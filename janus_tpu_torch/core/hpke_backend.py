"""Crypto primitive backend: `cryptography` when installed, else the
system libcrypto via ctypes.

The port's own copy of janus_tpu/core/hpke_backend.py, line for line.
A CUDA machine often has no `cryptography` wheel; there the port's
helper opens its HPKE shares through libcrypto (`BACKEND` says which
backend a process took). The HPKE layer only needs four primitives — AES-GCM, ChaCha20-Poly1305, X25519
and P-256 ECDH — all of which OpenSSL >= 1.1.1 (present wherever
CPython's `ssl` works) provides. This module exposes exactly that
surface:

- ``AESGCM`` / ``ChaCha20Poly1305``: ``ctor(key)`` with
  ``encrypt(nonce, data, aad)`` / ``decrypt(nonce, data, aad)`` —
  the `cryptography` AEAD interface.
- ``x25519_generate() -> (pk, sk)``, ``x25519_public(sk)``,
  ``x25519_exchange(sk, peer_pk)`` over raw 32-byte strings.
- ``p256_generate() -> (pk_uncompressed, sk_be32)``,
  ``p256_exchange(sk_be32, peer_uncompressed) -> x_be32``.
- Batch forms for the ingest hot path (docs/INGEST.md "Batched
  decrypt"): ``x25519_exchange_batch(sk, peer_pks)`` runs a whole
  decrypt window's exchanges through ONE private-key object and ONE
  derive context (the per-call EVP_PKEY parse + ctx create + free is
  ~60% of a scalar exchange through ctypes), and
  ``aead_open_batch(ctor, keys, nonces, cts, aads)`` opens a window
  through one reused cipher context. Failed lanes come back as None
  instead of raising, so one bad report can't fail its window.
- ``BATCH_RELEASES_GIL``: True when the batch calls release the GIL
  (the `cryptography` wheel does around its own native code). The
  ctypes-libcrypto fallback deliberately holds it (PyDLL, see below),
  so the ingest decrypt pool sizes itself from this flag instead of
  assuming crypto parallelism that isn't there.

When `cryptography` is importable the functions delegate to it
(identical behavior to the previous hard dependency); otherwise AEAD +
X25519 go through libcrypto's EVP interface and P-256 ECDH through
libcrypto's EC_KEY/ECDH_compute_key (constant-time scalar mult, like
every other production path). Only when those EC symbols are absent
does P-256 fall back to ~40 lines of affine curve arithmetic on
Python ints (scalar mult + on-curve validation only — no signing, no
wire parsing beyond the X9.62 uncompressed point). That Python ladder
is VARIABLE-TIME in the private scalar: acceptable for the ephemeral
encap side, but a long-term decap key served to untrusted clients
would leak timing — hence it is strictly the last resort and logs a
warning at import. Byte-exactness of every suite is enforced by the
RFC 9180 vector corpus in tests/test_hpke_vectors.py.
"""

from __future__ import annotations

import secrets

__all__ = [
    "BACKEND",
    "BATCH_RELEASES_GIL",
    "AESGCM",
    "ChaCha20Poly1305",
    "aead_open_batch",
    "x25519_generate",
    "x25519_public",
    "x25519_exchange",
    "x25519_exchange_batch",
    "p256_generate",
    "p256_exchange",
]

try:  # pragma: no cover - exercised where the wheel exists
    from cryptography.hazmat.primitives.asymmetric import ec as _ec
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey as _X25519Priv,
        X25519PublicKey as _X25519Pub,
    )
    from cryptography.hazmat.primitives.ciphers.aead import (
        AESGCM,
        ChaCha20Poly1305,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding as _Encoding,
        PublicFormat as _PublicFormat,
    )

    BACKEND = "cryptography"
    # the wheel's AEAD/ECDH primitives release the GIL around their
    # native work, so a batched open parallelizes across pool workers
    BATCH_RELEASES_GIL = True

    def x25519_generate() -> tuple[bytes, bytes]:
        sk = _X25519Priv.generate()
        return sk.public_key().public_bytes_raw(), sk.private_bytes_raw()

    def x25519_public(sk: bytes) -> bytes:
        return _X25519Priv.from_private_bytes(sk).public_key().public_bytes_raw()

    def x25519_exchange(sk: bytes, peer_pk: bytes) -> bytes:
        return _X25519Priv.from_private_bytes(sk).exchange(
            _X25519Pub.from_public_bytes(peer_pk)
        )

    def x25519_exchange_batch(sk: bytes, peer_pks) -> list:
        """One decap key against a window of encapsulated keys; a bad
        lane (malformed point) is None, never an exception — the HPKE
        layer maps it to that report's reject."""
        priv = _X25519Priv.from_private_bytes(sk)
        out = []
        for pk in peer_pks:
            if pk is None:
                out.append(None)
                continue
            try:
                out.append(priv.exchange(_X25519Pub.from_public_bytes(pk)))
            except Exception:
                out.append(None)
        return out

    def aead_open_batch(ctor, keys, nonces, cts, aads) -> list:
        """Open a window of AEAD ciphertexts (same algorithm, per-lane
        keys/nonces). Failed lanes (auth failure, malformed input, or a
        None key from an upstream failed lane) are None."""
        out = []
        for key, nonce, ct, aad in zip(keys, nonces, cts, aads):
            if key is None:
                out.append(None)
                continue
            try:
                out.append(ctor(key).decrypt(nonce, ct, aad or None))
            except Exception:
                out.append(None)
        return out

    _CURVE = _ec.SECP256R1()

    def p256_generate() -> tuple[bytes, bytes]:
        sk = _ec.generate_private_key(_CURVE)
        pk = sk.public_key().public_bytes(
            _Encoding.X962, _PublicFormat.UncompressedPoint
        )
        return pk, sk.private_numbers().private_value.to_bytes(32, "big")

    def p256_exchange(sk: bytes, peer_pk: bytes) -> bytes:
        priv = _ec.derive_private_key(int.from_bytes(sk, "big"), _CURVE)
        pub = _ec.EllipticCurvePublicKey.from_encoded_point(_CURVE, peer_pk)
        return priv.exchange(_ec.ECDH(), pub)

except ImportError:
    import ctypes
    import ctypes.util
    import threading

    BACKEND = "libcrypto"
    # PyDLL holds the GIL across every EVP call (deliberately — see the
    # convoy note below), so a batched open through this backend
    # serializes pool workers; the ingest pipeline sizes its decrypt
    # pool from this flag (docs/INGEST.md "Batched decrypt").
    BATCH_RELEASES_GIL = False

    _name = ctypes.util.find_library("crypto")
    # PyDLL, not CDLL: these EVP/EC calls are microsecond-scale and
    # never call back into Python, but a CDLL handle releases and
    # reacquires the GIL around EVERY call — and one hpke_open makes
    # dozens of them. Under a threaded server (the ingest decrypt
    # pool + handler pool) that per-call release triggers the new-GIL
    # convoy effect: each reacquire can wait a full switch interval
    # behind the other runnable threads. Measured on a 2-core host:
    # 8-thread hpke_open ran 7x SLOWER than single-threaded through
    # CDLL; through PyDLL threaded matches serial. The bulk work the
    # decrypt pool actually parallelizes (numpy share validation)
    # releases the GIL on its own.
    _lib = ctypes.PyDLL(_name or "libcrypto.so")

    _vp = ctypes.c_void_p
    _int = ctypes.c_int
    _sz = ctypes.c_size_t
    _cp = ctypes.c_char_p

    def _fn(name, restype, argtypes):
        f = getattr(_lib, name)
        f.restype = restype
        f.argtypes = argtypes
        return f

    # EVP AEAD
    _ctx_new = _fn("EVP_CIPHER_CTX_new", _vp, [])
    _ctx_free = _fn("EVP_CIPHER_CTX_free", None, [_vp])
    _ctx_reset = _fn("EVP_CIPHER_CTX_reset", _int, [_vp])
    _init = _fn("EVP_CipherInit_ex", _int, [_vp, _vp, _vp, _cp, _cp, _int])
    _ctrl = _fn("EVP_CIPHER_CTX_ctrl", _int, [_vp, _int, _int, _vp])
    _update = _fn("EVP_CipherUpdate", _int, [_vp, _cp, ctypes.POINTER(_int), _cp, _int])
    _final = _fn("EVP_CipherFinal_ex", _int, [_vp, _cp, ctypes.POINTER(_int)])
    _aes128 = _fn("EVP_aes_128_gcm", _vp, [])
    _aes256 = _fn("EVP_aes_256_gcm", _vp, [])
    _chacha = _fn("EVP_chacha20_poly1305", _vp, [])

    # The EVP_CIPHER objects are process-lifetime statics: fetch each
    # once at import instead of one EVP_aes_128_gcm() ctypes round-trip
    # per encrypt/decrypt call.
    _AES128_CIPHER = _aes128()
    _AES256_CIPHER = _aes256()
    _CHACHA_CIPHER = _chacha()

    _SET_IVLEN, _GET_TAG, _SET_TAG = 0x9, 0x10, 0x11
    _TAG = 16

    # Reusable EVP_CIPHER_CTX pool: context allocation + free was a
    # malloc/free pair and two ctypes calls on EVERY AEAD op. A context
    # is fully re-initialized by EVP_CIPHER_CTX_reset + EVP_CipherInit_ex
    # at the top of each run, so pooled reuse is safe across keys,
    # ciphers and threads (a context is only ever held by one caller at
    # a time; the pool hands it out under a lock). Batch opens hold one
    # context for their whole window.
    _CTX_POOL: list = []
    _CTX_POOL_LOCK = threading.Lock()
    _CTX_POOL_CAP = 16

    def _ctx_acquire():
        with _CTX_POOL_LOCK:
            if _CTX_POOL:
                return _CTX_POOL.pop()
        ctx = _ctx_new()
        if not ctx:
            raise MemoryError("EVP_CIPHER_CTX_new failed")
        return ctx

    def _ctx_release(ctx) -> None:
        with _CTX_POOL_LOCK:
            if len(_CTX_POOL) < _CTX_POOL_CAP:
                _CTX_POOL.append(ctx)
                return
        _ctx_free(ctx)

    def _aead_run(cipher, key, nonce, data, aad, enc: bool, ctx=None) -> bytes:
        own_ctx = ctx is None
        if own_ctx:
            ctx = _ctx_acquire()
        try:
            # reset FIRST: the context may carry a previous op's state
            # (including a failed one) — reset returns it to fresh
            if _ctx_reset(ctx) != 1:
                raise ValueError("cipher ctx reset failed")
            if _init(ctx, cipher, None, None, None, int(enc)) != 1:
                raise ValueError("cipher init failed")
            # 12 bytes is the default IV length of all three AEADs;
            # only non-default lengths need the ctrl round-trip
            if len(nonce) != 12 and _ctrl(ctx, _SET_IVLEN, len(nonce), None) != 1:
                raise ValueError("bad nonce length")
            if _init(ctx, None, None, key, nonce, int(enc)) != 1:
                raise ValueError("key/nonce init failed")
            if enc:
                pt = data
            else:
                if len(data) < _TAG:
                    raise ValueError("ciphertext shorter than tag")
                pt, tag = data[:-_TAG], data[-_TAG:]
                if _ctrl(ctx, _SET_TAG, _TAG, ctypes.create_string_buffer(tag, _TAG)) != 1:
                    raise ValueError("set tag failed")
            outl = _int(0)
            if aad and _update(ctx, None, ctypes.byref(outl), aad, len(aad)) != 1:
                raise ValueError("aad update failed")
            out = ctypes.create_string_buffer(max(1, len(pt)))
            if _update(ctx, out, ctypes.byref(outl), pt, len(pt)) != 1:
                raise ValueError("update failed")
            n = outl.value
            fin = ctypes.create_string_buffer(_TAG)
            if _final(ctx, fin, ctypes.byref(outl)) != 1:
                raise ValueError("AEAD decryption failed: invalid tag" if not enc else "final failed")
            n += outl.value
            body = out.raw[:n]
            if not enc:
                return body
            tag = ctypes.create_string_buffer(_TAG)
            if _ctrl(ctx, _GET_TAG, _TAG, tag) != 1:
                raise ValueError("get tag failed")
            return body + tag.raw
        finally:
            if own_ctx:
                _ctx_release(ctx)

    class _EvpAead:
        _key_sizes: tuple[int, ...] = ()

        def __init__(self, key: bytes):
            if len(key) not in self._key_sizes:
                raise ValueError(f"invalid key size {len(key)}")
            self._key = bytes(key)

        def _cipher(self):
            raise NotImplementedError

        def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
            return _aead_run(self._cipher(), self._key, bytes(nonce), bytes(data), bytes(aad or b""), True)

        def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
            return _aead_run(self._cipher(), self._key, bytes(nonce), bytes(data), bytes(aad or b""), False)

    class AESGCM(_EvpAead):
        _key_sizes = (16, 32)

        def _cipher(self):
            return _AES128_CIPHER if len(self._key) == 16 else _AES256_CIPHER

    class ChaCha20Poly1305(_EvpAead):
        _key_sizes = (32,)

        def _cipher(self):
            return _CHACHA_CIPHER

    def aead_open_batch(ctor, keys, nonces, cts, aads) -> list:
        """Open a window of AEAD ciphertexts (same algorithm, per-lane
        keys/nonces) through ONE pooled cipher context held for the
        whole window. Failed lanes (auth failure, malformed input, or a
        None key from an upstream failed lane) are None.

        Specialized against _aead_run for the window shape: HPKE
        nonces are always 12 bytes (every suite's default IV length),
        so cipher + key + nonce initialize in a single
        EVP_CipherInit_ex, and the output/tag scratch buffers are
        allocated once for the window's largest ciphertext instead of
        per lane."""
        n_lanes = len(cts)
        out: list = [None] * n_lanes
        max_pt = 0
        for i in range(n_lanes):
            if keys[i] is not None and len(cts[i]) >= _TAG:
                max_pt = max(max_pt, len(cts[i]) - _TAG)
        buf = ctypes.create_string_buffer(max(1, max_pt))
        tag_buf = ctypes.create_string_buffer(_TAG)
        fin = ctypes.create_string_buffer(_TAG)
        outl = _int(0)
        outl_ref = ctypes.byref(outl)
        # the EVP_CIPHER depends only on the key length (AESGCM picks
        # AES-128 vs AES-256 by it), so it resolves once per length —
        # an HPKE window has one, but the surface stays general
        ciphers: dict = {}
        ctx = _ctx_acquire()
        reset, init, ctrl, update, final, memmove = (
            _ctx_reset, _init, _ctrl, _update, _final, ctypes.memmove,
        )
        try:
            for i in range(n_lanes):
                key = keys[i]
                if key is None:
                    continue
                data = bytes(cts[i])
                if len(data) < _TAG:
                    continue
                cipher = ciphers.get(len(key))
                if cipher is None:
                    try:
                        cipher = ciphers[len(key)] = ctor(key)._cipher()
                    except ValueError:
                        continue
                nonce = bytes(nonces[i])
                if len(nonce) != 12:
                    # non-default IV length needs the split-init +
                    # SET_IVLEN sequence (12 is every AEAD's default;
                    # a shorter nonce through the one-shot init would
                    # be an OOB read, a longer one a silent truncation)
                    try:
                        out[i] = _aead_run(
                            cipher, key, nonce, data, bytes(aads[i] or b""),
                            False, ctx=ctx,
                        )
                    except ValueError:
                        pass
                    continue
                pt, tag = data[:-_TAG], data[-_TAG:]
                aad = bytes(aads[i] or b"")
                memmove(tag_buf, tag, _TAG)
                if (
                    reset(ctx) != 1
                    or init(ctx, cipher, None, key, nonce, 0) != 1
                    or ctrl(ctx, _SET_TAG, _TAG, tag_buf) != 1
                ):
                    continue
                if aad and update(ctx, None, outl_ref, aad, len(aad)) != 1:
                    continue
                if update(ctx, buf, outl_ref, pt, len(pt)) != 1:
                    continue
                n = outl.value
                if final(ctx, fin, outl_ref) != 1:
                    continue  # auth failure: reject this lane only
                out[i] = buf[: n + outl.value]
        finally:
            _ctx_release(ctx)
        return out

    # EVP X25519 (NID_X25519)
    _X25519 = 1034
    _pkey_ctx_new_id = _fn("EVP_PKEY_CTX_new_id", _vp, [_int, _vp])
    _pkey_ctx_new = _fn("EVP_PKEY_CTX_new", _vp, [_vp, _vp])
    _pkey_ctx_free = _fn("EVP_PKEY_CTX_free", None, [_vp])
    _pkey_free = _fn("EVP_PKEY_free", None, [_vp])
    _keygen_init = _fn("EVP_PKEY_keygen_init", _int, [_vp])
    _keygen = _fn("EVP_PKEY_keygen", _int, [_vp, ctypes.POINTER(_vp)])
    _new_raw_priv = _fn("EVP_PKEY_new_raw_private_key", _vp, [_int, _vp, _cp, _sz])
    _new_raw_pub = _fn("EVP_PKEY_new_raw_public_key", _vp, [_int, _vp, _cp, _sz])
    _get_raw_priv = _fn("EVP_PKEY_get_raw_private_key", _int, [_vp, _cp, ctypes.POINTER(_sz)])
    _get_raw_pub = _fn("EVP_PKEY_get_raw_public_key", _int, [_vp, _cp, ctypes.POINTER(_sz)])
    _derive_init = _fn("EVP_PKEY_derive_init", _int, [_vp])
    _derive_peer = _fn("EVP_PKEY_derive_set_peer", _int, [_vp, _vp])
    _derive = _fn("EVP_PKEY_derive", _int, [_vp, _cp, ctypes.POINTER(_sz)])

    def _raw32(getter, pkey) -> bytes:
        buf = ctypes.create_string_buffer(32)
        n = _sz(32)
        if getter(pkey, buf, ctypes.byref(n)) != 1 or n.value != 32:
            raise ValueError("raw key extraction failed")
        return buf.raw

    def x25519_generate() -> tuple[bytes, bytes]:
        pctx = _pkey_ctx_new_id(_X25519, None)
        if not pctx:
            raise MemoryError("EVP_PKEY_CTX_new_id failed")
        try:
            pkey = _vp()
            if _keygen_init(pctx) != 1 or _keygen(pctx, ctypes.byref(pkey)) != 1:
                raise ValueError("X25519 keygen failed")
            try:
                return _raw32(_get_raw_pub, pkey), _raw32(_get_raw_priv, pkey)
            finally:
                _pkey_free(pkey)
        finally:
            _pkey_ctx_free(pctx)

    def x25519_public(sk: bytes) -> bytes:
        # pass the REAL length: a short scalar with a hardcoded 32 was
        # an out-of-bounds read into whatever followed the bytes object
        pkey = _new_raw_priv(_X25519, None, bytes(sk), len(sk))
        if not pkey:
            raise ValueError("bad X25519 private key")
        try:
            return _raw32(_get_raw_pub, pkey)
        finally:
            _pkey_free(pkey)

    def x25519_exchange(sk: bytes, peer_pk: bytes) -> bytes:
        pkey = _new_raw_priv(_X25519, None, bytes(sk), len(sk))
        if not pkey:
            raise ValueError("bad X25519 private key")
        # length passed explicitly (the encapsulated key on the decap
        # side is attacker-controlled: libcrypto must see the actual
        # size and reject it, not read 32 bytes regardless)
        peer = _new_raw_pub(_X25519, None, bytes(peer_pk), len(peer_pk))
        if not peer:
            _pkey_free(pkey)
            raise ValueError("bad X25519 public key")
        pctx = _pkey_ctx_new(pkey, None)
        try:
            if not pctx or _derive_init(pctx) != 1 or _derive_peer(pctx, peer) != 1:
                raise ValueError("X25519 derive init failed")
            out = ctypes.create_string_buffer(32)
            n = _sz(32)
            if _derive(pctx, out, ctypes.byref(n)) != 1 or n.value != 32:
                raise ValueError("X25519 derive failed")
            return out.raw
        finally:
            if pctx:
                _pkey_ctx_free(pctx)
            _pkey_free(peer)
            _pkey_free(pkey)

    def x25519_exchange_batch(sk: bytes, peer_pks) -> list:
        """One decap key against a window of encapsulated keys.

        The scalar form pays an EVP_PKEY parse, a derive-context create
        + init, and three frees PER CALL — ~60% of its measured cost on
        this host (~79 µs scalar vs ~30 µs/lane batched; the X25519
        scalar mult itself is ~28 µs). Here the private key object and
        derive context are built once and each lane only parses its
        peer key, swaps it in with EVP_PKEY_derive_set_peer, and
        derives. Bad lanes (malformed/wrong-length peer keys) are None,
        never an exception — the HPKE layer maps them to that report's
        reject."""
        pkey = _new_raw_priv(_X25519, None, bytes(sk), len(sk))
        if not pkey:
            raise ValueError("bad X25519 private key")
        pctx = _pkey_ctx_new(pkey, None)
        try:
            if not pctx or _derive_init(pctx) != 1:
                raise ValueError("X25519 derive init failed")
            out = ctypes.create_string_buffer(32)
            n = _sz(32)
            n_ref = ctypes.byref(n)
            res: list = []
            append = res.append
            new_pub, set_peer, derive, free = (
                _new_raw_pub, _derive_peer, _derive, _pkey_free,
            )
            for pk in peer_pks:
                if pk is None:
                    append(None)
                    continue
                peer = new_pub(_X25519, None, bytes(pk), len(pk))
                if not peer:
                    append(None)
                    continue
                try:
                    n.value = 32
                    if set_peer(pctx, peer) != 1 or derive(pctx, out, n_ref) != 1 or n.value != 32:
                        append(None)
                        continue
                    append(out.raw)
                finally:
                    free(peer)
            return res
        finally:
            if pctx:
                _pkey_ctx_free(pctx)
            _pkey_free(pkey)

    # P-256 ECDH, preferred path: libcrypto's EC_KEY + ECDH_compute_key
    # (constant-time scalar multiplication). The symbols are deprecated
    # in OpenSSL 3.0 but still exported; if a future libcrypto drops
    # them we fall back to the Python ladder below (variable-time — see
    # module docstring).
    _NID_P256 = 415  # NID_X9_62_prime256v1
    _UNCOMPRESSED = 4  # POINT_CONVERSION_UNCOMPRESSED

    try:
        _ec_key_new = _fn("EC_KEY_new_by_curve_name", _vp, [_int])
        _ec_key_free = _fn("EC_KEY_free", None, [_vp])
        _ec_key_gen = _fn("EC_KEY_generate_key", _int, [_vp])
        _ec_key_set_priv = _fn("EC_KEY_set_private_key", _int, [_vp, _vp])
        _ec_key_get_priv = _fn("EC_KEY_get0_private_key", _vp, [_vp])
        _ec_key_get_pub = _fn("EC_KEY_get0_public_key", _vp, [_vp])
        _ec_key_get_group = _fn("EC_KEY_get0_group", _vp, [_vp])
        _ec_point_new = _fn("EC_POINT_new", _vp, [_vp])
        _ec_point_free = _fn("EC_POINT_free", None, [_vp])
        _ec_oct2point = _fn("EC_POINT_oct2point", _int, [_vp, _vp, _cp, _sz, _vp])
        _ec_point2oct = _fn(
            "EC_POINT_point2oct", _sz, [_vp, _vp, _int, _cp, _sz, _vp]
        )
        _ec_is_on_curve = _fn("EC_POINT_is_on_curve", _int, [_vp, _vp, _vp])
        _ecdh_compute = _fn("ECDH_compute_key", _int, [_cp, _sz, _vp, _vp, _vp])
        _bn_bin2bn = _fn("BN_bin2bn", _vp, [_cp, _int, _vp])
        _bn_bn2binpad = _fn("BN_bn2binpad", _int, [_vp, _cp, _int])
        _bn_free = _fn("BN_free", None, [_vp])
        _HAVE_EC = True
    except AttributeError:  # pragma: no cover - ancient/shorn libcrypto
        import logging

        logging.getLogger(__name__).warning(
            "libcrypto lacks EC_KEY/ECDH symbols; P-256 HPKE falls back "
            "to variable-time Python curve arithmetic (timing side "
            "channel on long-term decap keys)"
        )
        _HAVE_EC = False

    def _ec_p256_generate() -> tuple[bytes, bytes]:
        key = _ec_key_new(_NID_P256)
        if not key:
            raise MemoryError("EC_KEY_new_by_curve_name failed")
        try:
            if _ec_key_gen(key) != 1:
                raise ValueError("P-256 keygen failed")
            sk = ctypes.create_string_buffer(32)
            if _bn_bn2binpad(_ec_key_get_priv(key), sk, 32) != 32:
                raise ValueError("P-256 private key extraction failed")
            pk = ctypes.create_string_buffer(65)
            n = _ec_point2oct(
                _ec_key_get_group(key), _ec_key_get_pub(key),
                _UNCOMPRESSED, pk, 65, None,
            )
            if n != 65:
                raise ValueError("P-256 public key encoding failed")
            return pk.raw, sk.raw
        finally:
            _ec_key_free(key)

    def _ec_p256_exchange(sk: bytes, peer_pk: bytes) -> bytes:
        if len(sk) != 32:
            raise ValueError("bad P-256 private key")
        key = _ec_key_new(_NID_P256)
        if not key:
            raise MemoryError("EC_KEY_new_by_curve_name failed")
        bn = _bn_bin2bn(bytes(sk), 32, None)
        peer = None
        try:
            if not bn or _ec_key_set_priv(key, bn) != 1:
                raise ValueError("bad P-256 private key")
            group = _ec_key_get_group(key)
            peer = _ec_point_new(group)
            if (
                not peer
                or _ec_oct2point(group, peer, bytes(peer_pk), len(peer_pk), None) != 1
                or _ec_is_on_curve(group, peer, None) != 1
            ):
                raise ValueError("bad P-256 public key")
            out = ctypes.create_string_buffer(32)
            if _ecdh_compute(out, 32, peer, key, None) != 32:
                raise ValueError("P-256 ECDH failed")
            return out.raw
        finally:
            if peer:
                _ec_point_free(peer)
            if bn:
                _bn_free(bn)
            _ec_key_free(key)

    # P-256 ECDH on Python ints (affine; modern pow(x, -1, p) inversion).
    # LAST RESORT ONLY (_HAVE_EC False): the double-and-add ladder
    # branches on secret scalar bits — variable-time.
    _PP = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
    _PA = _PP - 3
    _PB = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
    _PN = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
    _PG = (
        0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
        0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    )

    def _p256_on_curve(x: int, y: int) -> bool:
        return (y * y - (x * x * x + _PA * x + _PB)) % _PP == 0

    def _p256_add(P, Q):
        if P is None:
            return Q
        if Q is None:
            return P
        x1, y1 = P
        x2, y2 = Q
        if x1 == x2:
            if (y1 + y2) % _PP == 0:
                return None
            lam = (3 * x1 * x1 + _PA) * pow(2 * y1, -1, _PP) % _PP
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, _PP) % _PP
        x3 = (lam * lam - x1 - x2) % _PP
        return x3, (lam * (x1 - x3) - y1) % _PP

    def _p256_mul(k: int, P):
        R = None
        while k:
            if k & 1:
                R = _p256_add(R, P)
            P = _p256_add(P, P)
            k >>= 1
        return R

    def _p256_decode(pk: bytes):
        if len(pk) != 65 or pk[0] != 4:
            raise ValueError("bad P-256 point encoding")
        x = int.from_bytes(pk[1:33], "big")
        y = int.from_bytes(pk[33:], "big")
        if not _p256_on_curve(x, y):
            raise ValueError("P-256 point not on curve")
        return x, y

    def _p256_encode(P) -> bytes:
        x, y = P
        return b"\x04" + x.to_bytes(32, "big") + y.to_bytes(32, "big")

    def _py_p256_generate() -> tuple[bytes, bytes]:
        sk = secrets.randbelow(_PN - 1) + 1
        return _p256_encode(_p256_mul(sk, _PG)), sk.to_bytes(32, "big")

    def _py_p256_exchange(sk: bytes, peer_pk: bytes) -> bytes:
        d = int.from_bytes(sk, "big")
        if not 1 <= d < _PN:
            raise ValueError("bad P-256 private key")
        S = _p256_mul(d, _p256_decode(peer_pk))
        if S is None:
            raise ValueError("P-256 ECDH produced the point at infinity")
        return S[0].to_bytes(32, "big")

    p256_generate = _ec_p256_generate if _HAVE_EC else _py_p256_generate
    p256_exchange = _ec_p256_exchange if _HAVE_EC else _py_p256_exchange
