"""HPKE (RFC 9180) single-shot seal/open with DAP application labels.

Equivalent of reference core/src/hpke.rs:27-120: base mode with the
DAP-07 application-info labels ("dap-07 input share",
"dap-07 aggregate share") and sender/recipient roles bound into the
key schedule info.

Suite matrix (reference core/src/hpke.rs:214-215,456 round_trip_check):
KEMs DHKEM(X25519, HKDF-SHA256) + DHKEM(P-256, HKDF-SHA256); KDFs
HKDF-SHA256/384/512; AEADs AES-128-GCM / AES-256-GCM /
ChaCha20Poly1305 — any combination. KEM/AEAD primitives come from
`core.hpke_backend` (the `cryptography` package when installed, else
the system libcrypto via ctypes — this image ships no crypto wheels);
the HKDF labeling is implemented here to match RFC 9180 exactly.

The port's own copy of janus_tpu/core/hpke.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu.
"""

from __future__ import annotations

import enum
import hashlib
import hmac
from dataclasses import dataclass

from .hpke_backend import (
    AESGCM,
    ChaCha20Poly1305,
    aead_open_batch,
    p256_exchange,
    p256_generate,
    x25519_exchange,
    x25519_exchange_batch,
    x25519_generate,
)
from ..messages import HpkeAeadId, HpkeCiphertext, HpkeConfig, HpkeConfigId, HpkeKdfId, HpkeKemId, Role

NN = 12  # nonce size, all three AEADs

_KDF_HASH = {
    HpkeKdfId.HKDF_SHA256: hashlib.sha256,
    HpkeKdfId.HKDF_SHA384: hashlib.sha384,
    HpkeKdfId.HKDF_SHA512: hashlib.sha512,
}

# openssl digest names for hmac.digest()'s one-shot C fast path (the
# batch open uses it; ~1.0 µs/call vs ~1.8 for hmac.new().digest())
_KDF_NAME = {
    HpkeKdfId.HKDF_SHA256: "sha256",
    HpkeKdfId.HKDF_SHA384: "sha384",
    HpkeKdfId.HKDF_SHA512: "sha512",
}

_AEAD = {  # id -> (constructor, Nk)
    HpkeAeadId.AES_128_GCM: (AESGCM, 16),
    HpkeAeadId.AES_256_GCM: (AESGCM, 32),
    HpkeAeadId.CHACHA20POLY1305: (ChaCha20Poly1305, 32),
}


class HpkeError(Exception):
    pass


def _labeled_extract(suite_id: bytes, hashfn, salt: bytes, label: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, b"HPKE-v1" + suite_id + label + ikm, hashfn).digest()


def _labeled_expand(suite_id: bytes, hashfn, prk: bytes, label: bytes, info: bytes, length: int) -> bytes:
    labeled_info = length.to_bytes(2, "big") + b"HPKE-v1" + suite_id + label + info
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + labeled_info + bytes([i]), hashfn).digest()
        out += t
        i += 1
    return out[:length]


# ---------------------------------------------------------------------------
# KEMs (both use HKDF-SHA256 internally per their RFC 9180 definitions)
# ---------------------------------------------------------------------------


class _X25519Kem:
    ID = HpkeKemId.X25519_HKDF_SHA256
    NSECRET = 32

    @staticmethod
    def generate() -> tuple[bytes, bytes]:
        return x25519_generate()

    @staticmethod
    def encap(pk_bytes: bytes) -> tuple[bytes, bytes]:
        pk_e, sk_e = x25519_generate()
        return x25519_exchange(sk_e, pk_bytes), pk_e

    @staticmethod
    def decap(sk_bytes: bytes, enc: bytes) -> bytes:
        return x25519_exchange(sk_bytes, enc)


class _P256Kem:
    ID = HpkeKemId.P256_HKDF_SHA256
    NSECRET = 32

    @staticmethod
    def generate() -> tuple[bytes, bytes]:
        return p256_generate()

    @staticmethod
    def encap(pk_bytes: bytes) -> tuple[bytes, bytes]:
        enc, sk_e = p256_generate()
        return p256_exchange(sk_e, pk_bytes), enc

    @staticmethod
    def decap(sk_bytes: bytes, enc: bytes) -> bytes:
        return p256_exchange(sk_bytes, enc)


_KEMS = {k.ID: k for k in (_X25519Kem, _P256Kem)}


def _extract_and_expand(kem, dh: bytes, kem_context: bytes) -> bytes:
    kem_suite_id = b"KEM" + int(kem.ID).to_bytes(2, "big")
    eae_prk = _labeled_extract(kem_suite_id, hashlib.sha256, b"", b"eae_prk", dh)
    return _labeled_expand(
        kem_suite_id, hashlib.sha256, eae_prk, b"shared_secret", kem_context, kem.NSECRET
    )


def _key_schedule(config: HpkeConfig, shared_secret: bytes, info: bytes):
    """Base mode key schedule -> (aead instance, base_nonce)."""
    suite_id = (
        b"HPKE"
        + int(config.kem_id).to_bytes(2, "big")
        + int(config.kdf_id).to_bytes(2, "big")
        + int(config.aead_id).to_bytes(2, "big")
    )
    hashfn = _KDF_HASH[config.kdf_id]
    ctor, nk = _AEAD[config.aead_id]
    psk_id_hash = _labeled_extract(suite_id, hashfn, b"", b"psk_id_hash", b"")
    info_hash = _labeled_extract(suite_id, hashfn, b"", b"info_hash", info)
    key_schedule_context = b"\x00" + psk_id_hash + info_hash
    secret = _labeled_extract(suite_id, hashfn, shared_secret, b"secret", b"")
    key = _labeled_expand(suite_id, hashfn, secret, b"key", key_schedule_context, nk)
    base_nonce = _labeled_expand(suite_id, hashfn, secret, b"base_nonce", key_schedule_context, NN)
    return ctor(key), base_nonce


class Label(enum.Enum):
    """DAP application-info labels (reference core/src/hpke.rs:45)."""

    INPUT_SHARE = b"dap-07 input share"
    AGGREGATE_SHARE = b"dap-07 aggregate share"


@dataclass(frozen=True)
class HpkeApplicationInfo:
    """label || sender role || recipient role (reference core/src/hpke.rs:62)."""

    label: Label
    sender: Role
    recipient: Role

    def bytes(self) -> bytes:
        return self.label.value + bytes([self.sender.value, self.recipient.value])


@dataclass(frozen=True)
class HpkeKeypair:
    config: HpkeConfig
    private_key: bytes  # raw X25519 scalar / P-256 big-endian scalar

    def config_id(self) -> HpkeConfigId:
        return self.config.id


def generate_hpke_config_and_private_key(
    config_id: int = 0,
    kem_id: HpkeKemId = HpkeKemId.X25519_HKDF_SHA256,
    kdf_id: HpkeKdfId = HpkeKdfId.HKDF_SHA256,
    aead_id: HpkeAeadId = HpkeAeadId.AES_128_GCM,
) -> HpkeKeypair:
    """reference core/src/hpke.rs generate_hpke_config_and_private_key."""
    kem = _kem_for(kem_id)
    _check_ciphersuite(kem_id, kdf_id, aead_id)
    pk_bytes, sk_bytes = kem.generate()
    config = HpkeConfig(HpkeConfigId(config_id), kem_id, kdf_id, aead_id, pk_bytes)
    return HpkeKeypair(config, sk_bytes)


def _kem_for(kem_id) -> type:
    try:
        return _KEMS[kem_id]
    except KeyError:
        raise HpkeError(f"unsupported HPKE KEM {kem_id}")


def _check_ciphersuite(kem_id, kdf_id, aead_id) -> None:
    if kdf_id not in _KDF_HASH or aead_id not in _AEAD:
        raise HpkeError(f"unsupported HPKE ciphersuite {kem_id}/{kdf_id}/{aead_id}")


def hpke_seal(
    config: HpkeConfig,
    application_info: HpkeApplicationInfo,
    plaintext: bytes,
    aad: bytes,
) -> HpkeCiphertext:
    """Single-shot base-mode seal to `config`'s public key."""
    kem = _kem_for(config.kem_id)
    _check_ciphersuite(config.kem_id, config.kdf_id, config.aead_id)
    dh, enc = kem.encap(config.public_key)
    shared_secret = _extract_and_expand(kem, dh, enc + config.public_key)
    aead, base_nonce = _key_schedule(config, shared_secret, application_info.bytes())
    ct = aead.encrypt(base_nonce, plaintext, aad)
    return HpkeCiphertext(config.id, enc, ct)


def hpke_open(
    keypair: HpkeKeypair,
    application_info: HpkeApplicationInfo,
    ciphertext: HpkeCiphertext,
    aad: bytes,
) -> bytes:
    """Single-shot base-mode open with the recipient private key."""
    kem = _kem_for(keypair.config.kem_id)
    _check_ciphersuite(keypair.config.kem_id, keypair.config.kdf_id, keypair.config.aead_id)
    if ciphertext.config_id != keypair.config.id:
        raise HpkeError(
            f"config id mismatch: {ciphertext.config_id} != {keypair.config.id}"
        )
    try:
        dh = kem.decap(keypair.private_key, ciphertext.encapsulated_key)
    except Exception as e:  # malformed point / key
        raise HpkeError(f"KEM decap failed: {e}") from e
    kem_context = ciphertext.encapsulated_key + keypair.config.public_key
    shared_secret = _extract_and_expand(kem, dh, kem_context)
    aead, base_nonce = _key_schedule(keypair.config, shared_secret, application_info.bytes())
    try:
        return aead.decrypt(base_nonce, ciphertext.payload, aad)
    except Exception as e:  # InvalidTag
        raise HpkeError(f"decryption failed: {e}") from e


def hpke_open_batch(
    keypair: HpkeKeypair,
    application_info: HpkeApplicationInfo,
    encs,
    payloads,
    aads,
) -> list:
    """Batched single-shot base-mode open: a whole decrypt window
    against ONE recipient keypair (the ingest hot path — every upload
    in a flush window addresses the same task HPKE config; the caller
    groups lanes by config id first, so no per-lane config-id check is
    needed here).

    `encs` / `payloads` / `aads` are parallel per-lane columns
    (encapsulated key, AEAD ciphertext, AAD). Returns a list aligned
    with them: plaintext bytes for lanes that opened, an `HpkeError`
    INSTANCE for lanes that failed — the per-lane value form of the
    exceptions `hpke_open` raises, so one tampered report rejects its
    own lane and never its window. Equivalence with the per-report
    oracle (same plaintexts, errors on the same indexes) is fuzz-pinned
    by tests/test_ingest_batch.py.

    What the batch amortizes over the window:
    - KEM decap runs through one EVP private-key object + derive
      context (`x25519_exchange_batch`) instead of a full parse/create/
      free cycle per report (P-256 lanes fall back to per-lane decap —
      the EC_KEY surface has no cheap peer swap).
    - The key-schedule constants (suite ids, psk_id/info hashes, the
      key-schedule context, every labeled-info template) are computed
      once; per lane only the secret-dependent HMACs remain, issued
      through `hmac.digest`'s one-shot C path.
    - AEAD opens share one cipher context (`aead_open_batch`).

    GIL note: whether this call parallelizes across decrypt-pool
    workers is a backend property (`hpke_backend.BATCH_RELEASES_GIL`);
    the ctypes-libcrypto fallback holds the GIL for the whole window by
    design (PyDLL convoy note in hpke_backend)."""
    import hmac as _hmac

    config = keypair.config
    kem = _kem_for(config.kem_id)
    _check_ciphersuite(config.kem_id, config.kdf_id, config.aead_id)
    n = len(encs)
    out: list = [None] * n

    # --- KEM decap column ---
    if kem is _X25519Kem:
        try:
            dhs = x25519_exchange_batch(keypair.private_key, encs)
        except Exception:
            # a bad RECIPIENT key (corrupt provisioning) fails every
            # lane's decap in the oracle too — per-lane rejects, never
            # a window-wide exception
            dhs = [None] * n
    else:
        dhs = []
        for enc in encs:
            try:
                dhs.append(kem.decap(keypair.private_key, enc))
            except Exception:
                dhs.append(None)

    # --- per-suite constants, computed once for the window ---
    kem_suite_id = b"KEM" + int(kem.ID).to_bytes(2, "big")
    # extract_and_expand templates (KEM KDF is always HKDF-SHA256)
    eae_msg_prefix = b"HPKE-v1" + kem_suite_id + b"eae_prk"
    ss_info_prefix = (
        kem.NSECRET.to_bytes(2, "big") + b"HPKE-v1" + kem_suite_id + b"shared_secret"
    )
    pk = config.public_key

    suite_id = (
        b"HPKE"
        + int(config.kem_id).to_bytes(2, "big")
        + int(config.kdf_id).to_bytes(2, "big")
        + int(config.aead_id).to_bytes(2, "big")
    )
    hashfn = _KDF_HASH[config.kdf_id]
    hname = _KDF_NAME[config.kdf_id]
    digest_size = hashfn().digest_size
    ctor, nk = _AEAD[config.aead_id]
    info = application_info.bytes()
    psk_id_hash = _labeled_extract(suite_id, hashfn, b"", b"psk_id_hash", b"")
    info_hash = _labeled_extract(suite_id, hashfn, b"", b"info_hash", info)
    key_schedule_context = b"\x00" + psk_id_hash + info_hash
    secret_msg = b"HPKE-v1" + suite_id + b"secret"
    key_info = (
        nk.to_bytes(2, "big") + b"HPKE-v1" + suite_id + b"key" + key_schedule_context
        + b"\x01"
    )
    nonce_info = (
        NN.to_bytes(2, "big") + b"HPKE-v1" + suite_id + b"base_nonce"
        + key_schedule_context + b"\x01"
    )
    # every derived length (NSECRET=32, nk<=32, NN=12) fits one HKDF
    # round of every supported hash, so expand == one truncated HMAC;
    # guarded here so a future suite can't silently truncate wrong
    assert max(kem.NSECRET, nk, NN) <= digest_size

    # --- per-lane key schedule (secret-dependent HMACs only) ---
    keys: list = [None] * n
    nonces: list = [None] * n
    hd = _hmac.digest
    ss_suffix = pk + b"\x01"
    nsecret = kem.NSECRET
    for i in range(n):
        dh = dhs[i]
        if dh is None:
            out[i] = HpkeError("KEM decap failed: bad encapsulated key")
            continue
        eae_prk = hd(b"", eae_msg_prefix + dh, "sha256")
        shared_secret = hd(eae_prk, ss_info_prefix + encs[i] + ss_suffix, "sha256")[
            :nsecret
        ]
        secret = hd(shared_secret, secret_msg, hname)
        keys[i] = hd(secret, key_info, hname)[:nk]
        nonces[i] = hd(secret, nonce_info, hname)[:NN]

    # --- AEAD open column ---
    opened = aead_open_batch(ctor, keys, nonces, payloads, aads)
    for i in range(n):
        if out[i] is not None:
            continue
        if opened[i] is None:
            # the message the per-report oracle's AEAD reject carries
            out[i] = HpkeError("decryption failed: AEAD decryption failed: invalid tag")
        else:
            out[i] = opened[i]
    return out
