"""Poplar1: heavy-hitters VDAF over an incremental DPF (host side).

The port's own copy of janus_tpu/vdaf/poplar1.py, value for value: the
IDPF (`Idpf.gen`, `eval_prefixes`), the aggregation parameter
(`Poplar1AggParam`: a level and its sorted prefixes), `Poplar1`'s
shard / prepare_init / prepare_next / prepare_finish / aggregate /
unshard, the helper's seed-derived correlated randomness
(`corr_from_seed`), the sketch's verify randomness (`verify_rand`), the
DAP codecs of public and input shares, and the collector's
`heavy_hitters` loop. A client shards with it, the collector unshards
with it, the helper's round 2 runs it, and the tests hold the device
walk (vdaf/poplar1_device.py) against its `prepare_init`.

Design (draft-irtf-cfrg-vdaf Poplar1, as janus_tpu re-derives it):

- **IDPF**: an incremental distributed point function over a bit
  string alpha of length `bits`. Two key shares; evaluated at any
  prefix p, the two parties' outputs sum to (beta_level if p is a
  prefix of alpha else 0). Each tree level's value is a vector
  (1, beta) in a level field: inner levels use Field64, the leaf level
  Field128.
- **Sketch**: per level the client provides additive shares of random
  (a, b) and of c = a^2 + b (leader explicit, helper derived from a
  seed). With verify randomness r_p per queried prefix (from the shared
  verify key and the report nonce), the aggregators reveal
  A = a + SUM r_p y_p and B = b + SUM r_p^2 y_p, then exchange shares
  of sigma = A^2 - B - 2*A*a + c (= Z^2 - W) and accept iff sigma == 0,
  which holds exactly when y is all-zero or one-hot with value 1.
- **Aggregation parameter**: (level, prefixes). The collector walks
  levels, keeping heavy prefixes.

XOF: the counter-mode SHAKE128 XOF (vdaf/xof.py) with Poplar1's
algorithm id for domain separation.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..fields.field import Field64, Field128
from .reference import VdafError
from .xof import SEED_SIZE, dst, prng_expand
from .xof import XofShake128

ALGO_ID = 0x00001000  # matches the reference's declared codepoint

USAGE_CONVERT = 5
USAGE_EXTEND = 6
USAGE_VERIFY_RAND = 7
USAGE_CORR_RAND = 8
# Domain separation for the convert VALUE vector lives in the usage id
# (not a binder): every XOF prefix stays lane-aligned, which is what
# lets the batched device walk (vdaf/poplar1_device.py) run on the
# single-block counter-mode Keccak kernel.
USAGE_CONVERT_VALUE = 9


def _xof_vec(field, seed: bytes, usage: int, binder: bytes, length: int):
    return prng_expand(field, seed, dst(ALGO_ID, usage), binder, length)


def _extend(seed: bytes) -> tuple[bytes, int, bytes, int]:
    """One IDPF tree step: seed -> (seed_L, bit_L, seed_R, bit_R)."""
    out = XofShake128(seed, dst(ALGO_ID, USAGE_EXTEND)).next(2 * SEED_SIZE + 2)
    return (
        out[:SEED_SIZE],
        out[2 * SEED_SIZE] & 1,
        out[SEED_SIZE : 2 * SEED_SIZE],
        out[2 * SEED_SIZE + 1] & 1,
    )


def _convert(field, seed: bytes, length: int) -> tuple[bytes, list[int]]:
    """Seed -> (next seed, value vector) in the level's field."""
    nxt = XofShake128.derive_seed(seed, dst(ALGO_ID, USAGE_CONVERT), b"")
    return nxt, _xof_vec(field, seed, USAGE_CONVERT_VALUE, b"", length)


@dataclass
class IdpfKey:
    """One party's IDPF key: root seed + per-level correction words +
    the sketch's correlated randomness (leader: explicit per-level
    (a, b, c) shares; helper: a 16-byte seed they derive from)."""

    root_seed: bytes
    # per level: (seed_cw, bit_cw_L, bit_cw_R, value_cw)
    correction_words: list
    # leader (party 0): list of per-level (a_share, b_share, c_share);
    # helper (party 1): 16-byte corr seed. None only for legacy tests.
    corr: object = None


def corr_from_seed(bits: int, corr_seed: bytes, level: int):
    """The helper's per-level (a, b, c) share, derived from its seed."""
    F = Field128 if level == bits - 1 else Field64
    vec = _xof_vec(F, corr_seed, USAGE_CORR_RAND, level.to_bytes(2, "big"), 3)
    return tuple(vec)


def verify_rand(bits: int, verify_key: bytes, nonce: bytes, param: "Poplar1AggParam"):
    """Per-prefix sketch randomness r_p, shared by both aggregators and
    unpredictable to the client: XOF(verify_key, nonce || level ||
    H(prefixes))."""
    import hashlib

    F = Field128 if param.level == bits - 1 else Field64
    binder = (
        nonce
        + param.level.to_bytes(2, "big")
        + hashlib.sha256(b"".join(p.to_bytes(16, "big") for p in param.prefixes)).digest()
    )
    return _xof_vec(F, verify_key, USAGE_VERIFY_RAND, binder, len(param.prefixes))


class Idpf:
    """2-party incremental DPF (the draft's IDPF with 2-element values:
    [count, weighted payload]); inner levels over Field64, leaf level
    over Field128."""

    VALUE_LEN = 2

    def __init__(self, bits: int):
        assert 1 <= bits <= 128
        self.bits = bits

    def field_at(self, level: int):
        return Field128 if level == self.bits - 1 else Field64

    def gen(self, alpha: int, beta_inner: list[int] | None = None, beta_leaf: int | None = None):
        """-> (public [shared correction words], key0, key1).

        Values programmed per level: [1, beta] where beta defaults to 1.
        """
        assert 0 <= alpha < (1 << self.bits)
        seed = [secrets.token_bytes(SEED_SIZE), secrets.token_bytes(SEED_SIZE)]
        ctrl = [0, 1]
        root = (seed[0], seed[1])
        cws = []
        for level in range(self.bits):
            F = self.field_at(level)
            bit = (alpha >> (self.bits - 1 - level)) & 1
            s0 = _extend(seed[0])
            s1 = _extend(seed[1])
            # (seed_L, t_L, seed_R, t_R) per party
            keep, lose = (2, 0) if bit else (0, 2)  # index into tuples
            seed_cw = bytes(a ^ b for a, b in zip(s0[lose], s1[lose]))
            t_cw_l = s0[1] ^ s1[1] ^ bit ^ 1
            t_cw_r = s0[3] ^ s1[3] ^ bit
            new_seed = []
            new_ctrl = []
            for p, s in ((0, s0), (1, s1)):
                ks, kt = s[keep], s[keep + 1]
                if ctrl[p]:
                    ks = bytes(a ^ b for a, b in zip(ks, seed_cw))
                    kt ^= t_cw_l if bit == 0 else t_cw_r
                new_seed.append(ks)
                new_ctrl.append(kt)
            # value correction for this level
            conv = []
            next_seed = []
            for p in (0, 1):
                ns, vec = _convert(F, new_seed[p], self.VALUE_LEN)
                conv.append(vec)
                next_seed.append(ns)
            beta = 1
            if level == self.bits - 1 and beta_leaf is not None:
                beta = beta_leaf
            elif beta_inner is not None and level < self.bits - 1:
                beta = beta_inner[level]
            want = [1, beta]
            # W_cw = (-1)^{t1} * (want - conv0 + conv1): the on-path party
            # holding ctrl=1 adds W_cw, party 1 negates its whole share
            sign = F.MODULUS - 1 if new_ctrl[1] else 1
            value_cw = [
                F.mul(sign, F.add(F.sub(w, conv[0][i]), conv[1][i]))
                for i, w in enumerate(want)
            ]
            cws.append((seed_cw, t_cw_l, t_cw_r, value_cw))
            seed = next_seed
            ctrl = new_ctrl
        return cws, IdpfKey(root[0], cws), IdpfKey(root[1], cws)

    def eval_prefixes(self, party: int, key: IdpfKey, level: int, prefixes: list[int]):
        """Evaluate this party's share at each prefix of bit-length
        level+1; returns [len(prefixes)][VALUE_LEN] field shares."""
        F = self.field_at(level)
        out = []
        for p in prefixes:
            share = self._eval_one(party, key, level, p)
            out.append(share)
        return out

    def _eval_one(self, party: int, key: IdpfKey, level: int, prefix: int):
        seed = key.root_seed
        ctrl = party  # party 1 starts with control bit 1
        value = None
        for lvl in range(level + 1):
            F = self.field_at(lvl)
            bit = (prefix >> (level - lvl)) & 1
            seed_cw, t_cw_l, t_cw_r, value_cw = key.correction_words[lvl]
            sl, tl, sr, tr = _extend(seed)
            if ctrl:
                sl = bytes(a ^ b for a, b in zip(sl, seed_cw))
                sr = bytes(a ^ b for a, b in zip(sr, seed_cw))
                tl ^= t_cw_l
                tr ^= t_cw_r
            seed, ctrl = (sr, tr) if bit else (sl, tl)
            seed, vec = _convert(F, seed, self.VALUE_LEN)
            if lvl == level:
                value = list(vec)
                if ctrl:
                    value = [F.add(v, cw) for v, cw in zip(value, value_cw)]
                if party == 1:
                    value = [F.neg(v) for v in value]
        return value


@dataclass
class Poplar1AggParam:
    level: int
    prefixes: tuple[int, ...]

    def encode(self) -> bytes:
        import struct

        out = struct.pack(">HI", self.level, len(self.prefixes))
        for p in self.prefixes:
            out += p.to_bytes(16, "big")
        return out

    @classmethod
    def decode(cls, raw: bytes) -> "Poplar1AggParam":
        import struct

        level, n = struct.unpack(">HI", raw[:6])
        prefixes = tuple(
            int.from_bytes(raw[6 + 16 * i : 22 + 16 * i], "big") for i in range(n)
        )
        return cls(level, prefixes)


@dataclass
class _PrepState:
    field: object
    y_shares: list  # per-prefix count share
    party: int
    a_share: int  # correlated-randomness shares for this level
    c_share: int
    sigma_share: int | None = None  # set after prepare_next


class Poplar1:
    """Host Poplar1: shard / prepare (quadratic sketch, 2 exchange
    rounds) / aggregate / unshard.

    Two aggregators (leader=0, helper=1). Round 1 reveals the masked
    sums (A, B); round 2 reveals sigma = Z^2 - W (module docstring),
    which is 0 iff the y vector is all-zero or one-hot with value 1.
    """

    NUM_SHARES = 2

    def __init__(self, bits: int):
        self.bits = bits
        self.idpf = Idpf(bits)

    # --- client ---
    def shard(self, measurement: int):
        """measurement: the alpha bit string as an int < 2^bits.

        Key 0 (leader) carries explicit per-level (a, b, c) correlated-
        randomness shares; key 1 (helper) derives its shares from a
        seed — constant wire size for the helper, like the draft."""
        cws, k0, k1 = self.idpf.gen(measurement)
        corr_seed = secrets.token_bytes(SEED_SIZE)
        leader_corr = []
        for level in range(self.bits):
            F = self.idpf.field_at(level)
            a = int.from_bytes(secrets.token_bytes(16), "big") % F.MODULUS
            b = int.from_bytes(secrets.token_bytes(16), "big") % F.MODULUS
            c = F.add(F.mul(a, a), b)  # c = a^2 + b
            a1, b1, c1 = corr_from_seed(self.bits, corr_seed, level)
            leader_corr.append((F.sub(a, a1), F.sub(b, b1), F.sub(c, c1)))
        k0.corr = leader_corr
        k1.corr = corr_seed
        return cws, (k0, k1)

    def _corr_at(self, party: int, key: IdpfKey, level: int):
        if party == 0:
            return key.corr[level]
        return corr_from_seed(self.bits, key.corr, level)

    # --- aggregator ---
    def prepare_init(
        self, party: int, key: IdpfKey, agg_param: Poplar1AggParam,
        verify_key: bytes = b"\x00" * SEED_SIZE, nonce: bytes = b"",
    ):
        """-> (state, round-1 message [A_share, B_share])."""
        F = self.idpf.field_at(agg_param.level)
        vals = self.idpf.eval_prefixes(party, key, agg_param.level, list(agg_param.prefixes))
        y = [v[0] for v in vals]
        r = verify_rand(self.bits, verify_key, nonce, agg_param)
        z = 0  # share of Z = SUM r_p y_p
        w = 0  # share of W = SUM r_p^2 y_p
        for rp, yp in zip(r, y):
            z = F.add(z, F.mul(rp, yp))
            w = F.add(w, F.mul(F.mul(rp, rp), yp))
        a_sh, b_sh, c_sh = self._corr_at(party, key, agg_param.level)
        state = _PrepState(F, y, party, a_sh, c_sh)
        return state, [F.add(z, a_sh), F.add(w, b_sh)]

    def prepare_next(self, state: _PrepState, round1_msgs: list[list[int]]):
        """Combine round-1 messages -> (state, round-2 msg [sigma_share])."""
        F = state.field
        A = 0
        B = 0
        for m in round1_msgs:
            A = F.add(A, m[0])
            B = F.add(B, m[1])
        sigma = F.sub(F.mul(2 % F.MODULUS, F.mul(A, state.a_share)), state.c_share)
        sigma = F.neg(sigma)  # -2*A*a_share + c_share
        if state.party == 0:
            sigma = F.add(sigma, F.sub(F.mul(A, A), B))
        state.sigma_share = sigma
        return state, [sigma]

    def prepare_finish(self, state: _PrepState, round2_msgs: list[list[int]]):
        F = state.field
        sigma = 0
        for m in round2_msgs:
            sigma = F.add(sigma, m[0])
        # sigma = Z^2 - W: zero iff y is all-zero (pruned path) or
        # one-hot with value 1
        if sigma != 0:
            raise VdafError("poplar1 sketch failed: y is not one-hot")
        return state.y_shares

    # --- aggregation ---
    def aggregate(self, agg_param: Poplar1AggParam, out_shares: list[list[int]]):
        F = self.idpf.field_at(agg_param.level)
        agg = [0] * len(agg_param.prefixes)
        for share in out_shares:
            agg = [F.add(a, b) for a, b in zip(agg, share)]
        return agg

    def unshard(self, agg_param: Poplar1AggParam, agg_shares: list[list[int]]):
        F = self.idpf.field_at(agg_param.level)
        agg = [0] * len(agg_param.prefixes)
        for share in agg_shares:
            agg = [F.add(a, b) for a, b in zip(agg, share)]
        return [int(x) for x in agg]


# ---------------------------------------------------------------------------
# DAP wire codecs (public share = correction words; input share = root
# seed and correlated randomness), byte for byte janus_tpu's.
# ---------------------------------------------------------------------------


def encode_public_share(bits: int, cws: list) -> bytes:
    """Correction words: per level seed_cw(16) || ctrl byte(t_l<<1|t_r)
    || value_cw elements (2, level field, fixed width)."""
    idpf = Idpf(bits)
    out = bytearray()
    for level, (seed_cw, t_l, t_r, value_cw) in enumerate(cws):
        F = idpf.field_at(level)
        out += seed_cw
        out.append((t_l << 1) | t_r)
        for v in value_cw:
            out += int(v).to_bytes(F.ENCODED_SIZE, "little")
    return bytes(out)


def decode_public_share(bits: int, raw: bytes) -> list:
    idpf = Idpf(bits)
    cws = []
    off = 0
    for level in range(bits):
        F = idpf.field_at(level)
        if off + SEED_SIZE + 1 + 2 * F.ENCODED_SIZE > len(raw):
            raise ValueError("poplar1 public share truncated")
        seed_cw = raw[off : off + SEED_SIZE]
        off += SEED_SIZE
        ctrl = raw[off]
        off += 1
        if ctrl > 3:
            raise ValueError("poplar1 public share bad control byte")
        value_cw = []
        for _ in range(Idpf.VALUE_LEN):
            v = int.from_bytes(raw[off : off + F.ENCODED_SIZE], "little")
            if v >= F.MODULUS:
                raise ValueError("poplar1 correction word out of range")
            value_cw.append(v)
            off += F.ENCODED_SIZE
        cws.append((seed_cw, (ctrl >> 1) & 1, ctrl & 1, value_cw))
    if off != len(raw):
        raise ValueError("poplar1 public share trailing bytes")
    return cws


def _leader_corr_size(bits: int) -> int:
    idpf = Idpf(bits)
    return sum(3 * idpf.field_at(level).ENCODED_SIZE for level in range(bits))


def encode_input_share(key: IdpfKey, party: int, bits: int) -> bytes:
    """Party 0: root_seed || per-level explicit (a, b, c) shares;
    party 1: root_seed || corr_seed."""
    if party == 1:
        return key.root_seed + key.corr
    idpf = Idpf(bits)
    out = bytearray(key.root_seed)
    for level, (a, b, c) in enumerate(key.corr):
        es = idpf.field_at(level).ENCODED_SIZE
        for v in (a, b, c):
            out += int(v).to_bytes(es, "little")
    return bytes(out)


def decode_input_share(bits: int, cws: list, raw: bytes, party: int) -> IdpfKey:
    if party == 1:
        if len(raw) != 2 * SEED_SIZE:
            raise ValueError("poplar1 helper input share must be root seed + corr seed")
        return IdpfKey(raw[:SEED_SIZE], cws, corr=raw[SEED_SIZE:])
    if len(raw) != SEED_SIZE + _leader_corr_size(bits):
        raise ValueError("poplar1 leader input share length mismatch")
    idpf = Idpf(bits)
    corr = []
    off = SEED_SIZE
    for level in range(bits):
        F = idpf.field_at(level)
        es = F.ENCODED_SIZE
        vals = []
        for _ in range(3):
            v = int.from_bytes(raw[off : off + es], "little")
            if v >= F.MODULUS:
                raise ValueError("poplar1 correlated randomness out of range")
            vals.append(v)
            off += es
        corr.append(tuple(vals))
    return IdpfKey(raw[:SEED_SIZE], cws, corr=corr)


def heavy_hitters(
    poplar: Poplar1, keys0, keys1, threshold: int, verify_key: bytes = b"\x00" * SEED_SIZE
) -> list[int]:
    """The classic Poplar loop: walk levels keeping prefixes whose count
    reaches the threshold; returns the heavy alpha values."""
    prefixes = [0, 1]
    for level in range(poplar.bits):
        agg_param = Poplar1AggParam(level, tuple(prefixes))
        out0, out1 = [], []
        for i, (k0, k1) in enumerate(zip(keys0, keys1)):
            nonce = i.to_bytes(16, "big")
            st0, m0 = poplar.prepare_init(0, k0, agg_param, verify_key, nonce)
            st1, m1 = poplar.prepare_init(1, k1, agg_param, verify_key, nonce)
            st0, s0 = poplar.prepare_next(st0, [m0, m1])
            st1, s1 = poplar.prepare_next(st1, [m0, m1])
            out0.append(poplar.prepare_finish(st0, [s0, s1]))
            out1.append(poplar.prepare_finish(st1, [s0, s1]))
        counts = poplar.unshard(
            agg_param,
            [poplar.aggregate(agg_param, out0), poplar.aggregate(agg_param, out1)],
        )
        survivors = [p for p, c in zip(prefixes, counts) if c >= threshold]
        if level == poplar.bits - 1:
            return survivors
        prefixes = [p << 1 for p in survivors] + [(p << 1) | 1 for p in survivors]
        prefixes.sort()
    return []
