"""Host Prio3 sharding for one report: the client's side of Prio3.

The port's own copy of the sharding half of janus_tpu/vdaf/reference.py:
the host NTT, the prover's side of the four circuits of the port's
registry (Count, Sum, SumVec and CountVec, Histogram, FixedPointVec: the
scalar encoding, the inputs of each gadget call and the gadget's value,
and `fp_encode_floats` for a fixed-point client), the FLP prover, and
`Prio3.shard` with the XOF helpers it calls, and `Prio3Sparse.shard`
(block-sparse SumVec: the public share carries the block indices), in
both XOF modes ("fast":
counter-mode SHAKE128 with the tree-digested binder and the helper's seed
as its binder; "draft": the VDAF-07 sponge with rejection sampling). The
circuits' field, lengths and gadget schedule are vdaf/circuits.py's, the
shapes the device engine runs. Given the same measurement, nonce and
`rand`, `shard` returns janus_tpu's public share and input shares bit for
bit.

A client shards one report at a time on the host; it is not an
aggregator. The aggregators' prepare runs only on the device engines
(vdaf/prio3.py, vdaf/draft.py), so this module holds no prepare, query
or decide: there is no host path for an aggregator to take. The
collector's `unshard` (the sum of the two aggregate shares, decoded)
runs on the host here, as janus_tpu's does, at the circuit's aggregate
length (a sparse circuit's logical length).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from ..fields.field import Field
from .circuits import Circuit, Count, FixedPointVec, Histogram, SparseSumVec, Sum, SumVec, next_pow2
from .xof import (
    SEED_SIZE,
    USAGE_JOINT_RAND_PART,
    USAGE_JOINT_RAND_SEED,
    USAGE_JOINT_RANDOMNESS,
    USAGE_MEASUREMENT_SHARE,
    USAGE_PROOF_SHARE,
    USAGE_PROVE_RANDOMNESS,
    XofCtr128,
    XofSponge128,
    draft_dst,
    dst,
)


# ---------------------------------------------------------------------------
# Host NTT
# ---------------------------------------------------------------------------


def ntt(field: type[Field], coeffs: list[int], n: int) -> list[int]:
    """Evaluate a polynomial (len <= n coeffs) at the n-th roots w^0..w^{n-1}."""
    a = list(coeffs) + [0] * (n - len(coeffs))
    _ntt_inplace(field, a, field.root_of_unity(n))
    return a


def intt(field: type[Field], evals: list[int]) -> list[int]:
    """Inverse: values at w^0..w^{n-1} -> coefficients."""
    n = len(evals)
    a = list(evals)
    _ntt_inplace(field, a, field.inv(field.root_of_unity(n)))
    n_inv = field.inv(n)
    return [field.mul(x, n_inv) for x in a]


def _ntt_inplace(field: type[Field], a: list[int], root: int) -> None:
    n = len(a)
    assert n & (n - 1) == 0
    p = field.MODULUS
    # bit-reversal permutation
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        w_len = pow(root, n // length, p)
        for start in range(0, n, length):
            w = 1
            for k in range(length // 2):
                u = a[start + k]
                v = a[start + k + length // 2] * w % p
                a[start + k] = (u + v) % p
                a[start + k + length // 2] = (u - v) % p
                w = w * w_len % p
        length <<= 1


# ---------------------------------------------------------------------------
# The prover's side of the circuits of vdaf/circuits.py
# ---------------------------------------------------------------------------
#
# A circuit's field, lengths and gadget schedule are vdaf/circuits.py's,
# the shapes the device engine runs; this module adds the scalar encoding,
# the inputs of each gadget call and the gadget's value. Count checks
# x*x - x with one Mul; Sum checks each bit through PolyEval(x^2 - x);
# SumVec and Histogram check bits chunk-wise through ParallelSum(Mul,
# chunk_length), each bit weighted by a power of jr[0] (Histogram's
# sum-to-one check, weighted by jr[1], is the verifier's, not the
# prover's). FixedPointVec adds, after its bit-check calls, calls of
# (y_e, y_e) squares of the offset-corrected entry values.


def encode(circ: Circuit, measurement) -> list[int]:
    if isinstance(circ, Count):
        assert measurement in (0, 1)
        return [measurement]
    if isinstance(circ, Sum):
        assert 0 <= measurement < (1 << circ.bits)
        return [(measurement >> j) & 1 for j in range(circ.bits)]
    if isinstance(circ, SparseSumVec):
        # the compact encoding: front-packed blocks, zero padding
        measurement = circ.compact_values(measurement)[0]
    if isinstance(circ, SumVec):
        assert len(measurement) == circ.length
        out = []
        for v in measurement:
            assert 0 <= v < (1 << circ.bits)
            out.extend((v >> j) & 1 for j in range(circ.bits))
        return out
    if isinstance(circ, Histogram):
        assert 0 <= measurement < circ.length
        return [1 if i == measurement else 0 for i in range(circ.length)]
    if isinstance(circ, FixedPointVec):
        assert len(measurement) == circ.length
        out = []
        norm = 0
        for v in measurement:
            v = int(v)
            assert -circ.offset <= v < circ.offset, "entry out of [-1, 1)"
            u = v + circ.offset
            out.extend((u >> j) & 1 for j in range(circ.bits))
            norm += v * v
        assert norm < (1 << circ.norm_bits), "L2 norm must be < 1"
        out.extend((norm >> j) & 1 for j in range(circ.norm_bits))
        return out
    raise ValueError(f"{type(circ).__name__} has no host sharder in janus_tpu_torch")


def gadget_inputs(circ: Circuit, inp: list[int], joint_rand: list[int], shares_inv: int) -> list[list[int]]:
    """The input list (arity long) of each call of the circuit's one
    gadget; the constant 1 is shared as shares_inv."""
    if isinstance(circ, Count):
        return [[inp[0], inp[0]]]
    if isinstance(circ, Sum):
        return [[x] for x in inp]
    # (r^{i+1} x_i, x_i - 1) pairs, ParallelSum(Mul, chunk_length) per call
    F, ch, n, r = circ.FIELD, circ.chunk_length, circ.input_len, joint_rand[0]
    fixed = isinstance(circ, FixedPointVec)
    rp = r
    out = []
    for k in range(circ.calls_bits if fixed else circ.gadget_uses[0].calls):
        call_inputs = []
        for c in range(ch):
            i = k * ch + c
            if i < n:
                call_inputs += [F.mul(rp, inp[i]), F.sub(inp[i], shares_inv)]
                rp = F.mul(rp, r)
            else:
                call_inputs += [0, 0]
        out.append(call_inputs)
    if fixed:
        for k in range(circ.calls_sq):
            call_inputs = []
            for c in range(ch):
                e = k * ch + c
                if e < circ.length:
                    y = _entry_value(circ, inp, e, shares_inv)
                    call_inputs += [y, y]
                else:
                    call_inputs += [0, 0]
            out.append(call_inputs)
    return out


def _entry_value(circ: FixedPointVec, inp: list[int], e: int, shares_inv: int) -> int:
    """A share of entry e's value v_e = sum_j 2^j u_bits - offset (the
    offset split across the shares)."""
    F = circ.FIELD
    acc = 0
    for j in range(circ.bits):
        acc = F.add(acc, F.mul(pow(2, j, F.MODULUS), inp[e * circ.bits + j]))
    return F.sub(acc, F.mul(circ.offset, shares_inv))


def gadget_eval(circ: Circuit, inputs: list[int]) -> int:
    """The value of the circuit's gadget on one point's inputs."""
    F = circ.FIELD
    if isinstance(circ, Sum):  # PolyEval(x^2 - x)
        return F.sub(F.mul(inputs[0], inputs[0]), inputs[0])
    acc = 0  # Mul, or ParallelSum(Mul, chunk_length)
    for c in range(0, len(inputs), 2):
        acc = F.add(acc, F.mul(inputs[c], inputs[c + 1]))
    return acc


def fp_encode_floats(values, bits: int) -> list[int]:
    """Floats in [-1, 1) -> raw fixed-point ints (scale 2^(bits-1)), clamped."""
    scale = 1 << (bits - 1)
    out = []
    for x in values:
        v = int(round(float(x) * scale))
        out.append(max(-scale, min(scale - 1, v)))
    return out


# ---------------------------------------------------------------------------
# FLP prover
# ---------------------------------------------------------------------------


def flp_prove(circ: Circuit, inp: list[int], prove_rand: list[int], joint_rand: list[int]) -> list[int]:
    F = circ.FIELD
    (use,) = circ.gadget_uses
    g = use.gadget
    m = use.wire_poly_len
    calls_inputs = gadget_inputs(circ, inp, joint_rand, 1)
    seeds = list(prove_rand[: g.arity])
    wire_polys = []
    for j in range(g.arity):
        # wire values: seed at alpha^0, call k at alpha^{k+1}
        evals = [seeds[j]] + [ci[j] for ci in calls_inputs]
        evals += [0] * (m - len(evals))
        wire_polys.append(intt(F, evals))
    n2 = next_pow2(g.degree * (m - 1) + 1)
    wire_evals = [ntt(F, wp, n2) for wp in wire_polys]
    gadget_evals = [gadget_eval(circ, [wire_evals[j][i] for j in range(g.arity)]) for i in range(n2)]
    gpoly = intt(F, gadget_evals)
    keep = use.gadget_poly_len
    assert all(c == 0 for c in gpoly[keep:]), "gadget poly degree overflow"
    proof = seeds + gpoly[:keep]
    assert len(proof) == circ.proof_len
    return proof


# ---------------------------------------------------------------------------
# Prio3 sharding (DAP uses exactly 2 shares: leader=0, helper=1)
# ---------------------------------------------------------------------------


class VdafError(Exception):
    """A report the VDAF rejects (Poplar1's failed sketch, vdaf/poplar1.py)."""


@dataclass
class LeaderShare:
    measurement_share: list[int]
    proof_share: list[int]
    joint_rand_blind: bytes | None


@dataclass
class HelperShare:
    seed: bytes
    joint_rand_blind: bytes | None


class Prio3:
    """Host Prio3 sharding for one circuit; `mode` is the task's
    `xof_mode` ("fast" or "draft")."""

    NUM_SHARES = 2

    def __init__(self, circuit: Circuit, mode: str = "fast"):
        assert mode in ("fast", "draft")
        self.circuit = circuit
        self.mode = mode
        self.xof = XofCtr128 if mode == "fast" else XofSponge128

    def _dst(self, usage: int) -> bytes:
        if self.mode == "draft":
            return draft_dst(self.circuit.algo_id, usage)
        return dst(self.circuit.algo_id, usage)

    def _agg_id_bytes(self, agg_id: int) -> bytes:
        # fast mode keeps ids lane-aligned (8-byte LE); draft uses one byte
        if self.mode == "draft":
            return bytes([agg_id])
        return agg_id.to_bytes(8, "little")

    @property
    def uses_joint_rand(self) -> bool:
        return self.circuit.joint_rand_len > 0

    @property
    def rand_size(self) -> int:
        n = 2  # prove seed + helper seed
        if self.uses_joint_rand:
            n += self.NUM_SHARES  # blinds
        return n * SEED_SIZE

    def shard(self, measurement, nonce: bytes, rand: bytes | None = None):
        """-> (public share: the two joint-rand parts or [], [LeaderShare,
        HelperShare]); `rand` (rand_size bytes) is drawn when absent."""
        circ = self.circuit
        F = circ.FIELD
        if rand is None:
            rand = secrets.token_bytes(self.rand_size)
        assert len(rand) == self.rand_size
        seeds = [rand[i : i + SEED_SIZE] for i in range(0, len(rand), SEED_SIZE)]
        prove_seed, helper_seed = seeds[0], seeds[1]
        blinds = seeds[2:] if self.uses_joint_rand else [None, None]

        inp = encode(circ, measurement)
        agg1 = self._agg_id_bytes(1)
        helper_meas = self._next_vec(helper_seed, USAGE_MEASUREMENT_SHARE, agg1, circ.input_len)
        leader_meas = [F.sub(x, h) for x, h in zip(inp, helper_meas)]

        joint_rand: list[int] = []
        parts: list[bytes] = []
        if self.uses_joint_rand:
            # fast mode binds the helper's 16-byte seed; draft mode binds
            # the full expanded share, as the draft specifies
            helper_binder = helper_seed if self.mode == "fast" else F.encode_vec(helper_meas)
            parts = [
                self._joint_rand_part(0, blinds[0], nonce, F.encode_vec(leader_meas)),
                self._joint_rand_part(1, blinds[1], nonce, helper_binder),
            ]
            jr_seed = self._joint_rand_seed(parts)
            joint_rand = self._next_vec(jr_seed, USAGE_JOINT_RANDOMNESS, b"", circ.joint_rand_len)

        prove_rand = self._next_vec(prove_seed, USAGE_PROVE_RANDOMNESS, b"", circ.prove_rand_len)
        proof = flp_prove(circ, inp, prove_rand, joint_rand)
        helper_proof = self._next_vec(helper_seed, USAGE_PROOF_SHARE, agg1, circ.proof_len)
        leader_proof = [F.sub(x, h) for x, h in zip(proof, helper_proof)]

        shares = [
            LeaderShare(leader_meas, leader_proof, blinds[0]),
            HelperShare(helper_seed, blinds[1]),
        ]
        return parts, shares

    def unshard(self, agg_shares: list[list[int]], num_measurements: int):
        """The collector's step: sum the aggregators' aggregate shares
        and decode the sum into the circuit's result."""
        F = self.circuit.FIELD
        agg = [0] * self.circuit.agg_output_len
        for s in agg_shares:
            agg = [F.add(a, b) for a, b in zip(agg, s)]
        return self.circuit.decode(agg, num_measurements)

    def _next_vec(self, seed: bytes, usage: int, binder: bytes, length: int) -> list[int]:
        return self.xof(seed, self._dst(usage), binder).next_vec(self.circuit.FIELD, length)

    def _joint_rand_part(self, agg_id: int, blind: bytes, nonce: bytes, share_binder: bytes) -> bytes:
        return self.xof.derive_seed(
            blind, self._dst(USAGE_JOINT_RAND_PART), self._agg_id_bytes(agg_id) + nonce + share_binder
        )

    def _joint_rand_seed(self, parts: list[bytes]) -> bytes:
        return self.xof.derive_seed(b"\x00" * SEED_SIZE, self._dst(USAGE_JOINT_RAND_SEED), b"".join(parts))


class SparsePublicShare(list):
    """Public share of a sparse report: the joint-randomness parts (the
    list itself) and the public block indices (janus_tpu's)."""

    __slots__ = ("indices",)

    def __init__(self, parts, indices):
        super().__init__(parts)
        self.indices = tuple(int(i) for i in indices)


class Prio3Sparse(Prio3):
    """Host Prio3 over a SparseSumVec: the compact-length Prio3 shard,
    with the block indices in the public share. Like Prio3 it has no
    prepare and no aggregate: the aggregators scatter on the device
    (EngineCache.aggregate_sparse)."""

    def shard(self, measurement, nonce: bytes, rand: bytes | None = None):
        indices = self.circuit.encode_indices(measurement)
        parts, shares = super().shard(measurement, nonce, rand)
        return SparsePublicShare(parts, indices), shares
