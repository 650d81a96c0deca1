"""Prio3 validity-circuit parameters: field, lengths, gadget schedule.

The batched engine (vdaf/engine.py) needs each circuit's shape only:
its field, input/output/joint-rand lengths, chunk length and the one
gadget use (gadget arity and degree, number of calls), from which the
FLP lengths follow. Count checks x*x - x with one Mul; Sum checks each
bit through PolyEval(x^2 - x); SumVec and Histogram check bits
chunk-wise through ParallelSum(Mul, chunk_length); CountVec is SumVec
with one bit an entry; FixedPointVec checks its bits and its L2 norm
through one ParallelSum(Mul, chunk_length) use. The collector turns
an unsharded aggregate into its result with each circuit's `decode`
(janus_tpu/vdaf/reference.py Circuit.decode).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.field import Field, Field64, Field128

AGG1 = (1).to_bytes(8, "little")  # helper aggregator id, lane-aligned
EVAL_POINT_CANDIDATES = 4  # fixed draw per gadget; first t with t^m != 1 wins


def next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def optimal_chunk_length(measurement_length: int) -> int:
    """sqrt-ish chunk size balancing gadget arity against calls."""
    return max(1, int(measurement_length**0.5))


@dataclass(frozen=True)
class Gadget:
    arity: int
    degree: int


MUL = Gadget(arity=2, degree=2)
POLY_EVAL_BIT = Gadget(arity=1, degree=2)  # x^2 - x


def parallel_sum(inner: Gadget, count: int) -> Gadget:
    """ParallelSum(inner, count): `count` inner calls summed, one gadget."""
    return Gadget(arity=inner.arity * count, degree=inner.degree)


@dataclass(frozen=True)
class GadgetUse:
    gadget: Gadget
    calls: int

    @property
    def wire_poly_len(self) -> int:  # m
        return next_pow2(1 + self.calls)

    @property
    def gadget_poly_len(self) -> int:  # degree*(m-1) + 1 coefficients
        return self.gadget.degree * (self.wire_poly_len - 1) + 1


class Circuit:
    FIELD: type[Field]
    input_len: int
    joint_rand_len: int
    output_len: int
    gadget_uses: list[GadgetUse]
    algo_id: int

    @property
    def prove_rand_len(self) -> int:
        return sum(g.gadget.arity for g in self.gadget_uses)

    @property
    def query_rand_len(self) -> int:
        return EVAL_POINT_CANDIDATES * len(self.gadget_uses)

    @property
    def proof_len(self) -> int:
        return sum(g.gadget.arity + g.gadget_poly_len for g in self.gadget_uses)

    @property
    def verifier_len(self) -> int:
        return 1 + sum(g.gadget.arity + 1 for g in self.gadget_uses)

    def decode(self, output: list[int], num_measurements: int):
        """The aggregate result of an unsharded aggregate `output`."""
        raise NotImplementedError


class Count(Circuit):
    """measurement in {0,1}; check x*x - x == 0. Field64, one Mul call."""

    FIELD = Field64
    input_len = 1
    joint_rand_len = 0
    output_len = 1
    algo_id = 0x00000000

    def __init__(self):
        self.gadget_uses = [GadgetUse(MUL, 1)]

    def decode(self, output, num_measurements):
        return output[0]


class Sum(Circuit):
    """measurement in [0, 2^bits); input = bit decomposition."""

    FIELD = Field128
    joint_rand_len = 1
    output_len = 1
    algo_id = 0x00000001

    def __init__(self, bits: int):
        self.bits = bits
        self.input_len = bits
        self.gadget_uses = [GadgetUse(POLY_EVAL_BIT, bits)]

    def decode(self, output, num_measurements):
        return output[0]


class SumVec(Circuit):
    """Vector of `length` values, each in [0, 2^bits); input is the
    length*bits bits, checked chunk-wise by ParallelSum(Mul, chunk)."""

    FIELD = Field128
    joint_rand_len = 1
    algo_id = 0x00000002

    def __init__(self, length: int, bits: int, chunk_length: int | None = None):
        self.length = length
        self.bits = bits
        self.input_len = length * bits
        self.output_len = length
        self.chunk_length = chunk_length or optimal_chunk_length(self.input_len)
        calls = -(-self.input_len // self.chunk_length)
        self.gadget_uses = [GadgetUse(parallel_sum(MUL, self.chunk_length), calls)]

    def decode(self, output, num_measurements):
        return list(output)


class Histogram(Circuit):
    """One-hot vector of `length` buckets: every entry is a bit (chunked
    as in SumVec, weighted by powers of jr[0]) and the entries sum to
    one (weighted by jr[1])."""

    FIELD = Field128
    joint_rand_len = 2
    algo_id = 0x00000003

    def __init__(self, length: int, chunk_length: int | None = None):
        self.length = length
        self.input_len = length
        self.output_len = length
        self.chunk_length = chunk_length or optimal_chunk_length(length)
        calls = -(-length // self.chunk_length)
        self.gadget_uses = [GadgetUse(parallel_sum(MUL, self.chunk_length), calls)]

    def decode(self, output, num_measurements):
        return list(output)


class FixedPointVec(Circuit):
    """Fixed-point vector with bounded L2 norm (janus_tpu/vdaf/reference.py
    FixedPointVec, the reference's Prio3FixedPoint{16,32,64}BitBoundedL2VecSum).

    Each of `length` entries is a signed fixed-point value v in
    [-2^(bits-1), 2^(bits-1)), standing for v / 2^(bits-1) in [-1, 1).
    The input is, per entry, the `bits` bits of the offset-binary value
    u = v + 2^(bits-1), then `norm_bits = 2*bits - 2` bits claiming the
    norm N = sum v_i^2. One ParallelSum(Mul, chunk) gadget use carries
    both checks: `calls_bits` calls of joint-rand-weighted bit checks
    over every input position, then `calls_sq` calls of (y_e, y_e)
    squares of the entry values. The output is u per entry; `decode`
    removes count * offset.

    The integer norm must not wrap mod p: length * 4^(bits-1) < p, so at
    64 bits the length is at most 3.
    """

    FIELD = Field128
    joint_rand_len = 2
    algo_id = 0x00FF0001  # private codepoint; not in the VDAF registry

    def __init__(self, length: int, bits: int, chunk_length: int | None = None):
        if bits not in (16, 32, 64):
            raise ValueError("fixed-point bits must be 16, 32 or 64")
        if length < 1:
            raise ValueError("length must be >= 1")
        if length * (1 << (2 * bits - 2)) >= self.FIELD.MODULUS:
            raise ValueError(
                f"length {length} too large for {bits}-bit entries: integer norm would overflow Field128"
            )
        self.length = length
        self.bits = bits
        self.norm_bits = 2 * bits - 2
        self.n_bits = length * bits + self.norm_bits  # bit-checked positions
        self.input_len = self.n_bits
        self.output_len = length
        self.offset = 1 << (bits - 1)
        self.chunk_length = chunk_length or optimal_chunk_length(self.n_bits)
        ch = self.chunk_length
        self.calls_bits = -(-self.n_bits // ch)
        self.calls_sq = -(-length // ch)
        self.gadget_uses = [GadgetUse(parallel_sum(MUL, ch), self.calls_bits + self.calls_sq)]

    def decode(self, output, num_measurements):
        F = self.FIELD
        half = F.MODULUS // 2
        res = []
        for u in output:
            t = F.sub(u, F.mul(self.offset, num_measurements))
            signed = t - F.MODULUS if t > half else t
            res.append(signed / self.offset)
        return res

