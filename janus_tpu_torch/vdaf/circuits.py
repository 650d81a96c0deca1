"""Prio3 validity-circuit parameters: field, lengths, gadget schedule.

The batched engine (vdaf/engine.py) needs each circuit's shape only:
its field, input/output/joint-rand lengths, chunk length and the one
gadget use (gadget arity and degree, number of calls), from which the
FLP lengths follow. Count checks x*x - x with one Mul; Sum checks each
bit through PolyEval(x^2 - x); SumVec and Histogram check bits
chunk-wise through ParallelSum(Mul, chunk_length).
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


class Count(Circuit):
    """measurement in {0,1}; check x*x - x == 0. Field64, one Mul call."""

    FIELD = Field64
    input_len = 1
    joint_rand_len = 0
    output_len = 1
    algo_id = 0x00000000

    def __init__(self):
        self.gadget_uses = [GadgetUse(MUL, 1)]


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
