"""VDAF instances of the port's slice and their batched Prio3 engines.

A serializable description of one VDAF configuration (the JAX
package's vdaf/registry.py VdafInstance, for the four Prio3 kinds on the
device path) that resolves to a circuit and to a Prio3Batched engine on
a device. Only the fast XOF mode runs here.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from ..device import resolve_device
from .circuits import Circuit, Count, Histogram, Sum, SumVec
from .prio3 import Prio3Batched


@dataclass(frozen=True)
class VdafInstance:
    """One VDAF configuration; hashable so dispatch results are cached."""

    kind: str  # "count" | "sum" | "sumvec" | "histogram"
    bits: int = 0
    length: int = 0
    chunk_length: int = 0  # 0 -> sqrt heuristic
    xof_mode: str = "fast"

    @classmethod
    def count(cls) -> "VdafInstance":
        return cls("count")

    @classmethod
    def sum(cls, bits: int) -> "VdafInstance":
        return cls("sum", bits=bits)

    @classmethod
    def sum_vec(cls, length: int, bits: int, chunk_length: int = 0) -> "VdafInstance":
        return cls("sumvec", bits=bits, length=length, chunk_length=chunk_length)

    @classmethod
    def histogram(cls, length: int, chunk_length: int = 0) -> "VdafInstance":
        return cls("histogram", length=length, chunk_length=chunk_length)

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        for k in ("bits", "length", "chunk_length"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        if self.xof_mode != "fast":
            d["xof_mode"] = self.xof_mode
        return d


@lru_cache(maxsize=None)
def circuit_for(inst: VdafInstance) -> Circuit:
    if inst.xof_mode != "fast":
        raise ValueError(f"xof_mode {inst.xof_mode!r} has no device path in janus_tpu_torch")
    ch = inst.chunk_length or None
    if inst.kind == "count":
        return Count()
    if inst.kind == "sum":
        return Sum(bits=inst.bits)
    if inst.kind == "sumvec":
        return SumVec(length=inst.length, bits=inst.bits, chunk_length=ch)
    if inst.kind == "histogram":
        return Histogram(length=inst.length, chunk_length=ch)
    raise ValueError(f"VDAF kind {inst.kind!r} has no device path in janus_tpu_torch")


@lru_cache(maxsize=None)
def _prio3_batched(inst: VdafInstance, device: torch.device) -> Prio3Batched:
    return Prio3Batched(circuit_for(inst), device=device)


def prio3_batched(inst: VdafInstance, device=None) -> Prio3Batched:
    """The batched engine of `inst` on `device` (CUDA unless the caller
    passes "cpu"), cached per (instance, device)."""
    return _prio3_batched(inst, resolve_device(device))
