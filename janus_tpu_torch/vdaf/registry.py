"""VDAF instances of the port's slice and their batched Prio3 engines.

A serializable description of one VDAF configuration (the JAX
package's vdaf/registry.py VdafInstance, for the four Prio3 kinds on the
device path) that resolves to a circuit and to a Prio3Batched engine on
a device. Both XOF modes run here: "fast" on Prio3Batched, "draft"
(VDAF-07) on Prio3BatchedDraft for the circuits it takes. A client's
host sharder for one report is `prio3_host` (vdaf/reference.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from ..device import resolve_device
from .circuits import Circuit, Count, Histogram, Sum, SumVec
from .draft import Prio3BatchedDraft
from .feasibility import device_memory_budget
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

    @property
    def rounds(self) -> int:
        """DAP prepare rounds: 1 for every Prio3 kind of the port."""
        return 1

    @property
    def has_aggregation_parameter(self) -> bool:
        """Prio3 takes no aggregation parameter; Poplar1 does (its
        collection raises NotPorted)."""
        return self.kind == "poplar1"

    def fails_at(self, stage: str) -> bool:
        """The JAX package's seam for its test-only failing fakes; no
        port kind fails on purpose."""
        assert stage in ("init", "step")
        return False

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        for k in ("bits", "length", "chunk_length"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        if self.xof_mode != "fast":
            d["xof_mode"] = self.xof_mode
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "VdafInstance":
        """Read what janus_tpu's VdafInstance.to_dict writes. Kinds and
        fields the port has no device path for raise ValueError."""
        if d.get("block_size") or d.get("max_blocks"):
            raise ValueError(f"VDAF {d} (block-sparse) has no device path in janus_tpu_torch")
        inst = cls(
            d["kind"],
            bits=d.get("bits", 0),
            length=d.get("length", 0),
            chunk_length=d.get("chunk_length", 0),
            xof_mode=d.get("xof_mode", "fast"),
        )
        circuit_for(inst)
        return inst


@lru_cache(maxsize=None)
def circuit_for(inst: VdafInstance) -> Circuit:
    if inst.xof_mode not in ("fast", "draft"):
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
    circ = circuit_for(inst)
    if inst.xof_mode == "draft":
        refusal = Prio3BatchedDraft.refusal(circ, device_memory_budget(device))
        if refusal is not None:
            raise ValueError(f"no device draft engine for {inst.to_dict()}: {refusal}")
        return Prio3BatchedDraft(circ, device=device)
    return Prio3Batched(circ, device=device)


def prio3_batched(inst: VdafInstance, device=None) -> Prio3Batched:
    """The batched engine of `inst` on `device` (CUDA unless the caller
    passes "cpu"), cached per (instance, device). A draft instance whose
    streams or memory the draft engine cannot take raises ValueError."""
    return _prio3_batched(inst, resolve_device(device))


@lru_cache(maxsize=None)
def prio3_host(inst: VdafInstance):
    """The host sharder of `inst` (vdaf/reference.py Prio3), for a
    client that shards one report at a time."""
    if inst.kind == "sparse_sumvec":
        from ..aggregator.errors import NotPorted

        raise NotPorted("sparse SumVec is not ported to janus_tpu_torch yet")
    from .reference import Prio3

    return Prio3(circuit_for(inst), mode=inst.xof_mode)
