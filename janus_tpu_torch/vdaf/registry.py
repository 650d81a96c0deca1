"""VDAF instances of the port's slice and their batched Prio3 engines.

A serializable description of one VDAF configuration (the JAX
package's vdaf/registry.py VdafInstance, for the seven Prio3 kinds on the
device path, Poplar1 and the four test fakes) that resolves to a circuit
and to a Prio3Batched engine on a device. Both XOF modes run here:
"fast" on Prio3Batched, "draft" (VDAF-07) on Prio3BatchedDraft for the
circuits it takes. A client's host sharder for one report is
`prio3_host` (vdaf/reference.py). Block-sparse SumVec runs its FLP on
the compact SumVec engine and scatters its aggregate by the public
block indices (Prio3Batched.scatter_rows). Poplar1 has no circuit: the
aggregators run it through aggregator/poplar1_ops.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch

from ..device import resolve_device
from .circuits import Circuit, Count, FixedPointVec, Histogram, SparseSumVec, Sum, SumVec
from .draft import Prio3BatchedDraft
from .feasibility import device_memory_budget
from .prio3 import Prio3Batched


@dataclass(frozen=True)
class VdafInstance:
    """One VDAF configuration; hashable so dispatch results are cached."""

    # "count" | "sum" | "sumvec" | "sparse_sumvec" | "histogram" | "countvec"
    # | "fixedpoint" | "poplar1" | the fakes
    kind: str
    bits: int = 0
    length: int = 0
    chunk_length: int = 0  # 0 -> sqrt heuristic
    # block-sparse geometry (sparse_sumvec only): up to `max_blocks`
    # blocks of `block_size` values of a `length`-dim logical vector
    block_size: int = 0
    max_blocks: int = 0
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
    def sparse_sumvec(
        cls, bits: int, length: int, block_size: int, max_blocks: int, chunk_length: int = 0
    ) -> "VdafInstance":
        """Block-sparse vector sum: a logical `length`-dim vector carried
        as up to `max_blocks` (block_index, `block_size` values) pairs;
        the FLP runs at the compact length max_blocks * block_size."""
        return cls(
            "sparse_sumvec", bits=bits, length=length, chunk_length=chunk_length,
            block_size=block_size, max_blocks=max_blocks,
        )

    @classmethod
    def histogram(cls, length: int, chunk_length: int = 0) -> "VdafInstance":
        return cls("histogram", length=length, chunk_length=chunk_length)

    @classmethod
    def count_vec(cls, length: int, chunk_length: int = 0) -> "VdafInstance":
        """A vector of counts (Prio3CountVec): SumVec with one bit an entry."""
        return cls("countvec", bits=1, length=length, chunk_length=chunk_length)

    @classmethod
    def fixed_point_vec(cls, length: int, bits: int = 16, chunk_length: int = 0) -> "VdafInstance":
        """A fixed-point vector sum with bounded L2 norm (Prio3FixedPoint{16,
        32,64}BitBoundedL2VecSum): `bits` is 16, 32 or 64."""
        return cls("fixedpoint", bits=bits, length=length, chunk_length=chunk_length)

    @classmethod
    def poplar1(cls, bits: int) -> "VdafInstance":
        """Heavy hitters over an IDPF with aggregation parameters (level,
        prefixes): the collection flow makes param-scoped aggregation
        jobs and the two-round sketch exchange runs on the continue
        step (aggregator/poplar1_ops.py)."""
        return cls("poplar1", bits=bits)

    # --- test-only fakes (janus_tpu's, after the reference's
    # VdafInstance::Fake* variants). They run the Count circuit and force
    # per-report prepare failures at the aggregators' dispatch sites, or
    # take two rounds, to exercise error paths and the continue step.
    @classmethod
    def fake(cls) -> "VdafInstance":
        return cls("fake")

    @classmethod
    def fake_fails_prep_init(cls) -> "VdafInstance":
        return cls("fake_fails_prep_init")

    @classmethod
    def fake_fails_prep_step(cls) -> "VdafInstance":
        return cls("fake_fails_prep_step")

    @classmethod
    def fake_two_round(cls) -> "VdafInstance":
        """Two-round fake: the helper parks in WaitingHelper and the
        continue request finishes it; round 2 is a prep-message echo."""
        return cls("fake_two_round")

    @property
    def rounds(self) -> int:
        """DAP prepare rounds: 1 for Prio3; 2 for Poplar1 (sketch
        exchange, then verify) and the two-round fake."""
        return 2 if self.kind in ("fake_two_round", "poplar1") else 1

    @property
    def has_aggregation_parameter(self) -> bool:
        """Poplar1 takes an aggregation parameter (level, prefixes):
        reports aggregate once per parameter, in jobs the collection
        flow creates."""
        return self.kind == "poplar1"

    def fails_at(self, stage: str) -> bool:
        """The seam of the fakes' failure dispatch sites: stage "init"
        (prepare initialization) or "step" (continue/finish)."""
        assert stage in ("init", "step")
        return self.kind == f"fake_fails_prep_{stage}"

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        for k in ("bits", "length", "chunk_length", "block_size", "max_blocks"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        if self.xof_mode != "fast":
            d["xof_mode"] = self.xof_mode
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "VdafInstance":
        """Read what janus_tpu's VdafInstance.to_dict writes. Kinds and
        fields the port has no device path for raise ValueError."""
        inst = cls(
            d["kind"],
            bits=d.get("bits", 0),
            length=d.get("length", 0),
            chunk_length=d.get("chunk_length", 0),
            xof_mode=d.get("xof_mode", "fast"),
            block_size=d.get("block_size", 0),
            max_blocks=d.get("max_blocks", 0),
        )
        if inst.kind == "poplar1":
            if not 1 <= inst.bits <= 64:
                raise ValueError(f"Poplar1 with {inst.bits} bits has no device path in janus_tpu_torch")
        else:
            circuit_for(inst)
        return inst


FAKE_KINDS = ("fake", "fake_fails_prep_init", "fake_fails_prep_step", "fake_two_round")


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
    if inst.kind == "sparse_sumvec":
        return SparseSumVec(
            length=inst.length, block_size=inst.block_size, max_blocks=inst.max_blocks, bits=inst.bits, chunk_length=ch
        )
    if inst.kind == "histogram":
        return Histogram(length=inst.length, chunk_length=ch)
    if inst.kind == "countvec":
        return SumVec(length=inst.length, bits=1, chunk_length=ch)
    if inst.kind == "fixedpoint":
        return FixedPointVec(length=inst.length, bits=inst.bits, chunk_length=ch)
    if inst.kind in FAKE_KINDS:
        return Count()
    if inst.kind == "poplar1":
        # janus_tpu's words: a taskprov opt-in's problem document carries them
        raise ValueError(
            "Poplar1 has no FLP circuit: the aggregator dispatches it to "
            "aggregator.poplar1_ops (IDPF + sketch over per-parameter "
            "prefixes), not the Prio3 engine"
        )
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
    """The host sharder of `inst` (vdaf/reference.py Prio3, or
    Prio3Sparse for block-sparse SumVec), for a client that shards one
    report at a time."""
    from .reference import Prio3, Prio3Sparse

    cls = Prio3Sparse if inst.kind == "sparse_sumvec" else Prio3
    return cls(circuit_for(inst), mode=inst.xof_mode)
