"""The two-party prepare + aggregate step, on one device or over a device mesh.

`two_party_step` is everything the aggregators do per report in one
aggregation job (leader prepare-init, helper prepare-init, combine and
decide, finish, masked aggregate), as one function over a report batch;
`helper_init_step` is the helper's prepare-init alone, the serving hot
path. Both equal the JAX package's parallel/api.py on the same inputs.

The mesh (`make_mesh`, `DeviceMesh`) is a dp x sp grid of devices that
one process drives, as the JAX package's single-controller `Mesh` is:

  - **dp** splits the report rows: every batch bucket is a power of two
    of at least MIN_BUCKET rows, so dp divides it, and row block i runs
    on row i's first device as a single-device step (the kernels launch
    there, on that device's current stream);
  - **sp** splits the measurement and out-share columns of long vectors:
    a row block's measurement columns are staged over the row's sp
    devices (`ColumnShards`) and gathered on its first device for the
    FLP query, which needs the whole vector; the out-share columns go
    back over the sp devices for the aggregate.

The partial aggregates reduce onto the mesh's first device by modular
field addition (the limbs carry, so never a raw sum of limbs), the
accepted count as an integer sum. A device may repeat in a mesh: two
shards on one card run one after the other on its stream, and their
copies cost nothing. Where the JAX package turns its Pallas kernels off
on a multi-device process (`pallas_call` has no SPMD rule), the shards
here are single-device steps and keep kernels 1-3; the values are the
same bit for bit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda_build import shard_scope
from ..vdaf.registry import VdafInstance, prio3_batched

class DeviceMesh:
    """A dp x sp grid of torch devices, row-major: device (i, j) serves
    dp row i's column block j. `distinct` is False where a device repeats
    (a rehearsal of the mesh on fewer cards)."""

    axis_names = ("dp", "sp")

    def __init__(self, devices, dp: int, sp: int):
        if len(devices) != dp * sp:
            raise ValueError(f"a {dp} x {sp} mesh takes {dp * sp} devices, got {len(devices)}")
        self.devices = tuple(devices)
        self.dp = dp
        self.sp = sp
        self.distinct = len(set(self.devices)) == len(self.devices)

    @property
    def shape(self) -> tuple[int, int]:
        return self.dp, self.sp

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def device(self, i: int, j: int = 0) -> torch.device:
        return self.devices[i * self.sp + j]

    def row(self, i: int) -> tuple:
        """The sp devices of dp row i."""
        return self.devices[i * self.sp : (i + 1) * self.sp]


def make_mesh(dp: int, sp: int = 1, devices=None) -> DeviceMesh:
    """A (dp, sp) mesh over the first dp * sp of `devices`.

    devices=None takes cuda:0 .. cuda:n-1 and raises without CUDA, as
    `resolve_device` does. An explicit list may repeat a device (the
    rehearsal on one card; `["cpu"] * 4` in the tests)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "janus_tpu_torch runs on CUDA and no CUDA device is available; "
                "pass devices=['cpu', ...] to build a mesh on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    n = dp * sp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return DeviceMesh(devices[:n], dp, sp)


def choose_mesh_geometry(
    ndev: int,
    input_len: int,
    output_len: int,
    sp_min_input_len: int,
    max_dp: int,
    dp: int | None = None,
    sp: int | None = None,
) -> tuple[int, int]:
    """Pick the (dp, sp) serving geometry for a circuit on `ndev` devices.

    Auto (dp/sp None): dp = largest power of two <= ndev, capped at
    `max_dp` (every batch bucket must divide by dp); long-vector tasks
    (input_len >= sp_min_input_len, even input/output lengths) trade one
    dp factor for sp=2 so the measurement/out-share columns shard too.

    Explicit dp/sp (the `engine: mesh:` config stanza / JANUS_MESH_DP/SP
    overrides) are validated, not trusted: non-power-of-two dp rounds
    down (bucket divisibility), dp*sp is clamped to the devices that
    exist, and sp>1 on a circuit whose input/output lengths can't split
    evenly falls back to sp=1. One device — or an override forcing
    dp=sp=1 — means the single-device path: callers get (1, 1) and build
    no mesh.
    """
    if ndev <= 1:
        return 1, 1
    auto_dp = 1 << (ndev.bit_length() - 1)  # largest power of two <= ndev
    if sp is not None:
        sp = max(1, int(sp))
    if dp is not None:
        dp = max(1, int(dp))
        dp = 1 << (dp.bit_length() - 1)  # buckets must divide by dp
    vec_ok = (
        input_len >= sp_min_input_len and input_len % 2 == 0 and output_len % 2 == 0
    )
    if dp is None and sp is None:
        dp, sp = auto_dp, 1
        if dp >= 2 and vec_ok:
            sp = 2
            dp //= 2
    else:
        if sp is None:
            sp = 1
        if sp > 1 and not (input_len % sp == 0 and output_len % sp == 0):
            sp = 1
        if dp is None:
            dp = max(1, auto_dp // sp)
            dp = 1 << (dp.bit_length() - 1)
    while dp > 1 and dp * sp > ndev:
        dp //= 2
    if dp * sp > ndev:
        return 1, 1  # override asks for more devices than exist
    dp = min(dp, max_dp)
    return max(1, dp), max(1, sp)


# --- moving values between the mesh's devices ---


def device_scope(device: torch.device):
    """`device` as the thread's current one for the block (CUDA only): the
    kernels launch on the current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_device(t: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """t on dst; t itself where it lies there. Between two CUDA devices the
    copy is issued non-blocking on dst's current stream after an event
    recorded on the source's current stream, so it reads t only once the
    source's queued work has written it. From pinned host memory the copy
    is non-blocking on dst's current stream."""
    if t.device == dst:
        return t
    if t.device.type == "cuda" and dst.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        stream = torch.cuda.current_stream(dst)
        stream.wait_event(ready)
        with torch.cuda.device(dst), torch.cuda.stream(stream):
            return t.to(dst, non_blocking=True)
    return t.to(dst, non_blocking=dst.type == "cuda" and t.is_pinned())


def _move(a, dst):
    """An arg (None, bytes, a limb tuple or a tensor) on dst."""
    if a is None or isinstance(a, (bytes, int)):
        return a
    if isinstance(a, tuple):
        return tuple(to_device(x, dst) for x in a)
    return to_device(a, dst)


def _col_splits(length: int, sp: int) -> list:
    if length % sp:
        raise ValueError(f"{length} columns do not split over sp = {sp}")
    w = length // sp
    return [(j * w, (j + 1) * w) for j in range(sp)]


class ColumnShards:
    """A field value split by its last axis over a mesh row's sp devices:
    `blocks[j]` is a limb tuple on the row's device j, holding columns
    [j * w, (j + 1) * w)."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = list(blocks)

    @classmethod
    def split(cls, value, devices) -> "ColumnShards":
        """Split a limb tuple's columns over `devices` (one block each)."""
        spans = _col_splits(value[0].shape[-1], len(devices))
        return cls(
            tuple(to_device(x[..., s:e], dev) for x in value) for (s, e), dev in zip(spans, devices)
        )

    def gather(self, dst: torch.device):
        """The whole value as one limb tuple on dst."""
        if len(self.blocks) == 1:
            return _move(self.blocks[0], dst)
        parts = [_move(blk, dst) for blk in self.blocks]
        return tuple(torch.cat([p[k] for p in parts], dim=-1) for k in range(len(parts[0])))

    def row(self, j: int) -> "ColumnShards":
        return ColumnShards(tuple(x[j] for x in blk) for blk in self.blocks)

    def add(self, tf, other: "ColumnShards") -> "ColumnShards":
        """Block by block, each on its own device (modular)."""
        return ColumnShards(tf.add(a, _move(b, a[0].device)) for a, b in zip(self.blocks, other.blocks))

    def to_ints(self, tf) -> np.ndarray:
        """The field elements in column order (gathers on the host)."""
        return np.concatenate([np.asarray(tf.to_ints(blk)) for blk in self.blocks])

    def to_host(self):
        """The limb tuple on the CPU."""
        return self.gather(torch.device("cpu"))


def stage_shards(mesh: DeviceMesh, args, specs):
    """Each dp row's block of every arg, placed on the mesh: spec "rows"
    puts the row block on row i's first device, "vec2" (a field limb
    tuple) also splits its columns over row i's sp devices
    (`ColumnShards`). None and bytes args pass as they are. Returns one
    arg tuple per dp row."""
    b = next(a.shape[0] if not isinstance(a, tuple) else a[0].shape[0]
             for a in args if a is not None and not isinstance(a, (bytes, int)))
    if b % mesh.dp:
        raise ValueError(f"a bucket of {b} rows does not split over dp = {mesh.dp}")
    h = b // mesh.dp
    shards = []
    for i in range(mesh.dp):
        s, e = i * h, (i + 1) * h
        row = []
        for a, spec in zip(args, specs):
            if a is None or isinstance(a, (bytes, int)):
                row.append(a)
            elif spec == "vec2":
                row.append(ColumnShards.split(tuple(x[s:e] for x in a), mesh.row(i)))
            elif isinstance(a, tuple):
                row.append(tuple(to_device(x[s:e], mesh.device(i)) for x in a))
            else:
                row.append(to_device(a[s:e], mesh.device(i)))
        shards.append(tuple(row))
    return shards


def reduce_columns(tf, parts) -> ColumnShards:
    """Sum dp rows' column-sharded partials (parts[i] a ColumnShards on
    row i) onto row 0's devices, block by block, by modular addition."""
    total = parts[0]
    for p in parts[1:]:
        total = total.add(tf, p)
    return total


def reduce_count(counts, dst: torch.device) -> torch.Tensor:
    """Accepted counts of every shard summed as integers on dst."""
    total = to_device(counts[0], dst)
    for c in counts[1:]:
        total = total + to_device(c, dst)
    return total


# --- the steps ---


def two_party_step(inst: VdafInstance, verify_key: bytes, device=None):
    """A function mapping the column-batched report tensors to both
    aggregate shares and the accepted-report count. Runs on CUDA unless
    the caller passes device="cpu"."""
    p3 = prio3_batched(inst, device)

    def step(nonce_lanes, public_parts, leader_meas, leader_proof, blind0, helper_seed, blind1):
        out0, seed0, ver0, part0 = p3.prepare_init_leader(
            verify_key, nonce_lanes, public_parts, leader_meas, leader_proof, blind0
        )
        out1, seed1, ver1, part1 = p3.prepare_init_helper(
            verify_key, nonce_lanes, public_parts, helper_seed, blind1
        )
        mask, prep_msg = p3.prep_shares_to_prep(ver0, ver1, part0, part1)
        mask = p3.prepare_finish(seed0, prep_msg, mask)
        mask = p3.prepare_finish(seed1, prep_msg, mask)
        agg0 = p3.aggregate(out0, mask)
        agg1 = p3.aggregate(out1, mask)
        return agg0, agg1, mask.sum()

    return step


def helper_init_step(inst: VdafInstance, verify_key: bytes, device=None):
    """Helper-side prepare-init only: seeds in, (out share, corrected
    seed, verifier share, own joint-rand part) out."""
    p3 = prio3_batched(inst, device)

    def step(nonce_lanes, public_parts, helper_seed, blind1):
        return p3.prepare_init_helper(verify_key, nonce_lanes, public_parts, helper_seed, blind1)

    return step


def _mesh_engines(inst: VdafInstance, mesh: DeviceMesh):
    """Each dp row's engine, on the row's first device; checks that sp
    splits the circuit's measurement and out-share columns."""
    p3s = [prio3_batched(inst, mesh.device(i)) for i in range(mesh.dp)]
    circ = p3s[0].circ
    if mesh.sp > 1:
        _col_splits(circ.input_len, mesh.sp)
        _col_splits(circ.output_len, mesh.sp)
    return p3s


TWO_PARTY_SPECS = ("rows", "rows", "vec2", "rows", "rows", "rows", "rows")


def sharded_two_party_step(inst: VdafInstance, verify_key: bytes, mesh: DeviceMesh):
    """`two_party_step` over a mesh, the counterpart of the JAX package's
    `jit_two_party_step`: rows split over dp, each row block's step on its
    row's first device, the leader's measurement columns staged over sp
    and gathered for the query, the out-share columns split back over sp
    for the aggregate. Returns (agg0, agg1, count) on the mesh's first
    device, equal to the single-device step bit for bit."""
    p3s = _mesh_engines(inst, mesh)
    tf = p3s[0].tf

    def step(nonce_lanes, public_parts, leader_meas, leader_proof, blind0, helper_seed, blind1):
        args = (nonce_lanes, public_parts, leader_meas, leader_proof, blind0, helper_seed, blind1)
        parts0, parts1, counts = [], [], []
        for i, shard in enumerate(stage_shards(mesh, args, TWO_PARTY_SPECS)):
            nonce, public, meas, proof, b0, hseed, b1 = shard
            p3 = p3s[i]
            with device_scope(mesh.device(i)), shard_scope(i):
                # the FLP query needs the whole measurement
                meas = meas.gather(mesh.device(i))
                out0, seed0, ver0, part0 = p3.prepare_init_leader(verify_key, nonce, public, meas, proof, b0)
                out1, seed1, ver1, part1 = p3.prepare_init_helper(verify_key, nonce, public, hseed, b1)
                mask, prep_msg = p3.prep_shares_to_prep(ver0, ver1, part0, part1)
                mask = p3.prepare_finish(seed0, prep_msg, mask)
                mask = p3.prepare_finish(seed1, prep_msg, mask)
                counts.append(mask.sum())
                for out, acc in ((out0, parts0), (out1, parts1)):
                    cols = ColumnShards.split(out, mesh.row(i))
                    acc.append(ColumnShards(
                        p3.aggregate(blk, to_device(mask, blk[0].device)) for blk in cols.blocks
                    ))
        agg0 = reduce_columns(tf, parts0).gather(mesh.first)
        agg1 = reduce_columns(tf, parts1).gather(mesh.first)
        return agg0, agg1, reduce_count(counts, mesh.first)

    return step


def sharded_helper_init_step(inst: VdafInstance, verify_key: bytes, mesh: DeviceMesh):
    """`helper_init_step` over a mesh: rows split over dp, each row
    block's prepare-init on its row's first device; the outputs come back
    concatenated on the mesh's first device."""
    p3s = _mesh_engines(inst, mesh)

    def step(nonce_lanes, public_parts, helper_seed, blind1):
        outs = []
        for i, (nonce, public, hseed, b1) in enumerate(
            stage_shards(mesh, (nonce_lanes, public_parts, helper_seed, blind1), ("rows",) * 4)
        ):
            with device_scope(mesh.device(i)), shard_scope(i):
                outs.append(p3s[i].prepare_init_helper(verify_key, nonce, public, hseed, b1))
        return tuple(_cat_rows([o[k] for o in outs], mesh.first) for k in range(4))

    return step


def _cat_rows(parts, dst):
    """Row blocks (None, limb tuples or tensors) concatenated on dst."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], tuple):
        return tuple(torch.cat([to_device(p[k], dst) for p in parts]) for k in range(len(parts[0])))
    return torch.cat([to_device(p, dst) for p in parts])
