"""The device seam of the serving path: one engine per (VDAF, verify key, device).

The port's counterpart of janus_tpu/aggregator/engine_cache.py. The
serving code reaches the card only through an `EngineCache`:

- Batches pad to power-of-two buckets (`bucket_size`, floored at
  MIN_BUCKET); padding lanes carry mask False and are sliced off.
- The bucket is capped by the memory model (`vdaf/feasibility.py`
  `feasible_bucket` over the card's memory, tiled where the engine's
  query streams); a batch past the cap runs as serial cap-sized
  dispatches.
- Out shares stay on the device between init and aggregate
  (`DeviceRows`); only masks, seeds and verifier shares come back.
- On `torch.cuda.OutOfMemoryError` the engine frees the allocator's
  cache, halves its cap from the failed dispatch's bucket and retries;
  at the floor it raises. The port never moves a request to the CPU on
  its own: there is no host engine.
- A leader batch of at least 2 x PIPELINE_CHUNK rows stages its chunks
  from pinned host memory on a side stream, so chunk k's compute
  overlaps the later chunks' copies.
- A block-sparse SumVec engine (`sparse`) aggregates by scattering the
  accepted reports' compact out shares into a logical accumulator by
  their public block indices (`aggregate_sparse`, on the scatter kernel
  of ops/scatter_cuda.py).

- Cross-job and cross-task coalescing: an init of at most
  COALESCE_MAX_JOB rows goes through a round-based `_Coalescer` shared by
  every engine of one (VDAF, device) and side; calls that arrive while a
  round runs ride the next one together, as one padded dispatch. A round
  of one engine keeps the verify key constant; a round that mixes tasks
  passes each lane its own key (`_verify_key_lanes`), which kernel 1's
  counter launch reads as a column and kernel 2 takes in its prefix. A
  merged round's out shares are `DeviceRows` views into one buffer.
- Prestaged leader columns (`prestage_leader`, `PrestagedInit`): the
  stage pipeline's read stage uploads a job's padded columns from pinned
  memory on a side stream while the device lane runs the previous job;
  `leader_init(prestaged=)` waits on the upload's event and uses them, or
  discards them and stages from the host where its route cannot.
- The card as a failable peer: every device step (`_dispatch`) and
  every blocking fetch (`_fetch`) runs under the process dispatch
  watchdog (`device_watchdog.py`) with the ambient deadline, on a worker
  thread that enters the engine's device and the caller's CUDA stream.
  A call that outlives its caller's budget raises DeadlineExceeded and
  runs on; one still unfinished at the watchdog's hang bound (30 s) is
  hung: DeviceHangError, and the engine is quarantined: it refuses every dispatch with DeviceQuarantinedError before
  staging anything, until a canary thread's probe (a masked aggregate of
  zeros under its own bounded deadline) shows the device answers again;
  the restore resets the caps. The `engine.dispatch` failpoint fires
  inside every supervised step (`oom` rides the memory ladder, `hang`
  parks the worker), `engine.canary` inside the probe.
- Device-resident accumulators: `aggregate_pending` sums one job's
  accepted rows per batch bucket on the card (`PendingDeltas`; a sparse
  job keeps its rows and scatter targets, `SparsePendingDeltas`), and
  `resident_merge`, called after the job's write transaction committed,
  adds them into per-(task, parameter, batch) slots that stay on the card
  (a sparse job's rows through kernel 4 into the dense logical slot),
  evicting LRU slots past RESIDENT_MAX_BYTES through the caller's flush.
  The driver owns the flush policy (aggregation_job_driver.py).
- Several devices, one process: an engine built over more than one device
  (`devices=`; with none named it serves on the one device, as a mesh is
  not yet measured on distinct cards) serves on a dp x sp mesh (parallel/api.py) of the geometry `choose_mesh_geometry`
  picks, as janus_tpu's does. Every dispatch (both inits, the coalesced
  rounds, the aggregates, the pending sums, the resident adds) splits its
  padded bucket's rows over dp; each row block runs as a single-device
  step on its row's first device; sp splits a long vector's measurement
  columns (gathered for the query) and its out-share columns, and a
  resident slot then lives as column shards on the sp devices until a take
  or flush gathers it (`ColumnShards`). Out shares stay on the devices as
  `MeshRows`. Partial sums reduce onto the mesh's first device mod p.
  Every mesh step runs on one process-wide lane thread, `mesh-dispatch`
  (`MeshDispatchQueue`, `_MESH_QUEUE`), in FIFO order, as janus_tpu's
  enqueues do. The port runs eagerly, so the host builds every launch of
  a step on the lane: the mesh engines of a process take turns for their
  whole host-side step, and only the device work after the last launch
  overlaps the next step. A shard that fails raises:
  there is no single-device or CPU retry. Block-sparse engines stay on one
  device (`mesh_fallback_reason`).

One engine may serve several threads at once: in one process the
helper's handler threads and the leader's job-driver workers share it
(the process LRU keys it by VDAF and verify key, which both roles
hold). The OOM ladder's cap and history change under `_oom_lock`, and
each call reads the cap once; the resident slots change under
`_resident_lock`; the pipelined route and each prestage make their side
stream and event per call, and the consumer waits on the event from its
own stream on the engine's device; a coalesced round runs on whichever
submitting thread holds the dispatcher role, under the engine's device,
never the thread's current one; the kernels count their launches under
a lock (ops/cuda_build.py `count_launch`).

The engine runs on CUDA unless it is built with device="cpu", where the
kernels' plain versions run. Values equal janus_tpu's EngineCache on
the same inputs. janus_tpu's JANUS_COALESCE, JANUS_XTASK_COALESCE and
JANUS_RESIDENT_MAX_BYTES environment knobs are not ported: coalescing
and cross-task coalescing are always on, and the resident byte cap is
the class constant RESIDENT_MAX_BYTES; JANUS_MESH_DP and JANUS_MESH_SP
neither: the geometry is the one `choose_mesh_geometry` picks for the
devices given, or the (MESH_DP, MESH_SP) the binaries' `engine: mesh:`
settings pin. Not ported: the compile caches (the port runs eagerly and
compiles nothing). janus_tpu's
quarantine serves the interim work from its host engine, which the port
does not have: a quarantined engine refuses, the job drivers step back
(`device_quarantined`) and the helper sheds 503 until the canary restores
it; the watchdog's abandoned-thread cap, which sends janus_tpu's engines
to their host engines for good, makes every engine here refuse for the
life of the process (`device_watchdog.WATCHDOG.device_down()`).

Observability, as in janus_tpu: the put/dispatch/fetch spans of both
inits and the aggregate (`engine.<op>.put`, `.dispatch`, `.fetch`,
`.fetch_seed`/`_ver`/`_part`, the pipelined route's `put_all_async` and
`chunk`), `_record_dispatch` (dispatch, row and fill metrics, the
device-cost ledger's compile/execute rows, and the first dispatch of each
specialization into the installed shape manifest), the host<->device byte
counter (`count_h2d` / `count_d2h`, from the tensors' `nbytes`), the
coalescer, prestage, quarantine, resident, scatter and mesh-lane metrics,
and the statusz sections `engine_cache`, `resident_accumulators` and
`mesh`. Every value is one the host already holds (rows, buckets,
`nbytes`, `time.monotonic()`): no metric adds a synchronization or a
launch. A dispatch span times the enqueue; the fetch that waits for the
kernels absorbs their time (the device-cost ledger's `d2h`). The dispatch
and fetch spans run inside the supervised closures, on the watchdog's
worker when it is armed (the worker runs in a copy of the caller's
context, so they carry the caller's trace id); the mesh lane runs each
step under the submitter's trace context.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from .. import failpoints, metrics
from ..convert import from_numpy_u64, to_numpy_u64
from ..core.deadline import current_deadline
from ..device import resolve_device
from ..fields.tfield import fzeros
from ..ops.cuda_build import shard_scope
from ..profiler import DEVICE_COST
from ..trace import current_context, span, use_context
from ..parallel.api import (
    ColumnShards,
    choose_mesh_geometry,
    device_scope,
    make_mesh,
    reduce_columns,
    stage_shards,
)
from ..vdaf.circuits import SparseSumVec
from ..vdaf.engine import STREAM_MIN_INPUT_LEN
from ..vdaf.feasibility import feasible_bucket, mesh_memory_budget
from ..vdaf.registry import VdafInstance, prio3_batched
from . import device_watchdog, shape_manifest
from .device_watchdog import DeviceQuarantinedError

log = logging.getLogger(__name__)

MIN_BUCKET = 32


def bucket_size(n: int, cap: int | None = None) -> int:
    """Power-of-two bucket for n rows, floored at MIN_BUCKET.

    `cap` (the engine's memory bound) clamps the result; a capped bucket
    may be smaller than n, and then the caller chunks the batch into
    cap-sized dispatches (EngineCache does)."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    if cap is not None and cap < b:
        b = cap
    return b


def is_oom_error(e: BaseException) -> bool:
    """A device memory exhaustion, the one error the engine recovers from."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


def _annotate_dispatch_bucket(e: BaseException, b: int, fixed: bool = False) -> None:
    """Record the bucket of the dispatch that raised: recovery halves from
    it, not from the caller's row count. `fixed` marks dispatches whose
    bucket cannot follow a halved cap (an aggregate over a resident
    buffer), so the handler knows a retry cannot make progress."""
    if not hasattr(e, "_janus_dispatch_bucket"):
        e._janus_dispatch_bucket = b
        e._janus_fixed_bucket = fixed


def _map_args(fn, args):
    """Apply fn to every array of an arg tuple whose entries are None,
    bytes, ints, field limb tuples or arrays."""
    out = []
    for a in args:
        if a is None or isinstance(a, (bytes, int)):
            out.append(a)
        elif isinstance(a, tuple):
            out.append(tuple(fn(x) for x in a))
        else:
            out.append(fn(a))
    return tuple(out)


def _cut_rows(a, s: int, e: int):
    """Row-slice an arg that may be None, bytes, a field limb tuple, or
    an array."""
    return _map_args(lambda x: x[s:e], (a,))[0]


def _as_tensor(a) -> torch.Tensor:
    """A tensor as it is; a numpy bool mask as a bool tensor; numpy u64
    lanes as their int64 view, bits unchanged (never a value cast)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(np.ascontiguousarray(a))
    return from_numpy_u64(a, "cpu")


def _pad(arr, b: int) -> torch.Tensor:
    """Zero rows appended up to b; zeros of the int64 view are u64 zeros,
    and False for a mask."""
    t = _as_tensor(arr)
    pad = b - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def pad_args(b: int, *args):
    return _map_args(lambda a: _pad(a, b), args)


def _tree_nbytes(tree) -> int:
    if tree is None or isinstance(tree, (bytes, int)):
        return 0
    if isinstance(tree, (tuple, list)):
        return sum(_tree_nbytes(x) for x in tree)
    nb = getattr(tree, "nbytes", None)
    return int(nb) if nb is not None else 0


def count_h2d(tree_or_bytes) -> None:
    """Account host->device bytes (staged uploads, masks, bucket ids)."""
    n = tree_or_bytes if isinstance(tree_or_bytes, int) else _tree_nbytes(tree_or_bytes)
    if n:
        metrics.engine_hd_bytes_total.add(n, direction="h2d")


def count_d2h(tree_or_bytes) -> None:
    """Account device->host bytes (fetches of masks, seeds, aggregates)."""
    n = tree_or_bytes if isinstance(tree_or_bytes, int) else _tree_nbytes(tree_or_bytes)
    if n:
        metrics.engine_hd_bytes_total.add(n, direction="d2h")


def put_args(args, device: torch.device, stream=None):
    """Move every array of an arg tuple to `device`. With a CUDA `stream`
    each host array is pinned and copied asynchronously on that stream;
    the caller waits on the stream's event before using the result."""
    if stream is None:
        return _map_args(lambda t: t.to(device), args)

    def put(t):
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    with torch.cuda.stream(stream):
        return _map_args(put, args)


def _fetch_rows(x, n: int) -> np.ndarray:
    """The first n rows of a lane tensor as uint64 numpy (blocks on the
    device, as JAX's np.asarray does)."""
    return to_numpy_u64(x[:n])


def _fetch_leader_rows(seed0, ver0, part0, n: int):
    """A leader init's host outputs: seed lanes or None, verifier limbs,
    joint-rand part lanes or None, first n rows each."""
    return (
        _fetch_rows(seed0, n) if seed0 is not None else None,
        tuple(_fetch_rows(x, n) for x in ver0),
        _fetch_rows(part0, n) if part0 is not None else None,
    )


def _fetch_leader_rows_spanned(kind: str, b: int, seed0, ver0, part0, n: int):
    """`_fetch_leader_rows` under janus_tpu's three fetch spans: the seed
    lanes, the verifier limbs, the joint-rand part lanes."""
    with span("engine.leader_init.fetch_seed", vdaf=kind, bucket=b):
        seed = _fetch_rows(seed0, n) if seed0 is not None else None
    with span("engine.leader_init.fetch_ver", vdaf=kind, bucket=b):
        ver = tuple(_fetch_rows(x, n) for x in ver0)
    with span("engine.leader_init.fetch_part", vdaf=kind, bucket=b):
        part = _fetch_rows(part0, n) if part0 is not None else None
    count_d2h((seed, ver, part))
    return seed, ver, part


class DeviceRows:
    """Out-share field value living on the device, padded to its bucket.

    `EngineCache.aggregate` reads it where it lies; `to_numpy()` fetches
    the true rows as uint64 limb arrays, bit-identical to JAX's, through
    the engine that made them (a supervised fetch). `offset` views rows
    [offset, offset + n) of a shared buffer."""

    __slots__ = ("value", "n", "offset", "engine")

    def __init__(self, value, n: int, offset: int = 0, engine=None):
        self.value = value  # tuple of [bucket, len] int64 limb tensors
        self.n = n  # true batch size (rows beyond n are padding)
        self.offset = offset
        self.engine = engine

    def view(self, offset: int, n: int) -> "DeviceRows":
        """Rows [offset, offset + n) of this value."""
        return DeviceRows(self.value, n, offset=self.offset + offset, engine=self.engine)

    def to_numpy(self):
        def fetch():
            rows = tuple(to_numpy_u64(x[self.offset : self.offset + self.n]) for x in self.value)
            count_d2h(rows)
            return rows

        return fetch() if self.engine is None else self.engine._fetch("fetch_rows", fetch)


class DeviceRowsChunks:
    """Out shares of a chunked or pipelined init: DeviceRows over
    consecutive row ranges, in order."""

    __slots__ = ("chunks",)

    def __init__(self, chunks: list[DeviceRows]):
        self.chunks = chunks

    @property
    def n(self) -> int:
        return sum(c.n for c in self.chunks)

    def to_numpy(self):
        parts = [c.to_numpy() for c in self.chunks]
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(len(parts[0])))


class MeshRows:
    """Out shares of a mesh dispatch, living on the mesh, padded to the
    bucket: `blocks[i]` holds dp row i's b/dp rows as `ColumnShards` over
    the row's sp devices (one block when sp = 1). Rows [offset, offset +
    n) are this value's; every other row (padding, a merged round's
    neighbours) is masked out wherever the value is read."""

    __slots__ = ("blocks", "n", "offset", "engine")

    def __init__(self, blocks, n: int, offset: int = 0, engine=None):
        self.blocks = blocks
        self.n = n
        self.offset = offset
        self.engine = engine

    @property
    def bucket(self) -> int:
        return sum(blk.blocks[0][0].shape[0] for blk in self.blocks)

    def view(self, offset: int, n: int) -> "MeshRows":
        return MeshRows(self.blocks, n, offset=self.offset + offset, engine=self.engine)

    def full_lanes(self, lanes, fill):
        """A per-row host array of this value's n rows, widened to the
        whole bucket with `fill` on every row not its own."""
        lanes = np.asarray(lanes)
        out = np.full(self.bucket, fill, dtype=lanes.dtype)
        out[self.offset : self.offset + self.n] = lanes
        return out

    def to_numpy(self):
        def fetch():
            host = [blk.to_host() for blk in self.blocks]
            return tuple(
                to_numpy_u64(torch.cat([h[k] for h in host])[self.offset : self.offset + self.n])
                for k in range(len(host[0]))
            )

        return fetch() if self.engine is None else self.engine._fetch("fetch_rows", fetch)


def _current_streams(devices) -> list:
    """The calling thread's current stream on each CUDA device."""
    return [torch.cuda.current_stream(d) for d in dict.fromkeys(devices) if d.type == "cuda"]


@contextlib.contextmanager
def _streams_scope(streams):
    """Each stream as the thread's current one on its device for the block
    (streams belong to a thread: a worker or the lane takes the caller's)."""
    with contextlib.ExitStack() as stack:
        for stream in streams:
            stack.enter_context(torch.cuda.stream(stream))
        yield


def _init_variant(op: str, vk_lanes) -> str:
    """janus_tpu's variant name of an init: `<op>_vk` where the verify key
    is a per-lane input (a cross-task round), else `<op>`."""
    return op if vk_lanes is None else f"{op}_vk"


def _helper_step(p3, vkey, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask):
    """The helper's init, combine and decide over one staged batch:
    (out share, accept mask, prep message lanes)."""
    out1, seed1, ver1, part1 = p3.prepare_init_helper(vkey, nonce_lanes, public_parts, helper_seeds, blinds)
    mask, prep_msg = p3.prep_shares_to_prep(ver0, ver1, part0, part1)
    mask = p3.prepare_finish(seed1, prep_msg, mask)
    mask = mask & ok_mask
    if prep_msg is None:
        prep_msg = torch.zeros((nonce_lanes.shape[0], 2), dtype=torch.int64, device=nonce_lanes.device)
    return out1, mask, prep_msg


def _tensors(x):
    """Every tensor of a staged structure (tuples, lists, ColumnShards)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, ColumnShards):
        yield from _tensors(x.blocks)
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _take_prestaged(prestaged):
    """A prestage's columns, ready to read on the calling thread's current
    streams: the columns were made on the prestage's side streams, so each
    device's current stream waits on its copies' event, and the allocator
    must not reuse them before that stream has read them."""
    staged, ready = prestaged.take()
    for dev, ev in ready:
        torch.cuda.current_stream(dev).wait_event(ev)
    if ready:
        for t in _tensors(staged):
            t.record_stream(torch.cuda.current_stream(t.device))
    return staged


def _cat_host(parts, n: int):
    """Per-shard host rows (None, limb tuples of arrays or arrays)
    concatenated, first n rows."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], tuple):
        return tuple(np.concatenate([p[k] for p in parts])[:n] for k in range(len(parts[0])))
    return np.concatenate(parts)[:n]


def _in_streams(streams, fn):
    with _streams_scope(streams):
        return fn()


def _value_add(tf, a, b):
    """a + b mod p for a limb tuple or column-sharded value."""
    return a.add(tf, b) if isinstance(a, ColumnShards) else tf.add(a, b)


def _value_ints(tf, v) -> list:
    """A field value's elements as Python ints (fetched from the device)."""
    return [int(x) for x in (v.to_ints(tf) if isinstance(v, ColumnShards) else tf.to_ints(v))]


def _injected_oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory (injected failpoint engine.dispatch)")


def _engine_dispatch_failpoint() -> None:
    """`engine.dispatch` failpoint inside every supervised device step:
    `oom` raises the memory exhaustion the ladder recovers from, `hang`
    parks the supervised worker as a wedged kernel would, so the
    watchdog's abandon and quarantine path is what recovers it."""
    failpoints.hit("engine.dispatch", oom_factory=_injected_oom)


class PrestagedInit:
    """A leader init's padded columns, uploaded ahead (double-buffered
    staging): `prestage_leader` issues the copies from pinned memory on a
    side stream and records `ready` after them; `leader_init` consumes
    them when its direct route runs at the same bucket. `discard()` drops
    the references, so a fallback (a merged round, a cap moved by the OOM
    ladder, the pipelined or chunked route) frees the buffers at once:
    they were made on the side stream, whose later work is ordered after
    the copies. A mesh engine's columns (`meshed`) are staged per dp row
    on the mesh, with one side stream and event per device."""

    __slots__ = ("b", "_staged", "_ready", "meshed")

    def __init__(self, b: int, staged, ready, meshed: bool = False):
        self.b = b
        self._staged = staged
        self._ready = ready  # [(device, torch.cuda.Event)], empty on the CPU
        self.meshed = meshed

    def usable(self, b: int, meshed: bool = False) -> bool:
        return self._staged is not None and self.b == b and self.meshed == meshed

    def take(self):
        staged, ready = self._staged, self._ready
        self._staged = self._ready = None
        return staged, ready

    def discard(self) -> None:
        self._staged = self._ready = None


class ResidentMergeError(RuntimeError):
    """resident_merge died partway through its entry loop. `merged` holds
    the keys whose delta did land in a resident slot before the failure:
    those flush with their slot, so the caller flushes directly only the
    remaining entries' rows (re-flushing a merged one double-counts it)."""

    def __init__(self, merged: frozenset, cause: BaseException):
        super().__init__(f"resident merge failed after {len(merged)} bucket(s): {cause!r}")
        self.merged = merged


class ResidentSlot:
    """One per-(task, aggregation parameter, batch) aggregate living on
    the card across job steps: `value` is an [output_len] field limb tuple
    (the logical length for a sparse task). The interval is the union of
    every merged contribution's; counts and checksums are durable already
    (each job's write transaction records them), only the share lives
    here until a flush."""

    __slots__ = ("key", "value", "interval", "rows", "nbytes", "last_used")

    def __init__(self, key: tuple, value, interval, rows: int, nbytes: int):
        self.key = key  # (task_id bytes, agg_param bytes, batch_identifier bytes)
        self.value = value
        self.interval = interval
        self.rows = rows
        self.nbytes = nbytes
        self.last_used = time.monotonic()


class PendingDeltas:
    """One job step's per-bucket masked sums, still on the card ([k,
    output_len] limb tuple, or its ColumnShards on a mesh with sp > 1):
    made by aggregate_pending on the device lane,
    merged into resident slots only after the job's write transaction
    committed. A failed commit drops the object: no rollback, and the
    re-step cannot merge twice."""

    __slots__ = ("value", "k", "row_nbytes")

    def __init__(self, value, k: int, row_nbytes: int):
        self.value = value
        self.k = k
        self.row_nbytes = row_nbytes

    def row(self, j: int):
        """Row j as a device field value (a view, nothing fetched)."""
        if isinstance(self.value, ColumnShards):
            return self.value.row(j)
        return tuple(x[j] for x in self.value)


class SparsePendingDeltas:
    """A block-sparse job's pending state. Two reports of one batch carry
    different block indices, so a compact-width pre-sum would add values
    of unrelated logical positions: the job's out shares ride to merge
    time with each report's flat scatter targets, and resident_merge
    scatters a bucket's rows straight into the dense logical slot (kernel
    4). Same commit discipline as PendingDeltas.

    flat_idx: [n, compact_len] host int32, the sentinel logical_len on
    padding lanes; bucket_idx: [n] host int32, -1 for a rejected report.
    row_nbytes is the dense logical row's size (what a slot holds)."""

    __slots__ = ("out_shares", "flat_idx", "bucket_idx", "k", "row_nbytes", "logical_len")

    def __init__(self, out_shares, flat_idx, bucket_idx, k: int, row_nbytes: int, logical_len: int):
        self.out_shares = out_shares
        self.flat_idx = flat_idx
        self.bucket_idx = bucket_idx
        self.k = k
        self.row_nbytes = row_nbytes
        self.logical_len = logical_len


# The process-wide resident ledger: the device bytes every engine's slots
# hold (the eviction cap reads the total) and the slot count per VDAF kind
# (several engines share a kind, one per task verify key).
_resident_bytes_lock = threading.Lock()
_resident_bytes_total = 0
_resident_buffer_counts: dict[str, int] = {}


def _resident_bytes_add(delta: int, kind: str, nbuf: int) -> int:
    """Account one slot insert (+) or removal (-): `delta` bytes and `nbuf`
    slots of VDAF `kind`; returns the new byte total."""
    global _resident_bytes_total
    with _resident_bytes_lock:
        _resident_bytes_total += delta
        total = _resident_bytes_total
        n = _resident_buffer_counts.get(kind, 0) + nbuf
        _resident_buffer_counts[kind] = n
    metrics.engine_resident_bytes.set(float(total))
    metrics.engine_resident_buffers.set(float(n), vdaf=kind)
    return total


def resident_bytes_total() -> int:
    with _resident_bytes_lock:
        return _resident_bytes_total


def resident_buffer_counts() -> dict[str, int]:
    """Resident slots held, by VDAF kind, over every engine."""
    with _resident_bytes_lock:
        return dict(_resident_buffer_counts)


class _Coalescer:
    """Round-based dispatch coalescing across concurrent callers.

    A call with no round in flight dispatches at once (no added latency
    when idle); calls that arrive while a round runs queue and ride the
    next round together, up to `max_rows` rows. The dispatcher role passes
    between submitting threads: the thread whose entry finished hands it
    to a waiter, which adopts it. Leases are untouched: each job still
    writes and releases its own.
    """

    __slots__ = ("_run", "_max_rows", "_lock", "_cv", "_queue", "_active", "rounds")

    def __init__(self, run, max_rows: int):
        self._run = run  # ([args...], [n...]) -> [per-call results]
        self._max_rows = max_rows
        self._lock = threading.Lock()
        # signalled when the dispatcher role frees up with work queued
        self._cv = threading.Condition(self._lock)
        self._queue: list[list] = []  # entries: [args, n, Event, result, error]
        self._active = False
        # calls per dispatched round, the recent window only
        self.rounds: deque = deque(maxlen=1024)

    def submit(self, args, n: int):
        ent = [args, n, threading.Event(), None, None]
        with self._lock:
            self._queue.append(ent)
            dispatcher = not self._active
            if dispatcher:
                self._active = True
        if dispatcher:
            self._dispatch_until_done(ent)
        else:
            while not ent[2].is_set():
                # the previous dispatcher may leave with entries queued
                # (its own round finished first): a waiter is notified
                # and adopts the role (the timeout only covers a lost
                # wake-up)
                with self._lock:
                    adopt = not self._active and not ent[2].is_set() and bool(self._queue)
                    if adopt:
                        self._active = True
                    elif not ent[2].is_set():
                        self._cv.wait(0.05)
                        continue
                if adopt:
                    self._dispatch_until_done(ent)
                    break
        if ent[4] is not None:
            raise ent[4]
        return ent[3]

    def _dispatch_until_done(self, own):
        """Dispatch rounds until our own entry completes and the queue is
        drained or another thread adopts the role."""
        try:
            while True:
                with self._lock:
                    batch: list[list] = []
                    rows = 0
                    while self._queue and (not batch or rows + self._queue[0][1] <= self._max_rows):
                        e = self._queue.pop(0)
                        batch.append(e)
                        rows += e[1]
                    if not batch:
                        return
                self.rounds.append(len(batch))
                try:
                    results = self._run([e[0] for e in batch], [e[1] for e in batch])
                    for e, r in zip(batch, results):
                        e[3] = r
                except BaseException as ex:  # noqa: BLE001 - re-raised below or per entry
                    # the round's entries were popped: nobody else would
                    # ever set their events, so every one gets the error
                    for e in batch:
                        e[4] = ex
                    if not isinstance(ex, Exception):
                        for e in batch:
                            e[2].set()
                        with self._lock:
                            self._cv.notify_all()
                        raise
                for e in batch:
                    e[2].set()
                with self._lock:
                    self._cv.notify_all()
                if own[2].is_set():
                    # our caller has work to do with its result: hand the
                    # role to a waiter (notified in finally)
                    return
        finally:
            with self._lock:
                self._active = False
                if self._queue:
                    self._cv.notify()


def _concat_args(args_list):
    """Concatenate per-call arg tuples along the batch axis. An arg is
    None in every call or in none (one engine's schedule); arrays become
    tensors (numpy bits unchanged), on the CPU unless all lie on one
    device."""

    def cat(parts):
        ts = [_as_tensor(p) for p in parts]
        if len({t.device for t in ts}) > 1:
            ts = [t.cpu() for t in ts]
        return torch.cat(ts)

    out = []
    for parts in zip(*args_list):
        if parts[0] is None:
            if any(p is not None for p in parts):
                raise ValueError("coalesced round: an argument is None in some calls only")
            out.append(None)
        elif isinstance(parts[0], tuple):  # field limbs
            out.append(tuple(cat([p[k] for p in parts]) for k in range(len(parts[0]))))
        else:
            out.append(cat(parts))
    return tuple(out)


def _split_rows(value, offsets):
    """Slice a host array, a limb tuple or None back into per-call rows."""
    if value is None:
        return [None] * (len(offsets) - 1)
    if isinstance(value, tuple):
        return [tuple(x[s:e] for x in value) for s, e in zip(offsets, offsets[1:])]
    return [value[s:e] for s, e in zip(offsets, offsets[1:])]


class _MeshDispatch:
    """One queued mesh enqueue: the function, its args, and the rendezvous
    the submitting thread blocks on."""

    __slots__ = ("fn", "args", "vdaf", "program", "ctx", "t_submit", "done", "result", "error")

    def __init__(self, fn, args, vdaf: str = "", program: str = ""):
        self.fn = fn
        self.args = args
        self.vdaf = vdaf
        self.program = program
        # the submitter's trace context: the lane's spans are its children
        self.ctx = current_context()
        self.t_submit = time.monotonic()
        self.done = threading.Event()
        self.result = None
        self.error = None


class MeshDispatchQueue:
    """The single-controller dispatch lane of every mesh engine in the
    process.

    One thread, `mesh-dispatch`, runs every mesh step, in FIFO order, as
    janus_tpu's lane runs its enqueues (there, two threads interleaving
    the per-device enqueues of two multi-device programs can deadlock).
    Unlike a lock it serves the waiters in order and counts its depth and
    wait. In the eager port a step's host side is its enqueue, so the
    lane serializes the whole host-side step of every mesh engine in the
    process; only the device work after a step's last launch overlaps
    the next one. `submit` blocks its caller until the
    enqueue ran and re-raises the enqueue's error, the same object, in the
    caller (the memory ladder marks and type-checks it); the lane lives
    on."""

    def __init__(self):
        self._q: "queue.SimpleQueue[_MeshDispatch]" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._depth = 0
        # (vdaf, program) pairs run once: the cost ledger's compile row
        self._seen: set[tuple[str, str]] = set()
        self._stats = self._zero_stats()

    @staticmethod
    def _zero_stats() -> dict:
        return {"submitted": 0, "completed": 0, "errors": 0, "max_depth": 0, "wait_s": 0.0, "max_wait_s": 0.0,
                "busy_s": 0.0}

    def submit(self, fn, *args, vdaf: str = "", program: str = ""):
        """Run fn(*args) on the lane; block until it returned; re-raise its
        exception here. `vdaf` and `program` name the step for the metrics
        and the device-cost ledger."""
        self._ensure_thread()
        item = _MeshDispatch(fn, args, vdaf, program)
        with self._lock:
            self._depth += 1
            depth = self._depth
            self._stats["submitted"] += 1
            self._stats["max_depth"] = max(self._stats["max_depth"], self._depth)
        metrics.mesh_dispatch_queue_depth.set(float(depth))
        self._q.put(item)
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._run, name="mesh-dispatch", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            wait = time.monotonic() - item.t_submit
            with self._lock:
                self._depth -= 1
                depth = self._depth
                self._stats["wait_s"] += wait
                self._stats["max_wait_s"] = max(self._stats["max_wait_s"], wait)
                first = (item.vdaf, item.program) not in self._seen
                if first:
                    self._seen.add((item.vdaf, item.program))
            metrics.mesh_dispatch_queue_depth.set(float(depth))
            metrics.mesh_dispatch_wait_seconds.observe(wait)
            t0 = time.monotonic()
            try:
                with use_context(item.ctx):
                    item.result = item.fn(*item.args)
            except BaseException as e:  # noqa: BLE001 - belongs to the caller
                item.error = e
            finally:
                dt = time.monotonic() - t0
                with self._lock:
                    self._stats["busy_s"] += dt
                    self._stats["completed"] += 1
                    if item.error is not None:
                        self._stats["errors"] += 1
                metrics.mesh_dispatch_busy_seconds.add(dt)
                metrics.mesh_dispatch_total.add(program=item.program or "unknown")
                if item.vdaf:
                    # the lane's own row per mesh program: its host-side
                    # step (the enqueue), the first run of a program as
                    # the cold call
                    DEVICE_COST.record(
                        item.vdaf, f"mesh:{item.program}", 0, "compile" if first else "execute", dt, dispatches=1
                    )
                item.done.set()

    def status(self) -> dict:
        with self._lock:
            t = self._thread
            return {"depth": self._depth, "lane_alive": bool(t is not None and t.is_alive()), **dict(self._stats)}

    def reset_for_tests(self) -> None:
        """Zero the counters; the lane thread, if any, runs on (it keeps no
        other state)."""
        with self._lock:
            self._stats = self._zero_stats()
            self._seen.clear()


# the process-wide lane: one queue for every engine's mesh enqueues (the
# interleaved-enqueue hazard is the process's, not an engine's)
_MESH_QUEUE = MeshDispatchQueue()

_xtask_lock = threading.Lock()
_xtask_coalescers: dict[tuple, "_Coalescer"] = {}


def _shared_coalescer(inst, placement, side: str, max_rows: int) -> "_Coalescer":
    """The coalescer every engine of (inst, placement) shares on one side.
    The placement is the engine's device, or its mesh's devices and
    geometry: a mesh round never merges with a single-device engine's."""
    key = (inst, placement, side)
    with _xtask_lock:
        co = _xtask_coalescers.get(key)
        if co is None:
            co = _Coalescer(_run_leader_round if side == "leader" else _run_helper_round, max_rows)
            _xtask_coalescers[key] = co
        return co


def _clear_shared_coalescers() -> None:
    with _xtask_lock:
        _xtask_coalescers.clear()


def _verify_key_lanes(engines, ns) -> np.ndarray:
    """[sum(ns), 2] uint64 lanes carrying each entry's verify key across
    its rows: the per-lane key of a cross-task round."""
    rows = [
        np.broadcast_to(np.frombuffer(e.verify_key, dtype="<u8").astype(np.uint64), (n, 2))
        for e, n in zip(engines, ns)
    ]
    return np.ascontiguousarray(np.concatenate(rows, axis=0))


def _round_prestage_fallback(args_list) -> None:
    """A merged round re-stages from the concatenated host columns: every
    entry's prestage is discarded (and counted by its engine)."""
    for eng, prestaged, *_ in args_list:
        if prestaged is not None:
            prestaged.discard()
            eng._count_prestage("discarded")


@contextlib.contextmanager
def _exec_engine(eng):
    """Tag an error out of a round with the engine that ran it: every
    entry of the round gets the same exception, and the memory ladder
    halves the cap of the engine whose dispatch ran out, not the
    caller's."""
    try:
        yield
    except BaseException as e:
        if not hasattr(e, "_janus_exec_engine"):
            e._janus_exec_engine = eng
        raise


def _run_leader_round(args_list, ns):
    """Coalescer round (leader init). Entries carry their engine and
    prestage: a round of one is the engine's own init, with its verify key
    constant and its prestage; a merged round runs on the first entry's
    engine (one VdafInstance, one geometry) as one dispatch, with
    per-lane keys when it mixes tasks."""
    engines = [a[0] for a in args_list]
    exec_eng = engines[0]
    # the round runs on whichever thread holds the dispatcher role: under
    # the executing engine's device, never that thread's current one
    with device_scope(exec_eng.device), _exec_engine(exec_eng):
        if len(args_list) == 1:
            eng, prestaged, *rest = args_list[0]
            return [eng._leader_init_inner(*rest, prestaged=prestaged)]
        cross = any(e is not exec_eng for e in engines)
        offsets = list(np.cumsum([0] + list(ns)))
        metrics.engine_coalesced_rounds_total.add()
        metrics.engine_coalesced_rows_total.add(int(sum(ns)))
        exec_eng._count_round(int(sum(ns)))
        _round_prestage_fallback(args_list)
        merged = _concat_args([a[2:] for a in args_list])
        vk = _verify_key_lanes(engines, ns) if cross else None
        # one padded dispatch for the whole round (no pipelined chunks:
        # round-to-round overlap already covers the copies)
        out0, seed0, ver0, part0 = exec_eng._leader_init_inner(
            *merged, coalesced=len(ns), allow_pipeline=False, vk_lanes=vk
        )
        if isinstance(out0, DeviceRowsChunks):
            # the cap halved between admission and dispatch and the round
            # chunked: split host rows instead of buffer views
            rows = out0.to_numpy()
            outs = [tuple(x[s:e] for x in rows) for s, e in zip(offsets, offsets[1:])]
        else:
            outs = [out0.view(s, e - s) for s, e in zip(offsets, offsets[1:])]
        return list(zip(outs, _split_rows(seed0, offsets), _split_rows(ver0, offsets), _split_rows(part0, offsets)))


def _run_helper_round(args_list, ns):
    """Coalescer round (helper init); see _run_leader_round."""
    engines = [a[0] for a in args_list]
    exec_eng = engines[0]
    with device_scope(exec_eng.device), _exec_engine(exec_eng):
        if len(args_list) == 1:
            eng, *rest = args_list[0]
            return [eng._helper_init_inner(*rest)]
        cross = any(e is not exec_eng for e in engines)
        offsets = list(np.cumsum([0] + list(ns)))
        metrics.engine_coalesced_rounds_total.add()
        metrics.engine_coalesced_rows_total.add(int(sum(ns)))
        exec_eng._count_round(int(sum(ns)))
        merged = _concat_args([a[1:] for a in args_list])
        vk = _verify_key_lanes(engines, ns) if cross else None
        out1, mask, prep_msg = exec_eng._helper_init_inner(*merged, coalesced=len(ns), vk_lanes=vk)
        if isinstance(out1, DeviceRowsChunks):
            rows = out1.to_numpy()
            return [(tuple(x[s:e] for x in rows), mask[s:e], prep_msg[s:e]) for s, e in zip(offsets, offsets[1:])]
        return [(out1.view(s, e - s), mask[s:e], prep_msg[s:e]) for s, e in zip(offsets, offsets[1:])]


class EngineCache:
    """Per (VDAF, verify key, devices) Prio3 steps over bucketed batches.

    device: CUDA unless the caller passes "cpu". devices: the devices to
    serve on; None takes the one device. More than
    one device makes a mesh of the geometry `choose_mesh_geometry` picks
    (a device may repeat: the rehearsal on one card). bucket_cap: None
    takes the memory model's cap (None on the CPU, uncapped); a positive
    value overrides it, rounded down to a power of two; 0 means uncapped.
    A mesh's cap is at least dp."""

    # input_len from which the vector axis takes a slice of the mesh (sp):
    # the streamed query's threshold, where the per-report vectors, not the
    # report count, fill the device
    SP_MIN_INPUT_LEN = STREAM_MIN_INPUT_LEN

    # Leader batches of at least 2 x PIPELINE_CHUNK rows run pipelined.
    PIPELINE_CHUNK = 256
    # Inits of at most COALESCE_MAX_JOB rows go through the coalescer; a
    # round takes at most COALESCE_ROUND_ROWS rows, and at most
    # COALESCE_ROUND_ELEMS input elements (a long circuit's round is
    # smaller), and never more than the memory cap.
    COALESCE_MAX_JOB = 4096
    COALESCE_ROUND_ROWS = 32768
    COALESCE_ROUND_ELEMS = 1 << 25
    # Process-wide device bytes of resident slots; past it a merge evicts
    # this engine's LRU slots through the driver's flush.
    RESIDENT_MAX_BYTES = 256 << 20
    # The hang quarantine's canary: its first probe this long after the
    # hang, doubling after each failed probe up to the max; each probe
    # runs under its own deadline. Tests shorten them on the instance.
    QUARANTINE_CANARY_DELAY_SECS = 5.0
    QUARANTINE_CANARY_TIMEOUT_SECS = 30.0
    QUARANTINE_CANARY_MAX_DELAY_SECS = 60.0
    # the serving mesh's pinned (dp, sp) axes (the binaries' `engine: mesh:`
    # settings); None picks them from the device count. choose_mesh_geometry
    # validates a pin against the circuit and the devices
    MESH_DP: int | None = None
    MESH_SP: int | None = None
    # every state `_backend_state` reports
    BACKEND_STATES = ("device", "quarantined", "device_down")

    def __init__(self, inst: VdafInstance, verify_key: bytes, device=None, bucket_cap: int | None = None,
                 devices=None):
        self.inst = inst
        self.verify_key = verify_key
        devices = [resolve_device(d) for d in devices or (device,)]
        self.p3 = prio3_batched(inst, devices[0])
        self.device = self.p3.device
        circ = self.p3.circ
        # the geometry: dp splits the report rows, sp a long vector's
        # columns; one device is no mesh
        dp, sp = choose_mesh_geometry(
            len(devices), getattr(circ, "input_len", 0), getattr(circ, "output_len", 0), self.SP_MIN_INPUT_LEN,
            MIN_BUCKET, dp=self.MESH_DP, sp=self.MESH_SP,
        )
        # block-sparse SumVec: aggregates scatter to the logical length,
        # into one accumulator on one device (as janus_tpu's)
        self.sparse = isinstance(circ, SparseSumVec)
        self.mesh_fallback_reason: str | None = None
        if self.sparse and dp * sp > 1:
            dp, sp = 1, 1
            self.mesh_fallback_reason = "sparse_scatter_single_device"
        self.dp, self.sp = dp, sp
        self.mesh = make_mesh(dp, sp, devices) if dp * sp > 1 else None
        self._devices = self.mesh.devices if self.mesh is not None else (self.device,)
        # each dp row's engine, on the row's first device
        self._p3s = [prio3_batched(inst, self.mesh.device(i)) for i in range(dp)] if self.mesh else [self.p3]
        if bucket_cap is not None:
            self.bucket_cap = (1 << (bucket_cap.bit_length() - 1)) if bucket_cap > 0 else None
        else:
            # the tiled model where the query streams (the tile, not
            # input_len, sizes its working set)
            plan = self.p3.plan
            self.bucket_cap = feasible_bucket(
                circ,
                mesh_memory_budget(self._devices),
                tile_elems=plan.group if plan is not None else None,
                draft=inst.xof_mode != "fast",
            )
        if self.bucket_cap is not None:
            # a mesh dispatch splits its rows over dp: every bucket, hence
            # the cap, must divide by dp
            self.bucket_cap = max(self.bucket_cap, dp)
        self._oom_lock = threading.Lock()
        self.oom_history: deque = deque(maxlen=16)
        # coalescing: the round's row cap follows the circuit's width and
        # the memory cap; engines of one (VDAF, placement) share a
        # coalescer per side
        in_len = max(1, getattr(circ, "input_len", 1))
        round_rows = max(MIN_BUCKET, min(self.COALESCE_ROUND_ROWS, self.COALESCE_ROUND_ELEMS // in_len))
        if self.bucket_cap is not None:
            round_rows = min(round_rows, self.bucket_cap)
        placement = (self.mesh.devices, dp, sp) if self.mesh is not None else self.device
        self._co_leader = _shared_coalescer(inst, placement, "leader", round_rows)
        self._co_helper = _shared_coalescer(inst, placement, "helper", round_rows)
        # what a canary restore resets
        self._initial_bucket_cap = self.bucket_cap
        self._initial_round_rows = round_rows
        # the hang quarantine (under _oom_lock): set by a hung supervised
        # call, cleared by the canary thread's successful probe
        self._quarantined = False
        self._quarantined_at = 0.0
        self._canary_next_at = 0.0
        # a quarantine flush's fetch hung too: the slots wait for the restore
        self._quarantine_fetch_hung = False
        self._canary_wakeup = threading.Event()
        self._canary_stop = False
        self._canary_thread: threading.Thread | None = None
        # the quarantine's counts per engine (the process-wide counter is
        # janus_engine_quarantines_total)
        self.quarantine_stats = {
            "opened": 0, "canary_probes": 0, "canary_failed": 0, "restored": 0, "refused": 0,
            "canary_delay_s": None, "last_probe_s": None, "last_quarantine_s": None, "rewarmed": 0,
        }
        # this engine's own counts beside the process-wide metrics: merged
        # rounds it ran, their rows, and the prestages' outcomes
        self._stats_lock = threading.Lock()
        self.coalesce_stats = {"merged_rounds": 0, "merged_rows": 0}
        self.prestage_stats = {"issued": 0, "used": 0, "discarded": 0}
        # device-resident aggregate state: per-(task, parameter, batch)
        # slots; the driver owns the flush policy
        self._resident: "OrderedDict[tuple, ResidentSlot]" = OrderedDict()
        self._resident_lock = threading.Lock()
        self._resident_stats = {
            "merged_rows": 0,
            "merges": 0,
            "evictions": 0,
            "eviction_deferred": 0,
            "takes": 0,
            "classic_fallbacks": 0,
        }
        self._scatter_rows_total = 0
        self._sparse_last_occupancy: float | None = None
        # the (op, bucket) pairs dispatched once (the compile histogram)
        # and the cost ledger's keys run once (its compile row)
        self._dispatched_buckets: set[tuple[str, int]] = set()
        self._ledger_dispatched: set[tuple] = set()
        self._dispatch_track_lock = threading.Lock()
        self._publish_state()

    def _dispatch(self, name: str, fn, *args):
        """Run one step on staged device tensors: the one place a device
        computation starts (and where a test injects a failure), under the
        watchdog with the `engine.dispatch` failpoint inside."""

        def step():
            _engine_dispatch_failpoint()
            return fn(*args)

        return self._supervised(name, step)

    def _fetch(self, label: str, fn):
        """A blocking device-to-host fetch under the watchdog. Not refused
        while quarantined: the quarantine flush of resident slots is one."""
        return self._supervised(label, fn)

    def _publish_state(self) -> None:
        """Refresh the janus_engine_backend / janus_engine_bucket_cap
        gauges of this engine's VDAF kind: exactly one state is 1."""
        state = self._backend_state()
        for s in self.BACKEND_STATES:
            metrics.engine_backend_state.set(1.0 if s == state else 0.0, vdaf=self.inst.kind, state=s)
        metrics.engine_bucket_cap.set(float(self.bucket_cap or 0), vdaf=self.inst.kind)

    def dispatched_all(self, ops, b: int) -> bool:
        """Whether this engine has dispatched every op of `ops` at bucket
        `b` in this process."""
        with self._dispatch_track_lock:
            return all((op, b) in self._dispatched_buckets for op in ops)

    def _record_dispatch(self, op: str, n: int, b: int, elapsed_s: float, ledger_op: str | None = None,
                         compile_key: tuple | None = None) -> None:
        """Per-dispatch accounting, as janus_tpu's: the dispatch and row
        counters, the padding-waste gauge, the first-call-per-(op, bucket)
        histogram, and the device-cost ledger's row (the first call of a
        key is its `compile` row, later calls `execute`). `elapsed_s` is
        host time: on the card the enqueue, not the kernels.

        `compile_key` is janus_tpu's jit variant name for the same
        specialization (`leader_init_vk`, `aggregate_view_<vb>`,
        `("aggregate_pending", kk, b)`, ...), so that the key, suffixed
        with ("mesh", dp, sp, device count) on a mesh, is the one
        janus_tpu records: a shape manifest either package wrote warms the
        other. The first call of a key is recorded into the installed
        manifest with its cost."""
        metrics.engine_dispatches_total.add(op=op)
        metrics.engine_rows_total.add(n, op=op)
        if b > 0:
            metrics.engine_batch_fill_ratio.set(n / b, op=op)
        lkey = compile_key if compile_key is not None else (ledger_op or op, b)
        if self.mesh is not None:
            lkey = tuple(lkey) + ("mesh", self.dp, self.sp, len(self._devices))
        with self._dispatch_track_lock:
            first = (op, b) not in self._dispatched_buckets
            if first:
                self._dispatched_buckets.add((op, b))
            ledger_first = lkey not in self._ledger_dispatched
            if ledger_first:
                self._ledger_dispatched.add(lkey)
        if first:
            metrics.engine_compile_seconds.observe(elapsed_s, op=op, bucket=str(b))
        DEVICE_COST.record(
            self.inst.kind, ledger_op or op, b, "compile" if ledger_first else "execute", elapsed_s, rows=n,
            dispatches=1,
        )
        if ledger_first:
            # the cold first call a restarted process would pay again: the
            # boot prewarm replays exactly this set before ready
            shape_manifest.record_dispatch(self.inst, ledger_op or op, b, lkey, elapsed_s, rows=n)

    # --- the mesh: every enqueue on the process's lane ---
    def _on_lane(self, name: str, fn):
        """Run a mesh closure on the `mesh-dispatch` lane, under the
        watchdog with the `engine.dispatch` failpoint, as `_dispatch` runs a
        single-device step. The lane enters the submitting thread's current
        stream on each of the mesh's devices, so the work is ordered after
        everything the caller queued there (its staged columns, a
        prestage's wait)."""

        def step():
            _engine_dispatch_failpoint()
            streams = _current_streams(self._devices)
            return _MESH_QUEUE.submit(_in_streams, streams, fn, vdaf=self.inst.kind, program=name)

        return self._supervised(name, step)

    def _mesh_dispatch(self, name: str, shard_fn, shards, reduce=None):
        """One mesh step: shard_fn(p3, i, *shards[i]) for every dp row i,
        on the row's first device (its launches counted for shard i), then
        `reduce` over the rows' results, all in one lane enqueue. A shard
        that fails raises: nothing is retried on fewer devices."""
        mesh = self.mesh

        def run():
            outs = []
            for i, args in enumerate(shards):
                with device_scope(mesh.device(i)), shard_scope(i):
                    outs.append(shard_fn(self._p3s[i], i, *args))
            return outs if reduce is None else reduce(outs)

        return self._on_lane(name, run)

    def _stage(self, args, specs):
        """Padded host args placed on the mesh, one arg tuple per dp row
        (parallel/api.py stage_shards)."""
        return stage_shards(self.mesh, _map_args(_as_tensor, args), specs)

    def _mesh_rows(self, host_rows, b: int) -> MeshRows:
        """Host out-share rows padded to b and placed on the mesh."""
        (rows,) = pad_args(b, host_rows)
        return MeshRows([shard[0] for shard in self._stage((rows,), ("vec2",))], host_rows[0].shape[0], engine=self)

    def _supervised(self, label: str, fn):
        """Run a device closure under the process watchdog with the
        ambient deadline (a job driver's lease bound, a helper handler's
        request budget); no deadline: a direct call. A spent budget raises
        DeadlineExceeded; only a call past the watchdog's hang bound
        quarantines (a mesh engine's hang quarantines the whole engine). A
        quarantined engine's call (the quarantine flush's fetch) gets no
        such grace: its bounded deadline is the hang bound. The worker
        thread enters the engine's device and the caller's current stream
        on each of the engine's devices: both belong to a thread, and the
        caller's staged tensors (a prestage's wait included) were ordered
        on those streams."""
        phase = self._LEDGER_SUPERVISED_PHASES.get(label)
        if phase is None:
            return self._supervised_call(label, fn)
        t0 = time.monotonic()
        try:
            return self._supervised_call(label, fn)
        finally:
            DEVICE_COST.record(self.inst.kind, label, 0, phase, time.monotonic() - t0)

    # Supervised regions the device-cost ledger books whole, as janus_tpu
    # does: the resident fetches are pure device-to-host waits. The inits'
    # and the aggregate's phases are split inside them instead
    # (_record_dispatch and the put/fetch span hooks).
    _LEDGER_SUPERVISED_PHASES = {
        "resident_fetch": "d2h",
        "resident_delta_fetch": "d2h",
    }

    def _supervised_call(self, label: str, fn):
        deadline = current_deadline()
        if deadline is None or device_watchdog.in_watchdog():
            return fn()
        dev = self.device
        streams = _current_streams(self._devices)

        def on_worker():
            with _streams_scope(streams), device_scope(dev):
                return fn()

        return device_watchdog.WATCHDOG.run(
            on_worker, deadline=deadline, label=label, vdaf=self.inst.kind, on_hang=self._quarantine_on_hang,
            hang_at_deadline=self._quarantined,
        )

    # --- the hang quarantine and its canary ---
    def _backend_state(self) -> str:
        if device_watchdog.WATCHDOG.device_down():
            return "device_down"
        return "quarantined" if self._quarantined else "device"

    def resident_ready(self) -> bool:
        """True while the device path serves: a quarantined engine's
        resident slots flush on the flusher's quarantine sweep."""
        return self._backend_state() == "device"

    def check_available(self, what: str = "dispatch") -> None:
        """Refuse before staging anything while quarantined (or with the
        device down): DeviceQuarantinedError with the time to the canary's
        next probe."""
        if device_watchdog.WATCHDOG.device_down():
            retry = device_watchdog.DEVICE_DOWN_RETRY_S
        elif self._quarantined:
            retry = max(0.0, self._canary_next_at - time.monotonic())
        else:
            return
        with self._stats_lock:
            self.quarantine_stats["refused"] += 1
        raise DeviceQuarantinedError(f"{self.inst.kind} {what}", retry)

    def _quarantine_on_hang(self, label: str) -> None:
        """Watchdog hang hook: open the device circuit. Every dispatch is
        refused from now on (the step that hung steps back, every other
        job too) and the canary thread owns the way back."""
        with self._oom_lock:
            if self._quarantined:
                # a call hung while quarantined; where it is the quarantine
                # flush's fetch, no more fetches until the restore
                if label == "resident_fetch":
                    self._quarantine_fetch_hung = True
                return
            now = time.monotonic()
            self._quarantined = True
            self._quarantined_at = now
            self._canary_next_at = now + self.QUARANTINE_CANARY_DELAY_SECS
            self.oom_history.append(
                {"at": time.time(), "bucket": None, "action": "quarantined", "error": f"hung dispatch {label}"}
            )
            start_canary = not device_watchdog.WATCHDOG.device_down()
            self._publish_state()
        with self._stats_lock:
            self.quarantine_stats["opened"] += 1
        metrics.engine_quarantines_total.add(vdaf=self.inst.kind, event="open")
        log.error("engine %s QUARANTINED after a hung %s; refusing every dispatch while the canary probes the "
                  "device", self.inst.kind, label)
        if start_canary:
            t = threading.Thread(target=self._canary_loop, name=f"engine-canary-{self.inst.kind}", daemon=True)
            self._canary_thread = t
            t.start()

    def _canary_loop(self) -> None:
        """After a cool-down, probe the device; on success restore the
        device path with the initial caps, on failure back off (doubling,
        capped) and probe again. Repeated hung probes walk the
        abandoned-thread cap toward device_down(), which ends the loop.

        After a restore the canary thread re-warms the engine's recorded
        specializations from the installed shape manifest, stop-aware
        between entries, as janus_tpu's does (`quarantine_stats`
        `rewarmed` counts them). janus_tpu's probe drops every compiled
        executable, so its re-warm recompiles them off the serving path.
        The port's quarantine and restore drop nothing a dispatch reuses:
        the kernel libraries stay loaded, PyTorch's loaded modules and the
        caching allocator's segments stay, and the cost ledger's keys stay
        dispatched. So the re-warm replays warm dispatches: the device-cost
        ledger books them `execute`, and the manifest records nothing new.
        What a restore resets is the bucket cap and the coalescers' round
        rows."""
        delay = self.QUARANTINE_CANARY_DELAY_SECS
        while True:
            self._canary_wakeup.wait(delay)
            self._canary_wakeup.clear()
            if self._canary_stop or not self._quarantined or device_watchdog.WATCHDOG.device_down():
                return
            with self._stats_lock:
                self.quarantine_stats["canary_probes"] += 1
            metrics.engine_quarantines_total.add(vdaf=self.inst.kind, event="canary_probe")
            t0 = time.monotonic()
            try:
                self._canary_probe()
            except Exception as e:  # noqa: BLE001 - a hung probe (DeviceHangError) included
                delay = min(delay * 2, self.QUARANTINE_CANARY_MAX_DELAY_SECS)
                with self._oom_lock:
                    self._canary_next_at = time.monotonic() + delay
                with self._stats_lock:
                    self.quarantine_stats["canary_failed"] += 1
                    self.quarantine_stats["canary_delay_s"] = delay
                metrics.engine_quarantines_total.add(vdaf=self.inst.kind, event="canary_failed")
                log.warning("canary probe for %s failed (%s: %s); next probe in %.1fs",
                            self.inst.kind, type(e).__name__, e, delay)
                continue
            now = time.monotonic()
            with self._oom_lock:
                self._quarantined = False
                self._quarantine_fetch_hung = False
                self.bucket_cap = self._initial_bucket_cap
                self._co_leader._max_rows = self._initial_round_rows
                self._co_helper._max_rows = self._initial_round_rows
                self.oom_history.append({"at": time.time(), "bucket": None, "action": "restored", "error": ""})
                quarantined_s = now - self._quarantined_at
                self._publish_state()
            metrics.engine_quarantines_total.add(vdaf=self.inst.kind, event="restored")
            with self._stats_lock:
                self.quarantine_stats["restored"] += 1
                self.quarantine_stats["last_probe_s"] = now - t0
                self.quarantine_stats["last_quarantine_s"] = quarantined_s
            log.warning("engine %s restored to the device path (canary probe succeeded)", self.inst.kind)
            if not self._canary_stop:
                try:
                    from .prewarm import warm_engine_from_manifest

                    warmed = warm_engine_from_manifest(self, should_stop=lambda: self._canary_stop)
                    with self._stats_lock:
                        self.quarantine_stats["rewarmed"] += warmed
                    if warmed:
                        log.info("canary re-warmed %d recorded specialization(s) for %s", warmed, self.inst.kind)
                except Exception:
                    log.warning("post-restore manifest warm failed", exc_info=True)
            return

    def stop_canary(self, timeout_s: float = 2.0) -> None:
        """Process-teardown hook: stop the canary loop and give an
        in-flight probe a bounded window to finish."""
        self._canary_stop = True
        self._canary_wakeup.set()
        t = self._canary_thread
        if t is not None and t.is_alive():
            t.join(timeout_s)

    def _canary_probe(self) -> None:
        """A small real masked aggregate of zeros on the engine's device,
        under the watchdog with its own bounded deadline: success means the
        device answers end to end. It runs on its own stream and waits on
        its own event: a device-wide synchronize would wait on an
        abandoned worker's stream, however healthy the card. The
        `engine.canary` failpoint lets tests hold the quarantine open."""
        p3 = self.p3
        dev = self.device
        # a mesh engine probes through its mesh, on every device and the
        # lane, at the smallest bucket dp divides
        b = max(MIN_BUCKET, self.dp)

        def probe():
            failpoints.hit("engine.canary")
            streams = [torch.cuda.Stream(device=d) for d in dict.fromkeys(self._devices) if d.type == "cuda"]
            with _streams_scope(streams), device_scope(dev):
                shape = (b, p3.circ.output_len)
                if self.mesh is not None:
                    zeros = self._mesh_rows(fzeros(p3.tf, shape, torch.device("cpu")), b)
                    agg = self._mesh_aggregate(zeros, np.zeros(b, dtype=bool))
                else:
                    agg = p3.aggregate(fzeros(p3.tf, shape, dev), torch.zeros(b, dtype=torch.bool, device=dev))
                for stream in streams:
                    done = torch.cuda.Event()
                    done.record(stream)
                    done.synchronize()
                return _value_ints(p3.tf, agg)

        deadline = time.monotonic() + self.QUARANTINE_CANARY_TIMEOUT_SECS
        result = device_watchdog.WATCHDOG.run(probe, deadline=deadline, label="canary", vdaf=self.inst.kind,
                                              hang_at_deadline=True)
        if any(result):
            raise RuntimeError(f"canary probe returned garbage: {result[:4]}")

    def engine_status(self) -> dict:
        """The backend state, the quarantine's counters and the caps."""
        with self._stats_lock:
            stats = dict(self.quarantine_stats)
        return {
            "vdaf": self.inst.kind,
            "backend": self._backend_state(),
            "quarantined": self._quarantined,
            "bucket_cap": self.bucket_cap,
            "quarantine": stats,
            **self.mesh_status(),
        }

    def mesh_status(self) -> dict:
        """This engine's geometry: dp, sp, whether it serves on a mesh,
        whether its resident slots live column-sharded, and why a mesh was
        declined."""
        return {
            "dp": self.dp,
            "sp": self.sp,
            "mesh": self.mesh is not None,
            "devices": [str(d) for d in self._devices],
            "distinct_devices": self.mesh.distinct if self.mesh is not None else True,
            "sharded_resident": self.sp > 1,
            "fallback_reason": self.mesh_fallback_reason,
        }

    def _count_round(self, rows: int) -> None:
        with self._stats_lock:
            self.coalesce_stats["merged_rounds"] += 1
            self.coalesce_stats["merged_rows"] += rows

    def _count_prestage(self, outcome: str) -> None:
        with self._stats_lock:
            self.prestage_stats[outcome] += 1
        if outcome != "issued":
            metrics.engine_prestage_total.add(outcome="hit" if outcome == "used" else "fallback")

    # --- memory-exhaustion ladder (shared by every public step) ---
    def _handle_engine_error(self, e: BaseException, n: int) -> None:
        """Called from an except block. Re-raises anything but memory
        exhaustion unchanged; otherwise frees the allocator's cache and
        halves the bucket cap, so the caller's retry chunks smaller. At
        the floor, or where halving cannot shrink the dispatch, it
        re-raises: the port has no host engine to move to. An error out
        of a coalesced round halves the cap of the engine that ran the
        round (`_exec_engine`), which may be another task's."""
        if not is_oom_error(e):
            raise
        eng = getattr(e, "_janus_exec_engine", self)
        with eng._oom_lock:
            # one exception object may reach several retry loops (every
            # entry of a coalesced round gets it); only the first may
            # touch the cap
            if getattr(e, "_janus_oom_handled", False):
                return
            e._janus_oom_handled = True
            observed = getattr(e, "_janus_dispatch_bucket", None)
            if observed is None:
                observed = bucket_size(n, eng.bucket_cap)
            stuck = (
                getattr(e, "_janus_fixed_bucket", False)
                and eng.bucket_cap is not None
                and observed // 2 >= eng.bucket_cap
            )
            # a mesh bucket splits over dp: the ladder's floor is dp rows
            if observed <= max(1, eng.dp) or stuck:
                eng.oom_history.append(
                    {"at": time.time(), "bucket": observed, "action": "raised", "error": str(e)[:200]}
                )
                raise
            if eng.device.type == "cuda":
                torch.cuda.empty_cache()
            new_cap = observed // 2
            eng.bucket_cap = new_cap if eng.bucket_cap is None else min(eng.bucket_cap, new_cap)
            eng.oom_history.append(
                {
                    "at": time.time(),
                    "bucket": observed,
                    "action": f"halved_to_{eng.bucket_cap}",
                    "error": str(e)[:200],
                }
            )
            metrics.engine_oom_retry_counter.add()
            eng._publish_state()

    def would_coalesce(self, n: int) -> bool:
        """True when an init of n rows enters a coalesced round (the
        routing of the init entries). A prestage for such a job is wasted
        whenever its round merges, so a parallel device lane declines to
        prestage exactly these jobs."""
        cap = self.bucket_cap
        return n <= self.COALESCE_MAX_JOB and (cap is None or n <= cap)

    # --- helper side: init + combine + decide in one step ---
    def helper_init(self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask):
        """Returns (out1 DeviceRows, accept mask, prep_msg lanes), the
        last two as numpy sliced to the true batch size. A batch of at
        most COALESCE_MAX_JOB rows rides a coalesced round."""
        args = (nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask)
        self.check_available("helper_init")
        while True:
            try:
                return self._helper_init_entry(*args)
            except Exception as e:  # noqa: BLE001 - memory filter inside
                self._handle_engine_error(e, nonce_lanes.shape[0])

    def _helper_init_entry(self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask):
        n = nonce_lanes.shape[0]
        if self.would_coalesce(n):
            return self._co_helper.submit(
                (self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask), n
            )
        return self._helper_init_inner(nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask)

    def _helper_init_chunked(
        self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask, cap: int, vk_lanes=None
    ):
        """Serial cap-sized dispatches for a batch past the memory bound;
        out shares stay on the device as DeviceRowsChunks."""
        n = nonce_lanes.shape[0]
        outs, masks, preps = [], [], []
        for s in range(0, n, cap):
            e = min(s + cap, n)
            out1, mask, prep = self._helper_init_inner(
                *(_cut_rows(a, s, e) for a in (nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask)),
                vk_lanes=_cut_rows(vk_lanes, s, e),
            )
            outs.append(out1)
            masks.append(mask)
            preps.append(prep)
        return DeviceRowsChunks(outs), np.concatenate(masks), np.concatenate(preps)

    def _helper_init_inner(
        self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask, coalesced: int = 0,
        vk_lanes=None,
    ):
        """One helper dispatch (chunked past the cap). `coalesced` is the
        round's call count (0 outside a merged round); `vk_lanes` the
        per-lane verify keys of a cross-task round."""
        self.check_available("helper_init")  # a round queued behind a hang
        p3 = self.p3
        n = nonce_lanes.shape[0]
        cap = self.bucket_cap  # read once: recovery may halve it meanwhile
        if cap is not None and n > cap:
            return self._helper_init_chunked(
                nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask, cap, vk_lanes=vk_lanes
            )
        b = bucket_size(n, cap)
        raw = (nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask)
        if self.mesh is not None:
            return self._mesh_helper_init(raw, n, b, vk_lanes)

        kind = self.inst.kind
        try:
            with span("engine.helper_init", vdaf=kind, batch=n, bucket=b, coalesced=coalesced):
                with span("engine.helper_init.put", vdaf=kind, bucket=b):
                    host = pad_args(b, *raw) if vk_lanes is None else pad_args(b, vk_lanes, *raw)
                    count_h2d(host)
                    if vk_lanes is None:
                        staged = put_args(host, self.device)
                        vkey = self.verify_key
                    else:
                        vkey, *staged = put_args(host, self.device)

                def dispatch():
                    with span("engine.helper_init.dispatch", vdaf=kind):
                        return _helper_step(p3, vkey, *staged)

                t_disp = time.monotonic()
                out1, mask, prep_msg = self._dispatch("helper_init", dispatch)
                self._record_dispatch("helper_init", n, b, time.monotonic() - t_disp,
                                      compile_key=(_init_variant("helper_init", vk_lanes), b))

                # out1 stays on the device; the mask and prep message come
                # back (the .cpu() blocks until the step has run)
                def fetch():
                    with span("engine.helper_init.fetch", vdaf=kind, bucket=b):
                        got = (mask[:n].cpu().numpy(), _fetch_rows(prep_msg, n))
                        count_d2h(got)
                        return got

                mask, prep_msg = self._fetch("helper_init_fetch", fetch)
        except Exception as e:
            _annotate_dispatch_bucket(e, b)
            raise
        return DeviceRows(out1, n, engine=self), mask, prep_msg

    def _mesh_helper_init(self, raw, n: int, b: int, vk_lanes):
        """One helper dispatch on the mesh: the bucket's rows split over dp,
        each row block's step on its row's first device, the out shares
        split by columns over the row's sp devices."""
        mesh = self.mesh
        vkey = self.verify_key if vk_lanes is None else vk_lanes

        def shard(p3, i, *a):
            out1, mask, prep_msg = _helper_step(p3, *a)
            return ColumnShards.split(out1, mesh.row(i)), mask, prep_msg

        kind = self.inst.kind

        def fetch():
            with span("engine.helper_init.fetch", vdaf=kind, bucket=b):
                got = (
                    np.concatenate([o[1].cpu().numpy() for o in outs])[:n],
                    np.concatenate([to_numpy_u64(o[2]) for o in outs])[:n],
                )
                count_d2h(got)
                return got

        try:
            with span("engine.helper_init", vdaf=kind, batch=n, bucket=b, coalesced=0):
                with span("engine.helper_init.put", vdaf=kind, bucket=b):
                    host = pad_args(b, vkey, *raw)
                    count_h2d(host)
                    shards = self._stage(host, ("rows",) * 8)
                t_disp = time.monotonic()
                with span("engine.helper_init.dispatch", vdaf=kind):
                    outs = self._mesh_dispatch("helper_init", shard, shards)
                self._record_dispatch("helper_init", n, b, time.monotonic() - t_disp,
                                      compile_key=(_init_variant("helper_init", vk_lanes), b))
                mask, prep_msg = self._fetch("helper_init_fetch", fetch)
        except Exception as e:
            _annotate_dispatch_bucket(e, b)
            raise
        return MeshRows([o[0] for o in outs], n, engine=self), mask, prep_msg

    # --- leader side: init only (the helper round trip follows) ---
    def leader_init(self, nonce_lanes, public_parts, meas, proof, blind0, ok=None, prestaged=None):
        """Returns (out0 DeviceRows or DeviceRowsChunks, corrected seed
        lanes or None, verifier share limbs, own joint-rand part lanes or
        None), the last three as numpy. `ok` is accepted for interface
        parity with janus_tpu; failed lanes cost nothing extra here.
        `prestaged` (from prestage_leader) is used where the direct route
        runs at its bucket, else discarded: the columns then go up from
        the host."""
        try:
            self.check_available("leader_init")
        except DeviceQuarantinedError:
            self._drop_prestage(prestaged)
            raise
        while True:
            try:
                return self._leader_init_entry(nonce_lanes, public_parts, meas, proof, blind0, prestaged)
            except Exception as e:  # noqa: BLE001 - memory filter inside
                if prestaged is not None:
                    prestaged.discard()  # the retry stages from the host
                    prestaged = None
                self._handle_engine_error(e, nonce_lanes.shape[0])

    def _leader_init_entry(self, nonce_lanes, public_parts, meas, proof, blind0, prestaged=None):
        n = nonce_lanes.shape[0]
        if self.would_coalesce(n):
            return self._co_leader.submit((self, prestaged, nonce_lanes, public_parts, meas, proof, blind0), n)
        return self._leader_init_inner(nonce_lanes, public_parts, meas, proof, blind0, prestaged=prestaged)

    def _leader_step(self, vkey, nonce_lanes, public_parts, meas, proof, blind0):
        return self.p3.prepare_init_leader(vkey, nonce_lanes, public_parts, meas, proof, blind0)

    def _drop_prestage(self, prestaged) -> None:
        if prestaged is not None:
            prestaged.discard()
            self._count_prestage("discarded")

    def _leader_init_inner(
        self, nonce_lanes, public_parts, meas, proof, blind0, coalesced: int = 0, allow_pipeline: bool = True,
        vk_lanes=None, prestaged=None,
    ):
        """One leader init: chunked past the cap, pipelined at 2 x
        PIPELINE_CHUNK rows or more (outside a merged round), else one
        dispatch, from a usable prestage or from the host columns."""
        try:
            self.check_available("leader_init")  # a round queued behind a hang
        except DeviceQuarantinedError:
            self._drop_prestage(prestaged)
            raise
        n = nonce_lanes.shape[0]
        cap = self.bucket_cap
        if cap is not None and n > cap:
            self._drop_prestage(prestaged)
            return self._leader_init_chunked(nonce_lanes, public_parts, meas, proof, blind0, cap, vk_lanes=vk_lanes)
        # the pipelined route is the single-device engine's: a mesh splits
        # a big batch over its devices instead
        if allow_pipeline and vk_lanes is None and self.mesh is None and n >= 2 * self.PIPELINE_CHUNK:
            self._drop_prestage(prestaged)
            return self._leader_init_pipelined(nonce_lanes, public_parts, meas, proof, blind0)
        b = bucket_size(n, cap)
        meshed = self.mesh is not None
        use_prestaged = prestaged is not None and vk_lanes is None and prestaged.usable(b, meshed)
        if prestaged is not None and not use_prestaged:
            self._drop_prestage(prestaged)
        if meshed:
            return self._mesh_leader_init(
                (nonce_lanes, public_parts, meas, proof, blind0), n, b, vk_lanes, prestaged if use_prestaged else None
            )
        kind = self.inst.kind
        try:
            with span("engine.leader_init", vdaf=kind, batch=n, bucket=b, coalesced=coalesced,
                      prestaged=bool(use_prestaged)):
                with span("engine.leader_init.put", vdaf=kind, bucket=b):
                    if use_prestaged:
                        self._count_prestage("used")
                        staged = _take_prestaged(prestaged)
                        vkey = self.verify_key
                    elif vk_lanes is None:
                        host = pad_args(b, nonce_lanes, public_parts, meas, proof, blind0)
                        count_h2d(host)
                        staged = put_args(host, self.device)
                        vkey = self.verify_key
                    else:
                        host = pad_args(b, vk_lanes, nonce_lanes, public_parts, meas, proof, blind0)
                        count_h2d(host)
                        vkey, *staged = put_args(host, self.device)

                def dispatch():
                    with span("engine.leader_init.dispatch", vdaf=kind):
                        return self._leader_step(vkey, *staged)

                t_disp = time.monotonic()
                out0, seed0, ver0, part0 = self._dispatch("leader_init", dispatch)
                self._record_dispatch("leader_init", n, b, time.monotonic() - t_disp,
                                      compile_key=(_init_variant("leader_init", vk_lanes), b))
                seed0, ver0, part0 = self._fetch(
                    "leader_init_fetch", lambda: _fetch_leader_rows_spanned(kind, b, seed0, ver0, part0, n)
                )
        except Exception as e:
            _annotate_dispatch_bucket(e, b)
            raise
        return DeviceRows(out0, n, engine=self), seed0, ver0, part0

    # the staging of a leader init's columns on a mesh: the measurement's
    # columns split over each row's sp devices
    LEADER_SPECS = ("rows", "rows", "vec2", "rows", "rows")

    def _mesh_leader_init(self, raw, n: int, b: int, vk_lanes, prestaged):
        """One leader dispatch on the mesh, from a usable prestage or from
        the host columns: each row block's measurement is gathered on its
        row's first device for the query, its out shares split back by
        columns over the row's sp devices."""
        mesh = self.mesh

        def shard(p3, i, vkey, nonce_lanes, public_parts, meas, proof, blind0):
            out0, seed0, ver0, part0 = p3.prepare_init_leader(
                vkey, nonce_lanes, public_parts, meas.gather(mesh.device(i)), proof, blind0
            )
            return ColumnShards.split(out0, mesh.row(i)), seed0, ver0, part0

        kind = self.inst.kind
        try:
            with span("engine.leader_init", vdaf=kind, batch=n, bucket=b, coalesced=0,
                      prestaged=prestaged is not None):
                with span("engine.leader_init.put", vdaf=kind, bucket=b):
                    if prestaged is not None:
                        self._count_prestage("used")
                        shards = [(self.verify_key, *sh) for sh in _take_prestaged(prestaged)]
                    else:
                        vkey = self.verify_key if vk_lanes is None else vk_lanes
                        host = pad_args(b, vkey, *raw)
                        count_h2d(host)
                        shards = self._stage(host, ("rows",) + self.LEADER_SPECS)
                t_disp = time.monotonic()
                with span("engine.leader_init.dispatch", vdaf=kind):
                    outs = self._mesh_dispatch("leader_init", shard, shards)
                self._record_dispatch("leader_init", n, b, time.monotonic() - t_disp,
                                      compile_key=(_init_variant("leader_init", vk_lanes), b))

                def fetch():
                    with span("engine.leader_init.fetch", vdaf=kind, bucket=b):
                        h = b // self.dp
                        rows = [_fetch_leader_rows(*o[1:], h) for o in outs]
                        got = tuple(_cat_host([r[k] for r in rows], n) for k in range(3))
                        count_d2h(got)
                        return got

                seed0, ver0, part0 = self._fetch("leader_init_fetch", fetch)
        except Exception as e:
            _annotate_dispatch_bucket(e, b)
            raise
        return MeshRows([o[0] for o in outs], n, engine=self), seed0, ver0, part0

    def prestage_leader(self, nonce_lanes, public_parts, meas, proof, blind0):
        """Double-buffered staging: issue the padded columns' uploads now
        (pinned, non-blocking, on a side stream; from the pipeline's read
        stage, while the device lane runs the previous job) and return a
        PrestagedInit for leader_init. None where the direct route will
        not run: past the cap (chunked) and at 2 x PIPELINE_CHUNK rows or
        more (the pipelined route stages its own chunks)."""
        self.check_available("prestage_leader")
        n = nonce_lanes.shape[0]
        cap = self.bucket_cap
        if cap is not None and n > cap:
            return None
        if self.mesh is None and n >= 2 * self.PIPELINE_CHUNK:
            return None
        b = bucket_size(n, cap)
        args = pad_args(b, nonce_lanes, public_parts, meas, proof, blind0)
        ready = []
        if self.mesh is not None:
            # one side stream per device; the copies read pinned memory
            streams = [torch.cuda.Stream(device=d) for d in dict.fromkeys(self._devices) if d.type == "cuda"]
            if streams:
                args = _map_args(lambda t: t.pin_memory(), args)
            with _streams_scope(streams):
                staged = self._stage(args, self.LEADER_SPECS)
            for stream in streams:
                ev = torch.cuda.Event()
                ev.record(stream)
                ready.append((stream.device, ev))
        elif self.device.type == "cuda":
            copy_stream = torch.cuda.Stream(device=self.device)
            staged = put_args(args, self.device, stream=copy_stream)
            ev = torch.cuda.Event()
            ev.record(copy_stream)
            ready.append((self.device, ev))
        else:
            staged = put_args(args, self.device)
        self._count_prestage("issued")
        return PrestagedInit(b, staged, ready, meshed=self.mesh is not None)

    @staticmethod
    def _merge_leader_chunks(outs, seeds, vers, parts):
        seed = np.concatenate(seeds) if seeds[0] is not None else None
        ver = tuple(np.concatenate([v[i] for v in vers]) for i in range(len(vers[0])))
        part = np.concatenate(parts) if parts[0] is not None else None
        return DeviceRowsChunks(outs), seed, ver, part

    def _leader_init_chunked(self, nonce_lanes, public_parts, meas, proof, blind0, cap: int, vk_lanes=None):
        """Serial cap-sized leader inits for a batch past the memory
        bound. Unlike the pipelined route, chunk k+1 is not staged while
        chunk k computes: bounding resident bytes is the point."""
        n = nonce_lanes.shape[0]
        outs, seeds, vers, parts = [], [], [], []
        for s in range(0, n, cap):
            e = min(s + cap, n)
            out0, seed0, ver0, part0 = self._leader_init_inner(
                *(_cut_rows(a, s, e) for a in (nonce_lanes, public_parts, meas, proof, blind0)),
                allow_pipeline=False,
                vk_lanes=_cut_rows(vk_lanes, s, e),
            )
            outs.append(out0)
            seeds.append(seed0)
            vers.append(ver0)
            parts.append(part0)
        return self._merge_leader_chunks(outs, seeds, vers, parts)

    def _leader_init_pipelined(self, nonce_lanes, public_parts, meas, proof, blind0):
        """Chunked leader init: every chunk's host-to-device copy is
        issued at once (pinned, non-blocking, on a side stream), then the
        chunks compute in order, chunk k waiting on its own copy's event
        only, so its compute overlaps chunks k+1..'s copies. Out shares
        stay on the device as DeviceRowsChunks."""
        n = nonce_lanes.shape[0]
        C = self.PIPELINE_CHUNK
        spans = [(s, min(s + C, n)) for s in range(0, n, C)]
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(device=self.device) if cuda else None
        kind = self.inst.kind
        # the dominant chunk bucket keys the ledger's row of the whole
        # pass's put and fetch, as in janus_tpu
        chunk_b = bucket_size(min(n, C))

        def fetch():
            with span("engine.leader_init.fetch", vdaf=kind, bucket=chunk_b):
                got = [_fetch_leader_rows(*r[1:], e - s) for (s, e), r in zip(spans, results)]
                count_d2h(got)
                return got

        try:
            with span("engine.leader_init", vdaf=kind, batch=n, pipelined=len(spans)):
                staged, ready = [], []
                with span("engine.leader_init.put_all_async", vdaf=kind, bucket=chunk_b):
                    for s, e in spans:
                        args = pad_args(
                            bucket_size(e - s),
                            *(_cut_rows(a, s, e) for a in (nonce_lanes, public_parts, meas, proof, blind0)),
                        )
                        count_h2d(args)
                        staged.append(put_args(args, self.device, stream=copy_stream))
                        if cuda:
                            ev = torch.cuda.Event()
                            ev.record(copy_stream)
                            ready.append(ev)
                results = []
                for k, args in enumerate(staged):
                    s, e = spans[k]
                    with span("engine.leader_init.chunk", k=k, rows=e - s, vdaf=kind):
                        if cuda:
                            compute = torch.cuda.current_stream(self.device)
                            compute.wait_event(ready[k])
                            # tensors made on the copy stream are read on this
                            # one: the allocator must not reuse them early
                            _map_args(lambda t: t.record_stream(compute), args)
                        t_disp = time.monotonic()
                        results.append(self._dispatch("leader_init", self._leader_step, self.verify_key, *args))
                        self._record_dispatch("leader_init", e - s, bucket_size(e - s), time.monotonic() - t_disp)
                outs = [DeviceRows(r[0], e - s, engine=self) for (s, e), r in zip(spans, results)]
                fetched = self._fetch("leader_init_fetch", fetch)
            seeds, vers, parts = (list(col) for col in zip(*fetched))
        except Exception as exc:
            _annotate_dispatch_bucket(exc, bucket_size(min(n, C)))
            raise
        return self._merge_leader_chunks(outs, seeds, vers, parts)

    # --- masked aggregate over the batch axis ---
    def aggregate(self, out_shares, mask):
        """Masked aggregate as a list of Python ints, with the same
        memory ladder as the init steps. out_shares: DeviceRows (an
        offset view included), DeviceRowsChunks, or host rows (a limb
        tuple of arrays or tensors)."""
        self.check_available("aggregate")
        while True:
            try:
                return self._aggregate_inner(out_shares, mask)
            except Exception as e:  # noqa: BLE001 - memory filter inside
                n = getattr(out_shares, "n", None) or np.asarray(mask).shape[0]
                self._handle_engine_error(e, n)

    def _merge_partials(self, parts):
        p = self.p3.tf.MODULUS
        total = None
        for part in parts:
            total = part if total is None else [(a + b) % p for a, b in zip(total, part)]
        return total

    def _aggregate_inner(self, out_shares, mask):
        p3 = self.p3
        mask = np.asarray(mask, dtype=bool)
        if self.mesh is not None:
            return self._mesh_aggregate_inner(out_shares, mask)
        if isinstance(out_shares, DeviceRowsChunks):
            # per-chunk masked reduce, merged mod p on the host
            offs = np.cumsum([0] + [c.n for c in out_shares.chunks])
            return self._merge_partials(
                self._aggregate_inner(c, mask[offs[i] : offs[i + 1]]) for i, c in enumerate(out_shares.chunks)
            )
        variant, rec_b = "aggregate", None
        if isinstance(out_shares, DeviceRows):
            # resident rows: only the mask moves; the reduce reads the
            # job's own rows of the buffer in place
            n, s = out_shares.n, out_shares.offset
            dispatch_b, fixed = out_shares.value[0].shape[0], True
            vb = bucket_size(n)
            if (s or vb < dispatch_b) and s + vb <= dispatch_b:
                # a view of a wider buffer (a merged round's job): janus_tpu
                # jits it as its own variant at the view's bucket
                variant, rec_b = f"aggregate_view_{vb}", vb
            args = (tuple(x[s : s + n] for x in out_shares.value), torch.from_numpy(mask.copy()).to(self.device))
            count_h2d(int(mask.nbytes))
        else:
            n = mask.shape[0]
            cap = self.bucket_cap
            if cap is not None and n > cap:
                # host rows past the memory cap: cap-sized partial reduces
                return self._merge_partials(
                    self._aggregate_inner(_cut_rows(out_shares, s, min(s + cap, n)), mask[s : s + cap])
                    for s in range(0, n, cap)
                )
            dispatch_b, fixed = bucket_size(n, cap), False
            args = None
        try:
            t_disp = time.monotonic()
            # the fetch (to_ints) waits for the kernels: inside the span,
            # as janus_tpu's, so it bounds the device work, not the enqueue
            with span("engine.aggregate.dispatch", vdaf=self.inst.kind, batch=n, bucket=dispatch_b):
                if args is None:
                    host = pad_args(dispatch_b, out_shares, mask)
                    count_h2d(host)
                    args = put_args(host, self.device)
                agg = self._dispatch("aggregate", p3.aggregate, *args)
                result = self._fetch("aggregate_fetch", lambda: [int(x) for x in p3.tf.to_ints(agg)])
                count_d2h(len(result) * p3.tf.LIMBS * 8)
            rec_b = rec_b or dispatch_b
            self._record_dispatch("aggregate", n, rec_b, time.monotonic() - t_disp, compile_key=(variant, rec_b))
            return result
        except Exception as e:
            _annotate_dispatch_bucket(e, dispatch_b, fixed=fixed)
            raise

    def _mesh_aggregate_inner(self, out_shares, mask):
        """A mesh engine's masked aggregate: chunks chunk by chunk, host rows
        staged on the mesh (cap-sized), then `_mesh_aggregate`."""
        if isinstance(out_shares, DeviceRowsChunks):
            offs = np.cumsum([0] + [c.n for c in out_shares.chunks])
            return self._merge_partials(
                self._mesh_aggregate_inner(c, mask[offs[i] : offs[i + 1]]) for i, c in enumerate(out_shares.chunks)
            )
        variant, rec_b = "aggregate", None
        if isinstance(out_shares, MeshRows):
            b, fixed, rows = out_shares.bucket, True, out_shares
            vb = bucket_size(rows.n)
            if (rows.offset or vb < b) and rows.offset + vb <= b:
                variant, rec_b = f"aggregate_view_{vb}", vb  # a view: as on one device
        else:
            n = mask.shape[0]
            cap = self.bucket_cap
            if cap is not None and n > cap:
                return self._merge_partials(
                    self._mesh_aggregate_inner(_cut_rows(out_shares, s, min(s + cap, n)), mask[s : s + cap])
                    for s in range(0, n, cap)
                )
            b, fixed, rows = bucket_size(n, cap), False, None
        try:
            t_disp = time.monotonic()
            with span("engine.aggregate.dispatch", vdaf=self.inst.kind, batch=rows.n if rows is not None else n,
                      bucket=b):
                if rows is None:
                    count_h2d(out_shares)
                    rows = self._mesh_rows(out_shares, b)
                count_h2d(int(mask.nbytes))
                agg = self._mesh_aggregate(rows, mask)
                result = self._fetch("aggregate_fetch", lambda: _value_ints(self.p3.tf, agg))
                count_d2h(len(result) * self.p3.tf.LIMBS * 8)
            rec_b = rec_b or b
            self._record_dispatch("aggregate", rows.n, rec_b, time.monotonic() - t_disp, compile_key=(variant, rec_b))
            return result
        except Exception as e:
            _annotate_dispatch_bucket(e, b, fixed=fixed)
            raise

    def _reduced(self, parts):
        """dp rows' column-sharded partials summed onto row 0's devices
        mod p: a limb tuple on the mesh's first device when sp = 1."""
        total = reduce_columns(self.p3.tf, parts)
        return total.blocks[0] if self.sp == 1 else total

    def _mesh_aggregate(self, rows: MeshRows, mask):
        """Masked sum of a mesh value's own rows: each dp row's column
        blocks summed on their devices under the row's slice of the mask
        (False on every row not the value's), then reduced mod p."""
        full = rows.full_lanes(np.asarray(mask, dtype=bool), False)
        h = rows.bucket // self.dp

        def shard(p3, i, cols):
            m = torch.from_numpy(full[i * h : (i + 1) * h].copy())
            return ColumnShards(p3.aggregate(blk, m.to(blk[0].device)) for blk in cols.blocks)

        return self._mesh_dispatch("aggregate", shard, [(blk,) for blk in rows.blocks], reduce=self._reduced)

    def _mesh_pending(self, rows: MeshRows, bucket_idx, k: int):
        """aggregate_buckets over a mesh value's own rows (index -1 on every
        row not the value's), reduced mod p: [k, output_len] on the mesh's
        first device, column shards on row 0's devices when sp > 1."""
        full = rows.full_lanes(np.asarray(bucket_idx, np.int32), -1)
        h = rows.bucket // self.dp

        def shard(p3, i, cols):
            idx = torch.from_numpy(full[i * h : (i + 1) * h].copy())
            return ColumnShards(p3.aggregate_buckets(blk, idx.to(blk[0].device), k) for blk in cols.blocks)

        return self._mesh_dispatch("aggregate_pending", shard, [(blk,) for blk in rows.blocks], reduce=self._reduced)

    # --- block-sparse aggregate: scatter-merge into a logical accumulator ---
    def aggregate_sparse(self, out_shares, mask, flat_idx):
        """Masked sparse aggregate as a list of Python ints of the logical
        length: every accepted report's compact out share scattered into
        one logical accumulator at its flat positions. flat_idx: [n,
        compact_len] int32 (wire.flat_scatter_indices), the sentinel L on
        padding lanes; a rejected report's row becomes all sentinel here.
        out_shares as for `aggregate`. On memory exhaustion the ladder
        halves the rows a dispatch takes and starts the accumulator
        again; at the floor it raises (there is no host scatter)."""
        self.check_available("aggregate_sparse")
        L = self.p3.circ.agg_output_len
        accept = np.asarray(mask, dtype=bool)
        idx = np.where(accept[:, None], np.asarray(flat_idx, dtype=np.int32), np.int32(L)).astype(np.int32)
        n = idx.shape[0]
        n_rows = int(accept.sum())
        live = int((idx < L).sum())
        while True:
            try:
                t_disp = time.monotonic()
                acc = self._scatter_dispatch(self._zeros_row(L), out_shares, idx)
                result = self._fetch("aggregate_fetch", lambda: [int(x) for x in self.p3.tf.to_ints(acc)])
                count_d2h(len(result) * self.p3.tf.LIMBS * 8)
                self._record_dispatch("aggregate", n, bucket_size(n), time.monotonic() - t_disp,
                                      ledger_op="scatter_merge", compile_key=("scatter_merge", bucket_size(n)))
                self._count_scatter(n_rows, live, idx.shape[1], resident=False)
                return result
            except Exception as e:  # noqa: BLE001 - memory filter inside
                self._handle_engine_error(e, idx.shape[0])

    def _count_scatter(self, n_rows: int, live: int, width: int, resident: bool = True) -> None:
        """The scatter metrics of one scatter-merge: its accepted reports
        and the share of their block slots that carried a block (host
        index data only). The resident status counts the resident merges'
        rows alone."""
        metrics.engine_scatter_rows_total.add(n_rows, vdaf=self.inst.kind)
        if resident:
            self._scatter_rows_total += n_rows
        if n_rows:
            occ = live / (n_rows * width)
            self._sparse_last_occupancy = occ
            metrics.engine_sparse_block_occupancy.set(occ, vdaf=self.inst.kind)

    def _zeros_row(self, length: int):
        """A fresh logical accumulator: a zero field row on the device."""
        return fzeros(self.p3.tf, (length,), self.device)

    def _scatter_rows(self, acc, values, idx, s: int, e: int):
        """Scatter rows [s, e) of a staged value into acc, at most the cap
        (read once) rows a dispatch. values: limb tensors on the device;
        idx: [rows, cm] host int32."""
        cap = self.bucket_cap
        step = e - s if cap is None else min(cap, e - s)
        for lo in range(s, e, step):
            hi = min(lo + step, e)
            try:
                rows = tuple(x[lo:hi] for x in values)
                idx_h = np.ascontiguousarray(idx[lo - s : hi - s])
                count_h2d(int(idx_h.nbytes))
                idx_t = torch.from_numpy(idx_h).to(self.device)
                acc = self._dispatch("scatter_rows", self.p3.scatter_rows, acc, rows, idx_t)
            except Exception as exc:
                _annotate_dispatch_bucket(exc, hi - lo)
                raise
        return acc

    def _scatter_dispatch(self, acc, out_shares, idx):
        """Scatter every row of `out_shares` whose idx row is live into
        acc (idx: [n, compact_len] host int32, the sentinel L drops a
        lane). DeviceRowsChunks go chunk by chunk; a DeviceRows scatters
        its whole bucket, the padding rows with all-sentinel idx rows, so
        their garbage never lands; host rows pad to their bucket the same
        way."""
        L = acc[0].shape[0]
        if isinstance(out_shares, DeviceRowsChunks):
            off = 0
            for chunk in out_shares.chunks:
                acc = self._scatter_dispatch(acc, chunk, idx[off : off + chunk.n])
                off += chunk.n
            return acc
        if isinstance(out_shares, DeviceRows):
            b = out_shares.value[0].shape[0]
            s = out_shares.offset
            full = np.full((b, idx.shape[1]), np.int32(L), np.int32)
            full[s : s + out_shares.n] = idx
            return self._scatter_rows(acc, out_shares.value, full, 0, b)
        # host limb rows
        n = idx.shape[0]
        b = bucket_size(n)
        host = pad_args(b, out_shares)
        count_h2d(host)
        (padded,) = put_args(host, self.device)
        full = np.full((b, idx.shape[1]), np.int32(L), np.int32)
        full[:n] = idx
        return self._scatter_rows(acc, padded, full, 0, b)

    # --- device-resident aggregate state: the engine owns the slots and
    # their device work; the driver owns the flush policy (interval,
    # eviction, drain), through its write-transaction path ---
    def note_classic_fallback(self) -> None:
        """The driver took the classic per-bucket accumulate for a job
        that asked for the resident route (memory exhaustion only)."""
        with self._resident_lock:
            self._resident_stats["classic_fallbacks"] += 1

    def aggregate_pending(self, out_shares, bucket_idx, k: int, flat_idx=None):
        """One job's per-bucket masked sums as a device [k, output_len]
        value (`PendingDeltas`): one dispatch, one [n] int32 upload,
        nothing fetched. bucket_idx: [n] int32, the bucket of each lane,
        -1 for a rejected one. Errors propagate: the driver falls back to
        the classic accumulate on memory exhaustion only.

        `flat_idx` ([n, compact_len] int32 scatter targets) marks a
        block-sparse job: nothing runs here, the scatter into the dense
        slot runs at merge time (SparsePendingDeltas says why)."""
        self.check_available("aggregate_pending")
        p3 = self.p3
        bucket_idx = np.asarray(bucket_idx, np.int32)
        if flat_idx is not None:
            L = p3.circ.agg_output_len
            return SparsePendingDeltas(
                out_shares, np.asarray(flat_idx, np.int32), bucket_idx, k, L * p3.tf.LIMBS * 8, L
            )
        n_rows = len(bucket_idx)
        try:
            t_disp = time.monotonic()
            value = self._pending_dispatch(out_shares, bucket_idx, k)
            # janus_tpu's program specializes on k padded to a power of
            # two (kk); the port sums k buckets as they are, under its key
            kk = 1 << max(0, int(k - 1).bit_length())
            self._record_dispatch("aggregate", n_rows, bucket_size(n_rows), time.monotonic() - t_disp,
                                  ledger_op="aggregate_pending",
                                  compile_key=("aggregate_pending", kk, bucket_size(n_rows)))
        except Exception as e:
            _annotate_dispatch_bucket(e, bucket_size(len(bucket_idx)), fixed=True)
            raise
        return PendingDeltas(value, k, p3.circ.output_len * p3.tf.LIMBS * 8)

    def _pending_dispatch(self, out_shares, bucket_idx, k: int):
        """aggregate_buckets over the rows of any out-share currency: a
        DeviceRows reads only its own rows [offset, offset + n) of its
        buffer (a merged round's neighbours never enter), chunks sum
        chunk by chunk, host rows go up first."""
        p3 = self.p3
        if isinstance(out_shares, DeviceRowsChunks):
            total = None
            off = 0
            for chunk in out_shares.chunks:
                part = self._pending_dispatch(chunk, bucket_idx[off : off + chunk.n], k)
                off += chunk.n
                total = part if total is None else _value_add(p3.tf, total, part)
            return total
        if self.mesh is not None:
            if not isinstance(out_shares, MeshRows):
                out_shares = self._mesh_rows(out_shares, bucket_size(len(bucket_idx)))
            return self._mesh_pending(out_shares, bucket_idx, k)
        if isinstance(out_shares, DeviceRows):
            n, s = out_shares.n, out_shares.offset
            rows = tuple(x[s : s + n] for x in out_shares.value)
        else:
            host = pad_args(len(bucket_idx), out_shares)
            count_h2d(host)
            (rows,) = put_args(host, self.device)
        idx_h = np.ascontiguousarray(bucket_idx)
        count_h2d(int(idx_h.nbytes))
        idx = torch.from_numpy(idx_h).to(self.device)
        return self._dispatch("aggregate_pending", p3.aggregate_buckets, rows, idx, k)

    def _resident_add(self, acc, row):
        """acc + row on the card (a new tensor: PyTorch has no donation,
        and the old value is freed when the slot lets it go). On a mesh
        through the lane; a column-sharded slot adds shard by shard on its
        devices and stays sharded until a take or flush gathers it."""
        if self.mesh is not None:
            return self._on_lane("resident_add", lambda: _value_add(self.p3.tf, acc, row))
        return self._dispatch("resident_add", self.p3.tf.add, acc, row)

    def _sparse_slot_value(self, slot, deltas: SparsePendingDeltas, j: int):
        """Bucket j's report rows scattered into the slot's dense logical
        accumulator (a zero one for a fresh slot or a raw delta fetch):
        kernel 4, which writes a new accumulator (acc copied, then added
        into), one launch a dispatch."""
        L = deltas.logical_len
        sel = deltas.bucket_idx == j
        idx = np.where(sel[:, None], deltas.flat_idx, np.int32(L)).astype(np.int32)
        acc = self._zeros_row(L) if slot is None else slot.value
        n_rows = int(sel.sum())
        t_disp = time.monotonic()
        value = self._scatter_dispatch(acc, deltas.out_shares, idx)
        self._record_dispatch("aggregate", n_rows, bucket_size(len(sel)), time.monotonic() - t_disp,
                              ledger_op="scatter_merge", compile_key=("scatter_merge", bucket_size(len(sel))))
        self._count_scatter(n_rows, int((idx < L).sum()), deltas.flat_idx.shape[1])
        return value

    def resident_merge(self, entries, deltas) -> list[dict]:
        """Merge one job's committed deltas into the resident slots.

        entries: [(key, j, report_count, interval)], key = (task_id bytes,
        agg_param bytes, batch_identifier bytes), j the delta's bucket.
        Call only after the job's write transaction committed (a failed or
        retried step drops its deltas, so nothing merges twice). Returns
        flush records of slots evicted past RESIDENT_MAX_BYTES, fetched
        and removed from the card already: the caller must persist them.
        A failure partway raises ResidentMergeError with the merged keys."""
        from ..messages import Interval

        self.check_available("resident_merge")
        sparse = isinstance(deltas, SparsePendingDeltas)
        evicted: list[ResidentSlot] = []
        merged: set = set()
        with self._resident_lock:
            try:
                for key, j, rows, interval in entries:
                    slot = self._resident.get(key)
                    if sparse:
                        # the scatter lands in the fresh or the existing
                        # dense logical accumulator
                        value = self._sparse_slot_value(slot, deltas, j)
                    if slot is None:
                        slot = ResidentSlot(key, value if sparse else deltas.row(j), interval, rows, deltas.row_nbytes)
                        self._resident[key] = slot
                        _resident_bytes_add(slot.nbytes, self.inst.kind, +1)
                    else:
                        slot.value = value if sparse else self._resident_add(slot.value, deltas.row(j))
                        slot.interval = Interval.merged(slot.interval, interval)
                        slot.rows += rows
                        self._resident.move_to_end(key)
                    slot.last_used = time.monotonic()
                    self._resident_stats["merged_rows"] += rows
                    merged.add(key)
            except BaseException as e:
                # a merged prefix stays on the card: report exactly which
                # keys landed, so the caller flushes only the rest
                raise ResidentMergeError(frozenset(merged), e) from e
            self._resident_stats["merges"] += 1
            while resident_bytes_total() > self.RESIDENT_MAX_BYTES and self._resident:
                _, slot = self._resident.popitem(last=False)
                _resident_bytes_add(-slot.nbytes, self.inst.kind, -1)
                evicted.append(slot)
                self._resident_stats["evictions"] += 1
            if not evicted:
                return []
            try:
                return self._fetch_slots_locked(evicted)
            except Exception:
                for slot in evicted:  # eviction must not lose state
                    self._resident[slot.key] = slot
                    _resident_bytes_add(slot.nbytes, self.inst.kind, +1)
                # the deltas all merged: raising would send the caller's
                # merge-failed recovery after rows already on the card
                # (counted twice). The eviction waits for the next merge
                # or flush pass.
                self._resident_stats["eviction_deferred"] += 1
                log.warning("resident eviction fetch failed for %s; eviction deferred", self.inst.kind,
                            exc_info=True)
                return []

    def resident_take(self, keys=None) -> list[dict]:
        """Pop all (or `keys`) resident slots and fetch their shares for a
        flush. On a fetch failure every popped slot is restored and the
        error propagates: resident state is never dropped. A quarantined
        engine still takes (the quarantine flush), unless a quarantine
        fetch hung already: then the slots wait for the canary's restore."""
        if self._quarantine_fetch_hung:
            self.check_available("resident_take")
        with self._resident_lock:
            take = list(self._resident.keys()) if keys is None else [k for k in keys if k in self._resident]
            slots = [self._resident.pop(k) for k in take]
            for slot in slots:
                _resident_bytes_add(-slot.nbytes, self.inst.kind, -1)
            if not slots:
                return []
            try:
                recs = self._fetch_slots_locked(slots)
            except BaseException:
                for slot in slots:
                    self._resident[slot.key] = slot
                    _resident_bytes_add(slot.nbytes, self.inst.kind, +1)
                raise
            self._resident_stats["takes"] += len(slots)
            return recs

    def fetch_delta_records(self, entries, deltas) -> list[dict]:
        """A job's raw delta rows as flush records: the driver's recovery
        when a merge failed after the commit. A sparse job's rows scatter
        into a zero dense row first (a flush record is always dense)."""
        tf = self.p3.tf
        sparse = isinstance(deltas, SparsePendingDeltas)

        def fetch():
            out = []
            for key, j, rows, interval in entries:
                value = self._sparse_slot_value(None, deltas, j) if sparse else deltas.row(j)
                out.append({"key": key, "share": _value_ints(tf, value), "rows": rows, "interval": interval})
            count_d2h(deltas.row_nbytes * len(entries))
            return out

        return self._fetch("resident_delta_fetch", fetch)

    def _fetch_slots_locked(self, slots: list) -> list[dict]:
        """Fetch popped slots' shares (callers hold _resident_lock)."""
        tf = self.p3.tf

        def fetch():
            recs = [
                {"key": s.key, "share": _value_ints(tf, s.value), "rows": s.rows, "interval": s.interval}
                for s in slots
            ]
            count_d2h(sum(s.nbytes for s in slots))
            return recs

        return self._fetch("resident_fetch", fetch)

    def has_resident(self) -> bool:
        """True while unflushed slots live on this engine: the process LRU
        must not evict it (the flush walks cached engines only)."""
        with self._resident_lock:
            return bool(self._resident)

    def resident_status(self) -> dict:
        with self._resident_lock:
            out = {
                "vdaf": self.inst.kind,
                "buffers": len(self._resident),
                "bytes": sum(s.nbytes for s in self._resident.values()),
                **dict(self._resident_stats),
            }
            if self.sparse:
                circ = self.p3.circ
                out["sparse"] = {
                    "logical_length": circ.agg_output_len,
                    "block_size": circ.block_size,
                    "max_blocks": circ.max_blocks,
                    "scatter_rows": self._scatter_rows_total,
                    "block_occupancy": self._sparse_last_occupancy,
                }
            return out


# LRU over live engines, keyed by (instance, verify key, devices).
_ENGINE_CACHE_MAX = 256
_engine_cache_lock = threading.Lock()
_engine_cache: "OrderedDict[tuple, EngineCache]" = OrderedDict()


def engine_cache(inst: VdafInstance, verify_key: bytes, device=None, devices=None) -> EngineCache:
    """The process-wide engine of (inst, verify_key, devices): CUDA unless
    the caller passes "cpu"; several devices (`devices=`) serve on a
    mesh. A draft circuit
    the port's draft engine refuses raises ValueError; there is no host
    engine to fall back to."""
    devs = tuple(resolve_device(d) for d in devices or (device,))
    key = (inst, verify_key, devs)
    with _engine_cache_lock:
        eng = _engine_cache.get(key)
        if eng is not None:
            _engine_cache.move_to_end(key)
            metrics.engine_cache_hits.add()
            return eng
    metrics.engine_cache_misses.add()
    # build outside the lock; a concurrent double build keeps the first
    eng = EngineCache(inst, verify_key, devices=devs)
    with _engine_cache_lock:
        cur = _engine_cache.get(key)
        if cur is not None:
            return cur
        _engine_cache[key] = eng
        while len(_engine_cache) > _ENGINE_CACHE_MAX:
            # evict the oldest engine that holds no resident state: the
            # flush walks cached engines only, so dropping one with live
            # slots would lose their shares and leak their ledger bytes
            victim = next((k for k, e in _engine_cache.items() if not e.has_resident()), None)
            if victim is None:
                # every engine holds unflushed state (bounded by
                # RESIDENT_MAX_BYTES): keep them until a flush drains one
                break
            _engine_cache.pop(victim)
        metrics.engine_cache_entries.set(float(len(_engine_cache)))
    return eng


def mesh_status() -> dict:
    """The statusz `mesh` section: the dispatch lane's counters and each
    cached engine's geometry. The device count reads CUDA's only where
    CUDA is up already (a statusz read must not initialize it)."""
    with _engine_cache_lock:
        engines = list(_engine_cache.values())
    return {
        "devices": torch.cuda.device_count() if torch.cuda.is_initialized() else None,
        "queue": _MESH_QUEUE.status(),
        "engines": [{"vdaf": e.inst.kind, **e.mesh_status()} for e in engines],
    }


def live_engines() -> list[EngineCache]:
    """The engines in the process cache, oldest first: the resident
    flush and drain walk these."""
    with _engine_cache_lock:
        return list(_engine_cache.values())


def shutdown_engines(timeout_s: float = 2.0) -> None:
    """Process teardown: stop every live engine's canary loop (bounded) so
    that no probe's device work races interpreter finalization. janus_main
    calls it before the watchdog drain."""
    for eng in live_engines():
        try:
            eng.stop_canary(timeout_s)
        except Exception:
            log.exception("stopping canary for %s failed", eng.inst.kind)


def _engine_cache_clear() -> None:
    """Drop every cached engine, the shared coalescers and the resident
    ledger (tests clear between modules)."""
    global _resident_bytes_total
    with _engine_cache_lock:
        _engine_cache.clear()
    _clear_shared_coalescers()
    _MESH_QUEUE.reset_for_tests()
    with _resident_bytes_lock:
        _resident_bytes_total = 0
        kinds = list(_resident_buffer_counts)
        _resident_buffer_counts.clear()
    metrics.engine_resident_bytes.set(0.0)
    for kind in kinds:
        metrics.engine_resident_buffers.set(0.0, vdaf=kind)
    metrics.engine_cache_entries.set(0.0)


engine_cache.cache_clear = _engine_cache_clear


def engine_cache_status() -> dict:
    """The statusz `engine_cache` section: per-engine bucket cap, backend
    state, geometry, quarantine counters and recent OOM history."""
    with _engine_cache_lock:
        engines = list(_engine_cache.values())
    out = []
    for eng in engines:
        out.append({
            **eng.engine_status(),
            "xof_mode": eng.inst.xof_mode,
            "initial_bucket_cap": eng._initial_bucket_cap,
            "coalesce_round_rows": eng._co_leader._max_rows,
            "resident": eng.resident_status(),
            "oom_history": list(eng.oom_history),
        })
    return {"entries": len(engines), "max_entries": _ENGINE_CACHE_MAX, "engines": out}


def resident_accumulators_status() -> dict:
    """The statusz `resident_accumulators` section: the process's resident
    bytes beside the cap, the sparse engines' scatter rollup, and every
    engine's slots and counters."""
    engines = live_engines()
    return {
        "total_bytes": resident_bytes_total(),
        "max_bytes": EngineCache.RESIDENT_MAX_BYTES,
        # always on: merged rounds carry each lane's verify key, and the
        # config refuses `cross_task_coalesce: false`
        "cross_task_coalesce": True,
        "sparse": {
            "engines": sum(1 for e in engines if e.sparse),
            "scatter_rows": sum(e._scatter_rows_total for e in engines),
        },
        "engines": [eng.resident_status() for eng in engines],
    }


from ..statusz import register_status_provider as _register_status_provider  # noqa: E402

_register_status_provider("engine_cache", engine_cache_status)
_register_status_provider("resident_accumulators", resident_accumulators_status)
_register_status_provider("mesh", mesh_status)
