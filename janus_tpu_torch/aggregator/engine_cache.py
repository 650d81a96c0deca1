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

One engine may serve several threads at once: in one process the
helper's handler threads and the leader's job-driver workers share it
(the process LRU keys it by VDAF and verify key, which both roles
hold). Its only mutable state, the OOM ladder's cap and history, changes
under `_oom_lock`, and each call reads the cap once; the pipelined route
makes its side stream and events per call and waits on them from the
calling thread's current stream; the kernels count their launches under
a lock (ops/cuda_build.py `count_launch`).

The engine runs on CUDA unless it is built with device="cpu", where the
kernels' plain versions run. Values equal janus_tpu's EngineCache on
the same inputs. Not ported yet: cross-job coalescing, prestaged leader
columns, resident accumulators (with them the sparse pending deltas),
the mesh, the dispatch watchdog with its quarantine and canary, and the
compile caches (the port runs eagerly and compiles nothing).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from ..convert import from_numpy_u64, to_numpy_u64
from ..device import resolve_device
from ..fields.tfield import fzeros
from ..vdaf.circuits import SparseSumVec
from ..vdaf.feasibility import device_memory_budget, feasible_bucket
from ..vdaf.registry import VdafInstance, prio3_batched

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


class DeviceRows:
    """Out-share field value living on the device, padded to its bucket.

    `EngineCache.aggregate` reads it where it lies; `to_numpy()` fetches
    the true rows as uint64 limb arrays, bit-identical to JAX's. `offset`
    views rows [offset, offset + n) of a shared buffer."""

    __slots__ = ("value", "n", "offset")

    def __init__(self, value, n: int, offset: int = 0):
        self.value = value  # tuple of [bucket, len] int64 limb tensors
        self.n = n  # true batch size (rows beyond n are padding)
        self.offset = offset

    def to_numpy(self):
        return tuple(to_numpy_u64(x[self.offset : self.offset + self.n]) for x in self.value)


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


class EngineCache:
    """Per (VDAF, verify key, device) Prio3 steps over bucketed batches.

    device: CUDA unless the caller passes "cpu". bucket_cap: None takes
    the memory model's cap (None on the CPU, uncapped); a positive value
    overrides it, rounded down to a power of two; 0 means uncapped."""

    # Leader batches of at least 2 x PIPELINE_CHUNK rows run pipelined.
    PIPELINE_CHUNK = 256

    def __init__(self, inst: VdafInstance, verify_key: bytes, device=None, bucket_cap: int | None = None):
        self.inst = inst
        self.verify_key = verify_key
        self.p3 = prio3_batched(inst, device)
        self.device = self.p3.device
        if bucket_cap is not None:
            self.bucket_cap = (1 << (bucket_cap.bit_length() - 1)) if bucket_cap > 0 else None
        else:
            # the tiled model where the query streams (the tile, not
            # input_len, sizes its working set)
            plan = self.p3.plan
            self.bucket_cap = feasible_bucket(
                self.p3.circ,
                device_memory_budget(self.device),
                tile_elems=plan.group if plan is not None else None,
                draft=inst.xof_mode != "fast",
            )
        self._oom_lock = threading.Lock()
        self.oom_history: deque = deque(maxlen=16)
        # block-sparse SumVec: aggregates scatter to the logical length
        self.sparse = isinstance(self.p3.circ, SparseSumVec)

    def _dispatch(self, name: str, fn, *args):
        """Run one step on staged device tensors: the one place a device
        computation starts (and where a test injects a failure)."""
        return fn(*args)

    # --- memory-exhaustion ladder (shared by every public step) ---
    def _handle_engine_error(self, e: BaseException, n: int) -> None:
        """Called from an except block. Re-raises anything but memory
        exhaustion unchanged; otherwise frees the allocator's cache and
        halves the bucket cap, so the caller's retry chunks smaller. At
        the floor, or where halving cannot shrink the dispatch, it
        re-raises: the port has no host engine to move to."""
        if not is_oom_error(e):
            raise
        with self._oom_lock:
            # one exception object may reach several retry loops; only
            # the first may touch the cap
            if getattr(e, "_janus_oom_handled", False):
                return
            e._janus_oom_handled = True
            observed = getattr(e, "_janus_dispatch_bucket", None)
            if observed is None:
                observed = bucket_size(n, self.bucket_cap)
            stuck = (
                getattr(e, "_janus_fixed_bucket", False)
                and self.bucket_cap is not None
                and observed // 2 >= self.bucket_cap
            )
            if observed <= 1 or stuck:
                self.oom_history.append(
                    {"at": time.time(), "bucket": observed, "action": "raised", "error": str(e)[:200]}
                )
                raise
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            new_cap = observed // 2
            self.bucket_cap = new_cap if self.bucket_cap is None else min(self.bucket_cap, new_cap)
            self.oom_history.append(
                {
                    "at": time.time(),
                    "bucket": observed,
                    "action": f"halved_to_{self.bucket_cap}",
                    "error": str(e)[:200],
                }
            )

    # --- helper side: init + combine + decide in one step ---
    def helper_init(self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask):
        """Returns (out1 DeviceRows, accept mask, prep_msg lanes), the
        last two as numpy sliced to the true batch size."""
        args = (nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask)
        while True:
            try:
                return self._helper_init_inner(*args)
            except Exception as e:  # noqa: BLE001 - memory filter inside
                self._handle_engine_error(e, nonce_lanes.shape[0])

    def _helper_init_chunked(self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask, cap: int):
        """Serial cap-sized dispatches for a batch past the memory bound;
        out shares stay on the device as DeviceRowsChunks."""
        n = nonce_lanes.shape[0]
        outs, masks, preps = [], [], []
        for s in range(0, n, cap):
            e = min(s + cap, n)
            out1, mask, prep = self._helper_init_inner(
                *(_cut_rows(a, s, e) for a in (nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask))
            )
            outs.append(out1)
            masks.append(mask)
            preps.append(prep)
        return DeviceRowsChunks(outs), np.concatenate(masks), np.concatenate(preps)

    def _helper_init_inner(self, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask):
        p3 = self.p3
        n = nonce_lanes.shape[0]
        cap = self.bucket_cap  # read once: recovery may halve it meanwhile
        if cap is not None and n > cap:
            return self._helper_init_chunked(
                nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask, cap
            )
        b = bucket_size(n, cap)

        def step(nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask):
            out1, seed1, ver1, part1 = p3.prepare_init_helper(
                self.verify_key, nonce_lanes, public_parts, helper_seeds, blinds
            )
            mask, prep_msg = p3.prep_shares_to_prep(ver0, ver1, part0, part1)
            mask = p3.prepare_finish(seed1, prep_msg, mask)
            mask = mask & ok_mask
            if prep_msg is None:
                prep_msg = torch.zeros((nonce_lanes.shape[0], 2), dtype=torch.int64, device=self.device)
            return out1, mask, prep_msg

        try:
            staged = put_args(pad_args(b, nonce_lanes, public_parts, helper_seeds, blinds, ver0, part0, ok_mask), self.device)
            out1, mask, prep_msg = self._dispatch("helper_init", step, *staged)
            # out1 stays on the device; the mask and prep message come
            # back (the .cpu() blocks until the step has run)
            mask = mask[:n].cpu().numpy()
            prep_msg = _fetch_rows(prep_msg, n)
        except Exception as e:
            _annotate_dispatch_bucket(e, b)
            raise
        return DeviceRows(out1, n), mask, prep_msg

    # --- leader side: init only (the helper round trip follows) ---
    def leader_init(self, nonce_lanes, public_parts, meas, proof, blind0, ok=None):
        """Returns (out0 DeviceRows or DeviceRowsChunks, corrected seed
        lanes or None, verifier share limbs, own joint-rand part lanes or
        None), the last three as numpy. `ok` is accepted for interface
        parity with janus_tpu; failed lanes cost nothing extra here."""
        while True:
            try:
                return self._leader_init_inner(nonce_lanes, public_parts, meas, proof, blind0)
            except Exception as e:  # noqa: BLE001 - memory filter inside
                self._handle_engine_error(e, nonce_lanes.shape[0])

    def _leader_step(self, nonce_lanes, public_parts, meas, proof, blind0):
        return self.p3.prepare_init_leader(self.verify_key, nonce_lanes, public_parts, meas, proof, blind0)

    def _leader_init_inner(self, nonce_lanes, public_parts, meas, proof, blind0, allow_pipeline: bool = True):
        n = nonce_lanes.shape[0]
        cap = self.bucket_cap
        if cap is not None and n > cap:
            return self._leader_init_chunked(nonce_lanes, public_parts, meas, proof, blind0, cap)
        if allow_pipeline and n >= 2 * self.PIPELINE_CHUNK:
            return self._leader_init_pipelined(nonce_lanes, public_parts, meas, proof, blind0)
        b = bucket_size(n, cap)
        try:
            staged = put_args(pad_args(b, nonce_lanes, public_parts, meas, proof, blind0), self.device)
            out0, seed0, ver0, part0 = self._dispatch("leader_init", self._leader_step, *staged)
            seed0 = _fetch_rows(seed0, n) if seed0 is not None else None
            ver0 = tuple(_fetch_rows(x, n) for x in ver0)
            part0 = _fetch_rows(part0, n) if part0 is not None else None
        except Exception as e:
            _annotate_dispatch_bucket(e, b)
            raise
        return DeviceRows(out0, n), seed0, ver0, part0

    @staticmethod
    def _merge_leader_chunks(outs, seeds, vers, parts):
        seed = np.concatenate(seeds) if seeds[0] is not None else None
        ver = tuple(np.concatenate([v[i] for v in vers]) for i in range(len(vers[0])))
        part = np.concatenate(parts) if parts[0] is not None else None
        return DeviceRowsChunks(outs), seed, ver, part

    def _leader_init_chunked(self, nonce_lanes, public_parts, meas, proof, blind0, cap: int):
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
        try:
            staged, ready = [], []
            for s, e in spans:
                args = pad_args(
                    bucket_size(e - s),
                    *(_cut_rows(a, s, e) for a in (nonce_lanes, public_parts, meas, proof, blind0)),
                )
                staged.append(put_args(args, self.device, stream=copy_stream))
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(copy_stream)
                    ready.append(ev)
            results = []
            for k, args in enumerate(staged):
                if cuda:
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(ready[k])
                    # tensors made on the copy stream are read on this
                    # one: the allocator must not reuse them early
                    _map_args(lambda t: t.record_stream(compute), args)
                results.append(self._dispatch("leader_init", self._leader_step, *args))
            outs, seeds, vers, parts = [], [], [], []
            for (s, e), (out0, seed0, ver0, part0) in zip(spans, results):
                outs.append(DeviceRows(out0, e - s))
                seeds.append(_fetch_rows(seed0, e - s) if seed0 is not None else None)
                vers.append(tuple(_fetch_rows(x, e - s) for x in ver0))
                parts.append(_fetch_rows(part0, e - s) if part0 is not None else None)
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
        if isinstance(out_shares, DeviceRowsChunks):
            # per-chunk masked reduce, merged mod p on the host
            offs = np.cumsum([0] + [c.n for c in out_shares.chunks])
            return self._merge_partials(
                self._aggregate_inner(c, mask[offs[i] : offs[i + 1]]) for i, c in enumerate(out_shares.chunks)
            )
        if isinstance(out_shares, DeviceRows):
            # resident rows: only the mask moves; the reduce reads the
            # job's own rows of the buffer in place
            n, s = out_shares.n, out_shares.offset
            dispatch_b, fixed = out_shares.value[0].shape[0], True
            args = (tuple(x[s : s + n] for x in out_shares.value), torch.from_numpy(mask.copy()).to(self.device))
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
            if args is None:
                args = put_args(pad_args(dispatch_b, out_shares, mask), self.device)
            agg = self._dispatch("aggregate", p3.aggregate, *args)
            return [int(x) for x in p3.tf.to_ints(agg)]
        except Exception as e:
            _annotate_dispatch_bucket(e, dispatch_b, fixed=fixed)
            raise

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
        L = self.p3.circ.agg_output_len
        accept = np.asarray(mask, dtype=bool)
        idx = np.where(accept[:, None], np.asarray(flat_idx, dtype=np.int32), np.int32(L)).astype(np.int32)
        while True:
            try:
                acc = self._scatter_dispatch(self._zeros_row(L), out_shares, idx)
                return [int(x) for x in self.p3.tf.to_ints(acc)]
            except Exception as e:  # noqa: BLE001 - memory filter inside
                self._handle_engine_error(e, idx.shape[0])

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
                idx_t = torch.from_numpy(np.ascontiguousarray(idx[lo - s : hi - s])).to(self.device)
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
        (padded,) = put_args(pad_args(b, out_shares), self.device)
        full = np.full((b, idx.shape[1]), np.int32(L), np.int32)
        full[:n] = idx
        return self._scatter_rows(acc, padded, full, 0, b)


# LRU over live engines, keyed by (instance, verify key, device).
_ENGINE_CACHE_MAX = 256
_engine_cache_lock = threading.Lock()
_engine_cache: "OrderedDict[tuple, EngineCache]" = OrderedDict()


def engine_cache(inst: VdafInstance, verify_key: bytes, device=None) -> EngineCache:
    """The process-wide engine of (inst, verify_key, device): CUDA unless
    the caller passes "cpu". A draft circuit the port's draft engine
    refuses raises ValueError; there is no host engine to fall back to."""
    key = (inst, verify_key, resolve_device(device))
    with _engine_cache_lock:
        eng = _engine_cache.get(key)
        if eng is not None:
            _engine_cache.move_to_end(key)
            return eng
    # build outside the lock; a concurrent double build keeps the first
    eng = EngineCache(inst, verify_key, device=key[2])
    with _engine_cache_lock:
        cur = _engine_cache.get(key)
        if cur is not None:
            return cur
        _engine_cache[key] = eng
        while len(_engine_cache) > _ENGINE_CACHE_MAX:
            _engine_cache.popitem(last=False)
    return eng


def _engine_cache_clear() -> None:
    with _engine_cache_lock:
        _engine_cache.clear()


engine_cache.cache_clear = _engine_cache_clear
