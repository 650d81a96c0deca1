"""Engine prewarm from the persisted shape manifest.

`prewarm_engines` replays the shape manifest (shape_manifest.py) against
the provisioned tasks at boot: every recorded dispatch specialization,
(vdaf, op, bucket, variant), is dispatched once with synthetic rows of
exactly that geometry, so its cold first call (PyTorch's lazy CUDA
module loading for the step's eager ops, the caching allocator's first
segments at the bucket, the first float64 `bmm`'s cuBLAS handle) is paid
BEFORE /readyz reports ready, and the first served dispatch at a
recorded key books `execute`, not `compile`, in the device-cost ledger.
Entries are warmed highest recorded cost first within a boot budget; an
entry whose recorded cost alone is over twice the budget is deferred at
once; the remainder warms on a daemon thread (`engine-warmup-bg`, role
`engine_warm` in the profiler's taxonomy), so one pathological manifest
delays readiness by at most the budget.

The same warmer serves the quarantine canary (engine_cache._canary_loop):
after a restore the engine's recorded specializations are replayed from
the manifest in the canary thread.

A warm runs on the engine's own device through the engine's own entry
points: a device error counts `failed` and is logged, and nothing moves
to the CPU.

Observability: `janus_engine_prewarm_total{outcome}` (`warmed`,
`failed`, `unsupported`, `no_task`, `deferred`, `geometry_mismatch`;
the boot warmup adds `skipped_covered`), `janus_engine_prewarm_seconds`,
and the /statusz `engine_prewarm` section with janus_tpu's keys
`compile_cache`, `aot`, `manifest` and `prewarm`.

The port's own copy of janus_tpu/aggregator/prewarm.py. Where it
differs: the `compile_cache` slice is the directory that arms the
kernel-library cache (aot_cache.py), not an XLA compile cache; a warm is
a cache hit when this process built no kernel library (every library it
runs came from the disk cache) and a miss when it built one, where
janus_tpu reads its AOT executable loads and saves around each warm; the
`aot` slice adds `dir`, `nvcc_s` and the libraries' `blob_bytes`; there
is no host engine, so no entry is `unsupported` for being on the host.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from .. import metrics
from ..statusz import register_status_provider
from . import aot_cache, shape_manifest

log = logging.getLogger(__name__)

DEFAULT_BOOT_BUDGET_S = 30.0
OUTCOMES = ("warmed", "failed", "unsupported", "no_task", "deferred", "geometry_mismatch")

# module state behind the /statusz `engine_prewarm` section; always
# well-formed, even in a process that never prewarms
_state_lock = threading.Lock()
_STATE: dict = {
    "state": "idle",  # idle | running | ready | done
    "warmed": 0,
    "cache_hits": 0,
    "cache_misses": 0,
    "failed": 0,
    "unsupported": 0,
    "no_task": 0,
    "deferred": 0,
    "geometry_mismatch": 0,
    "boot_budget_s": None,
    "priority_elapsed_s": None,
}
_COMPILE_CACHE: dict = {"enabled": False, "dir": None}


def note_compile_cache(cache_dir: str | None) -> None:
    """Record the configured compile cache directory (the one that arms
    the kernel-library cache) for the statusz section."""
    with _state_lock:
        _COMPILE_CACHE["enabled"] = cache_dir is not None
        _COMPILE_CACHE["dir"] = cache_dir


def _cache_dir_stats() -> tuple[int, int]:
    """(files, bytes) at the top of the compile cache dir (0, 0 when
    unknown)."""
    d = _COMPILE_CACHE.get("dir")
    if not d:
        return 0, 0
    files = total = 0
    try:
        with os.scandir(os.path.expanduser(d)) as it:
            for ent in it:
                try:
                    if ent.is_file():
                        files += 1
                        total += ent.stat().st_size
                except OSError:
                    continue
    except OSError:
        return 0, 0
    return files, total


def _bump(outcome: str, n: int = 1) -> None:
    metrics.engine_prewarm_total.add(n, outcome=outcome)
    if outcome in OUTCOMES:
        with _state_lock:
            _STATE[outcome] = _STATE.get(outcome, 0) + n


def engine_prewarm_status() -> dict:
    """The /statusz `engine_prewarm` section: the compile cache directory,
    the kernel-library cache, the manifest inventory and the prewarm's
    outcome counts."""
    files, nbytes = _cache_dir_stats()
    with _state_lock:
        state = dict(_STATE)
        cache = dict(_COMPILE_CACHE)
    cache["files"] = files
    cache["bytes"] = nbytes
    return {
        "compile_cache": cache,
        "aot": aot_cache.status(),
        "manifest": shape_manifest.manifest_status(),
        "prewarm": state,
    }


register_status_provider("engine_prewarm", engine_prewarm_status)


def reset_for_tests() -> None:
    with _state_lock:
        _STATE.update(state="idle", warmed=0, cache_hits=0, cache_misses=0, failed=0, unsupported=0, no_task=0,
                      deferred=0, geometry_mismatch=0, boot_budget_s=None, priority_elapsed_s=None)
        _COMPILE_CACHE.update(enabled=False, dir=None)


# ---------------------------------------------------------------------------
# Warming one recorded specialization, through the ENGINE's own entry
# points, so the dispatch is the one serving traffic makes and feeds the
# same cost ledger and manifest choke point.
# ---------------------------------------------------------------------------


def _tile_rows(a, n: int):
    """Repeat a 1-row staged arg (tensor, field-limb tuple, None) to n
    rows along the leading (report) axis."""
    if a is None or isinstance(a, (bytes, int)):
        return a
    if isinstance(a, tuple):
        return tuple(_tile_rows(x, n) for x in a)
    return a.repeat((n,) + (1,) * (a.dim() - 1))


class _Warmer:
    """Per-run context: shards ONE synthetic report per engine on its
    device and tiles it to each target row count. A step's shapes, never
    its values, make a specialization, so a repeated row warms what n
    distinct reports would, without n host shardings. Leader-init outputs
    are cached per (engine, rows), so helper and aggregate entries reuse
    the leader leg."""

    def __init__(self):
        self._base: dict[int, tuple] = {}
        self._batches: dict[tuple, tuple] = {}

    def _rows_for_bucket(self, bucket: int) -> int:
        # the smallest n whose bucket is `bucket`: the fewest staged bytes
        return bucket // 2 + 1

    def _batch(self, eng, n: int):
        import numpy as np

        from ..vdaf.testing import make_report_batch, random_measurements

        key = (id(eng), n)
        got = self._batches.get(key)
        if got is None:
            base = self._base.get(id(eng))
            if base is None:
                rng = np.random.default_rng(0xC01D)
                base, _ = make_report_batch(eng.inst, random_measurements(eng.inst, 1, rng), seed=0xC01D,
                                            device=eng.device)
                self._base[id(eng)] = base
            got = self._batches[key] = (tuple(_tile_rows(a, n) for a in base), {})
        return got

    def _leader_out(self, eng, n: int):
        """leader_init outputs at n rows (cached per engine and n)."""
        args, cache = self._batch(eng, n)
        if "leader" not in cache:
            nonce, parts, meas, proof, blind0, _, _ = args
            cache["leader"] = eng._leader_init_inner(nonce, parts, meas, proof, blind0, allow_pipeline=False)
        return args, cache["leader"]

    def warm(self, eng, entry: dict) -> str:
        """Warm one manifest entry on `eng`; returns the outcome."""
        import numpy as np

        from .engine_cache import MIN_BUCKET, DeviceRows, bucket_size

        key = [str(k) if not isinstance(k, (int, float)) else k for k in entry.get("key") or ()]
        # a specialization recorded under another mesh topology is another
        # program: replaying it here would warm what serving never runs
        current = (eng.dp, eng.sp, len(eng._devices)) if eng.mesh is not None else None
        if shape_manifest.entry_geometry(key) != current:
            return "geometry_mismatch"
        variant = str(key[0]) if key else str(entry.get("op", ""))
        bucket = int(entry.get("bucket", 0))
        if bucket < max(MIN_BUCKET, eng.dp) or (eng.bucket_cap is not None and bucket > eng.bucket_cap):
            return "unsupported"
        n = self._rows_for_bucket(bucket)
        vk_lanes = None
        if variant.endswith("_vk"):
            vk_lanes = np.ascontiguousarray(
                np.broadcast_to(np.frombuffer(eng.verify_key, dtype="<u8").astype(np.uint64), (n, 2))
            )
        if variant in ("leader_init", "leader_init_vk"):
            args, _ = self._batch(eng, n)
            nonce, parts, meas, proof, blind0, _, _ = args
            eng._leader_init_inner(nonce, parts, meas, proof, blind0, allow_pipeline=False, vk_lanes=vk_lanes)
            return "warmed"
        if variant in ("helper_init", "helper_init_vk"):
            args, (_, _, ver0, part0) = self._leader_out(eng, n)
            nonce, parts, _, _, _, hseed, blind1 = args
            eng._helper_init_inner(nonce, parts, hseed, blind1, ver0, part0, np.ones(n, dtype=bool),
                                   vk_lanes=vk_lanes)
            return "warmed"
        if variant == "aggregate":
            _, (out0, _, _, _) = self._leader_out(eng, n)
            eng.aggregate(out0, np.ones(n, dtype=bool))
            return "warmed"
        if variant.startswith("aggregate_view_"):
            try:
                vb = int(variant.rsplit("_", 1)[1])
            except ValueError:
                return "unsupported"
            if vb < MIN_BUCKET or bucket_size(vb) != vb:
                return "unsupported"
            # a view reads a buffer WIDER than its own bucket: a leader
            # init at 2 vb rows' bucket, aggregated through a vb-row view
            _, (out_big, _, _, _) = self._leader_out(eng, self._rows_for_bucket(2 * vb))
            if not isinstance(out_big, DeviceRows):
                return "unsupported"
            view = DeviceRows(out_big.value, min(vb, out_big.n), offset=0, engine=eng)
            eng.aggregate(view, np.ones(view.n, dtype=bool))
            return "warmed"
        if variant == "aggregate_pending":
            kk = max(1, int(key[1]) if len(key) > 1 else 1)
            _, (out0, _, _, _) = self._leader_out(eng, n)
            eng.aggregate_pending(out0, (np.arange(n, dtype=np.int32) % kk).astype(np.int32), kk)
            return "warmed"
        if variant == "scatter_merge":
            # the block-sparse scatter-add into the logical accumulator
            # (kernel 4), every compact lane live
            if not eng.sparse:
                return "unsupported"
            cm = eng.p3.circ.output_len
            _, (out0, _, _, _) = self._leader_out(eng, n)
            eng.aggregate_sparse(out0, np.ones(n, dtype=bool), np.tile(np.arange(cm, dtype=np.int32), (n, 1)))
            return "warmed"
        return "unsupported"


def _vdaf_key(d: dict) -> str:
    return json.dumps(dict(d), sort_keys=True, separators=(",", ":"))


def _warm_one(warmer: _Warmer, eng, entry: dict) -> str:
    t0 = time.monotonic()
    try:
        outcome = warmer.warm(eng, entry)
    except Exception:
        log.warning("prewarm of %s failed", entry.get("key"), exc_info=True)
        outcome = "failed"
    elapsed = time.monotonic() - t0
    if outcome == "warmed":
        metrics.engine_prewarm_seconds.observe(elapsed)
        # hit: every kernel library this process runs came from the disk
        # cache; miss: this process built one (a cold kernel-library cache)
        with _state_lock:
            _STATE["cache_misses" if aot_cache.stats()["saves"] else "cache_hits"] += 1
    _bump(outcome)
    return outcome


def prewarm_engines(
    ds,
    manifest: "shape_manifest.ShapeManifest | None" = None,
    boot_budget_s: float = DEFAULT_BOOT_BUDGET_S,
    ready_event: "threading.Event | None" = None,
    background_remainder: bool = True,
    devices=None,
) -> dict:
    """Replay the shape manifest against the provisioned tasks' engines on
    `devices` (None: CUDA), as `warmup_engines` does.

    Warms entries highest recorded cost first until `boot_budget_s` of
    wall time is spent; the remainder (counted `deferred`) continues on a
    daemon thread unless `background_remainder` is False. Returns a
    summary ({"entries", "warmed", "deferred", "priority_elapsed_s"}).
    `ready_event` is set the moment the priority set is warm."""
    from .engine_cache import engine_cache

    manifest = manifest if manifest is not None else shape_manifest.installed()
    t0 = time.monotonic()
    entries = manifest.entries() if manifest is not None else []
    summary: dict = {"entries": len(entries), "warmed": 0, "deferred": 0}
    with _state_lock:
        _STATE["state"] = "running" if entries else "done"
        _STATE["boot_budget_s"] = boot_budget_s
    if not entries:
        if ready_event is not None:
            ready_event.set()
        with _state_lock:
            _STATE["priority_elapsed_s"] = 0.0
        summary["priority_elapsed_s"] = 0.0
        return summary

    tasks = ds.run_tx(lambda tx: tx.get_tasks(), "prewarm_list_tasks")
    by_vdaf: dict[str, list] = {}
    for task in tasks:
        if task.vdaf.kind.startswith("fake") or task.vdaf.kind == "poplar1":
            continue
        by_vdaf.setdefault(_vdaf_key(task.vdaf.to_dict()), []).append(task)

    jobs: list[tuple[dict, object]] = []
    for entry in entries:
        matched = by_vdaf.get(_vdaf_key(entry.get("vdaf") or {}))
        if not matched:
            _bump("no_task")
            continue
        jobs.extend((entry, task) for task in matched)

    def engine_of(task):
        return engine_cache(task.vdaf, task.vdaf_verify_key, devices=devices)

    warmer = _Warmer()
    remainder: list[tuple[dict, object]] = []
    deferred_oversize: list[tuple[dict, object]] = []
    for i, (entry, task) in enumerate(jobs):
        if time.monotonic() - t0 > boot_budget_s:
            remainder = jobs[i:]
            break
        # an entry whose recorded cold cost alone dwarfs the budget defers
        # at once: a first call cannot be preempted, so starting it would
        # hold readiness far past the bound. Otherwise the overshoot is at
        # most one specialization's warm
        if float(entry.get("cost_s", 0.0)) > 2.0 * boot_budget_s:
            deferred_oversize.append((entry, task))
            continue
        if _warm_one(warmer, engine_of(task), entry) == "warmed":
            summary["warmed"] += 1
    remainder = deferred_oversize + remainder
    elapsed = time.monotonic() - t0
    summary["priority_elapsed_s"] = round(elapsed, 3)
    summary["deferred"] = len(remainder)
    with _state_lock:
        _STATE["state"] = "ready"
        _STATE["priority_elapsed_s"] = round(elapsed, 3)
    if ready_event is not None:
        ready_event.set()
    if remainder:
        _bump("deferred", len(remainder))
        log.info("engine prewarm: %d specialization(s) warmed in %.1fs; %d deferred past the %.1fs boot budget "
                 "to the background warmer", summary["warmed"], elapsed, len(remainder), boot_budget_s)
        if background_remainder:

            def _drain():
                w = _Warmer()
                for entry, task in remainder:
                    try:
                        _warm_one(w, engine_of(task), entry)
                    except Exception:
                        log.warning("background prewarm failed", exc_info=True)
                with _state_lock:
                    _STATE["state"] = "done"

            threading.Thread(target=_drain, name="engine-warmup-bg", daemon=True).start()
    else:
        with _state_lock:
            _STATE["state"] = "done"
        log.info("engine prewarm: %d specialization(s) warmed in %.1fs (budget %.1fs)", summary["warmed"],
                 elapsed, boot_budget_s)
    return summary


def warm_engine_from_manifest(eng, budget_s: float = 60.0, should_stop=None) -> int:
    """Re-warm ONE engine's recorded specializations (the quarantine
    canary's restore path). `should_stop` is checked between entries, so
    process teardown can end the loop (a daemon thread dispatching device
    work while the interpreter finalizes can crash in native code).
    Returns the warmed count."""
    manifest = shape_manifest.installed()
    if manifest is None:
        return 0
    want = _vdaf_key(eng.inst.to_dict())
    warmer = _Warmer()
    warmed = 0
    t0 = time.monotonic()
    for entry in manifest.entries():
        if should_stop is not None and should_stop():
            break
        if _vdaf_key(entry.get("vdaf") or {}) != want:
            continue
        if time.monotonic() - t0 > budget_s:
            break
        if _warm_one(warmer, eng, entry) == "warmed":
            warmed += 1
    return warmed
