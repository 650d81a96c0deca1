"""Always-on continuous profiling: the port's own copy of
janus_tpu/profiler.py.

Three coordinated parts, all low-overhead enough to run in every
production binary:

  1. **Sampling wall-clock profiler** (`SamplingProfiler`): a daemon
     thread samples `sys._current_frames()` at a configurable rate
     (default ~19 Hz — deliberately not a divisor of common 10/20/100 Hz
     timer periods, so periodic work doesn't alias into the samples),
     folds each thread's stack, tags it with the thread's *role*
     (derived from the thread names the subsystems assign at creation:
     device lane, prefetch, commit, HTTP handler, decrypt pool,
     flushers, SLO engine, ...) and aggregates into a bounded ring of
     fixed windows. Served as `GET /debug/profile` on every health
     listener in collapsed-stack (flamegraph.pl) format, with a JSON
     mode (`?format=json`) carrying per-role self/total percentages.
     The sampler measures its own cost and exports it
     (`janus_profiler_overhead_ratio`) — the overhead claim is a
     metric, not a promise.

  2. **Per-dispatch device cost ledger** (`DeviceCostLedger`): every
     supervised device region in the engine cache reports its wall time
     here, split by phase — `compile` (first call of an (op, bucket)),
     `execute` (dispatch), `h2d`/`d2h` (transfers) — keyed by
     (vdaf, op, bucket) with dispatch and row counts. The derived
     µs-per-report table (`janus_device_cost_us_per_report{op,phase}`)
     gives the device lane's busy ratio its denominator: what the busy
     time *buys* per report.

     On the card the port compiles nothing per shape: its `compile`
     row is the cold first call of an (op, bucket) key (PyTorch's lazy
     module loading, cuBLAS's first handle, allocator growth, the
     engine's first staging; the shape manifest records it and the
     prewarm pays it before ready), kept under janus_tpu's name so that
     rows, dispatches and keys mean the same in both packages. Launches are asynchronous: `execute` is the host
     time to enqueue a dispatch, and the queued kernels' time lands in
     the `d2h` phase of the fetch that waits for them, as in janus_tpu's
     `device_get`.

  3. **Boot-phase timeline** (`BootTimeline`): janus_main records named
     bring-up phases (imports → config → backend init → datastore →
     engine_warm_manifest (shape-manifest load) → engine_warm (the
     boot-budget AOT prewarm + legacy warmup) → listener up) as one
     contiguous sequence from the kernel-reported process start to
     /readyz-ready; served at `GET /debug/boot` and exported as
     `janus_boot_phase_seconds{phase}` so cold-start work (ROADMAP
     item 1) has a live baseline and a regression gate.

The frame/stack formatter here is shared with the device watchdog's
/statusz stalled-thread dumps, so the two renderings cannot diverge.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

from .exposition import validate_collapsed  # noqa: F401  (re-exported)
from .statusz import register_status_provider

# ---------------------------------------------------------------------------
# Shared frame formatting: ONE definition of "how a Python frame renders"
# for the folded stacks, the JSON top-frames table and the device
# watchdog's stalled-thread dumps.
# ---------------------------------------------------------------------------


def frame_label(frame, lineno: bool = False) -> str:
    """Compact `module.function` label for one frame (`:lineno` of the
    currently executing line when requested — the watchdog dumps want
    it, the folded aggregation deliberately does not, or near-identical
    stacks would shatter into per-line singletons)."""
    code = frame.f_code
    mod = frame.f_globals.get("__name__") or os.path.basename(code.co_filename)
    label = f"{mod}.{code.co_name}"
    if lineno:
        label += f":{frame.f_lineno}"
    return label


def format_stack(frame, limit: int = 48, lineno: bool = True) -> list[str]:
    """Outermost-first frame labels of a live frame chain (the shared
    rendering behind folded samples and the /statusz
    `device_watchdog.stalled` stack dumps)."""
    out: list[str] = []
    while frame is not None and len(out) < limit:
        out.append(frame_label(frame, lineno=lineno))
        frame = frame.f_back
    out.reverse()
    return out


def fold_component(s: str) -> str:
    """Sanitize one folded-stack component (a role, thread or frame
    name): the collapsed format is `frame;frame;... count` per line, so
    semicolons, whitespace and newlines INSIDE a component would corrupt
    the fold — a hostile thread name must render inert."""
    return "".join("_" if c in ";\n\r\t " or ord(c) < 0x20 else c for c in str(s)) or "_"


# ---------------------------------------------------------------------------
# Thread-role taxonomy: prefix match over the names the subsystems
# assign where their threads are created (docs/OBSERVABILITY.md carries
# the same table). First match wins — order longest/most specific first.
# ---------------------------------------------------------------------------

ROLE_PREFIXES: tuple[tuple[str, str], ...] = (
    ("device-lane-gauge", "flusher"),   # low-cadence gauge refresher
    ("device-lane", "device_lane"),     # the pipeline's serialized lane
    ("device-watchdog", "device_lane"), # supervised dispatches run here
    ("mesh-dispatch", "device_lane"),   # single-controller mesh enqueue lane
    ("step-read", "prefetch"),          # pipeline read/staging stage
    ("step-commit", "commit"),          # pipeline commit stage
    ("step-http", "http_client"),       # pipeline helper-HTTP stage
    ("dap-handler", "http_handler"),    # bounded HTTP handler pool
    ("ingest-decrypt", "decrypt_pool"),
    ("ingest-decode", "decode_pool"),
    ("report-writer", "flusher"),       # upload group-commit flusher
    ("resident-flusher", "flusher"),
    ("upload-journal-replay", "flusher"),
    ("chrome-trace-flush", "flusher"),
    ("slo-engine", "slo_engine"),
    ("health-sampler", "sampler"),
    ("datastore-supervisor", "supervisor"),
    ("engine-canary", "engine_warm"),
    ("engine-warmup", "engine_warm"),
    ("dap-listener", "listener"),       # accept loops (normalized names)
    ("health-listener", "listener"),
    ("api-listener", "listener"),
    ("interop-listener", "listener"),
    # the interop runner STEPS jobs (real aggregation work), so it must
    # not fold into the accept-loop role
    ("interop-runner", "other"),
    ("gc-loop", "gc"),
    ("janus-profiler", "profiler"),
    ("flight-recorder", "flight"),      # telemetry history snapshotter
    ("MainThread", "main"),
)


def thread_role(name: str) -> str:
    for prefix, role in ROLE_PREFIXES:
        if name.startswith(prefix):
            return role
    return "other"


# Leaf frames in these modules are parked waits (lock/queue/socket/
# sleep callers), not work: a wall-clock sample whose leaf lands here
# counts toward the role's TOTAL share but not its SELF share, so
# "device_lane 90% total / 5% self" reads as an idle lane, not a busy
# one. (C-level blocking shows the Python caller as the leaf, which is
# why this is a module heuristic rather than a function list —
# concurrent.futures.thread is here because an idle pool worker's
# queue.get is C-level SimpleQueue, leaving `_worker` itself as the
# Python leaf.)
_WAIT_MODULES = frozenset(
    (
        "threading",
        "queue",
        "selectors",
        "socket",
        "ssl",
        "socketserver",
        "subprocess",
        "concurrent.futures.thread",
    )
)


def _is_wait_leaf(label: str) -> bool:
    return label.rpartition(".")[0] in _WAIT_MODULES


@dataclass
class ProfilerConfig:
    """YAML `profiler:` stanza on CommonConfig (enabled by default in
    every binary via janus_main)."""

    enabled: bool = True
    # sampling rate; ~19 Hz default (prime-ish, anti-aliasing)
    hz: float = 19.0
    # fixed aggregation window length and the bounded ring of retained
    # windows: /debug/profile aggregates current + retained (so the
    # served view covers ~window_secs * (windows + 1) of history)
    window_secs: float = 30.0
    windows: int = 10
    max_stack_depth: int = 48

    @classmethod
    def from_dict(cls, d: dict | None) -> "ProfilerConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", True)),
            hz=float(d.get("hz", 19.0)),
            window_secs=float(d.get("window_secs", 30.0)),
            windows=int(d.get("windows", 10)),
            max_stack_depth=int(d.get("max_stack_depth", 48)),
        )


class _Window:
    __slots__ = ("start_unix", "passes", "samples", "stacks", "busy_s", "span_s")

    def __init__(self, start_unix: float):
        self.start_unix = start_unix
        self.passes = 0
        self.samples = 0  # thread-stacks sampled
        # {(role, frames tuple outermost-first): count}
        self.stacks: dict[tuple, int] = {}
        self.busy_s = 0.0  # sampler's own wall time inside this window
        self.span_s = 0.0  # wall covered by this window (set at rotation)


class SamplingProfiler:
    """See the module docstring. One instance per process (`PROFILER`),
    started by `install_profiler` from janus_main; tests construct their
    own."""

    def __init__(self, cfg: ProfilerConfig | None = None):
        self.cfg = cfg or ProfilerConfig()
        self._lock = threading.Lock()
        self._current: _Window | None = None
        self._ring: deque[_Window] = deque(maxlen=max(1, self.cfg.windows))
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._threads_last = 0

    # -- lifecycle -----------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "SamplingProfiler":
        if self.running:
            return self
        self._stop.clear()
        with self._lock:
            self._current = _Window(time.time())
        self._thread = threading.Thread(
            target=self._loop, name="janus-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
        self._thread = None

    # -- sampling ------------------------------------------------------
    def _loop(self) -> None:
        interval = 1.0 / max(0.1, self.cfg.hz)
        while not self._stop.wait(interval):
            try:
                self.sample_once()
            except Exception:  # the sampler must never die of one pass
                import logging

                logging.getLogger(__name__).exception("profiler sampling pass failed")

    def sample_once(self) -> int:
        """One sampling pass (also driven directly by tests): fold every
        other thread's stack into the current window. Returns the number
        of thread-stacks sampled."""
        from . import metrics

        t0 = time.perf_counter()
        own = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        depth = self.cfg.max_stack_depth
        sampled = 0
        entries = []
        for ident, frame in frames.items():
            if ident == own:
                continue
            name = names.get(ident, f"ident-{ident}")
            stack = tuple(format_stack(frame, limit=depth, lineno=False))
            if not stack:
                continue
            entries.append((thread_role(name), stack))
            sampled += 1
        busy = time.perf_counter() - t0
        now = time.time()
        with self._lock:
            self._maybe_rotate_locked(now)
            w = self._current
            if w is None:
                w = self._current = _Window(now)
            w.passes += 1
            w.samples += sampled
            w.busy_s += busy
            for key in entries:
                w.stacks[key] = w.stacks.get(key, 0) + 1
            self._threads_last = sampled
            overhead = self._overhead_ratio_locked()
        metrics.profiler_samples_total.add()
        metrics.profiler_threads.set(float(sampled))
        metrics.profiler_overhead_ratio.set(overhead)
        return sampled

    def _maybe_rotate_locked(self, now: float) -> None:
        w = self._current
        if w is not None and now - w.start_unix >= self.cfg.window_secs:
            w.span_s = now - w.start_unix
            self._ring.append(w)
            self._current = _Window(now)

    def _overhead_ratio_locked(self) -> float:
        """Measured sampler cost as a fraction of the wall time covered
        by the retained windows (0.0 while the sampler is off)."""
        busy = sum(w.busy_s for w in self._ring)
        span = sum(w.span_s for w in self._ring)
        w = self._current
        if w is not None:
            busy += w.busy_s
            span += time.time() - w.start_unix
        if span <= 0:
            return 0.0
        return busy / span

    # -- aggregation & rendering --------------------------------------
    def _aggregate_locked(self) -> tuple[dict, int, int]:
        """(stacks, samples, passes) merged across ring + current."""
        stacks: dict[tuple, int] = {}
        samples = passes = 0
        for w in list(self._ring) + ([self._current] if self._current else []):
            samples += w.samples
            passes += w.passes
            for key, c in w.stacks.items():
                stacks[key] = stacks.get(key, 0) + c
        return stacks, samples, passes

    def collapsed(self) -> str:
        """flamegraph.pl folded format: `role;frame;...;frame count`
        per line, root first, every component sanitized so hostile
        thread/frame names cannot corrupt the fold."""
        with self._lock:
            stacks, _, _ = self._aggregate_locked()
        lines = [
            ";".join(fold_component(c) for c in (role,) + frames) + f" {count}"
            for (role, frames), count in sorted(
                stacks.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines) + ("\n" if lines else "")

    def profile_json(self, top: int = 30) -> dict:
        """The `?format=json` payload: per-role self/total percentages
        (self excludes parked-wait leaves) and the top frames by self
        and total sample counts."""
        with self._lock:
            stacks, samples, passes = self._aggregate_locked()
            overhead = self._overhead_ratio_locked()
            threads_last = self._threads_last
            windows_retained = len(self._ring)
        roles: dict[str, dict] = {}
        frame_self: dict[str, int] = {}
        frame_total: dict[str, int] = {}
        for (role, frames), count in stacks.items():
            r = roles.setdefault(role, {"samples": 0, "self_samples": 0})
            r["samples"] += count
            leaf = frames[-1]
            if not _is_wait_leaf(leaf):
                r["self_samples"] += count
            frame_self[leaf] = frame_self.get(leaf, 0) + (
                0 if _is_wait_leaf(leaf) else count
            )
            for f in set(frames):
                frame_total[f] = frame_total.get(f, 0) + count
        denom = max(1, samples)
        for r in roles.values():
            r["total_pct"] = round(100.0 * r["samples"] / denom, 2)
            r["self_pct"] = round(100.0 * r["self_samples"] / denom, 2)
        top_frames = [
            {
                "frame": f,
                "self": frame_self.get(f, 0),
                "total": frame_total[f],
                "self_pct": round(100.0 * frame_self.get(f, 0) / denom, 2),
                "total_pct": round(100.0 * frame_total[f] / denom, 2),
            }
            for f in sorted(
                frame_total, key=lambda f: (-frame_self.get(f, 0), -frame_total[f])
            )[:top]
        ]
        return {
            "enabled": self.running,
            "hz": self.cfg.hz,
            "window_secs": self.cfg.window_secs,
            "windows_retained": windows_retained,
            "windows_cap": self._ring.maxlen,
            "passes": passes,
            "samples": samples,
            "threads_last_pass": threads_last,
            "overhead_ratio": round(overhead, 6),
            "roles": {k: roles[k] for k in sorted(roles)},
            "top_frames": top_frames,
        }

    def status(self) -> dict:
        """The compact /statusz `profile` section: enabled state,
        per-role CPU shares and the top frames by self time."""
        doc = self.profile_json(top=5)
        return {
            "enabled": doc["enabled"],
            "hz": doc["hz"],
            "passes": doc["passes"],
            "samples": doc["samples"],
            "overhead_ratio": doc["overhead_ratio"],
            "roles": {
                role: {"total_pct": r["total_pct"], "self_pct": r["self_pct"]}
                for role, r in doc["roles"].items()
            },
            "top_frames": doc["top_frames"],
        }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._ring.clear()
            self._current = _Window(time.time()) if self.running else None


# process-wide instance: always present (so /debug/profile and the
# statusz section answer a well-formed disabled document), started by
# install_profiler
PROFILER = SamplingProfiler()


def install_profiler(cfg: ProfilerConfig | None = None) -> SamplingProfiler:
    """Install + start the process profiler from the YAML `profiler:`
    stanza (janus_main). Replaces any running instance."""
    global PROFILER
    cfg = cfg or ProfilerConfig()
    PROFILER.stop()
    PROFILER = SamplingProfiler(cfg)
    if cfg.enabled:
        PROFILER.start()
    return PROFILER


def uninstall_profiler() -> None:
    """Stop the process profiler (teardown hook; the instance stays so
    the endpoints keep answering a well-formed disabled document)."""
    PROFILER.stop()


def profile_collapsed() -> str:
    return PROFILER.collapsed()


def profile_json() -> dict:
    return PROFILER.profile_json()


# ---------------------------------------------------------------------------
# Per-dispatch device cost ledger
# ---------------------------------------------------------------------------

COST_PHASES = ("compile", "execute", "h2d", "d2h")


class DeviceCostLedger:
    """Cumulative device-path cost per (vdaf, op, bucket), split by
    phase, with dispatch and row counts — fed by the engine cache's
    choke points (`_record_dispatch` for compile/execute + rows, the
    put/fetch span hooks for h2d/d2h, the supervised resident fetches).
    Derives the live `janus_device_cost_us_per_report{op,phase}` table:
    for an op, phase seconds summed over (vdaf, bucket) divided by the
    op's total rows."""

    def __init__(self):
        self._lock = threading.Lock()
        # {(vdaf, op, bucket): {"dispatches": n, "rows": n, <phase>_s...}}
        self._entries: dict[tuple, dict] = {}
        self._op_rows: dict[str, int] = {}
        self._op_phase_s: dict[tuple[str, str], float] = {}

    def record(
        self,
        vdaf: str,
        op: str,
        bucket: int,
        phase: str,
        seconds: float,
        rows: int = 0,
        dispatches: int = 0,
    ) -> None:
        if phase not in COST_PHASES:
            raise ValueError(f"unknown cost phase {phase!r}")
        from . import metrics

        key = (str(vdaf), str(op), int(bucket))
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = self._entries[key] = {
                    "dispatches": 0,
                    "rows": 0,
                    **{f"{p}_s": 0.0 for p in COST_PHASES},
                }
            ent["dispatches"] += dispatches
            ent["rows"] += rows
            ent[f"{phase}_s"] += seconds
            self._op_rows[op] = self._op_rows.get(op, 0) + rows
            self._op_phase_s[(op, phase)] = (
                self._op_phase_s.get((op, phase), 0.0) + seconds
            )
            op_rows = self._op_rows[op]
            gauge_updates = (
                [
                    (p, self._op_phase_s.get((op, p), 0.0))
                    for p in COST_PHASES
                ]
                if op_rows > 0
                else []
            )
        metrics.device_cost_seconds_total.add(seconds, op=op, phase=phase)
        for p, total_s in gauge_updates:
            metrics.device_cost_us_per_report.set(
                total_s / op_rows * 1e6, op=op, phase=p
            )

    def us_per_report(self) -> dict:
        """{op: {phase: µs/report}} for ops with recorded rows (the
        bench rider and the statusz attribution table)."""
        with self._lock:
            out: dict = {}
            for (op, phase), s in self._op_phase_s.items():
                rows = self._op_rows.get(op, 0)
                if rows > 0:
                    out.setdefault(op, {})[phase] = round(s / rows * 1e6, 3)
            return {op: dict(sorted(v.items())) for op, v in sorted(out.items())}

    def status(self) -> dict:
        """The /statusz `device_cost` section."""
        with self._lock:
            entries = [
                {
                    "vdaf": vdaf,
                    "op": op,
                    "bucket": bucket,
                    "dispatches": ent["dispatches"],
                    "rows": ent["rows"],
                    **{
                        f"{p}_s": round(ent[f"{p}_s"], 6)
                        for p in COST_PHASES
                    },
                }
                for (vdaf, op, bucket), ent in sorted(self._entries.items())
            ]
        return {"entries": entries, "us_per_report": self.us_per_report()}

    def reset_for_tests(self) -> None:
        with self._lock:
            self._entries.clear()
            self._op_rows.clear()
            self._op_phase_s.clear()


DEVICE_COST = DeviceCostLedger()


# h2d/d2h wall time rides the existing engine put/fetch spans via the
# span-hook registry (trace.register_span_hook): the span boundaries
# ARE the transfer boundaries (engine_cache keeps the blocking
# conversions inside them), so the ledger and the Chrome trace measure
# the same thing by construction. The `bucket` span arg (added at the
# engine call sites) keys the per-bucket row of the table.
_TRANSFER_SPANS = {
    "engine.helper_init.put": ("helper_init", "h2d"),
    "engine.helper_init.fetch": ("helper_init", "d2h"),
    "engine.leader_init.put": ("leader_init", "h2d"),
    "engine.leader_init.put_all_async": ("leader_init", "h2d"),
    "engine.leader_init.fetch": ("leader_init", "d2h"),
    "engine.leader_init.fetch_seed": ("leader_init", "d2h"),
    "engine.leader_init.fetch_ver": ("leader_init", "d2h"),
    "engine.leader_init.fetch_part": ("leader_init", "d2h"),
}


def _register_transfer_hooks() -> None:
    from .trace import register_span_hook

    def make_hook(op: str, phase: str):
        def hook(dur_s: float, args: dict) -> None:
            try:
                bucket = int(args.get("bucket") or 0)
            except (TypeError, ValueError):
                bucket = 0
            DEVICE_COST.record(
                str(args.get("vdaf", "")), op, bucket, phase, dur_s
            )

        return hook

    for name, (op, phase) in _TRANSFER_SPANS.items():
        register_span_hook(name, make_hook(op, phase))


_register_transfer_hooks()


# ---------------------------------------------------------------------------
# Boot-phase timeline
# ---------------------------------------------------------------------------


class BootTimeline:
    """Contiguous named bring-up phases from the kernel-reported process
    start: `phase_done(name)` closes the phase running since the
    previous mark, `mark_ready()` seals the record at the moment the
    process turns servable (the health listener is up and /readyz
    answers), so the recorded phases sum EXACTLY to the
    process-start → ready wall time. Phases reported after ready (a
    binary's run() body booting late subsystems — journal scan, DAP
    listener) append flagged `late` and are excluded from that sum."""

    def __init__(self, start_unix: float | None = None):
        if start_unix is None:
            from .metrics import _process_start_time

            start_unix = _process_start_time()
        self.start_unix = start_unix
        self._lock = threading.Lock()
        self._phases: list[dict] = []
        self._last_mark = start_unix
        self.ready_unix: float | None = None

    def phase_done(self, name: str) -> float:
        """Close the phase running since the previous mark; returns its
        duration. Also exports janus_boot_phase_seconds{phase}."""
        from . import metrics

        now = time.time()
        with self._lock:
            start = self._last_mark
            seconds = max(0.0, now - start)
            self._phases.append(
                {
                    "phase": str(name),
                    "start_s": round(start - self.start_unix, 6),
                    "end_s": round(now - self.start_unix, 6),
                    "seconds": round(seconds, 6),
                    **({"late": True} if self.ready_unix is not None else {}),
                }
            )
            self._last_mark = now
        metrics.boot_phase_seconds.set(seconds, phase=str(name))
        return seconds

    def mark_ready(self) -> None:
        """Seal the boot record (idempotent; first call wins)."""
        with self._lock:
            if self.ready_unix is None:
                self.ready_unix = time.time()
                self._last_mark = self.ready_unix

    def snapshot(self) -> dict:
        """The GET /debug/boot payload."""
        with self._lock:
            phases = [dict(p) for p in self._phases]
            ready = self.ready_unix
        boot = [p for p in phases if not p.get("late")]
        doc = {
            "started_unix": self.start_unix,
            "ready": ready is not None,
            "phases": phases,
            "boot_phases_sum_s": round(sum(p["seconds"] for p in boot), 6),
        }
        if ready is not None:
            doc["ready_unix"] = ready
            doc["total_s"] = round(ready - self.start_unix, 6)
        return doc

    def reset_for_tests(self, start_unix: float | None = None) -> None:
        with self._lock:
            self._phases.clear()
            self.start_unix = start_unix if start_unix is not None else time.time()
            self._last_mark = self.start_unix
            self.ready_unix = None


BOOT = BootTimeline()


def boot_snapshot() -> dict:
    return BOOT.snapshot()


# /statusz sections: the profiler summary and the device-cost table on
# every binary (registered at import — binary_utils imports this
# module, so every health listener carries them; both answer
# well-formed empty/disabled documents before anything runs)
register_status_provider("profile", lambda: PROFILER.status())
register_status_provider("device_cost", DEVICE_COST.status)
