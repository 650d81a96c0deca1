"""Telemetry flight recorder: in-process metric history and trend/leak
detection (docs/OBSERVABILITY.md "Flight recorder and trend alerts").

/metrics, /statusz and /alertz say how the process is doing now; this
module records how a number has moved over the last hours, and judges
whether resource curves stay flat under sustained load:

  1. **Recorder** (`FlightRecorder`): a low-cadence daemon thread (the
     YAML `flight:` stanza on CommonConfig, installed by janus_main by
     default) snapshots a configured set of series (process RSS from
     /proc, the engine's device-resident bytes, datastore table row
     counts and the upload journal's on-disk bytes, both fed by the
     health sampler's gauges, upload-journal bytes, GC deleted-row
     counters) into a bounded on-disk ring of JSONL segments with
     downsampling tiers (raw interval, 1m and 10m rollups, a fixed byte
     budget, torn-tail-tolerant reads like the upload journal). Raw
     snapshots also carry cumulative histogram bucket counts for the
     configured latency families, so p99 can be derived again over any
     sub-window.

  2. **Trend analyzer**: per tracked series, a robust (Theil–Sen)
     linear-regression slope over the in-memory window with a leak
     verdict: the projected growth over the window must clear both the
     residual noise band (median absolute deviation) and a relative
     floor, so flat-but-noisy series and microscopic drift stay quiet.
     Latency families get a window-vs-window p99 comparison (first half
     against second half of the window, from bucket deltas). Exported as
     `janus_flight_slope{series}` / `janus_flight_leak_active{series}` /
     `janus_flight_p99_ratio{family}` and read by the SLO engine's
     `trend` signal (slo.py), so a sustained leak pages through the
     burn-rate ladder and /alertz.

  3. **Serving**: `GET /debug/flight` (window queries, JSON) on every
     health listener, and a `flight` statusz section (ring occupancy,
     series tracked, last-snapshot age, live leak verdicts).

The recorder measures its own cost and exports it
(`janus_flight_overhead_ratio`). A failpoint (`flight.synthetic_leak`)
grows a synthetic tracked series while armed, so the leak detector can
be shown live end to end.

The port's own copy of janus_tpu/flight_recorder.py, with janus_tpu's
builtin series: `shape_manifest_bytes` is the shape manifest's file and
`aot_cache_bytes` the kernel-library cache's directory.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

from .statusz import register_status_provider, unregister_status_provider

log = logging.getLogger(__name__)

# bytes the synthetic-leak failpoint adds per armed snapshot: large
# against every noise band, so the negative test flips the verdict in
# a handful of intervals
SYNTHETIC_LEAK_STEP = 1 << 20


def _read_rss_bytes() -> float | None:
    """Resident set size from /proc/self/statm (field 2, pages); None
    off Linux (the series is simply absent rather than fake)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Tracked series
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SeriesSpec:
    """One tracked series. source="metric" sums the named registry
    family over the label matchers; source="rss" reads /proc. `leak`
    marks the series as leak-gated: the analyzer issues a slope/leak
    verdict for it (cumulative counters are recorded for history but
    not leak-gated — their slope is their job)."""

    name: str
    source: str = "metric"  # metric | rss
    metric: str = ""
    labels: tuple = ()  # compiled matchers (metrics.compile_matchers)
    leak: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "SeriesSpec":
        from .metrics import compile_matchers

        source = str(d.get("source", "metric"))
        if source not in ("metric", "rss"):
            raise ValueError(f"unknown flight series source {source!r}")
        return cls(
            name=str(d["name"]),
            source=source,
            metric=str(d.get("metric", "")),
            labels=compile_matchers(d.get("labels")),
            leak=bool(d.get("leak", True)),
        )

    def read(self) -> float | None:
        if self.source == "rss":
            return _read_rss_bytes()
        from .metrics import REGISTRY

        m = REGISTRY.get(self.metric)
        if m is None or not hasattr(m, "sum_matching"):
            return None
        v, n = m.sum_matching(self.labels)
        return v if n else None


def BUILTIN_SERIES() -> list[SeriesSpec]:
    """The shipped tracked set: the slow-leak risks (RSS, device-resident
    bytes, datastore rows, on-disk artifacts) plus the GC counters for
    history. YAML `flight.series` entries override these by name."""
    from .metrics import compile_matchers

    return [
        SeriesSpec(name="rss_bytes", source="rss", leak=True),
        SeriesSpec(
            name="engine_resident_bytes",
            metric="janus_engine_resident_bytes",
            leak=True,
        ),
        SeriesSpec(
            name="datastore_rows", metric="janus_datastore_table_rows", leak=True
        ),
        SeriesSpec(
            name="upload_journal_bytes", metric="janus_upload_journal_bytes", leak=True
        ),
        SeriesSpec(
            name="shape_manifest_bytes",
            metric="janus_artifact_bytes",
            labels=compile_matchers({"artifact": "shape_manifest"}),
            leak=True,
        ),
        SeriesSpec(
            name="aot_cache_bytes",
            metric="janus_artifact_bytes",
            labels=compile_matchers({"artifact": "aot_cache"}),
            leak=True,
        ),
        # cumulative: recorded into the ring for history/debug-bundle
        # evidence, never leak-gated (a healthy GC's counter RISES)
        SeriesSpec(
            name="gc_deleted_rows",
            metric="janus_gc_deleted_rows_total",
            leak=False,
        ),
    ]


@dataclass
class FlightRecorderConfig:
    """YAML `flight:` stanza on CommonConfig (enabled by default in
    every binary via janus_main). `dir: null` keeps the recorder
    memory-only (trend verdicts still work; nothing persists)."""

    enabled: bool = True
    interval_s: float = 10.0
    dir: str | None = None
    max_total_bytes: int = 16 << 20
    max_segment_bytes: int = 256 << 10
    # trend window the in-memory deque retains and verdicts judge over
    window_s: float = 3600.0
    # downsampling tiers written into the ring beside the raw records
    rollup_secs: tuple = (60.0, 600.0)
    # run the trend analysis every Nth snapshot pass (the Theil–Sen
    # pass costs more than a snapshot; the verdicts don't need to move
    # faster than a few intervals)
    analyze_every: int = 3
    # verdict knobs: at least min_points snapshots; projected growth
    # over the window must exceed BOTH noise_mult * residual MAD and
    # min_growth_ratio * max(|median level|, 1.0)
    min_points: int = 8
    noise_mult: float = 4.0
    min_growth_ratio: float = 0.05
    # window-vs-window p99: late/early ratio above this is unstable
    p99_max_ratio: float = 2.0
    # both halves of the window must have seen at least this many
    # observations for a p99 verdict — a handful of samples makes the
    # window-vs-window ratio pure noise
    p99_min_samples: int = 16
    latency_families: tuple = ("janus_http_request_duration_seconds",)
    series: tuple = ()  # raw dicts, merged over BUILTIN_SERIES by name

    @classmethod
    def from_dict(cls, d: dict | None) -> "FlightRecorderConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", True)),
            interval_s=float(d.get("interval_secs", 10.0)),
            dir=d.get("dir"),
            max_total_bytes=int(d.get("max_total_bytes", 16 << 20)),
            max_segment_bytes=int(d.get("max_segment_bytes", 256 << 10)),
            window_s=float(d.get("window_secs", 3600.0)),
            rollup_secs=tuple(
                float(x) for x in d.get("rollup_secs", (60.0, 600.0))
            ),
            analyze_every=max(1, int(d.get("analyze_every", 3))),
            min_points=int(d.get("min_points", 8)),
            noise_mult=float(d.get("noise_mult", 4.0)),
            min_growth_ratio=float(d.get("min_growth_ratio", 0.05)),
            p99_max_ratio=float(d.get("p99_max_ratio", 2.0)),
            p99_min_samples=int(d.get("p99_min_samples", 16)),
            latency_families=tuple(
                d.get("latency_families", ("janus_http_request_duration_seconds",))
            ),
            series=tuple(d.get("series", ())),
        )

    def build_series(self) -> list[SeriesSpec]:
        specs = {s.name: s for s in BUILTIN_SERIES()}
        for raw in self.series:
            spec = SeriesSpec.from_dict(raw)
            specs[spec.name] = spec
        return list(specs.values())


# ---------------------------------------------------------------------------
# Robust trend estimation
# ---------------------------------------------------------------------------


def theil_sen(points: list[tuple[float, float]]) -> tuple[float, float, float]:
    """(slope, intercept, residual MAD) of the Theil–Sen estimator over
    (t, v) points: slope = median of pairwise slopes, intercept =
    median(v - slope*t), noise = median absolute residual. Robust to a
    minority of outliers (a GC pause, one burst) the way least squares
    is not. Points are decimated evenly to <= 60 before the O(n^2)
    pairwise pass, so a 1h window at 1s cadence stays cheap."""
    n = len(points)
    if n < 2:
        return 0.0, points[0][1] if points else 0.0, 0.0
    if n > 60:
        step = n / 60.0
        points = [points[int(i * step)] for i in range(60)]
        n = len(points)
    slopes = []
    for i in range(n - 1):
        t0, v0 = points[i]
        for j in range(i + 1, n):
            t1, v1 = points[j]
            if t1 != t0:
                slopes.append((v1 - v0) / (t1 - t0))
    if not slopes:
        return 0.0, points[0][1], 0.0
    slopes.sort()
    slope = slopes[len(slopes) // 2]
    residuals = sorted(v - slope * t for t, v in points)
    intercept = residuals[len(residuals) // 2]
    abs_res = sorted(abs(v - (slope * t + intercept)) for t, v in points)
    mad = abs_res[len(abs_res) // 2]
    return slope, intercept, mad


def _p99_from_bucket_delta(
    bounds: tuple, early: list[float], late: list[float]
) -> float | None:
    """p99 upper-bound estimate from cumulative-bucket deltas
    (late - early, both cumulative counts per bound + the +Inf total
    appended last). None when the delta window saw no observations."""
    deltas = [b - a for a, b in zip(early, late)]
    total = deltas[-1]
    if total <= 0:
        return None
    target = 0.99 * total
    cum = 0.0
    for bound, d in zip(bounds, deltas):
        cum += d
        if cum >= target:
            return float(bound)
    return float("inf")


# ---------------------------------------------------------------------------
# The on-disk ring
# ---------------------------------------------------------------------------


class _Ring:
    """Bounded directory of JSONL segments (flight-<seq>.jsonl).
    Appends go to the active segment (flushed, not fsynced — history is
    best-effort evidence, not durability-critical); rotation at
    max_segment_bytes; the oldest whole segments are deleted to hold
    the byte budget. Reads are torn-tail-tolerant like the upload
    journal: an unparseable line (a crash mid-append) is skipped and
    counted, never fatal."""

    def __init__(self, path: str, max_segment_bytes: int, max_total_bytes: int):
        self.path = os.path.expanduser(path)
        self.max_segment_bytes = max(4096, int(max_segment_bytes))
        self.max_total_bytes = max(self.max_segment_bytes, int(max_total_bytes))
        os.makedirs(self.path, exist_ok=True)
        self._fh = None
        self._active = None
        self._active_bytes = 0
        self.dropped_segments = 0
        self.torn_lines = 0
        seqs = self._segment_seqs()
        self._seq = (seqs[-1] + 1) if seqs else 0

    def _segment_seqs(self) -> list[int]:
        out = []
        try:
            for name in os.listdir(self.path):
                if name.startswith("flight-") and name.endswith(".jsonl"):
                    try:
                        out.append(int(name[len("flight-") : -len(".jsonl")]))
                    except ValueError:
                        continue
        except OSError:
            pass
        return sorted(out)

    def _segment_path(self, seq: int) -> str:
        return os.path.join(self.path, f"flight-{seq:08d}.jsonl")

    def append(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":")) + "\n"
        data = line.encode()
        if self._fh is None or self._active_bytes + len(data) > self.max_segment_bytes:
            self._rotate()
        self._fh.write(data)
        self._fh.flush()
        self._active_bytes += len(data)

    def _rotate(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        self._active = self._segment_path(self._seq)
        self._fh = open(self._active, "ab")
        self._active_bytes = 0
        self._seq += 1
        self._enforce_budget()

    def _enforce_budget(self) -> None:
        seqs = self._segment_seqs()
        sizes = {}
        for s in seqs:
            try:
                sizes[s] = os.path.getsize(self._segment_path(s))
            except OSError:
                sizes[s] = 0
        total = sum(sizes.values())
        for s in seqs:
            if total <= self.max_total_bytes or self._segment_path(s) == self._active:
                break
            try:
                os.unlink(self._segment_path(s))
                total -= sizes[s]
                self.dropped_segments += 1
            except OSError:
                break

    def state(self) -> dict:
        seqs = self._segment_seqs()
        total = 0
        for s in seqs:
            try:
                total += os.path.getsize(self._segment_path(s))
            except OSError:
                pass
        return {
            "dir": self.path,
            "segments": len(seqs),
            "bytes": total,
            "dropped_segments": self.dropped_segments,
            "torn_lines_skipped": self.torn_lines,
        }

    def read(self, since_unix: float | None = None, tier: str | None = None) -> list[dict]:
        """Records at or after `since_unix` (all when None), oldest
        first; `tier` filters ("raw"/"60"/"600")."""
        out: list[dict] = []
        for s in self._segment_seqs():
            try:
                with open(self._segment_path(s), "rb") as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            # torn tail (crash mid-append) or corruption:
                            # skip the line, keep the valid prefix
                            self.torn_lines += 1
                            continue
                        if since_unix is not None and rec.get("t", 0) < since_unix:
                            continue
                        if tier is not None and rec.get("tier") != tier:
                            continue
                        out.append(rec)
            except OSError:
                continue
        return out

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


class _RollupTier:
    """One downsampling tier: accumulates raw snapshots per
    floor(t/period) bucket and emits a mean/min/max/n record when the
    bucket completes."""

    __slots__ = ("period", "bucket", "stats")

    def __init__(self, period: float):
        self.period = float(period)
        self.bucket: int | None = None
        self.stats: dict[str, list] = {}  # name -> [sum, min, max, n]

    def feed(self, t: float, values: dict) -> dict | None:
        bucket = int(t // self.period)
        emitted = None
        if self.bucket is not None and bucket != self.bucket and self.stats:
            emitted = {
                "t": self.bucket * self.period,
                "tier": f"{self.period:g}",
                "v": {
                    name: {
                        "mean": s[0] / s[3],
                        "min": s[1],
                        "max": s[2],
                        "n": s[3],
                    }
                    for name, s in self.stats.items()
                },
            }
            self.stats = {}
        self.bucket = bucket
        for name, v in values.items():
            s = self.stats.get(name)
            if s is None:
                self.stats[name] = [v, v, v, 1]
            else:
                s[0] += v
                s[1] = min(s[1], v)
                s[2] = max(s[2], v)
                s[3] += 1
        return emitted


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


class FlightRecorder:
    """See the module docstring. One instance per process, installed by
    `install_flight_recorder` (janus_main); tests construct their own
    and drive `snapshot_once()` / `analyze()` directly."""

    def __init__(self, cfg: FlightRecorderConfig | None = None, time_fn=time.time):
        self.cfg = cfg or FlightRecorderConfig()
        self._time = time_fn
        self.series = self.cfg.build_series()
        self._lock = threading.Lock()
        # in-memory window: (t, {name: value}) + histogram cumulatives
        self._window: list[tuple[float, dict]] = []
        self._hist_window: list[tuple[float, dict]] = []
        self._ring: _Ring | None = None
        if self.cfg.dir:
            try:
                self._ring = _Ring(
                    self.cfg.dir, self.cfg.max_segment_bytes, self.cfg.max_total_bytes
                )
            except OSError:
                log.exception("flight ring unavailable at %s; memory-only", self.cfg.dir)
        self._tiers = [_RollupTier(p) for p in self.cfg.rollup_secs]
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._started_unix: float | None = None
        self._last_snapshot_unix: float | None = None
        self._snapshots = 0
        self._busy_s = 0.0
        self._synthetic_bytes = 0
        self._last_analysis: dict = {}

    # -- lifecycle -----------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "FlightRecorder":
        if self.running:
            return self
        self._stop.clear()
        self._started_unix = self._time()
        self._thread = threading.Thread(
            target=self._loop, name="flight-recorder", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        # first pass immediately: a scrape right after boot must not
        # wait an interval for the janus_flight_* families to populate
        passes = 0
        while True:
            try:
                self.snapshot_once()
                passes += 1
                if passes % max(1, self.cfg.analyze_every) == 0:
                    self.analyze()
            except Exception:
                log.exception("flight recorder pass failed")
            if self._stop.wait(self.cfg.interval_s):
                return

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
        self._thread = None
        if self._ring is not None:
            self._ring.close()

    # -- snapshotting --------------------------------------------------
    def _read_hist_cumulatives(self) -> dict:
        """{family: {"bounds": [...], "cum": [...]}}: cumulative bucket
        counts summed across label sets, +Inf total appended — enough
        to re-derive any sub-window's latency distribution by delta."""
        from . import metrics
        from .metrics import REGISTRY

        out = {}
        for family in self.cfg.latency_families:
            m = REGISTRY.get(family)
            if not isinstance(m, metrics.Histogram):
                continue
            with m._lock:
                per_bucket = [0.0] * len(m.buckets)
                total = 0.0
                for key, counts in m._counts.items():
                    for i, c in enumerate(counts):
                        per_bucket[i] += c
                    total += m._totals[key]
            cum = []
            running = 0.0
            for c in per_bucket:
                running += c
                cum.append(running)
            cum.append(total)
            out[family] = {"bounds": list(m.buckets), "cum": cum}
        return out

    def snapshot_once(self) -> dict:
        """One snapshot pass (the unit tests and the /debug handlers
        drive it directly): read every tracked series, append to the
        in-memory window and the on-disk ring, feed the rollup tiers,
        export the bookkeeping gauges. Returns the raw record."""
        from . import failpoints, metrics

        t0 = time.perf_counter()
        now = self._time()
        # the injected-leak failpoint: while armed (error action), every
        # snapshot grows a synthetic leak-gated series — the negative
        # test that proves the detector is live, not decorative
        try:
            failpoints.hit("flight.synthetic_leak")
        except Exception:
            self._synthetic_bytes += SYNTHETIC_LEAK_STEP
        values: dict[str, float] = {}
        for spec in self.series:
            try:
                v = spec.read()
            except Exception:
                log.exception("flight series %s read failed", spec.name)
                v = None
            if v is not None:
                values[spec.name] = float(v)
        if self._synthetic_bytes:
            values["synthetic_leak_bytes"] = float(self._synthetic_bytes)
        hists = self._read_hist_cumulatives()
        record = {"t": now, "tier": "raw", "v": values}
        with self._lock:
            self._window.append((now, values))
            self._hist_window.append((now, hists))
            cutoff = now - self.cfg.window_s * 1.25
            while self._window and self._window[0][0] < cutoff:
                self._window.pop(0)
            while self._hist_window and self._hist_window[0][0] < cutoff:
                self._hist_window.pop(0)
            self._snapshots += 1
            self._last_snapshot_unix = now
            if self._started_unix is None:
                self._started_unix = now
            if self._ring is not None:
                try:
                    self._ring.append(record)
                    for tier in self._tiers:
                        rollup = tier.feed(now, values)
                        if rollup is not None:
                            self._ring.append(rollup)
                except OSError:
                    log.exception("flight ring append failed")
            busy = time.perf_counter() - t0
            self._busy_s += busy
            overhead = self._overhead_ratio_locked(time.time())
            ring_state = self._ring.state() if self._ring is not None else None
        metrics.flight_snapshots_total.add()
        metrics.flight_overhead_ratio.set(overhead)
        if ring_state is not None:
            metrics.flight_ring_bytes.set(float(ring_state["bytes"]))
            metrics.flight_ring_segments.set(float(ring_state["segments"]))
        return record

    def _overhead_ratio_locked(self, now: float) -> float:
        span = now - self._started_unix if self._started_unix is not None else 0.0
        if span <= 0:
            return 0.0
        return self._busy_s / span

    # -- analysis ------------------------------------------------------
    def analyze(self, window_s: float | None = None) -> dict:
        """The trend verdicts over the trailing window: per leak-gated
        series a Theil–Sen slope (units/second) and a leak verdict, per
        latency family a first-half-vs-second-half p99 comparison.
        Exports janus_flight_slope / janus_flight_leak_active /
        janus_flight_p99_ratio as a side effect."""
        from . import metrics

        t0 = time.perf_counter()
        window_s = float(window_s or self.cfg.window_s)
        now = self._time()
        cutoff = now - window_s
        with self._lock:
            window = [(t, v) for t, v in self._window if t >= cutoff]
            hist_window = [(t, h) for t, h in self._hist_window if t >= cutoff]
        leak_gated = {s.name for s in self.series if s.leak}
        leak_gated.add("synthetic_leak_bytes")
        names = sorted({n for _, vals in window for n in vals})
        series_out = {}
        for name in names:
            points = [(t, vals[name]) for t, vals in window if name in vals]
            doc: dict = {"points": len(points), "leak_gated": name in leak_gated}
            if len(points) < max(2, self.cfg.min_points):
                doc["verdict"] = "insufficient_data"
                series_out[name] = doc
                continue
            t_base = points[0][0]
            rel = [(t - t_base, v) for t, v in points]
            slope, intercept, mad = theil_sen(rel)
            span = rel[-1][0]
            level = sorted(v for _, v in points)[len(points) // 2]
            growth = slope * window_s  # projected growth over the window
            noise_floor = self.cfg.noise_mult * mad
            rel_floor = self.cfg.min_growth_ratio * max(abs(level), 1.0)
            leak = (
                name in leak_gated
                and slope > 0
                and growth > noise_floor
                and growth > rel_floor
            )
            doc.update(
                {
                    "slope_per_s": slope,
                    "projected_window_growth": growth,
                    "noise_mad": mad,
                    "median_level": level,
                    "covered_s": span,
                    "verdict": "leak" if leak else "flat",
                }
            )
            series_out[name] = doc
            if name in leak_gated:
                metrics.flight_slope.set(slope, series=name)
                metrics.flight_leak_active.set(1.0 if leak else 0.0, series=name)
        latency_out = {}
        if len(hist_window) >= 3:
            mid = hist_window[len(hist_window) // 2]
            first, last = hist_window[0], hist_window[-1]
            for family in self.cfg.latency_families:
                h0 = first[1].get(family)
                hm = mid[1].get(family)
                h1 = last[1].get(family)
                if not (h0 and hm and h1):
                    continue
                bounds = tuple(h1["bounds"])
                early = _p99_from_bucket_delta(bounds, h0["cum"], hm["cum"])
                late = _p99_from_bucket_delta(bounds, hm["cum"], h1["cum"])
                n_early = hm["cum"][-1] - h0["cum"][-1]
                n_late = h1["cum"][-1] - hm["cum"][-1]
                doc = {
                    "p99_early_s": early,
                    "p99_late_s": late,
                    "early_n": n_early,
                    "late_n": n_late,
                    "early_window": [first[0], mid[0]],
                    "late_window": [mid[0], last[0]],
                }
                if (
                    early is None
                    or late is None
                    or min(n_early, n_late) < self.cfg.p99_min_samples
                ):
                    doc["verdict"] = "insufficient_data"
                elif early <= 0:
                    doc["verdict"] = "stable" if late <= 0 else "degraded"
                else:
                    ratio = late / early
                    doc["p99_ratio"] = ratio
                    doc["verdict"] = (
                        "stable" if ratio <= self.cfg.p99_max_ratio else "degraded"
                    )
                    metrics.flight_p99_ratio.set(ratio, family=family)
                latency_out[family] = doc
        analysis = {
            "window_s": window_s,
            "generated_unix": now,
            "series": series_out,
            "latency": latency_out,
            "leaking": sorted(
                n for n, d in series_out.items() if d.get("verdict") == "leak"
            ),
        }
        with self._lock:
            self._busy_s += time.perf_counter() - t0
            self._last_analysis = analysis
        return analysis

    # -- serving -------------------------------------------------------
    def document(self, window_s: float | None = None, max_points: int = 500) -> dict:
        """The GET /debug/flight payload: recent in-window snapshots
        (evenly decimated to max_points), the live trend analysis and
        the ring state. Pure read + one analysis pass."""
        window_s = float(window_s or self.cfg.window_s)
        analysis = self.analyze(window_s)
        now = self._time()
        cutoff = now - window_s
        with self._lock:
            snaps = [
                {"t": t, "v": vals} for t, vals in self._window if t >= cutoff
            ]
            ring_state = self._ring.state() if self._ring is not None else None
            overhead = self._overhead_ratio_locked(time.time())
            last = self._last_snapshot_unix
        if len(snaps) > max_points:
            step = len(snaps) / float(max_points)
            snaps = [snaps[int(i * step)] for i in range(max_points)]
        return {
            "enabled": True,
            "running": self.running,
            "interval_s": self.cfg.interval_s,
            "window_s": window_s,
            "series_tracked": [s.name for s in self.series],
            "snapshots_total": self._snapshots,
            "last_snapshot_unix": last,
            "overhead_ratio": round(overhead, 6),
            "ring": ring_state,
            "snapshots": snaps,
            "analysis": analysis,
        }

    def status(self) -> dict:
        """The compact /statusz `flight` section (a stale last-snapshot
        age means a stalled recorder)."""
        now = self._time()
        with self._lock:
            ring_state = self._ring.state() if self._ring is not None else None
            last = self._last_snapshot_unix
            overhead = self._overhead_ratio_locked(time.time())
            analysis = self._last_analysis
        leaks = {
            n: d.get("slope_per_s")
            for n, d in (analysis.get("series") or {}).items()
            if d.get("verdict") == "leak"
        }
        return {
            "enabled": self.cfg.enabled,
            "running": self.running,
            "interval_s": self.cfg.interval_s,
            "series_tracked": [s.name for s in self.series],
            "snapshots": self._snapshots,
            "last_snapshot_unix": last,
            "last_snapshot_age_s": (
                round(now - last, 3) if last is not None else None
            ),
            "overhead_ratio": round(overhead, 6),
            "ring": ring_state,
            "leaks_active": leaks,
            "latency_verdicts": {
                f: d.get("verdict")
                for f, d in (analysis.get("latency") or {}).items()
            },
        }


# ---------------------------------------------------------------------------
# Process-wide instance (the health listener's /debug/flight reads it)
# ---------------------------------------------------------------------------

_recorder: FlightRecorder | None = None
_recorder_lock = threading.Lock()


def install_flight_recorder(
    cfg: FlightRecorderConfig | None = None, start: bool = True
) -> FlightRecorder:
    """Install (replacing any previous) the process-wide recorder and
    register its /statusz `flight` section. janus_main calls this with
    the YAML stanza; a disabled config still installs (statusz and
    /debug/flight answer well-formed disabled documents)."""
    global _recorder
    cfg = cfg or FlightRecorderConfig()
    recorder = FlightRecorder(cfg)
    recorder._status_provider = recorder.status
    with _recorder_lock:
        prev, _recorder = _recorder, recorder
    if prev is not None:
        prev.stop()
    register_status_provider("flight", recorder._status_provider)
    if start and cfg.enabled:
        recorder.start()
    return recorder


def uninstall_flight_recorder() -> None:
    global _recorder
    with _recorder_lock:
        recorder, _recorder = _recorder, None
    if recorder is not None:
        recorder.stop()
        unregister_status_provider(
            "flight", getattr(recorder, "_status_provider", None)
        )


def get_flight_recorder() -> FlightRecorder | None:
    return _recorder


def flight_document(window_s: float | None = None, max_points: int = 500) -> dict:
    """The GET /debug/flight payload for this process (a process
    without an installed recorder answers a well-formed disabled
    document, like /alertz)."""
    recorder = _recorder
    if recorder is None:
        return {"enabled": False, "series_tracked": [], "snapshots": [], "analysis": {}}
    return recorder.document(window_s=window_s, max_points=max_points)
