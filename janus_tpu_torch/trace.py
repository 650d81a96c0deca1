"""Structured logging + span tracing.

Equivalent of the reference's tracing subscriber installation
(aggregator/src/trace.rs:44-90): pretty or JSON line format, level
from config, and a **Chrome trace-file layer** (trace.rs:68-71):
host-side spans — request handlers, job steps, engine calls — written
as Chrome trace-event JSON, loadable in chrome://tracing or Perfetto
beside a `torch.profiler` trace of the card.

The port's own copy of janus_tpu/trace.py: the same span names, the
same W3C traceparent format and the same contextvar discipline, so a
trace id crosses between a port aggregator and a janus_tpu one in
either direction. janus_tpu's environment overrides (JANUS_LOG,
JANUS_CHROME_TRACE, JANUS_OTLP_ENDPOINT, JANUS_FLIGHT_RECORDER_SPANS,
JANUS_SLOW_TRACE_THRESHOLD_S) are not ported: the configuration and
the constructors' arguments are the only inputs.

A span measures the host: on the card a launch returns before the
kernel runs, so a span around a dispatch times the enqueue, and the
span that ends in the blocking copy back (a fetch) absorbs the queued
kernels' time.
"""

from __future__ import annotations

import atexit
import collections
import json
import logging
import math
import os
import random
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

# span-id generation: uniqueness, not unpredictability (no urandom
# syscall); a module-level instance so the span() hot path pays neither
# an import nor the global-PRNG lock contention pattern
_span_rng = random.Random()


@dataclass
class TraceConfiguration:
    """reference aggregator/src/trace.rs TraceConfiguration."""

    use_test_writer: bool = False
    force_json_output: bool = False
    level: str = "INFO"
    # Path for host-side span output in Chrome trace-event format
    # (reference trace.rs:68-71 ChromeLayer); None disables.
    chrome_trace_file: str | None = None
    # OTLP/HTTP collector base endpoint (spans POST to /v1/traces,
    # metrics to /v1/metrics, JSON encoding) — the reference's
    # OpenTelemetry OTLP exporters (trace.rs:44-90, metrics.rs:53-80).
    # None disables.
    otlp_endpoint: str | None = None

    @classmethod
    def from_dict(cls, d: dict | None) -> "TraceConfiguration":
        d = d or {}
        return cls(
            use_test_writer=bool(d.get("use_test_writer", False)),
            force_json_output=bool(d.get("force_json_output", False)),
            level=str(d.get("level", "INFO")),
            chrome_trace_file=d.get("chrome_trace_file"),
            otlp_endpoint=d.get("otlp_endpoint"),
        )


class ChromeTraceWriter:
    """Streams complete ('X') trace events; the file is a JSON array
    readable by chrome://tracing and Perfetto even if the tail comma
    is left dangling on crash.

    Events are buffered and flushed on a size/time threshold (a daemon
    flusher covers the idle case — a burst followed by silence still
    reaches disk within FLUSH_INTERVAL_S) and on close() — the previous
    per-event write+flush cost dominated the span hot path. Crash
    tolerance trades down
    accordingly: at most FLUSH_BYTES / FLUSH_INTERVAL_S of tail spans
    can be lost with the process (the flight recorder keeps them in
    memory regardless)."""

    FLUSH_BYTES = 64 * 1024
    FLUSH_INTERVAL_S = 1.0

    def __init__(self, path: str, flush_interval_s: float | None = None):
        self._f = open(path, "w")
        self._f.write("[\n")
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._closed = False
        self._buf: list[str] = []
        self._buf_bytes = 0
        self._last_flush = time.monotonic()
        self._flush_interval = (
            flush_interval_s if flush_interval_s is not None else self.FLUSH_INTERVAL_S
        )
        self._stop_flusher = threading.Event()
        self._flusher = threading.Thread(
            target=self._flush_loop, name="chrome-trace-flush", daemon=True
        )
        self._flusher.start()

    def _flush_loop(self) -> None:
        while not self._stop_flusher.wait(self._flush_interval):
            with self._lock:
                if self._closed:
                    return
                if self._buf:
                    self._flush_locked()

    def event(self, name: str, ts_us: float, dur_us: float, args: dict) -> None:
        doc = {
            "name": name,
            "ph": "X",
            "ts": ts_us,
            "dur": dur_us,
            "pid": self._pid,
            "tid": threading.get_ident() % 1_000_000,
            "args": args,
        }
        line = json.dumps(doc) + ",\n"
        with self._lock:
            if self._closed:
                return  # a daemon thread's span outlived the writer
            self._buf.append(line)
            self._buf_bytes += len(line)
            now = time.monotonic()
            if (
                self._buf_bytes >= self.FLUSH_BYTES
                or now - self._last_flush >= self._flush_interval
            ):
                self._flush_locked(now)

    def _flush_locked(self, now: float | None = None) -> None:
        try:
            self._f.write("".join(self._buf))
            self._f.flush()
        except ValueError:
            self._closed = True
        self._buf.clear()
        self._buf_bytes = 0
        self._last_flush = now if now is not None else time.monotonic()

    def close(self) -> None:
        self._stop_flusher.set()
        with self._lock:
            if self._closed:
                return
            self._flush_locked()
            self._closed = True
            try:
                self._f.write("{}]\n")
                self._f.close()
            except ValueError:
                pass  # already closed


class OtlpExporter:
    """Dependency-free OTLP/HTTP exporter, JSON encoding (the OTLP/HTTP
    spec's JSON mapping of the protobufs): finished spans batch to
    {endpoint}/v1/traces, metrics-registry snapshots to /v1/metrics.
    The reference ships the same capability via the opentelemetry-otlp
    crate (aggregator/src/trace.rs:44-90, metrics.rs:53-80)."""

    # Bound on spans buffered between flushes: a down collector must
    # not let the buffer grow with load for a whole flush interval;
    # past the cap the OLDEST spans drop (counted by
    # janus_otlp_spans_dropped_total) so the freshest context survives.
    MAX_BUFFERED_SPANS = 4096

    def __init__(self, endpoint: str, service_name: str = "janus_tpu", flush_interval_s: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        self._resource = {
            "attributes": [
                {"key": "service.name", "value": {"stringValue": service_name}},
                {"key": "process.pid", "value": {"intValue": str(os.getpid())}},
            ]
        }
        # process-wide resource attributes set before this exporter
        # existed (fleet replica identity) still apply
        self.apply_resource_attributes(resource_attributes())
        self._spans: list[dict] = []
        self._lock = threading.Lock()
        # a hung collector must not stall the flush loop past its own
        # interval (the old fixed 10 s timeout could back the loop up
        # 2x per flush at the default 5 s interval)
        self._post_timeout = max(0.1, min(float(flush_interval_s), 5.0))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, args=(flush_interval_s,), daemon=True
        )
        self._thread.start()
        atexit.register(self.shutdown)

    def apply_resource_attributes(self, attrs: dict) -> None:
        """Merge process-wide resource attributes (replica identity)
        into this exporter's OTLP resource, last-write-wins by key.
        Copy-on-write: the flush thread serializes self._resource
        concurrently, so the merged document is built aside and
        swapped in with one atomic reference assignment — never
        mutated in place under a running json.dumps."""
        merged = [dict(ent) for ent in self._resource["attributes"]]
        for k, v in attrs.items():
            for ent in merged:
                if ent["key"] == k:
                    ent["value"] = {"stringValue": str(v)}
                    break
            else:
                merged.append({"key": k, "value": {"stringValue": str(v)}})
        self._resource = {"attributes": merged}

    # --- span intake (called from span()'s exit path) ---
    def record_span(self, name, start_unix_ns, end_unix_ns, trace_id, span_id, parent_span_id, attrs):
        doc = {
            "traceId": _hex(trace_id, 32),
            "spanId": _hex(span_id, 16),
            "name": name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(start_unix_ns),
            "endTimeUnixNano": str(end_unix_ns),
            "attributes": [
                {"key": k, "value": self._any_value(v)} for k, v in attrs.items()
            ],
        }
        if parent_span_id is not None:
            doc["parentSpanId"] = _hex(parent_span_id, 16)
        dropped = 0
        with self._lock:
            self._spans.append(doc)
            overflow = len(self._spans) - self.MAX_BUFFERED_SPANS
            if overflow > 0:
                del self._spans[:overflow]
                dropped = overflow
        if dropped:
            from . import metrics

            metrics.otlp_spans_dropped_total.add(dropped)

    @staticmethod
    def _any_value(v):
        if isinstance(v, bool):
            return {"boolValue": v}
        if isinstance(v, int):
            return {"intValue": str(v)}
        if isinstance(v, float):
            return {"doubleValue": v}
        return {"stringValue": str(v)}

    # --- export ---
    def _post(self, path: str, doc: dict) -> None:
        import urllib.request

        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self._post_timeout) as resp:
                resp.read()
        except Exception:
            logging.getLogger(__name__).debug("OTLP export to %s failed", path, exc_info=True)

    def flush(self) -> None:
        with self._lock:
            spans, self._spans = self._spans, []
        if spans:
            self._post(
                "/v1/traces",
                {
                    "resourceSpans": [
                        {
                            "resource": self._resource,
                            "scopeSpans": [
                                {"scope": {"name": "janus_tpu"}, "spans": spans}
                            ],
                        }
                    ]
                },
            )
        metrics_doc = self._metrics_snapshot()
        if metrics_doc is not None:
            self._post("/v1/metrics", metrics_doc)

    def _metrics_snapshot(self) -> dict | None:
        from . import metrics as m

        now = str(time.time_ns())

        def attrs(labels):
            return [{"key": k, "value": {"stringValue": v}} for k, v in labels]

        out = []
        # metrics_list() copies under the registry lock: iterating
        # _metrics directly races a concurrent counter()/histogram()
        # registration ("dictionary changed size during iteration")
        for metric in m.REGISTRY.metrics_list():
            if isinstance(metric, m.Counter):
                with metric._lock:
                    items = sorted(metric._values.items())
                points = [
                    {"attributes": attrs(k), "timeUnixNano": now, "asDouble": v}
                    for k, v in items
                ]
                if points:
                    out.append(
                        {
                            "name": metric.name,
                            "sum": {
                                "dataPoints": points,
                                "aggregationTemporality": 2,  # CUMULATIVE
                                "isMonotonic": True,
                            },
                        }
                    )
            elif isinstance(metric, m.Gauge):
                with metric._lock:
                    items = sorted(metric._values.items())
                points = [
                    {"attributes": attrs(k), "timeUnixNano": now, "asDouble": v}
                    for k, v in items
                ]
                if points:
                    out.append({"name": metric.name, "gauge": {"dataPoints": points}})
            elif isinstance(metric, m.Histogram):
                points = []
                with metric._lock:
                    for key in sorted(metric._counts):
                        # OTLP bucket_counts are PER-BUCKET (unlike
                        # Prometheus's cumulative buckets); the last
                        # entry is the +Inf overflow
                        per_bucket = list(metric._counts[key])
                        overflow = metric._totals[key] - sum(per_bucket)
                        counts = [str(c) for c in per_bucket] + [str(overflow)]
                        points.append(
                            {
                                "attributes": attrs(key),
                                "timeUnixNano": now,
                                "count": str(metric._totals[key]),
                                "sum": metric._sums[key],
                                "bucketCounts": counts,
                                "explicitBounds": list(metric.buckets),
                            }
                        )
                if points:
                    out.append(
                        {
                            "name": metric.name,
                            "histogram": {"dataPoints": points, "aggregationTemporality": 2},
                        }
                    )
        if not out:
            return None
        return {
            "resourceMetrics": [
                {
                    "resource": self._resource,
                    "scopeMetrics": [{"scope": {"name": "janus_tpu"}, "metrics": out}],
                }
            ]
        }

    def _loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            try:
                self.flush()
            except Exception:
                # the flusher must outlive any single bad export
                logging.getLogger(__name__).debug("OTLP flush failed", exc_info=True)

    def shutdown(self) -> None:
        self._stop.set()
        self.flush()


_chrome_writer: ChromeTraceWriter | None = None
_otlp_exporter: OtlpExporter | None = None


def install_otlp_export(endpoint: str, flush_interval_s: float = 5.0) -> OtlpExporter:
    """Install the process-wide OTLP exporter (spans + metrics)."""
    global _otlp_exporter
    if _otlp_exporter is not None:
        _otlp_exporter.shutdown()
    _otlp_exporter = OtlpExporter(endpoint, flush_interval_s=flush_interval_s)
    return _otlp_exporter


@contextmanager
def scoped_chrome_trace(path: str):
    """Temporarily route host spans to a fresh Chrome trace file (the
    /debug/profile capture window), restoring any configured writer on
    exit. Unlike install_chrome_trace the path is used verbatim — the
    caller owns the artifact name."""
    global _chrome_writer
    prev = _chrome_writer
    w = ChromeTraceWriter(path)
    _chrome_writer = w
    try:
        yield path
    finally:
        _chrome_writer = prev
        w.close()


def install_chrome_trace(path: str) -> None:
    """Install the process-wide span writer. The PID is embedded in the
    filename: several processes sharing one configured path (leader +
    helper on a host) must not truncate/interleave each other's files."""
    global _chrome_writer
    root, ext = os.path.splitext(path)
    path = f"{root}.{os.getpid()}{ext or '.json'}"
    if _chrome_writer is not None:
        _chrome_writer.close()
    _chrome_writer = ChromeTraceWriter(path)
    atexit.register(_chrome_writer.close)


# ---------------------------------------------------------------------------
# W3C traceparent propagation (the OTLP-shaped analog of the reference's
# OpenTelemetry layer, trace.rs:44-90): every span carries
# (trace_id, span_id, parent_span_id); the HTTP client attaches the
# current context as a `traceparent` header and the DAP server adopts an
# incoming one, so one trace stitches upload -> init -> continue across
# leader and helper processes.
# ---------------------------------------------------------------------------

import contextvars


# (trace_id, span_id) of the active span, per task/thread: ints for
# locally-generated ids (hex-formatted lazily by _hex), hex strings
# when adopted from an incoming traceparent header
_trace_ctx: contextvars.ContextVar[tuple[int | str, int | str] | None] = (
    contextvars.ContextVar("janus_trace_ctx", default=None)
)


def _hex(v, width: int) -> str:
    # ids live in the contextvar as ints (locally generated, formatted
    # lazily) or as hex strings (adopted from an incoming header)
    return v if isinstance(v, str) else f"{v:0{width}x}"


def current_traceparent() -> str | None:
    """W3C traceparent header for the active span, or None."""
    ctx = _trace_ctx.get()
    if ctx is None:
        return None
    return f"00-{_hex(ctx[0], 32)}-{_hex(ctx[1], 16)}-01"


_HEX_DIGITS = frozenset("0123456789abcdef")


def _parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """(trace_id, span_id) from a W3C traceparent, or None when the
    header is absent/malformed. Per the spec, ids must be lowercase hex
    and non-zero, the version 2 hex digits != 'ff', flags 2 hex."""
    if not header:
        return None
    parts = header.split("-")
    if (
        len(parts) == 4
        and len(parts[0]) == 2
        and len(parts[1]) == 32
        and len(parts[2]) == 16
        and len(parts[3]) == 2
        and set(parts[0]) <= _HEX_DIGITS
        and set(parts[1]) <= _HEX_DIGITS
        and set(parts[2]) <= _HEX_DIGITS
        and set(parts[3]) <= _HEX_DIGITS
        and parts[0] != "ff"  # W3C: version 0xff is invalid
        and set(parts[1]) != {"0"}
        and set(parts[2]) != {"0"}
    ):
        return parts[1], parts[2]
    return None


def trace_id_of(header: str | None) -> str | None:
    """Validated trace id of a traceparent header (the persisted
    trace_context column), or None — the one place that parses it for
    display/linking (driver linked_traces, tests)."""
    parsed = _parse_traceparent(header)
    return parsed[0] if parsed else None


def adopt_traceparent(header: str | None):
    """Enter the trace context of an incoming request (or clear it if
    the header is absent/malformed — the handler's span then starts a
    fresh trace as a true root, with no phantom parent). Returns a
    token for contextvars reset."""
    parsed = _parse_traceparent(header)
    if parsed is not None:
        return _trace_ctx.set(parsed)
    return _trace_ctx.set(None)


def reset_traceparent(token) -> None:
    _trace_ctx.reset(token)


@contextmanager
def use_traceparent(header: str | None):
    """Run the body under a PERSISTED trace context (the datastore
    `trace_context` column on aggregation/collection jobs): spans opened
    inside become children of the span that created the job — across
    processes and across driver restarts, because the header round-trips
    through the database rather than living in any process. A falsy
    header is a no-op (the caller's ambient context is preserved), so
    rows written before the column existed keep today's behavior."""
    if not header:
        yield
        return
    token = adopt_traceparent(header)
    try:
        yield
    finally:
        _trace_ctx.reset(token)


def current_context():
    """Opaque trace context of the calling thread (for handing work to
    another thread — e.g. the ingest pipeline's stage workers — so their
    spans parent under the originating request's span)."""
    return _trace_ctx.get()


@contextmanager
def use_context(ctx):
    """Run the body under a trace context captured with
    current_context() on a different thread."""
    token = _trace_ctx.set(ctx)
    try:
        yield
    finally:
        _trace_ctx.reset(token)


# ---------------------------------------------------------------------------
# span -> metric bridge: a span NAME registered here records its
# duration into a histogram on exit, so the trace timeline and the
# Prometheus series measure the same boundaries by construction
# (registrations live next to the histogram definitions, metrics.py).
# Unregistered spans pay one dict lookup on exit.
# ---------------------------------------------------------------------------

_span_metrics: dict[str, tuple] = {}

# span name -> [fn(dur_s, args)] side-channel hooks: the device cost
# ledger (janus_tpu_torch/profiler.py) attributes the engine put/fetch spans'
# wall time to its h2d/d2h phases through these, so the ledger and the
# trace timeline measure the same boundaries by construction. A hook
# must never raise into the span exit path.
_span_hooks: dict[str, list] = {}


def register_span_metric(
    span_name: str, histogram, labels: dict | None = None, arg_labels: tuple = ()
) -> None:
    """Record every exit of span `span_name` into `histogram`:
    `labels` attach verbatim; each name in `arg_labels` is copied from
    the span's kwargs when present (e.g. vdaf=...)."""
    _span_metrics[span_name] = (histogram, dict(labels or {}), tuple(arg_labels))


def register_span_hook(span_name: str, fn) -> None:
    """Call `fn(dur_s, args)` on every exit of span `span_name`
    (in addition to any register_span_metric binding)."""
    _span_hooks.setdefault(span_name, []).append(fn)


def _bridge_span(name: str, dur_s: float, args: dict, trace_id=None) -> None:
    hooks = _span_hooks.get(name)
    if hooks is not None:
        for fn in hooks:
            try:
                fn(dur_s, args)
            except Exception:
                logging.getLogger(__name__).exception(
                    "span hook for %s failed", name
                )
    reg = _span_metrics.get(name)
    if reg is None:
        return
    hist, static, arg_labels = reg
    labels = dict(static)
    for k in arg_labels:
        v = args.get(k)
        if v is not None:
            labels[k] = str(v)
    # the exiting span's trace id rides the histogram sample as an
    # OpenMetrics exemplar (metrics.Histogram.observe), so a latency
    # bucket jump resolves to a concrete /debug/traces capture
    hist.observe(dur_s, exemplar_trace_id=trace_id, **labels)


# ---------------------------------------------------------------------------
# Flight recorder: an always-on, bounded, in-process ring of completed
# spans. Unlike the Chrome/OTLP writers (opt-in, file/network), this is
# always armed, so "where did THIS report's time go" is answerable
# after the fact without having pre-arranged a capture window:
#
#   - a deque ring of the last N completed spans (GIL-atomic appends —
#     no lock on the ring itself),
#   - per-name streaming latency digests (log2-microsecond buckets ->
#     p50/p95/p99 without storing samples),
#   - slow-op capture: when a ROOT span exceeds its per-name threshold,
#     the whole span tree still present in the ring is retained in a
#     separate bounded buffer (children complete before their root, so
#     the tree is intact unless ring churn evicted it first).
#
# Served as GET /debug/traces on every binary's health listener and as
# a /statusz section (binary_utils.HealthServer).
# ---------------------------------------------------------------------------

# log2(microsecond) duration buckets: index i covers [2^i, 2^(i+1)) µs;
# 40 buckets reach ~12.7 days — far past any span this system emits
_DIGEST_BUCKETS = 40


class _NameDigest:
    __slots__ = ("count", "errors", "sum_s", "buckets")

    def __init__(self):
        self.count = 0
        self.errors = 0
        self.sum_s = 0.0
        self.buckets = [0] * _DIGEST_BUCKETS

    def observe(self, dur_s: float, error: bool) -> None:
        us = dur_s * 1e6
        idx = 0 if us < 2.0 else min(int(us).bit_length() - 1, _DIGEST_BUCKETS - 1)
        self.buckets[idx] += 1
        self.count += 1
        self.sum_s += dur_s
        if error:
            self.errors += 1

    def quantile(self, q: float) -> float:
        """Upper bound (seconds) of the bucket holding the q-quantile."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.buckets):
            cum += c
            if cum >= target:
                return (1 << (i + 1)) / 1e6
        return (1 << _DIGEST_BUCKETS) / 1e6

    def doc(self) -> dict:
        return {
            "count": self.count,
            "errors": self.errors,
            "mean_s": round(self.sum_s / self.count, 6) if self.count else 0.0,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }


class FlightRecorder:
    """See the section comment above. `capacity` defaults to 512 spans
    and the slow threshold to 1 s."""

    def __init__(
        self,
        capacity: int | None = None,
        slow_capacity: int = 8,
        slow_threshold_s: float | None = None,
    ):
        if capacity is None:
            capacity = 512
        self.capacity = max(16, capacity)
        if slow_threshold_s is None:
            slow_threshold_s = 1.0
        self.default_slow_threshold_s = slow_threshold_s
        # ring entries: (name, trace_id, span_id, parent_span_id,
        # start_unix_ns, dur_s, args, error) — ids raw (int | hex str),
        # hex-formatted only at snapshot time to keep record() cheap
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._slow: collections.deque = collections.deque(maxlen=max(1, slow_capacity))
        self._slow_thresholds: dict[str, float] = {}
        self._digests: dict[str, _NameDigest] = {}
        # guards digests + slow capture only; the ring rides the GIL
        self._lock = threading.Lock()
        self._recorded = 0

    def set_slow_threshold(self, name: str, seconds: float) -> None:
        """Per-root-span-name slow-capture threshold: a root span of
        `name` lasting >= `seconds` captures its tree. 0 captures every
        root span of that name (tests); negative disables the name."""
        self._slow_thresholds[name] = float(seconds)

    def record(
        self, name, trace_id, span_id, parent_span_id, start_unix_ns, dur_s, args, error
    ) -> None:
        entry = (name, trace_id, span_id, parent_span_id, start_unix_ns, dur_s, args, error)
        self._ring.append(entry)
        with self._lock:
            self._recorded += 1
            digest = self._digests.get(name)
            if digest is None:
                digest = self._digests[name] = _NameDigest()
            digest.observe(dur_s, error is not None)
            # slow capture triggers on LOCAL roots: spans with no parent
            # at all, or whose parent is remote (hex-string ids adopted
            # from a traceparent header / persisted trace_context —
            # locally generated parents are ints). Without the latter, a
            # driver step's work spans — all children of the persisted
            # creator span — could never trigger capture in THIS process.
            if parent_span_id is None or isinstance(parent_span_id, str):
                threshold = self._slow_thresholds.get(name, self.default_slow_threshold_s)
                if 0 < threshold <= dur_s or (threshold == 0.0 and name in self._slow_thresholds):
                    # whole tree still in the ring (children completed
                    # first); list() snapshots the deque atomically
                    tree = [e for e in list(self._ring) if e[1] == trace_id]
                    self._slow.append(
                        {
                            "root": name,
                            "trace_id": _hex(trace_id, 32),
                            "duration_s": round(dur_s, 6),
                            "threshold_s": threshold,
                            "captured_unix_ns": start_unix_ns + int(dur_s * 1e9),
                            "spans": [self._entry_doc(e) for e in tree],
                        }
                    )

    @staticmethod
    def _entry_doc(entry) -> dict:
        name, trace_id, span_id, parent, start_ns, dur_s, args, error = entry
        doc = {
            "name": name,
            "trace_id": _hex(trace_id, 32),
            "span_id": _hex(span_id, 16),
            "start_unix_ns": str(start_ns),
            "duration_s": round(dur_s, 6),
        }
        if parent is not None:
            doc["parent_span_id"] = _hex(parent, 16)
        if args:
            doc["args"] = {k: v for k, v in args.items()}
        if error is not None:
            doc["error"] = error
        return doc

    def snapshot(self, recent_limit: int = 100) -> dict:
        """The /debug/traces payload: recent spans (newest last), the
        captured slow traces, and the per-name latency digests. Every
        span implicitly carries the process resource attributes
        (replica identity in a fleet) — surfaced once at the top, OTLP
        resource-semantics style, instead of per span."""
        recent = list(self._ring)[-recent_limit:] if recent_limit > 0 else []
        with self._lock:
            digests = {name: d.doc() for name, d in sorted(self._digests.items())}
            slow = list(self._slow)
        return {
            "recorded_total": self._recorded,
            "capacity": self.capacity,
            "default_slow_threshold_s": self.default_slow_threshold_s,
            "resource": dict(_resource_attributes),
            "recent": [self._entry_doc(e) for e in recent],
            "slow_traces": slow,
            "digests": digests,
        }

    def status(self) -> dict:
        """The compact /statusz section (no span bodies)."""
        with self._lock:
            digests = {name: d.doc() for name, d in sorted(self._digests.items())}
            slow = len(self._slow)
        return {
            "recorded_total": self._recorded,
            "ring": len(self._ring),
            "capacity": self.capacity,
            "slow_traces_captured": slow,
            "default_slow_threshold_s": self.default_slow_threshold_s,
            "names": digests,
        }


_flight_recorder = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-wide always-on recorder."""
    return _flight_recorder


# Process-wide resource attributes (OTLP resource semantics: they apply
# to every span this process emits). janus_main stamps the fleet
# replica identity here so traces from N replicas over one datastore
# stay attributable; /debug/traces surfaces them in its snapshot and
# the OTLP exporter merges them into resourceSpans.resource.
_resource_attributes: dict[str, str] = {}


def set_resource_attributes(**attrs) -> None:
    """Set/overwrite process-wide trace resource attributes (e.g.
    replica="replica-3"). Applied to the flight-recorder snapshot and
    to any OTLP exporter installed now or later."""
    for k, v in attrs.items():
        _resource_attributes[str(k)] = str(v)
    exporter = _otlp_exporter
    if exporter is not None:
        exporter.apply_resource_attributes(_resource_attributes)


def resource_attributes() -> dict:
    return dict(_resource_attributes)


# span-error counter resolved lazily (importing metrics at module level
# would cycle: metrics.py binds span names via register_span_metric at
# its import tail)
_span_errors_counter = None


def _count_span_error(name: str) -> None:
    global _span_errors_counter
    c = _span_errors_counter
    if c is None:
        from . import metrics

        c = _span_errors_counter = metrics.span_errors_total
    c.add(name=name)


@contextmanager
def span(name: str, **args):
    """Record a host-side span. The always-on flight recorder and the
    trace-context bookkeeping for traceparent propagation run on every
    span (contextvar ops, a PRNG draw, a deque append and a digest
    update — chip_smoke.py's observability line measures it; hex
    formatting is deferred to emission/snapshot time; ids need
    uniqueness, not unpredictability, so this is random.getrandbits,
    not a urandom syscall). Chrome/OTLP emission additionally runs when
    those writers are installed. Span names registered with
    register_span_metric also record their duration into the bound
    histogram on exit. An exception exiting the span is recorded as an
    `error=<ExcType>` attribute on every emitted event and counted in
    janus_span_errors_total{name} — then re-raised."""
    parent = _trace_ctx.get()
    trace_id = parent[0] if parent else _span_rng.getrandbits(128)
    span_id = _span_rng.getrandbits(64)
    token = _trace_ctx.set((trace_id, span_id))
    w = _chrome_writer
    ox = _otlp_exporter
    t0 = time.perf_counter_ns()
    e0 = time.time_ns()
    err_name = None
    try:
        yield
    except BaseException as e:
        err_name = type(e).__name__
        raise
    finally:
        t1 = time.perf_counter_ns()
        _trace_ctx.reset(token)
        if err_name is not None:
            args["error"] = err_name  # kwargs dict is per-call: safe to mutate
            _count_span_error(name)
        dur_s = (t1 - t0) / 1e9
        if _span_metrics or _span_hooks:
            _bridge_span(name, dur_s, args, trace_id)
        _flight_recorder.record(
            name, trace_id, span_id, parent[1] if parent else None,
            e0, dur_s, args, err_name,
        )
        if w is not None:
            w.event(
                name,
                t0 / 1000.0,
                (t1 - t0) / 1000.0,
                {
                    **args,
                    "trace_id": _hex(trace_id, 32),
                    "span_id": _hex(span_id, 16),
                    **({"parent_span_id": _hex(parent[1], 16)} if parent else {}),
                },
            )
        if ox is not None:
            ox.record_span(
                name, e0, e0 + (t1 - t0), trace_id, span_id,
                parent[1] if parent else None, args,
            )


def record_operation(name: str, dur_s: float, **args) -> None:
    """Feed a completed cross-thread operation into the flight
    recorder's per-name digests (and the span->metric bridge) without a
    live span context. The step pipeline uses it for the end-to-end
    "job.step" duration: the stages run on different threads, so no
    single span() block can cover the whole step, but the digest —
    which a served benchmark reads for the p50/p95 aggregation-
    job-step SLO — must still see one observation per stepped job."""
    trace_id = _span_rng.getrandbits(128)
    if _span_metrics or _span_hooks:
        # the synthesized trace id still resolves: the recorder ring
        # entry below carries the same id, so a bridged exemplar from a
        # cross-thread operation links to its /debug/traces record
        _bridge_span(name, dur_s, args, trace_id)
    _flight_recorder.record(
        name,
        trace_id,
        _span_rng.getrandbits(64),
        None,
        time.time_ns() - int(dur_s * 1e9),
        dur_s,
        args,
        args.get("error"),
    )


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        # correlate structured logs with traces: a log line emitted
        # under an active span carries its ids (docs/OBSERVABILITY.md)
        ctx = _trace_ctx.get()
        if ctx is not None:
            doc["trace_id"] = _hex(ctx[0], 32)
            doc["span_id"] = _hex(ctx[1], 16)
        if record.exc_info:
            doc["exception"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def install_trace_subscriber(config: TraceConfiguration | None = None) -> None:
    """Install the root logging handler (idempotent)."""
    config = config or TraceConfiguration()
    if config.chrome_trace_file:
        install_chrome_trace(config.chrome_trace_file)
    if config.otlp_endpoint:
        install_otlp_export(config.otlp_endpoint)
    level = config.level.upper()
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    if config.force_json_output:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    root.addHandler(handler)


# /statusz section: the flight recorder's compact summary on every
# binary (the full payload is GET /debug/traces on the health listener)
from .statusz import register_status_provider as _register_status_provider

_register_status_provider("flight_recorder", lambda: _flight_recorder.status())
