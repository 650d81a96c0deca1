"""Binary harness shared by the service processes, and the port's HTTP
serving utilities.

The port's own copy of janus_tpu/binary_utils.py (the reference's
aggregator/src/binary_utils.rs): `janus_main` (config, trace subscriber,
metrics, the device, the datastore, then the binary's body), the health
listener `HealthServer` (/healthz, /readyz, /metrics, /statusz, /alertz,
/debug/*), the readiness registry, SIGTERM -> Stopper graceful shutdown,
`warmup_engines` and the on-demand profiler capture, plus
`BoundedThreadingHTTPServer` and `LongHeaderLines`, the handler mixin that
lets a request carry a header line longer than http.server's 64 KiB.

Datastore keys come from --datastore-keys or the DATASTORE_KEYS
environment variable (comma-separated base64, the first key primary),
matching the reference's k8s-secret pathway.

The boot sequence is janus_tpu's: config, `backend_init`, the datastore,
then the cold-start layer: the shape manifest installed (boot phase
`engine_warm_manifest`), the `engine_prewarm` readiness check registered,
the manifest's specializations replayed by `prewarm_engines` before the
listener is up (`ready` is set whatever happens, so a failed prewarm
cannot wedge /readyz), then `warmup_engines`, which skips a bucket the
prewarm already dispatched in this process (`skipped_covered`).

Where janus_tpu differs: the device is `device:` from the configuration,
resolved first (no CUDA and no `device:` refuses the boot); the boot
phase `backend_init` is the CUDA context and the kernel libraries'
build or load (ops/cuda_build.py) through the kernel-library cache that
the compile cache directory arms (aggregator/aot_cache.py, in
`<dir>/aot`), where janus_tpu's is its XLA compile cache and AOT
executables; the `process` statusz section carries
`torch` (its version and CUDA version), the devices and the device's name;
the capture window is a torch.profiler window (CUDA activity on a CUDA
process), and a CUDA profiler that cannot start fails the request (500)
instead of answering with a host-only trace; the watchdog, canary, mesh
and resident settings come from the YAML alone (no JANUS_* override).
"""

from __future__ import annotations

import argparse
import base64
import http.client
import io
import json
import logging
import os
import signal
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qsl, urlsplit

from .aggregator import aot_cache
from .aggregator import prewarm as prewarm_mod
from .aggregator import shape_manifest as shape_manifest_mod
from .aggregator.job_driver import Stopper
from .config import CommonConfig, load_config
from .core.time_util import RealClock
from .datastore.store import Crypter, open_datastore
from .metrics import REGISTRY
from .ops import cuda_build
from .statusz import register_status_provider, render_statusz_html, status_snapshot
from .trace import install_trace_subscriber

log = logging.getLogger(__name__)

# A dap-taskprov header carries a whole base64url TaskConfig: a
# Prio3Histogram of 10,000 buckets lists 9,999 u64 boundaries, about
# 106,700 characters, past http.server's 65,536-byte header line limit
# (janus_tpu's server refuses it). The port's server reads lines up to this.
MAX_HEADER_LINE = 1 << 20
MAX_HEADERS = 100




class LongHeaderLines:
    """BaseHTTPRequestHandler mixin: reads the header block with lines up
    to MAX_HEADER_LINE bytes. A line over http.client's limit reaches the
    stdlib parser as a placeholder and its value is put back after it, so
    everything else (the Connection and Expect handling, the message
    class) is the stdlib's."""

    def parse_request(self):
        rfile = self.rfile
        lines, long_values = [], {}
        while True:
            line = rfile.readline(MAX_HEADER_LINE + 1)
            if len(line) > MAX_HEADER_LINE:
                return self._refuse("Line too long")
            if len(line) > http.client._MAXLINE:
                name, _, value = line.partition(b":")
                token = b"long-header-line-%d" % len(long_values)
                long_values[token.decode()] = (name.decode("latin-1").strip(), value.decode("latin-1").strip())
                line = name + b": " + token + b"\r\n"
            lines.append(line)
            if len(lines) > MAX_HEADERS:
                return self._refuse("Too many headers")
            if line in (b"\r\n", b"\n", b""):
                break
        self.rfile = io.BytesIO(b"".join(lines))
        try:
            ok = super().parse_request()
        finally:
            self.rfile = rfile
        if ok:
            for token, (name, value) in long_values.items():
                if self.headers.get(name) == token:
                    self.headers.replace_header(name, value)
        return ok

    def _refuse(self, message: str) -> bool:
        # the fields the stdlib's parse_request sets before it reads headers
        self.requestline = str(self.raw_requestline, "iso-8859-1").rstrip("\r\n")
        words = self.requestline.split()
        self.command = words[0] if words else None
        self.request_version = words[-1] if len(words) == 3 else self.default_request_version
        self.close_connection = True
        self.send_error(HTTPStatus.REQUEST_HEADER_FIELDS_TOO_LARGE, message)
        return False


class BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a fixed handler pool instead of a thread
    per connection: accepted connections are served by at most
    `max_handler_threads` workers; excess connections wait in the accept
    backlog or the pool queue."""

    # deep listen backlog: bursts of short-lived connections otherwise
    # overflow the default 5-entry accept queue into resets
    request_queue_size = 128

    def __init__(self, addr, handler_cls, max_handler_threads: int = 32):
        super().__init__(addr, handler_cls)
        self._max_handler_threads = max(1, max_handler_threads)
        self._active_connections = 0
        self._active_lock = threading.Lock()
        # accept time per connection (weak: entries vanish with the socket)
        self._accept_times = weakref.WeakKeyDictionary()
        self._pool = ThreadPoolExecutor(max_workers=self._max_handler_threads, thread_name_prefix="dap-handler")

    def queue_age_s(self, request) -> float | None:
        """Seconds `request` (a connection socket) waited between accept
        and a handler picking it up, once: later keep-alive requests on
        the same connection read None."""
        t = self._accept_times.pop(request, None)
        return None if t is None else time.monotonic() - t

    @property
    def saturated(self) -> bool:
        """Every pool worker is occupied by a connection; handlers then
        drop keep-alive so idle clients cannot pin every worker."""
        return self._active_connections >= self._max_handler_threads

    def process_request(self, request, client_address):
        try:
            self._accept_times[request] = time.monotonic()
        except TypeError:  # a socket type that takes no weak reference
            pass
        try:
            self._pool.submit(self._process_in_pool, request, client_address)
        except RuntimeError:  # pool already shut down (server closing)
            self.shutdown_request(request)

    def _process_in_pool(self, request, client_address):
        with self._active_lock:
            self._active_connections += 1
        try:
            self.finish_request(request, client_address)
        except Exception:
            self.handle_error(request, client_address)
        finally:
            with self._active_lock:
                self._active_connections -= 1
            self.shutdown_request(request)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# The health listener's discovery page
# ---------------------------------------------------------------------------

# Prometheus text exposition content type (version 0.0.4); the charset
# matters: label values may carry escaped non-ASCII task ids and errors
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# the OpenMetrics exposition (?openmetrics=1 or Accept-negotiated): the
# same families plus histogram exemplars and the # EOF terminator
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

# GET / on the health listener: a small discovery page, so an operator
# pointed at a port finds every endpoint from a browser
_INDEX_ENDPOINTS = (
    ("/healthz", "liveness (always 200 while the process runs)"),
    ("/readyz", "readiness (503 + JSON reasons while degraded)"),
    ("/metrics", "Prometheus text exposition"),
    ("/metrics?openmetrics=1", "OpenMetrics mode with trace exemplars"),
    ("/statusz", "process status snapshot (JSON; ?format=html)"),
    ("/alertz", "SLO burn-rate engine: alert state, budgets, evidence"),
    ("/debug/vars", "raw metrics-registry JSON dump"),
    ("/debug/traces", "flight recorder: recent spans, slow traces, digests"),
    ("/debug/profile", "continuous profiler: collapsed wall-clock stacks (flamegraph.pl)"),
    ("/debug/profile?format=json", "continuous profiler: per-role self/total shares"),
    ("/debug/boot", "boot-phase timeline (process start to /readyz ready)"),
    ("/debug/flight", "telemetry flight recorder: resource history, trend slopes, leak verdicts"),
    ("/debug/ledger", "report-flow conservation ledger: per-task balance, imbalance, breaches"),
)


def _render_index() -> bytes:
    import html as _html

    rows = "".join(
        f'<li><a href="{path}"><code>{_html.escape(path)}</code></a>'
        f" — {_html.escape(desc)}</li>"
        for path, desc in _INDEX_ENDPOINTS
    )
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>janus_tpu_torch health listener</title>"
        "<style>body{font-family:monospace;margin:2em;}li{margin:0.3em 0;}</style>"
        "</head><body><h1>janus_tpu_torch health listener</h1>"
        f"<ul>{rows}</ul>"
        "<p>POST /debug/profile?seconds=N opens an on-demand profiler "
        "capture window (torch.profiler; CUDA activity on a CUDA process).</p></body></html>"
    ).encode()


# ---------------------------------------------------------------------------
# Readiness registry: /healthz is liveness (the process is running:
# restarting it would not help), /readyz is readiness (this replica can do
# useful work now: take it out of rotation, do not kill it). A datastore
# outage fails readiness, never liveness: killing the process would also
# kill the upload spill journal's replayer.
# ---------------------------------------------------------------------------

_readiness_lock = threading.Lock()
_readiness_checks: dict[str, object] = {}


def register_readiness_check(name: str, fn) -> None:
    """Register (or replace) a readiness check: `fn()` returns None when
    ready, or a human-readable reason when not. A check that raises
    counts as not ready (with the exception as reason)."""
    with _readiness_lock:
        _readiness_checks[name] = fn


def unregister_readiness_check(name: str) -> None:
    with _readiness_lock:
        _readiness_checks.pop(name, None)


def readiness_snapshot() -> tuple[bool, dict]:
    """(ready, {check: reason}) across every registered check. No checks
    registered: ready."""
    with _readiness_lock:
        checks = dict(_readiness_checks)
    reasons: dict = {}
    for name, fn in sorted(checks.items()):
        try:
            reason = fn()
        except Exception as e:
            reason = f"readiness check failed: {type(e).__name__}: {e}"
        if reason:
            reasons[name] = str(reason)
    return not reasons, reasons


def parse_datastore_keys(raw: str) -> list[bytes]:
    """Comma-separated base64url AES-128 keys, the first primary."""
    keys = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        pad = "=" * (-len(part) % 4)
        keys.append(base64.urlsafe_b64decode(part + pad))
    if not keys:
        raise ValueError("at least one datastore key is required")
    for k in keys:
        if len(k) != 16:
            raise ValueError("datastore keys must be 16 bytes (AES-128-GCM)")
    return keys


def _split_hostport(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "0.0.0.0", int(port)


# ---------------------------------------------------------------------------
# On-demand profiler capture (POST /debug/profile?seconds=N): one window
# runs torch.profiler (CUDA activity where the process serves on CUDA, the
# host's operators otherwise; a Chrome trace loadable in Perfetto) beside a
# temporary host span Chrome-trace writer, and answers with the artifact
# paths. Guarded: a concurrent capture answers 409, the window is clamped.
# ---------------------------------------------------------------------------

PROFILE_MIN_SECONDS = 0.1
PROFILE_MAX_SECONDS = 60.0
_profile_lock = threading.Lock()


class ProfileBusy(RuntimeError):
    """A capture window is already open."""


def capture_profile(seconds: float, out_dir: str | None = None, devices=()) -> dict:
    """Open a capture window of `seconds` (clamped to [PROFILE_MIN_SECONDS,
    PROFILE_MAX_SECONDS]); raises ProfileBusy if one is open already.
    `devices` are the process's devices: where one is CUDA, the window
    records CUDA activity (the kernels every thread of the process
    launches), and a CUDA profiler that cannot start raises: there is no
    host-only fallback for a process on the card. Returns the artifact
    paths: the host span Chrome trace, and the device trace (torch's
    Chrome trace) in `device_trace_dir`."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, supported_activities

    from .trace import scoped_chrome_trace

    if not _profile_lock.acquire(blocking=False):
        raise ProfileBusy("a profile capture is already in progress")
    try:
        seconds = min(max(float(seconds), PROFILE_MIN_SECONDS), PROFILE_MAX_SECONDS)
        out_dir = out_dir or tempfile.mkdtemp(prefix="janus-profile-")
        os.makedirs(out_dir, exist_ok=True)
        host_trace = os.path.join(out_dir, "host-trace.json")
        device_dir = os.path.join(out_dir, "device")
        os.makedirs(device_dir, exist_ok=True)
        cuda = any(getattr(d, "type", None) == "cuda" for d in devices)
        if cuda:
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError("this process serves on CUDA and torch.profiler offers no CUDA activity")
            activities = [ProfilerActivity.CUDA]
        else:
            activities = [ProfilerActivity.CPU]
        prof = profile(activities=activities)
        prof.start()
        try:
            with scoped_chrome_trace(host_trace):
                time.sleep(seconds)
        finally:
            t0 = time.perf_counter()
            prof.stop()
            stop_s = time.perf_counter() - t0
        device_trace = os.path.join(device_dir, "trace.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(device_trace)
        return {
            "seconds": seconds,
            "host_chrome_trace": host_trace,
            "device_trace_dir": device_dir,
            "device_trace": device_trace,
            "activities": ["cuda" if a == ProfilerActivity.CUDA else "cpu" for a in activities],
            # the profiler's own cost after the window: collecting the
            # activity records, and writing the trace
            "stop_s": stop_s,
            "export_s": time.perf_counter() - t0,
        }
    finally:
        _profile_lock.release()


class HealthServer:
    """The per-process introspection listener:

      GET  /healthz                  -> 200 (liveness: always, while the
                                        process runs)
      GET  /readyz                   -> 200 when every registered readiness
                                        check passes; 503 with a JSON
                                        reason map while degraded
      GET  /metrics                  -> Prometheus text (?openmetrics=1:
                                        OpenMetrics with exemplars)
      GET  /statusz                  -> JSON status snapshot (HTML with
                                        ?format=html or Accept: text/html)
      GET  /alertz                   -> the SLO engine's alert document
      GET  /debug/vars               -> JSON dump of the metrics registry
      GET  /debug/profile            -> the sampling profiler's stacks
                                        (?format=json: role shares)
      GET  /debug/boot               -> the boot-phase timeline
      GET  /debug/traces             -> the span flight recorder
      GET  /debug/flight             -> the telemetry flight recorder
      GET  /debug/ledger             -> the conservation ledger
      GET  /                         -> the discovery page
      POST /debug/profile?seconds=N  -> on-demand profiler capture

    `devices` are the process's devices, for the capture window."""

    def __init__(self, addr: str, devices=()):
        host, port = _split_hostport(addr)
        devices = tuple(devices)

        class Handler(BaseHTTPRequestHandler):
            def _send(self, status: int, ctype: str, body: bytes) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, doc, status: int = 200, indent=None) -> None:
                self._send(status, "application/json", json.dumps(doc, indent=indent, default=str).encode())

            def do_GET(self):  # noqa: N802
                parts = urlsplit(self.path)
                query = dict(parse_qsl(parts.query))
                accept = self.headers.get("Accept") or ""
                if parts.path == "/healthz":
                    self._send(200, "text/plain", b"")
                elif parts.path in ("/", "/index.html"):
                    self._send(200, "text/html; charset=utf-8", _render_index())
                elif parts.path == "/alertz":
                    from .slo import alertz_snapshot

                    self._send_json(alertz_snapshot())
                elif parts.path == "/readyz":
                    ready, reasons = readiness_snapshot()
                    body = {"ready": ready}
                    if reasons:
                        body["reasons"] = reasons
                    self._send_json(body, 200 if ready else 503)
                elif parts.path == "/metrics":
                    openmetrics = query.get("openmetrics") == "1" or "application/openmetrics-text" in accept
                    self._send(
                        200,
                        OPENMETRICS_CONTENT_TYPE if openmetrics else METRICS_CONTENT_TYPE,
                        REGISTRY.render(openmetrics=openmetrics).encode(),
                    )
                elif parts.path == "/statusz":
                    snap = status_snapshot()
                    if query.get("format") == "html" or "text/html" in accept:
                        self._send(200, "text/html; charset=utf-8", render_statusz_html(snap).encode())
                    else:
                        self._send_json(snap, indent=2)
                elif parts.path == "/debug/vars":
                    self._send_json(REGISTRY.snapshot())
                elif parts.path == "/debug/profile":
                    # the always-on sampling profiler (the POST form of this
                    # path is the on-demand capture window)
                    from .profiler import profile_collapsed, profile_json

                    if query.get("format") == "json" or "application/json" in accept:
                        self._send_json(profile_json())
                    else:
                        self._send(200, "text/plain; charset=utf-8", profile_collapsed().encode())
                elif parts.path == "/debug/boot":
                    from .profiler import boot_snapshot

                    self._send_json(boot_snapshot())
                elif parts.path == "/debug/traces":
                    from .trace import flight_recorder

                    try:
                        limit = max(1, min(int(query.get("limit", "100")), 10_000))
                    except ValueError:
                        limit = 100
                    self._send_json(flight_recorder().snapshot(recent_limit=limit))
                elif parts.path == "/debug/flight":
                    from .flight_recorder import flight_document

                    try:
                        window_s = float(query["window_secs"])
                    except (KeyError, ValueError):
                        window_s = None
                    try:
                        max_points = max(1, min(int(query.get("max_points", "500")), 10_000))
                    except ValueError:
                        max_points = 500
                    self._send_json(flight_document(window_s=window_s, max_points=max_points))
                elif parts.path == "/debug/ledger":
                    from .ledger import ledger_document

                    self._send_json(ledger_document())
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):  # noqa: N802
                parts = urlsplit(self.path)
                if parts.path != "/debug/profile":
                    self._send(404, "text/plain", b"not found")
                    return
                query = dict(parse_qsl(parts.query))
                try:
                    seconds = float(query.get("seconds", "2"))
                except ValueError:
                    self._send(400, "text/plain", b"seconds must be a number")
                    return
                try:
                    result = capture_profile(seconds, devices=devices)
                except ProfileBusy as e:
                    self._send_json({"error": str(e)}, 409)
                    return
                except Exception:
                    log.exception("profile capture failed")
                    self._send(500, "text/plain", b"profile capture failed")
                    return
                self._send_json(result)

            def log_message(self, fmt, *args):
                pass

        # a small fixed pool: scrapes and probes are cheap, and the listener
        # must never grow threads either
        self._srv = BoundedThreadingHTTPServer((host, port), Handler, max_handler_threads=4)
        self._thread = threading.Thread(target=self._srv.serve_forever, name="health-listener", daemon=True)

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "HealthServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()


def setup_signal_handler(stopper) -> None:
    """SIGTERM/SIGINT -> cooperative stop (binary_utils.rs
    setup_signal_handler). Only callable from the main thread."""

    def handle(signum, frame):
        log.info("received signal %s, shutting down", signum)
        stopper.stop()
        # release threads parked by hang failpoints (a modelled device
        # wedge must not outlive the process's intent to exit)
        from . import failpoints

        failpoints.release_hangs()

    signal.signal(signal.SIGTERM, handle)
    signal.signal(signal.SIGINT, handle)


# ---------------------------------------------------------------------------
# Engine warmup. The port compiles nothing: an engine's first dispatch at
# a bucket loads PyTorch's CUDA modules for its ops, builds the engine's
# tables and warms the allocator, which the first job would otherwise
# wait for.
# ---------------------------------------------------------------------------


def warmup_engines_background(ds, buckets=None, devices=None) -> threading.Thread:
    """Warm each bucket in ascending order on a daemon thread while serving
    starts (small interactive buckets first)."""
    buckets = sorted(buckets or (None,), key=lambda b: b or 0)

    def work():
        for b in buckets:
            warmup_engines(ds, batch=b, devices=devices)

    t = threading.Thread(target=work, name="engine-warmup", daemon=True)
    t.start()
    return t


def warmup_engines(ds, batch: int | None = None, devices=None) -> dict:
    """One leader init, helper init and aggregate of every provisioned
    task's engine on `devices` (None: CUDA), before it serves.

    `batch` selects the batch size to warm. Without it, each task warms
    the sizes of its pending aggregation jobs (the buckets the next driver
    pass dispatches, at most four), or MIN_BUCKET where none is pending.
    A bucket whose three ops the engine has already dispatched in this
    process is skipped (`outcome="skipped_covered"`): the manifest prewarm
    warmed it. The warm is a real batch of that size through the engine's
    public entry points (the pipelined leader init from 2 x
    PIPELINE_CHUNK rows), where the prewarm replays single recorded
    dispatches. Fakes and Poplar1 (no Prio3 engine) are skipped.
    Failpoints stay inert throughout. Returns {"warmed": [(task_id,
    bucket)], "skipped_covered": n}."""
    import numpy as np

    from . import failpoints, metrics
    from .aggregator.engine_cache import MIN_BUCKET, bucket_size, engine_cache
    from .vdaf.testing import make_report_batch, random_measurements

    tasks = ds.run_tx(lambda tx: tx.get_tasks(), "warmup_list_tasks")
    pending: dict[bytes, list[int]] = {}
    if batch is None:
        try:
            pending = ds.run_tx(lambda tx: tx.get_pending_aggregation_job_sizes(), "warmup_job_sizes")
        except Exception:
            log.warning("pending aggregation job sizes unavailable; warming the minimum bucket", exc_info=True)
    # a bucket is skipped only where all three ops ran (a partial warm
    # would still pay the leader leg the aggregate needs)
    warm_ops = ("leader_init", "helper_init", "aggregate")
    result: dict = {"warmed": [], "skipped_covered": 0}
    with failpoints.suppressed():
        for task in tasks:
            if task.vdaf.kind.startswith("fake") or task.vdaf.kind == "poplar1":
                continue
            if batch is not None:
                sizes = [int(batch)]
            else:
                # one size per bucket, ascending, at most four
                by_bucket: dict[int, int] = {}
                for n in sorted(pending.get(task.task_id.data, [])):
                    by_bucket.setdefault(bucket_size(n), n)
                sizes = [by_bucket[b] for b in sorted(by_bucket)][:4] or [MIN_BUCKET]
            for warm_batch in sizes:
                b = bucket_size(warm_batch)
                try:
                    eng = engine_cache(task.vdaf, task.vdaf_verify_key, devices=devices)
                    if eng.dispatched_all(warm_ops, b):
                        result["skipped_covered"] += 1
                        metrics.engine_prewarm_total.add(outcome="skipped_covered")
                        continue
                    rng = np.random.default_rng(0)
                    meas = random_measurements(task.vdaf, warm_batch, rng)
                    args, _ = make_report_batch(task.vdaf, meas, seed=0, device=eng.device)
                    nonce, parts, lmeas, proof, blind0, hseed, blind1 = args
                    out0, _seed0, ver0, part0 = eng.leader_init(nonce, parts, lmeas, proof, blind0)
                    ok = np.ones(warm_batch, dtype=bool)
                    eng.helper_init(nonce, parts, hseed, blind1, ver0, part0, ok)
                    if task.vdaf.kind == "sparse_sumvec":
                        # block-sparse tasks never dispatch the dense
                        # aggregate: warm the scatter the resident merge and
                        # the classic sparse path share
                        from .vdaf.registry import circuit_for
                        from .vdaf.testing import sparse_compact_batch
                        from .vdaf.wire import flat_scatter_indices

                        _, block_idx = sparse_compact_batch(task.vdaf, meas)
                        eng.aggregate_sparse(out0, ok, flat_scatter_indices(block_idx, circuit_for(task.vdaf)))
                    else:
                        eng.aggregate(out0, ok)
                    result["warmed"].append((task.task_id, b))
                    log.info("warmed engines for task %s (%s) at bucket %d", task.task_id, task.vdaf.kind, b)
                except Exception:
                    log.exception("engine warmup failed for task %s", task.task_id)
    return result


def _backend_init(devices) -> None:
    """The CUDA context of each CUDA device, and every kernel library
    loaded from the build directory (the armed kernel-library cache, else
    janus_tpu_torch/_build/): the missing or refused ones built first, one
    nvcc per source, all together."""
    import torch

    cuda = [d for d in devices if d.type == "cuda"]
    if not cuda:
        return
    for d in dict.fromkeys(cuda):
        with torch.cuda.device(d):
            torch.zeros(1, device=d)
    cuda_build.build()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)


def _compile_cache_dir(common: CommonConfig) -> str | None:
    """The compile cache directory: `engine: compile_cache_dir` over the
    top-level `compilation_cache_dir`, as in janus_tpu."""
    d = common.engine.compile_cache_dir or common.compilation_cache_dir
    return os.path.expanduser(d) if d else None


def _manifest_path(common: CommonConfig) -> str | None:
    """`engine: shape_manifest_path`, else shape_manifest.jsonl in the
    compile cache directory; "" (or neither) is no manifest."""
    path = common.engine.shape_manifest_path
    if path is None:
        cache_dir = _compile_cache_dir(common)
        path = os.path.join(cache_dir, shape_manifest_mod.DEFAULT_FILENAME) if cache_dir else None
    return os.path.expanduser(path) if path else None


def configure_engines(common: CommonConfig) -> None:
    """The process-wide engine settings of a CommonConfig: the watchdog's
    abandoned-thread cap and hang bound, the quarantine canary's delay and
    timeout, and
    the `engine:` stanza's resident byte cap and mesh geometry pin."""
    from .aggregator import device_watchdog
    from .aggregator.engine_cache import EngineCache

    device_watchdog.configure(
        abandoned_thread_cap=common.watchdog_abandoned_thread_cap, hang_after_s=common.watchdog_hang_after_secs
    )
    EngineCache.QUARANTINE_CANARY_DELAY_SECS = common.quarantine_canary_delay_secs
    EngineCache.QUARANTINE_CANARY_TIMEOUT_SECS = common.quarantine_canary_timeout_secs
    if common.engine.resident_max_bytes:
        EngineCache.RESIDENT_MAX_BYTES = int(common.engine.resident_max_bytes)
    if common.engine.mesh_dp is not None:
        EngineCache.MESH_DP = int(common.engine.mesh_dp)
    if common.engine.mesh_sp is not None:
        EngineCache.MESH_SP = int(common.engine.mesh_sp)


def janus_main(description: str, config_cls, run, argv=None, install_signals: bool = True):
    """Shared entry point (reference binary_utils.rs janus_main).

    `run(cfg, ds, stopper)` is the binary body; this harness owns config
    parsing, logging, the device, the health/metrics listener, the
    datastore and signal handling. The device is resolved before anything
    else boots: a file without `device:` serves on CUDA and raises where
    there is none."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config-file", required=True, help="YAML configuration file")
    parser.add_argument(
        "--datastore-keys",
        default=os.environ.get("DATASTORE_KEYS", ""),
        help="comma-separated base64url AES-128 keys (or DATASTORE_KEYS env)",
    )
    args = parser.parse_args(argv)

    # the boot timeline: everything before this call (interpreter start,
    # the torch and package imports) is the "imports" phase; each later
    # phase_done closes the phase running since the previous mark, so the
    # phases tile process start -> ready
    from . import profiler as profiler_mod
    from .profiler import BOOT

    BOOT.phase_done("imports")

    cfg = load_config(args.config_file, config_cls)
    common: CommonConfig = cfg.common
    install_trace_subscriber(common.logging_config)
    if common.ignored_keys:
        log.info(
            "configuration keys with no counterpart in janus_tpu_torch, ignored: %s",
            ", ".join(common.ignored_keys),
        )
    devices = common.devices()

    import torch

    from .metrics import register_build_info, set_replica_identity

    def device_name(d) -> str:
        return torch.cuda.get_device_name(d) if d.type == "cuda" else d.type

    # janus_build_info's backend: the device this process serves on
    register_build_info(backend=device_name(devices[0]))

    # the fleet replica identity: janus_replica_info on every scrape; a
    # configured replica_id also labels the per-replica families and rides
    # every trace as a resource attribute
    fleet = common.fleet
    replica_id = fleet.resolved_replica_id()
    set_replica_identity(replica_id=fleet.replica_id, shard_index=fleet.shard_index, shard_count=fleet.shard_count)
    from .trace import set_resource_attributes

    set_resource_attributes(
        replica=replica_id,
        shard=f"{fleet.shard_index % max(1, fleet.shard_count)}/{fleet.shard_count}",
    )
    register_status_provider(
        "fleet",
        lambda: {
            "replica_id": replica_id,
            "configured": fleet.replica_id is not None,
            "shard_index": fleet.shard_index % max(1, fleet.shard_count),
            "shard_count": fleet.shard_count,
            "steal_after_secs": fleet.steal_after_secs,
        },
    )

    # fault injection: JANUS_FAILPOINTS wins over the YAML `failpoints:`;
    # unset arms nothing. Always on /statusz
    from . import failpoints

    failpoints.configure_from_env(default=common.failpoints)
    register_status_provider("failpoints", failpoints.status)

    # the device watchdog and the quarantine's canary
    from .aggregator import device_watchdog
    from .aggregator.engine_cache import shutdown_engines

    configure_engines(common)
    BOOT.phase_done("config")

    # the kernel-library cache: the compile cache directory arms it, so the
    # libraries build (cold) or load (warm) in <dir>/aot
    cache_dir = _compile_cache_dir(common)
    prewarm_mod.note_compile_cache(cache_dir)
    if cache_dir and common.engine.aot_cache:
        aot_cache.arm(os.path.join(cache_dir, "aot"))
    _backend_init(devices)
    BOOT.phase_done("backend_init")

    keys = parse_datastore_keys(args.datastore_keys)
    ds = open_datastore(common.database.url, Crypter(keys), RealClock())
    ds.slow_tx_warn_s = common.database.slow_tx_warn_secs
    ds.retry_max_interval_s = common.database.retry_max_interval_secs

    # datastore supervision: the probe thread's state machine, its statusz
    # section and the /readyz split (liveness stays up: an outage is a
    # reason to stop routing, never to kill the process)
    if common.database.health_probe_interval_secs > 0:
        supervisor = ds.start_supervision(
            probe_interval_s=common.database.health_probe_interval_secs,
            down_threshold=common.database.down_after_failures,
            reconnect_max_interval_s=common.database.reconnect_max_interval_secs,
        )
        register_readiness_check("datastore", supervisor.readiness)

    def _process_status():
        from . import __version__

        info = {
            "version": __version__,
            "role": description,
            "pid": os.getpid(),
            "config_file": args.config_file,
            "database_url": common.database.url,
            "devices": [str(d) for d in devices],
            "device_name": device_name(devices[0]),
            "torch": f"{torch.__version__} cuda {torch.version.cuda or 'none'}",
            "health_sampler_interval_s": common.health_sampler_interval_s,
            # each hand-written kernel's launches in this process (a dict
            # read under one lock)
            "kernel_launches": cuda_build.launch_totals(),
        }
        # the caching allocator's counts (host-side, no synchronization)
        cuda = [d for d in devices if d.type == "cuda"]
        if cuda:
            info["device_memory"] = {
                str(d): {
                    "allocated_bytes": torch.cuda.memory_allocated(d),
                    "peak_allocated_bytes": torch.cuda.max_memory_allocated(d),
                    "reserved_bytes": torch.cuda.memory_reserved(d),
                }
                for d in dict.fromkeys(cuda)
            }
        return info

    def _tasks_status():
        from .metrics import task_id_label

        tasks = ds.run_tx(lambda tx: tx.get_tasks(), "statusz_tasks")
        return [
            {
                "task_id": task_id_label(t.task_id.data),
                "role": t.role.name,
                "vdaf": t.vdaf.kind,
                "xof_mode": t.vdaf.xof_mode,
                "query_type": t.query_type.code,
            }
            for t in tasks
        ]

    register_status_provider("process", _process_status)
    register_status_provider("tasks", _tasks_status)
    BOOT.phase_done("datastore")

    # the shape manifest of observed dispatch specializations, and its
    # prewarm BEFORE the listener is up: /readyz never reports a process
    # ready whose first jobs would pay the recorded cold first calls
    manifest = None
    manifest_path = _manifest_path(common)
    if manifest_path:
        try:
            manifest = shape_manifest_mod.install_manifest(
                manifest_path, max_entries=common.engine.shape_manifest_max_entries
            )
        except Exception:
            log.exception("could not install the shape manifest at %s", manifest_path)
    BOOT.phase_done("engine_warm_manifest")

    prewarm_ready = threading.Event()
    register_readiness_check(
        "engine_prewarm",
        lambda: None if prewarm_ready.is_set() else "boot-budget engine prewarm still warming",
    )
    try:
        if common.engine.prewarm and manifest is not None:
            prewarm_mod.prewarm_engines(ds, manifest, boot_budget_s=common.engine.prewarm_boot_budget_secs,
                                        ready_event=prewarm_ready, devices=devices)
    except Exception:
        # counted (`failed` per entry) and logged; the process serves
        log.exception("manifest prewarm failed")
    finally:
        prewarm_ready.set()  # a disabled or failed prewarm never wedges /readyz
    if common.warmup_engines_at_boot:
        if common.warmup_buckets:
            # serve at once, warm the buckets behind
            warmup_engines_background(ds, common.warmup_buckets, devices=devices)
        else:
            warmup_engines(ds, devices=devices)
    BOOT.phase_done("engine_warm")

    # the SLO burn-rate engine behind GET /alertz and the `slo` section
    from . import slo as slo_mod

    slo_engine = None
    if common.slo.enabled:
        slo_engine = slo_mod.install_slo_engine(common.slo)

    # the always-on sampling profiler behind GET /debug/profile
    profiler_mod.install_profiler(common.profiler)

    # the telemetry flight recorder behind GET /debug/flight, feeding the
    # SLO engine's trend signal
    from . import flight_recorder as flight_mod

    flight_mod.install_flight_recorder(common.flight)

    stopper = Stopper()
    if install_signals:
        setup_signal_handler(stopper)
    health = HealthServer(common.health_check_listen_address, devices=devices).start()
    log.info("health/metrics listener on port %d", health.port)
    # the listener is up and every readiness check is live: /readyz
    # answers from here, so the boot record is sealed
    BOOT.phase_done("listener_up")
    BOOT.mark_ready()
    try:
        return run(cfg, ds, stopper)
    finally:
        health.stop()
        flight_mod.uninstall_flight_recorder()
        profiler_mod.uninstall_profiler()
        if slo_engine is not None:
            slo_mod.uninstall_slo_engine()
        # teardown order against interpreter finalization (a daemon thread
        # with device work queued while the interpreter finalizes can
        # crash in native code): (1) stop the engines' canary loops (a
        # bounded join of a probe in flight), (2) release hang-failpoint
        # wedges (they raise at their site), (3) let the watchdog's
        # abandoned workers retire, (4) close the datastore
        shutdown_engines(2.0)
        failpoints.release_hangs()
        device_watchdog.WATCHDOG.drain(2.0)
        unregister_readiness_check("engine_prewarm")
        shape_manifest_mod.uninstall_manifest()
        aot_cache.disarm()
        ds.close()
