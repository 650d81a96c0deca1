"""DAP HTTP layer: routes, media types, auth, admission, problem details.

Equivalent of reference aggregator/src/aggregator/http_handlers.rs:
205-268 on the Python stdlib threading HTTP server. The port's own copy
of janus_tpu/aggregator/http_handlers.py for the routes a leader needs
to take uploads and collections and a helper needs to answer a leader's
aggregation and aggregate-share requests:

  GET    /hpke_config?task_id=...
  PUT    /tasks/:task_id/reports
  PUT    /tasks/:task_id/aggregation_jobs/:aggregation_job_id
  POST   /tasks/:task_id/aggregation_jobs/:aggregation_job_id  (continue)
  PUT    /tasks/:task_id/collection_jobs/:collection_job_id
  POST   /tasks/:task_id/collection_jobs/:collection_job_id   (poll)
  DELETE /tasks/:task_id/collection_jobs/:collection_job_id
  POST   /tasks/:task_id/aggregate_shares
  GET    /tasks/:task_id/ledger   (the conservation ledger's peer read)

with janus_tpu's media-type check, aggregator and collector auth,
XOF-mode check, the poll's 202 with Retry-After and RFC 7807 problem
documents, byte for byte. Uploads flow through the
admission-controlled ingest pipeline (`ingest/`): a shed request answers
429 (capacity) or 503 (a propagated `DAP-Janus-Deadline` already spent)
with `Retry-After` before any decode, crypto or datastore work; admitted
uploads decode, decrypt and commit on the pipeline's workers while the
handler thread parks on its ticket. While the datastore supervisor
reports the database not up, the aggregate routes shed 503 with
`Retry-After` (uploads keep flowing into the spill journal), and so do
they, before any decode or HPKE work, while the task's engine refuses
dispatches (quarantined after a device hang, or the device down for the
process; a refusal raised later inside the handler answers the same). A
budget that dies inside the aggregate-init handler answers the
conclusive 408; a device hang inside it answers 500, as janus_tpu's
handler does.

Taskprov: with `Config.taskprov_enabled`, the helper's routes read the
`dap-taskprov` header (its SHA-256 must be the task ID), authorize the
leader as the task's taskprov peer instead of by a per-task token, and
provision the task on aggregate-init and aggregate-share; `hpke_config`
answers with the global HPKE configs for a task that is not provisioned
(yet). janus_tpu's leader driver sends no header of its own: a leader of
a taskprov task sends it through an HTTP client that attaches it
(`aggregator/testing.py` `TaskprovHeaderHttp`). `DapServer` reads header
lines up to 1 MiB (`binary_utils.LongHeaderLines`): the header of a
Prio3Histogram(10000) TaskConfig is ~106,700 characters, which
janus_tpu's server, on http.server's 64 KiB line limit, refuses.

Observability, as in janus_tpu: every request adopts an incoming
`traceparent` and runs under a `dap.<route>` span (so a helper's spans
carry the leader job's trace id), feeds the per-route request counter
and latency histogram (the request span's trace id as its exemplar),
and a shed counts in janus_upload_shed_total; the ingest pipeline's
occupancy is the statusz `ingest` section. The ledger route answers the
leader's reconciliation read behind the same aggregator auth as the
aggregation steps: this aggregator's per-(batch, parameter) aggregated
counts and its task counters, janus_tpu's JSON byte for byte.
"""

from __future__ import annotations

import base64
import hashlib
import json
import logging
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qsl, urlsplit

from .. import metrics
from ..binary_utils import BoundedThreadingHTTPServer, LongHeaderLines
from ..core import deadline as deadline_mod
from ..core.deadline import DEADLINE_EXCEEDED_STATUS, DeadlineExceeded
from ..ingest import AdmissionConfig, AdmissionController, IngestPipeline, ShedError
from ..messages import (
    AggregateShareReq,
    AggregationJobContinueReq,
    AggregationJobId,
    AggregationJobInitializeReq,
    CollectionJobId,
    CollectionReq,
    HpkeConfigList,
    Report,
    Role,
    TaskId,
)
from ..messages.codec import DecodeError
from ..messages.problem_type import DapProblemType
from ..messages.taskprov import TASKPROV_HEADER, TaskConfig
from ..statusz import register_status_provider
from ..trace import adopt_traceparent, current_context, reset_traceparent, span
from .core import Aggregator
from .device_watchdog import DeviceQuarantinedError
from .errors import AggregatorError, InvalidMessage, UnrecognizedTask

# Advertises the sender's XOF framing mode on aggregation-job requests so
# a leader/helper mode mismatch fails loudly instead of rejecting every
# report.
XOF_MODE_HEADER = "janus-xof-mode"

log = logging.getLogger(__name__)


def _b64dec(s: str, size: int) -> bytes:
    raw = base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
    if len(raw) != size:
        raise DecodeError(f"bad id length {len(raw)}")
    return raw


_ROUTES = [
    ("GET", re.compile(r"^/hpke_config$"), "hpke_config"),
    ("PUT", re.compile(r"^/tasks/([^/]+)/reports$"), "upload"),
    ("PUT", re.compile(r"^/tasks/([^/]+)/aggregation_jobs/([^/]+)$"), "aggregate_init"),
    ("POST", re.compile(r"^/tasks/([^/]+)/aggregation_jobs/([^/]+)$"), "aggregate_continue"),
    ("PUT", re.compile(r"^/tasks/([^/]+)/collection_jobs/([^/]+)$"), "collection_create"),
    ("POST", re.compile(r"^/tasks/([^/]+)/collection_jobs/([^/]+)$"), "collection_poll"),
    ("DELETE", re.compile(r"^/tasks/([^/]+)/collection_jobs/([^/]+)$"), "collection_delete"),
    ("POST", re.compile(r"^/tasks/([^/]+)/aggregate_shares$"), "aggregate_share"),
    # the conservation ledger's reconciliation: the leader's collection
    # driver reads the helper's per-batch counts over the aggregator-auth
    # channel of the DAP steps
    ("GET", re.compile(r"^/tasks/([^/]+)/ledger$"), "ledger"),
]

# Admission route classes: client uploads shed first; the
# aggregator-to-aggregator steps, which finish work the system already
# paid to admit, shed only near saturation. hpke_config and the
# collector's collection_jobs routes (which have their own 202
# Retry-After flow) are never shed.
_ROUTE_CLASS = {
    "upload": "upload",
    "aggregate_init": "aggregate",
    "aggregate_continue": "aggregate",
    "aggregate_share": "aggregate",
}

# Request body media types per route (reference http_handlers.rs:512-551).
_REQUEST_MEDIA_TYPES = {
    "upload": Report.MEDIA_TYPE,
    "aggregate_init": AggregationJobInitializeReq.MEDIA_TYPE,
    "aggregate_continue": AggregationJobContinueReq.MEDIA_TYPE,
    "collection_create": CollectionReq.MEDIA_TYPE,
    "aggregate_share": AggregateShareReq.MEDIA_TYPE,
}

# Browser-reachable routes get CORS preflights (reference
# http_handlers.rs:236-259).
_CORS_ROUTES = [
    (re.compile(r"^/hpke_config$"), "GET"),
    (re.compile(r"^/tasks/([^/]+)/reports$"), "PUT"),
    (re.compile(r"^/tasks/([^/]+)/collection_jobs/([^/]+)$"), "PUT, POST, DELETE"),
]


def _cors_allow(path: str) -> str | None:
    for rx, allow in _CORS_ROUTES:
        if rx.match(path):
            return allow
    return None


def _problem(status: int, doc: dict):
    return status, "application/problem+json", json.dumps(doc).encode()


def _shed(e: ShedError):
    """A shed request's answer: 429 (capacity) or 503 (availability),
    with Retry-After."""
    status, ctype, out = _problem(e.status, {"type": "about:blank", "status": e.status, "detail": str(e)})
    return status, ctype, out, {"Retry-After": str(max(1, math.ceil(e.retry_after_s)))}


def _refuse_if_device_down(ta) -> None:
    """The aggregate routes' device shed: raise the engine's
    DeviceQuarantinedError (answered 503) before any decode or HPKE work
    while it refuses dispatches."""
    if ta.engine is not None:
        ta.engine.check_available("aggregate request")


class DapHttpApp:
    """Routing + handler glue around an Aggregator. The ingest pipeline
    and the admission controller are built from the aggregator's Config
    on the first request of an admitted route."""

    def __init__(self, aggregator: Aggregator):
        self.agg = aggregator
        self._ingest: IngestPipeline | None = None
        self._admission: AdmissionController | None = None
        self._ingest_lock = threading.Lock()

    def _ensure_ingest(self) -> tuple[IngestPipeline, AdmissionController]:
        with self._ingest_lock:
            cfg = self.agg.cfg
            if self._ingest is None:
                self._ingest = IngestPipeline(
                    self.agg.report_writer,
                    decrypt_workers=cfg.ingest_decrypt_workers,
                    decode_workers=cfg.ingest_decode_workers,
                    queue_depth=cfg.ingest_queue_depth,
                    batch_window=cfg.ingest_batch_window,
                    batch_linger_ms=cfg.ingest_batch_linger_ms,
                )
                pipe = self._ingest

                def _ingest_status(pipe=pipe, cfg=cfg):
                    inflight, bound = pipe.depth()
                    return {
                        "inflight": inflight,
                        "queue_depth_bound": bound,
                        "occupancy": round(inflight / bound, 3) if bound else 0.0,
                        "decrypt_workers": pipe.decrypt_workers,
                        "decode_workers": pipe.decode_workers,
                        "batch_window": pipe.batch_window,
                        "batch_linger_ms": pipe.batch_linger_s * 1000.0,
                        "queue_high_watermark": cfg.queue_high_watermark,
                    }

                register_status_provider("ingest", _ingest_status)
            if self._admission is None:
                self._admission = AdmissionController(
                    AdmissionConfig(
                        upload_bucket_rate=cfg.upload_bucket_rate,
                        upload_bucket_burst=cfg.upload_bucket_burst,
                        aggregate_bucket_rate=cfg.aggregate_bucket_rate,
                        aggregate_bucket_burst=cfg.aggregate_bucket_burst,
                        shed_priority=tuple(cfg.shed_priority),
                        queue_high_watermark=cfg.queue_high_watermark,
                        shed_retry_after_s=cfg.upload_shed_retry_after_s,
                    ),
                    depth_fn=self._ingest.depth,
                    # the aggregate routes shed 503 while the datastore
                    # supervisor is not up
                    supervisor_fn=lambda: getattr(self.agg.ds, "supervisor", None),
                )
            return self._ingest, self._admission

    def close(self) -> None:
        """Drain the ingest pipeline's worker threads (shutdown)."""
        with self._ingest_lock:
            ingest = self._ingest
        if ingest is not None:
            ingest.close()

    def _taskprov_config(self, task_id: TaskId, headers):
        """Decode and verify the dap-taskprov header (reference
        http_handlers.rs:575-607 parse_taskprov_header): the task ID must
        equal SHA-256 of the encoded TaskConfig."""
        if not self.agg.cfg.taskprov_enabled:
            return None
        lowered = {k.lower(): v for k, v in headers.items()}
        raw = lowered.get(TASKPROV_HEADER)
        if raw is None:
            return None
        try:
            encoded = base64.urlsafe_b64decode(raw + "=" * (-len(raw) % 4))
        except Exception:
            raise InvalidMessage("taskprov header could not be decoded", task_id)
        if hashlib.sha256(encoded).digest() != task_id.data:
            raise InvalidMessage("derived taskprov task ID does not match task config", task_id)
        return TaskConfig.from_bytes(encoded)

    def _check_helper_auth(self, ta, task_id, headers, taskprov_config):
        """Aggregator (leader->helper) auth: the taskprov peer's tokens
        when the header is present, the task's token otherwise (reference
        aggregator.rs:420-432)."""
        if taskprov_config is not None:
            self.agg.taskprov_authorize_request(Role.LEADER, task_id, taskprov_config, headers)
        else:
            self.agg.check_aggregator_auth(ta.task, headers)

    def handle(self, method: str, path: str, query: dict, headers, body: bytes):
        """-> (status, content_type, body_bytes, extra_headers). Wraps
        _handle with the incoming traceparent, the `dap.<route>` span and
        the per-route request counter and latency histogram."""
        route = "none"
        for m, rx, name in _ROUTES:
            if m == method and rx.match(path):
                route = name
                break
        start = time.monotonic()
        # adopt the caller's trace (leader -> helper): one trace stitches
        # the job's steps across both aggregators
        tp_token = adopt_traceparent(next((v for k, v in headers.items() if k.lower() == "traceparent"), None))
        exemplar_ctx = None
        try:
            with span(f"dap.{route}", method=method):
                # the request span's trace id is the latency sample's
                # exemplar (the span has reset its context by then)
                exemplar_ctx = current_context()
                result = self._handle(method, path, query, headers, body)
        finally:
            reset_traceparent(tp_token)
        metrics.http_request_duration.observe(
            time.monotonic() - start, exemplar_trace_id=exemplar_ctx[0] if exemplar_ctx else None, route=route
        )
        metrics.http_request_counter.add(route=route, status=str(result[0]))
        if len(result) == 3:
            result = result + ({},)
        return result

    def _handle(self, method: str, path: str, query: dict, headers, body: bytes):
        try:
            if method == "OPTIONS":
                if _cors_allow(path) is not None:
                    return 204, "text/plain", b""
                return 404, "text/plain", b"not found"
            for m, rx, name in _ROUTES:
                if m != method:
                    continue
                match = rx.match(path)
                if not match:
                    continue
                want = _REQUEST_MEDIA_TYPES.get(name)
                if want is not None:
                    got = {k.lower(): v for k, v in headers.items()}.get("content-type", "")
                    # exact match, no parameter stripping (reference
                    # validate_content_type)
                    if got != want:
                        return _problem(
                            400,
                            DapProblemType.INVALID_MESSAGE.document(
                                detail=f"unexpected media type: {got!r} (want {want!r})"
                            ),
                        )
                route_class = _ROUTE_CLASS.get(name)
                if route_class is not None:
                    # shed before any decode, crypto or datastore work;
                    # the caller's budget, backdated by the accept-queue
                    # wait, is an admission signal too (a spent one sheds
                    # 503) and then bounds the handler
                    dl = deadline_mod.parse_header(headers, queue_age_s=deadline_mod.request_queue_age())
                    _, admission = self._ensure_ingest()
                    admission.admit(route_class, deadline=dl)
                    with deadline_mod.deadline_scope(dl):
                        return getattr(self, "h_" + name)(match, query, headers, body)
                return getattr(self, "h_" + name)(match, query, headers, body)
            return 404, "text/plain", b"not found"
        except ShedError as e:
            # 429 for capacity sheds, 503 for availability sheds, both
            # with Retry-After
            metrics.upload_shed_counter.add(route=e.route_class, reason=e.reason)
            return _shed(e)
        except DeviceQuarantinedError as e:
            # the task's engine refuses dispatches: an availability shed,
            # back about when its canary probes again
            return _shed(ShedError("aggregate", "device_quarantined", e.retry_in_s, status=503))
        except DeadlineExceeded as e:
            # the caller's budget died mid-handler: the conclusive status,
            # not a retryable 5xx
            return _problem(
                DEADLINE_EXCEEDED_STATUS,
                {
                    "type": "about:blank",
                    "status": DEADLINE_EXCEEDED_STATUS,
                    "detail": f"request deadline exceeded: {e}",
                },
            )
        except AggregatorError as e:
            doc = e.problem_document()
            if doc is None:
                log.exception("internal aggregator error")
                return 500, "text/plain", str(e).encode()
            return _problem(e.status, doc)
        except DecodeError as e:
            return _problem(400, DapProblemType.INVALID_MESSAGE.document(detail=f"undecodable request: {e}"))
        except Exception:
            log.exception("unhandled error in DAP handler")
            return 500, "text/plain", b"internal error"

    # --- handlers ---
    def h_hpke_config(self, match, query, headers, body):
        tid = query.get("task_id")
        if tid is None:
            raise InvalidMessage("task_id query parameter required")
        task_id = TaskId(_b64dec(tid, 32))
        try:
            configs = self.agg.task_aggregator_for(task_id).hpke_config_list()
            if not configs.configs:
                raise UnrecognizedTask("no per-task keys", task_id)
        except UnrecognizedTask:
            # a taskprov task is not provisioned here at upload time and
            # carries no keys of its own: advertise the global keys
            # (reference aggregator.rs:276-280)
            globals_ = self.agg.global_hpke_keypairs.configs()
            if not (self.agg.cfg.taskprov_enabled and globals_):
                raise
            configs = HpkeConfigList(tuple(globals_))
        return 200, "application/dap-hpke-config-list", configs.to_bytes()

    def h_upload(self, match, query, headers, body):
        task_id = TaskId(_b64dec(match.group(1), 32))
        ta = self.agg.task_aggregator_for(task_id)
        # staged ingest: this thread parks on the ticket, so the answer
        # still means "durably written"; a stage error re-raises here and
        # maps to its problem document. A replay is silent success.
        ingest, _ = self._ensure_ingest()
        if not ingest.submit(ta, self.agg.clock, body).result():
            metrics.upload_replay_counter.add()
        return 201, "text/plain", b""

    def h_aggregate_init(self, match, query, headers, body):
        task_id = TaskId(_b64dec(match.group(1), 32))
        job_id = AggregationJobId(_b64dec(match.group(2), 16))
        taskprov_config = self._taskprov_config(task_id, headers)
        # the helper's endpoint: the provisioning peer is the leader
        ta = self.agg.task_aggregator_for(task_id, taskprov_config, headers, peer_role=Role.LEADER)
        self._check_helper_auth(ta, task_id, headers, taskprov_config)
        _refuse_if_device_down(ta)
        # XOF framing check: the two framings produce disjoint streams, so
        # a mismatch would otherwise reject every report. Absence is
        # tolerated (a non-janus leader).
        sent_mode = {k.lower(): v for k, v in headers.items()}.get(XOF_MODE_HEADER)
        task_mode = ta.task.vdaf.xof_mode
        if sent_mode is not None and sent_mode != task_mode:
            raise InvalidMessage(
                f"XOF framing mismatch: peer uses {sent_mode!r}, task is "
                f"{task_mode!r} — aggregators must deploy the same mode",
                task_id,
            )
        req = AggregationJobInitializeReq.from_bytes(body)
        resp = ta.handle_aggregate_init(self.agg.ds, self.agg.clock, job_id, req, body)
        return 200, "application/dap-aggregation-job-resp", resp.to_bytes()

    def h_aggregate_continue(self, match, query, headers, body):
        task_id = TaskId(_b64dec(match.group(1), 32))
        job_id = AggregationJobId(_b64dec(match.group(2), 16))
        taskprov_config = self._taskprov_config(task_id, headers)
        ta = self.agg.task_aggregator_for(task_id)
        self._check_helper_auth(ta, task_id, headers, taskprov_config)
        _refuse_if_device_down(ta)
        req = AggregationJobContinueReq.from_bytes(body)
        resp = ta.handle_aggregate_continue(self.agg.ds, self.agg.clock, job_id, req, body)
        return 200, "application/dap-aggregation-job-resp", resp.to_bytes()

    def h_collection_create(self, match, query, headers, body):
        task_id = TaskId(_b64dec(match.group(1), 32))
        cj_id = CollectionJobId(_b64dec(match.group(2), 16))
        ta = self.agg.task_aggregator_for(task_id)
        self.agg.check_collector_auth(ta.task, headers)
        req = CollectionReq.from_bytes(body)
        ta.handle_create_collection_job(self.agg.ds, cj_id, req)
        return 201, "text/plain", b""

    def h_collection_poll(self, match, query, headers, body):
        task_id = TaskId(_b64dec(match.group(1), 32))
        cj_id = CollectionJobId(_b64dec(match.group(2), 16))
        ta = self.agg.task_aggregator_for(task_id)
        self.agg.check_collector_auth(ta.task, headers)
        ready, collection = ta.handle_get_collection_job(self.agg.ds, cj_id)
        if not ready:
            # the poll cadence the collector honors (reference
            # collector/src/lib.rs:466)
            return 202, "text/plain", b"", {"Retry-After": str(self.agg.cfg.collection_retry_after_s)}
        return 200, "application/dap-collection", collection.to_bytes()

    def h_collection_delete(self, match, query, headers, body):
        task_id = TaskId(_b64dec(match.group(1), 32))
        cj_id = CollectionJobId(_b64dec(match.group(2), 16))
        ta = self.agg.task_aggregator_for(task_id)
        self.agg.check_collector_auth(ta.task, headers)
        ta.handle_delete_collection_job(self.agg.ds, cj_id)
        return 204, "text/plain", b""

    def h_aggregate_share(self, match, query, headers, body):
        task_id = TaskId(_b64dec(match.group(1), 32))
        taskprov_config = self._taskprov_config(task_id, headers)
        # the helper's endpoint: taskprov provisioning here too (reference
        # aggregator.rs:641)
        ta = self.agg.task_aggregator_for(task_id, taskprov_config, headers, peer_role=Role.LEADER)
        self._check_helper_auth(ta, task_id, headers, taskprov_config)
        req = AggregateShareReq.from_bytes(body)
        resp = ta.handle_aggregate_share(self.agg.ds, req)
        return 200, "application/dap-aggregate-share", resp.to_bytes()

    def h_ledger(self, match, query, headers, body):
        """The conservation ledger's cross-aggregator read: this
        aggregator's per-batch aggregated report counts and its task
        counters, behind the leader->helper aggregator auth of the DAP
        aggregation steps (janus_tpu's route and JSON)."""
        task_id = TaskId(_b64dec(match.group(1), 32))
        taskprov_config = self._taskprov_config(task_id, headers)
        ta = self.agg.task_aggregator_for(task_id, taskprov_config, headers, peer_role=Role.LEADER)
        self._check_helper_auth(ta, task_id, headers, taskprov_config)

        def read(tx):
            return tx.ledger_batch_counts(task_id), tx.get_task_counters(task_id)

        batch_counts, counters = self.agg.ds.run_tx(read, "ledger_peer_read")
        doc = {"batch_counts": batch_counts, "counters": counters}
        return 200, "application/json", json.dumps(doc, sort_keys=True).encode()


class DapServer:
    """Bounded-concurrency HTTP server hosting a DapHttpApp (+ /healthz):
    requests are served by a fixed pool of `max_handler_threads`
    workers."""

    def __init__(self, app: DapHttpApp, host: str = "127.0.0.1", port: int = 0, max_handler_threads: int | None = None):
        outer = self
        if max_handler_threads is None:
            max_handler_threads = app.agg.cfg.max_handler_threads

        class Handler(LongHeaderLines, BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # an idle keep-alive connection must not pin a pool worker
            timeout = 60

            def _dispatch(self, method):
                parts = urlsplit(self.path)
                if parts.path == "/healthz":
                    self._reply(200, "text/plain", b"ok")
                    return
                # charge the accept-queue wait against the request's
                # propagated deadline
                age = self.server.queue_age_s(self.request)
                deadline_mod.set_request_queue_age(age or 0.0)
                query = dict(parse_qsl(parts.query))
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                try:
                    status, ctype, out, extra = outer.app.handle(
                        method, parts.path, query, dict(self.headers.items()), body
                    )
                except Exception:
                    log.exception("unhandled error serving %s %s", method, parts.path)
                    status, ctype, out, extra = (
                        500,
                        "application/problem+json",
                        b'{"type":"about:blank","status":500}',
                        None,
                    )
                self._reply(status, ctype, out, method, extra)

            def _reply(self, status, ctype, out, method="GET", extra=None):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(out)))
                if self.server.saturated:
                    # pool full: finish this response, then recycle the
                    # connection
                    self.send_header("Connection", "close")
                    self.close_connection = True
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                allow = _cors_allow(urlsplit(self.path).path)
                if allow is not None:
                    self.send_header("Access-Control-Allow-Origin", "*")
                    if method == "OPTIONS":
                        self.send_header("Access-Control-Allow-Methods", allow)
                        self.send_header(
                            "Access-Control-Allow-Headers",
                            "content-type, authorization, dap-auth-token",
                        )
                self.end_headers()
                if out:
                    self.wfile.write(out)

            def do_GET(self):
                self._dispatch("GET")

            def do_OPTIONS(self):
                self._dispatch("OPTIONS")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_POST(self):
                self._dispatch("POST")

            def do_DELETE(self):
                self._dispatch("DELETE")

            def log_message(self, fmt, *args):
                log.debug("http: " + fmt, *args)

        self.app = app
        self.server = BoundedThreadingHTTPServer((host, port), Handler, max_handler_threads=max_handler_threads)
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self) -> "DapServer":
        self._thread = threading.Thread(target=self.server.serve_forever, name="dap-listener", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        self.app.close()
