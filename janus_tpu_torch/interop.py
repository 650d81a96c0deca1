"""Interop test API (draft-dcook-ppm-dap-interop-test-design).

Equivalent of the reference's interop_binaries crate: three HTTP
servers — client (`/internal/test/upload`,
janus_interop_client.rs:215-233), aggregator
(`/internal/test/{ready,endpoint_for_task,add_task}` embedding the
full aggregator plus in-process job runners,
janus_interop_aggregator.rs:121-160) and collector
(`add_task`/`collection_start`/`collection_poll`). These let any
conforming DAP implementation drive ours (and vice versa) through a
implementation-neutral JSON API.

Numbers travel as JSON strings per the draft (u64/u128 don't fit
JSON doubles); both forms are accepted on input.

The port's own copy of janus_tpu/interop.py: the same routes and
documents. The aggregator's engines, its job runners' driver and its
add_task warmup run on the device it is given (`device=`: CUDA unless the
caller asks for the CPU).
"""

from __future__ import annotations

import base64
import json
import logging
import secrets
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .aggregator.core import Aggregator, Config
from .aggregator.aggregation_job_creator import (
    AggregationJobCreator,
    AggregationJobCreatorConfig,
)
from .aggregator.aggregation_job_driver import AggregationJobDriver
from .aggregator.collection_job_driver import CollectionJobDriver
from .aggregator.http_handlers import DapHttpApp
from .aggregator.job_driver import JobDriver, JobDriverConfig, Stopper
from .client import Client, ClientParameters
from .collector import CollectionJobNotReady, Collector, CollectorParameters
from .core.auth import AuthenticationToken
from .core.hpke import generate_hpke_config_and_private_key
from .core.http_client import HttpClient
from .core.time_util import RealClock
from .datastore.store import Datastore
from .messages import (
    BatchId,
    CollectionJobId,
    Duration,
    FixedSize,
    FixedSizeQuery,
    HpkeConfig,
    Interval,
    Query,
    Role,
    TaskId,
    Time,
    TimeInterval,
)
from .task import QueryTypeConfig, Task
from .vdaf.registry import VdafInstance

log = logging.getLogger(__name__)


def unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def vdaf_from_object(obj: dict) -> VdafInstance:
    """Interop VdafObject -> VdafInstance (reference
    interop_binaries/src/lib.rs VdafObject).

    The interop API exists for cross-implementation pairing, so tasks
    default to the spec framing (`xof_mode: draft`, the VDAF-07
    construction a conformant peer speaks, vdaf/draft.py on the device).
    Pairs of this framework (janus_tpu and janus_tpu_torch included) can
    opt into the fast framing with ``"xof_mode": "fast"`` in the
    VdafObject."""
    import dataclasses

    typ = obj["type"]
    geti = lambda k, d=0: int(obj.get(k, d))
    if typ == "Prio3Count":
        inst = VdafInstance.count()
    elif typ == "Prio3CountVec":
        inst = VdafInstance.count_vec(length=geti("length"), chunk_length=geti("chunk_length"))
    elif typ == "Prio3Sum":
        inst = VdafInstance.sum(bits=geti("bits"))
    elif typ == "Prio3SumVec":
        inst = VdafInstance.sum_vec(
            length=geti("length"), bits=geti("bits"), chunk_length=geti("chunk_length")
        )
    elif typ == "Prio3Histogram":
        inst = VdafInstance.histogram(length=geti("length"), chunk_length=geti("chunk_length"))
    elif typ.startswith("Prio3FixedPoint") and typ.endswith("BitBoundedL2VecSum"):
        bits = int(typ.removeprefix("Prio3FixedPoint").removesuffix("BitBoundedL2VecSum"))
        inst = VdafInstance.fixed_point_vec(length=geti("length"), bits=bits)
    else:
        raise ValueError(f"unsupported VDAF type {typ!r}")
    mode = str(obj.get("xof_mode", "draft"))
    if mode not in ("fast", "draft"):
        raise ValueError(f"unknown xof_mode {mode!r} (want 'fast' or 'draft')")
    return dataclasses.replace(inst, xof_mode=mode)


def measurement_from_json(vdaf: VdafInstance, measurement):
    if vdaf.kind in ("count", "sum", "histogram"):
        return int(measurement)
    if vdaf.kind in ("sumvec", "countvec"):
        return [int(x) for x in measurement]
    if vdaf.kind == "fixedpoint":
        # decimal strings in [-1, 1), matching result_to_json's scale
        scale = 1 << (vdaf.bits - 1)
        return [round(float(x) * scale) for x in measurement]
    raise ValueError(vdaf.kind)


def result_to_json(vdaf: VdafInstance, result):
    if vdaf.kind in ("count", "sum"):
        return str(result)
    if vdaf.kind == "fixedpoint":
        return [float(x) for x in result]
    return [str(x) for x in result]


class _JsonServer:
    """POST-only JSON-over-HTTP shell shared by the three servers."""

    def __init__(self, routes, dap_app=None, host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length") or 0)
                return self.rfile.read(n) if n else b""

            def do_POST(self):  # noqa: N802
                body = self._read_body()  # read exactly once per request
                handler = routes.get(self.path)
                if handler is not None:
                    try:
                        doc = json.loads(body) if body else {}
                        resp = handler(doc)
                    except Exception as e:
                        log.exception("interop handler error")
                        resp = {"status": "error", "error": f"{type(e).__name__}: {e}"}
                    out = json.dumps(resp).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(out)))
                    self.end_headers()
                    self.wfile.write(out)
                    return
                self._dap("POST", body)

            def do_GET(self):  # noqa: N802
                self._dap("GET", self._read_body())

            def do_PUT(self):  # noqa: N802
                self._dap("PUT", self._read_body())

            def do_DELETE(self):  # noqa: N802
                self._dap("DELETE", self._read_body())

            def _dap(self, method, body: bytes):
                """Non-interop paths serve the embedded DAP app (the
                reference mounts the aggregator under the same listener)."""
                if dap_app is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                from urllib.parse import parse_qsl, urlsplit

                parts = urlsplit(self.path)
                query = dict(parse_qsl(parts.query))
                status, ctype, out, _hdrs = dap_app.handle(
                    method, parts.path, query, self.headers, body
                )
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                if out:
                    self.wfile.write(out)

            def log_message(self, fmt, *args):
                pass

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="interop-listener", daemon=True
        )

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}/"

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


# ---------------------------------------------------------------------------
# Interop client
# ---------------------------------------------------------------------------


class InteropClient:
    """reference janus_interop_client.rs: upload via the test API."""

    def __init__(self, http=None, clock=None):
        self.http = http or HttpClient()
        self.clock = clock or RealClock()
        self._clients: dict[str, Client] = {}
        self._lock = threading.Lock()

    def handle_upload(self, doc: dict) -> dict:
        vdaf = vdaf_from_object(doc["vdaf"])
        with self._lock:
            client = self._clients.get(doc["task_id"])
        if client is None:
            params = ClientParameters(
                TaskId(unb64(doc["task_id"])),
                doc["leader"],
                doc["helper"],
                Duration(int(doc["time_precision"])),
            )
            client = Client.with_fetched_configs(params, vdaf, self.http, clock=self.clock)
            with self._lock:
                self._clients[doc["task_id"]] = client
        when = Time(int(doc["time"])) if "time" in doc else None
        client.upload(measurement_from_json(vdaf, doc["measurement"]), when=when)
        return {"status": "success"}

    def server(self, host="127.0.0.1", port=0) -> _JsonServer:
        return _JsonServer(
            {
                "/internal/test/ready": lambda doc: {},
                "/internal/test/upload": self.handle_upload,
            },
            host=host,
            port=port,
        )


# ---------------------------------------------------------------------------
# Interop aggregator
# ---------------------------------------------------------------------------


class InteropAggregator:
    """reference janus_interop_aggregator.rs: the full aggregator plus
    in-process job runners, administered through the test API."""

    def __init__(self, ds: Datastore, clock=None, device=None):
        self.ds = ds
        self.clock = clock or RealClock()
        self.aggregator = Aggregator(ds, self.clock, Config(), device=device)
        self.device = self.aggregator.device
        self.dap_app = DapHttpApp(self.aggregator)
        self._stopper = Stopper()
        self._runner: threading.Thread | None = None

    # --- job runners (reference embeds drivers in-process, :121-160) ---
    def start_job_runners(self) -> None:
        # Generous HTTP timeout: a JAX peer's first request compiles its
        # batched VDAF engine (tens of seconds cold); a short timeout breaks
        # the pipe and wastes a lease round-trip. Short lease so a failed
        # step retries quickly in test settings.
        http = HttpClient(timeout=180.0)
        creator = AggregationJobCreator(
            self.ds, AggregationJobCreatorConfig(min_aggregation_job_size=1)
        )
        agg_driver = AggregationJobDriver(self.ds, http, device=self.device)
        agg_jd = JobDriver(JobDriverConfig(), agg_driver.acquirer(15), agg_driver.stepper)
        col_driver = CollectionJobDriver(self.ds, http)
        col_jd = JobDriver(JobDriverConfig(), col_driver.acquirer(15), col_driver.stepper)

        def loop():
            # Prefer finishing aggregation before stepping collection jobs
            # (an interop harness uploads then immediately collects), but
            # bound the deferral so a steady upload trickle cannot starve
            # collection forever.
            quiet = 0
            deferred = 0
            while not self._stopper.stopped:
                try:
                    created = creator.run_once()
                    stepped = agg_jd.run_once()
                    quiet = quiet + 1 if (created == 0 and stepped == 0) else 0
                    if quiet >= 2 or deferred >= 20:
                        col_jd.run_once()
                        deferred = 0
                    else:
                        deferred += 1
                except Exception:
                    log.exception("interop job runner pass failed")
                self._stopper.wait(0.3)

        self._runner = threading.Thread(target=loop, name="interop-runner", daemon=True)
        self._runner.start()

    def stop(self) -> None:
        self._stopper.stop()
        if self._runner is not None:
            self._runner.join(timeout=10)

    # --- test API handlers ---
    def handle_ready(self, doc: dict) -> dict:
        return {}

    def handle_endpoint_for_task(self, doc: dict) -> dict:
        return {"status": "success", "endpoint": "/"}

    def handle_add_task(self, doc: dict) -> dict:
        role = Role.LEADER if doc["role"] == "leader" else Role.HELPER
        vdaf = vdaf_from_object(doc["vdaf"])
        qcode = int(doc["query_type"])
        if qcode == TimeInterval.CODE:
            qt = QueryTypeConfig.time_interval()
        elif qcode == FixedSize.CODE:
            mbs = doc.get("max_batch_size")
            qt = QueryTypeConfig.fixed_size(int(mbs) if mbs is not None else None)
        else:
            raise ValueError(f"unsupported query type {qcode}")
        leader_token = AuthenticationToken.bearer(doc["leader_authentication_token"])
        collector_token = None
        if role == Role.LEADER:
            collector_token = AuthenticationToken.bearer(
                doc["collector_authentication_token"]
            )
        task = Task(
            task_id=TaskId(unb64(doc["task_id"])),
            leader_aggregator_endpoint=doc["leader"],
            helper_aggregator_endpoint=doc["helper"],
            query_type=qt,
            vdaf=vdaf,
            role=role,
            vdaf_verify_key=unb64(doc["vdaf_verify_key"]),
            max_batch_query_count=int(doc.get("max_batch_query_count", 1)),
            task_expiration=(
                Time(int(doc["task_expiration"]))
                if doc.get("task_expiration") is not None
                else None
            ),
            report_expiry_age=None,
            min_batch_size=int(doc["min_batch_size"]),
            time_precision=Duration(int(doc["time_precision"])),
            tolerable_clock_skew=Duration(60),
            collector_hpke_config=HpkeConfig.from_bytes(
                unb64(doc["collector_hpke_config"])
            ),
            aggregator_auth_token=leader_token,
            collector_auth_token=collector_token,
            hpke_keys=(generate_hpke_config_and_private_key(config_id=0),),
        )
        self.ds.run_tx(lambda tx: tx.put_task(task), "interop_add_task")
        # Warm the engine now: add_task has no client timeout, whereas the
        # job runners' short test leases (15 s) should not carry an
        # engine's first dispatch.
        from .binary_utils import warmup_engines

        warmup_engines(self.ds, devices=(self.device,))
        return {"status": "success"}

    def server(self, host="127.0.0.1", port=0) -> _JsonServer:
        return _JsonServer(
            {
                "/internal/test/ready": self.handle_ready,
                "/internal/test/endpoint_for_task": self.handle_endpoint_for_task,
                "/internal/test/add_task": self.handle_add_task,
            },
            dap_app=self.dap_app,
            host=host,
            port=port,
        )


# ---------------------------------------------------------------------------
# Interop collector
# ---------------------------------------------------------------------------


@dataclass
class _CollectorTaskState:
    collector: Collector
    auth_token: AuthenticationToken


@dataclass
class _CollectionHandle:
    collector: Collector
    job_id: CollectionJobId
    query: Query
    vdaf: VdafInstance
    agg_param: bytes


class InteropCollector:
    """reference janus_interop_collector.rs: add_task (generates the
    collector HPKE keypair), collection_start, collection_poll."""

    def __init__(self, http=None):
        self.http = http or HttpClient()
        self._tasks: dict[str, _CollectorTaskState] = {}
        self._handles: dict[str, _CollectionHandle] = {}
        self._lock = threading.Lock()

    def handle_add_task(self, doc: dict) -> dict:
        vdaf = vdaf_from_object(doc["vdaf"])
        kp = generate_hpke_config_and_private_key(config_id=200)
        token = AuthenticationToken.bearer(doc["collector_authentication_token"])
        params = CollectorParameters(
            TaskId(unb64(doc["task_id"])), doc["leader"], token, kp
        )
        with self._lock:
            self._tasks[doc["task_id"]] = _CollectorTaskState(
                Collector(params, vdaf, self.http), token
            )
        return {
            "status": "success",
            "collector_hpke_config": b64(kp.config.to_bytes()),
        }

    def _query_from_json(self, doc: dict) -> Query:
        q = doc["query"]
        qcode = int(q["type"])
        if qcode == TimeInterval.CODE:
            return Query.time_interval(
                Interval(
                    Time(int(q["batch_interval_start"])),
                    Duration(int(q["batch_interval_duration"])),
                )
            )
        if qcode == FixedSize.CODE:
            sub = q.get("subtype")
            if sub is not None and int(sub) == FixedSizeQuery.BY_BATCH_ID:
                return Query.fixed_size(
                    FixedSizeQuery(FixedSizeQuery.BY_BATCH_ID, BatchId(unb64(q["batch_id"])))
                )
            return Query.fixed_size(FixedSizeQuery(FixedSizeQuery.CURRENT_BATCH))
        raise ValueError(f"unsupported query type {qcode}")

    def handle_collection_start(self, doc: dict) -> dict:
        state = self._tasks[doc["task_id"]]
        query = self._query_from_json(doc)
        agg_param = unb64(doc.get("agg_param", ""))
        job_id = state.collector.start_collection(query, agg_param)
        handle = b64(secrets.token_bytes(16))
        with self._lock:
            self._handles[handle] = _CollectionHandle(
                state.collector, job_id, query, state.collector.vdaf, agg_param
            )
        return {"status": "success", "handle": handle}

    def handle_collection_poll(self, doc: dict) -> dict:
        with self._lock:
            h = self._handles[doc["handle"]]
        try:
            res = h.collector.poll_once(h.job_id, h.query, h.agg_param)
        except CollectionJobNotReady:
            return {"status": "in progress"}
        out = {
            "status": "complete",
            "report_count": str(res.report_count),
            "result": result_to_json(h.vdaf, res.aggregate_result),
        }
        if h.query.query_type == FixedSize.CODE and res.partial_batch_selector is not None:
            out["batch_id"] = b64(res.partial_batch_selector.batch_id.data)
        return out

    def server(self, host="127.0.0.1", port=0) -> _JsonServer:
        return _JsonServer(
            {
                "/internal/test/ready": lambda doc: {},
                "/internal/test/add_task": self.handle_add_task,
                "/internal/test/collection_start": self.handle_collection_start,
                "/internal/test/collection_poll": self.handle_collection_poll,
            },
            host=host,
            port=port,
        )
