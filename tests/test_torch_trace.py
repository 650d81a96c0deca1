"""janus_tpu_torch's spans and traceparent propagation held against janus_tpu's.

- The W3C traceparent: parse, trace-id and format parity over a seeded
  set of valid and invalid headers.
- The OTLP/HTTP exporter against a loopback listener: both packages post
  the same span document.
- The trace context crosses threads where the port hands work off: the
  dispatch watchdog's worker (`EngineCache._supervised`, whose spans also
  feed the device-cost ledger's transfer hooks there), the
  `mesh-dispatch` lane, and the stage pipeline's lanes (the job's
  persisted trace on every stage thread).
- In all four leader/helper pairings (tests/test_torch_ledger.py's
  drive): every aggregation job row holds a traceparent, the leader's is
  its creator span's, and the helper's row and its `dap.aggregate_init`
  span carry the leader job's trace id.
- The flight recorder and the Chrome trace writer keep janus_tpu's
  documents.
"""

import json
import random
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

from janus_tpu import trace as j_trace
from janus_tpu_torch import trace as t_trace
from janus_tpu_torch.core.deadline import deadline_scope
from test_torch_ledger import drive
from test_torch_multi_round import PAIRINGS

HEX = "0123456789abcdef"


def _headers(seed: int, n: int = 300):
    rng = random.Random(seed)

    def hx(k):
        return "".join(rng.choice(HEX) for _ in range(k))

    out = [None, "", "00", "garbage", "00-" + "0" * 32 + "-" + hx(16) + "-01", "00-" + hx(32) + "-" + "0" * 16 + "-01",
           "ff-" + hx(32) + "-" + hx(16) + "-01", "00-" + hx(32).upper() + "-" + hx(16) + "-01",
           "00-" + hx(32) + "-" + hx(16) + "-01-extra", "00-" + hx(31) + "-" + hx(17) + "-01"]
    for _ in range(n):
        parts = [hx(2), hx(32), hx(16), hx(2)]
        kind = rng.randrange(6)
        if kind == 1:
            i = rng.randrange(4)
            parts[i] = parts[i][:-1]
        elif kind == 2:
            i = rng.randrange(4)
            parts[i] = parts[i][:-1] + rng.choice("gxZ-")
        elif kind == 3:
            parts = parts[: rng.randrange(1, 4)]
        out.append("-".join(parts))
    return out


def test_traceparent_parse_and_format_parity():
    headers = _headers(11)
    valid = 0
    for h in headers:
        assert t_trace._parse_traceparent(h) == j_trace._parse_traceparent(h), h
        assert t_trace.trace_id_of(h) == j_trace.trace_id_of(h), h
        with t_trace.use_traceparent(h), j_trace.use_traceparent(h):
            assert t_trace.current_traceparent() == j_trace.current_traceparent()
        tok_t, tok_j = t_trace.adopt_traceparent(h), j_trace.adopt_traceparent(h)
        try:
            assert t_trace.current_traceparent() == j_trace.current_traceparent()
            valid += t_trace.current_traceparent() is not None
        finally:
            t_trace.reset_traceparent(tok_t)
            j_trace.reset_traceparent(tok_j)
    assert 50 < valid < len(headers) - 50
    with t_trace.span("probe.root"):
        tp = t_trace.current_traceparent()
        assert t_trace._parse_traceparent(tp) is not None and j_trace._parse_traceparent(tp) is not None
        with t_trace.span("probe.child"):
            assert t_trace.trace_id_of(t_trace.current_traceparent()) == t_trace.trace_id_of(tp)
    assert t_trace.current_traceparent() is None


class _Collector(BaseHTTPRequestHandler):
    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        self.server.posts.append((self.path, json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


def test_otlp_exporter_posts_janus_tpus_span_document():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    server.posts = []
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        docs = {}
        for name, tr in (("jax", j_trace), ("torch", t_trace)):
            ex = tr.OtlpExporter(url, flush_interval_s=3600)
            ex.record_span("probe.span", 1_000, 2_500, 0xABC, 0x12, 0x34, {"rows": 3, "vdaf": "count", "ok": True})
            ex.record_span("probe.root", 0, 5_000, "ab" * 16, "cd" * 8, None, {"s": 0.5})
            server.posts.clear()
            ex.flush()
            ex._stop.set()
            docs[name] = [doc for path, doc in server.posts if path == "/v1/traces"]
            assert any(path == "/v1/metrics" for path, _ in server.posts)
        assert docs["torch"] == docs["jax"] and len(docs["jax"]) == 1
        (spans,) = [s["spans"] for s in docs["jax"][0]["resourceSpans"][0]["scopeSpans"]]
        assert [s["traceId"] for s in spans] == [f"{0xABC:032x}", "ab" * 16]
    finally:
        server.shutdown()
        server.server_close()


def test_flight_recorder_and_chrome_trace_documents_match_janus_tpu(tmp_path):
    docs = {}
    for name, tr in (("jax", j_trace), ("torch", t_trace)):
        rec = tr.FlightRecorder(capacity=16, slow_threshold_s=0.0)
        rec.set_slow_threshold("root", 0.0)
        rec.record("child", 0xA, 0x2, 0x1, 1_000, 0.002, {"k": 1}, None)
        rec.record("root", 0xA, 0x1, None, 1_000, 0.004, {}, "ValueError")
        snap = rec.snapshot()
        snap.pop("resource")
        docs[name] = (snap, rec.status())
        path = tmp_path / f"{name}.json"
        with tr.scoped_chrome_trace(str(path)):
            with tr.span("chrome.probe", rows=2):
                pass
        events = [e for e in json.loads(path.read_text()) if e]
        assert [e["name"] for e in events] == ["chrome.probe"] and events[0]["args"]["rows"] == 2
    for snap, _ in docs.values():
        for tr_doc in snap["slow_traces"]:
            tr_doc.pop("captured_unix_ns", None)
    assert docs["torch"] == docs["jax"]


def test_context_reaches_the_watchdog_worker_and_its_transfer_hooks():
    """Under a deadline the engine's supervised closures run on a
    watchdog worker, in a copy of the caller's context: the spans there
    carry the caller's trace id, and the device-cost ledger's transfer
    hook books the fetch span's time."""
    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.profiler import DEVICE_COST
    from janus_tpu_torch.vdaf.registry import VdafInstance

    eng = EngineCache(VdafInstance.count(), bytes(16), device="cpu")
    seen = {}

    def fetch():
        seen["thread"] = threading.current_thread().name
        seen["ctx"] = t_trace.current_context()
        with t_trace.span("engine.helper_init.fetch", vdaf="probe-kind", bucket=64):
            time.sleep(0.002)
        return 1

    with t_trace.span("probe.outer"):
        outer = t_trace.current_context()
        with deadline_scope(time.monotonic() + 30):
            assert eng._fetch("helper_init_fetch", fetch) == 1
    assert seen["thread"].startswith("device-watchdog")
    assert seen["ctx"][0] == outer[0]
    (row,) = [e for e in DEVICE_COST.status()["entries"] if e["vdaf"] == "probe-kind"]
    assert (row["op"], row["bucket"], row["dispatches"]) == ("helper_init", 64, 0) and row["d2h_s"] >= 0.002
    recent = t_trace.flight_recorder().snapshot(recent_limit=64)["recent"]
    (span,) = [s for s in recent if s["name"] == "engine.helper_init.fetch" and s["trace_id"] == f"{outer[0]:032x}"]


def test_context_reaches_the_mesh_dispatch_lane():
    from janus_tpu_torch.aggregator.engine_cache import MeshDispatchQueue

    q = MeshDispatchQueue()
    with t_trace.span("probe.mesh"):
        outer = t_trace.current_context()
        got = q.submit(lambda: (threading.current_thread().name, t_trace.current_context()), vdaf="", program="p")
    assert got[0] == "mesh-dispatch" and got[1] == outer
    assert q.status()["completed"] == 1


class _StagesDriver:
    """A job driver stand-in for StepPipeline: every stage records its
    thread and trace id; the job row carries a persisted traceparent."""

    TRACE = "00-" + "5e" * 16 + "-" + "7a" * 8 + "-01"

    def __init__(self):
        self.cfg = SimpleNamespace(maximum_attempts_before_failure=10)
        self.classic_fallbacks = 0
        self.seen = {}

    def _note(self, stage):
        self.seen[stage] = (threading.current_thread().name, t_trace.trace_id_of(t_trace.current_traceparent()))

    def read_job(self, acquired):
        from janus_tpu_torch.datastore.models import AggregationJobState

        self._note("read_outside")
        return object(), SimpleNamespace(state=AggregationJobState.IN_PROGRESS, trace_context=self.TRACE), [], {}

    def _lease_deadline(self, acquired):
        return time.monotonic() + 30

    def plan_step(self, acquired, task, job, ras):
        self._note("plan")
        return "init", []

    def stage_init(self, acquired, task, job, rows, reports):
        return SimpleNamespace(multi_round=False, prestaged=None)

    def device_init(self, st):
        self._note("device_init")

    def http_init(self, st):
        self._note("http_init")

    def device_accumulate(self, st):
        self._note("device_accumulate")

    def commit_finish(self, st):
        self._note("commit_finish")

    def handle_step_error(self, acquired, e):
        raise e


def test_context_reaches_every_stage_pipeline_lane():
    from janus_tpu_torch.aggregator.step_pipeline import StepPipeline, StepPipelineConfig

    drv = _StagesDriver()
    pipe = StepPipeline(drv, StepPipelineConfig(double_buffer=False))
    try:
        fut: Future = pipe.submit(SimpleNamespace(lease=SimpleNamespace(attempts=1), job_id=b"j"))
        fut.result(timeout=30)
    finally:
        pipe.close()
    want = t_trace.trace_id_of(drv.TRACE)
    assert drv.seen["read_outside"][1] is None  # read before the row is known
    for stage in ("plan", "device_init", "http_init", "device_accumulate", "commit_finish"):
        assert drv.seen[stage][1] == want, stage
    assert drv.seen["device_init"][0].startswith("device-lane")
    assert drv.seen["http_init"][0].startswith("step-http")
    assert drv.seen["commit_finish"][0].startswith("step-commit")


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_the_job_trace_crosses_leader_to_helper(monkeypatch, pairing):
    facts = drive(monkeypatch, pairing)["trace"]
    tid, sid = facts["creator"]
    # the stored trace_context is the creating span's traceparent
    assert facts["leader_ctx"] == f"00-{tid}-{sid}-01"
    assert j_trace.trace_id_of(facts["helper_ctx"]) == tid
    assert tid in facts["helper_init_traces"]
