"""The failpoint sites of janus_tpu_torch's helper, retry and ingest paths,
held against janus_tpu's.

Each site is armed in both packages (each has its own registry) and the
same request is driven through each; the outcomes must be equal:

- `helper.request` (error and timeout): the HttpClient's exception (type
  and message; the thread's last response headers cleared), and through
  retry_http_request a storm of two that the loop retries past;
- `helper.response` (timeout): the exception after the peer answered;
- `retry.attempt`: two injected transport errors retried before the one
  real attempt, and an unending storm that exhausts the backoff budget;
- `helper.aggregate` and `helper.aggregate_share`: the helper route's
  answer (status, content type, body) to an aggregate-init and an
  aggregate-share request;
- `ingest.decode` (it wins over a malformed body) and `ingest.decrypt`:
  the pipeline ticket's error and the upload route's answer.

Every site fires before any engine work, so nothing compiles. Tolerance:
exact equality.
"""

import http.server
import threading
import urllib.error

import pytest

from janus_tpu import client as j_client_mod
from janus_tpu import failpoints as j_fp
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.aggregator import core as j_core
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.core import hpke as j_hpke
from janus_tpu.core import http_client as j_http_client
from janus_tpu.core import retries as j_retries
from janus_tpu.core import time_util as j_time
from janus_tpu.datastore import store as j_store
from janus_tpu.ingest import pipeline as j_pipeline
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import failpoints as t_fp
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.core import http_client as t_http_client
from janus_tpu_torch.core import retries as t_retries
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.ingest import pipeline as t_pipeline
from janus_tpu_torch.messages import Time
from janus_tpu_torch.task import Task

NOW = 1_700_000_000
PKGS = {
    "janus_tpu": dict(fp=j_fp, http_client=j_http_client, retries=j_retries, pipeline=j_pipeline),
    "torch": dict(fp=t_fp, http_client=t_http_client, retries=t_retries, pipeline=t_pipeline),
}


@pytest.fixture(autouse=True)
def _disarm():
    """Failpoints are process-global, one registry a package."""
    j_fp.clear()
    t_fp.clear()
    yield
    j_fp.clear()
    t_fp.clear()


def _both(fn):
    """fn(package's modules) for each package, with that package's
    failpoints the only ones armed."""
    return [fn(mods) for mods in PKGS.values()]


def _error(e: BaseException):
    """An exception's type, message and (for a URLError) its reason's type."""
    reason = getattr(e, "reason", None)
    return type(e).__name__, str(e), type(reason).__name__ if reason is not None else None


@pytest.fixture(scope="module")
def peer():
    """A loopback peer answering every GET 200 with a Retry-After header."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Retry-After", "3")
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}/"
    srv.shutdown()
    srv.server_close()


# --- the HTTP client and the retry loop ------------------------------------------------


def _client_case(spec: str, url: str):
    def run(mods):
        http = mods["http_client"].HttpClient(timeout=10)
        assert http.get(url)[0] == 200 and http.last_response_headers  # a real response first
        mods["fp"].configure(spec)
        try:
            http.get(url)
            raise AssertionError(f"{spec} did not fire")
        except urllib.error.URLError as e:
            out = _error(e), http.last_response_headers == {}
        after = http.get(url)  # the budget spent: traffic flows again
        return out, after, mods["fp"].status()["failpoints"]

    return run


@pytest.mark.parametrize("spec", ["helper.request=error,count=1", "helper.request=timeout:0.01,count=1",
                                  "helper.response=timeout:0.01,count=1"])
def test_http_client_site_matches_janus_tpu(peer, spec):
    j, t = _both(_client_case(spec, peer))
    assert t == j
    (err_type, _, reason), cleared = t[0]
    assert err_type == "URLError" and t[1] == (200, b"ok")
    if "request" in spec:
        assert cleared  # a transport failure never shows the previous response's headers
    if "timeout" in spec:
        assert reason in ("timeout", "TimeoutError")


def test_helper_request_storm_is_retried(peer):
    """Two injected transport errors at helper.request, retried by the loop
    like real ones: the third attempt succeeds."""

    def run(mods):
        http = mods["http_client"].HttpClient(timeout=10)
        mods["fp"].configure("helper.request=error,count=2")
        out = mods["retries"].retry_http_request(lambda: http.get(peer), mods["retries"].Backoff.test())
        return out, mods["fp"].status()["failpoints"]["helper.request"]

    j, t = _both(run)
    assert t == j and t[0] == (200, b"ok") and (t[1]["hits"], t[1]["fired"]) == (3, 2)


@pytest.mark.parametrize("case", ["storm_then_success", "unending_storm"])
def test_retry_attempt_site_matches_janus_tpu(case):
    def run(mods):
        calls = []

        def do_request():
            calls.append(1)
            return 200, b"ok"

        spec = "retry.attempt=error:1,count=2" if case == "storm_then_success" else "retry.attempt=error:1"
        mods["fp"].configure(spec)
        try:
            out = mods["retries"].retry_http_request(do_request, mods["retries"].Backoff.test())
        except OSError as e:
            out = _error(e)
        fired = mods["fp"].status()["failpoints"]["retry.attempt"]["fired"]
        return out, len(calls), fired if case == "storm_then_success" else fired >= 2

    j, t = _both(run)
    assert t == j
    if case == "storm_then_success":
        assert t == ((200, b"ok"), 1, 2)  # the injected failures never reached do_request
    else:
        assert t[0][0] == "OSError" and t[1] == 0


# --- the helper's aggregate routes -------------------------------------------------------


def _b64(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).decode().rstrip("=")


@pytest.fixture(scope="module")
def helper_apps():
    """A janus_tpu and a port helper app over one Count task."""
    task = (
        j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j_registry.VdafInstance.count(), jm.Role.HELPER)
        .with_(vdaf_verify_key=bytes(range(16)))
        .build()
    )
    j_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
    t_eph = EphemeralDatastore(MockClock(Time(NOW)))
    j_eph.datastore.run_tx(lambda tx: tx.put_task(task))
    t_eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(task.to_dict())))
    apps = (j_http.DapHttpApp(j_core.Aggregator(j_eph.datastore, j_eph.clock)),
            t_http.DapHttpApp(t_core.Aggregator(t_eph.datastore, t_eph.clock, device="cpu")))
    yield task, apps
    for app, eph in zip(apps, (j_eph, t_eph)):
        app.close()
        app.agg.close()
        eph.cleanup()


def _helper_request(task, route: str):
    headers = dict(task.aggregator_auth_token.request_headers())
    if route == "aggregate":
        req = jm.AggregationJobInitializeReq(b"", jm.PartialBatchSelector.time_interval(), ())
        path = f"/tasks/{_b64(task.task_id.data)}/aggregation_jobs/{_b64(bytes(range(16)))}"
        return "PUT", path, {**headers, "Content-Type": req.MEDIA_TYPE}, req.to_bytes()
    interval = jm.Interval(jm.Time(NOW - NOW % 3600), jm.Duration(3600))
    req = jm.AggregateShareReq(jm.BatchSelector.time_interval(interval), b"", 0, jm.ReportIdChecksum())
    return "POST", f"/tasks/{_b64(task.task_id.data)}/aggregate_shares", \
        {**headers, "Content-Type": req.MEDIA_TYPE}, req.to_bytes()


@pytest.mark.parametrize("route", ["aggregate", "aggregate_share"])
def test_helper_site_answers_match_janus_tpu(helper_apps, route):
    """helper.aggregate (before the request hash) and
    helper.aggregate_share (after the deadline check): an armed error
    answers the leader as an internal error, in both packages."""
    task, apps = helper_apps
    method, path, headers, body = _helper_request(task, route)
    answers = []
    for app, mods in zip(apps, PKGS.values()):
        mods["fp"].configure(f"helper.{route}=error,count=1")
        answers.append(app.handle(method, path, {}, dict(headers), body))
        assert mods["fp"].status()["failpoints"][f"helper.{route}"]["fired"] == 1
    assert answers[1] == answers[0]
    assert answers[1][0] == 500


# --- the ingest stages -----------------------------------------------------------------------


def test_ingest_decode_site_resolves_the_ticket():
    def run(mods):
        mods["fp"].configure("ingest.decode=error:1,count=1")
        pipe = mods["pipeline"].IngestPipeline(writer=None, decrypt_workers=1, queue_depth=4)
        try:
            ticket = pipe.submit(ta=None, clock=None, body=b"irrelevant")
            with pytest.raises(Exception) as ei:
                ticket.result(timeout_s=10)
            return _error(ei.value), pipe.depth()[0]
        finally:
            pipe.close()

    j, t = _both(run)
    assert t == j and t[0][0] == "FailpointError" and t[1] == 0


@pytest.fixture(scope="module")
def leader_apps():
    """A janus_tpu and a port leader app over one Count task, and a valid
    upload from a janus_tpu client."""
    task = (
        j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j_registry.VdafInstance.count(), jm.Role.LEADER)
        .with_(vdaf_verify_key=bytes(range(16)))
        .build()
    )
    helper_kp = j_hpke.generate_hpke_config_and_private_key(config_id=1)
    params = j_client_mod.ClientParameters(task.task_id, "http://leader/", "http://leader/", task.time_precision)
    client = j_client_mod.Client(params, task.vdaf, task.hpke_keys[0].config, helper_kp.config,
                                 clock=j_time.MockClock(jm.Time(NOW)))
    j_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
    t_eph = EphemeralDatastore(MockClock(Time(NOW)))
    j_eph.datastore.run_tx(lambda tx: tx.put_task(task))
    t_eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(task.to_dict())))
    apps = (j_http.DapHttpApp(j_core.Aggregator(j_eph.datastore, j_eph.clock)),
            t_http.DapHttpApp(t_core.Aggregator(t_eph.datastore, t_eph.clock, device="cpu")))
    yield task, client, apps
    for app, eph in zip(apps, (j_eph, t_eph)):
        app.close()
        app.agg.close()
        eph.cleanup()


@pytest.mark.parametrize("case", ["decode", "decode_malformed_body", "decrypt"])
def test_ingest_site_upload_answers_match_janus_tpu(leader_apps, case):
    """ingest.decode (an armed error wins over a malformed body) and
    ingest.decrypt, armed for one hit: the upload route's answer, and the
    next upload of the same report is accepted."""
    task, client, apps = leader_apps
    report = client.prepare_report(1)
    body = b"\x00\x01" if case == "decode_malformed_body" else report.to_bytes()
    path = f"/tasks/{_b64(task.task_id.data)}/reports"
    headers = {"Content-Type": jm.Report.MEDIA_TYPE}
    site = "ingest.decrypt" if case == "decrypt" else "ingest.decode"
    answers = []
    for app, mods in zip(apps, PKGS.values()):
        mods["fp"].configure(f"{site}=error:1,count=1")
        first = app.handle("PUT", path, {}, dict(headers), body)
        again = app.handle("PUT", path, {}, dict(headers), report.to_bytes())
        answers.append((first, again, mods["fp"].status()["failpoints"][site]["fired"]))
    assert answers[1] == answers[0]
    first, again, fired = answers[1]
    assert first[0] == 500 and again[0] == 201 and fired == 1
