"""The card as a failable peer in janus_tpu_torch, held against janus_tpu.

The port's counterparts of tests/test_device_watchdog.py, minus the
host-engine cases (the port has no host engine):

- the dispatch watchdog's mechanics (direct call when disarmed, result
  and error hand-back with worker reuse, the context carried into the
  worker, an abandoned hang with its stack, the hang hook, an expired
  deadline refused) as one parametrised test over both packages'
  watchdogs, and the abandoned-thread cap, which trips janus_tpu's
  host-only mode and the port's device_down();
- the port's split of a spent budget from a hang (janus_tpu declares a
  hang at the caller's deadline): a call that outlives its caller's
  budget raises DeadlineExceeded and runs on, detached, its worker back
  in the pool when it ends; one still running at the hang bound is hung
  then; the armed path's hand-off cost is kept in `status()`; a helper
  request whose budget is shorter than its dispatch answers 408 and
  leaves the engine out of quarantine;
- the engine's hang quarantine: a hung dispatch raises DeviceHangError
  (never absorbed by the memory ladder), the quarantined engine refuses
  the interim init with DeviceQuarantinedError (janus_tpu serves it from
  its host engine) and dispatches nothing, and the canary restores the
  device path with the initial caps; a canary that fails and backs off;
  `stop_canary`; the cap's device_down() refusing every engine;
- the drivers: the stepper steps back on `device_hang` and
  `device_quarantined` and refunds the attempt;
- the helper: 503 with Retry-After on both aggregate routes while its
  engine is quarantined, and a hang inside the handler answers 500 as
  janus_tpu's handler does;
- the coalescer: a failing round fails every entry and the entries
  queued behind it run in the next round, in both packages'
  `_Coalescer` alike; on a real engine a hung merged round fails every
  entry with DeviceHangError and the entries queued behind it get
  DeviceQuarantinedError;
- a prestaged (and a plain) leader init under an armed deadline, run on
  the watchdog's worker, equals the direct init and janus_tpu's rows;
- resident slots: a quarantined engine's slots flush with reason
  "quarantine" through a bounded fetch on the watchdog (and on the
  ResidentFlusher's one-second sweep); when that fetch hangs they stay
  resident until the canary restores the engine, then flush.

Everything runs on the CPU (device="cpu"); tolerance: exact equality.
Deadlines and the hang bound (`hang_bound`) are a few tenths of a second
and the canary's delay is set on the instance, so the file takes
seconds.
"""

import threading
import time

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import aggregation_job_driver as j_driver
from janus_tpu.aggregator import device_watchdog as j_watchdog
from janus_tpu.aggregator import engine_cache as j_ec
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu.core import deadline as j_deadline
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import failpoints
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import aggregation_job_driver as t_driver
from janus_tpu_torch.aggregator import device_watchdog
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.aggregator.device_watchdog import DeviceHangError, DeviceQuarantinedError
from janus_tpu_torch.aggregator.engine_cache import EngineCache
from janus_tpu_torch.convert import step_args_to_numpy
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core import deadline as dl
from janus_tpu_torch.core.auth import AuthenticationToken
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

from test_torch_engine_cache import jax_single_device
from test_torch_job_driver import NOW, _leader_task, sides  # noqa: F401 - sides is a fixture

CPU = torch.device("cpu")
VK = bytes(range(16))
PKGS = {"janus_tpu": (j_watchdog, j_deadline), "torch": (device_watchdog, dl)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Failpoints, the process watchdog, the engine cache and the shared
    coalescers are globals: each test starts and ends disarmed and
    untripped, and its parked workers are released (raising, so they do
    no device work) before the next test."""
    monkeypatch.setenv("JANUS_MESH_DP", "1")
    monkeypatch.setenv("JANUS_MESH_SP", "1")
    failpoints.clear()
    device_watchdog.WATCHDOG.reset_for_tests()
    t_ec.engine_cache.cache_clear()
    yield
    failpoints.release_hangs()
    failpoints.clear()
    device_watchdog.WATCHDOG.drain(2.0)
    device_watchdog.WATCHDOG.reset_for_tests()
    for eng in t_ec.live_engines():
        eng.stop_canary()
    t_ec.engine_cache.cache_clear()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def _batch(n=4, seed=1):
    inst = t_registry.VdafInstance.count()
    meas = random_measurements(inst, n, np.random.default_rng(seed))
    args, _ = make_report_batch(inst, meas, seed=seed, device=CPU)
    return step_args_to_numpy(args)


def _engine(delay=0.1):
    eng = EngineCache(t_registry.VdafInstance.count(), VK, device="cpu")
    eng.QUARANTINE_CANARY_DELAY_SECS = delay
    return eng


def _rows(init):
    """A leader init's rows as numpy: out shares, seed, verifier, part."""
    out0, seed0, ver0, part0 = init
    return [np.asarray(x) for x in out0.to_numpy()], seed0, [np.asarray(x) for x in ver0], part0


def _same_rows(a, b) -> bool:
    (oa, sa, va, pa), (ob, sb, vb, pb) = a, b
    return (
        all(np.array_equal(x, y) for x, y in zip(oa, ob))
        and all(np.array_equal(x, y) for x, y in zip(va, vb))
        and (sa is None) == (sb is None)
        and (pa is None) == (pb is None)
    )


HANG_BOUND_S = 0.5


@pytest.fixture()
def hang_bound(monkeypatch):
    """The process watchdog's hang bound cut to HANG_BOUND_S."""
    monkeypatch.setattr(device_watchdog.WATCHDOG, "hang_after_s", HANG_BOUND_S)


def _hang(eng):
    """One leader init whose dispatch hangs: DeviceHangError at the
    watchdog's hang bound (the `hang_bound` fixture), well inside the
    caller's budget."""
    args = _batch()
    failpoints.configure("engine.dispatch=hang,count=1")
    with dl.deadline_scope(time.monotonic() + 4 * HANG_BOUND_S):
        with pytest.raises(DeviceHangError):
            eng.leader_init(*args[:5])


# --- the watchdog's mechanics, both packages ---------------------------------


def _hung_within(wd, s):
    """A deadline under which a wedged call is declared hung after about
    s: janus_tpu's watchdog declares it at the deadline, the port's at
    its hang bound (a spent budget alone only detaches the call)."""
    if hasattr(wd, "hang_after_s"):
        wd.hang_after_s = s
        return time.monotonic() + 10.0
    return time.monotonic() + s


def _case_disarmed(wd, deadline_mod):
    calls = []
    assert wd.run(lambda: calls.append(threading.get_ident()) or 42) == 42
    assert calls == [threading.get_ident()]  # ran inline on the caller's thread


def _case_results_and_reuse(wd, deadline_mod):
    deadline = time.monotonic() + 10
    assert wd.run(lambda: 7, deadline=deadline) == 7
    with pytest.raises(ValueError, match="boom"):
        wd.run(lambda: (_ for _ in ()).throw(ValueError("boom")), deadline=deadline)
    before = threading.active_count()
    for _ in range(20):
        assert wd.run(lambda: 1, deadline=time.monotonic() + 10) == 1
    assert threading.active_count() <= before + 1


def _case_context(wd, deadline_mod):
    with deadline_mod.deadline_scope(time.monotonic() + 30):
        got = wd.run(deadline_mod.current_deadline, deadline=time.monotonic() + 10)
    assert got is not None


def _case_abandon(wd, deadline_mod):
    gate = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as ei:
        wd.run(gate.wait, deadline=_hung_within(wd, 0.2), label="op1", vdaf="t")
    assert 0.15 < time.monotonic() - t0 < 2.0  # raised at the deadline
    assert type(ei.value).__name__ == "DeviceHangError" and ei.value.label == "op1"
    st = wd.status()
    assert st["abandoned_threads"] == 1 and st["hung_dispatches_total"] == 1
    (stalled,) = st["stalled"]
    assert stalled["label"] == "op1" and any("wait" in line for line in stalled["stack"])
    gate.set()  # the wedge clears: the worker retires
    assert _wait(lambda: wd.status()["abandoned_threads"] == 0)


def _case_hook(wd, deadline_mod):
    gate = threading.Event()
    hooked = []
    with pytest.raises(RuntimeError):
        wd.run(gate.wait, deadline=_hung_within(wd, 0.1), label="op", on_hang=hooked.append)
    assert hooked == ["op"]
    gate.set()


def _case_expired(wd, deadline_mod):
    with pytest.raises(deadline_mod.DeadlineExceeded):
        wd.run(lambda: 1, deadline=time.monotonic() - 0.1)


WATCHDOG_CASES = {
    "disarmed": _case_disarmed,
    "results_and_reuse": _case_results_and_reuse,
    "context": _case_context,
    "abandon": _case_abandon,
    "hook": _case_hook,
    "expired": _case_expired,
}


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("case", sorted(WATCHDOG_CASES))
def test_watchdog_mechanics_match_janus_tpu(pkg, case):
    mod, deadline_mod = PKGS[pkg]
    WATCHDOG_CASES[case](mod.DispatchWatchdog(abandoned_thread_cap=4), deadline_mod)


def _case_budget_spent(wd):
    """A budget shorter than the call: DeadlineExceeded, no hang; the
    call runs on and its worker goes back to the pool."""
    wd.hang_after_s = 0.3
    gate, hooked = threading.Event(), []
    with pytest.raises(dl.DeadlineExceeded):
        wd.run(gate.wait, deadline=time.monotonic() + 0.05, label="op", on_hang=hooked.append)
    gate.set()
    assert _wait(lambda: len(wd._idle) == 1)
    time.sleep(0.35)  # past the bound: the finished call is no hang
    st = wd.status()
    assert hooked == [] and st["abandoned_threads"] == 0 and st["hung_dispatches_total"] == 0
    assert st["budget_spent_total"] == 1
    assert wd.run(lambda: 5, deadline=time.monotonic() + 10) == 5 and wd._seq == 1  # the worker reused


def _case_detached_then_hung(wd):
    """A detached call still running at the hang bound is hung then: the
    hook fires from the bound's timer and the worker is abandoned."""
    wd.hang_after_s = 0.2
    gate, hooked = threading.Event(), []
    with pytest.raises(dl.DeadlineExceeded):
        wd.run(gate.wait, deadline=time.monotonic() + 0.05, label="op", on_hang=hooked.append)
    assert hooked == [] and wd.status()["abandoned_threads"] == 0
    assert _wait(lambda: hooked == ["op"])
    st = wd.status()
    assert st["abandoned_threads"] == 1 and st["stalled"][0]["age_s"] >= 0.2
    gate.set()
    assert _wait(lambda: wd.status()["abandoned_threads"] == 0)


def _case_hang_at_deadline(wd):
    """A health check (the canary's probe, a quarantined engine's fetch)
    makes its own deadline the bound."""
    gate = threading.Event()
    with pytest.raises(DeviceHangError):
        wd.run(gate.wait, deadline=time.monotonic() + 0.05, label="canary", hang_at_deadline=True)
    assert wd.status()["abandoned_threads"] == 1
    gate.set()


def _case_armed_cost(wd):
    """The armed path's hand-off is counted: calls and seconds."""
    for _ in range(3):
        assert wd.run(lambda: time.sleep(0.05), deadline=time.monotonic() + 10) is None
    st = wd.status()
    assert st["armed_calls"] == 3 and 0 <= st["armed_handoff_s"] < 3 * 0.05  # the closures' time left out


BOUND_CASES = {
    "budget_spent": _case_budget_spent,
    "detached_then_hung": _case_detached_then_hung,
    "hang_at_deadline": _case_hang_at_deadline,
    "armed_cost": _case_armed_cost,
}


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_watchdog_budget_is_not_a_hang(case):
    BOUND_CASES[case](device_watchdog.DispatchWatchdog(abandoned_thread_cap=4))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_watchdog_cap_trips_host_only_or_device_down(pkg):
    """The cap trips janus_tpu's host-only mode and the port's
    device_down(); then a supervised call refuses at once, with
    janus_tpu's DeviceHangError and the port's DeviceQuarantinedError."""
    mod, _ = PKGS[pkg]
    wd = mod.DispatchWatchdog(abandoned_thread_cap=2)
    gates = [threading.Event() for _ in range(2)]
    for g in gates:
        with pytest.raises(mod.DeviceHangError):
            wd.run(g.wait, deadline=_hung_within(wd, 0.05), label="op")
    refused = mod.DeviceHangError if pkg == "janus_tpu" else DeviceQuarantinedError
    with pytest.raises(refused):
        wd.run(lambda: 1, deadline=time.monotonic() + 10)
    assert (wd.host_only() if pkg == "janus_tpu" else wd.device_down()) is True
    for g in gates:
        g.set()


# --- the engine's quarantine and canary ---------------------------------------


def test_hang_quarantines_engine_then_canary_restores(hang_bound):
    """The device circuit's cycle: a hung dispatch raises DeviceHangError
    (not absorbed by the memory ladder), the quarantined engine refuses
    the interim init before staging anything (janus_tpu serves it from
    its host engine) and the canary's probe restores the device path
    with the initial caps."""
    eng = _engine(delay=30.0)  # the test wakes the canary itself
    args = _batch()
    want = _rows(eng.leader_init(*args[:5]))
    _hang(eng)
    assert eng._quarantined and eng._backend_state() == "quarantined" and not eng.resident_ready()
    assert eng._backend_state() in EngineCache.BACKEND_STATES
    assert device_watchdog.WATCHDOG.status()["abandoned_threads"] == 1

    dispatched = []
    real = eng._dispatch
    eng._dispatch = lambda name, fn, *a: dispatched.append(name) or real(name, fn, *a)
    with pytest.raises(DeviceQuarantinedError) as ei:
        eng.leader_init(*args[:5])
    assert 0.0 < ei.value.retry_in_s <= 30.0 and dispatched == []
    with pytest.raises(DeviceQuarantinedError):
        eng.prestage_leader(*args[:5])

    eng.bucket_cap = 32  # a cap the ladder moved: the restore resets it
    eng._canary_wakeup.set()  # the cool-down ends now
    assert _wait(lambda: not eng._quarantined)
    st = eng.engine_status()
    assert st["backend"] == "device" and eng.bucket_cap == eng._initial_bucket_cap
    assert st["quarantine"]["opened"] == 1 and st["quarantine"]["restored"] == 1
    assert st["quarantine"]["refused"] == 2 and st["quarantine"]["last_probe_s"] >= 0
    assert _same_rows(_rows(eng.leader_init(*args[:5])), want)
    assert eng.aggregate(eng.leader_init(*args[:5])[0], np.ones(4, dtype=bool)) is not None


def test_canary_failure_backs_off_then_restores(hang_bound):
    """While the device stays wedged (engine.canary hangs too) the engine
    stays quarantined and the canary backs off, doubling its delay; once
    the wedge clears the next probe restores."""
    eng = _engine(delay=0.05)
    eng.QUARANTINE_CANARY_TIMEOUT_SECS = 0.1
    args = _batch(seed=3)
    failpoints.configure("engine.dispatch=hang,count=1;engine.canary=hang")
    with dl.deadline_scope(time.monotonic() + 4 * HANG_BOUND_S):
        with pytest.raises(DeviceHangError):
            eng.leader_init(*args[:5])
    assert _wait(lambda: eng.quarantine_stats["canary_failed"] >= 2)
    assert eng._quarantined
    st = eng.engine_status()["quarantine"]  # each failure doubled the delay
    assert st["canary_delay_s"] == pytest.approx(0.05 * 2 ** st["canary_failed"])
    failpoints.release_hangs()  # the parked probes raise and retire
    failpoints.clear()
    assert _wait(lambda: not eng._quarantined)
    assert eng.quarantine_stats["restored"] == 1


def test_stop_canary_ends_loop_without_probe():
    eng = _engine(delay=30.0)  # far off: the wait is real
    eng._quarantine_on_hang("test")
    assert eng._quarantined and eng._canary_thread.is_alive()
    eng.stop_canary(timeout_s=5.0)
    assert not eng._canary_thread.is_alive()
    assert eng._quarantined and eng.quarantine_stats["canary_probes"] == 0


def test_cap_trips_device_down_for_every_engine(monkeypatch, hang_bound):
    """The abandoned-thread cap: every engine refuses for the life of the
    process (the port's divergence from janus_tpu's host-only mode), and
    no canary starts."""
    monkeypatch.setattr(device_watchdog.WATCHDOG, "abandoned_thread_cap", 1)
    eng, other = _engine(), EngineCache(t_registry.VdafInstance.sum_vec(3, 2), VK, device="cpu")
    _hang(eng)
    assert device_watchdog.WATCHDOG.device_down()
    assert eng._canary_thread is None
    for e in (eng, other):
        assert e._backend_state() == "device_down" and not e.resident_ready()
        with pytest.raises(DeviceQuarantinedError) as ei:
            e.aggregate((np.zeros((4, 1), np.uint64),) * e.p3.tf.LIMBS, np.ones(4, dtype=bool))
        assert ei.value.retry_in_s == device_watchdog.DEVICE_DOWN_RETRY_S


# --- the drivers -------------------------------------------------------------


@pytest.mark.parametrize("reason", ["device_hang", "device_quarantined"])
def test_stepper_steps_back_on_deadline_and_hang(sides, monkeypatch, reason):  # noqa: F811 - the fixture
    """A hung dispatch and a refused one are step-backs (lease released,
    attempt refunded), never failed attempts; the hang leaves janus_tpu's
    rows, the refusal comes back after its retry_in_s (at least
    min_step_back_delay_s)."""
    j, t = sides(_leader_task())
    drivers = {
        "jax": j_driver.AggregationJobDriver(j.ds, None, breakers=j_cb.OutboundCircuitBreakers()),
        "torch": t_driver.AggregationJobDriver(t.ds, None, breakers=t_cb.OutboundCircuitBreakers(), device=CPU),
    }
    errors = {
        "device_hang": {"jax": j_watchdog.DeviceHangError("leader_init", 4.0),
                        "torch": DeviceHangError("leader_init", 4.0)},
        "device_quarantined": {"torch": DeviceQuarantinedError("count leader_init", 3.2)},
    }[reason]
    rows = {}
    for side in (j, t):
        if side.pkg not in errors:
            continue
        drv, exc = drivers[side.pkg], errors[side.pkg]
        side.put_job(bytes(16), [])
        (acquired,) = drv.acquirer()(1)
        monkeypatch.setattr(drv, "step_aggregation_job", lambda a, exc=exc: (_ for _ in ()).throw(exc))
        drv.stepper(acquired)  # must not raise
        rows[side.pkg] = side.job_rows()
    want_delay = 1 if reason == "device_hang" else 3
    assert rows["torch"][0][2:5] == (NOW + want_delay, 1, 0)  # released, refunded, back after the delay
    if reason == "device_hang":
        assert rows["torch"] == rows["jax"]
    assert drivers["torch"].step_backs == {reason: 1}
    t.advance(want_delay)
    (again,) = drivers["torch"].acquirer()(1)
    assert again.lease.attempts == 1


# --- the helper --------------------------------------------------------------


@pytest.fixture()
def helper_app():
    token = AuthenticationToken.random_bearer()
    task = (
        TaskBuilder(QueryTypeConfig.time_interval(), t_registry.VdafInstance.count(), tm.Role.HELPER)
        .with_(aggregator_auth_token=token, vdaf_verify_key=VK)
        .build()
    )
    eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
    eph.datastore.run_tx(lambda tx: tx.put_task(task))
    from janus_tpu_torch.aggregator.core import Aggregator

    app = t_http.DapHttpApp(Aggregator(eph.datastore, eph.clock, device=CPU))
    yield task, token, app
    app.close()
    eph.cleanup()


def _b64(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def test_helper_sheds_503_while_its_engine_is_quarantined(helper_app):
    """Both aggregate routes shed 503 with Retry-After before any decode
    or HPKE work (the body here is not even decodable) while the task's
    engine is quarantined, and answer again once it is restored."""
    task, token, app = helper_app
    eng = app.agg.task_aggregator_for(task.task_id).engine
    eng.QUARANTINE_CANARY_DELAY_SECS = 2.5
    eng._quarantine_on_hang("test")
    path = f"/tasks/{_b64(task.task_id.data)}/aggregation_jobs/{_b64(bytes(16))}"
    for method, media in (("PUT", tm.AggregationJobInitializeReq.MEDIA_TYPE),
                          ("POST", tm.AggregationJobContinueReq.MEDIA_TYPE)):
        status, ctype, body, extra = app.handle(method, path, {}, {"Content-Type": media, **token.request_headers()},
                                                b"garbage")
        assert (status, ctype) == (503, "application/problem+json")
        assert extra == {"Retry-After": "3"} and b"device_quarantined" in body
    eng.stop_canary()
    with eng._oom_lock:
        eng._quarantined = False
    status, *_ = app.handle("PUT", path, {}, {"Content-Type": tm.AggregationJobInitializeReq.MEDIA_TYPE,
                                              **token.request_headers()}, b"garbage")
    assert status == 400  # decoded (and refused as undecodable) again


def test_helper_budget_shorter_than_its_dispatch_is_no_quarantine(helper_app):
    """A leader whose request budget is shorter than the helper's dispatch
    gets 408; the dispatch runs on detached, the engine stays on the
    device path and the next request is answered."""
    from janus_tpu_torch.aggregator.testing import leader_init_request

    task, token, app = helper_app
    eng = app.agg.task_aggregator_for(task.task_id).engine
    args = list(_batch(seed=9))
    headers = {"Content-Type": tm.AggregationJobInitializeReq.MEDIA_TYPE, **token.request_headers()}
    answers = []
    before = device_watchdog.WATCHDOG.status()
    for i, budget in enumerate(("0.5", None)):
        job = leader_init_request(task, eng, args, [NOW - 100] * 4)
        if budget is not None:
            # the helper's dispatch outlasts the leader's budget
            failpoints.configure("engine.dispatch=delay:1.5,count=1")
        path = f"/tasks/{_b64(task.task_id.data)}/aggregation_jobs/{_b64(bytes([i]) * 16)}"
        hdrs = dict(headers, **({dl.DEADLINE_HEADER: budget} if budget is not None else {}))
        answers.append(app.handle("PUT", path, {}, hdrs, job.request)[0])
        assert eng._backend_state() == "device" and eng.quarantine_stats["opened"] == 0
        failpoints.clear()
        assert _wait(lambda: len(device_watchdog.WATCHDOG._idle) >= 1)  # the detached worker is back
    assert answers == [408, 200]
    st = device_watchdog.WATCHDOG.status()
    assert st["budget_spent_total"] == before["budget_spent_total"] + 1 and st["abandoned_threads"] == 0
    assert st["hung_dispatches_total"] == before["hung_dispatches_total"]


@pytest.mark.parametrize("pkg", ["janus_tpu", "torch"])
def test_hang_inside_handler_answers_as_janus_tpu(monkeypatch, pkg):
    """A DeviceHangError escaping the aggregate-init handler answers 500
    (janus_tpu's answer for it); a refusal raised inside answers the 503
    shed in the port."""
    http, hang = (j_http, j_watchdog.DeviceHangError) if pkg == "janus_tpu" else (t_http, DeviceHangError)
    app = http.DapHttpApp.__new__(http.DapHttpApp)

    class _Admission:
        def admit(self, route_class, deadline=None):
            pass

    monkeypatch.setattr(http.DapHttpApp, "_ensure_ingest", lambda self: (None, _Admission()))
    raised = [hang("helper_init", 0.5)]
    if pkg == "torch":
        raised.append(DeviceQuarantinedError("count helper_init", 1.5))
    answers = []
    for exc in raised:
        monkeypatch.setattr(http.DapHttpApp, "h_aggregate_init",
                            lambda self, match, query, headers, body, exc=exc: (_ for _ in ()).throw(exc))
        answers.append(app._handle("PUT", f"/tasks/{'A' * 43}/aggregation_jobs/{'B' * 22}", {},
                                   {"Content-Type": tm.AggregationJobInitializeReq.MEDIA_TYPE}, b""))
    assert answers[0] == (500, "text/plain", b"internal error")
    if pkg == "torch":
        assert answers[1][0] == 503 and answers[1][3] == {"Retry-After": "2"}


# --- the coalescer under a hang -------------------------------------------------


@pytest.mark.parametrize("pkg", ["janus_tpu", "torch"])
def test_failing_round_fails_every_entry_and_queued_ones_run_next(pkg):
    """janus_tpu's `_Coalescer` and the port's alike: every entry of a
    round that raises gets the error (the dispatcher's and the waiters'),
    and the entries queued behind it run in the next round; no waiter is
    left parked."""
    ec, hang = (j_ec, j_watchdog.DeviceHangError) if pkg == "janus_tpu" else (t_ec, DeviceHangError)
    rounds = []
    first_in, go = threading.Event(), threading.Event()

    def run(args_list, ns):
        rounds.append(list(args_list))
        if len(rounds) == 1:
            first_in.set()
            go.wait(5)
            return ["a"]
        if len(rounds) == 2:
            raise hang("leader_init", 0.1)
        return [f"ok{a}" for a in args_list]

    co = ec._Coalescer(run, max_rows=100)
    results = {}

    def submit(key):
        try:
            results[key] = co.submit(key, 1)
        except Exception as e:  # noqa: BLE001 - recorded for the asserts
            results[key] = type(e).__name__

    threads = [threading.Thread(target=submit, args=("a",))]
    threads[0].start()
    assert first_in.wait(5)
    for key in ("b", "c"):  # queue behind the running round
        threads.append(threading.Thread(target=submit, args=(key,)))
        threads[-1].start()
    assert _wait(lambda: len(co._queue) == 2)
    go.set()
    for t in threads:
        t.join(5)
    assert not any(t.is_alive() for t in threads)
    threads = [threading.Thread(target=submit, args=(k,)) for k in ("d", "e")]
    for t in threads:
        t.start()
        t.join(5)
    assert results == {"a": "a", "b": "DeviceHangError", "c": "DeviceHangError", "d": "okd", "e": "oke"}
    assert [sorted(r) for r in rounds] == [["a"], ["b", "c"], ["d"], ["e"]]


def test_hung_merged_round_fails_every_entry_then_queued_ones_are_refused(hang_bound):
    """On a real engine: a merged round of two inits hangs, both entries
    get DeviceHangError; the two queued behind it ride the next round,
    which the quarantined engine refuses before staging: both get
    DeviceQuarantinedError."""
    eng = _engine(delay=30.0)
    args = _batch()
    co = eng._co_leader
    real_run = co._run
    first_in, go = threading.Event(), threading.Event()
    calls = []

    def gated(args_list, ns):
        calls.append(len(args_list))
        if len(calls) == 1:
            first_in.set()
            go.wait(5)
        return real_run(args_list, ns)

    co._run = gated
    # the first round's dispatch goes through; the merged round's hangs
    failpoints.configure("engine.dispatch=hang,count=1,after=1")
    results = {}

    def init(key, budget_s):
        with dl.deadline_scope(time.monotonic() + budget_s):
            try:
                results[key] = type(eng.leader_init(*args[:5])[0]).__name__
            except Exception as e:  # noqa: BLE001 - recorded for the asserts
                results[key] = type(e).__name__

    threads = [threading.Thread(target=init, args=("a", 10.0))]
    threads[0].start()
    assert first_in.wait(5)
    for key in ("b", "c"):
        threads.append(threading.Thread(target=init, args=(key, 4 * HANG_BOUND_S)))
        threads[-1].start()
    assert _wait(lambda: len(co._queue) == 2)
    go.set()
    assert _wait(lambda: len(calls) == 2)  # the merged round runs (and hangs)
    for key in ("d", "e"):
        threads.append(threading.Thread(target=init, args=(key, 10.0)))
        threads[-1].start()
    assert _wait(lambda: len(co._queue) == 2)
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert results == {"a": "DeviceRows", "b": "DeviceHangError", "c": "DeviceHangError",
                       "d": "DeviceQuarantinedError", "e": "DeviceQuarantinedError"}
    assert calls == [1, 2, 2] and eng._quarantined
    eng.stop_canary()


# --- the worker's stream and prestaged columns ---------------------------------------


def test_prestaged_leader_init_under_armed_deadline_equals_janus_tpu():
    """A prestaged and a plain leader init under an armed deadline run on
    the watchdog's worker and give rows bit-identical to the direct init
    and to janus_tpu's."""
    eng = EngineCache(t_registry.VdafInstance.count(), VK, device="cpu")
    args = _batch(n=5, seed=77)
    direct = _rows(eng.leader_init(*args[:5]))
    threads = []
    real_step = eng._leader_step
    eng._leader_step = lambda *a: threads.append(threading.current_thread().name) or real_step(*a)
    with dl.deadline_scope(time.monotonic() + 30):
        pre = eng.prestage_leader(*args[:5])
        staged = _rows(eng.leader_init(*args[:5], prestaged=pre))
        plain = _rows(eng.leader_init(*args[:5]))
    assert eng.prestage_stats == {"issued": 1, "used": 1, "discarded": 0}
    assert len(threads) == 2 and all(name.startswith("device-watchdog-") for name in threads)
    with jax_single_device():
        want = j_ec.EngineCache(j_registry.VdafInstance.count(), VK).leader_init(*args[:5])
    want = ([np.asarray(x) for x in want[0].to_numpy()], want[1], [np.asarray(x) for x in want[2]], want[3])
    for got in (staged, plain):
        assert _same_rows(got, direct) and _same_rows(got, want)


# --- resident slots under a quarantine -----------------------------------------


def _resident_engine():
    """A quarantined-to-be engine holding one resident slot of 4 rows; its
    canary waits until the test wakes it."""
    eng = _engine(delay=30.0)
    args = _batch(seed=5)
    out0 = eng.leader_init(*args[:5])[0]
    deltas = eng.aggregate_pending(out0, np.zeros(4, np.int32), 1)
    key = (bytes(32), b"", b"batch")
    eng.resident_merge([(key, 0, 4, tm.Interval(tm.Time(0), tm.Duration(3600)))], deltas)
    want = eng.aggregate(out0, np.ones(4, dtype=bool))
    return eng, key, want


def _flush_driver(monkeypatch, engines):
    drv = t_driver.AggregationJobDriver(None, None, device="cpu")
    flushed = []
    monkeypatch.setattr(t_driver, "live_engines", lambda: engines)
    monkeypatch.setattr(drv, "flush_resident_records",
                        lambda engine, recs, reason: flushed.append((reason, recs)) or len(recs))
    return drv, flushed


def _watch_fetches(monkeypatch, eng, gate=None):
    """Record each resident fetch's thread and deadline; with a gate, the
    fetch parks on it (a wedged fetch)."""
    seen = []
    real = eng._fetch

    def fetch(label, fn):
        def body():
            seen.append((threading.current_thread().name, dl.current_deadline()))
            if gate is not None:
                gate.wait()
            return fn()

        return real(label, body) if label == "resident_fetch" else real(label, fn)

    monkeypatch.setattr(eng, "_fetch", fetch)
    return seen


def test_quarantine_flushes_resident_slots_through_a_bounded_fetch(monkeypatch):
    eng, key, want = _resident_engine()
    drv, flushed = _flush_driver(monkeypatch, [eng])
    seen = _watch_fetches(monkeypatch, eng)
    eng._quarantine_on_hang("test")
    with pytest.raises(DeviceQuarantinedError):  # the merge path refuses
        eng.aggregate_pending(None, np.zeros(0, np.int32), 1)
    t0 = time.monotonic()
    assert drv.flush_resident_state() == 1
    ((reason, (rec,)),) = flushed
    assert reason == "quarantine" and rec["key"] == key and rec["share"] == want
    ((thread, deadline),) = seen
    assert thread.startswith("device-watchdog-")
    assert 0 < deadline - t0 <= t_driver.RESIDENT_FLUSH_FETCH_BOUND_S + 0.5
    assert eng.resident_status()["buffers"] == 0
    eng.stop_canary()


def test_resident_flusher_sweeps_a_quarantined_engine_at_its_poll(monkeypatch):
    """Between its interval passes (5 s here) the flusher sweeps every
    second: a quarantined engine's slots flush then, reason
    "quarantine"; a healthy engine's wait for the interval."""
    eng, key, want = _resident_engine()
    healthy, _, _ = _resident_engine()
    drv, flushed = _flush_driver(monkeypatch, [healthy, eng])
    eng._quarantine_on_hang("test")
    flusher = t_driver.ResidentFlusher(drv, interval_s=5.0).start()
    try:
        assert flusher.poll_s == 1.0 and _wait(lambda: flushed, timeout=3.0)
    finally:
        flusher.stop()
    ((reason, (rec,)),) = flushed
    assert reason == "quarantine" and rec["share"] == want
    assert healthy.resident_status()["buffers"] == 1
    eng.stop_canary()


def test_hung_quarantine_fetch_keeps_slots_until_the_canary_restores(monkeypatch):
    monkeypatch.setattr(t_driver, "RESIDENT_FLUSH_FETCH_BOUND_S", 0.3)
    eng, key, want = _resident_engine()
    drv, flushed = _flush_driver(monkeypatch, [eng])
    gate = threading.Event()
    seen = _watch_fetches(monkeypatch, eng, gate=gate)
    eng._quarantine_on_hang("test")
    assert drv.flush_engine_resident(eng, reason="quarantine") == 0  # the fetch hung: restored
    assert eng._quarantine_fetch_hung and eng.resident_status()["buffers"] == 1
    # the next sweep fetches nothing: the slots wait for the restore
    assert drv.flush_engine_resident(eng, reason="quarantine") == 0 and len(seen) == 1
    gate.set()
    eng._canary_wakeup.set()  # the cool-down ends now
    assert _wait(lambda: not eng._quarantined)
    assert eng.resident_ready() and not eng._quarantine_fetch_hung
    assert drv.flush_resident_state() == 1
    ((reason, (rec,)),) = flushed
    assert reason == "interval" and rec["key"] == key and rec["share"] == want
    assert eng.resident_status()["buffers"] == 0


def test_rehearse_chip_smoke_device_hang_drill():
    """chip_smoke.py's device-hang-drill on the CPU, at SumVec(4, 2), 3 jobs
    of 4 reports, the hung step under a 3 s lease and a 0.5 s hang bound
    (the card runs it at SumVec(1000, 16), 4 s and 1 s)."""
    import chip_smoke

    rec = chip_smoke.phase_device_hang_drill(torch, CPU, t_registry.VdafInstance.sum_vec(4, 2), job_size=4,
                                             lease_s=3, hang_after_s=0.5)
    assert [reason for reason, _ in rec["step_backs"]] == ["device_hang", "device_quarantined"]
    assert rec["watchdog"]["abandoned_threads"] == 1 and rec["helper_shed"]["status"] == 503
    assert rec["engine"]["quarantine"]["restored"] == 1 and rec["supervised_prestaged_equal"]
    assert device_watchdog.WATCHDOG.hang_after_s == device_watchdog.HANG_AFTER_S  # the drill put it back
    assert rec["collect"]["result_ok"]
