"""Peer-outage parking in janus_tpu_torch, held against janus_tpu.

The port's counterparts of tests/test_peer_outage.py: while every known
helper's breaker is open the claim acquirers park (no claim
transaction), and the half-open probe resumes them.

- The tracker's predicate, endpoint registry and probe outcomes (alive on
  any HTTP status, dead on a transport error with the cooldown
  restarted, rejected without touching the wire when the half-open slot
  is taken, before the cooldown, or with no endpoint known), the tick's
  probe after the cooldown and the background prober: one parametrised
  test over both packages' trackers, on the same script.
- The tick's outage seconds and parked flags, read from the tracker's own
  state (janus_tpu's live in its process-wide metrics registry), with
  `tick(now=...)` only.
- `make_claim_acquirer(peer_gate=)`: a parked pass runs no claim
  transaction, on both datastore engines; both drivers wire the gate to
  their tracker and register the helper's endpoint on their send path.
- `peer_states` and `status` of the circuit breaker equal janus_tpu's on
  the same script.

Everything runs on the CPU; tolerance: exact equality.
"""

import time

import pytest

from janus_tpu.aggregator import peer_health as j_ph
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import peer_health as t_ph
from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver
from janus_tpu_torch.aggregator.job_driver import make_claim_acquirer
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core.circuit_breaker import CircuitOpenError
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
from janus_tpu_torch.vdaf.registry import VdafInstance

PEER_URL = "http://helper.test:9999/dap/"
PEER = "helper.test:9999"
PKGS = {"janus_tpu": (j_ph, j_cb), "torch": (t_ph, t_cb)}
NOW = 1_600_000_000


def _breakers(cb, threshold=1, cooldown=0.01):
    return cb.OutboundCircuitBreakers(cb.CircuitBreakerConfig(failure_threshold=threshold, open_cooldown_s=cooldown))


class _FakeFetch:
    """fetch_any_status stand-in: records calls, answers a status or raises."""

    def __init__(self, status=404, error=None):
        self.status = status
        self.error = error
        self.calls = 0

    def __call__(self, url, timeout=None, **kw):
        self.calls += 1
        if self.error is not None:
            raise self.error
        return self.status, b""


# --- the tracker, both packages ---------------------------------------------------


def _case_parks_only_when_every_peer_is_down(ph, cb):
    br = _breakers(cb)
    tr = ph.PeerHealthTracker(br)
    assert not tr.should_park()  # no peer known: never park
    br.record_success("helper-b:80")
    br.record_failure("helper-a:80")
    assert not tr.should_park() and tr.parked_peers() == ["helper-a:80"]  # a partial outage
    br.record_failure("helper-b:80")
    assert tr.should_park()
    return tr.parked_peers()


def _case_observe_endpoint(ph, cb):
    tr = ph.PeerHealthTracker(_breakers(cb))
    labels = [tr.observe_endpoint(PEER_URL), tr.observe_endpoint(PEER_URL + "tasks/x")]
    return labels, tr.status()["peers"][PEER]["endpoint"]


def _case_probe_alive(ph, cb):
    br = _breakers(cb)
    fetch = _FakeFetch(status=404)
    tr = ph.PeerHealthTracker(br, http=fetch)
    tr.observe_endpoint(PEER_URL)
    br.record_failure(PEER)
    time.sleep(0.02)
    return tr.probe(PEER), fetch.calls, br.state(PEER), tr.should_park(), tr.status()["peers"][PEER]["probes"]


def _case_probe_dead(ph, cb):
    br = _breakers(cb)
    tr = ph.PeerHealthTracker(br, http=_FakeFetch(error=ConnectionError("still dead")))
    tr.observe_endpoint(PEER_URL)
    br.record_failure(PEER)
    time.sleep(0.02)
    return tr.probe(PEER), br.state(PEER), br.retry_in_s(PEER) > 0  # the full cooldown restarted


def _case_probe_does_not_stampede(ph, cb):
    br = _breakers(cb)
    fetch = _FakeFetch()
    tr = ph.PeerHealthTracker(br, http=fetch)
    tr.observe_endpoint(PEER_URL)
    br.record_failure(PEER)
    time.sleep(0.02)
    br.check(PEER)  # a driver's own attempt holds the half-open slot
    return tr.probe(PEER), fetch.calls


def _case_probe_before_cooldown(ph, cb):
    br = _breakers(cb, cooldown=60.0)
    fetch = _FakeFetch()
    tr = ph.PeerHealthTracker(br, http=fetch)
    tr.observe_endpoint(PEER_URL)
    br.record_failure(PEER)
    return tr.probe(PEER), fetch.calls


def _case_probe_without_endpoint(ph, cb):
    br = _breakers(cb)
    br.record_failure(PEER)
    time.sleep(0.02)
    return ph.PeerHealthTracker(br, http=_FakeFetch()).probe(PEER)


def _case_tick_probes_after_cooldown(ph, cb):
    br = _breakers(cb)
    fetch = _FakeFetch(status=405)
    tr = ph.PeerHealthTracker(br, http=fetch)
    tr.observe_endpoint(PEER_URL)
    br.record_failure(PEER)
    time.sleep(0.02)
    tr.tick()
    return fetch.calls, br.state(PEER)


def _case_background_prober(ph, cb):
    br = _breakers(cb)
    fetch = _FakeFetch(status=404)
    tr = ph.PeerHealthTracker(br, ph.PeerHealthConfig(probe_interval_s=0.05, probe_timeout_s=0.5), http=fetch)
    tr.observe_endpoint(PEER_URL)
    br.record_failure(PEER)
    tr.start()
    try:
        deadline = time.monotonic() + 5.0
        while br.state(PEER) != "closed" and time.monotonic() < deadline:
            time.sleep(0.02)
        closed = br.state(PEER)
    finally:
        tr.stop()
    return closed, fetch.calls >= 1, tr._thread is None


TRACKER_CASES = {
    "parks_only_when_every_peer_is_down": (_case_parks_only_when_every_peer_is_down, ["helper-a:80", "helper-b:80"]),
    "observe_endpoint": (_case_observe_endpoint, ([PEER, PEER], PEER_URL)),
    "probe_alive": (_case_probe_alive, ("alive", 1, "closed", False, {"alive": 1, "dead": 0, "rejected": 0})),
    "probe_dead": (_case_probe_dead, ("dead", "open", True)),
    "probe_does_not_stampede": (_case_probe_does_not_stampede, ("rejected", 0)),
    "probe_before_cooldown": (_case_probe_before_cooldown, ("rejected", 0)),
    "probe_without_endpoint": (_case_probe_without_endpoint, "rejected"),
    "tick_probes_after_cooldown": (_case_tick_probes_after_cooldown, (1, "closed")),
    "background_prober": (_case_background_prober, ("closed", True, True)),
}


@pytest.mark.parametrize("case", sorted(TRACKER_CASES))
def test_tracker_matches_janus_tpu(case):
    fn, want = TRACKER_CASES[case]
    assert fn(*PKGS["torch"]) == fn(*PKGS["janus_tpu"]) == want


def test_tick_accrues_outage_seconds_and_parked_flag():
    """The accrual and the parked flag, read from the tracker's own state
    and driven by tick(now=...) alone: no shared counter to race."""
    br = _breakers(t_cb, cooldown=3600.0)  # the cooldown never ends: no probes
    tr = t_ph.PeerHealthTracker(br, http=_FakeFetch())
    tr.observe_endpoint(PEER_URL)
    br.record_failure(PEER)
    t0 = 1000.0
    tr.tick(now=t0)  # the first beat anchors the accrual
    tr.tick(now=t0 + 5.0)
    tr.tick(now=t0 + 7.5)
    st = tr.status()
    assert st["parked"] is True
    assert st["peers"][PEER]["parked"] is True and st["peers"][PEER]["outage_seconds_total"] == 7.5
    # recovery: the half-open probe succeeds; the next tick clears the
    # flag and stops the accrual
    br._peers[PEER].opened_at -= 7200.0
    br.check(PEER)
    br.record_success(PEER)
    tr.tick(now=t0 + 9.0)
    st = tr.status()
    assert st["parked"] is False and st["peers"][PEER]["parked"] is False
    assert st["peers"][PEER]["outage_seconds_total"] == 7.5


def test_breaker_peer_states_and_status_match_janus_tpu():
    out = []
    for cb in (j_cb, t_cb):
        br = _breakers(cb, threshold=2, cooldown=60.0)
        assert br.peer_states() == {}
        br.record_success("a:1")
        br.record_failure("b:2")
        br.record_failure("b:2")
        st = br.status()
        for peer in st["peers"].values():
            peer["retry_in_s"] = peer["retry_in_s"] > 0
        out.append((br.peer_states(), st))
    assert out[0] == out[1]
    assert out[1][0] == {"a:1": "closed", "b:2": "open"} and out[1][1]["peers"]["b:2"]["opens"] == 1


# --- the acquirer gate and the drivers ------------------------------------------------


def _task(role=tm.Role.LEADER, endpoint=PEER_URL):
    return (
        TaskBuilder(QueryTypeConfig.time_interval(), VdafInstance.count(), role)
        .with_(min_batch_size=1, helper_aggregator_endpoint=endpoint)
        .build()
    )


def _put_job(ds, task):
    job = t_models.AggregationJobModel(
        task.task_id, tm.AggregationJobId(bytes(16)), b"", tm.PartialBatchSelector.time_interval().to_bytes(),
        tm.Interval(tm.Time(NOW), tm.Duration(1)), t_models.AggregationJobState.IN_PROGRESS, 0,
    )
    ds.run_tx(lambda tx: tx.put_aggregation_job(job))


@pytest.mark.parametrize("engine", ["sqlite", "pgfake"])
def test_park_gate_skips_claim_transactions(engine):
    """A parked pass returns [] without opening a claim transaction; after
    the half-open probe closes the breaker, claims run again."""
    eph = EphemeralDatastore(clock=MockClock(tm.Time(NOW)), engine=engine)
    ds = eph.datastore
    try:
        task = _task()
        ds.run_tx(lambda tx: tx.put_task(task))
        _put_job(ds, task)
        br = _breakers(t_cb)
        tr = t_ph.PeerHealthTracker(br)
        tr.observe_endpoint(PEER_URL)
        claims = []

        def claim(limit):
            claims.append(limit)
            return ds.run_tx(lambda tx: tx.acquire_incomplete_aggregation_jobs(tm.Duration(600), limit), "acq")

        acquire = make_claim_acquirer(ds, "aggregation", claim, peer_gate=tr.park_gate())
        br.record_failure(PEER)
        assert tr.should_park() and acquire(8) == [] and claims == []
        time.sleep(0.02)
        br.check(PEER)
        br.record_success(PEER)
        assert len(acquire(8)) == 1 and claims == [8]
    finally:
        eph.cleanup()


def test_both_drivers_park_and_register_the_helper_endpoint():
    """Both drivers' acquirers park on their tracker, and their send
    paths register the task's helper endpoint before the first attempt
    (here the breaker refuses it, so nothing touches the wire)."""
    eph = EphemeralDatastore(clock=MockClock(tm.Time(NOW)))
    ds = eph.datastore
    try:
        task = Task.from_dict(_task().to_dict())
        ds.run_tx(lambda tx: tx.put_task(task))
        _put_job(ds, task)
        br = _breakers(t_cb, cooldown=3600.0)
        tr = t_ph.PeerHealthTracker(br)
        agg = AggregationJobDriver(ds, None, breakers=br, device="cpu", peer_health=tr)
        col = CollectionJobDriver(ds, None, breakers=br, peer_health=tr)
        br.record_failure(PEER)
        assert agg.acquirer()(4) == [] and col.acquirer()(4) == []
        assert tr.status()["peers"][PEER]["endpoint"] is None  # known to the breaker only
        (acquired,) = AggregationJobDriver(ds, None, breakers=t_cb.OutboundCircuitBreakers(),
                                           device="cpu").acquirer()(1)
        with pytest.raises(CircuitOpenError):
            agg._send_agg_job_request_raw(task, acquired, tm.AggregationJobInitializeReq(
                b"", tm.PartialBatchSelector.time_interval(), ()))
        with pytest.raises(CircuitOpenError):
            col._send_aggregate_share_request(task, tm.AggregateShareReq(
                tm.BatchSelector.time_interval(tm.Interval(tm.Time(NOW), tm.Duration(3600))), b"", 0,
                tm.ReportIdChecksum()))
        assert tr.status()["peers"][PEER]["endpoint"] == PEER_URL
    finally:
        eph.cleanup()


def test_rehearse_chip_smoke_peer_outage_drill():
    """chip_smoke.py's peer-outage-drill on the CPU, at SumVec(4, 2) and one
    job of 4 reports (the card runs it at SumVec(1000, 16), 256 reports)."""
    import torch

    import chip_smoke

    rec = chip_smoke.phase_peer_outage_drill(torch, torch.device("cpu"), VdafInstance.sum_vec(4, 2), job_size=4)
    assert rec["step_backs"] == [["circuit_open", 1]] and rec["claims_skipped"] == 3
    assert rec["probes"]["alive"] == 1 and rec["collect"]["result_ok"]
