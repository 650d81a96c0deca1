"""janus_tpu_torch's stage pipeline held against janus_tpu.

Mirrors tests/test_step_pipeline.py on the port's StepPipeline, over
loopback HTTP against a port helper (device="cpu"): the pipelined step
end to end, a two-round job parked then continued, a stage error mapped
to the serial stepper's step-back (circuit open, a lease budget dying
between stages or already dead at the read), the shutdown drain's lease
release, an unhandled stage error leaving the lease to expire, the
device lane serializing dispatches under concurrent jobs, abandonment
past the attempts ceiling, and a device hang on the lane stepping back
`device_hang` (with the port's refusal by a quarantined engine, raised
by the read stage's prestage, stepping back `device_quarantined`).

Added: prestaged columns used on a single lane and declined on a
parallel one (where a merged round would discard them); a prestage that
fails for anything but memory fails the step, one that runs out of
memory stages from the host and is counted; and the two mixed pairings
with janus_tpu, a port leader (pipeline and resident accumulators)
against a janus_tpu helper and a janus_tpu leader (pipeline and resident
accumulators) against a port helper (its inits through the coalescer),
whose rows after the drain flush and whose collections equal a janus_tpu
pair's serial run and the ground truth. Tolerance: exact equality.
"""

import dataclasses
import time

import pytest
import torch

from janus_tpu.aggregator import step_pipeline as j_pipeline
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.aggregator import step_pipeline as t_pipeline
from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig, Stopper
from janus_tpu_torch.aggregator.step_pipeline import StepPipeline, StepPipelineConfig
from janus_tpu_torch.core.circuit_breaker import CircuitOpenError
from janus_tpu_torch.core.deadline import DeadlineExceeded
from janus_tpu_torch.messages import Duration

from test_torch_multi_round import PKG, Pairing, make_tasks, prepare_reports, query_for

TASKS = {"count": make_tasks(j_registry.VdafInstance.count()),
         "two_round": make_tasks(j_registry.VdafInstance.fake_two_round())}
REPORTS = {k: prepare_reports(t[0], t[1], [1, 0, 1, 1, 0, 1, 1, 1]) for k, t in TASKS.items()}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("JANUS_MESH_DP", "1")
    monkeypatch.setenv("JANUS_MESH_SP", "1")
    t_ec.engine_cache.cache_clear()
    yield
    t_ec.engine_cache.cache_clear()


@pytest.fixture()
def pair(monkeypatch):
    p = Pairing(monkeypatch, "torch", "torch", *TASKS["count"])
    yield p
    p.close()


def _jobs(pair, n_reports, size, kind="count"):
    pair.upload(REPORTS[kind][:n_reports])
    return pair.lp.creator.AggregationJobCreator(
        pair.l_eph.datastore,
        pair.lp.creator.AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=size),
    ).run_once()


def _driver(pair, pkg="torch", resident=False):
    lp = PKG[pkg]
    cfg = lp.adriver.AggregationJobDriverConfig(
        http_backoff=lp.retries.Backoff.test(),
        resident=lp.adriver.ResidentConfig(enabled=resident, flush_interval_s=3600.0),
    )
    return lp.adriver.AggregationJobDriver(pair.l_eph.datastore, pair.http(), cfg,
                                          breakers=lp.cb.OutboundCircuitBreakers(), **lp.adriver_kw)


def _job_rows(pair):
    """(state, lease released, attempts) of every leader job."""
    return sorted(pair.l_eph.datastore.run_tx(lambda tx: tx._c.execute(
        "SELECT state, lease_token IS NULL, lease_attempts FROM aggregation_jobs").fetchall()))


def _steps_back(drv):
    """Record the step-backs' reasons on the driver."""
    reasons = []
    real = drv.step_back

    def step_back(acquired, reason, delay_s):
        reasons.append(reason)
        return real(acquired, reason, delay_s)

    drv.step_back = step_back
    return reasons


def _run(drv, cfg=None, workers=4, **kw):
    pipe = StepPipeline(drv, cfg or StepPipelineConfig(), **kw)
    try:
        jd = JobDriver(JobDriverConfig(max_concurrent_job_workers=workers), drv.acquirer(), drv.stepper,
                       pipeline=pipe)
        while jd.run_once():
            pass
        return pipe.status()
    finally:
        pipe.close()


def _one_leased(pair):
    assert _jobs(pair, 3, 100) == 1
    drv = _driver(pair)
    (acquired,) = drv.acquirer()(1)
    return drv, acquired


def _submit(drv, acquired, **kw):
    pipe = StepPipeline(drv, StepPipelineConfig(), **kw)
    try:
        pipe.submit(acquired).result(timeout=60)
        return pipe.status()
    finally:
        pipe.close()


def test_config_from_dict_is_janus_tpus():
    # every field the port has equals janus_tpu's (its `enabled` switch
    # has no counterpart: the port's JobDriver takes a pipeline or none)
    for d in (None, {}, {"prefetch_depth": 0, "http_inflight": 3, "device_lane_workers": 2, "double_buffer": False},
              {"enabled": False, "commit_inflight": 5}):
        mine = dataclasses.asdict(StepPipelineConfig.from_dict(d))
        theirs = dataclasses.asdict(j_pipeline.StepPipelineConfig.from_dict(d))
        assert mine == {k: theirs[k] for k in mine}


def test_pipelined_step_end_to_end(pair):
    assert _jobs(pair, 6, 2) == 3
    drv = _driver(pair)
    status = _run(drv)
    assert _job_rows(pair) == [("finished", 1, 0)] * 3
    assert status["jobs_done"] == 3
    assert status["device_lane"]["dispatches"] == 6  # init and accumulate a job
    assert status["device_lane"]["concurrent_peak"] == 1
    assert status["classic_fallbacks"] == 0
    eng = t_ec.engine_cache(pair.task.vdaf, pair.task.vdaf_verify_key, "cpu")
    assert eng.prestage_stats["issued"] == 3 and eng.prestage_stats["used"] == 3


def test_pipelined_multi_round_parks_and_finishes(monkeypatch):
    pair = Pairing(monkeypatch, "torch", "torch", *TASKS["two_round"])
    try:
        assert _jobs(pair, 3, 100, "two_round") == 1
        drv = _driver(pair)
        pipe = StepPipeline(drv, StepPipelineConfig())
        try:
            jd = JobDriver(JobDriverConfig(), drv.acquirer(), drv.stepper, pipeline=pipe)
            assert jd.run_once() == 1
            assert pair.states("leader") == ["waiting_leader"] and pair.states("helper") == ["waiting_helper"]
            assert jd.run_once() == 1  # the continue step, a classic stage
            assert sorted(pipe.stage_seconds) == ["classic", "commit", "device", "http", "read"]
        finally:
            pipe.close()
        assert pair.states("leader") == ["finished"] and _job_rows(pair) == [("finished", 1, 0)]
    finally:
        pair.close()


def test_stage_error_maps_to_step_back_with_attempt_refunded(pair):
    drv, acquired = _one_leased(pair)
    reasons = _steps_back(drv)

    def open_circuit(st):
        raise CircuitOpenError("helper", 0.0)

    drv.http_init = open_circuit
    _submit(drv, acquired)
    assert reasons == ["circuit_open"]
    assert _job_rows(pair) == [("in_progress", 1, 0)]
    pair.l_eph.clock.advance(Duration(2))
    (again,) = drv.acquirer()(1)
    assert again.lease.attempts == acquired.lease.attempts


def test_deadline_expiry_between_stages_steps_back(pair):
    drv, acquired = _one_leased(pair)
    reasons = _steps_back(drv)
    drv._lease_deadline = lambda a: time.monotonic() + 0.1
    orig = drv.stage_init

    def slow_stage(*a, **kw):
        st = orig(*a, **kw)
        time.sleep(0.3)  # the budget dies while the job heads to the lane
        return st

    drv.stage_init = slow_stage
    _submit(drv, acquired)
    assert reasons == ["deadline_expired"]
    assert _job_rows(pair) == [("in_progress", 1, 0)]


@pytest.mark.parametrize("fault", ["hang", "refusal"])
def test_device_hang_in_lane_steps_back(pair, fault):
    """A hung dispatch on the device lane and a quarantined engine's
    refusal are step-backs with the attempt refunded, never failed
    attempts."""
    from janus_tpu_torch.aggregator.device_watchdog import DeviceHangError

    drv, acquired = _one_leased(pair)
    reasons = _steps_back(drv)
    eng = t_ec.engine_cache(pair.task.vdaf, pair.task.vdaf_verify_key, "cpu")
    if fault == "hang":
        drv.device_init = lambda st: (_ for _ in ()).throw(DeviceHangError("leader_init", 0.1))
    else:
        eng.QUARANTINE_CANARY_DELAY_SECS = 3600.0
        eng._quarantine_on_hang("test")
    try:
        _submit(drv, acquired)
    finally:
        eng.stop_canary()
    assert reasons == ["device_hang" if fault == "hang" else "device_quarantined"]
    assert _job_rows(pair) == [("in_progress", 1, 0)]


def test_shutdown_drain_releases_failing_lease(pair):
    drv, acquired = _one_leased(pair)

    def boom(st):
        raise RuntimeError("stage exploded mid-drain")

    drv.http_init = boom
    stopper = Stopper()
    stopper.stop()
    released = []
    _submit(drv, acquired, stopper=stopper,
            releaser=lambda a: released.append(a) or drv.step_back(a, "shutdown_drain", 0.0))
    assert released == [acquired]
    assert _job_rows(pair) == [("in_progress", 1, 0)]


def test_unhandled_stage_error_leaves_lease_to_expire(pair):
    drv, acquired = _one_leased(pair)

    def boom(st):
        raise RuntimeError("unexpected stage failure")

    drv.device_init = boom
    _submit(drv, acquired)
    assert _job_rows(pair) == [("in_progress", 0, 1)]  # still leased


def test_device_lane_serializes_under_concurrent_jobs(pair):
    assert _jobs(pair, 8, 2) == 4
    drv = _driver(pair)
    orig = drv.device_init

    def slow_device_init(st):
        time.sleep(0.05)  # widen the window a concurrent dispatch would need
        return orig(st)

    drv.device_init = slow_device_init
    status = _run(drv, StepPipelineConfig(device_lane_workers=1))
    assert _job_rows(pair) == [("finished", 1, 0)] * 4
    assert status["device_lane"]["concurrent_peak"] == 1
    assert status["device_lane"]["dispatches"] == 8


def test_expired_lease_at_read_steps_back(pair):
    drv, acquired = _one_leased(pair)
    reasons = _steps_back(drv)

    def expired(a):
        raise DeadlineExceeded("lease already expired (test)")

    drv._lease_deadline = expired
    _submit(drv, acquired)
    assert reasons == ["deadline_expired"]


def test_abandon_after_max_attempts_still_applies(pair):
    drv, acquired = _one_leased(pair)
    over = dataclasses.replace(
        acquired, lease=dataclasses.replace(acquired.lease, attempts=drv.cfg.maximum_attempts_before_failure + 1)
    )
    _submit(drv, over)
    assert [r[0] for r in _job_rows(pair)] == ["abandoned"]


def test_parallel_lane_declines_prestage_of_jobs_that_would_coalesce(pair):
    """Two lane workers: the read stage declines every prestage (each job
    would enter a coalesced round), and the jobs still finish."""
    assert _jobs(pair, 6, 2) == 3
    drv = _driver(pair)
    status = _run(drv, StepPipelineConfig(device_lane_workers=2))
    assert _job_rows(pair) == [("finished", 1, 0)] * 3
    assert status["prestage"] == {"declined": 3, "oom_fallbacks": 0}
    eng = t_ec.engine_cache(pair.task.vdaf, pair.task.vdaf_verify_key, "cpu")
    assert eng.prestage_stats["issued"] == 0


@pytest.mark.parametrize("error", ["device", "memory"])
def test_prestage_error_fails_the_step_unless_it_is_memory(pair, monkeypatch, error):
    """janus_tpu stages from the host after any prestage error; the port
    does so after memory exhaustion only (counted), and fails the step on
    any other error: the lease stays until it expires."""
    drv, acquired = _one_leased(pair)
    exc = (RuntimeError("CUDA error: misaligned address") if error == "device"
           else torch.cuda.OutOfMemoryError("CUDA out of memory"))

    def prestage(*a, **kw):
        raise exc

    monkeypatch.setattr(t_ec.EngineCache, "prestage_leader", prestage)
    status = _submit(drv, acquired)
    if error == "device":
        assert _job_rows(pair) == [("in_progress", 0, 1)]
        assert status["prestage"]["oom_fallbacks"] == 0
    else:
        assert _job_rows(pair) == [("finished", 1, 0)]
        assert status["prestage"]["oom_fallbacks"] == 1 and status["classic_fallbacks"] == 1


# --- mixed pairings with janus_tpu, resident and pipelined ---

N_REPORTS = 8
JOB_SIZE = 3
_REFERENCE: dict = {}


def _pairing_run(monkeypatch, leader, helper, pipelined):
    pair = Pairing(monkeypatch, leader, helper, *TASKS["count"])
    try:
        assert _jobs(pair, N_REPORTS, JOB_SIZE) == 3
        drv = _driver(pair, leader, resident=pipelined)
        lp = PKG[leader]
        if pipelined:
            pipe_mod = t_pipeline if leader == "torch" else j_pipeline
            pipe = pipe_mod.StepPipeline(drv, pipe_mod.StepPipelineConfig())
        else:
            pipe = None
        try:
            jd = lp.jobs.JobDriver(lp.jobs.JobDriverConfig(max_concurrent_job_workers=2), drv.acquirer(),
                                   drv.stepper, pipeline=pipe)
            while jd.run_once():
                pass
        finally:
            if pipe is not None:
                pipe.close()
        if pipelined:
            assert drv.flush_resident_state(reason="drain") == 1
        job_id = pair.collector(leader).start_collection(query_for(lp.m)).data
        assert pair.collection_jobs().run_once() == 1
        return {"rows": pair.rows(), "results": pair.poll_all(job_id)}
    finally:
        pair.close()


@pytest.mark.parametrize("pairing", ["torch-jax", "jax-torch"])
def test_pipelined_resident_pairing_matches_a_janus_tpu_pair(monkeypatch, pairing):
    if "ref" not in _REFERENCE:
        _REFERENCE["ref"] = _pairing_run(monkeypatch, "jax", "jax", pipelined=False)
    want = _REFERENCE["ref"]
    leader, helper = pairing.split("-")
    got = _pairing_run(monkeypatch, leader, helper, pipelined=True)
    truth = (N_REPORTS, sum([1, 0, 1, 1, 0, 1, 1, 1][:N_REPORTS]))
    assert {(c, r) for c, _, r in got["results"].values()} == {truth}
    assert got["results"] == want["results"]
    assert got["rows"] == want["rows"]


def test_chip_smoke_pipeline_phases_rehearse_on_the_cpu():
    """chip_smoke.py's two pipeline phases at a small geometry on the CPU:
    the merged two-task round equal to the solo rounds, every prestage of
    the single lane used, the parallel lane's declined and its inits
    merged, a serial pass on the same driver, one merge a job,
    no classic fallback, and every collection equal to the truth."""
    import chip_smoke
    from janus_tpu_torch.vdaf.registry import VdafInstance

    cpu = torch.device("cpu")
    dense = chip_smoke.phase_pipeline_resident(
        torch, cpu, VdafInstance.sum_vec(4, 2), (chip_smoke.VERIFY_KEY, chip_smoke.VERIFY_KEY_B), 6, 2,
        ((0, 1), (1, 3)), ((1, 2), (4, 3), (0, 1)), 3)
    assert dense["merged_round"]["max_abs_err"] == 0 and dense["flushed_slots"] == 2
    assert [(r["prestage"]["used"], r["prestage"]["declined"], r["merges"]) for r in dense["runs"]] == [
        (2, 0, 2), (0, 3, 3), (0, 0, 1)]
    assert dense["runs"][1]["round_sizes"]["leader"] == [1, 2], "the held round, then the two queued behind it"
    assert dense["runs"][2]["stepper"] == "serial" and len(dense["runs"][2]["job_s"]["all"]) == 1
    assert [c["report_count"] for c in dense["collect"]] == [5, 5]
    sparse = chip_smoke.phase_pipeline_resident(
        torch, cpu, VdafInstance.sparse_sumvec(4, 96, 4, 3), (chip_smoke.VERIFY_KEY,), 4, 2, (), ((1, 2),))
    (run,) = sparse["runs"]
    assert run["merges"] == 2 and len(run["merge_s"]) == 2 and run["classic_fallbacks"] == 0
    assert sparse["resident_status"][0]["sparse"]["scatter_rows"] == 4
    assert [c["report_count"] for c in sparse["collect"]] == [4]
