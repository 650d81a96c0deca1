"""The port's datastore supervision held against janus_tpu's: the cases
of tests/test_datastore_outage.py on the port's modules.

- `classify_error` on both engines (SQLite, and Postgres over pg_fake)
  gives janus_tpu's class for every error of the table.
- run_tx retries injected commit conflicts and connect failures, backs
  off with full jitter under its cap, never retries a fatal error, and
  reports at most one connection-class failure per call to the
  supervisor; close() reaches every thread's connection; a dropped
  Postgres connection is discarded and redialed.
- The supervisor's transitions (and its readiness), the slow-commit
  degrade with its hold, and the probe cycle through a failpoint outage.
- Admission: the aggregate routes shed 503 with the supervisor's
  reconnect delay while it is not up, uploads never; a port DapHttpApp
  answers an aggregate-init during an outage as janus_tpu's does.
- Drivers: both acquirers park while down, absorb connection-class
  failures and raise fatal ones; the generic loop parks through an
  outage; a step that loses the datastore steps back by the reconnect
  delay.

- chip_smoke.py's taskprov-histogram and outage-drill phases rehearse on
  the CPU at Histogram(4) with 16 reports: the same code the card runs,
  with the kernels' plain versions.

janus_tpu's /readyz tests have no counterpart: the port has no
readiness registry (the supervisor keeps `readiness()` as a method).
Tolerance: exact equality; timing bounds as in janus_tpu's tests.
"""

import sqlite3
import threading
import time

import pytest

from janus_tpu.datastore import pg_fake as j_fake
from janus_tpu.datastore import store as j_store
from janus_tpu.ingest import admission as j_admission
from janus_tpu_torch import failpoints
from janus_tpu_torch.datastore.pg_fake import OperationalError as PgOperationalError
from janus_tpu_torch.datastore.pg_fake import SerializationFailure
from janus_tpu_torch.datastore.store import DatastoreSupervisor, EphemeralDatastore, TxConflict
from janus_tpu_torch.ingest import admission as t_admission


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


@pytest.fixture
def eph():
    e = EphemeralDatastore()
    yield e
    e.cleanup()


@pytest.fixture
def pgfake():
    e = EphemeralDatastore(engine="pgfake")
    yield e
    e.cleanup()


@pytest.fixture(scope="module")
def j_ephs():
    """janus_tpu's datastores of both engines: the classifier reference."""
    out = {engine: j_store.EphemeralDatastore(engine=engine) for engine in ("sqlite", "pgfake")}
    yield out
    for e in out.values():
        e.cleanup()


# --- error classifier -----------------------------------------------------

SQLITE_ERRORS = [
    TxConflict("x"),
    sqlite3.OperationalError("database is locked"),
    sqlite3.OperationalError("unable to open database file"),
    sqlite3.OperationalError("disk I/O error"),
    sqlite3.OperationalError("no such table: nope"),
    sqlite3.OperationalError("near x: syntax error"),
    ValueError("x"),
]


def _same_error_in_jax(e):
    """The janus_tpu instance of a port error class (TxConflict and the
    pg_fake classes are each package's own)."""
    from janus_tpu_torch.datastore import pg_fake as t_fake
    from janus_tpu_torch.datastore import store as t_store

    for t_mod, j_mod in ((t_store, j_store), (t_fake, j_fake)):
        for name in ("LeaseConflict", "TxConflict", "SerializationFailure", "DeadlockDetected", "OperationalError"):
            if type(e) is getattr(t_mod, name, None):
                return getattr(j_mod, name)(*e.args)
    return e


def test_classify_error_sqlite_equals_janus_tpu(eph, j_ephs):
    from janus_tpu_torch.datastore.store import LeaseConflict

    got = [eph.datastore.classify_error(e) for e in SQLITE_ERRORS + [LeaseConflict("x")]]
    want = [j_ephs["sqlite"].datastore.classify_error(_same_error_in_jax(e)) for e in SQLITE_ERRORS + [LeaseConflict("x")]]
    assert got == want == ["serialization", "serialization", "connection", "connection", "fatal", "fatal", "other", "fatal"]


def test_classify_error_pgfake_equals_janus_tpu(pgfake, j_ephs):
    from janus_tpu_torch.datastore.pg_fake import DeadlockDetected

    errs = [
        SerializationFailure("concurrent update"),
        DeadlockDetected("deadlock"),
        TxConflict("x"),
        PgOperationalError("server closed the connection unexpectedly"),
        ValueError("x"),
    ]
    got = [pgfake.datastore.classify_error(e) for e in errs]
    want = [j_ephs["pgfake"].datastore.classify_error(_same_error_in_jax(e)) for e in errs]
    assert got == want == ["serialization", "serialization", "serialization", "connection", "other"]


# --- run_tx ---------------------------------------------------------------


def test_run_tx_retries_injected_conflicts_and_connect_failures(eph):
    ds = eph.datastore
    ds.failpoint_scope = "retrytest"
    failpoints.configure("datastore.commit.kindtest=error:1.0,count=2")
    assert ds.run_tx(lambda tx: tx.get_task_ids(), "kindtest") == []
    assert failpoints.status()["failpoints"]["datastore.commit.kindtest"]["fired"] == 2
    failpoints.configure("datastore.connect.retrytest=error:1.0,count=3")
    assert ds.run_tx(lambda tx: tx.get_task_ids(), "kindtest") == []
    assert failpoints.status()["failpoints"]["datastore.connect.retrytest"]["fired"] == 3


def test_retry_backoff_full_jitter_and_cap(eph):
    ds = eph.datastore
    ds.retry_max_interval_s = 0.01
    samples = [ds._retry_sleep_s(a) for a in range(20) for _ in range(5)]
    assert all(0.0 <= s <= 0.01 for s in samples)
    assert len(set(samples)) > 10
    assert all(ds._retry_sleep_s(0) <= 0.002 for _ in range(20))
    ds.failpoint_scope = "captest"
    failpoints.configure("datastore.connect.captest=error:1.0")
    t0 = time.monotonic()
    with pytest.raises(sqlite3.OperationalError):
        ds.run_tx(lambda tx: tx.get_task_ids(), "captest")
    assert time.monotonic() - t0 < 2.0
    # all 16 attempts dialed
    assert failpoints.status()["failpoints"]["datastore.connect.captest"]["fired"] == ds.MAX_RETRIES


def test_fatal_errors_do_not_retry(eph):
    calls = []

    def fn(tx):
        calls.append(1)
        tx._c.execute("SELECT * FROM definitely_not_a_table")

    with pytest.raises(sqlite3.OperationalError):
        eph.datastore.run_tx(fn, "fataltest")
    assert len(calls) == 1


def test_close_closes_every_threads_connection(eph):
    ds = eph.datastore
    conns = {}

    def worker(name):
        ds.run_tx(lambda tx: tx.get_task_ids(), "reg")
        conns[name] = ds._connect()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    conns["main"] = ds._connect()
    assert len(set(map(id, conns.values()))) == 4
    assert ds._conn_registry >= set(conns.values())
    ds.close()
    for conn in conns.values():
        with pytest.raises(sqlite3.ProgrammingError):
            conn.execute("SELECT 1")


def test_pg_connection_dropped_mid_tx_discarded_and_reconnected(pgfake):
    from tests.test_torch_pg import J_TASK
    from janus_tpu_torch.task import Task

    ds, driver = pgfake.datastore, pgfake.pg_driver
    task = Task.from_dict(J_TASK.to_dict())
    conn0 = ds._connect()
    driver.inject_once(
        lambda sql, p: sql.startswith("INSERT INTO tasks"),
        PgOperationalError("server closed the connection unexpectedly"),
        break_connection=True,
    )
    n_before = len(driver.statements("connect"))
    ds.run_tx(lambda tx: tx.put_task(task), "conn_lost")
    assert len(driver.statements("connect")) == n_before + 1
    assert conn0.closed and conn0 not in ds._conn_registry and ds._connect() is not conn0
    assert ds.run_tx(lambda tx: tx.get_task(task.task_id), "readback") is not None


def test_pg_connection_lost_feeds_supervisor(pgfake):
    ds = pgfake.datastore
    ds.supervisor = DatastoreSupervisor(ds, probe_interval_s=3600, down_threshold=2)
    ds.failpoint_scope = "supfeed"
    ds.retry_max_interval_s = 0.001
    failpoints.configure("datastore.connect.supfeed=error:1.0")
    for _ in range(2):
        with pytest.raises(PgOperationalError):
            ds.run_tx(lambda tx: tx.get_task_ids(), "sup_feed")
    # two failed calls, not 32 failed attempts: down at the threshold
    assert ds.supervisor.state == "down" and ds.supervisor.status()["consecutive_failures"] == 2
    failpoints.clear()
    assert ds.run_tx(lambda tx: tx.get_task_ids(), "sup_feed") == []
    assert ds.supervisor.state == "recovering" and ds.supervisor.status()["consecutive_failures"] == 0


def test_one_run_tx_reports_at_most_one_supervisor_failure(eph):
    ds = eph.datastore
    ds.supervisor = DatastoreSupervisor(ds, probe_interval_s=3600, down_threshold=2)
    ds.failpoint_scope = "blip"
    failpoints.configure("datastore.connect.blip=error:1.0,count=2")
    assert ds.run_tx(lambda tx: tx.get_task_ids(), "blip") == []
    assert ds.supervisor.state == "up"
    assert ds.supervisor.status()["transitions"].get("down") is None


# --- the supervisor -------------------------------------------------------


def test_supervisor_state_machine_transitions(eph):
    sup = DatastoreSupervisor(eph.datastore, probe_interval_s=3600, down_threshold=3)
    assert sup.state == "up" and sup.readiness() is None
    sup.record_failure(RuntimeError("x"))
    assert sup.state == "degraded" and sup.readiness() is None
    sup.record_failure()
    sup.record_failure()
    assert sup.state == "down"
    assert sup.readiness().startswith("datastore down (3 consecutive failures; last: RuntimeError: x)")
    sup.record_success()
    assert sup.state == "recovering"
    sup.record_failure()
    assert sup.state == "down"
    sup.record_success()
    sup.record_success()
    assert sup.state == "up"
    assert sup.status()["transitions"] == {"degraded": 1, "down": 2, "recovering": 2, "up": 1}
    assert [s for _, s in sup.transition_log] == ["degraded", "down", "recovering", "down", "recovering", "up"]
    stamps = [t for t, _ in sup.transition_log]
    assert stamps == sorted(stamps)


def test_supervisor_slow_commit_degrades_with_hold(eph):
    sup = DatastoreSupervisor(eph.datastore, probe_interval_s=3600, degraded_hold_s=0.2)
    sup.record_slow_commit(3.0)
    assert sup.state == "degraded" and sup.status()["last_error"] == "slow commit: 3.000s"
    sup.record_success()
    assert sup.state == "degraded"
    time.sleep(0.25)
    sup.record_success()
    assert sup.state == "up"


def test_supervisor_probe_cycle_end_to_end(eph):
    ds = eph.datastore
    ds.failpoint_scope = "probecycle"
    sup = ds.start_supervision(probe_interval_s=0.05, down_threshold=2, recover_threshold=2)
    assert ds.start_supervision() is sup  # idempotent

    def wait_for(state):
        deadline = time.monotonic() + 10
        while sup.state != state and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sup.state == state

    wait_for("up")
    failpoints.configure("datastore.connect.probecycle=error:1.0")
    wait_for("down")
    assert sup.reconnect_delay_s() >= sup.probe_interval_s
    failpoints.clear()
    wait_for("up")
    assert [s for _, s in sup.transition_log][-2:] == ["recovering", "up"]
    ds.close()
    assert ds.supervisor is None and sup._thread is None


# --- admission --------------------------------------------------------------


class FakeSup:
    state = "down"

    def reconnect_delay_s(self):
        return 7.0


@pytest.mark.parametrize("state", ["down", "degraded", "recovering"])
def test_admission_sheds_aggregate_routes_while_datastore_not_up(state):
    sup = FakeSup()
    sup.state = state
    answers = {}
    for name, mod in (("jax", j_admission), ("torch", t_admission)):
        ctl = mod.AdmissionController(mod.AdmissionConfig(), supervisor_fn=lambda: sup)
        with pytest.raises(mod.ShedError) as ei:
            ctl.admit("aggregate")
        answers[name] = (ei.value.status, ei.value.reason, ei.value.retry_after_s, str(ei.value))
        ctl.admit("upload")  # uploads flow into the spill journal
    assert answers["torch"] == answers["jax"] == (503, f"datastore_{state}", 7.0, answers["jax"][3])
    sup.state = "up"
    t_admission.AdmissionController(t_admission.AdmissionConfig(), supervisor_fn=lambda: sup).admit("aggregate")


def test_dap_app_sheds_aggregate_init_503_as_janus_tpu():
    from janus_tpu.aggregator import core as j_core
    from janus_tpu.aggregator import http_handlers as j_http
    from janus_tpu_torch.aggregator import core as t_core
    from janus_tpu_torch.aggregator import http_handlers as t_http
    from janus_tpu_torch.messages import AggregationJobInitializeReq

    answers = {}
    for name, core, http, E in (
        ("jax", j_core, j_http, j_store.EphemeralDatastore),
        ("torch", t_core, t_http, EphemeralDatastore),
    ):
        e = E()
        try:
            kw = {"device": "cpu"} if name == "torch" else {}
            app = http.DapHttpApp(core.Aggregator(e.datastore, e.clock, core.Config(), **kw))
            e.datastore.supervisor = FakeSup()
            path = "/tasks/" + "A" * 43 + "/aggregation_jobs/" + "A" * 22
            answers[name] = app.handle("PUT", path, {}, {"Content-Type": AggregationJobInitializeReq.MEDIA_TYPE}, b"")
            app.agg.close()
        finally:
            e.datastore.supervisor = None
            e.cleanup()
    assert answers["torch"] == answers["jax"]
    status, _, _, extra = answers["torch"]
    assert status == 503 and extra == {"Retry-After": "7"}


# --- drivers ------------------------------------------------------------------


def test_drivers_park_acquire_while_down(eph):
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver

    ds = eph.datastore
    sup = ds.start_supervision(probe_interval_s=3600, down_threshold=1)
    sup.record_failure()
    assert sup.state == "down"
    n0 = len(ds._conn_registry)
    assert AggregationJobDriver(ds, None, device="cpu").acquirer(60)(4) == []
    assert CollectionJobDriver(ds, None).acquirer(60)(4) == []
    assert len(ds._conn_registry) == n0


def test_driver_acquirer_absorbs_connection_errors_raises_fatal(eph):
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver

    ds = eph.datastore
    ds.failpoint_scope = "acqtol"
    ds.retry_max_interval_s = 0.001
    acquire = AggregationJobDriver(ds, None, device="cpu").acquirer(60)
    failpoints.configure("datastore.connect.acqtol=error:1.0")
    assert acquire(4) == []
    failpoints.clear()
    assert acquire(4) == []

    class FatalDs:
        supervisor = None
        clock = None

        def classify_error(self, e):
            return "fatal"

        def run_tx(self, fn, name):
            raise sqlite3.OperationalError("no such table: aggregation_jobs")

    with pytest.raises(sqlite3.OperationalError):
        AggregationJobDriver(FatalDs(), None, device="cpu").acquirer(60)(4)


def test_job_driver_loop_parks_through_outage(eph):
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig, Stopper

    ds = eph.datastore
    ds.failpoint_scope = "looppark"
    ds.retry_max_interval_s = 0.001
    calls = []
    stopper = Stopper()
    inner = AggregationJobDriver(ds, None, device="cpu").acquirer(60)

    def acquirer(limit):
        calls.append(1)
        if len(calls) >= 3:
            stopper.stop()
        return inner(limit)

    failpoints.configure("datastore.connect.looppark=error:1.0")
    JobDriver(
        JobDriverConfig(job_discovery_interval_s=0.01, max_job_discovery_interval_s=0.02),
        acquirer,
        lambda acquired: None,
        stopper,
    ).run()
    assert len(calls) >= 3


def test_step_that_loses_the_datastore_steps_back_by_the_reconnect_delay(eph):
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.aggregator.job_driver import datastore_reconnect_delay_s
    from janus_tpu_torch.datastore.models import AggregationJobModel, AggregationJobState
    from janus_tpu_torch.messages import AggregationJobId, Duration, Interval, Time
    from janus_tpu_torch.task import Task
    from tests.test_torch_pg import J_TASK

    ds = eph.datastore
    task = Task.from_dict(J_TASK.to_dict())
    job = AggregationJobModel(task.task_id, AggregationJobId(bytes(16)), b"", b"",
                              Interval(Time(1000), Duration(100)), AggregationJobState.IN_PROGRESS, 0)
    ds.run_tx(lambda tx: (tx.put_task(task), tx.put_aggregation_job(job)))
    assert datastore_reconnect_delay_s(ds) == 5.0  # unsupervised default
    drv = AggregationJobDriver(ds, None, device="cpu")
    (acq,) = ds.run_tx(lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), 1))
    now = ds.clock.now().seconds
    sup = ds.supervisor = DatastoreSupervisor(ds, probe_interval_s=3, down_threshold=1)
    sup.record_failure()
    sup._down_since -= 20  # down for 20 s: half of it, under the cap
    assert 9.9 < sup.reconnect_delay_s() <= 10.1
    assert drv.handle_step_error(acq, sqlite3.OperationalError("disk I/O error")) is True
    row = ds.run_tx(lambda tx: tx._c.execute("SELECT lease_expiry, lease_token, lease_attempts FROM aggregation_jobs").fetchone())
    assert row == (now + 10, None, 0)
    ds.supervisor = None


# --- chip_smoke.py's phases, rehearsed ---------------------------------------


def test_chip_smoke_taskprov_and_drill_phases_rehearse_on_the_cpu():
    import torch

    import chip_smoke

    pair = chip_smoke.TaskprovPair(torch, torch.device("cpu"), length=4, min_batch_size=1)
    try:
        rec = chip_smoke.phase_taskprov_histogram(pair, n_client=2, n_wire=14, bad_rows=(1, 5, 9))
        assert rec["finished"] == 13 and rec["collect"]["report_count"] == 13
        assert rec["helper_opt_in_s"] > 0 and rec["leader_pg_statements_in_upload"] > 0
        drill = chip_smoke.phase_outage_drill(pair, n_client=2, n_wire=14, bad_rows=(2, 6, 11))
    finally:
        pair.close()
    leader, helper = drill["leader_outage"], drill["helper_outage"]
    assert drill["acked_201"] == 16 and drill["collect"]["report_count"] == 13
    assert leader["spilled"] == leader["replayed_fresh"] > 0 and leader["replayed_dupes"] == 0
    assert leader["journal_fsyncs"] > 0 and leader["journal_bytes_peak"] > 0
    assert helper["sheds_503"] > 0 and helper["step_backs"][0][0] == "circuit_open"
    for side, rec in (("leader", leader), ("helper", helper)):
        states = [s for s, _ in drill["transitions_s"][side]]
        assert states[-2:] == ["recovering", "up"] and "down" in states
        assert rec["fail_to_down_s"] > 0 and rec["clear_to_up_s"] > 0 and rec["fail_s"] < rec["clear_s"]
