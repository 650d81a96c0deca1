"""The leader's job machinery of janus_tpu_torch, held against janus_tpu's.

- The creator's grouping of stored reports into jobs (sizes, report
  sets, order within a job, the reports left unaggregated) against
  janus_tpu's creator over the same reports; job ids are compared up to
  renaming; a fixed-size task's job and outstanding batch likewise.
- The leases: acquire, expiry, a token-guarded release and step-back,
  hand-back, the step-back of a step whose lease already expired, and
  abandonment after `maximum_attempts_before_failure`, as the same
  sequence of operations leaves the rows in both packages' datastores.
- `retry_http_request` over scripted statuses, transport errors and
  Retry-After values, with the same seeded jitter: the same sleeps, calls
  and outcome as janus_tpu's (one parametrised test); the circuit
  breaker's state machine over the same script as janus_tpu's; the
  response matching (`_match_resps`) over aligned, reordered, missing and
  extra responses.
- Driver steps against a port helper on loopback HTTP: a helper that
  answers 503, then 200; a circuit that opens, which steps the job back
  and refunds the attempt (and leaves the lease row as janus_tpu's driver
  does); a response with one report missing and the rest reordered; and
  two jobs stepped by two workers that share one EngineCache.

Everything runs on the CPU (device="cpu" for the port); tolerance: exact
equality.
"""

import dataclasses
import random
import time
import urllib.error

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import aggregation_job_creator as j_creator
from janus_tpu.aggregator import aggregation_job_driver as j_driver
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu.core import retries as j_retries
from janus_tpu.core import time_util as j_time
from janus_tpu.trace import trace_id_of
from janus_tpu.core.auth import AuthenticationToken
from janus_tpu.core.hpke import generate_hpke_config_and_private_key
from janus_tpu.datastore import models as j_models
from janus_tpu.datastore import store as j_store
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import aggregation_job_creator as t_creator
from janus_tpu_torch.aggregator import aggregation_job_driver as t_driver
from janus_tpu_torch.aggregator.core import Aggregator
from janus_tpu_torch.aggregator.engine_cache import engine_cache
from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig, deadline_request_timeout, lease_deadline
from janus_tpu_torch.aggregator.testing import leader_stored_reports
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core import deadline as t_deadline
from janus_tpu_torch.core import retries as t_retries
from janus_tpu_torch.core.http_client import HttpClient
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.task import Task
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements
from test_torch_engine_cache import jax_single_device

CPU = torch.device("cpu")
NOW = 1_700_000_000


class Side:
    """One package's datastore over a MockClock, with its task."""

    def __init__(self, pkg: str, j_task_):
        self.pkg = pkg
        self.m = jm if pkg == "jax" else tm
        self.models = j_models if pkg == "jax" else t_models
        if pkg == "jax":
            self.eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
            self.task = j_task_
        else:
            self.eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
            self.task = Task.from_dict(j_task_.to_dict())
        self.ds = self.eph.datastore
        self.clock = self.eph.clock
        self.ds.run_tx(lambda tx: tx.put_task(self.task))

    def advance(self, secs: int) -> None:
        self.clock.advance(self.m.Duration(secs))

    def put_reports(self, times) -> list[bytes]:
        """Stored reports with placeholder shares at the given times; the
        creator reads only ids and times."""
        m = self.m
        ids = [bytes([i + 1]) * 16 for i in range(len(times))]
        ct = m.HpkeCiphertext(m.HpkeConfigId(1), b"k", b"p")

        def put(tx):
            for rid, t in zip(ids, times):
                tx.put_client_report(
                    self.models.LeaderStoredReport(self.task.task_id, m.ReportId(rid), m.Time(t), b"", b"x", ct)
                )

        self.ds.run_tx(put)
        return ids

    def put_job(self, job_id: bytes, report_ids) -> None:
        m, models = self.m, self.models
        jid = m.AggregationJobId(job_id)

        def put(tx):
            tx.put_aggregation_job(
                models.AggregationJobModel(
                    self.task.task_id, jid, b"", m.PartialBatchSelector.time_interval().to_bytes(),
                    m.Interval(m.Time(NOW - 100), m.Duration(1)), models.AggregationJobState.IN_PROGRESS, 0,
                )
            )
            for i, rid in enumerate(report_ids):
                tx.put_report_aggregation(
                    models.ReportAggregationModel(
                        self.task.task_id, jid, m.ReportId(rid), m.Time(NOW - 100), i,
                        models.ReportAggregationState.START,
                    )
                )

        self.ds.run_tx(put)

    def job_rows(self):
        return self.ds.run_tx(
            lambda tx: tx._c.execute(
                "SELECT job_id, state, lease_expiry, lease_token IS NULL, lease_attempts, shard_key"
                " FROM aggregation_jobs ORDER BY job_id"
            ).fetchall()
        )

    def started(self):
        return self.ds.run_tx(
            lambda tx: tx._c.execute(
                "SELECT report_id, aggregation_started FROM client_reports ORDER BY report_id"
            ).fetchall()
        )

    def close(self):
        self.eph.cleanup()


def _leader_task(vdaf=None, query=None, **kw):
    return (
        j_task.TaskBuilder(query or j_task.QueryTypeConfig.time_interval(), vdaf or j_registry.VdafInstance.count(),
                           jm.Role.LEADER)
        .with_(vdaf_verify_key=bytes(range(16)), **kw)
        .build()
    )


@pytest.fixture()
def sides():
    made = []

    def make(j_task_):
        pair = Side("jax", j_task_), Side("torch", j_task_)
        made.extend(pair)
        return pair

    yield make
    for s in made:
        s.close()


# --- the creator ----------------------------------------------------------


def _jobs_up_to_renaming(side):
    """{sorted report ids: (ord by report, interval, pbs, state, step, aggregation parameter)}"""
    def read(tx):
        out = {}
        for job in tx.get_aggregation_jobs_for_task(side.task.task_id):
            ras = tx.get_report_aggregations_for_job(side.task.task_id, job.job_id)
            key = tuple(sorted(ra.report_id.data for ra in ras))
            out[key] = (
                tuple((ra.report_id.data, ra.ord, ra.client_time.seconds, ra.state.value) for ra in ras),
                job.client_timestamp_interval.to_bytes(), job.partial_batch_identifier, job.state.value, job.step,
                job.aggregation_parameter,
            )
            # both packages store the creating span's traceparent
            assert trace_id_of(job.trace_context) is not None
        return out

    return side.ds.run_tx(read)


@pytest.mark.parametrize("min_size,max_size,n", [(1, 4, 11), (3, 4, 10), (1, 1024, 5), (6, 8, 5)])
def test_creator_groups_reports_as_janus_tpu(sides, min_size, max_size, n):
    j, t = sides(_leader_task())
    times = [NOW - 5000 + 37 * ((i * 7) % n) for i in range(n)]  # distinct, out of order
    for side in (j, t):
        side.put_reports(times)
    made = [
        j_creator.AggregationJobCreator(j.ds, j_creator.AggregationJobCreatorConfig(min_size, max_size)).run_once(),
        t_creator.AggregationJobCreator(t.ds, t_creator.AggregationJobCreatorConfig(min_size, max_size)).run_once(),
    ]
    assert made[0] == made[1] == (0 if n < min_size else -(-n // max_size) - (n % max_size and n % max_size < min_size))
    assert _jobs_up_to_renaming(t) == _jobs_up_to_renaming(j)
    assert t.started() == j.started()
    # a second sweep finds nothing new
    assert t_creator.AggregationJobCreator(t.ds, t_creator.AggregationJobCreatorConfig(min_size, max_size)).run_once() == 0


def test_creator_refuses_a_fixed_size_task(sides):
    """The port's creator no longer refuses a fixed-size task: two reports
    make one job in one open outstanding batch, as janus_tpu's creator
    makes them (the batch and job ids up to renaming;
    tests/test_torch_fixed_size.py compares the packing case by case)."""
    j, t = sides(_leader_task(query=j_task.QueryTypeConfig.fixed_size(max_batch_size=10)))
    for side, creator in ((j, j_creator), (t, t_creator)):
        side.put_reports([NOW - 10, NOW - 20])
        assert creator.AggregationJobCreator(side.ds).run_once() == 1

    def packing(side):
        (job,) = side.ds.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(side.task.task_id))
        ras = side.ds.run_tx(lambda tx: tx.get_report_aggregations_for_job(side.task.task_id, job.job_id))
        batches = side.ds.run_tx(lambda tx: tx.get_outstanding_batches(side.task.task_id))
        pbs = side.m.PartialBatchSelector.from_bytes(job.partial_batch_identifier)
        return ([(ra.report_id.data, ra.ord) for ra in ras], [(b.size, b.batch_id.data == pbs.batch_id.data)
                                                              for b in batches], pbs.query_type)

    assert packing(t) == packing(j) == (packing(j)[0], [(2, True)], tm.FixedSize.CODE)
    assert t.started() == j.started()


# --- leases ---------------------------------------------------------------


def _lease_script(side, drv):
    """The same sequence of lease operations; the job rows after each."""
    m = side.m
    side.put_job(bytes(16), [])
    rows = []

    def acquire(secs=100):
        return side.ds.run_tx(lambda tx: tx.acquire_incomplete_aggregation_jobs(m.Duration(secs), 10))

    def op(name, fn):
        try:
            out = fn()
        except Exception as e:  # both packages' LeaseConflict
            out = type(e).__name__
        rows.append((name, out if isinstance(out, (str, int, type(None))) else len(out), side.job_rows()))

    first = acquire()
    rows.append(("acquire", len(first), side.job_rows()))
    op("acquire-while-leased", acquire)
    side.advance(101)
    second = acquire()
    rows.append(("acquire-after-expiry", [a.lease.attempts for a in second], side.job_rows()))
    op("release-stale-token", lambda: side.ds.run_tx(lambda tx: tx.release_aggregation_job(first[0])))
    op("step-back-stale-token", lambda: side.ds.run_tx(lambda tx: tx.step_back_aggregation_job(first[0], 5)))
    op("step-back", lambda: side.ds.run_tx(lambda tx: tx.step_back_aggregation_job(second[0], 5)))
    op("acquire-before-delay", acquire)
    side.advance(5)
    third = acquire()
    rows.append(("acquire-after-delay", [a.lease.attempts for a in third], side.job_rows()))
    op("step-back-counted", lambda: side.ds.run_tx(lambda tx: tx.step_back_aggregation_job(third[0], 0, count_attempt=True)))
    fourth = acquire()
    op("handback", lambda: side.ds.run_tx(lambda tx: tx.step_back_aggregation_job(fourth[0], 0, handback=True)))
    fifth = acquire()
    rows.append(("acquire-after-handback", [a.lease.attempts for a in fifth], side.job_rows()))
    op("release", lambda: side.ds.run_tx(lambda tx: tx.release_aggregation_job(fifth[0])))
    # a step whose lease expired before it ran steps back (attempt refunded)
    sixth = acquire(secs=10)
    side.advance(11)
    op("step-expired-lease", lambda: drv.stepper(sixth[0]))
    return rows


def test_lease_operations_match_janus_tpu(sides):
    j, t = sides(_leader_task())
    j_drv = j_driver.AggregationJobDriver(j.ds, None, breakers=j_cb.OutboundCircuitBreakers())
    t_drv = t_driver.AggregationJobDriver(t.ds, None, breakers=t_cb.OutboundCircuitBreakers(), device=CPU)
    got, want = _lease_script(t, t_drv), _lease_script(j, j_drv)
    assert got == want
    names = dict((name, out) for name, out, _ in got)
    assert names["release-stale-token"] == "LeaseConflict" and names["acquire-while-leased"] == 0
    # the refunded step-back: attempts back to 1, the job claimable at +5 s
    step_back_row = next(rows for name, _, rows in got if name == "step-back")[0]
    assert step_back_row[3:5] == (1, 1) and step_back_row[2] == NOW + 101 + 5
    assert next(rows for name, _, rows in got if name == "handback")[0][5] == -1
    assert got[-1][2][0][3:5] == (1, 0)  # expired-lease step: released, refunded


def test_abandonment_after_max_attempts_matches_janus_tpu(sides):
    j, t = sides(_leader_task())
    out = []
    for side, drv in (
        (j, j_driver.AggregationJobDriver(
            j.ds, None, j_driver.AggregationJobDriverConfig(maximum_attempts_before_failure=1),
            breakers=j_cb.OutboundCircuitBreakers())),
        (t, t_driver.AggregationJobDriver(
            t.ds, None, t_driver.AggregationJobDriverConfig(maximum_attempts_before_failure=1),
            breakers=t_cb.OutboundCircuitBreakers(), device=CPU)),
    ):
        ids = side.put_reports([NOW - 100, NOW - 90])
        side.ds.run_tx(lambda tx: tx.get_unaggregated_client_reports_for_task(side.task.task_id, 10))
        side.put_job(bytes(16), ids)
        acquire = drv.acquirer(lease_duration_s=10)
        assert [a.lease.attempts for a in acquire(1)] == [1]
        side.advance(11)
        (again,) = acquire(1)
        assert again.lease.attempts == 2
        drv.stepper(again)  # over the limit: abandoned, reports handed back
        out.append((side.job_rows(), side.started()))
    assert out[1] == out[0]
    assert out[1][0][0][1] == "abandoned" and {s for _, s in out[1][1]} == {0}


def test_lease_deadline_and_request_timeout():
    clock = MockClock(tm.Time(NOW))
    lease = t_models.Lease(b"t" * 16, tm.Time(NOW + 600), 1)
    dl = lease_deadline(clock, lease, 60)
    assert 539 < dl - time.monotonic() <= 540
    short = lease_deadline(clock, t_models.Lease(b"t" * 16, tm.Time(NOW + 10), 1), 60)
    assert 4 < short - time.monotonic() <= 5  # half of a lease shorter than twice the skew
    with pytest.raises(t_deadline.DeadlineExceeded):
        lease_deadline(clock, t_models.Lease(b"t" * 16, tm.Time(NOW), 1), 60)
    assert deadline_request_timeout(None, 5.0) == 5.0
    assert deadline_request_timeout(time.monotonic() + 100, 5.0) == 5.0
    assert deadline_request_timeout(time.monotonic() + 2, None) <= 2
    with pytest.raises(t_deadline.DeadlineExceeded):
        deadline_request_timeout(time.monotonic() - 1)


# --- retries and the breaker ------------------------------------------------

RETRY_SCRIPTS = {
    "ok": [200],
    "503-then-200": [503, 200],
    "5xx-exhausted": [500] * 100,
    "429-retry-after": [(429, "0.5"), 200],
    "retry-after-zero": [(503, "0"), 200],
    "retry-after-huge": [(503, "3600"), 200],
    "retry-after-past-date": [(503, "Wed, 21 Oct 2015 07:28:00 GMT"), 200],
    "retry-after-garbage": [(503, "soon"), 200],
    "transport-then-200": ["oserror", 200],
    "transport-exhausted": ["oserror"] * 100,
    "conclusive-4xx": [400],
    "deadline-passed": [503],
    "abort": [503, 503, 200],
}


def _run_retry(mod, script, case):
    random.seed(1234)
    steps = iter(script)
    sleeps, calls = [], []

    def do_request():
        calls.append(1)
        s = next(steps)
        if s == "oserror":
            raise urllib.error.URLError(OSError("refused"))
        if isinstance(s, tuple):
            return s[0], b"busy", {"Retry-After": s[1]}
        return s, f"body-{s}".encode()

    kw = {}
    if case == "deadline-passed":
        kw["deadline"] = time.monotonic() - 1
    if case == "abort":
        kw["should_abort"] = lambda: len(calls) >= 2
    backoff = mod.Backoff(initial=0.1, multiplier=2.0, max_interval=1.0, max_elapsed=3.0)
    try:
        out = mod.retry_http_request(do_request, backoff, sleep=sleeps.append, **kw)
    except Exception as e:
        out = type(e).__name__
    return out, sleeps, len(calls)


@pytest.mark.parametrize("case", list(RETRY_SCRIPTS))
def test_retry_sequence_matches_janus_tpu(case):
    script = RETRY_SCRIPTS[case]
    got = _run_retry(t_retries, script, case)
    assert got == _run_retry(j_retries, script, case)
    if case == "429-retry-after":
        assert got[1] == [0.5]
    if case in ("retry-after-zero", "retry-after-past-date"):
        assert got[1] == [0.1]  # floored at the initial interval
    if case == "retry-after-huge":
        assert got[1] == [1.0]  # clamped to max_interval


def test_breaker_state_machine_matches_janus_tpu(monkeypatch):
    now = [1000.0]
    for mod in (j_cb, t_cb):
        monkeypatch.setattr(mod.time, "monotonic", lambda: now[0])
    cfg = dict(failure_threshold=2, open_cooldown_s=10.0, close_threshold=1)
    breakers = (j_cb.OutboundCircuitBreakers(j_cb.CircuitBreakerConfig(**cfg)),
                t_cb.OutboundCircuitBreakers(t_cb.CircuitBreakerConfig(**cfg)))
    script = ["check", "fail", "check", "fail", "check", ("wait", 5), "check", ("wait", 6), "check", "check",
              "fail", "check", ("wait", 11), "check", "ok", "check", "fail", "ok", "fail", "check"]
    trace = [[], []]
    for step in script:
        if isinstance(step, tuple):
            now[0] += step[1]
            continue
        for k, b in enumerate(breakers):
            try:
                {"check": b.check, "fail": b.record_failure, "ok": b.record_success}[step]("peer")
                r = None
            except Exception as e:
                r = (type(e).__name__, round(e.retry_in_s, 6))
            trace[k].append((step, r, b.state("peer"), round(b.retry_in_s("peer"), 6)))
    assert trace[1] == trace[0]
    assert ("check", None, "half_open", 0.0) in trace[1]


@pytest.mark.parametrize("case", ["aligned", "reordered", "missing", "extra"])
def test_response_matching_matches_janus_tpu(case):
    sent = [bytes([i]) * 16 for i in range(5)]
    answered = {"aligned": sent, "reordered": sent[::-1], "missing": sent[:2] + sent[3:],
                "extra": sent + [b"\xff" * 16]}[case]
    col = tm.PrepareRespColumn(answered, bytearray(len(answered)), [None] * len(answered), [None] * len(answered))
    j_drv = j_driver.AggregationJobDriver.__new__(j_driver.AggregationJobDriver)
    got = t_driver.AggregationJobDriver._match_resps(None, sent, col)
    assert got == j_drv._match_resps(sent, col)
    if case == "missing":
        assert got[2] is None


# --- driver steps over loopback HTTP ------------------------------------------


class Stack:
    """A port leader datastore and a port helper behind a DapServer."""

    def __init__(self, vdaf_kw: dict, n: int):
        self.token = AuthenticationToken.random_bearer()
        self.helper_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
        self.helper = Aggregator(self.helper_eph.datastore, self.helper_eph.clock, device=CPU)
        self.server = DapServer(DapHttpApp(self.helper)).start()
        j_leader = _leader_task(j_registry.VdafInstance(**vdaf_kw), helper_aggregator_endpoint=self.server.url,
                                aggregator_auth_token=self.token)
        j_helper = dataclasses.replace(j_leader, role=jm.Role.HELPER,
                                       hpke_keys=(generate_hpke_config_and_private_key(config_id=1),))
        self.j_leader = j_leader
        self.task = Task.from_dict(j_leader.to_dict())
        self.helper_task = Task.from_dict(j_helper.to_dict())
        self.helper_eph.datastore.run_tx(lambda tx: tx.put_task(self.helper_task))
        self.leader = Side("torch", j_leader)
        self.inst = t_registry.VdafInstance(**vdaf_kw)
        self.meas = np.asarray(random_measurements(self.inst, n, np.random.default_rng(5)))
        args, _ = make_report_batch(self.inst, self.meas, seed=5, device=CPU)
        reports = leader_stored_reports(self.task, self.helper_task.hpke_keys[0].config, args, [NOW - 100] * n)
        self.ids = [r.report_id.data for r in reports]
        self.leader.ds.run_tx(lambda tx: [tx.put_client_report(r) for r in reports])

    def driver(self, http=None, **cfg):
        cfg.setdefault("http_backoff", t_retries.Backoff.test())
        return t_driver.AggregationJobDriver(
            self.leader.ds, http or HttpClient(timeout=10), t_driver.AggregationJobDriverConfig(**cfg),
            breakers=t_cb.OutboundCircuitBreakers(cfg.get("circuit_breaker")), device=CPU,
        )

    def ra_states(self):
        return self.leader.ds.run_tx(
            lambda tx: dict(tx._c.execute("SELECT report_id, COALESCE(prepare_error, -1) FROM report_aggregations"
                                          " ORDER BY report_id").fetchall())
        )

    def shares(self, ds):
        field = t_registry.circuit_for(self.inst).FIELD
        rows = ds.run_tx(lambda tx: tx._c.execute("SELECT aggregate_share, report_count FROM batch_aggregations").fetchall())
        return [(field.decode_vec(s), c) for s, c in rows]

    def close(self):
        self.server.stop()
        self.helper_eph.cleanup()
        self.leader.close()


@pytest.fixture()
def stack():
    made = []

    def make(vdaf_kw=None, n=6):
        s = Stack(vdaf_kw or {"kind": "count"}, n)
        made.append(s)
        return s

    yield make
    for s in made:
        s.close()


class Scripted:
    """An HttpClient that answers the first PUTs from a script, then
    forwards to the real client (optionally rewriting the response)."""

    def __init__(self, script=(), rewrite=None):
        self.inner = HttpClient(timeout=10)
        self.script = list(script)
        self.rewrite = rewrite
        self.puts = 0

    @property
    def last_response_headers(self):
        return self.inner.last_response_headers

    def put(self, url, body, headers=None, timeout=None):
        self.puts += 1
        if self.script:
            s = self.script.pop(0)
            if s == "oserror":
                raise urllib.error.URLError(OSError("connection refused"))
            return s, b""
        status, out = self.inner.put(url, body, headers, timeout=timeout)
        return status, self.rewrite(out) if self.rewrite else out


def test_helper_503_then_200_finishes_the_job(stack):
    s = stack()
    assert t_creator.AggregationJobCreator(s.leader.ds).run_once() == 1
    http = Scripted([503])
    drv = s.driver(http)
    assert JobDriver(JobDriverConfig(max_concurrent_job_workers=1), drv.acquirer(), drv.stepper).run_once() == 1
    assert http.puts == 2
    assert s.leader.job_rows()[0][1:5] == ("finished", NOW, 1, 0)
    assert set(s.ra_states().values()) == {-1}
    assert drv.breakers.state(t_cb.peer_label(s.task.helper_aggregator_endpoint)) == "closed"
    [(lead, n0)], [(help_, n1)] = s.shares(s.leader.ds), s.shares(s.helper_eph.datastore)
    assert n0 == n1 == 6 and (lead[0] + help_[0]) % t_registry.circuit_for(s.inst).FIELD.MODULUS == s.meas.sum()
    assert set(drv.step_seconds[0][1]) == {"read_tx", "stage_init", "device_init", "http_init",
                                           "device_accumulate", "commit_finish"}


def test_open_circuit_steps_back_and_refunds_the_attempt(stack):
    """Transport failures open the breaker mid-retry; the step steps back
    with the cooldown as delay and the attempt refunded, and the lease row
    equals the one janus_tpu's driver leaves on the same script."""
    s = stack()
    rows = []
    for pkg in ("torch", "jax"):
        side = s.leader if pkg == "torch" else Side("jax", s.j_leader)
        try:
            if pkg == "jax":
                side.ds.run_tx(lambda tx: [tx.put_client_report(r) for r in _as_jax_reports(s.leader)])
                creator = j_creator.AggregationJobCreator(side.ds)
                http = Scripted(["oserror"] * 10)
                cb = j_cb.CircuitBreakerConfig(failure_threshold=2, open_cooldown_s=30.0)
                drv = j_driver.AggregationJobDriver(
                    side.ds, http, j_driver.AggregationJobDriverConfig(http_backoff=j_retries.Backoff.test()),
                    breakers=j_cb.OutboundCircuitBreakers(cb))
            else:
                creator = t_creator.AggregationJobCreator(side.ds)
                http = Scripted(["oserror"] * 10)
                drv = s.driver(http, circuit_breaker=t_cb.CircuitBreakerConfig(failure_threshold=2, open_cooldown_s=30.0))
            assert creator.run_once() == 1
            with jax_single_device():
                (acq,) = drv.acquirer()(1)
                assert acq.lease.attempts == 1
                drv.stepper(acq)
            assert http.puts == 2
            rows.append([r[1:5] for r in side.job_rows()])
        finally:
            if pkg == "jax":
                side.close()
    assert rows[0] == rows[1]
    (state, expiry, released, attempts), = rows[0]
    assert (state, released, attempts) == ("in_progress", 1, 0) and NOW + 29 <= expiry <= NOW + 30


def _as_jax_reports(side):
    """The port leader's stored reports as janus_tpu rows."""
    def read(tx):
        ids = [r[0] for r in tx._c.execute("SELECT report_id FROM client_reports ORDER BY report_id")]
        return [tx.get_client_report(side.task.task_id, tm.ReportId(i)) for i in ids]

    return [
        j_models.LeaderStoredReport(jm.TaskId(r.task_id.data), jm.ReportId(r.report_id.data), jm.Time(r.client_time.seconds),
                                    r.public_share, r.leader_input_share,
                                    jm.HpkeCiphertext.from_bytes(r.helper_encrypted_input_share.to_bytes()))
        for r in side.ds.run_tx(read)
    ]


def test_missing_and_reordered_responses_fail_only_the_missing_report(stack):
    s = stack({"kind": "sumvec", "length": 3, "bits": 2}, n=5)

    def drop_and_reverse(body: bytes) -> bytes:
        resp = tm.AggregationJobResp.from_bytes(body)
        kept = [r for r in resp.prepare_resps if r.report_id.data != s.ids[2]]
        return tm.AggregationJobResp(tuple(kept[::-1])).to_bytes()

    assert t_creator.AggregationJobCreator(s.leader.ds).run_once() == 1
    drv = s.driver(Scripted(rewrite=drop_and_reverse))
    assert JobDriver(JobDriverConfig(max_concurrent_job_workers=1), drv.acquirer(), drv.stepper).run_once() == 1
    states = s.ra_states()
    assert states.pop(s.ids[2]) == int(tm.PrepareError.INVALID_MESSAGE)
    assert set(states.values()) == {-1}
    (lead, n0), = s.shares(s.leader.ds)
    assert n0 == 4


def test_two_jobs_two_workers_share_one_engine(stack):
    s = stack({"kind": "sumvec", "length": 3, "bits": 2}, n=8)
    cfg = t_creator.AggregationJobCreatorConfig(max_aggregation_job_size=4)
    assert t_creator.AggregationJobCreator(s.leader.ds, cfg).run_once() == 2
    drv = s.driver()
    assert JobDriver(JobDriverConfig(max_concurrent_job_workers=2), drv.acquirer(), drv.stepper).run_once() == 2
    assert [r[1] for r in s.leader.job_rows()] == ["finished", "finished"]
    assert len(drv.step_seconds) == 2
    engine = engine_cache(s.inst, s.task.vdaf_verify_key, CPU)
    assert s.helper.task_aggregator_for(s.helper_task.task_id).engine is engine
    p = t_registry.circuit_for(s.inst).FIELD.MODULUS
    [(lead, n0)], [(help_, n1)] = s.shares(s.leader.ds), s.shares(s.helper_eph.datastore)
    assert n0 == n1 == 8
    assert [(a + b) % p for a, b in zip(lead, help_)] == [int(x) for x in s.meas.sum(axis=0).reshape(-1)]


def test_job_driver_run_loop_and_outage_tolerance():
    """JobDriver.run streams acquired jobs to its workers until stopped;
    a connection-class acquire failure reads as no jobs, anything else
    raises."""
    import sqlite3
    import threading

    from janus_tpu_torch.aggregator.job_driver import Stopper, acquire_tolerating_outage

    batches = [[1, 2], [], [3]]
    stepped = []
    stopper = Stopper()

    def acquirer(limit):
        assert limit >= 1
        return batches.pop(0) if batches else []

    def stepper(job):
        stepped.append(job)
        if job == 2:
            raise RuntimeError("a failed step is logged, not fatal to the loop")
        if len(stepped) == 3:
            stopper.stop()

    cfg = JobDriverConfig(job_discovery_interval_s=0.001, max_job_discovery_interval_s=0.01)
    loop = threading.Thread(target=JobDriver(cfg, acquirer, stepper, stopper).run)
    loop.start()
    loop.join(timeout=10)
    assert not loop.is_alive() and sorted(stepped) == [1, 2, 3]

    eph = EphemeralDatastore()
    try:
        lost = sqlite3.OperationalError("unable to open database file")
        assert acquire_tolerating_outage(eph.datastore, lambda: (_ for _ in ()).throw(lost)) == []
        with pytest.raises(sqlite3.OperationalError):
            acquire_tolerating_outage(eph.datastore, lambda: (_ for _ in ()).throw(sqlite3.OperationalError("no such table")))
    finally:
        eph.cleanup()
