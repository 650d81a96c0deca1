"""janus_tpu_torch's collection held against janus_tpu's.

- Four pairings collect the same batch: a janus_tpu leader's
  CollectionJobDriver with a janus_tpu helper's DapServer (the
  reference), a port leader with a janus_tpu helper, a janus_tpu leader
  with a port helper, and a port pair. Each pairing starts from fresh
  SQLite datastores seeded directly with the same tasks and batch
  aggregations (shard rows in two time windows, and rows the query does
  not cover), so the JAX side compiles nothing. The leader creates the
  collection job under one fixed id through its TaskAggregator, and
  `JobDriver.run_once` steps it over loopback HTTP. The leader's
  collection job row (its leader share decrypted at rest, the helper's
  HPKE ciphertext opened with the collector's key, the lease columns),
  the aggregate-share job rows and the batch aggregations of both sides
  must equal the reference pairing's. Then a janus_tpu Collector and a
  port Collector poll the leader: both must get the reference's
  CollectionResult, which must equal the ground truth. Circuits: Count and
  a narrow SumVec, each under a time-interval query and a fixed-size
  current-batch query (whose choice skips a batch below min_batch_size).
- The leader's collection routes and the helper's aggregate-share route
  answer as janus_tpu's (status, content type, body, Retry-After) for the
  cases of tests/test_collect_validation.py (overlap, idempotent retry,
  job-id reuse, a new aggregation parameter on the same interval, the
  fixed-size query count), the 202 with Retry-After, an unknown, a deleted
  and an abandoned job, a nonempty aggregation parameter, and an
  aggregate-share request with a count or checksum mismatch, too small a
  batch, an exhausted query count, an unaligned interval or a wrong token.
- A port pair (leader and helper, each behind a DapServer) takes uploads
  from the port's Client, aggregates them and collects them for Count,
  reaching the ground truth.

The port runs with device="cpu"; tolerance: exact equality.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from janus_tpu import collector as j_collector
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.aggregator import collection_job_driver as j_cdriver
from janus_tpu.aggregator import core as j_core
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.aggregator import job_driver as j_jobs
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu.core import hpke as j_hpke
from janus_tpu.core import http_client as j_client
from janus_tpu.core import retries as j_retries
from janus_tpu.core import time_util as j_time
from janus_tpu.core.auth import AuthenticationToken
from janus_tpu.datastore import models as j_models
from janus_tpu.datastore import store as j_store
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import collector as t_collector
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import collection_job_driver as t_cdriver
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.aggregator import job_driver as t_jobs
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core import hpke as t_hpke
from janus_tpu_torch.core import http_client as t_client
from janus_tpu_torch.core import retries as t_retries
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.task import Task
from janus_tpu_torch.vdaf import registry as t_registry

NOW = 1_700_000_000
TP = 3600
W0 = NOW - NOW % TP - 2 * TP  # the collected interval is [W0, W0 + 2 TP)
JOB_ID = bytes(range(16))
MIN_BATCH = 5
CIRCUITS = {"count": {"kind": "count"}, "sumvec": {"kind": "sumvec", "length": 3, "bits": 2}}
QUERIES = ["time_interval", "fixed_size"]
PAIRINGS = ["torch-jax", "jax-torch", "torch-torch"]
BATCH_X, BATCH_Y = bytes([0x11]) * 32, bytes([0x22]) * 32

PKG = {
    "jax": SimpleNamespace(
        m=jm, models=j_models, core=j_core, http=j_http, jobs=j_jobs, cdriver=j_cdriver, client=j_client,
        retries=j_retries, cb=j_cb, collector=j_collector, hpke=j_hpke,
        eph=lambda: j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW))),
        aggregator=lambda eph, cfg=None: j_core.Aggregator(eph.datastore, eph.clock, cfg or j_core.Config()),
        task=lambda t: t,
    ),
    "torch": SimpleNamespace(
        m=tm, models=t_models, core=t_core, http=t_http, jobs=t_jobs, cdriver=t_cdriver, client=t_client,
        retries=t_retries, cb=t_cb, collector=t_collector, hpke=t_hpke,
        eph=lambda: EphemeralDatastore(MockClock(tm.Time(NOW))),
        aggregator=lambda eph, cfg=None: t_core.Aggregator(eph.datastore, eph.clock, cfg or t_core.Config(),
                                                           device="cpu"),
        task=lambda t: Task.from_dict(t.to_dict()),
    ),
}


def _b64(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def query_for(m, query_type: str):
    if query_type == "time_interval":
        return m.Query.time_interval(m.Interval(m.Time(W0), m.Duration(2 * TP)))
    return m.Query.fixed_size(m.FixedSizeQuery(m.FixedSizeQuery.CURRENT_BATCH))


def make_tasks(vdaf_kw: dict, query_type: str, collector_kp, **kw):
    """A janus_tpu leader task and its helper task."""
    qt = (j_task.QueryTypeConfig.time_interval() if query_type == "time_interval"
          else j_task.QueryTypeConfig.fixed_size(max_batch_size=64))
    leader = (
        j_task.TaskBuilder(qt, j_registry.VdafInstance(**vdaf_kw), jm.Role.LEADER)
        .with_(
            vdaf_verify_key=bytes(range(16)), collector_hpke_config=collector_kp.config,
            aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_auth_token=AuthenticationToken.random_bearer(),
            min_batch_size=MIN_BATCH, time_precision=jm.Duration(TP), **kw,
        )
        .build()
    )
    helper = dataclasses.replace(leader, role=jm.Role.HELPER,
                                 hpke_keys=(j_hpke.generate_hpke_config_and_private_key(config_id=1),))
    return leader, helper


class Scenario:
    """One circuit under one query type: the tasks, the seeded shard rows
    of both aggregators, the ground truth and the reference pairing's
    rows and result."""

    def __init__(self, circuit: str, query_type: str):
        self.query_type = query_type
        self.collector_kp = j_hpke.generate_hpke_config_and_private_key(config_id=7)
        self.j_leader, self.j_helper = make_tasks(CIRCUITS[circuit], query_type, self.collector_kp)
        circ = t_registry.circuit_for(t_registry.VdafInstance(**CIRCUITS[circuit]))
        self.field = circ.FIELD
        rng = np.random.default_rng(3)
        p = self.field.MODULUS
        if query_type == "time_interval":
            # two windows collected (the first in two shards), one after
            specs = [(W0, 0, 3, True), (W0, 1, 2, True), (W0 + TP, 0, 4, True), (W0 + 2 * TP, 0, 5, False)]
            keys = [(jm.Interval(jm.Time(w), jm.Duration(TP)).to_bytes(), o, n, w, c) for w, o, n, c in specs]
        else:
            # batch X in two shards from two windows; batch Y, assigned
            # more reports but aggregated below min_batch_size
            keys = [(BATCH_X, 0, 3, W0, True), (BATCH_X, 1, 4, W0 + TP, True), (BATCH_Y, 0, 2, W0, False)]
        self.rows = []
        truth = np.zeros(circ.output_len, dtype=object)
        for bid, ord_, count, window, collected in keys:
            value = [int(x) for x in rng.integers(0, count + 1, size=circ.output_len)]
            leader = [int.from_bytes(rng.bytes(16), "little") % p for _ in value]
            helper = [(v - a) % p for v, a in zip(value, leader)]
            self.rows.append((bid, ord_, count, (window + 7 * ord_, 100 + ord_), rng.bytes(32),
                              self.field.encode_vec(leader), self.field.encode_vec(helper)))
            if collected:
                truth += np.array(value, dtype=object)
        self.count = sum(k[2] for k in keys if k[4])
        self.truth = truth[0] if circuit == "count" else [int(x) for x in truth]
        self.reference = self.run("jax", "jax")

    def shard_rows(self, side: int):
        """The seeded rows with the leader's (0) or the helper's (1) shares."""
        return [r[:5] + (r[5 + side],) for r in self.rows]

    def run(self, leader: str, helper: str):
        """Collect with a `leader` driver against a `helper` server; returns
        the rows of both sides and each collector's result."""
        lp, hp = PKG[leader], PKG[helper]
        h_eph, l_eph = hp.eph(), lp.eph()
        h_agg = hp.aggregator(h_eph)
        h_srv = hp.http.DapServer(hp.http.DapHttpApp(h_agg)).start()
        l_srv = None
        try:
            seed(hp, h_eph.datastore, hp.task(self.j_helper), self.shard_rows(1))
            task = lp.task(dataclasses.replace(self.j_leader, helper_aggregator_endpoint=h_srv.url))
            outstanding = ((BATCH_X, 7), (BATCH_Y, 9)) if self.query_type == "fixed_size" else ()
            seed(lp, l_eph.datastore, task, self.shard_rows(0), outstanding)
            l_agg = lp.aggregator(l_eph)
            l_srv = lp.http.DapServer(lp.http.DapHttpApp(l_agg)).start()
            m = lp.m
            query = query_for(m, self.query_type)
            l_agg.task_aggregator_for(task.task_id).handle_create_collection_job(
                l_eph.datastore, m.CollectionJobId(JOB_ID), m.CollectionReq(query, b"")
            )
            pending = {pkg: self._poll(pkg, l_srv.url) for pkg in PKG}
            driver = lp.cdriver.CollectionJobDriver(
                l_eph.datastore, lp.client.HttpClient(timeout=30),
                lp.cdriver.CollectionJobDriverConfig(http_backoff=lp.retries.Backoff.test()),
                breakers=lp.cb.OutboundCircuitBreakers(),
            )
            jobs = lp.jobs.JobDriver(lp.jobs.JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(),
                                     driver.stepper)
            assert jobs.run_once() == 1
            assert jobs.run_once() == 0  # finished: nothing left to acquire
            return {
                "leader": self.leader_rows(l_eph.datastore, lp),
                "helper": share_job_rows(h_eph.datastore, hp),
                "helper_batches": batch_rows(h_eph.datastore),
                "pending": pending,
                "results": {pkg: self._poll(pkg, l_srv.url) for pkg in PKG},
            }
        finally:
            h_srv.stop()
            if l_srv is not None:
                l_srv.stop()
            h_eph.cleanup()
            l_eph.cleanup()

    def _poll(self, pkg: str, url: str):
        """One poll by `pkg`'s Collector: the result, normalized, or the
        202's Retry-After."""
        p = PKG[pkg]
        task = p.task(self.j_leader)
        kp = p.hpke.HpkeKeypair(p.m.HpkeConfig.from_bytes(self.collector_kp.config.to_bytes()),
                                self.collector_kp.private_key)
        collector = p.collector.Collector(
            p.collector.CollectorParameters(task.task_id, url, task.collector_auth_token, kp), task.vdaf,
            p.client.HttpClient(timeout=30),
        )
        try:
            res = collector.poll_once(p.m.CollectionJobId(JOB_ID), query_for(p.m, self.query_type))
        except p.collector.CollectionJobNotReady as e:
            return ("not ready", e.retry_after_s)
        pbs = res.partial_batch_selector.to_bytes() if res.partial_batch_selector is not None else None
        return (res.report_count, res.interval.to_bytes(), res.aggregate_result, pbs)

    def batch_selector(self, bid: bytes):
        if self.query_type == "time_interval":
            return jm.BatchSelector.time_interval(jm.Interval.from_bytes(bid))
        return jm.BatchSelector.fixed_size(jm.BatchId(bid))

    def leader_rows(self, ds, pkg):
        """The collection job (leader share decrypted, helper share opened
        with the collector's key, lease columns), the leader's
        aggregate-share jobs and its batch aggregations."""
        m = pkg.m

        def read(tx):
            (tid,) = tx._c.execute("SELECT task_id FROM tasks").fetchone()
            job = tx.get_collection_job(m.TaskId(tid), m.CollectionJobId(JOB_ID))
            lease = tx._c.execute(
                "SELECT lease_expiry, lease_token IS NULL, lease_attempts, shard_key FROM collection_jobs"
            ).fetchall()
            return tid, job, lease

        tid, job, lease = ds.run_tx(read)
        assert pkg.m is jm or job.trace_context is None  # the port has no spans
        aad = jm.AggregateShareAad(jm.TaskId(tid), b"", self.batch_selector(job.batch_identifier)).to_bytes()
        helper_share = j_hpke.hpke_open(
            self.collector_kp,
            j_hpke.HpkeApplicationInfo(j_hpke.Label.AGGREGATE_SHARE, jm.Role.HELPER, jm.Role.COLLECTOR),
            jm.HpkeCiphertext.from_bytes(job.helper_encrypted_aggregate_share), aad,
        )
        cj = (job.query, job.aggregation_parameter, job.batch_identifier, job.state.value, job.report_count,
              job.client_timestamp_interval.to_bytes(), job.leader_aggregate_share, helper_share, lease)
        return cj, share_job_rows(ds, pkg), batch_rows(ds)


def seed(pkg, ds, task, rows, outstanding=()) -> None:
    """The task, its batch aggregations (bid, ord, count, (start,
    duration), checksum, share) and outstanding batches (bid, size)."""
    m, models = pkg.m, pkg.models

    def put(tx):
        tx.put_task(task)
        for bid, ord_, count, (start, dur), checksum, share in rows:
            tx.put_batch_aggregation(models.BatchAggregation(
                task.task_id, bid, b"", ord_, models.BatchAggregationState.AGGREGATING, share, count,
                m.Interval(m.Time(start), m.Duration(dur)), m.ReportIdChecksum(checksum),
            ))
        for bid, size in outstanding:
            tx.put_outstanding_batch(models.OutstandingBatch(task.task_id, m.BatchId(bid), None, size))

    ds.run_tx(put)


def share_job_rows(ds, pkg):
    """The aggregate-share jobs, their shares decrypted at rest."""
    m = pkg.m

    def read(tx):
        keys = tx._c.execute(
            "SELECT task_id, batch_identifier, aggregation_parameter FROM aggregate_share_jobs"
            " ORDER BY batch_identifier"
        ).fetchall()
        out = []
        for tid, bid, param in keys:
            j = tx.get_aggregate_share_job(m.TaskId(tid), bid, param)
            out.append((bid, param, j.helper_aggregate_share, j.report_count, j.checksum.data))
        return out

    return ds.run_tx(read)


def batch_rows(ds):
    return ds.run_tx(lambda tx: tx._c.execute(
        "SELECT batch_identifier, aggregation_parameter, ord, state, aggregate_share, report_count,"
        " client_interval_start, client_interval_duration, checksum FROM batch_aggregations"
        " ORDER BY batch_identifier, ord"
    ).fetchall())


@pytest.fixture(scope="module", params=[(c, q) for c in CIRCUITS for q in QUERIES], ids=lambda p: f"{p[0]}-{p[1]}")
def scenario(request):
    return Scenario(*request.param)


def test_reference_pairing_reaches_the_ground_truth(scenario):
    ref = scenario.reference
    (cj, leader_share_jobs, leader_batches) = ref["leader"]
    assert cj[3] == "finished" and cj[4] == scenario.count and cj[8] == [(cj[8][0][0], 1, 0, cj[8][0][3])]
    assert leader_share_jobs == []  # no DP noise to persist
    (helper_job,) = ref["helper"]
    assert helper_job[3] == scenario.count
    collected = {(r[0], r[2]) for r in leader_batches if r[3] == "collected"}
    assert collected == {(r[0], r[1]) for r in scenario.rows if r[0] != BATCH_Y
                         and (scenario.query_type == "fixed_size" or r[3][0] < W0 + 2 * TP)}
    assert {(r[0], r[2], r[3]) for r in leader_batches} == {(r[0], r[2], r[3]) for r in ref["helper_batches"]}
    assert ref["pending"] == {"jax": ("not ready", 1.0), "torch": ("not ready", 1.0)}
    count, _, result, pbs = ref["results"]["jax"]
    assert (count, result) == (scenario.count, scenario.truth)
    want_pbs = jm.PartialBatchSelector.fixed_size(jm.BatchId(BATCH_X)).to_bytes()
    assert pbs == (None if scenario.query_type == "time_interval" else want_pbs)


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_pairing_rows_and_results_equal_janus_tpu_pair(scenario, pairing):
    got = scenario.run(*pairing.split("-"))
    ref = scenario.reference
    for key in ("leader", "helper", "helper_batches", "pending"):
        assert got[key] == ref[key], key
    # both collectors, against this pairing's leader, get the reference's result
    assert got["results"] == {"jax": ref["results"]["jax"], "torch": ref["results"]["jax"]}


# --- the routes' answers -----------------------------------------------------


class Apps:
    """A janus_tpu and a port DapHttpApp over fresh datastores holding
    the same task (and, for a helper, the same shard rows)."""

    def __init__(self, role: str, query_type: str = "time_interval", **kw):
        self.collector_kp = j_hpke.generate_hpke_config_and_private_key(config_id=7)
        leader, helper = make_tasks({"kind": "count"}, query_type, self.collector_kp, **kw)
        self.task = leader if role == "leader" else helper
        self.ephs, self.apps = {}, {}
        for pkg, p in PKG.items():
            eph = p.eph()
            task = p.task(self.task)
            if role == "helper":
                seed(p, eph.datastore, task, HELPER_ROWS)
            elif query_type == "fixed_size":
                # batch X: 7 reports aggregated, ready for a current-batch query
                seed(p, eph.datastore, task, [(BATCH_X, 0, 7, (W0, 1), bytes(32), bytes(8))], [(BATCH_X, 7)])
            else:
                seed(p, eph.datastore, task, [])
            self.ephs[pkg] = eph
            self.apps[pkg] = p.http.DapHttpApp(p.aggregator(eph))

    def both(self, method: str, path: str, headers: dict, body: bytes = b""):
        """The two apps' answers to one request (status, type, body, headers)."""
        return [self.apps[pkg].handle(method, path, {}, dict(headers), body) for pkg in PKG]

    def sql(self, stmt: str) -> None:
        for eph in self.ephs.values():
            eph.datastore.run_tx(lambda tx: tx._c.execute(stmt))

    def close(self):
        for pkg in PKG:
            self.apps[pkg].close()
            self.ephs[pkg].cleanup()


# the helper's shard rows: 7 reports in [W0, W0 + TP), 2 in the next window
HELPER_ROWS = [
    (jm.Interval(jm.Time(W0), jm.Duration(TP)).to_bytes(), 0, 7, (W0, 10), bytes([1]) * 32, bytes(8)),
    (jm.Interval(jm.Time(W0 + TP), jm.Duration(TP)).to_bytes(), 0, 2, (W0 + TP, 10), bytes([2]) * 32, bytes(8)),
]


def _collect_req(start: int, dur: int, param: bytes = b"") -> bytes:
    return jm.CollectionReq(jm.Query.time_interval(jm.Interval(jm.Time(start), jm.Duration(dur))), param).to_bytes()


def _fixed_req(batch_id: bytes | None, param: bytes = b"") -> bytes:
    fsq = (jm.FixedSizeQuery(jm.FixedSizeQuery.CURRENT_BATCH) if batch_id is None
           else jm.FixedSizeQuery(jm.FixedSizeQuery.BY_BATCH_ID, jm.BatchId(batch_id)))
    return jm.CollectionReq(jm.Query.fixed_size(fsq), param).to_bytes()


def _leader_script(case: str):
    """(query type, task overrides, [(method, job id byte or None, body or
    None, token override, content type override)])."""
    ti = "time_interval"
    if case == "overlap":
        return ti, {}, [("PUT", 1, _collect_req(W0, 2 * TP)), ("PUT", 2, _collect_req(W0 + TP, 2 * TP)),
                        ("PUT", 3, _collect_req(W0 + 2 * TP, TP))]
    if case == "idempotent-retry-and-job-id-reuse":
        return ti, {}, [("PUT", 3, _collect_req(W0, TP)), ("PUT", 3, _collect_req(W0, TP)),
                        ("PUT", 4, _collect_req(W0, TP)), ("PUT", 3, _collect_req(W0 + TP, TP))]
    if case == "new-aggregation-parameter-same-interval":
        return ti, {"max_batch_query_count": 2}, [("PUT", 30, _collect_req(W0, TP)),
                                                  ("PUT", 31, _collect_req(W0, TP, b"\x01"))]
    if case == "fixed-size-query-count":
        return "fixed_size", {}, [("PUT", 10, _fixed_req(None)), ("PUT", 11, _fixed_req(BATCH_X)),
                                  ("PUT", 12, _fixed_req(None)), ("PUT", 10, _fixed_req(None)),
                                  ("PUT", 10, _fixed_req(BATCH_X)), ("PUT", 13, _fixed_req(None, b"\x02"))]
    if case == "poll-202-retry-after":
        return ti, {}, [("PUT", 5, _collect_req(W0, TP)), ("POST", 5, b"")]
    if case == "unknown-and-deleted-job":
        return ti, {}, [("POST", 6, b""), ("DELETE", 6, b""), ("PUT", 6, _collect_req(W0, TP)),
                        ("DELETE", 6, b""), ("POST", 6, b""), ("DELETE", 6, b"")]
    if case == "abandoned-job":
        return ti, {}, [("PUT", 8, _collect_req(W0, TP)), "abandon", ("POST", 8, b"")]
    if case == "unaligned-and-short-interval":
        return ti, {}, [("PUT", 9, _collect_req(W0 + 1, TP)), ("PUT", 9, _collect_req(W0, TP // 2))]
    if case == "wrong-token-and-media-type":
        return ti, {}, [("PUT", 7, _collect_req(W0, TP), "bad-token"), ("POST", 7, b"", "bad-token"),
                        ("PUT", 7, _collect_req(W0, TP), None, "application/dap-collection-req")]
    raise AssertionError(case)


LEADER_CASES = ["overlap", "idempotent-retry-and-job-id-reuse", "new-aggregation-parameter-same-interval",
                "fixed-size-query-count", "poll-202-retry-after", "unknown-and-deleted-job", "abandoned-job",
                "unaligned-and-short-interval", "wrong-token-and-media-type"]


@pytest.mark.parametrize("case", LEADER_CASES)
def test_collection_route_answers_match_janus_tpu(case):
    query_type, kw, script = _leader_script(case)
    apps = Apps("leader", query_type, **kw)
    try:
        tid = _b64(apps.task.task_id.data)
        answers = []
        for step in script:
            if step == "abandon":
                apps.sql("UPDATE collection_jobs SET state = 'abandoned'")
                continue
            method, job, body, *rest = step
            token = AuthenticationToken.bearer("not-the-token") if rest and rest[0] else apps.task.collector_auth_token
            headers = dict(token.request_headers())
            if method == "PUT":
                headers["Content-Type"] = rest[1] if len(rest) > 1 else jm.CollectionReq.MEDIA_TYPE
            want, got = apps.both(method, f"/tasks/{tid}/collection_jobs/{_b64(bytes([job]) * 16)}", headers, body)
            assert got == want, (step, got, want)
            answers.append(want[0])
        expected = {
            "overlap": [201, 400, 201],
            "idempotent-retry-and-job-id-reuse": [201, 201, 400, 400],
            "new-aggregation-parameter-same-interval": [201, 400],
            "fixed-size-query-count": [201, 400, 400, 201, 400, 400],
            "poll-202-retry-after": [201, 202],
            "unknown-and-deleted-job": [400, 400, 201, 204, 400, 204],
            "abandoned-job": [201, 500],
            "unaligned-and-short-interval": [400, 400],
            "wrong-token-and-media-type": [400, 400, 400],
        }[case]
        assert answers == expected
    finally:
        apps.close()


def _share_req(start: int, dur: int, count: int, checksum: bytes, param: bytes = b"") -> bytes:
    sel = jm.BatchSelector.time_interval(jm.Interval(jm.Time(start), jm.Duration(dur)))
    return jm.AggregateShareReq(sel, param, count, jm.ReportIdChecksum(checksum)).to_bytes()


def _checksum(*parts: bytes) -> bytes:
    out = jm.ReportIdChecksum()
    for p in parts:
        out = out.combined_with(jm.ReportIdChecksum(p))
    return out.data


SHARE_CASES = {
    # (requests as (body, bad token), answers' statuses)
    "served-then-replayed": ([(_share_req(W0, TP, 7, _checksum(bytes([1]) * 32)), False)] * 2, [200, 200]),
    "count-mismatch": ([(_share_req(W0, TP, 6, _checksum(bytes([1]) * 32)), False)], [400]),
    "checksum-mismatch": ([(_share_req(W0, TP, 7, _checksum(bytes([9]) * 32)), False)], [400]),
    "batch-too-small": ([(_share_req(W0 + TP, TP, 2, _checksum(bytes([2]) * 32)), False)], [400]),
    "no-reports": ([(_share_req(W0 + 5 * TP, TP, 0, bytes(32)), False)], [400]),
    "query-count": ([(_share_req(W0, TP, 7, _checksum(bytes([1]) * 32)), False),
                     (_share_req(W0, TP, 7, _checksum(bytes([1]) * 32), b"\x01"), False)], [200, 400]),
    "unaligned": ([(_share_req(W0 + 1, TP, 7, bytes(32)), False)], [400]),
    "wrong-token": ([(_share_req(W0, TP, 7, _checksum(bytes([1]) * 32)), True)], [400]),
}


@pytest.mark.parametrize("case", list(SHARE_CASES))
def test_aggregate_share_answers_match_janus_tpu(case):
    requests, statuses = SHARE_CASES[case]
    apps = Apps("helper")
    try:
        tid = _b64(apps.task.task_id.data)
        for (body, bad), status in zip(requests, statuses):
            token = AuthenticationToken.bearer("not-the-token") if bad else apps.task.aggregator_auth_token
            headers = {"Content-Type": jm.AggregateShareReq.MEDIA_TYPE, **token.request_headers()}
            want, got = apps.both("POST", f"/tasks/{tid}/aggregate_shares", headers, body)
            assert want[0] == status, want
            if status == 200:
                # sealed to the collector with fresh randomness: compare
                # the plaintexts
                req = jm.AggregateShareReq.from_bytes(body)
                aad = jm.AggregateShareAad(apps.task.task_id, b"", req.batch_selector).to_bytes()
                info = j_hpke.HpkeApplicationInfo(j_hpke.Label.AGGREGATE_SHARE, jm.Role.HELPER, jm.Role.COLLECTOR)
                opened = [j_hpke.hpke_open(apps.collector_kp, info,
                                           jm.AggregateShare.from_bytes(a[2]).encrypted_aggregate_share, aad)
                          for a in (want, got)]
                assert got[:2] == want[:2] and opened[0] == opened[1] == bytes(8)
            else:
                assert got == want
        assert share_job_rows(apps.ephs["torch"].datastore, PKG["torch"]) == share_job_rows(
            apps.ephs["jax"].datastore, PKG["jax"])
        assert batch_rows(apps.ephs["torch"].datastore) == batch_rows(apps.ephs["jax"].datastore)
    finally:
        apps.close()


# --- upload -> aggregate -> collect, a port pair -------------------------------


def test_port_pair_uploads_aggregates_and_collects_count():
    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.client import Client, ClientParameters

    meas = [1, 0, 1, 1, 0, 1, 1]
    collector_kp = t_hpke.generate_hpke_config_and_private_key(config_id=7)
    helper_eph, leader_eph = PKG["torch"].eph(), PKG["torch"].eph()
    helper, leader = PKG["torch"].aggregator(helper_eph), PKG["torch"].aggregator(leader_eph)
    helper_srv = t_http.DapServer(t_http.DapHttpApp(helper)).start()
    leader_srv = t_http.DapServer(t_http.DapHttpApp(leader)).start()
    try:
        j_collector_kp = j_hpke.HpkeKeypair(jm.HpkeConfig.from_bytes(collector_kp.config.to_bytes()),
                                            collector_kp.private_key)
        j_leader, j_helper = make_tasks({"kind": "count"}, "time_interval", j_collector_kp,
                                        leader_aggregator_endpoint=leader_srv.url,
                                        helper_aggregator_endpoint=helper_srv.url)
        task, helper_task = Task.from_dict(j_leader.to_dict()), Task.from_dict(j_helper.to_dict())
        leader_eph.datastore.run_tx(lambda tx: tx.put_task(task))
        helper_eph.datastore.run_tx(lambda tx: tx.put_task(helper_task))
        http = t_client.HttpClient(timeout=30)
        params = ClientParameters(task.task_id, leader_srv.url, helper_srv.url, task.time_precision)
        client = Client.with_fetched_configs(params, task.vdaf, http, clock=leader_eph.clock)
        for m in meas:
            client.upload(m)
        assert AggregationJobCreator(leader_eph.datastore).run_once() == 1
        agg_driver = AggregationJobDriver(
            leader_eph.datastore, http, AggregationJobDriverConfig(http_backoff=t_retries.Backoff.test()),
            device="cpu",
        )
        cfg = t_jobs.JobDriverConfig(max_concurrent_job_workers=1)
        assert t_jobs.JobDriver(cfg, agg_driver.acquirer(), agg_driver.stepper).run_once() == 1

        collector = t_collector.Collector(
            t_collector.CollectorParameters(task.task_id, leader_srv.url, task.collector_auth_token, collector_kp),
            task.vdaf, http,
        )
        window = tm.Time(NOW).to_batch_interval_start(task.time_precision)
        query = tm.Query.time_interval(tm.Interval(window, task.time_precision))
        job_id = collector.start_collection(query)
        with pytest.raises(t_collector.CollectionJobNotReady):
            collector.poll_once(job_id, query)
        coll_driver = t_cdriver.CollectionJobDriver(
            leader_eph.datastore, http, t_cdriver.CollectionJobDriverConfig(http_backoff=t_retries.Backoff.test())
        )
        assert t_jobs.JobDriver(cfg, coll_driver.acquirer(), coll_driver.stepper).run_once() == 1
        result = collector.poll_once(job_id, query)
        assert (result.report_count, result.aggregate_result) == (len(meas), sum(meas))
        assert result.interval.start.seconds >= window.seconds
        assert set(coll_driver.step_seconds[-1][1]) == {"gather", "sum", "http_aggregate_share", "store"}
    finally:
        leader_srv.stop()
        helper_srv.stop()
        leader.close()
        helper.close()
        leader_eph.cleanup()
        helper_eph.cleanup()
