"""janus_tpu_torch's fixed-size job creation and the upload slice as a whole,
held against janus_tpu's.

- The creator's batch packing (fill toward max_batch_size, spill into new
  batches, the fullest open batch topped up first, sub-minimum chunks
  deferred, one packing per time bucket, jobs capped at the maximum job
  size) leaves the outstanding_batches, aggregation_jobs,
  report_aggregations and claimed client_reports rows that janus_tpu's
  creator leaves on the same reports. Both creators draw their batch and
  job ids from equal seeded streams, so the rows compare exactly.
- The batch and outstanding-batch datastore ops give janus_tpu's answers
  to one script of puts, top-ups, listings and deletes.
- The slice as a whole: Count reports uploaded by a client over loopback
  HTTP to a leader on a fixed-size task (one leader share corrupted
  inside the field, so upload accepts it and prepare rejects it), packed
  by the creator and stepped by the job driver against a helper, once
  with janus_tpu's client, leader and helper and once with the port's.
  The leader's and the helper's rows must be equal, and the two stored
  shares, keyed by the batch id, must unshard to the accepted sum.

The port runs with device="cpu"; tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest

from janus_tpu import client as j_client_mod
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.aggregator import aggregation_job_creator as j_creator
from janus_tpu.aggregator import aggregation_job_driver as j_driver
from janus_tpu.aggregator import core as j_core
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.aggregator import job_driver as j_jobs
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu.core import http_client as j_httpc
from janus_tpu.core import retries as j_retries
from janus_tpu.core import time_util as j_time
from janus_tpu.core.auth import AuthenticationToken
from janus_tpu.core.hpke import generate_hpke_config_and_private_key
from janus_tpu.datastore import models as j_models
from janus_tpu.datastore import store as j_store
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import client as t_client_mod
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import aggregation_job_creator as t_creator
from janus_tpu_torch.aggregator import aggregation_job_driver as t_driver
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.aggregator import job_driver as t_jobs
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core import http_client as t_httpc
from janus_tpu_torch.core import retries as t_retries
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.task import Task
from test_torch_upload import _Seeded, reseal_leader, seed_clients

NOW = 1_700_000_000

# --- the creator ----------------------------------------------------------

PKGS = {"jax": (jm, j_models, j_creator), "torch": (tm, t_models, t_creator)}


class Leader:
    """One package's leader datastore holding a fixed-size task."""

    def __init__(self, pkg: str, task):
        self.pkg = pkg
        self.m, self.models, self.creator = PKGS[pkg]
        if pkg == "jax":
            self.eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
            self.task = task
        else:
            self.eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
            self.task = Task.from_dict(task.to_dict())
        self.ds = self.eph.datastore
        self.ds.run_tx(lambda tx: tx.put_task(self.task))

    def put_reports(self, ids, times) -> None:
        m = self.m
        ct = m.HpkeCiphertext(m.HpkeConfigId(1), b"enc", b"ct")
        self.ds.run_tx(lambda tx: [
            tx.put_client_report(self.models.LeaderStoredReport(self.task.task_id, m.ReportId(r), m.Time(t), b"", b"x", ct))
            for r, t in zip(ids, times)
        ])

    def create(self, monkeypatch, stream, min_job: int, max_job: int) -> int:
        monkeypatch.setattr(self.creator, "secrets", stream)
        cfg = self.creator.AggregationJobCreatorConfig(min_job, max_job)
        return self.creator.AggregationJobCreator(self.ds, cfg).run_once()

    def rows(self):
        def q(tx, sql):
            return [tuple(r) for r in tx._c.execute(sql).fetchall()]

        return self.ds.run_tx(lambda tx: (
            q(tx, "SELECT batch_id, time_bucket_start, size, filled FROM outstanding_batches ORDER BY batch_id"),
            q(tx, "SELECT job_id, aggregation_parameter, partial_batch_identifier, client_interval_start,"
                  " client_interval_duration, state, step, shard_key, lease_expiry FROM aggregation_jobs ORDER BY job_id"),
            q(tx, "SELECT job_id, report_id, client_time, ord, state FROM report_aggregations ORDER BY job_id, ord"),
            q(tx, "SELECT report_id, aggregation_started FROM client_reports ORDER BY report_id"),
        ))


# (max_batch_size, batch window, min job, max job, passes: [(report count, time offset)])
CREATOR_CASES = {
    "fill-spill-top-up": (5, None, 1, 100, [(12, 0), (4, 0)]),
    "defer-sub-minimum": (5, None, 3, 100, [(7, 0), (2, 0)]),
    "time-buckets": (4, 3600, 1, 100, [(5, 0), (3, 3600), (2, 0)]),
    "job-cap": (5, None, 1, 3, [(11, 0)]),
}


@pytest.mark.parametrize("case", list(CREATOR_CASES))
def test_fixed_size_creator_leaves_janus_tpu_rows(monkeypatch, case):
    max_bs, window, min_job, max_job, passes = CREATOR_CASES[case]
    qt = j_task.QueryTypeConfig.fixed_size(
        max_batch_size=max_bs, batch_time_window_size=jm.Duration(window) if window else None
    )
    task = j_task.TaskBuilder(qt, j_registry.VdafInstance.count(), jm.Role.LEADER).build()
    sides = [Leader("jax", task), Leader("torch", task)]
    streams = [_Seeded(4), _Seeded(4)]
    rng = np.random.default_rng(8)
    try:
        for n, offset in passes:
            ids = [rng.bytes(16) for _ in range(n)]
            times = [NOW - 7200 + offset + 60 * i for i in range(n)]
            made = []
            for side, stream in zip(sides, streams):
                side.put_reports(ids, times)
                made.append(side.create(monkeypatch, stream, min_job, max_job))
            assert made[0] == made[1]
            assert sides[1].rows() == sides[0].rows()
        obs, jobs, ras, reports = sides[1].rows()
        assert all(size <= max_bs for _, _, size, _ in obs)
        assert [filled for _, _, size, filled in obs] == [int(size == max_bs) for _, _, size, _ in obs]
        assert len(jobs) > 1 and all(n <= max_job for n in np.unique([r[0] for r in ras], return_counts=True)[1])
        if case == "defer-sub-minimum":
            assert sorted(s for _, _, s, _ in obs) == [4, 5]  # the 2 left over waited for the next pass
    finally:
        for side in sides:
            side.eph.cleanup()


def _plain(x):
    """A datastore answer of either package as plain values."""
    if isinstance(x, list):
        return [_plain(y) for y in x]
    if hasattr(x, "batch_identifier"):  # Batch
        iv = x.client_timestamp_interval
        return (x.task_id.data, x.batch_identifier, x.aggregation_parameter, x.state.value,
                x.outstanding_aggregation_jobs, iv.start.seconds, iv.duration.seconds)
    if hasattr(x, "batch_id"):  # OutstandingBatch
        return (x.task_id.data, x.batch_id.data, x.time_bucket_start and x.time_bucket_start.seconds, x.size)
    return x


def test_batch_and_outstanding_batch_ops_match_janus_tpu():
    """The batch and outstanding-batch datastore ops, one script on both
    packages' datastores: the same answer at every step (put, get and
    update a batch; put, top up, mark filled, list with and without the
    filled ones and per time bucket, and delete outstanding batches)."""
    qt = j_task.QueryTypeConfig.fixed_size(max_batch_size=8, batch_time_window_size=jm.Duration(3600))
    task = j_task.TaskBuilder(qt, j_registry.VdafInstance.count(), jm.Role.LEADER).build()
    answers = []
    for side in (Leader("jax", task), Leader("torch", task)):
        m, models = side.m, side.models
        tid = m.TaskId(task.task_id.data)
        bucket = m.Time(NOW - 3600)
        ids = [m.BatchId(bytes([i]) * 32) for i in range(3)]

        def script(tx):
            out = []
            batch = models.Batch(tid, ids[0].data, b"", models.BatchState.OPEN, 2,
                                 m.Interval(bucket, m.Duration(3600)))
            tx.put_batch(batch)
            out.append(tx.get_batch(tid, ids[0].data, b""))
            tx.update_batch(dataclasses.replace(batch, state=models.BatchState.CLOSING, outstanding_aggregation_jobs=0))
            out += [tx.get_batch(tid, ids[0].data, b""), tx.get_batch(tid, ids[1].data, b"")]
            for bid, start in zip(ids, (None, bucket, bucket)):
                tx.put_outstanding_batch(models.OutstandingBatch(tid, bid, start))
            out += [tx.add_to_outstanding_batch(tid, ids[1], 8), tx.add_to_outstanding_batch(tid, ids[2], 3),
                    tx.add_to_outstanding_batch(tid, ids[0], 1)]
            tx.mark_outstanding_batch_filled(tid, ids[1])
            out += [tx.get_outstanding_batches(tid), tx.get_outstanding_batches(tid, include_filled=True),
                    tx.get_outstanding_batches(tid, time_bucket_start=bucket, include_filled=True)]
            tx.delete_outstanding_batch(tid, ids[1])
            out.append(tx.get_outstanding_batches(tid, include_filled=True))
            return out

        try:
            answers.append(_plain(side.ds.run_tx(script)))
        finally:
            side.eph.cleanup()
    assert answers[1] == answers[0]
    got = answers[1]
    assert got[0][3] == "open" and got[1][3:5] == ("closing", 0) and got[2] is None
    assert got[3:6] == [8, 3, 1] and [b[1][0] for b in got[6]] == [2, 0] and len(got[7]) == 3


# --- the slice as a whole -------------------------------------------------


MEAS = [1, 0, 1, 1, 0, 1, 1, 1, 0, 1]
CORRUPT = 4


@pytest.fixture(scope="module")
def slice_tasks():
    token = AuthenticationToken.random_bearer()
    leader = (
        j_task.TaskBuilder(j_task.QueryTypeConfig.fixed_size(max_batch_size=len(MEAS)), j_registry.VdafInstance.count(),
                           jm.Role.LEADER)
        .with_(vdaf_verify_key=bytes(range(16)), aggregator_auth_token=token)
        .build()
    )
    helper = dataclasses.replace(leader, role=jm.Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),))
    return leader, helper


def run_slice(monkeypatch, pkg: str, leader_task, helper_task):
    """Upload, create and step with one package throughout; returns the
    leader's and the helper's rows and the batch id."""
    if pkg == "jax":
        Eph, clock, http_mod = j_store.EphemeralDatastore, j_time.MockClock(jm.Time(NOW)), j_http
        m, client_mod, creator, driver_mod, jobs, cb, httpc, retries = (
            jm, j_client_mod, j_creator, j_driver, j_jobs, j_cb, j_httpc, j_retries)
        to_task = lambda t: t  # noqa: E731
        make_agg = lambda eph: j_core.Aggregator(eph.datastore, eph.clock, j_core.Config())  # noqa: E731
    else:
        Eph, clock, http_mod = EphemeralDatastore, MockClock(tm.Time(NOW)), t_http
        m, client_mod, creator, driver_mod, jobs, cb, httpc, retries = (
            tm, t_client_mod, t_creator, t_driver, t_jobs, t_cb, t_httpc, t_retries)
        to_task = lambda t: Task.from_dict(t.to_dict())  # noqa: E731
        make_agg = lambda eph: t_core.Aggregator(eph.datastore, eph.clock, device="cpu")  # noqa: E731
    seed_clients(monkeypatch, 17)
    monkeypatch.setattr(creator, "secrets", _Seeded(6))
    l_eph, h_eph = Eph(clock), Eph(clock)
    l_agg, h_agg = make_agg(l_eph), make_agg(h_eph)
    l_srv, h_srv = http_mod.DapServer(http_mod.DapHttpApp(l_agg)).start(), http_mod.DapServer(http_mod.DapHttpApp(h_agg)).start()
    try:
        task = to_task(dataclasses.replace(leader_task, leader_aggregator_endpoint=l_srv.url,
                                           helper_aggregator_endpoint=h_srv.url))
        l_eph.datastore.run_tx(lambda tx: tx.put_task(task))
        h_eph.datastore.run_tx(lambda tx: tx.put_task(to_task(helper_task)))
        http = httpc.HttpClient(timeout=30)
        params = client_mod.ClientParameters(task.task_id, l_srv.url, h_srv.url, task.time_precision)
        client = client_mod.Client.with_fetched_configs(params, task.vdaf, http, clock=clock)
        for i, meas in enumerate(MEAS):
            if i != CORRUPT:
                client.upload(meas)
                continue
            report = client.prepare_report(meas)
            report = reseal_leader(leader_task, jm.Report.from_bytes(report.to_bytes()), lambda p: p.__setitem__(
                slice(0, 8), ((int.from_bytes(p[:8], "little") + 1) % (2**64 - 2**32 + 1)).to_bytes(8, "little")))
            status, _ = http.put(params.upload_uri(), report.to_bytes(), {"Content-Type": m.Report.MEDIA_TYPE})
            assert status == 201
        assert creator.AggregationJobCreator(l_eph.datastore).run_once() == 1
        drv = driver_mod.AggregationJobDriver(
            l_eph.datastore, http, driver_mod.AggregationJobDriverConfig(http_backoff=retries.Backoff.test()),
            breakers=cb.OutboundCircuitBreakers(), **({} if pkg == "jax" else {"device": "cpu"}),
        )
        assert jobs.JobDriver(jobs.JobDriverConfig(max_concurrent_job_workers=1), drv.acquirer(), drv.stepper).run_once() == 1

        def rows(ds, leader: bool):
            def read(tx):
                q = lambda sql: [tuple(r) for r in tx._c.execute(sql).fetchall()]  # noqa: E731
                out = (
                    q("SELECT report_id, client_time, ord, state, prepare_error FROM report_aggregations ORDER BY ord"),
                    q("SELECT batch_identifier, aggregation_parameter, ord, state, aggregate_share, report_count,"
                      " client_interval_start, client_interval_duration, checksum FROM batch_aggregations"),
                    q("SELECT job_id, partial_batch_identifier, state, step, lease_token IS NULL, lease_attempts"
                      " FROM aggregation_jobs"),
                )
                if leader:
                    out += (q("SELECT batch_id, size, filled FROM outstanding_batches"),
                            q("SELECT report_id, client_time, public_share, aggregation_started FROM client_reports"
                              " ORDER BY report_id"))
                return out

            return ds.run_tx(read)

        return rows(l_eph.datastore, True), rows(h_eph.datastore, False)
    finally:
        l_srv.stop()
        h_srv.stop()
        l_agg.close()
        h_agg.close()
        l_eph.cleanup()
        h_eph.cleanup()


def test_upload_to_fixed_size_job_matches_janus_tpu(monkeypatch, slice_tasks):
    leader_task, helper_task = slice_tasks
    want = run_slice(monkeypatch, "jax", leader_task, helper_task)
    got = run_slice(monkeypatch, "torch", leader_task, helper_task)
    assert got[0] == want[0], "leader rows differ"
    assert got[1] == want[1], "helper rows differ"
    (l_ras, l_bas, l_jobs, l_obs, l_reports), (h_ras, h_bas, _) = got
    assert len(l_reports) == len(MEAS) and all(r[3] == 1 for r in l_reports)
    assert [ra[3] for ra in l_ras] == ["failed" if i == CORRUPT else "finished" for i in range(len(MEAS))]
    assert l_ras[CORRUPT][4] == int(tm.PrepareError.VDAF_PREP_ERROR)
    (batch_id, size, filled), = l_obs
    assert (size, filled) == (len(MEAS), 1) and l_jobs[0][2:5] == ("finished", 0, 1)
    assert tm.PartialBatchSelector.from_bytes(l_jobs[0][1]).batch_id.data == batch_id
    assert [b[0] for b in l_bas] == [b[0] for b in h_bas] == [batch_id]
    p = 2**64 - 2**32 + 1
    total = (int.from_bytes(l_bas[0][4], "little") + int.from_bytes(h_bas[0][4], "little")) % p
    assert total == sum(x for i, x in enumerate(MEAS) if i != CORRUPT) and l_bas[0][5] == len(MEAS) - 1
