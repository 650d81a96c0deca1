"""janus_tpu_torch's garbage collector held against janus_tpu's.

Both packages' datastores hold the same rows: two tasks (one with a
report_expiry_age, one without, which GC skips), client reports claimed
and not, aggregation jobs with their report aggregations, batch
aggregations, collection jobs (finished ones with a client interval, one
still without), and aggregate-share jobs. Both clocks advance by the same
amount; `GarbageCollector.run_once` then runs pass after pass until a
pass deletes nothing. Every pass must delete janus_tpu's counts, by kind,
and after every pass the rows left in every table must equal janus_tpu's (columns
encrypted at rest with a random nonce are left out). The task-counter
rows are excluded: janus_tpu's GC books the conservation ledger there,
which the port does not port. `delete_expired_batch_aggregations`, which
no GC pass calls in either package, is held against janus_tpu's on its
own. Tolerance: exact equality.
"""

import dataclasses

import pytest

from janus_tpu import messages as jm
from janus_tpu.aggregator import garbage_collector as j_gc
from janus_tpu.core import hpke as j_hpke
from janus_tpu_torch.aggregator import garbage_collector as t_gc
from test_torch_collect import NOW, PKG, TP, make_tasks

GC = {"jax": j_gc, "torch": t_gc}
TABLES = {
    "tasks": "SELECT task_id, role, task_expiration FROM tasks ORDER BY task_id",
    "client_reports": "SELECT task_id, report_id, client_time, public_share, helper_encrypted_input_share,"
                      " aggregation_started FROM client_reports ORDER BY task_id, report_id",
    "aggregation_jobs": "SELECT task_id, job_id, aggregation_parameter, partial_batch_identifier,"
                        " client_interval_start, client_interval_duration, state, step, shard_key, lease_expiry"
                        " FROM aggregation_jobs ORDER BY task_id, job_id",
    "report_aggregations": "SELECT * FROM report_aggregations ORDER BY task_id, job_id, ord",
    "batch_aggregations": "SELECT * FROM batch_aggregations ORDER BY task_id, batch_identifier, ord",
    "collection_jobs": "SELECT task_id, collection_job_id, query, batch_identifier, state, report_count,"
                       " client_interval_start, client_interval_duration, helper_encrypted_aggregate_share,"
                       " shard_key, lease_expiry FROM collection_jobs ORDER BY task_id, collection_job_id",
    "aggregate_share_jobs": "SELECT task_id, batch_identifier, aggregation_parameter, report_count, checksum"
                            " FROM aggregate_share_jobs ORDER BY task_id, batch_identifier",
    "batches": "SELECT * FROM batches ORDER BY task_id",
    "outstanding_batches": "SELECT * FROM outstanding_batches ORDER BY task_id",
}


def fill(pkg: str, tasks):
    """A datastore of `pkg` holding the same rows for each task."""
    p = PKG[pkg]
    m, models = p.m, p.models
    eph = p.eph()

    def put(tx):
        for n, j_task_ in enumerate(tasks):
            task = p.task(j_task_)
            tid = task.task_id
            tx.put_task(task)
            ct = m.HpkeCiphertext(m.HpkeConfigId(1), b"k", b"p")
            for k in range(12):
                rid = m.ReportId(bytes([n, k]) * 8)
                tx.put_client_report(models.LeaderStoredReport(tid, rid, m.Time(NOW - 900 * k), b"", b"x", ct))
                if k % 3:  # claimed by an aggregation job
                    tx._c.execute("UPDATE client_reports SET aggregation_started = 1 WHERE report_id = ?", (rid.data,))
            for k in range(6):
                jid = m.AggregationJobId(bytes([n, k]) * 8)
                tx.put_aggregation_job(models.AggregationJobModel(
                    tid, jid, b"", m.PartialBatchSelector.time_interval().to_bytes(),
                    m.Interval(m.Time(NOW - 2000 * k), m.Duration(100)), models.AggregationJobState.FINISHED, 0,
                ))
                for o in range(2):
                    tx.put_report_aggregation(models.ReportAggregationModel(
                        tid, jid, m.ReportId(bytes([n, k, o, 0]) * 4), m.Time(NOW - 2000 * k), o,
                        models.ReportAggregationState.FINISHED,
                    ))
                tx.put_batch_aggregation(models.BatchAggregation(
                    tid, m.Interval(m.Time(NOW - NOW % TP - TP * k), m.Duration(TP)).to_bytes(), b"", 0,
                    models.BatchAggregationState.AGGREGATING, bytes(8), 2,
                    m.Interval(m.Time(NOW - 2000 * k), m.Duration(100)), m.ReportIdChecksum(bytes([k]) * 32),
                ))
            for k in range(4):
                bid = m.Interval(m.Time(NOW - NOW % TP - TP * k), m.Duration(TP)).to_bytes()
                job = models.CollectionJobModel(
                    tid, m.CollectionJobId(bytes([n, k]) * 8),
                    m.Query.time_interval(m.Interval.from_bytes(bid)).to_bytes(), b"", bid,
                    models.CollectionJobState.START,
                )
                tx.put_collection_job(job)
                if k:  # the first stays without an interval
                    tx.update_collection_job(dataclasses.replace(
                        job, state=models.CollectionJobState.FINISHED, report_count=2,
                        client_timestamp_interval=m.Interval(m.Time(NOW - 2500 * k), m.Duration(50)),
                        leader_aggregate_share=bytes(8), helper_encrypted_aggregate_share=b"helper-ct",
                    ))
                if k < 2:
                    tx.put_aggregate_share_job(models.AggregateShareJob(
                        tid, bid, b"", bytes(8), 2, m.ReportIdChecksum(bytes([k]) * 32)
                    ))

    eph.datastore.run_tx(put)
    return eph


def rows(ds):
    return ds.run_tx(lambda tx: {t: tx._c.execute(sql).fetchall() for t, sql in TABLES.items()})


@pytest.fixture(scope="module")
def tasks():
    kp = j_hpke.generate_hpke_config_and_private_key(config_id=7)
    expiring, _ = make_tasks({"kind": "count"}, "time_interval", kp, report_expiry_age=jm.Duration(3 * TP))
    keeping, _ = make_tasks({"kind": "count"}, "time_interval", kp)
    return [expiring, keeping]


@pytest.mark.parametrize("advance", [0, 2 * TP, 20 * TP])
@pytest.mark.parametrize("limits", [None, (3, 2, 1)], ids=["default-limits", "small-limits"])
def test_gc_deletes_what_janus_tpu_deletes(tasks, advance, limits):
    ephs = {pkg: fill(pkg, tasks) for pkg in PKG}
    try:
        assert rows(ephs["torch"].datastore) == rows(ephs["jax"].datastore)
        gcs = {}
        for pkg, eph in ephs.items():
            eph.clock.advance(PKG[pkg].m.Duration(advance))
            cfg = None if limits is None else GC[pkg].GarbageCollectorConfig(*limits)
            gcs[pkg] = GC[pkg].GarbageCollector(eph.datastore, eph.clock, cfg)
        passes = []
        while len(passes) < 40:
            deleted = {pkg: gc.run_once() for pkg, gc in gcs.items()}
            assert deleted["torch"] == deleted["jax"], len(passes)
            # the same rows left after every pass, not only the last
            assert rows(ephs["torch"].datastore) == rows(ephs["jax"].datastore), len(passes)
            passes.append(deleted["jax"])
            if not any(deleted["jax"].values()):
                break
        total = {k: sum(d[k] for d in passes) for k in ("reports", "aggregation", "collection")}
        if advance == 20 * TP:
            # everything of the expiring task that carries a time has gone
            assert total == {"reports": 12, "aggregation": 6, "collection": 3}
        if limits is not None and advance:
            assert len(passes) > 2  # the limits bound each pass
    finally:
        for eph in ephs.values():
            eph.cleanup()


@pytest.mark.parametrize("cutoff,limit", [(NOW - 5000, 10), (NOW, 2), (NOW + TP, 100)])
def test_delete_expired_batch_aggregations_matches_janus_tpu(tasks, cutoff, limit):
    ephs = {pkg: fill(pkg, tasks) for pkg in PKG}
    try:
        deleted = {
            pkg: eph.datastore.run_tx(lambda tx, pkg=pkg: tx.delete_expired_batch_aggregations(
                PKG[pkg].m.TaskId(tasks[0].task_id.data), PKG[pkg].m.Time(cutoff), limit))
            for pkg, eph in ephs.items()
        }
        assert deleted["torch"] == deleted["jax"] and deleted["jax"] > 0
        assert rows(ephs["torch"].datastore) == rows(ephs["jax"].datastore)
    finally:
        for eph in ephs.values():
            eph.cleanup()
