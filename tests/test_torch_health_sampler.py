"""janus_tpu_torch/aggregator/health_sampler.py against janus_tpu's.

Both packages' datastores hold the same tasks, jobs and reports (the
rows of tests/test_torch_gc.py, plus in-progress aggregation jobs under a
lease, a collection job under a lease and a seeded spread of unaggregated
reports). After `run_once()` on the same clock, the sampler's snapshot,
the gauges it sets and the conservation ledger's evaluation it drives
must equal janus_tpu's. Tolerance: exact equality.
"""

import time

import numpy as np
import pytest

import janus_tpu.ledger as j_ledger
import janus_tpu.metrics as j_metrics
import janus_tpu_torch.ledger as t_ledger
import janus_tpu_torch.metrics as t_metrics
from janus_tpu.aggregator import health_sampler as j_hs
from janus_tpu.core import hpke as j_hpke
from janus_tpu_torch.aggregator import health_sampler as t_hs
from test_torch_collect import NOW, PKG, TP, make_tasks
from test_torch_gc import fill

HS = {"jax": j_hs, "torch": t_hs}
METRICS = {"jax": j_metrics, "torch": t_metrics}
LEDGER = {"jax": j_ledger, "torch": t_ledger}


@pytest.fixture(scope="module")
def tasks():
    kp = j_hpke.generate_hpke_config_and_private_key(config_id=7)
    a, _ = make_tasks({"kind": "count"}, "time_interval", kp, report_expiry_age=PKG["jax"].m.Duration(3 * TP))
    b, _ = make_tasks({"kind": "count"}, "fixed_size", kp)
    return [a, b]


def _more_rows(pkg: str, eph, tasks, seed: int):
    """Seeded unaggregated reports, in-progress jobs with their report
    aggregations, and one lease of each job type."""
    p = PKG[pkg]
    m, models = p.m, p.models
    rng = np.random.default_rng(seed)

    def put(tx):
        for n, j_task_ in enumerate(tasks):
            tid = p.task(j_task_).task_id
            ct = m.HpkeCiphertext(m.HpkeConfigId(1), b"k", b"p")
            for k in range(int(rng.integers(5, 40))):
                rid = m.ReportId(bytes([n, 0x80 | k]) + bytes(14))
                t = NOW - int(rng.integers(0, 6 * TP))
                tx.put_client_report(models.LeaderStoredReport(tid, rid, m.Time(t), b"", b"x", ct))
            for k in range(int(rng.integers(1, 4))):
                jid = m.AggregationJobId(bytes([n, 0x40 | k]) * 8)
                tx.put_aggregation_job(models.AggregationJobModel(
                    tid, jid, b"", m.PartialBatchSelector.time_interval().to_bytes(),
                    m.Interval(m.Time(NOW - 100), m.Duration(100)), models.AggregationJobState.IN_PROGRESS, 0,
                ))
                for o in range(int(rng.integers(1, 70))):
                    tx.put_report_aggregation(models.ReportAggregationModel(
                        tid, jid, m.ReportId(bytes([n, k, o, 0x40]) * 4), m.Time(NOW - 100), o,
                        models.ReportAggregationState.START,
                    ))
        tx.acquire_incomplete_aggregation_jobs(m.Duration(600), 2)
        tx.acquire_incomplete_collection_jobs(m.Duration(600), 1)

    eph.datastore.run_tx(put)


@pytest.mark.parametrize("seed", [0, 1])
def test_run_once_equals_janus_tpus(tasks, seed, tmp_path):
    ephs = {}
    samplers = {}
    try:
        for pkg in PKG:
            eph = ephs[pkg] = fill(pkg, tasks)
            _more_rows(pkg, eph, tasks, seed)
            journal = tmp_path / pkg / "journal"
            journal.mkdir(parents=True)
            (journal / "seg-0").write_bytes(bytes(1000 + seed))
            ev = LEDGER[pkg].LedgerEvaluator(eph.datastore, LEDGER[pkg].LedgerConfig(grace_s=0.0))
            samplers[pkg] = HS[pkg].HealthSampler(
                eph.datastore, 5.0, artifact_paths={"upload_journal": str(journal)}, ledger=ev
            )
        snaps = {}
        leases = []
        for advance in (0, 120, 4000):
            for pkg, eph in ephs.items():
                eph.clock.advance(PKG[pkg].m.Duration(advance))
                snaps[pkg] = samplers[pkg].run_once()
            assert snaps["torch"] == snaps["jax"], advance
            leases.append((snaps["torch"]["outstanding_leases"], snaps["torch"]["max_lease_age_seconds"]))
            # the gauges each sampler set, read back from its registry
            for key in ("jobs_gauge", "job_lease_age_seconds", "oldest_unaggregated_report_age_seconds",
                        "unaggregated_report_age_quantiles", "batches_pending_collection",
                        "datastore_table_rows", "artifact_bytes"):
                got = {}
                for pkg in PKG:
                    g = getattr(METRICS[pkg], key)
                    with g._lock:
                        got[pkg] = dict(g._values)
                shared = set(got["jax"]) & set(got["torch"])
                assert shared, key
                assert {k: got["torch"][k] for k in shared} == {k: got["jax"][k] for k in shared}, key
            docs = {pkg: samplers[pkg].ledger.document() for pkg in PKG}
            assert docs["torch"]["tasks"] == docs["jax"]["tasks"]
            assert docs["torch"]["breaches"] == docs["jax"]["breaches"]
            assert docs["torch"]["evaluations"] == docs["jax"]["evaluations"]
        snap = snaps["torch"]
        # three leases, seen aging, then expired past their 600 s
        assert leases == [(3, 0), (3, 120), (0, 0)]
        assert snap["artifact_bytes"] == {"upload_journal": 1000 + seed}
        assert snap["jobs"]["aggregation/in_progress"] >= 2
        assert set(snap["datastore_table_rows"]) == {
            "tasks", "client_reports", "aggregation_jobs", "report_aggregations", "batch_aggregations",
            "collection_jobs", "aggregate_share_jobs", "batches", "outstanding_batches", "task_counters",
        }
    finally:
        for eph in ephs.values():
            eph.cleanup()


def test_pending_job_sizes_equal(tasks):
    ephs = {pkg: fill(pkg, tasks) for pkg in PKG}
    try:
        for pkg, eph in ephs.items():
            _more_rows(pkg, eph, tasks, 5)
        sizes = {pkg: eph.datastore.run_tx(lambda tx: tx.get_pending_aggregation_job_sizes())
                 for pkg, eph in ephs.items()}
        assert sizes["torch"] == sizes["jax"] and sizes["torch"]
    finally:
        for eph in ephs.values():
            eph.cleanup()


def test_artifact_paths_keep_the_upload_journal_only():
    import janus_tpu.config as jcfg
    import janus_tpu_torch.config as tcfg

    doc = {"upload_journal": {"path": "/var/lib/janus/journal"}, "compilation_cache_dir": "/c"}
    j = j_hs.artifact_paths_from_config(jcfg.CommonConfig.from_dict(doc), jcfg.AggregatorConfig.from_dict(doc))
    t = t_hs.artifact_paths_from_config(tcfg.CommonConfig.from_dict(doc), tcfg.AggregatorConfig.from_dict(doc))
    # the upload journal, the shape manifest and the kernel-library cache,
    # as janus_tpu's
    assert t == j == {"upload_journal": "/var/lib/janus/journal", "shape_manifest": "/c/shape_manifest.jsonl",
                      "aot_cache": "/c/aot"}
    doc["engine"] = {"shape_manifest_path": "", "aot_cache": False}
    j = j_hs.artifact_paths_from_config(jcfg.CommonConfig.from_dict(doc), jcfg.AggregatorConfig.from_dict(doc))
    t = t_hs.artifact_paths_from_config(tcfg.CommonConfig.from_dict(doc), tcfg.AggregatorConfig.from_dict(doc))
    assert t == j == {"upload_journal": "/var/lib/janus/journal"}
    # the named divergence: no compile cache directory unless a key names
    # one (janus_tpu's default is ~/.cache/janus_tpu_xla)
    assert t_hs.artifact_paths_from_config(tcfg.CommonConfig.from_dict({})) == {}


def test_sampler_thread_starts_and_stops(tasks):
    eph = fill("torch", tasks)
    try:
        s = t_hs.HealthSampler(eph.datastore, 0.05).start()
        from janus_tpu_torch.statusz import status_snapshot

        deadline = time.monotonic() + 10
        while not s.last_snapshot and time.monotonic() < deadline:
            time.sleep(0.02)
        s.stop()
        assert status_snapshot()["job_health"]["interval_s"] == 0.05
    finally:
        eph.cleanup()
