"""Periodic datastore health sampler: the serving-side SLO gauges.

A production DAP deployment operates against aggregation lag — how far
behind the oldest unaggregated report is, how deep the job backlog
runs, how long leases stay outstanding (Prio-class systems alert on
exactly these; the reference surfaces them via its aggregator-api task
metrics and OTel instruments). This sampler runs cheap read-only
datastore queries on a period (CommonConfig.health_sampler_interval_s)
and exports:

  janus_jobs{type,state}                          job backlog (gauge)
  janus_job_lease_age_seconds                     max outstanding lease age
  janus_oldest_unaggregated_report_age_seconds{task_id}
  janus_unaggregated_report_age_seconds{task_id,quantile}
                                                  freshness p50/p95/p99
  janus_batches_pending_collection                collection jobs pending

plus a /statusz section with the latest snapshot. The companion
counter janus_task_reports_aggregated_total is NOT sampled — the
accumulator increments it at accumulate time (accumulator.py).

Lease age caveat: the schema stores only lease_expiry, not the acquire
time, so age is measured from when THIS sampler first observed the
lease — a lower bound on the true age (exact once the lease has been
visible for one sampling period).

The port's own copy of janus_tpu/aggregator/health_sampler.py. Its
on-disk artifacts are janus_tpu's: the upload journal, the shape manifest
and the kernel-library cache's directory (the port's AOT cache).
"""

from __future__ import annotations

import logging
import os
import threading

from ..metrics import task_id_label as _b64_task_id

log = logging.getLogger(__name__)


def _path_bytes(path: str) -> int:
    """On-disk bytes of a file, or the recursive total of a directory
    (the journal's segment directory).
    Missing paths are 0 — an artifact that was never created is empty,
    not an error."""
    path = os.path.expanduser(path)
    try:
        if os.path.isdir(path):
            total = 0
            for root, _dirs, files in os.walk(path):
                for name in files:
                    try:
                        total += os.path.getsize(os.path.join(root, name))
                    except OSError:
                        pass
            return total
        return os.path.getsize(path)
    except OSError:
        return 0


def artifact_paths_from_config(common, aggregator=None) -> dict[str, str]:
    """{artifact label: path} for janus_artifact_bytes, derived from a
    CommonConfig (and the AggregatorConfig for the upload journal): the
    spill journal dir, the shape manifest and the kernel-library cache's
    directory, the locally persisted state that can leak bytes."""
    out = {}
    if aggregator is not None and getattr(aggregator, "upload_journal_path", None):
        out["upload_journal"] = aggregator.upload_journal_path
    cache_dir = common.engine.compile_cache_dir or common.compilation_cache_dir
    manifest = common.engine.shape_manifest_path
    if manifest is None and cache_dir:
        manifest = os.path.join(cache_dir, "shape_manifest.jsonl")
    if manifest:
        out["shape_manifest"] = manifest
    if cache_dir and common.engine.aot_cache:
        out["aot_cache"] = os.path.join(cache_dir, "aot")
    return out


class HealthSampler:
    """Thread-per-process sampler over one datastore. `run_once()` is
    the unit of work (tests and the bench smoke call it directly);
    `start()` spawns the periodic daemon thread.

    `artifact_paths` ({label: path}, see artifact_paths_from_config)
    adds on-disk artifact size sampling (janus_artifact_bytes);
    `gc` (a GarbageCollector) adds janus_gc_lag_seconds refreshes
    between GC passes. Both feed the flight recorder's leak-gated
    series; the table row counts (janus_datastore_table_rows) are
    always sampled."""

    def __init__(
        self, ds, interval_s: float = 15.0, artifact_paths=None, gc=None, ledger=None
    ):
        self.ds = ds
        self.artifact_paths = dict(artifact_paths or {})
        self.gc = gc
        # conservation-ledger evaluator (ledger.py): balance
        # evaluation rides the sampler cadence so "the books close
        # within one sampler interval" is literally one run_once
        self.ledger = ledger
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # (type, task_id, job_id) -> clock seconds at first observation
        self._lease_first_seen: dict[tuple, int] = {}
        # task_id labels we exported last pass (stale ones reset to 0)
        self._lag_tasks: set[str] = set()
        self._quantile_tasks: set[str] = set()
        self.last_snapshot: dict = {}
        from ..statusz import register_status_provider

        register_status_provider("job_health", lambda: self.last_snapshot)

    # ------------------------------------------------------------------
    def run_once(self) -> dict:
        from .. import metrics
        from ..datastore.models import AggregationJobState, CollectionJobState

        now = self.ds.clock.now().seconds
        # per-replica labels (docs/ARCHITECTURE.md "Running a fleet"):
        # {} in single-process deployments, {"replica": id} when a
        # fleet identity is configured — N samplers exporting the same
        # backlog gauges to one scrape plane stay distinguishable
        rl = metrics.replica_labels()

        jobs = self.ds.run_tx(lambda tx: tx.count_jobs_by_state(), "health_jobs_by_state")
        # zero-fill the known states so a drained backlog decays to 0
        # instead of freezing at its last nonzero sample
        for state in AggregationJobState:
            jobs.setdefault(("aggregation", state.value), 0)
        for state in CollectionJobState:
            jobs.setdefault(("collection", state.value), 0)
        for (typ, state), count in sorted(jobs.items()):
            metrics.jobs_gauge.set(float(count), type=typ, state=state, **rl)

        leases = self.ds.run_tx(
            lambda tx: tx.get_held_lease_expiries(), "health_held_leases"
        )
        live_keys = set()
        max_age = 0
        for typ, task_id, job_id, _expiry in leases:
            key = (typ, bytes(task_id), bytes(job_id))
            live_keys.add(key)
            first = self._lease_first_seen.setdefault(key, now)
            max_age = max(max_age, now - first)
        # drop released/expired leases so a re-acquired job starts fresh
        for key in list(self._lease_first_seen):
            if key not in live_keys:
                del self._lease_first_seen[key]
        metrics.job_lease_age_seconds.set(float(max_age), **rl)

        # one scan feeds BOTH the oldest-age gauge (exact min) and the
        # freshness DISTRIBUTION — per-task p50/p95/p99 unaggregated
        # ages (a single stuck report and a systemically lagging task
        # look identical on the min alone)
        quants = self.ds.run_tx(
            lambda tx: tx.unaggregated_report_time_quantiles_by_task(),
            "health_freshness_quantiles",
        )
        seen_tasks = set()
        lag_by_task = {}
        freshness = {}
        for task_id, count, min_time, vals in quants:
            label = _b64_task_id(bytes(task_id))
            seen_tasks.add(label)
            age = float(max(0, now - min_time))
            lag_by_task[label] = age
            metrics.oldest_unaggregated_report_age_seconds.set(age, task_id=label, **rl)
            per_task = {"count": count}
            for q, t in vals.items():
                qlabel = f"p{round(q * 100):d}"
                qage = float(max(0, now - t))
                per_task[qlabel] = qage
                metrics.unaggregated_report_age_quantiles.set(
                    qage, task_id=label, quantile=qlabel, **rl
                )
            freshness[label] = per_task
        for label in self._lag_tasks - seen_tasks:
            metrics.oldest_unaggregated_report_age_seconds.set(0.0, task_id=label, **rl)
        for label in self._quantile_tasks - seen_tasks:
            for qlabel in ("p50", "p95", "p99"):
                metrics.unaggregated_report_age_quantiles.set(
                    0.0, task_id=label, quantile=qlabel, **rl
                )
        self._lag_tasks = seen_tasks
        self._quantile_tasks = seen_tasks

        pending = self.ds.run_tx(
            lambda tx: tx.count_batches_pending_collection(), "health_batches_pending"
        )
        metrics.batches_pending_collection.set(float(pending), **rl)

        # long-horizon state the flight recorder trends: per-table row
        # counts (flat under load + GC is the endurance gate), on-disk
        # artifact bytes, and a GC-lag refresh between GC passes
        table_rows = self.ds.run_tx(
            lambda tx: tx.count_table_rows(), "health_table_rows"
        )
        for table, count in sorted(table_rows.items()):
            metrics.datastore_table_rows.set(float(count), table=table, **rl)
        artifact_bytes = {}
        for label, path in sorted(self.artifact_paths.items()):
            size = _path_bytes(path)
            artifact_bytes[label] = size
            metrics.artifact_bytes.set(float(size), artifact=label, **rl)
        if self.gc is not None:
            self.gc.observe_lag()
        if self.ledger is not None:
            # evaluate_once never raises (errors keep the previous
            # balance document and count as outcome="error")
            self.ledger.evaluate_once()

        self.last_snapshot = {
            "sampled_at_clock_seconds": now,
            "jobs": {f"{typ}/{state}": n for (typ, state), n in sorted(jobs.items())},
            "outstanding_leases": len(leases),
            "max_lease_age_seconds": max_age,
            "oldest_unaggregated_report_age_seconds": lag_by_task,
            "unaggregated_report_age_quantiles": freshness,
            "batches_pending_collection": pending,
            "datastore_table_rows": table_rows,
            "artifact_bytes": artifact_bytes,
            "interval_s": self.interval_s,
        }
        return self.last_snapshot

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        # first pass immediately: a scrape right after boot (exactly
        # when ops check a restarted aggregator) must not see an empty
        # job_health section for a whole interval
        while True:
            try:
                self.run_once()
            except Exception:
                # sampling must never take the process down, and a
                # transiently unreachable database just skips a sample
                log.exception("health sampling pass failed")
            if self._stop.wait(self.interval_s):
                return

    def start(self) -> "HealthSampler":
        self._thread = threading.Thread(
            target=self._loop, name="health-sampler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
