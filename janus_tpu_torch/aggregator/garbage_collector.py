"""Expired-artifact garbage collection.

Equivalent of reference aggregator/src/aggregator/garbage_collector.rs:9-75:
per task, delete expired client reports, aggregation artifacts and
collection artifacts in one transaction each, bounded per pass by row
limits. Expiry cutoffs come from the task's report_expiry_age; tasks
without one are skipped (nothing ever expires).

The port's own copy of janus_tpu/aggregator/garbage_collector.py, with
the same limits, return dicts, metrics and conservation-ledger booking
(`expired`, `expired_param`, `expired_reclaimed`, in the transaction of
the deletes).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from .. import metrics
from ..datastore.store import Datastore

log = logging.getLogger(__name__)


@dataclass
class GarbageCollectorConfig:
    """reference garbage_collector.rs limits."""

    report_limit: int = 5000
    aggregation_limit: int = 10000
    collection_limit: int = 50


class GarbageCollector:
    def __init__(self, ds: Datastore, clock, cfg: GarbageCollectorConfig | None = None):
        self.ds = ds
        self.clock = clock
        self.cfg = cfg or GarbageCollectorConfig()
        self._last_pass_unix: float | None = None
        metrics.gc_lag_seconds.set(-1.0)

    def run_once(self) -> dict[str, int]:
        """One GC pass over every task; returns rows deleted by kind.
        Progress is exported for the flight recorder's endurance gates:
        janus_gc_deleted_rows_total{kind} and janus_gc_tasks_scanned_
        total rise with the work, janus_gc_lag_seconds tracks the age
        of the last COMPLETED pass (a growing lag with GC configured on
        means passes are stuck or erroring)."""
        totals = {"reports": 0, "aggregation": 0, "collection": 0}
        try:
            tasks = self.ds.run_tx(lambda tx: tx.get_tasks(), "gc_list_tasks")
            for task in tasks:
                if task.report_expiry_age is None:
                    continue
                metrics.gc_tasks_scanned_total.add()
                deleted = self.gc_task(task)
                for k, v in deleted.items():
                    totals[k] += v
        except Exception:
            metrics.gc_runs_total.add(outcome="error")
            if self._last_pass_unix is not None:
                metrics.gc_lag_seconds.set(time.time() - self._last_pass_unix)
            raise
        for k, v in totals.items():
            if v:
                metrics.gc_deleted_rows_total.add(v, kind=k)
        metrics.gc_runs_total.add(outcome="ok")
        self._last_pass_unix = time.time()
        metrics.gc_lag_seconds.set(0.0)
        return totals

    def observe_lag(self) -> float:
        """Refresh + return janus_gc_lag_seconds (the health sampler
        calls this between passes so the gauge moves even when the GC
        loop is wedged and never reaches run_once's own update)."""
        if self._last_pass_unix is None:
            return -1.0
        lag = time.time() - self._last_pass_unix
        metrics.gc_lag_seconds.set(lag)
        return lag

    def gc_task(self, task) -> dict[str, int]:
        cutoff = self.clock.now().sub(task.report_expiry_age)
        cfg = self.cfg

        def tx_fn(tx):
            unclaimed, claimed = tx.delete_expired_client_reports(
                task.task_id, cutoff, cfg.report_limit
            )
            jobs, pending_ras, pending_param_ras = tx.delete_expired_aggregation_artifacts(
                task.task_id, cutoff, cfg.aggregation_limit
            )
            collection = tx.delete_expired_collection_artifacts(
                task.task_id, cutoff, cfg.collection_limit
            )
            # conservation ledger attribution, in the SAME tx as the
            # deletes (exactly-once under run_tx retries): an expired
            # never-claimed report leaves the pending pool for the
            # `expired` terminal, and so does a claimed report whose
            # report_aggregations row died non-terminal with its
            # expired job (abandoned jobs' released START rows excluded
            # — their reports resolve through the unclaimed pool).
            # Param-fanout rows book their own lane (`expired_param`):
            # they debited `admitted_param`, never `admitted`. Claimed
            # rows whose RA already resolved were booked aggregated/
            # rejected at resolution — deleting their storage is not a
            # lifecycle event, only `expired_reclaimed` bookkeeping for
            # /debug/ledger.
            tx.increment_task_counters(
                task.task_id,
                {
                    "expired": unclaimed + pending_ras,
                    "expired_param": pending_param_ras,
                    "expired_reclaimed": claimed,
                },
            )
            return {
                "reports": unclaimed + claimed,
                "aggregation": jobs,
                "collection": collection,
            }

        deleted = self.ds.run_tx(tx_fn, "gc_task")
        if any(deleted.values()):
            log.info("gc task %s: deleted %s", task.task_id, deleted)
        return deleted
