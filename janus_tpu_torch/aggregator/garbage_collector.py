"""Expired-artifact garbage collection.

Equivalent of reference aggregator/src/aggregator/garbage_collector.rs:9-75:
per task, delete expired client reports, aggregation artifacts and
collection artifacts in one transaction, bounded per pass by row
limits. Expiry cutoffs come from the task's report_expiry_age; tasks
without one are skipped (nothing ever expires).

The port's own copy of janus_tpu/aggregator/garbage_collector.py, with
the same limits and return dicts. Left out: its metrics (passes, rows
deleted, lag) and the conservation ledger's task counters it books in
the same transaction.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

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

    def run_once(self) -> dict[str, int]:
        """One GC pass over every task; returns rows deleted by kind."""
        totals = {"reports": 0, "aggregation": 0, "collection": 0}
        tasks = self.ds.run_tx(lambda tx: tx.get_tasks(), "gc_list_tasks")
        for task in tasks:
            if task.report_expiry_age is None:
                continue
            for k, v in self.gc_task(task).items():
                totals[k] += v
        return totals

    def gc_task(self, task) -> dict[str, int]:
        cutoff = self.clock.now().sub(task.report_expiry_age)
        cfg = self.cfg

        def tx_fn(tx):
            return {
                "reports": tx.delete_expired_client_reports(task.task_id, cutoff, cfg.report_limit),
                "aggregation": tx.delete_expired_aggregation_artifacts(task.task_id, cutoff, cfg.aggregation_limit),
                "collection": tx.delete_expired_collection_artifacts(task.task_id, cutoff, cfg.collection_limit),
            }

        deleted = self.ds.run_tx(tx_fn, "gc_task")
        if any(deleted.values()):
            log.info("gc task %s: deleted %s", task.task_id, deleted)
        return deleted
