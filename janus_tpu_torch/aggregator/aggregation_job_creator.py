"""Aggregation job creator (leader only).

Equivalent of reference aggregator/src/aggregator/aggregation_job_creator.rs:
44-705: sweep every leader task, pack unaggregated client reports into
aggregation jobs of [min, max] size, and create the job and its
report-aggregation rows.

The port's own copy of janus_tpu/aggregator/aggregation_job_creator.py
for time-interval tasks. Not ported yet: fixed-size tasks (the batch
packing of `_create_fixed_size_jobs` and the outstanding-batch ops it
needs), for which `create_jobs_for_task` raises; the fleet shard filter
and its steal timers; and the `creator.create_job` span, so the job's
`trace_context` is stored as None.
"""

from __future__ import annotations

import secrets
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..datastore.models import (
    AggregationJobModel,
    AggregationJobState,
    ReportAggregationModel,
    ReportAggregationState,
)
from ..datastore.store import Datastore
from ..messages import (
    AggregationJobId,
    Duration,
    Interval,
    PartialBatchSelector,
    Role,
    Time,
    TimeInterval,
)
from ..task import Task
from .errors import NotPorted


@dataclass
class AggregationJobCreatorConfig:
    """reference aggregation_job_creator.rs:65-80."""

    min_aggregation_job_size: int = 1
    max_aggregation_job_size: int = 1024
    # worker threads for the per-task sweep; 1 = serial
    max_concurrent_tasks: int = 8


class AggregationJobCreator:
    def __init__(self, ds: Datastore, cfg: AggregationJobCreatorConfig | None = None):
        self.ds = ds
        self.cfg = cfg or AggregationJobCreatorConfig()

    def run_once(self) -> int:
        """Sweep all leader tasks once; returns the number of jobs created.
        Tasks sweep concurrently in a thread pool."""
        tasks = self.ds.run_tx(lambda tx: tx.get_tasks(), "creator_tasks")
        eligible = [
            t
            for t in tasks
            if t.role == Role.LEADER
            # parameterized VDAFs (Poplar1) get their jobs from the
            # collection job driver
            and not t.vdaf.has_aggregation_parameter
        ]
        if len(eligible) <= 1 or self.cfg.max_concurrent_tasks <= 1:
            return sum(self.create_jobs_for_task(t) for t in eligible)
        workers = min(self.cfg.max_concurrent_tasks, len(eligible))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return sum(pool.map(self.create_jobs_for_task, eligible))

    def create_jobs_for_task(self, task: Task) -> int:
        if task.query_type.code == TimeInterval.CODE:
            return self._create_time_interval_jobs(task)
        return self._create_fixed_size_jobs(task)

    def _claim(self, task: Task):
        return self.ds.run_tx(
            lambda tx: tx.get_unaggregated_client_reports_for_task(
                task.task_id, self.cfg.max_aggregation_job_size
            ),
            "creator_claim",
        )

    def _create_time_interval_jobs(self, task: Task) -> int:
        """reference create_aggregation_jobs_for_time_interval_task_no_param
        (:511)."""
        created = 0
        while True:
            claimed = self._claim(task)
            if len(claimed) < max(1, self.cfg.min_aggregation_job_size):
                # too few: release the claim, try next sweep
                if claimed:
                    self.ds.run_tx(
                        lambda tx: tx.mark_reports_unaggregated(
                            task.task_id, [r for r, _ in claimed]
                        ),
                        "creator_release",
                    )
                return created
            self._write_job(task, claimed, PartialBatchSelector.time_interval())
            created += 1
            if len(claimed) < self.cfg.max_aggregation_job_size:
                return created

    def _create_fixed_size_jobs(self, task: Task) -> int:
        raise NotPorted(
            "fixed-size aggregation job creation (batch packing into outstanding"
            " batches) is not ported to janus_tpu_torch yet"
        )

    def _write_job(self, task: Task, claimed, pbs: PartialBatchSelector) -> None:
        self.ds.run_tx(
            lambda tx: self._write_job_in_tx(tx, task, claimed, pbs), "creator_write_job"
        )

    def _write_job_in_tx(self, tx, task: Task, claimed, pbs: PartialBatchSelector) -> None:
        job_id = AggregationJobId(secrets.token_bytes(16))
        times = [t.seconds for _, t in claimed]
        tx.put_aggregation_job(
            AggregationJobModel(
                task.task_id,
                job_id,
                b"",
                pbs.to_bytes(),
                Interval(Time(min(times)), Duration(max(times) - min(times) + 1)),
                AggregationJobState.IN_PROGRESS,
                0,
            )
        )
        for i, (rid, t) in enumerate(claimed):
            tx.put_report_aggregation(
                ReportAggregationModel(
                    task.task_id, job_id, rid, t, i, ReportAggregationState.START
                )
            )
