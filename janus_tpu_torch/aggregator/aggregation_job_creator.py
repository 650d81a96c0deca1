"""Aggregation job creator (leader only).

Equivalent of reference aggregator/src/aggregator/aggregation_job_creator.rs:
44-705: sweep every leader task, pack unaggregated client reports into
aggregation jobs of [min, max] size, and create the job and its
report-aggregation rows. Fixed-size tasks also assign reports to
outstanding batches (BatchCreator, batch_creator.rs:32).

The port's own copy of janus_tpu/aggregator/aggregation_job_creator.py
for both query types. Not ported yet: the fleet shard filter and its
steal timers; and the `creator.create_job` span, so the job's
`trace_context` is stored as None.
"""

from __future__ import annotations

import secrets
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from ..datastore.models import (
    AggregationJobModel,
    AggregationJobState,
    OutstandingBatch,
    ReportAggregationModel,
    ReportAggregationState,
)
from ..datastore.store import Datastore
from ..messages import (
    AggregationJobId,
    BatchId,
    Duration,
    Interval,
    PartialBatchSelector,
    Role,
    Time,
    TimeInterval,
)
from ..task import Task


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
        """Batch packing toward max_batch_size (reference
        batch_creator.rs:140-330): claimed reports top up the fullest
        unfilled outstanding batch of their time bucket first, spill into
        new batches, and a batch is marked filled exactly when its
        assigned size reaches max_batch_size."""
        created = 0
        max_bs = task.query_type.max_batch_size or self.cfg.max_aggregation_job_size
        min_job = max(1, self.cfg.min_aggregation_job_size)
        window = task.query_type.batch_time_window_size
        while True:
            claimed = self._claim(task)
            if len(claimed) < min_job:
                if claimed:
                    self.ds.run_tx(
                        lambda tx: tx.mark_reports_unaggregated(
                            task.task_id, [r for r, _ in claimed]
                        ),
                        "creator_release",
                    )
                return created

            by_bucket: dict = {}
            for rid, t in claimed:
                bucket = t.to_batch_interval_start(window) if window else None
                by_bucket.setdefault(bucket, []).append((rid, t))

            def assign_and_write(tx):
                """One transaction: the batch accounting and the job rows
                commit together (a crash between them would corrupt the
                outstanding-batch sizes and orphan claimed reports)."""
                n_jobs = 0
                for bucket, group in by_bucket.items():
                    remaining = list(group)
                    obs = tx.get_outstanding_batches(task.task_id, bucket)
                    while remaining:
                        if obs:
                            ob = obs.pop(0)
                            bid, size = ob.batch_id, ob.size
                        else:
                            bid, size = None, 0  # a new batch, created lazily
                        take = min(max_bs - size, len(remaining))
                        if take <= 0:
                            tx.mark_outstanding_batch_filled(task.task_id, bid)
                            continue
                        if take < min_job and size + take < max_bs:
                            # too small for a job and does not complete the
                            # batch: leave these reports for a later pass
                            tx.mark_reports_unaggregated(task.task_id, [r for r, _ in remaining])
                            break
                        if bid is None:
                            bid = BatchId(secrets.token_bytes(32))
                            tx.put_outstanding_batch(OutstandingBatch(task.task_id, bid, bucket))
                        chunk, remaining = remaining[:take], remaining[take:]
                        if tx.add_to_outstanding_batch(task.task_id, bid, take) >= max_bs:
                            tx.mark_outstanding_batch_filled(task.task_id, bid)
                        self._write_job_in_tx(tx, task, chunk, PartialBatchSelector.fixed_size(bid))
                        n_jobs += 1
                return n_jobs

            n_jobs = self.ds.run_tx(assign_and_write, "creator_fixed_assign")
            created += n_jobs
            if n_jobs == 0:
                # every bucket deferred (sub-minimum chunks): the same
                # reports would be claimed again forever; stop this pass
                return created
            if len(claimed) < self.cfg.max_aggregation_job_size:
                return created

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
