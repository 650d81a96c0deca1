"""Aggregation job creator (leader only).

Equivalent of reference aggregator/src/aggregator/aggregation_job_creator.rs:
44-705: sweep every leader task, pack unaggregated client reports into
aggregation jobs of [min, max] size, and create the job and its
report-aggregation rows. Fixed-size tasks also assign reports to
outstanding batches (BatchCreator, batch_creator.rs:32).

The port's own copy of janus_tpu/aggregator/aggregation_job_creator.py
for both query types, with the fleet shard filter (`fleet=`,
`_shard_filter`): a creator replica sweeps its own shard's tasks every
pass and steals a foreign task only once its backlog has sat nonempty
with no owner progress for steal_after_secs. Each job's trace is rooted
in its `creator.create_job` span: the row's `trace_context` is that
span's traceparent, which the drivers adopt on every step and the helper
through the propagated header.
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
from ..datastore.store import Datastore, job_shard_key
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
from ..trace import current_traceparent, span


@dataclass
class AggregationJobCreatorConfig:
    """reference aggregation_job_creator.rs:65-80."""

    min_aggregation_job_size: int = 1
    max_aggregation_job_size: int = 1024
    # worker threads for the per-task sweep; 1 = serial
    max_concurrent_tasks: int = 8


class AggregationJobCreator:
    def __init__(self, ds: Datastore, cfg: AggregationJobCreatorConfig | None = None, fleet=None):
        self.ds = ds
        self.cfg = cfg or AggregationJobCreatorConfig()
        # the fleet shard preference (config.FleetConfig): a replica sweeps
        # its own shard's tasks every pass, and a foreign shard's task only
        # once its unaggregated backlog has sat nonempty for
        # steal_after_secs with no owner progress, so replicas stay off
        # each other's tasks while a dead replica's tasks still get jobs.
        # Report claims are atomic either way: sharding is a contention
        # predicate, never a correctness one.
        self.fleet = fleet
        if fleet is not None:
            fleet.install_identity()
        # foreign-task steal timers: task_id -> (clock seconds when this
        # replica opened the no-progress window, the task's aggregated
        # count then, the last probe's time). A report's client_time is
        # truncated to the task's time_precision, so it cannot measure how
        # long work has waited; this replica's own clock can. The window
        # restarts when the owner makes progress (the aggregated count
        # moved): under steady traffic the backlog is never seen empty.
        self._foreign_backlog_first_seen: dict[bytes, tuple[int, int, int]] = {}
        # the lag scan runs at steal_after cadence, not every sweep: the
        # steal cannot fire sooner
        self._next_lag_scan = 0.0
        # tasks this replica is stealing: swept every pass until their
        # backlog drains (the stealer's own job creation would otherwise
        # read as owner progress and restart the window)
        self._stealing: set[bytes] = set()

    def _shard_filter(self, tasks: list[Task]) -> list[Task]:
        """The tasks this pass sweeps: every own-shard task (the task's
        shard is job_shard_key(task_id, b"")), every task being stolen, and
        a foreign task whose backlog has been nonempty with a static
        aggregated count for steal_after_secs. The lag scan and the
        progress probe run at steal_after cadence, so a steal is seen at
        most 2 x steal_after after the backlog appeared; a failed scan
        sweeps only what is already this replica's."""
        fleet = self.fleet
        if fleet is None or fleet.shard_count <= 1 or not tasks:
            return tasks
        count = int(fleet.shard_count)
        index = int(fleet.shard_index) % count
        own, foreign = [], []
        for t in tasks:
            (own if job_shard_key(t.task_id.data, b"") % count == index else foreign).append(t)
        if not foreign:
            return own
        now = self.ds.clock.now().seconds
        steal_after = max(0.0, float(fleet.steal_after_secs))
        own.extend(t for t in foreign if t.task_id.data in self._stealing)
        if now < self._next_lag_scan:
            return own
        self._next_lag_scan = now + steal_after
        try:
            backlog_tasks = {
                task_id
                for task_id, _ in self.ds.run_tx(
                    lambda tx: tx.min_unaggregated_report_time_by_task(), "creator_lag_scan"
                )
            }
        except Exception:
            return own
        candidates = [t for t in foreign if t.task_id.data in backlog_tasks]
        due = [
            t
            for t in candidates
            if t.task_id.data not in self._foreign_backlog_first_seen
            or now - self._foreign_backlog_first_seen[t.task_id.data][2] >= steal_after
        ]
        try:
            aggregated = (
                self.ds.run_tx(
                    lambda tx: {t.task_id.data: tx.count_client_reports_for_task(t.task_id)[1] for t in due},
                    "creator_progress_scan",
                )
                if due
                else {}
            )
        except Exception:
            return own
        live: set[bytes] = set()
        for t in candidates:
            key = t.task_id.data
            live.add(key)
            if key in self._stealing or key not in aggregated:
                continue  # swept above, or its probe is not due yet
            agg = int(aggregated[key])
            first, last_agg, _ = self._foreign_backlog_first_seen.setdefault(key, (now, agg, now))
            if agg != last_agg:
                # the owner moved the count: it is alive, restart the window
                self._foreign_backlog_first_seen[key] = (now, agg, now)
            else:
                self._foreign_backlog_first_seen[key] = (first, last_agg, now)
                if now - first >= steal_after:
                    # steal, and stay on it until the backlog drains
                    self._stealing.add(key)
                    del self._foreign_backlog_first_seen[key]
                    own.append(t)
        # prune the tasks no longer foreign with a backlog (drained,
        # deleted, reassigned): a stale entry would hand a re-created task
        # id an ancient first-seen
        for key in list(self._foreign_backlog_first_seen):
            if key not in live:
                del self._foreign_backlog_first_seen[key]
        self._stealing &= live
        return own

    def run_once(self) -> int:
        """Sweep the leader tasks of this replica's shard (all of them when
        unsharded) once; returns the number of jobs created. Tasks sweep
        concurrently in a thread pool."""
        tasks = self.ds.run_tx(lambda tx: tx.get_tasks(), "creator_tasks")
        eligible = self._shard_filter(
            [
                t
                for t in tasks
                if t.role == Role.LEADER
                # parameterized VDAFs (Poplar1) get their jobs from the
                # collection job driver
                and not t.vdaf.has_aggregation_parameter
            ]
        )
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
        # the job's trace is rooted here: the creating span's context is
        # persisted in the row, so the leader driver (every step, every
        # restart) and the helper (through the propagated traceparent)
        # attach their spans under one trace id per job
        with span("creator.create_job", reports=len(claimed)):
            tx.put_aggregation_job(
                AggregationJobModel(
                    task.task_id,
                    job_id,
                    b"",
                    pbs.to_bytes(),
                    Interval(Time(min(times)), Duration(max(times) - min(times) + 1)),
                    AggregationJobState.IN_PROGRESS,
                    0,
                    trace_context=current_traceparent(),
                )
            )
            for i, (rid, t) in enumerate(claimed):
                tx.put_report_aggregation(
                    ReportAggregationModel(
                        task.task_id, job_id, rid, t, i, ReportAggregationState.START
                    )
                )
