"""Accumulator: merge verified output shares into sharded batch rows.

Equivalent of reference aggregator/src/aggregator/accumulator.rs: an
in-memory map batch-identifier -> (aggregate share, report count,
checksum, client interval), flushed in the writing transaction to a
random shard row 0..shard_count (contention control; accumulator.rs:92)
with unique-violation converted into a retryable conflict
(accumulator.rs:173-199).

The per-batch share arrives as one already-reduced device vector per
(job, batch bucket): the device sums the reports (one masked aggregate
per bucket), so the host merges a handful of vectors per job.

The port's own copy of janus_tpu/aggregator/accumulator.py: Prio3's
batched path, and the per-report `update_single` of the continue step,
where a parameterized VDAF (Poplar1) accumulates in its level's field
and keys its batch rows by the aggregation parameter. The per-task
counters and the e2e histogram it feeds there are left out with the
rest of the metrics.
"""

from __future__ import annotations

import secrets

import numpy as np

from ..datastore.models import BatchAggregation, BatchAggregationState
from ..messages import FixedSize, Interval, ReportIdChecksum, Time
from ..task import Task
from ..vdaf.registry import circuit_for


def add_encoded_aggregate_shares(field, a: bytes | None, b: bytes | None) -> bytes | None:
    """Element-wise mod-p sum of two encoded field vectors."""
    if a is None:
        return b
    if b is None:
        return a
    va = field.decode_vec(a)
    vb = field.decode_vec(b)
    assert len(va) == len(vb)
    return field.encode_vec([field.add(x, y) for x, y in zip(va, vb)])


def fixed_size_batch_id(pbs) -> bytes | None:
    """BatchId bytes for a fixed-size PartialBatchSelector, else None
    (time-interval jobs bucket by time window)."""
    return pbs.batch_id.data if pbs.query_type == FixedSize.CODE else None


def group_batch_buckets(task, metadatas, accept, batch_identifier: bytes | None) -> dict[bytes, list[int]]:
    """Accepted lane indices grouped by batch identifier."""
    buckets: dict[bytes, list[int]] = {}
    for i, md in enumerate(metadatas):
        if not accept[i]:
            continue
        if batch_identifier is not None:
            bid = batch_identifier
        else:
            start = md.time.to_batch_interval_start(task.time_precision)
            bid = Interval(start, task.time_precision).to_bytes()
        buckets.setdefault(bid, []).append(i)
    return buckets


def bucket_metadata(task, metadatas, lanes):
    """(checksum, client interval) over one bucket's lanes."""
    checksum = ReportIdChecksum()
    lo = hi = None
    for i in lanes:
        checksum = checksum.updated_with(metadatas[i].report_id)
        t = metadatas[i].time
        lo = t if lo is None or t < lo else lo
        hi = t if hi is None or t > hi else hi
    interval = Interval(lo.to_batch_interval_start(task.time_precision), task.time_precision)
    return checksum, interval


def accumulate_batched(
    task, engine, accumulator: "Accumulator", out_shares, accept, metadatas, batch_identifier: bytes | None = None
) -> None:
    """Group accepted lanes by batch bucket; one masked device reduce per
    bucket (replaces the reference's per-report Accumulator::update loop,
    accumulator.rs:76-122). A time-interval job whose reports span two
    windows makes two masked aggregates over the same resident rows.

    `batch_identifier`: for fixed-size tasks, the job's BatchId bytes —
    every accepted lane lands in that one batch. None (time-interval
    tasks) buckets lanes by their time_precision window.
    """
    n = len(metadatas)
    if n == 0:
        return
    field = accumulator.field
    buckets = group_batch_buckets(task, metadatas, accept, batch_identifier)
    bucket_mask = np.zeros(n, dtype=bool)
    for bid, lanes in buckets.items():
        bucket_mask[lanes] = True
        share_ints = engine.aggregate(out_shares, bucket_mask)
        bucket_mask[lanes] = False
        checksum, interval = bucket_metadata(task, metadatas, lanes)
        accumulator.update(
            bid,
            field.encode_vec(share_ints),
            len(lanes),
            checksum,
            interval,
            [metadatas[i].report_id for i in lanes],
        )


class Accumulator:
    """reference accumulator.rs:32."""

    def __init__(self, task: Task, shard_count: int = 1, field=None, aggregation_parameter: bytes = b""):
        """field/aggregation_parameter: a parameterized VDAF (Poplar1)
        accumulates in its parameter's field and keys its batch rows by
        the parameter; Prio3 uses the circuit's field and b""."""
        self.task = task
        self.field = field if field is not None else circuit_for(task.vdaf).FIELD
        self.agg_param = aggregation_parameter
        self.shard_count = shard_count
        # batch_identifier bytes -> [share bytes | None, count, checksum, interval | None, report ids]
        self._state: dict[bytes, list] = {}

    def update(
        self,
        batch_identifier: bytes,
        aggregate_share: bytes | None,
        report_count: int,
        checksum: ReportIdChecksum,
        client_interval: Interval,
        report_ids: list | None = None,
    ) -> None:
        """Merge one already-reduced contribution (device output)."""
        ent = self._state.get(batch_identifier)
        if ent is None:
            self._state[batch_identifier] = [
                aggregate_share, report_count, checksum, client_interval, list(report_ids or ())
            ]
            return
        ent[0] = add_encoded_aggregate_shares(self.field, ent[0], aggregate_share)
        ent[1] += report_count
        ent[2] = ent[2].combined_with(checksum)
        ent[3] = Interval.merged(ent[3], client_interval)
        ent[4].extend(report_ids or ())

    def update_single(self, batch_identifier: bytes, out_share: list[int], report_id, client_time: Time) -> None:
        """Merge one report's output share (the continue step's finish)."""
        self.update(
            batch_identifier,
            self.field.encode_vec(out_share),
            1,
            ReportIdChecksum.for_report_id(report_id),
            Interval(client_time.to_batch_interval_start(self.task.time_precision), self.task.time_precision),
            [report_id],
        )

    def flush_to_datastore(self, tx) -> set:
        """Merge into a random shard row per batch (reference :133-215).

        Returns the report ids that could NOT be merged because their
        batch was already collected; callers mark those report
        aggregations failed with PrepareError.BATCH_COLLECTED instead of
        failing the whole job (reference accumulator.rs:133-215 returns
        the same unmergeable set).

        Does NOT consume the accumulator state: the surrounding
        transaction may be retried after a rollback (run_tx retry loop),
        and a retry must re-flush the same contributions.
        """
        unmerged: set = set()
        for batch_identifier, (share, count, checksum, interval, rids) in self._state.items():
            # a COLLECTED row in ANY shard closes the batch
            if tx.batch_has_collected_shard(self.task.task_id, batch_identifier, self.agg_param):
                unmerged.update(r.data for r in rids)
                continue
            ord_ = secrets.randbelow(self.shard_count)
            existing = tx.get_batch_aggregation(self.task.task_id, batch_identifier, self.agg_param, ord_)
            if existing is None:
                tx.put_batch_aggregation(
                    BatchAggregation(
                        self.task.task_id,
                        batch_identifier,
                        self.agg_param,
                        ord_,
                        BatchAggregationState.AGGREGATING,
                        share,
                        count,
                        interval,
                        checksum,
                    )
                )
                continue
            merged = BatchAggregation(
                self.task.task_id,
                batch_identifier,
                self.agg_param,
                ord_,
                existing.state,
                add_encoded_aggregate_shares(self.field, existing.aggregate_share, share),
                existing.report_count + count,
                Interval.merged(existing.client_timestamp_interval, interval),
                existing.checksum.combined_with(checksum),
            )
            tx.update_batch_aggregation(merged)
        return unmerged
