"""Datastore row models.

Equivalent of reference aggregator_core/src/datastore/models.rs
(AggregationJob:220, ReportAggregation:586 + state:714,
BatchAggregation:843 + state:1042, CollectionJob:1055 + state:1182,
AggregateShareJob:1287).

The port's own copy of the models of janus_tpu/datastore/models.py that
the helper's aggregate-init and aggregate-share paths, the leader's
aggregation job creator and driver and its collection path use, line for
line: the job, report and batch aggregation rows, the collection job and
the aggregate-share job, the leader's stored report, the fixed-size
batch rows (`Batch`, `OutstandingBatch`), and the lease types
(`ShardSpec`, `Lease`, `AcquiredAggregationJob`,
`AcquiredCollectionJob`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace

from ..messages import (
    AggregationJobId,
    BatchId,
    CollectionJobId,
    HpkeCiphertext,
    Interval,
    PrepareError,
    ReportId,
    ReportIdChecksum,
    TaskId,
    Time,
)


class AggregationJobState(str, enum.Enum):
    """reference models.rs:374."""

    IN_PROGRESS = "in_progress"
    FINISHED = "finished"
    ABANDONED = "abandoned"
    DELETED = "deleted"


class ReportAggregationState(str, enum.Enum):
    """reference models.rs:714: Start / WaitingLeader(transition) /
    WaitingHelper(prep state) / Finished / Failed(error)."""

    START = "start"
    WAITING_LEADER = "waiting_leader"
    WAITING_HELPER = "waiting_helper"
    FINISHED = "finished"
    FAILED = "failed"


class BatchAggregationState(str, enum.Enum):
    """reference models.rs:1042."""

    AGGREGATING = "aggregating"
    COLLECTED = "collected"


class CollectionJobState(str, enum.Enum):
    """reference models.rs:1182."""

    START = "start"
    COLLECTABLE = "collectable"
    FINISHED = "finished"
    DELETED = "deleted"
    ABANDONED = "abandoned"


class BatchState(str, enum.Enum):
    """reference models.rs:1456."""

    OPEN = "open"
    CLOSING = "closing"
    CLOSED = "closed"


@dataclass(frozen=True)
class LeaderStoredReport:
    """A decrypted report at rest on the leader (reference models.rs:78)."""

    task_id: TaskId
    report_id: ReportId
    client_time: Time
    public_share: bytes
    leader_input_share: bytes  # decoded leader share, encrypted at rest
    helper_encrypted_input_share: HpkeCiphertext


@dataclass(frozen=True)
class AggregationJobModel:
    """reference models.rs:220."""

    task_id: TaskId
    job_id: AggregationJobId
    aggregation_parameter: bytes
    partial_batch_identifier: bytes  # encoded PartialBatchSelector body ('' for time-interval)
    client_timestamp_interval: Interval
    state: AggregationJobState
    step: int
    last_request_hash: bytes | None = None
    # W3C traceparent persisted by whoever created the job (the leader's
    # job creator / the helper's init handler); both job drivers adopt it
    # so a step's spans join the creating trace across processes and
    # driver restarts (janus_tpu.trace.use_traceparent)
    trace_context: str | None = None

    def with_state(self, state: AggregationJobState) -> "AggregationJobModel":
        return replace(self, state=state)


@dataclass(frozen=True)
class ShardSpec:
    """Fleet shard predicate for the batched lease claims: a replica owns
    the jobs whose persisted shard_key lands on its (shard_index mod
    shard_count); jobs outside the shard become claimable only after
    they have sat eligible for steal_after_s."""

    shard_count: int = 1
    shard_index: int = 0
    steal_after_s: int = 30

    @property
    def active(self) -> bool:
        return self.shard_count > 1


@dataclass(frozen=True)
class Lease:
    """An acquired job lease (reference models.rs:434)."""

    token: bytes
    expiry: Time
    attempts: int


@dataclass(frozen=True)
class AcquiredAggregationJob:
    """reference models.rs:494. shard_key is the row's stored shard hash
    at claim time (< 0: the affinity was released by a hand-back)."""

    task_id: TaskId
    job_id: AggregationJobId
    lease: Lease
    shard_key: int | None = None


@dataclass(frozen=True)
class AcquiredCollectionJob:
    """reference models.rs:540 (shard_key: see AcquiredAggregationJob)."""

    task_id: TaskId
    collection_job_id: CollectionJobId
    lease: Lease
    shard_key: int | None = None


@dataclass(frozen=True)
class ReportAggregationModel:
    """reference models.rs:586.

    prep_blob holds the serialized per-report prepare payload for the
    waiting states: the leader's transition (out share + verifier
    context) or the helper's prepare state; opaque at this layer and
    encrypted at rest.
    """

    task_id: TaskId
    job_id: AggregationJobId
    report_id: ReportId
    client_time: Time
    ord: int
    state: ReportAggregationState
    prep_blob: bytes = b""
    prepare_error: PrepareError | None = None

    def finished(self) -> "ReportAggregationModel":
        return replace(self, state=ReportAggregationState.FINISHED, prep_blob=b"")

    def failed(self, err: PrepareError) -> "ReportAggregationModel":
        return replace(
            self, state=ReportAggregationState.FAILED, prep_blob=b"", prepare_error=err
        )


@dataclass(frozen=True)
class BatchAggregation:
    """One shard of a batch's running aggregate (reference models.rs:843).

    Sharding exists to spread row contention (the reference picks a
    random shard 0..shard_count at accumulate time, accumulator.rs:92).
    """

    task_id: TaskId
    batch_identifier: bytes  # encoded Interval or BatchId
    aggregation_parameter: bytes
    ord: int
    state: BatchAggregationState
    aggregate_share: bytes | None  # encoded field vector, None for empty shard
    report_count: int
    client_timestamp_interval: Interval
    checksum: ReportIdChecksum


@dataclass(frozen=True)
class CollectionJobModel:
    """reference models.rs:1055."""

    task_id: TaskId
    collection_job_id: CollectionJobId
    query: bytes  # encoded Query
    aggregation_parameter: bytes
    batch_identifier: bytes
    state: CollectionJobState
    report_count: int | None = None
    client_timestamp_interval: Interval | None = None
    leader_aggregate_share: bytes | None = None  # encrypted at rest
    helper_encrypted_aggregate_share: bytes | None = None
    # W3C traceparent of the creating span in janus_tpu; the port, with
    # no spans, stores None
    trace_context: str | None = None


@dataclass(frozen=True)
class AggregateShareJob:
    """Helper-side record of a served aggregate share (reference models.rs:1287)."""

    task_id: TaskId
    batch_identifier: bytes
    aggregation_parameter: bytes
    helper_aggregate_share: bytes  # encoded field vector, encrypted at rest
    report_count: int
    checksum: ReportIdChecksum


@dataclass(frozen=True)
class Batch:
    """reference models.rs:1473."""

    task_id: TaskId
    batch_identifier: bytes
    aggregation_parameter: bytes
    state: BatchState
    outstanding_aggregation_jobs: int
    client_timestamp_interval: Interval


@dataclass(frozen=True)
class OutstandingBatch:
    """A fixed-size batch being filled (reference models.rs:1412)."""

    task_id: TaskId
    batch_id: BatchId
    time_bucket_start: Time | None
    size: int = 0  # reports assigned so far (incl. in-flight)
