"""Aggregator error taxonomy -> DAP problem details.

Equivalent of reference aggregator/src/aggregator/error.rs +
problem_details.rs: typed errors that map to (HTTP status, problem
type) pairs at the HTTP boundary.

The port's own copy of janus_tpu/aggregator/errors.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu. It adds `NotPorted`, which a
port module raises where janus_tpu has a path the port does not have
yet.
"""

from __future__ import annotations

from ..messages.problem_type import DapProblemType


class AggregatorError(Exception):
    status = 500
    problem: DapProblemType | None = None

    def __init__(self, detail: str = "", task_id=None):
        super().__init__(detail)
        self.detail = detail
        self.task_id = task_id

    def problem_document(self) -> dict | None:
        if self.problem is None:
            return None
        tid = None
        if self.task_id is not None:
            import base64

            tid = base64.urlsafe_b64encode(self.task_id.data).decode().rstrip("=")
        return self.problem.document(task_id=tid, detail=self.detail or None)


class UnrecognizedTask(AggregatorError):
    status = 400
    problem = DapProblemType.UNRECOGNIZED_TASK


class UnrecognizedAggregationJob(AggregatorError):
    status = 400
    problem = DapProblemType.UNRECOGNIZED_AGGREGATION_JOB


class UnrecognizedCollectionJob(AggregatorError):
    status = 400
    problem = DapProblemType.UNRECOGNIZED_COLLECTION_JOB


class UnauthorizedRequest(AggregatorError):
    status = 400
    problem = DapProblemType.UNAUTHORIZED_REQUEST


class InvalidMessage(AggregatorError):
    status = 400
    problem = DapProblemType.INVALID_MESSAGE


class OutdatedHpkeConfig(AggregatorError):
    status = 400
    problem = DapProblemType.OUTDATED_CONFIG


class ReportRejected(AggregatorError):
    status = 400
    problem = DapProblemType.REPORT_REJECTED


class ReportTooEarly(AggregatorError):
    status = 400
    problem = DapProblemType.REPORT_TOO_EARLY


class BatchInvalid(AggregatorError):
    status = 400
    problem = DapProblemType.BATCH_INVALID


class InvalidBatchSize(AggregatorError):
    status = 400
    problem = DapProblemType.INVALID_BATCH_SIZE


class BatchQueryCountExceeded(AggregatorError):
    status = 400
    problem = DapProblemType.BATCH_QUERY_COUNT_EXCEEDED


class BatchMismatch(AggregatorError):
    status = 400
    problem = DapProblemType.BATCH_MISMATCH


class BatchOverlap(AggregatorError):
    status = 400
    problem = DapProblemType.BATCH_OVERLAP


class StepMismatch(AggregatorError):
    status = 400
    problem = DapProblemType.STEP_MISMATCH


class InvalidTask(AggregatorError):
    """taskprov opt-out (reference error.rs InvalidTask/OptOutReason)."""

    status = 400
    problem = DapProblemType.INVALID_TASK


class NotPorted(NotImplementedError):
    """A path janus_tpu has and janus_tpu_torch does not port yet (a
    fixed-size task's job creation, a continue step, Poplar1). Raised,
    never skipped: the caller learns the work was not done."""
