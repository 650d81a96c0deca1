"""DAP problem-details types (urn:ietf:params:ppm:dap:error:*).

Equivalent of reference messages/src/problem_type.rs:5-47 — the 15
RFC 7807 problem types DAP defines, plus helpers to build a
problem-details JSON document.

The port's own copy of janus_tpu/messages/problem_type.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu.
"""

from __future__ import annotations

import enum

_PREFIX = "urn:ietf:params:ppm:dap:error:"


class DapProblemType(enum.Enum):
    INVALID_MESSAGE = "invalidMessage"
    UNRECOGNIZED_TASK = "unrecognizedTask"
    MISSING_TASK_ID = "missingTaskID"
    UNRECOGNIZED_AGGREGATION_JOB = "unrecognizedAggregationJob"
    OUTDATED_CONFIG = "outdatedConfig"
    REPORT_REJECTED = "reportRejected"
    REPORT_TOO_EARLY = "reportTooEarly"
    BATCH_INVALID = "batchInvalid"
    INVALID_BATCH_SIZE = "invalidBatchSize"
    BATCH_QUERY_COUNT_EXCEEDED = "batchQueryCountExceeded"
    BATCH_MISMATCH = "batchMismatch"
    UNAUTHORIZED_REQUEST = "unauthorizedRequest"
    BATCH_OVERLAP = "batchOverlap"
    STEP_MISMATCH = "stepMismatch"
    UNRECOGNIZED_COLLECTION_JOB = "unrecognizedCollectionJob"
    INVALID_TASK = "invalidTask"  # taskprov opt-out

    @property
    def type_uri(self) -> str:
        return _PREFIX + self.value

    @classmethod
    def from_uri(cls, uri: str) -> "DapProblemType":
        if not uri.startswith(_PREFIX):
            raise ValueError(f"not a DAP problem type: {uri}")
        return cls(uri[len(_PREFIX) :])

    def http_status(self) -> int:
        return 400

    def document(self, task_id: str | None = None, detail: str | None = None) -> dict:
        """RFC 7807 problem-details body as the reference emits
        (aggregator/src/aggregator/problem_details.rs)."""
        doc = {
            "type": self.type_uri,
            "title": self.value,
            "status": self.http_status(),
        }
        if task_id is not None:
            doc["taskid"] = task_id
        if detail is not None:
            doc["detail"] = detail
        return doc
