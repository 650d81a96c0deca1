"""DAP-07 wire messages with TLS-syntax encoding.

Python equivalent of the reference's `messages` crate
(messages/src/lib.rs:58-2850): every DAP struct with byte-exact
TLS-syntax Encode/Decode, the TimeInterval/FixedSize query-type
abstraction (messages/src/lib.rs:1929-2040), and the DAP problem-type
registry (messages/src/problem_type.rs:5-47).

The hot path never touches these Python codecs per report — report
batches are decoded column-wise into arrays by the aggregator layer —
but protocol conformance (byte-exact round-trips) is defined here and
locked by tests/test_messages.py.

The port's own copy of janus_tpu/messages/__init__.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu.
"""

from .codec import Decoder, Encoder, DecodeError
from .core import (
    AggregateShare,
    AggregateShareAad,
    AggregateShareReq,
    AggregationJobContinueReq,
    AggregationJobId,
    AggregationJobInitializeReq,
    AggregationJobResp,
    AggregationJobStep,
    BatchId,
    BatchSelector,
    Collection,
    CollectionJobId,
    CollectionReq,
    Duration,
    Extension,
    ExtensionType,
    FixedSize,
    FixedSizeQuery,
    HpkeAeadId,
    HpkeCiphertext,
    HpkeConfig,
    HpkeConfigId,
    HpkeConfigList,
    HpkeKdfId,
    HpkeKemId,
    InputShareAad,
    Interval,
    PartialBatchSelector,
    PlaintextInputShare,
    PreEncoded,
    PrepareContinue,
    PrepareError,
    PrepareInit,
    PrepareResp,
    PrepareRespColumn,
    PrepareStepResult,
    Query,
    Report,
    ReportColumn,
    ReportId,
    ReportIdChecksum,
    ReportMetadata,
    ReportShare,
    Role,
    TaskId,
    Time,
    TimeInterval,
    QUERY_TYPES,
    decode_prepare_resps_fast,
    decode_reports_fast,
    encode_report_share_raw,
    plaintext_input_share_payload_fast,
)
from .problem_type import DapProblemType

__all__ = [n for n in dir() if not n.startswith("_")]
