"""DAP-07 message structs (TLS syntax), byte layouts per draft-ietf-ppm-dap-07.

Each class mirrors one struct of the reference's messages crate; the
`file:line` in each docstring cites the reference definition
(messages/src/lib.rs unless noted). Wire layout follows the DAP-07
presentation-language definitions so that cross-implementation interop
(SURVEY.md section 2.9) stays possible.

The port's own copy of janus_tpu/messages/core.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu.
"""

from __future__ import annotations

import enum
import hashlib
import secrets
import struct
from dataclasses import dataclass, field

from .codec import (
    PP_CONTINUE,
    PP_FINISH,
    PP_INITIALIZE,
    Codec,
    DecodeError,
    Decoder,
    Encoder,
    check_pingpong_frame,
    decode_pingpong_frame,
)


def _fixed(name, size, *, doc=""):
    """Generate a fixed-length opaque byte newtype (TaskId, ReportId...)."""

    @dataclass(frozen=True)
    class Fixed(Codec):
        data: bytes

        SIZE = size

        def __post_init__(self):
            if len(self.data) != size:
                raise ValueError(f"{name} must be {size} bytes")

        def encode(self, enc: Encoder) -> None:
            enc.write(self.data)

        @classmethod
        def decode(cls, dec: Decoder):
            return cls(dec.take(size))

        @classmethod
        def random(cls):
            return cls(secrets.token_bytes(size))

        def __repr__(self):
            return f"{name}({self.data.hex()[:16]}…)"

    Fixed.__name__ = Fixed.__qualname__ = name
    Fixed.__doc__ = doc
    return Fixed


TaskId = _fixed("TaskId", 32, doc="reference messages/src/lib.rs:618")
BatchId = _fixed("BatchId", 32, doc="reference messages/src/lib.rs:273")
ReportId = _fixed("ReportId", 16, doc="reference messages/src/lib.rs:344")
AggregationJobId = _fixed("AggregationJobId", 16, doc="reference messages/src/lib.rs:2366")
CollectionJobId = _fixed("CollectionJobId", 16, doc="reference messages/src/lib.rs:1626")


@dataclass(frozen=True)
class ReportIdChecksum(Codec):
    """XOR-combined SHA-256 digests of report IDs.

    reference messages/src/lib.rs:426 + core/src/report_id.rs:7.
    """

    data: bytes = b"\x00" * 32

    SIZE = 32

    def __post_init__(self):
        if len(self.data) != 32:
            raise ValueError("checksum must be 32 bytes")

    def encode(self, enc: Encoder) -> None:
        enc.write(self.data)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(dec.take(32))

    @classmethod
    def for_report_id(cls, report_id: ReportId) -> "ReportIdChecksum":
        return cls(hashlib.sha256(report_id.data).digest())

    def updated_with(self, report_id: ReportId) -> "ReportIdChecksum":
        return self.combined_with(self.for_report_id(report_id))

    def combined_with(self, other: "ReportIdChecksum") -> "ReportIdChecksum":
        return ReportIdChecksum(bytes(a ^ b for a, b in zip(self.data, other.data)))


@dataclass(frozen=True, order=True)
class Duration(Codec):
    """Seconds; reference messages/src/lib.rs:128."""

    seconds: int

    def encode(self, enc: Encoder) -> None:
        enc.u64(self.seconds)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(dec.u64())


@dataclass(frozen=True, order=True)
class Time(Codec):
    """Seconds since UNIX epoch; reference messages/src/lib.rs:168."""

    seconds: int

    def encode(self, enc: Encoder) -> None:
        enc.u64(self.seconds)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(dec.u64())

    def to_batch_interval_start(self, time_precision: Duration) -> "Time":
        """Round down to a multiple of the task time precision
        (reference core/src/time.rs:177 TimeExt)."""
        p = time_precision.seconds
        return Time(self.seconds - self.seconds % p)

    def add(self, d: Duration) -> "Time":
        return Time(self.seconds + d.seconds)

    def sub(self, d: Duration) -> "Time":
        return Time(self.seconds - d.seconds)


@dataclass(frozen=True)
class Interval(Codec):
    """Half-open [start, start+duration); reference messages/src/lib.rs:210."""

    start: Time
    duration: Duration

    def __post_init__(self):
        # Match the reference's Interval::new overflow check
        # (messages/src/lib.rs:210): end must fit in u64.
        if self.start.seconds + self.duration.seconds > 0xFFFFFFFFFFFFFFFF:
            raise DecodeError("interval end overflows u64")

    def encode(self, enc: Encoder) -> None:
        self.start.encode(enc)
        self.duration.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(Time.decode(dec), Duration.decode(dec))

    @property
    def end(self) -> Time:
        return self.start.add(self.duration)

    def contains(self, t: Time) -> bool:
        return self.start <= t < self.end

    def aligned_to(self, time_precision: Duration) -> bool:
        p = time_precision.seconds
        return self.start.seconds % p == 0 and self.duration.seconds % p == 0

    @classmethod
    def merged(cls, a: "Interval", b: "Interval") -> "Interval":
        """Smallest interval covering both (reference core/src/time.rs:265)."""
        start = min(a.start, b.start)
        end = max(a.end, b.end)
        return cls(start, Duration(end.seconds - start.seconds))


class Role(enum.IntEnum):
    """reference messages/src/lib.rs:495."""

    COLLECTOR = 0
    CLIENT = 1
    LEADER = 2
    HELPER = 3

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.value)

    @classmethod
    def decode(cls, dec: Decoder):
        try:
            return cls(dec.u8())
        except ValueError as e:
            raise DecodeError(str(e))

    def to_bytes(self) -> bytes:  # shadow int.to_bytes for codec symmetry
        return bytes([self.value])

    @classmethod
    def from_bytes(cls, raw: bytes) -> "Role":
        dec = Decoder(raw)
        out = cls.decode(dec)
        dec.finish()
        return out


class HpkeKemId(enum.IntEnum):
    """RFC 9180 KEM registry; reference messages/src/lib.rs:747."""

    P256_HKDF_SHA256 = 0x0010
    X25519_HKDF_SHA256 = 0x0020


class HpkeKdfId(enum.IntEnum):
    HKDF_SHA256 = 0x0001
    HKDF_SHA384 = 0x0002
    HKDF_SHA512 = 0x0003


class HpkeAeadId(enum.IntEnum):
    AES_128_GCM = 0x0001
    AES_256_GCM = 0x0002
    CHACHA20POLY1305 = 0x0003


@dataclass(frozen=True)
class HpkeConfigId(Codec):
    """u8 config id; reference messages/src/lib.rs:835."""

    id: int

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.id)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(dec.u8())


class ExtensionType(enum.IntEnum):
    """reference messages/src/lib.rs:837."""

    TBD = 0
    TASKPROV = 0xFF00


@dataclass(frozen=True)
class Extension(Codec):
    """reference messages/src/lib.rs:837."""

    extension_type: int
    extension_data: bytes = b""

    def encode(self, enc: Encoder) -> None:
        enc.u16(self.extension_type)
        enc.opaque_u16(self.extension_data)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(dec.u16(), dec.opaque_u16())


@dataclass(frozen=True)
class HpkeCiphertext(Codec):
    """reference messages/src/lib.rs:915."""

    config_id: HpkeConfigId
    encapsulated_key: bytes
    payload: bytes

    def encode(self, enc: Encoder) -> None:
        self.config_id.encode(enc)
        enc.opaque_u16(self.encapsulated_key)
        enc.opaque_u32(self.payload)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(HpkeConfigId.decode(dec), dec.opaque_u16(), dec.opaque_u32())


@dataclass(frozen=True)
class HpkeConfig(Codec):
    """reference messages/src/lib.rs:1079."""

    id: HpkeConfigId
    kem_id: HpkeKemId
    kdf_id: HpkeKdfId
    aead_id: HpkeAeadId
    public_key: bytes

    def encode(self, enc: Encoder) -> None:
        self.id.encode(enc)
        enc.u16(self.kem_id)
        enc.u16(self.kdf_id)
        enc.u16(self.aead_id)
        enc.opaque_u16(self.public_key)

    @classmethod
    def decode(cls, dec: Decoder):
        cid = HpkeConfigId.decode(dec)
        algs = []
        for reg in (HpkeKemId, HpkeKdfId, HpkeAeadId):
            v = dec.u16()
            try:
                algs.append(reg(v))
            except ValueError:
                raise DecodeError(f"unsupported {reg.__name__} {v:#x}")
        return cls(cid, *algs, dec.opaque_u16())


@dataclass(frozen=True)
class HpkeConfigList(Codec):
    """reference messages/src/lib.rs:1171."""

    configs: tuple

    def encode(self, enc: Encoder) -> None:
        enc.items_u16(self.configs)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(tuple(dec.items_u16(HpkeConfig.decode)))


@dataclass(frozen=True)
class ReportMetadata(Codec):
    """reference messages/src/lib.rs:1209."""

    report_id: ReportId
    time: Time

    def encode(self, enc: Encoder) -> None:
        self.report_id.encode(enc)
        self.time.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(ReportId.decode(dec), Time.decode(dec))


@dataclass(frozen=True)
class PlaintextInputShare(Codec):
    """reference messages/src/lib.rs:1253."""

    extensions: tuple
    payload: bytes

    def encode(self, enc: Encoder) -> None:
        enc.items_u16(self.extensions)
        enc.opaque_u32(self.payload)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(tuple(dec.items_u16(Extension.decode)), dec.opaque_u32())


@dataclass(frozen=True)
class Report(Codec):
    """reference messages/src/lib.rs:1309."""

    metadata: ReportMetadata
    public_share: bytes
    leader_encrypted_input_share: HpkeCiphertext
    helper_encrypted_input_share: HpkeCiphertext

    MEDIA_TYPE = "application/dap-report"

    def encode(self, enc: Encoder) -> None:
        self.metadata.encode(enc)
        enc.opaque_u32(self.public_share)
        self.leader_encrypted_input_share.encode(enc)
        self.helper_encrypted_input_share.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(
            ReportMetadata.decode(dec),
            dec.opaque_u32(),
            HpkeCiphertext.decode(dec),
            HpkeCiphertext.decode(dec),
        )


# ---------------------------------------------------------------------------
# Query types (reference messages/src/lib.rs:1929-2040)
# ---------------------------------------------------------------------------


class TimeInterval:
    """Batch = an aligned time interval. reference messages/src/lib.rs:1993."""

    CODE = 1
    BatchIdentifier = Interval
    name = "time_interval"


class FixedSize:
    """Batch = a leader-assigned BatchId. reference messages/src/lib.rs:2012."""

    CODE = 2
    BatchIdentifier = BatchId
    name = "fixed_size"


QUERY_TYPES = {TimeInterval.CODE: TimeInterval, FixedSize.CODE: FixedSize}


@dataclass(frozen=True)
class FixedSizeQuery(Codec):
    """fixed-size query body: by_batch_id(0) | current_batch(1).

    reference messages/src/lib.rs:1435 (Query enum internals).
    """

    BY_BATCH_ID = 0
    CURRENT_BATCH = 1

    kind: int
    batch_id: BatchId | None = None

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.kind)
        if self.kind == self.BY_BATCH_ID:
            assert self.batch_id is not None
            self.batch_id.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        kind = dec.u8()
        if kind == cls.BY_BATCH_ID:
            return cls(kind, BatchId.decode(dec))
        if kind == cls.CURRENT_BATCH:
            return cls(kind)
        raise DecodeError(f"bad FixedSizeQuery kind {kind}")


@dataclass(frozen=True)
class Query(Codec):
    """reference messages/src/lib.rs:1435."""

    query_type: int
    batch_interval: Interval | None = None
    fixed_size_query: FixedSizeQuery | None = None

    @classmethod
    def time_interval(cls, interval: Interval) -> "Query":
        return cls(TimeInterval.CODE, batch_interval=interval)

    @classmethod
    def fixed_size(cls, fsq: FixedSizeQuery) -> "Query":
        return cls(FixedSize.CODE, fixed_size_query=fsq)

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.query_type)
        if self.query_type == TimeInterval.CODE:
            self.batch_interval.encode(enc)
        elif self.query_type == FixedSize.CODE:
            self.fixed_size_query.encode(enc)
        else:
            raise ValueError(f"bad query type {self.query_type}")

    @classmethod
    def decode(cls, dec: Decoder):
        qt = dec.u8()
        if qt == TimeInterval.CODE:
            return cls(qt, batch_interval=Interval.decode(dec))
        if qt == FixedSize.CODE:
            return cls(qt, fixed_size_query=FixedSizeQuery.decode(dec))
        raise DecodeError(f"bad query type {qt}")


@dataclass(frozen=True)
class CollectionReq(Codec):
    """reference messages/src/lib.rs:1507."""

    query: Query
    aggregation_parameter: bytes = b""

    MEDIA_TYPE = "application/dap-collect-req"

    def encode(self, enc: Encoder) -> None:
        self.query.encode(enc)
        enc.opaque_u32(self.aggregation_parameter)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(Query.decode(dec), dec.opaque_u32())


@dataclass(frozen=True)
class PartialBatchSelector(Codec):
    """reference messages/src/lib.rs:1562."""

    query_type: int
    batch_id: BatchId | None = None

    @classmethod
    def time_interval(cls) -> "PartialBatchSelector":
        return cls(TimeInterval.CODE)

    @classmethod
    def fixed_size(cls, batch_id: BatchId) -> "PartialBatchSelector":
        return cls(FixedSize.CODE, batch_id)

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.query_type)
        if self.query_type == FixedSize.CODE:
            self.batch_id.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        qt = dec.u8()
        if qt == TimeInterval.CODE:
            return cls(qt)
        if qt == FixedSize.CODE:
            return cls(qt, BatchId.decode(dec))
        raise DecodeError(f"bad query type {qt}")


@dataclass(frozen=True)
class BatchSelector(Codec):
    """reference messages/src/lib.rs:2661."""

    query_type: int
    batch_interval: Interval | None = None
    batch_id: BatchId | None = None

    @classmethod
    def time_interval(cls, interval: Interval) -> "BatchSelector":
        return cls(TimeInterval.CODE, batch_interval=interval)

    @classmethod
    def fixed_size(cls, batch_id: BatchId) -> "BatchSelector":
        return cls(FixedSize.CODE, batch_id=batch_id)

    @property
    def batch_identifier(self):
        return self.batch_interval if self.query_type == TimeInterval.CODE else self.batch_id

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.query_type)
        if self.query_type == TimeInterval.CODE:
            self.batch_interval.encode(enc)
        elif self.query_type == FixedSize.CODE:
            self.batch_id.encode(enc)
        else:
            raise ValueError(f"bad query type {self.query_type}")

    @classmethod
    def decode(cls, dec: Decoder):
        qt = dec.u8()
        if qt == TimeInterval.CODE:
            return cls(qt, batch_interval=Interval.decode(dec))
        if qt == FixedSize.CODE:
            return cls(qt, batch_id=BatchId.decode(dec))
        raise DecodeError(f"bad query type {qt}")


@dataclass(frozen=True)
class Collection(Codec):
    """reference messages/src/lib.rs:1685."""

    partial_batch_selector: PartialBatchSelector
    report_count: int
    interval: Interval
    leader_encrypted_agg_share: HpkeCiphertext
    helper_encrypted_agg_share: HpkeCiphertext

    MEDIA_TYPE = "application/dap-collection"

    def encode(self, enc: Encoder) -> None:
        self.partial_batch_selector.encode(enc)
        enc.u64(self.report_count)
        self.interval.encode(enc)
        self.leader_encrypted_agg_share.encode(enc)
        self.helper_encrypted_agg_share.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(
            PartialBatchSelector.decode(dec),
            dec.u64(),
            Interval.decode(dec),
            HpkeCiphertext.decode(dec),
            HpkeCiphertext.decode(dec),
        )


@dataclass(frozen=True)
class InputShareAad(Codec):
    """HPKE AAD for input shares; reference messages/src/lib.rs:1780."""

    task_id: TaskId
    metadata: ReportMetadata
    public_share: bytes

    def encode(self, enc: Encoder) -> None:
        self.task_id.encode(enc)
        self.metadata.encode(enc)
        enc.opaque_u32(self.public_share)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(TaskId.decode(dec), ReportMetadata.decode(dec), dec.opaque_u32())


@dataclass(frozen=True)
class AggregateShareAad(Codec):
    """HPKE AAD for aggregate shares; reference messages/src/lib.rs:1846."""

    task_id: TaskId
    aggregation_parameter: bytes
    batch_selector: BatchSelector

    def encode(self, enc: Encoder) -> None:
        self.task_id.encode(enc)
        enc.opaque_u32(self.aggregation_parameter)
        self.batch_selector.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(TaskId.decode(dec), dec.opaque_u32(), BatchSelector.decode(dec))


@dataclass(frozen=True)
class ReportShare(Codec):
    """reference messages/src/lib.rs:2068."""

    metadata: ReportMetadata
    public_share: bytes
    encrypted_input_share: HpkeCiphertext

    def encode(self, enc: Encoder) -> None:
        self.metadata.encode(enc)
        enc.opaque_u32(self.public_share)
        self.encrypted_input_share.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(ReportMetadata.decode(dec), dec.opaque_u32(), HpkeCiphertext.decode(dec))


@dataclass(frozen=True)
class PrepareInit(Codec):
    """reference messages/src/lib.rs:2139.

    `message` is one self-delimiting ping-pong message, embedded inline
    (no outer length prefix) per DAP-07.
    """

    report_share: ReportShare
    message: bytes  # ping-pong initialize message (leader prep share)

    def __post_init__(self):
        check_pingpong_frame(self.message)

    def encode(self, enc: Encoder) -> None:
        self.report_share.encode(enc)
        enc.write(self.message)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(ReportShare.decode(dec), decode_pingpong_frame(dec))


class PrepareError(enum.IntEnum):
    """reference messages/src/lib.rs:2288."""

    BATCH_COLLECTED = 0
    REPORT_REPLAYED = 1
    REPORT_DROPPED = 2
    HPKE_UNKNOWN_CONFIG_ID = 3
    HPKE_DECRYPT_ERROR = 4
    VDAF_PREP_ERROR = 5
    BATCH_SATURATED = 6
    TASK_EXPIRED = 7
    INVALID_MESSAGE = 8
    REPORT_TOO_EARLY = 9

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.value)

    @classmethod
    def decode(cls, dec: Decoder):
        try:
            return cls(dec.u8())
        except ValueError as e:
            raise DecodeError(str(e))

    def to_bytes(self) -> bytes:  # shadow int.to_bytes for codec symmetry
        return bytes([self.value])

    @classmethod
    def from_bytes(cls, raw: bytes) -> "PrepareError":
        dec = Decoder(raw)
        out = cls.decode(dec)
        dec.finish()
        return out


@dataclass(frozen=True)
class PrepareStepResult(Codec):
    """continue(0) | finished(1) | reject(2); reference messages/src/lib.rs:2235."""

    CONTINUE = 0
    FINISHED = 1
    REJECT = 2

    kind: int
    message: bytes | None = None
    prepare_error: PrepareError | None = None

    def __post_init__(self):
        if self.kind == self.CONTINUE:
            if self.message is None:
                raise DecodeError("continue PrepareStepResult requires a message")
            check_pingpong_frame(self.message)

    @classmethod
    def cont(cls, message: bytes) -> "PrepareStepResult":
        return cls(cls.CONTINUE, message=message)

    @classmethod
    def finished(cls) -> "PrepareStepResult":
        return cls(cls.FINISHED)

    @classmethod
    def reject(cls, err: PrepareError) -> "PrepareStepResult":
        return cls(cls.REJECT, prepare_error=err)

    def encode(self, enc: Encoder) -> None:
        enc.u8(self.kind)
        if self.kind == self.CONTINUE:
            enc.write(self.message)
        elif self.kind == self.REJECT:
            self.prepare_error.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        kind = dec.u8()
        if kind == cls.CONTINUE:
            return cls(kind, message=decode_pingpong_frame(dec))
        if kind == cls.FINISHED:
            return cls(kind)
        if kind == cls.REJECT:
            return cls(kind, prepare_error=PrepareError.decode(dec))
        raise DecodeError(f"bad PrepareStepResult kind {kind}")


@dataclass(frozen=True)
class PrepareResp(Codec):
    """reference messages/src/lib.rs:2189."""

    report_id: ReportId
    result: PrepareStepResult

    def encode(self, enc: Encoder) -> None:
        self.report_id.encode(enc)
        self.result.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(ReportId.decode(dec), PrepareStepResult.decode(dec))


@dataclass(frozen=True)
class PrepareContinue(Codec):
    """reference messages/src/lib.rs:2322."""

    report_id: ReportId
    message: bytes

    def __post_init__(self):
        check_pingpong_frame(self.message)

    def encode(self, enc: Encoder) -> None:
        self.report_id.encode(enc)
        enc.write(self.message)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(ReportId.decode(dec), decode_pingpong_frame(dec))


@dataclass(frozen=True)
class AggregationJobStep(Codec):
    """u16 step counter; reference messages/src/lib.rs:2507."""

    step: int

    def encode(self, enc: Encoder) -> None:
        enc.u16(self.step)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(dec.u16())

    def increment(self) -> "AggregationJobStep":
        return AggregationJobStep(self.step + 1)


@dataclass(frozen=True)
class AggregationJobInitializeReq(Codec):
    """reference messages/src/lib.rs:2432."""

    aggregation_parameter: bytes
    partial_batch_selector: PartialBatchSelector
    prepare_inits: tuple

    MEDIA_TYPE = "application/dap-aggregation-job-init-req"

    def encode(self, enc: Encoder) -> None:
        enc.opaque_u32(self.aggregation_parameter)
        self.partial_batch_selector.encode(enc)
        enc.items_u32(self.prepare_inits)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(
            dec.opaque_u32(),
            PartialBatchSelector.decode(dec),
            tuple(dec.items_u32(PrepareInit.decode)),
        )


@dataclass(frozen=True)
class AggregationJobContinueReq(Codec):
    """reference messages/src/lib.rs:2564."""

    step: AggregationJobStep
    prepare_continues: tuple

    MEDIA_TYPE = "application/dap-aggregation-job-continue-req"

    def encode(self, enc: Encoder) -> None:
        self.step.encode(enc)
        enc.items_u32(self.prepare_continues)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(AggregationJobStep.decode(dec), tuple(dec.items_u32(PrepareContinue.decode)))


@dataclass(frozen=True)
class AggregationJobResp(Codec):
    """reference messages/src/lib.rs:2619."""

    prepare_resps: tuple

    MEDIA_TYPE = "application/dap-aggregation-job-resp"

    def encode(self, enc: Encoder) -> None:
        enc.items_u32(self.prepare_resps)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(tuple(dec.items_u32(PrepareResp.decode)))


# ---------------------------------------------------------------------------
# columnar leader<->helper codec: the leader's hot path builds
# whole request bodies from pre-framed rows and parses whole responses
# into parallel columns, bypassing the per-report dataclass/Encoder
# machinery while keeping the wire bytes bit-identical (pinned by the
# codec-equivalence fuzz in tests/test_wire_columnar.py).
# ---------------------------------------------------------------------------


class PreEncoded(Codec):
    """An already-encoded wire item: encode() splices the raw bytes
    verbatim. The columnar leader codecs build whole batches of
    PrepareInit/PrepareContinue bodies in vectorized passes and hand
    them to the existing request containers through this, so the
    container's items_u32 framing — and therefore the request bytes —
    stays bit-identical to the per-item encode path. (A slotted plain
    class, not a dataclass: one is built per report on the hot path.)"""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        self.raw = raw

    def __eq__(self, other):
        return isinstance(other, PreEncoded) and self.raw == other.raw

    def __repr__(self):
        return f"PreEncoded({len(self.raw)}B)"

    def encode(self, enc: Encoder) -> None:
        enc.write(self.raw)


def encode_report_share_raw(
    report_id: bytes, time_seconds: int, public_share: bytes, ciphertext: HpkeCiphertext
) -> bytes:
    """ReportShare.to_bytes without the Encoder/dataclass machinery
    (the leader init hot loop builds one per pending report)."""
    return b"".join(
        (
            report_id,
            struct.pack(">QI", time_seconds, len(public_share)),
            public_share,
            struct.pack(">BH", ciphertext.config_id.id, len(ciphertext.encapsulated_key)),
            ciphertext.encapsulated_key,
            struct.pack(">I", len(ciphertext.payload)),
            ciphertext.payload,
        )
    )


class PrepareRespColumn:
    """An AggregationJobResp body parsed into parallel columns: 16-byte
    report ids, PrepareStepResult kinds, raw ping-pong message frames
    (kind=continue) and PrepareError values (kind=reject) — no
    per-report dataclass construction. Accepts exactly the inputs
    AggregationJobResp.from_bytes accepts and raises DecodeError on
    exactly the inputs it rejects."""

    __slots__ = ("report_ids", "kinds", "messages", "errors")

    def __init__(self, report_ids, kinds, messages, errors):
        self.report_ids: list[bytes] = report_ids
        self.kinds: bytearray = kinds
        self.messages: list[bytes | None] = messages
        self.errors: list[PrepareError | None] = errors

    def __len__(self) -> int:
        return len(self.report_ids)


def decode_prepare_resps_fast(raw: bytes) -> PrepareRespColumn:
    """Columnar AggregationJobResp parse (see PrepareRespColumn)."""
    total = len(raw)
    if total < 4:
        raise DecodeError("unexpected end of input")
    (body_len,) = struct.unpack_from(">I", raw, 0)
    end = 4 + body_len
    if end > total:
        raise DecodeError("unexpected end of input")
    if end != total:
        raise DecodeError(f"{total - end} trailing bytes")
    ids: list[bytes] = []
    kinds = bytearray()
    msgs: list[bytes | None] = []
    errs: list[PrepareError | None] = []
    pos = 4
    while pos < end:
        if end - pos < 17:
            raise DecodeError("unexpected end of input")
        rid = raw[pos : pos + 16]
        kind = raw[pos + 16]
        pos += 17
        msg = None
        err = None
        if kind == PrepareStepResult.CONTINUE:
            # one self-delimiting ping-pong frame, kept raw
            frame_start = pos
            if pos >= end:
                raise DecodeError("unexpected end of input")
            tag = raw[pos]
            pos += 1
            fields = 2 if tag == PP_CONTINUE else 1
            if tag not in (PP_INITIALIZE, PP_CONTINUE, PP_FINISH):
                raise DecodeError(f"bad ping-pong message tag {tag}")
            for _ in range(fields):
                if end - pos < 4:
                    raise DecodeError("unexpected end of input")
                (flen,) = struct.unpack_from(">I", raw, pos)
                pos += 4
                if end - pos < flen:
                    raise DecodeError("unexpected end of input")
                pos += flen
            msg = raw[frame_start:pos]
        elif kind == PrepareStepResult.REJECT:
            if pos >= end:
                raise DecodeError("unexpected end of input")
            try:
                err = PrepareError(raw[pos])
            except ValueError as e:
                raise DecodeError(str(e))
            pos += 1
        elif kind != PrepareStepResult.FINISHED:
            raise DecodeError(f"bad PrepareStepResult kind {kind}")
        ids.append(rid)
        kinds.append(kind)
        msgs.append(msg)
        errs.append(err)
    return PrepareRespColumn(ids, kinds, msgs, errs)


class ReportColumn:
    """A window of upload bodies parsed into parallel columns: 16-byte
    report ids, u64 client times, public shares, and the two HPKE
    ciphertexts decomposed into (config id, encapsulated key, payload)
    columns — no per-report dataclass/Decoder machinery (the upload
    analog of PrepareRespColumn). A lane that fails to parse
    carries its DecodeError in `errors` and None in the data columns,
    so one malformed upload rejects its own lane, never its window.
    Accept/reject per lane is identical to `Report.from_bytes`
    (fuzz-pinned by tests/test_ingest_batch.py)."""

    __slots__ = (
        "report_ids",
        "times",
        "public_shares",
        "leader_config_ids",
        "leader_encs",
        "leader_payloads",
        "helper_config_ids",
        "helper_encs",
        "helper_payloads",
        "errors",
    )

    def __init__(self):
        self.report_ids: list[bytes | None] = []
        self.times: list[int | None] = []
        self.public_shares: list[bytes | None] = []
        self.leader_config_ids: list[int | None] = []
        self.leader_encs: list[bytes | None] = []
        self.leader_payloads: list[bytes | None] = []
        self.helper_config_ids: list[int | None] = []
        self.helper_encs: list[bytes | None] = []
        self.helper_payloads: list[bytes | None] = []
        self.errors: list[DecodeError | None] = []

    def __len__(self) -> int:
        return len(self.report_ids)

    def report(self, i: int) -> Report:
        """Realize lane i as the Report dataclass (the single-report
        fallback path and TaskAggregator doubles without the batch
        surface use this; the batched stages never do)."""
        if self.errors[i] is not None:
            raise self.errors[i]
        return Report(
            ReportMetadata(ReportId(self.report_ids[i]), Time(self.times[i])),
            self.public_shares[i],
            HpkeCiphertext(
                HpkeConfigId(self.leader_config_ids[i]),
                self.leader_encs[i],
                self.leader_payloads[i],
            ),
            HpkeCiphertext(
                HpkeConfigId(self.helper_config_ids[i]),
                self.helper_encs[i],
                self.helper_payloads[i],
            ),
        )

    def helper_ciphertext(self, i: int) -> HpkeCiphertext:
        return HpkeCiphertext(
            HpkeConfigId(self.helper_config_ids[i]),
            self.helper_encs[i],
            self.helper_payloads[i],
        )


def _parse_report_fast(raw: bytes):
    """One upload body -> (rid, time, public_share, leader_ct_parts,
    helper_ct_parts); raises DecodeError on exactly the inputs
    Report.from_bytes rejects (truncation anywhere, trailing bytes —
    there are no value-level rejects in the Report layout: any u8
    config id and any u64 time are valid)."""
    total = len(raw)
    if total < 28:  # report_id(16) + time(8) + public-share length(4)
        raise DecodeError("unexpected end of input")
    rid = raw[0:16]
    t, plen = struct.unpack_from(">QI", raw, 16)
    pos = 28
    if total - pos < plen:
        raise DecodeError("unexpected end of input")
    pub = raw[pos : pos + plen]
    pos += plen
    cts = []
    for _ in range(2):
        if total - pos < 3:
            raise DecodeError("unexpected end of input")
        cfg = raw[pos]
        (elen,) = struct.unpack_from(">H", raw, pos + 1)
        pos += 3
        if total - pos < elen:
            raise DecodeError("unexpected end of input")
        enc = raw[pos : pos + elen]
        pos += elen
        if total - pos < 4:
            raise DecodeError("unexpected end of input")
        (paylen,) = struct.unpack_from(">I", raw, pos)
        pos += 4
        if total - pos < paylen:
            raise DecodeError("unexpected end of input")
        pay = raw[pos : pos + paylen]
        pos += paylen
        cts.append((cfg, enc, pay))
    if pos != total:
        raise DecodeError(f"{total - pos} trailing bytes")
    return rid, t, pub, cts[0], cts[1]


def plaintext_input_share_payload_fast(raw: bytes) -> bytes:
    """PlaintextInputShare.from_bytes(raw).payload without the
    Decoder/dataclass machinery, accepting and rejecting exactly the
    same inputs (the extension list's inner structure is still walked —
    a skip-over parser would admit bodies the codec rejects). The
    batched decrypt stage runs this once per opened plaintext."""
    total = len(raw)
    if total < 2:
        raise DecodeError("unexpected end of input")
    (elen,) = struct.unpack_from(">H", raw, 0)
    pos = 2
    ext_end = 2 + elen
    if total < ext_end:
        raise DecodeError("unexpected end of input")
    while pos < ext_end:
        if ext_end - pos < 4:  # u16 type + u16 data length
            raise DecodeError("unexpected end of input")
        (dlen,) = struct.unpack_from(">H", raw, pos + 2)
        pos += 4 + dlen
        if pos > ext_end:
            raise DecodeError("unexpected end of input")
    if total - ext_end < 4:
        raise DecodeError("unexpected end of input")
    (plen,) = struct.unpack_from(">I", raw, ext_end)
    pos = ext_end + 4
    if total - pos < plen:
        raise DecodeError("unexpected end of input")
    if pos + plen != total:
        raise DecodeError(f"{total - pos - plen} trailing bytes")
    return raw[pos : pos + plen]


def decode_reports_fast(bodies) -> ReportColumn:
    """Columnar upload-window decode (see ReportColumn)."""
    col = ReportColumn()
    for raw in bodies:
        try:
            rid, t, pub, lct, hct = _parse_report_fast(raw)
        except DecodeError as e:
            col.report_ids.append(None)
            col.times.append(None)
            col.public_shares.append(None)
            col.leader_config_ids.append(None)
            col.leader_encs.append(None)
            col.leader_payloads.append(None)
            col.helper_config_ids.append(None)
            col.helper_encs.append(None)
            col.helper_payloads.append(None)
            col.errors.append(e)
            continue
        col.report_ids.append(rid)
        col.times.append(t)
        col.public_shares.append(pub)
        col.leader_config_ids.append(lct[0])
        col.leader_encs.append(lct[1])
        col.leader_payloads.append(lct[2])
        col.helper_config_ids.append(hct[0])
        col.helper_encs.append(hct[1])
        col.helper_payloads.append(hct[2])
        col.errors.append(None)
    return col


@dataclass(frozen=True)
class AggregateShareReq(Codec):
    """reference messages/src/lib.rs:2733."""

    batch_selector: BatchSelector
    aggregation_parameter: bytes
    report_count: int
    checksum: ReportIdChecksum

    MEDIA_TYPE = "application/dap-aggregate-share-req"

    def encode(self, enc: Encoder) -> None:
        self.batch_selector.encode(enc)
        enc.opaque_u32(self.aggregation_parameter)
        enc.u64(self.report_count)
        self.checksum.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(
            BatchSelector.decode(dec),
            dec.opaque_u32(),
            dec.u64(),
            ReportIdChecksum.decode(dec),
        )


@dataclass(frozen=True)
class AggregateShare(Codec):
    """reference messages/src/lib.rs:2819."""

    encrypted_aggregate_share: HpkeCiphertext

    MEDIA_TYPE = "application/dap-aggregate-share"

    def encode(self, enc: Encoder) -> None:
        self.encrypted_aggregate_share.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder):
        return cls(HpkeCiphertext.decode(dec))
