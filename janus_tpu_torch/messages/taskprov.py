"""taskprov wire messages (draft-wang-ppm-dap-taskprov-04).

Equivalent of the reference's messages/src/taskprov.rs:17 — the in-band
task-provisioning extension: a `TaskConfig` carried base64url-encoded in
the `dap-taskprov` request header, whose SHA-256 digest IS the task ID.
Byte layouts follow the draft's TLS presentation language so the two
cooperating aggregators (and other DAP implementations) interoperate.

The port's own copy of janus_tpu/messages/taskprov.py, line for line: a
TaskConfig encodes to the same bytes in both packages, so both derive
the same task ID. `DpConfig` is defined here and nowhere else in the
port (`dp.py` holds the noise, not the wire message).
"""

from __future__ import annotations

import enum
import hashlib
import struct
from dataclasses import dataclass

from .codec import Codec, DecodeError, Decoder, Encoder
from .core import Duration, TaskId, Time

TASKPROV_HEADER = "dap-taskprov"  # reference core/src/lib.rs:40


class DpMechanism(enum.IntEnum):
    """reference messages/src/taskprov.rs (DpMechanism)."""

    RESERVED = 0
    NONE = 1


@dataclass(frozen=True)
class DpConfig(Codec):
    """Differential-privacy configuration (mostly unspecified upstream).

    reference messages/src/taskprov.rs (DpConfig).
    """

    dp_mechanism: DpMechanism = DpMechanism.NONE

    def encode(self, enc: Encoder) -> None:
        enc.u8(int(self.dp_mechanism))

    @classmethod
    def decode(cls, dec: Decoder) -> "DpConfig":
        v = dec.u8()
        try:
            return cls(DpMechanism(v))
        except ValueError:
            raise DecodeError(f"unexpected DpMechanism {v}")


class TaskprovQueryType(enum.IntEnum):
    RESERVED = 0
    TIME_INTERVAL = 1
    FIXED_SIZE = 2


@dataclass(frozen=True)
class QueryConfig(Codec):
    """Batch properties for a provisioned task.

    reference messages/src/taskprov.rs (QueryConfig). Note the draft
    encodes the query-type byte FIRST but its parameter (fixed-size
    max_batch_size) LAST, after min_batch_size.
    """

    time_precision: Duration
    max_batch_query_count: int
    min_batch_size: int
    query_type: TaskprovQueryType
    max_batch_size: int | None = None  # fixed-size only

    def __post_init__(self):
        if (self.query_type == TaskprovQueryType.FIXED_SIZE) != (
            self.max_batch_size is not None
        ):
            raise ValueError("max_batch_size iff fixed-size query")

    def encode(self, enc: Encoder) -> None:
        enc.u8(int(self.query_type))
        self.time_precision.encode(enc)
        enc.u16(self.max_batch_query_count)
        enc.u32(self.min_batch_size)
        if self.query_type == TaskprovQueryType.FIXED_SIZE:
            enc.u32(self.max_batch_size)

    @classmethod
    def decode(cls, dec: Decoder) -> "QueryConfig":
        qt = dec.u8()
        time_precision = Duration.decode(dec)
        max_bqc = dec.u16()
        min_bs = dec.u32()
        try:
            qt = TaskprovQueryType(qt)
        except ValueError:
            raise DecodeError(f"unexpected taskprov QueryType {qt}")
        max_batch_size = dec.u32() if qt == TaskprovQueryType.FIXED_SIZE else None
        return cls(time_precision, max_bqc, min_bs, qt, max_batch_size)


class VdafTypeCode(enum.IntEnum):
    PRIO3_COUNT = 0x00000000
    PRIO3_SUM = 0x00000001
    PRIO3_HISTOGRAM = 0x00000002
    POPLAR1 = 0x00001000


@dataclass(frozen=True)
class VdafType(Codec):
    """VDAF type + parameters (reference messages/src/taskprov.rs VdafType).

    Exactly one parameter set is used per code: `bits` for
    PRIO3_SUM (u8) and POPLAR1 (u16), `buckets` (u24-prefixed list of
    u64 bucket boundaries) for PRIO3_HISTOGRAM.
    """

    code: VdafTypeCode
    bits: int = 0
    buckets: tuple[int, ...] = ()

    @classmethod
    def prio3_count(cls) -> "VdafType":
        return cls(VdafTypeCode.PRIO3_COUNT)

    @classmethod
    def prio3_sum(cls, bits: int) -> "VdafType":
        return cls(VdafTypeCode.PRIO3_SUM, bits=bits)

    @classmethod
    def prio3_histogram(cls, buckets) -> "VdafType":
        if not buckets:
            raise ValueError("buckets must not be empty for Prio3Histogram")
        return cls(VdafTypeCode.PRIO3_HISTOGRAM, buckets=tuple(buckets))

    @classmethod
    def poplar1(cls, bits: int) -> "VdafType":
        return cls(VdafTypeCode.POPLAR1, bits=bits)

    def encode(self, enc: Encoder) -> None:
        enc.u32(int(self.code))
        if self.code == VdafTypeCode.PRIO3_SUM:
            enc.u8(self.bits)
        elif self.code == VdafTypeCode.PRIO3_HISTOGRAM:
            raw = b"".join(struct.pack(">Q", b) for b in self.buckets)
            assert len(raw) < (1 << 24)
            enc.write(len(raw).to_bytes(3, "big")).write(raw)
        elif self.code == VdafTypeCode.POPLAR1:
            enc.u16(self.bits)

    @classmethod
    def decode(cls, dec: Decoder) -> "VdafType":
        code = dec.u32()
        try:
            code = VdafTypeCode(code)
        except ValueError:
            raise DecodeError(f"unexpected VdafType {code:#x}")
        if code == VdafTypeCode.PRIO3_SUM:
            return cls(code, bits=dec.u8())
        if code == VdafTypeCode.PRIO3_HISTOGRAM:
            n = int.from_bytes(dec.take(3), "big")
            if n % 8:
                raise DecodeError("histogram bucket list not a multiple of 8 bytes")
            sub = dec.sub(n)
            buckets = tuple(sub.u64() for _ in range(n // 8))
            if not buckets:
                raise DecodeError("buckets must not be empty for Prio3Histogram")
            return cls(code, buckets=buckets)
        if code == VdafTypeCode.POPLAR1:
            return cls(code, bits=dec.u16())
        return cls(code)

    def to_vdaf_instance(self):
        """Map to a VdafInstance (reference core/src/task.rs:89-110)."""
        from ..vdaf.registry import VdafInstance

        if self.code == VdafTypeCode.PRIO3_COUNT:
            return VdafInstance.count()
        if self.code == VdafTypeCode.PRIO3_SUM:
            return VdafInstance.sum(self.bits)
        if self.code == VdafTypeCode.PRIO3_HISTOGRAM:
            # bucket boundaries -> bucket count (top bucket extends to
            # infinity), as the reference translates pre-VDAF-06 configs
            return VdafInstance.histogram(len(self.buckets) + 1)
        if self.code == VdafTypeCode.POPLAR1:
            return VdafInstance.poplar1(self.bits)
        raise ValueError(f"unsupported taskprov VdafType {self.code!r}")


@dataclass(frozen=True)
class VdafConfig(Codec):
    """reference messages/src/taskprov.rs (VdafConfig)."""

    dp_config: DpConfig
    vdaf_type: VdafType

    def encode(self, enc: Encoder) -> None:
        self.dp_config.encode(enc)
        self.vdaf_type.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder) -> "VdafConfig":
        return cls(DpConfig.decode(dec), VdafType.decode(dec))


def _encode_url(enc: Encoder, url: str) -> None:
    enc.opaque_u16(url.encode())


def _decode_url(dec: Decoder) -> str:
    raw = dec.opaque_u16()
    try:
        return raw.decode("ascii")
    except UnicodeDecodeError:
        raise DecodeError("aggregator endpoint URL is not ASCII")


@dataclass(frozen=True)
class TaskConfig(Codec):
    """Complete in-band task description.

    reference messages/src/taskprov.rs (TaskConfig): task_info
    (u8-prefixed, nonempty), aggregator endpoints (u16-prefixed list of
    u16-prefixed URLs, [leader, helper]), query config, expiration,
    VDAF config.
    """

    task_info: bytes
    aggregator_endpoints: tuple[str, ...]
    query_config: QueryConfig
    task_expiration: Time
    vdaf_config: VdafConfig

    def __post_init__(self):
        if not self.task_info:
            raise ValueError("task_info must not be empty")
        if not self.aggregator_endpoints:
            raise ValueError("aggregator_endpoints must not be empty")

    def encode(self, enc: Encoder) -> None:
        enc.opaque_u8(self.task_info)
        inner = Encoder()
        for url in self.aggregator_endpoints:
            _encode_url(inner, url)
        enc.opaque_u16(inner.bytes())
        self.query_config.encode(enc)
        self.task_expiration.encode(enc)
        self.vdaf_config.encode(enc)

    @classmethod
    def decode(cls, dec: Decoder) -> "TaskConfig":
        task_info = dec.opaque_u8()
        if not task_info:
            raise DecodeError("task_info must not be empty")
        url_dec = dec.sub(dec.u16())
        endpoints = []
        while url_dec.remaining:
            endpoints.append(_decode_url(url_dec))
        if not endpoints:
            raise DecodeError("aggregator_endpoints must not be empty")
        return cls(
            task_info,
            tuple(endpoints),
            QueryConfig.decode(dec),
            Time.decode(dec),
            VdafConfig.decode(dec),
        )

    def computed_task_id(self) -> TaskId:
        """taskprov task ID = SHA-256 of the encoded config
        (reference http_handlers.rs:592)."""
        return TaskId(hashlib.sha256(self.to_bytes()).digest())

    def leader_url(self) -> str:
        return self.aggregator_endpoints[0]

    def helper_url(self) -> str:
        if len(self.aggregator_endpoints) < 2:
            raise ValueError("taskprov configuration is missing the helper")
        return self.aggregator_endpoints[1]
