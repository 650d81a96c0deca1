"""Task model: per-task DAP configuration for an aggregator.

Equivalent of reference aggregator_core/src/task.rs:97-139 (`Task`),
:492 (`SerializedTask` YAML form), :677 (`TaskBuilder`). A task binds a
TaskId to endpoints, query type, VDAF, role, verify key, batch/time
parameters, auth tokens and HPKE keys.

The port's own copy of janus_tpu/task.py. A task is the state the port
carries across from a janus_tpu deployment (verify key, HPKE keypairs,
query type, VDAF): `Task.from_dict` reads what janus_tpu's
`Task.to_dict` writes, so a port helper provisioned from a janus_tpu
task answers as the janus_tpu helper does. The DP strategy (`dp.py`) is
written and read as janus_tpu writes and reads it.
"""

from __future__ import annotations

import base64
import secrets
from dataclasses import dataclass, replace

from .core.auth import AuthenticationToken
from .dp import DpStrategy
from .core.hpke import HpkeKeypair, generate_hpke_config_and_private_key
from .messages import Duration, HpkeConfig, Role, TaskId, Time, TimeInterval, FixedSize, QUERY_TYPES
from .vdaf.registry import VdafInstance

VERIFY_KEY_LENGTH = 16  # reference core/src/task.rs:15


@dataclass(frozen=True)
class QueryTypeConfig:
    """TimeInterval, or FixedSize{max_batch_size, batch_time_window_size}."""

    code: int
    max_batch_size: int | None = None
    batch_time_window_size: Duration | None = None

    @classmethod
    def time_interval(cls) -> "QueryTypeConfig":
        return cls(TimeInterval.CODE)

    @classmethod
    def fixed_size(cls, max_batch_size: int | None = None, batch_time_window_size: Duration | None = None) -> "QueryTypeConfig":
        return cls(FixedSize.CODE, max_batch_size, batch_time_window_size)

    @property
    def query_type(self):
        return QUERY_TYPES[self.code]

    def to_dict(self) -> dict:
        d = {"code": self.code}
        if self.max_batch_size is not None:
            d["max_batch_size"] = self.max_batch_size
        if self.batch_time_window_size is not None:
            d["batch_time_window_size"] = self.batch_time_window_size.seconds
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "QueryTypeConfig":
        return cls(
            d["code"],
            d.get("max_batch_size"),
            Duration(d["batch_time_window_size"]) if d.get("batch_time_window_size") is not None else None,
        )


@dataclass(frozen=True)
class Task:
    """reference aggregator_core/src/task.rs:97."""

    task_id: TaskId
    leader_aggregator_endpoint: str
    helper_aggregator_endpoint: str
    query_type: QueryTypeConfig
    vdaf: VdafInstance
    role: Role
    vdaf_verify_key: bytes
    max_batch_query_count: int
    task_expiration: Time | None
    report_expiry_age: Duration | None
    min_batch_size: int
    time_precision: Duration
    tolerable_clock_skew: Duration
    collector_hpke_config: HpkeConfig | None
    aggregator_auth_token: AuthenticationToken | None
    collector_auth_token: AuthenticationToken | None
    hpke_keys: tuple[HpkeKeypair, ...] = ()
    # DP noise each aggregator adds to its own aggregate share at release
    # (beyond the reference, whose DpMechanism is only Reserved|None)
    dp_strategy: DpStrategy = None  # type: ignore[assignment]

    def __post_init__(self):
        assert self.role in (Role.LEADER, Role.HELPER)
        assert len(self.vdaf_verify_key) == VERIFY_KEY_LENGTH
        assert self.time_precision.seconds > 0
        if self.dp_strategy is None:
            object.__setattr__(self, "dp_strategy", DpStrategy())

    def peer_endpoint(self) -> str:
        return (
            self.helper_aggregator_endpoint
            if self.role == Role.LEADER
            else self.leader_aggregator_endpoint
        )

    def hpke_keypair(self, config_id) -> HpkeKeypair | None:
        for kp in self.hpke_keys:
            if kp.config.id == config_id:
                return kp
        return None

    def report_expired(self, report_time: Time, now: Time) -> bool:
        """GC cutoff check (reference aggregator.rs:1362-1370)."""
        if self.report_expiry_age is None:
            return False
        return report_time.add(self.report_expiry_age) < now

    def to_dict(self) -> dict:
        """Serialized form (reference SerializedTask, task.rs:492)."""

        def b64(b: bytes) -> str:
            return base64.urlsafe_b64encode(b).decode().rstrip("=")

        return {
            "task_id": b64(self.task_id.data),
            "leader_aggregator_endpoint": self.leader_aggregator_endpoint,
            "helper_aggregator_endpoint": self.helper_aggregator_endpoint,
            "query_type": self.query_type.to_dict(),
            "vdaf": self.vdaf.to_dict(),
            "role": int(self.role),
            "vdaf_verify_key": b64(self.vdaf_verify_key),
            "max_batch_query_count": self.max_batch_query_count,
            "task_expiration": self.task_expiration.seconds if self.task_expiration else None,
            "report_expiry_age": self.report_expiry_age.seconds if self.report_expiry_age else None,
            "min_batch_size": self.min_batch_size,
            "time_precision": self.time_precision.seconds,
            "tolerable_clock_skew": self.tolerable_clock_skew.seconds,
            "collector_hpke_config": (
                base64.urlsafe_b64encode(self.collector_hpke_config.to_bytes()).decode()
                if self.collector_hpke_config
                else None
            ),
            "aggregator_auth_token": self.aggregator_auth_token.to_dict() if self.aggregator_auth_token else None,
            "collector_auth_token": self.collector_auth_token.to_dict() if self.collector_auth_token else None,
            "hpke_keys": [
                {
                    "config": base64.urlsafe_b64encode(kp.config.to_bytes()).decode(),
                    "private_key": b64(kp.private_key),
                }
                for kp in self.hpke_keys
            ],
            "dp_strategy": self.dp_strategy.to_dict() if self.dp_strategy.enabled else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Task":
        def unb64(s: str) -> bytes:
            return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))

        return cls(
            task_id=TaskId(unb64(d["task_id"])),
            leader_aggregator_endpoint=d["leader_aggregator_endpoint"],
            helper_aggregator_endpoint=d["helper_aggregator_endpoint"],
            query_type=QueryTypeConfig.from_dict(d["query_type"]),
            vdaf=VdafInstance.from_dict(d["vdaf"]),
            role=Role(d["role"]),
            vdaf_verify_key=unb64(d["vdaf_verify_key"]),
            max_batch_query_count=d["max_batch_query_count"],
            task_expiration=Time(d["task_expiration"]) if d.get("task_expiration") is not None else None,
            report_expiry_age=Duration(d["report_expiry_age"]) if d.get("report_expiry_age") is not None else None,
            min_batch_size=d["min_batch_size"],
            time_precision=Duration(d["time_precision"]),
            tolerable_clock_skew=Duration(d["tolerable_clock_skew"]),
            collector_hpke_config=(
                HpkeConfig.from_bytes(base64.urlsafe_b64decode(d["collector_hpke_config"]))
                if d.get("collector_hpke_config")
                else None
            ),
            aggregator_auth_token=(
                AuthenticationToken.from_dict(d["aggregator_auth_token"])
                if d.get("aggregator_auth_token")
                else None
            ),
            collector_auth_token=(
                AuthenticationToken.from_dict(d["collector_auth_token"])
                if d.get("collector_auth_token")
                else None
            ),
            hpke_keys=tuple(
                HpkeKeypair(
                    HpkeConfig.from_bytes(base64.urlsafe_b64decode(k["config"])),
                    unb64(k["private_key"]),
                )
                for k in d.get("hpke_keys", ())
            ),
            dp_strategy=DpStrategy.from_dict(d.get("dp_strategy")),
        )


class TaskBuilder:
    """Fluent builder with sane test defaults (reference task.rs:677)."""

    def __init__(self, query_type: QueryTypeConfig, vdaf: VdafInstance, role: Role):
        self._task = Task(
            task_id=TaskId.random(),
            leader_aggregator_endpoint="https://leader.example.com/",
            helper_aggregator_endpoint="https://helper.example.com/",
            query_type=query_type,
            vdaf=vdaf,
            role=role,
            vdaf_verify_key=secrets.token_bytes(VERIFY_KEY_LENGTH),
            max_batch_query_count=1,
            task_expiration=None,
            report_expiry_age=None,
            min_batch_size=1,
            time_precision=Duration(3600),
            tolerable_clock_skew=Duration(60),
            collector_hpke_config=generate_hpke_config_and_private_key(config_id=200).config,
            aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_auth_token=AuthenticationToken.random_bearer(),
            hpke_keys=(generate_hpke_config_and_private_key(config_id=0),),
        )

    def with_(self, **kwargs) -> "TaskBuilder":
        self._task = replace(self._task, **kwargs)
        return self

    def build(self) -> Task:
        return self._task
