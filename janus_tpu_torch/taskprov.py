"""taskprov peer-aggregator model + verify-key derivation.

Equivalent of reference aggregator_core/src/taskprov.rs:20-260: a
`PeerAggregator` is the pre-shared relationship with another DAP
aggregator that allows tasks to be provisioned in-band (the
`dap-taskprov` header), including the preshared `verify_key_init` from
which each provisioned task's VDAF verify key is derived with
HKDF-SHA256 per draft-wang-ppm-dap-taskprov-04 section 3.2.

The port's own copy of janus_tpu/taskprov.py, line for line: a peer's
`to_dict` round-trips through either package's `from_dict`, and both
derive the same verify key for a task.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import secrets
from dataclasses import dataclass, replace

from .core.auth import AuthenticationToken
from .core.hpke import generate_hpke_config_and_private_key
from .messages import Duration, HpkeConfig, Role, TaskId

VERIFY_KEY_INIT_LENGTH = 32

# draft-wang-ppm-dap-taskprov-04 section 3.2: HKDF salt = SHA-256("dap-taskprov")
TASKPROV_SALT = hashlib.sha256(b"dap-taskprov").digest()


def hkdf_sha256(salt: bytes, ikm: bytes, info: bytes, length: int) -> bytes:
    """RFC 5869 HKDF-Extract + Expand with SHA-256."""
    prk = hmac.new(salt, ikm, hashlib.sha256).digest()
    out = b""
    block = b""
    counter = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.sha256).digest()
        out += block
        counter += 1
    return out[:length]


@dataclass(frozen=True)
class PeerAggregator:
    """Pre-shared peer relationship (reference aggregator_core/src/taskprov.rs:92).

    (endpoint, role) uniquely identify the peer; `role` is the role the
    PEER plays in provisioned tasks.
    """

    endpoint: str
    role: Role
    verify_key_init: bytes
    collector_hpke_config: HpkeConfig
    report_expiry_age: Duration | None
    tolerable_clock_skew: Duration
    aggregator_auth_tokens: tuple[AuthenticationToken, ...]
    collector_auth_tokens: tuple[AuthenticationToken, ...]

    def __post_init__(self):
        assert self.role in (Role.LEADER, Role.HELPER)
        assert len(self.verify_key_init) == VERIFY_KEY_INIT_LENGTH

    # --- auth (reference taskprov.rs:206-235) ---
    def primary_aggregator_auth_token(self) -> AuthenticationToken:
        return self.aggregator_auth_tokens[-1]

    def check_aggregator_auth(self, headers) -> bool:
        return any(t.matches_headers(headers) for t in self.aggregator_auth_tokens)

    def primary_collector_auth_token(self) -> AuthenticationToken:
        return self.collector_auth_tokens[-1]

    def check_collector_auth(self, headers) -> bool:
        return any(t.matches_headers(headers) for t in self.collector_auth_tokens)

    # --- verify-key derivation (reference taskprov.rs:239-260) ---
    def derive_vdaf_verify_key(self, task_id: TaskId, length: int = 16) -> bytes:
        return hkdf_sha256(TASKPROV_SALT, self.verify_key_init, task_id.data, length)

    # --- serialization (datastore row payload) ---
    def to_dict(self) -> dict:
        return {
            "endpoint": self.endpoint,
            "role": int(self.role),
            "verify_key_init": base64.urlsafe_b64encode(self.verify_key_init).decode(),
            "collector_hpke_config": base64.urlsafe_b64encode(
                self.collector_hpke_config.to_bytes()
            ).decode(),
            "report_expiry_age": (
                self.report_expiry_age.seconds if self.report_expiry_age else None
            ),
            "tolerable_clock_skew": self.tolerable_clock_skew.seconds,
            "aggregator_auth_tokens": [t.to_dict() for t in self.aggregator_auth_tokens],
            "collector_auth_tokens": [t.to_dict() for t in self.collector_auth_tokens],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PeerAggregator":
        return cls(
            endpoint=d["endpoint"],
            role=Role(d["role"]),
            verify_key_init=base64.urlsafe_b64decode(d["verify_key_init"]),
            collector_hpke_config=HpkeConfig.from_bytes(
                base64.urlsafe_b64decode(d["collector_hpke_config"])
            ),
            report_expiry_age=(
                Duration(d["report_expiry_age"])
                if d.get("report_expiry_age") is not None
                else None
            ),
            tolerable_clock_skew=Duration(d["tolerable_clock_skew"]),
            aggregator_auth_tokens=tuple(
                AuthenticationToken.from_dict(t) for t in d["aggregator_auth_tokens"]
            ),
            collector_auth_tokens=tuple(
                AuthenticationToken.from_dict(t) for t in d["collector_auth_tokens"]
            ),
        )


class PeerAggregatorBuilder:
    """Test/provisioning builder (reference taskprov.rs test_util)."""

    def __init__(self):
        self._peer = PeerAggregator(
            endpoint="https://example.com/",
            role=Role.LEADER,
            verify_key_init=secrets.token_bytes(VERIFY_KEY_INIT_LENGTH),
            collector_hpke_config=generate_hpke_config_and_private_key(
                config_id=201
            ).config,
            report_expiry_age=None,
            tolerable_clock_skew=Duration(60),
            aggregator_auth_tokens=(AuthenticationToken.random_bearer(),),
            collector_auth_tokens=(AuthenticationToken.random_bearer(),),
        )

    def with_(self, **kwargs) -> "PeerAggregatorBuilder":
        self._peer = replace(self._peer, **kwargs)
        return self

    def build(self) -> PeerAggregator:
        return self._peer
