"""Authentication tokens with constant-time comparison.

Equivalent of reference core/src/task.rs AuthenticationToken
({Bearer, DapAuth}; constant-time eq via ring::constant_time — here
hmac.compare_digest).

The port's own copy of janus_tpu/core/auth.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu.
"""

from __future__ import annotations

import base64
import hmac
import secrets
from dataclasses import dataclass

DAP_AUTH_HEADER = "DAP-Auth-Token"


@dataclass(frozen=True)
class AuthenticationToken:
    kind: str  # "Bearer" | "DapAuth"
    token: str

    @classmethod
    def bearer(cls, token: str) -> "AuthenticationToken":
        return cls("Bearer", token)

    @classmethod
    def dap_auth(cls, token: str) -> "AuthenticationToken":
        return cls("DapAuth", token)

    @classmethod
    def random_bearer(cls) -> "AuthenticationToken":
        return cls.bearer(base64.urlsafe_b64encode(secrets.token_bytes(16)).rstrip(b"=").decode())

    def request_headers(self) -> dict[str, str]:
        if self.kind == "Bearer":
            return {"Authorization": f"Bearer {self.token}"}
        return {DAP_AUTH_HEADER: self.token}

    def matches_headers(self, headers) -> bool:
        """Constant-time check of an incoming header map (case-insensitive keys)."""
        lowered = {k.lower(): v for k, v in headers.items()}
        if self.kind == "Bearer":
            got = lowered.get("authorization", "")
            want = f"Bearer {self.token}"
            return hmac.compare_digest(got.encode(), want.encode())
        got = lowered.get(DAP_AUTH_HEADER.lower(), "")
        return hmac.compare_digest(got.encode(), self.token.encode())

    def to_dict(self) -> dict:
        return {"kind": self.kind, "token": self.token}

    @classmethod
    def from_dict(cls, d: dict) -> "AuthenticationToken":
        return cls(d["kind"], d["token"])
