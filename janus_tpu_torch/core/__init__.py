"""Shared runtime utilities of the port: HPKE, clocks, auth tokens.

The port's own copies of janus_tpu/core's JAX-free modules that the
helper's aggregate-init path needs (hpke, hpke_backend, time_util,
auth). The retries, circuit breaker, deadlines and HTTP client come
with the leader's job driver.
"""

from .auth import DAP_AUTH_HEADER, AuthenticationToken
from .hpke import (
    HpkeApplicationInfo,
    HpkeKeypair,
    Label,
    generate_hpke_config_and_private_key,
    hpke_open,
    hpke_seal,
)
from .time_util import Clock, MockClock, RealClock

__all__ = [
    "HpkeApplicationInfo",
    "HpkeKeypair",
    "Label",
    "generate_hpke_config_and_private_key",
    "hpke_open",
    "hpke_seal",
    "Clock",
    "MockClock",
    "RealClock",
    "AuthenticationToken",
    "DAP_AUTH_HEADER",
]
