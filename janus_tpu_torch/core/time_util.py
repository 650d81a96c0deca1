"""Clock abstraction with a controllable test clock.

Equivalent of reference core/src/time.rs:11-87 (`Clock`, `RealClock`,
`MockClock`); the interval/rounding extension methods live on the
message types themselves (janus_tpu.messages.core.Time/Interval).

The port's own copy of janus_tpu/core/time_util.py, line for line; it holds no JAX
and the port imports nothing of janus_tpu.
"""

from __future__ import annotations

import threading
import time as _time

from ..messages import Duration, Time


class Clock:
    def now(self) -> Time:
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> Time:
        return Time(int(_time.time()))


class MockClock(Clock):
    """Settable/advanceable clock for tests (reference core/src/time.rs:42)."""

    def __init__(self, when: Time = Time(1577836800)):  # 2020-01-01T00:00:00Z
        self._now = when
        self._lock = threading.Lock()

    def now(self) -> Time:
        with self._lock:
            return self._now

    def advance(self, d: Duration) -> None:
        with self._lock:
            self._now = self._now.add(d)

    def set(self, when: Time) -> None:
        with self._lock:
            self._now = when
