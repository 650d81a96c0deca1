"""HTTP retry with exponential backoff.

Equivalent of reference core/src/retries.rs:30-72: retries transport
errors and retryable status codes (5xx, 429) with capped exponential
backoff and jitter, honouring a server's Retry-After.

The port's own copy of janus_tpu/core/retries.py, with the
`retry.attempt` failpoint inside each attempt's `try`, so that an
injected transport error is retried exactly like a real one.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from .. import failpoints
from .deadline import DeadlineExceeded  # noqa: F401  (re-exported)


class RequestAborted(Exception):
    """The caller's should_abort() tripped mid-retry (driver shutdown
    drain): the request is abandoned without a conclusive response so the
    job step can step back and release its lease immediately."""


@dataclass(frozen=True)
class Backoff:
    initial: float = 0.1
    multiplier: float = 2.0
    max_interval: float = 5.0
    max_elapsed: float = 30.0
    jitter: float = 0.25

    @classmethod
    def test(cls) -> "Backoff":
        """Fast backoff for tests."""
        return cls(initial=0.001, max_interval=0.01, max_elapsed=0.25)


RETRYABLE_STATUS = {429, 500, 502, 503, 504}


def is_retryable_status(status: int) -> bool:
    return status in RETRYABLE_STATUS


def parse_retry_after(value) -> float | None:
    """Seconds to wait per an HTTP Retry-After header value (delta
    seconds or HTTP-date), or None if absent or unparseable."""
    if value is None:
        return None
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        pass
    try:
        from email.utils import parsedate_to_datetime

        dt = parsedate_to_datetime(str(value))
        return max(0.0, dt.timestamp() - time.time())
    except Exception:
        return None


def _retry_after_from(headers) -> float | None:
    if not headers:
        return None
    lowered = {str(k).lower(): v for k, v in headers.items()}
    return parse_retry_after(lowered.get("retry-after"))


def retry_http_request(
    do_request,
    backoff: Backoff = Backoff(),
    sleep=time.sleep,
    deadline: float | None = None,
    should_abort=None,
):
    """Call do_request() until success or budget exhausted.

    do_request returns (status, body), or (status, body, headers) to let
    a server-sent Retry-After steer the backoff, or raises OSError-likes
    for transport failures. Returns the last (status, body); raises the
    last transport error if every attempt failed by exception.

    A retryable status with a Retry-After header sets the next sleep to
    the server's delay, clamped to [backoff.initial, backoff.max_interval]
    and still bounded by the deadline.

    deadline: optional time.monotonic() value after which no further
    attempt or backoff sleep is started. Raises DeadlineExceeded if it
    passes before any conclusive response.

    should_abort: optional callable checked before every attempt and
    every backoff sleep; when it returns True the loop raises
    RequestAborted.
    """
    interval = backoff.initial
    elapsed = 0.0
    last_exc = None
    status = body = None
    while True:
        if should_abort is not None and should_abort():
            raise RequestAborted("request abandoned (shutdown drain)")
        if deadline is not None and time.monotonic() >= deadline:
            if last_exc is not None:
                raise last_exc
            raise DeadlineExceeded(
                "request deadline (lease bound) exceeded", last_status=status
            )
        retry_after = None
        try:
            failpoints.hit(
                "retry.attempt",
                error_factory=lambda: OSError("injected transport error (failpoint retry.attempt)"),
            )
            result = do_request()
            status, body = result[0], result[1]
            if not is_retryable_status(status):
                return status, body
            if len(result) > 2:
                retry_after = _retry_after_from(result[2])
            last_exc = None
        except (OSError, ConnectionError) as e:
            last_exc = e
        if retry_after is not None:
            # the server's schedule, clamped, no jitter; floored at the
            # initial interval so "Retry-After: 0" cannot spin the loop
            next_delay = min(max(retry_after, backoff.initial), backoff.max_interval)
        else:
            next_delay = interval
        budget_spent = elapsed + next_delay > backoff.max_elapsed
        deadline_near = (
            deadline is not None and time.monotonic() + next_delay >= deadline
        )
        if budget_spent or deadline_near:
            if last_exc is not None:
                raise last_exc
            if budget_spent:
                # backoff budget exhausted: the last (retryable) response
                # is the conclusive outcome
                return status, body
            raise DeadlineExceeded(
                "request deadline (lease bound) exceeded", last_status=status
            )
        if retry_after is None:
            next_delay = interval * (1 + random.uniform(-backoff.jitter, backoff.jitter))
        if should_abort is not None and should_abort():
            raise RequestAborted("request abandoned (shutdown drain)")
        sleep(next_delay)
        elapsed += next_delay
        interval = min(interval * backoff.multiplier, backoff.max_interval)
