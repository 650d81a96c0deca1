"""Request/step deadline propagation.

One ambient deadline per unit of work, carried in a contextvar:

* a **job driver** enters `deadline_scope(lease_deadline(...))` around a
  leased step, so every stage of the step (engine dispatch, helper HTTP,
  datastore writes) shares the lease budget;
* the **HTTP client** stamps the remaining budget on outbound requests
  as the `DAP-Janus-Deadline` header (seconds, decimal: a duration, not
  a wall-clock instant, so leader/helper clock skew cannot corrupt it);
* the **helper** turns the header back into an absolute monotonic
  deadline at admission, backdated by the time the request sat in the
  accept queue, and enters `deadline_scope` for the handler, where
  `check(stage)` raises `DeadlineExceeded` between stages.

`DeadlineExceeded` is the one exception type for "the budget is dead":
the retry loop (core/retries.py) and the helper handler raise it, and
the job driver translates it into a step-back instead of a failed
attempt. A helper that hits it mid-handler answers the conclusive
`DEADLINE_EXCEEDED_STATUS` (408, not a retryable 5xx), which the leader
maps back to DeadlineExceeded and steps back on.

With no scope entered, every hook here is a no-op.

The port's own copy of janus_tpu/core/deadline.py; it leaves out the
per-stage counter that `check` feeds there (metrics).
"""

from __future__ import annotations

import contextlib
import contextvars
import time

# Header carrying the sender's REMAINING budget in seconds (decimal).
DEADLINE_HEADER = "DAP-Janus-Deadline"

# Conclusive "your budget is dead" answer (helper -> leader). 408 is not
# in core.retries.RETRYABLE_STATUS, so the leader's retry loop returns it
# immediately and the driver steps back.
DEADLINE_EXCEEDED_STATUS = 408

# A header value beyond this is clamped ("effectively unbounded").
MAX_REMAINING_S = 24 * 3600.0


class DeadlineExceeded(TimeoutError):
    """The work's deadline (lease bound / propagated request budget)
    tripped before completion. Carries the last retryable status, if
    any, for logs only: a stale 5xx from an earlier attempt must not
    masquerade as the conclusive outcome of the request."""

    def __init__(self, msg: str, last_status: int | None = None):
        super().__init__(msg)
        self.last_status = last_status


_deadline_var: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "janus_deadline", default=None
)
# seconds the CURRENT request spent in the server's accept queue before a
# handler thread picked it up (set per request by DapServer)
_queue_age_var: contextvars.ContextVar[float] = contextvars.ContextVar(
    "janus_request_queue_age", default=0.0
)


def current_deadline() -> float | None:
    """The ambient time.monotonic() deadline, or None (unbounded)."""
    return _deadline_var.get()


def remaining_s() -> float | None:
    """Seconds left on the ambient deadline (may be negative), or None."""
    dl = _deadline_var.get()
    if dl is None:
        return None
    return dl - time.monotonic()


@contextlib.contextmanager
def deadline_scope(deadline: float | None):
    """Set the ambient deadline (a time.monotonic() value, or None to
    clear an inherited one) for the duration of the block."""
    token = _deadline_var.set(deadline)
    try:
        yield deadline
    finally:
        _deadline_var.reset(token)


def check(stage: str) -> None:
    """Raise DeadlineExceeded if the ambient deadline has passed."""
    dl = _deadline_var.get()
    if dl is None or time.monotonic() < dl:
        return
    raise DeadlineExceeded(f"deadline exceeded during {stage}")


def header_value(deadline: float | None) -> str | None:
    """Encode a monotonic deadline as the DAP-Janus-Deadline header value
    (remaining seconds), or None when unbounded or already dead."""
    if deadline is None:
        return None
    rem = deadline - time.monotonic()
    if rem <= 0:
        return None
    return f"{min(rem, MAX_REMAINING_S):.3f}"


def parse_header(headers, queue_age_s: float = 0.0) -> float | None:
    """Absolute monotonic deadline from a request's headers, or None.

    `queue_age_s` backdates the anchor: time the request spent waiting in
    our accept queue has already been spent. Unparseable or negative
    values are ignored (None)."""
    raw = None
    for k, v in headers.items():
        if str(k).lower() == DEADLINE_HEADER.lower():
            raw = v
            break
    if raw is None:
        return None
    try:
        rem = float(raw)
    except (TypeError, ValueError):
        return None
    if rem < 0:
        return None
    rem = min(rem, MAX_REMAINING_S)
    return time.monotonic() - max(0.0, queue_age_s) + rem


def set_request_queue_age(age_s: float) -> None:
    """Record how long the current request sat in the accept queue."""
    _queue_age_var.set(max(0.0, age_s))


def request_queue_age() -> float:
    return _queue_age_var.get()
