"""Admission control for the DAP front door.

The port's own copy of janus_tpu/ingest/admission.py. Two admission
signals, evaluated per request before any decode, crypto or datastore
work:

* **Token buckets** per route class (`upload`, `aggregate`): a
  configured sustained rate plus burst. Rate 0 disables the bucket.
* **Queue-depth watermarks** derived from the ingest pipeline's bounded
  stage queues: when pipeline occupancy crosses a class's watermark,
  that class sheds. The first class of the shed priority (client
  uploads by default) sheds at `queue_high_watermark`, later classes
  (the aggregator-to-aggregator steps that finish work already
  admitted) only as the queue approaches full.

A propagated deadline that is already spent sheds too, and so do the
aggregate routes while a datastore supervisor reports the database not
up (uploads keep flowing: they land in the spill journal). Shedding
raises `ShedError`, which the HTTP layer maps to a 429 (capacity) or 503
(availability) problem document with a `Retry-After` header. Not ported:
the shed counter.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


class ShedError(Exception):
    """Request refused by admission control. `status` is the HTTP
    answer: 429 for capacity sheds (try again soon), 503 for
    availability sheds (a spent deadline, the datastore down, the journal
    full: the server, not the client, is the problem); both carry
    Retry-After."""

    def __init__(
        self,
        route_class: str,
        reason: str,
        retry_after_s: float,
        status: int = 429,
    ):
        super().__init__(
            f"{route_class} shed ({reason}); retry after {retry_after_s:.1f}s"
        )
        self.route_class = route_class
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.status = status


class TokenBucket:
    """Classic token bucket: `burst` capacity, `rate` tokens/sec refill.

    `try_acquire` returns 0.0 when a token was taken, else the seconds
    until one refills (the Retry-After hint)."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        if rate <= 0:
            raise ValueError("token bucket rate must be positive")
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._clock = clock
        self._tokens = self.burst
        self._t = clock()
        self._lock = threading.Lock()

    def try_acquire(self) -> float:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst, self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            return (1.0 - self._tokens) / self.rate


@dataclass
class AdmissionConfig:
    """Knobs (mirrored by the aggregator Config)."""

    # requests/sec sustained + burst per route class; rate 0 = unlimited
    upload_bucket_rate: float = 0.0
    upload_bucket_burst: int = 0
    aggregate_bucket_rate: float = 0.0
    aggregate_bucket_burst: int = 0
    # first entry sheds first as pipeline occupancy rises
    shed_priority: tuple[str, ...] = ("upload", "aggregate")
    # occupancy fraction at which the first priority class sheds
    queue_high_watermark: float = 0.75
    # Retry-After for queue-pressure sheds (bucket sheds compute the
    # exact refill time instead)
    shed_retry_after_s: float = 1.0


class AdmissionController:
    """Evaluates both admission signals for one route class.

    `depth_fn() -> (in_flight, bound)` reports the ingest pipeline's
    occupancy; the controller derives per-class watermarks from the
    configured shed priority."""

    def __init__(self, cfg: AdmissionConfig, depth_fn=None, supervisor_fn=None):
        self.cfg = cfg
        self._depth_fn = depth_fn
        # optional datastore supervisor accessor: while the datastore is
        # not up, the aggregate-step routes, whose handlers go straight
        # into datastore transactions, shed 503 up front
        self._supervisor_fn = supervisor_fn or (lambda: None)
        self._buckets: dict[str, TokenBucket] = {}
        if cfg.upload_bucket_rate > 0:
            self._buckets["upload"] = TokenBucket(
                cfg.upload_bucket_rate, cfg.upload_bucket_burst or cfg.upload_bucket_rate
            )
        if cfg.aggregate_bucket_rate > 0:
            self._buckets["aggregate"] = TokenBucket(
                cfg.aggregate_bucket_rate,
                cfg.aggregate_bucket_burst or cfg.aggregate_bucket_rate,
            )
        # watermarks spaced across [high_watermark, 1.0) in shed order:
        # with the default priority and high=0.75, uploads shed at 75%
        # occupancy and aggregate steps at 87.5%
        n = max(1, len(cfg.shed_priority))
        hw = min(max(cfg.queue_high_watermark, 0.0), 1.0)
        self._watermarks = {
            cls: hw + (1.0 - hw) * i / n for i, cls in enumerate(cfg.shed_priority)
        }

    def watermark(self, route_class: str) -> float | None:
        return self._watermarks.get(route_class)

    def admit(self, route_class: str, deadline: float | None = None) -> None:
        """Raise ShedError if this request must be refused.

        `deadline`: the caller's propagated budget as an absolute
        time.monotonic() value (core.deadline.parse_header, already
        backdated by the time the request sat in the accept queue).
        Work whose budget died in transit or while queued sheds 503
        before any HPKE or datastore cost."""
        if deadline is not None and time.monotonic() >= deadline:
            raise ShedError(
                route_class,
                "deadline_expired",
                self.cfg.shed_retry_after_s,
                status=503,
            )
        if route_class == "aggregate":
            supervisor = self._supervisor_fn()
            if supervisor is not None and supervisor.state != "up":
                raise ShedError(
                    route_class,
                    f"datastore_{supervisor.state}",
                    supervisor.reconnect_delay_s(),
                    status=503,
                )
        wm = self._watermarks.get(route_class)
        if wm is not None and self._depth_fn is not None:
            depth, bound = self._depth_fn()
            if bound > 0 and depth >= wm * bound:
                raise ShedError(route_class, "queue", self.cfg.shed_retry_after_s)
        bucket = self._buckets.get(route_class)
        if bucket is not None:
            wait = bucket.try_acquire()
            if wait > 0:
                # never advertise a zero-second retry: a refill window
                # shorter than the clock tick still needs a 1s nudge
                raise ShedError(route_class, "rate", max(wait, 1.0))
