"""Generic lease-based job driver loop.

Equivalent of reference aggregator/src/binary_utils/job_driver.rs:25-260:
acquire a batch of leases, step each job on a bounded worker pool,
rediscover with an adaptive delay, drain cleanly on shutdown.

The port's own copy of janus_tpu/aggregator/job_driver.py, with the
datastore outage handling: the acquirers park while the datastore
supervisor reports down and absorb connection-class failures, and a
step that loses the datastore steps back by the supervisor's reconnect
delay; with a `peer_gate` (aggregator/peer_health.py) they park while
every helper's circuit is open. A JobDriver given a stage pipeline
(`aggregator/step_pipeline.py`) hands it every leased job. It leaves out
the fleet claim metrics (`record_acquire`) and the fleet shard predicate,
the `job.step` trace span and the serial stepper's drain releaser (the
pipeline has its own).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass

from ..core.deadline import DeadlineExceeded

log = logging.getLogger(__name__)


@dataclass
class JobDriverConfig:
    """reference aggregator/src/config.rs:121-141."""

    job_discovery_interval_s: float = 0.2
    max_job_discovery_interval_s: float = 5.0
    max_concurrent_job_workers: int = 4
    # fractional jitter applied to every discovery sleep
    discovery_jitter: float = 0.25


def lease_deadline(clock, lease, skew_s: int) -> float:
    """time.monotonic() bound for one job step's work: lease remaining
    minus clock skew (reference job_driver.rs:191-196), so a stuck helper
    cannot outlive the lease and run the job concurrently with its
    re-acquirer. A lease shorter than twice the skew keeps half its
    remaining time instead; the 1 s floor never extends past the lease.
    An already-expired lease raises DeadlineExceeded (a step-back)."""
    remaining = lease.expiry.seconds - clock.now().seconds
    if remaining <= 0:
        raise DeadlineExceeded(
            f"lease already expired {-remaining}s ago; stepping back, not dialing"
        )
    bound = remaining - skew_s if remaining > 2 * skew_s else remaining / 2
    return time.monotonic() + max(min(1.0, remaining), bound)


def deadline_request_timeout(
    deadline: float | None, attempt_cap_s: float | None = None
) -> float | None:
    """Per-attempt socket timeout capped to the remaining deadline (and to
    `attempt_cap_s`). A deadline already in the past raises
    DeadlineExceeded."""
    cap = None
    if deadline is not None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise DeadlineExceeded("request budget exhausted before the attempt")
        cap = remaining
    if attempt_cap_s is not None:
        cap = attempt_cap_s if cap is None else min(cap, attempt_cap_s)
    return cap


def datastore_down(ds) -> bool:
    """True while the datastore supervisor reports a hard outage: both
    drivers' acquirers park instead of burning an acquire (and a lease
    attempt on every job the claim would take) into a dead database."""
    supervisor = getattr(ds, "supervisor", None)
    return supervisor is not None and supervisor.state == "down"


def make_claim_acquirer(ds, claim_fn, peer_gate=None):
    """Shared acquirer body: run `claim_fn(limit)` (the datastore claim
    run_tx) through the outage-tolerant wrapper.

    `peer_gate` is the peer-outage analog of the supervisor park: a
    callable that is True while every known helper's circuit is open. A
    parked pass returns [] without running the claim transaction: a helper
    down for minutes must not have the driver claim jobs it cannot step."""

    def acquire(limit: int):
        if peer_gate is not None and peer_gate():
            return []
        return acquire_tolerating_outage(ds, lambda: claim_fn(limit))

    return acquire


def acquire_tolerating_outage(ds, acquire_tx):
    """Park (return []) while the supervisor reports down, absorb a
    connection-class acquire failure as 'no jobs this pass' (the
    discovery loop is the recovery mechanism), and re-raise everything
    else: a fatal error retried forever would be a silent stall."""
    if datastore_down(ds):
        return []
    try:
        return acquire_tx()
    except Exception as e:
        if is_datastore_connection_error(ds, e):
            log.warning(
                "job acquisition failed (datastore connection lost); "
                "backing off before rediscovery"
            )
            return []
        raise


def datastore_reconnect_delay_s(ds, default: float = 5.0) -> float:
    """Step-back delay of a step that lost its datastore: the
    supervisor's reconnect cooldown when supervised, `default` otherwise."""
    supervisor = getattr(ds, "supervisor", None)
    return supervisor.reconnect_delay_s() if supervisor is not None else default


def is_datastore_connection_error(ds, e: BaseException) -> bool:
    """Classify an exception as a datastore connection loss (tolerant of
    test doubles without a classifier)."""
    classify = getattr(ds, "classify_error", None)
    return classify is not None and classify(e) == "connection"


class Stopper:
    """Cooperative shutdown flag (reference uses trillium Stopper)."""

    def __init__(self):
        self._event = threading.Event()

    def stop(self) -> None:
        self._event.set()

    @property
    def stopped(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float) -> None:
        self._event.wait(timeout)


class JobDriver:
    """reference job_driver.rs:103 (run loop).

    acquirer(limit) -> list of acquired jobs;
    stepper(acquired) -> None (owns release/cancel).
    """

    def __init__(
        self,
        cfg: JobDriverConfig,
        acquirer,
        stepper,
        stopper: Stopper | None = None,
        pipeline=None,
    ):
        self.cfg = cfg
        self.acquirer = acquirer
        self.stepper = stepper
        self.stopper = stopper or Stopper()
        # a stage pipeline (aggregator/step_pipeline.py) takes every
        # leased job through pipeline.submit(acquired); its futures
        # resolve when the step has completed (it owns the error mapping
        # and the drain release), so the worker accounting is unchanged
        self.pipeline = pipeline

    def _submit(self, pool, acquired):
        if self.pipeline is not None:
            return self.pipeline.submit(acquired)
        return pool.submit(self._step_one, acquired)

    def run_once(self) -> int:
        """One acquire+step pass (barrier semantics: tests and one-shot
        tools); returns the number of jobs stepped."""
        jobs = self.acquirer(self.cfg.max_concurrent_job_workers)
        if not jobs:
            return 0
        with ThreadPoolExecutor(max_workers=self.cfg.max_concurrent_job_workers) as pool:
            wait([self._submit(pool, j) for j in jobs])
        return len(jobs)

    def _step_one(self, acquired) -> None:
        try:
            self.stepper(acquired)
        except Exception:
            log.exception("job step failed (lease will expire and retry)")

    def run(self) -> None:
        """Streaming discovery loop until stopped: acquire as worker
        permits free, so one slow job never idles the rest of the pool."""
        delay = self.cfg.job_discovery_interval_s
        jitter = min(0.9, max(0.0, float(self.cfg.discovery_jitter)))
        in_flight: set = set()
        with ThreadPoolExecutor(max_workers=self.cfg.max_concurrent_job_workers) as pool:
            while not self.stopper.stopped:
                in_flight = {f for f in in_flight if not f.done()}
                free = self.cfg.max_concurrent_job_workers - len(in_flight)
                n = 0
                if free > 0:
                    jobs = self.acquirer(free)
                    n = len(jobs)
                    for j in jobs:
                        in_flight.add(self._submit(pool, j))
                if n > 0:
                    delay = self.cfg.job_discovery_interval_s
                else:
                    delay = min(delay * 2, self.cfg.max_job_discovery_interval_s)
                sleep = delay * random.uniform(1.0 - jitter, 1.0 + jitter)
                if in_flight:
                    wait(in_flight, timeout=sleep, return_when=FIRST_COMPLETED)
                else:
                    self.stopper.wait(sleep)
            # shutdown: drain in-flight steps (job_driver.rs:124-142)
            if in_flight:
                wait(in_flight)
