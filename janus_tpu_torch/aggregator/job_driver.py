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
(`aggregator/step_pipeline.py`) hands it every leased job.

Fleet sharding: `make_claim_acquirer(shard=)` classifies every claim
transaction's jobs (`record_acquire`: own, stolen from another replica's
shard past the steal fence, or handed back by a draining replica) and
keeps the counts in the acquirer's `status()`, and feeds janus_tpu's
lease_acquire_tx_total, lease_acquired_jobs_total and lease_steals_total
(labelled by replica once a fleet identity is set:
metrics.set_replica_identity, from the drivers' `acquirer(fleet=)`). A
JobDriver given a `releaser` hands back at once the lease of a step that
fails while it is stopped. Every serial step runs under a `job.step`
span.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass

from .. import metrics
from ..core.deadline import DeadlineExceeded
from ..datastore.store import job_shard_key

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


def record_acquire(kind: str, jobs, shard=None) -> dict:
    """The fleet claim counts of one claim transaction: its outcome
    (claimed or empty), the jobs leased, and, with an active shard
    predicate, how many were stolen from another replica's shard (the
    steal-after-delay fallback draining a dead peer). A job whose stored
    shard_key is negative was handed back by a draining replica: claimed
    across shards at once by design and never a steal, so a routine
    rolling restart does not read as a starving shard; those are counted
    as `handbacks`. The shard index is reduced modulo the count first, as
    the claim's SQL does. Called after run_tx returned (a busy-retried
    attempt must not count twice), and only when a claim transaction ran.
    Returns {"outcome", "jobs", "steals", "handbacks"}; `kind` names the
    job type, as janus_tpu's metric label does."""
    out = {"outcome": "claimed" if jobs else "empty", "jobs": len(jobs), "steals": 0, "handbacks": 0}
    for a in jobs:
        sk = a.shard_key
        if sk is None:  # an acquired job built without its stored key
            sk = job_shard_key(a.task_id.data, _job_id_of(a).data)
        if sk < 0:
            out["handbacks"] += 1
        elif shard is not None and shard.active and sk % shard.shard_count != shard.shard_index % shard.shard_count:
            out["steals"] += 1
    labels = metrics.replica_labels()
    metrics.lease_acquire_tx_total.add(kind=kind, outcome=out["outcome"], **labels)
    if jobs:
        metrics.lease_acquired_jobs_total.add(len(jobs), kind=kind, **labels)
    if out["steals"]:
        metrics.lease_steals_total.add(out["steals"], kind=kind, **labels)
    return out


def _job_id_of(acquired):
    """The job-id field of either acquired-job shape."""
    if hasattr(acquired, "job_id"):
        return acquired.job_id
    return acquired.collection_job_id


class ClaimAcquirer:
    """Shared acquirer body for both drivers: `acquirer(limit)` runs
    `claim_fn(limit)` (the datastore claim run_tx) through the
    outage-tolerant wrapper and records the pass's fleet claim counts
    (`record_acquire`) only when a claim transaction ran: a parked or a
    connection-lost pass ran none, and counting it would make up claim
    traffic during the very outages the counts should stay honest
    through. `shard` is the claim's ShardSpec (None: unsharded).

    `peer_gate` is the peer-outage analog of the supervisor park: a
    callable that is True while every known helper's circuit is open. A
    parked pass returns [] without running the claim transaction: a helper
    down for minutes must not have the driver claim jobs it cannot step."""

    def __init__(self, ds, kind: str, claim_fn, shard=None, peer_gate=None):
        self.ds = ds
        self.kind = kind
        self.claim_fn = claim_fn
        self.shard = shard
        self.peer_gate = peer_gate
        self._lock = threading.Lock()
        self._claim_tx = {"claimed": 0, "empty": 0}
        self._totals = {"jobs": 0, "steals": 0, "handbacks": 0}

    def __call__(self, limit: int):
        if self.peer_gate is not None and self.peer_gate():
            return []
        ran = False

        def claim_tx():
            nonlocal ran
            out = self.claim_fn(limit)
            ran = True
            return out

        jobs = acquire_tolerating_outage(self.ds, claim_tx)
        if ran:
            counts = record_acquire(self.kind, jobs, self.shard)
            with self._lock:
                self._claim_tx[counts["outcome"]] += 1
                for k in self._totals:
                    self._totals[k] += counts[k]
        return jobs

    def status(self) -> dict:
        """{"kind", "shard": {count, index, steal_after_s} or None,
        "claim_tx": {"claimed", "empty"}, "jobs", "steals", "handbacks"}."""
        shard = self.shard
        with self._lock:
            return {
                "kind": self.kind,
                "shard": None if shard is None else {"count": shard.shard_count,
                                                     "index": shard.shard_index % shard.shard_count,
                                                     "steal_after_s": shard.steal_after_s},
                "claim_tx": dict(self._claim_tx),
                **self._totals,
            }


def make_claim_acquirer(ds, kind: str, claim_fn, shard=None, peer_gate=None) -> ClaimAcquirer:
    """The acquirer of a `kind` ("aggregation" or "collection") driver; see
    ClaimAcquirer."""
    return ClaimAcquirer(ds, kind, claim_fn, shard, peer_gate)


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
        releaser=None,
        pipeline=None,
    ):
        self.cfg = cfg
        self.acquirer = acquirer
        self.stepper = stepper
        self.stopper = stopper or Stopper()
        # releaser(acquired): called when a step fails while the stopper
        # is stopped (a shutdown drain), so the lease goes back at once
        # instead of aging out a whole TTL before a surviving replica takes
        # it (the drivers pass their `release_on_drain`)
        self.releaser = releaser
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
        from ..trace import span

        try:
            with span("job.step", job=type(acquired).__name__):
                self.stepper(acquired)
        except Exception:
            if self.stopper.stopped and self.releaser is not None:
                # shutdown drain: this process will not retry
                log.exception("job step failed during shutdown; releasing lease")
                try:
                    self.releaser(acquired)
                except Exception:
                    log.exception("shutdown lease release failed")
            else:
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
