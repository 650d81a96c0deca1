"""Aggregation job driver process (the leader's hot path).

Equivalent of reference aggregator/src/bin/aggregation_job_driver.rs:
the generic JobDriver loop over the AggregationJobDriver's acquirer and
stepper, on the devices of the configuration.
"""

from __future__ import annotations

import logging

from ..aggregator.aggregation_job_driver import (
    AggregationJobDriver,
    AggregationJobDriverConfig,
    ResidentFlusher,
)
from ..aggregator.health_sampler import HealthSampler, artifact_paths_from_config
from ..aggregator.job_driver import JobDriver
from ..aggregator.peer_health import default_tracker
from ..aggregator.step_pipeline import StepPipeline
from ..binary_utils import janus_main
from ..config import JobDriverBinaryConfig
from ..core.circuit_breaker import default_breakers
from ..ledger import install_ledger

log = logging.getLogger(__name__)


def run(cfg: JobDriverBinaryConfig, ds, stopper):
    # peer-outage parking and background half-open probing, over the
    # process-wide breaker registry the driver below shares
    tracker = default_tracker(default_breakers(cfg.outbound_circuit_breaker), cfg.peer_health)
    tracker.start()
    driver = AggregationJobDriver(
        ds,
        # per-attempt timeout, body budget and size cap from `helper_http:`
        # (the overall budget stays the lease deadline)
        cfg.helper_http.build(),
        AggregationJobDriverConfig(
            maximum_attempts_before_failure=cfg.job_driver.maximum_attempts_before_failure,
            circuit_breaker=cfg.outbound_circuit_breaker,
            resident=cfg.resident_accumulators,
        ),
        # helper retries in flight observe SIGTERM and step back instead
        # of spending the rest of the lease on a dead peer
        stopper=stopper,
        peer_health=tracker if cfg.peer_health.enabled else None,
        devices=cfg.common.devices(),
    )
    # a step that fails during shutdown releases its lease at once
    # (reacquirable by a surviving replica, attempts kept)
    releaser = driver.release_on_drain
    # the stage-pipelined stepper (read, device lane, HTTP and commit
    # stages); `step_pipeline: {enabled: false}` steps serially
    pipeline = None
    if cfg.step_pipeline.enabled:
        pipeline = StepPipeline(driver, cfg.step_pipeline, stopper=stopper, releaser=releaser)
    jd = JobDriver(
        cfg.job_driver,
        # fleet sharding and replica provenance on every claim
        driver.acquirer(cfg.job_driver.worker_lease_duration_s, fleet=cfg.common.fleet),
        driver.stepper,
        stopper,
        releaser=releaser,
        pipeline=pipeline,
    )
    # the conservation ledger's evaluation rides the sampler
    ledger_ev = install_ledger(ds, cfg.common.ledger)
    sampler = None
    if cfg.common.health_sampler_interval_s > 0:
        sampler = HealthSampler(
            ds,
            cfg.common.health_sampler_interval_s,
            artifact_paths=artifact_paths_from_config(cfg.common),
            ledger=ledger_ev,
        ).start()
    # resident mode: the background flusher bounds an idle driver's
    # unflushed window and flushes a quarantined engine's state
    flusher = None
    if cfg.resident_accumulators.enabled:
        flusher = ResidentFlusher(driver, cfg.resident_accumulators.flush_interval_s).start()
    try:
        jd.run()
    finally:
        tracker.stop()
        if sampler is not None:
            sampler.stop()
        if flusher is not None:
            flusher.stop()
        if pipeline is not None:
            # jd.run() drained the chains in flight; this retires the idle
            # stage workers
            pipeline.close()
        if cfg.resident_accumulators.enabled:
            # the drain: every committed delta is merged (jd.run()
            # returned), so the resident state is flushed through the
            # write transaction before exit
            driver.flush_resident_state(reason="drain")
    log.info("aggregation job driver shut down")


def main(argv=None):
    return janus_main("DAP aggregation job driver", JobDriverBinaryConfig, run, argv)


if __name__ == "__main__":
    main()
