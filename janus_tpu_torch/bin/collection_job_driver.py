"""Collection job driver process.

Equivalent of reference aggregator/src/bin/collection_job_driver.rs:
drives leader collection jobs (compute the aggregate share, fetch the
helper's encrypted share, finish the job).
"""

from __future__ import annotations

import logging

from ..aggregator.collection_job_driver import CollectionJobDriver, CollectionJobDriverConfig
from ..aggregator.health_sampler import HealthSampler, artifact_paths_from_config
from ..aggregator.job_driver import JobDriver
from ..aggregator.peer_health import default_tracker
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
    driver = CollectionJobDriver(
        ds,
        # per-attempt timeout, body budget and size cap from `helper_http:`
        # (the overall budget is the lease deadline)
        cfg.helper_http.build(),
        CollectionJobDriverConfig(
            maximum_attempts_before_failure=cfg.job_driver.maximum_attempts_before_failure,
            circuit_breaker=cfg.outbound_circuit_breaker,
        ),
        stopper=stopper,
        peer_health=tracker if cfg.peer_health.enabled else None,
    )
    jd = JobDriver(
        cfg.job_driver,
        # fleet sharding and replica provenance on every claim
        driver.acquirer(cfg.job_driver.worker_lease_duration_s, fleet=cfg.common.fleet),
        driver.stepper,
        stopper,
        releaser=driver.release_on_drain,
    )
    # the conservation ledger's evaluation rides the sampler, and the
    # installed evaluator also runs this driver's reconciliation with the
    # helper after each finished collection
    ledger_ev = install_ledger(ds, cfg.common.ledger)
    sampler = None
    if cfg.common.health_sampler_interval_s > 0:
        sampler = HealthSampler(
            ds,
            cfg.common.health_sampler_interval_s,
            artifact_paths=artifact_paths_from_config(cfg.common),
            ledger=ledger_ev,
        ).start()
    try:
        jd.run()
    finally:
        tracker.stop()
        if sampler is not None:
            sampler.stop()
    log.info("collection job driver shut down")


def main(argv=None):
    return janus_main("DAP collection job driver", JobDriverBinaryConfig, run, argv)


if __name__ == "__main__":
    main()
