"""Aggregation job creator process.

Equivalent of reference aggregator/src/bin/aggregation_job_creator.rs:
periodically packs unaggregated reports into aggregation jobs
(aggregation_job_creator.rs:87 run / :154 update_tasks).
"""

from __future__ import annotations

import logging

from ..aggregator.aggregation_job_creator import AggregationJobCreator
from ..binary_utils import janus_main
from ..config import JobCreatorConfig

log = logging.getLogger(__name__)


def run(cfg: JobCreatorConfig, ds, stopper):
    # the fleet's task-shard preference: own-shard tasks every pass, a
    # foreign shard's task only once its backlog ages past steal_after_secs
    creator = AggregationJobCreator(ds, cfg.creator_config(), fleet=cfg.common.fleet)
    while not stopper.stopped:
        try:
            n = creator.run_once()
            if n:
                log.info("created %d aggregation jobs", n)
        except Exception:
            log.exception("aggregation job creation pass failed")
        stopper.wait(cfg.aggregation_job_creation_interval_s)
    log.info("aggregation job creator shut down")


def main(argv=None):
    return janus_main("DAP aggregation job creator", JobCreatorConfig, run, argv)


if __name__ == "__main__":
    main()
