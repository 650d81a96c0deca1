"""DAP aggregator HTTP server.

Equivalent of reference aggregator/src/bin/aggregator.rs:29-110: the DAP
router on `listen_address`, an optional aggregator API listener on a
second address, and an optional in-process GC loop, serving on the
devices of the configuration.
"""

from __future__ import annotations

import logging
import threading

from ..aggregator.core import Aggregator
from ..aggregator.garbage_collector import GarbageCollector
from ..aggregator.health_sampler import HealthSampler, artifact_paths_from_config
from ..aggregator.http_handlers import DapHttpApp, DapServer
from ..binary_utils import _split_hostport, janus_main
from ..config import AggregatorConfig
from ..core.time_util import RealClock
from ..ledger import install_ledger

log = logging.getLogger(__name__)


def run(cfg: AggregatorConfig, ds, stopper):
    clock = RealClock()
    aggregator = Aggregator(ds, clock, cfg.protocol_config(), devices=cfg.common.devices())
    host, port = _split_hostport(cfg.listen_address)
    server = DapServer(
        DapHttpApp(aggregator),
        host=host,
        port=port,
        max_handler_threads=cfg.max_handler_threads,
    ).start()
    log.info(
        "DAP server listening on %s (handler threads <= %d, ingest queue depth %d)",
        server.url,
        cfg.max_handler_threads,
        cfg.ingest_queue_depth,
    )

    api_server = None
    if cfg.aggregator_api_listen_address:
        from ..aggregator_api import AggregatorApi, AggregatorApiServer

        api_host, api_port = _split_hostport(cfg.aggregator_api_listen_address)
        api = AggregatorApi(ds, auth_tokens=cfg.aggregator_api_auth_tokens)
        api_server = AggregatorApiServer(api, host=api_host, port=api_port).start()
        log.info("aggregator API listening on %s", api_server.url)

    gc = GarbageCollector(ds, clock) if cfg.garbage_collection_interval_s else None

    # the conservation ledger: its evaluation rides the health sampler;
    # /debug/ledger and the `ledger` statusz section read the installed
    # evaluator
    ledger_ev = install_ledger(ds, cfg.common.ledger)

    sampler = None
    if cfg.common.health_sampler_interval_s > 0:
        sampler = HealthSampler(
            ds,
            cfg.common.health_sampler_interval_s,
            artifact_paths=artifact_paths_from_config(cfg.common, cfg),
            gc=gc,
            ledger=ledger_ev,
        ).start()

    gc_thread = None
    if gc is not None:

        def gc_loop():
            while not stopper.stopped:
                try:
                    gc.run_once()
                except Exception:
                    log.exception("garbage collection pass failed")
                stopper.wait(cfg.garbage_collection_interval_s)

        gc_thread = threading.Thread(target=gc_loop, name="gc-loop", daemon=True)
        gc_thread.start()

    try:
        while not stopper.stopped:
            stopper.wait(1.0)
    finally:
        server.stop()  # also drains the ingest pipeline (DapHttpApp.close)
        if sampler is not None:
            sampler.stop()
        if api_server is not None:
            api_server.stop()
        # flush the uploads still buffered in the group-commit writer and
        # stop the journal replayer: a graceful shutdown drops no admitted
        # report (journaled ones replay on the next boot)
        aggregator.close()
    log.info("aggregator shut down")


def main(argv=None):
    return janus_main("DAP aggregator server", AggregatorConfig, run, argv)


if __name__ == "__main__":
    main()
