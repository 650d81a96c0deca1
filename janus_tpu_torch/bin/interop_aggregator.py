"""Interop-API aggregator binary: a full DAP aggregator and in-process job
runners behind the interop test API (reference
interop_binaries/src/bin/janus_interop_aggregator.rs:121-160), serving on
--device (CUDA unless it names another)."""

from __future__ import annotations

import argparse
import os
import secrets
import sys
import tempfile
import time

from ..core.time_util import RealClock
from ..datastore.store import Crypter, open_datastore
from ..interop import InteropAggregator
from ..trace import install_trace_subscriber


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="DAP interop test aggregator")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--database", default="", help="datastore path (default: fresh temp file)")
    parser.add_argument(
        "--datastore-keys",
        default=os.environ.get("DATASTORE_KEYS", ""),
        help="comma-separated base64url AES-128 keys; required with --database",
    )
    parser.add_argument("--device", default=None, help="the engines' device (default: CUDA)")
    args = parser.parse_args(argv)
    install_trace_subscriber()

    if args.datastore_keys:
        from ..binary_utils import parse_datastore_keys

        keys = parse_datastore_keys(args.datastore_keys)
    elif args.database:
        raise SystemExit(
            "--datastore-keys (or DATASTORE_KEYS) is required with a persistent "
            "--database: a random per-process key cannot decrypt existing rows"
        )
    else:
        keys = [secrets.token_bytes(16)]  # ephemeral DB, ephemeral key
    db = args.database or os.path.join(tempfile.mkdtemp(prefix="interop_"), "ds.sqlite")
    ds = open_datastore(db, Crypter(keys), RealClock())
    agg = InteropAggregator(ds, device=args.device)
    srv = agg.server(host="0.0.0.0", port=args.port).start()
    agg.start_job_runners()
    print(f"interop aggregator listening on {srv.url} (db {db}, device {agg.device})", flush=True)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        agg.stop()
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
