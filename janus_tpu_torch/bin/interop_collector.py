"""Interop-API collector binary (reference
interop_binaries/src/bin/janus_interop_collector.rs)."""

from __future__ import annotations

import argparse
import sys
import time

from ..interop import InteropCollector
from ..trace import install_trace_subscriber


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="DAP interop test collector")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args(argv)
    install_trace_subscriber()
    srv = InteropCollector().server(host="0.0.0.0", port=args.port).start()
    print(f"interop collector listening on {srv.url}", flush=True)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
