"""Interop-API client binary (reference
interop_binaries/src/bin/janus_interop_client.rs)."""

from __future__ import annotations

import argparse
import sys
import time

from ..interop import InteropClient
from ..trace import install_trace_subscriber


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="DAP interop test client")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args(argv)
    install_trace_subscriber()
    srv = InteropClient().server(host="0.0.0.0", port=args.port).start()
    print(f"interop client listening on {srv.url}", flush=True)
    try:
        while True:
            time.sleep(5)
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
