"""Generate a DAP HPKE keypair.

Equivalent of reference tools/src/bin/hpke_keygen.rs: emits the
base64url HpkeConfig (shareable with clients/peers) and the base64url
private key (kept secret).
"""

from __future__ import annotations

import argparse
import base64
import sys

from ..core.hpke import generate_hpke_config_and_private_key


def b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="generate a DAP HPKE keypair")
    parser.add_argument("id", type=int, nargs="?", default=0, help="HPKE config id (0-255)")
    args = parser.parse_args(argv)
    if not 0 <= args.id < 256:
        raise SystemExit("config id must be in [0, 255]")
    kp = generate_hpke_config_and_private_key(config_id=args.id)
    print(f"hpke_config: {b64(kp.config.to_bytes())}")
    print(f"private_key: {b64(kp.private_key)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
