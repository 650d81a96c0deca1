"""Full-featured collector CLI.

Equivalent of reference tools/src/bin/collect.rs:59-553: every VDAF
type and both query types, DAP-auth or bearer tokens, HPKE key
material via flags. Prints the report count, interval and aggregate
result.

Examples:
  python -m janus_tpu_torch.tools.collect \
    --task-id <b64> --leader https://leader.example.com/ \
    --vdaf count \
    --authorization-bearer-token tok \
    --hpke-config <b64> --hpke-private-key <b64> \
    --batch-interval-start 1700000000 --batch-interval-duration 3600

  ... --vdaf sumvec --bits 16 --length 100 --current-batch
"""

from __future__ import annotations

import argparse
import base64
import sys

from ..collector import Collector, CollectorParameters
from ..core.auth import AuthenticationToken
from ..core.hpke import HpkeKeypair
from ..core.http_client import HttpClient
from ..messages import (
    BatchId,
    Duration,
    FixedSizeQuery,
    HpkeConfig,
    Interval,
    Query,
    TaskId,
    Time,
)
from ..vdaf.registry import VdafInstance


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="DAP collector (reference tools/collect)")
    p.add_argument("--task-id", required=True, help="base64url task id")
    p.add_argument("--leader", required=True, help="leader endpoint URL")

    auth = p.add_mutually_exclusive_group(required=True)
    auth.add_argument("--authorization-bearer-token", help="collector bearer token")
    auth.add_argument("--dap-auth-token", help="collector DAP-Auth-Token")

    p.add_argument("--hpke-config", required=True, help="base64url collector HpkeConfig")
    p.add_argument("--hpke-private-key", required=True, help="base64url collector private key")

    p.add_argument(
        "--vdaf",
        required=True,
        choices=["count", "countvec", "sum", "sumvec", "histogram", "fixedpoint16vec", "fixedpoint32vec", "fixedpoint64vec"],
    )
    p.add_argument("--bits", type=int, help="bit width (sum, sumvec)")
    p.add_argument("--length", type=int, help="vector length / bucket count")

    q = p.add_mutually_exclusive_group(required=True)
    q.add_argument("--batch-interval-start", type=int, help="time-interval query start (s)")
    q.add_argument("--current-batch", action="store_true", help="fixed-size: current batch")
    q.add_argument("--batch-id", help="fixed-size: base64url batch id")
    p.add_argument("--batch-interval-duration", type=int, help="time-interval query duration (s)")
    p.add_argument(
        "--timeout",
        type=float,
        default=600.0,
        help="seconds to poll before giving up (first aggregation can be slow)",
    )
    return p


def vdaf_from_args(args) -> VdafInstance:
    if args.vdaf == "count":
        return VdafInstance.count()
    if args.vdaf == "countvec":
        if args.length is None:
            raise SystemExit("--length is required for countvec")
        return VdafInstance.count_vec(length=args.length)
    if args.vdaf == "sum":
        if args.bits is None:
            raise SystemExit("--bits is required for sum")
        return VdafInstance.sum(bits=args.bits)
    if args.vdaf == "sumvec":
        if args.bits is None or args.length is None:
            raise SystemExit("--bits and --length are required for sumvec")
        return VdafInstance.sum_vec(length=args.length, bits=args.bits)
    if args.vdaf == "histogram":
        if args.length is None:
            raise SystemExit("--length is required for histogram")
        return VdafInstance.histogram(length=args.length)
    if args.vdaf.startswith("fixedpoint"):
        if args.length is None:
            raise SystemExit("--length is required for fixed-point vectors")
        bits = int(args.vdaf.removeprefix("fixedpoint").removesuffix("vec"))
        return VdafInstance.fixed_point_vec(length=args.length, bits=bits)
    raise SystemExit(f"unknown vdaf {args.vdaf}")


def query_from_args(args) -> Query:
    if args.batch_interval_start is not None:
        if args.batch_interval_duration is None:
            raise SystemExit("--batch-interval-duration is required with --batch-interval-start")
        return Query.time_interval(
            Interval(Time(args.batch_interval_start), Duration(args.batch_interval_duration))
        )
    if args.current_batch:
        return Query.fixed_size(FixedSizeQuery(FixedSizeQuery.CURRENT_BATCH))
    return Query.fixed_size(
        FixedSizeQuery(FixedSizeQuery.BY_BATCH_ID, BatchId(_unb64(args.batch_id)))
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    vdaf = vdaf_from_args(args)  # validate VDAF/query args before key material
    query = query_from_args(args)
    if args.authorization_bearer_token:
        token = AuthenticationToken.bearer(args.authorization_bearer_token)
    else:
        token = AuthenticationToken.dap_auth(args.dap_auth_token)
    try:
        keypair = HpkeKeypair(
            HpkeConfig.from_bytes(_unb64(args.hpke_config)), _unb64(args.hpke_private_key)
        )
        task_id = TaskId(_unb64(args.task_id))
    except Exception as e:
        raise SystemExit(f"bad key material or task id: {e}")
    params = CollectorParameters(task_id, args.leader, token, keypair)
    collector = Collector(params, vdaf, HttpClient())
    result = collector.collect(query, timeout_s=args.timeout)
    if result.partial_batch_selector is not None:
        bid = base64.urlsafe_b64encode(result.partial_batch_selector.batch_id.data)
        print(f"Batch: {bid.decode().rstrip('=')}")
    print(f"Number of reports: {result.report_count}")
    print(f"Interval: [{result.interval.start.seconds}, +{result.interval.duration.seconds}s)")
    print(f"Aggregation result: {result.aggregate_result}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
