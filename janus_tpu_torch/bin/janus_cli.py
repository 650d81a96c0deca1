"""Operational CLI.

Equivalent of reference aggregator/src/bin/janus_cli.rs:54-78:
`provision-tasks` loads a YAML (or .json) list of task documents into the
datastore; `create-datastore-key` emits a fresh AES-128 key; `list-tasks`
lists the provisioned tasks. (The reference's kubernetes-secret
integration is deployment glue and is out of scope; keys travel through
flags or the environment.)

`provision-tasks --precompile B,...` warms the tasks' engines at those
batch buckets on `--device` (CUDA unless it names another): the port
compiles nothing ahead, so this is a check that every task's engine runs
on the device, with its seconds a bucket; janus_tpu's
`--compilation-cache-dir` has no counterpart.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import secrets
import sys
import time

from ..binary_utils import parse_datastore_keys
from ..config import load_document
from ..core.time_util import RealClock
from ..datastore.store import Crypter, open_datastore
from ..task import Task
from ..trace import install_trace_subscriber


def cmd_create_datastore_key(args) -> int:
    print(base64.urlsafe_b64encode(secrets.token_bytes(16)).decode().rstrip("="))
    return 0


def _open_datastore(args):
    raw = args.datastore_keys or os.environ.get("DATASTORE_KEYS", "")
    keys = parse_datastore_keys(raw)
    return open_datastore(args.database, Crypter(keys), RealClock())


def cmd_provision_tasks(args) -> int:
    docs = load_document(args.tasks_file)
    if not isinstance(docs, list):
        raise SystemExit("tasks file must be a YAML list of task documents")
    tasks = [Task.from_dict(d) for d in docs]
    if not args.dry_run:  # dry-run parses and validates only, touching no DB
        if not args.database:
            raise SystemExit("--database is required unless --dry-run")
        ds = _open_datastore(args)
        try:

            def tx_fn(tx):
                for task in tasks:
                    tx.put_task(task)

            ds.run_tx(tx_fn, "provision_tasks")
            if args.precompile:
                _precompile(args, ds)
        finally:
            ds.close()
    out = [{"task_id": base64.urlsafe_b64encode(t.task_id.data).decode().rstrip("=")} for t in tasks]
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


def _precompile(args, ds) -> None:
    """Warm the provisioned tasks' engines on the device at each bucket."""
    from ..binary_utils import warmup_engines
    from ..device import resolve_device

    device = resolve_device(args.device)
    buckets = [int(b) for b in str(args.precompile).split(",") if b]
    for b in sorted(buckets):
        t0 = time.time()
        warmup_engines(ds, batch=b, devices=(device,))
        print(f"warmed bucket {b} on {device} ({time.time() - t0:.1f}s)", file=sys.stderr)


def cmd_list_tasks(args) -> int:
    ds = _open_datastore(args)
    try:
        tasks = ds.run_tx(lambda tx: tx.get_tasks(), "list_tasks")
        for t in tasks:
            tid = base64.urlsafe_b64encode(t.task_id.data).decode().rstrip("=")
            print(f"{tid} role={t.role.name.lower()} vdaf={t.vdaf.kind}")
    finally:
        ds.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="janus_cli", description="Janus-TPU ops CLI")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("create-datastore-key", help="generate a datastore AES-128 key")

    def add_ds_args(p):
        p.add_argument("--database", required=True, help="datastore path")
        p.add_argument("--datastore-keys", default="", help="comma-separated base64url keys (or DATASTORE_KEYS env)")

    pt = sub.add_parser("provision-tasks", help="load tasks from a YAML file")
    pt.add_argument("tasks_file", help="YAML (or .json) list of task documents")
    pt.add_argument("--dry-run", action="store_true", help="parse and validate only")
    pt.add_argument("--database", default="", help="datastore path (unused with --dry-run)")
    pt.add_argument("--datastore-keys", default="", help="comma-separated base64url keys (or DATASTORE_KEYS env)")
    pt.add_argument(
        "--precompile",
        default="",
        metavar="BUCKETS",
        help="warm the tasks' engines at these comma-separated batch buckets (e.g. 32,512) on --device",
    )
    pt.add_argument("--device", default=None, help="device of --precompile (default: CUDA)")

    lt = sub.add_parser("list-tasks", help="list provisioned tasks")
    add_ds_args(lt)
    return parser


def main(argv=None) -> int:
    install_trace_subscriber()
    args = build_parser().parse_args(argv)
    if args.command == "create-datastore-key":
        return cmd_create_datastore_key(args)
    if args.command == "provision-tasks":
        return cmd_provision_tasks(args)
    if args.command == "list-tasks":
        return cmd_list_tasks(args)
    raise SystemExit(2)


if __name__ == "__main__":
    sys.exit(main())
