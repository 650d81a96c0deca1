""""Where did report X go" — trace one report through the pipeline.

    python -m janus_tpu_torch.tools.report_trace \\
        --db /var/janus/ds.sqlite --task-id=<b64url> --report-id=<b64url> \\
        [--journal-dir /var/janus/journal] [--datastore-keys k1,k2] [--json]

(Pass the ids as `--opt=value`: a base64url id may begin with "-".)

The conservation ledger (janus_tpu_torch/ledger.py; GET /debug/ledger) says
HOW MANY reports are unaccounted for per task; this answers WHICH
stage one specific report reached, by joining three sources in one
pass:

- the upload spill journal (admitted-but-not-yet-replayed reports
  survive a datastore outage on disk — a report can be "accepted"
  while absent from every table),
- the datastore (client_reports / report_aggregations + their jobs /
  batch_aggregations covering the report's timestamp), via the same
  single-snapshot query the ledger uses,
- the task's ledger books (counters, in-flight, imbalance) for the
  verdict's context: a report that is nowhere AND books that don't
  balance is a loss; a report that is nowhere with balanced books and
  a nonzero `expired` counter was garbage-collected.

Read-only against the datastore; journal segments are read directly
(never recovered/rotated) so tracing never mutates a live journal.
"""

from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import sys

from ..datastore.store import Crypter, open_datastore
from ..core.time_util import RealClock
from ..messages import PrepareError, ReportId, TaskId


def _b64u(s: str, size: int, what: str) -> bytes:
    s = s.strip()
    try:
        raw = base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))
    except Exception:
        raise SystemExit(f"{what}: not valid base64url: {s!r}")
    if len(raw) != size:
        raise SystemExit(f"{what}: want {size} bytes, got {len(raw)}")
    return raw


def _scan_journal(journal_dir: str, crypter, task_id: TaskId, report_id: ReportId) -> dict:
    """Look for the report among spilled-but-unreplayed journal frames.
    Reads segment files directly — never constructs an UploadJournal,
    which would recover/rotate a live journal out from under its
    owner."""
    from ..ingest import journal as _j

    found = []
    segments = sorted(
        glob.glob(os.path.join(journal_dir, f"{_j._SEGMENT_PREFIX}*{_j._SEGMENT_SUFFIX}"))
    )
    undecodable = 0
    for path in segments:
        payloads, _reason = _j._read_frames(path)
        for payload in payloads:
            try:
                row = _j._decode_row(crypter, payload)
            except Exception:
                # wrong --datastore-keys (or none): frames are encrypted
                # at rest; count, keep scanning — CRC already validated
                undecodable += 1
                continue
            if row.task_id == task_id and row.report_id == report_id:
                found.append(
                    {
                        "segment": os.path.basename(path),
                        "client_time": row.client_time.seconds,
                    }
                )
    return {
        "dir": journal_dir,
        "segments_scanned": len(segments),
        "undecodable_frames": undecodable,
        "found": found,
    }


def _verdict(trace: dict, journal: dict | None, books: dict | None) -> str:
    ras = trace["report_aggregations"]
    terminal = [ra for ra in ras if ra["state"] in ("finished", "failed")]
    if terminal:
        ra = terminal[-1]
        if ra["state"] == "finished":
            collected = [b for b in trace["batch_aggregations"] if b["state"] == "collected"]
            if collected:
                return (
                    f"AGGREGATED and COLLECTED: finished in job {ra['job_id'][:16]}…; "
                    f"{len(collected)} covering batch shard(s) already collected"
                )
            return (
                f"AGGREGATED, awaiting collection: finished in job {ra['job_id'][:16]}…; "
                "its batch shards are not collected yet"
            )
        err = ra["prepare_error"]
        name = PrepareError(err).name.lower() if err is not None else "unknown"
        return f"REJECTED ({name}) in job {ra['job_id'][:16]}… — terminal, counted in the ledger's rejected:{name} lane"
    live = [ra for ra in ras if ra["job_state"] == "in_progress"]
    if live:
        ra = live[-1]
        return (
            f"IN FLIGHT: state {ra['state']!r} in job {ra['job_id'][:16]}… "
            f"(job step {ra['job_step']}, {ra['job_attempts']} attempt(s))"
        )
    if trace["client_report"] is not None:
        if ras:
            # claimed by jobs that are all abandoned/gone: back in the
            # unclaimed pool (mark_reports_unaggregated) or wedged
            return (
                "CLAIMED but every claiming job is no longer in progress — "
                "either re-queued for a fresh job or wedged (ledger imbalance will say which)"
            )
        if trace["client_report"]["aggregation_started"]:
            return "CLAIMED (aggregation_started) but no report_aggregations row — claim tx landed, job creation did not (in the creator's grace window)"
        return "ADMITTED, awaiting aggregation (unclaimed in client_reports)"
    if journal and journal["found"]:
        return (
            "SPILLED: accepted into the upload journal, not yet replayed into the "
            "datastore (outage spill; the replayer will admit it)"
        )
    hints = []
    if books:
        if (books.get("imbalance") or {}).get("ingest"):
            hints.append(
                f"task ingest imbalance is {books['imbalance']['ingest']} — consistent with a LOST report"
            )
        if books.get("expired"):
            hints.append(f"task has {books['expired']} expired report(s) — may have been GC'd")
    return "NOT FOUND in journal or datastore" + (": " + "; ".join(hints) if hints else " (expired/GC'd, never admitted, or lost)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="trace one report through the pipeline")
    parser.add_argument("--db", required=True, help="database URL (postgres://…) or SQLite path")
    parser.add_argument("--task-id", required=True, help="base64url task id")
    parser.add_argument("--report-id", required=True, help="base64url report id")
    parser.add_argument("--journal-dir", help="upload journal directory to scan for spilled frames")
    parser.add_argument(
        "--datastore-keys",
        help="comma-separated base64url AES keys (only needed to decode journal frames)",
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    task_id = TaskId(_b64u(args.task_id, 32, "--task-id"))
    report_id = ReportId(_b64u(args.report_id, 16, "--report-id"))
    keys = [
        base64.urlsafe_b64decode(k.strip() + "=" * (-len(k.strip()) % 4))
        for k in (args.datastore_keys or "").split(",")
        if k.strip()
    ]
    crypter = Crypter(keys) if keys else Crypter()

    ds = open_datastore(args.db, crypter, RealClock())
    # one snapshot: the per-report drill-down and the task's books from
    # the same transaction the ledger itself reads
    def read(tx):
        return (
            tx.ledger_report_trace(task_id, report_id),
            tx.get_task_counters(task_id),
            tx.ledger_inflight_by_task().get(task_id.data, {}),
        )

    trace, counters, inflight = ds.run_tx(read, "report_trace")

    from .. import ledger as _ledger

    rejected = {
        k[len(_ledger.REJECTED_PREFIX):]: v
        for k, v in counters.items()
        if k.startswith(_ledger.REJECTED_PREFIX)
    }
    rejected_param = {
        k[len(_ledger.REJECTED_PARAM_PREFIX):]: v
        for k, v in counters.items()
        if k.startswith(_ledger.REJECTED_PARAM_PREFIX)
    }
    books = {
        "admitted": counters.get(_ledger.ADMITTED, 0),
        "aggregated": counters.get(_ledger.AGGREGATED, 0),
        "collected": counters.get(_ledger.COLLECTED, 0),
        "expired": counters.get(_ledger.EXPIRED, 0),
        "lost": counters.get(_ledger.LOST, 0),
        "rejected": rejected,
        "param": {
            "admitted": counters.get(_ledger.ADMITTED_PARAM, 0),
            "aggregated": counters.get(_ledger.AGGREGATED_PARAM, 0),
            "rejected": rejected_param,
            "expired": counters.get(_ledger.EXPIRED_PARAM, 0),
        },
        "in_flight": inflight,
        # the same three balance equations the evaluator exports
        # (janus_tpu_torch/ledger.py): param fanout keeps its own lane, and
        # collect drains both lanes' mass through batch_aggregations
        "imbalance": {
            "ingest": counters.get(_ledger.ADMITTED, 0)
            - counters.get(_ledger.AGGREGATED, 0)
            - sum(rejected.values())
            - counters.get(_ledger.EXPIRED, 0)
            - inflight.get("pending_reports", 0)
            - inflight.get("pending_aggregation", 0),
            "param": counters.get(_ledger.ADMITTED_PARAM, 0)
            - counters.get(_ledger.AGGREGATED_PARAM, 0)
            - sum(rejected_param.values())
            - counters.get(_ledger.EXPIRED_PARAM, 0)
            - inflight.get("pending_aggregation_param", 0),
            "collect": counters.get(_ledger.AGGREGATED, 0)
            + counters.get(_ledger.AGGREGATED_PARAM, 0)
            - counters.get(_ledger.COLLECTED, 0)
            - inflight.get("awaiting_collection", 0),
        },
    }

    journal = None
    if args.journal_dir:
        journal = _scan_journal(args.journal_dir, crypter, task_id, report_id)

    verdict = _verdict(trace, journal, books)
    doc = {
        "task_id": args.task_id,
        "report_id": args.report_id,
        "verdict": verdict,
        "trace": trace,
        "ledger": books,
        "journal": journal,
    }
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    print(f"report {args.report_id} of task {args.task_id}")
    print(f"  verdict: {verdict}")
    cr = trace["client_report"]
    if cr is not None:
        print(
            f"  client_reports: present, client_time {cr['client_time']}, "
            f"aggregation_started {cr['aggregation_started']}"
        )
    else:
        print("  client_reports: absent")
    for ra in trace["report_aggregations"]:
        err = ra["prepare_error"]
        errs = f", prepare_error {PrepareError(err).name.lower()}" if err is not None else ""
        print(
            f"  report_aggregation: job {ra['job_id'][:16]}… ord {ra['ord']} "
            f"state {ra['state']}{errs} (job: {ra['job_state']}, step {ra['job_step']})"
        )
    for ba in trace["batch_aggregations"]:
        print(
            f"  batch shard {ba['batch_identifier'][:16]}… ord {ba['ord']}: "
            f"state {ba['state']}, {ba['report_count']} report(s)"
        )
    if journal is not None:
        where = ", ".join(f["segment"] for f in journal["found"]) or "not found"
        extra = (
            f" ({journal['undecodable_frames']} undecodable frame(s) — wrong --datastore-keys?)"
            if journal["undecodable_frames"]
            else ""
        )
        print(f"  journal: {journal['segments_scanned']} segment(s) scanned, {where}{extra}")
    print(
        f"  ledger books: admitted {books['admitted']}, aggregated {books['aggregated']}, "
        f"rejected {sum(rejected.values())}, expired {books['expired']}, "
        f"collected {books['collected']}, imbalance {books['imbalance']}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
