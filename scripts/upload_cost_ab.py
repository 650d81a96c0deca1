#!/usr/bin/env python3
"""Split the cost of the served path's instrumentation on the uploads, in one process on one GPU.

    python3 scripts/upload_cost_ab.py [--rounds 3]

Runs chip_smoke's upload-drive-sumvec phase (1,024 SumVec(1000, 16)
reports uploaded over loopback HTTP, one job stepped, the batch
collected) once to warm the engine, then `--rounds` rounds of four
modes in turn, each a whole phase:

  live      the program as it ships;
  probe     the same with chip_smoke's observability probe (its Chrome
            trace writer on for the drive);
  no_book   the conservation ledger's `admitted` booking in the report
            writer's flush left out (the flush transaction's extra
            statement);
  bare      no booking, and every span and metric call a no-op.

The modes other than live and probe exist only in this script, which
replaces the functions for the duration of a run: the program has no
switch. It prints one JSON line a run (upload, job-step and phase
seconds) and a summary: each mode's median and spread per case.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODES = ("live", "probe", "no_book", "bare")


@contextlib.contextmanager
def _nospan(name, **args):
    yield


def _replace(pairs):
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in pairs]
    for obj, name, value in pairs:
        setattr(obj, name, value)
    return saved


def _mode(mode: str):
    """The (object, attribute, value) replacements of a mode."""
    from janus_tpu_torch import metrics, trace
    from janus_tpu_torch.aggregator import report_writer

    pairs = []
    if mode in ("no_book", "bare"):
        pairs.append((report_writer, "_ledger_book_admitted", lambda tx, reports, results: None))
    if mode == "bare":
        span = trace.span
        pairs += [(mod, "span", _nospan) for name, mod in list(sys.modules.items())
                  if name.startswith("janus_tpu_torch") and getattr(mod, "span", None) is span]
        pairs += [(cls, n, lambda self, *a, **k: None)
                  for cls, names in ((metrics.Counter, ("add",)), (metrics.Gauge, ("set", "add")),
                                     (metrics.Histogram, ("observe",)))
                  for n in names]
    return pairs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    a = ap.parse_args()
    import torch

    import chip_smoke
    from janus_tpu_torch.vdaf.registry import VdafInstance

    if not torch.cuda.is_available():
        raise SystemExit("upload_cost_ab: CUDA is not available")
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    args = (torch, dev, VdafInstance.sum_vec(1000, 16), 8, 1016, (5, 300, 1000), ("keccak_single_block", "expand_f128"))
    chip_smoke.phase_upload_drive(*args)  # warm the engine
    runs = {m: [] for m in MODES}
    for _ in range(a.rounds):
        for mode in MODES:
            saved = _replace(_mode(mode))
            try:
                t0 = time.perf_counter()
                rec = chip_smoke.phase_upload_drive(*args, observe=mode == "probe")
                phase_s = time.perf_counter() - t0
            finally:
                _replace(saved)
            row = {"mode": mode, "upload_s": rec["upload_s"], "step_s": rec["step_s"], "phase_s": phase_s}
            runs[mode].append(row)
            print(json.dumps(row), flush=True)
    summary = {"device": torch.cuda.get_device_name(0)}
    for mode, rows in runs.items():
        summary[mode] = {c: {"median": statistics.median(r[c] for r in rows), "min": min(r[c] for r in rows),
                             "max": max(r[c] for r in rows)} for c in ("upload_s", "step_s", "phase_s")}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
