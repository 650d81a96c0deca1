#!/usr/bin/env python3
"""Time the CUDA kernels of two checkouts in turns, on one GPU.

    python3 scripts/kernel_turns.py OLD_ROOT NEW_ROOT [--turns 1]

OLD_ROOT and NEW_ROOT are roots of checkouts of this repository (for
example an unpacked `git archive` of a parent commit beside the working
tree). Each turn runs one process per checkout, in the order old, new,
new, old, so that a drift of the card or the host over the run falls on
both alike. A process imports `chip_smoke.py` and `janus_tpu_torch` from
its root only, builds that checkout's kernels and runs its kernels phase
(`chip_smoke.phase_kernels`): every kernel case held against its plain
version and timed as that checkout's script times it (`ms`: CUDA events
around back-to-back calls, as a caller on the host sees them). It prints
one JSON line: each kernel's cases as (label, ms, max_abs_err), a case
without a name labelled by its shape. The last line is a summary: per
checkout, the mean `ms` of every (kernel, label) over its turns.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def label(case: dict) -> str:
    if "case" in case:
        return case["case"]
    keys = ("states", "reports", "blocks", "out_lanes", "rounds", "block_offset")
    return ", ".join(f"{k} {case[k]}" for k in keys if k in case)


def child(root: str) -> None:
    os.chdir(root)
    sys.path.insert(0, root)
    import contextlib
    import io

    import torch

    import chip_smoke

    with contextlib.redirect_stdout(io.StringIO()):  # the build line
        chip_smoke.phase_build()
    results = chip_smoke.phase_kernels(torch, torch.device("cuda"))
    out = {name: [[label(c), c["ms"], c["max_abs_err"]] for c in cases] for name, cases in results.items()}
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "kernels": out}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(os.path.abspath(args.new))
        return 0
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    runs = {"old": [], "new": []}
    for _ in range(args.turns):
        for side in ("old", "new", "new", "old"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "-", roots[side], "--child"],
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[side].append(json.loads(line)["kernels"])
    summary = {}
    for side, recs in runs.items():
        means = {}
        for name in recs[0]:
            for i, (lab, _, _) in enumerate(recs[0][name]):
                means[f"{name}: {lab}"] = sum(r[name][i][1] for r in recs) / len(recs)
        summary[side] = means
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
