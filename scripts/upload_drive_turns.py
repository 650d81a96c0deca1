#!/usr/bin/env python3
"""Time chip_smoke's upload-drive-sumvec phase of two checkouts in turns on one GPU.

    python3 scripts/upload_drive_turns.py OLD_ROOT NEW_ROOT [--turns 1]

OLD_ROOT and NEW_ROOT are roots of checkouts of this repository (for
example an unpacked `git archive` of a parent commit beside the working
tree). Each turn runs one process per checkout, in the order old, new,
new, old; a process builds its checkout's kernels and runs the phase
twice, as chip_smoke.py runs it (1,024 SumVec(1000, 16) reports uploaded
over loopback HTTP, one job stepped, the batch collected; with its
observability probe where the checkout has one), and keeps each run's
phase, upload and job-step seconds: the first run's engine is cold, the
second's warm.

It prints one JSON line a process, then a summary per checkout: each
case's mean, least, most, quartiles and median.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from leader_turns import _stats  # noqa: E402

CASES = ("cold_phase_s", "warm_phase_s", "warm_upload_s", "warm_step_s")


def child(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from janus_tpu_torch.vdaf.registry import VdafInstance

    assert os.path.abspath(chip_smoke.__file__).startswith(root), chip_smoke.__file__
    if not torch.cuda.is_available():
        raise SystemExit("upload_drive_turns: CUDA is not available")
    chip_smoke.phase_build()
    dev = torch.device("cuda")
    args = (torch, dev, VdafInstance.sum_vec(1000, 16), 8, 1016, (5, 300, 1000), ("keccak_single_block", "expand_f128"))
    observed = "observe" in inspect.signature(chip_smoke.phase_upload_drive).parameters
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        rec = chip_smoke.phase_upload_drive(*args, **({"observe": True} if observed else {}))
        runs.append((time.perf_counter() - t0, rec))
    (cold_s, _), (warm_s, warm) = runs
    return {"root": root, "device": torch.cuda.get_device_name(0), "observed": observed, "cold_phase_s": cold_s,
            "warm_phase_s": warm_s, "warm_upload_s": warm["upload_s"], "warm_step_s": warm["step_s"],
            "launches": warm["launches"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(os.path.abspath(a.old))), flush=True)
        return 0
    runs = []
    for _ in range(a.turns):
        for root in (a.old, a.new, a.new, a.old):
            root = os.path.abspath(root)
            out = subprocess.run([sys.executable, __file__, root, root, "--child"], capture_output=True, text=True,
                                 timeout=900)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    summary = {"device": runs[0]["device"]}
    for label, root in (("old", os.path.abspath(a.old)), ("new", os.path.abspath(a.new))):
        mine = [r for r in runs if r["root"] == root]
        summary[label] = {c: _stats([r[c] for r in mine]) for c in CASES}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
