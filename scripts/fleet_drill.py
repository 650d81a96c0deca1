#!/usr/bin/env python3
"""Run chip_smoke.py's fleet-drill phase alone, on one GPU.

    python3 scripts/fleet_drill.py [--per-task 256] [--job-size 128]

Builds the CUDA kernels (`chip_smoke.phase_build`), then runs
`chip_smoke.phase_fleet_drill` on cuda:0 at SumVec(1000, 16) with
`--per-task` reports a task in jobs of `--job-size`, in a fresh process
(the engine is cold, where `chip_smoke.py` reaches the phase with it
warm). Prints the build's seconds, the `{"fleet_drill": ...}` line and
the card's name and power limit as nvidia-smi gives them; exits non-zero
without CUDA or when the phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--per-task", type=int, default=256)
    ap.add_argument("--job-size", type=int, default=128)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fleet_drill: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from janus_tpu_torch.vdaf.registry import VdafInstance

    t0 = time.perf_counter()
    chip_smoke.phase_build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    rec = chip_smoke.phase_fleet_drill(torch, torch.device("cuda"), VdafInstance.sum_vec(1000, 16),
                                       per_task=args.per_task, job_size=args.job_size)
    print(json.dumps({"fleet_drill": rec}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
