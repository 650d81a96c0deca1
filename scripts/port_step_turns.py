#!/usr/bin/env python3
"""Time janus_tpu_torch's two-party step from two checkouts, in turns, on one GPU.

    python3 scripts/port_step_turns.py OLD_ROOT NEW_ROOT [--turns 2] [--reps 3]

OLD_ROOT and NEW_ROOT are roots of checkouts of this repository (for
example an unpacked `git archive` of a parent commit beside the working
tree). Each turn runs one process per checkout, in the order old, new,
new, old, so that a drift of the card or the host over the run falls on
both alike. A process imports `janus_tpu_torch` from its root only
(building that checkout's kernels), shards both paths' reports (the
same seeded reports as `chip_smoke.py`), then times `two_party_step`
and `helper_init_step` after one warm-up, the two paths in turns (fast,
draft, draft, fast), and prints one JSON line. The last line is a
summary per checkout: the mean step seconds of each path and the mean
of draft minus fast, which the turns make robust to the host's drift.

Paths: fast SumVec(1000, 16) at batch 1024 (a control the change under
test may leave alone) and draft SumVec(1000, 16) at batch 1024.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SEED = 20261016
VERIFY_KEY = bytes(range(32, 48))
PATHS = ("sumvec", "draft-sumvec")


def child(root: str, reps: int) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import janus_tpu_torch
    from janus_tpu_torch.parallel import api
    from janus_tpu_torch.vdaf.registry import VdafInstance
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    assert janus_tpu_torch.__file__.startswith(root), janus_tpu_torch.__file__
    if not torch.cuda.is_available():
        raise SystemExit("port_step_turns: CUDA is not available")
    dev = torch.device("cuda")
    runs = {}
    for path in PATHS:
        inst = VdafInstance("sumvec", bits=16, length=1000, xof_mode="draft" if path.startswith("draft") else "fast")
        meas = random_measurements(inst, 1024, np.random.default_rng(SEED))
        args, _ = make_report_batch(inst, meas, seed=SEED, shard_chunk=256, device=dev)
        runs[path] = {
            "two_party_step_s": (api.two_party_step(inst, VERIFY_KEY, device=dev), args),
            "helper_init_step_s": (api.helper_init_step(inst, VERIFY_KEY, device=dev), (args[0], args[1], args[5], args[6])),
        }
    rec = {"root": root, "device": torch.cuda.get_device_name(0)}
    for path in PATHS:
        rec[path] = {key: [] for key in runs[path]}
    for key in ("two_party_step_s", "helper_init_step_s"):
        for path in PATHS:  # warm-up
            fn, fargs = runs[path][key]
            fn(*fargs)
        torch.cuda.synchronize()
        # the two paths in turns within the process: fast, draft, draft, fast
        for _ in range(reps):
            for path in PATHS + PATHS[::-1]:
                fn, fargs = runs[path][key]
                t = time.perf_counter()
                fn(*fargs)
                torch.cuda.synchronize()
                rec[path][key].append(time.perf_counter() - t)
    for path in PATHS:
        fn, fargs = runs[path]["two_party_step_s"]
        torch.cuda.reset_peak_memory_stats()
        fn(*fargs)
        torch.cuda.synchronize()
        # both paths' reports stay allocated; the peak is over that floor
        rec[path]["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.old, a.reps)
        return 0
    a.old, a.new = os.path.abspath(a.old), os.path.abspath(a.new)
    runs = []
    for _ in range(a.turns):
        for root in (a.old, a.new, a.new, a.old):
            out = subprocess.run(
                [sys.executable, __file__, root, root, "--child", "--reps", str(a.reps)],
                capture_output=True, text=True, timeout=900,
            )
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    summary = {}
    for label, root in (("old", a.old), ("new", a.new)):
        mine = [r for r in runs if r["root"] == root]
        summary[label] = {}
        for key in ("two_party_step_s", "helper_init_step_s"):
            mean = {path: sum(sum(r[path][key]) for r in mine) / sum(len(r[path][key]) for r in mine) for path in PATHS}
            summary[label][key] = {**mean, "draft_minus_fast": mean["draft-sumvec"] - mean["sumvec"]}
    print(json.dumps({"summary": summary, "device": runs[0]["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
