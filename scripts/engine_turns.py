#!/usr/bin/env python3
"""Time janus_tpu_torch's EngineCache inits from two checkouts, in turns, on one GPU.

    python3 scripts/engine_turns.py OLD_ROOT NEW_ROOT [--turns 1] [--reps 3]

OLD_ROOT and NEW_ROOT are roots of checkouts of this repository (for
example an unpacked `git archive` of a parent commit beside the working
tree). Each turn runs one process per checkout, in the order old, new,
new, old, so that a drift of the card or the host falls on both alike. A
process imports `janus_tpu_torch` from its root only (building that
checkout's kernels), shards 1,024 SumVec(1000, 16) reports (the seeded
reports of `chip_smoke.py`) to host columns, and times after a warm-up:

- `helper_init` of all 1,024 (the serve path's engine call) and
  `leader_init` of all 1,024 (the drive path's, the pipelined route);
- `leader_init` of one 128-report job (a pipeline job's direct route);
- eight 128-report `leader_init`s from eight threads at once (concurrent
  jobs of one task: merged into rounds where the checkout coalesces).

It prints one JSON line a process, then a summary per checkout: the mean
seconds of each case.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 20261016
VERIFY_KEY = bytes(range(32, 48))
CASES = ("helper_init_1024", "leader_init_1024", "leader_init_128", "leader_init_8x128_threads")


def child(root: str, reps: int) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import janus_tpu_torch
    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.vdaf.registry import VdafInstance
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    assert janus_tpu_torch.__file__.startswith(root), janus_tpu_torch.__file__
    if not torch.cuda.is_available():
        raise SystemExit("engine_turns: CUDA is not available")
    dev = torch.device("cuda")
    inst = VdafInstance.sum_vec(1000, 16)
    meas = random_measurements(inst, 1024, np.random.default_rng(SEED))
    args, _ = make_report_batch(inst, meas, seed=SEED, shard_chunk=256, device=dev)
    nonce, public, lmeas, proof, b0, seeds, b1 = step_args_to_numpy(args)
    eng = EngineCache(inst, VERIFY_KEY, device=dev)
    _, _, ver0, part0 = eng.leader_init(nonce, public, lmeas, proof, b0)
    ok = np.ones(1024, dtype=bool)

    def rows(s, e):
        return (nonce[s:e], public[s:e], tuple(x[s:e] for x in lmeas), tuple(x[s:e] for x in proof), b0[s:e])

    def threads():
        with ThreadPoolExecutor(max_workers=8) as pool:
            for f in [pool.submit(eng.leader_init, *rows(128 * k, 128 * (k + 1))) for k in range(8)]:
                f.result()

    cases = {
        "helper_init_1024": lambda: eng.helper_init(nonce, public, seeds, b1, ver0, part0, ok),
        "leader_init_1024": lambda: eng.leader_init(nonce, public, lmeas, proof, b0),
        "leader_init_128": lambda: eng.leader_init(*rows(0, 128)),
        "leader_init_8x128_threads": threads,
    }
    rec = {"root": root, "device": torch.cuda.get_device_name(0), **{c: [] for c in CASES}}
    for fn in cases.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    for _ in range(reps):
        for c in CASES:
            t = time.perf_counter()
            cases[c]()
            torch.cuda.synchronize()
            rec[c].append(time.perf_counter() - t)
    co = getattr(eng, "_co_leader", None)
    rec["leader_round_sizes"] = list(co.rounds) if co is not None else None
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=1)
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
            out = subprocess.run([sys.executable, __file__, root, root, "--child", "--reps", str(a.reps)],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            line = out.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
    summary = {}
    for label, root in (("old", a.old), ("new", a.new)):
        mine = [r for r in runs if r["root"] == root]
        summary[label] = {c: sum(sum(r[c]) for r in mine) / sum(len(r[c]) for r in mine) for c in CASES}
    print(json.dumps({"summary": summary, "device": runs[0]["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
