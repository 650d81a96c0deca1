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

    python3 scripts/kernel_turns.py OLD_ROOT NEW_ROOT --entries [--turns 2]

times, in place of the kernels phase, two entry points that every
checkout since the field kernels has by these names, at the
SumVec(1000, 16) step's shapes (1,024 reports, seeded inputs made on the
card): `ops.limbmm.fold_contract` ([1024, 2, 127] x [1024, 127, 126],
Field128) and `vdaf.engine._pow2_weighted_sum` (the bits-major [1024, 16,
1000] view of a [1024, 16000] share). Each is timed call by call (`ms`,
CUDA events around back-to-back calls) and with its launches queued
ahead (`device_ms`), beside the peak device bytes one call adds; the
outputs' digest must agree between the checkouts.
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


def entries(root: str) -> None:
    os.chdir(root)
    sys.path.insert(0, root)
    import hashlib

    import numpy as np
    import torch

    import chip_smoke
    from janus_tpu_torch.fields.tfield import TF128
    from janus_tpu_torch.ops import limbmm
    from janus_tpu_torch.vdaf import engine

    assert chip_smoke.__file__.startswith(root), chip_smoke.__file__
    dev = torch.device("cuda")
    rng = np.random.default_rng(chip_smoke.SEED)
    w = chip_smoke.field_values(torch, dev, rng, TF128, (1024, 2, 127))
    X = chip_smoke.field_values(torch, dev, rng, TF128, (1024, 127, 126))
    share = chip_smoke.field_values(torch, dev, rng, TF128, (1024, 16000))
    view = tuple(x.reshape(1024, 1000, 16).transpose(1, 2) for x in share)
    rec = {"root": root, "device": torch.cuda.get_device_name(0), "entries": {}}
    for name, fn in (("fold_contract", lambda: limbmm.fold_contract(TF128, w, X)),
                     ("_pow2_weighted_sum", lambda: engine._pow2_weighted_sum(TF128, view, 16))):
        out = fn()
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(x.cpu().numpy().tobytes() for x in out)).hexdigest()[:16]
        del out
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        rec["entries"][name] = {"ms": chip_smoke.time_cuda(torch, fn, reps=20),
                                "device_ms": chip_smoke.time_queued(torch, fn, reps=20),
                                "peak_added_bytes": peak, "digest": digest}
    print(json.dumps(rec), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--entries", action="store_true", help="time fold_contract and _pow2_weighted_sum instead")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        (entries if args.entries else child)(os.path.abspath(args.new))
        return 0
    roots = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    runs = {"old": [], "new": []}
    for _ in range(args.turns):
        for side in ("old", "new", "new", "old"):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "-", roots[side], "--child"]
                + (["--entries"] if args.entries else []),
                capture_output=True, text=True, timeout=900,
            )
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[side].append(json.loads(line)["entries" if args.entries else "kernels"])
    if args.entries:
        summary = {side: {name: {key: sum(r[name][key] for r in recs) / len(recs)
                                 for key in ("ms", "device_ms", "peak_added_bytes")}
                          for name in recs[0]} for side, recs in runs.items()}
        digests = {name: {r[name]["digest"] for recs in runs.values() for r in recs} for name in runs["new"][0]}
        print(json.dumps({"summary": summary, "outputs_agree": all(len(d) == 1 for d in digests.values())}),
              flush=True)
        return 0 if all(len(d) == 1 for d in digests.values()) else 1
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
