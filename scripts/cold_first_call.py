#!/usr/bin/env python3
"""Split the cold first call of the north star's engine steps on one GPU.

    python3 scripts/cold_first_call.py [--reps 1] [--out DIR]

A process's first dispatch of an EngineCache step at a bucket (the
device-cost ledger's `compile` row, what the shape manifest records and
the prewarm pays before ready) is slower than the next one at the same
shapes. This script measures by how much, for the keys a 1,024-report
SumVec(1000, 16) job dispatches: `leader_init` at bucket 256 (the
pipelined leader's chunk), `helper_init` at 1,024 (the helper's request)
and `aggregate` at 256, and splits the difference by ablation into

- cuBLAS initialization: a process that runs one float64 `bmm` on the
  card first (the handle and its workspace): `cublas_init_s` is cold
  minus that;
- the caching allocator's growth: a process that reserves 8 GiB in the
  allocator first (allocated once and freed, so the segments stay
  cached): `allocator_growth_s` is cold minus that;
- lazy CUDA module loading: a process that runs the float64 `bmm` and
  the three steps once at 32 rows first, which loads every module they
  launch (at a bucket whose allocator segments are small):
  `module_loading_s` is cold minus that, less `cublas_init_s`.
  (CUDA_MODULE_LOADING=EAGER does not isolate it: the first call then
  loads the eager modules of every library it opens, cuBLAS's among
  them, and runs longer than the lazy cold call.)

The parent shards the reports on the card once and writes the host
columns (and the leader's verifier shares the helper needs) to `DIR`
(default: a temp dir); then, for each rep, one process a mode, in the
order cold, blas, alloc, modules, each timing the three steps' first call
and a second call (warm), synchronized on the card. Each process loads
the four kernel libraries before it times anything (the binaries'
`backend_init`). It prints one JSON line a process, then a summary: each
op's mean seconds by mode and the derived shares (cold minus each
ablation).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SEED = 20261016
VERIFY_KEY = bytes(range(32, 48))
MODES = ("cold", "blas", "alloc", "modules")
OPS = ("leader_init_256", "helper_init_1024", "aggregate_256")


def _setup(out: Path) -> None:
    """Shard 1,024 reports on the card; keep the host columns and the
    leader's verifier shares and joint-rand parts for the helper."""
    import numpy as np
    import torch

    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.vdaf.registry import VdafInstance
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    inst = VdafInstance.sum_vec(1000, 16)
    meas = random_measurements(inst, 1024, np.random.default_rng(SEED))
    args, _ = make_report_batch(inst, meas, seed=SEED, shard_chunk=256, device=torch.device("cuda"))
    cols = step_args_to_numpy(args)
    eng = EngineCache(inst, VERIFY_KEY, device=torch.device("cuda"))
    _, _, ver0, part0 = eng.leader_init(*cols[:5])
    arrays = {}
    for name, col in zip(("nonce", "public", "meas", "proof", "blind0", "seeds", "blind1"), cols):
        if col is None:
            continue
        if isinstance(col, tuple):
            for i, limb in enumerate(col):
                arrays[f"{name}.{i}"] = limb
        else:
            arrays[name] = col
    for i, limb in enumerate(ver0):
        arrays[f"ver0.{i}"] = limb
    if part0 is not None:
        arrays["part0"] = part0
    np.savez(out / "columns.npz", **arrays)


def _load(path: Path):
    import numpy as np

    z = np.load(path)

    def col(name):
        limbs = sorted((k for k in z.files if k.startswith(name + ".")), key=lambda k: int(k.split(".")[1]))
        if limbs:
            return tuple(z[k] for k in limbs)
        return z[name] if name in z.files else None

    cols = tuple(col(n) for n in ("nonce", "public", "meas", "proof", "blind0", "seeds", "blind1"))
    return cols, col("ver0"), col("part0")


def child(mode: str, columns: Path) -> None:
    import numpy as np
    import torch

    from janus_tpu_torch.aggregator.engine_cache import EngineCache, _cut_rows
    from janus_tpu_torch.ops import cuda_build
    from janus_tpu_torch.vdaf.registry import VdafInstance

    dev = torch.device("cuda")
    cols, ver0, part0 = _load(columns)
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    context_s = time.perf_counter() - t0
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    if mode in ("blas", "modules"):
        a = torch.ones((4, 8, 8), dtype=torch.float64, device=dev)
        torch.bmm(a, a)
    if mode == "alloc":
        block = torch.empty(8 << 30, dtype=torch.uint8, device=dev)
        del block
    torch.cuda.synchronize()
    eng = EngineCache(VdafInstance.sum_vec(1000, 16), VERIFY_KEY, device=dev)
    if mode == "modules":
        small = tuple(_cut_rows(c, 0, 32) for c in cols)
        out_small = eng._leader_init_inner(*small[:5], allow_pipeline=False)[0]
        eng._helper_init_inner(small[0], small[1], small[5], small[6], _cut_rows(ver0, 0, 32),
                               _cut_rows(part0, 0, 32), np.ones(32, dtype=bool))
        eng.aggregate(out_small, np.ones(32, dtype=bool))
    torch.cuda.synchronize()
    lead = tuple(_cut_rows(c, 0, 256) for c in cols[:5])
    n = cols[0].shape[0]
    ok = np.ones(n, dtype=bool)

    def timed(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    rec = {"mode": mode, "context_s": context_s, "reserved_bytes_before": torch.cuda.memory_reserved(dev)}
    calls = {
        "leader_init_256": lambda: eng._leader_init_inner(*lead, allow_pipeline=False),
        "helper_init_1024": lambda: eng._helper_init_inner(cols[0], cols[1], cols[5], cols[6], ver0, part0, ok),
    }
    out0 = None
    for op in OPS:
        if op == "aggregate_256":
            calls[op] = lambda: eng.aggregate(out0, np.ones(256, dtype=bool))
        got, first = timed(calls[op])
        _, second = timed(calls[op])
        if op == "leader_init_256":
            out0 = got[0]
        rec[op] = {"first_s": first, "warm_s": second}
    rec["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--columns", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.child:
        child(args.child, Path(args.columns))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("cold_first_call: CUDA is not available")
    out = Path(args.out or tempfile.mkdtemp(prefix="cold-first-call-"))
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _setup(out)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    recs = []
    for _ in range(args.reps):
        for mode in MODES:
            env = dict(os.environ, PYTHONPATH=str(ROOT))
            env.pop("CUDA_MODULE_LOADING", None)  # the default: lazy
            proc = subprocess.run([sys.executable, __file__, "--child", mode, "--columns", str(out / "columns.npz")],
                                  env=env, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"cold_first_call: the {mode} process failed:\n{proc.stderr[-4000:]}")
            line = [x for x in proc.stdout.splitlines() if x.startswith("{")][-1]
            print(line, flush=True)
            recs.append(json.loads(line))
    summary = {}
    for op in OPS:
        by_mode = {m: [r[op]["first_s"] for r in recs if r["mode"] == m] for m in MODES}
        mean = {m: sum(v) / len(v) for m, v in by_mode.items()}
        warm = [r[op]["warm_s"] for r in recs]
        cublas = mean["cold"] - mean["blas"]
        summary[op] = {
            "first_s": mean, "warm_s": sum(warm) / len(warm), "cublas_init_s": cublas,
            "allocator_growth_s": mean["cold"] - mean["alloc"],
            "module_loading_s": mean["cold"] - mean["modules"] - cublas,
        }
    print(json.dumps({"summary": summary, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
