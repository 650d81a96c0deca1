#!/usr/bin/env python3
"""Chip smoke test of janus_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py            # from the root of the repository

Phases, each of which must pass:

  1. build    both CUDA kernels from csrc/ (one nvcc per source, in parallel);
  2. kernels  each kernel against its plain PyTorch version on the card,
              bit for bit, at the shapes of the main path (24 rounds, plus
              a reduced-round case), with its time, the plain version's
              time and the least time the card could take (bound);
  3. sumvec   the main path: Prio3SumVec(length=1000, bits=16) at batch
              1024 through make_report_batch and two_party_step, with a few
              reports corrupted; the count must exclude exactly those, the
              two aggregate shares must sum to the numpy ground truth, and
              both kernels must have launched during the step (launch counts
              are set to 0 just before the step and read just after); a
              small batch must agree with the plain path on the CPU; then
              two_party_step and helper_init_step are timed;
  4. count    Prio3Count at batch 8192, the same checks (the Field64 path,
              through the single-block kernel).

Output: JSON lines (build, kernels, one per path, a profile of one step),
then the card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Without CUDA, or without the package
beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

SEED = 20261016
VERIFY_KEY = bytes(range(32, 48))

# Least-time model of the card (H100 SXM): HBM3 at 3.35 TB/s, and the
# 32-bit integer pipe at 64 ops/clock/SM (the CUDA programming guide's
# throughput table for compute capability 9.0) x 132 SMs x 1.98 GHz, the
# clock behind the published 67 TFLOP/s fp32 rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# A Keccak-f[1600] round in the fewest 32-bit instructions, counting
# 3-input logic (LOP3) and funnel shifts: theta 80 (column parities 20,
# rotations 10, the 3-input update of 25 lanes 50), rho 48 (24 rotations),
# chi 50 (one LOP3 per half lane), iota 2.
KECCAK_OPS_PER_ROUND = 180
# One 192-bit -> Field128 reduction (csrc/expand_f128.cu f128_reduce192):
# two folds and two conditional corrections of carry-chained 32-bit adds,
# about 40 instructions.
F128_REDUCE_OPS = 40


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_cuda(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over unsigned 64-bit words (0 when identical)."""
    worst = 0
    for g, w in zip(got, want):
        if torch.equal(g, w):
            continue
        diff = g != w
        gv = g[diff].cpu().numpy().view("uint64")[:4096]
        wv = w[diff].cpu().numpy().view("uint64")[:4096]
        worst = max(worst, max(abs(int(a) - int(b)) for a, b in zip(gv, wv)))
    return worst


def bound_ms(ops: float, nbytes: float) -> tuple[float, str]:
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_build():
    from janus_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    secs = time.perf_counter() - t0
    ptxas = {}
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
        ptxas[name] = [
            line.strip() for line in cuda_build.build_log(name).splitlines()
            if "registers" in line or "spill" in line
        ]
    emit({"build": {"seconds": secs, "kernels": list(cuda_build.KERNELS), "ptxas": ptxas}})


def phase_kernels(torch, dev):
    """Each kernel against its plain version at main-path shapes."""
    import numpy as np

    from janus_tpu_torch.ops import expand_cuda, keccak_cuda

    rng = np.random.default_rng(SEED)

    def lanes(shape):
        a = rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
        return torch.from_numpy(a.view(np.int64)).to(dev)

    batch, blocks, length = 1024, 2286, 16000  # SumVec(1000, 16): 16000 F128 elements a report
    results = {}

    # kernel 1: the leader binder's tree-digest leaf level is 1024 x 2286
    # states (out_lanes 2); counter-mode streams take out_lanes 21
    cases = []
    cols = list(lanes((21, batch, blocks)))
    n = batch * blocks
    for out_lanes, rounds in ((2, 24), (21, 24), (21, 3)):
        got = keccak_cuda.keccak_single_block(cols, out_lanes, rounds=rounds)
        want = keccak_cuda.keccak_single_block_plain(cols, out_lanes, rounds=rounds)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block(cols, out_lanes, rounds=rounds), reps=10)
        plain_ms = time_cuda(torch, lambda: keccak_cuda.keccak_single_block_plain(cols, out_lanes, rounds=rounds), reps=2)
        b_ms, b_by = bound_ms(n * rounds * KECCAK_OPS_PER_ROUND, n * 8 * (21 + out_lanes))
        cases.append({"states": n, "out_lanes": out_lanes, "rounds": rounds, "max_abs_err": err,
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
        del got, want
    results["keccak_single_block"] = cases
    del cols

    # kernel 2: the helper measurement share, 1024 reports x 2286 blocks
    cases = []
    prefix = lanes((batch, 5))  # dst || seed || AGG1
    for offset, rounds in ((3, 24), (1, 5)):
        got = expand_cuda.expand_f128(prefix, blocks, length, block_offset=offset, rounds=rounds)
        want = expand_cuda.expand_f128_plain(prefix, blocks, length, block_offset=offset, rounds=rounds)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        ms = time_cuda(torch, lambda: expand_cuda.expand_f128(prefix, blocks, length, block_offset=offset, rounds=rounds), reps=10)
        plain_ms = time_cuda(torch, lambda: expand_cuda.expand_f128_plain(prefix, blocks, length, block_offset=offset, rounds=rounds), reps=2)
        nb = batch * blocks
        b_ms, b_by = bound_ms(
            nb * rounds * KECCAK_OPS_PER_ROUND + batch * length * F128_REDUCE_OPS,
            prefix.numel() * 8 + 2 * batch * length * 8,
        )
        cases.append({"reports": batch, "blocks": blocks, "length": length, "block_offset": offset,
                      "rounds": rounds, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
        del got, want
    results["expand_f128"] = cases
    bad = [c for cs in results.values() for c in cs if c["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return results


def _bump_rows(torch, p3, field, rows):
    """A copy of `field` with element 0 of each listed report plus 1 (mod p)."""
    from janus_tpu_torch.fields.tfield import fconst

    out = tuple(x.clone() for x in field)
    idx = torch.tensor(rows, device=out[0].device)
    sel = tuple(x[idx, :1] for x in out)
    new = p3.tf.add(sel, fconst(p3.tf, 1, (), out[0].device))
    for x, v in zip(out, new):
        x[idx, :1] = v
    return out


def run_path(torch, dev, inst, batch: int, bad_rows, kernels, reps: int, shard_chunk: int, small_batch: int):
    """Drive one path through the entry points; returns (its JSON record,
    (the step function, its arguments))."""
    import numpy as np

    from janus_tpu_torch.ops import expand_cuda, keccak_cuda
    from janus_tpu_torch.parallel import api
    from janus_tpu_torch.vdaf.registry import prio3_batched
    from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

    counters = {"keccak_single_block": keccak_cuda.keccak_single_block, "expand_f128": expand_cuda.expand_f128}
    p3 = prio3_batched(inst, dev)
    meas = random_measurements(inst, batch, np.random.default_rng(SEED))
    t0 = time.perf_counter()
    args, _ = make_report_batch(inst, meas, seed=SEED, shard_chunk=shard_chunk, device=dev)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    args = list(args)
    args[3] = _bump_rows(torch, p3, args[3], bad_rows)  # corrupt leader proof shares
    step = api.two_party_step(inst, VERIFY_KEY, device=dev)

    # the main path: counts at 0 just before, read just after
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    agg0, agg1, count = step(*args)
    torch.cuda.synchronize()
    first_step_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    valid = np.ones(batch, dtype=bool)
    valid[list(bad_rows)] = False
    want = np.asarray(meas)[valid].sum(axis=0).reshape(-1)
    total = [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    if int(count) != batch - len(bad_rows):
        raise AssertionError(f"count {int(count)} != {batch - len(bad_rows)}")
    if total != [int(x) for x in want]:
        raise AssertionError("aggregate != numpy sum of the valid measurements")
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing} ({launches})")

    # a small batch agrees with the plain path on the CPU
    small = meas[:small_batch]
    outs = []
    for d in (dev, "cpu"):
        sargs, _ = make_report_batch(inst, small, seed=SEED + 1, device=d)
        s0, s1, sc = api.two_party_step(inst, VERIFY_KEY, device=d)(*sargs)
        sp3 = prio3_batched(inst, d)
        outs.append(([int(x) for x in sp3.tf.to_ints(sp3.merge_agg_shares(s0, s1))], int(sc)))
    if outs[0] != outs[1]:
        raise AssertionError("small batch: card and CPU plain path disagree")

    # timing after a warm-up
    helper = api.helper_init_step(inst, VERIFY_KEY, device=dev)
    hargs = (args[0], args[1], args[5], args[6])

    def timed(fn, fargs):
        fn(*fargs)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            fn(*fargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return times

    two_s = timed(step, args)
    helper_s = timed(helper, hargs)
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {
        "path": inst.kind,
        "vdaf": inst.to_dict(),
        "batch": batch,
        "corrupted": len(bad_rows),
        "count": int(count),
        "aggregate_ok": True,
        "small_batch_matches_cpu": True,
        "launches": launches,
        "shard_s": shard_s,
        "first_step_s": first_step_s,
        "two_party_step_s": two_s,
        "two_party_reports_per_s": batch / (sum(two_s) / len(two_s)),
        "helper_init_step_s": helper_s,
        "helper_init_reports_per_s": batch / (sum(helper_s) / len(helper_s)),
        "peak_device_bytes": peak,
    }, (step, args)


def profile_step(torch, step, args, step_s: float):
    """Device time by kernel over one step (torch.profiler), and the share
    of the unprofiled step time `step_s` that the card was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        rows.append((e.key, dev_us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    # device kernels only: operator rows (aten::) and runtime API rows
    # (cudaLaunchKernel and the like, no device time) are left out
    kernels_only = [r for r in rows if r[1] > 0 and not r[0].startswith(("aten::", "cuda"))]
    device_ms = sum(r[1] for r in kernels_only)
    return {
        "device_ms_total": device_ms,
        "kernel_launches": sum(r[2] for r in kernels_only),
        "step_s": step_s,
        "device_busy_share": device_ms / 1e3 / step_s,
        "top": [[k, ms, c] for k, ms, c in kernels_only[:15]],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; nothing was run")
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import janus_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"chip_smoke: janus_tpu_torch is not beside this script ({e})")
        return 3
    from janus_tpu_torch.vdaf.registry import VdafInstance

    dev = torch.device("cuda")
    failed = []

    def phase(name, fn, *a):
        log(f"chip_smoke: phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*a)
            log(f"chip_smoke: phase {name} passed in {time.perf_counter() - t0:.1f}s")
            return out
        except Exception:
            traceback.print_exc()
            failed.append(name)
            return None

    phase("build", phase_build)
    checks = phase("kernels", phase_kernels, torch, dev) if not failed else None
    paths = []
    sumvec = phase(
        "sumvec", run_path, torch, dev, VdafInstance.sum_vec(1000, 16), 1024, (5, 300, 1000),
        ("keccak_single_block", "expand_f128"), 3, 256, 4,
    ) if not failed else None
    if sumvec is not None:
        paths.append(sumvec[0])
        step_s = sumvec[0]["two_party_step_s"]
        prof = phase("profile", profile_step, torch, *sumvec[1], sum(step_s) / len(step_s))
        if prof is not None:
            emit({"profile": {"path": "sumvec", "batch": 1024, **prof}})
    count = phase(
        "count", run_path, torch, dev, VdafInstance.count(), 8192, (7, 4000, 8000),
        ("keccak_single_block",), 5, 0, 8,
    ) if not failed else None
    if count is not None:
        paths.append(count[0])

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        log(f"chip_smoke: nvidia-smi failed: {smi.stderr}")
        failed.append("nvidia-smi")
    if failed:
        log(f"chip_smoke: FAILED phases: {failed}")
        return 1

    main_launches = paths[0]["launches"]
    source = {"keccak_single_block": "janus_tpu_torch/csrc/keccak.cu",
              "expand_f128": "janus_tpu_torch/csrc/expand_f128.cu"}
    replaces = {"keccak_single_block": "janus_tpu/ops/keccak_pallas.py:236",
                "expand_f128": "janus_tpu/ops/expand_pallas.py:249"}
    kernels = []
    for name, cases in checks.items():
        main_case = cases[0]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source[name],
            "replaces": replaces[name],
            "launches": main_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": None,
            "cases": cases,
        })
    emit({"kernels": kernels})
    for p in paths:
        emit(p)
    print(smi.stdout.strip(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
