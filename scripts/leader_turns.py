#!/usr/bin/env python3
"""Time the served paths of two checkouts in turns, and the stage pipeline against the serial stepper, on one GPU.

    python3 scripts/leader_turns.py OLD_ROOT NEW_ROOT [--turns 1]

OLD_ROOT and NEW_ROOT are roots of checkouts of this repository (for
example an unpacked `git archive` of a parent commit beside the working
tree). Every process imports `janus_tpu_torch` and `chip_smoke` from its
root only, and builds that checkout's kernels.

Paths, parent against change: each turn runs one process per checkout,
in the order old, new, new, old, so that a drift of the card or the host
falls on both alike. A process runs chip_smoke's serve-sumvec and
drive-sumvec phases as the script runs them (1,024 SumVec(1000, 16)
reports: a helper's aggregate-init request over wire bytes, then a
leader's job step over loopback HTTP, each held against its truth) and
keeps the request's seconds (the first and a second job), the job
step's seconds and their stages, the engine's warm inits that the two
phases time in turns (`helper_init_turns_s`, `leader_init_s`), and, with
--profile, the host functions of the first request that took the most
time by cProfile (the profile slows that request; its seconds are kept
apart, and the other numbers are unaffected). Every process also keeps
the seconds the interpreter's garbage collector paused inside the first
request and inside the job step's JobDriver pass (`gc.callbacks`), with
the generations collected there, and, where the checkout has a dispatch
watchdog, how many device calls the two phases ran on its worker
threads and the seconds their hand-offs took (`armed_calls`,
`armed_handoff_s`; None for a checkout without one).

The pipeline, NEW_ROOT only: one process runs chip_smoke's pipeline
phase with one SumVec(1000, 16) task, 2,048 reports in 16 jobs of 128
and the driver in resident mode, as four passes of four jobs on one
driver: the serial stepper, the stage pipeline (one lane, prestaged
columns), the pipeline, the serial stepper. It keeps each pass's run
seconds and job seconds.

It prints one JSON line a process, then a summary: each case's mean,
least, most, quartiles and median seconds per checkout or stepper.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

PATH_CASES = ("request_s", "second_job_request_s", "helper_init_s", "step_s", "device_init_s", "http_init_s")


def _load(root: str):
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    import janus_tpu_torch

    for mod in (chip_smoke, janus_tpu_torch):
        assert os.path.abspath(mod.__file__).startswith(root), mod.__file__
    if not torch.cuda.is_available():
        raise SystemExit("leader_turns: CUDA is not available")
    chip_smoke.phase_build()
    return torch, chip_smoke, torch.device("cuda")


def _profiled_first_request(top: int):
    """Profile the helper's first aggregate-init request (cProfile, host
    functions by own time); returns (restore, the record it fills)."""
    import cProfile
    import pstats

    from janus_tpu_torch.aggregator.core import Aggregator

    raw, rec = Aggregator.handle_aggregate_init, {}

    def profiled(self, *a, **kw):
        if rec:
            return raw(self, *a, **kw)
        prof = cProfile.Profile()
        try:
            return prof.runcall(raw, self, *a, **kw)
        finally:
            st = pstats.Stats(prof)
            rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
            rec["total_s"] = st.total_tt
            rec["top"] = [[f"{f[0].rsplit('/', 2)[-1]}:{f[1]}:{f[2]}", v[1], v[2], v[3]] for f, v in rows]

    Aggregator.handle_aggregate_init = profiled

    def restore():
        Aggregator.handle_aggregate_init = raw

    return restore, rec


class _GcPauses:
    """While open, keeps every garbage-collector pause (start, seconds,
    generation) and the (start, end) spans of the named methods' calls."""

    def __init__(self, methods):
        self.methods, self.pauses, self.spans, self._t = methods, [], {}, None

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((self._t, time.perf_counter() - self._t, info["generation"]))
            self._t = None

    def __enter__(self):
        self._raw = [(cls, name, getattr(cls, name)) for cls, name in self.methods]
        for cls, name, raw in self._raw:
            spans = self.spans.setdefault(name, [])

            def timed(*a, _raw=raw, _spans=spans, **kw):
                t0 = time.perf_counter()
                try:
                    return _raw(*a, **kw)
                finally:
                    _spans.append((t0, time.perf_counter()))

            setattr(cls, name, timed)
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        for cls, name, raw in self._raw:
            setattr(cls, name, raw)

    def inside(self, name: str, k: int = 0) -> dict:
        """GC seconds inside the k-th call of `name`, and the pauses and
        seconds of each generation there."""
        s, e = self.spans[name][k]
        hits = [(d, g) for t, d, g in self.pauses if s <= t < e]
        return {"seconds": sum(d for d, _ in hits),
                "by_generation": {g: [sum(1 for _, h in hits if h == g), sum(d for d, h in hits if h == g)]
                                  for g in (0, 1, 2)}}


def _armed():
    """(calls, hand-off seconds) of the process's dispatch watchdog so
    far, or None in a checkout without one."""
    try:
        from janus_tpu_torch.aggregator.device_watchdog import WATCHDOG
    except ImportError:
        return None
    st = WATCHDOG.status()
    return st["armed_calls"], st["armed_handoff_s"]


def child_paths(root: str, profile: bool) -> dict:
    torch, cs, dev = _load(root)
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.job_driver import JobDriver
    from janus_tpu_torch.vdaf.registry import VdafInstance

    inst, fast, bad = VdafInstance.sum_vec(1000, 16), ("keccak_single_block", "expand_f128"), (5, 300, 1000)
    restore, prof = _profiled_first_request(30) if profile else (lambda: None, None)
    try:
        with _GcPauses([(Aggregator, "handle_aggregate_init")]) as gc_serve:
            serve = cs.phase_serve(torch, dev, "sumvec", inst, 1024, bad, fast, 256, False, 2)
    finally:
        restore()
    served = _armed()
    with _GcPauses([(JobDriver, "run_once")]) as gc_drive:
        drive = cs.phase_drive(torch, dev, "sumvec", inst, 1024, bad, fast)
    armed = {"armed_calls": {"serve": served[0], "drive": _armed()[0] - served[0]},
             "armed_handoff_s": {"serve": served[1], "drive": _armed()[1] - served[1]}} if served else {
        "armed_calls": None, "armed_handoff_s": None}
    return {
        "root": root, "case": "paths", "device": torch.cuda.get_device_name(0), "profiled": profile,
        "request_s": serve["request_s"], "second_job_request_s": serve["second_job_request_s"],
        "helper_init_s": serve["stage_s"]["helper_init"], "step_s": drive["step_s"],
        "device_init_s": drive["stage_s"]["device_init"], "http_init_s": drive["stage_s"]["http_init"],
        "engine_helper_init_s": serve["helper_init_turns_s"]["engine_helper_init"],
        "helper_init_step_s": serve["helper_init_turns_s"]["helper_init_step"],
        "serve_leader_init_s": serve["leader_init_s"], "drive_leader_init_s": drive["leader_init_turns_s"],
        "request_profile": prof,
        "request_gc": gc_serve.inside("handle_aggregate_init"), "step_gc": gc_drive.inside("run_once"),
        **armed,
    }


def child_pipeline(root: str) -> dict:
    torch, cs, dev = _load(root)
    from janus_tpu_torch.vdaf.registry import VdafInstance

    rec = cs.phase_pipeline_resident(torch, dev, VdafInstance.sum_vec(1000, 16), (cs.VERIFY_KEY,), 2048, 128,
                                     ((0, 5), (0, 300)), ((0, 4), (1, 4), (1, 4), (0, 4)))
    if not all(c["result_ok"] for c in rec["collect"]):
        raise AssertionError("leader_turns: the collection disagrees with the truth")
    return {
        "root": root, "case": "pipeline", "device": torch.cuda.get_device_name(0),
        "passes": [{"stepper": r["stepper"], "run_s": r["run_s"], "job_s": r["job_s"]["all"],
                    "job_p50_s": r["job_s"]["p50"], "round_sizes": r["round_sizes"], "merges": r["merges"],
                    "classic_fallbacks": r["classic_fallbacks"]} for r in rec["runs"]],
    }


def _spawn(case: str, root: str, profile: bool = False) -> dict:
    cmd = [sys.executable, __file__, root, root, "--child", case] + (["--profile"] if profile else [])
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(1)
    line = out.stdout.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


def _stats(xs) -> dict:
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 else (xs[0],) * 3
    return {"mean": sum(xs) / len(xs), "min": min(xs), "q1": q1, "median": med, "q3": q3, "max": max(xs),
            "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--profile", action="store_true",
                    help="add one more process a checkout whose first request runs under cProfile")
    ap.add_argument("--no-pipeline", action="store_true", help="skip the serial-against-pipeline process")
    ap.add_argument("--child", choices=("paths", "pipeline"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        root = os.path.abspath(a.old)
        rec = child_paths(root, a.profile) if a.child == "paths" else child_pipeline(root)
        print(json.dumps(rec), flush=True)
        return 0
    a.old, a.new = os.path.abspath(a.old), os.path.abspath(a.new)
    runs = [_spawn("paths", root) for _ in range(a.turns) for root in (a.old, a.new, a.new, a.old)]
    if a.profile:
        for root in (a.old, a.new):
            _spawn("paths", root, profile=True)
    summary = {"paths": {}, "pipeline": {}, "device": runs[0]["device"]}
    for label, root in (("old", a.old), ("new", a.new)):
        mine = [r for r in runs if r["root"] == root]
        summary["paths"][label] = {c: _stats([r[c] for r in mine]) for c in PATH_CASES}
        for c in ("engine_helper_init_s", "helper_init_step_s"):
            summary["paths"][label][c] = _stats([x for r in mine for x in r[c]])
    if a.no_pipeline:
        print(json.dumps({"summary": summary}), flush=True)
        return 0
    pipe = _spawn("pipeline", a.new)
    for stepper in ("serial", "pipeline"):
        mine = [p for p in pipe["passes"] if p["stepper"] == stepper]
        summary["pipeline"][stepper] = {"run_s": _stats([p["run_s"] for p in mine]),
                                        "job_p50_s": _stats([p["job_p50_s"] for p in mine])}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
