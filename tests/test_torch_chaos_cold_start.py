"""`python -m janus_tpu_torch.tools.chaos_run --scenario cold_start`, the
counterpart of janus_tpu's cold-start smoke, on the CPU (`--device cpu`),
as a process.

One cold and one warm boot of the real job driver binary over one seeded
shape manifest (janus_tpu's: Prio3Count, leader_init, helper_init and
aggregate at buckets 32, 64 and 128, one aggregate_pending): each boot
has the `engine_warm_manifest` phase and warms all ten entries before
/readyz reports ready, with none failed, and drains on SIGTERM; the warm
boot then steps one real job of 8 reports, which adds no `compile` row
to the device-cost split at a key the manifest covers, where the same job
on a control boot with no manifest and no prewarm adds one at each key
it runs (`job_cold_cost` puts the first call beside the steady
dispatches). No kernel launches on the CPU: every wrapper runs its plain
version, and each boot's and job's launch counts say so. The CPU builds no
kernel library, so the kernel-library keys and the speedup gate are
absent from the record (`CPU_ABSENT`). `seed_manifest` writes janus_tpu's
seeded manifest byte for byte.
"""

import ast
import subprocess
import sys
import time

from test_torch_chaos import CPU_ABSENT, REPO, _run, ok_key_pattern

from janus_tpu_torch.tools import chaos_run


def test_chaos_cold_start_smoke(tmp_path):
    rec = _run(tmp_path, "--scenario", "cold_start", "--smoke", "--job-reports", "8", timeout=300)
    assert rec["schedule"] == "cold_start" and rec["device"] == "cpu" and rec["vdafs"] == [{"kind": "count"}]
    keys = {k for k in rec if k.endswith("_ok")}
    assert all(ok_key_pattern("run_cold_start").fullmatch(k) for k in keys)
    assert keys.isdisjoint(CPU_ABSENT["run_cold_start"]), keys & CPU_ABSENT["run_cold_start"]
    assert rec["manifest_seeded_entries"] == 10
    cold, warm, unwarmed = rec["boots"]
    assert (cold["label"], warm["label"], unwarmed["label"]) == ("cold", "warm", "unwarmed")
    for boot in (cold, warm):
        phases = list(boot["phases"])
        # the manifest loads, then the prewarm (inside engine_warm) runs
        # before the listener: ready only after the priority set
        assert phases.index("engine_warm_manifest") < phases.index("engine_warm") < phases.index("listener_up")
        assert boot["warmed"] == boot["manifest_entries"] == 10
        assert (boot["failed"], boot["deferred"]) == (0, 0)
        assert (boot["aot_loads"], boot["aot_saves"], boot["nvcc_s"]) == (0, 0, 0.0)
        assert boot["drain_rc"] == 0 and boot["drained"]
    for boot in (cold, warm, unwarmed):
        assert set(boot["kernel_launches"].values()) == {0}
    job = warm["job"]
    assert (job["reports"], job["jobs_created"], job["finished"]) == (8, 1, 1)
    # the job's leader init and aggregate ran at keys the manifest covers,
    # and booked `execute` there
    assert {("leader_init", 32), ("aggregate", 32)} <= {tuple(k) for k in job["covered"]}
    assert job["dispatches_added"] == {"leader_init@32": 1, "aggregate@32": 1}
    assert job["covered_compile_rows_added"] == [] and job["compile_rows_added"] == []
    assert rec["warm_job_ok"] and rec["warm_job_no_compile_ok"]
    assert set(job["launches_added"].values()) == {0}
    # the control: ready with no prewarm, then the same job books the cold
    # first call at each key it runs
    assert "engine_warm_manifest" in unwarmed["phases"] and unwarmed["warmed"] == 0
    control = unwarmed["job"]
    assert (control["reports"], control["jobs_created"], control["finished"]) == (8, 1, 1)
    assert sorted(map(tuple, control["covered_compile_rows_added"])) == [("aggregate", 32), ("leader_init", 32)]
    assert rec["unwarmed_job_compiles_ok"]
    assert set(rec["job_cold_cost"]) == {"leader_init@32", "aggregate@32"}
    for cost in rec["job_cold_cost"].values():
        assert cost["first_call_s"] > 0 and cost["unwarmed_steady_s"] is None and cost["warm_per_dispatch_s"] > 0
    # janus_tpu's cold_start is a scenario of the port's harness now
    assert set(chaos_run.SCENARIOS) == {"crash_storm", "db_outage", "device_hang", "pipeline", "resident", "fleet",
                                        "soak", "peer_outage", "cold_start"}
    help_text = " ".join(subprocess.run([sys.executable, "-m", "janus_tpu_torch.tools.chaos_run", "--help"],
                                        cwd=str(REPO), capture_output=True, text=True, timeout=60).stdout.split())
    assert "cold_start =" in help_text and "excluded" not in help_text


def test_seed_manifest_writes_janus_tpus_bytes(tmp_path, monkeypatch):
    """janus_tpu's `seed_manifest`, nested in its run_cold_start, run from
    its source (the script is never imported: its module top sets JAX's
    environment) against the port's, both at one clock."""
    from janus_tpu.aggregator.shape_manifest import ShapeManifest
    from janus_tpu.vdaf.registry import VdafInstance as JVdaf
    from janus_tpu_torch.vdaf.registry import VdafInstance

    tree = ast.parse((REPO / "scripts" / "chaos_run.py").read_text())
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_cold_start")
    seed = next(n for n in ast.walk(run) if isinstance(n, ast.FunctionDef) and n.name == "seed_manifest")
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.25)
    for full in (False, True):
        ns = {"ShapeManifest": ShapeManifest,
              "insts": (JVdaf.count(), JVdaf.histogram(length=4)) if full else (JVdaf.count(),)}
        exec(compile(ast.Module(body=[seed], type_ignores=[]), "chaos_run.py", "exec"), ns)
        j_path, t_path = tmp_path / f"j{full}.jsonl", tmp_path / f"t{full}.jsonl"
        insts = (VdafInstance.count(), VdafInstance.histogram(length=4)) if full else (VdafInstance.count(),)
        assert ns["seed_manifest"](str(j_path)) == chaos_run.seed_manifest(str(t_path), insts) == 10 * len(insts)
        assert t_path.read_bytes() == j_path.read_bytes()
