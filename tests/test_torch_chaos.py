"""The port's chaos harness (janus_tpu_torch/tools/chaos_run.py), the
counterpart of tests/test_chaos.py:

- the port's schedules are janus_tpu's and parse with the port's
  failpoints.parse_spec;
- the crash_storm and db_outage smoke schedules run end to end on the
  CPU (`--device cpu`), the crash through the real port job driver
  binary, and every `*_ok` holds: the crashed driver exits 77, the
  restarted one steps the job on the device its YAML names, and the
  collection equals the ground truth exactly;
- the full schedules carry `slow` and `chaos`, as janus_tpu's do;
- for each scenario, the set of `*_ok` keys its `run_*` can set equals
  janus_tpu's, both read from the sources with `ast`, less the named
  divergences (DIVERGENCES);
- every `run_*` raises without CUDA before it boots anything.

The other seven scenarios' smokes (cold_start's among them) run in one
file each
(tests/test_torch_chaos_<scenario>.py), so that `--dist loadfile`
spreads them over the workers.

Each schedule runs as an operator runs it, `python -m
janus_tpu_torch.tools.chaos_run`, in a process of its own (its
failpoints and servers stay out of the test process).
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from janus_tpu_torch import failpoints
from janus_tpu_torch.tools import chaos_run

REPO = Path(__file__).resolve().parent.parent


def test_schedules_parse():
    """The harness's fault schedules must stay valid failpoint specs — a
    typo would silently inject nothing and void the chaos proof; they
    are janus_tpu's."""
    for spec in (
        chaos_run.CRASH_SCHEDULE,
        chaos_run.POST_COMMIT_CRASH_SCHEDULE,
        chaos_run.STORM_SCHEDULE,
        chaos_run.HELPER_5XX_SCHEDULE,
        chaos_run.DB_OUTAGE_SCHEDULE,
        chaos_run.DEVICE_HANG_SCHEDULE,
        chaos_run.PIPELINE_RTT_SCHEDULE,
        chaos_run.FLEET_RTT_SCHEDULE,
        chaos_run.RESIDENT_SCHEDULE,
    ):
        assert failpoints.parse_spec(spec)
    crash = failpoints.parse_spec(chaos_run.CRASH_SCHEDULE)["datastore.commit.step_agg_job_write"]
    assert crash.action == "crash" and crash.count == 1
    outage = failpoints.parse_spec(chaos_run.DB_OUTAGE_SCHEDULE)["datastore.connect.leader"]
    assert outage.action == "error" and outage.prob == 1.0
    hang = failpoints.parse_spec(chaos_run.DEVICE_HANG_SCHEDULE)["engine.dispatch"]
    assert hang.action == "hang" and hang.count == 1
    resident = failpoints.parse_spec(chaos_run.RESIDENT_SCHEDULE)
    assert (resident["engine.dispatch"].after, resident["engine.canary"].count) == (4, 2)
    assert failpoints.parse_spec(chaos_run.PIPELINE_RTT_SCHEDULE)["helper.request"].action == "delay"
    assert failpoints.parse_spec(chaos_run.FLEET_RTT_SCHEDULE)["helper.request"].action == "delay"
    assert failpoints.CRASH_EXIT_CODE == 77

    # janus_tpu's script, read as text: its module top sets JAX's
    # environment, which the test process must not take
    src = (REPO / "scripts" / "chaos_run.py").read_text()
    # janus_tpu's module-level constants, evaluated from the source
    j_consts = {
        node.targets[0].id: ast.literal_eval(node.value)
        for node in ast.parse(src).body
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id.endswith("_SCHEDULE")
    }
    for name in ("CRASH_SCHEDULE", "POST_COMMIT_CRASH_SCHEDULE", "STORM_SCHEDULE", "HELPER_5XX_SCHEDULE",
                 "DB_OUTAGE_SCHEDULE", "DEVICE_HANG_SCHEDULE", "PIPELINE_RTT_SCHEDULE", "FLEET_RTT_SCHEDULE",
                 "RESIDENT_SCHEDULE"):
        # byte for byte
        assert getattr(chaos_run, name) == j_consts[name], name
    assert set(j_consts) == {n for n in dir(chaos_run) if n.endswith("_SCHEDULE")}


def test_driver_yaml_names_the_device(tmp_path):
    path = chaos_run._driver_cfg(tmp_path / "d.yaml", "x.sqlite", 1234, 8, 1.5, "cuda:0")
    from janus_tpu_torch.config import JobDriverBinaryConfig, load_config

    cfg = load_config(path, JobDriverBinaryConfig)
    assert cfg.common.device == "cuda:0"
    assert not cfg.common.ignored_keys  # no JAX-only key
    assert cfg.job_driver.worker_lease_duration_s == 8


def _run(tmp_path, *args, timeout: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("JANUS_FAILPOINTS", None)
    proc = subprocess.run(
        [sys.executable, "-m", "janus_tpu_torch.tools.chaos_run", "--json", "--device", "cpu",
         "--workdir", str(tmp_path), *args],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    rec = json.loads([line for line in proc.stdout.splitlines() if line.startswith("{")][-1])
    assert rec["ok"] is True
    assert all(v for k, v in rec.items() if k.endswith("_ok")), rec
    return rec


def test_chaos_crash_storm_smoke(tmp_path):
    """The smoke schedule on the CPU: crash before the commit, restart
    into the transport and 5xx storm through the breaker, exact
    collection, SIGTERM drain."""
    rec = _run(tmp_path, "--smoke", timeout=240)
    assert rec["schedule"] == "smoke" and rec["device"] == "cpu"
    assert rec["crash_exit_code"] == 77  # failpoints.CRASH_EXIT_CODE
    assert rec["lease_held_after_crash_ok"] and rec["lease_reacquired_within_ttl_ok"]
    assert rec["circuit_cycle_ok"] is True, rec["circuit_transitions"]
    assert rec["stepped_back_ok"] is True, rec["step_backs"]
    # the restarted binary stepped the job on the device its YAML names
    assert rec["driver_devices"] == ["cpu"] and rec["driver_dispatches"] >= 1
    assert rec["exactly_once_ok"] is True
    assert (rec["collected_count"], rec["collected_sum"]) == (rec["admitted"], rec["ground_truth_sum"])
    assert rec["drain_ok"] is True


def test_chaos_db_outage_smoke(tmp_path):
    """The smoke schedule on the CPU: uploads ride a datastore outage on
    the spill journal, /readyz cycles, the journal drains, and the
    collection equals every acked upload exactly once."""
    rec = _run(tmp_path, "--scenario", "db_outage", "--smoke", timeout=240)
    assert rec["schedule"] == "db_outage_smoke"
    assert rec["healthy_fsyncs_ok"] is True  # journal idle = no fsyncs
    assert rec["readyz_up_ok"] and rec["readyz_down_ok"] and rec["readyz_recovered_ok"]
    assert rec["aggregate_shed_status"] == 503
    assert rec["driver_parked_ok"] is True  # no lease attempts burned
    assert rec["acked_during_outage"] > 0 and rec["spilled_acked_ok"]
    assert rec["journal_drained_ok"] is True
    assert rec["uploads_all_acked_ok"] is True, rec["upload_errors"]
    assert rec["exactly_once_ok"] is True
    assert rec["collected_count"] == rec["admitted"]


@pytest.mark.slow  # four driver boots and two lease expiries
@pytest.mark.chaos
def test_chaos_full_schedule(tmp_path):
    """The full schedule end to end, as an operator would run it: a
    second crash after the commit and a clean restart that finds
    nothing to redo."""
    rec = _run(tmp_path, timeout=540)
    assert rec["schedule"] == "full"
    assert rec["post_commit_crash_ok"] is True
    assert rec["clean_restart_ok"] is True
    assert rec["exactly_once_ok"] is True


@pytest.mark.slow  # a five-second outage window, replay drain and collection
@pytest.mark.chaos
def test_chaos_db_outage_full_schedule(tmp_path):
    rec = _run(tmp_path, "--scenario", "db_outage", timeout=540)
    assert rec["schedule"] == "db_outage_full"
    assert rec["acked_during_outage"] > 0
    assert rec["healthy_fsyncs_ok"] is True
    assert rec["journal_drained_ok"] is True
    assert rec["exactly_once_ok"] is True
    assert rec["collected_count"] == rec["admitted"]


def test_no_cuda_and_no_cpu_request_raises(monkeypatch, tmp_path):
    """The harness's default device is CUDA: without it the run raises
    before it boots anything."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos_run.run_chaos(workdir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos_run.run_db_outage(workdir=str(tmp_path / "b"))
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()


@pytest.mark.parametrize("fn", ["run_device_hang", "run_pipeline", "run_resident", "run_fleet", "run_soak",
                                "run_peer_outage", "run_cold_start"])
def test_new_scenarios_raise_without_cuda_before_booting(monkeypatch, tmp_path, fn):
    """The same for the other seven: no CUDA and no `device="cpu"` raises
    before a directory, a datastore, a server or a process exists."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(chaos_run, "_spawn_driver", lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(chaos_run, "_Pair", lambda *a, **k: spawned.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(chaos_run, fn)(workdir=str(tmp_path / "w"))
    assert not (tmp_path / "w").exists() and spawned == []


# `*_ok` keys the port's scenarios set where janus_tpu's do not, or the
# reverse, each with its reason (ROADMAP "Divergences")
DIVERGENCES = {
    # no host engine: the re-acquired job steps back `device_quarantined`
    # and nothing may finish between the quarantine's open and restore
    "run_device_hang": ({"no_interim_work_ok"}, set()),
    # the byte cap is sized from the port's own Count row and the record
    # says it holds exactly one slot
    "run_resident": ({"cap_one_count_slot_ok"}, set()),
    "run_pipeline": (set(), set()),
    "run_peer_outage": (set(), set()),
    "run_fleet": (set(), set()),
    "run_soak": (set(), set()),
    # the warm boot's real job after ready, on request (`job_reports`):
    # it finishes, and adds no `compile` row at a key the manifest covers,
    # where the same job on a boot with no prewarm books one
    "run_cold_start": ({"warm_job_ok", "warm_job_no_compile_ok", "unwarmed_job_compiles_ok"}, set()),
}

# `*_ok` keys a scenario sets on CUDA only, absent from a CPU record: the
# CPU builds and loads no kernel library, so there is nothing for the
# kernel-library cache keys, its cache hits and misses, or the cold/warm
# speedup to read (ROADMAP "Divergences")
CPU_ABSENT = {
    "run_cold_start": {"cold_aot_saves_ok", "warm_aot_loads_ok", "warm_cache_hits_ok", "cold_cache_misses_ok",
                       "speedup_ok"},
}


def _ok_keys(tree: ast.Module, fn_name: str, depth: int = 2) -> set:
    """The `*_ok` keys function `fn_name` of a module can put in its
    record: `result["x_ok"] = ...` (an f-string key as its pattern with
    `{}`), and the `_ok` keys of dict literals, in its body and in the
    module's functions and methods it calls (to `depth` calls deep)."""
    defs = {n.name: n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def key(node):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.JoinedStr):
            return "".join(v.value if isinstance(v, ast.Constant) else "{}" for v in node.values)
        return None

    out: set = set()
    seen: set = set()

    def visit(name: str, d: int) -> None:
        if name in seen or name not in defs:
            return
        seen.add(name)
        for node in ast.walk(defs[name]):
            if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
                k = key(node.slice)
                if k and k.endswith("_ok"):
                    out.add(k)
            elif isinstance(node, ast.Dict):
                out.update(k for k in map(key, node.keys) if k and k.endswith("_ok"))
            elif isinstance(node, ast.Call) and d > 0:
                f = node.func
                callee = f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else None
                if callee:
                    visit(callee, d - 1)

    visit(fn_name, depth)
    return out


@pytest.mark.parametrize("fn", sorted(DIVERGENCES))
def test_ok_key_sets_equal_janus_tpus_less_named_divergences(fn):
    """Each scenario's invariant keys are janus_tpu's: janus_tpu's script
    parsed with ast (never imported: its module top sets JAX's
    environment) against the port's module parsed the same way."""
    j_tree = ast.parse((REPO / "scripts" / "chaos_run.py").read_text())
    t_tree = ast.parse(Path(chaos_run.__file__).read_text())
    j_keys, t_keys = _ok_keys(j_tree, fn), _ok_keys(t_tree, fn)
    added, removed = DIVERGENCES[fn]
    assert j_keys, fn  # the extraction found janus_tpu's keys
    assert t_keys - j_keys == added, sorted(t_keys - j_keys)
    assert j_keys - t_keys == removed, sorted(j_keys - t_keys)


def ok_key_pattern(fn: str) -> re.Pattern:
    """A pattern matching every `*_ok` key janus_tpu's `fn` can set, and
    the port's named additions: a smoke record's keys must all match."""
    keys = _ok_keys(ast.parse((REPO / "scripts" / "chaos_run.py").read_text()), fn) | DIVERGENCES[fn][0]
    return re.compile("|".join(re.escape(k).replace(r"\{\}", "[^_]+") for k in sorted(keys)))
