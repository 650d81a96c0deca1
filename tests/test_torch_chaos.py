"""The port's chaos harness (janus_tpu_torch/tools/chaos_run.py), the
counterpart of tests/test_chaos.py:

- the port's schedules are janus_tpu's and parse with the port's
  failpoints.parse_spec;
- the crash_storm and db_outage smoke schedules run end to end on the
  CPU (`--device cpu`), the crash through the real port job driver
  binary, and every `*_ok` holds: the crashed driver exits 77, the
  restarted one steps the job on the device its YAML names, and the
  collection equals the ground truth exactly;
- the full schedules carry `slow` and `chaos`, as janus_tpu's do.

Each schedule runs as an operator runs it, `python -m
janus_tpu_torch.tools.chaos_run`, in a process of its own (its
failpoints and servers stay out of the test process).
"""

import json
import os
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
    ):
        assert failpoints.parse_spec(spec)
    crash = failpoints.parse_spec(chaos_run.CRASH_SCHEDULE)["datastore.commit.step_agg_job_write"]
    assert crash.action == "crash" and crash.count == 1
    outage = failpoints.parse_spec(chaos_run.DB_OUTAGE_SCHEDULE)["datastore.connect.leader"]
    assert outage.action == "error" and outage.prob == 1.0
    assert failpoints.CRASH_EXIT_CODE == 77

    # janus_tpu's script, read as text: its module top sets JAX's
    # environment, which the test process must not take
    src = (REPO / "scripts" / "chaos_run.py").read_text()
    for name in ("CRASH_SCHEDULE", "POST_COMMIT_CRASH_SCHEDULE", "STORM_SCHEDULE", "HELPER_5XX_SCHEDULE",
                 "DB_OUTAGE_SCHEDULE"):
        assert repr(getattr(chaos_run, name)).strip("'") in src, name


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
