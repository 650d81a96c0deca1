"""`python -m janus_tpu_torch.tools.chaos_run --scenario device_hang`,
the counterpart of janus_tpu's device-hang smoke (tests/test_tools.py's
`device_hang_smoke` record), on the CPU (`--device cpu`), as a process.

The real job driver binary's first dispatch wedges; past the port's
hang bound (`device_watchdog: hang_after_secs: 2`, inside the 8 s lease)
the job steps back `device_hang` before its lease expires and the engine
quarantines. Divergence: no host engine serves while quarantined — the
re-acquired job steps back `device_quarantined` and no job finishes
between the quarantine's open and its restore (`no_interim_work_ok`);
the job finishes on the device after the canary's restore, and the
collection equals the ground truth exactly.
"""

import pytest

from test_torch_chaos import _run, ok_key_pattern


def test_chaos_device_hang_smoke(tmp_path):
    rec = _run(tmp_path, "--scenario", "device_hang", "--smoke", timeout=240)
    assert rec["schedule"] == "device_hang_smoke" and rec["device"] == "cpu"
    assert all(ok_key_pattern("run_device_hang").fullmatch(k) for k in rec if k.endswith("_ok"))
    # janus_tpu's assertions of its smoke
    assert rec["lease_bounded_ok"] is True
    assert rec["hung_dispatch_ok"] and rec["stepped_back_device_hang_ok"]
    assert rec["quarantined_observed_ok"] and rec["quarantine_cycle_ok"]
    assert rec["restored_ok"] is True
    assert rec["abandoned_under_cap_ok"] and rec["stalled_stack_ok"]
    assert rec["drain_ok"] is True
    assert rec["exactly_once_ok"] is True
    assert rec["collected_count"] == rec["admitted"]
    assert rec["restore_warm_ok"] is True, rec.get("restore_elapsed_s")
    # the port's: the hang bound from the YAML, the step-back before the
    # lease expired, and nothing finished while quarantined
    assert rec["hang_after_s"] == 2.0
    assert rec["hung_lease_released_at"] <= rec["first_lease_expiry"]
    assert rec["step_backs"]['reason="device_hang"'] >= 1
    assert rec["step_backs"].get('reason="device_quarantined"', 0) >= 1, rec["step_backs"]
    assert rec["no_interim_work_ok"] is True and rec["interim_finished_jobs"] == 0
    assert rec["driver_devices"] == ["cpu"]


@pytest.mark.slow  # twelve reports, the same cycle
@pytest.mark.chaos
def test_chaos_device_hang_full_schedule(tmp_path):
    rec = _run(tmp_path, "--scenario", "device_hang", timeout=540)
    assert rec["schedule"] == "device_hang_full" and rec["admitted"] == 12
    assert rec["lease_bounded_ok"] and rec["no_interim_work_ok"]
    assert rec["exactly_once_ok"] is True
