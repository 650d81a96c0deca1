"""`python -m janus_tpu_torch.tools.chaos_run --scenario pipeline`, the
counterpart of janus_tpu's pipeline smoke (tests/test_tools.py's
`pipeline_smoke` record), on the CPU (`--device cpu`), as a process.

The real job driver binary with its YAML `step_pipeline:` stanza steps 8
jobs of 3 Count reports against a helper whose every request is delayed
0.08 s (`helper.request=delay:0.08`): the device lane must run while an
HTTP leg is in flight, every stage must execute, the lane must never run
two dispatches at once, the drain is clean and the collection equals the
ground truth exactly.
"""

import pytest

from test_torch_chaos import _run, ok_key_pattern


def test_chaos_pipeline_smoke(tmp_path):
    rec = _run(tmp_path, "--scenario", "pipeline", "--smoke", timeout=240)
    assert rec["schedule"] == "pipeline_smoke" and rec["device"] == "cpu"
    assert all(ok_key_pattern("run_pipeline").fullmatch(k) for k in rec if k.endswith("_ok"))
    assert rec["jobs_created"] == 8 and rec["job_states"] == {"finished": 8}
    # janus_tpu's assertions of its smoke
    assert rec["overlap_ok"] and rec["overlapped_dispatches"] >= 1
    assert rec["device_lane_busy_ok"] is True
    assert rec["statusz_overlap_events"] > 0
    assert rec["stages_executed_ok"] is True
    assert rec["statusz_pipeline_ok"] is True
    assert rec["drain_ok"] is True
    assert rec["exactly_once_ok"] is True
    assert rec["collected_count"] == rec["admitted"]
    assert rec["driver_devices"] == ["cpu"]


@pytest.mark.slow  # sixty reports in twenty jobs
@pytest.mark.chaos
def test_chaos_pipeline_full_schedule(tmp_path):
    rec = _run(tmp_path, "--scenario", "pipeline", timeout=540)
    assert rec["schedule"] == "pipeline_full" and rec["jobs_created"] == 20
    assert rec["overlap_ok"] and rec["exactly_once_ok"]
