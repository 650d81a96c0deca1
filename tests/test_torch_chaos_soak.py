"""`python -m janus_tpu_torch.tools.chaos_run --scenario soak`, the
counterpart of janus_tpu's soak smoke (tests/test_tools.py's
`soak_smoke` record), on the CPU (`--device cpu`), as a process.

Four epochs of task churn (a fresh task of 8 Count reports each), two
real job driver binaries, an exact collection and a GC pass an epoch;
the clean driver's flight recorder must call its leak-gated series flat,
its p99 stable and its overhead within 1 %, and the driver armed with
`flight.synthetic_leak` must be seen leaking and fire the
`resource_trend` alert. Divergences: SQLite only (`engine: "sqlite"`):
the port reads no JANUS_TEST_DATABASE_URL; the smoke samples health
every 0.02 s, not 0.5 s, so that each half of the p99 window holds about
two thousand transactions, not about 100.
"""

import pytest

from test_torch_chaos import _run, ok_key_pattern


def test_chaos_soak_smoke(tmp_path):
    rec = _run(tmp_path, "--scenario", "soak", "--smoke", timeout=300)
    assert rec["schedule"] == "soak_smoke" and rec["device"] == "cpu"
    assert rec["engine"] == "sqlite" and (rec["epochs"], rec["reports_per_epoch"]) == (4, 8)
    assert all(ok_key_pattern("run_soak").fullmatch(k) for k in rec if k.endswith("_ok"))
    # janus_tpu's assertions of its smoke
    assert rec["epochs_exact_ok"] is True
    assert rec["gc_deleted_rows"] > 0
    assert rec["zero_slope_ok"] is True
    assert rec["recorder_overhead_ratio"] <= 0.01
    assert rec["leak_detected_ok"] is True
    assert rec["trend_alert_fired_ok"] is True
    assert rec["conservation_ok"] is True
    assert rec["driver_devices"] == ["cpu"]
    # the p99 verdict is janus_tpu's, read over halves of thousands of
    # transactions each
    assert rec["health_sampler_interval_s"] == 0.02
    (p99,) = rec["p99_windows"].values()
    assert min(p99["early_n"], p99["late_n"]) >= 1200, p99
    assert rec["p99_stable_ok"] is True, p99


@pytest.mark.slow  # twelve epochs of 24 reports and production-shaped windows
@pytest.mark.chaos
def test_chaos_soak_full_schedule(tmp_path):
    rec = _run(tmp_path, "--scenario", "soak", timeout=1200)
    assert rec["schedule"] == "soak_full" and rec["engine"] == "sqlite"
    assert rec["epochs_exact_ok"] and rec["zero_slope_ok"]
