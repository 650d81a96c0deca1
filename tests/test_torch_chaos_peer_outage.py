"""`python -m janus_tpu_torch.tools.chaos_run --scenario peer_outage`, the
counterpart of janus_tpu's peer-outage smoke (tests/test_tools.py's
`peer_outage_smoke` record), on the CPU (`--device cpu`), as a process.

The real aggregation and collection job driver binaries reach the helper
through core/netsim.py's FaultProxy: a blackhole past the breaker's
threshold keeps uploads at 201 while both binaries park (claim
transactions frozen, zero lease conflicts), the half-open probe resumes
them on heal, the slicer and truncate lanes recover, and the two
disjoint collections partition the ground truth exactly.
"""

import pytest

from test_torch_chaos import _run, ok_key_pattern


def test_chaos_peer_outage_smoke(tmp_path):
    rec = _run(tmp_path, "--scenario", "peer_outage", "--smoke", timeout=300)
    assert rec["schedule"] == "peer_outage_smoke" and rec["device"] == "cpu"
    assert all(ok_key_pattern("run_peer_outage").fullmatch(k) for k in rec if k.endswith("_ok"))
    # janus_tpu's assertions of its smoke
    assert rec["uploads_during_blackhole_ok"] is True
    assert rec["both_parked_ok"] is True
    assert rec["claims_frozen_while_parked_ok"] is True
    assert rec["step_backs_bounded_ok"] is True
    assert rec["outage_seconds_counted_ok"] is True
    assert rec["statusz_peer_health_ok"] is True
    assert rec["unparked_ok"] and rec["recovery_agg_ok"]
    assert rec["collect1_exact_ok"] is True, rec.get("collect1")
    assert rec["slicer_lane_ok"] and rec["truncate_lane_ok"]
    assert rec["lease_conflicts_ok"] and rec["probes_alive_ok"]
    assert rec["exactly_once_ok"] is True
    assert rec["drain_ok"] is True
    # the proxy carried the drivers' traffic and its toxics fired
    assert rec["proxy_stats"]["toxic_fired"]["blackhole"] >= 1
    assert rec["proxy_stats"]["truncates"] >= 1
    assert rec["driver_devices"] == ["cpu"]


@pytest.mark.slow  # adds the latency and reset lanes
@pytest.mark.chaos
def test_chaos_peer_outage_full_schedule(tmp_path):
    rec = _run(tmp_path, "--scenario", "peer_outage", timeout=540)
    assert rec["schedule"] == "peer_outage_full"
    assert rec["latency_lane_ok"] and rec["reset_lane_ok"]
    assert rec["exactly_once_ok"] is True
