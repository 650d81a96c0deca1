"""`python -m janus_tpu_torch.tools.chaos_run --scenario fleet`, the
counterpart of janus_tpu's `--scenario fleet` smoke, on the CPU
(`--device cpu`), as a process; and claim_roundtrip_stats.

Real job driver binaries, each with its identity and shard in its YAML
`fleet:` stanza, over one leader store under a 0.1 s helper RTT: the
scaling curve at 1 and 2 replicas (gate 1.2), a replica SIGKILLed while
it holds a lease, another drained, the victim restarted; zero lease
conflicts, batched claims, steals of the drained shard, the conservation
ledger balanced at every quiesce point, an exact collection and the
injected silent loss detected on the next evaluation.
"""

import pytest

from janus_tpu_torch.tools import chaos_run

from test_torch_chaos import _run, ok_key_pattern


def test_claim_roundtrip_stats_counts_the_recorded_wire():
    """The batched claim issues one statement a claim transaction on the
    pg_fake wire, the per-row loop 1 + K: at 32 jobs in batches of 16,
    3 statements (two claims and the empty one) against 35."""
    st = chaos_run.claim_roundtrip_stats()
    assert st["claim_roundtrips_ok"] is True
    assert (st["batched_claimed"], st["per_row_claimed"]) == (32, 32)
    assert (st["batched_statements"], st["per_row_statements"]) == (3, 35)


def test_chaos_fleet_smoke(tmp_path):
    rec = _run(tmp_path, "--scenario", "fleet", "--smoke", timeout=300)
    assert rec["schedule"] == "fleet_smoke" and rec["device"] == "cpu"
    assert all(ok_key_pattern("run_fleet").fullmatch(k) for k in rec if k.endswith("_ok"))
    assert rec["fleet_scaling"]["replica_counts"] == [1, 2]
    assert rec["fleet_scaling"]["speedup_max_vs_1"] >= rec["scaling_gate"] == 1.2
    assert rec["victim_held_lease_ok"] and rec["victim_sigkill_ok"]
    assert rec["zero_lease_conflicts_ok"] and rec["lease_conflicts_total"] == 0
    assert rec["batched_claims_ok"] and rec["fleet_acquired_jobs"] > rec["fleet_claim_txs"]
    assert rec["steals_observed_ok"] is True
    assert rec["exactly_once_ok"] is True and rec["collected_count"] == rec["admitted"]
    assert rec["conservation_collected_ok"] and rec["peer_reconciled_ok"]
    assert rec["loss_detected_ok"] and rec["loss_injected_imbalance"] == 1
    # every replica read before its drain served on the YAML's device
    # and dispatched there
    assert {"scale1-0", "scale2-0", "scale2-1", "chaos-1", "survivor-0"} <= set(rec["replica_status"])
    for tag, st in rec["replica_status"].items():
        assert st["devices"] == ["cpu"] and st["dispatches"] >= 1, (tag, st)


@pytest.mark.slow  # 1/2/4 replicas, then a fleet of four
@pytest.mark.chaos
def test_chaos_fleet_full_schedule(tmp_path):
    rec = _run(tmp_path, "--scenario", "fleet", timeout=900)
    assert rec["schedule"] == "fleet_full"
    assert rec["fleet_scaling"]["replica_counts"] == [1, 2, 4]
    assert rec["scaling_ok"] and rec["exactly_once_ok"]
