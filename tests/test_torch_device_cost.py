"""janus_tpu_torch's device-cost ledger and profiler held against janus_tpu's.

- After the same CPU-served requests (tests/test_torch_ledger.py's drive:
  a leader job step over loopback HTTP with its helper's aggregate-init),
  the port pair's `DEVICE_COST` gained janus_tpu's ops with janus_tpu's
  dispatches and rows per op, keyed by the same (VDAF, op, bucket) keys: both
  engines pick the same bucket at these sizes. The port's `compile` row
  is the cold first call of an (op, bucket) key, janus_tpu's the jit
  compile; both are the first dispatch of the key. janus_tpu's engine
  also books a `mesh:<program>` row for each program its single-controller
  lane enqueues; the port's single-device engine runs no lane (only a
  port mesh engine books those rows), so they are left out here.
- `DeviceCostLedger` given the same records answers janus_tpu's status
  and per-report table; the sampling profiler's shared pieces
  (`format_stack`, the thread-role taxonomy, the collapsed-stack check)
  and the boot timeline answer alike.
"""

import sys

import pytest

from janus_tpu import profiler as j_profiler
from janus_tpu_torch import profiler as t_profiler
from test_torch_ledger import by_op, drive


def engine_ops(delta: dict) -> dict:
    return {op: v for op, v in by_op(delta).items() if not op.startswith("mesh:")}


def engine_keys(delta: dict) -> set:
    return {k for k in delta if not k[1].startswith("mesh:")}


def test_device_cost_of_the_same_requests_has_janus_tpus_ops_dispatches_and_rows(monkeypatch):
    want = drive(monkeypatch, "jax-jax")["cost"]["jax"]
    got = drive(monkeypatch, "torch-torch")["cost"]["torch"]
    assert engine_ops(got) == engine_ops(want)
    assert engine_keys(got) == engine_keys(want)
    assert set(engine_ops(want)) == {"leader_init", "helper_init", "aggregate"}
    # the leader's and the helper's init: one dispatch each of all 6 rows
    assert engine_ops(want)["leader_init"] == (1, 6) and engine_ops(want)["helper_init"] == (1, 6)


@pytest.mark.parametrize("pairing", ["torch-jax", "jax-torch"])
def test_mixed_pairings_split_the_cost_by_package(monkeypatch, pairing):
    """Each package books its own side: a port leader its leader_init,
    a port helper its helper_init, as janus_tpu's do."""
    ref = engine_ops(drive(monkeypatch, "jax-jax")["cost"]["jax"])
    cost = drive(monkeypatch, pairing)["cost"]
    leader, helper = pairing.split("-")
    assert engine_ops(cost[leader])["leader_init"] == ref["leader_init"]
    assert engine_ops(cost[helper])["helper_init"] == ref["helper_init"]
    total = {}
    for side in cost.values():
        for op, (d, rows) in engine_ops(side).items():
            total[op] = (total.get(op, (0, 0))[0] + d, total.get(op, (0, 0))[1] + rows)
    assert total == ref


def _records(mod):
    ledger = mod.DeviceCostLedger()
    for vdaf, op, bucket, phase, s, rows, d in (
        ("sumvec", "helper_init", 1024, "compile", 1.5, 1000, 1),
        ("sumvec", "helper_init", 1024, "execute", 0.25, 1000, 1),
        ("sumvec", "helper_init", 1024, "h2d", 0.01, 0, 0),
        ("sumvec", "helper_init", 1024, "d2h", 0.02, 0, 0),
        ("sumvec", "aggregate", 32, "execute", 0.003, 20, 1),
        ("count", "leader_init", 64, "execute", 0.004, 50, 1),
    ):
        ledger.record(vdaf, op, bucket, phase, s, rows=rows, dispatches=d)
    with pytest.raises(ValueError):
        ledger.record("x", "y", 0, "warp", 1.0)
    return ledger


def test_device_cost_ledger_answers_janus_tpus_documents():
    t, j = _records(t_profiler), _records(j_profiler)
    assert t.status() == j.status()
    assert t.us_per_report() == j.us_per_report()
    assert t_profiler.COST_PHASES == j_profiler.COST_PHASES


def test_profiler_pieces_answer_alike():
    frame = sys._getframe()
    assert t_profiler.format_stack(frame, limit=8) == j_profiler.format_stack(frame, limit=8)
    assert t_profiler.ROLE_PREFIXES == j_profiler.ROLE_PREFIXES
    for name in ("device-watchdog-3", "mesh-dispatch", "device-lane_0", "step-http_1", "ingest-decrypt-2", "x"):
        assert t_profiler.thread_role(name) == j_profiler.thread_role(name)
    for text in ("main;a.b;c.d 3\n", "main;a b 1\n", "main;x\n", ""):
        assert t_profiler.validate_collapsed(text) == j_profiler.validate_collapsed(text)
    assert t_profiler.fold_component("a;b c\n") == j_profiler.fold_component("a;b c\n")
    prof = t_profiler.SamplingProfiler(t_profiler.ProfilerConfig(hz=50.0))
    assert prof.sample_once() >= 1
    assert t_profiler.validate_collapsed(prof.collapsed()) == []
    assert set(prof.status()) == set(j_profiler.SamplingProfiler().status())
    boot = t_profiler.BootTimeline(start_unix=0.0)
    boot.phase_done("imports")
    boot.mark_ready()
    snap = boot.snapshot()
    assert snap["ready"] and [p["phase"] for p in snap["phases"]] == ["imports"]
