"""`python -m janus_tpu_torch.tools.chaos_run --scenario resident`, the
counterpart of janus_tpu's resident smoke (tests/test_tools.py's
`resident_smoke` record), on the CPU (`--device cpu`), as a process; and
the byte cap the scenario sizes from the port's own Count row.

The real job driver binary runs in resident mode under a byte cap of
exactly one Count slot: the second task's merge evicts through the flush
path, the third job's dispatch wedges (`engine.dispatch` hang after 4)
and steps back `device_hang` under the 2 s hang bound, the quarantine
sweep flushes a slot, the sparse task's merges run the scatter kernel's
wrapper in the binary while the Count engine is quarantined, and after
the canary's restore (two failed probes first) a last job lands resident
and the SIGTERM drain flushes it. Every collection equals its ground
truth exactly. Divergence: no host engine re-steps the wedged job — it
steps back `device_quarantined` until the restore.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.aggregator.engine_cache import EngineCache, resident_bytes_total
from janus_tpu_torch.convert import step_args_to_numpy
from janus_tpu_torch.messages import Duration, Interval, Time
from janus_tpu_torch.tools import chaos_run
from janus_tpu_torch.vdaf.registry import VdafInstance
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

from test_torch_chaos import _run, ok_key_pattern

REPO = Path(__file__).resolve().parent.parent


def test_cap_holds_exactly_one_port_count_slot(monkeypatch):
    """count_slot_nbytes() is what the engine charges a Count slot: under
    that cap one slot stays resident, and a second (another task's
    engine) overflows it and is flushed. It is janus_tpu's 8 bytes, the
    cap its script writes."""
    slot = chaos_run.count_slot_nbytes()
    j_src = (REPO / "scripts" / "chaos_run.py").read_text()
    assert slot == 8 and "resident_max_bytes: 8\\n" in j_src
    t_ec.engine_cache.cache_clear()
    monkeypatch.setattr(EngineCache, "RESIDENT_MAX_BYTES", slot)
    try:
        inst = VdafInstance.count()
        rng = np.random.default_rng(3)
        iv = Interval(Time(0), Duration(3600))
        flushed = []
        for i, vk in enumerate((bytes(16), bytes(range(16)))):
            eng = t_ec.engine_cache(inst, vk, device="cpu")
            args, _ = make_report_batch(inst, random_measurements(inst, 4, rng), seed=90 + i,
                                        device=torch.device("cpu"))
            nonce, public, mv, proof, blind0 = step_args_to_numpy(args)[:5]
            out0, _, _, _ = eng.leader_init(nonce, public, mv, proof, blind0)
            pend = eng.aggregate_pending(out0, np.zeros(4, np.int32), 1)
            assert pend.row_nbytes == slot
            flushed.append(eng.resident_merge([((b"t%d" % i, b"", b"bid"), 0, 4, iv)], pend))
        # the first slot fit; the second overflowed the one-slot cap
        assert flushed[0] == [] and len(flushed[1]) == 1
        assert resident_bytes_total() == slot
    finally:
        t_ec.engine_cache.cache_clear()


def test_chaos_resident_smoke(tmp_path):
    rec = _run(tmp_path, "--scenario", "resident", "--smoke", timeout=300)
    assert rec["schedule"] == "resident_smoke" and rec["device"] == "cpu"
    assert all(ok_key_pattern("run_resident").fullmatch(k) for k in rec if k.endswith("_ok"))
    # janus_tpu's assertions of its smoke
    assert rec["eviction_flush_ok"] is True
    assert rec["quarantined_observed_ok"] and rec["quarantine_flush_ok"]
    assert rec["stepped_back_device_hang_ok"] is True
    assert rec["restored_ok"] and rec["resident_before_drain_ok"]
    assert rec["no_lost_flushes_ok"] is True
    assert rec["drain_ok"] is True
    assert rec["exactly_once_a_ok"] and rec["exactly_once_b_ok"]
    # the port's: the cap holds exactly one port Count slot, the wedge
    # stepped back under the hang bound inside the 6 s lease, the sparse
    # task rode along through the scatter path and collected exactly
    assert rec["resident_max_bytes"] == rec["count_slot_nbytes"] == chaos_run.count_slot_nbytes()
    assert rec["cap_one_count_slot_ok"] is True
    assert rec["hang_after_s"] <= rec["wedge_to_step_back_s"] < rec["lease_ttl_s"]
    assert rec["step_backs"].get('reason="device_quarantined"', 0) >= 1, rec["step_backs"]
    assert rec["sparse_scatter_observed_ok"] and rec["sparse_eviction_flush_ok"]
    assert rec["exactly_once_s_ok"] is True and rec["admitted_s"] == 3
    assert rec["flush_samples"]['outcome="flushed",reason="quarantine"'] >= 1
    assert rec["driver_devices"] == ["cpu"]


@pytest.mark.slow  # the same waves (janus_tpu's full schedule differs only by name)
@pytest.mark.chaos
def test_chaos_resident_full_schedule(tmp_path):
    rec = _run(tmp_path, "--scenario", "resident", timeout=540)
    assert rec["schedule"] == "resident_full"
    assert rec["exactly_once_a_ok"] and rec["exactly_once_b_ok"] and rec["exactly_once_s_ok"]
