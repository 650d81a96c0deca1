"""janus_tpu_torch's Poplar1 held against janus_tpu's.

- The device prepare: `vdaf/poplar1_device.prepare_init_batched` (the
  batched IDPF walk and sketch, on the CPU through the single-block
  Keccak's plain version) against janus_tpu's
  `vdaf/poplar1_jax.prepare_init_batched` and against the port's host
  walk `Poplar1.prepare_init`, for both parties, at the four (bits,
  level, prefixes) cases of tests/test_poplar1_jax.py: y, A, B, a and c.
  One 64-bit leaf case, with prefixes and alphas above 2^63, is held
  against the host walk only (on the JAX side it would compile 64
  unrolled levels). The walk launches 2(L+1)+1 single-block
  permutations at level L (counted through the wrapper's plain path).
- The host module: with both packages drawing from one seeded stream,
  `shard` gives the same public share and input shares, byte for byte;
  the codecs decode each other's bytes and refuse the same malformed
  ones; prepare_init / prepare_next / prepare_finish, aggregate and
  unshard give the same values (and the same VdafError for a forged
  report); `Poplar1AggParam` round-trips; `heavy_hitters` finds the same
  values; `Poplar1Ops.decode_param` refuses what janus_tpu's refuses.
- The protocol, in all four leader/helper pairings (the harness of
  tests/test_torch_multi_round.py): the Poplar1(4) heavy-hitters loop of
  tests/test_poplar1_dap.py, level by level, leaves the reference pair's
  aggregation jobs (up to their random ids), WAITING and FINISHED rows,
  batch aggregations keyed by the parameter and collection jobs, and both
  packages' collectors get the reference's counts, which equal the ground
  truth; the invalid (mismatched-key) report is rejected by both sides
  and the collection counts the honest report only.

The janus_tpu side of the pairings walks on the host (its own
`JANUS_POPLAR1_DEVICE=0` seam); its device walk is held by the first
part. The port runs with device="cpu"; tolerance: exact equality.
"""

import dataclasses
import re

import numpy as np
import pytest

from janus_tpu import messages as jm
from janus_tpu.aggregator import poplar1_ops as j_ops
from janus_tpu.vdaf import poplar1 as jp
from janus_tpu.vdaf import poplar1_jax
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch.aggregator import poplar1_ops as t_ops
from janus_tpu_torch.ops import keccak_cuda
from janus_tpu_torch.vdaf import poplar1 as tp
from janus_tpu_torch.vdaf import poplar1_device
from test_torch_multi_round import (  # noqa: F401  (_single_jax_device: an autouse fixture)
    PAIRINGS,
    Pairing,
    Seeded,
    _single_jax_device,
    make_tasks,
    prepare_reports,
    query_for,
)

VK = bytes(range(16))
CASES = [
    (4, 1, (0, 1, 2, 3)),  # inner level, Field64, full fan
    (4, 3, (0b0110, 0b1011, 0b1111)),  # leaf level, Field128
    (8, 4, (0b01101, 0b10000)),  # sparse prefixes mid-tree
    (2, 0, (0, 1)),  # minimal tree
]


def _shard_batch(poplar, alphas):
    keys0, keys1 = [], []
    for a in alphas:
        _, (k0, k1) = poplar.shard(a)
        keys0.append(k0)
        keys1.append(k1)
    return keys0, keys1


def _host_prepare(poplar, party, keys, param, nonces):
    out = ([], [], [], [], [])
    for key, nonce in zip(keys, nonces):
        state, msg1 = poplar.prepare_init(party, key, param, VK, nonce)
        for col, v in zip(out, ([int(y) for y in state.y_shares], msg1[0], msg1[1], state.a_share, state.c_share)):
            col.append(v)
    return out


# --- the device prepare ---------------------------------------------------------


@pytest.mark.parametrize("bits,level,prefixes", CASES)
@pytest.mark.parametrize("party", [0, 1])
def test_device_prepare_matches_janus_tpu_and_the_host_walk(bits, level, prefixes, party):
    poplar = tp.Poplar1(bits)
    rng = np.random.default_rng(bits * 131 + level)
    alphas = [int(rng.integers(0, 1 << bits)) for _ in range(5)]
    keys = _shard_batch(poplar, alphas)[party]
    param = tp.Poplar1AggParam(level, prefixes)
    nonces = [rng.bytes(16) for _ in alphas]
    keccak_cuda.keccak_single_block.launches = 0
    got = poplar1_device.prepare_init_batched(bits, party, keys, param, VK, nonces, device="cpu")
    assert keccak_cuda.keccak_single_block.launches == 0  # the plain version on the CPU

    # janus_tpu reads the same keys through its own codecs
    cws = jp.decode_public_share(bits, tp.encode_public_share(bits, keys[0].correction_words))
    j_keys = [
        jp.decode_input_share(bits, jp.decode_public_share(bits, tp.encode_public_share(bits, k.correction_words)),
                              tp.encode_input_share(k, party, bits), party)
        for k in keys
    ]
    assert cws == j_keys[0].correction_words
    want = poplar1_jax.prepare_init_batched(bits, party, j_keys, jp.Poplar1AggParam(level, prefixes), VK, nonces)
    assert got == want
    assert list(got) == [list(x) for x in _host_prepare(poplar, party, keys, param, nonces)]


def test_device_prepare_at_64_bits_matches_the_host_walk():
    """The sign bit: alphas and prefixes above 2^63 enter as int64
    reinterpretations; the leaf is level 63 (Field128)."""
    bits = 64
    poplar = tp.Poplar1(bits)
    alphas = [(1 << 63) + 7, (1 << 64) - 1, 5]
    prefixes = (5, (1 << 63) + 7, (1 << 64) - 1)
    keys0, keys1 = _shard_batch(poplar, alphas)
    nonces = [bytes([i]) * 16 for i in range(len(alphas))]
    param = tp.Poplar1AggParam(bits - 1, prefixes)
    for party, keys in ((0, keys0), (1, keys1)):
        got = poplar1_device.prepare_init_batched(bits, party, keys, param, VK, nonces, device="cpu")
        assert list(got) == [list(x) for x in _host_prepare(poplar, party, keys, param, nonces)]
    with pytest.raises(ValueError, match="64-bit lanes"):
        poplar1_device.prepare_init_batched(65, 0, keys0, param, VK, nonces, device="cpu")


def test_walk_launches_two_per_level_and_one_sample(monkeypatch):
    """2(L+1)+1 single-block permutations per party at level L (counted
    on the walk's calls into the kernel wrapper)."""
    calls = []
    real = poplar1_device.ctr_stream_lanes
    monkeypatch.setattr(poplar1_device, "ctr_stream_lanes", lambda *a, **k: calls.append(1) or real(*a, **k))
    bits, level = 6, 3
    poplar = tp.Poplar1(bits)
    keys = _shard_batch(poplar, [3, 40])[1]
    poplar1_device.prepare_init_batched(bits, 1, keys, tp.Poplar1AggParam(level, (1, 5, 9)), VK,
                                        [bytes(16)] * 2, device="cpu")
    assert len(calls) == 2 * (level + 1) + 1


def test_device_prepare_raises_without_cuda_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    poplar = tp.Poplar1(2)
    keys = _shard_batch(poplar, [1])[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        poplar1_device.prepare_init_batched(2, 0, keys, tp.Poplar1AggParam(0, (0, 1)), VK, [bytes(16)])


# --- the host module ------------------------------------------------------------


def _seed_both(monkeypatch, seed: int):
    for mod in (jp, tp):
        monkeypatch.setattr(mod, "secrets", Seeded(seed))


@pytest.mark.parametrize("bits", [1, 4, 16])
def test_shard_and_codecs_match_janus_tpu(monkeypatch, bits):
    _seed_both(monkeypatch, bits)
    alpha = (0b1011011 * 977) % (1 << bits)
    j_cws, (j0, j1) = jp.Poplar1(bits).shard(alpha)
    t_cws, (t0, t1) = tp.Poplar1(bits).shard(alpha)
    pub = jp.encode_public_share(bits, j_cws)
    assert tp.encode_public_share(bits, t_cws) == pub
    assert tp.decode_public_share(bits, pub) == j_cws
    for party, jk, tk in ((0, j0, t0), (1, j1, t1)):
        raw = jp.encode_input_share(jk, party, bits)
        assert tp.encode_input_share(tk, party, bits) == raw
        assert tp.decode_input_share(bits, t_cws, raw, party) == tk
    # malformed shares: the same errors
    bad_pubs = [pub[:-1], pub + b"\x00", pub[:16] + b"\x07" + pub[17:]]
    bad_inputs = [(jp.encode_input_share(j0, 0, bits)[:-1], 0), (jp.encode_input_share(j1, 1, bits) + b"\x00", 1)]
    for raw in bad_pubs:
        with pytest.raises(ValueError) as want:
            jp.decode_public_share(bits, raw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tp.decode_public_share(bits, raw)
    for raw, party in bad_inputs:
        with pytest.raises(ValueError) as want:
            jp.decode_input_share(bits, j_cws, raw, party)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            tp.decode_input_share(bits, t_cws, raw, party)


def test_prepare_aggregate_and_unshard_match_janus_tpu(monkeypatch):
    bits = 5
    _seed_both(monkeypatch, 9)
    alphas = [0b10110, 0b10110, 0b00111, 0b11111]
    j_keys = _shard_batch(jp.Poplar1(bits), alphas)
    t_keys = _shard_batch(tp.Poplar1(bits), alphas)
    for level, prefixes in ((1, (0b01, 0b10, 0b11)), (bits - 1, (0b10110, 0b11111))):
        outs = {}
        for pkg, mod, keys in (("jax", jp, j_keys), ("torch", tp, t_keys)):
            poplar = mod.Poplar1(bits)
            param = mod.Poplar1AggParam(level, prefixes)
            out0, out1 = [], []
            for i, (k0, k1) in enumerate(zip(*keys)):
                nonce = i.to_bytes(16, "big")
                st0, m0 = poplar.prepare_init(0, k0, param, VK, nonce)
                st1, m1 = poplar.prepare_init(1, k1, param, VK, nonce)
                st0, s0 = poplar.prepare_next(st0, [m0, m1])
                st1, s1 = poplar.prepare_next(st1, [m0, m1])
                out0.append(poplar.prepare_finish(st0, [s0, s1]))
                out1.append(poplar.prepare_finish(st1, [s0, s1]))
            aggs = [poplar.aggregate(param, out0), poplar.aggregate(param, out1)]
            outs[pkg] = (out0, out1, aggs, poplar.unshard(param, aggs))
        assert outs["torch"] == outs["jax"]
        want = [sum(1 for a in alphas if a >> (bits - 1 - level) == p) for p in prefixes]
        assert outs["torch"][3] == want
    # a forged (mismatched-key) report fails the sketch in both
    for mod, keys in ((jp, j_keys), (tp, t_keys)):
        poplar = mod.Poplar1(bits)
        param = mod.Poplar1AggParam(2, (0, 5, 7))
        st0, m0 = poplar.prepare_init(0, keys[0][0], param, VK, bytes(16))
        st1, m1 = poplar.prepare_init(1, keys[1][2], param, VK, bytes(16))
        st0, s0 = poplar.prepare_next(st0, [m0, m1])
        st1, s1 = poplar.prepare_next(st1, [m0, m1])
        with pytest.raises(Exception, match="not one-hot") as e:
            poplar.prepare_finish(st0, [s0, s1])
        assert type(e.value).__name__ == "VdafError"


def test_agg_param_ops_and_heavy_hitters_match_janus_tpu(monkeypatch):
    bits = 6
    for level, prefixes in ((0, (0, 1)), (5, (3, 17, 63))):
        raw = jp.Poplar1AggParam(level, prefixes).encode()
        assert tp.Poplar1AggParam(level, prefixes).encode() == raw
        assert tp.Poplar1AggParam.decode(raw) == tp.Poplar1AggParam(level, prefixes)
    j_o, t_o = j_ops.Poplar1Ops(bits, VK), t_ops.Poplar1Ops(bits, VK, device="cpu")
    for level, prefixes in ((6, (0,)), (2, ()), (1, (4,)), (2, (3, 1)), (2, (1, 1))):
        raw = jp.Poplar1AggParam(level, prefixes).encode()
        with pytest.raises(ValueError) as want:
            j_o.decode_param(raw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            t_o.decode_param(raw)
    _seed_both(monkeypatch, 13)
    alphas = [9, 9, 9, 40, 40, 40, 7, 63]
    found = []
    for mod in (jp, tp):
        poplar = mod.Poplar1(bits)
        keys = _shard_batch(poplar, alphas)
        found.append(mod.heavy_hitters(poplar, *keys, threshold=3, verify_key=VK))
    assert found[0] == found[1] == [9, 40]


def test_ops_round1_batch_matches_janus_tpu_ops(monkeypatch):
    """Poplar1Ops.round1_batch over wire shares, a malformed one included:
    the same states, y shares and sketch shares, the same refusal."""
    monkeypatch.setenv("JANUS_POPLAR1_DEVICE", "0")
    bits = 4
    _seed_both(monkeypatch, 21)
    items = []
    for i, a in enumerate([3, 12, 12]):
        cws, (k0, _) = jp.Poplar1(bits).shard(a)
        items.append((jp.encode_public_share(bits, cws), jp.encode_input_share(k0, 0, bits), bytes([i]) * 16))
    items.append((items[0][0][:-1], items[0][1], bytes(16)))
    param_raw = jp.Poplar1AggParam(2, (1, 3, 6)).encode()
    j_o, t_o = j_ops.Poplar1Ops(bits, VK), t_ops.Poplar1Ops(bits, VK, device="cpu")
    want = j_o.round1_batch(0, items, j_o.decode_param(param_raw))
    got = t_o.round1_batch(0, items, t_o.decode_param(param_raw))
    assert [type(x).__name__ for x in got] == [type(x).__name__ for x in want]
    assert str(got[3]) == str(want[3])
    for (gs, gy, gm), (ws, wy, wm) in zip(got[:3], want[:3]):
        assert (gy, gm, gs.a_share, gs.c_share, gs.party) == (wy, wm, ws.a_share, ws.c_share, ws.party)


# --- the protocol, four pairings ------------------------------------------------


BITS = 4
HH_VDAF = j_registry.VdafInstance.poplar1(BITS)
HH_TASKS = make_tasks(HH_VDAF, max_batch_query_count=BITS + 1)
HH_MEASUREMENTS = [0b1010, 0b1010, 0b1010, 0b0110, 0b0110, 0b0001]
HH_REPORTS = prepare_reports(HH_TASKS[0], HH_TASKS[1], HH_MEASUREMENTS)
_REFERENCE: dict = {}


def _drive(pair, rounds: int = 8) -> None:
    """The collection and aggregation drivers until quiescent."""
    cjobs, ajobs = pair.collection_jobs(), pair.agg_jobs()
    for _ in range(rounds):
        if not cjobs.run_once() + ajobs.run_once():
            return
    raise AssertionError("the drivers did not settle")


def heavy_hitters_run(monkeypatch, leader: str, helper: str):
    pair = Pairing(monkeypatch, leader, helper, *HH_TASKS)
    try:
        pair.upload(HH_REPORTS)
        assert pair.create_jobs() == 0  # a parameterized VDAF's jobs come from the collection
        m = pair.lp.m
        levels = []
        prefixes = [0, 1]
        threshold = 2
        for level in range(BITS):
            agg_param = jp.Poplar1AggParam(level, tuple(sorted(prefixes))).encode()
            job_id = pair.collector(leader).start_collection(query_for(m), agg_param=agg_param).data
            _drive(pair)
            results = pair.poll_all(job_id, agg_param)
            (count, _, counts), = set((r[0], r[1], tuple(r[2])) for r in results.values())
            levels.append((agg_param, results, pair.rows()))
            survivors = [p for p, c in zip(sorted(prefixes), counts) if c >= threshold]
            prefixes = [p << 1 for p in survivors] + [(p << 1) | 1 for p in survivors]
        return {"levels": levels, "heavy": survivors}
    finally:
        pair.close()


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_heavy_hitters_leave_janus_tpu_rows_in_every_pairing(monkeypatch, pairing):
    if "hh" not in _REFERENCE:
        _REFERENCE["hh"] = heavy_hitters_run(monkeypatch, "jax", "jax")
    want = _REFERENCE["hh"]
    got = heavy_hitters_run(monkeypatch, *pairing.split("-")) if pairing != "jax-jax" else want
    assert got == want
    assert want["heavy"] == [0b0110, 0b1010]
    for level, (raw, results, rows) in enumerate(want["levels"]):
        param = jp.Poplar1AggParam.decode(raw)
        expected = [sum(1 for x in HH_MEASUREMENTS if x >> (BITS - 1 - level) == p) for p in param.prefixes]
        assert results["jax"] == results["torch"]
        assert results["jax"][0] == len(HH_MEASUREMENTS) and results["jax"][2] == expected
        # one job a level, every row finished on both sides, and the batch
        # rows keyed by each collected parameter
        for side in ("leader", "helper"):
            assert len(rows[side]["jobs"]) == level + 1
            assert {ra[3] for job in rows[side]["jobs"] for ra in job[2]} == {"finished"}
            assert {b[1] for b in rows[side]["batches"]} == {r[0] for r in want["levels"][: level + 1]}


def _corrupt(client, measurement, when=None):
    """tests/test_poplar1_dap.py's corrupt report: the leader's key of one
    sharding with the helper's key of another."""
    from janus_tpu.client import Client
    from janus_tpu.core.hpke import HpkeApplicationInfo, Label, hpke_seal

    report = Client.prepare_report(client, measurement, when=when)
    poplar = jp.Poplar1(BITS)
    cws_a, (k0_a, _) = poplar.shard(0b1100)
    _, (_, k1_b) = poplar.shard(0b0011)
    public = jp.encode_public_share(BITS, cws_a)
    aad = jm.InputShareAad(client.params.task_id, report.metadata, public).to_bytes()
    seal = [
        hpke_seal(cfg, HpkeApplicationInfo(Label.INPUT_SHARE, jm.Role.CLIENT, role),
                  jm.PlaintextInputShare((), jp.encode_input_share(key, party, BITS)).to_bytes(), aad)
        for cfg, role, key, party in ((client.leader_hpke_config, jm.Role.LEADER, k0_a, 0),
                                      (client.helper_hpke_config, jm.Role.HELPER, k1_b, 1))
    ]
    return dataclasses.replace(report, public_share=public, leader_encrypted_input_share=seal[0],
                               helper_encrypted_input_share=seal[1])


INVALID_REPORTS = prepare_reports(HH_TASKS[0], HH_TASKS[1], [0b1100]) + prepare_reports(
    HH_TASKS[0], HH_TASKS[1], [0], prepare=_corrupt)


def invalid_report_run(monkeypatch, leader: str, helper: str):
    pair = Pairing(monkeypatch, leader, helper, *HH_TASKS)
    try:
        pair.upload(INVALID_REPORTS)
        m = pair.lp.m
        agg_param = jp.Poplar1AggParam(0, (0, 1)).encode()
        job_id = pair.collector(leader).start_collection(query_for(m), agg_param=agg_param).data
        _drive(pair)
        return {"results": pair.poll_all(job_id, agg_param), "rows": pair.rows()}
    finally:
        pair.close()


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_invalid_report_is_rejected_by_both_sides_in_every_pairing(monkeypatch, pairing):
    if "invalid" not in _REFERENCE:
        _REFERENCE["invalid"] = invalid_report_run(monkeypatch, "jax", "jax")
    want = _REFERENCE["invalid"]
    got = invalid_report_run(monkeypatch, *pairing.split("-")) if pairing != "jax-jax" else want
    assert got == want
    assert {k: (v[0], v[2]) for k, v in want["results"].items()} == {"jax": (1, [0, 1]), "torch": (1, [0, 1])}
    corrupt_id = INVALID_REPORTS[1].metadata.report_id.data
    for side in ("leader", "helper"):
        (job,) = want["rows"][side]["jobs"]
        states = {ra[1]: (ra[3], ra[5]) for ra in job[2]}
        assert set(states.values()) == {("finished", None), states[corrupt_id]}
        assert states[corrupt_id][0] == "failed"
    # the leader's sketch check fails the report: VDAF_PREP_ERROR
    assert {ra[1]: ra[5] for ra in want["rows"]["leader"]["jobs"][0][2]}[corrupt_id] == int(
        jm.PrepareError.VDAF_PREP_ERROR)
