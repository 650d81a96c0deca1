"""janus_tpu_torch's CountVec and FixedPointVec held against janus_tpu's.

- FixedPointVec at 16, 32 and 64 bits: its constants, and its refusals
  (a length whose integer norm would wrap mod p, a vector whose L2 norm
  is not below 1), are janus_tpu's.
- The host sharder (vdaf/reference.py, the client's) gives janus_tpu's
  public share and input shares bit for bit, for FixedPointVec at each
  width and a CountVec, in both XOF modes.
- The batched encoding is janus_tpu's, 64-bit entries included, and the
  device prepare of FixedPointVec(4, 16) (two_party_step and
  helper_init_step) equals janus_tpu's on the same corrupted batch.
- The device prepare rejects a false norm claim and a forged entry bit
  (janus_tpu's tests/test_vdaf_reference.py cases, on the card's path).
- The collector's decode gives janus_tpu's floats.
- janus_tpu's DP end-to-end case (tests/test_dp.py): a port pair and a
  janus_tpu pair each take two FixedPointVec(2, 16) uploads, aggregate
  and collect them with discrete-Gaussian noise drawn from equal seeded
  streams, and give the same collection.
- Task dicts of countvec and fixedpoint load in the other package.

The port runs with device="cpu"; every comparison is exact equality.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from janus_tpu import client as j_client_mod
from janus_tpu import dp as j_dp
from janus_tpu.parallel import api as j_api
from janus_tpu.vdaf import engine as j_engine
from janus_tpu.vdaf import reference as j_reference
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import client as t_client_mod
from janus_tpu_torch import dp as t_dp
from janus_tpu_torch.convert import step_args_from_jax, step_args_to_numpy
from janus_tpu_torch.parallel import api as t_api
from janus_tpu_torch.vdaf import circuits as tc
from janus_tpu_torch.vdaf import engine as t_engine
from janus_tpu_torch.vdaf import reference as t_reference
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import testing as t_testing
from test_torch_prio3 import MEAS_CORRUPT, PROOF_CORRUPT, assert_same_field, assert_same_lanes, corrupt

CPU = torch.device("cpu")
VERIFY_KEY = bytes(range(16, 32))

CONSTANTS = ("length", "bits", "norm_bits", "n_bits", "input_len", "output_len", "offset", "chunk_length",
             "calls_bits", "calls_sq", "joint_rand_len", "algo_id", "proof_len", "verifier_len",
             "prove_rand_len", "query_rand_len")


@pytest.mark.parametrize("length,bits,chunk", [(1000, 16, 0), (7, 32, 3), (3, 64, 0), (1, 64, 2)])
def test_fixed_point_constants_match_janus_tpu(length, bits, chunk):
    t = tc.FixedPointVec(length, bits, chunk_length=chunk or None)
    j = j_reference.FixedPointVec(length, bits, chunk_length=chunk or None)
    assert {k: getattr(t, k) for k in CONSTANTS} == {k: getattr(j, k) for k in CONSTANTS}
    use_t, use_j = t.gadget_uses[0], j.gadget_uses[0]
    assert (use_t.calls, use_t.wire_poly_len, use_t.gadget_poly_len, use_t.gadget.arity) == (
        use_j.calls, use_j.wire_poly_len, use_j.gadget_poly_len, use_j.gadget.arity
    )


@pytest.mark.parametrize("length,bits", [(4, 64), (1 << 98, 16), (2, 8), (0, 16)])
def test_fixed_point_refusals_match_janus_tpu(length, bits):
    with pytest.raises(ValueError) as want:
        j_reference.FixedPointVec(length, bits)
    with pytest.raises(ValueError) as got:
        tc.FixedPointVec(length, bits)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("bits", [16, 32, 64])
def test_norm_of_one_or_more_is_refused_as_in_janus_tpu(bits):
    half = 1 << (bits - 1)
    circ_t, circ_j = tc.FixedPointVec(2, bits), j_reference.FixedPointVec(2, bits)
    # norms 2 (2^(b-1) - 1)^2 and (-2^(b-1))^2 = 4^(b-1): neither below 4^(b-1)
    for meas in ([half - 1, half - 1], [-half, 0]):
        with pytest.raises(AssertionError):
            circ_j.encode(meas)
        with pytest.raises(AssertionError):
            t_reference.encode(circ_t, meas)
        with pytest.raises(AssertionError):
            t_engine.batched_circuit(circ_t).encode_batch([meas])
    for ok in ([half // 2, -(half // 2)], [half - 1, 0], [-half + 1, 0]):  # norms below 4^(b-1)
        assert t_reference.encode(circ_t, ok) == circ_j.encode(ok)


SHARD_CASES = {
    "fixedpoint16": ({"kind": "fixedpoint", "length": 5, "bits": 16}, [[1000, -2000, 0, 5, -1]]),
    "fixedpoint32": ({"kind": "fixedpoint", "length": 3, "bits": 32}, [[1 << 29, -(1 << 28), 7]]),
    "fixedpoint64": ({"kind": "fixedpoint", "length": 3, "bits": 64}, [[1 << 61, -(1 << 62), -(1 << 60) + 3]]),
    "countvec": ({"kind": "countvec", "length": 9, "bits": 1}, [[1, 0, 1, 1, 0, 0, 1, 0, 1]]),
}


@pytest.mark.parametrize("mode", ["fast", "draft"])
@pytest.mark.parametrize("name", list(SHARD_CASES))
def test_host_shard_is_janus_tpus(name, mode):
    kw, (meas,) = SHARD_CASES[name]
    t_host = t_registry.prio3_host(t_registry.VdafInstance(**kw, xof_mode=mode))
    j_host = j_registry.prio3_host(j_registry.VdafInstance(**kw, xof_mode=mode))
    rng = np.random.default_rng(9)
    nonce, rand = rng.bytes(16), rng.bytes(t_host.rand_size)
    assert t_host.rand_size == j_host.rand_size
    t_parts, (t_l, t_h) = t_host.shard(meas, nonce, rand)
    j_parts, (j_l, j_h) = j_host.shard(meas, nonce, rand)
    assert list(t_parts) == list(j_parts)
    assert (t_l.measurement_share, t_l.proof_share, t_l.joint_rand_blind) == (
        j_l.measurement_share, j_l.proof_share, j_l.joint_rand_blind
    )
    assert (t_h.seed, t_h.joint_rand_blind) == (j_h.seed, j_h.joint_rand_blind)


@pytest.mark.parametrize("bits", [16, 32, 64])
def test_batched_encoding_is_janus_tpus(bits):
    length = 3 if bits == 64 else 6
    t_inst = t_registry.VdafInstance.fixed_point_vec(length, bits)
    j_inst = j_registry.VdafInstance.fixed_point_vec(length, bits)
    meas = t_testing.random_measurements(t_inst, 5, np.random.default_rng(4))
    half = 1 << (bits - 1)
    meas = np.concatenate([meas, [[-half // 2, half // 2 - 1] + [0] * (length - 2)]])  # entries far from 0
    t_rows = t_engine.batched_circuit(t_registry.circuit_for(t_inst)).encode_batch(meas)
    j_rows = j_engine.batched_circuit(j_registry.circuit_for(j_inst)).encode_batch(meas)
    assert t_rows.dtype == np.uint64 and (t_rows == j_rows).all()
    # the host encoding, row by row
    circ = t_registry.circuit_for(t_inst)
    assert [list(map(int, r)) for r in t_rows] == [t_reference.encode(circ, list(m)) for m in meas]


# --- the device prepare ----------------------------------------------------------


def test_device_prepare_matches_janus_tpu():
    """FixedPointVec(4, 16) at batch 6, two reports corrupted, sharded by
    both packages (equal batches), prepared by both (one JAX compile)."""
    t_inst = t_registry.VdafInstance.fixed_point_vec(4, 16)
    j_inst = j_registry.VdafInstance.fixed_point_vec(4, 16)
    meas = t_testing.random_measurements(t_inst, 6, np.random.default_rng(7))
    t_args, _ = t_testing.make_report_batch(t_inst, meas, seed=11, device=CPU)
    port_np = step_args_to_numpy(t_args)
    p3 = t_registry.prio3_batched(t_inst, CPU)
    # the query runs the generic route, and it never streams
    assert p3.plan is None and t_engine.stream_plan(p3.bc, min_input_len=1) is None
    jax_in = corrupt(port_np, p3.tf.MODULUS)
    agg0, agg1, count = t_api.two_party_step(t_inst, VERIFY_KEY, device=CPU)(*step_args_from_jax(jax_in, CPU))
    j_agg0, j_agg1, j_count = j_api.two_party_step(j_inst, VERIFY_KEY)(*jax_in)
    assert_same_field(agg0, j_agg0, "agg0")
    assert_same_field(agg1, j_agg1, "agg1")
    assert int(count) == int(j_count) == 4
    port_in = step_args_from_jax(jax_in, CPU)
    out1 = t_api.helper_init_step(t_inst, VERIFY_KEY, device=CPU)(port_in[0], port_in[1], port_in[5], port_in[6])
    j_out1 = j_api.helper_init_step(j_inst, VERIFY_KEY)(jax_in[0], jax_in[1], jax_in[5], jax_in[6])
    assert_same_field(out1[0], j_out1[0], "helper out share")
    assert_same_lanes(out1[1], j_out1[1], "helper corrected seed")
    assert_same_field(out1[2], j_out1[2], "helper verifier share")
    assert_same_lanes(out1[3], j_out1[3], "helper joint-rand part")
    # the aggregate is the offset-binary sum of the valid reports, and
    # decodes to their float sum
    valid = np.ones(6, dtype=bool)
    valid[[PROOF_CORRUPT, MEAS_CORRUPT]] = False
    total = [int(v) for v in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    offset = 1 << 15
    assert total == [int(v) for v in (np.asarray(meas)[valid] + offset).sum(axis=0)]
    assert p3.circ.decode(total, int(count)) == [float(v) / offset for v in np.asarray(meas)[valid].sum(axis=0)]


@pytest.mark.parametrize("forgery", ["false-norm-claim", "entry-bit"])
def test_device_prepare_rejects_forged_encodings(forgery, monkeypatch):
    """An honest prover over a forged input: a norm claimed 0 for a
    nonzero vector, or an entry 'bit' of 2. The device prepare rejects
    exactly that report."""
    inst = t_registry.VdafInstance.fixed_point_vec(2, 16)
    p3 = t_registry.prio3_batched(inst, CPU)
    circ = p3.circ
    meas = [[1 << 14, 1 << 14], [100, -100], [0, 0]]
    honest = p3.bc.encode_batch(meas)
    forged = honest.copy()
    if forgery == "false-norm-claim":
        forged[0, circ.length * circ.bits :] = 0
    else:
        forged[1, 0] = 2
    monkeypatch.setattr(p3.bc, "encode_batch", lambda m: forged)
    args, _ = t_testing.make_report_batch(inst, meas, seed=5, device=CPU)
    monkeypatch.undo()
    agg0, agg1, count = t_api.two_party_step(inst, VERIFY_KEY, device=CPU)(*args)
    assert int(count) == 2
    bad = 0 if forgery == "false-norm-claim" else 1
    total = [int(v) for v in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    good = [m for i, m in enumerate(meas) if i != bad]
    assert total == [sum(m[e] + (1 << 15) for m in good) for e in range(2)]


@pytest.mark.parametrize("bits", [16, 32, 64])
def test_collector_decode_is_janus_tpus(bits):
    length = 3
    t_host = t_registry.prio3_host(t_registry.VdafInstance.fixed_point_vec(length, bits))
    j_host = j_registry.prio3_host(j_registry.VdafInstance.fixed_point_vec(length, bits))
    p = t_host.circuit.FIELD.MODULUS
    rng = np.random.default_rng(bits)
    for count in (1, 2, 9):
        offset = 1 << (bits - 1)
        sums = [int(x) for x in rng.integers(-offset // 4, offset // 4, size=length)]
        agg = [(s + count * offset) % p for s in sums]
        split = [int(x) for x in rng.integers(0, 1 << 62, size=length)]
        shares = [[(a - s) % p for a, s in zip(agg, split)], split]
        got = t_host.unshard(shares, count)
        assert got == j_host.unshard(shares, count)
        assert got == [s / offset for s in sums]


# --- DP end to end ------------------------------------------------------------------


class _Seeded:
    """A stand-in for `secrets`: token_bytes and randbelow from one seeded stream."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def token_bytes(self, n: int) -> bytes:
        return self.rng.bytes(n)

    def randbelow(self, n: int) -> int:
        return int.from_bytes(self.rng.bytes(16), "big") % n


def dp_pair_collects(pkg: str):
    """tests/test_dp.py's DP end-to-end case on a pair of `pkg`: two
    FixedPointVec(2, 16) uploads through the Client, one aggregation job,
    one collection with sigma 4. Returns (report_count, result)."""
    from test_torch_collect import PKG

    p = PKG[pkg]
    if pkg == "jax":
        from janus_tpu import client as client_mod
        from janus_tpu.aggregator import aggregation_job_creator as creator_mod
        from janus_tpu.aggregator import aggregation_job_driver as adriver_mod
        from janus_tpu.task import QueryTypeConfig, TaskBuilder
        from janus_tpu.vdaf.registry import VdafInstance

        device = {}
    else:
        from janus_tpu_torch import client as client_mod
        from janus_tpu_torch.aggregator import aggregation_job_creator as creator_mod
        from janus_tpu_torch.aggregator import aggregation_job_driver as adriver_mod
        from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
        from janus_tpu_torch.vdaf.registry import VdafInstance

        device = {"device": "cpu"}
    m = p.m
    leader_eph, helper_eph = p.eph(), p.eph()
    leader, helper = p.aggregator(leader_eph), p.aggregator(helper_eph)
    leader_srv = p.http.DapServer(p.http.DapHttpApp(leader)).start()
    helper_srv = p.http.DapServer(p.http.DapHttpApp(helper)).start()
    try:
        vdaf = VdafInstance.fixed_point_vec(length=2, bits=16)
        collector_kp = p.hpke.generate_hpke_config_and_private_key(config_id=200)
        dp_mod = j_dp if pkg == "jax" else t_dp
        leader_task = (
            TaskBuilder(QueryTypeConfig.time_interval(), vdaf, m.Role.LEADER)
            .with_(
                leader_aggregator_endpoint=leader_srv.url,
                helper_aggregator_endpoint=helper_srv.url,
                collector_hpke_config=collector_kp.config,
                vdaf_verify_key=VERIFY_KEY,
                min_batch_size=1,
                dp_strategy=dp_mod.DpStrategy("discrete_gaussian", 4.0),
            )
            .build()
        )
        helper_task = dataclasses.replace(
            leader_task, role=m.Role.HELPER, hpke_keys=(p.hpke.generate_hpke_config_and_private_key(config_id=1),)
        )
        leader_eph.datastore.run_tx(lambda tx: tx.put_task(leader_task))
        helper_eph.datastore.run_tx(lambda tx: tx.put_task(helper_task))
        http = p.client.HttpClient(timeout=30)
        params = client_mod.ClientParameters(
            leader_task.task_id, leader_srv.url, helper_srv.url, leader_task.time_precision
        )
        client = client_mod.Client.with_fetched_configs(params, vdaf, http, clock=leader_eph.clock)
        for meas in ([0.25, -0.5], [0.25, 0.25]):
            client.upload(t_reference.fp_encode_floats(meas, 16))
        creator = creator_mod.AggregationJobCreator(
            leader_eph.datastore, creator_mod.AggregationJobCreatorConfig(min_aggregation_job_size=1)
        )
        assert creator.run_once() == 1
        drv = adriver_mod.AggregationJobDriver(
            leader_eph.datastore, http, adriver_mod.AggregationJobDriverConfig(http_backoff=p.retries.Backoff.test()),
            **device,
        )
        cfg = p.jobs.JobDriverConfig(max_concurrent_job_workers=1)
        assert p.jobs.JobDriver(cfg, drv.acquirer(), drv.stepper).run_once() == 1
        start = leader_eph.clock.now().to_batch_interval_start(leader_task.time_precision)
        query = m.Query.time_interval(m.Interval(m.Time(start.seconds - 3600), m.Duration(2 * 3600)))
        collector = p.collector.Collector(
            p.collector.CollectorParameters(
                leader_task.task_id, leader_srv.url, leader_task.collector_auth_token, collector_kp
            ),
            vdaf, http,
        )
        job_id = collector.start_collection(query)
        cdrv = p.cdriver.CollectionJobDriver(
            leader_eph.datastore, http, p.cdriver.CollectionJobDriverConfig(http_backoff=p.retries.Backoff.test())
        )
        assert p.jobs.JobDriver(cfg, cdrv.acquirer(), cdrv.stepper).run_once() == 1
        result = collector.poll_once(job_id, query)
        return result.report_count, result.aggregate_result
    finally:
        leader_srv.stop()
        helper_srv.stop()
        leader.close()
        helper.close()
        leader_eph.cleanup()
        helper_eph.cleanup()


def test_dp_end_to_end_fixed_point_matches_janus_tpu_pair(monkeypatch):
    from janus_tpu.aggregator import aggregation_job_creator as j_creator
    from janus_tpu_torch.aggregator import aggregation_job_creator as t_creator

    # one JAX device for the janus_tpu engines (the conftest makes eight)
    monkeypatch.setenv("JANUS_MESH_DP", "1")
    monkeypatch.setenv("JANUS_MESH_SP", "1")
    out = {}
    for pkg, mods in (("jax", (j_client_mod, j_reference, j_creator, j_dp)),
                      ("torch", (t_client_mod, t_reference, t_creator, t_dp))):
        stream = _Seeded(31)
        for mod in mods:
            monkeypatch.setattr(mod, "secrets", stream)
        out[pkg] = dp_pair_collects(pkg)
    assert out["torch"] == out["jax"]
    count, result = out["torch"]
    assert count == 2
    tol = 12 * 4.0 * math.sqrt(2) / (1 << 15)  # 12 sigma of the two shares' noise, in value space
    assert all(abs(g - w) <= tol for g, w in zip(result, [0.5, -0.25]))
    assert result != [0.5, -0.25]  # noised


# --- registry dicts --------------------------------------------------------------


@pytest.mark.parametrize(
    "make,kw",
    [("count_vec", {"length": 200_000}), ("count_vec", {"length": 9, "chunk_length": 3}),
     ("fixed_point_vec", {"length": 1000}), ("fixed_point_vec", {"length": 7, "bits": 32}),
     ("fixed_point_vec", {"length": 3, "bits": 64, "chunk_length": 5})],
)
@pytest.mark.parametrize("mode", ["fast", "draft"])
def test_registry_dicts_round_trip_across_packages(make, kw, mode):
    j_inst = dataclasses.replace(getattr(j_registry.VdafInstance, make)(**kw), xof_mode=mode)
    t_inst = dataclasses.replace(getattr(t_registry.VdafInstance, make)(**kw), xof_mode=mode)
    assert t_inst.to_dict() == j_inst.to_dict()
    assert t_registry.VdafInstance.from_dict(j_inst.to_dict()) == t_inst
    assert j_registry.VdafInstance.from_dict(t_inst.to_dict()) == j_inst
    t_circ, j_circ = t_registry.circuit_for(t_inst), j_registry.circuit_for(j_inst)
    assert type(t_circ).__name__ == type(j_circ).__name__
    assert (t_circ.input_len, t_circ.output_len, t_circ.proof_len, t_circ.chunk_length) == (
        j_circ.input_len, j_circ.output_len, j_circ.proof_len, j_circ.chunk_length
    )
