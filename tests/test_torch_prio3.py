"""janus_tpu_torch's two-party step held bit-identical to janus_tpu's.

For each circuit one batch is made from a numpy seed (the same draws in
both packages), some reports are corrupted, and the port's
two_party_step (both aggregate shares, the count) and helper_init_step
(out share, corrected seed, verifier share, joint-rand part) are held
against janus_tpu.parallel.api on the CPU with exact equality. The JAX
side runs eagerly, as its own CPU tests run it (Pallas off).

Cross-sharded: the JAX step runs on the batch the port sharded; and
where the JAX package shards too, its batch equals the port's and
verifies in the port through convert.step_args_from_jax.

The chunked circuits (several gadget calls a chunk) are in
test_torch_prio3_chunked.py, so that the two files run side by side.
"""

import numpy as np
import pytest
import torch

from janus_tpu.parallel import api as j_api
from janus_tpu.vdaf import registry as j_registry
from janus_tpu.vdaf import testing as j_testing
from janus_tpu_torch.convert import step_args_from_jax, step_args_to_numpy
from janus_tpu_torch.parallel import api as t_api
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import testing as t_testing

CPU = torch.device("cpu")
VERIFY_KEY = bytes(range(16, 32))
BATCH = 6
PROOF_CORRUPT = 1  # report whose leader proof share is off by one
MEAS_CORRUPT = 4  # report whose leader measurement share is off by one


def _instances(kind: str, **kw):
    return j_registry.VdafInstance(kind, **kw), t_registry.VdafInstance(kind, **kw)


def _bump(field_np, row: int, modulus: int):
    """Add 1 (mod p) to element 0 of one report's field value (uint64 limbs)."""
    v = (sum(int(x[row, 0]) << (64 * i) for i, x in enumerate(field_np)) + 1) % modulus
    out = tuple(x.copy() for x in field_np)
    for i, y in enumerate(out):
        y[row, 0] = np.uint64((v >> (64 * i)) & ((1 << 64) - 1))
    return out


def corrupt(args_np, modulus: int):
    nonce, parts, meas, proof, b0, seed, b1 = args_np
    proof = _bump(proof, PROOF_CORRUPT, modulus)
    meas = _bump(meas, MEAS_CORRUPT, modulus)
    return (nonce, parts, meas, proof, b0, seed, b1)


def assert_same_field(port, jax_value, what):
    assert len(port) == len(jax_value), what
    for i, (p, j) in enumerate(zip(port, jax_value)):
        assert p.dtype == torch.int64, what
        assert (p.numpy().view(np.uint64) == np.asarray(j)).all(), f"{what} limb {i}"


def assert_same_lanes(port, jax_value, what):
    if jax_value is None:
        assert port is None, what
        return
    assert (port.numpy().view(np.uint64) == np.asarray(jax_value)).all(), what


def expected_total(kind: str, meas, valid, length: int):
    m = np.asarray(meas)[valid]
    if kind == "histogram":
        return [int(x) for x in np.bincount(m, minlength=length)]
    if kind == "sumvec":
        return [int(x) for x in m.sum(axis=0)]
    return [int(m.sum())]


def run_case(kind: str, jax_shards: bool, **kw):
    j_inst, t_inst = _instances(kind, **kw)
    meas = t_testing.random_measurements(t_inst, BATCH, np.random.default_rng(7))
    t_args, _ = t_testing.make_report_batch(t_inst, meas, seed=11, device=CPU)
    port_np = step_args_to_numpy(t_args)
    p3 = t_registry.prio3_batched(t_inst, CPU)
    modulus = p3.tf.MODULUS

    if jax_shards:
        # a batch sharded by janus_tpu equals the port's and goes to the port
        j_args, _ = j_testing.make_report_batch(j_inst, meas, seed=11)
        j_np = step_args_to_numpy(step_args_from_jax(j_args, CPU))
        for i, (a, b) in enumerate(zip(j_np, port_np)):
            if a is None or b is None:
                assert a is None and b is None, i
            else:
                assert all((x == y).all() for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,))), i
        port_in = step_args_from_jax(corrupt(j_np, modulus), CPU)
    else:
        port_in = step_args_from_jax(corrupt(port_np, modulus), CPU)
    # the JAX reference steps run on the batch the port sharded
    jax_in = corrupt(port_np, modulus)

    agg0, agg1, count = t_api.two_party_step(t_inst, VERIFY_KEY, device=CPU)(*port_in)
    j_agg0, j_agg1, j_count = j_api.two_party_step(j_inst, VERIFY_KEY)(*jax_in)
    assert_same_field(agg0, j_agg0, "agg0")
    assert_same_field(agg1, j_agg1, "agg1")
    assert int(count) == int(j_count) == BATCH - 2

    nonce, parts, _, _, _, seed, blind1 = port_in
    out1 = t_api.helper_init_step(t_inst, VERIFY_KEY, device=CPU)(nonce, parts, seed, blind1)
    j_out1 = j_api.helper_init_step(j_inst, VERIFY_KEY)(jax_in[0], jax_in[1], jax_in[5], jax_in[6])
    assert_same_field(out1[0], j_out1[0], "helper out share")
    assert_same_lanes(out1[1], j_out1[1], "helper corrected seed")
    assert_same_field(out1[2], j_out1[2], "helper verifier share")
    assert_same_lanes(out1[3], j_out1[3], "helper joint-rand part")

    # and the aggregate is the plain sum of the valid measurements
    valid = np.ones(BATCH, dtype=bool)
    valid[[PROOF_CORRUPT, MEAS_CORRUPT]] = False
    total = p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))
    length = getattr(p3.circ, "length", 1)
    assert [int(x) for x in total] == expected_total(kind, meas, valid, length)


@pytest.mark.parametrize(
    "kind,jax_shards,kw",
    [
        ("count", True, {}),
        ("sum", False, {"bits": 8}),
        ("sumvec", False, {"length": 4, "bits": 4}),
    ],
    ids=["Count", "Sum8", "SumVec4x4"],
)
def test_two_party_and_helper_step_match_jax(kind, jax_shards, kw):
    run_case(kind, jax_shards, **kw)
