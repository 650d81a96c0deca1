"""janus_tpu_torch's CUDA kernels held against their plain versions on the card.

These need an NVIDIA GPU (sm_90a, nvcc on PATH or under /usr/local/cuda)
and skip elsewhere; on such a machine run them with
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda`. The plain
versions themselves are held against janus_tpu by the CPU tests.
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.ops import expand_cuda, keccak_cuda, sponge_cuda
from janus_tpu_torch.parallel import api
from janus_tpu_torch.vdaf.registry import VdafInstance, prio3_batched
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _lanes(shape, seed, device):
    a = np.random.default_rng(seed).integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
    return torch.from_numpy(a.view(np.int64)).to(device)


@pytest.mark.parametrize("rounds", [24, 3])
@pytest.mark.parametrize("out_lanes", [21, 2])
def test_single_block_kernel_matches_plain(cuda, rounds, out_lanes):
    cols = list(_lanes((21, 5, 333), out_lanes, cuda))
    before = keccak_cuda.keccak_single_block.launches
    got = keccak_cuda.keccak_single_block(cols, out_lanes, rounds=rounds)
    want = keccak_cuda.keccak_single_block_plain(cols, out_lanes, rounds=rounds)
    torch.cuda.synchronize()
    assert keccak_cuda.keccak_single_block.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rounds", [24, 3])
def test_expand_kernel_matches_plain(cuda, rounds):
    prefix = _lanes((7, 5), 9, cuda)
    for offset in (0, 11):
        got = expand_cuda.expand_f128(prefix, 40, 275, block_offset=offset, rounds=rounds)
        want = expand_cuda.expand_f128_plain(prefix, 40, 275, block_offset=offset, rounds=rounds)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (head bytes, body elements, body limbs): no body; a body at every byte
# offset mod 8; messages of 167, 168 and 169 bytes; multi-block bodies
SPONGE_MESSAGES = [(41, 0, 0), (57, 0, 0), (0, 20, 1), (3, 20, 1), (7, 20, 1), (8, 20, 1), (9, 20, 1),
                   (42, 40, 2), (26, 333, 2), (60, 33, 1)]
# (length, limbs, modulus): the two fields, and moduli that reject often
SPONGE_SAMPLES = [(50, 1, 2**64 - 2**32 + 1), (275, 2, 2**128 - 7 * 2**66 + 1), (40, 1, 2**63), (40, 2, 2**127),
                  (300, 2, 2**128 - 2**123)]


def _sponge_inputs(head_bytes, elems, limbs, batch, seed, device):
    head = _lanes((batch, -(-head_bytes // 8)), seed, device)
    if head_bytes % 8:
        head[:, -1] &= (1 << (8 * (head_bytes % 8))) - 1
    body = tuple(_lanes((batch, elems), seed + 1 + j, device) for j in range(limbs))
    return head, head_bytes + 8 * elems * limbs, body


@pytest.mark.parametrize("rounds", [24, 3])
@pytest.mark.parametrize("msg", SPONGE_MESSAGES, ids=str)
def test_sponge_kernel_lanes_match_plain(cuda, rounds, msg):
    head, msg_len, body = _sponge_inputs(*msg, 37, sum(msg), cuda)
    before = sponge_cuda.keccak_sponge.launches
    got = sponge_cuda.keccak_sponge(head, msg_len, body, msg[0], out_lanes=21, rounds=rounds)
    want = sponge_cuda.keccak_sponge_plain(head, msg_len, body, msg[0], out_lanes=21, rounds=rounds)
    torch.cuda.synchronize()
    assert sponge_cuda.keccak_sponge.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("sample", SPONGE_SAMPLES, ids=str)
@pytest.mark.parametrize("msg", [(26, 0, 0), (42, 40, 2)], ids=str)
def test_sponge_kernel_sample_matches_plain(cuda, msg, sample):
    head, msg_len, body = _sponge_inputs(*msg, 45, sample[0], cuda)
    got = sponge_cuda.keccak_sponge(head, msg_len, body, msg[0], sample=sample, rounds=24)
    want = sponge_cuda.keccak_sponge_plain(head, msg_len, body, msg[0], sample=sample, rounds=24)
    torch.cuda.synchronize()
    assert len(got) == sample[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sponge_kernel_raises_on_a_bad_shape(cuda):
    with pytest.raises(ValueError):
        sponge_cuda.keccak_sponge(_lanes((4, 22), 1, cuda), 100, out_lanes=2)


def test_draft_two_party_step_on_card_matches_cpu(cuda):
    """Draft mode runs the sponge kernel and neither fast-mode kernel."""
    inst = VdafInstance("sumvec", bits=4, length=10, xof_mode="draft")
    meas = random_measurements(inst, 16, np.random.default_rng(5))
    outs = {}
    for dev in ("cpu", cuda):
        for fn in (keccak_cuda.keccak_single_block, expand_cuda.expand_f128, sponge_cuda.keccak_sponge):
            fn.launches = 0
        args, _ = make_report_batch(inst, meas, seed=6, device=dev)
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device=dev)(*args)
        p3 = prio3_batched(inst, dev)
        outs[str(dev)] = ([int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))], int(count))
        assert (sponge_cuda.keccak_sponge.launches > 0) == (dev != "cpu")
        assert keccak_cuda.keccak_single_block.launches == 0 and expand_cuda.expand_f128.launches == 0
    assert outs["cpu"] == outs["cuda"]
    assert outs["cpu"] == ([int(x) for x in np.asarray(meas).sum(axis=0)], 16)


def test_two_party_step_on_card_matches_cpu(cuda):
    inst = VdafInstance.sum_vec(10, 4)
    meas = random_measurements(inst, 16, np.random.default_rng(3))
    outs = {}
    for dev in ("cpu", cuda):
        keccak_cuda.keccak_single_block.launches = 0
        expand_cuda.expand_f128.launches = 0
        sponge_cuda.keccak_sponge.launches = 0
        args, _ = make_report_batch(inst, meas, seed=4, device=dev)
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device=dev)(*args)
        p3 = prio3_batched(inst, dev)
        outs[str(dev)] = ([int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))], int(count))
        launched = keccak_cuda.keccak_single_block.launches > 0 and expand_cuda.expand_f128.launches > 0
        assert launched == (dev != "cpu")
        assert sponge_cuda.keccak_sponge.launches == 0
    assert outs["cpu"] == outs["cuda"]
    assert outs["cpu"] == ([int(x) for x in np.asarray(meas).sum(axis=0)], 16)


@pytest.mark.parametrize("route", ["direct", "pipelined", "chunked"])
def test_engine_routes_on_the_card_match_the_cpu(cuda, monkeypatch, route):
    """EngineCache on the card (pinned side-stream copies on the pipelined
    route, cap-sized dispatches on the chunked one) gives the CPU
    engine's values, with the kernels launched."""
    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.convert import step_args_to_numpy

    monkeypatch.setattr(EngineCache, "PIPELINE_CHUNK", 32)
    inst = VdafInstance.sum_vec(3, 2)
    n = 5 if route == "direct" else 70
    meas = random_measurements(inst, n, np.random.default_rng(n))
    args = step_args_to_numpy(make_report_batch(inst, meas, seed=n, device="cpu")[0])
    nonce, parts, lmeas, lproof, b0, seed, b1 = args
    results = []
    for dev in (cuda, "cpu"):
        eng = EngineCache(inst, bytes(16), device=dev, bucket_cap=32 if route == "chunked" else 0)
        keccak_cuda.keccak_single_block.launches = 0
        out0, seed0, ver0, part0 = eng.leader_init(nonce, parts, lmeas, lproof, b0)
        out1, mask, prep = eng.helper_init(nonce, parts, seed, b1, ver0, part0, np.ones(n, dtype=bool))
        results.append((out0.to_numpy(), seed0, ver0, part0, out1.to_numpy(), mask, prep,
                        eng.aggregate(out0, mask), eng.aggregate(out1, mask)))
        assert (keccak_cuda.keccak_single_block.launches > 0) == (dev is cuda)
    for got, want in zip(*results):
        if isinstance(got, list):
            assert got == want
        else:
            for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                assert np.array_equal(g, w)
    assert results[0][5].all()
