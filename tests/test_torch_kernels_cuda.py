"""janus_tpu_torch's CUDA kernels held against their plain versions on the card.

These need an NVIDIA GPU (sm_90a, nvcc on PATH or under /usr/local/cuda)
and skip elsewhere; on such a machine run them with
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda`. The plain
versions themselves are held against janus_tpu by the CPU tests.
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.ops import expand_cuda, keccak_cuda
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


@pytest.mark.parametrize("rounds", [24, 3])
def test_keccak_f1600_kernel_matches_plain(cuda, rounds):
    state = _lanes((25, 5 * 333), rounds, cuda)
    before = keccak_cuda.keccak_f1600.launches
    got = keccak_cuda.keccak_f1600(state, rounds=rounds)
    want = torch.stack(keccak_cuda.keccak_f1600_plain(state.unbind(0), rounds=rounds))
    torch.cuda.synchronize()
    assert keccak_cuda.keccak_f1600.launches == before + 1
    assert torch.equal(got, want)


def test_draft_two_party_step_on_card_matches_cpu(cuda):
    """Draft mode runs the full-permutation kernel and neither fast-mode kernel."""
    inst = VdafInstance("sumvec", bits=4, length=10, xof_mode="draft")
    meas = random_measurements(inst, 16, np.random.default_rng(5))
    outs = {}
    for dev in ("cpu", cuda):
        for fn in (keccak_cuda.keccak_single_block, expand_cuda.expand_f128, keccak_cuda.keccak_f1600):
            fn.launches = 0
        args, _ = make_report_batch(inst, meas, seed=6, device=dev)
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device=dev)(*args)
        p3 = prio3_batched(inst, dev)
        outs[str(dev)] = ([int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))], int(count))
        assert (keccak_cuda.keccak_f1600.launches > 0) == (dev != "cpu")
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
        args, _ = make_report_batch(inst, meas, seed=4, device=dev)
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device=dev)(*args)
        p3 = prio3_batched(inst, dev)
        outs[str(dev)] = ([int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))], int(count))
        launched = keccak_cuda.keccak_single_block.launches > 0 and expand_cuda.expand_f128.launches > 0
        assert launched == (dev != "cpu")
    assert outs["cpu"] == outs["cuda"]
    assert outs["cpu"] == ([int(x) for x in np.asarray(meas).sum(axis=0)], 16)
