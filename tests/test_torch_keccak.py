"""janus_tpu_torch's device XOF held against janus_tpu and hashlib.

The port's kernel wrappers take their plain versions on CPU tensors, so
these tests hold the plain versions (and all the framing around them)
bit-identical to the JAX package's keccak_jax on the same numpy-made
inputs. The JAX side runs as its own CPU tests run it: Pallas off, the
scan permutation. The reduced-round cases patch janus_tpu's
KECCAK_ROUNDS and pass the same count to the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.fields.jfield import JF64, JF128
from janus_tpu.vdaf import keccak_jax as kj
from janus_tpu_torch.convert import from_numpy_u64, to_numpy_u64
from janus_tpu_torch.fields.tfield import TF64, TF128
from janus_tpu_torch.ops import expand_cuda, keccak_cuda
from janus_tpu_torch.vdaf import keccak as tk
from janus_tpu_torch.vdaf import xof

CPU = torch.device("cpu")


def rand_u64(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)


@pytest.fixture
def rounds(request, monkeypatch):
    """Run both packages at the parametrized round count."""
    monkeypatch.setattr(kj, "KECCAK_ROUNDS", request.param)
    monkeypatch.setattr(tk, "KECCAK_ROUNDS", request.param)
    return request.param


@pytest.mark.parametrize("rounds", [24, 3], indirect=True)
@pytest.mark.parametrize("out_lanes", [21, 2])
def test_single_block_matches_jax(rounds, out_lanes):
    lanes = rand_u64((21, 3, 50), 100 + out_lanes)
    want = kj._single_block_keccak([jnp.asarray(x) for x in lanes], out_lanes=out_lanes)
    got = keccak_cuda.keccak_single_block([from_numpy_u64(x, CPU) for x in lanes], out_lanes, rounds=rounds)
    assert len(got) == out_lanes
    for i in range(out_lanes):
        assert (to_numpy_u64(got[i]) == np.asarray(want[i])).all(), i


@pytest.mark.parametrize("rounds", [24], indirect=True)
def test_ctr_stream_with_offset_matches_jax(rounds):
    d = xof.dst(0x42, 2)
    seeds = rand_u64((3, 2), 7)
    binder = rand_u64((3, 3), 8)
    parts_j = [(0, d), (2, jnp.asarray(seeds)), (4, jnp.asarray(binder))]
    parts_t = [(0, d), (2, from_numpy_u64(seeds, CPU)), (4, from_numpy_u64(binder, CPU))]
    want = kj.ctr_stream_lanes(parts_j, 56, 3, 4, ctr_offset=5)
    got = tk.ctr_stream_lanes(parts_t, 56, 3, 4, CPU, ctr_offset=5)
    assert got.shape == (3, 4, 21)
    assert (to_numpy_u64(got) == np.asarray(want)).all()


@pytest.mark.parametrize("rounds", [24], indirect=True)
def test_ctr_stream_matches_hashlib(rounds):
    """24 rounds against hashlib.shake_128 through the port's XofCtr128."""
    d = xof.dst(0x42, 2)
    seed = bytes(range(16))
    binder = bytes(range(100, 124))
    seed_lanes = from_numpy_u64(np.frombuffer(seed, dtype="<u8")[None, :], CPU)
    parts = [(0, d), (2, seed_lanes), (4, binder)]
    got = tk.ctr_stream_lanes(parts, 56, 1, 3, CPU)
    assert to_numpy_u64(got[0]).astype("<u8").tobytes() == xof.XofCtr128(seed, d, binder).next(3 * 168)


@pytest.mark.parametrize("lanes_n", [1, 14, 15, 120])
def test_tree_digest_matches_jax_and_host(lanes_n):
    data = rand_u64((2, lanes_n), 20 + lanes_n)
    want = kj.tree_digest_lanes([(0, jnp.asarray(data))], 8 * lanes_n, 2)
    got = tk.tree_digest_lanes([(0, from_numpy_u64(data, CPU))], 8 * lanes_n, 2, CPU)
    assert (to_numpy_u64(got) == np.asarray(want)).all()
    for b in range(2):
        assert to_numpy_u64(got[b]).astype("<u8").tobytes() == xof.tree_digest(data[b].astype("<u8").tobytes())


@pytest.mark.parametrize("rounds", [24, 2], indirect=True)
@pytest.mark.parametrize("jf,tf,length", [(JF64, TF64, 30), (JF128, TF128, 40)], ids=["Field64", "Field128"])
def test_expand_field_vec_matches_jax(rounds, jf, tf, length):
    d = xof.dst(0x7, 3)
    seeds = rand_u64((3, 2), 30 + length)
    parts_j = [(0, d), (2, jnp.asarray(seeds)), (4, b"\x01" + bytes(7))]
    parts_t = [(0, d), (2, from_numpy_u64(seeds, CPU)), (4, b"\x01" + bytes(7))]
    for offset in (0, 3):
        want = kj.expand_field_vec(jf, parts_j, 40, 3, length, block_offset=offset)
        got = tk.expand_field_vec(tf, parts_t, 40, 3, length, CPU, block_offset=offset)
        for g, w in zip(got, want):
            assert (to_numpy_u64(g) == np.asarray(w)).all(), offset


def test_expand_field_vec_matches_hashlib():
    """Field128 expansion against the host XofCtr128.next_vec (24 rounds)."""
    from janus_tpu_torch.fields.field import Field128

    d = xof.dst(0x7, 2)
    seed = bytes(range(32, 48))
    seed_lanes = from_numpy_u64(np.frombuffer(seed, dtype="<u8")[None, :], CPU)
    got = tk.expand_field_vec(TF128, [(0, d), (2, seed_lanes), (4, b"\x01" + bytes(7))], 40, 1, 17, CPU)
    want = xof.XofCtr128(seed, d, b"\x01" + bytes(7)).next_vec(Field128, 17)
    assert [int(x) for x in TF128.to_ints(got)[0]] == want


def test_expand_f128_plain_equals_unfused_stream():
    """The kernel's plain twin equals the unfused stream + sampling."""
    prefix = from_numpy_u64(rand_u64((2, 6), 41), CPU)
    for offset in (0, 9):
        lo, hi = expand_cuda.expand_f128_plain(prefix, 3, 19, block_offset=offset, rounds=4)
        cols = keccak_cuda.ctr_block_cols(prefix, 3, offset)
        stream = torch.stack(keccak_cuda.keccak_single_block_plain(cols, 21, rounds=4), dim=-1)
        want = tk.sample_field_vec(TF128, stream, 19)
        assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])
