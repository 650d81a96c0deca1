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


def _prefix_parts(seed):
    """A 9-lane prefix in every kind of part the callers pass: bytes (a
    dst), a [batch, 2] tensor, a strided view and a [1, k] row broadcast
    across the batch; lane 6 is a gap (zero)."""
    rng_lanes = rand_u64((3, 5), seed)
    bcast = rand_u64((1, 2), seed + 1)
    parts_j = [(0, xof.dst(0x42, 2)), (2, jnp.asarray(rng_lanes[:, :2])), (4, jnp.asarray(rng_lanes[:, 2:5:2])),
               (7, jnp.asarray(np.broadcast_to(bcast, (3, 2))))]
    t = from_numpy_u64(rng_lanes, CPU)
    parts_t = [(0, xof.dst(0x42, 2)), (2, t[:, :2]), (4, t[:, 2:5:2]), (7, from_numpy_u64(bcast, CPU))]
    return parts_j, parts_t


@pytest.mark.parametrize("rounds", [24, 3], indirect=True)
@pytest.mark.parametrize("out_lanes", [21, 5, 2])
def test_single_block_matches_jax(rounds, out_lanes):
    """Kernel 1's counter-mode entry (its plain version on the CPU)
    against keccak_jax.ctr_stream_lanes: the first out_lanes lanes of
    every block, at a counter offset."""
    parts_j, parts_t = _prefix_parts(100 + out_lanes)
    want = np.asarray(kj.ctr_stream_lanes(parts_j, 72, 3, 4, ctr_offset=5))[..., :out_lanes]
    got = keccak_cuda.keccak_ctr_blocks(parts_t, 9, 3, 4, out_lanes, CPU, ctr_offset=5, rounds=rounds)
    assert got.shape == (3, 4, out_lanes)
    assert (to_numpy_u64(got) == want).all()
    assert keccak_cuda.keccak_single_block.launches == 0


@pytest.mark.parametrize("rounds", [24, 3], indirect=True)
@pytest.mark.parametrize("lanes_n", [45, 14])
def test_tree_leaf_level_matches_jax(rounds, lanes_n):
    """The tree-level entry at the leaf level, its lane space given as a
    constant lane, a nonce and a share (as the joint-rand binder), against
    keccak_jax._tree_level_planar over the same data zero-padded."""
    nonce, share = rand_u64((2, 2), lanes_n), rand_u64((2, lanes_n - 3), lanes_n + 1)
    agg = (1).to_bytes(8, "little")
    data = np.concatenate([np.full((2, 1), 1, dtype=np.uint64), nonce, share], axis=1)
    n = keccak_cuda.tree_nodes(lanes_n)
    planes = np.zeros((2, 14 * n), dtype=np.uint64)
    planes[:, :lanes_n] = data
    want = kj._tree_level_planar(jnp.asarray(planes.reshape(2, 14, n)), 0, 8 * lanes_n)
    parts = [(0, agg), (1, from_numpy_u64(nonce, CPU)), (3, from_numpy_u64(share, CPU))]
    got = keccak_cuda.keccak_tree_level(parts, lanes_n, 2, 0, 8 * lanes_n, CPU, rounds=rounds)
    assert got.shape == (2, n, 2)
    assert (to_numpy_u64(got) == np.asarray(want)).all()


@pytest.mark.parametrize("rounds", [24, 3], indirect=True)
@pytest.mark.parametrize("n_below", [9, 7, 1])
def test_tree_upper_level_matches_jax(rounds, n_below):
    """The tree-level entry above the leaves reads the digests below
    ([batch, n, 2]) as lanes, the last chunk zero-padded, as
    keccak_jax._tree_level over the padded chunks."""
    digs = rand_u64((3, n_below, 2), 60 + n_below)
    groups = -(-n_below // 7)
    chunks = np.zeros((3, groups * 7, 2), dtype=np.uint64)
    chunks[:, :n_below] = digs
    want = kj._tree_level(jnp.asarray(chunks.reshape(3, groups, 14)), 2, 4000)
    got = keccak_cuda.keccak_tree_level([(0, from_numpy_u64(digs, CPU).reshape(3, -1))], 2 * n_below, 3, 2, 4000, CPU,
                                        rounds=rounds)
    assert got.shape == (3, groups, 2)
    assert (to_numpy_u64(got) == np.asarray(want)).all()


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


@pytest.mark.parametrize("lanes_n", [1, 14, 15, 120, 1003])
def test_tree_digest_matches_jax_and_host(lanes_n):
    data = rand_u64((2, lanes_n), 20 + lanes_n)
    want = kj.tree_digest_lanes([(0, jnp.asarray(data))], 8 * lanes_n, 2)
    got = tk.tree_digest_lanes([(0, from_numpy_u64(data, CPU))], 8 * lanes_n, 2, CPU)
    assert (to_numpy_u64(got) == np.asarray(want)).all()
    for b in range(2):
        assert to_numpy_u64(got[b]).astype("<u8").tobytes() == xof.tree_digest(data[b].astype("<u8").tobytes())


@pytest.mark.parametrize("rounds", [3], indirect=True)
def test_tree_digest_of_parts_matches_jax(rounds):
    """The joint-rand binder's shape: an aggregator id, a nonce and a long
    share, four levels (3,003 lanes: 215 leaves, 31, 5, 1), at 3 rounds."""
    nonce, share = rand_u64((2, 2), 70), rand_u64((2, 3000), 71)
    agg = (1).to_bytes(8, "little")
    want = kj.tree_digest_lanes([(0, agg), (1, jnp.asarray(nonce)), (3, jnp.asarray(share))], 8 * 3003, 2)
    got = tk.tree_digest_lanes([(0, agg), (1, from_numpy_u64(nonce, CPU)), (3, from_numpy_u64(share, CPU))],
                               8 * 3003, 2, CPU)
    assert (to_numpy_u64(got) == np.asarray(want)).all()


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
        stream = keccak_cuda.keccak_ctr_blocks_plain([(0, prefix)], 6, 2, 3, 21, CPU, ctr_offset=offset, rounds=4)
        want = tk.sample_field_vec(TF128, stream, 19)
        assert torch.equal(lo, want[0]) and torch.equal(hi, want[1])


def test_message_parts_are_checked():
    """Overlapping parts, parts past the message, non-int64 or wrongly
    shaped tensors and bytes that are not whole lanes raise."""
    t = torch.zeros((3, 2), dtype=torch.int64)
    for parts in ([(0, t), (1, t)], [(8, t)], [(0, t.int())], [(0, torch.zeros((2, 2), dtype=torch.int64))],
                  [(0, b"abc")]):
        with pytest.raises(ValueError):
            keccak_cuda.keccak_ctr_blocks(parts, 9, 3, 1, 2, CPU)
        with pytest.raises(ValueError):
            keccak_cuda.keccak_tree_level(parts, 9, 3, 0, 72, CPU)


class _CardTimingOff:
    """torch with the card's timing calls as no-ops, to rehearse
    chip_smoke.py's kernel cases with device="cpu"."""

    class _Event:
        def __init__(self, **_):
            pass

        def record(self):
            pass

        def elapsed_time(self, _):
            return 0.0

    class _Profile:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            pass

        def key_averages(self):
            return []

    cuda = type("cuda", (), {"synchronize": staticmethod(lambda: None), "Event": _Event,
                             "_sleep": staticmethod(lambda _: None)})
    profiler = type("profiler", (), {"profile": _Profile, "ProfilerActivity": torch.profiler.ProfilerActivity})

    def __getattr__(self, name):
        return getattr(torch, name)


def test_chip_smoke_kernel1_cases_rehearse_on_the_cpu():
    """chip_smoke.py's kernel-1 cases at a small width with device="cpu":
    every case runs both entries' plain versions, agrees, and counts the
    bytes and nodes of its shapes; no launch counts off the card."""
    import chip_smoke

    rng = np.random.default_rng(4)
    lanes = lambda shape: from_numpy_u64(rng.integers(0, 2**63, size=shape, dtype=np.uint64), CPU)  # noqa: E731
    keccak_cuda.keccak_single_block.launches = 0
    cases = chip_smoke.kernel1_cases(_CardTimingOff(), CPU, lanes, batch=3, length=20, hist_length=10, walk_states=40)
    assert [c["case"] for c in cases] == [
        "sumvec tree leaves", "sumvec tree leaves, 3 rounds", "sumvec tree level 1", "poplar1 leaf walk, extend",
        "poplar1 leaf walk, convert", "histogram10000 tree leaves", "stream at an offset, 3 rounds",
    ]
    assert all(c["max_abs_err"] == 0 for c in cases)
    assert cases[0]["nodes"] == 4 and cases[0]["lanes"] == 43 and cases[2]["nodes"] == 1
    assert [c["out_lanes"] for c in cases if "out_lanes" in c] == [5, 2, 21]
    assert cases[3]["states"] == 40 and cases[3]["bound_by"] == "operations"
    assert keccak_cuda.keccak_single_block.launches == 0
