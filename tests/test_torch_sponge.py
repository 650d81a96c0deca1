"""janus_tpu_torch's whole-sponge XOF call (ops/sponge_cuda.py) held against
hashlib, janus_tpu's draft sponge and sampler, and its own contract.

On the CPU `keccak_sponge` runs its plain version: the padded message
assembled from the head and the body's limb planes, the per-block loop
over the plain permutation, and the sequential-scan sampler. Every
comparison is exact. The kernel itself is held against this plain
version on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.fields.jfield import JF64, JF128
from janus_tpu.vdaf import draft_jax as jd
from janus_tpu.vdaf import keccak_jax as kj
from janus_tpu_torch.convert import from_numpy_u64, to_numpy_u64
from janus_tpu_torch.fields.tfield import TF64, TF128, fencode_lanes
from janus_tpu_torch.ops import sponge_cuda as sc
from janus_tpu_torch.parallel import api
from janus_tpu_torch.vdaf import draft as td
from janus_tpu_torch.vdaf import keccak as tk
from janus_tpu_torch.vdaf.registry import VdafInstance, prio3_batched
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

CPU = torch.device("cpu")
F64 = TF64.MODULUS
F128 = TF128.MODULUS


def rand_u64(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)


def make_call(head_bytes: int, elems: int, limbs: int, batch: int, seed: int):
    """Random head bytes and body limb planes: (head lanes, msg_len, body
    planes, the messages as host bytes per report)."""
    head = rand_u64((batch, -(-head_bytes // 8)), seed)
    if head_bytes % 8:
        head[:, -1] &= np.uint64((1 << (8 * (head_bytes % 8))) - 1)
    planes = [rand_u64((batch, elems), seed + 1 + j) for j in range(limbs)]
    msgs = []
    for r in range(batch):
        enc = np.stack([p[r] for p in planes], axis=-1).reshape(-1) if limbs else np.zeros(0, np.uint64)
        msgs.append(head[r].astype("<u8").tobytes()[:head_bytes] + enc.astype("<u8").tobytes())
    body = tuple(from_numpy_u64(p, CPU) for p in planes)
    return from_numpy_u64(head, CPU), head_bytes + 8 * elems * limbs, body, msgs


# --- against hashlib.shake_128, 24 rounds ------------------------------------

CASES = (
    [(h, 0, 0) for h in (0, 1, 7, 8, 9, 25, 42, 57, 60)]  # no body
    + [(h, 20, 1) for h in range(8)]  # a body at every byte offset mod 8 (160..167 bytes)
    + [(8, 20, 1), (9, 20, 1)]  # 168 and 169 bytes
    + [(42, 40, 2), (25, 70, 1), (60, 33, 2)]  # several blocks
)


@pytest.mark.parametrize("head_bytes,elems,limbs", CASES)
def test_sponge_matches_shake(head_bytes, elems, limbs):
    head, msg_len, body, msgs = make_call(head_bytes, elems, limbs, 2, head_bytes + 100 * elems + limbs)
    got = sc.keccak_sponge(head, msg_len, body, head_bytes, out_lanes=21)
    stream = sc.sponge_squeeze_plain(sc.sponge_message(head, msg_len, body, head_bytes), 2)
    for r, msg in enumerate(msgs):
        want = hashlib.shake_128(msg).digest(2 * 168)
        assert len(msg) == msg_len
        assert to_numpy_u64(got[r]).astype("<u8").tobytes() == want[:168]
        assert to_numpy_u64(stream[r].reshape(-1)).astype("<u8").tobytes() == want


def test_sponge_seed_lanes_are_the_first_lanes_of_the_stream():
    head, msg_len, body, msgs = make_call(42, 30, 2, 3, 5)
    got = sc.keccak_sponge(head, msg_len, body, 42, out_lanes=2)
    assert got.shape == (3, 2)
    for r, msg in enumerate(msgs):
        assert to_numpy_u64(got[r]).astype("<u8").tobytes() == hashlib.shake_128(msg).digest(16)


# --- against janus_tpu's _sponge_stream + _reject_sample, 3 rounds -------------


@pytest.fixture
def three_rounds(monkeypatch):
    monkeypatch.setattr(kj, "KECCAK_ROUNDS", 3)
    return 3


def _jax_stream(head, msg_len, body, body_off, out_blocks):
    segs = [(0, jnp.asarray(to_numpy_u64(head)))]
    if body:
        segs.append((body_off, jnp.asarray(to_numpy_u64(fencode_lanes(body)))))
    return jd._sponge_stream(segs, msg_len, head.shape[0], out_blocks)


FIELDS = [(JF64, TF64), (JF128, TF128)]


@pytest.mark.parametrize("jf,tf", FIELDS, ids=["Field64", "Field128"])
@pytest.mark.parametrize("head_bytes,elems,limbs", [(26, 0, 0), (42, 60, 2), (41, 45, 1)])
def test_sample_matches_jax_sponge_and_reject_sample(three_rounds, jf, tf, head_bytes, elems, limbs):
    length = 150
    head, msg_len, body, _ = make_call(head_bytes, elems, limbs, 3, 17 + elems)
    want = jd._reject_sample(jf, _jax_stream(head, msg_len, body, head_bytes, jd._stream_blocks_for(jf, length)), length)
    got = sc.keccak_sponge(head, msg_len, body, head_bytes, sample=(length, tf.LIMBS, tf.MODULUS), rounds=3)
    assert len(got) == len(want) == tf.LIMBS
    for g, w in zip(got, want):
        assert (to_numpy_u64(g) == np.asarray(w)).all()


@pytest.mark.parametrize("head_bytes,elems,limbs", [(57, 0, 0), (42, 200, 2)])
def test_seed_lanes_match_jax(three_rounds, head_bytes, elems, limbs):
    head, msg_len, body, _ = make_call(head_bytes, elems, limbs, 3, 23)
    want = np.asarray(_jax_stream(head, msg_len, body, head_bytes, 1))[:, :2]
    got = sc.keccak_sponge(head, msg_len, body, head_bytes, out_lanes=2, rounds=3)
    assert (to_numpy_u64(got) == want).all()


# A modulus that rejects about half the candidates: the window runs out
# within a few dozen candidates, so most of each output is the zero tail.
@pytest.mark.parametrize("limbs,modulus", [(1, 2**63), (2, 2**127), (2, 2**128 - 2**123)])
def test_sample_with_a_rejecting_modulus_matches_jax(three_rounds, limbs, modulus):
    length = 120
    head, msg_len, body, _ = make_call(26, 0, 0, 6, 31)
    jf = SimpleNamespace(LIMBS=limbs, MODULUS=modulus)
    want = jd._reject_sample(jf, _jax_stream(head, msg_len, body, 26, jd._stream_blocks_for(jf, length)), length)
    got = sc.keccak_sponge(head, msg_len, body, 26, sample=(length, limbs, modulus), rounds=3)
    for g, w in zip(got, want):
        assert (to_numpy_u64(g) == np.asarray(w)).all()
    if modulus in (2**63, 2**127):
        assert (to_numpy_u64(got[0])[:, -1] == 0).all()


# --- the sequential-scan sampler on crafted streams ---------------------------


def _stream_of(vals, limbs: int, length: int):
    lanes = -(-sc.candidate_count(length) * limbs // 21) * 21
    stream = np.zeros((len(vals), lanes), dtype=np.uint64)
    for r, row in enumerate(vals):
        for i, v in enumerate(row):
            for j in range(limbs):
                stream[r, i * limbs + j] = np.uint64((v >> (64 * j)) & (2**64 - 1))
    return stream


@pytest.mark.parametrize("jf,tf", FIELDS, ids=["Field64", "Field128"])
@pytest.mark.parametrize("rejects", [0, 1, 8, 9, 16])
def test_scan_sampler_matches_jax_at_the_window_edge(jf, tf, rejects):
    """`rejects` rejected candidates spread over the stream: up to 8 every
    element fills, from 9 on the tail past the ninth reject is zero."""
    length = 30
    rng = np.random.default_rng(rejects)
    p = jf.MODULUS
    row = [int(rng.integers(0, 2**62)) for _ in range(sc.candidate_count(length))]
    big = (1 << (64 * tf.LIMBS)) - 1
    for i in np.linspace(2, length + 6, rejects).astype(int) if rejects else []:
        row[i] = big if i % 2 else p
    stream = _stream_of([row], tf.LIMBS, length)
    want = jd._reject_sample(jf, jnp.asarray(stream), length)
    got = sc.reject_sample_scan(from_numpy_u64(stream, CPU), length, tf.LIMBS, tf.MODULUS)
    for g, w in zip(got, want):
        assert (to_numpy_u64(g) == np.asarray(w)).all()
    values = [int(x) for x in tf.to_ints(got)[0]]
    accepted = [v for v in row if v < p]
    if rejects <= 8:
        assert values == accepted[:length]
    else:
        assert values[-1] == 0


def test_scan_sampler_carries_a_straddled_field128_candidate():
    """Field128 candidate 10 is stream lanes 20 and 21, the last lane of
    one squeezed block and the first of the next. Rejected there by its
    high limb, p itself, p - 1 and a high limb of p's with the low limb
    2^64 - 1 around it: the same answer as janus_tpu."""
    length = 24
    p = F128
    p_hi = p >> 64
    rng = np.random.default_rng(3)
    rows = []
    for crafted in ({10: p}, {10: (p_hi << 64) | (2**64 - 1), 9: p - 1}, {10: p - 1, 11: p}, {10: 2**128 - 1}):
        row = [int(rng.integers(0, 2**62)) << 64 | int(rng.integers(0, 2**63)) for _ in range(sc.candidate_count(length))]
        for i, v in crafted.items():
            row[i] = v
        rows.append(row)
    stream = _stream_of(rows, 2, length)
    want = jd._reject_sample(JF128, jnp.asarray(stream), length)
    got = sc.reject_sample_scan(from_numpy_u64(stream, CPU), length, 2, p)
    for g, w in zip(got, want):
        assert (to_numpy_u64(g) == np.asarray(w)).all()
    values = [[int(x) for x in r] for r in TF128.to_ints(got)]
    for r, row in enumerate(rows):
        assert values[r] == [v for v in row if v < p][:length]
    assert values[2][10] == p - 1


# --- the wrapper's contract ---------------------------------------------------


def _bad_calls():
    head = torch.zeros((4, 6), dtype=torch.int64)
    plane = torch.zeros((4, 10), dtype=torch.int64)
    return {
        "head of 22 lanes": lambda: sc.keccak_sponge(torch.zeros((4, 22), dtype=torch.int64), 100, out_lanes=2),
        "head of int32": lambda: sc.keccak_sponge(head.int(), 40, out_lanes=2),
        "1-D head": lambda: sc.keccak_sponge(torch.zeros(6, dtype=torch.int64), 40, out_lanes=2),
        "planes of two shapes": lambda: sc.keccak_sponge(head, 42 + 160, (plane, plane[:, :5]), 42, out_lanes=2),
        "three planes": lambda: sc.keccak_sponge(head, 42 + 240, (plane,) * 3, 42, out_lanes=2),
        "wrong message length": lambda: sc.keccak_sponge(head, 42 + 81, (plane,), 42, out_lanes=2),
        "no output mode": lambda: sc.keccak_sponge(head, 40),
        "both output modes": lambda: sc.keccak_sponge(head, 40, out_lanes=2, sample=(5, 1, F64)),
        "22 out lanes": lambda: sc.keccak_sponge(head, 40, out_lanes=22),
        "three-limb sample": lambda: sc.keccak_sponge(head, 40, sample=(5, 3, F64)),
        "modulus too wide": lambda: sc.keccak_sponge(head, 40, sample=(5, 1, F128)),
        "meta device": lambda: sc.keccak_sponge(torch.empty((4, 6), dtype=torch.int64, device="meta"), 40, out_lanes=2),
    }


@pytest.mark.parametrize("what", list(_bad_calls()))
def test_keccak_sponge_refuses_bad_inputs(what):
    with pytest.raises(ValueError):
        _bad_calls()[what]()
    assert sc.keccak_sponge.launches == 0


# --- the draft engine's calls ---------------------------------------------------


@pytest.mark.parametrize("kind,calls", [("count", 4), ("sumvec", 11)])
def test_draft_step_makes_one_sponge_call_per_xof_call(monkeypatch, kind, calls):
    """A two-party step calls the sponge once per XOF call; every head is
    at most one rate block, and each joint-rand part's body is the share's
    own limb planes (no encoded copy)."""
    monkeypatch.setattr(tk, "KECCAK_ROUNDS", 3)
    inst = VdafInstance(kind, xof_mode="draft", **({"length": 4, "bits": 3} if kind == "sumvec" else {}))
    meas = random_measurements(inst, 3, np.random.default_rng(8))
    args, _ = make_report_batch(inst, meas, seed=9, device=CPU)
    seen = []
    real = td.keccak_sponge

    def spy(head, msg_len, body=(), body_off=0, **kw):
        seen.append((head.shape, [p.data_ptr() for p in body], body_off))
        return real(head, msg_len, body, body_off, **kw)

    monkeypatch.setattr(td, "keccak_sponge", spy)
    agg0, agg1, count = api.two_party_step(inst, bytes(16), device=CPU)(*args)
    p3 = prio3_batched(inst, CPU)
    assert int(count) == 3
    assert [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))] == list(
        np.asarray(meas).sum(axis=0).reshape(-1)
    )
    assert len(seen) == calls
    assert all(shape[1] <= 21 for shape, _, _ in seen)
    bodies = [(ptrs, off) for _, ptrs, off in seen if ptrs]
    assert len(bodies) == (2 if kind == "sumvec" else 0)
    if bodies:
        assert bodies[0] == ([x.data_ptr() for x in args[2]], 42)  # the leader's share, in place
