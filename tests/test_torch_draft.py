"""janus_tpu_torch's draft mode (VDAF-07) held against janus_tpu and hashlib.

The port's sponge, rejection sampler, plain Keccak-f[1600] and draft
two-party step run on the CPU (the sponge kernel's wrapper takes its
plain version there; tests/test_torch_sponge.py holds that wrapper
itself) and are held against the JAX package's draft_jax on the
same numpy-made inputs, against hashlib.shake_128, and against the host
VDAF-07 oracle reference.Prio3(mode="draft"). Every comparison is exact:
lanes and field elements are integers.

Where 24 rounds are not needed, both packages run at a reduced round
count through their KECCAK_ROUNDS knobs. The JAX package caches its
engines per instance and jit-compiles their shard, which bakes the round
count in; the reduced-round step test clears that cache before and
after itself, so no other test meets an engine traced at other rounds.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.fields.jfield import JF64, JF128
from janus_tpu.ops import keccak_pallas as kp
from janus_tpu.parallel import api as j_api
from janus_tpu.vdaf import draft_jax as jd
from janus_tpu.vdaf import feasibility as j_feas
from janus_tpu.vdaf import keccak_jax as kj
from janus_tpu.vdaf import registry as j_registry
from janus_tpu.vdaf import testing as j_testing
from janus_tpu_torch.convert import from_numpy_u64, step_args_from_jax, step_args_to_numpy, to_numpy_u64
from janus_tpu_torch.fields.tfield import TF64, TF128
from janus_tpu_torch.ops import keccak_cuda, sponge_cuda
from janus_tpu_torch.parallel import api as t_api
from janus_tpu_torch.vdaf import circuits as t_circuits
from janus_tpu_torch.vdaf import draft as td
from janus_tpu_torch.vdaf import engine as t_engine
from janus_tpu_torch.vdaf import feasibility as t_feas
from janus_tpu_torch.vdaf import keccak as tk
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import testing as t_testing
from janus_tpu_torch.vdaf.xof import XofSponge128, draft_dst

CPU = torch.device("cpu")
VERIFY_KEY = bytes(range(16, 32))


def rand_u64(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)


def row_bytes(lanes, row=0) -> bytes:
    return to_numpy_u64(lanes[row]).astype("<u8").tobytes()


@pytest.fixture
def rounds(request, monkeypatch):
    """Run both packages' sponges at the parametrized round count."""
    monkeypatch.setattr(kj, "KECCAK_ROUNDS", request.param)
    monkeypatch.setattr(tk, "KECCAK_ROUNDS", request.param)
    return request.param


def _sponge_stream(segments, msg_len: int, batch: int, out_blocks: int):
    """The plain sponge's raw stream of a message given as byte-offset
    segments: [batch, out_blocks * 21] lanes."""
    head = sponge_cuda.or_segments(segments, -(-msg_len // 8), batch, CPU)
    msg = sponge_cuda.sponge_message(head, msg_len)
    return sponge_cuda.sponge_squeeze_plain(msg, out_blocks, tk.KECCAK_ROUNDS).reshape(batch, -1)


# --- (a) the sponge against hashlib, 24 rounds -----------------------------


def test_static_message_matches_shake():
    msg = b"hello world, odd len!"  # 21 bytes, not lane aligned
    out = _sponge_stream([(0, msg)], len(msg), 3, 2)
    assert out.shape == (3, 42)
    assert row_bytes(out, 1) == hashlib.shake_128(msg).digest(2 * 168)


@pytest.mark.parametrize("offset", [0, 1, 3, 7, 9, 25, 26, 42])
def test_dynamic_segment_at_any_byte_offset_matches_shake(offset):
    dyn = rand_u64((2, 4), offset)  # 32 bytes
    head = bytes(range(1, offset + 1))
    out = _sponge_stream([(0, head), (offset, from_numpy_u64(dyn, CPU))], offset + 32, 2, 1)
    for row in range(2):
        msg = head + dyn[row].astype("<u8").tobytes()
        assert row_bytes(out, row) == hashlib.shake_128(msg).digest(168)


def test_multi_block_absorb_matches_shake():
    dyn = rand_u64((1, 70), 5)  # 560 bytes
    head = b"\x08" + b"d" * 8 + b"s" * 16  # 25-byte draft-style prefix
    out = _sponge_stream([(0, head), (25, from_numpy_u64(dyn, CPU))], 25 + 560, 1, 3)
    msg = head + dyn[0].astype("<u8").tobytes()
    assert row_bytes(out, 0) == hashlib.shake_128(msg).digest(3 * 168)


# --- (b) the sponge against JAX's scan branch --------------------------------


@pytest.mark.parametrize("rounds", [3], indirect=True)
def test_sponge_stream_matches_jax_scan_branch(rounds):
    """Absorb 8 blocks and squeeze 6: both past JAX's _UNROLL_BLOCKS, so
    its lax.scan absorb and squeeze run."""
    assert kj._UNROLL_BLOCKS < 6
    dyn = rand_u64((3, 150), 12)  # 1200 bytes
    nonce = rand_u64((3, 2), 13)
    msg_len = 26 + 16 + 1200
    head = b"\x08" + draft_dst(2, 8) + bytes(range(16)) + b"\x01"
    want = jd._sponge_stream([(0, head), (26, jnp.asarray(nonce)), (42, jnp.asarray(dyn))], msg_len, 3, 6)
    segs = [(0, head), (26, from_numpy_u64(nonce, CPU)), (42, from_numpy_u64(dyn, CPU))]
    got = _sponge_stream(segs, msg_len, 3, 6)
    assert (to_numpy_u64(got) == np.asarray(want)).all()


# --- (c) rejection sampling against JAX ----------------------------------


def _crafted_stream(jf, length: int):
    """Candidates for 3 reports: none rejected; scattered rejects inside
    the window (Field128's candidate 10 straddles stream lanes 20 and 21);
    window + 1 rejects (exhaustion)."""
    c_n = jd._candidate_count(jf, length)
    limbs = jf.LIMBS
    rng = np.random.default_rng(9 + limbs)
    p = jf.MODULUS
    vals = [[int(rng.integers(0, 2**62)) for _ in range(c_n)] for _ in range(3)]
    big = (1 << (64 * limbs)) - 1  # >= p: rejected
    for i in (0, 7, 8, 10, 25):
        vals[1][i] = big
    if limbs == 2:
        vals[1][3] = p  # high limb == p_hi, low limb == p_lo: rejected
        vals[1][4] = p - 1  # high limb == p_hi, low limb < p_lo: accepted
        vals[1][30] = p + (1 << 64) - 1 - (p & ((1 << 64) - 1))  # high == p_hi, low = 2^64-1: rejected
    for k in range(jd._REJECT_WINDOW + 1):
        vals[2][2 * k] = big
    lanes = -(-c_n * limbs // 21) * 21
    stream = np.zeros((3, lanes), dtype=np.uint64)
    for r in range(3):
        for i, v in enumerate(vals[r]):
            for j in range(limbs):
                stream[r, i * limbs + j] = np.uint64((v >> (64 * j)) & ((1 << 64) - 1))
    return vals, stream


@pytest.mark.parametrize("jf,tf", [(JF64, TF64), (JF128, TF128)], ids=["Field64", "Field128"])
def test_reject_sample_matches_jax_with_crafted_rejects(jf, tf):
    length = 40
    vals, stream = _crafted_stream(jf, length)
    want = jd._reject_sample(jf, jnp.asarray(stream), length)
    got = sponge_cuda.reject_sample_scan(from_numpy_u64(stream, CPU), length, tf.LIMBS, tf.MODULUS)
    for g, w in zip(got, want):
        assert (to_numpy_u64(g) == np.asarray(w)).all()
    have = [[int(x) for x in row] for row in tf.to_ints(got)]
    for r in range(3):
        accepted = [v for v in vals[r] if v < jf.MODULUS]
        if r < 2:
            assert have[r] == accepted[:length]
        else:
            # past the window the tail is zero, never a wrong value
            assert have[r] != accepted[:length]
            assert all(h in (w, 0) for h, w in zip(have[r], accepted[:length]))
            assert have[r][-1] == 0


@pytest.mark.parametrize("kind", ["count", "sum"])
def test_reject_sample_matches_host_next_vec(kind):
    """24 rounds: stream + sampling against XofSponge128.next_vec."""
    circ = t_circuits.Count() if kind == "count" else t_circuits.Sum(16)
    tf = TF64 if kind == "count" else TF128
    length = max(circ.query_rand_len, 5)
    seeds = rand_u64((4, 2), len(kind))
    d = draft_dst(circ.algo_id, 6)
    head = sponge_cuda.or_segments([(0, bytes([8]) + d), (9, from_numpy_u64(seeds, CPU))], 4, 4, CPU)
    got = tf.to_ints(sponge_cuda.keccak_sponge(head, 25, sample=(length, tf.LIMBS, tf.MODULUS)))
    for i in range(4):
        want = XofSponge128(seeds[i].astype("<u8").tobytes(), d).next_vec(circ.FIELD, length)
        assert [int(x) for x in got[i]] == want


# --- (d) the plain permutation against the Pallas kernel and the scan -------


def test_plain_keccak_f1600_matches_pallas_interpret():
    """rounds=2, the fixture of tests/test_keccak_pallas.py: (4, 129)
    states, which the Pallas wrapper pads from 516 to 1024 columns."""
    shape = (4, 129)
    rng = np.random.default_rng(sum(shape))
    lanes = [rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) for _ in range(25)]
    want = kp.keccak_f1600_pallas(tuple(jnp.asarray(x) for x in lanes), rounds=2)
    state = from_numpy_u64(np.stack(lanes).reshape(25, -1), CPU)
    got = torch.stack(keccak_cuda.keccak_f1600_plain(state.unbind(0), rounds=2))
    assert got.shape == (25, 516)
    for lane in range(25):
        assert (to_numpy_u64(got[lane]).reshape(shape) == np.asarray(want[lane])).all(), lane


def test_plain_keccak_f1600_matches_jax_scan_24_rounds():
    shape = (4, 129)
    lanes = rand_u64((25,) + shape, 77)
    assert not kp.enabled(int(np.prod(shape)))  # the JAX side runs its scan
    want = kj.keccak_f1600(tuple(jnp.asarray(x) for x in lanes), rounds=24)
    got = torch.stack(keccak_cuda.keccak_f1600_plain(from_numpy_u64(lanes.reshape(25, -1), CPU).unbind(0)))
    for lane in range(25):
        assert (to_numpy_u64(got[lane]).reshape(shape) == np.asarray(want[lane])).all(), lane


# --- (e) the draft two-party step against janus_tpu --------------------------

BATCH = 4
PROOF_CORRUPT = 2


@pytest.fixture
def fresh_jax_engines():
    j_registry.prio3_batched.cache_clear()
    yield
    j_registry.prio3_batched.cache_clear()


def _bump(field_np, row: int, modulus: int):
    v = (sum(int(x[row, 0]) << (64 * i) for i, x in enumerate(field_np)) + 1) % modulus
    out = tuple(x.copy() for x in field_np)
    for i, y in enumerate(out):
        y[row, 0] = np.uint64((v >> (64 * i)) & ((1 << 64) - 1))
    return out


def _same(port, jax_value, what):
    if jax_value is None:
        assert port is None, what
        return
    port = port if isinstance(port, tuple) else (port,)
    jax_value = jax_value if isinstance(jax_value, tuple) else (jax_value,)
    assert len(port) == len(jax_value), what
    for i, (p, j) in enumerate(zip(port, jax_value)):
        assert (to_numpy_u64(p) == np.asarray(j)).all(), f"{what} limb {i}"


@pytest.mark.parametrize("rounds", [3], indirect=True)
@pytest.mark.parametrize(
    "kind,kw",
    [("count", {}), ("sum", {"bits": 8}), ("sumvec", {"length": 40, "bits": 16, "chunk_length": 5})],
    ids=["Count", "Sum8", "SumVec40x16"],
)
def test_draft_two_party_and_helper_step_match_jax(rounds, fresh_jax_engines, kind, kw):
    j_inst = j_registry.VdafInstance(kind, xof_mode="draft", **kw)
    t_inst = t_registry.VdafInstance(kind, xof_mode="draft", **kw)
    p3 = t_registry.prio3_batched(t_inst, CPU)
    assert isinstance(p3, td.Prio3BatchedDraft)
    meas = t_testing.random_measurements(t_inst, BATCH, np.random.default_rng(7))

    # JAX's shards cross over, and the port's own shard gives the same
    j_args, _ = j_testing.make_report_batch(j_inst, meas, seed=11)
    j_np = step_args_to_numpy(step_args_from_jax(j_args, CPU))
    t_args, _ = t_testing.make_report_batch(t_inst, meas, seed=11, device=CPU)
    for i, (t, j) in enumerate(zip(t_args, j_args)):
        _same(t, j, f"step argument {i}")

    nonce, parts, lmeas, lproof, b0, seed, b1 = j_np
    jax_in = (nonce, parts, lmeas, _bump(lproof, PROOF_CORRUPT, p3.tf.MODULUS), b0, seed, b1)
    port_in = step_args_from_jax(jax_in, CPU)

    agg0, agg1, count = t_api.two_party_step(t_inst, VERIFY_KEY, device=CPU)(*port_in)
    j_agg0, j_agg1, j_count = j_api.two_party_step(j_inst, VERIFY_KEY)(*jax_in)
    _same(agg0, j_agg0, "agg0")
    _same(agg1, j_agg1, "agg1")
    assert int(count) == int(j_count) == BATCH - 1

    out1 = t_api.helper_init_step(t_inst, VERIFY_KEY, device=CPU)(port_in[0], port_in[1], port_in[5], port_in[6])
    j_out1 = j_api.helper_init_step(j_inst, VERIFY_KEY)(nonce, parts, seed, b1)
    for what, p, j in zip(("out share", "corrected seed", "verifier share", "joint-rand part"), out1, j_out1):
        _same(p, j, f"helper {what}")

    valid = np.ones(BATCH, dtype=bool)
    valid[PROOF_CORRUPT] = False
    total = [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    assert total == [int(x) for x in np.asarray(meas)[valid].sum(axis=0).reshape(-1)]


# --- (f) reports sharded by the host VDAF-07 oracle ----------------------------


def _lanes_of(rows) -> torch.Tensor:
    return from_numpy_u64(np.stack([np.frombuffer(r, dtype="<u8") for r in rows]), CPU)


@pytest.mark.parametrize(
    "kind,kw", [("count", {}), ("sum", {"bits": 8}), ("sumvec", {"length": 3, "bits": 2})], ids=["Count", "Sum8", "SumVec3x2"]
)
def test_prepare_of_host_sharded_reports_matches_host_oracle(kind, kw):
    """24 rounds. The host shards, the port prepares; every verifier
    share, joint-rand part, prep message and out share equals the host's."""
    t_inst = t_registry.VdafInstance(kind, xof_mode="draft", **kw)
    host = j_registry.prio3_host(j_registry.VdafInstance(kind, xof_mode="draft", **kw))
    assert host.mode == "draft"
    p3 = t_registry.prio3_batched(t_inst, CPU)
    tf = p3.tf
    batch = 3
    rng = np.random.default_rng(42)
    meas = t_testing.random_measurements(t_inst, batch, rng)
    nonces, pubs, leaders, helpers = [], [], [], []
    for m in meas:
        nonce = rng.bytes(16)
        public, (ls, hs) = host.shard(m.tolist(), nonce)
        nonces.append(nonce)
        pubs.append(public)
        leaders.append(ls)
        helpers.append(hs)
    nonce_lanes = _lanes_of(nonces)
    helper_seed = _lanes_of([hs.seed for hs in helpers])
    if host.uses_joint_rand:
        public_parts = torch.stack([_lanes_of(pub) for pub in pubs])
        blind0 = _lanes_of([ls.joint_rand_blind for ls in leaders])
        blind1 = _lanes_of([hs.joint_rand_blind for hs in helpers])
    else:
        public_parts = blind0 = blind1 = None
    meas_v = tf.from_ints(np.array([ls.measurement_share for ls in leaders], dtype=object), CPU)
    proof_v = tf.from_ints(np.array([ls.proof_share for ls in leaders], dtype=object), CPU)

    out0, seed0, ver0, part0 = p3.prepare_init_leader(VERIFY_KEY, nonce_lanes, public_parts, meas_v, proof_v, blind0)
    out1, seed1, ver1, part1 = p3.prepare_init_helper(VERIFY_KEY, nonce_lanes, public_parts, helper_seed, blind1)
    mask, prep_msg = p3.prep_shares_to_prep(ver0, ver1, part0, part1)
    mask = p3.prepare_finish(seed1, prep_msg, p3.prepare_finish(seed0, prep_msg, mask))
    assert mask.all()

    def ints(v, i):
        return [int(x) for x in tf.to_ints(v)[i]]

    for i in range(batch):
        st0, ps0 = host.prepare_init(VERIFY_KEY, 0, nonces[i], pubs[i], leaders[i])
        st1, ps1 = host.prepare_init(VERIFY_KEY, 1, nonces[i], pubs[i], helpers[i])
        msg = host.prepare_shares_to_prep([ps0, ps1])
        assert ints(ver0, i) == ps0.verifier_share
        assert ints(ver1, i) == ps1.verifier_share
        if host.uses_joint_rand:
            assert row_bytes(part0, i) == ps0.joint_rand_part
            assert row_bytes(part1, i) == ps1.joint_rand_part
            assert row_bytes(prep_msg, i) == msg
        assert ints(out0, i) == host.prepare_next(st0, msg)
        assert ints(out1, i) == host.prepare_next(st1, msg)


# --- (g) registry and feasibility ---------------------------------------------

BELOW_2_17 = [
    ("count", {}),
    ("sum", {"bits": 8}),
    ("sumvec", {"length": 1000, "bits": 16}),
    ("sumvec", {"length": 8000, "bits": 16}),  # input_len 128,000
    ("histogram", {"length": 7}),
]
BUDGETS = [None, 10**6, 10**8, 2 * 10**9, 80 * 10**9]


@pytest.mark.parametrize("kind,kw", BELOW_2_17, ids=lambda x: str(x))
def test_supports_circuit_and_feasibility_agree_with_jax(kind, kw):
    """The draft gate's verdicts are janus_tpu's. The memory model counts
    the port's own bytes (vdaf/feasibility.py): at least what both
    packages keep resident, and for the contraction query the float64
    limbs of the whole share; rows and buckets follow from it as in
    janus_tpu."""
    inst = t_registry.VdafInstance(kind, xof_mode="draft", **kw)
    t_circ = t_registry.circuit_for(inst)
    j_circ = j_registry.circuit_for(j_registry.VdafInstance(kind, xof_mode="draft", **kw))
    assert t_circ.input_len < 1 << 17
    for budget in BUDGETS[1:]:
        assert td.Prio3BatchedDraft.supports_circuit(t_circ, budget) == jd.Prio3BatchedDraft.supports_circuit(
            j_circ, budget
        ), budget
    e = t_circ.FIELD.ENCODED_SIZE
    resident = (t_circ.input_len + 2 * (t_circ.proof_len + t_circ.verifier_len + t_circ.output_len)) * e
    for draft in (False, True):
        row = t_feas.prepare_row_bytes(t_circ, draft=draft)
        assert row >= resident + (t_circ.input_len * e if draft else 0)
        if kind in ("sumvec", "histogram"):
            assert row >= resident + t_circ.input_len * 19 * 8  # the limb operand
        for budget in BUDGETS:
            rows = t_feas.feasible_rows(t_circ, budget, draft=draft)
            bucket = t_feas.feasible_bucket(t_circ, budget, draft=draft)
            if budget is None:
                assert rows is None and bucket is None
                continue
            assert rows == max(1, int(budget * t_feas.HEADROOM) // row)
            assert bucket & (bucket - 1) == 0 and bucket <= rows < 2 * bucket
    assert td.Prio3BatchedDraft.supports_circuit(t_circ)  # unknown budget: no memory bound
    assert isinstance(t_registry.prio3_batched(inst, CPU), td.Prio3BatchedDraft)


@pytest.mark.parametrize("length", [8192, 10_000])  # input_len 131,072 = 2^17, and 160,000
def test_draft_at_and_above_2_17_inputs_names_the_streamed_query(length):
    """Draft mode takes these inputs now: its engine's plan is the
    streamed query's, over the helper's whole expanded share."""
    inst = t_registry.VdafInstance("sumvec", bits=16, length=length, xof_mode="draft")
    circ = t_registry.circuit_for(inst)
    assert circ.input_len >= 1 << 17
    assert td.Prio3BatchedDraft.supports_circuit(circ)
    p3 = t_registry.prio3_batched(inst, CPU)
    assert isinstance(p3, td.Prio3BatchedDraft)
    assert p3.plan is not None and p3.plan == t_engine.stream_plan(p3.bc)
    assert p3._can_stream and not p3._stream_expand_offsets


def test_device_memory_budget_is_none_on_the_cpu():
    assert t_feas.device_memory_budget(CPU) is None
    assert t_feas.device_memory_budget("cpu") is None
