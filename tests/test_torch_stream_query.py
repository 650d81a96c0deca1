"""janus_tpu_torch's streamed FLP query held against its whole-share query and janus_tpu's.

(a) The streamed prepare (vdaf/engine.py flp_query_streamed, over the
    fast helper's share expanded a tile at a time, the draft helper's
    expanded share read by slices, and the leader's staged share read by
    slices) gives the field elements of the whole-share prepare, on the
    same inputs, for circuits whose tiles end off the chunk grid, whose
    chunk divides the alignment, a Histogram and a CountVec, in both XOF
    modes (draft at 3 Keccak rounds: the plain sponge's per-block loop).
    Small inputs reach the streamed route through stream_plan's own
    arguments (min_input_len=1, a small tile).
(b) The port's streamed helper and leader prepare equal janus_tpu's
    streamed prepare (its STREAM_MIN_INPUT_LEN patched to 1, as its own
    tests do), in fast mode and in draft mode.
(c) stream_plan and describe_engine_geometry equal janus_tpu's, field for
    field, at the north star's SumVec(100000, 16) (tile 61,936, 49 calls,
    26 steps) and other lengths; no JAX computation runs.
(d) A whole two-party step on the streamed route accepts every good
    report, rejects the corrupted ones and sums exactly.
(e) The draft engine takes SumVec(100000, 16) at an 80 GB budget and
    refuses what janus_tpu's draft gate refuses.

The port runs with device="cpu"; every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from janus_tpu.vdaf import draft_jax as jd
from janus_tpu.vdaf import engine as j_engine
from janus_tpu.vdaf import keccak_jax as kj
from janus_tpu.vdaf import reference as j_ref
from janus_tpu.vdaf.prio3_jax import Prio3Batched as JPrio3Batched
from janus_tpu_torch.convert import from_numpy_u64, to_numpy_u64
from janus_tpu_torch.parallel import api as t_api
from janus_tpu_torch.vdaf import circuits as tc
from janus_tpu_torch.vdaf import engine as t_engine
from janus_tpu_torch.vdaf import keccak as tk
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import testing as t_testing
from janus_tpu_torch.vdaf.draft import Prio3BatchedDraft
from janus_tpu_torch.vdaf.prio3 import Prio3Batched

CPU = torch.device("cpu")
VERIFY_KEY = bytes(range(16))
BATCH = 3

CIRCUITS = {
    # 640 inputs: tiles of 112 calls x 5 (the alignment lcm(7, 16) = 112
    # is prime to the chunk), the second tile mostly past input_len
    "sumvec-ch5": (tc.SumVec(40, 16, chunk_length=5), 112),
    "sumvec-ch7": (tc.SumVec(56, 8, chunk_length=7), 56),  # the chunk divides the alignment
    "histogram": (tc.Histogram(200, chunk_length=9), 63),
    "countvec": (tc.SumVec(300, 1), 119),  # CountVec: SumVec with one bit an entry
}


def lanes(rng, n):
    return rng.integers(0, 1 << 63, size=(BATCH, n), dtype=np.uint64)


def field_rows(rng, n, limbs=2):
    return tuple(rng.integers(0, 1 << 62, size=(BATCH, n), dtype=np.uint64) for _ in range(limbs))


def inputs(circ, seed=42):
    """numpy-made prepare inputs of both sides, for either package."""
    rng = np.random.default_rng(seed)
    jr = circ.joint_rand_len > 0
    return {
        "nonce": lanes(rng, 2),
        "seed": lanes(rng, 2),
        "blind1": lanes(rng, 2) if jr else None,
        "parts": np.stack([lanes(rng, 2), lanes(rng, 2)], axis=1) if jr else None,
        "meas": field_rows(rng, circ.input_len),
        "proof": field_rows(rng, circ.proof_len),
        "blind0": lanes(rng, 2) if jr else None,
    }


def to_port(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(from_numpy_u64(x, CPU) for x in v)
    return from_numpy_u64(v, CPU)


def port_prepare(p3, x):
    """(helper's 4 outputs, leader's 4 outputs) of a port engine."""
    t = {k: to_port(v) for k, v in x.items()}
    helper = p3.prepare_init_helper(VERIFY_KEY, t["nonce"], t["parts"], t["seed"], t["blind1"])
    leader = p3.prepare_init_leader(VERIFY_KEY, t["nonce"], t["parts"], t["meas"], t["proof"], t["blind0"])
    return helper, leader


def as_numpy(v):
    if v is None:
        return None
    if isinstance(v, tuple):
        return tuple(as_numpy(x) for x in v)
    if isinstance(v, torch.Tensor):
        return to_numpy_u64(v)
    return np.asarray(v).astype(np.uint64)


def assert_same(got, want, what):
    got, want = as_numpy(got), as_numpy(want)
    if want is None:
        assert got is None, what
    elif isinstance(want, tuple):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        assert got.shape == want.shape and (got == want).all(), what


def assert_same_outputs(got, want, side):
    for name, g, w in zip(("out share", "corrected seed", "verifier", "joint-rand part"), got, want):
        assert_same(g, w, f"{side} {name}")


@pytest.fixture
def three_rounds(monkeypatch):
    """Both packages' Keccak at 3 rounds (the draft sponge's plain loop is
    the CPU's slowest part)."""
    monkeypatch.setattr(kj, "KECCAK_ROUNDS", 3)
    monkeypatch.setattr(tk, "KECCAK_ROUNDS", 3)


# --- (a) streamed == whole share, torch only ----------------------------------


@pytest.mark.parametrize("mode", ["fast", "draft"])
@pytest.mark.parametrize("name", list(CIRCUITS))
def test_streamed_prepare_equals_whole_share(name, mode, three_rounds):
    circ, tile = CIRCUITS[name]
    cls = Prio3Batched if mode == "fast" else Prio3BatchedDraft
    streamed = cls(circ, device=CPU)
    whole = cls(circ, device=CPU)
    streamed.plan = t_engine.stream_plan(streamed.bc, min_input_len=1, tile_elems=tile)
    whole.plan = t_engine.stream_plan(whole.bc, min_input_len=circ.input_len + 1)
    assert whole.plan is None
    plan = streamed.plan
    assert plan.group % 7 == 0 and plan.group % plan.bits == 0 and plan.n_steps > 1
    assert plan.n_steps * plan.gcalls >= streamed.bc.calls
    x = inputs(circ)
    s_helper, s_leader = port_prepare(streamed, x)
    w_helper, w_leader = port_prepare(whole, x)
    assert_same_outputs(s_helper, w_helper, "helper")
    assert_same_outputs(s_leader, w_leader, "leader")


def test_fast_helper_expands_its_share_a_tile_at_a_time(monkeypatch):
    """The fast helper's streamed source is kernel 2's wrapper at block
    offsets k * group / 7, never one call over the whole share."""
    circ, tile = CIRCUITS["histogram"]
    p3 = Prio3Batched(circ, device=CPU)
    p3.plan = t_engine.stream_plan(p3.bc, min_input_len=1, tile_elems=tile)
    calls = []
    real = tk.expand_f128

    def spy(prefix, blocks, length, block_offset=0, rounds=24):
        calls.append((blocks, length, block_offset))
        return real(prefix, blocks, length, block_offset=block_offset, rounds=rounds)

    monkeypatch.setattr(tk, "expand_f128", spy)
    x = inputs(circ)
    t = {k: to_port(v) for k, v in x.items()}
    p3.prepare_init_helper(VERIFY_KEY, t["nonce"], t["parts"], t["seed"], t["blind1"])
    g = p3.plan.group
    share = [c for c in calls if c[1] == g]
    assert share == [(g // 7, g, k * g // 7) for k in range(p3.plan.n_steps)]
    assert all(c[1] < circ.input_len for c in calls)


# --- (b) the port's streamed prepare == janus_tpu's -----------------------------


@pytest.mark.parametrize(
    "mode,circ_args",
    [("fast", ("histogram", (200,), {"chunk_length": 9})), ("draft", ("histogram", (200,), {"chunk_length": 9}))],
    ids=["fast-histogram", "draft-histogram"],
)
def test_streamed_prepare_matches_janus_tpu(mode, circ_args, monkeypatch, three_rounds):
    kind, args, kw = circ_args
    t_circ = (tc.Histogram if kind == "histogram" else tc.SumVec)(*args, **kw)
    j_circ = (j_ref.Histogram if kind == "histogram" else j_ref.SumVec)(*args, **kw)
    monkeypatch.setattr(j_engine, "STREAM_MIN_INPUT_LEN", 1)
    jp3 = (JPrio3Batched if mode == "fast" else jd.Prio3BatchedDraft)(j_circ)
    tp3 = (Prio3Batched if mode == "fast" else Prio3BatchedDraft)(t_circ, device=CPU)
    tp3.plan = t_engine.stream_plan(tp3.bc, min_input_len=1)
    j_plan = j_engine.stream_plan(jp3.bc)
    assert (tp3.plan.gcalls, tp3.plan.n_steps, tp3.plan.group) == (j_plan.gcalls, j_plan.n_steps, j_plan.group)
    assert tp3.plan.n_steps > 1
    x = inputs(t_circ, seed=5)
    t_helper, t_leader = port_prepare(tp3, x)
    j_helper = jp3.prepare_init_helper(VERIFY_KEY, x["nonce"], x["parts"], x["seed"], x["blind1"])
    j_leader = jp3.prepare_init_leader(VERIFY_KEY, x["nonce"], x["parts"], x["meas"], x["proof"], x["blind0"])
    assert_same_outputs(t_helper, j_helper, "helper")
    assert_same_outputs(t_leader, j_leader, "leader")


# --- (c) the plan and the geometry ----------------------------------------------

GEOMETRY = {
    "sumvec-100k": ("sumvec", {"length": 100_000, "bits": 16}),
    "histogram-200k": ("histogram", {"length": 200_000}),
    "countvec-200k": ("countvec", {"length": 200_000}),
    "fixedpoint": ("fixedpoint", {"length": 10_000, "bits": 16}),
    "sumvec-below": ("sumvec", {"length": 8000, "bits": 16}),
}


@pytest.mark.parametrize("name", list(GEOMETRY))
def test_stream_plan_and_geometry_match_janus_tpu(name):
    from janus_tpu.vdaf import registry as j_registry

    kind, kw = GEOMETRY[name]
    make = {"countvec": "count_vec", "fixedpoint": "fixed_point_vec", "sumvec": "sum_vec", "histogram": "histogram"}[kind]
    t_bc = t_engine.batched_circuit(t_registry.circuit_for(getattr(t_registry.VdafInstance, make)(**kw)))
    j_bc = j_engine.batched_circuit(j_registry.circuit_for(getattr(j_registry.VdafInstance, make)(**kw)))
    t_plan, j_plan = t_engine.stream_plan(t_bc), j_engine.stream_plan(j_bc)
    if j_plan is None:
        assert t_plan is None
    else:
        assert (t_plan.gcalls, t_plan.n_steps, t_plan.group, t_plan.bits) == (
            j_plan.gcalls, j_plan.n_steps, j_plan.group, j_plan.bits
        )
    assert t_engine.describe_engine_geometry(t_bc) == j_engine.describe_engine_geometry(j_bc)
    if name == "sumvec-100k":
        assert (t_plan.group, t_plan.gcalls, t_plan.n_steps) == (61_936, 49, 26)
        assert t_bc.calls == 1266 and t_bc.circ.chunk_length == 1264
    if name in ("fixedpoint", "sumvec-below"):
        assert t_plan is None


def test_stream_plan_takes_its_threshold_and_tile_as_arguments():
    bc = t_engine.batched_circuit(tc.SumVec(100_000, 16))
    assert t_engine.stream_plan(bc, min_input_len=bc.circ.input_len + 1) is None
    small = t_engine.stream_plan(bc, tile_elems=1)  # floors at the alignment quantum
    assert small.gcalls == 7 and small.group == 7 * 1264 and small.n_steps == -(-1266 // 7)
    short = t_engine.stream_plan(t_engine.batched_circuit(tc.SumVec(21, 4)), min_input_len=1)
    j_short = j_engine.stream_plan(j_engine.batched_circuit(j_ref.SumVec(21, 4)), min_input_len=1)
    assert (short.gcalls, short.n_steps, short.group) == (j_short.gcalls, j_short.n_steps, j_short.group)


# --- (d) a whole two-party step on the streamed route -----------------------------


@pytest.mark.parametrize("kind,kw", [("sumvec", {"length": 40, "bits": 16, "chunk_length": 5}),
                                     ("countvec", {"length": 300})], ids=["sumvec", "countvec"])
def test_two_party_step_on_the_streamed_route(kind, kw, monkeypatch):
    inst = t_registry.VdafInstance(kind, **({"bits": 1} if kind == "countvec" else {}), **kw)
    p3 = t_registry.prio3_batched(inst, CPU)
    plan = t_engine.stream_plan(p3.bc, min_input_len=1, tile_elems=112)
    assert plan is not None and plan.n_steps > 1
    monkeypatch.setattr(p3, "plan", plan)
    batch = 5
    meas = t_testing.random_measurements(inst, batch, np.random.default_rng(3))
    args, _ = t_testing.make_report_batch(inst, meas, seed=4, device=CPU)
    args = list(args)
    # report 2's leader proof share off by one
    proof = tuple(x.clone() for x in args[3])
    bumped = p3.tf.add(tuple(x[2:3, :1] for x in proof), p3.tf.from_ints(np.array([[1]], dtype=object), CPU))
    for x, v in zip(proof, bumped):
        x[2:3, :1] = v
    args[3] = proof
    agg0, agg1, count = t_api.two_party_step(inst, VERIFY_KEY, device=CPU)(*args)
    assert int(count) == batch - 1
    valid = np.arange(batch) != 2
    total = [int(v) for v in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    assert total == [int(v) for v in np.asarray(meas)[valid].sum(axis=0)]


# --- (e) the draft gate ------------------------------------------------------------


def test_draft_takes_sumvec_100k_and_refuses_what_janus_tpu_refuses():
    big = tc.SumVec(100_000, 16)
    assert Prio3BatchedDraft.refusal(big, 80 * 10**9) is None
    assert Prio3BatchedDraft.supports_circuit(big)
    assert jd.Prio3BatchedDraft.supports_circuit(j_ref.SumVec(100_000, 16), 80 * 10**9)
    inst = t_registry.VdafInstance("sumvec", bits=16, length=100_000, xof_mode="draft")
    p3 = t_registry.prio3_batched(inst, CPU)
    assert isinstance(p3, Prio3BatchedDraft) and p3.plan == t_engine.stream_plan(p3.bc)
    assert p3.plan is not None and not p3._stream_expand_offsets
    # past MAX_STREAM_BLOCKS (a 167,620-block absorb), and too little memory
    for length, budget in ((110_000, 80 * 10**9), (110_000, None), (100_000, 10**8), (100_000, 2 * 10**9)):
        t_circ, j_circ = tc.SumVec(length, 16), j_ref.SumVec(length, 16)
        want = jd.Prio3BatchedDraft.supports_circuit(j_circ, budget)
        assert (Prio3BatchedDraft.refusal(t_circ, budget) is None) == want, (length, budget)
    assert "exceed 160000" in Prio3BatchedDraft.refusal(tc.SumVec(110_000, 16))
    with pytest.raises(ValueError, match="exceed"):
        t_registry.prio3_batched(t_registry.VdafInstance("sumvec", bits=16, length=110_000, xof_mode="draft"), CPU)


# --- (f) the memory model's binder phase ---------------------------------------------


def test_leader_binder_reaches_kernel_1_in_place(monkeypatch):
    """The leader's joint-rand binder (agg id, nonce, encoded share) goes
    to kernel 1's leaf level as its parts, the share tensor itself, and
    each level above reads the digests below as they lie: no assembled,
    padded or stacked copy of the message, which is why the model's
    binder phase is the encoded share and its leaf digests alone."""
    from janus_tpu_torch.fields.tfield import fencode_lanes
    from janus_tpu_torch.vdaf import feasibility

    p3 = Prio3Batched(tc.SumVec(20, 4), device=CPU)
    rng = np.random.default_rng(9)
    meas = p3.tf.from_ints(rng.integers(0, 2, size=(BATCH, p3.circ.input_len)).astype(object), CPU)
    binder = fencode_lanes(meas)
    seen = []
    real = tk.keccak_tree_level
    monkeypatch.setattr(tk, "keccak_tree_level", lambda parts, *a, **k: seen.append((parts, a)) or real(parts, *a, **k))
    got = p3._joint_rand_part(0, from_numpy_u64(lanes(rng, 2), CPU), from_numpy_u64(lanes(rng, 2), CPU), binder)
    assert got.shape == (BATCH, 2)
    (leaf_parts, leaf_args), *upper = seen
    assert leaf_args[:2] == (3 + binder.shape[1], BATCH) and leaf_args[2] == 0  # lanes, batch, level 0
    assert any(content is binder for _, content in leaf_parts)
    for level, (parts, args) in enumerate(upper, start=1):
        ((off, digs),) = parts
        assert off == 0 and args[2] == level and digs.shape == (BATCH, args[0])
    big = tc.SumVec(100_000, 16)
    plan = t_engine.stream_plan(t_engine.batched_circuit(big))
    assert feasibility.BINDER_COPIES >= 1 + 1 / 7
    with_binder = feasibility.prepare_row_bytes(big, tile_elems=plan.group)
    monkeypatch.setattr(feasibility, "BINDER_COPIES", 0)
    # at the north star's tile the binder is the step's largest phase
    assert with_binder - feasibility.prepare_row_bytes(big, tile_elems=plan.group) > 0
