"""janus_tpu_torch's block-sparse SumVec held against janus_tpu's.

- Registry dicts round-trip between the packages in both XOF modes, and
  the circuit's geometry is janus_tpu's (compact FLP width, logical
  aggregate length).
- The index codecs: the blob goldens, and the reject-divergence fuzz of
  tests/test_sparse_vdaf.py run across packages (the port's per-report
  decoder and its vectorized predicate against janus_tpu's decoder, row
  for row); a rejection lands on the offending lane only.
- The host sharder gives janus_tpu's public share bytes and input shares
  in both XOF modes, and the collector's unshard reads the logical length.
- The plain scatter (Prio3Batched.scatter_rows on the CPU) equals
  janus_tpu's Prio3Batched.scatter_rows and Prio3Sparse.aggregate_sparse
  with rejected rows, padding lanes, the padding rows of a bucket and a
  hot block that every report carries.
- EngineCache.aggregate_sparse equals janus_tpu's on a padded bucket of
  DeviceRows (the helper's padding rows hold nonzero garbage), on
  DeviceRowsChunks and on host rows; the OOM ladder halves the rows a
  scatter takes, stays exact, and raises at its floor: there is no host
  scatter. Both XOF modes prepare and aggregate to the ground truth.
- Upload, aggregate and collect in all four leader/helper pairings of the
  two packages: stored rows, problem documents and the collection equal
  a janus_tpu pair's, and a report with bad indices is refused at upload.

The port runs with device="cpu"; tolerance: exact equality of field
elements and bytes. janus_tpu's host engine, resident accumulators, mesh,
manifest, prewarm and metrics cases have no port counterpart.
"""

import base64
import dataclasses
import json

import numpy as np
import pytest
import torch

from janus_tpu import client as j_client_mod
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.aggregator import aggregation_job_creator as j_creator
from janus_tpu.aggregator.engine_cache import EngineCache as JEngineCache
from janus_tpu.messages.codec import DecodeError as JDecodeError
from janus_tpu.vdaf import reference as j_reference
from janus_tpu.vdaf import registry as j_registry
from janus_tpu.vdaf import testing as j_testing
from janus_tpu.vdaf import wire as j_wire
from janus_tpu_torch import client as t_client_mod
from janus_tpu_torch.aggregator import aggregation_job_creator as t_creator
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.aggregator.engine_cache import DeviceRows, DeviceRowsChunks, EngineCache
from janus_tpu_torch.convert import step_args_from_jax
from janus_tpu_torch.fields.tfield import TF128
from janus_tpu_torch.messages.codec import DecodeError
from janus_tpu_torch.ops import scatter_cuda
from janus_tpu_torch.vdaf import circuits as t_circuits
from janus_tpu_torch.vdaf import reference as t_reference
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import testing as t_testing
from janus_tpu_torch.vdaf import wire as t_wire

CPU = torch.device("cpu")
VK = bytes(range(16))
GEOM = dict(bits=2, length=48, block_size=4, max_blocks=3)
P = 2**128 - 7 * 2**66 + 1


def _insts(mode: str = "fast", **kw):
    g = {**GEOM, **kw}
    j = dataclasses.replace(j_registry.VdafInstance.sparse_sumvec(**g), xof_mode=mode)
    t = dataclasses.replace(t_registry.VdafInstance.sparse_sumvec(**g), xof_mode=mode)
    return j, t


def _oracle(circ, meas, lanes):
    """Plaintext logical sums (mod p) over the given reports."""
    want = [0] * circ.logical_length
    for i in lanes:
        for b, block in meas[i]:
            for o, v in enumerate(block):
                want[b * circ.block_size + o] = (want[b * circ.block_size + o] + int(v)) % P
    return want


# --- registry and circuit -----------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fast", "draft"])
@pytest.mark.parametrize("geom", [GEOM, dict(bits=16, length=1_000_000, block_size=64, max_blocks=16, chunk_length=5)])
def test_registry_round_trip_and_circuit_are_janus_tpus(mode, geom):
    j, t = _insts(mode, **geom)
    assert t.to_dict() == j.to_dict()
    assert t_registry.VdafInstance.from_dict(j.to_dict()) == t
    assert j_registry.VdafInstance.from_dict(t.to_dict()) == j
    tc, jc = t_registry.circuit_for(t), j_registry.circuit_for(j)
    assert isinstance(tc, t_circuits.SparseSumVec)
    for k in ("logical_length", "block_size", "max_blocks", "n_logical_blocks", "input_len", "output_len",
              "agg_output_len", "proof_len", "verifier_len", "chunk_length", "algo_id", "joint_rand_len"):
        assert getattr(tc, k) == getattr(jc, k), k
    assert tc.output_len == geom["max_blocks"] * geom["block_size"] and tc.agg_output_len == geom["length"]
    assert isinstance(t_registry.prio3_host(t), t_reference.Prio3Sparse)


@pytest.mark.parametrize("bad", [dict(length=50), dict(max_blocks=13), dict(block_size=0)])
def test_geometry_refusals_are_janus_tpus(bad):
    g = {**GEOM, **bad}
    for circ in (j_reference.SparseSumVec, t_circuits.SparseSumVec):
        with pytest.raises(ValueError):
            circ(g["length"], g["block_size"], g["max_blocks"], g["bits"])


# --- index codecs ---------------------------------------------------------------------------


def test_index_blob_codec_goldens():
    _, t = _insts()
    circ = t_registry.circuit_for(t)
    blob = t_wire.encode_block_indices([2, 7, -1])
    assert blob == (2).to_bytes(4, "big") + (7).to_bytes(4, "big") + b"\xff" * 4
    assert blob == j_wire.encode_block_indices([2, 7, -1])
    assert t_wire.decode_block_indices(blob, circ) == (2, 7, -1)
    with pytest.raises(DecodeError):
        t_wire.decode_block_indices(blob + b"\x00", circ)  # wrong length
    with pytest.raises(DecodeError):
        t_wire.decode_block_indices(t_wire.encode_block_indices([7, 2, -1]), circ)  # descending
    assert (t_wire.IDX_ENC_SIZE, t_wire.IDX_PADDING) == (j_wire.IDX_ENC_SIZE, j_wire.IDX_PADDING)


def _mutated_blobs(circ, rng, n: int):
    blob_len = circ.max_blocks * 4
    rows = []
    for _ in range(n):
        nb = int(rng.integers(1, circ.max_blocks + 1))
        idxs = sorted(rng.choice(circ.n_logical_blocks, size=nb, replace=False).tolist())
        blob = bytearray(j_wire.encode_block_indices(idxs + [-1] * (circ.max_blocks - nb)))
        for _ in range(int(rng.integers(0, 3))):
            kind = int(rng.integers(0, 3))
            if kind == 0:
                blob[int(rng.integers(0, blob_len))] = int(rng.integers(0, 256))
            elif kind == 1:
                a, b = (int(x) * 4 for x in rng.integers(0, circ.max_blocks, size=2))
                blob[a : a + 4], blob[b : b + 4] = blob[b : b + 4], blob[a : a + 4]
            else:
                k = int(rng.integers(0, circ.max_blocks)) * 4
                blob[k : k + 4] = b"\xff" * 4
        rows.append(bytes(blob))
    return rows


def test_wire_reject_divergence_fuzz_against_janus_tpu():
    """Mutated index blobs: the port's vectorized predicate and its
    per-report decoder agree with janus_tpu's decoder on every row, on the
    verdict and on the indices of an accepted row."""
    j, t = _insts(length=64, max_blocks=4)
    jc, tc = j_registry.circuit_for(j), t_registry.circuit_for(t)
    rows = _mutated_blobs(jc, np.random.default_rng(21), 300)
    want = []
    for blob in rows:
        try:
            want.append(tuple(j_wire.decode_block_indices(blob, jc)))
        except JDecodeError:
            want.append(None)
        try:
            got = t_wire.decode_block_indices(blob, tc)
        except DecodeError:
            got = None
        assert got == want[-1]
    assert 0 < sum(w is None for w in want) < len(want)
    got_idx, got_ok = t_wire.decode_index_columns(rows, tc)
    assert got_ok.tolist() == [w is not None for w in want]
    for i, w in enumerate(want):
        assert tuple(int(x) for x in got_idx[i]) == (w if w is not None else (-1,) * 4)
    j_idx, j_ok = j_wire.decode_index_columns(rows, jc)
    assert np.array_equal(got_idx, j_idx) and np.array_equal(got_ok, j_ok)
    _, ok2 = t_wire.decode_index_columns([rows[0][:-1], None, rows[0]], tc)
    assert ok2.tolist() == [False, False, want[0] is not None]


def test_rejection_lands_on_offending_lane_only():
    _, t = _insts()
    circ = t_registry.circuit_for(t)
    good = t_wire.encode_block_indices([1, 5, -1])
    bad = [
        t_wire.encode_block_indices([2, 2, -1]),  # duplicate
        t_wire.encode_block_indices([5, 1, -1]),  # descending
        t_wire.encode_block_indices([0, 12, -1]),  # out of range (12 blocks: 0..11)
        t_wire.encode_block_indices([0, -1, 3]),  # an index after padding
    ]
    idx, ok = t_wire.decode_index_columns([good, *bad, good], circ)
    assert ok.tolist() == [True, False, False, False, False, True]
    assert (idx[1:5] == -1).all() and [int(x) for x in idx[0]] == [1, 5, -1]
    flat = t_wire.flat_scatter_indices(idx, circ)
    assert flat.dtype == np.int32 and (flat[1:5] == circ.logical_length).all()
    assert flat[0].tolist() == [4, 5, 6, 7, 20, 21, 22, 23] + [48] * 4
    assert np.array_equal(flat, j_wire.flat_scatter_indices(idx, circ))


# --- host sharder and unshard ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fast", "draft"])
def test_host_shard_is_janus_tpus(mode):
    j, t = _insts(mode)
    jh, th = j_registry.prio3_host(j), t_registry.prio3_host(t)
    jw, tw = j_wire.Prio3Wire(jh.circuit), t_wire.Prio3Wire(th.circuit)
    assert tw.public_share_len == jw.public_share_len == 3 * 4 + 32
    meas = t_testing.random_measurements(t, 4, np.random.default_rng(5))
    assert meas == j_testing.random_measurements(j, 4, np.random.default_rng(5))
    rng = np.random.default_rng(6)
    for m in meas:
        nonce, rand = rng.bytes(16), rng.bytes(th.rand_size)
        (jp, (jl, jhs)), (tp, (tl, ths)) = jh.shard(m, nonce, rand), th.shard(m, nonce, rand)
        raw = tw.encode_public_share(tp)
        assert raw == jw.encode_public_share(jp)
        assert tp.indices == jp.indices and list(tp) == list(jp)
        dec = tw.decode_public_share(raw)
        assert isinstance(dec, t_reference.SparsePublicShare) and dec.indices == jp.indices and list(dec) == list(jp)
        t_leader = tw.encode_leader_share(tl.measurement_share, tl.proof_share, tl.joint_rand_blind)
        assert t_leader == jw.encode_leader_share(jl.measurement_share, jl.proof_share, jl.joint_rand_blind)
        assert tw.encode_helper_share(ths.seed, ths.joint_rand_blind) == jw.encode_helper_share(
            jhs.seed, jhs.joint_rand_blind
        )
    with pytest.raises(ValueError):
        tw.encode_public_share([b"\x00" * 16] * 2)  # no indices
    shares = [[int(x) for x in np.random.default_rng(7).integers(0, 2**62, 48)] for _ in range(2)]
    assert th.unshard(shares, 2) == jh.unshard(shares, 2)
    assert len(th.unshard(shares, 2)) == 48


# --- the plain scatter against janus_tpu's --------------------------------------------------


def _scatter_case(case: str, rng):
    """(block indices [b, mb] with -1 padding and -1 rows for rejected
    reports or bucket padding, whether each row is live).

    Beside rejected rows, bucket padding and a hot block, the cases shape
    the runs of equal positions down a column that the card's kernel
    adds in registers: every row on one block, runs of two rows that
    alternate between two blocks, blocks that descend row by row, runs
    broken by dead rows, and a hot bucket with dead and padding rows."""
    j, _ = _insts()
    circ = j_registry.circuit_for(j)
    mb, pool = circ.max_blocks, circ.n_logical_blocks
    b = 9 if case in ("rejected", "padding", "hot") else 16
    bi = np.full((b, mb), -1, dtype=np.int32)
    live = np.ones(b, dtype=bool)
    for i in range(b):
        nb = int(rng.integers(1, mb + 1))
        if case in ("hot", "dead-and-padding"):
            idxs = [0] + sorted((1 + rng.choice(pool - 1, size=nb - 1, replace=False)).tolist())
        elif case in ("one-block", "sentinel-runs"):
            idxs = [5]
        elif case == "alternating":
            idxs = [2, 7] if (i // 2) % 2 == 0 else [7]
        elif case == "descending":
            idxs = sorted({pool - 1 - (i % pool), (pool - 1 - 2 * i) % pool})
        else:
            idxs = sorted(rng.choice(pool, size=nb, replace=False).tolist())
        bi[i, : len(idxs)] = idxs
    if case == "rejected":
        live[[1, 4, 5]] = False
    elif case == "padding":
        live[6:] = False  # the padding rows of a bucket
    elif case == "sentinel-runs":
        live[[2, 3, 7, 12]] = False
    elif case == "dead-and-padding":
        live[[1, 5, 6]] = False
        live[11:] = False
    bi[~live] = -1
    return bi, live


SCATTER_CASES = ["rejected", "padding", "hot", "one-block", "alternating", "descending", "sentinel-runs",
                 "dead-and-padding"]


@pytest.mark.parametrize("case", SCATTER_CASES)
def test_plain_scatter_rows_equals_janus_tpu(case):
    import jax.numpy as jnp

    j, t = _insts()
    jc = j_registry.circuit_for(j)
    rng = np.random.default_rng(1 + SCATTER_CASES.index(case))
    bi, live = _scatter_case(case, rng)
    flat = t_wire.flat_scatter_indices(bi, jc)
    b, cm = flat.shape
    vals = [[int.from_bytes(rng.bytes(16), "little") % P for _ in range(cm)] for _ in range(b)]
    acc0 = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(jc.logical_length)]
    p3 = t_registry.prio3_batched(t, CPU)
    got = p3.scatter_rows(
        TF128.from_ints(np.array(acc0, dtype=object), CPU),
        TF128.from_ints(np.array(vals, dtype=object), CPU),
        torch.from_numpy(flat),
    )
    got = [int(x) for x in TF128.to_ints(got)]
    jp3 = j_registry.prio3_batched(j)
    jgot = jp3.scatter_rows(
        jp3.jf.from_ints(np.array(acc0, dtype=object)),
        jp3.jf.from_ints(np.array(vals, dtype=object)),
        jnp.asarray(flat),
    )
    assert got == [int(x) for x in jp3.jf.to_ints(jgot)]
    host = j_registry.prio3_host(j)
    agg = host.aggregate_sparse([(tuple(int(x) for x in bi[i]), vals[i]) for i in range(b) if live[i]])
    assert got == [(a + s) % P for a, s in zip(acc0, agg)]
    if case == "hot":
        assert all(bi[:, 0] == 0)


def test_scatter_wrapper_dispatches_by_device_and_drops_out_of_range_lanes():
    acc = (torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64))
    vals = (torch.tensor([[5, 6, 7]], dtype=torch.int64), torch.zeros((1, 3), dtype=torch.int64))
    idx = torch.tensor([[1, 4, 9]], dtype=torch.int32)  # 4 = L: the sentinel; 9 past it
    scatter_cuda.scatter_rows.launches = 0
    lo, hi = scatter_cuda.scatter_rows(acc, vals, idx)
    assert lo.tolist() == [0, 5, 0, 0] and hi.tolist() == [0] * 4
    assert scatter_cuda.scatter_rows.launches == 0  # the CPU runs the plain version
    with pytest.raises(ValueError):
        scatter_cuda.scatter_rows(acc, vals, idx[:, :2])
    with pytest.raises(ValueError):
        scatter_cuda.scatter_rows(acc[:1], vals, idx)


def test_scatter_scratch_is_counted_by_the_model():
    """The kernel's only scratch is a mark byte a 64-position group, in
    whole 2,048-position blocks, made per launch; its bytes are the
    model's (vdaf/feasibility.py)."""
    from janus_tpu_torch.vdaf import feasibility

    assert [scatter_cuda.scratch_bytes(L) for L in (1, 2048, 2049, 5000, 1_000_000)] == [32, 32, 64, 96, 15648]
    _, t = _insts()
    circ = t_registry.circuit_for(t)
    L, e = circ.agg_output_len, circ.FIELD.ENCODED_SIZE
    assert feasibility.sparse_aggregate_bytes(circ, 10) == (
        10 * circ.output_len * (2 * e + 4) + 2 * L * e + scatter_cuda.scratch_bytes(L)
    )


# --- the engine ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    """Both packages' engines over the same sharded batch of 6 reports,
    the leader's and the helper's out shares of each, and the flat
    scatter targets."""
    j, t = _insts()
    meas = j_testing.random_measurements(j, 6, np.random.default_rng(13))
    args, _ = j_testing.make_report_batch(j, meas, seed=14)
    circ = j_registry.circuit_for(j)
    flat = j_wire.flat_scatter_indices(j_testing.sparse_compact_batch(j, meas)[1], circ)
    je = JEngineCache(j, VK)
    te = EngineCache(t, VK, device=CPU)
    nonce, public, mv, proof, b0, seeds, b1 = args
    ok = np.ones(6, dtype=bool)
    jo0, _, jv0, jp0 = je.leader_init(nonce, public, mv, proof, b0)
    jo1, jacc, _ = je.helper_init(nonce, public, seeds, b1, jv0, jp0, ok)
    targs = step_args_from_jax(args, CPU)
    to0, _, tv0, tp0 = te.leader_init(*targs[:5])
    to1, tacc, _ = te.helper_init(targs[0], targs[1], targs[5], targs[6], tv0, tp0, ok)
    assert np.asarray(jacc).all() and tacc.all()
    return dict(j=j, t=t, meas=meas, args=args, flat=flat, circ=circ, je=je, te=te, jo=(jo0, jo1), to=(to0, to1))


ACCEPT = np.array([True, False, True, True, False, True])


@pytest.mark.parametrize("party", [0, 1])
def test_engine_aggregate_sparse_on_a_padded_bucket_equals_janus_tpu(engines, party):
    e = engines
    out = e["to"][party]
    assert isinstance(out, DeviceRows) and out.value[0].shape[0] == t_ec.MIN_BUCKET and out.n == 6
    if party == 1:
        # the helper's padding rows hold out shares expanded from zero seeds
        assert bool((out.value[0][6:] != 0).any())
    got = e["te"].aggregate_sparse(out, ACCEPT, e["flat"])
    want = e["je"].aggregate_sparse(e["jo"][party], ACCEPT, e["flat"])
    assert len(got) == 48 and all(type(x) is int for x in got)
    assert got == [int(x) for x in want]
    rows = out.to_numpy()
    host = j_registry.prio3_host(e["j"])
    ints = [[int(lo) | (int(hi) << 64) for lo, hi in zip(rows[0][i], rows[1][i])] for i in range(6)]
    bi = j_testing.sparse_compact_batch(e["j"], e["meas"])[1]
    pairs = [(tuple(int(x) for x in bi[i]), ints[i]) for i in range(6) if ACCEPT[i]]
    assert got == host.aggregate_sparse(pairs)
    # host rows and an offset view of the same bucket give the same share
    assert e["te"].aggregate_sparse(rows, ACCEPT, e["flat"]) == got
    view = DeviceRows(tuple(torch.cat([x[:2], x]) for x in out.value), 6, offset=2)
    assert e["te"].aggregate_sparse(view, ACCEPT, e["flat"]) == got


def test_engine_parties_sum_to_the_ground_truth_in_chunks(engines):
    e = engines
    te = EngineCache(e["t"], VK, device=CPU, bucket_cap=2)  # serial 2-row inits
    targs = step_args_from_jax(e["args"], CPU)
    ok = np.ones(6, dtype=bool)
    out0, _, ver0, part0 = te.leader_init(*targs[:5])
    out1, acc, _ = te.helper_init(targs[0], targs[1], targs[5], targs[6], ver0, part0, ok)
    assert isinstance(out0, DeviceRowsChunks) and isinstance(out1, DeviceRowsChunks) and acc.all()
    shares = [te.aggregate_sparse(out, ACCEPT, e["flat"]) for out in (out0, out1)]
    assert shares[0] == e["te"].aggregate_sparse(e["to"][0], ACCEPT, e["flat"])
    got = [(a + b) % P for a, b in zip(*shares)]
    assert got == _oracle(e["circ"], e["meas"], np.flatnonzero(ACCEPT))


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def _failing_scatter(eng, n_failures: int):
    orig = eng._dispatch
    state = {"left": n_failures, "raised": [], "rows": []}

    def patched(name, fn, *args):
        if name == "scatter_rows":
            state["rows"].append(args[1][0].shape[0])
            if state["left"] > 0:
                state["left"] -= 1
                exc = _oom()
                state["raised"].append(exc)
                raise exc
        return orig(name, fn, *args)

    eng._dispatch = patched
    return state


def test_oom_halves_the_rows_a_scatter_takes_and_stays_exact(engines):
    e = engines
    te = EngineCache(e["t"], VK, device=CPU)
    want = te.aggregate_sparse(e["to"][1], ACCEPT, e["flat"])
    state = _failing_scatter(te, 1)
    assert te.aggregate_sparse(e["to"][1], ACCEPT, e["flat"]) == want
    # the 32-row bucket failed once, then went as two 16-row dispatches
    assert state["rows"] == [32, 16, 16]
    assert te.bucket_cap == 16 and [h["action"] for h in te.oom_history] == ["halved_to_16"]


def test_oom_ladder_raises_at_its_floor_with_no_host_scatter(engines):
    e = engines
    te = EngineCache(e["t"], VK, device=CPU)
    state = _failing_scatter(te, 100)
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        te.aggregate_sparse(e["to"][1], ACCEPT, e["flat"])
    assert info.value is state["raised"][-1]
    assert [h["action"] for h in te.oom_history] == [
        "halved_to_16", "halved_to_8", "halved_to_4", "halved_to_2", "halved_to_1", "raised"
    ]
    assert state["rows"] == [32, 16, 8, 4, 2, 1]
    # janus_tpu degrades to a host scatter there; the port has none
    assert not hasattr(t_ec, "_host_scatter_rows") and not hasattr(t_ec, "HostEngineCache")


@pytest.mark.parametrize("mode", ["fast", "draft"])
def test_both_modes_prepare_and_scatter_to_the_ground_truth(mode):
    j, t = _insts(mode)
    meas = t_testing.random_measurements(t, 5, np.random.default_rng(17))
    args, _ = t_testing.make_report_batch(t, meas, seed=18, device="cpu")
    circ = t_registry.circuit_for(t)
    te = EngineCache(t, VK, device=CPU)
    out0, _, ver0, part0 = te.leader_init(*args[:5])
    out1, accept, _ = te.helper_init(args[0], args[1], args[5], args[6], ver0, part0, np.ones(5, dtype=bool))
    assert accept.all()
    bi = t_testing.sparse_compact_batch(t, meas)[1]
    flat = t_wire.flat_scatter_indices(bi, circ)
    mask = np.array([True, True, False, True, True])
    shares = [te.aggregate_sparse(out, mask, flat) for out in (out0, out1)]
    host = j_registry.prio3_host(j)
    for out, share in zip((out0, out1), shares):
        rows = out.to_numpy()
        ints = [[int(lo) | (int(hi) << 64) for lo, hi in zip(rows[0][i], rows[1][i])] for i in range(5)]
        assert share == host.aggregate_sparse([(tuple(bi[i].tolist()), ints[i]) for i in range(5) if mask[i]])
    assert t_registry.prio3_host(t).unshard(shares, 4) == _oracle(circ, meas, np.flatnonzero(mask))


# --- upload, aggregate and collect in the four pairings ------------------------------------


class _Seeded:
    """A stand-in for `secrets`: token_bytes and randbelow from one seeded stream."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def token_bytes(self, n: int) -> bytes:
        return self.rng.bytes(n)

    def randbelow(self, n: int) -> int:
        return int.from_bytes(self.rng.bytes(16), "big") % n


PAIR_MEAS = [
    [(0, [1, 2, 3, 0]), (5, [3, 3, 3, 3])],
    [(0, [2, 0, 0, 1])],
    [(1, [0, 1, 2, 3]), (5, [1, 1, 1, 1]), (11, [3, 0, 0, 3])],
    [(0, [3, 3, 3, 3]), (11, [2, 2, 2, 2])],
    [(7, [1, 0, 1, 0])],
]


def _bad_index_report(report):
    """`report` with its two first block indices swapped (descending)."""
    blob = bytearray(report.public_share)
    blob[0:4], blob[4:8] = blob[4:8], blob[0:4]
    return dataclasses.replace(report, public_share=bytes(blob))


def _modules(pkg: str):
    """(client, creator, aggregation driver, Backoff) modules of a package."""
    if pkg == "jax":
        from janus_tpu.aggregator import aggregation_job_driver as adriver
        from janus_tpu.core.retries import Backoff

        return j_client_mod, j_creator, adriver, Backoff
    from janus_tpu_torch.aggregator import aggregation_job_driver as adriver
    from janus_tpu_torch.core.retries import Backoff

    return t_client_mod, t_creator, adriver, Backoff


def sparse_pair(leader_pkg: str, helper_pkg: str, monkeypatch):
    """Five sparse uploads (through the leader package's Client) and one
    with descending indices, one aggregation job, one collection; returns
    what a janus_tpu pair must match."""
    from janus_tpu.core import hpke as j_hpke
    from test_torch_collect import PKG, batch_rows
    from test_torch_upload import client_report_rows

    pl, ph = PKG[leader_pkg], PKG[helper_pkg]
    client_mod, creator_mod, adriver_mod, Backoff = _modules(leader_pkg)
    for mods in ((j_client_mod, j_reference, j_creator), (t_client_mod, t_reference, t_creator)):
        stream = _Seeded(41)
        for mod in mods:
            monkeypatch.setattr(mod, "secrets", stream)
    leader_eph, helper_eph = pl.eph(), ph.eph()
    leader, helper = pl.aggregator(leader_eph), ph.aggregator(helper_eph)
    leader_srv = pl.http.DapServer(pl.http.DapHttpApp(leader)).start()
    helper_srv = ph.http.DapServer(ph.http.DapHttpApp(helper)).start()
    try:
        j, t = _insts()
        collector_kp = pl.hpke.generate_hpke_config_and_private_key(config_id=200)  # the leader package's
        helper_kp = j_hpke.generate_hpke_config_and_private_key(config_id=1)
        task = (
            j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j, jm.Role.LEADER)
            .with_(
                leader_aggregator_endpoint=leader_srv.url, helper_aggregator_endpoint=helper_srv.url,
                collector_hpke_config=jm.HpkeConfig.from_bytes(collector_kp.config.to_bytes()), vdaf_verify_key=VK,
                min_batch_size=1,
            )
            .build()
        )
        helper_task = dataclasses.replace(task, role=jm.Role.HELPER, hpke_keys=(helper_kp,))
        leader_eph.datastore.run_tx(lambda tx: tx.put_task(pl.task(task)))
        helper_eph.datastore.run_tx(lambda tx: tx.put_task(ph.task(helper_task)))
        m = pl.m
        vdaf = j if leader_pkg == "jax" else t
        ltask = pl.task(task)
        http = pl.client.HttpClient(timeout=30)
        params = client_mod.ClientParameters(ltask.task_id, leader_srv.url, helper_srv.url, ltask.time_precision)
        client = client_mod.Client.with_fetched_configs(params, vdaf, http, clock=leader_eph.clock)
        for meas in PAIR_MEAS:
            client.upload(meas)
        bad = _bad_index_report(client.prepare_report(PAIR_MEAS[0]))
        status, body = http.put(params.upload_uri(), bad.to_bytes(), {"Content-Type": m.Report.MEDIA_TYPE})
        problem = json.loads(body)
        # the task id is drawn anew each run: it must be this task's
        assert problem.pop("taskid") == base64.urlsafe_b64encode(task.task_id.data).decode().rstrip("=")
        upload_answer = (status, problem)
        reports = client_report_rows(leader_eph.datastore, helper_kp)

        creator = creator_mod.AggregationJobCreator(
            leader_eph.datastore, creator_mod.AggregationJobCreatorConfig(min_aggregation_job_size=1)
        )
        assert creator.run_once() == 1
        device = {} if leader_pkg == "jax" else {"device": "cpu"}
        drv = adriver_mod.AggregationJobDriver(
            leader_eph.datastore, http, adriver_mod.AggregationJobDriverConfig(http_backoff=Backoff.test()), **device
        )
        cfg = pl.jobs.JobDriverConfig(max_concurrent_job_workers=1)
        assert pl.jobs.JobDriver(cfg, drv.acquirer(), drv.stepper).run_once() == 1

        def ra_rows(eph):
            return sorted(eph.datastore.run_tx(lambda tx: tx._c.execute(
                "SELECT report_id, ord, state, prepare_error FROM report_aggregations"
            ).fetchall()))

        rows = (batch_rows(leader_eph.datastore), batch_rows(helper_eph.datastore), ra_rows(leader_eph),
                ra_rows(helper_eph))
        start = leader_eph.clock.now().to_batch_interval_start(ltask.time_precision)
        query = m.Query.time_interval(m.Interval(m.Time(start.seconds - 3600), m.Duration(2 * 3600)))
        collector = pl.collector.Collector(
            pl.collector.CollectorParameters(ltask.task_id, leader_srv.url, ltask.collector_auth_token, collector_kp),
            vdaf, http,
        )
        job_id = collector.start_collection(query)
        cdrv = pl.cdriver.CollectionJobDriver(
            leader_eph.datastore, http, pl.cdriver.CollectionJobDriverConfig(http_backoff=Backoff.test())
        )
        assert pl.jobs.JobDriver(cfg, cdrv.acquirer(), cdrv.stepper).run_once() == 1
        result = collector.poll_once(job_id, query)
        return {
            "reports": reports,
            "upload_answer": upload_answer,
            "rows": rows,
            "result": (result.report_count, list(result.aggregate_result)),
        }
    finally:
        leader_srv.stop()
        helper_srv.stop()
        leader.close()
        helper.close()
        leader_eph.cleanup()
        helper_eph.cleanup()


_PAIR_CACHE = {}


def _reference_pair(monkeypatch):
    if "ref" not in _PAIR_CACHE:
        _PAIR_CACHE["ref"] = sparse_pair("jax", "jax", monkeypatch)
    return _PAIR_CACHE["ref"]


@pytest.mark.parametrize("pairing", ["jax-jax", "torch-jax", "jax-torch", "torch-torch"])
def test_pairing_uploads_aggregates_and_collects_as_a_janus_tpu_pair(monkeypatch, pairing):
    want = _reference_pair(monkeypatch)
    got = want if pairing == "jax-jax" else sparse_pair(*pairing.split("-"), monkeypatch)
    circ = j_registry.circuit_for(_insts()[0])
    assert got["result"] == (5, _oracle(circ, PAIR_MEAS, range(5)))
    assert got["upload_answer"][0] == 400
    assert got["upload_answer"][1]["type"] == "urn:ietf:params:ppm:dap:error:invalidMessage"
    assert len(got["reports"]) == 5
    # one batch row a side, its share of the logical length
    assert [len(r[4]) for r in got["rows"][0] + got["rows"][1]] == [48 * 16, 48 * 16]
    assert got == want


def test_janus_tpu_sparse_task_and_logical_share_rows_read_in_the_port(tmp_path):
    """A janus_tpu datastore's sparse task row and a batch aggregation
    with a logical-length share read back in the port unchanged, and the
    port merges such shares as janus_tpu does."""
    from janus_tpu.aggregator.accumulator import add_encoded_aggregate_shares as j_add
    from janus_tpu.core import time_util as j_time
    from janus_tpu.datastore import models as j_models
    from janus_tpu.datastore import store as j_store
    from janus_tpu_torch import messages as tm
    from janus_tpu_torch.aggregator.accumulator import add_encoded_aggregate_shares as t_add
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import store as t_store
    from janus_tpu_torch.fields.field import Field128

    key, path, now = bytes(range(16)), str(tmp_path / "ds.sqlite"), 1_700_000_000
    j, t = _insts()
    task = j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j, jm.Role.HELPER).build()
    rng = np.random.default_rng(29)
    share = b"".join((int.from_bytes(rng.bytes(16), "little") % P).to_bytes(16, "little") for _ in range(48))
    bid = jm.Interval(jm.Time(now - now % 3600), jm.Duration(3600)).to_bytes()
    j_ds = j_store.Datastore(path, j_store.Crypter([key]), j_time.MockClock(jm.Time(now)))
    j_ds.run_tx(lambda tx: tx.put_task(task))
    j_ds.run_tx(lambda tx: tx.put_batch_aggregation(j_models.BatchAggregation(
        task.task_id, bid, b"", 0, j_models.BatchAggregationState.AGGREGATING, share, 3,
        jm.Interval(jm.Time(now - now % 3600), jm.Duration(3600)), jm.ReportIdChecksum(bytes(32)),
    )))
    j_ds.close()
    t_ds = t_store.Datastore(path, t_store.Crypter([key]), MockClock(tm.Time(now)))
    try:
        got = t_ds.run_tx(lambda tx: tx.get_task(tm.TaskId(task.task_id.data)))
        assert got.to_dict() == task.to_dict() and got.vdaf == t
        (row,) = t_ds.run_tx(lambda tx: tx.get_batch_aggregations_for_batch(got.task_id, bid, b""))
        assert row.aggregate_share == share and row.report_count == 3
    finally:
        t_ds.close()
    assert t_add(Field128, share, share) == j_add(Field128, share, share)


# --- chip_smoke.py's sparse phases, rehearsed ---------------------------------------------


def test_chip_smoke_sparse_phases_rehearse_on_the_cpu():
    """chip_smoke.py's `sparse` and `upload-drive-sparse` phases with
    device="cpu" at a small geometry: every check of the card's run but
    the launches (none may count off the card) holds."""
    import chip_smoke

    inst = t_registry.VdafInstance.sparse_sumvec(4, 96, 4, 3)
    rec = chip_smoke.phase_sparse(torch, CPU, inst, 40, (5, 30), reps=1, small_batch=3)
    assert (rec["count"], rec["accepted"], rec["aggregate_ok"]) == (38, 37, True)
    assert rec["block0_reports"] == 40 and not any(rec["launches"].values())
    up = chip_smoke.phase_upload_drive(torch, CPU, inst, 2, 30, (3, 20), ("keccak_single_block", "expand_f128"))
    assert up["path"] == "upload-drive-sparse" and up["bad_indices_rejected"] and up["aggregate_ok"]
    assert up["finished"] == 30 and up["collect"]["report_count"] == 30 and up["collect"]["result_ok"]


def test_chip_smoke_scatter_cases_rehearse_on_the_cpu():
    """chip_smoke.py's kernel-4 cases (north star, the leader's chunk,
    the bucket with dead rows) at a small
    geometry with device="cpu", the card's timing calls as no-ops."""
    import chip_smoke
    from test_torch_keccak import _CardTimingOff

    inst = t_registry.VdafInstance.sparse_sumvec(4, 96, 4, 3)
    cases = chip_smoke.check_scatter(_CardTimingOff(), CPU, np.random.default_rng(8), inst, rows=(12, 6, 64))
    assert [c["reports"] for c in cases] == [12, 6, 64]
    assert all(c["max_abs_err"] == 0 and c["logical_length"] == 96 for c in cases)
    assert cases[2]["live_lanes"] < cases[2]["reports"] * cases[2]["compact_lanes"]
