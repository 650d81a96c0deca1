"""The field kernels' plain versions and launch geometry, on the CPU.

Kernels 5-8 (csrc/field_arith.cu, ntt.cu, field_rows.cu, limb_contract.cu)
run only on the card (their wrappers: ops/field_cuda.py, ntt_cuda.py,
rows_cuda.py, limb_cuda.py); their arithmetic is their plain versions'
(the eager bodies in fields/tfield.py, ops/ntt.py and ops/limbmm.py),
which are held here against janus_tpu's jfield, ntt and limbmm functions (JAX on the CPU)
at the operand layouts a step passes: a strided column against a column,
[b, n] against [b, 1], an NTT stage's half rows against its twiddles,
[b, 126] against a 0-d constant and two strided [b, 255] views, with the
edge values 0, 1, p - 1, p - 2 and limbs with the top bit set. The inputs
are made with numpy from a seed; the tolerance is exact equality. Then
each wrapper's launch geometry (the shape, strides and stride-0 axes it
passes a kernel) is held against torch.broadcast_shapes and against the
views it describes, CPU tensors are shown to take the plain route with
every launch counter unchanged, the launchers to refuse them, and
operands on two devices to raise.
The card's checks of the kernels themselves are in
tests/test_torch_kernels_cuda.py.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.fields import jfield as jf_mod
from janus_tpu.fields.jfield import JF64, JF128
from janus_tpu.ops import limbmm as j_limbmm
from janus_tpu.ops import ntt as j_ntt
from janus_tpu.vdaf import engine as j_engine
from janus_tpu_torch.fields import tfield
from janus_tpu_torch.fields.tfield import TF64, TF128
from janus_tpu_torch.ops import cuda_build, field_cuda, limb_cuda, limbmm, ntt, ntt_cuda, rows_cuda

FIELDS = {"Field64": (JF64, TF64), "Field128": (JF128, TF128)}
B = 5  # reports


def _elements(p: int, shape, seed: int) -> np.ndarray:
    """Field elements of `shape` (object ints): the edge values first,
    then uniform draws from the seed."""
    n = int(np.prod(shape, dtype=np.int64))
    edges = [0, 1, p - 1, p - 2, 2**63, 2**63 + 1, 2**64 - 1, p - 2**64, 2**127, 2**127 + 2**63 + 5]
    edges = [e for e in edges if 0 <= e < p]
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(24), "little") % p for _ in range(n)]
    vals = (edges + rand)[:n]
    rng.shuffle(vals)
    return np.array(vals, dtype=object).reshape(shape)


def _limbs(tf, ints) -> list:
    """The limbs of field elements as uint64 numpy arrays."""
    flat = [int(x) for x in ints.reshape(-1)]
    return [np.array([(x >> (64 * i)) & ((1 << 64) - 1) for x in flat], dtype=np.uint64).reshape(ints.shape)
            for i in range(tf.LIMBS)]


def _values(tf, phys_shape, view, seed: int):
    """A value laid out in a physical array, and its view: (the port's
    torch view, janus_tpu's contiguous JAX array of the same elements)."""
    limbs = _limbs(tf, _elements(tf.MODULUS, phys_shape, seed))
    port = tuple(view(torch.from_numpy(np.ascontiguousarray(x).view(np.int64))) for x in limbs)
    jax = tuple(jnp.asarray(np.ascontiguousarray(view(x))) for x in limbs)
    return port, jax


def _equal(port, jax) -> bool:
    got = [x.contiguous().numpy().view(np.uint64) for x in port]
    want = [np.asarray(x) for x in jax]
    return all(g.shape == w.shape and (g == w).all() for g, w in zip(got, want))


# The operand layouts of a step: (name, a's physical shape and view, b's)
LAYOUTS = {
    "strided column x column": (((B, 3), lambda x: x[:, 1]), ((B,), lambda x: x)),
    "[b, n] x [b, 1]": (((B, 9), lambda x: x), ((B, 1), lambda x: x)),
    "ntt stage x twiddles": (((B, 16), lambda x: x.reshape(B, 2, 8)[..., 4:]), ((4,), lambda x: x)),
    "[b, 126] x 0-d": (((B, 126), lambda x: x), ((), lambda x: x)),
    "strided x strided [b, 255]": (((B, 510), lambda x: x[:, 1::2]), ((510, B), lambda x: x.T[:, ::2])),
}
OPS = ["add", "sub", "mul", "neg", "mul_pow2 32", "mul_pow2 33"]


@lru_cache(maxsize=None)
def _layout(field: str, layout: str):
    jf, tf = FIELDS[field]
    (pa, va), (pb, vb) = LAYOUTS[layout]
    return _values(tf, pa, va, 1 + len(layout)), _values(tf, pb, vb, 2 + len(layout))


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("field", list(FIELDS))
def test_elementwise_plain_matches_janus_tpu(field, layout, op):
    """Kernel 5's plain version (the TF64/TF128 bodies, fmul_pow2_plain)
    against jfield on the step's operand layouts."""
    jf, tf = FIELDS[field]
    (ta, ja), (tb, jb) = _layout(field, layout)
    if op.startswith("mul_pow2"):
        k = int(op.split()[1])
        got, want = tfield.fmul_pow2_plain(tf, ta, k), jf_mod.fmul_pow2(jf, ja, k)
    elif op == "neg":
        got, want = tf.neg_plain(ta), jf.neg(ja)
    else:
        got, want = getattr(tf, f"{op}_plain")(ta, tb), getattr(jf, op)(ja, jb)
    assert _equal(got, want)
    # the dispatching entry takes the plain route on the CPU
    if op.startswith("mul_pow2"):
        again = tfield.fmul_pow2(tf, ta, k)
    elif op == "neg":
        again = tf.neg(ta)
    else:
        again = getattr(tf, op)(ta, tb)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [2, 128])
@pytest.mark.parametrize("field", list(FIELDS))
def test_ntt_plain_matches_janus_tpu(field, n, inverse):
    """Kernel 6's plain version on strided rows [b, 2, n] (every other
    element of [b, 2, 2n]) against janus_tpu's _transform."""
    jf, tf = FIELDS[field]
    tv, jv = _values(tf, (B, 2, 2 * n), lambda x: x[..., ::2], 30 + n)
    got = ntt._transform_plain(tf, tv, n, inverse)
    assert _equal(got, j_ntt._transform(jf, jv, n, inverse))


@pytest.mark.parametrize("n", [1, 127, 255])
@pytest.mark.parametrize("field", list(FIELDS))
def test_powers_plain_matches_janus_tpu(field, n):
    """Kernel 7's powers on a strided column [b] (x = r[:, 0] of [b, 3])."""
    jf, tf = FIELDS[field]
    tx, jx = _values(tf, (B, 3), lambda x: x[:, 0], 40 + n)
    assert _equal(ntt.powers_plain(tf, tx, n), j_ntt.powers(jf, jx, n))


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("field", list(FIELDS))
def test_fsum_and_fdot_plain_match_janus_tpu(field, axis):
    """Kernel 7's sum (aggregate's batch axis among them) and dot on a
    transposed [b, 3, 7] value and a [b, 1, 7] broadcast."""
    jf, tf = FIELDS[field]
    tv, jv = _values(tf, (7, 3, B), lambda x: x.swapaxes(0, 2), 50)
    tw, jw = _values(tf, (B, 1, 7), lambda x: x, 51)
    assert _equal(tfield.fsum_plain(tf, tv, axis), jf_mod.fsum(jf, jv, axis))
    assert _equal(tfield.fdot_plain(tf, tv, tw, axis), jf_mod.fdot(jf, jv, jw, axis))


@pytest.mark.parametrize("field", list(FIELDS))
def test_poly_eval_powers_plain_matches_janus_tpu(field):
    """Kernel 7's fused dot: coefficients [b, 9] at a strided [b, 20] of
    powers."""
    jf, tf = FIELDS[field]
    tc, jc = _values(tf, (B, 9), lambda x: x, 60)
    tp, jp = _values(tf, (B, 2, 20), lambda x: x[:, 1, :], 61)
    assert _equal(ntt.poly_eval_powers_plain(tf, tc, tp), j_ntt.poly_eval_powers(jf, jc, jp))


@pytest.mark.parametrize("field", list(FIELDS))
def test_limb_contract_plain_matches_janus_tpu(field):
    """Kernel 8's plain versions: decompose7 of a strided value against
    janus_tpu's (limb axis last there), and the contraction of strided
    weights against janus_tpu's fold_contract."""
    jf, tf = FIELDS[field]
    tv, jv = _values(tf, (B, 2, 14), lambda x: x[..., ::2], 70)
    want = np.asarray(j_limbmm.decompose7(jf, jv)).astype(np.int64)  # [b, 2, 7, nl]
    for dim in (0, 2, 3):
        got = limbmm.decompose7_plain(tf, tv, dim).to(torch.int64).numpy()
        assert (np.moveaxis(got, dim, -1) == want).all(), dim
    tw, jw = _values(tf, (B, 2, 40), lambda x: x[..., ::2], 71)
    tX, jX = _values(tf, (B, 20, 6), lambda x: x, 72)
    got = limbmm.fold_contract(tf, tw, tX)
    assert _equal(got, j_limbmm.fold_contract(jf, jw, jX))
    assert all(torch.equal(x, y) for x, y in zip(limbmm.fold_contract_plain(tf, tw, tX), got))
    nl = limbmm.NLIMB[tf.LIMBS]
    dl = limbmm.decompose7_plain(tf, tw, 2).reshape(B, 2 * nl, 20)
    dr = limbmm.decompose7_plain(tf, tX, 2).reshape(B, 20, nl * 6)
    assert all(torch.equal(x, y) for x, y in zip(limbmm.recombine_plain(tf, torch.bmm(dl, dr), 2, 6), got))


# The truncation's layouts: (name, the physical shape, the view, the axis)
# for `bits` (SumVec's bits-major view of its share, Sum's axis -1, the
# streamed tile's view of a [b, 3 x 7 x bits] tile)
def _pow2_layouts(bits: int):
    return {
        "bits-major transpose": ((B, 9 * bits), lambda x: x.reshape(B, 9, bits).swapaxes(1, 2), 1),
        "axis -1": ((B, bits), lambda x: x, -1),
        "streamed tile": ((B, 2, 21 * bits), lambda x: x[:, 1].reshape(B, 21, bits).swapaxes(1, 2), 1),
    }


@pytest.mark.parametrize("bits", [1, 2, 16, 63, 64])
@pytest.mark.parametrize("field", list(FIELDS))
def test_pow2_weighted_sum_plain_matches_janus_tpu(field, bits):
    """Kernel 5's fused truncation entry: its plain version against
    janus_tpu's _pow2_weighted_sum at each layout its callers pass."""
    jf, tf = FIELDS[field]
    for i, (name, (phys, view, axis)) in enumerate(_pow2_layouts(bits).items()):
        tv, jv = _values(tf, phys, view, 90 + 10 * bits + i)
        got = tfield.fpow2_weighted_sum_plain(tf, tv, bits, axis)
        assert _equal(got, j_engine._pow2_weighted_sum(jf, jv, bits, axis)), name
        assert all(torch.equal(x, y) for x, y in zip(tfield.fpow2_weighted_sum(tf, tv, bits, axis), got)), name


# -- launch geometry (pure functions) -------------------------------------


def _shape_pairs(seed: int, count: int = 40):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        rank = int(rng.integers(0, 5))
        full = [int(x) for x in rng.integers(1, 4, rank)]
        shapes = []
        for _ in range(int(rng.integers(1, 5))):
            r = int(rng.integers(0, rank + 1))
            shapes.append(tuple(1 if rng.random() < 0.3 else d for d in full[rank - r:]))
        yield shapes


def _strided(shape, seed: int):
    """A tensor of `shape` whose strides are not contiguous ones: a slice
    of a larger tensor, axes permuted and stepped."""
    rng = np.random.default_rng(seed)
    big = torch.arange(int(np.prod([2 * d + 1 for d in shape], dtype=np.int64)) or 1).reshape(
        [2 * d + 1 for d in shape] or [1])
    t = big[tuple(slice(1, 1 + 2 * d, 2) for d in shape)] if shape else big.reshape(())
    if len(shape) > 1 and rng.random() < 0.5:
        perm = list(rng.permutation(len(shape)))
        t = t.permute(perm).contiguous().permute([perm.index(i) for i in range(len(shape))])
    return t


@pytest.mark.parametrize("seed", range(4))
def test_launch_geometry_is_broadcasting(seed):
    """field_arith's geometry: the shape torch.broadcast_shapes gives, each
    operand's strides where it has the axis and 0 where it broadcasts, so
    as_strided over its storage is the operand broadcast; merging the
    axes walks the same elements in the same order."""
    for i, shapes in enumerate(_shape_pairs(seed)):
        ts = [_strided(s, seed * 1000 + 10 * i + j) for j, s in enumerate(shapes)]
        out, per = field_cuda.launch_geometry([t.shape for t in ts], [t.stride() for t in ts])
        assert out == tuple(torch.broadcast_shapes(*shapes))
        mshape, mst = field_cuda.merge_axes(out, per)
        assert len(mshape) <= len(out) and int(np.prod(mshape, dtype=np.int64)) == int(np.prod(out, dtype=np.int64))
        for t, st, ms in zip(ts, per, mst):
            assert all(s == 0 for s, d, o in zip(st[len(out) - t.dim():], t.shape, out[len(out) - t.dim():])
                       if d == 1 and o != 1)
            assert all(s == 0 for s in st[: len(out) - t.dim()])
            view = torch.as_strided(t, out, st, t.storage_offset())
            assert torch.equal(view, t.broadcast_to(out))
            flat = torch.as_strided(t, mshape, ms, t.storage_offset())
            assert torch.equal(flat.reshape(-1), view.reshape(-1))
    with pytest.raises(ValueError):
        field_cuda.launch_geometry([(2, 3), (4, 3)], [(3, 1), (3, 1)])


def test_launch_geometry_of_the_step_layouts():
    """The step's operand layouts pass the kernel no copy and few axes: a
    strided column is one axis of stride 3, [b, n] x [b, 1] broadcasts b's
    column with stride 0, a 0-d constant is stride 0 throughout."""
    col = torch.zeros(B, 3, dtype=torch.int64)[:, 1]
    assert field_cuda.merge_axes(*field_cuda.launch_geometry([col.shape] * 2, [col.stride(), (1,)])) == (
        (B,), [(3,), (1,)])
    a, b = torch.zeros(B, 9, dtype=torch.int64), torch.zeros(B, 1, dtype=torch.int64)
    assert field_cuda.launch_geometry([a.shape, b.shape], [a.stride(), b.stride()]) == ((B, 9), [(9, 1), (1, 0)])
    c = torch.zeros((), dtype=torch.int64)
    a = torch.zeros(B, 126, dtype=torch.int64)
    assert field_cuda.merge_axes(*field_cuda.launch_geometry([a.shape, c.shape], [a.stride(), c.stride()])) == (
        (B * 126,), [(1,), (0,)])
    stage = torch.zeros(B, 16, dtype=torch.int64).reshape(B, 2, 8)[..., 4:]
    tw = torch.zeros(4, dtype=torch.int64)
    assert field_cuda.merge_axes(*field_cuda.launch_geometry([stage.shape, tw.shape], [stage.stride(), tw.stride()])
                                 ) == ((B * 2, 4), [(8, 1), (0, 1)])


def test_fused_launch_geometry_of_the_step_layouts():
    """The two fused entries' geometry against the views they describe:
    the pow2 sum's output axes and its summed axis at each truncation
    layout (at the step's, one output axis whose outputs' inputs follow
    one another, so the kernel's staging reads are contiguous), and the
    contraction's strides of the whole-share query's X and w and of the
    streamed query's w tile and reshaped X tile."""
    for bits in (1, 2, 16, 63, 64):
        for name, (phys, view, axis) in _pow2_layouts(bits).items():
            v = view(torch.arange(int(np.prod(phys))).reshape(phys))
            out_shape, mshape, mst, axis_st = field_cuda.pow2_geometry(tuple(v.shape), [v.stride()], axis, bits)
            whole = v.movedim(axis % v.dim(), -1)
            assert out_shape == tuple(whole.shape[:-1])
            for i in range(bits):
                sl = torch.as_strided(v, mshape, mst[0], v.storage_offset() + i * axis_st[0])
                assert torch.equal(sl.reshape(-1), whole[..., i].reshape(-1)), (name, i)
    step = torch.zeros(B, 16000, dtype=torch.int64).reshape(B, 1000, 16).transpose(1, 2)
    assert field_cuda.pow2_geometry(tuple(step.shape), [step.stride()] * 2, 1, 16) == (
        (B, 1000), (B * 1000,), [(16,), (16,)], [1, 1])
    with pytest.raises(ValueError):
        field_cuda.pow2_geometry((B, 4), [(4, 1)], -1, 5)
    with pytest.raises(ValueError):
        field_cuda.pow2_geometry((B, 70), [(70, 1)], -1, 65)
    X = torch.zeros(B, 127 * 126, dtype=torch.int64).reshape(B, 127, 126)
    w = torch.zeros(B, 2, 127, dtype=torch.int64)
    assert limb_cuda.contract_geometry(w.shape, [w.stride()], X.shape, [X.stride()]) == (
        B, 2, 127, 126, [(254, 127, 1)], [(127 * 126, 126, 1)])
    w_full = torch.arange(B * 2 * 300).reshape(B, 2, 300)
    wt = w_full[:, :, 49:98]
    Xt = torch.arange(B * 3000).reshape(B, 3000)[:, 40:40 + 49 * 40].reshape(B, 49, 40)
    b, W, calls, C, wst, xst = limb_cuda.contract_geometry(wt.shape, [wt.stride()], Xt.shape, [Xt.stride()])
    assert (b, W, calls, C) == (B, 2, 49, 40)
    assert torch.equal(torch.as_strided(w_full, wt.shape, wst[0], wt.storage_offset()), wt)
    assert torch.equal(torch.as_strided(Xt, Xt.shape, xst[0], Xt.storage_offset()), Xt)
    one = torch.zeros(B, 1, 5, dtype=torch.int64)
    assert limb_cuda.contract_geometry(one.shape, [one.stride()], (B, 5, 1), [(5, 1, 1)])[4:] == (
        [(5, 0, 1)], [(5, 1, 0)])
    with pytest.raises(ValueError):
        limb_cuda.contract_geometry((B, 2, 7), [(14, 7, 1)], (B, 8, 3), [(24, 3, 1)])


@pytest.mark.parametrize("seed", range(3))
def test_reduce_geometry_is_the_summed_broadcast(seed):
    """field_rows' sum and dot: the output drops the summed axis of the
    broadcast shape, and the summed axis's strides walk it."""
    for i, shapes in enumerate(_shape_pairs(100 + seed, 30)):
        shapes = shapes[:2]
        ts = [_strided(s, seed * 1000 + 10 * i + j) for j, s in enumerate(shapes)]
        full = tuple(torch.broadcast_shapes(*shapes))
        if not full:
            continue
        for axis in range(-len(full), len(full)):
            out, mshape, mst, m, axis_st = rows_cuda.reduce_geometry(
                [t.shape for t in ts], [t.stride() for t in ts], axis)
            ax = axis % len(full)
            assert out == full[:ax] + full[ax + 1:] and m == full[ax]
            for t, ms, s in zip(ts, mst, axis_st):
                whole = t.broadcast_to(full).movedim(ax, -1)
                for j in range(m):
                    sl = torch.as_strided(t, mshape, ms, t.storage_offset() + j * s)
                    assert torch.equal(sl.reshape(-1), whole[..., j].reshape(-1))


def test_ntt_and_decompose_geometry():
    """The NTT's batch axes and row stride, the one-block switch, and the
    fused contraction's operands (the launcher that took decompose7's
    place) read through strides: every [b, W, calls] x [b, calls, C] view
    is walked as itself."""
    rows = torch.zeros(B, 2, 256, dtype=torch.int64)[..., ::2]  # [b, 2, 128], row stride 2
    bshape, per = ntt_cuda.row_geometry(rows.shape[:-1], [rows.stride()] * 2)
    assert bshape == (B * 2,) and per == [(256, 2)] * 2
    assert ntt_cuda.block_geometry(128, 2) == (64, 4, 4 * 128 * 16)
    assert ntt_cuda.block_geometry(1, 1) == (1, 256, 256 * 8)
    assert ntt_cuda.block_geometry(8192, 2) is not None and ntt_cuda.block_geometry(16384, 2) is None
    assert ntt_cuda.block_geometry(16384, 1) is not None and ntt_cuda.block_geometry(32768, 1) is None
    base = torch.arange(B * 2 * 40).reshape(B, 2, 40)
    for w in (base[..., ::2], base.transpose(1, 2)[:, :20:2], base[:, :1, 3:9]):
        flat = torch.arange(B * 100).reshape(B, 100)[:, 3:]
        for X in (base[:, :, : w.shape[2]].transpose(1, 2), flat[:, : 4 * w.shape[2]].reshape(B, w.shape[2], 4)):
            _, W, calls, C, wst, xst = limb_cuda.contract_geometry(w.shape, [w.stride()] * 2, X.shape, [X.stride()] * 2)
            assert (W, calls, C) == (w.shape[1], w.shape[2], X.shape[2]) and wst[0] == wst[1]
            assert torch.equal(torch.as_strided(w, w.shape, wst[0], w.storage_offset()), w)
            assert torch.equal(torch.as_strided(X, X.shape, xst[0], X.storage_offset()), X)


# -- the CPU route, and operands on two devices ---------------------------

COUNTERS = (field_cuda.field_arith, ntt_cuda.ntt_transform, rows_cuda.field_rows, limb_cuda.limb_contract)


def _entries(tf, v, w):
    """Every entry of kernels 5-8 on the values v [b, 8] and w [b, 8]."""
    col = tuple(x[:, 0] for x in v)
    return [
        lambda: tf.add(v, w), lambda: tf.sub(v, w), lambda: tf.neg(v), lambda: tf.mul(v, w),
        lambda: tfield.fmul_pow2(tf, v, 40),
        lambda: ntt.ntt_batched(tf, v, 8), lambda: ntt.intt_batched(tf, v),
        lambda: ntt.powers(tf, col, 9), lambda: tfield.fsum(tf, v, 0), lambda: tfield.fdot(tf, v, w, -1),
        lambda: ntt.poly_eval_powers(tf, v, w),
        lambda: tfield.fpow2_weighted_sum(tf, v, 8, 1),
        lambda: limbmm.fold_contract(tf, tuple(x[:, None, :] for x in v), tuple(x[:, :, None] for x in w)),
    ]


@pytest.mark.parametrize("field", list(FIELDS))
def test_cpu_tensors_take_the_plain_route_and_count_nothing(field):
    _, tf = FIELDS[field]
    v, _ = _values(tf, (B, 8), lambda x: x, 80)
    w, _ = _values(tf, (B, 8), lambda x: x, 81)
    before = [c.launches for c in COUNTERS]
    totals = cuda_build.launch_totals()
    results = [fn() for fn in _entries(tf, v, w)]
    assert [c.launches for c in COUNTERS] == before
    assert cuda_build.launch_totals() == totals
    plain = [
        tf.add_plain(v, w), tf.sub_plain(v, w), tf.neg_plain(v), tf.mul_plain(v, w),
        tfield.fmul_pow2_plain(tf, v, 40),
        ntt._transform_plain(tf, v, 8, False), ntt._transform_plain(tf, v, 8, True),
        ntt.powers_plain(tf, tuple(x[:, 0] for x in v), 9), tfield.fsum_plain(tf, v, 0),
        tfield.fdot_plain(tf, v, w, -1), ntt.poly_eval_powers_plain(tf, v, w),
        tfield.fpow2_weighted_sum_plain(tf, v, 8, 1),
        limbmm.fold_contract_plain(tf, tuple(x[:, None, :] for x in v), tuple(x[:, :, None] for x in w)),
    ]
    assert len(results) == len(plain)
    for got, want in zip(results, plain):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("field", list(FIELDS))
def test_launchers_refuse_cpu_tensors(field):
    """The kernels' launchers take CUDA tensors only: the callers send
    CPU ones to the plain versions, so a CPU tensor that reaches a
    launcher raises, and nothing counts."""
    _, tf = FIELDS[field]
    v, _ = _values(tf, (B, 8), lambda x: x, 83)
    before = [c.launches for c in COUNTERS]
    tw = tuple(torch.zeros(7, dtype=torch.int64) for _ in range(tf.LIMBS))
    for fn in (lambda: field_cuda.elementwise("add", tf, v, v), lambda: ntt_cuda.transform(tf, v, 8, False, tw, None),
               lambda: rows_cuda.powers(tf, v, 3), lambda: rows_cuda.fsum(tf, v, 0),
               lambda: rows_cuda.fdot(tf, v, v, -1), lambda: rows_cuda.poly_eval_powers(tf, v, v),
               lambda: field_cuda.pow2_weighted_sum(tf, v, 8, 1),
               lambda: limb_cuda.fold_contract(tf, tuple(x[:, None, :] for x in v), tuple(x[:, :, None] for x in v))):
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            fn()
    assert [c.launches for c in COUNTERS] == before


@pytest.mark.parametrize("field", list(FIELDS))
def test_operands_on_two_devices_raise(field):
    """A CPU operand beside one on another device (`meta` here: the CPU
    has no card) is refused by every entry, not moved or copied."""
    _, tf = FIELDS[field]
    v, _ = _values(tf, (B, 8), lambda x: x, 82)
    w = tuple(x.to("meta") for x in v)
    entries = _entries(tf, v, w)
    for i in (0, 1, 3, 9, 10):  # add, sub, mul, fdot, poly_eval_powers
        with pytest.raises(ValueError, match="more than one device"):
            entries[i]()
    with pytest.raises(ValueError):  # fold_contract: its X alone on the other device
        entries[12]()
    mixed = (v[0], w[1]) if tf.LIMBS == 2 else None
    if mixed is not None:
        for fn in (lambda: tf.neg(mixed), lambda: ntt.intt_batched(tf, mixed), lambda: tfield.fsum(tf, mixed, 0),
                   lambda: ntt.powers(tf, mixed, 3), lambda: tfield.fpow2_weighted_sum(tf, mixed, 8, 1)):
            with pytest.raises(ValueError, match="more than one device"):
                fn()
    with pytest.raises(ValueError, match="unsupported device"):
        tf.add(w, w)
