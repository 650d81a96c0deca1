"""janus_tpu_torch fields, NTT and limb contraction held against janus_tpu.

Same inputs (made with numpy from a seed) go through the JAX package's
functions and the port's, on the CPU; the tolerance is exact equality,
because everything is integer field arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from janus_tpu.fields import jfield as jf_mod
from janus_tpu.fields.jfield import JF64, JF128
from janus_tpu.ops import limbmm as j_limbmm
from janus_tpu.ops import ntt as j_ntt
from janus_tpu_torch.fields import tfield
from janus_tpu_torch.fields.tfield import TF64, TF128
from janus_tpu_torch.ops import limbmm as t_limbmm
from janus_tpu_torch.ops import ntt as t_ntt

CPU = torch.device("cpu")
PAIRS = [(JF64, TF64), (JF128, TF128)]
IDS = ["Field64", "Field128"]


def edge_values(p: int) -> list[int]:
    vals = [0, 1, 2, p - 1, p - 2, 2**63 - 1, 2**63, 2**63 + 1, 2**32 - 1, 2**32, 2**64 - 1]
    if p > 2**64:
        vals += [2**64, 2**64 + 1, 2**127, p - 2**64, p - 2**66]
    return [v for v in vals if v < p]


def fuzz_ints(p: int, n: int, seed: int) -> np.ndarray:
    """n field elements: the edge values, then uniform draws from the seed."""
    rng = np.random.default_rng(seed)
    edges = edge_values(p)
    words = rng.integers(0, 2**63, size=(n, 4), dtype=np.uint64).astype(object)
    rand = [int(sum(int(w) << (63 * k) for k, w in enumerate(row)) % p) for row in words]
    return np.array((edges + rand)[:n], dtype=object)


def jax_value(jf, ints):
    return jf.from_ints(ints)


def port_value(tf, ints):
    return tf.from_ints(ints, CPU)


def ints_of(f, v):
    return [int(x) for x in np.asarray(f.to_ints(v)).reshape(-1)]


@pytest.mark.parametrize("jf,tf", PAIRS, ids=IDS)
def test_field_ops_match_jax_and_host(jf, tf):
    p = tf.MODULUS
    n = 64
    a = fuzz_ints(p, n, 1)
    b = np.array(list(fuzz_ints(p, n, 2)[::-1]), dtype=object)
    # every edge value meets every edge value
    e = edge_values(p)
    a = np.concatenate([a, np.array([x for x in e for _ in e], dtype=object)])
    b = np.concatenate([b, np.array([y for _ in e for y in e], dtype=object)])
    ja, jb = jax_value(jf, a), jax_value(jf, b)
    ta, tb = port_value(tf, a), port_value(tf, b)
    for op, host in (
        ("add", lambda x, y: (x + y) % p),
        ("sub", lambda x, y: (x - y) % p),
        ("mul", lambda x, y: (x * y) % p),
    ):
        got = ints_of(tf, getattr(tf, op)(ta, tb))
        assert got == ints_of(jf, getattr(jf, op)(ja, jb)), op
        assert got == [host(int(x), int(y)) for x, y in zip(a, b)], op
    got = ints_of(tf, tf.neg(ta))
    assert got == ints_of(jf, jf.neg(ja))
    assert got == [(-int(x)) % p for x in a]


@pytest.mark.parametrize("jf,tf", PAIRS, ids=IDS)
def test_inv_and_pow_match_jax(jf, tf):
    p = tf.MODULUS
    a = fuzz_ints(p, 12, 3)
    a = np.array([x for x in a if x != 0], dtype=object)
    got = ints_of(tf, tfield.finv(tf, port_value(tf, a)))
    assert got == [pow(int(x), p - 2, p) for x in a]
    got_pow = ints_of(tf, tfield.fpow_const(tf, port_value(tf, a), 37))
    assert got_pow == ints_of(jf, jf_mod.fpow_const(jf, jax_value(jf, a), 37))
    assert got_pow == [pow(int(x), 37, p) for x in a]


def test_mul64wide_matches_jax():
    rng = np.random.default_rng(4)
    edges = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 1], dtype=np.uint64)
    x = np.concatenate([np.repeat(edges, edges.size), rng.integers(0, 2**64 - 1, size=200, dtype=np.uint64, endpoint=True)])
    y = np.concatenate([np.tile(edges, edges.size), rng.integers(0, 2**64 - 1, size=200, dtype=np.uint64, endpoint=True)])
    jlo, jhi = jf_mod.mul64wide(jnp.asarray(x), jnp.asarray(y))
    tlo, thi = tfield.mul64wide(torch.from_numpy(x.view(np.int64)), torch.from_numpy(y.view(np.int64)))
    assert (tlo.numpy().view(np.uint64) == np.asarray(jlo)).all()
    assert (thi.numpy().view(np.uint64) == np.asarray(jhi)).all()
    want = [int(a) * int(b) for a, b in zip(x, y)]
    got = [int(lo) | (int(hi) << 64) for lo, hi in zip(tlo.numpy().view(np.uint64), thi.numpy().view(np.uint64))]
    assert got == want


@pytest.mark.parametrize("jf,tf", PAIRS, ids=IDS)
def test_structural_helpers_match_jax(jf, tf):
    p = tf.MODULUS
    a = fuzz_ints(p, 3 * 13, 5).reshape(3, 13)
    b = fuzz_ints(p, 3 * 13, 6).reshape(3, 13)
    ta, tb = port_value(tf, a), port_value(tf, b)
    ja, jb = jax_value(jf, a), jax_value(jf, b)
    for axis in (0, 1):
        assert ints_of(tf, tfield.fsum(tf, ta, axis)) == ints_of(jf, jf_mod.fsum(jf, ja, axis))
    assert ints_of(tf, tfield.fdot(tf, ta, tb)) == ints_of(jf, jf_mod.fdot(jf, ja, jb))
    for k in (1, 5, 31, 32, 33, 63):
        assert ints_of(tf, tfield.fmul_pow2(tf, ta, k)) == ints_of(jf, jf_mod.fmul_pow2(jf, ja, k)), k
    mask = np.arange(13) % 3 == 0
    got = tfield.fwhere(torch.from_numpy(mask), ta, tb)
    assert ints_of(tf, got) == ints_of(jf, jf_mod.fwhere(jnp.asarray(mask), ja, jb))
    assert ints_of(tf, tfield.fconst(tf, p + 5, (2,), CPU)) == [5, 5]
    z = port_value(tf, np.array([0, 1, p - 1], dtype=object))
    assert tfield.is_zero(z).tolist() == [True, False, False]


@pytest.mark.parametrize("jf,tf", PAIRS, ids=IDS)
@pytest.mark.parametrize("n", [8, 32])
def test_ntt_intt_lagrange_match_jax(jf, tf, n):
    p = tf.MODULUS
    k = n - 3
    c = fuzz_ints(p, 2 * k, 7 + n).reshape(2, k)
    tc, jc = port_value(tf, c), jax_value(jf, c)
    evals = t_ntt.ntt_batched(tf, tc, n)
    assert ints_of(tf, evals) == ints_of(jf, j_ntt.ntt_batched(jf, jc, n))
    back = t_ntt.intt_batched(tf, evals)
    assert ints_of(tf, back) == ints_of(jf, j_ntt.intt_batched(jf, j_ntt.ntt_batched(jf, jc, n)))
    rows = ints_of(tf, back)
    assert [rows[i * n : i * n + k] for i in range(2)] == [[int(x) for x in row] for row in c]
    assert all(v == 0 for i in range(2) for v in rows[i * n + k : (i + 1) * n])
    t = fuzz_ints(p, 2, 9 + n)
    pw_t = t_ntt.powers(tf, port_value(tf, t), n + 5)
    pw_j = j_ntt.powers(jf, jax_value(jf, t), n + 5)
    assert ints_of(tf, pw_t) == ints_of(jf, pw_j)
    assert ints_of(tf, t_ntt.lagrange_eval_weights(tf, pw_t, n)) == ints_of(
        jf, j_ntt.lagrange_eval_weights(jf, pw_j, n)
    )
    assert ints_of(tf, t_ntt.poly_eval_powers(tf, tc, pw_t)) == ints_of(jf, j_ntt.poly_eval_powers(jf, jc, pw_j))


@pytest.mark.parametrize("jf,tf", PAIRS, ids=IDS)
@pytest.mark.parametrize("calls", [1, 9])
def test_fold_contract_matches_jax_and_definition(jf, tf, calls):
    p = tf.MODULUS
    b, W, C = 2, 2, 5
    w = fuzz_ints(p, b * W * calls, 11 + calls).reshape(b, W, calls)
    X = fuzz_ints(p, b * calls * C, 12 + calls).reshape(b, calls, C)
    tw, tX = port_value(tf, w), port_value(tf, X)
    got = ints_of(tf, t_limbmm.fold_contract(tf, tw, tX))
    assert got == ints_of(jf, j_limbmm.fold_contract(jf, jax_value(jf, w), jax_value(jf, X)))
    definition = tfield.fsum(
        tf, tf.mul(tfield.fmap(lambda x: x[..., None], tw), tfield.fmap(lambda x: x[:, None], tX)), axis=2
    )
    assert got == ints_of(tf, definition)


@pytest.mark.parametrize("jf,tf", PAIRS, ids=IDS)
def test_from_ints_round_trips_and_rejects_out_of_range(jf, tf):
    p = tf.MODULUS
    ints = fuzz_ints(p, 20, 13)
    assert ints_of(tf, port_value(tf, ints)) == [int(x) for x in ints]
    assert ints_of(tf, port_value(tf, np.array([3, 2**63], dtype=np.uint64))) == [3, 2**63]
    for bad in ([p], [-1], [p + 2**70]):
        with pytest.raises(ValueError):
            tf.from_ints(np.array(bad, dtype=object), CPU)
    if tf.LIMBS == 1:
        with pytest.raises(ValueError):
            tf.from_ints(np.array([2**64 - 1], dtype=np.uint64), CPU)
