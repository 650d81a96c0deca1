"""Batched radix-2 NTT over limb-tuple field values.

The FLP evaluates and interpolates wire and gadget polynomials on
power-of-two root-of-unity domains. A transform processes an arbitrary
leading batch shape at once: values are tuples of limb tensors shaped
[..., n] and every butterfly is an elementwise field op over the whole
batch.

Structure per stage (iterative Cooley-Tukey, decimation in time, after
a bit-reversal gather):

    a.reshape(..., n // L, L) ->  u = a[..., :L/2],  v = a[..., L/2:]
    a' = concat(u + w*v, u - w*v)

Twiddle plans are cached per (field, n, direction), and their tensors
per device. The domain order matches the JAX package's ops/ntt.py.

On the card a transform is one launch of csrc/ntt.cu (ops/ntt_cuda.py),
and powers and poly_eval_powers one of csrc/field_rows.cu
(ops/rows_cuda.py); `_transform_plain`, `powers_plain` and
`poly_eval_powers_plain` are their plain versions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields.tfield import fconst, fmap, fsum_plain, i64
from . import ntt_cuda, rows_cuda
from .field_cuda import on_card


def _bitrev_perm(n: int) -> np.ndarray:
    bits = (n - 1).bit_length()
    perm = np.zeros(n, dtype=np.int64)
    for i in range(n):
        r = 0
        for b in range(bits):
            r |= ((i >> b) & 1) << (bits - 1 - b)
        perm[i] = r
    return perm


@lru_cache(maxsize=None)
def _plan(tf, n: int, inverse: bool):
    """Host-precomputed (perm, per-stage twiddles as int64 limb arrays, n_inv)."""
    F = tf.HOST
    root = F.root_of_unity(n)
    if inverse:
        root = F.inv(root)
    perm = _bitrev_perm(n)
    stages = []
    length = 2
    while length <= n:
        w_len = F.pow(root, n // length)
        tw = np.empty((tf.LIMBS, length // 2), dtype=np.int64)
        w = 1
        for k in range(length // 2):
            for li in range(tf.LIMBS):
                tw[li, k] = i64(w >> (64 * li))
            w = F.mul(w, w_len)
        stages.append(tuple(tw[li] for li in range(tf.LIMBS)))
        length <<= 1
    n_inv = F.inv(n) if inverse else None
    return perm, stages, n_inv


@lru_cache(maxsize=None)
def _plan_on(tf, n: int, inverse: bool, device: torch.device):
    perm, stages, n_inv = _plan(tf, n, inverse)
    return (
        torch.from_numpy(perm).to(device),
        [tuple(torch.from_numpy(t).to(device) for t in tw) for tw in stages],
        n_inv,
    )


@lru_cache(maxsize=None)
def _twiddles_on(tf, n: int, inverse: bool, device: torch.device):
    """The plan's stage twiddles as one table a limb, [n - 1]: stage L
    (L = 2, 4, ..., n) holds its L/2 twiddles at offset L/2 - 1 (the
    layout csrc/ntt.cu reads)."""
    _, stages, _ = _plan_on(tf, n, inverse, device)
    if not stages:
        return tuple(torch.zeros(1, dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    return tuple(torch.cat([tw[li] for tw in stages]) for li in range(tf.LIMBS))


def _transform(tf, v, n: int, inverse: bool):
    """The transform of every row of v [..., n]: one launch of
    csrc/ntt.cu on the card (ops/ntt_cuda.py), the plain version on the
    CPU."""
    if on_card("ntt_transform", v):
        device = v[0].device
        return ntt_cuda.transform(tf, v, n, inverse, _twiddles_on(tf, n, inverse, device), _plan(tf, n, inverse)[2])
    return _transform_plain(tf, v, n, inverse)


def _transform_plain(tf, v, n: int, inverse: bool):
    perm, stages, n_inv = _plan_on(tf, n, inverse, v[0].device)
    batch_shape = tuple(v[0].shape[:-1])
    a = fmap(lambda x: x.index_select(-1, perm), v)
    length = 2
    for w in stages:
        half = length // 2
        a = fmap(lambda x: x.reshape(batch_shape + (n // length, length)), a)
        u = fmap(lambda x: x[..., :half], a)
        wv = tf.mul_plain(fmap(lambda x: x[..., half:], a), w)
        a = fmap(lambda p, q: torch.cat([p, q], dim=-1), tf.add_plain(u, wv), tf.sub_plain(u, wv))
        a = fmap(lambda x: x.reshape(batch_shape + (n,)), a)
        length <<= 1
    if inverse:
        a = tf.mul_plain(a, fconst(tf, n_inv, (), v[0].device))
    return a


def ntt_batched(tf, coeffs, n: int):
    """Evaluate polynomials at the n-th roots w^0..w^{n-1}.

    coeffs: field value [..., k] with k <= n; zero-padded to n.
    """
    k = coeffs[0].shape[-1]
    assert k <= n and n & (n - 1) == 0
    if k < n:
        coeffs = fmap(lambda x: torch.nn.functional.pad(x, (0, n - k)), coeffs)
    return _transform(tf, coeffs, n, inverse=False)


def intt_batched(tf, evals):
    """Inverse: values at w^0..w^{n-1} -> coefficients. Last axis = n."""
    n = evals[0].shape[-1]
    assert n & (n - 1) == 0
    return _transform(tf, evals, n, inverse=True)


def lagrange_eval_weights(tf, t_powers, m: int):
    """L_k(t) for the m-point root-of-unity domain {a^0..a^{m-1}}.

    L_k(t) = (1/m) * sum_i a^{-ki} t^i: the inverse NTT of t's power
    vector [t^0..t^{m-1}], with no per-element inversion.

    t_powers: field value [..., >=m] of powers of t. Returns [..., m].
    """
    return intt_batched(tf, fmap(lambda x: x[..., :m], t_powers))


def powers(tf, x, n: int):
    """[x^0, x^1, ..., x^{n-1}] along a new trailing axis: one launch of
    csrc/field_rows.cu on the card (ops/rows_cuda.py).

    x: field value of shape [...]; returns [..., n].
    """
    return rows_cuda.powers(tf, x, n) if on_card("powers", x) else powers_plain(tf, x, n)


def powers_plain(tf, x, n: int):
    """The plain version of powers, log-depth."""
    assert n >= 1
    one = fconst(tf, 1, tuple(x[0].shape), x[0].device)
    acc = fmap(lambda a, b: torch.stack([a, b], dim=-1), one, x)  # [..., 2]
    cur = 2
    while cur < n:
        # acc holds x^0..x^{cur-1}; extend with acc * x^cur
        xc = tf.mul_plain(fmap(lambda a: a[..., -1], acc), x)  # x^cur
        ext = tf.mul_plain(acc, fmap(lambda a: a[..., None], xc))
        acc = fmap(lambda a, b: torch.cat([a, b], dim=-1), acc, ext)
        cur *= 2
    if cur != n:
        acc = fmap(lambda a: a[..., :n], acc)
    return acc


def poly_eval_powers(tf, coeffs, pw):
    """Evaluate polynomials given precomputed point powers: one fused
    launch of csrc/field_rows.cu on the card (ops/rows_cuda.py).

    coeffs: [..., k]; pw: [..., m] powers of the evaluation point with
    m >= k. Returns [...]: sum_i coeffs[i] * x^i.
    """
    if on_card("poly_eval_powers", (*coeffs, *pw)):
        return rows_cuda.poly_eval_powers(tf, coeffs, pw)
    return poly_eval_powers_plain(tf, coeffs, pw)


def poly_eval_powers_plain(tf, coeffs, pw):
    """The plain version of poly_eval_powers."""
    k = coeffs[0].shape[-1]
    return fsum_plain(tf, tf.mul_plain(coeffs, fmap(lambda a: a[..., :k], pw)), axis=-1)
