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
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields.tfield import fconst, fmap, fsum, i64


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


def _transform(tf, v, n: int, inverse: bool):
    perm, stages, n_inv = _plan_on(tf, n, inverse, v[0].device)
    batch_shape = tuple(v[0].shape[:-1])
    a = fmap(lambda x: x.index_select(-1, perm), v)
    length = 2
    for w in stages:
        half = length // 2
        a = fmap(lambda x: x.reshape(batch_shape + (n // length, length)), a)
        u = fmap(lambda x: x[..., :half], a)
        wv = tf.mul(fmap(lambda x: x[..., half:], a), w)
        a = fmap(lambda p, q: torch.cat([p, q], dim=-1), tf.add(u, wv), tf.sub(u, wv))
        a = fmap(lambda x: x.reshape(batch_shape + (n,)), a)
        length <<= 1
    if inverse:
        a = tf.mul(a, fconst(tf, n_inv, (), v[0].device))
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
    """[x^0, x^1, ..., x^{n-1}] along a new trailing axis, log-depth.

    x: field value of shape [...]; returns [..., n].
    """
    assert n >= 1
    one = fconst(tf, 1, tuple(x[0].shape), x[0].device)
    acc = fmap(lambda a, b: torch.stack([a, b], dim=-1), one, x)  # [..., 2]
    cur = 2
    while cur < n:
        # acc holds x^0..x^{cur-1}; extend with acc * x^cur
        xc = tf.mul(fmap(lambda a: a[..., -1], acc), x)  # x^cur
        ext = tf.mul(acc, fmap(lambda a: a[..., None], xc))
        acc = fmap(lambda a, b: torch.cat([a, b], dim=-1), acc, ext)
        cur *= 2
    if cur != n:
        acc = fmap(lambda a: a[..., :n], acc)
    return acc


def poly_eval_powers(tf, coeffs, pw):
    """Evaluate polynomials given precomputed point powers.

    coeffs: [..., k]; pw: [..., m] powers of the evaluation point with
    m >= k. Returns [...]: sum_i coeffs[i] * x^i.
    """
    k = coeffs[0].shape[-1]
    return fsum(tf, tf.mul(coeffs, fmap(lambda a: a[..., :k], pw)), axis=-1)
