"""Exact field contractions over limbs: the plain version as one batched float64 product of 7-bit limbs.

The FLP query's hot loop is a contraction over gadget calls:
wire_t[j] = sum_call w[call] * X[call, j] in Field64/Field128, per report
a [W x calls] @ [calls x chunk] product. Field elements are split into
limbs and the contraction runs as one matrix product:

  a = sum_l1 A_l1 2^(k l1),  b = sum_l2 B_l2 2^(k l2)   (A, B < 2^k)
  sum_call a b = sum_{l1,l2} 2^(k(l1+l2)) sum_call A_l1 B_l2

On the card `fold_contract` is one launch of csrc/limb_contract.cu
(ops/limb_cuda.py `fold_contract`): byte limbs (k = 8) on the int8
tensor cores, the limbs only in shared memory and registers, the
diagonal groups carried and reduced in the same kernel.

CPU tensors take the plain version, `fold_contract_plain`: 7-bit limbs
(k = 7; Field64 10 limbs, 70 bits; Field128 19, 133 bits) as in the JAX
package, the (l1, l2) grid riding as extra rows and columns of one
[batch, W*19, calls] @ [batch, calls, 19*C] torch.bmm in float64
(`decompose7_plain` twice), then `recombine_plain`. Every limb product
is < 2^14 and every column sum is < calls * 2^14, far below 2^53, so the
float64 result is the exact integer in any summation order and needs no
segmenting. The diagonal groups are recombined in 64-bit limbs with full
carries and reduced mod p by the sparse-moduli folds of
fields/tfield.py: the field element that fsum(mul) gives, which the
kernel gives too, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.tfield import _f64_reduce_wide, _f128_fold, _f128_reduce256, add_limbs, lsr
from . import limb_cuda
from .field_cuda import on_card

NLIMB = {1: 10, 2: 19}  # the plain version's 7-bit limbs an element, by 64-bit limb count


def decompose7_plain(tf, v, dim: int):
    """Field value (limb tuple, any shape S) -> float64 tensor of its
    7-bit limbs, little-endian, on a new axis of nlimbs at `dim`.

    Each limb is written straight into the one float64 result, so a
    call holds that result and one int64 limb at a time: 19 x 8 bytes a
    Field128 element (10 x 8 a Field64 one), plus a few int64 element
    temporaries (vdaf/feasibility.py counts both)."""
    nl = NLIMB[tf.LIMBS]
    shape = list(v[0].shape)
    dim = dim % (len(shape) + 1)
    shape.insert(dim, nl)
    out = torch.empty(shape, dtype=torch.float64, device=v[0].device)
    for j in range(nl):
        dst = out.select(dim, j)
        word, off = divmod(7 * j, 64)
        if word >= tf.LIMBS:
            dst.zero_()
            continue
        piece = lsr(v[word], off)
        if off > 57 and word + 1 < tf.LIMBS:
            piece = piece | (v[word + 1] << (64 - off))
        dst.copy_(piece & 0x7F)
    return out


def _reduce_limbs(tf, limbs):
    """64-bit limb list (value < 2^292 for Field128, 2^166 for Field64) -> field."""
    if tf.LIMBS == 1:
        l0, l1, l2 = limbs
        return (_f64_reduce_wide(l0, _f64_reduce_wide(l1, l2)),)
    # one fold (H = limbs[2:5] < 2^164) lands under 2^234, then the
    # 256-bit reduction
    r = _f128_fold(list(limbs), 3)[:4]
    return _f128_reduce256(*r)


def fold_contract(tf, w, X):
    """Exact field contraction: out[b, i, c] = sum_p w[b, i, p] * X[b, p, c].

    w: field value [batch, W, calls] (weight rows; W small).
    X: field value [batch, calls, C].
    Returns a reduced field value [batch, W, C], equal to
    fsum(tf, tf.mul(w[..., None], X[:, None]), axis=2): one launch of
    csrc/limb_contract.cu on the card (ops/limb_cuda.py), the plain
    version on the CPU.
    """
    if on_card("fold_contract", list(w) + list(X)):
        return limb_cuda.fold_contract(tf, w, X)
    return fold_contract_plain(tf, w, X)


def fold_contract_plain(tf, w, X):
    """The plain version of fold_contract: decompose7_plain twice, the
    float64 product, recombine_plain."""
    nl = NLIMB[tf.LIMBS]
    b, W, calls = w[0].shape
    C = X[0].shape[2]
    # the sum of all terms stays below 2^(64 * limbs) with room to spare
    assert calls < 1 << 30
    # limbs laid out as the product wants them: rows (w, l1), columns (l2, c)
    dl = decompose7_plain(tf, w, dim=2).reshape(b, W * nl, calls)
    dr = decompose7_plain(tf, X, dim=2).reshape(b, calls, nl * C)
    return recombine_plain(tf, torch.bmm(dl, dr), W, C)


def recombine_plain(tf, acc, W: int, C: int):
    """The product's exact column sums acc [b, W * nl, nl * C] (rows
    (w, l1), columns (l2, c)) -> the reduced field value [b, W, C]."""
    nl = NLIMB[tf.LIMBS]
    b = acc.shape[0]
    acc = acc.to(torch.int64).reshape(b, W, nl * nl, C)

    # diagonal groups: value = sum_s 2^(7s) colsum[s], s = l1 + l2
    n_s = 2 * nl - 1
    s_idx = torch.from_numpy(np.add.outer(np.arange(nl), np.arange(nl)).reshape(-1)).to(acc.device)
    grouped = acc.new_zeros((b, W, n_s, C)).index_add_(2, s_idx, acc)

    # 64-bit limbs with carries: colsum s lands at bit 7s and straddles
    # at most two limbs
    n_limbs = 5 if tf.LIMBS == 2 else 3
    limbs = [acc.new_zeros((b, W, C)) for _ in range(n_limbs)]
    zero = limbs[0]
    for s in range(n_s):
        col = grouped[:, :, s, :]
        word, off = divmod(7 * s, 64)
        add = [zero] * n_limbs
        add[word] = col << off
        if off > 0 and word + 1 < n_limbs:
            add[word + 1] = lsr(col, 64 - off)
        limbs, _ = add_limbs(limbs, add)
    return _reduce_limbs(tf, limbs)
