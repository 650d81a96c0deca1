"""Exact field contractions as one batched matrix product over 7-bit limbs.

The FLP query's hot loop is a contraction over gadget calls:
wire_t[j] = sum_call w[call] * X[call, j] in Field64/Field128, per report
a [W x calls] @ [calls x chunk] product. Field elements are split into
7-bit limbs and the contraction runs as one batched product:

  a = sum_l1 A_l1 2^(7 l1),  b = sum_l2 B_l2 2^(7 l2)   (A, B < 2^7)
  sum_call a b = sum_{l1,l2} 2^(7(l1+l2)) sum_call A_l1 B_l2

Field64 uses 10 limbs (70 bits), Field128 19 (133 bits); the (l1, l2)
grid rides as extra rows and columns of one product:
[batch, W*19, calls] @ [batch, calls, 19*C].

The product runs in float64 with torch.bmm. Every limb product is
< 2^14 and every column sum is < calls * 2^14, far below 2^53, so the
float64 result is the exact integer in any summation order and the
contraction needs no segmenting. Not float32: a float32 product may run
in TF32 and is exact only up to 2^24 (the JAX package segments it at
1024 calls for that reason). torch has no batched int8 product on CUDA,
which is why this is not int8 x int8 -> int32 as on the TPU's MXU; an
int8 tensor-core kernel for it is future work.

The diagonal groups are then recombined in 64-bit limbs with full
carries and reduced mod p by the sparse-moduli folds of fields/tfield.py;
the result is the field element that fsum(mul) gives.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.tfield import _f64_reduce_wide, _f128_fold, _f128_reduce256, add_limbs, lsr

_NLIMB = {1: 10, 2: 19}  # 7-bit limbs per element, by 64-bit limb count


def decompose7(tf, v):
    """Field value (limb tuple, any shape S) -> float64 tensor
    [*S, nlimbs] of 7-bit limbs, little-endian."""
    pieces = []
    for j in range(_NLIMB[tf.LIMBS]):
        word, off = divmod(7 * j, 64)
        if word >= tf.LIMBS:
            pieces.append(torch.zeros_like(v[0]))
            continue
        piece = lsr(v[word], off)
        if off > 57 and word + 1 < tf.LIMBS:
            piece = piece | (v[word + 1] << (64 - off))
        pieces.append(piece & 0x7F)
    return torch.stack(pieces, dim=-1).to(torch.float64)


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
    fsum(tf, tf.mul(w[..., None], X[:, None]), axis=2).
    """
    nl = _NLIMB[tf.LIMBS]
    b, W, calls = w[0].shape
    C = X[0].shape[2]
    # the sum of all terms stays below 2^(64 * limbs) with room to spare
    assert calls < 1 << 30
    dl = decompose7(tf, w).permute(0, 1, 3, 2).reshape(b, W * nl, calls)
    dr = decompose7(tf, X).permute(0, 1, 3, 2).reshape(b, calls, nl * C)
    acc = torch.bmm(dl, dr).to(torch.int64).reshape(b, W, nl * nl, C)

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
