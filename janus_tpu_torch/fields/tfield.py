"""Batched field arithmetic in PyTorch over 64-bit limb tensors.

A field-vector value is a tuple of tensors (the limbs), all with the
same shape: Field64 values are 1-tuples, Field128 values are 2-tuples
(lo, hi). Structural helpers map over the limb tuple, so the NTT and FLP
code is generic over the field. This is the layout of the JAX package,
so its public functions and these take and return like with like.

Every limb is a `torch.int64` holding the bit pattern of an unsigned
64-bit word. PyTorch on the CPU does not implement `+`, `>>` or `<` for
`torch.uint64`, and int64 gives what is needed:

  - `+`, `-` and `*` wrap mod 2^64, which is unsigned arithmetic;
  - a logical right shift is `(x >> k) & (2^(64-k) - 1)` (`lsr`);
  - an unsigned compare flips the sign bit first (`ult`);
  - a constant >= 2^63 enters as its two's-complement int64 (`i64`).

Reduction exploits the sparse moduli (no Montgomery form):
  Field64:  2^64 = 2^32 - 1,  2^96 = -1          (mod p)
  Field128: 2^128 = 7*2^66 - 1                   (mod p)

On the card the field ops are kernels: TF64/TF128's add, sub, neg and
mul, fmul_pow2 and fpow2_weighted_sum are one launch of
csrc/field_arith.cu each (ops/field_cuda.py), fsum and fdot one of
csrc/field_rows.cu (ops/rows_cuda.py). The eager bodies here
(`add_plain`, ..., `fmul_pow2_plain`, `fpow2_weighted_sum_plain`,
`fsum_plain`, `fdot_plain`) are their plain versions,
which CPU tensors run: each op sends its operands by their device
(`_on_card`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import field_cuda as _field_cuda
from ..ops import rows_cuda as _rows_cuda
from .field import Field64, Field128

I64 = torch.int64


def _on_card(what: str, *values) -> bool:
    """True where the values' limbs lie on one CUDA device (the kernel's
    route), False on the CPU (the plain version's); raises ValueError for
    limbs on two devices."""
    return _field_cuda.on_card(what, [t for v in values for t in v])
MASK64 = (1 << 64) - 1
MIN64 = -(1 << 63)
M32 = 0xFFFFFFFF


def i64(x: int) -> int:
    """The int64 value with the bit pattern of x mod 2^64."""
    x &= MASK64
    return x - (1 << 64) if x >> 63 else x


def lsr(x, k: int):
    """Logical right shift of int64 bit patterns by 0 <= k < 64."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def _flip(x):
    return x ^ MIN64 if isinstance(x, torch.Tensor) else i64(x) ^ MIN64


def ult(a, b):
    """Unsigned a < b on int64 bit patterns (either side may be an int)."""
    return _flip(a) < _flip(b)


def uge(a, b):
    return _flip(a) >= _flip(b)


def ugt(a, b):
    return _flip(a) > _flip(b)


# ---------------------------------------------------------------------------
# u64 multiprecision primitives (all elementwise)
# ---------------------------------------------------------------------------


def mul64wide(x, y):
    """Full 64x64 -> 128-bit product as (lo, hi) limb tensors."""
    xl = x & M32
    xh = lsr(x, 32)
    yl = y & M32
    yh = lsr(y, 32)
    ll = xl * yl
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = lh + lsr(ll, 32)  # cannot wrap: <= (2^32-1)^2 + 2^32-1 < 2^64
    mid2 = mid + hl
    carry = ult(mid2, mid).to(I64)
    lo = (ll & M32) | (mid2 << 32)
    hi = hh + lsr(mid2, 32) + (carry << 32)
    return lo, hi


def adc(a, b, c=0):
    """a + b + c with c in {0,1}; returns (sum, carry in {0,1})."""
    s1 = a + b
    c1 = ult(s1, a).to(I64)
    if isinstance(c, int) and c == 0:
        return s1, c1
    s2 = s1 + c
    c2 = ult(s2, s1).to(I64)
    return s2, c1 + c2


def sbb(a, b, brw=0):
    """a - b - brw with brw in {0,1}; returns (diff, borrow in {0,1})."""
    d1 = a - b
    b1 = ult(a, b).to(I64)
    if isinstance(brw, int) and brw == 0:
        return d1, b1
    d2 = d1 - brw
    b2 = ult(d1, brw).to(I64)
    return d2, b1 + b2


def add_limbs(a, b):
    """Add equal-length limb lists; returns (limbs, carry_out)."""
    out = []
    c = 0
    for x, y in zip(a, b):
        s, c = adc(x, y, c)
        out.append(s)
    return out, c


def sub_limbs(a, b):
    """Subtract equal-length limb lists; returns (limbs, borrow_out)."""
    out = []
    brw = 0
    for x, y in zip(a, b):
        d, brw = sbb(x, y, brw)
        out.append(d)
    return out, brw


def shl_limbs(a, k: int, out_len: int):
    """Shift limb list left by k bits (k < 64*out_len), zero-extended."""
    word = k // 64
    bit = k % 64
    zero = torch.zeros_like(a[0])
    ext = [zero] * word + list(a)
    ext += [zero] * (out_len + 1 - len(ext))
    if bit == 0:
        return ext[:out_len]
    out = []
    for i in range(out_len):
        lo = ext[i] << bit
        out.append(lo | lsr(ext[i - 1], 64 - bit) if i > 0 else lo)
    return out


# ---------------------------------------------------------------------------
# Field64 (Goldilocks)
# ---------------------------------------------------------------------------

_P64 = i64(Field64.MODULUS)
_EPS64 = 2**32 - 1  # 2^64 mod p


def _f64_reduce_wide(lo, hi):
    """Reduce a 128-bit value (lo, hi) mod p64. Uses 2^96 = -1, 2^64 = 2^32-1."""
    hl = hi & M32
    hh = lsr(hi, 32)
    # x = lo + hl*(2^32-1) - hh  (mod p)
    t = (hl << 32) - hl
    s = lo + t
    s = torch.where(ult(s, lo), s + _EPS64, s)
    r = s - hh
    r = torch.where(ult(s, hh), r - _EPS64, r)
    return torch.where(uge(r, _P64), r - _P64, r)


def _ints_to_limbs(tf, arr, device) -> tuple:
    """Host ints (an integer numpy array, or objects holding Python
    ints) < p -> limb tensors on `device`."""
    a = np.asarray(arr)
    if a.dtype.kind in "ui":
        ok = (a >= 0).all() and (tf.LIMBS > 1 or (a.astype(np.uint64) < np.uint64(tf.MODULUS)).all())
        words = [a.astype(np.uint64)] + [np.zeros(a.shape, np.uint64)] * (tf.LIMBS - 1)
    else:
        ints = np.vectorize(int, otypes=[object])(a) if a.size else a.astype(object)
        ok = not ints.size or ((ints >= 0) & (ints < tf.MODULUS)).all()
        words = [((ints >> (64 * i)) & MASK64).astype(np.uint64) for i in range(tf.LIMBS)] if ok else []
    if not ok:
        raise ValueError(f"field elements must lie in [0, {tf.MODULUS})")
    return tuple(torch.from_numpy(np.ascontiguousarray(w).view(np.int64)).to(device) for w in words)


def _limbs_to_ints(v) -> np.ndarray:
    acc = None
    for i, x in enumerate(v):
        part = x.detach().cpu().numpy().view(np.uint64).astype(object) << (64 * i)
        acc = part if acc is None else acc + part
    return acc


class TF64:
    """Batched Field64 ops. Values are 1-tuples of int64 limb tensors, reduced."""

    HOST = Field64
    LIMBS = 1
    MODULUS = Field64.MODULUS

    @staticmethod
    def add(a, b):
        return _field_cuda.elementwise("add", TF64, a, b) if _on_card("add", a, b) else TF64.add_plain(a, b)

    @staticmethod
    def add_plain(a, b):
        (x,), (y,) = a, b
        s = x + y
        s = torch.where(ult(s, x), s + _EPS64, s)
        return (torch.where(uge(s, _P64), s - _P64, s),)

    @staticmethod
    def sub(a, b):
        return _field_cuda.elementwise("sub", TF64, a, b) if _on_card("sub", a, b) else TF64.sub_plain(a, b)

    @staticmethod
    def sub_plain(a, b):
        (x,), (y,) = a, b
        d = x - y
        d = torch.where(ult(x, y), d - _EPS64, d)
        return (torch.where(uge(d, _P64), d - _P64, d),)

    @staticmethod
    def neg(a):
        return _field_cuda.elementwise("neg", TF64, a) if _on_card("neg", a) else TF64.neg_plain(a)

    @staticmethod
    def neg_plain(a):
        (x,) = a
        return (torch.where(x == 0, x, _P64 - x),)

    @staticmethod
    def mul(a, b):
        return _field_cuda.elementwise("mul", TF64, a, b) if _on_card("mul", a, b) else TF64.mul_plain(a, b)

    @staticmethod
    def mul_plain(a, b):
        (x,), (y,) = a, b
        return (_f64_reduce_wide(*mul64wide(x, y)),)

    @classmethod
    def from_ints(cls, arr, device) -> tuple:
        return _ints_to_limbs(cls, arr, device)

    @staticmethod
    def to_ints(v) -> np.ndarray:
        return _limbs_to_ints(v)


# ---------------------------------------------------------------------------
# Field128
# ---------------------------------------------------------------------------

_P128_LO = i64(Field128.MODULUS)
_P128_HI = i64(Field128.MODULUS >> 64)
_SEVEN66_LO = i64(7 * 2**66)
_SEVEN66_HI = i64((7 * 2**66) >> 64)
_SEVEN66M1_LO = i64(7 * 2**66 - 1)
_SEVEN66M1_HI = i64((7 * 2**66 - 1) >> 64)


def _ge128(alo, ahi, blo, bhi):
    return ugt(ahi, bhi) | ((ahi == bhi) & uge(alo, blo))


def _f128_fold(limbs, hi_len: int):
    """Given a value as limb list [l0, l1, h...], fold H*2^128 = H*(7*2^66 - 1).

    limbs: list of 2 + hi_len limb tensors. Returns a longer limb list
    whose known-zero top limbs the caller trims.
    """
    L = limbs[:2]
    H = limbs[2 : 2 + hi_len]
    zero = torch.zeros_like(H[0])
    # 7H = (H << 3) - H, over hi_len+1 limbs
    h8 = shl_limbs(H, 3, hi_len + 1)
    h7, _ = sub_limbs(h8, H + [zero])
    # (7H) << 66 positioned at its limb offset; value = L + 7H<<66 - H
    sh = shl_limbs(h7, 66, hi_len + 3)
    acc, _ = add_limbs(sh, L + [zero] * (hi_len + 1))
    acc, _ = sub_limbs(acc, H + [zero] * 3)
    return acc


def _f128_reduce256(r0, r1, r2, r3):
    """Reduce a 256-bit value to a Field128 element (lo, hi)."""
    # fold 1: H = (r2, r3) < 2^128 -> result < 2^198 (4 limbs, top <= 2^6)
    a = _f128_fold([r0, r1, r2, r3], 2)[:4]
    # fold 2: H = (a2, a3) < 2^70 -> result < 2^140 (3 limbs)
    b = _f128_fold(a, 2)[:3]
    # fold 3: H = b2 < 2^12 -> result < 2^128 + 2^82 (3 limbs, top in {0,1})
    c = _f128_fold([b[0], b[1], b[2]], 1)[:3]
    return _f128_finalize(*c)


def _f128_finalize(lo, hi, top):
    """Canonicalize a (lo, hi, top) value < 2^128 + eps with top in {0,1}."""
    # if the top bit is set: value - p = value - 2^128 + 7*2^66 - 1
    add_lo, cc = adc(lo, _SEVEN66_LO)
    add_hi = hi + _SEVEN66_HI + cc  # value - 2^128 < 2^82: stays tiny
    d_lo, bb = sbb(add_lo, 1)
    d_hi = add_hi - bb
    one = top != 0
    lo = torch.where(one, d_lo, lo)
    hi = torch.where(one, d_hi, hi)
    # final conditional subtract (at most once)
    ge = _ge128(lo, hi, _P128_LO, _P128_HI)
    s_lo, bb = sbb(lo, _P128_LO)
    s_hi = hi - _P128_HI - bb
    return torch.where(ge, s_lo, lo), torch.where(ge, s_hi, hi)


class TF128:
    """Batched Field128 ops. Values are (lo, hi) tuples of int64 limb tensors."""

    HOST = Field128
    LIMBS = 2
    MODULUS = Field128.MODULUS

    @staticmethod
    def add(a, b):
        return _field_cuda.elementwise("add", TF128, a, b) if _on_card("add", a, b) else TF128.add_plain(a, b)

    @staticmethod
    def add_plain(a, b):
        (alo, ahi), (blo, bhi) = a, b
        lo, c = adc(alo, blo)
        hi1 = ahi + bhi
        w1 = ult(hi1, ahi)
        hi = hi1 + c
        w2 = ult(hi, hi1)
        overflow = w1 | w2  # bit 128 set: a+b = 2^128 + (lo, hi)
        # subtract p on overflow or >= p; with overflow, 2^128 - p = 7*2^66 - 1
        o_lo, cc = adc(lo, _SEVEN66M1_LO)
        o_hi = hi + _SEVEN66M1_HI + cc
        lo = torch.where(overflow, o_lo, lo)
        hi = torch.where(overflow, o_hi, hi)
        ge = _ge128(lo, hi, _P128_LO, _P128_HI)
        s_lo, bb = sbb(lo, _P128_LO)
        s_hi = hi - _P128_HI - bb
        return (torch.where(ge, s_lo, lo), torch.where(ge, s_hi, hi))

    @staticmethod
    def sub(a, b):
        return _field_cuda.elementwise("sub", TF128, a, b) if _on_card("sub", a, b) else TF128.sub_plain(a, b)

    @staticmethod
    def sub_plain(a, b):
        (alo, ahi), (blo, bhi) = a, b
        lo, brw = sbb(alo, blo)
        hi1, brw2 = sbb(ahi, bhi, brw)
        underflow = brw2 != 0
        # add p back on underflow
        p_lo, cc = adc(lo, _P128_LO)
        p_hi = hi1 + _P128_HI + cc
        return (torch.where(underflow, p_lo, lo), torch.where(underflow, p_hi, hi1))

    @staticmethod
    def neg(a):
        return _field_cuda.elementwise("neg", TF128, a) if _on_card("neg", a) else TF128.neg_plain(a)

    @staticmethod
    def neg_plain(a):
        (lo, hi) = a
        z = (lo == 0) & (hi == 0)
        n_lo, bb = sbb(torch.full_like(lo, _P128_LO), lo)
        n_hi = _P128_HI - hi - bb
        return (torch.where(z, lo, n_lo), torch.where(z, hi, n_hi))

    @staticmethod
    def mul(a, b):
        return _field_cuda.elementwise("mul", TF128, a, b) if _on_card("mul", a, b) else TF128.mul_plain(a, b)

    @staticmethod
    def mul_plain(a, b):
        (a0, a1), (b0, b1) = a, b
        l00, h00 = mul64wide(a0, b0)
        l01, h01 = mul64wide(a0, b1)
        l10, h10 = mul64wide(a1, b0)
        l11, h11 = mul64wide(a1, b1)
        r1, c1 = adc(h00, l01)
        r1, c2 = adc(r1, l10)
        r2, c3 = adc(h01, h10, c1)
        r2, c4 = adc(r2, l11, c2)
        r3 = h11 + c3 + c4
        return _f128_reduce256(l00, r1, r2, r3)

    @classmethod
    def from_ints(cls, arr, device) -> tuple:
        return _ints_to_limbs(cls, arr, device)

    @staticmethod
    def to_ints(v) -> np.ndarray:
        return _limbs_to_ints(v)


# ---------------------------------------------------------------------------
# Generic helpers over limb tuples (field-agnostic)
# ---------------------------------------------------------------------------


def fmul_pow2(tf, v, k: int):
    """v * 2^k mod p for a static 0 <= k < 64: shifts and sparse-moduli
    folds instead of a generic multiply by the constant (one launch of
    csrc/field_arith.cu on the card; v itself for k = 0)."""
    assert 0 <= k < 64, k
    if k == 0:
        return v
    return _field_cuda.elementwise("mul_pow2", tf, v, k=k) if _on_card("fmul_pow2", v) else fmul_pow2_plain(tf, v, k)


def fmul_pow2_plain(tf, v, k: int):
    """The plain version of fmul_pow2 (0 < k < 64)."""
    if tf.LIMBS == 1:
        (lo,) = v
        return (_f64_reduce_wide(lo << k, lsr(lo, 64 - k)),)
    lo, hi = v
    top = lsr(hi, 64 - k)  # < 2^k
    nlo = lo << k
    nhi = (hi << k) | lsr(lo, 64 - k)
    if k <= 32:
        # fold top*2^128 once: result < 2^128 + 7*2^(66+k) < 2^129
        c = _f128_fold([nlo, nhi, top], 1)[:3]
        return _f128_finalize(*c)
    # k up to 63: 7*top*2^66 can reach 2^133 — full 256-bit reduction
    return _f128_reduce256(nlo, nhi, top, torch.zeros_like(top))


def fpow2_weighted_sum(tf, v, bits: int, axis: int = 1):
    """sum_{b < bits} 2^b * v[..., b, ...] along `axis` (1 <= bits <= 64):
    the truncation's weighted sum of bits, one launch of
    csrc/field_arith.cu on the card (ops/field_cuda.py pow2_weighted_sum)."""
    if _on_card("fpow2_weighted_sum", v):
        return _field_cuda.pow2_weighted_sum(tf, v, bits, axis)
    return fpow2_weighted_sum_plain(tf, v, bits, axis)


def fpow2_weighted_sum_plain(tf, v, bits: int, axis: int = 1):
    """The plain version of fpow2_weighted_sum: bits - 1 shift-based
    constant multiplies (fmul_pow2_plain) and as many adds."""
    acc = fmap(lambda x: x.select(axis, 0), v)
    for b in range(1, bits):
        acc = tf.add_plain(acc, fmul_pow2_plain(tf, fmap(lambda x: x.select(axis, b), v), b))
    return acc


def fmap(fn, *vals):
    """Apply a tensor fn limb-wise over field values."""
    return tuple(fn(*limbs) for limbs in zip(*vals))


def fzeros(tf, shape, device):
    return tuple(torch.zeros(shape, dtype=I64, device=device) for _ in range(tf.LIMBS))


# --- tile-shaped structural ops: the streamed query's vocabulary (the JAX
# package's jfield.py fslice_dyn, ftile, fput_tile, fpad_axis). The JAX
# versions are dynamic slices inside a scan; here the step is a Python
# int, so a tile is a narrow view and writing one is an in-place copy.


def fslice_dyn(v, start: int, size: int, axis: int = 1):
    """Elements [start, start + size) of a field value along `axis` (views)."""
    return tuple(x.narrow(axis, start, size) for x in v)


def ftile(v, step: int, tile: int, axis: int = 1):
    """Tile `step` (0-based) of width `tile` along `axis` (views)."""
    return fslice_dyn(v, step * tile, tile, axis=axis)


def fput_tile(dst, src, step: int, axis: int = 1):
    """Write `src` as tile `step` of `dst` along `axis`, in place (the
    inverse of ftile; the tile width is src's extent along `axis`).
    Returns dst."""
    width = src[0].shape[axis]
    for x, u in zip(dst, src):
        x.narrow(axis, step * width, width).copy_(u)
    return dst


def fpad_axis(v, pad: int, axis: int = 1):
    """Zero-pad a field value at the end of `axis` (no copy for pad=0)."""
    if pad == 0:
        return v
    axis = axis % v[0].ndim
    widths = [0, 0] * (v[0].ndim - 1 - axis) + [0, pad]
    return tuple(torch.nn.functional.pad(x, widths) for x in v)


def freshape(v, shape):
    """Reshape every limb to `shape` (-1 for the inferred axis)."""
    return tuple(x.reshape(shape) for x in v)


def fencode_lanes(v):
    """Field value [batch, n] -> its little-endian encoding as lanes
    [batch, n * limbs] (each element's limbs lo..hi in lane order, as
    Field.encode_vec)."""
    if len(v) == 1:
        return v[0]
    return torch.stack(v, dim=-1).reshape(v[0].shape[0], -1)


def fshape(v):
    return tuple(v[0].shape)


def fwhere(mask, a, b):
    """Select field values by boolean mask (broadcast against element shape)."""
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def fconst(tf, value: int, shape, device):
    """Broadcast a host int constant to a field value of given shape."""
    value %= tf.MODULUS
    return tuple(
        torch.full(shape, i64(value >> (64 * i)), dtype=I64, device=device)
        for i in range(tf.LIMBS)
    )


def fpow_const(tf, x, e: int):
    """x^e for a host-known exponent by square-and-multiply."""
    result = None
    base = x
    while e:
        if e & 1:
            result = base if result is None else tf.mul(result, base)
        e >>= 1
        if e:
            base = tf.mul(base, base)
    if result is None:
        return fconst(tf, 1, fshape(x), x[0].device)
    return result


def finv(tf, x):
    return fpow_const(tf, x, tf.MODULUS - 2)


def fsum(tf, v, axis: int):
    """Sum a field value along an axis (one launch of csrc/field_rows.cu
    on the card)."""
    return _rows_cuda.fsum(tf, v, axis) if _on_card("fsum", v) else fsum_plain(tf, v, axis)


def fsum_plain(tf, v, axis: int):
    """Sum a field value along an axis by log-depth halving (mod-add tree)."""
    axis = axis % v[0].ndim
    n = v[0].shape[axis]
    if n == 0:
        shape = list(v[0].shape)
        del shape[axis]
        return fzeros(tf, tuple(shape), v[0].device)
    # pad to a power of two with zeros, then halve
    m = 1 << (n - 1).bit_length()
    if m != n:
        pad_shape = list(v[0].shape)
        pad_shape[axis] = m - n
        v = fmap(lambda x: torch.cat([x, x.new_zeros(pad_shape)], dim=axis), v)
    while m > 1:
        half = m // 2
        v = tf.add_plain(fmap(lambda x: x.narrow(axis, 0, half), v), fmap(lambda x: x.narrow(axis, half, half), v))
        m = half
    return fmap(lambda x: x.squeeze(axis), v)


def fdot(tf, a, b, axis=-1):
    """Inner product along an axis (one fused launch of csrc/field_rows.cu
    on the card)."""
    return _rows_cuda.fdot(tf, a, b, axis) if _on_card("fdot", a, b) else fdot_plain(tf, a, b, axis)


def fdot_plain(tf, a, b, axis=-1):
    """The plain version of fdot."""
    return fsum_plain(tf, tf.mul_plain(a, b), axis=axis)


def is_zero(v):
    m = v[0] == 0
    for x in v[1:]:
        m = m & (x == 0)
    return m
