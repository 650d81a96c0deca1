// Field64 and Field128 arithmetic on native 64-bit words, for sm_90a (Hopper).
//
// Device functions shared by field_arith.cu, ntt.cu, field_rows.cu and
// limb_contract.cu. Each one is the plain version's algorithm in
// janus_tpu_torch/fields/tfield.py, step by step (the sparse-moduli folds,
// no Montgomery form), so a kernel gives the plain version's bit pattern
// for any input words, reduced or not:
//
//   Field64:  p = 2^64 - 2^32 + 1;  2^64 = 2^32 - 1, 2^96 = -1       (mod p)
//   Field128: p = 2^128 - 7*2^66 + 1;  2^128 = 7*2^66 - 1             (mod p)
//
// A Field64 element is one word, a Field128 element two (lo, hi). The
// moduli and the fold constants are not literals here: the wrapper passes
// them in a FieldConsts (janus_tpu_torch/ops/field_cuda.py, from
// Field64.MODULUS and Field128.MODULUS), by value with every launch.
//
// Operands are read through strides (a broadcast axis has stride 0) from
// the limb tensors' own storage; `Geo` carries the output shape and each
// tensor's strides, in elements, after the wrapper merged the axes it
// could.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

struct FieldConsts {
    u64 p64, eps64;          // Field64: p, 2^64 mod p
    u64 p128_lo, p128_hi;    // Field128: p
    u64 s66_lo, s66_hi;      // 7 * 2^66
    u64 s66m1_lo, s66m1_hi;  // 7 * 2^66 - 1 = 2^128 mod p
};

#define FIELD_MAX_RANK 8
#define FIELD_MAX_TENSORS 4

// The output shape and, for each input tensor (a.lo, a.hi, b.lo, b.hi),
// its stride along each output axis (0 where it broadcasts).
struct Geo {
    int rank;
    long long shape[FIELD_MAX_RANK];
    long long st[FIELD_MAX_TENSORS][FIELD_MAX_RANK];
};

// Each tensor's element offset of output element `idx` (row-major).
template <typename I, int NT>
__device__ __forceinline__ void geo_offsets(const Geo& g, I idx, long long (&off)[NT]) {
#pragma unroll
    for (int t = 0; t < NT; ++t) off[t] = 0;
    for (int d = g.rank - 1; d >= 0; --d) {
        I n = (I)g.shape[d];
        I i = idx % n;
        idx /= n;
#pragma unroll
        for (int t = 0; t < NT; ++t) off[t] += (long long)i * g.st[t][d];
    }
}

// A field element in registers (hi unused for Field64).
struct Fe {
    u64 lo, hi;
};

// ---------------------------------------------------------------------------
// u64 multiprecision primitives (tfield.py mul64wide, adc, sbb, *_limbs)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mul64wide(u64 x, u64 y, u64& lo, u64& hi) {
    lo = x * y;
    hi = __umul64hi(x, y);
}

// a + b + c, c in {0, 1}: the sum and the carry (0, 1 or 2 as in tfield's adc)
__device__ __forceinline__ u64 adc(u64 a, u64 b, u64 c, u64& carry) {
    u64 s1 = a + b;
    u64 c1 = s1 < a;
    u64 s2 = s1 + c;
    u64 c2 = s2 < s1;
    carry = c1 + c2;
    return s2;
}

// a - b - brw, brw in {0, 1}: the difference and the borrow
__device__ __forceinline__ u64 sbb(u64 a, u64 b, u64 brw, u64& borrow) {
    u64 d1 = a - b;
    u64 b1 = a < b;
    u64 d2 = d1 - brw;
    u64 b2 = d1 < brw;
    borrow = b1 + b2;
    return d2;
}

template <int N>
__device__ __forceinline__ void add_limbs(const u64 (&a)[N], const u64 (&b)[N], u64 (&out)[N]) {
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = adc(a[i], b[i], c, c);
}

template <int N>
__device__ __forceinline__ void sub_limbs(const u64 (&a)[N], const u64 (&b)[N], u64 (&out)[N]) {
    u64 brw = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = sbb(a[i], b[i], brw, brw);
}

// a (NIN limbs) << K, zero-extended, cut to NOUT limbs (tfield.shl_limbs)
template <int NIN, int K, int NOUT>
__device__ __forceinline__ void shl_limbs(const u64 (&a)[NIN], u64 (&out)[NOUT]) {
    constexpr int WORD = K / 64, BIT = K % 64;
    u64 ext[NOUT + 1];
#pragma unroll
    for (int i = 0; i < NOUT + 1; ++i) {
        int j = i - WORD;
        ext[i] = (j >= 0 && j < NIN) ? a[j] : 0ULL;
    }
#pragma unroll
    for (int i = 0; i < NOUT; ++i) {
        if (BIT == 0) {
            out[i] = ext[i];
        } else {
            u64 lo = ext[i] << BIT;
            out[i] = i > 0 ? (lo | (ext[i - 1] >> (64 - BIT))) : lo;
        }
    }
}

// ---------------------------------------------------------------------------
// Field64 (tfield.py TF64, _f64_reduce_wide)
// ---------------------------------------------------------------------------

__device__ __forceinline__ u64 f64_reduce_wide(u64 lo, u64 hi, const FieldConsts& k) {
    u64 hl = hi & 0xFFFFFFFFULL;
    u64 hh = hi >> 32;
    u64 t = (hl << 32) - hl;
    u64 s = lo + t;
    s = s < lo ? s + k.eps64 : s;
    u64 r = s - hh;
    r = s < hh ? r - k.eps64 : r;
    return r >= k.p64 ? r - k.p64 : r;
}

__device__ __forceinline__ u64 f64_add(u64 x, u64 y, const FieldConsts& k) {
    u64 s = x + y;
    s = s < x ? s + k.eps64 : s;
    return s >= k.p64 ? s - k.p64 : s;
}

__device__ __forceinline__ u64 f64_sub(u64 x, u64 y, const FieldConsts& k) {
    u64 d = x - y;
    d = x < y ? d - k.eps64 : d;
    return d >= k.p64 ? d - k.p64 : d;
}

__device__ __forceinline__ u64 f64_neg(u64 x, const FieldConsts& k) { return x == 0 ? x : k.p64 - x; }

__device__ __forceinline__ u64 f64_mul(u64 x, u64 y, const FieldConsts& k) {
    u64 lo, hi;
    mul64wide(x, y, lo, hi);
    return f64_reduce_wide(lo, hi, k);
}

__device__ __forceinline__ u64 f64_mul_pow2(u64 lo, int s, const FieldConsts& k) {
    return s == 0 ? lo : f64_reduce_wide(lo << s, lo >> (64 - s), k);
}

// ---------------------------------------------------------------------------
// Field128 (tfield.py TF128, _f128_fold, _f128_reduce256, _f128_finalize)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool ge128(u64 alo, u64 ahi, u64 blo, u64 bhi) {
    return ahi > bhi || (ahi == bhi && alo >= blo);
}

// [l0, l1, H...] -> l0 + l1 2^64 + 7H 2^66 - H over HL + 3 limbs:
// H 2^128 folded as H (7 2^66 - 1)
template <int HL>
__device__ __forceinline__ void f128_fold(const u64 (&limbs)[2 + HL], u64 (&acc)[HL + 3]) {
    u64 H[HL];
#pragma unroll
    for (int i = 0; i < HL; ++i) H[i] = limbs[2 + i];
    u64 h8[HL + 1], hz[HL + 1], h7[HL + 1];
    shl_limbs<HL, 3, HL + 1>(H, h8);
#pragma unroll
    for (int i = 0; i < HL + 1; ++i) hz[i] = i < HL ? H[i] : 0ULL;
    sub_limbs<HL + 1>(h8, hz, h7);
    u64 sh[HL + 3], lz[HL + 3], hz3[HL + 3], t[HL + 3];
    shl_limbs<HL + 1, 66, HL + 3>(h7, sh);
#pragma unroll
    for (int i = 0; i < HL + 3; ++i) {
        lz[i] = i < 2 ? limbs[i] : 0ULL;
        hz3[i] = i < HL ? H[i] : 0ULL;
    }
    add_limbs<HL + 3>(sh, lz, t);
    sub_limbs<HL + 3>(t, hz3, acc);
}

__device__ __forceinline__ Fe f128_finalize(u64 lo, u64 hi, u64 top, const FieldConsts& k) {
    u64 cc, bb;
    u64 add_lo = adc(lo, k.s66_lo, 0, cc);
    u64 add_hi = hi + k.s66_hi + cc;
    u64 d_lo = sbb(add_lo, 1, 0, bb);
    u64 d_hi = add_hi - bb;
    if (top != 0) {
        lo = d_lo;
        hi = d_hi;
    }
    bool ge = ge128(lo, hi, k.p128_lo, k.p128_hi);
    u64 s_lo = sbb(lo, k.p128_lo, 0, bb);
    u64 s_hi = hi - k.p128_hi - bb;
    return ge ? Fe{s_lo, s_hi} : Fe{lo, hi};
}

__device__ __forceinline__ Fe f128_reduce256(u64 r0, u64 r1, u64 r2, u64 r3, const FieldConsts& k) {
    const u64 in[4] = {r0, r1, r2, r3};
    u64 a5[5];
    f128_fold<2>(in, a5);
    const u64 a[4] = {a5[0], a5[1], a5[2], a5[3]};
    u64 b5[5];
    f128_fold<2>(a, b5);
    const u64 b[3] = {b5[0], b5[1], b5[2]};
    u64 c4[4];
    f128_fold<1>(b, c4);
    return f128_finalize(c4[0], c4[1], c4[2], k);
}

__device__ __forceinline__ Fe f128_add(Fe a, Fe b, const FieldConsts& k) {
    u64 c, cc, bb;
    u64 lo = adc(a.lo, b.lo, 0, c);
    u64 hi1 = a.hi + b.hi;
    bool w1 = hi1 < a.hi;
    u64 hi = hi1 + c;
    bool w2 = hi < hi1;
    if (w1 || w2) {  // bit 128 set: a + b = 2^128 + (lo, hi)
        u64 o_lo = adc(lo, k.s66m1_lo, 0, cc);
        u64 o_hi = hi + k.s66m1_hi + cc;
        lo = o_lo;
        hi = o_hi;
    }
    bool ge = ge128(lo, hi, k.p128_lo, k.p128_hi);
    u64 s_lo = sbb(lo, k.p128_lo, 0, bb);
    u64 s_hi = hi - k.p128_hi - bb;
    return ge ? Fe{s_lo, s_hi} : Fe{lo, hi};
}

__device__ __forceinline__ Fe f128_sub(Fe a, Fe b, const FieldConsts& k) {
    u64 brw, brw2, cc;
    u64 lo = sbb(a.lo, b.lo, 0, brw);
    u64 hi1 = sbb(a.hi, b.hi, brw, brw2);
    if (brw2 != 0) {  // add p back on underflow
        u64 p_lo = adc(lo, k.p128_lo, 0, cc);
        u64 p_hi = hi1 + k.p128_hi + cc;
        return Fe{p_lo, p_hi};
    }
    return Fe{lo, hi1};
}

__device__ __forceinline__ Fe f128_neg(Fe a, const FieldConsts& k) {
    if (a.lo == 0 && a.hi == 0) return a;
    u64 bb;
    u64 n_lo = sbb(k.p128_lo, a.lo, 0, bb);
    u64 n_hi = k.p128_hi - a.hi - bb;
    return Fe{n_lo, n_hi};
}

__device__ __forceinline__ Fe f128_mul(Fe a, Fe b, const FieldConsts& k) {
    u64 l00, h00, l01, h01, l10, h10, l11, h11, c1, c2, c3, c4;
    mul64wide(a.lo, b.lo, l00, h00);
    mul64wide(a.lo, b.hi, l01, h01);
    mul64wide(a.hi, b.lo, l10, h10);
    mul64wide(a.hi, b.hi, l11, h11);
    u64 r1 = adc(h00, l01, 0, c1);
    r1 = adc(r1, l10, 0, c2);
    u64 r2 = adc(h01, h10, c1, c3);
    r2 = adc(r2, l11, c2, c4);
    u64 r3 = h11 + c3 + c4;
    return f128_reduce256(l00, r1, r2, r3, k);
}

// v * 2^s for 0 <= s < 64 (tfield.fmul_pow2)
__device__ __forceinline__ Fe f128_mul_pow2(Fe v, int s, const FieldConsts& k) {
    if (s == 0) return v;
    u64 top = v.hi >> (64 - s);
    u64 nlo = v.lo << s;
    u64 nhi = (v.hi << s) | (v.lo >> (64 - s));
    if (s <= 32) {
        const u64 in[3] = {nlo, nhi, top};
        u64 c[4];
        f128_fold<1>(in, c);
        return f128_finalize(c[0], c[1], c[2], k);
    }
    return f128_reduce256(nlo, nhi, top, 0, k);
}

// ---------------------------------------------------------------------------
// The same ops over Fe, by field (LIMBS 1: Field64, 2: Field128)
// ---------------------------------------------------------------------------

template <int LIMBS>
__device__ __forceinline__ Fe fe_add(Fe a, Fe b, const FieldConsts& k) {
    if (LIMBS == 1) return Fe{f64_add(a.lo, b.lo, k), 0};
    return f128_add(a, b, k);
}

template <int LIMBS>
__device__ __forceinline__ Fe fe_sub(Fe a, Fe b, const FieldConsts& k) {
    if (LIMBS == 1) return Fe{f64_sub(a.lo, b.lo, k), 0};
    return f128_sub(a, b, k);
}

template <int LIMBS>
__device__ __forceinline__ Fe fe_neg(Fe a, const FieldConsts& k) {
    if (LIMBS == 1) return Fe{f64_neg(a.lo, k), 0};
    return f128_neg(a, k);
}

template <int LIMBS>
__device__ __forceinline__ Fe fe_mul(Fe a, Fe b, const FieldConsts& k) {
    if (LIMBS == 1) return Fe{f64_mul(a.lo, b.lo, k), 0};
    return f128_mul(a, b, k);
}

template <int LIMBS>
__device__ __forceinline__ Fe fe_mul_pow2(Fe a, int s, const FieldConsts& k) {
    if (LIMBS == 1) return Fe{f64_mul_pow2(a.lo, s, k), 0};
    return f128_mul_pow2(a, s, k);
}

template <int LIMBS>
__device__ __forceinline__ Fe fe_load(const u64* lo, const u64* hi, long long off_lo, long long off_hi) {
    return Fe{lo[off_lo], LIMBS == 2 ? hi[off_hi] : 0ULL};
}

template <int LIMBS>
__device__ __forceinline__ void fe_store(u64* lo, u64* hi, long long off, Fe v) {
    lo[off] = v.lo;
    if (LIMBS == 2) hi[off] = v.hi;
}

// x^e by square-and-multiply, as tfield.fpow_const (e = 0: one)
template <int LIMBS>
__device__ __forceinline__ Fe fe_pow(Fe x, unsigned long long e, const FieldConsts& k) {
    Fe result{1, 0};
    bool have = false;
    Fe base = x;
    while (e) {
        if (e & 1) {
            result = have ? fe_mul<LIMBS>(result, base, k) : base;
            have = true;
        }
        e >>= 1;
        if (e) base = fe_mul<LIMBS>(base, base, k);
    }
    return result;
}

// The host's copy of the consts array -> the struct passed by value
static inline FieldConsts field_consts(const unsigned long long* c) {
    FieldConsts k;
    k.p64 = c[0];
    k.eps64 = c[1];
    k.p128_lo = c[2];
    k.p128_hi = c[3];
    k.s66_lo = c[4];
    k.s66_hi = c[5];
    k.s66m1_lo = c[6];
    k.s66m1_hi = c[7];
    return k;
}

// The host's (rank, shape, strides [nt][rank]) arrays -> a Geo
static inline Geo field_geo(int rank, const long long* shape, const long long* strides, int nt) {
    Geo g;
    g.rank = rank;
    for (int d = 0; d < FIELD_MAX_RANK; ++d) {
        g.shape[d] = d < rank ? shape[d] : 1;
        for (int t = 0; t < FIELD_MAX_TENSORS; ++t) g.st[t][d] = (d < rank && t < nt) ? strides[t * rank + d] : 0;
    }
    return g;
}
