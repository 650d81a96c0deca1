// Elementwise Field64 / Field128 arithmetic, one launch an op, for sm_90a (Hopper).
//
// Replaces the elementwise field ops that XLA fuses into janus_tpu's jitted
// step (not Pallas kernels): janus_tpu/fields/jfield.py JF64 (:170; add
// :178, sub :186, neg :194, mul :199), JF128 (:277; add :285, sub :306,
// neg :317, mul :325) and fmul_pow2 (:359). In the port each of those was
// 26 to 589 eager int64 PyTorch ops (tfield.py), so a SumVec step launched
// tens of thousands of tiny kernels; here an op is one launch.
//
//   out = a + b, a - b, -a, a * b or a * 2^k   (mod p), elementwise
//
// a and b are limb tensors (1 word a Field64 element, 2 a Field128 one) of
// any shapes that broadcast, each limb read through its own strides
// (stride 0 on a broadcast axis): the step passes strided slices, [b, n]
// against [b, 1], NTT-stage views against twiddle rows and 0-d constants.
// The result is a new contiguous tensor of the broadcast shape.
//
// Bound on the H100: bytes for add, sub, neg and mul_pow2 (16-48 B moved
// against 10-60 integer instructions an element); a Field128 mul is about
// 150 32-bit instructions (four 64x64 products, three folds) against 48 B,
// near the balance of 16.7 Tops/s and 3.35 TB/s. The design: one thread an
// output element, the index split into each tensor's offset by the merged
// axes the wrapper passes (1-3 after merging, for the step's operands),
// 32-bit index arithmetic where the element count allows.
//
// A second entry fuses the truncation's chain, janus_tpu/vdaf/engine.py:374
// `_pow2_weighted_sum` (fmul_pow2 and add, bits - 1 of each, which XLA
// fuses into one loop; the port ran 2 (bits - 1) launches of the above):
//
//   out[...] = sum_{i < m} 2^i v[..., i, ...]   (mod p), m <= 64
//
// A block stages 128 outputs' inputs in shared memory, 16 of each at a
// time, the warps reading along the summed axis (contiguous at every step
// layout, so a warp reads 256 contiguous bytes a limb); then a thread an
// output shifts its inputs into an unreduced sum (Field128 below 2^197 in
// four 64-bit words, Field64 below 2^133 in three) and reduces once with
// field_ops.cuh; no intermediate is written. Bound on the H100: bytes (the
// step's [1024, 16, 1000] view of the bits, 262 MB in and 16 MB out,
// 0.0831 ms), against ~10 instructions an input and one reduction an
// output.
//
// Plain C interface, loaded with ctypes: a launch returns its CUDA error
// (0 on success).

#include "field_ops.cuh"

enum { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2, OP_MUL = 3, OP_MUL_POW2 = 4 };

template <typename I, int LIMBS, int OP>
__global__ void __launch_bounds__(256) field_arith_kernel(Geo g, FieldConsts k, int s, const u64* __restrict__ a0,
                                                          const u64* __restrict__ a1, const u64* __restrict__ b0,
                                                          const u64* __restrict__ b1, u64* __restrict__ o0,
                                                          u64* __restrict__ o1, I n) {
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += (I)gridDim.x * blockDim.x) {
        long long off[4];
        geo_offsets<I, 4>(g, idx, off);
        Fe a = fe_load<LIMBS>(a0, a1, off[0], off[1]);
        Fe r;
        if (OP == OP_NEG) {
            r = fe_neg<LIMBS>(a, k);
        } else if (OP == OP_MUL_POW2) {
            r = fe_mul_pow2<LIMBS>(a, s, k);
        } else {
            Fe b = fe_load<LIMBS>(b0, b1, off[2], off[3]);
            if (OP == OP_ADD) r = fe_add<LIMBS>(a, b, k);
            else if (OP == OP_SUB) r = fe_sub<LIMBS>(a, b, k);
            else r = fe_mul<LIMBS>(a, b, k);
        }
        fe_store<LIMBS>(o0, o1, (long long)idx, r);
    }
}

template <typename I, int LIMBS>
static cudaError_t launch_op(int op, int blocks, cudaStream_t st, const Geo& g, const FieldConsts& k, int s,
                             const u64* a0, const u64* a1, const u64* b0, const u64* b1, u64* o0, u64* o1, I n) {
    switch (op) {
        case OP_ADD:
            field_arith_kernel<I, LIMBS, OP_ADD><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_SUB:
            field_arith_kernel<I, LIMBS, OP_SUB><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_NEG:
            field_arith_kernel<I, LIMBS, OP_NEG><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_MUL:
            field_arith_kernel<I, LIMBS, OP_MUL><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_MUL_POW2:
            field_arith_kernel<I, LIMBS, OP_MUL_POW2><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// op: OP_*; limbs: 1 or 2; s: the power of two of OP_MUL_POW2; rank <= 8;
// shape[rank]; strides[4][rank] in elements (a.lo, a.hi, b.lo, b.hi; the
// missing ones 0); consts[8] (FieldConsts); n = prod(shape) > 0.
extern "C" int field_arith_launch(int op, int limbs, int s, int rank, const long long* shape, const long long* strides,
                                  const unsigned long long* consts, const void* a0, const void* a1, const void* b0,
                                  const void* b1, void* o0, void* o1, long long n, void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || n <= 0 || (limbs != 1 && limbs != 2)) return (int)cudaErrorInvalidValue;
    Geo g = field_geo(rank, shape, strides, 4);
    FieldConsts k = field_consts(consts);
    cudaStream_t st = (cudaStream_t)stream;
    long long want = (n + 255) / 256;
    int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
    const u64 *pa0 = (const u64*)a0, *pa1 = (const u64*)a1, *pb0 = (const u64*)b0, *pb1 = (const u64*)b1;
    u64 *po0 = (u64*)o0, *po1 = (u64*)o1;
    cudaError_t err;
    if (n < (1LL << 31)) {
        unsigned int n32 = (unsigned int)n;
        err = limbs == 1 ? launch_op<unsigned int, 1>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n32)
                         : launch_op<unsigned int, 2>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n32);
    } else {
        unsigned long long n64 = (unsigned long long)n;
        err = limbs == 1 ? launch_op<unsigned long long, 1>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n64)
                         : launch_op<unsigned long long, 2>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n64);
    }
    return (int)err;
}

// out[e] = sum_{i < m} 2^i v[off(e) + i * ax]  (mod p). A block takes
// P2_T consecutive outputs and stages their inputs in shared memory, P2_CH
// of each output's at a time: thread q loads input q % P2_CH of output
// q / P2_CH, so where the summed axis is contiguous and the outputs'
// inputs follow one another (every step layout) a warp reads 256
// contiguous bytes a limb; then each thread adds up its own output's.
#define P2_T 128
#define P2_CH 16

template <int LIMBS>
__global__ void __launch_bounds__(P2_T) pow2_sum_kernel(Geo g, FieldConsts k, int m, long long ax0, long long ax1,
                                                        const u64* __restrict__ v0, const u64* __restrict__ v1,
                                                        u64* __restrict__ o0, u64* __restrict__ o1, long long n) {
    __shared__ u64 sv[LIMBS][P2_T * (P2_CH + 1)];  // a row an output, padded against bank conflicts
    __shared__ long long sbase[2][P2_T];
    const int tid = threadIdx.x;
    for (long long e0 = (long long)blockIdx.x * P2_T; e0 < n; e0 += (long long)gridDim.x * P2_T) {
        const long long e = e0 + tid;
        const int cnt = n - e0 < P2_T ? (int)(n - e0) : P2_T;
        if (tid < cnt) {
            long long off[2];
            geo_offsets<unsigned long long, 2>(g, (unsigned long long)e, off);
            sbase[0][tid] = off[0];
            sbase[1][tid] = off[1];
        }
        u64 a[4] = {0, 0, 0, 0};  // the unreduced sum: Field128 < 2^197, Field64 < 2^133 (a[3] 0)
        for (int i0 = 0; i0 < m; i0 += P2_CH) {
            const int ch = m - i0 < P2_CH ? m - i0 : P2_CH;
            __syncthreads();  // the offsets are in; the last chunk's inputs are read
            // every load in flight before the first store (each thread P2_CH inputs a limb)
            u64 lv[P2_CH], hv[P2_CH];
#pragma unroll
            for (int j = 0; j < P2_CH; ++j) {
                const int q = tid + j * P2_T, el = q / P2_CH, i = q % P2_CH;
                const bool in = el < cnt && i < ch;
                lv[j] = in ? v0[sbase[0][el] + (i0 + i) * ax0] : 0ULL;
                hv[j] = (LIMBS == 2 && in) ? v1[sbase[1][el] + (i0 + i) * ax1] : 0ULL;
            }
#pragma unroll
            for (int j = 0; j < P2_CH; ++j) {
                const int q = tid + j * P2_T, el = q / P2_CH, i = q % P2_CH;
                if (el < cnt && i < ch) {
                    sv[0][el * (P2_CH + 1) + i] = lv[j];
                    if (LIMBS == 2) sv[LIMBS - 1][el * (P2_CH + 1) + i] = hv[j];
                }
            }
            __syncthreads();
            if (tid < cnt) {
                for (int i = 0; i < ch; ++i) {
                    const int s = i0 + i;  // (hi, lo) << s over three words
                    const u64 lo = sv[0][tid * (P2_CH + 1) + i];
                    const u64 hi = LIMBS == 2 ? sv[LIMBS - 1][tid * (P2_CH + 1) + i] : 0ULL;
                    const u64 s0 = lo << s;
                    const u64 s1 = s ? (hi << s) | (lo >> (64 - s)) : hi;
                    const u64 s2 = s ? hi >> (64 - s) : 0ULL;
                    u64 c;
                    a[0] = adc(a[0], s0, 0, c);
                    a[1] = adc(a[1], s1, c, c);
                    a[2] = adc(a[2], s2, c, c);
                    a[3] += c;
                }
            }
        }
        if (tid < cnt) {
            if (LIMBS == 1) {
                o0[e] = f64_reduce_wide(a[0], f64_reduce_wide(a[1], a[2], k), k);
            } else {
                Fe r = f128_reduce256(a[0], a[1], a[2], a[3], k);
                o0[e] = r.lo;
                o1[e] = r.hi;
            }
        }
        __syncthreads();  // this tile's offsets are read before the next tile writes them
    }
}

// limbs: 1 or 2; rank <= 8, shape[rank]: the output's merged axes;
// strides[2][rank]: each limb's strides along them; m (1..64) inputs an
// output along the summed axis, ax[2] each limb's stride along it;
// n = prod(shape) > 0
extern "C" int pow2_sum_launch(int limbs, int rank, const long long* shape, const long long* strides,
                               const unsigned long long* consts, int m, const long long* ax, const void* v0,
                               const void* v1, void* o0, void* o1, long long n, void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || n <= 0 || m < 1 || m > 64 || (limbs != 1 && limbs != 2))
        return (int)cudaErrorInvalidValue;
    Geo g = field_geo(rank, shape, strides, 2);
    FieldConsts k = field_consts(consts);
    cudaStream_t st = (cudaStream_t)stream;
    long long want = (n + P2_T - 1) / P2_T;
    int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
    const u64 *pv0 = (const u64*)v0, *pv1 = (const u64*)v1;
    u64 *po0 = (u64*)o0, *po1 = (u64*)o1;
    if (limbs == 1) pow2_sum_kernel<1><<<blocks, P2_T, 0, st>>>(g, k, m, ax[0], 0, pv0, pv1, po0, po1, n);
    else pow2_sum_kernel<2><<<blocks, P2_T, 0, st>>>(g, k, m, ax[0], ax[1], pv0, pv1, po0, po1, n);
    return (int)cudaGetLastError();
}
