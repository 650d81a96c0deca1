// The limb contraction's two field-side halves, for sm_90a (Hopper): 7-bit decomposition and recombination.
//
// Replaces janus_tpu/ops/limbmm.py:64 `decompose7` and the recombination
// of :95 `fold_contract` (the diagonal groups, the carries and :83
// `_reduce_limbs`), which XLA compiles into janus_tpu's jitted step
// around the MXU's product: not Pallas kernels. The port ran them as
// eager int64 PyTorch (a shift, an or and a mask a limb; 37 grouped
// column adds with carries; three folds).
//
//   decompose: out[..., j, ...] = (v >> 7j) & 0x7F as float64, j < nl
//              (nl = 10 limbs a Field64 element, 19 a Field128 one),
//              the new axis at `dim`, contiguous
//   recombine: acc = [b, W nl, nl C], torch.bmm's exact float64 product of
//              the two decompositions (rows (w, l1), columns (l2, c));
//              out[b, w, c] = sum_{l1, l2} 2^(7 (l1 + l2))
//              acc[b, w nl + l1, l2 C + c]  (mod p)
//
// as the plain versions (ops/limb_cuda.py): the column sums of one
// diagonal s = l1 + l2 in 64-bit integers, each put at bit 7s into 5 (3)
// 64-bit limbs with full carries, then folded and reduced by field_ops.cuh
// (the plain _reduce_limbs), so results are bit-identical.
//
// Bound on the H100: bytes. decompose writes 8 B a limb (152 B a Field128
// element) against ~4 instructions a limb; recombine reads nl^2 = 361
// float64 (2,888 B) an output element against ~800 instructions. Design:
// one thread an element; decompose reads its element through strides and
// writes limb j at j * inner, so a warp's stores are contiguous; recombine
// runs along c, so a warp reads 32 neighbouring columns of each of the
// 361 rows. The product between them stays torch.bmm in float64 (exact:
// every column sum is below 2^53), as janus_tpu leaves its product to XLA.
//
// Plain C interface, loaded with ctypes: a launch returns its CUDA error
// (0 on success).

#include "field_ops.cuh"

template <int LIMBS>
__global__ void decompose7_kernel(Geo g, int nl, long long inner, const u64* __restrict__ v0,
                                  const u64* __restrict__ v1, double* __restrict__ out, long long total) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        long long off[2];
        geo_offsets<unsigned long long, 2>(g, (unsigned long long)e, off);
        const u64 w[2] = {v0[off[0]], LIMBS == 2 ? v1[off[1]] : 0ULL};
        const long long outer = e / inner;
        const long long in = e - outer * inner;
        double* dst = out + outer * nl * inner + in;
        for (int j = 0; j < nl; ++j) {
            const int word = (7 * j) / 64, bit = (7 * j) % 64;
            u64 piece = 0;
            if (word < LIMBS) {
                piece = w[word] >> bit;
                if (bit > 57 && word + 1 < LIMBS) piece |= w[word + 1] << (64 - bit);
                piece &= 0x7F;
            }
            dst[(long long)j * inner] = (double)piece;
        }
    }
}

template <int LIMBS>
__global__ void recombine_kernel(FieldConsts k, const double* __restrict__ acc, long long W, long long C,
                                 u64* __restrict__ o0, u64* __restrict__ o1, long long total) {
    constexpr int NL = LIMBS == 2 ? 19 : 10;
    constexpr int NS = 2 * NL - 1;
    constexpr int NW = LIMBS == 2 ? 5 : 3;
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const long long c = e % C;
        const long long bw = e / C;  // b * W + w
        // rows bw * NL + l1 of the [b * W * NL, NL * C] product
        const double* base = acc + bw * NL * (NL * C) + c;
        u64 col[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) col[s] = 0;
#pragma unroll
        for (int l1 = 0; l1 < NL; ++l1) {
#pragma unroll
            for (int l2 = 0; l2 < NL; ++l2)
                col[l1 + l2] += (u64)(long long)base[((long long)l1 * NL + l2) * C];
        }
        u64 limbs[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) limbs[i] = 0;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int word = (7 * s) / 64, bit = (7 * s) % 64;
            u64 add[NW];
#pragma unroll
            for (int i = 0; i < NW; ++i) add[i] = 0;
            add[word] = col[s] << bit;
            if (bit > 0 && word + 1 < NW) add[word + 1] = col[s] >> (64 - bit);
            u64 next[NW];
            add_limbs<NW>(limbs, add, next);
#pragma unroll
            for (int i = 0; i < NW; ++i) limbs[i] = next[i];
        }
        if (LIMBS == 1) {
            o0[e] = f64_reduce_wide(limbs[0], f64_reduce_wide(limbs[1], limbs[2], k), k);
        } else {
            const u64 in5[5] = {limbs[0], limbs[1], limbs[2], limbs[3], limbs[4]};
            u64 r[6];
            f128_fold<3>(in5, r);
            Fe x = f128_reduce256(r[0], r[1], r[2], r[3], k);
            o0[e] = x.lo;
            o1[e] = x.hi;
        }
    }
}

static int grid_for(long long total, int threads) {
    long long want = (total + threads - 1) / threads;
    return (int)(want < 132LL * 64 ? want : 132LL * 64);
}

// v: rank axes shape[rank], strides[2][rank]; out: float64, the limb axis
// of nl inserted before the last `inner` elements of each element's index
extern "C" int decompose7_launch(int limbs, int rank, const long long* shape, const long long* strides, int nl,
                                 long long inner, const void* v0, const void* v1, void* out, long long total,
                                 void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || total <= 0 || inner <= 0 || (limbs != 1 && limbs != 2))
        return (int)cudaErrorInvalidValue;
    Geo g = field_geo(rank, shape, strides, 2);
    cudaStream_t st = (cudaStream_t)stream;
    if (limbs == 1)
        decompose7_kernel<1><<<grid_for(total, 256), 256, 0, st>>>(g, nl, inner, (const u64*)v0, (const u64*)v1,
                                                                   (double*)out, total);
    else
        decompose7_kernel<2><<<grid_for(total, 256), 256, 0, st>>>(g, nl, inner, (const u64*)v0, (const u64*)v1,
                                                                   (double*)out, total);
    return (int)cudaGetLastError();
}

// acc: contiguous float64 [b, W * nl, nl * C]; out: [b, W, C] limbs
extern "C" int recombine_launch(int limbs, const unsigned long long* consts, const void* acc, long long W,
                                long long C, void* o0, void* o1, long long total, void* stream) {
    if (total <= 0 || W <= 0 || C <= 0 || (limbs != 1 && limbs != 2)) return (int)cudaErrorInvalidValue;
    FieldConsts k = field_consts(consts);
    cudaStream_t st = (cudaStream_t)stream;
    if (limbs == 1)
        recombine_kernel<1><<<grid_for(total, 128), 128, 0, st>>>(k, (const double*)acc, W, C, (u64*)o0,
                                                                  (u64*)o1, total);
    else
        recombine_kernel<2><<<grid_for(total, 128), 128, 0, st>>>(k, (const double*)acc, W, C, (u64*)o0,
                                                                  (u64*)o1, total);
    return (int)cudaGetLastError();
}
