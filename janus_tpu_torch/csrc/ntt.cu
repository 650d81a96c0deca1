// Batched radix-2 NTT / inverse NTT over Field64 or Field128 rows, for sm_90a (Hopper).
//
// Replaces janus_tpu/ops/ntt.py:80 `_transform` (ntt_batched :108,
// intt_batched :121, lagrange_eval_weights :128), which XLA compiles into
// janus_tpu's jitted step (its stages split by anti_recompute_barrier,
// jfield.py:43): not a Pallas kernel. The port ran it as eager PyTorch, a
// bit-reversal gather and log2(n) stages of field mul, add, sub and cat:
// 3,995 ops for one n = 64 transform.
//
//   out[r, :] = NTT_n(in[r, :])            (forward)
//   out[r, :] = n^-1 NTT_n^-1(in[r, :])    (inverse)
//
// for every row r of the leading batch, iterative Cooley-Tukey by
// decimation in time after a bit-reversal gather, as the plain version
// (ops/ntt.py _transform_plain): stage L (L = 2, 4, ..., n) turns u = a[i],
// v = a[i + L/2] into u + w v, u - w v with w the stage's twiddle k, read
// from the plan's twiddle table (every stage's L/2 twiddles, stage L at
// offset L/2 - 1). The field ops are field_ops.cuh's, the plain version's
// algorithm, so rows are bit-identical to it.
//
// Bound on the H100: operations. A Field128 row of n = 128 is 448
// butterflies (a mul, an add and a sub each, ~200 32-bit instructions)
// against 4 KB moved. Design: where a row fits one block's shared memory
// (n words a limb; the wrapper takes this route up to 128 KB a row, Field128
// n <= 8,192 and Field64 n <= 16,384), one launch does the whole transform:
// a block holds one or more rows in shared memory, gathers each in
// bit-reversed order straight from the input's strides (no copy, no perm
// tensor), runs every stage between __syncthreads, and writes the row
// (scaled by n^-1 for the inverse) contiguous. Longer rows take one launch
// for the gather and one a stage, on the same arithmetic, the inverse's
// scale fused into the last stage.
//
// Plain C interface, loaded with ctypes: each launch returns its CUDA error
// (0 on success).

#include "field_ops.cuh"

// Row r's offsets in the input (lo, hi limb) from the batch axes of g
// (g.rank batch axes; strides of the lo and hi limb in st[0], st[1]).
__device__ __forceinline__ void row_offsets(const Geo& g, long long r, long long& off0, long long& off1) {
    long long o[2];
    geo_offsets<unsigned long long, 2>(g, (unsigned long long)r, o);
    off0 = o[0];
    off1 = o[1];
}

__device__ __forceinline__ unsigned int bitrev(unsigned int j, int log2n) {
    return log2n ? __brev(j) >> (32 - log2n) : 0u;
}

// One block: R rows of n elements, tpr threads a row. Shared memory holds
// the rows' limbs [R][LIMBS][n].
template <int LIMBS>
__global__ void ntt_rows_kernel(Geo g, FieldConsts k, int log2n, int tpr, int inverse, long long last0,
                                long long last1, const u64* __restrict__ in0, const u64* __restrict__ in1,
                                const u64* __restrict__ tw0, const u64* __restrict__ tw1, u64 ninv0, u64 ninv1,
                                u64* __restrict__ out0, u64* __restrict__ out1, long long rows) {
    extern __shared__ u64 sm[];
    const int n = 1 << log2n;
    const int half_n = n >> 1;
    const int rpb = blockDim.x / tpr;
    const int rl = threadIdx.x / tpr;
    const int t = threadIdx.x % tpr;
    const long long row = (long long)blockIdx.x * rpb + rl;
    const bool active = row < rows;
    u64* s0 = sm + (size_t)rl * LIMBS * n;
    u64* s1 = s0 + n;
    if (active) {
        long long off0, off1;
        row_offsets(g, row, off0, off1);
        for (int j = t; j < n; j += tpr) {
            unsigned int rj = bitrev((unsigned int)j, log2n);
            s0[rj] = in0[off0 + (long long)j * last0];
            if (LIMBS == 2) s1[rj] = in1[off1 + (long long)j * last1];
        }
    }
    __syncthreads();
    for (int lg = 1; lg <= log2n; ++lg) {
        const int half = 1 << (lg - 1);
        if (active) {
            for (int j = t; j < half_n; j += tpr) {
                const int kk = j & (half - 1);
                const int i0 = ((j >> (lg - 1)) << lg) + kk;
                const int i1 = i0 + half;
                Fe u{s0[i0], LIMBS == 2 ? s1[i0] : 0ULL};
                Fe v{s0[i1], LIMBS == 2 ? s1[i1] : 0ULL};
                Fe w{tw0[half - 1 + kk], LIMBS == 2 ? tw1[half - 1 + kk] : 0ULL};
                Fe wv = fe_mul<LIMBS>(v, w, k);
                Fe x = fe_add<LIMBS>(u, wv, k);
                Fe y = fe_sub<LIMBS>(u, wv, k);
                s0[i0] = x.lo;
                s0[i1] = y.lo;
                if (LIMBS == 2) {
                    s1[i0] = x.hi;
                    s1[i1] = y.hi;
                }
            }
        }
        __syncthreads();
    }
    if (active) {
        const Fe ninv{ninv0, ninv1};
        u64* d0 = out0 + row * n;
        u64* d1 = LIMBS == 2 ? out1 + row * n : nullptr;
        for (int j = t; j < n; j += tpr) {
            Fe x{s0[j], LIMBS == 2 ? s1[j] : 0ULL};
            if (inverse) x = fe_mul<LIMBS>(x, ninv, k);
            d0[j] = x.lo;
            if (LIMBS == 2) d1[j] = x.hi;
        }
    }
}

// Long rows, launch 1: out[r, bitrev(j)] = in[r, j] (thread an element)
template <int LIMBS>
__global__ void ntt_gather_kernel(Geo g, int log2n, long long last0, long long last1, const u64* __restrict__ in0,
                                  const u64* __restrict__ in1, u64* __restrict__ out0, u64* __restrict__ out1,
                                  long long total) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const long long row = e >> log2n;
        const unsigned int j = (unsigned int)(e & ((1LL << log2n) - 1));
        long long off0, off1;
        row_offsets(g, row, off0, off1);
        const long long dst = (row << log2n) + bitrev(j, log2n);
        out0[dst] = in0[off0 + (long long)j * last0];
        if (LIMBS == 2) out1[dst] = in1[off1 + (long long)j * last1];
    }
}

// Long rows, one launch a stage lg, in place on out (thread a butterfly);
// the inverse's last stage also scales by n^-1
template <int LIMBS>
__global__ void ntt_stage_kernel(FieldConsts k, int log2n, int lg, int scale, const u64* __restrict__ tw0,
                                 const u64* __restrict__ tw1, u64 ninv0, u64 ninv1, u64* out0, u64* out1,
                                 long long total) {
    const long long half = 1LL << (lg - 1);
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const long long row = e >> (log2n - 1);
        const long long j = e & ((1LL << (log2n - 1)) - 1);
        const long long kk = j & (half - 1);
        const long long i0 = (row << log2n) + ((j >> (lg - 1)) << lg) + kk;
        const long long i1 = i0 + half;
        Fe u{out0[i0], LIMBS == 2 ? out1[i0] : 0ULL};
        Fe v{out0[i1], LIMBS == 2 ? out1[i1] : 0ULL};
        Fe w{tw0[half - 1 + kk], LIMBS == 2 ? tw1[half - 1 + kk] : 0ULL};
        Fe wv = fe_mul<LIMBS>(v, w, k);
        Fe x = fe_add<LIMBS>(u, wv, k);
        Fe y = fe_sub<LIMBS>(u, wv, k);
        if (scale) {
            const Fe ninv{ninv0, ninv1};
            x = fe_mul<LIMBS>(x, ninv, k);
            y = fe_mul<LIMBS>(y, ninv, k);
        }
        out0[i0] = x.lo;
        out0[i1] = y.lo;
        if (LIMBS == 2) {
            out1[i0] = x.hi;
            out1[i1] = y.hi;
        }
    }
}

static int grid_for(long long total, int threads) {
    long long want = (total + threads - 1) / threads;
    return (int)(want < 132LL * 64 ? want : 132LL * 64);
}

// The whole transform in one launch. rank batch axes with shape[rank];
// strides[2][rank + 1]: each limb's batch strides, then its stride along
// the row; tw: the concatenated stage twiddles (n - 1 a limb); rows > 0;
// rows_per_block x tpr threads a block, smem_bytes of shared memory.
extern "C" int ntt_rows_launch(int limbs, int log2n, int inverse, int rank, const long long* shape,
                               const long long* strides, const unsigned long long* consts, const void* in0,
                               const void* in1, const void* tw0, const void* tw1, unsigned long long ninv0,
                               unsigned long long ninv1, void* out0, void* out1, long long rows, int rows_per_block,
                               int tpr, int smem_bytes, void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || rows <= 0 || (limbs != 1 && limbs != 2)) return (int)cudaErrorInvalidValue;
    long long bst[2 * FIELD_MAX_RANK];
    for (int t = 0; t < 2; ++t)
        for (int d = 0; d < rank; ++d) bst[t * rank + d] = strides[t * (rank + 1) + d];
    Geo g = field_geo(rank, shape, bst, 2);
    long long last0 = strides[rank], last1 = strides[2 * rank + 1];
    FieldConsts k = field_consts(consts);
    cudaStream_t st = (cudaStream_t)stream;
    long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    int threads = rows_per_block * tpr;
    cudaError_t err;
    if (limbs == 1) {
        if (smem_bytes > 48 * 1024) {
            err = cudaFuncSetAttribute(ntt_rows_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
            if (err != cudaSuccess) return (int)err;
        }
        ntt_rows_kernel<1><<<(unsigned int)blocks, threads, smem_bytes, st>>>(
            g, k, log2n, tpr, inverse, last0, last1, (const u64*)in0, (const u64*)in1, (const u64*)tw0,
            (const u64*)tw1, ninv0, ninv1, (u64*)out0, (u64*)out1, rows);
    } else {
        if (smem_bytes > 48 * 1024) {
            err = cudaFuncSetAttribute(ntt_rows_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
            if (err != cudaSuccess) return (int)err;
        }
        ntt_rows_kernel<2><<<(unsigned int)blocks, threads, smem_bytes, st>>>(
            g, k, log2n, tpr, inverse, last0, last1, (const u64*)in0, (const u64*)in1, (const u64*)tw0,
            (const u64*)tw1, ninv0, ninv1, (u64*)out0, (u64*)out1, rows);
    }
    return (int)cudaGetLastError();
}

// Long rows: the gather (stage 0), then each stage lg = 1..log2n, one
// launch each; the same arguments as ntt_rows_launch.
extern "C" int ntt_gather_launch(int limbs, int log2n, int rank, const long long* shape, const long long* strides,
                                 const void* in0, const void* in1, void* out0, void* out1, long long rows,
                                 void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || rows <= 0 || (limbs != 1 && limbs != 2)) return (int)cudaErrorInvalidValue;
    long long bst[2 * FIELD_MAX_RANK];
    for (int t = 0; t < 2; ++t)
        for (int d = 0; d < rank; ++d) bst[t * rank + d] = strides[t * (rank + 1) + d];
    Geo g = field_geo(rank, shape, bst, 2);
    long long last0 = strides[rank], last1 = strides[2 * rank + 1];
    long long total = rows << log2n;
    cudaStream_t st = (cudaStream_t)stream;
    if (limbs == 1)
        ntt_gather_kernel<1><<<grid_for(total, 256), 256, 0, st>>>(g, log2n, last0, last1, (const u64*)in0,
                                                                   (const u64*)in1, (u64*)out0, (u64*)out1, total);
    else
        ntt_gather_kernel<2><<<grid_for(total, 256), 256, 0, st>>>(g, log2n, last0, last1, (const u64*)in0,
                                                                   (const u64*)in1, (u64*)out0, (u64*)out1, total);
    return (int)cudaGetLastError();
}

extern "C" int ntt_stage_launch(int limbs, int log2n, int lg, int scale, const unsigned long long* consts,
                                const void* tw0, const void* tw1, unsigned long long ninv0, unsigned long long ninv1,
                                void* out0, void* out1, long long rows, void* stream) {
    if (log2n < 1 || lg < 1 || lg > log2n || rows <= 0 || (limbs != 1 && limbs != 2)) return (int)cudaErrorInvalidValue;
    FieldConsts k = field_consts(consts);
    long long total = rows << (log2n - 1);
    cudaStream_t st = (cudaStream_t)stream;
    if (limbs == 1)
        ntt_stage_kernel<1><<<grid_for(total, 256), 256, 0, st>>>(k, log2n, lg, scale, (const u64*)tw0,
                                                                  (const u64*)tw1, ninv0, ninv1, (u64*)out0,
                                                                  (u64*)out1, total);
    else
        ntt_stage_kernel<2><<<grid_for(total, 256), 256, 0, st>>>(k, log2n, lg, scale, (const u64*)tw0,
                                                                  (const u64*)tw1, ninv0, ninv1, (u64*)out0,
                                                                  (u64*)out1, total);
    return (int)cudaGetLastError();
}
