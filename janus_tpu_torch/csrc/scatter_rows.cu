// Field128 scatter-add of compact rows into a logical accumulator, for sm_90a (Hopper).
//
// Replaces janus_tpu/vdaf/prio3_jax.py:458 Prio3Batched.scatter_rows, which
// is not a Pallas kernel: XLA compiles its lax.scan over reports (gather,
// modular add, scatter with mode="drop"). It computes
//
//   out[p] = acc[p] + sum of values[i, c] over every lane (i, c) with
//            flat_idx[i, c] == p                                   (mod p128)
//
// for p in [0, L). A lane whose index lies outside [0, L) is dropped: the
// callers' sentinel is L, for padding blocks, rejected reports and the
// padding rows of a bucket.
//
// Field addition is exact, so the order of the adds does not change the
// result and the kernel sums by position, not report by report. Atomics
// have no modular 128-bit add, so each position gets a plain 192-bit
// integer sum in three u64 words of scratch: a lane adds its value's low
// word with atomicAdd, carries out of that add into the middle word with
// its high word, and a carry out of the middle word into the top word. The
// carry of each add comes from the value atomicAdd returns, so the words
// hold the exact integer sum under any interleaving (at most 2^64 lanes of
// values below 2^128). A last pass reduces each position's sum mod p, adds
// acc[p] and writes out[p] once. Reports that share a block (every report
// carrying block 0) meet only on the atomics of those positions.
//
// Bound on the H100: bytes. The function reads values (16 B a lane), the
// indices (4 B a lane) and acc (16 B a position) once and writes out once;
// its arithmetic is a handful of adds a lane. The design adds the scratch
// (zeroed, then read once: 48 B a position) and the atomics' traffic to
// that minimum.
//
// Plain C interface, loaded with ctypes: the launch returns the CUDA error
// code of its first failed launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned __int128 u128;
typedef unsigned long long ull;

// p = 2^128 - 7*2^66 + 1 = (2^64 - 28) * 2^64 + 1
#define P128 (((u128)0xFFFFFFFFFFFFFFE4ULL << 64) | (u128)1ULL)
// 2^128 - p = 7*2^66 - 1 = 27 * 2^64 + (2^64 - 1)
#define C128 (((u128)27ULL << 64) | (u128)0xFFFFFFFFFFFFFFFFULL)

// X = w0 + w1*2^64 + w2*2^128 < 2^192  ->  X mod p, canonical
// (csrc/expand_f128.cu's reduction, the same steps).
__device__ __forceinline__ u128 f128_reduce192(uint64_t w0, uint64_t w1, uint64_t w2) {
    const u128 L = ((u128)w1 << 64) | (u128)w0;
    const u128 t = (u128)w2 * 28u;
    const u128 s = L + ((u128)(uint64_t)t << 64);
    uint64_t top = (uint64_t)(t >> 64) + (s < L ? 1u : 0u);
    const u128 s1 = s - (u128)w2;
    top -= (s < (u128)w2) ? 1u : 0u;
    const u128 u = s1 + ((u128)(28u * top) << 64);
    const bool carry = u < s1;
    u128 v = u - (u128)top;
    const bool borrow = u < (u128)top;
    if (carry && !borrow) v += C128;
    if (v >= P128) v -= P128;
    return v;
}

__global__ void scatter_zero_kernel(ull* __restrict__ words, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) words[i] = 0;
}

// One thread per lane (report i, compact column c), row-major.
__global__ void scatter_accumulate_kernel(const uint64_t* __restrict__ val_lo, const uint64_t* __restrict__ val_hi,
                                          const int32_t* __restrict__ idx, long long lanes, long long L,
                                          ull* __restrict__ words) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= lanes) return;
    const long long p = idx[i];
    if (p < 0 || p >= L) return;  // the sentinel (L) and anything else out of range
    ull* cell = words + 3 * p;
    const ull lo = val_lo[i];
    const ull old0 = atomicAdd(cell, lo);
    // hi < 2^64 - 27 for an element < p, so hi + 1 does not wrap
    const ull mid = val_hi[i] + (old0 + lo < old0 ? 1ULL : 0ULL);
    const ull old1 = atomicAdd(cell + 1, mid);
    if (old1 + mid < old1) atomicAdd(cell + 2, 1ULL);
}

// One thread per logical position: out = acc + (its sum mod p), mod p.
__global__ void scatter_finalize_kernel(const uint64_t* __restrict__ acc_lo, const uint64_t* __restrict__ acc_hi,
                                        const ull* __restrict__ words, uint64_t* __restrict__ out_lo,
                                        uint64_t* __restrict__ out_hi, long long L) {
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= L) return;
    const u128 s = f128_reduce192(words[3 * p], words[3 * p + 1], words[3 * p + 2]);
    const u128 a = ((u128)acc_hi[p] << 64) | (u128)acc_lo[p];
    u128 t = a + s;
    // a, s < p: a true sum past 2^128 or at least p loses p (mod 2^128
    // the subtraction is right in both cases, the result being below p)
    if (t < a || t >= P128) t -= P128;
    out_lo[p] = (uint64_t)t;
    out_hi[p] = (uint64_t)(t >> 64);
}

// acc_lo, acc_hi: [L]; val_lo, val_hi: [lanes] (a [b, cm] row-major batch);
// idx: [lanes] int32; words: [3 L] scratch; out_lo, out_hi: [L].
extern "C" int scatter_rows_launch(const void* acc_lo, const void* acc_hi, const void* val_lo, const void* val_hi,
                                   const void* idx, long long lanes, long long L, void* words, void* out_lo,
                                   void* out_hi, void* stream) {
    if (L <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long nw = 3 * L;
    scatter_zero_kernel<<<(unsigned int)((nw + threads - 1) / threads), threads, 0, s>>>((ull*)words, nw);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    if (lanes > 0) {
        scatter_accumulate_kernel<<<(unsigned int)((lanes + threads - 1) / threads), threads, 0, s>>>(
            (const uint64_t*)val_lo, (const uint64_t*)val_hi, (const int32_t*)idx, lanes, L, (ull*)words);
        rc = cudaGetLastError();
        if (rc != cudaSuccess) return (int)rc;
    }
    scatter_finalize_kernel<<<(unsigned int)((L + threads - 1) / threads), threads, 0, s>>>(
        (const uint64_t*)acc_lo, (const uint64_t*)acc_hi, (const ull*)words, (uint64_t*)out_lo, (uint64_t*)out_hi, L);
    return (int)cudaGetLastError();
}
