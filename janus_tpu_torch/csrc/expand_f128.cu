// Fused counter-mode SHAKE128 expansion to Field128 for sm_90a (Hopper).
//
// Replaces janus_tpu/ops/expand_pallas.py expand_f128 (_call,
// _expand_kernel, _reduce_f128_words). One thread per (report, counter
// block): it builds the single-block message prefix || le64(offset + j)
// with SHAKE padding from the report's prefix row, runs the rounds in
// registers, and reduces the 168-byte rate block to 7 Field128 elements
// (three little-endian u64 lanes = one 192-bit value per element, taken
// mod p = 2^128 - 7*2^66 + 1), written straight to element 7*j + t of
// the report's lo/hi rows. The raw stream never reaches memory, and the
// TPU kernel's [b8, nb, 28, 128] u32 layout and transpose are gone.
//
// Bound on the H100: integer ALU. A block writes 112 bytes of elements
// against some 6,200 32-bit instructions of rounds plus the reduction,
// so the design spends nothing on memory beyond those writes: the
// prefix row (<= 19 lanes) is read by every thread of the report from
// L1/L2, and the state stays in registers.
//
// Plain C interface, loaded with ctypes: the launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_f1600.cuh"

typedef unsigned __int128 u128;

// p = 2^128 - 7*2^66 + 1 = (2^64 - 28) * 2^64 + 1
#define P128 (((u128)0xFFFFFFFFFFFFFFE4ULL << 64) | (u128)1ULL)
// 2^128 - p = 7*2^66 - 1 = 27 * 2^64 + (2^64 - 1)
#define C128 (((u128)27ULL << 64) | (u128)0xFFFFFFFFFFFFFFFFULL)

// X = w0 + w1*2^64 + w2*2^128 < 2^192  ->  X mod p, canonical.
// Same steps as _reduce_f128_words on native words: two folds of
// H*2^128 = H*(7*2^66 - 1), a top-bit correction, one conditional
// subtract of p.
__device__ __forceinline__ u128 f128_reduce192(uint64_t w0, uint64_t w1, uint64_t w2) {
    const u128 L = ((u128)w1 << 64) | (u128)w0;
    // fold 1: X1 = L + 28*H*2^64 - H, with H = w2 < 2^64, so X1 < 2^134
    const u128 t = (u128)w2 * 28u;  // 7H * 4 < 2^69
    const u128 s = L + ((u128)(uint64_t)t << 64);
    uint64_t top = (uint64_t)(t >> 64) + (s < L ? 1u : 0u);
    const u128 s1 = s - (u128)w2;
    top -= (s < (u128)w2) ? 1u : 0u;  // X1 = top*2^128 + s1, top < 2^6
    // fold 2: X2 = s1 + 28*top*2^64 - top < 2^128 + 2^75
    const u128 u = s1 + ((u128)(28u * top) << 64);
    const bool carry = u < s1;
    u128 v = u - (u128)top;
    const bool borrow = u < (u128)top;
    // top-bit correction: X2 = 2^128 + v with v < 2^75 -> v + (7*2^66 - 1)
    if (carry && !borrow) v += C128;
    if (v >= P128) v -= P128;
    return v;
}

__global__ void expand_f128_kernel(const uint64_t* __restrict__ prefix, int p,
                                   uint64_t* __restrict__ out_lo, uint64_t* __restrict__ out_hi,
                                   long long batch, long long nblocks, long long length,
                                   long long block_offset, int rounds) {
    long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= batch * nblocks) return;
    const long long b = idx / nblocks;
    const long long j = idx - b * nblocks;
    const uint64_t* pre = prefix + b * p;
    uint64_t a[25];
    // lanes [0, p): prefix; lane p: counter; 0x1F after the message; the
    // 0x80 pad bit in the top byte of rate lane 20; capacity lanes zero
#pragma unroll
    for (int l = 0; l < 25; ++l) {
        uint64_t v = 0;
        if (l < p) {
            v = pre[l];
        } else if (l == p) {
            v = (uint64_t)(block_offset + j);
        }
        if (l == p + 1) v |= 0x1FULL;
        if (l == 20) v |= 0x8000000000000000ULL;
        a[l] = v;
    }
    keccak_f1600(a, rounds);
    const long long row = b * length;
#pragma unroll
    for (int t = 0; t < 7; ++t) {
        const long long e = 7 * j + t;
        if (e < length) {
            const u128 v = f128_reduce192(a[3 * t], a[3 * t + 1], a[3 * t + 2]);
            out_lo[row + e] = (uint64_t)v;
            out_hi[row + e] = (uint64_t)(v >> 64);
        }
    }
}

// prefix: [batch, p] lanes; out_lo, out_hi: [batch, length] limbs.
extern "C" int expand_f128_launch(const void* prefix, int p, void* out_lo, void* out_hi,
                                  long long batch, long long nblocks, long long length,
                                  long long block_offset, int rounds, void* stream) {
    const long long total = batch * nblocks;
    if (total <= 0) return 0;
    const int threads = 128;
    long long blocks = (total + threads - 1) / threads;
    expand_f128_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)prefix, p, (uint64_t*)out_lo, (uint64_t*)out_hi, batch, nblocks,
        length, block_offset, rounds);
    return (int)cudaGetLastError();
}
