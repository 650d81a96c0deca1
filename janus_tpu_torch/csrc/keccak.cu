// Single-block Keccak-f[1600] for sm_90a (Hopper).
//
// Replaces janus_tpu/ops/keccak_pallas.py keccak_single_block_pallas
// (_call_single, _kernel_single): every state is a single-block SHAKE128
// message whose 21 rate lanes come in and whose 4 capacity lanes are
// zero; only the first `out_lanes` lanes go out (21 for a counter-mode
// stream block, 2 for a tree-digest node).
//
// Bound on the H100: integer ALU. A state moves 168 bytes in and at most
// 168 out, against 24 rounds of about 130 64-bit logic ops, each two
// 32-bit instructions: some 6,200 instructions per 336 bytes, far past
// the card's ratio of integer issue rate to memory rate. So the design
// keeps the whole state in registers for all rounds (one thread per
// state) and reads and writes each lane exactly once: lane l of state i
// lives at l*n + i, so a warp's loads and stores of one lane are
// contiguous. The TPU kernel's lo/hi u32 relayout is not needed: the
// lanes are native 64-bit words.
//
// Plain C interface, loaded with ctypes: the launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_f1600.cuh"

__global__ void keccak_single_block_kernel(const uint64_t* __restrict__ in,
                                           uint64_t* __restrict__ out, long long n,
                                           int out_lanes, int rounds) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 21; ++l) a[l] = in[(long long)l * n + i];
#pragma unroll
    for (int l = 21; l < 25; ++l) a[l] = 0;
    keccak_f1600(a, rounds);
#pragma unroll
    for (int l = 0; l < 21; ++l) {
        if (l < out_lanes) out[(long long)l * n + i] = a[l];
    }
}

// in: [21, n] lanes, out: [out_lanes, n] lanes (uint64 bit patterns).
extern "C" int keccak_single_block_launch(const void* in, void* out, long long n,
                                          int out_lanes, int rounds, void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    long long blocks = (n + threads - 1) / threads;
    keccak_single_block_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n, out_lanes, rounds);
    return (int)cudaGetLastError();
}
