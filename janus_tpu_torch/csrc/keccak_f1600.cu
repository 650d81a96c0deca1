// The full 25-lane Keccak-f[1600] for sm_90a (Hopper).
//
// Replaces janus_tpu/ops/keccak_pallas.py keccak_f1600_pallas (_call,
// _kernel_for): 25 lanes in, 25 lanes out, one permutation per state.
// The draft-mode (VDAF-07) sequential sponge runs one launch per absorbed
// or squeezed block, over one state per report.
//
// Bound on the H100: at the sponge's widths (1,024 to 8,192 states a
// launch, 8 to 64 blocks of 128 threads on 132 SMs) the launch itself;
// at a width that fills the card, the integer ALU: 400 bytes in and out
// per state against 24 rounds of about 130 64-bit logic ops. The design
// is that of keccak.cu: one thread per state, the 25 lanes in registers
// for all rounds, each lane read once and written once in a lane-major
// [25, n] layout (lane l of state i at l*n + i), so a warp's accesses to
// one lane are contiguous. Nothing is relaid: the TPU kernel's u32
// lo/hi halves are native 64-bit words here. The launch-bound regime is
// the design's known limit (one launch per block of a ~1,500-block
// chain); a kernel that runs a whole chain is later work.
//
// Plain C interface, loaded with ctypes: the launch returns the CUDA
// error code of the launch (0 on success). `in` and `out` must not
// overlap; the wrapper always allocates a fresh output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_f1600.cuh"

__global__ void keccak_f1600_kernel(const uint64_t* __restrict__ in,
                                    uint64_t* __restrict__ out, long long n, int rounds) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) a[l] = in[(long long)l * n + i];
    keccak_f1600(a, rounds);
#pragma unroll
    for (int l = 0; l < 25; ++l) out[(long long)l * n + i] = a[l];
}

// in, out: [25, n] lanes (uint64 bit patterns), distinct buffers.
extern "C" int keccak_f1600_launch(const void* in, void* out, long long n, int rounds,
                                   void* stream) {
    if (n <= 0) return 0;
    const int threads = 128;
    long long blocks = (n + threads - 1) / threads;
    keccak_f1600_kernel<<<(unsigned int)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, n, rounds);
    return (int)cudaGetLastError();
}
