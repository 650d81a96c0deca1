// Kernel 1 for sm_90a (Hopper): single-block Keccak-f[1600] over messages
// assembled in registers, in two launches shaped as the fast XOF's callers
// hold their data.
//
// Replaces janus_tpu/ops/keccak_pallas.py keccak_single_block_pallas
// (_call_single, _kernel_single): every state is a single-block SHAKE128
// message whose 21 rate lanes are built from the caller's data and whose 4
// capacity lanes are zero; only the lanes the caller reads go out.
//
//   keccak_ctr_launch   counter mode: the message prefix || le64(ctr_offset
//                       + j) with SHAKE padding, for block j of report b.
//                       Each prefix lane is a kernel argument (a constant,
//                       such as the dst) or a column read where it lies
//                       ([batch, k] tensors, any strides). Out: the first
//                       out_lanes lanes, as [batch, out_blocks, out_lanes].
//   keccak_tree_launch  one level of the arity-7 tree digest
//                       (vdaf/xof.py tree_digest): node k of report b hashes
//                       magic || le64(level) || le64(k) || le64(total bytes)
//                       || 14 payload lanes, the payload read in place from
//                       the level's lane space (the leaf level: lane j of
//                       node k is data lane j*n + k; upper levels: 14k + j of
//                       the digests below); lanes past the data read zero.
//                       Out: digests [batch, n, 2].
//
// Bound on the H100: integer ALU. A state is 24 rounds of about 180 32-bit
// instructions against at most 168 bytes in and 168 out, so the design
// spends nothing on memory beyond each input lane read once (a report's
// prefix lanes are shared by its blocks, from L1) and each output lane
// written once: one thread per state, the state in registers, no message
// or stacked lanes in memory, one launch per batch of states. Past 2 lanes
// out, the counter kernel stages them through shared memory so that a
// block's stores cover one contiguous range (a thread's own lanes are
// 8*out_lanes bytes apart from its neighbour's; chosen on the card:
// PERF.md, kernel 1).
//
// Plain C interface, loaded with ctypes: each launch returns the CUDA error
// code of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_f1600.cuh"

#define RATE_LANES 21
#define PREFIX_MAX 19  // a prefix and the counter fit one rate block
#define SEG_MAX 4  // the joint-rand binder's leaf level has 3 parts
#define KONST_MAX 16
#define TREE_CHUNK 14
#define THREADS 128

// Lane l < p of a counter-mode prefix: ptr[l][b * row_stride[l]] for report
// b, or konst[l] where ptr[l] is null.
struct CtrPrefix {
    const uint64_t* ptr[PREFIX_MAX];
    long long row_stride[PREFIX_MAX];
    uint64_t konst[PREFIX_MAX];
};

// A [batch, *] lane space made of segments where they lie: lane q of row b
// lies in segment s when start[s] <= q < start[s] + len[s], at
// ptr[s][b * row_stride[s] + (q - start[s]) * lane_stride[s]], or at
// konst[koff[s] + q - start[s]] where ptr[s] is null. Lanes no segment
// covers are zero.
struct LaneSpace {
    const uint64_t* ptr[SEG_MAX];
    long long start[SEG_MAX];
    long long len[SEG_MAX];
    long long row_stride[SEG_MAX];
    long long lane_stride[SEG_MAX];
    int koff[SEG_MAX];
    int nseg;
    uint64_t konst[KONST_MAX];
};

__device__ __forceinline__ uint64_t ld(const uint64_t* p) { return __ldg((const unsigned long long*)p); }

__device__ __forceinline__ uint64_t lane_at(const LaneSpace& m, long long b, long long q) {
    uint64_t v = 0;
#pragma unroll
    for (int s = 0; s < SEG_MAX; ++s) {
        if (s < m.nseg) {
            const long long r = q - m.start[s];
            if ((unsigned long long)r < (unsigned long long)m.len[s]) {  // 0 <= r < len
                v = m.ptr[s] ? ld(m.ptr[s] + b * m.row_stride[s] + r * m.lane_stride[s])
                             : m.konst[m.koff[s] + r];
            }
        }
    }
    return v;
}

// (row, column) of flat index idx in [rows, n]: 32-bit division where the
// whole range fits it (a 64-bit division is a long software sequence)
__device__ __forceinline__ void split_index(long long idx, long long n, long long total, long long& b,
                                            long long& k) {
    if (total <= 0xFFFFFFFFLL) {
        b = (unsigned)idx / (unsigned)n;
    } else {
        b = idx / n;
    }
    k = idx - b * n;
}

template <bool STAGE>
__global__ void __launch_bounds__(THREADS)
keccak_ctr_kernel(const __grid_constant__ CtrPrefix pre, int p, long long batch, long long nblocks,
                  long long ctr_offset, int out_lanes, uint64_t* __restrict__ out, int rounds) {
    __shared__ uint64_t stage[STAGE ? THREADS * RATE_LANES : 1];
    const long long total = batch * nblocks;
    const long long first = (long long)blockIdx.x * THREADS;
    const long long idx = first + threadIdx.x;
    uint64_t a[25];
    if (idx < total) {
        long long b, j;
        split_index(idx, nblocks, total, b, j);
        // lanes [0, p): prefix; lane p: counter; 0x1F after the message;
        // the 0x80 pad bit in the top byte of rate lane 20; capacity zero
#pragma unroll
        for (int l = 0; l < 25; ++l) {
            uint64_t v = 0;
            if (l < PREFIX_MAX && l < p) {
                v = pre.ptr[l] ? ld(pre.ptr[l] + b * pre.row_stride[l]) : pre.konst[l];
            } else if (l == p) {
                v = (uint64_t)(ctr_offset + j);
            }
            if (l == p + 1) v |= 0x1FULL;
            if (l == RATE_LANES - 1) v |= 0x8000000000000000ULL;
            a[l] = v;
        }
        keccak_f1600(a, rounds);
    }
    if (STAGE) {
        // the block's rows of [batch * nblocks, out_lanes] are one range
        if (idx < total) {
#pragma unroll
            for (int l = 0; l < RATE_LANES; ++l) {
                if (l < out_lanes) stage[threadIdx.x * out_lanes + l] = a[l];
            }
        }
        __syncthreads();
        const long long rows = total - first < THREADS ? total - first : THREADS;
        const int n = (int)rows * out_lanes;
        uint64_t* dst = out + first * out_lanes;
        for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = stage[i];
    } else if (idx < total) {
        uint64_t* dst = out + idx * out_lanes;
#pragma unroll
        for (int l = 0; l < RATE_LANES; ++l) {
            if (l < out_lanes) dst[l] = a[l];
        }
    }
}

__global__ void __launch_bounds__(THREADS)
keccak_tree_kernel(const __grid_constant__ LaneSpace m, long long batch, long long n, long long jstride,
                   long long kstride, uint64_t magic, long long level, long long total_bytes,
                   ulonglong2* __restrict__ out, int rounds) {
    const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long total = batch * n;
    if (idx >= total) return;
    long long b, k;
    split_index(idx, n, total, b, k);
    uint64_t a[25];
    a[0] = magic;
    a[1] = (uint64_t)level;
    a[2] = (uint64_t)k;
    a[3] = (uint64_t)total_bytes;
#pragma unroll
    for (int j = 0; j < TREE_CHUNK; ++j) a[4 + j] = lane_at(m, b, j * jstride + k * kstride);
    a[18] = 0x1FULL;  // the message is 4 + 14 lanes; 0x1F right after
    a[19] = 0;
    a[20] = 0x8000000000000000ULL;
#pragma unroll
    for (int l = 21; l < 25; ++l) a[l] = 0;
    keccak_f1600(a, rounds);
    out[idx] = make_ulonglong2(a[0], a[1]);
}

// pre: a CtrPrefix of p lanes; out: [batch, nblocks, out_lanes] lanes.
extern "C" int keccak_ctr_launch(const void* pre, int p, long long batch, long long nblocks, long long ctr_offset,
                                 int out_lanes, void* out, int rounds, void* stream) {
    const long long total = batch * nblocks;
    if (total <= 0) return 0;
    const CtrPrefix& prefix = *(const CtrPrefix*)pre;
    const unsigned int grid = (unsigned int)((total + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    if (out_lanes > 2) {
        keccak_ctr_kernel<true><<<grid, THREADS, 0, s>>>(prefix, p, batch, nblocks, ctr_offset, out_lanes,
                                                         (uint64_t*)out, rounds);
    } else {
        keccak_ctr_kernel<false><<<grid, THREADS, 0, s>>>(prefix, p, batch, nblocks, ctr_offset, out_lanes,
                                                          (uint64_t*)out, rounds);
    }
    return (int)cudaGetLastError();
}

// lanes: the level's LaneSpace; lane j of node k is lane j*jstride + k*kstride
// of it; out: [batch, n, 2] digests (16-byte aligned).
extern "C" int keccak_tree_launch(const void* lanes, long long batch, long long n, long long jstride,
                                  long long kstride, unsigned long long magic, long long level,
                                  long long total_bytes, void* out, int rounds, void* stream) {
    const long long total = batch * n;
    if (total <= 0) return 0;
    const LaneSpace& m = *(const LaneSpace*)lanes;
    const unsigned int grid = (unsigned int)((total + THREADS - 1) / THREADS);
    keccak_tree_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(m, batch, n, jstride, kstride, magic, level,
                                                                   total_bytes, (ulonglong2*)out, rounds);
    return (int)cudaGetLastError();
}
