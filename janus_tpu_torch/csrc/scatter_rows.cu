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
// Bound on the H100: bytes. The function reads the live lanes' values
// (16 B), every index (4 B) and acc (16 B a position) once and writes out
// once; its arithmetic is a handful of adds a lane. Field addition is
// exact, so the order of the adds does not change the result: the kernel
// sums by position, not report by report, straight into the output, in
// three launches whose cost beyond acc and out follows the live lanes.
//
//   copy        out = acc, 16-byte accesses; a block also zeroes the marks
//               of its 32 groups.
//   accumulate  a thread takes compact column c over a run of 2 rows (a
//               warp reads 32 neighbouring columns of one row; a dead
//               lane's value is not read) and adds equal consecutive
//               positions in registers with the exact Field128 add; the 8
//               warps of a block, each on its own run of rows of the same
//               32 columns, then merge their last runs of equal position
//               (block 0, in every report, becomes one sum a position a
//               block). Each run
//               goes into out with atomics, in rounds of independent ones
//               (every run's low word, then every high word with its carry,
//               then the rare folds), so a thread waits on two atomic round
//               trips, not two a run, and marks its 64-position group (one
//               byte a group). Programmatic dependent launch lets the loads
//               and the adds in registers run while the copy still runs.
//   finalize    a block owns 32 groups (2,048 positions): it takes p off
//               each position of a marked group that holds p or more.
//               Launched early too, it waits on the accumulate launch
//               before it reads a mark.
//
// Atomics have no modular 128-bit add, so a position's two words hold a
// 128-bit integer congruent to the sum mod p: an add puts its low word with
// atomicAdd, carries out of that add into the high word with its high word,
// and a carry out of the high word (the integer passed 2^128) is folded back
// in as 2^128 mod p = 7 * 2^66 - 1 by the thread whose add made it, the same
// way. Each carry comes from the old value its atomic returns, so the words
// stay congruent to the exact sum under any interleaving.
//
// The marks (a byte a 64-position group, 16 KB at L = 1,000,000) are the
// only scratch: the wrapper allocates them per launch, uninitialized, on
// the launch's stream, and the copy zeroes them before the accumulate,
// which waits for the copy before it writes one.
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
#define C128_LO 0xFFFFFFFFFFFFFFFFULL
#define C128_HI 27ULL

#define GROUP_SHIFT 6     // 64 positions a group
#define BLOCK_POS 2048    // positions a copy or finalize block: 32 groups
#define FIN_GROUPS 32
#define PASS_THREADS 256  // copy and finalize: 4 position pairs a thread
#define ACC_WARPS 8       // accumulate: 8 warps' row runs over 32 columns
#define ROWS 2            // rows a thread walks down its column (chosen on the card: PERF.md, kernel 4)

// a + b mod p for reduced a, b: a true sum past 2^128 or at least p loses p
// (mod 2^128 the subtraction is right in both cases, the result being below p)
__device__ __forceinline__ u128 f128_add(u128 a, u128 b) {
    u128 t = a + b;
    if (t < a || t >= P128) t -= P128;
    return t;
}

__device__ __forceinline__ u128 load_value(const ull* lo, const ull* hi, long long i) {
    return ((u128)__ldg(hi + i) << 64) | (u128)__ldg(lo + i);
}

// out = acc over 2,048 positions a block, and their 32 marks zero; the
// accumulate launch may start at once (it waits for the copy before its
// first atomic or mark).
__global__ void __launch_bounds__(PASS_THREADS)
scatter_copy_kernel(const ull* __restrict__ acc_lo, const ull* __restrict__ acc_hi, ull* __restrict__ out_lo,
                    ull* __restrict__ out_hi, unsigned char* __restrict__ marks, long long L) {
    cudaTriggerProgrammaticLaunchCompletion();
    if (threadIdx.x < FIN_GROUPS) marks[(long long)blockIdx.x * FIN_GROUPS + threadIdx.x] = 0;
    const long long base = (long long)blockIdx.x * BLOCK_POS;
#pragma unroll
    for (int k = 0; k < BLOCK_POS / (2 * PASS_THREADS); ++k) {
        const long long p = base + k * 2 * PASS_THREADS + 2 * threadIdx.x;
        if (p + 1 < L) {
            *(ulonglong2*)(out_lo + p) = __ldg((const ulonglong2*)(acc_lo + p));
            *(ulonglong2*)(out_hi + p) = __ldg((const ulonglong2*)(acc_hi + p));
        } else if (p < L) {
            out_lo[p] = acc_lo[p];
            out_hi[p] = acc_hi[p];
        }
    }
}

// Block (row super-run, 32 columns): warp w walks rows [r0 + w ROWS, r0 + (w+1) ROWS)
// of column c; every thread of a warp walks the same rows.
__global__ void __launch_bounds__(ACC_WARPS * 32)
scatter_accumulate_kernel(const ull* __restrict__ val_lo, const ull* __restrict__ val_hi,
                          const int32_t* __restrict__ idx, long long rows, long long cols, long long L,
                          ull* __restrict__ out_lo, ull* __restrict__ out_hi, unsigned char* __restrict__ marks) {
    __shared__ long long last_pos[ACC_WARPS][32];
    __shared__ ull last_lo[ACC_WARPS][32], last_hi[ACC_WARPS][32];
    cudaTriggerProgrammaticLaunchCompletion();  // the finalize launch may get ready
    const unsigned lane = threadIdx.x & 31;
    const unsigned w = threadIdx.x >> 5;
    const long long c = (long long)blockIdx.y * 32 + lane;
    const bool col_ok = c < cols;
    const long long r0 = ((long long)blockIdx.x * ACC_WARPS + w) * ROWS;
    // slot k > 0: the run that ended just before row k; slot 0: the last run
    long long pos[ROWS];
    u128 sum[ROWS];
    long long cur = -1;  // the open run's position, -1 before the first live lane
    u128 run = 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const long long i = r0 + k;
        const long long p = (col_ok && i < rows) ? (long long)__ldg(idx + i * cols + c) : -1;
        const bool live = p >= 0 && p < L;
        const u128 v = live ? load_value(val_lo, val_hi, i * cols + c) : (u128)0;
        pos[k] = -1;
        if (live && p != cur) {
            pos[k] = cur;
            sum[k] = run;
            cur = p;
            run = v;
        } else if (live) {
            run = f128_add(run, v);
        }
    }
    // the block's warps merge their last runs of one position into warp 0's
    last_pos[w][lane] = cur;
    last_lo[w][lane] = (ull)run;
    last_hi[w][lane] = (ull)(run >> 64);
    __syncthreads();
    if (w == 0 && cur >= 0) {
#pragma unroll
        for (int o = 1; o < ACC_WARPS; ++o) {
            if (last_pos[o][lane] == cur) {
                run = f128_add(run, ((u128)last_hi[o][lane] << 64) | (u128)last_lo[o][lane]);
                last_pos[o][lane] = -1;
            }
        }
    }
    __syncthreads();
    pos[0] = w == 0 ? cur : last_pos[w][lane];
    sum[0] = run;
    cudaGridDependencySynchronize();  // the copy has run: out holds acc, the marks are zero
    ull old[ROWS], add[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (pos[k] >= 0) {
            old[k] = atomicAdd(out_lo + pos[k], (ull)sum[k]);
            marks[pos[k] >> GROUP_SHIFT] = 1;
        }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (pos[k] >= 0) {
            // hi < 2^64 - 27 for an element < p, so hi + 1 does not wrap
            add[k] = (ull)(sum[k] >> 64) + (old[k] + (ull)sum[k] < old[k] ? 1ULL : 0ULL);
            old[k] = atomicAdd(out_hi + pos[k], add[k]);
        }
    }
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        // the integer passed 2^128: add 2^128 mod p, until no add wraps
        bool wrapped = pos[k] >= 0 && old[k] + add[k] < old[k];
        while (wrapped) {
            const ull o = atomicAdd(out_lo + pos[k], C128_LO);
            const ull a = C128_HI + (o + C128_LO < o ? 1ULL : 0ULL);
            const ull h = atomicAdd(out_hi + pos[k], a);
            wrapped = h + a < h;
        }
    }
}

// Block k: groups [32 k, 32 (k + 1)); a warp's 64 neighbouring positions
// (a pair a thread) lie in one group.
__global__ void __launch_bounds__(PASS_THREADS)
scatter_finalize_kernel(const unsigned char* __restrict__ marks, ull* __restrict__ out_lo, ull* __restrict__ out_hi,
                        long long L) {
    __shared__ unsigned char marked[FIN_GROUPS];
    cudaGridDependencySynchronize();  // the accumulate launch has run
    if (threadIdx.x < FIN_GROUPS) marked[threadIdx.x] = marks[(long long)blockIdx.x * FIN_GROUPS + threadIdx.x];
    __syncthreads();
    const long long base = (long long)blockIdx.x * BLOCK_POS;
#pragma unroll
    for (int k = 0; k < BLOCK_POS / (2 * PASS_THREADS); ++k) {
        const int off = k * 2 * PASS_THREADS + 2 * threadIdx.x;
        if (!marked[off >> GROUP_SHIFT]) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const long long p = base + off + e;
            if (p >= L) continue;
            const u128 v = ((u128)out_hi[p] << 64) | (u128)out_lo[p];
            if (v >= P128) {
                const u128 t = v - P128;
                out_lo[p] = (ull)t;
                out_hi[p] = (ull)(t >> 64);
            }
        }
    }
}

// A launch that may start before the one before it on the stream ends
// (programmatic dependent launch): the kernel waits for it with
// cudaGridDependencySynchronize where it needs its results.
template <typename... Params, typename... Args>
static cudaError_t launch_early(void (*kernel)(Params...), dim3 grid, dim3 block, cudaStream_t s, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// acc_lo, acc_hi, out_lo, out_hi: [L], 16-byte aligned; val_lo, val_hi:
// [rows, cols] row-major; idx: [rows, cols] int32; marks: [32 ceil(L /
// 2048)] bytes of scratch, any contents (the copy zeroes them).
extern "C" int scatter_rows_launch(const void* acc_lo, const void* acc_hi, const void* val_lo, const void* val_hi,
                                   const void* idx, long long rows, long long cols, long long L, void* marks,
                                   void* out_lo, void* out_hi, void* stream) {
    if (L <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned int nblk = (unsigned int)((L + BLOCK_POS - 1) / BLOCK_POS);
    ull* ol = (ull*)out_lo;
    ull* oh = (ull*)out_hi;
    unsigned char* mk = (unsigned char*)marks;
    scatter_copy_kernel<<<nblk, PASS_THREADS, 0, s>>>((const ull*)acc_lo, (const ull*)acc_hi, ol, oh, mk, L);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess || rows <= 0 || cols <= 0) return (int)rc;
    // x: row super-runs (up to 2^31 - 1), y: 32-column blocks (cols up to 2^21)
    const dim3 grid((unsigned int)((rows + ACC_WARPS * ROWS - 1) / (ACC_WARPS * ROWS)), (unsigned int)((cols + 31) / 32));
    rc = launch_early(scatter_accumulate_kernel, grid, dim3(ACC_WARPS * 32), s, (const ull*)val_lo,
                      (const ull*)val_hi, (const int32_t*)idx, rows, cols, L, ol, oh, mk);
    if (rc != cudaSuccess) return (int)rc;
    return (int)launch_early(scatter_finalize_kernel, dim3(nblk), dim3(PASS_THREADS), s, (const unsigned char*)mk,
                             ol, oh, L);
}
