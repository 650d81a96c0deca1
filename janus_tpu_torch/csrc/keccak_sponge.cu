// Whole draft-mode (VDAF-07) SHAKE128 XOF calls for sm_90a (Hopper).
//
// Replaces janus_tpu/ops/keccak_pallas.py keccak_f1600_pallas as the
// draft sponge uses it: the JAX package (vdaf/keccak_jax.py
// shake128_squeeze_lanes) runs one permutation per absorbed or squeezed
// block inside a lax.scan. Here one launch runs a whole XOF call, for
// every report of a batch:
//
//   absorb   the message  head || body  with SHAKE padding, block by
//            block. The head (the short framing: byte(8) || dst8 || seed
//            || ...) comes as [batch, head_lanes] lanes; the body, when
//            there is one, is read in place from a field vector's limb
//            planes (element by element, lo then hi) and shifted to its
//            byte offset here. The padding (0x1F after the message, 0x80
//            in the last rate byte, possibly the same byte) is written
//            here too, so no padded message exists in memory.
//   squeeze  either the first `out_lanes` lanes of the first squeezed
//            block (a derived seed), or draft rejection sampling fused
//            into the squeeze: candidates of `limbs` lanes are kept when
//            below the modulus (an argument: one kernel serves Field64
//            and Field128), the accepted ones fill the output in order
//            while at most WINDOW were rejected, and the tail stays zero
//            once more were. A Field128 candidate may straddle two
//            blocks (21 rate lanes are odd); its low half is carried
//            across the permutation. Squeezing stops once the output is
//            full or the window is spent.
//
// Bound on the H100: the chain is sequential per report, so at the
// path's widths (1,024 to 8,192 reports, 32 to 256 warps) one warp's
// instruction stream, not the card's throughput. A warp's 32-bit logic
// issues at 16 lanes a clock on its SM sub-partition, so a round costs
// about twice its ~200 instructions in clocks, whatever the number of
// reports in the warp; the roofline bound, all SMs busy, is far below a
// chain's time. The design does what it can about the sequential part:
// one launch per call instead of one per block, the state in registers
// for the whole chain (one thread per report, 25 lanes), the next
// block's body words loaded before the current permutation runs, and
// 32-thread blocks that spread the warps over as many SMs as there are
// warps. (A layout of five threads per report, a column each, with
// theta's parities, the rho-pi transpose and chi's neighbours exchanged
// through shared memory, ran no faster on the draft-sumvec step's chains
// and half as fast on Field64 at 8,192 reports: PERF.md.)
//
// Output stores are per-thread rows ([batch, length] planes), 8 bytes a
// thread, scattered over a warp's rows; L2 gathers them into sectors.
// They are not staged through shared memory: a squeeze that writes
// 256,000 bytes a report runs 2 % longer than an absorb of as many
// blocks that writes 16 (PERF.md).
//
// Plain C interface, loaded with ctypes: the launch returns the CUDA
// error code of the launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak_f1600.cuh"

namespace {

constexpr int RATE = 21;
constexpr int WINDOW = 8;

struct Sponge {
    const uint64_t* head;     // [batch, head_lanes]
    const uint64_t* body_lo;  // [batch, >= elements] limb planes, row stride body_stride
    const uint64_t* body_hi;  // second plane when body_limbs == 2
    long long body_stride;
    long long body_lanes;     // elements * body_limbs
    long long body_base;      // body byte offset / 8
    int body_shift;           // 8 * (body byte offset % 8)
    int body_limbs;
    int head_lanes;
    long long pad_lane;       // lane of the 0x1F byte
    uint64_t pad_word;
    long long n_blocks;       // absorbed blocks
    long long max_squeeze;    // sampling: blocks that hold every candidate
    int out_lanes;            // > 0: lanes mode; 0: sampling
    int length;
    int limbs;
    uint64_t p_lo, p_hi;
    uint64_t* out_lo;
    uint64_t* out_hi;
    long long batch;
    int rounds;
};

__device__ __forceinline__ uint64_t load_ro(const uint64_t* p) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

// Body lane k of a report (0 outside the body).
__device__ __forceinline__ uint64_t body_word(const Sponge& s, long long row, long long k) {
    if (k < 0 || k >= s.body_lanes) return 0;
    if (s.body_limbs == 1) return load_ro(s.body_lo + row * s.body_stride + k);
    const uint64_t* plane = (k & 1) ? s.body_hi : s.body_lo;
    return load_ro(plane + row * s.body_stride + (k >> 1));
}

// Lane j of the padded message, given w = body lane j - base and
// prev = body lane j - base - 1.
__device__ __forceinline__ uint64_t msg_lane(const Sponge& s, long long row, long long j, uint64_t w,
                                             uint64_t prev) {
    uint64_t v = s.body_shift ? (w << s.body_shift) | (prev >> (64 - s.body_shift)) : w;
    if (j < s.head_lanes) v |= load_ro(s.head + row * s.head_lanes + j);
    if (j == s.pad_lane) v |= s.pad_word;
    if (j == s.n_blocks * RATE - 1) v |= 0x8000000000000000ULL;
    return v;
}

// Draft rejection sampling as a sequential scan over stream lanes.
struct Sampler {
    int rejects = 0;
    int filled = 0;
    bool half = false;
    uint64_t lo = 0;

    __device__ __forceinline__ bool done(const Sponge& s) const {
        return filled >= s.length || rejects > WINDOW;
    }

    __device__ __forceinline__ void feed(const Sponge& s, long long row, uint64_t lane, bool store) {
        if (done(s)) return;
        uint64_t c_lo = lane, c_hi = 0;
        bool accept;
        if (s.limbs == 1) {
            accept = c_lo < s.p_lo;
        } else {
            if (!half) {
                lo = lane;
                half = true;
                return;
            }
            half = false;
            c_lo = lo;
            c_hi = lane;
            accept = c_hi < s.p_hi || (c_hi == s.p_hi && c_lo < s.p_lo);
        }
        if (!accept) {
            ++rejects;
            return;
        }
        if (store) {
            long long at = row * s.length + filled;
            s.out_lo[at] = c_lo;
            if (s.limbs == 2) s.out_hi[at] = c_hi;
        }
        ++filled;
    }

    __device__ void zero_tail(const Sponge& s, long long row) const {
        for (long long e = filled; e < s.length; ++e) {
            s.out_lo[row * s.length + e] = 0;
            if (s.limbs == 2) s.out_hi[row * s.length + e] = 0;
        }
    }
};

__global__ void __launch_bounds__(32) keccak_sponge_kernel(Sponge s) {
    const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= s.batch) return;
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) a[l] = 0;
    uint64_t next[RATE];
#pragma unroll
    for (int t = 0; t < RATE; ++t) next[t] = body_word(s, row, t - s.body_base);
    uint64_t prev = 0;
    for (long long blk = 0; blk < s.n_blocks; ++blk) {
#pragma unroll
        for (int t = 0; t < RATE; ++t) {
            a[t] ^= msg_lane(s, row, blk * RATE + t, next[t], prev);
            prev = next[t];
        }
        if (blk + 1 < s.n_blocks) {
            // in flight while the permutation runs
#pragma unroll
            for (int t = 0; t < RATE; ++t) next[t] = body_word(s, row, (blk + 1) * RATE + t - s.body_base);
        }
        keccak_f1600(a, s.rounds);
    }
    if (s.out_lanes) {
#pragma unroll
        for (int t = 0; t < RATE; ++t) {
            if (t < s.out_lanes) s.out_lo[row * s.out_lanes + t] = a[t];
        }
        return;
    }
    Sampler smp;
    for (long long blk = 0; blk < s.max_squeeze; ++blk) {
        if (blk) keccak_f1600(a, s.rounds);
#pragma unroll
        for (int t = 0; t < RATE; ++t) smp.feed(s, row, a[t], true);
        if (smp.done(s)) break;
    }
    smp.zero_tail(s, row);
}

}  // namespace

// head: [batch, head_lanes] lanes. body_lo/body_hi: limb planes of the
// body's field elements (body_limbs of them, 0 for no body), row stride
// body_stride, body_lanes = elements * body_limbs, starting at byte
// body_off of a msg_len-byte message. out_lanes > 0: out_lo is
// [batch, out_lanes]; else sampling into out_lo (and out_hi when limbs
// is 2), each [batch, length].
extern "C" int keccak_sponge_launch(const void* head, int head_lanes, const void* body_lo,
                                    const void* body_hi, long long body_stride, long long body_lanes,
                                    int body_limbs, long long body_off, long long msg_len, int out_lanes,
                                    int length, int limbs, unsigned long long p_lo,
                                    unsigned long long p_hi, void* out_lo, void* out_hi, long long batch,
                                    int rounds, void* stream) {
    if (batch <= 0) return 0;
    Sponge s;
    s.head = (const uint64_t*)head;
    s.head_lanes = head_lanes;
    s.body_lo = (const uint64_t*)body_lo;
    s.body_hi = (const uint64_t*)body_hi;
    s.body_stride = body_stride;
    s.body_lanes = body_limbs ? body_lanes : 0;
    s.body_limbs = body_limbs;
    s.body_base = body_off / 8;
    s.body_shift = (int)(8 * (body_off % 8));
    s.pad_lane = msg_len / 8;
    s.pad_word = 0x1FULL << (8 * (msg_len % 8));
    s.n_blocks = msg_len / (8 * RATE) + 1;
    s.out_lanes = out_lanes;
    s.length = length;
    s.limbs = limbs;
    s.max_squeeze = ((long long)(length + 2 * WINDOW) * limbs + RATE - 1) / RATE;
    s.p_lo = p_lo;
    s.p_hi = p_hi;
    s.out_lo = (uint64_t*)out_lo;
    s.out_hi = (uint64_t*)out_hi;
    s.batch = batch;
    s.rounds = rounds;
    keccak_sponge_kernel<<<(unsigned int)((batch + 31) / 32), 32, 0, (cudaStream_t)stream>>>(s);
    return (int)cudaGetLastError();
}
