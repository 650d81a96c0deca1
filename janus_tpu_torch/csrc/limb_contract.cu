// The limb contraction as one fused kernel on the int8 tensor cores, for sm_90a (Hopper).
//
// Replaces janus_tpu/ops/limbmm.py:95 `fold_contract` (with :64
// `decompose7` and :83 `_reduce_limbs`), which XLA compiles into
// janus_tpu's jitted step around the MXU's int8 x int8 -> int32 product:
// not a Pallas kernel.
//
//   out[b, i, c] = sum_p w[b, i, p] X[b, p, c]   (mod p)
//
// w [b, W, calls] and X [b, calls, C] are Field64 (1 word an element) or
// Field128 (2 words) limb tensors, each read through its own strides (the
// streamed query passes a tile of w and a reshaped tile of X): nothing is
// copied. The result is a new contiguous [b, W, C].
//
// Method. An element's little-endian bytes are its limbs (NB = 8 a word):
// x = sum_l X_l 2^(8l), w = sum_l W_l 2^(8l), 0 <= X_l, W_l < 2^8, so
//
//   sum_p w x = sum_s 2^(8s) col[s],   col[s] = sum_p sum_l2 X_l2 W_(s - l2)
//
// with s < 2 NB - 1 diagonals. col is one u8 x u8 -> s32 matrix product:
// rows c, columns (w, s), and K = (p, l2), the element's bytes in memory
// order. So the A operand is X as it lies (a fragment register is one
// 32-bit word of an element, loaded straight from device memory), and the
// B operand is w's bytes in a Toeplitz layout, B[(p, l2), (w, s)] =
// W_(s - l2) (0 outside 0..NB-1), which the block builds per chunk of
// calls in shared memory from each weight's reversed, zero-padded bytes.
// The accumulators are the diagonal sums themselves: no cut into limbs,
// no transpose, no diagonal pass. janus_tpu cuts 7-bit limbs because the
// TPU's MXU multiplies signed int8 only; mma.sync takes unsigned bytes.
// An s32 entry is exact while calls x NB x 255^2 < 2^31: every 2^11
// calls (a segment) the four lanes that hold an output's diagonals carry
// them at bit 8s into 5 (Field64: 3) 64-bit words, add them by warp
// shuffles, and one of them keeps the sum, so any calls < 2^30 is exact.
// After the last segment that lane reduces its sum by field_ops.cuh, as
// the plain version's recombination does (ops/limbmm.py
// `recombine_plain`): the canonical element, bit for bit.
//
// Bound on the H100: bytes. At the SumVec(1000, 16) step, X [1024, 127,
// 126] and w [1024, 2, 127] in, [1024, 2, 126] out: 270.5 MB, 0.0807 ms at
// 3.35 TB/s; the product is 2 x 1024 x 128 x 2048 x 64 = 34.4 G int8
// operations (padded), 0.017 ms at 1,979 Tops/s. Design: a 256-thread
// block takes one report, a w-group of 2 rows and 128 columns; warp i
// takes columns 16i..16i+15 (an m16 tile) against all (w, s) columns (8
// n8 tiles, 4 for Field64), mma.sync.m16n8k32 through inline PTX. The
// calls go in chunks of 4 k-steps (8 calls, Field64 16), double-buffered:
// while the warps multiply chunk n (its A fragments in registers, its B
// fragments in shared memory), chunk n + 1's A fragments are in flight
// from device memory (16 KB a block) and its B fragments are being built,
// one block barrier a chunk. The padded weights of 256 calls at a time
// stay in shared memory.
//
// Plain C interface, loaded with ctypes: the launch returns its CUDA error
// (0 on success).

#include "field_ops.cuh"

#define LC_THREADS 256
#define LC_CT 128           // columns c a block: 8 warps x an m16 tile
#define LC_KS 4             // k-steps a chunk
#define LC_WG 2             // w rows a block
#define LC_ZWIN 256         // calls whose padded weights shared memory holds at once
#define LC_SEG_CALLS 2048   // calls a segment: 2^11 x 16 x 255^2 < 2^31
#define LC_MAX_CALLS (1LL << 30)

template <int LIMBS>
struct Lc {
    static constexpr int NB = 8 * LIMBS;             // byte limbs an element
    static constexpr int CPK = 32 / NB;              // calls a k-step
    static constexpr int KS = LC_KS;                 // k-steps a chunk
    static constexpr int KC = KS * CPK;              // calls a chunk (a divisor of LC_ZWIN and LC_SEG_CALLS)
    static constexpr int NSP = 2 * NB;               // diagonals a w row, padded (the last is 0)
    static constexpr int NT = LC_WG * NSP / 8;       // n8 tiles
    static constexpr int NW = LIMBS == 2 ? 5 : 3;    // 64-bit words of an output's unreduced sum
    static constexpr int ZW = 3 * NB / 4;            // words of a weight's padded reversed bytes
    static constexpr int B_WORDS = KS * NT * 32 * 2;     // a chunk's B fragments
    static constexpr int Z_WORDS = LC_WG * LC_ZWIN * ZW;  // a window's padded weights
    static constexpr int SMEM = 4 * (2 * B_WORDS + Z_WORDS);
    // k-steps apart of one thread's B fragment entries (warps sharing an n-tile)
    static constexpr int BK = LC_THREADS / 32 / NT > 0 ? LC_THREADS / 32 / NT : 1;
};

// the strides, in elements, of w's limbs along (b, w, p) and X's along (b, p, c)
struct LcStrides {
    long long w[2][3];
    long long x[2][3];
};

// byte-reverse a 32-bit word
__device__ __forceinline__ uint32_t brev8(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// d += a (16 x 32 u8, row) * b (32 x 8 u8, col), s32
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// v (NW words) += x << bit (x < 2^40, 0 <= bit < 64) at word `word`
template <int NW>
__device__ __forceinline__ void add_shifted(u64 (&v)[NW], u64 x, int word, int bit) {
    u64 add[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) add[i] = 0;
    add[word] = x << bit;
    if (bit > 0 && word + 1 < NW) add[word + 1] = x >> (64 - bit);
    u64 c = 0;
#pragma unroll
    for (int i = 0; i < NW; ++i) v[i] = adc(v[i], add[i], c, c);
}

template <int LIMBS>
struct LcBlock {
    using L = Lc<LIMBS>;
    static constexpr int NB = L::NB, CPK = L::CPK, KS = L::KS, KC = L::KC, NSP = L::NSP, NT = L::NT, NW = L::NW,
                         ZW = L::ZW;

    int b, c0, r0w, W, calls, C;
    const LcStrides* st;  // the kernel's parameter, read in place
    const u64* ws[2];
    int tid, lane, warp, g, t;
    uint32_t* sz;
    // A fragment r of a k-step: 32-bit word of element (p = CPK ks + acall[r >> 1], c = c0 + 16 warp + g +
    // 8 (r & 1)) at K offset kk = 16 (r >> 1) + 4t of the k-step (kk % NB, so the limb and word, is the same for
    // both halves)
    const uint32_t* abase[2];
    long long astep;
    int acall[2];
    bool acol[2];
    int jb, ks0, wib, sb;  // this thread's B fragment entries: n-tile jb, k-steps ks0, ks0 + BK, ...

    // the chunk's A fragments
    __device__ __forceinline__ void load_a(uint32_t (&af)[KS][4], int ch) const {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int p = ch * KC + CPK * ks + acall[r >> 1];
                af[ks][r] = (acol[r & 1] && p < calls) ? __ldg(abase[r & 1] + (long long)p * astep) : 0u;
            }
    }

    // the padded reversed weights of calls [p0, p0 + LC_ZWIN): NB zero bytes, the bytes last first, NB zero bytes
    __device__ __forceinline__ void load_z(int p0) const {
        for (int q = tid; q < LC_WG * LC_ZWIN; q += LC_THREADS) {
            const int wi = q / LC_ZWIN, pl = q % LC_ZWIN;
            const int row = r0w + wi, p = p0 + pl;
            const bool in = row < W && p < calls;
            uint32_t* z = sz + q * ZW + NB / 4;
#pragma unroll
            for (int l = 0; l < LIMBS; ++l) {
                const u64 v = in ? ws[l][(long long)b * st->w[l][0] + (long long)row * st->w[l][1] +
                                         (long long)p * st->w[l][2]]
                                 : 0ULL;
                z[2 * (LIMBS - 1 - l)] = brev8((uint32_t)(v >> 32));
                z[2 * (LIMBS - 1 - l) + 1] = brev8((uint32_t)v);
            }
        }
    }

    // the chunk's B fragments: entry (ks, n-tile, lane) word h holds, byte i, W_(s - l2 - i) of w[wi][p], column
    // (wi, s) = divmod(8 n-tile + g, NSP), K offset kb = 16h + 4t: p = CPK ks + kb / NB, l2 = kb % NB
    __device__ __forceinline__ void build_b(uint2* sbf, int ch) const {
        const int pw = (ch * KC) % LC_ZWIN;  // the chunk's first call in the window
#pragma unroll
        for (int ks = ks0; ks < KS; ks += L::BK) {
            uint32_t bw[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int kb = 16 * h + 4 * t;
                const int off = 2 * NB - 1 - sb + kb % NB;  // byte offset of W_(s - l2) in the padded row
                const uint32_t* z = sz + (wib * LC_ZWIN + pw + CPK * ks + kb / NB) * ZW;
                bw[h] = __funnelshift_r(z[off >> 2], z[(off >> 2) + 1], 8 * (off & 3));
            }
            sbf[(ks * NT + jb) * 32 + lane] = make_uint2(bw[0], bw[1]);
        }
    }

    __device__ __forceinline__ void mma_chunk(int (&acc)[NT][4], const uint32_t (&af)[KS][4], const uint2* sbf,
                                              int ch) const {
        const int left = calls - ch * KC;
        const int ksteps = ((left < KC ? left : KC) + CPK - 1) / CPK;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            if (ks < ksteps) {
#pragma unroll
                for (int j = 0; j < NT; ++j) {
                    const uint2 bv = sbf[(ks * NT + j) * 32 + lane];
                    const uint32_t bfr[2] = {bv.x, bv.y};
                    mma_u8(acc[j], af[ks], bfr);
                }
            }
        }
    }

    // the segment's diagonals into the 64-bit sums: output o = 2 half + wi (rows c + 8 half, w row wi) is summed
    // over the 4 lanes that hold its diagonals s = 8 jj + 2t + e, and lane t == o keeps it
    __device__ __forceinline__ void flush(int (&acc)[NT][4], u64 (&mine)[NW]) const {
#pragma unroll
        for (int o = 0; o < 4; ++o) {
            const int half = o >> 1, wi = o & 1;
            u64 v[NW];
#pragma unroll
            for (int i = 0; i < NW; ++i) v[i] = 0;
#pragma unroll
            for (int jj = 0; jj < NSP / 8; ++jj) {
                const int j = wi * (NSP / 8) + jj;
                const u64 pair = (u64)(unsigned)acc[j][2 * half] + ((u64)(unsigned)acc[j][2 * half + 1] << 8);
                add_shifted<NW>(v, pair, jj, 16 * t);
            }
#pragma unroll
            for (int m = 1; m < 4; m <<= 1) {
                u64 u[NW], cy = 0;
#pragma unroll
                for (int i = 0; i < NW; ++i) u[i] = __shfl_xor_sync(0xffffffffu, v[i], m);
#pragma unroll
                for (int i = 0; i < NW; ++i) v[i] = adc(v[i], u[i], cy, cy);
            }
            if (t == o) {
                u64 cy = 0;
#pragma unroll
                for (int i = 0; i < NW; ++i) mine[i] = adc(mine[i], v[i], cy, cy);
            }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[j][r] = 0;
    }

    // chunk ch's MMAs, with chunk ch + 1's A fragments and B fragments loaded and built meanwhile
    __device__ __forceinline__ void step(int ch, int nchunks, int (&acc)[NT][4], u64 (&mine)[NW],
                                         const uint32_t (&cur)[KS][4], uint32_t (&nxt)[KS][4], const uint2* bcur,
                                         uint2* bnxt) const {
        if (ch + 1 < nchunks) {
            if ((ch + 1) * KC % LC_ZWIN == 0) {
                load_z((ch + 1) * KC);  // every table of the last window is built (the last step's sync)
                __syncthreads();
            }
            load_a(nxt, ch + 1);
            build_b(bnxt, ch + 1);
        }
        mma_chunk(acc, cur, bcur, ch);
        if ((ch + 1) * KC % LC_SEG_CALLS == 0 || ch + 1 == nchunks) flush(acc, mine);
        __syncthreads();  // chunk ch + 1's B fragments are in; chunk ch's are read
    }
};

template <int LIMBS>
__global__ void __launch_bounds__(LC_THREADS, 2) fold_contract_kernel(
    FieldConsts k, int batch, int W, int calls, int C, int n_ct, const __grid_constant__ LcStrides st,
    const u64* __restrict__ w0, const u64* __restrict__ w1, const u64* __restrict__ x0, const u64* __restrict__ x1,
    u64* __restrict__ o0, u64* __restrict__ o1) {
    using L = Lc<LIMBS>;
    constexpr int NB = L::NB, KS = L::KS, NSP = L::NSP, NT = L::NT, NW = L::NW;
    extern __shared__ __align__(16) uint32_t lc_smem[];
    uint2* sbf0 = reinterpret_cast<uint2*>(lc_smem);  // [ks][n-tile][lane] B fragments, two chunks
    uint2* sbf1 = sbf0 + L::B_WORDS / 2;

    int blk = blockIdx.x;
    const int c0 = (blk % n_ct) * LC_CT;
    blk /= n_ct;
    const int b = blk % batch;
    LcBlock<LIMBS> B{b, c0, (blk / batch) * LC_WG, W, calls, C, &st, {w0, w1}};
    B.tid = threadIdx.x;
    B.lane = B.tid & 31;
    B.warp = B.tid >> 5;
    B.g = B.lane >> 2;
    B.t = B.lane & 3;
    B.sz = lc_smem + 2 * L::B_WORDS;
    const int t = B.t, g = B.g, warp = B.warp;
    const int limb = (4 * t % NB) / 8, word = (4 * t % 8) / 4;
    const u64* xl = limb ? x1 : x0;
    const long long xsb = limb ? st.x[1][0] : st.x[0][0], xsp = limb ? st.x[1][1] : st.x[0][1],
                    xsc = limb ? st.x[1][2] : st.x[0][2];  // b * xsb, c * xsc: 64-bit products
    B.acall[0] = 4 * t / NB;
    B.acall[1] = (16 + 4 * t) / NB;
    B.astep = 2 * xsp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int c = c0 + 16 * warp + g + 8 * h;
        B.acol[h] = c < C;
        B.abase[h] = reinterpret_cast<const uint32_t*>(xl + b * xsb + (B.acol[h] ? c : 0) * xsc) + word;
    }
    B.jb = warp % NT;
    B.ks0 = warp / NT;
    B.wib = (8 * B.jb + g) / NSP;
    B.sb = (8 * B.jb + g) % NSP;

    for (int i = B.tid; i < L::Z_WORDS; i += LC_THREADS) B.sz[i] = 0;
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[j][r] = 0;
    u64 mine[NW];  // this lane's output's 64-bit sum
#pragma unroll
    for (int i = 0; i < NW; ++i) mine[i] = 0;
    uint32_t af0[KS][4], af1[KS][4];

    const int nchunks = (calls + L::KC - 1) / L::KC;
    __syncthreads();  // the weights' zero padding is in before any weight is written
    if (nchunks > 0) {
        B.load_z(0);
        B.load_a(af0, 0);
        __syncthreads();
        B.build_b(sbf0, 0);
        __syncthreads();
    }
    for (int ch = 0; ch < nchunks; ch += 2) {
        B.step(ch, nchunks, acc, mine, af0, af1, sbf0, sbf1);
        if (ch + 1 < nchunks) B.step(ch + 1, nchunks, acc, mine, af1, af0, sbf1, sbf0);
    }

    // lane t of group g holds output o = t: rows c + 8 (t >> 1), w row t & 1
    const int c = c0 + 16 * warp + g + 8 * (t >> 1), row = B.r0w + (t & 1);
    if (c < C && row < W) {
        const long long e = ((long long)b * W + row) * C + c;
        if constexpr (LIMBS == 1) {
            o0[e] = f64_reduce_wide(mine[0], f64_reduce_wide(mine[1], mine[2], k), k);
        } else {
            const u64 in5[5] = {mine[0], mine[1], mine[2], mine[3], mine[4]};
            u64 r[6];
            f128_fold<3>(in5, r);
            Fe x = f128_reduce256(r[0], r[1], r[2], r[3], k);
            o0[e] = x.lo;
            o1[e] = x.hi;
        }
    }
}

template <int LIMBS>
static cudaError_t launch(unsigned blocks, cudaStream_t s, const FieldConsts& k, int batch, int W, int calls, int C,
                          int n_ct, const LcStrides& st, const void* w0,
                          const void* w1, const void* x0, const void* x1, void* o0, void* o1) {
    cudaError_t err = cudaFuncSetAttribute(fold_contract_kernel<LIMBS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Lc<LIMBS>::SMEM);
    if (err != cudaSuccess) return err;
    fold_contract_kernel<LIMBS><<<blocks, LC_THREADS, Lc<LIMBS>::SMEM, s>>>(
        k, batch, W, calls, C, n_ct, st, (const u64*)w0, (const u64*)w1, (const u64*)x0, (const u64*)x1, (u64*)o0,
        (u64*)o1);
    return cudaGetLastError();
}

// w: [batch, W, calls], X: [batch, calls, C] limb tensors; strides[12]:
// w.lo's along (b, w, p), w.hi's, X.lo's along (b, p, c), X.hi's (Field64:
// the hi rows 0); out: contiguous [batch, W, C] limbs
extern "C" int fold_contract_launch(int limbs, const unsigned long long* consts, long long batch, long long W,
                                    long long calls, long long C, const long long* strides, const void* w0,
                                    const void* w1, const void* x0, const void* x1, void* o0, void* o1,
                                    void* stream) {
    if ((limbs != 1 && limbs != 2) || batch <= 0 || W <= 0 || C <= 0 || calls < 0 || calls >= LC_MAX_CALLS ||
        batch > 0x7FFFFFFFLL || W > 0x7FFFFFFFLL || C > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const long long n_ct = (C + LC_CT - 1) / LC_CT;
    const long long blocks = n_ct * batch * ((W + LC_WG - 1) / LC_WG);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    LcStrides st;
    for (int l = 0; l < 2; ++l)
        for (int a = 0; a < 3; ++a) {
            st.w[l][a] = strides[l * 3 + a];
            st.x[l][a] = strides[6 + l * 3 + a];
        }
    FieldConsts k = field_consts(consts);
    cudaStream_t s = (cudaStream_t)stream;
    const int ib = (int)batch, iw = (int)W, ic = (int)calls, iC = (int)C, in = (int)n_ct;
    return (int)(limbs == 1 ? launch<1>((unsigned)blocks, s, k, ib, iw, ic, iC, in, st, w0, w1, x0, x1, o0, o1)
                            : launch<2>((unsigned)blocks, s, k, ib, iw, ic, iC, in, st, w0, w1, x0, x1, o0, o1));
}
