// Elementwise Field64 / Field128 arithmetic, one launch an op, for sm_90a (Hopper).
//
// Replaces the elementwise field ops that XLA fuses into janus_tpu's jitted
// step (not Pallas kernels): janus_tpu/fields/jfield.py JF64 (:170; add
// :178, sub :186, neg :194, mul :199), JF128 (:277; add :285, sub :306,
// neg :317, mul :325) and fmul_pow2 (:359). In the port each of those was
// 26 to 589 eager int64 PyTorch ops (tfield.py), so a SumVec step launched
// tens of thousands of tiny kernels; here an op is one launch.
//
//   out = a + b, a - b, -a, a * b or a * 2^k   (mod p), elementwise
//
// a and b are limb tensors (1 word a Field64 element, 2 a Field128 one) of
// any shapes that broadcast, each limb read through its own strides
// (stride 0 on a broadcast axis): the step passes strided slices, [b, n]
// against [b, 1], NTT-stage views against twiddle rows and 0-d constants.
// The result is a new contiguous tensor of the broadcast shape.
//
// Bound on the H100: bytes for add, sub, neg and mul_pow2 (16-48 B moved
// against 10-60 integer instructions an element); a Field128 mul is about
// 150 32-bit instructions (four 64x64 products, three folds) against 48 B,
// near the balance of 16.7 Tops/s and 3.35 TB/s. The design: one thread an
// output element, the index split into each tensor's offset by the merged
// axes the wrapper passes (1-3 after merging, for the step's operands),
// 32-bit index arithmetic where the element count allows.
//
// Plain C interface, loaded with ctypes: the launch returns the CUDA error
// of the launch (0 on success).

#include "field_ops.cuh"

enum { OP_ADD = 0, OP_SUB = 1, OP_NEG = 2, OP_MUL = 3, OP_MUL_POW2 = 4 };

template <typename I, int LIMBS, int OP>
__global__ void __launch_bounds__(256) field_arith_kernel(Geo g, FieldConsts k, int s, const u64* __restrict__ a0,
                                                          const u64* __restrict__ a1, const u64* __restrict__ b0,
                                                          const u64* __restrict__ b1, u64* __restrict__ o0,
                                                          u64* __restrict__ o1, I n) {
    for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < n; idx += (I)gridDim.x * blockDim.x) {
        long long off[4];
        geo_offsets<I, 4>(g, idx, off);
        Fe a = fe_load<LIMBS>(a0, a1, off[0], off[1]);
        Fe r;
        if (OP == OP_NEG) {
            r = fe_neg<LIMBS>(a, k);
        } else if (OP == OP_MUL_POW2) {
            r = fe_mul_pow2<LIMBS>(a, s, k);
        } else {
            Fe b = fe_load<LIMBS>(b0, b1, off[2], off[3]);
            if (OP == OP_ADD) r = fe_add<LIMBS>(a, b, k);
            else if (OP == OP_SUB) r = fe_sub<LIMBS>(a, b, k);
            else r = fe_mul<LIMBS>(a, b, k);
        }
        fe_store<LIMBS>(o0, o1, (long long)idx, r);
    }
}

template <typename I, int LIMBS>
static cudaError_t launch_op(int op, int blocks, cudaStream_t st, const Geo& g, const FieldConsts& k, int s,
                             const u64* a0, const u64* a1, const u64* b0, const u64* b1, u64* o0, u64* o1, I n) {
    switch (op) {
        case OP_ADD:
            field_arith_kernel<I, LIMBS, OP_ADD><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_SUB:
            field_arith_kernel<I, LIMBS, OP_SUB><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_NEG:
            field_arith_kernel<I, LIMBS, OP_NEG><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_MUL:
            field_arith_kernel<I, LIMBS, OP_MUL><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        case OP_MUL_POW2:
            field_arith_kernel<I, LIMBS, OP_MUL_POW2><<<blocks, 256, 0, st>>>(g, k, s, a0, a1, b0, b1, o0, o1, n);
            break;
        default:
            return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
}

// op: OP_*; limbs: 1 or 2; s: the power of two of OP_MUL_POW2; rank <= 8;
// shape[rank]; strides[4][rank] in elements (a.lo, a.hi, b.lo, b.hi; the
// missing ones 0); consts[8] (FieldConsts); n = prod(shape) > 0.
extern "C" int field_arith_launch(int op, int limbs, int s, int rank, const long long* shape, const long long* strides,
                                  const unsigned long long* consts, const void* a0, const void* a1, const void* b0,
                                  const void* b1, void* o0, void* o1, long long n, void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || n <= 0 || (limbs != 1 && limbs != 2)) return (int)cudaErrorInvalidValue;
    Geo g = field_geo(rank, shape, strides, 4);
    FieldConsts k = field_consts(consts);
    cudaStream_t st = (cudaStream_t)stream;
    long long want = (n + 255) / 256;
    int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
    const u64 *pa0 = (const u64*)a0, *pa1 = (const u64*)a1, *pb0 = (const u64*)b0, *pb1 = (const u64*)b1;
    u64 *po0 = (u64*)o0, *po1 = (u64*)o1;
    cudaError_t err;
    if (n < (1LL << 31)) {
        unsigned int n32 = (unsigned int)n;
        err = limbs == 1 ? launch_op<unsigned int, 1>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n32)
                         : launch_op<unsigned int, 2>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n32);
    } else {
        unsigned long long n64 = (unsigned long long)n;
        err = limbs == 1 ? launch_op<unsigned long long, 1>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n64)
                         : launch_op<unsigned long long, 2>(op, blocks, st, g, k, s, pa0, pa1, pb0, pb1, po0, po1, n64);
    }
    return (int)err;
}
