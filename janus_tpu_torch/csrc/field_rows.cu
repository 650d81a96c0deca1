// Field64 / Field128 row functions: powers, sums and dot products along an axis, for sm_90a (Hopper).
//
// Replaces janus_tpu/ops/ntt.py:147 `powers` and :172 `poly_eval_powers`,
// and janus_tpu/fields/jfield.py:487 `fsum` and :516 `fdot` (with
// aggregate's sum over the batch axis, vdaf/prio3.py:311), which XLA fuses
// into janus_tpu's jitted step: not Pallas kernels. The port ran them as
// eager PyTorch, log-depth doublings and halvings of field muls and adds:
// 5,926 ops for powers(n = 64).
//
//   powers:  out[..., i] = x[...]^i,  i < n             (x^0 = 1, x^1 = x)
//   sum:     out[...] = sum_i a[..., i, ...]            (mod p, one axis)
//   dot:     out[...] = sum_i a[..., i, ...] b[..., i, ...]
//
// Modular addition of reduced elements is exact and commutative, so every
// order of the sum gives the same canonical element, the plain version's
// (ops/ntt.py, fields/tfield.py); x^i is unique too, so square-and-multiply gives the
// plain version's doubling result.
//
// Bound on the H100: bytes for sum (16 B read an element against ~20
// instructions), operations for powers (the function needs a mul an
// element, x^i = x^(i-1) x; square-and-multiply spends ~9, so the kernel
// runs at a few per cent of that bound) and for dot (a mul an element).
// Design: powers, one thread an output
// element, x read through its strides (the step's [b] column slices) and
// raised by its own square-and-multiply, no sequential dependence along
// the row. sum and dot, two modes the wrapper picks from the shape: one
// thread an output element walking the axis where there are many outputs
// (the batch-axis aggregate: neighbouring threads read neighbouring
// columns), one 256-thread block an output element with a shared-memory
// tree where there are few outputs and a long axis.
//
// Plain C interface, loaded with ctypes: a launch returns its CUDA error
// (0 on success).

#include "field_ops.cuh"

template <int LIMBS>
__global__ void powers_kernel(Geo g, FieldConsts k, const u64* __restrict__ x0, const u64* __restrict__ x1,
                              u64* __restrict__ o0, u64* __restrict__ o1, long long n, long long total) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        const long long row = e / n;
        const long long i = e - row * n;
        long long off[2];
        geo_offsets<unsigned long long, 2>(g, (unsigned long long)row, off);
        Fe x = fe_load<LIMBS>(x0, x1, off[0], off[1]);
        fe_store<LIMBS>(o0, o1, e, fe_pow<LIMBS>(x, (unsigned long long)i, k));
    }
}

// g: the output axes with each tensor's strides (a.lo, a.hi, b.lo, b.hi);
// ax[4]: each tensor's stride along the summed axis of length m.
struct Axis {
    long long m;
    long long ax[4];
};

template <int LIMBS, bool DOT>
__device__ __forceinline__ Fe row_term(const Axis& a, const long long (&off)[4], long long i, const u64* a0,
                                       const u64* a1, const u64* b0, const u64* b1, const FieldConsts& k) {
    Fe x = fe_load<LIMBS>(a0, a1, off[0] + i * a.ax[0], off[1] + i * a.ax[1]);
    if (!DOT) return x;
    Fe y = fe_load<LIMBS>(b0, b1, off[2] + i * a.ax[2], off[3] + i * a.ax[3]);
    return fe_mul<LIMBS>(x, y, k);
}

// a thread an output element
template <int LIMBS, bool DOT>
__global__ void reduce_thread_kernel(Geo g, Axis a, FieldConsts k, const u64* __restrict__ a0,
                                     const u64* __restrict__ a1, const u64* __restrict__ b0,
                                     const u64* __restrict__ b1, u64* __restrict__ o0, u64* __restrict__ o1,
                                     long long total) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x) {
        long long off[4];
        geo_offsets<unsigned long long, 4>(g, (unsigned long long)e, off);
        Fe acc{0, 0};
        for (long long i = 0; i < a.m; ++i) acc = fe_add<LIMBS>(acc, row_term<LIMBS, DOT>(a, off, i, a0, a1, b0, b1, k), k);
        fe_store<LIMBS>(o0, o1, e, acc);
    }
}

// a block an output element: strided partial sums, then a tree in shared memory
template <int LIMBS, bool DOT>
__global__ void __launch_bounds__(256) reduce_block_kernel(Geo g, Axis a, FieldConsts k, const u64* __restrict__ a0,
                                                           const u64* __restrict__ a1, const u64* __restrict__ b0,
                                                           const u64* __restrict__ b1, u64* __restrict__ o0,
                                                           u64* __restrict__ o1, long long total) {
    __shared__ u64 s0[256];
    __shared__ u64 s1[256];
    for (long long e = blockIdx.x; e < total; e += gridDim.x) {
        long long off[4];
        geo_offsets<unsigned long long, 4>(g, (unsigned long long)e, off);
        Fe acc{0, 0};
        for (long long i = threadIdx.x; i < a.m; i += blockDim.x)
            acc = fe_add<LIMBS>(acc, row_term<LIMBS, DOT>(a, off, i, a0, a1, b0, b1, k), k);
        s0[threadIdx.x] = acc.lo;
        s1[threadIdx.x] = acc.hi;
        __syncthreads();
        for (int w = blockDim.x / 2; w > 0; w >>= 1) {
            if (threadIdx.x < w) {
                Fe r = fe_add<LIMBS>(Fe{s0[threadIdx.x], s1[threadIdx.x]}, Fe{s0[threadIdx.x + w], s1[threadIdx.x + w]}, k);
                s0[threadIdx.x] = r.lo;
                s1[threadIdx.x] = r.hi;
            }
            __syncthreads();
        }
        if (threadIdx.x == 0) fe_store<LIMBS>(o0, o1, e, Fe{s0[0], s1[0]});
        __syncthreads();
    }
}

static int grid_for(long long total, int threads) {
    long long want = (total + threads - 1) / threads;
    return (int)(want < 132LL * 64 ? want : 132LL * 64);
}

// x: rank axes shape[rank], strides[2][rank]; out [prod(shape), n] contiguous
extern "C" int powers_launch(int limbs, int rank, const long long* shape, const long long* strides,
                             const unsigned long long* consts, const void* x0, const void* x1, void* o0, void* o1,
                             long long n, long long total, void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || total <= 0 || n <= 0 || (limbs != 1 && limbs != 2))
        return (int)cudaErrorInvalidValue;
    Geo g = field_geo(rank, shape, strides, 2);
    FieldConsts k = field_consts(consts);
    cudaStream_t st = (cudaStream_t)stream;
    if (limbs == 1)
        powers_kernel<1><<<grid_for(total, 256), 256, 0, st>>>(g, k, (const u64*)x0, (const u64*)x1, (u64*)o0,
                                                               (u64*)o1, n, total);
    else
        powers_kernel<2><<<grid_for(total, 256), 256, 0, st>>>(g, k, (const u64*)x0, (const u64*)x1, (u64*)o0,
                                                               (u64*)o1, n, total);
    return (int)cudaGetLastError();
}

template <int LIMBS, bool DOT>
static void launch_reduce(int block_mode, cudaStream_t st, const Geo& g, const Axis& a, const FieldConsts& k,
                          const u64* a0, const u64* a1, const u64* b0, const u64* b1, u64* o0, u64* o1,
                          long long total) {
    if (block_mode) {
        int blocks = (int)(total < 132LL * 64 ? total : 132LL * 64);
        reduce_block_kernel<LIMBS, DOT><<<blocks, 256, 0, st>>>(g, a, k, a0, a1, b0, b1, o0, o1, total);
    } else {
        reduce_thread_kernel<LIMBS, DOT><<<grid_for(total, 128), 128, 0, st>>>(g, a, k, a0, a1, b0, b1, o0, o1, total);
    }
}

// dot: 0 (sum of a) or 1 (sum of a * b); the output's rank axes shape[rank]
// with strides[4][rank] (a.lo, a.hi, b.lo, b.hi); the summed axis's length
// m and each tensor's stride along it, axis_strides[4]; out contiguous of
// total elements; block_mode: 0 a thread an output, 1 a block an output.
extern "C" int reduce_launch(int limbs, int dot, int block_mode, int rank, const long long* shape,
                             const long long* strides, long long m, const long long* axis_strides,
                             const unsigned long long* consts, const void* a0, const void* a1, const void* b0,
                             const void* b1, void* o0, void* o1, long long total, void* stream) {
    if (rank < 0 || rank > FIELD_MAX_RANK || total <= 0 || m < 0 || (limbs != 1 && limbs != 2))
        return (int)cudaErrorInvalidValue;
    Geo g = field_geo(rank, shape, strides, 4);
    Axis a;
    a.m = m;
    for (int t = 0; t < 4; ++t) a.ax[t] = axis_strides[t];
    FieldConsts k = field_consts(consts);
    cudaStream_t st = (cudaStream_t)stream;
    const u64 *pa0 = (const u64*)a0, *pa1 = (const u64*)a1, *pb0 = (const u64*)b0, *pb1 = (const u64*)b1;
    u64 *po0 = (u64*)o0, *po1 = (u64*)o1;
    if (limbs == 1) {
        if (dot) launch_reduce<1, true>(block_mode, st, g, a, k, pa0, pa1, pb0, pb1, po0, po1, total);
        else launch_reduce<1, false>(block_mode, st, g, a, k, pa0, pa1, pb0, pb1, po0, po1, total);
    } else {
        if (dot) launch_reduce<2, true>(block_mode, st, g, a, k, pa0, pa1, pb0, pb1, po0, po1, total);
        else launch_reduce<2, false>(block_mode, st, g, a, k, pa0, pa1, pb0, pb1, po0, po1, total);
    }
    return (int)cudaGetLastError();
}
