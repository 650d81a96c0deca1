"""The limb contraction as one fused kernel: CUDA kernel (csrc/limb_contract.cu) and its launcher.

Replaces janus_tpu/ops/limbmm.py:95 `fold_contract` (with :64
`decompose7` and :83 `_reduce_limbs`), which XLA compiles around the
MXU's int8 product in janus_tpu's jitted step: not a Pallas kernel. The
port's ops/limbmm.py `fold_contract` calls `fold_contract` here on the
card; its plain version is limbmm.py's `fold_contract_plain`
(`decompose7_plain` twice, a float64 torch.bmm, `recombine_plain`).

What bounds it on the H100: bytes. The kernel reads w [b, W, calls] and
X [b, calls, C] once and writes [b, W, C] once (at the SumVec(1000, 16)
step 270.5 MB, 0.0807 ms); the product of byte limbs on the int8 tensor
cores is a fifth of that in time. The design keeps every limb out of
device memory: an element's bytes are its limbs, so a warp loads X's
words straight into its mma.sync fragments (u8 x u8 -> s32), the block
lays w's bytes out as a Toeplitz operand in shared memory so that the
accumulators are the diagonal sums themselves, and each output's
diagonals are carried and reduced in the same launch (int32 sums
carried into 64-bit words every 2^11 calls, so any calls < 2^30 is
exact). The source's note has the tiling and the pipeline.

One launch a call, counted on `limb_contract`. Dispatch is by device,
in the caller (field_cuda.on_card): CUDA tensors come here, which
launches the kernel or raises (CPU tensors raise: they take the plain
version); operands on two devices raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .field_cuda import c_array, cuda_operands, field_consts, limb_ptrs, stream_of

# the kernel's launch count
limb_contract = cuda_build.LaunchCount("limb_contract")


def contract_geometry(w_shape, w_strides, x_shape, x_strides):
    """(batch, W, calls, C, w's strides along (b, w, p) a limb, X's along
    (b, p, c) a limb) of fold_contract(w [b, W, calls], X [b, calls, C]),
    the stride of every axis of length 1 set to 0 (the kernel never steps
    along it); raises ValueError where the shapes do not pair."""
    if len(w_shape) != 3 or len(x_shape) != 3 or w_shape[0] != x_shape[0] or w_shape[2] != x_shape[1]:
        raise ValueError(f"fold_contract: w {tuple(w_shape)} and X {tuple(x_shape)} are not [b, W, calls] and "
                         "[b, calls, C]")

    def steps(shape, strides):
        return [tuple(0 if n == 1 else s for n, s in zip(shape, st)) for st in strides]

    b, W, calls = (int(n) for n in w_shape)
    return b, W, calls, int(x_shape[2]), steps(w_shape, w_strides), steps(x_shape, x_strides)


def _fn():
    fn = cuda_build.load("limb_contract").fold_contract_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [i, p, ll, ll, ll, ll, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def fold_contract(tf, w, X):
    """out[b, i, c] = sum_p w[b, i, p] X[b, p, c] mod p for field values
    w [b, W, calls] and X [b, calls, C] on the card: a new field value
    [b, W, C], in one launch."""
    if len(w) != tf.LIMBS or len(X) != tf.LIMBS:
        raise ValueError(f"fold_contract: two {tf.LIMBS}-limb values")
    device = cuda_operands("fold_contract", list(w) + list(X))
    b, W, calls, C, wst, xst = contract_geometry(tuple(w[0].shape), [t.stride() for t in w], tuple(X[0].shape),
                                                 [t.stride() for t in X])
    if calls >= 1 << 30:
        raise ValueError(f"fold_contract: {calls} calls, the kernel takes fewer than 2^30")
    outs = tuple(torch.empty((b, W, C), dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    if outs[0].numel() == 0:
        return outs
    pad = [(0, 0, 0)] * (2 - tf.LIMBS)
    strides = [s for row in list(wst) + pad + list(xst) + pad for s in row]
    with torch.cuda.device(device):
        rc = _fn()(
            tf.LIMBS, field_consts(), b, W, calls, C, c_array(strides), *limb_ptrs(tf, w, 1)[:2],
            *limb_ptrs(tf, X, 1)[:2], *limb_ptrs(tf, outs, 1)[:2], stream_of(device),
        )
    cuda_build.check(rc, "limb_contract")
    cuda_build.count_launch(limb_contract)
    return outs
