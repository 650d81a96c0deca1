"""The limb contraction's decomposition and recombination: CUDA kernel (csrc/limb_contract.cu) and plain versions.

Replaces janus_tpu/ops/limbmm.py:64 `decompose7` and the recombination of
:95 `fold_contract` (the diagonal groups, the carries and :83
`_reduce_limbs`), which XLA compiles around the MXU's product in
janus_tpu's jitted step: not Pallas kernels. The port's ops/limbmm.py
`fold_contract` is `decompose7` twice, one torch.bmm in float64 and
`recombine`, which call the entries here on the card; their eager
versions (limbmm.py's `decompose7_plain`, `recombine_plain`) are the
plain versions.

What bounds it on the H100: bytes. decompose7 writes 8 bytes a 7-bit limb
(152 bytes a Field128 element) against a few instructions a limb;
recombine reads the product's 19 x 19 float64 column sums of an output
element (2,888 bytes) against ~800 instructions. A thread takes one
element: decompose7 reads it through its strides and writes its limbs
along the new axis, `inner` elements apart, so a warp's stores are
contiguous; recombine walks the product's rows along c, neighbouring
threads on neighbouring columns. The product itself stays torch.bmm, a
plain matrix product janus_tpu leaves to XLA; an int8 tensor-core
contraction is future work.

Both entries count on `limb_contract`. Dispatch is by device, in the
callers (field_cuda.on_card): CUDA tensors come here, which launches the
kernel or raises (CPU tensors raise: they take the plain versions);
operands on two devices raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .field_cuda import MAX_RANK, c_array, cuda_operands, field_consts, limb_ptrs, limb_rows, merge_axes, stream_of

NLIMB = {1: 10, 2: 19}  # 7-bit limbs an element, by 64-bit limb count


# the kernel's launch count, which every entry adds to
limb_contract = cuda_build.LaunchCount("limb_contract")


def decompose_geometry(shape, strides, dim: int, nl: int):
    """(the result's shape, the elements after the limb axis, the
    value's merged axes, each limb's strides along them) of decompose7."""
    dim = dim % (len(shape) + 1)
    inner = 1
    for d in shape[dim:]:
        inner *= d
    mshape, mst = merge_axes(shape, strides)
    return shape[:dim] + (nl,) + shape[dim:], inner, mshape, mst


def _fn(name: str):
    fn = getattr(cuda_build.load("limb_contract"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            "decompose7_launch": [i, i, p, p, i, ll, p, p, p, ll, p],
            "recombine_launch": [i, p, p, ll, ll, p, p, ll, p],
        }[name]
        fn.restype = ctypes.c_int
    return fn


def decompose7(tf, v, dim: int):
    """Field value (any shape S) -> float64 tensor of its 7-bit limbs,
    little-endian, on a new axis of NLIMB[tf.LIMBS] at `dim`."""
    if len(v) != tf.LIMBS:
        raise ValueError(f"decompose7: a {tf.LIMBS}-limb value")
    device = cuda_operands("decompose7", list(v))
    nl = NLIMB[tf.LIMBS]
    out_shape, inner, mshape, mst = decompose_geometry(tuple(v[0].shape), [x.stride() for x in v], dim, nl)
    out = torch.empty(out_shape, dtype=torch.float64, device=device)
    total = v[0].numel()
    if total == 0:
        return out
    rank = len(mshape)
    if rank > MAX_RANK:
        raise ValueError(f"decompose7: {rank} axes after merging, more than {MAX_RANK}")
    rows = limb_rows(tf, mst, rank, 1)[:2]
    with torch.cuda.device(device):
        rc = _fn("decompose7_launch")(
            tf.LIMBS, rank, c_array(mshape), c_array([s for row in rows for s in row]), nl, inner,
            *limb_ptrs(tf, v, 1)[:2], out.data_ptr(), total, stream_of(device),
        )
    cuda_build.check(rc, "limb_contract")
    cuda_build.count_launch(limb_contract)
    return out


def recombine(tf, acc, W: int, C: int):
    """acc: float64 [b, W * nl, nl * C], the exact product of the two
    decompositions (rows (w, l1), columns (l2, c)) -> the reduced field
    value [b, W, C] of sum_{l1, l2} 2^(7 (l1 + l2)) acc[b, (w, l1), (l2, c)]."""
    nl = NLIMB[tf.LIMBS]
    device = cuda_operands("recombine", [acc], torch.float64)
    if acc.dim() != 3 or acc.shape[1:] != (W * nl, nl * C):
        raise ValueError(f"recombine: a float64 [b, {W * nl}, {nl * C}] product wanted, not {tuple(acc.shape)}")
    b = acc.shape[0]
    acc = acc.contiguous()  # torch.bmm's result already is
    outs = tuple(torch.empty((b, W, C), dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    total = b * W * C
    if total == 0:
        return outs
    with torch.cuda.device(device):
        rc = _fn("recombine_launch")(
            tf.LIMBS, field_consts(), acc.data_ptr(), W, C, *limb_ptrs(tf, outs, 1)[:2], total, stream_of(device),
        )
    cuda_build.check(rc, "limb_contract")
    cuda_build.count_launch(limb_contract)
    return outs
