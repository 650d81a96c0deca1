"""Elementwise Field64/Field128 arithmetic: CUDA kernel (csrc/field_arith.cu) and plain version.

Replaces the field ops that XLA fuses into janus_tpu's jitted step, not
Pallas kernels: janus_tpu/fields/jfield.py JF64 (:170: add :178, sub :186,
neg :194, mul :199), JF128 (:277: add :285, sub :306, neg :317, mul :325)
and fmul_pow2 (:359). The port's TF64/TF128 methods and fmul_pow2
(fields/tfield.py) call `elementwise` on the card; their eager bodies are
the plain version (TF64's and TF128's `add_plain`, `sub_plain`,
`neg_plain` and `mul_plain`, and `fmul_pow2_plain`), 26 to 589 int64
PyTorch ops an op, which a SumVec step once ran tens of thousands of.

What bounds it on the H100: bytes for add, sub, neg and mul_pow2, about
balanced for a Field128 mul (~150 32-bit instructions against 48 bytes an
element). The kernel does one launch an op, a thread an output element,
and reads each limb tensor through its own strides, a broadcast axis as
stride 0 (`launch_geometry`), so the step's strided slices, [b, n] x
[b, 1] operands, NTT-stage views and 0-d constants cost no copy. The
result is a new contiguous tensor of the broadcast shape, as the plain
version's torch.where gives it.

A second entry, `pow2_weighted_sum`, fuses the truncation's chain
(janus_tpu/vdaf/engine.py:374 `_pow2_weighted_sum`: bits - 1 fmul_pow2
and as many adds, which XLA fuses into one loop) into one launch: a
block stages 128 outputs' inputs in shared memory (a warp reading 256
contiguous bytes where the summed axis is contiguous, as at every step
layout), then a thread an output shifts its inputs into an unreduced sum
and reduces once, writing no intermediate. Bytes bound it too; its plain
version is fields/tfield.py's `fpow2_weighted_sum_plain` (the loop of
fmul_pow2_plain and add_plain), and its caller tfield.fpow2_weighted_sum,
which vdaf/engine.py's `_pow2_weighted_sum` calls.

Dispatch is by device, in the callers: `on_card` sends CUDA operands to
`elementwise` or `pow2_weighted_sum`, which launch the kernel (or raise,
as they do for CPU operands), and CPU operands to the plain version.
Operands on two devices raise. Each launch counts on `field_arith`. The
same module holds the launch-geometry helpers (`launch_geometry`,
`merge_axes`, `reduce_geometry`), the device checks and the field
constants (`field_consts`) that the other field kernels' wrappers
(ntt_cuda, rows_cuda, limb_cuda) share.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from . import cuda_build

# csrc/field_ops.cuh FIELD_MAX_RANK: axes a launch takes after merging
MAX_RANK = 8
OPS = {"add": 0, "sub": 1, "neg": 2, "mul": 3, "mul_pow2": 4}
_BINARY = ("add", "sub", "mul")

# the kernel's launch count, which every launch adds to
field_arith = cuda_build.LaunchCount("field_arith")


@lru_cache(maxsize=None)
def field_consts():
    """The kernels' FieldConsts, from the fields' moduli: Field64's p and
    2^64 mod p; Field128's p, 7 * 2^66 and 2^128 mod p = 7 * 2^66 - 1
    (unsigned 64-bit words, lo then hi)."""
    from ..fields.field import Field64, Field128

    p64, p128 = Field64.MODULUS, Field128.MODULUS
    s66m1 = (1 << 128) % p128
    s66 = s66m1 + 1
    mask = (1 << 64) - 1
    words = (p64, (1 << 64) % p64, p128 & mask, p128 >> 64, s66 & mask, s66 >> 64, s66m1 & mask, s66m1 >> 64)
    return (ctypes.c_ulonglong * 8)(*words)


def launch_geometry(shapes, strides):
    """Broadcast operands of `shapes` (with element `strides`, as
    tensor.stride()) against each other: (the output shape, each
    operand's strides along the output's axes, 0 on every axis it
    broadcasts or where the output's size is 1). Raises ValueError where
    the shapes do not broadcast."""
    rank = max((len(s) for s in shapes), default=0)
    out = [1] * rank
    for s in shapes:
        for i, d in enumerate(s):
            ax = rank - len(s) + i
            if d != 1:
                if out[ax] != 1 and out[ax] != d:
                    raise ValueError(f"shapes {[tuple(x) for x in shapes]} do not broadcast")
                out[ax] = d
    per = []
    for s, st in zip(shapes, strides):
        pad = rank - len(s)
        per.append(tuple(0 if ax < pad or s[ax - pad] == 1 or out[ax] == 1 else st[ax - pad] for ax in range(rank)))
    return tuple(out), per


def merge_axes(shape, strides):
    """Drop the axes of size 1 and merge each axis into the one before it
    where every operand steps through both as through one (stride of the
    outer = size x stride of the inner): the same elements at the same
    offsets, in fewer axes. Returns (shape, strides)."""
    merged = []
    for d, n in enumerate(shape):
        if n == 1:
            continue
        sts = [st[d] for st in strides]
        if merged and all(ps == s * n for ps, s in zip(merged[-1][1], sts)):
            merged[-1] = (merged[-1][0] * n, sts)
        else:
            merged.append((n, sts))
    return tuple(n for n, _ in merged), [tuple(m[1][t] for m in merged) for t in range(len(strides))]


def reduce_geometry(shapes, strides, axis: int):
    """The launch geometry of a sum over `axis` of operands broadcast
    against each other: (the output shape, its merged axes, each
    operand's strides along them, the summed length, each operand's
    stride along the summed axis). field_rows' sums and dots and
    field_arith's pow2 sum take it."""
    shape, per = launch_geometry(shapes, strides)
    if not shape:
        raise ValueError("no axis to sum over")
    axis = axis % len(shape)
    out_shape = shape[:axis] + shape[axis + 1:]
    mshape, mst = merge_axes(out_shape, [st[:axis] + st[axis + 1:] for st in per])
    return out_shape, mshape, mst, shape[axis], [st[axis] for st in per]


def check_operands(what: str, tensors, dtype=torch.int64) -> torch.device:
    """The device every tensor lies on; raises ValueError where they lie
    on two, or where a CUDA operand is not of `dtype` (int64 limbs)."""
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{what}: operands on more than one device ({sorted({str(t.device) for t in tensors})})")
    if device.type == "cuda":
        if any(t.dtype != dtype for t in tensors):
            raise ValueError(f"{what}: operands must be {dtype}")
    elif device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {device}")
    return device


def on_card(what: str, tensors, dtype=torch.int64) -> bool:
    """True where the operands lie on one CUDA device (the kernel's
    route), False where they lie on the CPU (the plain version's); raises
    ValueError as check_operands does."""
    return check_operands(what, tensors, dtype).type == "cuda"


def cuda_operands(what: str, tensors, dtype=torch.int64) -> torch.device:
    """The one CUDA device the operands lie on; raises ValueError for any
    other: a kernel's launcher takes no CPU tensor."""
    device = check_operands(what, tensors, dtype)
    if device.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors; CPU ones take the plain version")
    return device


def limb_rows(tf, rows, rank: int, n_values: int) -> list:
    """Each limb tensor's stride row, padded to the kernels' (a.lo, a.hi
    [, b.lo, b.hi]) with zeros for the hi limb Field64 values lack, then
    to four rows."""
    if tf.LIMBS == 1:
        rows = [r for v in range(n_values) for r in (rows[v], (0,) * rank)]
    return list(rows) + [(0,) * rank] * (4 - len(rows))


def limb_ptrs(tf, tensors, n_values: int) -> list:
    """The limb tensors' pointers in the same order, None where a limb is
    missing."""
    ptrs = [t.data_ptr() for t in tensors]
    if tf.LIMBS == 1:
        ptrs = [p for v in range(n_values) for p in (ptrs[v], None)]
    return ptrs + [None] * (4 - len(ptrs))


def c_array(values, ctype=ctypes.c_longlong):
    return (ctype * max(1, len(values)))(*values)


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _lib(name: str = "field_arith_launch"):
    fn = getattr(cuda_build.load("field_arith"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {
            "field_arith_launch": [i, i, i, i, p, p, p, p, p, p, p, p, p, ll, p],
            "pow2_sum_launch": [i, i, p, p, p, i, p, p, p, p, p, ll, p],
        }[name]
        fn.restype = ctypes.c_int
    return fn


def elementwise(op: str, tf, a, b=None, k: int = 0):
    """a op b (add, sub, mul), -a (neg) or a * 2^k (mul_pow2, 0 < k < 64)
    mod p, elementwise over broadcast limb tuples on the card: a new field
    value of the broadcast shape, in one launch."""
    if op not in OPS:
        raise ValueError(f"field_arith: unknown op {op!r}")
    binary = op in _BINARY
    if len(a) != tf.LIMBS or (binary and (b is None or len(b) != tf.LIMBS)):
        raise ValueError(f"field_arith: {op} takes {'two' if binary else 'one'} {tf.LIMBS}-limb value(s)")
    tensors = list(a) + (list(b) if binary else [])
    device = cuda_operands("field_arith", tensors)
    if op == "mul_pow2" and not 0 < k < 64:
        raise ValueError(f"field_arith: mul_pow2 takes 0 < k < 64, not {k}")
    shape, per = launch_geometry([t.shape for t in tensors], [t.stride() for t in tensors])
    outs = tuple(torch.empty(shape, dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    n = outs[0].numel()
    if n == 0:
        return outs
    mshape, mst = merge_axes(shape, per)
    rank = len(mshape)
    if rank > MAX_RANK:
        raise ValueError(f"field_arith: {rank} axes after merging, more than {MAX_RANK}")
    n_values = 2 if binary else 1
    rows = limb_rows(tf, mst, rank, n_values)
    ptrs = limb_ptrs(tf, tensors, n_values)
    with torch.cuda.device(device):
        rc = _lib()(
            OPS[op], tf.LIMBS, k, rank, c_array(mshape), c_array([s for row in rows for s in row]), field_consts(),
            *ptrs, *limb_ptrs(tf, outs, 1)[:2], n, stream_of(device),
        )
    cuda_build.check(rc, "field_arith")
    cuda_build.count_launch(field_arith)
    return outs


def pow2_geometry(shape, strides, axis: int, bits: int):
    """The launch geometry of pow2_weighted_sum over a value's limbs of
    `shape` and `strides`: reduce_geometry's (output shape, merged axes,
    each limb's strides along them, each limb's stride along the summed
    axis); raises ValueError unless 1 <= bits <= min(64, the axis's
    length)."""
    out_shape, mshape, mst, m, axis_st = reduce_geometry([shape] * len(strides), strides, axis)
    if not 1 <= bits <= min(m, 64):
        raise ValueError(f"pow2_weighted_sum: bits {bits} outside 1..min({m}, 64)")
    return out_shape, mshape, mst, axis_st


def pow2_weighted_sum(tf, v, bits: int, axis: int = 1):
    """sum_{i < bits} 2^i v[..., i, ...] along `axis` mod p (1 <= bits <=
    64, v's axis at least bits long) on the card: a new field value of
    v's shape less `axis`, in one launch."""
    if len(v) != tf.LIMBS:
        raise ValueError(f"pow2_weighted_sum: a {tf.LIMBS}-limb value")
    device = cuda_operands("pow2_weighted_sum", list(v))
    out_shape, mshape, mst, axis_st = pow2_geometry(tuple(v[0].shape), [t.stride() for t in v], axis, bits)
    outs = tuple(torch.empty(out_shape, dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    n = outs[0].numel()
    if n == 0:
        return outs
    rank = len(mshape)
    if rank > MAX_RANK:
        raise ValueError(f"pow2_weighted_sum: {rank} axes after merging, more than {MAX_RANK}")
    rows = limb_rows(tf, mst, rank, 1)[:2]
    with torch.cuda.device(device):
        rc = _lib("pow2_sum_launch")(
            tf.LIMBS, rank, c_array(mshape), c_array([s for row in rows for s in row]), field_consts(), bits,
            c_array(list(axis_st) + [0] * (2 - len(axis_st))), *limb_ptrs(tf, v, 1)[:2],
            *limb_ptrs(tf, outs, 1)[:2], n, stream_of(device),
        )
    cuda_build.check(rc, "field_arith")
    cuda_build.count_launch(field_arith)
    return outs
