"""Field powers, sums and dot products along an axis: CUDA kernel (csrc/field_rows.cu) and plain versions.

Replaces what XLA fuses into janus_tpu's jitted step, not Pallas kernels:
janus_tpu/ops/ntt.py:147 `powers` and :172 `poly_eval_powers`,
janus_tpu/fields/jfield.py:487 `fsum` (aggregate's sum over the batch
axis, vdaf/prio3.py:311, among its callers) and :516 `fdot`. The port's
ops/ntt.py `powers` and `poly_eval_powers` and fields/tfield.py `fsum`
and `fdot` call the entries here on the card; their eager bodies are the
plain versions (ntt.py's `powers_plain`, `poly_eval_powers_plain`,
tfield.py's `fsum_plain`, `fdot_plain`): log-depth doublings and halvings
of field ops, 5,926 int64 PyTorch ops for powers(n = 64).

What bounds it on the H100: bytes for a sum, operations for powers and
a dot (the functions need a mul an element; powers' square-and-multiply
spends ~9, so it runs at a few per cent of its bound). Each entry is one launch
of the kernel, counted on `field_rows`. powers: a thread an output
element, x^i by square-and-multiply, x read through its strides. sum and
dot: a thread an output element walking the summed axis where there are
many outputs, a block an output element with a shared-memory tree where
there are few and the axis is long (`block_mode`). Operands are read
through their strides and broadcast as stride 0, as csrc/field_arith.cu
reads them; the result is contiguous.

Values must be reduced field elements, as every field value of the port
is: modular addition of reduced elements is exact and commutative, so
any summation order gives the plain version's canonical element, and
x^i is unique.

Dispatch is by device, in the callers (field_cuda.on_card): CUDA
tensors come here, which launches the kernel or raises (CPU tensors
raise: they take the plain versions); operands on two devices raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .field_cuda import (
    MAX_RANK,
    c_array,
    cuda_operands,
    field_consts,
    limb_ptrs,
    limb_rows,
    merge_axes,
    reduce_geometry,
    stream_of,
)


# the kernel's launch count, which every entry adds to
field_rows = cuda_build.LaunchCount("field_rows")


def block_mode(outputs: int, m: int) -> int:
    """1 (a block an output element) for few outputs over a long axis,
    else 0 (a thread an output element)."""
    return 1 if m >= 1024 and outputs < 2048 else 0


def _fn(name: str):
    fn = getattr(cuda_build.load("field_rows"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "powers_launch":
            fn.argtypes = [i, i, p, p, p, p, p, p, p, ll, ll, p]
        else:
            fn.argtypes = [i, i, i, i, p, p, ll, p, p, p, p, p, p, p, p, ll, p]
        fn.restype = ctypes.c_int
    return fn


def powers(tf, x, n: int):
    """[x^0, x^1, ..., x^{n-1}] along a new trailing axis: x [...] ->
    a field value [..., n]."""
    assert n >= 1
    if len(x) != tf.LIMBS:
        raise ValueError(f"powers: a {tf.LIMBS}-limb value")
    device = cuda_operands("powers", list(x))
    shape = tuple(x[0].shape)
    outs = tuple(torch.empty(shape + (n,), dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    total = outs[0].numel()
    if total == 0:
        return outs
    mshape, mst = merge_axes(shape, [t.stride() for t in x])
    rows = limb_rows(tf, mst, len(mshape), 1)[:2]
    ptrs = limb_ptrs(tf, x, 1)[:2]
    with torch.cuda.device(device):
        rc = _fn("powers_launch")(
            tf.LIMBS, len(mshape), c_array(mshape), c_array([s for row in rows for s in row]), field_consts(),
            *ptrs, *limb_ptrs(tf, outs, 1)[:2], n, total, stream_of(device),
        )
    cuda_build.check(rc, "field_rows")
    cuda_build.count_launch(field_rows)
    return outs


def _reduce(tf, values, axis: int, what: str):
    """One launch: the sum over `axis` of values[0] (of values[0] x
    values[1] for a dot), broadcast against each other."""
    tensors = [t for v in values for t in v]
    device = tensors[0].device
    out_shape, mshape, mst, m, axis_st = reduce_geometry(
        [t.shape for t in tensors], [t.stride() for t in tensors], axis)
    outs = tuple(torch.empty(out_shape, dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    total = outs[0].numel()
    if total == 0:
        return outs
    rank = len(mshape)
    if rank > MAX_RANK:
        raise ValueError(f"{what}: {rank} axes after merging, more than {MAX_RANK}")
    n_values = len(values)
    rows = limb_rows(tf, mst, rank, n_values)
    ptrs = limb_ptrs(tf, tensors, n_values)
    axis_st = [r[0] for r in limb_rows(tf, [(s,) for s in axis_st], 1, n_values)]
    with torch.cuda.device(device):
        rc = _fn("reduce_launch")(
            tf.LIMBS, int(n_values == 2), block_mode(total, m), rank, c_array(mshape),
            c_array([s for row in rows for s in row]), m, c_array(axis_st), field_consts(), *ptrs,
            *limb_ptrs(tf, outs, 1)[:2], total, stream_of(device),
        )
    cuda_build.check(rc, "field_rows")
    cuda_build.count_launch(field_rows)
    return outs


def fsum(tf, v, axis: int):
    """The mod-p sum of a field value along `axis`."""
    if len(v) != tf.LIMBS:
        raise ValueError(f"fsum: a {tf.LIMBS}-limb value")
    cuda_operands("fsum", list(v))
    return _reduce(tf, (v,), axis, "fsum")


def fdot(tf, a, b, axis=-1):
    """The inner product of a and b (broadcast) along `axis`."""
    if len(a) != tf.LIMBS or len(b) != tf.LIMBS:
        raise ValueError(f"fdot: two {tf.LIMBS}-limb values")
    cuda_operands("fdot", list(a) + list(b))
    return _reduce(tf, (a, b), axis, "fdot")


def poly_eval_powers(tf, coeffs, pw):
    """sum_i coeffs[..., i] * pw[..., i] over the coefficients' k: the
    polynomials at the point whose powers pw [..., >= k] holds."""
    if len(coeffs) != tf.LIMBS or len(pw) != tf.LIMBS:
        raise ValueError(f"poly_eval_powers: two {tf.LIMBS}-limb values")
    cuda_operands("poly_eval_powers", list(coeffs) + list(pw))
    k = coeffs[0].shape[-1]
    return _reduce(tf, (coeffs, tuple(x[..., :k] for x in pw)), -1, "poly_eval_powers")
