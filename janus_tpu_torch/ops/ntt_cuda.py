"""Batched NTT and inverse NTT over field rows: CUDA kernel (csrc/ntt.cu) and plain version.

Replaces janus_tpu/ops/ntt.py:80 `_transform` (ntt_batched :108,
intt_batched :121, lagrange_eval_weights :128), which XLA compiles into
janus_tpu's jitted step with its stages split by anti_recompute_barrier:
not a Pallas kernel. The port's ops/ntt.py `_transform` calls
`transform` on the card, counted on `ntt_transform`; its eager body is
the plain version (ntt.py's `_transform_plain`: a bit-reversal gather,
then log2(n) stages of field mul, add, sub and cat, 3,995 int64 PyTorch
ops for n = 64).

What bounds it on the H100: operations (a butterfly is a field mul, add
and sub against the 32 bytes it reads and writes once, in shared memory).
A row of n elements, n * limbs * 8 bytes, up to ROW_BYTES_IN_ONE_BLOCK
(128 KB: Field128 n <= 8,192, Field64 n <= 16,384) is transformed whole
by one block in shared memory, in one launch for every row of the batch:
gathered bit-reversed from the input's strides, every stage between
barriers, scaled by n^-1 for the inverse, stored contiguous. The step's
rows (n = 128 at SumVec(1000, 16), up to 4,096 at SumVec(100000, 16)) all
take that route. Longer rows take 1 + log2(n) launches on the same
arithmetic: the gather, then a launch a stage in place in global memory,
the inverse's scale fused into the last; each launch counts.

The caller passes the twiddles and n^-1 from ntt.py's per-device plan
(`_twiddles_on`: every stage's twiddles in one table a limb, stage L at
offset L/2 - 1). Dispatch is by device, in the caller
(field_cuda.on_card): CUDA tensors come here, which launches the kernel
or raises (CPU tensors raise: they take the plain version); operands on
two devices raise.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .field_cuda import MAX_RANK, c_array, cuda_operands, field_consts, limb_ptrs, limb_rows, merge_axes, stream_of

ROW_BYTES_IN_ONE_BLOCK = 128 * 1024
# threads a block: up to this many a row, rows packed up to it
BLOCK_THREADS = 256


# the kernel's launch count, which every entry adds to
ntt_transform = cuda_build.LaunchCount("ntt_transform")


def block_geometry(n: int, limbs: int):
    """(threads a row, rows a block, shared bytes a block) of the one-launch
    route for rows of n elements, or None where a row does not fit."""
    row_bytes = n * limbs * 8
    if row_bytes > ROW_BYTES_IN_ONE_BLOCK:
        return None
    tpr = max(1, min(n // 2, BLOCK_THREADS))
    rpb = max(1, BLOCK_THREADS // tpr)
    return tpr, rpb, rpb * row_bytes


def row_geometry(batch, strides):
    """The batch axes of rows [*batch, n], merged, and each limb's
    strides along them followed by its stride along the row."""
    bshape, bst = merge_axes(tuple(batch), [st[:-1] for st in strides])
    return bshape, [b + (st[-1],) for b, st in zip(bst, strides)]


def _fn(name: str):
    fn = getattr(cuda_build.load("ntt"), name)
    if fn.argtypes is None:
        p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
        fn.argtypes = {
            "ntt_rows_launch": [i, i, i, i, p, p, p, p, p, p, p, u, u, p, p, ll, i, i, i, p],
            "ntt_gather_launch": [i, i, i, p, p, p, p, p, p, ll, p],
            "ntt_stage_launch": [i, i, i, i, p, p, p, u, u, p, p, ll, p],
        }[name]
        fn.restype = ctypes.c_int
    return fn


def transform(tf, v, n: int, inverse: bool, tw, n_inv):
    """The NTT (inverse: n^-1 times the inverse NTT) of every row of the
    field value v [..., n] on the card: a new contiguous field value
    [..., n]. tw: the plan's twiddle table a limb ([n - 1], on v's
    device); n_inv: n^-1 as an int (None for the forward transform)."""
    if len(v) != tf.LIMBS:
        raise ValueError(f"ntt_transform: a {tf.LIMBS}-limb value")
    device = cuda_operands("ntt_transform", list(v) + list(tw))
    if n < 1 or n & (n - 1) or v[0].shape[-1] != n or any(x.shape != v[0].shape for x in v):
        raise ValueError(f"ntt_transform: rows of n = {n} (a power of two) wanted, not {tuple(v[0].shape)}")
    log2n = n.bit_length() - 1
    ninv = n_inv or 0
    ninv_words = (ninv & ((1 << 64) - 1), ninv >> 64)
    batch = tuple(v[0].shape[:-1])
    outs = tuple(torch.empty(batch + (n,), dtype=torch.int64, device=device) for _ in range(tf.LIMBS))
    rows = outs[0].numel() // n
    if rows == 0:
        return outs
    bshape, per = row_geometry(batch, [x.stride() for x in v])
    rank = len(bshape)
    if rank > MAX_RANK:
        raise ValueError(f"ntt_transform: {rank} batch axes after merging, more than {MAX_RANK}")
    strides = c_array([s for row in limb_rows(tf, per, rank + 1, 1)[:2] for s in row])
    ins, tws, out_ptrs = (limb_ptrs(tf, x, 1)[:2] for x in (v, tw, outs))
    geo = block_geometry(n, tf.LIMBS)
    with torch.cuda.device(device):
        stream = stream_of(device)
        if geo is not None:
            tpr, rpb, smem = geo
            rc = _fn("ntt_rows_launch")(
                tf.LIMBS, log2n, int(inverse), rank, c_array(bshape), strides, field_consts(), *ins, *tws,
                *ninv_words, *out_ptrs, rows, rpb, tpr, smem, stream,
            )
            cuda_build.check(rc, "ntt_transform")
            cuda_build.count_launch(ntt_transform)
            return outs
        rc = _fn("ntt_gather_launch")(tf.LIMBS, log2n, rank, c_array(bshape), strides, *ins, *out_ptrs, rows, stream)
        cuda_build.check(rc, "ntt_transform")
        cuda_build.count_launch(ntt_transform)
        for lg in range(1, log2n + 1):
            rc = _fn("ntt_stage_launch")(
                tf.LIMBS, log2n, lg, int(inverse and lg == log2n), field_consts(), *tws, *ninv_words, *out_ptrs,
                rows, stream,
            )
            cuda_build.check(rc, "ntt_transform")
            cuda_build.count_launch(ntt_transform)
    return outs

