"""Field128 scatter-add into a logical accumulator: CUDA kernel (csrc/scatter_rows.cu) and plain version.

Replaces janus_tpu/vdaf/prio3_jax.py:458 Prio3Batched.scatter_rows, the
aggregation of block-sparse SumVec. That one is not a Pallas kernel: XLA
compiles its lax.scan over reports. Given a logical accumulator acc [L]
(Field128 limbs), compact out-share rows values [b, cm] and their flat
logical positions flat_idx [b, cm] (int32), it returns acc plus every
lane added at its position, mod p. A lane whose index is the sentinel L
(a padding block, a rejected report, a padding row of a bucket) is
dropped; so is any index outside [0, L). Values must be reduced field
elements. On the main path, sparse_sumvec(16, 1000000, 64, 16) at 1,024
reports: b = 1,024, cm = 1,024, L = 1,000,000, once per party.

What bounds it on the H100 is memory: values, indices and acc read once
and the result written once, at most about 56 MB at that shape (only live
lanes' values need reading), against a few integer adds a lane. The
kernel does not walk the reports in order. Field addition is exact, so
it sums by position, straight into the output, in three launches: out =
acc; then a thread walks one compact column down 2 rows, adds equal
consecutive positions in registers, the 8 warps of a block merge their
last runs of one position (block 0, in every report, becomes one sum a
position a block), and every run goes into out with atomicAdds (the
carries taken from the old values the atomics return, a carry past
2^128 folded back in as 2^128 mod p), marking its 64-position group;
last, the marked groups' positions that hold p or more lose p. There is
no scratch but the marks (`scratch_bytes`, 16 KB at L = 1,000,000),
which the wrapper allocates per launch on the launch's stream and the
copy launch zeroes, so threads and streams share nothing.

Dispatch is by device: on a CUDA tensor `scatter_rows` launches the
kernel (and raises if it cannot); on a CPU tensor it runs
`scatter_rows_plain`, the JAX scan in plain PyTorch (one report at a
time: a gather, a TF128.add, a set that drops the sentinel lanes), which
is also the kernel's yardstick on the card. The plain version takes the
valid indices of one row to be distinct, as the block-index predicate
makes them; the kernel does not need that.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.tfield import TF128
from . import cuda_build


def scatter_rows_plain(acc, values, flat_idx):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    L = acc[0].shape[0]
    lo, hi = acc[0].clone(), acc[1].clone()
    for i in range(flat_idx.shape[0]):
        ix = flat_idx[i].long()
        live = (ix >= 0) & (ix < L)
        g = torch.where(live, ix, torch.zeros_like(ix))
        s_lo, s_hi = TF128.add((lo[g], hi[g]), (values[0][i], values[1][i]))
        lo[ix[live]] = s_lo[live]
        hi[ix[live]] = s_hi[live]
    return lo, hi


def scratch_bytes(L: int) -> int:
    """Device bytes of a launch's scratch for an accumulator of L
    positions: a mark byte a 64-position group, in whole 2,048-position
    blocks."""
    return 32 * -(-L // 2048)


def _lib():
    lib = cuda_build.load("scatter_rows")
    fn = lib.scatter_rows_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, ll, ll, ll, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def scatter_rows(acc, values, flat_idx):
    """acc: (lo, hi) int64 [L]; values: (lo, hi) int64 [b, cm]; flat_idx:
    int32 [b, cm]. Returns a new (lo, hi) [L]: acc plus every lane whose
    index lies in [0, L), added at that position mod p."""
    if len(acc) != 2 or len(values) != 2:
        raise ValueError("scatter_rows: Field128 limb pairs only")
    if acc[0].dim() != 1 or acc[0].shape != acc[1].shape:
        raise ValueError("scatter_rows: acc must be two [L] limb tensors")
    if flat_idx.dim() != 2 or values[0].shape != flat_idx.shape or values[1].shape != flat_idx.shape:
        raise ValueError("scatter_rows: values and flat_idx must be [b, cm] alike")
    device = flat_idx.device
    if device.type == "cpu":
        return scatter_rows_plain(acc, values, flat_idx)
    if device.type != "cuda":
        raise ValueError(f"scatter_rows: unsupported device {device}")
    tensors = (*acc, *values)
    if any(t.device != device for t in tensors):
        raise ValueError("scatter_rows: every input must lie on one device")
    if any(t.dtype != torch.int64 for t in tensors) or flat_idx.dtype != torch.int32:
        raise ValueError("scatter_rows: limbs must be int64 and flat_idx int32")
    L = acc[0].shape[0]
    acc_lo, acc_hi, val_lo, val_hi = (t.contiguous() for t in tensors)
    # the copy reads acc 16 bytes at a time
    acc_lo, acc_hi = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (acc_lo, acc_hi))
    idx = flat_idx.contiguous()
    out_lo = torch.empty(L, dtype=torch.int64, device=device)
    out_hi = torch.empty(L, dtype=torch.int64, device=device)
    if L:
        b, cm = idx.shape
        with torch.cuda.device(device):
            marks = torch.empty(scratch_bytes(L), dtype=torch.uint8, device=device)
            rc = _lib()(
                acc_lo.data_ptr(), acc_hi.data_ptr(), val_lo.data_ptr(), val_hi.data_ptr(), idx.data_ptr(),
                b, cm, L, marks.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream,
            )
        cuda_build.check(rc, "scatter_rows")
        cuda_build.count_launch(scatter_rows)
    return out_lo, out_hi


scatter_rows.launches = 0
