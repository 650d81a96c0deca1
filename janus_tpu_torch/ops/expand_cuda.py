"""Fused XOF expansion to Field128: CUDA kernel (csrc/expand_f128.cu) and plain version.

Replaces janus_tpu/ops/expand_pallas.py expand_f128: counter-mode
SHAKE128 over per-report prefixes (dst || seed || binder') straight to
Field128 vectors. Every 168-byte stream block is one single-block
permutation of prefix || le64(block_offset + j), and its 21 lanes become
7 elements, each a 192-bit little-endian value reduced mod
p = 2^128 - 7*2^66 + 1. On the main path it expands the helper's
measurement share (16000 elements, 2286 blocks a report at
SumVec(1000, 16)) and proof share, in shard and in helper prepare-init.

What bounds it on the H100 is the integer ALU: per block, 24 rounds
plus seven 192-bit reductions against 112 bytes of elements written.
The kernel runs one thread per (report, block) with the state in
registers and writes each element's lo/hi limbs once, straight into the
[batch, length] outputs; the raw stream never reaches memory.

Dispatch is by device: on a CUDA tensor `expand_f128` launches the
kernel (and raises if it cannot); on a CPU tensor it runs
`expand_f128_plain`, the same function in plain PyTorch (the unfused
stream through keccak_f1600_plain, then the 256-bit reduction of
fields/tfield.py), which is also the kernel's yardstick on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.tfield import _f128_reduce256
from . import cuda_build
from .keccak_cuda import RATE_LANES, ctr_block_cols, keccak_f1600_plain


def expand_f128_plain(prefix_lanes, out_blocks: int, length: int, block_offset: int = 0, rounds: int = 24):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    batch = prefix_lanes.shape[0]
    cols = ctr_block_cols(prefix_lanes, out_blocks, block_offset)
    zero = torch.zeros((batch, out_blocks), dtype=torch.int64, device=prefix_lanes.device)
    state = keccak_f1600_plain(cols + [zero] * 4, rounds)
    flat = torch.stack(state[:RATE_LANES], dim=-1).reshape(batch, -1)
    l0, l1, l2 = (flat[:, i : 3 * length : 3] for i in range(3))
    return _f128_reduce256(l0, l1, l2, torch.zeros_like(l0))


def _lib():
    lib = cuda_build.load("expand_f128")
    fn = lib.expand_f128_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def expand_f128(prefix_lanes, out_blocks: int, length: int, block_offset: int = 0, rounds: int = 24):
    """Expand per-report counter-mode prefixes to Field128 limb tensors.

    prefix_lanes: [batch, p] int64 (dst || seed || binder', p <= 19);
    returns (lo, hi), each [batch, length], from stream blocks
    block_offset .. block_offset + out_blocks - 1 (7 elements a block).
    """
    if prefix_lanes.dim() != 2:
        raise ValueError("expand_f128: prefix lanes must be [batch, p]")
    batch, p = prefix_lanes.shape
    if p + 1 > RATE_LANES - 1:
        raise ValueError(f"expand_f128: a {p}-lane prefix and the counter do not fit one rate block")
    if 7 * out_blocks < length:
        raise ValueError(f"expand_f128: {out_blocks} blocks hold fewer than {length} elements")
    device = prefix_lanes.device
    if device.type == "cpu":
        return expand_f128_plain(prefix_lanes, out_blocks, length, block_offset, rounds)
    if device.type != "cuda":
        raise ValueError(f"expand_f128: unsupported device {device}")
    if prefix_lanes.dtype != torch.int64:
        raise ValueError("expand_f128: prefix lanes must be int64")
    prefix = prefix_lanes.contiguous()
    lo = torch.empty((batch, length), dtype=torch.int64, device=device)
    hi = torch.empty((batch, length), dtype=torch.int64, device=device)
    if batch * out_blocks:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _lib()(
                prefix.data_ptr(), p, lo.data_ptr(), hi.data_ptr(),
                batch, out_blocks, length, int(block_offset), rounds, stream,
            )
        cuda_build.check(rc, "expand_f128")
        expand_f128.launches += 1
    return lo, hi


expand_f128.launches = 0
