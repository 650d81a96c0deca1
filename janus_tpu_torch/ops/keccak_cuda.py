"""Single-block Keccak-f[1600]: CUDA kernel (csrc/keccak.cu) and plain version.

Replaces janus_tpu/ops/keccak_pallas.py keccak_single_block_pallas: the
permutation of single-block SHAKE128 messages, 21 rate lanes in (the 4
capacity lanes are zero), the first `out_lanes` lanes out. Every seed
derivation, every counter-mode stream block and every tree-digest node
of the fast-mode XOF is one such permutation.

What bounds it on the H100 is the integer ALU, not memory: 24 rounds of
about 130 64-bit logic ops per state against 168 bytes in and at most
168 out. The kernel keeps each state in registers for all rounds, one
thread per state, and reads and writes each lane once in a lane-major
[21, n] layout so that a warp's accesses to one lane are contiguous.

Dispatch is by device: on a CUDA tensor `keccak_single_block` launches
the kernel (and raises if it cannot); on a CPU tensor it runs
`keccak_single_block_plain`, the same function in plain PyTorch, which
is also the kernel's yardstick on the card. `rounds` is a runtime
argument of both, so they agree at reduced rounds too.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..fields.tfield import i64, lsr
from . import cuda_build

RATE_LANES = 21

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets indexed [x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

PAD_START = 0x1F
PAD_END = i64(0x80 << 56)


def _rotl(x, r: int):
    return x if r == 0 else (x << r) | lsr(x, 64 - r)


def keccak_f1600_plain(state, rounds: int = 24):
    """The first `rounds` rounds of Keccak-f[1600] on 25 int64 tensors
    (lane (x, y) at index x + 5*y) of one shape."""
    a = list(state)
    for rnd in range(rounds):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi: B[y, 2x+3y] = rot(A[x, y])
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        # chi
        a = [
            b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        # iota
        a[0] = a[0] ^ i64(_RC[rnd])
    return tuple(a)


def keccak_single_block_plain(lane_cols, out_lanes: int, rounds: int = 24):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    shape = torch.broadcast_shapes(*(c.shape for c in lane_cols))
    cols = [c.expand(shape) for c in lane_cols]
    zero = torch.zeros(shape, dtype=torch.int64, device=cols[0].device)
    return keccak_f1600_plain(cols + [zero] * 4, rounds)[:out_lanes]


def _lib():
    lib = cuda_build.load("keccak")
    fn = lib.keccak_single_block_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def keccak_single_block(lane_cols, out_lanes: int, rounds: int = 24):
    """Permute single-block messages given as 21 int64 rate-lane tensors
    (broadcastable to one shape S); return the first `out_lanes` output
    lanes, each of shape S."""
    if len(lane_cols) != RATE_LANES or not 1 <= out_lanes <= RATE_LANES:
        raise ValueError(f"keccak_single_block: {len(lane_cols)} lanes in, {out_lanes} out")
    device = lane_cols[0].device
    if device.type == "cpu":
        return keccak_single_block_plain(lane_cols, out_lanes, rounds)
    if device.type != "cuda":
        raise ValueError(f"keccak_single_block: unsupported device {device}")
    if any(c.dtype != torch.int64 or c.device != device for c in lane_cols):
        raise ValueError("keccak_single_block: lanes must be int64 on one device")
    shape = torch.broadcast_shapes(*(c.shape for c in lane_cols))
    n = math.prod(shape)
    stacked = torch.empty((RATE_LANES,) + tuple(shape), dtype=torch.int64, device=device)
    for lane, col in enumerate(lane_cols):
        stacked[lane].copy_(col)
    out = torch.empty((out_lanes, n), dtype=torch.int64, device=device)
    if n:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _lib()(stacked.data_ptr(), out.data_ptr(), n, out_lanes, rounds, stream)
        cuda_build.check(rc, "keccak_single_block")
        keccak_single_block.launches += 1
    return tuple(out[lane].view(shape) for lane in range(out_lanes))


keccak_single_block.launches = 0


def ctr_block_cols(prefix, out_blocks: int, ctr_offset: int = 0):
    """The 21 rate lanes of the counter-mode messages prefix || le64(i)
    with SHAKE padding, for i in [ctr_offset, ctr_offset + out_blocks).

    prefix: [batch, p] int64 lanes (dst || seed || binder'). Returns 21
    tensors broadcastable to [batch, out_blocks].
    """
    batch, p = prefix.shape
    assert p + 1 <= RATE_LANES - 1, "prefix + counter must fit one rate block"
    device = prefix.device
    shape = (batch, out_blocks)
    cols = []
    for lane in range(RATE_LANES):
        if lane < p:
            cols.append(prefix[:, lane : lane + 1].expand(shape))
        elif lane == p:
            ctr = torch.arange(out_blocks, dtype=torch.int64, device=device) + ctr_offset
            cols.append(ctr[None, :].expand(shape))
        else:
            v = 0
            if lane == p + 1:
                v |= PAD_START
            if lane == RATE_LANES - 1:
                v |= PAD_END
            cols.append(torch.full((), v, dtype=torch.int64, device=device).expand(shape))
    return cols
