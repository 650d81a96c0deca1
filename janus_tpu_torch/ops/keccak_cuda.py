"""Kernel 1 on the card: single-block Keccak-f[1600] in two launches, and their plain versions.

csrc/keccak.cu replaces janus_tpu/ops/keccak_pallas.py
keccak_single_block_pallas: the permutation of single-block SHAKE128
messages (21 rate lanes in, the 4 capacity lanes zero). Every seed
derivation, every counter-mode stream block and every tree-digest node
of the fast-mode XOF is one such permutation, and each batch of them is
one launch of one of two entries, which take the message as the callers
hold it:

- `keccak_ctr_blocks`: counter-mode blocks prefix || le64(ctr_offset + j)
  of a [batch] of prefixes given as (lane_offset, content) parts, where
  content is bytes (the dst, an aggregator id: lanes passed to the
  kernel as arguments) or an int64 [batch, k] tensor (seeds, nonces,
  binders, read in place through its strides). Only the `out_lanes`
  first lanes come out, as [batch, out_blocks, out_lanes].
- `keccak_tree_level`: one level of the arity-7 tree digest over a lane
  space given as the same parts; the leaf level reads its planar payload
  (lane j of node k = data lane j*n + k) and the upper levels the
  digests below, both in place, lanes past the data reading zero. Out:
  digests [batch, n, 2].

So no permutation on the path stacks, pads or broadcasts its 21 lanes
in memory: the wrapper makes one small argument block on the host and
launches once. Both entries add to one launch count, that of kernel 1,
`keccak_single_block.launches`.

What bounds the kernel at a width that fills the card is the integer
ALU, not memory: 24 rounds of about 180 32-bit instructions per state
against at most 168 bytes in and 168 out. It keeps a state in
registers for all rounds, one thread per state.

Dispatch is by device: on a CUDA device each entry launches its kernel
(and raises if it cannot); on the CPU it runs its plain version
(`keccak_ctr_blocks_plain`, `keccak_tree_level_plain`: the parts
assembled into lanes, `ctr_block_cols` or the tree-node columns, and
`keccak_f1600_plain`), which is also the kernel's yardstick on the card.
`rounds` is a runtime argument of both, so they agree at reduced rounds
too.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields.tfield import i64, lsr
from . import cuda_build

RATE_LANES = 21
PREFIX_MAX = 19  # a prefix and its counter fit one rate block
SEG_MAX = 4  # parts of one tree level's lane space
KONST_MAX = 16  # constant lanes of one tree level's lane space

TREE_MAGIC_LANE = i64(int(np.frombuffer(b"JanusTr1", dtype="<u8")[0]))
TREE_CHUNK_LANES = 14  # 112 bytes
TREE_DIGEST_LANES = 2

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


class _LaunchCount:
    """Kernel 1's launch count, which both of its entries add to."""

    __name__ = "keccak_single_block"
    launches = 0


# the kernel's name in the launch checks (chip_smoke.py, the card tests)
keccak_single_block = _LaunchCount()


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


# --- message parts --------------------------------------------------------------------------


def _parts(parts, total_lanes: int, batch: int, device, what: str):
    """Check (lane_offset, bytes | int64 [batch or 1, k] tensor) parts of a
    [batch, total_lanes] message; return them sorted as (offset, lanes,
    content), bytes turned into a tuple of int64 lane values."""
    out = []
    pos = 0
    for off, content in sorted(parts, key=lambda p: p[0]):
        if off < pos:
            raise ValueError(f"{what}: overlapping message parts")
        if isinstance(content, (bytes, bytearray)):
            if len(content) % 8:
                raise ValueError(f"{what}: a bytes part must be whole lanes")
            vals = tuple(int(v) for v in np.frombuffer(bytes(content), dtype="<u8").view(np.int64))
            out.append((off, len(vals), vals))
            pos = off + len(vals)
            continue
        if content.dtype != torch.int64 or content.dim() != 2 or content.shape[0] not in (1, batch):
            raise ValueError(f"{what}: a tensor part must be int64 [batch or 1, k], got {tuple(content.shape)}")
        if content.device != device:
            raise ValueError(f"{what}: a part on {content.device}, not {device}")
        out.append((off, content.shape[1], content))
        pos = off + content.shape[1]
    if pos > total_lanes:
        raise ValueError(f"{what}: parts run to lane {pos}, past {total_lanes}")
    return out


def _device(device, what: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def assemble_lanes(parts, total_lanes: int, batch: int, device):
    """The message of (lane_offset, lanes | bytes) parts as one
    [batch, total_lanes] int64 tensor: gaps and the tail are zero, bytes
    are broadcast across the batch. The plain versions' assembly, and
    kernel 2's prefix (ops/expand_cuda.py takes it whole)."""
    device = _device(device, "assemble_lanes")
    segs = []
    pos = 0
    for off, n, content in _parts(parts, total_lanes, batch, device, "assemble_lanes"):
        if off > pos:
            segs.append(torch.zeros((batch, off - pos), dtype=torch.int64, device=device))
        if isinstance(content, tuple):
            row = torch.stack([torch.full((), v, dtype=torch.int64, device=device) for v in content])
            segs.append(row[None, :].expand(batch, n))
        else:
            segs.append(content.expand(batch, n))
        pos = off + n
    if pos < total_lanes:
        segs.append(torch.zeros((batch, total_lanes - pos), dtype=torch.int64, device=device))
    return torch.cat(segs, dim=1)


def _stream(device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _fn(name: str, argtypes):
    fn = getattr(cuda_build.load("keccak"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P = ctypes.c_void_p
_LL = ctypes.c_longlong


# --- counter mode ---------------------------------------------------------------------------


class _CtrPrefix(ctypes.Structure):
    """csrc/keccak.cu CtrPrefix."""

    _fields_ = [
        ("ptr", _P * PREFIX_MAX),
        ("row_stride", _LL * PREFIX_MAX),
        ("konst", ctypes.c_int64 * PREFIX_MAX),
    ]


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


def keccak_ctr_blocks_plain(parts, prefix_lanes: int, batch: int, out_blocks: int, out_lanes: int, device,
                            ctr_offset: int = 0, rounds: int = 24):
    """Plain PyTorch version of the counter-mode kernel: same inputs, same outputs."""
    prefix = assemble_lanes(parts, prefix_lanes, batch, device)
    shape = (batch, out_blocks)
    cols = [c.expand(shape) for c in ctr_block_cols(prefix, out_blocks, ctr_offset)]
    zero = torch.zeros(shape, dtype=torch.int64, device=device)
    state = keccak_f1600_plain(cols + [zero] * 4, rounds)
    return torch.stack(state[:out_lanes], dim=-1)


def keccak_ctr_blocks(parts, prefix_lanes: int, batch: int, out_blocks: int, out_lanes: int, device,
                      ctr_offset: int = 0, rounds: int = 24):
    """Counter-mode SHAKE128 blocks of per-report prefixes, one launch.

    parts: (lane_offset, bytes | int64 [batch or 1, k] tensor) segments of
    the prefix (prefix_lanes <= 19 lanes, gaps zero). Block j of report b
    is the single-block message prefix_b || le64(ctr_offset + j). Returns
    the first out_lanes lanes of every block, [batch, out_blocks,
    out_lanes] int64.
    """
    what = "keccak_ctr_blocks"
    if not 0 <= prefix_lanes <= PREFIX_MAX or not 1 <= out_lanes <= RATE_LANES:
        raise ValueError(f"{what}: a {prefix_lanes}-lane prefix, {out_lanes} lanes out")
    dev = _device(device, what)
    if dev.type == "cpu":
        return keccak_ctr_blocks_plain(parts, prefix_lanes, batch, out_blocks, out_lanes, dev, ctr_offset, rounds)
    checked = _parts(parts, prefix_lanes, batch, dev, what)
    pre = _CtrPrefix()
    for off, n, content in checked:
        for c in range(n):
            if isinstance(content, tuple):
                pre.konst[off + c] = content[c]
            else:
                pre.ptr[off + c] = content.data_ptr() + 8 * c * content.stride(1)
                pre.row_stride[off + c] = content.stride(0) if content.shape[0] > 1 else 0
    out = torch.empty((batch, out_blocks, out_lanes), dtype=torch.int64, device=dev)
    if batch * out_blocks:
        fn = _fn("keccak_ctr_launch", [_P, ctypes.c_int, _LL, _LL, _LL, ctypes.c_int, _P, ctypes.c_int, _P])
        with torch.cuda.device(dev):  # the runtime launches on the current device
            rc = fn(ctypes.byref(pre), prefix_lanes, batch, out_blocks, int(ctr_offset), out_lanes, out.data_ptr(),
                    rounds, _stream(dev))
        cuda_build.check(rc, what)
        cuda_build.count_launch(keccak_single_block)
    return out


# --- tree levels ----------------------------------------------------------------------------


class _LaneSpace(ctypes.Structure):
    """csrc/keccak.cu LaneSpace."""

    _fields_ = [
        ("ptr", _P * SEG_MAX),
        ("start", _LL * SEG_MAX),
        ("len", _LL * SEG_MAX),
        ("row_stride", _LL * SEG_MAX),
        ("lane_stride", _LL * SEG_MAX),
        ("koff", ctypes.c_int * SEG_MAX),
        ("nseg", ctypes.c_int),
        ("konst", ctypes.c_int64 * KONST_MAX),
    ]


def tree_nodes(lanes_n: int) -> int:
    """Nodes of a tree level over lanes_n lanes (14 payload lanes a node)."""
    return max(1, -(-lanes_n // TREE_CHUNK_LANES))


def keccak_tree_level_plain(parts, lanes_n: int, batch: int, level: int, total_bytes: int, device,
                            rounds: int = 24):
    """Plain PyTorch version of the tree-level kernel: same inputs, same outputs."""
    n = tree_nodes(lanes_n)
    data = assemble_lanes(parts, lanes_n, batch, device)
    data = torch.nn.functional.pad(data, (0, n * TREE_CHUNK_LANES - lanes_n))  # zero past lanes_n
    if level == 0:
        planes = data.reshape(batch, TREE_CHUNK_LANES, n)
        payload = lambda j: planes[:, j, :]  # noqa: E731
    else:
        chunks = data.reshape(batch, n, TREE_CHUNK_LANES)
        payload = lambda j: chunks[:, :, j]  # noqa: E731
    shape = (batch, n)
    consts = {0: TREE_MAGIC_LANE, 1: level, 3: total_bytes, 18: PAD_START, 20: PAD_END}
    cols = []
    for lane in range(25):
        if lane == 2:
            cols.append(torch.arange(n, dtype=torch.int64, device=device)[None, :].expand(shape))
        elif 4 <= lane < 4 + TREE_CHUNK_LANES:
            cols.append(payload(lane - 4))
        else:
            cols.append(torch.full(shape, consts.get(lane, 0), dtype=torch.int64, device=device))
    state = keccak_f1600_plain(cols, rounds)
    return torch.stack(state[:TREE_DIGEST_LANES], dim=-1)


def keccak_tree_level(parts, lanes_n: int, batch: int, level: int, total_bytes: int, device, rounds: int = 24):
    """One level of the arity-7 tree digest (vdaf/xof.py tree_digest), one launch.

    parts: (lane_offset, bytes | int64 [batch or 1, k] tensor) segments of
    the level's lanes_n-lane input (gaps zero). Level 0 is the leaf level
    over the data, lane j of node k being data lane j*n + k; a level
    above reads the digests below as lanes, node k hashing lanes
    14k .. 14k + 13. Lanes past lanes_n are zero. Node k hashes magic ||
    le64(level) || le64(k) || le64(total_bytes) || its 14 lanes. Returns
    the digests [batch, n, 2] int64, n = ceil(lanes_n / 14) (at least 1).
    """
    what = "keccak_tree_level"
    dev = _device(device, what)
    if dev.type == "cpu":
        return keccak_tree_level_plain(parts, lanes_n, batch, level, total_bytes, dev, rounds)
    checked = _parts(parts, lanes_n, batch, dev, what)
    if len(checked) > SEG_MAX:
        raise ValueError(f"{what}: {len(checked)} parts, at most {SEG_MAX}")
    m = _LaneSpace()
    m.nseg = len(checked)
    koff = 0
    for s, (off, n_lanes, content) in enumerate(checked):
        m.start[s], m.len[s] = off, n_lanes
        if isinstance(content, tuple):
            if koff + n_lanes > KONST_MAX:
                raise ValueError(f"{what}: more than {KONST_MAX} constant lanes")
            m.koff[s] = koff
            for c, v in enumerate(content):
                m.konst[koff + c] = v
            koff += n_lanes
        else:
            m.ptr[s] = content.data_ptr()
            m.row_stride[s] = content.stride(0) if content.shape[0] > 1 else 0
            m.lane_stride[s] = content.stride(1)
    n = tree_nodes(lanes_n)
    jstride, kstride = (n, 1) if level == 0 else (1, TREE_CHUNK_LANES)
    out = torch.empty((batch, n, TREE_DIGEST_LANES), dtype=torch.int64, device=dev)
    if batch:
        fn = _fn("keccak_tree_launch", [_P, _LL, _LL, _LL, _LL, ctypes.c_ulonglong, _LL, _LL, _P, ctypes.c_int, _P])
        with torch.cuda.device(dev):  # the runtime launches on the current device
            rc = fn(ctypes.byref(m), batch, n, jstride, kstride, TREE_MAGIC_LANE & (2**64 - 1), level, total_bytes,
                    out.data_ptr(), rounds, _stream(dev))
        cuda_build.check(rc, what)
        cuda_build.count_launch(keccak_single_block)
    return out
