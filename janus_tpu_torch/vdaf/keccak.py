"""Batched fast-mode XOF on the device: counter-mode stream, tree digest, sampling.

The counter-mode framing (vdaf/xof.py) makes every 168-byte output block
an independent single-block SHAKE128 message dst16 || seed || binder' ||
le64(i), so one batched permutation over [batch, n_blocks] states gives
the whole stream of every report in a batch; long binders are bound by
an arity-7 Merkle digest whose levels are each one batched permutation.
Byte-identical to the host oracle vdaf/xof.py and to the JAX package's
vdaf/keccak_jax.py.

Every permutation here is the single-block kernel
(ops/keccak_cuda.keccak_single_block) and every Field128 expansion the
fused kernel (ops/expand_cuda.expand_f128). Each wrapper chooses by the
device of its inputs: the kernel on CUDA, its plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.tfield import _f64_reduce_wide, _f128_reduce256, i64
from ..ops.expand_cuda import expand_f128
from ..ops.keccak_cuda import PAD_END, PAD_START, RATE_LANES, ctr_block_cols, keccak_single_block

# Round count of every permutation in this module: 24 always in
# production; a test lowers it to hold a reduced-round run against the
# JAX package at the same count.
KECCAK_ROUNDS = 24


def _assemble_segments(parts, total_lanes: int, batch: int, device):
    """Concatenate (lane_offset, lanes|bytes) parts into [batch, total_lanes].

    Gaps are zero-filled; host bytes are broadcast across the batch.
    """
    segs = []
    pos = 0
    for off, content in sorted(parts, key=lambda p: p[0]):
        assert off >= pos, "overlapping message parts"
        if off > pos:
            segs.append(torch.zeros((batch, off - pos), dtype=torch.int64, device=device))
            pos = off
        if isinstance(content, (bytes, bytearray)):
            assert len(content) % 8 == 0
            lanes = np.frombuffer(bytes(content), dtype="<u8").view(np.int64)
            row = torch.stack([torch.full((), int(v), dtype=torch.int64, device=device) for v in lanes])
            segs.append(row[None, :].expand(batch, lanes.size))
            pos += lanes.size
        else:
            assert content.dtype == torch.int64 and content.device == device
            segs.append(content)
            pos += content.shape[-1]
    assert pos <= total_lanes
    if pos < total_lanes:
        segs.append(torch.zeros((batch, total_lanes - pos), dtype=torch.int64, device=device))
    return torch.cat(segs, dim=1)


def _single_block_keccak(lane_cols, out_lanes: int):
    return keccak_single_block(lane_cols, out_lanes, rounds=KECCAK_ROUNDS)


def ctr_stream_lanes(prefix_parts, prefix_len_bytes: int, batch: int, out_blocks: int, device, ctr_offset: int = 0):
    """Counter-mode SHAKE128 stream: [batch, out_blocks, 21] int64 lanes.

    prefix_parts: (lane_offset, content) segments of the prefix
    dst16 || seed || binder' (binder' already inline-size). Block i of
    the stream is the single-block message prefix || le64(ctr_offset + i).
    """
    assert prefix_len_bytes % 8 == 0
    prefix = _assemble_segments(prefix_parts, prefix_len_bytes // 8, batch, device)
    state = _single_block_keccak(ctr_block_cols(prefix, out_blocks, ctr_offset), RATE_LANES)
    return torch.stack(state, dim=-1)


TREE_MAGIC_LANE = i64(int(np.frombuffer(b"JanusTr1", dtype="<u8")[0]))
TREE_CHUNK_LANES = 14  # 112 bytes
TREE_ARITY = 7
TREE_DIGEST_LANES = 2


def _tree_level(payload, level: int, total_lanes_bytes: int):
    """Hash one tree level: payload(j) -> [batch, n] lane j of every node's
    112-byte payload, for j in 0..13. Returns digests [batch, n, 2]."""
    p0 = payload(0)
    batch, n = p0.shape
    device = p0.device
    consts = {0: TREE_MAGIC_LANE, 1: level, 3: total_lanes_bytes, 18: PAD_START, 20: PAD_END}
    cols = []
    for lane in range(RATE_LANES):
        if lane == 2:
            cols.append(torch.arange(n, dtype=torch.int64, device=device)[None, :])
        elif 4 <= lane < 4 + TREE_CHUNK_LANES:
            cols.append(payload(lane - 4))
        else:
            cols.append(torch.full((1, 1), consts.get(lane, 0), dtype=torch.int64, device=device))
    state = _single_block_keccak(cols, TREE_DIGEST_LANES)
    return torch.stack(state, dim=-1)


def tree_digest_lanes(data_parts, data_len_bytes: int, batch: int, device):
    """Arity-7 Merkle digest of lane-aligned data: [batch, 2] int64 lanes.

    Byte-identical to vdaf/xof.tree_digest. Each level is one batched
    permutation over all of that level's nodes. Level 0 uses the planar
    leaf mapping (lane j of leaf k = data lane j*n + k), so each leaf
    lane column is a contiguous slice of the data.
    """
    assert data_len_bytes % 8 == 0
    lanes_n = data_len_bytes // 8
    data = _assemble_segments(data_parts, lanes_n, batch, device)  # [batch, L]
    n = max(1, -(-lanes_n // TREE_CHUNK_LANES))
    pad = n * TREE_CHUNK_LANES - lanes_n
    if pad:
        data = torch.nn.functional.pad(data, (0, pad))
    planes = data.reshape(batch, TREE_CHUNK_LANES, n)
    digs = _tree_level(lambda j: planes[:, j, :], 0, data_len_bytes)  # [batch, n, 2]
    level = 0
    while n > 1:
        level += 1
        groups = -(-n // TREE_ARITY)
        gpad = groups * TREE_ARITY - n
        if gpad:
            digs = torch.nn.functional.pad(digs, (0, 0, 0, gpad))
        chunks = digs.reshape(batch, groups, TREE_CHUNK_LANES)
        digs = _tree_level(lambda j: chunks[:, :, j], level, data_len_bytes)
        n = groups
    return digs[:, 0, :]


# ---------------------------------------------------------------------------
# Field-element sampling (oversample-and-reduce, vdaf/xof.py)
# ---------------------------------------------------------------------------


def sample_count_blocks(tf, length: int) -> int:
    """Number of stream blocks needed to sample `length` elements."""
    return -(-length * (tf.LIMBS + 1) // RATE_LANES)


def sample_field_vec(tf, stream_lanes, length: int):
    """Sample `length` field elements by reducing (LIMBS+1)-lane
    little-endian chunks mod p. stream_lanes: [batch, out_blocks, 21];
    returns a field value of shape [batch, length]."""
    batch = stream_lanes.shape[0]
    g = tf.LIMBS + 1
    flat = stream_lanes.reshape(batch, -1)
    assert flat.shape[1] >= length * g
    lanes = tuple(flat[:, i : length * g : g] for i in range(g))
    if tf.LIMBS == 1:
        return (_f64_reduce_wide(lanes[0], lanes[1]),)
    return _f128_reduce256(lanes[0], lanes[1], lanes[2], torch.zeros_like(lanes[0]))


def expand_field_vec(tf, prefix_parts, prefix_len_bytes: int, batch: int, length: int, device, block_offset: int = 0):
    """XOF-expand per-report prefixes (dst16 || seed || binder', binder
    already inline-size) to a field value [batch, length].

    Field128 goes through the fused expansion (kernel 2); Field64 through
    the counter-mode stream (kernel 1) and plain sampling.
    """
    assert prefix_len_bytes % 8 == 0
    blocks = sample_count_blocks(tf, length)
    if tf.LIMBS == 2:
        prefix = _assemble_segments(prefix_parts, prefix_len_bytes // 8, batch, device)
        return expand_f128(prefix, blocks, length, block_offset=block_offset, rounds=KECCAK_ROUNDS)
    out = ctr_stream_lanes(prefix_parts, prefix_len_bytes, batch, blocks, device, ctr_offset=block_offset)
    return sample_field_vec(tf, out, length)
