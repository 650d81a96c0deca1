"""Batched XOF on the device: fast mode's counter-mode stream, tree digest
and sampling. (Draft mode's sequential sponge is one kernel launch per
XOF call, ops/sponge_cuda.py, driven from vdaf/draft.py.)

The counter-mode framing (vdaf/xof.py) makes every 168-byte output block
an independent single-block SHAKE128 message dst16 || seed || binder' ||
le64(i), so one batched permutation over [batch, n_blocks] states gives
the whole stream of every report in a batch; long binders are bound by
an arity-7 Merkle digest whose levels are each one batched permutation.
Byte-identical to the host oracle vdaf/xof.py and to the JAX package's
vdaf/keccak_jax.py.

Every fast-mode permutation here is one launch of kernel 1
(ops/keccak_cuda.py: `keccak_ctr_blocks` for a stream, `keccak_tree_level`
for a tree level), which reads the message parts where they lie and
writes only the lanes the caller reads; every Field128 expansion is the
fused kernel 2 (ops/expand_cuda.expand_f128). Each wrapper chooses by
the device: the kernel on CUDA, its plain version on the CPU.
"""

from __future__ import annotations

import torch

from ..fields.tfield import _f64_reduce_wide, _f128_reduce256
from ..ops.expand_cuda import expand_f128
from ..ops.keccak_cuda import RATE_LANES, assemble_lanes, keccak_ctr_blocks, keccak_tree_level

# Round count of every permutation in this module and in draft mode's
# sponge (vdaf/draft.py): 24 always in production; a test lowers it to
# hold a reduced-round run against the JAX package at the same count.
KECCAK_ROUNDS = 24


def ctr_stream_lanes(prefix_parts, prefix_len_bytes: int, batch: int, out_blocks: int, device, ctr_offset: int = 0,
                     out_lanes: int = RATE_LANES):
    """Counter-mode SHAKE128 stream: [batch, out_blocks, out_lanes] int64
    lanes, the first out_lanes of each block's 21.

    prefix_parts: (lane_offset, content) segments of the prefix
    dst16 || seed || binder' (binder' already inline-size). Block i of
    the stream is the single-block message prefix || le64(ctr_offset + i).
    """
    assert prefix_len_bytes % 8 == 0
    return keccak_ctr_blocks(prefix_parts, prefix_len_bytes // 8, batch, out_blocks, out_lanes, device,
                             ctr_offset=ctr_offset, rounds=KECCAK_ROUNDS)


def tree_digest_lanes(data_parts, data_len_bytes: int, batch: int, device):
    """Arity-7 Merkle digest of lane-aligned data: [batch, 2] int64 lanes.

    Byte-identical to vdaf/xof.tree_digest. Each level is one batched
    permutation over all of that level's nodes, reading its input in
    place: the leaf level the data parts with the planar leaf mapping
    (lane j of leaf k = data lane j*n + k), each level above the
    digests [batch, n, 2] below it as 2n lanes.
    """
    assert data_len_bytes % 8 == 0
    digs = keccak_tree_level(data_parts, data_len_bytes // 8, batch, 0, data_len_bytes, device,
                             rounds=KECCAK_ROUNDS)
    level = 0
    while digs.shape[1] > 1:
        level += 1
        lanes = digs.reshape(batch, -1)
        digs = keccak_tree_level([(0, lanes)], lanes.shape[1], batch, level, data_len_bytes, device,
                                 rounds=KECCAK_ROUNDS)
    return digs[:, 0, :]


# ---------------------------------------------------------------------------
# Field-element sampling (oversample-and-reduce, vdaf/xof.py)
# ---------------------------------------------------------------------------


def sample_count_blocks(tf, length: int) -> int:
    """Number of stream blocks needed to sample `length` elements."""
    return -(-length * (tf.LIMBS + 1) // RATE_LANES)


def sample_field_vec(tf, stream_lanes, length: int):
    """Sample `length` field elements by reducing (LIMBS+1)-lane
    little-endian chunks mod p. stream_lanes: [batch, out_blocks, 21],
    or [batch, 1, k] with k >= LIMBS + 1 lanes per element sampled;
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
        prefix = assemble_lanes(prefix_parts, prefix_len_bytes // 8, batch, device)
        return expand_f128(prefix, blocks, length, block_offset=block_offset, rounds=KECCAK_ROUNDS)
    out = ctr_stream_lanes(prefix_parts, prefix_len_bytes, batch, blocks, device, ctr_offset=block_offset)
    return sample_field_vec(tf, out, length)
