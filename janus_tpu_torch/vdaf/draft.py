"""Batched Prio3 on the device for `xof_mode: "draft"`: the VDAF-07 framing.

Draft mode exists for pairing with other implementations: it follows
the draft-irtf-cfrg-vdaf-07 XofShake128 construction that upstream
Janus uses through `prio` 0.15 (sequential sponge, 8-byte DSTs,
single-byte aggregator ids, full-share joint-rand binders, rejection
sampling). The port's counterpart of the JAX package's
vdaf/draft_jax.py, value for value; the host oracle is
vdaf/xof.py XofSponge128.

Two things differ from the fast framing:

- **Byte-misaligned framing.** The absorb layout
  ``byte(len(dst)) || dst8 || seed16 || binder`` puts the seed at byte
  9 and the binder at byte 25, off the u64 lanes. `_assemble_bytes`
  ORs every segment, shifted by its byte offset with logical shifts,
  into one preallocated lane tensor.
- **Rejection sampling without gathers.** Field elements are drawn by
  rejecting candidates >= p. Element e is filled by candidate e+j
  (j <= _REJECT_WINDOW) exactly when that candidate is accepted and j
  rejects precede it: elementwise masks over shifted slices and one
  prefix sum. An exhausted window leaves a zero tail, which the FLP
  check then rejects; it never yields a wrong accepted value.

Every permutation is one launch of the full Keccak-f[1600] kernel
(ops/keccak_cuda.keccak_f1600) over one state per report, through the
sequential sponge of vdaf/keccak.py. The chain is one launch per block,
so a SumVec(1000, 16) joint-rand part (a 256,017-byte binder) is some
1,525 launches.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..fields.tfield import i64, lsr, ult
from .feasibility import feasible_rows
from .keccak import RATE_LANES, shake128_squeeze_lanes
from .prio3 import Prio3Batched, field_value_to_enc_lanes
from .xof import (
    SEED_SIZE,
    USAGE_JOINT_RAND_PART,
    USAGE_JOINT_RAND_SEED,
    USAGE_JOINT_RANDOMNESS,
    USAGE_QUERY_RANDOMNESS,
    draft_dst,
)

RATE = 8 * RATE_LANES  # 168
DRAFT_DST_SIZE = 8
PREFIX_BYTES = 1 + DRAFT_DST_SIZE + SEED_SIZE  # byte(len dst) || dst || seed

# Inputs from which the JAX package runs the FLP query streamed over
# tiles (its vdaf/engine.py STREAM_MIN_INPUT_LEN). The streamed query is
# not ported yet, so the port's draft engine stops below it.
STREAM_MIN_INPUT_LEN = 1 << 17


def _shift_lanes(lanes, s: int):
    """Prepend s (0..7) zero bytes to a little-endian u64 lane string
    [batch, k] -> [batch, k+1] (the tail lane carries the spill)."""
    batch, k = lanes.shape
    out = torch.zeros((batch, k + 1), dtype=torch.int64, device=lanes.device)
    if s == 0:
        out[:, :k] = lanes
        return out
    out[:, :k] = lanes << (8 * s)
    out[:, 1:] |= lsr(lanes, 64 - 8 * s)
    return out


def _assemble_bytes(segments, msg_len_bytes: int, batch: int, device):
    """Byte-offset segments -> padded SHAKE128 message blocks.

    segments: list of (byte_offset, content) with content either host
    bytes (any length; broadcast) or a [batch, k] int64 lane tensor
    (byte length 8k). Segments must occupy disjoint bytes. Every segment
    is ORed into one preallocated [batch, total_lanes] tensor. Returns
    [batch, n_blocks, RATE_LANES] int64 ready for the sponge.
    """
    n_blocks = msg_len_bytes // RATE + 1
    total_lanes = n_blocks * RATE_LANES
    out = torch.zeros((batch, total_lanes), dtype=torch.int64, device=device)
    # SHAKE padding: 0x1F after the message, 0x80 at the last rate byte
    # (bit-disjoint even when they share a byte or a lane)
    segments = list(segments) + [
        (msg_len_bytes, b"\x1f"),
        (total_lanes * 8 - 1, b"\x80"),
    ]
    for off, content in segments:
        base, s = divmod(off, 8)
        if isinstance(content, (bytes, bytearray)):
            raw = b"\x00" * s + bytes(content)
            raw = raw.ljust(-(-len(raw) // 8) * 8, b"\x00")
            row = np.frombuffer(raw, dtype="<u8").view(np.int64).copy()
            seg = torch.from_numpy(row).to(device)[None, :]
        else:
            assert content.dtype == torch.int64 and content.device == out.device
            seg = _shift_lanes(content, s)
        width = seg.shape[1]
        assert base + width <= total_lanes + 1, (off, width, total_lanes)
        seg = seg[:, : total_lanes - base]  # drop an all-zero spill tail
        out[:, base : base + seg.shape[1]] |= seg
    return out.view(batch, n_blocks, RATE_LANES)


def _sponge_stream(segments, msg_len_bytes: int, batch: int, out_blocks: int, device):
    """Draft sponge: absorb the assembled message, squeeze sequentially.
    Returns [batch, out_blocks * RATE_LANES] int64 stream lanes."""
    msg = _assemble_bytes(segments, msg_len_bytes, batch, device)
    out = shake128_squeeze_lanes(msg, out_blocks)
    return out.reshape(batch, -1)


# Rejected candidates absorbed per expansion before the output tail
# degrades to zero (and the report fails the FLP check). P(> 8 rejects)
# even for Field64 at 10M candidates is ~(10M * 2^-32)^9 / 9! ~ 2^-80;
# Field128's per-candidate reject probability is 2^-68.
_REJECT_WINDOW = 8


def _candidate_count(tf, length: int) -> int:
    """Candidates sampled per vector: the window plus slack so every
    shifted slice below stays in range."""
    return length + 2 * _REJECT_WINDOW


def _reject_sample(tf, stream_lanes, length: int):
    """Order-exact draft rejection sampling from contiguous
    ENCODED_SIZE-byte candidates. Returns a field value [batch, length];
    if more than _REJECT_WINDOW candidates are rejected, the missing
    tail is zero.

    Candidate e+j (j <= window) fills element e exactly when it is
    accepted and j rejects precede it. The compares are unsigned: p of
    Field64 and the high limb of Field128's p are >= 2^63, negative as
    int64.
    """
    c_n = _candidate_count(tf, length)
    limbs = tf.LIMBS
    cand = tuple(stream_lanes[:, i : c_n * limbs : limbs] for i in range(limbs))  # [batch, C] limbs
    if limbs == 1:
        accept = ult(cand[0], tf.MODULUS)
    else:
        p_lo = i64(tf.MODULUS & ((1 << 64) - 1))
        p_hi = i64(tf.MODULUS >> 64)
        accept = ult(cand[1], p_hi) | ((cand[1] == p_hi) & ult(cand[0], p_lo))
    # rejects strictly before each candidate (exclusive prefix sum)
    rej = (~accept).to(torch.int32)
    rejects_before = torch.cumsum(rej, dim=1) - rej
    out = tuple(torch.zeros((stream_lanes.shape[0], length), dtype=torch.int64, device=stream_lanes.device)
                for _ in range(limbs))
    for j in range(_REJECT_WINDOW + 1):
        sel = accept[:, j : j + length] & (rejects_before[:, j : j + length] == j)
        for o, c in zip(out, cand):
            o |= torch.where(sel, c[:, j : j + length], 0)
    return out


def _stream_blocks_for(tf, length: int) -> int:
    lanes = _candidate_count(tf, length) * tf.LIMBS
    return -(-lanes // RATE_LANES)


class Prio3BatchedDraft(Prio3Batched):
    """Device Prio3 with the VDAF-07 draft XOF framing.

    Shares the whole FLP and field pipeline with the fast engine; only
    the XOF plumbing (framing, sampling, binder choices) differs.
    """

    # Most sponge blocks per expansion (absorb or squeeze side), as in
    # the JAX package. Below STREAM_MIN_INPUT_LEN no circuit comes near.
    MAX_STREAM_BLOCKS = 160_000

    # Fewest report rows the device memory budget must hold for the
    # draft engine to take a circuit.
    MIN_DEVICE_ROWS = 8

    @classmethod
    def refusal(cls, circ, budget_bytes=None) -> str | None:
        """Why this engine does not take `circ` under `budget_bytes`
        (None: unknown, no memory bound), or None when it does."""
        if circ.input_len >= STREAM_MIN_INPUT_LEN:
            return (
                f"draft mode at input_len {circ.input_len} (>= 2^17) needs the streamed query, "
                "which janus_tpu_torch has not ported yet"
            )
        limbs = circ.FIELD.ENCODED_SIZE // 8
        longest = max(
            circ.input_len, circ.proof_len, circ.prove_rand_len, circ.query_rand_len, circ.joint_rand_len
        )
        blocks = math.ceil((longest + 2 * _REJECT_WINDOW) * limbs / RATE_LANES)
        # absorb side: the longest binder is the encoded measurement share
        absorb_blocks = (PREFIX_BYTES + 1 + SEED_SIZE + circ.input_len * circ.FIELD.ENCODED_SIZE) // RATE + 1
        if max(blocks, absorb_blocks) > cls.MAX_STREAM_BLOCKS:
            return f"draft-mode streams of {max(blocks, absorb_blocks)} blocks exceed {cls.MAX_STREAM_BLOCKS}"
        rows = feasible_rows(circ, budget_bytes, draft=True)
        if rows is not None and rows < cls.MIN_DEVICE_ROWS:
            return f"only {rows} rows fit the device memory budget of {budget_bytes} bytes (vdaf/feasibility.py)"
        return None

    @classmethod
    def supports_circuit(cls, circ, budget_bytes=None) -> bool:
        return cls.refusal(circ, budget_bytes) is None

    # --- draft XOF plumbing ---
    def _prefix_segments(self, usage: int, seed):
        """byte(8) || dst8 at offset 0 (static), seed16 at offset 9."""
        head = bytes([DRAFT_DST_SIZE]) + draft_dst(self.circ.algo_id, usage)
        if isinstance(seed, (bytes, bytearray)):
            return [(0, head + bytes(seed))]
        return [(0, head), (9, seed)]

    def _draft_stream(self, usage: int, seed, binder_segs, binder_len: int, batch: int, out_blocks: int):
        segs = self._prefix_segments(usage, seed) + [(PREFIX_BYTES + off, content) for off, content in binder_segs]
        return _sponge_stream(segs, PREFIX_BYTES + binder_len, batch, out_blocks, self.device)

    def _expand_vec_draft(self, usage: int, seed, binder_segs, binder_len: int, length: int, batch: int):
        stream = self._draft_stream(usage, seed, binder_segs, binder_len, batch, _stream_blocks_for(self.tf, length))
        return _reject_sample(self.tf, stream, length)

    def _derive_seed_draft(self, usage: int, seed, binder_segs, binder_len: int, batch: int):
        return self._draft_stream(usage, seed, binder_segs, binder_len, batch, 1)[:, : SEED_SIZE // 8]

    # --- overrides of the fast-framing plumbing ---
    def _expand_share(self, seed_lanes, usage: int, length: int):
        return self._expand_vec_draft(usage, seed_lanes, [(0, b"\x01")], 1, length, seed_lanes.shape[0])

    def _expand_vec(self, usage: int, seed_lanes, binder_parts, binder_len: int, length: int):
        # the shared pipeline calls this only with an empty binder (prove
        # and joint randomness); share expansion goes through _expand_share
        assert not binder_parts and binder_len == 0, "draft binders use byte segments"
        return self._expand_vec_draft(usage, seed_lanes, [], 0, length, seed_lanes.shape[0])

    def _part_binder(self, agg_id: int, meas, helper_seed):
        # draft binds the full encoded share for both aggregators
        return field_value_to_enc_lanes(self.tf, meas)

    def _joint_rand_part(self, agg_id: int, blind_lanes, nonce_lanes, share_binder_lanes):
        binder_len = 1 + SEED_SIZE + 8 * share_binder_lanes.shape[-1]
        segs = [(0, bytes([agg_id])), (1, nonce_lanes), (1 + SEED_SIZE, share_binder_lanes)]
        return self._derive_seed_draft(USAGE_JOINT_RAND_PART, blind_lanes, segs, binder_len, blind_lanes.shape[0])

    def _joint_rand_seed(self, part0_lanes, part1_lanes):
        segs = [(0, part0_lanes), (SEED_SIZE, part1_lanes)]
        return self._derive_seed_draft(
            USAGE_JOINT_RAND_SEED, b"\x00" * SEED_SIZE, segs, 2 * SEED_SIZE, part0_lanes.shape[0]
        )

    def _joint_rand(self, jr_seed_lanes):
        return self._expand_vec(USAGE_JOINT_RANDOMNESS, jr_seed_lanes, [], 0, self.circ.joint_rand_len)

    def _query_rand(self, verify_key: bytes, nonce_lanes):
        return self._expand_vec_draft(
            USAGE_QUERY_RANDOMNESS, verify_key, [(0, nonce_lanes)], SEED_SIZE,
            self.circ.query_rand_len, nonce_lanes.shape[0],
        )
