"""Batched Prio3 on the device for `xof_mode: "draft"`: the VDAF-07 framing.

Draft mode exists for pairing with other implementations: it follows
the draft-irtf-cfrg-vdaf-07 XofShake128 construction that upstream
Janus uses through `prio` 0.15 (sequential sponge, 8-byte DSTs,
single-byte aggregator ids, full-share joint-rand binders, rejection
sampling). The port's counterpart of the JAX package's
vdaf/draft_jax.py, value for value; the host oracle is
vdaf/xof.py XofSponge128.

Every draft XOF call (a derived seed, or a field vector drawn by
rejection sampling) is one launch of the whole-sponge kernel
(ops/sponge_cuda.keccak_sponge) over one state per report:

- **Byte-misaligned framing.** The absorb layout
  ``byte(len(dst)) || dst8 || seed16 || binder`` puts the seed at byte
  9 and the binder at byte 25, off the u64 lanes. The short head up to
  the body is ORed on the host into a [batch, <= 21] lane tensor; the
  one long binder, a joint-rand part's encoded share (256,000 bytes at
  SumVec(1000, 16)), is the kernel's body: it reads the share's limb
  planes in place at byte 42 and shifts them itself.
- **Rejection sampling in the squeeze.** Field elements are drawn by
  rejecting candidates >= p; an accepted candidate fills the next
  element while at most REJECT_WINDOW were rejected before it. An
  exhausted window leaves a zero tail, which the FLP check then
  rejects; it never yields a wrong accepted value.

At long inputs (vdaf/engine.py stream_plan) the query streams as in fast
mode, but the sponge has no random access: the helper's share is
expanded whole once (its joint-rand binder hashes it whole anyway) and
the query reads it a tile at a time.
"""

from __future__ import annotations

import math

from ..ops.sponge_cuda import REJECT_WINDOW, keccak_sponge, or_segments
from . import keccak
from .engine import batched_circuit, stream_plan
from .feasibility import feasible_rows
from .prio3 import Prio3Batched
from .xof import (
    SEED_SIZE,
    USAGE_JOINT_RAND_PART,
    USAGE_JOINT_RAND_SEED,
    USAGE_JOINT_RANDOMNESS,
    USAGE_QUERY_RANDOMNESS,
    draft_dst,
)

RATE = 8 * keccak.RATE_LANES  # 168
DRAFT_DST_SIZE = 8
PREFIX_BYTES = 1 + DRAFT_DST_SIZE + SEED_SIZE  # byte(len dst) || dst || seed


class Prio3BatchedDraft(Prio3Batched):
    """Device Prio3 with the VDAF-07 draft XOF framing.

    Shares the whole FLP and field pipeline with the fast engine; only
    the XOF plumbing (framing, sampling, binder choices) differs.
    """

    # The query streams; the helper's share is expanded whole (no block
    # offsets in a sponge), then read a tile at a time.
    _can_stream = True
    _stream_expand_offsets = False

    # Most sponge blocks per expansion (absorb or squeeze side), as in
    # the JAX package: SumVec(100000, 16)'s joint-rand part absorbs
    # 152,382 blocks (25.6 MB of encoded share a report).
    MAX_STREAM_BLOCKS = 160_000

    # Fewest report rows the device memory budget must hold for the
    # draft engine to take a circuit.
    MIN_DEVICE_ROWS = 8

    @classmethod
    def refusal(cls, circ, budget_bytes=None) -> str | None:
        """Why this engine does not take `circ` under `budget_bytes`
        (None: unknown, no memory bound), or None when it does. The
        memory model is the tiled one where the query streams."""
        limbs = circ.FIELD.ENCODED_SIZE // 8
        longest = max(
            circ.input_len, circ.proof_len, circ.prove_rand_len, circ.query_rand_len, circ.joint_rand_len
        )
        blocks = math.ceil((longest + 2 * REJECT_WINDOW) * limbs / keccak.RATE_LANES)
        # absorb side: the longest binder is the encoded measurement share
        absorb_blocks = (PREFIX_BYTES + 1 + SEED_SIZE + circ.input_len * circ.FIELD.ENCODED_SIZE) // RATE + 1
        if max(blocks, absorb_blocks) > cls.MAX_STREAM_BLOCKS:
            return f"draft-mode streams of {max(blocks, absorb_blocks)} blocks exceed {cls.MAX_STREAM_BLOCKS}"
        plan = stream_plan(batched_circuit(circ))
        rows = feasible_rows(circ, budget_bytes, tile_elems=plan.group if plan else None, draft=True)
        if rows is not None and rows < cls.MIN_DEVICE_ROWS:
            return f"only {rows} rows fit the device memory budget of {budget_bytes} bytes (vdaf/feasibility.py)"
        return None

    @classmethod
    def supports_circuit(cls, circ, budget_bytes=None) -> bool:
        return cls.refusal(circ, budget_bytes) is None

    # --- draft XOF plumbing ---
    def _draft_xof(self, usage: int, seed, head_segs, head_len: int, batch: int, body=(), **out):
        """One draft XOF call per report: absorb byte(8) || dst8 || seed16
        || head segments (head_len bytes) || body, then squeeze as `out`
        asks (keccak_sponge's out_lanes or sample)."""
        prefix = bytes([DRAFT_DST_SIZE]) + draft_dst(self.circ.algo_id, usage)
        if isinstance(seed, (bytes, bytearray)):
            segs = [(0, prefix + bytes(seed))]
        else:
            segs = [(0, prefix), (1 + DRAFT_DST_SIZE, seed)]
        segs += [(PREFIX_BYTES + off, content) for off, content in head_segs]
        head_bytes = PREFIX_BYTES + head_len
        head = or_segments(segs, -(-head_bytes // 8), batch, self.device)
        body_bytes = 8 * body[0].shape[1] * len(body) if body else 0
        return keccak_sponge(
            head, head_bytes + body_bytes, body=body, body_off=head_bytes, rounds=keccak.KECCAK_ROUNDS, **out
        )

    def _expand_vec_draft(self, usage: int, seed, head_segs, head_len: int, length: int, batch: int):
        sample = (length, self.tf.LIMBS, self.tf.MODULUS)
        return self._draft_xof(usage, seed, head_segs, head_len, batch, sample=sample)

    def _derive_seed_draft(self, usage: int, seed, head_segs, head_len: int, batch: int, body=()):
        return self._draft_xof(usage, seed, head_segs, head_len, batch, body, out_lanes=SEED_SIZE // 8)

    # --- overrides of the fast-framing plumbing ---
    def _expand_share(self, seed_lanes, usage: int, length: int):
        return self._expand_vec_draft(usage, seed_lanes, [(0, b"\x01")], 1, length, seed_lanes.shape[0])

    def _expand_vec(self, usage: int, seed_lanes, binder_parts, binder_len: int, length: int):
        # the shared pipeline calls this only with an empty binder (prove
        # and joint randomness); share expansion goes through _expand_share
        assert not binder_parts and binder_len == 0, "draft binders use byte segments"
        return self._expand_vec_draft(usage, seed_lanes, [], 0, length, seed_lanes.shape[0])

    def _part_binder(self, agg_id: int, meas, helper_seed):
        # draft binds the full encoded share for both aggregators: its limb
        # planes, which the sponge reads in place
        return meas

    def _joint_rand_part(self, agg_id: int, blind_lanes, nonce_lanes, share_binder):
        segs = [(0, bytes([agg_id])), (1, nonce_lanes)]
        return self._derive_seed_draft(
            USAGE_JOINT_RAND_PART, blind_lanes, segs, 1 + SEED_SIZE, blind_lanes.shape[0], body=share_binder
        )

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
