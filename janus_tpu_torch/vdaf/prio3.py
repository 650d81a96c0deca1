"""Batched Prio3 on the device: shard / prepare / aggregate over report batches.

Every step is a PyTorch computation over [batch]-leading tensors:

  - seeds, nonces and XOF-derived values are [batch, 2] int64 lane
    tensors (16-byte strings as little-endian u64 lanes),
  - field vectors are limb tuples (fields/tfield.py),
  - XOF expansion runs on the device through vdaf/keccak.py with the
    framing of the host oracle vdaf/xof.py,

so the values equal the JAX package's vdaf/prio3_jax.py on the same
inputs. Validity is a boolean lane mask throughout; an invalid report
never breaks the batch.

An engine whose `plan` is a StreamPlan (vdaf/engine.py stream_plan: the
long SumVec, CountVec and Histogram inputs) runs the streamed query. The
fast helper's measurement share is then expanded a tile at a time by
kernel 2 at a block offset and never exists whole; the leader's staged
share, which its joint-rand binder hashes whole, is read a tile at a time
(`sliced_meas_source`).
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..fields.tfield import fencode_lanes, fmap, fsum
from ..ops import scatter_cuda
from .circuits import AGG1, Circuit
from .engine import (
    BatchedCircuit,
    StreamPlan,
    batched_circuit,
    flp_decide_batched,
    flp_prove_batched,
    flp_query_batched,
    flp_query_streamed,
    sliced_meas_source,
    stream_plan,
)
from ..ops.keccak_cuda import assemble_lanes
from .keccak import ctr_stream_lanes, expand_field_vec, tree_digest_lanes
from .xof import (
    DST_SIZE,
    INLINE_BINDER_MAX,
    SEED_SIZE,
    TREE_DIGEST_SIZE,
    USAGE_JOINT_RAND_PART,
    USAGE_JOINT_RAND_SEED,
    USAGE_JOINT_RANDOMNESS,
    USAGE_MEASUREMENT_SHARE,
    USAGE_PROOF_SHARE,
    USAGE_PROVE_RANDOMNESS,
    USAGE_QUERY_RANDOMNESS,
    dst,
)

AGG0 = (0).to_bytes(8, "little")
SEED_LANES = SEED_SIZE // 8  # 2
DST_LANES = DST_SIZE // 8  # 2


class Prio3Batched:
    """Batched device Prio3 for one validity circuit, on one device.

    The device is CUDA unless the caller passes device="cpu"; with no
    CUDA and no explicit CPU device the constructor raises.
    """

    NUM_SHARES = 2
    # The streamed query's two flags, the JAX package's: _can_stream, the
    # query streams at long inputs (its math does not depend on the XOF
    # framing); _stream_expand_offsets, the helper's share can be expanded
    # at a block offset, so it never exists whole (counter mode only).
    _can_stream = True
    _stream_expand_offsets = True

    def __init__(self, circuit: Circuit, device=None):
        self.circ = circuit
        self.device = resolve_device(device)
        self.bc: BatchedCircuit = batched_circuit(circuit)
        self.tf = self.bc.tf
        # the streamed query's geometry, or None for the whole-share query;
        # tests and chip_smoke.py set another stream_plan(...) here
        self.plan: StreamPlan | None = stream_plan(self.bc) if self._can_stream else None

    # --- XOF plumbing (device) ---
    def _dst(self, usage: int) -> bytes:
        return dst(self.circ.algo_id, usage)

    def _prefix_parts(self, usage: int, seed_lanes, binder_parts, binder_len: int, batch: int):
        """Counter-mode prefix (dst||seed||binder') as lane segments.

        Binders longer than INLINE_BINDER_MAX are replaced by their tree
        digest, as vdaf/xof.XofCtr128 does.
        """
        if binder_len > INLINE_BINDER_MAX:
            # restricted to joint-rand-part; raise so the boundary
            # survives python -O
            if usage != USAGE_JOINT_RAND_PART:
                raise ValueError(f"tree-digest substitution restricted to joint-rand-part; got usage {usage}")
            digest = tree_digest_lanes(binder_parts, binder_len, batch, self.device)
            binder_parts = [(0, digest)]
            binder_len = TREE_DIGEST_SIZE
        parts = [(0, self._dst(usage)), (DST_LANES, seed_lanes)]
        off = DST_LANES + SEED_LANES
        for rel_off, content in binder_parts:
            parts.append((off + rel_off, content))
        return parts, DST_SIZE + SEED_SIZE + binder_len

    def _expand_vec(self, usage: int, seed_lanes, binder_parts, binder_len: int, length: int):
        """Field vector [batch, length] from per-report seeds + binder."""
        batch = seed_lanes.shape[0]
        parts, prefix_len = self._prefix_parts(usage, seed_lanes, binder_parts, binder_len, batch)
        return expand_field_vec(self.tf, parts, prefix_len, batch, length, self.device)

    def _derive_seed(self, usage: int, seed_lanes, binder_parts, binder_len: int, batch: int):
        """[batch, 2] output seed lanes."""
        parts, prefix_len = self._prefix_parts(usage, seed_lanes, binder_parts, binder_len, batch)
        return ctr_stream_lanes(parts, prefix_len, batch, 1, self.device, out_lanes=SEED_LANES)[:, 0, :]

    def _expand_share(self, seed_lanes, usage: int, length: int):
        """Expand a helper measurement/proof share: binder = AGG1."""
        return self._expand_vec(usage, seed_lanes, [(0, AGG1)], 8, length)

    def _expand_share_source(self, seed_lanes, usage: int, plan: StreamPlan):
        """The streamed query's source for the helper's share: step k is
        kernel 2's expansion of blocks [k * group / 7, (k + 1) * group / 7)
        of the share's stream, i.e. its elements [k * group, (k + 1) * group)."""
        batch = seed_lanes.shape[0]
        parts, prefix_len = self._prefix_parts(usage, seed_lanes, [(0, AGG1)], 8, batch)
        # the prefix is the same at every step: assembled once
        prefix = [(0, assemble_lanes(parts, prefix_len // 8, batch, self.device))]
        assert plan.group % 7 == 0, "a tile must be whole counter blocks"
        blocks = plan.group // 7

        def src(step: int):
            return expand_field_vec(
                self.tf, prefix, prefix_len, batch, plan.group, self.device, block_offset=step * blocks
            )

        return src

    def _part_binder(self, agg_id: int, meas, helper_seed):
        """The share binder of the joint-rand part: the leader binds its
        full encoded measurement share, the helper its 16-byte seed."""
        if agg_id == 0:
            return fencode_lanes(meas)
        return helper_seed

    def _joint_rand_part(self, agg_id: int, blind_lanes, nonce_lanes, share_binder_lanes):
        """derive_seed(blind, ..., agg_id8 + nonce + share_binder)."""
        agg = AGG0 if agg_id == 0 else AGG1
        return self._derive_seed(
            USAGE_JOINT_RAND_PART,
            blind_lanes,
            [(0, agg), (1, nonce_lanes), (1 + SEED_LANES, share_binder_lanes)],
            8 + SEED_SIZE + 8 * share_binder_lanes.shape[-1],
            blind_lanes.shape[0],
        )

    def _joint_rand_seed(self, part0_lanes, part1_lanes):
        return self._derive_seed(
            USAGE_JOINT_RAND_SEED,
            b"\x00" * SEED_SIZE,
            [(0, part0_lanes), (SEED_LANES, part1_lanes)],
            2 * SEED_SIZE,
            part0_lanes.shape[0],
        )

    def _joint_rand(self, jr_seed_lanes):
        return self._expand_vec(USAGE_JOINT_RANDOMNESS, jr_seed_lanes, [], 0, self.circ.joint_rand_len)

    def _query_rand(self, verify_key, nonce_lanes):
        """verify_key: 16 bytes (one task: passed to the kernels as
        constant lanes) or an int64 [batch, 2] lane tensor (a cross-task
        coalesced round: each lane carries its own task's key through the
        XOF like the per-lane nonce, read in place as a column by kernel
        1's counter launch and assembled into kernel 2's prefix)."""
        batch = nonce_lanes.shape[0]
        if isinstance(verify_key, (bytes, bytearray)):
            if len(verify_key) != SEED_SIZE:
                raise ValueError(f"verify key of {len(verify_key)} bytes, not {SEED_SIZE}")
        elif tuple(verify_key.shape) != (batch, SEED_LANES):
            raise ValueError(f"verify key lanes {tuple(verify_key.shape)}, not ({batch}, {SEED_LANES})")
        parts = [
            (0, self._dst(USAGE_QUERY_RANDOMNESS)),
            (DST_LANES, verify_key),
            (DST_LANES + SEED_LANES, nonce_lanes),
        ]
        return expand_field_vec(
            self.tf, parts, DST_SIZE + 2 * SEED_SIZE, batch, self.circ.query_rand_len, self.device
        )

    @property
    def uses_joint_rand(self) -> bool:
        return self.circ.joint_rand_len > 0

    # ------------------------------------------------------------------
    # shard (client / load-generator side, batched on device)
    # ------------------------------------------------------------------
    def shard(self, inp, nonce_lanes, rand_lanes):
        """Shard a batch of encoded measurements.

        inp: field value [batch, input_len] (from bc.encode_batch);
        nonce_lanes: [batch, 2]; rand_lanes: [batch, n_seeds, 2] with
        n_seeds = 2 (+2 with joint rand): prove, helper(, blind0, blind1).

        Returns a dict with public_parts [batch, 2, 2] (or None),
        leader_meas, leader_proof (field values), and the helper_seed and
        blind lanes passed through.
        """
        circ = self.circ
        tf = self.tf
        prove_seed = rand_lanes[:, 0]
        helper_seed = rand_lanes[:, 1]
        helper_meas = self._expand_share(helper_seed, USAGE_MEASUREMENT_SHARE, circ.input_len)
        leader_meas = tf.sub(inp, helper_meas)

        public_parts = None
        joint_rand = ()
        blind0 = blind1 = None
        if self.uses_joint_rand:
            blind0 = rand_lanes[:, 2]
            blind1 = rand_lanes[:, 3]
            part0 = self._joint_rand_part(0, blind0, nonce_lanes, self._part_binder(0, leader_meas, None))
            part1 = self._joint_rand_part(1, blind1, nonce_lanes, self._part_binder(1, helper_meas, helper_seed))
            joint_rand = self._joint_rand(self._joint_rand_seed(part0, part1))
            public_parts = torch.stack([part0, part1], dim=1)

        prove_rand = self._expand_vec(USAGE_PROVE_RANDOMNESS, prove_seed, [], 0, circ.prove_rand_len)
        proof = flp_prove_batched(self.bc, inp, prove_rand, joint_rand)
        helper_proof = self._expand_share(helper_seed, USAGE_PROOF_SHARE, circ.proof_len)
        return {
            "public_parts": public_parts,
            "leader_meas": leader_meas,
            "leader_proof": tf.sub(proof, helper_proof),
            "helper_seed": helper_seed,
            "blind0": blind0,
            "blind1": blind1,
        }

    # ------------------------------------------------------------------
    # prepare (aggregator side)
    # ------------------------------------------------------------------
    def prepare_init_leader(self, verify_key, nonce_lanes, public_parts, meas, proof, blind0):
        """Leader prepare-init over a batch.

        Returns (out_share, corrected_seed_lanes|None, verifier, own_part|None).
        """
        src = sliced_meas_source(self.bc, self.plan, meas) if self.plan is not None else None
        return self._prepare_init(verify_key, 0, nonce_lanes, public_parts, meas, proof, blind0, None, src)

    def prepare_init_helper(self, verify_key, nonce_lanes, public_parts, helper_seed, blind1):
        circ = self.circ
        proof = self._expand_share(helper_seed, USAGE_PROOF_SHARE, circ.proof_len)
        if self.plan is not None and self._stream_expand_offsets:
            # the fast helper's binder is its seed: nothing needs its whole
            # share, which kernel 2 expands a tile at a time
            src = self._expand_share_source(helper_seed, USAGE_MEASUREMENT_SHARE, self.plan)
            return self._prepare_init(verify_key, 1, nonce_lanes, public_parts, None, proof, blind1, helper_seed, src)
        meas = self._expand_share(helper_seed, USAGE_MEASUREMENT_SHARE, circ.input_len)
        src = sliced_meas_source(self.bc, self.plan, meas) if self.plan is not None else None
        return self._prepare_init(verify_key, 1, nonce_lanes, public_parts, meas, proof, blind1, helper_seed, src)

    def _prepare_init(self, verify_key, agg_id, nonce_lanes, public_parts, meas, proof, blind, helper_seed, src):
        """The shared prepare-init; `src` is the streamed query's source,
        None for the whole-share query over `meas`."""
        corrected_seed = None
        own_part = None
        joint_rand = ()
        if self.uses_joint_rand:
            # the binder (the leader's encoded share) is dropped right after
            own_part = self._joint_rand_part(
                agg_id, blind, nonce_lanes, self._part_binder(agg_id, meas, helper_seed)
            )
            other = public_parts[:, 1 - agg_id]
            parts = (own_part, other) if agg_id == 0 else (other, own_part)
            corrected_seed = self._joint_rand_seed(*parts)
            joint_rand = self._joint_rand(corrected_seed)
        query_rand = self._query_rand(verify_key, nonce_lanes)
        if src is not None:
            verifier, out_share = flp_query_streamed(
                self.bc, self.plan, src, proof, query_rand, joint_rand, self.NUM_SHARES
            )
            return out_share, corrected_seed, verifier, own_part
        verifier = flp_query_batched(self.bc, meas, proof, query_rand, joint_rand, self.NUM_SHARES)
        return self.bc.truncate(meas), corrected_seed, verifier, own_part

    def prep_shares_to_prep(self, verifier0, verifier1, part0=None, part1=None):
        """Combine both verifier shares: (accept_mask [batch], prep_msg_lanes|None)."""
        mask = flp_decide_batched(self.bc, self.tf.add(verifier0, verifier1))
        prep_msg = self._joint_rand_seed(part0, part1) if self.uses_joint_rand else None
        return mask, prep_msg

    def prepare_finish(self, corrected_seed, prep_msg, mask):
        """Final joint-randomness equality check, folded into the mask."""
        if self.uses_joint_rand:
            mask = mask & (prep_msg == corrected_seed).all(dim=-1)
        return mask

    # ------------------------------------------------------------------
    # aggregate
    # ------------------------------------------------------------------
    def aggregate(self, out_shares, mask):
        """Masked sum over the batch axis -> aggregate share [output_len].

        Invalid lanes contribute zero."""
        masked = fmap(lambda x: torch.where(mask[:, None], x, torch.zeros_like(x)), out_shares)
        return fsum(self.tf, masked, axis=0)

    def aggregate_buckets(self, out_shares, bucket_idx, k: int):
        """Per-bucket masked sums -> [k, output_len] field value.

        bucket_idx: [batch] int32 tensor assigning each lane to a batch
        bucket 0..k-1; rejected lanes carry -1 and land nowhere. k masked
        `aggregate`s, one bucket at a time, so the peak stays at one
        bucket's working set (a one-hot [batch, k, output_len] would grow
        with k). Equal to janus_tpu's Prio3Batched.aggregate_buckets, which
        pads k to a power of two for its compile cache; eager code has no
        such cache, so k stays as given."""
        parts = [self.aggregate(out_shares, bucket_idx == j) for j in range(k)]
        return tuple(torch.stack([p[i] for p in parts], dim=0) for i in range(self.tf.LIMBS))

    def merge_agg_shares(self, a, b):
        return self.tf.add(a, b)

    def scatter_rows(self, acc, values, flat_idx):
        """Scatter-add each report's compact lanes into a logical
        accumulator (block-sparse SumVec's aggregation): acc [L] Field128
        limbs, values [b, cm] compact out shares, flat_idx [b, cm] int32
        flat logical positions, with the sentinel L on every dropped lane
        (padding blocks, rejected reports, other buckets, padding rows).
        Returns the new accumulator; ops/scatter_cuda.py's kernel on the
        card, its plain version on the CPU. Equal to janus_tpu's
        Prio3Batched.scatter_rows and to Prio3Sparse.aggregate_sparse."""
        if self.tf.LIMBS != 2:
            raise ValueError("scatter_rows: Field128 circuits only")
        return scatter_cuda.scatter_rows(acc, values, flat_idx)
