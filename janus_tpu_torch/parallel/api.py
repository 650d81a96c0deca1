"""The two-party prepare + aggregate step: the port's entry points.

`two_party_step` is everything the aggregators do per report in one
aggregation job (leader prepare-init, helper prepare-init, combine and
decide, finish, masked aggregate), as one function over a report batch;
`helper_init_step` is the helper's prepare-init alone, the serving hot
path. Both equal the JAX package's parallel/api.py on the same inputs.
One device, no mesh.
"""

from __future__ import annotations

from ..vdaf.registry import VdafInstance, prio3_batched


def two_party_step(inst: VdafInstance, verify_key: bytes, device=None):
    """A function mapping the column-batched report tensors to both
    aggregate shares and the accepted-report count. Runs on CUDA unless
    the caller passes device="cpu"."""
    p3 = prio3_batched(inst, device)

    def step(nonce_lanes, public_parts, leader_meas, leader_proof, blind0, helper_seed, blind1):
        out0, seed0, ver0, part0 = p3.prepare_init_leader(
            verify_key, nonce_lanes, public_parts, leader_meas, leader_proof, blind0
        )
        out1, seed1, ver1, part1 = p3.prepare_init_helper(
            verify_key, nonce_lanes, public_parts, helper_seed, blind1
        )
        mask, prep_msg = p3.prep_shares_to_prep(ver0, ver1, part0, part1)
        mask = p3.prepare_finish(seed0, prep_msg, mask)
        mask = p3.prepare_finish(seed1, prep_msg, mask)
        agg0 = p3.aggregate(out0, mask)
        agg1 = p3.aggregate(out1, mask)
        return agg0, agg1, mask.sum()

    return step


def helper_init_step(inst: VdafInstance, verify_key: bytes, device=None):
    """Helper-side prepare-init only: seeds in, (out share, corrected
    seed, verifier share, own joint-rand part) out."""
    p3 = prio3_batched(inst, device)

    def step(nonce_lanes, public_parts, helper_seed, blind1):
        return p3.prepare_init_helper(verify_key, nonce_lanes, public_parts, helper_seed, blind1)

    return step
