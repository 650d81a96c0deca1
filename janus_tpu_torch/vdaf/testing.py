"""Report-batch generation for tests, benchmarks and load drivers.

The numpy draws are those of the JAX package's vdaf/testing.py, so one
seed gives the same report batch in both packages; the shard runs on
the port's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_numpy_u64
from .registry import VdafInstance, prio3_batched


def random_measurements(inst: VdafInstance, batch: int, rng: np.random.Generator):
    if inst.kind == "count":
        return rng.integers(0, 2, size=batch)
    if inst.kind == "sum":
        return rng.integers(0, 1 << min(inst.bits, 62), size=batch)
    if inst.kind == "sumvec":
        return rng.integers(0, 1 << min(inst.bits, 62), size=(batch, inst.length))
    if inst.kind == "histogram":
        return rng.integers(0, inst.length, size=batch)
    raise ValueError(inst.kind)


def make_report_batch(inst: VdafInstance, measurements, seed: int = 0, shard_chunk: int = 0, device=None):
    """Shard a batch of measurements on the device (CUDA unless the
    caller passes device="cpu").

    Returns (step_args, measurements) where step_args is the positional
    tuple for parallel.api.two_party_step: (nonce_lanes, public_parts,
    leader_meas, leader_proof, blind0, helper_seed, blind1).

    shard_chunk > 0 shards in sub-batches of that size (the FLP prove
    peaks at [chunk, arity, n2] per sub-batch) and concatenates.
    """
    p3 = prio3_batched(inst, device)
    rng = np.random.default_rng(seed)
    batch = len(measurements)
    nonce_np = rng.integers(0, 1 << 63, size=(batch, 2), dtype=np.uint64)
    n_seeds = 4 if p3.uses_joint_rand else 2
    rand_np = rng.integers(0, 1 << 63, size=(batch, n_seeds, 2), dtype=np.uint64)
    nonce_lanes = from_numpy_u64(nonce_np, p3.device)
    rand_lanes = from_numpy_u64(rand_np, p3.device)

    def shard_slice(lo: int, hi: int):
        inp = p3.tf.from_ints(p3.bc.encode_batch(measurements[lo:hi]), p3.device)
        return p3.shard(inp, nonce_lanes[lo:hi], rand_lanes[lo:hi])

    step = shard_chunk if 0 < shard_chunk < batch else batch
    parts = [shard_slice(lo, min(lo + step, batch)) for lo in range(0, batch, step)]
    sh = {}
    for k, v in parts[0].items():
        if v is None:
            sh[k] = None
        elif isinstance(v, tuple):
            sh[k] = tuple(torch.cat([p[k][i] for p in parts]) for i in range(len(v)))
        else:
            sh[k] = torch.cat([p[k] for p in parts])
    args = (
        nonce_lanes,
        sh["public_parts"],
        sh["leader_meas"],
        sh["leader_proof"],
        sh["blind0"],
        sh["helper_seed"],
        sh["blind1"],
    )
    return args, measurements
