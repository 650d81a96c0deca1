"""Report-batch generation for tests, benchmarks and load drivers.

The numpy draws are those of the JAX package's vdaf/testing.py, so one
seed gives the same report batch in both packages; the shard runs on
the port's device. `make_wire_reports` is a batched client: the device
shard, then each report HPKE-sealed and framed as client.Client
`prepare_report` frames one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_numpy_u64, step_args_to_numpy
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
    if inst.kind == "countvec":
        return rng.integers(0, 2, size=(batch, inst.length))
    if inst.kind == "fixedpoint":
        # signed raw values small enough that any vector's L2 norm is < 1
        offset = 1 << (inst.bits - 1)
        hi = max(1, int(offset / (inst.length**0.5)) // 2)
        return rng.integers(-hi, hi, size=(batch, inst.length))
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


def make_wire_reports(
    inst: VdafInstance,
    measurements,
    task_id,
    leader_hpke_config,
    helper_hpke_config,
    time,
    seed: int = 0,
    shard_chunk: int = 0,
    device=None,
):
    """Shard a batch on the device and assemble full DAP Report messages
    (report ids are the shard's nonces, every report at `time`).
    shard_chunk is make_report_batch's."""
    from ..core.hpke import HpkeApplicationInfo, Label, hpke_seal
    from ..messages import InputShareAad, PlaintextInputShare, Report, ReportId, ReportMetadata, Role
    from .engine import tf_for
    from .registry import circuit_for
    from .wire import Prio3Wire, encode_field_rows, lanes_to_seed_rows

    circ = circuit_for(inst)
    tf = tf_for(circ)
    wire = Prio3Wire(circ)
    args, _ = make_report_batch(inst, measurements, seed=seed, shard_chunk=shard_chunk, device=device)
    nonce, public, meas, proof, blind0, seeds, blind1 = step_args_to_numpy(args)
    n = nonce.shape[0]
    meas_rows = encode_field_rows(tf, meas)
    proof_rows = encode_field_rows(tf, proof)
    seed_rows = lanes_to_seed_rows(seeds)
    blind0_rows = lanes_to_seed_rows(blind0) if wire.uses_jr else [None] * n
    blind1_rows = lanes_to_seed_rows(blind1) if wire.uses_jr else [None] * n
    parts = [lanes_to_seed_rows(public[:, 0]), lanes_to_seed_rows(public[:, 1])] if wire.uses_jr else None
    leader_info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
    helper_info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.HELPER)
    reports = []
    for i, rid in enumerate(lanes_to_seed_rows(nonce)):
        metadata = ReportMetadata(ReportId(rid), time)
        public_share = wire.encode_public_share([parts[0][i], parts[1][i]] if wire.uses_jr else [])
        leader_payload = wire.encode_leader_share_raw(meas_rows[i] + proof_rows[i], blind0_rows[i])
        helper_payload = wire.encode_helper_share(seed_rows[i], blind1_rows[i])
        aad = InputShareAad(task_id, metadata, public_share).to_bytes()
        leader_ct = hpke_seal(leader_hpke_config, leader_info, PlaintextInputShare((), leader_payload).to_bytes(), aad)
        helper_ct = hpke_seal(helper_hpke_config, helper_info, PlaintextInputShare((), helper_payload).to_bytes(), aad)
        reports.append(Report(metadata, public_share, leader_ct, helper_ct))
    return reports
