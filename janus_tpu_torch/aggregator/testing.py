"""The leader's side of one aggregation job, for tests and chip_smoke.py.

`leader_init_request` turns a report batch (the step args of
vdaf/testing.py `make_report_batch`) into the AggregationJobInitializeReq
a leader sends: the helper shares and public shares encoded with
Prio3Wire, each helper share HPKE-sealed under the task's config, the
leader's prep shares from `EngineCache.leader_init` over host columns,
framed as ping-pong initialize messages. The leader's job driver, which
builds the same request from stored reports, comes in a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..convert import to_numpy_u64
from ..core.hpke import HpkeApplicationInfo, Label, hpke_seal
from ..messages import (
    AggregationJobInitializeReq,
    HpkeCiphertext,
    HpkeConfigId,
    InputShareAad,
    PartialBatchSelector,
    PlaintextInputShare,
    PrepareInit,
    PrepareStepResult,
    ReportId,
    ReportMetadata,
    ReportShare,
    Role,
    Time,
)
from ..vdaf.wire import PP_FINISH, Prio3Wire, decode_pingpong, encode_pingpong_share_column, lanes_to_seed_rows


def _host(a):
    """A step arg as uint64 numpy (limb tuples mapped, None kept)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(_host(x) for x in a)
    return to_numpy_u64(a) if isinstance(a, torch.Tensor) else np.asarray(a, dtype=np.uint64)


@dataclass
class LeaderJob:
    """One job as the leader holds it after its init step."""

    request: bytes  # the encoded AggregationJobInitializeReq
    out0: object  # the leader's out shares (DeviceRows or DeviceRowsChunks)
    prep_msgs: list  # the prep message the leader expects per report (b"" without joint randomness)


def leader_init_request(task, engine, step_args, times, *, unknown_config: tuple = ()) -> LeaderJob:
    """Build the time-interval aggregate-init request of one job over a
    report batch.

    step_args: (nonce_lanes, public_parts, leader_meas, leader_proof,
    blind0, helper_seed, blind1), tensors or uint64 arrays; the nonces
    double as report ids. times: the client time (seconds) of each
    report. unknown_config: indices of reports whose ciphertext names a
    config id the task does not hold.
    """
    nonce, public, meas, proof, blind0, seeds, blind1 = (_host(a) for a in step_args)
    wire = Prio3Wire(engine.p3.circ)
    n = nonce.shape[0]
    out0, seed0, ver0, part0 = engine.leader_init(nonce, public, meas, proof, blind0)
    frames = encode_pingpong_share_column(engine.p3.tf, ver0, part0 if wire.uses_jr else None)
    ids = [ReportId(r) for r in lanes_to_seed_rows(nonce)]
    seed_rows = lanes_to_seed_rows(seeds)
    blind_rows = lanes_to_seed_rows(blind1) if wire.uses_jr else [None] * n
    part_rows = (
        [lanes_to_seed_rows(public[:, 0]), lanes_to_seed_rows(public[:, 1])] if wire.uses_jr else None
    )
    config = task.hpke_keys[0].config
    taken = {kp.config.id.id for kp in task.hpke_keys}
    stranger = HpkeConfigId(next(c for c in range(256) if c not in taken))
    info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.HELPER)
    inits = []
    for i in range(n):
        md = ReportMetadata(ids[i], Time(int(times[i])))
        public_share = wire.encode_public_share([part_rows[0][i], part_rows[1][i]] if wire.uses_jr else [])
        payload = PlaintextInputShare((), wire.encode_helper_share(seed_rows[i], blind_rows[i])).to_bytes()
        ct = hpke_seal(config, info, payload, InputShareAad(task.task_id, md, public_share).to_bytes())
        if i in unknown_config:
            ct = HpkeCiphertext(stranger, ct.encapsulated_key, ct.payload)
        inits.append(PrepareInit(ReportShare(md, public_share, ct), frames.row(i)))
    req = AggregationJobInitializeReq(b"", PartialBatchSelector.time_interval(), tuple(inits))
    prep_msgs = lanes_to_seed_rows(seed0) if seed0 is not None else [b""] * n
    return LeaderJob(req.to_bytes(), out0, prep_msgs)


def outcomes(resp) -> list:
    """Per report of an AggregationJobResp: the prep message of the
    helper's ping-pong finish (bytes), or the PrepareError of a reject."""
    out = []
    for r in resp.prepare_resps:
        if r.result.kind == PrepareStepResult.REJECT:
            out.append(r.result.prepare_error)
            continue
        tag, prep_msg, _ = decode_pingpong(r.result.message)
        if tag != PP_FINISH:
            raise ValueError(f"report {r.report_id}: ping-pong tag {tag}, not finish")
        out.append(prep_msg)
    return out
