"""The leader's side of one aggregation job, for tests and chip_smoke.py.

`leader_init_request` turns a report batch (the step args of
vdaf/testing.py `make_report_batch`) into the AggregationJobInitializeReq
a leader sends: the helper shares and public shares encoded with
Prio3Wire, each helper share HPKE-sealed under the task's config, the
leader's prep shares from `EngineCache.leader_init` over host columns,
framed as ping-pong initialize messages. `leader_stored_reports` turns
the same batch into the rows an upload leaves in a leader's datastore
(the leader share decoded, the helper share sealed), which the job
creator and the job driver (`aggregation_job_driver.py`) then aggregate.
`TaskprovHeaderHttp` is the leader's HTTP client of a taskprov task: the
job drivers send the `dap-taskprov` header through it.
"""

from __future__ import annotations

import base64
from dataclasses import dataclass

import numpy as np
import torch

from ..convert import to_numpy_u64
from ..core.hpke import HpkeApplicationInfo, Label, hpke_seal
from ..core.http_client import HttpClient
from ..datastore.models import LeaderStoredReport
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
from ..messages.taskprov import TASKPROV_HEADER, TaskConfig
from ..vdaf.engine import tf_for
from ..vdaf.registry import circuit_for
from ..vdaf.wire import (
    PP_FINISH,
    Prio3Wire,
    decode_pingpong,
    encode_field_rows,
    encode_pingpong_share_column,
    lanes_to_seed_rows,
)


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


def leader_stored_reports(task, helper_config, step_args, times) -> list[LeaderStoredReport]:
    """The leader's stored reports of a report batch, as an upload leaves
    them: the leader share encoded (measurement || proof || blind), the
    public share encoded, the helper share HPKE-sealed under
    `helper_config` (the helper task's HpkeConfig). step_args: as
    `leader_init_request` takes them; the nonces double as report ids.
    times: the client time (seconds) of each report."""
    nonce, public, meas, proof, blind0, seeds, blind1 = (_host(a) for a in step_args)
    circ = circuit_for(task.vdaf)
    wire = Prio3Wire(circ)
    tf = tf_for(circ)
    n = nonce.shape[0]
    meas_rows = encode_field_rows(tf, meas)
    proof_rows = encode_field_rows(tf, proof)
    ids = lanes_to_seed_rows(nonce)
    seed_rows = lanes_to_seed_rows(seeds)
    blind0_rows = lanes_to_seed_rows(blind0) if wire.uses_jr else [None] * n
    blind1_rows = lanes_to_seed_rows(blind1) if wire.uses_jr else [None] * n
    part_rows = [lanes_to_seed_rows(public[:, 0]), lanes_to_seed_rows(public[:, 1])] if wire.uses_jr else None
    info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.HELPER)
    out = []
    for i in range(n):
        md = ReportMetadata(ReportId(ids[i]), Time(int(times[i])))
        public_share = wire.encode_public_share([part_rows[0][i], part_rows[1][i]] if wire.uses_jr else [])
        payload = PlaintextInputShare((), wire.encode_helper_share(seed_rows[i], blind1_rows[i])).to_bytes()
        ct = hpke_seal(helper_config, info, payload, InputShareAad(task.task_id, md, public_share).to_bytes())
        leader_share = wire.encode_leader_share_raw(meas_rows[i] + proof_rows[i], blind0_rows[i])
        out.append(LeaderStoredReport(task.task_id, md.report_id, md.time, public_share, leader_share, ct))
    return out


class TaskprovHeaderHttp(HttpClient):
    """Leader-side HTTP client that attaches the dap-taskprov header to
    the helper-bound aggregation and aggregate-share requests of one
    taskprov task (what a taskprov-aware leader sends; the job drivers
    take it as their `http`)."""

    def __init__(self, task_config: TaskConfig, **kwargs):
        super().__init__(**kwargs)
        self.header = base64.urlsafe_b64encode(task_config.to_bytes()).decode().rstrip("=")

    def _with_header(self, url, headers):
        if "aggregation_jobs" in url or "aggregate_shares" in url:
            headers = dict(headers or {})
            headers[TASKPROV_HEADER] = self.header
        return headers

    def put(self, url, body, headers=None, timeout=None):
        return super().put(url, body, self._with_header(url, headers), timeout=timeout)

    def post(self, url, body, headers=None, timeout=None):
        return super().post(url, body, self._with_header(url, headers), timeout=timeout)
