"""Aggregator protocol handlers: the helper's aggregate-init.

The port's counterpart of janus_tpu/aggregator/core.py, as far as a
helper needs to answer an aggregate-init request for a one-round Prio3
task: `TaskAggregator` (keypair lookup, `hpke_config_list`,
`handle_aggregate_init`, the replay of a stored response) and
`Aggregator` (task lookup, one TaskAggregator per task). The request
runs the same steps as janus_tpu's, value for value:

1. HPKE-open the input shares (batched per config id);
2. decode them into columns (`vdaf/wire.py`);
3. one `engine.helper_init` over the batch (the card's work);
4. one masked `engine.aggregate` per batch bucket (`accumulator.py`);
5. write the job, its report aggregations and its batch aggregations
   in one transaction;
6. answer with the AggregationJobResp.

A TaskAggregator runs on CUDA unless it is built with device="cpu", and
so does an Aggregator. Each request leaves the seconds of its stages in
`stage_seconds`; a propagated deadline (core/deadline.py) is checked
between stages as janus_tpu checks it. Not ported yet: Poplar1,
multi-round continue, upload, collection, taskprov (and with it the
global HPKE keys), aggregate-share; and the observability calls of
janus_tpu's handler (metrics, trace spans, failpoints, the conservation
ledger).
"""

from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..core import deadline as deadline_mod
from ..core.hpke import HpkeApplicationInfo, HpkeError, Label, hpke_open_batch
from ..core.time_util import Clock, RealClock
from ..datastore.models import (
    AggregationJobModel,
    AggregationJobState,
    ReportAggregationModel,
    ReportAggregationState,
)
from ..datastore.store import Datastore
from ..device import resolve_device
from ..messages import (
    AggregationJobId,
    AggregationJobInitializeReq,
    AggregationJobResp,
    Duration,
    HpkeConfigList,
    InputShareAad,
    Interval,
    PrepareError,
    PrepareResp,
    PrepareStepResult,
    Role,
    TaskId,
    Time,
    plaintext_input_share_payload_fast,
)
from ..messages.codec import DecodeError
from ..task import Task
from ..vdaf.registry import circuit_for
from ..vdaf.wire import (
    PP_FINISH,
    PP_INITIALIZE,
    Prio3Wire,
    decode_pingpong,
    encode_pingpong,
    lanes_to_seed_rows,
    seeds_to_lanes,
    split_prep_share_columns,
)
from . import errors
from .accumulator import Accumulator, accumulate_batched, fixed_size_batch_id
from .engine_cache import engine_cache


def _err_or_default(err) -> PrepareError:
    """PrepareError.BATCH_COLLECTED has enum value 0 (falsy), so the
    `err or DEFAULT` idiom silently rewrites it; compare against None."""
    return err if err is not None else PrepareError.VDAF_PREP_ERROR


@dataclass
class Config:
    """reference aggregator.rs:186-218, the part the helper's
    aggregate-init reads."""

    batch_aggregation_shard_count: int = 1


class TaskAggregator:
    """Per-task protocol ops (reference aggregator.rs:797)."""

    def __init__(self, task: Task, cfg: Config, device=None):
        if task.vdaf.rounds != 1:
            raise ValueError(f"{task.vdaf.kind}: only one-round Prio3 is ported")
        self.task = task
        self.cfg = cfg
        self.circ = circuit_for(task.vdaf)
        self.wire = Prio3Wire(self.circ)
        self.engine = engine_cache(task.vdaf, task.vdaf_verify_key, device)
        self.stage_seconds: dict[str, float] = {}

    def hpke_config_list(self) -> HpkeConfigList:
        return HpkeConfigList(tuple(kp.config for kp in self.task.hpke_keys))

    # ------------------------------------------------------------------
    # helper aggregate init (reference aggregator.rs:1561)
    # ------------------------------------------------------------------
    def handle_aggregate_init(
        self,
        ds: Datastore,
        clock: Clock,
        job_id: AggregationJobId,
        req: AggregationJobInitializeReq,
        request_bytes: bytes,
    ) -> AggregationJobResp:
        task = self.task
        stage = self.stage_seconds = {}
        t0 = time.perf_counter()
        request_hash = hashlib.sha256(request_bytes).digest()

        # idempotent replay (reference :1585,1884,1526)
        existing = ds.run_tx(lambda tx: tx.get_aggregation_job(task.task_id, job_id), "agg_init_check")
        if existing is not None:
            if existing.last_request_hash == request_hash:
                return self._replay_aggregate_init_response(ds, job_id)
            raise errors.InvalidMessage("aggregation job id reuse", task.task_id)

        if req.partial_batch_selector.query_type != task.query_type.code:
            raise errors.InvalidMessage("partial batch selector query type mismatch", task.task_id)

        inits = list(req.prepare_inits)
        n = len(inits)
        ids = [pi.report_share.metadata.report_id for pi in inits]
        if len(set(ids)) != n:  # dup report ids (reference :1590)
            raise errors.InvalidMessage("duplicate report id in init request", task.task_id)

        now = clock.now()
        prep_err = [None] * n  # per-report PrepareError or None
        helper_seed_rows: list[bytes | None] = [None] * n
        blind_rows: list[bytes | None] = [None] * n
        part_rows0: list[bytes | None] = [None] * n
        part_rows1: list[bytes | None] = [None] * n
        leader_prep_rows: list[bytes | None] = [None] * n

        # pass 1: cheap per-report checks + keypair lookup; HPKE lanes
        # collect per config id for the batched opens
        kp_cache: dict = {}
        hpke_groups: dict = {}  # config id -> (keypair, [i], encs, pays, aads)
        for i, pi in enumerate(inits):
            rs = pi.report_share
            md = rs.metadata
            if task.task_expiration and md.time > task.task_expiration:
                prep_err[i] = PrepareError.TASK_EXPIRED
                continue
            if task.report_expired(md.time, now):
                prep_err[i] = PrepareError.REPORT_DROPPED
                continue
            cfg_id = rs.encrypted_input_share.config_id
            if cfg_id not in kp_cache:
                kp_cache[cfg_id] = task.hpke_keypair(cfg_id)
            keypair = kp_cache[cfg_id]
            if keypair is None:
                prep_err[i] = PrepareError.HPKE_UNKNOWN_CONFIG_ID
                continue
            group = hpke_groups.setdefault(cfg_id, (keypair, [], [], [], []))
            group[1].append(i)
            group[2].append(rs.encrypted_input_share.encapsulated_key)
            group[3].append(rs.encrypted_input_share.payload)
            group[4].append(InputShareAad(task.task_id, md, rs.public_share).to_bytes())

        # pass 2: one batched open per config-id group
        plaintexts: list[bytes | None] = [None] * n
        info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.HELPER)
        for keypair, idxs_g, encs_g, pays_g, aads_g in hpke_groups.values():
            deadline_mod.check("helper_decrypt")
            opened = hpke_open_batch(keypair, info, encs_g, pays_g, aads_g)
            for i, pt in zip(idxs_g, opened):
                if isinstance(pt, HpkeError):
                    prep_err[i] = PrepareError.HPKE_DECRYPT_ERROR
                else:
                    plaintexts[i] = pt
        t1 = time.perf_counter()
        stage["hpke_open"] = t1 - t0

        # pass 3: per-report payload/message decode into columns
        for i, pi in enumerate(inits):
            if prep_err[i] is not None or plaintexts[i] is None:
                continue
            rs = pi.report_share
            try:
                payload = plaintext_input_share_payload_fast(plaintexts[i])
                seed, blind = self.wire.decode_helper_share(payload)
                parts = self.wire.decode_public_share(rs.public_share)
                tag, _, prep_share = decode_pingpong(pi.message)
                if tag != PP_INITIALIZE or prep_share is None:
                    raise DecodeError("expected ping-pong initialize")
            except DecodeError:
                prep_err[i] = PrepareError.INVALID_MESSAGE
                continue
            helper_seed_rows[i] = seed
            blind_rows[i] = blind
            if self.wire.uses_jr:
                part_rows0[i] = parts[0]
                part_rows1[i] = parts[1]
            leader_prep_rows[i] = prep_share

        # replay check against prior aggregations: one set-valued query
        fresh_ids = [rid for i, rid in enumerate(ids) if prep_err[i] is None]
        deadline_mod.check("helper_replay_tx")
        replayed_ids = ds.run_tx(
            lambda tx: tx.get_aggregated_report_ids(task.task_id, fresh_ids), "agg_init_replay"
        )
        for i, rid in enumerate(ids):
            if prep_err[i] is None and rid.data in replayed_ids:
                prep_err[i] = PrepareError.REPORT_REPLAYED

        # columnar staging
        nonce_lanes, ok_nonce = seeds_to_lanes([rid.data for rid in ids])
        seed_lanes, ok_seed = seeds_to_lanes(helper_seed_rows)
        ver0, part0_lanes, ok_prep = split_prep_share_columns(self.wire, self.engine.p3.tf, leader_prep_rows)
        ok = ok_nonce & ok_seed & ok_prep & np.array([e is None for e in prep_err])
        if self.wire.uses_jr:
            blind_lanes, ok_b = seeds_to_lanes(blind_rows)
            p0_pub, ok_p0 = seeds_to_lanes(part_rows0)
            p1_pub, ok_p1 = seeds_to_lanes(part_rows1)
            ok = ok & ok_b & ok_p0 & ok_p1
            public_parts = np.stack([p0_pub, p1_pub], axis=1)
        else:
            blind_lanes = None
            public_parts = None
        t2 = time.perf_counter()
        stage["decode"] = t2 - t1

        out1, accept, prep_msg_lanes = self.engine.helper_init(
            nonce_lanes, public_parts, seed_lanes, blind_lanes, ver0, part0_lanes, ok
        )
        accept = accept & ok
        prep_msg_rows = lanes_to_seed_rows(prep_msg_lanes) if self.wire.uses_jr else [b""] * n
        t3 = time.perf_counter()
        stage["helper_init"] = t3 - t2

        for i in range(n):
            if prep_err[i] is None and not accept[i]:
                prep_err[i] = PrepareError.VDAF_PREP_ERROR

        resps = []
        report_aggs = []
        for i, pi in enumerate(inits):
            md = pi.report_share.metadata
            if prep_err[i] is None:
                result = PrepareStepResult.cont(encode_pingpong(PP_FINISH, prep_msg_rows[i], None))
                state = ReportAggregationState.FINISHED
                blob = prep_msg_rows[i]
                err = None
            else:
                result = PrepareStepResult.reject(prep_err[i])
                state = ReportAggregationState.FAILED
                blob = b""
                err = prep_err[i]
            resps.append(PrepareResp(md.report_id, result))
            report_aggs.append(ReportAggregationModel(task.task_id, job_id, md.report_id, md.time, i, state, blob, err))

        # accumulate accepted out shares per batch bucket (reference
        # :1811-1826)
        accumulator = Accumulator(task, self.cfg.batch_aggregation_shard_count)
        accumulate_batched(
            task,
            self.engine,
            accumulator,
            out1,
            accept,
            [pi.report_share.metadata for pi in inits],
            batch_identifier=fixed_size_batch_id(req.partial_batch_selector),
        )
        t4 = time.perf_counter()
        stage["accumulate"] = t4 - t3

        times = [pi.report_share.metadata.time.seconds for pi in inits]
        job = AggregationJobModel(
            task.task_id,
            job_id,
            req.aggregation_parameter,
            req.partial_batch_selector.to_bytes(),
            Interval(Time(min(times)), Duration(max(times) - min(times) + 1)) if times else Interval(Time(0), Duration(1)),
            AggregationJobState.FINISHED,
            0,
            request_hash,
        )

        def write(tx):
            # flush first: reports landing in collected batches become
            # individual BATCH_COLLECTED rejections (reference :86-105)
            unmerged = accumulator.flush_to_datastore(tx)
            tx.put_aggregation_job(job)
            for ra in report_aggs:
                if ra.report_id.data in unmerged:
                    ra = ra.failed(PrepareError.BATCH_COLLECTED)
                tx.put_report_aggregation(ra)
            return unmerged

        deadline_mod.check("helper_write_tx")
        unmerged = ds.run_tx(write, "aggregate_init")
        stage["write_tx"] = time.perf_counter() - t4
        if unmerged:
            resps = [
                PrepareResp(r.report_id, PrepareStepResult.reject(PrepareError.BATCH_COLLECTED))
                if r.report_id.data in unmerged
                else r
                for r in resps
            ]
        return AggregationJobResp(tuple(resps))

    def _replay_aggregate_init_response(self, ds: Datastore, job_id) -> AggregationJobResp:
        """Rebuild the response from the stored rows (reference
        check_aggregation_job_idempotence, aggregator.rs:1526): FINISHED
        rows hold their prep message in prep_blob."""
        ras = ds.run_tx(
            lambda tx: tx.get_report_aggregations_for_job(self.task.task_id, job_id), "agg_init_replay_resp"
        )
        resps = []
        for ra in ras:
            if ra.state == ReportAggregationState.FINISHED:
                result = PrepareStepResult.cont(encode_pingpong(PP_FINISH, ra.prep_blob, None))
            else:
                result = PrepareStepResult.reject(_err_or_default(ra.prepare_error))
            resps.append(PrepareResp(ra.report_id, result))
        return AggregationJobResp(tuple(resps))


class Aggregator:
    """Top-level request router over tasks (reference aggregator.rs:156),
    as far as the helper's aggregate-init needs it."""

    def __init__(self, ds: Datastore, clock: Clock | None = None, cfg: Config | None = None, device=None):
        self.ds = ds
        self.clock = clock or RealClock()
        self.cfg = cfg or Config()
        # CUDA unless the caller asks for the CPU; raises without CUDA
        self.device = resolve_device(device)
        self._task_aggs: dict[bytes, TaskAggregator] = {}
        self._task_aggs_lock = threading.Lock()

    def task_aggregator_for(self, task_id: TaskId) -> TaskAggregator:
        ta = self._task_aggs.get(task_id.data)
        if ta is None:
            task = self.ds.run_tx(lambda tx: tx.get_task(task_id), "get_task")
            if task is None:
                raise errors.UnrecognizedTask("unknown task", task_id)
            # first insert wins: every caller gets the same object
            candidate = TaskAggregator(task, self.cfg, device=self.device)
            with self._task_aggs_lock:
                ta = self._task_aggs.setdefault(task_id.data, candidate)
        return ta

    def check_aggregator_auth(self, task: Task, headers) -> None:
        tok = task.aggregator_auth_token
        if tok is None or not tok.matches_headers(headers):
            raise errors.UnauthorizedRequest("bad aggregator auth", task.task_id)

    def handle_aggregate_init(self, task_id: TaskId, job_id: AggregationJobId, request_bytes: bytes) -> AggregationJobResp:
        """Decode an AggregationJobInitializeReq from its wire bytes and
        answer it for the task."""
        ta = self.task_aggregator_for(task_id)
        try:
            req = AggregationJobInitializeReq.from_bytes(request_bytes)
        except DecodeError as e:
            raise errors.InvalidMessage(f"undecodable aggregate-init request: {e}", task_id)
        return ta.handle_aggregate_init(self.ds, self.clock, job_id, req, request_bytes)
