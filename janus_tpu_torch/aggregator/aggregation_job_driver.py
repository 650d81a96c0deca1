"""Aggregation job driver (the leader's stepper).

Equivalent of reference aggregator/src/aggregator/aggregation_job_driver.rs:
49-894: acquire leases, read the job and its reports, run the leader's
prepare-init, PUT the init request to the helper, process its response,
accumulate, write back, release. The reference's per-report loops are
each one batched device call here.

For the one-round Prio3 VDAFs a job completes in a single step: init ->
the helper answers finish/reject per report -> the leader verifies the
prep message (joint-rand seed equality, a host-side compare) -> masked
accumulate. A crash anywhere before the final write leaves the job in
step 0 with its reports in START; the re-acquired lease replays the init
(the helper deduplicates by request hash).

A two-round VDAF takes two steps. The init step parks the accepted
reports in WAITING_LEADER with the leader's next message and its output
share (`commit_park`); the next step POSTs the ord-matched continue
request, accumulates what the helper finished and finishes the job
(`_continue_step`). Poplar1's init (`_step_poplar1_init`) runs round 1 of
the whole job as one batched IDPF walk on the card (kernel 1) and checks
the helper's sketch on the host before it parks.

The port's own copy of janus_tpu/aggregator/aggregation_job_driver.py:
the Prio3 init step through the serial stepper, its stages
(`stage_init`, `device_init`, `http_init`, `device_accumulate`,
`commit_finish` or `commit_park`), the Poplar1 init, the continue step,
the PUT and POST send path with its retries, circuit breaker and
lease-bounded deadline, the step-back and the abandonment. The driver
runs on CUDA unless it is built with device="cpu". There is no host
engine, so a device failure fails the step (the lease expires and the
job is retried, counting an attempt); `handle_step_error` has no
device-hang branch.

Not ported yet: the resident accumulators and `ResidentFlusher`
(`ResidentConfig(enabled=True)` is refused), the stage pipeline
(`step_pipeline.py`, which needs the engine's prestaged leader columns),
the sparse pending deltas of the resident route, the peer outage tracker;
and the calls into metrics, trace spans, failpoints and the conservation
ledger. Each step's stage seconds are kept in `step_seconds`.
"""

from __future__ import annotations

import base64
import dataclasses
import logging
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..core.circuit_breaker import (
    CircuitBreakerConfig,
    CircuitOpenError,
    OutboundCircuitBreakers,
    default_breakers,
    peer_label,
)
from ..core.deadline import (
    DEADLINE_EXCEEDED_STATUS,
    DeadlineExceeded,
    current_deadline,
    deadline_scope,
)
from ..core.retries import Backoff, RequestAborted, retry_http_request
from ..datastore.models import (
    AcquiredAggregationJob,
    AggregationJobState,
    ReportAggregationState,
)
from ..datastore.store import Datastore, LeaseConflict
from ..device import resolve_device
from ..messages import (
    AggregationJobContinueReq,
    AggregationJobInitializeReq,
    AggregationJobResp,
    AggregationJobStep,
    Duration,
    Interval,
    PartialBatchSelector,
    PreEncoded,
    PrepareError,
    PrepareInit,
    PrepareStepResult,
    ReportMetadata,
    ReportShare,
    decode_prepare_resps_fast,
    encode_report_share_raw,
)
from ..messages.codec import DecodeError
from ..task import Task
from ..vdaf.registry import circuit_for
from ..vdaf.wire import (
    PP_CONTINUE,
    PP_FINISH,
    PP_INITIALIZE,
    Prio3Wire,
    block_index_rows,
    decode_field_rows,
    decode_pingpong,
    encode_field_rows,
    encode_pingpong,
    encode_pingpong_share_column,
    flat_scatter_indices,
    pingpong_finish_frame_matches,
    seeds_to_lanes,
)
from .accumulator import Accumulator, accumulate_batched, fixed_size_batch_id
from .engine_cache import engine_cache
from .errors import NotPorted
from .job_driver import (
    datastore_reconnect_delay_s,
    deadline_request_timeout,
    is_datastore_connection_error,
    lease_deadline,
    make_claim_acquirer,
)
from .poplar1_ops import Poplar1Ops

log = logging.getLogger(__name__)


def _err_or_default(err) -> PrepareError:
    """PrepareError.BATCH_COLLECTED has enum value 0 (falsy), so the
    `err or DEFAULT` idiom silently rewrites it; compare against None."""
    return err if err is not None else PrepareError.VDAF_PREP_ERROR


@dataclass
class ResidentConfig:
    """The device-resident accumulators of janus_tpu. Not ported:
    AggregationJobDriver refuses enabled=True."""

    enabled: bool = False


@dataclass
class AggregationJobDriverConfig:
    batch_aggregation_shard_count: int = 1
    maximum_attempts_before_failure: int = 10
    http_backoff: Backoff = Backoff()
    # helper HTTP work is bounded by lease remaining minus this skew
    # (reference job_driver.rs:191-196)
    worker_lease_clock_skew_s: int = 60
    # leader->helper outbound circuit breaker
    circuit_breaker: CircuitBreakerConfig | None = None
    # floor for the breaker-open step-back reacquire delay
    min_step_back_delay_s: int = 1
    resident: ResidentConfig = field(default_factory=ResidentConfig)


@dataclass
class InitStepState:
    """Carrier of one Prio3 init step through the stage chain: stage_init
    fills the staging columns, device_init the device outputs, http_init
    the accept column, and the commit stages consume them."""

    acquired: AcquiredAggregationJob
    task: Task
    job: object
    pending: list
    reports: dict
    wire: Prio3Wire
    engine: object
    multi_round: bool = False
    # columnar staging (host)
    meas: object = None
    proof: object = None
    nonce_lanes: object = None
    blind_lanes: object = None
    public_parts: object = None
    ok: object = None
    failed: list = field(default_factory=list)
    # device init outputs
    out0: object = None
    seed0: object = None
    ver0: object = None
    part0: object = None
    # HTTP leg output
    accept: object = None
    continue_msgs: list = field(default_factory=list)  # multi-round: the next message
    # accumulate output
    accumulator: Accumulator | None = None
    # block-sparse tasks: the public block indices of each lane from the
    # decoded public shares ([n, max_blocks] int32, -1 for padding and
    # failed lanes); the accumulate stage expands them to flat targets
    block_idx: object = None


class AggregationJobDriver:
    """reference aggregation_job_driver.rs:49."""

    def __init__(
        self,
        ds: Datastore,
        http,
        cfg: AggregationJobDriverConfig | None = None,
        breakers: OutboundCircuitBreakers | None = None,
        stopper=None,
        device=None,
    ):
        self.ds = ds
        self.http = http
        self.cfg = cfg or AggregationJobDriverConfig()
        if self.cfg.resident.enabled:
            raise NotPorted("device-resident accumulators are not ported to janus_tpu_torch yet")
        # CUDA unless the caller asks for the CPU; raises without CUDA
        self.device = resolve_device(device)
        self.breakers = (
            breakers if breakers is not None else default_breakers(self.cfg.circuit_breaker)
        )
        # shutdown Stopper: in-flight helper retries abort on shutdown so
        # the step can step back instead of spending the whole lease
        self.stopper = stopper
        # (job id bytes, {stage: seconds}) of the latest steps
        self.step_seconds: deque = deque(maxlen=64)

    # --- JobDriver callbacks (reference :840-894) ---
    def acquirer(self, lease_duration_s: int = 600):
        """Batched claim acquirer over in-progress jobs."""
        return make_claim_acquirer(
            self.ds,
            lambda limit: self.ds.run_tx(
                lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(lease_duration_s), limit),
                "acquire_agg_jobs",
            ),
        )

    def _lease_deadline(self, acquired) -> float:
        return lease_deadline(self.ds.clock, acquired.lease, self.cfg.worker_lease_clock_skew_s)

    def stepper(self, acquired: AcquiredAggregationJob) -> None:
        if acquired.lease.attempts > self.cfg.maximum_attempts_before_failure:
            self.abandon_job(acquired)
            return
        try:
            self.step_aggregation_job(acquired)
        except Exception as e:
            if self.handle_step_error(acquired, e):
                return
            log.exception(
                "aggregation job %s step failed (attempt %d)",
                acquired.job_id,
                acquired.lease.attempts,
            )
            raise

    def handle_step_error(self, acquired: AcquiredAggregationJob, e: Exception) -> bool:
        """Map a step failure to the step-back / attempt-ledger semantics.
        Returns True when the failure became a step-back (lease released
        early, attempt refunded): the failure was not the job's fault.
        Anything else, a device failure included, fails the step and
        counts an attempt."""
        if isinstance(e, CircuitOpenError):
            # the helper's circuit is open: release the lease with the
            # cooldown as backoff instead of failing the step
            self.step_back(acquired, "circuit_open", max(e.retry_in_s, self.cfg.min_step_back_delay_s))
            return True
        if isinstance(e, RequestAborted):
            # shutdown drain: hand the lease back at once
            self.step_back(acquired, "shutdown_drain", 0.0)
            return True
        if isinstance(e, DeadlineExceeded):
            # the lease budget died (expired lease, retry loop past the
            # bound, or the helper's conclusive 408): redo under a fresh
            # lease, never burning the attempt ledger
            self.step_back(acquired, "deadline_expired", 0.0)
            return True
        if is_datastore_connection_error(self.ds, e):
            self.step_back(acquired, "datastore_down", datastore_reconnect_delay_s(self.ds))
            return True
        return False

    def step_back(self, acquired: AcquiredAggregationJob, reason: str, delay_s: float) -> None:
        """Release the lease early (reacquirable after delay_s, attempt
        refunded)."""
        delay = max(0, int(delay_s))
        log.warning(
            "stepping back aggregation job %s (%s): lease released, reacquirable in %ds",
            acquired.job_id, reason, delay,
        )
        # a shutdown drain is a clean hand-back to the rest of the fleet
        handback = reason == "shutdown_drain"
        try:
            self.ds.run_tx(
                lambda tx: tx.step_back_aggregation_job(
                    acquired, reacquire_delay_s=delay, count_attempt=False, handback=handback
                ),
                "step_back_agg_job",
            )
        except LeaseConflict:
            log.info("step-back of %s found the lease already gone", acquired.job_id)
        except Exception:
            # the step-back is an optimization: the lease ages out anyway
            log.warning("step-back of %s could not reach the datastore; lease will age out", acquired.job_id)

    def _stage_pending(self, task, wire, engine, pending, reports):
        """Columnar staging of stored leader shares -> device-ready
        arrays + per-report failure marks."""
        n = len(pending)
        meas_rows: list[bytes | None] = [None] * n
        proof_rows: list[bytes | None] = [None] * n
        blind_rows: list[bytes | None] = [None] * n
        part_rows0: list[bytes | None] = [None] * n
        part_rows1: list[bytes | None] = [None] * n
        failed = [None] * n  # PrepareError or None
        circ = wire.circ
        idx_rows: list | None = [None] * n if wire.sparse else None
        mlen = circ.input_len * wire.enc_size
        plen = circ.proof_len * wire.enc_size
        for i, ra in enumerate(pending):
            rep = reports.get(ra.report_id.data)
            if rep is None:
                failed[i] = PrepareError.REPORT_DROPPED
                continue
            payload = rep.leader_input_share
            if len(payload) != wire.leader_share_len:
                failed[i] = PrepareError.INVALID_MESSAGE
                continue
            meas_rows[i] = payload[:mlen]
            proof_rows[i] = payload[mlen : mlen + plen]
            if wire.uses_jr:
                blind_rows[i] = payload[mlen + plen :]
                try:
                    parts = wire.decode_public_share(rep.public_share)
                    part_rows0[i], part_rows1[i] = parts
                    if idx_rows is not None:
                        idx_rows[i] = parts.indices  # validated by the decode
                except DecodeError:
                    failed[i] = PrepareError.INVALID_MESSAGE

        # the test fakes' failure at the leader's prepare init
        if task.vdaf.fails_at("init"):
            for i in range(n):
                if failed[i] is None:
                    failed[i] = PrepareError.VDAF_PREP_ERROR

        tf = engine.p3.tf
        meas, ok_m = decode_field_rows(tf, meas_rows, circ.input_len)
        proof, ok_p = decode_field_rows(tf, proof_rows, circ.proof_len)
        nonce_lanes, _ = seeds_to_lanes([ra.report_id.data for ra in pending])
        ok = ok_m & ok_p & np.array([f is None for f in failed])
        if wire.uses_jr:
            blind_lanes, ok_b = seeds_to_lanes(blind_rows)
            p0, ok_p0 = seeds_to_lanes(part_rows0)
            p1, ok_p1 = seeds_to_lanes(part_rows1)
            ok = ok & ok_b & ok_p0 & ok_p1
            public_parts = np.stack([p0, p1], axis=1)
        else:
            blind_lanes = None
            public_parts = None
        block_idx = block_index_rows(idx_rows, circ) if idx_rows is not None else None
        return meas, proof, nonce_lanes, blind_lanes, public_parts, ok, failed, block_idx

    # --- the step (reference :102-726), as the stage methods in order ---
    def read_job(self, acquired: AcquiredAggregationJob):
        """tx1: read the task, the job, its report aggregations and the
        stored reports of the rows still in START (reference :144-233)."""

        def read(tx):
            task = tx.get_task(acquired.task_id)
            job = tx.get_aggregation_job(acquired.task_id, acquired.job_id)
            ras = tx.get_report_aggregations_for_job(acquired.task_id, acquired.job_id)
            reports = {}
            for ra in ras:
                if ra.state == ReportAggregationState.START:
                    reports[ra.report_id.data] = tx.get_client_report(acquired.task_id, ra.report_id)
            return task, job, ras, reports

        return self.ds.run_tx(read, "step_agg_job_read")

    def release_job(self, acquired: AcquiredAggregationJob) -> None:
        self.ds.run_tx(lambda tx: tx.release_aggregation_job(acquired), "release")

    def step_aggregation_job(self, acquired: AcquiredAggregationJob) -> None:
        t0 = time.perf_counter()
        task, job, ras, reports = self.read_job(acquired)
        read_s = time.perf_counter() - t0
        if job is None or task is None:
            raise RuntimeError("job or task vanished while leased")
        if job.state != AggregationJobState.IN_PROGRESS:
            self.release_job(acquired)
            return
        # the lease budget bounds every stage of the step, and the HTTP
        # client stamps its remainder on the helper request
        with deadline_scope(self._lease_deadline(acquired)):
            self._step_leased_job(acquired, task, job, ras, reports, seconds={"read_tx": read_s})

    def plan_step(self, acquired, task, job, ras):
        """Classify the leased step -> (kind, rows): 'continue'
        (WaitingLeader rows), 'poplar1', 'empty', or 'init' (the Prio3
        hot path) with the rows the step works on."""
        waiting = [ra for ra in ras if ra.state == ReportAggregationState.WAITING_LEADER]
        if waiting:
            return "continue", waiting
        pending = [ra for ra in ras if ra.state == ReportAggregationState.START]
        if task.vdaf.kind == "poplar1":
            return "poplar1", pending
        if not pending:
            return "empty", pending
        return "init", pending

    def _step_leased_job(self, acquired, task, job, ras, reports, seconds: dict | None = None) -> None:
        kind, rows = self.plan_step(acquired, task, job, ras)
        seconds = dict(seconds or {})
        if kind == "continue":
            # a two-round job's reports parked in WaitingLeader at init;
            # this step sends the continue request (reference :439-514)
            self._continue_step(acquired, task, job, rows, seconds)
        elif kind == "poplar1":
            self._step_poplar1_init(acquired, task, job, rows, reports, seconds)
        elif kind == "empty":
            self.finish_empty(acquired, job)
            return
        else:
            t = time.perf_counter()
            st = self.stage_init(acquired, task, job, rows, reports)
            finish = (
                (("commit_park", self.commit_park),)
                if st.multi_round
                else (("device_accumulate", self.device_accumulate), ("commit_finish", self.commit_finish))
            )
            for name, stage in (
                ("stage_init", None),
                ("device_init", self.device_init),
                ("http_init", self.http_init),
                *finish,
            ):
                if stage is not None:
                    stage(st)
                now = time.perf_counter()
                seconds[name] = now - t
                t = now
        self.step_seconds.append((acquired.job_id.data, seconds))

    def finish_empty(self, acquired, job) -> None:
        def finish(tx):
            tx.update_aggregation_job(job.with_state(AggregationJobState.FINISHED))
            tx.release_aggregation_job(acquired)

        self.ds.run_tx(finish, "step_agg_job_finish_empty")

    def stage_init(self, acquired, task, job, pending, reports) -> InitStepState:
        """Host stage: columnar staging of stored leader shares into
        device-ready arrays."""
        wire = Prio3Wire(circuit_for(task.vdaf))
        engine = engine_cache(task.vdaf, task.vdaf_verify_key, self.device)
        meas, proof, nonce_lanes, blind_lanes, public_parts, ok, failed, block_idx = self._stage_pending(
            task, wire, engine, pending, reports
        )
        return InitStepState(
            acquired=acquired,
            task=task,
            job=job,
            pending=pending,
            reports=reports,
            wire=wire,
            engine=engine,
            multi_round=task.vdaf.rounds > 1,
            meas=meas,
            proof=proof,
            nonce_lanes=nonce_lanes,
            blind_lanes=blind_lanes,
            public_parts=public_parts,
            ok=ok,
            failed=failed,
            block_idx=block_idx,
        )

    def device_init(self, st: InitStepState) -> None:
        """Device stage: batched leader prepare-init (reference hot loop
        :329-402)."""
        st.out0, st.seed0, st.ver0, st.part0 = st.engine.leader_init(
            st.nonce_lanes, st.public_parts, st.meas, st.proof, st.blind_lanes, ok=st.ok
        )

    def http_init(self, st: InitStepState) -> None:
        """HTTP stage: columnar request framing, the helper round trip,
        columnar response decode and host-side verification (reference
        :404-424 build/send, :530-726 response processing)."""
        acquired, task, job, pending, reports = st.acquired, st.task, st.job, st.pending, st.reports
        wire = st.wire
        n = len(pending)
        failed = st.failed
        # one vectorized framing pass; each PrepareInit body is spliced
        # from pre-encoded rows
        frames = encode_pingpong_share_column(st.engine.p3.tf, st.ver0, st.part0 if wire.uses_jr else None)
        prep_inits = []
        send_idx = []
        for i, ra in enumerate(pending):
            if failed[i] is not None or not st.ok[i]:
                if failed[i] is None:
                    failed[i] = PrepareError.INVALID_MESSAGE
                continue
            rep = reports[ra.report_id.data]
            prep_inits.append(
                PreEncoded(
                    encode_report_share_raw(
                        ra.report_id.data,
                        ra.client_time.seconds,
                        rep.public_share,
                        rep.helper_encrypted_input_share,
                    )
                    + frames.row(i)
                )
            )
            send_idx.append(i)

        multi_round = st.multi_round
        accept = np.zeros(n, dtype=bool)
        continue_msgs: list[bytes | None] = [None] * n
        if prep_inits:
            req = AggregationJobInitializeReq(
                job.aggregation_parameter,
                PartialBatchSelector.from_bytes(job.partial_batch_identifier),
                tuple(prep_inits),
            )
            body = self._send_init_request_raw(task, acquired, req)
            col = decode_prepare_resps_fast(body)
            mapping = self._match_resps([pending[i].report_id.data for i in send_idx], col)
            seed_rows = (
                np.ascontiguousarray(np.asarray(st.seed0, dtype="<u8")).view(np.uint8)
                if wire.uses_jr and not multi_round
                else None
            )
            for k, i in enumerate(send_idx):
                j = k if mapping is None else mapping[k]
                if j is None:
                    failed[i] = PrepareError.INVALID_MESSAGE
                    continue
                if col.kinds[j] == PrepareStepResult.REJECT:
                    failed[i] = _err_or_default(col.errors[j])
                    continue
                msg = col.messages[j]
                if multi_round:
                    # the helper answered ping-pong CONTINUE; the leader's
                    # next message, sent on the next step, finishes with
                    # the combined prep message (the fake: an echo)
                    try:
                        if msg is None:
                            raise DecodeError("no message")
                        tag, prep_msg, _share = decode_pingpong(msg)
                    except DecodeError:
                        failed[i] = PrepareError.INVALID_MESSAGE
                        continue
                    if tag != PP_CONTINUE:
                        failed[i] = PrepareError.INVALID_MESSAGE
                        continue
                    continue_msgs[i] = encode_pingpong(PP_FINISH, prep_msg or b"", None)
                    accept[i] = True
                    continue
                if wire.uses_jr:
                    # the helper's answer must be finish(our jr seed)
                    verdict = (
                        pingpong_finish_frame_matches(msg, seed_rows[i].tobytes())
                        if msg is not None
                        else None
                    )
                    if verdict is None:
                        failed[i] = PrepareError.INVALID_MESSAGE
                        continue
                    if verdict is False:
                        failed[i] = PrepareError.VDAF_PREP_ERROR
                        continue
                accept[i] = True

        # the test fakes' failure at the leader's continue/evaluate stage
        if task.vdaf.fails_at("step"):
            for i in range(n):
                if accept[i]:
                    accept[i] = False
                    failed[i] = PrepareError.VDAF_PREP_ERROR

        st.accept = accept
        st.continue_msgs = continue_msgs

    def _match_resps(self, sent_ids: list[bytes], col) -> list[int | None] | None:
        """Order-aligned prepare-resp matching: DAP requires the helper to
        answer in request order. Returns None when aligned (identity
        mapping); otherwise the id->index lookup, None for a report the
        helper did not answer."""
        if len(col.report_ids) == len(sent_ids) and all(a == b for a, b in zip(col.report_ids, sent_ids)):
            return None
        by_id = {rid: j for j, rid in enumerate(col.report_ids)}
        return [by_id.get(rid) for rid in sent_ids]

    def device_accumulate(self, st: InitStepState) -> None:
        """Device stage: one masked aggregate per batch bucket (reference
        Accumulator::update :605-627)."""
        st.accumulator = Accumulator(st.task, self.cfg.batch_aggregation_shard_count)
        metadatas = [ReportMetadata(ra.report_id, ra.client_time) for ra in st.pending]
        pbs = PartialBatchSelector.from_bytes(st.job.partial_batch_identifier)
        accumulate_batched(
            st.task,
            st.engine,
            st.accumulator,
            st.out0,
            st.accept,
            metadatas,
            batch_identifier=fixed_size_batch_id(pbs),
            flat_idx=self._flat_idx(st),
        )

    @staticmethod
    def _flat_idx(st: InitStepState):
        """[n, compact_len] int32 scatter targets of a sparse job's staged
        block indices; None for a dense task."""
        if st.block_idx is None:
            return None
        return flat_scatter_indices(st.block_idx, st.wire.circ)

    def commit_finish(self, st: InitStepState) -> None:
        """Commit stage: tx2 writes the results and releases the lease
        (reference :698-724)."""
        acquired, job = st.acquired, st.job
        new_ras = []
        for i, ra in enumerate(st.pending):
            if st.accept[i]:
                new_ras.append(ra.finished())
            else:
                new_ras.append(ra.failed(_err_or_default(st.failed[i])))
        accumulator = st.accumulator

        def write(tx):
            # flush first: reports whose batch was collected mid-flight
            # fail one by one with BATCH_COLLECTED
            unmerged = accumulator.flush_to_datastore(tx)
            for ra in new_ras:
                if ra.report_id.data in unmerged:
                    ra = ra.failed(PrepareError.BATCH_COLLECTED)
                tx.update_report_aggregation(ra)
            tx.update_aggregation_job(job.with_state(AggregationJobState.FINISHED))
            tx.release_aggregation_job(acquired)

        self.ds.run_tx(write, "step_agg_job_write")

    def commit_park(self, st: InitStepState) -> None:
        """Commit stage of a two-round init: park accepted reports as
        WaitingLeader(len(msg) || msg || out_share); the job stays in
        progress for the continue step (reference models.rs:714)."""
        out0_rows = encode_field_rows(st.engine.p3.tf, st.out0)
        new_ras = []
        for i, ra in enumerate(st.pending):
            if st.accept[i]:
                msg = st.continue_msgs[i]
                blob = len(msg).to_bytes(4, "big") + msg + out0_rows[i]
                new_ras.append(dataclasses.replace(ra, state=ReportAggregationState.WAITING_LEADER, prep_blob=blob))
            else:
                new_ras.append(ra.failed(_err_or_default(st.failed[i])))
        self._write_parked(st.acquired, new_ras, "step_agg_job_park")

    def _write_parked(self, acquired, new_ras, name: str) -> None:
        def write(tx):
            for ra in new_ras:
                tx.update_report_aggregation(ra)
            tx.release_aggregation_job(acquired)

        self.ds.run_tx(write, name)

    def _step_poplar1_init(self, acquired, task: Task, job, pending, reports, seconds: dict) -> None:
        """Poplar1's leader init (the ping-pong mapping is in
        poplar1_ops.py): round 1 of the whole job as one batched IDPF walk
        and sketch on the card, the sketch shares to the helper, the
        helper's combined sketch checked on the host, then park
        WaitingLeader for the continue step."""
        if not pending:
            self.finish_empty(acquired, job)
            return
        t = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t
            now = time.perf_counter()
            seconds[name] = now - t
            t = now

        pop = Poplar1Ops(task.vdaf.bits, task.vdaf_verify_key, self.device)
        param = pop.decode_param(job.aggregation_parameter)
        F = pop.field_for(param)
        n = len(pending)
        failed: list = [None] * n
        evals: dict[int, tuple] = {}  # i -> (prep state, y0, [A0, B0])
        items = []
        item_idx = []
        for i, ra in enumerate(pending):
            rep = reports.get(ra.report_id.data)
            if rep is None:
                failed[i] = PrepareError.REPORT_DROPPED
                continue
            items.append((rep.public_share, rep.leader_input_share, ra.report_id.data))
            item_idx.append(i)
        # one batched device walk for the whole job
        for i, res in zip(item_idx, pop.round1_batch(0, items, param)):
            if isinstance(res, ValueError):
                failed[i] = PrepareError.INVALID_MESSAGE
            else:
                evals[i] = res
        lap("round1")

        prep_inits = []
        send_idx = []
        for i, ra in enumerate(pending):
            if failed[i] is not None:
                continue
            rep = reports[ra.report_id.data]
            _, _, msg1_0 = evals[i]
            prep_inits.append(
                PrepareInit(
                    ReportShare(
                        ReportMetadata(ra.report_id, ra.client_time), rep.public_share, rep.helper_encrypted_input_share
                    ),
                    encode_pingpong(PP_INITIALIZE, None, pop.encode_vec(param, msg1_0)),
                )
            )
            send_idx.append(i)
        lap("encode_init")

        parked: dict[int, bytes] = {}  # i -> WaitingLeader blob
        if prep_inits:
            req = AggregationJobInitializeReq(
                job.aggregation_parameter,
                PartialBatchSelector.from_bytes(job.partial_batch_identifier),
                tuple(prep_inits),
            )
            resp = AggregationJobResp.from_bytes(self._send_init_request_raw(task, acquired, req))
            lap("http_init")
            by_id = {pr.report_id: pr for pr in resp.prepare_resps}
            es = pop.enc_size(param)
            for i in send_idx:
                ra = pending[i]
                pr = by_id.get(ra.report_id)
                if pr is None or pr.result.kind == PrepareStepResult.REJECT:
                    failed[i] = _err_or_default(pr.result.prepare_error if pr is not None else None)
                    continue
                try:
                    tag, prep_msg, helper_share = decode_pingpong(pr.result.message)
                    if tag != PP_CONTINUE or helper_share is None:
                        raise DecodeError("expected ping-pong continue")
                    # helper share = enc(A1)||enc(B1)||enc(sigma1)
                    msg1_1 = pop.decode_fixed_vec(param, helper_share[: 2 * es], 2)
                    sigma1 = pop.decode_elem(param, helper_share[2 * es :])
                except (DecodeError, ValueError):
                    failed[i] = PrepareError.INVALID_MESSAGE
                    continue
                st0, y0, msg1_0 = evals[i]
                sigma0, combined = pop.round2(st0, msg1_0, msg1_1)
                # the helper's round-1 prep message must equal our own
                # combination, and the sketch must verify (sigma0 + sigma1
                # == 0 iff y is one-hot or all zero)
                if prep_msg != pop.encode_vec(param, combined) or F.add(sigma0, sigma1) != 0:
                    failed[i] = PrepareError.VDAF_PREP_ERROR
                    continue
                msg = encode_pingpong(PP_FINISH, pop.encode_elem(param, sigma0), None)
                parked[i] = len(msg).to_bytes(4, "big") + msg + pop.encode_vec(param, y0)
            lap("round2")

        new_ras = []
        for i, ra in enumerate(pending):
            if i in parked:
                new_ras.append(dataclasses.replace(ra, state=ReportAggregationState.WAITING_LEADER, prep_blob=parked[i]))
            else:
                new_ras.append(ra.failed(_err_or_default(failed[i])))
        self._write_parked(acquired, new_ras, "step_p1_job_park")
        lap("commit_park")

    def _continue_step(self, acquired, task: Task, job, waiting, seconds: dict) -> None:
        """Send the ord-matched continue request for the WaitingLeader
        rows and finish the job (reference :439-514 and :530-726)."""
        t = time.perf_counter()
        if task.vdaf.kind == "poplar1":
            pop = Poplar1Ops(task.vdaf.bits)
            field = pop.field_for(pop.decode_param(job.aggregation_parameter))
        else:
            field = circuit_for(task.vdaf).FIELD
        msgs = []
        outs = []
        for ra in waiting:
            mlen = int.from_bytes(ra.prep_blob[:4], "big")
            msgs.append(ra.prep_blob[4 : 4 + mlen])
            outs.append(ra.prep_blob[4 + mlen :])
        # the stored messages are framed ping-pong messages already:
        # splice them raw (PrepareContinue = report_id || message)
        req = AggregationJobContinueReq(
            AggregationJobStep(job.step + 1),
            tuple(PreEncoded(ra.report_id.data + msg) for ra, msg in zip(waiting, msgs)),
        )
        body = self._send_agg_job_request_raw(task, acquired, req, method="POST")
        now = time.perf_counter()
        seconds["http_continue"] = now - t
        t = now
        col = decode_prepare_resps_fast(body)
        mapping = self._match_resps([ra.report_id.data for ra in waiting], col)

        accumulator = Accumulator(
            task, self.cfg.batch_aggregation_shard_count, field=field, aggregation_parameter=job.aggregation_parameter
        )
        fixed_bid = fixed_size_batch_id(PartialBatchSelector.from_bytes(job.partial_batch_identifier))
        new_ras = []
        for k, (ra, out_enc) in enumerate(zip(waiting, outs)):
            j = k if mapping is None else mapping[k]
            if j is not None and col.kinds[j] == PrepareStepResult.FINISHED:
                bid = fixed_bid or Interval(
                    ra.client_time.to_batch_interval_start(task.time_precision), task.time_precision
                ).to_bytes()
                accumulator.update_single(bid, field.decode_vec(out_enc), ra.report_id, ra.client_time)
                new_ras.append(dataclasses.replace(ra, state=ReportAggregationState.FINISHED, prep_blob=b""))
            else:
                err = _err_or_default(
                    col.errors[j] if j is not None and col.kinds[j] == PrepareStepResult.REJECT else None
                )
                new_ras.append(ra.failed(err))
        new_job = dataclasses.replace(job, state=AggregationJobState.FINISHED, step=job.step + 1)

        def write(tx):
            unmerged = accumulator.flush_to_datastore(tx)
            for ra in new_ras:
                if ra.report_id.data in unmerged:
                    ra = ra.failed(PrepareError.BATCH_COLLECTED)
                tx.update_report_aggregation(ra)
            tx.update_aggregation_job(new_job)
            tx.release_aggregation_job(acquired)

        self.ds.run_tx(write, "step_agg_job_continue_write")
        seconds["commit_continue"] = time.perf_counter() - t

    def _send_agg_job_request_raw(
        self, task: Task, acquired, req, extra_headers: dict | None = None, method: str = "PUT"
    ) -> bytes:
        """PUT (init) or POST (continue) to the helper's aggregation_jobs
        endpoint: URL, auth, deadline-capped timeouts, circuit breaker,
        retries; returns the raw response body."""
        # recompute the lease budget at call time (staging and the device
        # took wall time since the step captured it), clamped to the
        # ambient step scope
        deadline = self._lease_deadline(acquired)
        ambient = current_deadline()
        if ambient is not None:
            deadline = min(deadline, ambient)

        url = (
            task.helper_aggregator_endpoint.rstrip("/")
            + f"/tasks/{base64.urlsafe_b64encode(task.task_id.data).decode().rstrip('=')}"
            + f"/aggregation_jobs/{base64.urlsafe_b64encode(acquired.job_id.data).decode().rstrip('=')}"
        )
        headers = {"Content-Type": req.MEDIA_TYPE, **(extra_headers or {})}
        if task.aggregator_auth_token:
            headers.update(task.aggregator_auth_token.request_headers())
        peer = peer_label(task.helper_aggregator_endpoint)
        payload = req.to_bytes()  # encode once, not once per attempt

        def attempt():
            # circuit gate per attempt: a breaker opened by a concurrent
            # step aborts this retry loop too (CircuitOpenError is not a
            # transport error, so retry_http_request lets it propagate)
            self.breakers.check(peer)
            # through put/post, so test doubles that wrap a verb see it
            send = self.http.put if method == "PUT" else self.http.post
            try:
                status, body = send(url, payload, headers, timeout=deadline_request_timeout(deadline))
            except BaseException:
                # the breaker learns of a transport failure and frees a
                # half-open probe
                self.breakers.record_failure(peer)
                raise
            # 5xx = the peer is failing; anything conclusive (2xx/4xx) or
            # shedding (429) = alive
            if 500 <= status < 600:
                self.breakers.record_failure(peer)
            else:
                self.breakers.record_success(peer)
            return status, body, getattr(self.http, "last_response_headers", {})

        status, body = retry_http_request(
            attempt,
            self.cfg.http_backoff,
            deadline=deadline,
            should_abort=(lambda: self.stopper.stopped) if self.stopper is not None else None,
        )
        if status == DEADLINE_EXCEEDED_STATUS:
            # the helper's conclusive "your budget is dead": step back
            raise DeadlineExceeded("helper reported deadline exceeded", last_status=status)
        if status not in (200, 201):
            raise RuntimeError(f"helper {method} aggregation job failed: HTTP {status}: {body[:300]!r}")
        return body

    def _send_init_request_raw(self, task: Task, acquired, req: AggregationJobInitializeReq) -> bytes:
        from .http_handlers import XOF_MODE_HEADER

        return self._send_agg_job_request_raw(
            task, acquired, req, extra_headers={XOF_MODE_HEADER: task.vdaf.xof_mode}
        )

    # --- abandon (reference :728) ---
    def abandon_job(self, acquired: AcquiredAggregationJob) -> None:
        def cancel(tx):
            job = tx.get_aggregation_job(acquired.task_id, acquired.job_id)
            if job is None:
                return
            tx.update_aggregation_job(job.with_state(AggregationJobState.ABANDONED))
            ras = tx.get_report_aggregations_for_job(acquired.task_id, acquired.job_id)
            tx.mark_reports_unaggregated(
                acquired.task_id,
                [ra.report_id for ra in ras if ra.state == ReportAggregationState.START],
            )
            tx.release_aggregation_job(acquired)

        self.ds.run_tx(cancel, "abandon_agg_job")
        log.warning("abandoned aggregation job %s after max attempts", acquired.job_id)
