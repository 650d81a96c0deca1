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
job is retried, counting an attempt), but for two: a dispatch the
watchdog abandoned (DeviceHangError) steps the job back as
`device_hang`, and a dispatch the quarantined engine refused
(DeviceQuarantinedError) as `device_quarantined`, both with the attempt
refunded. The stage pipeline (`step_pipeline.py`) schedules the same
stage methods; `device_init` hands the engine the prestaged columns its
read stage uploaded. With a `peer_health` tracker the acquirer parks
while every helper's circuit is open.

Resident mode (`ResidentConfig(enabled=True)`): `device_accumulate` sums
the job's accepted rows per batch bucket on the card
(`EngineCache.aggregate_pending`) and the write transaction records the
batch rows with their counts and checksums but no share; after it
committed, `_resident_post_commit` merges the deltas into the engine's
resident slots (a sparse job's through kernel 4), flushes slots evicted
past the byte cap, and keeps the flush cadence. `flush_resident_state`
(the drain, and `ResidentFlusher`'s pass) writes every slot's share
through the batch-aggregation path; the take runs under the watchdog with
a bounded deadline, and the flusher sweeps a quarantined engine's slots
at its poll cadence (reason `quarantine`). Where janus_tpu falls back to the
classic accumulate on any error of the resident route, the port does so
on memory exhaustion only, and counts it (`classic_fallbacks`); any other
error fails the step. A flush into a batch collected meanwhile loses its
share, counted in `resident_lost` (janus_tpu books it in its ledger).

In a fleet the acquirer takes `fleet=` (config.FleetConfig): the claim's
shard predicate and steal fence, the replica's tag in every lease token,
and the claim counts in the acquirer's status(). `release_on_drain` is
the releaser janus_tpu's driver binary wires into JobDriver and the
stage pipeline. The helper's failpoints (`helper.request`,
`helper.response`, `retry.attempt`) fire in the HTTP client and the retry
loop this driver sends through.

Not ported: the calls into metrics, trace spans and the conservation
ledger. Each step's stage seconds are kept in `step_seconds`.
"""

from __future__ import annotations

import base64
import dataclasses
import logging
import threading
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
from .accumulator import (
    Accumulator,
    accumulate_batched,
    bucket_metadata,
    fixed_size_batch_id,
    group_batch_buckets,
)
from .device_watchdog import DeviceHangError, DeviceQuarantinedError
from .engine_cache import engine_cache, is_oom_error, live_engines
from .job_driver import (
    datastore_down,
    datastore_reconnect_delay_s,
    deadline_request_timeout,
    is_datastore_connection_error,
    lease_deadline,
    make_claim_acquirer,
)
from .poplar1_ops import Poplar1Ops

log = logging.getLogger(__name__)

# The deadline of a resident take with none around it (the flusher and
# the drain carry no lease): without one a wedged device would block the
# fetch for good while the take holds the engine's resident lock, and
# every commit worker behind it. Past it the slots are restored.
RESIDENT_FLUSH_FETCH_BOUND_S = 30.0


def _err_or_default(err) -> PrepareError:
    """PrepareError.BATCH_COLLECTED has enum value 0 (falsy), so the
    `err or DEFAULT` idiom silently rewrites it; compare against None."""
    return err if err is not None else PrepareError.VDAF_PREP_ERROR


@dataclass
class ResidentConfig:
    """Device-resident accumulators (the driver's `resident_accumulators:`
    settings). Off by default: resident mode trades the per-job share
    fetch and write for a bounded durability window (a hard crash loses
    the unflushed window; a drain and an eviction flush)."""

    enabled: bool = False
    # flush cadence of the resident slots (and the background flusher's
    # pass interval): a hard crash loses about this much accumulation
    flush_interval_s: float = 5.0

    @classmethod
    def from_dict(cls, d: dict | None) -> "ResidentConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", False)),
            flush_interval_s=float(d.get("flush_interval_secs", 5.0)),
        )


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
    # the padded columns the pipeline's read stage uploaded ahead
    # (EngineCache.prestage_leader), consumed by device_init
    prestaged: object = None
    # resident mode: the device deltas and the per-bucket merge entries,
    # consumed after the commit by commit_finish
    resident_delta: object = None
    resident_entries: list | None = None
    resident_rids: list | None = None
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
        peer_health=None,
        devices=None,
    ):
        self.ds = ds
        self.http = http
        self.cfg = cfg or AggregationJobDriverConfig()
        # the peer-outage parking tracker (peer_health.PeerHealthTracker);
        # None: the acquirer never parks on a peer outage
        self.peer_health = peer_health
        # CUDA unless the caller asks for the CPU; raises without CUDA. The
        # engines serve on `devices` where the caller names several (a
        # mesh), else on the one device
        self.devices = tuple(map(resolve_device, devices or (device,)))
        self.device = self.devices[0]
        self.breakers = (
            breakers if breakers is not None else default_breakers(self.cfg.circuit_breaker)
        )
        # shutdown Stopper: in-flight helper retries abort on shutdown so
        # the step can step back instead of spending the whole lease
        self.stopper = stopper
        # (job id bytes, {stage: seconds}) of the latest steps
        self.step_seconds: deque = deque(maxlen=64)
        # resident flush cadence: the last time this driver flushed,
        # seeded to now so the first inline flush waits a whole interval
        self._resident_flush_lock = threading.Lock()
        self._resident_last_flush = time.monotonic()
        # jobs that asked for the resident route and took the classic
        # accumulate (memory exhaustion), and resident shares lost to a
        # flush that came after their batch's collection
        self.classic_fallbacks = 0
        self.resident_lost = 0
        # step-backs by reason (janus_tpu's janus_job_step_back_total)
        self._step_back_lock = threading.Lock()
        self.step_backs: dict[str, int] = {}

    # --- JobDriver callbacks (reference :840-894) ---
    def acquirer(self, lease_duration_s: int = 600, fleet=None):
        """Batched claim acquirer over in-progress jobs. `fleet`
        (config.FleetConfig) adds the shard predicate with its steal-after
        fallback and stamps this replica's provenance tag into every lease
        token it mints; the acquirer's status() counts its claims."""
        shard = fleet.shard_spec() if fleet is not None else None
        holder = fleet.holder_tag() if fleet is not None else None
        return make_claim_acquirer(
            self.ds,
            "aggregation",
            lambda limit: self.ds.run_tx(
                lambda tx: tx.acquire_incomplete_aggregation_jobs(
                    Duration(lease_duration_s), limit, shard=shard, holder=holder
                ),
                "acquire_agg_jobs",
            ),
            shard=shard,
            peer_gate=self.peer_health.park_gate() if self.peer_health is not None else None,
        )

    def release_on_drain(self, acquired: AcquiredAggregationJob) -> None:
        """The drain releaser of JobDriver and StepPipeline: a step that
        failed during a shutdown hands its lease back at once, the attempt
        refunded and the shard affinity released, so a surviving replica
        claims it with no wait."""
        self.step_back(acquired, "shutdown_drain", 0.0)

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
        Anything else, a device failure other than a hang or a refusal
        included, fails the step and counts an attempt."""
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
        if isinstance(e, DeviceHangError):
            # the device call hung and was abandoned; the engine is
            # quarantined: not this job's fault
            self.step_back(acquired, "device_hang", self.cfg.min_step_back_delay_s)
            return True
        if isinstance(e, DeviceQuarantinedError):
            # the quarantined engine refused before staging anything: come
            # back about when its canary probes again
            self.step_back(acquired, "device_quarantined", max(e.retry_in_s, self.cfg.min_step_back_delay_s))
            return True
        if is_datastore_connection_error(self.ds, e):
            self.step_back(acquired, "datastore_down", datastore_reconnect_delay_s(self.ds))
            return True
        return False

    def step_back(self, acquired: AcquiredAggregationJob, reason: str, delay_s: float) -> None:
        """Release the lease early (reacquirable after delay_s, attempt
        refunded); counted by reason in `step_backs`."""
        with self._step_back_lock:
            self.step_backs[reason] = self.step_backs.get(reason, 0) + 1
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
        engine = engine_cache(task.vdaf, task.vdaf_verify_key, devices=self.devices)
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
        :329-402). A prestaged column set is consumed here; leader_init
        stages from the host columns where it cannot use it."""
        prestaged, st.prestaged = st.prestaged, None
        st.out0, st.seed0, st.ver0, st.part0 = st.engine.leader_init(
            st.nonce_lanes, st.public_parts, st.meas, st.proof, st.blind_lanes, ok=st.ok, prestaged=prestaged
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
        Accumulator::update :605-627). In resident mode the buckets' sums
        stay on the card as one PendingDeltas and the accumulator holds
        share-less entries; the sums merge into the engine's resident
        slots after the write transaction committed (commit_finish)."""
        st.accumulator = Accumulator(st.task, self.cfg.batch_aggregation_shard_count)
        metadatas = [ReportMetadata(ra.report_id, ra.client_time) for ra in st.pending]
        pbs = PartialBatchSelector.from_bytes(st.job.partial_batch_identifier)
        bid_fixed = fixed_size_batch_id(pbs)
        if self.cfg.resident.enabled and self._device_accumulate_resident(st, metadatas, bid_fixed):
            return
        accumulate_batched(
            st.task,
            st.engine,
            st.accumulator,
            st.out0,
            st.accept,
            metadatas,
            batch_identifier=bid_fixed,
            flat_idx=self._flat_idx(st),
        )

    def _device_accumulate_resident(self, st, metadatas, bid_fixed) -> bool:
        """The resident accumulate. True: st.accumulator holds share-less
        entries and st.resident_delta the device sums. False: the engine
        ran out of memory, and the caller runs the classic accumulate
        (counted); any other error propagates and fails the step."""
        n = len(metadatas)
        buckets = group_batch_buckets(st.task, metadatas, st.accept, bid_fixed)
        if not buckets:
            return True  # nothing accepted, nothing to merge
        keys = list(buckets)
        lane_bucket = np.full(n, -1, dtype=np.int32)
        for j, bid in enumerate(keys):
            lane_bucket[buckets[bid]] = j
        try:
            delta = st.engine.aggregate_pending(st.out0, lane_bucket, len(keys), flat_idx=self._flat_idx(st))
        except Exception as e:
            if not is_oom_error(e):
                raise
            log.warning("resident accumulate ran out of device memory for job %s; taking the classic "
                        "per-bucket path", st.acquired.job_id, exc_info=True)
            self.classic_fallbacks += 1
            st.engine.note_classic_fallback()
            return False
        entries = []
        rids0 = []
        for j, bid in enumerate(keys):
            lanes = buckets[bid]
            checksum, interval = bucket_metadata(st.task, metadatas, lanes)
            st.accumulator.update(
                bid,
                None,  # the share stays on the card until a flush
                len(lanes),
                checksum,
                interval,
                [metadatas[i].report_id for i in lanes],
            )
            entries.append(((st.task.task_id.data, st.job.aggregation_parameter, bid), j, len(lanes), interval))
            rids0.append(metadatas[lanes[0]].report_id.data)
        st.resident_delta = delta
        st.resident_entries = entries
        st.resident_rids = rids0
        return True

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
        # the committing attempt's unmergeable set, carried out of the tx
        # (run_tx may retry the closure)
        cell: dict = {}

        def write(tx):
            # flush first: reports whose batch was collected mid-flight
            # fail one by one with BATCH_COLLECTED
            unmerged = accumulator.flush_to_datastore(tx)
            cell["unmerged"] = unmerged
            for ra in new_ras:
                if ra.report_id.data in unmerged:
                    ra = ra.failed(PrepareError.BATCH_COLLECTED)
                tx.update_report_aggregation(ra)
            tx.update_aggregation_job(job.with_state(AggregationJobState.FINISHED))
            tx.release_aggregation_job(acquired)

        self.ds.run_tx(write, "step_agg_job_write")
        # resident mode: the deltas merge only now, after the commit
        # landed; a failed write (or a step-back earlier) drops them, so
        # the re-step under a fresh lease cannot merge twice
        if st.resident_delta is not None:
            self._resident_post_commit(st, cell.get("unmerged", set()))

    # --- resident aggregate state: merge and flush ---
    def _resident_post_commit(self, st, unmerged: set) -> None:
        """Merge the job's committed deltas into the resident slots, flush
        slots evicted past the byte cap, and keep the flush cadence."""
        engine = st.engine
        # a bucket whose batch was collected mid-flight had all its
        # reports refused by the flush (BATCH_COLLECTED): its delta must
        # not enter the resident share either
        entries = [e for e, rid0 in zip(st.resident_entries, st.resident_rids) if rid0 not in unmerged]
        delta, st.resident_delta = st.resident_delta, None
        if entries:
            try:
                evicted = engine.resident_merge(entries, delta)
            except Exception as merge_exc:
                # the commit landed and the merge did not: fetch the rows
                # not merged yet and write them through the flush path (a
                # merged prefix stays on the card and flushes with its
                # slot; flushing it here too would count it twice)
                merged_keys = getattr(merge_exc, "merged", frozenset())
                remaining = [e for e in entries if e[0] not in merged_keys]
                log.error(
                    "resident merge failed after the commit of job %s (%d of %d buckets merged); "
                    "flushing the remaining delta rows directly",
                    st.acquired.job_id, len(merged_keys), len(entries), exc_info=True,
                )
                try:
                    recs = engine.fetch_delta_records(remaining, delta)
                except Exception:
                    self.resident_lost += len(remaining)
                    log.exception("resident delta fetch failed too; %d bucket contribution(s) of job %s are LOST",
                                  len(remaining), st.acquired.job_id)
                    recs = []
                if recs:
                    self.flush_resident_records(engine, recs, reason="merge_failed")
            else:
                if evicted:
                    self.flush_resident_records(engine, evicted, reason="eviction")
        self.maybe_flush_resident(engine)

    def maybe_flush_resident(self, engine) -> None:
        """Keep the flush cadence inline (the background flusher covers
        idle periods; this bounds a busy driver too)."""
        now = time.monotonic()
        with self._resident_flush_lock:
            if now - self._resident_last_flush < self.cfg.resident.flush_interval_s:
                return
            self._resident_last_flush = now
        self.flush_engine_resident(engine, reason="interval")

    def flush_engine_resident(self, engine, reason: str = "interval") -> int:
        """Take every resident slot of `engine` and write the shares
        through the batch-aggregation write path; returns the slots
        flushed. The take runs under the watchdog, bounded by
        RESIDENT_FLUSH_FETCH_BOUND_S where no deadline is around it. A
        failed (or hung) take leaves the slots resident for the next
        pass; after a hung quarantine take they wait for the restore."""
        if reason != "drain" and datastore_down(self.ds):
            # flushing into a store known to be down would pop the slots
            # and lose their shares when the tx fails (a flush is at most
            # once: no key guards a re-flush against double merging)
            return 0
        try:
            ambient = current_deadline()
            with deadline_scope(ambient if ambient is not None else time.monotonic() + RESIDENT_FLUSH_FETCH_BOUND_S):
                recs = engine.resident_take()
        except Exception:
            log.warning("resident take failed for %s (%s); the state stays resident", engine.inst.kind, reason,
                        exc_info=True)
            return 0
        if not recs:
            return 0
        return self.flush_resident_records(engine, recs, reason)

    def flush_resident_state(self, reason: str = "interval") -> int:
        """Flush every cached engine's resident slots (the drain, and the
        background flusher's pass)."""
        # shares the cadence stamp with the inline check, so a busy driver
        # does not pay a second take and flush per interval
        with self._resident_flush_lock:
            self._resident_last_flush = time.monotonic()
        return sum(
            self.flush_engine_resident(eng, reason if eng.resident_ready() else "quarantine") for eng in live_engines()
        )

    def flush_resident_records(self, engine, recs: list, reason: str) -> int:
        """Persist fetched resident shares through the Accumulator write
        path (share-only merges: count 0, the identity checksum; counts
        and checksums were durable at each job's commit). A batch
        collected before its flush arrived loses the share (counted in
        `resident_lost`, logged); a deleted task is stale state."""
        from ..messages import ReportIdChecksum, TaskId

        by_task: dict[bytes, list] = {}
        for r in recs:
            by_task.setdefault(r["key"][0], []).append(r)
        flushed = 0
        for task_id_bytes, rows in by_task.items():
            cell: dict = {}

            def write(tx, task_id_bytes=task_id_bytes, rows=rows, cell=cell):
                cell.clear()
                task = tx.get_task(TaskId(task_id_bytes))
                if task is None:
                    cell["stale"] = len(rows)
                    return
                accs: dict[bytes, Accumulator] = {}
                lost = flushed_n = 0
                for r in rows:
                    _, agg_param, bid = r["key"]
                    if tx.batch_has_collected_shard(task.task_id, bid, agg_param):
                        lost += 1
                        log.error("resident share for task %s batch %r arrived after collection; the share is "
                                  "lost (flush reason=%s)", task.task_id, bid[:16], reason)
                        continue
                    acc = accs.get(agg_param)
                    if acc is None:
                        acc = accs[agg_param] = Accumulator(
                            task, self.cfg.batch_aggregation_shard_count, aggregation_parameter=agg_param
                        )
                    acc.update(bid, acc.field.encode_vec(r["share"]), 0, ReportIdChecksum(), r["interval"], [])
                    flushed_n += 1
                for acc in accs.values():
                    acc.flush_to_datastore(tx)
                cell["lost"] = lost
                cell["flushed"] = flushed_n

            try:
                self.ds.run_tx(write, "flush_resident")
            except Exception:
                log.exception("resident flush tx failed (%d buffer(s), reason=%s); the fetched shares are LOST",
                              len(rows), reason)
                self.resident_lost += len(rows)
                continue
            self.resident_lost += cell.get("lost", 0)
            flushed += cell.get("flushed", 0)
        return flushed

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
        if self.peer_health is not None:
            # register before any attempt: the tracker can then probe a
            # peer that never once answered
            self.peer_health.observe_endpoint(task.helper_aggregator_endpoint)
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


class ResidentFlusher:
    """Background resident flush: every interval_s it writes the resident
    slots of every cached engine through the driver's flush path, so an
    idle driver's last jobs do not wait for the next job, and every
    poll_s (at most a second) it flushes a quarantined engine's slots
    (reason `quarantine`): their fetch is bounded, and if it hangs the
    slots wait for the canary's restore. stop() and a final
    `driver.flush_resident_state("drain")` are the drain."""

    def __init__(self, driver: AggregationJobDriver, interval_s: float):
        self.driver = driver
        self.interval_s = max(0.1, float(interval_s))
        self.poll_s = min(1.0, self.interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="resident-flusher", daemon=True)

    def start(self) -> "ResidentFlusher":
        self._thread.start()
        return self

    def _loop(self) -> None:
        elapsed = 0.0
        while not self._stop.wait(self.poll_s):
            elapsed += self.poll_s
            try:
                if elapsed >= self.interval_s:
                    elapsed = 0.0
                    self.driver.flush_resident_state(reason="interval")
                else:
                    for eng in live_engines():
                        if not eng.resident_ready():
                            self.driver.flush_engine_resident(eng, reason="quarantine")
            except Exception:
                log.exception("resident flush pass failed; retrying next pass")

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout_s)
