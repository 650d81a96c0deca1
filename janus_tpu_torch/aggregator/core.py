"""Aggregator protocol handlers: upload, aggregate-init and collection.

The port's counterpart of janus_tpu/aggregator/core.py, as far as a
leader takes uploads and collections and a helper answers aggregate-init,
aggregate-continue and aggregate-share requests: `TaskAggregator`
(keypair lookup, `hpke_config_list`, the upload checks per report and
per column window, `handle_upload`, `handle_aggregate_init` with its
Poplar1 and two-round branches, the replay of a stored response,
`handle_aggregate_continue`, the leader's collection-job create, poll and
delete, the helper's `handle_aggregate_share` with its DP noise) and
`Aggregator` (task lookup, one TaskAggregator per task, the group-commit
`report_writer` of uploads, the aggregator and collector auth checks).
A Prio3 aggregate-init request runs the same steps as janus_tpu's, value
for value:

1. HPKE-open the input shares (batched per config id);
2. decode them into columns (`vdaf/wire.py`);
3. one `engine.helper_init` over the batch (the card's work);
4. one masked `engine.aggregate` per batch bucket (`accumulator.py`);
5. write the job, its report aggregations and its batch aggregations
   in one transaction;
6. answer with the AggregationJobResp.

A two-round VDAF (the `fake_two_round` test fake, Poplar1) parks its
accepted reports in WAITING_HELPER and answers ping-pong CONTINUE; the
leader's continue request finishes them and accumulates their output
shares. A Poplar1 init runs round 1 as one batched IDPF walk on the
card (`poplar1_ops.py`, kernel 1) and round 2 on the host.

An upload is checked as janus_tpu checks it: clock skew and expiry, the
public share's form and the HPKE config id first
(`upload_prepare_columns`), then the HPKE open and the leader share's
length and field range (`upload_decrypt_validate_batch`), each reject
with janus_tpu's error type and message. The checks run over a window of
decoded reports; the serving path runs the two stages in the ingest
pipeline (`ingest/pipeline.py`), and the per-report forms
(`upload_prepare`, `upload_decrypt_validate`, `handle_upload`) run them
on a window of one.

A TaskAggregator runs on CUDA unless it is built with device="cpu", and
so does an Aggregator. Each aggregate-init request leaves the seconds of
its stages in `stage_seconds`; a propagated deadline (core/deadline.py)
is checked between stages as janus_tpu checks it. Collection's
arithmetic (the sum of the shard rows, the DP noise) runs on the host,
as in janus_tpu.

Taskprov (draft-wang-ppm-dap-taskprov-04), as in janus_tpu: a helper
with `Config.taskprov_enabled` provisions a task it does not know from
the `dap-taskprov` header of its first aggregate-init or aggregate-share
request (`task_aggregator_for` -> `taskprov_opt_in`): the peer is
authorized against its pre-shared `PeerAggregator` (cache.py), the VDAF
is gated before anything is stored, and the task takes the verify key
derived from the peer's `verify_key_init` and no HPKE keys of its own.
Every TaskAggregator falls back on the global HPKE keypairs
(`GlobalHpkeKeypairCache`) for a config id its task does not hold.

With `Config.upload_journal_path` set, the report writer spills to the
durable upload journal (`ingest/journal.py`) while the datastore is
unreachable, and a `JournalReplayer` thread drains it back once the
supervisor reports the database reachable; `close()` stops both. The
journal's `status()` is the statusz `upload_journal` section while the
aggregator lives; its `readiness()` stays a method (the readiness
registry comes with the binaries).

The helper's failpoints fire where janus_tpu's do: `helper.aggregate`
at the head of aggregate-init (before the request hash, so an armed error
is a 500 to the leader) and `helper.aggregate_share` just after the
aggregate-share handler's deadline check.

The handlers make janus_tpu's observability calls: the upload and
helper spans (`upload.*`, `helper.hpke_stage`, `.replay_tx`,
`.columnar`, `.accumulate`, `.write_tx`), the upload and step-failure
counters, the HPKE batch-size histogram, the conservation ledger's
bookings inside the write transactions (the helper's admissions and
outcomes, a collection's `collected`), the aggregated-reports counter
and end-to-end histogram after each commit, and `trace_context`, the
current traceparent, on every aggregation and collection job row the
handlers write.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
import threading
import time
from dataclasses import dataclass

import numpy as np

from .. import failpoints, ledger, metrics
from ..core import deadline as deadline_mod
from ..core.hpke import HpkeApplicationInfo, HpkeError, Label, hpke_open_batch, hpke_seal
from ..core.time_util import Clock, RealClock
from ..datastore.models import (
    AggregateShareJob,
    AggregationJobModel,
    AggregationJobState,
    CollectionJobModel,
    CollectionJobState,
    LeaderStoredReport,
    ReportAggregationModel,
    ReportAggregationState,
)
from ..datastore.store import Datastore
from ..device import resolve_device
from ..dp import add_noise_to_agg_share
from ..messages import (
    AggregateShare,
    AggregateShareAad,
    AggregateShareReq,
    AggregationJobContinueReq,
    AggregationJobId,
    AggregationJobInitializeReq,
    AggregationJobResp,
    BatchId,
    BatchSelector,
    Collection,
    CollectionJobId,
    CollectionReq,
    Duration,
    FixedSizeQuery,
    HpkeCiphertext,
    HpkeConfigId,
    HpkeConfigList,
    InputShareAad,
    Interval,
    PartialBatchSelector,
    PlaintextInputShare,
    PrepareError,
    PrepareResp,
    PrepareStepResult,
    Query,
    Report,
    ReportId,
    ReportIdChecksum,
    Role,
    TaskId,
    Time,
    TimeInterval,
    decode_reports_fast,
    plaintext_input_share_payload_fast,
)
from ..messages.codec import DecodeError
from ..ingest.journal import JournalReplayer, UploadJournal
from ..messages.taskprov import TaskprovQueryType
from ..task import QueryTypeConfig, Task
from ..vdaf.registry import circuit_for
from ..vdaf.wire import (
    PP_CONTINUE,
    PP_FINISH,
    PP_INITIALIZE,
    Prio3Wire,
    block_index_rows,
    decode_index_columns,
    decode_pingpong,
    encode_field_rows,
    encode_pingpong,
    flat_scatter_indices,
    lanes_in_range,
    lanes_to_seed_rows,
    seeds_to_lanes,
    split_prep_share_columns,
)
from . import errors
from ..statusz import register_status_provider, unregister_status_provider
from ..trace import current_traceparent, span
from .accumulator import (
    Accumulator,
    accumulate_batched,
    add_encoded_aggregate_shares,
    count_reports_aggregated,
    fixed_size_batch_id,
    observe_report_e2e,
)
from .engine_cache import engine_cache
from .cache import GlobalHpkeKeypairCache, PeerAggregatorCache
from .poplar1_ops import Poplar1Ops
from .report_writer import ReportWriteBatcher

# Round-1 helper prep share carried in the two-round fake VDAF's
# ping-pong CONTINUE (opaque bytes, janus_tpu's; the fake's round-2 check
# is a prep-message echo: the machinery is what multi-round exercises).
FAKE_ROUND1_PREP_SHARE = b"fake-round1-ps!!"


def _one_lane(out: list):
    """The one lane of a column stage's answer; its error is raised."""
    if isinstance(out[0], BaseException):
        raise out[0]
    return out[0]


def _err_or_default(err) -> PrepareError:
    """PrepareError.BATCH_COLLECTED has enum value 0 (falsy), so the
    `err or DEFAULT` idiom silently rewrites it; compare against None."""
    return err if err is not None else PrepareError.VDAF_PREP_ERROR


@dataclass
class Config:
    """reference aggregator.rs:186-218: the helper's aggregate-init and
    the leader's upload and ingest fields."""

    max_upload_batch_size: int = 100
    # 0 = pure group commit (the reference's default write delay,
    # aggregator.rs:186-218); >0 adds a coalescing window
    max_upload_batch_write_delay_ms: int = 0
    batch_aggregation_shard_count: int = 1
    taskprov_enabled: bool = False
    # Retry-After (seconds) on 202 collection-job polls; the collector
    # honors it (reference collector/src/lib.rs:466)
    collection_retry_after_s: int = 1
    # --- ingest pipeline + admission control ---
    # HPKE-decrypt pool size; 0 = sized from the crypto backend's batch
    # GIL-release capability (ingest.pipeline.default_decrypt_workers)
    ingest_decrypt_workers: int = 0
    ingest_decode_workers: int = 1
    # flush-window batching of the decode + decrypt stages: max reports
    # per window and the linger a decode worker waits for it to fill
    ingest_batch_window: int = 32
    ingest_batch_linger_ms: float = 2.0
    # bound on uploads in flight through the pipeline (admission's
    # queue-depth signal and the hard queue-full backstop); every
    # in-flight upload parks one handler thread, so it must stay below
    # max_handler_threads for queue-pressure shedding to fire
    ingest_queue_depth: int = 24
    # token buckets per route class; rate 0 = unlimited
    upload_bucket_rate: float = 0.0
    upload_bucket_burst: int = 0
    aggregate_bucket_rate: float = 0.0
    aggregate_bucket_burst: int = 0
    # shed order under queue pressure (first sheds first): client uploads
    # before the aggregator-to-aggregator steps
    shed_priority: tuple = ("upload", "aggregate")
    # pipeline occupancy fraction at which shed_priority[0] sheds
    queue_high_watermark: float = 0.75
    # Retry-After for queue-pressure sheds (rate sheds advertise the
    # bucket's refill time)
    upload_shed_retry_after_s: float = 1.0
    # cap on concurrent HTTP handler threads in DapServer
    max_handler_threads: int = 32
    # --- durable upload spill journal: the directory of the CRC-framed,
    # fsync-on-ack journal the report writer spills to while the
    # datastore is unreachable. None (default) disarms it. ---
    upload_journal_path: str | None = None
    upload_journal_max_segment_bytes: int = 8 << 20
    upload_journal_max_total_bytes: int = 256 << 20
    upload_journal_max_segments: int = 1024
    upload_journal_spill_latency_s: float = 0.0
    upload_journal_replay_interval_s: float = 1.0
    upload_journal_full_retry_after_s: float = 30.0


class TaskAggregator:
    """Per-task protocol ops (reference aggregator.rs:797)."""

    def __init__(self, task: Task, cfg: Config, device=None, global_hpke_keypairs=None, devices=None):
        self.task = task
        self.cfg = cfg
        self.global_hpke_keypairs = global_hpke_keypairs
        if task.vdaf.kind == "poplar1":
            self.circ = None
            self.wire = None
            self.engine = None
            # CUDA unless the caller asks for the CPU; raises without CUDA
            self.poplar = Poplar1Ops(task.vdaf.bits, task.vdaf_verify_key, resolve_device(device))
        else:
            self.circ = circuit_for(task.vdaf)
            self.wire = Prio3Wire(self.circ)
            # several devices: the engine serves on a mesh
            self.engine = engine_cache(task.vdaf, task.vdaf_verify_key, device, devices=devices)
            self.poplar = None
        self.stage_seconds: dict[str, float] = {}

    def _hpke_keypair(self, config_id):
        """Task keypair, falling back to the global keys (reference
        aggregator.rs:1676; taskprov tasks carry no per-task keys)."""
        kp = self.task.hpke_keypair(config_id)
        if kp is None and self.global_hpke_keypairs is not None:
            kp = self.global_hpke_keypairs.keypair(config_id)
        return kp

    def hpke_config_list(self) -> HpkeConfigList:
        return HpkeConfigList(tuple(kp.config for kp in self.task.hpke_keys))

    # ------------------------------------------------------------------
    # upload (reference aggregator.rs:1325)
    # ------------------------------------------------------------------
    # The checks run once, over a decoded ReportColumn window: the column
    # stages below. The per-report forms run them on a one-lane column.
    def upload_prepare(self, clock: Clock, report: Report):
        """The cheap checks ahead of the decrypt stage: clock skew and
        expiry (reference :1344-1385), the public share's form, the HPKE
        keypair lookup. Returns the keypair for upload_decrypt_validate."""
        return _one_lane(self.upload_prepare_columns(clock, decode_reports_fast([report.to_bytes()]), [0]))

    def upload_decrypt_validate(self, report: Report, keypair) -> LeaderStoredReport:
        """Decrypt and decode the leader input share at upload time
        (reference :1391) and validate its length and field range.
        Returns the LeaderStoredReport to commit."""
        return _one_lane(self.upload_decrypt_validate_batch(decode_reports_fast([report.to_bytes()]), [0], keypair))

    def upload_prepare_columns(self, clock: Clock, col, idxs) -> list:
        """The upload checks ahead of the decrypt stage over lanes `idxs`
        of a ReportColumn: per lane, the HPKE keypair when admitted, else
        the error."""
        task = self.task
        now = clock.now()
        max_time = now.add(task.tolerable_clock_skew).seconds
        expiry = task.task_expiration.seconds if task.task_expiration else None
        kp_cache: dict[int, object] = {}
        # a sparse task's index predicate runs over the whole window at
        # once; a lane of the wrong total length gets None, so it fails
        # as the per-report decoder's length check would
        sparse_ok = None
        if self.poplar is None and self.wire.sparse:
            rows = [
                col.public_shares[i] if len(col.public_shares[i]) == self.wire.public_share_len else None
                for i in idxs
            ]
            _, sparse_ok = decode_index_columns(rows, self.wire.circ)
        out: list = []
        for k, i in enumerate(idxs):
            t = col.times[i]
            if t > max_time:
                out.append(errors.ReportTooEarly("report from the future", task.task_id))
                continue
            if expiry is not None and t > expiry:
                out.append(errors.ReportRejected("task expired", task.task_id))
                continue
            if task.report_expired(Time(t), now):
                out.append(errors.ReportRejected("report expired", task.task_id))
                continue
            # a Poplar1 public share is decoded with the input share, in
            # the decrypt stage (validate_shares decodes it once)
            if sparse_ok is not None:
                if not sparse_ok[k]:
                    metrics.upload_decode_failure_counter.add()
                    out.append(errors.InvalidMessage("bad public share: invalid sparse block indices", task.task_id))
                    continue
            elif self.poplar is None:
                try:
                    self.wire.decode_public_share(col.public_shares[i])
                except DecodeError as e:
                    metrics.upload_decode_failure_counter.add()
                    out.append(errors.InvalidMessage(f"bad public share: {e}", task.task_id))
                    continue
            cfg = col.leader_config_ids[i]
            if cfg not in kp_cache:
                kp_cache[cfg] = self._hpke_keypair(HpkeConfigId(cfg))
            keypair = kp_cache[cfg]
            if keypair is None:
                out.append(errors.OutdatedHpkeConfig("unknown HPKE config id", task.task_id))
                continue
            out.append(keypair)
        return out

    def upload_decrypt_validate_batch(self, col, idxs, keypair) -> list:
        """The decrypt stage over lanes `idxs` of a ReportColumn, all
        carrying `keypair`'s config id: one hpke_open_batch over the
        window, one numpy range check of the leader shares; per lane the
        LeaderStoredReport or the error."""
        task = self.task
        tid = task.task_id.data
        n = len(idxs)
        # InputShareAad.to_bytes, raw: task_id || report_id || time ||
        # u32-length-prefixed public share
        aads = [
            tid + col.report_ids[i] + struct.pack(">QI", col.times[i], len(col.public_shares[i])) + col.public_shares[i]
            for i in idxs
        ]
        with span("upload.hpke_validate_batch", batch=n):
            metrics.hpke_batch_size.observe(n)
            opened = hpke_open_batch(
                keypair,
                HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER),
                [col.leader_encs[i] for i in idxs],
                [col.leader_payloads[i] for i in idxs],
                aads,
            )

        def reject(e) -> errors.ReportRejected:
            metrics.upload_decrypt_failure_counter.add()
            return errors.ReportRejected(f"undecryptable/undecodable share: {e}", task.task_id)

        out: list = [None] * n
        payloads: list = [None] * n
        for j in range(n):
            if isinstance(opened[j], HpkeError):
                out[j] = reject(opened[j])
                continue
            try:
                payloads[j] = plaintext_input_share_payload_fast(opened[j])
            except DecodeError as e:
                out[j] = reject(e)

        if self.poplar is not None:
            for j, i in enumerate(idxs):
                if out[j] is not None:
                    continue
                try:
                    self.poplar.validate_shares(col.public_shares[i], payloads[j], party=0)
                except (DecodeError, ValueError) as e:
                    out[j] = reject(e)
            live: list[int] = []
        else:
            # length + field range over the meas||proof prefix, one numpy pass
            want_len = self.wire.leader_share_len
            nb = (self.circ.input_len + self.circ.proof_len) * self.wire.enc_size
            live = []
            rows: list[bytes] = []
            for j in range(n):
                if out[j] is not None:
                    continue
                if len(payloads[j]) != want_len:
                    out[j] = reject(DecodeError("bad leader share length"))
                    continue
                live.append(j)
                rows.append(payloads[j][:nb])
        if live:
            mat = np.frombuffer(b"".join(rows), dtype="<u8").reshape(len(live), -1)
            ok = lanes_in_range(mat, self.circ.FIELD.MODULUS, self.wire.enc_size // 8).all(axis=-1)
            for k, j in enumerate(live):
                if not ok[k]:
                    out[j] = reject(DecodeError("leader share element out of field range"))

        for j, i in enumerate(idxs):
            if out[j] is None:
                out[j] = LeaderStoredReport(
                    task.task_id,
                    ReportId(col.report_ids[i]),
                    Time(col.times[i]),
                    col.public_shares[i],
                    payloads[j],
                    col.helper_ciphertext(i),
                )
        return out

    def handle_upload(self, ds: Datastore, clock: Clock, report: Report, writer=None) -> None:
        """The single-threaded upload path (tests, tools; the HTTP route
        runs the same two stages in the ingest pipeline). `writer`: a
        ReportWriteBatcher; without one, one transaction per report. A
        replay is silent success, as in DAP."""
        keypair = self.upload_prepare(clock, report)
        stored = self.upload_decrypt_validate(report, keypair)
        with span("upload.write"):
            if writer is not None:
                fresh = writer.write_report(stored)
            else:
                fresh = ds.run_tx(lambda tx: tx.put_client_report(stored), "upload")
        if not fresh:
            metrics.upload_replay_counter.add()

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
        # helper-outage injection: an unhandled FailpointError here is a
        # 500 to the leader's driver, which its breaker counts
        failpoints.hit("helper.aggregate")
        stage = self.stage_seconds = {}
        t0 = time.perf_counter()
        request_hash = hashlib.sha256(request_bytes).digest()

        # idempotent replay (reference :1585,1884,1526)
        existing = ds.run_tx(lambda tx: tx.get_aggregation_job(task.task_id, job_id), "agg_init_check")
        if existing is not None:
            if existing.last_request_hash == request_hash:
                return self._replay_aggregate_init_response(ds, job_id, existing)
            raise errors.InvalidMessage("aggregation job id reuse", task.task_id)

        if req.partial_batch_selector.query_type != task.query_type.code:
            raise errors.InvalidMessage("partial batch selector query type mismatch", task.task_id)

        if self.poplar is not None:
            return self._handle_aggregate_init_poplar1(ds, clock, job_id, req, request_hash)

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
        # block-sparse tasks: the validated public block indices per lane
        idx_rows: list | None = [None] * n if self.wire.sparse else None

        with span("helper.hpke_stage", batch=n):
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
                    kp_cache[cfg_id] = self._hpke_keypair(cfg_id)
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
                metrics.hpke_batch_size.observe(len(idxs_g))
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
                if idx_rows is not None:
                    idx_rows[i] = parts.indices
                leader_prep_rows[i] = prep_share

        # replay check against prior aggregations: one set-valued query
        fresh_ids = [rid for i, rid in enumerate(ids) if prep_err[i] is None]
        deadline_mod.check("helper_replay_tx")
        with span("helper.replay_tx", batch=len(fresh_ids)):
            replayed_ids = ds.run_tx(
                lambda tx: tx.get_aggregated_report_ids(task.task_id, fresh_ids), "agg_init_replay"
            )
        for i, rid in enumerate(ids):
            if prep_err[i] is None and rid.data in replayed_ids:
                prep_err[i] = PrepareError.REPORT_REPLAYED

        # the test fakes' failure at prepare init (janus_tpu's seam)
        if task.vdaf.fails_at("init"):
            for i in range(n):
                if prep_err[i] is None:
                    prep_err[i] = PrepareError.VDAF_PREP_ERROR

        # columnar staging
        with span("helper.columnar", batch=n):
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

        # the test fakes' failure at the step/finish stage
        if task.vdaf.fails_at("step"):
            accept = np.zeros_like(accept)

        for i in range(n):
            if prep_err[i] is None and not accept[i]:
                prep_err[i] = PrepareError.VDAF_PREP_ERROR

        for e in prep_err:
            if e is not None:
                metrics.aggregate_step_failure_counter.add(type=e.name.lower())
        # a two-round VDAF parks accepted reports in WaitingHelper with
        # (prep_msg || out_share) and answers ping-pong CONTINUE; the
        # continue request finishes them
        multi_round = task.vdaf.rounds > 1
        out1_rows = encode_field_rows(self.engine.p3.tf, out1) if multi_round else None
        resps = []
        report_aggs = []
        for i, pi in enumerate(inits):
            md = pi.report_share.metadata
            if prep_err[i] is None and multi_round:
                result = PrepareStepResult.cont(encode_pingpong(PP_CONTINUE, prep_msg_rows[i], FAKE_ROUND1_PREP_SHARE))
                state = ReportAggregationState.WAITING_HELPER
                blob = prep_msg_rows[i] + out1_rows[i]
                err = None
            elif prep_err[i] is None:
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
        # :1811-1826); a two-round job accumulates at continue-finish
        accumulator = Accumulator(task, self.cfg.batch_aggregation_shard_count)
        if not multi_round:
            flat_idx = None
            if idx_rows is not None:
                flat_idx = flat_scatter_indices(block_index_rows(idx_rows, self.wire.circ), self.wire.circ)
            with span("helper.accumulate", batch=n):
                accumulate_batched(
                    task,
                    self.engine,
                    accumulator,
                    out1,
                    accept,
                    [pi.report_share.metadata for pi in inits],
                    batch_identifier=fixed_size_batch_id(req.partial_batch_selector),
                    flat_idx=flat_idx,
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
            AggregationJobState.IN_PROGRESS if multi_round else AggregationJobState.FINISHED,
            0,
            request_hash,
            # the leader's propagated traceparent: the helper's row records
            # the job trace id the leader persisted
            trace_context=current_traceparent(),
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
            # the conservation ledger, helper side: the RA rows are the
            # admission record, and rows terminal in this transaction book
            # their outcome too (a non-empty parameter: the param lane)
            ledger.count_admitted(tx, task.task_id, len(report_aggs), aggregation_parameter=req.aggregation_parameter)
            ledger.count_ra_outcomes(tx, task.task_id, report_aggs, unmerged,
                                     aggregation_parameter=req.aggregation_parameter)
            return unmerged

        deadline_mod.check("helper_write_tx")
        with span("helper.write_tx", batch=n):
            unmerged = ds.run_tx(write, "aggregate_init")
        stage["write_tx"] = time.perf_counter() - t4
        # the e2e histogram only after the commit; a two-round job
        # accumulates at continue
        if not multi_round:
            observe_report_e2e(
                clock,
                [pi.report_share.metadata.time for i, pi in enumerate(inits)
                 if accept[i] and pi.report_share.metadata.report_id.data not in unmerged],
            )
        if unmerged:
            resps = [
                PrepareResp(r.report_id, PrepareStepResult.reject(PrepareError.BATCH_COLLECTED))
                if r.report_id.data in unmerged
                else r
                for r in resps
            ]
        return AggregationJobResp(tuple(resps))

    def _handle_aggregate_init_poplar1(self, ds: Datastore, clock: Clock, job_id, req, request_hash) -> AggregationJobResp:
        """The helper's Poplar1 init (the ping-pong mapping is in
        poplar1_ops.py): the per-report checks, one batched HPKE open per
        config id, round 1 as one batched IDPF walk on the card, round 2
        on the host; accepted reports park in WAITING_HELPER and resolve
        at continue time, where the leader's sigma0 arrives."""
        task = self.task
        pop = self.poplar
        stage = self.stage_seconds = {}
        t0 = time.perf_counter()
        try:
            param = pop.decode_param(req.aggregation_parameter)
        except ValueError as e:
            raise errors.InvalidMessage(f"bad aggregation parameter: {e}", task.task_id)

        inits = list(req.prepare_inits)
        n = len(inits)
        ids = [pi.report_share.metadata.report_id for pi in inits]
        if len(set(ids)) != n:
            raise errors.InvalidMessage("duplicate report id in init request", task.task_id)

        now = clock.now()
        # param-scoped replay check: a report aggregates once per parameter
        replayed_ids = ds.run_tx(
            lambda tx: tx.get_aggregated_report_ids_for_param(task.task_id, ids, req.aggregation_parameter),
            "agg_init_replay_p1",
        )

        # pass 1: per-report checks; HPKE lanes collect per config id
        errs: list = [None] * n
        kp_cache: dict = {}
        hpke_groups: dict = {}  # config id -> (keypair, [i], encs, pays, aads)
        for i, pi in enumerate(inits):
            rs = pi.report_share
            md = rs.metadata
            if task.task_expiration and md.time > task.task_expiration:
                errs[i] = PrepareError.TASK_EXPIRED
            elif task.report_expired(md.time, now):
                errs[i] = PrepareError.REPORT_DROPPED
            elif md.report_id.data in replayed_ids:
                errs[i] = PrepareError.REPORT_REPLAYED
            else:
                cfg_id = rs.encrypted_input_share.config_id
                if cfg_id not in kp_cache:
                    kp_cache[cfg_id] = self._hpke_keypair(cfg_id)
                keypair = kp_cache[cfg_id]
                if keypair is None:
                    errs[i] = PrepareError.HPKE_UNKNOWN_CONFIG_ID
                    continue
                group = hpke_groups.setdefault(cfg_id, (keypair, [], [], [], []))
                group[1].append(i)
                group[2].append(rs.encrypted_input_share.encapsulated_key)
                group[3].append(rs.encrypted_input_share.payload)
                group[4].append(InputShareAad(task.task_id, md, rs.public_share).to_bytes())

        # pass 2: one batched open per config-id group, then the payload
        # and the leader's round-1 share of each opened report
        plaintexts: list[bytes | None] = [None] * n
        info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.HELPER)
        for keypair, idxs_g, encs_g, pays_g, aads_g in hpke_groups.values():
            deadline_mod.check("helper_decrypt")
            for i, pt in zip(idxs_g, hpke_open_batch(keypair, info, encs_g, pays_g, aads_g)):
                if isinstance(pt, HpkeError):
                    errs[i] = PrepareError.HPKE_DECRYPT_ERROR
                else:
                    plaintexts[i] = pt
        msg1_0s: list = [None] * n
        items = []
        item_idx = []
        for i, pi in enumerate(inits):
            if plaintexts[i] is None:
                continue
            rs = pi.report_share
            try:
                payload = PlaintextInputShare.from_bytes(plaintexts[i]).payload
                tag, _, leader_ps = decode_pingpong(pi.message)
                if tag != PP_INITIALIZE or leader_ps is None:
                    raise ValueError("expected ping-pong initialize")
                msg1_0s[i] = pop.decode_fixed_vec(param, leader_ps, 2)
                items.append((rs.public_share, payload, rs.metadata.report_id.data))
                item_idx.append(i)
            except (DecodeError, ValueError):
                errs[i] = PrepareError.INVALID_MESSAGE
        t1 = time.perf_counter()
        stage["hpke_open_decode"] = t1 - t0

        # round 1: one batched device walk over the eligible reports
        round1 = {}
        for i, res in zip(item_idx, pop.round1_batch(1, items, param)):
            if isinstance(res, ValueError):
                errs[i] = PrepareError.INVALID_MESSAGE
            else:
                round1[i] = res
        t2 = time.perf_counter()
        stage["round1"] = t2 - t1

        # round 2 on the host: combine, then park
        resps = []
        report_aggs = []
        for i, pi in enumerate(inits):
            md = pi.report_share.metadata
            err = errs[i]
            blob = b""
            state = ReportAggregationState.FAILED
            if err is None and i in round1:
                st1, y1, msg1_1 = round1[i]
                sigma1, combined = pop.round2(st1, msg1_0s[i], msg1_1)
                # the sketch's verdict needs the leader's sigma0, which the
                # continue request carries
                msg = pop.encode_vec(param, combined)
                share = pop.encode_vec(param, msg1_1) + pop.encode_elem(param, sigma1)
                blob = msg + share + pop.encode_vec(param, y1)
                state = ReportAggregationState.WAITING_HELPER
                result = PrepareStepResult.cont(encode_pingpong(PP_CONTINUE, msg, share))
            else:
                if err is None:
                    err = PrepareError.INVALID_MESSAGE
                metrics.aggregate_step_failure_counter.add(type=err.name.lower())
                result = PrepareStepResult.reject(err)
            resps.append(PrepareResp(md.report_id, result))
            report_aggs.append(ReportAggregationModel(task.task_id, job_id, md.report_id, md.time, i, state, blob, err))
        t3 = time.perf_counter()
        stage["round2"] = t3 - t2

        times = [pi.report_share.metadata.time.seconds for pi in inits]
        job = AggregationJobModel(
            task.task_id,
            job_id,
            req.aggregation_parameter,
            req.partial_batch_selector.to_bytes(),
            Interval(Time(min(times)), Duration(max(times) - min(times) + 1)) if times else Interval(Time(0), Duration(1)),
            AggregationJobState.IN_PROGRESS,
            0,
            request_hash,
            trace_context=current_traceparent(),
        )

        def write(tx):
            tx.put_aggregation_job(job)
            for ra in report_aggs:
                tx.put_report_aggregation(ra)
            # the conservation ledger (see handle_aggregate_init): Poplar1
            # always carries a parameter, so both land in the param lane
            ledger.count_admitted(tx, task.task_id, len(report_aggs), aggregation_parameter=req.aggregation_parameter)
            ledger.count_ra_outcomes(tx, task.task_id, report_aggs, aggregation_parameter=req.aggregation_parameter)

        deadline_mod.check("helper_write_tx")
        ds.run_tx(write, "aggregate_init_p1")
        stage["write_tx"] = time.perf_counter() - t3
        return AggregationJobResp(tuple(resps))

    def _replay_aggregate_init_response(self, ds: Datastore, job_id, job) -> AggregationJobResp:
        """Rebuild the response from the stored rows (reference
        check_aggregation_job_idempotence, aggregator.rs:1526).

        Reached only while the job's last_request_hash is still the init
        request's, before any continue (a continue bumps the hash).
        WAITING_HELPER rows answer the same ping-pong CONTINUE the init
        answered; FINISHED rows hold their prep message in prep_blob."""
        ras = ds.run_tx(
            lambda tx: tx.get_report_aggregations_for_job(self.task.task_id, job_id), "agg_init_replay_resp"
        )
        if self.poplar is not None:
            # blob = enc(A)||enc(B) || enc(A1)||enc(B1)||enc(sigma1) || y1
            es = self.poplar.enc_size(self.poplar.decode_param(job.aggregation_parameter))
            msg_len = 2 * es

            def round1_share(blob):
                return blob[2 * es : 5 * es]
        else:
            msg_len = 16 if self.wire.uses_jr else 0

            def round1_share(blob):
                return FAKE_ROUND1_PREP_SHARE

        resps = []
        for ra in ras:
            if ra.state == ReportAggregationState.FINISHED:
                result = PrepareStepResult.cont(encode_pingpong(PP_FINISH, ra.prep_blob, None))
            elif ra.state == ReportAggregationState.WAITING_HELPER:
                result = PrepareStepResult.cont(
                    encode_pingpong(PP_CONTINUE, ra.prep_blob[:msg_len], round1_share(ra.prep_blob))
                )
            else:
                result = PrepareStepResult.reject(_err_or_default(ra.prepare_error))
            resps.append(PrepareResp(ra.report_id, result))
        return AggregationJobResp(tuple(resps))

    # ------------------------------------------------------------------
    # helper aggregate continue (reference aggregation_job_continue.rs:30-300)
    # ------------------------------------------------------------------
    def handle_aggregate_continue(
        self,
        ds: Datastore,
        clock: Clock,
        job_id: AggregationJobId,
        req: AggregationJobContinueReq,
        request_bytes: bytes,
    ) -> AggregationJobResp:
        """Step a two-round job: ord-matched prepare continues against the
        stored WaitingHelper rows, step and replay validation, accumulate
        on finish."""
        task = self.task
        deadline_mod.check("helper_continue")
        if task.vdaf.rounds == 1:
            # a continue request is always a step mismatch for a one-round
            # VDAF (reference parity gate)
            raise errors.StepMismatch("no multi-round VDAFs configured", task.task_id)
        request_hash = hashlib.sha256(request_bytes).digest()
        step = req.step.step
        if step == 0:
            raise errors.InvalidMessage("aggregation job cannot continue to step 0", task.task_id)

        # validation, row reads, accumulate and writes in ONE transaction:
        # concurrent identical continues (a leader's timeout and re-POST)
        # serialize, so exactly one processes and the other replays
        def process(tx):
            job = tx.get_aggregation_job(task.task_id, job_id)
            if job is None:
                raise errors.UnrecognizedAggregationJob("no such aggregation job", task.task_id)
            if step == job.step:
                # idempotent replay: same request, same response, scoped to
                # the reports the continue addressed
                if job.last_request_hash == request_hash:
                    return self._rebuild_continue_resps(tx, job_id, req)
                raise errors.StepMismatch("continue step replay with different request", task.task_id)
            if job.state != AggregationJobState.IN_PROGRESS:
                raise errors.StepMismatch("aggregation job is not continuable", task.task_id)
            if step != job.step + 1:
                raise errors.StepMismatch(f"continue to step {step}, job is at step {job.step}", task.task_id)

            ras = tx.get_report_aggregations_for_job(task.task_id, job_id)
            all_waiting = [ra for ra in ras if ra.state == ReportAggregationState.WAITING_HELPER]
            # ord-matched subsequence (reference :58-84): a waiting report
            # the leader omitted is dropped; an unexpected, duplicate or
            # out-of-order step rejects the request
            waiting = []
            dropped = []
            it = iter(all_waiting)
            for pc in req.prepare_continues:
                for ra in it:
                    if ra.report_id == pc.report_id:
                        waiting.append(ra)
                        break
                    dropped.append(ra)
                else:
                    raise errors.InvalidMessage(
                        "leader sent unexpected, duplicate, or out-of-order prepare steps", task.task_id
                    )
            dropped.extend(it)  # trailing omissions

            pop_sigma1_at = None
            if self.poplar is not None:
                # blob = enc(A)||enc(B) || enc(A1)||enc(B1)||enc(sigma1) || y1
                param = self.poplar.decode_param(job.aggregation_parameter)
                es = self.poplar.enc_size(param)
                msg_len, skip_len = es, 5 * es  # FINISH msg = enc(sigma0)

                def pop_sigma1_at(blob):
                    return blob[4 * es : 5 * es]

                field = self.poplar.field_for(param)
            else:
                msg_len = 16 if self.wire.uses_jr else 0
                skip_len = msg_len
                field = None
            # count_metrics=False: this accumulator lives inside the run_tx
            # closure (a retry re-creates it); counted after the commit
            accumulator = Accumulator(
                task, self.cfg.batch_aggregation_shard_count, field=field, aggregation_parameter=job.aggregation_parameter,
                count_metrics=False,
            )
            fixed_bid = fixed_size_batch_id(PartialBatchSelector.from_bytes(job.partial_batch_identifier))
            updated = []
            resps = []
            for ra, pc in zip(waiting, req.prepare_continues):
                ok = False
                try:
                    tag, prep_msg, _share = decode_pingpong(pc.message)
                    if tag != PP_FINISH:
                        ok = False
                    elif pop_sigma1_at is not None:
                        # FINISH carries the leader's sigma0; accept iff
                        # sigma0 + sigma1 == 0
                        sigma0 = self.poplar.decode_elem(param, prep_msg or b"")
                        sigma1 = self.poplar.decode_elem(param, pop_sigma1_at(ra.prep_blob))
                        ok = field.add(sigma0, sigma1) == 0
                    else:
                        ok = (prep_msg or b"") == ra.prep_blob[:msg_len]
                except (DecodeError, ValueError):
                    ok = False
                if ok:
                    out_share = accumulator.field.decode_vec(ra.prep_blob[skip_len:])
                    bid = fixed_bid or Interval(
                        ra.client_time.to_batch_interval_start(task.time_precision), task.time_precision
                    ).to_bytes()
                    accumulator.update_single(bid, out_share, ra.report_id, ra.client_time)
                    updated.append(dataclasses.replace(ra, state=ReportAggregationState.FINISHED, prep_blob=b""))
                    resps.append(PrepareResp(ra.report_id, PrepareStepResult.finished()))
                else:
                    metrics.aggregate_step_failure_counter.add(type="vdaf_prep_error")
                    updated.append(ra.failed(PrepareError.VDAF_PREP_ERROR))
                    resps.append(PrepareResp(ra.report_id, PrepareStepResult.reject(PrepareError.VDAF_PREP_ERROR)))

            unmerged = accumulator.flush_to_datastore(tx)
            counted["n"] = accumulator.total_report_count() - len(unmerged)
            # the merged reports' client times, out of the committing
            # attempt, for the post-commit e2e observation
            counted["times"] = [
                ra.client_time for ra in updated
                if ra.state == ReportAggregationState.FINISHED and ra.report_id.data not in unmerged
            ]
            tx.update_aggregation_job(
                dataclasses.replace(
                    job, state=AggregationJobState.FINISHED, step=step, last_request_hash=request_hash
                )
            )
            dropped_terminal = [ra.failed(PrepareError.REPORT_DROPPED) for ra in dropped]
            for ra in dropped_terminal:
                # waiting rows the leader omitted (failed on its side):
                # reference marks them ReportDropped (:72-81)
                tx.update_report_aggregation(ra)
            for ra in updated:
                tx.update_report_aggregation(
                    ra.failed(PrepareError.BATCH_COLLECTED) if ra.report_id.data in unmerged else ra
                )
            # the conservation ledger: every addressed or omitted row
            # reaches a terminal in this transaction
            ledger.count_ra_outcomes(tx, task.task_id, updated + dropped_terminal, unmerged,
                                     aggregation_parameter=job.aggregation_parameter)
            if unmerged:
                resps = [
                    PrepareResp(r.report_id, PrepareStepResult.reject(PrepareError.BATCH_COLLECTED))
                    if r.report_id.data in unmerged
                    else r
                    for r in resps
                ]
            return AggregationJobResp(tuple(resps))

        counted: dict = {}
        resp = ds.run_tx(process, "aggregate_continue")
        count_reports_aggregated(task.task_id, counted.get("n", 0))
        observe_report_e2e(clock, counted.get("times", ()))
        return resp

    def _rebuild_continue_resps(self, tx, job_id, req) -> AggregationJobResp:
        """The replay's response, scoped to exactly the reports the
        continue request addressed, in request order (init-time failures
        are not part of a continue response)."""
        ras = {ra.report_id: ra for ra in tx.get_report_aggregations_for_job(self.task.task_id, job_id)}
        resps = []
        for pc in req.prepare_continues:
            ra = ras.get(pc.report_id)
            if ra is None:
                continue
            if ra.state == ReportAggregationState.FINISHED:
                resps.append(PrepareResp(ra.report_id, PrepareStepResult.finished()))
            else:
                resps.append(PrepareResp(ra.report_id, PrepareStepResult.reject(_err_or_default(ra.prepare_error))))
        return AggregationJobResp(tuple(resps))

    # ------------------------------------------------------------------
    # collection jobs (leader; reference aggregator.rs:2185-2746)
    # ------------------------------------------------------------------
    def handle_create_collection_job(
        self, ds: Datastore, collection_job_id: CollectionJobId, req: CollectionReq
    ) -> None:
        task = self.task
        if req.query.query_type != task.query_type.code:
            raise errors.InvalidMessage("query type mismatch", task.task_id)
        if self.poplar is not None:
            # a malformed parameter is refused at creation, not left for
            # the driver to abandon after its lease attempts
            try:
                self.poplar.decode_param(req.aggregation_parameter)
            except ValueError as e:
                raise errors.InvalidMessage(f"bad aggregation parameter: {e}", task.task_id)
        elif req.aggregation_parameter != b"" and not task.vdaf.kind.startswith("fake"):
            # the fakes, like the reference's dummy VDAF, take any
            # parameter; a Prio3 parameter is empty
            raise errors.InvalidMessage(
                "nonempty aggregation parameter for a parameterless VDAF",
                task.task_id,
            )
        current_batch = False
        if req.query.query_type == TimeInterval.CODE:
            interval = req.query.batch_interval
            if not interval.aligned_to(task.time_precision):
                raise errors.BatchInvalid("unaligned batch interval", task.task_id)
            if interval.duration.seconds < task.time_precision.seconds:
                raise errors.BatchInvalid("batch interval too small", task.task_id)
            batch_identifier = interval.to_bytes()
        elif req.query.fixed_size_query.kind == FixedSizeQuery.BY_BATCH_ID:
            batch_identifier = req.query.fixed_size_query.batch_id.data
        else:
            current_batch = True  # batch resolved inside the tx
            batch_identifier = None

        def create(tx):
            # current-batch queries are byte-identical across requests, so
            # their idempotency key is the collection job id, not the query
            if current_batch:
                existing = tx.get_collection_job(task.task_id, collection_job_id)
                if existing is not None:
                    if existing.query != req.query.to_bytes():
                        raise errors.InvalidMessage("collection job id reuse", task.task_id)
                    return  # idempotent retry of the same request
                chosen = None
                for ob in tx.get_outstanding_batches(task.task_id, include_filled=True):
                    # gate on reports actually aggregated, not assigned: an
                    # assigned report can fail prepare, and a consumed batch
                    # that never reaches min_batch_size is stranded
                    aggregated = tx.sum_batch_aggregation_report_count(
                        task.task_id, ob.batch_id.data, req.aggregation_parameter
                    )
                    if aggregated >= task.min_batch_size:
                        chosen = ob
                        break
                if chosen is None:
                    raise errors.BatchInvalid("no batch ready for collection", task.task_id)
                tx.delete_outstanding_batch(task.task_id, chosen.batch_id)
                bid = chosen.batch_id.data
            else:
                existing = tx.find_collection_job_by_query(
                    task.task_id, req.query.to_bytes(), req.aggregation_parameter
                )
                if existing is not None:
                    if existing.collection_job_id != collection_job_id:
                        raise errors.BatchOverlap("query already collected under another job", task.task_id)
                    return
                if tx.get_collection_job(task.task_id, collection_job_id) is not None:
                    raise errors.InvalidMessage("collection job id reuse", task.task_id)
                bid = batch_identifier

            # the leader's collect validation (reference query_type.rs:204
            # and aggregator.rs:2185-2485): overlap with distinct earlier
            # batches, then the query budget; deleted jobs still count
            if req.query.query_type == TimeInterval.CODE:
                for other_bid, _query, _state in tx.get_collection_job_batches_for_task(task.task_id):
                    if other_bid == bid:
                        continue
                    other = Interval.from_bytes(other_bid)
                    if (
                        interval.start.seconds < other.end.seconds
                        and other.start.seconds < interval.end.seconds
                    ):
                        raise errors.BatchOverlap(
                            "batch interval overlaps a previously collected interval",
                            task.task_id,
                        )
            queried = tx.count_collection_jobs_for_batch(task.task_id, bid)
            if queried >= task.max_batch_query_count:
                raise errors.BatchQueryCountExceeded(
                    "batch has reached max_batch_query_count", task.task_id
                )
            tx.put_collection_job(
                CollectionJobModel(
                    task.task_id,
                    collection_job_id,
                    req.query.to_bytes(),
                    req.aggregation_parameter,
                    bid,
                    CollectionJobState.START,
                    # the collection_create handler span's context: the
                    # collection job driver adopts it on every step
                    trace_context=current_traceparent(),
                )
            )

        ds.run_tx(create, "create_collection_job")

    def handle_get_collection_job(self, ds: Datastore, collection_job_id: CollectionJobId):
        """-> (ready: bool, Collection | None)."""
        task = self.task
        job = ds.run_tx(
            lambda tx: tx.get_collection_job(task.task_id, collection_job_id),
            "get_collection_job",
        )
        if job is None or job.state == CollectionJobState.DELETED:
            raise errors.UnrecognizedCollectionJob("no such collection job", task.task_id)
        if job.state in (CollectionJobState.START, CollectionJobState.COLLECTABLE):
            return False, None
        if job.state == CollectionJobState.ABANDONED:
            raise errors.AggregatorError("collection job abandoned", task.task_id)
        # finished: the leader's share is sealed to the collector here
        query = Query.from_bytes(job.query)
        if query.query_type == TimeInterval.CODE:
            pbs = PartialBatchSelector.time_interval()
            batch_selector = BatchSelector.time_interval(Interval.from_bytes(job.batch_identifier))
        else:
            pbs = PartialBatchSelector.fixed_size(BatchId(job.batch_identifier))
            batch_selector = BatchSelector.fixed_size(BatchId(job.batch_identifier))
        aad = AggregateShareAad(task.task_id, job.aggregation_parameter, batch_selector).to_bytes()
        leader_enc = hpke_seal(
            task.collector_hpke_config,
            HpkeApplicationInfo(Label.AGGREGATE_SHARE, Role.LEADER, Role.COLLECTOR),
            job.leader_aggregate_share,
            aad,
        )
        helper_enc = HpkeCiphertext.from_bytes(job.helper_encrypted_aggregate_share)
        return True, Collection(pbs, job.report_count, job.client_timestamp_interval, leader_enc, helper_enc)

    def handle_delete_collection_job(self, ds: Datastore, collection_job_id: CollectionJobId) -> None:
        task = self.task

        def delete(tx):
            job = tx.get_collection_job(task.task_id, collection_job_id)
            if job is None:
                raise errors.UnrecognizedCollectionJob("no such collection job", task.task_id)
            tx.update_collection_job(dataclasses.replace(job, state=CollectionJobState.DELETED))

        ds.run_tx(delete, "delete_collection_job")

    # ------------------------------------------------------------------
    # aggregate share (helper; reference aggregator.rs:2747-2980)
    # ------------------------------------------------------------------
    def handle_aggregate_share(self, ds: Datastore, req: AggregateShareReq) -> AggregateShare:
        task = self.task
        deadline_mod.check("helper_aggregate_share")
        failpoints.hit("helper.aggregate_share")
        if req.batch_selector.query_type != task.query_type.code:
            raise errors.InvalidMessage("query type mismatch", task.task_id)
        if req.batch_selector.query_type == TimeInterval.CODE:
            interval = req.batch_selector.batch_interval
            if not interval.aligned_to(task.time_precision):
                raise errors.BatchInvalid("unaligned batch interval", task.task_id)
            batch_identifier = interval.to_bytes()
        else:
            batch_identifier = req.batch_selector.batch_id.data
        if self.poplar is not None:
            try:
                share_field = self.poplar.field_for(self.poplar.decode_param(req.aggregation_parameter))
            except ValueError as e:
                raise errors.InvalidMessage(f"bad aggregation parameter: {e}", task.task_id)
        else:
            share_field = self.circ.FIELD

        def compute(tx):
            existing = tx.get_aggregate_share_job(task.task_id, batch_identifier, req.aggregation_parameter)
            if existing is not None:
                return existing
            # enforce the query count (reference max_batch_query_count)
            count = tx.count_aggregate_share_jobs_for_batch(task.task_id, batch_identifier)
            if count >= task.max_batch_query_count:
                raise errors.BatchQueryCountExceeded("batch queried too many times", task.task_id)
            # gather the helper's own shard rows
            if req.batch_selector.query_type == TimeInterval.CODE:
                rows = tx.get_batch_aggregations_intersecting_interval(
                    task.task_id,
                    Interval.from_bytes(batch_identifier),
                    aggregation_parameter=req.aggregation_parameter,
                )
            else:
                rows = tx.get_batch_aggregations_for_batch(task.task_id, batch_identifier, req.aggregation_parameter)
            share = None
            total = 0
            checksum = ReportIdChecksum()
            for row in rows:
                share = add_encoded_aggregate_shares(share_field, share, row.aggregate_share)
                total += row.report_count
                checksum = checksum.combined_with(row.checksum)
                tx.mark_batch_aggregations_collected(task.task_id, row.batch_identifier, row.aggregation_parameter)
            # the conservation ledger: only rows still uncollected at
            # gather time book `collected` (a re-query adds nothing, a
            # failed transaction books nothing)
            ledger.count_collected(tx, task.task_id, rows)
            if share is None:
                raise errors.BatchInvalid("no aggregated reports in batch", task.task_id)
            # leader/helper consistency (reference checksum/count match)
            if total != req.report_count or checksum != req.checksum:
                raise errors.BatchMismatch(
                    f"count/checksum mismatch: ours {total}, leader {req.report_count}",
                    task.task_id,
                )
            if total < task.min_batch_size:
                raise errors.InvalidBatchSize(f"batch too small: {total}", task.task_id)
            # DP: noise the helper's share once, before it is persisted or
            # released (count and checksum stay exact)
            share = add_noise_to_agg_share(task.dp_strategy, share_field, share)
            job = AggregateShareJob(
                task.task_id, batch_identifier, req.aggregation_parameter, share, total, checksum
            )
            tx.put_aggregate_share_job(job)
            return job

        job = ds.run_tx(compute, "aggregate_share")
        aad = AggregateShareAad(task.task_id, req.aggregation_parameter, req.batch_selector).to_bytes()
        encrypted = hpke_seal(
            task.collector_hpke_config,
            HpkeApplicationInfo(Label.AGGREGATE_SHARE, Role.HELPER, Role.COLLECTOR),
            job.helper_aggregate_share,
            aad,
        )
        return AggregateShare(encrypted)


class Aggregator:
    """Top-level request router over tasks (reference aggregator.rs:156):
    the helper's aggregate-init and aggregate-share, the leader's uploads
    and collection jobs."""

    def __init__(self, ds: Datastore, clock: Clock | None = None, cfg: Config | None = None, device=None,
                 devices=None):
        self.ds = ds
        self.clock = clock or RealClock()
        self.cfg = cfg or Config()
        # CUDA unless the caller asks for the CPU; raises without CUDA.
        # The engines serve on `devices` where the caller names several (a
        # mesh), else on the one device
        self.devices = tuple(map(resolve_device, devices or (device,)))
        self.device = self.devices[0]
        self._task_aggs: dict[bytes, TaskAggregator] = {}
        self._task_aggs_lock = threading.Lock()
        self.global_hpke_keypairs = GlobalHpkeKeypairCache(ds)
        self.peer_aggregators = PeerAggregatorCache(ds) if self.cfg.taskprov_enabled else None
        # datastore-outage survival: with a journal path the report
        # writer spills to the durable journal while the datastore is
        # unreachable, and a replayer drains it back on recovery
        self.upload_journal = None
        self.journal_replayer = None
        if self.cfg.upload_journal_path:
            self.upload_journal = UploadJournal(
                self.cfg.upload_journal_path,
                ds.crypter,
                max_segment_bytes=self.cfg.upload_journal_max_segment_bytes,
                max_total_bytes=self.cfg.upload_journal_max_total_bytes,
                max_segments=self.cfg.upload_journal_max_segments,
                full_retry_after_s=self.cfg.upload_journal_full_retry_after_s,
            )
        self.report_writer = ReportWriteBatcher(
            ds,
            self.cfg.max_upload_batch_size,
            self.cfg.max_upload_batch_write_delay_ms,
            journal=self.upload_journal,
            spill_latency_s=self.cfg.upload_journal_spill_latency_s,
        )
        if self.upload_journal is not None:
            register_status_provider("upload_journal", self.upload_journal.status)
            self.journal_replayer = JournalReplayer(
                self.upload_journal,
                self.report_writer,
                supervisor_fn=lambda: getattr(self.ds, "supervisor", None),
                interval_s=self.cfg.upload_journal_replay_interval_s,
            ).start()

    def close(self) -> None:
        """Shutdown: stop the journal replayer, then flush and stop the
        report writer, so uploads still buffered in the group commit land
        before exit (journaled ones stay on disk and replay on the next
        boot)."""
        if self.journal_replayer is not None:
            self.journal_replayer.stop()
        self.report_writer.close()
        if self.upload_journal is not None:
            unregister_status_provider("upload_journal", self.upload_journal.status)
            self.upload_journal.close()

    def task_aggregator_for(
        self, task_id: TaskId, taskprov_task_config=None, headers=None, peer_role: Role = Role.LEADER
    ) -> TaskAggregator:
        """peer_role: the role of the peer provisioning the task through
        taskprov (the helper's endpoints are called by the leader)."""
        ta = self._task_aggs.get(task_id.data)
        if ta is None:
            task = self.ds.run_tx(lambda tx: tx.get_task(task_id), "get_task")
            if task is None:
                if self.cfg.taskprov_enabled and taskprov_task_config is not None:
                    # opt in, then read again (reference aggregator.rs:368-381)
                    self.taskprov_opt_in(peer_role, task_id, taskprov_task_config, headers or {})
                    task = self.ds.run_tx(lambda tx: tx.get_task(task_id), "get_task")
                if task is None:
                    raise errors.UnrecognizedTask("unknown task", task_id)
            # first insert wins: every caller gets the same object
            candidate = TaskAggregator(task, self.cfg, device=self.device, global_hpke_keypairs=self.global_hpke_keypairs,
                                       devices=self.devices)
            with self._task_aggs_lock:
                ta = self._task_aggs.setdefault(task_id.data, candidate)
        return ta

    # ------------------------------------------------------------------
    # taskprov (reference aggregator.rs:639-776)
    # ------------------------------------------------------------------
    def taskprov_authorize_request(self, peer_role: Role, task_id: TaskId, task_config, headers):
        """Validate and authenticate a taskprov request against the
        pre-shared peer; returns the PeerAggregator (reference
        taskprov_authorize_request, aggregator.rs:724)."""
        urls = task_config.aggregator_endpoints
        if len(urls) != 2:
            raise errors.InvalidMessage("taskprov configuration is missing one or both aggregators", task_id)
        peer_url = urls[0] if peer_role == Role.LEADER else urls[1]
        peer = self.peer_aggregators.get(peer_url, peer_role) if self.peer_aggregators else None
        if peer is None:
            raise errors.InvalidTask(f"no such peer aggregator {peer_url}", task_id)
        if not peer.check_aggregator_auth(headers or {}):
            raise errors.UnauthorizedRequest("bad taskprov aggregator auth", task_id)
        if self.clock.now() > task_config.task_expiration:
            raise errors.InvalidTask("task expired", task_id)
        return peer

    def taskprov_opt_in(self, peer_role: Role, task_id: TaskId, task_config, headers) -> None:
        """Provision a task from an in-band TaskConfig (reference
        taskprov_opt_in, aggregator.rs:641-719)."""
        peer = self.taskprov_authorize_request(peer_role, task_id, task_config, headers)
        try:
            vdaf_instance = task_config.vdaf_config.vdaf_type.to_vdaf_instance()
            # gate before persisting: a task whose circuit can never be
            # built must be a clean InvalidTask, not a stored task that
            # answers 500 forever
            circuit_for(vdaf_instance)
        except ValueError as e:
            raise errors.InvalidTask(str(e), task_id)
        our_role = Role.HELPER if peer_role == Role.LEADER else Role.LEADER
        verify_key = peer.derive_vdaf_verify_key(task_id)

        qc = task_config.query_config
        if qc.query_type == TaskprovQueryType.TIME_INTERVAL:
            query_type = QueryTypeConfig.time_interval()
        elif qc.query_type == TaskprovQueryType.FIXED_SIZE:
            query_type = QueryTypeConfig.fixed_size(max_batch_size=qc.max_batch_size)
        else:
            raise errors.InvalidTask(f"unsupported query type {qc.query_type}", task_id)

        task = Task(
            task_id=task_id,
            leader_aggregator_endpoint=task_config.leader_url(),
            helper_aggregator_endpoint=task_config.helper_url(),
            query_type=query_type,
            vdaf=vdaf_instance,
            role=our_role,
            vdaf_verify_key=verify_key,
            max_batch_query_count=qc.max_batch_query_count,
            task_expiration=task_config.task_expiration,
            report_expiry_age=peer.report_expiry_age,
            min_batch_size=qc.min_batch_size,
            time_precision=qc.time_precision,
            tolerable_clock_skew=peer.tolerable_clock_skew,
            collector_hpke_config=peer.collector_hpke_config,
            aggregator_auth_token=None,  # peer tokens authenticate taskprov
            collector_auth_token=None,
            hpke_keys=(),  # taskprov tasks use the global HPKE keys
        )

        def put(tx):
            # a concurrent opt-in by another replica is benign (reference
            # aggregator.rs:699-707): the same config makes the same task
            if tx.get_task(task_id) is None:
                tx.put_task(task)

        self.ds.run_tx(put, "taskprov_put_task")

    def check_aggregator_auth(self, task: Task, headers) -> None:
        tok = task.aggregator_auth_token
        if tok is None or not tok.matches_headers(headers):
            raise errors.UnauthorizedRequest("bad aggregator auth", task.task_id)

    def check_collector_auth(self, task: Task, headers) -> None:
        tok = task.collector_auth_token
        if tok is None or not tok.matches_headers(headers):
            raise errors.UnauthorizedRequest("bad collector auth", task.task_id)

    def handle_aggregate_init(self, task_id: TaskId, job_id: AggregationJobId, request_bytes: bytes) -> AggregationJobResp:
        """Decode an AggregationJobInitializeReq from its wire bytes and
        answer it for the task."""
        ta = self.task_aggregator_for(task_id)
        try:
            req = AggregationJobInitializeReq.from_bytes(request_bytes)
        except DecodeError as e:
            raise errors.InvalidMessage(f"undecodable aggregate-init request: {e}", task_id)
        return ta.handle_aggregate_init(self.ds, self.clock, job_id, req, request_bytes)

    def handle_aggregate_continue(
        self, task_id: TaskId, job_id: AggregationJobId, request_bytes: bytes
    ) -> AggregationJobResp:
        """Decode an AggregationJobContinueReq from its wire bytes and
        answer it for the task."""
        ta = self.task_aggregator_for(task_id)
        try:
            req = AggregationJobContinueReq.from_bytes(request_bytes)
        except DecodeError as e:
            raise errors.InvalidMessage(f"undecodable aggregate-continue request: {e}", task_id)
        return ta.handle_aggregate_continue(self.ds, self.clock, job_id, req, request_bytes)
