"""Collection job driver (the leader's stepper).

Equivalent of reference aggregator/src/aggregator/collection_job_driver.rs:
40-307: acquire leases on collectable collection jobs, compute the
leader's aggregate share from the batch-aggregation shard rows, POST an
AggregateShareReq to the helper, store the helper's encrypted share and
finish the job.

The port's own copy of janus_tpu/aggregator/collection_job_driver.py:
the config, the batched acquirer (with a fleet's shard predicate and
holder tag, as AggregationJobDriver.acquirer) and its drain releaser
`release_on_drain`, the stepper with its
step-backs, the step (gather, sum, the min-batch gate, DP noise on the
leader's share, persisted and reused, the AggregateShareReq, then mark
and store in one transaction), the send path with its circuit breaker,
retries and lease-bounded deadline, and the abandonment. The sum runs on
the host, as in janus_tpu: collection launches no kernel. Each step's
stage seconds are kept in `step_seconds`. With a `peer_health` tracker
the acquirer parks while every helper's circuit is open.

A VDAF with an aggregation parameter (Poplar1) aggregates per
collection: the first step of its collection job creates param-scoped
aggregation jobs of at most 512 reports over the batch interval
(`_ensure_param_aggregation`) and releases the job; later steps release
it again until no job for the parameter is in progress, then compute the
aggregate share as for Prio3.

Observability, as in janus_tpu: a step runs under the trace the
collection-create handler persisted (`use_traceparent` of the row's
`trace_context`), its finishing span links the trace ids of the
aggregation jobs that filled the batch, param-scoped jobs join the
collection's trace, the store books `collected` (and the param lane's
admissions `admitted_param`) in the conservation ledger, and after the
store `_reconcile_with_helper` reads the helper's per-batch counts
(GET /tasks/{id}/ledger) into the installed ledger evaluator's peer
divergence. The step-back, cancellation and collect-stage e2e metrics are
janus_tpu's.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import secrets
import time
from collections import deque
from dataclasses import dataclass

from ..core.circuit_breaker import (
    CircuitBreakerConfig,
    CircuitOpenError,
    OutboundCircuitBreakers,
    default_breakers,
    peer_label,
)
from ..core.deadline import DEADLINE_EXCEEDED_STATUS, DeadlineExceeded, deadline_scope
from .. import ledger, metrics
from ..core.retries import Backoff, RequestAborted, retry_http_request
from ..datastore.models import (
    AcquiredCollectionJob,
    AggregateShareJob,
    AggregationJobModel,
    AggregationJobState,
    CollectionJobState,
    ReportAggregationModel,
    ReportAggregationState,
)
from ..datastore.store import Datastore, LeaseConflict
from ..dp import add_noise_to_agg_share
from ..messages import (
    AggregateShare,
    AggregateShareReq,
    AggregationJobId,
    BatchId,
    BatchSelector,
    Duration,
    Interval,
    PartialBatchSelector,
    Query,
    ReportIdChecksum,
    Time,
    TimeInterval,
)
from ..task import Task
from ..trace import current_traceparent, span, trace_id_of, use_traceparent
from ..vdaf.registry import circuit_for
from .accumulator import add_encoded_aggregate_shares
from .job_driver import (
    datastore_reconnect_delay_s,
    deadline_request_timeout,
    is_datastore_connection_error,
    lease_deadline,
    make_claim_acquirer,
)
from .poplar1_ops import Poplar1Ops

log = logging.getLogger(__name__)


@dataclass
class CollectionJobDriverConfig:
    maximum_attempts_before_failure: int = 10
    http_backoff: Backoff = Backoff()
    # see AggregationJobDriverConfig.worker_lease_clock_skew_s
    worker_lease_clock_skew_s: int = 60
    # see AggregationJobDriverConfig.circuit_breaker / min_step_back_delay_s
    circuit_breaker: CircuitBreakerConfig | None = None
    min_step_back_delay_s: int = 1


class CollectionJobDriver:
    """reference collection_job_driver.rs:40."""

    def __init__(
        self,
        ds: Datastore,
        http,
        cfg: CollectionJobDriverConfig | None = None,
        breakers: OutboundCircuitBreakers | None = None,
        stopper=None,
        peer_health=None,
    ):
        self.ds = ds
        self.http = http
        self.cfg = cfg or CollectionJobDriverConfig()
        self.breakers = breakers if breakers is not None else default_breakers(self.cfg.circuit_breaker)
        self.stopper = stopper
        # the peer-outage parking tracker (peer_health.PeerHealthTracker),
        # shared with the aggregation driver
        self.peer_health = peer_health
        # (collection job id bytes, {stage: seconds}) of the latest steps
        self.step_seconds: deque = deque(maxlen=64)

    def acquirer(self, lease_duration_s: int = 600, fleet=None):
        """Batched claim acquirer over collectable collection jobs; `fleet`
        as in AggregationJobDriver.acquirer."""
        if fleet is not None:
            fleet.install_identity()
        shard = fleet.shard_spec() if fleet is not None else None
        holder = fleet.holder_tag() if fleet is not None else None
        return make_claim_acquirer(
            self.ds,
            "collection",
            lambda limit: self.ds.run_tx(
                lambda tx: tx.acquire_incomplete_collection_jobs(
                    Duration(lease_duration_s), limit, shard=shard, holder=holder
                ),
                "acquire_collection_jobs",
            ),
            shard=shard,
            peer_gate=self.peer_health.park_gate() if self.peer_health is not None else None,
        )

    def release_on_drain(self, acquired: AcquiredCollectionJob) -> None:
        """JobDriver's drain releaser: see AggregationJobDriver.release_on_drain."""
        self.step_back(acquired, "shutdown_drain", 0.0)

    def stepper(self, acquired: AcquiredCollectionJob) -> None:
        if acquired.lease.attempts > self.cfg.maximum_attempts_before_failure:
            self.abandon_job(acquired)
            return
        try:
            self.step_collection_job(acquired)
        except CircuitOpenError as e:
            self.step_back(acquired, "circuit_open", max(e.retry_in_s, self.cfg.min_step_back_delay_s))
        except RequestAborted:
            self.step_back(acquired, "shutdown_drain", 0.0)
        except DeadlineExceeded:
            # the lease budget died (expired lease, retry bound, or the
            # helper's conclusive 408): step back, refund the attempt
            self.step_back(acquired, "deadline_expired", 0.0)
        except Exception as e:
            if is_datastore_connection_error(self.ds, e):
                self.step_back(acquired, "datastore_down", datastore_reconnect_delay_s(self.ds))
                return
            raise

    def step_back(self, acquired: AcquiredCollectionJob, reason: str, delay_s: float) -> None:
        """See AggregationJobDriver.step_back: early lease release with a
        reacquire delay, attempt refunded."""
        metrics.job_step_back_total.add(reason=reason, **metrics.replica_labels())
        delay = max(0, int(delay_s))
        log.warning(
            "stepping back collection job %s (%s): lease released, reacquirable in %ds",
            acquired.collection_job_id, reason, delay,
        )
        # a shutdown drain is a clean hand-back to the rest of the fleet
        handback = reason == "shutdown_drain"
        try:
            self.ds.run_tx(
                lambda tx: tx.step_back_collection_job(
                    acquired, reacquire_delay_s=delay, count_attempt=False, handback=handback
                ),
                "step_back_collection_job",
            )
        except LeaseConflict:
            log.info("step-back of %s found the lease already gone", acquired.collection_job_id)
        except Exception:
            log.warning(
                "step-back of %s could not reach the datastore; lease will age out",
                acquired.collection_job_id,
            )

    def step_collection_job(self, acquired: AcquiredCollectionJob) -> None:
        """reference step_collection_job_generic :108-300."""

        def read(tx):
            task = tx.get_task(acquired.task_id)
            job = tx.get_collection_job(acquired.task_id, acquired.collection_job_id)
            return task, job

        task, job = self.ds.run_tx(read, "step_collection_read")
        if task is None or job is None:
            raise RuntimeError("collection job vanished while leased")
        if job.state not in (CollectionJobState.START, CollectionJobState.COLLECTABLE):
            self.ds.run_tx(lambda tx: tx.release_collection_job(acquired), "release")
            return
        # adopt the trace the collection-create handler persisted: the
        # driver's spans, and the helper's aggregate-share handler through
        # the propagated traceparent, join the collector's trace. The
        # lease budget bounds the step, and the HTTP client stamps its
        # remainder on the helper request
        with use_traceparent(job.trace_context), deadline_scope(self._lease_deadline(acquired)):
            self._step_leased_job(acquired, task, job)

    def _step_leased_job(self, acquired: AcquiredCollectionJob, task: Task, job) -> None:
        seconds = {}
        t = time.perf_counter()

        def lap(name: str) -> None:
            nonlocal t
            now = time.perf_counter()
            seconds[name] = now - t
            t = now

        if task.vdaf.has_aggregation_parameter:
            # aggregation happens per collection parameter: create its
            # aggregation jobs on the first step, and wait for them to
            # finish before computing the aggregate share
            pop = Poplar1Ops(task.vdaf.bits)
            field = pop.field_for(pop.decode_param(job.aggregation_parameter))
            ready = self._ensure_param_aggregation(task, job)
            lap("ensure_param_aggregation")
            if not ready:
                self.ds.run_tx(lambda tx: tx.release_collection_job(acquired), "release")
                self.step_seconds.append((acquired.collection_job_id.data, seconds))
                return
        else:
            field = circuit_for(task.vdaf).FIELD
        query = Query.from_bytes(job.query)

        # tx1: gather the shard rows (reference :160-199), and the covered
        # aggregation jobs' persisted trace contexts: the collection
        # span's links
        def gather(tx):
            if query.query_type == TimeInterval.CODE:
                interval = Interval.from_bytes(job.batch_identifier)
                rows = tx.get_batch_aggregations_intersecting_interval(
                    task.task_id, interval, aggregation_parameter=job.aggregation_parameter
                )
                links = tx.get_aggregation_job_trace_contexts(task.task_id, interval=interval)
            else:
                rows = tx.get_batch_aggregations_for_batch(
                    task.task_id, job.batch_identifier, job.aggregation_parameter
                )
                links = tx.get_aggregation_job_trace_contexts(
                    task.task_id,
                    partial_batch_identifier=PartialBatchSelector.fixed_size(BatchId(job.batch_identifier)).to_bytes(),
                )
            return rows, links

        rows, links = self.ds.run_tx(gather, "step_collection_gather")
        lap("gather")
        share = None
        total = 0
        checksum = ReportIdChecksum()
        interval = None
        for row in rows:
            share = add_encoded_aggregate_shares(field, share, row.aggregate_share)
            total += row.report_count
            checksum = checksum.combined_with(row.checksum)
            interval = (
                row.client_timestamp_interval
                if interval is None
                else Interval.merged(interval, row.client_timestamp_interval)
            )
        lap("sum")

        if share is None or total < task.min_batch_size:
            # not enough reports yet: release and try again later
            self.ds.run_tx(lambda tx: tx.release_collection_job(acquired), "release")
            return

        # DP: noise the leader's own share before release. The noised
        # share is persisted per (batch, agg param) and reused by later
        # collection jobs over the same batch: fresh noise per query
        # would let a collector average it away (max_batch_query_count>1).
        if task.dp_strategy.enabled:
            existing = self.ds.run_tx(
                lambda tx: tx.get_aggregate_share_job(task.task_id, job.batch_identifier, job.aggregation_parameter),
                "leader_noised_share_lookup",
            )
            if existing is not None:
                share = existing.helper_aggregate_share
            else:
                share = add_noise_to_agg_share(task.dp_strategy, field, share)
                noised = AggregateShareJob(
                    task.task_id, job.batch_identifier, job.aggregation_parameter, share, total, checksum
                )
                self.ds.run_tx(lambda tx: tx.put_aggregate_share_job(noised), "leader_noised_share_store")
            lap("dp_noise")

        if query.query_type == TimeInterval.CODE:
            batch_selector = BatchSelector.time_interval(Interval.from_bytes(job.batch_identifier))
        else:
            batch_selector = BatchSelector.fixed_size(BatchId(job.batch_identifier))
        req = AggregateShareReq(batch_selector, job.aggregation_parameter, total, checksum)
        with span("driver.http_aggregate_share", reports=total):
            helper_share = self._send_aggregate_share_request(task, req, deadline=self._lease_deadline(acquired))
        lap("http_aggregate_share")

        def mark_and_store(tx):
            for row in rows:
                tx.mark_batch_aggregations_collected(task.task_id, row.batch_identifier, row.aggregation_parameter)
            # the conservation ledger: only rows still uncollected at
            # gather time book `collected` (a re-query adds nothing)
            ledger.count_collected(tx, task.task_id, rows)
            tx.update_collection_job(
                dataclasses.replace(
                    job,
                    state=CollectionJobState.FINISHED,
                    report_count=total,
                    client_timestamp_interval=interval,
                    leader_aggregate_share=share,
                    helper_encrypted_aggregate_share=helper_share.encrypted_aggregate_share.to_bytes(),
                )
            )
            tx.release_collection_job(acquired)

        # the finishing span links the aggregation jobs that filled the
        # batch: their persisted trace ids ride as an attribute (capped,
        # and the overflow shows)
        link_ids = sorted({t for t in (trace_id_of(h) for h in links) if t})
        with span("driver.collect_finish", reports=total, linked_traces=",".join(link_ids[:32]),
                  linked_truncated=len(link_ids) > 32):
            self.ds.run_tx(mark_and_store, "step_collection_store")
        lap("store")
        # the collect-stage e2e histogram, outside the transaction: batch
        # close (the batch interval's end; a fixed-size batch: the newest
        # report's window) to aggregate share released
        if query.query_type == TimeInterval.CODE:
            batch_close = Interval.from_bytes(job.batch_identifier).end.seconds
        else:
            batch_close = interval.end.seconds
        metrics.report_e2e_seconds.observe(float(max(0, self.ds.clock.now().seconds - batch_close)), stage="collect")
        # cross-aggregator reconciliation, after the books closed here
        self._reconcile_with_helper(task, rows)
        self.step_seconds.append((acquired.collection_job_id.data, seconds))

    def _reconcile_with_helper(self, task: Task, rows) -> None:
        """Fetch the helper's aggregated report counts (the authenticated
        GET /tasks/{id}/ledger) and compare them with the batches this
        collection covered, keyed "<batch hex>:<aggregation parameter
        hex>" on both sides. The divergence goes to the installed ledger
        evaluator (janus_ledger_peer_divergence, the peer breach track).
        Best-effort: the collection is released already."""
        ev = ledger.installed_ledger()
        if ev is None or not ev.cfg.reconcile_peer:
            return
        ours: dict[str, int] = {}
        for row in rows:
            key = f"{row.batch_identifier.hex()}:{row.aggregation_parameter.hex()}"
            ours[key] = ours.get(key, 0) + int(row.report_count)
        if not ours:
            return
        try:
            theirs = self._fetch_helper_ledger(task)
        except Exception:
            # an unreachable endpoint never fails a finished collection;
            # the divergence gauge keeps its last value
            log.warning("peer ledger reconciliation fetch failed for task %s", task.task_id, exc_info=True)
            return
        divergence = ev.record_peer_divergence(task.task_id, ours, theirs)
        if divergence:
            log.error(
                "cross-aggregator ledger divergence for task %s: %d report(s) differ between our batch "
                "aggregations and the helper's", task.task_id, divergence,
            )

    def _fetch_helper_ledger(self, task: Task) -> dict[str, int]:
        url = (
            task.helper_aggregator_endpoint.rstrip("/")
            + f"/tasks/{base64.urlsafe_b64encode(task.task_id.data).decode().rstrip('=')}/ledger"
        )
        headers = {}
        if task.aggregator_auth_token:
            headers.update(task.aggregator_auth_token.request_headers())
        status, body = self.http.get(url, headers, timeout=30.0)
        if status != 200:
            raise RuntimeError(f"helper ledger endpoint returned HTTP {status}")
        doc = json.loads(body.decode("utf-8"))
        return {str(k): int(v) for k, v in (doc.get("batch_counts") or {}).items()}

    def _ensure_param_aggregation(self, task: Task, job) -> bool:
        """Create aggregation jobs for the collection's parameter over the
        reports in the batch interval that have none under it; True when
        aggregation under the parameter is complete and the aggregate
        share can be computed. At most 512 reports a job."""
        interval = Interval.from_bytes(job.batch_identifier)
        param = job.aggregation_parameter

        def create(tx):
            in_interval = tx.get_client_report_ids_in_interval(task.task_id, interval)
            done = tx.get_aggregated_report_ids_for_param(task.task_id, [rid for rid, _ in in_interval], param)
            todo = [(rid, t) for rid, t in in_interval if rid.data not in done]
            for lo in range(0, len(todo), 512):
                chunk = todo[lo : lo + 512]
                job_id = AggregationJobId(secrets.token_bytes(16))
                times = [t.seconds for _, t in chunk]
                tx.put_aggregation_job(
                    AggregationJobModel(
                        task.task_id,
                        job_id,
                        param,
                        PartialBatchSelector.time_interval().to_bytes(),
                        Interval(Time(min(times)), Duration(max(times) - min(times) + 1)),
                        AggregationJobState.IN_PROGRESS,
                        0,
                        None,
                        # spawned by the collection: they join its trace
                        trace_context=current_traceparent(),
                    )
                )
                for ord_, (rid, t) in enumerate(chunk):
                    tx.put_report_aggregation(
                        ReportAggregationModel(
                            task.task_id, job_id, rid, t, ord_, ReportAggregationState.START, b"", None
                        )
                    )
            # the conservation ledger's param lane: creating the (report,
            # parameter) rows is its admission, exactly once per pair
            ledger.count_admitted(tx, task.task_id, len(todo), aggregation_parameter=param)
            if todo:
                return False  # fresh jobs: not ready this pass
            # ready once no job for this parameter is still in progress
            return tx.count_active_aggregation_jobs_for_param(task.task_id, param) == 0

        return self.ds.run_tx(create, "ensure_param_aggregation")

    def _lease_deadline(self, acquired) -> float:
        return lease_deadline(self.ds.clock, acquired.lease, self.cfg.worker_lease_clock_skew_s)

    def _send_aggregate_share_request(
        self, task: Task, req: AggregateShareReq, deadline: float | None = None
    ) -> AggregateShare:
        url = (
            task.helper_aggregator_endpoint.rstrip("/")
            + f"/tasks/{base64.urlsafe_b64encode(task.task_id.data).decode().rstrip('=')}/aggregate_shares"
        )
        headers = {"Content-Type": AggregateShareReq.MEDIA_TYPE}
        if task.aggregator_auth_token:
            headers.update(task.aggregator_auth_token.request_headers())
        peer = peer_label(task.helper_aggregator_endpoint)
        if self.peer_health is not None:
            # register before any attempt (see aggregation_job_driver.py)
            self.peer_health.observe_endpoint(task.helper_aggregator_endpoint)

        def attempt():
            # circuit gate per attempt; see AggregationJobDriver
            self.breakers.check(peer)
            try:
                status, body = self.http.post(
                    url, req.to_bytes(), headers, timeout=deadline_request_timeout(deadline)
                )
            except BaseException:
                self.breakers.record_failure(peer)
                raise
            if 500 <= status < 600:
                self.breakers.record_failure(peer)
            else:
                self.breakers.record_success(peer)
            # trailing headers element: a shedding helper's Retry-After
            # paces the retry loop
            return status, body, getattr(self.http, "last_response_headers", {})

        status, body = retry_http_request(
            attempt,
            self.cfg.http_backoff,
            deadline=deadline,
            should_abort=(lambda: self.stopper.stopped) if self.stopper is not None else None,
        )
        if status == DEADLINE_EXCEEDED_STATUS:
            raise DeadlineExceeded("helper reported deadline exceeded", last_status=status)
        if status != 200:
            raise RuntimeError(f"helper aggregate share failed: HTTP {status}: {body[:300]!r}")
        return AggregateShare.from_bytes(body)

    def abandon_job(self, acquired: AcquiredCollectionJob) -> None:
        def cancel(tx):
            job = tx.get_collection_job(acquired.task_id, acquired.collection_job_id)
            if job is None:
                return
            tx.update_collection_job(dataclasses.replace(job, state=CollectionJobState.ABANDONED))
            tx.release_collection_job(acquired)

        self.ds.run_tx(cancel, "abandon_collection_job")
        metrics.job_cancel_counter.add(kind="collection")
        log.warning("abandoned collection job %s", acquired.collection_job_id)
