"""The stage-pipelined leader stepper.

The port's counterpart of janus_tpu/aggregator/step_pipeline.py. The
serial stepper runs a leased job as one chain on one worker thread (read
transaction, host staging, device init, helper round trip, device
accumulate, write transaction), so the card idles behind the datastore
and the helper. Here the step is a pipeline of stages, each on its own
bounded executor:

    read    (prefetch_depth workers): read transaction and columnar
            staging; job k+1 stages while job k holds the card, and with
            double_buffer its padded columns go up to the card now, from
            pinned memory on a side stream (EngineCache.prestage_leader)
    device  (the device lane, device_lane_workers threads): every device
            dispatch, the leader init and the accumulate; with more than
            one worker, concurrent inits meet in the engine's coalescer
    http    (http_inflight workers): framing, the helper round trip,
            response decode and host verification
    commit  (commit_inflight workers): the write transaction and the
            lease release (and, in resident mode, the post-commit merge)

Steps off the Prio3 init path (a continue step, Poplar1's init, an empty
job) run their serial body as one "classic" stage.

Invariants: a job is in exactly one stage at a time (the next stage is
enqueued only after the previous returned); the lease budget is checked
again at every hand-off (`deadline.check`); a stage failure maps through
the driver's `handle_step_error`, as the serial stepper's does; on
shutdown (the stopper set) a failing step's lease goes back through the
releaser at once. At most prefetch_depth jobs hold staged columns the
card has not consumed (the staging window).

janus_tpu's metrics are fed (stage seconds, queue depths, the device
lane's busy seconds and ratio, overlap events, `job.step` through
trace.record_operation), and `status()`, the statusz `step_pipeline`
section, returns the same counts: stage seconds (the recent window, per
stage), queue depths, the device lane's busy time and concurrency peak,
overlap events, the prestages declined, and the classic fallbacks (the
driver's resident-route fallbacks and the prestages that failed for
memory). Every stage runs under the job's persisted trace context
(`use_traceparent` of the row's `trace_context`, read at the read
stage), so a stage's spans on any lane thread join the job's trace. The port's failure rule narrows two
janus_tpu fallbacks: a prestage that fails for anything but memory
exhaustion fails the step (janus_tpu stages from the host after any
error), and so does a resident accumulate (aggregation_job_driver.py).
A dispatch the watchdog abandoned (DeviceHangError) or a quarantined
engine refused (DeviceQuarantinedError, a prestage's included) fails its
stage like any error, and `handle_step_error` maps it to the step-backs
`device_hang` and `device_quarantined`, as the serial stepper's does; the
step-back transaction never runs on the device lane.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass

from .. import metrics
from ..core import deadline as deadline_mod
from ..datastore.models import AggregationJobState
from ..statusz import register_status_provider, unregister_status_provider
from ..trace import record_operation, use_traceparent
from .engine_cache import is_oom_error

log = logging.getLogger(__name__)

STAGE_READ = "read"
STAGE_DEVICE = "device"
STAGE_HTTP = "http"
STAGE_COMMIT = "commit"
STAGE_CLASSIC = "classic"  # the label of a non-pipelined step body
STAGES = (STAGE_READ, STAGE_DEVICE, STAGE_HTTP, STAGE_COMMIT)


@dataclass
class StepPipelineConfig:
    """The aggregation job driver's `step_pipeline:` settings."""

    # the binary builds the pipeline only where enabled (else it steps
    # serially)
    enabled: bool = True
    # jobs reading and staging ahead of the device lane (each holds its
    # staged columns until the card consumed them)
    prefetch_depth: int = 2
    # concurrent helper round trips
    http_inflight: int = 2
    # concurrent write transactions
    commit_inflight: int = 2
    # device-lane width: 1 serializes every dispatch; more lets small
    # jobs' inits meet in the engine's coalescer
    device_lane_workers: int = 1
    # the read stage uploads a job's padded columns while the lane runs
    # the previous job
    double_buffer: bool = True

    @classmethod
    def from_dict(cls, d: dict | None) -> "StepPipelineConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", True)),
            prefetch_depth=max(1, int(d.get("prefetch_depth", 2))),
            http_inflight=max(1, int(d.get("http_inflight", 2))),
            commit_inflight=max(1, int(d.get("commit_inflight", 2))),
            device_lane_workers=max(1, int(d.get("device_lane_workers", 1))),
            double_buffer=bool(d.get("double_buffer", True)),
        )


class DeviceLane:
    """The owner of device dispatches: a bounded executor whose busy time
    is accounted (the busy ratio over a rolling window) and whose
    concurrency peak is kept, so a test can hold the serialization."""

    # the ratio reads the last WINDOW..2*WINDOW seconds, not the lifetime
    RATIO_WINDOW_S = 60.0

    def __init__(self, workers: int = 1):
        self.workers = workers
        self._pool = ThreadPoolExecutor(workers, thread_name_prefix="device-lane")
        self._lock = threading.Lock()
        t0 = time.monotonic()
        self.busy_s = 0.0
        self.dispatches = 0
        self.concurrent = 0
        self.concurrent_peak = 0
        self._prev_t, self._prev_busy = t0, 0.0
        self._snap_t, self._snap_busy = t0, 0.0
        # the ratio gauge must decay while the lane idles: a low-cadence
        # refresher keeps it honest between dispatches
        self._stop = threading.Event()
        self._refresher = threading.Thread(target=self._refresh_loop, name="device-lane-gauge", daemon=True)
        self._refresher.start()

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.RATIO_WINDOW_S / 4):
            metrics.device_lane_busy_ratio.set(self.busy_ratio())

    def submit(self, fn, *args) -> Future:
        return self._pool.submit(self._run, fn, *args)

    def _run(self, fn, *args):
        with self._lock:
            self.concurrent += 1
            self.concurrent_peak = max(self.concurrent_peak, self.concurrent)
        t0 = time.monotonic()
        try:
            return fn(*args)
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self.concurrent -= 1
                self.busy_s += dt
                self.dispatches += 1
            metrics.device_lane_busy_seconds.add(dt)
            metrics.device_lane_busy_ratio.set(self.busy_ratio())

    def busy_ratio(self) -> float:
        now = time.monotonic()
        with self._lock:
            if now - self._snap_t >= self.RATIO_WINDOW_S:
                self._prev_t, self._prev_busy = self._snap_t, self._snap_busy
                self._snap_t, self._snap_busy = now, self.busy_s
            base_t, base_busy = self._prev_t, self._prev_busy
            busy = self.busy_s
        wall = now - base_t
        if wall <= 0:
            return 0.0
        return min(1.0, (busy - base_busy) / (wall * self.workers))

    def close(self, wait: bool = True) -> None:
        self._stop.set()
        self._pool.shutdown(wait=wait)


class _PipelinedStep:
    """One leased job moving through the stage chain."""

    __slots__ = ("acquired", "outer", "trace_context", "deadline", "state", "classic", "t_submit", "error",
                 "staging_permit")

    def __init__(self, acquired, outer: Future):
        self.acquired = acquired
        self.outer = outer
        self.trace_context = None  # the creator's persisted trace, set at read
        self.deadline = None  # the lease budget, set at read
        self.state = None  # InitStepState on the hot path
        self.classic = None  # zero-arg step body of a non-pipelined kind
        self.t_submit = time.monotonic()
        self.error = None
        self.staging_permit = False  # holding a slot of the staging window


class StepPipeline:
    """Schedules AggregationJobDriver's stage methods across bounded
    stage executors. submit(acquired) returns a Future that resolves when
    the job's step has completed (committed, stepped back, or failed and
    logged): JobDriver treats it as a serial step's future."""

    # stage and job seconds kept for status() (a recent window)
    SAMPLES = 4096

    def __init__(self, driver, cfg: StepPipelineConfig | None = None, stopper=None, releaser=None):
        self.driver = driver
        self.cfg = cfg or StepPipelineConfig()
        self.stopper = stopper
        self.releaser = releaser
        self.lane = DeviceLane(self.cfg.device_lane_workers)
        self._pools = {
            STAGE_READ: ThreadPoolExecutor(self.cfg.prefetch_depth, thread_name_prefix="step-read"),
            STAGE_HTTP: ThreadPoolExecutor(self.cfg.http_inflight, thread_name_prefix="step-http"),
            STAGE_COMMIT: ThreadPoolExecutor(self.cfg.commit_inflight, thread_name_prefix="step-commit"),
        }
        self._lock = threading.Lock()
        self._http_inflight = 0
        self._queued = {stage: 0 for stage in STAGES}
        self._jobs_done = 0
        # overlap: device dispatches that started while a helper round
        # trip was in flight (the overlap ratio's numerator), and round
        # trips that started while the lane was busy
        self._overlap_device = 0
        self._overlap_http = 0
        # prestages the read stage declined (a parallel lane, a job that
        # would coalesce) and those that failed for memory (the step
        # then staged from the host)
        self._prestage_declined = 0
        self._prestage_oom = 0
        self.stage_seconds: dict[str, deque] = {}
        self.job_seconds: deque = deque(maxlen=self.SAMPLES)
        self._closed = False
        # the staged-memory bound: at most prefetch_depth jobs hold staged
        # columns the card has not consumed yet
        self._staging_window = threading.Semaphore(self.cfg.prefetch_depth)
        # the exact registered object: close()'s guarded unregister is an
        # identity check
        self._status_provider = self.status
        register_status_provider("step_pipeline", self._status_provider)

    # --- submission ---
    def submit(self, acquired) -> Future:
        outer: Future = Future()
        job = _PipelinedStep(acquired, outer)
        self._enqueue(STAGE_READ, self._stage_read, job)
        return outer

    def _enqueue(self, stage: str, fn, job: _PipelinedStep, label: str | None = None) -> None:
        with self._lock:
            self._queued[stage] += 1
            metrics.step_pipeline_queue_depth.set(self._queued[stage], stage=stage)
        try:
            if stage == STAGE_DEVICE:
                self.lane.submit(self._run_stage, stage, fn, job, label)
            else:
                self._pools[stage].submit(self._run_stage, stage, fn, job, label)
        except RuntimeError as e:
            # a pool shut down mid-chain: surface it, never strand the lease
            with self._lock:
                self._queued[stage] -= 1
                metrics.step_pipeline_queue_depth.set(self._queued[stage], stage=stage)
            self._fail(job, e)

    # --- stage execution ---
    def _run_stage(self, stage: str, fn, job: _PipelinedStep, label: str | None) -> None:
        # only the real helper round trip counts as an HTTP leg in flight
        is_http = stage == STAGE_HTTP and label is None
        with self._lock:
            self._queued[stage] -= 1
            metrics.step_pipeline_queue_depth.set(self._queued[stage], stage=stage)
            direction = None
            if is_http:
                self._http_inflight += 1
                if self.lane.concurrent > 0:
                    direction = "http_start"
                    self._overlap_http += 1
            elif stage == STAGE_DEVICE and self._http_inflight > 0:
                direction = "device_start"
                self._overlap_device += 1
            if direction is not None:
                metrics.step_pipeline_overlap_total.add(direction=direction)
        t0 = time.monotonic()
        err: BaseException | None = None
        nxt = None
        try:
            # re-enter the job's trace and lease budget on this thread
            # (contextvars do not cross threads) and check the budget
            # before any stage work: a job whose lease died in a queue
            # steps back here
            with use_traceparent(job.trace_context), deadline_mod.deadline_scope(job.deadline):
                deadline_mod.check(f"step_pipeline_{stage}")
                nxt = fn(job)
        except BaseException as e:  # noqa: BLE001 - mapped to a step-back or a failure below
            err = e
        finally:
            # drop the in-flight mark before the next stage is enqueued
            if is_http:
                with self._lock:
                    self._http_inflight -= 1
        self._observe_stage(label or stage, time.monotonic() - t0)
        if err is not None:
            if stage == STAGE_DEVICE:
                # never run the step-back transaction on the device lane:
                # a slow datastore would park every queued dispatch
                try:
                    self._pools[STAGE_COMMIT].submit(self._fail, job, err)
                    return
                except RuntimeError:
                    pass  # commit pool already shut down: handle inline
            self._fail(job, err)
        elif nxt is None:
            self._finish(job)
        else:
            nstage, nfn, nlabel = nxt if len(nxt) == 3 else (*nxt, None)
            self._enqueue(nstage, nfn, job, nlabel)

    def _observe_stage(self, stage: str, dur_s: float) -> None:
        metrics.step_pipeline_stage_seconds.observe(dur_s, stage=stage)
        with self._lock:
            q = self.stage_seconds.get(stage)
            if q is None:
                q = self.stage_seconds[stage] = deque(maxlen=self.SAMPLES)
            q.append(dur_s)

    def _finish(self, job: _PipelinedStep) -> None:
        self._release_staging(job)  # a no-op unless the chain died staged
        job_s = time.monotonic() - job.t_submit
        with self._lock:
            self._jobs_done += 1
            self.job_seconds.append(job_s)
        args = {"job": type(job.acquired).__name__, "pipelined": True}
        if job.error is not None:
            args["error"] = job.error
        record_operation("job.step", job_s, **args)
        job.outer.set_result(None)

    def _fail(self, job: _PipelinedStep, e: BaseException) -> None:
        """Map a stage failure to the serial stepper's semantics
        (AggregationJobDriver.stepper and JobDriver._step_one)."""
        job.error = type(e).__name__
        try:
            if isinstance(e, Exception) and self.driver.handle_step_error(job.acquired, e):
                self._finish(job)
                return
        except Exception:
            log.exception("step-back handling itself failed for job %s", job.acquired.job_id)
            self._finish(job)
            return
        if self.stopper is not None and self.stopper.stopped and self.releaser is not None:
            # shutdown drain: this process will not retry; release the
            # lease now so a surviving peer takes the job at once
            log.error("pipelined job step failed during shutdown; releasing lease", exc_info=e)
            try:
                self.releaser(job.acquired)
            except Exception:
                log.exception("shutdown lease release failed")
        else:
            log.error(
                "pipelined job %s step failed (attempt %d; lease will expire and retry)",
                job.acquired.job_id, job.acquired.lease.attempts, exc_info=e,
            )
        self._finish(job)

    # --- the stage bodies ---
    def _stage_read(self, job: _PipelinedStep):
        driver = self.driver
        acquired = job.acquired
        if acquired.lease.attempts > driver.cfg.maximum_attempts_before_failure:
            driver.abandon_job(acquired)
            return None
        task, jobrow, ras, reports = driver.read_job(acquired)
        if jobrow is None or task is None:
            raise RuntimeError("job or task vanished while leased")
        if jobrow.state != AggregationJobState.IN_PROGRESS:
            driver.release_job(acquired)
            return None
        # the persisted creator trace and the lease budget hold for every
        # later stage, and for the rest of this one
        job.trace_context = jobrow.trace_context
        job.deadline = driver._lease_deadline(acquired)
        with use_traceparent(job.trace_context), deadline_mod.deadline_scope(job.deadline):
            kind, rows = driver.plan_step(acquired, task, jobrow, ras)
            if kind == "continue":
                job.classic = lambda: driver._continue_step(acquired, task, jobrow, rows, {})
                return (STAGE_HTTP, self._stage_classic, STAGE_CLASSIC)
            if kind == "poplar1":
                job.classic = lambda: driver._step_poplar1_init(acquired, task, jobrow, rows, reports, {})
                return (STAGE_HTTP, self._stage_classic, STAGE_CLASSIC)
            if kind == "empty":
                job.classic = lambda: driver.finish_empty(acquired, jobrow)
                return (STAGE_COMMIT, self._stage_classic, STAGE_CLASSIC)
            # blocks this read worker while prefetch_depth jobs hold
            # staged columns the card has not consumed
            self._staging_window.acquire()
            job.staging_permit = True
            st = driver.stage_init(acquired, task, jobrow, rows, reports)
            job.state = st
            if self.cfg.double_buffer:
                self._prestage(st)
            return (STAGE_DEVICE, self._stage_device_init)

    def _prestage(self, st) -> None:
        """Upload the job's padded columns now, on this read thread, so
        the copies overlap whatever dispatch holds the lane. A parallel
        lane declines jobs that would coalesce: a merged round discards
        its entries' prestages and stages from the host, so the copies
        would be paid twice. A prestage that runs out of memory leaves
        the step to stage from the host; any other failure fails it."""
        eng = st.engine
        if self.cfg.device_lane_workers > 1 and eng.would_coalesce(st.nonce_lanes.shape[0]):
            with self._lock:
                self._prestage_declined += 1
            return
        try:
            st.prestaged = eng.prestage_leader(st.nonce_lanes, st.public_parts, st.meas, st.proof, st.blind_lanes)
        except Exception as e:
            if not is_oom_error(e):
                raise
            log.warning("prestage ran out of device memory for job %s; device_init stages from the host",
                        st.acquired.job_id, exc_info=True)
            with self._lock:
                self._prestage_oom += 1
            st.prestaged = None

    def _release_staging(self, job: _PipelinedStep) -> None:
        if job.staging_permit:
            job.staging_permit = False
            self._staging_window.release()

    def _stage_classic(self, job: _PipelinedStep):
        job.classic()
        return None

    def _stage_device_init(self, job: _PipelinedStep):
        try:
            self.driver.device_init(job.state)
        finally:
            # the card consumed the staged columns (leader_init's copies
            # complete before it returns): free the host arrays and any
            # unconsumed prestage, and open the staging window
            st = job.state
            st.meas = st.proof = st.blind_lanes = st.public_parts = None
            st.nonce_lanes = None
            if st.prestaged is not None:
                st.prestaged.discard()
                st.prestaged = None
            self._release_staging(job)
        return (STAGE_HTTP, self._stage_http_init)

    def _stage_http_init(self, job: _PipelinedStep):
        self.driver.http_init(job.state)
        if job.state.multi_round:
            return (STAGE_COMMIT, self._stage_commit_park)
        return (STAGE_DEVICE, self._stage_device_accumulate)

    def _stage_device_accumulate(self, job: _PipelinedStep):
        self.driver.device_accumulate(job.state)
        return (STAGE_COMMIT, self._stage_commit_finish)

    def _stage_commit_park(self, job: _PipelinedStep):
        self.driver.commit_park(job.state)
        return None

    def _stage_commit_finish(self, job: _PipelinedStep):
        self.driver.commit_finish(job.state)
        return None

    # --- lifecycle, introspection ---
    def status(self) -> dict:
        with self._lock:
            queued = dict(self._queued)
            jobs_done = self._jobs_done
            overlap_device = self._overlap_device
            overlap_http = self._overlap_http
            http_inflight = self._http_inflight
            declined = self._prestage_declined
            prestage_oom = self._prestage_oom
        lane = self.lane
        return {
            "jobs_done": jobs_done,
            "queued": queued,
            "http_inflight": http_inflight,
            "device_lane": {
                "workers": lane.workers,
                "dispatches": lane.dispatches,
                "busy_s": lane.busy_s,
                "busy_ratio": lane.busy_ratio(),
                "concurrent_peak": lane.concurrent_peak,
            },
            # the share of device dispatches that started while a helper
            # round trip was in flight; overlap_events adds the reverse
            "overlapped_dispatches": overlap_device,
            "overlap_events": overlap_device + overlap_http,
            "overlap_ratio": min(1.0, overlap_device / lane.dispatches) if lane.dispatches else 0.0,
            "prestage": {"declined": declined, "oom_fallbacks": prestage_oom},
            "classic_fallbacks": self.driver.classic_fallbacks + prestage_oom,
            "config": {
                "prefetch_depth": self.cfg.prefetch_depth,
                "http_inflight": self.cfg.http_inflight,
                "commit_inflight": self.cfg.commit_inflight,
                "device_lane_workers": self.cfg.device_lane_workers,
                "double_buffer": self.cfg.double_buffer,
            },
        }

    def close(self, wait: bool = True) -> None:
        """Shut the stage executors down. Callers drain in-flight chains
        first (JobDriver.run waits on the outer futures), so this only
        retires idle workers."""
        if self._closed:
            return
        self._closed = True
        unregister_status_provider("step_pipeline", self._status_provider)
        for pool in self._pools.values():
            pool.shutdown(wait=wait)
        self.lane.close(wait=wait)
