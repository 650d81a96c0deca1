"""Staged, bounded upload ingest pipeline with window-batched crypto.

The port's own copy of janus_tpu/ingest/pipeline.py. Fixed-size stages
connected by bounded queues replace decode + HPKE open + validate +
write on the request thread:

    handler thread ──submit──▶ [decode q] ─▶ decode worker(s)
        (drains a flush window of raw bodies, parses them columnar via
         decode_reports_fast, runs the cheap time/keypair checks per
         lane; one malformed upload rejects its own lane, never its
         window)
                              ─▶ [decrypt q] ─▶ decrypt pool
        (whole windows: lanes grouped by (task, HPKE config) run one
         hpke_open_batch and one numpy range-validation pass)
                              ─▶ ReportWriteBatcher group commit
        (one datastore transaction per accumulated batch; the batch's
         flush resolves every ticket it carried)

The handler thread parks on an `UploadTicket` until its report's batch
commits, so an answer of 201 means durably written, a replay is still
201, and a stage error maps to the same problem document as janus_tpu's.
In-flight uploads are bounded by `queue_depth`; the bound sheds
ShedError (429 + Retry-After at the HTTP layer).

`batch_window` bounds how many uploads one decode pass drains;
`batch_linger_ms` is how long a decode worker waits for the window to
fill once it holds at least one upload. A window of 1 runs each report
alone through the same stages. `stage_seconds` sums the wall seconds of
the decode and decrypt windows (per stage, over all workers).

The stage failpoints fire per lane, as in janus_tpu's windowed stages:
`ingest.decode` before the lane's parse verdict (an armed error wins over
a malformed body) and `ingest.decrypt` before the lane's HPKE open (a
fired lane is rejected without crypto); each rejects its own lane only.

Not ported: janus_tpu's per-report stage loops (`batch_window=1` there;
here a window of 1 runs the windowed stages, failpoints included) and
its oracle loops for task doubles without the column surface (every port
TaskAggregator has it), and the metrics and trace spans of each stage.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time

from .. import failpoints
from ..core import hpke_backend
from ..messages import decode_reports_fast
from .admission import ShedError

log = logging.getLogger(__name__)

_STOP = object()


def default_decrypt_workers(batched: bool = True) -> int:
    """Decrypt-pool size when the config leaves it 0: one worker per
    host core (floor 2) with a backend whose batch HPKE open releases
    the GIL; 2 on the GIL-holding libcrypto fallback, where crypto from
    more workers serializes anyway and the second worker overlaps the
    numpy validation and the commit bookkeeping with the next window."""
    cores = max(2, os.cpu_count() or 2)
    if batched and not hpke_backend.BATCH_RELEASES_GIL:
        return min(2, cores)
    return cores


class UploadTicket:
    """One admitted upload's journey through the pipeline."""

    __slots__ = ("ta", "clock", "body", "keypair", "event", "fresh", "error")

    def __init__(self, ta, clock, body: bytes):
        self.ta = ta
        self.clock = clock
        self.body = body
        self.keypair = None
        self.event = threading.Event()
        self.fresh: bool | None = None
        self.error: BaseException | None = None

    def result(self, timeout_s: float = 30.0) -> bool:
        """Block until committed; returns False on replay, raises the
        stage error otherwise (the handler maps it to a problem doc)."""
        if not self.event.wait(timeout_s):
            raise TimeoutError("upload did not commit in time")
        if self.error is not None:
            raise self.error
        assert self.fresh is not None
        return self.fresh


class _DecryptWindow:
    """One decoded window headed for the decrypt stage: the shared
    ReportColumn plus the surviving (ticket, lane index) pairs."""

    __slots__ = ("col", "lanes")

    def __init__(self, col, lanes):
        self.col = col
        self.lanes = lanes  # list[(UploadTicket, int)]


class IngestPipeline:
    """Bounded staged ingest; see the module docstring.

    `writer` is the aggregator's ReportWriteBatcher (group commit).
    Threads start lazily on the first submit and are daemons; `close()`
    drains them for an orderly shutdown."""

    def __init__(
        self,
        writer,
        decrypt_workers: int = 0,
        decode_workers: int = 1,
        # default matches Config.ingest_queue_depth; must stay below the
        # HTTP handler-pool bound to be reachable
        queue_depth: int = 24,
        batch_window: int = 32,
        batch_linger_ms: float = 2.0,
    ):
        self.writer = writer
        self.batch_window = max(1, batch_window)
        self.batch_linger_s = max(0.0, batch_linger_ms) / 1000.0
        self.decrypt_workers = decrypt_workers or default_decrypt_workers(self.batch_window > 1)
        self.decode_workers = max(1, decode_workers)
        self.queue_depth = max(1, queue_depth)
        self.stage_seconds: dict[str, float] = {"decode": 0.0, "decrypt": 0.0}
        # queues sized to the in-flight bound so intra-pipeline puts never
        # block; the bound itself is enforced on _inflight
        self._decode_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        self._decrypt_q: queue.Queue = queue.Queue(maxsize=self.queue_depth)
        self._inflight = 0
        self._lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        self._started = False
        self._stop = False

    def depth(self) -> tuple[int, int]:
        """(uploads in flight, configured bound): the admission
        controller's queue-depth signal."""
        return self._inflight, self.queue_depth

    def submit(self, ta, clock, body: bytes) -> UploadTicket:
        """Admit one raw upload body. Raises ShedError when the in-flight
        bound is hit (the queue-full backstop behind the admission
        controller's watermark)."""
        ticket = UploadTicket(ta, clock, body)
        with self._lock:
            if self._stop:
                raise RuntimeError("ingest pipeline is closed")
            if self._inflight >= self.queue_depth:
                raise ShedError("upload", "queue_full", 1.0)
            self._inflight += 1
            if not self._started:
                self._start_locked()
            # enqueue under the lock (never blocks: queue capacity is the
            # in-flight bound), so close(), which flips _stop under this
            # lock before inserting its stop sentinels, cannot strand a
            # ticket behind a sentinel
            self._decode_q.put(ticket)
        return ticket

    def _start_locked(self) -> None:
        for i in range(self.decode_workers):
            t = threading.Thread(target=self._decode_loop, name=f"ingest-decode-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        for i in range(self.decrypt_workers):
            t = threading.Thread(target=self._decrypt_loop, name=f"ingest-decrypt-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        self._started = True

    def _add_seconds(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.stage_seconds[stage] += seconds

    def _resolve(self, ticket: UploadTicket, fresh=None, error=None) -> None:
        ticket.fresh = fresh
        ticket.error = error
        with self._lock:
            self._inflight -= 1
        ticket.event.set()

    def _submit_stored(self, ticket: UploadTicket, stored) -> None:
        """Hand one validated report to the group-commit writer; the
        flusher thread resolves the ticket when its batch lands."""

        def on_done(pending, ticket=ticket):
            if pending.error is not None:
                self._resolve(ticket, error=pending.error)
            else:
                self._resolve(ticket, fresh=pending.fresh)

        try:
            self.writer.submit_report(stored, on_done=on_done)
        except BaseException as e:
            self._resolve(ticket, error=e)

    def _drain_window(self, first: UploadTicket):
        """Collect up to batch_window tickets: whatever is queued,
        lingering batch_linger_s for stragglers. A _STOP drained
        mid-window is honored after the window (stop=True: the worker
        processes what it holds, then exits)."""
        window = [first]
        deadline = time.monotonic() + self.batch_linger_s
        while len(window) < self.batch_window:
            timeout = deadline - time.monotonic()
            try:
                t = self._decode_q.get(timeout=timeout) if timeout > 0 else self._decode_q.get_nowait()
            except queue.Empty:
                break
            if t is _STOP:
                return window, True
            window.append(t)
        return window, False

    def _decode_loop(self) -> None:
        while True:
            first = self._decode_q.get()
            if first is _STOP:
                return
            window, stop = self._drain_window(first)
            try:
                self._decode_window(window)
            except BaseException:  # never kill the worker; fail the window
                log.exception("ingest decode window failed")
                for t in window:
                    if not t.event.is_set():
                        self._resolve(t, error=RuntimeError("ingest decode stage failed"))
            if stop:
                return

    def _decode_window(self, window: list) -> None:
        t0 = time.perf_counter()
        col = decode_reports_fast([t.body for t in window])
        for t in window:
            t.body = b""  # decoded; free the raw copy

        # per lane: the failpoint, then the parse verdict; then per task
        # the cheap checks, columnar
        by_ta: dict[int, list[tuple[UploadTicket, int]]] = {}
        for i, ticket in enumerate(window):
            try:
                failpoints.hit("ingest.decode")
                if col.errors[i] is not None:
                    raise col.errors[i]
            except BaseException as e:
                self._resolve(ticket, error=e)
                continue
            by_ta.setdefault(id(ticket.ta), []).append((ticket, i))
        survivors: list[tuple[UploadTicket, int]] = []
        for lanes in by_ta.values():
            ta = lanes[0][0].ta
            results = ta.upload_prepare_columns(lanes[0][0].clock, col, [i for _, i in lanes])
            for (ticket, i), res in zip(lanes, results):
                if isinstance(res, BaseException):
                    self._resolve(ticket, error=res)
                else:
                    ticket.keypair = res
                    survivors.append((ticket, i))
        self._add_seconds("decode", time.perf_counter() - t0)
        if survivors:
            self._decrypt_q.put(_DecryptWindow(col, survivors))

    def _decrypt_loop(self) -> None:
        while True:
            item = self._decrypt_q.get()
            if item is _STOP:
                return
            try:
                self._decrypt_window(item)
            except BaseException:
                log.exception("ingest decrypt window failed")
                for ticket, _ in item.lanes:
                    if not ticket.event.is_set():
                        self._resolve(ticket, error=RuntimeError("ingest decrypt stage failed"))

    def _decrypt_window(self, item: _DecryptWindow) -> None:
        t0 = time.perf_counter()
        col = item.col
        # group by (task, HPKE config id): one batched open per group. The
        # config id comes from the decoded column, not keypair identity. A
        # lane whose failpoint fires is rejected before any crypto.
        groups: dict[tuple, list[tuple[UploadTicket, int]]] = {}
        for ticket, i in item.lanes:
            try:
                failpoints.hit("ingest.decrypt")
            except BaseException as e:
                self._resolve(ticket, error=e)
                continue
            groups.setdefault((id(ticket.ta), col.leader_config_ids[i]), []).append((ticket, i))
        for lanes in groups.values():
            ta, keypair = lanes[0][0].ta, lanes[0][0].keypair
            results = ta.upload_decrypt_validate_batch(col, [i for _, i in lanes], keypair)
            for (ticket, _), res in zip(lanes, results):
                if isinstance(res, BaseException):
                    self._resolve(ticket, error=res)
                else:
                    self._submit_stored(ticket, res)
        self._add_seconds("decrypt", time.perf_counter() - t0)

    def close(self) -> None:
        with self._lock:
            self._stop = True
            started = self._started
        if not started:
            return
        for _ in range(self.decode_workers):
            self._decode_q.put(_STOP)
        for _ in range(self.decrypt_workers):
            self._decrypt_q.put(_STOP)
        for t in self._threads:
            t.join(timeout=5)
        # fail any ticket a worker handed forward after its peers took the
        # stop sentinels (decode can enqueue behind a decrypt sentinel):
        # nothing will consume it, and its handler thread must get an
        # immediate error, not a result() timeout
        for q in (self._decode_q, self._decrypt_q):
            while True:
                try:
                    t = q.get_nowait()
                except queue.Empty:
                    break
                if t is _STOP:
                    continue
                tickets = [tk for tk, _ in t.lanes] if isinstance(t, _DecryptWindow) else [t]
                for ticket in tickets:
                    if not ticket.event.is_set():
                        self._resolve(ticket, error=RuntimeError("ingest pipeline is closed"))
