"""Upload write batching.

Equivalent of reference aggregator/src/aggregator/report_writer.rs:24-165
(`ReportWriteBatcher`): buffer uploaded reports and flush them in a
single transaction, fanning the per-report outcome (fresh vs replayed)
back to each waiting upload request.

The port's own copy of janus_tpu/aggregator/report_writer.py. The flush
policy is group commit, not a fixed timer: a flusher thread writes
whatever accumulated while the previous transaction ran, so a lone
client sees about one transaction's latency and concurrent bursts batch
naturally. `max_write_delay_ms > 0` adds a coalescing wait, capped by
`max_batch_size`. `stage_seconds["commit"]` sums the seconds of the
flush transactions.

Not ported: the upload journal (janus_tpu's `journal=` spill path, armed
by a datastore supervisor the port's SQLite store does not have), the
conservation ledger's admission count, and the flush failpoint.
"""

from __future__ import annotations

import logging
import threading
import time

from ..datastore.models import LeaderStoredReport
from ..datastore.store import Datastore

log = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("report", "event", "fresh", "error", "on_done")

    def __init__(self, report: LeaderStoredReport, on_done=None):
        self.report = report
        self.event = threading.Event()
        self.fresh: bool | None = None
        self.error: BaseException | None = None
        # optional callback, run on the flusher thread after the outcome
        # is recorded (the ingest pipeline resolves its tickets here)
        self.on_done = on_done


class ReportWriteBatcher:
    """Blocking writes with group-commit flushes. Request threads call
    `write_report` and park until their batch's transaction commits."""

    def __init__(self, ds: Datastore, max_batch_size: int = 100, max_write_delay_ms: int = 0):
        self.ds = ds
        self.max_batch_size = max_batch_size
        self.max_write_delay_s = max_write_delay_ms / 1000.0
        self.stage_seconds: dict[str, float] = {"commit": 0.0}
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buffer: list[_Pending] = []
        self._flusher: threading.Thread | None = None
        self._stop = False

    def write_report(self, report: LeaderStoredReport, timeout_s: float = 30.0) -> bool:
        """Queue and wait for the group commit; returns False on replay."""
        pending = self.submit_report(report)
        if not pending.event.wait(timeout_s):
            raise TimeoutError("report write batch did not flush in time")
        if pending.error is not None:
            raise pending.error
        assert pending.fresh is not None
        return pending.fresh

    def submit_report(self, report: LeaderStoredReport, on_done=None) -> _Pending:
        """Queue without waiting. The returned _Pending's event fires, and
        `on_done(pending)` runs on the flusher thread, once its batch's
        transaction commits (pending.fresh) or fails (pending.error)."""
        pending = _Pending(report, on_done)
        with self._cv:
            if self._stop:
                raise RuntimeError("report writer is closed")
            self._buffer.append(pending)
            if self._flusher is None:
                self._flusher = threading.Thread(target=self._flush_loop, name="report-writer", daemon=True)
                self._flusher.start()
            self._cv.notify()
        return pending

    def flush_now(self) -> None:
        """Flush whatever is buffered, synchronously (tests, shutdown)."""
        with self._cv:
            batch, self._buffer = self._buffer, []
        if batch:
            self._flush(batch)

    def close(self) -> None:
        """Stop the flusher thread after draining (shutdown)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        flusher = self._flusher
        if flusher is not None:
            flusher.join(timeout=5)
        self.flush_now()

    def _flush_loop(self) -> None:
        while True:
            with self._cv:
                while not self._buffer:
                    if self._stop:
                        return
                    self._cv.wait()
                if self.max_write_delay_s > 0:
                    # optional coalescing window: wait until the batch fills
                    # or the window closes
                    deadline = time.monotonic() + self.max_write_delay_s
                    while len(self._buffer) < self.max_batch_size and not self._stop:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                batch = self._buffer[: self.max_batch_size]
                self._buffer = self._buffer[self.max_batch_size :]
            if batch:  # a concurrent flush_now may have drained it
                self._flush(batch)

    def _flush(self, batch: list[_Pending]) -> None:
        """One transaction for the whole batch (reference :96-165)."""
        try:
            t0 = time.perf_counter()
            results = self.ds.run_tx(lambda tx: [tx.put_client_report(p.report) for p in batch], "upload_batch")
            with self._lock:
                self.stage_seconds["commit"] += time.perf_counter() - t0
            for p, fresh in zip(batch, results):
                p.fresh = fresh
        except BaseException as e:  # fan the failure out to every waiter
            for p in batch:
                p.error = e
        finally:
            for p in batch:
                p.event.set()
                if p.on_done is not None:
                    try:
                        p.on_done(p)
                    except Exception:
                        # a bad callback must not take down the flusher or
                        # the rest of the batch's notifications
                        log.exception("report write on_done callback failed")
