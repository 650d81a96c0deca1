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
flush transactions, `stage_seconds["spill"]` those of journal spills.

Datastore-outage survival, as in janus_tpu: with a journal attached, a
flush that hits a connection-class datastore error, or that runs while
the datastore supervisor reports the database not up, or after a commit
exceeded `spill_latency_s`, spills the batch to the durable on-disk
journal instead, and every waiter resolves fresh=True (201 on the
strength of the journal's fsync). The journal's replayer drains back
through `flush_direct`, which never spills; report-id dedup makes that
exactly-once. With no journal (the default) the flush path is the
pre-journal one. The `report_writer.flush` failpoint fails a whole
batch, as in janus_tpu.

Not ported: the conservation ledger's admission count (and its
`ledger.drop_report` failpoint) and the flush's trace spans.
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

    def __init__(
        self,
        ds: Datastore,
        max_batch_size: int = 100,
        max_write_delay_ms: int = 0,
        journal=None,
        spill_latency_s: float = 0.0,
    ):
        self.ds = ds
        self.max_batch_size = max_batch_size
        self.max_write_delay_s = max_write_delay_ms / 1000.0
        # optional durable spill journal (ingest.journal.UploadJournal):
        # None = the pre-journal flush path
        self.journal = journal
        # commit latency past this spills the next flushes (0 = only
        # connection-class errors and a supervisor not up spill)
        self.spill_latency_s = float(spill_latency_s)
        self.stage_seconds: dict[str, float] = {"commit": 0.0, "spill": 0.0}
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

    def flush_direct(self, reports: list[LeaderStoredReport]) -> list[bool]:
        """One transaction for `reports`, never spilling to the journal
        (the journal replayer's path: spilling a replay back into the
        journal would loop). Returns fresh-vs-replayed per report; raises
        on failure."""
        return self.ds.run_tx(lambda tx: [tx.put_client_report(r) for r in reports], "upload_journal_replay")

    def _should_spill_without_trying(self) -> bool:
        """Skip the doomed datastore attempt while the supervisor says the
        database is not up: every flush would otherwise spend run_tx's
        whole retry budget before spilling."""
        if self.journal is None:
            return False
        supervisor = getattr(self.ds, "supervisor", None)
        return supervisor is not None and supervisor.state != "up"

    def _spill(self, batch: list[_Pending]) -> None:
        """Journal the batch (fsync on ack) and resolve every waiter as
        fresh: durability now rests on the journal, and replay dedups any
        true duplicate. Raises (JournalFull included) on failure."""
        t0 = time.perf_counter()
        self.journal.append_batch([p.report for p in batch])
        with self._lock:
            self.stage_seconds["spill"] += time.perf_counter() - t0
        for p in batch:
            p.fresh = True

    def _flush(self, batch: list[_Pending]) -> None:
        """One transaction for the whole batch (reference :96-165)."""
        from .. import failpoints

        try:
            # the whole batch's waiters see an injected flush failure, and
            # the upload handlers map it to a 500, never a silent 201
            failpoints.hit(
                "report_writer.flush",
                error_factory=lambda: RuntimeError("injected flush failure (failpoint report_writer.flush)"),
            )
            if self._should_spill_without_trying():
                self._spill(batch)
                log.warning("datastore not up: spilled %d upload(s) to the journal", len(batch))
                return
            t0 = time.perf_counter()
            try:
                results = self.ds.run_tx(lambda tx: [tx.put_client_report(p.report) for p in batch], "upload_batch")
            except BaseException as e:
                # a connection-class failure with a journal: the ack rests
                # on local disk. Anything else (integrity, injected flush
                # faults, retries exhausted on contention) fails loudly.
                if (
                    self.journal is not None
                    and getattr(self.ds, "classify_error", None) is not None
                    and self.ds.classify_error(e) == "connection"
                ):
                    self._spill(batch)
                    log.warning("datastore connection lost (%s); spilled %d upload(s) to the journal", e, len(batch))
                    return
                raise
            elapsed = time.perf_counter() - t0
            with self._lock:
                self.stage_seconds["commit"] += elapsed
            if self.journal is not None and 0 < self.spill_latency_s < elapsed:
                # the commit landed but took too long: the supervisor
                # degrades, so the next flushes spill
                supervisor = getattr(self.ds, "supervisor", None)
                if supervisor is not None:
                    supervisor.record_slow_commit(elapsed)
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
