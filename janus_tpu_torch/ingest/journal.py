"""Durable upload spill journal: datastore-outage survival for the
DAP upload path (docs/ROBUSTNESS.md "Datastore outages").

The DAP ack contract is `201 ⇒ eventually aggregated exactly once`,
and the only thing a 201 may rest on is a durable write. When the
datastore is unreachable (connection-class failure) or drowning
(commit latency past the spill threshold), the ReportWriteBatcher
appends the already-validated report rows HERE — a CRC-framed,
segmented, fsync-on-ack append-only journal on local disk — and the
upload is acked on the strength of that fsync. A background
JournalReplayer drains segments back through the write batcher once
the datastore recovers; the datastore's report-id primary key makes
replay idempotent (duplicate ⇒ replayed-ok), and a segment is
truncated only after the transaction covering every row in it has
committed.

Durability/ordering contract:

  * **fsync-on-ack**: `append_batch` returns only after the frames and
    the fsync land; a 201 resting on the journal survives process
    death and OS crash (modulo disk loss — the journal is a
    *same-host* durability story, like a WAL).
  * **Idempotent replay**: rows are replayed through the same
    `put_client_report` ON CONFLICT DO NOTHING path as live uploads;
    a crash between replay-commit and truncate re-replays the segment
    harmlessly (every row dedups).
  * **Truncate after commit**: a segment is unlinked only after
    `flush_direct` returned for every row in it, so no acked report
    can exist solely in an unlinked file.
  * **Torn tails tolerated, damage quarantined**: a crash/ENOSPC
    mid-append leaves a TRUNCATED final frame (sequential writes always
    end short) — those rows were never acked (the fsync hadn't
    returned) and the valid prefix replays + truncates normally. A
    complete frame failing its CRC is genuine damage: the prefix still
    replays, but the file is QUARANTINED on disk as `.corrupt` (ERROR
    log + statusz count) because frames past the damage may hold acked
    data — never silently truncated, never a boot crash-loop.
  * **Bounded**: `max_total_bytes` / `max_segments` cap the journal;
    a full journal sheds uploads with `503 + Retry-After`
    (JournalFull) — bounded lies beat unbounded truth-on-disk.
  * **Encrypted at rest**: the leader input share is encrypted with
    the datastore Crypter (AAD table "upload_journal") under the same
    key rotation as the database, so spilled plaintext shares never
    touch disk.

Frame format (little-endian):

    "JUJ1" | u32 payload_len | u32 crc32(len_le || payload) | payload

(the CRC covers the length so a flipped length field reads as damage,
not as a benign torn tail; the magic lets the reader tell "file ends
here" from "damage with more frames behind it"). Payload: task_id(32)
report_id(16) client_time(u64) then length-prefixed public_share,
encrypted leader_input_share and helper_encrypted_input_share.

The port's own copy of janus_tpu/ingest/journal.py. The segment names,
the framing and the payload are janus_tpu's byte for byte, so a segment
written by either package replays into the other's datastore (with the
same Crypter keys). It leaves out the journal's counters and gauges
(depth, bytes, appends, replayed by outcome): `status()`, `depth()` and
the replayer's `replayed_fresh` / `replayed_dupes` carry the same counts.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
import zlib

from .admission import ShedError

log = logging.getLogger(__name__)

# frame = magic | u32 payload_len | u32 crc32(len_le || payload) | payload
# — the CRC covers the LENGTH so a bit-flipped length field cannot
# masquerade as a benign truncated tail, and the magic lets the reader
# tell "file ends here" (torn tail) from "damage with more frames
# behind it" (quarantine, never truncate)
_FRAME_MAGIC = b"JUJ1"
_FRAME_HDR = struct.Struct("<II")
_SEGMENT_PREFIX = "upload-journal-"
_SEGMENT_SUFFIX = ".wal"
_QUARANTINE_SUFFIX = ".corrupt"


def _frame(payload: bytes) -> bytes:
    len_le = struct.pack("<I", len(payload))
    crc = zlib.crc32(len_le + payload) & 0xFFFFFFFF
    return _FRAME_MAGIC + len_le + struct.pack("<I", crc) + payload


class JournalFull(ShedError):
    """The bounded journal cannot absorb more spilled uploads: shed
    with 503 + Retry-After (the datastore is down AND the local buffer
    is exhausted — the honest answer is 'come back later')."""

    def __init__(self, retry_after_s: float = 30.0):
        super().__init__("upload", "journal_full", retry_after_s)
        self.status = 503


def _encode_row(crypter, report) -> bytes:
    """LeaderStoredReport -> frame payload (share encrypted at rest)."""
    row_key = report.task_id.data + report.report_id.data
    enc_share = crypter.encrypt(
        "upload_journal", row_key, "leader_input_share", report.leader_input_share
    )
    helper = report.helper_encrypted_input_share.to_bytes()
    public = report.public_share or b""
    return b"".join(
        (
            report.task_id.data,
            report.report_id.data,
            struct.pack("<Q", report.client_time.seconds),
            struct.pack("<I", len(public)),
            public,
            struct.pack("<I", len(enc_share)),
            enc_share,
            struct.pack("<I", len(helper)),
            helper,
        )
    )


def _decode_row(crypter, payload: bytes):
    from ..datastore.models import LeaderStoredReport
    from ..messages import HpkeCiphertext, ReportId, TaskId, Time

    off = 0

    def take(n: int) -> bytes:
        nonlocal off
        if off + n > len(payload):
            raise ValueError("journal row truncated")
        out = payload[off : off + n]
        off += n
        return out

    task_id = take(32)
    report_id = take(16)
    (client_time,) = struct.unpack("<Q", take(8))
    (n,) = struct.unpack("<I", take(4))
    public = take(n)
    (n,) = struct.unpack("<I", take(4))
    enc_share = take(n)
    (n,) = struct.unpack("<I", take(4))
    helper = take(n)
    share = crypter.decrypt(
        "upload_journal", task_id + report_id, "leader_input_share", enc_share
    )
    return LeaderStoredReport(
        TaskId(task_id),
        ReportId(report_id),
        Time(client_time),
        public,
        share,
        HpkeCiphertext.from_bytes(helper),
    )


def _read_frames(path: str) -> tuple[list[bytes], str]:
    """(payloads, reason) where reason is:

      "clean"      every frame decoded
      "truncated"  the file ends inside the LAST frame — the signature
                   of a crash/ENOSPC mid-append; the missing rows were
                   never acked, so the prefix is safe to replay AND the
                   segment safe to truncate after it lands
      "crc"        damage with (possibly) acked frames behind it — a
                   checksum/magic failure, or an undecodable region
                   followed by another frame magic; the prefix is
                   replayed but the file must be QUARANTINED
                   (preserved on disk), never truncated

    Always stops at the first invalid frame. The "is there another
    frame magic after the damage?" scan is what keeps a corrupted
    length field from masquerading as a benign torn tail."""
    payloads: list[bytes] = []
    with open(path, "rb") as f:
        data = f.read()
    hdr = len(_FRAME_MAGIC) + _FRAME_HDR.size
    off = 0

    def _tail_reason(stop: int) -> str:
        # damage at `stop`: torn tail if nothing frame-like follows,
        # corruption (quarantine — the conservative direction) if a
        # later frame magic exists
        nxt = data.find(_FRAME_MAGIC, stop + 1)
        return "crc" if nxt != -1 else "truncated"

    while off < len(data):
        if off + hdr > len(data):
            return payloads, _tail_reason(off)
        if data[off : off + len(_FRAME_MAGIC)] != _FRAME_MAGIC:
            return payloads, _tail_reason(off)
        length, crc = _FRAME_HDR.unpack_from(data, off + len(_FRAME_MAGIC))
        start = off + hdr
        if start + length > len(data):
            return payloads, _tail_reason(off)
        payload = data[start : start + length]
        if zlib.crc32(struct.pack("<I", length) + payload) & 0xFFFFFFFF != crc:
            # a COMPLETE frame failing its checksum is damage even at
            # EOF (a torn sequential append leaves a short frame, not a
            # full-length one): always the quarantine direction
            return payloads, "crc"
        payloads.append(payload)
        off = start + length
    return payloads, "clean"


class UploadJournal:
    """Segmented append-only spill journal (see module docstring).

    Thread-safe; one active segment receives appends, sealed segments
    (everything older) are replay candidates. On construction the
    directory is scanned so a journal left non-empty by a crash is
    picked up by the replayer."""

    def __init__(
        self,
        directory: str,
        crypter,
        max_segment_bytes: int = 8 << 20,
        max_total_bytes: int = 256 << 20,
        max_segments: int = 1024,
        full_retry_after_s: float = 30.0,
    ):
        self.dir = os.path.abspath(os.path.expanduser(directory))
        self.crypter = crypter
        self.max_segment_bytes = max(4096, int(max_segment_bytes))
        self.max_total_bytes = max(self.max_segment_bytes, int(max_total_bytes))
        self.max_segments = max(2, int(max_segments))
        self.full_retry_after_s = float(full_retry_after_s)
        self._lock = threading.Lock()
        self._fh = None  # active segment file handle
        self._active_seq = 0
        self._active_bytes = 0
        self._active_records = 0
        # {seq: (records, bytes)} for sealed segments
        self._sealed: dict[int, tuple[int, int]] = {}
        self.fsyncs = 0
        self.appended_total = 0
        self.quarantined = 0
        # .corrupt files count toward max_total_bytes until an operator
        # removes them: quarantine preserves bytes, and a preserved
        # byte is still a byte on the bounded disk
        self.quarantined_bytes = 0
        os.makedirs(self.dir, exist_ok=True)
        self._recover()

    def _fsync_dir(self, required: bool = False) -> None:
        """Persist directory entries (segment create/unlink): a file
        fsync alone does not persist its dirent. `required=True` (the
        segment-CREATE path, which acks rest on) propagates failure —
        an upload must shed rather than be acked against a dirent that
        may not survive power loss; cleanup paths stay best-effort."""
        try:
            dirfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
        except OSError:
            if required:
                raise

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------
    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{_SEGMENT_PREFIX}{seq:016d}{_SEGMENT_SUFFIX}")

    def depth(self) -> tuple[int, int, int]:
        """(records awaiting replay, bytes on disk, segment count)."""
        with self._lock:
            records = self._active_records + sum(r for r, _ in self._sealed.values())
            nbytes = self._active_bytes + sum(b for _, b in self._sealed.values())
            segments = len(self._sealed) + (1 if self._active_records else 0)
            return records, nbytes, segments

    def status(self) -> dict:
        """/statusz section."""
        records, nbytes, segments = self.depth()
        return {
            "dir": self.dir,
            "records": records,
            "bytes": nbytes,
            "segments": segments,
            "max_total_bytes": self.max_total_bytes,
            "appended_total": self.appended_total,
            "fsyncs": self.fsyncs,
            "quarantined": self.quarantined,
            "quarantined_bytes": self.quarantined_bytes,
            "full": self.is_full(),
        }

    # a journal is reported full once less than this headroom remains:
    # readiness must flip BEFORE the next typical append is refused
    FULL_SLACK_BYTES = 4096

    def is_full(self) -> bool:
        with self._lock:
            nbytes = (
                self._active_bytes
                + sum(b for _, b in self._sealed.values())
                + self.quarantined_bytes
            )
            segments = len(self._sealed) + 1
            return (
                nbytes + self.FULL_SLACK_BYTES > self.max_total_bytes
                or segments > self.max_segments
            )

    def readiness(self) -> str | None:
        """None when the journal can absorb spills; a reason when full
        (/readyz fails — this replica can no longer honor 201s during
        an outage)."""
        if self.is_full():
            _, nbytes, segments = self.depth()
            return (
                f"upload journal full ({nbytes} bytes / {segments} segments,"
                f" cap {self.max_total_bytes} bytes / {self.max_segments} segments)"
            )
        return None

    # ------------------------------------------------------------------
    # boot recovery
    # ------------------------------------------------------------------
    def _recover(self) -> None:
        seqs = []
        quarantined_seqs = []
        for name in os.listdir(self.dir):
            if _QUARANTINE_SUFFIX in name:  # .corrupt / .corrupt.N
                # quarantined by an earlier process: still occupying
                # bounded disk until the operator deals with it — and
                # its sequence number must never be REUSED, or a later
                # quarantine's rename would overwrite the preserved file
                self.quarantined += 1
                self.quarantined_bytes += os.path.getsize(os.path.join(self.dir, name))
                stem = name.split(_QUARANTINE_SUFFIX)[0]
                if stem.startswith(_SEGMENT_PREFIX) and stem.endswith(_SEGMENT_SUFFIX):
                    try:
                        quarantined_seqs.append(
                            int(stem[len(_SEGMENT_PREFIX) : -len(_SEGMENT_SUFFIX)])
                        )
                    except ValueError:
                        pass
                continue
            if name.startswith(_SEGMENT_PREFIX) and name.endswith(_SEGMENT_SUFFIX):
                try:
                    seqs.append(int(name[len(_SEGMENT_PREFIX) : -len(_SEGMENT_SUFFIX)]))
                except ValueError:
                    log.warning("ignoring non-journal file %s", name)
        seqs.sort()
        for seq in seqs:
            path = self._seg_path(seq)
            # every pre-existing segment is sealed: the process that
            # wrote it is gone, and only frames whose fsync returned
            # were ever acked. A truncated tail (crash mid-append) is
            # expected and benign; a CRC-broken frame is genuine damage
            # — LOUD at boot, and the drain will replay its valid
            # prefix and then quarantine the file instead of
            # truncating it. Either way the aggregator boots.
            payloads, reason = _read_frames(path)
            if reason == "crc":
                log.error(
                    "upload journal segment %s is CORRUPT mid-segment; its "
                    "%d-record prefix will be replayed and the file "
                    "quarantined as .corrupt",
                    path,
                    len(payloads),
                )
            self._sealed[seq] = (len(payloads), os.path.getsize(path))
        self._active_seq = max(seqs + quarantined_seqs, default=0) + 1
        if self._sealed:
            log.warning(
                "upload journal recovered %d segment(s), %d record(s) awaiting replay",
                len(self._sealed),
                sum(r for r, _ in self._sealed.values()),
            )

    # ------------------------------------------------------------------
    # append (the spill path)
    # ------------------------------------------------------------------
    def _quarantine_path_locked(self, seq: int, path: str) -> None:
        self.quarantined += 1
        try:
            self.quarantined_bytes += os.path.getsize(path)
            target = path + _QUARANTINE_SUFFIX
            # never clobber an earlier quarantine's preserved bytes
            n = 1
            while os.path.exists(target):
                target = f"{path}{_QUARANTINE_SUFFIX}.{n}"
                n += 1
            os.replace(path, target)
        except OSError:
            log.exception("could not quarantine corrupt segment %s", path)
        self._fsync_dir()
        log.error(
            "upload journal segment %d is CORRUPT (acked data may be "
            "affected); quarantined as %s%s for manual recovery",
            seq,
            path,
            _QUARANTINE_SUFFIX,
        )

    def quarantine_segment(self, seq: int) -> None:
        """Move a corrupt sealed segment out of the replay queue,
        preserving its bytes as `<name>.corrupt` for manual recovery."""
        with self._lock:
            self._sealed.pop(seq, None)
            self._quarantine_path_locked(seq, self._seg_path(seq))

    def _open_active_locked(self):
        if self._fh is None:
            path = self._seg_path(self._active_seq)
            created = not os.path.exists(path)
            # buffering=0: a failed buffered flush would keep the
            # unwritten remainder in the userspace buffer and emit it
            # as mid-segment garbage on the NEXT (acked) append; raw
            # writes leave nothing behind to leak
            self._fh = open(path, "ab", buffering=0)
            self._active_bytes = self._fh.tell()
            if created:
                # the dirent must be durable before any ack rests on
                # this file: a file fsync alone does not persist it
                try:
                    self._fsync_dir(required=True)
                except OSError:
                    self._fh.close()
                    self._fh = None
                    raise
        return self._fh

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        # seal by ON-DISK size, not the in-memory counters: a failed
        # first append can leave torn bytes in a file the counters say
        # is empty, and an unsealed file would sit outside the bound
        # accounting (and outside the drain's cleanup) until restart
        try:
            size = os.path.getsize(self._seg_path(self._active_seq))
        except OSError:
            size = 0
        if self._active_records or size:
            self._sealed[self._active_seq] = (self._active_records, size)
        self._active_seq += 1
        self._active_records = 0
        self._active_bytes = 0

    def append_batch(self, reports) -> None:
        """Append every report, then ONE fsync for the batch; returns
        only after the data is durable (the ack rests on it). Raises
        JournalFull when the bound is hit — callers map it to
        503 + Retry-After."""
        if not reports:
            return
        frames = [_frame(_encode_row(self.crypter, report)) for report in reports]
        nbytes = sum(len(f) for f in frames)
        with self._lock:
            total = (
                self._active_bytes
                + sum(b for _, b in self._sealed.values())
                + self.quarantined_bytes
            )
            if (
                total + nbytes > self.max_total_bytes
                or len(self._sealed) + 1 > self.max_segments
            ):
                raise JournalFull(self.full_retry_after_s)
            fh = self._open_active_locked()
            try:
                blob = b"".join(frames)
                if fh.write(blob) != len(blob):
                    raise OSError("short write to upload journal")
                os.fsync(fh.fileno())
            except BaseException:
                # ENOSPC/EIO mid-batch: roll the file back to the last
                # durable frame boundary — torn bytes left mid-file
                # would sit in FRONT of future acked frames and turn
                # them into an unreadable suffix (quarantined or
                # dropped as a "torn tail" on replay). The raw
                # (unbuffered) handle holds no leftover bytes; drop it
                # anyway so the next append starts from a clean fd.
                try:
                    os.ftruncate(fh.fileno(), self._active_bytes)
                    fh.close()
                    self._fh = None
                except OSError:
                    # cannot repair in place: abandon this segment for
                    # appends (its valid prefix stays replayable)
                    self._rotate_locked()
                raise
            self.fsyncs += 1
            self._active_bytes += nbytes
            self._active_records += len(frames)
            self.appended_total += len(frames)
            if self._active_bytes >= self.max_segment_bytes:
                self._rotate_locked()

    # ------------------------------------------------------------------
    # replay surface
    # ------------------------------------------------------------------
    def seal_active(self) -> None:
        """Make the active segment (if non-empty) available to the
        replayer; appends continue into a fresh segment."""
        with self._lock:
            if self._active_records:
                self._rotate_locked()

    def sealed_segments(self) -> list[int]:
        with self._lock:
            return sorted(self._sealed)

    def read_segment(self, seq: int) -> tuple[list, str]:
        """Decode a sealed segment's valid prefix (oldest-first) and
        report how the segment ends: "clean" / "truncated" (crash
        mid-append — never-acked tail, segment truncatable after the
        prefix lands) / "crc" (damage — segment must be QUARANTINED
        after the prefix lands, never truncated: frames past the
        damage may be acked data)."""
        path = self._seg_path(seq)
        payloads, reason = _read_frames(path)
        rows = []
        for payload in payloads:
            try:
                rows.append(_decode_row(self.crypter, payload))
            except Exception as e:
                # CRC-valid but undecodable (e.g. the crypter key was
                # rotated out): content damage — replay the decodable
                # prefix and quarantine, or the replayer would wedge on
                # this segment forever and nothing behind it would drain
                log.error(
                    "upload journal segment %s row %d undecodable (%s: %s)",
                    path,
                    len(rows),
                    type(e).__name__,
                    e,
                )
                return rows, "crc"
        if reason == "truncated":
            log.warning(
                "upload journal segment %s has a torn tail after %d record(s)",
                path,
                len(rows),
            )
        return rows, reason

    def truncate_segment(self, seq: int) -> None:
        """Remove a fully-replayed segment. ONLY call after the
        datastore transaction covering every row in it committed."""
        path = self._seg_path(seq)
        with self._lock:
            self._sealed.pop(seq, None)
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        # directory fsync so the unlink itself is durable (a crash must
        # not resurrect a replayed segment... it would dedup anyway,
        # but the bound accounting should match the disk)
        self._fsync_dir()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class JournalReplayer:
    """Background drain: once the datastore is reachable again, replay
    sealed segments through the ReportWriteBatcher's direct flush path
    (same transaction shape and report-id dedup as live uploads) and
    truncate each segment only after its covering commit lands.

    `supervisor_fn` returns the DatastoreSupervisor (or None): while it
    reports "down", the replayer sleeps — replaying into a dead
    database only burns the retry budget."""

    def __init__(
        self,
        journal: UploadJournal,
        writer,
        supervisor_fn=None,
        interval_s: float = 1.0,
        batch_size: int = 200,
    ):
        self.journal = journal
        self.writer = writer
        self.supervisor_fn = supervisor_fn or (lambda: None)
        self.interval_s = max(0.05, float(interval_s))
        self.batch_size = max(1, int(batch_size))
        self.replayed_fresh = 0
        self.replayed_dupes = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "JournalReplayer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="upload-journal-replay", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            self._thread = None

    def kick(self) -> None:
        """Wake the drain loop now (recovery notification, tests)."""
        self._wake.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.drain_once()
            except Exception:
                log.exception("upload journal replay pass failed; will retry")

    def drain_once(self) -> int:
        """One drain pass; returns the number of rows replayed. Safe to
        call from tests/ops tooling (manual drains go through the same
        path)."""
        records, _, _ = self.journal.depth()
        # drain on records OR leftover sealed files: a crash during the
        # very first append of an outage leaves a zero-valid-record
        # segment whose bytes would otherwise pin journal capacity
        # forever (depth counts records; the file still counts toward
        # the bound)
        if records == 0 and not self.journal.sealed_segments():
            return 0
        supervisor = self.supervisor_fn()
        if supervisor is not None and supervisor.state == "down":
            return 0
        replayed = 0
        # sealed segments first; the active one is sealed ONLY once the
        # sealed queue drained cleanly — sealing on a failing pass
        # would rotate a fresh segment every interval and exhaust
        # max_segments long before the byte bound during a long outage
        for _ in range(2):
            n, ok = self._drain_sealed()
            replayed += n
            if not ok or self._stop.is_set():
                break
            if self.journal.depth()[0] == 0:
                break
            self.journal.seal_active()
        return replayed

    def _drain_sealed(self) -> tuple[int, bool]:
        """Replay every sealed segment; (rows replayed, queue fully
        drained). A segment is removed only AFTER the transaction
        covering its whole valid prefix committed — truncated (crash
        tails are never-acked rows) for clean/torn segments,
        quarantined (bytes preserved as .corrupt) for CRC-damaged
        ones, whose post-damage region may hold acked data."""
        replayed = 0
        for seq in self.journal.sealed_segments():
            if self._stop.is_set():
                return replayed, False
            rows, reason = self.journal.read_segment(seq)
            for lo in range(0, len(rows), self.batch_size):
                chunk = rows[lo : lo + self.batch_size]
                try:
                    outcomes = self.writer.flush_direct(chunk)
                except Exception as e:
                    # the datastore is (still) unhappy: keep the
                    # segment, retry on the next pass
                    log.warning(
                        "journal replay of segment %d failed (%s: %s); retrying later",
                        seq,
                        type(e).__name__,
                        e,
                    )
                    return replayed, False
                fresh = sum(1 for f in outcomes if f)
                dupes = len(outcomes) - fresh
                self.replayed_fresh += fresh
                self.replayed_dupes += dupes
                replayed += len(outcomes)
            # the covering commit landed: the segment may leave the queue
            if reason == "crc":
                self.journal.quarantine_segment(seq)
            else:
                self.journal.truncate_segment(seq)
                log.info("upload journal segment %d replayed and truncated", seq)
        return replayed, True
