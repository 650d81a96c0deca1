"""The port's durable upload spill journal and the report writer's spill
path: every case of tests/test_upload_journal.py on the port's modules,
and the journal's bytes across packages.

The contract under test: 201 means durably written. While the datastore
is unreachable the ack may rest on the journal's fsync; replay after
recovery lands every journaled report exactly once (report-id dedup makes
duplicates replayed-ok). The journal is bounded (full: a 503 shed), torn
tails from a crash mid-append are tolerated, damage is quarantined, and
while the datastore is healthy the armed journal does no fsync.

Across packages: with the same reports and the same Crypter nonces, both
packages write the same segment bytes; a segment written by either
package replays into the other's datastore, leaving the rows the writing
package's own replay leaves. And an Aggregator with `upload_journal_path`
arms the writer's journal and starts the replayer (the port raised
NotPorted for it before).

Tolerance: exact equality; timing bounds as in janus_tpu's tests.
"""

import os
import time

import pytest

from janus_tpu import messages as jm
from janus_tpu.datastore import models as j_models
from janus_tpu.datastore import store as j_store
from janus_tpu.ingest import journal as j_journal
from janus_tpu.aggregator import report_writer as j_writer
from janus_tpu_torch import failpoints
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator.report_writer import ReportWriteBatcher
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.datastore import store as t_store
from janus_tpu_torch.datastore.models import LeaderStoredReport
from janus_tpu_torch.datastore.store import EphemeralDatastore
from janus_tpu_torch.ingest import journal as t_journal
from janus_tpu_torch.ingest.admission import ShedError
from janus_tpu_torch.ingest.journal import JournalFull, JournalReplayer, UploadJournal

from tests.test_torch_pg import SeededSecrets


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.clear()
    yield
    failpoints.clear()


@pytest.fixture
def eph():
    e = EphemeralDatastore()
    yield e
    e.cleanup()


def mkreport(i: int, share: bytes = b"secret-share", m=tm, models=t_models) -> LeaderStoredReport:
    return models.LeaderStoredReport(
        m.TaskId(bytes([i % 256]) * 32),
        m.ReportId(i.to_bytes(16, "big")),
        m.Time(1_600_000_000 + i),
        b"public" + bytes([i % 256]),
        share,
        m.HpkeCiphertext(m.HpkeConfigId(7), b"ek", b"ct" * 4),
    )


def db_report_count(ds) -> int:
    return ds.run_tx(lambda tx: tx._c.execute("SELECT COUNT(*) FROM client_reports").fetchone()[0], "count")


# --- the journal ------------------------------------------------------------


def test_append_read_roundtrip_encrypted_at_rest(tmp_path, eph):
    j = UploadJournal(str(tmp_path / "j"), eph.datastore.crypter)
    reports = [mkreport(i, share=b"PLAINTEXT-SHARE-%d" % i) for i in range(5)]
    j.append_batch(reports)
    assert j.fsyncs == 1
    assert j.depth()[0] == 5
    j.seal_active()
    (seq,) = j.sealed_segments()
    rows, reason = j.read_segment(seq)
    assert reason == "clean"
    assert [r.report_id.data for r in rows] == [r.report_id.data for r in reports]
    assert rows[0].leader_input_share == b"PLAINTEXT-SHARE-0"
    assert rows[0].public_share == reports[0].public_share
    assert rows[0].helper_encrypted_input_share.to_bytes() == reports[0].helper_encrypted_input_share.to_bytes()
    raw = open(j._seg_path(seq), "rb").read()
    assert b"PLAINTEXT-SHARE" not in raw


def test_torn_tail_tolerated_on_crash_recovery(tmp_path, eph):
    d = str(tmp_path / "j")
    j = UploadJournal(d, eph.datastore.crypter)
    j.append_batch([mkreport(i) for i in range(3)])
    j.close()
    with open(j._seg_path(1), "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad")
    j2 = UploadJournal(d, eph.datastore.crypter)
    (seq,) = j2.sealed_segments()
    rows, reason = j2.read_segment(seq)
    assert reason == "truncated" and len(rows) == 3
    w = ReportWriteBatcher(eph.datastore, journal=j2)
    r = JournalReplayer(j2, w, interval_s=60)
    assert r.drain_once() == 3
    assert j2.quarantined == 0 and j2.depth()[0] == 0
    w.close()


def test_double_crash_torn_segments_both_replayed(tmp_path, eph):
    d = str(tmp_path / "j")
    j = UploadJournal(d, eph.datastore.crypter)
    j.append_batch([mkreport(i) for i in range(2)])
    j.close()
    with open(j._seg_path(1), "ab") as f:
        f.write(b"\x10\x00\x00\x00")
    j2 = UploadJournal(d, eph.datastore.crypter)
    j2.append_batch([mkreport(10 + i) for i in range(2)])
    j2.close()
    with open(j2._seg_path(2), "ab") as f:
        f.write(b"\x10\x00\x00\x00")
    j3 = UploadJournal(d, eph.datastore.crypter)
    assert j3.depth()[0] == 4 and j3.quarantined == 0
    w = ReportWriteBatcher(eph.datastore, journal=j3)
    r = JournalReplayer(j3, w, interval_s=60)
    assert r.drain_once() == 4
    assert j3.depth()[0] == 0 and j3.quarantined == 0
    assert db_report_count(eph.datastore) == 4
    w.close()


def test_mid_segment_crc_damage_prefix_replayed_then_quarantined(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    j.append_batch([mkreport(i) for i in range(3)])
    j.seal_active()
    j.append_batch([mkreport(10 + i) for i in range(2)])
    j.seal_active()
    first, _second = j.sealed_segments()
    path = j._seg_path(first)
    data = bytearray(open(path, "rb").read())
    frame1_len = 8 + (len(data) // 3 - 8)
    data[frame1_len + 12] ^= 0xFF
    open(path, "wb").write(bytes(data))
    rows, reason = j.read_segment(first)
    assert reason == "crc" and len(rows) == 1
    w = ReportWriteBatcher(ds, journal=j)
    r = JournalReplayer(j, w, interval_s=60)
    assert r.drain_once() == 3
    assert j.sealed_segments() == [] and j.quarantined == 1
    assert os.path.exists(path + ".corrupt")
    assert db_report_count(ds) == 3
    w.close()


def test_corrupt_length_field_quarantines_not_truncates(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    j.append_batch([mkreport(i) for i in range(3)])
    j.seal_active()
    (seq,) = j.sealed_segments()
    path = j._seg_path(seq)
    data = bytearray(open(path, "rb").read())
    data[6] |= 0x80
    open(path, "wb").write(bytes(data))
    rows, reason = j.read_segment(seq)
    assert reason == "crc" and rows == []
    w = ReportWriteBatcher(ds, journal=j)
    JournalReplayer(j, w, interval_s=60).drain_once()
    assert j.quarantined == 1 and os.path.exists(path + ".corrupt")
    w.close()


def test_undecodable_row_quarantines_instead_of_wedging(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), t_store.Crypter())
    j.append_batch([mkreport(1)])
    j.seal_active()
    j.crypter = ds.crypter  # another key: the row no longer decrypts
    rows, reason = j.read_segment(j.sealed_segments()[0])
    assert reason == "crc" and rows == []
    w = ReportWriteBatcher(ds, journal=j)
    JournalReplayer(j, w, interval_s=60).drain_once()
    assert j.quarantined == 1 and j.depth()[0] == 0
    w.close()


def test_quarantined_seq_never_reused_across_restart(tmp_path, eph):
    d = str(tmp_path / "j")
    j = UploadJournal(d, eph.datastore.crypter)
    j.append_batch([mkreport(1)])
    j.seal_active()
    (seq,) = j.sealed_segments()
    j.quarantine_segment(seq)
    j.close()
    j2 = UploadJournal(d, eph.datastore.crypter)
    assert j2._active_seq > seq
    j2.append_batch([mkreport(2)])
    j2.seal_active()
    (seq2,) = j2.sealed_segments()
    open(j2._seg_path(seq2) + ".corrupt", "wb").write(b"preserved")
    j2.quarantine_segment(seq2)
    assert open(j2._seg_path(seq2) + ".corrupt", "rb").read() == b"preserved"
    assert os.path.exists(j2._seg_path(seq2) + ".corrupt.1")


def test_zero_record_torn_segment_is_cleaned_up(tmp_path, eph):
    d = str(tmp_path / "j")
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, "upload-journal-0000000000000001.wal"), "wb").write(b"JUJ1\x40\x00\x00\x00")
    j = UploadJournal(d, eph.datastore.crypter)
    assert j.depth() == (0, 8, 1)
    w = ReportWriteBatcher(eph.datastore, journal=j)
    JournalReplayer(j, w, interval_s=60).drain_once()
    assert j.depth() == (0, 0, 0) and j.quarantined == 0
    w.close()


def test_quarantined_bytes_count_toward_the_bound(tmp_path, eph):
    d = str(tmp_path / "j")
    j = UploadJournal(d, eph.datastore.crypter, max_total_bytes=1 << 20)
    j.append_batch([mkreport(i) for i in range(4)])
    j.seal_active()
    (seq,) = j.sealed_segments()
    size = os.path.getsize(j._seg_path(seq))
    j.quarantine_segment(seq)
    assert j.quarantined_bytes == size
    j2 = UploadJournal(d, eph.datastore.crypter, max_total_bytes=1 << 20)
    assert j2.quarantined == 1 and j2.quarantined_bytes == size


def test_boot_survives_corrupt_segment(tmp_path, eph):
    d = str(tmp_path / "j")
    j = UploadJournal(d, eph.datastore.crypter)
    j.append_batch([mkreport(i) for i in range(3)])
    j.seal_active()
    j.append_batch([mkreport(10 + i) for i in range(2)])
    j.close()
    first = j.sealed_segments()[0]
    path = j._seg_path(first)
    data = bytearray(open(path, "rb").read())
    data[12] ^= 0xFF
    open(path, "wb").write(bytes(data))
    j2 = UploadJournal(d, eph.datastore.crypter)
    w = ReportWriteBatcher(eph.datastore, journal=j2)
    assert JournalReplayer(j2, w, interval_s=60).drain_once() == 2
    assert j2.quarantined == 1 and os.path.exists(path + ".corrupt")
    assert db_report_count(eph.datastore) == 2
    w.close()


def test_segment_rotation_and_bound(tmp_path, eph):
    j = UploadJournal(str(tmp_path / "j"), eph.datastore.crypter, max_segment_bytes=4096, max_total_bytes=8192)
    with pytest.raises(JournalFull) as ei:
        for i in range(200):
            j.append_batch([mkreport(i)])
    assert isinstance(ei.value, ShedError)
    assert ei.value.status == 503 and ei.value.reason == "journal_full"
    assert len(j.sealed_segments()) >= 1
    assert j.is_full() and j.readiness() is not None
    assert j.status()["full"] is True


def test_boot_recovery_scan(tmp_path, eph):
    d = str(tmp_path / "j")
    j1 = UploadJournal(d, eph.datastore.crypter)
    j1.append_batch([mkreport(i) for i in range(4)])
    j1.close()
    j2 = UploadJournal(d, eph.datastore.crypter)
    records, _, segments = j2.depth()
    assert records == 4 and segments == 1
    assert len(j2.sealed_segments()) == 1


# --- the replayer -------------------------------------------------------------


def test_replay_drains_and_truncates_after_commit(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    j.append_batch([mkreport(i) for i in range(6)])
    r = JournalReplayer(j, w, interval_s=60)
    assert r.drain_once() == 6
    assert j.depth() == (0, 0, 0)
    assert db_report_count(ds) == 6
    assert r.replayed_fresh == 6 and r.replayed_dupes == 0
    assert not [f for f in os.listdir(j.dir) if f.endswith(".wal")]
    w.close()


def test_replay_failure_keeps_segment_for_retry(tmp_path, eph):
    ds = eph.datastore
    ds.failpoint_scope = "jtest"
    ds.retry_max_interval_s = 0.001
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    j.append_batch([mkreport(i) for i in range(3)])
    failpoints.configure("datastore.connect.jtest=error:1.0")
    r = JournalReplayer(j, w, interval_s=60)
    assert r.drain_once() == 0
    assert j.depth()[0] == 3
    failpoints.clear()
    assert r.drain_once() == 3
    assert j.depth()[0] == 0 and db_report_count(ds) == 3
    w.close()


def test_replay_duplicate_is_replayed_ok(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    dup = mkreport(1)
    assert w.write_report(dup) is True
    j.append_batch([dup, mkreport(2)])
    r = JournalReplayer(j, w, interval_s=60)
    assert r.drain_once() == 2
    assert db_report_count(ds) == 2
    assert r.replayed_dupes == 1 and r.replayed_fresh == 1
    w.close()


def test_replayer_waits_out_datastore_down(tmp_path, eph):
    class FakeSup:
        state = "down"

    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    j.append_batch([mkreport(1)])
    r = JournalReplayer(j, w, supervisor_fn=lambda: FakeSup(), interval_s=60)
    assert r.drain_once() == 0
    assert j.depth()[0] == 1
    w.close()


def test_replayer_thread_drains_on_its_own(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    j.append_batch([mkreport(i) for i in range(3)])
    r = JournalReplayer(j, w, interval_s=0.05).start()
    deadline = time.monotonic() + 10
    while j.depth()[0] and time.monotonic() < deadline:
        time.sleep(0.01)
    r.stop()
    assert j.depth()[0] == 0 and db_report_count(ds) == 3 and r._thread is None
    w.close()


# --- the writer's spill path ----------------------------------------------------


def test_healthy_path_has_no_fsyncs_and_no_spill(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    for i in range(5):
        assert w.write_report(mkreport(i)) is True
    assert j.fsyncs == 0 and j.depth()[0] == 0
    assert db_report_count(ds) == 5
    assert w.stage_seconds["spill"] == 0.0
    w.close()


def test_spill_on_connection_error_resolves_201(tmp_path, eph):
    ds = eph.datastore
    ds.failpoint_scope = "spill"
    ds.retry_max_interval_s = 0.001
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    failpoints.configure("datastore.connect.spill=error:1.0")
    assert w.write_report(mkreport(1)) is True
    assert j.depth()[0] == 1 and j.fsyncs == 1
    failpoints.clear()
    assert JournalReplayer(j, w, interval_s=60).drain_once() == 1
    assert db_report_count(ds) == 1
    w.close()


def test_no_journal_connection_error_still_fails_loudly(eph):
    import sqlite3

    ds = eph.datastore
    ds.failpoint_scope = "nojournal"
    ds.retry_max_interval_s = 0.001
    w = ReportWriteBatcher(ds)
    failpoints.configure("datastore.connect.nojournal=error:1.0")
    with pytest.raises(sqlite3.OperationalError):
        w.write_report(mkreport(1))
    failpoints.clear()
    w.close()


def test_non_connection_errors_never_spill(tmp_path, eph):
    ds = eph.datastore
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    failpoints.configure("report_writer.flush=error:1,count=1")
    with pytest.raises(RuntimeError, match="report_writer.flush"):
        w.write_report(mkreport(1))
    assert j.depth()[0] == 0
    assert w.write_report(mkreport(2)) is True
    w.close()


def test_supervisor_down_bypasses_doomed_tx(tmp_path, eph):
    ds = eph.datastore
    ds.failpoint_scope = "bypass"
    sup = ds.start_supervision(probe_interval_s=0.05, down_threshold=2)
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j)
    failpoints.configure("datastore.connect.bypass=error:1.0")
    deadline = time.monotonic() + 10
    while sup.state != "down" and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sup.state == "down"
    t0 = time.monotonic()
    assert w.write_report(mkreport(1)) is True
    assert time.monotonic() - t0 < 0.5
    assert j.depth()[0] == 1
    failpoints.clear()
    w.close()


def test_journal_full_resolves_shed_error(tmp_path, eph):
    from janus_tpu_torch.datastore.store import DatastoreSupervisor

    ds = eph.datastore
    sup = ds.supervisor = DatastoreSupervisor(ds, probe_interval_s=3600)
    for _ in range(3):
        sup.record_failure()
    assert sup.state == "down"
    j = UploadJournal(str(tmp_path / "j"), ds.crypter, max_segment_bytes=4096, max_total_bytes=4096)
    w = ReportWriteBatcher(ds, journal=j)
    with pytest.raises(JournalFull) as ei:
        for i in range(200):
            w.write_report(mkreport(i))
    assert ei.value.status == 503 and ei.value.retry_after_s > 0
    w.close()


def test_slow_commit_degrades_and_spills_next_flush(tmp_path, eph):
    ds = eph.datastore
    ds.start_supervision(probe_interval_s=3600)
    j = UploadJournal(str(tmp_path / "j"), ds.crypter)
    w = ReportWriteBatcher(ds, journal=j, spill_latency_s=1e-9)
    assert w.write_report(mkreport(1)) is True
    assert db_report_count(ds) == 1
    assert ds.supervisor.state == "degraded"
    assert w.write_report(mkreport(2)) is True
    assert j.depth()[0] == 1
    w.close()


# --- across packages ---------------------------------------------------------------

KEY = bytes(range(16, 32))


def _reports(pkg: str, n: int = 5):
    if pkg == "jax":
        return [mkreport(i, b"share-%d" % i, m=jm, models=j_models) for i in range(n)]
    return [mkreport(i, b"share-%d" % i) for i in range(n)]


def test_both_packages_write_the_same_segment_bytes(tmp_path, monkeypatch):
    segs = {}
    for pkg, store, journal in (("jax", j_store, j_journal), ("torch", t_store, t_journal)):
        monkeypatch.setattr(store, "secrets", SeededSecrets(3))
        jr = journal.UploadJournal(str(tmp_path / pkg), store.Crypter([KEY]))
        jr.append_batch(_reports(pkg, 3))
        jr.append_batch(_reports(pkg, 5)[3:])
        jr.seal_active()
        (seq,) = jr.sealed_segments()
        segs[pkg] = (os.path.basename(jr._seg_path(seq)), open(jr._seg_path(seq), "rb").read())
        jr.close()
    assert segs["torch"] == segs["jax"]


def _client_rows(ds, store):
    """The leader's client_reports rows, the share decrypted at rest."""
    crypter = store.Crypter([KEY])

    def read(tx):
        rows = tx._c.execute(
            "SELECT task_id, report_id, client_time, public_share, leader_input_share,"
            " helper_encrypted_input_share, aggregation_started FROM client_reports ORDER BY task_id, report_id"
        ).fetchall()
        return [
            (t, r, ct, ps, crypter.decrypt("client_reports", t + r, "leader_input_share", lis), h, a)
            for t, r, ct, ps, lis, h, a in rows
        ]

    return ds.run_tx(read)


PACKAGES = {
    "jax": (j_store, j_journal, j_writer, lambda: j_store.EphemeralDatastore(crypter=j_store.Crypter([KEY]))),
    "torch": (t_store, t_journal, None, lambda: EphemeralDatastore(crypter=t_store.Crypter([KEY]))),
}


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_segment_replays_into_the_other_package(tmp_path, direction):
    src, dst = direction.split("-to-")
    rows = {}
    for replayer in (src, dst):
        # the writing package journals 4 reports in two segments, one torn
        d = str(tmp_path / f"{replayer}-j")
        s_store, s_journal, _, _ = PACKAGES[src]
        jr = s_journal.UploadJournal(d, s_store.Crypter([KEY]))
        reps = _reports(src, 5)
        jr.append_batch(reps[:2])
        jr.seal_active()
        jr.append_batch(reps[2:4])
        jr.close()
        with open(jr._seg_path(2), "ab") as f:
            f.write(b"JUJ1\x40\x00")  # a crash mid-append
        # the replaying package reads the directory and drains it
        r_store, r_journal, r_writer, r_eph = PACKAGES[replayer]
        eph = r_eph()
        try:
            writer = (r_writer.ReportWriteBatcher if r_writer else ReportWriteBatcher)(eph.datastore)
            rj = r_journal.UploadJournal(d, r_store.Crypter([KEY]))
            assert rj.depth()[0] == 4 and len(rj.sealed_segments()) == 2
            rep = r_journal.JournalReplayer(rj, writer, interval_s=60)
            assert rep.drain_once() == 4 and rep.replayed_fresh == 4
            assert rj.depth() == (0, 0, 0) and rj.quarantined == 0
            assert rep.drain_once() == 0
            rows[replayer] = _client_rows(eph.datastore, r_store)
            writer.close()
        finally:
            eph.cleanup()
    assert rows[dst] == rows[src]
    assert [r[1] for r in rows[dst]] == sorted(r.report_id.data for r in _reports(src, 4))


def test_aggregator_arms_the_journal_and_its_replayer(tmp_path, eph):
    from janus_tpu_torch.aggregator.core import Aggregator, Config

    cfg = Config(
        upload_journal_path=str(tmp_path / "journal"),
        upload_journal_max_segment_bytes=1 << 16,
        upload_journal_max_total_bytes=1 << 20,
        upload_journal_max_segments=8,
        upload_journal_spill_latency_s=2.5,
        upload_journal_replay_interval_s=0.05,
        upload_journal_full_retry_after_s=9.0,
    )
    agg = Aggregator(eph.datastore, eph.clock, cfg, device="cpu")
    try:
        j, w, r = agg.upload_journal, agg.report_writer, agg.journal_replayer
        assert w.journal is j and w.spill_latency_s == 2.5
        assert (j.max_segment_bytes, j.max_total_bytes, j.max_segments, j.full_retry_after_s) == (
            1 << 16, 1 << 20, 8, 9.0
        )
        assert r.journal is j and r.writer is w and r._thread is not None and r.interval_s == 0.05
        assert r.supervisor_fn() is None
        # the database goes away before the supervisor starts, so its
        # probes (the first at once, one on every state change) fail too
        failpoints.configure(f"datastore.connect.{eph.datastore.failpoint_scope}=error:1.0")
        sup = eph.datastore.start_supervision(probe_interval_s=3600)
        assert r.supervisor_fn() is sup
        # a spilled upload drains on its own through the running replayer:
        # the supervisor is driven down (the replayer holds while it is
        # down, and only then), so the report stays journaled until the
        # database is back
        for _ in range(sup.down_threshold):
            sup.record_failure()
        assert sup.state == "down"
        assert w.write_report(mkreport(3)) is True and j.depth()[0] == 1
        failpoints.clear()
        sup.record_success()
        deadline = time.monotonic() + 10
        while j.depth()[0] and time.monotonic() < deadline:
            time.sleep(0.01)
        assert j.depth()[0] == 0 and db_report_count(eph.datastore) == 1
    finally:
        agg.close()
    assert r._thread is None and j._fh is None
