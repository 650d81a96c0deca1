"""janus_tpu_torch's upload side held against janus_tpu's.

- The column upload stages (`upload_prepare_columns`,
  `upload_decrypt_validate_batch`) and the per-report ones
  (`upload_prepare`, `upload_decrypt_validate`, which run the column
  stages on a window of one) of a port leader return,
  lane by lane, the error type, message and problem document, or the
  stored report, that janus_tpu's return on the same ReportColumn: a
  window of valid reports with an out-of-range leader share, a bad public
  share, an unknown HPKE config id, a report from the future and an
  expired report. Circuits: Count, Sum, a narrow SumVec, Histogram and
  draft Count (janus_tpu's host code only: nothing is jitted).
  `handle_upload`, with and without the group-commit writer, stores
  janus_tpu's row, and a replay is silent.
- Uploads in both mixed pairings (a janus_tpu client to a port leader, a
  port client to a janus_tpu leader) over loopback HTTP store the rows
  that a janus_tpu client and leader store: the same report ids, times,
  public shares and leader shares (decrypted at rest), and helper
  ciphertexts that open to the same plaintexts. The clients draw their
  report ids and shard randomness from one seeded stream.
- The upload route's answers (status, content type, body, Retry-After)
  equal janus_tpu's for accepted, replayed, rejected, outdated-config,
  too-early, malformed, unknown-task, wrong-media-type and shed uploads.
- Admission and the pipeline shed and commit where janus_tpu's do: the
  token bucket, the watermarks, the rate shed's Retry-After and the spent
  deadline's 503 over the same scripts; the queue-full backstop; a burst
  that sheds 429 yet commits each admitted report once; a client that
  retries through a shed.
- Every upload and ingest field of Config reaches the pipeline, the
  admission controller and the writer as in janus_tpu, and a burst through
  them (the writer's coalescing window on) stores janus_tpu's rows.
- `ReportWriteBatcher`: group commit, a replay returns False, and close
  flushes what is buffered.
- A Poplar1 leader validates the public share with the leader's input
  share in the decrypt stage, as janus_tpu's does: the column stages and
  the upload route answer malformed Poplar1 uploads as janus_tpu's.

The port runs with device="cpu"; tolerance: exact equality.
"""

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from janus_tpu import client as j_client_mod
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.aggregator import core as j_core
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.core import hpke as j_hpke
from janus_tpu.core import time_util as j_time
from janus_tpu.core.http_client import HttpClient as JHttpClient
from janus_tpu.datastore import store as j_store
from janus_tpu.ingest import admission as j_admission
from janus_tpu.vdaf import reference as j_reference
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import client as t_client_mod
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.aggregator.report_writer import ReportWriteBatcher
from janus_tpu_torch.core.http_client import HttpClient
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.datastore.models import LeaderStoredReport
from janus_tpu_torch.ingest import IngestPipeline, ShedError
from janus_tpu_torch.ingest import admission as t_admission
from janus_tpu_torch.task import Task
from janus_tpu_torch.vdaf import reference as t_reference
from janus_tpu_torch.vdaf import registry as t_registry

NOW = 1_700_000_000
CIRCUITS = {
    "count": {"kind": "count"},
    "sum": {"kind": "sum", "bits": 5},
    "sumvec": {"kind": "sumvec", "length": 3, "bits": 2},
    "histogram": {"kind": "histogram", "length": 4},
    "draft-count": {"kind": "count", "xof_mode": "draft"},
}
MEASUREMENTS = {"count": [1, 0, 1], "sum": [3, 17, 31], "sumvec": [[1, 2, 3], [0, 0, 1], [3, 3, 3]],
                "histogram": [0, 3, 2], "draft-count": [0, 1, 1]}
LEADER_INFO = j_hpke.HpkeApplicationInfo(j_hpke.Label.INPUT_SHARE, jm.Role.CLIENT, jm.Role.LEADER)


class _Seeded:
    """A stand-in for the `secrets` module of a client: a seeded stream."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def token_bytes(self, n: int) -> bytes:
        return self.rng.bytes(n)


def seed_clients(monkeypatch, seed: int) -> None:
    """Both packages' clients draw report ids and shard randomness, in the
    same order, from equal seeded streams."""
    for mods in ((j_client_mod, j_reference), (t_client_mod, t_reference)):
        stream = _Seeded(seed)
        for mod in mods:
            monkeypatch.setattr(mod, "secrets", stream)


def leader_task(name: str, **kw):
    """A janus_tpu leader task (HPKE config 0) and the helper's keypair
    (config 1)."""
    vdaf = j_registry.VdafInstance(**CIRCUITS[name])
    task = (
        j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), vdaf, jm.Role.LEADER)
        .with_(vdaf_verify_key=bytes(range(16)), **kw)
        .build()
    )
    return task, j_hpke.generate_hpke_config_and_private_key(config_id=1)


def j_client(task, helper_kp, url="http://leader/", http=None):
    params = j_client_mod.ClientParameters(task.task_id, url, url, task.time_precision)
    return j_client_mod.Client(params, task.vdaf, task.hpke_keys[0].config, helper_kp.config,
                               clock=j_time.MockClock(jm.Time(NOW)), http=http)


def t_client(task, helper_kp, url="http://leader/", http=None):
    t_task = Task.from_dict(task.to_dict())
    params = t_client_mod.ClientParameters(t_task.task_id, url, url, t_task.time_precision)
    return t_client_mod.Client(params, t_task.vdaf, t_task.hpke_keys[0].config,
                               tm.HpkeConfig.from_bytes(helper_kp.config.to_bytes()),
                               clock=MockClock(tm.Time(NOW)), http=http)


def reseal_leader(task, report, mutate):
    """`report` with its leader payload changed by `mutate(bytearray)` and
    sealed again under the task's key."""
    kp = task.hpke_keys[0]
    aad = jm.InputShareAad(task.task_id, report.metadata, report.public_share).to_bytes()
    pt = jm.PlaintextInputShare.from_bytes(j_hpke.hpke_open(kp, LEADER_INFO, report.leader_encrypted_input_share, aad))
    payload = bytearray(pt.payload)
    mutate(payload)
    ct = j_hpke.hpke_seal(kp.config, LEADER_INFO, jm.PlaintextInputShare((), bytes(payload)).to_bytes(), aad)
    return dataclasses.replace(report, leader_encrypted_input_share=ct)


def stored(r):
    return (r.task_id.data, r.report_id.data, r.client_time.seconds, r.public_share, r.leader_input_share,
            r.helper_encrypted_input_share.to_bytes())


def outcome(x):
    if isinstance(x, BaseException):
        return type(x).__name__, str(x), x.problem_document()
    return stored(x)


def upload_window(name: str):
    """A window of uploads, one lane of each reject kind, as wire bytes."""
    task, helper_kp = leader_task(name, report_expiry_age=jm.Duration(3600))
    client = j_client(task, helper_kp)
    meas = MEASUREMENTS[name]
    reports = [client.prepare_report(m) for m in meas * 2]
    field = t_registry.circuit_for(t_registry.VdafInstance(**CIRCUITS[name])).FIELD
    size = field.ENCODED_SIZE

    def out_of_range(p):
        p[:size] = field.MODULUS.to_bytes(size, "little")

    reports[1] = reseal_leader(task, reports[1], out_of_range)
    reports[2] = dataclasses.replace(reports[2], public_share=reports[2].public_share + b"\x00")
    reports[3] = dataclasses.replace(
        reports[3],
        leader_encrypted_input_share=dataclasses.replace(reports[3].leader_encrypted_input_share,
                                                         config_id=jm.HpkeConfigId(99)),
    )
    reports.append(client.prepare_report(meas[0], when=jm.Time(NOW + 30 * 24 * 3600)))  # from the future
    reports.append(client.prepare_report(meas[0], when=jm.Time(NOW - 10 * 3600)))  # expired
    return task, [r.to_bytes() for r in reports]


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_upload_stages_match_janus_tpu_lane_by_lane(name):
    task, bodies = upload_window(name)
    j_ta = j_core.TaskAggregator(task, j_core.Config())
    t_ta = t_core.TaskAggregator(Task.from_dict(task.to_dict()), t_core.Config(), device="cpu")
    j_clock, t_clock = j_time.MockClock(jm.Time(NOW)), MockClock(tm.Time(NOW))

    def columns(ta, clock, col):
        got = ta.upload_prepare_columns(clock, col, list(range(len(bodies))))
        live = [i for i, r in enumerate(got) if not isinstance(r, BaseException)]
        groups = {}
        for i in live:
            groups.setdefault(col.leader_config_ids[i], []).append(i)
        for lanes in groups.values():
            for i, r in zip(lanes, ta.upload_decrypt_validate_batch(col, lanes, got[lanes[0]])):
                got[i] = r
        return [outcome(r) for r in got]

    def per_report(ta, clock, report_cls):
        out = []
        for b in bodies:
            report = report_cls.from_bytes(b)
            try:
                out.append(outcome(ta.upload_decrypt_validate(report, ta.upload_prepare(clock, report))))
            except Exception as e:
                out.append(outcome(e))
        return out

    want = columns(j_ta, j_clock, jm.decode_reports_fast(bodies))
    got = columns(t_ta, t_clock, tm.decode_reports_fast(bodies))
    assert got == want
    assert per_report(t_ta, t_clock, tm.Report) == per_report(j_ta, j_clock, jm.Report)
    kinds = [w[0] if isinstance(w[0], str) else "stored" for w in want]
    assert kinds == ["stored", "ReportRejected", "InvalidMessage", "OutdatedHpkeConfig", "stored", "stored",
                     "ReportTooEarly", "ReportRejected"]


def test_handle_upload_stores_janus_tpu_rows():
    """The single-threaded upload path, with and without the group-commit
    writer: the same stored row as janus_tpu's, and a replay is silent."""
    task, helper_kp = leader_task("sumvec")
    report = j_client(task, helper_kp).prepare_report([1, 2, 3])
    j_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
    t_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
    try:
        j_ta = j_core.TaskAggregator(task, j_core.Config())
        t_ta = t_core.TaskAggregator(Task.from_dict(task.to_dict()), t_core.Config(), device="cpu")
        j_ta.handle_upload(j_eph.datastore, j_eph.clock, report)
        t_report = tm.Report.from_bytes(report.to_bytes())
        writer = ReportWriteBatcher(t_eph.datastore)
        for w in (writer, None, writer):  # the second and third are replays
            t_ta.handle_upload(t_eph.datastore, t_eph.clock, t_report, writer=w)
        writer.close()

        def row(ds, m):
            return stored(ds.run_tx(lambda tx: tx.get_client_report(m.TaskId(task.task_id.data),
                                                                    m.ReportId(report.metadata.report_id.data))))

        assert row(t_eph.datastore, tm) == row(j_eph.datastore, jm)
        assert t_eph.datastore.run_tx(lambda tx: tx._c.execute("SELECT COUNT(*) FROM client_reports").fetchone()) == (1,)
    finally:
        j_eph.cleanup()
        t_eph.cleanup()


# --- uploads over HTTP in both mixed pairings ---------------------------


def _leader_stack(pkg: str, task, cfg=None, max_handler_threads=None):
    """A janus_tpu or port leader Aggregator behind a DapServer on port 0,
    holding `task` (a janus_tpu Task)."""
    if pkg == "jax":
        eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
        agg = j_core.Aggregator(eph.datastore, eph.clock, cfg or j_core.Config())
        srv = j_http.DapServer(j_http.DapHttpApp(agg)).start()
        eph.datastore.run_tx(lambda tx: tx.put_task(task))
    else:
        eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
        agg = t_core.Aggregator(eph.datastore, eph.clock, cfg or t_core.Config(), device="cpu")
        srv = t_http.DapServer(t_http.DapHttpApp(agg), max_handler_threads=max_handler_threads).start()
        eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(task.to_dict())))
    return eph, agg, srv


def client_report_rows(ds, helper_kp):
    """The leader's client_reports: id, time, public share, the leader
    share decrypted at rest, the helper ciphertext's plaintext."""
    def read(tx):
        (tid,) = tx._c.execute("SELECT task_id FROM tasks").fetchone()
        ids = [r[0] for r in tx._c.execute("SELECT report_id FROM client_reports ORDER BY report_id")]
        return [tx.get_client_report(tm.TaskId(tid), tm.ReportId(rid)) for rid in ids]

    out = []
    for r in ds.run_tx(read):
        aad = jm.InputShareAad(jm.TaskId(r.task_id.data), jm.ReportMetadata(jm.ReportId(r.report_id.data),
                               jm.Time(r.client_time.seconds)), r.public_share).to_bytes()
        ct = jm.HpkeCiphertext.from_bytes(r.helper_encrypted_input_share.to_bytes())
        info = j_hpke.HpkeApplicationInfo(j_hpke.Label.INPUT_SHARE, jm.Role.CLIENT, jm.Role.HELPER)
        out.append((r.report_id.data, r.client_time.seconds, r.public_share, r.leader_input_share,
                    j_hpke.hpke_open(helper_kp, info, ct, aad)))
    return out


_PAIRING_CACHE = {}


def run_pairing(monkeypatch, name: str, client_pkg: str, leader_pkg: str):
    task, helper_kp = _PAIRING_CACHE.setdefault(("task", name), leader_task(name))
    seed_clients(monkeypatch, 11)
    eph, agg, srv = _leader_stack(leader_pkg, task)
    try:
        make = j_client if client_pkg == "jax" else t_client
        client = make(task, helper_kp, srv.url, JHttpClient() if client_pkg == "jax" else HttpClient())
        for m in MEASUREMENTS[name]:
            client.upload(m)
        return client_report_rows(eph.datastore, helper_kp)
    finally:
        srv.stop()
        eph.cleanup()


@pytest.mark.parametrize("pairing", ["jax-torch", "torch-jax"])
@pytest.mark.parametrize("name", ["count", "sumvec", "draft-count"])
def test_mixed_pairings_store_janus_tpu_rows(monkeypatch, name, pairing):
    if ("ref", name) not in _PAIRING_CACHE:
        _PAIRING_CACHE[("ref", name)] = run_pairing(monkeypatch, name, "jax", "jax")
    want = _PAIRING_CACHE[("ref", name)]
    got = run_pairing(monkeypatch, name, *pairing.split("-"))
    assert len(want) == len(MEASUREMENTS[name])
    assert got == want


# --- the upload route's answers ----------------------------------------


UPLOAD_CASES = ["accepted", "replayed", "rejected", "outdated-config", "too-early", "bad-public-share", "undecodable",
                "unknown-task", "media-type", "shed"]


@pytest.fixture(scope="module")
def upload_apps():
    """janus_tpu and port leader apps over one task: `plain` without
    buckets, `bucket` with an upload bucket of burst 1 that barely
    refills."""
    task, helper_kp = leader_task("count")
    made, apps = [], {}
    for kind, kw in (("plain", {}), ("bucket", {"upload_bucket_rate": 0.001, "upload_bucket_burst": 1})):
        j_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
        t_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
        j_eph.datastore.run_tx(lambda tx: tx.put_task(task))
        t_eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(task.to_dict())))
        j_app = j_http.DapHttpApp(j_core.Aggregator(j_eph.datastore, j_eph.clock, j_core.Config(**kw)))
        t_app = t_http.DapHttpApp(t_core.Aggregator(t_eph.datastore, t_eph.clock, t_core.Config(**kw), device="cpu"))
        apps[kind] = (j_app, t_app)
        made += [(j_app, j_eph), (t_app, t_eph)]
    yield task, helper_kp, apps
    for app, eph in made:
        app.close()
        app.agg.close()
        eph.cleanup()


@pytest.mark.parametrize("case", UPLOAD_CASES)
def test_upload_route_answers_match_janus_tpu(upload_apps, case):
    task, helper_kp, apps = upload_apps
    client = j_client(task, helper_kp)
    report = client.prepare_report(1)
    j_app, t_app = apps["bucket" if case == "shed" else "plain"]
    tid = task.task_id.data
    headers = {"Content-Type": jm.Report.MEDIA_TYPE}
    if case == "rejected":
        report = reseal_leader(task, report, lambda p: p.__setitem__(slice(0, 8), (2**64 - 1).to_bytes(8, "little")))
    elif case == "outdated-config":
        report = dataclasses.replace(report, leader_encrypted_input_share=dataclasses.replace(
            report.leader_encrypted_input_share, config_id=jm.HpkeConfigId(7)))
    elif case == "too-early":
        report = client.prepare_report(1, when=jm.Time(NOW + 7200))
    elif case == "bad-public-share":
        report = dataclasses.replace(report, public_share=b"\x01")
    elif case == "unknown-task":
        tid = bytes(32)
    elif case == "media-type":
        headers["Content-Type"] = "application/octet-stream"
    body = b"\x00\x01" if case == "undecodable" else report.to_bytes()
    path = f"/tasks/{t_client_mod.b64url(tid)}/reports"
    sends = 2 if case in ("replayed", "shed") else 1
    for _ in range(sends):
        want = j_app.handle("PUT", path, {}, dict(headers), body)
        got = t_app.handle("PUT", path, {}, dict(headers), body)
    assert got == want
    assert got[0] == {"accepted": 201, "replayed": 201, "shed": 429}.get(case, 400)
    if case == "shed":
        assert got[3] == {"Retry-After": str(int(got[3]["Retry-After"]))} and int(got[3]["Retry-After"]) >= 1


def test_poplar1_upload_validation_matches_janus_tpu():
    """A Poplar1(4) leader validates the public share with the leader's
    input share in the decrypt stage, as janus_tpu's does: the column
    stages and the route answer a window of a valid report, a truncated
    and a malformed public share, a leader share with an out-of-range
    correlated-randomness element and one of the wrong length, lane by
    lane, as janus_tpu's."""
    from janus_tpu.vdaf import poplar1 as jp

    vdaf = j_registry.VdafInstance.poplar1(4)
    task = (j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), vdaf, jm.Role.LEADER)
            .with_(vdaf_verify_key=bytes(range(16))).build())
    helper_kp = j_hpke.generate_hpke_config_and_private_key(config_id=1)
    client = j_client(task, helper_kp)
    reports = [client.prepare_report(m) for m in (0b1010, 0b0110, 0b0001, 0b1111, 0b0011)]
    reports[1] = dataclasses.replace(reports[1], public_share=reports[1].public_share[:-1])
    bad_ctrl = bytearray(reports[2].public_share)
    bad_ctrl[16] = 7  # the first level's control byte
    reports[2] = dataclasses.replace(reports[2], public_share=bytes(bad_ctrl))
    reports[3] = reseal_leader(task, reports[3], lambda p: p.__setitem__(
        slice(16, 24), jp.Idpf(4).field_at(0).MODULUS.to_bytes(8, "little")))
    reports[4] = reseal_leader(task, reports[4], lambda p: p.extend(b"\x00"))
    bodies = [r.to_bytes() for r in reports]

    j_ta = j_core.TaskAggregator(task, j_core.Config())
    t_ta = t_core.TaskAggregator(Task.from_dict(task.to_dict()), t_core.Config(), device="cpu")

    def columns(ta, clock, col):
        got = ta.upload_prepare_columns(clock, col, list(range(len(bodies))))
        live = [i for i, r in enumerate(got) if not isinstance(r, BaseException)]
        for i, r in zip(live, ta.upload_decrypt_validate_batch(col, live, got[live[0]])):
            got[i] = r
        return [outcome(r) for r in got]

    want = columns(j_ta, j_time.MockClock(jm.Time(NOW)), jm.decode_reports_fast(bodies))
    assert columns(t_ta, MockClock(tm.Time(NOW)), tm.decode_reports_fast(bodies)) == want
    assert [w[0] if isinstance(w[0], str) else "stored" for w in want] == ["stored"] + ["ReportRejected"] * 4

    # the route: janus_tpu's status and problem document for each
    j_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
    t_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
    j_eph.datastore.run_tx(lambda tx: tx.put_task(task))
    t_eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(task.to_dict())))
    apps = [j_http.DapHttpApp(j_core.Aggregator(j_eph.datastore, j_eph.clock, j_core.Config())),
            t_http.DapHttpApp(t_core.Aggregator(t_eph.datastore, t_eph.clock, t_core.Config(), device="cpu"))]
    try:
        path = f"/tasks/{t_client_mod.b64url(task.task_id.data)}/reports"
        headers = {"Content-Type": jm.Report.MEDIA_TYPE}
        answers = [[app.handle("PUT", path, {}, dict(headers), b) for b in bodies] for app in apps]
        assert answers[1] == answers[0]
        assert [a[0] for a in answers[0]] == [201, 400, 400, 400, 400]
        assert all(b"reportRejected" in a[2] for a in answers[0][1:])
    finally:
        for app, eph in zip(apps, (j_eph, t_eph)):
            app.close()
            app.agg.close()
            eph.cleanup()


# --- admission and the pipeline -----------------------------------------


def _admission_script(adm, case: str):
    """The same script of admission calls; the outcomes in order."""
    out = []

    def admit(cls, **kw):
        try:
            ctl.admit(cls, **kw)
            out.append("ok")
        except adm.ShedError as e:
            out.append((e.route_class, e.reason, e.status, round(e.retry_after_s, 6)))

    if case == "bucket":
        now = [0.0]
        bucket = adm.TokenBucket(rate=2.0, burst=3, clock=lambda: now[0])
        out += [bucket.try_acquire() for _ in range(4)]
        now[0] += 0.5
        out += [bucket.try_acquire(), bucket.try_acquire()]
        return out
    if case == "watermarks":
        depth = {"v": (0, 100)}
        ctl = adm.AdmissionController(adm.AdmissionConfig(queue_high_watermark=0.75), depth_fn=lambda: depth["v"])
        for d in (74, 80, 95):
            depth["v"] = (d, 100)
            admit("upload")
            admit("aggregate")
        return out
    if case == "rate":
        ctl = adm.AdmissionController(adm.AdmissionConfig(upload_bucket_rate=0.5, upload_bucket_burst=1))
        admit("upload")
        admit("upload")
        admit("aggregate")
        out[1] = out[1][:3] + (1.0 <= out[1][3] <= 2.1,)
        return out
    ctl = adm.AdmissionController(adm.AdmissionConfig())
    admit("aggregate", deadline=time.monotonic() - 1.0)
    admit("upload", deadline=time.monotonic() + 60.0)
    return out


@pytest.mark.parametrize("case,want", [
    ("bucket", [0.0, 0.0, 0.0, 0.5, 0.0, 0.5]),
    ("watermarks", ["ok", "ok", ("upload", "queue", 429, 1.0), "ok", ("upload", "queue", 429, 1.0),
                    ("aggregate", "queue", 429, 1.0)]),
    ("rate", ["ok", ("upload", "rate", 429, True), "ok"]),
    ("deadline", [("aggregate", "deadline_expired", 503, 1.0), "ok"]),
])
def test_admission_sheds_where_janus_tpu_sheds(case, want):
    got = _admission_script(t_admission, case)
    assert got == _admission_script(j_admission, case)
    assert got == pytest.approx(want) if case == "bucket" else got == want


def test_pipeline_queue_full_backstop_sheds():
    """With the decode stage wedged, submits beyond queue_depth raise
    ShedError instead of blocking or growing queues without bound."""
    raw = tm.Report(tm.ReportMetadata(tm.ReportId(bytes(16)), tm.Time(0)), b"",
                    tm.HpkeCiphertext(tm.HpkeConfigId(0), b"", b""), tm.HpkeCiphertext(tm.HpkeConfigId(0), b"", b"")
                    ).to_bytes()
    gate = threading.Event()

    class _StuckTa:
        def upload_prepare_columns(self, clock, col, idxs):
            gate.wait(10)
            return [RuntimeError("never admitted") for _ in idxs]

    class _Writer:
        def submit_report(self, report, on_done=None):
            raise AssertionError("unreachable")

    pipe = IngestPipeline(_Writer(), decrypt_workers=1, queue_depth=2, batch_window=1)
    try:
        tickets = [pipe.submit(_StuckTa(), None, raw) for _ in range(2)]
        with pytest.raises(ShedError) as ei:
            pipe.submit(_StuckTa(), None, raw)
        assert ei.value.reason == "queue_full" and pipe.depth() == (2, 2)
        gate.set()
        for t in tickets:
            with pytest.raises(RuntimeError, match="never admitted"):
                t.result(timeout_s=10)
        assert pipe.depth() == (0, 2)
    finally:
        gate.set()
        pipe.close()


def _port_leader(cfg, max_handler_threads=None):
    task, helper_kp = leader_task("count")
    return (task, helper_kp, *_leader_stack("torch", task, cfg, max_handler_threads))


def test_upload_burst_sheds_429_and_admitted_commit_exactly_once():
    """A burst above the bucket's capacity: every request answers 201 or
    429 + Retry-After, exactly `burst` reports commit, once, and the
    handler threads stay within their bound."""
    task, helper_kp, eph, agg, srv = _port_leader(
        t_core.Config(upload_bucket_rate=0.001, upload_bucket_burst=4, ingest_queue_depth=32), max_handler_threads=4
    )
    try:
        client = t_client(task, helper_kp, srv.url)
        reports = [client.prepare_report(1) for _ in range(12)]

        def put(report):
            http = HttpClient()
            status, body = http.put(client.params.upload_uri(), report.to_bytes(),
                                    {"Content-Type": tm.Report.MEDIA_TYPE})
            ra = next((v for k, v in http.last_response_headers.items() if k.lower() == "retry-after"), None)
            return status, ra, body

        with ThreadPoolExecutor(max_workers=12) as pool:
            results = list(pool.map(put, reports))
        statuses = [s for s, _, _ in results]
        assert sorted(set(statuses)) == [201, 429] and statuses.count(201) == 4
        for status, ra, body in results:
            if status == 429:
                assert ra is not None and int(ra) >= 1 and b"429" in body
        assert eph.datastore.run_tx(lambda tx: tx._c.execute("SELECT COUNT(*) FROM client_reports").fetchone()) == (4,)
        handlers = [t.name for t in threading.enumerate() if t.name.startswith("dap-handler")]
        assert 0 < len(handlers) <= 4, handlers
    finally:
        srv.stop()
        agg.close()
        eph.cleanup()


def test_client_upload_retries_through_shed_then_succeeds():
    """The port's Client retries a shed upload after the advertised delay
    and lands it once the bucket refills."""
    task, helper_kp, eph, agg, srv = _port_leader(
        t_core.Config(upload_bucket_rate=5.0, upload_bucket_burst=1, upload_shed_retry_after_s=1.0)
    )
    try:
        client = t_client(task, helper_kp, srv.url, HttpClient())
        client.upload(1)  # takes the burst token
        client.upload(0)  # sheds once, then lands
        rows = eph.datastore.run_tx(lambda tx: tx._c.execute("SELECT COUNT(*) FROM client_reports").fetchone())
        assert rows == (2,)
    finally:
        srv.stop()
        agg.close()
        eph.cleanup()


# Every upload and ingest field of Config, each away from its default.
KNOBS = dict(ingest_decrypt_workers=2, ingest_decode_workers=2, ingest_batch_window=4, ingest_batch_linger_ms=5.0,
             ingest_queue_depth=16, upload_bucket_rate=1000.0, upload_bucket_burst=64, aggregate_bucket_rate=0.001,
             aggregate_bucket_burst=1, shed_priority=("aggregate", "upload"), queue_high_watermark=0.5,
             upload_shed_retry_after_s=2.0, max_upload_batch_size=8, max_upload_batch_write_delay_ms=50)


def test_config_knobs_reach_ingest_admission_and_writer_as_in_janus_tpu():
    """With every upload and ingest field of Config set, the pipeline, the
    admission controller and the group-commit writer that the app builds
    carry janus_tpu's values; a concurrent burst of uploads through them
    (two decode and two decrypt workers, windows of 4, the writer's
    coalescing window on) stores janus_tpu's rows; and the aggregate
    route's bucket sheds the second request as janus_tpu's does."""
    task, helper_kp = leader_task("sumvec")
    client = j_client(task, helper_kp)
    bodies = [client.prepare_report(m).to_bytes() for m in ([1, 2, 3], [0, 0, 1], [3, 3, 3], [2, 1, 0]) * 2]
    upload_path = f"/tasks/{t_client_mod.b64url(task.task_id.data)}/reports"
    agg_path = f"/tasks/{t_client_mod.b64url(bytes(32))}/aggregation_jobs/{t_client_mod.b64url(bytes(16))}"
    agg_headers = {"Content-Type": jm.AggregationJobInitializeReq.MEDIA_TYPE}
    agg_body = jm.AggregationJobInitializeReq(b"", jm.PartialBatchSelector.time_interval(), ()).to_bytes()
    seen = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
            eph.datastore.run_tx(lambda tx: tx.put_task(task))
            agg = j_core.Aggregator(eph.datastore, eph.clock, j_core.Config(**KNOBS))
            app = j_http.DapHttpApp(agg)
        else:
            eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
            eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(task.to_dict())))
            agg = t_core.Aggregator(eph.datastore, eph.clock, t_core.Config(**KNOBS), device="cpu")
            app = t_http.DapHttpApp(agg)
        try:
            pipe, adm = app._ensure_ingest()
            w = agg.report_writer
            knobs = ((pipe.decrypt_workers, pipe.decode_workers, pipe.batch_window, pipe.batch_linger_s,
                      pipe.queue_depth), dataclasses.asdict(adm.cfg), adm.watermark("upload"),
                     adm.watermark("aggregate"), (w.max_batch_size, w.max_write_delay_s))
            with ThreadPoolExecutor(max_workers=8) as pool:
                statuses = list(pool.map(
                    lambda b: app.handle("PUT", upload_path, {}, {"Content-Type": jm.Report.MEDIA_TYPE}, b)[0], bodies))
            m = jm if pkg == "jax" else tm
            rows = eph.datastore.run_tx(lambda tx: [
                stored(tx.get_client_report(m.TaskId(task.task_id.data), m.ReportId(m.Report.from_bytes(b).metadata.report_id.data)))
                for b in bodies
            ])
            sheds = [app.handle("PUT", agg_path, {}, dict(agg_headers), agg_body) for _ in range(2)]
            seen[pkg] = (knobs, statuses, rows, sheds)
        finally:
            app.close()
            agg.close()
            eph.cleanup()
    assert seen["torch"] == seen["jax"]
    knobs, statuses, rows, sheds = seen["torch"]
    assert knobs[0] == (2, 2, 4, 0.005, 16) and knobs[2:] == (0.75, 0.5, (8, 0.05))
    assert statuses == [201] * 8 and len(set(rows)) == 8
    assert sheds[0][0] == 400 and sheds[1][0] == 429 and sheds[1][3] == {"Retry-After": "1000"}


# --- the group-commit writer --------------------------------------------


def _stored_report(task_id, i: int) -> LeaderStoredReport:
    return LeaderStoredReport(task_id, tm.ReportId(i.to_bytes(16, "big")), tm.Time(NOW), b"", b"share",
                              tm.HpkeCiphertext(tm.HpkeConfigId(1), b"enc", b"ct"))


@pytest.fixture()
def writer_ds():
    eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
    task = Task.from_dict(leader_task("count")[0].to_dict())
    eph.datastore.run_tx(lambda tx: tx.put_task(task))
    yield task, eph.datastore
    eph.cleanup()


def test_report_writer_group_commits_and_a_replay_returns_false(writer_ds, monkeypatch):
    task, ds = writer_ds
    txs = []
    run_tx = ds.run_tx

    def counting(fn, name="tx"):
        txs.append(name)
        return run_tx(fn, name)

    monkeypatch.setattr(ds, "run_tx", counting)
    writer = ReportWriteBatcher(ds, max_batch_size=100, max_write_delay_ms=200)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            fresh = list(pool.map(lambda i: writer.write_report(_stored_report(task.task_id, i)), range(16)))
        assert fresh == [True] * 16
        assert 1 <= txs.count("upload_batch") < 16  # the window coalesced the burst
        assert writer.write_report(_stored_report(task.task_id, 3)) is False
        assert writer.stage_seconds["commit"] > 0
    finally:
        writer.close()
    assert ds.run_tx(lambda tx: tx._c.execute("SELECT COUNT(*) FROM client_reports").fetchone()) == (16,)


def test_report_writer_close_flushes_what_is_buffered(writer_ds):
    task, ds = writer_ds
    writer = ReportWriteBatcher(ds, max_batch_size=100, max_write_delay_ms=60_000)
    pending = [writer.submit_report(_stored_report(task.task_id, i)) for i in range(5)]
    time.sleep(0.05)
    assert not any(p.event.is_set() for p in pending)  # still inside the coalescing window
    writer.close()
    assert all(p.event.is_set() and p.fresh for p in pending)
    assert ds.run_tx(lambda tx: tx._c.execute("SELECT COUNT(*) FROM client_reports").fetchone()) == (5,)
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit_report(_stored_report(task.task_id, 9))
