"""The port's operator tools (janus_tpu_torch/tools/) held against
janus_tpu's (janus_tpu/tools/ and scripts/scrape_check.py) on the same
inputs, on the CPU:

- hpke_keygen: each package's keypair opens what the other package's
  hpke_seal seals under its config;
- dap_decode: for each of the nine media types, the same bytes print the
  same text;
- collect: the argument checks raise in both; end to end over a port
  leader/helper pair, a time-interval and a current-batch collection
  print the ground truth;
- gen_alert_rules: the rules after the header are janus_tpu's byte for
  byte and parse to docs/alerts/janus-alerts.yaml's groups; `--check`
  passes on that file and fails on a stale one;
- report_trace: both tools' `--json` documents are equal on the same
  port-written SQLite file and journal directory (a collected, a
  rejected and an unknown report; a journal frame with and without
  `--datastore-keys`);
- debug_bundle: the redaction cases of tests/test_tools.py; both tools'
  bundles of the port's health listener hold the same file names;
- scrape_check: rc 0 against a port listener whose process owns a
  datastore (so the `ledger` section is there), rc 1 with "missing the
  ledger section" against one whose process owns none; and both
  checkers, on a stub listener serving that listener's documents, pass
  them with janus_tpu's named keys added and reject each planted fault
  (a family, an exposition line, build_info, a section, an endpoint)
  with the same error.

Divergences by design, named where tested: the port's scrape_check reads
janus_build_info's `torch` label where janus_tpu's reads `jax` (and the
watchdog's `device_down` for `host_only`), and its gen_alert_rules header
names the port's generator. Both debug bundles inventory a shape manifest
(`--shape-manifest`/`--aot-dir`), and both checkers require the
`engine_prewarm` section.

Everything runs on one module-scoped port pair (device="cpu") and one
health listener; tolerance: exact equality.
"""

import base64
import dataclasses
import io
import json
import secrets
import tarfile
import threading
import time
from contextlib import contextmanager, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import yaml

from janus_tpu import messages as jm
from janus_tpu.core import hpke as j_hpke
from janus_tpu.tools import collect as j_collect
from janus_tpu.tools import dap_decode as j_dap_decode
from janus_tpu.tools import debug_bundle as j_debug_bundle
from janus_tpu.tools import gen_alert_rules as j_gen_alert_rules
from janus_tpu.tools import hpke_keygen as j_hpke_keygen
from janus_tpu.tools import report_trace as j_report_trace
from janus_tpu_torch.core import hpke as t_hpke
from janus_tpu_torch.tools import (
    collect,
    dap_decode,
    debug_bundle,
    gen_alert_rules,
    hpke_keygen,
    report_trace,
    scrape_check,
)

REPO = Path(__file__).resolve().parent.parent
ALERTS = REPO / "docs" / "alerts" / "janus-alerts.yaml"


def b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def keygen_lines(main, capsys, config_id: int) -> dict:
    assert main([str(config_id)]) == 0
    return dict(line.split(": ") for line in capsys.readouterr().out.strip().splitlines())


# --- hpke_keygen -----------------------------------------------------------


@pytest.mark.parametrize("opener", ["port", "janus_tpu"])
def test_hpke_keygen_keypair_opens_the_other_packages_seal(capsys, opener):
    """The port's keypair opens janus_tpu's seal under its config, and
    janus_tpu's keypair opens the port's seal."""
    from janus_tpu_torch import messages as tm

    # (keygen and open, msgs) of the opening package; the other seals
    if opener == "port":
        gen, open_hpke, open_msgs, seal_hpke, seal_msgs = hpke_keygen.main, t_hpke, tm, j_hpke, jm
    else:
        gen, open_hpke, open_msgs, seal_hpke, seal_msgs = j_hpke_keygen.main, j_hpke, jm, t_hpke, tm
    out = keygen_lines(gen, capsys, 7)
    assert set(out) == {"hpke_config", "private_key"}
    seal_cfg = seal_msgs.HpkeConfig.from_bytes(unb64(out["hpke_config"]))
    assert seal_cfg.id.id == 7
    ct = seal_hpke.hpke_seal(
        seal_cfg,
        seal_hpke.HpkeApplicationInfo(seal_hpke.Label.AGGREGATE_SHARE, seal_msgs.Role.HELPER, seal_msgs.Role.COLLECTOR),
        b"payload", b"aad",
    )
    kp = open_hpke.HpkeKeypair(open_msgs.HpkeConfig.from_bytes(unb64(out["hpke_config"])), unb64(out["private_key"]))
    info = open_hpke.HpkeApplicationInfo(open_hpke.Label.AGGREGATE_SHARE, open_msgs.Role.HELPER, open_msgs.Role.COLLECTOR)
    assert open_hpke.hpke_open(kp, info, open_msgs.HpkeCiphertext.from_bytes(ct.to_bytes()), b"aad") == b"payload"


def test_hpke_keygen_refuses_an_id_out_of_range():
    for main in (hpke_keygen.main, j_hpke_keygen.main):
        with pytest.raises(SystemExit):
            main(["256"])


# --- dap_decode ------------------------------------------------------------


def _messages() -> dict:
    """One message of each media type, made with janus_tpu's codecs from
    a seeded stream."""
    from janus_tpu.vdaf.wire import PP_CONTINUE, PP_INITIALIZE, encode_pingpong

    rng = np.random.default_rng(19)

    def raw(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    cfg = jm.HpkeConfig(
        jm.HpkeConfigId(7), jm.HpkeKemId.X25519_HKDF_SHA256, jm.HpkeKdfId.HKDF_SHA256,
        jm.HpkeAeadId.AES_128_GCM, raw(32),
    )
    meta = jm.ReportMetadata(jm.ReportId(raw(16)), jm.Time(1_700_000_000))
    ct = jm.HpkeCiphertext(jm.HpkeConfigId(1), raw(32), raw(48))
    iv = jm.Interval(jm.Time(1_699_999_200), jm.Duration(3600))
    bid = jm.BatchId(raw(32))
    init = jm.PrepareInit(jm.ReportShare(meta, raw(12), ct), encode_pingpong(PP_INITIALIZE, None, raw(40)))
    return {
        "hpke-config-list": jm.HpkeConfigList((cfg, cfg)),
        "report": jm.Report(meta, raw(20), ct, ct),
        "aggregation-job-init-req": jm.AggregationJobInitializeReq(
            b"", jm.PartialBatchSelector.fixed_size(bid), (init, init)
        ),
        "aggregation-job-continue-req": jm.AggregationJobContinueReq(
            jm.AggregationJobStep(1), (jm.PrepareContinue(meta.report_id, encode_pingpong(PP_INITIALIZE, None, raw(24))),)
        ),
        "aggregation-job-resp": jm.AggregationJobResp((
            jm.PrepareResp(meta.report_id, jm.PrepareStepResult.cont(encode_pingpong(PP_CONTINUE, raw(8), raw(16)))),
            jm.PrepareResp(meta.report_id, jm.PrepareStepResult.finished()),
            jm.PrepareResp(meta.report_id, jm.PrepareStepResult.reject(jm.PrepareError.VDAF_PREP_ERROR)),
        )),
        "aggregate-share-req": jm.AggregateShareReq(
            jm.BatchSelector.time_interval(iv), b"", 5, jm.ReportIdChecksum(raw(32))
        ),
        "aggregate-share": jm.AggregateShare(ct),
        "collect-req": jm.CollectionReq(jm.Query.fixed_size(jm.FixedSizeQuery(jm.FixedSizeQuery.BY_BATCH_ID, bid)),
                                        b"param"),
        "collection": jm.Collection(jm.PartialBatchSelector.time_interval(), 5, iv, ct, ct),
    }


def test_dap_decode_covers_janus_tpus_media_types():
    assert set(dap_decode.MEDIA_TYPES) == set(j_dap_decode.MEDIA_TYPES) == set(_messages())
    assert {k: v.__name__ for k, v in dap_decode.MEDIA_TYPES.items()} == {
        k: v.__name__ for k, v in j_dap_decode.MEDIA_TYPES.items()
    }


@pytest.mark.parametrize("media_type", sorted(j_dap_decode.MEDIA_TYPES))
def test_dap_decode_prints_janus_tpus_text(tmp_path, capsys, media_type):
    path = tmp_path / "msg.bin"
    path.write_bytes(_messages()[media_type].to_bytes())
    assert j_dap_decode.main([str(path), "--media-type", media_type]) == 0
    want = capsys.readouterr().out
    assert dap_decode.main([str(path), "-t", media_type]) == 0
    got = capsys.readouterr().out
    assert got == want and got.strip()


# --- the port pair the collect, report_trace, debug_bundle and
# scrape_check tests read ---------------------------------------------------


@dataclasses.dataclass
class Pair:
    tmp: Path
    key: bytes
    leader_db: str
    leader_ds: object
    leader_url: str
    interval_task: object
    fixed_task: object
    collector_kp: object
    accepted_id: object
    rejected_id: object
    spilled_id: object
    journal_dir: str
    drive: object
    collected: dict = dataclasses.field(default_factory=dict)


def _corrupt(task, report):
    """`report` with its leader measurement share plus 1: a well-formed
    upload the prepare rejects (vdaf_prep_error)."""
    from janus_tpu_torch.core.hpke import HpkeApplicationInfo, Label, hpke_open, hpke_seal
    from janus_tpu_torch.messages import InputShareAad, PlaintextInputShare, Report, Role
    from janus_tpu_torch.vdaf.registry import circuit_for

    info = HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER)
    aad = InputShareAad(task.task_id, report.metadata, report.public_share).to_bytes()
    payload = bytearray(PlaintextInputShare.from_bytes(
        hpke_open(task.hpke_keys[0], info, report.leader_encrypted_input_share, aad)
    ).payload)
    field = circuit_for(task.vdaf).FIELD
    size = field.ENCODED_SIZE
    payload[:size] = ((int.from_bytes(payload[:size], "little") + 1) % field.MODULUS).to_bytes(size, "little")
    sealed = hpke_seal(task.hpke_keys[0].config, info, PlaintextInputShare((), bytes(payload)).to_bytes(), aad)
    return Report(report.metadata, report.public_share, sealed, report.helper_encrypted_input_share)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A port leader and helper over loopback HTTP (device="cpu"), the
    leader's store a SQLite file under one known key. Two Count tasks: a
    time-interval one with four reports and one corrupted, aggregated
    (its collection is left to the collect test), and a fixed-size one
    with three reports. Beside them, a journal directory holding one
    spilled frame of the interval task."""
    from janus_tpu_torch.aggregator.aggregation_job_creator import (
        AggregationJobCreator,
        AggregationJobCreatorConfig,
    )
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver
    from janus_tpu_torch.aggregator.core import Aggregator, Config
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.time_util import RealClock
    from janus_tpu_torch.datastore.models import LeaderStoredReport
    from janus_tpu_torch.datastore.store import Crypter, Datastore
    from janus_tpu_torch.ingest.journal import UploadJournal
    from janus_tpu_torch.messages import HpkeCiphertext, HpkeConfigId, Report, ReportId, Role
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
    from janus_tpu_torch.vdaf.registry import VdafInstance

    tmp = tmp_path_factory.mktemp("tools")
    key = secrets.token_bytes(16)
    clock = RealClock()
    leader_db = str(tmp / "leader.sqlite")
    leader_ds = Datastore(leader_db, Crypter([key]), clock)
    helper_ds = Datastore(str(tmp / "helper.sqlite"), Crypter([key]), clock)
    helper_srv = DapServer(DapHttpApp(Aggregator(helper_ds, clock, Config(), device="cpu"))).start()
    leader_srv = DapServer(DapHttpApp(Aggregator(leader_ds, clock, Config(collection_retry_after_s=1),
                                                 device="cpu"))).start()
    http = HttpClient()
    collector_kp = generate_hpke_config_and_private_key(config_id=200)
    vdaf = VdafInstance.count()
    tasks = []
    for qt in (QueryTypeConfig.time_interval(), QueryTypeConfig.fixed_size(max_batch_size=3)):
        leader_task = TaskBuilder(qt, vdaf, Role.LEADER).with_(
            leader_aggregator_endpoint=leader_srv.url, helper_aggregator_endpoint=helper_srv.url,
            collector_hpke_config=collector_kp.config, collector_auth_token=AuthenticationToken.random_bearer(),
            min_batch_size=1,
        ).build()
        helper_task = dataclasses.replace(
            leader_task, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
        )
        leader_ds.run_tx(lambda tx: tx.put_task(leader_task))
        helper_ds.run_tx(lambda tx: tx.put_task(helper_task))
        tasks.append(leader_task)
    interval_task, fixed_task = tasks

    def put(params, report):
        status, body = http.put(params.upload_uri(), report.to_bytes(), {"Content-Type": Report.MEDIA_TYPE})
        assert status == 201, (status, body)

    ids = []
    for task, meas in ((interval_task, [1, 1, 0, 1]), (fixed_task, [1, 0, 1])):
        params = ClientParameters(task.task_id, leader_srv.url, helper_srv.url, task.time_precision)
        client = Client.with_fetched_configs(params, vdaf, http, clock=clock)
        for m in meas:
            report = client.prepare_report(m)
            put(params, report)
            ids.append(report.metadata.report_id)
        if task is interval_task:
            rejected = client.prepare_report(1)
            put(params, _corrupt(task, rejected))
    AggregationJobCreator(
        leader_ds, AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=100)
    ).run_once()
    drv = AggregationJobDriver(leader_ds, http, device="cpu")
    jd = JobDriver(JobDriverConfig(), drv.acquirer(), drv.stepper)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        jd.run_once()
        counts = leader_ds.run_tx(lambda tx: tx.count_jobs_by_state())
        if counts.get(("aggregation", "in_progress"), 0) == 0:
            break
    assert counts.get(("aggregation", "finished"), 0) == 2, counts

    # a spilled, never-replayed upload of the interval task
    journal_dir = tmp / "upload-journal"
    journal = UploadJournal(str(journal_dir), Crypter([key]))
    spilled_id = ReportId(secrets.token_bytes(16))
    journal.append_batch([LeaderStoredReport(
        interval_task.task_id, spilled_id, clock.now().to_batch_interval_start(interval_task.time_precision),
        b"public", b"leader share", HpkeCiphertext(HpkeConfigId(1), b"enc", b"payload"),
    )])
    journal.close()

    @contextmanager
    def drive():
        """The collection job driver stepping in a thread meanwhile."""
        from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver

        cdrv = CollectionJobDriver(leader_ds, http)
        cjd = JobDriver(JobDriverConfig(), cdrv.acquirer(), cdrv.stepper)
        stop = threading.Event()
        t = threading.Thread(target=lambda: [cjd.run_once() for _ in iter(lambda: stop.wait(0.2), True)],
                             daemon=True)
        t.start()
        try:
            yield
        finally:
            stop.set()
            t.join(timeout=10)

    try:
        yield Pair(tmp, key, leader_db, leader_ds, leader_srv.url, interval_task, fixed_task, collector_kp,
                   ids[0], rejected.metadata.report_id, spilled_id, str(journal_dir), drive)
    finally:
        leader_srv.stop()
        helper_srv.stop()
        for srv in (leader_srv, helper_srv):
            srv.app.agg.close()
        leader_ds.close()
        helper_ds.close()


# --- collect ---------------------------------------------------------------

BASE = [
    "--task-id", "x", "--leader", "http://l/",
    "--authorization-bearer-token", "t",
    "--hpke-config", "x", "--hpke-private-key", "x",
    "--current-batch",
]


@pytest.mark.parametrize("extra", [
    ["--vdaf", "sum"],  # missing --bits
    ["--vdaf", "histogram"],  # missing --length
    ["--vdaf", "fixedpoint16vec"],  # missing --length
    ["--vdaf", "sumvec", "--bits", "8"],  # missing --length
    ["--vdaf", "countvec"],  # missing --length
    ["--vdaf", "poplar1"],  # no such choice in either tool
], ids=lambda e: "-".join(e[1:]))
def test_collect_arg_validation_raises_in_both(extra):
    for main in (collect.main, j_collect.main):
        with pytest.raises(SystemExit):
            main(BASE + extra)


def test_collect_parser_has_janus_tpus_choices():
    def choices(p):
        return {a.dest: (a.choices, a.required, a.default) for a in p._actions}

    assert choices(collect.build_parser()) == choices(j_collect.build_parser())


def _collect_args(pair, task) -> list:
    return [
        "--task-id=" + b64(task.task_id.data),
        "--leader", pair.leader_url,
        "--authorization-bearer-token=" + task.collector_auth_token.token,
        "--hpke-config=" + b64(pair.collector_kp.config.to_bytes()),
        "--hpke-private-key=" + b64(pair.collector_kp.private_key),
        "--vdaf", "count",
        "--timeout", "60",
    ]


def _run_collect(pair, query: str) -> list:
    """The collect tool's lines for one query of the pair, run once (a
    second collection of the same batch would be refused as an overlap)."""
    if query not in pair.collected:
        if query == "time_interval":
            task = pair.interval_task
            start = pair.leader_ds.clock.now().to_batch_interval_start(task.time_precision).seconds
            args = ["--batch-interval-start", str(start - 3600), "--batch-interval-duration", str(3 * 3600)]
        else:
            task = pair.fixed_task
            args = ["--current-batch"]
        out = io.StringIO()
        with pair.drive(), redirect_stdout(out):
            assert collect.main(_collect_args(pair, task) + args) == 0
        pair.collected[query] = out.getvalue().splitlines()
    return pair.collected[query]


@pytest.mark.parametrize("query", ["time_interval", "current_batch"])
def test_collect_end_to_end_prints_the_ground_truth(pair, query):
    want = {"time_interval": ("Number of reports: 4", "Aggregation result: 3"),
            "current_batch": ("Number of reports: 3", "Aggregation result: 2")}[query]
    out = _run_collect(pair, query)
    assert want[0] in out and want[1] in out
    assert out[-2].startswith("Interval: [")
    assert out[0].startswith("Batch: ") == (query == "current_batch")


# --- gen_alert_rules -------------------------------------------------------


def test_gen_alert_rules_body_is_janus_tpus_byte_for_byte():
    text = gen_alert_rules.generate_rules_text()
    j_text = j_gen_alert_rules.generate_rules_text()
    # the one divergence by design: the header names the port's generator
    assert text.startswith(gen_alert_rules.HEADER) and j_text.startswith(j_gen_alert_rules.HEADER)
    assert "janus_tpu_torch.tools.gen_alert_rules" in gen_alert_rules.HEADER
    assert text[len(gen_alert_rules.HEADER):] == j_text[len(j_gen_alert_rules.HEADER):]
    assert gen_alert_rules.rules_body(text) == text[len(gen_alert_rules.HEADER):]
    assert yaml.safe_load(text) == yaml.safe_load(ALERTS.read_text())
    from janus_tpu_torch.slo import BUILTIN_SLOS

    rules = yaml.safe_load(text)["groups"][0]["rules"]
    assert len(rules) == 2 * len(BUILTIN_SLOS())


def test_gen_alert_rules_check_mode(tmp_path, capsys):
    assert gen_alert_rules.main(["--check", str(ALERTS)]) == 0
    own = tmp_path / "port.yaml"
    own.write_text(gen_alert_rules.generate_rules_text())
    assert gen_alert_rules.main(["--check", str(own)]) == 0
    stale = tmp_path / "stale.yaml"
    stale.write_text("groups: []\n")
    assert gen_alert_rules.main(["--check", str(stale)]) == 1
    drifted = tmp_path / "drifted.yaml"
    drifted.write_text(ALERTS.read_text().replace("severity: page", "severity: ticket", 1))
    assert gen_alert_rules.main(["--check", str(drifted)]) == 1
    assert "out of date" in capsys.readouterr().err


# --- report_trace ----------------------------------------------------------


def _trace(main, capsys, argv) -> dict:
    assert main(argv + ["--json"]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("case", ["collected", "rejected", "unknown", "journal_keys", "journal_no_keys"])
def test_report_trace_documents_equal_janus_tpus(pair, capsys, case):
    task = pair.interval_task
    if case in ("collected", "rejected"):
        # the collection first: a collected report's shards read `collected`
        _run_collect(pair, "time_interval")
    report_id = {
        "collected": pair.accepted_id, "rejected": pair.rejected_id, "unknown": None,
    }.get(case, pair.spilled_id)
    rid = b64(report_id.data) if report_id is not None else b64(secrets.token_bytes(16))
    # ids as `--opt=value`: a base64url id may begin with "-"
    argv = ["--db", pair.leader_db, f"--task-id={b64(task.task_id.data)}", f"--report-id={rid}"]
    if case.startswith("journal"):
        argv += ["--journal-dir", pair.journal_dir]
        if case == "journal_keys":
            argv += ["--datastore-keys", b64(pair.key)]
    got = _trace(report_trace.main, capsys, argv)
    want = _trace(j_report_trace.main, capsys, argv)
    assert got == want
    verdict = got["verdict"]
    if case == "collected":
        assert verdict.startswith("AGGREGATED and COLLECTED"), verdict
    elif case == "rejected":
        assert verdict.startswith("REJECTED (vdaf_prep_error)"), verdict
    elif case == "journal_keys":
        assert verdict.startswith("SPILLED") and got["journal"]["undecodable_frames"] == 0, got
    else:
        assert verdict.startswith("NOT FOUND"), verdict
        assert case != "journal_no_keys" or got["journal"]["undecodable_frames"] == 1
    assert got["ledger"]["imbalance"]["ingest"] == 0


def test_report_trace_text_mode_and_bad_ids(pair, capsys):
    argv = ["--db", pair.leader_db, f"--task-id={b64(pair.interval_task.task_id.data)}",
            f"--report-id={b64(pair.rejected_id.data)}"]
    assert report_trace.main(argv) == 0
    got = capsys.readouterr().out
    assert j_report_trace.main(argv) == 0
    assert got == capsys.readouterr().out and "prepare_error vdaf_prep_error" in got
    for main in (report_trace.main, j_report_trace.main):
        with pytest.raises(SystemExit, match="want 16 bytes"):
            main(argv[:-1] + [f"--report-id={b64(bytes(8))}"])


def test_report_trace_takes_an_id_beginning_with_a_dash(pair, capsys):
    rid = b64(b"\xf8" + bytes(15))
    assert rid.startswith("-")
    argv = ["--db", pair.leader_db, f"--task-id={b64(pair.interval_task.task_id.data)}", f"--report-id={rid}",
            "--json"]
    got = _trace(report_trace.main, capsys, argv)
    assert got == _trace(j_report_trace.main, capsys, argv) and got["verdict"].startswith("NOT FOUND"), got


# --- the health listener ---------------------------------------------------


@pytest.fixture(scope="module")
def listener(pair, tmp_path_factory):
    """A port HealthServer in a process that owns a datastore: the
    profiler, the flight recorder (one snapshot taken, its ring on disk)
    and the ledger over the leader's store installed, as janus_main
    installs them in every binary."""
    from janus_tpu_torch import flight_recorder, ledger, profiler
    from janus_tpu_torch.binary_utils import HealthServer

    ring = tmp_path_factory.mktemp("flight")
    profiler.install_profiler(profiler.ProfilerConfig(hz=100.0, window_secs=10.0))
    rec = flight_recorder.install_flight_recorder(flight_recorder.FlightRecorderConfig(interval_s=0.2, dir=str(ring)))
    rec.snapshot_once()
    ledger.install_ledger(pair.leader_ds)
    srv = HealthServer("127.0.0.1:0").start()
    try:
        yield f"http://127.0.0.1:{srv.port}", str(ring)
    finally:
        srv.stop()
        ledger.uninstall_ledger()
        flight_recorder.uninstall_flight_recorder()
        profiler.uninstall_profiler()


# --- debug_bundle ----------------------------------------------------------


REDACTION_CASE = {
    "database": {"url": "x.sqlite"},
    "aggregator_api": {"auth_tokens": ["hunter2"], "listen_address": "a:1"},
    "collector_auth_token": "t0",
    "nested": [{"hpke_private_key": "k"}],
}


def test_debug_bundle_redacts_as_janus_tpu_does():
    redacted = debug_bundle.redact_config(REDACTION_CASE)
    assert redacted == j_debug_bundle.redact_config(REDACTION_CASE)
    assert redacted["aggregator_api"]["auth_tokens"] == "**REDACTED**"
    assert redacted["collector_auth_token"] == "**REDACTED**"
    assert redacted["nested"][0]["hpke_private_key"] == "**REDACTED**"
    assert redacted["database"]["url"] == "x.sqlite"
    assert redacted["aggregator_api"]["listen_address"] == "a:1"
    assert debug_bundle.ENDPOINTS == j_debug_bundle.ENDPOINTS


def test_debug_bundle_holds_janus_tpus_files(pair, listener, tmp_path):
    url, ring = listener
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("database:\n  url: x.sqlite\naggregator_api:\n  auth_tokens: [hunter2]\n")
    now = time.time()
    names, manifests, states = {}, {}, {}
    # a shape manifest of two entries and a torn tail, beside a cache dir
    # holding one library
    from janus_tpu_torch.aggregator.shape_manifest import ShapeManifest

    shapes = tmp_path / "cache" / "shape_manifest.jsonl"
    man = ShapeManifest(str(shapes))
    for b in (32, 64):
        man.record({"kind": "count"}, "leader_init", b, ("leader_init", b), 0.5, rows=b)
    with open(shapes, "a") as f:
        f.write('{"v": 1, "crc": 1')
    (tmp_path / "cache" / "aot").mkdir()
    (tmp_path / "cache" / "aot" / "libkeccak-0.so").write_bytes(b"\x7fELF" + bytes(60))
    for pkg, fn in (("port", debug_bundle.collect_bundle), ("janus_tpu", j_debug_bundle.collect_bundle)):
        out = tmp_path / f"{pkg}.tar.gz"
        manifests[pkg] = fn([url], out_path=str(out), config_file=str(cfg), journal_dir=pair.journal_dir,
                            flight_dir=ring, shape_manifest=str(shapes), now=now)
        with tarfile.open(out) as tar:
            names[pkg] = set(tar.getnames())
            top = next(iter(names[pkg])).split("/")[0]
            mf = json.load(tar.extractfile(f"{top}/MANIFEST.json"))
            assert {f["path"] for f in mf["files"]} == names[pkg] - {f"{top}/MANIFEST.json"}
            states[pkg] = json.load(tar.extractfile(f"{top}/shape-manifest.json"))
            if pkg == "port":
                cfg_text = tar.extractfile(f"{top}/resolved-config.yaml").read().decode()
                assert "hunter2" not in cfg_text and "**REDACTED**" in cfg_text
                jd = json.load(tar.extractfile(f"{top}/upload-journal.json"))
                assert jd["segment_count"] == 1 and jd["corrupt_segments"] == []
                fr = json.load(tar.extractfile(f"{top}/flight-ring.json"))
                assert fr["segment_count"] >= 1 and fr["torn_lines"] == 0
    assert names["port"] == names["janus_tpu"]
    port = manifests["port"]
    assert port["tool"] == "janus_tpu_torch.tools.debug_bundle"
    # the same read-only inventory of the manifest and the cache dir, the
    # file left as it was (torn tail and all)
    assert states["port"] == states["janus_tpu"]
    assert (states["port"]["entries"], states["port"]["load"]["skipped_corrupt"]) == (2, 1)
    assert states["port"]["aot"]["blob_count"] == 1 and shapes.read_text().endswith('{"v": 1, "crc": 1')
    target = next(iter(port["targets"].values()))
    assert all("error" not in e for e in target["endpoints"].values())
    from janus_tpu_torch import metrics

    assert target["replica_id"] == metrics.replica_id()
    unreachable = debug_bundle.collect_bundle(["http://127.0.0.1:1"], out_path=str(tmp_path / "b2.tar.gz"),
                                              timeout=0.5)
    t2 = next(iter(unreachable["targets"].values()))
    assert all("error" in e for e in t2["endpoints"].values()) and t2["replica_id"] is None


def test_debug_bundle_main_exit_rule(listener, tmp_path, capsys):
    url, _ = listener
    assert debug_bundle.main(["--url", url, "--out", str(tmp_path / "a.tar.gz")]) == 0
    assert "0 capture errors" in capsys.readouterr().out
    assert debug_bundle.main(["--url", "http://127.0.0.1:1", "--out", str(tmp_path / "b.tar.gz"),
                              "--timeout", "0.5"]) == 1
    # a missing manifest is recorded in its inventory, not a capture error
    assert debug_bundle.main(["--url", url, "--out", str(tmp_path / "c.tar.gz"), "--shape-manifest",
                              str(tmp_path / "none.jsonl"), "--aot-dir", str(tmp_path)]) == 0
    assert "0 capture errors" in capsys.readouterr().out


# --- scrape_check ----------------------------------------------------------


def test_scrape_check_passes_against_a_listener_owning_a_datastore(listener, capsys):
    """The port's listener carries the engine_prewarm section (compile
    cache, kernel-library cache, manifest, prewarm), with janus_tpu's
    keys, and its check requires it."""
    import urllib.request

    url, _ = listener
    with urllib.request.urlopen(url + "/statusz", timeout=10) as r:
        ep = json.loads(r.read())["engine_prewarm"]
    assert set(ep) == {"compile_cache", "aot", "manifest", "prewarm"}
    assert ep["manifest"] == {"installed": False} and ep["prewarm"]["state"] in ("idle", "done")
    assert scrape_check.main(["--url", url, "--statusz"]) == 0, capsys.readouterr().err
    assert "scrape_check: OK" in capsys.readouterr().out
    assert scrape_check.main(["--url", url + "/nope"]) != 0


def test_scrape_check_requires_the_ledger_section(listener, pair, capsys):
    """The behaviour of the seed's failing janus_tpu case, kept: a
    listener whose process owns no datastore (no ledger installed) fails
    --statusz with "missing the ledger section"."""
    from janus_tpu_torch import ledger

    url, _ = listener
    ledger.uninstall_ledger()
    try:
        assert scrape_check.main(["--url", url, "--statusz"]) == 1
        assert "/statusz missing the ledger section" in capsys.readouterr().err
    finally:
        ledger.install_ledger(pair.leader_ds)


# --- scrape_check against janus_tpu's, on planted faults -------------------

SCRAPED = ("/metrics", "/metrics?openmetrics=1", "/statusz", "/readyz", "/debug/traces?limit=5", "/debug/ledger",
           "/alertz", "/debug/profile", "/debug/profile?format=json", "/debug/flight", "/debug/boot", "/")


def _edit_json(docs, path, fn):
    status, ctype, body = docs[path]
    doc = json.loads(body)
    fn(doc)
    docs[path] = (status, ctype, json.dumps(doc))


def _edit_metrics(docs, fn, modes=("/metrics", "/metrics?openmetrics=1")):
    for path in modes:
        status, ctype, body = docs[path]
        docs[path] = (status, ctype, fn(body))


def _drop_family(name):
    def fn(text):
        return "".join(line for line in text.splitlines(keepends=True)
                       if not (line.startswith(name + "{") or line.startswith(name + " ")
                               or line.startswith(f"# HELP {name} ") or line.startswith(f"# TYPE {name} ")))
    return fn


def _relabel(family, old, new):
    """Rename label `old` of `family`'s samples to `new` (None: drop it)."""
    import re

    def fn(text):
        out = []
        for line in text.splitlines(keepends=True):
            if line.startswith(family + "{"):
                line = re.sub(rf'([{{,]){old}="[^"]*",?', (lambda m: f'{m.group(1)}{new}="x",') if new
                              else (lambda m: m.group(1)), line).replace(",}", "}")
            out.append(line)
        return "".join(out)
    return fn


def _both_checkers_agree(docs):
    """The union of both deployments' documents: the port's capture plus
    janus_tpu's two named keys (janus_build_info's `jax` label, the device
    watchdog's `host_only`), so that each checker passes it and any
    planted fault is a fault to both. The `engine_prewarm` section is the
    port's own, as captured."""
    _edit_metrics(docs, _relabel("janus_build_info", "torch", None))
    _edit_metrics(docs, lambda t: t.replace("janus_build_info{", 'janus_build_info{jax="x",torch="x",'))

    def union(snap):
        snap["device_watchdog"]["host_only"] = snap["device_watchdog"]["device_down"]
    _edit_json(docs, "/statusz", union)


@pytest.fixture(scope="module")
def scrape_stub(listener):
    """A stub listener serving every document scrape_check reads, captured
    once from the port listener and made the union of both deployments';
    a test plants one fault in `stub.docs`."""
    import copy
    import http.server

    url, _ = listener
    captured = {path: _get(url + path) for path in SCRAPED}
    _both_checkers_agree(captured)

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            status, ctype, body = stub.docs.get(self.path, (404, "text/plain", "not found"))
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    stub = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    stub.captured = captured
    stub.docs = copy.deepcopy(captured)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    try:
        yield stub
    finally:
        stub.shutdown()
        stub.server_close()


def _get(url):
    """(status, Content-Type, body) of a GET, of a 503 too."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _janus_tpu_scrape_check():
    import runpy
    import sys

    sys.path.insert(0, str(REPO))
    try:
        return runpy.run_path(str(REPO / "scripts" / "scrape_check.py"), run_name="scrape_check")["main"]
    finally:
        sys.path.pop(0)


def _run_both(stub, capsys) -> dict:
    url = f"http://127.0.0.1:{stub.server_address[1]}"
    out = {}
    for pkg, main in (("port", scrape_check.main), ("janus_tpu", _janus_tpu_scrape_check())):
        rc = main(["--url", url, "--statusz", "--timeout", "10"])
        out[pkg] = (rc, capsys.readouterr().err)
    return out


def _fault_statusz(fn):
    return lambda docs: _edit_json(docs, "/statusz", fn)


def _stale_flight(snap):
    snap["flight"].update(enabled=True, running=True, last_snapshot_age_s=1e6)


def _breach(snap):
    snap["ledger"].update(enabled=True, breaches=[{"task": "t", "stage": "ingest"}])


def _peer_health_without_peers_key(snap):
    snap["peer_health"] = {"config": {}, "parked": []}


def _stalled_without_stack(snap):
    snap["device_watchdog"]["stalled"] = [{"label": "init", "age_s": 9.0}]


def _engine_entry_short(section, key):
    def fn(snap):
        snap[section].setdefault("engines", []).append({key: "x"})
    return fn


def _two_live_build_infos(text):
    line = next(ln for ln in text.splitlines(keepends=True) if ln.startswith("janus_build_info{"))
    return text.replace(line, line + line.replace('version="', 'version="other-'), 1)


def _append_line(line):
    def fn(text):
        if text.rstrip().endswith("# EOF"):
            return text.rstrip()[: -len("# EOF")] + line + "\n# EOF\n"
        return text + line + "\n"
    return fn


def _exemplar_on_a_bucket(text):
    line = next(ln for ln in text.splitlines() if "_bucket{" in ln)
    return text.replace(line, line + ' # {trace_id="ab"} 1.0', 1)


def _readyz_disagrees(docs):
    docs["/readyz"] = (200, "application/json", json.dumps({"ready": False, "reasons": {"datastore": "down"}}))


def _firing_alert_without_since(doc):
    doc["alerts"] = [{"alert": "a", "severity": "page", "state": "firing", "burn_rate_threshold": 14.4,
                      "firing_since_unix": None}]


def _boot_not_monotone(doc):
    doc["phases"] = [{"phase": "a", "start_s": 0.0, "end_s": 2.0, "seconds": 2.0},
                     {"phase": "b", "start_s": 1.0, "end_s": 3.0, "seconds": 2.0}]


# (case, fault, the text both checkers print for it)
SCRAPE_FAULTS = [
    ("no_engine_prewarm_section", _fault_statusz(lambda snap: snap.pop("engine_prewarm")),
     "/statusz missing the engine_prewarm section"),
    ("engine_prewarm_aot_without_loads", _fault_statusz(lambda snap: snap["engine_prewarm"]["aot"].pop("loads")),
     "/statusz engine_prewarm aot missing 'loads'"),
    ("engine_prewarm_manifest_without_installed",
     _fault_statusz(lambda snap: snap["engine_prewarm"]["manifest"].pop("installed")),
     "/statusz engine_prewarm manifest missing 'installed'"),
    ("missing_family", lambda d: _edit_metrics(d, _drop_family("janus_ledger_imbalance")),
     "/metrics missing the janus_ledger_imbalance family"),
    ("malformed_exposition_line", lambda d: _edit_metrics(d, _append_line('janus_up{x="1" 1'), ("/metrics",)),
     "unparseable sample 'janus_up{x=\"1\" 1'"),
    ("not_exposition_content_type", lambda d: d.__setitem__("/metrics", (200, "application/json", d["/metrics"][2])),
     "/metrics Content-Type not exposition format"),
    ("exemplar_in_default_mode", lambda d: _edit_metrics(d, _exemplar_on_a_bucket, ("/metrics",)),
     "malformed label segment at '} "),
    ("openmetrics_family_set_differs",
     lambda d: _edit_metrics(d, _drop_family("janus_gc_runs_total"), ("/metrics?openmetrics=1",)),
     "openmetrics mode exposes a different family set"),
    ("two_live_build_infos", lambda d: _edit_metrics(d, _two_live_build_infos),
     "janus_build_info needs exactly one value-1 sample"),
    ("replica_info_without_replica_id", lambda d: _edit_metrics(d, _relabel("janus_replica_info", "replica_id", None)),
     "janus_replica_info needs exactly one value-1 sample"),
    ("bad_collapsed_stack_line",
     lambda d: d.__setitem__("/debug/profile", (200, d["/debug/profile"][1], d["/debug/profile"][2] + "a;b c;d x\n")),
     "/debug/profile collapsed: "),
    ("profiler_disabled", lambda d: _edit_json(d, "/debug/profile?format=json", lambda p: p.update(enabled=False)),
     "/debug/profile reports the sampler disabled"),
    *[(f"statusz_without_{s}", _fault_statusz(lambda snap, s=s: snap.pop(s)), f"/statusz missing the {s} section")
      for s in ("device_watchdog", "resident_accumulators", "profile", "fleet", "mesh", "device_cost", "flight",
                "ledger")],
    ("resident_without_sparse", _fault_statusz(lambda snap: snap["resident_accumulators"].pop("sparse")),
     "/statusz resident_accumulators missing 'sparse'"),
    ("resident_engine_entry_short", _fault_statusz(_engine_entry_short("resident_accumulators", "vdaf")),
     "/statusz resident_accumulators engine entry missing"),
    ("mesh_queue_without_lane_alive", _fault_statusz(lambda snap: snap["mesh"]["queue"].pop("lane_alive")),
     "/statusz mesh queue missing 'lane_alive'"),
    ("device_cost_entry_short", _fault_statusz(lambda snap: snap["device_cost"]["entries"].append({"vdaf": "x"})),
     "/statusz device_cost entry missing"),
    ("stalled_dispatch_without_stack", _fault_statusz(_stalled_without_stack),
     "stalled entry without a stack dump"),
    ("peer_health_without_peers", _fault_statusz(_peer_health_without_peers_key),
     "/statusz peer_health missing 'peers'"),
    ("flight_snapshot_stale", _fault_statusz(_stale_flight), "has stopped recording"),
    ("ledger_breach_active", _fault_statusz(_breach), "active conservation breaches"),
    ("readyz_status_disagrees_with_body", _readyz_disagrees, "/readyz status 200 disagrees"),
    ("traces_without_digests", lambda d: _edit_json(d, "/debug/traces?limit=5", lambda t: t.pop("digests")),
     "/debug/traces missing 'digests'"),
    ("debug_ledger_without_enabled", lambda d: _edit_json(d, "/debug/ledger", lambda t: t.pop("enabled")),
     "/debug/ledger JSON missing 'enabled'"),
    ("firing_alert_without_since", lambda d: _edit_json(d, "/alertz", _firing_alert_without_since),
     "firing alert without firing_since"),
    ("flight_analysis_without_leaking",
     lambda d: _edit_json(d, "/debug/flight", lambda f: f.update(enabled=True, analysis={"series": {}, "latency": {}})),
     "/debug/flight analysis missing 'leaking'"),
    ("boot_phases_not_monotone", lambda d: _edit_json(d, "/debug/boot", _boot_not_monotone),
     "/debug/boot phases not monotone"),
    ("index_page_without_alertz",
     lambda d: d.__setitem__("/", (200, d["/"][1], d["/"][2].replace('"/alertz"', '"/x"').replace("/alertz", "/x"))),
     "GET / index page does not link /alertz"),
]


def test_scrape_check_both_pass_the_union_of_the_deployments(scrape_stub, capsys):
    """The baseline of the planted faults: both checkers pass the port
    listener's documents with janus_tpu's two named keys added."""
    import copy

    scrape_stub.docs = copy.deepcopy(scrape_stub.captured)
    got = _run_both(scrape_stub, capsys)
    assert got == {"port": (0, ""), "janus_tpu": (0, "")}, got


@pytest.mark.parametrize("case,fault,says", SCRAPE_FAULTS, ids=[c[0] for c in SCRAPE_FAULTS])
def test_scrape_check_rejects_what_janus_tpus_rejects(scrape_stub, capsys, case, fault, says):
    """Every family, build_info, exposition and section check kept: each
    planted fault fails both checkers, each naming it."""
    import copy

    scrape_stub.docs = copy.deepcopy(scrape_stub.captured)
    fault(scrape_stub.docs)
    got = _run_both(scrape_stub, capsys)
    for pkg, (rc, err) in got.items():
        assert rc == 1 and says in err, (case, pkg, rc, err[-1500:])


# the named divergences: (case, fault, port rc, janus_tpu rc)
SCRAPE_DIVERGENCES = [
    ("build_info_without_jax_label", lambda d: _edit_metrics(d, _relabel("janus_build_info", "jax", None)), 0, 1),
    ("build_info_without_torch_label", lambda d: _edit_metrics(d, _relabel("janus_build_info", "torch", None)), 1, 0),
    ("watchdog_without_host_only", _fault_statusz(lambda snap: snap["device_watchdog"].pop("host_only")), 0, 1),
    ("watchdog_without_device_down", _fault_statusz(lambda snap: snap["device_watchdog"].pop("device_down")), 1, 0),
]


@pytest.mark.parametrize("case,fault,port_rc,janus_rc", SCRAPE_DIVERGENCES, ids=[c[0] for c in SCRAPE_DIVERGENCES])
def test_scrape_check_divergences_by_design(scrape_stub, capsys, case, fault, port_rc, janus_rc):
    """The port reads its own names for the build's framework label and
    the watchdog's cap state; nothing else differs."""
    import copy

    scrape_stub.docs = copy.deepcopy(scrape_stub.captured)
    fault(scrape_stub.docs)
    got = _run_both(scrape_stub, capsys)
    assert (got["port"][0], got["janus_tpu"][0]) == (port_rc, janus_rc), (case, got)
