"""janus_tpu_torch's multi-round prepare held against janus_tpu's.

The three scenarios of tests/test_multi_round.py, driven by the
two-round fake VDAF (`fake_two_round`, the Count circuit with a
prep-message echo for round 2), each in all four leader/helper pairings
over loopback HTTP: a janus_tpu pair (the reference), a port leader with
a janus_tpu helper, a janus_tpu leader with a port helper, and a port
pair. Every pairing starts from fresh SQLite datastores holding the same
tasks, and its leader takes the same uploaded reports (the same Report
bytes through `handle_upload`); the creators draw job ids from one seeded
stream per package.

- Full protocol: after the init step both sides hold the reference's
  WAITING_LEADER / WAITING_HELPER rows and blobs, after the continue step
  its FINISHED rows, batch aggregations and job rows; then both packages'
  collectors get the reference's result from the pairing's leader, which
  equals the ground truth.
- Step and order validation: the helper's answers to a continue to step
  0, to step 2, to an unknown report, to the leader's own continue sent
  again (a byte-identical replay) and to another request at the same step
  equal the reference's, status and problem document.
- Init replay while WAITING_HELPER: the re-PUT init answers the original
  response byte for byte, the rows stay parked, and the job still
  finishes.
- The one-round fakes (`fake`, `fake_fails_prep_init`,
  `fake_fails_prep_step`) leave the reference's rows in every pairing:
  their failure seams fail the same reports on the same side.
- A continue request to a one-round task answers janus_tpu's
  stepMismatch, and a continue route answers janus_tpu's media-type and
  auth problem documents.

`Pairing` is shared with tests/test_torch_poplar1.py. The port runs with
device="cpu"; tolerance: exact equality.
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

from janus_tpu import collector as j_collector
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.aggregator import aggregation_job_creator as j_creator
from janus_tpu.aggregator import aggregation_job_driver as j_adriver
from janus_tpu.aggregator import collection_job_driver as j_cdriver
from janus_tpu.aggregator import core as j_core
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.aggregator import job_driver as j_jobs
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu.core import hpke as j_hpke
from janus_tpu.core import http_client as j_client
from janus_tpu.core import retries as j_retries
from janus_tpu.core import time_util as j_time
from janus_tpu.core.auth import AuthenticationToken
from janus_tpu.datastore import store as j_store
from janus_tpu.vdaf import registry as j_registry
from janus_tpu.vdaf import wire as j_wire
from janus_tpu_torch import collector as t_collector
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import aggregation_job_creator as t_creator
from janus_tpu_torch.aggregator import aggregation_job_driver as t_adriver
from janus_tpu_torch.aggregator import collection_job_driver as t_cdriver
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.aggregator import job_driver as t_jobs
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core import hpke as t_hpke
from janus_tpu_torch.core import http_client as t_client
from janus_tpu_torch.core import retries as t_retries
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.task import Task

NOW = 1_700_000_000
TP = 3600
WINDOW = NOW - NOW % TP
PAIRINGS = ["jax-jax", "torch-jax", "jax-torch", "torch-torch"]

PKG = {
    "jax": SimpleNamespace(
        m=jm, core=j_core, http=j_http, jobs=j_jobs, creator=j_creator, adriver=j_adriver, cdriver=j_cdriver,
        client=j_client, retries=j_retries, cb=j_cb, collector=j_collector, hpke=j_hpke,
        eph=lambda: j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW))),
        aggregator=lambda eph: j_core.Aggregator(eph.datastore, eph.clock, j_core.Config()),
        adriver_kw={},
        task=lambda t: t,
    ),
    "torch": SimpleNamespace(
        m=tm, core=t_core, http=t_http, jobs=t_jobs, creator=t_creator, adriver=t_adriver, cdriver=t_cdriver,
        client=t_client, retries=t_retries, cb=t_cb, collector=t_collector, hpke=t_hpke,
        eph=lambda: EphemeralDatastore(MockClock(tm.Time(NOW))),
        aggregator=lambda eph: t_core.Aggregator(eph.datastore, eph.clock, t_core.Config(), device="cpu"),
        adriver_kw={"device": "cpu"},
        task=lambda t: Task.from_dict(t.to_dict()),
    ),
}


class Seeded:
    """A stand-in for a module's `secrets`: a seeded stream."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def token_bytes(self, n: int) -> bytes:
        return self.rng.bytes(n)


def make_tasks(vdaf: j_registry.VdafInstance, max_batch_query_count: int = 1):
    """A janus_tpu leader task, its helper task and the collector's keypair."""
    collector_kp = j_hpke.generate_hpke_config_and_private_key(config_id=200)
    leader = (
        j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), vdaf, jm.Role.LEADER)
        .with_(
            vdaf_verify_key=bytes(range(16)), collector_hpke_config=collector_kp.config,
            aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_auth_token=AuthenticationToken.random_bearer(),
            min_batch_size=1, max_batch_query_count=max_batch_query_count, time_precision=jm.Duration(TP),
        )
        .build()
    )
    helper = dataclasses.replace(leader, role=jm.Role.HELPER,
                                 hpke_keys=(j_hpke.generate_hpke_config_and_private_key(config_id=1),))
    return leader, helper, collector_kp


def prepare_reports(leader_task, helper_task, measurements, prepare=None):
    """Reports sealed for the two tasks' keys, made once by a janus_tpu
    client; `prepare(client, m)` replaces the client's own."""
    from janus_tpu.client import Client, ClientParameters

    params = ClientParameters(leader_task.task_id, "http://leader/", "http://helper/", leader_task.time_precision)
    client = Client(params, leader_task.vdaf, leader_task.hpke_keys[0].config, helper_task.hpke_keys[0].config,
                    clock=j_time.MockClock(jm.Time(NOW)))
    return [(prepare or Client.prepare_report)(client, m) for m in measurements]


def query_for(m):
    return m.Query.time_interval(m.Interval(m.Time(WINDOW - TP), m.Duration(3 * TP)))


class Pairing:
    """A `leader` package's aggregator and drivers against a `helper`
    package's aggregator, each behind its own DapServer on port 0."""

    def __init__(self, monkeypatch, leader: str, helper: str, j_leader, j_helper, collector_kp, seed: int = 5):
        self.lp, self.hp = PKG[leader], PKG[helper]
        self.j_leader, self.collector_kp = j_leader, collector_kp
        for pkg in PKG.values():
            monkeypatch.setattr(pkg.creator, "secrets", Seeded(seed))
        self.h_eph, self.l_eph = self.hp.eph(), self.lp.eph()
        self.h_agg, self.l_agg = self.hp.aggregator(self.h_eph), self.lp.aggregator(self.l_eph)
        self.h_srv = self.hp.http.DapServer(self.hp.http.DapHttpApp(self.h_agg)).start()
        self.l_srv = self.lp.http.DapServer(self.lp.http.DapHttpApp(self.l_agg)).start()
        self.task = self.lp.task(dataclasses.replace(
            j_leader, leader_aggregator_endpoint=self.l_srv.url, helper_aggregator_endpoint=self.h_srv.url))
        self.helper_task = self.hp.task(j_helper)
        self.l_eph.datastore.run_tx(lambda tx: tx.put_task(self.task))
        self.h_eph.datastore.run_tx(lambda tx: tx.put_task(self.helper_task))

    def close(self):
        self.l_srv.stop()
        self.h_srv.stop()
        for agg in (self.l_agg, self.h_agg):
            if hasattr(agg, "close"):
                agg.close()
        self.l_eph.cleanup()
        self.h_eph.cleanup()

    def upload(self, reports) -> None:
        m = self.lp.m
        ta = self.l_agg.task_aggregator_for(self.task.task_id)
        for r in reports:
            ta.handle_upload(self.l_eph.datastore, self.l_eph.clock, m.Report.from_bytes(r.to_bytes()))

    def create_jobs(self) -> int:
        return self.lp.creator.AggregationJobCreator(
            self.l_eph.datastore, self.lp.creator.AggregationJobCreatorConfig(min_aggregation_job_size=1)
        ).run_once()

    def http(self):
        return self.lp.client.HttpClient(timeout=30)

    def agg_jobs(self, http=None):
        lp = self.lp
        driver = lp.adriver.AggregationJobDriver(
            self.l_eph.datastore, http or self.http(),
            lp.adriver.AggregationJobDriverConfig(http_backoff=lp.retries.Backoff.test()),
            breakers=lp.cb.OutboundCircuitBreakers(), **lp.adriver_kw,
        )
        return lp.jobs.JobDriver(lp.jobs.JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(),
                                 driver.stepper)

    def collection_jobs(self):
        lp = self.lp
        driver = lp.cdriver.CollectionJobDriver(
            self.l_eph.datastore, self.http(),
            lp.cdriver.CollectionJobDriverConfig(http_backoff=lp.retries.Backoff.test()),
            breakers=lp.cb.OutboundCircuitBreakers(),
        )
        return lp.jobs.JobDriver(lp.jobs.JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(),
                                 driver.stepper)

    def collector(self, pkg: str):
        p = PKG[pkg]
        task = p.task(self.j_leader)
        kp = p.hpke.HpkeKeypair(p.m.HpkeConfig.from_bytes(self.collector_kp.config.to_bytes()),
                                self.collector_kp.private_key)
        return p.collector.Collector(
            p.collector.CollectorParameters(task.task_id, self.l_srv.url, task.collector_auth_token, kp),
            task.vdaf, p.client.HttpClient(timeout=30),
        )

    def poll_all(self, job_id: bytes, agg_param: bytes = b""):
        """Both packages' collectors poll the leader: their results."""
        out = {}
        for pkg in PKG:
            m = PKG[pkg].m
            res = self.collector(pkg).poll_once(m.CollectionJobId(job_id), query_for(m), agg_param=agg_param)
            out[pkg] = (res.report_count, res.interval.to_bytes(), res.aggregate_result)
        return out

    def continue_url(self) -> str:
        job = self.l_eph.datastore.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(self.task.task_id))[0]
        return (self.h_srv.url.rstrip("/") + f"/tasks/{_b64(self.task.task_id.data)}"
                f"/aggregation_jobs/{_b64(job.job_id.data)}")

    def rows(self):
        """Both sides' aggregation jobs with their report aggregations
        (prep blobs decrypted), keyed up to the job ids, their batch
        aggregations and the leader's collection jobs."""
        return {
            "leader": side_rows(self.l_eph.datastore, self.lp.m),
            "helper": side_rows(self.h_eph.datastore, self.hp.m),
        }

    def states(self, side: str):
        return sorted({ra[3] for job in self.rows()[side]["jobs"] for ra in job[2]})


def _b64(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def side_rows(ds, m):
    """One datastore's rows, job ids replaced by (parameter, the job's
    sorted report ids): job ids are drawn at random where the creating
    code cannot be seeded from outside."""

    def read(tx):
        (tid,) = tx._c.execute("SELECT task_id FROM tasks").fetchone()
        task_id = m.TaskId(tid)
        jobs = []
        for (jid,) in tx._c.execute("SELECT job_id FROM aggregation_jobs").fetchall():
            job = tx.get_aggregation_job(task_id, m.AggregationJobId(jid))
            ras = tx.get_report_aggregations_for_job(task_id, m.AggregationJobId(jid))
            key = (job.aggregation_parameter, tuple(sorted(ra.report_id.data for ra in ras)))
            jobs.append((key, (
                job.partial_batch_identifier, job.client_timestamp_interval.to_bytes(), job.state.value, job.step,
                job.last_request_hash,
            ), [(ra.ord, ra.report_id.data, ra.client_time.seconds, ra.state.value, ra.prep_blob,
                 None if ra.prepare_error is None else int(ra.prepare_error)) for ra in ras]))
        collections = []
        for (cid,) in tx._c.execute("SELECT collection_job_id FROM collection_jobs").fetchall():
            cj = tx.get_collection_job(task_id, m.CollectionJobId(cid))
            collections.append((cj.query, cj.aggregation_parameter, cj.batch_identifier, cj.state.value,
                                cj.report_count, cj.leader_aggregate_share))
        batches = tx._c.execute(
            "SELECT batch_identifier, aggregation_parameter, ord, state, aggregate_share, report_count,"
            " client_interval_start, client_interval_duration, checksum FROM batch_aggregations"
            " ORDER BY batch_identifier, aggregation_parameter, ord"
        ).fetchall()
        return {"jobs": sorted(jobs), "collections": sorted(collections, key=repr), "batches": batches}

    return ds.run_tx(read)


@pytest.fixture(autouse=True)
def _single_jax_device(monkeypatch):
    """janus_tpu builds its engines on one device, the path the port
    ports, and walks Poplar1 on the host (its own test seam; its device
    walk is held by tests/test_torch_poplar1.py directly)."""
    monkeypatch.setenv("JANUS_MESH_DP", "1")
    monkeypatch.setenv("JANUS_MESH_SP", "1")
    monkeypatch.setenv("JANUS_POPLAR1_DEVICE", "0")


VDAF = j_registry.VdafInstance.fake_two_round()
TASKS = make_tasks(VDAF)
MEASUREMENTS = [1, 0, 1, 1]
REPORTS = prepare_reports(TASKS[0], TASKS[1], MEASUREMENTS)
_REFERENCE: dict = {}


def reference(monkeypatch, name: str, fn):
    if name not in _REFERENCE:
        _REFERENCE[name] = fn(monkeypatch, "jax", "jax")
    return _REFERENCE[name]


def full_protocol(monkeypatch, leader: str, helper: str):
    pair = Pairing(monkeypatch, leader, helper, *TASKS)
    try:
        pair.upload(REPORTS)
        assert pair.create_jobs() == 1
        jobs = pair.agg_jobs()
        assert jobs.run_once() == 1  # init: both sides park
        parked = pair.rows()
        assert pair.states("leader") == ["waiting_leader"] and pair.states("helper") == ["waiting_helper"]
        assert jobs.run_once() == 1  # continue: both sides finish and accumulate
        finished = pair.rows()
        assert pair.states("leader") == ["finished"] and pair.states("helper") == ["finished"]
        assert jobs.run_once() == 0

        m = pair.lp.m
        job_id = pair.collector(leader).start_collection(query_for(m)).data
        assert pair.collection_jobs().run_once() == 1
        return {"parked": parked, "finished": finished, "collected": pair.rows(), "results": pair.poll_all(job_id)}
    finally:
        pair.close()


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_two_round_full_protocol_leaves_janus_tpu_rows(monkeypatch, pairing):
    want = reference(monkeypatch, "full", full_protocol)
    got = full_protocol(monkeypatch, *pairing.split("-")) if pairing != "jax-jax" else want
    for key in ("parked", "finished", "collected"):
        assert got[key] == want[key], key
    (count, _, result), = {v for v in got["results"].values()}
    assert got["results"] == want["results"]
    assert (count, result) == (len(MEASUREMENTS), sum(MEASUREMENTS))
    # the parked blobs: the leader's len || PP_FINISH frame || out share,
    # the helper's (empty prep message) || out share
    (_, _, leader_ras), = want["parked"]["leader"]["jobs"]
    (_, _, helper_ras), = want["parked"]["helper"]["jobs"]
    assert all(ra[4][4] == j_wire.PP_FINISH and len(ra[4]) == 4 + 5 + 8 for ra in leader_ras)
    assert all(len(ra[4]) == 8 for ra in helper_ras)


def step_validation(monkeypatch, leader: str, helper: str):
    pair = Pairing(monkeypatch, leader, helper, *TASKS)
    try:
        pair.upload(REPORTS[:2])
        assert pair.create_jobs() == 1
        captured = {}
        base = pair.lp.client.HttpClient

        class Capturing(base):
            def post(self, url, body, headers=None, timeout=None):
                if "aggregation_jobs" in url:
                    captured.update(url=url, body=body, headers=headers)
                return super().post(url, body, headers, timeout=timeout)

        jobs = pair.agg_jobs(Capturing(timeout=30))
        assert jobs.run_once() == 1
        url = pair.continue_url()
        headers = {"Content-Type": jm.AggregationJobContinueReq.MEDIA_TYPE,
                   **TASKS[0].aggregator_auth_token.request_headers()}
        http = j_client.HttpClient(timeout=30)

        def post(req_bytes, hdrs=headers, to=url):
            status, body = http.post(to, req_bytes, hdrs)
            return status, json.loads(body) if status == 400 else body

        answers = {
            "step-0": post(jm.AggregationJobContinueReq(jm.AggregationJobStep(0), ()).to_bytes()),
            "step-2": post(jm.AggregationJobContinueReq(jm.AggregationJobStep(2), ()).to_bytes()),
            "unknown-report": post(jm.AggregationJobContinueReq(jm.AggregationJobStep(1), (
                jm.PrepareContinue(jm.ReportId(b"\xee" * 16), j_wire.encode_pingpong(j_wire.PP_FINISH, b"", None)),
            )).to_bytes()),
        }
        assert jobs.run_once() == 1  # the real continue
        first = post(captured["body"], captured["headers"], captured["url"])
        answers["replay"] = first
        answers["replay-again"] = post(captured["body"], captured["headers"], captured["url"])
        answers["same-step-other-request"] = post(
            jm.AggregationJobContinueReq(jm.AggregationJobStep(1), ()).to_bytes())
        answers["rows"] = pair.rows()
        return answers
    finally:
        pair.close()


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_continue_step_and_order_validation_answer_as_janus_tpu(monkeypatch, pairing):
    want = reference(monkeypatch, "validation", step_validation)
    got = step_validation(monkeypatch, *pairing.split("-")) if pairing != "jax-jax" else want
    assert got == want
    kinds = {k: v[1]["type"].rsplit(":", 1)[1] for k, v in want.items() if k != "rows" and v[0] == 400}
    assert kinds == {"step-0": "invalidMessage", "step-2": "stepMismatch", "unknown-report": "invalidMessage",
                     "same-step-other-request": "stepMismatch"}
    assert want["replay"][0] == 200 and want["replay-again"] == want["replay"]


def init_replay(monkeypatch, leader: str, helper: str):
    pair = Pairing(monkeypatch, leader, helper, *TASKS)
    try:
        pair.upload(REPORTS[:3])
        assert pair.create_jobs() == 1
        captured = {}
        base = pair.lp.client.HttpClient

        class Capturing(base):
            def put(self, url, body, headers=None, timeout=None):
                if "aggregation_jobs" in url:
                    captured.update(url=url, body=body, headers=headers)
                status, resp = super().put(url, body, headers, timeout=timeout)
                captured.setdefault("first", resp)
                return status, resp

        jobs = pair.agg_jobs(Capturing(timeout=30))
        assert jobs.run_once() == 1
        parked = pair.rows()
        status, body = j_client.HttpClient(timeout=30).put(captured["url"], captured["body"], captured["headers"])
        assert (status, body) == (200, captured["first"])
        assert pair.rows() == parked  # the replay changed nothing
        resp = jm.AggregationJobResp.from_bytes(body)
        assert [pr.result.kind for pr in resp.prepare_resps] == [jm.PrepareStepResult.CONTINUE] * 3
        assert jobs.run_once() == 1
        assert pair.states("helper") == ["finished"]
        return {"replayed": body, "parked": parked, "finished": pair.rows()}
    finally:
        pair.close()


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_init_replay_while_waiting_helper_answers_as_janus_tpu(monkeypatch, pairing):
    want = reference(monkeypatch, "replay", init_replay)
    got = init_replay(monkeypatch, *pairing.split("-")) if pairing != "jax-jax" else want
    assert got == want


def test_waiting_rows_round_trip_their_prep_blob_as_janus_tpu():
    """WAITING_LEADER and WAITING_HELPER rows keep their prep_blob
    (encrypted at rest) through put, get and update, in both datastores."""
    from janus_tpu.datastore import models as j_models
    from janus_tpu_torch.datastore import models as t_models

    task = TASKS[0]
    got = {}
    for pkg, models in (("jax", j_models), ("torch", t_models)):
        p = PKG[pkg]
        m, eph = p.m, p.eph()
        try:
            ds = eph.datastore
            t = p.task(task)
            jid = m.AggregationJobId(bytes(range(16)))
            rows = [models.ReportAggregationModel(t.task_id, jid, m.ReportId(bytes([i]) * 16), m.Time(NOW), i,
                                                  state, bytes([i]) * (40 + i), None)
                    for i, state in enumerate((models.ReportAggregationState.WAITING_LEADER,
                                               models.ReportAggregationState.WAITING_HELPER))]

            def put(tx):
                tx.put_task(t)
                tx.put_aggregation_job(models.AggregationJobModel(
                    t.task_id, jid, b"param", m.PartialBatchSelector.time_interval().to_bytes(),
                    m.Interval(m.Time(NOW), m.Duration(1)), models.AggregationJobState.IN_PROGRESS, 0))
                for ra in rows:
                    tx.put_report_aggregation(ra)

            ds.run_tx(put)
            first = ds.run_tx(lambda tx: tx.get_report_aggregations_for_job(t.task_id, jid))
            ds.run_tx(lambda tx: tx.update_report_aggregation(dataclasses.replace(rows[1], prep_blob=b"new")))
            second = ds.run_tx(lambda tx: tx.get_report_aggregations_for_job(t.task_id, jid))
            got[pkg] = [[(ra.state.value, ra.prep_blob) for ra in r] for r in (first, second)]
        finally:
            eph.cleanup()
    assert got["torch"] == got["jax"]
    assert got["jax"][0] == [("waiting_leader", b"\x00" * 40), ("waiting_helper", b"\x01" * 41)]
    assert got["jax"][1][1] == ("waiting_helper", b"new")


FAKES = ["fake", "fake_fails_prep_init", "fake_fails_prep_step"]
_FAKE_TASKS: dict = {}


def fake_run(monkeypatch, kind: str, leader: str, helper: str):
    if kind not in _FAKE_TASKS:
        tasks = make_tasks(j_registry.VdafInstance(kind))
        _FAKE_TASKS[kind] = tasks, prepare_reports(tasks[0], tasks[1], MEASUREMENTS)
    tasks, reports = _FAKE_TASKS[kind]
    pair = Pairing(monkeypatch, leader, helper, *tasks)
    try:
        pair.upload(reports)
        assert pair.create_jobs() == 1
        jobs = pair.agg_jobs()
        assert jobs.run_once() == 1 and jobs.run_once() == 0  # one round: done in one step
        return pair.rows()
    finally:
        pair.close()


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("kind", FAKES)
def test_one_round_fakes_leave_janus_tpu_rows(monkeypatch, kind, pairing):
    """The fakes' failure seams (`fails_at`): a failed init fails every
    report on the leader before any request, a failed step on both sides;
    the plain fake aggregates as Count."""
    key = f"fake-{kind}"
    want = reference(monkeypatch, key, lambda mp, lp, hp: fake_run(mp, kind, lp, hp))
    got = fake_run(monkeypatch, kind, *pairing.split("-")) if pairing != "jax-jax" else want
    assert got == want
    (_, job, leader_ras), = want["leader"]["jobs"]
    assert job[2] == "finished"
    err = int(jm.PrepareError.VDAF_PREP_ERROR)
    if kind == "fake":
        assert {ra[3] for ra in leader_ras} == {"finished"} and want["leader"]["batches"][0][5] == len(MEASUREMENTS)
    else:
        assert {(ra[3], ra[5]) for ra in leader_ras} == {("failed", err)} and want["leader"]["batches"] == []
    helper_ras = [ra for job in want["helper"]["jobs"] for ra in job[2]]
    if kind == "fake_fails_prep_init":
        assert helper_ras == []  # nothing was sent
    elif kind == "fake_fails_prep_step":
        assert {(ra[3], ra[5]) for ra in helper_ras} == {("failed", err)}


# --- the continue route's problem documents, app level --------------------


CONTINUE_CASES = ["one-round-task", "media-type", "bearer", "unknown-task", "undecodable"]


@pytest.mark.parametrize("case", CONTINUE_CASES)
def test_continue_route_problem_documents_match_janus_tpu(case):
    """janus_tpu's and the port's DapHttpApp over one one-round Count
    helper task answer a continue request alike."""
    leader, helper, _ = make_tasks(j_registry.VdafInstance.count())
    j_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
    t_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
    try:
        j_eph.datastore.run_tx(lambda tx: tx.put_task(helper))
        t_eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(helper.to_dict())))
        apps = [j_http.DapHttpApp(j_core.Aggregator(j_eph.datastore, j_eph.clock, j_core.Config())),
                t_http.DapHttpApp(t_core.Aggregator(t_eph.datastore, t_eph.clock, device="cpu"))]
        tid = helper.task_id.data
        path = f"/tasks/{_b64(tid)}/aggregation_jobs/{_b64(bytes(16))}"
        headers = {"Content-Type": jm.AggregationJobContinueReq.MEDIA_TYPE,
                   **helper.aggregator_auth_token.request_headers()}
        body = jm.AggregationJobContinueReq(jm.AggregationJobStep(1), ()).to_bytes()
        if case == "media-type":
            headers["Content-Type"] = jm.AggregationJobInitializeReq.MEDIA_TYPE
        elif case == "bearer":
            headers.update(AuthenticationToken.bearer("not-the-token").request_headers())
        elif case == "unknown-task":
            path = f"/tasks/{_b64(bytes(32))}/aggregation_jobs/{_b64(bytes(16))}"
        elif case == "undecodable":
            body = b"\x00"
        got = [app.handle("POST", path, {}, dict(headers), body) for app in apps]
        for app in apps:
            app.close()
    finally:
        j_eph.cleanup()
        t_eph.cleanup()
    assert got[1][:3] == got[0][:3]
    doc = json.loads(got[0][2])
    assert got[0][0] == 400
    if case == "one-round-task":
        assert doc["type"].endswith(":stepMismatch")
