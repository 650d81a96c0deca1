"""janus_tpu_torch's leader and helper over loopback HTTP, paired with janus_tpu's.

Four pairings step the same aggregation job: a janus_tpu leader driver
with a janus_tpu helper (the reference), a port leader with a janus_tpu
helper, a janus_tpu leader with a port helper, and a port pair. Each
pairing starts from fresh SQLite datastores holding the same tasks, the
same stored reports (the same sealed bytes) and the same job, written
directly under one fixed job id; the leader's `JobDriver.run_once`
steps it through its HttpClient against the helper's `DapServer` on
port 0. The leader's and the helper's report aggregations (decrypted),
batch aggregations and job rows (lease columns included) must equal the
reference pairing's, byte for byte. Tolerance: exact equality.

The job carries a corrupted leader share (VDAF_PREP_ERROR), a helper
share sealed under an unknown HPKE config id (HPKE_UNKNOWN_CONFIG_ID)
and a truncated leader share (INVALID_MESSAGE, never sent), and spans
two time windows; the leader's and the helper's stored shares unshard to
the accepted reports' sum in each window. Circuits: Count, a narrow
SumVec (joint randomness), and draft Count.

`DapHttpApp`'s problem documents are held against janus_tpu's for the
same requests: a bad media type, a wrong bearer token, an unknown task,
a mismatched XOF mode, an undecodable body; and its hpke_config and
unknown-route answers. A spent propagated deadline sheds 503 before the
handler, as janus_tpu's admission controller sheds it; a budget that
dies inside the handler answers the conclusive 408.

The port runs with device="cpu". The JAX engines are pinned to one
device, as in tests/test_torch_aggregate_init.py.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import aggregation_job_driver as j_driver
from janus_tpu.aggregator import core as j_core
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.aggregator import job_driver as j_jobs
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu.core import http_client as j_client
from janus_tpu.core import retries as j_retries
from janus_tpu.core import time_util as j_time
from janus_tpu.core.auth import AuthenticationToken
from janus_tpu.core.hpke import generate_hpke_config_and_private_key
from janus_tpu.datastore import models as j_models
from janus_tpu.datastore import store as j_store
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import aggregation_job_driver as t_driver
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.aggregator import job_driver as t_jobs
from janus_tpu_torch.aggregator.engine_cache import engine_cache
from janus_tpu_torch.aggregator.testing import leader_init_request, leader_stored_reports
from janus_tpu_torch.convert import step_args_to_numpy
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core import http_client as t_client
from janus_tpu_torch.core import retries as t_retries
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.task import Task
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements
from test_torch_engine_cache import jax_single_device

CPU = torch.device("cpu")
NOW = 1_700_000_000  # 800 s into a 3600 s window
WINDOW_A = NOW - 100
WINDOW_B = NOW - 2000  # the window before
CIRCUITS = {
    "count": {"kind": "count"},
    "sumvec": {"kind": "sumvec", "length": 3, "bits": 2},
    "draft-count": {"kind": "count", "xof_mode": "draft"},
}
N = 8
CORRUPT, UNKNOWN_CONFIG, BAD_SHARE = 2, 4, 6
JOB_ID = bytes(range(16))
PAIRINGS = ["torch-jax", "jax-torch", "torch-torch"]


def _bump(field_np, row: int, modulus: int):
    v = (sum(int(x[row, 0]) << (64 * i) for i, x in enumerate(field_np)) + 1) % modulus
    out = tuple(x.copy() for x in field_np)
    for i, y in enumerate(out):
        y[row, 0] = np.uint64((v >> (64 * i)) & ((1 << 64) - 1))
    return out


class Circuit:
    """One circuit's tasks, stored reports and job, in both packages'
    types, and the rows of the reference pairing."""

    def __init__(self, name: str):
        self.name = name
        kw = CIRCUITS[name]
        self.t_inst = t_registry.VdafInstance(**kw)
        self.token = AuthenticationToken.random_bearer()
        self.j_leader = (
            j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j_registry.VdafInstance(**kw), jm.Role.LEADER)
            .with_(vdaf_verify_key=bytes(range(16)), aggregator_auth_token=self.token)
            .build()
        )
        self.j_helper = dataclasses.replace(
            self.j_leader, role=jm.Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
        )
        meas = random_measurements(self.t_inst, N, np.random.default_rng(7))
        args = list(step_args_to_numpy(make_report_batch(self.t_inst, meas, seed=7, device=CPU)[0]))
        modulus = t_registry.circuit_for(self.t_inst).FIELD.MODULUS
        args[2] = _bump(args[2], CORRUPT, modulus)
        self.times = [WINDOW_A if i % 2 else WINDOW_B for i in range(N)]
        t_helper = Task.from_dict(self.j_helper.to_dict())
        reports = leader_stored_reports(
            Task.from_dict(self.j_leader.to_dict()), t_helper.hpke_keys[0].config, args, self.times
        )
        ct = reports[UNKNOWN_CONFIG].helper_encrypted_input_share
        reports[UNKNOWN_CONFIG] = dataclasses.replace(
            reports[UNKNOWN_CONFIG],
            helper_encrypted_input_share=dataclasses.replace(ct, config_id=tm.HpkeConfigId(9)),
        )
        reports[BAD_SHARE] = dataclasses.replace(
            reports[BAD_SHARE], leader_input_share=reports[BAD_SHARE].leader_input_share[:-1]
        )
        self.t_reports = reports
        self.meas = np.asarray(meas)
        self.accepted = np.array([i not in (CORRUPT, UNKNOWN_CONFIG, BAD_SHARE) for i in range(N)])
        self.reference = None

    # --- the two packages' rows --------------------------------------
    def _leader_rows(self, pkg, task):
        m, models = (jm, j_models) if pkg == "jax" else (tm, t_models)
        reports = [
            models.LeaderStoredReport(
                m.TaskId(r.task_id.data),
                m.ReportId(r.report_id.data),
                m.Time(r.client_time.seconds),
                r.public_share,
                r.leader_input_share,
                m.HpkeCiphertext.from_bytes(r.helper_encrypted_input_share.to_bytes()),
            )
            for r in self.t_reports
        ]
        job_id = m.AggregationJobId(JOB_ID)
        job = models.AggregationJobModel(
            task.task_id,
            job_id,
            b"",
            m.PartialBatchSelector.time_interval().to_bytes(),
            m.Interval(m.Time(WINDOW_B), m.Duration(WINDOW_A - WINDOW_B + 1)),
            models.AggregationJobState.IN_PROGRESS,
            0,
        )
        ras = [
            models.ReportAggregationModel(
                task.task_id, job_id, r.report_id, r.client_time, i, models.ReportAggregationState.START
            )
            for i, r in enumerate(reports)
        ]
        return reports, job, ras

    def run(self, leader: str, helper: str):
        """Step the job with a `leader` driver against a `helper` server;
        returns (leader rows, helper rows)."""
        if helper == "jax":
            h_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
            h_task = self.j_helper
            agg = j_core.Aggregator(h_eph.datastore, h_eph.clock, j_core.Config())
            srv = j_http.DapServer(j_http.DapHttpApp(agg)).start()
        else:
            h_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
            h_task = Task.from_dict(self.j_helper.to_dict())
            agg = t_core.Aggregator(h_eph.datastore, h_eph.clock, device=CPU)
            srv = t_http.DapServer(t_http.DapHttpApp(agg)).start()
        l_eph = None
        try:
            h_eph.datastore.run_tx(lambda tx: tx.put_task(h_task))
            j_leader = dataclasses.replace(self.j_leader, helper_aggregator_endpoint=srv.url)
            if leader == "jax":
                l_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
                task = j_leader
                driver = j_driver.AggregationJobDriver(
                    l_eph.datastore,
                    j_client.HttpClient(timeout=30),
                    j_driver.AggregationJobDriverConfig(http_backoff=j_retries.Backoff.test()),
                    breakers=j_cb.OutboundCircuitBreakers(),
                )
                jobs = j_jobs
            else:
                l_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
                task = Task.from_dict(j_leader.to_dict())
                driver = t_driver.AggregationJobDriver(
                    l_eph.datastore,
                    t_client.HttpClient(timeout=30),
                    t_driver.AggregationJobDriverConfig(http_backoff=t_retries.Backoff.test()),
                    breakers=t_cb.OutboundCircuitBreakers(),
                    device=CPU,
                )
                jobs = t_jobs
            reports, job, ras = self._leader_rows(leader, task)

            def seed(tx):
                tx.put_task(task)
                for r in reports:
                    tx.put_client_report(r)
                tx.put_aggregation_job(job)
                for ra in ras:
                    tx.put_report_aggregation(ra)

            l_eph.datastore.run_tx(seed)
            cfg = jobs.JobDriverConfig(max_concurrent_job_workers=1)
            assert jobs.JobDriver(cfg, driver.acquirer(), driver.stepper).run_once() == 1
            return read_rows(l_eph.datastore, leader), read_rows(h_eph.datastore, helper)
        finally:
            srv.stop()
            h_eph.cleanup()
            if l_eph is not None:
                l_eph.cleanup()


def read_rows(ds, pkg):
    """The job's report aggregations (decrypted), the task's batch
    aggregations, and the job row with its lease columns."""
    m = jm if pkg == "jax" else tm

    def fn(tx):
        (task_id,) = tx._c.execute("SELECT task_id FROM tasks").fetchone()
        tid, job = m.TaskId(task_id), m.AggregationJobId(JOB_ID)
        ras = [
            (r.report_id.data, r.client_time.seconds, r.ord, r.state.value, r.prep_blob,
             None if r.prepare_error is None else int(r.prepare_error))
            for r in tx.get_report_aggregations_for_job(tid, job)
        ]
        bas = tx._c.execute(
            "SELECT batch_identifier, aggregation_parameter, ord, state, aggregate_share, report_count,"
            " client_interval_start, client_interval_duration, checksum FROM batch_aggregations"
            " WHERE task_id = ? ORDER BY batch_identifier, ord",
            (task_id,),
        ).fetchall()
        j = tx.get_aggregation_job(tid, job)
        lease = tx._c.execute(
            "SELECT lease_expiry, lease_token IS NULL, lease_attempts, shard_key FROM aggregation_jobs"
            " WHERE task_id = ? AND job_id = ?",
            (task_id, JOB_ID),
        ).fetchone()
        agg_job = (j.aggregation_parameter, j.partial_batch_identifier, j.client_timestamp_interval.to_bytes(),
                   j.state.value, j.step, j.last_request_hash, tuple(lease))
        return ras, bas, agg_job

    return ds.run_tx(fn)


@pytest.fixture(scope="module", params=list(CIRCUITS))
def circuit(request):
    with jax_single_device():
        c = Circuit(request.param)
        c.reference = c.run("jax", "jax")
        yield c


def test_reference_pairing_reaches_the_ground_truth(circuit):
    """The janus_tpu pair's rows: the job finished and released, each
    reject with its error, and the two stored shares unshard to the
    accepted reports' sum in each window."""
    (l_ras, l_bas, l_job), (h_ras, h_bas, h_job) = circuit.reference
    assert l_job[3] == "finished" and l_job[6][1:3] == (1, 0)
    errors = {ra[0]: ra[5] for ra in l_ras}
    P = jm.PrepareError
    ids = [r.report_id.data for r in circuit.t_reports]
    assert errors[ids[CORRUPT]] == int(P.VDAF_PREP_ERROR)
    assert errors[ids[UNKNOWN_CONFIG]] == int(P.HPKE_UNKNOWN_CONFIG_ID)
    assert errors[ids[BAD_SHARE]] == int(P.INVALID_MESSAGE)
    assert [ra[3] for ra in l_ras] == ["finished" if a else "failed" for a in circuit.accepted]
    assert len(h_ras) == N - 1  # the truncated share was never sent
    field = t_registry.circuit_for(circuit.t_inst).FIELD
    assert len(l_bas) == len(h_bas) == 2  # two windows
    tp = Task.from_dict(circuit.j_leader.to_dict()).time_precision
    for lb, hb in zip(l_bas, h_bas):
        assert lb[0] == hb[0] and lb[5] == hb[5]
        window = tm.Interval.from_bytes(lb[0]).start
        lanes = circuit.accepted & np.array([tm.Time(t).to_batch_interval_start(tp) == window for t in circuit.times])
        total = [(a + b) % field.MODULUS for a, b in zip(field.decode_vec(lb[4]), field.decode_vec(hb[4]))]
        assert lb[5] == int(lanes.sum())
        assert total == [int(x) for x in circuit.meas[lanes].sum(axis=0).reshape(-1)]


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_pairing_rows_equal_janus_tpu_pair(circuit, pairing):
    leader, helper = pairing.split("-")
    with jax_single_device():
        got = circuit.run(leader, helper)
    assert got[0] == circuit.reference[0], "leader rows differ"
    assert got[1] == circuit.reference[1], "helper rows differ"


def test_leader_and_helper_share_one_engine(circuit):
    """In one process the port's leader driver and its helper reach the
    same EngineCache (keyed by VDAF, verify key and device)."""
    inst, key = circuit.t_inst, circuit.j_leader.vdaf_verify_key
    eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
    try:
        eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(circuit.j_helper.to_dict())))
        helper = t_core.Aggregator(eph.datastore, eph.clock, device=CPU)
        ta = helper.task_aggregator_for(tm.TaskId(circuit.j_helper.task_id.data))
        assert ta.engine is engine_cache(inst, key, CPU)
    finally:
        eph.cleanup()


# --- problem documents -------------------------------------------------


@pytest.fixture(scope="module")
def apps():
    """A janus_tpu and a port DapHttpApp over helpers holding one task."""
    token = AuthenticationToken.random_bearer()
    j_task_ = (
        j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j_registry.VdafInstance.count(), jm.Role.HELPER)
        .with_(aggregator_auth_token=token)
        .build()
    )
    j_eph = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
    t_eph = EphemeralDatastore(MockClock(tm.Time(NOW)))
    j_eph.datastore.run_tx(lambda tx: tx.put_task(j_task_))
    t_eph.datastore.run_tx(lambda tx: tx.put_task(Task.from_dict(j_task_.to_dict())))
    with jax_single_device():
        j_app = j_http.DapHttpApp(j_core.Aggregator(j_eph.datastore, j_eph.clock, j_core.Config()))
        t_app = t_http.DapHttpApp(t_core.Aggregator(t_eph.datastore, t_eph.clock, device=CPU))
        yield j_task_, token, j_app, t_app
    j_app.close()
    j_eph.cleanup()
    t_eph.cleanup()


def _b64(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).decode().rstrip("=")


PROBLEM_CASES = ["media-type", "bearer", "unknown-task", "xof-mode", "undecodable", "hpke-config", "hpke-config-unknown",
                 "unknown-route"]


@pytest.mark.parametrize("case", PROBLEM_CASES)
def test_problem_documents_match_janus_tpu(apps, case):
    task, token, j_app, t_app = apps
    media = jm.AggregationJobInitializeReq.MEDIA_TYPE
    tid = task.task_id.data
    headers = {"Content-Type": media, **token.request_headers()}
    body = jm.AggregationJobInitializeReq(b"", jm.PartialBatchSelector.time_interval(), ()).to_bytes()
    method, query = "PUT", {}
    path = f"/tasks/{_b64(tid)}/aggregation_jobs/{_b64(JOB_ID)}"
    if case == "media-type":
        headers["Content-Type"] = "application/octet-stream"
    elif case == "bearer":
        headers.update(AuthenticationToken.bearer("not-the-token").request_headers())
    elif case == "unknown-task":
        path = f"/tasks/{_b64(bytes(32))}/aggregation_jobs/{_b64(JOB_ID)}"
    elif case == "xof-mode":
        headers[t_http.XOF_MODE_HEADER] = "draft"
    elif case == "undecodable":
        body = b"\x00\x01"
    elif case.startswith("hpke-config"):
        method, path, body = "GET", "/hpke_config", b""
        query = {"task_id": _b64(tid if case == "hpke-config" else bytes(32))}
    else:
        method, path = "GET", "/tasks/x/nothing"
    with jax_single_device():
        want = j_app.handle(method, path, query, dict(headers), body)
        got = t_app.handle(method, path, query, dict(headers), body)
    assert got[:3] == want[:3]
    assert got[0] == (200 if case == "hpke-config" else 404 if case == "unknown-route" else 400)


def _init_request(task):
    meas = random_measurements(t_registry.VdafInstance.count(), 2, np.random.default_rng(3))
    args, _ = make_report_batch(t_registry.VdafInstance.count(), meas, seed=3, device=CPU)
    t_task = Task.from_dict(task.to_dict())
    job = leader_init_request(t_task, engine_cache(t_task.vdaf, t_task.vdaf_verify_key, CPU), args, [NOW - 100] * 2)
    return f"/tasks/{_b64(task.task_id.data)}/aggregation_jobs/{_b64(bytes(16))}", job.request


def test_spent_propagated_budget_sheds_503_as_janus_tpu(apps):
    """A request whose DAP-Janus-Deadline is already spent is shed by
    admission before the handler, with janus_tpu's 503, problem document
    and Retry-After."""
    task, token, j_app, t_app = apps
    headers = {"Content-Type": jm.AggregationJobInitializeReq.MEDIA_TYPE, "DAP-Janus-Deadline": "0.000",
               **token.request_headers()}
    path, body = _init_request(task)
    with jax_single_device():
        want = j_app.handle("PUT", path, {}, dict(headers), body)
    got = t_app.handle("PUT", path, {}, dict(headers), body)
    assert got == want
    assert got[:2] == (503, "application/problem+json") and got[3] == {"Retry-After": "1"}
    assert b"deadline_expired" in got[2]


def test_dead_propagated_budget_answers_the_conclusive_408(apps, monkeypatch):
    """A budget that dies inside the handler (here: during the HPKE open)
    drops the request at the next stage boundary with the conclusive 408,
    which the leader steps back on."""
    task, token, _, t_app = apps
    headers = {"Content-Type": jm.AggregationJobInitializeReq.MEDIA_TYPE, "DAP-Janus-Deadline": "0.300",
               **token.request_headers()}
    path, body = _init_request(task)
    open_batch = t_core.hpke_open_batch

    def slow_open(*a, **kw):
        time.sleep(0.6)
        return open_batch(*a, **kw)

    monkeypatch.setattr(t_core, "hpke_open_batch", slow_open)
    status, ctype, out, _ = t_app.handle("PUT", path, {}, headers, body)
    assert (status, ctype) == (408, "application/problem+json")
    assert b"deadline exceeded during helper_" in out  # a stage boundary inside the handler
