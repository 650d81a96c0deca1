"""janus_tpu_torch's taskprov held against janus_tpu's.

- Wire: a TaskConfig of every VdafType, under both query types, encodes
  to the same bytes in both packages, each package decodes the other's
  bytes to an equal config, and both compute the same task ID and map
  the VdafType to the same VdafInstance.
- Keys: the RFC 5869 HKDF vector; a PeerAggregator round-trips through
  either package's `to_dict`/`from_dict` and derives the same verify key.
- Datastore: the taskprov peer and global HPKE key ops on both of the
  port's engines (SQLite, and Postgres over pg_fake), and a global
  keypair row written by janus_tpu decrypts in the port.
- Opt-in end to end, in all four leader/helper pairings (janus_tpu or
  the port on each side): a helper that holds only a global HPKE keypair
  and its taskprov peer answers the client's hpke_config with the global
  config, provisions the task on the first aggregate-init carrying the
  dap-taskprov header, and the batch is collected. The same uploaded
  report bytes go to every pairing; the helper's provisioned task, both
  sides' batch aggregations and the collection must equal the janus_tpu
  pair's, and the collection the ground truth.
- Rejections: the requests of tests/test_taskprov.py's rejection test
  (and a few more) get the same status and problem document from a port
  helper as from a janus_tpu helper.

The port runs with device="cpu"; tolerance: exact equality. Circuit:
Prio3Count (and Histogram of length 4 for the wire), four reports.
"""

import base64
import dataclasses
from types import SimpleNamespace

import pytest

from janus_tpu import collector as j_collector
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu import taskprov as j_taskprov
from janus_tpu.aggregator import aggregation_job_creator as j_creator
from janus_tpu.aggregator import aggregation_job_driver as j_driver
from janus_tpu.aggregator import collection_job_driver as j_cdriver
from janus_tpu.aggregator import core as j_core
from janus_tpu.aggregator import http_handlers as j_http
from janus_tpu.aggregator import job_driver as j_jobs
from janus_tpu.core import circuit_breaker as j_cb
from janus_tpu.core import hpke as j_hpke
from janus_tpu.core import http_client as j_client
from janus_tpu.core import retries as j_retries
from janus_tpu.core import time_util as j_time
from janus_tpu.core.auth import AuthenticationToken as JToken
from janus_tpu.datastore import store as j_store
from janus_tpu.messages import taskprov as j_tp
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import collector as t_collector
from janus_tpu_torch import messages as tm
from janus_tpu_torch import taskprov as t_taskprov
from janus_tpu_torch.aggregator import aggregation_job_creator as t_creator
from janus_tpu_torch.aggregator import aggregation_job_driver as t_driver
from janus_tpu_torch.aggregator import collection_job_driver as t_cdriver
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import http_handlers as t_http
from janus_tpu_torch.aggregator import job_driver as t_jobs
from janus_tpu_torch.aggregator.testing import TaskprovHeaderHttp
from janus_tpu_torch.client import Client, ClientParameters
from janus_tpu_torch.core import circuit_breaker as t_cb
from janus_tpu_torch.core import hpke as t_hpke
from janus_tpu_torch.core import http_client as t_client
from janus_tpu_torch.core import retries as t_retries
from janus_tpu_torch.core.auth import AuthenticationToken
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import store as t_store
from janus_tpu_torch.messages import taskprov as t_tp
from janus_tpu_torch.task import QueryTypeConfig, Task, TaskBuilder
from janus_tpu_torch.vdaf import registry as t_registry

from tests.test_torch_engine_cache import jax_single_device

CPU = "cpu"
NOW = 1_700_000_000
TP = 3600
LEADER_URL, HELPER_URL = "https://leader.example/", "https://helper.example/"
MEASUREMENTS = [1, 0, 1, 1]
VDAF_TYPES = {
    "count": lambda tp: tp.VdafType.prio3_count(),
    "sum": lambda tp: tp.VdafType.prio3_sum(32),
    "histogram": lambda tp: tp.VdafType.prio3_histogram([10, 20, 30]),
    "poplar1": lambda tp: tp.VdafType.poplar1(16),
}


def task_config(tp, m, vdaf: str = "count", query_type: str = "time_interval", **kw):
    fixed = query_type == "fixed_size"
    qc = tp.QueryConfig(
        time_precision=m.Duration(TP),
        max_batch_query_count=1,
        min_batch_size=1,
        query_type=tp.TaskprovQueryType.FIXED_SIZE if fixed else tp.TaskprovQueryType.TIME_INTERVAL,
        max_batch_size=100 if fixed else None,
    )
    cfg = tp.TaskConfig(
        task_info=b"taskprov port test",
        aggregator_endpoints=(LEADER_URL, HELPER_URL),
        query_config=qc,
        task_expiration=m.Time(2_000_000_000),
        vdaf_config=tp.VdafConfig(tp.DpConfig(), VDAF_TYPES[vdaf](tp)),
    )
    return dataclasses.replace(cfg, **kw)


# --- wire ---------------------------------------------------------------


@pytest.mark.parametrize("query_type", ["time_interval", "fixed_size"])
@pytest.mark.parametrize("vdaf", list(VDAF_TYPES))
def test_task_config_bytes_equal_janus_tpu(vdaf, query_type):
    j_cfg = task_config(j_tp, jm, vdaf, query_type)
    t_cfg = task_config(t_tp, tm, vdaf, query_type)
    raw = j_cfg.to_bytes()
    assert t_cfg.to_bytes() == raw
    assert t_tp.TaskConfig.from_bytes(raw) == t_cfg
    assert j_tp.TaskConfig.from_bytes(t_cfg.to_bytes()) == j_cfg
    assert t_cfg.computed_task_id().data == j_cfg.computed_task_id().data
    assert (t_cfg.leader_url(), t_cfg.helper_url()) == (LEADER_URL, HELPER_URL)
    t_inst = t_cfg.vdaf_config.vdaf_type.to_vdaf_instance()
    assert t_inst.to_dict() == j_cfg.vdaf_config.vdaf_type.to_vdaf_instance().to_dict()


def test_histogram_boundaries_map_to_buckets_and_decode_errors_match():
    # 9,999 boundaries are Prio3Histogram(10000), the chip's taskprov task
    vt = t_tp.VdafType.prio3_histogram(range(1, 10000))
    assert vt.to_vdaf_instance() == t_registry.VdafInstance.histogram(10000)
    assert t_tp.VdafType.from_bytes(vt.to_bytes()) == vt
    for bad in (
        bytes.fromhex("00000002") + b"\x00\x00\x09" + bytes(9),  # not a multiple of 8
        bytes.fromhex("00000002") + b"\x00\x00\x00",  # no buckets
        bytes.fromhex("0000abcd"),  # unknown code
    ):
        with pytest.raises(tm.DecodeError) as t_err:
            t_tp.VdafType.from_bytes(bad)
        with pytest.raises(jm.DecodeError) as j_err:
            j_tp.VdafType.from_bytes(bad)
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="helper"):
        task_config(t_tp, tm, aggregator_endpoints=(LEADER_URL,)).helper_url()


# --- keys ---------------------------------------------------------------


def test_hkdf_rfc5869_vector1():
    okm = t_taskprov.hkdf_sha256(
        bytes.fromhex("000102030405060708090a0b0c"), bytes.fromhex("0b" * 22), bytes.fromhex("f0f1f2f3f4f5f6f7f8f9"), 42
    )
    assert okm == bytes.fromhex("3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf34007208d5b887185865")
    assert t_taskprov.TASKPROV_SALT == j_taskprov.TASKPROV_SALT


@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_peer_aggregator_round_trips_and_derives_the_same_key(direction):
    src, dst = (j_taskprov, t_taskprov) if direction == "jax-to-torch" else (t_taskprov, j_taskprov)
    peer = src.PeerAggregatorBuilder().with_(endpoint=LEADER_URL).build()
    other = dst.PeerAggregator.from_dict(peer.to_dict())
    assert other.to_dict() == peer.to_dict()
    assert src.PeerAggregator.from_dict(other.to_dict()) == peer
    for tid in (bytes(32), bytes(range(32))):
        assert other.derive_vdaf_verify_key(tm.TaskId(tid) if dst is t_taskprov else jm.TaskId(tid)) == (
            peer.derive_vdaf_verify_key(jm.TaskId(tid) if src is j_taskprov else tm.TaskId(tid))
        )
    headers = peer.primary_aggregator_auth_token().request_headers()
    assert other.check_aggregator_auth(headers) and not other.check_aggregator_auth({"Authorization": "Bearer x"})


# --- datastore ------------------------------------------------------------


@pytest.mark.parametrize("engine", ["sqlite", "pgfake"])
def test_peer_and_global_key_ops(engine):
    eph = t_store.EphemeralDatastore(MockClock(tm.Time(NOW)), engine=engine)
    ds = eph.datastore
    try:
        peer = t_taskprov.PeerAggregatorBuilder().with_(endpoint=LEADER_URL).build()
        ds.run_tx(lambda tx: tx.put_taskprov_peer_aggregator(peer))
        # the upsert replaces the row of the same (endpoint, role)
        peer2 = dataclasses.replace(peer, tolerable_clock_skew=tm.Duration(7))
        ds.run_tx(lambda tx: tx.put_taskprov_peer_aggregator(peer2))
        assert ds.run_tx(lambda tx: tx.get_taskprov_peer_aggregator(LEADER_URL, tm.Role.LEADER)) == peer2
        assert ds.run_tx(lambda tx: tx.get_taskprov_peer_aggregator(LEADER_URL, tm.Role.HELPER)) is None
        assert ds.run_tx(lambda tx: tx.get_taskprov_peer_aggregators()) == [peer2]
        ds.run_tx(lambda tx: tx.delete_taskprov_peer_aggregator(LEADER_URL, tm.Role.LEADER))
        assert ds.run_tx(lambda tx: tx.get_taskprov_peer_aggregators()) == []

        kps = [t_hpke.generate_hpke_config_and_private_key(config_id=i) for i in (3, 4)]
        ds.run_tx(lambda tx: tx.put_global_hpke_keypair(kps[0], state="active"))
        ds.run_tx(lambda tx: tx.put_global_hpke_keypair(kps[1]))
        got = ds.run_tx(lambda tx: tx.get_global_hpke_keypairs())
        assert sorted((kp.config.to_bytes(), kp.private_key, st) for kp, st in got) == sorted(
            [(kps[0].config.to_bytes(), kps[0].private_key, "active"), (kps[1].config.to_bytes(), kps[1].private_key, "pending")]
        )
        ds.run_tx(lambda tx: tx.set_global_hpke_keypair_state(4, "expired"))
        ds.run_tx(lambda tx: tx.delete_global_hpke_keypair(3))
        got = ds.run_tx(lambda tx: tx.get_global_hpke_keypairs())
        assert [(kp.config.id.id, st) for kp, st in got] == [(4, "expired")]
    finally:
        eph.cleanup()


def test_janus_tpu_global_keypair_row_decrypts_in_the_port(tmp_path):
    key = bytes(range(16))
    path = str(tmp_path / "ds.sqlite")
    j_ds = j_store.Datastore(path, j_store.Crypter([key]), j_time.MockClock(jm.Time(NOW)))
    j_kp = j_hpke.generate_hpke_config_and_private_key(config_id=9)
    j_peer = j_taskprov.PeerAggregatorBuilder().with_(endpoint=LEADER_URL).build()
    j_ds.run_tx(lambda tx: tx.put_global_hpke_keypair(j_kp, state="active"))
    j_ds.run_tx(lambda tx: tx.put_taskprov_peer_aggregator(j_peer))
    j_ds.close()
    t_ds = t_store.Datastore(path, t_store.Crypter([key]), MockClock(tm.Time(NOW)))
    try:
        ((kp, state),) = t_ds.run_tx(lambda tx: tx.get_global_hpke_keypairs())
        assert (kp.config.to_bytes(), kp.private_key, state) == (j_kp.config.to_bytes(), j_kp.private_key, "active")
        (peer,) = t_ds.run_tx(lambda tx: tx.get_taskprov_peer_aggregators())
        assert peer.to_dict() == j_peer.to_dict()
        # and the cache serves it: advertised while active, decrypting
        from janus_tpu_torch.aggregator.cache import GlobalHpkeKeypairCache

        cache = GlobalHpkeKeypairCache(t_ds)
        assert [c.to_bytes() for c in cache.configs()] == [j_kp.config.to_bytes()]
        assert cache.keypair(9).private_key == j_kp.private_key and cache.keypair(8) is None
    finally:
        t_ds.close()


# --- opt-in end to end ----------------------------------------------------

PKG = {
    "jax": SimpleNamespace(
        m=jm, tp=j_tp, core=j_core, http=j_http, creator=j_creator, driver=j_driver, cdriver=j_cdriver,
        jobs=j_jobs, cb=j_cb, retries=j_retries, client=j_client, collector=j_collector, taskprov=j_taskprov,
        hpke=j_hpke,
        eph=lambda: j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW))),
        agg=lambda eph, cfg: j_core.Aggregator(eph.datastore, eph.clock, cfg),
        task=lambda d: j_task.Task.from_dict(d),
        inst=lambda d: j_registry.VdafInstance.from_dict(d),
    ),
    "torch": SimpleNamespace(
        m=tm, tp=t_tp, core=t_core, http=t_http, creator=t_creator, driver=t_driver, cdriver=t_cdriver,
        jobs=t_jobs, cb=t_cb, retries=t_retries, client=t_client, collector=t_collector, taskprov=t_taskprov,
        hpke=t_hpke,
        eph=lambda: t_store.EphemeralDatastore(MockClock(tm.Time(NOW))),
        agg=lambda eph, cfg: t_core.Aggregator(eph.datastore, eph.clock, cfg, device=CPU),
        task=lambda d: Task.from_dict(d),
        inst=lambda d: t_registry.VdafInstance.from_dict(d),
    ),
}


def _header_http(pkg: str, cfg_bytes: bytes):
    """The leader's HTTP client of the taskprov task, in its package."""
    if pkg == "torch":
        return TaskprovHeaderHttp(t_tp.TaskConfig.from_bytes(cfg_bytes), timeout=30)
    from tests.test_taskprov import TaskprovHeaderHttp as JTaskprovHeaderHttp

    http = JTaskprovHeaderHttp(j_tp.TaskConfig.from_bytes(cfg_bytes))
    http.timeout = 30
    return http


class OptIn:
    """The shared inputs of every pairing: the TaskConfig, the peer's
    secrets, the helper's global keypair, the leader's task (provisioned
    out of band) and the uploaded report bytes."""

    def __init__(self):
        self.cfg = task_config(t_tp, tm)
        self.cfg_bytes = self.cfg.to_bytes()
        self.task_id = self.cfg.computed_task_id()
        self.collector_kp = t_hpke.generate_hpke_config_and_private_key(config_id=200)
        self.global_kp = t_hpke.generate_hpke_config_and_private_key(config_id=7)
        self.peer = (
            t_taskprov.PeerAggregatorBuilder()
            .with_(
                endpoint=LEADER_URL,
                role=tm.Role.LEADER,
                collector_hpke_config=self.collector_kp.config,
                aggregator_auth_tokens=(AuthenticationToken.random_bearer(),),
                collector_auth_tokens=(AuthenticationToken.random_bearer(),),
            )
            .build()
        )
        inst = self.cfg.vdaf_config.vdaf_type.to_vdaf_instance()
        self.leader_task = (
            TaskBuilder(QueryTypeConfig.time_interval(), inst, tm.Role.LEADER)
            .with_(
                task_id=self.task_id,
                leader_aggregator_endpoint=LEADER_URL,
                vdaf_verify_key=self.peer.derive_vdaf_verify_key(self.task_id),
                collector_hpke_config=self.collector_kp.config,
                aggregator_auth_token=self.peer.primary_aggregator_auth_token(),
                collector_auth_token=self.peer.primary_collector_auth_token(),
                task_expiration=self.cfg.task_expiration,
                time_precision=tm.Duration(TP),
                min_batch_size=1,
            )
            .build()
        )
        params = ClientParameters(self.task_id, LEADER_URL, HELPER_URL, tm.Duration(TP))
        client = Client(params, inst, self.leader_task.hpke_keys[0].config, self.global_kp.config,
                        clock=MockClock(tm.Time(NOW)))
        self.reports = [client.prepare_report(m).to_bytes() for m in MEASUREMENTS]

    def run(self, leader: str, helper: str):
        """One pairing: upload, opt-in step, collection. Returns the rows
        that must equal across pairings."""
        L, H = PKG[leader], PKG[helper]
        h_eph, l_eph = H.eph(), L.eph()
        servers, aggs = [], []
        try:
            h_eph.datastore.run_tx(lambda tx: tx.put_global_hpke_keypair(
                H.hpke.HpkeKeypair(H.m.HpkeConfig.from_bytes(self.global_kp.config.to_bytes()),
                                   self.global_kp.private_key), state="active"))
            h_eph.datastore.run_tx(lambda tx: tx.put_taskprov_peer_aggregator(
                H.taskprov.PeerAggregator.from_dict(self.peer.to_dict())))
            helper_agg = H.agg(h_eph, H.core.Config(taskprov_enabled=True))
            aggs.append(helper_agg)
            h_srv = H.http.DapServer(H.http.DapHttpApp(helper_agg)).start()
            servers.append(h_srv)
            leader_agg = L.agg(l_eph, L.core.Config())
            aggs.append(leader_agg)
            l_srv = L.http.DapServer(L.http.DapHttpApp(leader_agg)).start()
            servers.append(l_srv)
            task = L.task(dataclasses.replace(self.leader_task, helper_aggregator_endpoint=h_srv.url).to_dict())
            l_eph.datastore.run_tx(lambda tx: tx.put_task(task))

            # the helper advertises its global config for the unprovisioned task
            http = t_client.HttpClient(timeout=30)
            tid = base64.urlsafe_b64encode(self.task_id.data).decode().rstrip("=")
            status, body = http.get(h_srv.url + f"hpke_config?task_id={tid}")
            assert status == 200 and body == tm.HpkeConfigList((self.global_kp.config,)).to_bytes()
            for raw in self.reports:
                status, _ = http.put(l_srv.url + f"tasks/{tid}/reports", raw, {"Content-Type": tm.Report.MEDIA_TYPE})
                assert status == 201

            L.creator.AggregationJobCreator(
                l_eph.datastore, L.creator.AggregationJobCreatorConfig(min_aggregation_job_size=1)
            ).run_once()
            header_http = _header_http(leader, self.cfg_bytes)
            kw = {"device": CPU} if leader == "torch" else {}
            driver = L.driver.AggregationJobDriver(
                l_eph.datastore, header_http, L.driver.AggregationJobDriverConfig(http_backoff=L.retries.Backoff.test()),
                breakers=L.cb.OutboundCircuitBreakers(), **kw,
            )
            jobs_cfg = L.jobs.JobDriverConfig(max_concurrent_job_workers=1)
            assert L.jobs.JobDriver(jobs_cfg, driver.acquirer(), driver.stepper).run_once() == 1
            helper_task = h_eph.datastore.run_tx(lambda tx: tx.get_task(H.m.TaskId(self.task_id.data)))

            collector = L.collector.Collector(
                L.collector.CollectorParameters(
                    L.m.TaskId(self.task_id.data), l_srv.url, task.collector_auth_token,
                    L.hpke.HpkeKeypair(L.m.HpkeConfig.from_bytes(self.collector_kp.config.to_bytes()),
                                       self.collector_kp.private_key),
                ),
                L.inst(task.vdaf.to_dict()),
                L.client.HttpClient(timeout=30),
            )
            start = NOW - NOW % TP
            query = L.m.Query.time_interval(L.m.Interval(L.m.Time(start - TP), L.m.Duration(2 * TP)))
            job_id = collector.start_collection(query)
            cdriver = L.cdriver.CollectionJobDriver(
                l_eph.datastore, header_http, breakers=L.cb.OutboundCircuitBreakers(),
            )
            assert L.jobs.JobDriver(jobs_cfg, cdriver.acquirer(), cdriver.stepper).run_once() == 1
            result = collector.poll_once(job_id, query)

            def batch_rows(ds):
                return ds.run_tx(lambda tx: tx._c.execute(
                    "SELECT batch_identifier, aggregation_parameter, ord, state, aggregate_share, report_count,"
                    " client_interval_start, client_interval_duration, checksum FROM batch_aggregations"
                    " ORDER BY batch_identifier, ord").fetchall())

            return {
                "helper_task": helper_task.to_dict(),
                "helper_batches": batch_rows(h_eph.datastore),
                "leader_batches": batch_rows(l_eph.datastore),
                "result": (result.report_count, result.aggregate_result),
            }
        finally:
            for srv in servers:
                srv.stop()
            for agg in aggs:
                agg.close()
            h_eph.cleanup()
            l_eph.cleanup()


@pytest.fixture(scope="module")
def optin():
    with jax_single_device():
        o = OptIn()
        o.reference = o.run("jax", "jax")
        yield o


def test_reference_pairing_opts_in_and_reaches_the_ground_truth(optin):
    ref = optin.reference
    assert ref["result"] == (len(MEASUREMENTS), sum(MEASUREMENTS))
    task = ref["helper_task"]
    assert task["role"] == int(tm.Role.HELPER) and task["hpke_keys"] == []
    assert task["vdaf_verify_key"] == optin.leader_task.to_dict()["vdaf_verify_key"]
    assert task["vdaf"] == optin.leader_task.vdaf.to_dict()
    assert [r[5] for r in ref["helper_batches"]] == [len(MEASUREMENTS)]


@pytest.mark.parametrize("pairing", ["torch-jax", "jax-torch", "torch-torch"])
def test_opt_in_pairing_equals_janus_tpu_pair(optin, pairing):
    leader, helper = pairing.split("-")
    with jax_single_device():
        got = optin.run(leader, helper)
    assert got == optin.reference


# --- rejections -------------------------------------------------------------


@pytest.fixture(scope="module")
def helper_apps():
    """A janus_tpu and a port helper with taskprov enabled and one peer."""
    peer = t_taskprov.PeerAggregatorBuilder().with_(endpoint=LEADER_URL, role=tm.Role.LEADER).build()
    out = {}
    for name, P in PKG.items():
        eph = P.eph()
        eph.datastore.run_tx(lambda tx: tx.put_taskprov_peer_aggregator(P.taskprov.PeerAggregator.from_dict(peer.to_dict())))
        out[name] = (P.http.DapHttpApp(P.agg(eph, P.core.Config(taskprov_enabled=True))), eph)
    yield peer, {k: v[0] for k, v in out.items()}
    for app, eph in out.values():
        app.agg.close()
        eph.cleanup()


def _b64(b: bytes) -> str:
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


REJECTIONS = {
    "unknown peer": dict(cfg=dict(aggregator_endpoints=("https://other.example/", HELPER_URL))),
    "bad auth": dict(auth="Bearer nope"),
    "expired": dict(cfg=dict(task_expiration=tm.Time(1))),
    "task id mismatch": dict(task_id=bytes(32)),
    "one endpoint": dict(cfg=dict(aggregator_endpoints=(LEADER_URL,))),
    "undecodable header": dict(header="!!!not base64"),
    "poplar1 gate": dict(vdaf="poplar1"),
    "aggregate share route": dict(route="aggregate_share", cfg=dict(task_expiration=tm.Time(1))),
    "no header": dict(header=None),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_rejections_answer_as_janus_tpu(helper_apps, case):
    peer, apps = helper_apps
    spec = REJECTIONS[case]
    cfg = task_config(t_tp, tm, spec.get("vdaf", "count"), **spec.get("cfg", {}))
    raw = cfg.to_bytes()
    tid = spec.get("task_id", cfg.computed_task_id().data)
    headers = {"Authorization": spec["auth"]} if "auth" in spec else peer.primary_aggregator_auth_token().request_headers()
    header = spec.get("header", _b64(raw))
    if header is not None:
        headers[t_tp.TASKPROV_HEADER] = header
    if spec.get("route") == "aggregate_share":
        method, path, ctype = "POST", f"/tasks/{_b64(tid)}/aggregate_shares", tm.AggregateShareReq.MEDIA_TYPE
    else:
        method, path = "PUT", f"/tasks/{_b64(tid)}/aggregation_jobs/{_b64(bytes(16))}"
        ctype = tm.AggregationJobInitializeReq.MEDIA_TYPE
    headers["Content-Type"] = ctype
    answers = {name: app.handle(method, path, {}, dict(headers), b"") for name, app in apps.items()}
    assert answers["torch"] == answers["jax"]
    status, _, body, _ = answers["torch"]
    assert status in (400, 404), (status, body)
    # nothing was provisioned by a rejected opt-in
    assert apps["torch"].agg.ds.run_tx(lambda tx: tx.get_task(tm.TaskId(tid))) is None


# --- a TaskConfig past http.server's header line limit ------------------------


def test_a_histogram_10000_taskprov_header_reaches_the_port_helper(helper_apps):
    """9,999 boundaries make a dap-taskprov header of ~106,700 characters.
    The port's DapServer reads it whole (janus_tpu's stdlib server refuses
    a header line over 64 KiB and closes the connection), checks its digest
    against the task ID and authorizes the peer: a wrong token gets the
    same problem document the janus_tpu app gives the same request."""
    peer, apps = helper_apps
    cfg = task_config(t_tp, tm, vdaf_config=t_tp.VdafConfig(t_tp.DpConfig(), t_tp.VdafType.prio3_histogram(range(1, 10000))))
    tid = cfg.computed_task_id().data
    headers = {
        "Content-Type": tm.AggregationJobInitializeReq.MEDIA_TYPE,
        t_tp.TASKPROV_HEADER: _b64(cfg.to_bytes()),
        "Authorization": "Bearer nope",
    }
    assert len(headers[t_tp.TASKPROV_HEADER]) > 100_000
    path = f"tasks/{_b64(tid)}/aggregation_jobs/{_b64(bytes(16))}"
    srv = t_http.DapServer(apps["torch"]).start()
    try:
        status, body = t_client.HttpClient(timeout=30).put(srv.url + path, b"", headers)
    finally:
        srv.server.shutdown()
        srv.server.server_close()
    assert (status, body) == apps["jax"].handle("PUT", "/" + path, {}, dict(headers), b"")[0:3:2]
    assert status == 400 and b"unauthorizedRequest" in body
    j_srv = j_http.DapServer(apps["jax"]).start()
    try:
        try:
            j_status = j_client.HttpClient(timeout=30).put(j_srv.url + path, b"", headers)[0]
        except OSError:
            j_status = None  # the connection closed mid-request
        assert j_status in (None, 431)
    finally:
        j_srv.server.shutdown()
        j_srv.server.server_close()


def test_long_header_lines_are_read_whole_up_to_their_cap():
    import http.server
    import threading
    import urllib.request

    from janus_tpu_torch.binary_utils import MAX_HEADER_LINE, LongHeaderLines

    class Echo(LongHeaderLines, http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            out = (self.headers.get("X-Long", "") + "|" + self.headers.get("X-Short", "")).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Echo)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/"
    try:
        value = "v" * 200_000
        req = urllib.request.Request(url, headers={"X-Long": value, "X-Short": "s"})
        assert urllib.request.urlopen(req, timeout=30).read() == (value + "|s").encode()
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(url, headers={"X-Long": "v" * MAX_HEADER_LINE}), timeout=30)
        assert ei.value.code == 431
    finally:
        srv.shutdown()
        srv.server_close()
