"""The port's binaries as processes, against janus_tpu's.

- each of the five binaries' `--help` equals janus_tpu's golden
  (tests/goldens/<name>_help.txt) byte for byte;
- each service binary boots from YAML with `device: cpu`, every route of
  its health listener answers (POST /debug/profile included), and SIGTERM
  drains it to rc 0 with "shut down" in its log;
- a binary whose YAML names no device exits non-zero where there is no
  CUDA, with resolve_device's message, and never serves on the CPU;
- `janus_cli provision-tasks` of one tasks file stores the task rows
  janus_tpu's does (`Task.to_dict`), and `list-tasks` lists them alike;
- the aggregator API answers one sequence of requests with janus_tpu's
  statuses and leaves the same stored rows.

The deployment boots once per module (each process pays a torch import);
its health listeners use ports 23400-23409.
"""

import base64
import json
import os
import secrets
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
GOLDENS = Path(__file__).resolve().parent / "goldens"
HELP_BINARIES = ["aggregator", "aggregation_job_creator", "aggregation_job_driver", "collection_job_driver", "janus_cli"]
SERVICES = ["aggregator", "aggregation_job_creator", "aggregation_job_driver", "collection_job_driver"]
HEALTH_BASE = 23400
DAP_PORT = 23409
GET_ROUTES = [
    "/healthz", "/readyz", "/metrics", "/metrics?openmetrics=1", "/statusz", "/statusz?format=html", "/alertz",
    "/debug/vars", "/debug/profile", "/debug/profile?format=json", "/debug/boot", "/debug/traces",
    "/debug/flight", "/debug/ledger", "/",
]


def new_key() -> str:
    return base64.urlsafe_b64encode(secrets.token_bytes(16)).decode().rstrip("=")


def port_env(key: str) -> dict:
    # one torch thread a process: the suite runs many processes at once
    return dict(os.environ, PYTHONPATH=str(REPO), DATASTORE_KEYS=key, OMP_NUM_THREADS="1")


def spawn(package: str, name: str, cfg_path, env: dict, log_path):
    logf = open(log_path, "wb")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", f"{package}.bin.{name}", "--config-file", str(cfg_path)],
            env=env, stdout=logf, stderr=subprocess.STDOUT, cwd=str(REPO),
        )
    finally:
        logf.close()


def fetch(url: str, method: str = "GET", timeout: float = 30.0):
    req = urllib.request.Request(url, method=method, data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def wait_ready(port: int, proc, log_path, deadline_s: float = 120.0) -> None:
    """Until the listener's /readyz answers 200 (the process must stay up)."""
    deadline = time.monotonic() + deadline_s
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"process exited {proc.returncode}: {Path(log_path).read_text()[-3000:]}")
        try:
            if fetch(f"http://127.0.0.1:{port}/readyz", timeout=2)[0] == 200:
                return
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError(f"listener {port} never ready: {Path(log_path).read_text()[-3000:]}")
        time.sleep(0.2)


def drain(proc, log_path, timeout_s: float = 30.0) -> tuple[int, str]:
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=timeout_s)
    return rc, Path(log_path).read_text()


# --- --help against janus_tpu's goldens ---


@pytest.fixture(scope="module")
def helps():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = {
        b: subprocess.Popen([sys.executable, "-m", f"janus_tpu_torch.bin.{b}", "--help"], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for b in HELP_BINARIES
    }
    out = {}
    for b, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        out[b] = (p.returncode, stdout + stderr)
    return out


@pytest.mark.parametrize("binary", HELP_BINARIES)
def test_help_matches_janus_tpus_golden(helps, binary):
    rc, text = helps[binary]
    assert rc == 0, text
    assert text == (GOLDENS / f"{binary}_help.txt").read_text()


# --- the four service binaries booted from YAML on the CPU ---


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("binaries")
    key = new_key()
    extra = {
        "aggregator": {"listen_address": f"127.0.0.1:{DAP_PORT}",
                       "aggregator_api": {"listen_address": "127.0.0.1:0", "auth_tokens": ["t"]}},
        "aggregation_job_creator": {"aggregation_job_creation_interval_secs": 0.5},
        "aggregation_job_driver": {"worker_lease_duration_secs": 30},
        "collection_job_driver": {"worker_lease_duration_secs": 30},
    }
    procs = {}
    for idx, name in enumerate(SERVICES):
        doc = {
            "database": {"url": str(tmp / "ds.sqlite")},
            "health_check_listen_address": f"127.0.0.1:{HEALTH_BASE + idx}",
            "device": "cpu",
            # janus_tpu's JAX keys: read and ignored
            "jax_platform": "cpu",
            "health_sampler_interval_secs": 1,
            "flight": {"interval_secs": 0.5},
            "slo": {"evaluation_interval_secs": 0.5},
            **extra[name],
        }
        cfg = tmp / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump(doc))
        procs[name] = (spawn("janus_tpu_torch", name, cfg, port_env(key), tmp / f"{name}.log"), tmp / f"{name}.log",
                       HEALTH_BASE + idx)
    try:
        for name, (proc, log, port) in procs.items():
            wait_ready(port, proc, log)
        yield procs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("name", SERVICES)
def test_every_health_route_answers(deployment, name):
    from janus_tpu_torch import exposition

    _, log, port = deployment[name]
    base = f"http://127.0.0.1:{port}"
    for route in GET_ROUTES:
        status, ctype, body = fetch(base + route)
        assert status == 200, (route, status, body[:300])
        assert body or route == "/healthz", route
    assert fetch(base + "/nope")[0] == 404
    _, _, text = fetch(base + "/metrics")
    assert exposition.validate_exposition(text.decode()) == []
    _, _, om = fetch(base + "/metrics?openmetrics=1")
    assert exposition.validate_exposition(om.decode(), openmetrics=True) == []
    assert 'backend="cpu"' in text.decode()
    statusz = json.loads(fetch(base + "/statusz")[2])
    for section in ("process", "tasks", "slo", "flight", "fleet", "failpoints", "datastore", "profile", "device_cost"):
        assert section in statusz, section
    assert statusz["process"]["devices"] == ["cpu"] and statusz["process"]["torch"].startswith("2.")
    if name != "aggregation_job_creator":
        deadline = time.monotonic() + 20
        while "job_health" not in statusz and time.monotonic() < deadline:
            time.sleep(0.3)
            statusz = json.loads(fetch(base + "/statusz")[2])
        assert "ledger" in statusz and "job_health" in statusz
    boot = json.loads(fetch(base + "/debug/boot")[2])
    assert boot["ready"] and [p["phase"] for p in boot["phases"][:6]] == [
        "imports", "config", "backend_init", "datastore", "engine_warm", "listener_up"
    ]
    alertz = json.loads(fetch(base + "/alertz")[2])
    assert alertz["enabled"] and {s["name"] for s in alertz["slos"]} >= {"upload_availability", "device_health"}
    assert json.loads(fetch(base + "/debug/flight")[2])["enabled"]
    assert "configuration keys with no counterpart in janus_tpu_torch, ignored: jax_platform" in Path(log).read_text()


@pytest.mark.parametrize("name", SERVICES)
def test_profile_capture_window(deployment, name):
    port = deployment[name][2]
    status, _, body = fetch(f"http://127.0.0.1:{port}/debug/profile?seconds=0.3", method="POST")
    assert status == 200, body
    doc = json.loads(body)
    assert doc["activities"] == ["cpu"] and doc["seconds"] == 0.3
    assert json.loads(Path(doc["device_trace"]).read_text())["traceEvents"] is not None
    assert Path(doc["host_chrome_trace"]).exists()
    assert fetch(f"http://127.0.0.1:{port}/debug/profile?seconds=x", method="POST")[0] == 400


def test_aggregator_serves_dap_and_the_api(deployment):
    status, _, body = fetch(f"http://127.0.0.1:{DAP_PORT}/hpke_config")
    assert status in (400, 404), body  # no global keys and no task: a DAP problem, not a crash


@pytest.mark.parametrize("name", SERVICES)
def test_sigterm_drains(deployment, name):
    proc, log, _ = deployment[name]
    rc, text = drain(proc, log)
    assert rc == 0, text[-3000:]
    assert "shut down" in text


def test_no_device_needs_cuda(tmp_path):
    """No `device:`: CUDA, which this machine lacks, so the binary refuses
    to boot; it never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here: the binary would serve on it")
    cfg = tmp_path / "creator.yaml"
    cfg.write_text(yaml.safe_dump({
        "database": {"url": str(tmp_path / "ds.sqlite")},
        "health_check_listen_address": f"127.0.0.1:{HEALTH_BASE + 8}",
    }))
    out = subprocess.run(
        [sys.executable, "-m", "janus_tpu_torch.bin.aggregation_job_creator", "--config-file", str(cfg)],
        env=port_env(new_key()), cwd=str(REPO), capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert "janus_tpu_torch runs on CUDA and no CUDA device is available" in out.stderr
    assert "health/metrics listener" not in out.stderr


# --- janus_cli ---


def test_provision_tasks_stores_janus_tpus_rows(tmp_path, capsys):
    from janus_tpu.bin import janus_cli as j_cli
    from janus_tpu.core.auth import AuthenticationToken
    from janus_tpu.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu.core.time_util import RealClock as JClock
    from janus_tpu.datastore.store import Crypter as JCrypter
    from janus_tpu.datastore.store import open_datastore as j_open
    from janus_tpu.messages import Role
    from janus_tpu.task import QueryTypeConfig, TaskBuilder
    from janus_tpu.vdaf.registry import VdafInstance
    from janus_tpu_torch.bin import janus_cli as t_cli
    from janus_tpu_torch.binary_utils import parse_datastore_keys
    from janus_tpu_torch.core.time_util import RealClock
    from janus_tpu_torch.datastore.store import Crypter, open_datastore

    tasks = [
        TaskBuilder(QueryTypeConfig.time_interval(), VdafInstance.count(), Role.LEADER).with_(
            aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_auth_token=AuthenticationToken.random_bearer()).build(),
        TaskBuilder(QueryTypeConfig.fixed_size(max_batch_size=64), VdafInstance.sum_vec(1000, 16), Role.HELPER).with_(
            aggregator_auth_token=AuthenticationToken.random_bearer(),
            hpke_keys=(generate_hpke_config_and_private_key(config_id=3),)).build(),
    ]
    docs = [t.to_dict() for t in tasks]
    (tmp_path / "tasks.yaml").write_text(yaml.safe_dump(docs))
    (tmp_path / "tasks.json").write_text(json.dumps(docs))
    key = new_key()
    outs, rows, listings = {}, {}, {}
    for pkg, cli, tasks_file in (("jax", j_cli, "tasks.yaml"), ("torch", t_cli, "tasks.yaml"),
                                 ("torch-json", t_cli, "tasks.json")):
        db = str(tmp_path / f"{pkg}.sqlite")
        assert cli.main(["provision-tasks", str(tmp_path / tasks_file), "--database", db,
                         f"--datastore-keys={key}"]) == 0
        outs[pkg] = json.loads(capsys.readouterr().out)
        assert cli.main(["list-tasks", "--database", db, f"--datastore-keys={key}"]) == 0
        listings[pkg] = capsys.readouterr().out
        if pkg == "jax":
            ds = j_open(db, JCrypter(parse_datastore_keys(key)), JClock())
        else:
            ds = open_datastore(db, Crypter(parse_datastore_keys(key)), RealClock())
        try:
            rows[pkg] = sorted((t.to_dict() for t in ds.run_tx(lambda tx: tx.get_tasks())), key=lambda d: d["task_id"])
        finally:
            ds.close()
    assert outs["torch"] == outs["jax"] == outs["torch-json"]
    assert rows["torch"] == rows["jax"] == rows["torch-json"] == sorted(docs, key=lambda d: d["task_id"])
    assert listings["torch"] == listings["jax"]
    # --dry-run validates and touches no datastore
    assert t_cli.main(["provision-tasks", str(tmp_path / "tasks.json"), "--dry-run"]) == 0
    capsys.readouterr()
    assert t_cli.main(["create-datastore-key"]) == 0
    k = capsys.readouterr().out.strip()
    assert len(base64.urlsafe_b64decode(k + "=" * (-len(k) % 4))) == 16


# --- the aggregator API ---


def test_aggregator_api_matches_janus_tpus():
    from janus_tpu.aggregator_api import AggregatorApi as JApi
    from janus_tpu.datastore.store import EphemeralDatastore as JEph
    from janus_tpu.messages import Role
    from janus_tpu.task import QueryTypeConfig, TaskBuilder
    from janus_tpu.vdaf.registry import VdafInstance
    from janus_tpu_torch.aggregator_api import AggregatorApi, AggregatorApiServer
    from janus_tpu_torch.datastore import EphemeralDatastore

    leader = TaskBuilder(QueryTypeConfig.time_interval(), VdafInstance.sum(bits=8), Role.LEADER).build().to_dict()
    helper = TaskBuilder(QueryTypeConfig.fixed_size(max_batch_size=10), VdafInstance.count(), Role.HELPER).build().to_dict()
    unknown = base64.urlsafe_b64encode(bytes(32)).decode().rstrip("=")
    bad_role = dict(leader, task_id=unknown, role=7)
    bad_precision = dict(leader, task_id=unknown, time_precision="x")
    from janus_tpu.taskprov import PeerAggregatorBuilder

    peer = PeerAggregatorBuilder().with_(endpoint="https://peer.example.com/", role=Role.HELPER).build().to_dict()
    auth = {"Authorization": "Bearer tok"}
    seq = [
        ("GET", "/task_ids", None, {}),
        ("GET", "/task_ids", None, {"Authorization": "Bearer nope"}),
        ("POST", "/tasks", leader, auth),
        ("POST", "/tasks", helper, auth),
        ("POST", "/tasks", bad_role, auth),
        ("POST", "/tasks", bad_precision, auth),
        ("GET", "/task_ids", None, auth),
        ("GET", f"/tasks/{leader['task_id']}", None, auth),
        ("GET", f"/tasks/{leader['task_id']}/metrics", None, auth),
        ("GET", "/tasks/%%%", None, auth),
        ("GET", f"/tasks/{unknown}", None, auth),
        ("PUT", "/hpke_configs", {"config_id": 9}, auth),
        ("PUT", "/hpke_configs", {"config_id": 300}, auth),
        ("PATCH", "/hpke_configs/9", {"state": "active"}, auth),
        ("PATCH", "/hpke_configs/9", {"state": "bogus"}, auth),
        ("PUT", "/taskprov/peer_aggregators", peer, auth),
        ("PUT", "/taskprov/peer_aggregators", {"endpoint": "x"}, auth),
        ("GET", "/taskprov/peer_aggregators", None, auth),
        ("DELETE", "/taskprov/peer_aggregators", {"endpoint": peer["endpoint"], "role": peer["role"]}, auth),
        ("DELETE", f"/tasks/{helper['task_id']}", None, auth),
        ("GET", "/no/such/route", None, auth),
        ("POST", "/tasks", None, auth),
    ]
    ephs = {"jax": JEph(), "torch": EphemeralDatastore()}
    apis = {"jax": JApi(ephs["jax"].datastore, auth_tokens=("tok",)),
            "torch": AggregatorApi(ephs["torch"].datastore, auth_tokens=("tok",))}
    try:
        answers = {pkg: [] for pkg in apis}
        for method, path, doc, headers in seq:
            body = json.dumps(doc).encode() if doc is not None else b""
            for pkg, api in apis.items():
                status, out = api.handle(method, path, {}, headers, body)
                answers[pkg].append((status, out if method == "GET" and status == 200 and "hpke" not in path else None))
        assert answers["torch"] == answers["jax"]
        assert [a[0] for a in answers["torch"]] == [401, 401, 201, 201, 400, 500, 200, 200, 200, 400, 404, 201, 400,
                                                    200, 400, 201, 400, 200, 204, 204, 404, 400]

        def stored(ds):
            return (
                sorted((t.to_dict() for t in ds.run_tx(lambda tx: tx.get_tasks())), key=lambda d: d["task_id"]),
                sorted((kp.config.id.id, state) for kp, state in ds.run_tx(lambda tx: tx.get_global_hpke_keypairs())),
                [p.to_dict() for p in ds.run_tx(lambda tx: tx.get_taskprov_peer_aggregators())],
            )

        j_rows, t_rows = stored(ephs["jax"].datastore), stored(ephs["torch"].datastore)
        assert t_rows == j_rows == ([leader], [(9, "active")], [])
        assert answers["torch"][17][1] == [peer]
        # where the two differ: janus_tpu stores a task of a VDAF it does
        # not know (201), the port's VdafInstance refuses it (400)
        odd = dict(leader, task_id=unknown, vdaf={"kind": "nope"})
        body = json.dumps(odd).encode()
        assert apis["jax"].handle("POST", "/tasks", {}, auth, body)[0] == 201
        assert apis["torch"].handle("POST", "/tasks", {}, auth, body)[0] == 400
        # the HTTP shell
        srv = AggregatorApiServer(apis["torch"]).start()
        try:
            req = urllib.request.Request(srv.url + "/", headers=auth)
            with urllib.request.urlopen(req) as r:
                assert json.loads(r.read()) == {"protocol": "DAP-07", "server": "janus_tpu_torch"}
            assert fetch(srv.url + "/task_ids")[0] == 401
        finally:
            srv.stop()
    finally:
        for eph in ephs.values():
            eph.cleanup()


def test_cuda_profile_window_never_falls_back_to_the_host():
    """A process that serves on CUDA answers POST /debug/profile with 500
    where torch.profiler offers no CUDA activity (this CPU build offers
    none): no host-only trace stands in for the device's. A CPU process
    gets its window; a second window while one is open answers 409."""
    import threading

    import torch

    from janus_tpu_torch.binary_utils import HealthServer, capture_profile

    srv = HealthServer("127.0.0.1:0", devices=(torch.device("cuda", 0),)).start()
    try:
        status, _, body = fetch(f"http://127.0.0.1:{srv.port}/debug/profile?seconds=0.1", method="POST")
        assert status == 500 and body == b"profile capture failed"
    finally:
        srv.stop()
    srv = HealthServer("127.0.0.1:0", devices=(torch.device("cpu"),)).start()
    try:
        holder = threading.Thread(target=capture_profile, args=(1.0,))
        holder.start()
        time.sleep(0.2)
        assert fetch(f"http://127.0.0.1:{srv.port}/debug/profile?seconds=0.1", method="POST")[0] == 409
        holder.join()
        status, _, body = fetch(f"http://127.0.0.1:{srv.port}/debug/profile?seconds=0.1", method="POST")
        assert status == 200 and json.loads(body)["activities"] == ["cpu"]
    finally:
        srv.stop()


def test_warmup_engines_and_precompile_on_the_cpu(tmp_path, capsys):
    """warmup_engines: each task's engine, one leader init, helper init and
    aggregate at the bucket asked for, or at MIN_BUCKET with nothing
    pending; janus_cli --precompile runs it on --device."""
    from janus_tpu_torch.aggregator.engine_cache import MIN_BUCKET
    from janus_tpu_torch.bin import janus_cli
    from janus_tpu_torch.binary_utils import parse_datastore_keys, warmup_engines
    from janus_tpu_torch.core.time_util import RealClock
    from janus_tpu_torch.datastore.store import Crypter, open_datastore
    from janus_tpu_torch.messages import Role
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
    from janus_tpu_torch.vdaf.registry import VdafInstance

    tasks = [TaskBuilder(QueryTypeConfig.time_interval(), v, Role.HELPER).build()
             for v in (VdafInstance.count(), VdafInstance.sum_vec(4, 2), VdafInstance.sparse_sumvec(2, 48, 4, 3))]
    (tmp_path / "tasks.json").write_text(json.dumps([t.to_dict() for t in tasks]))
    key, db = new_key(), str(tmp_path / "ds.sqlite")
    assert janus_cli.main(["provision-tasks", str(tmp_path / "tasks.json"), "--database", db,
                           f"--datastore-keys={key}", "--precompile", "40", "--device", "cpu"]) == 0
    assert "warmed bucket 40 on cpu" in capsys.readouterr().err
    ds = open_datastore(db, Crypter(parse_datastore_keys(key)), RealClock())
    try:
        out = warmup_engines(ds, devices=("cpu",))
        assert sorted((t.data, b) for t, b in out["warmed"]) == sorted((t.task_id.data, MIN_BUCKET) for t in tasks)
    finally:
        ds.close()
