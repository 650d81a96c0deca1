"""The interop test API (draft-dcook-ppm-dap-interop-test-design): the
port's InteropAggregator paired with janus_tpu's, both ways, in one
process over loopback, driven only through the /internal/test/* routes,
as a foreign harness would drive them (tests/test_interop.py's flow).

- leader = janus_tpu_torch, helper = janus_tpu, with the port's interop
  client and collector facing the leader; and the reverse, with
  janus_tpu's client and collector;
- Prio3Count in the interop API's default framing (draft, VDAF-07);
- the interop binaries as processes: the port's
  `bin.interop_aggregator`, `interop_client` and `interop_collector`
  beside janus_tpu's `bin.interop_aggregator`, one task led by each
  aggregator, in this framework's fast framing (ports 23530-23533).

Every collection must equal the ground truth.
"""

import base64
import json
import os
import secrets
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from janus_tpu.core.time_util import MockClock as JClock
from janus_tpu.datastore.store import EphemeralDatastore as JEph
from janus_tpu.interop import InteropAggregator as JAgg
from janus_tpu.interop import InteropClient as JClient
from janus_tpu.interop import InteropCollector as JCollector
from janus_tpu.messages import Time as JTime
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.interop import InteropAggregator, InteropClient, InteropCollector
from janus_tpu_torch.messages import Time

NOW = 1_600_000_000


def post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def b64(b):
    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def _drive(client_url, collector_url, leader_url, helper_url, vdaf, now_s, measurements, tp=3600):
    """One task through the interop routes: collector, leader and helper
    add_task, the uploads, then a collection polled to its end."""
    task_id = b64(secrets.token_bytes(32))
    collector_token = "collector-" + b64(secrets.token_bytes(8))
    resp = post(collector_url + "internal/test/add_task", {
        "task_id": task_id, "leader": leader_url, "vdaf": vdaf,
        "collector_authentication_token": collector_token, "query_type": 1,
    })
    assert resp["status"] == "success", resp
    common = {
        "task_id": task_id, "leader": leader_url, "helper": helper_url, "vdaf": vdaf,
        "leader_authentication_token": "leader-" + b64(secrets.token_bytes(8)),
        "vdaf_verify_key": b64(secrets.token_bytes(16)), "max_batch_query_count": 1, "query_type": 1,
        "min_batch_size": 1, "time_precision": tp, "collector_hpke_config": resp["collector_hpke_config"],
        "task_expiration": None,
    }
    resp = post(leader_url + "internal/test/add_task",
                {**common, "role": "leader", "collector_authentication_token": collector_token})
    assert resp["status"] == "success", resp
    resp = post(helper_url + "internal/test/add_task", {**common, "role": "helper"})
    assert resp["status"] == "success", resp
    for m in measurements:
        resp = post(client_url + "internal/test/upload", {
            "task_id": task_id, "leader": leader_url, "helper": helper_url, "vdaf": vdaf, "measurement": m,
            "time_precision": tp,
        })
        assert resp["status"] == "success", resp
    resp = post(collector_url + "internal/test/collection_start", {
        "task_id": task_id, "agg_param": "",
        "query": {"type": 1, "batch_interval_start": (now_s // tp - 1) * tp, "batch_interval_duration": 3 * tp},
    })
    assert resp["status"] == "success", resp
    handle = resp["handle"]
    deadline = time.monotonic() + 120
    while True:
        resp = post(collector_url + "internal/test/collection_poll", {"handle": handle})
        if resp["status"] == "complete":
            return resp
        assert resp["status"] == "in progress", resp
        assert time.monotonic() < deadline, "collection did not complete"
        time.sleep(0.5)


def _aggregator(pkg: str):
    if pkg == "jax":
        eph = JEph(clock=JClock(JTime(NOW)))
        return eph, JAgg(eph.datastore, clock=eph.clock)
    eph = EphemeralDatastore(MockClock(Time(NOW)))
    return eph, InteropAggregator(eph.datastore, clock=eph.clock, device="cpu")


@pytest.mark.parametrize("leader_pkg,helper_pkg,front", [("torch", "jax", "torch"), ("jax", "torch", "jax")],
                         ids=["port-leader", "janus-tpu-leader"])
def test_interop_pair_collects_the_ground_truth(leader_pkg, helper_pkg, front):
    (leader_eph, leader), (helper_eph, helper) = _aggregator(leader_pkg), _aggregator(helper_pkg)
    clock = leader_eph.clock
    # the client and collector of the front package face the leader
    client_cls, collector_cls = (InteropClient, InteropCollector) if front == "torch" else (JClient, JCollector)
    servers = [leader.server().start(), helper.server().start()]
    leader.start_job_runners()
    client_srv = client_cls(clock=clock).server().start()
    collector_srv = collector_cls().server().start()
    servers += [client_srv, collector_srv]
    try:
        leader_url, helper_url = servers[0].url, servers[1].url
        vdaf = {"type": "Prio3Count"}
        for srv in servers:
            assert post(srv.url + "internal/test/ready", {}) == {}
        task_id = b64(secrets.token_bytes(32))
        assert post(leader_url + "internal/test/endpoint_for_task", {"task_id": task_id, "role": "leader"}) == {
            "status": "success", "endpoint": "/"
        }
        measurements = ["1", "0", "1", "1", "0", "1"]
        resp = _drive(client_srv.url, collector_srv.url, leader_url, helper_url, vdaf, clock.now().seconds,
                      measurements)
        assert resp["report_count"] == str(len(measurements))
        assert resp["result"] == str(sum(int(m) for m in measurements))
    finally:
        leader.stop()
        helper.stop()
        for srv in servers:
            srv.stop()
        leader_eph.cleanup()
        helper_eph.cleanup()


def test_vdaf_objects_and_json_numbers_match_janus_tpus():
    from janus_tpu import interop as j
    from janus_tpu_torch import interop as t

    objects = [
        {"type": "Prio3Count"}, {"type": "Prio3Sum", "bits": "8"},
        {"type": "Prio3SumVec", "bits": 16, "length": "1000", "chunk_length": "0", "xof_mode": "fast"},
        {"type": "Prio3Histogram", "length": "4", "chunk_length": "2"}, {"type": "Prio3CountVec", "length": 3},
        {"type": "Prio3FixedPoint16BitBoundedL2VecSum", "length": "2"},
    ]
    for obj in objects:
        jv, tv = j.vdaf_from_object(obj), t.vdaf_from_object(obj)
        assert tv.to_dict() == jv.to_dict()
    for bad in ({"type": "Poplar1"}, {"type": "Prio3Count", "xof_mode": "slow"}):
        with pytest.raises(ValueError):
            t.vdaf_from_object(bad)
        with pytest.raises(ValueError):
            j.vdaf_from_object(bad)
    fp = t.vdaf_from_object(objects[-1])
    assert t.measurement_from_json(fp, ["0.5", "-0.25"]) == j.measurement_from_json(j.vdaf_from_object(objects[-1]),
                                                                                    ["0.5", "-0.25"])
    assert t.result_to_json(t.vdaf_from_object(objects[2]), [1, 2]) == ["1", "2"]


def test_interop_binaries_pair_both_ways(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    ports = {"port_agg": 23530, "jax_agg": 23531, "client": 23532, "collector": 23533}
    cmds = {
        "port_agg": ["janus_tpu_torch.bin.interop_aggregator", "--device", "cpu"],
        "jax_agg": ["janus_tpu.bin.interop_aggregator"],
        "client": ["janus_tpu_torch.bin.interop_client"],
        "collector": ["janus_tpu_torch.bin.interop_collector"],
    }
    procs = {}
    try:
        for name, cmd in cmds.items():
            penv = dict(env, JAX_PLATFORMS="cpu", XLA_FLAGS="") if name == "jax_agg" else env
            log = open(tmp_path / f"{name}.log", "wb")
            procs[name] = subprocess.Popen([sys.executable, "-m", *cmd, "--port", str(ports[name])], env=penv,
                                           cwd=repo, stdout=log, stderr=subprocess.STDOUT)
            log.close()
        urls = {name: f"http://127.0.0.1:{p}/" for name, p in ports.items()}
        deadline = time.monotonic() + 120
        for name, url in urls.items():
            while True:
                assert procs[name].poll() is None, (tmp_path / f"{name}.log").read_text()[-2000:]
                try:
                    assert post(url + "internal/test/ready", {}) == {}
                    break
                except OSError:
                    assert time.monotonic() < deadline, name
                    time.sleep(0.3)
        vdaf = {"type": "Prio3Count", "xof_mode": "fast"}
        for leader, helper in (("port_agg", "jax_agg"), ("jax_agg", "port_agg")):
            meas = ["1", "1", "0", "1"] if leader == "port_agg" else ["0", "1", "1"]
            resp = _drive(urls["client"], urls["collector"], urls[leader], urls[helper], vdaf, int(time.time()), meas)
            assert resp["report_count"] == str(len(meas)), leader
            assert resp["result"] == str(sum(int(m) for m in meas)), leader
        assert "interop aggregator listening" in (tmp_path / "port_agg.log").read_text()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for proc in procs.values():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
