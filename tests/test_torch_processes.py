"""The deployed process pair, as real processes: the port's binaries,
booted from YAML with `device: cpu`, in the manner of
tests/test_integration_processes.py.

One deployment serves the module: the port's leader (aggregator, job
creator, aggregation job driver and collection job driver over one SQLite
file), a port helper (`python -m janus_tpu_torch.bin.aggregator`) and a
janus_tpu helper (`python -m janus_tpu.bin.aggregator`, JAX on the CPU),
each side with its own datastore keys. Tasks are provisioned through the
port's janus_cli (janus_tpu's for its helper), reports uploaded through
the port's Client and collected through the port's Collector:

- case 1: a SumVec task whose helper is the port's helper (the port's
  five processes);
- case 2: a Prio3Count task whose helper is janus_tpu's.

Each collection must equal the ground truth. Last, every process drains
on SIGTERM with rc 0. Ports 23500-23525 (janus_tpu's process tests use
20200+ and 21310+).
"""

import dataclasses
import json
import os
import signal
import time

import numpy as np
import pytest
import yaml

from test_torch_binaries import fetch, new_key, port_env, spawn, wait_ready

HEALTH = {"helper_port": 23520, "helper_jax": 23521, "leader": 23522, "creator": 23523, "agg_driver": 23524,
          "col_driver": 23525}
DAP = {"helper_port": 23510, "helper_jax": 23511, "leader": 23512}


def _url(name: str) -> str:
    return f"http://127.0.0.1:{DAP[name]}/"


def _tasks():
    """(leader task, helper task, collector keypair) of each case, built
    with janus_tpu's TaskBuilder (the port reads the same dict)."""
    from janus_tpu.core.auth import AuthenticationToken
    from janus_tpu.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu.messages import Role
    from janus_tpu.task import QueryTypeConfig, TaskBuilder
    from janus_tpu.vdaf.registry import VdafInstance

    out = {}
    for case, vdaf, helper in (("sumvec", VdafInstance.sum_vec(4, 3), "helper_port"),
                               ("count", VdafInstance.count(), "helper_jax")):
        kp = generate_hpke_config_and_private_key(config_id=200)
        leader = TaskBuilder(QueryTypeConfig.time_interval(), vdaf, Role.LEADER).with_(
            leader_aggregator_endpoint=_url("leader"), helper_aggregator_endpoint=_url(helper),
            collector_hpke_config=kp.config, aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_auth_token=AuthenticationToken.random_bearer(), min_batch_size=1,
        ).build()
        helper_task = dataclasses.replace(leader, role=Role.HELPER,
                                          hpke_keys=(generate_hpke_config_and_private_key(config_id=1),))
        out[case] = (leader, helper_task, kp, helper)
    return out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    from janus_tpu.bin import janus_cli as j_cli
    from janus_tpu_torch.bin import janus_cli as t_cli

    tmp = tmp_path_factory.mktemp("processes")
    keys = {"leader": new_key(), "helper_port": new_key(), "helper_jax": new_key()}
    dbs = {side: str(tmp / f"{side}.sqlite") for side in keys}
    tasks = _tasks()
    # provision: the leader's two tasks and each helper's own
    leader_file = tmp / "leader_tasks.json"
    leader_file.write_text(json.dumps([t[0].to_dict() for t in tasks.values()]))
    assert t_cli.main(["provision-tasks", str(leader_file), "--database", dbs["leader"],
                       f"--datastore-keys={keys['leader']}"]) == 0
    for case, (_, helper_task, _, side) in tasks.items():
        f = tmp / f"{side}_tasks.yaml"
        f.write_text(yaml.safe_dump([helper_task.to_dict()]))
        cli = t_cli if side == "helper_port" else j_cli
        assert cli.main(["provision-tasks", str(f), "--database", dbs[side], f"--datastore-keys={keys[side]}"]) == 0

    def cfg(name, db, extra):
        doc = {"database": {"url": db}, "health_check_listen_address": f"127.0.0.1:{HEALTH[name]}",
               "health_sampler_interval_secs": 1, **extra}
        path = tmp / f"{name}.yaml"
        path.write_text(yaml.safe_dump(doc))
        return path

    port = {"device": "cpu"}
    driver = {**port, "worker_lease_duration_secs": 30, "min_job_discovery_delay_secs": 0.1,
              "max_job_discovery_delay_secs": 0.5}
    specs = {
        "helper_port": ("janus_tpu_torch", "aggregator", dbs["helper_port"],
                        {**port, "listen_address": f"127.0.0.1:{DAP['helper_port']}"}),
        "helper_jax": ("janus_tpu", "aggregator", dbs["helper_jax"],
                       {"jax_platform": "cpu", "listen_address": f"127.0.0.1:{DAP['helper_jax']}",
                        "compilation_cache_dir": os.environ.get("JAX_COMPILATION_CACHE_DIR"),
                        "engine": {"aot_cache": False, "prewarm": False}}),
        "leader": ("janus_tpu_torch", "aggregator", dbs["leader"],
                   {**port, "listen_address": f"127.0.0.1:{DAP['leader']}"}),
        "creator": ("janus_tpu_torch", "aggregation_job_creator", dbs["leader"],
                    {**port, "aggregation_job_creation_interval_secs": 0.5, "min_aggregation_job_size": 1}),
        "agg_driver": ("janus_tpu_torch", "aggregation_job_driver", dbs["leader"], driver),
        "col_driver": ("janus_tpu_torch", "collection_job_driver", dbs["leader"], driver),
    }
    procs = {}
    try:
        for name, (package, binary, db, extra) in specs.items():
            side = name if name.startswith("helper") else "leader"
            env = port_env(keys[side])
            if package == "janus_tpu":
                # one JAX CPU device: the single-device engine
                env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="")
            log = tmp / f"{name}.log"
            procs[name] = (spawn(package, binary, cfg(name, db, extra), env, log), log, HEALTH[name])
        for name, (proc, log, hport) in procs.items():
            wait_ready(hport, proc, log, deadline_s=180.0)
        yield tasks, procs
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _collect(tasks, case, measurements):
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.collector import Collector, CollectorParameters
    from janus_tpu_torch.core.hpke import HpkeKeypair
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.time_util import RealClock
    from janus_tpu_torch.messages import Duration, HpkeConfig, Interval, Query, Time
    from janus_tpu_torch.task import Task

    j_leader, _, j_kp, helper = tasks[case]
    leader = Task.from_dict(j_leader.to_dict())
    kp = HpkeKeypair(HpkeConfig.from_bytes(j_kp.config.to_bytes()), j_kp.private_key)
    clock, http = RealClock(), HttpClient(timeout=120)
    client = Client.with_fetched_configs(
        ClientParameters(leader.task_id, _url("leader"), _url(helper), leader.time_precision), leader.vdaf, http,
        clock=clock,
    )
    for m in measurements:
        client.upload(m)
    collector = Collector(CollectorParameters(leader.task_id, _url("leader"), leader.collector_auth_token, kp),
                          leader.vdaf, http)
    tp = leader.time_precision.seconds
    start = clock.now().seconds // tp * tp
    query = Query.time_interval(Interval(Time(start - tp), Duration(3 * tp)))
    return collector.collect(query, timeout_s=180.0)


def test_port_helper_case(pair):
    tasks, _ = pair
    rng = np.random.default_rng(18)
    meas = [[int(x) for x in row] for row in rng.integers(0, 8, size=(6, 4))]
    result = _collect(tasks, "sumvec", meas)
    assert result.report_count == len(meas)
    assert [int(x) for x in result.aggregate_result] == [int(x) for x in np.sum(meas, axis=0)]


def test_janus_tpu_helper_case(pair):
    tasks, _ = pair
    meas = [int(x) for x in np.random.default_rng(19).integers(0, 2, 7)]
    result = _collect(tasks, "count", meas)
    assert result.report_count == len(meas)
    assert int(result.aggregate_result) == sum(meas)


def test_books_balance_on_the_leader(pair):
    _, procs = pair
    deadline = time.monotonic() + 30
    while True:
        doc = json.loads(fetch(f"http://127.0.0.1:{HEALTH['agg_driver']}/debug/ledger")[2])
        if doc.get("evaluations") and not doc.get("breaches"):
            break
        assert time.monotonic() < deadline, doc
        time.sleep(0.5)
    statusz = json.loads(fetch(f"http://127.0.0.1:{HEALTH['agg_driver']}/statusz")[2])
    assert statusz["process"]["devices"] == ["cpu"]
    assert "peer_health" in statusz and "outbound_circuit" in statusz


def test_every_process_drains(pair):
    """SIGTERM to all six at once: each exits 0 and logs its shutdown."""
    _, procs = pair
    for proc, _, _ in procs.values():
        proc.send_signal(signal.SIGTERM)
    for name, (proc, log, _) in procs.items():
        rc = proc.wait(timeout=60)
        text = log.read_text()
        assert rc == 0, f"{name}: {text[-3000:]}"
        assert "shut down" in text, name


def test_rehearse_chip_smoke_binaries_phase():
    """chip_smoke.py's binaries-sumvec phase on the CPU at SumVec(4, 2):
    janus_cli, the five processes from .json configs, the uploads under
    the profile windows, the collection, the scrapes and the drain (the
    card's kernel check reads CUDA traces, so it runs on the card only)."""
    import sys

    import torch

    sys.path.insert(0, str(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import chip_smoke
    from janus_tpu_torch.vdaf.registry import VdafInstance

    out = chip_smoke.phase_binaries(torch, torch.device("cpu"), VdafInstance.sum_vec(4, 2), 2, 30, (3, 20),
                                    profile_s=1.0, base_port=23540)
    assert out["report_count"] == 30 and out["aggregate_ok"]
    assert set(out["exit_codes"].values()) == {0}
    assert all(s["exposition_errors"] == 0 and s["backend"] == "cpu" for s in out["scrapes"].values())
    assert out["ledger"]["leader"]["peer_divergence"] == 0
    assert {p["activities"][0] for p in out["profiles"].values()} == {"cpu"}
