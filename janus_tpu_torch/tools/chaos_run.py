"""Crash-recovery chaos harness: prove exactly-once aggregation under
injected faults, against the port's own job driver binary.

The port's counterpart of janus_tpu's scripts/chaos_run.py for two of
its scenarios, `crash_storm` (the default) and `db_outage`, with the
same schedules, lease and breaker timings, invariants and `*_ok` keys.

Topology — chosen so the component being killed is the REAL binary
while everything else stays fast:

  - leader + helper DAP servers run in-process (DapServer threads over
    loopback HTTP) on `device`, with file-backed SQLite datastores in a
    temp dir, so the aggregation job drivers cross a real process +
    HTTP + DB boundary;
  - the aggregation job driver — the thing that crashes — runs as the
    real `python -m janus_tpu_torch.bin.aggregation_job_driver` binary
    against the leader database file, its YAML naming the same
    `device:`, armed via JANUS_FAILPOINTS;
  - the job creator and collection job driver run in-process.

Deterministic schedule (all probabilistic faults are count-budgeted):

  1. upload N reports through the real Client; the admitted
     measurements are the ground truth.
  2. driver A boots with
       datastore.commit.step_agg_job_write=crash:1.0,count=1
     — it steps the job: the helper aggregates and acks the init, and
     the leader dies (os._exit, the SIGKILL analog) BEFORE its own
     write commits. Assert exit code CRASH_EXIT_CODE and a still-held
     lease.
  3. driver B boots into a storm:
       env  helper.request=error:1.0,count=2   (transport failures)
            datastore.commit=error:0.2          (transient tx faults,
                                                 absorbed by run_tx)
       harness-side helper.aggregate=error:1.0,count=2 (real HTTP 500s
                                                 from the helper)
     Its outbound circuit must open, the job steps back (lease
     released early, attempt refunded), the breaker half-opens and
     closes once the storm budget is spent, and the job completes —
     the helper's request-hash dedup makes the replayed init
     idempotent. The lease must be reacquired within the lease TTL.
     Driver B's /statusz must show the device it serves on and at
     least one device dispatch: the binary stepped the job there.
  4. (full schedule only) a second batch + driver C with
       datastore.post_commit.step_agg_job_write=crash:1.0,count=1
     — death AFTER the commit, before anything was acked — then a
     clean driver D that must find nothing left to redo.
  5. collect through the real Collector and assert the aggregate
     equals the ground truth EXACTLY (count and sum: no loss, no
     double-count), the breaker cycle is visible in
     janus_outbound_circuit_state / _transitions_total and on
     /statusz, and driver B SIGTERM-drains cleanly.

The second scenario, `--scenario db_outage`, proves DATASTORE-outage
survival: under a sustained upload load, the leader's database is taken
down via the `datastore.connect` failpoint (scoped to the leader's
store — no real process is killed; the aggregation job driver runs
in-process). Invariants:

  - every upload acked 201 before, DURING and after the outage window
    is present exactly once in the final collected aggregate — during
    the outage the acks rest on the durable spill journal's fsync;
  - the datastore supervisor walks up → degraded → down → recovering →
    up, `/readyz` flips 200 → 503 (with a JSON reason) → 200 while
    `/healthz` stays live, and aggregate-step routes shed 503 while
    the store is down;
  - on recovery the journal drains to empty (replay through the write
    batcher, report-id dedup = exactly-once) and is truncated;
  - while the datastore is healthy the armed-but-idle journal performs
    ZERO fsyncs — the hot path is unchanged.

Usage:
    python -m janus_tpu_torch.tools.chaos_run --smoke --json
    python -m janus_tpu_torch.tools.chaos_run --json        # full schedule
    python -m janus_tpu_torch.tools.chaos_run --scenario db_outage --smoke --json
    ... --device cpu                  # the default is CUDA

Exit code 0 iff every invariant held; the result JSON rides on stdout.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import secrets
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

# the checkout holding this package: the driver subprocesses import it
REPO = str(Path(__file__).resolve().parents[2])

CRASH_SCHEDULE = "datastore.commit.step_agg_job_write=crash:1.0,count=1"
POST_COMMIT_CRASH_SCHEDULE = (
    "datastore.post_commit.step_agg_job_write=crash:1.0,count=1"
)
STORM_SCHEDULE = "helper.request=error:1.0,count=2;datastore.commit=error:0.2"
HELPER_5XX_SCHEDULE = "helper.aggregate=error:1.0,count=2"
# full datastore outage, scoped to the store whose failpoint_scope is
# "leader" (the harness names the leader's store; the in-process
# helper's store keeps its default scope and stays up)
DB_OUTAGE_SCHEDULE = "datastore.connect.leader=error:1.0"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _driver_cfg(path, db, health_port, ttl_s, cooldown_s, device: str):
    cfg = (
        f"database: {{url: {db}}}\n"
        f'health_check_listen_address: "127.0.0.1:{health_port}"\n'
        f'device: "{device}"\n'
        "min_job_discovery_delay_secs: 0.1\n"
        "max_job_discovery_delay_secs: 0.5\n"
        f"worker_lease_duration_secs: {ttl_s}\n"
        "maximum_attempts_before_failure: 20\n"
        "outbound_circuit_breaker:\n"
        "  failure_threshold: 3\n"
        f"  open_cooldown_secs: {cooldown_s}\n"
    )
    with open(path, "w") as f:
        f.write(cfg)
    return str(path)


def _spawn_driver(cfg_path, key, log_path, failpoints: str | None):
    """The real aggregation job driver binary on `cfg_path`, armed with
    `failpoints` through JANUS_FAILPOINTS (none: unarmed)."""
    env = dict(os.environ, PYTHONPATH=REPO, DATASTORE_KEYS=key)
    if failpoints:
        env["JANUS_FAILPOINTS"] = failpoints
    else:
        env.pop("JANUS_FAILPOINTS", None)
    logf = open(log_path, "wb")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "janus_tpu_torch.bin.aggregation_job_driver", "--config-file", str(cfg_path)],
            env=env,
            stdout=logf,
            stderr=subprocess.STDOUT,
            cwd=REPO,
        )
    finally:
        logf.close()


def _wait_healthz(port: int, deadline_s: float = 120.0) -> None:
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/healthz", timeout=2
            ) as r:
                assert r.status == 200
                return
        except Exception:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def _scrape(port: int, path: str) -> str:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=10
    ) as r:
        return r.read().decode()


def _metric_samples(text: str, name: str) -> dict[str, float]:
    """{label_block_or_'': value} for one family of a scraped /metrics
    page, via the shared exposition parser (the same one scrape_check
    and the metrics tests use, incl. escaped label values)."""
    from ..exposition import parse_exposition

    fam = parse_exposition(text)[0].get(name)
    if fam is None:
        return {}
    return {
        ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())): float(value)
        for sample_name, labels, value in fam.samples
        if sample_name == name
    }


def _http_status(url: str, method: str = "GET", body: bytes | None = None,
                 headers: dict | None = None, timeout: float = 10.0):
    """(status, body bytes) tolerating non-2xx (urllib raises on those);
    the shared helper lives beside the HTTP client."""
    from ..core.http_client import fetch_any_status

    return fetch_any_status(url, method=method, body=body, headers=headers, timeout=timeout)


def _provision_pair(leader_ds, helper_ds, leader_url, helper_url, collector_config_id: int,
                    helper_config_id: int):
    """One time-interval Prio3Count task on each side; returns (leader
    task, collector keypair, vdaf)."""
    import dataclasses

    from ..core.auth import AuthenticationToken
    from ..core.hpke import generate_hpke_config_and_private_key
    from ..messages import Role
    from ..task import QueryTypeConfig, TaskBuilder
    from ..vdaf.registry import VdafInstance

    vdaf = VdafInstance.count()
    collector_kp = generate_hpke_config_and_private_key(config_id=collector_config_id)
    leader_task = (
        TaskBuilder(QueryTypeConfig.time_interval(), vdaf, Role.LEADER)
        .with_(
            leader_aggregator_endpoint=leader_url,
            helper_aggregator_endpoint=helper_url,
            collector_hpke_config=collector_kp.config,
            aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_auth_token=AuthenticationToken.random_bearer(),
            min_batch_size=1,
        )
        .build()
    )
    helper_task = dataclasses.replace(
        leader_task,
        role=Role.HELPER,
        hpke_keys=(generate_hpke_config_and_private_key(config_id=helper_config_id),),
    )
    leader_ds.run_tx(lambda tx: tx.put_task(leader_task), "provision")
    helper_ds.run_tx(lambda tx: tx.put_task(helper_task), "provision")
    return leader_task, collector_kp, vdaf


def _collect_exact(leader_ds, leader_url, leader_task, collector_kp, vdaf, clock, want) -> dict:
    """Run the collection job driver in-process while the real Collector
    collects the three-interval window around now; `want` is the list
    of admitted measurements."""
    import threading

    from ..aggregator.collection_job_driver import CollectionJobDriver
    from ..aggregator.job_driver import JobDriver, JobDriverConfig
    from ..collector import Collector, CollectorParameters
    from ..core.http_client import HttpClient
    from ..messages import Duration, Interval, Query, Time

    cdrv = CollectionJobDriver(leader_ds, HttpClient())
    stop_collect = threading.Event()

    def collect_loop():
        jd = JobDriver(
            JobDriverConfig(job_discovery_interval_s=0.2),
            cdrv.acquirer(60),
            cdrv.stepper,
        )
        while not stop_collect.is_set():
            jd.run_once()
            stop_collect.wait(0.3)

    ct = threading.Thread(target=collect_loop, daemon=True)
    ct.start()
    try:
        collector = Collector(
            CollectorParameters(
                leader_task.task_id,
                leader_url,
                leader_task.collector_auth_token,
                collector_kp,
            ),
            vdaf,
            HttpClient(),
        )
        tp = leader_task.time_precision
        start = clock.now().to_batch_interval_start(tp)
        query = Query.time_interval(
            Interval(Time(start.seconds - tp.seconds), Duration(3 * tp.seconds))
        )
        collected = collector.collect(query, timeout_s=120.0)
        # THE invariant: exactly the admitted reports, no loss, no
        # double count
        return {
            "collected_count": collected.report_count,
            "collected_sum": collected.aggregate_result,
            "exactly_once_ok": (
                collected.report_count == len(want)
                and collected.aggregate_result == sum(want)
            ),
        }
    finally:
        stop_collect.set()
        ct.join(timeout=10)


def run_chaos(
    n_reports: int = 5,
    lease_ttl_s: int = 8,
    breaker_cooldown_s: float = 1.5,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Run the schedule; returns the invariant-assertion record. Every
    `*_ok` key must be True for the run to count as a pass. The
    in-process leader and helper and the driver binaries serve on
    `device` (CUDA unless the caller names another; raises without)."""
    from .. import failpoints
    from ..aggregator.aggregation_job_creator import (
        AggregationJobCreator,
        AggregationJobCreatorConfig,
    )
    from ..aggregator.core import Aggregator, Config
    from ..aggregator.http_handlers import DapHttpApp, DapServer
    from ..binary_utils import warmup_engines
    from ..client import Client, ClientParameters
    from ..core.http_client import HttpClient
    from ..core.time_util import RealClock
    from ..datastore.store import Crypter, Datastore
    from ..device import resolve_device
    from ..failpoints import CRASH_EXIT_CODE

    # the driver binaries' YAML names the device with its index
    device = str(resolve_device(device))
    t_run0 = time.monotonic()
    tmp = workdir or tempfile.mkdtemp(prefix="janus-chaos-")
    os.makedirs(tmp, exist_ok=True)
    key_bytes = secrets.token_bytes(16)
    key = base64.urlsafe_b64encode(key_bytes).decode().rstrip("=")
    clock = RealClock()
    leader_db = os.path.join(tmp, "leader.sqlite")
    helper_db = os.path.join(tmp, "helper.sqlite")
    leader_ds = Datastore(leader_db, Crypter([key_bytes]), clock)
    helper_ds = Datastore(helper_db, Crypter([key_bytes]), clock)

    result: dict = {"workdir": tmp, "schedule": "full" if full else "smoke", "device": device}
    procs: list[subprocess.Popen] = []
    leader_srv = helper_srv = None
    try:
        helper_srv = DapServer(
            DapHttpApp(Aggregator(helper_ds, clock, Config(), device=device))
        ).start()
        leader_srv = DapServer(
            DapHttpApp(Aggregator(leader_ds, clock, Config(collection_retry_after_s=1), device=device))
        ).start()
        leader_task, collector_kp, vdaf = _provision_pair(
            leader_ds, helper_ds, leader_srv.url, helper_srv.url, 200, 1
        )
        # warm the in-process helper's engine (it shares the engine
        # cache with this process's leader): the helper's first
        # aggregate-init then answers inside the driver's request budget
        warmup_engines(leader_ds, devices=[resolve_device(device)])

        # --- phase 1: ground truth -------------------------------------
        http = HttpClient()
        params = ClientParameters(
            leader_task.task_id, leader_srv.url, helper_srv.url, leader_task.time_precision
        )
        client = Client.with_fetched_configs(params, vdaf, http, clock=clock)
        measurements = [(i % 3 != 0) * 1 for i in range(n_reports)]
        for m in measurements:
            client.upload(m)
        creator = AggregationJobCreator(
            leader_ds,
            AggregationJobCreatorConfig(
                min_aggregation_job_size=1, max_aggregation_job_size=100
            ),
        )
        creator.run_once()
        result["admitted"] = len(measurements)
        result["ground_truth_sum"] = sum(measurements)

        def held_agg_leases():
            return [
                e
                for e in leader_ds.run_tx(
                    lambda tx: tx.get_held_lease_expiries(), "chaos_monitor"
                )
                if e[0] == "aggregation"
            ]

        def agg_jobs_by_state():
            counts = leader_ds.run_tx(
                lambda tx: tx.count_jobs_by_state(), "chaos_monitor"
            )
            return {
                state: n for (typ, state), n in counts.items() if typ == "aggregation"
            }

        # --- phase 2: crash between helper ack and leader commit --------
        ttl = int(lease_ttl_s)
        port_a = _free_port()
        cfg_a = _driver_cfg(
            os.path.join(tmp, "driver_a.yaml"), leader_db, port_a, ttl, breaker_cooldown_s, device
        )
        drv_a = _spawn_driver(
            cfg_a, key, os.path.join(tmp, "driver_a.log"), CRASH_SCHEDULE
        )
        procs.append(drv_a)
        rc_a = drv_a.wait(timeout=300)
        t_crash = time.monotonic()
        result["crash_exit_code"] = rc_a
        result["crash_ok"] = rc_a == CRASH_EXIT_CODE
        leases = held_agg_leases()
        # the dead driver's lease is still outstanding: nobody rolled it
        # back, exactly like SIGKILL
        result["lease_held_after_crash_ok"] = len(leases) == 1
        crashed_expiry = leases[0][3] if leases else 0
        states = agg_jobs_by_state()
        result["job_in_progress_after_crash_ok"] = states.get("in_progress", 0) >= 1

        # --- phase 3: restart into a helper storm -----------------------
        failpoints.configure(HELPER_5XX_SCHEDULE)  # helper-side real 500s
        port_b = _free_port()
        cfg_b = _driver_cfg(
            os.path.join(tmp, "driver_b.yaml"), leader_db, port_b, ttl, breaker_cooldown_s, device
        )
        drv_b = _spawn_driver(
            cfg_b, key, os.path.join(tmp, "driver_b.log"), STORM_SCHEDULE
        )
        procs.append(drv_b)
        _wait_healthz(port_b)
        # the recovery clock starts once a live driver exists: reacquire
        # latency must not be charged for driver B's own boot time
        t_recoverable = max(t_crash, time.monotonic())

        reacquired_at = None
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            if reacquired_at is None:
                now_leases = held_agg_leases()
                if any(e[3] != crashed_expiry for e in now_leases):
                    reacquired_at = time.monotonic()
            states = agg_jobs_by_state()
            if states.get("in_progress", 0) == 0 and states.get("finished", 0) >= 1:
                if reacquired_at is None:
                    reacquired_at = time.monotonic()
                break
            time.sleep(0.05)
        states = agg_jobs_by_state()
        result["job_finished_ok"] = (
            states.get("finished", 0) >= 1 and states.get("in_progress", 0) == 0
        )
        result["lease_reacquire_s"] = (
            round(reacquired_at - t_recoverable, 3) if reacquired_at else None
        )
        # the crashed lease must be picked up within its TTL (plus
        # discovery latency margin): leases are always recovered
        result["lease_reacquired_within_ttl_ok"] = (
            reacquired_at is not None and (reacquired_at - t_recoverable) <= ttl + 3.0
        )
        failpoints.clear()

        # --- breaker cycle visibility (driver B is still alive) ---------
        metrics_text = _scrape(port_b, "/metrics")
        state_samples = _metric_samples(metrics_text, "janus_outbound_circuit_state")
        trans = _metric_samples(
            metrics_text, "janus_outbound_circuit_transitions_total"
        )
        result["circuit_state_samples"] = state_samples
        result["circuit_transitions"] = trans
        opened = sum(v for k, v in trans.items() if 'to="open"' in k)
        half = sum(v for k, v in trans.items() if 'to="half_open"' in k)
        closed = sum(v for k, v in trans.items() if 'to="closed"' in k)
        result["circuit_cycle_ok"] = bool(
            opened >= 1
            and half >= 1
            and closed >= 1
            and state_samples
            and all(v == 0.0 for v in state_samples.values())  # closed again
        )
        statusz = json.loads(_scrape(port_b, "/statusz"))
        result["statusz_circuit_ok"] = bool(
            statusz.get("outbound_circuit", {}).get("peers")
        )
        result["statusz_failpoints_armed_ok"] = (
            statusz.get("failpoints", {}).get("enabled") is True
        )
        # the binary stepped the job on `device`: its process section
        # names it, and its device-cost table holds the dispatches
        result["driver_devices"] = statusz.get("process", {}).get("devices")
        result["driver_device_name"] = statusz.get("process", {}).get("device_name")
        result["driver_dispatches"] = sum(
            int(e.get("dispatches", 0)) for e in statusz.get("device_cost", {}).get("entries", [])
        )
        result["driver_on_device_ok"] = (
            result["driver_devices"] == [device] and result["driver_dispatches"] >= 1
        )
        step_backs = _metric_samples(metrics_text, "janus_job_step_back_total")
        result["step_backs"] = step_backs
        result["stepped_back_ok"] = (
            sum(v for k, v in step_backs.items() if "circuit_open" in k) >= 1
        )

        # --- SIGTERM drain of driver B ----------------------------------
        drv_b.send_signal(signal.SIGTERM)
        rc_b = drv_b.wait(timeout=60)
        log_b = open(os.path.join(tmp, "driver_b.log"), "rb").read()
        result["drain_ok"] = rc_b == 0 and b"shut down" in log_b

        # --- phase 4 (full): crash AFTER commit, before ack --------------
        if full:
            extra = [1] * max(3, n_reports // 2)
            for m in extra:
                client.upload(m)
            measurements += extra
            result["admitted"] = len(measurements)
            result["ground_truth_sum"] = sum(measurements)
            creator.run_once()
            port_c = _free_port()
            cfg_c = _driver_cfg(
                os.path.join(tmp, "driver_c.yaml"), leader_db, port_c, ttl, breaker_cooldown_s, device
            )
            drv_c = _spawn_driver(
                cfg_c, key, os.path.join(tmp, "driver_c.log"), POST_COMMIT_CRASH_SCHEDULE
            )
            procs.append(drv_c)
            rc_c = drv_c.wait(timeout=300)
            result["post_commit_crash_ok"] = rc_c == CRASH_EXIT_CODE
            # death after the commit: the work IS durable; a clean
            # restart must find nothing left to redo (and the final
            # exact-count collection proves nothing was re-done)
            states = agg_jobs_by_state()
            result["post_commit_job_finished_ok"] = states.get("in_progress", 0) == 0
            port_d = _free_port()
            cfg_d = _driver_cfg(
                os.path.join(tmp, "driver_d.yaml"), leader_db, port_d, ttl, breaker_cooldown_s, device
            )
            drv_d = _spawn_driver(
                cfg_d, key, os.path.join(tmp, "driver_d.log"), None
            )
            procs.append(drv_d)
            _wait_healthz(port_d)
            time.sleep(2.0)  # a couple of discovery passes
            drv_d.send_signal(signal.SIGTERM)
            rc_d = drv_d.wait(timeout=60)
            states = agg_jobs_by_state()
            result["clean_restart_ok"] = rc_d == 0 and states.get("in_progress", 0) == 0

        # --- phase 5: collect and compare against ground truth ----------
        # across a mid-commit crash, commit faults, transport storms and
        # helper 500s
        result.update(
            _collect_exact(leader_ds, leader_srv.url, leader_task, collector_kp, vdaf, clock, measurements)
        )

        result["elapsed_s"] = round(time.monotonic() - t_run0, 1)
        result["ok"] = all(v for k, v in result.items() if k.endswith("_ok"))
        return result
    finally:
        failpoints.clear()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if leader_srv is not None:
            leader_srv.stop()
        if helper_srv is not None:
            helper_srv.stop()
        leader_ds.close()
        helper_ds.close()


def run_db_outage(
    n_warm: int = 4,
    outage_hold_s: float = 1.5,
    probe_interval_s: float = 0.15,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Datastore-outage survival schedule (see module docstring); every
    `*_ok` key must be True for the run to pass."""
    import threading

    from .. import failpoints
    from ..aggregator.aggregation_job_creator import (
        AggregationJobCreator,
        AggregationJobCreatorConfig,
    )
    from ..aggregator.aggregation_job_driver import AggregationJobDriver
    from ..aggregator.core import Aggregator, Config
    from ..aggregator.http_handlers import DapHttpApp, DapServer
    from ..aggregator.job_driver import JobDriver, JobDriverConfig
    from ..binary_utils import (
        HealthServer,
        register_readiness_check,
        unregister_readiness_check,
        warmup_engines,
    )
    from ..client import Client, ClientParameters
    from ..core.http_client import HttpClient
    from ..core.time_util import RealClock
    from ..datastore.store import Crypter, Datastore
    from ..device import resolve_device
    from ..messages import AggregationJobInitializeReq

    dev = resolve_device(device)
    t_run0 = time.monotonic()
    tmp = workdir or tempfile.mkdtemp(prefix="janus-dbout-")
    os.makedirs(tmp, exist_ok=True)
    key_bytes = secrets.token_bytes(16)
    clock = RealClock()
    leader_ds = Datastore(
        os.path.join(tmp, "leader.sqlite"), Crypter([key_bytes]), clock
    )
    # the outage schedule targets ONLY this store (the in-process
    # helper's store keeps its default scope and stays up)
    leader_ds.failpoint_scope = "leader"
    helper_ds = Datastore(
        os.path.join(tmp, "helper.sqlite"), Crypter([key_bytes]), clock
    )
    sup = leader_ds.start_supervision(
        probe_interval_s=probe_interval_s,
        down_threshold=2,
        reconnect_max_interval_s=max(1.0, 4 * probe_interval_s),
    )
    register_readiness_check("datastore", sup.readiness)

    result: dict = {
        "workdir": tmp,
        "schedule": "db_outage_full" if full else "db_outage_smoke",
        "device": str(dev),
    }
    leader_srv = helper_srv = health_srv = None
    leader_agg = None
    try:
        journal_dir = os.path.join(tmp, "upload-journal")
        leader_agg = Aggregator(
            leader_ds,
            clock,
            Config(
                collection_retry_after_s=1,
                upload_journal_path=journal_dir,
                upload_journal_replay_interval_s=0.2,
            ),
            device=dev,
        )
        journal = leader_agg.upload_journal
        helper_srv = DapServer(
            DapHttpApp(Aggregator(helper_ds, clock, Config(), device=dev))
        ).start()
        leader_srv = DapServer(DapHttpApp(leader_agg)).start()
        health_srv = HealthServer("127.0.0.1:0").start()
        hp = health_srv.port

        leader_task, collector_kp, vdaf = _provision_pair(
            leader_ds, helper_ds, leader_srv.url, helper_srv.url, 201, 2
        )
        warmup_engines(leader_ds, devices=[dev])

        http = HttpClient()
        params = ClientParameters(
            leader_task.task_id,
            leader_srv.url,
            helper_srv.url,
            leader_task.time_precision,
        )
        client = Client.with_fetched_configs(params, vdaf, http, clock=clock)

        # --- sustained upload load: one background uploader running
        # across the whole schedule; every 201-acked measurement is
        # ground truth, wherever the ack came from -------------------
        acked: list[int] = []
        upload_errors: list[str] = []
        stop_uploader = threading.Event()

        def uploader():
            i = 0
            while not stop_uploader.is_set():
                m = (i % 3 != 0) * 1
                try:
                    client.upload(m)
                    acked.append(m)
                except Exception as e:  # shed/refused: NOT ground truth
                    upload_errors.append(f"{type(e).__name__}: {e}")
                i += 1
                stop_uploader.wait(0.04)

        # --- phase 1: healthy, journal armed but idle ----------------
        t0 = time.monotonic()
        for i in range(n_warm):
            client.upload(1)
            acked.append(1)
        result["healthy_upload_ms"] = round(
            (time.monotonic() - t0) / max(1, n_warm) * 1000, 2
        )
        # the armed-but-idle journal must not touch the hot path
        result["healthy_fsyncs"] = journal.fsyncs
        result["healthy_fsyncs_ok"] = journal.fsyncs == 0
        status, body = _http_status(f"http://127.0.0.1:{hp}/readyz")
        result["readyz_up_ok"] = (
            status == 200 and json.loads(body).get("ready") is True
        )
        # jobs created now but NOT stepped: the outage-window driver
        # pass below must park instead of burning their lease attempts
        creator = AggregationJobCreator(
            leader_ds,
            AggregationJobCreatorConfig(
                min_aggregation_job_size=1, max_aggregation_job_size=100
            ),
        )
        creator.run_once()

        ut = threading.Thread(target=uploader, daemon=True)
        ut.start()
        time.sleep(6 * 0.04)  # a few sustained-load acks while healthy

        # --- phase 2: kill the datastore under load ------------------
        acked_before_outage = len(acked)
        failpoints.configure(DB_OUTAGE_SCHEDULE)
        deadline = time.monotonic() + 30
        while sup.state != "down" and time.monotonic() < deadline:
            time.sleep(0.02)
        result["supervisor_down_ok"] = sup.state == "down"
        status, body = _http_status(f"http://127.0.0.1:{hp}/readyz")
        try:
            reasons = json.loads(body).get("reasons", {})
        except Exception:
            reasons = {}
        result["readyz_down_status"] = status
        result["readyz_down_ok"] = status == 503 and bool(reasons)
        # aggregate-step routes shed 503 up front while the store is
        # down (the helper would only waste work on a doomed handler)
        tid = base64.urlsafe_b64encode(leader_task.task_id.data).decode().rstrip("=")
        jid = base64.urlsafe_b64encode(secrets.token_bytes(16)).decode().rstrip("=")
        status, _ = _http_status(
            f"{leader_srv.url}tasks/{tid}/aggregation_jobs/{jid}",
            method="PUT",
            body=b"x",
            headers={"Content-Type": AggregationJobInitializeReq.MEDIA_TYPE},
        )
        result["aggregate_shed_status"] = status
        result["aggregate_shed_ok"] = status == 503
        # a driver pass during the outage parks (no acquire, no lease
        # attempts burned) instead of crashing or marching to abandon
        drv = AggregationJobDriver(leader_ds, http, device=dev)
        jd = JobDriver(
            JobDriverConfig(job_discovery_interval_s=0.1),
            drv.acquirer(60),
            drv.stepper,
        )
        result["driver_parked_ok"] = jd.run_once() == 0
        time.sleep(outage_hold_s)  # sustained load keeps acking into the journal
        depth_during = journal.depth()
        result["journal_depth_during_outage"] = depth_during[0]
        acked_during_outage = len(acked) - acked_before_outage
        result["acked_during_outage"] = acked_during_outage
        result["spilled_acked_ok"] = (
            acked_during_outage > 0 and depth_during[0] > 0
        )

        # --- phase 3: recovery ---------------------------------------
        failpoints.clear()
        deadline = time.monotonic() + 60
        while (
            sup.state != "up" or journal.depth()[0] > 0
        ) and time.monotonic() < deadline:
            time.sleep(0.05)
        result["supervisor_recovered_ok"] = sup.state == "up"
        result["journal_drained_ok"] = journal.depth()[0] == 0
        status, body = _http_status(f"http://127.0.0.1:{hp}/readyz")
        result["readyz_recovered_ok"] = (
            status == 200 and json.loads(body).get("ready") is True
        )
        time.sleep(6 * 0.04)  # a few more sustained-load acks while healthy
        stop_uploader.set()
        ut.join(timeout=30)
        result["admitted"] = len(acked)
        result["ground_truth_sum"] = sum(acked)
        result["upload_errors"] = upload_errors[:5]
        result["uploads_all_acked_ok"] = not upload_errors

        # --- phase 4: aggregate + collect == ground truth ------------
        creator.run_once()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            jd.run_once()
            counts = leader_ds.run_tx(
                lambda tx: tx.count_jobs_by_state(), "dbout_monitor"
            )
            agg = {s: n for (t, s), n in counts.items() if t == "aggregation"}
            if agg.get("in_progress", 0) == 0:
                break
            time.sleep(0.1)
        # absent key = zero jobs in that state (count_jobs_by_state only
        # returns states with rows)
        result["aggregation_done_ok"] = agg.get("in_progress", 0) == 0 and bool(
            agg.get("finished", 0)
        )
        # every 201 — healthy, spilled, replayed — exactly once
        result.update(
            _collect_exact(leader_ds, leader_srv.url, leader_task, collector_kp, vdaf, clock, acked)
        )

        result["journal_fsyncs_total"] = journal.fsyncs
        result["elapsed_s"] = round(time.monotonic() - t_run0, 1)
        result["ok"] = all(v for k, v in result.items() if k.endswith("_ok"))
        return result
    finally:
        failpoints.clear()
        unregister_readiness_check("datastore")
        unregister_readiness_check("upload_journal")
        if leader_agg is not None:
            leader_agg.close()
        for srv in (leader_srv, helper_srv):
            if srv is not None:
                srv.stop()
        if health_srv is not None:
            health_srv.stop()
        leader_ds.close()
        helper_ds.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--smoke",
        action="store_true",
        help="fast deterministic schedule (crash + storm + collect); "
        "the default runs the full schedule incl. the post-commit crash",
    )
    ap.add_argument(
        "--scenario",
        choices=["crash_storm", "db_outage"],
        default="crash_storm",
        help="crash_storm = driver SIGKILL + helper storms (default); "
        "db_outage = datastore outage under upload load (journal spill, "
        "degraded serving, replay, exactly-once)",
    )
    ap.add_argument("--reports", type=int, default=0, help="0 = schedule default")
    ap.add_argument("--json", action="store_true", help="print the result record as JSON")
    ap.add_argument("--workdir", default=None, help="keep artifacts here (default: temp dir)")
    ap.add_argument(
        "--device",
        default="cuda",
        help="device of the leader, the helper and the driver binaries "
        "(default cuda; `cpu` only where asked)",
    )
    args = ap.parse_args(argv)

    if args.scenario == "db_outage":
        result = run_db_outage(
            n_warm=args.reports or (4 if args.smoke else 10),
            outage_hold_s=1.5 if args.smoke else 5.0,
            full=not args.smoke,
            workdir=args.workdir,
            device=args.device,
        )
    else:
        result = run_chaos(
            n_reports=args.reports or (5 if args.smoke else 12),
            full=not args.smoke,
            workdir=args.workdir,
            device=args.device,
        )
    if args.json:
        print(json.dumps(result))
    else:
        print(json.dumps(result, indent=2))
    if not result.get("ok"):
        failed = [k for k, v in result.items() if k.endswith("_ok") and not v]
        print(f"CHAOS FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
