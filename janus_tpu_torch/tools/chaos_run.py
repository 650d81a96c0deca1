"""Crash-recovery chaos harness: prove exactly-once aggregation under
injected faults, against the port's own job driver binary.

The port's counterpart of janus_tpu's scripts/chaos_run.py: its nine
scenarios (`crash_storm`, the default, `db_outage`, `device_hang`,
`pipeline`, `resident`, `fleet`, `soak`, `peer_outage`, `cold_start`),
each against the port's own binaries, with janus_tpu's schedules, lease,
breaker and canary timings, wave sizes and `*_ok` keys. Where the port
differs (no host engine, the port's own hang bound and slot size,
SQLite only, the soak smoke's health cadence, the kernel-library cache
in place of the AOT compile cache), each `run_*` docstring says so.

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

The other seven, one function each (its docstring has the invariants):

  - `device_hang` (run_device_hang): a driver binary's first dispatch
    wedges; past the `device_watchdog: hang_after_secs` bound (2 s,
    inside the 8 s lease) it steps back `device_hang`, the engine
    quarantines, the re-acquired job steps back `device_quarantined`
    (no host engine: no work lands while quarantined,
    `no_interim_work_ok`), the canary restores the engine and the job
    finishes on the device;
  - `resident` (run_resident): resident accumulators under a byte cap of
    one port Count slot (`count_slot_nbytes()`): eviction, quarantine
    sweep and SIGTERM drain each flush resident state, a block-sparse
    task's merges run the scatter kernel in the binary, collections
    exact;
  - `pipeline` (run_pipeline): the stage-pipelined stepper overlaps the
    device lane with a stretched helper RTT;
  - `fleet` (run_fleet, with claim_roundtrip_stats): replicas from their
    YAML `fleet:` stanzas over one store, the scaling curve, a SIGKILL
    mid-step, a drain and a restart, zero lease conflicts, the
    conservation ledger at every quiesce point;
  - `soak` (run_soak): task churn and GC judged by the flight
    recorder's trend verdicts, an injected leak firing the trend alert;
    SQLite only (the port reads no JANUS_TEST_DATABASE_URL);
  - `peer_outage` (run_peer_outage): both driver binaries reach the
    helper through a core/netsim.py FaultProxy: blackhole, park, probe,
    heal, slicer and truncate lanes;
  - `cold_start` (run_cold_start, with seed_manifest): a cold and a warm
    boot of the driver binary on one shape manifest: the manifest phase,
    the prewarm before ready, the kernel libraries built cold and loaded
    warm, and on request one real job after ready with no cold first call
    at a recorded key.

Usage:
    python -m janus_tpu_torch.tools.chaos_run --smoke --json
    python -m janus_tpu_torch.tools.chaos_run --json        # full schedule
    python -m janus_tpu_torch.tools.chaos_run --scenario <name> --smoke --json
        (<name>: db_outage, device_hang, resident, pipeline, peer_outage,
        fleet, soak, cold_start)
    ... --device cpu                  # the default is CUDA

Exit code 0 iff every invariant held; the result JSON rides on stdout.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
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
# the driver's first device dispatch wedges FOREVER (released only by
# the stopper): the hung-dispatch model for --scenario device_hang
DEVICE_HANG_SCHEDULE = "engine.dispatch=hang,count=1"
# --scenario pipeline: stretch every helper RTT so the stage pipeline
# has a real window to overlap device work with (loopback RTTs are
# otherwise microseconds and the overlap proof would be flaky)
PIPELINE_RTT_SCHEDULE = "helper.request=delay:0.08"
# --scenario fleet: stretch the helper RTT so job throughput is
# RTT-bound — N replicas' worker pools then overlap N times the
# sleeping round trips and the served-rps scaling curve measures FLEET
# parallelism, not the host's CPU arithmetic
FLEET_RTT_SCHEDULE = "helper.request=delay:0.1"
# --scenario resident: the first four SERVING device dispatches (two
# count tasks x leader_init + masked-delta) land clean, the FIFTH
# wedges forever — quarantining the engine while earlier jobs'
# aggregate state sits resident in device memory; two canary probes
# fail to hold the quarantine window open long enough to observe the
# flush live. The driver's boot warmup dispatches don't shift the
# anchor: warmup runs under failpoints.suppressed()
RESIDENT_SCHEDULE = "engine.dispatch=hang,count=1,after=4;engine.canary=error:1.0,count=2"
# the driver's hang bound (`device_watchdog: hang_after_secs`) in the two
# scenarios whose dispatch hangs: inside their 8 s and 6 s leases, where
# janus_tpu's watchdog declares the hang at the lease deadline itself
HANG_AFTER_S = 2.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _driver_cfg(path, db, health_port, ttl_s, cooldown_s, device: str, extra: str = ""):
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
        + extra
    )
    with open(path, "w") as f:
        f.write(cfg)
    return str(path)


def _watchdog_yaml(canary_delay_s: float) -> str:
    """The `device_watchdog:` stanza of a driver whose dispatch hangs: the
    canary's cool-down and probe bound, and the port's own hang bound
    (a wedged dispatch must step back inside the lease, not at 30 s)."""
    return (
        "device_watchdog:\n"
        f"  canary_delay_secs: {canary_delay_s}\n"
        "  canary_timeout_secs: 30\n"
        f"  hang_after_secs: {HANG_AFTER_S}\n"
    )


def _spawn_driver(cfg_path, key, log_path, failpoints: str | None,
                  module: str = "janus_tpu_torch.bin.aggregation_job_driver"):
    """The real job driver binary `module` (the aggregation job driver
    unless named) on `cfg_path`, armed with `failpoints` through
    JANUS_FAILPOINTS (none: unarmed)."""
    env = dict(os.environ, PYTHONPATH=REPO, DATASTORE_KEYS=key)
    if failpoints:
        env["JANUS_FAILPOINTS"] = failpoints
    else:
        env.pop("JANUS_FAILPOINTS", None)
    logf = open(log_path, "wb")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", module, "--config-file", str(cfg_path)],
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
                    helper_config_id: int, vdaf=None, **task_kw):
    """One time-interval task (Prio3Count unless `vdaf` names another;
    `task_kw` overrides TaskBuilder fields) on each side; returns (leader
    task, collector keypair, vdaf)."""
    import dataclasses

    from ..core.auth import AuthenticationToken
    from ..core.hpke import generate_hpke_config_and_private_key
    from ..messages import Role
    from ..task import QueryTypeConfig, TaskBuilder
    from ..vdaf.registry import VdafInstance

    vdaf = vdaf or VdafInstance.count()
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
            **task_kw,
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


@contextlib.contextmanager
def _collection_driver(leader_ds):
    """The collection job driver, in this process, stepping in the
    background while the body collects."""
    import threading

    from ..aggregator.collection_job_driver import CollectionJobDriver
    from ..aggregator.job_driver import JobDriver, JobDriverConfig
    from ..core.http_client import HttpClient

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
        yield
    finally:
        stop_collect.set()
        ct.join(timeout=10)


def _collector(leader_url, leader_task, collector_kp, vdaf):
    """The real Collector of `leader_task` against the leader at `leader_url`."""
    from ..collector import Collector, CollectorParameters
    from ..core.http_client import HttpClient

    return Collector(
        CollectorParameters(leader_task.task_id, leader_url, leader_task.collector_auth_token, collector_kp),
        vdaf,
        HttpClient(),
    )


def _window_query(leader_task, at, units: int = 3):
    """A time-interval query of `units` batch units from the one before
    the unit holding `at` (a messages.Time)."""
    from ..messages import Duration, Interval, Query, Time

    tp = leader_task.time_precision
    start = at.to_batch_interval_start(tp)
    return Query.time_interval(Interval(Time(start.seconds - tp.seconds), Duration(units * tp.seconds)))


def _collect_exact(leader_ds, leader_url, leader_task, collector_kp, vdaf, clock, want,
                   timeout_s: float = 120.0) -> dict:
    """Run the collection job driver in-process while the real Collector
    collects the three-interval window around now; `want` is the list
    of admitted measurements."""
    with _collection_driver(leader_ds):
        collected = _collector(leader_url, leader_task, collector_kp, vdaf).collect(
            _window_query(leader_task, clock.now()), timeout_s=timeout_s
        )
    # THE invariant: exactly the admitted reports, no loss, no double
    # count
    return {
        "collected_count": collected.report_count,
        "collected_sum": collected.aggregate_result,
        "exactly_once_ok": (
            collected.report_count == len(want)
            and collected.aggregate_result == sum(want)
        ),
    }


class _Pair:
    """The harness's in-process leader and helper: an Aggregator each on
    `device` over its own datastore (the leader's at `leader_db`, a
    SQLite file in `tmp` unless named), behind DapServers on loopback.
    Both stores share one key, which the driver binaries get as
    DATASTORE_KEYS."""

    def __init__(self, tmp: str, device: str, clock, leader_db: str | None = None):
        from ..datastore.store import Crypter, open_datastore

        key_bytes = secrets.token_bytes(16)
        self.key = base64.urlsafe_b64encode(key_bytes).decode().rstrip("=")
        self.clock = clock
        self.device = device
        self.leader_db = leader_db or os.path.join(tmp, "leader.sqlite")
        self.leader_ds = open_datastore(self.leader_db, Crypter([key_bytes]), clock)
        self.helper_ds = open_datastore(os.path.join(tmp, "helper.sqlite"), Crypter([key_bytes]), clock)
        self.leader_srv = self.helper_srv = None

    def start(self) -> "_Pair":
        from ..aggregator.core import Aggregator, Config
        from ..aggregator.http_handlers import DapHttpApp, DapServer

        self.helper_srv = DapServer(
            DapHttpApp(Aggregator(self.helper_ds, self.clock, Config(), device=self.device))
        ).start()
        self.leader_srv = DapServer(
            DapHttpApp(Aggregator(self.leader_ds, self.clock, Config(collection_retry_after_s=1),
                                  device=self.device))
        ).start()
        return self

    def provision(self, collector_config_id: int, helper_config_id: int, vdaf=None, helper_url=None, **task_kw):
        """_provision_pair on this pair (the helper's endpoint its server's
        unless `helper_url` names another, a proxy's)."""
        return _provision_pair(self.leader_ds, self.helper_ds, self.leader_srv.url,
                               helper_url or self.helper_srv.url, collector_config_id, helper_config_id,
                               vdaf, **task_kw)

    def client(self, leader_task, vdaf):
        """The real Client of `leader_task` (HPKE configs fetched over HTTP)."""
        from ..client import Client, ClientParameters
        from ..core.http_client import HttpClient

        params = ClientParameters(
            leader_task.task_id, self.leader_srv.url, self.helper_srv.url, leader_task.time_precision
        )
        return Client.with_fetched_configs(params, vdaf, HttpClient(), clock=self.clock)

    def agg_jobs_by_state(self) -> dict:
        """{state: count} of the leader's aggregation jobs (a state with
        no job is absent)."""
        counts = self.leader_ds.run_tx(lambda tx: tx.count_jobs_by_state(), "chaos_monitor")
        return {state: n for (typ, state), n in counts.items() if typ == "aggregation"}

    def finished_jobs(self) -> int:
        return self.agg_jobs_by_state().get("finished", 0)

    def held_agg_leases(self) -> list:
        return [
            e for e in self.leader_ds.run_tx(lambda tx: tx.get_held_lease_expiries(), "chaos_monitor")
            if e[0] == "aggregation"
        ]

    def collect_exact(self, leader_task, collector_kp, vdaf, want, timeout_s: float = 120.0) -> dict:
        return _collect_exact(self.leader_ds, self.leader_srv.url, leader_task, collector_kp, vdaf, self.clock,
                              want, timeout_s)

    def close(self) -> None:
        for srv in (self.leader_srv, self.helper_srv):
            if srv is not None:
                srv.stop()
        self.leader_ds.close()
        self.helper_ds.close()


def _stop_all(procs) -> None:
    """Kill every process the scenario started that is still running."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _sigterm_drain(proc, log_path: str, timeout_s: float = 60.0) -> tuple:
    """SIGTERM `proc`; (rc, drained cleanly: rc 0 and the binary's
    "shut down" line in its log)."""
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=timeout_s)
    with open(log_path, "rb") as f:
        return rc, rc == 0 and b"shut down" in f.read()


def _open_run(device: str, workdir: str | None, prefix: str):
    """(resolved device string, run directory): resolve_device raises
    without CUDA where the caller did not name the CPU, before the
    directory or anything else exists."""
    from ..device import resolve_device

    device = str(resolve_device(device))
    tmp = workdir or tempfile.mkdtemp(prefix=prefix)
    os.makedirs(tmp, exist_ok=True)
    return device, tmp


def _finish(result: dict, t_run0: float) -> dict:
    result["elapsed_s"] = round(time.monotonic() - t_run0, 1)
    result["ok"] = all(v for k, v in result.items() if k.endswith("_ok"))
    return result


def _label_sum(samples: dict, needle: str) -> float:
    return sum(v for k, v in samples.items() if needle in k)


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
    from ..binary_utils import warmup_engines
    from ..core.time_util import RealClock
    from ..failpoints import CRASH_EXIT_CODE

    # the driver binaries' YAML names the device with its index
    device, tmp = _open_run(device, workdir, "janus-chaos-")
    t_run0 = time.monotonic()
    clock = RealClock()
    pair = _Pair(tmp, device, clock)
    leader_db, key = pair.leader_db, pair.key
    leader_ds = pair.leader_ds

    result: dict = {"workdir": tmp, "schedule": "full" if full else "smoke", "device": device}
    procs: list[subprocess.Popen] = []
    try:
        pair.start()
        leader_task, collector_kp, vdaf = pair.provision(200, 1)
        # warm the in-process helper's engine (it shares the engine
        # cache with this process's leader): the helper's first
        # aggregate-init then answers inside the driver's request budget
        warmup_engines(leader_ds, devices=[device])

        # --- phase 1: ground truth -------------------------------------
        client = pair.client(leader_task, vdaf)
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
        held_agg_leases = pair.held_agg_leases
        agg_jobs_by_state = pair.agg_jobs_by_state

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
        result["drain_ok"] = _sigterm_drain(drv_b, os.path.join(tmp, "driver_b.log"))[1]

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
        result.update(pair.collect_exact(leader_task, collector_kp, vdaf, measurements))
        return _finish(result, t_run0)
    finally:
        failpoints.clear()
        _stop_all(procs)
        pair.close()


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


def run_device_hang(
    n_reports: int = 5,
    lease_ttl_s: int = 8,
    canary_delay_s: float = 1.5,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Deadline-aware device-path schedule: the real aggregation job
    driver binary runs with `engine.dispatch=hang,count=1` armed — its
    first device dispatch wedges forever, as a hung kernel or a stalled
    fetch would. Invariants:

      - the hung step never outlives its lease: past the watchdog's hang
        bound (`device_watchdog: hang_after_secs`, inside the lease) the
        dispatch is abandoned and the job steps back
        (`janus_job_step_back_total{reason="device_hang"}`), releasing
        the lease BEFORE its expiry;
      - the abandoned thread is visible (`janus_hung_dispatches_total`,
        `janus_abandoned_dispatch_threads` under the cap, a live stack
        dump in /statusz `device_watchdog.stalled`) and the engine goes
        device → quarantined → (canary probe) → device, all observed
        live over the driver's /metrics + /statusz;
      - no work lands while quarantined (the port has no host engine):
        the re-acquired job steps back `device_quarantined`, attempt
        refunded, and finishes on the device after the restore; the
        final collection equals the admitted ground truth exactly;
      - the driver SIGTERM-drains cleanly (release_hangs unparks the
        modeled wedge on shutdown).

    Every `*_ok` key must be True to pass."""
    from ..aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from ..binary_utils import warmup_engines
    from ..core.time_util import RealClock

    device, tmp = _open_run(device, workdir, "janus-devhang-")
    t_run0 = time.monotonic()
    clock = RealClock()
    pair = _Pair(tmp, device, clock)
    result: dict = {
        "workdir": tmp,
        "schedule": "device_hang_full" if full else "device_hang_smoke",
        "device": device,
        "hang_after_s": HANG_AFTER_S,
    }
    procs: list[subprocess.Popen] = []
    try:
        pair.start()
        leader_task, collector_kp, vdaf = pair.provision(202, 3)
        # the in-process helper's engine, warm: its first aggregate-init
        # answers inside the driver's request budget
        warmup_engines(pair.leader_ds, devices=[device])
        client = pair.client(leader_task, vdaf)
        measurements = [(i % 3 != 0) * 1 for i in range(n_reports)]
        for m in measurements:
            client.upload(m)
        AggregationJobCreator(
            pair.leader_ds,
            AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=100),
        ).run_once()
        result["admitted"] = len(measurements)
        result["ground_truth_sum"] = sum(measurements)

        # --- spawn the real driver with the hang armed ------------------
        port = _free_port()
        cfg = _driver_cfg(
            os.path.join(tmp, "driver.yaml"), pair.leader_db, port, int(lease_ttl_s), 1.5, device,
            # fast canary cycle so the quarantine window is short but
            # still reliably observable by the 0.05s poll below
            extra=_watchdog_yaml(canary_delay_s),
        )
        log_path = os.path.join(tmp, "driver.log")
        drv = _spawn_driver(cfg, pair.key, log_path, DEVICE_HANG_SCHEDULE)
        procs.append(drv)
        _wait_healthz(port)

        # --- observe: lease bounded, watchdog + quarantine visible, no
        # job finishing between the open and the restore -------------
        first_expiry = None
        released_at = None  # wall clock when the FIRST (hung) lease left
        quarantined_seen = False
        quarantined_at = None  # monotonic when quarantine first observed
        restored_at = None
        open_finished = None  # finished jobs when the open was first seen
        interim_finishes = 0
        stalled_stack_seen = False
        abandoned_max = 0.0
        cap = None
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            leases = pair.held_agg_leases()
            now_wall = clock.now().seconds
            if leases and first_expiry is None:
                first_expiry = leases[0][3]
                result["first_lease_expiry"] = first_expiry
            if (
                first_expiry is not None
                and released_at is None
                and not any(e[3] == first_expiry for e in leases)
            ):
                released_at = now_wall
            # the job states are read BEFORE the metrics: a job seen
            # finished here while the metrics below still show the
            # quarantine open (and no restore) finished inside it
            states = pair.agg_jobs_by_state()
            finished = states.get("finished", 0)
            try:
                mtext = _scrape(port, "/metrics")
                backend = _metric_samples(mtext, "janus_engine_backend")
                if backend.get('state="quarantined",vdaf="count"') == 1.0:
                    if not quarantined_seen:
                        quarantined_at = time.monotonic()
                    quarantined_seen = True
                quar = _metric_samples(mtext, "janus_engine_quarantines_total")
                restored = _label_sum(quar, 'event="restored"') >= 1
                if open_finished is not None and not restored and finished > open_finished:
                    interim_finishes = max(interim_finishes, finished - open_finished)
                if open_finished is None and _label_sum(quar, 'event="open"') >= 1:
                    open_finished = finished
                if restored and restored_at is None:
                    restored_at = time.monotonic()
                ab = _metric_samples(mtext, "janus_abandoned_dispatch_threads")
                abandoned_max = max(abandoned_max, *(ab.values() or [0.0]))
                statusz = json.loads(_scrape(port, "/statusz"))
                wd = statusz.get("device_watchdog", {})
                cap = wd.get("abandoned_thread_cap", cap)
                for ent in wd.get("stalled", []):
                    if ent.get("stack"):
                        stalled_stack_seen = True
            except Exception:
                pass  # scrape raced the driver's own work; retry next poll
            # the job finishes only after the canary's cycle: the loop
            # ends once it is finished AND the restore was seen
            if states.get("in_progress", 0) == 0 and finished >= 1 and restored_at is not None:
                break
            time.sleep(0.05)

        states = pair.agg_jobs_by_state()
        result["job_finished_ok"] = (
            states.get("finished", 0) >= 1 and states.get("in_progress", 0) == 0
        )
        # THE lease-bound invariant: the hung step released its lease
        # (stepped back) BEFORE the lease expired — the wedge never
        # outlives the lease and runs concurrently with a re-acquirer.
        # (+1s margin covers the 0.05s poll + second-granularity clock.)
        result["hung_lease_released_at"] = released_at
        result["lease_bounded_ok"] = (
            first_expiry is not None
            and released_at is not None
            and released_at <= first_expiry + 1
        )
        result["quarantined_observed_ok"] = quarantined_seen
        result["stalled_stack_ok"] = stalled_stack_seen
        result["abandoned_max"] = abandoned_max
        result["abandoned_under_cap_ok"] = (
            abandoned_max >= 1.0 and cap is not None and abandoned_max < cap
        )
        # no host engine: nothing lands between the open and the restore
        result["interim_finished_jobs"] = interim_finishes
        result["no_interim_work_ok"] = open_finished is not None and interim_finishes == 0

        # the restore: the canary's cool-down plus one probe dispatch (the
        # port compiles nothing); 20 s leaves headroom over the ~1.5 s
        # cool-down
        restore_elapsed = (
            None if quarantined_at is None or restored_at is None else restored_at - quarantined_at
        )
        result["restore_elapsed_s"] = round(restore_elapsed, 2) if restore_elapsed is not None else None
        result["restore_warm_ok"] = restore_elapsed is not None and restore_elapsed <= 20.0

        # --- steady state: restored to device, counters tell the story --
        mtext = _scrape(port, "/metrics")
        hung = _metric_samples(mtext, "janus_hung_dispatches_total")
        result["hung_dispatches"] = hung
        result["hung_dispatch_ok"] = sum(hung.values()) >= 1
        step_backs = _metric_samples(mtext, "janus_job_step_back_total")
        result["step_backs"] = step_backs
        result["stepped_back_device_hang_ok"] = _label_sum(step_backs, "device_hang") >= 1
        quar = _metric_samples(mtext, "janus_engine_quarantines_total")
        result["quarantine_events"] = quar
        result["quarantine_cycle_ok"] = (
            _label_sum(quar, 'event="open"') >= 1 and _label_sum(quar, 'event="restored"') >= 1
        )
        backend = _metric_samples(mtext, "janus_engine_backend")
        result["restored_ok"] = (
            backend.get('state="device",vdaf="count"') == 1.0
            and backend.get('state="quarantined",vdaf="count"') == 0.0
        )
        statusz = json.loads(_scrape(port, "/statusz"))
        result["statusz_watchdog_ok"] = (
            statusz.get("device_watchdog", {}).get("hung_dispatches_total", 0) >= 1
        )
        result["driver_devices"] = statusz.get("process", {}).get("devices")

        # --- SIGTERM drain (release_hangs unparks the modeled wedge) ----
        result["drain_rc"], result["drain_ok"] = _sigterm_drain(drv, log_path)

        # --- collect and compare against ground truth -------------------
        # every admitted report exactly once, finished on the device
        # after the restore
        result.update(pair.collect_exact(leader_task, collector_kp, vdaf, measurements))
        return _finish(result, t_run0)
    finally:
        from .. import failpoints

        failpoints.clear()
        _stop_all(procs)
        pair.close()


def _histogram_counts(text: str, name: str) -> dict[str, float]:
    """{label_block: value} of a histogram family's _count samples."""
    from ..exposition import parse_exposition

    fam = parse_exposition(text)[0].get(name)
    if fam is None:
        return {}
    return {
        ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())): float(value)
        for sample_name, labels, value in fam.samples
        if sample_name == name + "_count"
    }


def run_pipeline(
    n_reports: int = 24,
    job_size: int = 3,
    lease_ttl_s: int = 60,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Stage-pipeline overlap proof: the REAL driver binary — pipelined
    stepper enabled via its YAML `step_pipeline:` stanza — steps many
    small jobs against a loopback helper whose RTT is stretched by a
    `helper.request=delay` failpoint. Asserts the overlap actually
    happened (the device lane ran while an HTTP leg was in flight:
    janus_step_pipeline_overlap_total > 0 and a recorded overlap ratio
    > 0), every pipeline stage executed (stage-seconds counts for
    read/device/http/commit), the device-lane busy ratio is live,
    SIGTERM drains rc 0, and the final collection equals the admitted
    ground truth exactly — the pipeline never loses or double-steps a
    job. Every `*_ok` key must be True to pass."""
    from ..aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from ..binary_utils import warmup_engines
    from ..core.time_util import RealClock

    device, tmp = _open_run(device, workdir, "janus-pipeline-")
    t_run0 = time.monotonic()
    clock = RealClock()
    pair = _Pair(tmp, device, clock)
    result: dict = {
        "workdir": tmp,
        "schedule": "pipeline_full" if full else "pipeline_smoke",
        "device": device,
    }
    procs: list[subprocess.Popen] = []
    try:
        pair.start()
        leader_task, collector_kp, vdaf = pair.provision(204, 3)
        warmup_engines(pair.leader_ds, batch=job_size, devices=[device])
        client = pair.client(leader_task, vdaf)
        measurements = [(i % 3 != 0) * 1 for i in range(n_reports)]
        for m in measurements:
            client.upload(m)
        # many SMALL jobs: the pipeline needs several concurrently
        # leased steps for its stages to interleave
        AggregationJobCreator(
            pair.leader_ds,
            AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=job_size),
        ).run_once()
        result["admitted"] = len(measurements)
        result["ground_truth_sum"] = sum(measurements)
        result["jobs_created"] = (n_reports + job_size - 1) // job_size

        # --- spawn the real driver: pipelined stepper via YAML ----------
        port = _free_port()
        cfg = _driver_cfg(
            os.path.join(tmp, "driver.yaml"), pair.leader_db, port, int(lease_ttl_s), 1.5, device,
            extra=(
                "max_concurrent_job_workers: 4\n"
                "step_pipeline:\n"
                "  enabled: true\n"
                "  prefetch_depth: 2\n"
                "  http_inflight: 2\n"
                "  commit_inflight: 2\n"
            ),
        )
        log_path = os.path.join(tmp, "driver.log")
        drv = _spawn_driver(cfg, pair.key, log_path, PIPELINE_RTT_SCHEDULE)
        procs.append(drv)
        _wait_healthz(port)

        # --- wait for all jobs to finish --------------------------------
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            states = pair.agg_jobs_by_state()
            if states.get("in_progress", 0) == 0 and states.get("finished", 0) >= result["jobs_created"]:
                break
            time.sleep(0.1)
        states = pair.agg_jobs_by_state()
        result["job_states"] = states
        result["jobs_finished_ok"] = (
            states.get("finished", 0) >= result["jobs_created"]
            and states.get("in_progress", 0) == 0
        )

        mtext = _scrape(port, "/metrics")
        overlap = _metric_samples(mtext, "janus_step_pipeline_overlap_total")
        result["overlapped_dispatches"] = sum(overlap.values())
        result["overlap_ok"] = result["overlapped_dispatches"] >= 1
        busy = _metric_samples(mtext, "janus_device_lane_busy_ratio")
        result["device_lane_busy_ratio"] = max(busy.values() or [0.0])
        result["device_lane_busy_ok"] = result["device_lane_busy_ratio"] > 0
        stage_counts = _histogram_counts(mtext, "janus_step_pipeline_stage_seconds")
        result["stage_seconds_counts"] = stage_counts
        result["stages_executed_ok"] = all(
            any(f'stage="{s}"' in k and v > 0 for k, v in stage_counts.items())
            for s in ("read", "device", "http", "commit")
        )
        statusz = json.loads(_scrape(port, "/statusz"))
        sp = statusz.get("step_pipeline", {})
        result["statusz_overlap_ratio"] = sp.get("overlap_ratio", 0)
        result["statusz_overlap_events"] = sp.get("overlap_events", 0)
        result["statusz_pipeline_ok"] = (
            sp.get("jobs_done", 0) >= result["jobs_created"]
            and sp.get("overlap_events", 0) > 0
            and sp.get("device_lane", {}).get("concurrent_peak", 99) <= 1
        )
        result["driver_devices"] = statusz.get("process", {}).get("devices")

        # --- SIGTERM drain ---------------------------------------------
        result["drain_rc"], result["drain_ok"] = _sigterm_drain(drv, log_path)

        # --- collect and compare against ground truth -------------------
        result.update(pair.collect_exact(leader_task, collector_kp, vdaf, measurements))
        return _finish(result, t_run0)
    finally:
        _stop_all(procs)
        pair.close()


def count_slot_nbytes() -> int:
    """The device bytes of one resident Prio3Count slot in the port: the
    engine's `row_nbytes` (output_len x Field64 limbs x 8), what
    `EngineCache.aggregate_pending` charges a slot."""
    from ..vdaf.registry import VdafInstance, prio3_batched

    p3 = prio3_batched(VdafInstance.count(), "cpu")
    return p3.circ.output_len * p3.tf.LIMBS * 8


# the resident scenario's block-sparse task at janus_tpu's geometry
DEFAULT_SPARSE = dict(bits=3, length=48, block_size=4, max_blocks=3)


def _sparse_waves(vdaf) -> tuple:
    """The resident scenario's two block-sparse waves (2 reports, then 1)
    as (block, values) pairs: janus_tpu's own at its geometry
    (DEFAULT_SPARSE), else drawn from a seeded generator at `vdaf`'s
    (2 or max_blocks distinct ascending blocks a report, drawn uniformly,
    values below 2^bits)."""
    if all(getattr(vdaf, k) == v for k, v in DEFAULT_SPARSE.items()):
        return (
            [
                [(0, [1, 2, 3, 4]), (5, [7, 0, 1, 2])],
                [(0, [0, 1, 0, 1]), (3, [2, 2, 2, 2]), (11, [5, 0, 0, 6])],
            ],
            [[(2, [1, 0, 0, 3]), (7, [0, 4, 0, 0])]],
        )
    import numpy as np

    rng = np.random.default_rng(20261018)
    n_blocks = vdaf.length // vdaf.block_size

    def report(nb: int):
        blocks = sorted(rng.choice(n_blocks, size=nb, replace=False).tolist())
        return [(b, rng.integers(0, 1 << vdaf.bits, size=vdaf.block_size).tolist()) for b in blocks]

    return [report(2), report(vdaf.max_blocks)], [report(2)]


def _dense_truth(vdaf, measurements) -> list:
    """The logical-length sum of block-sparse measurements."""
    want = [0] * vdaf.length
    for m in measurements:
        for blk, vals in m:
            for j, v in enumerate(vals):
                want[blk * vdaf.block_size + j] += v
    return want


def run_resident(
    wave_sizes: tuple = (3, 3, 4, 3),
    lease_ttl_s: int = 6,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
    sparse_vdaf=None,
) -> dict:
    """Resident aggregate state flush contract against the REAL driver
    binary with `resident_accumulators` enabled and a `resident_max_bytes`
    of exactly ONE Count slot (`count_slot_nbytes()`, 8 bytes).
    Deterministic schedule:

      1. two tasks (A, B) each land one job resident; task B's merge
         overflows the byte cap and LRU-evicts the oldest slot of its
         engine through the flush path (reason="eviction") — observed
         live. (An engine serves one task's verify key: the eviction
         walks B's engine, so it is B's slot that leaves.)
      2. task A's next job wedges on its device dispatch
         (engine.dispatch hang, after=4) → watchdog abandon past the
         `hang_after_secs` bound, inside the lease → quarantine; the
         flusher's quarantine sweep writes the quarantined engine's
         resident slot out (reason="quarantine") while the wedged job
         steps back (`device_hang`, then `device_quarantined` while the
         canary fails twice) and re-steps on the device after the
         restore;
      3. after the canary restores the device path, one more task-A
         job lands resident; SIGTERM drains it through the write-tx
         path (drain contract) and the final collections equal ALL
         tasks' admitted ground truths exactly — no share bytes lost
         across eviction, quarantine, or drain.

    A block-sparse sumvec task ("s", `sparse_vdaf`: janus_tpu's
    sparse_sumvec(3, 48, 4, 3) unless named) rides the same run: its
    first wave uploads inside the quarantine window (the sparse engine
    keeps dispatching while the count engine is quarantined), its
    logical slot always overflows the one-slot cap so every merge exits
    through the eviction flush, a second wave rides the restore->drain
    window, and its collection must equal the dense expansion of the
    admitted (block, values) pairs exactly — with the scatter row
    counter proving the scatter kernel carried the deltas.

    wave_sizes: (task A wave 1, task B wave 1, task A hang wave,
    task A drain wave). Every `*_ok` key must be True to pass."""
    from ..aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from ..binary_utils import warmup_engines
    from ..core.time_util import RealClock
    from ..vdaf.registry import VdafInstance

    device, tmp = _open_run(device, workdir, "janus-resident-")
    t_run0 = time.monotonic()
    clock = RealClock()
    pair = _Pair(tmp, device, clock)
    sparse_vdaf = sparse_vdaf or VdafInstance.sparse_sumvec(**DEFAULT_SPARSE)
    slot = cap = count_slot_nbytes()
    result: dict = {
        "workdir": tmp,
        "schedule": "resident_full" if full else "resident_smoke",
        "device": device,
        "hang_after_s": HANG_AFTER_S,
        "sparse_vdaf": sparse_vdaf.to_dict(),
        # the byte cap holds exactly one port Count slot: a second slot
        # anywhere in the process overflows it
        "lease_ttl_s": lease_ttl_s,
        "count_slot_nbytes": slot,
        "resident_max_bytes": cap,
        "cap_one_count_slot_ok": slot <= cap < 2 * slot,
    }
    procs: list[subprocess.Popen] = []
    try:
        pair.start()
        vdaf = VdafInstance.count()
        tasks = {}
        for name, cfg_id, task_vdaf in (("a", 210, vdaf), ("b", 211, vdaf), ("s", 212, sparse_vdaf)):
            leader_task, collector_kp, _ = pair.provision(cfg_id, 4, task_vdaf)
            tasks[name] = (leader_task, collector_kp, task_vdaf)
        # the in-process helper's engines, warm (the driver warms its own
        # at boot: `warmup_engines_at_boot` below)
        warmup_engines(pair.leader_ds, devices=[device])

        creator = AggregationJobCreator(
            pair.leader_ds,
            AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=100),
        )
        truth: dict = {"a": [], "b": [], "s": []}

        def upload(task_name: str, measurements) -> None:
            leader_task, _, task_vdaf = tasks[task_name]
            client = pair.client(leader_task, task_vdaf)
            for m in measurements:
                client.upload(m)
            truth[task_name].extend(measurements)
            creator.run_once()

        def flush_samples(mtext: str) -> dict:
            return _metric_samples(mtext, "janus_engine_resident_flushes_total")

        def wait_finished(n: int, deadline_s: float = 120.0) -> None:
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline and pair.finished_jobs() < n:
                time.sleep(0.05)

        # --- spawn the real driver: resident mode on, interval flush
        # effectively off (3600 s) so every flush observed below is an
        # EVICTION, QUARANTINE, or DRAIN flush — never the timer ------
        port = _free_port()
        cfg = _driver_cfg(
            os.path.join(tmp, "driver.yaml"), pair.leader_db, port, int(lease_ttl_s), 1.5, device,
            extra=(
                "resident_accumulators:\n"
                "  enabled: true\n"
                "  flush_interval_secs: 3600\n"
                "engine:\n"
                f"  resident_max_bytes: {cap}\n"  # exactly ONE count slot
                # every engine warm BEFORE the health listener: a cold
                # first dispatch must not race the hang bound mid-phase
                "warmup_engines_at_boot: true\n"
                + _watchdog_yaml(1.5)
            ),
        )
        log_path = os.path.join(tmp, "driver.log")
        drv = _spawn_driver(cfg, pair.key, log_path, RESIDENT_SCHEDULE)
        procs.append(drv)
        _wait_healthz(port)

        # --- phase 1: task A then task B land resident; B's merge
        # overflows the cap and evicts through the flush path ---------
        upload("a", [1, 0, 1][: wave_sizes[0]] or [1])
        wait_finished(1)
        upload("b", [1, 1, 0][: wave_sizes[1]] or [1])
        eviction_seen = False
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not eviction_seen:
            if pair.finished_jobs() >= 2:
                samples = flush_samples(_scrape(port, "/metrics"))
                eviction_seen = samples.get('outcome="flushed",reason="eviction"', 0) >= 1
            time.sleep(0.05)
        result["eviction_flush_ok"] = eviction_seen

        # --- phase 2: task A's next job wedges (hang armed after=4) ->
        # quarantine; the flusher sweep flushes the slot live ---------
        upload("a", [1, 1, 1, 0][: wave_sizes[2]] or [1])
        quarantined_seen = False
        quarantined_at = None
        quarantine_flush_seen = False
        wedge_started = None  # the hung dispatch's start (statusz age)
        step_back_at = None
        deadline = time.monotonic() + 180
        while time.monotonic() < deadline:
            try:
                mtext = _scrape(port, "/metrics")
                if wedge_started is None:
                    stalled = json.loads(_scrape(port, "/statusz")).get("device_watchdog", {}).get("stalled", [])
                    if stalled:
                        wedge_started = time.monotonic() - max(e.get("age_s", 0.0) for e in stalled)
            except Exception:
                time.sleep(0.1)
                continue
            backend = _metric_samples(mtext, "janus_engine_backend")
            if backend.get('state="quarantined",vdaf="count"') == 1.0 and not quarantined_seen:
                quarantined_seen = True
                quarantined_at = time.monotonic()
            if step_back_at is None and _label_sum(
                    _metric_samples(mtext, "janus_job_step_back_total"), "device_hang") >= 1:
                step_back_at = time.monotonic()
            samples = flush_samples(mtext)
            if samples.get('outcome="flushed",reason="quarantine"', 0) >= 1:
                quarantine_flush_seen = True
            if quarantine_flush_seen and step_back_at is not None:
                break
            time.sleep(0.05)
        result["quarantined_observed_ok"] = quarantined_seen
        result["quarantine_flush_ok"] = quarantine_flush_seen
        step_backs = _metric_samples(_scrape(port, "/metrics"), "janus_job_step_back_total")
        result["stepped_back_device_hang_ok"] = _label_sum(step_backs, "device_hang") >= 1
        # from the wedged dispatch's start to the device_hang step-back
        # seen on /metrics (the hang bound included; 0.05 s polls)
        result["wedge_to_step_back_s"] = (
            round(step_back_at - wedge_started, 3) if step_back_at and wedge_started else None
        )

        # --- sparse wave 1: uploaded inside the quarantine window (the
        # count engine is quarantined; the sparse engine dispatches on
        # its own device path). Its slot overflows the one-slot cap at
        # merge time, so the state exits through the EVICTION flush --
        sparse_wave_1, sparse_wave_2 = _sparse_waves(sparse_vdaf)
        pre_sparse_evictions = flush_samples(_scrape(port, "/metrics")).get(
            'outcome="flushed",reason="eviction"', 0
        )
        upload("s", sparse_wave_1)
        # task A's hang-wave job finishes only after the restore: the
        # sparse job is the third finished one
        wait_finished(3)

        # --- phase 3: canary restores the device path; one more job
        # lands resident and SIGTERM drains it ------------------------
        restored_at = None
        restore_deadline = time.monotonic() + 90
        while time.monotonic() < restore_deadline:
            backend = _metric_samples(_scrape(port, "/metrics"), "janus_engine_backend")
            if backend.get('state="device",vdaf="count"') == 1.0:
                restored_at = time.monotonic()
                break
            time.sleep(0.1)
        result["restored_ok"] = backend.get('state="device",vdaf="count"') == 1.0
        result["quarantine_to_restore_s"] = (
            round(restored_at - quarantined_at, 3) if restored_at and quarantined_at else None
        )
        # the wedged job re-steps on the device once restored
        wait_finished(4)
        # sparse wave 2 rides the restore->drain window; it merges (and
        # self-evicts through the flush path) BEFORE task A's final job
        # lands resident, so the drain contract below stays
        # deterministic
        upload("s", sparse_wave_2)
        wait_finished(5)
        upload("a", [0, 1, 1][: wave_sizes[3]] or [1])
        resident_before_drain = 0
        deadline = time.monotonic() + 120
        statusz: dict = {}
        while time.monotonic() < deadline:
            if pair.finished_jobs() >= 6:
                statusz = json.loads(_scrape(port, "/statusz"))
                ra = statusz.get("resident_accumulators", {})
                resident_before_drain = sum(e.get("buffers", 0) for e in ra.get("engines", []))
                if resident_before_drain >= 1:
                    result["statusz_resident_bytes"] = ra.get("total_bytes")
                    break
            time.sleep(0.05)
        result["resident_before_drain_ok"] = resident_before_drain >= 1
        proc_status = statusz.get("process", {})
        result["driver_devices"] = proc_status.get("devices")
        result["driver_device_name"] = proc_status.get("device_name")
        result["driver_device_memory"] = proc_status.get("device_memory")

        mtext = _scrape(port, "/metrics")
        samples = flush_samples(mtext)
        result["flush_samples"] = samples
        result["no_lost_flushes_ok"] = not any(
            'outcome="lost"' in k and v > 0 for k, v in samples.items()
        )
        # the sparse ride-along, judged cumulatively before the drain:
        # any eviction past the pre-sparse count is the sparse slot
        # exiting through the eviction path, and the scatter row counter
        # proves the scatter kernel (no dense or host detour) carried the
        # sparse deltas
        scatter_samples = _metric_samples(mtext, "janus_engine_scatter_rows_total")
        result["sparse_scatter_rows"] = sum(scatter_samples.values())
        result["sparse_scatter_observed_ok"] = scatter_samples.get('vdaf="sparse_sumvec"', 0) > 0
        result["sparse_eviction_flush_ok"] = (
            samples.get('outcome="flushed",reason="eviction"', 0) > pre_sparse_evictions
        )
        hd = _metric_samples(mtext, "janus_engine_hd_bytes_total")
        result["hd_bytes"] = hd
        result["hd_bytes_ok"] = _label_sum(hd, 'direction="h2d"') > 0
        result["step_backs"] = _metric_samples(mtext, "janus_job_step_back_total")

        # --- SIGTERM drain: the resident remainder flushes through the
        # write-tx path before exit (collection proves it landed) -----
        result["drain_rc"], result["drain_ok"] = _sigterm_drain(drv, log_path)

        # --- collect EVERY task and compare against ground truth -----
        with _collection_driver(pair.leader_ds):
            for name in ("a", "b", "s"):
                leader_task, collector_kp, task_vdaf = tasks[name]
                collected = _collector(pair.leader_srv.url, leader_task, collector_kp, task_vdaf).collect(
                    _window_query(leader_task, clock.now()), timeout_s=120.0
                )
                if name == "s":
                    # ground truth at the LOGICAL length
                    want = _dense_truth(sparse_vdaf, truth["s"])
                    got = list(collected.aggregate_result)
                else:
                    want = sum(truth[name])
                    got = collected.aggregate_result
                result[f"collected_count_{name}"] = collected.report_count
                result[f"exactly_once_{name}_ok"] = collected.report_count == len(truth[name]) and got == want
                result[f"admitted_{name}"] = len(truth[name])
                if name == "s":
                    # a logical vector may be a million long: its sum and
                    # nonzero count stand in the record
                    result["collected_sum_s"] = sum(got)
                    result["ground_truth_sum_s"] = sum(want)
                    result["ground_truth_nonzero_s"] = sum(1 for v in want if v)
                else:
                    result[f"collected_sum_{name}"] = got
                    result[f"ground_truth_sum_{name}"] = want
        return _finish(result, t_run0)
    finally:
        from .. import failpoints

        failpoints.clear()
        _stop_all(procs)
        pair.close()


def claim_roundtrip_stats(n_jobs: int = 32, batch: int = 16) -> dict:
    """Claim round-trips per job, measured not assumed: the batched
    claim transaction vs a reimplementation of the old per-row loop,
    both over the recorded-conversation pg_fake driver so every
    statement is counted exactly as it would hit the PG wire. The
    batched form issues ONE statement per claim transaction; the
    per-row loop issued 1 SELECT + K guarded UPDATEs."""
    from ..core.time_util import MockClock
    from ..datastore.models import AggregationJobModel, AggregationJobState
    from ..datastore.store import EphemeralDatastore
    from ..messages import AggregationJobId, Duration, Interval, Role, Time
    from ..task import QueryTypeConfig, TaskBuilder
    from ..vdaf.registry import VdafInstance

    def seeded_store():
        eph = EphemeralDatastore(clock=MockClock(Time(1_600_000_000)), engine="pgfake")
        ds = eph.datastore
        task = (
            TaskBuilder(QueryTypeConfig.time_interval(), VdafInstance.count(), Role.LEADER)
            .with_(min_batch_size=1)
            .build()
        )
        ds.run_tx(lambda tx: tx.put_task(task))

        def put_jobs(tx):
            for i in range(n_jobs):
                tx.put_aggregation_job(
                    AggregationJobModel(
                        task.task_id,
                        AggregationJobId(i.to_bytes(16, "big")),
                        b"",
                        b"\x01",
                        Interval(Time(1_600_000_000), Duration(1)),
                        AggregationJobState.IN_PROGRESS,
                        0,
                    )
                )

        ds.run_tx(put_jobs)
        return eph, ds

    def count_statements(eph, ds, claim_fn) -> tuple[int, int]:
        """(statements executed, jobs claimed) draining the store."""
        eph.pg_driver.clear_log()
        claimed = 0
        while True:
            got = ds.run_tx(lambda tx: claim_fn(tx))
            if not got:
                break
            claimed += len(got)
        return len(eph.pg_driver.statements("execute")), claimed

    def legacy_per_row(tx):
        """The per-row claim loop the batched claim replaced, kept here as
        the measurement oracle (one SELECT, then a guarded UPDATE ..
        RETURNING per candidate row)."""
        now = tx._clock.now().seconds
        rows = tx._c.execute(
            "SELECT task_id, job_id FROM aggregation_jobs"
            " WHERE state = 'in_progress' AND lease_expiry <= ?"
            " ORDER BY lease_expiry LIMIT ?" + tx._lease_suffix,
            (now, batch),
        ).fetchall()
        out = []
        for task_id, job_id in rows:
            token = secrets.token_bytes(16)
            cur = tx._c.execute(
                "UPDATE aggregation_jobs SET lease_expiry = ?, lease_token = ?,"
                " lease_attempts = lease_attempts + 1"
                " WHERE task_id = ? AND job_id = ? AND state = 'in_progress'"
                " AND lease_expiry <= ? RETURNING lease_attempts",
                (now + 600, token, task_id, job_id, now),
            ).fetchone()
            if cur is not None:
                out.append((task_id, job_id))
        return out

    eph, ds = seeded_store()
    try:
        batched_stmts, batched_claimed = count_statements(
            eph, ds, lambda tx: tx.acquire_incomplete_aggregation_jobs(Duration(600), batch)
        )
    finally:
        eph.cleanup()
    eph, ds = seeded_store()
    try:
        legacy_stmts, legacy_claimed = count_statements(eph, ds, legacy_per_row)
    finally:
        eph.cleanup()
    batched_per_job = batched_stmts / max(1, batched_claimed)
    legacy_per_job = legacy_stmts / max(1, legacy_claimed)
    return {
        "jobs": n_jobs,
        "claim_batch": batch,
        "batched_statements": batched_stmts,
        "batched_claimed": batched_claimed,
        "batched_stmts_per_job": round(batched_per_job, 3),
        "per_row_statements": legacy_stmts,
        "per_row_claimed": legacy_claimed,
        "per_row_stmts_per_job": round(legacy_per_job, 3),
        # THE acceptance comparison: claim round-trips per job,
        # batched vs the per-row loop (gate: measurably below)
        "roundtrip_ratio": round(legacy_per_job / max(1e-9, batched_per_job), 1),
        "claim_roundtrips_ok": (
            batched_claimed == n_jobs
            and legacy_claimed == n_jobs
            and batched_per_job < legacy_per_job / 2
        ),
    }


def _replica_snapshot(statusz: dict) -> dict:
    """What a fleet replica's /statusz says of its device: the device it
    serves on, its dispatches (device-cost table), the caching
    allocator's counts (`process.device_memory`, CUDA only) and each
    engine's bucket cap."""
    proc = statusz.get("process", {})
    return {
        "devices": proc.get("devices"),
        "device_name": proc.get("device_name"),
        "dispatches": sum(int(e.get("dispatches", 0)) for e in statusz.get("device_cost", {}).get("entries", [])),
        "device_memory": proc.get("device_memory"),
        "buckets": [
            {"vdaf": e.get("vdaf"), "bucket_cap": e.get("bucket_cap"), "initial_bucket_cap": e.get("initial_bucket_cap")}
            for e in statusz.get("engine_cache", {}).get("engines", [])
        ],
    }


def run_fleet(
    replicas: int = 4,
    jobs_per_replica: int = 24,
    job_size: int = 2,
    lease_ttl_s: int = 5,
    steal_after_s: int = 2,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Fleet-grade scale-out proof: N REAL aggregation-job-driver
    binaries — each with its own fleet identity and shard slice in its
    YAML's `fleet:` stanza — over ONE leader datastore, under RTT-bound
    load, every one on `device`. Phases:

      1. claim-efficiency: batched claim tx vs the old per-row loop,
         statements counted on the recorded PG wire (in-process);
      2. scaling curve: served rps with 1, 2 and 4 replicas (1 and 2 in
         the smoke), each phase its own driver set + fresh job wave —
         the `fleet_scaling` record;
      3. chaos: a fleet under load (4 replicas in the full schedule, 2 in
         the smoke) — SIGKILL one replica while it HOLDS leases (lease
         expires, survivors steal its shard after the delay, attempt
         accounting intact), SIGTERM-drain another (leases handed back
         immediately, rc 0), restart the killed replica and prove it
         serves a fresh wave;
      4. collection == admitted ground truth EXACTLY across every
         wave, zero lease-token conflicts on every scraped replica
         (no job double-stepped), and no job starves past
         ttl + steal + margin after the kill;
      5. an injected silent loss (`ledger.drop_report`) is a +1 ingest
         imbalance on the next ledger evaluation and turns the
         `conservation` SLO signal bad.

    The report-flow ledger (`ledger.install_ledger`, grace 0) checks the
    books close at every quiesce point. `replica_status` holds each
    replica's device, dispatches, allocator counts and bucket caps as
    its /statusz gave them before it was drained (the drained chaos
    replica once it has dispatched, waiting at most 10 s; the SIGKILLed
    victim is not read). Every `*_ok` key must be True to pass."""
    from .. import failpoints
    from .. import ledger as ledger_mod
    from ..aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from ..binary_utils import warmup_engines
    from ..core.time_util import RealClock
    from ..datastore.store import replica_holder_tag
    from ..metrics import task_id_label
    from ..slo import ConservationSignal

    device, tmp = _open_run(device, workdir, "janus-fleet-")
    t_run0 = time.monotonic()
    clock = RealClock()
    pair = _Pair(tmp, device, clock)
    result: dict = {
        "workdir": tmp,
        "schedule": "fleet_full" if full else "fleet_smoke",
        "device": device,
        "replicas": replicas,
    }
    procs: list[subprocess.Popen] = []
    replica_status: dict[str, dict] = {}
    # report-flow conservation gate: the ledger evaluates against the
    # shared leader store at every quiesce point — the books must close
    # (imbalance 0) after every wave, through the kill, the drain, the
    # steal and the restart. grace 0: a nonzero residual at a quiesce
    # point breaches immediately. The installed evaluator also powers
    # the in-process collection driver's cross-aggregator
    # reconciliation in phase 4.
    ledger_ev = ledger_mod.install_ledger(pair.leader_ds, ledger_mod.LedgerConfig(grace_s=0.0))
    conservation: dict[str, dict] = {}

    def conservation_check(tag: str) -> bool:
        doc = ledger_ev.evaluate_once()
        imb = {label: dict(t["imbalance"]) for label, t in doc.get("tasks", {}).items()}
        conservation[tag] = imb
        return bool(imb) and all(v.get("ingest") == 0 and v.get("collect") == 0 for v in imb.values())

    try:
        # --- phase 1: claim round-trips per job, measured ------------
        result["claim_stats"] = claim_roundtrip_stats()
        result["claim_roundtrips_ok"] = result["claim_stats"]["claim_roundtrips_ok"]

        pair.start()
        leader_task, collector_kp, vdaf = pair.provision(205, 5)
        warmup_engines(pair.leader_ds, batch=job_size, devices=[device])
        client = pair.client(leader_task, vdaf)
        creator = AggregationJobCreator(
            pair.leader_ds,
            AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=job_size),
        )
        measurements: list[int] = []
        finished_target = {"jobs": 0}

        def upload_wave(n_reports: int) -> int:
            wave = [(i % 3 != 0) * 1 for i in range(n_reports)]
            for m in wave:
                client.upload(m)
            measurements.extend(wave)
            return (n_reports + job_size - 1) // job_size

        def wait_finished(deadline_s: float) -> bool:
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                if pair.finished_jobs() >= finished_target["jobs"]:
                    return True
                time.sleep(0.05)
            return pair.finished_jobs() >= finished_target["jobs"]

        def spawn_replica(i: int, shard_count: int, tag: str):
            """One REAL driver binary with fleet identity replica-i of
            shard_count; `tag` keeps per-phase artifacts apart."""
            port = _free_port()
            cfg = _driver_cfg(
                os.path.join(tmp, f"driver-{tag}-{i}.yaml"), pair.leader_db, port, int(lease_ttl_s), 1.5, device,
                extra=(
                    "max_concurrent_job_workers: 4\n"
                    "fleet:\n"
                    f"  replica_id: replica-{i}\n"
                    f"  shard_count: {shard_count}\n"
                    f"  shard_index: {i}\n"
                    f"  steal_after_secs: {steal_after_s}\n"
                ),
            )
            drv = _spawn_driver(cfg, pair.key, os.path.join(tmp, f"driver-{tag}-{i}.log"), FLEET_RTT_SCHEDULE)
            procs.append(drv)
            return i, port, drv

        def snapshot(replica_set, tag: str) -> None:
            for i, port, drv in replica_set:
                if drv.poll() is None:
                    replica_status[f"{tag}-{i}"] = _replica_snapshot(json.loads(_scrape(port, "/statusz")))

        def drain(replica_set, expect_rc0: bool = True) -> bool:
            ok = True
            for _i, _port, drv in replica_set:
                if drv.poll() is None:
                    drv.send_signal(signal.SIGTERM)
            for _i, _port, drv in replica_set:
                try:
                    rc = drv.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    drv.kill()
                    rc = None
                ok = ok and (rc == 0 or not expect_rc0)
            return ok

        # --- phase 2: served-rps scaling curve -----------------------
        phase_counts = (1, 2, 4) if full else (1, 2)
        rps: dict[int, float] = {}
        for n in phase_counts:
            fleet = [spawn_replica(i, n, f"scale{n}") for i in range(n)]
            for _i, port, _drv in fleet:
                _wait_healthz(port)
            jobs = upload_wave(jobs_per_replica * n * job_size)
            finished_target["jobs"] += jobs
            t0 = time.monotonic()
            creator.run_once()
            done = wait_finished(120)
            elapsed = time.monotonic() - t0
            result[f"scale_{n}_done_ok"] = done
            rps[n] = (jobs_per_replica * n * job_size) / max(1e-9, elapsed)
            snapshot(fleet, f"scale{n}")
            result[f"drain_scale_{n}_ok"] = drain(fleet)
            # quiesce point: the wave is finished and the replicas are
            # drained — every admitted report must be accounted for
            result[f"conservation_scale_{n}_ok"] = conservation_check(f"scale_{n}")
        n_max = max(phase_counts)
        result["fleet_scaling"] = {
            "replica_counts": list(phase_counts),
            "served_rps": {str(n): round(rps[n], 1) for n in phase_counts},
            "speedup_max_vs_1": round(rps[n_max] / max(1e-9, rps[1]), 2),
            "scaling_efficiency": round(rps[n_max] / max(1e-9, rps[1]) / n_max, 2),
            "claim_stats": result["claim_stats"],
        }
        # RTT-bound work must scale meaningfully with replica count
        # (full 1->4: >= 1.8x; smoke 1->2: >= 1.2x) — the record carries
        # the real efficiency number either way
        gate = 1.8 if full else 1.2
        result["scaling_gate"] = gate
        result["scaling_ok"] = result["fleet_scaling"]["speedup_max_vs_1"] >= gate

        # --- phase 3: kill / drain / restart under load --------------
        chaos_n = replicas if full else 2
        fleet = [spawn_replica(i, chaos_n, "chaos") for i in range(chaos_n)]
        by_idx = {i: (i, port, drv) for i, port, drv in fleet}
        for _i, port, _drv in fleet:
            _wait_healthz(port)
        jobs = upload_wave(jobs_per_replica * chaos_n * job_size)
        finished_target["jobs"] += jobs
        creator.run_once()

        # wait until the victim (replica 0) HOLDS a lease mid-step,
        # proven by the provenance tag on the held row. If a wave
        # drains before the poll catches it (a fast machine, not a
        # product defect), upload ANOTHER wave and keep looking — the
        # kill must be provably mid-step, never a guess.
        victim_tag = replica_holder_tag("replica-0").hex()
        tags = {replica_holder_tag(f"replica-{i}").hex(): i for i in range(chaos_n)}
        victim_holding = False
        seen_holder_tags: set = set()
        for _attempt in range(4):
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                holders = pair.leader_ds.run_tx(lambda tx: tx.get_lease_holders(), "fleet_monitor")
                seen_holder_tags.update(h[3] for h in holders)
                if any(h[3] == victim_tag for h in holders):
                    victim_holding = True
                    break
                if pair.finished_jobs() >= finished_target["jobs"]:
                    break  # wave drained before we caught the victim
                time.sleep(0.01)
            if victim_holding:
                break
            finished_target["jobs"] += upload_wave(jobs_per_replica * chaos_n * job_size)
            creator.run_once()
        result["victim_held_lease_ok"] = victim_holding
        result["holder_tags_are_replica_tags_ok"] = bool(seen_holder_tags) and all(
            t in tags for t in seen_holder_tags
        )

        # SIGKILL the victim MID-STEP: nothing releases its leases —
        # they must expire and drain through TTL + steal-after
        _, _victim_port, victim = by_idx[0]
        victim.send_signal(signal.SIGKILL)
        t_kill = time.monotonic()
        result["victim_killed_rc"] = victim.wait(timeout=30)
        result["victim_sigkill_ok"] = result["victim_killed_rc"] == -signal.SIGKILL

        # SIGTERM-drain another replica: clean rc 0, leases handed back.
        # Its /statusz is read first, once it has dispatched (waiting at
        # most 10 s), so the record shows the device it served on
        drain_idx = 1
        t_wait = time.monotonic()
        while True:
            st = _replica_snapshot(json.loads(_scrape(by_idx[drain_idx][1], "/statusz")))
            if st["dispatches"] >= 1 or time.monotonic() - t_wait > 10:
                break
            time.sleep(0.05)
        replica_status[f"chaos-{drain_idx}"] = st
        result["drain_waited_s"] = round(time.monotonic() - t_wait, 3)
        result["drain_mid_load_ok"] = drain([by_idx[drain_idx]])

        # survivors (or nobody, in the 2-replica smoke: the restarted
        # victim) must finish the wave; no job starves past the bound
        survivors = [by_idx[i] for i in range(chaos_n) if i not in (0, drain_idx)]

        # restart the killed replica (same identity + shard)
        restarted = spawn_replica(0, chaos_n, "restart")
        _wait_healthz(restarted[1])
        result["restart_boot_ok"] = True
        survivors.append(restarted)

        starvation_bound_s = lease_ttl_s + steal_after_s + 45
        done = wait_finished(starvation_bound_s)
        result["chaos_wave_done_ok"] = done
        result["post_kill_drain_s"] = round(time.monotonic() - t_kill, 1)
        result["no_starvation_ok"] = done and result["post_kill_drain_s"] <= starvation_bound_s

        # a fresh wave lands with the restarted replica participating
        jobs = upload_wave(jobs_per_replica * job_size)
        finished_target["jobs"] += jobs
        creator.run_once()
        result["restart_wave_done_ok"] = wait_finished(60)

        # fleet observability on every live replica: replica_info
        # carries the configured identity, the batched claim metrics
        # are live, and the lease-conflict counter reads ZERO — no job
        # was ever double-stepped
        conflicts = acquired_jobs = claim_txs = steals = 0.0
        replica_info_ok = True
        mesh_statusz_ok = True
        for i, port, _drv in survivors:
            mtext = _scrape(port, "/metrics")
            info = _metric_samples(mtext, "janus_replica_info")
            want = f'replica_id="replica-{i}"'
            if not any(want in k and v == 1.0 for k, v in info.items()):
                replica_info_ok = False
            conflicts += sum(_metric_samples(mtext, "janus_lease_conflicts_total").values())
            acquired_jobs += sum(_metric_samples(mtext, "janus_lease_acquired_jobs_total").values())
            claim_txs += _label_sum(_metric_samples(mtext, "janus_lease_acquire_tx_total"), 'outcome="claimed"')
            steals += sum(_metric_samples(mtext, "janus_lease_steals_total").values())
            statusz = json.loads(_scrape(port, "/statusz"))
            if statusz.get("fleet", {}).get("replica_id") != f"replica-{i}":
                replica_info_ok = False
            # every replica — including the restart that replaced the
            # killed one — must publish the mesh dispatch section (the
            # lane is per-process state)
            mesh = statusz.get("mesh")
            if not (isinstance(mesh, dict) and isinstance(mesh.get("queue"), dict)):
                mesh_statusz_ok = False
            replica_status[f"survivor-{i}"] = _replica_snapshot(statusz)
        result["replica_info_ok"] = replica_info_ok
        result["mesh_statusz_ok"] = mesh_statusz_ok
        result["lease_conflicts_total"] = conflicts
        result["zero_lease_conflicts_ok"] = conflicts == 0.0
        result["fleet_acquired_jobs"] = acquired_jobs
        result["fleet_claim_txs"] = claim_txs
        result["batched_claims_ok"] = claim_txs > 0 and acquired_jobs / max(1.0, claim_txs) > 1.0
        result["lease_steals"] = steals
        result["steals_observed_ok"] = steals >= 1.0  # the dead shard drained
        result["replica_status"] = replica_status

        result["drain_final_ok"] = drain(survivors)
        # quiesce point: kill + drain + steal + restart are behind us
        # and every wave is finished — the books must still close
        result["conservation_chaos_ok"] = conservation_check("chaos")

        # --- phase 4: collect EVERYTHING vs ground truth -------------
        result["admitted"] = len(measurements)
        result["ground_truth_sum"] = sum(measurements)
        # every admitted report exactly once across kill, drain, steal,
        # and restart — no loss, no double
        result.update(pair.collect_exact(leader_task, collector_kp, vdaf, measurements, timeout_s=180.0))

        # quiesce point: post-collection BOTH stages must close —
        # ingest (admitted == aggregated) and collect (aggregated ==
        # collected, nothing left awaiting)
        result["conservation_collected_ok"] = conservation_check("collected")
        result["conservation"] = conservation
        # the cross-aggregator reconciliation ran inside the collection
        # driver's step: on this clean lane the per-batch counts must
        # AGREE — divergence 0
        label = task_id_label(leader_task.task_id.data)
        peer = ledger_ev.document().get("tasks", {}).get(label, {}).get("peer")
        result["peer_reconciliation"] = peer
        result["peer_reconciled_ok"] = peer is not None and peer.get("divergence") == 0

        # --- phase 5: injected-loss lane -----------------------------
        # the ledger.drop_report failpoint silently deletes ONE admitted
        # report AFTER its admission tx counted it — the tamper no
        # throughput metric can see. The next ledger evaluation must
        # book a +1 ingest imbalance, breach immediately (grace 0), and
        # turn the `conservation` SLO signal bad.
        class _SigState:
            _condition_state: dict = {}

        sig_engine = _SigState()
        sig = ConservationSignal()
        slo_bad_before, _, _ = sig.read(sig_engine)
        failpoints.configure("ledger.drop_report=error:1.0,count=1")
        try:
            client.upload(1)
        finally:
            failpoints.clear()
        loss_doc = ledger_ev.evaluate_once()
        loss_imb = loss_doc.get("tasks", {}).get(label, {}).get("imbalance", {})
        slo_bad_after, _, _ = sig.read(sig_engine)
        result["loss_injected_imbalance"] = loss_imb.get("ingest")
        result["loss_breaches"] = list(loss_doc.get("breaches", []))
        result["loss_detected_ok"] = (
            loss_imb.get("ingest") == 1
            and any(s.endswith("/ingest") for s in loss_doc.get("breaches", []))
            and slo_bad_after > slo_bad_before
        )
        return _finish(result, t_run0)
    finally:
        failpoints.clear()
        ledger_mod.uninstall_ledger()
        _stop_all(procs)
        pair.close()


def run_soak(
    epochs: int = 4,
    reports_per_epoch: int = 8,
    job_size: int = 4,
    report_expiry_s: float = 30.0,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Endurance soak: sustained open-loop load with TIME-INTERVAL TASK
    CHURN and GC actually deleting collected rows, judged by the flight
    recorder's trend verdicts instead of a single end-state snapshot.

      - one epoch = a fresh time-interval task (short report_expiry_age)
        + an upload wave with known ground truth + aggregation by two
        REAL driver binaries + an EXACT collection of that epoch + a GC
        pass (old epochs' rows are expired by then and really deleted);
      - driver A runs clean: its /debug/flight analysis must call
        rss_bytes and datastore_rows FLAT over the trailing window (no
        leak-gated series leaking), p99 families stable, recorder
        self-overhead <= 1%, ring inside its byte budget, statusz
        `flight` section fresh;
      - driver B runs with the flight.synthetic_leak failpoint armed:
        the injected leak must flip janus_flight_leak_active, land the
        series in analysis.leaking, and fire the resource_trend SLO
        alert on /alertz within the window_scale-shrunk ladder.

    Both schedules run on SQLite (`engine: "sqlite"` in the record): the
    port reads no JANUS_TEST_DATABASE_URL. The smoke's drivers sample
    health every 0.02 s, not janus_tpu's 0.5 s, so that each half of the
    p99 window holds about two thousand transactions (the record's
    `p99_windows`): at 0.5 s each half held about 100, its p99 was the
    second-largest, and one slow read on a shared host moved it a bucket;
    at 0.05 s (about 900 a half) a burst of nine slow reads still did.
    The verdict itself is janus_tpu's. The report-flow ledger checks the
    books close at every epoch. Every `*_ok` key must be True to pass."""
    from .. import ledger as ledger_mod
    from ..aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from ..aggregator.garbage_collector import GarbageCollector
    from ..binary_utils import warmup_engines
    from ..core.time_util import RealClock
    from ..messages import Duration, Interval, Query, Time

    device, tmp = _open_run(device, workdir, "janus-soak-")
    t_run0 = time.monotonic()
    clock = RealClock()
    pair = _Pair(tmp, device, clock)

    # flight/SLO cadences: production-shaped in the full run, shrunk to
    # tier-1 seconds in the smoke (window_scale turns the 1h/5m page
    # ladder into 36s/3s — the injected leak fires the trend page in
    # seconds instead of an hour)
    flight_interval_s = 2.0 if full else 0.5
    # a TRAILING window: long enough for robust slopes, short enough
    # that by verdict time it covers steady state instead of the boot
    # ramp (a window spanning the whole run would honestly — and
    # uselessly — report "rows grew" for the fill phase)
    flight_window_s = 600.0 if full else 15.0
    window_scale = 0.1 if full else 0.01
    # the health sampler's six reads are most of an idle driver's
    # transactions, so its cadence sets how many observations each half
    # of the p99 window holds: janus_tpu's 0.5 s gives about 100 a half
    # in the smoke's 15 s window, where the p99 is the second-largest
    # and one slow read on a shared host moves it; 0.05 s gives about
    # 900 (its p99 the ninth-largest, still moved by a burst on a loaded
    # host), 0.02 s about 2,200. The full schedule's 600 s window holds
    # thousands at 0.5 s
    health_interval_s = 0.5 if full else 0.02

    def soak_extra(flight_dir: str) -> str:
        return (
            "max_concurrent_job_workers: 4\n"
            f"health_sampler_interval_secs: {health_interval_s}\n"
            "flight:\n"
            f"  dir: {flight_dir}\n"
            f"  interval_secs: {flight_interval_s}\n"
            "  analyze_every: 3\n"
            f"  window_secs: {flight_window_s}\n"
            "  min_points: 10\n"
            "  rollup_secs: [2, 10]\n"
            "  max_segment_bytes: 65536\n"
            "  max_total_bytes: 262144\n"
            "  latency_families: [janus_database_transaction_duration_seconds]\n"
            "slo:\n"
            "  evaluation_interval_secs: 0.25\n"
            f"  window_scale: {window_scale}\n"
        )

    result: dict = {
        "workdir": tmp,
        "schedule": "soak_full" if full else "soak_smoke",
        "device": device,
        "engine": "sqlite",
        "epochs": epochs,
        "reports_per_epoch": reports_per_epoch,
        "health_sampler_interval_s": health_interval_s,
    }
    procs: list[subprocess.Popen] = []
    # continuous conservation gate: the books must close at EVERY epoch
    # quiesce point — through task churn, GC really deleting expired
    # rows (expiry attribution keeps the equation balanced), and
    # continuous collection. grace 0: any residual at a quiesce point is
    # an immediate breach. The installed evaluator also powers the
    # collect loop's cross-aggregator reconciliation.
    ledger_ev = ledger_mod.install_ledger(pair.leader_ds, ledger_mod.LedgerConfig(grace_s=0.0))
    conservation_by_epoch: list[dict] = []

    def conservation_check() -> bool:
        doc = ledger_ev.evaluate_once()
        imb = {label: dict(t["imbalance"]) for label, t in doc.get("tasks", {}).items()}
        conservation_by_epoch.append(imb)
        return bool(imb) and all(v.get("ingest") == 0 and v.get("collect") == 0 for v in imb.values())

    try:
        pair.start()

        def provision_epoch_task(e: int):
            """Task churn: each epoch gets its OWN time-interval task with
            a short report_expiry_age, so by the time later epochs run,
            earlier epochs' collected rows are expired and GC has real
            rows to delete."""
            leader_task, collector_kp, _ = pair.provision(
                100 + (e % 100), 5,
                # a fine time precision keeps the report-timestamp
                # round-down well inside the short expiry window (the
                # default 1h precision would round every report to
                # "already expired")
                time_precision=Duration(5),
                report_expiry_age=Duration(int(report_expiry_s)),
            )
            return leader_task, collector_kp

        # epoch 0 before boot, so the in-process helper's engine is warm
        epoch_tasks = [provision_epoch_task(0)]
        warmup_engines(pair.leader_ds, batch=job_size, devices=[device])

        flight_dirs = {"A": os.path.join(tmp, "flight-A"), "B": os.path.join(tmp, "flight-B")}
        ports: dict[str, int] = {}
        drivers: list[tuple] = []
        for tag, armed in (("A", None), ("B", "flight.synthetic_leak=error:1.0")):
            port = _free_port()
            ports[tag] = port
            cfg = _driver_cfg(
                os.path.join(tmp, f"driver-{tag}.yaml"), pair.leader_db, port, 8, 1.5, device,
                extra=soak_extra(flight_dirs[tag]),
            )
            log_path = os.path.join(tmp, f"driver-{tag}.log")
            drv = _spawn_driver(cfg, pair.key, log_path, armed)
            procs.append(drv)
            drivers.append((drv, log_path))
        for port in ports.values():
            _wait_healthz(port)

        creator = AggregationJobCreator(
            pair.leader_ds,
            AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=job_size),
        )
        gc_leader = GarbageCollector(pair.leader_ds, clock)
        gc_helper = GarbageCollector(pair.helper_ds, clock)
        vdaf = None

        def aggregation_idle(deadline_s: float) -> bool:
            """Wait until no aggregation job is in a non-finished state
            (GC-deleted jobs simply vanish from the counts)."""
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                if all(s == "finished" for s, n in pair.agg_jobs_by_state().items() if n):
                    return True
                time.sleep(0.1)
            return False

        gc_deleted_total = 0
        epochs_exact: list[bool] = []
        epoch_details = []
        rows_by_epoch = []
        epochs_balanced: list[bool] = []
        # the collection-job driver (the leader side of collect), in the
        # background across every epoch
        with _collection_driver(pair.leader_ds):
            for e in range(epochs):
                if e >= len(epoch_tasks):
                    epoch_tasks.append(provision_epoch_task(e))
                leader_task, collector_kp = epoch_tasks[e]
                vdaf = leader_task.vdaf
                client = pair.client(leader_task, vdaf)
                t_epoch = clock.now()
                wave = [(i % 3 != 0) * 1 for i in range(reports_per_epoch)]
                for m in wave:
                    client.upload(m)
                creator.run_once()
                # the drivers must finish this epoch's jobs before the
                # collect — a collection issued mid-aggregation honestly
                # reports only the shares aggregated so far
                aggregation_idle(90.0)
                # collection == admitted ground truth, CONTINUOUSLY. The
                # batch interval anchors at the epoch's UPLOAD time — the
                # fine precision means "now" at collect time can be
                # several batch units past the wave.
                tp = leader_task.time_precision
                start = t_epoch.to_batch_interval_start(tp)
                query = Query.time_interval(Interval(Time(start.seconds - tp.seconds), Duration(6 * tp.seconds)))
                collected = _collector(pair.leader_srv.url, leader_task, collector_kp, vdaf).collect(
                    query, timeout_s=120.0
                )
                exact = collected.report_count == len(wave) and collected.aggregate_result == sum(wave)
                epochs_exact.append(exact)
                epoch_details.append({
                    "admitted": len(wave),
                    "sum": sum(wave),
                    "collected_count": collected.report_count,
                    "collected_sum": collected.aggregate_result,
                })
                # GC pass after every epoch: earlier epochs' rows age past
                # report_expiry_age mid-run and must REALLY vanish
                deleted = gc_leader.run_once()
                gc_helper.run_once()
                gc_deleted_total += sum(deleted.values())
                rows_by_epoch.append(
                    sum(pair.leader_ds.run_tx(lambda tx: tx.count_table_rows(), "soak_monitor").values())
                )
                # epoch quiesce point: the epoch is collected and GC has
                # run — every task's books (including earlier, partially
                # GC'd epochs) must close
                epochs_balanced.append(conservation_check())

        result["epochs_exact"] = epochs_exact
        result["epoch_details"] = epoch_details
        result["epochs_exact_ok"] = bool(epochs_exact) and all(epochs_exact)
        result["leader_rows_by_epoch"] = rows_by_epoch

        # keep GC pressure on until expiry has provably deleted rows
        # (the last epochs' reports only expire after the loop)
        gc_deadline = time.monotonic() + (60 if full else 30)
        while gc_deleted_total == 0 and time.monotonic() < gc_deadline:
            time.sleep(1.0)
            gc_deleted_total += sum(gc_leader.run_once().values())
            gc_helper.run_once()
        result["gc_deleted_rows"] = gc_deleted_total
        result["gc_deleted_ok"] = gc_deleted_total > 0

        # final quiesce: even after the late GC passes expired the last
        # epochs' rows, every epoch's books still close — expiry is an
        # ATTRIBUTED terminal, not silent row loss
        final_balanced = conservation_check()
        result["conservation_by_epoch"] = conservation_by_epoch
        result["conservation_ok"] = bool(epochs_balanced) and all(epochs_balanced) and final_balanced

        # --- verdict phase: the drivers idle on steady state while the
        # recorder's trailing window sheds the boot/ramp-up slope ------
        def flight_doc(tag: str, window_s: float | None = None) -> dict:
            q = f"?window_secs={window_s:g}" if window_s else ""
            return json.loads(_scrape(ports[tag], f"/debug/flight{q}"))

        def settled_flat(doc: dict) -> bool:
            sv = doc.get("analysis", {}).get("series", {})
            return all(sv.get(n, {}).get("verdict") == "flat" for n in ("rss_bytes", "datastore_rows")) and not (
                doc.get("analysis", {}).get("leaking")
            )

        judge_window_s = 6 * flight_interval_s + 2.0  # >= min_points span
        deadline = time.monotonic() + (120 if full else 45)
        fa: dict = {}
        while time.monotonic() < deadline:
            fa = flight_doc("A", judge_window_s)
            # settle poll: the first trailing windows still straddle the
            # final epoch's churn; the steady-state question is whether
            # the series SETTLE to flat, not the first verdict computed
            if settled_flat(fa):
                break
            time.sleep(1.0)
        series_a = fa.get("analysis", {}).get("series", {})
        result["flight_a_verdicts"] = {n: d.get("verdict") for n, d in series_a.items()}
        result["flight_a_slopes"] = {n: d.get("slope_per_s") for n, d in series_a.items()}
        # THE soak invariant: sustained load + churn + GC leaves the
        # leak-gated resource series FLAT over the trailing window
        result["zero_slope_ok"] = settled_flat(fa)
        # p99 window-vs-window over the FULL recorder window (the judge
        # window has too few txs per half for a stable quantile)
        latency_a = flight_doc("A").get("analysis", {}).get("latency", {})
        result["p99_verdicts"] = {f: d.get("verdict") for f, d in latency_a.items()}
        result["p99_windows"] = latency_a
        result["p99_stable_ok"] = all(d.get("verdict") != "degraded" for d in latency_a.values())
        result["recorder_overhead_ratio"] = fa.get("overhead_ratio")
        result["overhead_ok"] = fa.get("overhead_ratio") is not None and fa["overhead_ratio"] <= 0.01
        ring = fa.get("ring") or {}
        result["ring"] = ring
        result["ring_budget_ok"] = ring.get("segments", 0) >= 1 and ring.get("bytes", 1 << 60) <= 262144
        statusz = json.loads(_scrape(ports["A"], "/statusz"))
        fl = statusz.get("flight", {})
        age = fl.get("last_snapshot_age_s")
        result["statusz_flight_fresh_ok"] = (
            fl.get("enabled") is True
            and fl.get("running") is True
            and age is not None
            and age <= 3 * flight_interval_s + 2.0
        )
        result["driver_devices"] = statusz.get("process", {}).get("devices")
        # the gauge follows the PERIODIC analysis over the full window;
        # right after the last epoch that window can still contain the
        # fill ramp — the clean-driver claim is that it settles to zero
        no_leak = False
        settle_deadline = time.monotonic() + (60 if full else 30)
        while time.monotonic() < settle_deadline:
            leak_a = _metric_samples(_scrape(ports["A"], "/metrics"), "janus_flight_leak_active")
            no_leak = sum(leak_a.values()) == 0.0
            if no_leak:
                break
            time.sleep(1.0)
        result["clean_driver_no_leak_ok"] = no_leak

        # --- injected-leak negative control: driver B ----------------
        leak_seen = alert_fired = False
        deadline = time.monotonic() + (120 if full else 45)
        fb: dict = {}
        while time.monotonic() < deadline:
            fb = flight_doc("B")
            leak_seen = "synthetic_leak_bytes" in (fb.get("analysis", {}).get("leaking") or [])
            if leak_seen:
                alertz = json.loads(_scrape(ports["B"], "/alertz"))
                alert_fired = any(f.startswith("resource_trend/") for f in alertz.get("firing", []))
                if alert_fired:
                    break
            time.sleep(0.5)
        result["leak_detected_ok"] = leak_seen
        result["trend_alert_fired_ok"] = alert_fired
        leak_b = _metric_samples(_scrape(ports["B"], "/metrics"), "janus_flight_leak_active")
        result["leak_gauge_ok"] = any(
            'series="synthetic_leak_bytes"' in k and v == 1.0 for k, v in leak_b.items()
        )
        result["flight_b_leaking"] = fb.get("analysis", {}).get("leaking")

        # drain both drivers cleanly
        for drv, _log in drivers:
            drv.send_signal(signal.SIGTERM)
        drain_ok = True
        for drv, _log in drivers:
            try:
                rc = drv.wait(timeout=60)
            except subprocess.TimeoutExpired:
                drv.kill()
                rc = None
            drain_ok = drain_ok and rc == 0
        result["drain_ok"] = drain_ok
        return _finish(result, t_run0)
    finally:
        _stop_all(procs)
        ledger_mod.uninstall_ledger()
        pair.close()


def run_peer_outage(
    n_reports: int = 4,
    lease_ttl_s: int = 8,
    breaker_cooldown_s: float = 1.5,
    full: bool = False,
    workdir: str | None = None,
    device: str = "cuda",
) -> dict:
    """Peer-outage survival schedule: the REAL aggregation + collection
    job driver binaries reach the in-process helper only through a
    core/netsim.py FaultProxy, and the wire is degraded toxiproxy-style.
    Invariants:

      - clean baseline traffic flows through the proxy and aggregates
        exactly;
      - a full blackhole longer than the breaker-open threshold keeps
        uploads at 201 (the leader is untouched) while BOTH driver
        binaries open their breakers, step back (`reason="circuit_open"`,
        bounded), then PARK: claim transactions stop cold
        (`janus_lease_acquire_tx_total` frozen), `janus_peer_parked` = 1,
        `janus_peer_outage_seconds_total` grows, `/statusz` grows a
        `peer_health` section, and `janus_lease_conflicts_total` stays 0;
      - when the wire heals, the cheap half-open probe
        (`janus_peer_probes_total{outcome="alive"}`) closes the breaker,
        both drivers resume, and the parked work drains;
      - a slow-drip (slicer) response trips the wall-clock body budget and
        a mid-request truncation retries as a torn connection — neither
        wedges a worker, both lanes complete;
      - (full schedule) latency+jitter and flaky mid-request reset lanes
        also complete;
      - the final collections equal the admitted ground truth EXACTLY and
        both binaries SIGTERM-drain cleanly.

    Every `*_ok` key must be True for the run to pass."""
    import threading
    from urllib.parse import urlsplit

    from ..aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from ..binary_utils import warmup_engines
    from ..core.netsim import FaultProxy
    from ..core.time_util import RealClock
    from ..messages import Duration, Interval, Query, Time

    device, tmp = _open_run(device, workdir, "janus-peerout-")
    t_run0 = time.monotonic()
    clock = RealClock()
    pair = _Pair(tmp, device, clock)
    result: dict = {
        "workdir": tmp,
        "schedule": "peer_outage_full" if full else "peer_outage_smoke",
        "device": device,
    }
    procs: list[subprocess.Popen] = []
    proxy = None
    try:
        pair.start()
        # the hostile wire: driver traffic to the helper crosses this
        # proxy (the task's helper endpoint below points at it); client
        # + collector traffic goes direct so proxy stats are driver-only
        hhost, hport = urlsplit(pair.helper_srv.url).netloc.split(":")
        proxy = FaultProxy(hhost, int(hport)).start()
        leader_task, collector_kp, vdaf = pair.provision(
            202, 3, helper_url=proxy.url,
            # small buckets so the waves before and after the blackhole
            # land in disjoint batch intervals and the two collections
            # partition the ground truth exactly
            time_precision=Duration(2),
        )
        # one warm engine serves the in-process leader and helper: the
        # drivers run with a tight per-attempt timeout, so the helper
        # must not pay a cold first init on the first proxied request
        warmup_engines(pair.leader_ds, devices=[device])

        # tight split so the schedule's clock stays short: 2 s attempts
        # against an 8 s lease, breaker opens after 3 failures, 1.5 s
        # cooldown, prober every 0.5 s
        extra = (
            "peer_health:\n"
            "  probe_interval_secs: 0.5\n"
            "  probe_timeout_secs: 1.0\n"
            "helper_http:\n"
            "  attempt_timeout_secs: 2.0\n"
            "  body_budget_secs: 2.0\n"
            "  max_response_mb: 8\n"
        )
        ttl = int(lease_ttl_s)
        drivers = []
        for name, module in (("agg_driver", "janus_tpu_torch.bin.aggregation_job_driver"),
                             ("collect_driver", "janus_tpu_torch.bin.collection_job_driver")):
            port = _free_port()
            cfg = _driver_cfg(os.path.join(tmp, f"{name}.yaml"), pair.leader_db, port, ttl, breaker_cooldown_s,
                              device, extra=extra)
            log_path = os.path.join(tmp, f"{name}.log")
            drv = _spawn_driver(cfg, pair.key, log_path, None, module=module)
            procs.append(drv)
            drivers.append((drv, port, log_path))
        ports = tuple(port for _drv, port, _log in drivers)
        for port in ports:
            _wait_healthz(port)
        port_a = ports[0]

        client = pair.client(leader_task, vdaf)
        creator = AggregationJobCreator(
            pair.leader_ds,
            AggregationJobCreatorConfig(min_aggregation_job_size=1, max_aggregation_job_size=100),
        )
        acked: list[int] = []
        upload_errors: list[str] = []

        def upload_wave(measurements) -> None:
            for m in measurements:
                try:
                    client.upload(m)
                    acked.append(m)
                except Exception as e:
                    upload_errors.append(f"{type(e).__name__}: {e}")

        def wait_agg_done(deadline_s: float) -> bool:
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                st = pair.agg_jobs_by_state()
                if st and st.get("in_progress", 0) == 0:
                    return True
                time.sleep(0.1)
            return False

        def family_sum(port: int, name: str) -> float:
            return sum(_metric_samples(_scrape(port, "/metrics"), name).values())

        def circuit_open_backs(port: int) -> float:
            return _label_sum(_metric_samples(_scrape(port, "/metrics"), "janus_job_step_back_total"), "circuit_open")

        def parked_value(port: int) -> float:
            samples = _metric_samples(_scrape(port, "/metrics"), "janus_peer_parked")
            return max(samples.values()) if samples else 0.0

        def wait_parked(value: float, deadline_s: float) -> bool:
            deadline = time.monotonic() + deadline_s
            while time.monotonic() < deadline:
                if all(parked_value(p) == value for p in ports):
                    return True
                time.sleep(0.2)
            return False

        tp = leader_task.time_precision

        def bucket_now() -> int:
            return clock.now().to_batch_interval_start(tp).seconds

        def cross_bucket_boundary() -> int:
            """Sleep into a FRESH bucket; returns its start. Everything
            uploaded before the call stays strictly below it."""
            last = bucket_now()
            while bucket_now() <= last:
                time.sleep(0.1)
            return bucket_now()

        # --- phase 1: clean baseline through the proxy ----------------
        interval_start = bucket_now()
        upload_wave([(i % 3 != 0) * 1 for i in range(n_reports)])
        wave_a_count, wave_a_sum = len(acked), sum(acked)
        creator.run_once()
        result["baseline_agg_ok"] = wait_agg_done(120)
        result["proxy_connections_baseline"] = proxy.stats["connections_total"]
        result["proxied_baseline_ok"] = proxy.stats["connections_total"] >= 1
        boundary = cross_bucket_boundary()

        # --- phase 2: blackhole past the breaker-open threshold -------
        proxy.set_toxics("up", [{"kind": "blackhole"}])
        proxy.set_toxics("down", [{"kind": "blackhole"}])
        # uploads only touch the leader: they must keep acking 201
        upload_wave([1] * 3)
        result["uploads_during_blackhole_ok"] = not upload_errors
        creator.run_once()  # the agg driver now steps into the blackhole
        # a mid-outage collection over the BASELINE interval drives the
        # collection binary into the blackhole too (wave A is already
        # aggregated, so its step reaches the helper dial)
        collector = _collector(pair.leader_srv.url, leader_task, collector_kp, vdaf)
        q1 = Query.time_interval(Interval(Time(interval_start), Duration(boundary - interval_start)))
        collect1: dict = {}

        def collect1_loop():
            try:
                c = collector.collect(q1, timeout_s=240.0)
                collect1["count"] = c.report_count
                collect1["sum"] = c.aggregate_result
            except Exception as e:
                collect1["error"] = f"{type(e).__name__}: {e}"

        c1t = threading.Thread(target=collect1_loop, daemon=True)
        c1t.start()

        # both binaries must PARK: breaker opens, acquirers gate off
        result["both_parked_ok"] = wait_parked(1.0, 90)
        # while parked: claim transactions stop cold and circuit_open
        # step-backs stay bounded (no churn — that's the whole point)
        pre = {p: (family_sum(p, "janus_lease_acquire_tx_total"), circuit_open_backs(p)) for p in ports}
        time.sleep(2.0)
        frozen = bounded = True
        for p in ports:
            claims_then, backs_then = pre[p]
            frozen = frozen and family_sum(p, "janus_lease_acquire_tx_total") == claims_then
            bounded = bounded and (circuit_open_backs(p) - backs_then) <= 1
        result["claims_frozen_while_parked_ok"] = frozen
        result["step_backs_bounded_ok"] = bounded
        result["outage_seconds_counted_ok"] = all(
            family_sum(p, "janus_peer_outage_seconds_total") > 0 for p in ports
        )
        statusz = json.loads(_scrape(port_a, "/statusz"))
        ph = statusz.get("peer_health", {})
        result["statusz_peer_health_ok"] = ph.get("parked") is True and bool(ph.get("peers"))
        result["driver_devices"] = statusz.get("process", {}).get("devices")

        # --- phase 3: heal the wire; probes resume both drivers -------
        proxy.clear()
        result["unparked_ok"] = wait_parked(0.0, 60)
        result["recovery_agg_ok"] = wait_agg_done(120)
        c1t.join(timeout=240)
        result["collect1"] = collect1
        result["collect1_exact_ok"] = collect1.get("count") == wave_a_count and collect1.get("sum") == wave_a_sum

        if full:
            # --- latency + jitter lane --------------------------------
            lat = [{"kind": "latency", "latency_s": 0.08, "jitter_s": 0.04}]
            proxy.set_toxics("up", lat)
            proxy.set_toxics("down", lat)
            upload_wave([1] * 3)
            creator.run_once()
            result["latency_lane_ok"] = wait_agg_done(120)
            proxy.clear()
            # --- flaky mid-request resets -----------------------------
            proxy.set_toxics("up", [{"kind": "reset", "after_bytes": 120, "count": 2}])
            upload_wave([1] * 2)
            creator.run_once()
            result["reset_lane_ok"] = wait_agg_done(120) and proxy.stats["resets"] >= 1
            proxy.clear()

        # --- phase 4: slow-drip (slicer) lane -------------------------
        # one connection's responses drip in 24-byte slices, 0.7 s
        # apart: each slice resets a per-read socket timer, so only the
        # client's wall-clock body budget can end the attempt; the
        # retry rides a fresh (clean) connection
        proxy.set_toxics("down", [{"kind": "slicer", "slice_bytes": 24, "delay_s": 0.7, "count": 1}])
        upload_wave([1] * 2)
        creator.run_once()
        result["slicer_lane_ok"] = wait_agg_done(150) and proxy.stats["toxic_fired"].get("slicer", 0) >= 1
        # --- phase 5: mid-request truncation lane ---------------------
        # cut one connection's REQUEST 150 bytes in — mid-headers for
        # any HTTP request, so the fire is deterministic regardless of
        # DAP body sizes. The driver sees the connection die before a
        # response and retries on a fresh (clean) wire; the helper never
        # got a full request, so no state moved.
        proxy.set_toxics("up", [{"kind": "truncate", "after_bytes": 150, "count": 1}])
        upload_wave([1] * 2)
        creator.run_once()
        result["truncate_lane_ok"] = wait_agg_done(150) and proxy.stats["truncates"] >= 1
        proxy.clear()
        result["upload_errors"] = upload_errors[:5]
        result["uploads_all_acked_ok"] = not upload_errors

        # --- phase 6: collect everything after the baseline boundary --
        end = cross_bucket_boundary()
        q2 = Query.time_interval(Interval(Time(boundary), Duration(end - boundary)))
        collected = collector.collect(q2, timeout_s=240.0)
        result["collect2"] = {"count": collected.report_count, "sum": collected.aggregate_result}
        # THE invariant: the two disjoint collections partition the
        # admitted ground truth exactly — through a blackhole, parking,
        # probing, slow-drip and truncation
        result["exactly_once_ok"] = (
            collect1.get("count", 0) + collected.report_count == len(acked)
            and collect1.get("sum", 0) + collected.aggregate_result == sum(acked)
        )
        result["admitted"] = len(acked)
        result["ground_truth_sum"] = sum(acked)

        # --- final gates + drain --------------------------------------
        result["lease_conflicts_ok"] = all(family_sum(p, "janus_lease_conflicts_total") == 0 for p in ports)
        result["probes_alive_ok"] = all(
            _label_sum(_metric_samples(_scrape(p, "/metrics"), "janus_peer_probes_total"), 'outcome="alive"') >= 1
            for p in ports
        )
        result["proxy_stats"] = {k: v for k, v in proxy.stats.items() if k != "toxic_fired"} | {
            "toxic_fired": dict(proxy.stats["toxic_fired"])
        }
        result["drain_ok"] = all(_sigterm_drain(drv, log_path)[1] for drv, _port, log_path in drivers)
        return _finish(result, t_run0)
    finally:
        _stop_all(procs)
        if proxy is not None:
            proxy.stop()
        pair.close()


def seed_manifest(path: str, insts, buckets=(32, 64, 128)) -> int:
    """janus_tpu's cold-start manifest, byte for byte at one clock: for each
    VDAF, leader_init, helper_init and aggregate at each bucket (cost
    bucket / 10, so the priority order is fixed) and one aggregate_pending
    of 8 buckets at 64 rows (cost 3.0). Returns the entries written."""
    from ..aggregator.shape_manifest import ShapeManifest

    man = ShapeManifest(path)
    n = 0
    for inst in insts:
        for b in buckets:
            for op in ("leader_init", "helper_init", "aggregate"):
                man.record(inst.to_dict(), op, b, (op, b), float(b) / 10, rows=b)
                n += 1
        man.record(inst.to_dict(), "aggregate_pending", 64, ("aggregate_pending", 8, 64), 3.0, rows=64)
        n += 1
    return n


def _compile_rows(statusz: dict, kind: str) -> dict:
    """{(op, bucket): (compile_s, dispatches, execute_s)} of one VDAF
    kind's rows in a /statusz `device_cost` section."""
    return {(e["op"], e["bucket"]): (e["compile_s"], e["dispatches"], e["execute_s"])
            for e in (statusz.get("device_cost") or {}).get("entries", []) if e["vdaf"] == kind}


def run_cold_start(
    pairs: int = 1,
    full: bool = False,
    warm_budget_s: float = 10.0,
    workdir: str | None = None,
    device: str = "cuda",
    vdafs=None,
    buckets=(32, 64, 128),
    manifest: str | None = None,
    job_reports: int = 0,
) -> dict:
    """Cold-start A/B: interleaved cold and warm boots of the real job
    driver binary, restart to first dispatch read from /debug/boot. Both
    boots of a pair replay the SAME shape manifest through the prewarm
    before /readyz reports ready, so ready means every recorded
    specialization has run once, and the boot total is the restart to
    first dispatch. What differs is the compile cache directory: empty
    (cold: `backend_init` builds the four kernel libraries with nvcc into
    its kernel-library cache) or the one the cold boot filled (warm: it
    loads them and builds none).

    The leader (whose store the drivers share) and the helper run in this
    process on `device` (CUDA unless named; raises without it before
    anything boots), one task each of `vdafs` (janus_tpu's: Count, and
    Histogram(4) with `full`). The manifest is janus_tpu's seeded one
    (`seed_manifest` over `buckets`), or a copy of `manifest`, a manifest a
    serving process recorded. With `job_reports`, the last warm boot then
    steps one real job of that many reports of the first VDAF after
    ready: it must finish, and add no `compile` row to the device-cost
    split at any (op, bucket) the manifest covers (`warm_job_ok`,
    `warm_job_no_compile_ok`, the port's additions). The same job then
    runs on a control boot, `unwarmed`: the warm libraries, no manifest
    and no prewarm. Its job books the cold first call at those keys
    (`unwarmed_job_compiles_ok`), so the record holds, per covered key,
    the first call's seconds beside the steady per-dispatch seconds of
    both jobs (`job_cold_cost`), and both jobs' step seconds. Each boot
    and each job reports the process's kernel launches (/statusz
    `process`), the prewarm's and the job's own.

    Gates, as janus_tpu's: every boot ready, with the
    `engine_warm_manifest` phase and every entry warmed; the warm boot
    under `warm_budget_s`; SIGTERM drains. On CUDA also: the cold boot
    built the four libraries (`cold_aot_saves_ok`), the warm boot built
    none (`warm_aot_loads_ok`), the warms' cache hits and misses follow
    them (`warm_cache_hits_ok`, `cold_cache_misses_ok`), and warm is at
    least 1.5x (3x with `full`) faster than cold (`speedup_ok`). The CPU
    builds no library, so those five keys are absent from a CPU record."""
    import shutil

    from ..aggregator.shape_manifest import inspect_file
    from ..core.time_util import RealClock
    from ..ops.cuda_build import KERNELS
    from ..vdaf.registry import VdafInstance

    device, tmp = _open_run(device, workdir, "janus-coldstart-")
    t_run0 = time.monotonic()
    on_card = device.startswith("cuda")
    insts = tuple(vdafs) if vdafs is not None else (
        (VdafInstance.count(), VdafInstance.histogram(length=4)) if full else (VdafInstance.count(),)
    )
    result: dict = {"workdir": tmp, "schedule": "cold_start", "pairs": pairs, "device": device,
                    "vdafs": [inst.to_dict() for inst in insts]}
    clock = RealClock()
    pair = _Pair(tmp, device, clock).start()
    procs: list = []
    try:
        tasks = [pair.provision(30 + 2 * i, 31 + 2 * i, vdaf=inst)[0] for i, inst in enumerate(insts)]

        def one_boot(idx: int, label: str, cache_dir: str, manifest_path: str, job_seed: int | None = None,
                     covered=(), prewarm: bool = True) -> dict:
            port = _free_port()
            log_path = os.path.join(tmp, f"driver-{idx}-{label}.log")
            cfg = _driver_cfg(
                os.path.join(tmp, f"driver-{idx}-{label}.yaml"), pair.leader_db, port, 600, 1.5, device,
                extra=f"compilation_cache_dir: {json.dumps(cache_dir)}\n"
                "engine:\n"
                f"  shape_manifest_path: {json.dumps(manifest_path)}\n"
                f"  prewarm: {json.dumps(prewarm)}\n"
                "  prewarm_boot_budget_secs: 300\n",
            )
            drv = _spawn_driver(cfg, pair.key, log_path, None)
            procs.append(drv)
            boot: dict = {"label": label}
            _wait_healthz(port, deadline_s=600.0)
            deadline = time.monotonic() + 60
            doc: dict = {}
            while time.monotonic() < deadline:
                doc = json.loads(_scrape(port, "/debug/boot"))
                if doc.get("ready"):
                    break
                time.sleep(0.1)
            boot["ready_ok"] = bool(doc.get("ready"))
            boot["total_s"] = doc.get("total_s")
            boot["phases"] = {ph["phase"]: ph["seconds"] for ph in doc.get("phases", [])}
            boot["manifest_phase_ok"] = "engine_warm_manifest" in boot["phases"]
            pw = _metric_samples(_scrape(port, "/metrics"), "janus_engine_prewarm_total")
            boot["prewarm_total"] = pw
            boot["warmed"] = _label_sum(pw, 'outcome="warmed"')
            statusz = json.loads(_scrape(port, "/statusz"))
            ep = statusz.get("engine_prewarm", {})
            prewarm = ep.get("prewarm", {})
            aot = ep.get("aot", {})
            boot.update(
                cache_hits=prewarm.get("cache_hits", 0), cache_misses=prewarm.get("cache_misses", 0),
                failed=prewarm.get("failed", 0), deferred=prewarm.get("deferred", 0),
                priority_elapsed_s=prewarm.get("priority_elapsed_s"),
                manifest_entries=ep.get("manifest", {}).get("entries", 0),
                aot_loads=aot.get("loads", 0), aot_saves=aot.get("saves", 0), aot_errors=aot.get("errors", 0),
                nvcc_s=aot.get("nvcc_s", 0.0), aot_dir=aot.get("dir"),
                device_memory=statusz.get("process", {}).get("device_memory"),
                kernel_launches=statusz.get("process", {}).get("kernel_launches"),
            )
            if job_seed is not None:
                boot["job"] = step_job(port, statusz, covered, job_seed)
            boot["drain_rc"], boot["drained"] = _sigterm_drain(drv, log_path)
            return boot

        def step_job(port: int, statusz: dict, covered, seed: int) -> dict:
            """One real job of `job_reports` new reports of the first task,
            stepped by the ready driver: the device-cost rows and the
            kernel launches it adds."""
            import numpy as np

            from ..aggregator.aggregation_job_creator import AggregationJobCreator
            from ..aggregator.testing import leader_stored_reports
            from ..convert import step_args_to_numpy
            from ..vdaf.testing import make_report_batch, random_measurements

            task, inst = tasks[0], insts[0]
            helper_task = pair.helper_ds.run_tx(lambda tx: tx.get_task(task.task_id), "chaos_provision")
            meas = random_measurements(inst, job_reports, np.random.default_rng(seed))
            args, _ = make_report_batch(inst, meas, seed=seed, shard_chunk=256, device=device)
            now = clock.now().seconds
            reports = leader_stored_reports(task, helper_task.hpke_keys[0].config, step_args_to_numpy(args),
                                            [now - 60] * job_reports)
            pair.leader_ds.run_tx(lambda tx: [tx.put_client_report(r) for r in reports], "chaos_upload")
            before = _compile_rows(statusz, inst.kind)
            launches0 = statusz.get("process", {}).get("kernel_launches") or {}
            finished0 = pair.finished_jobs()
            t0 = time.monotonic()
            created = AggregationJobCreator(pair.leader_ds).run_once()
            deadline = time.monotonic() + 600
            while pair.finished_jobs() <= finished0 and time.monotonic() < deadline:
                time.sleep(0.1)
            step_s = time.monotonic() - t0
            after_doc = json.loads(_scrape(port, "/statusz"))
            after = _compile_rows(after_doc, inst.kind)
            zero = (0.0, 0, 0.0)
            grown = sorted(k for k, row in after.items() if row[0] > before.get(k, zero)[0])
            added = {k: tuple(a - b for a, b in zip(row, before.get(k, zero))) for k, row in after.items()}
            launches = after_doc.get("process", {}).get("kernel_launches") or {}
            return {"reports": job_reports, "jobs_created": created, "finished": pair.finished_jobs() - finished0,
                    "step_s": step_s, "covered": sorted(covered), "compile_rows_added": grown,
                    "covered_compile_rows_added": [k for k in grown if k in covered],
                    "dispatches_added": {f"{k[0]}@{k[1]}": d for k, (_, d, _) in added.items() if d > 0},
                    # per (op, bucket): (compile_s, dispatches, execute_s) added
                    "cost_added": {f"{k[0]}@{k[1]}": v for k, v in added.items() if v[1] > 0},
                    "launches_added": {k: v - launches0.get(k, 0) for k, v in launches.items()}}

        boots: list[dict] = []
        for i in range(pairs):
            cache_dir = os.path.join(tmp, f"cache-{i}")
            manifest_path = os.path.join(tmp, f"shape-manifest-{i}.jsonl")
            if manifest is not None:
                shutil.copyfile(manifest, manifest_path)
                result["manifest_seeded_entries"] = len(inspect_file(manifest_path)[0])
            else:
                result["manifest_seeded_entries"] = seed_manifest(manifest_path, insts, buckets)
            # interleaved: cold then warm on the same (cache, manifest)
            # pair, so the warm boot reads exactly what the cold one wrote
            boots.append(one_boot(i, "cold", cache_dir, manifest_path))
            want = insts[0].to_dict()
            covered = {(e["op"], e["bucket"]) for e in inspect_file(manifest_path)[0] if e["vdaf"] == want}
            job = job_reports > 0 and i == pairs - 1
            boots.append(one_boot(i, "warm", cache_dir, manifest_path, 0xC01D if job else None, covered))
            if job:
                # the control: the same job on the warm libraries with no
                # manifest and no prewarm, after the warm boot (whatever
                # else warmed in between favours the control)
                boots.append(one_boot(i, "unwarmed", cache_dir, "", 0xC01E, covered, prewarm=False))
        result["boots"] = boots
        colds = [b for b in boots if b["label"] == "cold"]
        warms = [b for b in boots if b["label"] == "warm"]
        unwarmed = [b for b in boots if b["label"] == "unwarmed"]
        ok_shape = all(b.get("ready_ok") and b.get("total_s") is not None for b in boots)
        result["boots_ready_ok"] = ok_shape
        if ok_shape:
            cold_s = sorted(b["total_s"] for b in colds)[len(colds) // 2]
            warm_s = sorted(b["total_s"] for b in warms)[len(warms) // 2]
            result["cold_restart_to_first_dispatch_s"] = round(cold_s, 3)
            result["warm_restart_to_first_dispatch_s"] = round(warm_s, 3)
            result["speedup"] = round(cold_s / max(1e-9, warm_s), 2)
            result["warm_under_budget_ok"] = warm_s < warm_budget_s
            result["speedup_gate"] = 3.0 if full else 1.5
            result["manifest_phase_ok"] = all(b.get("manifest_phase_ok") for b in boots)
            result["prewarm_observed_ok"] = all(b.get("warmed", 0) >= result["manifest_seeded_entries"]
                                                for b in colds + warms)
            if on_card:
                # the kernel-library cache: the cold boot builds the four
                # libraries, the warm one loads them and builds none
                result["speedup_ok"] = result["speedup"] >= result["speedup_gate"]
                result["warm_cache_hits_ok"] = all(b.get("cache_hits", 0) > 0 for b in warms)
                result["cold_cache_misses_ok"] = all(b.get("cache_misses", 0) > 0 for b in colds)
                result["cold_aot_saves_ok"] = all(b.get("aot_saves", 0) == len(KERNELS) for b in colds)
                result["warm_aot_loads_ok"] = all(
                    b.get("aot_saves", 0) == 0 and b.get("aot_loads", 0) == len(KERNELS) for b in warms
                )
            result["drain_ok"] = all(b.get("drain_rc") == 0 for b in boots)
            job = next((b["job"] for b in warms if "job" in b), None)
            if job is not None:
                result["warm_job_ok"] = job["finished"] >= 1
                result["warm_job_no_compile_ok"] = not job["covered_compile_rows_added"]
                control = unwarmed[0]["job"]
                result["unwarmed_job_compiles_ok"] = control["finished"] >= 1 and bool(
                    control["covered_compile_rows_added"])
                result["warm_job_step_s"] = job["step_s"]
                result["unwarmed_job_step_s"] = control["step_s"]
                # per covered key the job ran: the control's first call, the
                # control's steady dispatches and the warm job's dispatches
                # (host seconds of the dispatch, each)
                cost: dict = {}
                for key in control["covered_compile_rows_added"]:
                    k = f"{key[0]}@{key[1]}"
                    c_compile, c_n, c_exec = control["cost_added"][k]
                    w = job["cost_added"].get(k)
                    cost[k] = {"first_call_s": c_compile,
                               "unwarmed_steady_s": c_exec / (c_n - 1) if c_n > 1 else None,
                               "warm_per_dispatch_s": w[2] / w[1] if w else None}
                result["job_cold_cost"] = cost
        result["elapsed_s"] = round(time.monotonic() - t_run0, 1)
        result["ok"] = bool(boots) and all(v for k, v in result.items() if k.endswith("_ok"))
        return result
    finally:
        _stop_all(procs)
        pair.close()


SCENARIOS = ("crash_storm", "db_outage", "device_hang", "pipeline", "resident", "fleet", "soak", "peer_outage",
             "cold_start")


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
        choices=SCENARIOS,
        default="crash_storm",
        help="crash_storm = driver SIGKILL + helper storms (default); "
        "db_outage = datastore outage under upload load (journal spill, "
        "degraded serving, replay, exactly-once); device_hang = wedged "
        "device dispatch (watchdog abandon inside the lease, quarantine + "
        "canary restore, no work while quarantined, exactly-once); "
        "pipeline = stage-pipelined stepper overlap proof (device lane "
        "busy while a stretched helper RTT is in flight, exactly-once); "
        "resident = device-resident accumulator flush contract (LRU "
        "eviction, quarantine sweep, SIGTERM drain each flush resident "
        "state; collections exact); fleet = N real driver replicas over "
        "one store (sharded batched claims): served-rps scaling at 1/2/4 "
        "replicas, SIGKILL + SIGTERM + restart mid-load, zero lease "
        "conflicts, exact collection; soak = endurance soak under task "
        "churn + GC deletion, judged by flight-recorder trend verdicts "
        "(zero-slope on the clean driver, an injected leak fires the trend "
        "alert; SQLite only); peer_outage = helper behind a netsim fault "
        "proxy (a blackhole past the breaker threshold parks BOTH real "
        "driver binaries, a cheap probe resumes them, slow-drip + "
        "truncation lanes recover, collections exact); cold_start = "
        "interleaved cold and warm boots of the real driver binary, each "
        "replaying the shape manifest through the prewarm before ready "
        "(the cold boot builds the kernel libraries, the warm one loads "
        "them; restart to first dispatch from /debug/boot)",
    )
    ap.add_argument("--reports", type=int, default=0, help="0 = schedule default")
    ap.add_argument(
        "--job-reports",
        type=int,
        default=0,
        help="cold_start: step one real job of this many reports on the warm boot (0: none)",
    )
    ap.add_argument("--json", action="store_true", help="print the result record as JSON")
    ap.add_argument("--workdir", default=None, help="keep artifacts here (default: temp dir)")
    ap.add_argument(
        "--device",
        default="cuda",
        help="device of the leader, the helper and the driver binaries "
        "(default cuda; `cpu` only where asked)",
    )
    args = ap.parse_args(argv)

    common = dict(full=not args.smoke, workdir=args.workdir, device=args.device)
    if args.scenario == "db_outage":
        result = run_db_outage(
            n_warm=args.reports or (4 if args.smoke else 10),
            outage_hold_s=1.5 if args.smoke else 5.0,
            **common,
        )
    elif args.scenario == "device_hang":
        result = run_device_hang(n_reports=args.reports or (5 if args.smoke else 12), **common)
    elif args.scenario == "pipeline":
        result = run_pipeline(n_reports=args.reports or (24 if args.smoke else 60), **common)
    elif args.scenario == "resident":
        result = run_resident(**common)
    elif args.scenario == "fleet":
        result = run_fleet(**common)
    elif args.scenario == "soak":
        result = run_soak(
            epochs=4 if args.smoke else 12,
            reports_per_epoch=args.reports or (8 if args.smoke else 24),
            report_expiry_s=30.0 if args.smoke else 120.0,
            **common,
        )
    elif args.scenario == "cold_start":
        result = run_cold_start(job_reports=args.job_reports, **common)
    elif args.scenario == "peer_outage":
        result = run_peer_outage(n_reports=args.reports or (4 if args.smoke else 8), **common)
    else:
        result = run_chaos(n_reports=args.reports or (5 if args.smoke else 12), **common)
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
