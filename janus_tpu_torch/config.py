"""YAML configuration of the binaries.

The port's own copy of janus_tpu/config.py (the reference's
aggregator/src/config.rs): CommonConfig shared by every binary (database,
logging, health-check listener, the device, the observability stanzas,
the fleet identity), the JobDriverConfig knobs (config.rs:121-141) and
one section per binary, with janus_tpu's YAML key names and defaults.
Secrets (datastore keys) arrive through flags or the environment, never
the YAML file (binary_utils.rs:40-66).

Where janus_tpu differs:

- `device:` takes the place of `jax_platform`: one device string
  ("cuda:0", "cpu") or a list of them (the engines then serve on a mesh of
  those devices, with the geometry `engine: mesh: {dp, sp}` pins). Absent,
  the process runs on CUDA and refuses to boot without it
  (`device.resolve_device`); the CPU runs only where the file says so.
- The keys that configure what the port does not have are read and
  ignored, as `from_dict` ignores any key it does not know: the
  top-level `jax_platform` and `compilation_cache_dir`, and `engine:`'s
  `compile_cache_dir`, `aot_cache`, `prewarm*` and `shape_manifest_*`.
  `CommonConfig.ignored_keys` names those a file set, and janus_main logs
  them once at boot.
- `engine: cross_task_coalesce: false` is refused at load: the port
  always coalesces across tasks.
- `FleetConfig.from_dict` reads the dict alone: janus_tpu's
  `JANUS_REPLICA_ID`, `JANUS_SHARD_COUNT`, `JANUS_SHARD_INDEX` and
  `JANUS_STEAL_AFTER_S` overrides are not ported (no `JANUS_*` knob is).
- `load_config` reads a `.json` file with `json` (JSON is YAML 1.2, so
  janus_tpu reads the same file) and any other with PyYAML's
  `safe_load`, which must then be installed.
"""

from __future__ import annotations

import json
import math
import os
import socket
from dataclasses import dataclass, field

from .aggregator.aggregation_job_creator import AggregationJobCreatorConfig
from .aggregator.aggregation_job_driver import ResidentConfig
from .aggregator.core import Config as AggregatorProtocolConfig
from .aggregator.job_driver import JobDriverConfig
from .aggregator.peer_health import PeerHealthConfig
from .aggregator.step_pipeline import StepPipelineConfig
from .core.circuit_breaker import CircuitBreakerConfig
from .core.http_client import HttpClientConfig
from .datastore.models import ShardSpec
from .datastore.store import replica_holder_tag
from .flight_recorder import FlightRecorderConfig
from .ledger import LedgerConfig
from .profiler import ProfilerConfig
from .slo import SloEngineConfig
from .trace import TraceConfiguration

# keys of janus_tpu's YAML that configure the JAX runtime, its compile
# caches and its prewarm: read and ignored here
IGNORED_TOP_LEVEL_KEYS = ("jax_platform", "compilation_cache_dir")
IGNORED_ENGINE_KEYS = (
    "compile_cache_dir",
    "aot_cache",
    "prewarm",
    "prewarm_boot_budget_secs",
    "shape_manifest_path",
    "shape_manifest_max_entries",
)


def default_replica_id() -> str:
    """Stable-per-process replica id (hostname-pid), used when no fleet
    identity is configured."""
    return f"{socket.gethostname()}-{os.getpid()}"


@dataclass
class FleetConfig:
    """The `fleet:` stanza: a replica's identity and its shard. It claims
    the jobs whose persisted shard_key % shard_count == shard_index at
    once, and any other only after steal_after_secs of eligibility (a
    dead replica's shard drains instead of starving)."""

    # stable replica identity; None: hostname-pid
    replica_id: str | None = None
    shard_count: int = 1
    shard_index: int = 0
    steal_after_secs: float = 30.0

    @classmethod
    def from_dict(cls, d: dict | None) -> "FleetConfig":
        d = d or {}
        replica_id = d.get("replica_id")
        return cls(
            replica_id=str(replica_id) if replica_id else None,
            shard_count=max(1, int(d.get("shard_count", 1))),
            shard_index=int(d.get("shard_index", 0)),
            steal_after_secs=max(0.0, float(d.get("steal_after_secs", 30.0))),
        )

    def resolved_replica_id(self) -> str:
        return self.replica_id or default_replica_id()

    def shard_spec(self) -> ShardSpec | None:
        """ShardSpec for the batched lease claims; None when the fleet is
        unsharded (the predicate drops out of the claim)."""
        if self.shard_count <= 1:
            return None
        return ShardSpec(
            shard_count=self.shard_count,
            shard_index=self.shard_index % self.shard_count,
            # ceil, never truncate: the claim predicate works in whole
            # seconds, and a fractional steal_after (0.5) must fence for 1 s,
            # not disable the fence while the creator honours the float
            steal_after_s=math.ceil(max(0.0, self.steal_after_secs)),
        )

    def install_identity(self) -> None:
        """The process's replica identity in the metrics registry: labelled
        per replica only where a replica_id is configured."""
        from . import metrics

        metrics.set_replica_identity(self.replica_id, self.shard_index, self.shard_count)

    def holder_tag(self) -> bytes:
        """8-byte provenance tag stamped into every lease token this replica
        mints."""
        return replica_holder_tag(self.resolved_replica_id())


@dataclass
class EngineConfig:
    """The `engine:` stanza: engine-layer knobs shared by every binary
    with a device path."""

    # process-wide device-byte bound on resident aggregate buffers
    # (EngineCache.RESIDENT_MAX_BYTES); 0/None keeps the class default
    resident_max_bytes: int | None = None
    # merge small jobs across tasks into one device dispatch; the port
    # always does, so only None (absent) or True loads
    cross_task_coalesce: bool | None = None
    # `mesh: {dp, sp}` pins the serving mesh axes (dp: the report batch,
    # sp: the measurement and out-share columns) instead of picking them
    # from the device count; choose_mesh_geometry validates the pin
    mesh_dp: int | None = None
    mesh_sp: int | None = None

    @classmethod
    def from_dict(cls, d: dict | None) -> "EngineConfig":
        d = d or {}
        rmb = d.get("resident_max_bytes")
        xt = d.get("cross_task_coalesce")
        if xt is not None and not xt:
            raise ValueError(
                "engine: cross_task_coalesce: false is not supported: janus_tpu_torch always coalesces "
                "small jobs across tasks (per-lane verify keys); remove the key"
            )
        mesh = d.get("mesh") or {}
        mdp = mesh.get("dp")
        msp = mesh.get("sp")
        return cls(
            resident_max_bytes=int(rmb) if rmb is not None else None,
            cross_task_coalesce=bool(xt) if xt is not None else None,
            mesh_dp=int(mdp) if mdp is not None else None,
            mesh_sp=int(msp) if msp is not None else None,
        )


@dataclass
class DbConfig:
    """reference config.rs:61 (url + connection knobs). `url` selects the
    engine: a postgres:// or postgresql:// URL opens the Postgres backend;
    any other value is a SQLite filesystem path (or ":memory:")."""

    url: str = "janus.sqlite"
    # warning threshold for one datastore transaction (run_tx wall time,
    # retries included); <= 0 disables the warning
    slow_tx_warn_secs: float = 1.0
    # cap on one run_tx retry sleep (full-jitter exponential backoff below it)
    retry_max_interval_secs: float = 0.128
    # the datastore supervisor's health-probe period (up / degraded / down /
    # recovering, /readyz, shedding, the journal's spill); 0 disables
    health_probe_interval_secs: float = 5.0
    # consecutive connection-class failures before the state goes down
    down_after_failures: int = 3
    # ceiling of the jittered reconnect/probe backoff while down
    reconnect_max_interval_secs: float = 30.0

    @classmethod
    def from_dict(cls, d: dict) -> "DbConfig":
        return cls(
            url=str(d.get("url", "janus.sqlite")),
            slow_tx_warn_secs=float(d.get("slow_tx_warn_secs", 1.0)),
            retry_max_interval_secs=float(d.get("retry_max_interval_secs", 0.128)),
            health_probe_interval_secs=float(d.get("health_probe_interval_secs", 5.0)),
            down_after_failures=int(d.get("down_after_failures", 3)),
            reconnect_max_interval_secs=float(d.get("reconnect_max_interval_secs", 30.0)),
        )


@dataclass
class TaskprovConfig:
    """reference config.rs:93."""

    enabled: bool = False

    @classmethod
    def from_dict(cls, d: dict | None) -> "TaskprovConfig":
        return cls(enabled=bool((d or {}).get("enabled", False)))


@dataclass
class CommonConfig:
    """reference config.rs:28-45."""

    database: DbConfig = field(default_factory=DbConfig)
    logging_config: TraceConfiguration = field(default_factory=TraceConfiguration)
    health_check_listen_address: str = "0.0.0.0:9001"
    # the device this process serves on: a device string, or a tuple of
    # them for a mesh; None is CUDA, and no CUDA refuses the boot
    device: str | tuple[str, ...] | None = None
    # warm the engines of every provisioned task at boot (a first dispatch
    # at a bucket: the kernel libraries loaded, the allocator warmed)
    # instead of paying it on the first request. The device-path binaries
    # use it.
    warmup_engines_at_boot: bool = False
    # with warmup_buckets set (e.g. [32, 256, 1024]) the warmup runs in a
    # background thread, ascending, while serving starts
    warmup_buckets: tuple[int, ...] = ()
    # period of the job/task health sampler (aggregator/health_sampler.py);
    # 0 disables. The aggregator server and both job drivers run it.
    health_sampler_interval_s: float = 15.0
    # fault injection (failpoints.py): a spec string or a {name: spec}
    # mapping; None arms nothing
    failpoints: object = None
    # the device watchdog and the quarantine's canary (`device_watchdog:`)
    watchdog_abandoned_thread_cap: int = 8
    quarantine_canary_delay_secs: float = 5.0
    quarantine_canary_timeout_secs: float = 30.0
    # the SLO burn-rate engine (`slo:`), on by default: every binary
    # answers GET /alertz
    slo: SloEngineConfig = field(default_factory=SloEngineConfig)
    # engine-layer knobs (`engine:`)
    engine: EngineConfig = field(default_factory=EngineConfig)
    # the always-on sampling profiler (`profiler:`) behind GET /debug/profile
    profiler: ProfilerConfig = field(default_factory=ProfilerConfig)
    # the telemetry flight recorder (`flight:`) behind GET /debug/flight
    flight: FlightRecorderConfig = field(default_factory=FlightRecorderConfig)
    # the report-flow conservation ledger (`ledger:`) behind GET /debug/ledger
    ledger: LedgerConfig = field(default_factory=LedgerConfig)
    # fleet identity and job-claim sharding (`fleet:`)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    # keys of the file that configure janus_tpu's JAX runtime and that this
    # package reads and ignores ("engine.aot_cache" for a nested one)
    ignored_keys: tuple[str, ...] = ()

    @classmethod
    def from_dict(cls, d: dict) -> "CommonConfig":
        wd = d.get("device_watchdog", {}) or {}
        device = d.get("device")
        if isinstance(device, (list, tuple)):
            device = tuple(str(x) for x in device)
            if not device:
                raise ValueError("device: an empty list names no device")
        elif device is not None:
            device = str(device)
        engine = d.get("engine") or {}
        ignored = tuple(k for k in IGNORED_TOP_LEVEL_KEYS if k in d) + tuple(
            f"engine.{k}" for k in IGNORED_ENGINE_KEYS if k in engine
        )
        return cls(
            database=DbConfig.from_dict(d.get("database", {})),
            logging_config=TraceConfiguration.from_dict(d.get("logging_config")),
            health_check_listen_address=str(d.get("health_check_listen_address", "0.0.0.0:9001")),
            device=device,
            warmup_engines_at_boot=bool(d.get("warmup_engines_at_boot", False)),
            warmup_buckets=tuple(int(b) for b in d.get("warmup_buckets", ())),
            health_sampler_interval_s=float(d.get("health_sampler_interval_secs", 15.0)),
            failpoints=d.get("failpoints"),
            watchdog_abandoned_thread_cap=int(wd.get("abandoned_thread_cap", 8)),
            quarantine_canary_delay_secs=float(wd.get("canary_delay_secs", 5.0)),
            quarantine_canary_timeout_secs=float(wd.get("canary_timeout_secs", 30.0)),
            slo=SloEngineConfig.from_dict(d.get("slo")),
            engine=EngineConfig.from_dict(engine),
            profiler=ProfilerConfig.from_dict(d.get("profiler")),
            flight=FlightRecorderConfig.from_dict(d.get("flight")),
            ledger=LedgerConfig.from_dict(d.get("ledger")),
            fleet=FleetConfig.from_dict(d.get("fleet")),
            ignored_keys=ignored,
        )

    def devices(self) -> tuple:
        """The torch devices this process serves on: CUDA where `device` is
        absent (raising without it), else each named one."""
        from .device import resolve_device

        names = self.device if isinstance(self.device, tuple) else (self.device,)
        return tuple(resolve_device(d) for d in names)


def _job_driver_from_dict(d: dict) -> JobDriverConfig:
    """reference config.rs:121-141 field names."""
    return JobDriverConfig(
        job_discovery_interval_s=d.get("min_job_discovery_delay_secs", 0.2),
        max_job_discovery_interval_s=d.get("max_job_discovery_delay_secs", 5.0),
        max_concurrent_job_workers=int(d.get("max_concurrent_job_workers", 4)),
        worker_lease_duration_s=int(d.get("worker_lease_duration_secs", 600)),
        maximum_attempts_before_failure=int(d.get("maximum_attempts_before_failure", 10)),
        discovery_jitter=float(d.get("job_discovery_jitter", 0.25)),
    )


@dataclass
class AggregatorConfig:
    """reference aggregator/src/bin/aggregator.rs Config."""

    common: CommonConfig = field(default_factory=CommonConfig)
    listen_address: str = "0.0.0.0:8080"
    aggregator_api_listen_address: str | None = None
    aggregator_api_auth_tokens: tuple[str, ...] = ()
    max_upload_batch_size: int = 100
    max_upload_batch_write_delay_ms: int = 0
    batch_aggregation_shard_count: int = 1
    taskprov: TaskprovConfig = field(default_factory=TaskprovConfig)
    garbage_collection_interval_s: float | None = None
    collection_retry_after_s: int = 1
    # --- the ingest pipeline and admission control (`ingest:`) ---
    ingest_decrypt_workers: int = 0  # 0: sized from the crypto backend
    ingest_decode_workers: int = 1
    # flush-window batching of decode and decrypt; a window of 1 is the
    # per-report path
    ingest_batch_window: int = 32
    ingest_batch_linger_ms: float = 2.0
    # must stay below max_handler_threads (each upload in flight parks a
    # handler thread, so a larger bound can never fill)
    ingest_queue_depth: int = 24
    upload_bucket_rate: float = 0.0  # 0 = unlimited
    upload_bucket_burst: int = 0
    aggregate_bucket_rate: float = 0.0
    aggregate_bucket_burst: int = 0
    shed_priority: tuple = ("upload", "aggregate")
    queue_high_watermark: float = 0.75
    upload_shed_retry_after_s: float = 1.0
    max_handler_threads: int = 32
    # --- the durable upload spill journal (`upload_journal:`); no path:
    # disarmed, and the upload flush adds no fsync ---
    upload_journal_path: str | None = None
    upload_journal_max_segment_bytes: int = 8 << 20
    upload_journal_max_total_bytes: int = 256 << 20
    upload_journal_max_segments: int = 1024
    # commit latency past this spills later flushes to the journal; 0:
    # connection-class errors and a down datastore only
    upload_journal_spill_latency_secs: float = 0.0
    upload_journal_replay_interval_secs: float = 1.0
    # Retry-After on the 503 while the journal is full
    upload_journal_full_retry_after_secs: float = 30.0

    @classmethod
    def from_dict(cls, d: dict) -> "AggregatorConfig":
        gc = d.get("garbage_collection", {}) or {}
        api = d.get("aggregator_api", {}) or {}
        ingest = d.get("ingest", {}) or {}
        journal = d.get("upload_journal", {}) or {}
        return cls(
            common=CommonConfig.from_dict(d),
            listen_address=str(d.get("listen_address", "0.0.0.0:8080")),
            aggregator_api_listen_address=api.get("listen_address"),
            aggregator_api_auth_tokens=tuple(api.get("auth_tokens", ())),
            max_upload_batch_size=int(d.get("max_upload_batch_size", 100)),
            max_upload_batch_write_delay_ms=int(d.get("max_upload_batch_write_delay_ms", 0)),
            batch_aggregation_shard_count=int(d.get("batch_aggregation_shard_count", 1)),
            taskprov=TaskprovConfig.from_dict(d.get("taskprov_config")),
            garbage_collection_interval_s=gc.get("gc_frequency_s"),
            collection_retry_after_s=int(d.get("collection_retry_after_secs", 1)),
            ingest_decrypt_workers=int(ingest.get("decrypt_workers", 0)),
            ingest_decode_workers=int(ingest.get("decode_workers", 1)),
            ingest_batch_window=int(ingest.get("decrypt_batch_window", 32)),
            ingest_batch_linger_ms=float(ingest.get("decrypt_batch_linger_ms", 2.0)),
            ingest_queue_depth=int(ingest.get("queue_depth", 24)),
            upload_bucket_rate=float(ingest.get("upload_bucket_rate", 0.0)),
            upload_bucket_burst=int(ingest.get("upload_bucket_burst", 0)),
            aggregate_bucket_rate=float(ingest.get("aggregate_bucket_rate", 0.0)),
            aggregate_bucket_burst=int(ingest.get("aggregate_bucket_burst", 0)),
            shed_priority=tuple(ingest.get("shed_priority", ("upload", "aggregate"))),
            queue_high_watermark=float(ingest.get("queue_high_watermark", 0.75)),
            upload_shed_retry_after_s=float(ingest.get("shed_retry_after_secs", 1.0)),
            max_handler_threads=int(ingest.get("max_handler_threads", 32)),
            upload_journal_path=journal.get("path"),
            upload_journal_max_segment_bytes=int(journal.get("max_segment_bytes", 8 << 20)),
            upload_journal_max_total_bytes=int(journal.get("max_total_bytes", 256 << 20)),
            upload_journal_max_segments=int(journal.get("max_segments", 1024)),
            upload_journal_spill_latency_secs=float(journal.get("spill_commit_latency_secs", 0.0)),
            upload_journal_replay_interval_secs=float(journal.get("replay_interval_secs", 1.0)),
            upload_journal_full_retry_after_secs=float(journal.get("full_retry_after_secs", 30.0)),
        )

    def protocol_config(self) -> AggregatorProtocolConfig:
        return AggregatorProtocolConfig(
            max_upload_batch_size=self.max_upload_batch_size,
            max_upload_batch_write_delay_ms=self.max_upload_batch_write_delay_ms,
            batch_aggregation_shard_count=self.batch_aggregation_shard_count,
            taskprov_enabled=self.taskprov.enabled,
            collection_retry_after_s=self.collection_retry_after_s,
            ingest_decrypt_workers=self.ingest_decrypt_workers,
            ingest_decode_workers=self.ingest_decode_workers,
            ingest_batch_window=self.ingest_batch_window,
            ingest_batch_linger_ms=self.ingest_batch_linger_ms,
            ingest_queue_depth=self.ingest_queue_depth,
            upload_bucket_rate=self.upload_bucket_rate,
            upload_bucket_burst=self.upload_bucket_burst,
            aggregate_bucket_rate=self.aggregate_bucket_rate,
            aggregate_bucket_burst=self.aggregate_bucket_burst,
            shed_priority=self.shed_priority,
            queue_high_watermark=self.queue_high_watermark,
            upload_shed_retry_after_s=self.upload_shed_retry_after_s,
            max_handler_threads=self.max_handler_threads,
            upload_journal_path=self.upload_journal_path,
            upload_journal_max_segment_bytes=self.upload_journal_max_segment_bytes,
            upload_journal_max_total_bytes=self.upload_journal_max_total_bytes,
            upload_journal_max_segments=self.upload_journal_max_segments,
            upload_journal_spill_latency_s=self.upload_journal_spill_latency_secs,
            upload_journal_replay_interval_s=self.upload_journal_replay_interval_secs,
            upload_journal_full_retry_after_s=self.upload_journal_full_retry_after_secs,
        )


@dataclass
class JobCreatorConfig:
    """reference aggregator/src/bin/aggregation_job_creator.rs Config."""

    common: CommonConfig = field(default_factory=CommonConfig)
    aggregation_job_creation_interval_s: float = 1.0
    min_aggregation_job_size: int = 10
    max_aggregation_job_size: int = 100
    max_concurrent_tasks: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "JobCreatorConfig":
        # (tasks_update_frequency_secs is accepted but unused: the creator
        # reads the task list again on every pass)
        return cls(
            common=CommonConfig.from_dict(d),
            aggregation_job_creation_interval_s=float(d.get("aggregation_job_creation_interval_secs", 1.0)),
            min_aggregation_job_size=int(d.get("min_aggregation_job_size", 10)),
            max_aggregation_job_size=int(d.get("max_aggregation_job_size", 100)),
            max_concurrent_tasks=int(d.get("max_concurrent_tasks", 8)),
        )

    def creator_config(self) -> AggregationJobCreatorConfig:
        return AggregationJobCreatorConfig(
            min_aggregation_job_size=self.min_aggregation_job_size,
            max_aggregation_job_size=self.max_aggregation_job_size,
            max_concurrent_tasks=self.max_concurrent_tasks,
        )


@dataclass
class JobDriverBinaryConfig:
    """reference aggregator/src/bin/{aggregation,collection}_job_driver.rs."""

    common: CommonConfig = field(default_factory=CommonConfig)
    job_driver: JobDriverConfig = field(default_factory=JobDriverConfig)
    # the leader-to-helper circuit breaker (`outbound_circuit_breaker:`)
    outbound_circuit_breaker: CircuitBreakerConfig = field(default_factory=CircuitBreakerConfig)
    # peer-outage parking and half-open probing (`peer_health:`)
    peer_health: PeerHealthConfig = field(default_factory=PeerHealthConfig)
    # per-attempt timeout, body budget and size cap of the outbound helper
    # client (`helper_http:`)
    helper_http: HttpClientConfig = field(default_factory=HttpClientConfig)
    # the stage-pipelined leader stepper (`step_pipeline:`), on by default;
    # `enabled: false` restores the serial stepper
    step_pipeline: StepPipelineConfig = field(default_factory=StepPipelineConfig)
    # device-resident accumulators (`resident_accumulators:`), off by default
    resident_accumulators: ResidentConfig = field(default_factory=ResidentConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "JobDriverBinaryConfig":
        return cls(
            common=CommonConfig.from_dict(d),
            job_driver=_job_driver_from_dict(d),
            outbound_circuit_breaker=CircuitBreakerConfig.from_dict(d.get("outbound_circuit_breaker")),
            peer_health=PeerHealthConfig.from_dict(d.get("peer_health")),
            helper_http=HttpClientConfig.from_dict(d.get("helper_http")),
            step_pipeline=StepPipelineConfig.from_dict(d.get("step_pipeline")),
            resident_accumulators=ResidentConfig.from_dict(d.get("resident_accumulators")),
        )


def load_document(path: str):
    """The document in the file at `path`: a `.json` file is parsed with
    json, any other as YAML with PyYAML's safe_load (PyYAML is required
    for it: there is no fallback from one parser to the other)."""
    if str(path).endswith(".json"):
        with open(path) as f:
            return json.load(f)
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"{path}: reading YAML needs PyYAML (import yaml failed: {e}); install it, or give the file as .json"
        ) from e
    with open(path) as f:
        return yaml.safe_load(f)


def load_config(path: str, cls):
    """`cls.from_dict` of the configuration file at `path` (load_document)."""
    return cls.from_dict(load_document(path) or {})
