"""The rules janus_tpu_torch keeps: no JAX, the device is never chosen
silently, the CPU never counts as a kernel launch, and the leader's job
driver has no way to finish a job other than the device's."""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import janus_tpu_torch
from janus_tpu_torch.aggregator.aggregation_job_driver import (
    AggregationJobDriver,
    AggregationJobDriverConfig,
    ResidentConfig,
)
from janus_tpu_torch.aggregator.core import Aggregator, Config, TaskAggregator
from janus_tpu_torch.aggregator.http_handlers import DapHttpApp
from janus_tpu_torch.aggregator.engine_cache import EngineCache, engine_cache
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.device import resolve_device
from janus_tpu_torch.messages import Role, TaskId, Time
from janus_tpu_torch.ops import expand_cuda, keccak_cuda, scatter_cuda, sponge_cuda
from janus_tpu_torch.parallel import api
from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
from janus_tpu_torch.vdaf.circuits import Count, SumVec
from janus_tpu_torch.vdaf.prio3 import Prio3Batched
from janus_tpu_torch.vdaf.reference import Prio3, Prio3Sparse
from janus_tpu_torch.vdaf.registry import VdafInstance, prio3_batched, prio3_host
from janus_tpu_torch.vdaf.testing import make_report_batch, make_wire_reports, random_measurements, sparse_compact_batch
from janus_tpu_torch.vdaf.wire import flat_scatter_indices

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(Path(janus_tpu_torch.__file__).parent.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_include_every_module_of_the_package():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in (
        "vdaf/draft.py",
        "vdaf/feasibility.py",
        "vdaf/keccak.py",
        "ops/keccak_cuda.py",
        "ops/sponge_cuda.py",
        "aggregator/engine_cache.py",
        "aggregator/core.py",
        "vdaf/wire.py",
        "messages/core.py",
        "core/hpke_backend.py",
        "datastore/store.py",
        "task.py",
        "core/deadline.py",
        "core/retries.py",
        "core/circuit_breaker.py",
        "core/http_client.py",
        "datastore/models.py",
        "aggregator/job_driver.py",
        "aggregator/aggregation_job_creator.py",
        "aggregator/aggregation_job_driver.py",
        "aggregator/step_pipeline.py",
        "aggregator/accumulator.py",
        "aggregator/http_handlers.py",
        "binary_utils.py",
        "client.py",
        "ingest/__init__.py",
        "ingest/admission.py",
        "ingest/pipeline.py",
        "aggregator/report_writer.py",
        "vdaf/reference.py",
        "dp.py",
        "collector.py",
        "aggregator/collection_job_driver.py",
        "aggregator/garbage_collector.py",
        "messages/taskprov.py",
        "taskprov.py",
        "aggregator/cache.py",
        "failpoints.py",
        "datastore/pg_fake.py",
        "ingest/journal.py",
        "ops/scatter_cuda.py",
        "vdaf/circuits.py",
        "parallel/api.py",
        "statusz.py",
        "metrics.py",
        "exposition.py",
        "trace.py",
        "profiler.py",
        "ledger.py",
        "config.py",
        "slo.py",
        "flight_recorder.py",
        "aggregator/health_sampler.py",
        "aggregator/peer_health.py",
        "bin/__init__.py",
        "bin/aggregator.py",
        "bin/aggregation_job_creator.py",
        "bin/aggregation_job_driver.py",
        "bin/collection_job_driver.py",
        "bin/janus_cli.py",
        "bin/interop_aggregator.py",
        "bin/interop_client.py",
        "bin/interop_collector.py",
        "aggregator_api.py",
        "interop.py",
    ):
        assert f"janus_tpu_torch/{module}" in names, module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_janus_tpu(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), f"{path}: imports {mod}"
        assert top != "janus_tpu", f"{path}: imports {mod}"


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Prio3Batched(Count())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.two_party_step(VdafInstance.count(), bytes(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_report_batch(VdafInstance.count(), [0, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        api.two_party_step(VdafInstance("count", xof_mode="draft"), bytes(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCache(VdafInstance.count(), bytes(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_cache(VdafInstance.count(), bytes(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TaskAggregator(TaskBuilder(QueryTypeConfig.time_interval(), VdafInstance.count(), Role.HELPER).build(), Config())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_wire_reports(VdafInstance.count(), [0, 1], TaskId.random(), None, None, Time(0))
    assert Prio3Batched(SumVec(length=2, bits=2), device="cpu").device == torch.device("cpu")


def test_no_cuda_and_no_cpu_request_raises_for_the_shell(monkeypatch):
    """The leader's job driver and the helper's HTTP app, built without a
    device: both raise without CUDA; with device="cpu" both build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eph = EphemeralDatastore()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            AggregationJobDriver(eph.datastore, None)
        with pytest.raises(RuntimeError, match="CUDA"):
            DapHttpApp(Aggregator(eph.datastore))
        assert AggregationJobDriver(eph.datastore, None, device="cpu").device == torch.device("cpu")
        assert DapHttpApp(Aggregator(eph.datastore, device="cpu")).agg.device == torch.device("cpu")
    finally:
        eph.cleanup()


def test_driver_maps_no_device_failure_to_a_fallback():
    """No device failure moves work to a fallback (the port has no host
    engine to serve a retry): handle_step_error steps a hung or a refused
    dispatch back (tests/test_torch_device_watchdog.py) and fails the step
    on any other device error; the driver takes resident mode, and the
    resident route falls back to the classic accumulate on memory
    exhaustion only: any other error out of aggregate_pending, a hang
    included, fails the step."""
    from types import SimpleNamespace

    from janus_tpu_torch.aggregator.device_watchdog import DeviceHangError

    src = inspect.getsource(AggregationJobDriver.handle_step_error)
    assert "host" not in src.lower()
    eph = EphemeralDatastore()
    try:
        res = AggregationJobDriver(
            eph.datastore, None, AggregationJobDriverConfig(resident=ResidentConfig(enabled=True)), device="cpu"
        )
        assert res.cfg.resident.enabled

        def pending_raising(exc):
            def aggregate_pending(*a, **kw):
                raise exc

            eng = SimpleNamespace(aggregate_pending=aggregate_pending, note_classic_fallback=lambda: None)
            task = TaskBuilder(QueryTypeConfig.time_interval(), VdafInstance.count(), Role.LEADER).build()
            wire = SimpleNamespace(sparse=False)
            return SimpleNamespace(task=task, engine=eng, accept=np.ones(1, bool), out0=None, block_idx=None,
                                   wire=wire, acquired=SimpleNamespace(job_id="job"))

        md = [SimpleNamespace(report_id=None, time=Time(3600))]
        with pytest.raises(RuntimeError, match="illegal memory access"):
            res._device_accumulate_resident(pending_raising(RuntimeError("CUDA error: an illegal memory access")),
                                            md, b"bid")
        assert res.classic_fallbacks == 0
        with pytest.raises(DeviceHangError):
            res._device_accumulate_resident(pending_raising(DeviceHangError("aggregate_pending", 1.0)), md, b"bid")
        assert res.classic_fallbacks == 0
        assert res._device_accumulate_resident(pending_raising(torch.cuda.OutOfMemoryError("out of memory")),
                                               md, b"bid") is False
        assert res.classic_fallbacks == 1
        drv = AggregationJobDriver(eph.datastore, None, device="cpu")
        # a device failure is not a step-back: it fails the step
        assert drv.handle_step_error(None, RuntimeError("CUDA error: an illegal memory access")) is False
        assert drv.handle_step_error(None, torch.cuda.OutOfMemoryError("out of memory")) is False
    finally:
        eph.cleanup()


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 3), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        keccak_cuda.keccak_ctr_blocks([(0, meta)], 3, 2, 1, 2, meta.device)
    with pytest.raises(ValueError):
        keccak_cuda.keccak_tree_level([(0, meta)], 3, 2, 0, 24, meta.device)
    with pytest.raises(ValueError):  # a part on another device than the launch's
        keccak_cuda.keccak_ctr_blocks([(0, meta)], 3, 2, 1, 2, "cpu")
    with pytest.raises(ValueError):
        expand_cuda.expand_f128(torch.empty((2, 4), dtype=torch.int64, device="meta"), 2, 10)
    with pytest.raises(ValueError):
        sponge_cuda.keccak_sponge(torch.empty((3, 4), dtype=torch.int64, device="meta"), 32, out_lanes=2)
    acc = (torch.empty(8, dtype=torch.int64, device="meta"),) * 2
    rows = (torch.empty((2, 4), dtype=torch.int64, device="meta"),) * 2
    with pytest.raises(ValueError):
        scatter_cuda.scatter_rows(acc, rows, torch.empty((2, 4), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("kind", ["count", "sumvec", "draft-count", "draft-sumvec", "sparse"])
def test_cpu_run_leaves_launch_counters_at_zero(kind):
    mode = "draft" if kind.startswith("draft") else "fast"
    if kind.endswith("count"):
        inst = VdafInstance("count", xof_mode=mode)
    elif kind == "sparse":
        inst = VdafInstance.sparse_sumvec(2, 12, 2, 2)
    else:
        inst = VdafInstance("sumvec", bits=2, length=3, xof_mode=mode)
    counters = (keccak_cuda.keccak_single_block, expand_cuda.expand_f128, sponge_cuda.keccak_sponge,
                scatter_cuda.scatter_rows)
    for fn in counters:
        fn.launches = 0
    meas = random_measurements(inst, 3, np.random.default_rng(1))
    args, _ = make_report_batch(inst, meas, seed=2, device="cpu")
    p3 = prio3_batched(inst, "cpu")
    if kind == "sparse":
        # the compact prepare, then each party's scatter into the logical vector
        eng = EngineCache(inst, bytes(16), device="cpu")
        nonce, parts, lmeas, lproof, b0, seeds, b1 = args
        out0, _, ver0, part0 = eng.leader_init(nonce, parts, lmeas, lproof, b0)
        out1, accept, _ = eng.helper_init(nonce, parts, seeds, b1, ver0, part0, np.ones(3, dtype=bool))
        assert accept.all()
        flat = flat_scatter_indices(sparse_compact_batch(inst, meas)[1], p3.circ)
        shares = [eng.aggregate_sparse(out, accept, flat) for out in (out0, out1)]
        want = [0] * 12
        for m in meas:
            for b, vals in m:
                for o, v in enumerate(vals):
                    want[2 * b + o] += v
        assert [(a + b) % p3.tf.MODULUS for a, b in zip(*shares)] == want
    else:
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device="cpu")(*args)
        assert int(count) == 3
        assert [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))] == list(
            np.asarray(meas).sum(axis=0).reshape(-1)
        )
    assert [fn.launches for fn in counters] == [0, 0, 0, 0]


def test_host_prio3_shards_and_has_no_prepare():
    """A client's host sharder and the collector's unshard, and nothing an
    aggregator could prepare or aggregate with: the aggregators' prepare
    runs only on the device engines, and a sparse aggregate only on the
    scatter kernel."""
    p3 = prio3_host(VdafInstance.sum_vec(3, 2))
    assert isinstance(p3, Prio3) and callable(p3.shard) and callable(p3.unshard)
    for name in ("prepare_init", "prepare_next", "prepare_shares_to_prep", "aggregate"):
        assert not hasattr(Prio3, name), name
    sparse = prio3_host(VdafInstance.sparse_sumvec(2, 8, 2, 2))
    assert isinstance(sparse, Prio3Sparse) and callable(sparse.shard) and callable(sparse.unshard)
    for name in ("prepare_init", "aggregate", "aggregate_sparse"):
        assert not hasattr(sparse, name), name


def test_upload_journal_is_armed_and_poplar1_client_is_ported(tmp_path):
    """A set upload_journal_path arms the journal (the report writer spills
    to it, its replayer thread runs) and no path leaves it off; the
    Poplar1 client shards with the host Poplar1 and its wire codecs."""
    from janus_tpu_torch.ingest.journal import JournalReplayer, UploadJournal

    eph = EphemeralDatastore()
    try:
        agg = Aggregator(eph.datastore, cfg=Config(upload_journal_path=str(tmp_path / "journal")), device="cpu")
        try:
            assert isinstance(agg.upload_journal, UploadJournal) and agg.report_writer.journal is agg.upload_journal
            assert isinstance(agg.journal_replayer, JournalReplayer) and agg.journal_replayer._thread is not None
        finally:
            agg.close()
        plain = Aggregator(eph.datastore, device="cpu")
        assert plain.upload_journal is None and plain.journal_replayer is None and plain.report_writer.journal is None
        plain.close()
    finally:
        eph.cleanup()
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.messages import Duration
    from janus_tpu_torch.vdaf import poplar1

    kp = generate_hpke_config_and_private_key(config_id=1)
    params = ClientParameters(TaskId(bytes(32)), "http://leader/", "http://helper/", Duration(3600))
    client = Client(params, VdafInstance.poplar1(4), kp.config, kp.config)
    assert client.prio3 is None and isinstance(client.poplar, poplar1.Poplar1)
    report = client.prepare_report(0b1010)
    assert len(poplar1.decode_public_share(4, report.public_share)) == 4


def test_poplar1_collector_and_parameterized_collection_are_not_ported():
    """Both are ported: the collector unshards in the
    parameter's field, and the collection job driver creates param-scoped
    aggregation jobs of at most 512 reports over the batch interval, then
    waits until none of them is in progress."""
    from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver
    from janus_tpu_torch.collector import Collector
    from janus_tpu_torch.datastore.models import (
        AggregationJobState,
        CollectionJobModel,
        CollectionJobState,
        LeaderStoredReport,
    )
    from janus_tpu_torch.messages import CollectionJobId, HpkeCiphertext, HpkeConfigId, Interval, ReportId
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggParam

    poplar = VdafInstance("poplar1", bits=4)
    assert Collector(None, poplar, None).prio3 is None
    task = TaskBuilder(QueryTypeConfig.time_interval(), poplar, Role.LEADER).build()
    eph = EphemeralDatastore()
    try:
        ds = eph.datastore
        start = Time(1_700_000_000).to_batch_interval_start(task.time_precision)
        ct = HpkeCiphertext(HpkeConfigId(1), b"k", b"p")
        ds.run_tx(lambda tx: [tx.put_task(task)] + [
            tx.put_client_report(LeaderStoredReport(task.task_id, ReportId(i.to_bytes(16, "big")), start, b"", b"x", ct))
            for i in range(513)
        ])
        param = Poplar1AggParam(0, (0, 1)).encode()
        job = CollectionJobModel(task.task_id, CollectionJobId(bytes(16)), b"", param,
                                 Interval(start, task.time_precision).to_bytes(), CollectionJobState.START)
        driver = CollectionJobDriver(ds, None)
        assert driver._ensure_param_aggregation(task, job) is False  # jobs made: not ready
        jobs = ds.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(task.task_id))
        sizes = sorted(len(ds.run_tx(lambda tx: tx.get_report_aggregations_for_job(task.task_id, j.job_id))) for j in jobs)
        assert sizes == [1, 512] and {j.aggregation_parameter for j in jobs} == {param}
        assert driver._ensure_param_aggregation(task, job) is False  # still in progress
        ds.run_tx(lambda tx: [tx.update_aggregation_job(j.with_state(AggregationJobState.FINISHED)) for j in jobs])
        assert driver._ensure_param_aggregation(task, job) is True
        assert len(ds.run_tx(lambda tx: tx.get_aggregation_jobs_for_task(task.task_id))) == 2  # none added
    finally:
        eph.cleanup()
