"""janus_tpu_torch's multi-device serving held against janus_tpu's mesh.

The port drives a dp x sp grid of devices from one process, as janus_tpu
does; here the grid is `["cpu"] * n` (a device may repeat), and janus_tpu
runs on the eight virtual XLA devices of tests/conftest.py.

- `choose_mesh_geometry` equals janus_tpu's over a grid of device counts
  and vector shapes, and over the overrides of tests/test_mesh_dispatch.py.
- `make_mesh` lays a grid out row-major and raises without devices and
  without CUDA, as does an engine built with neither.
- `sharded_two_party_step` at (dp, sp) = (4, 1) and (2, 2) equals the
  port's single-device step (Count and draft Count at 3 Keccak rounds at
  (4, 1), SumVec at both, Histogram at (2, 2)) and `janus_tpu.parallel.api.jit_two_party_step` on a
  mesh: Count and draft Count at (4, 1), SumVec at (2, 2);
  `sharded_helper_init_step` equals the single-device helper step.
  janus_tpu's program of a circuit with joint randomness (SumVec,
  Histogram) takes 12-27 s to compile on the CPU at any geometry, a
  Count's about a second, so the file builds one such program, SumVec's
  at (2, 2); Histogram is held against the port's single-device step,
  which tests/test_torch_prio3.py and the draft tests hold against
  janus_tpu.
- A mesh `EngineCache` serves like the single-device one: helper init,
  leader init direct and prestaged, masked aggregates with rejected
  lanes, aggregate_pending, resident merge and take, at (4, 1) on Count
  and at (2, 2) on SumVec (column-sharded resident slots). On Count it
  also serves like janus_tpu's (4, 1) mesh engine; on both, geometry and
  fallback reason agree with janus_tpu's engine (built, not served: a
  SumVec engine's programs would cost tens of seconds). A block-sparse task stays
  on one device. Cap and ladder floor at dp, a chunked batch past the cap,
  a merged cross-task round, the canary probe through the mesh, the
  lane's thread, and a shard that fails: it raises, nothing is retried.
- `MeshDispatchQueue` keeps the contract of tests/test_mesh_dispatch.py:
  one lane with no overlap and no starvation, an error that reaches the
  caller while the lane survives, FIFO order when backlogged.
- A port helper on a `["cpu"] * 4` mesh answers a janus_tpu leader over
  loopback HTTP, and the collection equals the ground truth.

Tolerance: exact equality.
"""

import threading
import time

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import engine_cache as j_ec
from janus_tpu.parallel import api as j_api
from janus_tpu.vdaf import keccak_jax as kj
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.aggregator.engine_cache import EngineCache, MeshDispatchQueue, MeshRows, mesh_status
from janus_tpu_torch.convert import from_numpy_u64, step_args_to_numpy, to_numpy_u64
from janus_tpu_torch.messages import Duration, Interval, Time
from janus_tpu_torch.ops import cuda_build, keccak_cuda
from janus_tpu_torch.parallel import api as t_api
from janus_tpu_torch.vdaf import keccak as tk
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import testing as t_testing

CPU = torch.device("cpu")
VK = bytes(range(16))
IV = Interval(Time(0), Duration(3600))
BATCH = 32
BAD_ROW = 3


def _insts(kind, **kw):
    return j_registry.VdafInstance(kind, **kw), t_registry.VdafInstance(kind, **kw)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """An empty engine cache, shared coalescers and resident ledger around
    each test; janus_tpu's geometry comes from the test alone."""
    monkeypatch.delenv("JANUS_MESH_DP", raising=False)
    monkeypatch.delenv("JANUS_MESH_SP", raising=False)
    t_ec.engine_cache.cache_clear()
    yield
    t_ec.engine_cache.cache_clear()


# --- geometry ---------------------------------------------------------------

GRID = [
    (ndev, il, ol, 4096, 32, None, None)
    for ndev in range(1, 9)
    for il, ol in ((2, 1), (8192, 8192), (8191, 8191))
]
OVERRIDES = [
    (1, 2, 1, 4096, 32, None, None),
    (6, 2, 1, 4096, 32, None, None),
    (8, 8192, 8192, 4096, 32, None, None),
    (8, 2, 1, 4096, 32, 3, None),
    (4, 8, 8, 4096, 32, 4, 2),
    (8, 7, 7, 0, 32, None, 2),
    (8, 8192, 8192, 4096, 2, None, None),
    (2, 8, 8, 0, 32, 2, 4),
    (3, 8, 8, 0, 32, None, 4),
    (8, 2, 1, 0, 32, 1, 1),
    (8, 16, 16, 0, 32, 16, None),
]


@pytest.mark.parametrize("case", GRID + OVERRIDES, ids=lambda c: "-".join(map(str, c)))
def test_choose_mesh_geometry_matches_janus_tpu(case):
    *pos, dp, sp = case
    assert t_api.choose_mesh_geometry(*pos, dp=dp, sp=sp) == j_api.choose_mesh_geometry(*pos, dp=dp, sp=sp)


def test_make_mesh_lays_devices_out_row_major(monkeypatch):
    mesh = t_api.make_mesh(2, 2, ["cpu"] * 5)
    assert mesh.shape == (2, 2) and mesh.axis_names == ("dp", "sp")
    assert mesh.devices == (CPU,) * 4 and not mesh.distinct
    assert mesh.row(1) == (CPU, CPU) and mesh.device(1, 1) == CPU and mesh.first == CPU
    with pytest.raises(ValueError):
        t_api.make_mesh(4, 2, ["cpu"] * 4)
    # no devices named and no CUDA: refused, as resolve_device refuses
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCache(t_registry.VdafInstance.count(), VK)


def test_shard_scope_attributes_launches_to_shards():
    def probe_kernel():
        pass

    probe_kernel.launches = 0
    cuda_build.reset_shard_launches()
    cuda_build.count_launch(probe_kernel)
    for i in (0, 1, 1):
        with cuda_build.shard_scope(i):
            cuda_build.count_launch(probe_kernel)
    assert probe_kernel.launches == 4
    assert keccak_cuda.keccak_single_block.__name__ == "keccak_single_block"
    assert cuda_build.shard_launches()["probe_kernel"] == {0: 1, 1: 2}
    cuda_build.reset_shard_launches()


# --- the sharded two-party step -------------------------------------------


def _bump(field, row: int, modulus: int):
    """A field value (numpy limbs) with element [row, 0] plus one."""
    v = (sum(int(x[row, 0]) << (64 * i) for i, x in enumerate(field)) + 1) % modulus
    out = tuple(x.copy() for x in field)
    for i, y in enumerate(out):
        y[row, 0] = np.uint64((v >> (64 * i)) & ((1 << 64) - 1))
    return out


def _batch(t_inst, n: int, seed: int, bad_row=None):
    """Numpy step args made by the port's sharder; the leader's proof of
    `bad_row` corrupted."""
    meas = t_testing.random_measurements(t_inst, n, np.random.default_rng(seed))
    args, m = t_testing.make_report_batch(t_inst, meas, seed=seed, device=CPU)
    args = list(step_args_to_numpy(args))
    if bad_row is not None:
        args[3] = _bump(args[3], bad_row, t_registry.prio3_batched(t_inst, CPU).tf.MODULUS)
    return tuple(args), m


def _tensors(args):
    return tuple(
        None if a is None else tuple(from_numpy_u64(x, CPU) for x in a) if isinstance(a, tuple)
        else from_numpy_u64(a, CPU)
        for a in args
    )


def _ints(value):
    """Lanes, masks or field limbs (tensors, numpy or JAX arrays, limb
    tuples) as nested lists of Python ints."""
    if value is None:
        return None
    if isinstance(value, tuple):
        return [_ints(x) for x in value]
    a = to_numpy_u64(value) if isinstance(value, torch.Tensor) else np.asarray(value)
    return [int(x) for x in a.ravel()]


@pytest.fixture
def draft_rounds(monkeypatch):
    """Both packages' sponges at 3 rounds; janus_tpu's engines, which bake
    the round count into their jitted programs, made afresh around it."""
    monkeypatch.setattr(kj, "KECCAK_ROUNDS", 3)
    monkeypatch.setattr(tk, "KECCAK_ROUNDS", 3)
    j_registry.prio3_batched.cache_clear()
    yield
    j_registry.prio3_batched.cache_clear()


# (circuit, janus_tpu's mesh or None, the port's geometries)
STEP_CASES = {
    "count": (("count", {}), (4, 1), [(4, 1)]),
    "sumvec": (("sumvec", {"length": 2, "bits": 1}), (2, 2), [(4, 1), (2, 2)]),
    "histogram": (("histogram", {"length": 2}), None, [(2, 2)]),
    "draft-count": (("count", {"xof_mode": "draft"}), (4, 1), [(4, 1)]),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_two_party_step_matches_janus_tpu_mesh(case, request):
    (kind, kw), j_geom, geoms = STEP_CASES[case]
    if kw.get("xof_mode") == "draft":
        request.getfixturevalue("draft_rounds")
    j_inst, t_inst = _insts(kind, **kw)
    args, _ = _batch(t_inst, BATCH, 11, bad_row=BAD_ROW)
    port_in = _tensors(args)
    single = t_api.two_party_step(t_inst, VK, device=CPU)(*port_in)
    want = (_ints(single[0]), _ints(single[1]), int(single[2]))
    if j_geom is not None:
        j_out = j_api.jit_two_party_step(j_inst, VK, j_api.make_mesh(*j_geom))(*args)
        assert want == (_ints(tuple(j_out[0])), _ints(tuple(j_out[1])), int(j_out[2]))
    assert want[2] == BATCH - 1
    h_single = t_api.helper_init_step(t_inst, VK, device=CPU)(port_in[0], port_in[1], port_in[5], port_in[6])
    for dp, sp in geoms:
        mesh = t_api.make_mesh(dp, sp, ["cpu"] * (dp * sp))
        agg0, agg1, count = t_api.sharded_two_party_step(t_inst, VK, mesh)(*port_in)
        assert (_ints(agg0), _ints(agg1), int(count)) == want, (dp, sp)
        h_mesh = t_api.sharded_helper_init_step(t_inst, VK, mesh)(port_in[0], port_in[1], port_in[5], port_in[6])
        assert [_ints(x) for x in h_mesh] == [_ints(x) for x in h_single], (dp, sp)


def test_sharded_step_refuses_columns_sp_cannot_split():
    mesh = t_api.make_mesh(2, 2, ["cpu"] * 4)
    with pytest.raises(ValueError):
        t_api.sharded_two_party_step(t_registry.VdafInstance.count(), VK, mesh)


# --- the mesh engine ------------------------------------------------------


class TSP(EngineCache):
    """The port's engine with the vector axis from any length."""

    SP_MIN_INPUT_LEN = 1


class JSP(j_ec.EngineCache):
    """janus_tpu's engine with the vector axis from any length."""

    SP_MIN_INPUT_LEN = 1


def _serve(eng, args, n: int, k: int = 2):
    """One serving round through an engine's entry points: a prestaged
    leader init, a direct one, the helper init, both parties' masked
    aggregates with rejected lanes, two jobs' pending sums merged into
    resident slots, and the take. Elements as Python ints."""
    nonce, parts, meas, proof, blind0, hseed, blind1 = args
    ok = np.ones(n, dtype=bool)
    ok[::5] = False
    pre = eng.prestage_leader(nonce, parts, meas, proof, blind0)
    out0, seed0, ver0, part0 = eng.leader_init(nonce, parts, meas, proof, blind0, prestaged=pre)
    direct = eng.leader_init(nonce, parts, meas, proof, blind0)
    p0 = part0 if part0 is not None else np.zeros((n, 2), dtype=np.uint64)
    out1, mask, prep = eng.helper_init(nonce, parts, hseed, blind1, ver0, p0, ok)
    buckets = (np.arange(n) % k).astype(np.int32)
    for out in (out0, out1):
        deltas = eng.aggregate_pending(out, np.where(ok, buckets, -1).astype(np.int32), k)
        eng.resident_merge([(("g", j), j, n // k, IV) for j in range(k)], deltas)
    return {
        "leader": [_ints(x) for x in (seed0, ver0, part0) if x is not None],
        "direct": [_ints(x) for x in direct[1:] if x is not None],
        "out0": _ints(out0.to_numpy()),
        "helper": (_ints(mask), _ints(prep)),
        "agg": (eng.aggregate(out0, ok), eng.aggregate(out1, ok)),
        "resident": sorted((str(r["key"]), [int(x) for x in r["share"]]) for r in eng.resident_take()),
    }


# (circuit, geometry, whether janus_tpu's engine serves too: its
# programs for a circuit with joint randomness compile for tens of
# seconds on the CPU)
ENGINE_CASES = {"count": (("count", {}), (4, 1), True),
                "sumvec": (("sumvec", {"length": 2, "bits": 1}), (2, 2), False)}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mesh_engine_serves_like_single_device_and_janus_tpu_mesh(case, monkeypatch):
    (kind, kw), geom, j_serves = ENGINE_CASES[case]
    j_inst, t_inst = _insts(kind, **kw)
    args, _ = _batch(t_inst, 40, 5, bad_row=7)
    monkeypatch.setenv("JANUS_MESH_DP", str(geom[0]))
    monkeypatch.setenv("JANUS_MESH_SP", str(geom[1]))
    j_eng = JSP(j_inst, VK)
    t_eng = TSP(t_inst, VK, devices=["cpu"] * 4)
    assert (t_eng.dp, t_eng.sp) == (j_eng.dp, j_eng.sp) == geom
    assert t_eng.mesh_fallback_reason is j_eng.mesh_fallback_reason is None
    assert t_eng.mesh.shape == geom and t_eng.engine_status()["sharded_resident"] == (geom[1] > 1)
    got = _serve(t_eng, args, 40)
    assert got == _serve(TSP(t_inst, VK, device="cpu"), args, 40)
    if j_serves:
        assert got == _serve(j_eng, args, 40)
    assert t_eng.prestage_stats["used"] == 1


def test_sparse_task_stays_on_one_device():
    kw = {"bits": 2, "length": 48, "block_size": 4, "max_blocks": 3}
    j_inst, t_inst = _insts("sparse_sumvec", **kw)
    t_eng = EngineCache(t_inst, VK, devices=["cpu"] * 4)
    j_eng = j_ec.EngineCache(j_inst, VK)
    assert (t_eng.dp, t_eng.sp, t_eng.mesh) == (j_eng.dp, j_eng.sp, j_eng.mesh) == (1, 1, None)
    assert t_eng.mesh_fallback_reason == j_eng.mesh_fallback_reason == "sparse_scatter_single_device"


def test_mesh_engine_cap_floor_chunks_and_rounds():
    """The cap is at least dp; the memory ladder halves from the failed
    bucket down to dp and raises there; a batch past the cap runs in
    cap-sized mesh dispatches; a round that merges two tasks' inits on a
    mesh equals each task's own init; a single-device prestage is no use
    to a mesh engine."""
    eng = EngineCache(t_registry.VdafInstance.count(), VK, devices=["cpu"] * 4, bucket_cap=2)
    assert (eng.dp, eng.sp, eng.bucket_cap) == (4, 1, 4)

    def oom(bucket):
        try:
            e = torch.cuda.OutOfMemoryError("injected")
            e._janus_dispatch_bucket = bucket
            raise e
        except torch.cuda.OutOfMemoryError as err:
            eng._handle_engine_error(err, bucket)

    eng.bucket_cap = 16
    oom(16)
    assert eng.bucket_cap == 8
    oom(8)
    assert eng.bucket_cap == 4
    with pytest.raises(torch.cuda.OutOfMemoryError):
        oom(4)  # the floor: dp rows
    assert eng.oom_history[-1]["action"] == "raised"
    inst = t_registry.VdafInstance.sum_vec(length=2, bits=1)
    # past the cap: 70 rows in cap-sized dispatches
    args, _ = _batch(inst, 70, 9, bad_row=1)
    capped = TSP(inst, VK, devices=["cpu"] * 4, bucket_cap=32)
    assert _serve(capped, args, 70) == _serve(TSP(inst, VK, device="cpu"), args, 70)
    # a merged round of two tasks on one mesh
    other = TSP(inst, bytes(range(16, 32)), devices=["cpu"] * 4)
    single = [TSP(inst, e.verify_key, device="cpu") for e in (capped, other)]
    cut = [tuple(None if a is None else tuple(x[s:e] for x in a) if isinstance(a, tuple) else a[s:e]
                 for a in args[:5]) for s, e in ((0, 8), (8, 20))]
    res = t_ec._run_leader_round([(capped, None, *cut[0]), (other, None, *cut[1])], [8, 12])
    assert capped.coalesce_stats["merged_rounds"] == 1 and isinstance(res[0][0], MeshRows)
    for got, eng_s, c in zip(res, single, cut):
        want = eng_s._leader_init_inner(*c)
        ok = np.ones(got[0].n, dtype=bool)
        ok[1] = False
        assert _ints(got[0].to_numpy()) == _ints(want[0].to_numpy())
        assert _ints(got[2]) == _ints(want[2])
        assert capped.aggregate(got[0], ok) == eng_s.aggregate(want[0], ok)
    pre = single[0].prestage_leader(*args[:5])
    other.leader_init(*args[:5], prestaged=pre)
    assert not pre.meshed and other.prestage_stats["discarded"] == 1


def test_mesh_engine_lane_canary_status_and_failed_shard(monkeypatch):
    """Every mesh enqueue runs on the `mesh-dispatch` thread; the canary
    probes through the mesh; the status reports the geometry; a shard that
    fails raises in the caller, the lane lives on, and nothing is retried
    on fewer devices."""
    lane = MeshDispatchQueue()
    monkeypatch.setattr(t_ec, "_MESH_QUEUE", lane)
    inst = t_registry.VdafInstance.count()
    eng = t_ec.engine_cache(inst, VK, devices=["cpu"] * 4)
    assert eng._on_lane("probe", lambda: threading.current_thread().name) == "mesh-dispatch"
    eng._canary_probe()
    snap = mesh_status()
    (ent,) = snap["engines"]
    assert (ent["dp"], ent["sp"], ent["mesh"], ent["distinct_devices"], ent["fallback_reason"]) == (
        4, 1, True, False, None)
    assert snap["queue"]["submitted"] >= 2 and snap["queue"]["lane_alive"]

    args, _ = _batch(inst, BATCH, 13)
    nonce, parts, meas, proof, blind0, hseed, blind1 = args
    ver0 = eng.leader_init(nonce, parts, meas, proof, blind0)[2]
    ok = np.ones(BATCH, dtype=bool)
    calls = []
    real = t_ec._helper_step

    def failing(p3, *a):
        shard = cuda_build._shard.index
        calls.append(shard)
        if shard == 1:
            raise RuntimeError("shard 1 failed")
        return real(p3, *a)

    monkeypatch.setattr(t_ec, "_helper_step", failing)
    errors = lane.status()["errors"]
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        eng.helper_init(nonce, parts, hseed, blind1, ver0, np.zeros((BATCH, 2), np.uint64), ok)
    assert calls == [0, 1]  # no retry, on the mesh or elsewhere
    assert lane.status()["errors"] == errors + 1 and lane.status()["lane_alive"]
    monkeypatch.setattr(t_ec, "_helper_step", real)
    _, mask, _ = eng.helper_init(nonce, parts, hseed, blind1, ver0, np.zeros((BATCH, 2), np.uint64), ok)
    assert mask.sum() == BATCH


# --- the dispatch lane itself (no device work) ------------------------------


def test_mesh_dispatch_queue_single_lane_no_overlap_no_starvation():
    q = MeshDispatchQueue()
    lanes, executed, overlaps, errors = set(), [], [], []
    busy = threading.Event()
    results = {}

    def work(tag):
        if busy.is_set():
            overlaps.append(tag)
        busy.set()
        try:
            lanes.add(threading.current_thread().name)
            executed.append(tag)
            time.sleep(0.001)
        finally:
            busy.clear()
        return tag * 2

    def submitter(base):
        try:
            for j in range(5):
                tag = base * 100 + j
                results[tag] = q.submit(work, tag)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "submitter starved"
    assert not errors and not overlaps
    assert lanes == {"mesh-dispatch"} and len(executed) == 20
    assert results == {t: t * 2 for t in executed}
    st = q.status()
    assert (st["submitted"], st["completed"], st["errors"], st["depth"]) == (20, 20, 0, 0)
    assert st["lane_alive"] is True and st["busy_s"] > 0


def test_mesh_dispatch_queue_exception_propagates_and_lane_survives():
    q = MeshDispatchQueue()

    class Boom(RuntimeError):
        pass

    boom = Boom("injected")

    def bad():
        raise boom

    with pytest.raises(Boom) as ei:
        q.submit(bad)
    assert ei.value is boom  # the same object: the memory ladder marks it
    assert q.status()["errors"] == 1
    assert q.submit(lambda: 7) == 7
    assert q.status()["completed"] == 2
    q.reset_for_tests()
    assert q.status()["submitted"] == 0 and q.status()["lane_alive"]


def test_mesh_dispatch_queue_fifo_order_when_backlogged():
    q = MeshDispatchQueue()
    order = []
    gate = threading.Event()

    def blocker():
        gate.wait(30)
        order.append("blocker")

    t0 = threading.Thread(target=q.submit, args=(blocker,))
    t0.start()
    for _ in range(200):
        if q.status()["depth"] == 0 and q.status()["submitted"] == 1:
            break
        time.sleep(0.005)
    backlog = []
    for i in range(6):
        th = threading.Thread(target=q.submit, args=(order.append, i))
        th.start()
        backlog.append(th)
        for _ in range(400):  # each racer counted before the next starts
            if q.status()["submitted"] >= 2 + i:
                break
            time.sleep(0.005)
    gate.set()
    t0.join(timeout=30)
    for th in backlog:
        th.join(timeout=30)
    assert order == ["blocker", 0, 1, 2, 3, 4, 5]
    assert q.status()["max_depth"] >= 6


# --- over HTTP: a janus_tpu leader, a port helper on a mesh -----------------


def test_port_mesh_helper_answers_janus_tpu_leader_and_collects(monkeypatch):
    from test_torch_multi_round import PKG, Pairing, make_tasks, prepare_reports, query_for

    from janus_tpu_torch.aggregator import core as t_core

    monkeypatch.setenv("JANUS_MESH_DP", "1")  # janus_tpu's leader on one device
    monkeypatch.setenv("JANUS_MESH_SP", "1")
    monkeypatch.setattr(PKG["torch"], "aggregator", lambda eph: t_core.Aggregator(
        eph.datastore, eph.clock, t_core.Config(), devices=["cpu"] * 4))
    measurements = [int(x) for x in np.random.default_rng(21).integers(0, 2, 64)]
    tasks = make_tasks(j_registry.VdafInstance.count())
    pair = Pairing(monkeypatch, "jax", "torch", *tasks)
    try:
        pair.upload(prepare_reports(tasks[0], tasks[1], measurements))
        assert pair.create_jobs() >= 1
        jobs = pair.agg_jobs()
        while jobs.run_once():
            pass
        helper_engine = pair.h_agg.task_aggregator_for(pair.helper_task.task_id).engine
        assert (helper_engine.dp, helper_engine.sp) == (4, 1) and helper_engine.mesh is not None
        m = pair.lp.m
        job_id = pair.collector("jax").start_collection(query_for(m)).data
        assert pair.collection_jobs().run_once() == 1
        results = pair.poll_all(job_id)
        (count, _, result), = set(results.values())
        assert (count, result) == (64, sum(measurements))
    finally:
        pair.close()


def test_rehearse_chip_smoke_mesh_phase(monkeypatch):
    """chip_smoke.py's mesh phase on the CPU: SumVec(4, 2) at 32 reports on
    a [cpu, cpu] mesh, and the sharded step of SumVec(8, 2) at 8 reports
    with the vector axis lowered, so that two devices choose dp = 1,
    sp = 2, held against the single-device step's outputs."""
    import chip_smoke

    sumvec = chip_smoke.phase_mesh(torch, CPU, t_registry.VdafInstance.sum_vec(4, 2), 32, (5, 20, 30))
    assert sumvec["distinct_devices"] is False and sumvec["devices"] == ["cpu", "cpu"]
    assert (sumvec["dp"], sumvec["sp"], sumvec["accepted"], sumvec["max_abs_err"]) == (2, 1, 29, 0)
    assert sumvec["turn_order"] == ["single", "mesh", "mesh", "single"]
    assert [len(sumvec["serve_s"][k]) for k in ("single", "mesh")] == [2, 2]
    assert not any(sumvec["launches"].values())  # the CPU launches no kernel
    assert sumvec["lane"]["lane_alive"] and sumvec["lane"]["errors"] == 0

    big = t_registry.VdafInstance.sum_vec(8, 2)
    args, _ = _batch(big, 8, 17, bad_row=3)
    port_in = _tensors(args)
    want = t_api.two_party_step(big, chip_smoke.VERIFY_KEY, device=CPU)(*port_in)
    monkeypatch.setattr(EngineCache, "SP_MIN_INPUT_LEN", 1)
    rec = chip_smoke.phase_mesh_step(torch, CPU, big, port_in, want, 1)
    assert (rec["dp"], rec["sp"], rec["accepted"], rec["max_abs_err"]) == (1, 2, 7, 0)
    with pytest.raises(AssertionError):  # a wrong reference fails the phase
        chip_smoke.phase_mesh_step(torch, CPU, big, port_in, (want[1], want[0], want[2]), 1)
