"""janus_tpu_torch's device-resident accumulators held against janus_tpu.

Mirrors tests/test_resident_accumulator.py on the port's engine and driver
(device="cpu"):

- engine: the resident path against the plaintext oracle and the classic
  per-bucket aggregate (fuzzed over seeds), several jobs merged into one
  slot, LRU eviction through the flush (never a drop), a merge that fails
  partway (only the unmerged rows flush), an eviction whose fetch fails
  (deferred, never counted twice), a failed take (state restored), the
  process LRU keeping engines with resident state, `would_coalesce`
  matching the entry routing, and a prestaged leader init equal to the
  unprestaged one and to janus_tpu's;
- `aggregate_buckets` and a slot's encoded bytes after three jobs equal
  janus_tpu's (janus_tpu's engine fed the port's out shares as host
  rows), dense (Count) and block-sparse (sparse_sumvec(2, 48, 4, 3),
  whose merge scatters through kernel 4's wrapper);
- driver: resident jobs over loopback HTTP against a port helper, the
  drain flush, then a collection equal to the ground truth; a failed
  commit merges nothing and the re-step merges once; the flush cadence
  shared with the background flusher; no flush while the datastore is
  down; a non-memory error of the resident accumulate fails the step,
  memory exhaustion takes the classic accumulate and is counted.

Left out: janus_tpu's two quarantine and host-engine cases
(`test_quarantine_mid_job_flushes_and_host_path_continues`,
`test_host_engine_leader_init_accepts_prestaged_kwarg`): the port has no
host engine. Its watchdog cases (the flush's fetch bound, a quarantined
engine's slots flushed, and kept until the restore when that fetch
hangs) are in tests/test_torch_device_watchdog.py. Tolerance: exact
equality.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import engine_cache as j_ec
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch.aggregator import aggregation_job_driver as t_adriver
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.aggregator.engine_cache import EngineCache, ResidentMergeError
from janus_tpu_torch.convert import step_args_to_numpy
from janus_tpu_torch.messages import Duration, Interval, Time
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import wire as t_wire
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements, sparse_compact_batch

from test_torch_engine_cache import jax_single_device
from test_torch_multi_round import PKG, Pairing, make_tasks, prepare_reports, query_for

CPU = torch.device("cpu")
VK = bytes(range(16))
IV = Interval(Time(0), Duration(3600))
SPARSE = {"bits": 2, "length": 48, "block_size": 4, "max_blocks": 3}


@pytest.fixture(scope="module")
def jax_ref():
    """janus_tpu's engines (one device): Count and the sparse circuit."""
    with jax_single_device():
        return {
            "count": j_ec.EngineCache(j_registry.VdafInstance.count(), VK),
            "sparse": j_ec.EngineCache(j_registry.VdafInstance("sparse_sumvec", **SPARSE), VK),
        }


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Each test starts with an empty engine cache, shared coalescers and
    resident ledger; janus_tpu's engines stay on one device."""
    monkeypatch.setenv("JANUS_MESH_DP", "1")
    monkeypatch.setenv("JANUS_MESH_SP", "1")
    t_ec.engine_cache.cache_clear()
    yield
    t_ec.engine_cache.cache_clear()


def _inst(kind):
    return {
        "count": t_registry.VdafInstance.count(),
        "histogram": t_registry.VdafInstance.histogram(length=6),
        "sumvec": t_registry.VdafInstance.sum_vec(length=4, bits=4),
        "sparse": t_registry.VdafInstance("sparse_sumvec", **SPARSE),
    }[kind]


def _batch(inst, n, rng, seed):
    meas = random_measurements(inst, n, rng)
    args, m = make_report_batch(inst, meas, seed=seed, device=CPU)
    return step_args_to_numpy(args), m


def _leader(eng, args):
    nonce, public, mv, proof, blind0 = args[:5]
    return eng.leader_init(nonce, public, mv, proof, blind0)


def _oracle(kind, m, lanes, length):
    if kind == "count":
        return [sum(int(m[i]) for i in lanes)]
    if kind == "histogram":
        out = [0] * length
        for i in lanes:
            out[int(m[i])] += 1
        return out
    return [sum(int(m[i][k]) for i in lanes) for k in range(length)]


# --- the engine ---


@pytest.mark.parametrize("kind,seed", [("count", 42), ("histogram", 42), ("sumvec", 42), ("sumvec", 7)])
def test_resident_matches_host_oracle_fuzz(kind, seed):
    """Random jobs with rejected lanes and two batch buckets through both
    parties' resident path: the taken shares equal the classic per-bucket
    aggregates summed, and leader + helper equals the plaintext."""
    inst = _inst(kind)
    eng = EngineCache(inst, VK, device="cpu")
    p = eng.p3.tf.MODULUS
    length = eng.p3.circ.output_len
    rng = np.random.default_rng(seed)
    keys = [b"bucket-a", b"bucket-b"]
    totals: dict[bytes, list[int]] = {}
    for trial in range(3):
        n = int(rng.integers(3, 9))
        args, m = _batch(inst, n, rng, 1000 + trial)
        nonce, public, mv, proof, blind0, seeds, blind1 = args
        out0, _, ver0, part0 = eng.leader_init(nonce, public, mv, proof, blind0)
        out1, ok, _ = eng.helper_init(nonce, public, seeds, blind1, ver0, part0, np.ones(n, dtype=bool))
        assert ok.all()
        lane_bucket = np.where(rng.random(n) > 0.3, rng.integers(0, 2, size=n), -1).astype(np.int32)
        pend = eng.aggregate_pending(out0, lane_bucket, 2)
        entries = [((b"task", b"", bid), j, int((lane_bucket == j).sum()), IV) for j, bid in enumerate(keys)]
        assert eng.resident_merge(entries, pend) == []
        for j, bid in enumerate(keys):
            classic = eng.aggregate(out0, lane_bucket == j)
            helper = eng.aggregate(out1, lane_bucket == j)
            lanes = [i for i in range(n) if lane_bucket[i] == j]
            assert [(a + b) % p for a, b in zip(classic, helper)] == [w % p for w in _oracle(kind, m, lanes, length)]
            tot = totals.setdefault(bid, [0] * length)
            totals[bid] = [(a + b) % p for a, b in zip(tot, classic)]
    recs = {r["key"][2]: r for r in eng.resident_take()}
    assert {k: r["share"] for k, r in recs.items()} == totals
    assert eng.resident_take() == []
    assert t_ec.resident_bytes_total() == 0


def test_multi_job_merge_accumulates_in_place():
    inst = _inst("count")
    eng = EngineCache(inst, VK, device="cpu")
    p = eng.p3.tf.MODULUS
    rng = np.random.default_rng(7)
    want = rows = 0
    for j in range(3):
        args, _ = _batch(inst, 5, rng, 2000 + j)
        out0, _, _, _ = _leader(eng, args)
        eng.resident_merge([((b"t", b"", b"bid"), 0, 5, IV)], eng.aggregate_pending(out0, np.zeros(5, np.int32), 1))
        want = (want + eng.aggregate(out0, np.ones(5, bool))[0]) % p
        rows += 5
    st = eng.resident_status()
    assert st["buffers"] == 1 and st["merges"] == 3 and st["merged_rows"] == 15
    (rec,) = eng.resident_take()
    assert rec["share"] == [want] and rec["rows"] == rows


def test_eviction_flushes_never_drops(monkeypatch):
    """Past RESIDENT_MAX_BYTES the LRU slot is evicted through the flush
    records, never dropped: the evicted plus the final take cover every
    contribution once."""
    inst = _inst("histogram")
    eng = EngineCache(inst, VK, device="cpu")
    monkeypatch.setattr(EngineCache, "RESIDENT_MAX_BYTES", eng.p3.circ.output_len * eng.p3.tf.LIMBS * 8)
    rng = np.random.default_rng(9)
    wants, flushed = {}, []
    for j, bid in enumerate([b"b0", b"b1", b"b2"]):
        args, _ = _batch(inst, 4, rng, 3000 + j)
        out0, _, _, _ = _leader(eng, args)
        pend = eng.aggregate_pending(out0, np.zeros(4, np.int32), 1)
        flushed.extend(eng.resident_merge([((b"t", b"", bid), 0, 4, IV)], pend))
        wants[bid] = eng.aggregate(out0, np.ones(4, bool))
    assert len(flushed) == 2 and eng.resident_status()["evictions"] == 2
    got = {r["key"][2]: r["share"] for r in flushed + eng.resident_take()}
    assert got == wants


def test_partial_merge_failure_flushes_only_unmerged(monkeypatch):
    """A merge that dies partway leaves its merged prefix on the card:
    ResidentMergeError carries those keys, and the driver's recovery
    flushes only the rest."""
    inst = _inst("count")
    eng = EngineCache(inst, bytes(range(48, 64)), device="cpu")
    rng = np.random.default_rng(31)
    n = 4
    k0, k1 = (b"t", b"", b"k0"), (b"t", b"", b"k1")
    args, _ = _batch(inst, n, rng, 500)
    out_a, _, _, _ = _leader(eng, args)
    eng.resident_merge([(k1, 0, n, IV)], eng.aggregate_pending(out_a, np.zeros(n, np.int32), 1))
    args2, _ = _batch(inst, n, rng, 501)
    out_b, _, _, _ = _leader(eng, args2)
    idx = np.array([0, 0, 1, 1], np.int32)
    pend = eng.aggregate_pending(out_b, idx, 2)

    def boom(acc, row):
        raise RuntimeError("wedged add")

    monkeypatch.setattr(eng, "_resident_add", boom)
    driver = t_adriver.AggregationJobDriver(None, None, device="cpu")
    flushed = []
    monkeypatch.setattr(driver, "flush_resident_records",
                        lambda engine, recs, reason: flushed.append((reason, recs)) or len(recs))
    st = SimpleNamespace(engine=eng, resident_delta=pend, resident_entries=[(k0, 0, 2, IV), (k1, 1, 2, IV)],
                         resident_rids=[b"r0", b"r1"], acquired=SimpleNamespace(job_id="job-x"))
    driver._resident_post_commit(st, set())
    ((reason, recs),) = flushed
    assert reason == "merge_failed" and [r["key"] for r in recs] == [k1]
    assert recs[0]["share"] == eng.aggregate(out_b, idx == 1)
    got = {r["key"]: r["share"] for r in eng.resident_take()}
    assert got[k1] == eng.aggregate(out_a, np.ones(n, bool))
    assert got[k0] == eng.aggregate(out_b, idx == 0)
    eng.resident_merge([(k1, 0, n, IV)], eng.aggregate_pending(out_a, np.zeros(n, np.int32), 1))
    with pytest.raises(ResidentMergeError) as ei:
        eng.resident_merge([(k0, 0, 2, IV), (k1, 1, 2, IV)], eng.aggregate_pending(out_b, idx, 2))
    assert ei.value.merged == frozenset({k0})
    eng.resident_take()


def _failing_fetch(eng, monkeypatch, label):
    real = eng._fetch

    def flaky(name, fn):
        if name == label:
            raise RuntimeError("wedged fetch")
        return real(name, fn)

    monkeypatch.setattr(eng, "_fetch", flaky)


def test_eviction_fetch_failure_defers_never_double_counts(monkeypatch):
    inst = _inst("count")
    eng = EngineCache(inst, VK, device="cpu")
    row_bytes = eng.p3.circ.output_len * eng.p3.tf.LIMBS * 8
    monkeypatch.setattr(EngineCache, "RESIDENT_MAX_BYTES", t_ec.resident_bytes_total() + row_bytes)
    rng = np.random.default_rng(33)
    outs = {bid: _leader(eng, _batch(inst, 4, rng, 600 + j)[0])[0] for j, bid in enumerate([b"b0", b"b1"])}
    assert eng.resident_merge([((b"t", b"", b"b0"), 0, 4, IV)],
                              eng.aggregate_pending(outs[b"b0"], np.zeros(4, np.int32), 1)) == []
    _failing_fetch(eng, monkeypatch, "resident_fetch")
    pend1 = eng.aggregate_pending(outs[b"b1"], np.zeros(4, np.int32), 1)
    assert eng.resident_merge([((b"t", b"", b"b1"), 0, 4, IV)], pend1) == []
    st = eng.resident_status()
    assert st["buffers"] == 2 and st["eviction_deferred"] == 1
    monkeypatch.undo()
    got = {r["key"][2]: r["share"] for r in eng.resident_take()}
    for bid in (b"b0", b"b1"):
        assert got[bid] == eng.aggregate(outs[bid], np.ones(4, bool))


def test_resident_take_failure_restores_state(monkeypatch):
    inst = _inst("count")
    eng = EngineCache(inst, VK, device="cpu")
    out0, _, _, _ = _leader(eng, _batch(inst, 4, np.random.default_rng(13), 88)[0])
    eng.resident_merge([((b"t", b"", b"bid"), 0, 4, IV)], eng.aggregate_pending(out0, np.zeros(4, np.int32), 1))
    want = eng.aggregate(out0, np.ones(4, bool))
    _failing_fetch(eng, monkeypatch, "resident_fetch")
    with pytest.raises(RuntimeError, match="wedged fetch"):
        eng.resident_take()
    monkeypatch.undo()
    assert eng.resident_status()["buffers"] == 1
    (rec,) = eng.resident_take()
    assert rec["share"] == want


def test_engine_cache_lru_never_evicts_resident_state(monkeypatch):
    inst = _inst("count")
    eng0 = t_ec.engine_cache(inst, VK, "cpu")
    out0, _, _, _ = _leader(eng0, _batch(inst, 3, np.random.default_rng(37), 800)[0])
    eng0.resident_merge([((b"t", b"", b"bid"), 0, 3, IV)], eng0.aggregate_pending(out0, np.zeros(3, np.int32), 1))
    before = t_ec.resident_bytes_total()
    assert before > 0 and t_ec.resident_buffer_counts() == {"count": 1}
    monkeypatch.setattr(t_ec, "_ENGINE_CACHE_MAX", 2)
    t_ec.engine_cache(inst, bytes(range(16, 32)), "cpu")
    t_ec.engine_cache(inst, bytes(range(32, 48)), "cpu")
    assert t_ec.engine_cache(inst, VK, "cpu") is eng0
    assert eng0 in t_ec.live_engines() and len(t_ec.live_engines()) == 2
    assert t_ec.resident_bytes_total() == before
    (rec,) = eng0.resident_take()
    assert rec["rows"] == 3 and t_ec.resident_bytes_total() == 0


def test_would_coalesce_predicate_matches_entry_routing(monkeypatch):
    """would_coalesce is exactly the init entries' routing: the pipeline
    declines a prestage on a parallel lane for these jobs (a merged round
    discards prestages and stages from the host)."""
    eng = EngineCache(_inst("count"), VK, device="cpu")
    routes = []
    monkeypatch.setattr(eng, "_co_leader", SimpleNamespace(submit=lambda args, n: routes.append("round")))
    monkeypatch.setattr(eng, "_leader_init_inner", lambda *a, **kw: routes.append("direct"))
    for n, cap in ((4, None), (EngineCache.COALESCE_MAX_JOB, None), (EngineCache.COALESCE_MAX_JOB + 1, None),
                   (4, 2), (4, 4), (EngineCache.COALESCE_MAX_JOB, 1 << 20)):
        eng.bucket_cap = cap
        eng._leader_init_entry(np.zeros((n, 2), np.uint64), None, None, None, None)
        assert routes.pop() == ("round" if eng.would_coalesce(n) else "direct"), (n, cap)
    eng.bucket_cap = None
    assert eng.would_coalesce(4) and eng.would_coalesce(EngineCache.COALESCE_MAX_JOB)
    assert not eng.would_coalesce(EngineCache.COALESCE_MAX_JOB + 1)
    eng.bucket_cap = 2
    assert not eng.would_coalesce(4), "past the cap the init is chunked, not coalesced"
    eng.bucket_cap = 4
    assert eng.would_coalesce(4), "at the cap the init still rides a round"


def test_prestaged_leader_init_equals_unprestaged_and_janus_tpu(jax_ref):
    inst = _inst("count")
    eng = EngineCache(inst, VK, device="cpu")
    args, _ = _batch(inst, 5, np.random.default_rng(11), 77)
    plain = _leader(eng, args)
    pre = eng.prestage_leader(*args[:5])
    assert pre is not None and pre.b == t_ec.MIN_BUCKET
    staged = eng.leader_init(*args[:5], prestaged=pre)
    assert eng.prestage_stats == {"issued": 1, "used": 1, "discarded": 0}
    want = jax_ref["count"].leader_init(*args[:5])
    for got in (plain, staged):
        assert np.array_equal(got[0].to_numpy()[0], np.asarray(want[0].to_numpy()[0]))
        for a, b in zip(got[2], want[2]):
            assert np.array_equal(a, np.asarray(b))
    # a prestage at another bucket is discarded and the host columns used
    other = eng.prestage_leader(*args[:5])
    other.b = 64
    again = eng.leader_init(*args[:5], prestaged=other)
    assert eng.prestage_stats == {"issued": 2, "used": 1, "discarded": 1} and other.take() == (None, None)
    assert np.array_equal(again[0].to_numpy()[0], plain[0].to_numpy()[0])
    # past 2 x PIPELINE_CHUNK rows the pipelined route stages its own
    assert eng.prestage_leader(np.zeros((2 * EngineCache.PIPELINE_CHUNK, 2), np.uint64), None, (), (), None) is None


# --- against janus_tpu's resident path ---


@pytest.mark.parametrize("kind", ["count", "sparse"])
def test_resident_slot_bytes_after_three_jobs_equal_janus_tpu(jax_ref, kind):
    """Three jobs' leader out shares (the port's, as host rows, for both
    engines) through aggregate_pending and resident_merge: every slot's
    share, rows and encoded bytes equal janus_tpu's; dense per-bucket
    sums equal janus_tpu's aggregate_buckets."""
    inst = _inst(kind)
    eng = EngineCache(inst, VK, device="cpu")
    j_eng = jax_ref[kind]
    circ = eng.p3.circ
    rng = np.random.default_rng(17)
    for j in range(3):
        n = 5
        args, m = _batch(inst, n, rng, 40 + j)
        out0, _, _, _ = _leader(eng, args)
        rows = out0.to_numpy()
        lane_bucket = np.array([0, 1, -1, 0, 1], np.int32)
        flat = None
        if kind == "sparse":
            flat = t_wire.flat_scatter_indices(sparse_compact_batch(inst, m)[1], circ)
        else:
            got = eng.p3.aggregate_buckets(tuple(torch.from_numpy(x.view(np.int64)) for x in rows),
                                           torch.from_numpy(lane_bucket), 2)
            want = j_eng.p3.aggregate_buckets(rows, lane_bucket, 2)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy().view(np.uint64), np.asarray(b))
        entries = [((b"t", b"", bid), jj, int((lane_bucket == jj).sum()), IV) for jj, bid in enumerate([b"a", b"b"])]
        for e, out in ((eng, out0), (j_eng, rows)):
            e.resident_merge(entries, e.aggregate_pending(out, lane_bucket, 2, flat_idx=flat))
    got = sorted(eng.resident_take(), key=lambda r: r["key"])
    want = sorted(j_eng.resident_take(), key=lambda r: r["key"])
    assert [r["key"] for r in got] == [r["key"] for r in want] == [(b"t", b"", b"a"), (b"t", b"", b"b")]
    for g, w in zip(got, want):
        assert g["rows"] == w["rows"] == 6
        assert len(g["share"]) == (circ.agg_output_len if kind == "sparse" else circ.output_len)
        assert circ.FIELD.encode_vec(g["share"]) == circ.FIELD.encode_vec([int(x) for x in w["share"]])
    if kind == "sparse":
        st = eng.resident_status()
        assert st["sparse"]["scatter_rows"] == 12 and st["merges"] == 3


# --- the driver ---

VDAF = j_registry.VdafInstance.count()
TASKS = make_tasks(VDAF)
MEASUREMENTS = [1, 0, 1, 1, 0, 1, 1]
REPORTS = prepare_reports(TASKS[0], TASKS[1], MEASUREMENTS)


def resident_driver(pair, http=None, interval_s=3600.0, pkg=None):
    lp = PKG[pkg] if pkg else pair.lp
    return lp.adriver.AggregationJobDriver(
        pair.l_eph.datastore, http or pair.http(),
        lp.adriver.AggregationJobDriverConfig(
            http_backoff=lp.retries.Backoff.test(),
            resident=lp.adriver.ResidentConfig(enabled=True, flush_interval_s=interval_s),
        ),
        breakers=lp.cb.OutboundCircuitBreakers(), **lp.adriver_kw,
    )


def _collect(pair):
    m = pair.lp.m
    job_id = pair.collector("torch").start_collection(query_for(m)).data
    assert pair.collection_jobs().run_once() == 1
    return pair.poll_all(job_id)


def _jobs_of(pair, size):
    pair.upload(REPORTS)
    return pair.lp.creator.AggregationJobCreator(
        pair.l_eph.datastore, pair.lp.creator.AggregationJobCreatorConfig(min_aggregation_job_size=1,
                                                                          max_aggregation_job_size=size)
    ).run_once()


def test_driver_resident_end_to_end_flush_then_collect(monkeypatch):
    pair = Pairing(monkeypatch, "torch", "torch", *TASKS)
    try:
        assert _jobs_of(pair, 3) == 3
        drv = resident_driver(pair)
        from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig

        jd = JobDriver(JobDriverConfig(max_concurrent_job_workers=2), drv.acquirer(), drv.stepper)
        while jd.run_once():
            pass
        eng = t_ec.engine_cache(pair.task.vdaf, pair.task.vdaf_verify_key, "cpu")
        st = eng.resident_status()
        assert st["buffers"] == 1 and st["merged_rows"] == len(MEASUREMENTS) and st["merges"] == 3
        batches = pair.rows()["leader"]["batches"]
        assert sum(b[5] for b in batches) == len(MEASUREMENTS) and all(b[4] is None for b in batches)
        assert drv.flush_resident_state(reason="drain") == 1
        assert eng.resident_status()["buffers"] == 0 and t_ec.resident_bytes_total() == 0
        assert any(b[4] is not None for b in pair.rows()["leader"]["batches"])
        results = _collect(pair)
        want = (len(MEASUREMENTS), sum(MEASUREMENTS))
        assert {(c, r) for c, _, r in results.values()} == {want}
        assert drv.classic_fallbacks == 0 and drv.resident_lost == 0
    finally:
        pair.close()


def test_commit_failure_drops_delta_no_double_merge(monkeypatch):
    pair = Pairing(monkeypatch, "torch", "torch", *TASKS)
    try:
        assert _jobs_of(pair, 100) == 1
        drv = resident_driver(pair)
        ds = pair.l_eph.datastore
        real = ds.run_tx
        armed = {"on": True}

        def flaky(fn, name="tx", *a, **kw):
            if name == "step_agg_job_write" and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected commit failure")
            return real(fn, name, *a, **kw)

        monkeypatch.setattr(ds, "run_tx", flaky)
        (acquired,) = drv.acquirer()(1)
        with pytest.raises(RuntimeError, match="injected commit failure"):
            drv.step_aggregation_job(acquired)
        eng = t_ec.engine_cache(pair.task.vdaf, pair.task.vdaf_verify_key, "cpu")
        assert eng.resident_status()["buffers"] == 0, "a failed commit merged nothing"
        drv.step_back(acquired, "test", 0.0)
        from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig

        jd = JobDriver(JobDriverConfig(max_concurrent_job_workers=1), drv.acquirer(), drv.stepper)
        while jd.run_once():
            pass
        assert eng.resident_status()["merged_rows"] == len(MEASUREMENTS)
        assert drv.flush_resident_state(reason="drain") == 1
        assert {(c, r) for c, _, r in _collect(pair).values()} == {(len(MEASUREMENTS), sum(MEASUREMENTS))}
    finally:
        pair.close()


def test_non_memory_error_fails_the_step_and_memory_takes_the_classic_path(monkeypatch):
    """The port's narrowing of janus_tpu's fallback: a device error out
    of aggregate_pending fails the step (the lease stays, the job stays in
    progress, nothing merged); memory exhaustion takes the classic
    accumulate, counted in the driver and the engine, and the job
    finishes with its share written at once."""
    pair = Pairing(monkeypatch, "torch", "torch", *TASKS)
    try:
        assert _jobs_of(pair, 100) == 1
        drv = resident_driver(pair)
        eng = t_ec.engine_cache(pair.task.vdaf, pair.task.vdaf_verify_key, "cpu")
        errors = [RuntimeError("CUDA error: an illegal memory access was encountered")]
        real = eng.aggregate_pending

        def pending(*a, **kw):
            if errors:
                raise errors.pop(0)
            return real(*a, **kw)

        monkeypatch.setattr(eng, "aggregate_pending", pending)
        (acquired,) = drv.acquirer()(1)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            drv.stepper(acquired)
        rows = pair.rows()["leader"]
        assert [j[1][2] for j in rows["jobs"]] == ["in_progress"] and rows["batches"] == []
        assert drv.classic_fallbacks == 0 and eng.resident_status()["merges"] == 0
        drv.step_back(acquired, "test", 0.0)
        errors.append(torch.cuda.OutOfMemoryError("CUDA out of memory"))
        (acquired,) = drv.acquirer()(1)
        drv.stepper(acquired)
        st = eng.resident_status()
        assert drv.classic_fallbacks == 1 and st["classic_fallbacks"] == 1 and st["merges"] == 0
        batches = pair.rows()["leader"]["batches"]
        assert len(batches) == 1 and batches[0][4] is not None and batches[0][5] == len(MEASUREMENTS)
    finally:
        pair.close()


def test_interval_flush_cadence_shared_with_background_flusher(monkeypatch):
    driver = t_adriver.AggregationJobDriver(None, None, device="cpu")
    monkeypatch.setattr(t_adriver, "live_engines", lambda: [])
    inline = []
    monkeypatch.setattr(driver, "flush_engine_resident", lambda e, reason="interval": inline.append(reason) or 0)
    driver.flush_resident_state(reason="interval")  # the flusher's pass stamps the cadence
    driver.maybe_flush_resident(object())
    assert inline == []
    driver._resident_last_flush -= driver.cfg.resident.flush_interval_s + 1
    driver.maybe_flush_resident(object())
    assert inline == ["interval"]
    # the background flusher runs its pass every interval
    passes = []
    monkeypatch.setattr(driver, "flush_resident_state", lambda reason="interval": passes.append(reason) or 0)
    flusher = t_adriver.ResidentFlusher(driver, 0.1).start()
    deadline = time.monotonic() + 5
    while len(passes) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    flusher.stop()
    assert passes[:2] == ["interval", "interval"] and not flusher._thread.is_alive()


def test_flush_skipped_while_datastore_down(monkeypatch):
    inst = _inst("count")
    eng = EngineCache(inst, VK, device="cpu")
    out0, _, _, _ = _leader(eng, _batch(inst, 3, np.random.default_rng(43), 910)[0])
    eng.resident_merge([((b"t", b"", b"bid"), 0, 3, IV)], eng.aggregate_pending(out0, np.zeros(3, np.int32), 1))
    ds = SimpleNamespace(supervisor=SimpleNamespace(state="down"))
    driver = t_adriver.AggregationJobDriver(ds, None, device="cpu")
    flushed = []
    monkeypatch.setattr(driver, "flush_resident_records", lambda engine, recs, reason: flushed.append(reason) or len(recs))
    assert driver.flush_engine_resident(eng, "interval") == 0
    assert eng.resident_status()["buffers"] == 1 and flushed == []
    assert driver.flush_engine_resident(eng, "drain") == 1
    assert flushed == ["drain"] and eng.resident_status()["buffers"] == 0


def test_resident_config_from_dict_is_janus_tpus():
    from janus_tpu.aggregator import aggregation_job_driver as j_adriver

    for d in (None, {}, {"enabled": True, "flush_interval_secs": 2.5}):
        assert dataclasses.asdict(t_adriver.ResidentConfig.from_dict(d)) == dataclasses.asdict(
            j_adriver.ResidentConfig.from_dict(d))
