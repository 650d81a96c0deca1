"""janus_tpu_torch's cross-job and cross-task dispatch coalescing held against janus_tpu.

Mirrors tests/test_engine_coalesce.py. The round mechanics of both
packages' `_Coalescer` (a merged round, the row cap, an error reaching
every caller of its round) run the same script. The port's engines
(device="cpu") then run concurrent jobs through gated rounds, a merged
two-task round with per-lane verify keys (Count for Field64, SumVec(3, 2)
for Field128), and offset views of a shared out-share buffer; every out
share, seed, verifier share, joint-rand part, mask, prep message and
aggregate must equal janus_tpu's engine run on the same numpy-made
batch, one job at a time (its scalar-key route: its device engine for
the first task's key, its host engine for the second's, which compiles
nothing). Tolerance: exact equality.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import engine_cache as j_ec
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.convert import step_args_to_numpy
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

from test_torch_engine_cache import _failing_dispatch, jax_single_device

CPU = torch.device("cpu")
KEYS = (bytes(range(16)), bytes(range(16, 32)))
CIRCUITS = {"count": {}, "sumvec": {"length": 3, "bits": 2}}
N = 4


@pytest.fixture(scope="module")
def jax_ref():
    """janus_tpu's references, one per (circuit, key): its device engine
    on one device for the first key, its scalar host engine (the same
    functions, compiled for no key) for the second."""
    with jax_single_device():
        ref = {(k, KEYS[0]): j_ec.EngineCache(j_registry.VdafInstance(k, **CIRCUITS[k]), KEYS[0]) for k in CIRCUITS}
    ref.update({(k, KEYS[1]): j_ec.HostEngineCache(j_registry.VdafInstance(k, **CIRCUITS[k]), KEYS[1])
                for k in CIRCUITS})
    return ref


def _rows(out):
    """Host limb arrays of an out share in any currency."""
    return out.to_numpy() if hasattr(out, "to_numpy") else out


@pytest.fixture()
def fresh():
    """Port engines built for the test alone (the shared coalescers go
    with the cache)."""
    t_ec.engine_cache.cache_clear()
    yield
    t_ec.engine_cache.cache_clear()


def _inst(kind):
    return t_registry.VdafInstance(kind, **CIRCUITS[kind])


def _jobs(kind, n_jobs, seed):
    inst = _inst(kind)
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n_jobs):
        meas = random_measurements(inst, N, rng)
        args, m = make_report_batch(inst, meas, seed=seed + j, device=CPU)
        out.append((step_args_to_numpy(args), m))
    return out


def _same(a, b, what):
    if b is None:
        assert a is None, what
        return
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.array_equal(np.asarray(x), np.asarray(y)), f"{what} limb {i}"


def _full(eng, args, mask):
    """One job through an engine's public surface: host values of the
    leader init, the helper init and both masked aggregates."""
    nonce, public, mv, proof, blind0, seeds, blind1 = args
    out0, seed0, ver0, part0 = eng.leader_init(nonce, public, mv, proof, blind0)
    out1, ok, prep = eng.helper_init(nonce, public, seeds, blind1, ver0, part0, np.ones(N, dtype=bool))
    return {"out0": _rows(out0), "seed0": seed0, "ver0": ver0, "part0": part0, "out1": _rows(out1),
            "mask": np.asarray(ok), "prep": prep, "agg0": eng.aggregate(out0, mask),
            "agg1": eng.aggregate(out1, mask)}


def _same_job(got, want, what):
    for k in ("out0", "seed0", "ver0", "part0", "out1", "mask", "prep"):
        _same(got[k], want[k], f"{what} {k}")
    assert got["agg0"] == want["agg0"] and got["agg1"] == want["agg1"], what


def _gated(co):
    """Hold co's rounds until the returned event is set; returns (event,
    engines-per-round list, restore)."""
    gate = threading.Event()
    orig = co._run
    engines: list[int] = []

    def run(args_list, ns):
        gate.wait(5)
        engines.append(len({id(a[0]) for a in args_list}))
        return orig(args_list, ns)

    co._run = run
    co.rounds.clear()

    def restore():
        co._run = orig

    return gate, engines, restore


# --- the round mechanics, the same script on both packages ---


def _mechanics(mod, case):
    if case == "merge":
        gate = threading.Event()

        def run(args_list, ns):
            gate.wait(5)
            return [sum(a) * n for a, n in zip(args_list, ns)]

        co = mod._Coalescer(run, max_rows=1000)
        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = [pool.submit(co.submit, (i, i), 2) for i in range(8)]
            time.sleep(0.2)  # all 8 enqueue behind the first dispatcher
            gate.set()
            results = [f.result(timeout=10) for f in futs]
        return results, sum(co.rounds), max(co.rounds) > 1
    if case == "cap":
        gate = threading.Event()

        def run(args_list, ns):
            gate.wait(5)
            assert sum(ns) <= 5
            return list(ns)

        co = mod._Coalescer(run, max_rows=5)
        with ThreadPoolExecutor(max_workers=6) as pool:
            futs = [pool.submit(co.submit, (), 3) for _ in range(6)]
            time.sleep(0.2)
            gate.set()
            return [f.result(timeout=10) for f in futs], sum(co.rounds), max(co.rounds)
    calls = {"n": 0}

    def run(args_list, ns):
        calls["n"] += 1
        raise RuntimeError("boom")

    co = mod._Coalescer(run, max_rows=100)
    with pytest.raises(RuntimeError, match="boom"):
        co.submit((), 1)
    return calls["n"]


@pytest.mark.parametrize("case", ["merge", "cap", "error"])
def test_coalescer_round_mechanics_match_janus_tpu(case):
    got = _mechanics(t_ec, case)
    assert got == _mechanics(j_ec, case)
    if case == "merge":
        assert got == ([2 * i * 2 for i in range(8)], 8, True)
    elif case == "cap":
        assert got[0] == [3] * 6 and got[1] == 6 and got[2] == 1


# --- jobs of one task through the port's engine ---


@pytest.mark.parametrize("kind", list(CIRCUITS))
def test_concurrent_jobs_match_serial_and_janus_tpu(fresh, jax_ref, kind):
    """Jobs through one engine at once (eight Count, four SumVec), their
    rounds gated so several merge: every job equals its serial run and
    janus_tpu's."""
    eng = t_ec.EngineCache(_inst(kind), KEYS[0], device="cpu")
    jobs = _jobs(kind, 8 if kind == "count" else 4, 100)
    mask = np.ones(N, dtype=bool)
    want = [_full(jax_ref[(kind, KEYS[0])], args, mask) for args, _ in jobs]
    serial = [_full(eng, args, mask) for args, _ in jobs]
    gate, _, restore = _gated(eng._co_leader)
    try:
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futs = [pool.submit(_full, eng, args, mask) for args, _ in jobs]
            time.sleep(0.3)
            gate.set()
            concurrent = [f.result(timeout=120) for f in futs]
    finally:
        restore()
    assert max(eng._co_leader.rounds) > 1, eng._co_leader.rounds
    assert eng.coalesce_stats["merged_rounds"] >= 1
    for j, (c, s, w) in enumerate(zip(concurrent, serial, want)):
        _same_job(s, w, f"serial job {j}")
        _same_job(c, w, f"concurrent job {j}")


def test_coalesced_cross_job_masked_aggregate_excludes_neighbors(fresh, jax_ref):
    """Five jobs' leader rows in one shared buffer (a forced merged
    round), each job rejecting one of its own lanes: each job's masked
    aggregate over its view equals janus_tpu's over the job alone."""
    eng = t_ec.EngineCache(_inst("sumvec"), KEYS[0], device="cpu")
    jobs = _jobs("sumvec", 5, 300)
    masks = [np.array([i != (j % N) for i in range(N)]) for j in range(5)]
    j_eng = jax_ref[("sumvec", KEYS[0])]
    want = []
    for (args, _), mask in zip(jobs, masks):
        out0, _, _, _ = j_eng.leader_init(*args[:5])
        want.append(j_eng.aggregate(out0, mask))
    gate, _, restore = _gated(eng._co_leader)
    try:
        with ThreadPoolExecutor(max_workers=5) as pool:
            futs = [pool.submit(lambda a: eng.leader_init(*a[:5]), args) for args, _ in jobs]
            time.sleep(0.3)
            gate.set()
            outs = [f.result(timeout=120) for f in futs]
    finally:
        restore()
    assert max(eng._co_leader.rounds) > 1, eng._co_leader.rounds
    rows = [o[0] for o in outs]
    assert any(r.offset for r in rows), "the round's out shares are views into one buffer"
    for (out0, *_), mask, w in zip(outs, masks, want):
        assert eng.aggregate(out0, mask) == w


# --- two tasks in one round: per-lane verify keys ---


@pytest.mark.parametrize("kind", list(CIRCUITS))
def test_cross_task_round_per_lane_keys_matches_janus_tpu(fresh, jax_ref, kind):
    """A merged leader round and a merged helper round over two tasks'
    jobs (one engine each, different verify keys): each job's rows equal
    janus_tpu's solo init under its own task's key, and its aggregates."""
    engines = [t_ec.EngineCache(_inst(kind), key, device="cpu") for key in KEYS]
    assert engines[0]._co_leader is engines[1]._co_leader
    jobs = _jobs(kind, 4, 700)
    owners = [engines[j % 2] for j in range(4)]
    lead = t_ec._run_leader_round([(e, None, *args[:5]) for e, (args, _) in zip(owners, jobs)], [N] * 4)
    helped = t_ec._run_helper_round(
        [(e, args[0], args[1], args[5], args[6], ver0, part0, np.ones(N, dtype=bool))
         for e, (args, _), (_, _, ver0, part0) in zip(owners, jobs, lead)],
        [N] * 4,
    )
    assert engines[0].coalesce_stats["merged_rounds"] == 2
    for j, ((args, _), (out0, seed0, ver0, part0), (out1, mask, prep)) in enumerate(zip(jobs, lead, helped)):
        j_eng = jax_ref[(kind, KEYS[j % 2])]
        jo0, js0, jv0, jp0 = j_eng.leader_init(*args[:5])
        jo1, jmask, jprep = j_eng.helper_init(args[0], args[1], args[5], args[6], jv0, jp0, np.ones(N, dtype=bool))
        assert isinstance(out0, t_ec.DeviceRows) and out0.offset == j * N
        _same(out0.to_numpy(), _rows(jo0), f"job {j} out0")
        _same(seed0, js0, f"job {j} seed0")
        _same(ver0, jv0, f"job {j} ver0")
        _same(part0, jp0, f"job {j} part0")
        _same(out1.to_numpy(), _rows(jo1), f"job {j} out1")
        assert np.array_equal(mask, np.asarray(jmask)) and mask.all(), f"job {j} mask"
        _same(prep, jprep, f"job {j} prep")
        full = np.ones(N, dtype=bool)
        assert owners[j].aggregate(out0, full) == j_eng.aggregate(jo0, full)
        assert owners[j].aggregate(out1, full) == j_eng.aggregate(jo1, full)


def test_cross_task_concurrent_jobs_match_janus_tpu(fresh, jax_ref):
    """Small jobs of two tasks through their engines at once, gated so a
    round mixes the tasks: each job's rows and aggregates equal
    janus_tpu's, and no neighbour's row leaks into a job's aggregate."""
    kind = "sumvec"
    engines = [t_ec.EngineCache(_inst(kind), key, device="cpu") for key in KEYS]
    jobs = _jobs(kind, 4, 900)
    masks = [np.array([i != (j % N) for i in range(N)]) for j in range(4)]
    want = [_full(jax_ref[(kind, KEYS[j % 2])], args, mk) for j, ((args, _), mk) in enumerate(zip(jobs, masks))]
    gate, round_engines, restore = _gated(engines[0]._co_leader)
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(_full, engines[j % 2], args, mk) for j, ((args, _), mk) in enumerate(zip(jobs, masks))]
            time.sleep(0.4)
            gate.set()
            got = [f.result(timeout=120) for f in futs]
    finally:
        restore()
    assert max(round_engines) > 1, round_engines
    for j, (g, w) in enumerate(zip(got, want)):
        _same_job(g, w, f"job {j}")


def test_oom_in_a_cross_task_round_halves_the_running_engines_cap(fresh, jax_ref):
    """Memory exhaustion in a merged two-task round reaches every entry
    as one exception. Whichever entry's thread handles it first, the
    ladder halves the cap of the engine that ran the round (once) and
    leaves the other task's engine alone; the round's retry equals
    janus_tpu's rows."""
    kind = "count"
    engines = [t_ec.EngineCache(_inst(kind), key, device="cpu") for key in KEYS]
    jobs = _jobs(kind, 2, 1100)
    entries = [(eng, None, *args[:5]) for eng, (args, _) in zip(engines, jobs)]
    state = _failing_dispatch(engines[0], 1, only="leader_init")
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        t_ec._run_leader_round(entries, [N, N])
    assert info.value is state["raised"][0]
    for eng in (engines[1], engines[0]):  # the other task's thread first
        try:
            raise info.value
        except Exception as e:  # noqa: BLE001 - the entry loops' handler
            eng._handle_engine_error(e, N)
    assert engines[0].bucket_cap == 16 and [h["action"] for h in engines[0].oom_history] == ["halved_to_16"]
    assert engines[1].bucket_cap is None and not engines[1].oom_history
    retry = t_ec._run_leader_round(entries, [N, N])
    for j, ((args, _), (out0, seed0, ver0, part0)) in enumerate(zip(jobs, retry)):
        jo0, js0, jv0, jp0 = jax_ref[(kind, KEYS[j])].leader_init(*args[:5])
        _same(out0.to_numpy(), _rows(jo0), f"job {j} out0")
        _same(seed0, js0, f"job {j} seed0")
        _same(ver0, jv0, f"job {j} ver0")
        _same(part0, jp0, f"job {j} part0")


# --- offset views of a shared buffer ---


@pytest.mark.parametrize("offset", [0, 8, 40])
def test_coalesced_view_never_leaks_neighbor_rows(fresh, offset):
    """A job's masked aggregate (and its per-bucket pending sums) over
    its [offset, offset + n) view of a 64-row buffer whose every row is
    nonzero equals the plain sum of its own accepted rows."""
    eng = t_ec.EngineCache(_inst("sumvec"), KEYS[0], device="cpu")
    tf = eng.p3.tf
    b, n, out_len = 64, 4, 3
    rows = np.random.default_rng(11).integers(1, 1000, size=(b, out_len))
    value = tuple(torch.from_numpy(x) for x in (rows.astype(np.int64), np.zeros_like(rows, dtype=np.int64)))
    assert tf.LIMBS == 2
    dr = t_ec.DeviceRows(value, n, offset=offset)
    mask = np.array([True, False, True, True])
    want = [int(sum(int(rows[offset + i][j]) for i in range(n) if mask[i]) % tf.MODULUS) for j in range(out_len)]
    assert eng.aggregate(dr, mask) == want
    pend = eng.aggregate_pending(dr, np.where(mask, 0, -1).astype(np.int32), 1)
    assert [int(x) for x in tf.to_ints(pend.row(0))] == want


def test_shared_coalescers_follow_instance_device_and_cache(fresh):
    """Engines of one VdafInstance and device share a coalescer per side;
    another circuit has its own; cache_clear drops the shared ones."""
    a = t_ec.EngineCache(_inst("count"), KEYS[0], device="cpu")
    b = t_ec.EngineCache(_inst("count"), KEYS[1], device="cpu")
    c = t_ec.EngineCache(_inst("sumvec"), KEYS[0], device="cpu")
    assert a._co_leader is b._co_leader and a._co_helper is b._co_helper
    assert a._co_leader is not a._co_helper and c._co_leader is not a._co_leader
    t_ec.engine_cache.cache_clear()
    assert t_ec.EngineCache(_inst("count"), KEYS[0], device="cpu")._co_leader is not a._co_leader
    # the round's row cap follows the width, as janus_tpu's
    assert a._co_leader._max_rows == min(t_ec.EngineCache.COALESCE_ROUND_ROWS,
                                        t_ec.EngineCache.COALESCE_ROUND_ELEMS // a.p3.circ.input_len)
