"""janus_tpu_torch's EngineCache held against janus_tpu's, and its memory ladder.

The same numpy-made report batch goes through both packages' engines on
the CPU (the port with device="cpu"): leader_init, helper_init and the
masked aggregate must give identical out shares, seeds, verifier
shares, joint-rand parts, masks, prep messages and aggregates, on each
route the JAX engine takes: direct (n = 5, bucket 32), chunked past the
bucket cap (n = 70, cap 32) and pipelined (PIPELINE_CHUNK patched down
on both classes). Tolerance: exact equality.

The ladder is the port's alone (janus_tpu's ends in a host engine the
port does not have): an injected torch.cuda.OutOfMemoryError halves the
cap once and the retry equals the uncapped result; at the floor, and
where halving cannot shrink the dispatch, it raises; any other error
raises unchanged.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import engine_cache as j_ec
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch.aggregator import engine_cache as t_ec
from janus_tpu_torch.aggregator.engine_cache import DeviceRows, EngineCache, bucket_size, engine_cache
from janus_tpu_torch.convert import step_args_to_numpy
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

CPU = torch.device("cpu")
VK = bytes(range(16))
CIRCUITS = {"count": {}, "sumvec": {"length": 3, "bits": 2}}
CORRUPT = (1, 33)  # reports whose leader measurement share is off by one
HELPER_REJECT = 4  # a lane the helper's own checks failed (ok_mask False)


def _bump(field_np, row: int, modulus: int):
    v = (sum(int(x[row, 0]) << (64 * i) for i, x in enumerate(field_np)) + 1) % modulus
    out = tuple(x.copy() for x in field_np)
    for i, y in enumerate(out):
        y[row, 0] = np.uint64((v >> (64 * i)) & ((1 << 64) - 1))
    return out


def _batch(kind: str, n: int):
    """A host-column batch (uint64 numpy) with some corrupted reports."""
    inst = t_registry.VdafInstance(kind, **CIRCUITS[kind])
    meas = random_measurements(inst, n, np.random.default_rng(n))
    args, _ = make_report_batch(inst, meas, seed=n, device=CPU)
    nonce, parts, lmeas, lproof, b0, seed, b1 = step_args_to_numpy(args)
    p = t_registry.circuit_for(inst).FIELD.MODULUS
    for row in CORRUPT:
        if row < n:
            lmeas = _bump(lmeas, row, p)
    return (nonce, parts, lmeas, lproof, b0, seed, b1), meas


@contextlib.contextmanager
def jax_single_device(**env):
    """janus_tpu reads its engine geometry and bucket cap from the
    environment when an engine is built: pin one device (the tests'
    conftest gives JAX eight virtual ones), the path the port ports."""
    env = {"JANUS_MESH_DP": "1", "JANUS_MESH_SP": "1", **env}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _jax_engine(kind: str, cap: int | None):
    inst = j_registry.VdafInstance(kind, **CIRCUITS[kind])
    with jax_single_device(JANUS_BUCKET_CAP=str(cap or 0)):
        eng = j_ec.EngineCache(inst, VK)
    assert eng.mesh is None
    return eng


@pytest.fixture(scope="module")
def jax_engines():
    """One JAX engine per (circuit, cap), built once for the module."""
    return {(k, cap): _jax_engine(k, cap) for k in CIRCUITS for cap in (None, 32)}


def _same_rows(port, jax_value, what):
    if jax_value is None:
        assert port is None, what
        return
    port = port if isinstance(port, tuple) else (port,)
    jax_value = jax_value if isinstance(jax_value, tuple) else (jax_value,)
    assert len(port) == len(jax_value), what
    for i, (p, j) in enumerate(zip(port, jax_value)):
        assert p.dtype == np.uint64, what
        assert np.array_equal(p, np.asarray(j)), f"{what} limb {i}"


def _round(eng, args, n):
    """Leader init, helper init and the masked aggregates through the
    public surface, as host values."""
    nonce, parts, lmeas, lproof, b0, seed, b1 = args
    out0, seed0, ver0, part0 = eng.leader_init(nonce, parts, lmeas, lproof, b0)
    ok = np.ones(n, dtype=bool)
    ok[HELPER_REJECT] = False
    out1, mask, prep = eng.helper_init(nonce, parts, seed, b1, ver0, part0, ok)
    return {
        "out0": out0.to_numpy(),
        "seed0": seed0,
        "ver0": ver0,
        "part0": part0,
        "out1": out1.to_numpy(),
        "mask": mask,
        "prep": prep,
        "agg0": eng.aggregate(out0, mask),
        "agg1": eng.aggregate(out1, mask),
        "agg1_host": eng.aggregate(out1.to_numpy(), mask),
        "types": (type(out0).__name__, type(out1).__name__),
    }


ROUTES = {
    "direct": dict(n=5, cap=None, chunk=None, types=("DeviceRows", "DeviceRows")),
    "chunked": dict(n=70, cap=32, chunk=None, types=("DeviceRowsChunks", "DeviceRowsChunks")),
    "pipelined": dict(n=70, cap=None, chunk=32, types=("DeviceRowsChunks", "DeviceRows")),
}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", list(CIRCUITS))
def test_engine_matches_jax(jax_engines, monkeypatch, kind, route):
    r = ROUTES[route]
    if r["chunk"]:
        monkeypatch.setattr(j_ec.EngineCache, "PIPELINE_CHUNK", r["chunk"])
        monkeypatch.setattr(EngineCache, "PIPELINE_CHUNK", r["chunk"])
    args, meas = _batch(kind, r["n"])
    port = _round(EngineCache(t_registry.VdafInstance(kind, **CIRCUITS[kind]), VK, device=CPU, bucket_cap=r["cap"] or 0), args, r["n"])
    jax = _round(jax_engines[(kind, r["cap"])], args, r["n"])
    assert port["types"] == jax["types"] == r["types"]
    for key in ("out0", "seed0", "ver0", "part0", "out1", "prep"):
        _same_rows(port[key], jax[key], key)
    assert port["mask"].dtype == bool and np.array_equal(port["mask"], jax["mask"])
    for key in ("agg0", "agg1", "agg1_host"):
        assert port[key] == [int(x) for x in jax[key]], key
    # the honest reports' aggregate, from the two shares
    p = t_registry.circuit_for(t_registry.VdafInstance(kind, **CIRCUITS[kind])).FIELD.MODULUS
    valid = np.ones(r["n"], dtype=bool)
    valid[[c for c in CORRUPT if c < r["n"]] + [HELPER_REJECT]] = False
    assert np.array_equal(port["mask"], valid)
    total = [(a + b) % p for a, b in zip(port["agg0"], port["agg1"])]
    assert total == [int(x) for x in np.asarray(meas)[valid].sum(axis=0).reshape(-1)]


def test_offset_view_aggregate_matches_jax(jax_engines):
    """Two masked aggregates over one resident buffer (one per batch
    window, as a time-interval job spanning two windows makes), and an
    offset view of it, equal JAX's."""
    args, _ = _batch("sumvec", 5)
    nonce, parts, lmeas, lproof, b0, seed, b1 = args
    port = EngineCache(t_registry.VdafInstance("sumvec", **CIRCUITS["sumvec"]), VK, device=CPU)
    jeng = jax_engines[("sumvec", None)]
    t_out = port.helper_init(nonce, parts, seed, b1, *port.leader_init(nonce, parts, lmeas, lproof, b0)[2:], np.ones(5, bool))[0]
    j_out = jeng.helper_init(nonce, parts, seed, b1, *jeng.leader_init(nonce, parts, lmeas, lproof, b0)[2:], np.ones(5, bool))[0]
    for lanes in ([0, 2], [3, 4]):
        m = np.zeros(5, dtype=bool)
        m[lanes] = True
        assert port.aggregate(t_out, m) == [int(x) for x in jeng.aggregate(j_out, m)]
    view_t = DeviceRows(t_out.value, 3, offset=2)
    view_j = j_ec.DeviceRows(j_out.value, 3, offset=2)
    m = np.array([True, False, True])
    _same_rows(view_t.to_numpy(), view_j.to_numpy(), "view rows")
    assert port.aggregate(view_t, m) == [int(x) for x in jeng.aggregate(view_j, m)]


# --- the memory ladder -------------------------------------------------------


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def _failing_dispatch(eng, n_failures: int, exc_factory=_oom, only=None):
    """Make the first n_failures dispatches (of step `only`, or any)
    raise; returns the injection's record."""
    orig = eng._dispatch
    state = {"left": n_failures, "raised": []}

    def patched(name, fn, *args):
        if state["left"] > 0 and only in (None, name):
            state["left"] -= 1
            exc = exc_factory()
            state["raised"].append(exc)
            raise exc
        return orig(name, fn, *args)

    eng._dispatch = patched
    return state


@pytest.fixture(scope="module")
def count_round():
    inst = t_registry.VdafInstance.count()
    args, _ = _batch("count", 5)
    want = _round(EngineCache(inst, VK, device=CPU), args, 5)
    return inst, args, want


def test_bucket_size():
    assert bucket_size(40) == 64
    assert bucket_size(40, cap=16) == 16  # the caller chunks to <= 16
    assert bucket_size(10, cap=16) == 16
    assert bucket_size(1, cap=1) == 1
    assert bucket_size(5) == t_ec.MIN_BUCKET == 32
    assert bucket_size(33) == 64 and bucket_size(64) == 64


def test_bucket_cap_keyword():
    inst = t_registry.VdafInstance.count()
    assert EngineCache(inst, VK, device=CPU).bucket_cap is None  # no memory model on the CPU
    assert EngineCache(inst, VK, device=CPU, bucket_cap=20).bucket_cap == 16
    assert EngineCache(inst, VK, device=CPU, bucket_cap=0).bucket_cap is None


@pytest.mark.parametrize("step", ["leader_init", "helper_init", "aggregate"])
def test_injected_oom_halves_the_cap_once_and_the_retry_is_exact(count_round, step):
    inst, args, want = count_round
    eng = EngineCache(inst, VK, device=CPU)
    state = _failing_dispatch(eng, 1, only=step)
    got = _round(eng, args, 5)
    assert len(state["raised"]) == 1
    # halved from the failed dispatch's bucket (32), once
    assert eng.bucket_cap == 16
    assert [h["action"] for h in eng.oom_history] == ["halved_to_16"]
    for key in ("out0", "seed0", "ver0", "part0", "out1", "prep"):
        _same_rows(got[key], want[key], key)
    assert np.array_equal(got["mask"], want["mask"])
    assert (got["agg0"], got["agg1"], got["agg1_host"]) == (want["agg0"], want["agg1"], want["agg1_host"])


def test_one_exception_object_touches_the_cap_once():
    eng = EngineCache(t_registry.VdafInstance.count(), VK, device=CPU)
    exc = _oom()
    for _ in range(3):
        try:
            raise exc
        except Exception as e:
            eng._handle_engine_error(e, 100)
    assert eng.bucket_cap == 64 and len(eng.oom_history) == 1


def test_oom_at_the_floor_raises(count_round):
    inst, args, _ = count_round
    eng = EngineCache(inst, VK, device=CPU, bucket_cap=1)
    state = _failing_dispatch(eng, 1)
    nonce, parts, lmeas, lproof, b0, _, _ = args
    with pytest.raises(torch.cuda.OutOfMemoryError) as info:
        eng.leader_init(nonce, parts, lmeas, lproof, b0)
    assert info.value is state["raised"][0]
    assert eng.bucket_cap == 1 and eng.oom_history[-1]["action"] == "raised"


def test_oom_on_a_resident_buffer_that_halving_cannot_shrink_raises(count_round):
    """A resident out share keeps its bucket whatever the cap: once the
    cap is at half that bucket, a further OOM raises."""
    inst, args, _ = count_round
    eng = EngineCache(inst, VK, device=CPU)
    nonce, parts, lmeas, lproof, b0, _, _ = args
    out0 = eng.leader_init(nonce, parts, lmeas, lproof, b0)[0]
    _failing_dispatch(eng, 5, only="aggregate")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.aggregate(out0, np.ones(5, dtype=bool))
    assert [h["action"] for h in eng.oom_history] == ["halved_to_16", "raised"]


def test_other_errors_raise_unchanged(count_round):
    inst, args, _ = count_round
    eng = EngineCache(inst, VK, device=CPU)
    boom = ValueError("shape mismatch")
    _failing_dispatch(eng, 1, exc_factory=lambda: boom)
    nonce, parts, lmeas, lproof, b0, _, _ = args
    with pytest.raises(ValueError) as info:
        eng.leader_init(nonce, parts, lmeas, lproof, b0)
    assert info.value is boom
    assert eng.bucket_cap is None and not eng.oom_history


def test_engine_cache_is_keyed_by_device_and_never_falls_back(monkeypatch):
    inst = t_registry.VdafInstance.count()
    a = engine_cache(inst, VK, "cpu")
    assert engine_cache(inst, VK, CPU) is a
    assert engine_cache(inst, bytes(16), "cpu") is not a
    assert a.device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_cache(inst, VK)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineCache(inst, VK)
    # a draft circuit the port's draft engine refuses raises, no host engine
    # (a 167,620-block absorb, past the draft engine's 160,000)
    huge = t_registry.VdafInstance("sumvec", bits=16, length=110_000, xof_mode="draft")
    with pytest.raises(ValueError, match="exceed 160000"):
        engine_cache(huge, VK, "cpu")
