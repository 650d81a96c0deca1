"""janus_tpu_torch/config.py against janus_tpu/config.py: the same YAML
loads to the same settings, with the port's `device:` in place of
janus_tpu's JAX runtime keys.

- every sample in docs/samples loads in both packages, and every field
  the two share is equal (JAX_ONLY and PORT_ONLY name the rest);
- PeerHealthConfig, CircuitBreakerConfig and HttpClientConfig read a
  sample's stanza and a seeded dict to janus_tpu's values;
- `device:` absent means CUDA (which raises here, with no CUDA), `cpu`
  the CPU, and a list with `engine: mesh:` serves on a mesh of that
  geometry (two CPU devices);
- `cross_task_coalesce: false` is refused; the `.json` and `.yaml` copy
  of a sample load to equal configs; without PyYAML a `.yaml` file raises
  and a `.json` one still loads.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import janus_tpu.aggregator.peer_health as j_peer_health
import janus_tpu.config as jcfg
import janus_tpu.core.circuit_breaker as j_breaker
import janus_tpu.core.http_client as j_http
import janus_tpu_torch.aggregator.peer_health as t_peer_health
import janus_tpu_torch.config as tcfg
import janus_tpu_torch.core.circuit_breaker as t_breaker
import janus_tpu_torch.core.http_client as t_http
from janus_tpu_torch.aggregator.engine_cache import EngineCache
from janus_tpu_torch.binary_utils import configure_engines
from janus_tpu_torch.vdaf.registry import VdafInstance

SAMPLES = Path(__file__).resolve().parent.parent / "docs" / "samples"
CLASSES = {
    "aggregator": "AggregatorConfig",
    "aggregation_job_creator": "JobCreatorConfig",
    "aggregation_job_driver": "JobDriverBinaryConfig",
    "collection_job_driver": "JobDriverBinaryConfig",
}
# janus_tpu's setting of the JAX runtime (the cold-start keys are live in
# both packages)
JAX_ONLY = {"common.jax_platform"}
# the port's own hang bound (`device_watchdog: hang_after_secs`): janus_tpu
# declares a hang at the caller's deadline
PORT_ONLY = {"common.device", "common.ignored_keys", "common.watchdog_hang_after_secs"}


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict) and k not in ("failpoints",):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _load_both(path):
    name = CLASSES[path.stem]
    return (
        jcfg.load_config(str(path), getattr(jcfg, name)),
        tcfg.load_config(str(path), getattr(tcfg, name)),
    )


@pytest.mark.parametrize("sample", sorted(SAMPLES.glob("*.yaml")), ids=lambda p: p.stem)
def test_sample_loads_to_janus_tpus_settings(sample):
    j, t = _load_both(sample)
    fj, ft = _flat(dataclasses.asdict(j)), _flat(dataclasses.asdict(t))
    assert set(fj) - set(ft) <= JAX_ONLY, sorted(set(fj) - set(ft) - JAX_ONLY)
    assert set(ft) - set(fj) == PORT_ONLY
    shared = sorted(set(fj) & set(ft))
    doc = yaml.safe_load(sample.read_text())
    # the one named divergence of a default: no compile cache directory
    # unless a key names one (janus_tpu's is ~/.cache/janus_tpu_xla)
    unset = [] if "compilation_cache_dir" in doc else ["common.compilation_cache_dir"]
    assert [k for k in shared if fj[k] != ft[k]] == unset
    if unset:
        assert (fj[unset[0]], ft[unset[0]]) == ("~/.cache/janus_tpu_xla", None)
    # the samples set no device, so each binary would serve on CUDA, and
    # every JAX key a sample sets is named for janus_main's boot log
    assert t.common.device is None
    assert tcfg.IGNORED_TOP_LEVEL_KEYS == ("jax_platform",)
    assert set(t.common.ignored_keys) == {k for k in tcfg.IGNORED_TOP_LEVEL_KEYS if k in doc}


def _seeded_stanzas(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "peer_health": {
            "enabled": bool(rng.integers(2)),
            "park": bool(rng.integers(2)),
            "probe_interval_secs": float(rng.uniform(0.1, 30)),
            "probe_timeout_secs": float(rng.uniform(0.1, 30)),
        },
        "outbound_circuit_breaker": {
            "failure_threshold": int(rng.integers(1, 20)),
            "open_cooldown_secs": float(rng.uniform(1, 120)),
            "close_threshold": int(rng.integers(1, 5)),
            "enabled": bool(rng.integers(2)),
        },
        "helper_http": {
            "attempt_timeout_secs": float(rng.uniform(1, 600)),
            "body_budget_secs": float(rng.uniform(1, 60)),
            "max_response_mb": float(rng.uniform(1, 128)),
        },
    }


PAIRS = {
    "peer_health": (j_peer_health.PeerHealthConfig, t_peer_health.PeerHealthConfig),
    "outbound_circuit_breaker": (j_breaker.CircuitBreakerConfig, t_breaker.CircuitBreakerConfig),
    "helper_http": (j_http.HttpClientConfig, t_http.HttpClientConfig),
}


@pytest.mark.parametrize("source", ["aggregation_job_driver", "collection_job_driver", "seed-0", "seed-1", "empty"])
@pytest.mark.parametrize("stanza", sorted(PAIRS))
def test_stanza_from_dict_equals_janus_tpus(source, stanza):
    if source.startswith("seed-"):
        d = _seeded_stanzas(int(source[5:]))[stanza]
    elif source == "empty":
        d = None
    else:
        d = yaml.safe_load((SAMPLES / f"{source}.yaml").read_text()).get(stanza)
    j_cls, t_cls = PAIRS[stanza]
    assert dataclasses.asdict(t_cls.from_dict(d)) == dataclasses.asdict(j_cls.from_dict(d))
    if stanza == "helper_http":
        jc, tc = j_cls.from_dict(d).build(), t_cls.from_dict(d).build()
        assert (tc.timeout, tc.body_budget_s, tc.max_response_bytes) == (
            jc.timeout, jc.body_budget_s, jc.max_response_bytes
        )


def test_park_and_enabled_switches_gate_the_park_decision():
    breakers = t_breaker.OutboundCircuitBreakers(t_breaker.CircuitBreakerConfig(failure_threshold=1))
    breakers.record_failure("helper:1")
    for enabled, park, want in ((True, True, True), (True, False, False), (False, True, False)):
        cfg = t_peer_health.PeerHealthConfig.from_dict({"enabled": enabled, "park": park})
        assert t_peer_health.PeerHealthTracker(breakers, cfg).should_park() is want


def test_default_tracker_is_shared_and_takes_the_first_config():
    t_peer_health.reset_default_tracker()
    try:
        breakers = t_breaker.OutboundCircuitBreakers()
        cfg = t_peer_health.PeerHealthConfig(probe_interval_s=2.0)
        a = t_peer_health.default_tracker(breakers, cfg)
        b = t_peer_health.default_tracker(breakers, t_peer_health.PeerHealthConfig(probe_interval_s=9.0))
        assert a is b and a.cfg == cfg
    finally:
        t_peer_health.reset_default_tracker()


def test_device_absent_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    common = tcfg.CommonConfig.from_dict({})
    assert common.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        common.devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        tcfg.CommonConfig.from_dict({"device": "cuda:0"}).devices()
    assert tcfg.CommonConfig.from_dict({"device": "cpu"}).devices() == (torch.device("cpu"),)


@pytest.mark.parametrize("mesh,want", [(None, (2, 1)), ({"dp": 1, "sp": 2}, (1, 2)), ({"dp": 1, "sp": 1}, (1, 1))])
def test_device_list_with_mesh_stanza_builds_that_geometry(monkeypatch, mesh, want):
    from janus_tpu_torch.aggregator.device_watchdog import WATCHDOG

    # configure_engines sets process-wide values: each is put back after
    for name in ("MESH_DP", "MESH_SP", "QUARANTINE_CANARY_DELAY_SECS", "QUARANTINE_CANARY_TIMEOUT_SECS",
                 "RESIDENT_MAX_BYTES"):
        monkeypatch.setattr(EngineCache, name, getattr(EngineCache, name))
    monkeypatch.setattr(WATCHDOG, "abandoned_thread_cap", WATCHDOG.abandoned_thread_cap)
    monkeypatch.setattr(WATCHDOG, "hang_after_s", WATCHDOG.hang_after_s)
    EngineCache.MESH_DP = EngineCache.MESH_SP = None
    doc = {"device": ["cpu", "cpu"]}
    if mesh is not None:
        doc["engine"] = {"mesh": mesh}
    common = tcfg.CommonConfig.from_dict(doc)
    assert common.devices() == (torch.device("cpu"),) * 2
    configure_engines(common)
    eng = EngineCache(VdafInstance.sum_vec(4, 2), bytes(16), devices=common.devices())
    assert (eng.dp, eng.sp) == want
    assert (eng.mesh is not None) == (want != (1, 1))


@pytest.mark.parametrize("doc,want", [({}, 30.0), ({"device_watchdog": {"hang_after_secs": 2}}, 2.0),
                                      ({"device_watchdog": {"hang_after_secs": 0.5, "canary_delay_secs": 1.5}}, 0.5)])
def test_hang_after_secs_reaches_the_process_watchdog(monkeypatch, doc, want):
    """`device_watchdog: hang_after_secs`, the port's own key, sets the
    process watchdog's hang bound through configure_engines; absent, the
    bound stays device_watchdog.HANG_AFTER_S (30 s)."""
    from janus_tpu_torch.aggregator import device_watchdog

    for name in ("QUARANTINE_CANARY_DELAY_SECS", "QUARANTINE_CANARY_TIMEOUT_SECS", "RESIDENT_MAX_BYTES"):
        monkeypatch.setattr(EngineCache, name, getattr(EngineCache, name))
    monkeypatch.setattr(device_watchdog.WATCHDOG, "abandoned_thread_cap", device_watchdog.WATCHDOG.abandoned_thread_cap)
    monkeypatch.setattr(device_watchdog.WATCHDOG, "hang_after_s", 123.0)
    assert device_watchdog.HANG_AFTER_S == 30.0
    common = tcfg.CommonConfig.from_dict({"device": "cpu", **doc})
    assert common.watchdog_hang_after_secs == want
    configure_engines(common)
    assert device_watchdog.WATCHDOG.hang_after_s == want
    assert device_watchdog.WATCHDOG.status()["hang_after_s"] == want


def test_cross_task_coalesce_false_is_refused():
    with pytest.raises(ValueError, match="always coalesces"):
        tcfg.CommonConfig.from_dict({"engine": {"cross_task_coalesce": False}})
    assert tcfg.CommonConfig.from_dict({"engine": {"cross_task_coalesce": True}}).engine.cross_task_coalesce


@pytest.mark.parametrize("sample", sorted(SAMPLES.glob("*.yaml")), ids=lambda p: p.stem)
def test_json_and_yaml_copies_load_alike(sample, tmp_path):
    doc = yaml.safe_load(sample.read_text())
    as_json = tmp_path / f"{sample.stem}.json"
    as_json.write_text(json.dumps(doc))
    cls = getattr(tcfg, CLASSES[sample.stem])
    assert tcfg.load_config(str(as_json), cls) == tcfg.load_config(str(sample), cls)
    # janus_tpu reads the JSON file as the YAML 1.2 it is
    jcls = getattr(jcfg, CLASSES[sample.stem])
    assert jcfg.load_config(str(as_json), jcls) == jcfg.load_config(str(sample), jcls)


def test_yaml_needs_pyyaml_and_json_does_not(tmp_path, monkeypatch):
    (tmp_path / "c.yaml").write_text("device: cpu\n")
    (tmp_path / "c.json").write_text('{"device": "cpu"}')
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        tcfg.load_config(str(tmp_path / "c.yaml"), tcfg.JobCreatorConfig)
    assert tcfg.load_config(str(tmp_path / "c.json"), tcfg.JobCreatorConfig).common.device == "cpu"


def test_shutdown_engines_stops_the_canary_loops():
    """engine_cache.shutdown_engines, janus_main's first teardown step: every
    live engine's canary thread ends within the bound (janus_tpu's has the
    same signature and the same effect, over its device engines)."""
    import inspect
    import threading

    from janus_tpu.aggregator import engine_cache as j_engine_cache
    from janus_tpu_torch.aggregator import engine_cache as t_engine_cache

    assert str(inspect.signature(t_engine_cache.shutdown_engines)) == str(
        inspect.signature(j_engine_cache.shutdown_engines)
    )
    t_engine_cache.engine_cache.cache_clear()
    try:
        eng = t_engine_cache.engine_cache(VdafInstance.count(), bytes(16), device="cpu")
        eng.QUARANTINE_CANARY_DELAY_SECS = 600.0  # the loop waits out a long cool-down
        eng._quarantined = True
        eng._canary_thread = threading.Thread(target=eng._canary_loop, daemon=True)
        eng._canary_thread.start()
        t_engine_cache.shutdown_engines(2.0)
        assert not eng._canary_thread.is_alive()
    finally:
        eng._quarantined = False
        t_engine_cache.engine_cache.cache_clear()
