"""janus_tpu_torch/slo.py against janus_tpu/slo.py.

The same seeded sequence of counter, gauge and histogram updates goes
into a fresh registry of each package (the SLO engines read them in
place of the process registry), and each package's engine evaluates it
on the same mock clock: the burn rates, the firing transitions, the
budget remaining and the whole /alertz document must be equal at every
tick. The builtin definitions are equal by name, and a config merges over
them by name alike.
"""

import dataclasses

import numpy as np
import pytest

import janus_tpu.metrics as jm
import janus_tpu.slo as jslo
import janus_tpu_torch.metrics as tm
import janus_tpu_torch.slo as tslo

# the families the builtin definitions read, with their label names
COUNTERS = {
    "janus_http_requests": ("route", "status"),
    "janus_hung_dispatches_total": (),
    "janus_engine_resident_flushes_total": ("outcome",),
}
GAUGES = {
    "janus_datastore_up": (),
    "janus_abandoned_dispatch_threads": (),
    "janus_engine_backend": ("vdaf", "state"),
    "janus_peer_parked": ("peer",),
    "janus_ledger_breach_active": ("task_id", "stage"),
    "janus_ledger_imbalance": ("task_id", "stage"),
    "janus_flight_leak_active": ("series",),
    "janus_flight_slope": ("series",),
}
HISTOGRAM = "janus_report_e2e_seconds"


def _registry(metrics):
    reg = metrics.MetricsRegistry()
    for name in COUNTERS:
        reg.counter(name)
    for name in GAUGES:
        reg.gauge(name)
    reg.histogram(HISTOGRAM, buckets=metrics.REGISTRY.get(HISTOGRAM).buckets)
    return reg


def _updates(seed: int, ticks: int):
    """Per tick, the list of (kind, family, labels, value) updates: an
    upload route with bursts of 5xx and sheds, e2e latencies around the
    thresholds, and gauges and counters flipping on and off."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(ticks):
        ups = []
        storm = 10 <= t < 22
        ups.append(("add", "janus_http_requests", {"route": "upload", "status": "201"}, int(rng.integers(50, 100))))
        bad = int(rng.integers(5, 40)) if storm else int(rng.integers(0, 2))
        for status in ("429", "503", "500"):
            ups.append(("add", "janus_http_requests", {"route": "upload", "status": status}, bad))
        ups.append(("add", "janus_http_requests", {"route": "aggregate", "status": "200"}, int(rng.integers(1, 9))))
        for _ in range(int(rng.integers(3, 12))):
            slow = rng.random() < (0.4 if storm else 0.005)
            ups.append(("observe", HISTOGRAM, {"stage": "aggregate"}, float(rng.uniform(901, 4000) if slow else rng.uniform(1, 800))))
            ups.append(("observe", HISTOGRAM, {"stage": "collect"}, float(rng.uniform(10, 7200))))
        ups.append(("set", "janus_datastore_up", {}, 0.0 if 14 <= t < 18 else 1.0))
        if rng.random() < 0.15:
            ups.append(("add", "janus_hung_dispatches_total", {}, 1))
        ups.append(("set", "janus_abandoned_dispatch_threads", {}, float(rng.integers(0, 2)) if storm else 0.0))
        ups.append(("set", "janus_engine_backend", {"vdaf": "sumvec", "state": "quarantined"}, 1.0 if 16 <= t < 20 else 0.0))
        ups.append(("set", "janus_peer_parked", {"peer": "helper:1"}, float(rng.random() < 0.2)))
        ups.append(("set", "janus_ledger_breach_active", {"task_id": "t", "stage": "ingest"}, float(12 <= t < 25)))
        ups.append(("set", "janus_ledger_imbalance", {"task_id": "t", "stage": "ingest"}, float(rng.integers(0, 5))))
        ups.append(("set", "janus_flight_leak_active", {"series": "rss_bytes"}, float(t >= 20)))
        ups.append(("set", "janus_flight_slope", {"series": "rss_bytes"}, float(rng.uniform(0, 100))))
        if rng.random() < 0.1:
            ups.append(("add", "janus_engine_resident_flushes_total", {"outcome": "lost"}, 1))
        out.append(ups)
    return out


def _apply(reg, ups):
    for kind, name, labels, value in ups:
        getattr(reg.get(name), kind)(value, **labels)


@pytest.fixture
def fresh_registries(monkeypatch):
    regs = (_registry(jm), _registry(tm))
    monkeypatch.setattr(jslo, "REGISTRY", regs[0])
    monkeypatch.setattr(tslo, "REGISTRY", regs[1])
    yield regs
    # the engines export their burn rates, budgets and alert states to each
    # package's process registry: take this test's series out again
    names = {d.name for d in tslo.BUILTIN_SLOS()}
    for m in (jm, tm):
        for gauge in (m.slo_burn_rate, m.slo_error_budget_remaining, m.alert_active):
            with gauge._lock:
                for key in [k for k in gauge._values if (dict(k).get("slo") or dict(k).get("alert")) in names]:
                    del gauge._values[key]


def _run_pair(regs, cfg_dict, seed=0, ticks=40, step_s=1.0):
    """Both engines over the same updates on a mock clock; returns the
    per-tick alertz documents and the firing transitions of each."""
    now = [1_700_000_000.0]
    engines = []
    for slo_mod in (jslo, tslo):
        cfg = slo_mod.SloEngineConfig.from_dict(cfg_dict)
        engines.append(slo_mod.SloEngine.from_config(cfg, time_fn=lambda: now[0]))
    docs = ([], [])
    for ups in _updates(seed, ticks):
        for reg in regs:
            _apply(reg, ups)
        now[0] += step_s
        for i, eng in enumerate(engines):
            eng.evaluate_once()
            docs[i].append(eng.alertz_doc())
    return docs


CFG = {"window_scale": 1 / 360.0, "evaluation_interval_secs": 1.0}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alertz_equal_at_every_tick(fresh_registries, seed):
    j_docs, t_docs = _run_pair(fresh_registries, CFG, seed=seed)
    assert t_docs == j_docs
    # the storm fires something, and it resolves again: transitions happen
    firing = [tuple(d["firing"]) for d in t_docs]
    assert any(firing) and len(set(firing)) > 2


def test_burn_rates_budgets_and_transitions(fresh_registries):
    j_docs, t_docs = _run_pair(fresh_registries, CFG, seed=3)

    def view(docs):
        rows = []
        for d in docs:
            rows.append((
                {s["name"]: s["burn_rates"] for s in d["slos"]},
                {s["name"]: s["error_budget_remaining_ratio"] for s in d["slos"]},
                sorted(d["firing"]),
            ))
        return rows

    assert view(t_docs) == view(j_docs)
    transitions = [
        (i, a["alert"], a["severity"])
        for i in range(1, len(t_docs))
        for a, b in zip(t_docs[i]["alerts"], t_docs[i - 1]["alerts"])
        if a["state"] != b["state"]
    ]
    assert transitions


def test_installed_engine_serves_alertz_and_statusz(fresh_registries):
    """install_slo_engine / alertz_snapshot / the `slo` statusz section."""
    from janus_tpu.statusz import status_snapshot as j_status
    from janus_tpu_torch.statusz import status_snapshot as t_status

    assert tslo.alertz_snapshot() == jslo.alertz_snapshot() == {"enabled": False, "firing": [], "alerts": [], "slos": []}
    now = [1_700_000_000.0]
    engines = []
    try:
        for slo_mod in (jslo, tslo):
            eng = slo_mod.install_slo_engine(slo_mod.SloEngineConfig.from_dict(CFG), start=False)
            eng._time = lambda: now[0]
            engines.append(eng)
        for ups in _updates(4, 25):
            for reg in fresh_registries:
                _apply(reg, ups)
            now[0] += 1.0
            for eng in engines:
                eng.evaluate_once()
        assert tslo.alertz_snapshot() == jslo.alertz_snapshot()
        assert t_status()["slo"] == j_status()["slo"]
        assert tslo.get_slo_engine() is engines[1]
    finally:
        jslo.uninstall_slo_engine()
        tslo.uninstall_slo_engine()
    assert "slo" not in t_status()


def _canon(d):
    sig = d.signal
    return (d.name, d.objective, d.description, d.enabled, [dataclasses.astuple(w) for w in d.windows],
            sig.kind, dataclasses.asdict(sig))


def test_builtin_definitions_equal_by_name():
    j = {d.name: _canon(d) for d in jslo.BUILTIN_SLOS()}
    t = {d.name: _canon(d) for d in tslo.BUILTIN_SLOS()}
    assert t == j
    assert tslo.DEFAULT_LADDER == jslo.DEFAULT_LADDER


def test_config_merges_over_builtins_by_name():
    raw = {
        "definitions": [
            {"name": "upload_availability", "objective": 0.99,
             "windows": [{"long_secs": 600, "short_secs": 60, "burn_rate": 10, "severity": "page"}]},
            {"name": "device_health", "enabled": False},
            {"name": "collect_latency", "description": "tighter",
             "signal": {"kind": "histogram_latency", "metric": "janus_report_e2e_seconds",
                        "labels": {"stage": "collect"}, "threshold_s": 60}, "objective": 0.95},
            {"name": "custom_ratio", "objective": 0.9,
             "signal": {"kind": "counter_ratio", "good": {"metric": "janus_http_requests", "labels": {"status": "200"}},
                        "bad": [{"metric": "janus_http_requests", "labels": {"status": "~5.."}}]}},
            {"name": "custom_cond", "objective": 0.9,
             "signal": {"kind": "condition", "conditions": [{"metric": "janus_datastore_up", "op": "<", "value": 1}]}},
        ]
    }
    j = [_canon(d) for d in jslo.SloEngineConfig.from_dict(raw).build_definitions()]
    t = [_canon(d) for d in tslo.SloEngineConfig.from_dict(raw).build_definitions()]
    assert t == j
    names = [c[0] for c in t]
    assert "device_health" not in names and names[-2:] == ["custom_ratio", "custom_cond"]
    for bad in ({"definitions": [{"objective": 0.9}]},
                {"definitions": [{"name": "x", "objective": 0.9, "signal": {"kind": "nope"}}]}):
        with pytest.raises(ValueError):
            tslo.SloEngineConfig.from_dict(bad).build_definitions()
        with pytest.raises(ValueError):
            jslo.SloEngineConfig.from_dict(bad).build_definitions()
