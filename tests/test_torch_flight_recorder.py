"""janus_tpu_torch/flight_recorder.py against janus_tpu/flight_recorder.py.

On seeded series: Theil–Sen, p99 from a bucket delta, the leak / flat /
degraded verdicts and the rollups equal janus_tpu's; both rings hold the
same records, and a torn tail is skipped alike. The recorders read the
same stand-in series (a fixed value sequence each) and a latency
histogram in a fresh registry of each package, on one mock clock.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest

import janus_tpu.flight_recorder as jfr
import janus_tpu.metrics as jm
import janus_tpu_torch.flight_recorder as tfr
import janus_tpu_torch.metrics as tm

LATENCY = "janus_http_request_duration_seconds"


@pytest.mark.parametrize("seed", range(6))
def test_theil_sen_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 140))
    t = np.sort(rng.uniform(0, 3600, n))
    v = rng.normal(100, 10, n) + rng.uniform(-1, 1) * t
    if seed % 2:
        v[rng.integers(0, n, 3)] += 1e4  # outliers
    pts = [(float(a), float(b)) for a, b in zip(t, v)]
    assert tfr.theil_sen(pts) == jfr.theil_sen(pts)
    assert tfr.theil_sen(pts[:1]) == jfr.theil_sen(pts[:1])
    assert tfr.theil_sen([]) == jfr.theil_sen([])


@pytest.mark.parametrize("seed", range(6))
def test_p99_from_bucket_delta_equal(seed):
    rng = np.random.default_rng(seed)
    bounds = tuple(sorted(rng.uniform(0.001, 10, 12)))
    early_counts = rng.integers(0, 50, len(bounds) + 1)
    late_counts = early_counts + rng.integers(0, 50 if seed else 1, len(bounds) + 1) * (seed != 5)
    early = list(np.cumsum(early_counts[:-1]).astype(float)) + [float(early_counts.sum())]
    late = list(np.cumsum(late_counts[:-1]).astype(float)) + [float(late_counts.sum())]
    assert tfr._p99_from_bucket_delta(bounds, early, late) == jfr._p99_from_bucket_delta(bounds, early, late)


class _Series:
    """A stand-in tracked series: the next value of a fixed sequence each
    read (None: absent this snapshot)."""

    def __init__(self, name, values, leak=True):
        self.name, self.leak, self._values, self._i = name, leak, values, 0

    def read(self):
        v = self._values[self._i]
        self._i += 1
        return v


def _series(seed: int, n: int):
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=float)
    flat = 1000.0 + rng.normal(0, 5, n)
    leak = 500.0 + 40.0 * t + rng.normal(0, 5, n)
    spiky = 200.0 + rng.normal(0, 1, n)
    spiky[rng.integers(0, n, 4)] += 5000
    gaps = [None if rng.random() < 0.3 else float(x) for x in rng.uniform(0, 10, n)]
    return [
        ("flat_bytes", [float(x) for x in flat], True),
        ("leak_bytes", [float(x) for x in leak], True),
        ("spiky_rows", [float(x) for x in spiky], True),
        ("sparse_series", gaps, True),
        ("counter_total", [float(x) for x in np.cumsum(rng.integers(0, 9, n))], False),
    ]


def _latency(seed: int, n: int):
    """Per snapshot, the observations of the latency family: fast early,
    slow late (a degraded p99)."""
    rng = np.random.default_rng(seed + 100)
    return [list(rng.uniform(0.001, 0.05 if i < n // 2 else 2.0, int(rng.integers(5, 15)))) for i in range(n)]


def _recorder(mod, cfg, now, specs):
    rec = mod.FlightRecorder(cfg, time_fn=lambda: now[0])
    rec.series = [_Series(name, list(vals), leak) for name, vals, leak in specs]
    return rec


@pytest.fixture
def fresh_latency(monkeypatch):
    regs = []
    for m in (jm, tm):
        reg = m.MetricsRegistry()
        reg.histogram(LATENCY, buckets=m.REGISTRY.get(LATENCY).buckets)
        monkeypatch.setattr(m, "REGISTRY", reg)
        regs.append(reg)
    yield regs
    # the verdict gauges the analyses set live in each package's process
    # registry: take this test's series out again (an SLO engine of a later
    # test reads janus_flight_leak_active)
    names = {name for name, _, _ in _series(0, 2)} | {"synthetic_leak_bytes"}
    for m in (jm, tm):
        for gauge in (m.flight_slope, m.flight_leak_active, m.flight_p99_ratio):
            with gauge._lock:
                for key in [k for k in gauge._values if dict(k).get("series") in names
                            or dict(k).get("family") == LATENCY]:
                    del gauge._values[key]


def _drive(tmp_path, regs, seed=0, n=120, step=7.0, with_dir=True):
    specs = _series(seed, n)
    lat = _latency(seed, n)
    now = [1_700_000_000.0]
    recs = []
    for mod, sub in ((jfr, "jax"), (tfr, "port")):
        cfg = mod.FlightRecorderConfig.from_dict({
            "interval_secs": step, "window_secs": n * step, "dir": str(tmp_path / sub) if with_dir else None,
            "max_segment_bytes": 8192, "max_total_bytes": 1 << 20, "min_points": 8,
        })
        recs.append(_recorder(mod, cfg, now, specs))
    raws = ([], [])
    for i in range(n):
        now[0] += step
        for reg in regs:
            h = reg.get(LATENCY)
            for x in lat[i]:
                h.observe(x, route="upload")
        for k, rec in enumerate(recs):
            raws[k].append(rec.snapshot_once())
    return recs, raws


def test_snapshots_verdicts_and_rollups_equal(tmp_path, fresh_latency):
    (jrec, trec), (jraw, traw) = _drive(tmp_path, fresh_latency)
    assert traw == jraw
    ja, ta = jrec.analyze(), trec.analyze()
    assert ta == ja
    assert ta["series"]["leak_bytes"]["verdict"] == "leak"
    assert ta["series"]["flat_bytes"]["verdict"] == "flat"
    assert ta["series"]["counter_total"]["verdict"] == "flat"  # cumulative: never leak-gated
    assert ta["latency"][LATENCY]["verdict"] == "degraded"
    # a short trailing window has too few points
    assert trec.analyze(window_s=30.0) == jrec.analyze(window_s=30.0)
    assert trec.analyze(window_s=30.0)["series"]["flat_bytes"]["verdict"] == "insufficient_data"
    # the ring: the same raw and rollup records (1m and 10m tiers)
    jrecs, trecs = jrec._ring.read(), trec._ring.read()
    assert trecs == jrecs
    assert {r["tier"] for r in trecs} == {"raw", "60", "600"}
    for tier in ("60", "600"):
        assert trec._ring.read(tier=tier) == jrec._ring.read(tier=tier)
    since = trecs[len(trecs) // 2]["t"]
    assert trec._ring.read(since_unix=since) == jrec._ring.read(since_unix=since)

    def strip(doc):
        return {k: v for k, v in doc.items() if k not in ("overhead_ratio", "ring")}

    assert strip(trec.document(max_points=50)) == strip(jrec.document(max_points=50))
    assert strip(trec.status()) == strip(jrec.status())
    jring, tring = jrec._ring.state(), trec._ring.state()
    assert {k: v for k, v in tring.items() if k != "dir"} == {k: v for k, v in jring.items() if k != "dir"}
    jrec.stop()
    trec.stop()


def test_ring_budget_and_torn_tail(tmp_path, fresh_latency):
    (jrec, trec), _ = _drive(tmp_path, fresh_latency, seed=1, n=400, step=3.0)
    jrec.stop()
    trec.stop()
    # the byte budget dropped the oldest whole segments alike
    assert trec._ring.state()["segments"] == jrec._ring.state()["segments"]
    assert trec._ring.dropped_segments == jrec._ring.dropped_segments
    # a crash mid-append: half a record at the end of the newest segment
    for rec in (jrec, trec):
        newest = max(Path(rec._ring.path).glob("flight-*.jsonl"))
        with open(newest, "ab") as f:
            f.write(json.dumps({"t": 1.0, "tier": "raw", "v": {"x": 1}}).encode()[:17])
    jr = jfr._Ring(jrec._ring.path, 8192, 1 << 20)
    tr = tfr._Ring(trec._ring.path, 8192, 1 << 20)
    assert tr.read() == jr.read()
    assert tr.torn_lines == jr.torn_lines == 1
    # a reopened ring continues after the newest segment
    assert tr._seq == jr._seq


def test_builtin_series_are_janus_tpus_but_the_artifacts_the_port_lacks():
    j = {s.name: s for s in jfr.BUILTIN_SERIES()}
    t = {s.name: s for s in tfr.BUILTIN_SERIES()}
    assert set(j) - set(t) == {"shape_manifest_bytes", "aot_cache_bytes"}
    for name, spec in t.items():
        js = j[name]
        assert (spec.source, spec.metric, spec.labels, spec.leak) == (js.source, js.metric, js.labels, js.leak)
    assert tfr.FlightRecorderConfig.from_dict({"series": [{"name": "rss_bytes", "source": "rss", "leak": False}]}
                                              ).build_series()[0].leak is False


def test_install_and_uninstall(tmp_path):
    from janus_tpu_torch.statusz import status_snapshot

    assert tfr.flight_document() == jfr.flight_document() == {
        "enabled": False, "series_tracked": [], "snapshots": [], "analysis": {}
    }
    rec = tfr.install_flight_recorder(tfr.FlightRecorderConfig(interval_s=0.05, dir=str(tmp_path / "ring")))
    try:
        assert tfr.get_flight_recorder() is rec
        deadline = time.monotonic() + 10
        while rec.status()["snapshots"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert status_snapshot()["flight"]["running"] is True
        doc = tfr.flight_document(max_points=5)
        assert doc["enabled"] and doc["snapshots"] and "rss_bytes" in doc["series_tracked"]
    finally:
        tfr.uninstall_flight_recorder()
    assert tfr.get_flight_recorder() is None and "flight" not in status_snapshot()
