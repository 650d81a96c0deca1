"""janus_tpu_torch/flight_recorder.py against janus_tpu/flight_recorder.py.

On seeded series: Theil–Sen, p99 from a bucket delta, the leak / flat /
degraded verdicts and the rollups equal janus_tpu's; both rings hold the
same records, and a torn tail is skipped alike. The recorders read the
same stand-in series (a fixed value sequence each) and a latency
histogram in a fresh registry of each package, on one mock clock.
"""

import json
import math
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


def _raw_p99(obs):
    """The plain quantile of raw observations: the nearest-rank p99, the
    ceil(0.99 n)-th smallest."""
    return sorted(obs)[math.ceil(0.99 * len(obs)) - 1]


def _p99_bucket(obs, bounds):
    """The bucket (lower, upper] that holds the raw p99 (the first from
    0; (last bound, +Inf] past the last bound)."""
    x = _raw_p99(obs)
    lows = (0.0,) + tuple(float(b) for b in bounds)
    highs = tuple(float(b) for b in bounds) + (float("inf"),)
    return next((lo, hi) for lo, hi in zip(lows, highs) if x <= hi)


def _p99_interpolated(obs, bounds):
    """Prometheus's histogram_quantile(0.99) of raw observations: rank
    0.99 n, interpolated linearly inside the bucket that holds it; +Inf
    past the last bound, None for no observations."""
    if not len(obs):
        return None
    target = 0.99 * len(obs)
    lower, below = 0.0, 0.0
    for b in bounds:
        cum = float(sum(1 for x in obs if x <= b))
        if cum >= target:
            return lower + (b - lower) * (target - below) / (cum - below)
        lower, below = float(b), cum
    return float("inf")


def _cumulative(obs, bounds):
    """Prometheus's cumulative bucket counts of `obs`, the +Inf total last."""
    return [float(sum(1 for x in obs if x <= b)) for b in bounds] + [float(len(obs))]


@pytest.mark.parametrize("seed", range(6))
def test_p99_from_bucket_delta_equal(seed):
    """The port's estimate (a named divergence) is histogram_quantile's
    of the window's raw observations, inside the bucket of their
    nearest-rank p99 and within that bucket's width of it; janus_tpu's,
    which adds the cumulative deltas up again and returns a bound, is
    never above that bucket's bound and reads below it wherever more
    than ~1 % of the window lies under a lower bound."""
    rng = np.random.default_rng(seed)
    bounds = tuple(sorted(rng.uniform(0.001, 10, 12)))
    early_obs = list(rng.uniform(0, 12, int(rng.integers(0, 400))))
    n_late = 0 if seed == 5 else int(rng.integers(101, 999)) // 100 * 100 + int(rng.integers(1, 99))
    late_obs = list(rng.lognormal(0, 1.5, n_late))
    early = _cumulative(early_obs, bounds)
    late = [a + b for a, b in zip(early, _cumulative(late_obs, bounds))]
    got = tfr._p99_from_bucket_delta(bounds, early, late)
    assert got == _p99_interpolated(late_obs, bounds)
    reference = jfr._p99_from_bucket_delta(bounds, early, late)
    if got is None:
        assert reference is None
    else:
        lo, hi = _p99_bucket(late_obs, bounds)
        assert lo < got <= hi
        if hi != float("inf"):
            assert abs(got - _raw_p99(late_obs)) <= hi - lo
        assert reference <= hi
        below = [b for b in bounds if b < hi]
        if below and sum(1 for x in late_obs if x <= below[-1]) >= 0.5 * len(late_obs):
            assert reference < hi
    # half the window at 0.5 ms, half at 4 ms: rank 198 of 200 lies 98 %
    # into the (2.5 ms, 5 ms] bucket; janus_tpu reads 2.5 ms
    ladder = (0.001, 0.0025, 0.005, 0.01)
    obs = [0.0005] * 100 + [0.004] * 100
    got = tfr._p99_from_bucket_delta(ladder, [0.0] * 5, _cumulative(obs, ladder))
    assert got == _p99_interpolated(obs, ladder) and math.isclose(got, 0.00495)
    assert jfr._p99_from_bucket_delta(ladder, [0.0] * 5, _cumulative(obs, ladder)) == 0.0025


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


def _drive(tmp_path, regs, seed=0, n=120, step=7.0, with_dir=True, lat=None):
    specs = _series(seed, n)
    lat = lat or _latency(seed, n)
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


_P99_KEYS = ("p99_early_s", "p99_late_s", "p99_ratio")


def _without_p99(doc):
    """An analysis (or a document or status holding one) without the p99
    estimates and their ratio: the port's estimator is a named divergence
    from janus_tpu's (test_p99_from_bucket_delta_equal)."""
    if isinstance(doc, dict):
        return {k: _without_p99(v) for k, v in doc.items() if k not in _P99_KEYS}
    if isinstance(doc, list):
        return [_without_p99(v) for v in doc]
    return doc


def test_snapshots_verdicts_and_rollups_equal(tmp_path, fresh_latency):
    n, step = 120, 7.0
    (jrec, trec), (jraw, traw) = _drive(tmp_path, fresh_latency)
    assert traw == jraw
    ja, ta = jrec.analyze(), trec.analyze()
    assert _without_p99(ta) == _without_p99(ja)
    # the port's p99s are the plain quantile's buckets of each half's raw
    # observations (snapshot i, taken at start + (i + 1) step, holds lat[i]);
    # janus_tpu's read no higher
    lat, bounds = _latency(0, n), fresh_latency[1].get(LATENCY).buckets
    doc, ref = ta["latency"][LATENCY], ja["latency"][LATENCY]
    start = 1_700_000_000.0
    (t0, tm_), (_, t1) = doc["early_window"], doc["late_window"]
    idx = [round((t - start) / step) - 1 for t in (t0, tm_, t1)]
    early = [x for i in range(idx[0] + 1, idx[1] + 1) for x in lat[i]]
    late = [x for i in range(idx[1] + 1, idx[2] + 1) for x in lat[i]]
    assert (doc["p99_early_s"], doc["p99_late_s"]) == (_p99_interpolated(early, bounds),
                                                       _p99_interpolated(late, bounds))
    assert ref["p99_early_s"] <= _p99_bucket(early, bounds)[1] and ref["p99_late_s"] <= _p99_bucket(late, bounds)[1]
    assert ta["series"]["leak_bytes"]["verdict"] == "leak"
    assert ta["series"]["flat_bytes"]["verdict"] == "flat"
    assert ta["series"]["counter_total"]["verdict"] == "flat"  # cumulative: never leak-gated
    assert ta["latency"][LATENCY]["verdict"] == "degraded"
    # a short trailing window has too few points
    assert _without_p99(trec.analyze(window_s=30.0)) == _without_p99(jrec.analyze(window_s=30.0))
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

    assert _without_p99(strip(trec.document(max_points=50))) == _without_p99(strip(jrec.document(max_points=50)))
    assert _without_p99(strip(trec.status())) == _without_p99(strip(jrec.status()))
    jring, tring = jrec._ring.state(), trec._ring.state()
    assert {k: v for k, v in tring.items() if k != "dir"} == {k: v for k, v in jring.items() if k != "dir"}
    jrec.stop()
    trec.stop()


@pytest.mark.parametrize("early,late,verdict,reference", [
    # one bucket up: 1 in 11 late observations at 2 ms
    ([0.0005] * 10, [0.0005] * 10 + [0.002], "degraded", (0.001, 0.0025, "degraded")),
    # two buckets up
    ([0.0005] * 10, [0.0005] * 2 + [0.004] * 10, "degraded", (0.001, 0.005, "degraded")),
    # no move
    ([0.0005] * 10, [0.0005] * 10, "stable", (0.001, 0.001, "stable")),
    # the named differences: half the late window at 4 ms reads 2.5 ms in
    # janus_tpu's estimator (one bucket low) ...
    ([0.0005] * 10, [0.0005] * 10 + [0.004] * 10, "degraded", (0.001, 0.0025, "degraded")),
    # ... a 5x tail move (4 ms to 20 ms, half of each window) reads 2.5 ms
    # in both of janus_tpu's halves: `stable` there ...
    ([0.0005] * 10 + [0.004] * 10, [0.0005] * 10 + [0.02] * 10, "degraded", (0.0025, 0.0025, "stable")),
    # ... and a p99 that moves a hair across the 1 ms bound (raw 0.8 ms to
    # 1.1 ms) reads as a 2.5x move in janus_tpu's bounds: `degraded` there
    ([0.0008] * 100, [0.0008] * 98 + [0.0011] * 2, "stable", (0.001, 0.0025, "degraded")),
])
def test_p99_verdict_of_a_bucket_move_equal(tmp_path, fresh_latency, early, late, verdict, reference):
    """Early snapshots observe `early` each, late ones `late`: the port's
    p99 estimates are histogram_quantile's of each half's observations,
    its verdict janus_tpu's rule on them; janus_tpu's estimates and
    verdict are `reference` (its estimator reads bucket bounds, low where
    much of a window lies in lower buckets: the named difference); every
    other field of the two documents is equal."""
    n = 60
    lat = [list(early) if i <= n // 2 else list(late) for i in range(n)]
    (jrec, trec), _ = _drive(tmp_path, fresh_latency, n=n, lat=lat)
    bounds = fresh_latency[1].get(LATENCY).buckets
    jdoc, tdoc = jrec.analyze()["latency"][LATENCY], trec.analyze()["latency"][LATENCY]
    p99s = (_p99_interpolated(early, bounds), _p99_interpolated(late, bounds))
    # (a half holds its observations many times over: the same rank
    # fraction, rounded apart in the last bits)
    assert all(math.isclose(got, want) for got, want in zip((tdoc["p99_early_s"], tdoc["p99_late_s"]), p99s))
    assert tdoc["verdict"] == verdict
    assert (jdoc["p99_early_s"], jdoc["p99_late_s"], jdoc["verdict"]) == reference
    assert _without_p99({k: v for k, v in tdoc.items() if k != "verdict"}) == _without_p99(
        {k: v for k, v in jdoc.items() if k != "verdict"})
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
    # the port keeps janus_tpu's artifacts too: the shape manifest and the
    # kernel-library cache (its AOT cache)
    assert set(j) == set(t)
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
