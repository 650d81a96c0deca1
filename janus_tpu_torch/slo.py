"""In-process SLO burn-rate engine (`/alertz`).

An operator must be able to answer "are we meeting our objectives, and
which request blew the budget?" without standing up an external
Prometheus first. This module evaluates multi-window multi-burn-rate
alerts (the Google SRE Workbook method: a fast 14.4x/1h rung that pages
and a slow 6x/6h rung that tickets) directly over the in-process metrics
registry:

  - `SloDefinition`: objective + signal + burn-rate ladder. Signals
    read the registry's own series: a counter good/bad ratio (upload
    availability), a latency histogram threshold (the
    janus_report_e2e_seconds stages), a condition set over gauges and
    counter deltas (datastore up, device health), the flight recorder's
    leak verdicts (trend) and the conservation ledger's breaches.
  - `SloEngine`: a low-cadence thread snapshots each signal's
    cumulative (bad, total) every tick into a bounded sliding window,
    computes burn rates per configured window, drives alert state
    (firing-since, recovery), and exports
    `janus_alert_active{alert,severity}`,
    `janus_slo_error_budget_remaining_ratio{slo}` and
    `janus_slo_burn_rate{slo,window}`.
  - `GET /alertz` (binary_utils.HealthServer) serves the full state:
    per-alert burn rates against thresholds, budget remaining,
    firing-since, and the evidence series behind the numbers; the
    compact `slo` statusz section rides beside it.

Definitions come from the YAML `slo:` stanza (docs/samples/*.yaml),
merged by name over BUILTIN_SLOS.

The port's own copy of janus_tpu/slo.py: the same signal kinds, ladder,
builtin definitions, merge and documents. The `device_health` builtin
keeps janus_tpu's engine-backend matcher; the port has no host engine,
so its `host_fallback` and `timed_fallback` states never occur here, and
the port's `device_down` state is not among the ones it matches.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass, field

from . import metrics
from .metrics import REGISTRY, compile_matchers

log = logging.getLogger(__name__)

# The SRE Workbook's recommended ladder (table 5-2), expressed as
# (long window, short window, burn-rate threshold, severity): the fast
# rung catches an outage in minutes, the slow rung catches a trickle
# that would quietly exhaust a 30d budget in days.
DEFAULT_LADDER = (
    {"long_secs": 3600.0, "short_secs": 300.0, "burn_rate": 14.4, "severity": "page"},
    {"long_secs": 21600.0, "short_secs": 1800.0, "burn_rate": 6.0, "severity": "ticket"},
)


def format_window(seconds: float) -> str:
    """Human window label for the janus_slo_burn_rate series ("1h",
    "5m", "90s") — stable across config round-trips."""
    seconds = float(seconds)
    if seconds >= 3600 and seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds >= 60 and seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{seconds:g}s"


# ---------------------------------------------------------------------------
# Signals: each reads cumulative (bad, total) event counts from the
# live registry. `read(engine)` returns (bad, total, has_data);
# has_data=False (no matching series yet) freezes the window instead of
# recording a fake all-good sample.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Selector:
    """One registry series selection: metric name + label matchers
    (exact / "~regex" / list-of-alternatives, metrics.compile_matchers)."""

    metric: str
    labels: tuple = ()  # compiled matcher tuple

    @classmethod
    def from_dict(cls, d: dict) -> "Selector":
        return cls(metric=str(d["metric"]), labels=compile_matchers(d.get("labels")))

    def read(self) -> tuple[float, int]:
        m = REGISTRY.get(self.metric)
        if m is None or not hasattr(m, "sum_matching"):
            return 0.0, 0
        return m.sum_matching(self.labels)

    def describe(self) -> str:
        if not self.labels:
            return self.metric
        inner = []
        for name, kind, want in self.labels:
            if kind == "eq":
                inner.append(f'{name}="{want}"')
            elif kind == "re":
                inner.append(f'{name}=~"{want.pattern}"')
            else:
                inner.append(f'{name}=~"{"|".join(sorted(want))}"')
        return self.metric + "{" + ",".join(inner) + "}"


@dataclass(frozen=True)
class RatioSignal:
    """Availability ratio over counters: bad/(good+bad). Several
    selectors may feed each side (e.g. 5xx statuses + shed counter)."""

    kind = "counter_ratio"
    good: tuple[Selector, ...]
    bad: tuple[Selector, ...]

    @classmethod
    def from_dict(cls, d: dict) -> "RatioSignal":
        def sels(raw):
            raw = raw if isinstance(raw, (list, tuple)) else [raw]
            return tuple(Selector.from_dict(s) for s in raw)

        return cls(good=sels(d["good"]), bad=sels(d["bad"]))

    def read(self, engine) -> tuple[float, float, bool]:
        good = bad = 0.0
        matched = 0
        for s in self.good:
            v, n = s.read()
            good += v
            matched += n
        for s in self.bad:
            v, n = s.read()
            bad += v
            matched += n
        return bad, good + bad, matched > 0

    def evidence(self) -> dict:
        out = {}
        for side, sels in (("good", self.good), ("bad", self.bad)):
            for s in sels:
                v, n = s.read()
                out[f"{side}:{s.describe()}"] = v if n else None
        return out


@dataclass(frozen=True)
class LatencySignal:
    """Latency objective over a registry histogram: an observation is
    good when <= threshold_s (rounded UP to the histogram's nearest
    bucket bound, recorded as effective_threshold_s)."""

    kind = "histogram_latency"
    metric: str
    labels: tuple
    threshold_s: float

    @classmethod
    def from_dict(cls, d: dict) -> "LatencySignal":
        return cls(
            metric=str(d["metric"]),
            labels=compile_matchers(d.get("labels")),
            threshold_s=float(d["threshold_s"]),
        )

    def _histogram(self):
        m = REGISTRY.get(self.metric)
        return m if isinstance(m, metrics.Histogram) else None

    def effective_threshold_s(self) -> float:
        h = self._histogram()
        return h.nearest_bucket_le(self.threshold_s) if h else self.threshold_s

    def read(self, engine) -> tuple[float, float, bool]:
        h = self._histogram()
        if h is None:
            return 0.0, 0.0, False
        good, total, n = h.le_total_matching(
            h.nearest_bucket_le(self.threshold_s), self.labels
        )
        return total - good, total, n > 0

    def evidence(self) -> dict:
        h = self._histogram()
        desc = Selector(self.metric, self.labels).describe()
        if h is None:
            return {desc: None}
        good, total, n = h.le_total_matching(
            h.nearest_bucket_le(self.threshold_s), self.labels
        )
        return {
            f"{desc} observations": total if n else None,
            f"{desc} over {self.effective_threshold_s():g}s": (total - good) if n else None,
        }


@dataclass(frozen=True)
class Condition:
    """One boolean sub-condition of a ConditionSignal. mode="value"
    compares the matched series' sum against `value` with `op`;
    mode="delta" compares the sum's increase since the previous tick
    (counters: "any hung dispatch since last look is a bad tick")."""

    selector: Selector
    op: str = ">"  # > < >= <= == !=
    value: float = 0.0
    mode: str = "value"  # value | delta

    _OPS = {
        ">": lambda a, b: a > b,
        "<": lambda a, b: a < b,
        ">=": lambda a, b: a >= b,
        "<=": lambda a, b: a <= b,
        "==": lambda a, b: a == b,
        "!=": lambda a, b: a != b,
    }

    @classmethod
    def from_dict(cls, d: dict) -> "Condition":
        op = str(d.get("op", ">"))
        if op not in cls._OPS:
            raise ValueError(f"unknown condition op {op!r}")
        mode = str(d.get("mode", "value"))
        if mode not in ("value", "delta"):
            # a typo ('deltas') would silently degrade to cumulative
            # semantics and latch the SLO bad forever after one event
            raise ValueError(f"unknown condition mode {mode!r} (want value|delta)")
        return cls(
            selector=Selector.from_dict(d),
            op=op,
            value=float(d.get("value", 0.0)),
            mode=mode,
        )

    def describe(self) -> str:
        base = self.selector.describe()
        if self.mode == "delta":
            return f"increase({base}) {self.op} {self.value:g}"
        return f"{base} {self.op} {self.value:g}"


@dataclass(frozen=True)
class ConditionSignal:
    """Time-based SLO: every evaluation tick is one event, bad when ANY
    condition holds. The burn rate is then the fraction of recent time
    the system was in the bad state, over the error budget."""

    kind = "condition"
    conditions: tuple[Condition, ...]

    @classmethod
    def from_dict(cls, d: dict) -> "ConditionSignal":
        raw = d["conditions"]
        return cls(conditions=tuple(Condition.from_dict(c) for c in raw))

    def read(self, engine) -> tuple[float, float, bool]:
        """Engine-side state: cumulative bad/total tick counts and the
        per-condition previous sums for delta mode live in
        engine._condition_state[id(self)]."""
        st = engine._condition_state.setdefault(
            id(self), {"bad": 0.0, "total": 0.0, "prev": {}}
        )
        any_bad = False
        any_data = False
        for i, cond in enumerate(self.conditions):
            v, n = cond.selector.read()
            if cond.mode == "delta":
                prev = st["prev"].get(i)
                st["prev"][i] = v
                if prev is None:
                    continue  # first sight: no delta yet
                any_data = True
                if Condition._OPS[cond.op](v - prev, cond.value):
                    any_bad = True
            else:
                if n == 0:
                    continue  # series not born yet: unknown, not good
                any_data = True
                if Condition._OPS[cond.op](v, cond.value):
                    any_bad = True
        if any_data:
            st["total"] += 1.0
            if any_bad:
                st["bad"] += 1.0
        return st["bad"], st["total"], any_data

    def evidence(self) -> dict:
        out = {}
        for cond in self.conditions:
            v, n = cond.selector.read()
            out[cond.describe()] = v if n else None
        return out


@dataclass(frozen=True)
class TrendSignal:
    """Time-based SLO over the flight recorder's leak verdicts
    (docs/OBSERVABILITY.md "Flight recorder and trend alerts"): every
    evaluation tick is one event, bad while any matched series of
    `metric` (default janus_flight_leak_active, 1 while a leak-gated
    series shows a sustained positive trend) is above zero. A slow
    resource leak is invisible to every point-in-time signal — this is
    how it pages through the same burn-rate ladder. The verdict gauges
    are only born once the recorder's first analysis pass runs, so a
    process without a recorder reports no_data rather than fake
    health."""

    kind = "trend"
    metric: str = "janus_flight_leak_active"
    labels: tuple = ()

    @classmethod
    def from_dict(cls, d: dict) -> "TrendSignal":
        return cls(
            metric=str(d.get("metric", "janus_flight_leak_active")),
            labels=compile_matchers(d.get("labels")),
        )

    def _read_raw(self) -> tuple[float, int]:
        m = REGISTRY.get(self.metric)
        if m is None or not hasattr(m, "sum_matching"):
            return 0.0, 0
        return m.sum_matching(self.labels)

    def read(self, engine) -> tuple[float, float, bool]:
        st = engine._condition_state.setdefault(
            id(self), {"bad": 0.0, "total": 0.0, "prev": {}}
        )
        v, n = self._read_raw()
        if n == 0:
            return st["bad"], st["total"], st["total"] > 0
        st["total"] += 1.0
        if v > 0:
            st["bad"] += 1.0
        return st["bad"], st["total"], True

    def evidence(self) -> dict:
        desc = Selector(self.metric, self.labels).describe()
        v, n = self._read_raw()
        out = {f"{desc} leaking series": v if n else None}
        leak, slopes = REGISTRY.get(self.metric), REGISTRY.get("janus_flight_slope")
        if v > 0 and hasattr(leak, "_values") and hasattr(slopes, "_values"):
            with leak._lock:
                leak_vals = dict(leak._values)
            with slopes._lock:
                slope_vals = dict(slopes._values)
            for key, active in sorted(leak_vals.items()):
                if active > 0:
                    out[f"slope{dict(key)}"] = slope_vals.get(key)
        return out


@dataclass(frozen=True)
class ConservationSignal:
    """Time-based SLO over the report-flow conservation ledger
    (ledger.py; docs/OBSERVABILITY.md "Conservation
    accounting"): every evaluation tick is one event, bad while any
    matched series of `metric` (default janus_ledger_breach_active — 1
    once a per-(task, stage) imbalance has stayed nonzero past the
    ledger's grace window) is above zero. A silently lost or
    double-counted report moves no rate and no latency histogram — the
    unbalanced books are the only signal, and this is how they page
    through the same burn-rate ladder. The breach gauges are only born
    once an installed evaluator's first pass runs, so a process without
    a ledger reports no_data rather than fake health."""

    kind = "conservation"
    metric: str = "janus_ledger_breach_active"
    labels: tuple = ()

    @classmethod
    def from_dict(cls, d: dict) -> "ConservationSignal":
        return cls(
            metric=str(d.get("metric", "janus_ledger_breach_active")),
            labels=compile_matchers(d.get("labels")),
        )

    def _read_raw(self) -> tuple[float, int]:
        m = REGISTRY.get(self.metric)
        if m is None or not hasattr(m, "sum_matching"):
            return 0.0, 0
        return m.sum_matching(self.labels)

    def read(self, engine) -> tuple[float, float, bool]:
        st = engine._condition_state.setdefault(
            id(self), {"bad": 0.0, "total": 0.0, "prev": {}}
        )
        v, n = self._read_raw()
        if n == 0:
            return st["bad"], st["total"], st["total"] > 0
        st["total"] += 1.0
        if v > 0:
            st["bad"] += 1.0
        return st["bad"], st["total"], True

    def evidence(self) -> dict:
        desc = Selector(self.metric, self.labels).describe()
        v, n = self._read_raw()
        out = {f"{desc} breached series": v if n else None}
        breach = REGISTRY.get(self.metric)
        imbalance = REGISTRY.get("janus_ledger_imbalance")
        if v > 0 and hasattr(breach, "_values") and hasattr(imbalance, "_values"):
            with breach._lock:
                breach_vals = dict(breach._values)
            with imbalance._lock:
                imbalance_vals = dict(imbalance._values)
            for key, active in sorted(breach_vals.items()):
                if active > 0:
                    out[f"imbalance{dict(key)}"] = imbalance_vals.get(key)
        return out


_SIGNAL_KINDS = {
    "counter_ratio": RatioSignal,
    "histogram_latency": LatencySignal,
    "condition": ConditionSignal,
    "trend": TrendSignal,
    "conservation": ConservationSignal,
}


def signal_from_dict(d: dict):
    kind = str(d.get("kind", ""))
    cls = _SIGNAL_KINDS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown SLO signal kind {kind!r} (want one of {sorted(_SIGNAL_KINDS)})"
        )
    return cls.from_dict(d)


# ---------------------------------------------------------------------------
# Definitions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BurnWindow:
    long_s: float
    short_s: float
    burn_rate: float
    severity: str

    @classmethod
    def from_dict(cls, d: dict) -> "BurnWindow":
        return cls(
            long_s=float(d["long_secs"]),
            short_s=float(d["short_secs"]),
            burn_rate=float(d["burn_rate"]),
            severity=str(d.get("severity", "page")),
        )


@dataclass(frozen=True)
class SloDefinition:
    name: str
    objective: float  # e.g. 0.999 -> error budget 0.001
    signal: object
    description: str = ""
    windows: tuple[BurnWindow, ...] = tuple(
        BurnWindow.from_dict(w) for w in DEFAULT_LADDER
    )
    enabled: bool = True

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - self.objective)

    @classmethod
    def from_dict(cls, d: dict) -> "SloDefinition":
        windows = tuple(
            BurnWindow.from_dict(w) for w in d.get("windows", DEFAULT_LADDER)
        )
        return cls(
            name=str(d["name"]),
            objective=float(d["objective"]),
            signal=signal_from_dict(d["signal"]),
            description=str(d.get("description", "")),
            windows=windows,
            enabled=bool(d.get("enabled", True)),
        )


def BUILTIN_SLOS() -> list[SloDefinition]:
    """The shipped defaults — one per operational question the paper's
    deployment posture forces (docs/OBSERVABILITY.md "SLO engine"):
    upload availability, aggregate/collect end-to-end latency,
    datastore reachability, device-path health. YAML `slo.definitions`
    entries override these by name."""
    return [
        SloDefinition(
            name="upload_availability",
            description=(
                "client uploads answered 201 vs shed (429/503) or failed "
                "(5xx) at the DAP upload route"
            ),
            objective=0.999,
            signal=RatioSignal(
                good=(
                    Selector(
                        "janus_http_requests",
                        compile_matchers({"route": "upload", "status": "201"}),
                    ),
                ),
                # 429/503 sheds and 5xx failures all land on the same
                # route counter, so one selector cannot double-count a
                # shed that also rides janus_upload_shed_total
                bad=(
                    Selector(
                        "janus_http_requests",
                        compile_matchers({"route": "upload", "status": "~(429|5..)"}),
                    ),
                ),
            ),
        ),
        SloDefinition(
            name="aggregate_step_latency",
            description=(
                "end-to-end report aggregation latency (client timestamp "
                "-> verified output share, janus_report_e2e_seconds"
                '{stage="aggregate"}) under 15 minutes'
            ),
            objective=0.99,
            signal=LatencySignal(
                metric="janus_report_e2e_seconds",
                labels=compile_matchers({"stage": "aggregate"}),
                threshold_s=900.0,
            ),
        ),
        SloDefinition(
            name="collect_latency",
            description=(
                "batch close -> aggregate share released "
                '(janus_report_e2e_seconds{stage="collect"}) under 1 hour'
            ),
            objective=0.99,
            signal=LatencySignal(
                metric="janus_report_e2e_seconds",
                labels=compile_matchers({"stage": "collect"}),
                threshold_s=3600.0,
            ),
        ),
        SloDefinition(
            name="datastore_up",
            description=(
                "the datastore supervisor reports the database reachable "
                "(janus_datastore_up)"
            ),
            objective=0.999,
            signal=ConditionSignal(
                conditions=(
                    Condition(
                        selector=Selector("janus_datastore_up", ()),
                        op="==",
                        value=0.0,
                    ),
                )
            ),
        ),
        SloDefinition(
            name="device_health",
            description=(
                "the device path is healthy: no new hung dispatches, no "
                "watchdog-parked threads, and no engine resident off the "
                "device (quarantined / host_fallback / timed_fallback)"
            ),
            objective=0.99,
            signal=ConditionSignal(
                conditions=(
                    Condition(
                        selector=Selector("janus_hung_dispatches_total", ()),
                        op=">",
                        value=0.0,
                        mode="delta",
                    ),
                    Condition(
                        selector=Selector("janus_abandoned_dispatch_threads", ()),
                        op=">",
                        value=0.0,
                    ),
                    Condition(
                        selector=Selector(
                            "janus_engine_backend",
                            compile_matchers(
                                {
                                    "state": "~(quarantined|host_fallback|timed_fallback)"
                                }
                            ),
                        ),
                        op=">",
                        value=0.0,
                    ),
                )
            ),
        ),
        SloDefinition(
            name="peer_reachable",
            description=(
                "the other aggregator is reachable: no peer is parked by "
                "the peer-health tracker (janus_peer_parked; "
                "aggregator/peer_health.py)"
            ),
            objective=0.999,
            signal=ConditionSignal(
                conditions=(
                    Condition(
                        selector=Selector("janus_peer_parked", ()),
                        op=">",
                        value=0.0,
                    ),
                )
            ),
        ),
        SloDefinition(
            name="report_conservation",
            description=(
                "the report-flow books close: no per-(task, stage) "
                "conservation imbalance — lost or double-counted reports "
                "— sustained past the ledger grace window, and no "
                "cross-aggregator divergence (janus_ledger_breach_active)"
            ),
            objective=0.999,
            signal=ConservationSignal(),
        ),
        SloDefinition(
            name="resident_lost",
            description=(
                "no resident aggregate share was lost on the flush path "
                '(janus_engine_resident_flushes_total{outcome="lost"}): '
                "count books still balance (counts are durable at job "
                "commit), but the lost share mass silently skews the "
                "released aggregate"
            ),
            objective=0.999,
            signal=ConditionSignal(
                conditions=(
                    Condition(
                        selector=Selector(
                            "janus_engine_resident_flushes_total",
                            compile_matchers({"outcome": "lost"}),
                        ),
                        op=">",
                        value=0.0,
                        mode="delta",
                    ),
                )
            ),
        ),
        SloDefinition(
            name="resource_trend",
            description=(
                "no leak-gated flight-recorder series (RSS, engine "
                "resident bytes, datastore rows, journal/manifest/AOT "
                "artifact bytes) shows a sustained positive trend "
                "(janus_flight_leak_active)"
            ),
            objective=0.99,
            signal=TrendSignal(),
        ),
    ]


@dataclass
class SloEngineConfig:
    """The YAML `slo:` stanza (CommonConfig). `definitions` entries
    merge over BUILTIN_SLOS by name (set `enabled: false` to drop a
    built-in); `window_scale` shrinks every ladder window uniformly —
    drills and tests use it to make hour-scale alerting observable in
    seconds without forking the definitions."""

    enabled: bool = True
    evaluation_interval_s: float = 10.0
    window_scale: float = 1.0
    budget_window_s: float | None = None  # default: longest ladder window
    definitions: tuple = ()  # raw dicts, merged in build_definitions

    @classmethod
    def from_dict(cls, d: dict | None) -> "SloEngineConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", True)),
            evaluation_interval_s=float(d.get("evaluation_interval_secs", 10.0)),
            window_scale=float(d.get("window_scale", 1.0)),
            budget_window_s=(
                float(d["budget_window_secs"]) if "budget_window_secs" in d else None
            ),
            definitions=tuple(d.get("definitions", ())),
        )

    def build_definitions(self) -> list[SloDefinition]:
        defs = {s.name: s for s in BUILTIN_SLOS()}
        for raw in self.definitions:
            name = str(raw.get("name", ""))
            if not name:
                raise ValueError("slo definition without a name")
            if name in defs and "signal" not in raw:
                # partial override of a built-in (objective, windows,
                # enabled) without re-stating its signal
                base = defs[name]
                merged = {
                    "name": name,
                    "objective": raw.get("objective", base.objective),
                    "description": raw.get("description", base.description),
                    "enabled": raw.get("enabled", base.enabled),
                }
                windows = raw.get("windows")
                new = SloDefinition(
                    name=name,
                    objective=float(merged["objective"]),
                    signal=base.signal,
                    description=str(merged["description"]),
                    windows=(
                        tuple(BurnWindow.from_dict(w) for w in windows)
                        if windows
                        else base.windows
                    ),
                    enabled=bool(merged["enabled"]),
                )
                defs[name] = new
            else:
                defs[name] = SloDefinition.from_dict(raw)
        return [s for s in defs.values() if s.enabled]


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class _SloState:
    """Per-SLO sliding window of cumulative (t, bad, total) samples."""

    __slots__ = ("definition", "samples", "alerts", "no_data")

    def __init__(self, definition: SloDefinition):
        self.definition = definition
        self.samples: collections.deque = collections.deque()
        # one state per LADDER RUNG (keyed by index — severities may
        # repeat, e.g. the Workbook's 3-rung ladder has two page rungs,
        # and a later same-severity rung must not clobber an earlier
        # firing one): {"firing": bool, "since": unix}
        self.alerts = [
            {"firing": False, "since": None} for _ in definition.windows
        ]
        self.no_data = True

    def append(self, t: float, bad: float, total: float, retention_s: float) -> None:
        self.samples.append((t, bad, total))
        cutoff = t - retention_s
        while len(self.samples) > 1 and self.samples[1][0] <= cutoff:
            self.samples.popleft()

    def window_delta(self, window_s: float, now: float) -> tuple[float, float, float]:
        """(bad delta, total delta, actual covered seconds) between now
        and the newest sample at or before now-window (best effort: a
        freshly-started engine covers what it has)."""
        if not self.samples:
            return 0.0, 0.0, 0.0
        newest = self.samples[-1]
        cutoff = now - window_s
        base = self.samples[0]
        for s in self.samples:
            if s[0] <= cutoff:
                base = s
            else:
                break
        return (
            newest[1] - base[1],
            newest[2] - base[2],
            max(0.0, newest[0] - base[0]),
        )


class SloEngine:
    """Evaluates the definitions on a low-cadence thread (or on demand
    via evaluate_once for tests). Thread-safe snapshot readers:
    alertz_doc() for GET /alertz, status() for the /statusz section."""

    def __init__(
        self,
        definitions: list[SloDefinition] | None = None,
        interval_s: float = 10.0,
        window_scale: float = 1.0,
        budget_window_s: float | None = None,
        time_fn=time.time,
    ):
        self.interval_s = max(0.01, float(interval_s))
        self.window_scale = max(1e-9, float(window_scale))
        self._time = time_fn
        defs = BUILTIN_SLOS() if definitions is None else list(definitions)
        self._states = {d.name: _SloState(d) for d in defs if d.enabled}
        longest = max(
            (w.long_s for st in self._states.values() for w in st.definition.windows),
            default=3600.0,
        )
        self.budget_window_s = (
            float(budget_window_s)
            if budget_window_s is not None
            else longest * self.window_scale
        )
        self._retention_s = (
            max(longest * self.window_scale, self.budget_window_s) + 10 * self.interval_s
        )
        self._condition_state: dict = {}
        self._lock = threading.Lock()
        self._last_eval: float | None = None
        self._eval_count = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @classmethod
    def from_config(cls, cfg: SloEngineConfig, time_fn=time.time) -> "SloEngine":
        return cls(
            definitions=cfg.build_definitions(),
            interval_s=cfg.evaluation_interval_s,
            window_scale=cfg.window_scale,
            budget_window_s=cfg.budget_window_s,
            time_fn=time_fn,
        )

    # --- evaluation ---

    def evaluate_once(self, now: float | None = None) -> None:
        now = self._time() if now is None else now
        with self._lock:
            for st in self._states.values():
                try:
                    self._evaluate_slo(st, now)
                except Exception:
                    # one broken definition must not kill the ladder
                    log.exception("SLO %s evaluation failed", st.definition.name)
            self._last_eval = now
            self._eval_count += 1

    def _evaluate_slo(self, st: _SloState, now: float) -> None:
        d = st.definition
        bad, total, has_data = d.signal.read(self)
        st.no_data = not has_data
        if has_data:
            st.append(now, bad, total, self._retention_s)

        burns: dict[float, float] = {}
        for w in d.windows:
            for win_s in (w.long_s, w.short_s):
                if win_s not in burns:
                    burns[win_s] = self._burn(st, win_s * self.window_scale, now)
        # per-replica labels ({} until a fleet identity is configured):
        # N replicas' SLO engines exporting to one scrape plane stay
        # truthful — each replica's burn is its own series, never a
        # last-write-wins blend (docs/ARCHITECTURE.md "Running a fleet")
        rl = metrics.replica_labels()
        for win_s, burn in burns.items():
            metrics.slo_burn_rate.set(
                burn, slo=d.name, window=format_window(win_s), **rl
            )

        # budget remaining over the budget window
        bad_d, total_d, _ = st.window_delta(self.budget_window_s, now)
        err_ratio = (bad_d / total_d) if total_d > 0 else 0.0
        metrics.slo_error_budget_remaining.set(
            1.0 - err_ratio / d.budget, slo=d.name, **rl
        )

        severity_firing: dict[str, bool] = {}
        for i, w in enumerate(d.windows):
            firing = (
                burns[w.long_s] >= w.burn_rate and burns[w.short_s] >= w.burn_rate
            )
            state = st.alerts[i]
            if firing and not state["firing"]:
                state["firing"] = True
                state["since"] = now
                log.warning(
                    "SLO alert firing: %s severity=%s burn(long=%s)=%.1f "
                    "burn(short=%s)=%.1f threshold=%.1f",
                    d.name,
                    w.severity,
                    format_window(w.long_s),
                    burns[w.long_s],
                    format_window(w.short_s),
                    burns[w.short_s],
                    w.burn_rate,
                )
            elif not firing and state["firing"]:
                state["firing"] = False
                state["since"] = None
                log.info("SLO alert resolved: %s severity=%s", d.name, w.severity)
            # the gauge has one series per (alert, severity): it reads 1
            # while ANY rung of that severity fires
            severity_firing[w.severity] = (
                severity_firing.get(w.severity, False) or state["firing"]
            )
        for severity, firing in severity_firing.items():
            metrics.alert_active.set(
                1.0 if firing else 0.0, alert=d.name, severity=severity, **rl
            )

    def _burn(self, st: _SloState, window_s: float, now: float) -> float:
        bad_d, total_d, covered = st.window_delta(window_s, now)
        if total_d <= 0 or covered <= 0:
            return 0.0
        return (bad_d / total_d) / st.definition.budget

    # --- lifecycle ---

    def start(self) -> "SloEngine":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="slo-engine", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        # first pass immediately: a post-restart scrape must not wait a
        # full interval for the alert gauges to exist
        while True:
            try:
                self.evaluate_once()
            except Exception:
                log.exception("SLO evaluation pass failed")
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None

    # --- snapshots ---

    def alertz_doc(self) -> dict:
        """The GET /alertz payload."""
        with self._lock:
            now = self._time()
            slos = []
            alerts = []
            for st in self._states.values():
                d = st.definition
                window_burns = {}
                for w in d.windows:
                    for win_s in (w.long_s, w.short_s):
                        window_burns.setdefault(
                            format_window(win_s),
                            round(self._burn(st, win_s * self.window_scale, now), 4),
                        )
                bad_d, total_d, covered = st.window_delta(self.budget_window_s, now)
                err_ratio = (bad_d / total_d) if total_d > 0 else 0.0
                slo_doc = {
                    "name": d.name,
                    "description": d.description,
                    "objective": d.objective,
                    "signal_kind": d.signal.kind,
                    "no_data": st.no_data,
                    "burn_rates": window_burns,
                    "error_budget_remaining_ratio": round(
                        1.0 - err_ratio / d.budget, 4
                    ),
                    "budget_window_events": total_d,
                    "budget_window_bad_events": bad_d,
                    "budget_window_covered_s": round(covered, 3),
                    "evidence": d.signal.evidence(),
                }
                if isinstance(d.signal, LatencySignal):
                    slo_doc["effective_threshold_s"] = d.signal.effective_threshold_s()
                slos.append(slo_doc)
                for i, w in enumerate(d.windows):
                    state = st.alerts[i]
                    alerts.append(
                        {
                            "alert": d.name,
                            "severity": w.severity,
                            "state": "firing" if state["firing"] else "ok",
                            "burn_rate_threshold": w.burn_rate,
                            "long_window": format_window(w.long_s),
                            "short_window": format_window(w.short_s),
                            "burn_rate_long": round(
                                self._burn(st, w.long_s * self.window_scale, now), 4
                            ),
                            "burn_rate_short": round(
                                self._burn(st, w.short_s * self.window_scale, now), 4
                            ),
                            "firing_since_unix": state["since"],
                            **(
                                {"firing_for_s": round(now - state["since"], 3)}
                                if state["since"] is not None
                                else {}
                            ),
                        }
                    )
            return {
                "enabled": True,
                "evaluation_interval_s": self.interval_s,
                "window_scale": self.window_scale,
                "budget_window_s": self.budget_window_s,
                "last_evaluation_unix": self._last_eval,
                "evaluations": self._eval_count,
                "firing": sorted(
                    {
                        f'{a["alert"]}/{a["severity"]}'
                        for a in alerts
                        if a["state"] == "firing"
                    }
                ),
                "alerts": alerts,
                "slos": slos,
            }

    def status(self) -> dict:
        """The compact /statusz `slo` section."""
        doc = self.alertz_doc()
        return {
            "evaluations": doc["evaluations"],
            "last_evaluation_unix": doc["last_evaluation_unix"],
            "firing": doc["firing"],
            "budget_remaining": {
                s["name"]: s["error_budget_remaining_ratio"] for s in doc["slos"]
            },
            "no_data": sorted(s["name"] for s in doc["slos"] if s["no_data"]),
        }


# ---------------------------------------------------------------------------
# Process-wide engine (the health listener's /alertz reads it)
# ---------------------------------------------------------------------------

_engine: SloEngine | None = None
_engine_lock = threading.Lock()


def install_slo_engine(cfg: SloEngineConfig | None = None, start: bool = True) -> SloEngine:
    """Install (replacing any previous) the process-wide engine and
    register its /statusz section. janus_main calls this with the YAML
    stanza; tests/bench call it with a scaled config."""
    global _engine
    from .statusz import register_status_provider

    cfg = cfg or SloEngineConfig()
    engine = SloEngine.from_config(cfg)
    # one stable bound-method object per engine: the identity-guarded
    # unregister below must see the same callable that was registered
    engine._status_provider = engine.status
    with _engine_lock:
        prev, _engine = _engine, engine
    if prev is not None:
        prev.stop()
    register_status_provider("slo", engine._status_provider)
    if start:
        engine.start()
    return engine


def uninstall_slo_engine() -> None:
    global _engine
    from .statusz import unregister_status_provider

    with _engine_lock:
        engine, _engine = _engine, None
    if engine is not None:
        engine.stop()
        unregister_status_provider("slo", getattr(engine, "_status_provider", None))
    return None


def get_slo_engine() -> SloEngine | None:
    return _engine


def alertz_snapshot() -> dict:
    """The GET /alertz payload for this process: the installed engine's
    state, or a well-formed disabled document (every binary serves the
    route; a process without an engine — e.g. slo.enabled: false —
    still answers with valid JSON)."""
    engine = _engine
    if engine is None:
        return {"enabled": False, "firing": [], "alerts": [], "slos": []}
    return engine.alertz_doc()
