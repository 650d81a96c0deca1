"""Prometheus text-exposition parser, validator, and naming lint.

One minimal parser shared by three consumers so they can never
disagree about what "scrape-valid" means:

  - tests/test_metrics_exposition.py (every registered metric must
    render parseable output),
  - bench.py's --dry-run observability smoke (the served scrape must
    be valid end-to-end over HTTP),
  - scripts/scrape_check.py (deploy smoke check against a live
    aggregator).

Covers the subset of the format janus_tpu_torch.metrics emits: # HELP /
# TYPE comments, samples with escaped label values, histogram
_bucket/_sum/_count families, and — in OpenMetrics mode
(openmetrics=True, the `?openmetrics=1` exposition) — histogram-bucket
exemplars (`... # {trace_id="..."} value ts`) plus the `# EOF`
terminator. Not a general-purpose OpenMetrics parser.

The port's own copy of janus_tpu/exposition.py: each package's parser
accepts the other's rendering.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)$"
)

# Counters predating the *_total convention (reference-mirroring names,
# aggregator.rs:114-245). New counters MUST end in _total; these are
# the explicit grandfather list the naming lint accepts.
GRANDFATHERED_COUNTERS = frozenset(
    {
        "janus_upload_decrypt_failures",
        "janus_upload_replayed_reports",
        "janus_upload_decode_failures",
        "janus_aggregate_step_failures",
        "janus_job_cancellations",
        "janus_engine_oom_retries",
        "janus_engine_host_fallbacks",
        "janus_http_requests",
    }
)

# Histograms whose unit is a COUNT, not a duration (their name carries
# the unit implicitly). Everything else ending up as a histogram must
# be a duration and end _seconds.
SIZE_HISTOGRAMS = frozenset(
    {
        "janus_hpke_batch_size",
    }
)


class ExpositionError(ValueError):
    pass


@dataclass
class Family:
    name: str
    type: str = "untyped"
    help: str = ""
    # [(sample_name, labels dict, value)]
    samples: list = field(default_factory=list)
    # OpenMetrics mode: [(sample_name, labels dict, exemplar dict)]
    # where exemplar = {"labels": {...}, "value": float, "ts": float|None}
    exemplars: list = field(default_factory=list)


def _parse_labels(raw: str, errors: list[str], where: str) -> dict:
    """Parse `k="v",k2="v2"` honoring the exposition escapes
    (\\\\, \\", \\n) inside label values."""
    labels: dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        m = re.match(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"', raw[i:])
        if not m:
            errors.append(f"{where}: malformed label segment at {raw[i:]!r}")
            return labels
        key = m.group(1)
        i += m.end()
        out = []
        closed = False
        while i < n:
            c = raw[i]
            if c == "\\":
                if i + 1 >= n:
                    errors.append(f"{where}: dangling backslash in label value")
                    return labels
                esc = raw[i + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(esc, "\\" + esc))
                i += 2
            elif c == '"':
                closed = True
                i += 1
                break
            elif c == "\n":
                # a REAL newline inside a label value is the corruption
                # the escaping exists to prevent
                errors.append(f"{where}: unescaped newline in label value")
                return labels
            else:
                out.append(c)
                i += 1
        if not closed:
            errors.append(f"{where}: unterminated label value for {key}")
            return labels
        labels[key] = "".join(out)
        i += re.match(r"\s*,?", raw[i:]).end()
    return labels


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    return float(raw)


def _split_unquoted_hash(line: str) -> tuple[str, str | None]:
    """Split a sample line at the first '#' that sits OUTSIDE a quoted
    label value (the OpenMetrics exemplar marker). Returns
    (base, exemplar_clause or None); a '#' inside a label value —
    hostile task ids are legal — never splits."""
    in_q = False
    i, n = 0, len(line)
    while i < n:
        c = line[i]
        if c == "\\" and in_q:
            i += 2
            continue
        if c == '"':
            in_q = not in_q
        elif c == "#" and not in_q:
            return line[:i].rstrip(), line[i + 1 :].strip()
        i += 1
    return line, None


# OpenMetrics spec: the combined rune length of an exemplar's label
# names and values must not exceed 128
_EXEMPLAR_MAX_RUNES = 128


def _parse_exemplar(clause: str, errors: list[str], where: str) -> dict | None:
    """Parse `{labels} value [ts]` (the clause after the unquoted '#').
    Appends errors and returns None when malformed."""
    if not clause.startswith("{"):
        errors.append(f"{where}: malformed exemplar clause {clause!r}")
        return None
    # find the matching close brace outside quoted values
    in_q = False
    end = -1
    i = 1
    while i < len(clause):
        c = clause[i]
        if c == "\\" and in_q:
            i += 2
            continue
        if c == '"':
            in_q = not in_q
        elif c == "}" and not in_q:
            end = i
            break
        i += 1
    if end < 0:
        errors.append(f"{where}: unterminated exemplar label set")
        return None
    label_errors: list[str] = []
    labels = (
        _parse_labels(clause[1:end], label_errors, where) if end > 1 else {}
    )
    if label_errors:
        errors.extend(label_errors)
        return None
    runes = sum(len(k) + len(v) for k, v in labels.items())
    if runes > _EXEMPLAR_MAX_RUNES:
        errors.append(
            f"{where}: exemplar label set exceeds {_EXEMPLAR_MAX_RUNES} runes"
        )
        return None
    rest = clause[end + 1 :].split()
    if not rest or len(rest) > 2:
        errors.append(f"{where}: exemplar needs `value [timestamp]`, got {clause!r}")
        return None
    try:
        value = _parse_value(rest[0])
    except ValueError:
        errors.append(f"{where}: unparseable exemplar value {rest[0]!r}")
        return None
    ts = None
    if len(rest) == 2:
        try:
            ts = float(rest[1])
        except ValueError:
            errors.append(f"{where}: unparseable exemplar timestamp {rest[1]!r}")
            return None
    return {"labels": labels, "value": value, "ts": ts}


def parse_exposition(
    text: str, openmetrics: bool = False
) -> tuple[dict[str, Family], list[str]]:
    """-> ({family name: Family}, [error strings]). Sample names like
    foo_bucket/_sum/_count attach to their histogram family `foo`.
    With openmetrics=True, histogram-bucket/counter exemplars are
    parsed into Family.exemplars (malformed ones are errors) and a
    `# EOF` terminator line is accepted; in the default mode any
    exemplar clause is a parse error — the stock scrape must stay
    bit-compatible with the 0.0.4 text format."""
    families: dict[str, Family] = {}
    errors: list[str] = []
    saw_eof = False

    def family_for(sample_name: str) -> Family | None:
        if sample_name in families:
            return families[sample_name]
        for suffix in ("_bucket", "_sum", "_count"):
            if sample_name.endswith(suffix):
                base = sample_name[: -len(suffix)]
                fam = families.get(base)
                if fam is not None and fam.type == "histogram":
                    return fam
        return None

    for lineno, line in enumerate(text.splitlines(), 1):
        line = line.rstrip("\r")
        if not line.strip():
            continue
        where = f"line {lineno}"
        if saw_eof:
            errors.append(f"{where}: content after # EOF")
            break
        if openmetrics and line.strip() == "# EOF":
            saw_eof = True
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP ") :].split(" ", 1)
            name = parts[0]
            if not _NAME_RE.match(name):
                errors.append(f"{where}: bad metric name {name!r}")
                continue
            families.setdefault(name, Family(name)).help = (
                parts[1] if len(parts) > 1 else ""
            )
        elif line.startswith("# TYPE "):
            parts = line[len("# TYPE ") :].split(" ", 1)
            if len(parts) != 2 or parts[1] not in (
                "counter",
                "gauge",
                "histogram",
                "summary",
                "untyped",
            ):
                errors.append(f"{where}: bad TYPE line {line!r}")
                continue
            families.setdefault(parts[0], Family(parts[0])).type = parts[1]
        elif line.startswith("#"):
            continue  # other comments are legal
        else:
            exemplar = None
            if openmetrics:
                base, clause = _split_unquoted_hash(line)
                if clause is not None:
                    exemplar = _parse_exemplar(clause, errors, where)
                    if exemplar is None:
                        continue
                    line = base
            m = _SAMPLE_RE.match(line)
            if not m:
                errors.append(f"{where}: unparseable sample {line!r}")
                continue
            name = m.group("name")
            labels = (
                _parse_labels(m.group("labels"), errors, where)
                if m.group("labels") is not None
                else {}
            )
            try:
                value = _parse_value(m.group("value"))
            except ValueError:
                errors.append(f"{where}: unparseable value {m.group('value')!r}")
                continue
            fam = family_for(name)
            if fam is None:
                errors.append(f"{where}: sample {name!r} has no # TYPE family")
                continue
            if exemplar is not None:
                # OpenMetrics allows exemplars on histogram buckets and
                # counters only — and a bucket exemplar must sit within
                # its bucket's bound
                if name.endswith("_bucket") and fam.type == "histogram":
                    le = labels.get("le")
                    try:
                        bound = _parse_value(le) if le is not None else math.inf
                    except ValueError:
                        bound = math.inf
                    if exemplar["value"] > bound:
                        errors.append(
                            f"{where}: exemplar value {exemplar['value']:g} above "
                            f"bucket bound le={le}"
                        )
                        continue
                elif fam.type != "counter":
                    errors.append(
                        f"{where}: exemplar on a {fam.type} sample {name!r} "
                        "(only histogram buckets and counters may carry one)"
                    )
                    continue
                fam.exemplars.append((name, labels, exemplar))
            fam.samples.append((name, labels, value))
    if openmetrics and not saw_eof:
        errors.append("missing # EOF terminator (OpenMetrics mode)")
    return families, errors


def _histogram_errors(fam: Family) -> list[str]:
    """Bucket monotonicity + _sum/_count consistency per label set."""
    errors: list[str] = []
    by_key: dict[tuple, dict] = {}
    for name, labels, value in fam.samples:
        key_labels = {k: v for k, v in labels.items() if k != "le"}
        key = tuple(sorted(key_labels.items()))
        ent = by_key.setdefault(key, {"buckets": [], "sum": None, "count": None})
        if name.endswith("_bucket"):
            if "le" not in labels:
                errors.append(f"{fam.name}: _bucket sample without le label")
                continue
            ent["buckets"].append((_parse_value(labels["le"]), value))
        elif name.endswith("_sum"):
            ent["sum"] = value
        elif name.endswith("_count"):
            ent["count"] = value
    for key, ent in by_key.items():
        lbl = dict(key)
        buckets = sorted(ent["buckets"])
        if not buckets:
            errors.append(f"{fam.name}{lbl}: histogram label set without buckets")
            continue
        if buckets[-1][0] != math.inf:
            errors.append(f"{fam.name}{lbl}: missing +Inf bucket")
        prev = -math.inf
        for le, v in buckets:
            if v < prev:
                errors.append(f"{fam.name}{lbl}: bucket counts not monotone at le={le}")
            prev = v
        if ent["count"] is None or ent["sum"] is None:
            errors.append(f"{fam.name}{lbl}: missing _sum/_count")
            continue
        if buckets[-1][0] == math.inf and buckets[-1][1] != ent["count"]:
            errors.append(
                f"{fam.name}{lbl}: +Inf bucket {buckets[-1][1]} != _count {ent['count']}"
            )
        if ent["count"] == 0 and ent["sum"] not in (0, 0.0):
            errors.append(f"{fam.name}{lbl}: zero count with nonzero sum")
    return errors


def validate_exposition(text: str, openmetrics: bool = False) -> list[str]:
    """Full scrape validation: parse errors + per-family semantic checks.
    Empty list = scrape-valid. openmetrics=True validates the exemplar
    exposition mode (exemplar syntax + # EOF terminator)."""
    families, errors = parse_exposition(text, openmetrics=openmetrics)
    for fam in families.values():
        if fam.type == "histogram":
            errors.extend(_histogram_errors(fam))
        elif fam.type == "counter":
            for _, _, value in fam.samples:
                if value < 0:
                    errors.append(f"{fam.name}: negative counter value {value}")
    return errors


def lint_metric_names(
    names_by_type: dict[str, str], grandfathered: frozenset = GRANDFATHERED_COUNTERS
) -> list[str]:
    """Naming-convention lint over {family name: type}: every metric is
    janus_-prefixed; counters end _total unless explicitly
    grandfathered; duration histograms end _seconds."""
    errors = []
    for name, typ in sorted(names_by_type.items()):
        if not name.startswith("janus_"):
            errors.append(f"{name}: metric names must start with janus_")
        if typ == "counter" and not name.endswith("_total") and name not in grandfathered:
            errors.append(f"{name}: counters must end _total (or be grandfathered)")
        if (
            typ == "histogram"
            and not name.endswith("_seconds")
            and name not in SIZE_HISTOGRAMS
        ):
            errors.append(f"{name}: duration histograms must end _seconds")
    return errors


def registry_names_by_type(registry) -> dict[str, str]:
    """{name: type} for a janus_tpu_torch.metrics.MetricsRegistry (the lint's
    input when checking the live registry rather than a scrape)."""
    from . import metrics as m

    out = {}
    for metric in registry.metrics_list():
        if isinstance(metric, m.Counter):
            out[metric.name] = "counter"
        elif isinstance(metric, m.Gauge):
            out[metric.name] = "gauge"
        elif isinstance(metric, m.Histogram):
            out[metric.name] = "histogram"
    return out


def validate_collapsed(text: str) -> list[str]:
    """Well-formedness errors of a collapsed-stack (flamegraph.pl)
    document: every non-empty line is `frame;frame;... count` with an
    integer count and non-empty, whitespace-free frame components (the
    profiler's sanitizer guarantees this even for hostile thread/frame
    names — tools/scrape_check.py and the tests enforce it stays true).
    It lives here, with the other scrape validators, so that the deploy
    check imports no torch; profiler.py re-exports it."""
    errors = []
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        stack, sep, count = line.rpartition(" ")
        if not sep or not count.isdigit():
            errors.append(f"line {i}: no trailing integer count: {line[:80]!r}")
            continue
        if not stack:
            errors.append(f"line {i}: empty stack: {line[:80]!r}")
            continue
        for comp in stack.split(";"):
            if not comp or any(c in comp for c in " \t\n\r"):
                errors.append(
                    f"line {i}: bad frame component {comp[:40]!r}: {line[:80]!r}"
                )
                break
    return errors
