"""Render the in-process SLO definitions as a Prometheus rule file.

    python -m janus_tpu_torch.tools.gen_alert_rules [--check PATH]

The port's counterpart of janus_tpu's generator, over the port's own
`slo.BUILTIN_SLOS` (janus_tpu_torch/slo.py). Everything after the
header is byte-identical to janus_tpu's output, so one checked-in rule
file (docs/alerts/janus-alerts.yaml) serves both deployments; `--check`
compares the rules after each text's leading comment header, since the
file's header names janus_tpu's generator.

Translation notes (best effort, semantics documented in
docs/OBSERVABILITY.md):
  - counter-ratio and latency SLOs become multi-window multi-burn-rate
    expressions (SRE Workbook ch. 5): both the long and the short
    window must exceed `burn_rate x budget`.
  - condition SLOs (datastore-up, device health) become direct
    threshold alerts with `for:` set to the rung's short window.
  - trend SLOs (resource leaks) alert while the flight recorder's
    janus_flight_leak_active verdict gauge is nonzero for the rung's
    short window.
  - conservation SLOs (report-flow ledger) alert while any
    janus_ledger_breach_active series is nonzero for the rung's short
    window.
"""

from __future__ import annotations

import argparse
import sys

from ..slo import (
    BUILTIN_SLOS,
    ConditionSignal,
    ConservationSignal,
    LatencySignal,
    RatioSignal,
    SloDefinition,
    TrendSignal,
    format_window,
)

HEADER = """\
# GENERATED FILE — DO NOT EDIT.
#
# Prometheus alerting rules generated from janus_tpu_torch's in-process
# SLO definitions (janus_tpu_torch/slo.py BUILTIN_SLOS) by
#   python -m janus_tpu_torch.tools.gen_alert_rules
# The rules below this header are byte-identical to janus_tpu's
# generator's; regenerate instead of editing.
"""

def _matchers_promql(compiled: tuple) -> str:
    parts = []
    for name, kind, want in compiled:
        if kind == "eq":
            parts.append(f'{name}="{want}"')
        elif kind == "re":
            parts.append(f'{name}=~"{want.pattern}"')
        else:  # "in"
            parts.append(f'{name}=~"{"|".join(sorted(want))}"')
    return "{" + ",".join(parts) + "}" if parts else ""


def _ratio_rate(selectors, window: str) -> str:
    terms = [
        f"sum(rate({s.metric}{_matchers_promql(s.labels)}[{window}]))"
        for s in selectors
    ]
    return " + ".join(terms) if len(terms) > 1 else terms[0]


def _ratio_err_expr(sig: RatioSignal, window: str) -> str:
    bad = _ratio_rate(sig.bad, window)
    total = _ratio_rate(tuple(sig.good) + tuple(sig.bad), window)
    return f"(({bad}) / (({total}) > 0))"


def _latency_err_expr(sig: LatencySignal, window: str) -> str:
    le = f"{sig.effective_threshold_s():g}"
    base = _matchers_promql(sig.labels)
    # splice le into the bucket selector
    if base:
        bucket_sel = base[:-1] + f',le="{le}"}}'
    else:
        bucket_sel = f'{{le="{le}"}}'
    good = f"sum(rate({sig.metric}_bucket{bucket_sel}[{window}]))"
    total = f"sum(rate({sig.metric}_count{base}[{window}]))"
    return f"(1 - (({good}) / (({total}) > 0)))"


def _condition_expr(sig: ConditionSignal, short_window: str) -> str:
    parts = []
    for cond in sig.conditions:
        sel = f"{cond.selector.metric}{_matchers_promql(cond.selector.labels)}"
        if cond.mode == "delta":
            parts.append(f"(increase({sel}[{short_window}]) {cond.op} {cond.value:g})")
        else:
            parts.append(f"(sum({sel}) {cond.op} {cond.value:g})")
    return " or ".join(parts)


def _alert_name(slo_name: str, severity: str) -> str:
    camel = "".join(p.capitalize() for p in slo_name.split("_"))
    return f"Janus{camel}{severity.capitalize()}"


def rules_for(defs: list[SloDefinition]) -> dict:
    rules = []
    for d in defs:
        budget = d.budget
        for w in d.windows:
            long_w, short_w = format_window(w.long_s), format_window(w.short_s)
            threshold = f"({w.burn_rate:g} * {budget:g})"
            if isinstance(d.signal, RatioSignal):
                expr = (
                    f"{_ratio_err_expr(d.signal, long_w)} > {threshold}\n"
                    f"and\n"
                    f"{_ratio_err_expr(d.signal, short_w)} > {threshold}"
                )
                for_ = None
            elif isinstance(d.signal, LatencySignal):
                expr = (
                    f"{_latency_err_expr(d.signal, long_w)} > {threshold}\n"
                    f"and\n"
                    f"{_latency_err_expr(d.signal, short_w)} > {threshold}"
                )
                for_ = None
            elif isinstance(d.signal, ConditionSignal):
                expr = _condition_expr(d.signal, short_w)
                for_ = short_w
            elif isinstance(d.signal, ConservationSignal):
                # the ledger already held the residual through its
                # grace window before raising the breach gauge, so a
                # threshold alert on the debounced verdict is faithful
                sel = f"{d.signal.metric}{_matchers_promql(d.signal.labels)}"
                expr = f"(sum({sel}) > 0)"
                for_ = short_w
            elif isinstance(d.signal, TrendSignal):
                # like conditions: the leak-verdict gauge is already a
                # debounced boolean, so a threshold alert held for the
                # rung's short window is the faithful translation
                sel = f"{d.signal.metric}{_matchers_promql(d.signal.labels)}"
                expr = f"(sum({sel}) > 0)"
                for_ = short_w
            else:  # pragma: no cover - new signal kinds must be added here
                raise TypeError(f"no PromQL translation for {type(d.signal).__name__}")
            rule = {
                "alert": _alert_name(d.name, w.severity),
                "expr": expr,
            }
            if for_ is not None:
                rule["for"] = for_
            rule["labels"] = {"severity": w.severity, "slo": d.name}
            rule["annotations"] = {
                "summary": f"{d.name}: burn rate over {w.burn_rate:g}x "
                f"(objective {d.objective:g})",
                "description": d.description
                or f"SLO {d.name} is burning its error budget at more than "
                f"{w.burn_rate:g}x over both the {long_w} and {short_w} windows.",
                "runbook": "GET /alertz on the affected binary for burn rates, "
                "budget and evidence; scripts/debug_bundle.py for a snapshot.",
            }
            rules.append(rule)
    return {"groups": [{"name": "janus-slo-burn-rates", "rules": rules}]}


def generate_rules_text(defs: list[SloDefinition] | None = None) -> str:
    import yaml

    doc = rules_for(BUILTIN_SLOS() if defs is None else defs)
    return HEADER + yaml.safe_dump(doc, sort_keys=False, default_flow_style=False)


def rules_body(text: str) -> str:
    """The rules of a generated text: everything after its leading
    comment header (the header names the generator that wrote it)."""
    lines = text.splitlines(keepends=True)
    i = 0
    while i < len(lines) and lines[i].startswith("#"):
        i += 1
    return "".join(lines[i:])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--check",
        metavar="PATH",
        help="exit non-zero unless PATH's rules (after its header) match "
        "the generated rules (the CI sync check)",
    )
    args = ap.parse_args(argv)
    text = generate_rules_text()
    if args.check:
        with open(args.check) as f:
            on_disk = f.read()
        if rules_body(on_disk) != rules_body(text):
            print(
                f"{args.check} is out of date: regenerate with "
                "python -m janus_tpu_torch.tools.gen_alert_rules > " + args.check,
                file=sys.stderr,
            )
            return 1
        print(f"{args.check} is in sync")
        return 0
    sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
