"""janus_tpu_torch's metrics registry and exposition held against janus_tpu's.

- The registries: the same 107 families, by name, type and help string
  (janus_build_info's help names its `torch` label where janus_tpu's
  names `jax`), and the same span->metric bridges.
- The label names: every call site of the port that feeds a family
  (an `.add`, `.set` or `.observe` on it, found by parsing the package's
  sources) uses a label-name set that janus_tpu's call sites of that
  family use too; janus_build_info's labels are janus_tpu's with `torch`
  for `jax`.
- Each package's parser accepts the other's rendering, in both formats,
  after the same seeded sequence of adds, sets and observes on fresh
  registries, and the two renderings are equal.
- tests/test_metrics_exposition.py's registry and format cases, held
  against both packages (`pkg` parameter).
"""

import ast
import random
import sys
import time
from pathlib import Path

import pytest

import janus_tpu
import janus_tpu_torch
from janus_tpu import exposition as j_expo
from janus_tpu import metrics as j_metrics
from janus_tpu import trace as j_trace
from janus_tpu_torch import exposition as t_expo
from janus_tpu_torch import metrics as t_metrics
from janus_tpu_torch import trace as t_trace

PKGS = {
    "jax": (j_metrics, j_expo, j_trace),
    "torch": (t_metrics, t_expo, t_trace),
}


def _families(metrics_mod) -> dict:
    """{name: (type, help)} of the families the module defines."""
    out = {}
    for v in vars(metrics_mod).values():
        for kind, cls in (("counter", metrics_mod.Counter), ("gauge", metrics_mod.Gauge),
                          ("histogram", metrics_mod.Histogram)):
            if type(v) is cls:
                out[v.name] = (kind, v.help)
    return out


def test_the_same_107_families_types_and_help():
    port, ref = _families(t_metrics), _families(j_metrics)
    assert len(port) == 107 and set(port) == set(ref)
    assert {n: t for n, (t, _) in port.items()} == {n: t for n, (t, _) in ref.items()}
    differ = {n for n in port if port[n][1] != ref[n][1]}
    assert differ == {"janus_build_info"}
    assert port["janus_build_info"][1] == ref["janus_build_info"][1].replace("/jax/", "/torch/")
    names = t_expo.registry_names_by_type(t_metrics.REGISTRY)
    assert {n: t for n, (t, _) in port.items()}.items() <= names.items()
    assert t_expo.lint_metric_names(names) == []


def test_the_same_span_bridges_and_transfer_hooks():
    from janus_tpu import profiler as j_profiler
    from janus_tpu_torch import profiler as t_profiler

    def bridges(trace_mod):
        return {name: (h.name, tuple(sorted(labels.items())), args)
                for name, (h, labels, args) in trace_mod._span_metrics.items() if name.startswith("engine.")}

    assert bridges(t_trace) == bridges(j_trace)
    assert t_profiler._TRANSFER_SPANS == j_profiler._TRANSFER_SPANS
    assert set(t_trace._span_hooks) >= set(t_profiler._TRANSFER_SPANS)


def _label_sets(pkg_root: Path, families: set) -> dict:
    """{family attribute: {frozenset of label names}} over every
    `<family>.add/.set/.observe(...)` call in the package (a `**` splat
    counts as the label "**")."""
    out: dict = {}
    for path in pkg_root.rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("add", "set", "observe")):
                continue
            target = node.func.value
            name = target.attr if isinstance(target, ast.Attribute) else getattr(target, "id", None)
            if name not in families:
                continue
            labels = frozenset("**" if k.arg is None else k.arg for k in node.keywords
                               if k.arg != "exemplar_trace_id")
            out.setdefault(name, set()).add(labels)
    return out


def test_call_site_label_names_are_janus_tpus():
    attrs = {k for k, v in vars(t_metrics).items() if isinstance(v, (t_metrics.Counter, t_metrics.Gauge,
                                                                     t_metrics.Histogram))}
    port = _label_sets(Path(janus_tpu_torch.__file__).parent, attrs)
    ref = _label_sets(Path(janus_tpu.__file__).parent, attrs)
    assert len(port) >= 80, sorted(attrs - set(port))
    for fam, sets in port.items():
        if fam == "build_info":
            continue
        assert sets <= ref.get(fam, set()), (fam, sets, ref.get(fam))
    assert port["build_info"] == {frozenset({"version", "python", "torch", "backend"})}
    assert ref["build_info"] == {frozenset({"version", "python", "jax", "backend"})}


def _seeded_ops(metrics_mod, seed: int):
    """A fresh registry after a seeded sequence of adds, sets and
    observes over a few families, hostile label values included."""
    rng = random.Random(seed)
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("janus_parity_events_total", "events")
    g = reg.gauge("janus_parity_depth", "depth")
    h = reg.histogram("janus_parity_op_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    values = ["a", "b", 'quote"d', "new\nline", "back\\slash", "# {fake} 1"]
    for i in range(200):
        op = rng.choice(values)
        c.add(rng.randint(1, 5), op=op)
        g.set(rng.random() * 100, op=op)
        g.add(1, op="x")
        h.observe(rng.random() * 2, exemplar_trace_id=f"{rng.getrandbits(128):032x}" if i % 3 == 0 else None,
                  op=rng.choice(values[:2]))
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
def test_each_parser_accepts_the_others_rendering(openmetrics):
    j_text = _seeded_ops(j_metrics, 7).render(openmetrics=openmetrics)
    t_text = _seeded_ops(t_metrics, 7).render(openmetrics=openmetrics)
    # the exemplars' timestamps are the only thing two runs differ in
    strip = (lambda s: "\n".join(line.split(" # {trace_id")[0] for line in s.splitlines()))
    assert strip(t_text) == strip(j_text)
    for text in (j_text, t_text):
        for expo in (j_expo, t_expo):
            assert expo.validate_exposition(text, openmetrics=openmetrics) == []
        j_fams, _ = j_expo.parse_exposition(text, openmetrics=openmetrics)
        t_fams, _ = t_expo.parse_exposition(text, openmetrics=openmetrics)
        assert {n: f.samples for n, f in j_fams.items()} == {n: f.samples for n, f in t_fams.items()}


def test_full_registries_render_valid_in_both_parsers():
    for metrics_mod in (j_metrics, t_metrics):
        for openmetrics in (False, True):
            text = metrics_mod.REGISTRY.render(openmetrics=openmetrics)
            assert j_expo.validate_exposition(text, openmetrics=openmetrics) == []
            assert t_expo.validate_exposition(text, openmetrics=openmetrics) == []


def test_build_info_carries_the_torch_label():
    import torch

    t_metrics.register_build_info(backend="probe-card")
    try:
        info = t_metrics.REGISTRY.snapshot()["janus_build_info"]
        (live,) = [s for s in info["samples"] if s["value"] == 1]
        assert set(live["labels"]) == {"version", "python", "torch", "backend"}
        assert live["labels"]["torch"].startswith(torch.__version__)
        assert live["labels"]["backend"] == "probe-card"
    finally:
        t_metrics.register_build_info()


def test_replica_identity_labels_as_janus_tpu():
    from janus_tpu_torch.config import FleetConfig

    try:
        FleetConfig(replica_id="replica-7", shard_count=4, shard_index=5).install_identity()
        assert t_metrics.replica_labels() == {"replica": "replica-7"}
        (live,) = [s for s in t_metrics.REGISTRY.snapshot()["janus_replica_info"]["samples"] if s["value"] == 1]
        assert live["labels"] == {"replica_id": "replica-7", "shard_index": "1", "shard_count": "4"}
    finally:
        t_metrics.set_replica_identity()
    assert t_metrics.replica_labels() == {}


# --- tests/test_metrics_exposition.py's registry and format cases, on both packages ---


@pytest.mark.parametrize("pkg", PKGS)
def test_label_escaping_roundtrip(pkg):
    m, expo, _ = PKGS[pkg]
    hostile = 'task"id\nwith\\everything'
    c = m.Counter("janus_escape_test_total", "escaping probe")
    c.add(3, task=hostile)
    sample_lines = [line for line in c.render().splitlines() if not line.startswith("#")]
    assert len(sample_lines) == 1
    families, errors = expo.parse_exposition(f"# HELP {c.name} x\n# TYPE {c.name} counter\n" + sample_lines[0])
    assert not errors
    ((_, labels, value),) = families[c.name].samples
    assert labels["task"] == hostile and value == 3.0


@pytest.mark.parametrize("pkg", PKGS)
def test_unescaped_scrape_would_be_rejected(pkg):
    _, expo, _ = PKGS[pkg]
    _, errors = expo.parse_exposition('# TYPE janus_x_total counter\njanus_x_total{a="broken\nvalue"} 1\n')
    assert errors


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_bucket_monotonicity_and_sums(pkg):
    m, expo, _ = PKGS[pkg]
    h = m.Histogram("janus_mono_test_seconds", "probe", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v, op="x")
    families, errors = expo.parse_exposition(
        "# HELP janus_mono_test_seconds p\n# TYPE janus_mono_test_seconds histogram\n"
        + "\n".join(line for line in h.render().splitlines() if not line.startswith("#"))
    )
    assert not errors
    samples = families["janus_mono_test_seconds"].samples
    buckets = [(labels["le"], v) for name, labels, v in samples if name.endswith("_bucket")]
    counts = [v for _, v in buckets]
    assert counts == sorted(counts)
    count = next(v for name, _, v in samples if name.endswith("_count"))
    assert count == 5 and next(v for le, v in buckets if le == "+Inf") == count
    assert next(v for name, _, v in samples if name.endswith("_sum")) == pytest.approx(56.05)


@pytest.mark.parametrize("pkg", PKGS)
def test_naming_lint_flags_violations(pkg):
    _, expo, _ = PKGS[pkg]
    errs = expo.lint_metric_names({
        "not_janus_thing": "gauge",
        "janus_new_counter": "counter",
        "janus_upload_decrypt_failures": "counter",
        "janus_some_duration": "histogram",
    })
    assert any("not_janus_thing" in e for e in errs)
    assert any("janus_new_counter" in e for e in errs)
    assert any("janus_some_duration" in e for e in errs)
    assert not any("janus_upload_decrypt_failures" in e for e in errs)


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_gauge_locked_reads_and_totals(pkg):
    m, _, _ = PKGS[pkg]
    g = m.Gauge("janus_gauge_probe", "probe")
    g.set(2.0, k="a")
    g.add(3.0, k="b")
    assert g.get(k="a") == 2.0 and g.total() == 5.0
    c = m.Counter("janus_counter_probe_total", "probe")
    c.add(4, k="a")
    assert c.get(k="a") == 4.0 and c.total() == 4.0


@pytest.mark.parametrize("pkg", PKGS)
def test_span_metric_bridge_records_duration_with_labels(pkg):
    m, _, tr = PKGS[pkg]
    h = m.Histogram("janus_bridge_probe_seconds", "probe")
    tr.register_span_metric("bridge.probe", h, labels={"op": "x", "phase": "put"}, arg_labels=("vdaf",))
    try:
        with tr.span("bridge.probe", vdaf="count"):
            time.sleep(0.01)
        key = (("op", "x"), ("phase", "put"), ("vdaf", "count"))
        assert h._totals[key] == 1 and h._sums[key] >= 0.01
        with tr.span("bridge.probe"):
            pass
        assert h._totals[(("op", "x"), ("phase", "put"))] == 1
    finally:
        tr._span_metrics.pop("bridge.probe", None)


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_exemplar_storage_and_openmetrics_render(pkg):
    m, _, _ = PKGS[pkg]
    h = m.Histogram("janus_t_ex_seconds", "t", buckets=(0.1, 1.0))
    h.observe(0.05, exemplar_trace_id="ab" * 16, route="u")
    h.observe(0.5, exemplar_trace_id=0x1234, route="u")
    h.observe(7.0, exemplar_trace_id="cd" * 16, route="u")
    assert " # {" not in h.render()
    om = h.render(openmetrics=True)
    assert '# {trace_id="' + "ab" * 16 + '"} 0.05' in om and '# {trace_id="cd' in om
    h.observe(0.06, exemplar_trace_id="ef" * 16, route="u")
    om = h.render(openmetrics=True)
    assert "ab" * 16 not in om and "ef" * 16 in om
    assert {e["le"] for e in h.exemplars()} == {"0.1", "1", "+Inf"}


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_exemplar_from_ambient_trace_context(pkg):
    m, _, tr = PKGS[pkg]
    h = m.Histogram("janus_t_ex2_seconds", "t")
    with tr.span("t.exemplar_ambient"):
        want = tr.trace_id_of(tr.current_traceparent())
        h.observe(0.2)
    (ex,) = h.exemplars()
    assert ex["trace_id"] == want
    h2 = m.Histogram("janus_t_ex3_seconds", "t")
    h2.observe(0.2)
    assert h2.exemplars() == []


@pytest.mark.parametrize("pkg", PKGS)
def test_histogram_exemplar_label_set_bound(pkg):
    m, _, _ = PKGS[pkg]
    h = m.Histogram("janus_t_ex4_seconds", "t")
    for i in range(m.Histogram.MAX_EXEMPLAR_LABEL_SETS + 10):
        h.observe(0.2, exemplar_trace_id="aa" * 16, series=str(i))
    assert len(h._exemplars) == m.Histogram.MAX_EXEMPLAR_LABEL_SETS
    assert sum(h._totals.values()) == m.Histogram.MAX_EXEMPLAR_LABEL_SETS + 10


@pytest.mark.parametrize("pkg", PKGS)
def test_openmetrics_parser_accepts_and_rejects_exemplars(pkg):
    _, expo, _ = PKGS[pkg]
    header = "# HELP x_seconds t\n# TYPE x_seconds histogram\n"
    tail = 'x_seconds_bucket{le="+Inf"} 1\nx_seconds_sum 0.05\nx_seconds_count 1\n# EOF\n'
    good = header + 'x_seconds_bucket{le="0.1"} 1 # {trace_id="abc"} 0.05 1700000000.0\n' + tail
    assert expo.validate_exposition(good, openmetrics=True) == []
    fams, _ = expo.parse_exposition(good, openmetrics=True)
    (_, _, ex) = fams["x_seconds"].exemplars[0]
    assert ex == {"labels": {"trace_id": "abc"}, "value": 0.05, "ts": 1700000000.0}
    assert expo.validate_exposition(good) != []
    bad = header + 'x_seconds_bucket{le="0.1"} 1 # {trace_id="abc"} 5.0\n' + tail
    assert any("above bucket bound" in e for e in expo.validate_exposition(bad, openmetrics=True))
    bad = '# TYPE g gauge\ng 1 # {trace_id="a"} 0.5\n# EOF\n'
    assert any("only histogram buckets" in e for e in expo.validate_exposition(bad, openmetrics=True))
    bad = header + 'x_seconds_bucket{le="0.1"} 1 # {trace_id="a 0.05\n' + tail
    assert any("unterminated" in e for e in expo.validate_exposition(bad, openmetrics=True))
    bad = header + 'x_seconds_bucket{le="0.1"} 1 # {trace_id="a"} zap\n' + tail
    assert any("unparseable exemplar value" in e for e in expo.validate_exposition(bad, openmetrics=True))
    assert any("missing # EOF" in e
               for e in expo.validate_exposition(header + tail.replace("# EOF\n", ""), openmetrics=True))
    assert any("content after # EOF" in e
               for e in expo.validate_exposition(good + "x_seconds_count 2\n", openmetrics=True))


@pytest.mark.parametrize("pkg", PKGS)
def test_hash_inside_label_value_is_not_an_exemplar(pkg):
    m, expo, _ = PKGS[pkg]
    c = m.Counter("janus_t_hash_total", "t")
    c.add(reason='before # {fake="exemplar"} 1 after')
    text = "# TYPE janus_t_hash_total counter\n" + c.render().splitlines()[-1] + "\n# EOF\n"
    fams, errors = expo.parse_exposition(text, openmetrics=True)
    assert errors == [] and fams["janus_t_hash_total"].exemplars == []
    assert fams["janus_t_hash_total"].samples[0][1]["reason"] == 'before # {fake="exemplar"} 1 after'


@pytest.mark.parametrize("pkg", PKGS)
def test_registry_openmetrics_mode_is_superset_and_default_unchanged(pkg):
    m, expo, _ = PKGS[pkg]
    reg = m.MetricsRegistry()
    reg.counter("janus_t_probe_total", "t").add(2)
    h = reg.histogram("janus_t_ex6_seconds", "t")
    h.observe(0.2, exemplar_trace_id="ab" * 16)
    default = reg.render()
    assert " # {" not in default
    om = reg.render(openmetrics=True)
    assert om.rstrip().endswith("# EOF") and expo.validate_exposition(om, openmetrics=True) == []
    fams_om, _ = expo.parse_exposition(om, openmetrics=True)
    fams_def, _ = expo.parse_exposition(default)
    assert set(fams_om) == set(fams_def)


@pytest.mark.parametrize("pkg", PKGS)
def test_process_start_time_and_one_live_build_info(pkg):
    m, _, _ = PKGS[pkg]
    m.register_build_info(backend="cpu")
    try:
        (live,) = [s for s in m.REGISTRY.snapshot()["janus_build_info"]["samples"] if s["value"] == 1]
        assert live["labels"]["backend"] == "cpu"
        assert live["labels"]["python"] == "%d.%d.%d" % sys.version_info[:3]
        assert 0 < m.process_start_time_seconds.get() <= time.time()
    finally:
        m.register_build_info()


@pytest.mark.parametrize("pkg", PKGS)
def test_statusz_survives_a_broken_provider_and_escapes_html(pkg):
    statusz = __import__(f"{'janus_tpu' if pkg == 'jax' else 'janus_tpu_torch'}.statusz", fromlist=["x"])

    def broken():
        raise RuntimeError("boom")

    statusz.register_status_provider("zz_broken", broken)
    statusz.register_status_provider("zz_hostile", lambda: {"task": "<script>alert(1)</script>"})
    try:
        snap = statusz.status_snapshot()
        assert snap["zz_broken"] == {"error": "RuntimeError: boom"}
        html = statusz.render_statusz_html(snap)
        assert "<script>" not in html and "&lt;script&gt;" in html
    finally:
        statusz.unregister_status_provider("zz_broken")
        statusz.unregister_status_provider("zz_hostile")
    assert "zz_broken" not in statusz.status_snapshot()
