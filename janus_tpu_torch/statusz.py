"""/statusz provider registry: one JSON/HTML snapshot per process.

The reference exposes operational state through its aggregator-api and
OTel resources; here every subsystem that owns interesting state
registers a named provider callable and the health listener
(binary_utils.HealthServer) renders the union at GET /statusz —
build/process info, configured tasks, engine-cache state (bucket caps,
backend, OOM history), ingest pipeline occupancy, and the job backlog
from the health sampler.

Providers must be cheap and must never raise into the handler: a
provider error renders as {"error": ...} under its section instead of
failing the whole snapshot.

The port's own copy of janus_tpu/statusz.py, served at GET /statusz by
every binary's health listener (binary_utils.HealthServer).
"""

from __future__ import annotations

import html
import json
import threading
import time

_lock = threading.Lock()
_providers: dict[str, object] = {}


def register_status_provider(name: str, fn) -> None:
    """Register (or replace) the section `name`; `fn()` returns any
    JSON-serializable value."""
    with _lock:
        _providers[name] = fn


def unregister_status_provider(name: str, fn=None) -> None:
    """Remove the section `name`. With `fn`, remove only if it is still
    the registered provider — a closing subsystem must not tear down a
    successor's registration (latest registration wins)."""
    with _lock:
        if fn is None or _providers.get(name) is fn:
            _providers.pop(name, None)


def status_snapshot() -> dict:
    with _lock:
        providers = dict(_providers)
    out: dict = {"generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    for name, fn in sorted(providers.items()):
        try:
            out[name] = fn()
        except Exception as e:  # a broken provider must not kill /statusz
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def render_statusz_html(snapshot: dict) -> str:
    """Minimal dependency-free HTML view of the snapshot (one <section>
    per provider, pretty-printed JSON bodies). Every provider-supplied
    string — section names and values alike — must pass through
    html.escape before it reaches the page: hostile label values (a
    task id carrying <script>) render inert, pinned by
    tests/test_metrics_exposition.py::test_statusz_html_escapes_hostile_values."""
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        "<title>janus_tpu statusz</title>",
        "<style>body{font-family:monospace;margin:2em;}h2{border-bottom:1px solid #999;}"
        "pre{background:#f4f4f4;padding:0.6em;overflow-x:auto;}</style>",
        "</head><body><h1>janus_tpu /statusz</h1>",
    ]
    for name, value in snapshot.items():
        if name == "generated_at":
            parts.append(f"<p>generated at {html.escape(str(value))}</p>")
            continue
        body = html.escape(json.dumps(value, indent=2, default=str))
        parts.append(f"<h2>{html.escape(name)}</h2><pre>{body}</pre>")
    parts.append("</body></html>")
    return "".join(parts)
