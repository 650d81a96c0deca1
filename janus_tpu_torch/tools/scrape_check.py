"""Deploy smoke check: scrape a running aggregator's health listener
and validate the output with the same exposition parser the tests use.

    python -m janus_tpu_torch.tools.scrape_check --url http://127.0.0.1:9001 [--statusz]

Exit status 0 when /metrics parses clean (and, with --statusz, the
/statusz snapshot is well-formed JSON with the expected sections);
non-zero with the errors on stderr otherwise.

The port's counterpart of janus_tpu's scripts/scrape_check.py, over the
port's own exposition parser and HTTP helper. It keeps every family
check and every section check, the `engine_prewarm` section's (compile
cache, kernel-library cache, manifest, prewarm) among them. Two keys are
read under the port's names: janus_build_info's `torch`
label where janus_tpu's carries `jax`, and the device watchdog's
`device_down` (the port moves no work to the host at the thread cap)
where janus_tpu's has `host_only`.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.request

from ..exposition import lint_metric_names, parse_exposition, validate_collapsed, validate_exposition


def _fetch(url: str, timeout: float) -> tuple[str, str]:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8"), resp.headers.get("Content-Type", "")


def _fetch_any_status(url: str, timeout: float) -> tuple[int, str]:
    """(status, body) tolerating non-2xx (a degraded /readyz answers
    503, which urllib raises as HTTPError)."""
    from ..core.http_client import fetch_any_status

    status, body = fetch_any_status(url, timeout=timeout)
    return status, body.decode("utf-8")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--url",
        required=True,
        help="health listener base URL, e.g. http://127.0.0.1:9001",
    )
    ap.add_argument(
        "--statusz", action="store_true", help="also validate the /statusz snapshot"
    )
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    base = args.url.rstrip("/")

    errors: list[str] = []
    try:
        text, ctype = _fetch(base + "/metrics", args.timeout)
    except Exception as e:
        print(f"scrape_check: GET /metrics failed: {e}", file=sys.stderr)
        return 2
    if not ctype.startswith("text/plain") or "version=0.0.4" not in ctype:
        errors.append(f"/metrics Content-Type not exposition format: {ctype!r}")
    errors.extend(validate_exposition(text))
    # exemplars belong to the OpenMetrics mode only: re-reading the
    # default scrape WITH exemplar parsing must find none (a substring
    # test would false-positive on a legal label value containing
    # ' # {'; real leaked clauses also fail validate_exposition above)
    leak_fams, _ = parse_exposition(text, openmetrics=True)
    if any(f.exemplars for f in leak_fams.values()):
        errors.append("/metrics default mode leaked an exemplar clause")
    families, _ = parse_exposition(text)
    errors.extend(lint_metric_names({f.name: f.type for f in families.values()}))
    if not families:
        errors.append("/metrics exposed no metric families")

    # OpenMetrics exposition mode (?openmetrics=1): same families plus
    # histogram exemplars and the # EOF terminator, exemplar syntax
    # validated by the shared parser
    try:
        om_text, om_ctype = _fetch(base + "/metrics?openmetrics=1", args.timeout)
    except Exception as e:
        errors.append(f"GET /metrics?openmetrics=1 failed: {e}")
    else:
        if not om_ctype.startswith("application/openmetrics-text"):
            errors.append(
                f"/metrics?openmetrics=1 Content-Type not OpenMetrics: {om_ctype!r}"
            )
        om_errors = validate_exposition(om_text, openmetrics=True)
        errors.extend(f"openmetrics: {e}" for e in om_errors)
        om_families, _ = parse_exposition(om_text, openmetrics=True)
        if set(om_families) != set(families):
            errors.append(
                "openmetrics mode exposes a different family set than the default scrape"
            )
    # device-path watchdog/quarantine families (docs/ROBUSTNESS.md
    # "Device hangs & deadlines"): registered at import in every
    # binary, so absence is a deploy regression, not an idle process
    for fam in (
        "janus_hung_dispatches_total",
        "janus_abandoned_dispatch_threads",
        "janus_engine_quarantines_total",
        # stage-pipelined leader stepper (registered at import
        # in every binary — absence is a deploy regression)
        "janus_step_pipeline_stage_seconds",
        "janus_step_pipeline_queue_depth",
        "janus_device_lane_busy_ratio",
        "janus_device_lane_busy_seconds_total",
        "janus_step_pipeline_overlap_total",
        "janus_prep_resp_order_mismatch_total",
        # SLO burn-rate engine + the standard process/build
        # families scrapers expect — all registered at import in every
        # binary, so absence is a deploy regression
        "janus_alert_active",
        "janus_slo_error_budget_remaining_ratio",
        "janus_slo_burn_rate",
        "janus_build_info",
        "janus_process_start_time_seconds",
        # batched ingest crypto — registered at import in
        # every binary, so absence is a deploy regression
        "janus_hpke_batch_size",
        "janus_ingest_decrypt_batch_seconds",
        # device-resident aggregate state + host<->device traffic
        # — registered at import in every binary
        "janus_engine_resident_buffers",
        "janus_engine_resident_bytes",
        "janus_engine_hd_bytes_total",
        "janus_engine_resident_flushes_total",
        "janus_engine_prestage_total",
        # continuous profiler + device cost ledger + boot timeline
        # — registered at import in every binary
        "janus_profiler_samples_total",
        "janus_profiler_threads",
        "janus_profiler_overhead_ratio",
        "janus_device_cost_seconds_total",
        "janus_device_cost_us_per_report",
        "janus_boot_phase_seconds",
        # prewarm outcome families: registered at import in every
        # binary (the port's stay at zero: it prewarms nothing)
        "janus_engine_prewarm_total",
        "janus_engine_prewarm_seconds",
        # fleet scale-out: batched sharded lease claims + replica
        # identity — registered at import in every binary
        "janus_replica_info",
        "janus_lease_acquire_tx_total",
        "janus_lease_acquired_jobs_total",
        "janus_lease_steals_total",
        "janus_lease_conflicts_total",
        # single-controller mesh dispatch queue — registered
        # at import in every binary, so absence is a deploy regression
        "janus_mesh_dispatch_total",
        "janus_mesh_dispatch_queue_depth",
        "janus_mesh_dispatch_wait_seconds",
        "janus_mesh_dispatch_busy_seconds_total",
        # block-sparse scatter-merge — registered at import
        # in every binary, so absence is a deploy regression
        "janus_engine_scatter_rows_total",
        "janus_engine_sparse_block_occupancy",
        # flight recorder: telemetry history + trend/leak verdicts
        # — registered at import in every binary
        "janus_flight_slope",
        "janus_flight_leak_active",
        "janus_flight_p99_ratio",
        "janus_flight_snapshots_total",
        "janus_flight_ring_bytes",
        "janus_flight_ring_segments",
        "janus_flight_overhead_ratio",
        # lifecycle gauges the recorder trends
        "janus_gc_deleted_rows_total",
        "janus_gc_tasks_scanned_total",
        "janus_gc_runs_total",
        "janus_gc_lag_seconds",
        "janus_datastore_table_rows",
        "janus_artifact_bytes",
        # peer-outage parking + half-open probing —
        # registered at import in every binary, so absence is a deploy
        # regression (labeled families render even with zero samples)
        "janus_peer_parked",
        "janus_peer_outage_seconds_total",
        "janus_peer_probes_total",
        # report-flow conservation ledger — registered at
        # import in every binary, so absence is a deploy regression
        "janus_ledger_imbalance",
        "janus_ledger_breach_active",
        "janus_ledger_peer_divergence",
        "janus_ledger_evaluations_total",
    ):
        if fam not in families:
            errors.append(f"/metrics missing the {fam} family")

    # janus_build_info must carry the identity labels with value 1
    bi = families.get("janus_build_info")
    if bi is not None:
        live = [(labels, v) for _, labels, v in bi.samples if v == 1]
        if len(live) != 1 or not {"version", "python", "torch", "backend"} <= set(
            live[0][0]
        ):
            errors.append(
                "janus_build_info needs exactly one value-1 sample with "
                "version/python/torch/backend labels"
            )

    # janus_replica_info: exactly one value-1 sample with
    # the fleet identity labels — the join key when N replicas export
    # to one scrape plane
    ri = families.get("janus_replica_info")
    if ri is not None:
        live = [(labels, v) for _, labels, v in ri.samples if v == 1]
        if len(live) != 1 or not {
            "replica_id",
            "shard_index",
            "shard_count",
        } <= set(live[0][0]):
            errors.append(
                "janus_replica_info needs exactly one value-1 sample with "
                "replica_id/shard_index/shard_count labels"
            )

    if args.statusz:
        try:
            body, _ = _fetch(base + "/statusz", args.timeout)
            snap = json.loads(body)
        except Exception as e:
            errors.append(f"/statusz not valid JSON: {e}")
        else:
            if not isinstance(snap, dict) or not snap:
                errors.append("/statusz snapshot is empty")
            else:
                # the device_watchdog section must carry the abandoned-
                # thread accounting and, for every stalled dispatch, a
                # live stack dump — the first artifact an operator
                # needs when a dispatch wedges
                wd = snap.get("device_watchdog")
                if not isinstance(wd, dict):
                    errors.append("/statusz missing the device_watchdog section")
                else:
                    # `device_down` is the port's state of the cap (it has
                    # no host fallback, where janus_tpu's reads `host_only`)
                    for key in ("abandoned_threads", "abandoned_thread_cap", "device_down", "stalled"):
                        if key not in wd:
                            errors.append(f"/statusz device_watchdog missing {key!r}")
                    for ent in wd.get("stalled", []) or []:
                        if not ent.get("stack"):
                            errors.append(
                                "/statusz device_watchdog stalled entry without a stack dump"
                            )
                # resident aggregate state: process-wide
                # byte ledger + per-engine buffer/merge/eviction counts
                ra = snap.get("resident_accumulators")
                if not isinstance(ra, dict):
                    errors.append("/statusz missing the resident_accumulators section")
                else:
                    # `sparse` rides the section unconditionally: the
                    # process-wide scatter-merge rollup must be
                    # present even with zero sparse engines provisioned
                    for key in ("total_bytes", "max_bytes", "cross_task_coalesce", "sparse", "engines"):
                        if key not in ra:
                            errors.append(f"/statusz resident_accumulators missing {key!r}")
                    sp = ra.get("sparse")
                    if isinstance(sp, dict):
                        for key in ("engines", "scatter_rows"):
                            if key not in sp:
                                errors.append(
                                    f"/statusz resident_accumulators sparse missing {key!r}"
                                )
                    for ent in ra.get("engines", []) or []:
                        for key in ("vdaf", "buffers", "bytes", "merges", "evictions"):
                            if key not in ent:
                                errors.append(
                                    f"/statusz resident_accumulators engine entry missing {key!r}"
                                )
                                break
                # continuous profiler + device cost ledger:
                # the compact profiler summary (per-role shares, top
                # frames, measured overhead) and the per-(vdaf, op,
                # bucket) cost table with the µs/report attribution
                prof = snap.get("profile")
                if not isinstance(prof, dict):
                    errors.append("/statusz missing the profile section")
                else:
                    for key in ("enabled", "roles", "top_frames", "overhead_ratio"):
                        if key not in prof:
                            errors.append(f"/statusz profile missing {key!r}")
                # the cold-start layer: the compile cache directory, the
                # kernel-library cache, the manifest inventory and the
                # prewarm's outcome counts, which an operator reads after a
                # slow boot
                ep = snap.get("engine_prewarm")
                if not isinstance(ep, dict):
                    errors.append("/statusz missing the engine_prewarm section")
                else:
                    for key in ("compile_cache", "aot", "manifest", "prewarm"):
                        if key not in ep:
                            errors.append(f"/statusz engine_prewarm missing {key!r}")
                    for key in ("enabled", "dir", "files", "bytes"):
                        if key not in (ep.get("compile_cache") or {}):
                            errors.append(f"/statusz engine_prewarm compile_cache missing {key!r}")
                    for key in ("state", "warmed", "cache_hits", "cache_misses"):
                        if key not in (ep.get("prewarm") or {}):
                            errors.append(f"/statusz engine_prewarm prewarm missing {key!r}")
                    for key in ("enabled", "blobs", "loads", "saves"):
                        if key not in (ep.get("aot") or {}):
                            errors.append(f"/statusz engine_prewarm aot missing {key!r}")
                    if "installed" not in (ep.get("manifest") or {}):
                        errors.append("/statusz engine_prewarm manifest missing 'installed'")
                # fleet identity: every process carries its
                # replica id + shard slice on /statusz
                fl = snap.get("fleet")
                if not isinstance(fl, dict):
                    errors.append("/statusz missing the fleet section")
                else:
                    for key in ("replica_id", "shard_index", "shard_count"):
                        if key not in fl:
                            errors.append(f"/statusz fleet missing {key!r}")
                # peer-outage parking: the peer-health
                # tracker registers its section only in the job driver
                # binaries, so it is validated when present rather than
                # required
                ph = snap.get("peer_health")
                if ph is not None:
                    if not isinstance(ph, dict):
                        errors.append("/statusz peer_health is not an object")
                    else:
                        for key in ("config", "parked", "peers"):
                            if key not in ph:
                                errors.append(f"/statusz peer_health missing {key!r}")
                        for peer, ent in (ph.get("peers") or {}).items():
                            for key in ("state", "probes"):
                                if key not in (ent or {}):
                                    errors.append(
                                        f"/statusz peer_health peer {peer} missing {key!r}"
                                    )
                                    break
                # multi-chip serving: mesh geometry + the
                # single-controller dispatch-queue accounting — present
                # (devices may be null pre-backend-init) on every binary
                mesh = snap.get("mesh")
                if not isinstance(mesh, dict):
                    errors.append("/statusz missing the mesh section")
                else:
                    for key in ("devices", "queue", "engines"):
                        if key not in mesh:
                            errors.append(f"/statusz mesh missing {key!r}")
                    for key in ("depth", "lane_alive", "submitted", "completed", "errors"):
                        if key not in (mesh.get("queue") or {}):
                            errors.append(f"/statusz mesh queue missing {key!r}")
                    for ent in mesh.get("engines", []) or []:
                        for key in ("vdaf", "dp", "sp", "mesh"):
                            if key not in ent:
                                errors.append(f"/statusz mesh engine entry missing {key!r}")
                                break
                dc = snap.get("device_cost")
                if not isinstance(dc, dict):
                    errors.append("/statusz missing the device_cost section")
                else:
                    for key in ("entries", "us_per_report"):
                        if key not in dc:
                            errors.append(f"/statusz device_cost missing {key!r}")
                    for ent in dc.get("entries", []) or []:
                        for key in ("vdaf", "op", "bucket", "dispatches", "rows"):
                            if key not in ent:
                                errors.append(
                                    f"/statusz device_cost entry missing {key!r}"
                                )
                                break
                # telemetry flight recorder: every binary
                # installs it by default; a running recorder whose last
                # snapshot has gone stale is a deploy regression — the
                # long-horizon evidence trail has silently stopped
                fr = snap.get("flight")
                if not isinstance(fr, dict):
                    errors.append("/statusz missing the flight section")
                else:
                    for key in (
                        "enabled",
                        "running",
                        "series_tracked",
                        "last_snapshot_age_s",
                        "leaks_active",
                    ):
                        if key not in fr:
                            errors.append(f"/statusz flight missing {key!r}")
                    if fr.get("enabled") and fr.get("running"):
                        age = fr.get("last_snapshot_age_s")
                        stale_after = max(3 * float(fr.get("interval_s") or 10.0), 30.0)
                        if age is None:
                            errors.append(
                                "/statusz flight recorder running but never snapshotted"
                            )
                        elif float(age) > stale_after:
                            errors.append(
                                f"/statusz flight last snapshot {age}s old "
                                f"(stale after {stale_after:g}s) — the recorder "
                                "has stopped recording"
                            )
                    elif fr.get("enabled") and not fr.get("running"):
                        errors.append(
                            "/statusz flight recorder enabled but not running"
                        )
                # report-flow conservation ledger: every
                # binary that owns a datastore installs it by default; a
                # listener without the section means report-loss
                # accounting is dark on that replica
                lg = snap.get("ledger")
                if not isinstance(lg, dict):
                    errors.append("/statusz missing the ledger section")
                else:
                    for key in (
                        "enabled",
                        "evaluations",
                        "grace_s",
                        "breaches",
                        "imbalance",
                    ):
                        if key not in lg:
                            errors.append(f"/statusz ledger missing {key!r}")
                    if lg.get("enabled") and lg.get("breaches"):
                        errors.append(
                            f"/statusz ledger reports active conservation "
                            f"breaches: {lg.get('breaches')} — reports are "
                            "leaking between pipeline stages"
                        )

    # /readyz semantics (docs/ROBUSTNESS.md "Datastore outages"): 200
    # with {"ready": true} when serving, 503 with a JSON reason map when
    # degraded (datastore down / upload journal full). Anything else —
    # missing route, non-JSON body, status/body disagreement — is a
    # deploy regression.
    try:
        status, body = _fetch_any_status(base + "/readyz", args.timeout)
    except Exception as e:
        errors.append(f"GET /readyz failed: {e}")
    else:
        if status not in (200, 503):
            errors.append(f"/readyz answered {status} (want 200 or 503)")
        else:
            try:
                ready = json.loads(body)
            except Exception as e:
                errors.append(f"/readyz not valid JSON: {e}")
            else:
                if not isinstance(ready, dict) or "ready" not in ready:
                    errors.append("/readyz JSON missing 'ready'")
                elif ready["ready"] is not (status == 200):
                    errors.append(
                        f"/readyz status {status} disagrees with body {ready}"
                    )
                elif status == 503 and not ready.get("reasons"):
                    errors.append("/readyz degraded (503) without a JSON reason")

    # the always-on flight recorder (trace.py) serves
    # /debug/traces on every binary; a listener that can't render it
    # is a deploy regression
    try:
        body, _ = _fetch(base + "/debug/traces?limit=5", args.timeout)
        traces = json.loads(body)
    except Exception as e:
        errors.append(f"/debug/traces not valid JSON: {e}")
    else:
        for key in ("recent", "slow_traces", "digests", "recorded_total"):
            if key not in traces:
                errors.append(f"/debug/traces missing {key!r}")

    # conservation ledger: /debug/ledger answers the full
    # balance document on every binary — {"enabled": false} when no
    # evaluator is installed, the per-task books otherwise
    try:
        body, _ = _fetch(base + "/debug/ledger", args.timeout)
        ledger_doc = json.loads(body)
    except Exception as e:
        errors.append(f"/debug/ledger not valid JSON: {e}")
    else:
        if not isinstance(ledger_doc, dict) or "enabled" not in ledger_doc:
            errors.append("/debug/ledger JSON missing 'enabled'")
        elif ledger_doc["enabled"]:
            for key in ("evaluations", "tasks", "breaches"):
                if key not in ledger_doc:
                    errors.append(f"/debug/ledger missing {key!r}")

    # /alertz: every binary answers the SLO engine state as
    # well-formed JSON — enabled or not — with the alert/slo lists; a
    # firing alert must carry its burn rates and firing-since
    try:
        body, _ = _fetch(base + "/alertz", args.timeout)
        alertz = json.loads(body)
    except Exception as e:
        errors.append(f"/alertz not valid JSON: {e}")
    else:
        for key in ("enabled", "firing", "alerts", "slos"):
            if key not in alertz:
                errors.append(f"/alertz missing {key!r}")
        for a in alertz.get("alerts", []) or []:
            for key in ("alert", "severity", "state", "burn_rate_threshold"):
                if key not in a:
                    errors.append(f"/alertz alert entry missing {key!r}: {a}")
                    break
            if a.get("state") == "firing" and a.get("firing_since_unix") is None:
                errors.append(f"/alertz firing alert without firing_since: {a}")
        if alertz.get("enabled"):
            for s in alertz.get("slos", []) or []:
                for key in (
                    "name",
                    "objective",
                    "burn_rates",
                    "error_budget_remaining_ratio",
                    "evidence",
                ):
                    if key not in s:
                        errors.append(f"/alertz slo entry missing {key!r}: {s}")
                        break

    # continuous profiler: /debug/profile must serve a
    # well-formed collapsed-stack document (hostile thread names must
    # not corrupt the fold — validated with the shared validator) and a
    # JSON mode with per-role shares; every binary runs the sampler by
    # default, so a disabled profiler is a deploy regression
    try:
        body, ctype = _fetch(base + "/debug/profile", args.timeout)
    except Exception as e:
        errors.append(f"GET /debug/profile failed: {e}")
    else:
        if not ctype.startswith("text/plain"):
            errors.append(f"/debug/profile Content-Type not text/plain: {ctype!r}")
        errors.extend(
            f"/debug/profile collapsed: {e}" for e in validate_collapsed(body)
        )
    try:
        body, ctype = _fetch(base + "/debug/profile?format=json", args.timeout)
        prof = json.loads(body)
    except Exception as e:
        errors.append(f"/debug/profile?format=json not valid JSON: {e}")
    else:
        if not ctype.startswith("application/json"):
            errors.append(f"/debug/profile json Content-Type: {ctype!r}")
        for key in ("enabled", "roles", "top_frames", "overhead_ratio", "samples"):
            if key not in prof:
                errors.append(f"/debug/profile json missing {key!r}")
        if prof.get("enabled") is not True:
            errors.append(
                "/debug/profile reports the sampler disabled (it is on by "
                "default in every binary — a disabled profiler is a deploy "
                "regression)"
            )

    # telemetry flight recorder: /debug/flight must serve a
    # well-formed history + trend-analysis document on every binary
    # (the recorder is on by default; even a disabled one answers
    # enabled: false with the document shape intact)
    try:
        body, ctype = _fetch(base + "/debug/flight", args.timeout)
        flight = json.loads(body)
    except Exception as e:
        errors.append(f"/debug/flight not valid JSON: {e}")
    else:
        if not ctype.startswith("application/json"):
            errors.append(f"/debug/flight Content-Type: {ctype!r}")
        for key in ("enabled", "series_tracked", "snapshots", "analysis"):
            if key not in flight:
                errors.append(f"/debug/flight missing {key!r}")
        if flight.get("enabled"):
            for key in ("window_s", "snapshots_total", "overhead_ratio", "ring"):
                if key not in flight:
                    errors.append(f"/debug/flight missing {key!r}")
            analysis = flight.get("analysis") or {}
            for key in ("series", "latency", "leaking"):
                if key not in analysis:
                    errors.append(f"/debug/flight analysis missing {key!r}")

    # boot-phase timeline: /debug/boot is one contiguous,
    # monotone phase sequence from process start
    try:
        body, _ = _fetch(base + "/debug/boot", args.timeout)
        boot = json.loads(body)
    except Exception as e:
        errors.append(f"/debug/boot not valid JSON: {e}")
    else:
        for key in ("started_unix", "ready", "phases", "boot_phases_sum_s"):
            if key not in boot:
                errors.append(f"/debug/boot missing {key!r}")
        last_end = 0.0
        for p in boot.get("phases", []) or []:
            if not {"phase", "start_s", "end_s", "seconds"} <= set(p):
                errors.append(f"/debug/boot phase entry malformed: {p}")
                break
            if p["start_s"] < last_end - 1e-6 or p["end_s"] < p["start_s"] - 1e-6:
                errors.append(f"/debug/boot phases not monotone at {p['phase']!r}")
                break
            last_end = p["end_s"]

    # the endpoint-discovery index page (GET /) must link the surface
    try:
        body, ctype = _fetch(base + "/", args.timeout)
    except Exception as e:
        errors.append(f"GET / failed: {e}")
    else:
        if not ctype.startswith("text/html"):
            errors.append(f"GET / Content-Type not HTML: {ctype!r}")
        for link in (
            "/metrics",
            "/statusz",
            "/alertz",
            "/debug/traces",
            "/debug/flight",
            "/readyz",
        ):
            if link not in body:
                errors.append(f"GET / index page does not link {link}")

    for err in errors:
        print(f"scrape_check: {err}", file=sys.stderr)
    if errors:
        return 1
    print(f"scrape_check: OK ({len(families)} metric families)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
