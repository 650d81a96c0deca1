"""One-command incident debug bundle.

    python -m janus_tpu_torch.tools.debug_bundle --url http://127.0.0.1:9001 \\
        [--url http://127.0.0.1:9002 ...] [--config-file cfg.yaml] \\
        [--journal-dir /var/janus/journal] [--flight-dir /var/janus/flight] \\
        [--shape-manifest /var/janus/cache/shape_manifest.jsonl] [--aot-dir DIR] \\
        [--out bundle.tar.gz]

Snapshots every introspection endpoint of one or several binaries'
health listeners — /metrics (both exposition modes), /statusz,
/debug/vars, /debug/traces, /debug/profile (collapsed + JSON),
/debug/boot, /debug/flight, /debug/ledger, /alertz, /readyz,
/healthz — plus the
resolved YAML config (secrets redacted) and the upload-journal
directory state, into a timestamped tar.gz with a MANIFEST.json
inventorying every capture (source, HTTP status, bytes, sha256). One
invocation takes ANY number of --url targets, and each target's
MANIFEST entry records the fleet replica id read off its /statusz —
so one incident bundle covers a whole replica fleet and stays
attributable per process. This
is the artifact an operator attaches to an incident: the flight
recorder, the SLO engine's burn rates and the metric families of the
moment, collected before the evidence scrolls out of the rings.

Non-200 answers (a degraded /readyz) are captured, never fatal; an
unreachable endpoint is recorded in the manifest with its error so a
half-dead process still yields a bundle.

The port keeps janus_tpu's endpoints, manifest and exit rule. Its
`--shape-manifest` inventories the shape manifest and `--aot-dir` the
kernel-library cache (the port's AOT cache: `<compile cache dir>/aot`,
the manifest's sibling by default) into shape-manifest.json.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import re
import sys
import tarfile
import time

# endpoint name -> path; the names become file names inside the bundle
ENDPOINTS = (
    ("healthz", "/healthz"),
    ("readyz", "/readyz"),
    ("metrics", "/metrics"),
    ("metrics_openmetrics", "/metrics?openmetrics=1"),
    ("statusz", "/statusz"),
    ("debug_vars", "/debug/vars"),
    ("debug_traces", "/debug/traces?limit=10000"),
    ("alertz", "/alertz"),
    # continuous profiler: both renderings — the collapsed
    # folded stacks feed flamegraph.pl directly from the bundle — plus
    # the boot-phase timeline
    ("debug_profile", "/debug/profile"),
    ("debug_profile_json", "/debug/profile?format=json"),
    ("debug_boot", "/debug/boot"),
    # telemetry flight recorder: the recent window + the
    # slope/leak report — the long-horizon evidence a point-in-time
    # snapshot can't reconstruct
    ("debug_flight", "/debug/flight"),
    # report-flow conservation ledger: the per-task balance document —
    # whether the books closed at capture time, and where the
    # imbalance sits if they didn't
    ("debug_ledger", "/debug/ledger"),
)

_SECRET_KEY_RE = re.compile(r"(token|secret|password|key)s?$", re.IGNORECASE)
REDACTED = "**REDACTED**"


def redact_config(doc):
    """Recursively mask values whose key smells like a secret
    (token/secret/password/key). Keys are kept so the shape of the
    config survives; values never leave the host."""
    if isinstance(doc, dict):
        out = {}
        for k, v in doc.items():
            if _SECRET_KEY_RE.search(str(k)) and isinstance(v, (str, bytes, list, tuple)):
                out[k] = REDACTED
            else:
                out[k] = redact_config(v)
        return out
    if isinstance(doc, (list, tuple)):
        return [redact_config(v) for v in doc]
    return doc


def _fetch(url: str, timeout: float) -> tuple[int, bytes]:
    """(status, body) tolerating non-2xx (a degraded /readyz is 503 —
    still evidence, not an error)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _target_name(url: str) -> str:
    """Filesystem-safe directory name for one listener URL."""
    return re.sub(r"[^A-Za-z0-9.]+", "_", url.split("://", 1)[-1]).strip("_")


def journal_dir_state(path: str) -> dict:
    """Non-content inventory of the upload-journal directory: segment
    names/sizes/mtimes (the rows themselves are encrypted at rest and
    stay on the host)."""
    entries = []
    total = 0
    try:
        names = sorted(os.listdir(path))
    except OSError as e:
        return {"path": path, "error": f"{type(e).__name__}: {e}"}
    for name in names:
        full = os.path.join(path, name)
        try:
            st = os.stat(full)
        except OSError:
            continue
        entries.append({"name": name, "bytes": st.st_size, "mtime": st.st_mtime})
        total += st.st_size
    return {
        "path": path,
        "segments": entries,
        "segment_count": len(entries),
        "total_bytes": total,
        "corrupt_segments": [
            e["name"] for e in entries if e["name"].endswith(".corrupt")
        ],
    }


def shape_manifest_state(path: str, aot_dir: str | None = None) -> dict:
    """Non-content inventory of the shape manifest and the kernel-library
    cache's directory (names and sizes only; entry counts from a
    tolerant, read-only parse: a corrupt manifest is evidence, not an
    error). `aot_dir` defaults to the manifest's sibling `aot/` (the
    layout under the compile cache dir)."""
    out: dict = {"path": path}
    try:
        st = os.stat(path)
        out["bytes"] = st.st_size
        out["mtime"] = st.st_mtime
    except OSError as e:
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    try:
        # READ-ONLY: a diagnostic tool never compacts the live manifest
        from ..aggregator.shape_manifest import inspect_file

        entries, stats = inspect_file(path)
        out["entries"] = len(entries)
        out["load"] = stats
    except Exception as e:  # stdlib-only parse, but stay non-fatal
        out["parse_error"] = f"{type(e).__name__}: {e}"
    aot_dir = aot_dir or os.path.join(os.path.dirname(path), "aot")
    blobs = []
    try:
        for name in sorted(os.listdir(aot_dir)):
            try:
                blobs.append({"name": name, "bytes": os.stat(os.path.join(aot_dir, name)).st_size})
            except OSError:
                continue
        out["aot"] = {
            "dir": aot_dir,
            "blobs": blobs,
            "blob_count": len(blobs),
            "total_bytes": sum(b["bytes"] for b in blobs),
        }
    except OSError as e:
        out["aot"] = {"dir": aot_dir, "error": f"{type(e).__name__}: {e}"}
    return out


def flight_dir_state(path: str) -> dict:
    """Non-content inventory of the flight-recorder segment ring:
    segment names/sizes/mtimes plus per-segment record/torn-line counts
    from a READ-ONLY tolerant parse (`inspect_file` discipline — never
    compact or rewrite what you are capturing as evidence; the torn
    tail IS the evidence)."""
    entries = []
    total = 0
    try:
        names = sorted(os.listdir(path))
    except OSError as e:
        return {"path": path, "error": f"{type(e).__name__}: {e}"}
    for name in names:
        if not (name.startswith("flight-") and name.endswith(".jsonl")):
            continue
        full = os.path.join(path, name)
        try:
            st = os.stat(full)
        except OSError:
            continue
        records = 0
        torn = 0
        tiers: dict[str, int] = {}
        try:
            with open(full, "rb") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        torn += 1
                        continue
                    records += 1
                    tier = str(rec.get("tier", "?"))
                    tiers[tier] = tiers.get(tier, 0) + 1
        except OSError:
            pass
        entries.append(
            {
                "name": name,
                "bytes": st.st_size,
                "mtime": st.st_mtime,
                "records": records,
                "torn_lines": torn,
                "tiers": tiers,
            }
        )
        total += st.st_size
    return {
        "path": path,
        "segments": entries,
        "segment_count": len(entries),
        "total_bytes": total,
        "torn_lines": sum(e["torn_lines"] for e in entries),
    }


def collect_bundle(
    urls: list[str],
    out_path: str | None = None,
    config_file: str | None = None,
    journal_dir: str | None = None,
    shape_manifest: str | None = None,
    aot_dir: str | None = None,
    flight_dir: str | None = None,
    timeout: float = 10.0,
    now: float | None = None,
) -> dict:
    """Build the bundle; returns the manifest (its `bundle_path` is the
    written tar.gz)."""
    now = time.time() if now is None else now
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(now))
    bundle_name = f"janus-debug-{stamp}"
    out_path = out_path or f"{bundle_name}.tar.gz"

    files: list[tuple[str, bytes]] = []  # (path inside bundle, content)
    manifest: dict = {
        "created_unix": now,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now)),
        "tool": "janus_tpu_torch.tools.debug_bundle",
        "targets": {},
        "files": [],
    }

    def add_file(rel: str, content: bytes, source: str, status=None, error=None):
        entry = {
            "path": rel,
            "source": source,
            "bytes": len(content),
            "sha256": hashlib.sha256(content).hexdigest(),
        }
        if status is not None:
            entry["status"] = status
        if error is not None:
            entry["error"] = error
        manifest["files"].append(entry)
        files.append((rel, content))

    for url in urls:
        base = url.rstrip("/")
        target = _target_name(base)
        captured = {}
        replica_id = None
        peer_health = None
        for name, path in ENDPOINTS:
            source = base + path
            ext = (
                ".txt"
                if name in ("healthz", "metrics", "metrics_openmetrics", "debug_profile")
                else ".json"
            )
            rel = f"{bundle_name}/{target}/{name}{ext}"
            try:
                status, body = _fetch(source, timeout)
            except Exception as e:
                err = f"{type(e).__name__}: {e}"
                add_file(rel, err.encode(), source, error=err)
                captured[name] = {"error": err}
                continue
            add_file(rel, body, source, status=status)
            captured[name] = {"status": status, "bytes": len(body)}
            if name == "statusz" and status == 200:
                # fleet replica identity per capture: one
                # incident bundle covers the whole fleet, so every
                # target records WHICH replica it was
                try:
                    snap = json.loads(body)
                    replica_id = snap.get("fleet", {}).get("replica_id")
                    # peer-outage state per capture: a
                    # "helper down?" incident bundle answers at the top
                    # of the manifest, not three files deep
                    ph = snap.get("peer_health")
                    if isinstance(ph, dict):
                        peer_health = {
                            "parked": ph.get("parked"),
                            "parked_peers": sorted(
                                p
                                for p, ent in (ph.get("peers") or {}).items()
                                if (ent or {}).get("state") not in ("closed", None)
                            ),
                        }
                except Exception:
                    replica_id = None
        manifest["targets"][target] = {
            "url": base,
            "replica_id": replica_id,
            "endpoints": captured,
        }
        if peer_health is not None:
            manifest["targets"][target]["peer_health"] = peer_health

    if config_file:
        try:
            import yaml

            with open(config_file) as f:
                raw = yaml.safe_load(f) or {}
            redacted = yaml.safe_dump(redact_config(raw), sort_keys=False)
            add_file(
                f"{bundle_name}/resolved-config.yaml",
                redacted.encode(),
                f"config:{config_file}",
            )
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            add_file(
                f"{bundle_name}/resolved-config.yaml",
                err.encode(),
                f"config:{config_file}",
                error=err,
            )

    if journal_dir:
        state = journal_dir_state(journal_dir)
        add_file(
            f"{bundle_name}/upload-journal.json",
            json.dumps(state, indent=2).encode(),
            f"journal:{journal_dir}",
        )

    if shape_manifest:
        state = shape_manifest_state(shape_manifest, aot_dir=aot_dir)
        add_file(
            f"{bundle_name}/shape-manifest.json",
            json.dumps(state, indent=2, default=str).encode(),
            f"shape_manifest:{shape_manifest}",
        )

    if flight_dir:
        state = flight_dir_state(flight_dir)
        add_file(
            f"{bundle_name}/flight-ring.json",
            json.dumps(state, indent=2).encode(),
            f"flight:{flight_dir}",
        )

    manifest["bundle_path"] = os.path.abspath(out_path)
    manifest_bytes = json.dumps(manifest, indent=2, default=str).encode()

    with tarfile.open(out_path, "w:gz") as tar:

        def add(rel: str, content: bytes) -> None:
            info = tarfile.TarInfo(rel)
            info.size = len(content)
            info.mtime = int(now)
            tar.addfile(info, io.BytesIO(content))

        add(f"{bundle_name}/MANIFEST.json", manifest_bytes)
        for rel, content in files:
            add(rel, content)
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--url",
        action="append",
        required=True,
        help="health listener base URL (repeatable: leader + helper + drivers)",
    )
    ap.add_argument("--out", help="output tar.gz path (default: timestamped in cwd)")
    ap.add_argument(
        "--config-file",
        help="YAML config to include, secrets redacted (token/secret/password/key)",
    )
    ap.add_argument(
        "--journal-dir",
        help="upload-journal directory to inventory (names/sizes only)",
    )
    ap.add_argument(
        "--shape-manifest",
        help="shape manifest file to inventory (entry counts + kernel-library names/sizes, no contents)",
    )
    ap.add_argument(
        "--aot-dir",
        help="kernel-library cache dir to inventory (default: the manifest's sibling aot/, the layout "
        "under the compile cache dir)",
    )
    ap.add_argument(
        "--flight-dir",
        help="flight-recorder segment-ring dir to inventory (segment "
        "names/sizes + record/torn-line counts, read-only)",
    )
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    manifest = collect_bundle(
        args.url,
        out_path=args.out,
        config_file=args.config_file,
        journal_dir=args.journal_dir,
        shape_manifest=args.shape_manifest,
        aot_dir=args.aot_dir,
        flight_dir=args.flight_dir,
        timeout=args.timeout,
    )
    errors = [f for f in manifest["files"] if f.get("error")]
    print(f"debug_bundle: wrote {manifest['bundle_path']} "
          f"({len(manifest['files'])} files, {len(errors)} capture errors)")
    for f in errors:
        print(f"debug_bundle:   {f['source']}: {f['error']}", file=sys.stderr)
    # a bundle with SOME captures is still a success — incident tooling
    # must degrade, not abort; only a bundle with zero successful
    # captures exits non-zero
    ok = any("error" not in f for f in manifest["files"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
