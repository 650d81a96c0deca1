"""Persisted shape manifest: the dispatch specializations this process has
actually run.

Every first dispatch of a specialization (vdaf config, op, batch bucket,
compile key: the variant name plus any extra geometry such as
aggregate_pending's padded bucket count kk) is recorded here by the
EngineCache choke point (`_record_dispatch`), with the wall time that
first call cost. On the card that cold first call is the lazy loading of
PyTorch's CUDA modules for the step's eager ops, the caching allocator's
first segments at that bucket and the first float64 `bmm`'s cuBLAS
handle and workspace: the price a restarted process pays again inside
its first served job. At the next boot the prewarm (aggregator/prewarm.py)
replays the manifest highest-cost-first against the provisioned tasks,
so every recorded specialization has run once BEFORE /readyz reports
ready.

File format: append-only JSONL, one record per line:

    {"v": 1, "crc": <crc32 of canonical entry json>, "e": {entry}}

entry = {vdaf: VdafInstance.to_dict(), op, bucket, key: [compile_key],
cost_s, rows, seen, last_unix}. The same `record()` calls write the same
bytes as janus_tpu's module (given one clock), and each package reads the
other's file, so a manifest either package wrote warms the other. The
discipline mirrors the upload journal's (ingest/journal.py), scaled down
for advisory data:

  * **Torn tails tolerated**: a crash mid-append leaves a truncated
    final line; it fails to parse and is skipped (counted), the valid
    prefix loads. No fsync: losing a tail entry costs one cold first
    call later, never correctness.
  * **Damage skipped, never fatal**: a line whose CRC or JSON is bad is
    counted and skipped; a corrupt manifest can slow a boot, it cannot
    break one (a manifest-less boot warms as `warmup_engines` does).
  * **Version skew skipped**: lines with `v` != MANIFEST_VERSION are
    counted and ignored.
  * **Append-compacted and bounded**: repeated boots append duplicate
    keys (later lines win, `seen` counts); once the file grows past the
    compaction threshold it is rewritten (tmp + atomic os.replace) with
    one line per live entry, truncated to `max_entries` by recorded cost.

The port's own copy of janus_tpu/aggregator/shape_manifest.py.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib

log = logging.getLogger(__name__)

MANIFEST_VERSION = 1
DEFAULT_MAX_ENTRIES = 512
DEFAULT_FILENAME = "shape_manifest.jsonl"


def _canonical(entry: dict) -> str:
    return json.dumps(entry, sort_keys=True, separators=(",", ":"))


def _crc(entry: dict) -> int:
    return zlib.crc32(_canonical(entry).encode()) & 0xFFFFFFFF


def _line(entry: dict) -> str:
    return json.dumps({"v": MANIFEST_VERSION, "crc": _crc(entry), "e": entry}, sort_keys=True,
                      separators=(",", ":")) + "\n"


def entry_key(entry: dict) -> tuple:
    """Identity of one specialization: (vdaf config, op, bucket,
    compile_key). The compile_key list is the variant the call site
    dispatched (engine_cache._record_dispatch), so e.g.
    aggregate_pending's kk geometry keys separately per kk."""
    return (
        _canonical(entry.get("vdaf") or {}),
        str(entry.get("op", "")),
        int(entry.get("bucket", 0)),
        tuple(entry.get("key") or ()),
    )


def entry_geometry(key) -> tuple[int, int, int] | None:
    """The mesh geometry a specialization was recorded under:
    engine_cache._record_dispatch suffixes mesh compile keys with
    ("mesh", dp, sp, device count). Returns (dp, sp, ndev), or None for a
    single-device entry. The prewarm and the boot warmup skip entries
    whose topology does not match the booting process."""
    k = tuple(key or ())
    if len(k) >= 4 and str(k[-4]) == "mesh":
        try:
            return int(k[-3]), int(k[-2]), int(k[-1])
        except (TypeError, ValueError):
            return None
    return None


class ShapeManifest:
    """See the module docstring. Thread-safe: `record` may be called from
    any dispatch thread while `entries`/`status` snapshot for the prewarm
    loop and /statusz."""

    def __init__(self, path: str, max_entries: int = DEFAULT_MAX_ENTRIES):
        self.path = path
        self.max_entries = max(1, int(max_entries))
        self._lock = threading.Lock()
        self._entries: dict[tuple, dict] = {}
        self._file_lines = 0
        self._compactions = 0
        self.load_stats = {"lines": 0, "loaded": 0, "skipped_corrupt": 0, "skipped_version": 0}

    # -- load ----------------------------------------------------------
    def load(self, compact: bool = True) -> dict:
        """Read the file, tolerant of torn tails, damage and version skew
        (each skipped and counted). Returns the load stats. A missing file
        is an empty manifest. `compact=False` makes the load strictly
        read-only (a diagnostic tool must not rewrite the evidence)."""
        stats = {"lines": 0, "loaded": 0, "skipped_corrupt": 0, "skipped_version": 0}
        entries: dict[tuple, dict] = {}
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            raw = b""
        except OSError as e:
            log.warning("shape manifest %s unreadable (%s); starting empty", self.path, e)
            raw = b""
        for line in raw.splitlines():
            line = line.strip()
            if not line:
                continue
            stats["lines"] += 1
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict):
                    raise ValueError("not an object")
            except (ValueError, UnicodeDecodeError):
                stats["skipped_corrupt"] += 1
                continue
            if rec.get("v") != MANIFEST_VERSION:
                stats["skipped_version"] += 1
                continue
            entry = rec.get("e")
            if not isinstance(entry, dict) or rec.get("crc") != _crc(entry):
                stats["skipped_corrupt"] += 1
                continue
            try:
                # last line wins: each appended record carries the
                # cumulative seen count
                entries[entry_key(entry)] = entry
                stats["loaded"] += 1
            except (TypeError, ValueError):
                stats["skipped_corrupt"] += 1
        with self._lock:
            self._entries = entries
            self._file_lines = stats["lines"]
            self.load_stats = stats
            if compact and (
                stats["skipped_corrupt"]
                or stats["skipped_version"]
                or stats["lines"] > self._compact_threshold()
                or len(entries) > self.max_entries
            ):
                self._compact_locked()
        if stats["skipped_corrupt"] or stats["skipped_version"]:
            log.warning("shape manifest %s: loaded %d entries, skipped %d corrupt + %d version-skew line(s)",
                        self.path, stats["loaded"], stats["skipped_corrupt"], stats["skipped_version"])
        return dict(stats)

    # -- record --------------------------------------------------------
    def record(self, vdaf: dict, op: str, bucket: int, compile_key, cost_s: float, rows: int = 0) -> None:
        """Record one observed specialization (called at the FIRST
        dispatch of a compile key per process, so the append rate is
        bounded by the number of distinct specializations). `cost_s` is
        that first call's wall time, which the prewarm order sorts on;
        re-observations keep the MAX recorded cost."""
        entry = {
            "vdaf": dict(vdaf),
            "op": str(op),
            "bucket": int(bucket),
            "key": [k if isinstance(k, (int, float)) else str(k) for k in (compile_key or (op, bucket))],
            "cost_s": round(float(cost_s), 6),
            "rows": int(rows),
            "seen": 1,
            "last_unix": round(time.time(), 3),
        }
        key = entry_key(entry)
        with self._lock:
            prev = self._entries.get(key)
            if prev is not None:
                entry["seen"] = int(prev.get("seen", 1)) + 1
                entry["cost_s"] = max(entry["cost_s"], float(prev.get("cost_s", 0.0)))
            self._entries[key] = entry
            self._append_locked(entry)
            if self._file_lines > self._compact_threshold() or len(self._entries) > self.max_entries:
                self._compact_locked()

    def _append_locked(self, entry: dict) -> None:
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(_line(entry))
            self._file_lines += 1
        except OSError:
            log.warning("shape manifest append to %s failed", self.path, exc_info=True)

    def _compact_threshold(self) -> int:
        return max(64, 2 * self.max_entries)

    def _compact_locked(self) -> None:
        """Rewrite the file with one line per live entry, truncated to
        max_entries by cost (tmp + atomic replace: a crash leaves either
        the old file or the new one)."""
        keep = sorted(self._entries.values(), key=lambda e: -float(e.get("cost_s", 0.0)))[: self.max_entries]
        self._entries = {entry_key(e): e for e in keep}
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                for e in keep:
                    f.write(_line(e))
            os.replace(tmp, self.path)
            self._file_lines = len(keep)
            self._compactions += 1
        except OSError:
            log.warning("shape manifest compaction of %s failed", self.path, exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # -- queries -------------------------------------------------------
    def entries(self) -> list[dict]:
        """Snapshot of live entries, highest recorded cost first (the
        prewarm priority order)."""
        with self._lock:
            out = [dict(e) for e in self._entries.values()]
        out.sort(key=lambda e: (-float(e.get("cost_s", 0.0)), str(e.get("op", ""))))
        return out

    def covers(self, vdaf: dict, op: str, bucket: int, geometry: tuple[int, int, int] | None = None) -> bool:
        """True when a recorded specialization matches (vdaf, op, bucket)
        with the PLAIN variant (a `leader_init_vk` entry does not cover
        `leader_init`) under the caller's mesh `geometry` (None: one
        device). The boot warmup skips what this covers."""
        vkey = _canonical(dict(vdaf))
        with self._lock:
            return any(
                k[0] == vkey
                and k[1] == str(op)
                and k[2] == int(bucket)
                and k[3]
                and str(k[3][0]) == str(op)
                and entry_geometry(k[3]) == geometry
                for k in self._entries
            )

    def file_bytes(self) -> int:
        try:
            return os.stat(self.path).st_size
        except OSError:
            return 0

    def status(self) -> dict:
        with self._lock:
            n = len(self._entries)
            stats = dict(self.load_stats)
            compactions = self._compactions
            lines = self._file_lines
        return {
            "path": self.path,
            "entries": n,
            "max_entries": self.max_entries,
            "file_lines": lines,
            "file_bytes": self.file_bytes(),
            "compactions": compactions,
            "load": stats,
        }


# ---------------------------------------------------------------------------
# The process-wide installed manifest. janus_main installs it at boot (its
# path from the YAML, or next to the compile cache) and uninstalls it at
# teardown; the EngineCache choke point records into whatever is installed
# (a no-op otherwise: one None check a first dispatch).
# ---------------------------------------------------------------------------

_installed: ShapeManifest | None = None
_installed_lock = threading.Lock()


def install_manifest(path: str, max_entries: int = DEFAULT_MAX_ENTRIES) -> ShapeManifest:
    """Install (and load) the process shape manifest, replacing any
    previous one."""
    global _installed
    m = ShapeManifest(path, max_entries=max_entries)
    m.load()
    with _installed_lock:
        _installed = m
    return m


def uninstall_manifest() -> None:
    global _installed
    with _installed_lock:
        _installed = None


def installed() -> ShapeManifest | None:
    return _installed


def record_dispatch(inst, op: str, bucket: int, compile_key, cost_s: float, rows: int = 0) -> None:
    """EngineCache choke-point hook: record a first dispatch into the
    installed manifest, if any. Fake VDAFs and Poplar1 are never recorded;
    a failure is logged and swallowed (manifest trouble must never fail a
    serving dispatch)."""
    m = _installed
    if m is None:
        return
    try:
        kind = getattr(inst, "kind", "")
        if kind.startswith("fake") or kind == "poplar1":
            return
        m.record(inst.to_dict(), op, bucket, compile_key, cost_s, rows=rows)
    except Exception:
        log.warning("shape manifest record failed", exc_info=True)


def inspect_file(path: str, max_entries: int = DEFAULT_MAX_ENTRIES) -> tuple[list[dict], dict]:
    """READ-ONLY parse of a manifest file: (entries, load stats) with no
    compaction and no rewrite, for diagnostic tools (debug_bundle)."""
    m = ShapeManifest(path, max_entries=max_entries)
    stats = m.load(compact=False)
    return m.entries(), stats


def manifest_status() -> dict:
    """The manifest slice of the /statusz `engine_prewarm` section."""
    m = _installed
    if m is None:
        return {"installed": False}
    return {"installed": True, **m.status()}
