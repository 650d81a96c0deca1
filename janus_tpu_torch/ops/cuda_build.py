"""Build the hand-written CUDA kernels (csrc/*.cu) and load them with ctypes.

Each source compiles with nvcc into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library is keyed by a hash of its source, the headers in csrc/, the
flags and the host's fingerprint, and is built on first use into the
build directory: janus_tpu_torch/_build/ (listed in .gitignore), or the
directory `set_build_dir` named (aggregator/aot_cache.py arms it as the
port's kernel-library cache). `build()` starts one nvcc per source, all
together. A failed build raises with nvcc's output; ptxas's register and
spill report is kept beside each library (`build_log`).

Cross-machine poison: a library built elsewhere (another nvcc release,
another target, another torch CUDA) must never be loaded. Two defences:
`host_fingerprint()` (the `nvcc --version` release, the `-gencode`
target and torch's CUDA version) is part of every library's key, so a
foreign library is never even looked up; and each library carries the
fingerprint and digest it was built with in a sidecar (`<lib>.json`),
checked before `ctypes.CDLL` (`library_ok`). A foreign or corrupt library
is deleted and rebuilt from the same sources; if the rebuild fails the
call raises with nvcc's output. Processes that share a build directory
(replicas on one host) check and build under an exclusive lock on
`<dir>/.lock`, and a library's sidecar is written before the library is
moved into place.

Counts (`cache_stats`): `loads` (a library taken from disk), `saves` (a
library built), `errors` (a foreign or corrupt library deleted),
`bytes_saved` (bytes of the libraries built) and `nvcc_s` (wall seconds
of the builds).

Every kernel wrapper counts its launches with `count_launch`, under one
lock: the leader's job driver and the helper's handler may launch from
two threads of one process. Besides the wrapper's own `launches`, which a
caller may set to 0, the process keeps a total per kernel that nothing
resets (`launch_totals`, in the /statusz `process` section).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import json
import logging
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

log = logging.getLogger(__name__)

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("keccak", "expand_f128", "keccak_sponge", "scatter_rows")
# the kernel wrappers' names, rows 1-4 of PERF.md's table
KERNEL_WRAPPERS = ("keccak_single_block", "expand_f128", "keccak_sponge", "scatter_rows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SIDECAR_SUFFIX = ".json"

_loaded: dict[str, ctypes.CDLL] = {}
# the libraries this process built (a later load of one is not a cache load)
_built_here: set[Path] = set()
_load_lock = threading.Lock()
_launch_lock = threading.Lock()
_launch_totals: dict[str, int] = {}
_stats_lock = threading.Lock()
_STATS = {"loads": 0, "saves": 0, "errors": 0, "bytes_saved": 0, "nvcc_s": 0.0}
_build_dir_set: list = [None]  # the directory set_build_dir named, else None
_HOST_FP: dict = {}  # {nvcc path (None: none found): fingerprint}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def set_build_dir(directory: str | None) -> None:
    """Build and find the libraries in `directory` (created on the first
    build); None: janus_tpu_torch/_build/ again."""
    _build_dir_set[0] = os.path.expanduser(directory) if directory else None


def build_dir_set() -> str | None:
    return _build_dir_set[0]


def build_dir() -> Path:
    d = _build_dir_set[0]
    return Path(d) if d else BUILD_DIR


def cache_stats() -> dict:
    with _stats_lock:
        return dict(_STATS)


def reset_cache_stats() -> None:
    with _stats_lock:
        _STATS.update(loads=0, saves=0, errors=0, bytes_saved=0, nvcc_s=0.0)
    _HOST_FP.clear()


def _bump(key: str, n=1) -> None:
    with _stats_lock:
        _STATS[key] += n


def host_fingerprint() -> str:
    """Digest of what a library's machine code depends on beyond its
    sources and flags: the nvcc release (`nvcc --version`), the -gencode
    target and torch's CUDA version. A host without nvcc has the release
    "absent": it can load no library (none matches) and build none."""
    try:
        nvcc = _nvcc()
    except RuntimeError:
        nvcc = None
    fp = _HOST_FP.get(nvcc)
    if fp is None:
        import torch

        release = "absent"
        if nvcc is not None:
            out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60).stdout
            m = re.search(r"release [0-9.]+, V([0-9.]+)", out)
            release = m.group(1) if m else "unknown"
        target = NVCC_FLAGS[NVCC_FLAGS.index("-gencode") + 1]
        parts = (f"nvcc {release}", target, f"torch cuda {torch.version.cuda}")
        fp = _HOST_FP[nvcc] = hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]
    return fp


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(host_fingerprint().encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _sidecar(lib: Path) -> Path:
    return lib.with_suffix(SIDECAR_SUFFIX)


def _seal(built: Path, lib: Path) -> None:
    """Write `lib`'s sidecar from the library just `built`, before it is
    moved into place: this host's fingerprint and its digest (tmp +
    atomic replace)."""
    side = _sidecar(lib)
    tmp = side.with_name(f"{side.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps({"v": 1, "fp": host_fingerprint(), "sha256": _digest(built)}))
    os.replace(tmp, side)


def library_ok(lib: Path) -> bool:
    """True when `lib` exists and is this host's, intact: its sidecar's
    fingerprint is host_fingerprint() and its digest matches. A library
    that fails either check is deleted (with its sidecar) and counted as
    an error, before anything loads it; False then, as for a missing one."""
    if not lib.exists():
        return False
    side = _sidecar(lib)
    try:
        meta = json.loads(side.read_text())
        if not (isinstance(meta, dict) and meta.get("v") == 1):
            raise ValueError("no fingerprint")
        if meta.get("fp") != host_fingerprint():
            raise ValueError(f"built on another machine (fp {meta.get('fp')!r} != host {host_fingerprint()!r})")
        if meta.get("sha256") != _digest(lib):
            raise ValueError("digest mismatch (corrupt library)")
        return True
    except (OSError, ValueError) as e:
        _bump("errors")
        log.warning("kernel library %s refused (%s); deleting it and rebuilding", lib, e)
        for p in (lib, side):
            try:
                p.unlink()
            except OSError:
                pass
        return False


@contextlib.contextmanager
def _dir_lock(directory: Path):
    """An exclusive lock on the build directory, between processes and
    between threads (each holder opens the lock file anew)."""
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names=KERNELS) -> None:
    """Compile every named library that is not in the build directory yet
    (or that its check deleted there), in parallel, under the directory's
    lock: a process that waited on another's build finds its libraries."""
    failed = []
    with _dir_lock(build_dir()):
        running = []
        t0 = time.monotonic()
        for name in names:
            out = _lib_path(name)
            if library_ok(out):
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, proc, tmp, out))
        for name, proc, tmp, out in running:
            output = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{output}")
                continue
            out.with_suffix(".log").write_text(output)
            _seal(tmp, out)
            os.replace(tmp, out)
            _built_here.add(out)
            _bump("saves")
            _bump("bytes_saved", out.stat().st_size)
        if running:
            _bump("nvcc_s", time.monotonic() - t0)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, spills) from the build of `name`."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`: from the build
    directory where it is there and passes its check, else built first."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:  # one build per process, whichever thread asks
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                path = _lib_path(name)
                if path not in _built_here:
                    _bump("loads")
                lib = ctypes.CDLL(str(path))
                _loaded[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` counter (thread-safe) and
    to the process's total, and to its count for the mesh shard the
    thread runs, if any."""
    with _launch_lock:
        wrapper.launches += 1
        _launch_totals[wrapper.__name__] = _launch_totals.get(wrapper.__name__, 0) + 1
        shard = getattr(_shard, "index", None)
        if shard is not None:
            per = _shard_launches.setdefault(wrapper.__name__, {})
            per[shard] = per.get(shard, 0) + 1


def launch_totals() -> dict[str, int]:
    """This process's launches of each kernel since it started."""
    with _launch_lock:
        return {name: _launch_totals.get(name, 0) for name in KERNEL_WRAPPERS}


# A mesh engine runs each dp row's step under `shard_scope(i)`, so that
# the launches of each shard can be read apart, even where shards share a
# card (`shard_launches`).
_shard = threading.local()
_shard_launches: dict[str, dict[int, int]] = {}


@contextlib.contextmanager
def shard_scope(index: int):
    """Count this thread's launches in the block for mesh shard `index`."""
    prev = getattr(_shard, "index", None)
    _shard.index = index
    try:
        yield
    finally:
        _shard.index = prev


def shard_launches() -> dict[str, dict[int, int]]:
    """Launches per kernel and shard since the last reset."""
    with _launch_lock:
        return {k: dict(v) for k, v in _shard_launches.items()}


def reset_shard_launches() -> None:
    with _launch_lock:
        _shard_launches.clear()


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
