"""Build the hand-written CUDA kernels (csrc/*.cu) and load them with ctypes.

Each source compiles with nvcc into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library is keyed by a hash of its source, the headers in csrc/ and
the flags, and is built on first use into janus_tpu_torch/_build/ (listed
in .gitignore). `build()` starts one nvcc per source, all together. A
failed build raises with nvcc's output; ptxas's register and spill
report is kept beside each library (`build_log`).

Every kernel wrapper counts its launches with `count_launch`, under one
lock: the leader's job driver and the helper's handler may launch from
two threads of one process.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("keccak", "expand_f128", "keccak_sponge", "scatter_rows")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_launch_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> None:
    """Compile every named library that is not built yet, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, spills) from the build of `name`."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:  # one build per process, whichever thread asks
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(_lib_path(name)))
                _loaded[name] = lib
    return lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `launches` counter (thread-safe), and
    to its count for the mesh shard the thread runs, if any."""
    with _launch_lock:
        wrapper.launches += 1
        shard = getattr(_shard, "index", None)
        if shard is not None:
            per = _shard_launches.setdefault(wrapper.__name__, {})
            per[shard] = per.get(shard, 0) + 1


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
