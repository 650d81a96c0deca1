"""The kernel-library cache: the port's counterpart of janus_tpu's
serialized-executable AOT cache.

The port's one compiled artifact on disk is a kernel library: each
hand-written CUDA source (csrc/*.cu) built by nvcc into a shared library
with a plain C interface. ops/cuda_build.py owns the whole decision: the
key (source, headers, flags and this host's fingerprint), the sidecar
check against foreign or corrupt libraries, the lock that processes
sharing a directory build under, and the counts. This module is the
operator's side of it: `arm(dir)` moves the build directory away from
`janus_tpu_torch/_build/` (janus_main arms `<compile_cache_dir>/aot`),
and `status()` is the `aot` slice of the /statusz `engine_prewarm`
section. A process finds its libraries there and loads them (`loads`),
or builds them with nvcc from the sources in its checkout (`saves`): a
cold boot pays the builds, a warm one does not. There is no
plain-version fallback: a CUDA tensor runs its kernel or the call
raises.

What janus_tpu's AOT layer does that has no counterpart here: it
serializes a traced, compiled XLA program per (engine, jit variant,
argument avals) and deserializes it to skip the re-trace. The port runs
eagerly: there is no traced program to serialize, so the cache holds the
four kernel libraries and nothing per shape. The cold first call of a
shape (lazy module loading, the allocator's first segments, cuBLAS's
first handle) is what the shape manifest records and the prewarm pays
before ready.
"""

from __future__ import annotations

import os

from ..ops import cuda_build

BLOB_SUFFIX = ".so"


def arm(directory: str) -> None:
    """Build and load the kernel libraries in `directory` (created on the
    first build) instead of janus_tpu_torch/_build/."""
    cuda_build.set_build_dir(directory)


def disarm() -> None:
    cuda_build.set_build_dir(None)


def armed_dir() -> str | None:
    return cuda_build.build_dir_set()


def stats() -> dict:
    """O(1) counter snapshot (no directory scan): `loads`, `saves`,
    `errors`, `bytes_saved` and `nvcc_s`, counted in every process, armed
    or not."""
    return cuda_build.cache_stats()


def status() -> dict:
    """The `aot` slice of the /statusz engine_prewarm section: whether a
    directory is armed, the build directory, its libraries and their
    bytes, and the counts."""
    d = cuda_build.build_dir()
    blobs = blob_bytes = 0
    try:
        with os.scandir(d) as it:
            for ent in it:
                if ent.name.endswith(BLOB_SUFFIX):
                    blobs += 1
                    try:
                        blob_bytes += ent.stat().st_size
                    except OSError:
                        pass
    except OSError:
        pass
    return {"enabled": armed_dir() is not None, "dir": str(d), "blobs": blobs, "blob_bytes": blob_bytes,
            **stats()}


def reset_for_tests() -> None:
    disarm()
    cuda_build.reset_cache_stats()
