"""janus_tpu_torch: the Prio3 device path of janus_tpu in PyTorch and CUDA.

A port of the JAX package `janus_tpu` for an NVIDIA H100. It keeps the
JAX package's module layout (fields/, ops/, vdaf/, parallel/) and its
public layouts (a field value is a tuple of limb tensors), so the two
packages can be held against each other on the same inputs. The JAX
package is the reference; this package imports nothing of it.

Entry points run on CUDA unless the caller passes device="cpu"; the
hand-written kernels live in csrc/ and are built with nvcc on first use
(ops/cuda_build.py).
"""

__version__ = "0.1.0"


def __getattr__(name):
    # `resolve_device` is read lazily: importing the package imports no
    # torch, so an operator tool that needs no device (debug_bundle,
    # dap_decode, hpke_keygen) starts without it
    if name == "resolve_device":
        from .device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
