"""Carry report batches and field values between numpy and the port.

The JAX package's state is report batches and keys: uint64 lane arrays
and limb tuples of uint64 arrays. The port holds the same bit patterns
as int64 tensors. Through numpy (`arr.view(np.int64)`) the values pass
unchanged either way, so a batch sharded by one package can be prepared
by the other.
"""

from __future__ import annotations

import numpy as np
import torch


def from_numpy_u64(arr, device) -> torch.Tensor:
    """uint64 (or int64) numpy array -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint64, copy=False))
    return torch.from_numpy(a.view(np.int64).copy()).to(device)


def to_numpy_u64(t: torch.Tensor) -> np.ndarray:
    """int64 tensor -> uint64 numpy array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)


def _map(value, fn):
    if value is None:
        return None
    if isinstance(value, tuple):
        return tuple(fn(x) for x in value)
    return fn(value)


def step_args_from_jax(args, device):
    """The 7-tuple (nonce_lanes, public_parts, leader_meas, leader_proof,
    blind0, helper_seed, blind1) of janus_tpu's make_report_batch (arrays
    or numpy) -> the port's tensors on `device`. None entries stay None;
    field values stay limb tuples."""
    return tuple(_map(a, lambda x: from_numpy_u64(np.asarray(x), device)) for a in args)


def step_args_to_numpy(args):
    """The reverse of step_args_from_jax: the port's tensors -> uint64
    numpy arrays that janus_tpu's two_party_step takes."""
    return tuple(_map(a, to_numpy_u64) for a in args)
