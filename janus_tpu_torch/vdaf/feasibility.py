"""Device-memory feasibility model for prepare dispatches.

The port's own copy of the JAX package's vdaf/feasibility.py model: how
many report rows of a two-party prepare fit a device's memory, from the
circuit geometry alone.

- `device_memory_budget(device)` is the card's total memory
  (`torch.cuda.get_device_properties`), or None for the CPU, which the
  callers treat as unbounded. There is no environment override: a
  caller that wants another budget passes `budget_bytes`.
- `prepare_row_bytes()` estimates resident bytes per report row from
  the input, proof, verifier and output lengths and the limb width, plus
  the working set of the whole-share query (the JAX package's tiled term
  for its streamed query comes with that query, which is not ported yet).
- `feasible_rows()` / `feasible_bucket()` turn that into the largest
  batch, and the largest power-of-two batch, that fits.

A first-order estimate with headroom, not a buffer-assignment oracle.
"""

from __future__ import annotations

import torch

# Fraction of the budget the model plans into: slack for temporaries
# and the allocator's fragmentation.
HEADROOM = 0.85

# Whole-share working copies for the untiled query: calls-inputs
# tensor, its r-power product, and the interleaved pairs.
UNTILED_WORKING_COPIES = 4


def device_memory_budget(device) -> int | None:
    """Total memory of a CUDA device in bytes, or None for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def _elem_bytes(circ) -> int:
    # one field element = LIMBS u64 lanes = ENCODED_SIZE bytes resident
    return circ.FIELD.ENCODED_SIZE


def prepare_row_bytes(circ, draft: bool = False) -> int:
    """Modeled resident bytes per report row of a two-party prepare.

    draft: the VDAF-07 framing materializes the full helper share (the
    sequential sponge has no random-access counter) plus its rejection
    candidate stream, so it pays O(input_len) more per row.
    """
    per = _elem_bytes(circ)
    n = circ.input_len
    # the leader measurement share is resident for the whole step; both
    # proof shares, both verifier shares, both out shares
    resident = n * per
    resident += 2 * circ.proof_len * per
    resident += 2 * circ.verifier_len * per
    resident += 2 * circ.output_len * per
    resident += UNTILED_WORKING_COPIES * n * per
    if draft:
        # the materialized helper share and the ~1.5x candidate stream
        # the rejection sampler reads it from
        resident += int(2.5 * n * per)
    return resident


def feasible_rows(circ, budget_bytes: int | None, draft: bool = False) -> int | None:
    """Largest report-row count the budget supports, or None (unbounded)
    when the budget is unknown. Always at least 1."""
    if budget_bytes is None:
        return None
    row = prepare_row_bytes(circ, draft=draft)
    return max(1, int(budget_bytes * HEADROOM) // max(1, row))


def feasible_bucket(circ, budget_bytes: int | None, draft: bool = False) -> int | None:
    """Largest power-of-two batch within the budget (None = unbounded)."""
    rows = feasible_rows(circ, budget_bytes, draft=draft)
    if rows is None:
        return None
    b = 1
    while b * 2 <= rows:
        b *= 2
    return b
