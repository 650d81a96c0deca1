"""Device-memory feasibility model for prepare dispatches.

How many report rows of a two-party prepare fit a device's memory, from
the circuit's geometry alone. The JAX package's vdaf/feasibility.py
counts its own buffers (XLA's); this model counts the bytes the port
holds, tensor by tensor, as the code in vdaf/prio3.py, vdaf/engine.py,
vdaf/keccak.py and ops/limbmm.py allocates them:

- `device_memory_budget(device)` is the card's total memory
  (`torch.cuda.get_device_properties`), or None for the CPU, which the
  callers treat as unbounded. There is no environment override: a
  caller that wants another budget passes `budget_bytes`.
- `prepare_row_bytes()` is the bytes a report row holds at the step's
  peak: what stays resident through the step, plus the largest of the
  transient phases, which run one after another.
- `feasible_rows()` / `feasible_bucket()` turn that into the largest
  batch, and the largest power-of-two batch, that fits.

Per report row, with n = input_len, e = a field element's bytes (16 for
Field128, 8 for Field64), nl = its 7-bit limbs (19 or 10), ch = the
chunk length and K = the elements one fold contracts (calls x ch for the
whole share, the tile for the streamed query):

Resident through the step
  - the leader's staged measurement share: n e;
  - both proof shares, both verifier shares: 2 (proof_len + verifier_len) e;
  - both out shares: 2 output_len e; the streamed query writes each into
    a truncate buffer of whole tiles, n_steps x tile / bits elements;
  - draft mode: the helper's share, n e, which the sequential sponge
    expands whole (the sponge kernel samples in place, so no candidate
    stream reaches memory, and it reads the joint-rand binders, the
    encoded shares, in place).

Transient phases (the largest counts)
  - the fast leader's joint-rand binder (circuits with joint
    randomness): its encoded share (n e) and the leaf digests (n e / 7):
    kernel 1's tree-level launch reads the binder's parts in place, so
    no assembled, padded or stacked copy of the message exists: 1.15 n e;
  - the contraction query (SumVec, CountVec, Histogram), whole share or
    one tile: the fast helper's share when it is whole (n e; a tile of
    kernel 2's output, K e, when streamed), the zero-padded share or
    last tile and the tile's reshaped copies for the fold and for
    truncate (3 K e), its float64 limbs (K nl 8, written in place by
    limbmm.decompose7, plus three int64 temporaries of K while a limb is
    cut), the product of the limb contraction in float64 and in int64 at
    once (2 x 2 nl x nl ch 8), and the Histogram's whole-share sum (n e);
  - the generic query (Count, Sum, FixedPointVec): the calls-inputs
    tensor of calls x arity elements, its product by the Lagrange
    weights, the Field128 multiply's 64-bit partial products, carries and
    reduction temporaries, and the sum's halving tree:
    GENERIC_WORKING_COPIES copies of it (the count held against the card
    at FixedPointVec(1000, 16): chip_smoke.py's fixedpoint line), and the
    whole share for the fast helper.

A block-sparse SumVec prepares at its compact width (the rows above),
then aggregates each party's out shares by the scatter kernel
(`sparse_aggregate_bytes`): both parties' compact out shares stay
resident (2 output_len e a row), and a dispatch adds the logical
accumulator it reads and the one it writes (2 L e, L = the logical
length) and the rows' flat indices (4 output_len a row); the kernel
adds into its output in place, and its only scratch is a mark byte a
64-position group (ops/scatter_cuda.py `scratch_bytes`), made per launch.

The resident route (aggregator/engine_cache.py) adds what it keeps
past a step (`resident_route_bytes`): the job's pending delta, k buckets
of output_len elements (a sparse job keeps no delta: its out shares,
counted above, wait for the merge, which writes a new logical slot of
L e beside the one it reads), and the slots every engine holds, the
process's resident ledger (`resident_bytes_total()`). The bucket choice
does not count them, as janus_tpu's does not.

A first-order count, checked against `max_memory_allocated` on the card
(chip_smoke.py prints both); the engine's OOM ladder is the backstop.
"""

from __future__ import annotations

import math

import torch

from ..ops.scatter_cuda import scratch_bytes
from .circuits import Histogram, SparseSumVec, SumVec

# Fraction of the budget the model plans into: slack for temporaries
# and the allocator's fragmentation.
HEADROOM = 0.85

# The fast leader's binder phase, in copies of its encoded share (above).
BINDER_COPIES = 1.15

# Copies of the calls-inputs tensor the generic query holds at once.
GENERIC_WORKING_COPIES = 26

# int64 temporaries while limbmm.decompose7 cuts one limb (shift, or, mask).
LIMB_TEMPS = 3

_NLIMB = {8: 10, 16: 19}  # 7-bit limbs an element, by its bytes


def device_memory_budget(device) -> int | None:
    """Total memory of a CUDA device in bytes, or None for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def mesh_memory_budget(devices) -> int | None:
    """The smallest budget of a mesh's devices (None where any is the
    CPU). janus_tpu caps a mesh engine's bucket from one device's budget
    and the whole bucket, which is conservative for a mesh; the port keeps
    that cap, so that its geometry and cap equal janus_tpu's."""
    budgets = [device_memory_budget(d) for d in devices]
    return None if any(b is None for b in budgets) else min(budgets)


def _elem_bytes(circ) -> int:
    # one field element = LIMBS int64 lanes = ENCODED_SIZE bytes resident
    return circ.FIELD.ENCODED_SIZE


def _contracts(circ) -> bool:
    """The query folds by limb contraction (engine._flp_query_batched_mm)."""
    return type(circ) in (SumVec, SparseSumVec, Histogram)


def prepare_row_bytes(circ, tile_elems: int | None = None, draft: bool = False) -> int:
    """Modeled peak bytes per report row of a two-party prepare.

    tile_elems: the streamed query's tile in input elements
    (StreamPlan.group), or None for the whole-share query. draft: the
    VDAF-07 framing (the helper's share exists whole).
    """
    e = _elem_bytes(circ)
    n = circ.input_len
    use = circ.gadget_uses[0]
    tiled = tile_elems is not None and tile_elems < n and _contracts(circ)

    out_elems = circ.output_len
    if tiled:
        out_elems = math.ceil(n / tile_elems) * tile_elems // getattr(circ, "bits", 1)
    resident = n * e + 2 * (circ.proof_len + circ.verifier_len + out_elems) * e
    if draft:
        resident += n * e

    phases = [0]
    if circ.joint_rand_len and not draft:
        phases.append(int(BINDER_COPIES * n * e))
    helper_share = 0 if draft else n * e
    if _contracts(circ):
        nl = _NLIMB[e]
        ch = circ.chunk_length
        k = tile_elems if tiled else use.calls * ch
        product = 2 * (2 * nl) * (nl * ch) * 8
        query = 3 * k * e + k * nl * 8 + max(LIMB_TEMPS * k * 8, product)
        if tiled:
            query += 0 if draft else k * e  # kernel 2's tile of the helper's share
        else:
            query += helper_share
            if isinstance(circ, Histogram):
                query += n * e
        phases.append(query)
    else:
        phases.append(GENERIC_WORKING_COPIES * use.calls * use.gadget.arity * e + helper_share)
    return resident + max(phases)


def sparse_aggregate_bytes(circ, rows: int) -> int:
    """Modeled peak bytes of a block-sparse aggregate over `rows` reports
    (above): the resident out shares of both parties, one scatter
    dispatch's accumulators and indices, and the kernel's marks."""
    e = _elem_bytes(circ)
    L = circ.agg_output_len
    return rows * circ.output_len * (2 * e + 4) + 2 * L * e + scratch_bytes(L)


def resident_route_bytes(circ, k: int, resident_bytes: int) -> dict:
    """Bytes the resident route holds beside a step (above): the pending
    delta of k batch buckets (for a sparse circuit, the merge's new
    logical slot), the resident slots held, and their sum."""
    e = _elem_bytes(circ)
    if isinstance(circ, SparseSumVec):
        pending = circ.agg_output_len * e
    else:
        pending = k * circ.output_len * e
    return {"pending_delta": pending, "resident": resident_bytes, "total": pending + resident_bytes}


def feasible_rows(circ, budget_bytes: int | None, tile_elems: int | None = None, draft: bool = False) -> int | None:
    """Largest report-row count the budget supports, or None (unbounded)
    when the budget is unknown. Always at least 1."""
    if budget_bytes is None:
        return None
    row = prepare_row_bytes(circ, tile_elems=tile_elems, draft=draft)
    return max(1, int(budget_bytes * HEADROOM) // max(1, row))


def feasible_bucket(circ, budget_bytes: int | None, tile_elems: int | None = None, draft: bool = False) -> int | None:
    """Largest power-of-two batch within the budget (None = unbounded)."""
    rows = feasible_rows(circ, budget_bytes, tile_elems=tile_elems, draft=draft)
    if rows is None:
        return None
    b = 1
    while b * 2 <= rows:
        b *= 2
    return b
