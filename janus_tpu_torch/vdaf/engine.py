"""Batched FLP prove / query / decide over report batches.

One call processes a whole report batch: every value is a limb-tuple
field tensor with a leading [batch] axis, wire and gadget polynomial
interpolation is the batched NTT of ops/ntt.py, and gadget evaluation
is elementwise. Field elements are identical to the JAX package's
vdaf/engine.py on the same inputs (held against it by the tests).

All four Prio3 circuits here (Count/Sum/SumVec/Histogram) have exactly
one gadget use of degree 2; the adapters below encode each circuit's
gadget-call schedule as reshapes over the batch. Per-report validity
never branches: an invalid report yields a False lane in the decision
mask and is dropped at aggregation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields.tfield import (
    TF64,
    TF128,
    fconst,
    fmap,
    fmul_pow2,
    fpow_const,
    fsum,
    fwhere,
    is_zero,
)
from ..ops.limbmm import fold_contract
from ..ops.ntt import intt_batched, lagrange_eval_weights, ntt_batched, poly_eval_powers, powers
from .circuits import EVAL_POINT_CANDIDATES, Circuit, Count, Histogram, Sum, SumVec, next_pow2


def tf_for(circuit: Circuit):
    return {8: TF64, 16: TF128}[circuit.FIELD.ENCODED_SIZE]


# ---------------------------------------------------------------------------
# Per-circuit batched adapters
# ---------------------------------------------------------------------------


class BatchedCircuit:
    """Vectorized gadget schedule for one validity circuit.

    All methods take/return limb-tuple field values with a leading
    [batch] axis. `calls_inputs` returns [batch, calls, arity];
    `gadget_eval` consumes wires with arity on axis 1 ([batch, arity,
    ...]) and returns the gadget output with that axis dropped.
    """

    def __init__(self, circ: Circuit):
        self.circ = circ
        self.tf = tf_for(circ)
        assert len(circ.gadget_uses) == 1, "Prio3 circuits have one gadget use"
        use = circ.gadget_uses[0]
        self.arity = use.gadget.arity
        self.calls = use.calls
        self.m = use.wire_poly_len
        self.gp_len = use.gadget_poly_len
        self.n2 = next_pow2(self.gp_len)

    def encode_batch(self, measurements) -> np.ndarray:
        """[batch] measurements -> [batch, input_len] uint64 (< p)."""
        raise NotImplementedError

    def calls_inputs(self, inp, joint_rand, shares_inv: int):
        raise NotImplementedError

    def gadget_eval(self, wires):
        raise NotImplementedError

    def finish(self, inp, joint_rand, gadget_outs, shares_inv: int):
        raise NotImplementedError

    def truncate(self, inp):
        raise NotImplementedError

    def _sic(self, shares_inv: int, device):
        return fconst(self.tf, shares_inv, (), device)


class BCount(BatchedCircuit):
    def encode_batch(self, measurements):
        a = np.asarray(measurements, dtype=np.uint64)
        assert ((a == 0) | (a == 1)).all()
        return a[:, None]

    def calls_inputs(self, inp, joint_rand, shares_inv):
        # [[x, x]]: one call, arity 2
        return fmap(lambda x: x[:, :, None].expand(-1, -1, 2), inp)

    def gadget_eval(self, wires):
        return self.tf.mul(fmap(lambda x: x[:, 0], wires), fmap(lambda x: x[:, 1], wires))

    def finish(self, inp, joint_rand, gadget_outs, shares_inv):
        return self.tf.sub(fmap(lambda x: x[:, 0], gadget_outs), fmap(lambda x: x[:, 0], inp))

    def truncate(self, inp):
        return inp


class BSum(BatchedCircuit):
    def encode_batch(self, measurements):
        a = np.asarray(measurements, dtype=np.uint64)
        bits = self.circ.bits
        if bits < 64:
            assert (a < (np.uint64(1) << np.uint64(bits))).all()
        return (a[:, None] >> np.arange(bits, dtype=np.uint64)[None, :]) & np.uint64(1)

    def calls_inputs(self, inp, joint_rand, shares_inv):
        return fmap(lambda x: x[:, :, None], inp)  # [batch, bits, 1]

    def gadget_eval(self, wires):
        tf = self.tf
        x = fmap(lambda w: w[:, 0], wires)
        return tf.sub(tf.mul(x, x), x)  # x^2 - x

    def finish(self, inp, joint_rand, gadget_outs, shares_inv):
        tf = self.tf
        r = fmap(lambda x: x[:, 0], joint_rand)
        rp = fmap(lambda x: x[..., 1:], powers(tf, r, self.calls + 1))  # r^1..r^calls
        return fsum(tf, tf.mul(rp, gadget_outs), axis=-1)

    def truncate(self, inp):
        return fmap(lambda x: x[:, None], _pow2_weighted_sum(self.tf, inp, self.circ.bits, axis=-1))


class _BChunked(BatchedCircuit):
    """Shared ParallelSum(Mul, chunk) schedule of SumVec and Histogram."""

    def calls_inputs(self, inp, joint_rand, shares_inv):
        """(r^{i+1} x_i, x_i - shares_inv) pairs -> [batch, calls, 2*chunk]."""
        tf = self.tf
        n = self.circ.input_len
        ch = self.circ.chunk_length
        r = fmap(lambda x: x[:, 0], joint_rand)
        rp = fmap(lambda x: x[..., 1:], powers(tf, r, n + 1))  # [batch, n]: r^1..r^n
        a = tf.mul(rp, inp)
        b = tf.sub(inp, self._sic(shares_inv, inp[0].device))
        # interleave (a_i, b_i), then pad to calls*chunk pairs
        pairs = fmap(lambda x, y: torch.stack([x, y], dim=-1).reshape(x.shape[0], -1), a, b)
        pad = self.calls * ch * 2 - pairs[0].shape[-1]
        if pad:
            pairs = fmap(lambda x: torch.nn.functional.pad(x, (0, pad)), pairs)
        return fmap(lambda x: x.reshape(x.shape[0], self.calls, 2 * ch), pairs)

    def gadget_eval(self, wires):
        # wires [batch, 2*chunk, ...] -> sum_c w[2c]*w[2c+1]
        tf = self.tf
        ch = self.circ.chunk_length
        shaped = fmap(lambda w: w.reshape((w.shape[0], ch, 2) + tuple(w.shape[2:])), wires)
        x = fmap(lambda w: w[:, :, 0], shaped)
        y = fmap(lambda w: w[:, :, 1], shaped)
        return fsum(tf, tf.mul(x, y), axis=1)


class BSumVec(_BChunked):
    def encode_batch(self, measurements):
        a = np.asarray(measurements, dtype=np.uint64)  # [batch, length]
        bits = self.circ.bits
        out = (a[:, :, None] >> np.arange(bits, dtype=np.uint64)[None, None, :]) & np.uint64(1)
        return out.reshape(a.shape[0], -1)

    def finish(self, inp, joint_rand, gadget_outs, shares_inv):
        return fsum(self.tf, gadget_outs, axis=-1)

    def truncate(self, inp):
        # bits-major [batch, bits, length]: sum_b 2^b x[:, b, :]
        bits = self.circ.bits
        length = self.circ.length
        v = fmap(lambda x: x.reshape(x.shape[0], length, bits).transpose(1, 2), inp)
        return _pow2_weighted_sum(self.tf, v, bits)


class BHistogram(_BChunked):
    def encode_batch(self, measurements):
        a = np.asarray(measurements, dtype=np.int64)
        assert ((0 <= a) & (a < self.circ.length)).all()
        out = np.zeros((a.shape[0], self.circ.length), dtype=np.uint64)
        out[np.arange(a.shape[0]), a] = 1
        return out

    def finish(self, inp, joint_rand, gadget_outs, shares_inv):
        tf = self.tf
        bit_check = fsum(tf, gadget_outs, axis=-1)
        sum_check = tf.sub(fsum(tf, inp, axis=-1), self._sic(shares_inv, inp[0].device))
        jr1 = fmap(lambda x: x[:, 1], joint_rand)
        return tf.add(bit_check, tf.mul(jr1, sum_check))

    def truncate(self, inp):
        return inp


_ADAPTERS = {Count: BCount, Sum: BSum, SumVec: BSumVec, Histogram: BHistogram}


def _pow2_weighted_sum(tf, v, bits: int, axis: int = 1):
    """sum_b 2^b * v[:, b, ...] over a bits-major axis, by shift-based
    constant multiplies (fmul_pow2)."""
    acc = fmap(lambda x: x.select(axis, 0), v)
    for b in range(1, bits):
        acc = tf.add(acc, fmul_pow2(tf, fmap(lambda x: x.select(axis, b), v), b))
    return acc


def batched_circuit(circ: Circuit) -> BatchedCircuit:
    return _ADAPTERS[type(circ)](circ)


# ---------------------------------------------------------------------------
# FLP prove / query / decide (batched)
# ---------------------------------------------------------------------------


def _wire_polys(bc: BatchedCircuit, seeds, ci):
    """Interpolate wire polynomials: [batch, arity, m] coefficients.

    seeds: [batch, arity] (prove rand or proof-share head); ci: calls
    inputs [batch, calls, arity]. Wire j's values on the NTT domain are
    [seed_j, ci[0][j], ..., ci[calls-1][j], 0...].
    """
    evals = fmap(lambda s, c: torch.cat([s[:, :, None], c.transpose(1, 2)], dim=-1), seeds, ci)
    if 1 + bc.calls < bc.m:
        evals = fmap(lambda x: torch.nn.functional.pad(x, (0, bc.m - (1 + bc.calls))), evals)
    return intt_batched(bc.tf, evals)


def flp_prove_batched(bc: BatchedCircuit, inp, prove_rand, joint_rand):
    """proof [batch, proof_len]."""
    tf = bc.tf
    ci = bc.calls_inputs(inp, joint_rand, 1)
    wire_evals = ntt_batched(tf, _wire_polys(bc, prove_rand, ci), bc.n2)  # [batch, arity, n2]
    gpoly = intt_batched(tf, bc.gadget_eval(wire_evals))
    return fmap(lambda s, g: torch.cat([s, g[..., : bc.gp_len]], dim=-1), prove_rand, gpoly)


def _pick_eval_point(tf, cands, m: int):
    """First candidate t (of EVAL_POINT_CANDIDATES) with t^m != 1."""
    tm = fpow_const(tf, cands, m)  # [batch, 4]
    ok = ~is_zero(tf.sub(tm, fconst(tf, 1, (), cands[0].device)))
    idx = torch.argmax(ok.to(torch.int64), dim=-1)  # first True (0 if none)
    return fmap(lambda x: torch.gather(x, -1, idx[:, None])[:, 0], cands)


def _query_proof_side(bc: BatchedCircuit, proof_share, query_rand):
    """Shared proof-share setup of every query variant: split
    seeds/gadget coefficients, pick the eval point t, evaluate the
    gadget polynomial at the call points, and compute t's Lagrange
    weights. Returns (seeds, gcoeffs, t, outs, pw, L0, Lc)."""
    tf = bc.tf
    seeds = fmap(lambda x: x[..., : bc.arity], proof_share)
    gcoeffs = fmap(lambda x: x[..., bc.arity : bc.arity + bc.gp_len], proof_share)
    assert query_rand[0].shape[-1] == EVAL_POINT_CANDIDATES
    t = _pick_eval_point(tf, query_rand, bc.m)
    # gadget outputs at call points alpha^{k+1}: fold mod x^m - 1, NTT_m
    folds = -(-bc.gp_len // bc.m)
    padded = fmap(lambda x: torch.nn.functional.pad(x, (0, folds * bc.m - bc.gp_len)), gcoeffs)
    gfold = fsum(tf, fmap(lambda x: x.reshape(x.shape[0], folds, bc.m), padded), axis=1)
    gevals = ntt_batched(tf, gfold, bc.m)  # values at alpha^0..alpha^{m-1}
    outs = fmap(lambda x: x[..., 1 : bc.calls + 1], gevals)
    pw = powers(tf, t, bc.gp_len)
    L = lagrange_eval_weights(tf, pw, bc.m)
    L0 = fmap(lambda x: x[:, 0], L)
    Lc = fmap(lambda x: x[:, 1 : 1 + bc.calls], L)
    return seeds, gcoeffs, t, outs, pw, L0, Lc


def _chunked_wire_weights(bc: BatchedCircuit, Lc, r):
    """Per-call weight rows for the wire contraction of the
    ParallelSum(Mul, chunk) schedule.

    wire_t[2i]   = r^{i+1} * sum_call (L_call * r^{call*ch}) * X[call, i]
    wire_t[2i+1] =           sum_call  L_call               * X[call, i]
                   - shares_inv * (sum of L over calls whose position i
                                   is a real input element)

    Returns (w [batch, 2, calls], rc1 [batch, ch]), rc1 = r^1..r^ch.
    """
    tf = bc.tf
    ch = bc.circ.chunk_length
    n_calls = Lc[0].shape[-1]
    rc = powers(tf, r, ch + 1)  # [batch, ch+1]
    rc1 = fmap(lambda x: x[:, 1:], rc)
    rch = fmap(lambda x: x[:, ch], rc)  # r^ch
    rpow_ch = powers(tf, rch, n_calls)  # r^{call*ch}
    u0 = tf.mul(Lc, rpow_ch)
    return fmap(lambda a, b: torch.stack([a, b], dim=1), u0, Lc), rc1


def _chunked_b_correction(bc: BatchedCircuit, Lc, shares_inv):
    """shares_inv * SL_i (see _chunked_wire_weights): SL for positions
    covered by every call, minus the last call's weight at padded
    positions (input_len is not a multiple of chunk)."""
    tf = bc.tf
    ch = bc.circ.chunk_length
    device = Lc[0].device
    SL = fsum(tf, Lc, axis=-1)  # [batch]
    rem = bc.circ.input_len - (bc.calls - 1) * ch
    SLvec = fmap(lambda x: x[:, None].expand(x.shape[0], ch), SL)
    if rem < ch:
        SLpad = tf.sub(SL, fmap(lambda x: x[:, bc.calls - 1], Lc))
        mask = torch.arange(ch, device=device) < rem
        SLvec = fwhere(mask[None, :], SLvec, fmap(lambda x: x[:, None].expand(x.shape[0], ch), SLpad))
    return tf.mul(SLvec, fconst(tf, shares_inv, (), device))


def _chunked_X(bc: BatchedCircuit, inp_share):
    """[batch, input_len] share -> zero-padded [batch, calls, ch]."""
    ch = bc.circ.chunk_length
    pad = bc.calls * ch - bc.circ.input_len
    x = inp_share
    if pad:
        x = fmap(lambda v: torch.nn.functional.pad(v, (0, pad)), x)
    return fmap(lambda v: v.reshape(v.shape[0], bc.calls, ch), x)


def _verifier(v, wire_t, proof_t):
    return fmap(lambda a, b, c: torch.cat([a[:, None], b, c[:, None]], dim=-1), v, wire_t, proof_t)


def flp_query_batched(bc: BatchedCircuit, inp_share, proof_share, query_rand, joint_rand, num_shares: int):
    """verifier share [batch, verifier_len].

    The chunked circuits (SumVec, Histogram) take the contraction path
    (_flp_query_batched_mm); Count and Sum take the elementwise fold."""
    if type(bc.circ) in (SumVec, Histogram):
        return _flp_query_batched_mm(bc, inp_share, proof_share, query_rand, joint_rand, num_shares)
    tf = bc.tf
    shares_inv = bc.circ.FIELD.inv(num_shares)
    ci = bc.calls_inputs(inp_share, joint_rand, shares_inv)
    seeds, gcoeffs, t, outs, pw, L0, Lc = _query_proof_side(bc, proof_share, query_rand)
    # wire_j(t) = seed_j*L_0(t) + sum_i ci[i, j]*L_{i+1}(t), with L the
    # Lagrange basis at t: no wire-polynomial interpolation
    prod = tf.mul(ci, fmap(lambda x: x[:, :, None], Lc))  # [batch, calls, arity]
    wire_t = tf.add(fsum(tf, prod, axis=1), tf.mul(seeds, fmap(lambda x: x[:, None], L0)))
    proof_t = poly_eval_powers(tf, gcoeffs, pw)  # [batch]
    v = bc.finish(inp_share, joint_rand, outs, shares_inv)  # [batch]
    return _verifier(v, wire_t, proof_t)


def _flp_query_batched_mm(bc: BatchedCircuit, inp_share, proof_share, query_rand, joint_rand, num_shares: int):
    """flp_query_batched for the ParallelSum(Mul, chunk) circuits, with
    the O(input_len) wire fold as one limb contraction (ops/limbmm.py)."""
    tf = bc.tf
    shares_inv = bc.circ.FIELD.inv(num_shares)
    batch = inp_share[0].shape[0]
    seeds, gcoeffs, t, outs, pw, L0, Lc = _query_proof_side(bc, proof_share, query_rand)
    r = fmap(lambda x: x[:, 0], joint_rand)
    w, rc1 = _chunked_wire_weights(bc, Lc, r)
    Fw = fold_contract(tf, w, _chunked_X(bc, inp_share))  # [batch, 2, ch]
    A = tf.mul(fmap(lambda x: x[:, 0], Fw), rc1)
    B = tf.sub(fmap(lambda x: x[:, 1], Fw), _chunked_b_correction(bc, Lc, shares_inv))
    wire_t = fmap(lambda a, b: torch.stack([a, b], dim=-1).reshape(batch, -1), A, B)
    wire_t = tf.add(wire_t, tf.mul(seeds, fmap(lambda x: x[:, None], L0)))
    proof_t = poly_eval_powers(tf, gcoeffs, pw)
    v = bc.finish(inp_share, joint_rand, outs, shares_inv)
    return _verifier(v, wire_t, proof_t)


def flp_decide_batched(bc: BatchedCircuit, verifier):
    """Boolean accept mask [batch] over combined verifier messages."""
    tf = bc.tf
    v0 = fmap(lambda x: x[:, 0], verifier)
    wires = fmap(lambda x: x[:, 1 : 1 + bc.arity], verifier)
    y = fmap(lambda x: x[:, 1 + bc.arity], verifier)
    return is_zero(v0) & is_zero(tf.sub(bc.gadget_eval(wires), y))

