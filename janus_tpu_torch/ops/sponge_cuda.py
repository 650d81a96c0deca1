"""Whole draft-mode SHAKE128 XOF calls: a CUDA kernel (csrc/keccak_sponge.cu) and its plain version.

Replaces janus_tpu/ops/keccak_pallas.py keccak_f1600_pallas as the
draft sponge runs it (once per absorbed or squeezed block, inside
vdaf/keccak_jax.py shake128_squeeze_lanes). `keccak_sponge` runs one
VDAF-07 XOF call for every report of a batch in one launch:

- the message is a short per-report head ([batch, h] int64 lanes, the
  framing up to the body) and an optional body read in place from a
  field vector's limb planes (element by element, lo then hi) at byte
  offset `body_off`; the kernel shifts the body into place and writes
  the SHAKE padding itself;
- the output is either the first `out_lanes` lanes of the first squeezed
  block (a derived seed) or, with `sample=(length, limbs, modulus)`,
  `length` field elements drawn by draft rejection sampling from
  `limbs`-lane candidates, fused into the squeeze.

What bounds it on the H100 is the chain's latency: the sponge is
sequential per report, and at the draft path's widths (1,024 to 8,192
reports) one state's permutations in a row take far longer than the
card's integer throughput needs for all of them (the kernel's notes).

Dispatch is by device: on a CUDA tensor `keccak_sponge` launches the
kernel (and raises if it cannot); on a CPU tensor it runs
`keccak_sponge_plain`, the same function in plain PyTorch (the padded
message assembled in full, the per-block loop over
keccak_f1600_plain, and `reject_sample_scan`), which is also the
kernel's yardstick on the card. `rounds` is a runtime argument of both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields.tfield import fencode_lanes, i64, lsr, ult
from . import cuda_build
from .keccak_cuda import RATE_LANES, keccak_f1600_plain

RATE = 8 * RATE_LANES  # 168 bytes

# Rejected candidates a sampled vector absorbs before its tail stays zero
# (and the report fails the FLP check). P(> 8 rejects) even for Field64
# at 10M candidates is ~(10M * 2^-32)^9 / 9! ~ 2^-80; Field128's
# per-candidate reject probability is 2^-68.
REJECT_WINDOW = 8


def candidate_count(length: int) -> int:
    """Candidates a sampled vector may consume: the window plus slack."""
    return length + 2 * REJECT_WINDOW


def stream_blocks(length: int, limbs: int) -> int:
    """Squeezed blocks that hold every candidate of a `length` sample."""
    return -(-candidate_count(length) * limbs // RATE_LANES)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _shift_lanes(lanes, s: int):
    """Prepend s (0..7) zero bytes to a little-endian u64 lane string
    [batch, k] -> [batch, k+1] (the tail lane carries the spill)."""
    batch, k = lanes.shape
    out = torch.zeros((batch, k + 1), dtype=torch.int64, device=lanes.device)
    if s == 0:
        out[:, :k] = lanes
        return out
    out[:, :k] = lanes << (8 * s)
    out[:, 1:] |= lsr(lanes, 64 - 8 * s)
    return out


def or_segments(segments, n_lanes: int, batch: int, device):
    """Byte-offset segments ORed into one [batch, n_lanes] int64 lane string.

    segments: (byte_offset, content) with content either host bytes (any
    length; broadcast) or a [batch, k] int64 lane tensor (8k bytes).
    Segments must occupy disjoint bytes; a spill past n_lanes must be
    zero bytes.
    """
    out = torch.zeros((batch, n_lanes), dtype=torch.int64, device=device)
    for off, content in segments:
        base, s = divmod(off, 8)
        if isinstance(content, (bytes, bytearray)):
            # host bytes go in as scalars, one in-place OR per lane: a
            # host-to-device copy would wait for the stream
            raw = b"\x00" * s + bytes(content)
            raw = raw.ljust(-(-len(raw) // 8) * 8, b"\x00")
            for i, v in enumerate(np.frombuffer(raw, dtype="<u8")):
                assert base + i < n_lanes or not v, (off, n_lanes)
                if v:
                    out[:, base + i] |= i64(int(v))
            continue
        assert content.dtype == torch.int64 and content.device == out.device
        seg = _shift_lanes(content, s)
        assert base + seg.shape[1] <= n_lanes + 1, (off, seg.shape[1], n_lanes)
        seg = seg[:, : n_lanes - base]  # drop an all-zero spill tail
        out[:, base : base + seg.shape[1]] |= seg
    return out


def sponge_message(head, msg_len: int, body=(), body_off: int = 0):
    """The padded SHAKE128 message head || body: [batch, n_blocks, 21]."""
    batch = head.shape[0]
    n_blocks = msg_len // RATE + 1
    total = n_blocks * RATE_LANES
    segs = [(0, head)]
    if body:
        segs.append((body_off, fencode_lanes(body)))
    # SHAKE padding: 0x1F after the message, 0x80 at the last rate byte
    # (bit-disjoint even when they share a byte or a lane)
    segs += [(msg_len, b"\x1f"), (total * 8 - 1, b"\x80")]
    return or_segments(segs, total, batch, head.device).view(batch, n_blocks, RATE_LANES)


def sponge_squeeze_plain(msg_lanes, out_blocks: int, rounds: int = 24):
    """SHAKE128 over padded messages [batch, n_blocks, 21]: absorb block
    by block, then squeeze [batch, out_blocks, 21] stream lanes (the first
    squeezed block is the state after absorbing)."""
    batch, n_blocks, _ = msg_lanes.shape
    zero = torch.zeros((batch,), dtype=torch.int64, device=msg_lanes.device)
    state = [zero] * 25
    for blk in range(n_blocks):
        state = [s ^ msg_lanes[:, blk, i] if i < RATE_LANES else s for i, s in enumerate(state)]
        state = list(keccak_f1600_plain(state, rounds))
    out = []
    for blk in range(out_blocks):
        if blk:
            state = list(keccak_f1600_plain(state, rounds))
        out.append(torch.stack(state[:RATE_LANES], dim=-1))
    return torch.stack(out, dim=1)


def reject_sample_scan(stream_lanes, length: int, limbs: int, modulus: int):
    """Draft rejection sampling with the semantics of a sequential scan:
    candidate i (lanes i*limbs .. i*limbs+limbs-1 of the stream,
    [batch, >= candidate_count(length) * limbs]) is kept when below
    `modulus` (unsigned); a kept candidate fills the next element while
    at most REJECT_WINDOW candidates were rejected before it, and past
    that the tail stays zero. The scan's running reject count is a prefix
    sum, so a kept candidate i with r rejects before it lands at element
    i - r. Returns `limbs` planes [batch, length]."""
    batch = stream_lanes.shape[0]
    cands = candidate_count(length)
    assert stream_lanes.shape[1] >= cands * limbs
    planes = [stream_lanes[:, j : cands * limbs : limbs] for j in range(limbs)]
    p_lo = i64(modulus & ((1 << 64) - 1))
    p_hi = i64(modulus >> 64)
    if limbs == 1:
        accept = ult(planes[0], p_lo)
    else:
        accept = ult(planes[1], p_hi) | ((planes[1] == p_hi) & ult(planes[0], p_lo))
    rejected = (~accept).to(torch.int64)
    before = torch.cumsum(rejected, dim=1) - rejected  # rejects before each candidate
    at = torch.arange(cands, device=stream_lanes.device) - before  # its element, when kept
    fill = accept & (before <= REJECT_WINDOW) & (at < length)
    at = torch.where(fill, at, length)  # column `length` is a sink
    out = []
    for plane in planes:
        o = torch.zeros((batch, length + 1), dtype=torch.int64, device=stream_lanes.device)
        o.scatter_(1, at, torch.where(fill, plane, 0))
        out.append(o[:, :length].contiguous())
    return tuple(out)


def keccak_sponge_plain(head, msg_len: int, body=(), body_off: int = 0, out_lanes: int = 0, sample=None,
                        rounds: int = 24):
    """Plain PyTorch version of the kernel: same inputs, same outputs."""
    msg = sponge_message(head, msg_len, body, body_off)
    if sample is None:
        return sponge_squeeze_plain(msg, 1, rounds)[:, 0, :out_lanes]
    length, limbs, modulus = sample
    stream = sponge_squeeze_plain(msg, stream_blocks(length, limbs), rounds).reshape(head.shape[0], -1)
    return reject_sample_scan(stream, length, limbs, modulus)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int,  # head, head_lanes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,  # body
    ctypes.c_longlong, ctypes.c_longlong,  # body_off, msg_len
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_ulonglong,  # output mode
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]


def _launcher():
    fn = cuda_build.load("keccak_sponge").keccak_sponge_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(head, msg_len: int, body, body_off: int, out_lanes: int, sample):
    if head.dim() != 2 or not 0 <= head.shape[1] <= RATE_LANES:
        raise ValueError(f"keccak_sponge: head of shape {tuple(head.shape)}, want [batch, <= {RATE_LANES}]")
    batch = head.shape[0]
    if len(body) > 2 or any(p.dim() != 2 or p.shape != body[0].shape or p.shape[0] != batch for p in body):
        raise ValueError("keccak_sponge: body must be 0-2 limb planes of one shape [batch, n]")
    if any(t.dtype != torch.int64 or t.device != head.device for t in (head, *body)):
        raise ValueError("keccak_sponge: head and body must be int64 on one device")
    body_bytes = 8 * body[0].shape[1] * len(body) if body else 0
    if (body and msg_len != body_off + body_bytes) or msg_len < 0 or body_off < 0:
        raise ValueError(f"keccak_sponge: message of {msg_len} bytes, body of {body_bytes} at byte {body_off}")
    if (sample is None) == (not out_lanes):
        raise ValueError("keccak_sponge: give exactly one of out_lanes and sample")
    if sample is None and not 1 <= out_lanes <= RATE_LANES:
        raise ValueError(f"keccak_sponge: out_lanes {out_lanes}")
    if sample is not None:
        length, limbs, modulus = sample
        if length < 1 or limbs not in (1, 2) or not 0 < modulus < 1 << (64 * limbs):
            raise ValueError(f"keccak_sponge: sample {sample}")


def keccak_sponge(head, msg_len: int, body=(), body_off: int = 0, out_lanes: int = 0, sample=None,
                  rounds: int = 24):
    """One draft SHAKE128 XOF call per report.

    head: [batch, h] int64 lanes (h <= 21), message bytes from 0 (bytes
    at and past `body_off` zero); body: 0-2 int64 limb planes [batch, n]
    of field elements, encoded lo then hi, at byte `body_off`; msg_len:
    the message's bytes. Returns [batch, out_lanes] lanes, or with
    `sample=(length, limbs, modulus)` a tuple of `limbs` planes
    [batch, length].
    """
    body = tuple(body)
    _check(head, msg_len, body, body_off, out_lanes, sample)
    device = head.device
    if device.type == "cpu":
        return keccak_sponge_plain(head, msg_len, body, body_off, out_lanes, sample, rounds)
    if device.type != "cuda":
        raise ValueError(f"keccak_sponge: unsupported device {device}")
    batch = head.shape[0]
    head = head.contiguous()
    if body and any(p.stride(1) != 1 or p.stride(0) != body[0].stride(0) for p in body):
        body = tuple(p.contiguous() for p in body)
    if sample is None:
        length, limbs, modulus = 0, 1, 0
        outs = (torch.empty((batch, out_lanes), dtype=torch.int64, device=device),)
    else:
        length, limbs, modulus = sample
        outs = tuple(torch.empty((batch, length), dtype=torch.int64, device=device) for _ in range(limbs))
    if batch:
        body_ptrs = [p.data_ptr() for p in body] + [0] * (2 - len(body))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = _launcher()(
                head.data_ptr(), head.shape[1],
                body_ptrs[0], body_ptrs[1], body[0].stride(0) if body else 0,
                body[0].shape[1] * len(body) if body else 0, len(body),
                body_off, msg_len,
                out_lanes, length, limbs, modulus & ((1 << 64) - 1), modulus >> 64,
                outs[0].data_ptr(), outs[-1].data_ptr(), batch, rounds, stream,
            )
        cuda_build.check(rc, "keccak_sponge")
        cuda_build.count_launch(keccak_sponge)
    return outs[0] if sample is None else outs


keccak_sponge.launches = 0
