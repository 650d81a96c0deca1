"""Wire encodings for Prio3 shares + the ping-pong prepare protocol,
and columnar (de)serialization between wire bytes and device tensors.

The port's own copy of the Prio3 part of janus_tpu/vdaf/wire.py, with
the same byte layouts (the sparse-index codecs come with the sparse
circuits):

Share payloads (inside HPKE plaintext / PlaintextInputShare.payload):
  leader: meas_share_vec || proof_share_vec || [blind 16B]
  helper: seed 16B || [blind 16B]
Public share: joint-rand parts part0 || part1 (or empty).

Ping-pong messages (PrepareInit.message / PrepareResp continue payload):
  initialize(0): u8 tag || opaque u32 prep_share
  continue  (1): u8 tag || opaque u32 prep_msg || opaque u32 prep_share
  finish    (2): u8 tag || opaque u32 prep_msg
Prep share: verifier_share_vec || [joint_rand_part 16B]
Prep message: [joint_rand_seed 16B]

`tf` below is the port's tensor field class (fields/tfield.py TF64 or
TF128: LIMBS, MODULUS). Field values arrive as limb tuples of int64
tensors (the bits of u64 lanes) or of uint64 numpy arrays, or as an
engine's DeviceRows; the codecs read them through numpy in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import to_numpy_u64
from ..messages.codec import (
    PP_CONTINUE,
    PP_FINISH,
    PP_INITIALIZE,
    DecodeError,
    Decoder,
    Encoder,
)
from .circuits import Circuit

SEED_SIZE = 16


def _u64(x) -> np.ndarray:
    """A limb or lane array as uint64 numpy, bits unchanged."""
    if isinstance(x, torch.Tensor):
        return to_numpy_u64(x)
    return np.asarray(x, dtype=np.uint64)


# ---------------------------------------------------------------------------
# columnar field-vector codecs (numpy, whole-batch)
# ---------------------------------------------------------------------------


def field_rows_u8(tf, value) -> np.ndarray:
    """Device field value [batch, n] -> one uint8 matrix [batch, n*enc]
    of the per-row little-endian encodings (the whole-batch form behind
    encode_field_rows; the columnar framing passes splice it directly)."""
    if hasattr(value, "to_numpy"):  # engine_cache.DeviceRows
        value = value.to_numpy()
    limbs = [_u64(x) for x in value]
    if len(limbs) == 1:
        lanes = limbs[0]
    else:
        lanes = np.stack(limbs, axis=-1).reshape(limbs[0].shape[0], -1)
    le = np.ascontiguousarray(lanes.astype("<u8"))
    return le.view(np.uint8).reshape(le.shape[0], -1)


def encode_field_rows(tf, value) -> list[bytes]:
    """Device field value [batch, n] -> per-row little-endian encodings."""
    u8 = field_rows_u8(tf, value)
    return [row.tobytes() for row in u8]


def lanes_in_range(lanes: np.ndarray, modulus: int, limbs: int) -> np.ndarray:
    """Element-wise `value < modulus` over little-endian u64 lane arrays
    shaped [..., n*limbs]. Single home for the two-limb lexicographic
    compare so upload validation and driver staging can't diverge."""
    if limbs == 1:
        return lanes < np.uint64(modulus)
    r = lanes.reshape(lanes.shape[:-1] + (-1, 2))
    lo, hi = r[..., 0], r[..., 1]
    p_lo = np.uint64(modulus & 0xFFFFFFFFFFFFFFFF)
    p_hi = np.uint64(modulus >> 64)
    return (hi < p_hi) | ((hi == p_hi) & (lo < p_lo))


def decode_field_rows(tf, rows: list[bytes], n: int):
    """Per-row encodings -> host numpy limb tuple [batch, n] (validated).

    Returns (limb_arrays, ok_mask): rows failing length or range checks
    get a False mask lane and zeroed content (ragged-batch design,
    SURVEY.md section 7).
    """
    batch = len(rows)
    enc_size = 8 * tf.LIMBS
    lanes = np.zeros((batch, n * tf.LIMBS), dtype=np.uint64)
    ok = np.zeros(batch, dtype=bool)
    for i, row in enumerate(rows):
        if row is None or len(row) != n * enc_size:
            continue
        lanes[i] = np.frombuffer(row, dtype="<u8")
        ok[i] = True
    ok &= lanes_in_range(lanes, tf.MODULUS, tf.LIMBS).all(axis=-1)
    if tf.LIMBS == 1:
        limbs = (lanes,)
    else:
        r = lanes.reshape(batch, n, 2)
        limbs = (np.ascontiguousarray(r[:, :, 0]), np.ascontiguousarray(r[:, :, 1]))
    # zero out bad rows so device math stays in range
    for l in limbs:
        l[~ok] = 0
    return limbs, ok


def seeds_to_lanes(rows: list[bytes | None]) -> tuple[np.ndarray, np.ndarray]:
    """16-byte seed rows -> ([batch, 2] u64 lanes, ok mask)."""
    batch = len(rows)
    lanes = np.zeros((batch, 2), dtype=np.uint64)
    ok = np.zeros(batch, dtype=bool)
    for i, row in enumerate(rows):
        if row is not None and len(row) == SEED_SIZE:
            lanes[i] = np.frombuffer(row, dtype="<u8")
            ok[i] = True
    return lanes, ok


def lanes_to_seed_rows(lanes) -> list[bytes]:
    return [row.tobytes() for row in _u64(lanes).astype("<u8")]


# ---------------------------------------------------------------------------
# columnar ping-pong framing (leader hot path)
# ---------------------------------------------------------------------------


class PingPongFrameColumn:
    """A whole batch of uniform-stride ping-pong frames in ONE buffer.

    The leader's init path frames every report's prep share with the
    same tag and the same length prefix (all prep shares of a batch are
    the same size), so the frames can be built in a single vectorized
    pass instead of one Encoder round per report. `row(i)` slices
    report i's frame out of the shared buffer — bit-identical to
    `encode_pingpong(tag, ..., share)` for that row."""

    __slots__ = ("buf", "stride", "n")

    def __init__(self, buf: bytes, stride: int, n: int):
        self.buf = buf
        self.stride = stride
        self.n = n

    def row(self, i: int) -> bytes:
        s = i * self.stride
        return self.buf[s : s + self.stride]

    def rows(self) -> list[bytes]:
        return [self.row(i) for i in range(self.n)]


def encode_pingpong_share_column(tf, ver_value, part_value) -> PingPongFrameColumn:
    """Batched `encode_pingpong(PP_INITIALIZE, None,
    encode_prep_share_raw(ver_row, part_row))`: one numpy pass building
    every report's framed prep share.

    ver_value: device/host field value [batch, verifier_len] (limb
    tuple or DeviceRows); part_value: [batch, 2] u64 joint-rand part
    lanes, or None for circuits without joint randomness."""
    ver_u8 = field_rows_u8(tf, ver_value)
    n = ver_u8.shape[0]
    cols = [ver_u8]
    share_len = ver_u8.shape[1]
    if part_value is not None:
        part_u8 = (
            np.ascontiguousarray(_u64(part_value).astype("<u8"))
            .view(np.uint8)
            .reshape(n, -1)
        )
        cols.append(part_u8)
        share_len += part_u8.shape[1]
    # frame header: u8 tag || u32 big-endian share length — constant
    # across the batch, broadcast into the leading 5 columns
    hdr = np.empty((n, 5), dtype=np.uint8)
    hdr[:] = np.frombuffer(
        bytes([PP_INITIALIZE]) + share_len.to_bytes(4, "big"), dtype=np.uint8
    )
    mat = np.concatenate([hdr] + cols, axis=1)
    return PingPongFrameColumn(mat.tobytes(), 5 + share_len, n)


def pingpong_finish_frame_matches(frame: bytes, want_msg: bytes) -> bool | None:
    """Fast verify of a helper's 1-round answer against the expected
    prep message: True = frame is `finish(want_msg)`, False = a finish
    frame carrying a DIFFERENT message of the right length (VDAF prep
    error), None = not a well-formed finish-of-that-length frame at all
    (invalid message). `frame` must be exactly one self-delimiting
    ping-pong message (the response decoder guarantees this), so the
    check reduces to two bytes compares instead of a Decoder pass."""
    hdr = bytes([PP_FINISH]) + len(want_msg).to_bytes(4, "big")
    if len(frame) != len(hdr) + len(want_msg) or frame[: len(hdr)] != hdr:
        return None
    return frame[len(hdr) :] == want_msg


# ---------------------------------------------------------------------------
# scalar wire codecs (client side / message framing)
# ---------------------------------------------------------------------------


def encode_pingpong(tag: int, prep_msg: bytes | None, prep_share: bytes | None) -> bytes:
    enc = Encoder()
    enc.u8(tag)
    if tag == PP_INITIALIZE:
        enc.opaque_u32(prep_share)
    elif tag == PP_CONTINUE:
        enc.opaque_u32(prep_msg)
        enc.opaque_u32(prep_share)
    elif tag == PP_FINISH:
        enc.opaque_u32(prep_msg)
    else:
        raise ValueError(f"bad ping-pong tag {tag}")
    return enc.bytes()


def decode_pingpong(raw: bytes) -> tuple[int, bytes | None, bytes | None]:
    """-> (tag, prep_msg, prep_share); raises DecodeError."""
    dec = Decoder(raw)
    tag = dec.u8()
    if tag == PP_INITIALIZE:
        out = (tag, None, dec.opaque_u32())
    elif tag == PP_CONTINUE:
        out = (tag, dec.opaque_u32(), dec.opaque_u32())
    elif tag == PP_FINISH:
        out = (tag, dec.opaque_u32(), None)
    else:
        raise DecodeError(f"bad ping-pong tag {tag}")
    dec.finish()
    return out


class Prio3Wire:
    """Per-circuit sizes + scalar encoders (client path uses these)."""

    def __init__(self, circ: Circuit):
        self.circ = circ
        self.enc_size = circ.FIELD.ENCODED_SIZE
        self.uses_jr = circ.joint_rand_len > 0

    # sizes
    @property
    def leader_share_len(self) -> int:
        n = (self.circ.input_len + self.circ.proof_len) * self.enc_size
        return n + (SEED_SIZE if self.uses_jr else 0)

    @property
    def helper_share_len(self) -> int:
        return SEED_SIZE + (SEED_SIZE if self.uses_jr else 0)

    @property
    def public_share_len(self) -> int:
        return 2 * SEED_SIZE if self.uses_jr else 0

    @property
    def prep_share_len(self) -> int:
        return self.circ.verifier_len * self.enc_size + (SEED_SIZE if self.uses_jr else 0)

    @property
    def prep_msg_len(self) -> int:
        return SEED_SIZE if self.uses_jr else 0

    # scalar encoders (ints)
    def encode_leader_share(self, meas: list[int], proof: list[int], blind: bytes | None) -> bytes:
        F = self.circ.FIELD
        out = F.encode_vec(meas) + F.encode_vec(proof)
        if self.uses_jr:
            out += blind
        return out

    def encode_leader_share_raw(self, encoded_meas_proof: bytes, blind: bytes | None) -> bytes:
        """Column path: meas||proof row already encoded (encode_field_rows)."""
        return encoded_meas_proof + (blind if self.uses_jr else b"")

    def validate_leader_share(self, raw: bytes) -> None:
        """Length + field-range validation without scalar decoding.

        The upload handler only needs to know the share is well-formed
        (the stored payload is re-staged columnar by the driver); the
        full scalar decode of a 16k-element share costs ~100ms/report
        in Python and was the measured upload bottleneck. numpy checks
        the same conditions in microseconds."""
        if len(raw) != self.leader_share_len:
            raise DecodeError("bad leader share length")
        n = self.circ.input_len + self.circ.proof_len
        lanes = np.frombuffer(raw[: n * self.enc_size], dtype="<u8")
        limbs = self.enc_size // 8
        if not bool(lanes_in_range(lanes, self.circ.FIELD.MODULUS, limbs).all()):
            raise DecodeError("leader share element out of field range")

    def decode_leader_share(self, raw: bytes) -> tuple[list[int], list[int], bytes | None]:
        F = self.circ.FIELD
        n = self.circ.input_len * self.enc_size
        p = self.circ.proof_len * self.enc_size
        if len(raw) != self.leader_share_len:
            raise DecodeError("bad leader share length")
        meas = F.decode_vec(raw[:n])
        proof = F.decode_vec(raw[n : n + p])
        blind = raw[n + p :] if self.uses_jr else None
        return meas, proof, blind

    def encode_helper_share(self, seed: bytes, blind: bytes | None) -> bytes:
        return seed + (blind if self.uses_jr else b"")

    def decode_helper_share(self, raw: bytes) -> tuple[bytes, bytes | None]:
        if len(raw) != self.helper_share_len:
            raise DecodeError("bad helper share length")
        return raw[:SEED_SIZE], (raw[SEED_SIZE:] if self.uses_jr else None)

    def encode_public_share(self, parts: list[bytes]) -> bytes:
        return b"".join(parts) if self.uses_jr else b""

    def decode_public_share(self, raw: bytes) -> list[bytes]:
        if len(raw) != self.public_share_len:
            raise DecodeError("bad public share length")
        if not self.uses_jr:
            return []
        return [raw[:SEED_SIZE], raw[SEED_SIZE:]]

    def encode_prep_share_raw(self, verifier_bytes: bytes, part: bytes | None) -> bytes:
        """Column path: verifier row already encoded (encode_field_rows)."""
        return verifier_bytes + (part if self.uses_jr else b"")

    def encode_prep_share(self, verifier: list[int], part: bytes | None) -> bytes:
        out = self.circ.FIELD.encode_vec(verifier)
        if self.uses_jr:
            out += part
        return out

    def decode_prep_share(self, raw: bytes) -> tuple[list[int], bytes | None]:
        if len(raw) != self.prep_share_len:
            raise DecodeError("bad prep share length")
        n = self.circ.verifier_len * self.enc_size
        verifier = self.circ.FIELD.decode_vec(raw[:n])
        return verifier, (raw[n:] if self.uses_jr else None)


def split_prep_share_columns(wire: Prio3Wire, tf, rows: list[bytes | None]):
    """Batch of encoded prep shares -> (verifier limbs, part lanes, ok).

    Used by the helper to stage the leader's prep shares
    (PrepareInit.message payloads) into device arrays.
    """
    vlen = wire.circ.verifier_len
    vbytes = vlen * wire.enc_size
    ver_rows: list[bytes | None] = []
    part_rows: list[bytes | None] = []
    for row in rows:
        if row is None or len(row) != wire.prep_share_len:
            ver_rows.append(None)
            part_rows.append(None)
            continue
        ver_rows.append(row[:vbytes])
        part_rows.append(row[vbytes:] if wire.uses_jr else b"\x00" * SEED_SIZE)
    limbs, ok = decode_field_rows(tf, ver_rows, vlen)
    if wire.uses_jr:
        part_lanes, ok2 = seeds_to_lanes(part_rows)
        ok = ok & ok2
    else:
        part_lanes = np.zeros((len(rows), 2), dtype=np.uint64)
    return limbs, part_lanes, ok
