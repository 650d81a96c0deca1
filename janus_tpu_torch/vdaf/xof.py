"""XOF framing of the fast mode: counter-mode SHAKE128 (host oracle).

The framing the device path reproduces byte for byte:

1. Counter-mode output:

       block_i = SHAKE128(dst16 || seed || binder' || le64(i))[:168]
       stream  = block_0 || block_1 || ...

   Every block depends only on (seed, binder, i), so the whole stream of
   every report in a batch is one batched single-block permutation.

2. Tree-digested long binders: binders longer than 112 bytes are
   replaced by a 16-byte Merkle digest with 112-byte leaves and arity-7
   internal nodes; every node hash is a single-block SHAKE128 message,
   so each tree level is one batched permutation.

All binder layouts Prio3 uses are multiples of 8 bytes, so every field
of every message is u64-lane-aligned.

Field elements are sampled by oversample-and-reduce: element i consumes
(LIMBS+1) little-endian 8-byte lanes, read as an integer and reduced
mod p (bias <= 2^-64 per element).
"""

from __future__ import annotations

import hashlib

import numpy as np

SEED_SIZE = 16

# Domain-separation usage tags (one byte each), following the Prio3
# usage enumeration.
USAGE_MEASUREMENT_SHARE = 2
USAGE_PROOF_SHARE = 3
USAGE_JOINT_RANDOMNESS = 4
USAGE_PROVE_RANDOMNESS = 5
USAGE_QUERY_RANDOMNESS = 6
USAGE_JOINT_RAND_SEED = 7
USAGE_JOINT_RAND_PART = 8

ALGO_CLASS_VDAF = 0
DST_SIZE = 16

RATE = 168  # SHAKE128 rate in bytes

# Binders longer than this are replaced by tree_digest(binder).
INLINE_BINDER_MAX = 112
# Tree hash geometry: 112-byte leaves, arity-7 internal nodes
# (7 x 16-byte digests = 112 bytes), every node message single-block.
TREE_CHUNK = 112
TREE_ARITY = 7
TREE_DIGEST_SIZE = 16
TREE_MAGIC = b"JanusTr1"


def dst(algo_id: int, usage: int, version: int = 7) -> bytes:
    """Domain-separation tag: class || version || algo id || usage,
    zero-padded to DST_SIZE so it occupies exactly two u64 lanes."""
    raw = (
        bytes([ALGO_CLASS_VDAF, version])
        + algo_id.to_bytes(4, "big")
        + usage.to_bytes(2, "big")
    )
    return raw.ljust(DST_SIZE, b"\x00")


def _le64(i: int) -> bytes:
    return i.to_bytes(8, "little")


def tree_digest(data: bytes) -> bytes:
    """16-byte Merkle digest of lane-aligned data.

    Leaf k's payload is planar: u64 lane j*n+k for j in 0..13 (n = leaf
    count), a fixed bijection of the data, so that on the device every
    leaf lane column is one contiguous slice.
    """
    assert len(data) % 8 == 0
    total = _le64(len(data))

    def node(level: int, index: int, payload: bytes) -> bytes:
        assert len(payload) == TREE_CHUNK
        msg = TREE_MAGIC + _le64(level) + _le64(index) + total + payload
        return hashlib.shake_128(msg).digest(TREE_DIGEST_SIZE)

    lanes = np.frombuffer(data, dtype="<u8")
    n = max(1, -(-lanes.size // (TREE_CHUNK // 8)))
    planes = np.zeros((TREE_CHUNK // 8, n), dtype=np.uint64)
    planes.reshape(-1)[: lanes.size] = lanes
    digs = [node(0, k, planes[:, k].tobytes()) for k in range(n)]
    level = 0
    while len(digs) > 1:
        level += 1
        pad = -len(digs) % TREE_ARITY
        digs.extend([b"\x00" * TREE_DIGEST_SIZE] * pad)
        digs = [
            node(level, g, b"".join(digs[g * TREE_ARITY : (g + 1) * TREE_ARITY]))
            for g in range(len(digs) // TREE_ARITY)
        ]
    return digs[0]


class XofCtr128:
    """Counter-mode SHAKE128 XOF over hashlib (the oracle for the device Keccak)."""

    SEED_SIZE = SEED_SIZE

    def __init__(self, seed: bytes, dst_: bytes, binder: bytes = b""):
        assert len(seed) == SEED_SIZE
        assert len(dst_) <= DST_SIZE
        if len(binder) > INLINE_BINDER_MAX:
            # The digest's collision bound is argued only for the
            # joint-rand-part usage; raise (not assert) so the boundary
            # survives python -O.
            usage = int.from_bytes(dst_[6:8], "big")
            if usage != USAGE_JOINT_RAND_PART:
                raise ValueError(
                    f"tree-digest substitution restricted to joint-rand-part; got usage {usage}"
                )
            binder = tree_digest(binder)
        self._prefix = dst_.ljust(DST_SIZE, b"\x00") + seed + binder
        assert len(self._prefix) + 8 <= RATE - 1  # always one absorb block
        self._block = 0
        self._buf = b""

    def next(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._buf += hashlib.shake_128(self._prefix + _le64(self._block)).digest(RATE)
            self._block += 1
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def next_vec(self, field, length: int) -> list[int]:
        """Sample `length` field elements by oversample-and-reduce:
        ENCODED_SIZE + 8 stream bytes per element, little-endian, mod p."""
        size = field.ENCODED_SIZE + 8
        p = field.MODULUS
        return [int.from_bytes(self.next(size), "little") % p for _ in range(length)]
