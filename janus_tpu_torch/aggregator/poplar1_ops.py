"""Poplar1 protocol ops for the DAP aggregator.

The port's own copy of janus_tpu/aggregator/poplar1_ops.py: the
aggregation parameter's checks, upload validation, the batched round 1
of the leader and the helper, round 2 and the codecs.

Protocol mapping onto DAP ping-pong (2 rounds, the shape the continue
machinery serves for the two-round fake). es = the level field's encoded
size; the sketch algebra is vdaf/poplar1.py's:

  - leader init: IDPF-evaluates its key at the parameter's prefixes and
    computes its round-1 sketch share [A0, B0];
    PrepareInit.message = PP_INITIALIZE(prep_share = enc(A0)||enc(B0)).
  - helper init: evaluates -> y1 + [A1, B1]; combines A = A0+A1,
    B = B0+B1 and computes its round-2 share sigma1. Parks
    WAITING_HELPER with prep_blob =
    enc(A)||enc(B) || enc(A1)||enc(B1)||enc(sigma1) || enc(y1) and
    answers PP_CONTINUE(prep_msg = enc(A)||enc(B),
    prep_share = enc(A1)||enc(B1)||enc(sigma1)).
  - leader continue: recomputes (A, B) from its own [A0, B0] and the
    helper's [A1, B1], checks them against the helper's prep_msg,
    computes sigma0, checks sigma0 + sigma1 == 0, parks WAITING_LEADER,
    then sends PP_FINISH(enc(sigma0)); the helper's ord-matched continue
    recomputes sigma from its stored sigma1 and accumulates y1 iff
    sigma == 0.

Round 1 of every non-empty batch runs on the ops' device: one batched
[reports x prefixes] IDPF walk and sketch (vdaf/poplar1_device.py,
kernel 1 on CUDA). There is no host route: janus_tpu's environment
switch and its small-batch host walk are left out, and the two give
bit-identical values. Round 2 and the codecs run on the host, as in
janus_tpu.
"""

from __future__ import annotations

from ..vdaf.poplar1 import (
    SEED_SIZE,
    Idpf,
    Poplar1,
    Poplar1AggParam,
    _PrepState,
    decode_input_share,
    decode_public_share,
)
from ..vdaf.poplar1_device import prepare_init_batched


class Poplar1Ops:
    def __init__(self, bits: int, verify_key: bytes = b"\x00" * SEED_SIZE, device=None):
        assert bits > 0, "poplar1 task missing bit length"
        self.bits = bits
        self.idpf = Idpf(bits)
        self.poplar = Poplar1(bits)
        self.verify_key = verify_key
        # round 1's device: CUDA unless the caller asks for the CPU (the
        # codecs and round 2 need none, so it is resolved at round 1)
        self.device = device

    # --- aggregation parameter ---
    def decode_param(self, raw: bytes) -> Poplar1AggParam:
        param = Poplar1AggParam.decode(raw)
        if not (0 <= param.level < self.bits):
            raise ValueError(f"poplar1 level {param.level} out of range")
        if not param.prefixes:
            raise ValueError("poplar1 aggregation parameter has no prefixes")
        limit = 1 << (param.level + 1)
        if any(not (0 <= p < limit) for p in param.prefixes):
            raise ValueError("poplar1 prefix out of range for level")
        if list(param.prefixes) != sorted(set(param.prefixes)):
            raise ValueError("poplar1 prefixes must be sorted and distinct")
        return param

    def field_for(self, param: Poplar1AggParam):
        return self.idpf.field_at(param.level)

    def enc_size(self, param: Poplar1AggParam) -> int:
        return self.field_for(param).ENCODED_SIZE

    # --- share handling ---
    def validate_shares(self, public_share: bytes, input_share_payload: bytes, party: int) -> None:
        cws = decode_public_share(self.bits, public_share)
        decode_input_share(self.bits, cws, input_share_payload, party)

    def _key(self, party: int, public_share: bytes, payload: bytes):
        cws = decode_public_share(self.bits, public_share)
        return decode_input_share(self.bits, cws, payload, party)

    def round1_batch(self, party: int, items, param):
        """Batched round 1 over [(public_share, payload, nonce)].

        Returns a list of (state, y_shares, msg1) | ValueError per item.
        Decode failures stay per report; the others evaluate in one
        [reports x prefixes] walk on the ops' device."""
        results: list = [None] * len(items)
        keys = []
        idx = []
        nonces = []
        for i, (ps, payload, nonce) in enumerate(items):
            try:
                keys.append(self._key(party, ps, payload))
                idx.append(i)
                nonces.append(nonce)
            except ValueError as e:
                results[i] = e
        if not keys:
            return results
        F = self.field_for(param)
        y, A, B, a_sh, c_sh = prepare_init_batched(self.bits, party, keys, param, self.verify_key, nonces, self.device)
        for k, i in enumerate(idx):
            state = _PrepState(F, y[k], party, a_sh[k], c_sh[k])
            results[i] = (state, y[k], [A[k], B[k]])
        return results

    def round2(self, state, msg1_leader, msg1_helper):
        """-> (sigma_share, combined [A, B])."""
        F = state.field
        state, msg2 = self.poplar.prepare_next(state, [msg1_leader, msg1_helper])
        A = F.add(msg1_leader[0], msg1_helper[0])
        B = F.add(msg1_leader[1], msg1_helper[1])
        return msg2[0], [A, B]

    # --- codecs ---
    def encode_elem(self, param: Poplar1AggParam, x: int) -> bytes:
        return int(x).to_bytes(self.enc_size(param), "little")

    def decode_elem(self, param: Poplar1AggParam, raw: bytes) -> int:
        F = self.field_for(param)
        if len(raw) != F.ENCODED_SIZE:
            raise ValueError("poplar1 element length mismatch")
        x = int.from_bytes(raw, "little")
        if x >= F.MODULUS:
            raise ValueError("poplar1 element out of range")
        return x

    def encode_vec(self, param: Poplar1AggParam, xs: list[int]) -> bytes:
        return b"".join(self.encode_elem(param, x) for x in xs)

    def decode_vec(self, param: Poplar1AggParam, raw: bytes) -> list[int]:
        return self.decode_fixed_vec(param, raw, len(param.prefixes))

    def decode_fixed_vec(self, param: Poplar1AggParam, raw: bytes, n: int) -> list[int]:
        es = self.enc_size(param)
        if len(raw) != es * n:
            raise ValueError("poplar1 vector length mismatch")
        return [self.decode_elem(param, raw[i : i + es]) for i in range(0, len(raw), es)]
