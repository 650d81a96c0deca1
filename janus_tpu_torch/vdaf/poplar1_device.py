"""Batched Poplar1 prepare on the device: the IDPF walk and the sketch.

The port's counterpart of janus_tpu/vdaf/poplar1_jax.py. The host walk
(vdaf/poplar1.py `Idpf._eval_one`) steps the IDPF tree per report, per
prefix, per level. The walk is level-synchronous: every (report, prefix)
pair performs the same `extend` and `convert` XOF step at each level,
and every such XOF call is one single-block counter-mode SHAKE128
message. So this module flattens [reports x prefixes] into one batch
axis of N = n * P columns and runs the level loop as batched
permutations through vdaf/keccak.py `ctr_stream_lanes`: on a CUDA
tensor each is one launch of kernel 1 (ops/keccak_cuda.py
`keccak_ctr_blocks`, which reads the seeds in place and writes only the
lanes read: 5 for `extend`, 2 for `convert`, LIMBS + 1 for the value),
on a CPU tensor its plain version. A walk to
level L launches it 2(L+1)+1 times: `extend` and `convert` per level,
and the value sample at the last one. The per-prefix left/right choice
is an elementwise `where` on the prefix bit, the correction words
broadcast per report, and the sketch (z = sum r_p y_p, w = sum r_p^2
y_p) is a field dot product over the prefix axis (fields/tfield.py).

Bit-identical to the host walk and to janus_tpu's device walk: the same
XofCtr128 framing (dst16 || seed || le64(counter)), the same
oversample-and-reduce sampling, the same correction and negation order.

Lanes are int64 tensors holding u64 bit patterns. A prefix of a 64-bit
tree reaches the sign bit, so prefixes, seeds and correction words enter
as their int64 reinterpretation (fields/tfield.py `i64`); the only
shifts here are followed by `& 1`, which is exact on int64.

The host side of a call stays on the host, as in janus_tpu: the keys'
lanes, the verify randomness (`verify_rand`, a host XOF expansion of P
elements a report), the helper's `corr_from_seed`, and the int
conversions. `prepare_init_batched` can time the host part and the
device part apart (`seconds=`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..fields.tfield import TF64, TF128, fdot, fmap, fwhere, i64
from .keccak import ctr_stream_lanes, sample_field_vec
from .poplar1 import ALGO_ID, USAGE_CONVERT, USAGE_CONVERT_VALUE, USAGE_EXTEND, corr_from_seed, verify_rand
from .xof import DST_SIZE, SEED_SIZE, dst

_DST_EXTEND = dst(ALGO_ID, USAGE_EXTEND)
_DST_CONVERT = dst(ALGO_ID, USAGE_CONVERT)
_DST_CONVERT_VALUE = dst(ALGO_ID, USAGE_CONVERT_VALUE)
_PREFIX_LEN = DST_SIZE + SEED_SIZE  # dst || seed


def _tf_at(bits: int, level: int):
    return TF128 if level == bits - 1 else TF64


def _stream(dst_: bytes, seed_lanes, out_lanes: int):
    """The first out_lanes lanes of one counter-mode block of dst || seed
    per row: [N, out_lanes]."""
    n = seed_lanes.shape[0]
    return ctr_stream_lanes(
        [(0, dst_), (2, seed_lanes)], _PREFIX_LEN, n, 1, seed_lanes.device, out_lanes=out_lanes
    )[:, 0, :]


def _extend_lanes(seed_lanes):
    """Batched Idpf `_extend`: [N, 2] seeds -> (sl [N, 2], tl [N], sr, tr)."""
    stream = _stream(_DST_EXTEND, seed_lanes, 5)
    sl = stream[:, 0:2]
    sr = stream[:, 2:4]
    tl = stream[:, 4] & 1
    tr = (stream[:, 4] >> 8) & 1
    return sl, tl, sr, tr


def _convert_lanes(tf, seed_lanes, sample: bool):
    """Batched Idpf `_convert`: -> (next seed [N, 2], the value's first
    element [N] or None)."""
    nxt = _stream(_DST_CONVERT, seed_lanes, 2)
    y = None
    if sample:
        # the first element takes LIMBS + 1 lanes of its block
        stream = _stream(_DST_CONVERT_VALUE, seed_lanes, tf.LIMBS + 1)
        y = fmap(lambda v: v[:, 0], sample_field_vec(tf, stream[:, None, :], 1))
    return nxt, y


def _eval(tf, level: int, party: int, root, cw_seed, cw_tl, cw_tr, vcw0, prefixes, r, a_sh, b_sh):
    """The [n, P]-batched IDPF eval and sketch, on the device of `root`.

    root [n, 2]; cw_seed [n, L, 2]; cw_tl/cw_tr [n, L]; vcw0 field [n];
    prefixes [P]; r field [n, P]; a_sh/b_sh field [n]. Returns the value
    shares y [n, P] and the round-1 sketch shares A, B [n]."""
    n = root.shape[0]
    P = prefixes.shape[0]
    N = n * P
    seeds = root[:, None, :].expand(n, P, 2).reshape(N, 2)
    ctrl = torch.full((N,), party, dtype=torch.int64, device=root.device)
    for lvl in range(level + 1):
        sl, tl, sr, tr = _extend_lanes(seeds)
        cw_s = cw_seed[:, lvl, None, :].expand(n, P, 2).reshape(N, 2)
        ctl = cw_tl[:, lvl, None].expand(n, P).reshape(N)
        ctr_ = cw_tr[:, lvl, None].expand(n, P).reshape(N)
        mask = (0 - ctrl)[:, None]  # all ones where the control bit is set
        sl = sl ^ (cw_s & mask)
        sr = sr ^ (cw_s & mask)
        tl = tl ^ (ctl & ctrl)
        tr = tr ^ (ctr_ & ctrl)
        bit = (prefixes >> (level - lvl)) & 1  # [P]
        sel = bit[None, :].expand(n, P).reshape(N).bool()
        seeds = torch.where(sel[:, None], sr, sl)
        ctrl = torch.where(sel, tr, tl)
        seeds, y = _convert_lanes(tf, seeds, sample=(lvl == level))
    # value correction on the on-path control bit, then the party's sign
    vcw = fmap(lambda v: v[:, None].expand(n, P).reshape(N), vcw0)
    y = fwhere(ctrl.bool(), tf.add(y, vcw), y)
    if party == 1:
        y = tf.neg(y)
    y = fmap(lambda v: v.reshape(n, P), y)
    # sketch shares: A = a + sum r_p y_p, B = b + sum r_p^2 y_p
    z = fdot(tf, r, y, axis=-1)
    w = fdot(tf, tf.mul(r, r), y, axis=-1)
    return y, tf.add(z, a_sh), tf.add(w, b_sh)


def _seed_lanes(seeds: list[bytes], shape) -> np.ndarray:
    """16-byte seeds -> their two little-endian u64 lanes each, as int64."""
    return np.frombuffer(b"".join(seeds), dtype="<u8").view(np.int64).reshape(shape).copy()


def prepare_init_batched(bits: int, party: int, keys, param, verify_key: bytes, nonces, device=None,
                         seconds: dict | None = None):
    """Device twin of `Poplar1.prepare_init` over a report batch, on
    `device` (CUDA unless the caller passes "cpu").

    keys: IdpfKeys (with .corr populated); nonces: bytes. Returns
    (y [n][P], A [n], B [n], a_shares [n], c_shares [n]) as host ints,
    equal to the host walk's. `seconds`, when given, receives the host
    part (keys_to_lanes, verify_rand, corr, to_device, to_host) and the
    device part (device, up to torch.cuda.synchronize()) of the call."""
    if not 1 <= bits <= 64:
        raise ValueError(f"poplar1 device prepare holds prefixes in 64-bit lanes; bits={bits}")
    dev = resolve_device(device)
    laps = {}
    t = time.perf_counter()

    def lap(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        laps[name] = now - t
        t = now

    n = len(keys)
    level = param.level
    P = len(param.prefixes)
    L = level + 1
    tf = _tf_at(bits, level)

    root = _seed_lanes([k.root_seed for k in keys], (n, 2))
    cw_seed = _seed_lanes([k.correction_words[lvl][0] for k in keys for lvl in range(L)], (n, L, 2))
    cw_tl = np.array([[k.correction_words[lvl][1] for lvl in range(L)] for k in keys], dtype=np.int64).reshape(n, L)
    cw_tr = np.array([[k.correction_words[lvl][2] for lvl in range(L)] for k in keys], dtype=np.int64).reshape(n, L)
    vcw0 = [int(k.correction_words[level][3][0]) for k in keys]
    prefixes = np.array([i64(p) for p in param.prefixes], dtype=np.int64)
    lap("keys_to_lanes")
    r_rows = [verify_rand(bits, verify_key, nonce, param) for nonce in nonces]
    lap("verify_rand")
    corr = [k.corr[level] if party == 0 else corr_from_seed(bits, k.corr, level) for k in keys]
    a_sh = [c[0] for c in corr]
    b_sh = [c[1] for c in corr]
    c_sh = [c[2] for c in corr]
    lap("corr")

    def put(a):
        return torch.from_numpy(a).to(dev)

    args = (
        put(root), put(cw_seed), put(cw_tl), put(cw_tr),
        tf.from_ints(np.array(vcw0, dtype=object), dev),
        put(prefixes),
        tf.from_ints(np.array(r_rows, dtype=object).reshape(n, P), dev),
        tf.from_ints(np.array(a_sh, dtype=object), dev),
        tf.from_ints(np.array(b_sh, dtype=object), dev),
    )
    lap("to_device")
    y, A, B = _eval(tf, level, party, *args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # the fetch below waits for the card anyway
    lap("device")
    y_ints = tf.to_ints(y)
    out = (
        [[int(v) for v in row] for row in y_ints],
        [int(x) for x in tf.to_ints(A)],
        [int(x) for x in tf.to_ints(B)],
        a_sh,
        c_sh,
    )
    lap("to_host")
    if seconds is not None:
        seconds.update(laps)
    return out
