"""janus_tpu_torch's client and host sharder held against janus_tpu's.

- The port's host `Prio3.shard` (vdaf/reference.py) returns janus_tpu's
  `prio3_host(...).shard(m, nonce, rand)` bit for bit: public share,
  leader measurement and proof shares, helper seed and blinds, for Count,
  Sum, a narrow SumVec and Histogram in both XOF modes.
- Its shares pass the port's `two_party_step` on the CPU: a batch of
  host-sharded reports, a corrupted one among them, aggregates to the sum
  of the others.
- `Client.prepare_report` agrees with janus_tpu's on the same report id
  and randomness (both clients draw from one seeded stream): the same
  report id, time and public share, and leader and helper ciphertexts
  that open to the same plaintexts (HPKE seals are randomized, so the
  ciphertexts are compared after opening).
- The batched client `make_wire_reports` agrees with janus_tpu's on one
  seed, after opening, for Count, a narrow SumVec and draft Count.

The port runs with device="cpu"; tolerance: exact equality.
"""

import secrets

import numpy as np
import pytest

from janus_tpu import messages as jm
from janus_tpu.core import hpke as j_hpke
from janus_tpu.vdaf import registry as j_registry
from janus_tpu.vdaf import testing as j_testing
from janus_tpu_torch import messages as tm
from janus_tpu_torch.convert import step_args_from_jax
from janus_tpu_torch.parallel import api
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf import testing as t_testing
from janus_tpu_torch.vdaf.engine import tf_for
from janus_tpu_torch.vdaf.wire import decode_field_rows, seeds_to_lanes
from test_torch_upload import CIRCUITS, MEASUREMENTS, NOW, j_client, leader_task, seed_clients, t_client

SHARD_CIRCUITS = {
    "count": {"kind": "count"},
    "sum": {"kind": "sum", "bits": 5},
    "sumvec": {"kind": "sumvec", "length": 3, "bits": 2},
    "histogram": {"kind": "histogram", "length": 4},
}
MODES = ["fast", "draft"]


def _measurement(kind: str, rng):
    if kind == "count":
        return int(rng.integers(0, 2))
    if kind == "sum":
        return int(rng.integers(0, 32))
    if kind == "sumvec":
        return [int(x) for x in rng.integers(0, 4, size=3)]
    return int(rng.integers(0, 4))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(SHARD_CIRCUITS))
def test_host_shard_is_bit_identical_to_janus_tpu(name, mode):
    kw = {**SHARD_CIRCUITS[name], "xof_mode": mode}
    j_p3 = j_registry.prio3_host(j_registry.VdafInstance(**kw))
    t_p3 = t_registry.prio3_host(t_registry.VdafInstance(**kw))
    assert t_p3.rand_size == j_p3.rand_size
    rng = np.random.default_rng(5)
    for _ in range(3):
        m = _measurement(SHARD_CIRCUITS[name]["kind"], rng)
        nonce, rand = rng.bytes(16), rng.bytes(j_p3.rand_size)
        j_public, j_shares = j_p3.shard(m, nonce, rand)
        t_public, t_shares = t_p3.shard(m, nonce, rand)
        assert t_public == j_public
        assert [vars(s) for s in t_shares] == [vars(s) for s in j_shares]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["count", "sumvec"])
def test_host_shares_pass_the_port_two_party_step(name, mode):
    inst = t_registry.VdafInstance(**SHARD_CIRCUITS[name], xof_mode=mode)
    p3 = t_registry.prio3_host(inst)
    circ = p3.circuit
    tf = tf_for(t_registry.circuit_for(inst))
    rng = np.random.default_rng(9)
    meas = [_measurement(name, rng) for _ in range(5)]
    nonces = [secrets.token_bytes(16) for _ in meas]
    shards = [p3.shard(m, n) for m, n in zip(meas, nonces)]
    leaders = [s[1][0] for s in shards]
    helpers = [s[1][1] for s in shards]
    F = circ.FIELD
    leaders[2].measurement_share[0] = F.add(leaders[2].measurement_share[0], 1)  # corrupt report 2
    nonce_lanes, _ = seeds_to_lanes(nonces)
    meas_np, _ = decode_field_rows(tf, [F.encode_vec(s.measurement_share) for s in leaders], circ.input_len)
    proof_np, _ = decode_field_rows(tf, [F.encode_vec(s.proof_share) for s in leaders], circ.proof_len)
    seed_lanes, _ = seeds_to_lanes([s.seed for s in helpers])
    if p3.uses_joint_rand:
        public = np.stack([seeds_to_lanes([s[0][j] for s in shards])[0] for j in (0, 1)], axis=1)
        blind0 = seeds_to_lanes([s.joint_rand_blind for s in leaders])[0]
        blind1 = seeds_to_lanes([s.joint_rand_blind for s in helpers])[0]
    else:
        public = blind0 = blind1 = None
    args = step_args_from_jax((nonce_lanes, public, meas_np, proof_np, blind0, seed_lanes, blind1), "cpu")
    agg0, agg1, count = api.two_party_step(inst, bytes(16), device="cpu")(*args)
    bp3 = t_registry.prio3_batched(inst, "cpu")
    total = [int(x) for x in bp3.tf.to_ints(bp3.merge_agg_shares(agg0, agg1))]
    keep = [m for i, m in enumerate(meas) if i != 2]
    assert int(count) == 4
    assert total == [int(x) for x in np.asarray(keep).sum(axis=0).reshape(-1)]


def _opened(task, report, helper_kp):
    """(report id, time, public share, leader plaintext, helper plaintext)
    of a report of either package, opened with janus_tpu's HPKE."""
    r = jm.Report.from_bytes(report.to_bytes())
    aad = jm.InputShareAad(task.task_id, r.metadata, r.public_share).to_bytes()
    info = lambda role: j_hpke.HpkeApplicationInfo(j_hpke.Label.INPUT_SHARE, jm.Role.CLIENT, role)  # noqa: E731
    return (
        r.metadata.report_id.data,
        r.metadata.time.seconds,
        r.public_share,
        j_hpke.hpke_open(task.hpke_keys[0], info(jm.Role.LEADER), r.leader_encrypted_input_share, aad),
        j_hpke.hpke_open(helper_kp, info(jm.Role.HELPER), r.helper_encrypted_input_share, aad),
    )


@pytest.mark.parametrize("name", ["count", "sumvec", "histogram", "draft-count"])
def test_prepare_report_agrees_with_janus_tpu_after_opening(monkeypatch, name):
    task, helper_kp = leader_task(name)
    seed_clients(monkeypatch, 21)
    j_c, t_c = j_client(task, helper_kp), t_client(task, helper_kp)
    for m in MEASUREMENTS[name]:
        when = jm.Time(NOW - 1234)
        want = _opened(task, j_c.prepare_report(m, when=when), helper_kp)
        got = _opened(task, t_c.prepare_report(m, when=tm.Time(when.seconds)), helper_kp)
        assert got == want
        assert got[1] == (NOW - 1234) // 3600 * 3600


@pytest.mark.parametrize("name", ["count", "sumvec", "draft-count"])
def test_wire_reports_match_janus_tpu_after_opening(name):
    """The batched client: the port's make_wire_reports (device shard on
    the CPU, then sealed and framed) and janus_tpu's, on one seed and the
    same measurements, give the same report ids, times and public shares,
    and leader and helper ciphertexts that open to the same plaintexts."""
    task, helper_kp = leader_task(name)
    kw = CIRCUITS[name]
    meas = t_testing.random_measurements(t_registry.VdafInstance(**kw), 4, np.random.default_rng(13))
    when = NOW - 1800
    want = j_testing.make_wire_reports(j_registry.VdafInstance(**kw), meas, task.task_id, task.hpke_keys[0].config,
                                       helper_kp.config, jm.Time(when), seed=13)
    got = t_testing.make_wire_reports(
        t_registry.VdafInstance(**kw), meas, tm.TaskId(task.task_id.data),
        tm.HpkeConfig.from_bytes(task.hpke_keys[0].config.to_bytes()),
        tm.HpkeConfig.from_bytes(helper_kp.config.to_bytes()), tm.Time(when), seed=13, shard_chunk=3, device="cpu",
    )
    assert len(got) == len(want) == 4
    assert [_opened(task, r, helper_kp) for r in got] == [_opened(task, r, helper_kp) for r in want]
