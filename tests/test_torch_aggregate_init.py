"""janus_tpu_torch's helper answering aggregate-init, held against janus_tpu's.

Both helpers are provisioned from one janus_tpu task (the port reads its
`to_dict`), each over its own SQLite datastore, with clocks at the same
time; the port's runs with device="cpu". The same request bytes go to
both, and the encoded AggregationJobResp must be byte-identical, as must
the rows they write: batch aggregations (share bytes, report count,
interval, checksum), report aggregations and the aggregation job.
Tolerance: exact equality.

For Count, a small SumVec (joint randomness) and draft Count, one job
carries every error lane (unknown HPKE config id, a bad ciphertext, a
report after the task's expiration, a corrupted leader prep share) and
spans two time windows (two masked aggregates over the same resident
rows); the whole request is then replayed, and a second job replays one
report id. The requests are built by the port's leader side; one more
is built by janus_tpu's own report and leader-init code (the mixed
pairing). In every case the leader's aggregate over its out shares plus
the helper's stored share unshard to the honest reports' sum.
"""

import dataclasses

import numpy as np
import pytest
import torch

from janus_tpu.aggregator import core as j_core
from janus_tpu.core import hpke as j_hpke
from janus_tpu.core import time_util as j_time
from janus_tpu.datastore import store as j_store
from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.vdaf import registry as j_registry
from janus_tpu.vdaf import testing as j_testing
from janus_tpu.vdaf import wire as j_wire
from janus_tpu_torch import messages as tm
from janus_tpu_torch.aggregator import core as t_core
from janus_tpu_torch.aggregator import errors as t_errors
from janus_tpu_torch.aggregator.testing import leader_init_request, outcomes
from janus_tpu_torch.convert import step_args_to_numpy
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import EphemeralDatastore
from janus_tpu_torch.task import Task
from janus_tpu_torch.vdaf import registry as t_registry
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements
from test_torch_engine_cache import jax_single_device

CPU = torch.device("cpu")
NOW = 1_700_000_000  # 800 s into a 3600 s window
WINDOW_A = NOW - 100
WINDOW_B = NOW - 2000  # the window before
CIRCUITS = {
    "count": {"kind": "count"},
    "sumvec": {"kind": "sumvec", "length": 3, "bits": 2},
    "draft-count": {"kind": "count", "xof_mode": "draft"},
}
N = 8
UNKNOWN_CONFIG, BAD_CIPHERTEXT, EXPIRED, CORRUPT = 1, 2, 3, 5
P = jm.PrepareError


class Pair:
    """A janus_tpu helper and a port helper provisioned from one task."""

    def __init__(self, name: str, fixed_size: bool = False):
        kw = dict(CIRCUITS[name])
        self.t_inst = t_registry.VdafInstance(**kw)
        self.j_inst = j_registry.VdafInstance(**kw)
        qt = j_task.QueryTypeConfig.fixed_size(max_batch_size=100) if fixed_size else j_task.QueryTypeConfig.time_interval()
        self.j_task = (
            j_task.TaskBuilder(qt, self.j_inst, jm.Role.HELPER)
            .with_(vdaf_verify_key=bytes(range(16)), task_expiration=jm.Time(NOW))
            .build()
        )
        self.t_task = Task.from_dict(self.j_task.to_dict())
        self.j_ds = j_store.EphemeralDatastore(j_time.MockClock(jm.Time(NOW)))
        self.t_ds = EphemeralDatastore(MockClock(tm.Time(NOW)))
        self.j_ds.datastore.run_tx(lambda tx: tx.put_task(self.j_task))
        self.t_ds.datastore.run_tx(lambda tx: tx.put_task(self.t_task))
        with jax_single_device():
            self.j_helper = j_core.TaskAggregator(self.j_task, j_core.Config())
        assert self.j_helper.engine.mesh is None
        self.t_helper = t_core.Aggregator(self.t_ds.datastore, self.t_ds.clock, device=CPU)
        self.t_engine = self.t_helper.task_aggregator_for(self.t_task.task_id).engine

    def close(self):
        self.j_ds.cleanup()
        self.t_ds.cleanup()

    def answer(self, job_id: bytes, body: bytes):
        """Both helpers' encoded responses to one request."""
        j_resp = self.j_helper.handle_aggregate_init(
            self.j_ds.datastore,
            self.j_ds.clock,
            jm.AggregationJobId(job_id),
            jm.AggregationJobInitializeReq.from_bytes(body),
            body,
        )
        t_resp = self.t_helper.handle_aggregate_init(self.t_task.task_id, tm.AggregationJobId(job_id), body)
        return j_resp.to_bytes(), t_resp

    def rows(self, job_id: bytes):
        """Every row both helpers wrote for the task and the job."""

        def read(ds, m, job):
            def fn(tx):
                tid = m.TaskId(self.j_task.task_id.data)
                ba = tx._c.execute(
                    "SELECT batch_identifier, aggregation_parameter, ord, state, aggregate_share, report_count,"
                    " client_interval_start, client_interval_duration, checksum FROM batch_aggregations"
                    " WHERE task_id = ? ORDER BY batch_identifier, ord",
                    (tid.data,),
                ).fetchall()
                ras = [
                    (r.report_id.data, r.client_time.seconds, r.ord, r.state.value, r.prep_blob,
                     None if r.prepare_error is None else int(r.prepare_error))
                    for r in tx.get_report_aggregations_for_job(tid, job)
                ]
                j = tx.get_aggregation_job(tid, job)
                agg_job = (j.aggregation_parameter, j.partial_batch_identifier, j.client_timestamp_interval.to_bytes(),
                           j.state.value, j.step, j.last_request_hash)
                return ba, ras, agg_job

            return ds.datastore.run_tx(fn)

        return read(self.j_ds, jm, jm.AggregationJobId(job_id)), read(self.t_ds, tm, tm.AggregationJobId(job_id))

    def helper_shares(self):
        """{batch identifier: (share ints, report count)} of the port helper."""
        field = t_registry.circuit_for(self.t_inst).FIELD
        rows = self.rows(bytes(16))[1][0]
        return {r[0]: (field.decode_vec(r[4]), r[5]) for r in rows}


@pytest.fixture(scope="module", params=list(CIRCUITS))
def pair(request):
    p = Pair(request.param)
    yield p
    p.close()


def _bump(field_np, row: int, modulus: int):
    v = (sum(int(x[row, 0]) << (64 * i) for i, x in enumerate(field_np)) + 1) % modulus
    out = tuple(x.copy() for x in field_np)
    for i, y in enumerate(out):
        y[row, 0] = np.uint64((v >> (64 * i)) & ((1 << 64) - 1))
    return out


def _cat_rows(a, b):
    """Row 0 of a, then the rows of b (None and limb tuples kept)."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(np.concatenate([x[:1], y]) for x, y in zip(a, b))
    return np.concatenate([a[:1], b])


def _spoil_ciphertext(body: bytes, i: int) -> bytes:
    """The request with report i's HPKE payload altered in its last byte."""
    req = tm.AggregationJobInitializeReq.from_bytes(body)
    inits = list(req.prepare_inits)
    rs = inits[i].report_share
    ct = rs.encrypted_input_share
    bad = dataclasses.replace(ct, payload=ct.payload[:-1] + bytes([ct.payload[-1] ^ 1]))
    inits[i] = dataclasses.replace(inits[i], report_share=dataclasses.replace(rs, encrypted_input_share=bad))
    return dataclasses.replace(req, prepare_inits=tuple(inits)).to_bytes()


def _job(pair, seed: int, n: int = N):
    """A port-built request with every error lane and two windows."""
    meas = random_measurements(pair.t_inst, n, np.random.default_rng(seed))
    args, _ = make_report_batch(pair.t_inst, meas, seed=seed, device=CPU)
    args = list(step_args_to_numpy(args))
    args[2] = _bump(args[2], CORRUPT, pair.t_engine.p3.tf.MODULUS)
    times = [WINDOW_A if i % 2 else WINDOW_B for i in range(n)]
    times[EXPIRED] = NOW + 50
    job = leader_init_request(pair.t_task, pair.t_engine, args, times, unknown_config=(UNKNOWN_CONFIG,))
    job.request = _spoil_ciphertext(job.request, BAD_CIPHERTEXT)
    return job, args, meas, times


def _expected(job, n=N):
    want = list(job.prep_msgs)
    for i, err in ((UNKNOWN_CONFIG, P.HPKE_UNKNOWN_CONFIG_ID), (BAD_CIPHERTEXT, P.HPKE_DECRYPT_ERROR),
                   (EXPIRED, P.TASK_EXPIRED), (CORRUPT, P.VDAF_PREP_ERROR)):
        want[i] = err
    return want


def _check_unshards_to_truth(pair, out0, meas, times, got):
    """Leader's masked aggregate over its out shares + the helper's stored
    share = the sum of the accepted reports, in each window."""
    p = t_registry.circuit_for(pair.t_inst).FIELD.MODULUS
    accept = np.array([isinstance(x, bytes) for x in got])
    shares = pair.helper_shares()
    tp = pair.t_task.time_precision
    for bid, (share, count) in shares.items():
        window = tm.Interval.from_bytes(bid)
        in_window = np.array([tm.Time(t).to_batch_interval_start(tp) == window.start for t in times])
        lanes = accept & in_window
        assert count == int(lanes.sum())
        leader = pair.t_engine.aggregate(out0, lanes)
        total = [(a + b) % p for a, b in zip(leader, share)]
        assert total == [int(x) for x in np.asarray(meas)[lanes].sum(axis=0).reshape(-1)]
    return shares


def test_aggregate_init_matches_janus_tpu(pair):
    job, args, meas, times = _job(pair, seed=21)
    j_bytes, t_resp = pair.answer(bytes(16), job.request)
    assert t_resp.to_bytes() == j_bytes
    got = outcomes(t_resp)
    assert got == _expected(job)
    rows = pair.rows(bytes(16))
    assert rows[0] == rows[1]
    assert len(rows[1][0]) == 2  # two windows, two batch aggregations
    shares = _check_unshards_to_truth(pair, job.out0, meas, times, got)

    # the whole request again: the same bytes, and no row moves
    j_again, t_again = pair.answer(bytes(16), job.request)
    assert t_again.to_bytes() == j_again == j_bytes
    assert pair.rows(bytes(16)) == rows
    assert pair.helper_shares() == shares

    # a second job replays report 0 of the first
    meas2 = random_measurements(pair.t_inst, 4, np.random.default_rng(22))
    args2 = step_args_to_numpy(make_report_batch(pair.t_inst, meas2, seed=22, device=CPU)[0])
    both = [_cat_rows(a, b) for a, b in zip(args, args2)]
    job2 = leader_init_request(pair.t_task, pair.t_engine, both, [WINDOW_A] * 5)
    j2, t2 = pair.answer(bytes([1] * 16), job2.request)
    assert t2.to_bytes() == j2
    got2 = outcomes(t2)
    assert got2[0] == P.REPORT_REPLAYED and got2[1:] == job2.prep_msgs[1:]
    rows2 = pair.rows(bytes([1] * 16))
    assert rows2[0] == rows2[1]


def test_mixed_pairing_request_built_by_janus_tpu():
    """A janus_tpu leader's request (its shard, its EngineCache.leader_init,
    its wire framing, its HPKE) answered by both helpers."""
    pair = Pair("sumvec", fixed_size=True)
    try:
        j_engine = pair.j_helper.engine
        meas = random_measurements(pair.t_inst, 6, np.random.default_rng(31))
        j_args, _ = j_testing.make_report_batch(pair.j_inst, meas, seed=31)
        host = [None if a is None else (tuple(np.asarray(x) for x in a) if isinstance(a, tuple) else np.asarray(a)) for a in j_args]
        nonce, public, lmeas, lproof, b0, hseed, b1 = host
        out0, seed0, ver0, part0 = j_engine.leader_init(nonce, public, lmeas, lproof, b0)
        frames = j_wire.encode_pingpong_share_column(j_engine.p3.jf, ver0, part0)
        wire = j_wire.Prio3Wire(j_registry.circuit_for(pair.j_inst))
        info = j_hpke.HpkeApplicationInfo(j_hpke.Label.INPUT_SHARE, jm.Role.CLIENT, jm.Role.HELPER)
        ids = j_wire.lanes_to_seed_rows(nonce)
        inits = []
        for i in range(6):
            md = jm.ReportMetadata(jm.ReportId(ids[i]), jm.Time(WINDOW_A))
            ps = wire.encode_public_share(j_wire.lanes_to_seed_rows(public[i]))
            payload = jm.PlaintextInputShare((), wire.encode_helper_share(*j_wire.lanes_to_seed_rows(np.stack([hseed[i], b1[i]]))))
            ct = j_hpke.hpke_seal(pair.j_task.hpke_keys[0].config, info, payload.to_bytes(),
                                  jm.InputShareAad(pair.j_task.task_id, md, ps).to_bytes())
            inits.append(jm.PrepareInit(jm.ReportShare(md, ps, ct), frames.row(i)))
        bid = jm.BatchId(bytes(range(32)))
        body = jm.AggregationJobInitializeReq(b"", jm.PartialBatchSelector.fixed_size(bid), tuple(inits)).to_bytes()

        j_bytes, t_resp = pair.answer(bytes(16), body)
        assert t_resp.to_bytes() == j_bytes
        got = outcomes(t_resp)
        assert got == j_wire.lanes_to_seed_rows(seed0)
        rows = pair.rows(bytes(16))
        assert rows[0] == rows[1]
        (share, count), = pair.helper_shares().values()
        assert count == 6 and pair.rows(bytes(16))[1][0][0][0] == bid.data
        leader = j_engine.aggregate(out0, np.ones(6, dtype=bool))
        p = t_registry.circuit_for(pair.t_inst).FIELD.MODULUS
        assert [(int(a) + b) % p for a, b in zip(leader, share)] == [int(x) for x in np.asarray(meas).sum(axis=0)]
    finally:
        pair.close()


def test_task_dict_is_read_as_janus_tpu_wrote_it():
    j = (
        j_task.TaskBuilder(j_task.QueryTypeConfig.fixed_size(max_batch_size=7), j_registry.VdafInstance.sum_vec(4, 3, 2), jm.Role.HELPER)
        .with_(task_expiration=jm.Time(NOW), report_expiry_age=jm.Duration(600))
        .build()
    )
    t = Task.from_dict(j.to_dict())
    assert t.to_dict() == j.to_dict()
    assert t.vdaf == t_registry.VdafInstance.sum_vec(4, 3, 2) and t.vdaf.rounds == 1
    assert t.hpke_keys[0].private_key == j.hpke_keys[0].private_key
    assert t.hpke_keys[0].config.to_bytes() == j.hpke_keys[0].config.to_bytes()
    # a Poplar1 task reads as janus_tpu wrote it (its prepare runs through
    # aggregator/poplar1_ops.py), and so does a block-sparse SumVec task
    # (its compact prepare on the SumVec engine, its aggregate by scatter)
    p = j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j_registry.VdafInstance.poplar1(4),
                           jm.Role.HELPER).build()
    tp_task = Task.from_dict(p.to_dict())
    assert tp_task.to_dict() == p.to_dict()
    assert tp_task.vdaf == t_registry.VdafInstance.poplar1(4) and tp_task.vdaf.rounds == 2
    sp = j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), j_registry.VdafInstance.sparse_sumvec(2, 64, 8, 2),
                            jm.Role.HELPER).build()
    sp_task = Task.from_dict(sp.to_dict())
    assert sp_task.to_dict() == sp.to_dict()
    assert sp_task.vdaf == t_registry.VdafInstance.sparse_sumvec(2, 64, 8, 2) and sp_task.vdaf.rounds == 1


def test_request_level_rejections():
    """Unknown task, job id reuse with other bytes, a duplicate report id,
    and a query-type mismatch are refused before the device runs."""
    pair = Pair("count")
    try:
        job, _, _, _ = _job(pair, seed=41)
        agg = pair.t_helper
        with pytest.raises(t_errors.UnrecognizedTask):
            agg.handle_aggregate_init(tm.TaskId(bytes(32)), tm.AggregationJobId(bytes(16)), job.request)
        req = tm.AggregationJobInitializeReq.from_bytes(job.request)
        dup = dataclasses.replace(req, prepare_inits=req.prepare_inits + req.prepare_inits[:1]).to_bytes()
        with pytest.raises(t_errors.InvalidMessage, match="duplicate"):
            agg.handle_aggregate_init(pair.t_task.task_id, tm.AggregationJobId(bytes(16)), dup)
        fixed = dataclasses.replace(req, partial_batch_selector=tm.PartialBatchSelector.fixed_size(tm.BatchId(bytes(32))))
        with pytest.raises(t_errors.InvalidMessage, match="query type"):
            agg.handle_aggregate_init(pair.t_task.task_id, tm.AggregationJobId(bytes(16)), fixed.to_bytes())
        agg.handle_aggregate_init(pair.t_task.task_id, tm.AggregationJobId(bytes(16)), job.request)
        ta = agg.task_aggregator_for(pair.t_task.task_id)
        assert ta.hpke_config_list().to_bytes() == pair.j_helper.hpke_config_list().to_bytes()
        assert set(ta.stage_seconds) == {
            "hpke_open", "decode", "helper_init", "accumulate", "write_tx"
        }
        with pytest.raises(t_errors.InvalidMessage, match="reuse"):
            agg.handle_aggregate_init(pair.t_task.task_id, tm.AggregationJobId(bytes(16)), dup)
    finally:
        pair.close()
