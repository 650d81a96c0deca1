"""janus_tpu_torch's differential privacy held against janus_tpu's.

- One seeded stream fed to both packages' `secrets` draws (the module
  attribute of each dp.py): `discrete_gaussian` at several scales, and
  `add_noise_to_agg_share` on Field64 and Field128 shares, give
  janus_tpu's values exactly.
- A disabled strategy (mechanism "none", sigma 0) and an empty share are
  the identity; the strategy's dict, and a task's, are janus_tpu's.
- With DP on, a janus_tpu pair and a port pair each collect one
  fixed-size batch twice (a current-batch query, then a query by the
  batch's id; max_batch_query_count 2) from equally seeded streams. The
  leader's noised share is persisted (one aggregate-share job row on each
  side) and reused by the second collection, so both collections give
  the same noised result; rows and results equal janus_tpu's.

The port runs with device="cpu"; tolerance: exact equality.
"""

import dataclasses
import random
from fractions import Fraction

import pytest

from janus_tpu import dp as j_dp
from janus_tpu.core import hpke as j_hpke
from janus_tpu.fields.field import Field64 as JField64
from janus_tpu.fields.field import Field128 as JField128
from janus_tpu_torch import dp as t_dp
from janus_tpu_torch.fields.field import Field64, Field128
from janus_tpu_torch.task import Task
from test_torch_collect import (
    BATCH_X,
    PKG,
    TP,
    W0,
    make_tasks,
    seed,
    share_job_rows,
)


class _Seeded:
    """A stand-in for dp.py's `secrets`: a seeded stream."""

    def __init__(self, seed_: int):
        self.rng = random.Random(seed_)

    def randbelow(self, n: int) -> int:
        return self.rng.randrange(n)


def seed_dp(monkeypatch, seed_: int) -> None:
    for mod in (j_dp, t_dp):
        monkeypatch.setattr(mod, "secrets", _Seeded(seed_))


@pytest.mark.parametrize("sigma", [Fraction(1, 2), Fraction(1), Fraction(5), Fraction(37, 3), Fraction(100)])
def test_discrete_gaussian_matches_janus_tpu(monkeypatch, sigma):
    seed_dp(monkeypatch, 11)
    want = [j_dp.discrete_gaussian(sigma) for _ in range(60)]
    got = [t_dp.discrete_gaussian(sigma) for _ in range(60)]
    assert got == want
    assert any(x != 0 for x in got)


@pytest.mark.parametrize("fields", [(JField64, Field64), (JField128, Field128)], ids=["field64", "field128"])
@pytest.mark.parametrize("sigma", [0.5, 8.0, 123.25])
def test_add_noise_to_agg_share_matches_janus_tpu(monkeypatch, fields, sigma):
    j_field, t_field = fields
    share = t_field.encode_vec([0, 1, t_field.MODULUS - 1, 12345, 7])
    seed_dp(monkeypatch, 5)
    want = j_dp.add_noise_to_agg_share(j_dp.DpStrategy("discrete_gaussian", sigma), j_field, share)
    got = t_dp.add_noise_to_agg_share(t_dp.DpStrategy("discrete_gaussian", sigma), t_field, share)
    assert got == want and got != share


def test_disabled_strategy_is_the_identity_and_serializes_as_janus_tpu():
    share = Field128.encode_vec([1, 2, 3])
    assert t_dp.add_noise_to_agg_share(t_dp.DpStrategy(), Field128, share) == share
    assert t_dp.add_noise_to_agg_share(t_dp.DpStrategy("discrete_gaussian", 0.0), Field128, share) == share
    assert t_dp.add_noise_to_agg_share(t_dp.DpStrategy("discrete_gaussian", 5.0), Field128, None) is None
    for strategy in (j_dp.DpStrategy(), j_dp.DpStrategy("discrete_gaussian", 2.5)):
        assert t_dp.DpStrategy.from_dict(strategy.to_dict()).to_dict() == strategy.to_dict()
        kp = j_hpke.generate_hpke_config_and_private_key(config_id=7)
        j_leader, _ = make_tasks({"kind": "count"}, "time_interval", kp, dp_strategy=strategy)
        port = Task.from_dict(j_leader.to_dict())
        assert port.dp_strategy == t_dp.DpStrategy(strategy.mechanism, strategy.sigma)
        assert port.to_dict() == j_leader.to_dict()


def collect_twice(pkg: str):
    """A pair of `pkg` collects batch X twice with DP on; returns the two
    results and the leader's and the helper's aggregate-share jobs."""
    p = PKG[pkg]
    kp = j_hpke.generate_hpke_config_and_private_key(config_id=7)
    j_leader, j_helper = make_tasks({"kind": "sumvec", "length": 3, "bits": 2}, "fixed_size", kp,
                                    max_batch_query_count=2, dp_strategy=j_dp.DpStrategy("discrete_gaussian", 3.0))
    rows = [(BATCH_X, 0, 3, (W0, 10), bytes([1]) * 32), (BATCH_X, 1, 4, (W0 + TP, 10), bytes([2]) * 32)]
    leader_vals, helper_vals = [[5, 6, 7], [1, 0, 2]], [[1, 2, 3], [4, 4, 4]]
    enc = Field128.encode_vec
    h_eph, l_eph = p.eph(), p.eph()
    h_srv = p.http.DapServer(p.http.DapHttpApp(p.aggregator(h_eph))).start()
    l_srv = None
    try:
        seed(p, h_eph.datastore, p.task(j_helper), [r + (enc(v),) for r, v in zip(rows, helper_vals)])
        task = p.task(dataclasses.replace(j_leader, helper_aggregator_endpoint=h_srv.url))
        seed(p, l_eph.datastore, task, [r + (enc(v),) for r, v in zip(rows, leader_vals)], [(BATCH_X, 7)])
        l_agg = p.aggregator(l_eph)
        l_srv = p.http.DapServer(p.http.DapHttpApp(l_agg)).start()
        m = p.m
        keypair = p.hpke.HpkeKeypair(m.HpkeConfig.from_bytes(kp.config.to_bytes()), kp.private_key)
        collector = p.collector.Collector(
            p.collector.CollectorParameters(task.task_id, l_srv.url, task.collector_auth_token, keypair), task.vdaf,
            p.client.HttpClient(timeout=30),
        )
        driver = p.cdriver.CollectionJobDriver(
            l_eph.datastore, p.client.HttpClient(timeout=30),
            p.cdriver.CollectionJobDriverConfig(http_backoff=p.retries.Backoff.test()),
            breakers=p.cb.OutboundCircuitBreakers(),
        )
        jobs = p.jobs.JobDriver(p.jobs.JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(),
                                driver.stepper)
        results = []
        for i, fsq in enumerate((m.FixedSizeQuery(m.FixedSizeQuery.CURRENT_BATCH),
                                 m.FixedSizeQuery(m.FixedSizeQuery.BY_BATCH_ID, m.BatchId(BATCH_X)))):
            job_id, query = m.CollectionJobId(bytes([i + 1]) * 16), m.Query.fixed_size(fsq)
            l_agg.task_aggregator_for(task.task_id).handle_create_collection_job(
                l_eph.datastore, job_id, m.CollectionReq(query, b"")
            )
            assert jobs.run_once() == 1
            res = collector.poll_once(job_id, query)
            results.append((res.report_count, res.aggregate_result))
        return results, share_job_rows(l_eph.datastore, p), share_job_rows(h_eph.datastore, p)
    finally:
        h_srv.stop()
        if l_srv is not None:
            l_srv.stop()
        h_eph.cleanup()
        l_eph.cleanup()


def test_leader_noised_share_is_persisted_and_reused_as_in_janus_tpu(monkeypatch):
    out = {}
    for pkg in PKG:
        seed_dp(monkeypatch, 23)
        out[pkg] = collect_twice(pkg)
    assert out["torch"] == out["jax"]
    (first, second), leader_jobs, helper_jobs = out["torch"]
    assert first == second  # the same noise, not fresh noise per query
    assert first[0] == 7 and first[1] != [11, 12, 16]  # the noiseless sum
    assert len(leader_jobs) == len(helper_jobs) == 1
    assert leader_jobs[0][0] == helper_jobs[0][0] == BATCH_X
    # the leader's persisted share is its rows' sum plus noise
    noised = Field128.decode_vec(leader_jobs[0][2])
    assert noised != [5 + 1, 6 + 0, 7 + 2]
