"""janus_tpu_torch's CUDA kernels held against their plain versions on the card.

These need an NVIDIA GPU (sm_90a, nvcc on PATH or under /usr/local/cuda)
and skip elsewhere; on such a machine run them with
`python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda`. The plain
versions themselves are held against janus_tpu by the CPU tests.
"""

import numpy as np
import pytest
import torch

from janus_tpu_torch.ops import expand_cuda, keccak_cuda, scatter_cuda, sponge_cuda
from janus_tpu_torch.parallel import api
from janus_tpu_torch.vdaf.registry import VdafInstance, prio3_batched
from janus_tpu_torch.vdaf.testing import make_report_batch, random_measurements

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _lanes(shape, seed, device):
    a = np.random.default_rng(seed).integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
    return torch.from_numpy(a.view(np.int64)).to(device)


def _prefix_parts(batch, seed, device):
    """A 10-lane prefix: a dst (bytes), a strided [batch, 2] view, a
    [batch, 3] tensor and a [1, 2] row broadcast across the batch."""
    t = _lanes((batch, 7), seed, device)
    return [(0, bytes(range(16))), (2, t[:, 0:4:2]), (4, t[:, 2:5]), (8, _lanes((1, 2), seed + 1, device))]


@pytest.mark.parametrize("rounds", [24, 3])
@pytest.mark.parametrize("out_lanes", [21, 5, 2])
def test_single_block_kernel_matches_plain(cuda, rounds, out_lanes):
    """Kernel 1's counter-mode entry (its stores staged through shared
    memory past 2 lanes) against its plain version; one launch."""
    parts = _prefix_parts(5, out_lanes, cuda)
    want = keccak_cuda.keccak_ctr_blocks_plain(parts, 10, 5, 333, out_lanes, cuda, ctr_offset=7, rounds=rounds)
    before = keccak_cuda.keccak_single_block.launches
    got = keccak_cuda.keccak_ctr_blocks(parts, 10, 5, 333, out_lanes, cuda, ctr_offset=7, rounds=rounds)
    torch.cuda.synchronize()
    assert keccak_cuda.keccak_single_block.launches == before + 1
    assert got.shape == (5, 333, out_lanes) and torch.equal(got, want)


@pytest.mark.parametrize("rounds", [24, 3])
@pytest.mark.parametrize("level", [0, 3])
def test_tree_level_kernel_matches_plain(cuda, rounds, level):
    """Kernel 1's tree-level entry: the leaf level over a binder's parts
    (an aggregator id, a nonce, a share of 4,000 lanes: 4,003, not a
    multiple of 14), an upper level over [batch, 286, 2] digests."""
    if level == 0:
        parts = [(0, bytes(8)), (1, _lanes((6, 2), 3, cuda)), (3, _lanes((6, 4000), 4, cuda))]
        lanes_n = 4003
    else:
        parts = [(0, _lanes((6, 286, 2), 5, cuda).reshape(6, -1))]
        lanes_n = 572
    want = keccak_cuda.keccak_tree_level_plain(parts, lanes_n, 6, level, 32024, cuda, rounds=rounds)
    before = keccak_cuda.keccak_single_block.launches
    got = keccak_cuda.keccak_tree_level(parts, lanes_n, 6, level, 32024, cuda, rounds=rounds)
    torch.cuda.synchronize()
    assert keccak_cuda.keccak_single_block.launches == before + 1
    assert got.shape == (6, keccak_cuda.tree_nodes(lanes_n), 2) and torch.equal(got, want)


@pytest.mark.parametrize("rounds", [24, 3])
def test_expand_kernel_matches_plain(cuda, rounds):
    prefix = _lanes((7, 5), 9, cuda)
    for offset in (0, 11):
        got = expand_cuda.expand_f128(prefix, 40, 275, block_offset=offset, rounds=rounds)
        want = expand_cuda.expand_f128_plain(prefix, 40, 275, block_offset=offset, rounds=rounds)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# Prio3Histogram(10000), the taskprov path's circuit: 10,000 Field128
# inputs a report, so the leader binder's tree leaf level and the helper's
# measurement share are both ceil(10000 / 7) = 1,429 blocks a report
HIST_BLOCKS, HIST_LENGTH = 1429, 10000


def test_single_block_kernel_matches_plain_at_histogram_10000(cuda):
    """The leader binder's leaf level at Prio3Histogram(10000): 1,024
    reports x 1,429 nodes over an id, a nonce and 20,000 share lanes;
    then the counter-mode entry over as many blocks, 21 lanes out."""
    parts = [(0, bytes(8)), (1, _lanes((1024, 2), 21, cuda)), (3, _lanes((1024, 2 * HIST_LENGTH), 22, cuda))]
    got = keccak_cuda.keccak_tree_level(parts, 3 + 2 * HIST_LENGTH, 1024, 0, 8 * (3 + 2 * HIST_LENGTH), cuda)
    want = keccak_cuda.keccak_tree_level_plain(parts, 3 + 2 * HIST_LENGTH, 1024, 0, 8 * (3 + 2 * HIST_LENGTH), cuda)
    torch.cuda.synchronize()
    assert got.shape == (1024, HIST_BLOCKS, 2) and torch.equal(got, want)
    del got, want
    parts = _prefix_parts(1024, 23, cuda)
    got = keccak_cuda.keccak_ctr_blocks(parts, 10, 1024, HIST_BLOCKS, 21, cuda)
    want = keccak_cuda.keccak_ctr_blocks_plain(parts, 10, 1024, HIST_BLOCKS, 21, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 3])
def test_expand_kernel_matches_plain_at_histogram_10000(cuda, offset):
    prefix = _lanes((1024, 5), 23, cuda)
    before = expand_cuda.expand_f128.launches
    got = expand_cuda.expand_f128(prefix, HIST_BLOCKS, HIST_LENGTH, block_offset=offset)
    want = expand_cuda.expand_f128_plain(prefix, HIST_BLOCKS, HIST_LENGTH, block_offset=offset)
    torch.cuda.synchronize()
    assert expand_cuda.expand_f128.launches == before + 1
    assert got[0].shape == (1024, HIST_LENGTH)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (head bytes, body elements, body limbs): no body; a body at every byte
# offset mod 8; messages of 167, 168 and 169 bytes; multi-block bodies
SPONGE_MESSAGES = [(41, 0, 0), (57, 0, 0), (0, 20, 1), (3, 20, 1), (7, 20, 1), (8, 20, 1), (9, 20, 1),
                   (42, 40, 2), (26, 333, 2), (60, 33, 1)]
# (length, limbs, modulus): the two fields, and moduli that reject often
SPONGE_SAMPLES = [(50, 1, 2**64 - 2**32 + 1), (275, 2, 2**128 - 7 * 2**66 + 1), (40, 1, 2**63), (40, 2, 2**127),
                  (300, 2, 2**128 - 2**123)]


def _sponge_inputs(head_bytes, elems, limbs, batch, seed, device):
    head = _lanes((batch, -(-head_bytes // 8)), seed, device)
    if head_bytes % 8:
        head[:, -1] &= (1 << (8 * (head_bytes % 8))) - 1
    body = tuple(_lanes((batch, elems), seed + 1 + j, device) for j in range(limbs))
    return head, head_bytes + 8 * elems * limbs, body


@pytest.mark.parametrize("rounds", [24, 3])
@pytest.mark.parametrize("msg", SPONGE_MESSAGES, ids=str)
def test_sponge_kernel_lanes_match_plain(cuda, rounds, msg):
    head, msg_len, body = _sponge_inputs(*msg, 37, sum(msg), cuda)
    before = sponge_cuda.keccak_sponge.launches
    got = sponge_cuda.keccak_sponge(head, msg_len, body, msg[0], out_lanes=21, rounds=rounds)
    want = sponge_cuda.keccak_sponge_plain(head, msg_len, body, msg[0], out_lanes=21, rounds=rounds)
    torch.cuda.synchronize()
    assert sponge_cuda.keccak_sponge.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("sample", SPONGE_SAMPLES, ids=str)
@pytest.mark.parametrize("msg", [(26, 0, 0), (42, 40, 2)], ids=str)
def test_sponge_kernel_sample_matches_plain(cuda, msg, sample):
    head, msg_len, body = _sponge_inputs(*msg, 45, sample[0], cuda)
    got = sponge_cuda.keccak_sponge(head, msg_len, body, msg[0], sample=sample, rounds=24)
    want = sponge_cuda.keccak_sponge_plain(head, msg_len, body, msg[0], sample=sample, rounds=24)
    torch.cuda.synchronize()
    assert len(got) == sample[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_sponge_kernel_raises_on_a_bad_shape(cuda):
    with pytest.raises(ValueError):
        sponge_cuda.keccak_sponge(_lanes((4, 22), 1, cuda), 100, out_lanes=2)


def test_draft_two_party_step_on_card_matches_cpu(cuda):
    """Draft mode runs the sponge kernel and neither fast-mode kernel."""
    inst = VdafInstance("sumvec", bits=4, length=10, xof_mode="draft")
    meas = random_measurements(inst, 16, np.random.default_rng(5))
    outs = {}
    for dev in ("cpu", cuda):
        for fn in (keccak_cuda.keccak_single_block, expand_cuda.expand_f128, sponge_cuda.keccak_sponge):
            fn.launches = 0
        args, _ = make_report_batch(inst, meas, seed=6, device=dev)
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device=dev)(*args)
        p3 = prio3_batched(inst, dev)
        outs[str(dev)] = ([int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))], int(count))
        assert (sponge_cuda.keccak_sponge.launches > 0) == (dev != "cpu")
        assert keccak_cuda.keccak_single_block.launches == 0 and expand_cuda.expand_f128.launches == 0
    assert outs["cpu"] == outs["cuda"]
    assert outs["cpu"] == ([int(x) for x in np.asarray(meas).sum(axis=0)], 16)


def test_two_party_step_on_card_matches_cpu(cuda):
    inst = VdafInstance.sum_vec(10, 4)
    meas = random_measurements(inst, 16, np.random.default_rng(3))
    outs = {}
    for dev in ("cpu", cuda):
        keccak_cuda.keccak_single_block.launches = 0
        expand_cuda.expand_f128.launches = 0
        sponge_cuda.keccak_sponge.launches = 0
        args, _ = make_report_batch(inst, meas, seed=4, device=dev)
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device=dev)(*args)
        p3 = prio3_batched(inst, dev)
        outs[str(dev)] = ([int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))], int(count))
        launched = keccak_cuda.keccak_single_block.launches > 0 and expand_cuda.expand_f128.launches > 0
        assert launched == (dev != "cpu")
        assert sponge_cuda.keccak_sponge.launches == 0
    assert outs["cpu"] == outs["cuda"]
    assert outs["cpu"] == ([int(x) for x in np.asarray(meas).sum(axis=0)], 16)


def test_streamed_step_on_the_card_equals_the_whole_share_step(cuda):
    """SumVec(100000, 16) at 4 reports: the streamed prepare (kernel 2 a
    tile a step for the helper's share) and the whole-share prepare (its
    stream_plan threshold past input_len) give the same field elements on
    both sides, and the two-party step accepts and sums every report."""
    from janus_tpu_torch.vdaf.engine import stream_plan
    from janus_tpu_torch.vdaf.prio3 import Prio3Batched

    inst = VdafInstance.sum_vec(100_000, 16)
    p3 = prio3_batched(inst, cuda)
    assert (p3.plan.group, p3.plan.gcalls, p3.plan.n_steps) == (61_936, 49, 26)
    whole = Prio3Batched(p3.circ, device=cuda)
    whole.plan = stream_plan(whole.bc, min_input_len=p3.circ.input_len + 1)
    assert whole.plan is None
    meas = random_measurements(inst, 4, np.random.default_rng(8))
    args, _ = make_report_batch(inst, meas, seed=9, shard_chunk=4, device=cuda)
    nonce, parts, lmeas, lproof, blind0, seed, blind1 = args
    outs = []
    for eng in (p3, whole):
        expand_cuda.expand_f128.launches = 0
        helper = eng.prepare_init_helper(bytes(16), nonce, parts, seed, blind1)
        launches = expand_cuda.expand_f128.launches
        leader = eng.prepare_init_leader(bytes(16), nonce, parts, lmeas, lproof, blind0)
        outs.append((helper, leader, launches))
    torch.cuda.synchronize()
    # the helper's share: one launch a step streamed, one in all whole
    assert outs[0][2] - outs[1][2] == p3.plan.n_steps - 1
    for a, b in zip(outs[0][:2], outs[1][:2]):
        for x, y in zip(a, b):
            xs, ys = (x, y) if isinstance(x, tuple) else ((x,), (y,))
            assert all(torch.equal(u, v) for u, v in zip(xs, ys))
    agg0, agg1, count = api.two_party_step(inst, bytes(16), device=cuda)(*args)
    assert int(count) == 4
    total = [int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))]
    assert total == [int(x) for x in np.asarray(meas).sum(axis=0)]


def test_fixed_point_on_the_card_matches_cpu(cuda):
    """FixedPointVec(1000, 16) at batch 8 (one report's leader proof share
    corrupted): the card and the CPU plain path give the same aggregate
    and count, the valid reports' offset-binary sum."""
    inst = VdafInstance.fixed_point_vec(1000, 16)
    meas = random_measurements(inst, 8, np.random.default_rng(12))
    outs = {}
    for dev in ("cpu", cuda):
        p3 = prio3_batched(inst, dev)
        args, _ = make_report_batch(inst, meas, seed=13, device=dev)
        args = list(args)
        proof = tuple(x.clone() for x in args[3])
        proof[0][3, 0] += 1  # lo limb of a Field128 element below 2^64 - 1: stays below p
        args[3] = proof
        expand_cuda.expand_f128.launches = 0
        agg0, agg1, count = api.two_party_step(inst, bytes(16), device=dev)(*args)
        assert (expand_cuda.expand_f128.launches > 0) == (dev != "cpu")
        outs[str(dev)] = ([int(x) for x in p3.tf.to_ints(p3.merge_agg_shares(agg0, agg1))], int(count))
    assert outs["cpu"] == outs["cuda"]
    valid = np.arange(8) != 3
    assert outs["cpu"] == ([int(x) for x in (np.asarray(meas)[valid] + (1 << 15)).sum(axis=0)], 7)


@pytest.mark.parametrize("route", ["direct", "pipelined", "chunked"])
def test_engine_routes_on_the_card_match_the_cpu(cuda, monkeypatch, route):
    """EngineCache on the card (pinned side-stream copies on the pipelined
    route, cap-sized dispatches on the chunked one) gives the CPU
    engine's values, with the kernels launched."""
    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.convert import step_args_to_numpy

    monkeypatch.setattr(EngineCache, "PIPELINE_CHUNK", 32)
    inst = VdafInstance.sum_vec(3, 2)
    n = 5 if route == "direct" else 70
    meas = random_measurements(inst, n, np.random.default_rng(n))
    args = step_args_to_numpy(make_report_batch(inst, meas, seed=n, device="cpu")[0])
    nonce, parts, lmeas, lproof, b0, seed, b1 = args
    results = []
    for dev in (cuda, "cpu"):
        eng = EngineCache(inst, bytes(16), device=dev, bucket_cap=32 if route == "chunked" else 0)
        keccak_cuda.keccak_single_block.launches = 0
        out0, seed0, ver0, part0 = eng.leader_init(nonce, parts, lmeas, lproof, b0)
        out1, mask, prep = eng.helper_init(nonce, parts, seed, b1, ver0, part0, np.ones(n, dtype=bool))
        results.append((out0.to_numpy(), seed0, ver0, part0, out1.to_numpy(), mask, prep,
                        eng.aggregate(out0, mask), eng.aggregate(out1, mask)))
        assert (keccak_cuda.keccak_single_block.launches > 0) == (dev is cuda)
    for got, want in zip(*results):
        if isinstance(got, list):
            assert got == want
        else:
            for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
                assert np.array_equal(g, w)
    assert results[0][5].all()


@pytest.mark.parametrize("xof_mode,n,workers", [("fast", 40, 1), ("draft", 40, 1), ("fast", 1200, 2)])
def test_port_driver_pair_on_the_card_matches_the_cpu(cuda, xof_mode, n, workers):
    """A port leader's job driver steps SumVec jobs against a port helper
    over loopback HTTP, once on the card and once on the CPU, from the
    same stored reports: the same report outcomes and the same stored
    shares on both sides, with the path's kernels launched on the card.
    The last case makes two 600-report jobs (each on the pipelined leader
    route) and steps them with two workers, so one job's leader init and
    side-stream copies run beside the other's helper request on one
    EngineCache."""
    import dataclasses

    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator, AggregationJobCreatorConfig
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.aggregator.testing import leader_stored_reports
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.messages import Role, Time
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder

    now = 1_700_000_000
    inst = VdafInstance("sumvec", bits=2, length=3, xof_mode=xof_mode)
    leader_task = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.LEADER).with_(
        vdaf_verify_key=bytes(16), aggregator_auth_token=AuthenticationToken.random_bearer()
    ).build()
    helper_task = dataclasses.replace(
        leader_task, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
    )
    meas = random_measurements(inst, n, np.random.default_rng(3))
    args, _ = make_report_batch(inst, meas, seed=3, device="cpu")
    reports = leader_stored_reports(leader_task, helper_task.hpke_keys[0].config, args, [now - 100] * n)
    reports[7] = dataclasses.replace(reports[7], leader_input_share=bytes(len(reports[7].leader_input_share)))
    counters = (keccak_cuda.keccak_single_block, expand_cuda.expand_f128, sponge_cuda.keccak_sponge)
    results = []
    for dev in (cuda, "cpu"):
        leader, helper = EphemeralDatastore(MockClock(Time(now))), EphemeralDatastore(MockClock(Time(now)))
        server = DapServer(DapHttpApp(Aggregator(helper.datastore, helper.clock, device=dev))).start()
        try:
            task = dataclasses.replace(leader_task, helper_aggregator_endpoint=server.url)
            leader.datastore.run_tx(lambda tx: [tx.put_task(task)] + [tx.put_client_report(r) for r in reports])
            helper.datastore.run_tx(lambda tx: tx.put_task(helper_task))
            creator_cfg = AggregationJobCreatorConfig(max_aggregation_job_size=n // workers)
            assert AggregationJobCreator(leader.datastore, creator_cfg).run_once() == workers
            driver = AggregationJobDriver(
                leader.datastore, HttpClient(timeout=120), AggregationJobDriverConfig(http_backoff=Backoff.test()),
                breakers=OutboundCircuitBreakers(), device=dev,
            )
            for fn in counters:
                fn.launches = 0
            job_driver = JobDriver(JobDriverConfig(max_concurrent_job_workers=workers), driver.acquirer(), driver.stepper)
            assert job_driver.run_once() == workers
            assert len(driver.step_seconds) == workers
            launches = [fn.launches for fn in counters]
            assert (sum(launches) > 0) == (dev is cuda)
            if dev is cuda:
                assert (launches[2] > 0) == (xof_mode == "draft") and (launches[0] > 0) == (xof_mode == "fast")

            def rows(ds):
                return ds.run_tx(lambda tx: (
                    tx._c.execute("SELECT report_id, state, prepare_error FROM report_aggregations ORDER BY report_id").fetchall(),
                    tx._c.execute("SELECT batch_identifier, aggregate_share, report_count, checksum FROM batch_aggregations").fetchall(),
                    tx._c.execute("SELECT state, lease_token IS NULL FROM aggregation_jobs").fetchall(),
                ))

            results.append((rows(leader.datastore), rows(helper.datastore)))
        finally:
            server.stop()
            leader.cleanup()
            helper.cleanup()
    assert results[0] == results[1]
    (l_ras, l_bas, l_jobs), (_, h_bas, _) = results[0]
    assert sum(1 for r in l_ras if r[1] == "failed") == 1 and l_bas[0][2] == h_bas[0][2] == n - 1
    assert l_jobs == [("finished", 1)] * workers


def test_port_fixed_size_upload_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """Count reports uploaded over loopback to a port leader on a
    fixed-size task, packed by the creator and stepped against a port
    helper, once on the card and once on the CPU, from the same report
    bytes and the same batch and job ids: the same rows on both sides,
    with the single-block kernel launched on the card."""
    import dataclasses

    from janus_tpu_torch.aggregator import aggregation_job_creator as creator_mod
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.circuit_breaker import OutboundCircuitBreakers
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.messages import Report, Role, Time
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder

    class Seeded:
        def __init__(self, seed):
            self.rng = np.random.default_rng(seed)

        def token_bytes(self, n):
            return self.rng.bytes(n)

    now, n = 1_700_000_000, 24
    inst = VdafInstance.count()
    leader_task = TaskBuilder(QueryTypeConfig.fixed_size(max_batch_size=n), inst, Role.LEADER).with_(
        vdaf_verify_key=bytes(16), aggregator_auth_token=AuthenticationToken.random_bearer()
    ).build()
    helper_task = dataclasses.replace(
        leader_task, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
    )
    params = ClientParameters(leader_task.task_id, "http://unused/", "http://unused/", leader_task.time_precision)
    client = Client(params, inst, leader_task.hpke_keys[0].config, helper_task.hpke_keys[0].config,
                    clock=MockClock(Time(now)))
    meas = np.random.default_rng(5).integers(0, 2, size=n)
    bodies = [client.prepare_report(int(m)).to_bytes() for m in meas]
    counters = (keccak_cuda.keccak_single_block, expand_cuda.expand_f128, sponge_cuda.keccak_sponge)
    results = []
    for dev in (cuda, "cpu"):
        monkeypatch.setattr(creator_mod, "secrets", Seeded(2))
        leader, helper = EphemeralDatastore(MockClock(Time(now))), EphemeralDatastore(MockClock(Time(now)))
        l_agg = Aggregator(leader.datastore, leader.clock, device=dev)
        servers = [DapServer(DapHttpApp(Aggregator(helper.datastore, helper.clock, device=dev))).start(),
                   DapServer(DapHttpApp(l_agg)).start()]
        try:
            task = dataclasses.replace(leader_task, helper_aggregator_endpoint=servers[0].url)
            leader.datastore.run_tx(lambda tx: tx.put_task(task))
            helper.datastore.run_tx(lambda tx: tx.put_task(helper_task))
            http = HttpClient(timeout=120)
            upload_uri = servers[1].url + params.upload_uri()[len("http://unused/"):]
            assert [http.put(upload_uri, b, {"Content-Type": Report.MEDIA_TYPE})[0] for b in bodies] == [201] * n
            assert creator_mod.AggregationJobCreator(leader.datastore).run_once() == 1
            driver = AggregationJobDriver(
                leader.datastore, http, AggregationJobDriverConfig(http_backoff=Backoff.test()),
                breakers=OutboundCircuitBreakers(), device=dev,
            )
            for fn in counters:
                fn.launches = 0
            assert JobDriver(JobDriverConfig(max_concurrent_job_workers=1), driver.acquirer(), driver.stepper).run_once() == 1
            launches = [fn.launches for fn in counters]
            assert (launches[0] > 0) == (dev is cuda) and launches[1:] == [0, 0]

            def rows(ds):
                return ds.run_tx(lambda tx: (
                    tx._c.execute("SELECT report_id, state, prepare_error FROM report_aggregations ORDER BY report_id").fetchall(),
                    tx._c.execute("SELECT batch_identifier, aggregate_share, report_count, checksum FROM batch_aggregations").fetchall(),
                    tx._c.execute("SELECT job_id, partial_batch_identifier, state, lease_token IS NULL FROM aggregation_jobs").fetchall(),
                ))

            obs = leader.datastore.run_tx(lambda tx: tx._c.execute("SELECT batch_id, size, filled FROM outstanding_batches").fetchall())
            results.append((rows(leader.datastore), rows(helper.datastore), obs))
        finally:
            for s in servers:
                s.stop()
            l_agg.close()
            leader.cleanup()
            helper.cleanup()
    assert results[0] == results[1]
    (l_ras, l_bas, l_jobs), _, obs = results[0]
    assert [r[1] for r in l_ras] == ["finished"] * n and l_bas[0][2] == n and obs[0][1:] == (n, 1)
    p = 2**64 - 2**32 + 1
    shares = [int.from_bytes(rows[1][0][1], "little") for rows in results[0][:2]]
    assert sum(shares) % p == int(meas.sum())


def test_port_pair_collects_a_sumvec_job_on_the_card(cuda):
    """A narrow SumVec job aggregated by a port pair on the card (helper
    behind a DapServer, 1 corrupted report), then collected: a port
    Collector's time-interval query, the CollectionJobDriver's step (no
    kernel launched) and the poll reach the sum of the accepted
    measurements."""
    import dataclasses

    from janus_tpu_torch.aggregator.aggregation_job_creator import AggregationJobCreator
    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver, CollectionJobDriverConfig
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.aggregator.testing import leader_stored_reports
    from janus_tpu_torch.collector import Collector, CollectorParameters
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.messages import Interval, Query, Role, Time
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder

    now, n, bad = 1_700_000_000, 64, 9
    inst = VdafInstance.sum_vec(3, 2)
    collector_kp = generate_hpke_config_and_private_key(config_id=7)
    leader_task = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.LEADER).with_(
        vdaf_verify_key=bytes(16), aggregator_auth_token=AuthenticationToken.random_bearer(),
        collector_hpke_config=collector_kp.config, min_batch_size=n // 2,
    ).build()
    helper_task = dataclasses.replace(
        leader_task, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
    )
    meas = np.asarray(random_measurements(inst, n, np.random.default_rng(4)))
    args, _ = make_report_batch(inst, meas, seed=4, device="cpu")
    reports = leader_stored_reports(leader_task, helper_task.hpke_keys[0].config, args, [now - 100] * n)
    reports[bad] = dataclasses.replace(reports[bad], leader_input_share=bytes(len(reports[bad].leader_input_share)))
    counters = (keccak_cuda.keccak_single_block, expand_cuda.expand_f128, sponge_cuda.keccak_sponge)
    leader, helper = EphemeralDatastore(MockClock(Time(now))), EphemeralDatastore(MockClock(Time(now)))
    l_agg = Aggregator(leader.datastore, leader.clock, device=cuda)
    servers = [DapServer(DapHttpApp(Aggregator(helper.datastore, helper.clock, device=cuda))).start(),
               DapServer(DapHttpApp(l_agg)).start()]
    try:
        task = dataclasses.replace(leader_task, helper_aggregator_endpoint=servers[0].url)
        leader.datastore.run_tx(lambda tx: [tx.put_task(task)] + [tx.put_client_report(r) for r in reports])
        helper.datastore.run_tx(lambda tx: tx.put_task(helper_task))
        assert AggregationJobCreator(leader.datastore).run_once() == 1
        http = HttpClient(timeout=120)
        cfg = JobDriverConfig(max_concurrent_job_workers=1)
        driver = AggregationJobDriver(leader.datastore, http, AggregationJobDriverConfig(http_backoff=Backoff.test()),
                                      device=cuda)
        assert JobDriver(cfg, driver.acquirer(), driver.stepper).run_once() == 1

        collector = Collector(CollectorParameters(task.task_id, servers[1].url, task.collector_auth_token,
                                                  collector_kp), inst, http)
        query = Query.time_interval(Interval(Time(now - 100).to_batch_interval_start(task.time_precision),
                                             task.time_precision))
        job_id = collector.start_collection(query)
        coll_driver = CollectionJobDriver(leader.datastore, http, CollectionJobDriverConfig(http_backoff=Backoff.test()))
        for fn in counters:
            fn.launches = 0
        assert JobDriver(cfg, coll_driver.acquirer(), coll_driver.stepper).run_once() == 1
        assert [fn.launches for fn in counters] == [0, 0, 0]
        result = collector.poll_once(job_id, query)
        accept = np.arange(n) != bad
        assert result.report_count == n - 1
        assert result.aggregate_result == [int(x) for x in meas[accept].sum(axis=0)]
    finally:
        for s in servers:
            s.stop()
        l_agg.close()
        leader.cleanup()
        helper.cleanup()


@pytest.mark.parametrize("bits,level", [(8, 4), (8, 7)])
def test_poplar1_prepare_on_the_card_matches_cpu_and_the_host_walk(cuda, bits, level):
    """The batched IDPF walk and sketch on the card (kernel 1, 2(L+1)+1
    launches a party at level L) against its CPU run and the host walk,
    both parties, an inner (Field64) and the leaf (Field128) level."""
    from janus_tpu_torch.vdaf.poplar1 import Poplar1, Poplar1AggParam
    from janus_tpu_torch.vdaf.poplar1_device import prepare_init_batched

    poplar = Poplar1(bits)
    rng = np.random.default_rng(level)
    alphas = [int(x) for x in rng.integers(0, 1 << bits, size=6)]
    keys = [poplar.shard(a)[1] for a in alphas]
    prefixes = tuple(sorted({a >> (bits - 1 - level) for a in alphas} | {0, (1 << (level + 1)) - 1}))
    param = Poplar1AggParam(level, prefixes)
    nonces = [rng.bytes(16) for _ in alphas]
    vk = bytes(range(16))
    for party in (0, 1):
        party_keys = [k[party] for k in keys]
        keccak_cuda.keccak_single_block.launches = 0
        got = prepare_init_batched(bits, party, party_keys, param, vk, nonces, device=cuda)
        assert keccak_cuda.keccak_single_block.launches == 2 * (level + 1) + 1
        assert got == prepare_init_batched(bits, party, party_keys, param, vk, nonces, device="cpu")
        for i, key in enumerate(party_keys):
            state, msg1 = poplar.prepare_init(party, key, param, vk, nonces[i])
            assert (got[0][i], got[1][i], got[2][i], got[3][i], got[4][i]) == (
                state.y_shares, msg1[0], msg1[1], state.a_share, state.c_share)


def test_port_pair_poplar1_heavy_hitters_on_the_card(cuda):
    """A Poplar1(4) heavy-hitters collection by a port pair on the card:
    uploads through the port's Client, one collection a level driven by
    the collection and aggregation drivers (init on the card, continue on
    the host), the per-prefix counts of each level and the heavy set."""
    import dataclasses

    from janus_tpu_torch.aggregator.aggregation_job_driver import AggregationJobDriver, AggregationJobDriverConfig
    from janus_tpu_torch.aggregator.collection_job_driver import CollectionJobDriver, CollectionJobDriverConfig
    from janus_tpu_torch.aggregator.core import Aggregator
    from janus_tpu_torch.aggregator.http_handlers import DapHttpApp, DapServer
    from janus_tpu_torch.aggregator.job_driver import JobDriver, JobDriverConfig
    from janus_tpu_torch.client import Client, ClientParameters
    from janus_tpu_torch.collector import Collector, CollectorParameters
    from janus_tpu_torch.core.auth import AuthenticationToken
    from janus_tpu_torch.core.hpke import generate_hpke_config_and_private_key
    from janus_tpu_torch.core.http_client import HttpClient
    from janus_tpu_torch.core.retries import Backoff
    from janus_tpu_torch.core.time_util import MockClock
    from janus_tpu_torch.datastore import EphemeralDatastore
    from janus_tpu_torch.messages import Duration, Interval, Query, Role, Time
    from janus_tpu_torch.task import QueryTypeConfig, TaskBuilder
    from janus_tpu_torch.vdaf.poplar1 import Poplar1AggParam

    now, bits, threshold = 1_700_000_000, 4, 2
    meas = [0b1010, 0b1010, 0b1010, 0b0110, 0b0110, 0b0001]
    inst = VdafInstance.poplar1(bits)
    collector_kp = generate_hpke_config_and_private_key(config_id=7)
    leader, helper = EphemeralDatastore(MockClock(Time(now))), EphemeralDatastore(MockClock(Time(now)))
    l_agg = Aggregator(leader.datastore, leader.clock, device=cuda)
    h_agg = Aggregator(helper.datastore, helper.clock, device=cuda)
    servers = [DapServer(DapHttpApp(h_agg)).start(), DapServer(DapHttpApp(l_agg)).start()]
    try:
        task = TaskBuilder(QueryTypeConfig.time_interval(), inst, Role.LEADER).with_(
            vdaf_verify_key=bytes(16), aggregator_auth_token=AuthenticationToken.random_bearer(),
            collector_hpke_config=collector_kp.config, min_batch_size=1, max_batch_query_count=bits + 1,
            leader_aggregator_endpoint=servers[1].url, helper_aggregator_endpoint=servers[0].url,
        ).build()
        helper_task = dataclasses.replace(
            task, role=Role.HELPER, hpke_keys=(generate_hpke_config_and_private_key(config_id=1),)
        )
        leader.datastore.run_tx(lambda tx: tx.put_task(task))
        helper.datastore.run_tx(lambda tx: tx.put_task(helper_task))
        http = HttpClient(timeout=120)
        params = ClientParameters(task.task_id, servers[1].url, servers[0].url, task.time_precision)
        client = Client.with_fetched_configs(params, inst, http, clock=leader.clock)
        for m in meas:
            client.upload(m)

        cfg = JobDriverConfig(max_concurrent_job_workers=1)
        adriver = AggregationJobDriver(leader.datastore, http, AggregationJobDriverConfig(http_backoff=Backoff.test()),
                                       device=cuda)
        cdriver = CollectionJobDriver(leader.datastore, http, CollectionJobDriverConfig(http_backoff=Backoff.test()))
        ajobs = JobDriver(cfg, adriver.acquirer(), adriver.stepper)
        cjobs = JobDriver(cfg, cdriver.acquirer(), cdriver.stepper)
        collector = Collector(CollectorParameters(task.task_id, servers[1].url, task.collector_auth_token,
                                                  collector_kp), inst, http)
        window = Time(now).to_batch_interval_start(task.time_precision)
        query = Query.time_interval(Interval(window, Duration(task.time_precision.seconds)))
        prefixes = [0, 1]
        keccak_cuda.keccak_single_block.launches = 0
        for level in range(bits):
            agg_param = Poplar1AggParam(level, tuple(sorted(prefixes))).encode()
            job_id = collector.start_collection(query, agg_param=agg_param)
            for _ in range(8):
                if not cjobs.run_once() + ajobs.run_once():
                    break
            result = collector.poll_once(job_id, query, agg_param=agg_param)
            want = [sum(1 for m in meas if m >> (bits - 1 - level) == p) for p in sorted(prefixes)]
            assert result.report_count == len(meas) and result.aggregate_result == want
            survivors = [p for p, c in zip(sorted(prefixes), want) if c >= threshold]
            prefixes = [p << 1 for p in survivors] + [(p << 1) | 1 for p in survivors]
        assert survivors == [0b0110, 0b1010]
        # both sides' init steps walked on the card: 2 * sum(2(L+1)+1)
        assert keccak_cuda.keccak_single_block.launches == 2 * sum(2 * (lv + 1) + 1 for lv in range(bits))
    finally:
        for s in servers:
            s.stop()
        l_agg.close()
        h_agg.close()
        leader.cleanup()
        helper.cleanup()


# --- the block-sparse scatter (csrc/scatter_rows.cu) --------------------------------------

P128 = 2**128 - 7 * 2**66 + 1


def _field_rows(shape, seed, device):
    """Random reduced Field128 limbs (lo, hi) of `shape`."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 2**64 - 1, size=shape, dtype=np.uint64, endpoint=True)
    hi = rng.integers(0, (P128 >> 64) - 1, size=shape, dtype=np.uint64)  # < p's high word: reduced
    return tuple(torch.from_numpy(a.view(np.int64)).to(device) for a in (lo, hi))


def _scatter_idx(b, max_blocks, block_size, n_blocks, seed, hot=False, dead_rows=()):
    """flat indices of b reports of 1..max_blocks distinct blocks each (block
    0 in every one when hot), the dead rows all sentinel."""
    from janus_tpu_torch.vdaf.circuits import SparseSumVec
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    rng = np.random.default_rng(seed)
    circ = SparseSumVec(n_blocks * block_size, block_size, max_blocks, 16)
    bi = np.full((b, max_blocks), -1, dtype=np.int32)
    for i in range(b):
        nb = int(rng.integers(1, max_blocks + 1))
        if hot:
            rest = (1 + rng.choice(n_blocks - 1, size=nb - 1, replace=False)).tolist()
            idxs = [0] + sorted(rest)
        else:
            idxs = sorted(rng.choice(n_blocks, size=nb, replace=False).tolist())
        bi[i, :nb] = idxs
    bi[list(dead_rows)] = -1
    return flat_scatter_indices(bi, circ), circ.logical_length


def _runs_idx(case, b, seed):
    """flat indices [b, 3 x 4] of run-shaped cases over 12 blocks of 4:
    every row on one block, runs of two rows alternating between two
    blocks, blocks descending row by row, one block's runs broken by dead
    rows."""
    from janus_tpu_torch.vdaf.circuits import SparseSumVec
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    circ = SparseSumVec(48, 4, 3, 16)
    bi = np.full((b, 3), -1, dtype=np.int32)
    for i in range(b):
        idxs = {"one-block": [5], "sentinel-runs": [5], "alternating": [2, 7] if (i // 2) % 2 == 0 else [7],
                "descending": sorted({11 - i % 12, (11 - 2 * i) % 12})}[case]
        bi[i, : len(idxs)] = idxs
    if case == "sentinel-runs":
        bi[np.random.default_rng(seed).choice(b, size=b // 3, replace=False)] = -1
    return flat_scatter_indices(bi, circ), circ.logical_length


@pytest.mark.parametrize(
    "case,b,mb,bs,nblocks",
    [("hot", 64, 4, 8, 40), ("padding", 32, 3, 4, 12), ("all-sentinel", 16, 3, 4, 12),
     ("north-star", 1024, 16, 64, 15625), ("one-block", 50, 3, 4, 12), ("alternating", 50, 3, 4, 12),
     ("descending", 50, 3, 4, 12), ("sentinel-runs", 50, 3, 4, 12)],
)
def test_scatter_kernel_matches_plain(cuda, case, b, mb, bs, nblocks):
    """Kernel 4 against its plain version, twice, its scratch handed back
    dirty by the allocator before each launch (the copy zeroes it)."""
    dead = {"padding": range(20, 32), "all-sentinel": range(16)}.get(case, ())
    if case in ("one-block", "alternating", "descending", "sentinel-runs"):
        flat, L = _runs_idx(case, b, seed=b)
    else:
        flat, L = _scatter_idx(b, mb, bs, nblocks, seed=b + mb, hot=case in ("hot", "north-star"), dead_rows=dead)
    idx = torch.from_numpy(flat).to(cuda)
    vals = _field_rows(flat.shape, 5, cuda)
    acc = _field_rows((L,), 6, cuda)
    want = scatter_cuda.scatter_rows_plain(acc, vals, idx)
    for _ in range(2):
        dirty = torch.full((scatter_cuda.scratch_bytes(L),), 1, dtype=torch.uint8, device=cuda)
        del dirty
        before = scatter_cuda.scatter_rows.launches
        got = scatter_cuda.scatter_rows(acc, vals, idx)
        torch.cuda.synchronize()
        assert scatter_cuda.scatter_rows.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "all-sentinel":
        assert torch.equal(got[0], acc[0]) and torch.equal(got[1], acc[1])


def test_scatter_kernel_from_threads_and_streams(cuda):
    """Eight threads scatter at once into one L, half of them on side
    streams, so that launches of one stream interleave: each has its own
    marks, and every result equals its plain version."""
    import threading

    flat, L = _scatter_idx(256, 16, 64, 15625, seed=3, hot=True)
    idx = torch.from_numpy(flat).to(cuda)
    acc = _field_rows((L,), 6, cuda)
    inputs = [_field_rows(flat.shape, 10 + k, cuda) for k in range(8)]
    wants = [scatter_cuda.scatter_rows_plain(acc, v, idx) for v in inputs]
    results = [None] * 8
    streams = [torch.cuda.Stream(device=cuda) for _ in range(4)]
    torch.cuda.synchronize()

    def run(k):
        if k % 2:
            with torch.cuda.stream(streams[k // 2]):
                out = [scatter_cuda.scatter_rows(acc, inputs[k], idx) for _ in range(5)][-1]
                torch.cuda.current_stream().synchronize()
        else:
            out = [scatter_cuda.scatter_rows(acc, inputs[k], idx) for _ in range(5)][-1]
        results[k] = out

    threads = [threading.Thread(target=run, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for got, want in zip(results, wants):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sparse_engine_on_the_card_matches_the_cpu(cuda):
    """A small sparse batch with a hot block: the engine's prepare and
    aggregate_sparse on the card equal the CPU's, and kernel 4 launched
    once per party."""
    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.vdaf.testing import sparse_compact_batch
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    inst = VdafInstance.sparse_sumvec(4, 96, 4, 3)
    rng = np.random.default_rng(3)
    meas = []
    for _ in range(40):  # block 0 in every report, then up to 2 of blocks 1..23
        rest = sorted((1 + rng.choice(23, size=int(rng.integers(0, 3)), replace=False)).tolist())
        meas.append([(b, [int(v) for v in rng.integers(0, 16, size=4)]) for b in [0] + rest])
    mask = np.ones(40, dtype=bool)
    mask[[3, 17]] = False
    shares = {}
    for dev in ("cpu", cuda):
        args, _ = make_report_batch(inst, meas, seed=4, device=dev)
        eng = EngineCache(inst, bytes(16), device=dev)
        out0, _, ver0, part0 = eng.leader_init(*args[:5])
        out1, accept, _ = eng.helper_init(args[0], args[1], args[5], args[6], ver0, part0, np.ones(40, dtype=bool))
        assert accept.all()
        flat = flat_scatter_indices(sparse_compact_batch(inst, meas)[1], eng.p3.circ)
        before = scatter_cuda.scatter_rows.launches
        shares[str(dev)] = [eng.aggregate_sparse(out, mask & accept, flat) for out in (out0, out1)]
        if dev != "cpu":
            assert scatter_cuda.scatter_rows.launches == before + 2
    assert shares["cpu"] == shares[str(cuda)]


@pytest.mark.parametrize("kind", ["count", "sumvec"])
def test_merged_two_task_round_on_the_card_equals_solo_rounds(cuda, kind):
    """Two tasks' batches (different verify keys) as solo rounds and as
    one merged round, leader then helper: every value equal bit for bit,
    and equal to the CPU's merged round; the per-lane keys reach kernel 1
    (Count, Field64) and kernel 2 (SumVec, Field128)."""
    from janus_tpu_torch.aggregator import engine_cache as ec
    from janus_tpu_torch.convert import step_args_to_numpy

    inst = VdafInstance.count() if kind == "count" else VdafInstance.sum_vec(1000, 16)
    keys = (bytes(range(16)), bytes(range(16, 32)))
    n = 24
    got = {}
    for dev in ("cpu", cuda):
        engines = [ec.EngineCache(inst, key, device=dev) for key in keys]
        batches = []
        for j in range(2):
            meas = random_measurements(inst, n, np.random.default_rng(50 + j))
            args, _ = make_report_batch(inst, meas, seed=50 + j, device=dev)
            batches.append(step_args_to_numpy(args))
        ok = np.ones(n, dtype=bool)

        def rounds(idx):
            lead = ec._run_leader_round([(engines[j], None, *batches[j][:5]) for j in idx], [n] * len(idx))
            helped = ec._run_helper_round(
                [(engines[j], batches[j][0], batches[j][1], batches[j][5], batches[j][6], lead[k][2], lead[k][3], ok)
                 for k, j in enumerate(idx)], [n] * len(idx))
            return [(o0.to_numpy(), s0, v0, p0, o1.to_numpy(), m1, q1)
                    for (o0, s0, v0, p0), (o1, m1, q1) in zip(lead, helped)]

        solo = rounds([0]) + rounds([1])
        merged = rounds([0, 1])
        for a, b in zip(solo, merged):
            for x, y in zip(a, b):
                if x is None:
                    assert y is None
                    continue
                for xx, yy in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
                    assert np.array_equal(xx, yy)
            assert a[5].all()
        got[str(dev)] = merged
    for a, b in zip(got["cpu"], got[str(cuda)]):
        for x, y in zip(a, b):
            if x is not None:
                for xx, yy in zip(x if isinstance(x, tuple) else (x,), y if isinstance(y, tuple) else (y,)):
                    assert np.array_equal(xx, yy)


def test_sparse_resident_merge_through_kernel_4_matches_plain(cuda):
    """Three sparse jobs' pending deltas merged into one resident slot: on
    the card each merge is one launch of kernel 4 (the slot copied, the
    job's rows added in), and the taken slot equals the CPU's, whose merges
    run the plain scatter."""
    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.messages import Duration, Interval, Time
    from janus_tpu_torch.vdaf.testing import sparse_compact_batch
    from janus_tpu_torch.vdaf.wire import flat_scatter_indices

    inst = VdafInstance.sparse_sumvec(16, 1_000_000, 64, 16)
    iv = Interval(Time(0), Duration(3600))
    taken = {}
    for dev in ("cpu", cuda):
        eng = EngineCache(inst, bytes(16), device=dev)
        before = scatter_cuda.scatter_rows.launches
        for j in range(3):
            rng = np.random.default_rng(60 + j)
            meas = []
            for _ in range(20):  # the hot block 0 in every report
                rest = sorted((1 + rng.choice(15_624, size=int(rng.integers(0, 4)), replace=False)).tolist())
                meas.append([(b, [int(v) for v in rng.integers(0, 1 << 16, size=64)]) for b in [0] + rest])
            args, _ = make_report_batch(inst, meas, seed=60 + j, device=dev)
            out0, _, _, _ = eng.leader_init(*args[:5])
            flat = flat_scatter_indices(sparse_compact_batch(inst, meas)[1], eng.p3.circ)
            lane_bucket = np.zeros(20, np.int32)
            lane_bucket[[2, 11]] = -1
            pend = eng.aggregate_pending(out0, lane_bucket, 1, flat_idx=flat)
            eng.resident_merge([((b"t", b"", b"bid"), 0, 18, iv)], pend)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert scatter_cuda.scatter_rows.launches == before + 3
        (rec,) = eng.resident_take()
        assert rec["rows"] == 54 and len(rec["share"]) == 1_000_000
        taken[str(dev)] = rec["share"]
    assert taken["cpu"] == taken[str(cuda)]


def test_supervised_leader_init_on_the_card_equals_the_unsupervised_one(cuda):
    """A leader init under an armed deadline runs on the dispatch
    watchdog's worker thread, on the caller's (side) stream, and equals the
    unsupervised init bit for bit, prestaged or not, at SumVec(1000, 16)."""
    import threading
    import time

    from janus_tpu_torch.aggregator.engine_cache import EngineCache
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.core.deadline import deadline_scope

    inst = VdafInstance.sum_vec(1000, 16)
    eng = EngineCache(inst, bytes(range(16)), device=cuda)
    meas = random_measurements(inst, 96, np.random.default_rng(60))
    args, _ = make_report_batch(inst, meas, seed=60, device=cuda)
    cols = step_args_to_numpy(args)[:5]
    want = eng.leader_init(*cols)
    seen = []
    real_step = eng._leader_step
    side = torch.cuda.Stream(device=cuda)

    def step(*a):
        seen.append((threading.current_thread().name, torch.cuda.current_stream(cuda) == side))
        return real_step(*a)

    eng._leader_step = step
    with torch.cuda.stream(side), deadline_scope(time.monotonic() + 120):
        pre = eng.prestage_leader(*cols)
        staged = eng.leader_init(*cols, prestaged=pre)
        plain = eng.leader_init(*cols)
    torch.cuda.synchronize()
    assert len(seen) == 2
    assert all(name.startswith("device-watchdog-") and on_side for name, on_side in seen)
    assert eng.prestage_stats["used"] == 1
    for got in (staged, plain):
        assert all(np.array_equal(a, b) for a, b in zip(got[0].to_numpy(), want[0].to_numpy()))
        assert all(np.array_equal(a, b) for a, b in zip(got[2], want[2]))
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[3], want[3])


def test_mesh_engine_on_one_card_equals_the_single_device_engine(cuda):
    """A dp = 2 mesh of [cuda:0, cuda:0] (the rehearsal on one card) serves
    SumVec(1000, 16) like the single-device engine, bit for bit: leader and
    helper init, masked aggregates with rejected lanes, aggregate_pending,
    a resident merge and the take; each shard launches kernels 1 and 2, on
    the lane thread; then sharded_two_party_step at dp = 1, sp = 2 on a
    long-enough SumVec equals two_party_step."""
    from janus_tpu_torch.aggregator import engine_cache as ec
    from janus_tpu_torch.convert import step_args_to_numpy
    from janus_tpu_torch.messages import Duration, Interval, Time
    from janus_tpu_torch.ops import cuda_build

    inst = VdafInstance.sum_vec(1000, 16)
    dev = torch.device("cuda", 0)
    mesh_eng = ec.EngineCache(inst, bytes(range(16)), devices=[dev, dev])
    single = ec.EngineCache(inst, bytes(range(16)), device=dev)
    assert (mesh_eng.dp, mesh_eng.sp, mesh_eng.mesh.distinct) == (2, 1, False)
    n, k = 200, 2
    args, _ = make_report_batch(inst, random_measurements(inst, n, np.random.default_rng(61)), seed=61, device=dev)
    nonce, parts, meas, proof, blind0, hseed, blind1 = step_args_to_numpy(args)
    ok = np.ones(n, dtype=bool)
    ok[::7] = False
    iv = Interval(Time(0), Duration(3600))
    got = {}
    for name, eng in (("single", single), ("mesh", mesh_eng)):
        cuda_build.reset_shard_launches()
        out0, seed0, ver0, part0 = eng.leader_init(nonce, parts, meas, proof, blind0)
        out1, mask, prep = eng.helper_init(nonce, parts, hseed, blind1, ver0, part0, ok)
        pend = eng.aggregate_pending(out0, np.where(ok, np.arange(n) % k, -1).astype(np.int32), k)
        eng.resident_merge([((b"t", b"", bytes([j])), j, n // k, iv) for j in range(k)], pend)
        got[name] = (
            [x.tolist() for x in out0.to_numpy()], seed0.tolist(), [x.tolist() for x in ver0], part0.tolist(),
            mask.tolist(), prep.tolist(), eng.aggregate(out0, ok), eng.aggregate(out1, ok),
            sorted((r["key"], r["share"]) for r in eng.resident_take()),
        )
        if name == "mesh":
            per_shard = cuda_build.shard_launches()
            for kernel in ("keccak_single_block", "expand_f128"):
                assert set(per_shard[kernel]) == {0, 1} and min(per_shard[kernel].values()) > 0
    torch.cuda.synchronize()
    assert got["mesh"] == got["single"]
    assert ec._MESH_QUEUE.status()["lane_alive"]

    long_inst = VdafInstance.sum_vec(4096, 4)
    meas = random_measurements(long_inst, 4, np.random.default_rng(62))
    args, _ = make_report_batch(long_inst, meas, seed=62, device=dev)
    want = api.two_party_step(long_inst, bytes(16), device=dev)(*args)
    mesh = api.make_mesh(1, 2, [dev, dev])
    got = api.sharded_two_party_step(long_inst, bytes(16), mesh)(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0])) and int(got[2]) == int(want[2]) == 4


def test_kernel_1_launches_on_its_inputs_card_not_the_current_one(cuda):
    """Kernel 1's two launches run inside their device's guard: on cuda:1
    while cuda:0 is current they equal the plain version (without the
    guard the launch would take cuda:0 with cuda:1's stream)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev1 = torch.device("cuda", 1)
    with torch.cuda.device(0):
        parts = _prefix_parts(5, 21, dev1)
        want = keccak_cuda.keccak_ctr_blocks_plain(parts, 10, 5, 33, 21, dev1, ctr_offset=7)
        got = keccak_cuda.keccak_ctr_blocks(parts, 10, 5, 33, 21, dev1, ctr_offset=7)
        tparts = [(0, bytes(8)), (1, _lanes((6, 2), 3, dev1)), (3, _lanes((6, 4000), 4, dev1))]
        twant = keccak_cuda.keccak_tree_level_plain(tparts, 4003, 6, 0, 32024, dev1)
        tgot = keccak_cuda.keccak_tree_level(tparts, 4003, 6, 0, 32024, dev1)
        torch.cuda.synchronize(dev1)
    assert torch.equal(got, want) and torch.equal(tgot, twant)
