"""Fleet sharding in janus_tpu_torch, held against janus_tpu.

The port's counterparts of tests/test_fleet.py's 16 tests, each on both
datastore engines (SQLite and the Postgres engine over pg_fake) and, where
a property holds for each package alone, on both packages:

- the shard key, the replica holder tag, lease_holder_hex and
  FleetConfig (shard_spec, holder_tag, from_dict with no environment
  overrides) equal janus_tpu's on the same inputs;
- a scripted claim sequence under a MockClock (the shard partition, the
  steal fence, own shard first, the hand-back, an expired lease
  reacquired) leaves the same job rows (state, lease_expiry, attempts,
  shard_key, holder hex) in both packages, up to the random token bytes;
- record_acquire's counts and the acquirers' status() equal the deltas of
  janus_tpu's lease_acquire_tx_total, lease_acquired_jobs_total and
  lease_steals_total, and a parked acquirer records no claim in either;
- the datastore's lease-conflict counts equal janus_tpu's
  lease_conflicts_total deltas;
- the creator's _shard_filter sweeps the same task ids at every pass of a
  scripted timeline;
- JobDriver(releaser=) hands a step that fails during a drain back
  (shard_key -1, attempt refunded) through the serial stepper and through
  StepPipeline, does not outside a drain, and only logs a failing
  releaser;
- both drivers' acquirer(fleet=) mint tokens carrying the holder tag.

Last, chip_smoke.py's fleet-drill phase runs on the CPU at Prio3Count: two
drivers (shards 0 and 1) over one datastore, one drains with a hand-back,
the other finishes every job, and both collections equal the ground truth.
No VDAF program compiles on the janus_tpu side. Tolerance: exact equality.
"""

import threading
import types

import numpy as np
import pytest

from janus_tpu import config as j_config
from janus_tpu import messages as jm
from janus_tpu import metrics as j_metrics
from janus_tpu import task as j_task
from janus_tpu.aggregator import aggregation_job_creator as j_creator
from janus_tpu.aggregator import aggregation_job_driver as j_agg
from janus_tpu.aggregator import collection_job_driver as j_coll
from janus_tpu.aggregator import job_driver as j_jd
from janus_tpu.aggregator import step_pipeline as j_pipe
from janus_tpu.core import time_util as j_time
from janus_tpu.datastore import models as j_models
from janus_tpu.datastore import store as j_store
from janus_tpu.vdaf.registry import VdafInstance as JVdafInstance
from janus_tpu_torch import config as t_config
from janus_tpu_torch import messages as tm
from janus_tpu_torch import task as t_task
from janus_tpu_torch.aggregator import aggregation_job_creator as t_creator
from janus_tpu_torch.aggregator import aggregation_job_driver as t_agg
from janus_tpu_torch.aggregator import collection_job_driver as t_coll
from janus_tpu_torch.aggregator import job_driver as t_jd
from janus_tpu_torch.aggregator import step_pipeline as t_pipe
from janus_tpu_torch.core import time_util as t_time
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.datastore import store as t_store

NOW = 1_600_000_000
ENGINES = ["sqlite", "pgfake"]
PKGS = {
    "janus_tpu": types.SimpleNamespace(
        store=j_store, models=j_models, m=jm, time=j_time, task=j_task, config=j_config, jd=j_jd, agg=j_agg,
        coll=j_coll, creator=j_creator, pipe=j_pipe, driver_kw={}),
    "torch": types.SimpleNamespace(
        store=t_store, models=t_models, m=tm, time=t_time, task=t_task, config=t_config, jd=t_jd, agg=t_agg,
        coll=t_coll, creator=t_creator, pipe=t_pipe, driver_kw={"device": "cpu"}),
}
JANUS_ENV = ("JANUS_REPLICA_ID", "JANUS_SHARD_COUNT", "JANUS_SHARD_INDEX", "JANUS_STEAL_AFTER_S")


@pytest.fixture(autouse=True)
def _no_fleet_env(monkeypatch):
    """janus_tpu's FleetConfig reads these; an inherited one would make its
    side differ from the dict alone."""
    for var in JANUS_ENV:
        monkeypatch.delenv(var, raising=False)


def _j_task(task_id: bytes | None = None):
    b = j_task.TaskBuilder(j_task.QueryTypeConfig.time_interval(), JVdafInstance.count(), jm.Role.LEADER)
    b = b.with_(min_batch_size=1)
    if task_id is not None:
        b = b.with_(task_id=jm.TaskId(task_id))
    return b.build()


class Side:
    """One package's datastore (engine `engine`, a MockClock at NOW) with one
    leader Count task, the same task in both packages."""

    def __init__(self, name: str, engine: str, j_task_obj):
        self.name = name
        self.p = p = PKGS[name]
        self.clock = p.time.MockClock(p.m.Time(NOW))
        self.eph = p.store.EphemeralDatastore(clock=self.clock, engine=engine)
        self.ds = self.eph.datastore
        self.task = j_task_obj if name == "janus_tpu" else t_task.Task.from_dict(j_task_obj.to_dict())
        self.ds.run_tx(lambda tx: tx.put_task(self.task))

    def put_job(self, job_id: bytes):
        m = self.p.m
        job = self.p.models.AggregationJobModel(
            self.task.task_id, m.AggregationJobId(job_id), b"", b"\x01", m.Interval(m.Time(NOW), m.Duration(1)),
            self.p.models.AggregationJobState.IN_PROGRESS, 0)
        self.ds.run_tx(lambda tx: tx.put_aggregation_job(job))
        return job

    def put_jobs(self, n: int) -> list[bytes]:
        return [self.put_job(i.to_bytes(16, "big")).job_id.data for i in range(n)]

    def claim(self, limit: int, lease_s: int = 600, shard=None, holder=None):
        spec = None if shard is None else self.p.models.ShardSpec(*shard)
        return self.ds.run_tx(lambda tx: tx.acquire_incomplete_aggregation_jobs(
            self.p.m.Duration(lease_s), limit, shard=spec, holder=holder), "acq")

    def advance(self, secs: int) -> None:
        self.clock.advance(self.p.m.Duration(secs))

    def rows(self, holder: bool = False):
        """(job id, state, lease_expiry, attempts, shard_key, held, holder
        hex if `holder`) of every job: everything but the random token."""
        def read(tx):
            return tx._c.execute("SELECT job_id, state, lease_expiry, lease_attempts, shard_key, lease_token"
                                 " FROM aggregation_jobs ORDER BY job_id").fetchall()

        return [(bytes(j), st, int(exp), att, sk, tok is not None,
                 self.p.store.lease_holder_hex(bytes(tok)) if holder and tok is not None else None)
                for j, st, exp, att, sk, tok in self.ds.run_tx(read, "rows")]

    def cleanup(self):
        self.eph.cleanup()


@pytest.fixture
def sides(request):
    made = []

    def make(engine: str, task_id: bytes | None = None):
        jt = _j_task(task_id)
        out = [Side(n, engine, jt) for n in PKGS]
        made.extend(out)
        return out

    yield make
    for s in made:
        s.cleanup()


def _ids(acquired):
    return sorted(a.job_id.data for a in acquired)


def _own(task_id: bytes, job_ids, count: int, index: int) -> set:
    return {j for j in job_ids if t_store.job_shard_key(task_id, j) % count == index}


# --- 1: the shard key ------------------------------------------------------------


def test_shard_key_is_stable_and_bounded():
    """Same (task, job) identity, same key in both packages; keys stay in
    the modulo space and spread."""
    rng = np.random.default_rng(11)
    t = rng.bytes(32)
    keys = [t_store.job_shard_key(t, rng.bytes(16)) for _ in range(256)]
    rng = np.random.default_rng(11)
    t = rng.bytes(32)
    assert keys == [j_store.job_shard_key(t, rng.bytes(16)) for _ in range(256)]
    assert t_store.SHARD_KEY_SPACE == j_store.SHARD_KEY_SPACE
    assert all(0 <= k < t_store.SHARD_KEY_SPACE for k in keys) and len(set(keys)) > 200
    assert t_store.job_shard_key(t, b"") == j_store.job_shard_key(t, b"")  # a task's creator shard


def test_holder_tag_and_holder_hex_match_janus_tpu():
    for rid in ("replica-7", "a", "b", "", "host-1234", "ünïcode"):
        assert t_store.replica_holder_tag(rid) == j_store.replica_holder_tag(rid)
        assert len(t_store.replica_holder_tag(rid)) == 8
    for token in (None, b"", bytes(range(16)), t_store.make_lease_token(b"abc")):
        assert t_store.lease_holder_hex(token) == j_store.lease_holder_hex(token)
    assert t_store.HANDBACK_SHARD_KEY == j_store.HANDBACK_SHARD_KEY == -1


# --- 2: racing handles ---------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("engine", ENGINES)
def test_batched_claim_partitions_exactly_across_racing_handles(sides, engine, pkg):
    """Four threads racing batched claims over 24 rows partition them
    exactly; each claim transaction shares one token, tokens differ
    between transactions."""
    side = dict(zip(PKGS, sides(engine)))[pkg]
    side.put_jobs(24)
    acquired, lock = [], threading.Lock()

    def worker():
        got = side.claim(12)
        with lock:
            acquired.extend(got)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    ids = [a.job_id.data for a in acquired]
    assert len(ids) == len(set(ids)) == 24
    assert len({a.lease.token for a in acquired}) >= 2


# --- 3-6: the scripted claim sequences, row for row --------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_expired_lease_reacquired_with_monotone_attempts(sides, engine):
    out = []
    for side in sides(engine):
        side.put_job(bytes(16))
        (a1,) = side.claim(4, lease_s=10)
        step = [(a1.lease.attempts, side.rows())]
        assert side.claim(4, lease_s=10) == []  # not yet expired
        side.advance(60)
        (a2,) = side.claim(4)
        step.append((a2.lease.attempts, a2.lease.token != a1.lease.token, side.rows()))
        with pytest.raises(side.p.store.LeaseConflict):
            with side.ds.tx() as tx:
                tx.release_aggregation_job(a1)
        side.ds.run_tx(lambda tx: tx.release_aggregation_job(a2))
        step.append(side.rows())
        out.append(step)
    assert out[0] == out[1]
    assert [s[0] for s in out[1][:2]] == [1, 2]


@pytest.mark.parametrize("engine", ENGINES)
def test_shard_predicate_and_steal_after_delay(sides, engine):
    """Replica 0 of 2 claims only its own shard at once; the other shard
    only after steal_after_s of eligibility. Both packages claim the same
    jobs at each step and leave the same rows."""
    out = []
    for side in sides(engine):
        ids = side.put_jobs(32)
        own = _own(side.task.task_id.data, ids, 2, 0)
        assert 0 < len(own) < len(ids)
        got = [_ids(side.claim(64, shard=(2, 0, 30)))]
        assert set(got[0]) == own
        side.advance(10)
        got.append(_ids(side.claim(64, shard=(2, 0, 30))))
        assert got[1] == []
        side.advance(31)
        got.append(_ids(side.claim(64, shard=(2, 0, 30))))
        assert set(got[2]) == set(ids) - own
        out.append((got, side.rows()))
    assert out[0] == out[1]


@pytest.mark.parametrize("engine", ENGINES)
def test_own_shard_claims_before_stolen_rows(sides, engine):
    out = []
    for side in sides(engine):
        ids = side.put_jobs(32)
        own = _own(side.task.task_id.data, ids, 2, 0)
        side.advance(60)  # every row past any steal delay
        got = side.claim(len(own), shard=(2, 0, 1))
        assert set(_ids(got)) == own
        out.append((_ids(got), side.rows()))
    assert out[0] == out[1]


@pytest.mark.parametrize("engine", ENGINES)
def test_shutdown_handback_is_instantly_stealable(sides, engine):
    """A hand-back releases the shard affinity: the other shard claims it
    at once, as a hand-back and not a steal; a plain step-back stays fenced.
    record_acquire on the same claim counts what janus_tpu's metrics do."""
    out = []
    for side in sides(engine):
        ids = side.put_jobs(16)
        own1 = _own(side.task.task_id.data, ids, 2, 1)
        assert side.ds.run_tx(lambda tx: tx.acquire_incomplete_collection_jobs(side.p.m.Duration(600), 1)) == []
        held = sorted(side.claim(64, shard=(2, 1, 30)), key=lambda a: a.job_id.data)
        assert {a.job_id.data for a in held} == own1
        half = max(1, len(held) // 2)
        handed, fenced = held[:half], held[half:]

        def give_back(tx):
            for a in handed:
                tx.step_back_aggregation_job(a, 0, handback=True)
            for a in fenced:
                tx.step_back_aggregation_job(a, 0)

        side.ds.run_tx(give_back)
        rows_back = side.rows()
        crossed = side.claim(64, shard=(2, 0, 30))
        foreign = {a.job_id.data for a in crossed} & own1
        assert foreign == {a.job_id.data for a in handed}
        assert all(a.shard_key < 0 for a in crossed if a.job_id.data in foreign)
        shard0 = side.p.models.ShardSpec(2, 0, 30)
        if side.name == "janus_tpu":
            before = _j_counts("aggregation")
            j_jd.record_acquire("aggregation", crossed, shard0)
            counts = _j_delta(before, _j_counts("aggregation"))
        else:
            c = t_jd.record_acquire("aggregation", crossed, shard0)
            assert c["handbacks"] == len(handed)
            counts = {"claimed": 1, "empty": 0, "jobs": c["jobs"], "steals": c["steals"]}
        assert counts["steals"] == 0
        out.append((_ids(crossed), sorted((a.job_id.data, a.shard_key) for a in crossed), rows_back, side.rows(),
                    counts))
    assert out[0] == out[1]


# --- 7: the parked acquirer --------------------------------------------------------------


def _j_counts(kind: str) -> dict:
    return {"claimed": j_metrics.lease_acquire_tx_total.get(kind=kind, outcome="claimed"),
            "empty": j_metrics.lease_acquire_tx_total.get(kind=kind, outcome="empty"),
            "jobs": j_metrics.lease_acquired_jobs_total.get(kind=kind),
            "steals": j_metrics.lease_steals_total.get(kind=kind)}


def _j_delta(before: dict, after: dict) -> dict:
    return {k: int(after[k] - before[k]) for k in before}


def _t_counts(status: dict) -> dict:
    return {**status["claim_tx"], "jobs": status["jobs"], "steals": status["steals"]}


@pytest.mark.parametrize("engine", ENGINES)
def test_parked_acquirer_records_no_claim_tx(sides, engine):
    """An acquirer parked on a datastore outage runs no claim transaction
    and records none, in either package; healthy again, the claim counts."""
    out = []
    for side in sides(engine):
        side.put_job(bytes(16))
        acquire = side.p.agg.AggregationJobDriver(side.ds, None, **side.p.driver_kw).acquirer(600)
        counts = (lambda: _j_counts("aggregation")) if side.name == "janus_tpu" else (
            lambda: _t_counts(acquire.status()))
        before = counts()
        side.ds.supervisor = types.SimpleNamespace(state="down", stop=lambda: None)
        assert acquire(4) == []
        parked = _j_delta(before, counts())
        side.ds.supervisor = None
        assert len(acquire(4)) == 1
        out.append((parked, _j_delta(before, counts())))
    assert out[0] == out[1]
    assert out[1] == ({"claimed": 0, "empty": 0, "jobs": 0, "steals": 0},
                      {"claimed": 1, "empty": 0, "jobs": 1, "steals": 0})


# --- 8-9: the claim window ----------------------------------------------------------------


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("engine", ENGINES)
def test_claim_order_is_randomized_within_the_window(sides, engine, pkg):
    seen = set()
    for _ in range(8):
        side = dict(zip(PKGS, sides(engine)))[pkg]
        side.put_jobs(20)
        (a,) = side.claim(1)
        seen.add(a.job_id.data)
    assert len(seen) > 1


@pytest.mark.parametrize("pkg", list(PKGS))
@pytest.mark.parametrize("engine", ENGINES)
def test_claim_window_prefers_oldest_under_deep_backlog(sides, engine, pkg):
    side = dict(zip(PKGS, sides(engine)))[pkg]
    by_age = []
    for i in range(96):
        by_age.append(side.put_job(i.to_bytes(16, "big")).job_id.data)
        side.advance(1)
    claimed = 0
    for _ in range(6):
        got = side.claim(4)
        assert got and {a.job_id.data for a in got} <= set(by_age[: 64 + claimed])
        claimed += len(got)


# --- 10: lease conflicts -----------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_lease_conflict_counted_and_fatal(sides, engine):
    """A token mismatch on release and on step-back counts once each, by
    kind and op (janus_tpu's lease_conflicts_total, the port's datastore
    status()), and classifies fatal."""
    out = []
    for side in sides(engine):
        side.put_job(bytes(16))
        (a1,) = side.claim(1, lease_s=10)
        side.advance(60)
        (a2,) = side.claim(1)
        ops = (("aggregation", "release"), ("aggregation", "step_back"))
        before = [j_metrics.lease_conflicts_total.get(kind=k, op=o) for k, o in ops]
        errors = []
        for fn in (lambda tx: tx.release_aggregation_job(a1), lambda tx: tx.step_back_aggregation_job(a1)):
            with pytest.raises(side.p.store.LeaseConflict) as ei:
                side.ds.run_tx(fn)
            errors.append(ei.value)
        if side.name == "janus_tpu":
            counts = [int(j_metrics.lease_conflicts_total.get(kind=k, op=o) - b) for (k, o), b in zip(ops, before)]
        else:
            st = side.ds.status()["lease_conflicts"]
            counts = [st[k][o] for k, o in ops]
            assert [(e.kind, e.op) for e in errors] == list(ops)
        assert side.ds.classify_error(side.p.store.LeaseConflict("x")) == "fatal"
        side.ds.run_tx(lambda tx: tx.release_aggregation_job(a2))
        out.append((counts, side.rows()))
    assert out[0] == out[1] and out[1][0] == [1, 1]


# --- 11: provenance ---------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_lease_token_carries_replica_provenance(sides, engine):
    out = []
    for side in sides(engine):
        side.put_job(bytes(16))
        tag = side.p.store.replica_holder_tag("replica-7")
        (a,) = side.claim(1, holder=tag)
        assert a.lease.token[:8] == tag and side.p.store.lease_holder_hex(a.lease.token) == tag.hex()
        holders = side.ds.run_tx(lambda tx: tx.get_lease_holders())
        out.append(([(h[0], bytes(h[1]), bytes(h[2]), h[3], h[4]) for h in holders], side.rows(holder=True)))
    assert out[0] == out[1]
    assert [(h[0], h[3]) for h in out[1][0]] == [("aggregation", t_store.replica_holder_tag("replica-7").hex())]


# --- 12-13: FleetConfig --------------------------------------------------------------------


FLEET_CASES = {
    "four_shards": {"replica_id": "r-1", "shard_count": 4, "shard_index": 2, "steal_after_secs": 5},
    "fractional_steal": {"replica_id": "r-2", "shard_count": 2, "shard_index": 1, "steal_after_secs": 0.5},
    "index_out_of_range": {"replica_id": "r-3", "shard_count": 2, "shard_index": 5, "steal_after_secs": 30},
    "negative_steal": {"replica_id": "r-4", "shard_count": 3, "shard_index": 0, "steal_after_secs": -2},
    "string_values": {"replica_id": "r-5", "shard_count": "8", "shard_index": "3", "steal_after_secs": "2.5"},
    "unsharded": {"replica_id": "solo"},
    "zero_count": {"replica_id": "z", "shard_count": 0},
    "empty": None,
}


def _fleet_view(cfg, store):
    spec = cfg.shard_spec()
    return (cfg.replica_id, cfg.shard_count, cfg.shard_index, cfg.steal_after_secs,
            None if spec is None else (spec.shard_count, spec.shard_index, spec.steal_after_s, spec.active),
            cfg.holder_tag() if cfg.replica_id else None)


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_fleet_config_matches_janus_tpu(case):
    d = FLEET_CASES[case]
    want = _fleet_view(j_config.FleetConfig.from_dict(d), j_store)
    assert _fleet_view(t_config.FleetConfig.from_dict(d), t_store) == want
    if case == "fractional_steal":
        assert want[4] == (2, 1, 1, True)  # ceil: a 0.5 s steal fences 1 s, never 0
    if case == "index_out_of_range":
        assert want[4][1] == 1


def test_fleet_config_reads_no_environment(monkeypatch):
    """janus_tpu's env overrides win over its dict; the port reads the dict
    alone (a divergence by design)."""
    for var, value in zip(JANUS_ENV, ("env-r", "8", "5", "2.5")):
        monkeypatch.setenv(var, value)
    d = {"replica_id": "yaml-r", "shard_count": 2}
    j = j_config.FleetConfig.from_dict(d)
    assert (j.replica_id, j.shard_count, j.shard_index, j.steal_after_secs) == ("env-r", 8, 5, 2.5)
    t = t_config.FleetConfig.from_dict(d)
    assert (t.replica_id, t.shard_count, t.shard_index, t.steal_after_secs) == ("yaml-r", 2, 0, 30.0)
    assert t_config.FleetConfig.from_dict(None).shard_spec() is None


def test_replica_identity_matches_janus_tpu():
    """The counterpart of janus_tpu's replica-label test (its metric labels
    are not ported): the default identity is hostname-pid in both, and the
    holder tag follows the resolved id."""
    assert t_config.default_replica_id() == j_metrics.default_replica_id()
    for rid in (None, "fleet-a"):
        j, t = j_config.FleetConfig(replica_id=rid), t_config.FleetConfig(replica_id=rid)
        assert t.resolved_replica_id() == j.resolved_replica_id()
        assert t.holder_tag() == j.holder_tag()


# --- 14: the driver acquirer's counts ------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_acquirer_records_claim_and_steal_counts(sides, engine):
    """acquirer(fleet=) over 16 stealable jobs: one claim transaction, 16
    jobs, the foreign ones counted as steals, in both packages."""
    out = []
    for side in sides(engine):
        ids = side.put_jobs(16)
        side.advance(60)
        fleet = side.p.config.FleetConfig(replica_id="r-0", shard_count=2, shard_index=0, steal_after_secs=1)
        acquire = side.p.agg.AggregationJobDriver(side.ds, None, **side.p.driver_kw).acquirer(600, fleet=fleet)
        before = _j_counts("aggregation")
        got = acquire(16)
        if side.name == "janus_tpu":
            counts = _j_delta(before, _j_counts("aggregation"))
        else:
            counts = _t_counts(acquire.status())
            assert acquire.status()["shard"] == {"count": 2, "index": 0, "steal_after_s": 1}
        own = _own(side.task.task_id.data, ids, 2, 0)
        assert counts == {"claimed": 1, "empty": 0, "jobs": 16, "steals": 16 - len(own)}
        assert all(a.lease.token[:8] == fleet.holder_tag() for a in got)
        out.append((counts, side.rows(holder=True)))
    assert out[0] == out[1]


# --- record_acquire on the same acquired lists ------------------------------------------------


RECORD_CASES = {
    "empty": ("aggregation", [], (2, 0, 30)),
    "unsharded": ("aggregation", [0, 1, -1, 3], None),
    "sharded": ("aggregation", [0, 1, -1, None, 4, 7], (2, 0, 30)),
    "index_out_of_range": ("aggregation", [0, 1, 2, 3, -1], (2, 3, 30)),
    "one_shard": ("aggregation", [0, 1], (1, 0, 30)),
    "collection": ("collection", [5, 6, -1, None], (3, 2, 30)),
}


def _acquired(p, kind: str, task_id: bytes, keys):
    m = p.m
    out = []
    for i, sk in enumerate(keys):
        lease = p.models.Lease(bytes(16), m.Time(NOW), 1)
        if kind == "aggregation":
            out.append(p.models.AcquiredAggregationJob(m.TaskId(task_id), m.AggregationJobId(bytes([i]) * 16),
                                                       lease, shard_key=sk))
        else:
            out.append(p.models.AcquiredCollectionJob(m.TaskId(task_id), m.CollectionJobId(bytes([i]) * 16),
                                                      lease, shard_key=sk))
    return out


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_record_acquire_matches_janus_tpu_metrics(case):
    kind, keys, shard = RECORD_CASES[case]
    task_id = bytes(range(32))
    j_shard = None if shard is None else j_models.ShardSpec(*shard)
    before = _j_counts(kind)
    j_jd.record_acquire(kind, _acquired(PKGS["janus_tpu"], kind, task_id, keys), j_shard)
    want = _j_delta(before, _j_counts(kind))
    t_shard = None if shard is None else t_models.ShardSpec(*shard)
    got = t_jd.record_acquire(kind, _acquired(PKGS["torch"], kind, task_id, keys), t_shard)
    assert {"claimed": int(got["outcome"] == "claimed"), "empty": int(got["outcome"] == "empty"),
            "jobs": got["jobs"], "steals": got["steals"]} == want
    assert got["handbacks"] == sum(1 for k in keys if k is not None and k < 0)


# --- 15: the creator's shard filter ------------------------------------------------------------


def _task_ids_by_shard(seed: int, want: list[int]) -> list[bytes]:
    """Task ids from the seed whose creator shard (of 2) is want[i]."""
    rng = np.random.default_rng(seed)
    out = []
    for shard in want:
        while True:
            tid = rng.bytes(32)
            if t_store.job_shard_key(tid, b"") % 2 == shard and tid not in out:
                out.append(tid)
                break
    return out


class CreatorSide:
    """One package's creator replica (shard 0 of 2, steal after 30 s) over
    its own datastore, with the given leader Count tasks."""

    def __init__(self, name: str, engine: str, j_tasks):
        self.p = p = PKGS[name]
        self.name = name
        self.clock = p.time.MockClock(p.m.Time(NOW))
        self.eph = p.store.EphemeralDatastore(clock=self.clock, engine=engine)
        self.ds = self.eph.datastore
        self.tasks = [t if name == "janus_tpu" else t_task.Task.from_dict(t.to_dict()) for t in j_tasks]
        for t in self.tasks:
            self.ds.run_tx(lambda tx, t=t: tx.put_task(t))
        self.creator = p.creator.AggregationJobCreator(
            self.ds, p.creator.AggregationJobCreatorConfig(min_aggregation_job_size=1, max_concurrent_tasks=1),
            fleet=p.config.FleetConfig(replica_id="c-0", shard_count=2, shard_index=0, steal_after_secs=30))
        self.swept: list[bytes] = []
        real = self.creator.create_jobs_for_task

        def recording(task):
            self.swept.append(task.task_id.data)
            return real(task)

        self.creator.create_jobs_for_task = recording
        self._rid = 0

    def put_reports(self, i: int, n: int) -> None:
        m, models = self.p.m, self.p.models
        task = self.tasks[i]

        def put(tx):
            for _ in range(n):
                self._rid += 1
                tx.put_client_report(models.LeaderStoredReport(
                    task.task_id, m.ReportId(self._rid.to_bytes(16, "big")), m.Time(NOW), b"", b"x",
                    m.HpkeCiphertext(m.HpkeConfigId(0), b"", b"")))

        self.ds.run_tx(put)

    def owner_progress(self, i: int) -> None:
        """The owning replica claims one report of task i."""
        self.ds.run_tx(lambda tx: tx.get_unaggregated_client_reports_for_task(self.tasks[i].task_id, 1),
                       "owner_progress")

    def run_pass(self, at: int, failing_scan: bool = False):
        self.clock.advance(self.p.m.Duration(at - self.clock.now().seconds))
        self.swept = []
        real_run_tx = self.ds.run_tx
        if failing_scan:
            def run_tx(fn, name="tx", *a, **kw):
                if name == "creator_lag_scan":
                    raise RuntimeError("lag scan failed")
                return real_run_tx(fn, name, *a, **kw)

            self.ds.run_tx = run_tx
        try:
            created = self.creator.run_once()
        finally:
            self.ds.run_tx = real_run_tx
        c = self.creator
        return (created, sorted(self.swept), sorted(c._foreign_backlog_first_seen),
                sorted(c._foreign_backlog_first_seen.values()), sorted(c._stealing))

    def cleanup(self):
        self.eph.cleanup()


@pytest.mark.parametrize("engine", ENGINES)
def test_creator_shard_preference_with_steal(engine):
    """tests/test_fleet.py's timeline in both packages: own task only, then
    owner progress resets the window, then the foreign task is stolen, then
    its drained backlog clears the timer and the steal."""
    ids = _task_ids_by_shard(5, [0, 1])
    j_tasks = [_j_task(t) for t in ids]
    out = []
    for name in PKGS:
        side = CreatorSide(name, engine, j_tasks)
        try:
            side.put_reports(0, 3)
            side.put_reports(1, 3)
            steps = [side.run_pass(NOW)]
            side.owner_progress(1)
            steps.append(side.run_pass(NOW + 60))
            steps.append(side.run_pass(NOW + 120))
            steps.append(side.run_pass(NOW + 180))
            out.append(steps)
        finally:
            side.cleanup()
    assert out[0] == out[1]
    assert [s[0] for s in out[1]] == [1, 0, 1, 0]
    assert out[1][3][2:] == ([], [], [])  # the timer and the steal pruned


@pytest.mark.parametrize("engine", ENGINES)
def test_creator_swept_tasks_match_janus_tpu_timeline(engine):
    """A scripted timeline, the same swept task ids at every pass in both
    packages: an own task; a foreign task whose backlog stays static (stolen
    at the first scan a whole window after it was first seen, then swept
    every pass while its backlog lasts); a foreign task whose owner makes
    progress until NOW+70 (never stolen while it does, stolen once it
    stops); the scans at steal_after cadence; pruning; a failed scan."""
    ids = _task_ids_by_shard(9, [0, 1, 1])
    j_tasks = [_j_task(t) for t in ids]
    out = []
    for name in PKGS:
        side = CreatorSide(name, engine, j_tasks)
        try:
            side.put_reports(0, 2)
            side.put_reports(1, 2)
            side.put_reports(2, 40)
            script = []
            for at, progress, more, fail in (
                (NOW, False, (), False),  # scan: both foreign tasks first seen
                (NOW + 10, True, (), False),  # between scans: own only
                (NOW + 30, False, (1,), False),  # scan: the static task stolen; the progressing one restarted
                (NOW + 40, True, (1,), False),  # sticky: the stolen task swept between scans
                (NOW + 60, False, (), False),  # scan: both have a backlog again, one progressed
                (NOW + 70, True, (), False),
                (NOW + 90, False, (), True),  # a failed scan: own and sticky only
                (NOW + 120, False, (), False),  # the owner stopped: the window runs
                (NOW + 150, False, (), False),  # stolen
                (NOW + 160, False, (), False),
                (NOW + 180, False, (), False),  # drained: pruned
            ):
                if progress:
                    side.owner_progress(2)
                for i in more:
                    side.put_reports(i, 1)
                script.append(side.run_pass(at, failing_scan=fail))
            out.append(script)
        finally:
            side.cleanup()
    assert out[0] == out[1]
    swept = [[ids.index(t) for t in step[1]] for step in out[1]]
    assert swept[0] == [0] and swept[1] == [0]
    assert 1 in swept[2] and 2 not in swept[2]
    assert any(2 in s for s in swept[7:]) and out[1][-1][4] == []


# --- 16: collection jobs -----------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_collection_job_claims_shard_and_partition(sides, engine):
    out = []
    for side in sides(engine):
        p = side.p

        def put_cj(tx, i):
            tx.put_collection_job(p.models.CollectionJobModel(
                side.task.task_id, p.m.CollectionJobId(i.to_bytes(16, "big")), b"q%d" % i, b"", b"b",
                p.models.CollectionJobState.START))

        for i in range(16):
            side.ds.run_tx(lambda tx, i=i: put_cj(tx, i))
        ids = [i.to_bytes(16, "big") for i in range(16)]
        own = _own(side.task.task_id.data, ids, 2, 0)
        got = side.ds.run_tx(lambda tx: tx.acquire_incomplete_collection_jobs(
            p.m.Duration(600), 32, shard=p.models.ShardSpec(2, 0, 30)))
        assert {a.collection_job_id.data for a in got} == own
        other = side.ds.run_tx(lambda tx: tx.acquire_incomplete_collection_jobs(
            p.m.Duration(600), 32, shard=p.models.ShardSpec(2, 1, 30)))
        assert {a.collection_job_id.data for a in other} == set(ids) - own
        out.append((sorted((a.collection_job_id.data, a.shard_key, a.lease.attempts) for a in got + other)))
    assert out[0] == out[1]


# --- both drivers' acquirer(fleet=) -------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_both_drivers_acquirers_mint_holder_tokens(sides, engine):
    out = []
    for side in sides(engine):
        p = side.p
        side.put_jobs(4)
        side.ds.run_tx(lambda tx: tx.put_collection_job(p.models.CollectionJobModel(
            side.task.task_id, p.m.CollectionJobId(bytes(16)), b"q", b"", b"b", p.models.CollectionJobState.START)))
        fleet = p.config.FleetConfig(replica_id="replica-b", shard_count=1)
        agg = p.agg.AggregationJobDriver(side.ds, None, **p.driver_kw).acquirer(600, fleet=fleet)
        coll = p.coll.CollectionJobDriver(side.ds, None).acquirer(600, fleet=fleet)
        got = agg(8) + coll(8)
        assert len(got) == 5 and {a.lease.token[:8] for a in got} == {fleet.holder_tag()}
        holders = side.ds.run_tx(lambda tx: tx.get_lease_holders())
        out.append(sorted((h[0], bytes(h[2]), h[3]) for h in holders))
    assert out[0] == out[1] and {h[2] for h in out[1]} == {t_store.replica_holder_tag("replica-b").hex()}


# --- JobDriver(releaser=): the drain hand-back ------------------------------------------------------


def _drain_case(side, route: str, stopped: bool, releaser_fails: bool):
    p = side.p
    side.put_job(bytes(16))
    drv = p.agg.AggregationJobDriver(side.ds, None, **p.driver_kw)

    def read_job(acquired):
        raise RuntimeError("the step fails mid-drain")

    drv.read_job = read_job
    released = []

    def releaser(acquired):
        released.append(acquired.job_id.data)
        if releaser_fails:
            raise RuntimeError("the release itself fails")
        drv.step_back(acquired, "shutdown_drain", 0.0)

    stopper = p.jd.Stopper()
    if stopped:
        stopper.stop()
    pipe = p.pipe.StepPipeline(drv, stopper=stopper, releaser=releaser) if route == "pipeline" else None
    try:
        jd = p.jd.JobDriver(p.jd.JobDriverConfig(max_concurrent_job_workers=1), drv.acquirer(600), drv.stepper,
                            stopper, releaser=releaser, pipeline=pipe)
        assert jd.run_once() == 1
    finally:
        if pipe is not None:
            pipe.close()
    return len(released), side.rows()


@pytest.mark.parametrize("case", ["drain", "no_drain", "failing_releaser"])
@pytest.mark.parametrize("route", ["serial", "pipeline"])
def test_drain_releaser_hands_the_lease_back(sides, route, case):
    """A step that fails while the stopper is stopped is handed back at once
    (shard_key -1, the attempt refunded, reacquirable now); outside a drain
    the lease stays to expire; a releaser that fails is only logged. Both
    packages, through the serial stepper and through StepPipeline."""
    made = sides("sqlite")
    out = [_drain_case(side, route, case != "no_drain", case == "failing_releaser") for side in made]
    assert out[0] == out[1]
    released, ((job_id, state, expiry, attempts, shard_key, held, _),) = out[1]
    if case == "drain":
        assert released == 1 and (state, expiry, attempts, shard_key, held) == ("in_progress", NOW, 0, -1, False)
    else:
        assert released == (1 if case == "failing_releaser" else 0)
        own_key = t_store.job_shard_key(made[1].task.task_id.data, job_id)
        assert (state, attempts, shard_key, held) == ("in_progress", 1, own_key, True)


# --- the fleet drill, rehearsed ------------------------------------------------------------------


def test_rehearse_chip_smoke_fleet_drill():
    """chip_smoke.py's fleet-drill on the CPU at Prio3Count, two tasks of 4
    reports (one corrupted each) in jobs of 2, the card's four jobs and
    their shard keys: the creator's steal, the hand-back at the armed
    helper.aggregate, a's own claims, the hand-back claim and the steal,
    the lease holders, and both collections against the ground truth (the
    card runs SumVec(1000, 16), 256 reports a task in jobs of 128)."""
    import torch

    import chip_smoke
    from janus_tpu_torch.vdaf.registry import VdafInstance

    rec = chip_smoke.phase_fleet_drill(torch, torch.device("cpu"), VdafInstance.count(), per_task=4, job_size=2,
                                       bad_rows=(1,))
    assert rec["jobs_per_task"] == {"A": 2, "B": 2} and rec["creator_steal_s"] <= 10
    by_shard = rec["jobs_by_shard"]
    assert by_shard == {"a": 2, "b": 2}
    assert rec["claims"] == {"a": {"own": 2, "stolen": 1, "handed_back": 1, "claim_tx": {"claimed": 4, "empty": 2}},
                             "b": {"own": 1, "stolen": 0, "handed_back": 0, "claim_tx": {"claimed": 1, "empty": 0}}}
    assert rec["handback_claim_mock_s"] == 0 and rec["steps"] == 4
    assert rec["failpoints"]["helper.aggregate"] == {"hits": 1, "fired": 1}
    assert [c["report_count"] for c in rec["collect"]] == [3, 3] and all(c["result_ok"] for c in rec["collect"])
