"""The port's Postgres engine held against janus_tpu's, statement for
statement.

Each package's `PostgresDatastore` runs over its own recorded-
conversation driver (`datastore/pg_fake.py`). Both packages' `secrets`
(the Crypter's nonces, the lease tokens) draw from one seeded stream
each, the clocks are MockClocks at the same time and the task is the same
task dict, so the two conversations must be equal event for event:
every connect with its DSN and options, every statement with its SQL
text and parameters, every commit, rollback and close. The flows are
those of tests/test_pg_conversation.py: bootstrap, connection setup,
lease acquire and release with the conflict of a second release, the
serialization-failure retry and the broken-connection reconnect; then no
`?` reaches the wire and every lease claim locks its candidate window
`FOR UPDATE SKIP LOCKED`. Tolerance: exact equality.
"""

import random
import re

import pytest

from janus_tpu import messages as jm
from janus_tpu import task as j_task
from janus_tpu.core import time_util as j_time
from janus_tpu.datastore import models as j_models
from janus_tpu.datastore import pg_fake as j_fake
from janus_tpu.datastore import store as j_store
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import messages as tm
from janus_tpu_torch.core.time_util import MockClock
from janus_tpu_torch.datastore import models as t_models
from janus_tpu_torch.datastore import pg_fake as t_fake
from janus_tpu_torch.datastore import store as t_store
from janus_tpu_torch.task import Task

NOW = 1_600_000_000
DSN = "postgresql://fake-host:5432/janus"
KEY = bytes(range(16))


class SeededSecrets:
    """The `secrets` surface the store modules use, from a seeded stream."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)

    def token_bytes(self, n: int) -> bytes:
        return self._rng.randbytes(n)

    def token_hex(self, n: int) -> str:
        return self.token_bytes(n).hex()


PKG = {
    "jax": dict(store=j_store, fake=j_fake, m=jm, models=j_models, clock=lambda: j_time.MockClock(jm.Time(NOW))),
    "torch": dict(store=t_store, fake=t_fake, m=tm, models=t_models, clock=lambda: MockClock(tm.Time(NOW))),
}

J_TASK = j_task.TaskBuilder(
    j_task.QueryTypeConfig.time_interval(), j_registry.VdafInstance.count(), jm.Role.LEADER
).build()


class Side:
    """One package's PostgresDatastore over its fake driver."""

    def __init__(self, name: str, monkeypatch):
        p = PKG[name]
        self.name = name
        self.m, self.models = p["m"], p["models"]
        monkeypatch.setattr(p["store"], "secrets", SeededSecrets(7))
        self.driver = p["fake"].FakePostgresDriver()
        self.ds = p["store"].PostgresDatastore(
            DSN, p["store"].Crypter([KEY]), p["clock"](), schema="janus_pgtest", driver=self.driver
        )
        self.task = J_TASK if name == "jax" else Task.from_dict(J_TASK.to_dict())
        self.fake = p["fake"]
        self.store = p["store"]

    def job(self, jid: int = 1):
        m, models = self.m, self.models
        return models.AggregationJobModel(
            self.task.task_id, m.AggregationJobId(bytes([jid] * 16)), b"", b"",
            m.Interval(m.Time(1000), m.Duration(100)), models.AggregationJobState.IN_PROGRESS, 0,
        )

    def close(self):
        self.ds.close()
        self.driver.cleanup()


@pytest.fixture
def sides(monkeypatch):
    out = {name: Side(name, monkeypatch) for name in PKG}
    yield out
    for s in out.values():
        s.close()


def conversation(side, since: int = 0):
    return side.driver.log[since:]


def both(sides, flow):
    """Run `flow(side)` on each package; returns {name: the events it logged}."""
    out = {}
    for name, side in sides.items():
        n0 = len(side.driver.log)
        flow(side)
        out[name] = conversation(side, n0)
    return out


def test_bootstrap_conversation_equals_janus_tpu(sides):
    j_log, t_log = (conversation(sides[n]) for n in ("jax", "torch"))
    assert t_log == j_log
    sqls = [e[1] for e in t_log if e[0] == "execute"]
    assert sqls[0].startswith("SELECT pg_advisory_xact_lock")
    assert 'CREATE SCHEMA IF NOT EXISTS "janus_pgtest"' in sqls[1]
    ddl = "\n".join(s for s in sqls if "CREATE TABLE" in s)
    assert "BYTEA" in ddl and "BIGINT" in ddl and "BLOB" not in ddl and not re.search(r"\bINTEGER\b", ddl)
    assert t_store._pg_schema() == j_store._pg_schema()
    assert ("commit",) in t_log


def test_connection_setup_equals_janus_tpu(sides):
    for side in sides.values():
        conn = side.ds._connect()
        assert conn.isolation_level == side.fake.FakePostgresDriver.IsolationLevel.REPEATABLE_READ
    j_conn, t_conn = (sides[n].driver.statements("connect") for n in ("jax", "torch"))
    assert t_conn == j_conn and t_conn[0][1] == DSN and "options" in t_conn[0][2]


def test_lease_acquire_release_and_conflict_equal_janus_tpu(sides):
    m_dur = {"jax": jm.Duration, "torch": tm.Duration}

    def flow(side):
        ds = side.ds
        ds.run_tx(lambda tx: tx.put_task(side.task))
        ds.run_tx(lambda tx: tx.put_aggregation_job(side.job()))
        (acq,) = ds.run_tx(lambda tx: tx.acquire_incomplete_aggregation_jobs(m_dur[side.name](600), 10))
        ds.run_tx(lambda tx: tx.release_aggregation_job(acq))
        with pytest.raises(side.store.LeaseConflict):
            with ds.tx() as tx:
                tx.release_aggregation_job(acq)
        side.token = acq.lease.token

    logs = both(sides, flow)
    assert logs["torch"] == logs["jax"]
    (claim,) = [e for e in logs["torch"] if e[0] == "execute" and e[1].startswith("UPDATE aggregation_jobs SET lease_expiry = %s, lease_token = %s")]
    assert re.search(r"ORDER BY lease_expiry LIMIT \d+ FOR UPDATE SKIP LOCKED\) AS cand ORDER BY random\(\) LIMIT %s\)", claim[1])
    assert claim[1].endswith("RETURNING task_id, job_id, lease_attempts, shard_key")
    expiry, token, now, limit = claim[2]
    assert (expiry - now, limit, token) == (600, 10, sides["torch"].token)
    releases = [e for e in logs["torch"] if e[0] == "execute" and "lease_token = NULL" in e[1]]
    assert len(releases) == 2 and all(e[2][4] == token for e in releases)
    assert logs["torch"][-1] == ("rollback",)


def test_serialization_failure_retry_equals_janus_tpu(sides):
    def flow(side):
        side.driver.inject_once(
            lambda sql, p: sql.startswith("INSERT INTO tasks"),
            side.fake.SerializationFailure("could not serialize access due to concurrent update"),
        )
        calls = []
        side.ds.retry_max_interval_s = 0.0
        side.ds.run_tx(lambda tx: (calls.append(1), tx.put_task(side.task)))
        assert len(calls) == 2
        assert side.ds.run_tx(lambda tx: tx.get_task(side.task.task_id)) is not None

    logs = both(sides, flow)
    assert logs["torch"] == logs["jax"]
    kinds = [e[0] for e in logs["torch"]]
    assert kinds.count("rollback") == 1 and kinds.count("connect") == 0


def test_broken_connection_reconnect_equals_janus_tpu(sides):
    def flow(side):
        conn0 = side.ds._connect()
        side.driver.inject_once(
            lambda sql, p: sql.startswith("INSERT INTO tasks"),
            side.fake.OperationalError("server closed the connection unexpectedly"),
            break_connection=True,
        )
        side.ds.retry_max_interval_s = 0.0
        side.ds.run_tx(lambda tx: tx.put_task(side.task), "conn_lost")
        assert conn0.closed and conn0 not in side.ds._conn_registry and side.ds._connect() is not conn0
        assert side.ds.run_tx(lambda tx: tx.get_task(side.task.task_id)) is not None

    logs = both(sides, flow)
    assert logs["torch"] == logs["jax"]
    kinds = [e[0] for e in logs["torch"]]
    assert kinds.count("connect") == 1 and "close" in kinds


def test_no_qmark_and_every_lease_select_locks_its_window(sides):
    def flow(side):
        m = side.m
        ds = side.ds
        ds.run_tx(lambda tx: tx.put_task(side.task))
        ds.run_tx(lambda tx: tx.put_aggregation_job(side.job()))
        ds.run_tx(lambda tx: tx.acquire_incomplete_aggregation_jobs(m.Duration(600), 4))
        ds.run_tx(lambda tx: tx.acquire_incomplete_collection_jobs(m.Duration(600), 4))
        ds.run_tx(lambda tx: tx.get_task_ids())
        ds.run_tx(lambda tx: tx.get_unaggregated_client_reports_for_task(side.task.task_id, 8))
        ds.run_tx(lambda tx: tx.get_tasks())

    logs = both(sides, flow)
    assert logs["torch"] == logs["jax"]
    sqls = [e[1] for e in logs["torch"] if e[0] == "execute"]
    assert all("?" not in s for s in sqls)
    claims = [s for s in sqls if "lease_attempts = lease_attempts + 1" in s]
    assert len(claims) == 2
    assert all(" FOR UPDATE SKIP LOCKED) AS cand" in s for s in claims)
    # the port's SQLite engine never sends the suffix
    assert t_store.Transaction(None, None, None)._lease_suffix == ""


def test_open_datastore_dispatch(tmp_path, monkeypatch):
    monkeypatch.setattr(t_store, "_psycopg", None)
    with pytest.raises(RuntimeError, match="psycopg is not installed"):
        t_store.open_datastore("postgres://db/janus", t_store.Crypter(), MockClock())
    ds = t_store.open_datastore(str(tmp_path / "x.sqlite"), t_store.Crypter(), MockClock())
    try:
        assert type(ds) is t_store.Datastore and ds.DIALECT == "sqlite"
    finally:
        ds.close()
