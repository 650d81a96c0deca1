"""Datastore: transactional facade + typed ops + Crypter, on SQLite or Postgres.

The port's own copy of the part of janus_tpu/datastore/store.py that
the helper's aggregate-init and aggregate-share paths, the leader's job
creator, job drivers and collection, and the garbage collector use: the
same schema (a janus_tpu SQLite file and a port one hold the same tables
and rows), the same `Crypter` (AES-128-GCM at rest, AAD =
table||row||column, multi-key rotation), and the typed ops on tasks,
client reports, aggregation jobs and their leases, report aggregations,
batch aggregations, collection jobs and their leases, aggregate-share
jobs, fixed-size batches and outstanding batches, and the expiry
deletes, the taskprov peer aggregators and the global HPKE keys, each
with janus_tpu's SQL. The lease ops are token-guarded: a release or
step-back whose token no longer matches raises `LeaseConflict`, which
`run_tx` does not retry.

Two engines behind the one typed-op surface, as in janus_tpu:

  - SQLite (`Datastore`): BEGIN IMMEDIATE and a bounded retry on busy;
    a lease claim is one guarded UPDATE ... RETURNING, atomic under
    SQLite's writer lock.
  - Postgres (`PostgresDatastore`, psycopg, optional): REPEATABLE READ
    with retry on serialization failure, real `FOR UPDATE SKIP LOCKED`
    lease claims, the same schema translated BLOB->BYTEA and
    INTEGER->BIGINT (`_pg_schema`). `open_datastore` picks it for a
    postgres:// URL. Without psycopg it runs over `pg_fake.py`'s
    recorded-conversation driver (`EphemeralDatastore(engine="pgfake")`),
    whose statement stream equals janus_tpu's.

`run_tx` classifies every failure (`classify_error`: serialization,
connection, fatal, other), discards a dead connection, and reports at
most one connection-class failure per call to the attached
`DatastoreSupervisor` (up / degraded / down / recovering, fed by a
probe thread and by real transactions), which the report writer's
journal spill, the admission controller and the job drivers read. The
`datastore.connect.<scope>` failpoint fires on every connection
checkout; `datastore.tx_begin`, `.commit` and `.post_commit` (scoped by
the transaction's name) fire inside run_tx, as in janus_tpu.

Fleet sharding, as in janus_tpu: every job row carries its persisted
`job_shard_key`; the batched claims take a `ShardSpec` and a holder tag
(`replica_holder_tag`, the first 8 bytes of every lease token the
replica mints, read back by `lease_holder_hex` and `get_lease_holders`);
a shutdown hand-back stores `HANDBACK_SHARD_KEY`. The creator's lag scan
and progress probe are `min_unaggregated_report_time_by_task` and
`count_client_reports_for_task`. A `LeaseConflict` carries its `kind`
and `op`, and the datastore counts it (`status()["lease_conflicts"]`)
and in janus_lease_conflicts_total, as janus_tpu does.

The conservation ledger's ops are janus_tpu's: `increment_task_counters`
(called inside the transaction of the state change it counts),
`get_task_counters`, `get_all_task_counters`, `ledger_inflight_by_task`,
`ledger_batch_counts`, `ledger_report_trace`; the expiry deletes return
janus_tpu's per-lane counts for the GC's `expired` booking; a
collection's trace links come from `get_aggregation_job_trace_contexts`.
run_tx feeds the transaction duration and retry metrics, the supervisor
the datastore up and failure gauges, and `start_supervision` registers
the supervisor's `status()` as the statusz `datastore` section.

The health sampler's reads are janus_tpu's (`count_table_rows`,
`count_jobs_by_state`, `get_held_lease_expiries`,
`count_batches_pending_collection`, the report-age quantiles), and so is
the slow-transaction warning (`slow_tx_warn_s`, set from the binaries'
YAML; its JANUS_SLOW_TX_WARN_S knob is not ported).
"""

from __future__ import annotations

import hashlib
import json
import math
import logging
import os
import re
import secrets
import sqlite3
import tempfile
import threading
import time as _time

_log = logging.getLogger(__name__)

try:  # the Postgres engine is optional (psycopg is not in every image)
    import psycopg as _psycopg
except ImportError:  # pragma: no cover - exercised where psycopg exists
    _psycopg = None

from ..core.hpke_backend import AESGCM
from ..messages import (
    AggregationJobId,
    BatchId,
    CollectionJobId,
    Duration,
    HpkeCiphertext,
    Interval,
    PrepareError,
    ReportId,
    ReportIdChecksum,
    TaskId,
    Time,
)
from ..task import Task
from .models import (
    AcquiredAggregationJob,
    AcquiredCollectionJob,
    AggregateShareJob,
    AggregationJobModel,
    AggregationJobState,
    Batch,
    BatchAggregation,
    BatchAggregationState,
    BatchState,
    CollectionJobModel,
    CollectionJobState,
    LeaderStoredReport,
    Lease,
    OutstandingBatch,
    ReportAggregationModel,
    ReportAggregationState,
    ShardSpec,
)

SCHEMA_VERSION = 5

# janus_tpu's schema, table for table. Its Postgres engine derives its
# DDL from this text (BLOB->BYTEA, INTEGER->BIGINT, '?'->'%s'), so no
# identifier may contain BLOB or INTEGER and no SQL literal a '?'.
_SCHEMA = """
CREATE TABLE IF NOT EXISTS schema_version (version INTEGER NOT NULL);

CREATE TABLE IF NOT EXISTS tasks (
    task_id BLOB PRIMARY KEY,
    role INTEGER NOT NULL,
    task_expiration INTEGER,
    doc BLOB NOT NULL            -- encrypted serialized Task
);

CREATE TABLE IF NOT EXISTS client_reports (
    task_id BLOB NOT NULL,
    report_id BLOB NOT NULL,
    client_time INTEGER NOT NULL,
    public_share BLOB,
    leader_input_share BLOB,     -- encrypted
    helper_encrypted_input_share BLOB,
    aggregation_started INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (task_id, report_id)
);
-- partial-index analog of ...up.sql:157 (unaggregated lookup)
CREATE INDEX IF NOT EXISTS client_reports_unaggregated
    ON client_reports (task_id, client_time) WHERE aggregation_started = 0;

CREATE TABLE IF NOT EXISTS aggregation_jobs (
    task_id BLOB NOT NULL,
    job_id BLOB NOT NULL,
    aggregation_parameter BLOB NOT NULL,
    partial_batch_identifier BLOB NOT NULL,
    client_interval_start INTEGER NOT NULL,
    client_interval_duration INTEGER NOT NULL,
    state TEXT NOT NULL,
    step INTEGER NOT NULL DEFAULT 0,
    last_request_hash BLOB,
    trace_context TEXT,          -- W3C traceparent of the creating span
    shard_key INTEGER NOT NULL DEFAULT 0,  -- job_shard_key(task, job)
    lease_expiry INTEGER NOT NULL DEFAULT 0,
    lease_token BLOB,
    lease_attempts INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (task_id, job_id)
);
-- analog of the state_and_lease_expiry index (...up.sql:168-189)
CREATE INDEX IF NOT EXISTS aggregation_jobs_lease
    ON aggregation_jobs (state, lease_expiry) WHERE state = 'in_progress';

CREATE TABLE IF NOT EXISTS report_aggregations (
    task_id BLOB NOT NULL,
    job_id BLOB NOT NULL,
    report_id BLOB NOT NULL,
    client_time INTEGER NOT NULL,
    ord INTEGER NOT NULL,
    state TEXT NOT NULL,
    prep_blob BLOB,              -- encrypted
    prepare_error INTEGER,
    PRIMARY KEY (task_id, job_id, ord)
);
CREATE INDEX IF NOT EXISTS report_aggregations_by_report
    ON report_aggregations (task_id, report_id);

CREATE TABLE IF NOT EXISTS batch_aggregations (
    task_id BLOB NOT NULL,
    batch_identifier BLOB NOT NULL,
    aggregation_parameter BLOB NOT NULL,
    ord INTEGER NOT NULL,
    state TEXT NOT NULL,
    aggregate_share BLOB,
    report_count INTEGER NOT NULL DEFAULT 0,
    client_interval_start INTEGER NOT NULL DEFAULT 0,
    client_interval_duration INTEGER NOT NULL DEFAULT 0,
    checksum BLOB NOT NULL,
    PRIMARY KEY (task_id, batch_identifier, aggregation_parameter, ord)
);

CREATE TABLE IF NOT EXISTS collection_jobs (
    task_id BLOB NOT NULL,
    collection_job_id BLOB NOT NULL,
    query BLOB NOT NULL,
    aggregation_parameter BLOB NOT NULL,
    batch_identifier BLOB NOT NULL,
    state TEXT NOT NULL,
    report_count INTEGER,
    client_interval_start INTEGER,
    client_interval_duration INTEGER,
    leader_aggregate_share BLOB,           -- encrypted
    helper_encrypted_aggregate_share BLOB,
    trace_context TEXT,          -- W3C traceparent of the creating span
    shard_key INTEGER NOT NULL DEFAULT 0,  -- job_shard_key(task, job)
    lease_expiry INTEGER NOT NULL DEFAULT 0,
    lease_token BLOB,
    lease_attempts INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (task_id, collection_job_id)
);

CREATE TABLE IF NOT EXISTS aggregate_share_jobs (
    task_id BLOB NOT NULL,
    batch_identifier BLOB NOT NULL,
    aggregation_parameter BLOB NOT NULL,
    helper_aggregate_share BLOB NOT NULL,  -- encrypted
    report_count INTEGER NOT NULL,
    checksum BLOB NOT NULL,
    PRIMARY KEY (task_id, batch_identifier, aggregation_parameter)
);

CREATE TABLE IF NOT EXISTS batches (
    task_id BLOB NOT NULL,
    batch_identifier BLOB NOT NULL,
    aggregation_parameter BLOB NOT NULL,
    state TEXT NOT NULL,
    outstanding_aggregation_jobs INTEGER NOT NULL DEFAULT 0,
    client_interval_start INTEGER NOT NULL DEFAULT 0,
    client_interval_duration INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (task_id, batch_identifier, aggregation_parameter)
);

CREATE TABLE IF NOT EXISTS outstanding_batches (
    task_id BLOB NOT NULL,
    batch_id BLOB NOT NULL,
    time_bucket_start INTEGER,
    size INTEGER NOT NULL DEFAULT 0,     -- reports assigned so far
    filled INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (task_id, batch_id)
);

CREATE TABLE IF NOT EXISTS global_hpke_keys (
    config_id INTEGER PRIMARY KEY,
    config BLOB NOT NULL,
    private_key BLOB NOT NULL,   -- encrypted
    state TEXT NOT NULL DEFAULT 'pending',
    updated_at INTEGER NOT NULL
);

CREATE TABLE IF NOT EXISTS taskprov_peer_aggregators (
    endpoint TEXT NOT NULL,
    role INTEGER NOT NULL,
    doc BLOB NOT NULL,           -- encrypted serialized PeerAggregator
    PRIMARY KEY (endpoint, role)
);

-- Report-flow conservation ledger (janus_tpu/ledger.py): monotone
-- per-task lifecycle counters, incremented INSIDE the same transaction
-- as the state change they count — run_tx retries re-run the whole
-- closure, so a counter updated in the tx is exactly-once, and every
-- process (listener, driver fleet, GC) sees one consistent set of
-- books. Bounded: O(tasks x counter names), never per-report.
CREATE TABLE IF NOT EXISTS task_counters (
    task_id BLOB NOT NULL,
    counter_name TEXT NOT NULL,
    amount INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (task_id, counter_name)
);
"""


class Crypter:
    """AES-128-GCM at rest, AAD = table||row||column, multi-key rotation
    (reference datastore.rs:4889-4960): encrypt under keys[0], try all
    keys on decrypt."""

    NONCE = 12

    def __init__(self, keys: list[bytes] | None = None):
        keys = keys if keys is not None else [secrets.token_bytes(16)]
        assert keys and all(len(k) == 16 for k in keys)
        self._keys = [AESGCM(k) for k in keys]

    @staticmethod
    def aad(table: str, row: bytes, column: str) -> bytes:
        return table.encode() + b"/" + row + b"/" + column.encode()

    def encrypt(self, table: str, row: bytes, column: str, plaintext: bytes) -> bytes:
        nonce = secrets.token_bytes(self.NONCE)
        return nonce + self._keys[0].encrypt(nonce, plaintext, self.aad(table, row, column))

    def decrypt(self, table: str, row: bytes, column: str, data: bytes) -> bytes:
        nonce, ct = data[: self.NONCE], data[self.NONCE :]
        aad = self.aad(table, row, column)
        last = None
        for key in self._keys:
            try:
                return key.decrypt(nonce, ct, aad)
            except Exception as e:  # InvalidTag
                last = e
        raise ValueError(f"datastore decryption failed: {last}")


class TxConflict(Exception):
    """A retryable conflict (an insert that hit an existing row)."""


class LeaseConflict(TxConflict):
    """A token-guarded lease write (release / step-back) found the token
    no longer matching: the lease expired and another replica re-acquired
    it. Deterministic, so run_tx raises it at once instead of retrying.
    `kind` ("aggregation" or "collection") and `op` ("release" or
    "step_back") classify it, as janus_tpu's janus_lease_conflicts_total
    labels do; the datastore counts it in `lease_conflicts`."""

    def __init__(self, msg: str, kind: str | None = None, op: str | None = None):
        super().__init__(msg)
        self.kind = kind
        self.op = op


# modulo space of the persisted shard hash: far above any plausible
# shard_count, small enough that `shard_key % count` stays exact in
# every engine's integer type
SHARD_KEY_SPACE = 1 << 16


def job_shard_key(task_id: bytes, job_id: bytes) -> int:
    """Stable shard hash of a (task, job) identity, persisted on the
    row at creation. sha256-based so every replica — any language, any
    PYTHONHASHSEED — computes the same key."""
    digest = hashlib.sha256(task_id + job_id).digest()
    return int.from_bytes(digest[:8], "big") % SHARD_KEY_SPACE


def replica_holder_tag(replica_id: str) -> bytes:
    """8-byte stable provenance tag of a replica id, carried in the first
    half of every lease token the replica mints."""
    return hashlib.sha256(replica_id.encode()).digest()[:8]


def lease_holder_hex(token: bytes | None) -> str | None:
    """Provenance half of a lease token (hex), or None when no lease is
    held. Only meaningful for tokens minted with a holder tag."""
    return bytes(token[:8]).hex() if token else None


# shard_key sentinel for a clean shutdown hand-back: the row's shard
# affinity is released, so any replica claims it at once, and the claim
# (which returns the stored key) is told apart from a steal
HANDBACK_SHARD_KEY = -1


def make_lease_token(holder: bytes | None = None) -> bytes:
    """Fresh 16-byte lease token. With a holder tag the first 8 bytes
    carry the claiming replica's provenance and the last 8 stay random
    per claim transaction."""
    if holder:
        return bytes(holder[:8]).ljust(8, b"\0") + secrets.token_bytes(8)
    return secrets.token_bytes(16)


class _PgConnAdapter:
    """Gives a psycopg connection the sqlite3 execute surface the typed
    ops are written against: qmark placeholders, execute returning a
    cursor with fetchone/fetchall/rowcount."""

    def __init__(self, conn):
        self._conn = conn

    def execute(self, sql: str, params=()):
        return self._conn.execute(sql.replace("?", "%s"), params)

    def executemany(self, sql: str, seq):
        cur = self._conn.cursor()
        cur.executemany(sql.replace("?", "%s"), list(seq))
        return cur


class Transaction:
    """One open transaction; exposes the typed ops. Obtained from
    Datastore.run_tx / Datastore.tx(). The `dialect` selects the
    lease-select locking suffix (Postgres gets a real FOR UPDATE SKIP
    LOCKED, datastore.rs:1853-1860) and the RETURNING form."""

    def __init__(self, conn, crypter: Crypter, clock, dialect: str = "sqlite", on_lease_conflict=None):
        self._c = conn
        self._crypter = crypter
        self._clock = clock
        # on_lease_conflict(kind, op): the datastore's conflict count
        self._on_lease_conflict = on_lease_conflict
        self._lease_suffix = " FOR UPDATE SKIP LOCKED" if dialect == "postgres" else ""
        # UPDATE ... RETURNING needs SQLite >= 3.35; older libraries take
        # the two-statement form, exact inside the serialized transaction.
        # Postgres always keeps the RETURNING wire form (pg_fake emulates
        # it on an old SQLite, so the recorded stream is what a server
        # receives).
        self._returning = dialect == "postgres" or sqlite3.sqlite_version_info >= (3, 35)

    def _lease_conflict(self, kind: str, op: str, msg: str) -> LeaseConflict:
        """Count a token mismatch on a guarded lease write and build the
        LeaseConflict to raise. Counted here, not in run_tx: the conflict
        is fatal, so the transaction never retries and it counts once."""
        from .. import metrics

        metrics.lease_conflicts_total.add(
            kind=kind, op=op, **metrics.replica_labels()
        )
        if self._on_lease_conflict is not None:
            self._on_lease_conflict(kind, op)
        return LeaseConflict(msg, kind, op)

    def _update_returning_one(self, update_sql: str, params, returning: str, select_sql: str, select_params):
        """Single-row guarded `UPDATE ... RETURNING <returning>`, with the
        pre-3.35 two-statement form: UPDATE, then re-read via select_sql
        only when a row was changed (exact inside the serialized
        transaction)."""
        if self._returning:
            return self._c.execute(update_sql + " RETURNING " + returning, params).fetchone()
        if not self._c.execute(update_sql, params).rowcount:
            return None
        return self._c.execute(select_sql, select_params).fetchone()

    # ---- tasks (reference datastore.rs:528-1160) ----
    def put_task(self, task: Task) -> None:
        doc = json.dumps(task.to_dict()).encode()
        enc = self._crypter.encrypt("tasks", task.task_id.data, "doc", doc)
        self._c.execute(
            "INSERT INTO tasks (task_id, role, task_expiration, doc) VALUES (?,?,?,?)",
            (
                task.task_id.data,
                int(task.role),
                task.task_expiration.seconds if task.task_expiration else None,
                enc,
            ),
        )

    def get_task(self, task_id: TaskId) -> Task | None:
        row = self._c.execute(
            "SELECT doc FROM tasks WHERE task_id = ?", (task_id.data,)
        ).fetchone()
        if row is None:
            return None
        doc = self._crypter.decrypt("tasks", task_id.data, "doc", row[0])
        return Task.from_dict(json.loads(doc))

    def get_task_ids(self) -> list[TaskId]:
        return [
            TaskId(r[0]) for r in self._c.execute("SELECT task_id FROM tasks ORDER BY task_id")
        ]

    def get_tasks(self) -> list[Task]:
        return [t for t in (self.get_task(tid) for tid in self.get_task_ids()) if t]

    def delete_task(self, task_id: TaskId) -> None:
        """The task and every row of its reports, jobs and batches (the
        aggregator API's DELETE /tasks/:task_id)."""
        for table in (
            "tasks",
            "client_reports",
            "aggregation_jobs",
            "report_aggregations",
            "batch_aggregations",
            "collection_jobs",
            "aggregate_share_jobs",
            "batches",
            "outstanding_batches",
        ):
            self._c.execute(f"DELETE FROM {table} WHERE task_id = ?", (task_id.data,))  # noqa: S608

    # ---- taskprov peer aggregators (reference datastore.rs:4436-4748) ----
    def put_taskprov_peer_aggregator(self, peer) -> None:
        row_key = peer.endpoint.encode() + bytes([int(peer.role)])
        doc = json.dumps(peer.to_dict()).encode()
        enc = self._crypter.encrypt("taskprov_peer_aggregators", row_key, "doc", doc)
        # upsert portable to both engines (sqlite >= 3.24 and Postgres)
        self._c.execute(
            "INSERT INTO taskprov_peer_aggregators (endpoint, role, doc)"
            " VALUES (?,?,?)"
            " ON CONFLICT (endpoint, role) DO UPDATE SET doc = excluded.doc",
            (peer.endpoint, int(peer.role), enc),
        )

    def _decode_peer_aggregator(self, endpoint: str, role: int, doc_enc: bytes):
        from ..taskprov import PeerAggregator

        row_key = endpoint.encode() + bytes([int(role)])
        doc = self._crypter.decrypt("taskprov_peer_aggregators", row_key, "doc", doc_enc)
        return PeerAggregator.from_dict(json.loads(doc))

    def get_taskprov_peer_aggregator(self, endpoint: str, role):
        row = self._c.execute(
            "SELECT doc FROM taskprov_peer_aggregators WHERE endpoint = ? AND role = ?",
            (endpoint, int(role)),
        ).fetchone()
        if row is None:
            return None
        return self._decode_peer_aggregator(endpoint, int(role), row[0])

    def get_taskprov_peer_aggregators(self) -> list:
        rows = self._c.execute(
            "SELECT endpoint, role, doc FROM taskprov_peer_aggregators ORDER BY endpoint, role"
        ).fetchall()
        return [self._decode_peer_aggregator(e, r, d) for e, r, d in rows]

    def delete_taskprov_peer_aggregator(self, endpoint: str, role) -> None:
        self._c.execute(
            "DELETE FROM taskprov_peer_aggregators WHERE endpoint = ? AND role = ?",
            (endpoint, int(role)),
        )

    # ---- client reports (reference datastore.rs:1162-1723) ----
    def put_client_report(self, report: LeaderStoredReport) -> bool:
        """Returns False if the report id already exists (replay)."""
        row_key = report.task_id.data + report.report_id.data
        lis = self._crypter.encrypt(
            "client_reports", row_key, "leader_input_share", report.leader_input_share
        )
        cur = self._c.execute(
            "INSERT INTO client_reports (task_id, report_id, client_time, public_share,"
            " leader_input_share, helper_encrypted_input_share) VALUES (?,?,?,?,?,?)"
            " ON CONFLICT DO NOTHING",
            (
                report.task_id.data,
                report.report_id.data,
                report.client_time.seconds,
                report.public_share,
                lis,
                report.helper_encrypted_input_share.to_bytes(),
            ),
        )
        return cur.rowcount == 1

    def delete_client_report(self, task_id: TaskId, report_id: ReportId) -> bool:
        """Delete one stored report row. Production code never calls
        this: it exists for the `ledger.drop_report` failpoint (a silent
        loss after the admission counter booked the report, which the
        conservation ledger must catch) and for tests. True if a row was
        deleted."""
        cur = self._c.execute(
            "DELETE FROM client_reports WHERE task_id = ? AND report_id = ?",
            (task_id.data, report_id.data),
        )
        return cur.rowcount == 1

    def get_client_report(self, task_id: TaskId, report_id: ReportId) -> LeaderStoredReport | None:
        row = self._c.execute(
            "SELECT client_time, public_share, leader_input_share, helper_encrypted_input_share"
            " FROM client_reports WHERE task_id = ? AND report_id = ?",
            (task_id.data, report_id.data),
        ).fetchone()
        if row is None:
            return None
        row_key = task_id.data + report_id.data
        return LeaderStoredReport(
            task_id,
            report_id,
            Time(row[0]),
            row[1],
            self._crypter.decrypt("client_reports", row_key, "leader_input_share", row[2]),
            HpkeCiphertext.from_bytes(row[3]),
        )

    def check_report_replayed(self, task_id: TaskId, report_id: ReportId) -> bool:
        return (
            self._c.execute(
                "SELECT 1 FROM client_reports WHERE task_id = ? AND report_id = ?",
                (task_id.data, report_id.data),
            ).fetchone()
            is not None
        )

    def get_unaggregated_client_reports_for_task(
        self, task_id: TaskId, limit: int
    ) -> list[tuple[ReportId, Time]]:
        """Claims up to `limit` unaggregated reports (marks them started),
        like datastore.rs:1331 get_unaggregated_client_report_ids_for_task."""
        if self._returning:
            rows = self._c.execute(
                "UPDATE client_reports SET aggregation_started = 1"
                " WHERE (task_id, report_id) IN ("
                "   SELECT task_id, report_id FROM client_reports"
                "   WHERE task_id = ? AND aggregation_started = 0"
                "   ORDER BY client_time LIMIT ?)"
                " RETURNING report_id, client_time",
                (task_id.data, limit),
            ).fetchall()
        else:
            rows = self._c.execute(
                "SELECT report_id, client_time FROM client_reports"
                " WHERE task_id = ? AND aggregation_started = 0"
                " ORDER BY client_time LIMIT ?",
                (task_id.data, limit),
            ).fetchall()
            self._c.executemany(
                "UPDATE client_reports SET aggregation_started = 1"
                " WHERE task_id = ? AND report_id = ?",
                [(task_id.data, r[0]) for r in rows],
            )
        return [(ReportId(r[0]), Time(r[1])) for r in rows]

    def count_client_reports_for_task(self, task_id: TaskId) -> tuple[int, int]:
        """(total, aggregated) client reports of a task: the creator's
        owner-progress probe reads the second."""
        row = self._c.execute(
            "SELECT COUNT(*), COALESCE(SUM(aggregation_started), 0) FROM client_reports WHERE task_id = ?",
            (task_id.data,),
        ).fetchone()
        return row[0], row[1]

    # ---- health reads (aggregator/health_sampler.py): cheap aggregate
    # queries the sampler runs on a period against the serving database ----

    # the durable tables whose row counts the sampler exports
    # (janus_datastore_table_rows{table}, the flight recorder's
    # datastore_rows series)
    COUNTED_TABLES = (
        "tasks",
        "client_reports",
        "aggregation_jobs",
        "report_aggregations",
        "batch_aggregations",
        "collection_jobs",
        "aggregate_share_jobs",
        "batches",
        "outstanding_batches",
        "task_counters",
    )

    def count_table_rows(self) -> dict[str, int]:
        """{table: row count} over COUNTED_TABLES."""
        return {
            t: self._c.execute(f"SELECT COUNT(*) FROM {t}").fetchone()[0]  # noqa: S608
            for t in self.COUNTED_TABLES
        }

    def count_jobs_by_state(self) -> dict[tuple[str, str], int]:
        """{(job type, state): count} over aggregation and collection jobs
        (the janus_jobs{type,state} backlog gauges)."""
        out: dict[tuple[str, str], int] = {}
        for typ, table in (("aggregation", "aggregation_jobs"), ("collection", "collection_jobs")):
            for state, n in self._c.execute(f"SELECT state, COUNT(*) FROM {table} GROUP BY state").fetchall():
                out[(typ, str(state))] = int(n)
        return out

    def get_held_lease_expiries(self) -> list[tuple[str, bytes, bytes, int]]:
        """[(job type, task_id, job_id, lease_expiry)] of every outstanding
        lease: a projection of get_lease_holders, so both reads share one
        definition of held."""
        return [(typ, task_id, job_id, expiry) for typ, task_id, job_id, _holder, expiry in self.get_lease_holders()]

    def get_pending_aggregation_job_sizes(self, limit: int = 256) -> dict[bytes, list[int]]:
        """{task_id: [report counts]} of in-progress aggregation jobs: the
        batch sizes the next driver pass dispatches, which the boot warmup
        warms."""
        rows = self._c.execute(
            "SELECT aj.task_id, COUNT(*) FROM aggregation_jobs aj"
            " JOIN report_aggregations ra"
            "   ON ra.task_id = aj.task_id AND ra.job_id = aj.job_id"
            " WHERE aj.state = 'in_progress'"
            " GROUP BY aj.task_id, aj.job_id LIMIT ?",
            (int(limit),),
        ).fetchall()
        out: dict[bytes, list[int]] = {}
        for task_id, n in rows:
            out.setdefault(task_id, []).append(int(n))
        return out

    def count_batches_pending_collection(self) -> int:
        """Collection jobs still awaiting an aggregate result."""
        return int(
            self._c.execute("SELECT COUNT(*) FROM collection_jobs WHERE state IN ('start', 'collectable')").fetchone()[0]
        )

    def unaggregated_report_time_quantiles_by_task(
        self, quantiles: tuple[float, ...] = (0.5, 0.95, 0.99), bucket_s: int = 60
    ) -> list[tuple[bytes, int, int, dict[float, int]]]:
        """[(task_id, count, exact oldest client_time, {q: client_time at
        the q age-quantile})] over unaggregated reports, from one scan
        bucketed by `bucket_s` of client time in the database. The q
        age-quantile is the bucket of the report at 1-based rank
        n - ceil(q * (n - 1)) counted from the oldest, given as the
        bucket's older edge: both lean to the older report, the
        conservative side for a lag gauge."""
        rows = self._c.execute(
            "SELECT task_id, client_time / ?, COUNT(*), MIN(client_time)"
            " FROM client_reports"
            " WHERE aggregation_started = 0 GROUP BY task_id, client_time / ?"
            " ORDER BY task_id, client_time / ?",
            (bucket_s, bucket_s, bucket_s),
        ).fetchall()
        by_task: dict[bytes, list[tuple[int, int, int]]] = {}
        for task_id, bucket, cnt, bucket_min in rows:
            by_task.setdefault(task_id, []).append((int(bucket), int(cnt), int(bucket_min)))
        out: list[tuple[bytes, int, int, dict[float, int]]] = []
        for task_id, buckets in by_task.items():
            n = sum(c for _, c, _ in buckets)
            oldest = buckets[0][2]  # ascending: the first bucket holds the min
            vals: dict[float, int] = {}
            for q in quantiles:
                rank = n - math.ceil(q * (n - 1))
                cum = 0
                for bucket, cnt, _ in buckets:  # ascending time: oldest first
                    cum += cnt
                    if cum >= rank:
                        vals[q] = bucket * bucket_s
                        break
            out.append((task_id, n, oldest, vals))
        return out

    def min_unaggregated_report_time_by_task(self) -> list[tuple[bytes, int]]:
        """[(task_id, oldest unaggregated client_time)]: the tasks with a
        backlog no aggregation job has claimed yet (the creator's lag scan)."""
        rows = self._c.execute(
            "SELECT task_id, MIN(client_time) FROM client_reports"
            " WHERE aggregation_started = 0 GROUP BY task_id"
        ).fetchall()
        return [(r[0], int(r[1])) for r in rows]

    def mark_reports_unaggregated(self, task_id: TaskId, report_ids: list[ReportId]) -> None:
        self._c.executemany(
            "UPDATE client_reports SET aggregation_started = 0 WHERE task_id = ? AND report_id = ?",
            [(task_id.data, r.data) for r in report_ids],
        )

    def delete_expired_client_reports(self, task_id: TaskId, cutoff: Time, limit: int) -> tuple[int, int]:
        """(never-claimed, claimed) expired rows deleted — split by
        aggregation_started so the GC can attribute expiry in the
        conservation ledger: a never-claimed report leaves the pending
        pool for the `expired` terminal, while a claimed one already
        resolved (or will resolve) through its report_aggregations row
        and only its storage is reclaimed here."""
        out = []
        for started in (0, 1):
            cur = self._c.execute(
                "DELETE FROM client_reports WHERE (task_id, report_id) IN ("
                " SELECT task_id, report_id FROM client_reports"
                " WHERE task_id = ? AND client_time < ? AND aggregation_started = ? LIMIT ?)",
                (task_id.data, cutoff.seconds, started, max(0, limit - sum(out))),
            )
            out.append(cur.rowcount)
        return out[0], out[1]

    # ---- report-flow conservation ledger (ledger.py) ----
    def increment_task_counters(self, task_id: TaskId, deltas: dict[str, int]) -> None:
        """Upsert-add monotone lifecycle counters for a task. MUST be
        called inside the same transaction as the state change being
        counted: run_tx re-runs the whole closure on a retry, so an
        in-tx increment is exactly-once where an in-process counter
        would double-count (the documented run_tx retry discipline)."""
        rows = [(task_id.data, name, int(n)) for name, n in deltas.items() if n]
        if not rows:
            return
        self._c.executemany(
            "INSERT INTO task_counters (task_id, counter_name, amount) VALUES (?,?,?)"
            " ON CONFLICT (task_id, counter_name) DO UPDATE SET"
            " amount = task_counters.amount + excluded.amount",
            rows,
        )

    def get_task_counters(self, task_id: TaskId) -> dict[str, int]:
        rows = self._c.execute(
            "SELECT counter_name, amount FROM task_counters WHERE task_id = ?",
            (task_id.data,),
        ).fetchall()
        return {str(r[0]): int(r[1]) for r in rows}

    def get_all_task_counters(self) -> dict[bytes, dict[str, int]]:
        """{task_id: {counter: amount}} over every task with books."""
        out: dict[bytes, dict[str, int]] = {}
        for task_id, name, amount in self._c.execute(
            "SELECT task_id, counter_name, amount FROM task_counters"
        ).fetchall():
            out.setdefault(bytes(task_id), {})[str(name)] = int(amount)
        return out

    def ledger_inflight_by_task(self) -> dict[bytes, dict[str, int]]:
        """{task_id: {category: count}} of attributably in-flight
        reports, read in one transaction so the ledger's balance
        evaluates against a single snapshot:

        - pending_reports: admitted client_reports no aggregation job
          has claimed yet (aggregation_started = 0)
        - pending_aggregation: report_aggregations still in a
          non-terminal state (start / waiting_*) — claimed, outcome due
        - pending_aggregation_param: same, but for jobs carrying a
          non-empty aggregation parameter (the param-fanout lane —
          those rows debit `admitted_param`, never `admitted`)
        - awaiting_collection: aggregated report mass sitting in
          uncollected batch_aggregations shards
        """
        out: dict[bytes, dict[str, int]] = {}
        for task_id, n in self._c.execute(
            "SELECT task_id, COUNT(*) FROM client_reports"
            " WHERE aggregation_started = 0 GROUP BY task_id"
        ).fetchall():
            out.setdefault(bytes(task_id), {})["pending_reports"] = int(n)
        # only RAs of live jobs: abandon_job releases a job's START rows
        # back to the unclaimed pool without rewriting them, so counting
        # an abandoned job's rows would double-book those reports (and a
        # WAITING row stuck in an abandoned job SHOULD read as imbalance
        # — it will never resolve, which is exactly a lost report)
        for task_id, param, n in self._c.execute(
            "SELECT ra.task_id, aj.aggregation_parameter <> ?, COUNT(*)"
            " FROM report_aggregations ra"
            " JOIN aggregation_jobs aj"
            "   ON aj.task_id = ra.task_id AND aj.job_id = ra.job_id"
            " WHERE ra.state IN ('start', 'waiting_leader', 'waiting_helper')"
            " AND aj.state = 'in_progress'"
            " GROUP BY 1, 2",
            (b"",),
        ).fetchall():
            key = "pending_aggregation_param" if param else "pending_aggregation"
            t = out.setdefault(bytes(task_id), {})
            t[key] = t.get(key, 0) + int(n)
        for task_id, n in self._c.execute(
            "SELECT task_id, COALESCE(SUM(report_count), 0) FROM batch_aggregations"
            " WHERE state <> 'collected' GROUP BY task_id"
        ).fetchall():
            out.setdefault(bytes(task_id), {})["awaiting_collection"] = int(n)
        return out

    def ledger_batch_counts(self, task_id: TaskId) -> dict[str, int]:
        """{"<batch_identifier hex>:<aggregation_parameter hex>":
        aggregated report count} for a task — the cross-aggregator
        reconciliation payload (both aggregators persist
        batch_aggregations; equal per-key counts mean neither side
        silently dropped or double-counted a report the other
        aggregated — the observability analog of a linear tag). Keyed
        per (batch, param): a multi-parameter task accumulates the same
        batch once per collection parameter, and summing across params
        would inflate the helper's count against a leader comparison
        that covers a single collection's parameter."""
        rows = self._c.execute(
            "SELECT batch_identifier, aggregation_parameter,"
            " COALESCE(SUM(report_count), 0)"
            " FROM batch_aggregations WHERE task_id = ?"
            " GROUP BY batch_identifier, aggregation_parameter",
            (task_id.data,),
        ).fetchall()
        return {
            f"{bytes(r[0]).hex()}:{bytes(r[1]).hex()}": int(r[2]) for r in rows
        }

    def ledger_report_trace(self, task_id: TaskId, report_id: ReportId) -> dict:
        """One report's whereabouts across every pipeline table — the
        per-report drill-down behind janus_tpu's tools/report_trace.py (the ledger
        says HOW MANY are unaccounted; this answers WHICH stage one
        specific report reached). Read-only; single snapshot."""
        out: dict = {"client_report": None, "report_aggregations": [], "batch_aggregations": []}
        row = self._c.execute(
            "SELECT client_time, aggregation_started FROM client_reports"
            " WHERE task_id = ? AND report_id = ?",
            (task_id.data, report_id.data),
        ).fetchone()
        client_time = None
        if row is not None:
            client_time = int(row[0])
            out["client_report"] = {
                "client_time": client_time,
                "aggregation_started": bool(row[1]),
            }
        for r in self._c.execute(
            "SELECT ra.job_id, ra.ord, ra.state, ra.prepare_error, ra.client_time,"
            " aj.state, aj.step, aj.lease_attempts"
            " FROM report_aggregations ra"
            " LEFT JOIN aggregation_jobs aj"
            "   ON aj.task_id = ra.task_id AND aj.job_id = ra.job_id"
            " WHERE ra.task_id = ? AND ra.report_id = ?"
            " ORDER BY ra.job_id, ra.ord",
            (task_id.data, report_id.data),
        ).fetchall():
            if client_time is None:
                client_time = int(r[4])
            out["report_aggregations"].append(
                {
                    "job_id": bytes(r[0]).hex(),
                    "ord": int(r[1]),
                    "state": str(r[2]),
                    "prepare_error": None if r[3] is None else int(r[3]),
                    "job_state": None if r[5] is None else str(r[5]),
                    "job_step": None if r[6] is None else int(r[6]),
                    "job_attempts": None if r[7] is None else int(r[7]),
                }
            )
        if client_time is not None:
            # every accumulator shard whose client interval covers this
            # report's timestamp — collected shards mean the report's
            # mass (if it FINISHED) has left through a collection
            for r in self._c.execute(
                "SELECT batch_identifier, ord, state, report_count"
                " FROM batch_aggregations WHERE task_id = ?"
                " AND client_interval_start <= ?"
                " AND client_interval_start + client_interval_duration > ?"
                " ORDER BY batch_identifier, ord",
                (task_id.data, client_time, client_time),
            ).fetchall():
                out["batch_aggregations"].append(
                    {
                        "batch_identifier": bytes(r[0]).hex(),
                        "ord": int(r[1]),
                        "state": str(r[2]),
                        "report_count": int(r[3]),
                    }
                )
        return out

    # ---- aggregation jobs (reference datastore.rs:1724-2051) ----

    def put_aggregation_job(self, job: AggregationJobModel) -> None:
        self._c.execute(
            "INSERT INTO aggregation_jobs (task_id, job_id, aggregation_parameter,"
            " partial_batch_identifier, client_interval_start, client_interval_duration,"
            " state, step, last_request_hash, trace_context, shard_key, lease_expiry)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                job.task_id.data,
                job.job_id.data,
                job.aggregation_parameter,
                job.partial_batch_identifier,
                job.client_timestamp_interval.start.seconds,
                job.client_timestamp_interval.duration.seconds,
                job.state.value,
                job.step,
                job.last_request_hash,
                job.trace_context,
                job_shard_key(job.task_id.data, job.job_id.data),
                # eligible-since stamp: a past-expiry value means
                # "claimable"; the CREATION time (not 0) is what the
                # steal-after-delay fallback measures eligibility age
                # against — a fresh job must not look infinitely stale
                self._clock.now().seconds,
            ),
        )

    def get_aggregation_job(self, task_id: TaskId, job_id: AggregationJobId) -> AggregationJobModel | None:
        row = self._c.execute(
            "SELECT aggregation_parameter, partial_batch_identifier, client_interval_start,"
            " client_interval_duration, state, step, last_request_hash, trace_context"
            " FROM aggregation_jobs WHERE task_id = ? AND job_id = ?",
            (task_id.data, job_id.data),
        ).fetchone()
        if row is None:
            return None
        return AggregationJobModel(
            task_id,
            job_id,
            row[0],
            row[1],
            Interval(Time(row[2]), Duration(row[3])),
            AggregationJobState(row[4]),
            row[5],
            row[6],
            row[7],
        )

    def update_aggregation_job(self, job: AggregationJobModel) -> None:
        self._c.execute(
            "UPDATE aggregation_jobs SET state = ?, step = ?, last_request_hash = ?"
            " WHERE task_id = ? AND job_id = ?",
            (job.state.value, job.step, job.last_request_hash, job.task_id.data, job.job_id.data),
        )

    def get_aggregation_jobs_for_task(self, task_id: TaskId) -> list[AggregationJobModel]:
        rows = self._c.execute(
            "SELECT job_id FROM aggregation_jobs WHERE task_id = ? ORDER BY job_id",
            (task_id.data,),
        ).fetchall()
        return [self.get_aggregation_job(task_id, AggregationJobId(r[0])) for r in rows]

    # ---- leases (reference datastore.rs:1836-1905) ----
    def _acquire_jobs_batched(
        self,
        table: str,
        id_col: str,
        state_pred: str,
        lease_duration: Duration,
        limit: int,
        shard: ShardSpec | None,
        holder: bytes | None,
    ) -> list[tuple[bytes, bytes, bytes, int, int, int]]:
        """One claim transaction leasing up to `limit` jobs: a single
        UPDATE whose candidate subquery carries the eligibility window
        (lease expired), the shard predicate, and a randomized claim order
        inside an oldest-first window of max(4*limit, 64) rows. The batch
        shares one fresh token. In-shard rows are claimable as soon as
        their lease expires; out-of-shard rows once they have sat eligible
        for steal_after_s, or at once after a hand-back (shard_key < 0).

        Returns [(task_id, job_id, token, expiry, lease_attempts,
        shard_key)]."""
        now = self._clock.now().seconds
        expiry = now + lease_duration.seconds
        token = make_lease_token(holder)
        eligible = f"{state_pred} AND lease_expiry <= ?"
        params: list = [now]
        order = "random()"
        if shard is not None and shard.active:
            count = int(shard.shard_count)
            index = int(shard.shard_index) % count
            eligible = (
                f"{state_pred} AND lease_expiry <= ?"
                f" AND (shard_key % {count} = {index} OR shard_key < 0"
                " OR lease_expiry <= ?)"
            )
            params = [now, now - max(0, int(shard.steal_after_s))]
            order = f"CASE WHEN shard_key % {count} = {index} THEN 0 ELSE 1 END, random()"
        window = max(4 * int(limit), 64)
        select_sql = (
            f"SELECT task_id, {id_col} FROM ("
            f"SELECT task_id, {id_col}, shard_key FROM {table}"
            f" WHERE {eligible} ORDER BY lease_expiry LIMIT {window}"
            f"{self._lease_suffix}"
            f") AS cand ORDER BY {order} LIMIT ?"
        )
        set_sql = (
            f"UPDATE {table} SET lease_expiry = ?, lease_token = ?,"
            " lease_attempts = lease_attempts + 1"
        )
        if self._returning:
            rows = self._c.execute(
                set_sql
                + f" WHERE (task_id, {id_col}) IN ({select_sql})"
                + f" RETURNING task_id, {id_col}, lease_attempts, shard_key",
                (expiry, token, *params, limit),
            ).fetchall()
        else:
            cand = self._c.execute(select_sql, (*params, limit)).fetchall()
            if not cand:
                return []
            marks = ",".join(["(?,?)"] * len(cand))
            flat = [x for row in cand for x in row]
            self._c.execute(
                set_sql + f" WHERE (task_id, {id_col}) IN (VALUES {marks}) AND {eligible}",
                (expiry, token, *flat, *params),
            )
            rows = self._c.execute(
                f"SELECT task_id, {id_col}, lease_attempts, shard_key FROM {table}"
                " WHERE lease_token = ?",
                (token,),
            ).fetchall()
        return [(t, j, token, expiry, att, sk) for t, j, att, sk in rows]

    def acquire_incomplete_aggregation_jobs(
        self,
        lease_duration: Duration,
        limit: int,
        shard: ShardSpec | None = None,
        holder: bytes | None = None,
    ) -> list[AcquiredAggregationJob]:
        """Batched lease claim over in-progress aggregation jobs
        (reference datastore.rs:1836; see _acquire_jobs_batched)."""
        return [
            AcquiredAggregationJob(
                TaskId(t),
                AggregationJobId(j),
                Lease(token, Time(expiry), att),
                shard_key=sk,
            )
            for t, j, token, expiry, att, sk in self._acquire_jobs_batched(
                "aggregation_jobs",
                "job_id",
                "state = 'in_progress'",
                lease_duration,
                limit,
                shard,
                holder,
            )
        ]

    def release_aggregation_job(self, acquired: AcquiredAggregationJob) -> None:
        """reference datastore.rs:1905: the step succeeded. Stamps now as
        the eligible-since, resets the attempt ledger and re-stamps the
        shard affinity; raises LeaseConflict if the lease was lost."""
        cur = self._c.execute(
            "UPDATE aggregation_jobs SET lease_expiry = ?, lease_token = NULL,"
            " lease_attempts = 0, shard_key = ?"
            " WHERE task_id = ? AND job_id = ? AND lease_token = ?",
            (
                self._clock.now().seconds,
                job_shard_key(acquired.task_id.data, acquired.job_id.data),
                acquired.task_id.data,
                acquired.job_id.data,
                acquired.lease.token,
            ),
        )
        if cur.rowcount != 1:
            raise self._lease_conflict("aggregation", "release", "lease token mismatch on release")

    def step_back_aggregation_job(
        self,
        acquired: AcquiredAggregationJob,
        reacquire_delay_s: int = 0,
        count_attempt: bool = False,
        handback: bool = False,
    ) -> None:
        """Early lease release without resetting the attempt ledger: the
        job becomes reacquirable after `reacquire_delay_s`.
        count_attempt=False refunds the acquire's lease_attempts increment
        (a helper outage must not march jobs to abandonment); handback=True
        releases the shard affinity (shutdown drain). Raises LeaseConflict
        if the lease was lost."""
        now = self._clock.now().seconds
        attempts_sql = (
            "lease_attempts"
            if count_attempt
            else "CASE WHEN lease_attempts > 0 THEN lease_attempts - 1 ELSE 0 END"
        )
        shard_key = (
            HANDBACK_SHARD_KEY
            if handback
            else job_shard_key(acquired.task_id.data, acquired.job_id.data)
        )
        cur = self._c.execute(
            "UPDATE aggregation_jobs SET lease_expiry = ?, lease_token = NULL,"
            f" lease_attempts = {attempts_sql}, shard_key = ?"
            " WHERE task_id = ? AND job_id = ? AND lease_token = ?",
            (
                now + max(0, int(reacquire_delay_s)),
                shard_key,
                acquired.task_id.data,
                acquired.job_id.data,
                acquired.lease.token,
            ),
        )
        if cur.rowcount != 1:
            raise self._lease_conflict("aggregation", "step_back", "lease token mismatch on step-back")

    def put_report_aggregation(self, ra: ReportAggregationModel) -> None:
        row_key = ra.task_id.data + ra.job_id.data + ra.ord.to_bytes(8, "big")
        blob = (
            self._crypter.encrypt("report_aggregations", row_key, "prep_blob", ra.prep_blob)
            if ra.prep_blob
            else b""
        )
        self._c.execute(
            "INSERT INTO report_aggregations (task_id, job_id, report_id, client_time, ord,"
            " state, prep_blob, prepare_error) VALUES (?,?,?,?,?,?,?,?)",
            (
                ra.task_id.data,
                ra.job_id.data,
                ra.report_id.data,
                ra.client_time.seconds,
                ra.ord,
                ra.state.value,
                blob,
                int(ra.prepare_error) if ra.prepare_error is not None else None,
            ),
        )

    def update_report_aggregation(self, ra: ReportAggregationModel) -> None:
        row_key = ra.task_id.data + ra.job_id.data + ra.ord.to_bytes(8, "big")
        blob = (
            self._crypter.encrypt("report_aggregations", row_key, "prep_blob", ra.prep_blob)
            if ra.prep_blob
            else b""
        )
        self._c.execute(
            "UPDATE report_aggregations SET state = ?, prep_blob = ?, prepare_error = ?"
            " WHERE task_id = ? AND job_id = ? AND ord = ?",
            (
                ra.state.value,
                blob,
                int(ra.prepare_error) if ra.prepare_error is not None else None,
                ra.task_id.data,
                ra.job_id.data,
                ra.ord,
            ),
        )

    def get_report_aggregations_for_job(
        self, task_id: TaskId, job_id: AggregationJobId
    ) -> list[ReportAggregationModel]:
        rows = self._c.execute(
            "SELECT report_id, client_time, ord, state, prep_blob, prepare_error"
            " FROM report_aggregations WHERE task_id = ? AND job_id = ? ORDER BY ord",
            (task_id.data, job_id.data),
        ).fetchall()
        out = []
        for r in rows:
            row_key = task_id.data + job_id.data + r[2].to_bytes(8, "big")
            blob = (
                self._crypter.decrypt("report_aggregations", row_key, "prep_blob", r[4])
                if r[4]
                else b""
            )
            out.append(
                ReportAggregationModel(
                    task_id,
                    job_id,
                    ReportId(r[0]),
                    Time(r[1]),
                    r[2],
                    ReportAggregationState(r[3]),
                    blob,
                    PrepareError(r[5]) if r[5] is not None else None,
                )
            )
        return out

    def get_aggregated_report_ids(self, task_id: TaskId, report_ids: list[ReportId]) -> set[bytes]:
        """Which of `report_ids` already have ANY report-aggregation row
        (helper replay check) — one set query for the whole init batch,
        not a per-report loop (the reference's single
        get_unaggregated-style set op; was VERDICT r2 Weak #2)."""
        out: set[bytes] = set()
        ids = [r.data for r in report_ids]
        # SQLite caps host parameters (default 999); chunk well under it
        for lo in range(0, len(ids), 500):
            chunk = ids[lo : lo + 500]
            marks = ",".join("?" * len(chunk))
            rows = self._c.execute(
                "SELECT DISTINCT report_id FROM report_aggregations"
                f" WHERE task_id = ? AND report_id IN ({marks})",
                (task_id.data, *chunk),
            ).fetchall()
            out.update(r[0] for r in rows)
        return out

    def get_aggregated_report_ids_for_param(
        self, task_id: TaskId, report_ids: list[ReportId], aggregation_parameter: bytes
    ) -> set[bytes]:
        """Param-scoped replay check (a VDAF with an aggregation
        parameter, Poplar1): which of `report_ids` already have a report
        aggregation under a job with THIS parameter. A report aggregates
        once per parameter."""
        out: set[bytes] = set()
        ids = [r.data for r in report_ids]
        for lo in range(0, len(ids), 500):
            chunk = ids[lo : lo + 500]
            marks = ",".join("?" * len(chunk))
            rows = self._c.execute(
                "SELECT DISTINCT ra.report_id FROM report_aggregations ra"
                " JOIN aggregation_jobs aj ON aj.task_id = ra.task_id"
                "  AND aj.job_id = ra.job_id"
                " WHERE ra.task_id = ? AND aj.aggregation_parameter = ?"
                f" AND ra.report_id IN ({marks})",
                (task_id.data, aggregation_parameter, *chunk),
            ).fetchall()
            out.update(r[0] for r in rows)
        return out

    def get_client_report_ids_in_interval(self, task_id: TaskId, interval: Interval) -> list[tuple[ReportId, Time]]:
        """Every stored client report whose time falls in the interval
        (the collection-driven aggregation of a parameterized VDAF)."""
        rows = self._c.execute(
            "SELECT report_id, client_time FROM client_reports"
            " WHERE task_id = ? AND client_time >= ? AND client_time < ?"
            " ORDER BY client_time, report_id",
            (task_id.data, interval.start.seconds, interval.end.seconds),
        ).fetchall()
        return [(ReportId(r[0]), Time(r[1])) for r in rows]

    def count_active_aggregation_jobs_for_param(self, task_id: TaskId, aggregation_parameter: bytes) -> int:
        return self._c.execute(
            "SELECT COUNT(*) FROM aggregation_jobs"
            " WHERE task_id = ? AND aggregation_parameter = ? AND state = 'in_progress'",
            (task_id.data, aggregation_parameter),
        ).fetchone()[0]

    # ---- batch aggregations (reference datastore.rs:3020-3368) ----
    def put_batch_aggregation(self, ba: BatchAggregation) -> None:
        try:
            self._c.execute(
                "INSERT INTO batch_aggregations (task_id, batch_identifier, aggregation_parameter,"
                " ord, state, aggregate_share, report_count, client_interval_start,"
                " client_interval_duration, checksum) VALUES (?,?,?,?,?,?,?,?,?,?)",
                (
                    ba.task_id.data,
                    ba.batch_identifier,
                    ba.aggregation_parameter,
                    ba.ord,
                    ba.state.value,
                    ba.aggregate_share,
                    ba.report_count,
                    ba.client_timestamp_interval.start.seconds,
                    ba.client_timestamp_interval.duration.seconds,
                    ba.checksum.data,
                ),
            )
        except sqlite3.IntegrityError as e:
            # unique violation -> retryable conflict (reference accumulator.rs:173-199)
            raise TxConflict(str(e)) from e

    def update_batch_aggregation(self, ba: BatchAggregation) -> None:
        self._c.execute(
            "UPDATE batch_aggregations SET state = ?, aggregate_share = ?, report_count = ?,"
            " client_interval_start = ?, client_interval_duration = ?, checksum = ?"
            " WHERE task_id = ? AND batch_identifier = ? AND aggregation_parameter = ? AND ord = ?",
            (
                ba.state.value,
                ba.aggregate_share,
                ba.report_count,
                ba.client_timestamp_interval.start.seconds,
                ba.client_timestamp_interval.duration.seconds,
                ba.checksum.data,
                ba.task_id.data,
                ba.batch_identifier,
                ba.aggregation_parameter,
                ba.ord,
            ),
        )

    def get_batch_aggregation(
        self, task_id: TaskId, batch_identifier: bytes, agg_param: bytes, ord: int
    ) -> BatchAggregation | None:
        row = self._c.execute(
            "SELECT state, aggregate_share, report_count, client_interval_start,"
            " client_interval_duration, checksum FROM batch_aggregations"
            " WHERE task_id = ? AND batch_identifier = ? AND aggregation_parameter = ? AND ord = ?",
            (task_id.data, batch_identifier, agg_param, ord),
        ).fetchone()
        if row is None:
            return None
        return BatchAggregation(
            task_id,
            batch_identifier,
            agg_param,
            ord,
            BatchAggregationState(row[0]),
            row[1],
            row[2],
            Interval(Time(row[3]), Duration(row[4])),
            ReportIdChecksum(row[5]),
        )

    def sum_batch_aggregation_report_count(
        self, task_id: TaskId, batch_identifier: bytes, param: bytes
    ) -> int:
        """Aggregated report total for a batch, one SELECT across shards."""
        row = self._c.execute(
            "SELECT COALESCE(SUM(report_count), 0) FROM batch_aggregations"
            " WHERE task_id = ? AND batch_identifier = ? AND aggregation_parameter = ?",
            (task_id.data, batch_identifier, param),
        ).fetchone()
        return int(row[0])

    def batch_has_collected_shard(
        self, task_id: TaskId, batch_identifier: bytes, param: bytes
    ) -> bool:
        """Cheap existence check: is any shard of this batch collected?"""
        row = self._c.execute(
            "SELECT 1 FROM batch_aggregations WHERE task_id = ? AND batch_identifier = ?"
            " AND aggregation_parameter = ? AND state = 'collected' LIMIT 1",
            (task_id.data, batch_identifier, param),
        ).fetchone()
        return row is not None

    def get_batch_aggregations_for_batch(
        self, task_id: TaskId, batch_identifier: bytes, agg_param: bytes
    ) -> list[BatchAggregation]:
        rows = self._c.execute(
            "SELECT ord FROM batch_aggregations WHERE task_id = ? AND batch_identifier = ?"
            " AND aggregation_parameter = ? ORDER BY ord",
            (task_id.data, batch_identifier, agg_param),
        ).fetchall()
        return [
            self.get_batch_aggregation(task_id, batch_identifier, agg_param, r[0]) for r in rows
        ]

    def get_batch_aggregations_intersecting_interval(
        self, task_id: TaskId, interval: Interval, aggregation_parameter: bytes | None = None
    ) -> list[BatchAggregation]:
        """Time-interval collection: the shard rows whose batch interval
        falls inside the collection interval (reference query_type.rs:204
        CollectableQueryType). aggregation_parameter restricts to rows
        accumulated under it; None matches every parameter."""
        rows = self._c.execute(
            "SELECT DISTINCT batch_identifier, aggregation_parameter FROM batch_aggregations"
            " WHERE task_id = ?",
            (task_id.data,),
        ).fetchall()
        out = []
        for bid, param in rows:
            if aggregation_parameter is not None and param != aggregation_parameter:
                continue
            biv = Interval.from_bytes(bid)
            if biv.start >= interval.start and biv.end <= interval.end:
                out.extend(self.get_batch_aggregations_for_batch(task_id, bid, param))
        return out

    def mark_batch_aggregations_collected(
        self, task_id: TaskId, batch_identifier: bytes, agg_param: bytes
    ) -> None:
        self._c.execute(
            "UPDATE batch_aggregations SET state = 'collected'"
            " WHERE task_id = ? AND batch_identifier = ? AND aggregation_parameter = ?",
            (task_id.data, batch_identifier, agg_param),
        )

    def delete_expired_batch_aggregations(self, task_id: TaskId, cutoff: Time, limit: int) -> int:
        cur = self._c.execute(
            "DELETE FROM batch_aggregations WHERE (task_id, batch_identifier, aggregation_parameter, ord) IN ("
            " SELECT task_id, batch_identifier, aggregation_parameter, ord FROM batch_aggregations"
            " WHERE task_id = ? AND client_interval_start + client_interval_duration < ? LIMIT ?)",
            (task_id.data, cutoff.seconds, limit),
        )
        return cur.rowcount

    # ---- collection jobs (reference datastore.rs:2456-3019) ----
    def put_collection_job(self, job: CollectionJobModel) -> None:
        self._c.execute(
            "INSERT INTO collection_jobs (task_id, collection_job_id, query, aggregation_parameter,"
            " batch_identifier, state, trace_context, shard_key, lease_expiry)"
            " VALUES (?,?,?,?,?,?,?,?,?)",
            (
                job.task_id.data,
                job.collection_job_id.data,
                job.query,
                job.aggregation_parameter,
                job.batch_identifier,
                job.state.value,
                job.trace_context,
                job_shard_key(job.task_id.data, job.collection_job_id.data),
                self._clock.now().seconds,  # eligible-since (see agg jobs)
            ),
        )

    def get_collection_job(
        self, task_id: TaskId, collection_job_id: CollectionJobId
    ) -> CollectionJobModel | None:
        row = self._c.execute(
            "SELECT query, aggregation_parameter, batch_identifier, state, report_count,"
            " client_interval_start, client_interval_duration, leader_aggregate_share,"
            " helper_encrypted_aggregate_share, trace_context FROM collection_jobs"
            " WHERE task_id = ? AND collection_job_id = ?",
            (task_id.data, collection_job_id.data),
        ).fetchone()
        if row is None:
            return None
        row_key = task_id.data + collection_job_id.data
        las = (
            self._crypter.decrypt("collection_jobs", row_key, "leader_aggregate_share", row[7])
            if row[7]
            else None
        )
        return CollectionJobModel(
            task_id,
            collection_job_id,
            row[0],
            row[1],
            row[2],
            CollectionJobState(row[3]),
            row[4],
            Interval(Time(row[5]), Duration(row[6])) if row[5] is not None else None,
            las,
            row[8],
            row[9],
        )

    def get_collection_job_batches_for_task(self, task_id: TaskId) -> list[tuple[bytes, bytes, str]]:
        """[(batch_identifier, query, state)] over every collection job
        of the task: the leader's time-interval overlap scan (reference
        query_type.rs:204)."""
        rows = self._c.execute(
            "SELECT batch_identifier, query, state FROM collection_jobs WHERE task_id = ?",
            (task_id.data,),
        ).fetchall()
        return [(r[0], r[1], r[2]) for r in rows]

    def count_collection_jobs_for_batch(self, task_id: TaskId, batch_identifier: bytes) -> int:
        """Queries consumed against a batch (the leader's
        max_batch_query_count; deleted jobs still count: the budget is
        spent)."""
        return self._c.execute(
            "SELECT COUNT(*) FROM collection_jobs WHERE task_id = ? AND batch_identifier = ?",
            (task_id.data, batch_identifier),
        ).fetchone()[0]

    def find_collection_job_by_query(
        self, task_id: TaskId, query: bytes, aggregation_parameter: bytes = b""
    ) -> CollectionJobModel | None:
        """Idempotent collection-job creation (reference
        aggregator.rs:2233). A collection is identified by (query,
        aggregation parameter)."""
        row = self._c.execute(
            "SELECT collection_job_id FROM collection_jobs"
            " WHERE task_id = ? AND query = ? AND aggregation_parameter = ?",
            (task_id.data, query, aggregation_parameter),
        ).fetchone()
        return self.get_collection_job(task_id, CollectionJobId(row[0])) if row else None

    def update_collection_job(self, job: CollectionJobModel) -> None:
        row_key = job.task_id.data + job.collection_job_id.data
        las = (
            self._crypter.encrypt(
                "collection_jobs", row_key, "leader_aggregate_share", job.leader_aggregate_share
            )
            if job.leader_aggregate_share
            else None
        )
        self._c.execute(
            "UPDATE collection_jobs SET state = ?, report_count = ?, client_interval_start = ?,"
            " client_interval_duration = ?, leader_aggregate_share = ?, helper_encrypted_aggregate_share = ?"
            " WHERE task_id = ? AND collection_job_id = ?",
            (
                job.state.value,
                job.report_count,
                job.client_timestamp_interval.start.seconds if job.client_timestamp_interval else None,
                job.client_timestamp_interval.duration.seconds if job.client_timestamp_interval else None,
                las,
                job.helper_encrypted_aggregate_share,
                job.task_id.data,
                job.collection_job_id.data,
            ),
        )

    def acquire_incomplete_collection_jobs(
        self,
        lease_duration: Duration,
        limit: int,
        shard: ShardSpec | None = None,
        holder: bytes | None = None,
    ) -> list[AcquiredCollectionJob]:
        """Batched lease claim over collectable collection jobs
        (reference datastore.rs:2853; see _acquire_jobs_batched)."""
        return [
            AcquiredCollectionJob(
                TaskId(t),
                CollectionJobId(j),
                Lease(token, Time(expiry), att),
                shard_key=sk,
            )
            for t, j, token, expiry, att, sk in self._acquire_jobs_batched(
                "collection_jobs",
                "collection_job_id",
                "state IN ('start', 'collectable')",
                lease_duration,
                limit,
                shard,
                holder,
            )
        ]

    def release_collection_job(self, acquired: AcquiredCollectionJob) -> None:
        """See release_aggregation_job."""
        cur = self._c.execute(
            "UPDATE collection_jobs SET lease_expiry = ?, lease_token = NULL,"
            " lease_attempts = 0, shard_key = ?"
            " WHERE task_id = ? AND collection_job_id = ? AND lease_token = ?",
            (
                self._clock.now().seconds,
                job_shard_key(acquired.task_id.data, acquired.collection_job_id.data),
                acquired.task_id.data,
                acquired.collection_job_id.data,
                acquired.lease.token,
            ),
        )
        if cur.rowcount != 1:
            raise self._lease_conflict("collection", "release", "lease token mismatch on release")

    def step_back_collection_job(
        self,
        acquired: AcquiredCollectionJob,
        reacquire_delay_s: int = 0,
        count_attempt: bool = False,
        handback: bool = False,
    ) -> None:
        """See step_back_aggregation_job."""
        now = self._clock.now().seconds
        attempts_sql = (
            "lease_attempts"
            if count_attempt
            else "CASE WHEN lease_attempts > 0 THEN lease_attempts - 1 ELSE 0 END"
        )
        shard_key = (
            HANDBACK_SHARD_KEY
            if handback
            else job_shard_key(acquired.task_id.data, acquired.collection_job_id.data)
        )
        cur = self._c.execute(
            "UPDATE collection_jobs SET lease_expiry = ?, lease_token = NULL,"
            f" lease_attempts = {attempts_sql}, shard_key = ?"
            " WHERE task_id = ? AND collection_job_id = ? AND lease_token = ?",
            (
                now + max(0, int(reacquire_delay_s)),
                shard_key,
                acquired.task_id.data,
                acquired.collection_job_id.data,
                acquired.lease.token,
            ),
        )
        if cur.rowcount != 1:
            raise self._lease_conflict("collection", "step_back", "lease token mismatch on step-back")

    def get_lease_holders(self) -> list[tuple[str, bytes, bytes, str, int]]:
        """[(job type, task_id, job_id, holder provenance hex,
        lease_expiry)] for every outstanding lease (token set, not yet
        expired): which replica holds which job, read off the provenance
        half of the lease token."""
        now = self._clock.now().seconds
        out: list[tuple[str, bytes, bytes, str, int]] = []
        for typ, table, id_col in (
            ("aggregation", "aggregation_jobs", "job_id"),
            ("collection", "collection_jobs", "collection_job_id"),
        ):
            rows = self._c.execute(
                f"SELECT task_id, {id_col}, lease_token, lease_expiry FROM {table}"
                " WHERE lease_token IS NOT NULL AND lease_expiry > ?",
                (now,),
            ).fetchall()
            out.extend((typ, r[0], r[1], lease_holder_hex(r[2]), int(r[3])) for r in rows)
        return out

    # ---- aggregate share jobs (reference datastore.rs:3369-3706) ----
    def put_aggregate_share_job(self, job: AggregateShareJob) -> None:
        row_key = job.task_id.data + job.batch_identifier
        share = self._crypter.encrypt(
            "aggregate_share_jobs", row_key, "helper_aggregate_share", job.helper_aggregate_share
        )
        self._c.execute(
            "INSERT INTO aggregate_share_jobs (task_id, batch_identifier, aggregation_parameter,"
            " helper_aggregate_share, report_count, checksum) VALUES (?,?,?,?,?,?)",
            (
                job.task_id.data,
                job.batch_identifier,
                job.aggregation_parameter,
                share,
                job.report_count,
                job.checksum.data,
            ),
        )

    def get_aggregate_share_job(
        self, task_id: TaskId, batch_identifier: bytes, agg_param: bytes
    ) -> AggregateShareJob | None:
        row = self._c.execute(
            "SELECT helper_aggregate_share, report_count, checksum FROM aggregate_share_jobs"
            " WHERE task_id = ? AND batch_identifier = ? AND aggregation_parameter = ?",
            (task_id.data, batch_identifier, agg_param),
        ).fetchone()
        if row is None:
            return None
        row_key = task_id.data + batch_identifier
        return AggregateShareJob(
            task_id,
            batch_identifier,
            agg_param,
            self._crypter.decrypt("aggregate_share_jobs", row_key, "helper_aggregate_share", row[0]),
            row[1],
            ReportIdChecksum(row[2]),
        )

    def count_aggregate_share_jobs_for_batch(self, task_id: TaskId, batch_identifier: bytes) -> int:
        return self._c.execute(
            "SELECT COUNT(*) FROM aggregate_share_jobs WHERE task_id = ? AND batch_identifier = ?",
            (task_id.data, batch_identifier),
        ).fetchone()[0]

    # ---- batches (reference datastore.rs:3944-4161) ----
    def put_batch(self, batch: Batch) -> None:
        self._c.execute(
            "INSERT INTO batches (task_id, batch_identifier, aggregation_parameter, state,"
            " outstanding_aggregation_jobs, client_interval_start, client_interval_duration)"
            " VALUES (?,?,?,?,?,?,?)",
            (
                batch.task_id.data,
                batch.batch_identifier,
                batch.aggregation_parameter,
                batch.state.value,
                batch.outstanding_aggregation_jobs,
                batch.client_timestamp_interval.start.seconds,
                batch.client_timestamp_interval.duration.seconds,
            ),
        )

    def get_batch(self, task_id: TaskId, batch_identifier: bytes, agg_param: bytes) -> Batch | None:
        row = self._c.execute(
            "SELECT state, outstanding_aggregation_jobs, client_interval_start,"
            " client_interval_duration FROM batches"
            " WHERE task_id = ? AND batch_identifier = ? AND aggregation_parameter = ?",
            (task_id.data, batch_identifier, agg_param),
        ).fetchone()
        if row is None:
            return None
        return Batch(
            task_id,
            batch_identifier,
            agg_param,
            BatchState(row[0]),
            row[1],
            Interval(Time(row[2]), Duration(row[3])),
        )

    def update_batch(self, batch: Batch) -> None:
        self._c.execute(
            "UPDATE batches SET state = ?, outstanding_aggregation_jobs = ?,"
            " client_interval_start = ?, client_interval_duration = ?"
            " WHERE task_id = ? AND batch_identifier = ? AND aggregation_parameter = ?",
            (
                batch.state.value,
                batch.outstanding_aggregation_jobs,
                batch.client_timestamp_interval.start.seconds,
                batch.client_timestamp_interval.duration.seconds,
                batch.task_id.data,
                batch.batch_identifier,
                batch.aggregation_parameter,
            ),
        )

    # ---- outstanding batches (reference datastore.rs:3707-3943) ----
    def put_outstanding_batch(self, ob: OutstandingBatch) -> None:
        self._c.execute(
            "INSERT INTO outstanding_batches (task_id, batch_id, time_bucket_start, size)"
            " VALUES (?,?,?,?)",
            (
                ob.task_id.data,
                ob.batch_id.data,
                ob.time_bucket_start.seconds if ob.time_bucket_start else None,
                ob.size,
            ),
        )

    def get_outstanding_batches(
        self,
        task_id: TaskId,
        time_bucket_start: Time | None = None,
        include_filled: bool = False,
    ) -> list[OutstandingBatch]:
        """Fullest first: the reference's per-bucket priority queue
        (batch_creator.rs:83) tops up the most-filled batch first."""
        filled_clause = "" if include_filled else " AND filled = 0"
        if time_bucket_start is None:
            rows = self._c.execute(
                "SELECT batch_id, time_bucket_start, size FROM outstanding_batches"
                f" WHERE task_id = ?{filled_clause} ORDER BY size DESC",
                (task_id.data,),
            ).fetchall()
        else:
            rows = self._c.execute(
                "SELECT batch_id, time_bucket_start, size FROM outstanding_batches"
                f" WHERE task_id = ?{filled_clause} AND time_bucket_start = ?"
                " ORDER BY size DESC",
                (task_id.data, time_bucket_start.seconds),
            ).fetchall()
        return [
            OutstandingBatch(task_id, BatchId(r[0]), Time(r[1]) if r[1] is not None else None, r[2])
            for r in rows
        ]

    def add_to_outstanding_batch(self, task_id: TaskId, batch_id: BatchId, n: int) -> int:
        """Record n more reports assigned to the batch; returns the new size."""
        row = self._update_returning_one(
            "UPDATE outstanding_batches SET size = size + ? WHERE task_id = ? AND batch_id = ?",
            (n, task_id.data, batch_id.data),
            "size",
            "SELECT size FROM outstanding_batches WHERE task_id = ? AND batch_id = ?",
            (task_id.data, batch_id.data),
        )
        if row is None:
            raise TxConflict("outstanding batch vanished")
        return row[0]

    def mark_outstanding_batch_filled(self, task_id: TaskId, batch_id: BatchId) -> None:
        self._c.execute(
            "UPDATE outstanding_batches SET filled = 1 WHERE task_id = ? AND batch_id = ?",
            (task_id.data, batch_id.data),
        )

    def delete_outstanding_batch(self, task_id: TaskId, batch_id: BatchId) -> None:
        """Consume a batch chosen by a current-batch collection."""
        self._c.execute(
            "DELETE FROM outstanding_batches WHERE task_id = ? AND batch_id = ?",
            (task_id.data, batch_id.data),
        )

    # ---- global HPKE keys (reference datastore.rs:4316-4435) ----
    def put_global_hpke_keypair(self, keypair, state: str = "pending") -> None:
        row_key = bytes([keypair.config.id.id])
        enc = self._crypter.encrypt("global_hpke_keys", row_key, "private_key", keypair.private_key)
        self._c.execute(
            "INSERT INTO global_hpke_keys (config_id, config, private_key, state, updated_at)"
            " VALUES (?,?,?,?,?)",
            (keypair.config.id.id, keypair.config.to_bytes(), enc, state, self._clock.now().seconds),
        )

    def get_global_hpke_keypairs(self) -> list[tuple]:
        """[(HpkeKeypair, state)]."""
        from ..core.hpke import HpkeKeypair
        from ..messages import HpkeConfig

        out = []
        for cid, cfg, sk, state in self._c.execute(
            "SELECT config_id, config, private_key, state FROM global_hpke_keys"
        ):
            row_key = bytes([cid])
            out.append(
                (
                    HpkeKeypair(
                        HpkeConfig.from_bytes(cfg),
                        self._crypter.decrypt("global_hpke_keys", row_key, "private_key", sk),
                    ),
                    state,
                )
            )
        return out

    def set_global_hpke_keypair_state(self, config_id: int, state: str) -> None:
        self._c.execute(
            "UPDATE global_hpke_keys SET state = ?, updated_at = ? WHERE config_id = ?",
            (state, self._clock.now().seconds, config_id),
        )

    def delete_global_hpke_keypair(self, config_id: int) -> None:
        self._c.execute("DELETE FROM global_hpke_keys WHERE config_id = ?", (config_id,))

    def get_aggregation_job_trace_contexts(
        self,
        task_id: TaskId,
        interval: Interval | None = None,
        partial_batch_identifier: bytes | None = None,
        limit: int = 64,
    ) -> list[str]:
        """Distinct persisted trace contexts of the aggregation jobs a
        collection covers (time-interval INTERSECTION — the same
        semantics as the batch gather, so a job whose claimed reports
        straddle the collection boundary still links — or fixed-size
        partial-batch-selector match) — the collection span's causality
        links back to the aggregation work that filled the batch.
        Callers wanting to detect truncation ask for one more than they
        display."""
        if interval is not None:
            rows = self._c.execute(
                "SELECT DISTINCT trace_context FROM aggregation_jobs"
                " WHERE task_id = ? AND trace_context IS NOT NULL"
                " AND client_interval_start < ?"
                " AND client_interval_start + client_interval_duration > ?"
                " LIMIT ?",
                (task_id.data, interval.end.seconds, interval.start.seconds, limit),
            ).fetchall()
        elif partial_batch_identifier is not None:
            rows = self._c.execute(
                "SELECT DISTINCT trace_context FROM aggregation_jobs"
                " WHERE task_id = ? AND trace_context IS NOT NULL"
                " AND partial_batch_identifier = ? LIMIT ?",
                (task_id.data, partial_batch_identifier, limit),
            ).fetchall()
        else:
            return []
        return [str(r[0]) for r in rows]

    # ---- GC (reference datastore.rs:4162-4315) ----
    def delete_expired_aggregation_artifacts(self, task_id: TaskId, cutoff: Time, limit: int) -> tuple[int, int, int]:
        """(jobs deleted, never-resolved rows of the canonical lane,
        never-resolved rows of the param-fanout lane). The row counts
        are the GC's ledger attribution: a non-terminal row deleted
        here would otherwise sit unaccounted forever (its job expired
        before resolving), so the GC books it `expired` /
        `expired_param` in the same transaction.

        Abandoned jobs need care: abandon_job returns a canonical job's
        START rows to the unclaimed pool (mark_reports_unaggregated),
        so those reports reach a real terminal later (re-aggregated,
        rejected, or expired as unclaimed client_reports) — booking the
        stale START rows again here would double-debit `admitted` and
        latch a false negative residual. Only an abandoned canonical
        job's waiting_* rows really are lost. Param-fanout jobs have no
        pool to return to (the per-param replay check treats ANY row as
        done), so ALL their non-terminal rows are lost on abandonment
        and book `expired_param` here."""
        rows = self._c.execute(
            "SELECT job_id, state, aggregation_parameter FROM aggregation_jobs"
            " WHERE task_id = ?"
            " AND client_interval_start + client_interval_duration < ? LIMIT ?",
            (task_id.data, cutoff.seconds, limit),
        ).fetchall()
        n = pending = pending_param = 0
        for job_id, job_state, agg_param in rows:
            is_param = bytes(agg_param or b"") != b""
            if str(job_state) == "abandoned" and not is_param:
                states = "('waiting_leader', 'waiting_helper')"
            else:
                states = "('start', 'waiting_leader', 'waiting_helper')"
            lost = int(
                self._c.execute(
                    "SELECT COUNT(*) FROM report_aggregations"
                    " WHERE task_id = ? AND job_id = ?"
                    f" AND state IN {states}",
                    (task_id.data, job_id),
                ).fetchone()[0]
            )
            if is_param:
                pending_param += lost
            else:
                pending += lost
            self._c.execute(
                "DELETE FROM report_aggregations WHERE task_id = ? AND job_id = ?",
                (task_id.data, job_id),
            )
            cur = self._c.execute(
                "DELETE FROM aggregation_jobs WHERE task_id = ? AND job_id = ?",
                (task_id.data, job_id),
            )
            n += cur.rowcount
        return n, pending, pending_param

    def delete_expired_collection_artifacts(self, task_id: TaskId, cutoff: Time, limit: int) -> int:
        # aggregate_share_jobs carry no client-time column in this schema;
        # they are removed with the task, as in janus_tpu
        return self._c.execute(
            "DELETE FROM collection_jobs WHERE (task_id, collection_job_id) IN ("
            " SELECT task_id, collection_job_id FROM collection_jobs"
            " WHERE task_id = ? AND client_interval_start IS NOT NULL"
            " AND client_interval_start + client_interval_duration < ? LIMIT ?)",
            (task_id.data, cutoff.seconds, limit),
        ).rowcount





class Datastore:
    """Connection manager + transaction runner (reference datastore.rs:107),
    SQLite engine: one connection per thread, BEGIN IMMEDIATE, bounded
    retry with full-jitter backoff on busy/conflict. Engine-specific
    seams (overridden by PostgresDatastore): `DIALECT`, `_connect`,
    `_begin`, `_retryable_errors`, `_adapt`, `_connection_lost_error`,
    `_discard_if_broken`, `classify_error`."""

    MAX_RETRIES = 16
    DIALECT = "sqlite"
    # cap on one retry sleep; the sleep is full-jitter uniform in
    # [0, min(cap, base * 2^attempt)]
    retry_max_interval_s = 0.128
    retry_base_interval_s = 0.002
    # a transaction (retries included) slower than this logs a warning
    # (the binaries' database.slow_tx_warn_secs); <= 0 turns it off
    slow_tx_warn_s = 1.0

    def __init__(self, path: str, crypter: Crypter, clock):
        self._path = path
        self._crypter = crypter
        self._clock = clock
        self._local = threading.local()
        # every live per-thread connection, so close() reaches them all
        self._conn_registry: set = set()
        self._conn_registry_lock = threading.Lock()
        # scope suffix of the datastore.connect failpoint (hit as
        # `datastore.connect` and `datastore.connect.<scope>`), so a
        # schedule can take down one datastore of several in a process
        self.failpoint_scope = os.path.basename(str(path)) or str(path)
        # attached by start_supervision(); run_tx feeds it successes and
        # connection failures even before its probe thread runs
        self.supervisor: DatastoreSupervisor | None = None
        # token mismatches on guarded lease writes, by (kind, op): janus_tpu's
        # janus_lease_conflicts_total, read through status()
        self._lease_conflicts: dict[tuple[str, str], int] = {}
        self._lease_conflicts_lock = threading.Lock()
        self._bootstrap_schema()

    def _bootstrap_schema(self) -> None:
        conn = self._connect()
        with conn:
            conn.executescript(_SCHEMA)
            row = conn.execute("SELECT version FROM schema_version").fetchone()
            if row is None:
                conn.execute("INSERT INTO schema_version (version) VALUES (?)", (SCHEMA_VERSION,))
            elif row[0] != SCHEMA_VERSION:
                raise RuntimeError(f"unsupported schema version {row[0]}")

    @property
    def clock(self):
        return self._clock

    @property
    def crypter(self) -> Crypter:
        """The at-rest crypter (shared with the upload spill journal, so
        journaled shares stay encrypted on disk under the same keys)."""
        return self._crypter

    def _hit_connect_failpoint(self) -> None:
        """`datastore.connect` failpoint: fires on every connection
        checkout, cached or fresh, so an armed outage models "the database
        is unreachable". Its error and timeout actions raise this engine's
        connection-lost error, which classify_error calls "connection"."""
        from .. import failpoints

        failpoints.hit_scoped(
            "datastore.connect",
            self.failpoint_scope,
            error_factory=lambda: self._connection_lost_error(
                "injected connect failure (failpoint datastore.connect)"
            ),
            timeout_factory=lambda: self._connection_lost_error(
                "injected connect timeout (failpoint datastore.connect)"
            ),
        )

    def _connection_lost_error(self, msg: str) -> Exception:
        return sqlite3.OperationalError(msg)

    def _register_conn(self, conn) -> None:
        with self._conn_registry_lock:
            self._conn_registry.add(conn)

    def _connect(self) -> sqlite3.Connection:
        self._hit_connect_failpoint()
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(
                self._path,
                timeout=30.0,
                uri=self._path.startswith("file:"),
                check_same_thread=False,
            )
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            conn.execute("PRAGMA foreign_keys=ON")
            self._local.conn = conn
            self._register_conn(conn)
        return conn

    def _begin(self, conn) -> None:
        conn.execute("BEGIN IMMEDIATE")

    def _adapt(self, conn):
        """Wrap the raw connection for Transaction's execute surface."""
        return conn

    def _discard(self, conn) -> None:
        """Drop a dead cached connection: close, unregister, and clear the
        thread-local so the next _connect dials fresh."""
        try:
            conn.close()
        except Exception:
            pass
        with self._conn_registry_lock:
            self._conn_registry.discard(conn)
        if getattr(self._local, "conn", None) is conn:
            self._local.conn = None

    def _discard_if_broken(self, conn) -> None:
        """Drop the cached connection if the engine marks it broken
        (SQLite connections carry no broken flag)."""

    def classify_error(self, e: BaseException) -> str:
        """"serialization" (contention: SQLite busy, an injected or insert
        conflict; retry on the same connection), "connection" (the
        connection or the database under it is gone: discard, redial,
        tell the supervisor), "fatal" (schema/SQL error or a lease
        conflict: no retry can help) or "other"."""
        if isinstance(e, LeaseConflict):
            return "fatal"
        if isinstance(e, TxConflict):
            return "serialization"
        if isinstance(e, sqlite3.OperationalError):
            msg = str(e).lower()
            if "locked" in msg or "busy" in msg:
                return "serialization"
            if "no such" in msg or "syntax error" in msg:
                return "fatal"
            # "unable to open database file", "disk I/O error", injected
            # connect failures, ...
            return "connection"
        return "other"

    @property
    def _retryable_errors(self) -> tuple:
        return (sqlite3.OperationalError, TxConflict)

    def _tx_obj(self, conn) -> Transaction:
        return Transaction(self._adapt(conn), self._crypter, self._clock, dialect=self.DIALECT,
                           on_lease_conflict=self._count_lease_conflict)

    def _count_lease_conflict(self, kind: str, op: str) -> None:
        with self._lease_conflicts_lock:
            self._lease_conflicts[(kind, op)] = self._lease_conflicts.get((kind, op), 0) + 1

    def status(self) -> dict:
        """{"lease_conflicts": {kind: {op: count}}}: the lease races this
        datastore's transactions lost."""
        out: dict[str, dict[str, int]] = {}
        with self._lease_conflicts_lock:
            for (kind, op), n in sorted(self._lease_conflicts.items()):
                out.setdefault(kind, {})[op] = n
        return {"lease_conflicts": out}

    def tx(self):
        """Single-attempt transaction as a context manager (no retry):
        commits on a clean exit, rolls back on an exception."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            conn = self._connect()
            self._begin(conn)
            try:
                yield self._tx_obj(conn)
                conn.commit()
            except BaseException:
                conn.rollback()
                raise

        return cm()

    def _retry_sleep_s(self, attempt: int) -> float:
        import random

        ceiling = min(
            max(0.0, float(self.retry_max_interval_s)),
            self.retry_base_interval_s * (1 << min(attempt, 30)),
        )
        return random.uniform(0.0, ceiling)

    def probe(self) -> None:
        """One cheap connectivity check on this thread's connection (the
        supervisor's probe). Raises the engine's error on failure, after
        discarding the dead connection."""
        conn = None
        try:
            conn = self._connect()
            conn.execute("SELECT 1").fetchone()
            # leave no transaction open behind the probe (psycopg's
            # implicit BEGIN opens one at the first statement)
            conn.rollback()
        except BaseException:
            if conn is not None:
                self._discard(conn)
            raise

    def start_supervision(self, **kwargs) -> "DatastoreSupervisor":
        """Create, attach and start the background supervisor
        (idempotent); kwargs go to DatastoreSupervisor."""
        if self.supervisor is None:
            from ..statusz import register_status_provider

            self.supervisor = DatastoreSupervisor(self, **kwargs)
            self.supervisor.start()
            self._status_provider = self.supervisor.status
            register_status_provider("datastore", self._status_provider)
        return self.supervisor

    def run_tx(self, fn, name: str = "tx"):
        """Run fn(Transaction) with retry on busy/conflict
        (reference run_tx_with_name, datastore.rs:216-242). The
        `datastore.tx_begin`, `datastore.commit` and
        `datastore.post_commit` failpoints (scoped by `name`) raise a
        retryable TxConflict; a connection-class failure discards the
        connection and counts once per call toward the supervisor."""
        from .. import failpoints, metrics

        def _inj() -> TxConflict:
            return TxConflict(f"injected conflict (failpoint, tx={name})")

        start = _time.monotonic()
        # one supervisor observation per call, not per attempt: one doomed
        # transaction retrying three times in ~10 ms is one outage sighting
        supervisor_notified = False
        for attempt in range(self.MAX_RETRIES):
            conn = None
            try:
                # inside the try: a failed (re)connect is a retryable
                # connection-class failure
                conn = self._connect()
                self._begin(conn)
                failpoints.hit_scoped("datastore.tx_begin", name, error_factory=_inj)
                result = fn(self._tx_obj(conn))
                failpoints.hit_scoped("datastore.commit", name, error_factory=_inj)
                conn.commit()
                failpoints.hit_scoped("datastore.post_commit", name, error_factory=_inj)
                elapsed = _time.monotonic() - start
                metrics.tx_duration.observe(elapsed, tx=name)
                if 0 < self.slow_tx_warn_s < elapsed:
                    _log.warning(
                        "slow datastore transaction %s: %.3fs over %d attempt(s) (threshold %.2fs)",
                        name, elapsed, attempt + 1, self.slow_tx_warn_s,
                    )
                if self.supervisor is not None:
                    self.supervisor.record_success()
                return result
            except self._retryable_errors as e:
                kind = self.classify_error(e)
                if kind != "fatal":
                    metrics.tx_retries_total.add(tx=name, kind=kind)
                if conn is not None:
                    if kind == "connection":
                        # never retry into a dead cached connection
                        try:
                            conn.rollback()
                        except Exception:
                            pass
                        self._discard(conn)
                    else:
                        try:
                            conn.rollback()
                        except Exception:
                            self._discard(conn)
                        else:
                            self._discard_if_broken(conn)
                if kind == "connection" and self.supervisor is not None and not supervisor_notified:
                    supervisor_notified = True
                    self.supervisor.record_failure(e)
                if kind == "fatal" or attempt == self.MAX_RETRIES - 1:
                    raise
                _time.sleep(self._retry_sleep_s(attempt))
            except BaseException:
                if conn is not None:
                    try:
                        conn.rollback()
                    except Exception:
                        self._discard(conn)
                raise
        raise AssertionError(f"run_tx {name}: unreachable")

    def close(self) -> None:
        """Stop the supervisor and close every per-thread connection."""
        if self.supervisor is not None:
            from ..statusz import unregister_status_provider

            self.supervisor.stop()
            # a supervisor attached by hand (tests) was never registered
            provider = getattr(self, "_status_provider", None)
            if provider is not None:
                unregister_status_provider("datastore", provider)
            self.supervisor = None
        with self._conn_registry_lock:
            conns, self._conn_registry = list(self._conn_registry), set()
        for conn in conns:
            try:
                conn.close()
            except Exception:
                pass
        self._local.conn = None


class DatastoreSupervisor:
    """Per-process datastore connection supervisor: a background probe
    drives a four-state machine

        up ──(connection failures / slow commits)──▶ degraded
        degraded ──(failures ≥ down_threshold)─────▶ down
        down ──(probe succeeds)────────────────────▶ recovering
        recovering ──(recover_threshold successes)─▶ up
                   └─(any failure)─────────────────▶ down

    fed by both the probe and real transactions (run_tx reports every
    connection-class failure and every commit). Consumers: the report
    writer spills uploads to the journal while it is not up; the
    admission controller sheds the aggregate routes 503 while it is not
    up; both job drivers stop acquiring while it is down and step back
    by `reconnect_delay_s()`. While down, the probe retries on a
    full-jitter backoff from probe_interval_s toward
    reconnect_max_interval_s. `transition_log` keeps each change as
    (time.monotonic(), new state)."""

    STATES = ("up", "degraded", "down", "recovering")

    def __init__(
        self,
        ds: Datastore,
        probe_interval_s: float = 5.0,
        down_threshold: int = 3,
        recover_threshold: int = 2,
        reconnect_max_interval_s: float = 30.0,
        degraded_hold_s: float = 10.0,
    ):
        self._ds = ds
        self.probe_interval_s = max(0.05, float(probe_interval_s))
        self.down_threshold = max(1, int(down_threshold))
        self.recover_threshold = max(1, int(recover_threshold))
        self.reconnect_max_interval_s = max(self.probe_interval_s, float(reconnect_max_interval_s))
        self.degraded_hold_s = max(0.0, float(degraded_hold_s))
        self._lock = threading.Lock()
        self._state = "up"
        self._consecutive_failures = 0
        self._recover_successes = 0
        self._down_since: float | None = None
        self._degraded_until = 0.0
        self._last_error: str | None = None
        self._transitions: dict[str, int] = {}
        self.transition_log: list[tuple[float, str]] = []
        self._stop = threading.Event()
        # set on every state change so the probe loop re-probes now
        # instead of sleeping out a reconnect backoff
        self._kick = threading.Event()
        self._thread: threading.Thread | None = None
        self._publish_locked()

    def _set_state_locked(self, new: str) -> None:
        if new == self._state:
            return
        _log.warning("datastore supervisor: %s -> %s", self._state, new)
        self._state = new
        self._transitions[new] = self._transitions.get(new, 0) + 1
        self.transition_log.append((_time.monotonic(), new))
        self._down_since = _time.monotonic() if new == "down" else None
        self._kick.set()

    def _publish_locked(self) -> None:
        from .. import metrics

        metrics.datastore_up.set(0.0 if self._state == "down" else 1.0)
        metrics.datastore_consecutive_failures.set(float(self._consecutive_failures))

    def record_failure(self, error: BaseException | None = None) -> None:
        """One connection-class failure (probe or real transaction)."""
        with self._lock:
            self._consecutive_failures += 1
            self._recover_successes = 0
            if error is not None:
                self._last_error = f"{type(error).__name__}: {error}"
            if self._consecutive_failures >= self.down_threshold:
                self._set_state_locked("down")
            elif self._state == "up":
                self._set_state_locked("degraded")
            elif self._state == "recovering":
                self._set_state_locked("down")
            self._publish_locked()

    def record_success(self) -> None:
        """One successful commit or probe."""
        with self._lock:
            self._consecutive_failures = 0
            if self._state == "down":
                self._recover_successes = 1
                self._set_state_locked("recovering")
            elif self._state == "recovering":
                self._recover_successes += 1
                if self._recover_successes >= self.recover_threshold:
                    self._set_state_locked("up")
            elif self._state == "degraded" and _time.monotonic() >= self._degraded_until:
                self._set_state_locked("up")
            self._publish_locked()

    def record_slow_commit(self, elapsed_s: float) -> None:
        """A commit past the writer's spill latency threshold: the
        database is up but drowning, so degrade (uploads spill to the
        journal) for at least degraded_hold_s."""
        with self._lock:
            self._degraded_until = _time.monotonic() + self.degraded_hold_s
            if self._state == "up":
                self._set_state_locked("degraded")
            self._last_error = f"slow commit: {elapsed_s:.3f}s"
            self._publish_locked()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def reconnect_delay_s(self) -> float:
        """How long a consumer (a job driver's step-back, Retry-After)
        should wait before trying the datastore again."""
        with self._lock:
            if self._state != "down" or self._down_since is None:
                return self.probe_interval_s
            downtime = _time.monotonic() - self._down_since
            return min(max(self.probe_interval_s, downtime / 2), self.reconnect_max_interval_s)

    def readiness(self) -> str | None:
        """None when ready; a reason when not (only a hard down fails
        readiness: degraded still serves)."""
        with self._lock:
            if self._state == "down":
                return (
                    f"datastore down ({self._consecutive_failures} consecutive"
                    f" failures; last: {self._last_error})"
                )
            return None

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "down_for_s": (
                    round(_time.monotonic() - self._down_since, 1) if self._down_since is not None else None
                ),
                "last_error": self._last_error,
                "transitions": dict(self._transitions),
                "probe_interval_s": self.probe_interval_s,
            }

    def _probe_once(self) -> None:
        try:
            self._ds.probe()
        except Exception as e:
            kind = self._ds.classify_error(e)
            # serialization-class probe failures are contention, not an
            # outage: real traffic is getting through
            if kind in ("connection", "other", "fatal"):
                self.record_failure(e)
        else:
            self.record_success()

    def _probe_delay_s(self) -> float:
        import random

        if self.state != "down":
            return self.probe_interval_s
        # jittered reconnect backoff while down, growing toward the cap
        with self._lock:
            downtime = _time.monotonic() - self._down_since if self._down_since else 0.0
        ceiling = min(
            self.reconnect_max_interval_s,
            self.probe_interval_s * (1 + downtime / (4 * self.probe_interval_s)),
        )
        return random.uniform(self.probe_interval_s * 0.5, ceiling)

    def _run(self) -> None:
        # first probe at once: a process booted mid-outage must not
        # advertise up for a whole interval
        while not self._stop.is_set():
            self._probe_once()
            self._kick.clear()
            # stop() sets _stop before its kick: a kick cleared just above
            # shows here, so the loop never sleeps through its stop
            if self._stop.is_set():
                return
            self._kick.wait(self._probe_delay_s())

    def start(self) -> "DatastoreSupervisor":
        if self._thread is None:
            self._thread = threading.Thread(target=self._run, name="datastore-supervisor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=5)
            self._thread = None


def _pg_schema() -> str:
    """The canonical DDL translated for Postgres: BLOB->BYTEA,
    INTEGER->BIGINT (SQLite's INTEGER is 64-bit; Postgres's is 32)."""
    ddl = re.sub(r"\bBLOB\b", "BYTEA", _SCHEMA)
    ddl = re.sub(r"\bINTEGER\b", "BIGINT", ddl)
    return ddl


class PostgresDatastore(Datastore):
    """Postgres engine: the reference's horizontal-scaling deployment
    (datastore.rs:203-305): REPEATABLE READ with retry on serialization
    failure, `FOR UPDATE SKIP LOCKED` lease claims (datastore.rs:
    1836-1905), many worker hosts against one database.

    `dsn` is a postgres:// or postgresql:// URL. An optional `schema`
    confines the tables to a named schema. `driver` injects a
    psycopg-shaped module (connect, IsolationLevel, errors,
    OperationalError): the real psycopg by default, pg_fake's
    FakePostgresDriver where no server exists."""

    DIALECT = "postgres"
    # arbitrary fixed key serializing concurrent schema bootstrap
    _BOOTSTRAP_LOCK_KEY = 0x6A616E7573  # "janus"

    def __init__(self, dsn: str, crypter: Crypter, clock, schema: str | None = None, driver=None):
        self._driver = driver if driver is not None else _psycopg
        if self._driver is None:
            raise RuntimeError("database.url is postgres:// but psycopg is not installed")
        self._dsn = dsn
        self._schema = schema
        super().__init__(dsn, crypter, clock)

    def _bootstrap_schema(self) -> None:
        conn = self._connect()
        try:
            # advisory lock: worker hosts booting against an empty database
            # would otherwise race the CREATEs and the version insert
            conn.execute("SELECT pg_advisory_xact_lock(%s)", (self._BOOTSTRAP_LOCK_KEY,))
            if self._schema is not None:
                conn.execute(f'CREATE SCHEMA IF NOT EXISTS "{self._schema}"')
            for stmt in _pg_schema().split(";"):
                if stmt.strip():
                    conn.execute(stmt)
            row = conn.execute("SELECT version FROM schema_version").fetchone()
            if row is None:
                conn.execute("INSERT INTO schema_version (version) VALUES (%s)", (SCHEMA_VERSION,))
            elif row[0] != SCHEMA_VERSION:
                raise RuntimeError(f"unsupported schema version {row[0]}")
            conn.commit()
        except BaseException:
            conn.rollback()
            raise

    def _connect(self):
        self._hit_connect_failpoint()
        conn = getattr(self._local, "conn", None)
        if conn is None:
            kwargs = {}
            if self._schema is not None:
                kwargs["options"] = f"-c search_path={self._schema}"
            conn = self._driver.connect(self._dsn, autocommit=False, **kwargs)
            conn.isolation_level = self._driver.IsolationLevel.REPEATABLE_READ
            self._local.conn = conn
            self._register_conn(conn)
        return conn

    def _begin(self, conn) -> None:
        # psycopg opens the transaction at the first statement
        # (autocommit=False), at the connection's isolation level
        pass

    def _adapt(self, conn):
        return _PgConnAdapter(conn)

    def _connection_lost_error(self, msg: str) -> Exception:
        return self._driver.OperationalError(msg)

    def _discard_if_broken(self, conn) -> None:
        if getattr(conn, "closed", False) or getattr(conn, "broken", False):
            self._discard(conn)

    def classify_error(self, e: BaseException) -> str:
        errs = self._driver.errors
        if isinstance(e, LeaseConflict):
            return "fatal"
        if isinstance(e, (errs.SerializationFailure, errs.DeadlockDetected, TxConflict)):
            return "serialization"
        if isinstance(e, self._driver.OperationalError):
            # lost or refused connections and server shutdown
            return "connection"
        if isinstance(e, getattr(self._driver, "ProgrammingError", ())):
            return "fatal"
        return "other"

    @property
    def _retryable_errors(self) -> tuple:
        return (
            self._driver.errors.SerializationFailure,
            self._driver.errors.DeadlockDetected,
            self._driver.OperationalError,
            TxConflict,
        )

    def drop_schema(self) -> None:
        """Test teardown: drop the confined schema and everything in it."""
        assert self._schema is not None
        conn = self._connect()
        conn.execute(f'DROP SCHEMA IF EXISTS "{self._schema}" CASCADE')
        conn.commit()


def open_datastore(url: str, crypter: Crypter, clock):
    """database.url dispatch: postgres:// -> PostgresDatastore, anything
    else is a SQLite path (reference DbConfig, config.rs:61)."""
    if url.startswith(("postgres://", "postgresql://")):
        return PostgresDatastore(url, crypter, clock)
    return Datastore(url, crypter, clock)


class EphemeralDatastore:
    """A datastore removed by cleanup() (the analog of the reference's
    ephemeral test database, datastore/test_util.rs:26-120).

    engine="sqlite" (default) uses a temporary file; engine="pgfake" runs
    PostgresDatastore over pg_fake's recorded-conversation driver (the
    Postgres engine's code paths, SQLite rows; `pg_driver` holds its
    log); engine="postgres" uses the server at $JANUS_TEST_DATABASE_URL
    in a random schema dropped on cleanup."""

    def __init__(self, clock=None, crypter: Crypter | None = None, engine: str = "sqlite"):
        from ..core.time_util import MockClock

        self.clock = clock if clock is not None else MockClock()
        self.crypter = crypter or Crypter()
        self._dir = None
        self.pg_driver = None
        if engine == "postgres":
            url = os.environ.get("JANUS_TEST_DATABASE_URL")
            if not url:
                raise RuntimeError("JANUS_TEST_DATABASE_URL not set")
            schema = "janus_test_" + secrets.token_hex(8)
            self.datastore = PostgresDatastore(url, self.crypter, self.clock, schema=schema)
        elif engine == "pgfake":
            from .pg_fake import FakePostgresDriver

            self.pg_driver = FakePostgresDriver()
            self.datastore = PostgresDatastore(
                "postgresql://pgfake/janus", self.crypter, self.clock, schema="janus_pgfake", driver=self.pg_driver
            )
        elif engine == "sqlite":
            self._dir = tempfile.TemporaryDirectory(prefix="janus-tpu-torch-ds-")
            self.datastore = Datastore(os.path.join(self._dir.name, "ds.sqlite"), self.crypter, self.clock)
        else:
            raise ValueError(f"unknown datastore engine {engine!r}")

    def cleanup(self) -> None:
        if isinstance(self.datastore, PostgresDatastore):
            self.datastore.drop_schema()
        self.datastore.close()
        if self.pg_driver is not None:
            self.pg_driver.cleanup()
        if self._dir is not None:
            self._dir.cleanup()
