"""Recorded-conversation fake of the psycopg driver surface.

The port's own copy of janus_tpu/datastore/pg_fake.py. Neither image
the port runs in has a Postgres server or psycopg, so the
`PostgresDatastore` engine (reference aggregator_core/src/datastore.rs:
203-305) would otherwise never execute. This driver stands in for
psycopg at the exact seam `PostgresDatastore` uses (`connect`,
`IsolationLevel`, `errors.*`, `OperationalError`), so the PG adapter's
Python logic — `%s` parameter binding, implicit-BEGIN transaction
management, REPEATABLE-READ retry loop, broken-connection discard,
advisory-lock bootstrap, FOR UPDATE SKIP LOCKED lease claims — runs for
real against a shared SQLite file that plays the server.

Two layers of fidelity:

- **Conversation**: every statement is recorded exactly as it would hit
  the PG wire (after the adapter's `?`→`%s` rewrite), plus
  connect/commit/rollback/close events. tests/test_torch_pg.py holds the
  port's streams equal to janus_tpu's for the lease and retry paths.
- **Execution**: statements are translated back (`%s`→`?`, PG-only
  statements mapped to no-ops) and executed on SQLite, so typed ops see
  real rows.

What this cannot prove: genuine PG server semantics (MVCC snapshot
behavior, serialization-failure timing, type coercion details).

Error taxonomy mirrors psycopg's: SerializationFailure and
DeadlockDetected subclass OperationalError, which subclasses Error.
SQLite "database is locked" surfaces as OperationalError — the same
retryable class a PG worker sees on a dropped connection.
"""

from __future__ import annotations

import os
import re
import sqlite3
import tempfile
import threading


class Error(Exception):
    pass


class OperationalError(Error):
    pass


class IntegrityError(Error):
    pass


class SerializationFailure(OperationalError):
    pass


class DeadlockDetected(OperationalError):
    pass


class InFailedSqlTransaction(Error):
    pass


class _Errors:
    """The `psycopg.errors` namespace subset the datastore touches."""

    SerializationFailure = SerializationFailure
    DeadlockDetected = DeadlockDetected
    IntegrityError = IntegrityError
    InFailedSqlTransaction = InFailedSqlTransaction


class _IsolationLevel:
    READ_COMMITTED = 1
    REPEATABLE_READ = 2
    SERIALIZABLE = 3


_ADVISORY_LOCK_RE = re.compile(r"^\s*SELECT\s+pg_advisory_xact_lock", re.I)
_CREATE_SCHEMA_RE = re.compile(r"^\s*CREATE\s+SCHEMA\b", re.I)
_DROP_SCHEMA_RE = re.compile(r"^\s*DROP\s+SCHEMA\b", re.I)
# PG row-locking clause SQLite has no parse for; recorded verbatim,
# stripped for execution (SQLite's database-level write lock is the
# stand-in — the real SKIP LOCKED semantics need the real-PG suite).
# Matched at statement end OR at a subquery's closing paren: the
# batched lease claim puts it INSIDE the candidate subquery
# (UPDATE .. WHERE (..) IN (SELECT .. FOR UPDATE SKIP LOCKED)).
_FOR_UPDATE_RE = re.compile(r"\s+FOR\s+UPDATE(\s+SKIP\s+LOCKED)?(?=\s*\)|\s*$)", re.I)


def _to_sqlite(sql: str) -> str:
    return _FOR_UPDATE_RE.sub("", sql).replace("%s", "?")


# UPDATE ... RETURNING needs SQLite >= 3.35; on older system libs the
# fake emulates it (see FakeConnection._execute_update_returning) so
# the recorded PG wire form never changes.
_SQLITE_RETURNING = sqlite3.sqlite_version_info >= (3, 35)
_UPDATE_RETURNING_RE = re.compile(
    r"^\s*(UPDATE\s+(\w+)\s+SET\s+.+?)\s+RETURNING\s+(.+?)\s*$", re.I | re.S
)


def _depth0_where(s: str) -> int:
    """Index of the outermost ' WHERE ' (paren depth 0), or -1."""
    depth = 0
    u = s.upper()
    for i, c in enumerate(s):
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        elif depth == 0 and u.startswith(" WHERE ", i):
            return i
    return -1


class FakeConnection:
    """psycopg-Connection surface: execute/cursor/commit/rollback/close,
    `closed`/`broken` flags, assignable `isolation_level`. Transactions
    are implicit (BEGIN at first statement), matching psycopg
    autocommit=False."""

    def __init__(self, driver: "FakePostgresDriver"):
        self._driver = driver
        self._sq = sqlite3.connect(
            driver._db_path, timeout=5.0, isolation_level=None, check_same_thread=False
        )
        self._sq.execute("PRAGMA foreign_keys=ON")
        self._in_tx = False
        self.closed = False
        self.broken = False
        self.isolation_level = None

    # -- transaction management (implicit BEGIN, like psycopg) --
    def _ensure_tx(self):
        if not self._in_tx:
            self._sq.execute("BEGIN")
            self._in_tx = True

    def execute(self, sql: str, params=()):
        self._driver._record("execute", sql, tuple(params))
        if self.broken or self.closed:
            raise OperationalError("connection is broken")
        self._driver._maybe_inject(self, sql, params)
        if _ADVISORY_LOCK_RE.match(sql):
            self._ensure_tx()
            return self._sq.execute("SELECT 1")
        if _CREATE_SCHEMA_RE.match(sql) or _DROP_SCHEMA_RE.match(sql):
            self._ensure_tx()
            return self._sq.execute("SELECT 1")
        self._ensure_tx()
        try:
            if not _SQLITE_RETURNING:
                m = _UPDATE_RETURNING_RE.match(sql)
                if m:
                    return self._execute_update_returning(m, tuple(params))
            return self._sq.execute(_to_sqlite(sql), params)
        except sqlite3.IntegrityError:
            raise  # _INTEGRITY_ERRORS catches the sqlite3 class
        except sqlite3.OperationalError as e:
            raise OperationalError(str(e)) from e

    def _execute_update_returning(self, m: "re.Match", params: tuple):
        """UPDATE ... RETURNING on a pre-3.35 sqlite: pin the matching
        rowids first, update only those, then select the RETURNING
        columns back by rowid. Equivalent inside the surrounding
        transaction (single writer); the conversation log above already
        recorded the genuine PG wire form."""
        head, table, cols = m.group(1), m.group(2), m.group(3)
        wi = _depth0_where(head)
        set_part, where = (head[:wi], head[wi + 7 :]) if wi >= 0 else (head, None)
        n_set = set_part.count("%s")
        if where is None:
            sel = f"SELECT rowid FROM {table}"  # noqa: S608 - fake, test-only
            rowids = [r[0] for r in self._sq.execute(sel).fetchall()]
        else:
            sel = f"SELECT rowid FROM {table} WHERE {_to_sqlite(where)}"
            rowids = [r[0] for r in self._sq.execute(sel, params[n_set:]).fetchall()]
        if not rowids:
            return self._sq.execute(f"SELECT {_to_sqlite(cols)} FROM {table} WHERE 0")
        ph = ",".join("?" * len(rowids))
        self._sq.execute(
            f"{_to_sqlite(set_part)} WHERE rowid IN ({ph})",
            params[:n_set] + tuple(rowids),
        )
        return self._sq.execute(
            f"SELECT {_to_sqlite(cols)} FROM {table} WHERE rowid IN ({ph})",
            tuple(rowids),
        )

    def cursor(self):
        conn = self

        class _Cur:
            def executemany(self, sql, seq):
                seq = [tuple(p) for p in seq]
                conn._driver._record("executemany", sql, tuple(seq))
                if conn.broken or conn.closed:
                    raise OperationalError("connection is broken")
                conn._driver._maybe_inject(conn, sql, seq)
                conn._ensure_tx()
                try:
                    self._c = conn._sq.executemany(_to_sqlite(sql), seq)
                except sqlite3.IntegrityError:
                    raise
                except sqlite3.OperationalError as e:
                    raise OperationalError(str(e)) from e
                return self._c

            def __getattr__(self, name):
                # Guard: before executemany() runs there is no `_c`, and
                # a bare `getattr(self._c, ...)` would re-enter this
                # __getattr__ for `_c` itself — infinite recursion
                # surfacing as RecursionError.
                if name == "_c":
                    raise AttributeError(
                        "cursor has no result yet: call executemany() first"
                    )
                return getattr(self._c, name)

        return _Cur()

    def commit(self):
        self._driver._record("commit")
        if self.broken or self.closed:
            raise OperationalError("connection is broken")
        if self._in_tx:
            self._sq.execute("COMMIT")
            self._in_tx = False

    def rollback(self):
        self._driver._record("rollback")
        if self.broken or self.closed:
            raise OperationalError("connection is broken")
        if self._in_tx:
            self._sq.execute("ROLLBACK")
            self._in_tx = False

    def close(self):
        self._driver._record("close")
        self.closed = True
        try:
            self._sq.close()
        except Exception:
            pass


class FakePostgresDriver:
    """Module-shaped driver object: pass as `PostgresDatastore(driver=...)`."""

    errors = _Errors
    OperationalError = OperationalError
    Error = Error
    IsolationLevel = _IsolationLevel

    def __init__(self, db_path: str | None = None):
        if db_path is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="janus-torch-pgfake-")
            db_path = os.path.join(self._tmp.name, "pgfake.sqlite")
        else:
            self._tmp = None
        self._db_path = db_path
        self._lock = threading.Lock()
        self.log: list[tuple] = []
        self.connections: list[FakeConnection] = []
        # (predicate(sql, params) -> bool, exception, once) injection
        # rules, checked before execution — tests script failures here
        self._injections: list[list] = []

    # -- psycopg module surface --
    def connect(self, dsn: str, autocommit: bool = False, **kwargs):
        self._record("connect", dsn, tuple(sorted(kwargs)))
        assert autocommit is False, "datastore always runs transactional"
        conn = FakeConnection(self)
        self.connections.append(conn)
        return conn

    # -- recording / scripting --
    def _record(self, kind: str, *detail):
        with self._lock:
            self.log.append((kind, *detail))

    def _maybe_inject(self, conn, sql, params):
        with self._lock:
            for rule in self._injections:
                pred, exc, once, break_conn = rule
                if pred(sql, params):
                    if once:
                        self._injections.remove(rule)
                    if break_conn:
                        # model a dropped server connection: psycopg
                        # marks the connection broken and every later
                        # operation on it (rollback included) fails
                        conn.broken = True
                    raise exc

    def inject_once(self, predicate, exc: Exception, break_connection: bool = False):
        """Raise `exc` on the first statement matching predicate(sql,
        params). With break_connection=True the connection is marked
        broken first (the dropped-mid-transaction shape: the datastore
        must discard it and redial, never retry into it)."""
        self._injections.append([predicate, exc, True, break_connection])

    def statements(self, kind: str = "execute") -> list[tuple]:
        return [e for e in self.log if e[0] == kind]

    def clear_log(self):
        with self._lock:
            self.log.clear()

    def cleanup(self):
        for c in self.connections:
            if not c.closed:
                try:
                    c.close()
                except Exception:
                    pass
        if self._tmp is not None:
            self._tmp.cleanup()
