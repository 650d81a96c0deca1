"""Report-flow conservation ledger (docs/OBSERVABILITY.md
"Conservation accounting").

Every metric family this repo exports counts *events*; none of them
*balance*. This module treats the report pipeline as a balanced
accounting equation over datastore-backed per-task lifecycle counters
(the task_counters table): every admitted report must end in exactly
one terminal state — aggregated, rejected{reason}, expired — or be
attributably in-flight (unclaimed client_reports, a live job's
report_aggregations, aggregated mass awaiting collection). The books
close per (task, stage):

    stage="ingest":  admitted - aggregated - rejected - expired
                     - pending_reports - pending_aggregation  == 0
    stage="param":   admitted_param - aggregated_param - rejected_param
                     - expired_param - pending_aggregation_param == 0
    stage="collect": aggregated + aggregated_param - collected
                     - awaiting_collection == 0

A sustained positive residual is a silently lost report; a sustained
negative one is a double-count (e.g. a replayed job step whose
counters were incremented outside its transaction). Counter updates
therefore always ride INSIDE the transaction of the state change they
count — run_tx retries re-run the whole closure, so in-tx increments
are exactly-once where in-process counters double-count, and a fleet
of driver binaries over one datastore shares one consistent set of
books.

The evaluator runs at health-sampler cadence, exports
janus_ledger_imbalance{task_id,stage} plus janus_ledger_breach_active
once a residual stays nonzero past the grace window (transient
read-snapshot skew between the counter read and the in-flight read —
e.g. a report admitted between the two statements under Postgres
read-committed — self-clears within a tick), and feeds the
`conservation` SLO signal kind (slo.py). Cross-aggregator
reconciliation (the collection driver fetching the helper's per-batch
aggregated counts) reports through record_peer_divergence and pages
through the same breach gauge with stage="peer".

Resident-share loss (engine_resident_flushes_total{outcome="lost"}) is
a SHARE-mass loss, not a count loss: the counts were durable at each
job's commit, so the count books above still close — which is exactly
why it gets its own `lost` counter + builtin SLO (resident_lost)
instead of a seat in the count equation.

The port's own copy of janus_tpu/ledger.py: the same counter names,
bookings and balance equations, so a port aggregator reconciles with a
janus_tpu one in either role. The port has no health sampler yet: the
caller evaluates (`evaluate_once`), and the `conservation` SLO signal
comes with the SLO engine.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

from . import metrics
from .metrics import task_id_label

log = logging.getLogger(__name__)

# Counter-name taxonomy (task_counters.counter_name). Rejections are
# per-reason: "rejected:<prepare error name>".
ADMITTED = "admitted"
AGGREGATED = "aggregated"
COLLECTED = "collected"
EXPIRED = "expired"
EXPIRED_RECLAIMED = "expired_reclaimed"
LOST = "lost"
REJECTED_PREFIX = "rejected:"

# Parameter-fanout lane (VDAFs with nontrivial aggregation parameters,
# e.g. Poplar1): one admitted report legitimately aggregates once PER
# collection parameter, so booking those FINISHED rows as `aggregated`
# would debit a single `admitted` several times and drive the ingest
# residual permanently negative. The fanout keeps its own books —
# admission is the creation of the (report, param) report_aggregations
# row (leader: _ensure_param_aggregation; helper: the init handler) and
# every such admission must reach exactly one param-lane terminal:
#
#   stage="param": admitted_param - aggregated_param
#                  - Σ rejected_param:<reason> - expired_param
#                  - pending_aggregation_param               == 0
#
# The canonical ingest equation never sees the fanout (a param task's
# client_reports stay in pending_reports until GC expiry), while the
# collect equation uses aggregated + aggregated_param: batch
# aggregation rows carry the param mass, and collections drain it.
ADMITTED_PARAM = "admitted_param"
AGGREGATED_PARAM = "aggregated_param"
EXPIRED_PARAM = "expired_param"
REJECTED_PARAM_PREFIX = "rejected_param:"


@dataclass
class LedgerConfig:
    """The YAML `ledger:` stanza (CommonConfig). `grace_s` is how long
    a nonzero residual must persist before it counts as a breach
    (feeds janus_ledger_breach_active and the conservation SLO);
    `reconcile_peer` turns the leader collection driver's
    fetch-the-helper's-counts pass on/off."""

    enabled: bool = True
    grace_s: float = 120.0
    reconcile_peer: bool = True

    @classmethod
    def from_dict(cls, d: dict | None) -> "LedgerConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", True)),
            grace_s=float(d.get("grace_secs", d.get("grace_s", 120.0))),
            reconcile_peer=bool(d.get("reconcile_peer", True)),
        )


# ---------------------------------------------------------------------------
# Transaction-side counting helpers — the choke points call these INSIDE
# the write transaction of the state change being counted.
# ---------------------------------------------------------------------------


def count_admitted(tx, task_id, n: int, aggregation_parameter: bytes = b"") -> None:
    """A report became durable (fresh put, not a replay): leader
    report_writer flush / journal replay, or the helper's init handler
    writing the job's report_aggregations rows (the helper has no
    client_reports — the RA rows ARE its admission record). A non-empty
    aggregation parameter books into the param-fanout lane instead
    (one admission per (report, param))."""
    if n > 0:
        key = ADMITTED_PARAM if aggregation_parameter else ADMITTED
        tx.increment_task_counters(task_id, {key: n})


def count_ra_outcomes(
    tx, task_id, ras, unmerged=frozenset(), aggregation_parameter: bytes = b""
) -> None:
    """Book the terminal outcomes of a report_aggregations write batch:
    FINISHED rows whose share merged are `aggregated`, FINISHED rows in
    the flush's unmergeable set are rejected:batch_collected (the
    caller rewrites the row the same way), FAILED rows are
    rejected:<reason>. Non-terminal (waiting) rows stay in-flight and
    are not booked. Rows of a job with a non-empty aggregation
    parameter book into the param-fanout lane (`aggregated_param` /
    `rejected_param:<reason>`): a report FINISHES once per parameter,
    so those terminals must never debit the single `admitted`."""
    from .datastore.models import ReportAggregationState

    agg_key = AGGREGATED_PARAM if aggregation_parameter else AGGREGATED
    rej_prefix = REJECTED_PARAM_PREFIX if aggregation_parameter else REJECTED_PREFIX
    deltas: dict[str, int] = {}
    for ra in ras:
        if ra.state == ReportAggregationState.FINISHED:
            if ra.report_id.data in unmerged:
                key = rej_prefix + "batch_collected"
            else:
                key = agg_key
        elif ra.state == ReportAggregationState.FAILED:
            err = getattr(ra, "prepare_error", None)
            name = err.name.lower() if err is not None else "unknown"
            key = rej_prefix + name
        else:
            continue
        deltas[key] = deltas.get(key, 0) + 1
    if deltas:
        tx.increment_task_counters(task_id, deltas)


def count_collected(tx, task_id, rows) -> None:
    """Book the aggregated mass a collection is about to mark collected
    — only rows still uncollected at gather time, so a re-query of the
    same batch (max_batch_query_count > 1) books nothing twice."""
    from .datastore.models import BatchAggregationState

    n = sum(
        int(row.report_count)
        for row in rows
        if row.state != BatchAggregationState.COLLECTED
    )
    if n > 0:
        tx.increment_task_counters(task_id, {COLLECTED: n})


def count_lost(ds, task_id, n: int) -> None:
    """Book resident-share loss. Best-effort OWN transaction: two of
    the three loss paths are failure paths where the original
    transaction is gone (tx failure, delta-fetch failure), so this
    cannot ride a state-change tx; if the datastore is down too, the
    loss still reaches the in-process lost metric + ERROR log."""
    if n <= 0:
        return
    try:
        ds.run_tx(
            lambda tx: tx.increment_task_counters(task_id, {LOST: n}),
            "ledger_count_lost",
        )
    except Exception:
        log.warning(
            "could not book %d lost resident share(s) for task %s in the "
            "ledger; the in-process metric still carries the loss",
            n,
            task_id,
        )


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


@dataclass
class _BreachTrack:
    first_nonzero: float | None = None
    value: float = 0.0


class LedgerEvaluator:
    """Periodic balance evaluation over one datastore. `evaluate_once()`
    runs at health-sampler cadence (HealthSampler calls it when a
    ledger is installed); the latest balance document is held for the
    `ledger` statusz section and GET /debug/ledger — readers get the
    last COMPLETE document under a lock, never a torn mid-evaluation
    view, and a datastore error keeps the previous document."""

    def __init__(self, ds, cfg: LedgerConfig | None = None):
        self.ds = ds
        self.cfg = cfg or LedgerConfig()
        self._lock = threading.Lock()
        # complete shape from birth: a scrape racing the first sampler
        # tick still sees every documented key (scrape_check pins them)
        self._doc: dict = {
            "enabled": True,
            "evaluations": 0,
            "tasks": {},
            "breaches": [],
        }
        self._evaluations = 0
        # (task label, stage) -> breach tracking state
        self._tracks: dict[tuple[str, str], _BreachTrack] = {}
        # task label -> latest peer reconciliation result
        self._peer: dict[str, dict] = {}

    # -- feed: cross-aggregator reconciliation (collection driver) -----
    def record_peer_divergence(
        self, task_id, ours: dict[str, int], theirs: dict[str, int]
    ) -> int:
        """Compare our aggregated counts against the helper's, keyed by
        (batch identifier, aggregation parameter) — per-param keys keep
        a multi-parameter task's fanout from inflating one batch's
        count — and restricted to the keys WE cover (the helper may not
        have created rows for a batch still aggregating on its side).
        Returns the total absolute divergence and exports it."""
        label = task_id_label(task_id.data)
        divergence = 0
        detail = {}
        for bid, n in ours.items():
            peer_n = int(theirs.get(bid, 0))
            if peer_n != n:
                divergence += abs(n - peer_n)
                detail[bid] = {"ours": n, "helper": peer_n}
        rl = metrics.replica_labels()
        metrics.ledger_peer_divergence.set(float(divergence), task_id=label, **rl)
        with self._lock:
            self._peer[label] = {
                "divergence": divergence,
                "batches_compared": len(ours),
                "mismatched": detail,
                "at_unix": time.time(),
            }
        self._breach_update(label, "peer", float(divergence), time.monotonic())
        return divergence

    # -- evaluation ----------------------------------------------------
    def evaluate_once(self) -> dict:
        try:
            doc = self._evaluate()
        except Exception:
            metrics.ledger_evaluations_total.add(outcome="error")
            log.exception("ledger evaluation failed; keeping previous balance")
            with self._lock:
                return dict(self._doc)
        metrics.ledger_evaluations_total.add(outcome="ok")
        with self._lock:
            self._doc = doc
            return dict(doc)

    def _evaluate(self) -> dict:
        def read(tx):
            return tx.get_all_task_counters(), tx.ledger_inflight_by_task()

        counters, inflight = self.ds.run_tx(read, "ledger_snapshot")
        now_mono = time.monotonic()
        rl = metrics.replica_labels()
        self._evaluations += 1
        with self._lock:
            peer_snapshot = dict(self._peer)
        tasks_doc: dict[str, dict] = {}
        for task_id_bytes in sorted(set(counters) | set(inflight)):
            c = counters.get(task_id_bytes, {})
            f = inflight.get(task_id_bytes, {})
            label = task_id_label(task_id_bytes)
            admitted = c.get(ADMITTED, 0)
            aggregated = c.get(AGGREGATED, 0)
            collected = c.get(COLLECTED, 0)
            expired = c.get(EXPIRED, 0)
            lost = c.get(LOST, 0)
            rejected = {
                k[len(REJECTED_PREFIX):]: v
                for k, v in c.items()
                if k.startswith(REJECTED_PREFIX)
            }
            rejected_total = sum(rejected.values())
            admitted_param = c.get(ADMITTED_PARAM, 0)
            aggregated_param = c.get(AGGREGATED_PARAM, 0)
            expired_param = c.get(EXPIRED_PARAM, 0)
            rejected_param = {
                k[len(REJECTED_PARAM_PREFIX):]: v
                for k, v in c.items()
                if k.startswith(REJECTED_PARAM_PREFIX)
            }
            pending_reports = f.get("pending_reports", 0)
            pending_aggregation = f.get("pending_aggregation", 0)
            pending_aggregation_param = f.get("pending_aggregation_param", 0)
            awaiting_collection = f.get("awaiting_collection", 0)

            ingest = (
                admitted
                - aggregated
                - rejected_total
                - expired
                - pending_reports
                - pending_aggregation
            )
            param = (
                admitted_param
                - aggregated_param
                - sum(rejected_param.values())
                - expired_param
                - pending_aggregation_param
            )
            # collect balances COUNT mass through batch_aggregations,
            # which carries both lanes (param tasks' shards are keyed by
            # their aggregation parameter but drain through the same
            # collected/awaiting accounting)
            collect = aggregated + aggregated_param - collected - awaiting_collection
            metrics.ledger_imbalance.set(float(ingest), task_id=label, stage="ingest", **rl)
            metrics.ledger_imbalance.set(float(param), task_id=label, stage="param", **rl)
            metrics.ledger_imbalance.set(float(collect), task_id=label, stage="collect", **rl)
            self._breach_update(label, "ingest", float(ingest), now_mono)
            self._breach_update(label, "param", float(param), now_mono)
            self._breach_update(label, "collect", float(collect), now_mono)

            tasks_doc[label] = {
                "admitted": admitted,
                "aggregated": aggregated,
                "rejected": rejected,
                "expired": expired,
                "expired_reclaimed": c.get(EXPIRED_RECLAIMED, 0),
                "lost": lost,
                "collected": collected,
                "param": {
                    "admitted": admitted_param,
                    "aggregated": aggregated_param,
                    "rejected": rejected_param,
                    "expired": expired_param,
                },
                "in_flight": {
                    "pending_reports": pending_reports,
                    "pending_aggregation": pending_aggregation,
                    "pending_aggregation_param": pending_aggregation_param,
                    "awaiting_collection": awaiting_collection,
                },
                "imbalance": {"ingest": ingest, "param": param, "collect": collect},
                "peer": peer_snapshot.get(label),
            }

        # peer tracks only gain fresh values when a collection finishes
        # (record_peer_divergence); re-evaluating them here keeps the
        # breach gauge and the breach list advancing every sampler tick
        # even when no collection runs during the grace window.
        with self._lock:
            peer_tracks = [
                (label, tr.value)
                for (label, stage), tr in self._tracks.items()
                if stage == "peer"
            ]
        for label, value in peer_tracks:
            self._breach_update(label, "peer", value, now_mono)

        with self._lock:
            breaches = sorted(
                f"{label}/{stage}"
                for (label, stage), tr in self._tracks.items()
                if self._breached(tr, now_mono)
            )
        return {
            "enabled": True,
            "evaluations": self._evaluations,
            "grace_s": self.cfg.grace_s,
            "evaluated_at_unix": time.time(),
            "tasks": tasks_doc,
            "breaches": breaches,
        }

    # -- breach tracking -----------------------------------------------
    def _breach_update(self, label: str, stage: str, value: float, now_mono: float) -> None:
        # _tracks is shared between the sampler thread (_evaluate) and
        # collection-driver threads (record_peer_divergence): mutate it
        # only under the lock, and do the metric/log I/O outside it.
        with self._lock:
            tr = self._tracks.setdefault((label, stage), _BreachTrack())
            tr.value = value
            if value == 0:
                tr.first_nonzero = None
            elif tr.first_nonzero is None:
                tr.first_nonzero = now_mono
            breached = self._breached(tr, now_mono)
        metrics.ledger_breach_active.set(
            1.0 if breached else 0.0,
            task_id=label,
            stage=stage,
            **metrics.replica_labels(),
        )
        if breached:
            log.error(
                "conservation breach: task %s stage %s residual %g nonzero "
                "for more than the %gs grace window",
                label,
                stage,
                value,
                self.cfg.grace_s,
            )

    def _breached(self, tr: _BreachTrack, now_mono: float) -> bool:
        return (
            tr.first_nonzero is not None
            and (now_mono - tr.first_nonzero) >= self.cfg.grace_s
        )

    # -- surfaces ------------------------------------------------------
    def document(self) -> dict:
        """The latest complete balance document (GET /debug/ledger).
        Lock-protected copy: a concurrent evaluation never hands a
        reader a torn half-written table."""
        with self._lock:
            return dict(self._doc)

    def status(self) -> dict:
        """The `ledger` statusz section: the balance table, compressed
        to what an operator scans first."""
        with self._lock:
            doc = dict(self._doc)
        return {
            "enabled": True,
            "evaluations": doc.get("evaluations", 0),
            "grace_s": self.cfg.grace_s,
            "breaches": doc.get("breaches", []),
            "imbalance": {
                label: t.get("imbalance")
                for label, t in (doc.get("tasks") or {}).items()
            },
        }


# ---------------------------------------------------------------------------
# Process-ambient install (mirrors flight_recorder: the binary that owns
# the datastore installs one evaluator; the health listener's
# /debug/ledger route and the statusz section read it ambiently).
# ---------------------------------------------------------------------------

_installed: LedgerEvaluator | None = None


def install_ledger(ds, cfg: LedgerConfig | None = None) -> LedgerEvaluator | None:
    """Create + register the process's ledger evaluator (None when the
    config disables it). Registers the `ledger` statusz section."""
    global _installed
    cfg = cfg or LedgerConfig()
    if not cfg.enabled:
        _installed = None
        return None
    ev = LedgerEvaluator(ds, cfg)
    _installed = ev
    from .statusz import register_status_provider

    register_status_provider("ledger", ev.status)
    return ev


def uninstall_ledger() -> None:
    global _installed
    ev, _installed = _installed, None
    if ev is not None:
        from .statusz import unregister_status_provider

        unregister_status_provider("ledger", ev.status)


def installed_ledger() -> LedgerEvaluator | None:
    return _installed


def ledger_document() -> dict:
    """GET /debug/ledger payload for this process."""
    ev = _installed
    if ev is None:
        return {"enabled": False}
    return ev.document()
