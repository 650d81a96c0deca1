"""janus_tpu_torch's report-flow conservation ledger held against janus_tpu's.

The same seeded upload -> aggregate -> collect runs in the four
leader/helper pairings over loopback HTTP (the `Pairing` harness of
tests/test_torch_multi_round.py): a janus_tpu pair (the reference), a
port leader with a janus_tpu helper, a janus_tpu leader with a port
helper, and a port pair. Uploads go through each leader's report writer
(the booking point of `admitted`); the leader's package has its ledger
evaluator installed (grace 0), so its collection driver reconciles with
the helper over GET /tasks/{id}/ledger.

- Prio3SumVec(4, 2), 6 reports, 2 of them rejected (one helper share
  that fails HPKE, one leader share bumped so the proof fails): both
  sides' `get_all_task_counters()` equal the reference's, counter by
  counter; the helper's init request sent again (a replayed step) books
  nothing; the books balance; the peer divergence is 0 in all four
  pairings, and a tampered helper count sets the breach gauge.
- GC expiry: claimed and unclaimed reports expire with janus_tpu's
  per-lane counts (`expired`, `expired_reclaimed`).
- Poplar1 at two levels: the param lane's admissions and outcomes.
- The `ledger.drop_report` failpoint: the silently dropped report shows
  as an ingest imbalance of 1 in both packages.

`LedgerDrive` is shared with tests/test_torch_trace.py and
tests/test_torch_device_cost.py. The port runs with device="cpu";
tolerance: exact equality.
"""

import dataclasses

import pytest

from janus_tpu import failpoints as j_failpoints
from janus_tpu import ledger as j_ledger
from janus_tpu import messages as jm
from janus_tpu import metrics as j_metrics
from janus_tpu import profiler as j_profiler
from janus_tpu import trace as j_trace
from janus_tpu.aggregator import garbage_collector as j_gc
from janus_tpu.core.hpke import HpkeApplicationInfo, Label, hpke_open, hpke_seal
from janus_tpu.vdaf import registry as j_registry
from janus_tpu_torch import failpoints as t_failpoints
from janus_tpu_torch import ledger as t_ledger
from janus_tpu_torch import metrics as t_metrics
from janus_tpu_torch import profiler as t_profiler
from janus_tpu_torch import trace as t_trace
from janus_tpu_torch.aggregator import garbage_collector as t_gc
from test_torch_multi_round import PAIRINGS, PKG, TP, Pairing, make_tasks, prepare_reports, query_for

OBS = {
    "jax": dict(ledger=j_ledger, metrics=j_metrics, trace=j_trace, profiler=j_profiler, failpoints=j_failpoints,
                gc=j_gc),
    "torch": dict(ledger=t_ledger, metrics=t_metrics, trace=t_trace, profiler=t_profiler, failpoints=t_failpoints,
                  gc=t_gc),
}

VDAF = j_registry.VdafInstance.sum_vec(4, 2)
TASKS = make_tasks(VDAF)
MEASUREMENTS = [[1, 2, 3, 0], [0, 0, 1, 1], [3, 3, 3, 3], [2, 1, 0, 1], [1, 1, 1, 1], [0, 3, 2, 1]]
HPKE_FAIL, PROOF_FAIL = 1, 3


def _bump_leader_share(client, measurement):
    """A report whose leader measurement share's first element is one
    more than the client's: the helper's proof check fails."""
    from janus_tpu.client import Client

    report = Client.prepare_report(client, measurement)
    keypair = TASKS[0].hpke_keys[0]
    info = HpkeApplicationInfo(Label.INPUT_SHARE, jm.Role.CLIENT, jm.Role.LEADER)
    aad = jm.InputShareAad(TASKS[0].task_id, report.metadata, report.public_share).to_bytes()
    payload = bytearray(jm.PlaintextInputShare.from_bytes(
        hpke_open(keypair, info, report.leader_encrypted_input_share, aad)).payload)
    field = VDAF_FIELD
    v = (int.from_bytes(payload[: field.ENCODED_SIZE], "little") + 1) % field.MODULUS
    payload[: field.ENCODED_SIZE] = v.to_bytes(field.ENCODED_SIZE, "little")
    sealed = hpke_seal(keypair.config, info, jm.PlaintextInputShare((), bytes(payload)).to_bytes(), aad)
    return dataclasses.replace(report, leader_encrypted_input_share=sealed)


def _garble_helper_share(report):
    ct = report.helper_encrypted_input_share
    payload = ct.payload[:-1] + bytes([ct.payload[-1] ^ 1])
    return dataclasses.replace(report, helper_encrypted_input_share=dataclasses.replace(ct, payload=payload))


VDAF_FIELD = j_registry.circuit_for(VDAF).FIELD
REPORTS = prepare_reports(TASKS[0], TASKS[1], MEASUREMENTS)
REPORTS[HPKE_FAIL] = _garble_helper_share(REPORTS[HPKE_FAIL])
REPORTS[PROOF_FAIL] = prepare_reports(TASKS[0], TASKS[1], [MEASUREMENTS[PROOF_FAIL]], prepare=_bump_leader_share)[0]


@pytest.fixture(autouse=True)
def _single_jax_device(monkeypatch):
    """janus_tpu builds its engines on one device, the path the port ports."""
    monkeypatch.setenv("JANUS_MESH_DP", "1")
    monkeypatch.setenv("JANUS_MESH_SP", "1")
    monkeypatch.setenv("JANUS_POPLAR1_DEVICE", "0")


def _cost_by_key(profiler) -> dict:
    # keyed by VDAF too: an earlier test in the process may have booked
    # another VDAF's dispatches under the same (op, bucket)
    return {(e["vdaf"], e["op"], e["bucket"]): e for e in profiler.DEVICE_COST.status()["entries"]}


def cost_delta(before: dict, after: dict) -> dict:
    """{(vdaf, op, bucket): (dispatches, rows)} added between two
    device-cost snapshots, for the keys that gained a dispatch."""
    out = {}
    for key, e in after.items():
        e0 = before.get(key, {"dispatches": 0, "rows": 0})
        d = (e["dispatches"] - e0["dispatches"], e["rows"] - e0["rows"])
        if d[0]:
            out[key] = d
    return out


def by_op(delta: dict) -> dict:
    out: dict = {}
    for (_, op, _), (d, rows) in delta.items():
        tot = out.setdefault(op, [0, 0])
        tot[0] += d
        tot[1] += rows
    return {op: tuple(v) for op, v in out.items()}


class _RecordingHttp:
    """The leader driver's HTTP client, recording every PUT it sends."""

    def __init__(self, inner):
        self.inner = inner
        self.puts = []

    def put(self, url, body, headers=None, timeout=None):
        self.puts.append((url, body, dict(headers or {})))
        return self.inner.put(url, body, headers, timeout=timeout)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class LedgerDrive:
    """One pairing's seeded drive (see the module docstring); `run()`
    returns what the three test files compare."""

    def __init__(self, monkeypatch, leader: str, helper: str, tasks=TASKS):
        self.leader, self.helper = leader, helper
        self.lo, self.ho = OBS[leader], OBS[helper]
        self.pair = Pairing(monkeypatch, leader, helper, *tasks)
        self.lo["ledger"].install_ledger(self.pair.l_eph.datastore, self.lo["ledger"].LedgerConfig(grace_s=0.0))

    def close(self):
        self.lo["ledger"].uninstall_ledger()
        self.pair.close()

    def upload(self, reports) -> None:
        pair = self.pair
        ta = pair.l_agg.task_aggregator_for(pair.task.task_id)
        for r in reports:
            ta.handle_upload(pair.l_eph.datastore, pair.l_eph.clock, pair.lp.m.Report.from_bytes(r.to_bytes()),
                             writer=pair.l_agg.report_writer)

    def counters(self) -> dict:
        return {side: eph.datastore.run_tx(lambda tx: tx.get_all_task_counters())
                for side, eph in (("leader", self.pair.l_eph), ("helper", self.pair.h_eph))}

    def books(self) -> dict:
        """Both sides' evaluated balance documents, without timestamps."""
        out = {}
        for side, obs, eph in (("leader", self.lo, self.pair.l_eph), ("helper", self.ho, self.pair.h_eph)):
            ev = obs["ledger"].LedgerEvaluator(eph.datastore, obs["ledger"].LedgerConfig(grace_s=0.0))
            doc = ev.evaluate_once()
            out[side] = {label: {k: v for k, v in t.items() if k != "peer"} for label, t in doc["tasks"].items()}
        return out

    def peer(self) -> dict:
        doc = self.lo["ledger"].installed_ledger().evaluate_once()
        return {label: t["peer"] for label, t in doc.get("tasks", {}).items()}

    def run(self) -> dict:
        pair = self.pair
        self.upload(REPORTS)
        assert pair.create_jobs() == 1
        cost0 = {p: _cost_by_key(OBS[p]["profiler"]) for p in PKG}
        http = _RecordingHttp(pair.http())
        assert pair.agg_jobs(http=http).run_once() == 1
        cost = {p: cost_delta(cost0[p], _cost_by_key(OBS[p]["profiler"])) for p in PKG}
        stepped = self.counters()
        # the init request again: the helper answers its stored response
        # and books nothing
        (url, body, headers), = http.puts
        status, _ = http.inner.put(url, body, headers)
        assert status in (200, 201)
        assert self.counters() == stepped
        trace = self.trace_facts()
        job_id = pair.collector(self.leader).start_collection(query_for(pair.lp.m)).data
        assert pair.collection_jobs().run_once() == 1
        results = pair.poll_all(job_id)
        pkgs = {self.leader, self.helper}
        return {"stepped": stepped, "counters": self.counters(), "books": self.books(), "peer": self.peer(),
                "results": results, "trace": trace, "cost": {p: cost[p] for p in pkgs}}

    def trace_facts(self) -> dict:
        """The trace ids of the step: the leader job row's, the helper
        job row's, the leader's creator span's (trace and span id) and the
        helper's dap.aggregate_init spans'."""
        pair = self.pair

        def ctx(ds):
            return ds.run_tx(lambda tx: [r[0] for r in tx._c.execute(
                "SELECT trace_context FROM aggregation_jobs").fetchall()])

        (leader_ctx,) = ctx(pair.l_eph.datastore)
        (helper_ctx,) = ctx(pair.h_eph.datastore)

        def recent(obs, name):
            return [s for s in obs["trace"].flight_recorder().snapshot(recent_limit=512)["recent"]
                    if s["name"] == name]

        creator = recent(self.lo, "creator.create_job")[-1]
        return {
            "leader_ctx": leader_ctx,
            "helper_ctx": helper_ctx,
            "creator": (creator["trace_id"], creator["span_id"]),
            "helper_init_traces": [s["trace_id"] for s in recent(self.ho, "dap.aggregate_init")],
        }


_REFERENCE: dict = {}


def drive(monkeypatch, pairing: str) -> dict:
    """The pairing's drive; the janus_tpu pair's is computed once."""
    if pairing == "jax-jax" and "ref" in _REFERENCE:
        return _REFERENCE["ref"]
    d = LedgerDrive(monkeypatch, *pairing.split("-"))
    try:
        out = d.run()
    finally:
        d.close()
    if pairing == "jax-jax":
        _REFERENCE["ref"] = out
    return out


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_task_counters_equal_janus_tpu_after_the_same_drive(monkeypatch, pairing):
    want = drive(monkeypatch, "jax-jax")
    got = drive(monkeypatch, pairing)
    assert got["stepped"] == want["stepped"] and got["counters"] == want["counters"]
    assert got["results"] == want["results"]
    (counters,) = want["counters"]["leader"].values()
    assert counters == {"admitted": 6, "aggregated": 4, "rejected:hpke_decrypt_error": 1,
                        "rejected:vdaf_prep_error": 1, "collected": 4}
    assert want["counters"]["helper"] == want["counters"]["leader"]


@pytest.mark.parametrize("pairing", PAIRINGS)
def test_books_balance_and_reconcile_with_divergence_zero(monkeypatch, pairing):
    got = drive(monkeypatch, pairing)
    assert got["books"] == drive(monkeypatch, "jax-jax")["books"]
    for side in ("leader", "helper"):
        (t,) = got["books"][side].values()
        assert t["imbalance"] == {"ingest": 0, "param": 0, "collect": 0}
    (peer,) = got["peer"].values()
    assert peer["divergence"] == 0 and peer["batches_compared"] == 1 and peer["mismatched"] == {}


def test_a_tampered_helper_count_raises_the_breach_gauge(monkeypatch):
    """A port pair after the drive; the helper's batch row then gains a
    report it never aggregated, and the leader's reconciliation reads the
    divergence and the breach."""
    d = LedgerDrive(monkeypatch, "torch", "torch")
    try:
        d.run()
        pair = d.pair
        pair.h_eph.datastore.run_tx(lambda tx: tx._c.execute(
            "UPDATE batch_aggregations SET report_count = report_count + 1 WHERE ord = 0"))
        rows = pair.l_eph.datastore.run_tx(lambda tx: tx.get_batch_aggregations_intersecting_interval(
            pair.task.task_id, query_for(pair.lp.m).batch_interval, aggregation_parameter=b""))
        driver = pair.lp.cdriver.CollectionJobDriver(pair.l_eph.datastore, pair.http())
        driver._reconcile_with_helper(pair.task, rows)
        label = t_metrics.task_id_label(pair.task.task_id.data)
        (peer,) = d.peer().values()
        assert peer["divergence"] == 1
        # labelled by replica where a fleet identity is installed
        rl = t_metrics.replica_labels()
        assert t_metrics.ledger_peer_divergence.get(task_id=label, **rl) == 1.0
        assert t_metrics.ledger_breach_active.get(task_id=label, stage="peer", **rl) == 1.0
        doc = t_ledger.installed_ledger().evaluate_once()
        assert f"{label}/peer" in doc["breaches"]
    finally:
        d.close()


def _gc_run(monkeypatch, pkg: str):
    leader, helper, kp = TASKS
    leader = dataclasses.replace(leader, report_expiry_age=jm.Duration(TP))
    d = LedgerDrive(monkeypatch, pkg, pkg, tasks=(leader, helper, kp))
    try:
        d.upload(REPORTS[:4])
        assert d.pair.create_jobs() == 1
        d.upload(REPORTS[4:])  # never claimed
        eph = d.pair.l_eph
        eph.clock.advance(d.pair.lp.m.Duration(4 * TP))
        deleted = OBS[pkg]["gc"].GarbageCollector(eph.datastore, eph.clock).run_once()
        return deleted, d.counters()["leader"], d.books()["leader"]
    finally:
        d.close()


def test_gc_expiry_books_per_lane_counts_as_janus_tpu(monkeypatch):
    want = _gc_run(monkeypatch, "jax")
    assert _gc_run(monkeypatch, "torch") == want
    deleted, counters, books = want
    assert deleted == {"reports": 6, "aggregation": 1, "collection": 0}
    (c,) = counters.values()
    assert c == {"admitted": 6, "expired": 6, "expired_reclaimed": 4}
    (t,) = books.values()
    assert t["imbalance"] == {"ingest": 0, "param": 0, "collect": 0}


def _drop_run(monkeypatch, pkg: str):
    fp = OBS[pkg]["failpoints"]
    d = LedgerDrive(monkeypatch, pkg, pkg)
    try:
        fp.configure("ledger.drop_report=error,count=1")
        d.upload(REPORTS)
        return d.counters()["leader"], d.books()["leader"]
    finally:
        fp.clear()
        d.close()


def test_drop_report_failpoint_shows_as_a_lost_report_in_both_packages(monkeypatch):
    want = _drop_run(monkeypatch, "jax")
    assert _drop_run(monkeypatch, "torch") == want
    counters, books = want
    assert list(counters.values()) == [{"admitted": 6}]
    (t,) = books.values()
    # admitted 6, 5 pending: the silently dropped report is the residual
    assert t["in_flight"]["pending_reports"] == 5 and t["imbalance"]["ingest"] == 1


def _poplar1_run(monkeypatch, leader: str, helper: str):
    from janus_tpu.vdaf import poplar1 as jp
    from test_torch_poplar1 import BITS, HH_REPORTS, HH_TASKS, _drive

    d = LedgerDrive(monkeypatch, leader, helper, tasks=HH_TASKS)
    try:
        d.upload(HH_REPORTS)
        pair = d.pair
        for level, prefixes in ((0, (0, 1)), (1, (0, 1, 2, 3))):
            agg_param = jp.Poplar1AggParam(level, prefixes).encode()
            pair.collector(leader).start_collection(query_for(pair.lp.m), agg_param=agg_param)
            _drive(pair)
        assert BITS > 1
        return d.counters(), d.books(), {k: (v or {}).get("divergence") for k, v in d.peer().items()}
    finally:
        d.close()


@pytest.mark.parametrize("pairing", ["torch-jax", "torch-torch"])
def test_poplar1_books_the_param_lane_as_janus_tpu(monkeypatch, pairing):
    if "hh" not in _REFERENCE:
        _REFERENCE["hh"] = _poplar1_run(monkeypatch, "jax", "jax")
    want = _REFERENCE["hh"]
    assert _poplar1_run(monkeypatch, *pairing.split("-")) == want
    counters, books, divergence = want
    n = 6
    (lc,) = counters["leader"].values()
    assert lc == {"admitted": n, "admitted_param": 2 * n, "aggregated_param": 2 * n, "collected": 2 * n}
    (t,) = books["leader"].values()
    assert t["imbalance"] == {"ingest": 0, "param": 0, "collect": 0}
    assert list(divergence.values()) == [0]


def test_both_packages_answer_the_ledger_route_alike(monkeypatch):
    """GET /tasks/{id}/ledger of a port helper and of a janus_tpu helper
    after the same drive: the same JSON, and the wrong token refused."""
    bodies = {}
    for pkg in ("jax", "torch"):
        d = LedgerDrive(monkeypatch, pkg, pkg)
        try:
            d.run()
            pair = d.pair
            url = pair.h_srv.url.rstrip("/") + "/tasks/" + _b64(pair.task.task_id.data) + "/ledger"
            http = pair.http()
            status, body = http.get(url, pair.task.aggregator_auth_token.request_headers())
            bad, _ = http.get(url, {"Authorization": "Bearer wrong"})
            bodies[pkg] = (status, body, bad)
        finally:
            d.close()
    assert bodies["torch"] == bodies["jax"]
    assert bodies["jax"][0] == 200 and bodies["jax"][2] == 400


def _b64(b: bytes) -> str:
    import base64

    return base64.urlsafe_b64encode(b).decode().rstrip("=")


def test_ledger_module_is_janus_tpus_taxonomy():
    for name in ("ADMITTED", "AGGREGATED", "COLLECTED", "EXPIRED", "EXPIRED_RECLAIMED", "LOST", "REJECTED_PREFIX",
                 "ADMITTED_PARAM", "AGGREGATED_PARAM", "EXPIRED_PARAM", "REJECTED_PARAM_PREFIX"):
        assert getattr(t_ledger, name) == getattr(j_ledger, name)
    assert t_ledger.ledger_document() == j_ledger.ledger_document() == {"enabled": False}
