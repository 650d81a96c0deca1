"""Peer-outage parking: stop claiming jobs while the other aggregator is
down, and resume them with a cheap half-open probe.

The outbound circuit breaker (core/circuit_breaker.py) makes a dead
helper cheap per step: a claimed job fails fast with CircuitOpenError and
steps back. But the step-backs still churn: every driver worker keeps
claiming leases, opening transactions and releasing them for as long as
the outage lasts. The datastore outage discipline
(job_driver.py `acquire_tolerating_outage`) has the better shape: while
the dependency is known to be down, park the acquirer itself (no claim
transaction, no lease), and let a cheap probe resume it.

* `PeerHealthTracker.observe_endpoint(url)`: both job drivers register
  the helper endpoint of every task they step, so the tracker knows the
  peers and where to aim probes.
* `park_gate()` plugs into `make_claim_acquirer(..., peer_gate=...)`.
  Claims park while every known peer's breaker is not closed: with one
  helper a dead peer parks the driver outright; with several, a partial
  outage falls back to the per-step breaker step-backs (a claim might
  target a healthy peer).
* a background prober (`start()`/`stop()`) runs `tick` every
  `probe_interval_s`: it accrues the outage seconds, keeps the parked
  flags, and issues the half-open probe itself, one GET through the
  breaker's single probe slot (any HTTP status counts as alive), so
  recovery does not wait for a parked driver to stumble into the peer.

The port's own copy of janus_tpu/aggregator/peer_health.py. It feeds
janus_tpu's parked gauge, outage-seconds counter and probe counter, and
keeps the same counts in the tracker's own state (`status()`), so two
trackers never share a count there; the newest tracker's `status()` is
the statusz `peer_health` section. `PeerHealthConfig.from_dict` reads
the job driver binaries' `peer_health:` section, with its `enabled` and
`park` switches; `default_tracker` is the process-wide tracker that both
drivers of a binary share.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

from ..core.circuit_breaker import CLOSED, CircuitOpenError, OutboundCircuitBreakers, peer_label
from .. import metrics
from ..statusz import register_status_provider

log = logging.getLogger(__name__)

PROBE_ALIVE = "alive"
PROBE_DEAD = "dead"
PROBE_REJECTED = "rejected"


@dataclass(frozen=True)
class PeerHealthConfig:
    """The job driver binaries' `peer_health:` section. A driver built
    without a tracker does not park either (the binaries hand the tracker
    over only where `enabled`)."""

    enabled: bool = True
    # park claim acquisition while every known peer is not closed; off:
    # probe and export state only, and keep the per-step breaker step-backs
    park: bool = True
    # background prober cadence (also the outage seconds' accrual grain)
    probe_interval_s: float = 5.0
    # budget of one probe GET
    probe_timeout_s: float = 5.0

    @classmethod
    def from_dict(cls, d: dict | None) -> "PeerHealthConfig":
        d = d or {}
        return cls(
            enabled=bool(d.get("enabled", True)),
            park=bool(d.get("park", True)),
            probe_interval_s=float(d.get("probe_interval_secs", 5.0)),
            probe_timeout_s=float(d.get("probe_timeout_secs", 5.0)),
        )


class PeerHealthTracker:
    """Shared by both job drivers of a process (like the breaker registry
    it reads): a helper down for aggregation steps is down for
    aggregate-share fetches too, and both acquirers park together."""

    def __init__(self, breakers: OutboundCircuitBreakers, cfg: PeerHealthConfig | None = None, http=None):
        self.breakers = breakers
        self.cfg = cfg or PeerHealthConfig()
        # a fetch_any_status-compatible stand-in for tests; None: the real
        # core.http_client.fetch_any_status
        self._http = http
        self._lock = threading.Lock()
        # peer -> probe URL (the task's helper endpoint; any HTTP answer,
        # 404 included, proves the peer routes and talks HTTP)
        self._endpoints: dict[str, str] = {}
        # peer -> monotonic time of the last outage accrual
        self._last_accrual: dict[str, float] = {}
        self._parked_since: float | None = None
        self._outage_started: dict[str, float] = {}
        self._probe_counts: dict[str, dict[str, int]] = {}
        # janus_tpu's janus_peer_parked gauge and
        # janus_peer_outage_seconds_total counter, per peer
        self._parked: dict[str, bool] = {}
        self._outage_seconds: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        register_status_provider("peer_health", self.status)

    # --- the drivers' side ---
    def observe_endpoint(self, url: str) -> str:
        """Register a helper endpoint (from the drivers' send paths,
        before the breaker check, so even a peer that never answered once
        can be probed). Returns its peer label."""
        peer = peer_label(url)
        with self._lock:
            self._endpoints.setdefault(peer, url)
        return peer

    def parked_peers(self) -> list[str]:
        """Peers whose breaker is not closed."""
        return sorted(p for p, s in self.breakers.peer_states().items() if s != CLOSED)

    def should_park(self) -> bool:
        """True while claim acquisition should park: parking enabled, at
        least one peer known, and every known peer not closed."""
        if not (self.cfg.enabled and self.cfg.park):
            return False
        states = self.breakers.peer_states()
        if not states:
            return False
        return all(s != CLOSED for s in states.values())

    def park_gate(self):
        """The callable for make_claim_acquirer(..., peer_gate=...)."""
        return self.should_park

    # --- the prober ---
    def tick(self, now: float | None = None) -> None:
        """One prober beat: accrue outage seconds, set the parked flags,
        probe whatever can be probed. The background thread loops it."""
        if now is None:
            now = time.monotonic()
        states = self.breakers.peer_states()
        parked = self.should_park()
        with self._lock:
            self._parked_since = (self._parked_since or now) if parked else None
            for peer, state in states.items():
                down = state != CLOSED
                self._parked[peer] = down
                metrics.peer_parked.set(1.0 if down else 0.0, peer=peer)
                last = self._last_accrual.get(peer)
                if down:
                    self._outage_started.setdefault(peer, now)
                    if last is not None:
                        self._outage_seconds[peer] = self._outage_seconds.get(peer, 0.0) + max(0.0, now - last)
                        metrics.peer_outage_seconds_total.add(max(0.0, now - last), peer=peer)
                    self._last_accrual[peer] = now
                else:
                    self._outage_started.pop(peer, None)
                    self._last_accrual.pop(peer, None)
        for peer, state in states.items():
            if state != CLOSED and self.breakers.retry_in_s(peer) == 0.0:
                self.probe(peer)

    def probe(self, peer: str) -> str:
        """One half-open probe through the breaker's single probe slot.
        Returns the outcome ("alive", "dead" or "rejected")."""
        with self._lock:
            url = self._endpoints.get(peer)
        if url is None:
            return PROBE_REJECTED
        try:
            self.breakers.check(peer)
        except CircuitOpenError:
            # cooldown not over, or another probe (maybe a driver's own
            # step) holds the half-open slot: do not stampede
            outcome = PROBE_REJECTED
        else:
            try:
                fetch = self._http
                if fetch is None:
                    from ..core.http_client import fetch_any_status as fetch
                status, _ = fetch(url, timeout=self.cfg.probe_timeout_s)
            except Exception as e:
                log.warning("peer probe %s (%s) failed: %s", peer, url, e)
                self.breakers.record_failure(peer)
                outcome = PROBE_DEAD
            else:
                # any status is a live peer: it routed, took the connection
                # and spoke HTTP (a GET on the task endpoint answers 404)
                log.info("peer probe %s answered %d: resuming", peer, status)
                self.breakers.record_success(peer)
                outcome = PROBE_ALIVE
        metrics.peer_probes_total.add(peer=peer, outcome=outcome)
        with self._lock:
            counts = self._probe_counts.setdefault(peer, {PROBE_ALIVE: 0, PROBE_DEAD: 0, PROBE_REJECTED: 0})
            counts[outcome] += 1
        return outcome

    def _run(self) -> None:
        while not self._stop.wait(self.cfg.probe_interval_s):
            try:
                self.tick()
            except Exception:
                log.exception("peer health tick failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="peer-health-prober", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.cfg.probe_interval_s + 5.0)

    # --- state ---
    def status(self) -> dict:
        """The config, the park decision and every peer's state, parked
        flag, outage seconds and probe counts. Never raises."""
        now = time.monotonic()
        states = self.breakers.peer_states()
        with self._lock:
            endpoints = dict(self._endpoints)
            outage_started = dict(self._outage_started)
            probe_counts = {p: dict(c) for p, c in self._probe_counts.items()}
            parked_flags = dict(self._parked)
            outage_seconds = dict(self._outage_seconds)
            parked_since = self._parked_since
        parked = self.should_park()
        return {
            "config": {
                "enabled": self.cfg.enabled,
                "park": self.cfg.park,
                "probe_interval_s": self.cfg.probe_interval_s,
                "probe_timeout_s": self.cfg.probe_timeout_s,
            },
            "parked": parked,
            "parked_for_s": round(now - parked_since, 3) if parked and parked_since is not None else 0.0,
            "peers": {
                peer: {
                    "state": states.get(peer, "unknown"),
                    "endpoint": endpoints.get(peer),
                    "parked": parked_flags.get(peer, False),
                    "outage_seconds_total": outage_seconds.get(peer, 0.0),
                    "outage_for_s": round(now - outage_started[peer], 3) if peer in outage_started else 0.0,
                    "probes": probe_counts.get(peer, {PROBE_ALIVE: 0, PROBE_DEAD: 0, PROBE_REJECTED: 0}),
                }
                for peer in sorted(set(states) | set(endpoints))
            },
        }



# The process-wide tracker, shared by both job drivers of a binary (as
# default_breakers is): the first caller's config wins, and a later one
# replaces it only where the first was the default.
_default_lock = threading.Lock()
_default: PeerHealthTracker | None = None


def default_tracker(breakers: OutboundCircuitBreakers, cfg: PeerHealthConfig | None = None) -> PeerHealthTracker:
    global _default
    with _default_lock:
        if _default is None:
            _default = PeerHealthTracker(breakers, cfg)
        elif cfg is not None and _default.cfg == PeerHealthConfig():
            _default.cfg = cfg
        return _default


def reset_default_tracker() -> None:
    """Stop the prober and drop the process-wide tracker (tests)."""
    global _default
    with _default_lock:
        if _default is not None:
            _default.stop()
        _default = None
