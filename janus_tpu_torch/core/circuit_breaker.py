"""Per-peer outbound circuit breaker for leader->helper traffic.

A dead helper otherwise burns the whole lease inside
`retry_http_request` on every job step, for every job. The breaker makes
the failure cheap and the recovery automatic:

    CLOSED ──(failure_threshold consecutive failures)──▶ OPEN
    OPEN   ──(open_cooldown_s elapsed)────────────────▶ HALF_OPEN
    HALF_OPEN: one in-flight probe request is admitted;
               success ▶ CLOSED, failure ▶ OPEN (cooldown restarts)

While OPEN (or while the half-open probe slot is taken), `check()`
raises CircuitOpenError immediately; the job driver treats that as a
step-back (release the lease early with a reacquire delay, do not count
an attempt).

"Failure" is a transport error or a 5xx on one HTTP attempt; a
conclusive response (2xx/4xx, DAP problem documents included) is a
success.

The port's own copy of janus_tpu/core/circuit_breaker.py, with its
state gauge and transition counter; the process's shared registry
(`default_breakers`) is the statusz `outbound_circuit` section.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from urllib.parse import urlsplit

log = logging.getLogger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"
_STATE_VALUE = {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}


class CircuitOpenError(RuntimeError):
    """The breaker for this peer is open: fail fast, step back."""

    def __init__(self, peer: str, retry_in_s: float):
        super().__init__(
            f"outbound circuit to {peer} is open (retry in {retry_in_s:.1f}s)"
        )
        self.peer = peer
        self.retry_in_s = max(0.0, retry_in_s)


@dataclass(frozen=True)
class CircuitBreakerConfig:
    # consecutive per-attempt failures before the circuit opens
    failure_threshold: int = 5
    # how long an open circuit rejects before admitting a probe
    open_cooldown_s: float = 30.0
    # successes required in half-open before closing
    close_threshold: int = 1
    enabled: bool = True


def peer_label(url: str) -> str:
    """Stable per-peer key from an endpoint URL: host[:port]."""
    try:
        netloc = urlsplit(url).netloc
        return netloc or url
    except ValueError:
        return url


class _PeerCircuit:
    __slots__ = (
        "peer",
        "state",
        "consecutive_failures",
        "half_open_successes",
        "opened_at",
        "probe_in_flight",
        "opens",
        "total_failures",
        "total_successes",
    )

    def __init__(self, peer: str):
        self.peer = peer
        self.state = CLOSED
        self.consecutive_failures = 0
        self.half_open_successes = 0
        self.opened_at = 0.0
        self.probe_in_flight = False
        self.opens = 0
        self.total_failures = 0
        self.total_successes = 0


class OutboundCircuitBreakers:
    """Registry of per-peer breakers sharing one config."""

    def __init__(self, cfg: CircuitBreakerConfig | None = None):
        self.cfg = cfg or CircuitBreakerConfig()
        self._lock = threading.Lock()
        self._peers: dict[str, _PeerCircuit] = {}

    def _get(self, peer: str) -> _PeerCircuit:
        pc = self._peers.get(peer)
        if pc is None:
            pc = self._peers[peer] = _PeerCircuit(peer)
            self._publish(pc)
        return pc

    def _publish(self, pc: _PeerCircuit) -> None:
        from .. import metrics

        metrics.outbound_circuit_state.set(_STATE_VALUE[pc.state], peer=pc.peer)

    def _transition(self, pc: _PeerCircuit, to: str) -> None:
        from .. import metrics

        if pc.state == to:
            return
        log.warning("outbound circuit %s: %s -> %s", pc.peer, pc.state, to)
        pc.state = to
        metrics.outbound_circuit_transitions.add(peer=pc.peer, to=to)
        self._publish(pc)

    def _open(self, pc: _PeerCircuit) -> None:
        pc.opened_at = time.monotonic()
        pc.opens += 1
        self._transition(pc, OPEN)

    def check(self, peer: str) -> None:
        """Gate one request attempt. Raises CircuitOpenError while the
        peer's circuit rejects; moves OPEN -> HALF_OPEN (admitting this
        caller as the probe) once the cooldown has elapsed."""
        if not self.cfg.enabled:
            return
        with self._lock:
            pc = self._get(peer)
            if pc.state == CLOSED:
                return
            now = time.monotonic()
            if pc.state == OPEN:
                remaining = pc.opened_at + self.cfg.open_cooldown_s - now
                if remaining > 0:
                    raise CircuitOpenError(peer, remaining)
                self._transition(pc, HALF_OPEN)
                pc.half_open_successes = 0
                pc.probe_in_flight = True
                return
            # HALF_OPEN: admit one probe at a time
            if pc.probe_in_flight:
                raise CircuitOpenError(peer, self.cfg.open_cooldown_s)
            pc.probe_in_flight = True

    def record_success(self, peer: str) -> None:
        if not self.cfg.enabled:
            return
        with self._lock:
            pc = self._get(peer)
            pc.total_successes += 1
            pc.consecutive_failures = 0
            if pc.state == HALF_OPEN:
                pc.probe_in_flight = False
                pc.half_open_successes += 1
                if pc.half_open_successes >= self.cfg.close_threshold:
                    self._transition(pc, CLOSED)

    def record_failure(self, peer: str) -> None:
        if not self.cfg.enabled:
            return
        with self._lock:
            pc = self._get(peer)
            pc.total_failures += 1
            pc.consecutive_failures += 1
            if pc.state == HALF_OPEN:
                # the probe failed: back to a full cooldown
                pc.probe_in_flight = False
                self._open(pc)
            elif pc.state == CLOSED and pc.consecutive_failures >= self.cfg.failure_threshold:
                self._open(pc)

    def state(self, peer: str) -> str:
        with self._lock:
            return self._get(peer).state

    def peer_states(self) -> dict[str, str]:
        """Every known peer's state: the peer-health tracker's parking
        input (aggregator/peer_health.py). Creates no peer entry."""
        with self._lock:
            return {p: pc.state for p, pc in self._peers.items()}

    def retry_in_s(self, peer: str) -> float:
        """Seconds until the peer's circuit will admit a probe (0 when
        closed or half-open)."""
        with self._lock:
            pc = self._get(peer)
            if pc.state != OPEN:
                return 0.0
            return max(0.0, pc.opened_at + self.cfg.open_cooldown_s - time.monotonic())

    def status(self) -> dict:
        """The config and every peer's state and counters."""
        with self._lock:
            now = time.monotonic()
            return {
                "config": {
                    "failure_threshold": self.cfg.failure_threshold,
                    "open_cooldown_s": self.cfg.open_cooldown_s,
                    "close_threshold": self.cfg.close_threshold,
                    "enabled": self.cfg.enabled,
                },
                "peers": {
                    pc.peer: {
                        "state": pc.state,
                        "consecutive_failures": pc.consecutive_failures,
                        "opens": pc.opens,
                        "total_failures": pc.total_failures,
                        "total_successes": pc.total_successes,
                        "retry_in_s": round(max(0.0, pc.opened_at + self.cfg.open_cooldown_s - now), 3)
                        if pc.state == OPEN
                        else 0.0,
                    }
                    for pc in self._peers.values()
                },
            }


# Process-wide default registry, shared by every driver of the process.
_default_lock = threading.Lock()
_default: OutboundCircuitBreakers | None = None


def default_breakers(cfg: CircuitBreakerConfig | None = None) -> OutboundCircuitBreakers:
    """The process's shared breaker registry. The first caller's config
    wins; a later config replaces it only if the default one was set."""
    global _default
    with _default_lock:
        if _default is None:
            from ..statusz import register_status_provider

            _default = OutboundCircuitBreakers(cfg)
            register_status_provider("outbound_circuit", _default.status)
        elif cfg is not None and _default.cfg == CircuitBreakerConfig():
            _default.cfg = cfg
        return _default
