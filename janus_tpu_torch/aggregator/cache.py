"""Aggregator-side caches.

Equivalent of reference aggregator/src/cache.rs: the
`GlobalHpkeKeypairCache` (:24-139, refreshed in the background so every
request doesn't hit the datastore) and the `PeerAggregatorCache`
(:148, taskprov peers are read-heavy and practically immutable).
Refresh here is deadline-based on access rather than a background task:
cheap under the GIL and exactly as stale as the reference's timer.

The port's own copy of janus_tpu/aggregator/cache.py, line for line.
"""

from __future__ import annotations

import threading
import time


class GlobalHpkeKeypairCache:
    """reference cache.rs:24. Serves decryption keypairs for config ids
    that are not bound to a single task (incl. all taskprov tasks)."""

    DEFAULT_REFRESH_INTERVAL_S = 30 * 60

    def __init__(self, ds, refresh_interval_s: float = DEFAULT_REFRESH_INTERVAL_S):
        self._ds = ds
        self._interval = refresh_interval_s
        self._lock = threading.Lock()
        self._by_id: dict[int, object] = {}
        self._configs: list = []
        self._next_refresh = 0.0
        self.refresh()

    def refresh(self) -> None:
        rows = self._ds.run_tx(lambda tx: tx.get_global_hpke_keypairs(), "global_hpke_refresh")
        with self._lock:
            self._by_id = {
                kp.config.id.id: kp for kp, state in rows if state in ("pending", "active")
            }
            self._configs = [kp.config for kp, state in rows if state == "active"]
            self._next_refresh = time.monotonic() + self._interval

    def _maybe_refresh(self) -> None:
        if time.monotonic() >= self._next_refresh:
            self.refresh()

    def keypair(self, config_id) -> object | None:
        """Decryption keypair for a config id (reference cache.rs:121;
        pending keys decrypt but aren't advertised)."""
        self._maybe_refresh()
        with self._lock:
            return self._by_id.get(getattr(config_id, "id", config_id))

    def configs(self) -> list:
        """Advertisable (active) configs (reference cache.rs:109)."""
        self._maybe_refresh()
        with self._lock:
            return list(self._configs)


class PeerAggregatorCache:
    """reference cache.rs:148: load-once cache of taskprov peers."""

    def __init__(self, ds):
        self._peers = ds.run_tx(
            lambda tx: tx.get_taskprov_peer_aggregators(), "peer_aggregator_load"
        )

    def get(self, endpoint: str, role):
        for peer in self._peers:
            if peer.endpoint == endpoint and peer.role == role:
                return peer
        return None
