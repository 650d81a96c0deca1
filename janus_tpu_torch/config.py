"""Configuration of a leader replica in a fleet.

The port's own copy of `FleetConfig` from janus_tpu/config.py (the YAML
`fleet:` stanza): the replica's identity and its slice of the job-claim
shard space, read by `AggregationJobCreator(fleet=)` and both drivers'
`acquirer(fleet=)`. `from_dict` reads the dict alone: janus_tpu's
`JANUS_REPLICA_ID`, `JANUS_SHARD_COUNT`, `JANUS_SHARD_INDEX` and
`JANUS_STEAL_AFTER_S` overrides are not ported. `install_identity()`
feeds the identity to the metrics registry (metrics.set_replica_identity:
janus_replica_info, the `fleet` statusz section and the replica label of
the lease, step-back and ledger families), as janus_main does from the
YAML; the drivers' and the creator's `fleet=` call it. The rest of
janus_tpu's configuration (the binaries' YAML sections) is not ported.
"""

from __future__ import annotations

import math
import os
import socket
from dataclasses import dataclass

from .datastore.models import ShardSpec
from .datastore.store import replica_holder_tag


def default_replica_id() -> str:
    """Stable-per-process replica id (hostname-pid), used when no fleet
    identity is configured."""
    return f"{socket.gethostname()}-{os.getpid()}"


@dataclass
class FleetConfig:
    """A replica's identity and its shard: it claims the jobs whose
    persisted shard_key % shard_count == shard_index at once, and any
    other only after steal_after_secs of eligibility (a dead replica's
    shard drains instead of starving)."""

    # stable replica identity; None: hostname-pid
    replica_id: str | None = None
    shard_count: int = 1
    shard_index: int = 0
    steal_after_secs: float = 30.0

    @classmethod
    def from_dict(cls, d: dict | None) -> "FleetConfig":
        d = d or {}
        replica_id = d.get("replica_id")
        return cls(
            replica_id=str(replica_id) if replica_id else None,
            shard_count=max(1, int(d.get("shard_count", 1))),
            shard_index=int(d.get("shard_index", 0)),
            steal_after_secs=max(0.0, float(d.get("steal_after_secs", 30.0))),
        )

    def resolved_replica_id(self) -> str:
        return self.replica_id or default_replica_id()

    def shard_spec(self) -> ShardSpec | None:
        """ShardSpec for the batched lease claims; None when the fleet is
        unsharded (the predicate drops out of the claim)."""
        if self.shard_count <= 1:
            return None
        return ShardSpec(
            shard_count=self.shard_count,
            shard_index=self.shard_index % self.shard_count,
            # ceil, never truncate: the claim predicate works in whole
            # seconds, and a fractional steal_after (0.5) must fence for 1 s,
            # not disable the fence while the creator honours the float
            steal_after_s=math.ceil(max(0.0, self.steal_after_secs)),
        )

    def install_identity(self) -> None:
        """The process's replica identity in the metrics registry: labelled
        per replica only where a replica_id is configured."""
        from . import metrics

        metrics.set_replica_identity(self.replica_id, self.shard_index, self.shard_count)

    def holder_tag(self) -> bytes:
        """8-byte provenance tag stamped into every lease token this replica
        mints."""
        return replica_holder_tag(self.resolved_replica_id())
