"""DAP collector: create collection jobs, poll, decrypt, unshard.

Equivalent of reference collector/src/lib.rs:155-650
(`CollectorParameters`, `Collector::collect` = start_collection +
poll_once/poll_until_complete, HPKE-open of both aggregate shares,
vdaf.unshard).

The port's own copy of janus_tpu/collector.py. The unshard is the host
`Prio3.unshard` (vdaf/reference.py), or for Poplar1 `Poplar1.unshard`
(vdaf/poplar1.py) in the field of the aggregation parameter's level, as
in janus_tpu. A heavy-hitters collector walks the levels itself: one
collection per `Poplar1AggParam(level, prefixes)`, passed as `agg_param`.
"""

from __future__ import annotations

import secrets
import time as _time
from dataclasses import dataclass

from .client import b64url
from .core.auth import AuthenticationToken
from .core.hpke import HpkeApplicationInfo, HpkeKeypair, Label, hpke_open
from .core.retries import retry_http_request
from .messages import (
    AggregateShareAad,
    BatchSelector,
    Collection,
    CollectionJobId,
    CollectionReq,
    Interval,
    Query,
    Role,
    TaskId,
    TimeInterval,
)
from .vdaf.poplar1 import Poplar1, Poplar1AggParam
from .vdaf.registry import VdafInstance, circuit_for, prio3_host


@dataclass
class CollectorParameters:
    """reference collector/src/lib.rs:155."""

    task_id: TaskId
    leader_endpoint: str
    auth_token: AuthenticationToken
    hpke_keypair: HpkeKeypair  # collector's own keypair

    def collection_job_uri(self, collection_job_id: CollectionJobId) -> str:
        return (
            self.leader_endpoint.rstrip("/")
            + f"/tasks/{b64url(self.task_id.data)}/collection_jobs/{b64url(collection_job_id.data)}"
        )


@dataclass
class CollectionResult:
    """reference collector/src/lib.rs:279 `Collection`."""

    report_count: int
    interval: Interval
    aggregate_result: object
    partial_batch_selector: object = None  # set for fixed-size queries


class CollectionJobNotReady(Exception):
    """202 poll response; retry_after_s carries the leader's Retry-After
    hint when present (reference collector/src/lib.rs:466)."""

    def __init__(self, retry_after_s: float | None = None):
        super().__init__("collection job not ready")
        self.retry_after_s = retry_after_s


class Collector:
    """reference collector/src/lib.rs:359."""

    def __init__(self, params: CollectorParameters, vdaf: VdafInstance, http):
        self.params = params
        self.vdaf = vdaf
        self.prio3 = prio3_host(vdaf) if vdaf.kind != "poplar1" else None
        self.http = http

    def start_collection(self, query: Query, agg_param: bytes = b"") -> CollectionJobId:
        """PUT the CollectionReq (reference :384)."""
        job_id = CollectionJobId(secrets.token_bytes(16))
        req = CollectionReq(query, agg_param)
        headers = {"Content-Type": CollectionReq.MEDIA_TYPE}
        headers.update(self.params.auth_token.request_headers())
        status, body = retry_http_request(
            lambda: self.http.put(self.params.collection_job_uri(job_id), req.to_bytes(), headers)
            + (getattr(self.http, "last_response_headers", {}),)
        )
        if status not in (200, 201):
            raise RuntimeError(f"collection create failed: HTTP {status}: {body[:300]!r}")
        return job_id

    def poll_once(self, job_id: CollectionJobId, query: Query, agg_param: bytes = b""):
        """POST-poll the job (reference :440); raises CollectionJobNotReady."""
        headers = dict(self.params.auth_token.request_headers())
        status, body = retry_http_request(
            lambda: self.http.post(self.params.collection_job_uri(job_id), b"", headers)
            + (getattr(self.http, "last_response_headers", {}),)
        )
        if status == 202:
            ra = None
            hdrs = getattr(self.http, "last_response_headers", {})
            raw = next((v for k, v in hdrs.items() if k.lower() == "retry-after"), None)
            if raw is not None:
                try:
                    ra = max(0.0, float(raw))  # delta-seconds form only
                except ValueError:
                    ra = None
            raise CollectionJobNotReady(retry_after_s=ra)
        if status != 200:
            raise RuntimeError(f"collection poll failed: HTTP {status}: {body[:300]!r}")
        collection = Collection.from_bytes(body)
        return self._unshard(collection, query, agg_param)

    def poll_until_complete(
        self, job_id: CollectionJobId, query: Query, agg_param: bytes = b"", timeout_s: float = 60.0,
        poll_interval_s: float = 0.2,
    ) -> CollectionResult:
        """reference :561: honors the leader's Retry-After on 202
        (collector/src/lib.rs:466), falling back to poll_interval_s."""
        deadline = _time.monotonic() + timeout_s
        while True:
            try:
                return self.poll_once(job_id, query, agg_param)
            except CollectionJobNotReady as e:
                # a 0 (or absent) hint keeps the local floor: never
                # busy-loop POSTs against the leader
                wait = poll_interval_s if not e.retry_after_s else e.retry_after_s
                # capped to the remaining budget, so a hint >= budget still
                # gets one final poll at the deadline
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("collection job did not complete in time")
                _time.sleep(min(wait, remaining))

    def collect(self, query: Query, agg_param: bytes = b"", timeout_s: float = 60.0) -> CollectionResult:
        """start + poll to completion (reference :619)."""
        job_id = self.start_collection(query, agg_param)
        return self.poll_until_complete(job_id, query, agg_param, timeout_s)

    def _unshard(self, collection: Collection, query: Query, agg_param: bytes) -> CollectionResult:
        """Decrypt both aggregate shares + vdaf.unshard (reference :500-560)."""
        if query.query_type == TimeInterval.CODE:
            batch_selector = BatchSelector.time_interval(query.batch_interval)
        else:
            batch_selector = BatchSelector.fixed_size(collection.partial_batch_selector.batch_id)
        aad = AggregateShareAad(self.params.task_id, agg_param, batch_selector).to_bytes()
        if self.vdaf.kind == "poplar1":
            poplar = Poplar1(self.vdaf.bits)
            p1_param = Poplar1AggParam.decode(agg_param)
            field = poplar.idpf.field_at(p1_param.level)
        else:
            field = circuit_for(self.vdaf).FIELD
        shares = []
        for role, ct in (
            (Role.LEADER, collection.leader_encrypted_agg_share),
            (Role.HELPER, collection.helper_encrypted_agg_share),
        ):
            pt = hpke_open(
                self.params.hpke_keypair,
                HpkeApplicationInfo(Label.AGGREGATE_SHARE, role, Role.COLLECTOR),
                ct,
                aad,
            )
            shares.append(field.decode_vec(pt))
        if self.vdaf.kind == "poplar1":
            result = poplar.unshard(p1_param, shares)
        else:
            result = self.prio3.unshard(shares, collection.report_count)
        pbs = collection.partial_batch_selector if query.query_type != TimeInterval.CODE else None
        return CollectionResult(collection.report_count, collection.interval, result, pbs)
