"""DAP client: shard a measurement, HPKE-seal input shares, upload.

Equivalent of reference client/src/lib.rs:58-300 (`ClientParameters`,
HPKE-config fetch, `prepare_report`, `upload`); the port's own copy of
janus_tpu/client.py. Sharding uses the host Prio3 of
vdaf/reference.py, or the host Poplar1 of vdaf/poplar1.py (IDPF keys
and correlated randomness, with its public- and input-share codecs), one
report at a time (a client is not an aggregator); batched Prio3 load
generation uses the device shard in vdaf/testing.py `make_wire_reports`
instead.
"""

from __future__ import annotations

import base64
import secrets
from dataclasses import dataclass

from .core.hpke import HpkeApplicationInfo, Label, hpke_seal
from .core.retries import Backoff, retry_http_request
from .core.time_util import Clock, RealClock
from .messages import (
    Duration,
    HpkeConfig,
    HpkeConfigList,
    InputShareAad,
    PlaintextInputShare,
    Report,
    ReportId,
    ReportMetadata,
    Role,
    TaskId,
)
from .vdaf.poplar1 import Poplar1, encode_input_share, encode_public_share
from .vdaf.registry import VdafInstance, circuit_for, prio3_host
from .vdaf.wire import Prio3Wire


def b64url(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


@dataclass
class ClientParameters:
    """reference client/src/lib.rs:58."""

    task_id: TaskId
    leader_aggregator_endpoint: str
    helper_aggregator_endpoint: str
    time_precision: Duration

    def hpke_config_uri(self, role: Role) -> str:
        base = self.leader_aggregator_endpoint if role == Role.LEADER else self.helper_aggregator_endpoint
        return base.rstrip("/") + f"/hpke_config?task_id={b64url(self.task_id.data)}"

    def upload_uri(self) -> str:
        return self.leader_aggregator_endpoint.rstrip("/") + f"/tasks/{b64url(self.task_id.data)}/reports"


class Client:
    """reference client/src/lib.rs:182."""

    def __init__(
        self,
        parameters: ClientParameters,
        vdaf: VdafInstance,
        leader_hpke_config: HpkeConfig,
        helper_hpke_config: HpkeConfig,
        clock: Clock | None = None,
        http=None,
    ):
        self.params = parameters
        self.vdaf = vdaf
        if vdaf.kind == "poplar1":
            self.prio3 = None
            self.wire = None
            self.poplar = Poplar1(vdaf.bits)
        else:
            self.prio3 = prio3_host(vdaf)
            self.wire = Prio3Wire(circuit_for(vdaf))
            self.poplar = None
        self.leader_hpke_config = leader_hpke_config
        self.helper_hpke_config = helper_hpke_config
        self.clock = clock or RealClock()
        self.http = http

    @classmethod
    def with_fetched_configs(cls, parameters: ClientParameters, vdaf: VdafInstance, http, clock=None):
        """Fetch both aggregators' HPKE config lists (reference :135)."""
        configs = []
        for role in (Role.LEADER, Role.HELPER):
            status, body = retry_http_request(
                lambda role=role: http.get(parameters.hpke_config_uri(role)) + (http.last_response_headers,)
            )
            if status != 200:
                raise RuntimeError(f"hpke_config fetch failed: HTTP {status}")
            cfg_list = HpkeConfigList.from_bytes(body)
            if not cfg_list.configs:
                raise RuntimeError("aggregator advertised no HPKE configs")
            configs.append(cfg_list.configs[0])
        return cls(parameters, vdaf, configs[0], configs[1], clock=clock, http=http)

    def prepare_report(self, measurement, when=None) -> Report:
        """Shard and seal (reference client/src/lib.rs:212-260)."""
        report_id = ReportId(secrets.token_bytes(16))
        time = (when or self.clock.now()).to_batch_interval_start(self.params.time_precision)
        metadata = ReportMetadata(report_id, time)
        if self.poplar is not None:
            cws, (k0, k1) = self.poplar.shard(measurement)
            public_share = encode_public_share(self.poplar.bits, cws)
            leader_raw = encode_input_share(k0, 0, self.poplar.bits)
            helper_raw = encode_input_share(k1, 1, self.poplar.bits)
        else:
            public_share_parts, (leader_share, helper_share) = self.prio3.shard(measurement, report_id.data)
            public_share = self.wire.encode_public_share(public_share_parts)
            leader_raw = self.wire.encode_leader_share(
                leader_share.measurement_share, leader_share.proof_share, leader_share.joint_rand_blind
            )
            helper_raw = self.wire.encode_helper_share(helper_share.seed, helper_share.joint_rand_blind)
        aad = InputShareAad(self.params.task_id, metadata, public_share).to_bytes()
        leader_ct = hpke_seal(
            self.leader_hpke_config,
            HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.LEADER),
            PlaintextInputShare((), leader_raw).to_bytes(),
            aad,
        )
        helper_ct = hpke_seal(
            self.helper_hpke_config,
            HpkeApplicationInfo(Label.INPUT_SHARE, Role.CLIENT, Role.HELPER),
            PlaintextInputShare((), helper_raw).to_bytes(),
            aad,
        )
        return Report(metadata, public_share, leader_ct, helper_ct)

    def upload(self, measurement, when=None) -> None:
        """PUT the report to the leader with retries (reference :270); the
        response headers go to the retry loop, so a shedding leader's
        429 + Retry-After paces this client."""
        report = self.prepare_report(measurement, when=when)

        def attempt():
            status, body = self.http.put(
                self.params.upload_uri(), report.to_bytes(), {"Content-Type": Report.MEDIA_TYPE}
            )
            return status, body, self.http.last_response_headers

        status, body = retry_http_request(attempt, Backoff())
        if status not in (200, 201):
            raise RuntimeError(f"upload failed: HTTP {status}: {body[:200]!r}")
