"""Minimal HTTP client with the (status, body) convention of
retry_http_request. The reference uses reqwest (aggregator.rs:3033
send_request_to_helper); this wraps urllib for the same purpose.

The port's own copy of janus_tpu/core/http_client.py: per-attempt
timeouts, a wall-clock budget and a size cap on every response body,
the propagated deadline header, and each thread's last response headers
(for Retry-After), `fetch_any_status`, and the `helper.request`
failpoint (error: a transport failure; timeout: a hung peer; before the
request is built) and `helper.response` (timeout: a peer that answers
and then stalls the body), and the outgoing `traceparent` header of the
current span, which the peer's DAP server adopts.
"""

from __future__ import annotations

import http.client
import socket
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass

from .. import failpoints
from . import deadline

# chunked body reads: each recv is bounded by the socket timeout AND the
# whole body by the wall-clock budget
_READ_CHUNK = 65536


def _injected_transport_error() -> urllib.error.URLError:
    return urllib.error.URLError("injected transport error (failpoint helper.request)")


def _injected_timeout() -> urllib.error.URLError:
    # what a real socket timeout looks like through urllib: a URLError
    # wrapping socket.timeout (an OSError), so the retry loop treats it
    # as any other transport failure
    return urllib.error.URLError(socket.timeout("injected timeout (failpoint)"))


class PeerResponseTooLarge(Exception):
    """The peer's response body exceeded the configured size cap. Not an
    OSError on purpose: retry_http_request lets it propagate, and the
    driver step fails (attempt counted)."""

    def __init__(self, url: str, limit_bytes: int):
        super().__init__(
            f"response body from {url} exceeded the {limit_bytes}-byte cap"
        )
        self.url = url
        self.limit_bytes = limit_bytes


@dataclass(frozen=True)
class HttpClientConfig:
    """The job driver binaries' `helper_http:` section: the per-attempt
    half of the overall-deadline/per-attempt-timeout split; the retry
    loop's overall budget stays the lease deadline (job_driver.py
    deadline_request_timeout)."""

    # connect + per-read socket timeout and the default body budget of one
    # attempt
    attempt_timeout_s: float = 300.0
    # wall-clock budget for reading one response body (None = the attempt
    # timeout)
    body_budget_s: float | None = None
    # response body size cap
    max_response_bytes: int = 64 << 20

    @classmethod
    def from_dict(cls, d: dict | None) -> "HttpClientConfig":
        d = d or {}
        budget = d.get("body_budget_secs")
        return cls(
            attempt_timeout_s=float(d.get("attempt_timeout_secs", 300.0)),
            body_budget_s=None if budget is None else float(budget),
            max_response_bytes=int(float(d.get("max_response_mb", 64.0)) * (1 << 20)),
        )

    def build(self) -> "HttpClient":
        return HttpClient(
            timeout=self.attempt_timeout_s,
            body_budget_s=self.body_budget_s,
            max_response_bytes=self.max_response_bytes,
        )


def fetch_any_status(
    url: str,
    method: str = "GET",
    body: bytes | None = None,
    headers: dict | None = None,
    timeout: float = 10.0,
    max_bytes: int = 64 << 10,
) -> tuple[int, bytes]:
    """One request returning (status, body) for any status: urllib raises
    HTTPError on non-2xx, but a probe of a degraded endpoint needs the
    status (the peer-health probe counts any answer as a live peer). The
    body is read up to its cap, `max_bytes`, and cut there: the probe
    ignores it, and a misbehaving peer must not make it read without end."""
    req = urllib.request.Request(url, data=body, headers=headers or {}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(max_bytes)
    except urllib.error.HTTPError as e:
        return e.code, e.read(max_bytes)


class HttpClient:
    def __init__(
        self,
        timeout: float = 300.0,
        body_budget_s: float | None = None,
        max_response_bytes: int = 64 << 20,
    ):
        self.timeout = timeout
        self.body_budget_s = body_budget_s
        self.max_response_bytes = max_response_bytes
        self._local = threading.local()

    def _read_body(self, resp, url: str, budget_s: float | None) -> bytes:
        """Chunked body read under a wall-clock budget and a size cap. A
        budget breach surfaces as a URLError-wrapped timeout (retryable,
        breaker-counted); a size breach as PeerResponseTooLarge; a
        truncated body as URLError."""
        chunks: list[bytes] = []
        total = 0
        t0 = time.monotonic()
        while True:
            if budget_s is not None and time.monotonic() - t0 > budget_s:
                raise urllib.error.URLError(
                    socket.timeout(
                        f"response body read exceeded the {budget_s:g}s "
                        f"wall-clock budget ({total} bytes in)"
                    )
                )
            try:
                chunk = resp.read(_READ_CHUNK)
            except http.client.HTTPException as e:
                raise urllib.error.URLError(e) from e
            if not chunk:
                # read(amt) returns b"" on a premature FIN: check the
                # undelivered Content-Length residue ourselves
                remaining = getattr(resp, "length", None)
                if remaining:
                    raise urllib.error.URLError(http.client.IncompleteRead(b"", remaining))
                return b"".join(chunks)
            total += len(chunk)
            if self.max_response_bytes and total > self.max_response_bytes:
                raise PeerResponseTooLarge(url, self.max_response_bytes)
            chunks.append(chunk)

    @property
    def last_response_headers(self) -> dict:
        """Response headers of this thread's most recent request (clients
        are shared across driver worker threads)."""
        return getattr(self._local, "headers", {})

    @last_response_headers.setter
    def last_response_headers(self, value: dict) -> None:
        self._local.headers = value

    def request(
        self,
        method: str,
        url: str,
        body: bytes | None = None,
        headers: dict | None = None,
        timeout: float | None = None,
    ):
        # clear this thread's previous response headers first, so a
        # transport error cannot leave a stale Retry-After visible
        self.last_response_headers = {}
        # fault injection for the whole outbound path (error: a transport
        # failure, delay: a slow WAN, timeout: a hung peer, crash: the
        # process dies mid-request)
        failpoints.hit(
            "helper.request",
            error_factory=_injected_transport_error,
            timeout_factory=_injected_timeout,
        )
        headers = dict(headers or {})
        if not any(k.lower() == "traceparent" for k in headers):
            from ..trace import current_traceparent

            tp = current_traceparent()
            if tp is not None:
                headers["traceparent"] = tp
        # inside a driver's lease-bounded step the remaining budget rides
        # every outbound request (re-stamped per attempt)
        if not any(k.lower() == deadline.DEADLINE_HEADER.lower() for k in headers):
            dl = deadline.header_value(deadline.current_deadline())
            if dl is not None:
                headers[deadline.DEADLINE_HEADER] = dl
        req = urllib.request.Request(url, data=body, method=method, headers=headers)
        effective_timeout = self.timeout if timeout is None else min(self.timeout, timeout)
        budget = self.body_budget_s
        if budget is None:
            budget = effective_timeout
        try:
            with urllib.request.urlopen(req, timeout=effective_timeout) as resp:
                self.last_response_headers = dict(resp.headers.items())
                # a slow body: the peer answered but trickles the payload
                failpoints.hit("helper.response", timeout_factory=_injected_timeout)
                return resp.status, self._read_body(resp, url, budget)
        except urllib.error.HTTPError as e:
            self.last_response_headers = dict(e.headers.items())
            try:
                err_body = self._read_body(e, url, budget)
            except OSError as read_err:
                # a reset while draining the error body is a transport
                # failure, not a conclusive response
                raise urllib.error.URLError(read_err) from read_err
            return e.code, err_body

    def get(self, url: str, headers: dict | None = None, timeout: float | None = None):
        return self.request("GET", url, None, headers, timeout)

    def put(self, url: str, body: bytes, headers: dict | None = None, timeout: float | None = None):
        return self.request("PUT", url, body, headers, timeout)

    def post(self, url: str, body: bytes, headers: dict | None = None, timeout: float | None = None):
        return self.request("POST", url, body, headers, timeout)

    def delete(self, url: str, headers: dict | None = None, timeout: float | None = None):
        return self.request("DELETE", url, None, headers, timeout)
