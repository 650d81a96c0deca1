"""janus_tpu_torch's wire-level fault proxy (core/netsim.py) and the
port's HttpClient through it.

The port's counterparts of tests/test_netsim.py, on the port's own
FaultProxy and HttpClient: every toxic kind against a real HTTP upstream,
the wall-clock body budget against a slow-drip wire (a per-read socket
timeout alone never ends that read), the response size cap's
non-retryable contract, the probe GET's body cap, the per-connection toxic count budgets and the
runtime toggle; and the proxy's wire stats equal janus_tpu's FaultProxy's
on the same exchange."""

import http.client
import socket
import threading
import time
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from janus_tpu.core import netsim as j_netsim
from janus_tpu_torch.core.http_client import HttpClient, PeerResponseTooLarge
from janus_tpu_torch.core.netsim import FaultProxy


class _Handler(BaseHTTPRequestHandler):
    """GET /<n> answers 200 with an n-byte body and a Content-Length,
    so a truncated wire surfaces as IncompleteRead on the client."""

    protocol_version = "HTTP/1.1"

    def do_GET(self):
        n = int(self.path.rsplit("/", 1)[1])
        payload = b"x" * n
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def upstream():
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture()
def proxy(upstream):
    with FaultProxy("127.0.0.1", upstream.server_address[1]) as p:
        yield p


def _settles(pred, timeout=2.0):
    """The pump threads account stats just after forwarding; give them
    a beat before asserting on the counters."""
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


def test_passthrough_and_stats(proxy):
    status, body = HttpClient(timeout=5.0).get(proxy.url + "1000")
    assert status == 200 and body == b"x" * 1000
    assert proxy.stats["connections_total"] == 1
    assert _settles(lambda: proxy.stats["bytes_down"] >= 1000)  # headers + body
    assert _settles(lambda: proxy.stats["bytes_up"] > 0)  # the GET request line


def test_latency_toxic_delays_the_response(proxy):
    proxy.set_toxics("down", [{"kind": "latency", "latency_s": 0.3}])
    t0 = time.monotonic()
    status, body = HttpClient(timeout=5.0).get(proxy.url + "100")
    assert status == 200 and body == b"x" * 100
    assert time.monotonic() - t0 >= 0.25
    assert proxy.stats["toxic_fired"].get("latency", 0) >= 1


def test_bandwidth_toxic_caps_throughput(proxy):
    proxy.set_toxics("down", [{"kind": "bandwidth", "bytes_per_s": 16384}])
    t0 = time.monotonic()
    status, body = HttpClient(timeout=10.0).get(proxy.url + "8192")
    assert status == 200 and len(body) == 8192
    assert time.monotonic() - t0 >= 0.3  # ~0.5 s at 16 KiB/s
    assert proxy.stats["toxic_fired"].get("bandwidth", 0) >= 1


def test_slicer_defeats_socket_timeout_but_not_body_budget(proxy):
    """THE satellite pin for the wall-clock body budget: a slow-drip
    body (slicer) makes progress on every read, so the generous
    per-read socket timeout never fires — only HttpClient's wall-clock
    body budget ends the attempt, and it surfaces as a retryable
    URLError-wrapped socket.timeout."""
    proxy.set_toxics(
        "down", [{"kind": "slicer", "slice_bytes": 256, "delay_s": 0.05}]
    )
    # control: same hostile wire, budget = the (ample) attempt timeout
    status, body = HttpClient(timeout=10.0).get(proxy.url + "4096")
    assert status == 200 and len(body) == 4096
    assert proxy.stats["toxic_fired"].get("slicer", 0) >= 1

    # tight wall-clock budget: the drip (~0.8 s) must be cut short even
    # though every individual read completes well inside the 10 s
    # socket timeout
    with pytest.raises(urllib.error.URLError) as ei:
        HttpClient(timeout=10.0, body_budget_s=0.3).get(proxy.url + "4096")
    assert isinstance(ei.value.reason, socket.timeout)
    assert "wall-clock budget" in str(ei.value.reason)


def test_reset_toxic_is_a_transport_error(proxy):
    proxy.set_toxics("up", [{"kind": "reset", "after_bytes": 0}])
    with pytest.raises((urllib.error.URLError, OSError)):
        HttpClient(timeout=5.0).get(proxy.url + "100")
    assert proxy.stats["resets"] >= 1


def test_truncate_toxic_normalizes_to_urlerror(proxy):
    """A mid-body FIN (short body under a Content-Length) raises
    http.client.IncompleteRead — an HTTPException, not an OSError —
    which HttpClient normalizes to a retryable URLError instead of
    letting a raw stdlib internal escape the retry loop."""
    proxy.set_toxics("down", [{"kind": "truncate", "after_bytes": 300}])
    with pytest.raises(urllib.error.URLError) as ei:
        HttpClient(timeout=5.0).get(proxy.url + "4096")
    assert isinstance(ei.value.reason, http.client.HTTPException)
    assert proxy.stats["truncates"] >= 1


def test_blackhole_bounded_by_attempt_timeout(proxy):
    proxy.set_toxics("down", [{"kind": "blackhole"}])
    t0 = time.monotonic()
    with pytest.raises((urllib.error.URLError, OSError)):
        HttpClient(timeout=0.5).get(proxy.url + "100")
    # the client's own timeout is the only way out — and it worked
    assert time.monotonic() - t0 < 5.0
    assert proxy.stats["blackholed_chunks"] >= 1


def test_count_budget_applies_to_exactly_n_connections(proxy):
    proxy.set_toxics("up", [{"kind": "reset", "after_bytes": 0, "count": 1}])
    with pytest.raises((urllib.error.URLError, OSError)):
        HttpClient(timeout=5.0).get(proxy.url + "100")
    # budget spent at accept time: the next connection sees a clean wire
    status, body = HttpClient(timeout=5.0).get(proxy.url + "100")
    assert status == 200 and body == b"x" * 100
    assert proxy.toxics()["up"] == []  # expired, not lingering


def test_runtime_toggle_heals_live_proxy(proxy):
    proxy.set_toxics("down", [{"kind": "blackhole"}])
    with pytest.raises((urllib.error.URLError, OSError)):
        HttpClient(timeout=0.4).get(proxy.url + "100")
    proxy.clear()
    status, body = HttpClient(timeout=5.0).get(proxy.url + "100")
    assert status == 200 and body == b"x" * 100


def test_unknown_toxic_kind_rejected(proxy):
    with pytest.raises(ValueError):
        proxy.set_toxics("down", [{"kind": "gremlin"}])
    with pytest.raises(ValueError):
        proxy.set_toxics("sideways", [])


def test_response_size_cap_is_non_retryable(upstream):
    """A peer streaming more than max_response_bytes raises
    PeerResponseTooLarge — deliberately NOT an OSError, so
    retry_http_request propagates it after ONE attempt instead of
    replaying the giant download."""
    from janus_tpu_torch.core.retries import Backoff, retry_http_request

    url = f"http://127.0.0.1:{upstream.server_address[1]}/200000"
    client = HttpClient(timeout=5.0, max_response_bytes=1024)
    calls = {"n": 0}

    def do_request():
        calls["n"] += 1
        return client.get(url)

    with pytest.raises(PeerResponseTooLarge) as ei:
        retry_http_request(do_request, backoff=Backoff.test())
    assert calls["n"] == 1  # no replay
    assert not isinstance(ei.value, OSError)
    assert ei.value.limit_bytes == 1024


def test_probe_fetch_reads_at_most_its_cap(upstream):
    """fetch_any_status, the peer-health probe's GET, reads a body only
    up to its cap: a peer streaming a large body cannot make it read on."""
    from janus_tpu_torch.core.http_client import fetch_any_status

    url = f"http://127.0.0.1:{upstream.server_address[1]}/200000"
    assert fetch_any_status(url, timeout=5.0, max_bytes=1024) == (200, b"x" * 1024)
    assert fetch_any_status(url.replace("200000", "10"), timeout=5.0) == (200, b"x" * 10)


@pytest.mark.parametrize("toxic", [None, {"kind": "latency", "latency_s": 0.05}])
def test_wire_stats_equal_janus_tpus_proxy(upstream, toxic):
    """The same request through janus_tpu's FaultProxy and the port's: the
    same answer and the same wire stats."""
    stats = []
    for proxy_cls in (j_netsim.FaultProxy, FaultProxy):
        with proxy_cls("127.0.0.1", upstream.server_address[1]) as p:
            if toxic is not None:
                p.set_toxics("down", [toxic])
            assert HttpClient(timeout=5.0).get(p.url + "500") == (200, b"x" * 500)
            assert _settles(lambda: p.stats["bytes_down"] >= 500 and p.stats["bytes_up"] > 0)
            # how many chunks a response takes varies: compare which toxics fired
            stats.append({k: set(v) if k == "toxic_fired" else v for k, v in p.stats.items()
                          if k not in ("bytes_up", "bytes_down")})
    assert stats[0] == stats[1]
