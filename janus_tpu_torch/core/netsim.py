"""In-process TCP fault proxy (toxiproxy-style) for wire-level chaos.

Every prior fault drill injected failures IN-PROCESS (failpoints.py
raises a synthetic URLError before a socket is touched), so the
retry/breaker/lease machinery had never seen a real wire pathology:
mid-body stalls, truncated responses, RSTs, slow-drip bodies,
minutes-long blackholes. `FaultProxy` closes that gap: it listens on a
loopback port, pumps bytes to/from a real upstream (the helper
aggregator), and applies a runtime-togglable chain of *toxics* per
direction — so a REAL leader driver binary talks to a REAL helper
through a hostile wire, from chaos_run and tests, with zero external
dependencies.

Directions follow the toxiproxy convention, named from the proxy
client's point of view:

    "up"   = client -> upstream   (the leader's request bytes)
    "down" = upstream -> client   (the helper's response bytes)

Toxic taxonomy (dicts, so chaos_run schedules read like YAML):

    {"kind": "latency",   "latency_s": 0.05, "jitter_s": 0.02}
        sleep latency±jitter before forwarding each chunk
    {"kind": "bandwidth", "bytes_per_s": 8192}
        cap forward throughput (sleeps len(chunk)/rate per chunk)
    {"kind": "slicer",    "slice_bytes": 64, "delay_s": 0.05}
        slow-drip: forward in slice_bytes pieces with delay_s between
        them — each read still makes "progress", defeating any
        per-read socket timeout on the receiver
    {"kind": "reset",     "after_bytes": 0}
        hard RST (SO_LINGER 0) once after_bytes of this direction have
        been forwarded; 0 = pre-body (first chunk resets immediately)
    {"kind": "truncate",  "after_bytes": 100}
        forward exactly after_bytes, then close BOTH sockets cleanly
        (FIN): the receiver sees a short body, not an error
    {"kind": "blackhole"}
        swallow everything: bytes of this direction are read and
        dropped, nothing is forwarded, no response ever comes — the
        client's own timeout is the only way out

Every toxic takes an optional "count": the number of CONNECTIONS it
applies to before expiring (toxiproxy's toxicity knob made
deterministic). Omitted = applies until cleared. Toxic chains are
re-read per chunk, so `set_toxics` / `clear` mid-connection affect
live flows — exactly how a real outage starts in the middle of a
response body.

The port's own copy of janus_tpu/core/netsim.py (host code, no torch).
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time

log = logging.getLogger(__name__)

_CHUNK = 65536
# bounded sleep quantum so stop() never waits behind a long toxic sleep
_SLEEP_QUANTUM = 0.05

TOXIC_KINDS = ("latency", "bandwidth", "slicer", "reset", "truncate", "blackhole")


class _ConnReset(Exception):
    """Internal: the reset toxic fired — RST both sockets."""


class _ConnTruncate(Exception):
    """Internal: the truncate toxic fired — FIN both sockets."""


class _Toxic:
    """One armed toxic instance plus its remaining connection budget."""

    __slots__ = ("spec", "remaining", "fired")

    def __init__(self, spec: dict):
        kind = spec.get("kind")
        if kind not in TOXIC_KINDS:
            raise ValueError(f"unknown toxic kind {kind!r} (want one of {TOXIC_KINDS})")
        self.spec = dict(spec)
        count = spec.get("count")
        self.remaining = None if count is None else int(count)
        self.fired = 0


class FaultProxy:
    """TCP proxy between `127.0.0.1:port` and `(upstream_host,
    upstream_port)` with per-direction toxic chains. Thread-per-pump;
    `start()`/`stop()` bound every thread's lifetime."""

    def __init__(
        self,
        upstream_host: str,
        upstream_port: int,
        listen_host: str = "127.0.0.1",
        listen_port: int = 0,
        connect_timeout_s: float = 10.0,
    ):
        self.upstream_host = upstream_host
        self.upstream_port = int(upstream_port)
        self.listen_host = listen_host
        self._requested_port = int(listen_port)
        self.connect_timeout_s = connect_timeout_s
        self.port: int | None = None
        self._lock = threading.Lock()
        self._toxics: dict[str, list[_Toxic]] = {"up": [], "down": []}
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._conns: list[tuple[socket.socket, socket.socket]] = []
        self._stopped = threading.Event()
        # wire stats (chaos gates assert toxics actually FIRED — a lane
        # that silently never touched the wire proves nothing)
        self.stats = {
            "connections_total": 0,
            "bytes_up": 0,
            "bytes_down": 0,
            "resets": 0,
            "truncates": 0,
            "blackholed_chunks": 0,
            "toxic_fired": {},  # kind -> count
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "FaultProxy":
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.listen_host, self._requested_port))
        listener.listen(64)
        listener.settimeout(0.2)
        self._listener = listener
        self.port = listener.getsockname()[1]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="netsim-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for a, b in conns:
            for s in (a, b):
                self._fin(s)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5)

    def __enter__(self) -> "FaultProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def url(self) -> str:
        """Base HTTP URL of the proxy listener (chaos task endpoints)."""
        return f"http://{self.listen_host}:{self.port}/"

    # ------------------------------------------------------------------
    # toxic control (runtime-togglable, per direction)
    # ------------------------------------------------------------------
    def set_toxics(self, direction: str, toxics: list[dict]) -> None:
        """Replace the toxic chain for one direction ("up"/"down").
        Live connections see the change on their next chunk."""
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be 'up' or 'down', not {direction!r}")
        armed = [_Toxic(t) for t in toxics]
        with self._lock:
            self._toxics[direction] = armed

    def add_toxic(self, direction: str, toxic: dict) -> None:
        if direction not in ("up", "down"):
            raise ValueError(f"direction must be 'up' or 'down', not {direction!r}")
        with self._lock:
            self._toxics[direction].append(_Toxic(toxic))

    def clear(self, direction: str | None = None) -> None:
        """Drop all toxics (or one direction's); the wire heals."""
        with self._lock:
            for d in ("up", "down") if direction is None else (direction,):
                self._toxics[d] = []

    def toxics(self) -> dict[str, list[dict]]:
        with self._lock:
            return {
                d: [dict(t.spec, fired=t.fired) for t in chain]
                for d, chain in self._toxics.items()
            }

    def _claim_toxics(self, direction: str) -> list[dict]:
        """Snapshot this direction's active toxic specs for ONE new
        connection, consuming one unit of each budgeted toxic's count
        and expiring exhausted ones."""
        with self._lock:
            chain = self._toxics[direction]
            claimed: list[dict] = []
            survivors: list[_Toxic] = []
            for t in chain:
                if t.remaining is None:
                    claimed.append(t.spec)
                    survivors.append(t)
                elif t.remaining > 0:
                    t.remaining -= 1
                    claimed.append(t.spec)
                    if t.remaining > 0:
                        survivors.append(t)
                # remaining == 0 on entry: already spent, drop it
            self._toxics[direction] = survivors
            return claimed

    def _count_fired(self, kind: str) -> None:
        with self._lock:
            fired = self.stats["toxic_fired"]
            fired[kind] = fired.get(kind, 0) + 1

    # ------------------------------------------------------------------
    # data plane
    # ------------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                client, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                upstream = socket.create_connection(
                    (self.upstream_host, self.upstream_port),
                    timeout=self.connect_timeout_s,
                )
            except OSError as e:
                log.debug("netsim: upstream dial failed: %s", e)
                try:
                    client.close()
                except OSError:
                    pass
                continue
            with self._lock:
                self.stats["connections_total"] += 1
                self._conns.append((client, upstream))
            # per-connection toxic snapshot: a budgeted toxic ("count")
            # is claimed at accept time so exactly N connections feel it
            conn_toxics = {
                "up": self._claim_toxics("up"),
                "down": self._claim_toxics("down"),
            }
            for direction, src, dst in (
                ("up", client, upstream),
                ("down", upstream, client),
            ):
                threading.Thread(
                    target=self._pump,
                    args=(direction, src, dst, client, upstream, conn_toxics),
                    name=f"netsim-{direction}",
                    daemon=True,
                ).start()

    def _sleep(self, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while not self._stopped.is_set():
            left = deadline - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(left, _SLEEP_QUANTUM))

    @staticmethod
    def _rst(sock: socket.socket) -> None:
        """Abortive close: RST instead of FIN. SHUT_RD first — it is
        local-only for TCP (nothing on the wire) but wakes a sibling
        pump thread blocked in recv() on this fd; a close() alone is
        DEFERRED by the kernel while that syscall holds the file ref,
        so the RST would never be sent."""
        try:
            sock.shutdown(socket.SHUT_RD)
        except OSError:
            pass
        try:
            sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0)
            )
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    @staticmethod
    def _fin(sock: socket.socket) -> None:
        """Clean close that actually reaches the peer NOW: shutdown(2)
        acts on the socket immediately (FIN on the wire, blocked
        sibling recv() woken) even while another pump thread's
        in-flight recv holds the fd's file ref and defers close(2)."""
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _pump(
        self,
        direction: str,
        src: socket.socket,
        dst: socket.socket,
        client: socket.socket,
        upstream: socket.socket,
        conn_toxics: dict,
    ) -> None:
        forwarded = 0
        byte_key = "bytes_up" if direction == "up" else "bytes_down"
        try:
            while not self._stopped.is_set():
                try:
                    chunk = src.recv(_CHUNK)
                except OSError:
                    break
                if not chunk:
                    # clean EOF: half-close toward dst so e.g. an HTTP
                    # request body boundary still propagates
                    try:
                        dst.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    break
                # live chain = the proxy's CURRENT chain for kinds armed
                # after the connection started, plus this connection's
                # claimed budgeted toxics
                with self._lock:
                    live = [t.spec for t in self._toxics[direction]]
                chain = conn_toxics[direction] + [
                    s for s in live if s not in conn_toxics[direction]
                ]
                try:
                    forwarded = self._apply_chain(
                        chain, direction, chunk, dst, forwarded, byte_key
                    )
                except _ConnReset:
                    with self._lock:
                        self.stats["resets"] += 1
                    self._rst(client)
                    self._rst(upstream)
                    return
                except _ConnTruncate:
                    with self._lock:
                        self.stats["truncates"] += 1
                    for s in (client, upstream):
                        self._fin(s)
                    return
                except OSError:
                    break
        finally:
            # one side died: tear down both (a half-dead proxy flow
            # would look like a stall, which is the blackhole's job)
            for s in (src, dst):
                self._fin(s)

    def _apply_chain(
        self,
        chain: list[dict],
        direction: str,
        chunk: bytes,
        dst: socket.socket,
        forwarded: int,
        byte_key: str,
    ) -> int:
        """Run one received chunk through the toxic chain, forwarding
        whatever survives. Returns the updated forwarded-byte count."""
        for spec in chain:
            kind = spec["kind"]
            if kind == "blackhole":
                with self._lock:
                    self.stats["blackholed_chunks"] += 1
                self._count_fired("blackhole")
                return forwarded  # swallowed; never forwarded
            if kind == "latency":
                jitter = float(spec.get("jitter_s", 0.0))
                delay = float(spec.get("latency_s", 0.0))
                if jitter:
                    delay += random.uniform(-jitter, jitter)
                if delay > 0:
                    self._count_fired("latency")
                    self._sleep(delay)
            elif kind == "bandwidth":
                rate = float(spec.get("bytes_per_s", 0.0))
                if rate > 0:
                    self._count_fired("bandwidth")
                    self._sleep(len(chunk) / rate)
            elif kind == "reset":
                if forwarded + len(chunk) > int(spec.get("after_bytes", 0)) or not chunk:
                    allowed = max(0, int(spec.get("after_bytes", 0)) - forwarded)
                    if allowed:
                        dst.sendall(chunk[:allowed])
                        with self._lock:
                            self.stats[byte_key] += allowed
                    self._count_fired("reset")
                    raise _ConnReset()
            elif kind == "truncate":
                limit = int(spec.get("after_bytes", 0))
                if forwarded + len(chunk) >= limit:
                    allowed = max(0, limit - forwarded)
                    if allowed:
                        dst.sendall(chunk[:allowed])
                        with self._lock:
                            self.stats[byte_key] += allowed
                    self._count_fired("truncate")
                    raise _ConnTruncate()
            elif kind == "slicer":
                size = max(1, int(spec.get("slice_bytes", 64)))
                delay = float(spec.get("delay_s", 0.05))
                self._count_fired("slicer")
                for off in range(0, len(chunk), size):
                    dst.sendall(chunk[off : off + size])
                    with self._lock:
                        self.stats[byte_key] += len(chunk[off : off + size])
                    if off + size < len(chunk):
                        self._sleep(delay)
                return forwarded + len(chunk)
        dst.sendall(chunk)
        with self._lock:
            self.stats[byte_key] += len(chunk)
        return forwarded + len(chunk)
