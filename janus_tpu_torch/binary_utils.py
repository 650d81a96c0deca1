"""Serving utilities shared by the port's HTTP listeners.

The port's own copy of `BoundedThreadingHTTPServer` from
janus_tpu/binary_utils.py, and `LongHeaderLines`, the handler mixin that
lets a request carry a header line longer than http.server's 64 KiB. The
rest of janus_tpu's module (the binaries' config loading, health
listener, readiness registry, profiler capture) is not ported.
"""

from __future__ import annotations

import http.client
import io
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from http import HTTPStatus
from http.server import ThreadingHTTPServer

# A dap-taskprov header carries a whole base64url TaskConfig: a
# Prio3Histogram of 10,000 buckets lists 9,999 u64 boundaries, about
# 106,700 characters, past http.server's 65,536-byte header line limit
# (janus_tpu's server refuses it). The port's server reads lines up to this.
MAX_HEADER_LINE = 1 << 20
MAX_HEADERS = 100


class LongHeaderLines:
    """BaseHTTPRequestHandler mixin: reads the header block with lines up
    to MAX_HEADER_LINE bytes. A line over http.client's limit reaches the
    stdlib parser as a placeholder and its value is put back after it, so
    everything else (the Connection and Expect handling, the message
    class) is the stdlib's."""

    def parse_request(self):
        rfile = self.rfile
        lines, long_values = [], {}
        while True:
            line = rfile.readline(MAX_HEADER_LINE + 1)
            if len(line) > MAX_HEADER_LINE:
                return self._refuse("Line too long")
            if len(line) > http.client._MAXLINE:
                name, _, value = line.partition(b":")
                token = b"long-header-line-%d" % len(long_values)
                long_values[token.decode()] = (name.decode("latin-1").strip(), value.decode("latin-1").strip())
                line = name + b": " + token + b"\r\n"
            lines.append(line)
            if len(lines) > MAX_HEADERS:
                return self._refuse("Too many headers")
            if line in (b"\r\n", b"\n", b""):
                break
        self.rfile = io.BytesIO(b"".join(lines))
        try:
            ok = super().parse_request()
        finally:
            self.rfile = rfile
        if ok:
            for token, (name, value) in long_values.items():
                if self.headers.get(name) == token:
                    self.headers.replace_header(name, value)
        return ok

    def _refuse(self, message: str) -> bool:
        # the fields the stdlib's parse_request sets before it reads headers
        self.requestline = str(self.raw_requestline, "iso-8859-1").rstrip("\r\n")
        words = self.requestline.split()
        self.command = words[0] if words else None
        self.request_version = words[-1] if len(words) == 3 else self.default_request_version
        self.close_connection = True
        self.send_error(HTTPStatus.REQUEST_HEADER_FIELDS_TOO_LARGE, message)
        return False


class BoundedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a fixed handler pool instead of a thread
    per connection: accepted connections are served by at most
    `max_handler_threads` workers; excess connections wait in the accept
    backlog or the pool queue."""

    # deep listen backlog: bursts of short-lived connections otherwise
    # overflow the default 5-entry accept queue into resets
    request_queue_size = 128

    def __init__(self, addr, handler_cls, max_handler_threads: int = 32):
        super().__init__(addr, handler_cls)
        self._max_handler_threads = max(1, max_handler_threads)
        self._active_connections = 0
        self._active_lock = threading.Lock()
        # accept time per connection (weak: entries vanish with the socket)
        self._accept_times = weakref.WeakKeyDictionary()
        self._pool = ThreadPoolExecutor(max_workers=self._max_handler_threads, thread_name_prefix="dap-handler")

    def queue_age_s(self, request) -> float | None:
        """Seconds `request` (a connection socket) waited between accept
        and a handler picking it up, once: later keep-alive requests on
        the same connection read None."""
        t = self._accept_times.pop(request, None)
        return None if t is None else time.monotonic() - t

    @property
    def saturated(self) -> bool:
        """Every pool worker is occupied by a connection; handlers then
        drop keep-alive so idle clients cannot pin every worker."""
        return self._active_connections >= self._max_handler_threads

    def process_request(self, request, client_address):
        try:
            self._accept_times[request] = time.monotonic()
        except TypeError:  # a socket type that takes no weak reference
            pass
        try:
            self._pool.submit(self._process_in_pool, request, client_address)
        except RuntimeError:  # pool already shut down (server closing)
            self.shutdown_request(request)

    def _process_in_pool(self, request, client_address):
        with self._active_lock:
            self._active_connections += 1
        try:
            self.finish_request(request, client_address)
        except Exception:
            self.handle_error(request, client_address)
        finally:
            with self._active_lock:
                self._active_connections -= 1
            self.shutdown_request(request)

    def server_close(self):
        super().server_close()
        self._pool.shutdown(wait=False)
