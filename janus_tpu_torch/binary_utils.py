"""Serving utilities shared by the port's HTTP listeners.

The port's own copy of `BoundedThreadingHTTPServer` from
janus_tpu/binary_utils.py. The rest of that module (the binaries'
config loading, health listener, profiler capture) is not ported.
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from http.server import ThreadingHTTPServer


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
