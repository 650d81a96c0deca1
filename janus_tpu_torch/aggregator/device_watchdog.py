"""Watchdog-supervised device work: the card treated as a failable peer.

A device call has no timeout: a wedged kernel, or a blocking fetch behind
one, parks the calling thread for good, and a job driver's thread then
holds its lease until the lease runs out while the work is already dead.
`DispatchWatchdog.run(fn, deadline=...)` runs the device closure on a
reusable worker thread and waits for it, but never past the caller's
deadline (the ambient `core.deadline` budget: a job driver's lease
bound, a helper handler's propagated request budget).

A spent budget and a hung device are two things. When the caller's
budget runs out first, the caller gets DeadlineExceeded (the job steps
back `deadline_expired`, the helper answers 408) and the call runs on,
detached: if it finishes, its worker goes back to the pool. A call is
hung only when it is still unfinished `hang_after_s` after it started, a
fixed bound on how long a healthy device call may take: then its worker
is abandoned (it stays parked on the hung call, which cannot be
interrupted), is counted and listed with its current stack in
`status()`, `on_hang(label)` fires (the engine's quarantine) and, where
the caller still waits, it gets DeviceHangError. A caller that checks
the device's health (the canary's probe, a quarantined engine's fetch)
passes `hang_at_deadline=True`: its own deadline is the bound.

Abandoned threads are a leak by design (each pins a stack and what its
call staged), so they are capped: at `abandoned_thread_cap` parked
threads the watchdog trips `device_down()`. From then on every engine
refuses every dispatch for the life of the process and the canaries
stop: a device that has eaten that many threads is not coming back on
its own.

Disarmed cost (no ambient deadline): one contextvar read and a None
check; the closure runs on the caller's thread. Armed cost: the hand-off
to the worker and back, kept in `status()` (`armed_calls`,
`armed_handoff_s`: the wall time of the armed calls that returned, less
the time their closures ran).

The port's own copy of janus_tpu/aggregator/device_watchdog.py. Where
janus_tpu's cap trips a host-only mode (every engine serving from its
host engine), the port has no host engine: the cap trips `device_down()`
and `run` refuses with `DeviceQuarantinedError`. janus_tpu declares a
hang at the caller's deadline, where a quarantine costs little because
its host engine serves; here a quarantine refuses every dispatch, so a
short budget alone must not cause one, hence the separate bound. The
hung-dispatch counter and the abandoned-thread gauge are janus_tpu's,
`status()` is the statusz `device_watchdog` section (each parked
thread's stack rendered by profiler.format_stack, as janus_tpu's), and
the JANUS_WATCHDOG_ABANDONED_CAP environment default is not ported (the
cap is a constructor argument and `configure`). A binary sets the bound
with the port's own `device_watchdog: hang_after_secs` key.
"""

from __future__ import annotations

import contextvars
import logging
import queue
import sys
import threading
import time

from ..core.deadline import DeadlineExceeded
from ..profiler import format_stack
from ..statusz import register_status_provider as _register_status_provider

log = logging.getLogger(__name__)

# A supervised call still unfinished this long after it started is hung:
# well past any healthy dispatch or fetch of one bucket on the card, and
# the canary's probe bound (EngineCache.QUARANTINE_CANARY_TIMEOUT_SECS).
HANG_AFTER_S = 30.0

# What a refusal of device_down() advertises as its retry delay: the
# canary's longest back-off (EngineCache.QUARANTINE_CANARY_MAX_DELAY_SECS).
DEVICE_DOWN_RETRY_S = 60.0


class DeviceHangError(RuntimeError):
    """A supervised device call exceeded its deadline and was abandoned.
    Not a memory exhaustion: the engine's OOM ladder must not absorb it;
    it quarantines the engine and the job steps back instead."""

    def __init__(self, label: str, waited_s: float):
        super().__init__(
            f"device dispatch {label!r} abandoned after {waited_s:.3f}s "
            "(past the hang bound; thread parked and counted)"
        )
        self.label = label
        self.waited_s = waited_s


class DeviceQuarantinedError(RuntimeError):
    """The engine refused a dispatch before staging anything: it is
    quarantined after a hang (until its canary restores it, about
    `retry_in_s` from now), or the watchdog tripped device_down()."""

    def __init__(self, what: str, retry_in_s: float):
        super().__init__(f"device refused {what}: quarantined, retry in {retry_in_s:.3f}s")
        self.retry_in_s = retry_in_s


# marks code already running on a watchdog worker, so nested supervised
# regions (a fetch that dispatches) do not stack a second worker
_in_watchdog: contextvars.ContextVar[bool] = contextvars.ContextVar("janus_torch_in_watchdog", default=False)


def in_watchdog() -> bool:
    return _in_watchdog.get()


class _Job:
    __slots__ = ("fn", "ctx", "done", "result", "exc", "lock", "abandoned", "detached", "timer", "label",
                 "started_at", "ran_s")

    def __init__(self, fn, ctx, label: str):
        self.fn = fn
        self.ctx = ctx
        self.done = threading.Event()
        self.result = None
        self.exc: BaseException | None = None
        self.lock = threading.Lock()
        self.abandoned = False
        # the caller's budget ran out first: no one waits for the result
        self.detached = False
        self.timer: threading.Timer | None = None
        self.label = label
        self.started_at = time.monotonic()
        self.ran_s = 0.0

    def outcome(self):
        if self.exc is not None:
            raise self.exc
        return self.result


class DispatchWatchdog:
    """One per process (WATCHDOG below); engines call through `run`."""

    def __init__(self, abandoned_thread_cap: int = 8, hang_after_s: float = HANG_AFTER_S):
        self.abandoned_thread_cap = max(1, abandoned_thread_cap)
        self.hang_after_s = hang_after_s
        self._lock = threading.Lock()
        self._idle: list = []  # idle (thread, job queue) pairs
        self._stalled: dict[int, dict] = {}  # thread ident -> info
        self._device_down = False
        self._hung_total = 0
        self._budget_spent = 0
        self._armed_calls = 0
        self._armed_handoff_s = 0.0
        self._seq = 0

    def device_down(self) -> bool:
        """True once the abandoned-thread cap tripped: no further device
        dispatches in this process."""
        return self._device_down

    def reset_for_tests(self) -> None:
        """Drop device_down() and forget the stalled bookkeeping (the
        parked threads are daemons and unwind on their own)."""
        from .. import metrics

        with self._lock:
            self._device_down = False
            self._stalled.clear()
            self._idle.clear()
        metrics.abandoned_dispatch_threads.set(0.0)

    def _worker_loop(self, q) -> None:
        while True:
            job: _Job = q.get()
            t0 = time.monotonic()
            try:
                result = job.ctx.run(job.fn)
                exc = None
            except BaseException as e:  # noqa: BLE001 - handed to the caller's thread
                result, exc = None, e
            ident = threading.get_ident()
            with job.lock:
                job.result, job.exc = result, exc
                job.ran_s = time.monotonic() - t0
                abandoned, timer = job.abandoned, job.timer
                job.done.set()
            if timer is not None:
                timer.cancel()
            if abandoned:
                # the hung call returned at last (the device answered, or a
                # released failpoint): the result is dropped, the thread retires
                from .. import metrics

                with self._lock:
                    self._stalled.pop(ident, None)
                    n = len(self._stalled)
                metrics.abandoned_dispatch_threads.set(float(n))
                log.warning("abandoned dispatch %s completed after %.1fs; worker retiring",
                            job.label, time.monotonic() - job.started_at)
                return
            with self._lock:
                self._idle.append((threading.current_thread(), q))

    def _checkout_worker(self):
        with self._lock:
            if self._idle:
                return self._idle.pop()
            self._seq += 1
            seq = self._seq
        q: queue.Queue = queue.Queue(maxsize=1)
        t = threading.Thread(target=self._worker_loop, args=(q,), name=f"device-watchdog-{seq}", daemon=True)
        t.start()
        return t, q

    def run(self, fn, *, deadline: float | None = None, label: str = "dispatch", vdaf: str = "", on_hang=None,
            hang_at_deadline: bool = False):
        """Execute `fn` under supervision.

        deadline None (or already on a watchdog worker): a direct call.
        Otherwise `fn` runs on a worker in a copy of the caller's context
        (the deadline contextvar rides along; a thread's CUDA device and
        stream do not, so the caller's closure sets them). The caller
        waits until the call ends, its deadline, or the hang bound
        (`hang_after_s` after the start; the deadline itself with
        hang_at_deadline), whichever is first. At the deadline short of
        the bound: DeadlineExceeded, and the call runs on detached. At the
        bound (reached later by a detached call too): the worker is
        abandoned, `on_hang(label)` fires (the engine's quarantine hook)
        and a waiting caller gets DeviceHangError."""
        if deadline is None or _in_watchdog.get():
            return fn()
        if deadline - time.monotonic() <= 0:
            raise DeadlineExceeded(f"no budget left before dispatch {label!r}")
        if self._device_down:
            # engines refuse before dispatching; this is the backstop for
            # races around the trip
            raise DeviceQuarantinedError(label, DEVICE_DOWN_RETRY_S)
        ctx = contextvars.copy_context()
        ctx.run(_in_watchdog.set, True)
        job = _Job(fn, ctx, label)
        bound = deadline if hang_at_deadline else min(job.started_at + self.hang_after_s, deadline)
        thread, q = self._checkout_worker()
        q.put(job)
        if not job.done.wait(max(0.0, bound - time.monotonic())):
            with job.lock:
                if not job.done.is_set():
                    if hang_at_deadline or bound < deadline:
                        job.abandoned = True
                        self._record_hang(thread, job, vdaf)
                    else:
                        # only the caller's budget is spent: the hang check
                        # waits for the bound
                        job.detached = True
                        job.timer = threading.Timer(
                            job.started_at + self.hang_after_s - time.monotonic(), self._check_detached,
                            args=(thread, job, vdaf, on_hang))
                        job.timer.daemon = True
                        job.timer.start()
            if job.abandoned:
                self._call_hook(on_hang, label)
                raise DeviceHangError(label, time.monotonic() - job.started_at)
            if job.detached:
                with self._lock:
                    self._budget_spent += 1
                raise DeadlineExceeded(f"budget spent during {label!r} (the call runs on, detached)")
        handoff = time.monotonic() - job.started_at - job.ran_s
        with self._lock:
            self._armed_calls += 1
            self._armed_handoff_s += handoff
        return job.outcome()

    def _check_detached(self, thread: threading.Thread, job: _Job, vdaf: str, on_hang) -> None:
        """The hang bound of a detached call: still running is a hang."""
        with job.lock:
            if job.done.is_set():
                return
            job.abandoned = True
            self._record_hang(thread, job, vdaf)
        self._call_hook(on_hang, job.label)

    @staticmethod
    def _call_hook(on_hang, label: str) -> None:
        if on_hang is not None:
            try:
                on_hang(label)
            except Exception:
                log.exception("watchdog on_hang hook failed for %s", label)

    def _record_hang(self, thread: threading.Thread, job: _Job, vdaf: str) -> None:
        """Under job.lock, so a worker that returns now finds its entry."""
        from .. import metrics

        metrics.hung_dispatches_total.add(vdaf=vdaf, op=job.label)
        waited = time.monotonic() - job.started_at
        with self._lock:
            self._stalled[thread.ident] = {
                "label": job.label,
                "vdaf": vdaf,
                "thread": thread.name,
                "since": time.time(),
                "started_monotonic": job.started_at,
            }
            n = len(self._stalled)
            tripped = n >= self.abandoned_thread_cap and not self._device_down
            if tripped:
                self._device_down = True
            self._hung_total += 1
        metrics.abandoned_dispatch_threads.set(float(n))
        log.error("device dispatch %s HUNG (%.3fs, past its bound); thread %s abandoned (%d/%d parked)",
                  job.label, waited, thread.name, n, self.abandoned_thread_cap)
        if tripped:
            log.error("abandoned-dispatch cap %d reached: the device is DOWN for this process; every "
                      "engine refuses every dispatch", self.abandoned_thread_cap)

    def drain(self, timeout_s: float = 2.0) -> bool:
        """Wait (bounded) for abandoned workers to retire: the shutdown
        hook, called after failpoints.release_hangs(), so woken workers
        unwind before the interpreter finalizes. True when none remain."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._stalled:
                    return True
            time.sleep(0.01)
        with self._lock:
            return not self._stalled

    def status(self) -> dict:
        """Counts, the device_down flag, and a live stack of every parked
        thread: the first thing an operator wants when a dispatch wedges."""
        with self._lock:
            stalled = {ident: dict(info) for ident, info in self._stalled.items()}
            device_down = self._device_down
            hung_total = self._hung_total
            counts = {
                "budget_spent_total": self._budget_spent,
                "armed_calls": self._armed_calls,
                "armed_handoff_s": self._armed_handoff_s,
            }
        frames = sys._current_frames()
        now = time.monotonic()
        out_stalled = []
        for ident, info in sorted(stalled.items()):
            ent = {
                "label": info["label"],
                "vdaf": info["vdaf"],
                "thread": info["thread"],
                "age_s": round(now - info["started_monotonic"], 3),
            }
            frame = frames.get(ident)
            if frame is not None:
                ent["stack"] = format_stack(frame, limit=12, lineno=True)
            out_stalled.append(ent)
        return {
            "abandoned_threads": len(stalled),
            "abandoned_thread_cap": self.abandoned_thread_cap,
            "device_down": device_down,
            "hung_dispatches_total": hung_total,
            "hang_after_s": self.hang_after_s,
            **counts,
            "stalled": out_stalled,
        }


WATCHDOG = DispatchWatchdog()

_register_status_provider("device_watchdog", WATCHDOG.status)


def configure(abandoned_thread_cap: int | None = None, hang_after_s: float | None = None) -> None:
    """Set the process watchdog's abandoned-thread cap and hang bound."""
    if abandoned_thread_cap is not None:
        WATCHDOG.abandoned_thread_cap = max(1, int(abandoned_thread_cap))
    if hang_after_s is not None:
        WATCHDOG.hang_after_s = float(hang_after_s)

