"""First-class fault injection: a registry of named failpoints.

A DAP deployment's steady state includes helper outages, slow WANs and
mid-commit crashes; this module lets tests, the chaos harness
(scripts/chaos_run.py) and operators provoke those failures
deterministically at the exact seams where they happen in production
(docs/ROBUSTNESS.md has the full fault matrix).

Configuration — the `JANUS_FAILPOINTS` environment variable or the
`failpoints:` key of the common YAML config section (env wins):

    JANUS_FAILPOINTS='datastore.commit=error:0.3;helper.request=delay:2.0,count=5;engine.dispatch=oom:1'

Grammar (';'-separated entries):

    <name>=<action>[:<arg>][,prob=<P>][,count=<N>][,after=<K>]

Actions:

    error[:P]    raise at the site with probability P (default 1.0).
                 The site chooses the exception type so the injected
                 failure is indistinguishable from the real one (a
                 retryable transport error at the HTTP client, a
                 retryable conflict in run_tx, ...).
    delay[:S]    sleep S seconds (default 1.0), then continue — a slow
                 WAN / slow response body.
    timeout[:S]  sleep S seconds (default 1.0), then raise the site's
                 timeout error — a hung peer that eventually trips the
                 socket timeout.
    crash[:P]    os._exit(CRASH_EXIT_CODE) with probability P — the
                 moral equivalent of SIGKILL at this exact line; no
                 finally blocks, no flushes, no transaction rollback.
    oom[:P]      raise a RESOURCE_EXHAUSTED-shaped error so the engine
                 OOM-recovery path (halved-bucket retry, host fallback)
                 takes over.
    hang[:S]     park the calling thread — a wedged device dispatch /
                 tunnel stall that never returns. S seconds when given;
                 default (0) parks FOREVER, released only by the
                 process stopper (release_hangs(), wired to SIGTERM) or
                 by re-configuring/disarming the registry. A timed park
                 or a reconfigure-release RESUMES the site (the device
                 finally answered); a STOPPER release raises
                 FailpointError instead — a thread woken mid-teardown
                 must not re-enter real device work while the
                 interpreter finalizes. Pair with the dispatch watchdog
                 (docs/ROBUSTNESS.md "Device hangs & deadlines") to
                 prove hung work is abandoned, not waited out.

Modifiers: `prob=P` overrides the firing probability regardless of
action arg; `count=N` is a firing budget — after N firings the
failpoint goes inert (failures that storm and then clear); `after=K`
skips the first K hits of the site before arming — "let two jobs land,
wedge the third" schedules (the resident-accumulator chaos proof
quarantines mid-stream this way) without racing a sleep against the
job loop.

Scoped names: sites that serve many logical operations fire both their
base name and a scoped variant — run_tx fires `datastore.commit` and
`datastore.commit.<tx_name>` — so a schedule can target one transaction
("crash the leader's aggregation write, nothing else").

Cost when disabled: `hit()` is a single module-flag check; the registry
compiles to a no-op on every production hot path unless explicitly
armed.

The port's own copy of janus_tpu/failpoints.py, with its own registry
(configuring one package's failpoints arms nothing in the other). It
leaves out the `janus_failpoints_fired_total` counter; `status()` gives
each failpoint's hits and firings.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import threading
import time

log = logging.getLogger(__name__)

# Distinctive exit status for the crash action so harnesses can tell an
# injected crash from a real one.
CRASH_EXIT_CODE = 77

_ACTIONS = ("error", "delay", "timeout", "crash", "oom", "hang")


class FailpointError(Exception):
    """Deliberately injected failure (the default when a site does not
    supply a more realistic exception type)."""


class FailpointSpecError(ValueError):
    """A JANUS_FAILPOINTS / YAML failpoint spec did not parse."""


class _Failpoint:
    __slots__ = ("name", "action", "arg", "prob", "count", "after", "fired", "hits")

    def __init__(
        self,
        name: str,
        action: str,
        arg: float,
        prob: float,
        count: int | None,
        after: int = 0,
    ):
        self.name = name
        self.action = action
        self.arg = arg
        self.prob = prob
        self.count = count  # None = unlimited
        self.after = after  # skip the first N hits before arming
        self.fired = 0
        self.hits = 0

    def snapshot(self) -> dict:
        return {
            "action": self.action,
            "arg": self.arg,
            "prob": self.prob,
            "count": self.count,
            "after": self.after,
            "hits": self.hits,
            "fired": self.fired,
        }


# ENABLED is THE hot-path flag: hit() returns after one check when no
# failpoint is armed. Everything else is guarded by _lock.
ENABLED = False
_lock = threading.Lock()
_registry: dict[str, _Failpoint] = {}
# deterministic under JANUS_FAILPOINTS_SEED (chaos schedules that want
# reproducible probabilistic faults), process-random otherwise
_rng = random.Random(
    int(os.environ["JANUS_FAILPOINTS_SEED"])
    if os.environ.get("JANUS_FAILPOINTS_SEED")
    else None
)
# Threads parked by the hang action wait on this event. It is set (and
# replaced with a fresh one) on every reconfigure/disarm, and by
# release_hangs() — which the binaries' SIGTERM handler calls — so a
# parked "wedged device" releases on shutdown or schedule change
# instead of pinning teardown.
_hang_release = threading.Event()


def release_hangs() -> None:
    """Unpark every thread currently held by a hang failpoint (the
    process stopper hook: a modeled device wedge must not outlive the
    process's intent to exit). Unlike a reconfigure — where the site
    RESUMES, modeling a device that finally answered — a stopper
    release makes the site RAISE FailpointError: a thread woken during
    teardown must not re-enter real (native device) work while the
    interpreter finalizes underneath it."""
    global _hang_release
    with _lock:
        old = _hang_release
        _hang_release = threading.Event()
    old._janus_hang_raise = True  # waiters captured THIS event
    old.set()


def _parse_one(name: str, body: str) -> _Failpoint:
    parts = [p.strip() for p in body.split(",") if p.strip()]
    if not parts:
        raise FailpointSpecError(f"failpoint {name!r}: empty action")
    action, _, raw_arg = parts[0].partition(":")
    action = action.strip()
    if action not in _ACTIONS:
        raise FailpointSpecError(
            f"failpoint {name!r}: unknown action {action!r} (expected one of {_ACTIONS})"
        )
    try:
        # hang's arg is seconds with 0 = forever, so its default is 0
        arg = float(raw_arg) if raw_arg else (0.0 if action == "hang" else 1.0)
    except ValueError:
        raise FailpointSpecError(f"failpoint {name!r}: bad action arg {raw_arg!r}") from None
    # for error/crash/oom the positional arg IS the probability; for
    # delay/timeout/hang it is seconds and prob defaults to always
    prob = arg if action in ("error", "crash", "oom") else 1.0
    count = None
    after = 0
    for mod in parts[1:]:
        key, _, val = mod.partition("=")
        key = key.strip()
        try:
            if key == "prob":
                prob = float(val)
            elif key == "count":
                count = int(val)
            elif key == "after":
                after = int(val)
            else:
                raise FailpointSpecError(
                    f"failpoint {name!r}: unknown modifier {key!r} "
                    "(expected prob=/count=/after=)"
                )
        except ValueError:
            raise FailpointSpecError(f"failpoint {name!r}: bad modifier {mod!r}") from None
    if not 0.0 <= prob <= 1.0:
        raise FailpointSpecError(f"failpoint {name!r}: prob {prob} outside [0, 1]")
    if count is not None and count < 0:
        raise FailpointSpecError(f"failpoint {name!r}: negative count")
    if after < 0:
        raise FailpointSpecError(f"failpoint {name!r}: negative after")
    return _Failpoint(name, action, arg, prob, count, after)


def parse_spec(spec) -> dict[str, _Failpoint]:
    """Parse a spec string (`name=action:arg,mod=...;name2=...`) or a
    mapping ({name: "action:arg,mod=..."}, the YAML form) into
    failpoints. Raises FailpointSpecError on malformed input — a chaos
    schedule with a typo must fail loudly, not silently inject nothing.
    """
    entries: list[tuple[str, str]] = []
    if isinstance(spec, dict):
        entries = [(str(k).strip(), str(v)) for k, v in spec.items()]
    else:
        for chunk in str(spec).split(";"):
            chunk = chunk.strip()
            if not chunk:
                continue
            name, sep, body = chunk.partition("=")
            if not sep:
                raise FailpointSpecError(f"failpoint entry {chunk!r}: expected name=action")
            entries.append((name.strip(), body))
    out: dict[str, _Failpoint] = {}
    for name, body in entries:
        if not name:
            raise FailpointSpecError(f"failpoint entry with empty name: {body!r}")
        out[name] = _parse_one(name, body)
    return out


def configure(spec) -> None:
    """Replace the active failpoint set. `spec` is a spec string, a
    mapping, or None/''/{} to disarm everything."""
    global ENABLED, _hang_release
    parsed = parse_spec(spec) if spec else {}
    with _lock:
        _registry.clear()
        _registry.update(parsed)
        ENABLED = bool(_registry)
        # re-arming or disarming releases threads parked by the OLD
        # schedule's hang entries (the modeled wedge "recovers")
        old_release, _hang_release = _hang_release, threading.Event()
    old_release.set()
    if parsed:
        log.warning(
            "failpoints ARMED: %s",
            "; ".join(f"{n}={fp.action}:{fp.arg}" for n, fp in parsed.items()),
        )


def configure_from_env(default=None, environ=os.environ) -> None:
    """Arm from JANUS_FAILPOINTS, falling back to `default` (the YAML
    `failpoints:` value) when the env var is absent. An empty env var
    explicitly disarms (overriding the YAML)."""
    raw = environ.get("JANUS_FAILPOINTS")
    configure(raw if raw is not None else default)


def clear() -> None:
    configure(None)


# Boot-warmup suppression: engine warmup dispatches are
# infrastructure, not the serving path a chaos schedule drills. When a
# binary boots with failpoints armed AND warmup_engines_at_boot, the
# warmup's dispatches would otherwise consume `after=K` anchors and
# `count=` budgets, shifting where a scheduled fault lands — the
# suppression window keeps every site inert (hits not even counted) so
# schedules stay anchored to SERVING dispatch counts. Process-global
# on purpose: warm dispatches run on watchdog/lane worker threads, not
# the caller's, and boot warmup completes before serving starts.
_suppressed = 0


@contextlib.contextmanager
def suppressed():
    """Context manager: every failpoint site is a no-op inside."""
    global _suppressed
    with _lock:
        _suppressed += 1
    try:
        yield
    finally:
        with _lock:
            _suppressed -= 1


def status() -> dict:
    """Snapshot for /statusz: active failpoints with remaining budgets."""
    with _lock:
        if not _registry:
            return {"enabled": False}
        return {
            "enabled": True,
            "failpoints": {name: fp.snapshot() for name, fp in _registry.items()},
        }


def _lookup_and_arm(name: str) -> _Failpoint | None:
    """One armed firing of `name`, or None. Budget/probability are
    evaluated under the lock so concurrent sites cannot overspend a
    count= budget."""
    with _lock:
        fp = _registry.get(name)
        if fp is None:
            return None
        fp.hits += 1
        if fp.hits <= fp.after:
            return None  # not armed yet (after=K skips the first K hits)
        if fp.count is not None and fp.fired >= fp.count:
            return None
        if fp.prob < 1.0 and _rng.random() >= fp.prob:
            return None
        fp.fired += 1
    return fp


def _act(fp: _Failpoint, error_factory=None, timeout_factory=None, oom_factory=None) -> None:
    if fp.action == "delay":
        log.warning("failpoint %s: delaying %.3fs", fp.name, fp.arg)
        time.sleep(fp.arg)
        return
    if fp.action == "timeout":
        log.warning("failpoint %s: timing out after %.3fs", fp.name, fp.arg)
        time.sleep(fp.arg)
        exc = (
            timeout_factory()
            if timeout_factory is not None
            else TimeoutError(f"injected timeout (failpoint {fp.name})")
        )
        raise exc
    if fp.action == "crash":
        # the point is to model SIGKILL mid-line: no cleanup, no
        # rollback, no flush — only the log line (stderr) escapes
        log.error("failpoint %s: crashing (os._exit %d)", fp.name, CRASH_EXIT_CODE)
        os._exit(CRASH_EXIT_CODE)
    if fp.action == "oom":
        if oom_factory is not None:
            raise oom_factory()
        raise RuntimeError(f"RESOURCE_EXHAUSTED: injected failpoint {fp.name}")
    if fp.action == "hang":
        with _lock:
            release = _hang_release
        log.warning(
            "failpoint %s: hanging %s",
            fp.name,
            f"{fp.arg:.3f}s" if fp.arg > 0 else "forever (until released)",
        )
        release.wait(fp.arg if fp.arg > 0 else None)
        if getattr(release, "_janus_hang_raise", False):
            # stopper release (process exiting): abort the site instead
            # of resuming the modeled device work mid-teardown
            raise FailpointError(f"hang released by process stop (failpoint {fp.name})")
        return
    # action == "error"
    log.warning("failpoint %s: injecting error", fp.name)
    exc = (
        error_factory()
        if error_factory is not None
        else FailpointError(f"injected failure (failpoint {fp.name})")
    )
    raise exc


def hit(name: str, error_factory=None, timeout_factory=None, oom_factory=None) -> None:
    """The instrumented-site entry point. A no-op (one module-flag
    check) unless failpoints are armed; otherwise evaluates `name`'s
    probability/budget and performs its action. `error_factory` /
    `timeout_factory` let the site raise its own realistic exception
    types for the error/timeout actions, and `oom_factory` the memory
    exhaustion its recovery path recognizes for the oom action."""
    if not ENABLED or _suppressed:
        return
    fp = _lookup_and_arm(name)
    if fp is not None:
        _act(fp, error_factory, timeout_factory, oom_factory)


def hit_scoped(base: str, scope: str, error_factory=None, timeout_factory=None) -> None:
    """Fire `base` and `base.scope` (e.g. `datastore.commit` and
    `datastore.commit.step_agg_job_write`) so schedules can target
    either every operation through a seam or one specific one."""
    if not ENABLED or _suppressed:
        return
    fp = _lookup_and_arm(base)
    if fp is not None:
        _act(fp, error_factory, timeout_factory)
    fp = _lookup_and_arm(base + "." + scope)
    if fp is not None:
        _act(fp, error_factory, timeout_factory)
