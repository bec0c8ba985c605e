"""Deterministic failpoint fault injection.

Copy of ``sm_distributed_tpu/utils/failpoints.py``, the same grammar and
behaviour, so the port's stores and work dir are fault-injectable the same
way.  Every recovery-relevant seam gets a *named injection point*::

    from ..utils.failpoints import failpoint, register_failpoint

    FP_RESULTS_RENAME = register_failpoint(
        "storage.results_rename", "between results tmp writes and renames")
    ...
    failpoint(FP_RESULTS_RENAME, path=tmp)   # no-op unless activated

Activation comes from the ``SM_FAILPOINTS`` environment variable (read once at
import, so spawned workers inherit faults) or programmatically via
``configure()``.  The spec grammar, ``;``-separated::

    SM_FAILPOINTS="storage.results_rename=crash@2;isocalc.shard_save=torn;
                   workdir.fetch=raise:OSError?0.5"

    name=action[:arg][@N][?P]

Actions:
    raise[:ExcName]  raise the named exception (allowlist below; default
                     ``FailpointError``) with a recognizable message
    crash[:code]     ``os._exit(code)`` — a hard process death with no cleanup
                     (default exit code 21)
    sleep:seconds    delay
    torn[:fraction]  truncate the file handed to ``failpoint(..., path=)`` to
                     ``fraction`` of its bytes (default 0.5) and CONTINUE
    enospc           raise ``OSError(errno.ENOSPC, ...)`` at this write seam
    wait:path        block until the file ``path`` exists, then continue: a
                     gate that holds a job at a seam until a chaos driver
                     has seen the state it waits for (the port's own action;
                     the JAX package's grammar has no such gate)

Triggers (both deterministic):
    @N       fire on the Nth hit of this failpoint only (1-based, per process)
    ?P       fire with probability P per hit, from a ``random.Random`` seeded
             by ``crc32(name) ^ SM_FAILPOINTS_SEED``

Every fired injection writes a ``FAILPOINT-FIRED name=... action=...`` line to
stderr (before crashing, for ``crash``) and counts into ``injected_counts()``;
recovery paths report themselves through ``record_recovery(event)``.  Both
counter families are exported through an attached service
``MetricsRegistry`` (``attach_metrics``) as
``sm_failpoints_injected_total{name=}`` and
``sm_recovery_events_total{event=}``.

Zero overhead when disabled: ``failpoint()`` is a single global read + ``is
None`` test before returning.
"""

from __future__ import annotations

import os
import random
import re
import sys
import threading
import time
import zlib
from dataclasses import dataclass
from pathlib import Path


class FailpointError(RuntimeError):
    """Default exception injected by a ``raise`` failpoint."""


# Injectable exception types — a deliberate allowlist (the spec comes from an
# env var; eval'ing arbitrary names would be a foot-gun).
_EXCEPTIONS: dict[str, type[BaseException]] = {
    "FailpointError": FailpointError,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "IOError": OSError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "MemoryError": MemoryError,
}

_SPEC_RE = re.compile(
    r"(?P<action>[a-z]+)"
    r"(?::(?P<arg>[^@?;]*))?"
    r"(?:@(?P<nth>\d+))?"
    r"(?:\?(?P<prob>[0-9.]+))?"
)

_lock = threading.RLock()
_registry: dict[str, str] = {}          # name -> one-line description
_injected: dict[str, int] = {}          # name -> fired count
_recovered: dict[str, int] = {}         # event -> recovery-action count
_metrics = None                         # attached MetricsRegistry (optional)

# None = disabled; the failpoint() fast path is one read + None test
_active: "dict[str, _Spec] | None" = None
_active_spec: str | None = None            # the spec text behind _active


def register_failpoint(name: str, description: str = "") -> str:
    """Declare an injection point.  Names are global and must be unique —
    a duplicate registration is a programming error (two seams would be
    indistinguishable in specs, docs, and metrics)."""
    with _lock:
        if name in _registry:
            raise ValueError(f"duplicate failpoint name: {name!r}")
        _registry[name] = description
    return name


def registered_failpoints() -> dict[str, str]:
    """{name: description} of every registered injection point.  Only
    complete once the modules hosting the seams have been imported."""
    with _lock:
        return dict(_registry)


@dataclass
class _Spec:
    name: str
    action: str                  # raise | crash | sleep | torn |
                                 # enospc | wait
    arg: str | None = None
    nth: int | None = None       # fire on this hit only (1-based)
    prob: float | None = None    # seeded per-hit probability
    hits: int = 0
    rng: random.Random | None = None


def _parse_one(name: str, rhs: str) -> _Spec:
    m = _SPEC_RE.fullmatch(rhs)
    if not m:
        raise ValueError(f"failpoint {name}: unparseable spec {rhs!r}")
    action = m.group("action")
    arg = m.group("arg")
    nth = int(m.group("nth")) if m.group("nth") else None
    prob = float(m.group("prob")) if m.group("prob") else None
    if action not in ("raise", "crash", "sleep", "torn", "enospc", "wait"):
        raise ValueError(f"failpoint {name}: unknown action {action!r}")
    if action == "enospc" and arg:
        raise ValueError(f"failpoint {name}: enospc takes no argument")
    if action == "raise" and arg and arg not in _EXCEPTIONS:
        raise ValueError(
            f"failpoint {name}: exception {arg!r} not in "
            f"{sorted(_EXCEPTIONS)}")
    if action == "wait" and not arg:
        raise ValueError(f"failpoint {name}: wait needs a gate file path")
    if action == "sleep":
        if not arg:
            raise ValueError(f"failpoint {name}: sleep needs a seconds arg")
        float(arg)
    if action == "torn" and arg:
        f = float(arg)
        if not 0.0 <= f < 1.0:
            raise ValueError(f"failpoint {name}: torn fraction must be in [0,1)")
    if action == "crash" and arg:
        int(arg)
    if nth is not None and nth < 1:
        raise ValueError(f"failpoint {name}: @N is 1-based")
    if prob is not None and not 0.0 < prob <= 1.0:
        raise ValueError(f"failpoint {name}: ?P must be in (0,1]")
    rng = None
    if prob is not None:
        seed = zlib.crc32(name.encode()) ^ int(
            os.environ.get("SM_FAILPOINTS_SEED", "0"))
        rng = random.Random(seed)
    return _Spec(name=name, action=action, arg=arg or None,
                 nth=nth, prob=prob, rng=rng)


def parse_failpoints(text: str) -> dict[str, _Spec]:
    """Parse a full ``SM_FAILPOINTS`` spec string; raises ``ValueError`` with
    the offending name on any malformed entry."""
    out: dict[str, _Spec] = {}
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, rhs = part.partition("=")
        name = name.strip()
        if not sep or not name or not rhs.strip():
            raise ValueError(f"malformed failpoint entry {part!r} "
                             "(want name=action[:arg][@N][?P])")
        if name in out:
            raise ValueError(f"failpoint {name} specified twice")
        out[name] = _parse_one(name, rhs.strip())
    return out


def configure(spec: str | None) -> None:
    """Activate a spec string (env-var grammar); ``None``/empty disables.
    Replaces any previous activation and resets hit counters."""
    global _active, _active_spec
    with _lock:
        _active_spec = spec or None
        if not spec:
            _active = None
            return
        _active = parse_failpoints(spec)


def active_spec() -> str | None:
    """The currently-armed spec string (or None).  Process pools spawned by
    the engine pass this to their worker initializers so a programmatic
    ``configure()`` in the parent reaches spawned children the same way the
    ``SM_FAILPOINTS`` env var does (children re-read the env at import, but
    never see the parent's in-process configuration)."""
    with _lock:
        return _active_spec


def reset() -> None:
    """Disable injection and clear the injected/recovery counters (tests)."""
    global _active, _active_spec
    with _lock:
        _active = None
        _active_spec = None
        _injected.clear()
        _recovered.clear()


def injected_counts() -> dict[str, int]:
    with _lock:
        return dict(_injected)


def recovery_counts() -> dict[str, int]:
    with _lock:
        return dict(_recovered)


def record_recovery(event: str, n: int = 1) -> None:
    """Called by recovery paths (corrupt-shard skip, orphan-tmp sweep, stale
    requeue, ...) so fault-injection runs can prove recovery actually
    engaged, and so the service exports ``sm_recovery_events_total``."""
    if n <= 0:
        return
    with _lock:
        _recovered[event] = _recovered.get(event, 0) + n
        m = _metrics
    if m is not None:
        m.counter("sm_recovery_events_total",
                  "Recovery actions taken, by event",
                  ("event",)).labels(event=event).inc(n)


def attach_metrics(registry) -> None:
    """Export both counter families through a service ``MetricsRegistry``.
    Counts recorded before attachment are backfilled."""
    global _metrics
    with _lock:
        _metrics = registry
        inj = dict(_injected)
        rec = dict(_recovered)
    fam = registry.counter("sm_failpoints_injected_total",
                           "Faults injected by failpoint name", ("name",))
    for name, n in inj.items():
        fam.labels(name=name).inc(n)
    fam_r = registry.counter("sm_recovery_events_total",
                             "Recovery actions taken, by event", ("event",))
    for event, n in rec.items():
        fam_r.labels(event=event).inc(n)


def _should_fire(spec: _Spec) -> bool:
    spec.hits += 1
    if spec.nth is not None and spec.hits != spec.nth:
        return False
    if spec.rng is not None and spec.rng.random() >= spec.prob:
        return False
    return True


def failpoint(name: str, path: str | os.PathLike | None = None) -> None:
    """The injection point.  ``path`` is the file a ``torn`` action mangles;
    seams that move/commit a file should pass it."""
    active = _active
    if active is None:
        return                      # disabled: the zero-overhead fast path
    spec = active.get(name)
    if spec is None:
        return
    with _lock:
        if not _should_fire(spec):
            return
        _injected[name] = _injected.get(name, 0) + 1
        m = _metrics
    if m is not None:
        m.counter("sm_failpoints_injected_total",
                  "Faults injected by failpoint name",
                  ("name",)).labels(name=name).inc()
    sys.stderr.write(
        f"FAILPOINT-FIRED name={name} action={spec.action} "
        f"hit={spec.hits} path={path or ''}\n")
    sys.stderr.flush()
    # attach the trigger to the owning span — emitted (and the trace line
    # flushed) before the action runs, so even a crash action leaves its
    # mark in the job's trace for the post-mortem
    from . import tracing

    tracing.event("failpoint", name=name, action=spec.action, hit=spec.hits)
    if spec.action == "raise":
        exc = _EXCEPTIONS[spec.arg or "FailpointError"]
        raise exc(f"injected failpoint {name} (hit {spec.hits})")
    if spec.action == "enospc":
        import errno

        raise OSError(
            errno.ENOSPC,
            f"No space left on device [injected failpoint {name} "
            f"(hit {spec.hits})]", str(path) if path is not None else None)
    if spec.action == "crash":
        os._exit(int(spec.arg or 21))
    if spec.action == "sleep":
        time.sleep(float(spec.arg))
        return
    if spec.action == "wait":
        gate = Path(spec.arg)
        while not gate.exists():
            time.sleep(0.01)
        return
    if spec.action == "torn":
        if path is None:
            raise FailpointError(
                f"failpoint {name}: torn action but the seam passed no path")
        p = Path(path)
        size = p.stat().st_size
        keep = int(size * float(spec.arg or 0.5))
        with open(p, "r+b") as f:
            f.truncate(keep)
        return


# Env activation happens once at import: every process of a run (the CLI, its
# isocalc pool workers) sees the same spec without plumbing.
configure(os.environ.get("SM_FAILPOINTS"))
