"""Device-backend circuit breaker.

Port of ``sm_distributed_tpu/models/breaker.py``'s state machine.  The
breaker wraps the device scoring seam in ``MSMBasicSearch._score_group``:

- **closed**: device scoring as normal; each cleanly scored group counts as
  a success and resets the consecutive-error count;
- **open**: after ``service.breaker_threshold`` consecutive sticky device
  faults (``models/faults.py``; OOM, transient and program faults never
  count).  A ``torch_cuda`` job is refused with
  :class:`DeviceUnavailableError`, loudly: logged and counted
  (:func:`refused_count`), the job left FAILED for the caller's retry
  policy.  The port never moves device work to the host: the JAX package's
  degrade to the numpy oracle is not ported, and ``numpy_ref`` scores only
  when the config names it;
- **half-open**: once ``service.breaker_cooldown_s`` has elapsed, the next
  job's device build is allowed through as a probe.  A clean group closes
  the breaker; another device fault re-opens it and restarts the cooldown.

A process registry of breakers, one per chip, as in the JAX package: a
search holding a device-pool lease answers to its chips' breakers through
a :class:`LeaseBreaker` (a fault counts on every leased chip, a clean group
resets them all, and the device path runs only if every chip allows it; an
open chip breaker refuses the job, it never moves it to the host), so one
bad chip never refuses jobs holding other chips.  A search without a lease
answers to the process breaker (label ``"*"``).  The service exports
``sm_breaker_state{device=}``, ``sm_breaker_transitions_total`` and
``sm_breaker_refused_total`` (``attach_metrics``); the last stands where the
JAX package counts ``sm_breaker_degraded_total``.
"""

from __future__ import annotations

import threading
import time

from ..utils import tracing
from ..utils.logger import logger

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"

# the process-wide breaker's label
GLOBAL_LABEL = "*"
_STATE_CODE = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}


class DeviceUnavailableError(RuntimeError):
    """The device breaker is open: a ``torch_cuda`` job cannot score now.
    Raised instead of moving the work to the host; the caller's retry
    policy runs the job again after the cooldown."""


class CircuitBreaker:
    """Consecutive-failure breaker with half-open recovery probes."""

    # shared-state registry, the JAX package's own (tests hold the two equal):
    # these attrs may only be mutated under _lock
    _GUARDED_BY = {"_state": "_lock", "_failures": "_lock",
                   "_opened_at": "_lock", "transitions": "_lock"}

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 label: str = GLOBAL_LABEL):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.label = str(label)
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0
        self._opened_at = 0.0
        # (monotonic time, from, to) — bounded history for probes/tests
        self.transitions: list[tuple[float, str, str]] = []

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition_locked(self, to: str) -> None:
        # callers hold self._lock
        if self._state == to:
            return
        self.transitions.append((time.monotonic(), self._state, to))
        if len(self.transitions) > 256:
            del self.transitions[:-256]
        logger.warning("device breaker[%s]: %s -> %s (%d consecutive "
                       "failures)", self.label, self._state, to,
                       self._failures)
        tracing.event("breaker", device=self.label, from_state=self._state,
                      to_state=to, failures=self._failures)
        self._state = to
        _export_state(to, self.label)

    def allow_device(self) -> bool:
        """May the next job use the device backend?  In OPEN state this
        flips to HALF_OPEN once the cooldown has elapsed and admits that one
        caller as the recovery probe."""
        with self._lock:
            if self._state == STATE_CLOSED or self._state == STATE_HALF_OPEN:
                return True
            if time.monotonic() - self._opened_at >= self.cooldown_s:
                self._transition_locked(STATE_HALF_OPEN)
                return True
            return False

    def record_success(self) -> None:
        """A device scoring group completed cleanly."""
        with self._lock:
            self._failures = 0
            if self._state != STATE_CLOSED:
                self._transition_locked(STATE_CLOSED)

    def record_failure(self) -> bool:
        """A sticky device fault occurred; returns True when the breaker is
        now open (the caller refuses the job)."""
        with self._lock:
            self._failures += 1
            if self._state == STATE_HALF_OPEN or (
                    self._state == STATE_CLOSED
                    and self._failures >= self.threshold):
                self._opened_at = time.monotonic()
                self._transition_locked(STATE_OPEN)
            elif self._state == STATE_OPEN:
                self._opened_at = time.monotonic()
            return self._state == STATE_OPEN

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state, "failures": self._failures,
                    "threshold": self.threshold,
                    "cooldown_s": self.cooldown_s}


class LeaseBreaker:
    """Per-chip breaker view over one device-pool lease.

    A sticky fault at the scoring seam counts on EVERY leased chip's
    breaker (the seam cannot attribute deeper; the health probe does), a
    clean group resets them all, and the device path is allowed only when
    every chip's breaker allows it."""

    def __init__(self, breakers: list[CircuitBreaker]):
        self._breakers = list(breakers)

    @property
    def state(self) -> str:
        # the worst state across the lease: open > half_open > closed
        states = [b.state for b in self._breakers]
        for s in (STATE_OPEN, STATE_HALF_OPEN):
            if s in states:
                return s
        return STATE_CLOSED

    def allow_device(self) -> bool:
        # every chip is asked (no short-circuit), so each open breaker past
        # its cooldown flips to its half-open probe together
        return all([b.allow_device() for b in self._breakers])

    def record_success(self) -> None:
        for b in self._breakers:
            b.record_success()

    def record_failure(self) -> bool:
        return any([b.record_failure() for b in self._breakers])

    def snapshot(self) -> dict:
        return {b.label: b.snapshot() for b in self._breakers}


# ------------------------------------------------------- process registry
_lock = threading.Lock()
_breakers: dict[str, CircuitBreaker] = {}
_refused = 0
_metrics = None


def _breaker_locked(label: str) -> CircuitBreaker:
    b = _breakers.get(label)
    if b is None:
        b = _breakers[label] = CircuitBreaker(label=label)
    return b


def get_device_breaker(service_cfg=None, devices=None):
    """The process's breaker for a device scope: ``devices`` (a lease's
    chip tuple) selects its chips' breakers in a :class:`LeaseBreaker`;
    ``None`` the process breaker (label ``"*"``).  ``service_cfg`` (a
    ``ServiceConfig``) refreshes the thresholds in place; the state
    machines are untouched."""
    labels = ([GLOBAL_LABEL] if not devices
              else [str(int(d)) for d in devices])
    with _lock:
        picked = [_breaker_locked(lb) for lb in labels]
        if service_cfg is not None:
            for b in picked:
                b.threshold = int(service_cfg.breaker_threshold)
                b.cooldown_s = float(service_cfg.breaker_cooldown_s)
    if not devices:
        return picked[0]
    return LeaseBreaker(picked)


def breaker_for(label) -> CircuitBreaker | None:
    """The breaker of one label (a chip index or ``"*"``), or None when
    this process never touched it."""
    with _lock:
        return _breakers.get(str(label))


def breakers_snapshot() -> dict:
    """{label: snapshot} of every breaker this process touched (the ``GET
    /debug/devices`` body's breaker half)."""
    with _lock:
        picked = list(_breakers.values())
    return {b.label: b.snapshot() for b in picked}


def reset_device_breaker() -> None:
    """Fresh breakers, a zero refused count and no metrics (tests)."""
    global _refused, _metrics
    with _lock:
        _breakers.clear()
        _refused = 0
        _metrics = None


def _export_state(state: str, label: str) -> None:
    m = _metrics
    if m is None:
        return
    m.gauge("sm_breaker_state",
            "Device breaker state (0=closed, 1=half_open, 2=open), per "
            "chip ('*' = the un-leased process breaker)",
            ("device",)).labels(device=label).set(_STATE_CODE[state])
    m.counter("sm_breaker_transitions_total",
              "Device breaker state transitions, by chip and destination",
              ("device", "to")).labels(device=label, to=state).inc()


def attach_metrics(registry) -> None:
    """Export the breaker through a service ``MetricsRegistry``:
    ``sm_breaker_state{device=}``, ``sm_breaker_transitions_total{device=,
    to=}`` and ``sm_breaker_refused_total`` (refusals before attachment are
    backfilled)."""
    global _metrics
    with _lock:
        _metrics = registry
        existing = list(_breakers.values())
        refused = _refused
    g = registry.gauge(
        "sm_breaker_state",
        "Device breaker state (0=closed, 1=half_open, 2=open), per chip "
        "('*' = the un-leased process breaker)", ("device",))
    for b in existing or [CircuitBreaker()]:
        g.labels(device=b.label).set(_STATE_CODE[b.state])
    registry.counter(
        "sm_breaker_transitions_total",
        "Device breaker state transitions, by chip and destination",
        ("device", "to"))
    registry.counter(
        "sm_breaker_refused_total",
        "torch_cuda jobs refused on an open device breaker").inc(refused)


def refuse_device(reason: str) -> DeviceUnavailableError:
    """Count, log and trace one refused ``torch_cuda`` job; returns the
    error for the caller to raise."""
    global _refused
    with _lock:
        _refused += 1
        m = _metrics
    if m is not None:
        m.counter("sm_breaker_refused_total",
                  "torch_cuda jobs refused on an open device breaker").inc()
    logger.error("device breaker open: %s; the job fails for the retry "
                 "policy (the port does not move device work to the host)",
                 reason)
    tracing.event("device_refused", reason=reason[:300])
    return DeviceUnavailableError(f"device breaker open: {reason}")


def refused_count() -> int:
    """``torch_cuda`` jobs this process refused on an open breaker."""
    with _lock:
        return _refused
