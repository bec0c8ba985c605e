"""Device-fault taxonomy: one classification for every backend exception.

Copy of ``sm_distributed_tpu/models/faults.py`` with a fourth class for the
card.  Every exception raised while a backend scores maps to exactly one
kind:

``oom``
    Memory exhaustion (``models/oom.py`` is the authority, and is asked
    first: ``torch.OutOfMemoryError`` is a ``RuntimeError``).  A sizing
    signal: the scoring batch halves and rescores in place.  Never a device
    fault: no breaker count.
``program``
    A fault of the program, not of the device: ``kernels._build.KernelError``
    (nvcc missing or failing, a library that does not load, a launch check
    such as no thread-block cluster of this shape fitting the card), CUDA
    errors that name the launch or the code (invalid configuration,
    argument or value; no kernel image for the device; too many resources
    requested; an illegal or misaligned address; an illegal instruction; a
    device-side assert; a launch failure), and every other exception that
    names neither the device nor an injection.  Re-raised at once, never
    counted by the breaker: the kernels load lazily at their
    first launch, so a build failure surfaces inside ``score_batches``, and
    counting it would open the breaker after three jobs and refuse every
    later one with the broken kernel named nowhere.
``transient``
    Known-recoverable runtime hiccups: ``TimeoutError`` /
    ``ConnectionError`` and the status texts below.  The attempt fails into
    the caller's retry policy, with no breaker count.
``sticky``
    Errors that name the device (an uncorrectable ECC or NVLink error, a
    lost device, CUDA's "unknown error") and the injected
    ``backend.chip_fault`` / ``backend.device_error`` failpoints.  The
    breaker (``models/breaker.py``) counts these; below its threshold the
    fault re-raises, at it the breaker opens and the job fails with
    ``DeviceUnavailableError``.  No class moves device work to the host.

The split, in the order :func:`classify` tests it: oom, program (the kernel
error class and the code markers), transient, sticky (the device and
injection markers), and program for the rest.  The JAX package's
taxonomy, where everything that is neither OOM nor transient is sticky,
classifies the program faults above as sticky.

``_score_group`` reports every classified non-OOM fault through
:func:`report_device_fault` (the job trace, ``sm_device_faults_total{kind=}``
and, for transient and sticky faults, the service's health tracker, which
:func:`set_fault_listener` subscribes) and every clean device group through
:func:`report_device_ok`.  A program fault never reaches the health tracker:
it says nothing about the chip.
"""

from __future__ import annotations

import threading

from ..kernels._build import KernelError
from ..utils import tracing
from ..utils.failpoints import register_failpoint
from ..utils.logger import logger
from . import oom

FAULT_OOM = "oom"
FAULT_PROGRAM = "program"
FAULT_TRANSIENT = "transient"
FAULT_STICKY = "sticky"

# The injectable chip-fault seam (fired in MSMBasicSearch._score_group next
# to backend.device_error): the raised exception CLASS selects the
# taxonomy — raise:ConnectionError / raise:TimeoutError inject a transient,
# raise:RuntimeError a sticky device fault, and raise:MemoryError still
# lands in the OOM sizing path.
FP_CHIP_FAULT = register_failpoint(
    "backend.chip_fault",
    "inside a device score_batches call — the classified chip-fault seam "
    "(models/faults.py): ConnectionError/TimeoutError = transient (no "
    "breaker count), other exceptions = sticky (breaker count)")

# the failpoints whose injected errors count as device faults
INJECTED_MARKERS = ("backend.chip_fault", "backend.device_error")

# CUDA error texts (lower case) that name the launch or the code
_PROGRAM_MARKERS = (
    "invalid configuration",
    "invalid argument",
    "invalid value",
    "invalid device function",
    "no kernel image",
    "too many resources requested",
    "illegal memory access",
    "illegal address",
    "misaligned address",
    "illegal instruction",
    "device-side assert",
    "launch failure",
)

# Status texts that mark an exception as KNOWN-transient (the JAX
# package's list).
_TRANSIENT_MARKERS = (
    "deadline_exceeded",
    "deadline exceeded",
    "unavailable",
    "aborted",
    "cancelled by peer",
    "collective",            # collective timeout / all-reduce stall
    "all-reduce",
    "all_reduce",
    "tunnel",                # dying proxy/tunnel
    "connection reset",
    "broken pipe",
    "temporarily unavailable",
    "too many requests",
)

# error texts (lower case) that name the device itself
_DEVICE_MARKERS = (
    "uncorrectable ecc",
    "ecc error",
    "uncorrectable nvlink",
    "unknown error",
    "fallen off the bus",
    "gpu is lost",
    "device lost",
    "no cuda-capable device",
)


def classify(exc: BaseException) -> str:
    """Map one backend exception to its fault kind (module docstring)."""
    if oom.is_oom_error(exc):
        return FAULT_OOM
    if isinstance(exc, KernelError):
        return FAULT_PROGRAM
    text = str(exc).lower()
    if any(m in text for m in _PROGRAM_MARKERS):
        return FAULT_PROGRAM
    if isinstance(exc, (TimeoutError, ConnectionError)):
        return FAULT_TRANSIENT
    if any(m in text for m in _TRANSIENT_MARKERS):
        return FAULT_TRANSIENT
    if any(m in text for m in _DEVICE_MARKERS) or is_injected(exc):
        return FAULT_STICKY
    return FAULT_PROGRAM


def is_injected(exc: BaseException) -> bool:
    """Was ``exc`` raised by a device-fault failpoint?"""
    text = str(exc)
    return any(m in text for m in INJECTED_MARKERS)


# ------------------------------------------------------- listener + metrics
_lock = threading.Lock()
_listener = None                       # the service's HealthTracker
_metrics = None


def set_fault_listener(listener) -> None:
    """Subscribe a health tracker (``service/health.py``): it receives every
    transient or sticky device fault as ``report_fault(devices, kind,
    error)`` and every clean device group as ``report_ok(devices)``.  One
    listener per process (the last registration wins: the live scheduler's
    pool)."""
    global _listener
    with _lock:
        _listener = listener


def clear_fault_listener(listener=None) -> None:
    """Detach.  With ``listener`` given, only when it is still the
    registered one: a newer scheduler's registration survives an older
    service's teardown."""
    global _listener
    with _lock:
        if listener is None or _listener is listener:
            _listener = None


def report_device_fault(devices, kind: str, error: BaseException | str) -> None:
    """A classified fault at the scoring seam.  ``devices`` is the job's
    lease chip tuple (None for un-leased runs: nothing to attribute).
    Stamps the job trace, exports ``sm_device_faults_total{kind=}`` and
    dispatches transient and sticky faults to the health listener."""
    err = str(error)
    tracing.event("device_fault", kind=kind, error=err[:300],
                  **({"devices": [int(d) for d in devices]}
                     if devices else {}))
    m = _metrics
    if m is not None:
        m.counter("sm_device_faults_total",
                  "Classified device faults at the scoring seam, by kind",
                  ("kind",)).labels(kind=kind).inc()
    with _lock:
        listener = _listener
    if listener is None or not devices or kind == FAULT_PROGRAM:
        return
    try:
        listener.report_fault(tuple(int(d) for d in devices), kind, err)
    except Exception:
        logger.warning("device-fault listener %r failed", listener,
                       exc_info=True)


def report_device_ok(devices) -> None:
    """A clean device scoring group: clears the lease chips' suspect state
    and fault counters (a quarantine is only undone by a re-probe)."""
    with _lock:
        listener = _listener
    if listener is None or not devices:
        return
    try:
        listener.report_ok(tuple(int(d) for d in devices))
    except Exception:
        logger.warning("device-fault listener %r failed", listener,
                       exc_info=True)


def attach_metrics(registry) -> None:
    """Export ``sm_device_faults_total{kind=}`` through a service
    ``MetricsRegistry``."""
    global _metrics
    with _lock:
        _metrics = registry
    registry.counter("sm_device_faults_total",
                     "Classified device faults at the scoring seam, by kind",
                     ("kind",))


def reset() -> None:
    """Detach the listener and the metrics (tests)."""
    global _listener, _metrics
    with _lock:
        _listener = None
        _metrics = None
