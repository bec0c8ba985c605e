"""Logging setup and the phase timer.

Port of ``sm_distributed_tpu/utils/logger.py``: one engine-wide logger named
``sm-tpu``, console + optional file handler, ``JsonLogFormatter`` (``logs.json:
true``: one JSON object per line with ``trace_id``/``job_id``/``span`` from
the ambient trace context), exception-safe phase observers, and
``phase_timer``, which records a phase's wall seconds, logs it, notifies the
observers and emits a tracing span for it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

from . import tracing

LOGGER_NAME = "sm-tpu"
_FMT = "%(asctime)s - %(levelname)s - %(name)s - %(message)s"


class JsonLogFormatter(logging.Formatter):
    """Structured JSON log lines with trace correlation fields.

    Every record carries ``trace_id``/``job_id``/``span`` from the ambient
    trace context (empty strings when the emitting thread is untraced), so
    one grep joins scheduler, engine, backend, and spool lines for a job.
    """

    def format(self, record: logging.LogRecord) -> str:
        ctx = tracing.current()
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
            "trace_id": ctx.trace_id if ctx else "",
            "job_id": ctx.job_id if ctx else "",
            "span": ctx.span_id if ctx else "",
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def _formatter(json_logs: bool) -> logging.Formatter:
    return JsonLogFormatter() if json_logs else logging.Formatter(_FMT)


def init_logger(logs_dir: str | None = None, level: int = logging.INFO,
                json_logs: bool = False) -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(level)
    if not logger.handlers:
        sh = logging.StreamHandler()
        logger.addHandler(sh)
    if logs_dir:
        path = Path(logs_dir)
        path.mkdir(parents=True, exist_ok=True)
        if not any(isinstance(h, logging.FileHandler) for h in logger.handlers):
            logger.addHandler(logging.FileHandler(path / "sm-tpu.log"))
    # (re)apply the format to every handler: a later init_logger call with
    # json_logs flips existing handlers too (the CLI owns the config)
    for h in logger.handlers:
        h.setFormatter(_formatter(json_logs))
    return logger


logger = logging.getLogger(LOGGER_NAME)

# Observers called as fn(phase, seconds) on every phase_timer exit, in
# registration order; one that raises never breaks the others.
_phase_observers: list = []


def add_phase_observer(fn) -> None:
    """Register a phase-duration observer (idempotent per function)."""
    if fn not in _phase_observers:
        _phase_observers.append(fn)


def remove_phase_observer(fn) -> None:
    """Remove a previously registered observer (missing = no-op)."""
    with contextlib.suppress(ValueError):
        _phase_observers.remove(fn)


def _notify_phase(phase: str, dt: float) -> None:
    """Exception-safe dispatch: an observer that raises must not break
    phase_timer (or starve the observers after it)."""
    for fn in list(_phase_observers):
        try:
            fn(phase, dt)
        except Exception:  # observability must never fail the pipeline
            logger.warning("phase observer %r failed for %s", fn, phase,
                           exc_info=True)


@contextlib.contextmanager
def phase_timer(phase: str, timings: dict[str, float] | None = None):
    """Log the wall-clock of a pipeline phase; optionally record it into a
    timings dict, notify observers, and emit a tracing span when the thread
    carries an ambient trace context."""
    t0 = time.perf_counter()
    logger.info("phase %s ...", phase)
    try:
        with tracing.span(phase, phase=True):
            yield
    finally:
        dt = time.perf_counter() - t0
        logger.info("phase %s done in %.3fs", phase, dt)
        if timings is not None:
            timings[phase] = timings.get(phase, 0.0) + dt
        _notify_phase(phase, dt)
