"""End-to-end job tracing and the flight recorder.

Port of the parts of ``sm_distributed_tpu/utils/tracing.py`` the job path
uses.  A job's trace is a tree of spans sharing a ``trace_id`` minted at CLI
entry (``new_trace``), propagated through ``SearchJob`` and
``MSMBasicSearch`` into the isotope-pattern stream and its pool workers
(serialized across the spawn boundary, re-parented on return), with events
(failpoints, device peaks) attached to the owning span.  Records are the
reference's, one JSON object each:

- ``span``:  ``{kind, trace_id, span_id, parent_id, name, ts, dur, pid,
  tid, attrs}``, ``ts`` epoch seconds at entry, ``dur`` wall seconds;
- ``event``: ``{kind, trace_id, span_id, name, ts, pid, tid, attrs}``.

Sinks: a bounded in-memory flight recorder ring, process-global, and a
per-job JSONL file under the trace dir (append-only, one flushed line per
record).  The current span is ambient through a ``ContextVar``; a new
thread attaches explicitly (``with attach(ctx):``).  ``span()``/``event()``
with no context return at once.

The service's parts wait for the service port (ROADMAP queue 1 item 9):
replica and process identity on records, the disk-pressure write gate, and
the Chrome trace export.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from pathlib import Path

from .failpoints import failpoint, register_failpoint

_log = logging.getLogger("sm-tpu")

FP_TRACE_APPEND = register_failpoint(
    "trace.append",
    "inside a per-job trace file append (I/O error / ENOSPC) — trace "
    "emission must never fail the pipeline")

RECORD_KINDS = ("span", "event")

_CTX: contextvars.ContextVar["TraceContext | None"] = contextvars.ContextVar(
    "sm_trace_ctx", default=None)
_CAPTURE: contextvars.ContextVar["list | None"] = contextvars.ContextVar(
    "sm_trace_capture", default=None)

_enabled = True


def new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """Position in a trace: ids + the per-job sink every child inherits."""

    trace_id: str
    span_id: str
    job_id: str = ""
    file: str = ""                # per-job JSONL sink ("" = ring only)

    def child(self, span_id: str | None = None) -> "TraceContext":
        return TraceContext(trace_id=self.trace_id,
                            span_id=span_id or new_id(),
                            job_id=self.job_id, file=self.file)

    def to_wire(self) -> dict:
        """Minimal dict for a process hop (no file — workers have no sinks)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "job_id": self.job_id}

    @staticmethod
    def from_wire(d: dict | None) -> "TraceContext | None":
        if not d or not d.get("trace_id"):
            return None
        return TraceContext(trace_id=str(d["trace_id"]),
                            span_id=str(d.get("span_id", "")),
                            job_id=str(d.get("job_id", "")))


# --------------------------------------------------------- flight recorder
class FlightRecorder:
    """Bounded ring of the most recent records, process-wide."""

    def __init__(self, maxlen: int = 2048):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=maxlen)

    def record(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)

    def recent(self, n: int | None = None) -> list[dict]:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-max(0, int(n)):]

    def resize(self, maxlen: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(maxlen)))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    @property
    def maxlen(self) -> int:
        with self._lock:
            return self._ring.maxlen or 0


flight_recorder = FlightRecorder()


def configure(enabled: bool = True, ring_size: int | None = None) -> None:
    """Apply ``SMConfig.tracing`` knobs (CLI startup)."""
    global _enabled
    _enabled = bool(enabled)
    if ring_size is not None and ring_size != flight_recorder.maxlen:
        flight_recorder.resize(ring_size)


def enabled() -> bool:
    return _enabled


# --------------------------------------------------------------- file sink
# cached append handles: one flushed line per record, no per-record open()
_files_lock = threading.Lock()
_files: dict[str, object] = {}


def _file_handle_locked(path: str):
    """Caller holds ``_files_lock``."""
    f = _files.get(path)
    if f is None or f.closed:
        if len(_files) >= 64:         # bound fd usage across many jobs
            for stale in list(_files):
                with contextlib.suppress(OSError):
                    _files[stale].close()
                del _files[stale]
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        f = _files[path] = open(path, "a", encoding="utf-8")
    return f


def close_files() -> None:
    """Close cached trace-file handles (tests / shutdown)."""
    with _files_lock:
        for f in _files.values():
            with contextlib.suppress(OSError):
                f.close()
        _files.clear()


# reentrancy guard for the trace.append failpoint: a FIRED failpoint emits
# its own "failpoint" trace event, which re-enters _emit
_appending = threading.local()


def _emit(rec: dict, file: str) -> None:
    buf = _CAPTURE.get()
    if buf is not None:               # worker-side capture: no sinks here
        buf.append(rec)
        return
    flight_recorder.record(rec)
    if file:
        line = json.dumps(rec, default=str) + "\n"
        try:
            # I/O faults here degrade to a lost trace line, never a failed job
            if not getattr(_appending, "active", False):
                _appending.active = True
                try:
                    failpoint(FP_TRACE_APPEND, path=file)
                finally:
                    _appending.active = False
            with _files_lock:         # whole-line writes, never interleaved
                f = _file_handle_locked(file)
                f.write(line)
                f.flush()
        except OSError:               # tracing must never fail the pipeline
            _log.warning("trace emit to %s failed", file, exc_info=True)


# ------------------------------------------------------------ context + API
def current() -> TraceContext | None:
    return _CTX.get()


@contextlib.contextmanager
def attach(ctx: TraceContext | None):
    """Make ``ctx`` the ambient trace context for this thread/block."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def new_trace(job_id: str = "", trace_dir: str | Path | None = None,
              trace_id: str | None = None,
              span_id: str | None = None) -> TraceContext:
    """Mint a root context (does not emit anything).  ``trace_dir`` selects
    the per-job JSONL sink: ``<trace_dir>/<trace_id>.jsonl``."""
    tid = trace_id or new_id()
    file = str(trace_path(trace_dir, tid)) if trace_dir else ""
    return TraceContext(trace_id=tid, span_id=span_id or new_id(),
                        job_id=job_id, file=file)


def trace_path(trace_dir: str | Path, trace_id: str) -> Path:
    return Path(trace_dir) / f"{trace_id}.jsonl"


def _base(ctx: TraceContext, name: str, kind: str) -> dict:
    rec = {
        "kind": kind, "trace_id": ctx.trace_id, "span_id": ctx.span_id,
        "name": name, "ts": time.time(), "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if ctx.job_id:
        rec["job_id"] = ctx.job_id
    return rec


@contextlib.contextmanager
def span(name: str, /, ctx: TraceContext | None = None, **attrs):
    """Timed child span of ``ctx`` (or the ambient context).  No-op without
    either.  Yields the child context (ambient inside the block), emits the
    span record on exit; a raising body is recorded with ``error`` in attrs
    and re-raised."""
    parent = ctx if ctx is not None else _CTX.get()
    if parent is None or not _enabled:
        yield None
        return
    child = parent.child()
    rec = _base(child, name, "span")
    rec["parent_id"] = parent.span_id
    if attrs:
        rec["attrs"] = attrs
    token = _CTX.set(child)
    t0 = time.perf_counter()
    try:
        yield child
    except BaseException as exc:
        rec.setdefault("attrs", {})["error"] = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        _CTX.reset(token)
        rec["dur"] = time.perf_counter() - t0
        _emit(rec, parent.file)


def emit_span(ctx: TraceContext, name: str, /, ts: float = 0.0,
              dur: float = 0.0,
              span_id: str | None = None, parent_id: str = "",
              **attrs) -> None:
    """Emit a span record with explicit timing — for spans whose body ran
    elsewhere (the CLI's root ``submit`` span closed after the job)."""
    if ctx is None or not _enabled:
        return
    rec = {
        "kind": "span", "trace_id": ctx.trace_id,
        "span_id": span_id or new_id(), "parent_id": parent_id,
        "name": name, "ts": ts, "dur": dur, "pid": os.getpid(),
        "tid": threading.get_ident(),
    }
    if ctx.job_id:
        rec["job_id"] = ctx.job_id
    if attrs:
        rec["attrs"] = attrs
    _emit(rec, ctx.file)


def event(name: str, /, ctx: TraceContext | None = None, **attrs) -> None:
    """Instant event attached to the owning span (``ctx`` or ambient).
    With neither, the event still lands in the flight recorder with empty
    ids."""
    if not _enabled:
        return
    owner = ctx if ctx is not None else _CTX.get()
    if owner is None:
        owner = TraceContext(trace_id="", span_id="")
    rec = _base(owner, name, "event")
    if attrs:
        rec["attrs"] = attrs
    _emit(rec, owner.file)


# ----------------------------------------------- process-hop (pool workers)
@contextlib.contextmanager
def capture():
    """Redirect this thread's emissions into a list instead of the sinks —
    the worker side of a process hop.  Yields the list; the parent process
    passes it to ``emit_records`` after the hop returns."""
    buf: list[dict] = []
    token = _CAPTURE.set(buf)
    try:
        yield buf
    finally:
        _CAPTURE.reset(token)


def emit_records(records: list[dict] | None,
                 ctx: TraceContext | None = None) -> None:
    """Emit records captured in a worker (they already carry trace/parent
    ids from the wire context; the parent process owns the sinks).  ``ctx``
    supplies the file sink."""
    if not records or not _enabled:
        return
    file = ctx.file if ctx is not None else ""
    for rec in records:
        if isinstance(rec, dict) and rec.get("kind") in RECORD_KINDS:
            _emit(rec, file)


def read_trace(path: str | Path) -> list[dict]:
    """Parse a per-job JSONL trace file; tolerates a torn trailing line."""
    out: list[dict] = []
    try:
        text = Path(path).read_text(encoding="utf-8")
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue                  # torn trailing write
        if isinstance(rec, dict):
            out.append(rec)
    return out
