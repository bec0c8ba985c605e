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

For the service: the scheduler's replica and process identity are stamped
on every record (``set_replica``, ``set_process``), the disk governor gates
file writes (``set_file_gate``) and its GC drops cached handles before it
unlinks an aged file (``close_file``), and ``GET /jobs/<id>/trace`` renders
records as Chrome trace-event JSON (``to_chrome_trace``).
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
# required keys per record kind (validate_records + the trace smoke driver)
_SPAN_KEYS = ("kind", "trace_id", "span_id", "parent_id", "name", "ts",
              "dur", "pid", "tid")
_EVENT_KEYS = ("kind", "trace_id", "span_id", "name", "ts", "pid", "tid")

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

    # guarded-by registry, the JAX package's own (tests hold the two equal)
    _GUARDED_BY = {"_ring": "_lock"}

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


# replica identity: stamped on every record this process emits, so a trace
# continued across a takeover shows which replica ran each span
_replica_id = ""


def set_replica(replica_id: str) -> None:
    """Set the process-wide replica id (service startup; "" disables)."""
    global _replica_id
    _replica_id = str(replica_id or "")


def replica() -> str:
    return _replica_id


# pod process identity (process_id, host) stamped on every record
_process_id = -1
_host = ""


def set_process(process_id: int, host: str = "") -> None:
    """Set the pod identity stamped on every record (-1/"" disables)."""
    global _process_id, _host
    _process_id = int(process_id)
    _host = str(host or "")


def process() -> tuple[int, str]:
    return _process_id, _host


def _stamp(rec: dict) -> None:
    if _replica_id:
        rec["replica"] = _replica_id
    if _process_id >= 0:
        rec["process"] = _process_id
    if _host:
        rec["host"] = _host


# --------------------------------------------------------------- file sink
# cached append handles: one flushed line per record, no per-record open()
_files_lock = threading.Lock()
_files: dict[str, object] = {}

# disk-pressure gate: the resource governor installs a callable consulted
# before every FILE write, so under disk pressure trace writes are the first
# thing dropped (ring records keep flowing).  None = always write.  The gate
# must be cheap and non-raising; it is called outside _files_lock.
_file_gate = None


def set_file_gate(fn) -> None:
    """Install (or clear, with ``None``) the trace-file write gate
    (``ResourceGovernor.trace_gate``)."""
    global _file_gate
    _file_gate = fn


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


def close_file(path: str | Path) -> None:
    """Drop one cached append handle (the GC sweeper calls this before
    unlinking an aged trace file, so a later append reopens instead of
    writing to an unlinked inode)."""
    with _files_lock:
        f = _files.pop(str(path), None)
        if f is not None:
            with contextlib.suppress(OSError):
                f.close()


# reentrancy guard for the trace.append failpoint: a FIRED failpoint emits
# its own "failpoint" trace event, which re-enters _emit
_appending = threading.local()


def _emit(rec: dict, file: str) -> None:
    buf = _CAPTURE.get()
    if buf is not None:               # worker-side capture: no sinks here
        buf.append(rec)
        return
    flight_recorder.record(rec)
    if file and (_file_gate is None or _file_gate()):
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
    _stamp(rec)
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
    _stamp(rec)
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


def validate_records(records: list[dict]) -> list[str]:
    """Schema check; returns problem strings (empty = valid).  The trace
    smoke driver and tests run every emitted trace through this."""
    problems = []
    for i, rec in enumerate(records):
        if not isinstance(rec, dict):
            problems.append(f"record {i}: not an object")
            continue
        kind = rec.get("kind")
        if kind not in RECORD_KINDS:
            problems.append(f"record {i}: bad kind {kind!r}")
            continue
        keys = _SPAN_KEYS if kind == "span" else _EVENT_KEYS
        missing = [k for k in keys if k not in rec]
        if missing:
            problems.append(f"record {i} ({kind} {rec.get('name')!r}): "
                            f"missing {missing}")
        if kind == "span" and not isinstance(rec.get("dur"), (int, float)):
            problems.append(f"record {i}: span dur not numeric")
        if "attrs" in rec and not isinstance(rec["attrs"], dict):
            problems.append(f"record {i}: attrs not an object")
    return problems


def to_chrome_trace(records: list[dict]) -> dict:
    """Trace records as Chrome trace-event JSON (Perfetto-loadable): spans
    become complete ``"X"`` events (µs timestamps), instants thread-scoped
    ``"i"`` events; a ``torch_profile`` event surfaces the job's
    ``torch.profiler`` trace dir in ``otherData``."""
    events: list[dict] = []
    other: dict = {}
    pids = set()
    for rec in records:
        pid = int(rec.get("pid", 0))
        pids.add(pid)
        args = dict(rec.get("attrs") or {})
        args["trace_id"] = rec.get("trace_id", "")
        args["span_id"] = rec.get("span_id", "")
        base = {
            "name": str(rec.get("name", "")),
            "cat": "span" if rec.get("kind") == "span" else "event",
            "pid": pid, "tid": int(rec.get("tid", 0)),
            "ts": round(float(rec.get("ts", 0.0)) * 1e6, 3),
            "args": args,
        }
        if rec.get("kind") == "span":
            base["ph"] = "X"
            base["dur"] = round(float(rec.get("dur", 0.0)) * 1e6, 3)
            if rec.get("parent_id"):
                base["args"]["parent_id"] = rec["parent_id"]
        else:
            base["ph"] = "i"
            base["s"] = "t"
            if rec.get("name") == "torch_profile" and "dir" in args:
                other["torch_profile_dir"] = args["dir"]
        events.append(base)
        if rec.get("trace_id") and "trace_id" not in other:
            other["trace_id"] = rec["trace_id"]
        if rec.get("job_id"):
            other.setdefault("job_id", rec["job_id"])
    for pid in sorted(pids):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "args": {"name": f"sm-tpu pid {pid}"}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}
