"""Device-memory exhaustion: classification and the proven-safe batch memory.

Copy of ``sm_distributed_tpu/models/oom.py`` for the card.  A CUDA
out-of-memory is a *sizing* signal (this dataset x this batch does not fit
on the card), never a health verdict about the device.  This module gives
the scoring seam (``models/msm_basic.py::MSMBasicSearch._score_group``) the
vocabulary to treat it so:

- :func:`is_oom_error` recognizes the allocator's failure shapes:
  ``torch.OutOfMemoryError`` (the caching allocator's "CUDA out of
  memory"), cuBLAS's ``CUBLAS_STATUS_ALLOC_FAILED`` (a matmul whose
  workspace cannot be allocated), the JAX package's text markers, and a
  plain ``MemoryError``, which the ``backend.device_error`` failpoint can
  inject deterministically;
- the **safe-batch registry**: after a backoff converges, the proven-safe
  batch is recorded per :func:`shape_key` (dataset shape x backend x device
  lease), so the NEXT job on the same shape starts at the size that fits
  instead of re-discovering the OOM; ``MSMBasicSearch`` consults it before
  building the backend and the checkpoint partition.

``torch.OutOfMemoryError`` is a ``RuntimeError``: a classifier must test for
OOM before anything that treats a ``RuntimeError`` as a device fault
(``models/faults.py::classify`` does).  The service exports the
``sm_oom_*`` family (``attach_metrics``) and shows the registry on ``GET
/debug/resources``.

The registry is process-global plain state under one leaf lock: a
performance memo, not a correctness mechanism; losing it on restart only
costs one extra backoff cycle.
"""

from __future__ import annotations

import threading

import torch

from ..utils import tracing
from ..utils.logger import logger

# substrings that mark an exception as device memory exhaustion: torch's
# caching allocator raises OutOfMemoryError("CUDA out of memory. Tried to
# allocate ..."), cuBLAS reports CUBLAS_STATUS_ALLOC_FAILED when a matmul's
# workspace cannot be allocated; the rest are the JAX package's (XLA's
# RESOURCE_EXHAUSTED texts).  MemoryError is the host-side (and
# failpoint-injectable) shape.
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "Resource exhausted", "CUBLAS_STATUS_ALLOC_FAILED")


def is_oom_error(exc: BaseException) -> bool:
    """Is this exception a memory-exhaustion signal (device or host)?"""
    if isinstance(exc, (MemoryError, torch.OutOfMemoryError)):
        return True
    text = str(exc)
    return any(m in text for m in _OOM_MARKERS)


def shape_key(n_pixels: int, backend: str, device_indices=None) -> str:
    """Registry key for a (dataset shape, device lease) combination: what a
    scoring batch's device footprint depends on.  ``None`` device_indices =
    the process's device.  The pixel count keys on its lattice bucket
    (``ops/buckets.pixel_bucket``): every dataset size in a bucket scores at
    the same scratch shapes, so a learned safe batch transfers across it."""
    from ..ops.buckets import pixel_bucket

    devs = ",".join(str(int(i)) for i in device_indices) \
        if device_indices else "*"
    return f"pxb{pixel_bucket(int(n_pixels))}|{backend}|dev[{devs}]"


class _GuardedRegistry:
    """The module singleton's state, lock-guarded."""

    _GUARDED_BY = {"_safe": "_lock", "_events": "_lock",
                   "_recoveries": "_lock"}

    def __init__(self):
        self._lock = threading.Lock()
        self._safe: dict[str, int] = {}
        self._events = 0              # OOM exceptions classified
        self._recoveries = 0          # backoffs that converged

    def record_event(self) -> None:
        with self._lock:
            self._events += 1

    def record_safe(self, key: str, batch: int) -> None:
        with self._lock:
            self._safe[key] = int(batch)
            self._recoveries += 1

    def safe_batch_for(self, key: str) -> int | None:
        with self._lock:
            return self._safe.get(key)

    def snapshot(self) -> dict:
        with self._lock:
            return {"events": self._events, "recoveries": self._recoveries,
                    "safe_batches": dict(self._safe)}

    def reset(self) -> None:
        with self._lock:
            self._safe.clear()
            self._events = 0
            self._recoveries = 0


_registry = _GuardedRegistry()
_metrics = None
_metrics_lock = threading.Lock()


def record_oom_event(where: str, error: str) -> None:
    """An OOM was classified at the scoring seam (before any retry)."""
    _registry.record_event()
    tracing.event("oom", where=where, error=error[:300])
    m = _metrics
    if m is not None:
        m.counter("sm_oom_events_total",
                  "Device/host memory-exhaustion errors classified at the "
                  "scoring seam").inc()


def record_safe_batch(key: str, batch: int) -> None:
    """A backoff converged: ``batch`` is proven to fit for ``key``; later
    jobs on the same shape start there."""
    _registry.record_safe(key, batch)
    logger.warning("oom: learned safe batch %d for %s", batch, key)
    tracing.event("oom_safe_batch", key=key, batch=int(batch))
    m = _metrics
    if m is not None:
        m.counter("sm_oom_recoveries_total",
                  "OOM backoffs that converged to a fitting batch size").inc()
        m.gauge("sm_oom_safe_batch",
                "Most recently learned proven-safe formula batch").set(batch)


def safe_batch_for(key: str) -> int | None:
    return _registry.safe_batch_for(key)


def snapshot() -> dict:
    """Registry contents: OOM events, converged backoffs, safe batches
    (``GET /debug/resources``)."""
    return _registry.snapshot()


def reset() -> None:
    """Forget learned sizes and counts (tests)."""
    _registry.reset()


def attach_metrics(registry) -> None:
    """Export the ``sm_oom_*`` family through a service MetricsRegistry;
    counts recorded before attachment are backfilled."""
    global _metrics
    with _metrics_lock:
        _metrics = registry
    snap = _registry.snapshot()
    registry.counter(
        "sm_oom_events_total",
        "Device/host memory-exhaustion errors classified at the scoring "
        "seam").inc(snap["events"])
    registry.counter(
        "sm_oom_recoveries_total",
        "OOM backoffs that converged to a fitting batch size").inc(
        snap["recoveries"])
    g = registry.gauge("sm_oom_safe_batch",
                       "Most recently learned proven-safe formula batch")
    if snap["safe_batches"]:
        g.set(list(snap["safe_batches"].values())[-1])
