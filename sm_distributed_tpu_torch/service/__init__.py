"""The port's annotation service: a long-running service over the spool.

Copies of ``sm_distributed_tpu/service``'s modules for the card:

- ``scheduler``  — the concurrent job scheduler: a worker pool draining the
  spool, priority classes + per-tenant fairness, device-bound phases under
  per-job **device-pool leases** (``device_pool``: a lease of chip ``i``
  runs the job on ``cuda:i``) while CPU staging/parse overlap; the failure
  policy (cooperative cancellation, retry with backoff + jitter,
  dead-letter with the traceback, heartbeats, a stall watchdog, crash-loop
  quarantine) and fenced multi-replica leases (``leases``);
- ``health``     — per-chip health, with a copy round-trip probe;
- ``admission``  — overload protection for ``POST /submit``;
- ``resources``  — the disk-budget governor and retention GC;
- ``metrics``    — counters/gauges/histograms with Prometheus text
  exposition;
- ``telemetry``  — device-memory monitor + SLO tracker;
- ``readpath``   — the result read path: segment queries, cursors, ion
  tiles, the governed read cache and read admission;
- ``api``        — the stdlib ``http.server`` admin API;
- ``fleetview``  — the fleet view behind ``GET /fleet/*`` (every live
  replica's exposition merged) and the device profiler behind ``GET
  /debug/profile``;
- ``primer``     — the kernel-build primer: builds, loads and sets up the
  kernels of the recorded bucket specs while the spool sits idle (``GET
  /debug/compile``);
- ``fleet``      — the elastic fleet controller (``serve --fleet``): spawn,
  crash replacement and zero-loss drains of ``serve`` replicas;
- ``server``     — ``AnnotationService`` composing all of the above (plus
  the device breaker, ``models/breaker.py``, and the stream ingest,
  ``engine/stream.py``) with graceful SIGTERM shutdown.
"""

from .admission import AdmissionController
from .device_pool import DeviceLease, DevicePool
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .scheduler import JobRecord, JobScheduler, RetryPolicy
from .server import AnnotationService
from .telemetry import DeviceMonitor, SLOTracker

__all__ = [
    "AdmissionController",
    "AnnotationService",
    "Counter",
    "DeviceLease",
    "DeviceMonitor",
    "DevicePool",
    "Gauge",
    "Histogram",
    "JobRecord",
    "JobScheduler",
    "MetricsRegistry",
    "RetryPolicy",
    "SLOTracker",
]
