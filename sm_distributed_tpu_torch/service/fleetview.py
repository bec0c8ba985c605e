"""Device profiling behind ``GET /debug/profile``.

Port of the ``DeviceProfiler`` of ``sm_distributed_tpu/service/
fleetview.py``: a single-flight ``torch.profiler`` capture around whatever
the scheduler has in flight (concurrent requests get 409), per-kernel
device-time attribution through ``analysis/profiling.py`` (the fused
moments kernel vs the scoring chain vs transfers), and ``device_kernel``
spans injected into every RUNNING job's trace so Perfetto shows host spans
and device kernels on one timeline.

The JAX module's ``FleetView`` (the ``/fleet/*`` aggregation across live
replicas) is not in the port yet: ROADMAP queue 1 item 9b.5.

Config: ``telemetry.profile``.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

from ..utils import tracing
from ..utils.config import ProfileConfig


class DeviceProfiler:
    """Single-flight ``torch.profiler`` capture behind ``/debug/profile``."""

    def __init__(self, service, cfg: ProfileConfig | None = None):
        self.service = service
        self.cfg = cfg or ProfileConfig()
        self.dir = Path(cfg.dir) if cfg and cfg.dir else \
            Path(service.sm_config.work_dir) / "profiles"
        self._busy = threading.Lock()
        self.c_captures = service.metrics.counter(
            "sm_profile_captures_total",
            "Completed /debug/profile capture sessions")

    def run(self, seconds: float | None) -> tuple[int, dict]:
        if not self.cfg.enabled:
            return 404, {"error": "device profiling disabled "
                                  "(telemetry.profile.enabled)",
                         "reason": "not_found"}
        if seconds is not None and seconds <= 0:
            return 400, {"error": "'seconds' must be positive",
                         "reason": "invalid_request"}
        secs = min(float(seconds or self.cfg.default_seconds),
                   self.cfg.max_seconds)
        if not self._busy.acquire(blocking=False):
            return 409, {"error": "a profile capture is already running",
                         "reason": "busy"}
        try:
            from ..analysis.profiling import ProfileSession

            session = ProfileSession(self.dir)
            running = [j for j in self.service.scheduler.jobs()
                       if j["state"] == "running"]
            try:
                session.start()
            except RuntimeError as exc:
                return 503, {"error": str(exc),
                             "reason": "profiler_unavailable"}
            time.sleep(secs)
            result = session.stop()
            injected = self._inject_device_spans(result["events"], running)
            self.c_captures.inc()
            return 200, {
                "seconds": secs,
                "duration_s": result["duration_s"],
                "trace_file": result["trace_file"],
                "attribution": result["attribution"],
                "jobs_running": [j["msg_id"] for j in running],
                "injected_spans": injected,
            }
        finally:
            self._busy.release()

    # a capture window can cover thousands of kernel launches; the job
    # trace gets the longest ones (the attribution table carries the rest)
    _MAX_INJECTED = 64

    def _inject_device_spans(self, events: list[dict],
                             running: list[dict]) -> int:
        """Inject ``device_kernel`` spans (wall-clock mapped) into every
        running job's trace file.  Returns the number of spans written (0
        with no running traced jobs — the capture result still carries the
        attribution)."""
        trace_dir = getattr(self.service, "trace_dir", None)
        if not events or not running or not trace_dir:
            return 0
        top = sorted(events, key=lambda e: e["dur_s"],
                     reverse=True)[:self._MAX_INJECTED]
        injected = 0
        for job in running:
            tid = job.get("trace_id")
            if not tid:
                continue
            ctx = tracing.TraceContext(
                trace_id=tid, span_id=tracing.new_id(),
                job_id=job["msg_id"],
                file=str(tracing.trace_path(trace_dir, tid)))
            for e in top:
                tracing.emit_span(
                    ctx, "device_kernel", ts=e["ts_wall"], dur=e["dur_s"],
                    module=e["module"], op=e["op"],
                    kernel_class=e["class"])
                injected += 1
        return injected
