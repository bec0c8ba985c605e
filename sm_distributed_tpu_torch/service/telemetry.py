"""Quantitative telemetry: device-memory monitor, SLO tracker, snapshot ring.

Copy of ``sm_distributed_tpu/service/telemetry.py`` for the card:

- **DeviceMonitor** — a sampling thread reading per-device memory in use,
  peak and capacity (``utils/devicemem.py``: the caching allocator's
  counters per CUDA device, ``None`` without CUDA), the device pool's
  occupancy, and process RSS.  Every sample updates gauges on the shared
  ``MetricsRegistry`` AND lands in a bounded in-memory **time-series
  ring** served by ``GET /debug/timeseries``.  The monitor also installs a
  ``phase_timer`` observer so every traced job phase records its peak
  device memory (gauge ``sm_phase_hbm_peak_bytes{phase=}`` + an ``hbm``
  trace event) without the engine importing the service layer.

  Peaks are the allocator's per-device high-water mark since its last
  ``torch.cuda.reset_peak_memory_stats``, shared by every worker thread
  of the process: two jobs on one card see one peak.  The service only
  reads it, never resets it (a reset in one job would cut another's
  window short); the caller that owns a measurement window, such as a
  benchmark script between runs, owns the reset.

- **SLOTracker** — histograms for queue-wait (submit → first attempt
  start), submit → first annotation (the first scored checkpoint group;
  ``models/msm_basic.py`` notifies through a module-level observer list),
  and end-to-end latency (submit → terminal outcome), recorded at the
  scheduler's seams.  ``report()`` computes attainment against the
  configured objectives straight from the histogram buckets
  (``Histogram.fraction_below``) plus the error-budget burn rate —
  ``GET /slo``.  The read path observes the ``read`` SLI and the stream
  ingest's provisional re-ranks the ``stream_partial`` SLI.

Config: ``SMConfig.telemetry`` (enabled, sample_interval_s,
timeseries_len, slo_* objectives).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from pathlib import Path

from ..utils import devicemem, tracing
from ..utils.config import TelemetryConfig
from ..utils.logger import add_phase_observer, logger, remove_phase_observer

# occupancy is the mean of the most recent N token samples — at the default
# 5 s cadence this is a ~5 min sliding window, long enough to smooth one
# job's hold/release flapping, short enough to show a saturation trend
_OCCUPANCY_WINDOW = 60


class DeviceMonitor:
    """Sample device/HBM/cache/occupancy state into gauges + a ring."""

    # guarded-by registry, the JAX package's own (tests hold the two equal):
    # the snapshot ring is appended by the sampling thread and listed by HTTP
    # handlers; _occ is deliberately sampling-thread-private (no lock declared)
    _GUARDED_BY = {"_ring": "_lock"}

    def __init__(self, registry, cfg: TelemetryConfig | None = None,
                 queue_root: str | Path | None = None,
                 device_pool=None, replica_id: str = "",
                 readpath=None, stream_ingest=None):
        self.registry = registry
        self.cfg = cfg or TelemetryConfig()
        # replica identity: stamped on every timeseries sample so
        # a dashboard merging N replicas' /debug/timeseries can tell the
        # streams apart
        self.replica_id = replica_id
        # the scheduler's device pool (service/device_pool.py): sampled,
        # never taken
        self.device_pool = device_pool
        self.queue_root = Path(queue_root) if queue_root else None
        # the read path's cache and in-flight state and the stream
        # ingest's chunk counters sample into the ring too
        self.readpath = readpath
        self.stream_ingest = stream_ingest
        self._ring: deque = deque(maxlen=self.cfg.timeseries_len)
        self._occ: deque = deque(maxlen=_OCCUPANCY_WINDOW)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        m = registry
        self.g_hbm_in_use = m.gauge(
            "sm_device_hbm_bytes_in_use",
            "HBM bytes currently allocated, per device", ("device",))
        self.g_hbm_peak = m.gauge(
            "sm_device_hbm_peak_bytes",
            "Peak HBM bytes allocated since process start, per device",
            ("device",))
        self.g_hbm_limit = m.gauge(
            "sm_device_hbm_limit_bytes",
            "HBM capacity available to the allocator, per device",
            ("device",))
        self.g_devices = m.gauge(
            "sm_device_count", "CUDA devices visible to the process")
        self.g_occupancy = m.gauge(
            "sm_device_token_occupancy_ratio",
            "Fraction of recent samples that found the device token held "
            "(with a device pool: windowed mean of the pool-wide in-use "
            "ratio)")
        self.g_pool_ratio = m.gauge(
            "sm_device_pool_occupancy_ratio",
            "Fraction of pool chips currently held by job leases")
        self.g_phase_hbm = m.gauge(
            "sm_phase_hbm_peak_bytes",
            "Peak HBM observed at each pipeline phase's exit", ("phase",))
    # ------------------------------------------------------------- sampling
    def sample(self) -> dict:
        """Take one snapshot: update every gauge and append to the ring."""
        now = time.time()
        devices = devicemem.device_stats()
        hbm_in_use = hbm_peak = None
        for d in devices:
            label = f"{d['id']}:{d['kind']}"
            if d["bytes_in_use"] is not None:
                self.g_hbm_in_use.labels(device=label).set(d["bytes_in_use"])
                hbm_in_use = (hbm_in_use or 0) + d["bytes_in_use"]
            if d["peak_bytes"] is not None:
                self.g_hbm_peak.labels(device=label).set(d["peak_bytes"])
                hbm_peak = max(hbm_peak or 0, d["peak_bytes"])
            if d["limit_bytes"] is not None:
                self.g_hbm_limit.labels(device=label).set(d["limit_bytes"])
        self.g_devices.set(len(devices))

        locked = None
        pool_snap = None
        if self.device_pool is not None:
            # half-open device recovery: quarantined chips past
            # their cooldown are re-probed on the sampling cadence too, so
            # an idle service readmits recovered chips without waiting for
            # the next lease to trigger it
            health = getattr(self.device_pool, "health", None)
            if health is not None:
                try:
                    health.reprobe_due()
                except Exception:
                    logger.warning("telemetry: device re-probe failed",
                                   exc_info=True)
            # per-chip pool occupancy: the pool updates
            # its own sm_device_pool_in_use{device=} gauge at grant/release
            # (event-exact); here we sample the pool-WIDE ratio into the
            # window + ring so /debug/timeseries shows the saturation trend
            pool_snap = self.device_pool.snapshot()
            ratio = pool_snap["in_use"] / max(1, pool_snap["size"])
            locked = pool_snap["in_use"] >= pool_snap["size"]
            self.g_pool_ratio.set(ratio)
            self._occ.append(ratio)
            occupancy = sum(self._occ) / len(self._occ)
            self.g_occupancy.set(occupancy)
        else:
            occupancy = None

        # pod identity: samples from different host processes
        # interleave in shared dashboards — stamp which process took each
        proc_id, proc_host = tracing.process()
        snap = {
            "ts": round(now, 3),
            **({"replica": self.replica_id} if self.replica_id else {}),
            **({"process": proc_id} if proc_id >= 0 else {}),
            **({"host": proc_host} if proc_host else {}),
            "devices": len(devices),
            "device_kind": devices[0]["kind"] if devices else None,
            "hbm_bytes_in_use": hbm_in_use,
            "hbm_peak_bytes": hbm_peak,
            "device_token_locked": locked,
            "device_token_occupancy": (round(occupancy, 4)
                                       if occupancy is not None else None),
            "rss_bytes": _rss_bytes(),
        }
        if pool_snap is not None:
            snap["device_pool_size"] = pool_snap["size"]
            snap["device_pool_hosts"] = pool_snap.get("hosts", 1)
            snap["device_pool_per_host_in_use"] = pool_snap.get(
                "per_host_in_use")
            snap["device_pool_in_use"] = pool_snap["in_use"]
            snap["device_pool_ratio"] = round(
                pool_snap["in_use"] / max(1, pool_snap["size"]), 4)
            snap["device_pool_waiters"] = pool_snap["waiters"]
            snap["device_pool_grants_total"] = pool_snap["grants_total"]
            # chip-level health roll-up (service/health.py):
            # state counts + the fenced chip list, so /debug/timeseries
            # shows quarantines/readmits as a trend without scraping
            health = pool_snap.get("health")
            if health is not None:
                snap["device_health_ok"] = health["ok"]
                snap["device_health_suspect"] = health["suspect"]
                snap["device_health_quarantined"] = health["quarantined"]
                snap["device_quarantined"] = [
                    c["device"] for c in health["chips"]
                    if c["state"] == "quarantined"]
                snap["device_quarantines_total"] = (
                    health["quarantines_total"])
        if self.queue_root is not None:
            try:
                snap["queue_pending"] = len(
                    list(self.queue_root.glob("pending/*.json")))
                snap["queue_running"] = len(
                    list(self.queue_root.glob("running/*.json")))
            except OSError:
                pass
        # read plane: cache + in-flight state, so /debug/timeseries charts
        # read saturation beside device state
        if self.readpath is not None:
            rp = self.readpath.snapshot()
            cache = rp.get("cache", {})
            snap["read_inflight"] = rp.get("inflight")
            snap["read_sheds"] = rp.get("sheds")
            snap["read_cache_hits"] = cache.get("hits")
            snap["read_cache_misses"] = cache.get("misses")
            snap["read_cache_bytes"] = cache.get("bytes")
            snap["read_cache_entries"] = cache.get("entries")
        # stream plane: chunk/pixel/re-rank totals (from the shared
        # registry) + acquisitions currently open on the shared stream root
        if self.stream_ingest is not None:
            snap["stream_chunks_total"] = self.registry.value(
                "sm_stream_chunks_total")
            snap["stream_pixels_total"] = self.registry.value(
                "sm_stream_pixels_total")
            snap["stream_reranks_total"] = self.registry.value(
                "sm_stream_reranks_total")
            try:
                snap["stream_in_flight"] = self.stream_ingest.in_flight()
            except OSError:
                pass
        with self._lock:
            self._ring.append(snap)
        return snap

    def timeseries(self, n: int | None = None) -> list[dict]:
        with self._lock:
            items = list(self._ring)
        return items if n is None else items[-max(0, int(n)):]

    # ------------------------------------------------------ phase HBM hook
    def _observe_phase(self, phase: str, seconds: float) -> None:
        """phase_timer observer: record the peak device memory at every
        phase exit (gauge + an ``hbm`` event on the job's ambient trace).
        No-op without CUDA memory stats."""
        peak = devicemem.hbm_peak_bytes()
        if peak is None:
            return
        self.g_phase_hbm.labels(phase=phase).set(peak)
        tracing.event("hbm", phase=phase, peak_bytes=peak)

    # ------------------------------------------------------------ lifecycle
    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.sample_interval_s):
            try:
                self.sample()
            except Exception:  # telemetry must never kill the service
                logger.warning("telemetry sample failed", exc_info=True)

    def start(self) -> None:
        if self._thread is not None:
            return
        add_phase_observer(self._observe_phase)
        self.sample()                     # the ring is never empty once up
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-monitor")
        self._thread.start()

    def stop(self) -> None:
        remove_phase_observer(self._observe_phase)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def _rss_bytes() -> int | None:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


# ------------------------------------------------------------------- SLOs
class SLOTracker:
    """Latency SLIs as histograms + attainment/error-budget reporting.

    Five objectives (``SMConfig.telemetry.slo_*``), each "fraction of
    observations under T seconds >= target".  The scheduler records
    queue-wait at each job's FIRST attempt start and end-to-end latency at
    every terminal outcome; ``models/msm_basic.py`` notifies the first
    scored checkpoint group through its first-annotation observer list
    (the moment the first FDR-rankable metrics exist); the read path
    observes each served read and the scheduler each stream re-rank.
    Attainment comes from the histogram buckets themselves, so
    ``/slo`` and ``/metrics`` can never disagree.
    """

    # guarded-by registry, the JAX package's own (tests hold the two equal)
    _GUARDED_BY = {"_submits": "_lock", "_first_noted": "_lock"}

    def __init__(self, registry, cfg: TelemetryConfig | None = None):
        self.cfg = cfg or TelemetryConfig()
        self.h_queue_wait = registry.histogram(
            "sm_slo_queue_wait_seconds",
            "Submit -> first attempt start, per job")
        self.h_first_annotation = registry.histogram(
            "sm_slo_first_annotation_seconds",
            "Submit -> first scored checkpoint group, per job")
        self.h_e2e = registry.histogram(
            "sm_slo_e2e_seconds",
            "Submit -> terminal outcome, per job (all outcomes)")
        self.h_read = registry.histogram(
            "sm_slo_read_seconds",
            "Read-path request latency (annotations/cohort/tile GETs)")
        self.h_stream_partial = registry.histogram(
            "sm_slo_stream_partial_seconds",
            "Chunk commit -> provisional re-rank published, per re-rank")
        self._lock = threading.Lock()
        self._submits: dict[str, float] = {}     # job_id -> submit epoch
        self._first_noted: set[str] = set()

    # ------------------------------------------------------ recording seams
    def job_started(self, job_id: str, submit_ts: float,
                    attempt_start: float, attempt: int) -> None:
        """Scheduler seam: an attempt is starting.  Queue wait is observed
        once per job (first attempt only — retries are failure latency and
        belong to e2e, not to admission)."""
        with self._lock:
            self._submits[job_id] = submit_ts
        if attempt == 1:
            self.h_queue_wait.observe(max(0.0, attempt_start - submit_ts))

    def note_first_annotation(self, job_id: str = "") -> None:
        """msm_basic observer: the first checkpoint group finished scoring.
        ``job_id`` defaults to the ambient trace context's (the scoring
        thread runs under the attempt span).  Unknown jobs (offline CLI
        runs never registered by a scheduler) are ignored."""
        if not job_id:
            ctx = tracing.current()
            job_id = ctx.job_id if ctx is not None else ""
        if not job_id:
            return
        with self._lock:
            submit_ts = self._submits.get(job_id)
            if submit_ts is None or job_id in self._first_noted:
                return
            self._first_noted.add(job_id)
        self.h_first_annotation.observe(max(0.0, time.time() - submit_ts))

    def observe_terminal(self, job_id: str, state: str,
                         submit_ts: float) -> None:
        """Scheduler seam: terminal outcome — close out the job."""
        self.h_e2e.observe(max(0.0, time.time() - submit_ts))
        with self._lock:
            self._submits.pop(job_id, None)
            self._first_noted.discard(job_id)

    def observe_read(self, seconds: float) -> None:
        """Read-path seam (service/readpath.py): one served read; sheds
        (429) are excluded: they are admission outcomes, not latency."""
        self.h_read.observe(max(0.0, seconds))

    def observe_stream_partial(self, seconds: float) -> None:
        """Streaming seam: one provisional re-rank became visible on the
        partial channel, ``seconds`` after the newest chunk it covers was
        committed to the acquisition manifest."""
        self.h_stream_partial.observe(max(0.0, seconds))

    # -------------------------------------------------------------- report
    def report(self) -> dict:
        """The ``GET /slo`` body: per-SLI objective, attainment computed
        from the live histogram, and error-budget burn (attained shortfall
        over the allowed shortfall; >= 1.0 means the budget is exhausted
        at the current rate)."""
        target = self.cfg.slo_target
        out = {"target": target, "slos": {}}
        for name, hist, objective_s in (
                ("queue_wait", self.h_queue_wait, self.cfg.slo_queue_wait_s),
                ("first_annotation", self.h_first_annotation,
                 self.cfg.slo_first_annotation_s),
                ("e2e", self.h_e2e, self.cfg.slo_e2e_s),
                ("read", self.h_read, self.cfg.slo_read_s),
                ("stream_partial", self.h_stream_partial,
                 self.cfg.slo_stream_partial_s)):
            attained, count = hist.fraction_below(objective_s)
            entry = {
                "objective_s": objective_s,
                "target": target,
                "count": count,
                "attainment": round(attained, 6) if count else None,
                "violations": (round((1.0 - attained) * count)
                               if count else 0),
                "error_budget_burn": (
                    round((1.0 - attained) / (1.0 - target), 4)
                    if count else None),
            }
            out["slos"][name] = entry
        return out
