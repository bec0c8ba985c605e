"""AnnotationService — the long-running serving composition.

Copy of ``sm_distributed_tpu/service/server.py`` for the port's modules.
Wires together the spool (``QueuePublisher`` for ``POST /submit``), the
``JobScheduler`` worker pool, the metrics registry (phase-timer observer +
residency collector + spool depth gauges), and the ``AdminAPI``, with
POSIX-graceful shutdown: SIGTERM/SIGINT stop admission, requeue
claimed-but-unstarted messages, drain running jobs, then stop the API —
``running/`` is empty on a clean exit, so a restart resumes exactly the
pending backlog.  The device pool has one chip per visible CUDA device for
a ``torch_cuda`` service on the card (none there raises), one for
``numpy_ref`` or ``device="cpu"``.  The stream ingest, the read path and
the device profiler (``GET /debug/profile``) are wired as in the JAX
package.  Its locks are watched by the lock-order detector
(``analysis/lockorder.py``) when the caller enables it before building the
service, as the drivers do under ``SM_LOCK_ORDER``; its recovery paths
(crash requeues, fenced takeovers, drains, the disk governor) are driven
by the port's drivers (``sm_distributed_tpu_torch.drivers``:
``chaos_sweep``, ``replica_chaos``, ``resource_smoke``, ``trace_smoke``,
``fleet_smoke``).  The kernel-build primer (``service/primer.py``) primes
the recorded bucket specs while the spool sits idle, the build census
(``kernels/_build.py``) is exported under ``telemetry.retrace``, and the
fleet view serves ``/fleet/*``, as the JAX package's primer, retrace
census and fleet view do; ``serve --fleet`` runs the fleet controller
(``service/fleet.py``) beside this service.
"""

from __future__ import annotations

import signal
import threading
import time
from pathlib import Path

from ..engine.daemon import QUEUE_ANNOTATE, QueuePublisher, _STATES
from ..models import faults, oom
from ..models.breaker import attach_metrics as attach_breaker_metrics
from ..models.breaker import get_device_breaker
from ..utils import tracing
from ..utils.config import SMConfig
from ..utils.failpoints import attach_metrics as attach_failpoint_metrics
from ..utils.logger import add_phase_observer, logger, remove_phase_observer
from .admission import AdmissionController
from .api import AdminAPI
from .device_pool import DevicePool, resolve_pool_size
from .fleetview import DeviceProfiler, FleetView
from .metrics import MetricsRegistry, build_info_collector, process_collector
from .resources import ResourceGovernor, set_governor
from .scheduler import JobScheduler
from .telemetry import DeviceMonitor, SLOTracker


def kernel_launches() -> dict[str, int]:
    """Each kernel wrapper's launch count in this process, by kernel (one a
    launch of its kernel on the card, none on the CPU)."""
    from ..ops.chaos import chaos_count_sums, chaos_count_sums_strips
    from ..ops.moments import batch_moments
    from ..ops.score import fused_window_moments

    return {"moments": batch_moments.launches,
            "chaos": chaos_count_sums.launches,
            "chaos_tiles": chaos_count_sums.tiled_launches,
            "chaos_strips": chaos_count_sums_strips.launches,
            "fused_window_moments": fused_window_moments.launches}


def _collect_launches(m: MetricsRegistry) -> None:
    """``sm_kernel_launches_total{kernel=}``: :func:`kernel_launches`."""
    family = m.counter("sm_kernel_launches_total",
                       "Hand-written kernel launches in this process, by "
                       "kernel", ("kernel",))
    for kernel, n in kernel_launches().items():
        c = family.labels(kernel=kernel)
        # counters only move forward: a delta from the wrapper's count
        c.inc(max(0.0, n - c.value))


class AnnotationService:
    def __init__(
        self,
        queue_dir: str | Path,
        callback,
        sm_config: SMConfig | None = None,
        queue: str = QUEUE_ANNOTATE,
        residency=None,
        with_api: bool = True,
    ):
        self.sm_config = sm_config or SMConfig.get_conf()
        cfg = self.sm_config.service
        self.queue_dir = Path(queue_dir)
        self.queue = queue
        self.metrics = MetricsRegistry()
        self.publisher = QueuePublisher(queue_dir, queue=queue)
        # end-to-end tracing: per-job JSONL
        # files + the flight-recorder ring behind /jobs/<id>/trace and
        # /debug/events.  tracing.enabled=false keeps only the no-op stubs.
        tracing.configure(enabled=self.sm_config.tracing.enabled,
                          ring_size=self.sm_config.tracing.ring_size)
        self.trace_dir = (self.sm_config.trace_dir
                          if self.sm_config.tracing.enabled else None)
        # replica identity: stamped on every trace record and
        # telemetry sample this process emits
        tracing.set_replica(cfg.replica_id)
        # overload protection in front of /submit: bounded depth, per-tenant
        # quotas, EWMA latency shedding (service/admission.py); the
        # scheduler feeds terminal outcomes + attempt latency back into it.
        # State is replica-local; the spool re-adoption and the peer view
        # are wired after the scheduler exists (it owns the shard map).
        self.admission = AdmissionController(cfg.admission, metrics=self.metrics)
        # SLO instrumentation (service/telemetry.py): queue-wait / first-
        # annotation / e2e histograms recorded at the scheduler's seams,
        # attainment served by GET /slo
        self.slo = SLOTracker(self.metrics, self.sm_config.telemetry)
        # device pool: resolved against the configured backend and device
        # so a torch_cuda service on the card leases out every visible
        # chip, while numpy_ref or device="cpu" keeps a 1-chip pool
        pool_size = resolve_pool_size(cfg, backend=self.sm_config.backend,
                                      device=self.sm_config.device)
        # per-chip health (service/health.py): quarantined chips
        # leave placement, lease-time probes fence dead chips before a job
        # touches them, half-open re-probes readmit recovered ones —
        # surfaced on GET /debug/devices and sm_device_* metrics
        from .health import HealthTracker

        self.device_pool = DevicePool(
            pool_size,
            max_bypass=cfg.device_pool_max_bypass,
            hosts=cfg.device_pool_hosts,
            health=HealthTracker.from_config(
                pool_size, cfg, hosts=cfg.device_pool_hosts))
        self.device_pool.attach_metrics(self.metrics)
        # resource governor (service/resources.py): disk-budget
        # preflight at every governed write seam, degrade order traces →
        # cache → 507 submits, bounded-retention GC run from the
        # scheduler's replica loop.  Installed as the process singleton so
        # the engine seams (checkpoints, results, publish, cache shards)
        # and the admission controller consult it without plumbing;
        # tracing's file gate makes trace appends the FIRST thing dropped.
        read_cache_dir = Path(self.sm_config.work_dir) / "read_cache"
        from ..engine.stream import StreamIngest, stream_root

        stream_dir = stream_root(self.sm_config)
        self.resources = ResourceGovernor(
            self.sm_config.resources,
            work_dir=self.sm_config.work_dir,
            results_dir=self.sm_config.storage.results_dir,
            queue_root=self.queue_dir / queue,
            trace_dir=self.trace_dir,
            cache_dir=Path(self.sm_config.work_dir) / "isocalc_cache",
            tracing_cfg=self.sm_config.tracing,
            metrics=self.metrics, replica_id=cfg.replica_id,
            read_cache_dir=read_cache_dir,
            read_cache_max_bytes=cfg.read.cache_disk_max_bytes,
            stream_dir=stream_dir,
            stream_retention_age_s=cfg.stream.retention_age_s,
            stream_idle_timeout_s=cfg.stream.idle_timeout_s)
        set_governor(self.resources)
        tracing.set_file_gate(self.resources.trace_gate)
        # live-acquisition ingest (engine/stream.py): the HTTP chunk seam
        # (POST /datasets/<id>/pixels|finish) appends into the crash-safe
        # chunk log that StreamSearchJob re-scores from; a shared work_dir
        # means any replica can serve appends for any acquisition
        self.stream_ingest = StreamIngest(stream_dir, metrics=self.metrics)
        # result read path (service/readpath.py): governed LRU + segment
        # reader + tile renderer behind the GET endpoints; cache fills
        # consult the governor's no-read-cache degrade level
        from .readpath import ReadPath

        self.readpath = ReadPath(
            self.sm_config.storage.results_dir, cfg.read,
            governor=self.resources, metrics=self.metrics, slo=self.slo,
            disk_dir=read_cache_dir) if cfg.read.enabled else None
        # device-OOM adaptive-scoring telemetry (models/oom.py): events,
        # converged backoffs, and the learned safe batch on /metrics
        oom.attach_metrics(self.metrics)
        # classified device-fault telemetry (models/faults.py):
        # sm_device_faults_total{kind=} beside the oom/breaker families
        faults.attach_metrics(self.metrics)
        # kernel-build attribution: every nvcc build and every load of a
        # library built before, by kernel (sm_compile_* on /metrics, read
        # from the process's build census at scrape time) — the port's
        # counterpart of the JAX package's retrace census
        if self.sm_config.telemetry.retrace:
            from ..kernels import _build

            self.metrics.add_collector(_build.collect_census)
        # each hand-written kernel's launches in this process, read from
        # its wrapper's count at scrape time
        self.metrics.add_collector(_collect_launches)
        self.scheduler = JobScheduler(
            queue_dir, callback, config=cfg, queue=queue, metrics=self.metrics,
            admission=self.admission, trace_dir=self.trace_dir, slo=self.slo,
            device_pool=self.device_pool, resources=self.resources)
        # replica-scoped spool re-adoption + the registry-backed peer view:
        # each replica tracks its own shards and folds the peers' gossiped
        # summaries into its quota/shed decisions (GET /peers serves both)
        self.admission.sync_from_spool(self.queue_dir / queue,
                                       owns_msg=self.scheduler.owns_msg)
        self.admission.set_peer_view(self.scheduler.peer_admission_summaries)
        # the kernel-build primer (service/primer.py): when the spool sits
        # idle, build, load and set up the kernels of the recorded bucket
        # specs so a cold submit pays no nvcc.  Constructed even when
        # disabled — GET /debug/compile serves its primed-vs-missing view
        # either way; only the idle thread is gated on the knob.
        from .primer import CachePrimer

        self.primer = CachePrimer(
            self.sm_config, busy=self._primer_busy, metrics=self.metrics)
        # device & memory telemetry: memory/occupancy/kernel-cache sampler
        # feeding gauges + the GET /debug/timeseries snapshot ring
        from ..kernels._build import build_dir_for

        self.telemetry = DeviceMonitor(
            self.metrics, self.sm_config.telemetry,
            device_pool=self.device_pool,
            queue_root=self.queue_dir / queue,
            compile_cache_dir=build_dir_for(self.sm_config),
            replica_id=cfg.replica_id,
            readpath=self.readpath, stream_ingest=self.stream_ingest)
        # device-backend circuit breaker: configure the process singleton
        # from THIS service's knobs and export its state on /metrics
        get_device_breaker(cfg)
        attach_breaker_metrics(self.metrics)
        self.residency = residency
        self.started_at = time.time()
        self._stop_requested = threading.Event()
        self._shutdown_done = threading.Event()
        self._shutdown_once = threading.Lock()
        self._phase_hist = self.metrics.histogram(
            "sm_phase_seconds", "Pipeline phase wall clock by phase name",
            ("phase",))
        # chaos observability: sm_failpoints_injected_total{name=} and
        # sm_recovery_events_total{event=} surface on /metrics
        attach_failpoint_metrics(self.metrics)
        # isocalc cold-path observability: pattern counter +
        # per-generation worker/rate gauges, plus a scrape-window rate
        from ..ops import isocalc as isocalc_mod
        from .metrics import rate_collector

        isocalc_mod.attach_metrics(self.metrics)
        rate_collector(self.metrics, "sm_isocalc_patterns_scrape_rate_per_s",
                       "Isotope patterns computed per second, over the "
                       "window since the previous scrape",
                       isocalc_mod.patterns_total)
        # build identity + process health: dashboards need a
        # version/backend join key and leak-spotting gauges (RSS, threads,
        # FDs)
        build_info_collector(self.metrics, backend=self.sm_config.backend)
        process_collector(self.metrics)
        if residency is not None:
            self.metrics.add_collector(self._collect_residency)
        self.api = AdminAPI(self, host=cfg.http_host,
                            port=cfg.http_port) if with_api else None
        # the fleet view (/fleet/* across live replicas) and GET
        # /debug/profile (an on-demand torch.profiler capture around the
        # jobs in flight).  The admin address, pool occupancy and in-flight
        # stream count are gossiped through registry heartbeats so peers
        # can scrape this replica without another channel — the API binds
        # its socket in __init__, so the address is final here
        self.fleetview = (FleetView(self, cfg.fleetview)
                          if cfg.fleetview.enabled and with_api else None)
        self.profiler = DeviceProfiler(self, self.sm_config.telemetry.profile)
        if self.api is not None:
            self.scheduler.add_gossip(
                "admin", lambda: "%s:%d" % self.api.address)
        self.scheduler.add_gossip("pool", self._gossip_pool)
        self.scheduler.add_gossip("streams_in_flight",
                                  self.stream_ingest.in_flight)

    def _gossip_pool(self) -> dict:
        """The heartbeat-sized pool summary peers read (the full per-chip
        view stays on this replica's /debug/devices)."""
        snap = self.device_pool.snapshot()
        return {"size": snap["size"], "in_use": snap["in_use"],
                "waiters": snap["waiters"]}

    # -------------------------------------------------------------- metrics
    def _observe_phase(self, phase: str, seconds: float) -> None:
        self._phase_hist.labels(phase=phase).observe(seconds)

    def _collect_residency(self, m: MetricsRegistry) -> None:
        """Scrape-time pull of ``DatasetResidency.stats`` into counters
        (the stats ARE cumulative, so exposing their current value under a
        counter type is faithful)."""
        stats = self.residency.stats
        hits = m.counter("sm_residency_hits_total",
                         "Residency cache hits", ("cache",))
        misses = m.counter("sm_residency_misses_total",
                           "Residency cache misses", ("cache",))
        for cache in ("dataset", "backend"):
            h = hits.labels(cache=cache)
            miss = misses.labels(cache=cache)
            # counters only move forward; set via delta from the live stats
            h.inc(max(0.0, stats[f"{cache}_hits"] - h.value))
            miss.inc(max(0.0, stats[f"{cache}_misses"] - miss.value))

    def _primer_busy(self) -> bool:
        """Real work in flight?  The primer only runs while this is False
        (and re-checks between specs), so priming never delays a job."""
        if self.scheduler.live_claims() > 0:
            return True
        root = self.queue_dir / self.queue
        return any(True for _ in root.glob("pending/*.json")) or \
            any(True for _ in root.glob("running/*.json"))

    def queue_depths(self) -> dict:
        root = self.queue_dir / self.queue
        return {s: len(list(root.glob(f"{s}/*.json"))) for s in _STATES}

    def stopping(self) -> bool:
        """True once shutdown began — /submit sheds with 503 from here on."""
        return self._stop_requested.is_set()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        add_phase_observer(self._observe_phase)
        # first-annotation SLI: msm_basic notifies once per search when the
        # first checkpoint group's metrics land (producer-side observer
        # list, same pattern as phase observers)
        from ..models.msm_basic import add_first_annotation_observer

        add_first_annotation_observer(self.slo.note_first_annotation)
        if self.sm_config.telemetry.enabled:
            self.telemetry.start()
        self.scheduler.start()
        if self.api is not None:
            self.api.start()
        if self.sm_config.service.prime.enabled:
            self.primer.start()
        logger.info("service: up (queue=%s)", self.queue_dir / self.queue)

    def shutdown(self, timeout_s: float | None = None) -> bool:
        """Drain and stop everything; safe to call more than once.  A
        concurrent caller BLOCKS until the in-flight drain finishes —
        otherwise the main thread (run_forever's finally) can exit the
        process while the signal-drain thread is still mid-retire,
        leaving registry/heartbeat debris behind (a retired
        replica must leave nothing)."""
        with self._shutdown_once:
            if self._stop_requested.is_set():
                first = False
            else:
                self._stop_requested.set()
                first = True
        if not first:
            self._shutdown_done.wait(
                timeout=(timeout_s if timeout_s is not None else
                         self.sm_config.service.drain_timeout_s) + 10.0)
            return True
        logger.info("service: shutdown requested — draining")
        self.primer.stop()
        ok = self.scheduler.shutdown(timeout_s)
        if self.api is not None:
            self.api.stop()
        self.telemetry.stop()
        from ..models.msm_basic import remove_first_annotation_observer

        remove_first_annotation_observer(self.slo.note_first_annotation)
        remove_phase_observer(self._observe_phase)
        # detach the resource governor so a later service (tests run many
        # per process) starts from its own budget, not this one's
        from .resources import get_governor

        if get_governor() is self.resources:
            tracing.set_file_gate(None)
            set_governor(None)
        self._shutdown_done.set()
        return ok

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT → graceful drain.  Only valid in the main thread."""

        def _handler(signum, frame):
            logger.info("service: received signal %d", signum)
            # handler must return fast; the drain happens in a helper thread
            threading.Thread(target=self.shutdown, daemon=True,
                             name="signal-drain").start()

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)

    def run_forever(self, max_terminal: int | None = None,
                    idle_timeout_s: float | None = None) -> int:
        """Block until shutdown (signal or programmatic).  ``max_terminal``
        stops after N jobs reach a terminal state (smoke tests);
        ``idle_timeout_s`` stops after the spool stays empty that long."""
        idle_since = None
        try:
            while not self._stop_requested.is_set():
                if self.scheduler.drain_complete():
                    # zero-loss drain: the replica acked — every
                    # claim resolved, nothing more will be written; exit so
                    # the controller can count the drain done
                    logger.info("service: drain acked — retiring")
                    break
                if max_terminal is not None and \
                        self.scheduler._terminal_count >= max_terminal:
                    break
                if idle_timeout_s is not None:
                    depths = self.queue_depths()
                    busy = depths["pending"] or depths["running"]
                    if busy:
                        idle_since = None
                    elif idle_since is None:
                        idle_since = time.time()
                    elif time.time() - idle_since >= idle_timeout_s:
                        break
                time.sleep(0.1)
        finally:
            self.shutdown()
        return 0
