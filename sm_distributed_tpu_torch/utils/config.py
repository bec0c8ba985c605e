"""Configuration of the PyTorch port.

A port of ``sm_distributed_tpu/utils/config.py``: the per-dataset
``DSConfig`` (database, isotope_generation, image_generation) with the same
keys and defaults, and the engine's ``SMConfig`` with ``backend``
(``torch_cuda``, the default, or the host oracle ``numpy_ref``),
``device``, ``fdr``, the ``parallel`` knobs the scoring and isotope-pattern
paths read (``resident_datasets`` included), the ``service`` block of the
annotation service (scheduler, device pool and health, replicas and leases,
admission, breaker), ``telemetry``, ``resources``, ``storage``, ``tracing``
(its retention knobs included), ``logs``, ``work_dir``, ``logs_dir`` and
``failpoints``, and the process-global instance of ``set_path`` /
``get_conf``.  ``from_dict`` rejects unknown keys, as the JAX package does.

The ``service`` blocks ``fleet`` (the elastic replica fleet), ``prime``
(the kernel-build primer) and ``fleetview`` (the ``/fleet/*`` view,
enabled by default), the ``read`` block (the read path) and the ``stream``
block (live acquisition ingest) take every value the JAX package does, as
does ``telemetry.retrace`` (the kernel-build census behind ``GET
/debug/compile`` and the ``sm_compile_*`` families).
``parallel.compile_cache_dir`` names where the port's kernels are built:
``""`` (the default) keeps ``build/torch_kernels`` at the repository root,
a path moves the builds and the primer's two manifests there; the JAX
package's ``"off"`` (no persistent XLA cache) has no meaning for a port
that must build its kernels somewhere, and raises.
The mesh and multi-process knobs
(``parallel.pixels_axis``, ``formulas_axis``, ``coordinator_address``,
``num_processes``, ``process_id``, ``init_retries``, ``init_backoff_s``)
and ``service.devices_per_job`` above 1 take every value the JAX package
does (``parallel/``).
``telemetry.profile`` (``GET /debug/profile`` through ``torch.profiler``)
and ``parallel.isocalc_device`` ("on": isotope patterns blurred and
centroided on the search's device) take every value the JAX package does.
``peak_compaction`` and ``band_slice`` take every value the JAX package
does: ``"auto"`` lets the backend pick the plain, band or compact variant
for each batch by its estimated cost on the card, ``"on"`` forces one (band
first), ``"off"`` leaves it out; the variants give the same bits.
``do_preprocessing`` (hot-spot clipping), ``checkpoint_every`` (search
checkpoint groups) and ``cube_dtype`` (a bf16 or int8 resident intensity
cube on the flat path) take every value the JAX package accepts.  The
service drivers (``sm_distributed_tpu_torch.drivers``) and the lock-order
detector (``SM_LOCK_ORDER``) read nothing beyond these keys.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, ClassVar

VALID_BACKENDS = ("numpy_ref", "torch_cuda")


def _from_dict(cls, d: dict[str, Any]):
    """Build a dataclass from a dict, recursing into dataclass fields and
    rejecting unknown keys.  Keys starting with "__" are comments."""
    d = {k: v for k, v in d.items() if not k.startswith("__")}
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown {cls.__name__} config keys: {sorted(unknown)}")
    kwargs = {}
    for key, val in d.items():
        target = _DATACLASS_FIELDS.get((cls.__name__, key))
        if target is not None and isinstance(val, dict):
            kwargs[key] = _from_dict(target, val)
        elif isinstance(val, list):
            kwargs[key] = tuple(val)
        else:
            kwargs[key] = val
    return cls(**kwargs)


@dataclass(frozen=True)
class IsotopeGenerationConfig:
    """ds_config['isotope_generation']."""
    adducts: tuple[str, ...] = ("+H", "+Na", "+K")
    charge: int = 1
    isocalc_sigma: float = 0.01
    isocalc_pts_per_mz: int = 10000
    n_peaks: int = 4

    def __post_init__(self):
        if self.charge == 0:
            raise ValueError("isotope_generation.charge must be nonzero")
        if self.isocalc_sigma <= 0 or self.isocalc_pts_per_mz <= 0 or self.n_peaks <= 0:
            raise ValueError("isotope_generation: sigma/pts_per_mz/n_peaks must be positive")


@dataclass(frozen=True)
class ImageGenerationConfig:
    """ds_config['image_generation']."""
    ppm: float = 3.0
    nlevels: int = 30
    do_preprocessing: bool = False
    q: float = 99.0

    def __post_init__(self):
        if self.ppm <= 0 or self.nlevels <= 0 or not (0 < self.q <= 100):
            raise ValueError("image_generation: ppm/nlevels/q out of range")


@dataclass(frozen=True)
class DatabaseConfig:
    """ds_config['database']."""
    name: str = "HMDB"
    version: str = "2016"


@dataclass(frozen=True)
class DSConfig:
    """Per-dataset config (ds_config.json)."""
    database: DatabaseConfig = field(default_factory=DatabaseConfig)
    isotope_generation: IsotopeGenerationConfig = field(
        default_factory=IsotopeGenerationConfig)
    image_generation: ImageGenerationConfig = field(
        default_factory=ImageGenerationConfig)

    @staticmethod
    def load(path: str | Path) -> "DSConfig":
        return _from_dict(DSConfig, json.loads(Path(path).read_text()))

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "DSConfig":
        return _from_dict(DSConfig, d)


@dataclass(frozen=True)
class FDRConfig:
    """sm_config['fdr']: decoy sampling is seeded."""
    decoy_sample_size: int = 20
    seed: int = 42


@dataclass(frozen=True)
class ParallelConfig:
    """The ``parallel`` knobs the scoring and isotope-pattern paths read
    (same names and defaults as the JAX package).  ``mz_chunk > 0`` takes
    the m/z-chunked cube path; ``fused_metrics="on"`` takes the fused
    window-moments kernel on the flat path (not with hot-spot clipping),
    while ``"auto"`` and ``"off"`` keep the unfused chain, whose variant
    ``peak_compaction`` and ``band_slice`` choose.  ``cube_dtype`` ("bf16",
    "int8") keeps the flat path's resident intensities compact, expanded
    to f32 per batch where the batch reads them; the cube path
    (``mz_chunk > 0``) stays f32.  ``checkpoint_every > 0`` groups batches
    into checkpoint groups of that many (the leading group one batch) when
    the search has a checkpoint directory.  ``isocalc_workers`` (0 = all
    cores) and ``isocalc_chunk`` (0 = the default chunk of 2048 pairs) size
    the isotope-pattern pool and its cache shards; ``overlap_isocalc``
    starts pattern generation before the input is staged (``SearchJob``)
    and, on the ``numpy_ref`` backend, scores batches as their patterns
    land.  ``resident_datasets`` is how many parsed datasets and set-up
    backends the service keeps resident across jobs (LRU, 0 disables:
    ``engine/residency.py``).  ``pixels_axis`` and ``formulas_axis`` shape
    the ("pixels", "formulas") mesh a search shards over (-1: every device
    left over; ``parallel/mesh.py``); ``coordinator_address``,
    ``num_processes``, ``process_id``, ``init_retries`` and
    ``init_backoff_s`` configure the multi-process runtime
    (``parallel/distributed.py``; the env variables ``SM_COORDINATOR``,
    ``SM_NUM_PROCESSES`` and ``SM_PROCESS_ID`` override the first
    three).  ``compile_cache_dir`` is where the kernels are built
    (``kernels/_build.py``)."""
    pixels_axis: int = -1
    formulas_axis: int = 1
    formula_batch: int = 2048
    mz_chunk: int = 0
    peak_compaction: str = "auto"
    order_ions: str = "auto"
    band_slice: str = "auto"
    shape_buckets: str = "auto"
    cube_dtype: str = "f32"
    fused_metrics: str = "auto"
    checkpoint_every: int = 0
    isocalc_workers: int = 0
    isocalc_chunk: int = 0
    isocalc_device: str = "off"
    overlap_isocalc: str = "auto"
    resident_datasets: int = 2
    coordinator_address: str = ""        # "" = single-process (no-op init)
    num_processes: int = 1
    process_id: int = -1                 # -1 = resolve from env/launcher
    init_retries: int = 5                # attempts after the first
    init_backoff_s: float = 1.0          # first retry delay; doubles
    # where the kernels are built: "" = build/torch_kernels at the
    # repository root, anything else = that directory (the primer's bucket
    # and prime manifests live beside the builds)
    compile_cache_dir: str = ""

    def __post_init__(self):
        if self.compile_cache_dir == "off":
            raise ValueError(
                "parallel.compile_cache_dir='off' would mean no kernel "
                "build directory: the JAX package's 'off' turns its "
                "persistent XLA cache off, but the port builds its CUDA "
                "kernels with nvcc on first use and keeps them somewhere; "
                "give '' (build/torch_kernels) or a directory")
        for axis in ("pixels_axis", "formulas_axis"):
            if getattr(self, axis) < -1 or getattr(self, axis) == 0:
                raise ValueError(
                    "mesh axis sizes must be -1 or positive, got "
                    f"pixels_axis={self.pixels_axis}, "
                    f"formulas_axis={self.formulas_axis}")
        for knob, valid in (("order_ions", ("auto", "mz", "table")),
                            ("band_slice", ("auto", "on", "off")),
                            ("peak_compaction", ("auto", "on", "off")),
                            ("shape_buckets", ("auto", "on", "off")),
                            ("cube_dtype", ("f32", "bf16", "int8")),
                            ("fused_metrics", ("auto", "on", "off")),
                            ("isocalc_device", ("on", "off")),
                            ("overlap_isocalc", ("auto", "on", "off"))):
            v = getattr(self, knob)
            if v not in valid:
                raise ValueError(
                    f"parallel.{knob} must be one of {valid}, got {v!r}")
        if self.formula_batch <= 0 or self.isocalc_workers < 0 \
                or self.isocalc_chunk < 0 or self.checkpoint_every < 0 \
                or self.resident_datasets < 0:
            raise ValueError("parallel: formula_batch must be positive and "
                             "isocalc_workers, isocalc_chunk, "
                             "checkpoint_every and resident_datasets >= 0")


@dataclass(frozen=True)
class AdmissionConfig:
    """Overload protection for ``POST /submit``.  A shed submit gets a structured 429/503 with a
    ``Retry-After`` header instead of joining an unbounded backlog."""
    max_queue_depth: int = 512           # admitted-but-not-terminal bound
                                         # across all tenants; 0 = unlimited
    max_tenant_inflight: int = 128       # per-tenant admitted-but-not-
                                         # terminal bound; 0 = unlimited
    ewma_alpha: float = 0.2              # weight of the newest job latency
    latency_shed_s: float = 0.0          # EWMA job latency that starts
                                         # shedding (503); 0 disables
    latency_resume_s: float = 0.0        # hysteresis floor: resume accepting
                                         # below this (0 = 0.75 * shed)
    retry_after_s: float = 1.0           # Retry-After hint on shed responses

    def __post_init__(self):
        if self.max_queue_depth < 0 or self.max_tenant_inflight < 0:
            raise ValueError("admission: depth/quota bounds must be >= 0")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("admission: ewma_alpha must be in (0, 1]")
        if self.latency_shed_s < 0 or self.latency_resume_s < 0:
            raise ValueError("admission: latency thresholds must be >= 0")
        if self.retry_after_s < 0:
            raise ValueError("admission: retry_after_s must be >= 0")

    @property
    def effective_resume_s(self) -> float:
        return self.latency_resume_s or 0.75 * self.latency_shed_s



@dataclass(frozen=True)
class ReadPathConfig:
    """Result read path (``service/readpath.py``): the queryable annotation
    index, the ion-image tile service and the governed LRU cache behind the
    ``GET /datasets*`` and ``/annotations`` endpoints, the JAX package's
    knobs and defaults.  Reads shed independently of writes: more than
    ``max_concurrent`` in-flight reads get a structured 429 + Retry-After,
    and cache fills stop (reads still answer from the source segments) when
    the disk governor degrades past the read-cache floor."""
    enabled: bool = True                 # serve the read endpoints
    cache_max_bytes: int = 64 << 20      # in-memory LRU result/tile cache
                                         # byte cap (0 disables caching)
    cache_max_entries: int = 1024        # ... entry cap
    cache_disk_max_bytes: int = 128 << 20  # on-disk tile cache byte cap
                                         # under <work_dir>/read_cache
                                         # (0 disables the disk tier)
    max_concurrent: int = 32             # in-flight read bound; excess reads
                                         # shed with 429 (0 = unlimited)
    retry_after_s: float = 1.0           # Retry-After hint on shed reads
    page_size: int = 100                 # default annotations page length
    page_size_max: int = 1000            # hard cap on ?limit=

    def __post_init__(self):
        if min(self.cache_max_bytes, self.cache_max_entries,
               self.cache_disk_max_bytes, self.max_concurrent) < 0:
            raise ValueError("read: cache/concurrency bounds must be >= 0")
        if self.retry_after_s < 0:
            raise ValueError("read: retry_after_s must be >= 0")
        if not 0 < self.page_size <= self.page_size_max:
            raise ValueError(
                "read: need 0 < page_size <= page_size_max")


@dataclass(frozen=True)
class StreamConfig:
    """Live-acquisition streaming ingest (``engine/stream.py``): ``mode:
    "stream"`` submits, ``POST /datasets/<id>/pixels`` chunk appends into
    the crash-safe chunk log, provisional re-scores as coverage grows, and
    batch-identical convergence at ``POST /datasets/<id>/finish``; the JAX
    package's knobs and defaults."""
    idle_timeout_s: float = 300.0        # cancel an acquisition when no NEW
                                         # chunk commits for this long (stream
                                         # jobs are exempt from the submit's
                                         # absolute deadline); 0 waits forever
    poll_interval_s: float = 0.25        # stream attempt's manifest poll
                                         # cadence while waiting for chunks
    rescore_min_chunks: int = 1          # provisional re-scores run only
                                         # when at least this many NEW chunks
                                         # committed since the last one
    retention_age_s: float = 3600.0      # finished chunk logs idle past
                                         # this are removed by the governor's
                                         # GC sweep; abandoned (never
                                         # finished) logs after
                                         # retention_age_s + idle_timeout_s
                                         # idle (0 = keep forever)

    def __post_init__(self):
        if self.idle_timeout_s < 0 or self.retention_age_s < 0:
            raise ValueError(
                "stream: idle_timeout_s/retention_age_s must be >= 0")
        if self.poll_interval_s <= 0 or self.rescore_min_chunks < 1:
            raise ValueError("stream: poll_interval_s must be positive and "
                             "rescore_min_chunks >= 1")


@dataclass(frozen=True)
class FleetConfig:
    """Elastic replica fleet (``service/fleet.py``), the JAX package's knobs
    and defaults.  A FleetController supervises replica subprocesses and
    makes hysteresis-damped scale decisions between ``min_replicas`` and
    ``max_replicas`` from the live signals the service already exports:
    ``/slo`` error-budget burn, admission queue depth, and device-pool
    occupancy.  Scale-down is a zero-loss *drain*: the victim stops
    claiming, finishes or releases in-flight work, acks, and retires —
    rendezvous hashing re-owns its shards and fenced leases make the
    handoff safe by construction."""
    enabled: bool = False                # serve --fleet (or this knob) runs
                                         # the controller beside replica r0
    min_replicas: int = 1                # repair floor (crash replacement
                                         # bypasses hysteresis + cooldown)
    max_replicas: int = 4                # scale ceiling
    decide_interval_s: float = 5.0       # controller decision cadence
    cooldown_s: float = 60.0             # min gap between scale events, so
                                         # flapping traffic can't thrash
    hysteresis_ticks: int = 2            # consecutive decide ticks a signal
                                         # must hold before acting
    scale_up_burn: float = 1.0           # worst /slo error-budget burn at or
                                         # above this is scale-up pressure
    scale_down_burn: float = 0.5         # burn must be at or below this for
                                         # scale-down relief
    queue_high_per_replica: float = 8.0  # pending depth / alive replicas at
                                         # or above this is pressure
    queue_low_per_replica: float = 1.0   # ... at or below this is relief
    occupancy_high: float = 0.95         # pool occupancy at or above this is
                                         # pressure (0 disables the signal)
    spawn_timeout_s: float = 30.0        # a spawned replica must register a
                                         # heartbeat within this or count as
                                         # a failed spawn
    drain_timeout_s: float = 120.0       # drain ack + process exit deadline
                                         # before the victim is force-killed

    def __post_init__(self):
        if self.min_replicas <= 0 or self.max_replicas < self.min_replicas:
            raise ValueError("fleet: need 1 <= min_replicas <= max_replicas")
        if self.decide_interval_s <= 0 or self.cooldown_s < 0 or \
                self.hysteresis_ticks < 1:
            raise ValueError("fleet: decide_interval_s must be positive, "
                             "cooldown_s >= 0, hysteresis_ticks >= 1")
        if self.scale_up_burn <= 0 or self.scale_down_burn < 0 or \
                self.scale_down_burn > self.scale_up_burn:
            raise ValueError("fleet: need 0 <= scale_down_burn <= "
                             "scale_up_burn")
        if self.queue_high_per_replica <= 0 or \
                self.queue_low_per_replica < 0 or \
                self.queue_low_per_replica > self.queue_high_per_replica:
            raise ValueError("fleet: need 0 <= queue_low_per_replica <= "
                             "queue_high_per_replica")
        if not 0.0 <= self.occupancy_high <= 1.0:
            raise ValueError("fleet: occupancy_high must be in [0, 1]")
        if self.spawn_timeout_s <= 0 or self.drain_timeout_s <= 0:
            raise ValueError("fleet: spawn/drain timeouts must be positive")


@dataclass(frozen=True)
class PrimeConfig:
    """The kernel-build primer (``service/primer.py``), the JAX package's
    knobs and defaults: a scheduler-idle background thread builds, loads
    and sets up on the device the kernels of every recorded bucket spec,
    so a cold submit pays no ``nvcc``.  ``GET /debug/compile`` reports
    primed vs missing specs; ``drivers/prime_cache.py`` is the offline
    equivalent."""

    enabled: bool = False                # start the idle primer thread
    idle_after_s: float = 5.0            # spool must be idle this long
                                         # before a prime cycle starts
    interval_s: float = 30.0             # rescan cadence for new bucket
                                         # specs once everything known is
                                         # primed
    max_specs_per_cycle: int = 0         # prime at most N specs per idle
                                         # cycle (0 = no cap); the primer
                                         # re-checks idleness between specs
                                         # either way

    def __post_init__(self):
        if self.idle_after_s < 0 or self.interval_s <= 0:
            raise ValueError("prime: idle_after_s must be >= 0 and "
                             "interval_s positive")
        if self.max_specs_per_cycle < 0:
            raise ValueError("prime: max_specs_per_cycle must be >= 0")


@dataclass(frozen=True)
class FleetViewConfig:
    """The fleet view (``service/fleetview.py``), the JAX package's knobs and
    defaults: the serving replica scrapes live peers (admin addresses
    gossiped through registry heartbeats), merges their exposition, and
    answers ``GET /fleet/metrics|slo|status`` with a fleet-wide view that
    degrades to partial-with-evidence when a peer dies mid-scrape."""
    enabled: bool = True                 # serve the /fleet/* endpoints
    scrape_timeout_s: float = 2.0        # per-peer HTTP scrape budget; a
                                         # peer slower than this counts as a
                                         # scrape error, not a fleet 500
    cache_ttl_s: float = 1.0             # merged-view reuse window so N
                                         # dashboard readers cost one fleet
                                         # scrape (0 = scrape every request)

    def __post_init__(self):
        if self.scrape_timeout_s <= 0 or self.cache_ttl_s < 0:
            raise ValueError("fleetview: scrape_timeout_s must be positive "
                             "and cache_ttl_s >= 0")


@dataclass(frozen=True)
class ServiceConfig:
    """Annotation-service knobs (scheduler, failure policy, device pool and
    health, replicas, admin API, admission, breaker), the JAX package's,
    consumed by ``sm_distributed_tpu_torch.service`` (the ``serve`` CLI
    command).  A lease of ``devices_per_job`` (or a submit's ``devices``)
    chips above 1 scores on a mesh over them (``parallel/sharded.py``).
    ``read`` (the read path) and ``stream``
    (live-acquisition ingest), ``fleet`` (the elastic fleet), ``prime``
    (the kernel-build primer) and ``fleetview`` (the ``/fleet/*`` view) are
    the JAX package's blocks.  ``breaker_degraded_batch`` (the JAX package's
    numpy batch while the breaker is open) is accepted, validated and read
    nowhere: the port refuses a job on an open breaker instead of moving it
    to the host."""
    workers: int = 2                     # concurrent job slots (CPU phases
                                         # overlap; device phases run under
                                         # the job's device-pool lease)
    poll_interval_s: float = 0.5         # pending/ scan cadence when idle
    job_timeout_s: float = 21600.0       # per-attempt wall clock (6 h — the
                                         # 80k-formula DESI job is 32-67 min)
    max_attempts: int = 3                # attempts before dead-letter
    backoff_base_s: float = 1.0          # retry delay = base * 2^(n-1) ...
    backoff_max_s: float = 60.0          # ... capped here ...
    backoff_jitter: float = 0.1          # ... times 1 + U[0, jitter]
    heartbeat_interval_s: float = 5.0    # claim heartbeat touch cadence
    stale_after_s: float = 30.0          # claims with no heartbeat this old
                                         # are requeued by crash recovery
    drain_timeout_s: float = 30.0        # graceful-shutdown wait for running
    http_host: str = "127.0.0.1"         # admin API bind (healthz/metrics/
    http_port: int = 8685                # jobs/submit); port 0 = ephemeral
    # --- cooperative cancellation (utils/cancel.py) ---
    cancel_grace_s: float = 15.0         # after a cancel is delivered, how
                                         # long the worker waits for the
                                         # attempt thread to unwind before
                                         # declaring it abandoned
    watchdog_interval_s: float = 5.0     # stall-watchdog scan cadence
    watchdog_stall_s: float = 0.0        # cancel attempts whose progress
                                         # heartbeat is older than this;
                                         # 0 disables the watchdog
    # --- poison-job quarantine ---
    quarantine_after: int = 8            # claims without a terminal outcome
                                         # before a message moves to
                                         # quarantine/; 0 disables
    # --- device pool (service/device_pool.py) ---
    device_pool_size: int = 0            # chips the scheduler leases out;
                                         # 0 = auto (the visible CUDA
                                         # devices for torch_cuda on the
                                         # card, else 1)
    devices_per_job: int = 1             # chips a job claims by default; a
                                         # per-submit "devices" field
                                         # overrides.  1 = pack jobs onto
                                         # distinct chips; above 1 a mesh
    device_pool_max_bypass: int = 64     # grants that may jump a waiting
                                         # larger lease before it seals the
                                         # queue (anti-starvation for
                                         # sub-mesh jobs under small-job
                                         # traffic)
    device_pool_hosts: int = 1           # host dimension of the pool (a
                                         # host x chip topology, simulated
                                         # on the CPU): the
                                         # pool's chips split into this many
                                         # equal failure domains; 1-host
                                         # leases are preferred, a sub-mesh
                                         # lease may span hosts and reports
                                         # them (DeviceLease.hosts)
    lease_reap_after_s: float = 300.0    # an abandoned (zombie) attempt's
                                         # device lease is reclaimed when
                                         # its thread exits, or forcibly
                                         # after this TTL; 0 = wait for the
                                         # thread forever
    # --- per-chip device health (service/health.py) ---
    health_probe_on_lease: bool = True   # probe every granted chip with a
                                         # device round-trip before the job
                                         # touches it (a torch copy to and
                                         # from the card)
    health_fault_quarantine: int = 3     # consecutive transient /
                                         # unattributed-sticky strikes on a
                                         # chip before it is quarantined
                                         # (an attributed sticky fault
                                         # quarantines immediately)
    health_reprobe_after_s: float = 60.0 # quarantine -> half-open re-probe
                                         # cooldown; a passing re-probe
                                         # readmits the chip (0 = never
                                         # re-probe)
    health_host_evict_fraction: float = 0.75  # fraction of a host domain's
                                         # chips quarantined at which the
                                         # WHOLE host is evicted (>= 1.0
                                         # disables host eviction)
    # --- pod host watchdog (service/scheduler.py) ---
    host_watchdog_interval_s: float = 0.0  # cadence of the per-host process-
                                         # heartbeat scan; 0 disables the
                                         # watchdog (single-process pods)
    host_stale_after_s: float = 10.0     # a host whose EVERY process beat is
                                         # older than this is evicted: its
                                         # chips quarantine as one unit and
                                         # in-flight attempts on them cancel
                                         # into the normal retry path
    # --- multi-replica scheduling (service/leases.py) ---
    replica_id: str = "r0"               # this scheduler process's identity
                                         # (serve --replica-id); leases and
                                         # heartbeats carry it
    replicas: int = 1                    # expected replica count (serve
                                         # --replicas) — informational; the
                                         # LIVE set comes from heartbeats
    spool_shards: int = 8                # logical spool partitions; claims
                                         # filter by crc32(msg_id) % shards
                                         # and rendezvous-hash ownership
    replica_heartbeat_interval_s: float = 2.0   # registry beat cadence
    replica_stale_after_s: float = 8.0   # a peer whose beat is older drops
                                         # from the alive set (its shards
                                         # redistribute to survivors)
    takeover_interval_s: float = 2.0     # takeover/orphan scan cadence
    # --- device-backend circuit breaker (models/breaker.py) ---
    breaker_threshold: int = 3           # consecutive device errors → open
    breaker_cooldown_s: float = 30.0     # open → half-open probe delay
    breaker_degraded_batch: int = 512    # read nowhere (see above)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    prime: PrimeConfig = field(default_factory=PrimeConfig)
    read: ReadPathConfig = field(default_factory=ReadPathConfig)
    stream: StreamConfig = field(default_factory=StreamConfig)
    fleetview: FleetViewConfig = field(default_factory=FleetViewConfig)

    def __post_init__(self):
        if self.workers <= 0 or self.max_attempts <= 0:
            raise ValueError("service: workers/max_attempts must be positive")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0 or self.backoff_jitter < 0:
            raise ValueError("service: backoff knobs must be non-negative")
        if self.cancel_grace_s < 0 or self.watchdog_interval_s <= 0 or \
                self.watchdog_stall_s < 0 or self.quarantine_after < 0:
            raise ValueError("service: cancel/watchdog/quarantine knobs out of range")
        if self.breaker_threshold <= 0 or self.breaker_cooldown_s < 0 or \
                self.breaker_degraded_batch <= 0:
            raise ValueError("service: breaker knobs out of range")
        if self.device_pool_size < 0 or self.devices_per_job <= 0 or \
                self.device_pool_max_bypass < 0:
            raise ValueError("service: device-pool knobs out of range "
                             "(device_pool_size >= 0, devices_per_job >= 1, "
                             "device_pool_max_bypass >= 0)")
        if self.device_pool_hosts <= 0 or self.lease_reap_after_s < 0:
            raise ValueError("service: device_pool_hosts must be >= 1 and "
                             "lease_reap_after_s >= 0")
        if self.health_fault_quarantine < 1 or \
                self.health_reprobe_after_s < 0 or \
                not 0.0 < self.health_host_evict_fraction:
            raise ValueError(
                "service: health_fault_quarantine must be >= 1, "
                "health_reprobe_after_s >= 0, and "
                "health_host_evict_fraction > 0 (>= 1.0 disables eviction)")
        if self.host_watchdog_interval_s < 0 or self.host_stale_after_s <= 0:
            raise ValueError("service: host_watchdog_interval_s must be >= 0 "
                             "and host_stale_after_s positive")
        if not self.replica_id or self.replicas <= 0 or self.spool_shards <= 0:
            raise ValueError("service: replica_id must be non-empty and "
                             "replicas/spool_shards positive")
        if self.replica_heartbeat_interval_s <= 0 or \
                self.replica_stale_after_s <= 0 or \
                self.takeover_interval_s <= 0:
            raise ValueError("service: replica heartbeat/staleness/takeover "
                             "intervals must be positive")



@dataclass(frozen=True)
class ProfileConfig:
    """On-demand device profiling (``service/fleetview.py``): ``GET
    /debug/profile?seconds=`` runs a ``torch.profiler`` capture around
    in-flight work, attributes device time per kernel, and injects
    ``device_kernel`` spans into live job traces.  The JAX package's knobs
    and defaults."""
    enabled: bool = True                 # serve /debug/profile
    default_seconds: float = 2.0         # capture window when ?seconds= is
                                         # omitted
    max_seconds: float = 30.0            # hard cap on a requested window (a
                                         # profile holds the single-flight
                                         # slot for its whole duration)
    dir: str = ""                        # capture dir; "" = <work_dir>/profiles

    def __post_init__(self):
        if not 0 < self.default_seconds <= self.max_seconds:
            raise ValueError("profile: need 0 < default_seconds <= "
                             "max_seconds")


@dataclass(frozen=True)
class TelemetryConfig:
    """Quantitative telemetry (service/telemetry.py): the device-memory
    monitor + metric-snapshot time-series ring behind ``GET
    /debug/timeseries``, the SLO objectives ``GET /slo`` reports
    attainment/error-budget burn against, and the device profiler behind
    ``GET /debug/profile`` (``profile``).  ``retrace`` records the
    kernel-build census (``kernels/_build.py``: builds, loads and per-device
    launch set-ups) under the JAX package's ``sm_compile_*`` families, with
    the kernel as the ``site``."""
    enabled: bool = True                 # start the sampling thread
    sample_interval_s: float = 5.0       # device/occupancy sample cadence
    timeseries_len: int = 720            # snapshot ring capacity (1 h @ 5 s)
    # SLO objectives: latency threshold (seconds) + attainment target
    # (fraction of jobs that must land under the threshold)
    slo_queue_wait_s: float = 30.0       # submit -> first attempt start
    slo_first_annotation_s: float = 120.0  # submit -> first scored group
    slo_e2e_s: float = 600.0             # submit -> terminal outcome
    slo_read_s: float = 0.25             # read request -> response
    slo_stream_partial_s: float = 30.0   # stream chunk commit -> provisional
                                         # partial served
    slo_target: float = 0.99
    retrace: bool = True                 # kernel-build census: sm_compile_*
                                         # families + `compile` trace events
    profile: ProfileConfig = field(default_factory=ProfileConfig)

    def __post_init__(self):
        if self.sample_interval_s <= 0 or self.timeseries_len <= 0:
            raise ValueError(
                "telemetry: sample_interval_s/timeseries_len must be positive")
        if min(self.slo_queue_wait_s, self.slo_first_annotation_s,
               self.slo_e2e_s, self.slo_read_s,
               self.slo_stream_partial_s) <= 0:
            raise ValueError("telemetry: SLO thresholds must be positive")
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError("telemetry: slo_target must be in (0, 1)")


@dataclass(frozen=True)
class ResourcesConfig:
    """Resource-exhaustion survival (service/resources.py): disk-budget
    governor + bounded-retention GC.
    The governor preflights every governed write seam and degrades in a
    configured order as headroom shrinks — trace writes drop first
    (remaining < trace_floor_bytes), then isocalc cache writes
    (< cache_floor_bytes), then new submits shed with a structured 507
    (< submit_floor_bytes); essential writes (checkpoints, results, spool)
    are denied only when the floor itself would be breached."""
    min_free_bytes: int = 0              # filesystem free-space reserve the
                                         # governor protects (0 disables the
                                         # statvfs constraint)
    disk_budget_bytes: int = 0           # cap on bytes under the governed
                                         # roots (work/results/queue);
                                         # 0 = free-space constraint only
    trace_floor_bytes: int = 32 << 20    # remaining headroom below which
                                         # trace-file writes are dropped
    cache_floor_bytes: int = 16 << 20    # ... below which isocalc cache
                                         # shard writes are dropped
    read_cache_floor_bytes: int = 12 << 20  # ... below which read-path
                                         # cache fills stop (reads still
                                         # answer from the segments)
    submit_floor_bytes: int = 8 << 20    # ... below which POST /submit
                                         # sheds with 507 + Retry-After
    gc_interval_s: float = 30.0          # retention sweep + usage rescan
                                         # cadence (scheduler replica loop)
    done_retention_age_s: float = 0.0    # spool done/ messages older than
                                         # this are removed (0 = keep)
    failed_retention_age_s: float = 0.0  # dead-letter/quarantine evidence
                                         # older than this is removed
                                         # (0 = keep)
    cache_retention_max_bytes: int = 0   # isocalc cache size cap — oldest
                                         # shards removed first (0 = keep)
    registry_retention_age_s: float = 3600.0  # crashed replicas' registry
                                         # heartbeat files older than this
                                         # are removed (they never retire)

    def __post_init__(self):
        if min(self.min_free_bytes, self.disk_budget_bytes,
               self.cache_retention_max_bytes) < 0:
            raise ValueError("resources: byte knobs must be >= 0")
        if not (self.trace_floor_bytes >= self.cache_floor_bytes
                >= self.read_cache_floor_bytes
                >= self.submit_floor_bytes >= 0):
            raise ValueError(
                "resources: degrade floors must be ordered "
                "trace_floor_bytes >= cache_floor_bytes >= "
                "read_cache_floor_bytes >= submit_floor_bytes >= 0 "
                "(traces drop first, then isocalc cache, then read-cache "
                "fills, then submits)")
        if self.gc_interval_s <= 0:
            raise ValueError("resources.gc_interval_s must be positive")
        if min(self.done_retention_age_s, self.failed_retention_age_s,
               self.registry_retention_age_s) < 0:
            raise ValueError("resources: retention ages must be >= 0")


@dataclass(frozen=True)
class StorageConfig:
    """Where results land: parquet files, the sqlite ledger and index, and
    the ion images (``npz``, sparse, or ``png``), under ``results_dir``."""
    results_dir: str = "results"
    store_images: bool = True
    image_format: str = "npz"

    def __post_init__(self):
        if self.image_format not in ("npz", "png"):
            raise ValueError("storage.image_format must be 'npz' or 'png', "
                             f"got {self.image_format!r}")


@dataclass(frozen=True)
class TracingConfig:
    """Job tracing (``utils/tracing.py``): per-job JSONL span logs under
    ``dir`` ("" = ``<work_dir>/traces``), their retention, and the flight
    recorder's size."""
    enabled: bool = True
    dir: str = ""
    ring_size: int = 2048
    # retention of the on-disk per-job trace files, enforced by the
    # resource governor's GC sweep (service/resources.py): files older than
    # retention_age_s go, and past retention_max_bytes the oldest first.
    # 0 disables that dimension.
    retention_age_s: float = 0.0
    retention_max_bytes: int = 0

    def __post_init__(self):
        if self.ring_size <= 0:
            raise ValueError("tracing.ring_size must be positive")
        if self.retention_age_s < 0 or self.retention_max_bytes < 0:
            raise ValueError("tracing.retention_* must be >= 0")


@dataclass(frozen=True)
class LogsConfig:
    """``json: true`` logs one JSON object a line with the trace ids
    (``utils/logger.py::JsonLogFormatter``)."""
    json: bool = False


@dataclass(frozen=True)
class SMConfig:
    """Engine config of the port.  ``device`` defaults to the card: asking
    for ``cuda`` on a machine without one raises, nothing falls back to the
    CPU.  Tests pass ``device="cpu"``.  ``work_dir`` defaults to
    ``sm_tpu_work`` in the temporary directory, as the JAX package's
    ``/tmp/sm_tpu_work``."""
    backend: str = "torch_cuda"
    device: str = "cuda"
    fdr: FDRConfig = field(default_factory=FDRConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    service: ServiceConfig = field(default_factory=ServiceConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    tracing: TracingConfig = field(default_factory=TracingConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    resources: ResourcesConfig = field(default_factory=ResourcesConfig)
    logs: LogsConfig = field(default_factory=LogsConfig)
    work_dir: str = field(default_factory=lambda: str(
        Path(tempfile.gettempdir()) / "sm_tpu_work"))
    logs_dir: str = ""
    failpoints: str = ""

    def __post_init__(self):
        if self.backend not in VALID_BACKENDS:
            raise ValueError(
                f"backend must be one of {VALID_BACKENDS}, got {self.backend!r}")

    @property
    def trace_dir(self) -> str:
        """Resolved per-job trace-file directory (tracing.dir wins)."""
        return self.tracing.dir or str(Path(self.work_dir) / "traces")

    _instance: ClassVar["SMConfig | None"] = None

    @staticmethod
    def set_path(path: str | Path) -> "SMConfig":
        """Load ``path`` as the process-global config."""
        SMConfig._instance = _from_dict(SMConfig,
                                        json.loads(Path(path).read_text()))
        return SMConfig._instance

    @staticmethod
    def set(conf: "SMConfig") -> "SMConfig":
        SMConfig._instance = conf
        return conf

    @staticmethod
    def get_conf() -> "SMConfig":
        """The process-global config (defaults until one is set)."""
        if SMConfig._instance is None:
            SMConfig._instance = SMConfig()
        return SMConfig._instance

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SMConfig":
        return _from_dict(SMConfig, d)


_DATACLASS_FIELDS = {
    ("DSConfig", "database"): DatabaseConfig,
    ("DSConfig", "isotope_generation"): IsotopeGenerationConfig,
    ("DSConfig", "image_generation"): ImageGenerationConfig,
    ("SMConfig", "fdr"): FDRConfig,
    ("SMConfig", "parallel"): ParallelConfig,
    ("SMConfig", "service"): ServiceConfig,
    ("SMConfig", "storage"): StorageConfig,
    ("SMConfig", "tracing"): TracingConfig,
    ("SMConfig", "telemetry"): TelemetryConfig,
    ("TelemetryConfig", "profile"): ProfileConfig,
    ("SMConfig", "resources"): ResourcesConfig,
    ("SMConfig", "logs"): LogsConfig,
    ("ServiceConfig", "admission"): AdmissionConfig,
    ("ServiceConfig", "fleet"): FleetConfig,
    ("ServiceConfig", "prime"): PrimeConfig,
    ("ServiceConfig", "fleetview"): FleetViewConfig,
    ("ServiceConfig", "read"): ReadPathConfig,
    ("ServiceConfig", "stream"): StreamConfig,
}
