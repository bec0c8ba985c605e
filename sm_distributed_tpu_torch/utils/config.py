"""Configuration of the PyTorch port.

A port of ``sm_distributed_tpu/utils/config.py``: the per-dataset
``DSConfig`` (database, isotope_generation, image_generation) with the same
keys and defaults, and the engine's ``SMConfig`` with ``backend``
(``torch_cuda``, the default, or the host oracle ``numpy_ref``),
``device``, ``fdr``, the ``parallel`` knobs the scoring and isotope-pattern
paths read, the ``service`` block's three breaker knobs, ``storage``,
``tracing``, ``logs``, ``work_dir``, ``logs_dir`` and ``failpoints``, and
the process-global instance of ``set_path`` / ``get_conf``.  ``from_dict``
rejects unknown keys, as the JAX package does.

A block or value the port does not have yet raises ``NotImplementedError``
naming the ROADMAP item that brings it, rather than being dropped: every
``service`` key but ``breaker_threshold``, ``breaker_cooldown_s`` and
``breaker_degraded_batch``, the ``telemetry`` and ``resources`` blocks and
the tracing retention knobs (item 9) unless they hold the JAX package's
default, ``parallel.isocalc_device="on"`` (item 8), the JAX package's mesh
and multi-host knobs (item 7), its compile cache and dataset residency
(item 9), and the values listed on each dataclass.  ``peak_compaction`` and
``band_slice`` take every value the JAX package does: ``"auto"`` lets the
backend pick the plain, band or compact variant for each batch by its
estimated cost on the card, ``"on"`` forces one (band first), ``"off"``
leaves it out; the variants give the same bits.  ``do_preprocessing``
(hot-spot clipping), ``checkpoint_every`` (search checkpoint groups) and
``cube_dtype`` (a bf16 or int8 resident intensity cube on the flat path)
take every value the JAX package accepts.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, ClassVar

VALID_BACKENDS = ("numpy_ref", "torch_cuda")


# the JAX package's ``service`` keys beside the breaker knobs, with their
# defaults (nested blocks as dicts): the service port (ROADMAP queue 1 item
# 9) brings them.  tests/test_torch_resilience.py holds this table equal to
# the JAX package's ServiceConfig defaults
_SERVICE_NOT_YET = {
    "workers": 2, "poll_interval_s": 0.5, "job_timeout_s": 21600.0,
    "max_attempts": 3, "backoff_base_s": 1.0, "backoff_max_s": 60.0,
    "backoff_jitter": 0.1, "heartbeat_interval_s": 5.0,
    "stale_after_s": 30.0, "drain_timeout_s": 30.0,
    "http_host": "127.0.0.1", "http_port": 8685, "cancel_grace_s": 15.0,
    "watchdog_interval_s": 5.0, "watchdog_stall_s": 0.0,
    "quarantine_after": 8, "device_pool_size": 0, "devices_per_job": 1,
    "device_pool_max_bypass": 64, "device_pool_hosts": 1,
    "lease_reap_after_s": 300.0, "health_probe_on_lease": True,
    "health_fault_quarantine": 3, "health_reprobe_after_s": 60.0,
    "health_host_evict_fraction": 0.75, "host_watchdog_interval_s": 0.0,
    "host_stale_after_s": 10.0, "replica_id": "r0", "replicas": 1,
    "spool_shards": 8, "replica_heartbeat_interval_s": 2.0,
    "replica_stale_after_s": 8.0, "takeover_interval_s": 2.0,
    "admission": {"max_queue_depth": 512, "max_tenant_inflight": 128,
                  "ewma_alpha": 0.2, "latency_shed_s": 0.0,
                  "latency_resume_s": 0.0, "retry_after_s": 1.0},
    "fleet": {"enabled": False, "min_replicas": 1, "max_replicas": 4,
              "decide_interval_s": 5.0, "cooldown_s": 60.0,
              "hysteresis_ticks": 2, "scale_up_burn": 1.0,
              "scale_down_burn": 0.5, "queue_high_per_replica": 8.0,
              "queue_low_per_replica": 1.0, "occupancy_high": 0.95,
              "spawn_timeout_s": 30.0, "drain_timeout_s": 120.0},
    "prime": {"enabled": False, "idle_after_s": 5.0, "interval_s": 30.0,
              "max_specs_per_cycle": 0},
    "read": {"enabled": True, "cache_max_bytes": 67108864,
             "cache_max_entries": 1024, "cache_disk_max_bytes": 134217728,
             "max_concurrent": 32, "retry_after_s": 1.0, "page_size": 100,
             "page_size_max": 1000},
    "stream": {"idle_timeout_s": 300.0, "poll_interval_s": 0.25,
               "rescore_min_chunks": 1, "retention_age_s": 3600.0},
    "fleetview": {"enabled": True, "scrape_timeout_s": 2.0,
                  "cache_ttl_s": 1.0},
}

# blocks and knobs of the JAX package's config the port does not have yet:
# (dataclass, key) -> (ROADMAP item, the JAX package's default, which is
# accepted); None as the default: any value raises.  A nested block is
# accepted when each key it gives holds its default.
_NOT_YET = {
    **{("ServiceConfig", k): ("queue 1 item 9", v)
       for k, v in _SERVICE_NOT_YET.items()},
    ("SMConfig", "telemetry"): ("queue 1 item 9", None),
    ("SMConfig", "resources"): ("queue 1 item 9", None),
    ("TracingConfig", "retention_age_s"): ("queue 1 item 9", 0.0),
    ("TracingConfig", "retention_max_bytes"): ("queue 1 item 9", 0),
    ("ParallelConfig", "compile_cache_dir"): ("queue 1 item 9", ""),
    ("ParallelConfig", "resident_datasets"): ("queue 1 item 9", 2),
    ("ParallelConfig", "pixels_axis"): ("queue 1 item 7", -1),
    ("ParallelConfig", "formulas_axis"): ("queue 1 item 7", 1),
    ("ParallelConfig", "coordinator_address"): ("queue 1 item 7", ""),
    ("ParallelConfig", "num_processes"): ("queue 1 item 7", 1),
    ("ParallelConfig", "process_id"): ("queue 1 item 7", -1),
    ("ParallelConfig", "init_retries"): ("queue 1 item 7", 5),
    ("ParallelConfig", "init_backoff_s"): ("queue 1 item 7", 1.0),
}


def _from_dict(cls, d: dict[str, Any]):
    """Build a dataclass from a dict, recursing into dataclass fields and
    rejecting unknown keys.  Keys starting with "__" are comments.  A key of
    the JAX package's config the port does not have yet raises
    ``NotImplementedError`` unless it holds the JAX package's default."""
    d = {k: v for k, v in d.items() if not k.startswith("__")}
    for key in list(d):
        entry = _NOT_YET.get((cls.__name__, key))
        if entry is None:
            continue
        item, default = entry
        if default is not None and _holds_default(d[key], default):
            del d[key]
            continue
        raise _not_in_slice(f"{cls.__name__} {key!r}", item)
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


def _holds_default(value, default) -> bool:
    """``value`` is ``default``, or, for a nested block, a dict each of
    whose keys holds its default."""
    if isinstance(default, dict):
        return isinstance(value, dict) and all(
            k in default and _holds_default(v, default[k])
            for k, v in value.items())
    return value == default


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the PyTorch port yet ({item} of ROADMAP.md)")


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
    land."""
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

    def __post_init__(self):
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
                or self.isocalc_chunk < 0 or self.checkpoint_every < 0:
            raise ValueError("parallel: formula_batch must be positive and "
                             "isocalc_workers, isocalc_chunk and "
                             "checkpoint_every >= 0")
        if self.isocalc_device == "on":
            raise _not_in_slice("parallel.isocalc_device='on' (device "
                                "isotope-pattern blur)", "queue 1 item 8")


@dataclass(frozen=True)
class ServiceConfig:
    """The ``service`` block's device-breaker knobs (``models/breaker.py``):
    consecutive sticky device faults before the breaker opens, and the open
    -> half-open probe delay.  ``breaker_degraded_batch`` (the JAX
    package's numpy formula batch while the breaker is open) is accepted
    and validated so the JAX package's configs load, and read nowhere: the
    port refuses a job on an open breaker instead of moving it to the host.
    The block's other keys raise until the service port."""
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    breaker_degraded_batch: int = 512

    def __post_init__(self):
        if self.breaker_threshold <= 0 or self.breaker_cooldown_s < 0 or \
                self.breaker_degraded_batch <= 0:
            raise ValueError("service: breaker knobs out of range")


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
    ``dir`` ("" = ``<work_dir>/traces``) and the flight recorder's size."""
    enabled: bool = True
    dir: str = ""
    ring_size: int = 2048

    def __post_init__(self):
        if self.ring_size <= 0:
            raise ValueError("tracing.ring_size must be positive")


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
    ("SMConfig", "logs"): LogsConfig,
}
