"""Configuration of the PyTorch port: the knobs its main path reads.

A port of ``sm_distributed_tpu/utils/config.py`` cut to this slice: the
per-dataset ``DSConfig`` (database, isotope_generation, image_generation)
with the same keys and defaults, and an ``SMConfig`` with ``backend``,
``device``, ``fdr`` and the ``parallel`` knobs the scoring paths read.
``from_dict`` rejects unknown keys, as the JAX package does.

A value this slice cannot honour raises ``NotImplementedError`` naming the
ROADMAP item that brings it.  ``"auto"`` for ``peak_compaction`` and
``band_slice`` resolves to the plain variant, which the JAX package declares
bit-exact against both (``models/msm_jax.py`` NUMERICS), so results do not
change.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

VALID_BACKENDS = ("torch_cuda",)


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
        if self.do_preprocessing:
            raise _not_in_slice("image_generation.do_preprocessing=true "
                                "(hot-spot clipping)", "queue 1 item 7")


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
    """The ``parallel`` knobs the scoring paths read (same names and
    defaults as the JAX package).  ``mz_chunk > 0`` takes the m/z-chunked
    cube path; ``fused_metrics="on"`` takes the fused window-moments kernel
    on the flat path, while ``"auto"`` and ``"off"`` keep the plain
    chain."""
    formula_batch: int = 2048
    mz_chunk: int = 0
    peak_compaction: str = "auto"
    order_ions: str = "auto"
    band_slice: str = "auto"
    shape_buckets: str = "auto"
    cube_dtype: str = "f32"
    fused_metrics: str = "auto"
    # isotope-pattern process pool: 0 = all cores
    isocalc_workers: int = 0

    def __post_init__(self):
        for knob, valid in (("order_ions", ("auto", "mz", "table")),
                            ("band_slice", ("auto", "on", "off")),
                            ("peak_compaction", ("auto", "on", "off")),
                            ("shape_buckets", ("auto", "on", "off")),
                            ("cube_dtype", ("f32", "bf16", "int8")),
                            ("fused_metrics", ("auto", "on", "off"))):
            v = getattr(self, knob)
            if v not in valid:
                raise ValueError(
                    f"parallel.{knob} must be one of {valid}, got {v!r}")
        if self.formula_batch <= 0 or self.isocalc_workers < 0:
            raise ValueError("parallel: formula_batch must be positive and "
                             "isocalc_workers >= 0")
        if self.cube_dtype != "f32":
            raise _not_in_slice(f"parallel.cube_dtype={self.cube_dtype!r} "
                                "(resident-cube compaction)", "queue 1 item 6")
        if self.peak_compaction == "on":
            raise _not_in_slice("parallel.peak_compaction='on'",
                                "queue 1 item 5")
        if self.band_slice == "on":
            raise _not_in_slice("parallel.band_slice='on'", "queue 1 item 5")


@dataclass(frozen=True)
class SMConfig:
    """Engine config of the port.  ``device`` defaults to the card: asking
    for ``cuda`` on a machine without one raises, nothing falls back to the
    CPU.  Tests pass ``device="cpu"``."""
    backend: str = "torch_cuda"
    device: str = "cuda"
    fdr: FDRConfig = field(default_factory=FDRConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def __post_init__(self):
        if self.backend not in VALID_BACKENDS:
            raise ValueError(
                f"backend must be one of {VALID_BACKENDS}, got {self.backend!r}")

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SMConfig":
        return _from_dict(SMConfig, d)


_DATACLASS_FIELDS = {
    ("DSConfig", "database"): DatabaseConfig,
    ("DSConfig", "isotope_generation"): IsotopeGenerationConfig,
    ("DSConfig", "image_generation"): ImageGenerationConfig,
    ("SMConfig", "fdr"): FDRConfig,
    ("SMConfig", "parallel"): ParallelConfig,
}
