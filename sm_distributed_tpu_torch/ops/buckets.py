"""Canonical shape-bucket lattice and the bucket-spec registry.

Copy of ``sm_distributed_tpu/ops/buckets.py``.  The lattice: raw
dataset-dependent shapes snap to the quarter-point ladder
``{1, 1.25, 1.5, 1.75} x 2^e`` so the port pads exactly as the JAX package
does — resident peak arrays (``peak_bucket``), image rows (``row_bucket``,
zero rows whose only effect, on the correlation mean, is masked by the real
pixel count) and the pad-to batch (``batch_bucket_down``) — and keys the
OOM safe-batch memory on the same buckets (``pixel_bucket``).
``band_bucket`` is the JAX package's band-capacity ladder
(``ops/imager_jax.py``): the port's band is a view of exactly its width, and
reads the ladder only to name a band batch's spec as the JAX package does.

The spec registry: the backends record each batch's ``BucketSpec`` at
dispatch (``models/msm_torch.py``, ``parallel/sharded.py``) under the JAX
package's keys (``_SPEC_KEYS``, ``spec_key``), write-through to
``bucket_manifest.json`` in the kernel build directory, where the kernel
primer (``service/primer.py``) finds what traffic needs: on the port a
spec names the kernels its variant launches, not an XLA executable.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

# ---------------------------------------------------------------- lattice

# floors: below these the padding waste is noise and a single bucket is
# cheaper than many tiny executables
PEAK_FLOOR = 4096       # resident-peak arrays (slots are 8 bytes)
ROW_FLOOR = 8           # image rows
PIXEL_FLOOR = 64        # flat pixel counts (oom shape keys)


def pow2ish(n: int, floor: int = 1) -> int:
    """Smallest quarter-ladder point ({1, 1.25, 1.5, 1.75} x 2^e) >= n,
    with a floor.  The shared canonical rounding — every shape bucket in
    the engine goes through this one ladder."""
    n = max(int(n), 1)
    cap = max(int(floor), 1)
    while cap < n:
        cap <<= 1
    if cap > floor and cap >= 8:
        # quarter points live between cap/2 and cap
        for quarters in (5, 6, 7):
            mid = (cap >> 3) * quarters
            if n <= mid:
                return mid
    return cap


def pow2ish_down(n: int, floor: int = 1) -> int:
    """Largest quarter-ladder point <= n (>= floor) — the DOWN-snap used
    for pad-to batch sizes, where rounding up would grow a proven-fitting
    memory footprint.  Ladder points: powers of two, plus the 5/8, 6/8,
    7/8 points of every octave at or above 8 (matching ``pow2ish``)."""
    n = max(int(n), 1)
    f = max(int(floor), 1)
    if n <= f:
        return f
    best = f
    cap = 1
    while cap <= n:
        if cap >= f:
            best = max(best, cap)
        if cap >= 8 and cap > f:
            for eighths in (5, 6, 7):
                pt = (cap >> 3) * eighths
                if f <= pt <= n:
                    best = max(best, pt)
        cap <<= 1
    # the octave just above n can still hold in-range quarter points
    if cap >= 8 and cap > f:
        for eighths in (5, 6, 7):
            pt = (cap >> 3) * eighths
            if f <= pt <= n:
                best = max(best, pt)
    return best


def peak_bucket(n_peaks: int) -> int:
    """Lattice capacity for a resident sorted-peak array."""
    return pow2ish(n_peaks, PEAK_FLOOR)


def row_bucket(nrows: int) -> int:
    """Lattice row count for the image grid (columns stay exact)."""
    return pow2ish(nrows, ROW_FLOOR)


def pixel_bucket(n_pixels: int) -> int:
    """Lattice point for a flat pixel count: the granularity of the OOM
    safe-batch ``shape_key``, so a learned batch transfers to every dataset
    size sharing the bucket."""
    return pow2ish(n_pixels, PIXEL_FLOOR)


def batch_bucket_down(batch: int) -> int:
    """Largest lattice point <= ``batch`` — pad-to batch sizes and
    OOM-shrunk caps snap DOWN so padding never grows a proven-fitting
    device-memory footprint."""
    return pow2ish_down(batch, 1)


def buckets_enabled(parallel_cfg) -> bool:
    """``parallel.shape_buckets`` knob: "auto"/"on" enable the lattice,
    "off" keeps the exact legacy shapes (tests compare the two)."""
    return getattr(parallel_cfg, "shape_buckets", "auto") != "off"


def effective_batch(parallel_cfg) -> int:
    """The pad-to scoring batch: ``parallel.formula_batch`` snapped DOWN
    to the lattice when buckets are on (both the slicing side —
    ``MSMBasicSearch`` — and the padding side — the backend — call
    this, so they can never disagree)."""
    b = max(1, parallel_cfg.formula_batch)
    return batch_bucket_down(b) if buckets_enabled(parallel_cfg) else b

def band_bucket(width: int, floor: int = 1 << 21) -> int:
    """Static band-slice capacity for a band of ``width`` peaks: the
    smallest {1, 1.125..1.875 step 1/8} x pow-2 ladder point >= width
    (with a floor) — the JAX package's ``ops/imager_jax.band_bucket``."""
    cap = floor
    while cap < width:
        cap <<= 1
    if cap > floor:
        for eighths in range(9, 16):
            mid = (cap >> 4) * eighths
            if width <= mid:
                return mid
    return cap


# ---------------------------------------------------------- spec registry

_SPEC_KEYS = (
    # identity of one batch shape in the lattice (the JAX package's keys)
    "kind",               # "flat" | "sharded" | "chunked"
    "variant",            # "plain" | "compact" | "band" | "fused" | "step"
    "nrows", "ncols",     # bucketed rows x exact columns (metric geometry)
    "nlevels", "do_preprocessing", "q",
    "n_resident",         # bucketed resident peak slots (per shard row)
    "b", "k",             # padded batch x isotope peaks
    "gc_width",           # sticky chunk-band ladder point
    "n_keep", "r_pad",    # compact-variant capacities (0 = n/a)
    "w_cap",              # band-variant capacity (0 = n/a)
    "g", "c", "wc",       # bound-grid / chunk-plan shapes
    "devices",            # lease shape: chip count (1 = single device)
    # sharded (mesh-shaped) specs only — absent (None) on flat specs
    # so pre-existing manifest keys stay stable within a kind:
    "mesh_pix", "mesh_form",  # mesh axis sizes (pixels x formulas)
    "p_loc",              # per-shard pixel capacity (whole bucketed rows)
    "w",                  # total window count (the inv permutation length)
    # compacted cubes only — recorded only when
    # parallel.cube_dtype != "f32", so legacy spec keys stay byte-stable:
    "cube_dtype",         # "bf16" | "int8" resident intensity dtype
)


def spec_key(spec: dict) -> str:
    """Stable identity string for one BucketSpec (manifest/dedup key)."""
    return "|".join(f"{k}={spec.get(k)}" for k in _SPEC_KEYS)


class _SpecRegistry:
    """Process-global registry of observed bucket specs, write-through to
    ``<kernel build dir>/bucket_manifest.json`` (guarded-by registry, the
    JAX package's own)."""

    _GUARDED_BY = {"_specs": "_lock", "_dir": "_lock"}
    _MAX = 256                        # manifest bound (oldest dropped)

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, dict] = {}
        self._dir: Path | None = None

    def set_dir(self, cache_dir) -> None:
        """Bind the persistence directory (the kernel build directory)
        and fold any previously persisted manifest in."""
        if cache_dir is None:
            return
        path = Path(cache_dir) / "bucket_manifest.json"
        loaded: dict[str, dict] = {}
        try:
            raw = json.loads(path.read_text())
            for ent in raw.get("specs", []):
                if isinstance(ent, dict):
                    loaded[spec_key(ent)] = ent
        except (OSError, ValueError):
            pass                      # absent/corrupt manifest = empty
        with self._lock:
            self._dir = Path(cache_dir)
            for k, v in loaded.items():
                self._specs.setdefault(k, v)

    def record(self, spec: dict) -> bool:
        """Record one observed spec; returns True when it is new.  New
        specs write through to the manifest (atomic tmp+replace); a failed
        write is logged by the caller's layer, never raised."""
        key = spec_key(spec)
        with self._lock:
            if key in self._specs:
                return False
            self._specs[key] = dict(spec)
            while len(self._specs) > self._MAX:
                self._specs.pop(next(iter(self._specs)))
            snapshot = list(self._specs.values())
            directory = self._dir
        if directory is not None:
            _write_manifest(directory, snapshot)
        return True

    def specs(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._specs.values()]

    def reset(self) -> None:
        with self._lock:
            self._specs.clear()
            self._dir = None


def _write_manifest(directory: Path, specs: list[dict]) -> None:
    path = directory / "bucket_manifest.json"
    tmp = path.with_name(path.name + ".tmp")
    try:
        directory.mkdir(parents=True, exist_ok=True)
        tmp.write_text(json.dumps({"specs": specs}))
        os.replace(tmp, path)
    except OSError:
        from ..utils.logger import logger

        logger.warning("could not write bucket manifest %s", path,
                       exc_info=True)


_registry = _SpecRegistry()


def bind_manifest_dir(cache_dir) -> None:
    """Point the spec registry's persistence at the kernel build directory
    (once a process, by ``service/primer.bind_builds``)."""
    _registry.set_dir(cache_dir)


def record_spec(spec: dict) -> bool:
    """Record one observed executable spec (backends call this at
    dispatch time, deduped); returns True when new."""
    return _registry.record(spec)


def recorded_specs() -> list[dict]:
    return _registry.specs()


def load_manifest(cache_dir) -> list[dict]:
    """Read a persisted bucket manifest without touching the process
    registry (the prime_cache driver's entry point)."""
    path = Path(cache_dir) / "bucket_manifest.json"
    try:
        raw = json.loads(path.read_text())
    except (OSError, ValueError):
        return []
    return [e for e in raw.get("specs", []) if isinstance(e, dict)]


def reset() -> None:
    """Forget recorded specs and the bound manifest dir (tests)."""
    _registry.reset()
