"""Theoretical isotope patterns (the reference's IsocalcWrapper).

Port of ``sm_distributed_tpu/ops/isocalc.py``: exact isotopic fine
structure, gaussian blur at instrument resolution (``isocalc_sigma``,
``isocalc_pts_per_mz``), centroid detection and the top ``n_peaks``
centroids per (formula, adduct), intensities normalized to max 100.  The
per-pattern math (``fine_structure``, ``centroids``) is a copy and gives the
same bits.

Generation runs as the JAX package's ``PatternStream``: the missing
(formula, adduct) work-list is cut into deterministic chunks, fanned out
over a spawn process pool (inline for short lists, with a rebuild-then-
inline retry ladder), and every completed chunk commits one CRC32-checked
cache shard ``theor_peaks_<key>_<job>_c<ci>.npz`` under ``cache_dir`` and
fills its rows of the table.  The parameter key and the shard format are
the JAX package's, so a cache written by either package is read by the
other.  Corrupt shards are skipped and unlinked; shards compact into one
base file past 64.

Cache-shard writes pass the service's disk governor
(``service/resources.py``): skipped under disk pressure, denied at the hard
floor; the service exports the generation counters (``attach_metrics``).

Device mode (``device_blur=True``, ``parallel.isocalc_device="on"`` or env
``SM_ISOCALC_DEVICE=1``): workers emit each ion's fine-structure segments
(``fine_structure_segments``) and the blur, centroid detection and top
``n_peaks`` run batched on the search's torch device
(``ops/isocalc_torch.py``); heavy ions past the stage's caps take the exact
host oracle.  The patterns agree with the oracle to ~1e-5, not bit-exactly,
so they live under their own cache key (``dev<key>``, the JAX package's).
Workers stay free of torch: the stage runs in the parent process.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import zipfile
import zlib
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from . import elements
from .formula import FormulaError, apply_adduct, parse_formula
from ..utils import tracing
from ..utils.config import IsotopeGenerationConfig
from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger

# fine-structure pruning: drop states below this relative abundance
_PRUNE_ABUNDANCE = 1e-10
# merge fine-structure states closer than this [Da] (well below any
# instrument sigma we blur with; keeps convolutions small)
_MERGE_DA = 1e-5
# cap on states kept per convolution (keeps worst-case formulas bounded)
_MAX_STATES = 4096


def _merge_states(masses: np.ndarray, abunds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort by mass; merge states within _MERGE_DA (abundance-weighted mass)."""
    order = np.argsort(masses)
    masses, abunds = masses[order], abunds[order]
    # group indices: new group wherever the gap exceeds the merge width
    group = np.concatenate([[0], np.cumsum(np.diff(masses) > _MERGE_DA)])
    n = group[-1] + 1
    # bincount == add.at here (same left-to-right accumulation order, so
    # identical f64 bits) at a fraction of the cost — add.at's unbuffered
    # ufunc loop was the fine-structure hot spot
    ab = np.bincount(group, weights=abunds, minlength=n)
    wm = np.bincount(group, weights=masses * abunds, minlength=n)
    return wm / ab, ab


def _prune(masses: np.ndarray, abunds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keep = abunds > _PRUNE_ABUNDANCE * abunds.max()
    masses, abunds = masses[keep], abunds[keep]
    if masses.size > _MAX_STATES:
        keep = np.argsort(abunds)[-_MAX_STATES:]
        keep.sort()
        masses, abunds = masses[keep], abunds[keep]
    return masses, abunds


def _convolve(a: tuple[np.ndarray, np.ndarray], b: tuple[np.ndarray, np.ndarray]):
    m = (a[0][:, None] + b[0][None, :]).ravel()
    p = (a[1][:, None] * b[1][None, :]).ravel()
    return _prune(*_merge_states(m, p))


@lru_cache(maxsize=8192)
def _element_distribution(el: str, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Isotope distribution of n atoms of el, by exponentiation-by-squaring.

    Cached per (element, count): across a molecular DB the same (el, n)
    pairs recur constantly (profiled at 30% of pattern wall-clock when
    recomputed per formula — the cache is exact, the arrays are treated
    as read-only by every consumer).  Each worker process builds its own
    cache (cheap relative to a >=256-pattern batch)."""
    isos = elements.ISOTOPES[el]
    base = (np.array([m for m, _ in isos]), np.array([a for _, a in isos]))
    result: tuple[np.ndarray, np.ndarray] | None = None
    sq = base
    while n > 0:
        if n & 1:
            result = sq if result is None else _convolve(result, sq)
        n >>= 1
        if n:
            sq = _convolve(sq, sq)
    assert result is not None
    return result


def fine_structure(counts: dict[str, int]) -> tuple[np.ndarray, np.ndarray]:
    """Exact isotopic fine structure of a neutral molecule: (masses, abundances),
    sorted by mass, abundances summing to ~1 (minus pruned tail)."""
    acc: tuple[np.ndarray, np.ndarray] | None = None
    for el, n in sorted(counts.items()):
        dist = _element_distribution(el, n)
        acc = dist if acc is None else _convolve(acc, dist)
    assert acc is not None
    return acc


def centroids(
    counts: dict[str, int],
    charge: int,
    isocalc_sigma: float,
    isocalc_pts_per_mz: int,
    n_peaks: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Centroided theoretical pattern of the ION with the given atom counts.

    Returns (mzs, ints): up to ``n_peaks`` peaks sorted by m/z ascending,
    intensities normalized so the strongest peak is 100.0 (the pyisocalc
    convention the reference stores in theor_peaks [U]).
    """
    masses, abunds = fine_structure(counts)
    # ion m/z per fine-structure state
    mzs_fs = (masses - charge * elements.ELECTRON_MASS) / abs(charge)

    # Only the low-mass end can contribute the top peaks: blurring merges
    # states within ~sigma, and isotope peaks are ~1/|z| apart. Keep a margin
    # of n_peaks+2 isotope spacings above the monoisotopic state.
    lo = mzs_fs.min()
    window = (n_peaks + 2) / abs(charge)
    keep = mzs_fs <= lo + window
    mzs_fs, abunds_fs = mzs_fs[keep], abunds[keep]

    # profile grid at pts_per_mz resolution, padded by 5 sigma
    pad = 5.0 * isocalc_sigma
    step = 1.0 / isocalc_pts_per_mz
    grid_lo = mzs_fs.min() - pad
    npts = int(np.ceil((mzs_fs.max() + pad - grid_lo) / step)) + 1
    half = int(np.ceil(pad / step))
    centers = np.rint((mzs_fs - grid_lo) / step).astype(np.int64)
    # COMPACT grid: states cluster at ~1/|z| isotope spacings, so >80% of
    # the full [lo, hi] grid is exactly zero (no state within 5 sigma) —
    # yet the zero stretches dominated the wall (local-max scan + arrays
    # over ~50k points for <=4 peaks).  Build the profile only over the
    # union of per-state windows padded by 1 point: every nonzero point
    # AND both its neighbors live inside (gap points have zero profile,
    # zero plateaus can never satisfy the strict right-side maximum test,
    # and the reference semantics truncate each state's contribution at
    # its window edge anyway), so peak indices/values are IDENTICAL to
    # the full-grid scan.  The zero-pad property is ARGUED here (pad
    # points sit outside every truncated window by construction), not
    # runtime-checked; the boundary masking below is what keeps the scan
    # exact even at the clipped grid edges.
    # states (and hence centers) are mass-ascending — fine_structure sorts
    # by mass and the keep mask preserves order — so segments merge with
    # one linear pass, no sort
    assert centers.size == 0 or np.all(np.diff(centers) >= 0)
    s_lo = np.maximum(centers - (half + 1), 0)
    s_hi = np.minimum(centers + (half + 1), npts - 1)
    run_hi = np.maximum.accumulate(s_hi)
    new = np.concatenate([[True], s_lo[1:] > run_hi[:-1] + 1])
    starts = s_lo[new]                       # disjoint covered segments
    ends = run_hi[np.concatenate([new[1:], [True]])]
    seg_off = np.concatenate([[0], np.cumsum(ends[:-1] - starts[:-1] + 1)])
    n_compact = int(seg_off[-1] + (ends[-1] - starts[-1] + 1))
    # each STATE's whole (clipped) window lies inside ONE segment, so the
    # full->compact map is a per-state offset — no per-point searchsorted
    seg_state = np.searchsorted(starts, centers, side="right") - 1
    state_shift = (seg_off - starts)[seg_state]          # (S,)

    # vectorized over states: every state adds a (2*half+1)-point gaussian
    # window (one bincount instead of a Python loop per state)
    # i32 indices: the profile grid is tens of thousands of points (far
    # below 2**31) and the half-width (S, W) index block is the hot
    # allocation — half the bytes of the default i64
    offs = np.arange(-half, half + 1, dtype=np.int32)
    idx = centers.astype(np.int32)[:, None] + offs[None, :]
    if int(centers[0]) < half or int(centers[-1]) + half > npts - 1:
        # out-of-range window points are TRUNCATED (zero contribution),
        # matching the per-state-window semantics — clamping alone would
        # pile tail terms onto profile[0]/profile[-1] at wrong x offsets
        # (ADVICE r2)
        in_range = (idx >= 0) & (idx < npts)
        np.clip(idx, 0, npts - 1, out=idx)
        # same bits as gathering from grid = grid_lo + step*arange(npts):
        # both compute grid_lo + step*k elementwise
        x = (grid_lo + step * idx) - mzs_fs[:, None]
        contrib = np.where(
            in_range,
            abunds_fs[:, None] * np.exp(-0.5 * (x / isocalc_sigma) ** 2), 0.0)
    else:
        # no window is clipped — identical bits without the mask/clip/
        # where passes over the (states, window) block; the in-place ufunc
        # chain runs the exact same op sequence with no extra temporaries.
        # Reachability: centers[0] == rint(pad/step) vs half ==
        # ceil(pad/step), so this path engages when pad/step is integral —
        # true for the shipped defaults (5*0.01 * 10000 = 500) — and
        # configs with fractional pad/step take the exact masked branch
        # above (re-anchoring the grid to force the fast path would change
        # result bits for those configs; not worth it)
        x = step * idx
        x += grid_lo
        x -= mzs_fs[:, None]
        x /= isocalc_sigma
        np.multiply(x, x, out=x)
        x *= -0.5
        np.exp(x, out=x)
        x *= abunds_fs[:, None]
        contrib = x
    # bincount over the raveled (state, window) grid accumulates in the same
    # row-major order as add.at — identical f64 bits (the compact mapping
    # is order-preserving within each bin's collision group)
    cidx = idx + state_shift[:, None]
    profile = np.bincount(cidx.ravel(), weights=contrib.ravel(),
                          minlength=n_compact)

    # local maxima per covered segment; cross-segment neighbors are zero
    mids = (profile[1:-1] >= profile[:-2]) & (profile[1:-1] > profile[2:])
    # mask out compact points that are segment BOUNDARIES (their full-grid
    # neighbors differ from their compact neighbors); their profile is 0
    # except at grid edges, and a boundary point adjacent to a positive
    # interior value can never be a strict local max of the full grid
    # unless it is positive itself — which only happens at the clipped
    # grid edges, exactly where the full scan's mids also excluded
    # (profile[0]/profile[-1] are never scanned)
    bounds_c = np.concatenate([seg_off, seg_off + (ends - starts)])
    interior = np.ones(n_compact, dtype=bool)
    interior[bounds_c] = False
    peak_idx = np.nonzero(mids & interior[1:-1])[0] + 1
    if peak_idx.size == 0:
        peak_idx = np.array([int(np.argmax(profile))])

    # parabolic interpolation around each maximum for sub-grid m/z + height
    y0, y1, y2 = profile[peak_idx - 1], profile[peak_idx], profile[peak_idx + 1]
    denom = y0 - 2 * y1 + y2
    delta = np.where(np.abs(denom) > 0, 0.5 * (y0 - y2) / np.where(denom == 0, 1, denom), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    # compact -> full-grid index, then the same grid_lo + step*k expression
    # the dense grid used (identical f64 bits)
    seg_of = np.searchsorted(seg_off, peak_idx, side="right") - 1
    full_ix = starts[seg_of] + (peak_idx - seg_off[seg_of])
    peak_mzs = (grid_lo + step * full_ix) + delta * step
    peak_ints = y1 - 0.25 * (y0 - y2) * delta

    # top n_peaks by intensity, then m/z-ascending; normalize max -> 100
    if peak_mzs.size > n_peaks:
        top = np.argsort(peak_ints)[-n_peaks:]
        top.sort()
        peak_mzs, peak_ints = peak_mzs[top], peak_ints[top]
    order = np.argsort(peak_mzs)
    peak_mzs, peak_ints = peak_mzs[order], peak_ints[order]
    peak_ints = 100.0 * peak_ints / peak_ints.max()
    return peak_mzs, peak_ints.astype(np.float64)


@dataclass
class IsotopePatternTable:
    """Device-friendly packed isotope patterns for a list of ions.

    The replacement for the reference's ``theor_peaks`` table + Spark
    broadcast (``Formulas.get_sf_peak_*`` [U], SURVEY.md #8): fixed-shape
    (n_ions, max_peaks) arrays, zero-padded, ready to ship to the device.
    """

    sfs: list[str]            # sum formula per ion
    adducts: list[str]        # adduct per ion
    mzs: np.ndarray           # (n_ions, max_peaks) f64, 0-padded
    ints: np.ndarray          # (n_ions, max_peaks) f64, 0-padded, max=100 per row
    n_valid: np.ndarray       # (n_ions,) i32 — valid peak count per ion
    targets: np.ndarray       # (n_ions,) bool — target (vs decoy) ion

    @property
    def n_ions(self) -> int:
        return self.mzs.shape[0]

    @property
    def max_peaks(self) -> int:
        return self.mzs.shape[1]


# Version salt for pairs-based checkpoint fingerprints (models/msm_basic.py
# hashes it instead of the full pattern table when scoring overlaps
# generation); the JAX package's value, so a checkpoint written by either
# package resumes in the other.  BUMP THIS (in both packages) whenever
# centroids()/fine_structure() change result bits: a stale value lets an old
# mid-search checkpoint resume against silently different patterns.
ISOCALC_PATTERN_VERSION = 1

# ---------------------------------------------------------------------------
# fine-structure segments (host prep for the device blur stage)
#
# Windowed states cluster at isotope spacings (~1/|z| Da) while the blur
# support is only 5*sigma, so the profile decomposes into a handful of short
# independent segments, each evaluated densely on the device
# (ops/isocalc_torch.py) without a scatter.

# per-segment grid cap (points).  At the shipped 10k pts/mz this allows a
# ~53 mDa state span per segment; typical isotope clusters span a few mDa.
SEGMENT_GRID_CAP = 1536


def fine_structure_segments(
    counts: dict[str, int],
    charge: int,
    isocalc_sigma: float,
    isocalc_pts_per_mz: int,
    n_peaks: int,
) -> list[tuple[float, np.ndarray, np.ndarray, int]] | None:
    """Windowed ion fine structure, split into blur-independent segments.

    Returns ``[(seg_lo, m_rel, abunds, npts), ...]`` — per segment the f64
    grid origin (min state - 5 sigma), state positions relative to it, their
    abundances, and the segment grid length — or ``None`` when the ion does
    not fit the device stage's static caps (over ``n_peaks + 4`` segments, or
    a segment wider than SEGMENT_GRID_CAP): such heavy ions take the exact
    NumPy oracle instead.

    Segments are cut where the state gap exceeds ``2*pad + 2*step``: beyond
    that distance the oracle's truncated per-state windows cannot reach
    across the cut either, so evaluating segments independently drops only
    contributions the oracle drops too.
    """
    masses, abunds = fine_structure(counts)
    mzs = (masses - charge * elements.ELECTRON_MASS) / abs(charge)
    lo = mzs.min()
    keep = mzs <= lo + (n_peaks + 2) / abs(charge)
    mzs, abunds = mzs[keep], abunds[keep]
    step = 1.0 / isocalc_pts_per_mz
    pad = 5.0 * isocalc_sigma
    cuts = np.nonzero(np.diff(mzs) > 2 * pad + 2 * step)[0] + 1
    segs: list[tuple[float, np.ndarray, np.ndarray, int]] = []
    for s, e in zip(np.r_[0, cuts], np.r_[cuts, mzs.size]):
        m, a = mzs[s:e], abunds[s:e]
        seg_lo = float(m[0]) - pad
        npts = int(np.ceil((m[-1] + pad - seg_lo) / step)) + 1
        if npts > SEGMENT_GRID_CAP:
            return None
        segs.append((seg_lo, m - seg_lo, a, npts))
    if len(segs) > n_peaks + 4:
        return None
    return segs


FP_ISO_WORKER = register_failpoint(
    "isocalc.worker",
    "per-chunk isotope-pattern compute (pool-worker crash / chunk retry)")
FP_ISO_SHARD_SAVE = register_failpoint(
    "isocalc.shard_save",
    "between an isocalc cache shard's tmp savez and its os.replace")
FP_ISO_SHARD_LOAD = register_failpoint(
    "isocalc.shard_load",
    "per isocalc cache shard read at wrapper init (I/O error path)")

# pairs below this count are computed inline (pool startup isn't worth it)
_PARALLEL_THRESHOLD = 256
# (formula, adduct) pairs per work chunk == per incremental cache shard;
# serial and pooled generation use the same chunking, so shard boundaries
# are identical.  SM_ISOCALC_CHUNK overrides.
_DEFAULT_CHUNK = 2048
# pool rebuild attempts after a worker crash before falling back to inline
_POOL_ATTEMPTS = 2


def _chunk_size(configured: int = 0) -> int:
    if configured > 0:
        return configured
    return max(1, int(os.environ.get("SM_ISOCALC_CHUNK", _DEFAULT_CHUNK)))


def _pool_init(failpoint_spec: str | None) -> None:
    """Spawned-worker initializer: arm the parent's programmatic failpoint
    spec (env-var specs arrive via inheritance at import instead)."""
    if failpoint_spec:
        from ..utils import failpoints

        failpoints.configure(failpoint_spec)


def _compute_chunk(args):
    """Compute one chunk of pre-validated (sf, adduct) pairs, in a spawned
    pool worker or inline.  Returns ``(ci, outputs, trace_records)``, each
    output

    - ``("pat", ion, mzs, ints)``: a finished host-computed pattern, or
    - ``("seg", ion, segments)``: fine-structure segments for the device
      blur->centroid stage (device mode; heavy ions still arrive as "pat"
      through the exact oracle).

    With a wire trace context the chunk's span is captured (the worker has
    no sinks) and returned for the parent process to emit."""
    ci, pairs, params, device, wire = args
    ctx = tracing.TraceContext.from_wire(wire)
    if ctx is None:
        return ci, _compute_chunk_body(pairs, params, device), []
    with tracing.capture() as records:
        with tracing.span("isocalc_chunk", ctx=ctx, ci=ci,
                          n_pairs=len(pairs), worker_pid=os.getpid()):
            out = _compute_chunk_body(pairs, params, device)
    return ci, out, records


def _compute_chunk_body(pairs, params, device):
    failpoint(FP_ISO_WORKER)
    charge, sigma, pts_per_mz, n_peaks = params
    out = []
    for sf, adduct in pairs:
        counts = apply_adduct(parse_formula(sf), adduct)
        ion = f"{sf}{adduct}"
        if device:
            segs = fine_structure_segments(
                counts, charge, sigma, pts_per_mz, n_peaks)
            if segs is not None:
                out.append(("seg", ion, segs))
                continue
        mzs, ints = centroids(counts, charge, sigma, pts_per_mz, n_peaks)
        out.append(("pat", ion, mzs, ints))
    return out


# -- metrics hooks (the service's attach_metrics pattern) ---------------------

_metrics_lock = threading.Lock()
_metrics_registry = None
_patterns_total = 0


def attach_metrics(registry) -> None:
    """Export generation counters through a service ``MetricsRegistry``:
    ``sm_isocalc_patterns_total`` plus per-stream worker/rate gauges."""
    global _metrics_registry
    with _metrics_lock:
        _metrics_registry = registry
        total = _patterns_total
    c = registry.counter("sm_isocalc_patterns_total",
                         "Isotope patterns computed (cold, not cache hits)")
    if total:
        c.inc(total)


def patterns_total() -> int:
    """Monotone count of cold-computed patterns (service rate collector)."""
    with _metrics_lock:
        return _patterns_total


def _count_patterns(n: int, workers: int, rate: float) -> None:
    global _patterns_total
    with _metrics_lock:
        _patterns_total += n
        reg = _metrics_registry
    if reg is not None:
        reg.counter("sm_isocalc_patterns_total",
                    "Isotope patterns computed (cold, not cache hits)").inc(n)
        reg.gauge("sm_isocalc_workers",
                  "Process-pool size of the last isocalc generation"
                  ).set(workers)
        reg.gauge("sm_isocalc_patterns_per_s",
                  "Throughput of the current/last isocalc generation"
                  ).set(rate)


class PatternStream:
    """A running isotope-pattern generation (the JAX package's class).

    The table's rows are fixed up front (duplicates dropped, first
    occurrence kept; invalid chemistry dropped, as in the reference); cached
    patterns fill their rows at once, and a generator thread generates the
    missing ones chunk by chunk, committing each chunk's cache shard and
    rows in chunk order (out-of-order pool completions wait), so the shard
    sequence is the same in serial and pooled runs and a crash leaves a
    clean prefix.  ``ready_rows`` is the filled prefix of the table.
    """

    # guarded-by registry, the JAX package's less its _done flag, which
    # this copy does not keep: the publication frontier + stream terminal
    # state move only under _cond (row arrays themselves are single-writer,
    # published via the _ready_rows barrier)
    _GUARDED_BY = {"_ready_rows": "_cond", "_row_done": "_cond",
                   "_error": "_cond"}

    def __init__(self, wrapper: "IsocalcWrapper",
                 pairs: list[tuple[str, str]],
                 flags: list[bool] | None):
        self.wrapper = wrapper
        if flags is None:
            flags = [True] * len(pairs)
        seen: set[tuple[str, str]] = set()
        self.sfs: list[str] = []
        self.adducts: list[str] = []
        targets: list[bool] = []
        for (sf, adduct), flag in zip(pairs, flags):
            key = (sf, adduct)
            if key in seen:
                continue
            seen.add(key)
            try:
                apply_adduct(parse_formula(sf), adduct)
            except FormulaError:
                continue
            self.sfs.append(sf)
            self.adducts.append(adduct)
            targets.append(flag)
        self.targets = np.array(targets, dtype=bool)
        n = len(self.sfs)
        k = wrapper.cfg.n_peaks
        self.mzs = np.zeros((n, k))
        self.ints = np.zeros((n, k))
        self.n_valid = np.zeros(n, dtype=np.int32)
        self._row_done = np.zeros(n, dtype=bool)
        self._ready_rows = 0
        self._cond = threading.Condition()
        self._error: BaseException | None = None
        self._cancel = threading.Event()
        self.gen_seconds = 0.0
        self.workers = 1
        self.patterns_per_s = 0.0
        self.cold_patterns = 0

        self._row_of = {f"{sf}{ad}": i
                        for i, (sf, ad) in enumerate(zip(self.sfs,
                                                         self.adducts))}
        missing: list[tuple[str, str]] = []
        with wrapper._lock:
            for sf, ad in zip(self.sfs, self.adducts):
                hit = wrapper._cache.get(f"{sf}{ad}")
                if hit is None:
                    missing.append((sf, ad))
                else:
                    self._fill_row_locked(self._row_of[f"{sf}{ad}"], *hit)
        self._advance_prefix_locked()
        chunk = _chunk_size(wrapper.chunk_size)
        self._chunks = [missing[s: s + chunk]
                        for s in range(0, len(missing), chunk)]
        self.n_missing = len(missing)
        # deterministic job tag: chunk shards of the same missing set (a
        # rerun after a crash) land on the same file names
        self._job_tag = hashlib.sha256(
            "\x00".join(f"{sf}{ad}" for sf, ad in missing).encode()
        ).hexdigest()[:8]
        # thread hop: the caller's trace context goes along
        self._trace = tracing.current()
        self._thread = threading.Thread(
            target=self._run, name="isocalc-stream", daemon=True)
        self._thread.start()

    # -- consumer side -------------------------------------------------------

    @property
    def n_ions(self) -> int:
        return len(self.sfs)

    def ready_rows(self) -> int:
        with self._cond:
            return self._ready_rows

    def wait_rows(self, n: int, timeout: float | None = None) -> int:
        """Block until the first ``n`` table rows have patterns (or the
        stream errors — re-raised here)."""
        n = min(n, self.n_ions)
        with self._cond:
            self._cond.wait_for(
                lambda: self._ready_rows >= n or self._error is not None,
                timeout)
            if self._error is not None:
                raise self._error
            return self._ready_rows

    def table_view(self) -> "IsotopePatternTable":
        """The final table over the stream's shared row arrays: valid up to
        ``ready_rows()`` while generation runs, complete once it is done."""
        return IsotopePatternTable(
            sfs=self.sfs, adducts=self.adducts,
            mzs=self.mzs, ints=self.ints,
            n_valid=self.n_valid, targets=self.targets,
        )

    def result_table(self) -> "IsotopePatternTable":
        """Block until generation completes; return the packed table."""
        self._thread.join()
        with self._cond:
            if self._error is not None:
                raise self._error
        return self.table_view()

    def cancel(self) -> None:
        """Abort generation: stop submitting chunks, drop pending work,
        join the generator thread."""
        self._cancel.set()
        self._thread.join()

    # -- generation side -----------------------------------------------------

    def _fill_row_locked(self, row: int, mzs: np.ndarray,
                         ints: np.ndarray) -> None:
        k = min(mzs.size, self.mzs.shape[1])
        self.mzs[row, :k] = mzs[:k]
        self.ints[row, :k] = ints[:k]
        self.n_valid[row] = k
        self._row_done[row] = True

    def _advance_prefix_locked(self) -> None:
        r = self._ready_rows
        while r < self.n_ions and self._row_done[r]:
            r += 1
        self._ready_rows = r

    def _run(self) -> None:
        t0 = time.perf_counter()
        try:
            if self._chunks:
                with tracing.attach(self._trace), \
                        tracing.span("isocalc_gen", missing=self.n_missing,
                                     chunks=len(self._chunks)):
                    self._generate()
            with self.wrapper._lock:
                self.wrapper._maybe_compact()
        except BaseException as exc:  # noqa: BLE001 — consumer re-raises
            with self._cond:
                self._error = exc
                self._cond.notify_all()
            return
        self.gen_seconds = time.perf_counter() - t0
        if self.cold_patterns:
            self.patterns_per_s = self.cold_patterns / max(
                self.gen_seconds, 1e-9)
            _count_patterns(0, self.workers, self.patterns_per_s)
        self.wrapper.last_stats = dict(
            cold_patterns=self.cold_patterns,
            seconds=round(self.gen_seconds, 3),
            patterns_per_s=round(self.patterns_per_s, 2),
            workers=self.workers,
            device=self.wrapper.device_blur,
        )
        with self._cond:
            self._cond.notify_all()

    def _deliver(self, ci: int, outputs: list, records: list | None) -> None:
        """Commit one completed chunk: device-finish its segment outputs,
        then its cache shard, its table rows, the prefix; emit the worker's
        captured trace spans."""
        tracing.emit_records(records, tracing.current())
        entries: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        seg_ions = [(o[1], o[2]) for o in outputs if o[0] == "seg"]
        if seg_ions:
            finished = self.wrapper._device_stage().centroid_batch(
                [segs for _ion, segs in seg_ions])
            for (ion, _segs), (mzs, ints) in zip(seg_ions, finished):
                entries[ion] = (mzs, ints)
        for o in outputs:
            if o[0] == "pat":
                _kind, ion, mzs, ints = o
                entries[ion] = (mzs, ints)
        self.wrapper._commit_chunk_shard(self._job_tag, ci, entries)
        with self._cond:
            for ion, (mzs, ints) in entries.items():
                self._fill_row_locked(self._row_of[ion], mzs, ints)
            self._advance_prefix_locked()
            self._cond.notify_all()
        self.cold_patterns += len(entries)
        now = time.perf_counter()
        if now - self._t_last_log >= 5.0 or ci == len(self._chunks) - 1:
            rate = self.cold_patterns / max(now - self._t_gen0, 1e-9)
            logger.info(
                "isocalc: %d/%d patterns (%.1f patterns/s, %d workers)",
                self.cold_patterns, self.n_missing, rate, self.workers)
            self._t_last_log = now
        _count_patterns(len(entries), self.workers, self.cold_patterns
                        / max(now - self._t_gen0, 1e-9))

    def _generate(self) -> None:
        self._t_gen0 = self._t_last_log = time.perf_counter()
        wrapper = self.wrapper
        n_procs = wrapper.n_procs or int(os.environ.get(
            "SM_ISOCALC_PROCS", os.cpu_count() or 1))
        params = wrapper._params()
        device = wrapper.device_blur
        use_pool = self.n_missing >= _PARALLEL_THRESHOLD and n_procs > 1
        self.workers = n_procs if use_pool else 1
        buffered: dict[int, tuple] = {}
        next_ci = 0
        ctx = tracing.current()
        wire = ctx.to_wire() if ctx is not None else None

        def commit_ready() -> None:
            nonlocal next_ci
            while next_ci in buffered:
                outputs, records = buffered.pop(next_ci)
                self._deliver(next_ci, outputs, records)
                next_ci += 1

        if not use_pool:
            for ci, chunk in enumerate(self._chunks):
                if self._cancel.is_set():
                    return
                _ci, outputs, records = _compute_chunk(
                    (ci, chunk, params, device, wire))
                buffered[ci] = (outputs, records)
                commit_ready()
            return

        from concurrent.futures import ProcessPoolExecutor, as_completed
        from concurrent.futures.process import BrokenProcessPool
        from multiprocessing import get_context

        from ..utils import failpoints

        remaining = set(range(len(self._chunks)))
        spec = failpoints.active_spec()
        # spawn, not fork: the caller may hold CUDA state and threads
        for attempt in range(_POOL_ATTEMPTS):
            if not remaining or self._cancel.is_set():
                break
            ex = ProcessPoolExecutor(
                max_workers=min(n_procs, len(remaining)),
                mp_context=get_context("spawn"),
                initializer=_pool_init, initargs=(spec,))
            try:
                futs = {ex.submit(_compute_chunk,
                                  (ci, self._chunks[ci], params, device,
                                   wire)): ci
                        for ci in sorted(remaining)}
                for fut in as_completed(futs):
                    ci = futs[fut]
                    if self._cancel.is_set():
                        return
                    try:
                        _ci, outputs, records = fut.result()
                    except BrokenProcessPool:
                        # a worker died: every pending future is poisoned —
                        # rebuild the pool for what is left
                        record_recovery("isocalc.pool_broken")
                        logger.warning(
                            "isocalc pool broken with %d chunks left "
                            "(attempt %d); rebuilding",
                            len(remaining), attempt + 1)
                        break
                    except Exception:
                        record_recovery("isocalc.worker_retry")
                        logger.warning("isocalc chunk %d failed in a worker; "
                                       "will retry", ci, exc_info=True)
                        continue
                    remaining.discard(ci)
                    buffered[ci] = (outputs, records)
                    commit_ready()
            finally:
                ex.shutdown(wait=False, cancel_futures=True)
        # inline fallback for what the pool did not finish
        for ci in sorted(remaining):
            if self._cancel.is_set():
                return
            record_recovery("isocalc.chunk_inline")
            _ci, outputs, records = _compute_chunk(
                (ci, self._chunks[ci], params, device, wire))
            buffered[ci] = (outputs, records)
            commit_ready()


class IsocalcWrapper:
    """Same responsibility and knobs as the reference class of the same name.

    ``cache_dir`` (optional) persists computed patterns per parameter set in
    CRC32-checked shards, so only (formula, adduct) pairs missing from the
    cache are computed; ``n_procs`` caps the spawn pool (None = all cores;
    env ``SM_ISOCALC_PROCS``), ``chunk_size`` the pairs a chunk and shard
    (0 = 2048; env ``SM_ISOCALC_CHUNK``).  Without ``cache_dir`` patterns
    live in this wrapper's memory only.

    ``device_blur`` (None: env ``SM_ISOCALC_DEVICE=1`` opts in) routes the
    blur and centroid detection of every ion that fits the stage's caps
    through ``ops/isocalc_torch.py`` on the torch ``device`` (default
    ``"cuda"``; a CUDA device that is not there raises, with no fallback to
    the host oracle).  Device-mode patterns live under their own cache key,
    never mixed with the oracle's."""

    # guarded-by registry, the JAX package's own (tests hold the two equal):
    # the in-memory pattern cache + dirty set are shared between streams and
    # single-ion callers
    _GUARDED_BY = {"_cache": "_lock", "_dirty": "_lock"}

    _COMPACT_SHARDS = 64

    def __init__(self, cfg: IsotopeGenerationConfig,
                 cache_dir: str | Path | None = None,
                 n_procs: int | None = None,
                 device_blur: bool | None = None, chunk_size: int = 0,
                 device: str = "cuda"):
        self.cfg = cfg
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.n_procs = n_procs
        self.chunk_size = chunk_size
        if device_blur is None:
            device_blur = os.environ.get("SM_ISOCALC_DEVICE", "") not in (
                "", "0")
        self.device_blur = bool(device_blur)
        self.device = device
        self._device = None
        self._lock = threading.RLock()
        self._cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self._dirty: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        # stats of the last generation (workers, patterns/s)
        self.last_stats: dict = {}
        if self.cache_dir is not None:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
            self._sweep_stale_tmps()
            for path in self._shard_paths():
                # a concurrent compactor may unlink a shard between the glob
                # and the load; a crashed writer may leave a corrupt one
                try:
                    failpoint(FP_ISO_SHARD_LOAD, path=path)
                    self._cache.update(self._load_shard(path))
                except (zipfile.BadZipFile, ValueError, KeyError) as e:
                    # corrupt: recompute, and unlink the file
                    record_recovery("isocalc.corrupt_shard")
                    logger.warning(
                        "removing corrupt isocalc shard %s: %s", path, e)
                    path.unlink(missing_ok=True)
                except OSError as e:
                    # possibly transient: skip but keep the file
                    record_recovery("isocalc.unreadable_shard")
                    logger.warning(
                        "skipping unreadable isocalc shard %s: %s", path, e)

    def _sweep_stale_tmps(self, max_age_s: float = 3600.0) -> None:
        """Remove orphaned tmp files a crashed writer left behind (age-gated
        so a live concurrent writer's tmp survives)."""
        now = time.time()
        for p in self.cache_dir.glob("tmp_*.npz"):
            try:
                if now - p.stat().st_mtime > max_age_s:
                    p.unlink(missing_ok=True)
            except OSError:
                continue

    @staticmethod
    def _load_shard(path) -> dict:
        """{ion: (mzs, ints)} from one cache shard: stacked arrays and a
        CRC32 of the payload; shards without the crc member, and the legacy
        per-ion-member layout, still read."""
        out: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        with np.load(path, allow_pickle=False) as z:
            if "ions" in z.files:
                ions, lens = z["ions"], z["lens"]
                mzs, ints = z["mzs"], z["ints"]
                if "crc" in z.files and int(z["crc"]) != _entries_crc(
                        lens, mzs, ints):
                    raise ValueError("isocalc shard checksum mismatch")
                for i, ion in enumerate(ions):
                    ln = int(lens[i])
                    out[str(ion)] = (mzs[i, :ln].copy(), ints[i, :ln].copy())
            else:
                for k in z.files:
                    if k.endswith("/mzs"):
                        ion = k[: -len("/mzs")]
                        out[ion] = (z[k], z[ion + "/ints"])
        return out

    def _param_key(self) -> str:
        """The JAX package's key of the patterns' parameters.  Device-mode
        patterns agree with the oracle only to ~1e-5: they take their own
        namespace, a "dev" PREFIX (the shard glob is "theor_peaks_<key>*",
        which a suffixed key would still match)."""
        c = self.cfg
        blob = json.dumps(
            [c.charge, c.isocalc_sigma, c.isocalc_pts_per_mz, c.n_peaks],
            sort_keys=True)
        key = hashlib.sha256(blob.encode()).hexdigest()[:16]
        return f"dev{key}" if self.device_blur else key

    def _shard_paths(self) -> list[Path]:
        return sorted(self.cache_dir.glob(
            f"theor_peaks_{self._param_key()}*.npz"))

    @staticmethod
    def _stack_entries(entries: dict) -> dict[str, np.ndarray]:
        """Pack {ion: (mzs, ints)} into stacked arrays + a CRC32 of the
        payload."""
        ions = list(entries)
        width = max((entries[i][0].size for i in ions), default=1)
        n = len(ions)
        lens = np.zeros(n, dtype=np.int32)
        mzs = np.zeros((n, width), dtype=np.float64)
        ints = np.zeros((n, width), dtype=np.float64)
        for i, ion in enumerate(ions):
            m, t = entries[ion]
            lens[i] = m.size
            mzs[i, : m.size] = m
            ints[i, : t.size] = t
        return {"ions": np.array(ions), "lens": lens, "mzs": mzs, "ints": ints,
                "crc": np.int64(_entries_crc(lens, mzs, ints))}

    def _write_shard(self, shard: Path, entries: dict) -> None:
        """tmp savez -> failpoint seam -> atomic rename.  tmp names take a
        "tmp_" prefix so the constructor's "theor_peaks_*" glob never sees
        a half-written file.  Under disk pressure (``service/resources.py``)
        a cache shard is an optional write: past the cache floor it is
        skipped (the patterns stay in this process's memory and recompute
        next time), and the preflight guards the hard floor."""
        import uuid

        from ..service import resources as _resources

        if not _resources.allow_cache():
            return
        est = sum(m.nbytes + t.nbytes for m, t in entries.values()) + 8192
        _resources.preflight("isocalc.shard_save", est)
        tmp = self.cache_dir / f"tmp_{uuid.uuid4().hex[:8]}.npz"
        np.savez(tmp, **self._stack_entries(entries))
        failpoint(FP_ISO_SHARD_SAVE, path=tmp)
        os.replace(tmp, shard)

    def _commit_chunk_shard(self, job_tag: str, ci: int,
                            entries: dict) -> None:
        """Commit one chunk's patterns: memory + one incremental shard with
        a deterministic name."""
        with self._lock:
            self._cache.update(entries)
        if self.cache_dir is None or not entries:
            return
        shard = self.cache_dir / (
            f"theor_peaks_{self._param_key()}_{job_tag}_c{ci:05d}.npz")
        with self._lock:
            self._write_shard(shard, entries)

    def _maybe_compact(self) -> None:
        """Merge the shard files into one base file past the threshold
        (caller holds the lock); from the files, so shards another process
        wrote since this wrapper loaded are kept."""
        import uuid

        from ..service import resources as _resources

        if self.cache_dir is None or not _resources.allow_cache():
            return                    # disk pressure: defer compaction too
        shards = self._shard_paths()
        if len(shards) <= self._COMPACT_SHARDS:
            return
        merged: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        for path in shards:
            try:
                merged.update(self._load_shard(path))
            except Exception as exc:
                logger.debug("isocalc compact: skipping shard %s (%s)",
                             path.name, exc)
                continue
        merged.update(self._cache)
        base = self.cache_dir / f"theor_peaks_{self._param_key()}.npz"
        tmp = self.cache_dir / f"tmp_{uuid.uuid4().hex[:8]}.npz"
        np.savez(tmp, **self._stack_entries(merged))
        # replace base before unlinking shards: a kill in between loses no
        # entries
        os.replace(tmp, base)
        for s in shards:
            if s != base:
                s.unlink(missing_ok=True)

    def save_cache(self) -> None:
        """Persist entries from single-ion ``isotope_peaks`` calls as one
        incremental shard.  Table generation commits chunk shards
        instead."""
        import uuid

        with self._lock:
            if self.cache_dir is None or not self._dirty:
                return
            shard = self.cache_dir / (
                f"theor_peaks_{self._param_key()}_{uuid.uuid4().hex[:8]}.npz")
            self._write_shard(shard, self._dirty)
            self._dirty = {}
            self._maybe_compact()

    def _params(self) -> tuple:
        c = self.cfg
        return (c.charge, c.isocalc_sigma, c.isocalc_pts_per_mz, c.n_peaks)

    def _device_stage(self):
        """The lazy ``DeviceBlurCentroid`` (imports torch only in device
        mode, and only in this process: pool workers never reach it)."""
        if self._device is None:
            from .isocalc_torch import DeviceBlurCentroid

            self._device = DeviceBlurCentroid(*self._params(),
                                              device=self.device)
        return self._device

    def isotope_peaks(self, sf: str, adduct: str
                      ) -> tuple[np.ndarray, np.ndarray] | None:
        """Centroided (mzs, ints) for formula+adduct, or None if the
        chemistry is invalid (e.g. '-H' from an H-free formula).  Host
        oracle unless device mode is on."""
        ion = f"{sf}{adduct}"
        with self._lock:
            hit = self._cache.get(ion)
        if hit is not None:
            return hit
        try:
            counts = apply_adduct(parse_formula(sf), adduct)
        except FormulaError:
            return None
        segs = (fine_structure_segments(counts, *self._params())
                if self.device_blur else None)
        if segs is not None:
            peaks = self._device_stage().centroid_batch([segs])[0]
        else:
            peaks = centroids(counts, *self._params())
        with self._lock:
            self._cache[ion] = peaks
            self._dirty[ion] = peaks
        return peaks

    def stream_table(self, sf_adduct_pairs: list[tuple[str, str]],
                     target_flags: list[bool] | None = None
                     ) -> PatternStream:
        """Start generation; returns a running ``PatternStream`` at once."""
        return PatternStream(self, list(sf_adduct_pairs), target_flags)

    def pattern_table(self, sf_adduct_pairs: list[tuple[str, str]],
                      target_flags: list[bool] | None = None
                      ) -> IsotopePatternTable:
        """Compute or load the patterns of all pairs and pack them into
        fixed-shape arrays (duplicates keep their first occurrence, invalid
        chemistry is dropped, as in the reference).  Blocking form of
        ``stream_table``."""
        return self.stream_table(sf_adduct_pairs, target_flags).result_table()


def _entries_crc(lens: np.ndarray, mzs: np.ndarray, ints: np.ndarray) -> int:
    """CRC32 over the stacked payload (shard integrity check)."""
    crc = zlib.crc32(np.ascontiguousarray(lens).tobytes())
    crc = zlib.crc32(np.ascontiguousarray(mzs).tobytes(), crc)
    return zlib.crc32(np.ascontiguousarray(ints).tobytes(), crc)
