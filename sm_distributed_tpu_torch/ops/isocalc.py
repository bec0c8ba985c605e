"""Theoretical isotope patterns (the reference's IsocalcWrapper).

Port of ``sm_distributed_tpu/ops/isocalc.py``: exact isotopic fine
structure, gaussian blur at instrument resolution (``isocalc_sigma``,
``isocalc_pts_per_mz``), centroid detection and the top ``n_peaks``
centroids per (formula, adduct), intensities normalized to max 100.  The
per-pattern math (``fine_structure``, ``centroids``) is a copy and gives the
same bits.  ``IsocalcWrapper`` keeps an in-memory cache and, for long
work-lists, a spawn process pool; the JAX package's on-disk shard cache,
pattern stream and device blur stage are not part of this port.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import elements
from .formula import FormulaError, apply_adduct, parse_formula
from ..utils.config import IsotopeGenerationConfig

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


# pairs below this count are computed inline (pool startup isn't worth it)
_PARALLEL_THRESHOLD = 256
# (formula, adduct) pairs per pool task
_CHUNK = 512


def _compute_chunk(args) -> list[tuple[np.ndarray, np.ndarray]]:
    """Patterns of one chunk of pre-validated (sf, adduct) pairs (module
    level so spawned pool workers can import it)."""
    pairs, (charge, sigma, pts_per_mz, n_peaks) = args
    return [centroids(apply_adduct(parse_formula(sf), adduct), charge, sigma,
                      pts_per_mz, n_peaks)
            for sf, adduct in pairs]


class IsocalcWrapper:
    """Same responsibility and knobs as the reference class of the same name.

    ``n_procs`` caps the spawn process pool used for work-lists of at least
    256 missing patterns (None = all cores); smaller lists compute inline.
    Patterns are cached in memory per wrapper."""

    def __init__(self, cfg: IsotopeGenerationConfig, n_procs: int | None = None):
        self.cfg = cfg
        self.n_procs = n_procs
        self._lock = threading.Lock()
        self._cache: dict[str, tuple[np.ndarray, np.ndarray]] = {}

    def _params(self) -> tuple:
        c = self.cfg
        return (c.charge, c.isocalc_sigma, c.isocalc_pts_per_mz, c.n_peaks)

    def isotope_peaks(self, sf: str, adduct: str
                      ) -> tuple[np.ndarray, np.ndarray] | None:
        """Centroided (mzs, ints) for formula+adduct, or None if the
        chemistry is invalid (e.g. '-H' from an H-free formula)."""
        ion = f"{sf}{adduct}"
        with self._lock:
            hit = self._cache.get(ion)
        if hit is not None:
            return hit
        try:
            counts = apply_adduct(parse_formula(sf), adduct)
        except FormulaError:
            return None
        peaks = centroids(counts, *self._params())
        with self._lock:
            self._cache[ion] = peaks
        return peaks

    def _compute_missing(self, missing: list[tuple[str, str]]) -> None:
        chunks = [missing[s:s + _CHUNK] for s in range(0, len(missing), _CHUNK)]
        params = self._params()
        n_procs = self.n_procs or os.cpu_count() or 1
        if len(missing) >= _PARALLEL_THRESHOLD and n_procs > 1:
            from concurrent.futures import ProcessPoolExecutor
            from multiprocessing import get_context

            # spawn, not fork: the caller may hold CUDA state and threads
            with ProcessPoolExecutor(max_workers=min(n_procs, len(chunks)),
                                     mp_context=get_context("spawn")) as ex:
                results = list(ex.map(_compute_chunk,
                                      [(c, params) for c in chunks]))
        else:
            results = [_compute_chunk((c, params)) for c in chunks]
        with self._lock:
            for chunk, peaks in zip(chunks, results):
                for (sf, ad), pk in zip(chunk, peaks):
                    self._cache[f"{sf}{ad}"] = pk

    def pattern_table(
        self,
        sf_adduct_pairs: list[tuple[str, str]],
        target_flags: list[bool] | None = None,
    ) -> IsotopePatternTable:
        """Compute the patterns of all pairs and pack them into fixed-shape
        arrays.  Duplicate pairs keep their first occurrence and
        invalid-chemistry ions are dropped, as in the reference."""
        pairs = list(sf_adduct_pairs)
        flags = [True] * len(pairs) if target_flags is None else target_flags
        seen: set[tuple[str, str]] = set()
        sfs: list[str] = []
        adducts: list[str] = []
        targets: list[bool] = []
        for (sf, adduct), flag in zip(pairs, flags):
            if (sf, adduct) in seen:
                continue
            seen.add((sf, adduct))
            try:
                apply_adduct(parse_formula(sf), adduct)
            except FormulaError:
                continue
            sfs.append(sf)
            adducts.append(adduct)
            targets.append(flag)
        with self._lock:
            missing = [(sf, ad) for sf, ad in zip(sfs, adducts)
                       if f"{sf}{ad}" not in self._cache]
        if missing:
            self._compute_missing(missing)
        n, k = len(sfs), self.cfg.n_peaks
        mzs = np.zeros((n, k))
        ints = np.zeros((n, k))
        n_valid = np.zeros(n, dtype=np.int32)
        with self._lock:
            for row, (sf, ad) in enumerate(zip(sfs, adducts)):
                pk_mzs, pk_ints = self._cache[f"{sf}{ad}"]
                m = min(pk_mzs.size, k)
                mzs[row, :m] = pk_mzs[:m]
                ints[row, :m] = pk_ints[:m]
                n_valid[row] = m
        return IsotopePatternTable(sfs=sfs, adducts=adducts, mzs=mzs,
                                   ints=ints, n_valid=n_valid,
                                   targets=np.array(targets, dtype=bool))
