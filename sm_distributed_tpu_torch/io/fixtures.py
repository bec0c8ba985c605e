"""Synthetic dataset generation — the offline stand-in for the reference's
test fixtures.  Port of ``sm_distributed_tpu/io/fixtures.py``: for the same
arguments ``generate_synthetic_dataset`` writes the same spectra (only the
random UUID of the imzML/ibd pair differs).  ``synthetic_dataset_arrays``
builds a dataset of the same recipe in memory with vectorised draws, for
sizes where writing and parsing imzML would dominate a run.

The reference tests against a bundled micro imzML dataset and the downloaded
"spheroid" scientific-regression dataset (SURVEY.md §4; BASELINE config #1).
With no network, we generate a procedural spheroid-like dataset with known
ground truth: a subset of target ions get spatially-structured signal
(informative images -> high measure_of_chaos), the rest and all decoys see
only noise -> the FDR ranking has a known right answer.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..ops.isocalc import IsocalcWrapper
from ..utils.config import IsotopeGenerationConfig
from .imzml import ImzMLWriter

# 50 plausible small-molecule sum formulas (metabolite-like, HMDB-style).
FIXTURE_FORMULAS: list[str] = [
    "C6H12O6", "C6H13NO2", "C5H9NO4", "C9H11NO2", "C3H7NO3",
    "C4H9NO3", "C5H11NO2", "C6H14N4O2", "C6H9N3O2", "C11H12N2O2",
    "C4H7NO4", "C5H5N5", "C5H5N5O", "C10H13N5O4", "C10H13N5O5",
    "C9H13N3O5", "C10H12N2O6", "C4H6O5", "C4H6O4", "C6H8O7",
    "C3H4O3", "C4H4O4", "C5H8O5", "C7H6O2", "C7H8N4O2",
    "C8H10N4O2", "C10H16N5O13P3", "C10H15N5O10P2", "C10H14N5O7P", "C21H27N7O14P2",
    "C16H32O2", "C18H36O2", "C18H34O2", "C18H32O2", "C20H32O2",
    "C5H11O8P", "C6H13O9P", "C3H9O6P", "C8H20NO6P", "C5H14NO4P",
    "C23H38N7O17P3S", "C9H16O4", "C24H50NO7P", "C26H54NO7P", "C42H82NO8P",
    "C40H80NO8P", "C44H84NO8P", "C27H46O", "C19H28O2", "C18H24O2",
]


def expand_formula_list(n: int) -> list[str]:
    """Deterministic list of ``n`` plausible CHNO sum formulas for scale
    benchmarks (BASELINE configs #2/#3 need thousands of ions; the bundled
    50-formula fixture alone underfills a 1024-ion batch)."""
    out = list(dict.fromkeys(FIXTURE_FORMULAS))
    c, h_off, nn, o = 7, 0, 0, 2
    while len(out) < n:
        h = c + 2 - h_off % 5 + nn
        sf = f"C{c}H{max(2, h)}" + (f"N{nn}" if nn else "") + (f"O{o}" if o else "")
        if sf not in out:
            out.append(sf)
        # walk composition space deterministically
        c += 1
        if c > 40:
            c = 7
            o += 1
            if o > 12:
                o = 0
                nn += 1
            h_off += 1
    return out[:n]


@dataclass
class SyntheticGroundTruth:
    formulas: list[str]          # all target formulas written to the mol DB
    present: list[str]           # subset given real spatial signal
    adduct: str
    nrows: int
    ncols: int


def _spatial_pattern(kind: int, nrows: int, ncols: int, rng: np.random.Generator) -> np.ndarray:
    """An informative (spatially structured) intensity image in [0, 1]."""
    yy, xx = np.mgrid[0:nrows, 0:ncols]
    cy, cx = nrows / 2, ncols / 2
    r = np.hypot(yy - cy, xx - cx) / (min(nrows, ncols) / 2)
    if kind % 3 == 0:       # filled blob (spheroid core)
        img = np.clip(1.0 - r, 0, 1) ** 1.5
    elif kind % 3 == 1:     # ring (spheroid rim)
        img = np.exp(-(((r - 0.6) / 0.15) ** 2))
    else:                   # half-gradient (polarized tissue)
        img = np.clip(xx / ncols + 0.1 * np.sin(yy / 3), 0, 1)
    img = img * (0.8 + 0.4 * rng.random(img.shape))  # mild multiplicative noise
    return img / img.max()


def _signal_patterns(formulas, present_fraction: float, adduct: str,
                     nrows: int, ncols: int, rng: np.random.Generator):
    """The present formulas (drawn from ``rng``), and for each of them with
    an isotope pattern its (mzs, ints) peaks and its spatial image."""
    calc = IsocalcWrapper(IsotopeGenerationConfig(adducts=(adduct,)),
                          n_procs=1)
    n_present = max(1, int(round(present_fraction * len(formulas))))
    present = list(rng.permutation(formulas)[:n_present])
    patterns = {}
    images = {}
    for i, sf in enumerate(present):
        peaks = calc.isotope_peaks(sf, adduct)
        if peaks is None:
            continue
        patterns[sf] = peaks
        images[sf] = _spatial_pattern(i, nrows, ncols, rng)
    return present, patterns, images


def generate_synthetic_dataset(
    out_dir: str | Path,
    nrows: int = 32,
    ncols: int = 32,
    formulas: list[str] | None = None,
    present_fraction: float = 0.6,
    adduct: str = "+H",
    noise_peaks: int = 200,
    mz_jitter_ppm: float = 0.5,
    seed: int = 7,
    name: str = "synthetic_spheroid",
) -> tuple[Path, SyntheticGroundTruth]:
    """Write a processed-mode imzML/ibd pair with known ground truth.

    Returns (imzml_path, ground_truth).  ``present_fraction`` of the formulas
    receive structured spatial signal at their theoretical isotope m/z values
    (intensities following the theoretical envelope); everything else only
    ever matches background noise.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    formulas = list(formulas if formulas is not None else FIXTURE_FORMULAS)
    present, patterns, images = _signal_patterns(
        formulas, present_fraction, adduct, nrows, ncols, rng)

    imzml_path = out_dir / f"{name}.imzML"
    mz_lo, mz_hi = 80.0, 1000.0
    with ImzMLWriter(imzml_path, continuous=False) as wr:
        for y in range(nrows):
            for x in range(ncols):
                mzs_parts = []
                ints_parts = []
                for sf, (pk_mzs, pk_ints) in patterns.items():
                    a = images[sf][y, x]
                    if a <= 0.02:
                        continue
                    jitter = 1.0 + mz_jitter_ppm * 1e-6 * rng.standard_normal(pk_mzs.size)
                    mzs_parts.append(pk_mzs * jitter)
                    ints_parts.append(a * pk_ints * (0.9 + 0.2 * rng.random(pk_ints.size)))
                # background noise: uniform random m/z, exponential intensity
                noise_mz = rng.uniform(mz_lo, mz_hi, size=noise_peaks)
                noise_int = rng.exponential(2.0, size=noise_peaks).astype(np.float64)
                mzs_parts.append(noise_mz)
                ints_parts.append(noise_int)
                mzs = np.concatenate(mzs_parts)
                ints = np.concatenate(ints_parts)
                order = np.argsort(mzs)
                # imzML scan positions are conventionally 1-based
                wr.add_spectrum(x + 1, y + 1, mzs[order], ints[order])

    truth = SyntheticGroundTruth(
        formulas=formulas, present=present, adduct=adduct, nrows=nrows, ncols=ncols
    )
    return imzml_path, truth


def _pixel_mz_order(pix: np.ndarray, mzs: np.ndarray, counts: np.ndarray,
                    row_ptr: np.ndarray) -> np.ndarray:
    """``np.lexsort((mzs, pix))``, ties included, in a fraction of its time
    at whole-slide sizes: a stable sort by pixel (``pix`` is a few sorted
    runs), then a stable sort of each pixel's m/z row, padded with +inf."""
    by_pix = np.argsort(pix, kind="stable")
    width = int(counts.max()) if counts.size else 0
    slot = np.arange(pix.size) - np.repeat(row_ptr[:-1], counts)
    rows = np.full((counts.size, width), np.inf)
    rows[pix[by_pix], slot] = mzs[by_pix]
    within = np.argsort(rows, axis=1, kind="stable")
    del rows
    real = np.arange(width)[None, :] < counts[:, None]
    return by_pix[(within + row_ptr[:-1, None])[real]]


def synthetic_dataset_arrays(
    nrows: int = 32,
    ncols: int = 32,
    formulas: list[str] | None = None,
    present_fraction: float = 0.6,
    adduct: str = "+H",
    noise_peaks: int = 200,
    mz_jitter_ppm: float = 0.5,
    seed: int = 7,
):
    """``(SpectralDataset, SyntheticGroundTruth)`` built in memory.

    The recipe of ``generate_synthetic_dataset`` — the same present set and
    spatial patterns from the same seed, signal peaks at the theoretical
    isotope m/z with ppm jitter and envelope-shaped intensities wherever a
    pattern exceeds 0.02, ``noise_peaks`` uniform-m/z exponential-intensity
    noise peaks in every pixel — with the per-pixel draws vectorised (so the
    random numbers, though not their distribution, differ from the imzML
    writer's; the present set and the spatial patterns are the same).
    m/z is f64 and intensity f32, as the imzML round trip
    stores them."""
    from .dataset import SpectralDataset

    rng = np.random.default_rng(seed)
    formulas = list(formulas if formulas is not None else FIXTURE_FORMULAS)
    present, patterns, images = _signal_patterns(
        formulas, present_fraction, adduct, nrows, ncols, rng)
    n_pix = nrows * ncols
    pix_parts, mz_parts, int_parts = [], [], []
    for sf, (pk_mzs, pk_ints) in patterns.items():
        amp = images[sf].ravel()
        px = np.nonzero(amp > 0.02)[0]
        k = pk_mzs.size
        jitter = 1.0 + mz_jitter_ppm * 1e-6 * rng.standard_normal((px.size, k))
        fac = 0.9 + 0.2 * rng.random((px.size, k))
        pix_parts.append(np.repeat(px, k))
        mz_parts.append((pk_mzs[None, :] * jitter).ravel())
        int_parts.append((amp[px, None] * pk_ints[None, :] * fac).ravel())
    pix_parts.append(np.repeat(np.arange(n_pix), noise_peaks))
    mz_parts.append(rng.uniform(80.0, 1000.0, size=n_pix * noise_peaks))
    int_parts.append(rng.exponential(2.0, size=n_pix * noise_peaks))
    pix = np.concatenate(pix_parts)
    mzs = np.concatenate(mz_parts)
    ints = np.concatenate(int_parts).astype(np.float32)
    counts = np.bincount(pix, minlength=n_pix)
    row_ptr = np.zeros(n_pix + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    order = _pixel_mz_order(pix, mzs, counts, row_ptr)
    ds = SpectralDataset(
        nrows=nrows, ncols=ncols,
        pixel_inds=np.arange(n_pix, dtype=np.int64),
        mask=np.ones((nrows, ncols), dtype=bool),
        mzs_flat=mzs[order], ints_flat=ints[order], row_ptr=row_ptr)
    truth = SyntheticGroundTruth(formulas=formulas, present=present,
                                 adduct=adduct, nrows=nrows, ncols=ncols)
    return ds, truth
