"""Dataset: ragged spectra in a flat CSR layout over the dense pixel grid.

Copy of ``sm_distributed_tpu/io/dataset.py``: spectra land in a flat CSR
layout over the dense pixel grid (empty pixels are empty rows), m/z-sorted
within each pixel, with the shared integer intensity grid
(``intensity_quantization``) that makes ion images bit-equal across
backends.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .imzml import ImzMLReader


@dataclass
class SpectralDataset:
    """Host-side dataset in flat-CSR-over-dense-pixel-grid layout."""

    nrows: int
    ncols: int
    pixel_inds: np.ndarray    # (n_spectra,) i64 — dense row-major pixel index per spectrum
    mask: np.ndarray          # (nrows, ncols) bool — sample-area mask (pixels with spectra)
    mzs_flat: np.ndarray      # (P,) f64 — all peaks, grouped by pixel, m/z-sorted per pixel
    ints_flat: np.ndarray     # (P,) f32
    row_ptr: np.ndarray       # (n_pixels+1,) i64 — CSR offsets over dense pixel grid

    @property
    def n_pixels(self) -> int:
        return self.nrows * self.ncols

    # -- order-free exact intensity grid (ops/quantize.py) ---------------

    def intensity_quantization(self, ppm: float) -> tuple[np.ndarray, float]:
        """(integer-valued f32 intensities, power-of-two scale) for ``ppm``.

        Both backends extract ion images from this shared grid, which makes
        image pixel values bit-identical regardless of summation order,
        backend, or shard count (the exact-FDR-rank requirement).  Cached
        per ppm.
        """
        from ..ops.quantize import intensity_scale, quantize_intensities

        cache = getattr(self, "_int_q_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_int_q_cache", cache)
        if ppm not in cache:
            pixel_of_peak = np.repeat(
                np.arange(self.n_pixels, dtype=np.int64), self.row_lengths())
            scale = intensity_scale(self.mzs_flat, self.ints_flat, pixel_of_peak, ppm)
            cache[ppm] = (quantize_intensities(self.ints_flat, scale), scale)
        return cache[ppm]

    @property
    def n_peaks(self) -> int:
        return int(self.mzs_flat.size)

    # -- construction ----------------------------------------------------

    @staticmethod
    def _pixel_grid(coords: np.ndarray, n_spectra: int):
        """(nrows, ncols, pixel_inds, mask) from raw scan coordinates.

        Pixel-order normalization mirrors the reference's
        ``_define_pixels_order`` [U]: coordinates are mapped through their
        sorted unique values (robust to offsets and uniform step sizes), and
        the dense pixel index is row-major ``row * ncols + col``.
        """
        coords = np.asarray(coords, dtype=np.int64)
        if coords.ndim != 2 or coords.shape[1] != 2 or coords.shape[0] != n_spectra:
            raise ValueError("coords must be (n_spectra, 2) matching spectra list")
        ux = np.unique(coords[:, 0])
        uy = np.unique(coords[:, 1])
        ncols, nrows = ux.size, uy.size
        col = np.searchsorted(ux, coords[:, 0])
        row = np.searchsorted(uy, coords[:, 1])
        pixel_inds = row * ncols + col
        if np.unique(pixel_inds).size != pixel_inds.size:
            raise ValueError("duplicate scan coordinates map to the same pixel")
        mask = np.zeros(nrows * ncols, dtype=bool)
        mask[pixel_inds] = True
        return nrows, ncols, pixel_inds, mask.reshape(nrows, ncols)

    @staticmethod
    def _row_ptr(n_pixels: int, pixel_inds: np.ndarray, lens: np.ndarray):
        counts = np.zeros(n_pixels, dtype=np.int64)
        counts[pixel_inds] = lens
        row_ptr = np.zeros(n_pixels + 1, dtype=np.int64)
        np.cumsum(counts, out=row_ptr[1:])
        return row_ptr

    @staticmethod
    def _sort_rows_inplace(mzs_flat, ints_flat, row_ptr) -> None:
        """Ensure ascending m/z within each CSR row, touching only rows that
        need it.  Centroided imzML stores m/z ascending in practice, so the
        vectorized violation scan usually finds nothing and this is O(N)
        with no extra copies (vs a full-array lexsort at ~2.5x N bytes)."""
        if mzs_flat.size < 2:
            return
        viol = mzs_flat[1:] < mzs_flat[:-1]
        # a drop across a row boundary is not a violation
        starts = row_ptr[1:-1]
        viol[starts[(starts > 0) & (starts < mzs_flat.size)] - 1] = False
        if not viol.any():
            return
        bad = np.unique(
            np.searchsorted(row_ptr, np.nonzero(viol)[0] + 1, side="right") - 1)
        for r in bad:
            s, e = row_ptr[r], row_ptr[r + 1]
            order = np.argsort(mzs_flat[s:e], kind="stable")
            mzs_flat[s:e] = mzs_flat[s:e][order]
            ints_flat[s:e] = ints_flat[s:e][order]

    @classmethod
    def from_imzml(cls, path: str | Path) -> "SpectralDataset":
        """STREAMING ingest: peak host memory stays ~(12 bytes x total peaks)
        plus one spectrum, instead of the eager build's ~4x that.

        The reference streams spectrum-by-spectrum through its converter and
        reader (``imzml_txt_converter``/``dataset_reader`` [U], SURVEY.md
        #4-5); a >200k-pixel DESI slide (BASELINE #5) can exceed host RAM
        under an eager whole-dataset materialization long before device memory
        matters.
        Here: pass 1 reads per-spectrum peak COUNTS from the XML metadata
        and preallocates the exact CSR arrays; pass 2 streams each
        spectrum's bytes directly into its CSR slot (no intermediate list,
        no concat, no full-array lexsort — per-row m/z order is verified
        and repaired only where violated)."""
        with ImzMLReader(path) as rd:
            lens = rd.spectrum_lengths()
            nrows, ncols, pixel_inds, mask = cls._pixel_grid(
                rd.coordinates, rd.n_spectra)
            row_ptr = cls._row_ptr(nrows * ncols, pixel_inds, lens)
            total = int(lens.sum())
            mzs_flat = np.empty(total, dtype=np.float64)
            ints_flat = np.empty(total, dtype=np.float32)
            for i in range(rd.n_spectra):
                m, t = rd.read_spectrum(i)
                s = row_ptr[pixel_inds[i]]
                if m.size != lens[i]:
                    raise ValueError(
                        f"spectrum {i}: ibd length {m.size} != XML metadata "
                        f"length {lens[i]}")
                mzs_flat[s : s + m.size] = m
                ints_flat[s : s + t.size] = t
            cls._sort_rows_inplace(mzs_flat, ints_flat, row_ptr)
            return cls(
                nrows=nrows,
                ncols=ncols,
                pixel_inds=pixel_inds,
                mask=mask,
                mzs_flat=mzs_flat,
                ints_flat=ints_flat,
                row_ptr=row_ptr,
            )

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def padded_cube(self, ints: np.ndarray | None = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Dense (n_pixels, L) m/z + intensity cube for the m/z-chunked cube
        path: (mz_cube f64, int_cube f32), the JAX package's default layout.

        m/z rows are padded with +inf (so searchsorted puts windows before the
        padding), intensities with 0.  L is the max spectrum length rounded up
        to a multiple of 128.  ``ints`` (one per peak, in ``mzs_flat`` order)
        replaces the raw intensities, e.g. with their integer-grid values.
        """
        lens = self.row_lengths()
        L = int(max(1, lens.max())) if lens.size else 1
        L = -(-L // 128) * 128
        mz_cube = np.full((self.n_pixels, L), np.inf, dtype=np.float64)
        int_cube = np.zeros((self.n_pixels, L), dtype=np.float32)
        pixel_of_peak = np.repeat(np.arange(self.n_pixels), lens)
        col_of_peak = np.arange(self.n_peaks) - np.repeat(self.row_ptr[:-1], lens)
        mz_cube[pixel_of_peak, col_of_peak] = self.mzs_flat
        int_cube[pixel_of_peak, col_of_peak] = (
            self.ints_flat if ints is None else ints)
        return mz_cube, int_cube
