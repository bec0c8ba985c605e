"""Ion-image extraction, NumPy reference (the ``numpy_ref`` backend).

Copy of ``sm_distributed_tpu/ops/imager_np.py``: the reference sorts each
m/z segment's (pixel, mz, int) triples by m/z and, per theoretical peak,
takes the contiguous [searchsorted(lo), searchsorted(hi)) slice, then
shuffles hits into per-ion images.  This backend keeps that exact
semantics: one global m/z sort, two vectorized searchsorteds for ALL
windows at once, and a bincount scatter-add per window.

The ppm window matches the reference: [mz*(1-ppm*1e-6), mz*(1+ppm*1e-6)],
lower bound inclusive, upper bound exclusive ('left'/'left' sides).
"""

from __future__ import annotations

import numpy as np

from dataclasses import dataclass

from ..io.dataset import SpectralDataset
from .isocalc import IsotopePatternTable
from .quantize import quantize_mz, quantize_window


@dataclass
class SortedPeakView:
    """Once-per-dataset prep: all dataset peaks globally m/z-sorted on the
    quantized grid (the reference's per-segment sort, unsegmented).  Built
    once and reused across formula batches."""

    n_pixels: int
    g_mzs_q: np.ndarray        # (P,) int32, ascending
    g_ints: np.ndarray         # (P,) f32 — integer-valued when ppm given
    pixel_of_peak: np.ndarray  # (P,) i64 — dense pixel index per sorted peak
    int_scale: float = 1.0     # power-of-two intensity-grid scale

    @classmethod
    def prepare(cls, ds: SpectralDataset, ppm: float | None = None) -> "SortedPeakView":
        """With ``ppm`` given, intensities come from the shared integer grid
        (ds.intensity_quantization) — bit-identical images vs the
        torch_cuda backend under any summation order.  Without it, raw
        intensities (legacy)."""
        if ppm is not None:
            ints, scale = ds.intensity_quantization(ppm)
        else:
            ints, scale = ds.ints_flat, 1.0
        g_mzs_q_unsorted = quantize_mz(ds.mzs_flat)
        order = np.argsort(g_mzs_q_unsorted, kind="stable")
        pixel_of_peak = np.repeat(
            np.arange(ds.n_pixels, dtype=np.int64), ds.row_lengths()
        )[order]
        return cls(
            n_pixels=ds.n_pixels,
            g_mzs_q=g_mzs_q_unsorted[order],
            g_ints=ints[order],
            pixel_of_peak=pixel_of_peak,
            int_scale=scale,
        )


def extract_ion_images(
    source: SpectralDataset | SortedPeakView,
    table: IsotopePatternTable,
    ppm: float,
) -> np.ndarray:
    """Dense ion images: (n_ions, max_peaks, n_pixels) float32.

    Matching happens on the shared quantized m/z grid (ops/quantize.py) so the
    hit set is exactly the torch_cuda backend's, and intensities on the shared
    integer grid so pixel SUMS are bit-identical too (order-free; see
    ops/quantize.py).  Output images are de-quantized back to raw units (an
    exact power-of-two division).  Padded (invalid) isotope peaks yield
    all-zero images, like the reference's missing sparse matrices.  Pass a
    prebuilt SortedPeakView when scoring many batches.
    """
    view = (source if isinstance(source, SortedPeakView)
            else SortedPeakView.prepare(source, ppm))

    lo, hi = quantize_window(table.mzs, ppm)
    start = np.searchsorted(view.g_mzs_q, lo.ravel(), side="left").reshape(lo.shape)
    end = np.searchsorted(view.g_mzs_q, hi.ravel(), side="left").reshape(hi.shape)

    n_ions, max_peaks = table.mzs.shape
    images = np.zeros((n_ions, max_peaks, view.n_pixels), dtype=np.float32)
    valid = np.arange(max_peaks)[None, :] < table.n_valid[:, None]
    for i in range(n_ions):
        for k in range(max_peaks):
            if not valid[i, k]:
                continue
            s, e = start[i, k], end[i, k]
            if e > s:
                images[i, k] = np.bincount(
                    view.pixel_of_peak[s:e], weights=view.g_ints[s:e],
                    minlength=view.n_pixels,
                ).astype(np.float32)
    if view.int_scale != 1.0:
        images /= np.float32(view.int_scale)   # exact: scale is a power of two
    return images
