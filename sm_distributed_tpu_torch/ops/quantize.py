"""m/z and intensity quantization: the shared grids that make scoring exact.

Copy of the host half of ``sm_distributed_tpu/ops/quantize.py``.  m/z values
and ppm-window bounds are quantized to int32 units of 1e-5 Da before
matching, identically in every backend, so hit sets agree by construction.
Intensities snap to an integer grid scaled by a power of two so that every
per-(pixel, window) sum stays below 2**24: f32 sums are then exact in any
order (scatter-add atomics, matmul accumulation), which is what makes ion
images bit-equal across backends and devices.

int32 ceiling: 2**31 * 1e-5 = 21474 Da, far above any MS m/z range.
"""

from __future__ import annotations

import numpy as np

MZ_SCALE = 1e5  # quantization steps per Da
MZ_MAX = (2**31 - 2) / MZ_SCALE
# padding sentinel for m/z cubes: larger than any real quantized m/z
MZ_PAD_Q = np.int32(2**31 - 1)


def quantize_mz(mz: np.ndarray) -> np.ndarray:
    """Host-side f64 -> int32 grid. Values beyond MZ_MAX (incl. +inf padding)
    saturate to the padding sentinel."""
    mz = np.asarray(mz, dtype=np.float64)
    q = np.rint(mz * MZ_SCALE)
    return np.where(q >= MZ_PAD_Q, MZ_PAD_Q, q).astype(np.int32)


def quantize_window(mzs: np.ndarray, ppm: float) -> tuple[np.ndarray, np.ndarray]:
    """ppm windows [mz*(1-ppm*1e-6), mz*(1+ppm*1e-6)) on the quantized grid.
    Computed in f64 on host, identically in both backends."""
    mzs = np.asarray(mzs, dtype=np.float64)
    lo = quantize_mz(mzs * (1.0 - ppm * 1e-6))
    hi = quantize_mz(mzs * (1.0 + ppm * 1e-6))
    return lo, hi


# -- intensity quantization: order-free exact accumulation --------------------
#
# Ion-image pixel values are sums of peak intensities.  Summation order on an
# accelerator (atomic scatter-adds, matmul accumulation) is implementation-
# defined, so f32 sums of arbitrary floats are NOT reproducible across backends or shard
# counts.  The fix is structural: snap intensities to an integer grid scaled
# so that every per-(pixel, window) sum stays below 2**24 — every partial sum
# is then an exactly-representable f32 integer and ANY summation order yields
# the same bits.  The scale is a power of two, so de-quantization (a
# division by 2**k) is also exact in f32 and all MSM metrics — which are
# scale-invariant (chaos thresholds relative to vmax; correlation and
# pattern match are cosines) — see identical values either way.

INT_SUM_BITS = 24  # f32 exact-integer range


def intensity_scale(
    mzs_flat: np.ndarray,      # (P,) f64, m/z per peak, sorted within pixel
    ints_flat: np.ndarray,     # (P,) intensities
    pixel_of_peak: np.ndarray,  # (P,) pixel index per peak (non-decreasing)
    ppm: float,
) -> float:
    """Power-of-two scale 2**k such that hmax * max(rint(i*2**k)) < 2**24,
    where hmax bounds the peak count inside any ppm window of any pixel."""
    if ints_flat.size == 0:
        return 1.0
    max_raw = float(np.max(ints_flat))
    if max_raw <= 0:
        return 1.0
    # exact per-pixel sliding-window occupancy on the quantized m/z grid:
    # key = pixel * 2**32 + mz_q is globally ascending; a window never spans
    # the 2**32 inter-pixel gap
    mz_q = quantize_mz(mzs_flat).astype(np.int64)
    key = pixel_of_peak.astype(np.int64) * (1 << 32) + mz_q
    # generous window bound (2.5x ppm covers any window whose left edge is
    # at this peak, including the center-to-edge asymmetry)
    width = np.ceil(np.asarray(mzs_flat, np.float64)
                    * (2.5 * ppm * 1e-6) * MZ_SCALE).astype(np.int64)
    hi = np.searchsorted(key, key + width, side="right")
    hmax = int(np.max(hi - np.arange(key.size)))
    target = (2**INT_SUM_BITS - 1) / (max(hmax, 1) + 1) / max_raw
    return float(2.0 ** np.floor(np.log2(target)))


def quantize_intensities(ints_flat: np.ndarray, scale: float) -> np.ndarray:
    """Snap to the integer grid; values stay integer-valued float32."""
    return np.rint(np.asarray(ints_flat, np.float64) * scale).astype(np.float32)
