"""MSM metrics, NumPy reference (the ``numpy_ref`` backend).

Copy of ``sm_distributed_tpu/ops/metrics_np.py``, the f64 oracle the device
chain is held against: per ion,

- ``measure_of_chaos(img, nlevels)`` -- spatial informativeness: 1 minus
  the mean 4-connected component count (``scipy.ndimage.label``) of the
  principal image thresholded at ``nlevels`` levels, normalized by the
  nonzero-pixel count;
- ``isotope_image_correlation(imgs, weights)`` -- intensity-weighted mean
  Pearson correlation between the principal image and each higher-isotope
  image;
- ``isotope_pattern_match(imgs_total_ints, theor_ints)`` -- cosine
  agreement between the theoretical and observed total-intensity isotope
  envelopes.

MSM = chaos * spatial * spectral.  Optional hot-spot removal first: clip
each image at its q-th percentile of positive values
(``do_preprocessing``/``q``).  ``hotspot_percentile_f32`` is the
cross-backend definition of that cutoff; the port keeps this one copy of
it, which ``ops/metrics.py`` imports.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

# 4-connectivity (cross) — scipy.ndimage.label default, matches the reference.
_STRUCTURE4 = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=int)


def hotspot_percentile_f32(pos_sorted: np.ndarray, q: float) -> np.float32:
    """q-th linear-interpolated percentile of the sorted positive pixels,
    computed as a fixed sequence of SINGLE f32 operations.

    This sequence is the cross-backend DEFINITION of the hotspot cutoff:
    every step is either exact in f32 (floor, fraction < 2**23, differences
    of grid integers) or one correctly-rounded IEEE op, so numpy here and
    ``ops/metrics.hotspot_clip_batch`` on the card produce the same bits;
    and because image values are integers times a power-of-two scale
    (ops/quantize.py), the arithmetic commutes with the scale — the device
    chain computes it in quantized units, this oracle in raw units, and the
    clipped images still match bit for bit."""
    m = pos_sorted.size
    t = np.float32(q) / np.float32(100.0)
    pos = t * np.float32(m - 1)                   # one rounded mul
    lo = np.floor(pos)                            # exact
    frac = np.float32(pos - lo)                   # exact (pos < 2**23)
    i_lo = int(lo)
    v_lo = np.float32(pos_sorted[i_lo])
    v_hi = np.float32(pos_sorted[min(i_lo + 1, m - 1)])
    prod = np.float32(v_hi - v_lo) * frac         # exact diff, one mul
    return v_lo + prod                            # one rounded add


def hotspot_clip(img: np.ndarray, q: float = 99.0) -> np.ndarray:
    """Hot-spot removal (``image_generation.do_preprocessing``): clip at the
    q-th percentile of the positive pixels; no-op on empty images."""
    pos = np.sort(img[img > 0])
    if pos.size == 0:
        return img
    return np.minimum(img, hotspot_percentile_f32(pos, q))


def measure_of_chaos(img: np.ndarray, nlevels: int = 30) -> float:
    """Spatial chaos of a 2-D image in [0, 1]; 0 for empty images.

    Thresholds: ``nlevels`` levels evenly spaced in (0, max) — level i is
    ``vmax * i/nlevels`` (level 0 counts the support's components).
    Connectivity: 4-neighbour.

    The threshold grid and the final mean/normalize arithmetic are computed
    in float32, mirroring the device chain bit for bit: at integer-grid image
    magnitudes (up to 2**24) the f32/f64 threshold representations can differ
    by ~0.5, enough to flip a mask pixel — the f32 grid is the definition,
    in both backends (exact-FDR-rank requirement).
    """
    img = np.nan_to_num(np.asarray(img, dtype=np.float32))
    img = np.where(img > 0, img, np.float32(0.0))
    vmax = np.float32(img.max())
    n_notnull = int((img > 0).sum())
    if vmax <= 0 or n_notnull == 0:
        return 0.0
    count_sum = 0
    for i in range(nlevels):
        lev = vmax * (np.float32(i) / np.float32(nlevels))
        _, n = ndimage.label(img > lev, structure=_STRUCTURE4)
        count_sum += n
    # single division, mirroring the device chain (ops/metrics.py: a
    # reciprocal multiply would drift by an ulp)
    chaos = np.float32(1.0) - np.float32(count_sum) / np.float32(
        nlevels * max(n_notnull, 1))
    return float(np.clip(chaos, np.float32(0.0), np.float32(1.0)))


def isotope_image_correlation(
    images_flat: np.ndarray, weights: np.ndarray
) -> float:
    """Weighted mean Pearson correlation of higher-isotope images vs the
    principal image.  ``images_flat``: (n_peaks, n_pixels); ``weights``:
    theoretical intensities of peaks 1..n-1 (reference passes
    ``theor_ints[1:]``).  NaN correlations (constant images) count as 0;
    result clipped to [0, 1]."""
    images_flat = np.asarray(images_flat, dtype=np.float64)
    n_peaks = images_flat.shape[0]
    if n_peaks < 2:
        return 0.0
    base = images_flat[0]
    corrs = np.zeros(n_peaks - 1)
    bc = base - base.mean()
    bn = np.sqrt((bc * bc).sum())
    for k in range(1, n_peaks):
        x = images_flat[k]
        xc = x - x.mean()
        xn = np.sqrt((xc * xc).sum())
        if bn > 0 and xn > 0:
            corrs[k - 1] = (bc * xc).sum() / (bn * xn)
    weights = np.asarray(weights, dtype=np.float64)[: n_peaks - 1]
    wsum = weights.sum()
    if wsum <= 0:
        return 0.0
    return float(np.clip((corrs * weights).sum() / wsum, 0.0, 1.0))


def isotope_pattern_match(
    image_total_ints: np.ndarray, theor_ints: np.ndarray
) -> float:
    """Cosine similarity between observed total-intensity envelope and the
    theoretical envelope, in [0, 1]; 0 if either is empty."""
    obs = np.asarray(image_total_ints, dtype=np.float64)
    theor = np.asarray(theor_ints, dtype=np.float64)
    on = np.linalg.norm(obs)
    tn = np.linalg.norm(theor)
    if on == 0 or tn == 0:
        return 0.0
    return float(np.clip(np.dot(obs, theor) / (on * tn), 0.0, 1.0))


def ion_metrics(
    images: np.ndarray,
    theor_ints: np.ndarray,
    n_valid: int,
    nrows: int,
    ncols: int,
    nlevels: int = 30,
    do_preprocessing: bool = False,
    q: float = 99.0,
) -> tuple[float, float, float, float]:
    """(chaos, spatial, spectral, msm) for one ion.

    ``images``: (max_peaks, n_pixels) dense; only the first ``n_valid`` rows
    are real isotope peaks: the reference's per-ion metric function.
    """
    imgs = images[:n_valid].astype(np.float64)
    if n_valid == 0 or imgs[0].max() <= 0:
        return 0.0, 0.0, 0.0, 0.0
    if do_preprocessing:
        imgs = np.stack([hotspot_clip(im, q) for im in imgs])
    chaos = measure_of_chaos(imgs[0].reshape(nrows, ncols), nlevels)
    spatial = isotope_image_correlation(imgs, weights=theor_ints[1:n_valid])
    spectral = isotope_pattern_match(imgs.sum(axis=1), theor_ints[:n_valid])
    msm = chaos * spatial * spectral
    return chaos, spatial, spectral, msm
