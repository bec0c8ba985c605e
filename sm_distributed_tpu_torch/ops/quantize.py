"""m/z and intensity quantization: the shared grids that make scoring exact.

Copy of the host half of ``sm_distributed_tpu/ops/quantize.py``, with the
resident-cube compaction (``compact_cube`` / ``expand_cube``) and its device
expansion in torch (``expand_cube_range`` / ``expand_cube_at``).  m/z values
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
import torch

from ..analysis.numerics import numerics_surface

# Numerics contracts (analysis/numerics.py), the JAX package's.  bf16
# compaction rounds the integer grid to 8 significant bits: the drift from
# the f32 cube is data-level, hence the wide contract; what it must keep
# is the FDR ranking, identical on the sentinel fixture
# (drivers/ulp_sentinel.py, whose measure the named test runs).
NUMERICS = numerics_surface(__name__, {
    "quantize_mz":
        "contract=bit_exact; test=tests/test_torch_numerics.py::"
        "test_quantize_sites_equal_the_jax_packages",
    "quantize_window":
        "contract=bit_exact; test=tests/test_torch_host.py::"
        "test_quantize_window",
    "quantize_intensities":
        "contract=bit_exact; test=tests/test_torch_numerics.py::"
        "test_quantize_sites_equal_the_jax_packages",
    "intensity_scale":
        "contract=bit_exact; test=tests/test_torch_numerics.py::"
        "test_quantize_sites_equal_the_jax_packages",
    "compact_cube":
        "contract=ulp(4096); test=tests/test_torch_ulp_sentinel.py::"
        "test_measure_on_the_cpu_matches_the_jax_side",
    "expand_cube_range":
        "contract=bit_exact; test=tests/test_torch_cube_dtype.py::"
        "test_device_expansion_matches_host",
})

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


# -- resident-cube compaction (parallel.cube_dtype) --------------------------
#
# The resident flat intensity cube holds integer-grid values (above).  bf16
# keeps 8 significant bits: a value rounds to nearest even on a coarser
# integer grid, so every per-(pixel, window) sum of the rounded values still
# stays below 2**24 and remains order-free exact.  int8 quantizes each tile
# of QTILE consecutive m/z-sorted peaks with a POWER-OF-TWO scale, so the
# dequantization multiply (code * 2**k) is exact in f32 and the only loss is
# the rint to 8 bits.  Expansion is exact either way: images scored on a
# compact cube are bit-equal to images scored on the f32 cube
# ``expand_cube(*compact_cube(in_s))``.

CUBE_DTYPES = ("f32", "bf16", "int8")
QTILE = 1024  # peaks per int8 scale tile (lattice peak counts are multiples)


def compact_cube(in_s: np.ndarray, cube_dtype: str):
    """Host-side compaction of the (N,) f32 intensity cube.

    Returns ``(codes, scales)``: for ``"bf16"`` the codes are the bfloat16
    values' bit patterns as ``uint16`` (numpy has no bfloat16; the cast is
    torch's round-to-nearest-even, as ``ml_dtypes`` rounds), for ``"int8"``
    the int8 codes; ``scales`` is the (N // QTILE,) f32 per-tile power-of-two
    dequantization factors (None for f32 and bf16)."""
    if cube_dtype not in CUBE_DTYPES:
        raise ValueError(f"cube_dtype must be one of {CUBE_DTYPES}, "
                         f"got {cube_dtype!r}")
    in_s = np.ascontiguousarray(in_s, dtype=np.float32)
    if cube_dtype == "f32":
        return in_s, None
    if cube_dtype == "bf16":
        bf = torch.from_numpy(in_s).to(torch.bfloat16)
        # smlint: host-sync-ok[a host tensor's numpy view: no device here]
        return bf.view(torch.int16).numpy().view(np.uint16), None
    if in_s.size % QTILE != 0:
        raise ValueError(
            f"int8 cube needs a QTILE={QTILE}-aligned peak count "
            f"(lattice-padded), got {in_s.size}")
    tiles = in_s.reshape(-1, QTILE)
    m = np.max(np.abs(tiles), axis=1)
    # smallest 2**e with m / 2**e <= 127 (m == 0 -> scale 1)
    e = np.ceil(np.log2(np.maximum(m, 1e-30) / 127.0))
    scales = np.exp2(np.maximum(e, np.float64(-126.0))).astype(np.float32)
    codes = np.rint(tiles / scales[:, None]).astype(np.int8)
    return codes.reshape(-1), scales


def expand_cube(codes: np.ndarray, scales) -> np.ndarray:
    """Host-side inverse of :func:`compact_cube`: the (N,) f32 cube."""
    if codes.dtype == np.float32:
        return codes
    if codes.dtype == np.uint16:
        # bfloat16 is the top half of an f32
        return (codes.astype(np.uint32) << 16).view(np.float32)
    return (codes.reshape(-1, QTILE).astype(np.float32)
            * scales[:, None]).reshape(-1)


def cube_to_device(codes: np.ndarray, device) -> torch.Tensor:
    """The compact codes of :func:`compact_cube` as a resident tensor:
    f32, bfloat16 (from the uint16 bit patterns) or int8."""
    t = torch.from_numpy(np.ascontiguousarray(codes))
    if codes.dtype == np.uint16:
        t = t.view(torch.int16).view(torch.bfloat16)
    # smlint: host-sync-ok[the resident cube goes up once, at set-up]
    return t.to(device)


def expand_cube_range(codes: torch.Tensor, scales: torch.Tensor | None,
                      lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """f32 values of the resident slots ``[lo, hi)`` — the device
    counterpart of ``expand_cube`` over a range (the JAX package expands the
    whole cube with ``expand_cube_jnp``).  An f32 cube returns its view; a
    bf16 range is cast; an int8 range expands the tiles it touches, each
    slot by the scale of its absolute tile ``i // QTILE``.  Exact."""
    hi = codes.numel() if hi is None else hi
    if codes.dtype == torch.float32:
        return codes[lo:hi]
    if scales is None:
        return codes[lo:hi].float()
    t0, t1 = lo // QTILE, -(-hi // QTILE)
    tiles = (codes[t0 * QTILE:t1 * QTILE].view(-1, QTILE).float()
             * scales[t0:t1, None])
    off = t0 * QTILE
    return tiles.view(-1)[lo - off:hi - off]


def expand_cube_at(codes: torch.Tensor, scales: torch.Tensor | None,
                   idx: torch.Tensor) -> torch.Tensor:
    """f32 values of the resident slots ``idx`` (a gather), each int8 code
    by its gathered tile scale.  Exact."""
    vals = codes[idx]
    if codes.dtype == torch.float32:
        return vals
    vals = vals.float()
    return vals if scales is None else vals * scales[idx // QTILE]
