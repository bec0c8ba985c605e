"""PyTorch backend: ion-image extraction and MSM scoring on one device.

Port of ``sm_distributed_tpu/models/msm_jax.py`` (``JaxBackend``), with
these scorers:

- :func:`score_flat_plain` (``fused_score_fn_flat_banded``): resident
  m/z-sorted flat peaks, banded extraction (``ops/imager.py``), then
  ``ops/metrics.batch_metrics``, whose moments and chaos steps are the
  hand-written kernels on the card;
- :func:`score_flat_sliced` and :func:`score_flat_compact`
  (``fused_score_fn_flat_banded_sliced`` / ``_compact``): the same chain
  over a subset of the resident peaks — the contiguous rank band the
  batch's window union spans, or the peaks inside the union gathered on
  the device.  ``TorchBackend._variant_for`` picks plain, band or compact
  for each batch with the JAX package's rule and the card's per-slot
  rates; all three give the same bits;
- :func:`score_flat_fused` (``fused_score_fn_flat_fused``) with
  ``parallel.fused_metrics="on"``: the plain histogram, then the fused
  window-moments kernel (``ops/score.py``), which writes only the moment
  partials and the principal rows, then
  ``ops/metrics.batch_metrics_from_partials``;
- :func:`score_chunked` (``fused_score_fn_chunked``) with
  ``parallel.mz_chunk > 0``: the resident dense cube and the m/z-chunked
  extraction, whose scratch is bounded at (P, gc_width+2) — the path of
  whole-slide images, whose flat scratch no batch size fits.

With ``image_generation.do_preprocessing`` every chain but the fused one
hot-spot clips the image block before its moments; preprocessing never
takes the fused kernel.

With ``parallel.cube_dtype`` "bf16" or "int8" the flat path's resident
intensities are compact (``ops/quantize.compact_cube``: half or a quarter
of the f32 bytes, int8 with one power-of-two scale a ``QTILE`` slots) and
each scorer expands to f32 only the slots its batch reads: the band's
slots, the gathered slots, or the whole cube for the plain and fused
variants.  Expansion is exact, so images equal those of the f32 cube
rounded the same way.  The cube path stays f32, as in the JAX package.

Each formula batch is planned on the host (padded windows, bound ranks, the
chunk plan, the band and the compaction runs).  On the flat paths the
shape-bucket lattice is mirrored so the port scores exactly the padded
shapes the JAX package does: image rows snap up to ``row_bucket(nrows)``
(zero rows, masked by the real pixel count), resident peak arrays pad to
``peak_bucket`` slots, and the pad-to batch snaps down to the lattice.  The
cube path stays off the row lattice, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..analysis.numerics import numerics_surface
from ..io.dataset import SpectralDataset
from ..ops import buckets as shape_buckets
from ..ops.imager import (
    BAND_WINDOWS,
    batch_peak_band,
    batch_peak_runs,
    compact_peaks,
    extract_images_flat_banded,
    extract_images_mz_chunked,
    flat_bound_ranks,
    flat_histogram,
    ion_window_chunks,
    ions_per_chunk_for,
    prepare_cube_arrays,
    prepare_flat_sorted_arrays,
    restrict_flat_to_windows,
    window_chunks,
    window_rank_grid,
)
from ..ops.isocalc import IsotopePatternTable
from ..ops.metrics import batch_metrics, batch_metrics_from_partials
from ..ops.score import fused_window_moments
from ..ops.quantize import (
    MZ_PAD_Q,
    QTILE,
    compact_cube,
    cube_to_device,
    expand_cube_range,
    quantize_window,
)
from ..utils import tracing
from ..utils.config import DSConfig, SMConfig

# Numerics contracts (analysis/numerics.py), the JAX package's
# ``models/msm_jax.py`` sites by the port function that computes each (its
# moments, chaos, correlation, pattern-match and cube-expansion sites are
# declared by ops/moments.py, ops/metrics.py and ops/quantize.py).  The
# band and compact variants take no padded= clause: they pad nothing.
NUMERICS = numerics_surface(__name__, {
    "score_chunked":
        "contract=ulp(8); test=tests/test_torch_numerics.py::"
        "test_chunked_step_holds_its_contract",
    "score_flat_plain":
        "contract=ulp(16); test=tests/test_torch_numerics.py::"
        "test_flat_step_holds_its_contracts; padded=pixel_sorted,int_sorted",
    "score_flat_compact":
        "contract=bit_exact; test=tests/test_torch_variants.py::"
        "test_variants_match_plain_and_jax",
    "score_flat_sliced":
        "contract=bit_exact; test=tests/test_torch_variants.py::"
        "test_variants_match_plain_and_jax",
    "score_flat_fused":
        "contract=ulp(16); test=tests/test_torch_numerics.py::"
        "test_fused_step_holds_its_contract; padded=pixel_sorted,int_sorted",
    "TorchBackend.extract_ion_images":
        "contract=bit_exact; test=tests/test_torch_job.py::"
        "test_extract_ion_images_matches_jax_and_numpy",
    "extract_images_flat_banded":
        "contract=bit_exact; test=tests/test_torch_extract.py::"
        "test_extraction_bit_equal",
    "TorchBackend.image_block":
        "contract=bit_exact; test=tests/test_torch_cube.py::"
        "test_cube_image_block_is_the_scored_block",
})

logger = logging.getLogger(__name__)


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for ``device``.  CUDA is required when asked for:
    there is no fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                "available (pass device='cpu' to run on the CPU)")
        # ion images are exact only through full-f32 matmuls: TF32 would
        # round the integer-grid band sums to ~11 bits
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError("could not disable TF32 matmuls")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _extract_plain(pixel_sorted, int_sorted, pos, starts, r_lo_loc,
                   r_hi_loc, *, gc_width: int, b: int, k: int, n_pixels: int,
                   scales: torch.Tensor | None = None) -> torch.Tensor:
    """The plain chain's extraction step: the raw (b, k, P) image block of
    one padded batch in the plan's ion order, from every resident peak (a
    compact ``int_sorted`` expanded to f32 whole)."""
    return extract_images_flat_banded(
        pixel_sorted, expand_cube_range(int_sorted, scales), pos, starts,
        r_lo_loc, r_hi_loc, None, gc_width=gc_width,
        n_pixels=n_pixels).view(b, k, -1)


def _extract_band(pixel_sorted, int_sorted, b_lo: int, width: int, pos,
                  starts, r_lo_loc, r_hi_loc, *, gc_width: int, b: int,
                  k: int, n_pixels: int, scales: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """The band chain's extraction step (:func:`score_flat_sliced`)."""
    return _extract_plain(
        pixel_sorted[b_lo:b_lo + width],
        expand_cube_range(int_sorted, scales, b_lo, b_lo + width),
        torch.clamp(pos - b_lo, 0, width), starts, r_lo_loc, r_hi_loc,
        gc_width=gc_width, b=b, k=k, n_pixels=n_pixels)


def _extract_compact(pixel_sorted, int_sorted, run_pos, run_delta, n_b: int,
                     pos_b, starts, r_lo_loc, r_hi_loc, *, gc_width: int,
                     b: int, k: int, n_pixels: int,
                     scales: torch.Tensor | None = None) -> torch.Tensor:
    """The compact chain's extraction step (:func:`score_flat_compact`)."""
    px_b, in_b = compact_peaks(pixel_sorted, int_sorted, run_pos, run_delta,
                               n_b, scales)
    return _extract_plain(px_b, in_b, pos_b, starts, r_lo_loc, r_hi_loc,
                          gc_width=gc_width, b=b, k=k, n_pixels=n_pixels)


def _block_metrics(imgs, inv, theor_ints, n_valid, n_real, *, nrows: int,
                   ncols: int, nlevels: int, do_preprocessing: bool = False,
                   q: float = 99.0) -> torch.Tensor:
    """The plain, band and compact chains' metrics step: ``batch_metrics``
    of the block, its rows un-permuted to the table's ion order by
    ``inv``."""
    out = batch_metrics(imgs, theor_ints, n_valid, nrows, ncols, nlevels,
                        n_real=n_real, do_preprocessing=do_preprocessing, q=q)
    return out[inv]


def _fused_scratch(pixel_sorted, int_sorted, pos, *, gc_width: int,
                   n_pixels: int, scales: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """The fused chain's extraction step: the plain path's histogram (a
    compact cube expands whole)."""
    return flat_histogram(pixel_sorted, expand_cube_range(int_sorted, scales),
                          pos, gc_width=gc_width, n_pixels=n_pixels)


def _fused_moments(wh, starts, r_lo_loc, r_hi_loc, n_real, *, gc_width: int,
                   b: int, k: int, n_pixels: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused chain's moments step: the fused window-moments kernel over
    the histogram, ``(partials (b, k, 5), principal (b, P))``."""
    partials, principal = fused_window_moments(
        wh[:, :n_pixels], starts, r_lo_loc, r_hi_loc,
        n_pixels if n_real is None else n_real, gc_width=gc_width, k=k)
    return partials.view(b, k, 5), principal.view(b, n_pixels)


def score_flat_plain(
    pixel_sorted: torch.Tensor,  # (N,) int64 resident pixel rows
    int_sorted: torch.Tensor,    # (N,) f32 resident intensities
    pos: torch.Tensor,           # (G,) int64 bound ranks
    starts: np.ndarray,          # (C,) chunk grid offsets (host)
    r_lo_loc: torch.Tensor,      # (C, Wc) int32
    r_hi_loc: torch.Tensor,      # (C, Wc) int32
    inv: torch.Tensor,           # (b,) ion un-permutation
    theor_ints: torch.Tensor,    # (b, k) f32, plan-sorted
    n_valid: torch.Tensor,       # (b,) int32, plan-sorted
    n_real: int | None,
    *,
    gc_width: int,
    b: int,
    k: int,
    nrows: int,
    ncols: int,
    nlevels: int,
    do_preprocessing: bool = False,
    q: float = 99.0,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """(b, 4) metrics of one padded batch, in the table's ion order — the
    port of ``fused_score_fn_flat_banded``.  The chunk plan is ion-major, so
    extraction emits the (b, k, P) block directly and only the metric rows
    are un-permuted by ``inv``.  A compact ``int_sorted`` (bf16, or int8
    with its tile ``scales``) is expanded to f32 whole: the plain histogram
    reads every resident slot."""
    imgs = _extract_plain(pixel_sorted, int_sorted, pos, starts, r_lo_loc,
                          r_hi_loc, gc_width=gc_width, b=b, k=k,
                          n_pixels=nrows * ncols, scales=scales)
    return _block_metrics(imgs, inv, theor_ints, n_valid, n_real,
                          nrows=nrows, ncols=ncols, nlevels=nlevels,
                          do_preprocessing=do_preprocessing, q=q)


def score_flat_sliced(
    pixel_sorted: torch.Tensor,  # (N,) int64 resident pixel rows
    int_sorted: torch.Tensor,    # (N,) f32 resident intensities
    b_lo: int,                   # band start rank
    width: int,                  # band width (peaks)
    pos: torch.Tensor,           # (G,) int64 source-space bound ranks
    starts: np.ndarray,
    r_lo_loc: torch.Tensor,
    r_hi_loc: torch.Tensor,
    inv: torch.Tensor,
    theor_ints: torch.Tensor,
    n_valid: torch.Tensor,
    n_real: int | None,
    *,
    gc_width: int,
    b: int,
    k: int,
    nrows: int,
    ncols: int,
    nlevels: int,
    do_preprocessing: bool = False,
    q: float = 99.0,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`score_flat_plain` over the contiguous band ``[b_lo, b_lo +
    width)`` of the resident peaks — the port of
    ``fused_score_fn_flat_banded_sliced``.  The band is a view, and the
    bound ranks are shifted into it on the device with bounds outside it
    clipped (``clip(pos - b_lo, 0, width)``): peaks of the band outside
    every window land in gap bins of zero membership, and bounds below the
    band are batch-padding zeros, ranked below every real window, exactly
    as the full histogram treats them — images and metrics are
    bit-identical to the plain variant's.  A compact cube expands the
    band's slots only, each int8 slot by the scale of its absolute tile."""
    imgs = _extract_band(pixel_sorted, int_sorted, b_lo, width, pos, starts,
                         r_lo_loc, r_hi_loc, gc_width=gc_width, b=b, k=k,
                         n_pixels=nrows * ncols, scales=scales)
    return _block_metrics(imgs, inv, theor_ints, n_valid, n_real,
                          nrows=nrows, ncols=ncols, nlevels=nlevels,
                          do_preprocessing=do_preprocessing, q=q)


def score_flat_compact(
    pixel_sorted: torch.Tensor,  # (N,) int64 resident pixel rows
    int_sorted: torch.Tensor,    # (N,) f32 resident intensities
    run_pos: torch.Tensor,       # (R,) int64 kept-space run starts
    run_delta: torch.Tensor,     # (R,) int64 source-offset jumps
    n_b: int,                    # kept peaks this batch
    pos_b: torch.Tensor,         # (G,) int64 kept-space bound ranks
    starts: np.ndarray,
    r_lo_loc: torch.Tensor,
    r_hi_loc: torch.Tensor,
    inv: torch.Tensor,
    theor_ints: torch.Tensor,
    n_valid: torch.Tensor,
    n_real: int | None,
    *,
    gc_width: int,
    b: int,
    k: int,
    nrows: int,
    ncols: int,
    nlevels: int,
    do_preprocessing: bool = False,
    q: float = 99.0,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """:func:`score_flat_plain` over the batch's kept peaks only, gathered
    on the device by ``compact_peaks`` — the port of
    ``fused_score_fn_flat_banded_compact``.  The kept peaks are exactly
    those inside some window of the batch, so the (pixel, bin, intensity)
    hit multiset, and every image and metric bit, is the plain variant's.
    A compact cube expands the gathered slots only, with their gathered
    tile scales."""
    imgs = _extract_compact(pixel_sorted, int_sorted, run_pos, run_delta,
                            n_b, pos_b, starts, r_lo_loc, r_hi_loc,
                            gc_width=gc_width, b=b, k=k,
                            n_pixels=nrows * ncols, scales=scales)
    return _block_metrics(imgs, inv, theor_ints, n_valid, n_real,
                          nrows=nrows, ncols=ncols, nlevels=nlevels,
                          do_preprocessing=do_preprocessing, q=q)


def score_flat_fused(
    pixel_sorted: torch.Tensor,  # (N,) int64 resident pixel rows
    int_sorted: torch.Tensor,    # (N,) f32 resident intensities
    pos: torch.Tensor,           # (G,) int64 bound ranks
    starts: np.ndarray,          # (C,) chunk grid offsets (host)
    r_lo_loc: torch.Tensor,      # (C, Wc) int32
    r_hi_loc: torch.Tensor,      # (C, Wc) int32
    inv: torch.Tensor,           # (b,) ion un-permutation
    theor_ints: torch.Tensor,    # (b, k) f32, plan-sorted
    n_valid: torch.Tensor,       # (b,) int32, plan-sorted
    n_real: int | None,
    *,
    gc_width: int,
    b: int,
    k: int,
    nrows: int,
    ncols: int,
    nlevels: int,
    scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """(b, 4) metrics of one padded batch through the fused window-moments
    kernel, in the table's ion order — the port of
    ``fused_score_fn_flat_fused``.  The histogram is the plain path's (a
    compact cube expands whole); the kernel reads exactly the band rows the
    plain path's matmuls read, and the metric rows are un-permuted by
    ``inv``."""
    n_pix = nrows * ncols
    wh = _fused_scratch(pixel_sorted, int_sorted, pos, gc_width=gc_width,
                        n_pixels=n_pix, scales=scales)
    partials, principal = _fused_moments(
        wh, starts, r_lo_loc, r_hi_loc, n_real, gc_width=gc_width, b=b, k=k,
        n_pixels=n_pix)
    del wh
    out = batch_metrics_from_partials(partials, principal, theor_ints,
                                      n_valid, nrows, ncols, nlevels)
    return out[inv]


def score_chunked(
    mz_q_cube: torch.Tensor,     # (P, L) int32 resident cube m/z
    int_cube: torch.Tensor,      # (P, L) f32 resident cube intensities
    grid: torch.Tensor,          # (G,) int32 sorted window bounds
    starts: np.ndarray,          # (C,) chunk grid offsets (host)
    r_lo_loc: torch.Tensor,      # (C, Wc) int32
    r_hi_loc: torch.Tensor,      # (C, Wc) int32
    inv: torch.Tensor,           # (b*k,) window un-permutation
    theor_ints: torch.Tensor,    # (b, k) f32, table order
    n_valid: torch.Tensor,       # (b,) int32, table order
    *,
    gc_width: int,
    b: int,
    k: int,
    nrows: int,
    ncols: int,
    nlevels: int,
    do_preprocessing: bool = False,
    q: float = 99.0,
) -> torch.Tensor:
    """(b, 4) metrics of one padded batch on the m/z-chunked cube path, in
    the table's ion order — the port of ``fused_score_fn_chunked``.  The
    cube path is off the row lattice, so the moments are unmasked."""
    imgs = extract_images_mz_chunked(
        mz_q_cube, int_cube, grid, starts, r_lo_loc, r_hi_loc, inv,
        gc_width=gc_width)
    imgs = imgs.view(b, k, -1)[:, :, :nrows * ncols]
    return batch_metrics(imgs, theor_ints, n_valid, nrows, ncols, nlevels,
                         n_real=None, do_preprocessing=do_preprocessing, q=q)


class FlatPlan(NamedTuple):
    """Host plan of one flat-path batch."""
    grid: np.ndarray         # (G,) sorted window bounds
    r_lo: np.ndarray         # (G/2,) lo bound ranks
    r_hi: np.ndarray         # (G/2,) hi bound ranks
    ints_p: np.ndarray       # (b, k) padded theoretical intensities
    nv_p: np.ndarray         # (b,) padded valid peak counts
    chunks: tuple            # ion_window_chunks(...)
    pos: np.ndarray          # (G,) bound ranks among the resident peaks
    b_eff: int               # static batch size of this batch
    runs: tuple | None       # batch_peak_runs(...), unless compaction is off
    band: tuple | None       # batch_peak_band(...), unless band_slice is off


# the card's per-slot costs of the histogram step, which the variant rule
# weighs: the scatter-add of one peak slot, and the device gather of one
# kept slot (compact_peaks) plus its scatter-add.  Measured by
# chip_smoke.py phase 9 on an m/z-ordered 6-batch stream (bench.py's scale
# case), as the histogram's device ms less the scratch's fixed cost over
# the band's slots and over the kept slots, on NVIDIA H100 80GB HBM3,
# 700.00 W.  A plain histogram's slots cost more there (1.54 ns): on CUDA
# the accumulate sorts its indices and reduces each cell's duplicates in
# turn, and an ordered batch's slots outside its windows pile into the
# bins below its first and above its last bound.  So the plain estimate is
# a floor, reached when a batch keeps nearly every resident peak, which is
# where the rule can pick plain.
SCATTER_NS_PER_SLOT = 0.43
COMPACT_NS_PER_SLOT = 0.47


class TorchBackend:
    """Scorer selected by ``SMConfig.backend == 'torch_cuda'``: the flat path
    (the plain, band or compact chain, or the fused kernel with
    ``fused_metrics="on"``), or the cube path with ``mz_chunk > 0``."""

    name = "torch_cuda"

    # static batch size for small tables (the stream's tail): a short final
    # slice padded to formula_batch would pay the full batch's scratch,
    # chaos and metrics cost
    _TAIL_BATCH = 256

    def __init__(self, ds: SpectralDataset, ds_config: DSConfig,
                 sm_config: SMConfig,
                 restrict_table: IsotopePatternTable | None = None,
                 device: str | torch.device | None = None):
        self.ds = ds
        self.ds_config = ds_config
        self.device = resolve_device(device if device is not None
                                     else sm_config.device)
        self._buckets = shape_buckets.buckets_enabled(sm_config.parallel)
        self.batch = shape_buckets.effective_batch(sm_config.parallel)
        img_cfg = ds_config.image_generation
        self.ppm = img_cfg.ppm
        self.nlevels = img_cfg.nlevels
        self.do_preprocessing = img_cfg.do_preprocessing
        self.q = img_cfg.q
        self._nrows_b = (shape_buckets.row_bucket(ds.nrows)
                         if self._buckets else ds.nrows)
        self._n_pix_b = self._nrows_b * ds.ncols
        # real pixel count for the masked moments; None off the lattice
        self._n_real = ds.n_pixels if self._buckets else None
        self.int_scale = ds.intensity_quantization(self.ppm)[1]
        self.mz_chunk = max(0, sm_config.parallel.mz_chunk)
        # the resident flat intensity cube's dtype (parallel.cube_dtype) and
        # its int8 tile scales; the cube path stays f32, as in the JAX
        # package
        self.cube_dtype = "f32"
        self._scales = None
        # bytes of each resident array: pixel rows, intensities, scales
        self.resident_bytes: dict[str, int] = {}
        if self.mz_chunk:
            self._init_cube(ds, restrict_table)
        else:
            self._init_flat(ds, ds_config, sm_config, restrict_table)
        # "on" takes the fused kernel; "auto" keeps the plain chain on every
        # device until the fused kernel beats it on the card (ROADMAP);
        # hot-spot clipping needs the image block, so it never fuses
        self._fused = (sm_config.parallel.fused_metrics == "on"
                       and not self.do_preprocessing)
        self._compaction = sm_config.parallel.peak_compaction
        self._band_mode = sm_config.parallel.band_slice
        # batches this backend scored by each flat variant (a search builds
        # its own backend, so the counts are the search's)
        self.variant_counts = dict.fromkeys(
            ("plain", "band", "compact", "fused"), 0)
        # sticky chunk band widths: grow to the max seen in a stream.  The
        # JAX package also keeps sticky compaction capacities (_n_keep,
        # _r_pad) and grows them to a stream-wide fixpoint, because its
        # static shapes pad every compact batch and its variant estimate
        # charges the padding; eager torch pads nothing and the estimate
        # charges the exact band width and kept count, so neither exists
        # here and every batch's choice depends on that batch alone
        self._gc_width = 0
        self._gc_tail = 0
        # the compaction capacities a batch's spec names: the JAX package's
        # sticky _n_keep / _r_pad, grown as it grows them (nothing pads to
        # them here)
        self._spec_n_keep = 0
        self._spec_r_pad = 0
        # the JAX backend skips its warm-up's executions when a manifest
        # says its persistent XLA cache holds every executable; the port
        # has no such cache, so its warm-up always scores
        self.last_warmup_skipped = False

    def _init_cube(self, ds: SpectralDataset,
                   restrict_table: IsotopePatternTable | None) -> None:
        """The dense quantized cube, resident.  Off the row lattice: the
        cube's rows are per-dataset anyway."""
        if restrict_table is not None:
            logger.info("window-union restriction not applicable on the "
                        "mz_chunk cube path (dense per-pixel rows); scoring "
                        "the full cube")
        mz_q, int_cube = prepare_cube_arrays(ds, ppm=self.ppm)
        # smlint: host-sync-ok[the cube goes up once, at set-up]
        self._mz_q = torch.from_numpy(mz_q).to(self.device)
        # smlint: host-sync-ok[the cube goes up once, at set-up]
        self._ints = torch.from_numpy(int_cube).to(self.device)
        self.resident_bytes = {"mz": self._mz_q.nbytes,
                               "intensity": self._ints.nbytes, "scales": 0}
        logger.info("torch_cuda cube resident: %s int32 + %s f32 on %s",
                    tuple(mz_q.shape), tuple(int_cube.shape), self.device)
        self._nrows_b = ds.nrows
        self._n_pix_b = ds.n_pixels
        self._n_real = None

    def _init_flat(self, ds: SpectralDataset, ds_config: DSConfig,
                   sm_config: SMConfig,
                   restrict_table: IsotopePatternTable | None) -> None:
        """The m/z-sorted flat peaks, resident and lattice-padded, the
        intensities in ``parallel.cube_dtype``: bf16 halves, int8 (with one
        f32 scale a QTILE slots) quarters the resident intensity array; each
        scorer expands to f32 only the slots its batch reads."""
        # guard: the histogram scratch is (2BK+1, P+1) f32 — past a few GB
        # the device OOM is opaque, so fail early with guidance
        k_est = ds_config.isotope_generation.n_peaks
        scratch = 4 * (self._n_pix_b + 1) * max(2 * self.batch * k_est + 1,
                                                4098)
        if scratch > (8 << 30):
            raise ValueError(
                f"flat-path histogram scratch would be ~{scratch / 2**30:.0f}"
                f" GiB ({ds.n_pixels} pixels x formula_batch={self.batch}"
                f" x {k_est} peaks); reduce parallel.formula_batch, or set"
                " parallel.mz_chunk to use the bounded-scratch cube path")
        mz_s, px_s, in_s = prepare_flat_sorted_arrays(ds, self.ppm)
        if restrict_table is not None:
            # drop peaks outside every window of the search up front: on
            # noisy data most peaks match nothing (exact)
            lo_q, hi_q = quantize_window(restrict_table.mzs, self.ppm)
            mzk, pxk, ink, n_eff = restrict_flat_to_windows(
                mz_s[None], px_s[None], in_s[None], lo_q, hi_q,
                overflow_row=ds.n_pixels)
            logger.info("window-union restriction: %d -> %d peaks",
                        mz_s.size, n_eff)
            mz_s, px_s, in_s = mzk[0], pxk[0], ink[0]
        if self._buckets:
            # lattice-pad the resident arrays: m/z saturates to the
            # sentinel (outside every window), pixel points at the overflow
            # row, intensity 0 — exact
            n_pad = shape_buckets.peak_bucket(mz_s.size)
            if n_pad > mz_s.size:
                tail = n_pad - mz_s.size
                mz_s = np.concatenate(
                    [mz_s, np.full(tail, MZ_PAD_Q, mz_s.dtype)])
                px_s = np.concatenate(
                    [px_s, np.full(tail, ds.n_pixels, px_s.dtype)])
                in_s = np.concatenate([in_s, np.zeros(tail, in_s.dtype)])
        self.cube_dtype = sm_config.parallel.cube_dtype
        if self.cube_dtype == "int8" and in_s.size % QTILE != 0:
            # int8 tiles need QTILE-aligned slots, padded with the same
            # zero-intensity overflow-row slots as the lattice pad (as the
            # JAX package does; lattice points and the flat layout's
            # 1024-slot rounding are already multiples of QTILE)
            tail = -in_s.size % QTILE
            mz_s = np.concatenate([mz_s, np.full(tail, MZ_PAD_Q, mz_s.dtype)])
            px_s = np.concatenate(
                [px_s, np.full(tail, ds.n_pixels, px_s.dtype)])
            in_s = np.concatenate([in_s, np.zeros(tail, in_s.dtype)])
        codes, scales = compact_cube(in_s, self.cube_dtype)
        self._mz_host = mz_s
        # smlint: host-sync-ok[the resident peaks go up once, at set-up]
        self._px_s = torch.from_numpy(px_s.astype(np.int64)).to(self.device)
        self._in_s = cube_to_device(codes, self.device)
        if scales is not None:
            # smlint: host-sync-ok[the int8 tile scales go up once, at set-up]
            self._scales = torch.from_numpy(scales).to(self.device)
        self.resident_bytes = {
            "pixel": self._px_s.nbytes, "intensity": self._in_s.nbytes,
            "scales": 0 if scales is None else self._scales.nbytes}
        logger.info(
            "torch_cuda flat peaks resident: %d sorted peaks on %s; "
            "cube_dtype=%s, bytes %s", mz_s.size, self.device,
            self.cube_dtype, self.resident_bytes)

    def _batch_for(self, n: int) -> int:
        # the cube path and small formula batches keep one batch size
        if self.mz_chunk or self.batch <= self._TAIL_BATCH:
            return self.batch
        return self._TAIL_BATCH if n <= self._TAIL_BATCH else self.batch

    def shrink_batch(self, batch: int) -> None:
        """Cap the static padding batch (shrink only).  Under the lattice
        the new cap snaps down to a lattice point.  Per-ion metrics do not
        depend on it."""
        new = max(1, int(batch))
        if self._buckets:
            new = shape_buckets.batch_bucket_down(new)
        if new < self.batch:
            logger.warning("torch_cuda backend: formula batch %d -> %d",
                           self.batch, new)
            self.batch = new

    def _padded_windows(self, table: IsotopePatternTable, b: int | None = None):
        """One batch's quantized windows padded to the static batch size
        (padded ions: bounds (0, 0), n_valid 0 -> all metrics 0), with their
        bound ranks: (grid, r_lo, r_hi, ints_p, nv_p)."""
        n, b = table.n_ions, b or self.batch
        if n > b:
            raise ValueError(f"batch of {n} ions exceeds formula_batch={b}")
        k = table.max_peaks
        lo_q, hi_q = quantize_window(table.mzs, self.ppm)
        lo_p = np.zeros((b, k), dtype=np.int32)
        hi_p = np.zeros((b, k), dtype=np.int32)
        ints_p = np.zeros((b, k), dtype=np.float32)
        nv_p = np.zeros(b, dtype=np.int32)
        lo_p[:n], hi_p[:n] = lo_q, hi_q
        ints_p[:n] = table.ints
        nv_p[:n] = table.n_valid
        grid, r_lo, r_hi = window_rank_grid(lo_p, hi_p)
        return grid, r_lo, r_hi, ints_p, nv_p

    def _flat_plan(self, table: IsotopePatternTable) -> FlatPlan:
        """Host plan of one batch: padded windows, the ion-major chunk plan,
        bound ranks, and (unless their mode is "off") the compaction runs
        and the peak band."""
        b_eff = self._batch_for(table.n_ions)
        grid, r_lo, r_hi, ints_p, nv_p = self._padded_windows(table, b_eff)
        k_eff = max(1, table.max_peaks)
        chunks = ion_window_chunks(
            r_lo, r_hi, b_eff, k_eff,
            ions_per_chunk_for(b_eff, k_eff, BAND_WINDOWS))
        pos = flat_bound_ranks(self._mz_host, grid)
        runs, band = None, None
        if self._compaction != "off" or self._band_mode != "off":
            lo_q, hi_q = quantize_window(table.mzs, self.ppm)
            if self._compaction != "off":
                runs = batch_peak_runs(self._mz_host, lo_q, hi_q, pos)
            if self._band_mode != "off":
                band = batch_peak_band(self._mz_host, lo_q, hi_q)
        return FlatPlan(grid, r_lo, r_hi, ints_p, nv_p, chunks, pos, b_eff,
                        runs, band)

    def _variant_for(self, runs, band) -> str:
        """The extraction variant of one batch: "band" (scatter the
        contiguous band of the resident peaks), "compact" (gather the
        batch's kept peaks, then scatter) or "plain" (scatter every
        resident peak) — the JAX package's rule.  "on" forces a variant,
        band first; otherwise the least estimated histogram cost wins, at
        the card's per-slot rates (``SCATTER_NS_PER_SLOT``,
        ``COMPACT_NS_PER_SLOT``).  Those rates are not the JAX package's,
        so the port may pick another variant than it does for the same
        batch; every variant gives the same bits."""
        if self._band_mode == "on" and band is not None:
            return "band"
        if self._compaction == "on" and runs is not None:
            return "compact"
        n = int(self._mz_host.size)
        est = {"plain": SCATTER_NS_PER_SLOT * n}
        if runs is not None:
            est["compact"] = COMPACT_NS_PER_SLOT * runs[2]
        if band is not None and band[1] < n:
            est["band"] = SCATTER_NS_PER_SLOT * band[1]
        return min(est, key=est.get)

    def _grow_from_plan(self, plan: FlatPlan) -> None:
        gc = plan.chunks[4]
        if plan.b_eff == self.batch:
            self._gc_width = max(self._gc_width, gc)
        else:
            self._gc_tail = max(self._gc_tail, gc)

    def presize(self, tables) -> None:
        """Grow the sticky band widths to cover ``tables`` without scoring,
        so every batch of a search runs at one shape.  The cube path plans
        each batch's band width on its own."""
        if self.mz_chunk:
            return
        for t in tables:
            self._grow_from_plan(self._flat_plan(t))

    def _device_plan(self, table: IsotopePatternTable,
                     plan: FlatPlan | None = None) -> dict:
        """One batch's plan with its per-batch arrays on the device: bound
        ranks, chunk plan, ion un-permutation and the plan-sorted side
        inputs, at the sticky band width."""
        if plan is None:
            plan = self._flat_plan(table)
        starts, r_lo_loc, r_hi_loc, inv, _gc_width, order = plan.chunks
        self._grow_from_plan(plan)
        put = self._put
        return dict(
            pos=put(plan.pos, torch.int64), starts=starts,
            r_lo_loc=put(r_lo_loc), r_hi_loc=put(r_hi_loc),
            inv=put(inv, torch.int64), theor_ints=put(plan.ints_p[order]),
            n_valid=put(plan.nv_p[order]),
            gc_width=(self._gc_width if plan.b_eff == self.batch
                      else self._gc_tail), b=plan.b_eff)

    def _put(self, a: np.ndarray, dtype: torch.dtype | None = None
             ) -> torch.Tensor:
        """A host array on the backend's device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        # smlint: host-sync-ok[a batch's host plan goes up before its launches]
        return (t if dtype is None else t.to(dtype)).to(self.device)

    def _cube_plan(self, table: IsotopePatternTable) -> dict:
        """One cube-path batch's window-major chunk plan, its per-batch
        arrays on the device."""
        grid, r_lo, r_hi, ints_p, nv_p = self._padded_windows(table)
        starts, r_lo_loc, r_hi_loc, inv, gc_width = window_chunks(
            r_lo, r_hi, self.mz_chunk)
        put = self._put
        return dict(grid=put(grid), starts=starts, r_lo_loc=put(r_lo_loc),
                    r_hi_loc=put(r_hi_loc), inv=put(inv, torch.int64),
                    theor_ints=put(ints_p), n_valid=put(nv_p),
                    gc_width=gc_width)

    def _dispatch(self, table: IsotopePatternTable,
                  plan: FlatPlan | None = None, variant: str | None = None
                  ) -> torch.Tensor:
        """Enqueue one padded batch on the device; returns its (b, 4)
        metrics (on the device, not synchronised).  On the flat path the
        batch takes ``variant`` when given (a variant whose mode is "off"
        has no host plan and raises), else the fused kernel with
        ``fused_metrics="on"`` whatever the rule picks, as in the JAX
        package, else the rule's variant."""
        if self.mz_chunk:
            d = self._cube_plan(table)
            return score_chunked(
                self._mz_q, self._ints, d["grid"], d["starts"],
                d["r_lo_loc"], d["r_hi_loc"], d["inv"], d["theor_ints"],
                d["n_valid"], gc_width=d["gc_width"], b=self.batch,
                k=table.max_peaks, nrows=self._nrows_b, ncols=self.ds.ncols,
                nlevels=self.nlevels, do_preprocessing=self.do_preprocessing,
                q=self.q)
        if plan is None:
            plan = self._flat_plan(table)
        if variant is None:
            variant = self._variant_of(plan)
        d = self._device_plan(table, plan)
        statics = dict(gc_width=d["gc_width"], b=d["b"], k=table.max_peaks,
                       nrows=self._nrows_b, ncols=self.ds.ncols,
                       nlevels=self.nlevels)
        tail = (d["starts"], d["r_lo_loc"], d["r_hi_loc"], d["inv"],
                d["theor_ints"], d["n_valid"], self._n_real)
        statics["scales"] = self._scales
        if variant == "fused":
            out = score_flat_fused(self._px_s, self._in_s, d["pos"], *tail,
                                   **statics)
        elif variant == "plain":
            out = score_flat_plain(
                self._px_s, self._in_s, d["pos"], *tail, **statics,
                do_preprocessing=self.do_preprocessing, q=self.q)
        elif variant == "band" and plan.band is not None:
            b_lo, width = plan.band
            out = score_flat_sliced(
                self._px_s, self._in_s, b_lo, width, d["pos"], *tail,
                **statics, do_preprocessing=self.do_preprocessing, q=self.q)
        elif variant == "compact" and plan.runs is not None:
            run_pos, run_delta, n_b, pos_b = plan.runs
            out = score_flat_compact(
                self._px_s, self._in_s, self._put(run_pos, torch.int64),
                self._put(run_delta, torch.int64), n_b,
                self._put(pos_b, torch.int64), *tail, **statics,
                do_preprocessing=self.do_preprocessing, q=self.q)
        else:
            raise ValueError(f"flat variant {variant!r} is not planned for "
                             "this backend")
        self.variant_counts[variant] += 1
        if self._n_real is not None:
            shape_buckets.record_spec(self._bucket_spec(variant, plan, d,
                                                        table.max_peaks))
        return out

    def _bucket_spec(self, variant: str, plan: FlatPlan, d: dict,
                     k: int) -> dict:
        """The batch's BucketSpec (``ops/buckets.py``) under the JAX
        package's keys and values: the same batch on the same variant names
        the same spec in both packages.  The band and compact capacities
        are the JAX package's padding (its ``band_bucket`` and sticky
        compaction capacities); the port pads neither."""
        # smlint: spec-key-ok[resident slots are peak_bucket-padded at set-up]
        n = int(self._px_s.shape[0])
        n_keep = r_pad = w_cap = 0
        if variant == "compact":
            run_pos, _delta, n_b, _pos_b = plan.runs
            want = min(-(-max(n_b, 1) // (1 << 16)) * (1 << 16), max(1, n))
            self._spec_n_keep = n_keep = max(self._spec_n_keep, want)
            self._spec_r_pad = r_pad = max(
                self._spec_r_pad, -(-max(run_pos.size, 1) // 4096) * 4096)
        elif variant == "band":
            w_cap = min(shape_buckets.band_bucket(plan.band[1]),
                        int(self._mz_host.size))
        r_lo_loc = d["r_lo_loc"]
        spec = {
            "kind": "flat", "variant": variant,
            "nrows": int(self._nrows_b), "ncols": int(self.ds.ncols),
            "nlevels": int(self.nlevels),
            "do_preprocessing": bool(self.do_preprocessing),
            "q": float(self.q),
            "n_resident": n, "b": int(d["b"]), "k": int(k),
            "gc_width": int(d["gc_width"]),
            "n_keep": n_keep, "r_pad": r_pad, "w_cap": w_cap,
            # smlint: spec-key-ok[2bk bounds of a padded batch; b on a ladder]
            "g": int(plan.pos.shape[0]),
            # smlint: spec-key-ok[a padded batch's chunks: b and k bound them]
            "c": int(r_lo_loc.shape[0]), "wc": int(r_lo_loc.shape[1]),
            "devices": 1,
        }
        if self.cube_dtype != "f32":
            spec["cube_dtype"] = self.cube_dtype
        return spec

    def image_block(self, table: IsotopePatternTable,
                    plan: FlatPlan | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(images, theor_ints, n_valid)`` of one padded batch, in the
        plan's ion order (the table's on the cube path), as its metrics
        receive them: the (b, k, P) image block with the images of invalid
        isotope peaks zeroed (P is the row-bucketed pixel count, ``n_real``
        the real one), the (b, k) theoretical intensities and the (b,)
        valid peak counts.  Extraction takes the plain variant and the
        images are not hot-spot clipped, as in the JAX package's export."""
        k = table.max_peaks
        if self.mz_chunk:
            d = self._cube_plan(table)
            imgs = extract_images_mz_chunked(
                self._mz_q, self._ints, d["grid"], d["starts"],
                d["r_lo_loc"], d["r_hi_loc"], d["inv"],
                gc_width=d["gc_width"]).view(self.batch, k, -1)
        else:
            d = self._device_plan(table, plan)
            imgs = _extract_plain(
                self._px_s, self._in_s, d["pos"], d["starts"], d["r_lo_loc"],
                d["r_hi_loc"], gc_width=d["gc_width"], b=d["b"], k=k,
                n_pixels=self._n_pix_b, scales=self._scales)
        valid = (torch.arange(k, dtype=torch.int64,
                              device=self.device)[None, :]
                 < d["n_valid"][:, None])
        return (imgs.masked_fill_(~valid[:, :, None], 0.0), d["theor_ints"],
                d["n_valid"])

    def extract_ion_images(self, table: IsotopePatternTable) -> np.ndarray:
        """(n_ions, K, n_pixels) f32 ion images of ``table``, in its ion
        order, from the device extraction (``image_block``): the exact-pixel
        prefix of the row-bucketed grid, divided by the intensity grid's
        power-of-two scale (exact), the images of invalid isotope peaks
        zero.  Bit-equal to the JAX backend's ``extract_ion_images`` and to
        ``ops/imager_np`` (shared integer grids).  Tables longer than the
        backend's batch are extracted batch by batch."""
        from .msm_basic import _slice_table

        n, b = table.n_ions, self.batch
        if n > b:
            return np.concatenate([
                self.extract_ion_images(_slice_table(table, s, min(s + b, n)))
                for s in range(0, n, b)])
        if self.mz_chunk:
            imgs, _theor, _n_valid = self.image_block(table)
        else:
            plan = self._flat_plan(table)
            imgs, _theor, _n_valid = self.image_block(table, plan)
            # the plan's ion order back to the table's
            imgs = imgs[self._put(plan.chunks[3], torch.int64)]
        # smlint: host-sync-ok[the export fetches its ion images once]
        out = imgs[:n, :, :self.ds.n_pixels].cpu().numpy()
        out /= np.float32(self.int_scale)
        return out

    @property
    def resident_peaks(self) -> int:
        """Peak slots resident on the device: the flat path's sorted,
        restricted and lattice-padded slots; the cube path's (P, L) slots."""
        if self.mz_chunk:
            return int(self._mz_q.numel())
        return int(self._mz_host.size)

    def band_shapes(self, tables) -> list[tuple[int, int, int]]:
        """``(windows, gc_width, grid_bins)`` of each flat-path batch of
        ``tables`` as a stream of them launches it: the windows its banded
        matmuls compute (the chunk plan's C x Wc), the band width they run
        at (the sticky width of the batch's size, grown over ``tables``
        first, as ``score_batches`` grows it) and the bound grid's bins —
        what ``ops/imager.banded_score_cost_model`` prices."""
        if self.mz_chunk:
            raise ValueError("band_shapes prices the flat path; this "
                             "backend scores the mz_chunk cube")
        plans = [self._flat_plan(t) for t in tables]
        for plan in plans:
            self._grow_from_plan(plan)
        return [(int(plan.chunks[1].size),
                 self._gc_width if plan.b_eff == self.batch
                 else self._gc_tail, int(plan.pos.size)) for plan in plans]

    @property
    def n_real(self) -> int | None:
        """Real pixel count of the image rows (None off the lattice)."""
        return self._n_real

    @property
    def grid(self) -> tuple[int, int]:
        """(rows, cols) of the scored images: rows are row-bucketed under
        the lattice."""
        return self._nrows_b, self.ds.ncols

    def score_batch(self, table: IsotopePatternTable) -> np.ndarray:
        """(n_ions, 4) f64 metrics of one batch."""
        out = self._dispatch(table)
        # smlint: host-sync-ok[the batch's metric rows are its result]
        return out[:table.n_ions].cpu().numpy().astype(np.float64)

    def score_batches(self, tables, cancel=None) -> list[np.ndarray]:
        """Score a list of batches: plan all first (pre-sizing the sticky
        band widths to the stream's max), enqueue every batch, then copy the
        results to the host.  ``cancel`` (a ``CancelToken``) is checked
        between batches.  The copy stays here: a device error of any batch
        surfaces at it, inside the caller's fault handling."""
        tables = list(tables)
        plans = ([None] * len(tables) if self.mz_chunk
                 else [self._flat_plan(t) for t in tables])
        for plan in plans:
            if plan is not None:
                self._grow_from_plan(plan)
        outs = []
        dev_attr = ({"device": int(self.device.index)}
                    if self.device.index is not None else {})
        for t, plan in zip(tables, plans):
            if cancel is not None:
                cancel.check("score_batch")
            # a per-batch scoring span, as the JAX backend's: on the card it
            # measures the enqueue (the copies below settle the device work)
            with tracing.span("score_batch", backend="torch_cuda",
                              ions=int(t.n_ions), enqueue=True, **dev_attr):
                outs.append(self._dispatch(t, plan))
        # smlint: host-sync-ok[rows fetched once, after every batch is queued]
        return [o[:t.n_ions].cpu().numpy().astype(np.float64)
                for o, t in zip(outs, tables)]

    def _variant_of(self, plan: FlatPlan) -> str:
        """The flat variant ``_dispatch`` takes for ``plan`` by default."""
        return "fused" if self._fused else self._variant_for(plan.runs,
                                                             plan.band)

    def warmup(self, tables) -> None:
        """Pre-size the sticky band widths on ``tables`` and score one batch
        of each variant they take, so every kernel of the stream is built,
        loaded and set up on the device before the first timed batch (the
        mesh's ``warmup``, ``parallel/sharded.py``).  The cube path scores
        the first batch.  ``last_warmup_skipped`` stays False: the JAX
        backend's manifest trim has no counterpart here."""
        tables = list(tables)
        self.last_warmup_skipped = False
        if self.mz_chunk:
            if tables:
                self.score_batch(tables[0])
            return
        plans = [self._flat_plan(t) for t in tables]
        for plan in plans:
            self._grow_from_plan(plan)
        seen: set = set()
        for t, plan in zip(tables, plans):
            variant = self._variant_of(plan)
            if variant not in seen:
                seen.add(variant)
                # smlint: host-sync-ok[warm-up waits out each variant once]
                self._dispatch(t, plan, variant).cpu()

    def probe_phases(self, table: IsotopePatternTable):
        """Per-phase launch hooks for profiling: ``(phases, info)``, where
        ``phases`` maps the JAX backend's phase names to zero-argument
        callables, each launching on the device the step ``score_batch``
        launches for this batch, through the same step functions, with the
        same tensors and the same variant, and returning its device output:

        - ``fused_full``: the whole batch (``_dispatch``);
        - ``extract``: the variant's extraction step, then ``mask_block``
          (the images of invalid peaks zeroed, hot-spot clipped with
          ``do_preprocessing``); on the fused variant the histogram;
        - ``moments``: the moments kernel over that block; on the fused
          variant the fused window-moments kernel over the histogram and
          ``moments_from_partials``;
        - ``chaos``, ``correlation``, ``pattern``: the epilogue's steps on
          those moments (``msm_combine`` of the three, un-permuted by the
          plan, is the batch's metric rows).

        The steps chain: each reads what the latest call of the one before
        it returned, and all of them ran once before the hooks are handed
        out.  ``info`` names the path, the variant and the batch's shapes.
        The cube path has ``fused_full`` only, as the JAX backend's."""
        if self.mz_chunk:
            return ({"fused_full": lambda: self._dispatch(table)},
                    {"path": "mz_chunk"})
        from ..ops.metrics import (
            correlation_from_moments,
            isotope_pattern_match_batch,
            mask_block,
            measure_of_chaos_batch,
            moments_from_partials,
        )
        from ..ops.moments import batch_moments

        plan = self._flat_plan(table)
        variant = self._variant_of(plan)
        d = self._device_plan(table, plan)
        b, k, n_pix, gc = d["b"], table.max_peaks, self._n_pix_b, d["gc_width"]
        nrows, ncols = self._nrows_b, self.ds.ncols
        theor, n_valid = d["theor_ints"], d["n_valid"]
        chunk = (d["starts"], d["r_lo_loc"], d["r_hi_loc"])
        shape = dict(gc_width=gc, b=b, k=k, n_pixels=n_pix)
        state: dict = {}
        if variant == "fused":
            def extract():
                state["wh"] = _fused_scratch(
                    self._px_s, self._in_s, d["pos"], gc_width=gc,
                    n_pixels=n_pix, scales=self._scales)
                return state["wh"]

            def moments():
                partials, principal = _fused_moments(
                    state["wh"], *chunk, self._n_real, **shape)
                *mom, state["valid"] = moments_from_partials(
                    partials, principal, n_valid)
                state["principal"], state["moments"] = principal, tuple(mom)
                return state["moments"]
        else:
            if variant == "band":
                b_lo, width = plan.band
                block = lambda: _extract_band(  # noqa: E731
                    self._px_s, self._in_s, b_lo, width, d["pos"], *chunk,
                    **shape, scales=self._scales)
            elif variant == "compact":
                run_pos, run_delta, n_b, pos_b = plan.runs
                args = (self._put(run_pos, torch.int64),
                        self._put(run_delta, torch.int64), n_b,
                        self._put(pos_b, torch.int64))
                block = lambda: _extract_compact(  # noqa: E731
                    self._px_s, self._in_s, *args, *chunk, **shape,
                    scales=self._scales)
            else:
                block = lambda: _extract_plain(  # noqa: E731
                    self._px_s, self._in_s, d["pos"], *chunk, **shape,
                    scales=self._scales)

            def extract():
                imgs = block()
                state["valid"] = mask_block(imgs, n_valid,
                                            self.do_preprocessing, self.q)
                state["imgs"], state["principal"] = imgs, imgs[:, 0, :]
                return imgs

            def moments():
                state["moments"] = batch_moments(state["imgs"], self._n_real)
                return state["moments"]

        def chaos():
            _sums, _normsq, _dots, vmax, n_notnull = state["moments"]
            return measure_of_chaos_batch(state["principal"], nrows, ncols,
                                          self.nlevels, vmax, n_notnull)

        def correlation():
            _sums, normsq, dots, _vmax, _nn = state["moments"]
            return correlation_from_moments(normsq, dots, theor,
                                            state["valid"])

        def pattern():
            return isotope_pattern_match_batch(state["moments"][0], theor,
                                               state["valid"])

        extract()
        moments()
        phases = {"fused_full": lambda: self._dispatch(table, plan, variant),
                  "extract": extract, "moments": moments, "chaos": chaos,
                  "correlation": correlation, "pattern": pattern}
        info = dict(path="flat", variant=variant, b=int(b), k=int(k),
                    gc_width=int(gc), nrows=int(nrows), ncols=int(ncols),
                    nlevels=int(self.nlevels),
                    resident_peaks=self.resident_peaks,
                    grid_bins=int(plan.pos.size),
                    band_width=int(plan.band[1]) if plan.band else 0,
                    kept_peaks=int(plan.runs[2]) if plan.runs else 0)
        return phases, info
