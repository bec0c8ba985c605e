"""PyTorch backend: ion-image extraction and MSM scoring on one device.

Port of ``sm_distributed_tpu/models/msm_jax.py`` (``JaxBackend``), with
three scorers:

- :func:`score_flat_plain` (``fused_score_fn_flat_banded``), the default:
  resident m/z-sorted flat peaks, banded extraction (``ops/imager.py``),
  then ``ops/metrics.batch_metrics``, whose moments and chaos steps are the
  hand-written kernels on the card;
- :func:`score_flat_fused` (``fused_score_fn_flat_fused``) with
  ``parallel.fused_metrics="on"``: the same histogram, then the fused
  window-moments kernel (``ops/score.py``), which writes only the moment
  partials and the principal rows, then
  ``ops/metrics.batch_metrics_from_partials``;
- :func:`score_chunked` (``fused_score_fn_chunked``) with
  ``parallel.mz_chunk > 0``: the resident dense cube and the m/z-chunked
  extraction, whose scratch is bounded at (P, gc_width+2) — the path of
  whole-slide images, whose flat scratch no batch size fits.

Each formula batch is planned on the host (padded windows, bound ranks, the
chunk plan).  On the flat paths the shape-bucket lattice is mirrored so the
port scores exactly the padded shapes the JAX package does: image rows snap
up to ``row_bucket(nrows)`` (zero rows, masked by the real pixel count),
resident peak arrays pad to ``peak_bucket`` slots, and the pad-to batch
snaps down to the lattice.  The cube path stays off the row lattice, as in
the JAX package.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..io.dataset import SpectralDataset
from ..ops import buckets as shape_buckets
from ..ops.imager import (
    BAND_WINDOWS,
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
from ..ops.quantize import MZ_PAD_Q, quantize_window
from ..utils.config import DSConfig, SMConfig

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
) -> torch.Tensor:
    """(b, 4) metrics of one padded batch, in the table's ion order — the
    port of ``fused_score_fn_flat_banded``.  The chunk plan is ion-major, so
    extraction emits the (b, k, P) block directly and only the metric rows
    are un-permuted by ``inv``."""
    imgs = extract_images_flat_banded(
        pixel_sorted, int_sorted, pos, starts, r_lo_loc, r_hi_loc, None,
        gc_width=gc_width, n_pixels=nrows * ncols)
    out = batch_metrics(imgs.view(b, k, -1), theor_ints, n_valid, nrows,
                        ncols, nlevels, n_real=n_real)
    return out[inv]


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
) -> torch.Tensor:
    """(b, 4) metrics of one padded batch through the fused window-moments
    kernel, in the table's ion order — the port of
    ``fused_score_fn_flat_fused``.  The histogram is the plain path's; the
    kernel reads exactly the band rows the plain path's matmuls read, and
    the metric rows are un-permuted by ``inv``."""
    n_pix = nrows * ncols
    wh = flat_histogram(pixel_sorted, int_sorted, pos, gc_width=gc_width,
                        n_pixels=n_pix)
    partials, principal = fused_window_moments(
        wh[:, :n_pix], starts, r_lo_loc, r_hi_loc,
        n_pix if n_real is None else n_real, gc_width=gc_width, k=k)
    del wh
    out = batch_metrics_from_partials(
        partials.view(b, k, 5), principal.view(b, n_pix), theor_ints, n_valid,
        nrows, ncols, nlevels)
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
) -> torch.Tensor:
    """(b, 4) metrics of one padded batch on the m/z-chunked cube path, in
    the table's ion order — the port of ``fused_score_fn_chunked``.  The
    cube path is off the row lattice, so the moments are unmasked."""
    imgs = extract_images_mz_chunked(
        mz_q_cube, int_cube, grid, starts, r_lo_loc, r_hi_loc, inv,
        gc_width=gc_width)
    imgs = imgs.view(b, k, -1)[:, :, :nrows * ncols]
    return batch_metrics(imgs, theor_ints, n_valid, nrows, ncols, nlevels,
                         n_real=None)


class TorchBackend:
    """Scorer selected by ``SMConfig.backend == 'torch_cuda'``: the flat path
    (plain chain, or the fused kernel with ``fused_metrics="on"``), or the
    cube path with ``mz_chunk > 0``."""

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
        self._nrows_b = (shape_buckets.row_bucket(ds.nrows)
                         if self._buckets else ds.nrows)
        self._n_pix_b = self._nrows_b * ds.ncols
        # real pixel count for the masked moments; None off the lattice
        self._n_real = ds.n_pixels if self._buckets else None
        self.int_scale = ds.intensity_quantization(self.ppm)[1]
        self.mz_chunk = max(0, sm_config.parallel.mz_chunk)
        if self.mz_chunk:
            self._init_cube(ds, restrict_table)
        else:
            self._init_flat(ds, ds_config, restrict_table)
        # "on" takes the fused kernel; "auto" keeps the plain chain on every
        # device until the fused kernel beats it on the card (ROADMAP)
        self._fused = sm_config.parallel.fused_metrics == "on"
        # sticky chunk band widths: grow to the max seen in a stream
        self._gc_width = 0
        self._gc_tail = 0

    def _init_cube(self, ds: SpectralDataset,
                   restrict_table: IsotopePatternTable | None) -> None:
        """The dense quantized cube, resident.  Off the row lattice: the
        cube's rows are per-dataset anyway."""
        if restrict_table is not None:
            logger.info("window-union restriction not applicable on the "
                        "mz_chunk cube path (dense per-pixel rows); scoring "
                        "the full cube")
        mz_q, int_cube = prepare_cube_arrays(ds, ppm=self.ppm)
        self._mz_q = torch.from_numpy(mz_q).to(self.device)
        self._ints = torch.from_numpy(int_cube).to(self.device)
        logger.info("torch_cuda cube resident: %s int32 + %s f32 on %s",
                    tuple(mz_q.shape), tuple(int_cube.shape), self.device)
        self._nrows_b = ds.nrows
        self._n_pix_b = ds.n_pixels
        self._n_real = None

    def _init_flat(self, ds: SpectralDataset, ds_config: DSConfig,
                   restrict_table: IsotopePatternTable | None) -> None:
        """The m/z-sorted flat peaks, resident and lattice-padded."""
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
        self._mz_host = mz_s
        self._px_s = torch.from_numpy(px_s.astype(np.int64)).to(self.device)
        self._in_s = torch.from_numpy(in_s).to(self.device)
        logger.info("torch_cuda flat peaks resident: %d sorted peaks on %s",
                    mz_s.size, self.device)

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

    def _flat_plan(self, table: IsotopePatternTable):
        """Host plan of one batch: (grid, r_lo, r_hi, ints_p, nv_p, chunks,
        pos, b_eff)."""
        b_eff = self._batch_for(table.n_ions)
        grid, r_lo, r_hi, ints_p, nv_p = self._padded_windows(table, b_eff)
        k_eff = max(1, table.max_peaks)
        chunks = ion_window_chunks(
            r_lo, r_hi, b_eff, k_eff,
            ions_per_chunk_for(b_eff, k_eff, BAND_WINDOWS))
        pos = flat_bound_ranks(self._mz_host, grid)
        return grid, r_lo, r_hi, ints_p, nv_p, chunks, pos, b_eff

    def _grow_from_plan(self, plan) -> None:
        gc = plan[5][4]
        if plan[7] == self.batch:
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

    def _device_plan(self, table: IsotopePatternTable, plan=None) -> dict:
        """One batch's plan with its per-batch arrays on the device: bound
        ranks, chunk plan, ion un-permutation and the plan-sorted side
        inputs, at the sticky band width."""
        if plan is None:
            plan = self._flat_plan(table)
        _grid, _r_lo, _r_hi, ints_p, nv_p, chunks, pos, b_eff = plan
        starts, r_lo_loc, r_hi_loc, inv, _gc_width, order = chunks
        self._grow_from_plan(plan)
        put = self._put
        return dict(
            pos=put(pos, torch.int64), starts=starts, r_lo_loc=put(r_lo_loc),
            r_hi_loc=put(r_hi_loc), inv=put(inv, torch.int64),
            theor_ints=put(ints_p[order]), n_valid=put(nv_p[order]),
            gc_width=(self._gc_width if b_eff == self.batch
                      else self._gc_tail), b=b_eff)

    def _put(self, a: np.ndarray, dtype: torch.dtype | None = None
             ) -> torch.Tensor:
        """A host array on the backend's device."""
        t = torch.from_numpy(np.ascontiguousarray(a))
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

    def _dispatch(self, table: IsotopePatternTable, plan=None
                  ) -> torch.Tensor:
        """Enqueue one padded batch on the device; returns its (b, 4)
        metrics (on the device, not synchronised)."""
        if self.mz_chunk:
            d = self._cube_plan(table)
            return score_chunked(
                self._mz_q, self._ints, d["grid"], d["starts"],
                d["r_lo_loc"], d["r_hi_loc"], d["inv"], d["theor_ints"],
                d["n_valid"], gc_width=d["gc_width"], b=self.batch,
                k=table.max_peaks, nrows=self._nrows_b, ncols=self.ds.ncols,
                nlevels=self.nlevels)
        d = self._device_plan(table, plan)
        score = score_flat_fused if self._fused else score_flat_plain
        return score(
            self._px_s, self._in_s, d["pos"], d["starts"], d["r_lo_loc"],
            d["r_hi_loc"], d["inv"], d["theor_ints"], d["n_valid"],
            self._n_real, gc_width=d["gc_width"], b=d["b"],
            k=table.max_peaks, nrows=self._nrows_b, ncols=self.ds.ncols,
            nlevels=self.nlevels)

    def image_block(self, table: IsotopePatternTable
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(images, theor_ints, n_valid)`` of one padded batch, in the
        plan's ion order (the table's on the cube path), as its metrics
        receive them: the (b, k, P) image block with the images of invalid
        isotope peaks zeroed (P is the row-bucketed pixel count, ``n_real``
        the real one), the (b, k) theoretical intensities and the (b,)
        valid peak counts."""
        k = table.max_peaks
        if self.mz_chunk:
            d = self._cube_plan(table)
            imgs = extract_images_mz_chunked(
                self._mz_q, self._ints, d["grid"], d["starts"],
                d["r_lo_loc"], d["r_hi_loc"], d["inv"],
                gc_width=d["gc_width"]).view(self.batch, k, -1)
        else:
            d = self._device_plan(table)
            imgs = extract_images_flat_banded(
                self._px_s, self._in_s, d["pos"], d["starts"], d["r_lo_loc"],
                d["r_hi_loc"], None, gc_width=d["gc_width"],
                n_pixels=self._n_pix_b).view(d["b"], k, -1)
        valid = (torch.arange(k, device=self.device)[None, :]
                 < d["n_valid"][:, None])
        return (imgs.masked_fill_(~valid[:, :, None], 0.0), d["theor_ints"],
                d["n_valid"])

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
        return out[:table.n_ions].cpu().numpy().astype(np.float64)

    def score_batches(self, tables) -> list[np.ndarray]:
        """Score a list of batches: plan all first (pre-sizing the sticky
        band widths to the stream's max), enqueue every batch, then copy the
        results to the host."""
        tables = list(tables)
        if self.mz_chunk:
            outs = [self._dispatch(t) for t in tables]
        else:
            plans = [self._flat_plan(t) for t in tables]
            for plan in plans:
                self._grow_from_plan(plan)
            outs = [self._dispatch(t, plan) for t, plan in zip(tables, plans)]
        return [o[:t.n_ions].cpu().numpy().astype(np.float64)
                for o, t in zip(outs, tables)]
