"""Ion-image extraction on the flat, m/z-sorted resident-peak layout and on
the m/z-chunked dense cube.

Port of the flat-banded and m/z-chunked paths of
``sm_distributed_tpu/ops/imager_jax.py``.  The host planners below are
copies (the JAX module imports jax at its top, so the port keeps its own):
the window-bound rank grid, the globally m/z-sorted peak arrays, bound
ranks, the window-union restriction, the ion-major and window-major chunk
plans and the quantized cube.  ``extract_images_flat_banded`` is the flat
path's device step in torch:

1. bins from a delta array and a cumsum (``bins[j] = #{g: grid[g] <= mz[j]}``);
2. a histogram scatter-add (``index_put_(accumulate=True)``) of the integer
   grid intensities into the bins-major ``(cols, P+1)`` scratch;
3. per chunk of windows, a banded membership matmul ``d.T @ band``.

``extract_images_mz_chunked`` is the cube path's: one searchsorted of the
cube against the batch's bound grid, then per chunk a scatter-add into a
``(P, gc_width+2)`` scratch and one membership matmul.

The flat path's histogram may take a subset of the resident peaks, as the
JAX package's extraction variants do: the contiguous rank band a batch's
window union spans (``batch_peak_band``; the band variant scatters the
slice ``px_s[b_lo:b_lo + width]`` with its bound ranks shifted by
``b_lo``), or the peaks inside the union only (``batch_peak_runs``, then
``compact_peaks`` gathers them on the device).  Unlike the JAX package,
nothing is padded to a fixed capacity: eager torch needs no static shapes,
so the band is a view of exactly ``width`` slots (no ``band_bucket``
ladder, no clamp of its start) and the compaction gathers exactly ``n_b``
slots (no pad slots pointed at an out-of-range pixel, which a CUDA
``index_put_`` would fault on rather than drop).  The sharded path
(``parallel/sharded.py``) does the same in every cell of its mesh.

Exactness: intensities sit on the shared integer grid with every
per-(pixel, window) sum below 2**24, so the scatter's atomics and the
matmul's accumulation are exact in f32 in any order, and over any subset
of the peaks that keeps every in-window one — images are bit-equal to the
JAX package's, provided the matmul runs in full f32 (no TF32; the backend
sets and checks this).
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.dataset import SpectralDataset
from .quantize import MZ_PAD_Q, expand_cube_at, quantize_mz

# windows per band chunk in the flat-banded extraction (each chunk's
# membership matmul covers ~2*BAND_WINDOWS grid columns)
BAND_WINDOWS = 512


def window_rank_grid(
    lo_q: np.ndarray, hi_q: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: (grid (2W,) int32 sorted, r_lo (W,), r_hi (W,) int32).

    ``grid`` is the sorted multiset of all window bounds; ``r_*`` are each
    bound's LEFTMOST rank in the grid.  Exactness: a peak lies in window w
    iff lo_q[w] <= mz_q < hi_q[w], and #\\{mz_q < b\\} == #peaks whose grid
    bin is <= leftmost_rank(b) (strictly-below counting survives duplicate
    bounds because equal bounds share the leftmost rank)."""
    lo_flat = np.ascontiguousarray(lo_q, dtype=np.int32).ravel()
    hi_flat = np.ascontiguousarray(hi_q, dtype=np.int32).ravel()
    # NOTE: the grid keeps duplicate bounds (fixed 2W size) on purpose — a
    # deduplicated grid has a data-dependent length, so every batch would
    # take a new shape for nearly nothing saved (real batches are almost all
    # unique bounds anyway).
    grid = np.sort(np.concatenate([lo_flat, hi_flat]))
    r_lo = np.searchsorted(grid, lo_flat, side="left").astype(np.int32)
    r_hi = np.searchsorted(grid, hi_flat, side="left").astype(np.int32)
    return grid, r_lo, r_hi


def prepare_flat_sorted_arrays(
    ds: SpectralDataset,
    ppm: float,
    pad_to_multiple: int = 1024,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: globally m/z-sorted flat peak arrays
    (mz_q (N,) int32 ascending, pixel (N,) int32, int (N,) f32 integer grid).

    Padding: m/z saturates to the MZ_PAD_Q sentinel, pixel points at an
    overflow row (``ds.n_pixels``, sliced off before the matmul), intensity 0.
    The single-device layout IS the 1-shard case of the sharded layout.
    """
    mz_s, px_s, in_s, _p_loc = prepare_flat_sharded_arrays(
        ds, ppm, n_shards=1, pad_to_multiple=pad_to_multiple)
    return mz_s[0], px_s[0], in_s[0]


def flat_bound_ranks(mz_sorted_host: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Host-side per-batch: rank of each grid bound among the sorted peaks,
    ``pos[g] = #{peaks with mz < grid[g]}``.  G binary searches into the
    host copy of the dataset-static sorted m/z array; only the (G,) ranks
    go to the device, which turns them into per-peak bins with a delta
    array and a cumsum."""
    return np.searchsorted(mz_sorted_host, grid, side="left").astype(np.int32)


def prepare_flat_sharded_arrays(
    ds: SpectralDataset,
    ppm: float,
    n_shards: int = 1,
    pad_to_multiple: int = 1024,
    p_loc: int | None = None,
    slot_bucket=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side flat layout per PIXEL SHARD: (mz_q (S, Nmax) int32 ascending
    per row, px_local (S, Nmax) int32, ints (S, Nmax) f32, p_loc).

    Each shard owns a contiguous slice of ``p_loc = ceil(P/S)`` pixels and
    its peaks sorted by quantized m/z; rows pad to the max shard peak count
    rounded up to ``pad_to_multiple`` (m/z -> MZ_PAD_Q sentinel, pixel ->
    the shard-local overflow row ``p_loc``, intensity 0).

    ``p_loc`` (the shape-bucket lattice): an explicit per-shard pixel
    capacity >= ceil(P/S); the sharded backend passes a row-bucketed
    whole-row capacity, so trailing shards may be partly or wholly padding.
    ``slot_bucket`` replaces the ``pad_to_multiple`` rounding of the
    peak-slot capacity with the shared lattice (``ops/buckets.peak_bucket``).
    """
    if p_loc is None:
        p_loc = -(-ds.n_pixels // n_shards)
    elif p_loc * n_shards < ds.n_pixels:
        raise ValueError(
            f"p_loc={p_loc} x {n_shards} shards cannot hold "
            f"{ds.n_pixels} pixels")
    mz_q = quantize_mz(ds.mzs_flat)
    ints_q, _scale = ds.intensity_quantization(ppm)
    lens = ds.row_lengths()
    pixel = np.repeat(np.arange(ds.n_pixels, dtype=np.int64), lens)
    shard = (pixel // p_loc).astype(np.int32)
    counts = np.bincount(shard, minlength=n_shards)
    if slot_bucket is not None:
        n_max = int(slot_bucket(max(int(counts.max()), 1)))
    else:
        n_max = -(-max(int(counts.max()), 1)
                  // pad_to_multiple) * pad_to_multiple
    mz_s = np.full((n_shards, n_max), MZ_PAD_Q, dtype=np.int32)
    px_s = np.full((n_shards, n_max), p_loc, dtype=np.int32)
    in_s = np.zeros((n_shards, n_max), dtype=np.float32)
    for s in range(n_shards):
        m = shard == s
        order = np.argsort(mz_q[m], kind="stable")
        c = int(counts[s])
        mz_s[s, :c] = mz_q[m][order]
        px_s[s, :c] = (pixel[m] - s * p_loc).astype(np.int32)[order]
        in_s[s, :c] = ints_q[m][order]
    return mz_s, px_s, in_s, p_loc


def gc_ladder(span: int) -> int:
    """Static chunk band width for a window span: smallest {1, 1.5} x
    pow-2 point >= span (the one rule for every chunk plan's band
    width)."""
    cap = 2
    while cap < span:
        cap <<= 1
    mid = (cap >> 2) * 3
    return mid if span <= mid and mid >= 2 else cap


def ions_per_chunk_for(b: int, k: int, window_budget: int) -> int:
    """Largest divisor of the static batch ``b`` whose k-window block
    stays within ``window_budget`` windows per chunk (the shared rule for
    ion-major chunk plans)."""
    ipc = max(1, min(window_budget // max(k, 1), b))
    while b % ipc:
        ipc -= 1
    return ipc


def merged_window_bounds(lo_q: np.ndarray, hi_q: np.ndarray) -> np.ndarray:
    """Host-side: the union of half-open quantized windows [lo, hi) as a
    flat sorted boundary array [lo1, hi1, lo2, hi2, ...] of DISJOINT
    intervals.  Membership test: searchsorted(flat, mz, 'right') is odd."""
    lo = np.asarray(lo_q, dtype=np.int64).ravel()
    hi = np.asarray(hi_q, dtype=np.int64).ravel()
    real = lo < hi                       # drop empty windows (batch padding)
    lo, hi = lo[real], hi[real]
    if lo.size == 0:
        return np.zeros(0, dtype=np.int32)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    run_hi = np.maximum.accumulate(hi)
    # a new disjoint interval starts where lo exceeds every prior hi
    # (touching intervals merge too, keeping the parity test valid)
    new = np.concatenate([[True], lo[1:] > run_hi[:-1]])
    starts = lo[new]
    ends = run_hi[np.concatenate([new[1:], [True]])]
    return np.stack([starts, ends], axis=1).ravel().astype(np.int32)


def batch_peak_band(mz_host: np.ndarray, lo_q: np.ndarray,
                    hi_q: np.ndarray) -> tuple[int, int]:
    """Host-side: the CONTIGUOUS rank band [start, start+width) of the
    sorted resident peaks spanned by a batch's window union.  For an
    m/z-ordered ion table every batch's union is m/z-localized, so the band
    is narrow; extraction can then scatter a slice of the resident arrays
    directly (no per-run gather) — see
    models/msm_torch.py::score_flat_sliced."""
    flat = merged_window_bounds(lo_q, hi_q)
    if flat.size == 0:
        return 0, 0
    cuts = np.searchsorted(
        mz_host, np.array([flat[0], flat[-1]], dtype=mz_host.dtype),
        side="left")
    return int(cuts[0]), int(cuts[1] - cuts[0])


def batch_peak_runs(
    mz_host: np.ndarray,   # (N,) int32 sorted quantized m/z (resident peaks)
    lo_q: np.ndarray,      # batch window lo bounds (any shape)
    hi_q: np.ndarray,      # batch window hi bounds
    pos: np.ndarray,       # (G,) int32 source-space bound ranks (flat_bound_ranks)
) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
    """Host-side compaction plan: (run_kept_start (R,) i32, run_delta (R,) i32,
    n_b, pos_b (G,) i32).

    The batch's windows merge into disjoint m/z intervals that cut the
    sorted peaks into contiguous kept RUNS.  ``run_kept_start`` is each
    run's first index in kept space, ``run_delta`` the jump in (source -
    kept) offset at that index; ``pos_b`` re-bases the grid bound ranks to
    kept space: #kept peaks strictly below the bound."""
    flat = merged_window_bounds(lo_q, hi_q)
    cuts = np.searchsorted(mz_host, flat.astype(mz_host.dtype), side="left")
    starts, ends = cuts[0::2].astype(np.int64), cuts[1::2].astype(np.int64)
    lens = ends - starts
    keep = lens > 0
    starts, lens = starts[keep], lens[keep]
    if starts.size == 0:     # batch with no real windows (all padding)
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), 0,
                np.zeros(np.asarray(pos).shape, np.int32))
    kept_start = np.zeros(starts.size + 1, dtype=np.int64)
    np.cumsum(lens, out=kept_start[1:])
    n_b = int(kept_start[-1])
    # kept rank of a source rank s: walk back to the last run starting <= s;
    # clamp inside the run (bounds between runs — possible only for empty
    # padding windows — snap to the nearest run edge, which keeps their
    # windows empty in kept space)
    r = np.searchsorted(starts, pos, side="right") - 1
    rc = np.clip(r, 0, None)
    pos_b = np.where(
        r < 0, 0,
        kept_start[rc] + np.clip(pos - starts[rc], 0, lens[rc]))
    offsets = starts - kept_start[:-1]
    run_delta = np.diff(offsets, prepend=0)
    return (kept_start[:-1].astype(np.int32), run_delta.astype(np.int32),
            n_b, pos_b.astype(np.int32))


def compact_peaks(
    px_s: torch.Tensor,       # (N,) int64 resident pixel rows
    in_s: torch.Tensor,       # (N,) resident intensities (f32, bf16, int8)
    run_pos: torch.Tensor,    # (R,) int64 kept-space run starts (< n_b)
    run_delta: torch.Tensor,  # (R,) int64 source-offset jumps
    n_b: int,
    scales: torch.Tensor | None = None,  # (N/QTILE,) f32 int8 tile scales
) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side gather of a batch's kept peak slots: (px_b, in_b), both
    (n_b,), ``in_b`` in f32.  The source index of kept slot j is j plus the
    running sum of the run jumps at or before j: one ``index_add_`` of the
    jumps into an (n_b,) delta array, a ``cumsum``, then the gather (of a
    compact cube's codes, expanded with their gathered tile scales).  Every
    run starts below ``n_b``, so no index leaves its array (the JAX package
    instead pads to a fixed capacity and drops the pad slots' scatter)."""
    dev = px_s.device
    d = torch.zeros(n_b, dtype=torch.int64, device=dev)
    d.index_add_(0, run_pos, run_delta)
    src = torch.arange(n_b, dtype=torch.int64, device=dev) + torch.cumsum(
        d, dim=0)
    return px_s[src], expand_cube_at(in_s, scales, src)


def window_union_member(mz_q: np.ndarray, flat_bounds: np.ndarray) -> np.ndarray:
    """Boolean mask: which quantized m/z values fall inside ANY window of
    the union (the reference's searchsorted hot loop only emits hits
    [U, formula_imager_segm]; this is the dataset-side equivalent —
    peaks outside every window of a SEARCH can never contribute and are
    dropped from the device arrays up front)."""
    if flat_bounds.size == 0:
        return np.zeros(mz_q.shape, dtype=bool)
    return (np.searchsorted(flat_bounds, mz_q, side="right") % 2) == 1


def restrict_flat_to_windows(
    mz_s: np.ndarray,    # (S, N) int32 per-shard sorted, MZ_PAD_Q padding
    px_s: np.ndarray,    # (S, N) int32
    in_s: np.ndarray,    # (S, N) f32
    lo_q: np.ndarray,    # window lo bounds (any shape; empty lo==hi dropped)
    hi_q: np.ndarray,
    overflow_row: int,
    pad_to_multiple: int = 1024,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Keep only peaks inside the union of the windows; re-pad each shard
    row to the new common length.  Returns (mz, px, ints, max_kept).

    Exact: dropped peaks match no window, so every image bit is unchanged;
    padding rows (MZ_PAD_Q sentinel) sit outside every real window and drop
    with the rest.  Table padding rows quantize to the empty window (0, 0),
    which merged_window_bounds already drops — callers pass raw bounds."""
    flat = merged_window_bounds(lo_q, hi_q)
    keeps = [window_union_member(mz_s[s], flat) for s in range(mz_s.shape[0])]
    n_eff = max((int(k.sum()) for k in keeps), default=1)
    n_pad = -(-max(n_eff, 1) // pad_to_multiple) * pad_to_multiple
    s_count = mz_s.shape[0]
    mz_k = np.full((s_count, n_pad), MZ_PAD_Q, dtype=np.int32)
    px_k = np.full((s_count, n_pad), overflow_row, dtype=np.int32)
    in_k = np.zeros((s_count, n_pad), dtype=np.float32)
    for s, k in enumerate(keeps):
        c = int(k.sum())
        mz_k[s, :c] = mz_s[s][k]
        px_k[s, :c] = px_s[s][k]
        in_k[s, :c] = in_s[s][k]
    return mz_k, px_k, in_k, n_eff


def ion_window_chunks(
    r_lo: np.ndarray, r_hi: np.ndarray, b: int, k: int,
    ions_per_chunk: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, np.ndarray]:
    """ION-MAJOR chunk plan: (starts (C,), r_lo_loc (C, Wc), r_hi_loc
    (C, Wc), inv_ions (b,), gc_width, order (b,)).

    Whole IONS are sorted (by their first real window's lo rank;
    all-empty padding ions last) and chunked, all K windows of an ion
    staying adjacent — so the banded matmul emits image rows already
    ION-MAJOR: the (b, k, P) block needs NO (W, P) gather (a full-block
    permutation in device memory), only the final (b, 4) METRIC rows are
    un-permuted by ``inv_ions``.  Callers permute the per-ion side inputs
    (theor_ints, n_valid) by ``order`` to match.  Exact: each window
    still sums exactly its own bins (integer grid, any order/grouping).

    Requires ``ions_per_chunk`` to divide ``b`` (static batches are
    powers of two; callers clamp).  gc_width is on the {1, 1.5} x pow-2
    ladder of ``gc_ladder``."""
    r_lo2 = np.asarray(r_lo).reshape(b, k)
    r_hi2 = np.asarray(r_hi).reshape(b, k)
    empty = r_lo2 >= r_hi2
    all_empty = empty.all(axis=1)
    first_real = np.argmax(~empty, axis=1)
    first_lo = np.where(all_empty, 0, r_lo2[np.arange(b), first_real])
    order = np.lexsort((first_lo, all_empty.astype(np.int8)))
    ipc = ions_per_chunk
    c = b // ipc
    wc = ipc * k
    r_lo_s = r_lo2[order].reshape(c, wc)
    r_hi_s = r_hi2[order].reshape(c, wc)
    real_s = ~empty[order].reshape(c, wc)
    # chunk offset: min lo rank over the chunk's REAL windows (an all-
    # padding chunk keeps 0); empty windows' local ranks may go negative,
    # which the membership test already treats as empty
    big = np.int64(1) << 40
    lo_real = np.where(real_s, r_lo_s, big)
    starts = np.where(real_s.any(axis=1), lo_real.min(axis=1), 0).astype(
        np.int32)
    r_lo_loc = (r_lo_s - starts[:, None]).astype(np.int32)
    r_hi_loc = (r_hi_s - starts[:, None]).astype(np.int32)
    span = int(np.where(real_s, r_hi_loc, 0).max()) if b else 1
    gc_width = gc_ladder(max(span, wc, 2))
    inv_ions = np.empty(b, dtype=np.int32)
    inv_ions[order] = np.arange(b, dtype=np.int32)
    return (starts, r_lo_loc, r_hi_loc, inv_ions, gc_width,
            order.astype(np.int32))


def flat_histogram(
    pixel_sorted: torch.Tensor,  # (N,) int64, overflow slots -> a pad row
    int_sorted: torch.Tensor,    # (N,) f32 integer grid, 0 at padding
    pos: torch.Tensor,           # (G,) int64 host-computed bound ranks
    *,
    gc_width: int,
    n_pixels: int,
) -> torch.Tensor:
    """The bins-major ``(cols, W)`` f32 histogram scratch of one batch,
    ``cols = max(G + 1, gc_width + 2)``: row g holds, per pixel, the
    intensities of the peaks whose bin (the count of bounds <= their m/z) is
    g.  Column ``n_pixels`` is the overflow column of the padding slots; the
    width W is ``n_pixels + 1`` rounded up to a multiple of 4 (zero columns
    past the overflow), so every row starts 16-byte aligned for the fused
    kernel's vector loads."""
    dev = int_sorted.device
    n = pixel_sorted.shape[0]
    g = pos.shape[0]
    delta = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    delta.index_add_(0, pos, torch.ones_like(pos))
    bins = torch.cumsum(delta[:-1], dim=0)
    cols = max(g + 1, gc_width + 2)
    width = -(-(n_pixels + 1) // 4) * 4
    wh = torch.zeros((cols, width), dtype=torch.float32, device=dev)
    wh.index_put_((bins, pixel_sorted), int_sorted, accumulate=True)
    return wh


def banded_images(
    whp: torch.Tensor,           # (cols, P) f32 histogram rows, pixels unit-strided
    starts,                      # (C,) chunk grid offsets (host ints)
    r_lo_loc: torch.Tensor,      # (C, Wc) int32 local lo ranks
    r_hi_loc: torch.Tensor,      # (C, Wc) int32 local hi ranks
    *,
    gc_width: int,
) -> torch.Tensor:
    """(C*Wc, P) f32 images in plan order.  Each chunk slices its
    ``gc_width + 2`` rows of the scratch (the start clamped so the slice
    stays inside, the local ranks shifted by the same amount) and runs one
    membership matmul.  Out-of-band bins have zero membership in the dense
    form, so the banded result is bit-identical to it."""
    dev = whp.device
    cols, n_pixels = whp.shape
    gg = torch.arange(gc_width + 2, dtype=torch.int32, device=dev)[:, None]
    n_chunks, wc = r_lo_loc.shape
    imgs = torch.empty((n_chunks * wc, n_pixels), dtype=torch.float32,
                       device=dev)
    for c, start in enumerate(np.asarray(starts).tolist()):
        start_eff = min(start, cols - (gc_width + 2))
        shift = start - start_eff
        band = whp[start_eff:start_eff + gc_width + 2]
        d = ((gg > (r_lo_loc[c] + shift)[None, :])
             & (gg <= (r_hi_loc[c] + shift)[None, :])).to(torch.float32)
        torch.matmul(d.T, band, out=imgs[c * wc:(c + 1) * wc])
    return imgs


def extract_images_flat_banded(
    pixel_sorted: torch.Tensor,  # (N,) int64, overflow slots -> a pad row
    int_sorted: torch.Tensor,    # (N,) f32 integer grid, 0 at padding
    pos: torch.Tensor,           # (G,) int64 host-computed bound ranks
    starts,                      # (C,) chunk grid offsets (host ints)
    r_lo_loc: torch.Tensor,      # (C, Wc) int32 local lo ranks
    r_hi_loc: torch.Tensor,      # (C, Wc) int32 local hi ranks
    inv: torch.Tensor | None,    # (W,) sorted-row -> input-order map
    *,
    gc_width: int,
    n_pixels: int,
) -> torch.Tensor:
    """(C*Wc, n_pixels) f32 images (input order when ``inv`` is given): the
    histogram built once at full width, then the banded membership matmul
    of every chunk."""
    wh = flat_histogram(pixel_sorted, int_sorted, pos, gc_width=gc_width,
                        n_pixels=n_pixels)
    imgs = banded_images(wh[:, :n_pixels], starts, r_lo_loc, r_hi_loc,
                         gc_width=gc_width)
    if inv is None:
        return imgs
    return imgs[inv]


# -- m/z-chunked cube path ----------------------------------------------------
#
# A whole-slide image (1024x1024 pixels and more) makes the flat path's
# (2BK+1, P+1) histogram scratch too large for any batch size.  With
# ``ParallelConfig.mz_chunk`` set, the dense (pixels x peaks) cube is resident
# instead, windows are sorted by m/z and cut into chunks, and each chunk's
# LOCAL bound-grid slice bounds the scratch at (P, gc_width+2).  The global
# searchsorted happens once per batch (local bins are global bins minus the
# chunk's grid offset); only the scatter-add repeats per chunk.  Images are
# bit-identical to the unchunked path: hit sets are exact integer-grid
# matches and sums are exact integers in any grouping.


def prepare_cube_arrays(
    ds: SpectralDataset,
    ppm: float | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: (mz_q_cube int32 (P, L), int_cube float32 (P, L)).

    m/z rows are quantized (padding saturates to the MZ_PAD_Q sentinel, above
    every real window bound, so padded peaks land past every rank).  With
    ``ppm`` given, intensities come from the shared integer grid
    (ds.intensity_quantization): every per-(pixel, window) sum stays below
    2**24, so scatter-add and matmul accumulation are exact in f32 in any
    order."""
    ints_q = None if ppm is None else ds.intensity_quantization(ppm)[0]
    mz_cube, int_cube = ds.padded_cube(ints_q)
    return quantize_mz(mz_cube), int_cube


def window_chunks(
    r_lo: np.ndarray, r_hi: np.ndarray, mz_chunk: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Host-side window-major chunk plan: (starts (C,), r_lo_loc (C, Wc),
    r_hi_loc (C, Wc), inv (W,), gc_width).

    Windows are ordered by lo rank and cut every ``mz_chunk`` windows; a
    chunk's grid offset is its first window's lo rank; ``gc_width`` (the max
    local rank span on the ``gc_ladder``) sizes the scratch.  Empty windows
    (batch padding, or windows collapsed by quantization) sort last: a
    partially padded batch would otherwise put rank-0 empties and high-rank
    real windows into one chunk whose span is the whole grid.  Their local
    ranks go negative in a straddling chunk, which the membership test
    treats as empty.  ``inv`` maps sorted rows back to input order."""
    w = int(r_lo.size)
    wc = max(1, int(mz_chunk))
    c = max(1, -(-w // wc))
    order = np.lexsort((r_lo, (r_lo == r_hi).astype(np.int8)))
    pad = c * wc - w
    r_lo_s = np.concatenate([r_lo[order], np.zeros(pad, r_lo.dtype)]).reshape(c, wc)
    r_hi_s = np.concatenate([r_hi[order], np.zeros(pad, r_hi.dtype)]).reshape(c, wc)
    starts = r_lo_s[:, 0].astype(np.int32)
    # padded tail windows: snap to the chunk offset -> empty local window
    if pad:
        r_lo_s[-1, wc - pad:] = starts[-1]
        r_hi_s[-1, wc - pad:] = starts[-1]
    r_lo_loc = (r_lo_s - starts[:, None]).astype(np.int32)
    r_hi_loc = (r_hi_s - starts[:, None]).astype(np.int32)
    gc_width = gc_ladder(max(int(r_hi_loc.max()) if w else 1, wc, 2))
    inv = np.empty(w, dtype=np.int32)
    inv[order] = np.arange(w, dtype=np.int32)
    return starts, r_lo_loc, r_hi_loc, inv, gc_width


def extract_images_mz_chunked(
    mz_q_cube: torch.Tensor,   # (P, L) int32, MZ_PAD_Q padding
    int_cube: torch.Tensor,    # (P, L) f32 integer grid, 0 at padding
    grid: torch.Tensor,        # (G,) int32 sorted window bounds (all chunks)
    starts,                    # (C,) grid offset per chunk (host ints)
    r_lo_loc: torch.Tensor,    # (C, Wc) int32 local lo ranks
    r_hi_loc: torch.Tensor,    # (C, Wc) int32 local hi ranks
    inv: torch.Tensor,         # (W,) int64 sorted-row -> input-order map
    *,
    gc_width: int,
) -> torch.Tensor:
    """(W, P) f32 ion-window images, the scratch bounded at (P, gc_width+2).

    Out-of-chunk peaks clip to bins 0 and gc_width+1, which no window of the
    chunk covers (local interiors are (rlo, rhi] with rlo >= 0 and
    rhi <= gc_width)."""
    dev = int_cube.device
    p = mz_q_cube.shape[0]
    width = gc_width + 2
    bins_g = torch.searchsorted(grid, mz_q_cube, right=True)   # once
    rows = torch.arange(p, dtype=torch.int64, device=dev)[:, None] * width
    vals = int_cube.reshape(-1)
    gg = torch.arange(width, dtype=torch.int32, device=dev)[:, None]
    n_chunks, wc = r_lo_loc.shape
    imgs = torch.empty((n_chunks * wc, p), dtype=torch.float32, device=dev)
    for c, start in enumerate(np.asarray(starts).tolist()):
        lin = (bins_g - start).clamp_(0, gc_width + 1).add_(rows)
        wh = torch.zeros(p * width, dtype=torch.float32, device=dev)
        wh.index_add_(0, lin.view(-1), vals)
        del lin
        d = ((gg > r_lo_loc[c][None, :])
             & (gg <= r_hi_loc[c][None, :])).to(torch.float32)
        torch.matmul(d.T, wh.view(p, width).T,
                     out=imgs[c * wc:(c + 1) * wc])
        del wh
    return imgs[inv]


# -- roofline cost model ------------------------------------------------------

def fused_score_cost_model(
    n_pixels: int,
    resident_peaks: int,
    n_ions: int,
    max_peaks: int,
    formula_batch: int,
    nlevels: int = 30,
    ordered: bool = True,
    fused: bool = False,
    cube_dtype: str = "f32",
) -> dict:
    """Minimum-work estimate of one full scoring rep (all ions once), the
    roofline's work model (``drivers/roofline_probe.py``,
    ``drivers/bench.py``).  A copy of the JAX package's
    ``ops/imager_jax.py::fused_score_cost_model``, equal to it on every
    input; pure Python.

    - histogram scatter: every scored peak slot is one intensity read, one
      index read and one f32 read-modify-write on the scratch (~12 B).
      Ordered streams scatter each resident peak about once in all (the
      band variant's per-batch bands); unordered streams re-touch the
      residents per batch.
    - scratch zero-init: one (P+1) x max(G+1, gc+2) f32 block per batch.
    - membership matmul: wh (P, G+1) @ D (G+1, B) per batch at f32.  The
      chunk plan's banded matmuls (:func:`banded_images`) do 2·BK·(gc+2)·P
      flops a batch instead: fewer than this term at large batches, more
      at small ones, so this floor does not bound the port's work; the
      port's roofline divides by :func:`banded_score_cost_model`.
    - image block: (n_ions, K, P) f32 written by extraction, then read by
      the moments pass (1x) and the chaos sweeps (~2 passes).

    Returns byte and flop totals; the larger of bytes over a bandwidth peak
    and flops over a matmul peak is the roofline floor.  It prices no
    padding, no host work and no launch gaps.

    ``fused=True`` prices the fused window-moments kernel
    (``ops/score.py``): the (B, K, P) image block never round-trips device
    memory; the kernel reads the histogram band twice (moments, then the
    centred epilogue) and writes the moment partials and the (B, P)
    principal images the chaos kernel reads.  ``cube_dtype`` prices the
    resident intensity read of the scatter at the compact width (bf16 2 B,
    int8 1 B a peak).
    """
    n_batches = max(1, -(-n_ions // formula_batch))
    g = 2 * formula_batch * max_peaks
    scratch_cols = max(g + 1, 4098)
    scatter_slots = (resident_peaks if ordered
                     else resident_peaks * n_batches)
    int_bytes = {"f32": 4, "bf16": 2, "int8": 1}[cube_dtype]
    # per slot: intensity read + index read + f32 scratch read-modify-write
    scatter_bytes = (int_bytes + 8) * scatter_slots
    init_bytes = 4 * n_batches * (n_pixels + 1) * scratch_cols
    if fused:
        band_read_bytes = 2 * 4 * n_batches * (g + 1) * n_pixels
        image_bytes = 4 * n_ions * n_pixels          # principal write only
        metric_read_bytes = 2 * image_bytes          # chaos ~2 passes
        # the membership dot runs in both kernel passes; the centred
        # epilogue's dots add 2*2 flops per (ion, peak, pixel) cell
        matmul_flops = (2 * 2.0 * n_batches * n_pixels * (g + 1)
                        * formula_batch
                        + 4.0 * n_ions * max_peaks * n_pixels)
        total_bytes = (scatter_bytes + init_bytes + band_read_bytes
                       + image_bytes + metric_read_bytes)
        return dict(
            n_batches=n_batches,
            scatter_slots=int(scatter_slots),
            scatter_bytes=int(scatter_bytes),
            scratch_init_bytes=int(init_bytes),
            band_read_bytes=int(band_read_bytes),
            image_bytes=int(image_bytes),
            metric_read_bytes=int(metric_read_bytes),
            total_bytes=int(total_bytes),
            matmul_flops=float(matmul_flops),
        )
    image_bytes = 4 * n_ions * max_peaks * n_pixels
    metric_read_bytes = 3 * image_bytes    # moments 1x + chaos ~2 passes
    matmul_flops = 2.0 * n_batches * n_pixels * (g + 1) * formula_batch
    total_bytes = scatter_bytes + init_bytes + image_bytes + metric_read_bytes
    return dict(
        n_batches=n_batches,
        scatter_slots=int(scatter_slots),
        scatter_bytes=int(scatter_bytes),
        scratch_init_bytes=int(init_bytes),
        image_bytes=int(image_bytes),
        metric_read_bytes=int(metric_read_bytes),
        total_bytes=int(total_bytes),
        matmul_flops=float(matmul_flops),
    )


def banded_score_cost_model(
    n_pixels: int,
    resident_peaks: int,
    n_ions: int,
    max_peaks: int,
    formula_batch: int,
    bands: list[tuple[int, int, int]],
    nlevels: int = 30,
    ordered: bool = True,
    fused: bool = False,
    cube_dtype: str = "f32",
) -> dict:
    """The port's minimum work of one full scoring rep, the floor its
    roofline shares divide by: :func:`fused_score_cost_model`'s terms, with
    the two the port's extraction does not share priced from what its
    launches do.  ``bands`` holds one ``(windows, gc_width, grid_bins)``
    a batch of the rep (``TorchBackend.band_shapes``):

    - membership matmul: the chunk plan's banded matmuls
      (:func:`banded_images`), 2·W·(gc+2)·P flops a batch for its W
      planned windows at band width gc, instead of the dense
      2·P·(G+1)·B.  The fused kernel runs the banded dot in both its
      passes, plus the centred epilogue's 4 flops a (ion, peak, pixel)
      cell, as the dense model prices it;
    - scratch zero-init: one max(G+1, gc+2) x W_px f32 block a batch, W_px
      = P+1 rounded up to a multiple of 4 (:func:`flat_histogram`),
      instead of (P+1) x max(G+1, 4098).

    The keys are :func:`fused_score_cost_model`'s; ``n_batches`` is
    ``len(bands)``."""
    model = fused_score_cost_model(
        n_pixels, resident_peaks, n_ions, max_peaks, formula_batch,
        nlevels=nlevels, ordered=ordered, fused=fused, cube_dtype=cube_dtype)
    width = -(-(n_pixels + 1) // 4) * 4
    init_bytes = sum(4 * max(g + 1, gc + 2) * width for _w, gc, g in bands)
    banded = sum(2.0 * w * (gc + 2) * n_pixels for w, gc, _g in bands)
    flops = (2 * banded + 4.0 * n_ions * max_peaks * n_pixels if fused
             else banded)
    model["total_bytes"] += int(init_bytes) - model["scratch_init_bytes"]
    model.update(n_batches=len(bands), scratch_init_bytes=int(init_bytes),
                 matmul_flops=float(flops))
    return model
