"""Mesh-sharded scoring: one formula batch over a ("pixels", "formulas") mesh.

Port of ``sm_distributed_tpu/parallel/sharded.py`` (``ShardedJaxBackend``,
``make_jax_backend``).  The JAX package runs one ``shard_map``-ed program
per batch over its mesh; here each process's controller (the search's
thread) drives its own cells (s, f) of a ``parallel/mesh.Mesh`` of torch
devices (every cell in one process; in a mesh spanning processes, the
cells on this process's chips, ``Mesh.local``) in three stages:

1. **extraction**: cell (s, f) histograms pixel shard s's resident peaks
   (the contiguous image rows ``[s * p_loc, (s + 1) * p_loc)``, m/z
   sorted) under formula shard f's windows and runs the banded membership
   matmuls (``ops/imager.extract_images_flat_banded``), giving the
   ``(B_loc, K, p_loc)`` image block of formula shard f's ``B_loc`` ions on
   its pixels.  The extraction takes the plain, band or compact variant of
   the single-device path (``models/msm_torch.py``), one variant for the
   whole mesh (``_variant_for``), each cell with its own exact band or
   kept peaks;
2. **the shuffle** (the JAX package's ``all_to_all`` along the pixel
   axis): device (j, f) receives sub-batch j of every pixel shard's block
   and concatenates them along the pixel axis, ending with all pixels of
   ``B_loc / n_pix`` ions.  A part whose two cells are in one process is a
   ``Tensor.to(device)`` copy (device to device between cards); the parts
   that cross processes go through one ``all_to_all_single`` a batch over
   a packed buffer, whose split sizes both sides derive from the plan and
   the metric grid (``parallel/distributed.py`` picks NCCL or gloo);
3. **metrics**: ``ops/metrics.batch_metrics`` on that ``(B_loc / n_pix, K,
   P)`` block: the masked moments kernel and the packed chaos kernel on
   the card, launched under their tensor's device
   (``kernels/_build.on_tensor_device``).  Then **the gather** (the JAX
   package's ``all_gather``): the ``(B_loc / n_pix, 4)`` metric rows of
   every cell reach every process (one ``all_gather`` a batch in a mesh
   spanning processes) and, in pixel-shard order, reassemble formula
   shard f's rows.

Every process of a mesh spanning processes computes the whole host plan
(it is deterministic, so all pick one variant and one band width), holds
the resident rows of the pixel shards it has a cell in, and issues its
collectives in one fixed order derived from the mesh and the plan, never
from which cell finished first; every process ends with the same metric
bits and the same ion images.  A process of the pod that fails alone
leaves the others waiting in a collective until the group's timeout
(``distributed.INIT_TIMEOUT_S``), where they fail too.

Image values are exact integers on the shared intensity grid, so every ion's
full image is bit-identical to the single-device path's and its metrics are
computed by the same code on the same bits: sharded scoring is BIT-EQUAL to
``TorchBackend``'s at any mesh shape, as the JAX package's contract says.
Images are extracted in the ion-major chunk plan's order (the
single-device path's); the plan is formula shard f's and shared by every
pixel shard, so the shuffle hands each device the same ions from every
shard, and only the gathered metric rows are un-permuted.

As in the JAX package the mesh step does not take the fused kernel (the
correlation moments need the post-shuffle global-pixel mean), refuses
``parallel.mz_chunk``, keeps bf16 resident intensities (expanded to f32 by
each cell) and scores an int8 cube as f32, with a warning (per-tile scales
do not align with shard rows).  Unlike the JAX package nothing is padded to
a sticky capacity: eager torch needs no static shapes, so each cell's band
is a view of exactly its width and its compaction gathers exactly its kept
peaks (the JAX package's ``_grow_compact_capacity``, ``band_bucket`` and
the padding of ``_pack_runs`` / ``_pack_bands`` have no counterpart).  Each
batch records its bucket spec under the JAX package's keys
(``_sharded_spec``): the kernel primer (``service/primer.py``) reads its
lease shape (``devices``) and the kernels its variant launches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..analysis.numerics import numerics_surface
from ..io.dataset import SpectralDataset
from ..models.msm_torch import (
    COMPACT_NS_PER_SLOT,
    SCATTER_NS_PER_SLOT,
    TorchBackend,
    resolve_device,
)
from ..ops import buckets as shape_buckets
from ..ops.imager import (
    BAND_WINDOWS,
    batch_peak_band,
    batch_peak_runs,
    compact_peaks,
    extract_images_flat_banded,
    flat_bound_ranks,
    ion_window_chunks,
    ions_per_chunk_for,
    prepare_flat_sharded_arrays,
    restrict_flat_to_windows,
    window_rank_grid,
)
from ..ops.isocalc import IsotopePatternTable
from ..ops.metrics import batch_metrics
from ..ops.quantize import (
    compact_cube,
    cube_to_device,
    expand_cube_range,
    quantize_window,
)
from ..utils import tracing
from ..utils.config import DSConfig, SMConfig
from ..utils.logger import logger
from .mesh import FORMULAS_AXIS, PIXELS_AXIS, Mesh, make_mesh

# Numerics contracts (analysis/numerics.py), the JAX package's: the mesh
# step and the mesh program are bit-equal to the single-device backend.
# No padded= clause: the padded shard arrays are the backend's members,
# not the step's parameters.
NUMERICS = numerics_surface(__name__, {
    "ShardedTorchBackend._dispatch":
        "contract=bit_exact; test=tests/test_torch_parallel.py::"
        "test_sharded_matches_single_device",
    "ShardedTorchBackend.score_batches":
        "contract=bit_exact; test=tests/test_torch_parallel.py::"
        "test_sharded_window_restriction_bit_exact",
})

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class ShardPlan(NamedTuple):
    """Host plan of one batch on the mesh."""
    ints_p: np.ndarray       # (b, k) padded theoretical intensities
    nv_p: np.ndarray         # (b,) padded valid peak counts
    chunks: list             # [f] ion_window_chunks(...) of formula shard f
    pos: list                # [s][f] (G_loc,) bound ranks in pixel shard s
    runs: list | None        # [s][f] batch_peak_runs(...) unless "off"
    bands: list | None       # [s][f] batch_peak_band(...) unless "off"
    k: int                   # isotope peaks a row


class ShardedTorchBackend:
    """Multi-device scorer: the interface and results of
    ``models/msm_torch.TorchBackend``, the data sharded over the mesh."""

    name = "torch_cuda"

    def __init__(self, ds: SpectralDataset, ds_config: DSConfig,
                 sm_config: SMConfig, mesh: Mesh | None = None,
                 restrict_table: IsotopePatternTable | None = None):
        self.ds = ds
        self.ds_config = ds_config
        par = sm_config.parallel
        self.mesh = mesh if mesh is not None else make_mesh(
            par, device=sm_config.device)
        # the cells this process drives (every cell unless the mesh spans
        # processes), formula shard-major
        self._cells = self.mesh.local()
        if not self._cells:
            # smlint: host-sync-ok[a numpy grid of device names, for the error]
            raise ValueError(f"this process drives no cell of the mesh "
                             f"{self.mesh.devices.tolist()}")
        self.spans_processes = self.mesh.spans_processes()
        grid = self.mesh.devices
        for d in dict.fromkeys(grid[c] for c in self._cells):
            resolve_device(d)             # a card that exists; no TF32
        self._home = grid[self._cells[0]]
        n_pix = self.mesh.shape[PIXELS_AXIS]
        n_form = self.mesh.shape[FORMULAS_AXIS]
        self._n_pix, self._n_form = n_pix, n_form
        self._buckets = shape_buckets.buckets_enabled(par)
        # each formula shard's block splits evenly across the pixel shards
        # (the shuffle's ion sub-batches)
        self._batch_granule = n_form * n_pix
        self.batch = _round_up(shape_buckets.effective_batch(par),
                               self._batch_granule)
        img = ds_config.image_generation
        self.ppm = img.ppm
        self.nlevels = img.nlevels
        self.do_preprocessing = img.do_preprocessing
        self.q = img.q
        if par.mz_chunk:
            raise ValueError(
                "parallel.mz_chunk applies only to the single-device cube "
                "path; on a multi-device mesh, per-device memory is bounded "
                f"by sharding (pixels/{n_pix}) — unset mz_chunk, or "
                "reduce parallel.formula_batch / grow the pixels axis to "
                "shrink per-shard scratch")
        # the histogram scratch of one cell, as the JAX package guards it
        k_est = ds_config.isotope_generation.n_peaks
        b_loc = self.batch // n_form
        p_loc_est = -(-ds.n_pixels // n_pix)
        scratch = 4 * (p_loc_est + 1) * max(2 * b_loc * k_est + 1, 4098)
        if scratch > (8 << 30):
            raise ValueError(
                f"per-shard histogram scratch would be ~{scratch / 2**30:.0f}"
                f" GiB ({p_loc_est} pixels/shard x {b_loc} ions/formula-shard"
                f" x {k_est} peaks); reduce parallel.formula_batch, grow the"
                " pixels mesh axis, or add formula shards")
        if self._buckets:
            # whole lattice rows per shard, peak slots on the lattice; the
            # metric grid is the single-device path's row bucket, which the
            # shuffle's concatenation is cut to
            nrows_b = shape_buckets.row_bucket(ds.nrows)
            r_loc = shape_buckets.pow2ish(-(-nrows_b // n_pix), 1)
            mz_s, px_s, in_s, self._p_loc = prepare_flat_sharded_arrays(
                ds, self.ppm, n_pix, p_loc=r_loc * ds.ncols,
                slot_bucket=shape_buckets.peak_bucket)
            self._nrows_metric = nrows_b
        else:
            mz_s, px_s, in_s, self._p_loc = prepare_flat_sharded_arrays(
                ds, self.ppm, n_pix)
            self._nrows_metric = ds.nrows
        self._n_pix_metric = self._nrows_metric * ds.ncols
        # each pixel shard's columns inside the metric grid (0: past it)
        self._widths = [max(0, min(self._p_loc,
                                   self._n_pix_metric - s * self._p_loc))
                        for s in range(n_pix)]
        # the real pixel count for the masked moments; None off the lattice
        self._n_real = ds.n_pixels if self._buckets else None
        if restrict_table is not None:
            mz_s, px_s, in_s = self._restrict_shards(mz_s, px_s, in_s,
                                                     restrict_table)
        self.cube_dtype = par.cube_dtype
        if self.cube_dtype == "int8":
            logger.warning(
                "parallel.cube_dtype=int8 is single-device only (per-tile "
                "scales do not shard); mesh path keeps f32 residents")
            self.cube_dtype = "f32"
        self._compaction = par.peak_compaction
        self._band_mode = par.band_slice
        self.int_scale = ds.intensity_quantization(self.ppm)[1]
        self._mz_shards = mz_s            # host-side, for the bound ranks
        self.collective = "none"
        if self.spans_processes:
            self._pod_setup(ds)
        # pixel shard s's rows on each distinct device of this process's
        # cells of mesh row s: cells of one row on one device share them
        self._px: list[dict] = []
        self._in: list[dict] = []
        for s in range(n_pix):
            row_px, row_in = {}, {}
            row = dict.fromkeys(grid[c] for c in self._cells if c[0] == s)
            if row:
                codes, _scales = compact_cube(in_s[s], self.cube_dtype)
            for d in row:
                row_px[d] = torch.from_numpy(
                    px_s[s].astype(np.int64)).to(d)
                row_in[d] = cube_to_device(codes, d)
            self._px.append(row_px)
            self._in.append(row_in)
        logger.info(
            "torch_cuda sharded flat peaks resident: %s over mesh %s "
            "(pixels=%d, formulas=%d, p_loc=%d); cube_dtype=%s",
            px_s.shape, self.mesh.shape, n_pix, n_form, self._p_loc,
            self.cube_dtype)
        self._gc_width = 0                # sticky chunk band width
        # bytes this process sent and received across processes in its
        # last batch's shuffle
        self.cross_bytes = 0
        # batches this backend scored by each extraction variant
        self.variant_counts = dict.fromkeys(("plain", "band", "compact"), 0)
        # called with each stage's name as it is enqueued (chip_smoke.py
        # records CUDA events there); None in the program
        self.timer = None

    # ------------------------------------------------------------- set-up
    def _pod_setup(self, ds: SpectralDataset) -> None:
        """A mesh spanning processes: which process drives each cell, each
        process's cells, whether any shuffle part crosses processes, and
        the device transport.  The processes compare what their plans
        derive from (the cells' owners, the batch, the shard geometry) in
        one gloo gather, so a process that would issue other collectives
        raises here instead of deadlocking the group."""
        from . import distributed

        n_pix, n_form = self._n_pix, self._n_form
        size = distributed.world()[1]
        own = np.array([[self.mesh.owner(s, f) for f in range(n_form)]
                        for s in range(n_pix)])
        if set(own.flat) != set(range(size)):
            raise ValueError(
                f"a mesh spanning processes spans all {size} of them; this "
                f"one's cells are driven by processes {sorted(set(own.flat))}")
        self._owners = own
        self._cells_of = [[(s, f) for f in range(n_form)
                           for s in range(n_pix) if own[s, f] == q]
                          for q in range(size)]
        self._crosses = bool((own[:, None, :] != own[None, :, :]).any())
        self.collective = distributed.device_collective(self._home)
        mine = (own.tolist(), self.batch, self._p_loc, self._n_pix_metric,
                tuple(self._mz_shards.shape), int(ds.n_peaks))
        differ = [q for q, theirs in enumerate(
            distributed.all_gather_object(mine)) if theirs != mine]
        if differ:
            raise ValueError(
                f"processes {differ} plan another mesh or dataset than "
                f"process {distributed.world()[0]} ({mine})")
        logger.info("mesh %s spans %d processes (this one drives cells %s); "
                    "device collectives over %s", self.mesh.shape, size,
                    self._cells, self.collective)

    def shrink_batch(self, batch: int) -> None:
        """Cap the padding batch (shrink only), clamped to the mesh's batch
        granule (formula shards x pixel shards): below it, memory relief
        must come from the mesh geometry instead."""
        new = max(self._batch_granule,
                  _round_up(max(1, int(batch)), self._batch_granule))
        if new < self.batch:
            logger.warning("sharded torch_cuda backend: formula batch %d -> "
                           "%d (OOM backoff, granule %d)", self.batch, new,
                           self._batch_granule)
            self.batch = new

    def _restrict_shards(self, mz_s, px_s, in_s, table):
        """Drop peaks outside the union of ``table``'s windows from every
        pixel shard's row and re-pad rows to the new common length
        (exact)."""
        lo_q, hi_q = quantize_window(table.mzs, self.ppm)
        mz_k, px_k, in_k, n_eff = restrict_flat_to_windows(
            mz_s, px_s, in_s, lo_q, hi_q, overflow_row=self._p_loc)
        logger.info("window-union restriction: %d -> %d peaks/shard max",
                    mz_s.shape[1], n_eff)
        return mz_k, px_k, in_k

    # --------------------------------------------------------- host plans
    def _flat_plan(self, table: IsotopePatternTable) -> ShardPlan:
        """Host prep of one batch: per formula shard its windows' rank grid
        and ion-major chunk plan, and per (pixel shard, formula shard) cell
        the bound ranks and, unless their mode is "off", the compaction
        runs and the rank band among the shard's peaks."""
        n, b = table.n_ions, self.batch
        if n > b:
            raise ValueError(f"batch of {n} ions exceeds formula_batch={b}")
        k = table.max_peaks
        k_eff = max(1, k)
        lo_q, hi_q = quantize_window(table.mzs, self.ppm)
        lo_p = np.zeros((b, k), dtype=np.int32)
        hi_p = np.zeros((b, k), dtype=np.int32)
        ints_p = np.zeros((b, k), dtype=np.float32)
        nv_p = np.zeros(b, dtype=np.int32)
        lo_p[:n], hi_p[:n] = lo_q, hi_q
        ints_p[:n] = table.ints
        nv_p[:n] = table.n_valid
        b_loc = b // self._n_form
        ipc = ions_per_chunk_for(b_loc, k_eff, BAND_WINDOWS)
        shards = range(self._n_pix)
        chunks = []
        pos = [[] for _ in shards]
        runs = [[] for _ in shards] if self._compaction != "off" else None
        bands = [[] for _ in shards] if self._band_mode != "off" else None
        for fi in range(self._n_form):
            sl = slice(fi * b_loc, (fi + 1) * b_loc)
            grid, r_lo, r_hi = window_rank_grid(lo_p[sl], hi_p[sl])
            chunks.append(ion_window_chunks(r_lo, r_hi, b_loc, k_eff, ipc))
            for s in shards:
                mz = self._mz_shards[s]
                pos[s].append(flat_bound_ranks(mz, grid))
                if runs is not None:
                    runs[s].append(batch_peak_runs(mz, lo_p[sl], hi_p[sl],
                                                   pos[s][fi]))
                if bands is not None:
                    bands[s].append(batch_peak_band(mz, lo_p[sl],
                                                    hi_p[sl]))
        return ShardPlan(ints_p, nv_p, chunks, pos, runs, bands, k)

    def _variant_for(self, runs, bands) -> str:
        """The extraction variant of one batch, for the whole mesh: the
        single-device rule (``TorchBackend._variant_for``, the card's
        per-slot rates) on the busiest cell's work.  "on" forces a variant,
        band first; every variant gives the same bits."""
        if self._band_mode == "on" and bands is not None:
            return "band"
        if self._compaction == "on" and runs is not None:
            return "compact"
        n = int(self._mz_shards.shape[1])
        est = {"plain": SCATTER_NS_PER_SLOT * n}
        if runs is not None:
            est["compact"] = COMPACT_NS_PER_SLOT * max(
                r[2] for row in runs for r in row)
        if bands is not None:
            w = max(bd[1] for row in bands for bd in row)
            if w < n:
                est["band"] = SCATTER_NS_PER_SLOT * w
        return min(est, key=est.get)

    def _grow(self, plan: ShardPlan) -> None:
        self._gc_width = max([self._gc_width] + [c[4] for c in plan.chunks])

    def presize(self, tables) -> None:
        """Grow the sticky band width to cover ``tables`` without scoring,
        so every batch of a search runs at one shape."""
        for t in tables:
            self._grow(self._flat_plan(t))

    def warmup(self, tables) -> None:
        """Pre-size on ``tables`` and score one batch of each extraction
        variant they take, so every kernel is built and loaded on every
        device of the mesh before the first timed batch."""
        tables = list(tables)
        plans = [self._flat_plan(t) for t in tables]
        for plan in plans:
            self._grow(plan)
        seen: set = set()
        for t, plan in zip(tables, plans):
            variant = self._variant_for(plan.runs, plan.bands)
            if variant not in seen:
                seen.add(variant)
                # smlint: host-sync-ok[warm-up waits out each variant once]
                self._dispatch(t, plan).cpu()

    # ------------------------------------------------------------ scoring
    def _mark(self, stage: str) -> None:
        if self.timer is not None:
            self.timer(stage)

    def _cell_images(self, plan: ShardPlan, variant: str, s: int, fi: int,
                     dev) -> torch.Tensor:
        """Stage 1 in cell (s, fi): the (B_loc, K, p_loc) image block of
        formula shard fi's ions on pixel shard s, in the chunk plan's ion
        order."""
        starts, r_lo_loc, r_hi_loc, _inv, _gc, _order = plan.chunks[fi]
        px, codes = self._px[s][dev], self._in[s][dev]
        pos = _put(plan.pos[s][fi], dev, torch.int64)
        if variant == "band":
            b_lo, width = plan.bands[s][fi]
            px = px[b_lo:b_lo + width]
            ints = expand_cube_range(codes, None, b_lo, b_lo + width)
            pos = torch.clamp(pos - b_lo, 0, width)
        elif variant == "compact":
            run_pos, run_delta, n_b, pos_b = plan.runs[s][fi]
            px, ints = compact_peaks(px, codes, _put(run_pos, dev, torch.int64),
                                     _put(run_delta, dev, torch.int64), n_b)
            pos = _put(pos_b, dev, torch.int64)
        else:
            ints = expand_cube_range(codes, None)
        imgs = extract_images_flat_banded(
            px, ints, pos, starts, _put(r_lo_loc, dev), _put(r_hi_loc, dev),
            None, gc_width=self._gc_width, n_pixels=self._p_loc)
        return imgs.view(self.batch // self._n_form, plan.k, self._p_loc)

    def _shuffle(self, blocks: dict, bj: int, k: int) -> dict:
        """Stage 2: each of this process's cells (j, f) gets sub-batch j of
        every pixel shard's block of formula shard f, along the pixel axis,
        cut to the metric grid: a ``Tensor.to`` copy from a cell of this
        process, the rest out of :meth:`_exchange`."""
        grid = self.mesh.devices
        shards = [s for s, w in enumerate(self._widths) if w > 0]
        recv = (self._exchange(blocks, bj, k, shards)
                if self.spans_processes and self._crosses else {})
        mine = {}
        for j, f in self._cells:
            rows = slice(j * bj, (j + 1) * bj)
            parts = []
            for s in shards:
                blk = blocks.get((s, f))
                if blk is None:
                    part = recv[(s, j, f)]
                elif self._widths[s] == self._p_loc:
                    part = blk[rows]
                else:
                    part = blk[rows, :, :self._widths[s]]
                parts.append(part.to(grid[j, f]))
            mine[(j, f)] = (parts[0] if len(parts) == 1
                            and parts[0].is_contiguous()
                            else torch.cat(parts, dim=2))
        return mine

    def _exchange(self, blocks: dict, bj: int, k: int, shards) -> dict:
        """The shuffle's parts that cross processes, in one
        ``all_to_all_single``: this process packs its parts for process q in
        (f, j, s) order and unpacks what process q packed for it in the same
        order; both derive every part's size (``bj * k`` times the shard's
        width in the metric grid) from the plan.  Returns ``{(s, j, f):
        (bj, k, width)}`` on this process's first device."""
        from . import distributed

        rank, size = distributed.world()
        own = self._owners
        sends: list = [[] for _ in range(size)]
        send_n, recv_n = [0] * size, [0] * size
        recv_keys: list = [[] for _ in range(size)]
        for f in range(self._n_form):
            for j in range(self._n_pix):
                for s in shards:
                    src, dst = own[s, f], own[j, f]
                    n = bj * k * self._widths[s]
                    if src == dst:
                        continue
                    if src == rank:
                        part = blocks[(s, f)][j * bj:(j + 1) * bj, :,
                                              :self._widths[s]]
                        sends[dst].append(part.to(self._home).reshape(-1))
                        send_n[dst] += n
                    elif dst == rank:
                        recv_keys[src].append((s, j, f))
                        recv_n[src] += n
        parts = [p for q in sends for p in q]
        dtype = next(iter(blocks.values())).dtype
        send = (torch.cat(parts) if parts else
                torch.empty(0, dtype=dtype, device=self._home))
        del parts, sends
        got = distributed.all_to_all(send, send_n, recv_n)
        self.cross_bytes = (sum(send_n) + sum(recv_n)) * send.element_size()
        out, off = {}, 0
        for q in range(size):
            for s, j, f in recv_keys[q]:
                n = bj * k * self._widths[s]
                out[(s, j, f)] = got[off:off + n].view(bj, k, self._widths[s])
                off += n
        return out

    def _gather(self, parts: dict, home) -> dict:
        """Every cell's tensor of ``parts`` (this process's cells; one
        shape for all) on ``home``: in a mesh spanning processes by one
        ``all_gather`` of each process's cells in (f, s) order, padded to
        the most cells any process drives."""
        if not self.spans_processes:
            return {c: t.to(home) for c, t in parts.items()}
        from . import distributed

        mine = [parts[c].to(home) for c in self._cells]
        most = max(len(cells) for cells in self._cells_of)
        mine += [torch.zeros_like(mine[0])] * (most - len(mine))
        got = distributed.all_gather(torch.stack(mine))
        return {c: got[q][i] for q, cells in enumerate(self._cells_of)
                for i, c in enumerate(cells)}

    def _dispatch(self, table: IsotopePatternTable,
                  plan: ShardPlan | None = None) -> torch.Tensor:
        """Enqueue one padded batch on the mesh; returns its (b, 4)
        metrics in the table's ion order, on this process's first device
        (not synchronised)."""
        if plan is None:
            plan = self._flat_plan(table)
        self._grow(plan)
        variant = self._variant_for(plan.runs, plan.bands)
        grid = self.mesh.devices
        n_pix, n_form = self._n_pix, self._n_form
        b_loc = self.batch // n_form
        bj = b_loc // n_pix
        self._mark("start")
        blocks = {(s, fi): self._cell_images(plan, variant, s, fi,
                                             grid[s, fi])
                  for s, fi in self._cells}
        self._mark("extract")
        mine = self._shuffle(blocks, bj, plan.k)
        del blocks
        self._mark("shuffle")
        rows = {}
        for j, fi in self._cells:
            order = plan.chunks[fi][5]
            sl = slice(fi * b_loc, (fi + 1) * b_loc)
            sub = slice(j * bj, (j + 1) * bj)
            theor = plan.ints_p[sl][order][sub]
            n_valid = plan.nv_p[sl][order][sub]
            dev = grid[j, fi]
            rows[(j, fi)] = batch_metrics(
                mine.pop((j, fi)), _put(theor, dev), _put(n_valid, dev),
                self._nrows_metric, self.ds.ncols, self.nlevels,
                n_real=self._n_real,
                do_preprocessing=self.do_preprocessing, q=self.q)
        self._mark("metrics")
        home = self._home
        rows = self._gather(rows, home)
        outs = []
        for fi in range(n_form):
            f_rows = torch.cat([rows[(j, fi)] for j in range(n_pix)])
            outs.append(f_rows[_put(plan.chunks[fi][3], home, torch.int64)])
        out = torch.cat(outs)
        self._mark("gather")
        self.variant_counts[variant] += 1
        if self._buckets:
            shape_buckets.record_spec(self._sharded_spec(variant, plan))
        return out

    def _sharded_spec(self, variant: str, plan: ShardPlan) -> dict:
        """The batch's BucketSpec under the JAX package's keys: its lease
        topology (mesh axes, per-shard pixel capacity) and plan shapes,
        summed over the formula shards.  Nothing is padded to a
        compaction or band capacity here, so those stay 0.  ``devices``
        counts the mesh's distinct cards (the JAX package's mesh size: its
        meshes never repeat a device); a mesh spanning processes counts
        every cell, as the JAX package's pod mesh does."""
        chunks = plan.chunks
        spec = {
            "kind": "sharded", "variant": variant,
            "nrows": int(self._nrows_metric), "ncols": int(self.ds.ncols),
            "nlevels": int(self.nlevels),
            "do_preprocessing": bool(self.do_preprocessing),
            "q": float(self.q),
            # smlint: spec-key-ok[shard slots are peak_bucket-padded at set-up]
            "n_resident": int(self._mz_shards.shape[1]),
            "b": int(self.batch), "k": int(plan.k),
            "gc_width": int(self._gc_width),
            "n_keep": 0, "r_pad": 0, "w_cap": 0,
            # smlint: spec-key-ok[2bk bounds of a padded batch; b on a ladder]
            "g": int(sum(p.shape[0] for p in plan.pos[0])),
            # smlint: spec-key-ok[a padded batch's chunks: b and k bound them]
            "c": int(sum(c[1].shape[0] for c in chunks)),
            # smlint: spec-key-ok[a padded batch's chunks: b and k bound them]
            "wc": int(max(c[1].shape[1] for c in chunks)),
            # smlint: spec-key-ok[a padded batch's chunks: b and k bound them]
            "w": int(sum(c[3].shape[0] for c in chunks)),
            # smlint: spec-key-ok[a mesh's cards: at most those of the pod]
            "devices": (self.mesh.size if self.spans_processes
                        else len(self.mesh.distinct())),
            "mesh_pix": int(self._n_pix), "mesh_form": int(self._n_form),
            "p_loc": int(self._p_loc),
        }
        if self.cube_dtype != "f32":
            spec["cube_dtype"] = self.cube_dtype
        return spec

    def score_batch(self, table: IsotopePatternTable) -> np.ndarray:
        """(n_ions, 4) f64 metrics of one batch."""
        out = self._dispatch(table)
        # smlint: host-sync-ok[the batch's metric rows are its result]
        return out[:table.n_ions].cpu().numpy().astype(np.float64)

    def score_batches(self, tables, cancel=None) -> list[np.ndarray]:
        """Plan every batch first (pre-sizing the sticky band width),
        enqueue each, then copy the results to the host; a device error of
        any batch surfaces at the copy, inside the caller's fault handling.
        ``cancel`` is checked once before the group, at the checkpoint
        grain, as in the JAX package."""
        tables = list(tables)
        if cancel is not None:
            cancel.check("score_batches")
        plans = [self._flat_plan(t) for t in tables]
        for plan in plans:
            self._grow(plan)
        outs = []
        for t, plan in zip(tables, plans):
            with tracing.span("score_batch", backend="torch_cuda_sharded",
                              ions=int(t.n_ions), enqueue=True,
                              mesh=self.mesh.shape,
                              collective=self.collective):
                outs.append(self._dispatch(t, plan))
        devices = [str(d) for d in self.mesh.devices.flat]
        with tracing.span("device_sync", batches=len(outs), devices=devices):
            # smlint: host-sync-ok[rows fetched once, after every batch]
            res = [o[:t.n_ions].cpu().numpy().astype(np.float64)
                   for o, t in zip(outs, tables)]
        self._trace_mesh_memory()
        return res

    def _trace_mesh_memory(self) -> None:
        """Each of this process's cards' allocated bytes onto the ambient
        trace (nothing on the CPU)."""
        grid = self.mesh.devices
        per = {str(d): int(torch.cuda.memory_allocated(d))
               for d in dict.fromkeys(grid[c] for c in self._cells)
               if d.type == "cuda"}
        if per:
            tracing.event("mesh_hbm", devices=per)

    def extract_ion_images(self, table: IsotopePatternTable) -> np.ndarray:
        """(n_ions, K, n_pixels) f32 ion images of ``table``, in its ion
        order, off the device shards: each cell extracts its formula
        shard's windows on its pixel shard (the plain variant), every
        cell's block reaches every process (one ``all_gather`` on the host
        in a mesh spanning processes) and the blocks are assembled on the
        host, divided by the intensity grid's power-of-two scale (exact),
        the images of invalid isotope peaks zero.  Bit-equal to
        ``ops/imager_np`` in every process.  Tables longer than the batch
        are extracted batch by batch."""
        from ..models.msm_basic import _slice_table

        n, b = table.n_ions, self.batch
        if n > b:
            return np.concatenate([
                self.extract_ion_images(_slice_table(table, s, min(s + b, n)))
                for s in range(0, n, b)])
        plan = self._flat_plan(table)
        self._grow(plan)
        k, p_loc = plan.k, self._p_loc
        b_loc = b // self._n_form
        imgs = np.zeros((b, k, self._n_pix * p_loc), dtype=np.float32)
        blocks = {}
        for s, fi in self._cells:
            dev = self.mesh.devices[s, fi]
            blk = self._cell_images(plan, "plain", s, fi, dev)
            blocks[(s, fi)] = blk[_put(plan.chunks[fi][3], dev, torch.int64)]
        cpu = torch.device("cpu")
        for (s, fi), blk in self._gather(blocks, cpu).items():
            # smlint: host-sync-ok[the gather put the blocks on the host]
            imgs[fi * b_loc:(fi + 1) * b_loc, :,
                 s * p_loc:(s + 1) * p_loc] = blk.numpy()
        imgs = np.ascontiguousarray(imgs[:n, :, :self.ds.n_pixels])
        imgs /= np.float32(self.int_scale)
        valid = np.arange(k)[None, :] < table.n_valid[:, None]
        imgs[~valid] = 0.0
        return imgs


def _put(a: np.ndarray, dev, dtype: torch.dtype | None = None
         ) -> torch.Tensor:
    """A host array on ``dev``."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    # smlint: host-sync-ok[a batch's host plan goes up before its launches]
    return (t if dtype is None else t.to(dtype)).to(dev)


def make_torch_backend(ds: SpectralDataset, ds_config: DSConfig,
                       sm_config: SMConfig, restrict_table=None,
                       device_indices=None, devices=None):
    """The single-device backend or the mesh-sharded one.

    ``device_indices`` is a device-pool lease's chips: a 1-chip lease gets
    ``TorchBackend`` pinned to that chip, an N-chip lease
    ``ShardedTorchBackend`` over a mesh of those chips, shaped by
    ``parallel.pixels_axis`` / ``formulas_axis``.  ``devices`` (an explicit
    device list, which may repeat a device) takes the lease's place; in a
    multi-process runtime a list shorter than the axes ask is this
    process's part of a mesh spanning processes (one gloo gather learns
    the others' lengths).  With neither, the mesh spans the config's
    devices (``mesh.config_devices``); a mesh of one device gets
    ``TorchBackend``.  ``restrict_table`` (the search's full ion table)
    drops the dataset's peaks outside every window (exact)."""
    from .distributed import (
        all_gather_object,
        maybe_initialize_distributed,
        world,
    )
    from .mesh import axes_ask, host_topology, lease_devices, pod_devices

    par = sm_config.parallel
    maybe_initialize_distributed(par)          # no-op single-process
    hosts = 1
    if devices is not None and world()[1] > 1 and \
            axes_ask(par) > len(devices):
        devices = pod_devices(devices, all_gather_object(len(devices)))
    if devices is None:
        devices = lease_devices(device_indices, device=sm_config.device)
        pool_hosts = max(1, int(sm_config.service.device_pool_hosts))
        if devices is not None and pool_hosts > 1:
            from ..service.device_pool import resolve_pool_size
            from ..service.health import split_host_ranges

            # the host failure domains THIS lease spans (the pool hands
            # out chips host-major)
            size = resolve_pool_size(sm_config.service, sm_config.backend,
                                     sm_config.device)
            hosts = max(1, len(host_topology(
                device_indices, split_host_ranges(size, pool_hosts))))
    if devices is not None and len(devices) == 1:
        return TorchBackend(ds, ds_config, sm_config,
                            restrict_table=restrict_table, device=devices[0])
    mesh = make_mesh(par, devices=devices, hosts=hosts,
                     device=sm_config.device)
    if mesh.size == 1:
        return TorchBackend(ds, ds_config, sm_config,
                            restrict_table=restrict_table,
                            device=mesh.devices[0, 0])
    return ShardedTorchBackend(ds, ds_config, sm_config, mesh=mesh,
                               restrict_table=restrict_table)
