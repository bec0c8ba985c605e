"""Measure-of-chaos component counts.

Port of ``sm_distributed_tpu/ops/chaos_pallas.py``.  For each principal
image: the SUM over ``nlevels`` thresholds ``vmax * l / nlevels`` of the
number of 4-connected components of ``max(img, 0) > thr``, exact integers
bit-equal to ``scipy.ndimage.label``.

- :func:`chaos_count_sums` is the wrapper.  A CPU tensor goes to the plain
  version.  A CUDA tensor goes to a hand-written kernel chosen by the JAX
  package's routing rule :func:`chaos_route` and, within the "packed" route
  (images within the lean whole-image budget: 256x256, 512x512), by
  :func:`packed_variant`:
  - images of at most 65,536 pixels take ``csrc/chaos.cu``, one CTA an
    image with the whole union-find in shared memory (``"smem"``, counted in
    ``chaos_count_sums.launches``);
  - larger packed images (``"tiles"``, counted in
    ``chaos_count_sums.tiled_launches``) and the "strips" route (1024x1024
    whole-slide images, through :func:`chaos_count_sums_strips`, counted in
    ``chaos_count_sums_strips.launches``) take ``csrc/chaos_strips.cu``:
    row tiles of at most 65,536 pixels, each with its union-find in shared
    memory, then a seam merge per image, on the plan of :func:`tile_plan`.
    Launches whose seam merge keeps its union-find in a global plane (more
    seam nodes than shared memory holds, e.g. 2048x2048) are also counted
    in ``chaos_count_sums_strips.seam_plane_launches``.
  Shapes for which the JAX package has no Pallas route (``"scan"``: past
  the packed budget and wider than the strip kernel's 8192 columns) take
  the row-tile kernel too whenever :func:`tile_plan` fits one row in a tile
  (at most 65,536 pixels a row; counted in
  ``chaos_count_sums.tiled_launches``), else :func:`chaos_count_sums_scan`.
  The kernels keep a level count in one byte, so they take at most
  ``MAX_KERNEL_LEVELS`` thresholds a launch: more levels are launched over
  consecutive ranges of the thresholds (:func:`level_ranges`) and the
  per-range sums added, exactly (each is an integer).  Every counter counts
  kernel launches, one per range.  A kernel that fails to build or launch
  raises.
- :func:`chaos_count_sums_scan` is the port of the JAX package's
  associative-scan route (``ops/metrics_jax.py``, device code there, no
  Pallas kernel): segmented running minima along rows and columns to a
  fixpoint, level by level, in torch ops on the tensor's device.  It serves
  images whose rows are wider than a tile (counted in
  ``chaos_count_sums_scan.launches``).
- :func:`chaos_count_sums_torch` is the plain version every route is held
  to: iterated 4-neighbour min-label propagation with pointer jumping, run
  to its fixpoint, for any image size.  A CPU tensor takes it on every
  route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..analysis.numerics import numerics_surface
from ..analysis.surface import kernel_surface
from ..kernels import _build

# Numerics contracts (analysis/numerics.py), the JAX package's
# ``ops/chaos_pallas.py`` sites.  The CPU tests hold the plain twins; the
# kernels' proof is on the card (chip_smoke.py phases 4, 8 and 20: each
# kernel bit-equal to its plain version).
NUMERICS = numerics_surface(__name__, {
    "chaos_count_sums":
        "contract=bit_exact; test=tests/test_torch_chaos.py::"
        "test_plain_matches_scipy",
    "chaos_count_sums_strips":
        "contract=bit_exact; test=tests/test_torch_chaos.py::"
        "test_plain_matches_strip_kernel_interpret",
})

# The kernel build surface (analysis/surface.py): the libraries this module
# launches, and what bounds their launches' shapes.
KERNEL_SURFACE = kernel_surface(__name__, {
    "_launch_smem":
        "library=chaos; shapes=images of at most SMEM_MAX_PIXELS, at most "
        "MAX_KERNEL_LEVELS levels a launch (level ranges past it)",
    "_launch_tiles":
        "library=chaos_strips; shapes=row tiles of tile_plan(nrows, ncols, "
        "nlevels), at most MAX_KERNEL_LEVELS levels a launch",
})

# the JAX package's packed-kernel budgets (ops/chaos_pallas.py), in cells:
# the routing decision is kept identical so the two packages agree on which
# shapes each kernel serves
_MAX_CELLS_LEAN = 288 * 1024
_MAX_CELLS_STRIP = 192 * 1024
_HALO = 8

# the shared-memory kernel's labels are uint16: pixel indices 0..65535
SMEM_MAX_PIXELS = 65536
# the kernels' level counts are uint8: thresholds a launch (MAX_LEVELS of
# csrc/chaos_smem.cuh)
MAX_KERNEL_LEVELS = 255


def _pack_geometry(nrows: int, ncols: int, lane_width: int,
                   max_cells: int) -> tuple[int, int, int]:
    rp = -(-nrows // 8) * 8
    budget = max(128, (max_cells // rp) // 128 * 128)
    lane_width = min(lane_width, budget)
    if ncols <= lane_width:
        cp = ncols
        while lane_width % cp != 0:
            cp += 1
        ib = lane_width // cp
    else:
        cp = -(-ncols // 128) * 128
        ib = 1
    return rp, cp, ib


def chaos_route(nrows: int, ncols: int, lane_width: int = 512) -> str:
    """'packed', 'strips' or 'scan' — the JAX package's routing rule."""
    rp, cp, ib = _pack_geometry(nrows, ncols, lane_width, _MAX_CELLS_LEAN)
    if rp * cp * ib <= _MAX_CELLS_LEAN:
        return "packed"
    cp = -(-ncols // 128) * 128
    strip = (_MAX_CELLS_STRIP // cp - 2 * _HALO) // 8 * 8
    if strip >= 8 and (strip + 2 * _HALO) * cp <= _MAX_CELLS_STRIP:
        return "strips"
    return "scan"


def packed_variant(n_pixels: int) -> str:
    """The packed route's kernel for images of ``n_pixels``: ``"smem"`` (the
    whole image's union-find in shared memory) up to the uint16 label limit,
    else ``"tiles"`` (the row-tile kernel)."""
    return "smem" if n_pixels <= SMEM_MAX_PIXELS else "tiles"


def _round16(b: int) -> int:
    return -(-b // 16) * 16


def chaos_smem_bytes(nrows: int, ncols: int, nlevels: int) -> int:
    """Dynamic shared memory of one CTA counting an nrows x ncols block (a
    whole image or a row tile; the layout of ``csrc/chaos_smem.cuh``'s
    ``chaos_block_smem_bytes``, which the C entries check against the
    device's opt-in limit): 33 reduction ints, the thresholds, P uint16
    labels, each 16-byte aligned, then the level plane of ``nrows`` rows of
    ``round_up(ncols + 1, 4)`` bytes and one zero word."""
    return (_round16(4 * 33) + _round16(4 * nlevels)
            + _round16(2 * nrows * ncols) + nrows * ((ncols + 4) & ~3) + 4)


# the seam merge's shared memory before its node arrays: 32 int64 partial
# sums and the top level
_SEAM_HEAD_BYTES = _round16(8 * 32 + 4)


def seam_smem_bytes(nodes: int) -> int:
    """Dynamic shared memory of the seam merge's CTA with its union-find in
    shared memory (``csrc/chaos_strips.cu::seam_smem_bytes``): the partial
    sums, then per seam node a uint16 label and record partner and a uint8
    level count and record level, each array 16-byte aligned."""
    return _SEAM_HEAD_BYTES + 2 * _round16(2 * nodes) + 2 * _round16(nodes)


# shared memory an H100 block may use (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_BLOCK_BYTES = 232448


class TilePlan(NamedTuple):
    """How ``csrc/chaos_strips.cu`` cuts an image (:func:`tile_plan`)."""
    rows: int             # rows a tile (the last tile may have fewer)
    tiles: int            # tiles an image
    seam_slots: int       # seam nodes a tile: 2 * ncols, ncols for one row
    seam_nodes: int       # seam nodes an image: tiles * seam_slots
    tile_smem_bytes: int  # dynamic shared memory of the tile kernel's CTA
    tile_words: int       # lev words of a full tile (past 17,408, the
    #                       register slots of csrc/chaos_smem.cuh, the rest
    #                       are scanned at every level)
    seam_in_smem: bool    # the merge's union-find in shared memory
    merge_smem_bytes: int  # dynamic shared memory of the merge's CTA
    scratch_bytes: int    # an image's scratch: level count (1 B) and record
    #                       (4 B) a seam node, local sum (4 B) a tile
    plane_bytes: int      # a merge CTA's global seam plane (4 B a node), or 0


def tile_plan(nrows: int, ncols: int, nlevels: int) -> TilePlan:
    """The row-tile kernel's plan for nrows x ncols images: tiles of as many
    whole rows as keep a tile within the uint16 label limit (65,536 pixels)
    and its shared memory within an H100 block's; the seam merge's
    union-find in shared memory when its nodes fit uint16 labels and its
    bytes the block, else in a global int32 plane over the seam nodes."""
    if nrows <= 0 or ncols <= 0:
        raise ValueError(f"tile_plan: empty {nrows}x{ncols} image")
    rows = min(nrows, SMEM_MAX_PIXELS // ncols)
    while rows > 0 and \
            chaos_smem_bytes(rows, ncols, nlevels) > SMEM_BLOCK_BYTES:
        rows -= 1
    if rows == 0:
        raise ValueError(f"tile_plan: one row of {ncols} pixels does not "
                         "fit a row tile")
    tiles = -(-nrows // rows)
    slots = 2 * ncols if rows > 1 else ncols
    nodes = tiles * slots
    words = rows * (((ncols + 4) & ~3) // 4)
    in_smem = (nodes <= SMEM_MAX_PIXELS
               and seam_smem_bytes(nodes) <= SMEM_BLOCK_BYTES)
    return TilePlan(
        rows=rows, tiles=tiles, seam_slots=slots, seam_nodes=nodes,
        tile_smem_bytes=chaos_smem_bytes(rows, ncols, nlevels),
        tile_words=words,
        seam_in_smem=in_smem,
        merge_smem_bytes=seam_smem_bytes(nodes) if in_smem
        else _SEAM_HEAD_BYTES,
        scratch_bytes=5 * nodes + 4 * tiles,
        plane_bytes=0 if in_smem else 4 * nodes)


def scan_variant(nrows: int, ncols: int, nlevels: int) -> str:
    """The port's kernel for images on the JAX package's "scan" route:
    ``"tiles"`` (the row-tile kernel) when :func:`tile_plan` fits one row in
    a tile, else ``"scan"`` (:func:`chaos_count_sums_scan`)."""
    try:
        tile_plan(nrows, ncols, nlevels)
    except ValueError:
        return "scan"
    return "tiles"


def level_ranges(nlevels: int) -> list[tuple[int, int]]:
    """Consecutive ranges ``[a, b)`` of at most MAX_KERNEL_LEVELS thresholds
    that cover ``range(nlevels)``: one kernel launch each.  The count summed
    over levels is additive over disjoint level ranges, and each range's
    thresholds still rise, so a launch over ``thr[:, a:b]`` gives exactly
    that range's share."""
    if nlevels <= 0:
        raise ValueError(f"level_ranges: nlevels={nlevels}")
    return [(a, min(a + MAX_KERNEL_LEVELS, nlevels))
            for a in range(0, nlevels, MAX_KERNEL_LEVELS)]


def _over_level_ranges(launch, principal: torch.Tensor, thr: torch.Tensor,
                       nrows: int, ncols: int, nlevels: int) -> torch.Tensor:
    """``launch`` over each of :func:`level_ranges`, the shares added in f64
    and rounded once to f32, as the plain version rounds its int64 total.
    Each share is exact: the shared-memory kernel's f32 count stays below
    2**24 (at most 32,768 components a level of 65,536 pixels, 255 levels),
    and the row-tile kernel returns its count in f64."""
    total = None
    for a, b in level_ranges(nlevels):
        part = launch(principal, thr[:, a:b].contiguous(), nrows, ncols,
                      b - a).to(torch.float64)
        total = part if total is None else total + part
    return total.to(torch.float32)


def chaos_thresholds(vmax: torch.Tensor, nlevels: int) -> torch.Tensor:
    """(N, nlevels) f32 thresholds ``vmax * (l / nlevels)``.  The fractions
    are f32 divisions of f32 integers, as the JAX package computes them, and
    the product is one rounded f32 multiply."""
    fracs = np.arange(nlevels, dtype=np.float32) / np.float32(nlevels)
    # smlint: host-sync-ok[nlevels host fractions go up once a batch]
    return vmax[:, None] * torch.from_numpy(fracs).to(vmax.device)


def _component_counts(mask: torch.Tensor) -> torch.Tensor:
    """(N,) int64 4-connectivity component counts of an (N, R, C) mask.

    Labels start as pixel indices; each round takes the min over the
    4-neighbourhood and then jumps every label to its label's label.  Labels
    are always indices of pixels of the same component and never grow, so
    the loop reaches a fixpoint, where each component holds one label whose
    pixel points to itself."""
    n, r, c = mask.shape
    big = r * c
    idx = torch.arange(big, dtype=torch.int64,
                       device=mask.device).view(1, r, c)
    lab = torch.where(mask, idx, big)
    flat_pad = torch.full((n, 1), big, dtype=lab.dtype, device=mask.device)
    while True:
        nb = lab.clone()
        nb[:, :, :-1] = torch.minimum(nb[:, :, :-1], lab[:, :, 1:])
        nb[:, :, 1:] = torch.minimum(nb[:, :, 1:], lab[:, :, :-1])
        nb[:, :-1, :] = torch.minimum(nb[:, :-1, :], lab[:, 1:, :])
        nb[:, 1:, :] = torch.minimum(nb[:, 1:, :], lab[:, :-1, :])
        nb = torch.where(mask, nb, big)
        flat = torch.cat([nb.view(n, big), flat_pad], dim=1)
        jumped = torch.gather(flat, 1, nb.view(n, big)).view(n, r, c)
        new = torch.minimum(nb, jumped)
        if torch.equal(new, lab):
            break
        lab = new
    return ((lab == idx) & mask).sum(dim=(1, 2))


def _sum_over_levels(principal: torch.Tensor, nrows: int, ncols: int,
                     nlevels: int, counts) -> torch.Tensor:
    """(N,) f32 sums over levels of ``counts`` (an (N, R, C) mask -> (N,)
    int64 component counter) of each level's mask."""
    img = torch.clamp(principal, min=0.0)
    thr = chaos_thresholds(img.amax(dim=1), nlevels)
    n = img.shape[0]
    total = torch.zeros(n, dtype=torch.int64, device=img.device)
    img3 = img.reshape(n, nrows, ncols)
    for level in range(nlevels):
        total += counts(img3 > thr[:, level, None, None])
    return total.to(torch.float32)


def chaos_count_sums_torch(principal: torch.Tensor, nrows: int, ncols: int,
                           nlevels: int) -> torch.Tensor:
    """(N,) f32 per-image sums over levels of component counts, in plain
    torch ops, for any image size."""
    return _sum_over_levels(principal, nrows, ncols, nlevels,
                            _component_counts)


def _seg_min_scan(vals: torch.Tensor, resets: torch.Tensor, dim: int,
                  reverse: bool, span: int) -> torch.Tensor:
    """Segmented running minimum along ``dim``: the minimum restarts at every
    ``resets`` position (mask boundaries), so labels flood only within
    contiguous runs (``_seg_min_scan`` of ``ops/metrics_jax.py``).  A key
    of (segments left, value) makes a plain ``cummin`` segmented: a later
    segment's keys lie below every earlier one's (``span`` exceeds every
    value)."""
    if reverse:
        vals, resets = vals.flip(dim), resets.flip(dim)
    seg = torch.cumsum(resets.to(torch.int64), dim)
    base = (vals.shape[dim] + 1 - seg) * span
    out = torch.cummin(base + vals, dim).values - base
    return out.flip(dim) if reverse else out


def _scan_component_counts(mask: torch.Tensor) -> torch.Tensor:
    """(N,) int64 4-connectivity component counts of an (N, R, C) mask by
    the JAX package's scan route (``_cc_count``): labels start as pixel
    indices, sweeps of segmented running minima along rows and columns,
    both ways, run until nothing changes; a component keeps the smallest
    index of its pixels, whose label is its own."""
    n, r, c = mask.shape
    big = r * c
    iota = torch.arange(big, dtype=torch.int64,
                        device=mask.device).view(1, r, c)
    resets = ~mask

    def sweep(lab):
        lab = _seg_min_scan(lab, resets, 2, False, big + 1)
        lab = _seg_min_scan(lab, resets, 2, True, big + 1)
        lab = _seg_min_scan(lab, resets, 1, False, big + 1)
        lab = _seg_min_scan(lab, resets, 1, True, big + 1)
        return torch.where(mask, lab, big)

    lab = torch.where(mask, iota, big)
    while True:
        new = sweep(lab)
        if torch.equal(new, lab):
            break
        lab = new
    return ((lab == iota) & mask).sum(dim=(1, 2))


def chaos_count_sums_scan(principal: torch.Tensor, nrows: int, ncols: int,
                          nlevels: int) -> torch.Tensor:
    """(N,) f32 per-image sums over levels of component counts by the scan
    route, in torch ops on the tensor's device (counted in
    ``chaos_count_sums_scan.launches``): the route the JAX package takes,
    as device code, for images no Pallas kernel fits; the port's wrapper
    sends it images whose rows are wider than a row tile."""
    out = _sum_over_levels(principal, nrows, ncols, nlevels,
                           _scan_component_counts)
    chaos_count_sums_scan.launches += 1
    return out


def _kernel_thresholds(principal: torch.Tensor, nrows: int, ncols: int,
                       nlevels: int, what: str) -> torch.Tensor:
    """Check a CUDA input of a chaos kernel; return its (N, nlevels)
    thresholds."""
    if principal.dtype != torch.float32 or principal.dim() != 2 \
            or principal.shape[1] != nrows * ncols:
        raise ValueError(
            f"{what} takes an (N, {nrows * ncols}) float32 tensor, "
            f"got {tuple(principal.shape)} {principal.dtype}")
    if principal.shape[0] and (principal.stride(1) != 1
                               or principal.stride(0) < principal.shape[1]):
        raise ValueError(f"{what} needs contiguous pixels per image")
    # max(max(x), 0) == max(max(x, 0)): no clamped copy of the images
    vmax = torch.clamp(principal.amax(dim=1), min=0.0)
    return chaos_thresholds(vmax, nlevels).contiguous()


@_build.on_tensor_device
def _launch_smem(principal: torch.Tensor, thr: torch.Tensor, nrows: int,
                 ncols: int, nlevels: int) -> torch.Tensor:
    n = principal.shape[0]
    dev = principal.device
    lib = _build.ready("chaos", dev)
    fn = lib.sm_chaos_smem
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if nlevels > lib.sm_chaos_max_levels():
        raise _build.KernelError(f"chaos kernel takes at most "
                                 f"{lib.sm_chaos_max_levels()} levels a "
                                 f"launch, got {nlevels}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(principal.data_ptr(), principal.stride(0), thr.data_ptr(),
                    out.data_ptr(), n, nrows, ncols, nlevels, stream),
                 "shared-memory chaos kernel launch")
    chaos_count_sums.launches += 1
    return out


@_build.on_tensor_device
def _launch_tiles(principal: torch.Tensor, thr: torch.Tensor, nrows: int,
                  ncols: int, nlevels: int, strips: bool = False
                  ) -> torch.Tensor:
    """The row-tile kernel and the seam merge of ``csrc/chaos_strips.cu``
    on the plan of :func:`tile_plan`, counted in
    ``chaos_count_sums_strips.launches`` (``strips``, the strips route) or
    ``chaos_count_sums.tiled_launches``; the launches whose seam merge keeps
    its union-find in a global plane also in
    ``chaos_count_sums_strips.seam_plane_launches``.  (N,) f64 exact
    counts."""
    n = principal.shape[0]
    dev = principal.device
    plan = tile_plan(nrows, ncols, nlevels)
    lib = _build.ready("chaos_strips", dev)
    fn = lib.sm_chaos_tiles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if nlevels > lib.sm_chaos_tiles_max_levels():
        raise _build.KernelError(
            f"row-tile chaos kernel takes at most "
            f"{lib.sm_chaos_tiles_max_levels()} levels a launch, got "
            f"{nlevels}")
    if n * plan.tiles >= 2**31:
        raise ValueError(f"row-tile chaos kernel: {n} images of "
                         f"{plan.tiles} tiles past its grid limits")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(n, sms))
    nodes = plan.seam_nodes
    out = torch.empty(n, dtype=torch.float64, device=dev)
    seam_m = torch.empty(n * nodes, dtype=torch.uint8, device=dev)
    rec = torch.empty(n * nodes, dtype=torch.int32, device=dev)
    tile_sum = torch.empty(n * plan.tiles, dtype=torch.int32, device=dev)
    plane = (None if plan.seam_in_smem else
             torch.empty(grid * nodes, dtype=torch.int32, device=dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(principal.data_ptr(), principal.stride(0), thr.data_ptr(),
                    out.data_ptr(), seam_m.data_ptr(), rec.data_ptr(),
                    tile_sum.data_ptr(),
                    None if plane is None else plane.data_ptr(), n, nrows,
                    ncols, nlevels, plan.rows, int(plan.seam_in_smem), grid,
                    stream),
                 "row-tile chaos kernel launch")
    if strips:
        chaos_count_sums_strips.launches += 1
    else:
        chaos_count_sums.tiled_launches += 1
    if not plan.seam_in_smem:
        chaos_count_sums_strips.seam_plane_launches += 1
    return out


def chaos_count_sums(principal: torch.Tensor, nrows: int, ncols: int,
                     nlevels: int) -> torch.Tensor:
    """(N,) f32 per-image sums over levels of component counts for (N,
    nrows*ncols) principal images.  Rows may be strided (a ``[:, 0, :]``
    view of the image block), pixels must be contiguous.  CPU: the plain
    version.  CUDA: the kernel of the shape's route and
    :func:`packed_variant`: ``csrc/chaos.cu``'s shared-memory kernel
    (counted in ``chaos_count_sums.launches``) or the row-tile kernel
    (``chaos_count_sums.tiled_launches``), or
    :func:`chaos_count_sums_strips`; on the "scan" route the row-tile kernel
    when one row fits a tile, else :func:`chaos_count_sums_scan`; any other
    device raises."""
    route = chaos_route(nrows, ncols)
    if principal.device.type == "cpu":
        return chaos_count_sums_torch(principal, nrows, ncols, nlevels)
    if principal.device.type != "cuda":
        raise ValueError(
            f"chaos_count_sums: unsupported device {principal.device}")
    if route == "strips":
        return chaos_count_sums_strips(principal, nrows, ncols, nlevels)
    if route == "scan" and scan_variant(nrows, ncols, nlevels) == "scan":
        return chaos_count_sums_scan(principal, nrows, ncols, nlevels)
    thr = _kernel_thresholds(principal, nrows, ncols, nlevels,
                             "chaos_count_sums")
    launch = (_launch_smem if route == "packed"
              and packed_variant(nrows * ncols) == "smem" else _launch_tiles)
    return _over_level_ranges(launch, principal, thr, nrows, ncols, nlevels)


def chaos_count_sums_strips(principal: torch.Tensor, nrows: int, ncols: int,
                            nlevels: int) -> torch.Tensor:
    """The same counts through the row-tile kernel of
    ``csrc/chaos_strips.cu`` (counted in ``chaos_count_sums_strips.launches``),
    which takes images of more than 65,536 pixels;
    :func:`chaos_count_sums` sends it the shapes past the packed kernel's
    budget.  CPU: the plain version; anything else raises."""
    if principal.device.type == "cpu":
        return chaos_count_sums_torch(principal, nrows, ncols, nlevels)
    if principal.device.type != "cuda":
        raise ValueError(
            f"chaos_count_sums_strips: unsupported device {principal.device}")
    thr = _kernel_thresholds(principal, nrows, ncols, nlevels,
                             "chaos_count_sums_strips")
    return _over_level_ranges(functools.partial(_launch_tiles, strips=True),
                              principal, thr, nrows, ncols, nlevels)


chaos_count_sums.launches = 0
chaos_count_sums.tiled_launches = 0
chaos_count_sums_strips.launches = 0
chaos_count_sums_strips.seam_plane_launches = 0
chaos_count_sums_scan.launches = 0
