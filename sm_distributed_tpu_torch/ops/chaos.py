"""Measure-of-chaos component counts.

Port of ``sm_distributed_tpu/ops/chaos_pallas.py``.  For each principal
image: the SUM over ``nlevels`` thresholds ``vmax * l / nlevels`` of the
number of 4-connected components of ``max(img, 0) > thr``, exact integers
bit-equal to ``scipy.ndimage.label``.

- :func:`chaos_count_sums` is the wrapper.  A CPU tensor goes to the plain
  version; a CUDA tensor goes to the hand-written kernel ``csrc/chaos.cu``
  (kernel 3 of the port, the "packed" route), or the call raises.
- :func:`chaos_count_sums_torch` is the plain version: iterated 4-neighbour
  min-label propagation with pointer jumping, run to its fixpoint.

The JAX package routes images past its lean whole-image budget to the strip
kernel (``chaos_route(...) == "strips"``, e.g. 1024x1024); that kernel is not
ported yet, so those shapes raise ``NotImplementedError`` here on every
device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# the JAX package's packed-kernel budgets (ops/chaos_pallas.py), in cells:
# the routing decision is kept identical so the two packages agree on which
# shapes each kernel serves
_MAX_CELLS_LEAN = 288 * 1024
_MAX_CELLS_STRIP = 192 * 1024
_HALO = 8


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


def _check_route(nrows: int, ncols: int) -> None:
    route = chaos_route(nrows, ncols)
    if route != "packed":
        raise NotImplementedError(
            f"{nrows}x{ncols} images take the JAX package's {route!r} chaos "
            "route, which the port does not have yet (ROADMAP queue 2 item "
            "4, the strip chaos kernel)")


def chaos_thresholds(vmax: torch.Tensor, nlevels: int) -> torch.Tensor:
    """(N, nlevels) f32 thresholds ``vmax * (l / nlevels)``.  The fractions
    are f32 divisions of f32 integers, as the JAX package computes them, and
    the product is one rounded f32 multiply."""
    fracs = np.arange(nlevels, dtype=np.float32) / np.float32(nlevels)
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
    idx = torch.arange(big, device=mask.device).view(1, r, c)
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


def chaos_count_sums_torch(principal: torch.Tensor, nrows: int, ncols: int,
                           nlevels: int) -> torch.Tensor:
    """(N,) f32 per-image sums over levels of component counts, in plain
    torch ops."""
    _check_route(nrows, ncols)
    img = torch.clamp(principal, min=0.0)
    thr = chaos_thresholds(img.amax(dim=1), nlevels)
    n = img.shape[0]
    total = torch.zeros(n, dtype=torch.int64, device=img.device)
    img3 = img.reshape(n, nrows, ncols)
    for level in range(nlevels):
        total += _component_counts(img3 > thr[:, level, None, None])
    return total.to(torch.float32)


def _launch(principal: torch.Tensor, thr: torch.Tensor, nrows: int,
            ncols: int, nlevels: int) -> torch.Tensor:
    from ..kernels import _build

    n, p = principal.shape
    dev = principal.device
    lib = _build.load("chaos")
    fn = lib.sm_chaos
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if nlevels > lib.sm_chaos_max_levels():
        raise ValueError(f"chaos kernel takes at most "
                         f"{lib.sm_chaos_max_levels()} levels, got {nlevels}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(n, 2 * sms))
    lev_in_smem = p <= 160 * 1024
    out = torch.empty(n, dtype=torch.float32, device=dev)
    par = torch.empty(grid * p, dtype=torch.int32, device=dev)
    lev = torch.empty(0 if lev_in_smem else grid * p, dtype=torch.uint8,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(principal.data_ptr(), principal.stride(0),
                    thr.data_ptr(), out.data_ptr(), par.data_ptr(),
                    lev.data_ptr(), n, nrows, ncols, nlevels, grid,
                    int(lev_in_smem), p if lev_in_smem else 0, stream),
                 "chaos kernel launch")
    return out


def chaos_count_sums(principal: torch.Tensor, nrows: int, ncols: int,
                     nlevels: int) -> torch.Tensor:
    """(N,) f32 per-image sums over levels of component counts for (N,
    nrows*ncols) principal images.  Rows may be strided (a ``[:, 0, :]``
    view of the image block), pixels must be contiguous.  CPU: the plain
    version.  CUDA: the ``csrc/chaos.cu`` kernel (counted in
    ``chaos_count_sums.launches``); anything else raises."""
    if principal.device.type == "cpu":
        return chaos_count_sums_torch(principal, nrows, ncols, nlevels)
    if principal.device.type != "cuda":
        raise ValueError(
            f"chaos_count_sums: unsupported device {principal.device}")
    _check_route(nrows, ncols)
    if principal.dtype != torch.float32 or principal.dim() != 2 \
            or principal.shape[1] != nrows * ncols:
        raise ValueError(
            f"chaos_count_sums takes an (N, {nrows * ncols}) float32 tensor, "
            f"got {tuple(principal.shape)} {principal.dtype}")
    if principal.shape[0] and (principal.stride(1) != 1
                               or principal.stride(0) < principal.shape[1]):
        raise ValueError("chaos_count_sums needs contiguous pixels per image")
    # max(max(x), 0) == max(max(x, 0)): no clamped copy of the images
    vmax = torch.clamp(principal.amax(dim=1), min=0.0)
    thr = chaos_thresholds(vmax, nlevels).contiguous()
    out = _launch(principal, thr, nrows, ncols, nlevels)
    chaos_count_sums.launches += 1
    return out


chaos_count_sums.launches = 0
