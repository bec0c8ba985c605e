"""Fused window extraction + moment partials: the flat path without the
materialized image block.

Port of ``sm_distributed_tpu/ops/score_pallas.py``.  From one batch's
histogram scratch and its ion-major chunk plan, every window row's moment
partials and every ion's principal (window 0) image:

- ``partials`` (C, Wc, 5) f32, columns (sums, normsq, dots, vmax, nn) per
  window row in the plan's chunk-sorted order: pixel sum, centered squared
  norm and centered dot against the ion's window 0 (the mean divides by
  ``n_real`` and pixels past it are masked out of the centered terms), max
  and positive count;
- ``principal`` (C, ipc, P) f32.

The (B, K, P) image block of the plain chain (``ops/imager.banded_images``
then ``ops/moments``) is never written.

- :func:`fused_window_moments` is the wrapper.  A CPU tensor goes to the
  plain version; a CUDA tensor goes to the hand-written kernel
  ``csrc/fused_moments.cu``, one thread-block cluster per ion planned by
  ``ops/moments.moments_plan``, one launch per row group of
  ``ops/moments.moments_groups`` (one group up to ``K_MAX`` windows an ion;
  each launch counted in ``fused_window_moments.launches``), or the call
  raises.
- :func:`fused_window_moments_torch` is the plain version: the plain
  chain's ``banded_images`` and ``batch_moments_torch``, rearranged into the
  partials and the principal rows.

Exactness: image values are integer-grid sums below 2**24, so principal
rows, vmax and nn are exact in any order.  Row sums may pass 2**24, where an
f32 total depends on its order: both versions take the exact total (f64
accumulation, exact for integers below 2**53) rounded once.  The centered
terms are the plain chain's f32 sums in the plain version and
f64-accumulated in the kernel, which sits within an ulp or two of an f64
reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..analysis.numerics import numerics_surface
from ..analysis.surface import kernel_surface
from ..kernels import _build
from .imager import banded_images
from .moments import K_MAX, batch_moments_torch, moments_groups, moments_plan

# Numerics contract (analysis/numerics.py), the JAX package's
# ``ops/score_pallas.py`` site.  The CPU test holds the plain twin to an
# f64 reference; the kernel's proof is on the card (chip_smoke.py phases
# 6, 10.5 and 20: the kernel against this plain version).
NUMERICS = numerics_surface(__name__, {
    "fused_window_moments":
        "contract=ulp(16); test=tests/test_torch_fused.py::"
        "test_plain_matches_dense_reference; padded=whp",
})

# The kernel build surface (analysis/surface.py): the library this module
# launches, and what bounds its launches' shapes.
KERNEL_SURFACE = kernel_surface(__name__, {
    "_launch":
        "library=fused_moments; shapes=the chunk plan's windows, K <= K_MAX "
        "a launch (row groups past it), the cluster of moments_plan",
})


def _moment_partials(x: torch.Tensor, n_real: int) -> torch.Tensor:
    """(B, K, 5) partials of a (B, K, P) image block: the plain chain's
    ``batch_moments_torch`` normsq and dots, with two columns it does not
    give.  Sums are the exact totals rounded once, since an f32 sum past
    2**24 depends on its order and the kernel's must match bit for bit;
    max and positive count are taken for every window, not only window 0."""
    _sums, normsq, dots, _vmax, _nn = batch_moments_torch(x, n_real)
    sums = x.sum(dim=-1, dtype=torch.float64).to(torch.float32)
    vmax = x.amax(dim=-1)
    nn = (x > 0).sum(dim=-1).to(torch.float32)
    return torch.stack([sums, normsq, dots, vmax, nn], dim=-1)


def fused_window_moments_torch(whp: torch.Tensor, starts, r_lo_loc:
                               torch.Tensor, r_hi_loc: torch.Tensor,
                               n_real: int, *, gc_width: int, k: int
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(partials (C, Wc, 5), principal (C, ipc, P)) in plain torch ops."""
    n_chunks, wc = r_lo_loc.shape
    p = whp.shape[1]
    x = banded_images(whp, starts, r_lo_loc, r_hi_loc,
                      gc_width=gc_width).view(-1, k, p)
    partials = _moment_partials(x, n_real).view(n_chunks, wc, 5)
    return partials, x[:, 0, :].reshape(n_chunks, wc // k, p)


@_build.on_tensor_device
def _launch(whp: torch.Tensor, starts: torch.Tensor, r_lo_loc: torch.Tensor,
            r_hi_loc: torch.Tensor, n_real: int, gc_width: int, k: int
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch per row group of ``ops/moments.moments_groups`` (window 0
    and up to K_MAX - 1 more windows an ion; one group up to K_MAX), each
    counted in ``fused_window_moments.launches``."""
    cols, p = whp.shape
    n_chunks, wc = r_lo_loc.shape
    dev = whp.device
    lib = _build.ready("fused_moments", dev)
    fn = lib.sm_fused_moments
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.sm_fused_moments_k_max() != K_MAX:
        raise _build.KernelError(f"fused kernel takes K <= "
                                 f"{lib.sm_fused_moments_k_max()}, plan "
                                 f"K_MAX={K_MAX}")
    partials = torch.empty((n_chunks, wc, 5), dtype=torch.float32, device=dev)
    principal = torch.empty((n_chunks, wc // k, p), dtype=torch.float32,
                            device=dev)
    vec = int(p % 4 == 0 and whp.stride(0) % 4 == 0
              and whp.data_ptr() % 16 == 0 and principal.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for first, width in moments_groups(k):
        plan = moments_plan(n_chunks * (wc // k), width, p)
        _build.check(fn(whp.data_ptr(), whp.stride(0), cols, starts.data_ptr(),
                        r_lo_loc.data_ptr(), r_hi_loc.data_ptr(),
                        partials.data_ptr(), principal.data_ptr(), n_chunks,
                        wc, width, k, first, p, int(n_real), gc_width,
                        plan.cluster, plan.slice_len,
                        int(plan.regime == "resident"), plan.smem_bytes, vec,
                        stream),
                     f"fused window-moments kernel launch (windows "
                     f"{first}+{width - 1}, {plan})")
        fused_window_moments.launches += 1
    return partials, principal


def fused_window_moments(whp: torch.Tensor, starts, r_lo_loc: torch.Tensor,
                         r_hi_loc: torch.Tensor, n_real: int, *,
                         gc_width: int, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Partials and principal rows of every chunk of the plan.

    ``whp``: (cols, P) f32 histogram rows (``flat_histogram(...)[:, :P]``;
    pixels unit-strided, rows may be strided); ``starts``: (C,) host chunk
    grid offsets; ``r_lo_loc``/``r_hi_loc``: (C, Wc) int32 local rank
    bounds, Wc a multiple of ``k``; ``n_real``: the real pixel count (P off
    the lattice).  CPU: the plain version.  CUDA: the
    ``csrc/fused_moments.cu`` kernel; anything else raises."""
    if whp.device.type == "cpu":
        return fused_window_moments_torch(whp, starts, r_lo_loc, r_hi_loc,
                                          n_real, gc_width=gc_width, k=k)
    if whp.device.type != "cuda":
        raise ValueError(f"fused_window_moments: unsupported device "
                         f"{whp.device}")
    cols, p = whp.shape
    n_chunks, wc = r_lo_loc.shape
    if whp.dtype != torch.float32 or whp.stride(1) != 1 or cols < gc_width + 2:
        raise ValueError("fused_window_moments takes (cols >= gc_width + 2, P)"
                         " float32 rows with unit-strided pixels")
    if wc % k or not 0 < int(n_real) <= p:
        raise ValueError(f"fused_window_moments: Wc={wc} not a multiple of "
                         f"k={k}, or n_real={n_real} outside (0, {p}]")
    for t in (r_lo_loc, r_hi_loc):
        if t.dtype != torch.int32 or t.shape != (n_chunks, wc) \
                or not t.is_contiguous() or t.device != whp.device:
            raise ValueError("fused_window_moments takes contiguous (C, Wc) "
                             "int32 rank bounds on the histogram's device")
    # smlint: host-sync-ok[the chunk grid offsets go up once a batch]
    starts_d = torch.from_numpy(
        np.ascontiguousarray(starts, dtype=np.int32)).to(whp.device)
    if starts_d.shape != (n_chunks,):
        raise ValueError(f"fused_window_moments: {tuple(starts_d.shape)} "
                         f"starts for {n_chunks} chunks")
    return _launch(whp, starts_d, r_lo_loc, r_hi_loc, int(n_real), gc_width,
                   k)


fused_window_moments.launches = 0
