"""Per-ion image moments: one streaming pass for every metric reduction.

Port of ``sm_distributed_tpu/ops/moments_pallas.py``.  The MSM metrics need,
per (ion, peak) image row of the (N, K, P) block: the pixel sum, the
centered squared norm and the centered dot against the principal row, and
per ion the principal row's max and positive count.

- :func:`batch_moments` is the wrapper the metrics call.  A CPU tensor goes
  to the plain version; a CUDA tensor goes to the hand-written kernel
  ``csrc/moments.cu`` (kernels 1 and 2 of the port: masked when ``n_real``
  is given, unmasked otherwise), or the call raises.
- :func:`batch_moments_torch` is the plain version, op for op the JAX
  package's ``batch_moments_jnp``.
- :func:`moments_plan` is the launch plan of the kernel (and of
  ``csrc/fused_moments.cu``): one thread-block cluster of S CTAs per ion,
  each CTA a contiguous pixel slice of all K rows, held in its shared
  memory when the ion's block fits the cluster ("resident") and read from
  global memory on both passes when it does not ("streaming").

``n_real`` (shape-bucket lattice): when the trailing pixels are zero rows
added by ``ops/buckets.row_bucket``, the mean divides by the real pixel
count and the centered block is masked back to zero past it; sums, max and
positive count are exactly invariant to zero pads.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_Moments = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def batch_moments_torch(images: torch.Tensor, n_real: int | None = None
                        ) -> _Moments:
    """(sums (N,K), normsq (N,K), dots (N,K), vmax (N,), n_notnull (N,))
    in plain torch ops.  With ``n_real`` None (or equal to P) this is the
    unpadded sequence."""
    sums = images.sum(dim=-1)
    p = images.shape[-1]
    if n_real is None:
        cent = images - sums[..., None] / torch.tensor(
            float(p), dtype=torch.float32, device=images.device)
    else:
        mean = sums[..., None] / torch.tensor(
            float(n_real), dtype=torch.float32, device=images.device)
        real = torch.arange(p, device=images.device) < n_real
        cent = torch.where(real[None, None, :], images - mean,
                           torch.zeros((), dtype=images.dtype,
                                       device=images.device))
    normsq = (cent * cent).sum(dim=-1)
    dots = (cent[:, 0:1, :] * cent).sum(dim=-1)
    principal = images[:, 0, :]
    vmax = principal.amax(dim=1)
    nn = (principal > 0).to(torch.float32).sum(dim=1)
    return sums, normsq, dots, vmax, nn


# The shared memory a block may use on the card the plan is made for
# (NVIDIA H100 SXM).
SMEM_PER_BLOCK = 232_448
# cluster sizes the kernels take (16 is Hopper's non-portable maximum), and
# the most rows an ion may have (MC_K_MAX)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
K_MAX = 8
# the kernels' static shared memory beside the slice (McScratch in
# csrc/moments_cluster.cuh, ~5.6 KB), rounded up
STATIC_SMEM_RESERVE = 8192
# the resident slice's stage barriers (MC_BARRIER_BYTES)
BARRIER_BYTES = 64
# a slice of at most 64 KiB lets up to three CTAs share an SM, so one CTA's
# reductions and cluster barriers overlap its neighbours' copies
SLICE_TARGET_BYTES = 65_536


class MomentsPlan(NamedTuple):
    cluster: int        # CTAs per ion
    slice_len: int      # pixels per CTA (the last CTA's slice may be shorter)
    regime: str         # "resident" or "streaming"
    smem_bytes: int     # dynamic shared memory per CTA


def slice_len(p: int, cluster: int) -> int:
    """Pixels per CTA of a cluster of ``cluster`` CTAs over P pixels: P for
    one CTA, else ceil(P / cluster) rounded up to a multiple of 4."""
    if cluster == 1:
        return p
    return -(-(-(-p // cluster)) // 4) * 4


def moments_smem_bytes(k: int, slice_pixels: int, resident: bool) -> int:
    """Dynamic shared memory of one CTA (``mc_smem_bytes``): the stage
    barriers and K rows of the slice, each padded to 16 bytes (resident);
    none (streaming)."""
    if not resident:
        return 0
    return BARRIER_BYTES + 4 * k * (-(-slice_pixels // 4) * 4)


def moments_plan(n: int, k: int, p: int) -> MomentsPlan:
    """The cluster plan for ``n`` ions of ``k`` rows of ``p`` pixels.

    Resident when some cluster's slices fit a CTA's shared memory: the
    smallest cluster whose slice is at most SLICE_TARGET_BYTES, else the
    smallest that fits at all.  Streaming otherwise, with the largest
    cluster.  CTA ``rank`` takes pixels [rank * slice_len, (rank + 1) *
    slice_len) clipped to P; no slice is empty."""
    if n <= 0 or not 1 <= k <= K_MAX or p <= 0:
        raise ValueError(f"moments_plan: no plan for n={n} k={k} p={p}")
    sizes = [s for s in CLUSTER_SIZES if (s - 1) * slice_len(p, s) < p]
    fits = [s for s in sizes
            if moments_smem_bytes(k, slice_len(p, s), True)
            + STATIC_SMEM_RESERVE <= SMEM_PER_BLOCK]
    if not fits:
        s = sizes[-1]
        return MomentsPlan(s, slice_len(p, s), "streaming", 0)
    s = next((s for s in fits
              if 4 * k * slice_len(p, s) <= SLICE_TARGET_BYTES), fits[0])
    n_slice = slice_len(p, s)
    return MomentsPlan(s, n_slice, "resident",
                       moments_smem_bytes(k, n_slice, True))


def _launch(images: torch.Tensor, n_real: int | None) -> torch.Tensor:
    from ..kernels import _build

    n, k, p = images.shape
    lib = _build.load("moments")
    fn = lib.sm_moments
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k_max = lib.sm_moments_k_max()
    if k > k_max:
        raise ValueError(f"moments kernel takes K <= {k_max} peaks, got {k}")
    plan = moments_plan(n, k, p)
    out = torch.empty((n, k, 5), dtype=torch.float32, device=images.device)
    vec = int(p % 4 == 0 and images.data_ptr() % 16 == 0)
    masked = n_real is not None
    stream = torch.cuda.current_stream(images.device).cuda_stream
    _build.check(fn(images.data_ptr(), out.data_ptr(), n, k, p,
                    int(n_real) if masked else p, int(masked), vec,
                    plan.cluster, plan.slice_len,
                    int(plan.regime == "resident"), plan.smem_bytes, stream),
                 f"moments kernel launch ({plan})")
    return out


def batch_moments(images: torch.Tensor, n_real: int | None = None
                  ) -> _Moments:
    """Moments of an (N, K, P) f32 image block.  CPU: the plain version.
    CUDA: the ``csrc/moments.cu`` kernel, one cluster per ion as
    :func:`moments_plan` says (counted in ``batch_moments.launches``);
    anything else raises, a cluster the device cannot schedule included."""
    if images.device.type == "cpu":
        return batch_moments_torch(images, n_real)
    if images.device.type != "cuda":
        raise ValueError(f"batch_moments: unsupported device {images.device}")
    if images.dtype != torch.float32 or images.dim() != 3:
        raise ValueError("batch_moments takes an (N, K, P) float32 tensor, "
                         f"got {tuple(images.shape)} {images.dtype}")
    if not images.is_contiguous():
        raise ValueError("batch_moments takes a contiguous image block")
    p = images.shape[2]
    if n_real is not None and not 0 < int(n_real) <= p:
        raise ValueError(f"n_real={n_real} outside (0, {p}]")
    out = _launch(images, n_real)
    batch_moments.launches += 1
    return (out[:, :, 0], out[:, :, 1], out[:, :, 2], out[:, 0, 3],
            out[:, 0, 4])


batch_moments.launches = 0
