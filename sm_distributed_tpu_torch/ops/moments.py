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

``n_real`` (shape-bucket lattice): when the trailing pixels are zero rows
added by ``ops/buckets.row_bucket``, the mean divides by the real pixel
count and the centered block is masked back to zero past it; sums, max and
positive count are exactly invariant to zero pads.
"""

from __future__ import annotations

import ctypes

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


def _launch(images: torch.Tensor, n_real: int | None) -> torch.Tensor:
    from ..kernels import _build

    n, k, p = images.shape
    lib = _build.load("moments")
    fn = lib.sm_moments
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k_max = lib.sm_moments_k_max()
    if k > k_max:
        raise ValueError(f"moments kernel takes K <= {k_max} peaks, got {k}")
    out = torch.empty((n, k, 5), dtype=torch.float32, device=images.device)
    vec = int(p % 4 == 0 and images.data_ptr() % 16 == 0)
    masked = n_real is not None
    stream = torch.cuda.current_stream(images.device).cuda_stream
    _build.check(fn(images.data_ptr(), out.data_ptr(), n, k, p,
                    int(n_real) if masked else p, int(masked), vec, stream),
                 "moments kernel launch")
    return out


def batch_moments(images: torch.Tensor, n_real: int | None = None
                  ) -> _Moments:
    """Moments of an (N, K, P) f32 image block.  CPU: the plain version.
    CUDA: the ``csrc/moments.cu`` kernel (counted in
    ``batch_moments.launches``); anything else raises."""
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
