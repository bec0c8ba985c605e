"""MSM metrics for a formula batch, in torch.

Port of ``sm_distributed_tpu/ops/metrics_jax.py`` (``batch_metrics`` and its
epilogues): one moments pass (``ops/moments.py``) feeds the chaos thresholds
and the correlation and pattern-match epilogues; chaos counts come from
``ops/chaos.py``.  On the card those two are the hand-written kernels; on
the CPU their plain versions.
"""

from __future__ import annotations

import torch

from .chaos import chaos_count_sums, chaos_count_sums_torch
from .moments import batch_moments, batch_moments_torch

_TINY = 1e-30   # the JAX package's np.float32(1e-30) denominators floor


def measure_of_chaos_batch(principal: torch.Tensor, nrows: int, ncols: int,
                           nlevels: int, vmax: torch.Tensor,
                           n_notnull: torch.Tensor, plain: bool = False
                           ) -> torch.Tensor:
    """(N,) chaos = clip(1 - count_sums / (nlevels * n_notnull), 0, 1), 0
    for empty images.  ``vmax``/``n_notnull`` come from the moments pass.
    The one division is by a runtime denominator (exact in f32 below
    2**24), and torch rounds it correctly on both devices — a reciprocal
    multiply would drift by an ulp.  ``plain`` takes the counts from the
    plain version on any device (the yardstick for the kernel)."""
    counts = chaos_count_sums_torch if plain else chaos_count_sums
    count_sums = counts(principal, nrows, ncols, nlevels)
    denom = nlevels * torch.clamp(n_notnull, min=1.0)
    chaos = torch.clamp(1.0 - count_sums / denom, 0.0, 1.0)
    return torch.where((vmax > 0) & (n_notnull > 0), chaos,
                       torch.zeros_like(chaos))


def correlation_from_moments(normsq: torch.Tensor, dots: torch.Tensor,
                             weights: torch.Tensor, valid: torch.Tensor
                             ) -> torch.Tensor:
    """(N,) weighted mean Pearson correlation of peaks 1..K-1 against peak
    0, from the centered moments; constant images count 0; clipped to
    [0, 1]."""
    zero = torch.zeros((), dtype=normsq.dtype, device=normsq.device)
    norm = torch.sqrt(normsq)
    denom = norm[:, 0:1] * norm
    corr = torch.where(denom > 0, dots / torch.clamp(denom, min=_TINY), zero)
    w = torch.where(valid, weights, zero)
    w[:, 0] = 0.0
    wsum = w.sum(dim=1)
    out = torch.where(wsum > 0,
                      (corr * w).sum(dim=1) / torch.clamp(wsum, min=_TINY),
                      zero)
    return torch.clamp(out, 0.0, 1.0)


def isotope_pattern_match_batch(totals: torch.Tensor, theor: torch.Tensor,
                                valid: torch.Tensor) -> torch.Tensor:
    """(N,) cosine between the masked observed and theoretical envelopes,
    in [0, 1]."""
    zero = torch.zeros((), dtype=totals.dtype, device=totals.device)
    obs = torch.where(valid, totals, zero)
    th = torch.where(valid, theor, zero)
    on = torch.sqrt((obs * obs).sum(dim=1))
    tn = torch.sqrt((th * th).sum(dim=1))
    dot = (obs * th).sum(dim=1)
    out = torch.where((on > 0) & (tn > 0),
                      dot / torch.clamp(on * tn, min=_TINY), zero)
    return torch.clamp(out, 0.0, 1.0)


def batch_metrics(images: torch.Tensor, theor_ints: torch.Tensor,
                  n_valid: torch.Tensor, nrows: int, ncols: int,
                  nlevels: int = 30, n_real: int | None = None,
                  plain: bool = False) -> torch.Tensor:
    """(N, 4) of (chaos, spatial, spectral, msm) for an (N, K, nrows*ncols)
    image block.

    ``n_real`` (shape-bucket lattice): ``nrows`` is the row-bucketed grid
    and the trailing pixels are zero rows; the moments centre on the real
    pixel count, and chaos runs on the padded grid unmasked (zero pixels
    are below every threshold, so counts, vmax and n_notnull are exact
    either way).

    The images of invalid isotope peaks are zeroed IN PLACE (the JAX
    package's ``where(valid, images, 0)``): the block is a per-batch
    transient of several GB at full size, and a masked copy would double
    it.

    ``plain`` runs the plain versions of the moments and chaos steps on
    any device instead of the kernels: the chain the kernels are held
    against on the card."""
    k = images.shape[1]
    valid = (torch.arange(k, device=images.device)[None, :]
             < n_valid[:, None])
    images.masked_fill_(~valid[:, :, None], 0.0)
    moments = batch_moments_torch if plain else batch_moments
    sums, normsq, dots, vmax, n_notnull = moments(images, n_real)
    chaos = measure_of_chaos_batch(images[:, 0, :], nrows, ncols, nlevels,
                                   vmax, n_notnull, plain=plain)
    spatial = correlation_from_moments(normsq, dots, theor_ints, valid)
    spectral = isotope_pattern_match_batch(sums, theor_ints, valid)
    alive = (n_valid > 0) & (vmax > 0)
    zero = torch.zeros((), dtype=chaos.dtype, device=chaos.device)
    chaos = torch.where(alive, chaos, zero)
    spatial = torch.where(alive, spatial, zero)
    spectral = torch.where(alive, spectral, zero)
    msm = chaos * spatial * spectral
    return torch.stack([chaos, spatial, spectral, msm], dim=1)
