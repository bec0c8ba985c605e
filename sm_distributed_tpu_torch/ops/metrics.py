"""MSM metrics for a formula batch, in torch.

Port of ``sm_distributed_tpu/ops/metrics_jax.py`` (``batch_metrics``,
``batch_metrics_from_partials`` and their epilogues): one moments pass
(``ops/moments.py``, or the fused kernel's partials from ``ops/score.py``)
feeds the chaos thresholds and the correlation and pattern-match epilogues;
chaos counts come from ``ops/chaos.py``.  On the card those are the
hand-written kernels; on the CPU their plain versions.  With
``image_generation.do_preprocessing`` the block is hot-spot clipped first
(``hotspot_clip_batch``, torch ops), bit-identical to the numpy oracle's
cutoff (``ops/metrics_np.py``: ``hotspot_percentile_f32``, ``hotspot_clip``,
imported here).
"""

from __future__ import annotations

import numpy as np
import torch

from ..analysis.numerics import numerics_surface
from .chaos import chaos_count_sums, chaos_count_sums_torch
from .metrics_np import hotspot_clip, hotspot_percentile_f32  # noqa: F401
from .moments import batch_moments, batch_moments_torch

# Numerics contracts (analysis/numerics.py), the JAX package's
# ``ops/metrics_jax.py`` sites.  The flat step's test holds each
# component at its site's declared bound against the numpy oracle on the
# fixtures.  The JAX package's ``isotope_image_correlation_batch`` has no
# site here: spatial always goes through the moments and
# ``correlation_from_moments``.
NUMERICS = numerics_surface(__name__, {
    "batch_metrics":
        "contract=ulp(16); test=tests/test_torch_numerics.py::"
        "test_flat_step_holds_its_contracts; padded=images",
    "measure_of_chaos_batch":
        "contract=bit_exact; test=tests/test_torch_numerics.py::"
        "test_flat_step_holds_its_contracts; padded=principal",
    "hotspot_clip_batch":
        "contract=bit_exact; test=tests/test_torch_preprocess.py::"
        "test_hotspot_clip_batch_matches_jax_and_oracle; padded=images",
    "correlation_from_moments":
        "contract=ulp(16); test=tests/test_torch_numerics.py::"
        "test_flat_step_holds_its_contracts",
    "isotope_pattern_match_batch":
        "contract=ulp(16); test=tests/test_torch_numerics.py::"
        "test_flat_step_holds_its_contracts",
    "batch_metrics_from_partials":
        "contract=bit_exact; test=tests/test_torch_numerics.py::"
        "test_epilogue_from_partials_is_batch_metrics; padded=principal",
})

_TINY = 1e-30   # the JAX package's np.float32(1e-30) denominators floor

# bytes of sort scratch (values and int64 indices) hot-spot clipping may
# hold at once: the block is sorted in groups of ions within it
HOTSPOT_SORT_BYTES = 1 << 29


def hotspot_clip_batch(images: torch.Tensor, q: float) -> torch.Tensor:
    """Hot-spot removal of an (N, K, P) block IN PLACE, bit-identical to
    ``hotspot_percentile_f32``: each (ion, peak) image is clipped at the
    q-th linear-interpolated percentile of its positive pixels; images with
    no positive pixel pass through.  Returns ``images``.

    Each row is sorted ascending: the positives occupy its top m slots
    (zeros and lattice pads sort below them), so the interpolation base
    sits at index (P - m) + floor(pos).  Three hazards, each of which flips
    clipped-pixel bits:

    - FMA: the cutoff is ``v_lo + ((v_hi - v_lo) * frac)`` as separate
      ops, each one rounded kernel; never ``torch.addcmul``, ``torch.lerp``
      (which rounds differently) or ``torch.compile``, any of which may
      contract the multiply-add;
    - the index offset (P - m) + floor(pos) stays in integer arithmetic
      (folded into the float position it would round);
    - memory: ``torch.sort`` returns int64 indices beside the values, 12
      bytes a pixel; a (2048, 4, 65536) block sorted whole would add 6.4
      GB, so ions are sorted in groups of at most ``HOTSPOT_SORT_BYTES``
      of scratch."""
    n, k, p = images.shape
    # the JAX package's host f32 constant: t = f32(q) / f32(100)
    # smlint: host-sync-ok[two scalars go up once a clipped batch]
    t = torch.tensor(np.float32(q) / np.float32(100.0), dtype=torch.float32,
                     device=images.device)
    # smlint: host-sync-ok[two scalars go up once a clipped batch]
    inf = torch.tensor(float("inf"), dtype=images.dtype, device=images.device)
    step = max(1, HOTSPOT_SORT_BYTES // max(1, 12 * k * p))
    for s in range(0, n, step):
        block = images[s:s + step]
        srt = torch.sort(block, dim=-1).values
        # smlint: masked-ok[zero pads are never positive: the count is exact]
        m = (block > 0).sum(dim=-1)                        # int64
        pos = t * torch.clamp(m - 1, min=0).to(torch.float32)   # one mul
        lo = torch.floor(pos)                              # exact
        frac = (pos - lo)[..., None]                       # exact
        i_lo = (p - m) + lo.to(torch.int64)                # integer index
        i_hi = torch.clamp(i_lo + 1, max=p - 1)
        v_lo = torch.gather(srt, -1, torch.clamp(i_lo, 0, p - 1)[..., None])
        v_hi = torch.gather(srt, -1, i_hi[..., None])
        del srt
        prod = (v_hi - v_lo) * frac                        # exact diff, mul
        cutoff = v_lo + prod                               # one rounded add
        # an image with no positive pixel keeps its values: min(x, inf)
        cutoff = torch.where((m > 0)[..., None], cutoff, inf)
        torch.minimum(block, cutoff, out=block)
    return images


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
                  plain: bool = False, do_preprocessing: bool = False,
                  q: float = 99.0) -> torch.Tensor:
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
    it.  With ``do_preprocessing`` the masked block is then hot-spot
    clipped at percentile ``q``, in place too (``hotspot_clip_batch``).

    ``plain`` runs the plain versions of the moments and chaos steps on
    any device instead of the kernels: the chain the kernels are held
    against on the card."""
    valid = mask_block(images, n_valid, do_preprocessing, q)
    moments = batch_moments_torch if plain else batch_moments
    sums, normsq, dots, vmax, n_notnull = moments(images, n_real)
    return _msm_rows(images[:, 0, :], sums, normsq, dots, vmax, n_notnull,
                     theor_ints, n_valid, valid, nrows, ncols, nlevels, plain)


def mask_block(images: torch.Tensor, n_valid: torch.Tensor,
               do_preprocessing: bool = False, q: float = 99.0
               ) -> torch.Tensor:
    """``batch_metrics``' first step on an (N, K, P) image block, IN PLACE:
    the images of invalid isotope peaks zeroed, then, with
    ``do_preprocessing``, the block hot-spot clipped at percentile ``q``.
    Returns the (N, K) validity mask."""
    k = images.shape[1]
    valid = (torch.arange(k, dtype=torch.int64, device=images.device)[None, :]
             < n_valid[:, None])
    images.masked_fill_(~valid[:, :, None], 0.0)
    if do_preprocessing:
        hotspot_clip_batch(images, q)
    return valid


def batch_metrics_from_partials(partials: torch.Tensor,
                                principal: torch.Tensor,
                                theor_ints: torch.Tensor,
                                n_valid: torch.Tensor, nrows: int, ncols: int,
                                nlevels: int = 30) -> torch.Tensor:
    """``batch_metrics`` from precomputed moments: the fused kernel's exit.

    ``partials``: (N, K, 5) moment columns (sums, normsq, dots, vmax, nn)
    of the UNMASKED window rows; ``principal``: (N, nrows*ncols) window-0
    images, masked by :func:`moments_from_partials`."""
    sums, normsq, dots, vmax, n_notnull, valid = moments_from_partials(
        partials, principal, n_valid)
    return _msm_rows(principal, sums, normsq, dots, vmax, n_notnull,
                     theor_ints, n_valid, valid, nrows, ncols, nlevels)


def moments_from_partials(partials: torch.Tensor, principal: torch.Tensor,
                          n_valid: torch.Tensor):
    """``(sums, normsq, dots, vmax, n_notnull, valid)`` of the fused
    kernel's (N, K, 5) moment columns, masked as ``batch_metrics`` masks its
    image block.  ``batch_metrics`` zeroes invalid rows before its moments
    pass; here the mask moves onto the moment columns, which is exactly
    equivalent: an invalid row's masked image is all zero, so its sums,
    normsq and dots are 0.0, what the ``where`` writes, and valid rows'
    moments never see the mask.  vmax, nn and the principal image are
    window 0's, valid iff ``n_valid > 0``.  Pad pixels of ``principal``
    are exact zeros, so chaos needs no ``n_real`` mask.  The principal rows
    of ions with no valid peak are zeroed IN PLACE."""
    k = partials.shape[1]
    valid = (torch.arange(k, dtype=torch.int64,
                          device=partials.device)[None, :]
             < n_valid[:, None])
    zero = torch.zeros((), dtype=partials.dtype, device=partials.device)
    sums, normsq, dots = (torch.where(valid, partials[..., i], zero)
                          for i in range(3))
    alive0 = n_valid > 0
    vmax = torch.where(alive0, partials[:, 0, 3], zero)
    n_notnull = torch.where(alive0, partials[:, 0, 4], zero)
    principal.masked_fill_(~alive0[:, None], 0.0)
    return sums, normsq, dots, vmax, n_notnull, valid


def _msm_rows(principal, sums, normsq, dots, vmax, n_notnull, theor_ints,
              n_valid, valid, nrows, ncols, nlevels, plain=False
              ) -> torch.Tensor:
    """(N, 4) (chaos, spatial, spectral, msm) from the moments, each
    component 0 where the ion has no valid peak or an all-zero principal
    image."""
    chaos = measure_of_chaos_batch(principal, nrows, ncols, nlevels,
                                   vmax, n_notnull, plain=plain)
    spatial = correlation_from_moments(normsq, dots, theor_ints, valid)
    spectral = isotope_pattern_match_batch(sums, theor_ints, valid)
    return msm_combine(chaos, spatial, spectral, n_valid, vmax)


def msm_combine(chaos: torch.Tensor, spatial: torch.Tensor,
                spectral: torch.Tensor, n_valid: torch.Tensor,
                vmax: torch.Tensor) -> torch.Tensor:
    """(N, 4) (chaos, spatial, spectral, msm) of the three components, each
    0 where the ion has no valid peak or an all-zero principal image."""
    alive = (n_valid > 0) & (vmax > 0)
    zero = torch.zeros((), dtype=chaos.dtype, device=chaos.device)
    chaos = torch.where(alive, chaos, zero)
    spatial = torch.where(alive, spatial, zero)
    spectral = torch.where(alive, spectral, zero)
    msm = chaos * spatial * spectral
    return torch.stack([chaos, spatial, spectral, msm], dim=1)
