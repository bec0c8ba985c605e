"""Moments: the port's plain version against the JAX package.

The plain ``batch_moments_torch`` mirrors ``batch_moments_jnp`` op for op,
masked (``n_real`` set: lattice zero rows past it) and unmasked.  It is held
against ``batch_moments_jnp``, against the Pallas kernels in interpret mode,
and against an f64 reference.

Tolerances (the ulp(16) contract of ``COMPONENT_CONTRACTS`` for what feeds
spatial/spectral): the inputs sit on the integer intensity grid with every
row sum below 2**24, so sums, vmax and positive counts are exact in any
summation order and must be equal; the centered squared norms are sums of
non-negative f32 terms in another order than XLA's, held to 16 ulp; a
centered dot can cancel to near zero, so its error is measured in ulp of
the scale it is divided by in the correlation, sqrt(normsq[0] *
normsq[k]) — 16 ulp there is 16 ulp of the correlation.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sm_distributed_tpu.analysis.numerics import ulp_distance
from sm_distributed_tpu.ops.moments_pallas import (
    batch_moments_jnp,
    batch_moments_pallas,
    batch_moments_pallas_masked,
)
from sm_distributed_tpu_torch.ops.moments import batch_moments_torch

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

ULP = 16

SHAPES = [(6, 4, 256), (5, 3, 99), (4, 4, 1024), (3, 2, 130)]


def _block(shape, seed, n_real=None, density=0.4):
    """Integer-grid images (values < 2**10, so row sums stay < 2**24) with
    the lattice's zero pixels past ``n_real``."""
    rng = np.random.default_rng(seed)
    img = (rng.integers(0, 1 << 10, shape)
           * (rng.random(shape) < density)).astype(np.float32)
    if n_real is not None:
        img[:, :, n_real:] = 0.0
    return img


def _f64(img, n_real=None):
    x = img.astype(np.float64)
    p = x.shape[-1]
    n = p if n_real is None else n_real
    sums = x.sum(-1)
    cent = np.where(np.arange(p) < n, x - sums[..., None] / n, 0.0)
    return (sums, (cent * cent).sum(-1), (cent[:, 0:1] * cent).sum(-1),
            x[:, 0].max(-1), (x[:, 0] > 0).sum(-1).astype(np.float64))


def _assert_within(got, want, what):
    g = [np.asarray(a, np.float64) for a in got]
    w = [np.asarray(a, np.float64) for a in want]
    np.testing.assert_array_equal(g[0], w[0], err_msg=f"{what}: sums")
    np.testing.assert_array_equal(g[3], w[3], err_msg=f"{what}: vmax")
    np.testing.assert_array_equal(g[4], w[4], err_msg=f"{what}: n_notnull")
    assert ulp_distance(g[1], w[1]).max() <= ULP, f"{what}: normsq"
    scale = np.sqrt(np.maximum(w[1][:, 0:1] * w[1], 0)).astype(np.float32)
    ulp = np.spacing(np.maximum(scale, np.float32(1e-30)))
    assert (np.abs(g[2] - w[2]) / ulp).max() <= ULP, f"{what}: dots"


def _port(img, n_real):
    return [t.numpy() for t in batch_moments_torch(torch.from_numpy(img),
                                                   n_real)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_jnp(shape, masked):
    n_real = shape[2] - 7 if masked else None
    img = _block(shape, 1, n_real)
    want = batch_moments_jnp(img, None if n_real is None
                             else np.int32(n_real))
    _assert_within(_port(img, n_real), want, "vs batch_moments_jnp")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_pallas_interpret(shape, masked):
    n_real = shape[2] - 7 if masked else None
    img = _block(shape, 2, n_real)
    if masked:
        want = batch_moments_pallas_masked(img, np.int32(n_real),
                                           interpret=True)
    else:
        want = batch_moments_pallas(img, interpret=True)
    _assert_within(_port(img, n_real), want, "vs Pallas interpret")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("masked", [False, True])
def test_plain_matches_f64(shape, masked):
    n_real = shape[2] - 7 if masked else None
    img = _block(shape, 3, n_real)
    _assert_within(_port(img, n_real), _f64(img, n_real), "vs f64")


def test_masked_equals_unmasked_at_full_count():
    """``n_real == P`` is the unpadded sequence bit for bit."""
    img = _block((4, 4, 256), 4)
    for a, b in zip(_port(img, None), _port(img, 256)):
        np.testing.assert_array_equal(a, b)


def test_empty_and_single_pixel_rows():
    img = np.zeros((2, 4, 64), np.float32)
    img[1, 0, 5] = 3.0
    sums, normsq, dots, vmax, nn = _port(img, 60)
    assert np.all(np.isfinite(normsq)) and np.all(np.isfinite(dots))
    assert vmax.tolist() == [0.0, 3.0] and nn.tolist() == [0.0, 1.0]
