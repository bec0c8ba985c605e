"""``batch_metrics``: the port against the JAX package on the same blocks.

Contracts (``COMPONENT_CONTRACTS``): chaos bit-equal (integer counts and one
correctly rounded division on both sides); spatial and spectral within
16 ulp (the same f32 reductions taken in another order); msm within 32 ulp
(the product of three components carries their drift).  Cases: the lattice
on (``n_real`` set, zero rows past it) and off, with padded ions
(``n_valid`` 0), partial isotope envelopes and empty images.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sm_distributed_tpu.analysis.numerics import ulp_distance
from sm_distributed_tpu.ops.metrics_jax import batch_metrics as jmetrics
from sm_distributed_tpu_torch.ops.metrics import batch_metrics

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}


def _block(seed, n, k, nrows, ncols, real_rows):
    """Integer-grid ion images: blobs of signal on a sparse noise floor,
    rows past ``real_rows`` zero (lattice padding)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:nrows, 0:ncols]
    imgs = np.zeros((n, k, nrows, ncols), np.float32)
    for i in range(n):
        cy, cx = rng.uniform(0, real_rows), rng.uniform(0, ncols)
        rad = rng.uniform(1.5, 5)
        blob = np.clip(1 - np.hypot(yy - cy, xx - cx) / rad, 0, 1)
        for j in range(k):
            amp = rng.integers(50, 4000) * rng.uniform(0.5, 1.0)
            noise = rng.integers(0, 40, (nrows, ncols)) * (
                rng.random((nrows, ncols)) < 0.15)
            imgs[i, j] = np.rint(amp * blob * (i % 5 != 4)) + noise
    imgs[:, :, real_rows:, :] = 0.0
    theor = np.zeros((n, k), np.float32)
    theor[:, 0] = 100.0
    theor[:, 1:] = rng.uniform(1, 80, (n, k - 1)).astype(np.float32)
    n_valid = rng.integers(0, k + 1, n).astype(np.int32)
    n_valid[:3] = [k, 1, 0]
    return imgs.reshape(n, k, -1), theor, n_valid


@pytest.mark.parametrize("lattice", [False, True], ids=["plain", "lattice"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_metrics_matches_jax(lattice, seed):
    n, k, nrows, ncols, nlevels = 24, 4, 10, 11, 30
    real_rows = 9 if lattice else nrows
    imgs, theor, n_valid = _block(seed, n, k, nrows, ncols, real_rows)
    n_real = real_rows * ncols if lattice else None
    want = np.asarray(jmetrics(
        imgs, theor, n_valid, nrows, ncols, nlevels,
        n_real=None if n_real is None else np.int32(n_real)))
    got = batch_metrics(torch.from_numpy(imgs.copy()),
                        torch.from_numpy(theor), torch.from_numpy(n_valid),
                        nrows, ncols, nlevels, n_real=n_real).numpy()
    assert got.dtype == np.float32 and got.shape == (n, 4)
    for col, name in enumerate(CONTRACT):
        drift = int(ulp_distance(got[:, col], want[:, col]).max())
        assert drift <= CONTRACT[name], f"{name}: {drift} ulp"
    assert (got[:, 3] > 0).any()                 # the blocks do score


def test_invalid_peaks_are_zeroed_in_place():
    """The image block is masked in place (it is a per-batch transient)."""
    imgs, theor, n_valid = _block(3, 6, 4, 8, 8, 8)
    t = torch.from_numpy(imgs.copy())
    batch_metrics(t, torch.from_numpy(theor), torch.from_numpy(n_valid),
                  8, 8, 10)
    valid = np.arange(4)[None, :] < n_valid[:, None]
    np.testing.assert_array_equal(t.numpy()[~valid], 0.0)
    np.testing.assert_array_equal(t.numpy()[valid], imgs[valid])
