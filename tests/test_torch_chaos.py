"""Chaos: the port's plain component counts against the JAX package and scipy.

Counts are exact integers, so every comparison is bit-exact (the chaos
contract is 0 ulp): against the Pallas packed kernel in interpret mode,
against the JAX chaos score on its associative-scan route
(``measure_of_chaos_batch(use_pallas=False)``) through the port's epilogue,
and against ``scipy.ndimage.label`` with 4-connectivity on the same f32
threshold grid.  Shapes the JAX package sends to its strip kernel raise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import ndimage

from sm_distributed_tpu.ops.chaos_pallas import chaos_count_sums as jcount
from sm_distributed_tpu.ops.chaos_pallas import chaos_route as jroute
from sm_distributed_tpu.ops.metrics_jax import measure_of_chaos_batch as jchaos
from sm_distributed_tpu_torch.ops.chaos import (
    chaos_count_sums,
    chaos_count_sums_torch,
    chaos_route,
)
from sm_distributed_tpu_torch.ops.metrics import measure_of_chaos_batch

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

_S4 = [[0, 1, 0], [1, 1, 1], [0, 1, 0]]


def _scipy_count_sum(img2d, nlevels):
    img = np.maximum(img2d.astype(np.float32), 0.0)
    vmax = img.max()
    return sum(ndimage.label(img > vmax * (np.float32(li) / np.float32(nlevels)),
                             structure=_S4)[1] for li in range(nlevels))


def _serpentine(r=16, c=16):
    img = np.zeros((r, c), np.float32)
    for row in range(0, r, 2):
        img[row, :] = 1.0
        if row + 1 < r:
            img[row + 1, c - 1 if (row // 2) % 2 == 0 else 0] = 1.0
    return img


def _random(shape, seed, n=6):
    rng = np.random.default_rng(seed)
    r, c = shape
    return np.where(rng.random((n, r * c)) < 0.45,
                    rng.random((n, r * c)), 0).astype(np.float32)


CASES = {
    "random8x8": lambda: ((8, 8), _random((8, 8), 0), 6),
    "random12x10": lambda: ((12, 10), _random((12, 10), 1), 6),
    "random16x33": lambda: ((16, 33), _random((16, 33), 2), 6),
    "serpentine": lambda: ((16, 16), _serpentine().reshape(1, -1), 1),
    "serpentine_levels": lambda: (
        (16, 16), (_serpentine() * np.linspace(0.2, 1, 16, dtype=np.float32)
                   ).reshape(1, -1), 5),
    "empty": lambda: ((8, 8), np.zeros((1, 64), np.float32), 4),
    "full": lambda: ((8, 8), np.ones((1, 64), np.float32), 4),
    "negative": lambda: ((8, 8), -_random((8, 8), 3, n=2), 3),
}


@pytest.fixture(params=list(CASES))
def case(request):
    return CASES[request.param]()


def test_plain_matches_pallas_interpret(case):
    (r, c), imgs, nlevels = case
    want = np.asarray(jcount(imgs, nrows=r, ncols=c, nlevels=nlevels,
                             interpret=True))
    got = chaos_count_sums_torch(torch.from_numpy(imgs), r, c, nlevels)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_matches_scipy(case):
    (r, c), imgs, nlevels = case
    got = chaos_count_sums(torch.from_numpy(imgs), r, c, nlevels).numpy()
    want = [_scipy_count_sum(im.reshape(r, c), nlevels) for im in imgs]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_chaos_score_matches_scan_route(case):
    (r, c), imgs, nlevels = case
    clamped = np.maximum(imgs, 0)
    vmax = clamped.max(axis=1)
    nn = (clamped > 0).sum(axis=1).astype(np.float32)
    want = np.asarray(jchaos(imgs, r, c, nlevels, use_pallas=False,
                             vmax=vmax, n_notnull=nn))
    got = measure_of_chaos_batch(torch.from_numpy(imgs), r, c, nlevels,
                                 torch.from_numpy(vmax), torch.from_numpy(nn))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1024, 1024), (700, 900), (256, 256),
                                   (512, 512), (9, 11), (4, 2000)])
def test_route_matches_jax(shape):
    assert chaos_route(*shape) == jroute(*shape)


@pytest.mark.parametrize("shape", [(1024, 1024), (700, 900)])
def test_strip_shapes_raise(shape):
    assert jroute(*shape) == "strips"
    img = torch.zeros((1, shape[0] * shape[1]))
    with pytest.raises(NotImplementedError, match="strip chaos kernel"):
        chaos_count_sums(img, shape[0], shape[1], 4)
