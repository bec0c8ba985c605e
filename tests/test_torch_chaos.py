"""Chaos: the port's plain component counts against the JAX package and scipy.

Counts are exact integers, so every comparison is bit-exact (the chaos
contract is 0 ulp): against the Pallas packed kernel in interpret mode,
against the JAX chaos score on its associative-scan route
(``measure_of_chaos_batch(use_pallas=False)``) through the port's epilogue,
and against ``scipy.ndimage.label`` with 4-connectivity on the same f32
threshold grid.  The plain version is also the plain version of the strip
kernel: it matches the JAX package's strip kernel in interpret mode on
multi-strip images, and scipy on whole-slide shapes.

The packed route's shared-memory kernel (``csrc/chaos.cu``, images of at
most 65,536 pixels) cannot run here: its routing, its shared-memory budget
and a sequential model of its algorithm (uint16 labels, level counts, the
padded level plane, links level by level from the top, the count identity)
are held here; ``chip_smoke.py`` holds the kernel itself on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import ndimage

from sm_distributed_tpu.ops.chaos_pallas import chaos_count_sums as jcount
from sm_distributed_tpu.ops.chaos_pallas import (
    chaos_count_sums_strips as jstrips,
)
from sm_distributed_tpu.ops.chaos_pallas import chaos_route as jroute
from sm_distributed_tpu.ops.metrics_jax import measure_of_chaos_batch as jchaos
from sm_distributed_tpu_torch.ops.chaos import (
    SMEM_MAX_PIXELS,
    chaos_count_sums,
    chaos_count_sums_strips,
    chaos_count_sums_torch,
    chaos_route,
    chaos_smem_bytes,
    chaos_thresholds,
    packed_variant,
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
    """Shapes the JAX package routes to its strip kernel are served: on the
    CPU the wrappers return scipy's count sums (a sparse seeded image,
    two levels, so the plain version stays quick)."""
    assert jroute(*shape) == chaos_route(*shape) == "strips"
    r, c = shape
    rng = np.random.default_rng(r + c)
    img = np.where(rng.random(r * c) < 0.05, rng.random(r * c),
                   0).astype(np.float32)[None]
    want = np.float32(_scipy_count_sum(img[0].reshape(r, c), 2))
    for wrapper in (chaos_count_sums, chaos_count_sums_strips):
        got = wrapper(torch.from_numpy(img), r, c, 2).numpy()
        np.testing.assert_array_equal(got, [want])


def _snake(nr, nc):
    """One component that spans every strip, down and up across their
    boundaries (tests/test_chaos_pallas.py)."""
    snake = np.zeros((nr, nc), np.float32)
    snake[:, 2] = 1.0
    snake[0, 2:60] = 1.0
    snake[:, 60] = 1.0
    snake[nr - 1, 10:60] = 1.0
    return snake


STRIP_CASES = {
    # shape, strip rows, levels, image count (the JAX kernel's test shapes)
    "48x64-serpentine": ((48, 64), 16, 6, 3),
    "50x70": ((50, 70), 16, 5, 4),
    "33x129": ((33, 129), 8, 5, 4),
}


@pytest.mark.parametrize("name", list(STRIP_CASES))
def test_plain_matches_strip_kernel_interpret(name):
    (r, c), strip_rows, nlevels, n = STRIP_CASES[name]
    imgs = _random((r, c), sum(map(ord, name)), n=n)
    if name.endswith("serpentine"):
        imgs = np.concatenate([imgs, _snake(r, c).reshape(1, -1),
                               _serpentine(r, c).reshape(1, -1),
                               np.zeros((1, r * c), np.float32)])
    want = np.asarray(jstrips(imgs, nrows=r, ncols=c, nlevels=nlevels,
                              interpret=True, strip_rows=strip_rows))
    got = chaos_count_sums_strips(torch.from_numpy(imgs), r, c, nlevels)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_scan_shapes_raise():
    assert jroute(2, 100000) == chaos_route(2, 100000) == "scan"
    with pytest.raises(NotImplementedError, match="scan"):
        chaos_count_sums(torch.zeros((1, 2 * 100000)), 2, 100000, 4)


# ------------------------------------------- the shared-memory packed kernel
# shared memory an H100 block may use (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_SMEM_PER_BLOCK = 232448


@pytest.mark.parametrize("shape,variant", [
    ((256, 256), "smem"), ((9, 11), "smem"), ((32, 32), "smem"),
    ((1, 65537), "global"), ((257, 256), "global"), ((512, 512), "global")])
def test_packed_variant_by_pixel_count(shape, variant):
    """Images of at most 65,536 pixels (the uint16 label limit) take the
    shared-memory kernel, larger ones the global-plane kernel."""
    assert packed_variant(shape[0] * shape[1]) == variant
    assert (shape[0] * shape[1] <= SMEM_MAX_PIXELS) == (variant == "smem")
    if shape != (1, 65537):
        assert chaos_route(*shape) == "packed"


@pytest.mark.parametrize("nlevels", [1, 30, 255])
def test_smem_bytes_fit_an_h100_block(nlevels):
    """The main path's 256x256 grid fits one block's shared memory at every
    level count up to the kernels' 255: labels 2 bytes and level counts 1
    byte a pixel, plus row padding, thresholds and the reduction."""
    got = chaos_smem_bytes(256, 256, nlevels)
    assert 3 * 65536 < got <= H100_SMEM_PER_BLOCK
    assert chaos_smem_bytes(256, 256, 255) == 144 + 1024 + 131072 + 66564


def test_smem_bytes_fit_every_small_packed_shape():
    """Any packed-route shape of at most 65,536 pixels fits (the packed
    budget keeps narrow images short, so row padding stays small)."""
    for nrows in (1, 2, 3, 7, 64, 255, 2048, 2304):
        for ncols in (1, 2, 3, 5, 16, 31, 256, 300, 4096, 65536):
            if nrows * ncols <= SMEM_MAX_PIXELS and \
                    chaos_route(nrows, ncols) == "packed":
                assert chaos_smem_bytes(nrows, ncols, 255) \
                    <= H100_SMEM_PER_BLOCK, (nrows, ncols)


def _model_union(par, a, b):
    """``smem_union`` run alone: climb the side whose parent is larger
    (halving its path) until the two sides share a parent (one tree, 0) or
    that side is a root, which then hangs under the other side's smaller
    parent (the compare-and-swap, a join, 1)."""
    while True:
        pa, pb = int(par[a]), int(par[b])
        if pa == pb:
            return 0
        if pa < pb:
            a, b, pa, pb = b, a, pb, pa
        if pa == a:
            par[a] = pb
            return 1
        g = int(par[pa])
        if g != pa:
            par[a] = g
        a = g


def _model_smem_kernel(imgs, nrows, ncols, nlevels):
    """A sequential model of ``csrc/chaos.cu::chaos_smem_kernel`` on (N, P)
    f32 images: per image, the level counts by binary search over the
    thresholds, the padded level plane (rows of round_up(ncols + 1, 4)
    bytes, padding at level 0, a zero word after the last row), uint16
    labels set for m > 0, then levels e = top .. 1, each linking the right
    and down edges whose byte-wise minimum is e by the kernel's union, and
    the count identity sum(m) - sum over joins of e.  Returns the (N,)
    f32 sums and each image's final label plane."""
    p_count = nrows * ncols
    assert p_count <= SMEM_MAX_PIXELS
    img = np.maximum(imgs.astype(np.float32), 0.0)
    vmax = torch.from_numpy(img.max(axis=1))
    thr = chaos_thresholds(vmax, nlevels).numpy()
    row = (ncols + 4) & ~3
    words = nrows * row
    sums, planes = [], []
    for im in range(img.shape[0]):
        # #{l : thr[l] < v}: a binary search over the rising thresholds
        m = np.searchsorted(thr[im], img[im], side="left").astype(np.uint8)
        lev = np.zeros(words + 4, np.uint8)
        lev[:words].reshape(nrows, row)[:, :ncols] = m.reshape(nrows, ncols)
        par = np.zeros(p_count, np.uint16)
        live = np.nonzero(m)[0]
        par[live] = live.astype(np.uint16)
        acc = int(m.sum(dtype=np.int64))
        e_right = np.minimum(lev[:words], lev[1:words + 1])
        e_down = np.minimum(lev[:words - row], lev[row:words])
        for e in range(int(m.max(initial=0)), 0, -1):
            links = 0
            hits_r = set(np.nonzero(e_right == e)[0].tolist())
            hits_d = set(np.nonzero(e_down == e)[0].tolist())
            for q in sorted(hits_r | hits_d):
                assert q % row < ncols      # padding never links
                a = (q // row) * ncols + q % row
                if q in hits_r:
                    links += _model_union(par, a, a + 1)
                if q in hits_d:
                    links += _model_union(par, a, a + ncols)
            acc -= e * links
        assert (par[live] <= live).all()    # labels fall along every chain
        sums.append(acc)
        planes.append(par)
    return np.asarray(sums, np.float32), planes


def test_smem_model_matches_plain_pallas_and_scipy(case):
    (r, c), imgs, nlevels = case
    got, _ = _model_smem_kernel(imgs, r, c, nlevels)
    plain = chaos_count_sums_torch(torch.from_numpy(imgs), r, c, nlevels)
    np.testing.assert_array_equal(got, plain.numpy())
    want = np.asarray(jcount(imgs, nrows=r, ncols=c, nlevels=nlevels,
                             interpret=True))
    np.testing.assert_array_equal(got, want)
    sc = [_scipy_count_sum(im.reshape(r, c), nlevels) for im in imgs]
    np.testing.assert_array_equal(got, np.asarray(sc, np.float32))


def test_smem_model_at_the_uint16_limit():
    """One 256x256 image, dense enough that its last pixel (label 65535,
    set) joins a component and is linked under a smaller root: the model
    stays bit-equal to the plain version, the Pallas kernel in interpret
    mode and scipy."""
    rng = np.random.default_rng(65535)
    img = np.where(rng.random(65536) < 0.55, rng.random(65536),
                   0).astype(np.float32)
    img[[65535, 65534, 65535 - 256]] = 0.9
    imgs = img[None]
    got, planes = _model_smem_kernel(imgs, 256, 256, 5)
    assert planes[0][65535] < 65535          # label 65535 was live, linked
    plain = chaos_count_sums_torch(torch.from_numpy(imgs), 256, 256, 5)
    np.testing.assert_array_equal(got, plain.numpy())
    want = np.asarray(jcount(imgs, nrows=256, ncols=256, nlevels=5,
                             interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0] == _scipy_count_sum(img.reshape(256, 256), 5)
