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
    seam_smem_bytes,
    tile_plan,
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
    ((1, 65537), "tiles"), ((257, 256), "tiles"), ((512, 512), "tiles")])
def test_packed_variant_by_pixel_count(shape, variant):
    """Images of at most 65,536 pixels (the uint16 label limit) take the
    shared-memory kernel, larger ones the row-tile kernel."""
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


def _model_link(par, a, b):
    """``smem_union`` run alone: climb the side whose parent is larger
    (halving its path) until the two sides share a parent (one tree: None)
    or that side is a root, which then hangs under the other side's smaller
    parent (the compare-and-swap, a join: the hung root and its new
    parent)."""
    while True:
        pa, pb = int(par[a]), int(par[b])
        if pa == pb:
            return None
        if pa < pb:
            a, b, pa, pb = b, a, pb, pa
        if pa == a:
            par[a] = pb
            return a, pb
        g = int(par[pa])
        if g != pa:
            par[a] = g
        a = g


def _model_union(par, a, b):
    """1 when ``smem_union`` joins two trees, 0 when they were one."""
    return int(_model_link(par, a, b) is not None)


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


# --------------------------------------- the row-tile kernel and seam merge
# A sequential model of csrc/chaos_strips.cu: the tile kernel
# (chaos_block_count<true> of csrc/chaos_smem.cuh on tiles of whole rows,
# labels rotated one row, the joins of seam-holding trees recorded) and the
# seam merge (a union-find over every tile's seam slots, levels from the top,
# the records replayed and the cross-seam edges added, and the identity
# sum_t localsum_t - sum over cross joins of e + sum over records that
# joined nothing of e).  The tile-row count is a parameter, so small images
# are cut into many tiles; `seed` shuffles the links within each level, in
# the tiles and in the merge, as the card's threads may order them.

def _model_find(par, a):
    while int(par[a]) != a:
        a = int(par[a])
    return a


def _model_tile(m, rng):
    """One tile of level counts ``m`` (rows, ncols).  Returns its local sum,
    the level counts of its S seam labels and its records {a: (pb, e)}: the
    seam root a hung under pb at level e.
    Checks on the way, at every level, the per-level form of the records:
    each seam pixel's root rep_l(s) is a seam pixel, and I_t(l) (the seam
    pixels in the mask with rep_l(s) != s) equals the records of levels
    >= e."""
    rows, ncols = m.shape
    n_px = rows * ncols
    seam = 2 * ncols if rows > 1 else ncols
    flat = m.ravel()

    def label(p):
        return (p + ncols) % n_px

    par = np.zeros(n_px, np.int64)
    seam_m = np.zeros(seam, np.int64)
    for p in range(n_px):
        if flat[p]:
            par[label(p)] = label(p)
        if label(p) < seam:
            seam_m[label(p)] = flat[p]
    acc = int(flat.sum())
    rec = {}
    for e in range(int(flat.max(initial=0)), 0, -1):
        edges = [(p, p + 1) for p in range(n_px)
                 if p % ncols + 1 < ncols and min(flat[p], flat[p + 1]) == e]
        edges += [(p, p + ncols) for p in range(n_px - ncols)
                  if min(flat[p], flat[p + ncols]) == e]
        if rng is not None:
            rng.shuffle(edges)
        for a, b in edges:
            joined = _model_link(par, label(a), label(b))
            if joined is None:
                continue
            acc -= e
            root, parent = joined
            if root < seam:
                assert parent < root and root not in rec
                rec[root] = (parent, e)
        reps = {s: _model_find(par, s) for s in range(seam) if seam_m[s] >= e}
        assert all(r < seam for r in reps.values())
        i_t = sum(r != s for s, r in reps.items())
        assert i_t == sum(le >= e for _, le in rec.values())
    return acc, seam_m, rec


def _model_tiles(imgs, nrows, ncols, nlevels, rows, seed=None):
    """The (N,) f32 sums of the row-tile kernel and the seam merge on (N, P)
    f32 images cut into tiles of ``rows`` rows."""
    rng = None if seed is None else np.random.default_rng(seed)
    img = np.maximum(imgs.astype(np.float32), 0.0)
    thr = chaos_thresholds(torch.from_numpy(img.max(axis=1)), nlevels).numpy()
    tiles = -(-nrows // rows)
    slots = 2 * ncols if rows > 1 else ncols
    nodes = tiles * slots
    sums = []
    for im in range(img.shape[0]):
        m = np.searchsorted(thr[im], img[im],
                            side="left").reshape(nrows, ncols)
        seam_m = np.zeros(nodes, np.int64)
        rec = {}
        total = 0
        for t in range(tiles):
            acc, sm, rc = _model_tile(m[t * rows:(t + 1) * rows], rng)
            total += acc
            seam_m[t * slots:t * slots + len(sm)] = sm
            rec.update({t * slots + a: (t * slots + pb, e)
                        for a, (pb, e) in rc.items()})
        par = np.arange(nodes)
        for e in range(int(seam_m.max(initial=0)), 0, -1):
            ops = []
            for v in range(nodes):
                if seam_m[v] < e:
                    continue
                if v in rec and rec[v][1] == e:
                    ops.append((True, v, rec[v][0]))
                t, lab = divmod(v, slots)
                if lab < ncols and t + 1 < tiles:
                    below = min(rows, nrows - (t + 1) * rows)
                    q = (t + 1) * slots + (ncols + lab if below > 1 else lab)
                    if min(seam_m[v], seam_m[q]) == e:
                        ops.append((False, v, q))
            if rng is not None:
                rng.shuffle(ops)
            for replay, a, b in ops:
                joined = _model_union(par, a, b)
                if replay and not joined:
                    total += e
                elif not replay and joined:
                    total -= e
        sums.append(total)
    return np.asarray(sums, np.float32)


def _comb(teeth_down=True, r=24, c=21):
    """Vertical teeth on the even columns joined by one bar in the last
    (or first) row: cut into tiles of a few rows, the teeth join only in
    the bar's tile."""
    img = np.zeros((r, c), np.float32)
    img[:, ::2] = 1.0
    img[r - 1 if teeth_down else 0, :] = 1.0
    return img


def _spiral(n=23):
    """A square spiral of one-pixel lines one pixel apart, walked inwards
    from the top-left corner: one path whose vertical runs cross every
    horizontal seam many times."""
    img = np.zeros((n, n), np.float32)
    r = c = 0
    dr, dc = 0, 1
    img[r, c] = 1.0
    while True:
        for _ in range(2):      # straight on, else turn right once
            nr, nc = r + dr, c + dc
            ar, ac = nr + dr, nc + dc
            if 0 <= nr < n and 0 <= nc < n and not img[nr, nc] and not (
                    0 <= ar < n and 0 <= ac < n and img[ar, ac]):
                r, c = nr, nc
                img[r, c] = 1.0
                break
            dr, dc = dc, -dr
        else:
            return img


def _ramp(img, levels, seed):
    """``img`` with its set pixels at random heights, so components split
    and join across levels."""
    rng = np.random.default_rng(seed)
    h = rng.integers(1, levels + 1, size=img.shape).astype(np.float32)
    return (img * h).reshape(1, -1)


TILE_CASES = {
    # name: images, shape, levels, tile rows
    "random-3rows": lambda: (_random((12, 10), 4), (12, 10), 6, 3),
    "random-1row": lambda: (_random((7, 9), 5), (7, 9), 5, 1),
    "random-last-tile-1row": lambda: (_random((13, 8), 6), (13, 8), 5, 4),
    "random-16x33-5rows": lambda: (_random((16, 33), 7, n=3), (16, 33), 6, 5),
    "snake-5rows": lambda: (_snake(48, 64).reshape(1, -1), (48, 64), 3, 5),
    "snake-levels-7rows": lambda: (
        np.concatenate([_ramp(_snake(48, 64), 4, 1), _random((48, 64), 8, 2)]),
        (48, 64), 4, 7),
    "serpentine-2rows": lambda: (_serpentine(16, 16).reshape(1, -1),
                                 (16, 16), 2, 2),
    "comb-down-4rows": lambda: (_comb(True).reshape(1, -1), (24, 21), 2, 4),
    "comb-up-4rows": lambda: (_comb(False).reshape(1, -1), (24, 21), 2, 4),
    "comb-levels-3rows": lambda: (_ramp(_comb(True), 5, 2), (24, 21), 5, 3),
    "spiral-2rows": lambda: (_spiral().reshape(1, -1), (23, 23), 2, 2),
    "spiral-3rows": lambda: (_spiral().reshape(1, -1), (23, 23), 2, 3),
    "spiral-levels-4rows": lambda: (_ramp(_spiral(), 6, 3), (23, 23), 6, 4),
    "all-ones-3rows": lambda: (np.ones((1, 60), np.float32), (10, 6), 4, 3),
    "single-pixel": lambda: (np.eye(1, 9 * 8, 5 * 8 + 3, dtype=np.float32),
                             (9, 8), 3, 2),
    "one-row-tiles": lambda: (_ramp(_serpentine(9, 12), 3, 4), (9, 12), 3, 1),
}


@pytest.mark.parametrize("name", list(TILE_CASES))
@pytest.mark.parametrize("seed", [None, 1])
def test_tile_model_matches_plain_and_scipy(name, seed):
    """The row-tile kernel's and the seam merge's model, in label order and
    with the links of each level shuffled, equals the plain version and
    scipy."""
    imgs, (r, c), nlevels, rows = TILE_CASES[name]()
    got = _model_tiles(imgs, r, c, nlevels, rows, seed)
    plain = chaos_count_sums_torch(torch.from_numpy(imgs), r, c, nlevels)
    np.testing.assert_array_equal(got, plain.numpy())
    sc = [_scipy_count_sum(im.reshape(r, c), nlevels) for im in imgs]
    np.testing.assert_array_equal(got, np.asarray(sc, np.float32))
    assert got.any()


def test_tile_cases_cross_seams():
    """The comb's teeth and the spiral's path are one component that each
    tile sees in many pieces."""
    for img, rows in ((_comb(True), 4), (_comb(False), 4), (_spiral(), 2)):
        assert ndimage.label(img, structure=_S4)[1] == 1
        r = img.shape[0]
        pieces = [ndimage.label(img[t:t + rows], structure=_S4)[1]
                  for t in range(0, r, rows)]
        assert max(pieces) > 2, pieces


def test_tile_model_at_every_tile_height():
    """One random image cut at every tile height from one row to the whole
    image: the same sums."""
    imgs = _random((11, 7), 9, n=2)
    plain = chaos_count_sums_torch(torch.from_numpy(imgs), 11, 7, 4).numpy()
    for rows in range(1, 12):
        np.testing.assert_array_equal(_model_tiles(imgs, 11, 7, 4, rows),
                                      plain, err_msg=f"{rows} rows")


# the shapes of the route tests above that the row-tile kernel serves: every
# strip shape, every packed shape past 65,536 pixels, and the widest of each
TILE_SHAPES = [(1024, 1024), (700, 900), (512, 512), (257, 256),
               (400, 333), (8, 36864), (2048, 2048), (24, 8192), (100, 8192)]


@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("nlevels", [30, 255])
def test_tile_plan_fits_an_h100_block(shape, nlevels):
    """A tile holds at most 65,536 pixels and fits one block's shared
    memory; its level words fit the register slots or are counted; the seam
    nodes, the merge's placement and the scratch follow from the tiles."""
    r, c = shape
    assert packed_variant(r * c) == "tiles" or chaos_route(r, c) == "strips"
    plan = tile_plan(r, c, nlevels)
    assert 1 <= plan.rows <= r and plan.rows * c <= SMEM_MAX_PIXELS
    assert plan.tiles == -(-r // plan.rows)
    assert plan.tile_smem_bytes == chaos_smem_bytes(plan.rows, c, nlevels)
    assert plan.tile_smem_bytes <= H100_SMEM_PER_BLOCK
    assert plan.tile_words == plan.rows * ((c + 4) & ~3) // 4
    # every tile of these shapes fits the 17 register slots of 1024 words
    assert plan.tile_words <= 17 * 1024
    assert plan.seam_slots == (2 * c if plan.rows > 1 else c)
    assert plan.seam_nodes == plan.tiles * plan.seam_slots
    fits = (plan.seam_nodes <= SMEM_MAX_PIXELS
            and seam_smem_bytes(plan.seam_nodes) <= H100_SMEM_PER_BLOCK)
    assert plan.seam_in_smem == fits
    assert plan.plane_bytes == (0 if fits else 4 * plan.seam_nodes)
    assert plan.scratch_bytes == 5 * plan.seam_nodes + 4 * plan.tiles


@pytest.mark.parametrize("shape,want", [
    ((1024, 1024), (64, 16, 32768, True)),
    ((512, 512), (128, 4, 4096, True)),
    ((8, 36864), (1, 8, 294912, False)),
    ((2048, 2048), (32, 64, 262144, False)),
    ((24, 8192), (8, 3, 49152, False)),
    ((100, 8192), (8, 13, 212992, False)),
])
def test_tile_plan_shapes(shape, want):
    """Rows a tile, tiles, seam nodes and whether the merge keeps its
    union-find in shared memory: at the whole-slide shape, the 512x512
    packed shape, one-row tiles, the widest strip shape, and 2048x2048,
    whose seam nodes take the global seam plane."""
    plan = tile_plan(*shape, 30)
    assert (plan.rows, plan.tiles, plan.seam_nodes, plan.seam_in_smem) == want


def test_tile_scratch_is_sized_by_the_seams():
    """A 256-image whole-slide batch's scratch is far below the old design's
    label and level planes (5 bytes a pixel: 1.34 GB)."""
    plan = tile_plan(1024, 1024, 30)
    assert 256 * plan.scratch_bytes <= 256 * 1024 * 1024 * 5 // 2
    assert plan.scratch_bytes == 5 * 32768 + 4 * 16
