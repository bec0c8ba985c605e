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
from sm_distributed_tpu_torch.ops.moments import (
    SMEM_PER_BLOCK,
    STATIC_SMEM_RESERVE,
    batch_moments_torch,
    moments_plan,
    moments_smem_bytes,
    slice_len,
)

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


# ------------------------------------------------- the cluster kernel's plan
def slices(p, cluster):
    """(start, length) of each CTA's slice in rank order, as the kernels
    cut P pixels over a cluster of ``cluster`` CTAs."""
    n = slice_len(p, cluster)
    return [(r * n, min(n, p - r * n)) for r in range(cluster)]


@pytest.mark.parametrize("shape,regime,cluster", [
    ((2048, 4, 65536), "resident", 16),     # the main path: 64 KiB slices
    ((256, 4, 1048576), "streaming", 16),   # the whole-slide block
    ((5, 3, 999), "resident", 1),
    ((2, 1, 99), "resident", 1),
    ((64, 8, 65536), "resident", 16),       # K = 8: 128 KiB slices
    ((256, 1, 65536), "resident", 4),
    ((4, 3, 1000003), "streaming", 16),     # P not divisible by S or by 4
    ((2048, 4, 65533), "resident", 16),
    ((3, 2, 70001), "resident", 16),
    ((3, 1, 8192), "resident", 1),
    ((256, 4, 1024), "resident", 1),        # the golden fixture's block
], ids=str)
def test_moments_plan(shape, regime, cluster):
    """The plan's regime and cluster size at the shapes the paths give it;
    its slices tile [0, P) exactly once, none empty, each a multiple of 4
    pixels but the last when the cluster has more than one CTA; a resident
    slice fits one H100 block's shared memory beside the static scratch."""
    n, k, p = shape
    plan = moments_plan(n, k, p)
    assert (plan.regime, plan.cluster) == (regime, cluster), plan
    assert plan.slice_len == slice_len(p, plan.cluster)
    parts = slices(p, plan.cluster)
    assert len(parts) == plan.cluster
    covered = np.zeros(p, np.int64)
    for start, length in parts:
        assert length > 0
        covered[start:start + length] += 1
    assert (covered == 1).all()
    if plan.cluster > 1:
        assert all(length % 4 == 0 for _, length in parts[:-1])
    if regime == "resident":
        assert plan.smem_bytes == moments_smem_bytes(k, plan.slice_len, True)
        assert plan.smem_bytes + STATIC_SMEM_RESERVE <= SMEM_PER_BLOCK
        assert plan.smem_bytes >= 4 * k * plan.slice_len
    else:
        assert plan.smem_bytes == 0
        assert 4 * k * slice_len(p, 16) + STATIC_SMEM_RESERVE > SMEM_PER_BLOCK


def test_moments_plan_main_shape_leaves_room_for_three_ctas():
    """At the main path's shape a CTA's slice is 64 KiB, so three CTAs
    (with their static scratch) share an SM's 228 KiB."""
    plan = moments_plan(2048, 4, 65536)
    assert plan.slice_len == 4096 and plan.smem_bytes == 64 + 65536
    assert 3 * (plan.smem_bytes + STATIC_SMEM_RESERVE) <= 233472


@pytest.mark.parametrize("bad", [(0, 4, 10), (3, 0, 10), (3, 9, 10),
                                 (3, 4, 0)])
def test_moments_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        moments_plan(*bad)


def _model_cluster_moments(img, n_real, cluster, max_rows=1):
    """A sequential model of ``csrc/moments.cu`` (and of the fused kernel's
    moment passes) on an (N, K, P) f32 block: the plan's slices for a
    cluster of ``cluster`` CTAs, per-slice f64 sums combined in rank order,
    the mean f32(total) / n in f32 (one rounding), then per slice the
    centered values masked by the global pixel index and their products in
    f32 (one rounding each) summed in f64, combined in rank order and
    rounded to f32 once; max and positive count per slice, combined over the
    cluster, for the first ``max_rows`` rows.  Returns the (N, K, 5) rows."""
    n, k, p = img.shape
    n_mean = p if n_real is None else n_real
    parts = slices(p, cluster)
    tot = np.zeros((n, k))
    vmax = np.full((n, max_rows), -np.inf, np.float32)
    cnt = np.zeros((n, max_rows), np.int64)
    for start, length in parts:             # pass 1, rank order
        x = img[:, :, start:start + length]
        tot = tot + x.astype(np.float64).sum(axis=2)
        vmax = np.maximum(vmax, x[:, :max_rows].max(axis=2))
        cnt += (x[:, :max_rows] > 0).sum(axis=2)
    sums = tot.astype(np.float32)
    mean = sums / np.float32(n_mean)
    assert mean.dtype == np.float32
    ns, dt = np.zeros((n, k)), np.zeros((n, k))
    for start, length in parts:             # pass 2, rank order
        x = img[:, :, start:start + length]
        real = start + np.arange(length) < n_mean
        c = np.where(real, x - mean[..., None], np.float32(0))
        assert c.dtype == np.float32
        ns = ns + (c * c).astype(np.float64).sum(axis=2)
        dt = dt + (c[:, 0:1] * c).astype(np.float64).sum(axis=2)
    out = np.zeros((n, k, 5), np.float32)
    out[..., 0], out[..., 1], out[..., 2] = sums, ns, dt
    out[..., 3] = vmax if max_rows == k else vmax[:, :1]
    out[..., 4] = cnt if max_rows == k else cnt[:, :1]
    return out


MODEL_CASES = [
    # (shape, n_real, cluster): n_real inside a non-last slice, at 1, at P
    ((6, 4, 256), 100, 4),
    ((5, 3, 999), 990, 2),
    ((5, 3, 999), None, 16),
    ((2, 1, 99), 1, 1),
    ((3, 8, 1024), 700, 8),
    ((4, 2, 130), None, 2),
    ((4, 4, 4096), 1500, 16),
    ((2, 2, 1001), 1001, 4),
]


@pytest.mark.parametrize("shape,n_real,cluster", MODEL_CASES, ids=str)
def test_cluster_model_matches_plain_jnp_and_f64(shape, n_real, cluster):
    """The model is bit-equal to the plain version in sums, max and counts
    on the integer grid, and its norms and dots sit within ULP of the f64
    reference and of ``batch_moments_jnp`` beyond that one's own drift."""
    img = _block(shape, 5, n_real)
    got = _model_cluster_moments(img, n_real, cluster)
    cols = [got[..., 0], got[..., 1], got[..., 2], got[:, 0, 3],
            got[:, 0, 4]]
    plain = _port(img, n_real)
    for i in (0, 3, 4):
        np.testing.assert_array_equal(cols[i], plain[i])
    _assert_within(cols, _f64(img, n_real), "model vs f64")
    want = [np.asarray(a, np.float64) for a in batch_moments_jnp(
        img, None if n_real is None else np.int32(n_real))]
    ref = _f64(img, n_real)
    assert (ulp_distance(cols[1], want[1])
            <= ULP + ulp_distance(want[1], ref[1])).all()
    scale = np.sqrt(np.maximum(ref[1][:, 0:1] * ref[1], 0)).astype(np.float32)
    ulp = np.spacing(np.maximum(scale, np.float32(1e-30)))
    assert (np.abs(cols[2] - want[2]) / ulp
            <= ULP + np.abs(want[2] - ref[2]) / ulp).all()


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_cluster_model_sums_do_not_depend_on_the_split(cluster):
    """On the integer grid the split changes no sum, max or count bit, and
    the centered terms stay within ULP of the one-CTA model's."""
    img = _block((4, 4, 2048), 6, 1500)
    one = _model_cluster_moments(img, 1500, 1)
    got = _model_cluster_moments(img, 1500, cluster)
    for i in (0, 3, 4):
        np.testing.assert_array_equal(got[..., i], one[..., i])
    assert ulp_distance(got[..., 1], one[..., 1]).max() <= ULP
