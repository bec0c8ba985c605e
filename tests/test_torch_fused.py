"""The fused window-moments path of the port against the JAX package.

The JAX package's fused Pallas kernel (``ops/score_pallas.py``) does not run
on this jax, so the port's plain fused version is held against what that
kernel is declared equal to: the plain chain, JAX's
``extract_images_flat_banded`` + ``batch_moments_jnp`` on the same histogram
and plan, the dense membership of ``tests/test_score_pallas.py``, and f64
moments of the same images.

Tolerances: image values are integer-grid sums below 2**24, so principal
rows, vmax and positive counts are exact and must be equal.  Row sums may
pass 2**24 (the 32x32 spheroid's do): the port takes the exact total
rounded once, which must equal the f64 total of the images rounded to f32.
Centered norms are sums of f32 terms in another order than XLA's, held to
16 ulp of the f64 moments (the ulp(16) contract of the moments); a centered
dot can cancel to near zero, so its error is measured in ulp of the scale
it is divided by in the correlation, sqrt(normsq[0] * normsq[k]).  Against
JAX's f32 moments the port may differ by 16 ulp plus JAX's own distance
from f64 (XLA's dots drift by tens of ulp on a one-pixel image).  Metrics:
the ``COMPONENT_CONTRACTS`` ulp ceilings (chaos 0, spatial 16, spectral 16,
msm 32); FDR ranks identical.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from sm_distributed_tpu.analysis.numerics import ulp_distance
from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu.models.msm_basic import _slice_table
from sm_distributed_tpu_torch.convert import (
    configs_from_dicts,
    dataset_from_arrays,
    pattern_table_from_arrays,
)
from sm_distributed_tpu_torch.ops.imager import banded_images, flat_histogram
from sm_distributed_tpu_torch.ops.moments import CLUSTER_SIZES, slice_len
from sm_distributed_tpu_torch.ops.score import (
    _moment_partials,
    fused_window_moments,
    fused_window_moments_torch,
)

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

# the JAX backends here leave XLA's persistent compilation cache off: it is
# process-global once on, and would turn later tests' compiles in the same
# worker into cache loads
NO_XLA_CACHE = "off"

ULP = 16
CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}
FIXTURES = {
    "offgrid9x11": dict(nrows=9, ncols=11, formulas=None,
                        present_fraction=0.5, noise_peaks=12, seed=41),
    "spheroid32": dict(nrows=32, ncols=32, formulas=None,
                       present_fraction=0.6, noise_peaks=200,
                       mz_jitter_ppm=0.5, seed=7),
}
ADDUCTS = ("+H", "+K")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """name -> (jax dataset, port dataset, jax table, port table, fdr,
    assignment), built once per module."""
    from sm_distributed_tpu.ops.fdr import FDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig

    cache = {}

    def get(name):
        if name not in cache:
            path, truth = generate_synthetic_dataset(
                tmp_path_factory.mktemp(name), **FIXTURES[name])
            jds = JDataset.from_imzml(path)
            tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds,
                                      jds.mask, jds.mzs_flat, jds.ints_flat,
                                      jds.row_ptr)
            fdr = FDR(decoy_sample_size=3, target_adducts=ADDUCTS, seed=42)
            assignment = fdr.decoy_adduct_selection(truth.formulas)
            pairs, flags = assignment.all_ion_tuples(truth.formulas, ADDUCTS)
            jt = IsocalcWrapper(IsotopeGenerationConfig(adducts=ADDUCTS),
                                n_procs=1).pattern_table(pairs, flags)
            tt = pattern_table_from_arrays(jt.sfs, jt.adducts, jt.mzs,
                                           jt.ints, jt.n_valid, jt.targets)
            cache[name] = (jds, tds, jt, tt, fdr, assignment)
        return cache[name]

    return get


def _score(backend, table, batch):
    return np.concatenate(backend.score_batches(
        [_slice_table(table, s, min(s + batch, table.n_ions))
         for s in range(0, table.n_ions, batch)]))


def _ranks(table, metrics, fdr, assignment):
    df = pd.DataFrame({"sf": table.sfs, "adduct": table.adducts,
                       "msm": metrics[:, 3]})
    return fdr.estimate_fdr(df, assignment)


def _f64_moments(imgs, n_real):
    """(sums, normsq, dots) of a (b, k, P) block in f64."""
    x = imgs.astype(np.float64)
    sums = x.sum(axis=2)
    real = np.arange(x.shape[2]) < n_real
    cent = np.where(real, x - sums[..., None] / n_real, 0.0)
    return sums, (cent * cent).sum(axis=2), (cent[:, 0:1] * cent).sum(axis=2)


def _dot_ulps(dots, ref_dots, ref_normsq):
    """|dots - ref| in ulp of sqrt(normsq[0] * normsq[k]) (f32)."""
    scale = np.sqrt(ref_normsq[:, 0:1] * ref_normsq).astype(np.float32)
    spacing = np.spacing(np.maximum(scale, np.float32(1e-30)))
    return np.abs(dots.astype(np.float64) - ref_dots) / spacing


def _check_partials(partials, principal, imgs, n_real, jax_moments=None):
    """Partials (C, Wc, 5) and principal rows (C, ipc, P) of the port
    against the (b, k, P) images: exact columns equal, centered columns
    within ULP of the f64 moments, and, given JAX's (sums, normsq, dots) of
    the block, within ULP of them beyond their own distance from f64."""
    b, k, p = imgs.shape
    part = partials.reshape(b, k, 5)
    np.testing.assert_array_equal(principal.reshape(b, p), imgs[:, 0, :])
    np.testing.assert_array_equal(part[..., 3], imgs.max(axis=2))
    np.testing.assert_array_equal(part[..., 4],
                                  (imgs > 0).sum(axis=2).astype(np.float32))
    sums, normsq, dots = _f64_moments(imgs, n_real)
    np.testing.assert_array_equal(part[..., 0], sums.astype(np.float32))
    assert ulp_distance(part[..., 1], normsq).max() <= ULP
    assert _dot_ulps(part[..., 2], dots, normsq).max() <= ULP
    if jax_moments is not None:
        j_sums, j_normsq, j_dots = jax_moments
        assert (ulp_distance(part[..., 0], j_sums)
                <= ULP + ulp_distance(j_sums, sums)).all()
        assert (ulp_distance(part[..., 1], j_normsq)
                <= ULP + ulp_distance(j_normsq, normsq)).all()
        assert (_dot_ulps(part[..., 2], j_dots, normsq)
                <= ULP + _dot_ulps(j_dots, dots, normsq)).all()


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("buckets", ["auto", "off"])
def test_plain_matches_jax_plain_chain(fixtures, name, buckets):
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.ops.imager_jax import (
        extract_images_flat_banded as jextract,
    )
    from sm_distributed_tpu.ops.moments_pallas import batch_moments_jnp
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    jds, tds, jt, tt = fixtures(name)[:4]
    sm_dict = {"backend": "jax_tpu",
               "parallel": {"formula_batch": 64, "shape_buckets": buckets,
                            "compile_cache_dir": NO_XLA_CACHE}}
    ds_dict = {"isotope_generation": {"adducts": list(ADDUCTS)}}
    jb = JaxBackend(jds, DSConfig.from_dict(ds_dict),
                    SMConfig.from_dict(sm_dict))
    sm, dc = configs_from_dicts(sm_dict, ds_dict, device="cpu")
    tb = TorchBackend(tds, dc, sm)
    n_pix = tb._n_pix_b
    n_real = tb.n_real if tb.n_real is not None else n_pix
    for s in range(0, min(jt.n_ions, 192), tb.batch):
        t = _slice_table(jt, s, min(s + tb.batch, jt.n_ions))
        _grid, _lo, _hi, _ints, _nv, chunks, pos, b_eff = tb._flat_plan(t)
        starts, r_lo_loc, r_hi_loc, _inv, gc, _order = chunks
        k = t.max_peaks
        imgs = np.asarray(jextract(
            jb._px_s, jb._in_s, pos, starts, r_lo_loc, r_hi_loc, None,
            gc_width=gc, n_pixels=n_pix)).reshape(b_eff, k, n_pix)
        sums, normsq, dots, _vmax, _nn = (np.asarray(a) for a in
                                          batch_moments_jnp(imgs, np.int32(n_real)))
        wh = flat_histogram(tb._px_s, tb._in_s,
                            torch.from_numpy(pos.astype(np.int64)),
                            gc_width=gc, n_pixels=n_pix)
        args = (wh[:, :n_pix], starts, torch.from_numpy(r_lo_loc),
                torch.from_numpy(r_hi_loc), n_real)
        partials, principal = fused_window_moments_torch(
            *args, gc_width=gc, k=k)
        assert partials.shape == (len(starts), r_lo_loc.shape[1], 5)
        assert principal.shape == (len(starts), r_lo_loc.shape[1] // k,
                                   n_pix)
        _check_partials(partials.numpy(), principal.numpy(), imgs, n_real,
                        (sums, normsq, dots))
        # the wrapper on a CPU tensor is the plain version
        for a, w in zip(fused_window_moments(*args, gc_width=gc, k=k),
                        (partials, principal)):
            assert torch.equal(a, w)
        assert imgs[:, 0].any()


def _model_window_values(whp, starts, r_lo, r_hi, gc_width, cluster):
    """A sequential model of the fused kernel's pass 0 on a (cols, P) f32
    histogram: per window (its chunk's start clamped to start_eff, the
    local ranks shifted by the same amount, the band rows g0..g1 clipped to
    [0, gc_width + 1]) and per CTA slice of the plan's split over
    ``cluster`` CTAs, the window's band rows added in row order in f32.
    Returns the (C * Wc, P) values in plan order."""
    from test_torch_moments import slices

    cols, p = whp.shape
    n_chunks, wc = r_lo.shape
    out = np.zeros((n_chunks * wc, p), np.float32)
    for c in range(n_chunks):
        start = int(starts[c])
        start_eff = min(start, cols - (gc_width + 2))
        shift = start - start_eff
        for w in range(wc):
            g0 = max(int(r_lo[c, w]) + shift + 1, 0)
            g1 = min(int(r_hi[c, w]) + shift, gc_width + 1)
            for a, length in slices(p, cluster):
                v = np.zeros(length, np.float32)
                for g in range(g0, g1 + 1):
                    v = v + whp[start_eff + g, a:a + length]
                out[c * wc + w, a:a + length] = v
    return out


def _largest_cluster(p, want):
    """The largest cluster size up to ``want`` whose slices of P pixels are
    all non-empty (the plans the kernels take)."""
    return max(s for s in CLUSTER_SIZES
               if s <= want and (s - 1) * slice_len(p, s) < p)


def _model_fused(whp, starts, r_lo, r_hi, n_real, gc_width, k, cluster):
    """(values (C*Wc, P), partials (C, Wc, 5), principal (C, ipc, P)) of
    the fused kernel's model: pass 0's window values, then the cluster
    moments model with max and positive count for every window."""
    from test_torch_moments import _model_cluster_moments

    cluster = _largest_cluster(whp.shape[1], cluster)
    vals = _model_window_values(whp, starts, r_lo, r_hi, gc_width, cluster)
    n_chunks, wc = r_lo.shape
    blk = vals.reshape(-1, k, whp.shape[1])
    part = _model_cluster_moments(blk, n_real, cluster, max_rows=k)
    return (vals, part.reshape(n_chunks, wc, 5),
            blk[:, 0, :].reshape(n_chunks, wc // k, -1))


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("cluster", [1, 4, 16])
def test_cluster_model_matches_plain_chain(fixtures, name, cluster):
    """The fused kernel's per-slice window derivation is bit-equal to the
    port's ``banded_images`` rows and to the JAX package's plain chain
    (``extract_images_flat_banded``) on the fixture's first batch; its
    partials, through the cluster moments model, hold the contract of
    ``_check_partials`` against those images, JAX's moments and f64."""
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.ops.imager_jax import (
        extract_images_flat_banded as jextract,
    )
    from sm_distributed_tpu.ops.moments_pallas import batch_moments_jnp
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    jds, tds, jt = fixtures(name)[:3]
    sm_dict = {"backend": "jax_tpu",
               "parallel": {"formula_batch": 64,
                            "compile_cache_dir": NO_XLA_CACHE}}
    ds_dict = {"isotope_generation": {"adducts": list(ADDUCTS)}}
    jb = JaxBackend(jds, DSConfig.from_dict(ds_dict),
                    SMConfig.from_dict(sm_dict))
    sm, dc = configs_from_dicts(sm_dict, ds_dict, device="cpu")
    tb = TorchBackend(tds, dc, sm)
    n_pix = tb._n_pix_b
    n_real = tb.n_real if tb.n_real is not None else n_pix
    t = _slice_table(jt, 0, min(tb.batch, jt.n_ions))
    _grid, _lo, _hi, _ints, _nv, chunks, pos, b_eff = tb._flat_plan(t)
    starts, r_lo_loc, r_hi_loc, _inv, gc, _order = chunks
    k = t.max_peaks
    wh = flat_histogram(tb._px_s, tb._in_s,
                        torch.from_numpy(pos.astype(np.int64)),
                        gc_width=gc, n_pixels=n_pix)
    assert wh.stride(0) % 4 == 0           # rows 16-byte aligned
    whp = wh[:, :n_pix]
    vals, partials, principal = _model_fused(
        whp.numpy(), starts, r_lo_loc, r_hi_loc, n_real, gc, k, cluster)
    plain = banded_images(whp, starts, torch.from_numpy(r_lo_loc),
                          torch.from_numpy(r_hi_loc), gc_width=gc).numpy()
    np.testing.assert_array_equal(vals, plain)
    imgs = np.asarray(jextract(
        jb._px_s, jb._in_s, pos, starts, r_lo_loc, r_hi_loc, None,
        gc_width=gc, n_pixels=n_pix))
    np.testing.assert_array_equal(vals, imgs)
    imgs = imgs.reshape(b_eff, k, n_pix)
    sums, normsq, dots, _vmax, _nn = (
        np.asarray(a) for a in batch_moments_jnp(imgs, np.int32(n_real)))
    _check_partials(partials, principal, imgs, n_real, (sums, normsq, dots))
    assert imgs[:, 0].any()


def _plan_case(seed, C=3, ipc=4, k=3, gc_width=11, g=40, n_pix=128):
    """A histogram scratch and a chunk plan shaped like ``ion_window_chunks``
    output (the recipe of tests/test_score_pallas.py): integer-grid values
    on the real grid rows, chunk offsets and local window rank bounds."""
    rng = np.random.default_rng(seed)
    wc = ipc * k
    whp = np.zeros((max(g + 1, gc_width + 2), n_pix), np.float32)
    whp[:g + 1] = (rng.integers(0, 50, size=(g + 1, n_pix))
                   * (rng.random((g + 1, n_pix)) < 0.4)).astype(np.float32)
    starts = rng.integers(0, g - gc_width, size=C).astype(np.int32)
    r_lo = rng.integers(-1, gc_width - 2, size=(C, wc)).astype(np.int32)
    r_hi = (r_lo + rng.integers(1, 3, size=(C, wc))).astype(np.int32)
    return whp, starts, r_lo, r_hi


def _dense_images(whp, starts, r_lo, r_hi):
    """(C, Wc, P) f64 images through the dense global membership."""
    rows = np.arange(whp.shape[0])
    glo = starts[:, None] + r_lo
    ghi = starts[:, None] + r_hi
    d = ((rows[None, None, :] > glo[..., None])
         & (rows[None, None, :] <= ghi[..., None]))
    return np.einsum("cwr,rp->cwp", d.astype(np.float64),
                     whp.astype(np.float64))


@pytest.mark.parametrize("cluster", [1, 2, 16])
@pytest.mark.parametrize("n_real", [128, 37])
def test_cluster_model_matches_dense_reference(cluster, n_real):
    """On a synthetic plan with clamped chunk starts and empty windows, the
    model's values equal the dense membership's, and its partials those of
    the plain fused version (exact columns equal, centered ones in
    contract); n_real 37 falls in the first slice of a split."""
    k, gc_width = 3, 11
    whp, starts, r_lo, r_hi = _plan_case(7, k=k, gc_width=gc_width)
    starts[0] = whp.shape[0] - 3           # clamped: start_eff < start
    r_hi[1, 2] = r_lo[1, 2]                # an empty window
    vals, partials, principal = _model_fused(whp, starts, r_lo, r_hi,
                                             n_real, gc_width, k, cluster)
    dense = _dense_images(whp, starts, r_lo, r_hi)
    np.testing.assert_array_equal(vals, dense.reshape(vals.shape))
    want_p, want_pr = fused_window_moments_torch(
        torch.from_numpy(whp), starts, torch.from_numpy(r_lo),
        torch.from_numpy(r_hi), n_real, gc_width=gc_width, k=k)
    np.testing.assert_array_equal(principal, want_pr.numpy())
    for i in (0, 3, 4):
        np.testing.assert_array_equal(partials[..., i], want_p.numpy()[..., i])
    c, wc = r_lo.shape
    _check_partials(partials, principal,
                    vals.reshape(c * wc // k, k, -1), n_real)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_real", [128, 100])
def test_plain_matches_dense_reference(seed, n_real):
    k, gc_width = 3, 11
    whp, starts, r_lo, r_hi = _plan_case(seed, k=k, gc_width=gc_width)
    partials, principal = fused_window_moments_torch(
        torch.from_numpy(whp), starts, torch.from_numpy(r_lo),
        torch.from_numpy(r_hi), n_real, gc_width=gc_width, k=k)
    imgs = _dense_images(whp, starts, r_lo, r_hi)
    c, wc = r_lo.shape
    blk = imgs.reshape(c * wc // k, k, -1).astype(np.float32)
    _check_partials(partials.numpy(), principal.numpy(), blk, n_real)


@pytest.mark.parametrize("pad_to", [160, 256])
def test_plain_pad_invariant_across_lattice(pad_to):
    """Zero pixel columns past ``n_real`` leave every partial unchanged and
    the principal rows zero there (the lattice's row padding)."""
    k, gc_width, n_pix = 3, 11, 128
    whp, starts, r_lo, r_hi = _plan_case(5, k=k, gc_width=gc_width,
                                         n_pix=n_pix)
    padded = np.zeros((whp.shape[0], pad_to), np.float32)
    padded[:, :n_pix] = whp
    bounds = (starts, torch.from_numpy(r_lo), torch.from_numpy(r_hi), n_pix)
    base_p, base_pr = fused_window_moments_torch(
        torch.from_numpy(whp), *bounds, gc_width=gc_width, k=k)
    pad_p, pad_pr = fused_window_moments_torch(
        torch.from_numpy(padded), *bounds, gc_width=gc_width, k=k)
    assert torch.equal(pad_pr[..., :n_pix], base_pr)
    assert not pad_pr[..., n_pix:].any()
    assert torch.equal(pad_p, base_p)


def _partials_case(seed, n=24, k=4, nrows=10, ncols=11):
    """Moment partials of an integer-grid block, its principal rows, and
    side inputs with padded ions (n_valid 0) and partial envelopes."""
    rng = np.random.default_rng(seed)
    imgs = (rng.integers(0, 300, (n, k, nrows * ncols))
            * (rng.random((n, k, nrows * ncols)) < 0.3)).astype(np.float32)
    imgs[4::5] = 0.0
    theor = rng.uniform(1, 100, (n, k)).astype(np.float32)
    n_valid = rng.integers(0, k + 1, n).astype(np.int32)
    n_valid[:3] = [k, 1, 0]
    partials = _moment_partials(torch.from_numpy(imgs),
                                nrows * ncols).numpy()
    return imgs, partials, theor, n_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_from_partials_matches_jax(seed):
    from sm_distributed_tpu.ops.metrics_jax import (
        batch_metrics_from_partials as jfrom_partials,
    )
    from sm_distributed_tpu_torch.ops.metrics import (
        batch_metrics,
        batch_metrics_from_partials,
    )

    nrows, ncols, nlevels = 10, 11, 30
    imgs, partials, theor, n_valid = _partials_case(seed, nrows=nrows,
                                                    ncols=ncols)
    principal = imgs[:, 0, :]
    want = np.asarray(jfrom_partials(partials, principal, theor, n_valid,
                                     nrows, ncols, nlevels))
    t_principal = torch.from_numpy(principal.copy())
    got = batch_metrics_from_partials(
        torch.from_numpy(partials), t_principal, torch.from_numpy(theor),
        torch.from_numpy(n_valid), nrows, ncols, nlevels).numpy()
    assert got.dtype == np.float32 and got.shape == (len(imgs), 4)
    for col, comp in enumerate(CONTRACT):
        drift = int(ulp_distance(got[:, col], want[:, col]).max())
        assert drift <= CONTRACT[comp], f"{comp}: {drift} ulp"
    assert (got[:, 3] > 0).any()
    # principal rows of ions with no valid peak are zeroed in place
    assert not t_principal[torch.from_numpy(n_valid) == 0].any()
    # and the epilogue of the materialized block gives the same rows
    plain = batch_metrics(torch.from_numpy(imgs.copy()),
                          torch.from_numpy(theor), torch.from_numpy(n_valid),
                          nrows, ncols, nlevels).numpy()
    for col, comp in enumerate(CONTRACT):
        assert ulp_distance(got[:, col], plain[:, col]).max() <= \
            CONTRACT[comp], comp


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fused_backend_matches_jax_plain_backend(fixtures, name):
    """``fused_metrics="on"`` on the CPU against the JAX package's plain
    chain (``fused_metrics="off"``): chaos bit-equal, the other components
    within the contracts, FDR ranks identical."""
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    jds, tds, jt, tt, fdr, assignment = fixtures(name)
    ds_dict = {"isotope_generation": {"adducts": list(ADDUCTS)}}
    jb = JaxBackend(jds, DSConfig.from_dict(ds_dict), SMConfig.from_dict(
        {"backend": "jax_tpu",
         "parallel": {"formula_batch": 128, "fused_metrics": "off",
                      "compile_cache_dir": NO_XLA_CACHE}}),
        restrict_table=jt)
    sm, dc = configs_from_dicts(
        {"parallel": {"formula_batch": 128, "fused_metrics": "on"}},
        ds_dict, device="cpu")
    tb = TorchBackend(tds, dc, sm, restrict_table=tt)
    assert tb._fused
    want = _score(jb, jt, jb.batch)
    got = _score(tb, tt, tb.batch)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for col, comp in enumerate(CONTRACT):
        drift = int(ulp_distance(got[:, col], want[:, col]).max())
        assert drift <= CONTRACT[comp], f"{comp}: {drift} ulp"
    pd.testing.assert_frame_equal(_ranks(tt, got, fdr, assignment),
                                  _ranks(jt, want, fdr, assignment))
    assert (got[:, 3] > 0).any()


def test_fused_search_ranks_match_plain_search(fixtures):
    from sm_distributed_tpu_torch.io.fixtures import FIXTURE_FORMULAS
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch

    tds = fixtures("spheroid32")[1]
    out = {}
    for mode in ("off", "on"):
        sm, dc = configs_from_dicts(
            {"fdr": {"decoy_sample_size": 5},
             "parallel": {"formula_batch": 64, "fused_metrics": mode,
                          "isocalc_workers": 1}},
            {"isotope_generation": {"adducts": ["+H"]}}, device="cpu")
        out[mode] = MSMBasicSearch(tds, FIXTURE_FORMULAS, dc, sm).search()
    plain, fused = out["off"], out["on"]
    pd.testing.assert_frame_equal(
        fused.annotations[["sf", "adduct", "fdr", "fdr_level"]],
        plain.annotations[["sf", "adduct", "fdr", "fdr_level"]])
    cols = list(CONTRACT)
    a = fused.all_metrics[cols].to_numpy().astype(np.float32)
    b = plain.all_metrics[cols].to_numpy().astype(np.float32)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    for col, comp in enumerate(cols):
        assert ulp_distance(a[:, col], b[:, col]).max() <= CONTRACT[comp]
    assert len(fused.annotations) and (fused.annotations.msm > 0).any()
