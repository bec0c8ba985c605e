"""The m/z-chunked cube path of the port against the JAX package's.

The same datasets (rebuilt through ``convert.py``) and ion tables go through
both packages:

- the dense cube (``padded_cube``, ``prepare_cube_arrays``) and the
  window-major chunk plan (``window_chunks``) are array-equal;
- ``extract_images_mz_chunked`` is bit-equal to the JAX function for
  ``mz_chunk`` 64 and 128 (ion images are exact integer-grid sums: no
  tolerance), and to the unchunked images;
- ``TorchBackend(mz_chunk)`` against ``JaxBackend(mz_chunk)`` and the f64
  numpy oracle: chaos bit-equal, spatial, spectral and msm within the
  ``COMPONENT_CONTRACTS`` ulp ceilings (chaos 0, spatial 16, spectral 16,
  msm 32) of the oracle, and of the JAX backend up to the JAX backend's own
  distance from the oracle (the two take their f32 reductions in different
  orders); FDR ranks identical;
- a port search on the cube path gives the annotations of the port's flat
  search.
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
from sm_distributed_tpu.ops import imager_jax
from sm_distributed_tpu_torch.convert import (
    configs_from_dicts,
    dataset_from_arrays,
    pattern_table_from_arrays,
)
from sm_distributed_tpu_torch.ops import imager

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

# the JAX backends here leave XLA's persistent compilation cache off: it is
# process-global once on, and would turn later tests' compiles in the same
# worker into cache loads
NO_XLA_CACHE = "off"

CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}
FIXTURES = {
    "offgrid9x11": dict(nrows=9, ncols=11, formulas=None,
                        present_fraction=0.5, noise_peaks=12, seed=41),
    "synthetic12x12": dict(nrows=12, ncols=12, present_fraction=0.5,
                           noise_peaks=80, seed=47),
}
ADDUCTS = ("+H", "+Na")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """name -> (jax dataset, port dataset, ion table (jax), ion table
    (port), fdr, assignment, oracle metrics), built once per module."""
    from sm_distributed_tpu.models.msm_basic import NumpyBackend
    from sm_distributed_tpu.ops.fdr import FDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import DSConfig, IsotopeGenerationConfig

    cache = {}

    def get(name):
        if name not in cache:
            path, truth = generate_synthetic_dataset(
                tmp_path_factory.mktemp(name), **FIXTURES[name])
            jds = JDataset.from_imzml(path)
            tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds,
                                      jds.mask, jds.mzs_flat, jds.ints_flat,
                                      jds.row_ptr)
            fdr = FDR(decoy_sample_size=5, target_adducts=ADDUCTS, seed=42)
            assignment = fdr.decoy_adduct_selection(truth.formulas)
            pairs, flags = assignment.all_ion_tuples(truth.formulas, ADDUCTS)
            jt = IsocalcWrapper(IsotopeGenerationConfig(adducts=ADDUCTS),
                                n_procs=1).pattern_table(pairs, flags)
            tt = pattern_table_from_arrays(jt.sfs, jt.adducts, jt.mzs,
                                           jt.ints, jt.n_valid, jt.targets)
            ds_cfg = DSConfig.from_dict(
                {"isotope_generation": {"adducts": list(ADDUCTS)}})
            oracle = _score(NumpyBackend(jds, ds_cfg), jt, 512)
            cache[name] = (jds, tds, jt, tt, fdr, assignment, oracle)
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


@pytest.mark.parametrize("name", list(FIXTURES))
def test_cube_arrays_equal(fixtures, name):
    jds, tds = fixtures(name)[:2]
    got, want = tds.padded_cube(), jds.padded_cube()
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for ppm in (None, 3.0):
        for a, b in zip(imager.prepare_cube_arrays(tds, ppm=ppm),
                        imager_jax.prepare_cube_arrays(jds, ppm=ppm)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _bounds(table, b_pad=0):
    """Window rank bounds of a table, with ``b_pad`` padding ions (bounds
    (0, 0)) appended as the backend pads a short batch."""
    from sm_distributed_tpu.ops.quantize import quantize_window

    lo, hi = quantize_window(table.mzs, 3.0)
    lo = np.concatenate([lo, np.zeros((b_pad, lo.shape[1]), lo.dtype)])
    hi = np.concatenate([hi, np.zeros((b_pad, hi.shape[1]), hi.dtype)])
    return imager_jax.window_rank_grid(lo, hi)


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("mz_chunk", [8, 64, 100])
def test_window_chunks_equal(fixtures, name, mz_chunk):
    jt = fixtures(name)[2]
    for b_pad in (0, 13):
        _grid, r_lo, r_hi = _bounds(jt, b_pad)
        want = imager_jax.window_chunks(r_lo, r_hi, mz_chunk)
        got = imager.window_chunks(r_lo, r_hi, mz_chunk)
        for a, b in zip(got[:4], want[:4]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[4] == want[4]


@pytest.mark.parametrize("name", list(FIXTURES))
@pytest.mark.parametrize("mz_chunk", [64, 128])
def test_chunked_images_bit_equal(fixtures, name, mz_chunk):
    import jax.numpy as jnp

    jds, tds, jt = fixtures(name)[:3]
    mz_q, int_cube = imager_jax.prepare_cube_arrays(jds, ppm=3.0)
    grid, r_lo, r_hi = _bounds(jt, b_pad=7)
    starts, rlo_l, rhi_l, inv, gcw = imager_jax.window_chunks(
        r_lo, r_hi, mz_chunk)
    want = np.asarray(imager_jax.extract_images_mz_chunked(
        jnp.asarray(mz_q), jnp.asarray(int_cube), jnp.asarray(grid),
        jnp.asarray(starts), jnp.asarray(rlo_l), jnp.asarray(rhi_l),
        jnp.asarray(inv), gc_width=gcw))
    tmz, tint = imager.prepare_cube_arrays(tds, ppm=3.0)
    got = imager.extract_images_mz_chunked(
        torch.from_numpy(tmz), torch.from_numpy(tint),
        torch.from_numpy(grid), starts, torch.from_numpy(rlo_l),
        torch.from_numpy(rhi_l), torch.from_numpy(inv.astype(np.int64)),
        gc_width=gcw).numpy()
    assert got.shape == want.shape == (r_lo.size, jds.n_pixels)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    # and the unchunked images: the chunk plan changes no bit
    unchunked = np.asarray(imager_jax.extract_images(
        jnp.asarray(mz_q), jnp.asarray(int_cube), jnp.asarray(grid),
        jnp.asarray(r_lo), jnp.asarray(r_hi)))
    np.testing.assert_array_equal(got, unchunked)


CASES = {
    "offgrid9x11-chunk64": ("offgrid9x11", 64, 128),
    "offgrid9x11-chunk512": ("offgrid9x11", 512, 512),
    "synthetic12x12-chunk128": ("synthetic12x12", 128, 256),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cube_backend_matches_jax_backend(fixtures, case):
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    name, mz_chunk, batch = CASES[case]
    jds, tds, jt, tt, fdr, assignment, oracle = fixtures(name)
    sm_dict = {"backend": "jax_tpu",
               "parallel": {"formula_batch": batch, "mz_chunk": mz_chunk,
                            "compile_cache_dir": NO_XLA_CACHE}}
    ds_dict = {"isotope_generation": {"adducts": list(ADDUCTS)}}
    jb = JaxBackend(jds, DSConfig.from_dict(ds_dict),
                    SMConfig.from_dict(sm_dict), restrict_table=jt)
    sm, dc = configs_from_dicts(sm_dict, ds_dict, device="cpu")
    tb = TorchBackend(tds, dc, sm, restrict_table=tt)
    assert tb.mz_chunk == jb.mz_chunk == mz_chunk
    assert tb.batch == jb.batch and tb.n_real is None
    assert tb.grid == (jds.nrows, jds.ncols)
    np.testing.assert_array_equal(tb._mz_q.numpy(), np.asarray(jb._mz_q))
    np.testing.assert_array_equal(tb._ints.numpy(), np.asarray(jb._ints))
    want = _score(jb, jt, jb.batch)
    got = _score(tb, tt, tb.batch)
    assert got.shape == want.shape == (jt.n_ions, 4)
    for col, comp in enumerate(CONTRACT):
        to_oracle = ulp_distance(got[:, col], oracle[:, col])
        assert to_oracle.max() <= CONTRACT[comp], \
            f"{comp}: {to_oracle.max()} ulp from the oracle"
        jax_to_oracle = ulp_distance(want[:, col], oracle[:, col])
        to_jax = ulp_distance(got[:, col], want[:, col])
        assert (to_jax <= CONTRACT[comp] + jax_to_oracle).all(), \
            f"{comp}: {to_jax.max()} ulp from the JAX backend"
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    pd.testing.assert_frame_equal(_ranks(tt, got, fdr, assignment),
                                  _ranks(jt, want, fdr, assignment))
    assert (got[:, 3] > 0).any()


def test_cube_image_block_is_the_scored_block(fixtures):
    """``image_block`` on the cube path returns the table-order images the
    cube scorer's metrics receive."""
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.ops.metrics import batch_metrics

    _jds, tds, _jt, tt = fixtures("synthetic12x12")[:4]
    sm, dc = configs_from_dicts(
        {"parallel": {"formula_batch": 64, "mz_chunk": 32}},
        {"isotope_generation": {"adducts": list(ADDUCTS)}}, device="cpu")
    tb = TorchBackend(tds, dc, sm)
    table = _slice_table(tt, 0, 50)
    imgs, theor, n_valid = tb.image_block(table)
    assert imgs.shape == (64, table.max_peaks, tds.n_pixels)
    nrows, ncols = tb.grid
    want = batch_metrics(imgs, theor, n_valid, nrows, ncols, tb.nlevels)
    assert torch.equal(torch.from_numpy(tb.score_batch(table)),
                       want[:50].double())


def _cube_vs_flat(tds, formulas, adducts, batch):
    """The port's search of ``tds`` on the flat path and on the cube path
    (``mz_chunk`` 64): the same annotations and FDR arrays, and ion by ion
    chaos bit-equal and the other components within the contracts."""
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch

    ds_dict = {"isotope_generation": {"adducts": list(adducts)}}
    out = {}
    for mz_chunk in (0, 64):
        sm, dc = configs_from_dicts(
            {"fdr": {"decoy_sample_size": 5},
             "parallel": {"formula_batch": batch, "mz_chunk": mz_chunk,
                          "isocalc_workers": 1}}, ds_dict, device="cpu")
        out[mz_chunk] = MSMBasicSearch(tds, formulas, dc, sm).search()
    flat, cube = out[0], out[64]
    pd.testing.assert_frame_equal(
        cube.annotations[["sf", "adduct", "fdr", "fdr_level"]],
        flat.annotations[["sf", "adduct", "fdr", "fdr_level"]])
    assert cube.all_metrics.sf.tolist() == flat.all_metrics.sf.tolist()
    cols = list(CONTRACT)
    a = cube.all_metrics[cols].to_numpy().astype(np.float32)
    b = flat.all_metrics[cols].to_numpy().astype(np.float32)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    for col, comp in enumerate(cols):
        assert ulp_distance(a[:, col], b[:, col]).max() <= CONTRACT[comp], comp
    assert len(cube.annotations) and (cube.annotations.msm > 0).any()


def test_cube_search_matches_flat_search(fixtures):
    from sm_distributed_tpu_torch.io.fixtures import FIXTURE_FORMULAS

    tds = fixtures("synthetic12x12")[1]
    _cube_vs_flat(tds, FIXTURE_FORMULAS, ("+H",), 64)


def test_cube_search_matches_flat_search_with_tail_batch():
    """Three adducts at a batch of 512: the flat path scores the table in a
    256-ion tail batch on the row lattice (masked moments), the cube path in
    one 512-ion batch off it (unmasked)."""
    from sm_distributed_tpu_torch.io.fixtures import (
        expand_formula_list,
        synthetic_dataset_arrays,
    )

    tds, truth = synthetic_dataset_arrays(
        20, 20, formulas=expand_formula_list(10), present_fraction=0.6,
        noise_peaks=60, seed=7)
    _cube_vs_flat(tds, truth.formulas, ("+H", "+Na", "+K"), 512)
