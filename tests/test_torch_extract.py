"""Banded flat extraction: the port's torch version is bit-equal to the JAX
package's ``extract_images_flat_banded``.

Both packages score the same dataset (rebuilt through ``convert.py``) and
the same ion table; the residents, the host plans and the (b*k, P) image
blocks must be identical — ion images are exact integer-grid sums, so no
tolerance.  Cases: the 9x11 off-lattice and the 32x32 spheroid fixtures,
lattice on and off, the ion-major plan (``inv=None``) and the un-permuted
window order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu.ops.imager_jax import (
    extract_images_flat_banded as jextract,
)
from sm_distributed_tpu_torch.convert import (
    configs_from_dicts,
    dataset_from_arrays,
    pattern_table_from_arrays,
)
from sm_distributed_tpu_torch.ops.imager import extract_images_flat_banded

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

# the JAX backends here leave XLA's persistent compilation cache off: it is
# process-global once on, and would turn later tests' compiles in the same
# worker into cache loads
NO_XLA_CACHE = "off"

FIXTURES = {
    "offgrid9x11": dict(nrows=9, ncols=11, formulas=None,
                        present_fraction=0.5, noise_peaks=12, seed=41),
    "spheroid32": dict(nrows=32, ncols=32, formulas=None,
                       present_fraction=0.6, noise_peaks=200,
                       mz_jitter_ppm=0.5, seed=7),
}


@pytest.fixture(scope="module", params=list(FIXTURES))
def fixture(request, tmp_path_factory):
    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp(request.param), **FIXTURES[request.param])
    jds = JDataset.from_imzml(path)
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig

    jt = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H", "+K")),
                        n_procs=1).pattern_table(
        [(sf, ad) for sf in truth.formulas for ad in ("+H", "+K")])
    tt = pattern_table_from_arrays(jt.sfs, jt.adducts, jt.mzs, jt.ints,
                                   jt.n_valid, jt.targets)
    return jds, tds, jt, tt


def _backends(fixture, buckets, batch):
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig

    jds, tds, _jt, _tt = fixture
    sm = {"backend": "jax_tpu",
          "parallel": {"formula_batch": batch, "shape_buckets": buckets,
                       "compile_cache_dir": NO_XLA_CACHE}}
    ds = {"isotope_generation": {"adducts": ["+H", "+K"]}}
    jb = JaxBackend(jds, DSConfig.from_dict(ds), SMConfig.from_dict(sm))
    tsm, tdc = configs_from_dicts(sm, ds, device="cpu")
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    return jb, TorchBackend(tds, tdc, tsm)


@pytest.mark.parametrize("buckets", ["auto", "off"])
@pytest.mark.parametrize("ordered", [False, True], ids=["inv_none", "inv"])
def test_extraction_bit_equal(fixture, buckets, ordered):
    from sm_distributed_tpu.models.msm_basic import _slice_table

    jb, tb = _backends(fixture, buckets, 64)
    np.testing.assert_array_equal(tb._mz_host, jb._mz_host)
    np.testing.assert_array_equal(tb._px_s.numpy(), np.asarray(jb._px_s))
    np.testing.assert_array_equal(tb._in_s.numpy(), np.asarray(jb._in_s))
    assert tb._n_pix_b == jb._n_pix_b and tb.batch == jb.batch
    _jds, _tds, jt, _tt = fixture
    for s in range(0, jt.n_ions, jb.batch):
        t = _slice_table(jt, s, min(s + jb.batch, jt.n_ions))
        jplan = jb._flat_plan(t)
        tplan = tb._flat_plan(t)
        for a, b in zip(jplan[:5], tplan[:5]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jplan[5], tplan[5]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jplan[6], tplan[6])
        assert jplan[8] == tplan[7]
        starts, r_lo_loc, r_hi_loc, inv, gc, _order = tplan[5]
        if ordered:
            # the window-major un-permutation of the generic extraction
            w = np.arange(r_lo_loc.size, dtype=np.int32)[::-1].copy()
            jinv, tinv = w, torch.from_numpy(w.astype(np.int64))
        else:
            jinv, tinv = None, None
        want = np.asarray(jextract(
            jb._px_s, jb._in_s, jplan[6], starts, r_lo_loc, r_hi_loc, jinv,
            gc_width=gc, n_pixels=jb._n_pix_b))
        got = extract_images_flat_banded(
            tb._px_s, tb._in_s, torch.from_numpy(tplan[6].astype(np.int64)),
            starts, torch.from_numpy(r_lo_loc), torch.from_numpy(r_hi_loc),
            tinv, gc_width=gc, n_pixels=tb._n_pix_b).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert got.any()


def test_wider_band_is_bit_equal(fixture):
    """A sticky band wider than the plan's own (the stream max) changes no
    image bit: out-of-band bins have zero membership."""
    _jb, tb = _backends(fixture, "auto", 64)
    _jds, _tds, _jt, tt = fixture
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    t = _slice_table(tt, 0, min(64, tt.n_ions))
    plan = tb._flat_plan(t)
    starts, r_lo_loc, r_hi_loc, _inv, gc, _order = plan[5]
    pos = torch.from_numpy(plan[6].astype(np.int64))
    args = (tb._px_s, tb._in_s, pos, starts, torch.from_numpy(r_lo_loc),
            torch.from_numpy(r_hi_loc), None)
    a = extract_images_flat_banded(*args, gc_width=gc, n_pixels=tb._n_pix_b)
    b = extract_images_flat_banded(*args, gc_width=4 * gc,
                                   n_pixels=tb._n_pix_b)
    assert torch.equal(a, b)
