"""``TorchBackend(device="cpu")`` against ``JaxBackend`` and ``NumpyBackend``.

All three score the same dataset and ion table (carried across with
``convert.py``): targets and seeded decoys, in formula batches.

Tolerances, from ``COMPONENT_CONTRACTS`` (chaos 0, spatial 16, spectral 16,
msm 32 ulp): both f32 backends are held to them against the numpy oracle,
which computes in f64.  Against the JAX backend the port may differ by the
contract plus the JAX backend's own distance from the oracle: the two take
their f32 reductions in different orders, and on the spheroid XLA's
reduction order alone puts one ion's spatial score 24 ulp from the oracle
(the port's is 4 ulp from it).  Chaos is bit-equal everywhere, and FDR
ranks and levels are identical to both backends.  Cases: both fixtures,
the lattice on and off, the 256-ion tail batch, and a shrunk batch.
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
    "spheroid32": dict(nrows=32, ncols=32, formulas=None,
                       present_fraction=0.6, noise_peaks=200,
                       mz_jitter_ppm=0.5, seed=7),
}
ADDUCTS = ("+H", "+Na")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """name -> (name, jax dataset, ion table, fdr, assignment, oracle),
    built once per module; the oracle is the numpy backend's (f64)
    metrics of the table."""
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
            fdr = FDR(decoy_sample_size=5, target_adducts=ADDUCTS, seed=42)
            assignment = fdr.decoy_adduct_selection(truth.formulas)
            pairs, flags = assignment.all_ion_tuples(truth.formulas, ADDUCTS)
            table = IsocalcWrapper(IsotopeGenerationConfig(adducts=ADDUCTS),
                                   n_procs=2).pattern_table(pairs, flags)
            ds_cfg = DSConfig.from_dict(
                {"isotope_generation": {"adducts": list(ADDUCTS)}})
            oracle = _score(NumpyBackend(jds, ds_cfg), table, 512)
            cache[name] = (jds, table, fdr, assignment, oracle)
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


def _torch(jds, table, sm_dict, ds_dict, shrink=None):
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    tt = pattern_table_from_arrays(table.sfs, table.adducts, table.mzs,
                                   table.ints, table.n_valid, table.targets)
    sm, dc = configs_from_dicts(sm_dict, ds_dict, device="cpu")
    tb = TorchBackend(tds, dc, sm, restrict_table=tt)
    if shrink:
        tb.shrink_batch(shrink)
    return tb, tt


CASES = {
    "offgrid9x11-lattice-tail": ("offgrid9x11", "auto", 512, None),
    "offgrid9x11-nolattice-tail": ("offgrid9x11", "off", 512, None),
    "offgrid9x11-lattice-shrunk": ("offgrid9x11", "auto", 256, 100),
    "spheroid32-lattice-shrunk": ("spheroid32", "auto", 256, 100),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax_backend(fixtures, case):
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig

    name, buckets, batch, shrink = CASES[case]
    jds, table, fdr, assignment, oracle = fixtures(name)
    sm_dict = {"backend": "jax_tpu",
               "parallel": {"formula_batch": batch, "shape_buckets": buckets,
                            "compile_cache_dir": NO_XLA_CACHE}}
    ds_dict = {"isotope_generation": {"adducts": list(ADDUCTS)}}
    jb = JaxBackend(jds, DSConfig.from_dict(ds_dict),
                    SMConfig.from_dict(sm_dict), restrict_table=table)
    tb, tt = _torch(jds, table, sm_dict, ds_dict, shrink)
    if shrink:
        jb.shrink_batch(shrink)
        assert tb.batch == jb.batch < batch
    eff = tb.batch
    assert table.n_ions % eff <= 256 < eff or eff <= 256   # a tail batch
    want = _score(jb, table, eff)
    got = _score(tb, tt, eff)
    assert got.shape == want.shape == (table.n_ions, 4)
    for col, comp in enumerate(CONTRACT):
        to_oracle = ulp_distance(got[:, col], oracle[:, col])
        assert to_oracle.max() <= CONTRACT[comp], \
            f"{comp}: {to_oracle.max()} ulp from the oracle"
        jax_to_oracle = ulp_distance(want[:, col], oracle[:, col])
        to_jax = ulp_distance(got[:, col], want[:, col])
        assert (to_jax <= CONTRACT[comp] + jax_to_oracle).all(), \
            f"{comp}: {to_jax.max()} ulp from the JAX backend"
    pd.testing.assert_frame_equal(_ranks(tt, got, fdr, assignment),
                                  _ranks(table, want, fdr, assignment))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_matches_numpy_backend(fixtures, name):
    jds, table, fdr, assignment, want = fixtures(name)
    ds_dict = {"isotope_generation": {"adducts": list(ADDUCTS)}}
    tb, tt = _torch(jds, table, {"parallel": {"formula_batch": 512}},
                    ds_dict)
    got = _score(tb, tt, tb.batch)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    pd.testing.assert_frame_equal(_ranks(tt, got, fdr, assignment),
                                  _ranks(table, want, fdr, assignment))
    assert (got[:, 3] > 0).any()
