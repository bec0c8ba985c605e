"""Hot-spot preprocessing (``image_generation.do_preprocessing``) in the
port against the JAX package.

- ``ops/metrics.hotspot_clip_batch`` bit-equal to the JAX package's
  ``hotspot_clip_batch`` and to the numpy oracle's ``hotspot_clip`` (the
  JAX package's and the port's copy) on empty images, a single positive
  pixel, random and integer-grid images with lattice zero pads, at ``q``
  of 50, 99 and 100, whether the block is sorted whole or in ion groups;
- ``batch_metrics`` with preprocessing against the JAX function under the
  component contracts (chaos bit-equal, spatial and spectral within 16
  ulp, msm within 32);
- ``TorchBackend`` with preprocessing on the flat path (every extraction
  variant bit-equal to the plain one) and on the cube path against
  ``JaxBackend`` and the f64 numpy oracle, as in
  ``tests/test_torch_backend.py``: chaos bit-equal, the other metrics
  within the contract of the oracle and within the contract plus the JAX
  backend's own distance from it; FDR ranks identical;
- ``fused_metrics="on"`` with preprocessing takes the unfused chain and
  gives its bits;
- the golden report's ``preprocessing`` section reproduced by the port's
  search (the tolerance of ``tests/test_golden_report.py``, and the ulp
  contracts against the f64 oracle that wrote it).
"""

from __future__ import annotations

import json

import numpy as np
import pandas as pd
import pytest
import torch

from scripts.make_golden_report import DS, GEN, GOLDEN_PATH, SM
from sm_distributed_tpu.analysis.numerics import ulp_distance
from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu.models.msm_basic import _slice_table
from sm_distributed_tpu_torch.convert import (
    configs_from_dicts,
    dataset_from_arrays,
    pattern_table_from_arrays,
)
from sm_distributed_tpu_torch.ops import metrics as tmetrics

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}
ADDUCTS = ("+H", "+Na")
PRE = {"image_generation": {"ppm": 3.0, "do_preprocessing": True}}


def _images(case: str, seed: int) -> np.ndarray:
    """(n, k, P) f32 blocks: ``empty`` (all zero), ``single`` (one positive
    pixel an image), ``random`` (exponential values, ~30% zeros) and
    ``grid`` (integer-grid intensities up to 2**20, as the extraction
    emits, with lattice zero rows at the end of every image)."""
    rng = np.random.default_rng(seed)
    n, k, p = 6, 3, 120
    if case == "empty":
        return np.zeros((n, k, p), np.float32)
    if case == "single":
        imgs = np.zeros((n, k, p), np.float32)
        at = rng.integers(0, p, (n, k))
        imgs[np.arange(n)[:, None], np.arange(k)[None, :], at] = \
            rng.integers(1, 5000, (n, k))
        return imgs
    if case == "random":
        imgs = rng.exponential(1.0, (n, k, p)).astype(np.float32)
        imgs[imgs < 0.3] = 0.0
        imgs[2, 1] = 0.0
        return imgs
    imgs = rng.integers(0, 1 << 20, (n, k, p)).astype(np.float32)
    imgs *= rng.random((n, k, p)) < 0.6
    imgs[:, :, 100:] = 0.0                    # lattice zero rows
    imgs[4] = 0.0                             # a padded ion
    return imgs


@pytest.mark.parametrize("q", [50.0, 99.0, 100.0])
@pytest.mark.parametrize("case", ["empty", "single", "random", "grid"])
def test_hotspot_clip_batch_matches_jax_and_oracle(case, q):
    import jax.numpy as jnp
    from sm_distributed_tpu.ops.metrics_jax import hotspot_clip_batch as jclip
    from sm_distributed_tpu.ops.metrics_np import hotspot_clip as np_clip

    imgs = _images(case, seed=int(q))
    got = tmetrics.hotspot_clip_batch(torch.from_numpy(imgs.copy()), q)
    got = got.numpy()
    want = np.asarray(jclip(jnp.asarray(imgs), q))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    oracle = np.stack([[np_clip(im, q) for im in ion] for ion in imgs])
    copy = np.stack([[tmetrics.hotspot_clip(im, q) for im in ion]
                     for ion in imgs])
    assert oracle.dtype == copy.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32),
                                  oracle.view(np.uint32))
    np.testing.assert_array_equal(copy.view(np.uint32),
                                  oracle.view(np.uint32))
    if case in ("random", "grid"):
        assert (got < imgs).any() or q == 100.0     # something was clipped


@pytest.mark.parametrize("seed", range(3))
def test_hotspot_percentile_copy_matches_jax_oracle(seed):
    from sm_distributed_tpu.ops.metrics_np import hotspot_percentile_f32

    rng = np.random.default_rng(seed)
    for m in (1, 2, 3, 17, 1000):
        pos = np.sort(rng.integers(1, 1 << 22, m).astype(np.float32))
        for q in (0.5, 50.0, 95.0, 99.0, 99.9, 100.0):
            got = tmetrics.hotspot_percentile_f32(pos, q)
            want = hotspot_percentile_f32(pos, q)
            assert got.dtype == np.float32
            assert got.view(np.uint32) == want.view(np.uint32)


def test_hotspot_sort_groups_give_the_same_bits(monkeypatch):
    """A scratch budget of one ion sorts the block ion by ion: the same
    bits as one whole-block sort."""
    imgs = _images("grid", seed=7)
    whole = tmetrics.hotspot_clip_batch(torch.from_numpy(imgs.copy()), 99.0)
    monkeypatch.setattr(tmetrics, "HOTSPOT_SORT_BYTES", 1)
    grouped = tmetrics.hotspot_clip_batch(torch.from_numpy(imgs.copy()),
                                          99.0)
    assert torch.equal(whole, grouped)


@pytest.mark.parametrize("lattice", [False, True], ids=["plain", "lattice"])
@pytest.mark.parametrize("seed", [0, 1])
def test_batch_metrics_preprocessed_matches_jax(lattice, seed):
    from sm_distributed_tpu.ops.metrics_jax import batch_metrics as jmetrics

    n, k, nrows, ncols, nlevels = 16, 4, 10, 12, 30
    rng = np.random.default_rng(seed)
    imgs = _images("grid", seed).reshape(6, 3, 10, 12)[:, :, :, :]
    imgs = np.concatenate([imgs, imgs[:, :1]], axis=1)         # k = 4
    imgs = np.concatenate([imgs] * 3)[:n].reshape(n, k, -1)
    real = 9 * ncols if lattice else None
    if lattice:
        imgs[:, :, real:] = 0.0
    theor = rng.uniform(1, 100, (n, k)).astype(np.float32)
    n_valid = rng.integers(0, k + 1, n).astype(np.int32)
    n_valid[:2] = [k, 0]
    want = np.asarray(jmetrics(
        imgs, theor, n_valid, nrows, ncols, nlevels, do_preprocessing=True,
        q=99.0, n_real=None if real is None else np.int32(real)))
    args = (torch.from_numpy(theor), torch.from_numpy(n_valid), nrows,
            ncols, nlevels)
    got = tmetrics.batch_metrics(
        torch.from_numpy(imgs.copy()), *args, n_real=real,
        do_preprocessing=True, q=99.0).numpy()
    plain = tmetrics.batch_metrics(
        torch.from_numpy(imgs.copy()), *args, n_real=real, plain=True,
        do_preprocessing=True, q=99.0).numpy()
    unclipped = tmetrics.batch_metrics(
        torch.from_numpy(imgs.copy()), *args, n_real=real).numpy()
    np.testing.assert_array_equal(got, plain)
    assert not np.array_equal(got, unclipped)       # the clip mattered
    for col, name in enumerate(CONTRACT):
        drift = int(ulp_distance(got[:, col], want[:, col]).max())
        assert drift <= CONTRACT[name], f"{name}: {drift} ulp"
    assert (got[:, 3] > 0).any()


# ----------------------------------------------------------------- backend
@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The off-lattice 9x11 fixture with +H and +Na, 5 decoys each: the JAX
    dataset, the ion table, FDR and the numpy oracle's (f64) metrics with
    preprocessing."""
    from sm_distributed_tpu.models.msm_basic import NumpyBackend
    from sm_distributed_tpu.ops.fdr import FDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import (
        DSConfig,
        IsotopeGenerationConfig,
    )

    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("preproc"), nrows=9, ncols=11,
        formulas=None, present_fraction=0.5, noise_peaks=12, seed=41)
    jds = JDataset.from_imzml(path)
    fdr = FDR(decoy_sample_size=5, target_adducts=ADDUCTS, seed=42)
    assignment = fdr.decoy_adduct_selection(truth.formulas)
    pairs, flags = assignment.all_ion_tuples(truth.formulas, ADDUCTS)
    table = IsocalcWrapper(IsotopeGenerationConfig(adducts=ADDUCTS),
                           n_procs=1).pattern_table(pairs, flags)
    ds_dict = {**PRE, "isotope_generation": {"adducts": list(ADDUCTS)}}
    oracle = _score(NumpyBackend(jds, DSConfig.from_dict(ds_dict)), table,
                    128)
    return jds, table, fdr, assignment, ds_dict, oracle


def _score(backend, table, batch):
    return np.concatenate(backend.score_batches(
        [_slice_table(table, s, min(s + batch, table.n_ions))
         for s in range(0, table.n_ions, batch)]))


def _ranks(table, metrics, fdr, assignment):
    df = pd.DataFrame({"sf": table.sfs, "adduct": table.adducts,
                       "msm": metrics[:, 3]})
    return fdr.estimate_fdr(df, assignment)


def _jax(fixture, parallel: dict):
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig

    jds, table, _fdr, _assignment, ds_dict, _oracle = fixture
    sm = SMConfig.from_dict({"backend": "jax_tpu", "parallel": {
        "formula_batch": 128, "compile_cache_dir": "off", **parallel}})
    jb = JaxBackend(jds, DSConfig.from_dict(ds_dict), sm,
                    restrict_table=table)
    return _score(jb, table, jb.batch)


def _port(fixture, parallel: dict):
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    jds, table, _fdr, _assignment, ds_dict, _oracle = fixture
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    tt = pattern_table_from_arrays(table.sfs, table.adducts, table.mzs,
                                   table.ints, table.n_valid, table.targets)
    sm, dc = configs_from_dicts({"parallel": {"formula_batch": 128,
                                              **parallel}}, ds_dict,
                                device="cpu")
    tb = TorchBackend(tds, dc, sm, restrict_table=tt)
    return tb, _score(tb, tt, tb.batch)


def _hold_to_jax(fixture, got, want):
    _jds, table, fdr, assignment, _ds_dict, oracle = fixture
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for col, comp in enumerate(CONTRACT):
        assert ulp_distance(got[:, col], oracle[:, col]).max() \
            <= CONTRACT[comp], comp
        jax_to_oracle = ulp_distance(want[:, col], oracle[:, col])
        assert (ulp_distance(got[:, col], want[:, col])
                <= CONTRACT[comp] + jax_to_oracle).all(), comp
    pd.testing.assert_frame_equal(_ranks(table, got, fdr, assignment),
                                  _ranks(table, want, fdr, assignment))
    assert (got[:, 3] > 0).any()


@pytest.fixture(scope="module")
def flat_pair(fixture):
    """The JAX backend's and the port's plain-variant metrics with
    preprocessing."""
    off = {"band_slice": "off", "peak_compaction": "off"}
    return _jax(fixture, off), _port(fixture, off)[1]


@pytest.mark.parametrize("band,compaction", [
    ("off", "off"), ("on", "off"), ("off", "on"), ("auto", "auto")])
def test_backend_preprocessed_matches_jax(fixture, flat_pair, band,
                                          compaction):
    want, plain = flat_pair
    tb, got = _port(fixture, {"band_slice": band,
                              "peak_compaction": compaction})
    np.testing.assert_array_equal(got, plain)
    _hold_to_jax(fixture, got, want)
    if band == "on":
        assert tb.variant_counts["band"] > 0
    if compaction == "on":
        assert tb.variant_counts["compact"] > 0


def test_backend_preprocessed_fused_on_takes_the_unfused_chain(fixture,
                                                                flat_pair):
    """Preprocessing excludes the fused kernel, even under "on"."""
    _want, plain = flat_pair
    tb, got = _port(fixture, {"fused_metrics": "on", "band_slice": "off",
                              "peak_compaction": "off"})
    np.testing.assert_array_equal(got, plain)
    assert tb.variant_counts["fused"] == 0
    assert tb.variant_counts["plain"] > 0


def test_cube_path_preprocessed_matches_jax(fixture):
    want = _jax(fixture, {"mz_chunk": 64})
    _tb, got = _port(fixture, {"mz_chunk": 64})
    _hold_to_jax(fixture, got, want)


# ------------------------------------------------------------------ golden
@pytest.fixture(scope="module")
def golden_bundle(tmp_path_factory):
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.io.fixtures import (
        generate_synthetic_dataset as tgenerate,
    )
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch

    path, truth = tgenerate(tmp_path_factory.mktemp("golden_pre"), **GEN)
    ds = SpectralDataset.from_imzml(path)
    sm = dict(SM, parallel=dict(SM["parallel"], isocalc_workers=2))
    ds_cfg = {**DS, "isotope_generation": {"adducts": ["+H"]},
              "image_generation": {**DS["image_generation"],
                                   "do_preprocessing": True}}
    sm_cfg, ds_cfg = configs_from_dicts(sm, ds_cfg, device="cpu")
    return MSMBasicSearch(ds, truth.formulas, ds_cfg, sm_cfg).search()


def test_golden_preprocessing_metrics(golden_bundle):
    want = json.loads(GOLDEN_PATH.read_text())["preprocessing"]["all_metrics"]
    got = {(r.sf, r.adduct): r
           for r in golden_bundle.all_metrics.itertuples()}
    assert len(got) == len(want)
    for w in want:
        g = got[(w["sf"], w["adduct"])]
        assert bool(g.is_target) == w["is_target"]
        for col in CONTRACT:
            assert getattr(g, col) == pytest.approx(w[col], abs=1e-6), (
                f"{col} drifted for {w['sf']}{w['adduct']}")
            assert ulp_distance(getattr(g, col), w[col]) <= CONTRACT[col], (
                f"{col} past its ulp contract for {w['sf']}{w['adduct']}")


def test_golden_preprocessing_annotations(golden_bundle):
    want = json.loads(GOLDEN_PATH.read_text())["preprocessing"]["annotations"]
    ann = golden_bundle.annotations
    assert [(r.sf, r.adduct) for r in ann.itertuples()] == [
        (w["sf"], w["adduct"]) for w in want], "annotation ORDER drifted"
    np.testing.assert_allclose(ann.msm.to_numpy(), [w["msm"] for w in want],
                               atol=1e-6)
    np.testing.assert_array_equal(ann.fdr.to_numpy(), [w["fdr"] for w in want])
    np.testing.assert_array_equal(ann.fdr_level.to_numpy(),
                                  [w["fdr_level"] for w in want])
