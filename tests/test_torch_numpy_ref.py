"""The port's ``numpy_ref`` backend against the JAX package's, on the CPU.

Port copies of ``tests/test_search_numpy.py``: the extraction semantics of
``ops/imager_np.extract_ion_images`` (each also equal to the JAX
function's), the end-to-end ``numpy_ref`` search on the 16x16 synthetic
fixture — bit-equal to the JAX package's ``numpy_ref`` search, which it
overlaps with pattern generation as the JAX one does — checkpoint resume, a
stale checkpoint ignored, and determinism.  Also: the port's copies of the
numpy metrics equal to the JAX package's on random images, and the
hot-spot functions defined in one module of the port only.  Tolerance:
bit-equality throughout (the two oracles are copies).
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.convert import (
    dataset_from_arrays,
    pattern_table_from_arrays,
)
from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
from sm_distributed_tpu_torch.ops.imager_np import extract_ion_images
from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

PORT = Path(__file__).resolve().parent.parent / "sm_distributed_tpu_torch"


def _port_ds(jds):
    return dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                               jds.mzs_flat, jds.ints_flat, jds.row_ptr)


def _tiny_table(mzs, n_valid=None, targets=None):
    mzs = np.asarray(mzs, dtype=np.float64)
    n, k = mzs.shape
    return pattern_table_from_arrays(
        [f"SF{i}" for i in range(n)], ["+H"] * n, mzs,
        np.where(mzs > 0, 100.0, 0.0),
        n_valid if n_valid is not None else [k] * n,
        targets if targets is not None else [True] * n)


def _extract_both(coords, spectra, mzs, ppm, n_valid=None):
    """The port's images, after checking them equal to the JAX
    function's on the same dataset and table."""
    from sm_distributed_tpu.ops.imager_np import extract_ion_images as jext
    from sm_distributed_tpu.ops.isocalc import IsotopePatternTable

    jds = JDataset.from_arrays(np.asarray(coords), spectra)
    t = _tiny_table(mzs, n_valid)
    got = extract_ion_images(_port_ds(jds), t, ppm)
    want = jext(jds, IsotopePatternTable(
        sfs=t.sfs, adducts=t.adducts, mzs=t.mzs, ints=t.ints,
        n_valid=t.n_valid, targets=t.targets), ppm)
    np.testing.assert_array_equal(got, want)
    return got


def test_extract_exact_window_semantics():
    coords = [[1, 1], [2, 1], [1, 2], [2, 2]]
    spectra = [
        (np.array([100.0000, 200.0]), np.array([1.0, 5.0])),
        (np.array([100.0001]), np.array([2.0])),       # +1 ppm of 100
        (np.array([100.0010]), np.array([3.0])),       # +10 ppm: outside
        (np.array([], dtype=float), np.array([], dtype=float)),
    ]
    images = _extract_both(coords, spectra, [[100.0, 200.0]], 3.0)
    assert images.shape == (1, 2, 4)
    np.testing.assert_allclose(images[0, 0], [1.0, 2.0, 0.0, 0.0])
    np.testing.assert_allclose(images[0, 1], [5.0, 0.0, 0.0, 0.0])


def test_extract_sums_multiple_hits_per_pixel():
    spectra = [(np.array([99.99995, 100.0, 100.00005]),
                np.array([1.0, 2.0, 4.0]))]
    images = _extract_both([[1, 1]], spectra, [[100.0]], 1.0)
    assert images[0, 0, 0] == pytest.approx(7.0)


def test_extract_invalid_peaks_zero():
    spectra = [(np.array([100.0, 200.0]), np.array([1.0, 1.0]))]
    images = _extract_both([[1, 1]], spectra, [[100.0, 200.0]], 3.0,
                           n_valid=[1])
    assert images[0, 0, 0] == 1.0
    np.testing.assert_array_equal(images[0, 1], 0.0)


def test_extract_overlapping_windows_both_hit():
    spectra = [(np.array([100.0]), np.array([3.0]))]
    images = _extract_both([[1, 1]], spectra, [[100.00001], [99.99999]], 3.0)
    assert images[0, 0, 0] == 3.0
    assert images[1, 0, 0] == 3.0


@pytest.fixture(scope="module")
def synthetic_ds(tmp_path_factory):
    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("ds"), nrows=16, ncols=16, formulas=None,
        present_fraction=0.5, noise_peaks=80, seed=11)
    jds = JDataset.from_imzml(path)
    return jds, _port_ds(jds), truth


def test_numpy_ref_search_end_to_end(synthetic_ds):
    """The port's numpy_ref search: bit-equal to the JAX package's
    numpy_ref search of the same dataset, and the JAX test's bars on
    recall, false positives and scored decoys."""
    from sm_distributed_tpu.models.msm_basic import MSMBasicSearch as JSearch
    from sm_distributed_tpu.utils.config import DSConfig as JDC
    from sm_distributed_tpu.utils.config import SMConfig as JSC

    jds, tds, truth = synthetic_ds
    sm = {"backend": "numpy_ref", "fdr": {"decoy_sample_size": 8, "seed": 3},
          "parallel": {"formula_batch": 64}}
    dsd = {"isotope_generation": {"adducts": ["+H"]},
           "image_generation": {"ppm": 3.0}}
    search = MSMBasicSearch(tds, truth.formulas, DSConfig.from_dict(dsd),
                            SMConfig.from_dict(sm))
    bundle = search.search()
    assert search.last_backend.name == "numpy_ref"
    want = JSearch(jds, truth.formulas, JDC.from_dict(dsd),
                   JSC.from_dict(sm)).search()
    pd.testing.assert_frame_equal(bundle.annotations, want.annotations,
                                  check_exact=True)
    pd.testing.assert_frame_equal(bundle.all_metrics, want.all_metrics,
                                  check_exact=True)
    ann = bundle.annotations
    assert set(ann.adduct) == {"+H"}
    assert len(ann) == len(truth.formulas)
    present = ann[ann.sf.isin(truth.present)]
    absent = ann[~ann.sf.isin(truth.present)]
    assert (present.msm > 0.2).all(), present[["sf", "msm"]]
    acc_set = set(ann[ann.fdr_level <= 0.1].sf)
    assert len(set(truth.present) - acc_set) <= max(1, len(truth.present) // 10)
    assert len(acc_set - set(truth.present)) <= max(1, len(truth.present) // 10)
    assert present.msm.mean() > 3 * max(absent.msm.mean(), 0.01)
    assert (~bundle.all_metrics.is_target).sum() > 0


def test_search_checkpoint_resume(synthetic_ds, tmp_path, monkeypatch):
    """Kill a search mid-way; the resumed run skips the checkpointed batch
    groups and gives the uninterrupted run's results; ``finalize`` removes
    the shards and an orphaned tmp."""
    from sm_distributed_tpu_torch.models import msm_basic as mb

    _jds, tds, truth = synthetic_ds
    sm = SMConfig.from_dict(
        {"backend": "numpy_ref", "fdr": {"decoy_sample_size": 4, "seed": 5},
         "parallel": {"formula_batch": 16, "checkpoint_every": 1}})
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    sub = truth.formulas[:12]
    baseline = MSMBasicSearch(tds, sub, dc, sm).search().annotations

    orig = mb.NumpyBackend.score_batch
    calls = {"n": 0}

    def bomb(self, t):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt  # a kill after 2 batch groups
        return orig(self, t)

    monkeypatch.setattr(mb.NumpyBackend, "score_batch", bomb)
    with pytest.raises(KeyboardInterrupt):
        MSMBasicSearch(tds, sub, dc, sm, checkpoint_dir=str(tmp_path)).search()
    assert len(sorted(tmp_path.glob("msm_search.p0.g*.ckpt.npz"))) == 2

    resumed_calls = {"n": 0}

    def count(self, t):
        resumed_calls["n"] += 1
        return orig(self, t)

    monkeypatch.setattr(mb.NumpyBackend, "score_batch", count)
    job2 = MSMBasicSearch(tds, sub, dc, sm, checkpoint_dir=str(tmp_path))
    resumed = job2.search().annotations
    n_batches = -(-job2.last_table.n_ions // 16)
    assert resumed_calls["n"] == n_batches - 2
    pd.testing.assert_frame_equal(resumed, baseline)
    assert list(tmp_path.glob("msm_search.p0.g*.ckpt.npz"))
    (tmp_path / "msm_search.p0.g00099.ckpt.tmp.npz").write_bytes(b"junk")
    job2.last_checkpoint.finalize()
    assert not list(tmp_path.glob("msm_search.p0.g*"))


def test_search_checkpoint_stale_ignored(synthetic_ds, tmp_path):
    """A checkpoint of another search (another fingerprint) is not
    trusted: the search rescores cleanly."""
    from sm_distributed_tpu_torch.models.msm_basic import SearchCheckpoint

    _jds, tds, truth = synthetic_ds
    sm = SMConfig.from_dict(
        {"backend": "numpy_ref", "fdr": {"decoy_sample_size": 4, "seed": 5},
         "parallel": {"formula_batch": 16, "checkpoint_every": 1}})
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    stale = SearchCheckpoint(tmp_path, "deadbeef")
    stale.save(np.full((7, 4), 99.0), gi=0, n_groups=1, row_ranges=[(0, 7)])
    sub = truth.formulas[:6]
    ref = MSMBasicSearch(tds, sub, dc, sm).search().annotations
    got = MSMBasicSearch(tds, sub, dc, sm,
                         checkpoint_dir=str(tmp_path)).search().annotations
    pd.testing.assert_frame_equal(got, ref)


def test_search_deterministic(synthetic_ds):
    _jds, tds, truth = synthetic_ds
    sm = SMConfig.from_dict(
        {"backend": "numpy_ref", "fdr": {"decoy_sample_size": 4, "seed": 5},
         "parallel": {"formula_batch": 32}})
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    sub = truth.formulas[:10]
    r1 = MSMBasicSearch(tds, sub, dc, sm).search().annotations
    r2 = MSMBasicSearch(tds, sub, dc, sm).search().annotations
    pd.testing.assert_frame_equal(r1, r2)


@pytest.mark.parametrize("seed", range(3))
def test_numpy_metrics_match_jax(seed):
    """The copied oracle functions give the JAX package's values on random
    sparse images, with and without hot-spot clipping."""
    from sm_distributed_tpu.ops import metrics_np as jm
    from sm_distributed_tpu_torch.ops import metrics_np as tm

    rng = np.random.default_rng(seed)
    for _ in range(6):
        k, nrows, ncols = 4, 9, 11
        imgs = np.where(rng.random((k, nrows * ncols)) < 0.4,
                        np.rint(rng.random((k, nrows * ncols)) * 500), 0
                        ).astype(np.float32)
        theor = np.array([100.0, 55.0, 20.0, 4.0])
        for pre in (False, True):
            assert tm.ion_metrics(imgs, theor, 3, nrows, ncols, 30, pre,
                                  95.0) == jm.ion_metrics(
                imgs, theor, 3, nrows, ncols, 30, pre, 95.0)
        assert tm.measure_of_chaos(imgs[0].reshape(nrows, ncols), 7) == \
            jm.measure_of_chaos(imgs[0].reshape(nrows, ncols), 7)


def test_hotspot_functions_defined_in_one_module():
    """``hotspot_percentile_f32`` and ``hotspot_clip`` are defined once in
    the port (``ops/metrics_np.py``); ``ops/metrics.py`` uses that copy."""
    from sm_distributed_tpu_torch.ops import metrics, metrics_np

    defined = {}
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.FunctionDef) and node.name in (
                    "hotspot_percentile_f32", "hotspot_clip"):
                defined.setdefault(node.name, []).append(
                    str(path.relative_to(PORT)))
    assert defined == {"hotspot_percentile_f32": ["ops/metrics_np.py"],
                       "hotspot_clip": ["ops/metrics_np.py"]}
    assert metrics.hotspot_clip is metrics_np.hotspot_clip
    assert metrics.hotspot_percentile_f32 is metrics_np.hotspot_percentile_f32


def test_search_job_checkpoints_and_stores_numpy_images(tmp_path,
                                                        monkeypatch):
    """A ``SearchJob`` on ``numpy_ref`` with ``checkpoint_every``: the
    search writes its shards in the job's work dir, the job stores the
    numpy extraction's ion images (bit-equal to the device extraction of
    the same ions) and removes the shards after the results are stored."""
    from sm_distributed_tpu_torch.engine.search_job import SearchJob
    from sm_distributed_tpu_torch.engine.storage import SearchResultsStore
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.io.fixtures import (
        generate_synthetic_dataset as tgen,
    )
    from sm_distributed_tpu_torch.models import msm_basic as mb
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper

    path, truth = tgen(tmp_path / "ds", nrows=8, ncols=8,
                       present_fraction=0.5, noise_peaks=20, seed=5)
    sm = SMConfig.from_dict({
        "backend": "numpy_ref", "device": "cpu",
        "work_dir": str(tmp_path / "work"),
        "fdr": {"decoy_sample_size": 2, "seed": 1},
        "parallel": {"formula_batch": 8, "checkpoint_every": 1,
                     "isocalc_workers": 1},
        "storage": {"results_dir": str(tmp_path / "results")}})
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    saved = []
    orig = mb.SearchCheckpoint.save

    def spy(self, metrics, gi, n_groups, row_ranges):
        saved.append((self.dir, gi))
        return orig(self, metrics, gi, n_groups, row_ranges)

    monkeypatch.setattr(mb.SearchCheckpoint, "save", spy)
    job = SearchJob("np8", "np8", path, dc, sm,
                    formulas=list(truth.formulas)[:6])
    bundle = job.run()
    assert len(saved) > 1 and all(d == job.work_dir.path for d, _ in saved)
    assert not list(job.work_dir.path.glob("msm_search.p0.g*"))
    images, ions = SearchResultsStore.load_ion_images(
        tmp_path / "results" / "np8" / "ion_images.npz")
    keep = bundle.annotations[bundle.annotations.fdr_level <= 0.5]
    assert len(ions) > 0 and set(ions) == set(zip(keep.sf, keep.adduct))
    ds = SpectralDataset.from_imzml(path)
    tb = TorchBackend(ds, dc, SMConfig.from_dict(
        {"device": "cpu", "parallel": {"formula_batch": 8}}))
    table = IsocalcWrapper(dc.isotope_generation, n_procs=1).pattern_table(
        list(ions))
    want = tb.extract_ion_images(table).reshape(images.shape)
    np.testing.assert_array_equal(images, want)
