"""The port's job path on the CPU: ``SearchJob`` and the CLI end to end,
held to the golden report, to the port's library search and to the JAX
package's readers; and the device image export behind the stored images.

- ``SearchJob.run()`` (through the CLI's ``run`` and in-process) on the
  golden 32x32 spheroid (the recipe of ``scripts/make_golden_report.py``)
  stores the annotations of the golden report's ``root`` and
  ``multi_adduct`` sections: the same annotation order, metrics within
  1e-6 and the golden test's ulp contracts, identical ``fdr`` and
  ``fdr_level``;
- on the 16x16 synthetic fixture the stored frames equal the port's
  library search bit for bit, and the JAX package's ``JobLedger``,
  ``AnnotationIndex`` and ``SearchResultsStore.load_ion_images`` read the
  stored directory with equal results;
- a missing input marks the job FAILED with its traceback and leaves no
  index rows (``tests/test_engine.py``'s failure contract);
- ``TorchBackend.extract_ion_images`` is bit-equal to the JAX backend's and
  to ``ops/imager_np`` (ion images are exact integer-grid sums: no
  tolerance), lattice on and off, and past the backend's batch.
"""

from __future__ import annotations

import contextlib
import json
import logging

import numpy as np
import pandas as pd
import pytest
import torch

from scripts.make_golden_report import DS, GEN, GOLDEN_PATH, SM
from sm_distributed_tpu.analysis.numerics import ulp_distance
from sm_distributed_tpu_torch.engine.cli import main as cli_main
from sm_distributed_tpu_torch.engine.search_job import SearchJob
from sm_distributed_tpu_torch.engine.storage import (
    AnnotationIndex,
    JobLedger,
    SearchResultsStore,
)
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SECTIONS = {"root": ("+H",), "multi_adduct": ("+H", "+Na", "+K")}
CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}


@contextlib.contextmanager
def _isolated_engine_state():
    """The CLI sets the port's process-global SMConfig and adds handlers to
    the engine's logger (bound to the captured stderr of the moment):
    restore both afterwards."""
    log = logging.getLogger("sm-tpu")
    handlers, level = list(log.handlers), log.level
    SMConfig._instance = None
    try:
        yield
    finally:
        SMConfig._instance = None
        for h in log.handlers[:]:
            if h not in handlers:
                log.removeHandler(h)
                h.close()
        log.setLevel(level)


@pytest.fixture(autouse=True)
def _reset_port_config():
    with _isolated_engine_state():
        yield


def _sm(tmp, **extra) -> dict:
    """A CPU sm.json for a job under ``tmp``: the golden recipe's fdr and
    batch, the isotope patterns computed in this process."""
    d = {"device": "cpu", "work_dir": str(tmp / "work"),
         "fdr": dict(SM["fdr"]),
         "parallel": dict(SM["parallel"], isocalc_workers=1),
         "storage": {"results_dir": str(tmp / "results")}}
    d.update(extra)
    return d


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN_PATH.read_text())


@pytest.fixture(scope="module")
def spheroid(tmp_path_factory):
    return generate_synthetic_dataset(
        tmp_path_factory.mktemp("golden_job"), **GEN)


@pytest.fixture(scope="module")
def cli_results(spheroid, tmp_path_factory):
    """The golden sections through the CLI: ``import-db`` then ``run`` per
    section, one work dir (the second section's run reads the first's
    pattern shards), one results dir."""
    path, truth = spheroid
    tmp = tmp_path_factory.mktemp("golden_cli")
    (tmp / "db.csv").write_text(
        "id,name,formula\n" + "".join(f"{i},mol{i},{sf}\n"
                                      for i, sf in enumerate(truth.formulas)))
    (tmp / "sm.json").write_text(json.dumps(_sm(tmp)))
    with _isolated_engine_state():
        assert cli_main(["import-db", str(tmp / "db.csv"), "golden", "1",
                         "--sm-config", str(tmp / "sm.json")]) == 0
        for key, adducts in SECTIONS.items():
            (tmp / f"{key}.json").write_text(json.dumps({
                **DS, "database": {"name": "golden", "version": "1"},
                "isotope_generation": {"adducts": list(adducts)}}))
            SMConfig._instance = None
            assert cli_main(["run", "spheroid", str(path), "--ds-id", key,
                             "--ds-config", str(tmp / f"{key}.json"),
                             "--sm-config", str(tmp / "sm.json")]) == 0
    return tmp


def _section(golden, key):
    return golden if key == "root" else golden[key]


@pytest.mark.parametrize("key", list(SECTIONS))
def test_cli_run_stores_golden_annotations(golden, cli_results, key):
    ann = pd.read_parquet(cli_results / "results" / key /
                          "annotations.parquet")
    want = _section(golden, key)["annotations"]
    assert [(r.sf, r.adduct) for r in ann.itertuples()] == [
        (w["sf"], w["adduct"]) for w in want], "annotation ORDER drifted"
    np.testing.assert_allclose(ann.msm.to_numpy(), [w["msm"] for w in want],
                               atol=1e-6)
    np.testing.assert_array_equal(ann.fdr.to_numpy(), [w["fdr"] for w in want])
    np.testing.assert_array_equal(ann.fdr_level.to_numpy(),
                                  [w["fdr_level"] for w in want])


@pytest.mark.parametrize("key", list(SECTIONS))
def test_cli_run_stores_golden_metrics(golden, cli_results, key):
    got = pd.read_parquet(cli_results / "results" / key /
                          "all_metrics.parquet")
    got = {(r.sf, r.adduct): r for r in got.itertuples()}
    want = _section(golden, key)["all_metrics"]
    assert len(got) == len(want)
    for w in want:
        g = got[(w["sf"], w["adduct"])]
        assert bool(g.is_target) == w["is_target"]
        for col in CONTRACT:
            assert getattr(g, col) == pytest.approx(w[col], abs=1e-6)
            assert ulp_distance(getattr(g, col), w[col]) <= CONTRACT[col]


def test_cli_ledger_index_and_search(cli_results, capsys):
    """Both jobs FINISHED; the index holds each section's annotations; the
    ``search`` command prints the annotations at FDR <= 0.1; the second
    run's patterns came from the first run's shards."""
    ledger = JobLedger(cli_results / "results")
    jobs = ledger.jobs()
    assert list(jobs.status) == ["FINISHED", "FINISHED"]
    assert set(jobs.ds_id) == set(SECTIONS)
    idx = AnnotationIndex(ledger)
    for key in SECTIONS:
        ann = pd.read_parquet(cli_results / "results" / key /
                              "annotations.parquet")
        assert len(idx.search(ds_id=key)) == len(ann)
    assert list((cli_results / "work" / "isocalc_cache").glob(
        "theor_peaks_*.npz"))
    capsys.readouterr()
    assert cli_main(["search", "--ds-id", "root", "--max-fdr", "0.1",
                     "--sm-config", str(cli_results / "sm.json")]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    ann = pd.read_parquet(cli_results / "results" / "root" /
                          "annotations.parquet")
    passed = ann[ann.fdr_level <= 0.1]
    assert len(out) == 1 + len(passed) and len(passed) > 0
    rows = sorted((ln.split()[2], ln.split()[3]) for ln in out[1:])
    assert rows == sorted(zip(passed.sf, passed.adduct))


def test_cli_results_read_by_the_jax_package(cli_results):
    """The JAX package's ledger, index and image loader read the port's
    results directory: equal frames and images."""
    from sm_distributed_tpu.engine.storage import (
        AnnotationIndex as JIndex,
        JobLedger as JLedger,
        SearchResultsStore as JStore,
    )

    res = cli_results / "results"
    jl, pl = JLedger(res), JobLedger(res)
    pd.testing.assert_frame_equal(jl.jobs(), pl.jobs())
    pd.testing.assert_frame_equal(JIndex(jl).search(max_fdr_level=0.5),
                                  AnnotationIndex(pl).search(
                                      max_fdr_level=0.5))
    for key in SECTIONS:
        npz = res / key / "ion_images.npz"
        ji, jions = JStore.load_ion_images(npz)
        pi, pions = SearchResultsStore.load_ion_images(npz)
        assert jions == pions and len(pions) > 0
        np.testing.assert_array_equal(ji, pi)


def test_search_job_in_process_matches_library_search(tmp_path):
    """SearchJob on the 16x16 synthetic fixture: the stored frames equal the
    port's library search on the same dataset bit for bit; the stored
    images equal the device extraction of the annotated ions; the planted
    ions are annotated; the trace-free job records its phases."""
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch

    path, truth = generate_synthetic_dataset(
        tmp_path / "ds", nrows=16, ncols=16, present_fraction=0.5,
        noise_peaks=80, seed=11)
    sm = SMConfig.from_dict(_sm(tmp_path))
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    job = SearchJob("fx16", "fixture", path, dc, sm,
                    formulas=list(truth.formulas))
    bundle = job.run()
    assert {"stage_input", "read_dataset", "decoy_selection",
            "isotope_patterns", "backend_setup", "score", "fdr",
            "store_results"} <= set(bundle.timings)
    res = tmp_path / "results" / "fx16"
    ds = SpectralDataset.from_imzml(path)
    want = MSMBasicSearch(ds, list(truth.formulas), dc, sm).search()
    pd.testing.assert_frame_equal(pd.read_parquet(res / "annotations.parquet"),
                                  want.annotations.reset_index(drop=True),
                                  check_exact=True)
    pd.testing.assert_frame_equal(pd.read_parquet(res / "all_metrics.parquet"),
                                  want.all_metrics.reset_index(drop=True),
                                  check_exact=True)
    hits = set(want.annotations[want.annotations.fdr_level <= 0.1].sf)
    assert {str(s) for s in truth.present} <= hits
    assert JobLedger(tmp_path / "results").jobs("fx16").status.tolist() == [
        "FINISHED"]
    assert job.last_hbm["hbm_peak_bytes"] is None     # no CUDA device here
    imgs, ions = SearchResultsStore.load_ion_images(res / "ion_images.npz")
    keep = want.annotations[want.annotations.fdr_level <= 0.5]
    assert sorted(ions) == sorted(zip(keep.sf, keep.adduct))
    assert imgs.shape[2:] == (16, 16) and imgs.any()


def test_missing_input_fails_job_and_leaves_no_index_rows(tmp_path):
    sm = SMConfig.from_dict(_sm(tmp_path))
    job = SearchJob("bad", "bad", tmp_path / "missing.imzML", DSConfig(), sm,
                    formulas=["C6H12O6"])
    with pytest.raises(FileNotFoundError):
        job.run(clean=True)
    jobs = JobLedger(tmp_path / "results").jobs("bad")
    assert jobs.status.tolist() == ["FAILED"]
    assert "Traceback" in jobs.error[0] and "missing.imzML" in jobs.error[0]
    assert AnnotationIndex(job.ledger).search(ds_id="bad").empty
    assert job.work_dir.path.exists()      # kept for the rerun


def test_cancelled_job_stores_nothing(tmp_path):
    from sm_distributed_tpu_torch.utils.cancel import (
        CancelToken,
        JobCancelledError,
    )

    path, truth = generate_synthetic_dataset(
        tmp_path / "ds", nrows=6, ncols=7, present_fraction=0.5,
        noise_peaks=5, seed=3)
    token = CancelToken()
    token.cancel("user")
    job = SearchJob("c", "c", path, DSConfig(), SMConfig.from_dict(
        _sm(tmp_path)), formulas=list(truth.formulas)[:4], cancel=token)
    with pytest.raises(JobCancelledError):
        job.run()
    assert JobLedger(tmp_path / "results").jobs("c").status.tolist() == [
        "FAILED"]
    assert not (tmp_path / "results" / "c" / "annotations.parquet").exists()


def test_png_images_and_profile(tmp_path):
    """``image_format="png"`` writes every isotope-peak image of the
    annotated ions; ``profile_dir`` writes a torch.profiler trace."""
    pytest.importorskip("PIL")
    path, truth = generate_synthetic_dataset(
        tmp_path / "ds", nrows=8, ncols=8, present_fraction=0.5,
        noise_peaks=10, seed=5)
    sm = SMConfig.from_dict(_sm(tmp_path, storage={
        "results_dir": str(tmp_path / "results"), "image_format": "png"}))
    job = SearchJob("p", "p", path, DSConfig.from_dict(
        {"isotope_generation": {"adducts": ["+H"]}}), sm,
        formulas=list(truth.formulas)[:10], profile_dir=str(tmp_path / "prof"))
    bundle = job.run()
    keep = bundle.annotations[bundle.annotations.fdr_level <= 0.5]
    pngs = list((tmp_path / "results" / "p" / "ion_images").glob("*.png"))
    assert len(pngs) == 4 * len(keep) > 0
    assert list((tmp_path / "prof").glob("*.json"))


# ----------------------------------------------------- device image export
@pytest.fixture(scope="module")
def spheroid_tables(spheroid):
    """The spheroid as both packages' datasets and a +H/+K ion table."""
    from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig
    from sm_distributed_tpu_torch.convert import (
        dataset_from_arrays,
        pattern_table_from_arrays,
    )

    path, truth = spheroid
    jds = JDataset.from_imzml(path)
    jt = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H", "+K")),
                        n_procs=1).pattern_table(
        [(sf, ad) for sf in truth.formulas for ad in ("+H", "+K")])
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    tt = pattern_table_from_arrays(jt.sfs, jt.adducts, jt.mzs, jt.ints,
                                   jt.n_valid, jt.targets)
    return jds, jt, tds, tt


@pytest.mark.parametrize("buckets,batch", [("auto", 256), ("off", 256),
                                           ("auto", 64)])
def test_extract_ion_images_matches_jax_and_numpy(spheroid_tables, buckets,
                                                  batch):
    """On and off the lattice, and with more ions than the batch (extracted
    batch by batch): bit-equal to the JAX backend's export and to the numpy
    extraction."""
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.ops.imager_np import (
        SortedPeakView,
        extract_ion_images,
    )
    from sm_distributed_tpu.utils.config import DSConfig as JDS
    from sm_distributed_tpu.utils.config import SMConfig as JSM
    from sm_distributed_tpu_torch.convert import configs_from_dicts
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    jds, jt, tds, tt = spheroid_tables
    ds_dict = {"isotope_generation": {"adducts": ["+H", "+K"]}}
    sm_dict = {"backend": "jax_tpu",
               "parallel": {"formula_batch": batch, "shape_buckets": buckets,
                            "compile_cache_dir": "off"}}
    sm, dc = configs_from_dicts(sm_dict, ds_dict, device="cpu")
    got = TorchBackend(tds, dc, sm, restrict_table=tt).extract_ion_images(tt)
    assert got.shape == (tt.n_ions, tt.max_peaks, jds.n_pixels)
    assert got.dtype == np.float32 and got.any()
    jb = JaxBackend(jds, JDS.from_dict(ds_dict), JSM.from_dict(sm_dict),
                    restrict_table=jt)
    np.testing.assert_array_equal(got, jb.extract_ion_images(jt))
    view = SortedPeakView.prepare(jds, 3.0)
    np.testing.assert_array_equal(got, np.asarray(
        extract_ion_images(view, jt, 3.0), np.float32))
