"""Residency, device leases and the search's service hooks, on the CPU.

- a warm job (the same dataset and ions, a shared ``DatasetResidency``)
  skips the parse and the backend set-up and stores the same results,
  exactly;
- a resident backend whose device met a sticky fault is evicted, so the
  next job sets up a fresh one; the OOM backoff still converges with a
  resident backend and gives the same bits;
- a lease of chip ``i`` is ``cuda:i``; more than one chip raises;
- the first-annotation observers fire once a search and the provisional
  annotations over the first scored group equal the JAX package's (the
  numpy oracles of both packages, exactly).
"""

from __future__ import annotations

import pandas as pd
import pytest
import torch

from sm_distributed_tpu_torch.engine import search_job as sj_mod
from sm_distributed_tpu_torch.engine.residency import DatasetResidency
from sm_distributed_tpu_torch.engine.search_job import SearchJob
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.models import breaker, faults, msm_basic, oom
from sm_distributed_tpu_torch.models import msm_torch
from sm_distributed_tpu_torch.utils import failpoints
from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DS = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    breaker.reset_device_breaker()
    oom.reset()
    faults.reset()
    failpoints.reset()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("res_ds"), nrows=8, ncols=8,
        present_fraction=0.5, noise_peaks=30, seed=11)
    return path, truth.formulas[:5]


def _sm(tmp, **parallel) -> SMConfig:
    return SMConfig.from_dict({
        "device": "cpu", "work_dir": str(tmp / "work"),
        "fdr": {"decoy_sample_size": 2, "seed": 1},
        "parallel": {"isocalc_workers": 1, **parallel},
        "storage": {"results_dir": str(tmp / "res")}})


@pytest.fixture
def counted(monkeypatch):
    """Count parses and backend set-ups."""
    calls = {"parse": 0, "setup": 0}
    real_parse = sj_mod.SpectralDataset.from_imzml
    real_init = msm_torch.TorchBackend.__init__

    def parse(path):
        calls["parse"] += 1
        return real_parse(path)

    def init(self, *a, **kw):
        calls["setup"] += 1
        real_init(self, *a, **kw)

    monkeypatch.setattr(sj_mod.SpectralDataset, "from_imzml",
                        staticmethod(parse))
    monkeypatch.setattr(msm_torch.TorchBackend, "__init__", init)
    return calls


def _job(path, formulas, sm, residency, ds_id="res1"):
    return SearchJob(ds_id, "res", path, DS, sm, formulas=formulas,
                     residency=residency)


def test_warm_job_skips_parse_and_setup(dataset, tmp_path, counted):
    path, formulas = dataset
    sm = _sm(tmp_path)
    residency = DatasetResidency(max_datasets=2, max_backends=2)
    cold = _job(path, formulas, sm, residency).run()
    assert counted == {"parse": 1, "setup": 1}
    warm = _job(path, formulas, sm, residency).run()
    assert counted == {"parse": 1, "setup": 1}
    assert residency.stats == {"dataset_hits": 1, "dataset_misses": 1,
                               "backend_hits": 1, "backend_misses": 1}
    pd.testing.assert_frame_equal(warm.annotations, cold.annotations,
                                  check_exact=True)
    pd.testing.assert_frame_equal(warm.all_metrics, cold.all_metrics,
                                  check_exact=True)
    # another ion table is another backend: set up afresh
    _job(path, formulas[:3], sm, residency).run()
    assert counted == {"parse": 1, "setup": 2}


def test_sticky_fault_evicts_the_resident_backend(dataset, tmp_path,
                                                  counted):
    path, formulas = dataset
    sm = _sm(tmp_path)
    residency = DatasetResidency(max_datasets=2, max_backends=2)
    want = _job(path, formulas, sm, residency).run()
    failpoints.configure("backend.chip_fault=raise:RuntimeError@1")
    with pytest.raises(RuntimeError, match="backend.chip_fault"):
        _job(path, formulas, sm, residency).run()
    failpoints.reset()
    assert residency.stats["backend_hits"] == 1
    got = _job(path, formulas, sm, residency).run()
    assert counted["setup"] == 2       # the faulted backend was not reused
    assert residency.stats["backend_misses"] == 2
    pd.testing.assert_frame_equal(got.annotations, want.annotations,
                                  check_exact=True)


def test_oom_backoff_converges_with_a_resident_backend(dataset, tmp_path,
                                                       counted):
    path, formulas = dataset
    want = _job(path, formulas, _sm(tmp_path / "ref"), None).run()
    sm = _sm(tmp_path, formula_batch=8)
    residency = DatasetResidency(max_datasets=2, max_backends=2)
    failpoints.configure("backend.device_error=raise:MemoryError@1")
    got = _job(path, formulas, sm, residency).run()
    failpoints.reset()
    snap = oom.snapshot()
    assert snap["events"] == 1 and snap["recoveries"] == 1
    # the next job starts at the learned batch, a new checkpoint partition
    # and so a new backend key: set up once more, then resident
    again = _job(path, formulas, sm, residency).run()
    warm = _job(path, formulas, sm, residency).run()
    assert residency.stats["backend_misses"] == 2
    assert residency.stats["backend_hits"] == 1
    for bundle in (got, again, warm):
        pd.testing.assert_frame_equal(bundle.annotations, want.annotations,
                                      check_exact=True)
    assert breaker.get_device_breaker().state == breaker.STATE_CLOSED


def test_lease_device():
    assert msm_basic.lease_device("cuda", None) == "cuda"
    assert msm_basic.lease_device("cuda", (3,)) == "cuda:3"
    assert msm_basic.lease_device("cuda:0", (1,)) == "cuda:1"
    assert msm_basic.lease_device("cpu", (2,)) == "cpu"
    # a lease of several chips keys the residency by all of them (a mesh)
    assert msm_basic.lease_device("cuda", (0, 1)) == ("cuda:0", "cuda:1")
    assert msm_basic.lease_device("cpu", (0, 1)) == ("cpu", "cpu")


def test_first_annotation_and_partials_match_jax(dataset):
    """With checkpoint groups of one batch, the first group's provisional
    annotations reach the observer, and they equal the JAX package's for
    the same search on the numpy oracles."""
    from sm_distributed_tpu.io.dataset import SpectralDataset as JDS
    from sm_distributed_tpu.models import msm_basic as jmsm
    from sm_distributed_tpu.utils.config import DSConfig as JDSConfig
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    from sm_distributed_tpu_torch.io.dataset import SpectralDataset

    path, formulas = dataset
    cfg = {"backend": "numpy_ref",
           "fdr": {"decoy_sample_size": 2, "seed": 1},
           "parallel": {"formula_batch": 4, "isocalc_workers": 1,
                        "overlap_isocalc": "off"}}
    got: dict = {}
    for name, mod, ds, sm, dsc in (
            ("torch", msm_basic, SpectralDataset.from_imzml(path),
             SMConfig.from_dict({**cfg, "device": "cpu"}), DS),
            ("jax", jmsm, JDS.from_imzml(path), JSMConfig.from_dict(cfg),
             JDSConfig.from_dict({"isotope_generation":
                                  {"adducts": ["+H"]}}))):
        partials, firsts = [], []

        def first(firsts=firsts):
            firsts.append(1)

        mod.add_first_annotation_observer(first)
        try:
            mod.MSMBasicSearch(ds, formulas, dsc, sm,
                               partial_observer=partials.append).search()
        finally:
            mod.remove_first_annotation_observer(first)
        got[name] = (partials, len(firsts))
    assert got["torch"] == got["jax"]
    partials, n_first = got["torch"]
    assert n_first == 1
    assert len(partials) == 1 and partials[0]["provisional"]
    assert partials[0]["n_scored"] == 4


def test_residency_under_concurrent_workers():
    """More threads than cores hit one residency with a short switch
    interval: every call is counted once as a hit or a miss, a key's
    concurrent builders converge on one value, and evictions never lose
    the LRU's bound."""
    import sys
    import threading

    residency = DatasetResidency(max_datasets=3, max_backends=3)
    calls, errors = [0], []
    lock = threading.Lock()

    def worker(seed: int):
        try:
            for i in range(300):
                key = ("ds", (seed + i) % 5)
                a = residency.dataset(key, lambda k=key: k)
                b = residency.backend(key, lambda k=key: k)
                assert a == key and b == key
                if i % 7 == 0:
                    residency.evict_backend(key)
                with lock:
                    calls[0] += 1
        except BaseException as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    st = residency.stats
    assert st["dataset_hits"] + st["dataset_misses"] == calls[0] == 16 * 300
    assert st["backend_hits"] + st["backend_misses"] == calls[0]
    assert len(residency._datasets.data) <= 3
    assert len(residency._backends.data) <= 3
