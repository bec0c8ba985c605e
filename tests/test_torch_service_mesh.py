"""Leases of several chips in the port's service: a job scores on a mesh
over its lease (``parallel/sharded.py``), and each leased chip has its own
breaker (``models/breaker.py``), as in the JAX package.

On ``device: cpu`` with a simulated pool of 4 chips:

- a ``devices: 2`` job (and, with ``service.devices_per_job: 2``, a job
  that names no count) scores through ``ShardedTorchBackend`` over a 2x1
  mesh, its stored results bit-equal to a 1-chip job's;
- on a 2-chip lease a sticky fault opens both chips' breakers; a later
  lease of chips 2-3 scores, one of chips 0-1 is refused; the same calls
  on the JAX package's ``LeaseBreaker`` give the same states."""

from __future__ import annotations

import json

import pandas as pd
import pytest
import torch

from sm_distributed_tpu_torch.io.dataset import SpectralDataset
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.models import breaker, faults, oom
from sm_distributed_tpu_torch.models.breaker import DeviceUnavailableError
from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
from sm_distributed_tpu_torch.parallel.sharded import ShardedTorchBackend
from sm_distributed_tpu_torch.service import AnnotationService
from sm_distributed_tpu_torch.utils import failpoints
from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DS_CONFIG = {"isotope_generation": {"adducts": ["+H"]}}


@pytest.fixture(autouse=True)
def _reset_port_state():
    for reset in (breaker.reset_device_breaker, oom.reset, faults.reset,
                  failpoints.reset):
        reset()
    SMConfig._instance = None
    yield
    SMConfig._instance = None
    for reset in (breaker.reset_device_breaker, oom.reset, faults.reset,
                  failpoints.reset):
        reset()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("mesh_ds"), nrows=8, ncols=8,
        present_fraction=0.5, noise_peaks=30, seed=11)
    return path, list(truth.formulas[:4])


def _sm(tmp, **service) -> dict:
    return {"device": "cpu", "work_dir": str(tmp / "work"),
            "fdr": {"decoy_sample_size": 2, "seed": 1},
            "parallel": {"isocalc_workers": 1, "formula_batch": 8},
            "storage": {"results_dir": str(tmp / "res")},
            "service": {"workers": 1, "poll_interval_s": 0.02,
                        "backoff_base_s": 0.05, "http_port": 0,
                        "device_pool_size": 4, **service}}


def _meshes_scored(monkeypatch) -> list:
    """Record the mesh shape of every sharded scoring call."""
    seen = []
    real = ShardedTorchBackend.score_batches

    def spy(self, tables, cancel=None):
        seen.append(dict(self.mesh.shape))
        return real(self, tables, cancel)

    monkeypatch.setattr(ShardedTorchBackend, "score_batches", spy)
    return seen


@pytest.mark.parametrize("how", ["submit", "devices_per_job"])
def test_two_chip_job_scores_on_a_mesh_bit_equal(dataset, tmp_path,
                                                 monkeypatch, how):
    from sm_distributed_tpu_torch.engine.daemon import annotate_callback

    path, formulas = dataset
    seen = _meshes_scored(monkeypatch)
    svc = {"devices_per_job": 2} if how == "devices_per_job" else {}
    sm = SMConfig.from_dict(_sm(tmp_path, **svc))
    assert sm.service.devices_per_job == (2 if svc else 1)
    service = AnnotationService(tmp_path / "q", annotate_callback(sm),
                                sm_config=sm, with_api=False)
    pair = {} if svc else {"devices": 2}
    for ds_id, extra in (("one", {"devices": 1}), ("two", pair)):
        service.publisher.publish({
            "ds_id": ds_id, "input_path": str(path), "formulas": formulas,
            "ds_config": DS_CONFIG, **extra})
    service.start()
    try:
        assert service.scheduler.wait_for_terminal(2, timeout_s=120.0)
    finally:
        assert service.shutdown()
    spool = tmp_path / "q" / "sm_annotate"
    assert len(list(spool.glob("done/*.json"))) == 2, \
        [json.loads(p.read_text()).get("traceback")
         for p in spool.glob("failed/*.json")]
    assert seen and all(m == {"pixels": 2, "formulas": 1} for m in seen)
    res = tmp_path / "res"
    for name in ("annotations.parquet", "all_metrics.parquet"):
        pd.testing.assert_frame_equal(
            pd.read_parquet(res / "two" / name),
            pd.read_parquet(res / "one" / name), check_exact=True)
    assert {"0", "1"} <= set(breaker.breakers_snapshot())


def _search(path, formulas, sm, devices):
    return MSMBasicSearch(SpectralDataset.from_imzml(path), formulas,
                          DSConfig.from_dict(DS_CONFIG), sm,
                          device_indices=devices)


def test_fault_on_a_two_chip_lease_opens_both_breakers(dataset, tmp_path):
    path, formulas = dataset
    sm = SMConfig.from_dict({**_sm(tmp_path, breaker_threshold=1,
                                   breaker_cooldown_s=3600.0)})
    failpoints.configure("backend.device_error=raise:RuntimeError@1")
    with pytest.raises(DeviceUnavailableError):
        _search(path, formulas, sm, (0, 1)).search()
    failpoints.configure(None)
    states = {k: v["state"] for k, v in breaker.breakers_snapshot().items()}
    assert states == {"0": "open", "1": "open"}
    other = _search(path, formulas, sm, (2, 3))
    bundle = other.search()
    assert isinstance(other.last_backend, ShardedTorchBackend)
    assert len(bundle.all_metrics) == len(other.last_table.sfs)
    with pytest.raises(DeviceUnavailableError, match="refused"):
        _search(path, formulas, sm, (0, 1)).search()
    single = _search(path, formulas, sm, (3,))
    single.search()
    assert isinstance(single.last_backend, TorchBackend)
    states = {k: v["state"] for k, v in breaker.breakers_snapshot().items()}
    assert states == {"0": "open", "1": "open", "2": "closed",
                      "3": "closed"}
    assert breaker.refused_count() == 2


def test_lease_breaker_matches_jax():
    """The scoring seam's calls, step by step, on both packages' per-chip
    registries: a failure on chips (0, 1), a success on (2, 3), admission
    of each lease, a cooldown, the half-open probe's success."""
    from sm_distributed_tpu.models import breaker as jbreaker
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    knobs = {"service": {"breaker_threshold": 1,
                         "breaker_cooldown_s": 3600.0}}
    port_cfg = SMConfig.from_dict(knobs).service
    jax_cfg = JSMConfig.from_dict(knobs).service
    jbreaker.reset_device_breaker()
    steps = [((0, 1), "allow"), ((0, 1), "fail"), ((2, 3), "allow"),
             ((2, 3), "ok"), ((0, 1), "allow"), ((1, 2), "allow"),
             ((0, 1), "cooldown"), ((0, 1), "allow"), ((0, 1), "ok"),
             ((0, 1), "allow")]
    try:
        for devices, op in steps:
            got = []
            for mod, cfg in ((breaker, port_cfg), (jbreaker, jax_cfg)):
                lb = mod.get_device_breaker(cfg, devices=devices)
                if op == "cooldown":
                    for d in devices:
                        mod.breaker_for(d).cooldown_s = 0.0
                    got.append(None)
                    continue
                got.append({"allow": lb.allow_device,
                            "fail": lb.record_failure,
                            "ok": lb.record_success}[op]())
                got[-1] = (got[-1], lb.state)
            assert got[0] == got[1], (devices, op)
            snap = {k: (v["state"], v["failures"])
                    for k, v in breaker.breakers_snapshot().items()}
            jsnap = {k: (v["state"], v["failures"])
                     for k, v in jbreaker.breakers_snapshot().items()}
            assert snap == jsnap, (devices, op)
    finally:
        jbreaker.reset_device_breaker()
