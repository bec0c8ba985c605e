"""A mesh spanning processes (``parallel/mesh.py``, ``sharded.py``,
``distributed.py``), against the single-process port and the JAX package.

Two REAL processes (``tests/torch_distributed_worker.py ... pod``) bring a
gloo group up under the launch contract; each stands for 4 CPU devices of
a 4x2 mesh over 8, the shape of the JAX package's
``tests/test_distributed.py::test_two_process_distributed_real`` (the 8x8
fixture, seed 17, 30 noise peaks, ``formula_batch`` 8).  Images are exact
integers on the grid and collectives copy bytes, so:

- both processes' metric rows are BIT-EQUAL to each other, to the port's
  single-process 4x2 mesh and to ``TorchBackend(cpu)``, and within
  ``COMPONENT_CONTRACTS`` of ``ShardedJaxBackend`` on the conftest's 8
  virtual CPU devices beyond its own distance from the numpy oracle, with
  chaos bit-equal;
- ``extract_ion_images`` in both equals ``ops/imager_np``;
- a checkpointed search killed at its third group in both, whose process 1
  then drops its last shard, resumes from the agreed group and ends equal
  to the uninterrupted search and to the single-device one;
- a fault in one process alone ends the other with an error: at once when
  the faulty process exits, at the group's timeout while it stays alive.

And without processes: the cross-process lease mapping against the JAX
package's, the transport rule, the pod's chip order from the config, and a
process holding only its own pixel shards' rows.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from sm_distributed_tpu.analysis.numerics import (
    COMPONENT_CONTRACTS,
    ulp_distance,
)
from sm_distributed_tpu_torch.parallel import distributed
from sm_distributed_tpu_torch.parallel import mesh as pmesh
from sm_distributed_tpu_torch.parallel.mesh import RemoteChip

torch.set_num_threads(1)

WORKER = Path(__file__).parent / "torch_distributed_worker.py"
ENV_KEYS = ("SM_COORDINATOR", "SM_NUM_PROCESSES", "SM_PROCESS_ID",
            "SM_DIST_SIMULATE", "SM_HOST_NAME", "SM_FAILPOINTS")
COLUMNS = ["chaos", "spatial", "spectral", "msm"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(out: Path, mode: str, imzml: Path, formulas: Path) -> None:
    """Both worker processes of ``mode`` to their ends (150 s each)."""
    env = {**{k: v for k, v in os.environ.items() if k not in ENV_KEYS},
           "SM_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "SM_NUM_PROCESSES": "2", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(out), mode, str(imzml),
         str(formulas)],
        env={**env, "SM_PROCESS_ID": str(rank)}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=150)
            outs.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{mode} worker {rank}:\n{text[-4000:]}"


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    """The fixture's imzML and formulas, the pod workers' results, and the
    single-process references: (dir, results by rank, port dataset, port
    table, JAX dataset, JAX table)."""
    import sys as _sys

    from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
    from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu.ops.fdr import FDR as JFDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper as JIsocalc
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.utils.config import DSConfig

    out = tmp_path_factory.mktemp("pod")
    imzml, truth = generate_synthetic_dataset(
        out / "ds", nrows=8, ncols=8, formulas=None, present_fraction=0.5,
        noise_peaks=30, seed=17)
    formulas = list(truth.formulas)[:8]
    (out / "formulas.json").write_text(json.dumps(formulas))
    _run_pair(out, "pod", imzml, out / "formulas.json")
    res = [json.loads((out / f"pod_p{r}.json").read_text()) for r in (0, 1)]

    _sys.path.insert(0, str(WORKER.parent))
    import torch_distributed_worker as w

    tds = SpectralDataset.from_imzml(imzml)
    tt = w.pod_table(formulas, DSConfig.from_dict(w.POD_DS))
    jfdr = JFDR(decoy_sample_size=3, target_adducts=("+H",), seed=5)
    pairs, flags = jfdr.decoy_adduct_selection(formulas).all_ion_tuples(
        formulas, ("+H",))
    jt = JIsocalc(IsotopeGenerationConfig(adducts=("+H",)),
                  n_procs=1).pattern_table(pairs, flags)
    assert list(jt.sfs) == list(tt.sfs) and \
        list(jt.adducts) == list(tt.adducts)
    return out, res, tds, tt, JDataset.from_imzml(imzml), jt, formulas


def _scores(backend, table, batch: int) -> np.ndarray:
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    return np.concatenate(backend.score_batches(
        [_slice_table(table, s, min(s + batch, table.n_ions))
         for s in range(0, table.n_ions, batch)]))


def _load(out: Path, what: str) -> list[np.ndarray]:
    return [np.load(out / f"pod_{what}_p{r}.npy") for r in (0, 1)]


# ----------------------------------------------------------- the pod's run
def test_pod_cells_residents_and_transport(pod_run):
    """Process r drives pixel shards 2r and 2r+1 of both formula shards,
    holds only their resident rows, and moves device tensors over gloo
    (the CPU); every batch's shuffle crosses the processes."""
    _out, res, *_ = pod_run
    for r, got in enumerate(res):
        assert (got["rank"], got["size"], got["collective"]) == \
            (r, 2, "gloo")
        assert sorted(map(tuple, got["cells"])) == sorted(
            (s, f) for s in (2 * r, 2 * r + 1) for f in (0, 1))
        assert got["resident_shards"] == [2 * r, 2 * r + 1]
        assert got["cross_bytes"] > 0 and got["n_batches"] == 4


def test_pod_rows_bit_equal_to_the_single_process_mesh_and_device(pod_run):
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.parallel.sharded import (
        ShardedTorchBackend,
        make_torch_backend,
    )
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    out, res, tds, tt, *_ = pod_run
    import torch_distributed_worker as w

    sm, dc = SMConfig.from_dict(w.POD_SM), DSConfig.from_dict(w.POD_DS)
    first, scores = _load(out, "batch"), _load(out, "scores")
    np.testing.assert_array_equal(first[0], first[1])
    np.testing.assert_array_equal(scores[0], scores[1])
    mesh = make_torch_backend(tds, dc, sm, restrict_table=tt,
                              devices=[torch.device("cpu")] * 8)
    assert isinstance(mesh, ShardedTorchBackend) and \
        not mesh.spans_processes and mesh.batch == res[0]["batch"]
    np.testing.assert_array_equal(
        mesh.score_batch(_slice_table(tt, 0, mesh.batch)), first[0])
    np.testing.assert_array_equal(_scores(mesh, tt, mesh.batch), scores[0])
    single = TorchBackend(tds, dc, sm, restrict_table=tt,
                          device=torch.device("cpu"))
    np.testing.assert_array_equal(_scores(single, tt, mesh.batch),
                                  scores[0])


def test_pod_rows_within_contracts_of_sharded_jax(pod_run):
    from sm_distributed_tpu.models.msm_basic import NumpyBackend
    from sm_distributed_tpu.parallel.mesh import make_mesh as jmake
    from sm_distributed_tpu.parallel.sharded import ShardedJaxBackend
    from sm_distributed_tpu.utils.config import DSConfig as JDSConfig
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    out, res, _tds, _tt, jds, jt, _f = pod_run
    import torch_distributed_worker as w

    jsm = JSMConfig.from_dict({
        "backend": "jax_tpu",
        "parallel": {"formula_batch": 8, "pixels_axis": 4,
                     "formulas_axis": 2, "compile_cache_dir": "off"}})
    jdc = JDSConfig.from_dict(w.POD_DS)
    jb = ShardedJaxBackend(jds, jdc, jsm, mesh=jmake(jsm.parallel),
                           restrict_table=jt)
    assert jb.batch == res[0]["batch"]
    want = _scores(jb, jt, jb.batch)
    oracle = _scores(NumpyBackend(jds, jdc), jt, jb.batch)
    for got in _load(out, "scores"):
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        for col, comp in enumerate(COLUMNS):
            gap = ulp_distance(got[:, col], want[:, col])
            allowed = COMPONENT_CONTRACTS[comp] + ulp_distance(
                want[:, col], oracle[:, col])
            assert (gap <= allowed).all(), \
                f"{comp}: {gap.max()} ulp from ShardedJaxBackend"


def test_pod_ion_images_equal_numpy_in_both_processes(pod_run):
    from sm_distributed_tpu_torch.ops.imager_np import (
        SortedPeakView,
        extract_ion_images,
    )

    out, _res, tds, tt, *_ = pod_run
    want = extract_ion_images(SortedPeakView.prepare(tds, 3.0), tt, 3.0)
    for got in _load(out, "images"):
        np.testing.assert_array_equal(got, want)


def test_pod_checkpoint_resume_agrees_and_ends_equal(pod_run):
    """Durable groups 2 and 1: both processes resume from group 1, and
    their searches (held in the workers to the uninterrupted pod search)
    equal the single-device search bit for bit."""
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    out, res, tds, _tt, _jds, _jt, formulas = pod_run
    import torch_distributed_worker as w

    assert res[0]["resume"] == [[2, 1]] and res[1]["resume"] == [[1, 1]]
    m0, m1 = _load(out, "metrics")
    np.testing.assert_array_equal(m0, m1)
    one = {**w.POD_SM, "parallel": {**w.POD_SM["parallel"],
                                    "pixels_axis": -1, "formulas_axis": 1}}
    want = MSMBasicSearch(tds, formulas, DSConfig.from_dict(w.POD_DS),
                          SMConfig.from_dict(one)).search()
    np.testing.assert_array_equal(m0, want.all_metrics[COLUMNS].to_numpy())


def test_pod_one_sided_fault_ends_the_other_process(pod_run):
    """Process 1 raises alone and exits: process 0's collective fails on
    the closed peer, an error and not a hang."""
    _out, res, *_ = pod_run
    assert "device.score_batch" in res[1]["one_sided"]
    assert res[0]["one_sided"] and res[0]["one_sided"].startswith(
        "RuntimeError"), res[0]["one_sided"]
    assert res[0]["one_sided_s"] < 60


def test_pod_one_sided_fault_waits_out_the_group_timeout(pod_run):
    """Process 1 raises alone and stays alive with its group open:
    process 0 fails at the group's timeout (cut to 10 s here)."""
    out, *_ = pod_run
    import torch_distributed_worker as w

    stall = out / "stall"
    stall.mkdir()
    _run_pair(stall, "pod-stall", next((out / "ds").glob("*.imzML")),
              out / "formulas.json")
    res = [json.loads((stall / f"stall_p{r}.json").read_text())
           for r in (0, 1)]
    assert "device.score_batch" in res[1]["one_sided"]
    assert "Timed out" in res[0]["one_sided"], res[0]
    assert w.STALL_TIMEOUT_S * 0.9 <= res[0]["one_sided_s"] < 60


# ------------------------------------------------------------ no processes
@pytest.mark.parametrize("cards,want", [
    ([("a",), ("b",)], "nccl"),
    ([("a", "b"), ("c", "d")], "nccl"),
    ([("a",), ("a",)], "gloo"),
    ([("a", "b"), ("b", "c")], "gloo"),
    ([(), ()], "gloo"),
    ([("a",), ()], "gloo")])
def test_transport_rule(cards, want):
    """NCCL only when every process has cards and none is shared."""
    assert distributed.transport_for(cards) == want


def _pod(monkeypatch, rank: int, cards) -> None:
    monkeypatch.setattr(distributed, "world", lambda: (rank, len(cards)))
    monkeypatch.setattr(distributed, "_pod", distributed.Pod(
        tuple(map(tuple, cards)), distributed.transport_for(cards)))


def test_config_devices_span_the_pod_past_this_process_cards(monkeypatch):
    """Axes asking for more cards than this process has take the pod's
    host-major order; axes it can serve stay on its own cards."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    _pod(monkeypatch, 1, [("a", "b"), ("c", "d")])
    cfg = types.SimpleNamespace(pixels_axis=2, formulas_axis=2)
    assert pmesh.config_devices("cuda", cfg) == [
        RemoteChip(0, 0), RemoteChip(0, 1), torch.device("cuda", 0),
        torch.device("cuda", 1)]
    cfg = types.SimpleNamespace(pixels_axis=2, formulas_axis=1)
    assert pmesh.config_devices("cuda", cfg) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = pmesh.make_mesh(types.SimpleNamespace(pixels_axis=2,
                                                 formulas_axis=2),
                           devices=pmesh.pod_devices(
                               [torch.device("cuda", 0)] * 2, [2, 2]))
    assert mesh.spans_processes() and mesh.local() == [(1, 0), (1, 1)]
    assert [mesh.owner(s, f) for s in (0, 1) for f in (0, 1)] == \
        [0, 0, 1, 1]


def test_remote_chips_sort_as_jax_devices():
    from sm_distributed_tpu.parallel.mesh import global_device_order as jord

    chips = [RemoteChip(p, p * 3 + i) for p in (2, 0, 1) for i in (2, 0, 1)]
    assert pmesh.global_device_order(chips) == jord(chips)
    assert [c.id for c in pmesh.global_device_order(chips)] == list(range(9))


@pytest.fixture
def small():
    """A 6x8 dataset and its ion table, port objects."""
    from sm_distributed_tpu_torch.io.fixtures import synthetic_dataset_arrays
    from sm_distributed_tpu_torch.ops.fdr import FDR
    from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu_torch.utils.config import DSConfig

    ds, truth = synthetic_dataset_arrays(6, 8, noise_peaks=10, seed=3)
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    formulas = list(truth.formulas)[:4]
    fdr = FDR(decoy_sample_size=1, target_adducts=("+H",), seed=1)
    pairs, flags = fdr.decoy_adduct_selection(formulas).all_ion_tuples(
        formulas, ("+H",))
    table = IsocalcWrapper(dc.isotope_generation,
                           n_procs=1).pattern_table(pairs, flags)
    return ds, dc, table


def _backend(ds, dc, rows, rank, size, monkeypatch, gathered=None):
    from sm_distributed_tpu_torch.parallel.sharded import ShardedTorchBackend
    from sm_distributed_tpu_torch.utils.config import SMConfig

    monkeypatch.setattr(distributed, "world", lambda: (rank, size))
    monkeypatch.setattr(distributed, "all_gather_object",
                        gathered or (lambda obj: [obj] * size))
    sm = SMConfig.from_dict({"device": "cpu",
                             "parallel": {"formula_batch": 8}})
    return ShardedTorchBackend(ds, dc, sm, mesh=pmesh.Mesh(rows))


def test_a_process_uploads_only_its_pixel_shards_rows(small, monkeypatch):
    ds, dc, _table = small
    cpu = torch.device("cpu")
    rows = [[cpu, cpu], [RemoteChip(1, 2), RemoteChip(1, 3)]]
    b = _backend(ds, dc, rows, 0, 2, monkeypatch)
    assert b.spans_processes and b.collective == "gloo"
    assert b.mesh.local() == [(0, 0), (0, 1)]
    assert list(b._px[0]) == [cpu] and list(b._in[0]) == [cpu]
    assert b._px[1] == {} and b._in[1] == {}
    rows = [[RemoteChip(0, 0), RemoteChip(0, 1)], [cpu, cpu]]
    b = _backend(ds, dc, rows, 1, 2, monkeypatch)
    assert b._px[0] == {} and list(b._px[1]) == [cpu]


def test_pod_backend_refuses_a_mesh_or_plan_it_cannot_share(small,
                                                            monkeypatch):
    """A mesh that leaves a process out, and processes whose meshes or
    datasets differ, raise at set-up instead of deadlocking."""
    ds, dc, _table = small
    cpu = torch.device("cpu")
    rows = [[cpu, cpu], [RemoteChip(1, 2), RemoteChip(1, 3)]]
    with pytest.raises(ValueError, match="spans all 3"):
        _backend(ds, dc, rows, 0, 3, monkeypatch)
    with pytest.raises(ValueError, match=r"processes \[1\] plan another"):
        _backend(ds, dc, rows, 0, 2, monkeypatch,
                 gathered=lambda obj: [obj, (obj[0], obj[1] * 2,
                                             *obj[2:])])


def test_an_oom_in_one_process_of_a_pod_does_not_back_off(small):
    """The OOM backoff halves the batch in place only where no other
    process's collectives depend on it."""
    from sm_distributed_tpu_torch.models import oom
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import SMConfig

    ds, dc, _table = small
    search = MSMBasicSearch(ds, ["C6H12O6"], dc,
                            SMConfig.from_dict({"device": "cpu"}))
    shrunk = []
    pod = types.SimpleNamespace(spans_processes=True,
                                shrink_batch=shrunk.append)
    local = types.SimpleNamespace(spans_processes=False,
                                  shrink_batch=shrunk.append)
    try:
        assert search._oom_backoff(pod, [(0, 8)], 0, "oom") == 0
        assert shrunk == []
        assert search._oom_backoff(local, [(0, 8)], 0, "oom") == 4
        assert shrunk == [4]
    finally:
        oom.reset()
