"""Worker process of the port's REAL 2-process runtime tests.

Launched by ``tests/test_torch_distributed.py`` and
``tests/test_torch_pod_mesh.py`` with ``SM_COORDINATOR``,
``SM_NUM_PROCESSES`` and ``SM_PROCESS_ID`` in the environment (the launch
contract of ``sm_distributed_tpu_torch/parallel/distributed.py``) and an
output directory as its argument.  Imports the port only (no jax).

``python torch_distributed_worker.py OUT`` (the runtime):

1. ``maybe_initialize_distributed`` through the config resolution: a gloo
   process group over a TCP rendezvous at the coordinator;
2. the process's rank, identity and a ``agree_min`` of divergent values;
3. a checkpointed search of a seeded 8x8 dataset on the CPU, killed by the
   ``device.score_batch`` failpoint before its third group in both
   processes; process 1 then drops its second shard, so the two hold 2
   and 1 durable groups; the rerun agrees on resuming from group 1
   (``MSMBasicSearch._agree_resume_point``) in both processes and finishes.

Writes ``ok_p<rank>.json`` (the figures) and ``metrics_p<rank>.npy``.

``python torch_distributed_worker.py OUT pod IMZML FORMULAS_JSON`` (a mesh
spanning both processes, the JAX package's ``tests/distributed_worker.py``
shape): each process stands for 4 CPU devices (``devices=[cpu] * 4``) of
a 4x2 mesh over 8, so pixel shards 0-1 live in process 0 and 2-3 in
process 1.

1. ``ShardedTorchBackend.score_batch`` of the first batch, then
   ``score_batches`` of the whole table, over the cross-process mesh;
2. ``extract_ion_images`` of the whole table;
3. a search, then a checkpointed search killed before its third group in
   both processes; process 1 drops its last shard; the rerun agrees on
   group 1 and ends equal to the uninterrupted search;
4. a one-sided fault: process 1 alone raises at ``device.score_batch``
   before the search's second group and exits; process 0 must end with an
   error (its collective's peer is gone), not hang.

Writes ``pod_p<rank>.json`` and ``pod_<what>_p<rank>.npy``.

``python torch_distributed_worker.py OUT pod-stall IMZML FORMULAS_JSON``:
step 4 alone, with the group's timeout cut to ``STALL_TIMEOUT_S``, and
process 1 stays alive after its fault (until process 0 has written its
result): process 0 must end with an error at the timeout.  Writes
``stall_p<rank>.json``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sm_distributed_tpu_torch.io.fixtures import synthetic_dataset_arrays  # noqa: E402
from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch  # noqa: E402
from sm_distributed_tpu_torch.parallel import distributed  # noqa: E402
from sm_distributed_tpu_torch.utils import failpoints  # noqa: E402
from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig  # noqa: E402

SM = {"device": "cpu", "fdr": {"decoy_sample_size": 2, "seed": 3},
      "parallel": {"formula_batch": 8, "checkpoint_every": 1,
                   "isocalc_workers": 1, "init_backoff_s": 0.2}}
DS = {"isotope_generation": {"adducts": ["+H"]}}

POD_SM = {"device": "cpu", "fdr": {"decoy_sample_size": 3, "seed": 5},
          "parallel": {"formula_batch": 8, "pixels_axis": 4,
                       "formulas_axis": 2, "checkpoint_every": 1,
                       "isocalc_workers": 1, "init_backoff_s": 0.2}}
POD_DS = {"isotope_generation": {"adducts": ["+H"]},
          "image_generation": {"ppm": 3.0}}
POD_LOCAL = 4                     # CPU devices each process stands for
STALL_TIMEOUT_S = 10.0


def pod_table(formulas, ds_config):
    """The ion table of ``formulas`` (+H, 3 decoys each, seed 5)."""
    from sm_distributed_tpu_torch.ops.fdr import FDR
    from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper

    fdr = FDR(decoy_sample_size=3, target_adducts=("+H",), seed=5)
    assignment = fdr.decoy_adduct_selection(formulas)
    pairs, flags = assignment.all_ion_tuples(formulas, ("+H",))
    return IsocalcWrapper(ds_config.isotope_generation,
                          n_procs=1).pattern_table(pairs, flags)


def main(out: Path) -> None:
    sm = SMConfig.from_dict(SM)
    assert distributed.maybe_initialize_distributed(sm.parallel)
    rank, size = distributed.world()
    ident = distributed.process_identity()
    agreed_value = distributed.agree_min([5, 2][rank])
    ds, truth = synthetic_dataset_arrays(8, 8, noise_peaks=20, seed=11)
    formulas = list(truth.formulas)[:8]
    ckpt = out / "ckpt"

    def search():
        return MSMBasicSearch(ds, formulas, DSConfig.from_dict(DS), sm,
                              checkpoint_dir=str(ckpt))

    failpoints.configure("device.score_batch=raise:RuntimeError@3")
    try:
        search().search()
        raise AssertionError("the killed search did not die")
    except RuntimeError as exc:
        assert "device.score_batch" in str(exc), exc
    failpoints.configure(None)
    mine = sorted(ckpt.glob(f"msm_search.p{rank}.g*.ckpt.npz"))
    assert len(mine) == 2, mine
    if rank == 1:
        mine[-1].unlink()
    agreed = []
    resumed = search()
    real = resumed._agree_resume_point
    resumed._agree_resume_point = lambda done: agreed.append(
        (done, real(done))) or agreed[-1][1]
    bundle = resumed.search()
    np.save(out / f"metrics_p{rank}.npy",
            bundle.all_metrics[["chaos", "spatial", "spectral",
                                "msm"]].to_numpy())
    (out / f"ok_p{rank}.json").write_text(json.dumps({
        "rank": rank, "size": size, "identity": ident,
        "agree_min": agreed_value, "resume": agreed}))
    distributed.shutdown()
    assert not distributed.is_initialized()


def _pod_setup(imzml: str):
    import torch

    from sm_distributed_tpu_torch.io.dataset import SpectralDataset

    sm = SMConfig.from_dict(POD_SM)
    dc = DSConfig.from_dict(POD_DS)
    assert distributed.maybe_initialize_distributed(sm.parallel)
    return sm, dc, SpectralDataset.from_imzml(imzml), \
        [torch.device("cpu")] * POD_LOCAL


def _one_sided_fault(ds, formulas, dc, sm, cpus, res: dict) -> None:
    """Process 1 alone raises before the search's second group."""
    if distributed.world()[0] == 1:
        failpoints.configure("device.score_batch=raise:RuntimeError@2")
    t0 = time.perf_counter()
    try:
        MSMBasicSearch(ds, formulas, dc, sm, devices=cpus).search()
        res["one_sided"] = None
    except Exception as exc:
        res["one_sided"] = f"{type(exc).__name__}: {exc}"[:400]
    res["one_sided_s"] = time.perf_counter() - t0
    failpoints.configure(None)


def pod_stall(out: Path, imzml: str, formulas: list[str]) -> None:
    distributed.INIT_TIMEOUT_S = STALL_TIMEOUT_S
    sm, dc, ds, cpus = _pod_setup(imzml)
    rank = distributed.world()[0]
    res = {"rank": rank}
    _one_sided_fault(ds, formulas, dc, sm, cpus, res)
    (out / f"stall_p{rank}.json").write_text(json.dumps(res))
    if rank == 1:
        # alive, its group open, until process 0 has ended its search
        deadline = time.monotonic() + 120
        while not (out / "stall_p0.json").exists() and \
                time.monotonic() < deadline:
            time.sleep(0.1)


def pod(out: Path, imzml: str, formulas: list[str]) -> None:
    import pandas as pd

    from sm_distributed_tpu_torch.models.msm_basic import _slice_table
    from sm_distributed_tpu_torch.parallel.sharded import (
        ShardedTorchBackend,
        make_torch_backend,
    )

    sm, dc, ds, cpus = _pod_setup(imzml)
    rank, size = distributed.world()
    table = pod_table(formulas, dc)
    backend = make_torch_backend(ds, dc, sm, restrict_table=table,
                                 devices=cpus)
    assert isinstance(backend, ShardedTorchBackend), type(backend)
    assert backend.spans_processes and backend.mesh.shape == {
        "pixels": 4, "formulas": 2}, backend.mesh.devices
    b = backend.batch
    slices = [(s, min(s + b, table.n_ions))
              for s in range(0, table.n_ions, b)]
    np.save(out / f"pod_batch_p{rank}.npy",
            backend.score_batch(_slice_table(table, *slices[0])))
    np.save(out / f"pod_scores_p{rank}.npy", np.concatenate(
        backend.score_batches([_slice_table(table, *sl) for sl in slices])))
    np.save(out / f"pod_images_p{rank}.npy",
            backend.extract_ion_images(table))
    res = {"rank": rank, "size": size, "collective": backend.collective,
           "cells": backend.mesh.local(),
           "resident_shards": [s for s, row in enumerate(backend._px)
                               if row],
           "cross_bytes": backend.cross_bytes, "batch": b,
           "n_batches": len(slices)}
    del backend

    ckpt = out / "pod_ckpt"

    def search(**kw):
        return MSMBasicSearch(ds, formulas, dc, sm, devices=cpus, **kw)

    want = search().search()
    failpoints.configure("device.score_batch=raise:RuntimeError@3")
    try:
        search(checkpoint_dir=str(ckpt)).search()
        raise AssertionError("the killed search did not die")
    except RuntimeError as exc:
        assert "device.score_batch" in str(exc), exc
    failpoints.configure(None)
    mine = sorted(ckpt.glob(f"msm_search.p{rank}.g*.ckpt.npz"))
    assert len(mine) == 2, mine
    if rank == 1:
        mine[-1].unlink()
    agreed = []
    resumed = search(checkpoint_dir=str(ckpt))
    real = resumed._agree_resume_point
    resumed._agree_resume_point = lambda done: agreed.append(
        (done, real(done))) or agreed[-1][1]
    got = resumed.search()
    assert resumed.last_backend.spans_processes
    pd.testing.assert_frame_equal(got.all_metrics, want.all_metrics,
                                  check_exact=True)
    pd.testing.assert_frame_equal(got.annotations, want.annotations,
                                  check_exact=True)
    np.save(out / f"pod_metrics_p{rank}.npy",
            want.all_metrics[["chaos", "spatial", "spectral",
                              "msm"]].to_numpy())
    res["resume"] = agreed

    _one_sided_fault(ds, formulas, dc, sm, cpus, res)
    (out / f"pod_p{rank}.json").write_text(json.dumps(res))
    print(f"pod worker {rank}: {res}", flush=True)


if __name__ == "__main__":
    if sys.argv[2:3] in (["pod"], ["pod-stall"]):
        run = pod if sys.argv[2] == "pod" else pod_stall
        run(Path(sys.argv[1]), sys.argv[3],
            json.loads(Path(sys.argv[4]).read_text()))
    else:
        main(Path(sys.argv[1]))
