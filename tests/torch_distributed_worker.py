"""Worker process of the port's REAL 2-process runtime test.

Launched by ``tests/test_torch_distributed.py`` with ``SM_COORDINATOR``,
``SM_NUM_PROCESSES`` and ``SM_PROCESS_ID`` in the environment (the launch
contract of ``sm_distributed_tpu_torch/parallel/distributed.py``) and an
output directory as its argument.  Imports the port only (no jax).

1. ``maybe_initialize_distributed`` through the config resolution: a gloo
   process group over a TCP rendezvous at the coordinator;
2. the process's rank, identity and a ``agree_min`` of divergent values;
3. a checkpointed search of a seeded 8x8 dataset on the CPU, killed by the
   ``device.score_batch`` failpoint before its third group in both
   processes; process 1 then drops its second shard, so the two hold 2
   and 1 durable groups; the rerun agrees on resuming from group 1
   (``MSMBasicSearch._agree_resume_point``) in both processes and finishes.

Writes ``ok_p<rank>.json`` (the figures) and ``metrics_p<rank>.npy``.
"""

from __future__ import annotations

import json
import sys
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


if __name__ == "__main__":
    main(Path(sys.argv[1]))
