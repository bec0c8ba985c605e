"""End-to-end demo: synthesize an imzML dataset, annotate it on the card,
and query the results — the port of the JAX package's
``examples/annotate_demo.py``, with its steps and flags.

Run from the repo root (no external data or services needed)::

    python -m sm_distributed_tpu_torch.drivers.annotate_demo   # torch_cuda, cuda
    python -m sm_distributed_tpu_torch.drivers.annotate_demo --device cpu
    python -m sm_distributed_tpu_torch.drivers.annotate_demo --backend numpy_ref
    python -m sm_distributed_tpu_torch.drivers.annotate_demo --nrows 128 --ncols 128

Scores on the card unless ``--device cpu`` (or ``--backend numpy_ref``) is
given; a card asked for where none is visible is a usage error.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

from . import add_device_arguments, require_card


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap)
    ap.add_argument("--nrows", type=int, default=32)
    ap.add_argument("--ncols", type=int, default=32)
    ap.add_argument("--out", default=None,
                    help="working directory (default: a temp dir)")
    args = ap.parse_args(argv)
    if args.backend == "torch_cuda":
        require_card(ap, args.device)

    from ..engine.search_job import SearchJob
    from ..engine.storage import AnnotationIndex, JobLedger
    from ..io.fixtures import generate_synthetic_dataset
    from ..utils.config import DSConfig, SMConfig
    from ..utils.logger import init_logger

    init_logger()
    root = (Path(args.out) if args.out
            else Path(tempfile.mkdtemp(prefix="smtorch_demo_")))

    # 1. a synthetic dataset with known ground truth (half the formulas are
    #    spatially structured signal, the rest are absent)
    imzml, truth = generate_synthetic_dataset(
        root / "dataset", nrows=args.nrows, ncols=args.ncols,
        present_fraction=0.5, noise_peaks=100, seed=7)
    print(f"dataset: {args.nrows}x{args.ncols} px at {imzml}")
    print(f"ground truth: {len(truth.present)}/{len(truth.formulas)} "
          "formulas present")

    # 2. configure + run the annotation job (target/decoy FDR included)
    sm_config = SMConfig.from_dict({
        "backend": args.backend,
        "device": args.device,
        "work_dir": str(root / "work"),
        "storage": {"results_dir": str(root / "results")},
        "fdr": {"decoy_sample_size": 10, "seed": 42},
    })
    ds_config = DSConfig.from_dict({
        "isotope_generation": {"adducts": ["+H"]},
        "image_generation": {"ppm": 3.0},
    })
    job = SearchJob("demo", "demo dataset", imzml, ds_config,
                    sm_config=sm_config, formulas=list(truth.formulas))
    bundle = job.run()

    # 3. query the index the way the reference's webapp queries ES
    index = AnnotationIndex(JobLedger(sm_config.storage.results_dir))
    hits = index.search(ds_id="demo", max_fdr_level=0.1)
    got = set(hits.sf)
    tp = got & set(truth.present)
    fp = got - set(truth.present)
    print(f"\nannotations at FDR<=10%: {len(hits)} "
          f"(true positives {len(tp)}/{len(truth.present)}, false {len(fp)})")
    print(hits[["sf", "adduct", "mz", "msm", "fdr_level"]]
          .head(10).to_string(index=False))
    print(f"\nresults under {root}/results (parquet + sqlite + PNGs); "
          f"timings: {bundle.timings}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
