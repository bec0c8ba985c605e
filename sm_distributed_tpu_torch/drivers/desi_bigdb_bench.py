"""Whole-slide pixels against a big database in one job — the port of the
JAX package's ``scripts/desi_bigdb_bench.py``.

512x512 = 262,144 pixels scored against ~80k formulas x (1 target + 20
decoy) adducts = ~1.68M ions in ONE measured end-to-end ``SearchJob``, at
formula_batch 256 with a checkpoint every 64 batches: the bench's ``desi``
geometry and the cold-path script's database together, where the resident
peaks, the band widths over ~6.5k batches and the sustained stream are
stressed.

It reuses the bench's 512x512 dataset (``drivers/bench.py``'s generator
parameters, under ``.cache/torch_bench``) and the cold-path run's pattern
cache when present (the same formula list, adducts and FDR seed give the
same (formula, adduct) pairs): run it after
``drivers/cold_path_bench.py`` for a warm-pattern measurement, with a
fresh ``--work-dir`` for a cold one.

Scores on the card unless ``--device cpu`` (or ``--backend numpy_ref``).
Usage::

    python -m sm_distributed_tpu_torch.drivers.desi_bigdb_bench       # card
    python -m sm_distributed_tpu_torch.drivers.desi_bigdb_bench --device cpu \\
        --n-formulas 60 --nrows 8 --ncols 8 --work-dir /tmp/bigdb

Prints ONE JSON line (the JAX script's keys); logs to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import add_device_arguments, require_card

REPO_ROOT = Path(__file__).resolve().parents[2]


def run(*, n_formulas: int, nrows: int, ncols: int, decoy_sample_size: int,
        formula_batch: int, checkpoint_every: int, cache_dir: Path,
        work_dir: Path | None = None, fixture_formulas: int = 500,
        noise_peaks: int = 200, backend: str = "torch_cuda",
        device: str = "cuda") -> dict:
    from ..engine.search_job import SearchJob
    from ..io.fixtures import expand_formula_list, generate_synthetic_dataset
    from ..service.primer import bind_builds
    from ..utils.config import DSConfig, SMConfig
    from ..utils.logger import logger

    cache_dir = Path(cache_dir)
    work_dir = Path(work_dir or cache_dir / "cold_path" / "work")

    # the bench's desi dataset, bit for bit (drivers/bench.py::prepare's
    # generator parameters): signal for ``fixture_formulas`` formulas; the
    # other scored formulas still pay extraction and decoy ranking
    t0 = time.perf_counter()
    ds_path, _truth = generate_synthetic_dataset(
        cache_dir / f"bench_ds_{nrows}x{ncols}_f{fixture_formulas}",
        nrows=nrows, ncols=ncols,
        formulas=expand_formula_list(fixture_formulas),
        present_fraction=0.6, noise_peaks=noise_peaks, seed=7, reuse=True)
    logger.info("fixture: %dx%d px (%.1fs)", nrows, ncols,
                time.perf_counter() - t0)

    sm_config = SMConfig.from_dict({
        "backend": backend,
        "device": device,
        "fdr": {"decoy_sample_size": decoy_sample_size},
        "storage": {"results_dir": str(cache_dir / "desi_bigdb" / "results"),
                    "store_images": False},
        "work_dir": str(work_dir),
        "parallel": {"formula_batch": formula_batch,
                     "checkpoint_every": checkpoint_every},
    })
    bind_builds(sm_config)
    ds_config = DSConfig.from_dict({
        "isotope_generation": {"adducts": ["+H"]},
        "image_generation": {"ppm": 3.0},
    })
    formulas = expand_formula_list(n_formulas)

    t0 = time.perf_counter()
    job = SearchJob("desi_bigdb", "desi-bigdb-config5", ds_path, ds_config,
                    sm_config, formulas=formulas)
    bundle = job.run()
    wall = time.perf_counter() - t0

    t = bundle.timings
    n_ions = int(bundle.all_metrics.shape[0])
    score_s = t.get("score", 0.0)
    return {
        "metric": "desi_bigdb_config5_wall_clock",
        "unit": "s",
        "value": round(wall, 1),
        "n_formulas": n_formulas,
        "n_ions": n_ions,
        "n_pixels": nrows * ncols,
        "score_s": round(score_s, 1),
        "score_ions_per_s": round(n_ions / score_s, 1) if score_s else None,
        "isocalc_s": round(t.get("isotope_patterns", 0.0), 1),
        "phases_s": {k: round(v, 1) for k, v in sorted(t.items())},
        "n_annotations_fdr10": int((bundle.annotations["fdr"] <= 0.1).sum())
        if len(bundle.annotations) else 0,
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap)
    ap.add_argument("--n-formulas", type=int, default=80_000)
    ap.add_argument("--nrows", type=int, default=512)
    ap.add_argument("--ncols", type=int, default=512)
    ap.add_argument("--decoy-sample-size", type=int, default=20)
    ap.add_argument("--formula-batch", type=int, default=256,
                    help="256 keeps the flat-path histogram scratch inside "
                         "the backend's guard at 262k pixels")
    ap.add_argument("--checkpoint-every", type=int, default=64,
                    help="batches per checkpoint group (a group boundary "
                         "every ~16k ions; also exercises mid-search "
                         "checkpointing at this scale)")
    ap.add_argument("--work-dir", default="",
                    help="job work dir (default: .cache/torch_bench/"
                         "cold_path/work — SHARES the cold-path run's "
                         "pattern cache)")
    args = ap.parse_args(argv)
    if args.backend == "torch_cuda":
        require_card(ap, args.device)

    from ..utils.logger import init_logger

    init_logger()
    out = run(
        n_formulas=args.n_formulas, nrows=args.nrows, ncols=args.ncols,
        decoy_sample_size=args.decoy_sample_size,
        formula_batch=args.formula_batch,
        checkpoint_every=args.checkpoint_every,
        cache_dir=REPO_ROOT / ".cache" / "torch_bench",
        work_dir=Path(args.work_dir) if args.work_dir else None,
        backend=args.backend, device=args.device,
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
