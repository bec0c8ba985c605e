"""Cold-path wall clock of one end-to-end job at ~80k formulas — the port
of the JAX package's ``scripts/cold_path_bench.py``.

One measured ``SearchJob`` with a cold isotope-pattern cache: staging,
parse, decoy selection, isotope-pattern generation, scoring, FDR and
storage, on a 100x100-pixel section.  The dataset carries signal for
``--present`` formulas (a tissue section holds a small fraction of a big
database); the others still cost full pattern generation, scoring and
decoy ranking, which is the point.

Scores on the card unless ``--device cpu`` (or ``--backend numpy_ref``)
is given; a card asked for where none is visible is a usage error.
Usage::

    python -m sm_distributed_tpu_torch.drivers.cold_path_bench        # card
    python -m sm_distributed_tpu_torch.drivers.cold_path_bench --device cpu \\
        --n-formulas 60 --nrows 8 --ncols 8 --present 6 --work-dir /tmp/cp

Prints ONE JSON line (the JAX script's keys); logs to stderr.  The run is
dominated by pattern generation: run it alone so the wall clock is honest.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

from . import add_device_arguments, require_card

REPO_ROOT = Path(__file__).resolve().parents[2]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap)
    ap.add_argument("--n-formulas", type=int, default=80_000)
    ap.add_argument("--nrows", type=int, default=100)
    ap.add_argument("--ncols", type=int, default=100)
    ap.add_argument("--decoy-sample-size", type=int, default=20)
    ap.add_argument("--present", type=int, default=800,
                    help="formulas with embedded spatial signal")
    ap.add_argument("--work-dir", default="",
                    help="job work dir (default: .cache/torch_bench/"
                         "cold_path; the pattern cache inside is REMOVED "
                         "first — that's the 'cold' in cold path)")
    ap.add_argument("--isocalc-device", action="store_true",
                    help="route blur->centroid through the device stage "
                         "(parallel.isocalc_device=on)")
    ap.add_argument("--isocalc-workers", type=int, default=0,
                    help="isocalc pool size (0 = all cores)")
    args = ap.parse_args(argv)
    if args.backend == "torch_cuda" or args.isocalc_device:
        require_card(ap, args.device)

    from ..engine.search_job import SearchJob
    from ..io.fixtures import expand_formula_list, generate_synthetic_dataset
    from ..service.primer import bind_builds
    from ..utils.config import DSConfig, SMConfig
    from ..utils.logger import init_logger, logger

    init_logger()
    root = Path(args.work_dir or REPO_ROOT / ".cache" / "torch_bench"
                / "cold_path")
    root.mkdir(parents=True, exist_ok=True)

    formulas = expand_formula_list(args.n_formulas)
    t0 = time.perf_counter()
    ds_path, _truth = generate_synthetic_dataset(
        root / "ds", nrows=args.nrows, ncols=args.ncols,
        formulas=formulas[: args.present], present_fraction=1.0,
        noise_peaks=200, seed=11, reuse=True)
    logger.info("fixture: %dx%d px, %d signal formulas (%.1fs)",
                args.nrows, args.ncols, args.present,
                time.perf_counter() - t0)

    # the cold cache: the whole point of this measurement
    job_work = root / "work"
    for stale in (job_work / "isocalc_cache", root / "results"):
        shutil.rmtree(stale, ignore_errors=True)

    sm_config = SMConfig.from_dict({
        "backend": args.backend,
        "device": args.device,
        "fdr": {"decoy_sample_size": args.decoy_sample_size},
        "storage": {"results_dir": str(root / "results"),
                    "store_images": False},
        "work_dir": str(job_work),
        "parallel": {
            "isocalc_device": "on" if args.isocalc_device else "off",
            "isocalc_workers": args.isocalc_workers,
        },
    })
    bind_builds(sm_config)
    ds_config = DSConfig.from_dict({
        "isotope_generation": {"adducts": ["+H"]},
        "image_generation": {"ppm": 3.0},
    })

    t0 = time.perf_counter()
    job = SearchJob("cold3", "cold-path-config3", ds_path, ds_config,
                    sm_config, formulas=formulas)
    bundle = job.run()
    wall = time.perf_counter() - t0

    t = bundle.timings
    # the generation wall (isocalc_gen) against the residual blocking wait
    # (isotope_patterns): parse and staging overlap the generation
    isocalc_s = t.get("isocalc_gen", t.get("isotope_patterns", 0.0))
    iso_stats = job.last_isocalc_stats or {}
    out = {
        "metric": "cold_path_config3_wall_clock",
        "unit": "s",
        "value": round(wall, 1),
        "n_formulas": args.n_formulas,
        "n_ions": int(bundle.all_metrics.shape[0]),
        "n_pixels": args.nrows * args.ncols,
        "isocalc_s": round(isocalc_s, 1),
        "isocalc_share": round(isocalc_s / wall, 3) if wall else None,
        "isocalc_wait_s": round(t.get("isotope_patterns", 0.0), 1),
        "isocalc_workers": iso_stats.get("workers"),
        "patterns_per_s": iso_stats.get("patterns_per_s"),
        "isocalc_device": bool(iso_stats.get("device", False)),
        "phases_s": {k: round(v, 1) for k, v in sorted(t.items())},
        "n_annotations_fdr10": int((bundle.annotations["fdr"] <= 0.1).sum())
        if len(bundle.annotations) else 0,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
