"""Per-phase timing of one scoring batch on the bench workload — the port
of the JAX package's ``scripts/profile_bench.py``.

Times each stage (extraction, moments, chaos, correlation, pattern match)
through the backend's own probe hooks (``TorchBackend.probe_phases``):
each probed phase launches what ``score_batch`` launches for the batch's
variant, on the same tensors.  On the card a phase's time is CUDA events
around ``reps`` calls after a warm call (the JAX script forces a host
readback instead); on the CPU the host clock.

Usage::

    python -m sm_distributed_tpu_torch.drivers.profile_bench          # card
    python -m sm_distributed_tpu_torch.drivers.profile_bench --device cpu \\
        --nrows 8 --ncols 8 --formula-batch 32 --noise-peaks 10 --reps 1

Prints ONE JSON line on stdout (``phases_ms``: ms a call by phase, the
JAX script's phase names; ``info``: the batch's path, variant and
shapes); logs to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from . import add_device_arguments, require_card

REPO_ROOT = Path(__file__).resolve().parents[2]


def device_seconds(fn, device: str, reps: int = 1) -> float:
    """Seconds a call of ``fn`` takes over ``reps`` calls: between two CUDA
    events on the card, the host clock around them on the CPU (where every
    op has finished when it returns)."""
    import torch

    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def timeit(name: str, fn, reps: int = 5, device: str = "cuda") -> float:
    """Seconds a call of ``fn`` takes: one warm call, then
    :func:`device_seconds` over ``reps`` calls."""
    import torch

    from ..utils.logger import logger

    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = device_seconds(fn, device, reps)
    logger.info("%-28s %8.3f ms", name, dt * 1e3)
    return dt


def profile(nrows=64, ncols=64, formula_batch=512, noise_peaks=200, reps=5,
            cache_dir=None, n_formulas=None, batch_index=0,
            device: str = "cuda") -> tuple[dict, dict]:
    """Run the phase breakdown; returns ``({phase: seconds}, info)``.

    ``n_formulas``: expand the formula list as the bench does (None = the
    50 curated fixture formulas; the dataset then goes to
    ``profile_ds_<r>x<c>``, else to the bench's ``bench_ds_*`` name, so a
    bench dataset is reused).  ``batch_index`` picks the formula batch:
    batch 0 holds the targets, later ones are mostly decoys."""
    from ..io.dataset import SpectralDataset
    from ..io.fixtures import (
        FIXTURE_FORMULAS,
        expand_formula_list,
        generate_synthetic_dataset,
    )
    from ..models.msm_basic import _slice_table
    from ..models.msm_torch import TorchBackend
    from ..ops.fdr import FDR
    from ..ops.isocalc import IsocalcWrapper
    from ..service.primer import bind_builds
    from ..utils.config import DSConfig, SMConfig
    from ..utils.logger import init_logger, logger

    init_logger()
    cache_dir = Path(cache_dir or REPO_ROOT / ".cache" / "torch_bench")
    formulas = (expand_formula_list(n_formulas) if n_formulas
                else FIXTURE_FORMULAS)
    name = (f"bench_ds_{nrows}x{ncols}_f{n_formulas}" if n_formulas
            else f"profile_ds_{nrows}x{ncols}")
    path, truth = generate_synthetic_dataset(
        cache_dir / name, nrows=nrows, ncols=ncols,
        formulas=formulas, present_fraction=0.6,
        noise_peaks=noise_peaks, seed=7, reuse=True,
    )
    ds = SpectralDataset.from_imzml(path)
    ds_config = DSConfig.from_dict(
        {"isotope_generation": {"adducts": ["+H"]},
         "image_generation": {"ppm": 3.0}})
    sm_config = SMConfig.from_dict(
        {"backend": "torch_cuda", "device": device,
         "fdr": {"decoy_sample_size": 20},
         "parallel": {"formula_batch": formula_batch}})
    bind_builds(sm_config)

    fdr = FDR(decoy_sample_size=20, target_adducts=("+H",), seed=42)
    assignment = fdr.decoy_adduct_selection(truth.formulas)
    pairs, flags = assignment.all_ion_tuples(truth.formulas, ("+H",))
    calc = IsocalcWrapper(ds_config.isotope_generation,
                          cache_dir=str(cache_dir / "isocalc"))
    table = calc.pattern_table(pairs, flags)

    backend = TorchBackend(ds, ds_config, sm_config, restrict_table=table)
    b = backend.batch
    s0 = min(batch_index * b, max(table.n_ions - b, 0))
    sub = _slice_table(table, s0, min(s0 + b, table.n_ions))

    phases, info = backend.probe_phases(sub)
    logger.info("probe info: %s", info)
    timings = {name: timeit(name, fn, reps=reps, device=device)
               for name, fn in phases.items()}
    parts = sum(t for name, t in timings.items() if name != "fused_full")
    logger.info("sum of parts: %.3f ms (full %.3f ms)",
                parts * 1e3, timings["fused_full"] * 1e3)
    return timings, info


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap, backend_help="the profiled backend (torch_cuda "
                         "only)")
    ap.add_argument("--nrows", type=int, default=64)
    ap.add_argument("--ncols", type=int, default=64)
    ap.add_argument("--formula-batch", type=int, default=512)
    ap.add_argument("--noise-peaks", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n-formulas", type=int, default=None,
                    help="expand the formula list as the bench does "
                         "(default: the 50 fixture formulas)")
    ap.add_argument("--batch-index", type=int, default=0)
    args = ap.parse_args(argv)
    if args.backend != "torch_cuda":
        ap.error("the profile measures torch_cuda")
    require_card(ap, args.device)
    from .bench import card_identity

    timings, info = profile(
        nrows=args.nrows, ncols=args.ncols, formula_batch=args.formula_batch,
        noise_peaks=args.noise_peaks, reps=args.reps,
        n_formulas=args.n_formulas,
        batch_index=args.batch_index, device=args.device)
    print(json.dumps({
        "metric": "phase_ms", "device": args.device,
        **card_identity(args.device),
        "phases_ms": {k: round(v * 1e3, 6) for k, v in timings.items()},
        "info": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
