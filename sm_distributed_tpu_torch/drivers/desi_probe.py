"""Per-batch and per-phase cost of the bench's ``desi`` case — the port of
the JAX package's ``scripts/desi_probe.py``.

Builds the ``drivers/bench.py`` ``desi`` workload (512x512 pixels, 500
formulas, the m/z-ordered stream at formula_batch 256, the f32 cube) and
attributes the stream's time:

1. serial per-batch timings: each batch's ``score_batch`` launches
   (``probe_phases``' ``fused_full``) alone, its variant and band width,
   timed with CUDA events on the card (the JAX script forces a readback);
2. ``probe_phases`` splits (extract / moments / chaos / correlation /
   pattern) on the first, median-width, widest and last batches;
3. the pipelined rate of one stream.

It reuses the bench's dataset under ``.cache/torch_bench`` (generated when
missing).  Usage::

    python -m sm_distributed_tpu_torch.drivers.desi_probe              # card
    python -m sm_distributed_tpu_torch.drivers.desi_probe --device cpu \\
        --nrows 8 --ncols 8 --n-formulas 12 --formula-batch 64

Prints ONE JSON line on stdout; logs to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import add_device_arguments, require_card


def build(formula_batch=256, nrows=512, ncols=512, n_formulas=500,
          device: str = "cuda", cache_dir=None):
    """``(prep, backend)``: the bench's prepared case and a ``torch_cuda``
    backend over it."""
    from ..models.msm_basic import make_backend
    from ..service.primer import bind_builds
    from ..utils.config import SMConfig
    from .bench import CACHE_DIR, BenchConfig, prepare

    cfg = BenchConfig("desi", nrows, ncols, n_formulas, formula_batch,
                      decoy_sample_size=20, reps=1, baseline_ions=0)
    prep = prepare(cfg, cache_dir or CACHE_DIR)
    sm_config = SMConfig.from_dict(
        {"backend": "torch_cuda", "device": device,
         "fdr": {"decoy_sample_size": 20},
         "parallel": {"formula_batch": formula_batch}})
    bind_builds(sm_config)
    backend = make_backend("torch_cuda", prep["ds"], prep["ds_config"],
                           sm_config, table=prep["table"])
    return prep, backend


def probe(formula_batch=256, nrows=512, ncols=512, n_formulas=500,
          device: str = "cuda", cache_dir=None) -> dict:
    from ..utils.logger import init_logger, logger
    from .profile_bench import device_seconds, timeit

    init_logger()
    prep, backend = build(formula_batch, nrows, ncols, n_formulas, device,
                          cache_dir)
    table, batches = prep["table"], prep["batches"]
    t0 = time.perf_counter()
    backend.warmup(batches)
    warmup_s = time.perf_counter() - t0
    logger.info("warmup: %.1fs", warmup_s)

    # 1. serial per-batch timings
    per_batch = []
    for i, t in enumerate(batches):
        phases, info = backend.probe_phases(t)
        dt = device_seconds(phases["fused_full"], device)
        per_batch.append({"batch": i, "variant": info.get("variant"),
                          "band_width": info.get("band_width", 0),
                          "ms": round(dt * 1e3, 6)})
    tot = sum(p["ms"] for p in per_batch) / 1e3
    logger.info("serial total: %.3fs over %d batches", tot, len(per_batch))
    for p in per_batch:
        logger.info("batch %2d %-7s band_w=%9d  %8.3f ms", p["batch"],
                    p["variant"], p["band_width"], p["ms"])

    # 2. phase splits on representative batches
    widths = [p["band_width"] for p in per_batch]
    reps = {0, int(np.argsort(widths)[len(widths) // 2]),
            int(np.argmax(widths)), len(batches) - 1}
    splits, infos = {}, {}
    for i in sorted(reps):
        phases, info = backend.probe_phases(batches[i])
        logger.info("batch %d probe info: %s", i, info)
        infos[f"b{i}"] = info
        splits[f"b{i}"] = {
            name: round(timeit(f"b{i}:{name}", fn, reps=3,
                               device=device) * 1e3, 6)
            for name, fn in phases.items()}

    # 3. the pipelined stream (one rep)
    t0 = time.perf_counter()
    backend.score_batches(batches)
    dt = time.perf_counter() - t0
    logger.info("pipelined stream: %.2fs -> %.1f ions/s",
                dt, table.n_ions / dt)
    return {"metric": "desi_probe", "n_ions": int(table.n_ions),
            "n_pixels": int(prep["ds"].n_pixels),
            "n_batches": len(batches), "warmup_s": round(warmup_s, 3),
            "serial_total_s": round(tot, 6), "batches": per_batch,
            "phases_ms": splits, "probe_info": infos,
            "stream_s": round(dt, 6),
            "stream_ions_per_s": round(table.n_ions / dt, 1),
            "variant_counts": dict(backend.variant_counts)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap, backend_help="the probed backend (torch_cuda "
                         "only)")
    ap.add_argument("--formula-batch", type=int, default=256)
    ap.add_argument("--nrows", type=int, default=512)
    ap.add_argument("--ncols", type=int, default=512)
    ap.add_argument("--n-formulas", type=int, default=500)
    args = ap.parse_args(argv)
    if args.backend != "torch_cuda":
        ap.error("the probe measures torch_cuda")
    require_card(ap, args.device)
    from .bench import card_identity

    out = probe(formula_batch=args.formula_batch, nrows=args.nrows,
                ncols=args.ncols, n_formulas=args.n_formulas,
                device=args.device)
    print(json.dumps({**out, "device": args.device,
                      **card_identity(args.device)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
