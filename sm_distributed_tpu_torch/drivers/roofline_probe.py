"""Roofline probe of the scoring stream — the port of the JAX package's
``scripts/roofline_probe.py``.

The stream is timed against the port's minimum work
(``ops/imager.py::banded_score_cost_model``: the JAX cost model's terms,
copied exactly in ``fused_score_cost_model``, with its dense membership
matmul and scratch priced as the port's banded launches do them)::

    headroom_x = measured_seconds / max(bytes / peak_bw, flops / peak_flops)

an upper bound on what further tuning of the same algorithm could recover
(the model prices no padding, host work or launch gaps).

Departure from the JAX script: the share divides by the card's
**published** peaks (:data:`PUBLISHED_PEAKS`, NVIDIA's data sheet for one
H100 SXM at 700 W: 3.35 TB/s of HBM, and 67 TFLOP/s f32 outside the tensor
cores, because the engine's matmuls run at ``highest``, never TF32), not by
microbenchmarked ones.  :func:`measure_device_peaks` still measures a
reduction, an elementwise copy and an f32 matmul at ``highest`` (CUDA
events on the card) and prints them under ``peaks``; the published ones are
under ``published_peaks``.  Off the card there is no published peak, so
the floor, the bound, the headroom and the share are null — and a
``--min-frac`` gate fails.  The card's name and power limit
(``nvidia-smi``) are printed beside every figure.

Usage::

    python -m sm_distributed_tpu_torch.drivers.roofline_probe --device cpu --tiny
    python -m sm_distributed_tpu_torch.drivers.roofline_probe      # the card
    python -m sm_distributed_tpu_torch.drivers.roofline_probe \\
        --nrows 512 --ncols 512 --n-formulas 500 --formula-batch 256

Prints ONE JSON line on stdout; logs to stderr.  Exit 0, or 1 when the
share is below ``--min-frac`` (or null with the gate set).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import add_device_arguments, require_card

# NVIDIA's data sheet, one H100 SXM, dense, at its 700 W power limit
PUBLISHED_PEAKS = {"card": "H100", "bytes_per_s": 3.35e12,
                   "f32_flops": 67e12}


def published_peaks(device: str) -> dict | None:
    """The card's published HBM rate and f32 rate, or None where none is
    published for the device (the CPU, a card other than an H100)."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    if PUBLISHED_PEAKS["card"] not in torch.cuda.get_device_name(dev):
        return None
    return dict(PUBLISHED_PEAKS)


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def measure_device_peaks(bw_mb: int = 256, mm_n: int = 2048,
                         device: str = "cuda") -> dict:
    """Microbenchmark ceilings on ``device``: the effective bandwidth of a
    reduction and of an elementwise copy over a ``bw_mb``-MB f32 array, and
    the f32 matmul rate at ``highest`` (the engine's precision; TF32 off,
    as ``models/msm_torch.resolve_device`` sets and checks)."""
    import torch

    from ..models.msm_torch import resolve_device
    from .profile_bench import device_seconds

    dev = resolve_device(device)
    n = bw_mb * (1 << 20) // 4
    x = torch.arange(n, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    red = lambda: x.sum()                                   # noqa: E731
    cpy = lambda: torch.mul(x, 2.0, out=out)                # noqa: E731
    red()
    cpy()
    red_dts = [device_seconds(red, dev) for _ in range(5)]
    cpy_dts = [device_seconds(cpy, dev) for _ in range(5)]
    red_bw = 4 * n / _median(red_dts)            # bytes read
    cpy_bw = 8 * n / _median(cpy_dts)            # read + write
    a = torch.ones((mm_n, mm_n), dtype=torch.float32, device=dev)
    c = torch.empty_like(a)
    mm = lambda: torch.matmul(a, a, out=c)                  # noqa: E731
    mm()
    mm_dts = [device_seconds(mm, dev) for _ in range(3)]
    flops = 2.0 * mm_n**3 / _median(mm_dts)
    return dict(
        peak_reduction_gbps=red_bw / 1e9,
        peak_copy_gbps=cpy_bw / 1e9,
        peak_bw_gbps=max(red_bw, cpy_bw) / 1e9,
        peak_matmul_gflops=flops / 1e9,
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else str(dev)),
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_device_arguments(ap, backend_help="the probed backend (torch_cuda "
                         "only)")
    ap.add_argument("--nrows", type=int, default=64)
    ap.add_argument("--ncols", type=int, default=64)
    ap.add_argument("--n-formulas", type=int, default=250)
    ap.add_argument("--formula-batch", type=int, default=2048)
    ap.add_argument("--decoy-sample-size", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true",
                    help="smoke shape (16x16 px, 8 formulas, tiny "
                         "microbenches)")
    ap.add_argument("--fused", choices=("auto", "on", "off"), default="auto",
                    help="parallel.fused_metrics for the probed backend "
                         "('on' takes the fused window-moments kernel)")
    ap.add_argument("--cube-dtype", choices=("f32", "bf16", "int8"),
                    default="f32",
                    help="parallel.cube_dtype for the probed backend")
    ap.add_argument("--min-frac", type=float, default=0.0,
                    help="exit 1 unless roofline_frac (= floor_s / "
                         "measured_s) >= this; a null share fails the gate")
    args = ap.parse_args(argv)
    if args.backend != "torch_cuda":
        ap.error("the probe measures torch_cuda")
    require_card(ap, args.device)
    if args.tiny:
        args.nrows = args.ncols = 16
        args.n_formulas = 8
        args.formula_batch = 64
        args.decoy_sample_size = 4
        args.reps = 1

    from ..models.msm_basic import make_backend
    from ..ops.imager import banded_score_cost_model
    from ..service.primer import bind_builds
    from ..utils.config import SMConfig
    from ..utils.logger import init_logger, logger
    from .bench import CACHE_DIR, BenchConfig, _sync, card_identity, prepare

    init_logger()
    cfg = BenchConfig("roofline", args.nrows, args.ncols, args.n_formulas,
                      args.formula_batch, args.decoy_sample_size,
                      reps=args.reps, baseline_ions=0)
    prep = prepare(cfg, CACHE_DIR)
    table, ds = prep["table"], prep["ds"]
    sm_config = SMConfig.from_dict(
        {"backend": "torch_cuda", "device": args.device,
         "fdr": {"decoy_sample_size": args.decoy_sample_size},
         "parallel": {"formula_batch": args.formula_batch,
                      "fused_metrics": args.fused,
                      "cube_dtype": args.cube_dtype}})
    bind_builds(sm_config)
    backend = make_backend("torch_cuda", ds, prep["ds_config"], sm_config,
                           table=table)
    batches = prep["batches"]
    backend.warmup(batches)
    _sync(args.device)

    fused0 = backend.variant_counts["fused"]
    dts = []
    for i in range(max(1, args.reps)):
        t0 = time.perf_counter()
        backend.score_batches(batches)
        dts.append(time.perf_counter() - t0)
        logger.info("rep %d: %.3fs (%.1f ions/s)", i, dts[-1],
                    table.n_ions / dts[-1])
    measured_s = _median(dts)
    # price the variant that ran
    fused_active = backend.variant_counts["fused"] > fused0

    peaks = measure_device_peaks(bw_mb=16 if args.tiny else 256,
                                 mm_n=256 if args.tiny else 2048,
                                 device=args.device)
    resident_peaks = backend.resident_peaks
    model = banded_score_cost_model(
        n_pixels=ds.n_pixels,
        resident_peaks=resident_peaks,
        n_ions=table.n_ions,
        max_peaks=table.max_peaks,
        formula_batch=args.formula_batch,
        bands=backend.band_shapes(batches),
        nlevels=prep["ds_config"].image_generation.nlevels,
        ordered=True,
        fused=fused_active,
        cube_dtype=args.cube_dtype,
    )
    published = published_peaks(args.device)
    floor_s = bound = headroom = frac = None
    if published is not None:
        t_bw = model["total_bytes"] / published["bytes_per_s"]
        t_fl = model["matmul_flops"] / published["f32_flops"]
        floor_s = max(t_bw, t_fl)
        bound = "bandwidth" if t_bw >= t_fl else "compute"
        headroom = round(measured_s / floor_s, 2) if floor_s > 0 else None
        frac = round(floor_s / measured_s, 6) if measured_s > 0 else 0.0
        floor_s = round(floor_s, 6)
    int_bytes = {"f32": 4, "bf16": 2, "int8": 1}[args.cube_dtype]
    out = {
        "metric": "fused_score_roofline",
        "measured_s_per_rep": round(measured_s, 4),
        "ions_per_s": round(table.n_ions / measured_s, 1),
        "model": model,
        "peaks": {k: round(v, 2) for k, v in peaks.items()
                  if isinstance(v, float)},
        "published_peaks": (None if published is None else
                            {"bw_gbps": published["bytes_per_s"] / 1e9,
                             "matmul_gflops": published["f32_flops"] / 1e9}),
        "device": peaks["device"],
        **card_identity(args.device),
        "roofline_floor_s": floor_s,
        "bound": bound,
        "headroom_x": headroom,
        "roofline_frac": frac,
        "fused": bool(fused_active),
        "cube_dtype": args.cube_dtype,
        "resident_cube_bytes": int(resident_peaks * int_bytes),
        "n_ions": int(table.n_ions),
        "n_pixels": int(ds.n_pixels),
        "resident_peaks": resident_peaks,
    }
    print(json.dumps(out))
    if args.min_frac and (frac is None or frac < args.min_frac):
        logger.error(
            "roofline_frac %s below gate --min-frac %.4f (measured %.4fs vs "
            "model floor %s)", frac, args.min_frac, measured_s, floor_s)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
