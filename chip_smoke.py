#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sm_distributed_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sm_distributed_tpu_torch/csrc`` with
nvcc, drives the library search at full width (256x256 pixels, 200 noise
peaks a pixel, formula batches of 2048 ions, a cold isotope-pattern cache),
holds each kernel against its plain PyTorch version on the main path's
first image block and checks the 32x32 golden fixture against ``tests/data/golden_spheroid.json``.  One line per
phase; any failure raises and exits non-zero.  The line before the last is
a JSON object with each kernel's launches on the main path, its error
against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the rate of their type
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# the moments contract on the card: sums, max and positive counts exact on
# integer-grid values (row sums < 2**24, so any order gives the same bits);
# the centered norms within 16 ulp, the centered dots within 16 ulp of the
# scale they are divided by in the correlation (sqrt(normsq0 * normsq_k))
MOMENT_ULPS = 16
# the MSM component contracts (chaos, spatial, spectral, msm) in ulp
CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}

# full-width main path: the JAX bench's scale geometry
NROWS = NCOLS = 256
NOISE_PEAKS = 200
N_FORMULAS = 100          # ~4.9k ions with 3 adducts and 20 decoys each

# the golden fixture recipe of scripts/make_golden_report.py (GEN, SM, DS)
GOLDEN_GEN = dict(nrows=32, ncols=32, formulas=None, present_fraction=0.6,
                  noise_peaks=200, mz_jitter_ppm=0.5, seed=7)
GOLDEN_SM = {"fdr": {"decoy_sample_size": 20, "seed": 42},
             "parallel": {"formula_batch": 256}}
GOLDEN_DS = {"image_generation": {"ppm": 3.0}}
GOLDEN_SECTIONS = {"root": ("+H",), "multi_adduct": ("+H", "+Na", "+K")}


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: int, op_seconds: float) -> tuple[float, str]:
    """The least time of a function on the card, in ms, and what sets it:
    its bytes over the memory rate or its operations over their peak."""
    byte_seconds = n_bytes / HBM_BYTES_PER_S
    if byte_seconds >= op_seconds:
        return 1e3 * byte_seconds, "bytes"
    return 1e3 * op_seconds, "operations"


def _lex(x: torch.Tensor) -> torch.Tensor:
    i = x.float().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise f32 ulp distance."""
    return (_lex(a) - _lex(b)).abs()


def ulps_at(diff: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """|diff| in ulp of ``scale`` (f32)."""
    s = scale.float().clamp(min=1e-30)
    return diff.abs().double() / (torch.nextafter(s, s * 2) - s).double()


# ----------------------------------------------------------------- phases
def phase_environment() -> tuple[str, torch.device]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    from sm_distributed_tpu_torch.models.msm_torch import resolve_device

    dev = resolve_device("cuda:0")
    say(f"phase 1 environment: torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32} precision="
        f"{torch.get_float32_matmul_precision()}")
    return card, dev


def phase_build() -> None:
    from sm_distributed_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    regs = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln]
            for name, log in _build.build_logs.items()}
    say(f"phase 2 build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(_build.KERNELS)} (nvcc {_build.NVCC_FLAGS}); {regs}")


def _check_moments(x: torch.Tensor, n_real, exact_sums: bool, label: str):
    """Kernel against the plain version and an f64 reference.  The kernel
    is held to MOMENT_ULPS of the f64 reference, and to MOMENT_ULPS of the
    plain version beyond the plain version's own distance from the f64
    reference: the plain version's f32 sums drift too, and that drift is
    not the kernel's (sums, max and counts are exact where stated)."""
    from sm_distributed_tpu_torch.ops.moments import (
        batch_moments,
        batch_moments_torch,
    )

    got = batch_moments(x, n_real)
    want = batch_moments_torch(x, n_real)
    ref = [r.float() for r in batch_moments_torch(x.double(), n_real)]
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3]), f"moments {label}: vmax not exact"
    assert torch.equal(got[4], want[4]), f"moments {label}: count not exact"
    if exact_sums:
        assert torch.equal(got[0], want[0]), f"moments {label}: sums"
    scale = torch.sqrt((ref[1][:, 0:1] * ref[1]).clamp(min=0))
    gaps = {}
    for name, i, dist in (("sums", 0, ulps), ("normsq", 1, ulps),
                          ("dots", 2, lambda a, b: ulps_at(a - b, scale))):
        to_ref = dist(got[i], ref[i])
        plain_to_ref = dist(want[i], ref[i])
        to_plain = dist(got[i], want[i])
        assert float(to_ref.max()) <= MOMENT_ULPS, (
            f"moments {label}: {name} {float(to_ref.max())} ulp from f64")
        assert bool((to_plain <= MOMENT_ULPS + plain_to_ref).all()), (
            f"moments {label}: {name} {float(to_plain.max())} ulp from plain")
        gaps[name] = (float(to_plain.max()), float(to_ref.max()),
                      float(plain_to_ref.max()))
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    say(f"  moments {label} {tuple(x.shape)} n_real={n_real}: ulp gap "
        "(kernel-plain, kernel-f64, plain-f64) "
        + ", ".join(f"{k} {v[0]:.0f}/{v[1]:.0f}/{v[2]:.0f}"
                    for k, v in gaps.items())
        + f"; max abs err vs plain {err}")
    return err


def _scipy_count_sums(images: np.ndarray, nrows: int, ncols: int,
                      nlevels: int) -> list[int]:
    from scipy import ndimage

    s4 = [[0, 1, 0], [1, 1, 1], [0, 1, 0]]
    out = []
    for im in images:
        img = np.maximum(im.reshape(nrows, ncols).astype(np.float32), 0.0)
        vmax = img.max()
        out.append(sum(
            ndimage.label(img > vmax * (np.float32(li) / np.float32(nlevels)),
                          structure=s4)[1] for li in range(nlevels)))
    return out


def _check_chaos(images: torch.Tensor, nrows: int, ncols: int, nlevels: int,
                 label: str) -> None:
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_torch,
    )

    got = chaos_count_sums(images, nrows, ncols, nlevels)
    want = chaos_count_sums_torch(images, nrows, ncols, nlevels)
    assert torch.equal(got, want), (
        f"chaos {label}: {int((got != want).sum())} images differ")
    host = images[:3].cpu().numpy()
    sc = _scipy_count_sums(host, nrows, ncols, nlevels)
    assert got[:3].cpu().tolist() == [float(v) for v in sc], (
        f"chaos {label}: kernel {got[:3].tolist()} != scipy {sc}")
    say(f"  chaos {label}: {images.shape[0]} images {nrows}x{ncols} "
        f"bit-equal to the plain version, first 3 equal to scipy {sc}")


def _random_images(n: int, p: int, dev, gen) -> torch.Tensor:
    dens = torch.rand(n, 1, device=dev, generator=gen) * 0.8 + 0.1
    vals = torch.rand(n, p, device=dev, generator=gen)
    keep = torch.rand(n, p, device=dev, generator=gen) < dens
    return torch.where(keep, vals, torch.zeros((), device=dev))


def phase_kernels(dev, block: torch.Tensor, n_real, nlevels: int) -> list:
    """Kernels against their plain versions on the card, at the main path's
    shapes: ``block`` is the first (2048, 4, 65536) image block of the main
    path's dataset, as the metrics receive it."""
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_torch,
    )
    from sm_distributed_tpu_torch.ops.moments import (
        batch_moments,
        batch_moments_torch,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    n, k, p = block.shape
    # --- moments (kernels 1 and 2: masked and unmasked) ---
    grid = (torch.randint(0, 256, (n, k, p), device=dev, generator=gen)
            .float() * (torch.rand(n, k, p, device=dev, generator=gen) < 0.3))
    err = 0.0
    err = max(err, _check_moments(grid, p - 256, True, "integer grid masked"))
    err = max(err, _check_moments(grid, None, True, "integer grid unmasked"))
    del grid
    err = max(err, _check_moments(block, n_real, False, "main-path block"))
    small = (torch.randint(0, 1000, (5, 3, 999), device=dev, generator=gen)
             .float() * (torch.rand(5, 3, 999, device=dev, generator=gen) < .5))
    _check_moments(small, 990, True, "off-lattice masked")
    _check_moments(small, None, True, "off-lattice unmasked")
    mom_ms = time_ms(lambda: batch_moments(block, n_real))
    mom_unmasked_ms = time_ms(lambda: batch_moments(block, None))
    mom_plain_ms = time_ms(lambda: batch_moments_torch(block, n_real), reps=3)
    mom_unmasked_plain_ms = time_ms(lambda: batch_moments_torch(block, None),
                                    reps=3)
    mom_bytes = block.numel() * 4 + n * k * 5 * 4
    # per element: 1 f32 sub + 2 f32 mul (centered terms) and 3 f64 adds
    mom_bound, mom_by = bound_ms(
        mom_bytes, 3 * block.numel() / F32_OPS_PER_S
        + 3 * block.numel() / F64_OPS_PER_S)
    say(f"  moments times: kernel {mom_ms:.3f} ms masked, "
        f"{mom_unmasked_ms:.3f} ms unmasked; plain {mom_plain_ms:.3f} ms "
        f"masked, {mom_unmasked_plain_ms:.3f} ms unmasked; bound "
        f"{mom_bound:.3f} ms ({mom_by})")

    # --- chaos (kernel 3, packed route) ---
    principal = block[:, 0, :]                 # the main path's strided view
    side = int(round(p ** 0.5))
    _check_chaos(principal, side, side, nlevels, "main-path principal")
    _check_chaos(_random_images(256, 256 * 256, dev, gen), 256, 256, nlevels,
                 "random masks")
    _check_chaos(_random_images(64, 512 * 512, dev, gen), 512, 512, nlevels,
                 "random masks")
    up = principal[:64].reshape(64, side, side).repeat_interleave(
        2, dim=1).repeat_interleave(2, dim=2).reshape(64, -1)
    _check_chaos(up, 2 * side, 2 * side, nlevels, "principal upsampled 2x")
    ch_ms = time_ms(lambda: chaos_count_sums(principal, side, side, nlevels),
                    reps=5)
    ch_plain_ms = time_ms(
        lambda: chaos_count_sums_torch(principal, side, side, nlevels),
        reps=1, warmup=0)
    # the byte floor: the union-find's compares and atomics are integer
    # work whose count depends on the images, which no peak rate models
    ch_bytes = principal.shape[0] * (p * 4 + nlevels * 4 + 4)
    ch_bound, ch_by = bound_ms(ch_bytes, 0.0)
    say(f"  chaos times: kernel {ch_ms:.3f} ms, plain {ch_plain_ms:.3f} ms, "
        f"byte floor {ch_bound:.3f} ms")
    say("phase 4 kernels: moments within "
        f"{MOMENT_ULPS} ulp of f64 and of the plain version beyond its own "
        "drift (sums/max/counts exact on the integer grid), chaos bit-equal "
        "to the plain version and scipy")
    return [
        {"name": "moments", "route": "cuda",
         "source": "sm_distributed_tpu_torch/csrc/moments.cu",
         "replaces": "sm_distributed_tpu/ops/moments_pallas.py:179",
         "max_abs_err": err, "ms": mom_ms, "plain_ms": mom_plain_ms,
         "bound_ms": mom_bound, "bound_by": mom_by, "library_ms": None},
        {"name": "chaos", "route": "cuda",
         "source": "sm_distributed_tpu_torch/csrc/chaos.cu",
         "replaces": "sm_distributed_tpu/ops/chaos_pallas.py:284",
         "max_abs_err": 0.0, "ms": ch_ms, "plain_ms": ch_plain_ms,
         "bound_ms": ch_bound, "bound_by": ch_by, "library_ms": None},
    ]


def _setup_main_path():
    """The full-width dataset and the search object (set-up: not part of
    the measured main path).  The search's isotope-pattern cache is cold."""
    from sm_distributed_tpu_torch.io.fixtures import (
        expand_formula_list,
        synthetic_dataset_arrays,
    )
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    t0 = time.perf_counter()
    ds, truth = synthetic_dataset_arrays(
        NROWS, NCOLS, formulas=expand_formula_list(N_FORMULAS),
        present_fraction=0.6, noise_peaks=NOISE_PEAKS, seed=7)
    t_ds = time.perf_counter() - t0
    ds_cfg = DSConfig()                     # default adducts, ppm, nlevels
    sm_cfg = SMConfig.from_dict({"fdr": {"decoy_sample_size": 20}})
    search = MSMBasicSearch(ds, truth.formulas, ds_cfg, sm_cfg)
    say(f"  set-up: {ds.n_pixels} pixels, {ds.n_peaks} peaks; dataset "
        f"{t_ds:.1f} s")
    return ds, truth, search, ds_cfg


def phase_main_path(ds, truth, search) -> dict:
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table
    from sm_distributed_tpu_torch.ops.chaos import chaos_count_sums
    from sm_distributed_tpu_torch.ops.moments import batch_moments

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch_moments.launches = 0
    chaos_count_sums.launches = 0
    t0 = time.perf_counter()
    bundle = search.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"moments": batch_moments.launches,
                "chaos": chaos_count_sums.launches}
    peak = torch.cuda.max_memory_allocated()
    table = search.last_table
    n_batches = -(-table.n_ions // search.last_backend.batch)
    tim = bundle.timings
    say(f"  main path: {ds.n_pixels} pixels, {ds.n_peaks} peaks, "
        f"{table.n_ions} ions in {n_batches} batches of "
        f"{search.last_backend.batch}; wall {wall:.3f} s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in tim.items())
        + f"; {table.n_ions / tim['score']:.1f} ions/s scored; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} never launched on the main path"
    ann = bundle.annotations
    hits = set(ann[(ann.adduct == "+H") & (ann.fdr_level <= 0.1)].sf)
    present = [str(sf) for sf in truth.present]
    recall = sum(sf in hits for sf in present) / len(present)
    say(f"  recall of the {len(present)} present (+H) ions at fdr_level "
        f"<= 0.1: {recall:.3f} ({len(ann)} annotations)")
    assert recall >= 0.5, f"recall {recall:.3f} of present ions"
    # batch 0 again: through the kernels (must equal the search's rows),
    # and on its image block through the kernels, the plain chain and an
    # f64 reference of the moments and epilogues
    backend = search.last_backend
    t0 = _slice_table(table, 0, backend.batch)
    rows = bundle.all_metrics[["chaos", "spatial", "spectral", "msm"]]
    assert np.array_equal(backend.score_batch(t0),
                          rows.to_numpy()[:t0.n_ions]), \
        "re-scored batch differs from the search's rows"
    drift = _kernels_vs_plain_chain(backend, t0)
    breakdown = _batch_breakdown(backend, t0)
    say(f"phase 3 main path: {table.n_ions / tim['score']:.1f} ions/s; "
        "batch 0 ulp gaps (kernels-plain, kernels-f64, plain-f64) "
        f"{drift}")
    return {"launches": launches, "ions_per_s": table.n_ions / tim["score"],
            "timings": tim, "peak_bytes": peak, "wall_s": wall,
            "n_ions": table.n_ions, "n_peaks": ds.n_peaks,
            "drift": drift, "recall": recall, "batch_ms": breakdown}


def _batch_breakdown(backend, table) -> dict:
    """Device milliseconds of one full batch's steps (CUDA events, median
    of 3): extraction (bins, scatter-add, banded matmuls), moments kernel,
    chaos kernel, and the whole batch."""
    from sm_distributed_tpu_torch.ops.chaos import chaos_count_sums
    from sm_distributed_tpu_torch.ops.moments import batch_moments

    imgs, _theor, _nv = backend.image_block(table)
    nrows, ncols = backend.grid
    out = {
        "extract": time_ms(lambda: backend.image_block(table), reps=3),
        "moments": time_ms(lambda: batch_moments(imgs, backend.n_real),
                           reps=3),
        "chaos": time_ms(lambda: chaos_count_sums(
            imgs[:, 0, :], nrows, ncols, backend.nlevels), reps=3),
        "batch": time_ms(lambda: backend.score_batch(table), reps=3),
    }
    say("  batch 0 device ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()))
    return out


def _metrics_f64(imgs, theor, n_valid, n_real, chaos) -> torch.Tensor:
    """(b, 4) f64 reference: the moments and epilogues of batch_metrics in
    f64, with the (exact) chaos of the kernel path."""
    from sm_distributed_tpu_torch.ops.metrics import (
        correlation_from_moments,
        isotope_pattern_match_batch,
    )
    from sm_distributed_tpu_torch.ops.moments import batch_moments_torch

    k = imgs.shape[1]
    valid = torch.arange(k, device=imgs.device)[None, :] < n_valid[:, None]
    sums, normsq, dots, vmax, _nn = batch_moments_torch(imgs.double(), n_real)
    theor = theor.double()
    alive = (n_valid > 0) & (vmax > 0)
    zero = torch.zeros((), dtype=torch.float64, device=imgs.device)
    spatial = torch.where(alive, correlation_from_moments(
        normsq, dots, theor, valid), zero)
    spectral = torch.where(alive, isotope_pattern_match_batch(
        sums, theor, valid), zero)
    chaos = chaos.double()
    return torch.stack([chaos, spatial, spectral, chaos * spatial * spectral],
                       dim=1)


def _kernels_vs_plain_chain(backend, table) -> dict:
    """One batch's metrics through the kernels and through the plain chain,
    on the same image block, under the component contracts, ion by ion:
    chaos bit-equal; for spatial, spectral and msm the kernels within the
    ulp contract of the f64 reference, and within the contract of the plain
    chain plus the plain chain's own distance from the reference at that
    ion (its f32 sums drift; see PERF.md), that slack capped at the
    contract itself, so no limit exceeds twice the contract."""
    from sm_distributed_tpu_torch.ops.metrics import batch_metrics

    imgs, theor, n_valid = backend.image_block(table)
    nrows, ncols = backend.grid
    kern = batch_metrics(imgs.clone(), theor, n_valid, nrows, ncols,
                         backend.nlevels, n_real=backend.n_real)
    plain = batch_metrics(imgs.clone(), theor, n_valid, nrows, ncols,
                          backend.nlevels, n_real=backend.n_real, plain=True)
    ref = _metrics_f64(imgs, theor, n_valid, backend.n_real, kern[:, 0])
    assert torch.equal(kern[:, 0], plain[:, 0]), "chaos: kernels vs plain"
    drift = {}
    for col, comp in enumerate(CONTRACT):
        to_ref = ulps(kern[:, col], ref[:, col])
        plain_to_ref = ulps(plain[:, col], ref[:, col])
        to_plain = ulps(kern[:, col], plain[:, col])
        slack = plain_to_ref.clamp(max=CONTRACT[comp])
        gap = (int(to_plain.max()), int(to_ref.max()), int(plain_to_ref.max()))
        assert bool((to_ref <= CONTRACT[comp]).all()), (
            f"{comp}: kernels {gap[1]} ulp from f64")
        bad = to_plain > CONTRACT[comp] + slack
        assert not bool(bad.any()), (
            f"{comp}: {int(bad.sum())} ions past the contract from the plain "
            f"chain (largest gap {gap[0]} ulp)")
        drift[comp] = gap
    return drift


def phase_golden() -> None:
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    golden = json.loads((ROOT / "tests" / "data" /
                         "golden_spheroid.json").read_text())
    with tempfile.TemporaryDirectory() as td:
        path, truth = generate_synthetic_dataset(Path(td), **GOLDEN_GEN)
        ds = SpectralDataset.from_imzml(path)
    worst = 0.0
    for key, adducts in GOLDEN_SECTIONS.items():
        section = golden if key == "root" else golden[key]
        ds_cfg = DSConfig.from_dict(
            {**GOLDEN_DS, "isotope_generation": {"adducts": list(adducts)}})
        bundle = MSMBasicSearch(ds, truth.formulas, ds_cfg,
                                SMConfig.from_dict(GOLDEN_SM)).search()
        got = {(r.sf, r.adduct): r for r in bundle.all_metrics.itertuples()}
        assert len(got) == len(section["all_metrics"]), key
        for w in section["all_metrics"]:
            g = got[(w["sf"], w["adduct"])]
            assert bool(g.is_target) == w["is_target"]
            for col in CONTRACT:
                d = abs(getattr(g, col) - w[col])
                worst = max(worst, d)
                assert d <= 1e-6, f"{key}: {col} of {w['sf']}{w['adduct']}"
        ann, want = bundle.annotations, section["annotations"]
        assert [(r.sf, r.adduct) for r in ann.itertuples()] == [
            (w["sf"], w["adduct"]) for w in want], f"{key}: annotation order"
        assert np.array_equal(ann.fdr.to_numpy(), [w["fdr"] for w in want])
        assert np.array_equal(ann.fdr_level.to_numpy(),
                              [w["fdr_level"] for w in want])
    say(f"phase 5 golden: 32x32 spheroid root and multi_adduct match "
        f"golden_spheroid.json (annotation order and FDR arrays equal, "
        f"metrics within {worst:.2e} <= 1e-6)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "sm_distributed_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the sm_distributed_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    _card, dev = phase_environment()
    phase_build()
    ds, truth, search, ds_cfg = _setup_main_path()
    main = phase_main_path(ds, truth, search)
    backend = search.last_backend
    block, _theor, _n_valid = backend.image_block(
        _slice_table(search.last_table, 0, backend.batch))
    kernels = phase_kernels(dev, block, backend.n_real,
                            ds_cfg.image_generation.nlevels)
    del block
    torch.cuda.empty_cache()
    for entry in kernels:
        entry["launches"] = main["launches"][entry["name"]]
    phase_golden()
    say("main path: " + json.dumps({
        k: main[k] for k in ("ions_per_s", "timings", "peak_bytes", "wall_s",
                             "n_ions", "n_peaks", "drift", "recall",
                             "batch_ms")}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
