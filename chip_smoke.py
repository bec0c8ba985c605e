#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sm_distributed_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sm_distributed_tpu_torch/csrc`` with
nvcc and drives four paths of the library search, each with the kernel
launch counts set to 0 just before it and read just after:

- the main path, the plain flat chain (phases 3-5): 256x256 pixels, 200
  noise peaks a pixel, formula batches of 2048 ions, a cold isotope-pattern
  cache; each kernel held against its plain PyTorch version on its first
  image block, and the 32x32 golden fixture checked against
  ``tests/data/golden_spheroid.json``.  Chaos takes the packed route's
  shared-memory kernel (images of at most 65,536 pixels); phase 4 also
  holds the row-tile kernel that serves larger packed images (512x512, and
  8x36864 with one-row tiles) on random masks and images whose components
  cross the tile seams;
- the fused path (phase 6): the same search with
  ``parallel.fused_metrics="on"``, held against the main path's results, and
  the fused window-moments kernel against its plain version;
- the cube path at the main size (phase 7): the main path's dataset and
  ions with ``parallel.mz_chunk=512``, held ion by ion to the main path's
  results;
- the whole-slide path (phase 8): a 1024x1024 dataset on the m/z-chunked
  cube path (``parallel.mz_chunk=512``), whose chaos takes the row-tile
  kernel on the strips route, held against its plain version and scipy
  (also on a comb and a spiral across the tile seams, and on a 2048x2048
  pair whose seam merge takes the global seam plane); its unmasked moments
  kernel and its metrics held against their plain versions and f64 on the
  path's first batch.

The two moments kernels (``csrc/moments.cu``, ``csrc/fused_moments.cu``) run
one thread-block cluster per ion, planned by ``ops/moments.moments_plan``;
each moments check prints its plan (cluster size, slice, regime), and the
timing lines put each kernel beside its bound, a measured one-read
yardstick (one ``sum(-1)`` over the same block) and the number of clusters
of its plan the card holds at once.

    python3 chip_smoke.py --ab DIR

also times the moments, fused and chaos kernels of another checkout of the
repo at ``DIR`` (its ``sm_distributed_tpu_torch`` built from its own
sources into its own ``build/``) against this one's, in turns (other, this,
this, other), on the same inputs: chaos on the 512x512 masks, the main
path's principal images and the whole-slide batch's.

One line per phase; any failure raises and exits non-zero.  The line before
the last is a JSON object with each kernel's launches on its path, its error
against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
port beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import re
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

# the whole-slide path: a 1024x1024 DESI-like slide on the m/z-chunked cube
# path (mz_chunk = the flat path's BAND_WINDOWS, formula_batch = the JAX
# bench's desi batch), +H only, ~20 formulas with 20 decoys each: 2 batches
WS_SIDE = 1024
WS_NOISE_PEAKS = 200
WS_FORMULAS = 20
WS_PARALLEL = {"mz_chunk": 512, "formula_batch": 256}

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


def time_once(fn) -> tuple[float, object]:
    """Milliseconds of one call of ``fn`` (CUDA events) and its result."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def kernel_split(calls: dict, names) -> dict:
    """Device milliseconds, by kernel, of one run of each of ``calls``
    ({label: fn}), in one torch.profiler session (the CUPTI trace of the
    card): {label: {kernel: ms}} for the kernels whose names contain one of
    ``names``, each call launching ``len(names) - 1`` of them (the row-tile
    kernel and one merge).  Empty when the trace holds another count."""
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls.values():
            fn()
            torch.cuda.synchronize()
    per_call = len(names) - 1
    evs = sorted((e for e in prof.events()
                  if "CUDA" in str(e.device_type)
                  and any(k in e.name for k in names)),
                 key=lambda e: e.time_range.start)
    if len(evs) != per_call * len(calls):
        return {}
    out = {}
    for i, label in enumerate(calls):
        out[label] = {
            next(k for k in names if k in e.name):
                e.time_range.elapsed_us() / 1e3
            for e in evs[i * per_call:(i + 1) * per_call]}
    return out


TILE_KERNELS = ("chaos_tile_kernel", "seam_merge_smem_kernel",
                "seam_merge_plane_kernel")


def _launch_counters() -> dict:
    """Each kernel's launch counter: the wrapper that holds it and its
    attribute.  The packed chaos wrapper counts its two kernels apart (the
    shared-memory kernel, and the row-tile kernel for images past 65,536
    pixels); ``chaos_seam_plane`` counts the row-tile launches, on either
    route, whose seam merge keeps its union-find in a global plane."""
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_strips,
    )
    from sm_distributed_tpu_torch.ops.moments import batch_moments
    from sm_distributed_tpu_torch.ops.score import fused_window_moments

    return {"moments": (batch_moments, "launches"),
            "chaos": (chaos_count_sums, "launches"),
            "chaos_tiles": (chaos_count_sums, "tiled_launches"),
            "chaos_strips": (chaos_count_sums_strips, "launches"),
            "chaos_seam_plane": (chaos_count_sums_strips,
                                 "seam_plane_launches"),
            "fused_window_moments": (fused_window_moments, "launches")}


def reset_launches() -> None:
    for wrapper, attr in _launch_counters().values():
        setattr(wrapper, attr, 0)


def read_launches() -> dict:
    return {k: getattr(w, attr) for k, (w, attr) in _launch_counters().items()}


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


def _ptxas_report(log: str) -> dict:
    """{kernel: (registers, spill store bytes)} from ptxas -v output; the
    moments kernels' template instances named ``name<K,regime>``."""
    out, fn, spill = {}, None, 0
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn, spill = m.group(1), 0
            t = re.match(r"_Z\d+(\w+?)ILi(\d+)ELb(\d)E", fn)
            if t:
                fn = (f"{t.group(1)}<{t.group(2)},"
                      f"{'resident' if t.group(3) == '1' else 'streaming'}>")
            t = re.match(r"_Z(\d+)(\w+)", fn)
            if t and not fn.endswith(">"):
                fn = t.group(2)[:int(t.group(1))]
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out[fn] = (int(m.group(1)), spill)
    return out


def _check_moments_layout() -> None:
    """The cluster kernels' shared-memory layout (``mc_smem_bytes`` in
    csrc/moments_cluster.cuh) is the one ops/moments.py::moments_smem_bytes
    mirrors for the plans."""
    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.ops.moments import moments_smem_bytes

    fn = _build.load("moments").sm_moments_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    for k in (1, 4, 8):
        for sl in (99, 999, 1024, 4096, 16384, 65536):
            for res in (True, False):
                assert fn(k, sl, int(res)) == moments_smem_bytes(k, sl, res), (
                    k, sl, res)


def active_clusters(k: int, plan) -> int:
    """Clusters of a moments plan's shape the card holds at once
    (cudaOccupancyMaxActiveClusters, through csrc/moments.cu)."""
    from sm_distributed_tpu_torch.kernels import _build

    fn = _build.load("moments").sm_moments_active_clusters
    fn.argtypes = [ctypes.c_int] * 4
    return fn(k, plan.cluster, plan.slice_len, int(plan.regime == "resident"))


def phase_build() -> None:
    from sm_distributed_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    took = time.perf_counter() - t0
    regs = {}
    for name, log in _build.build_logs.items():
        rep = _ptxas_report(log)
        if name in ("moments", "fused_moments") and rep:
            # the paths' K = 4 instances, and the largest spill of any K
            worst = max(rep.items(), key=lambda kv: kv[1][1])
            rep = {f: v for f, v in rep.items() if "<4," in f}
            rep["largest spill"] = f"{worst[0]} {worst[1]}"
        regs[name] = rep
    _check_moments_layout()
    say(f"phase 2 build: {took:.2f} s for {', '.join(_build.KERNELS)} "
        f"(nvcc {_build.NVCC_FLAGS}); ptxas (registers, spill store bytes) "
        f"{regs}; cluster layout mirrors ops/moments.py")


def _check_moments(x: torch.Tensor, n_real, exact_sums: bool, label: str):
    """Kernel against the plain version and an f64 reference.  The kernel
    is held to MOMENT_ULPS of the f64 reference, and to MOMENT_ULPS of the
    plain version beyond the plain version's own distance from the f64
    reference: the plain version's f32 sums drift too, and that drift is
    not the kernel's (sums, max and counts are exact where stated)."""
    from sm_distributed_tpu_torch.ops.moments import (
        batch_moments,
        batch_moments_torch,
        moments_plan,
    )

    plan = moments_plan(*x.shape)
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
    say(f"  moments {label} {tuple(x.shape)} n_real={n_real} "
        f"(plan: {plan.cluster} CTAs x {plan.slice_len} px, {plan.regime}"
        f"{'' if x.data_ptr() % 16 == 0 else ', misaligned'}): ulp gap "
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
                 label: str, variant: str, n_scipy: int = 3) -> float:
    """The packed chaos wrapper on ``images`` against the plain version
    (bit-equal) and scipy (the first ``n_scipy``), and the packed kernel it
    launched (``variant``: "smem" or "tiles", by the two counters; for
    "tiles", the seam merge's placement by its plan and counter).
    Returns the plain version's milliseconds."""
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_torch,
        packed_variant,
        tile_plan,
    )

    assert packed_variant(nrows * ncols) == variant
    plane = variant == "tiles" and not tile_plan(nrows, ncols,
                                                 nlevels).seam_in_smem
    reset_launches()
    got = chaos_count_sums(images, nrows, ncols, nlevels)
    ran = read_launches()
    want_ran = {"chaos": int(variant == "smem"),
                "chaos_tiles": int(variant == "tiles"),
                "chaos_strips": 0, "chaos_seam_plane": int(plane)}
    assert {k: ran[k] for k in want_ran} == want_ran, (label, ran)
    plain_ms, want = time_once(
        lambda: chaos_count_sums_torch(images, nrows, ncols, nlevels))
    assert torch.equal(got, want), (
        f"chaos {label}: {int((got != want).sum())} images differ")
    host = images[:n_scipy].cpu().numpy()
    sc = _scipy_count_sums(host, nrows, ncols, nlevels)
    assert got[:n_scipy].cpu().tolist() == [float(v) for v in sc], (
        f"chaos {label}: kernel {got[:n_scipy].tolist()} != scipy {sc}")
    say(f"  chaos {label} ({variant} kernel"
        f"{', global seam plane' if plane else ''}): {images.shape[0]} images "
        f"{nrows}x{ncols}, {nlevels} levels, bit-equal to the plain version, "
        f"first {n_scipy} equal to scipy {sc}")
    return plain_ms


def _check_smem_layout(shapes, levels) -> None:
    """The shared-memory chaos kernel's layout in csrc/chaos.cu is the one
    ops/chaos.py::chaos_smem_bytes mirrors (the CPU tests hold the mirror
    to the card's shared memory per block)."""
    import ctypes

    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.ops.chaos import chaos_smem_bytes

    fn = _build.load("chaos").sm_chaos_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    for r, c in shapes:
        for nl in levels:
            assert fn(r, c, nl) == chaos_smem_bytes(r, c, nl), (r, c, nl)


# shapes whose row-tile plans phase 4 holds to the kernels' layout: the
# whole-slide and 512x512 shapes, the widest strip shape, one-row tiles and
# two plans with the global seam plane
TILE_LAYOUT_SHAPES = ((1024, 1024), (512, 512), (700, 900), (100, 8192),
                      (400, 333), (8, 36864), (2048, 2048))


def _check_tile_layout(levels) -> None:
    """The row-tile kernel's and the seam merge's shared-memory layouts in
    csrc/chaos_strips.cu are the ones ops/chaos.py::tile_plan mirrors."""
    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.ops.chaos import tile_plan

    lib = _build.load("chaos_strips")
    tile_fn = lib.sm_chaos_tile_smem_bytes
    seam_fn = lib.sm_chaos_seam_smem_bytes
    tile_fn.argtypes = [ctypes.c_int] * 3
    seam_fn.argtypes = [ctypes.c_int]
    for r, c in TILE_LAYOUT_SHAPES:
        for nl in levels:
            plan = tile_plan(r, c, nl)
            assert tile_fn(plan.rows, c, nl) == plan.tile_smem_bytes, (
                r, c, nl)
            if plan.seam_in_smem:
                assert seam_fn(plan.seam_nodes) == plan.merge_smem_bytes, (
                    r, c)


def _spiral(n: int) -> np.ndarray:
    """A square spiral of one-pixel lines one pixel apart, walked inwards
    from the top-left corner: one path whose vertical runs cross every
    horizontal tile seam many times."""
    img = np.zeros((n, n), np.float32)
    r = c = 0
    dr, dc = 0, 1
    img[r, c] = 1.0
    while True:
        for _ in range(2):      # straight on, else turn right once
            nr, nc = r + dr, c + dc
            ar, ac = nr + dr, nc + dc
            if 0 <= nr < n and 0 <= nc < n and not img[nr, nc] and not (
                    0 <= ar < n and 0 <= ac < n and img[ar, ac]):
                r, c = nr, nc
                img[r, c] = 1.0
                break
            dr, dc = dc, -dr
        else:
            return img


def _seam_images(nrows: int, ncols: int, dev) -> torch.Tensor:
    """Images whose components cross tile seams: a comb (teeth on the even
    columns joined only by the last row, so the teeth meet in the last
    tile), the same comb at graded heights (teeth split across levels), and
    for square shapes a spiral and a spiral at graded heights."""
    comb = np.zeros((nrows, ncols), np.float32)
    comb[:, ::2] = 1.0
    comb[-1, :] = 1.0
    grade = (np.arange(nrows * ncols, dtype=np.float32).reshape(nrows, ncols)
             % 7 + 1) / 7
    stack = [comb, comb * grade]
    if nrows == ncols:
        spiral = _spiral(nrows)
        stack += [spiral, spiral * grade]
    return torch.from_numpy(np.stack(stack).reshape(len(stack), -1)).to(dev)


def _blob_images(n: int, side: int, dev, gen) -> torch.Tensor:
    """n smooth side x side images: bicubic upsampling of 24x24 uniform
    noise, shifted down so ~30% of the pixels are 0.  Their level sets are
    large nested components, the opposite of random masks."""
    coarse = torch.rand(n, 1, 24, 24, device=dev, generator=gen)
    up = torch.nn.functional.interpolate(coarse, size=(side, side),
                                         mode="bicubic", align_corners=False)
    return (up - 0.35).clamp(min=0).reshape(n, -1).contiguous()


def _edge_images(side: int, dev) -> torch.Tensor:
    """Four side x side images: all positive (one component, the longest
    chains), a checkerboard (the most components, no links), a serpentine
    through every row, and one with only the last pixel set."""
    ones = np.ones((side, side), np.float32)
    checker = (np.indices((side, side)).sum(axis=0) % 2).astype(np.float32)
    last = np.zeros((side, side), np.float32)
    last[-1, -1] = 1.0
    stack = np.stack([ones, checker, _serpentine(side, side), last])
    return torch.from_numpy(stack.reshape(4, -1)).to(dev)


def _time_turns(fn_a, fn_b, reps: int) -> tuple[float, float]:
    """Milliseconds of two versions timed in turns (a, b, b, a): the mean
    of each one's two medians."""
    a1 = time_ms(fn_a, reps=reps)
    b1 = time_ms(fn_b, reps=reps)
    b2 = time_ms(fn_b, reps=reps)
    a2 = time_ms(fn_a, reps=reps)
    return (a1 + a2) / 2, (b1 + b2) / 2


def _random_images(n: int, p: int, dev, gen) -> torch.Tensor:
    dens = torch.rand(n, 1, device=dev, generator=gen) * 0.8 + 0.1
    vals = torch.rand(n, p, device=dev, generator=gen)
    keep = torch.rand(n, p, device=dev, generator=gen) < dens
    return torch.where(keep, vals, torch.zeros((), device=dev))


def phase_kernels(dev, block: torch.Tensor, n_real, nlevels: int,
                  ab=None) -> list:
    """Kernels against their plain versions on the card, at the main path's
    shapes: ``block`` is the first (2048, 4, 65536) image block of the main
    path's dataset, as the metrics receive it.  ``ab``: another checkout's
    port (``--ab``), timed in turns against this one."""
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_strips,
    )
    from sm_distributed_tpu_torch.ops.moments import (
        batch_moments,
        batch_moments_torch,
        moments_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(11)
    n, k, p = block.shape
    # --- moments (kernels 1 and 2: masked and unmasked), resident regime
    # at the main shape, and every edge of the cluster split ---
    grid = (torch.randint(0, 256, (n, k, p), device=dev, generator=gen)
            .float() * (torch.rand(n, k, p, device=dev, generator=gen) < 0.3))
    slice0 = moments_plan(n, k, p).slice_len
    err = 0.0
    err = max(err, _check_moments(grid, p - 256, True, "integer grid masked"))
    err = max(err, _check_moments(grid, None, True, "integer grid unmasked"))
    err = max(err, _check_moments(grid, slice0 + 904, True,
                                  "integer grid, n_real in slice 1"))
    err = max(err, _check_moments(grid, 1, True, "integer grid, n_real 1"))
    buf = torch.empty(64 * k * p + 1, device=dev)
    mis = buf[1:].view(64, k, p)            # contiguous, 4 bytes off 16
    mis.copy_(grid[:64])
    err = max(err, _check_moments(mis, p - 3000, True, "misaligned view"))
    err = max(err, _check_moments(mis, None, True, "misaligned view"))
    del grid, mis, buf
    err = max(err, _check_moments(block, n_real, False, "main-path block"))
    for shape, nr in (((5, 3, 999), 990), ((5, 3, 999), None),
                      ((2, 1, 99), 1), ((2, 1, 99), None),
                      ((64, 8, 65536), 65000), ((64, 8, 65536), None),
                      ((256, 1, 65536), 20000), ((256, 1, 65536), None)):
        # values below 256: row sums stay below 2**24 at 65,536 pixels
        edge = (torch.randint(0, 256, shape, device=dev, generator=gen)
                .float() * (torch.rand(shape, device=dev, generator=gen) < .5))
        err = max(err, _check_moments(edge, nr, True, "edge block"))
    # streaming regime (values below 16, so row sums stay below 2**24 and
    # the plain version's f32 sums are exact too): n_real in slice 3, and a
    # P that is not a multiple of 4 (4-byte loads)
    for shape, nr in (((8, 4, 1 << 20), 3 * (1 << 16) + 1000),
                      ((8, 4, 1 << 20), None), ((4, 3, 1000003), 999000)):
        edge = (torch.randint(0, 16, shape, device=dev, generator=gen)
                .float() * (torch.rand(shape, device=dev, generator=gen) < .3))
        err = max(err, _check_moments(edge, nr, True, "streaming block"))
    del edge
    mom_ms = time_ms(lambda: batch_moments(block, n_real))
    mom_unmasked_ms = time_ms(lambda: batch_moments(block, None))
    mom_plain_ms = time_ms(lambda: batch_moments_torch(block, n_real), reps=3)
    mom_unmasked_plain_ms = time_ms(lambda: batch_moments_torch(block, None),
                                    reps=3)
    one_read_ms = time_ms(lambda: block.sum(-1))
    mom_bytes = block.numel() * 4 + n * k * 5 * 4
    # per element: 1 f32 sub + 2 f32 mul (centered terms) and 3 f64 adds
    mom_bound, mom_by = bound_ms(
        mom_bytes, 3 * block.numel() / F32_OPS_PER_S
        + 3 * block.numel() / F64_OPS_PER_S)
    plan = moments_plan(n, k, p)
    say(f"  moments times: kernel {mom_ms:.3f} ms masked, "
        f"{mom_unmasked_ms:.3f} ms unmasked; plain {mom_plain_ms:.3f} ms "
        f"masked, {mom_unmasked_plain_ms:.3f} ms unmasked; bound "
        f"{mom_bound:.3f} ms ({mom_by}, {mom_bound / mom_ms:.1%} of it); "
        f"one-read yardstick block.sum(-1) {one_read_ms:.3f} ms; plan "
        f"{plan.cluster} CTAs x {plan.slice_len} px {plan.regime}, "
        f"{active_clusters(k, plan)} clusters resident at once")
    if ab is not None:
        for masked_nr, label in ((n_real, "masked"), (None, "unmasked")):
            old_ms, new_ms = _time_turns(
                lambda: ab.moments.batch_moments(block, masked_nr),
                lambda: batch_moments(block, masked_nr), reps=10)
            say(f"  moments in turns against {ab.root} ({label}, main "
                f"block): other {old_ms:.3f} ms, this {new_ms:.3f} ms")
        want = batch_moments(block, n_real)
        other = ab.moments.batch_moments(block, n_real)
        assert all(torch.equal(a, b) for i, (a, b) in
                   enumerate(zip(want, other)) if i in (0, 3, 4))

    # --- chaos (kernel 3, packed route): the shared-memory kernel up to
    # 65,536 pixels, the row-tile kernel of csrc/chaos_strips.cu above ---
    principal = block[:, 0, :]                 # the main path's strided view
    side = int(round(p ** 0.5))
    _check_smem_layout(((side, side), (32, 32), (9, 11), (1, 4096)),
                       (1, nlevels, 255))
    _check_tile_layout((1, nlevels, 255))
    ch_plain_ms = _check_chaos(principal, side, side, nlevels,
                               "main-path principal", "smem")
    _check_chaos(_random_images(256, side * side, dev, gen), side, side,
                 nlevels, "random masks", "smem")
    edges = _edge_images(side, dev)
    _check_chaos(edges, side, side, nlevels, "edge images", "smem",
                 n_scipy=4)
    edge_sums = chaos_count_sums(edges, side, side, nlevels).tolist()
    assert edge_sums == [nlevels, side * side // 2 * nlevels, nlevels,
                         nlevels], edge_sums
    _check_chaos(_random_images(16, side * side, dev, gen), side, side, 255,
                 "random masks", "smem")
    _check_chaos(_random_images(64, 32 * 32, dev, gen), 32, 32, nlevels,
                 "random batch", "smem")
    _check_chaos(_random_images(64, 9 * 11, dev, gen), 9, 11, nlevels,
                 "random batch", "smem")
    masks512 = _random_images(64, 512 * 512, dev, gen)
    g512_plain_ms = _check_chaos(masks512, 512, 512, nlevels, "random masks",
                                 "tiles")
    up = principal[:64].reshape(64, side, side).repeat_interleave(
        2, dim=1).repeat_interleave(2, dim=2).reshape(64, -1)
    _check_chaos(up, 2 * side, 2 * side, nlevels, "principal upsampled 2x",
                 "tiles")
    _check_chaos(_random_images(8, 512 * 512, dev, gen), 512, 512, 255,
                 "random masks", "tiles")
    # one-row tiles: the packed shape 8x36864 (its seam merge's 294,912
    # nodes take the global seam plane)
    _check_chaos(_random_images(16, 8 * 36864, dev, gen), 8, 36864, nlevels,
                 "random masks, one-row tiles", "tiles")
    _check_chaos(_seam_images(8, 36864, dev), 8, 36864, nlevels,
                 "comb and spiral, one-row tiles", "tiles", n_scipy=2)
    _check_chaos(_seam_images(512, 512, dev), 512, 512, nlevels,
                 "comb and spiral", "tiles", n_scipy=2)
    # an odd width: 4-byte loads, and 1,998 seam nodes (the merge's last
    # word of four nodes padded)
    _check_chaos(_random_images(16, 400 * 333, dev, gen), 400, 333, nlevels,
                 "random masks, odd width", "tiles")
    _check_chaos(_seam_images(400, 333, dev), 400, 333, nlevels,
                 "comb, odd width", "tiles", n_scipy=2)
    # the row-tile kernel on the main path's images: one tile an image
    assert torch.equal(
        chaos_count_sums_strips(principal, side, side, nlevels),
        chaos_count_sums(principal, side, side, nlevels))
    strips_ms = time_ms(lambda: chaos_count_sums_strips(
        principal, side, side, nlevels), reps=5)
    ch_ms = time_ms(lambda: chaos_count_sums(principal, side, side, nlevels),
                    reps=5)
    g512_ms = time_ms(lambda: chaos_count_sums(masks512, 512, 512, nlevels),
                      reps=5)
    # the byte floor: the union-find's compares and atomics are integer
    # work whose count depends on the images, which no peak rate models
    ch_bytes = principal.shape[0] * (p * 4 + nlevels * 4 + 4)
    ch_bound, ch_by = bound_ms(ch_bytes, 0.0)
    g512_bound, g512_by = bound_ms(
        masks512.shape[0] * (512 * 512 * 4 + nlevels * 4 + 4), 0.0)
    n_px = principal.shape[0] * p
    say(f"  chaos times on the {principal.shape[0]} main-path principal "
        f"images: shared-memory kernel {ch_ms:.3f} ms "
        f"({ch_ms * 1e6 / n_px:.4f} ns a pixel), row-tile kernel (one tile "
        f"an image) {strips_ms:.3f} ms ({strips_ms * 1e6 / n_px:.4f} ns a "
        f"pixel); plain {ch_plain_ms:.3f} ms; byte floor {ch_bound:.3f} ms")
    say(f"  chaos times on {masks512.shape[0]} random 512x512 masks: "
        f"row-tile kernel {g512_ms:.3f} ms "
        f"({g512_ms * 1e6 / masks512.numel():.4f} ns a pixel; "
        f"{g512_bound / g512_ms:.2%} of its bound), plain "
        f"{g512_plain_ms:.3f} ms, byte floor {g512_bound:.3f} ms")
    if ab is not None:
        assert torch.equal(ab.chaos.chaos_count_sums(masks512, 512, 512,
                                                     nlevels),
                           chaos_count_sums(masks512, 512, 512, nlevels))
        old_ms, new_ms = _time_turns(
            lambda: ab.chaos.chaos_count_sums(masks512, 512, 512, nlevels),
            lambda: chaos_count_sums(masks512, 512, 512, nlevels), reps=5)
        say(f"  chaos in turns against {ab.root} (64 random 512x512 "
            f"masks): other {old_ms:.3f} ms, this {new_ms:.3f} ms")
        old_ms, new_ms = _time_turns(
            lambda: ab.chaos.chaos_count_sums(principal, side, side, nlevels),
            lambda: chaos_count_sums(principal, side, side, nlevels), reps=5)
        say(f"  chaos in turns against {ab.root} (main-path principal, "
            f"shared-memory kernel): other {old_ms:.3f} ms, this "
            f"{new_ms:.3f} ms")
    say("phase 4 kernels: moments within "
        f"{MOMENT_ULPS} ulp of f64 and of the plain version beyond its own "
        "drift (sums/max/counts exact on the integer grid), both packed chaos "
        "kernels bit-equal to the plain version and scipy")
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
        {"name": "chaos_tiles", "route": "cuda",
         "source": "sm_distributed_tpu_torch/csrc/chaos_strips.cu",
         "replaces": "sm_distributed_tpu/ops/chaos_pallas.py:284",
         "max_abs_err": 0.0, "ms": g512_ms, "plain_ms": g512_plain_ms,
         "bound_ms": g512_bound, "bound_by": g512_by, "library_ms": None},
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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    bundle = search.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
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
    assert launches["moments"] > 0, "moments kernel never launched"
    assert launches["chaos"] == n_batches and launches["chaos_tiles"] == 0 \
        and launches["chaos_strips"] == 0, (
            f"chaos: the shared-memory kernel must run once a batch and the "
            f"row-tile kernel never: {launches}")
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
            "drift": drift, "recall": recall, "batch_ms": breakdown,
            "bundle": bundle}


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


def _search_rows(bundle) -> np.ndarray:
    return bundle.all_metrics[list(CONTRACT)].to_numpy().astype(np.float32)


def _hold_to_main(bundle, ref, label: str) -> dict:
    """Another path's search of the main path's dataset and ions against
    the main path's: the same ions in the same order, the same annotations
    and FDR arrays, and ion by ion chaos bit-equal and spatial, spectral
    and msm within the contracts.  Returns the largest ulp gap of each."""
    got_m, ref_m = bundle.all_metrics, ref.all_metrics
    assert got_m.sf.tolist() == ref_m.sf.tolist() and \
        got_m.adduct.tolist() == ref_m.adduct.tolist(), \
        f"{label}: the ion rows differ from the main path's"
    got_rows = torch.from_numpy(_search_rows(bundle))
    ref_rows = torch.from_numpy(_search_rows(ref))
    gaps = {}
    for col, comp in enumerate(CONTRACT):
        gap = ulps(got_rows[:, col], ref_rows[:, col])
        bad = torch.nonzero(gap > CONTRACT[comp]).flatten()[:5].tolist()
        assert not bad, (
            f"{label}: {int((gap > CONTRACT[comp]).sum())} ions' {comp} past "
            f"{CONTRACT[comp]} ulp from the main path, e.g. "
            + "; ".join(f"{ref_m.sf.iloc[i]}{ref_m.adduct.iloc[i]} "
                        f"{got_rows[i].tolist()} vs {ref_rows[i].tolist()}"
                        for i in bad))
        gaps[comp] = int(gap.max())
    ann, ref_ann = bundle.annotations, ref.annotations
    assert [(r.sf, r.adduct) for r in ann.itertuples()] == [
        (r.sf, r.adduct) for r in ref_ann.itertuples()], \
        f"{label}: annotation order differs from the main path"
    assert np.array_equal(ann.fdr.to_numpy(), ref_ann.fdr.to_numpy())
    assert np.array_equal(ann.fdr_level.to_numpy(),
                          ref_ann.fdr_level.to_numpy())
    return gaps


def _band_rows(starts, r_lo_loc, r_hi_loc, cols: int, gc_width: int
               ) -> tuple[int, int]:
    """(distinct histogram rows the plan's windows cover, their sum over
    windows): the rows the fused kernel reads, clipped to each chunk's band
    as the plain chain clips them."""
    rlo = r_lo_loc.cpu().numpy().astype(np.int64)
    rhi = r_hi_loc.cpu().numpy().astype(np.int64)
    st = np.asarray(starts, dtype=np.int64)
    st_eff = np.minimum(st, cols - (gc_width + 2))
    shift = (st - st_eff)[:, None]
    g0 = np.maximum(rlo + shift + 1, 0) + st_eff[:, None]
    g1 = np.minimum(rhi + shift, gc_width + 1) + st_eff[:, None]
    n = np.maximum(g1 - g0 + 1, 0).ravel()
    covered = np.zeros(cols, dtype=bool)
    for a, m in zip(g0.ravel()[n > 0], n[n > 0]):
        covered[a:a + m] = True
    return int(covered.sum()), int(n.sum())


def _histogram_block(backend, table) -> tuple:
    """``(whp, starts, r_lo_loc, r_hi_loc, n_real, gc_width)`` of one flat
    batch as the fused kernel receives them in ``score_flat_fused``: the
    (cols, P) histogram rows (P row-bucketed), the host chunk offsets, the
    device rank bounds at the sticky band width and the real pixel count."""
    from sm_distributed_tpu_torch.ops.imager import flat_histogram

    d = backend._device_plan(table)
    n_pix = backend.grid[0] * backend.grid[1]
    wh = flat_histogram(backend._px_s, backend._in_s, d["pos"],
                        gc_width=d["gc_width"], n_pixels=n_pix)
    return (wh[:, :n_pix], d["starts"], d["r_lo_loc"], d["r_hi_loc"],
            backend.n_real or n_pix, d["gc_width"])


def phase_fused(ds, truth, search, ds_cfg, main: dict,
                ab=None) -> tuple[dict, dict]:
    """The main path's search again with ``fused_metrics="on"``: the fused
    window-moments kernel on every batch, results held to the main path's
    rows, and the kernel against its plain version on batch 0 (and, with
    ``ab``, against another checkout's kernel in turns)."""
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.ops.imager import banded_images
    from sm_distributed_tpu_torch.ops.moments import (
        batch_moments,
        batch_moments_torch,
        moments_plan,
    )
    from sm_distributed_tpu_torch.ops.score import (
        fused_window_moments,
        fused_window_moments_torch,
    )
    from sm_distributed_tpu_torch.utils.config import SMConfig

    t_start = time.perf_counter()
    fused = MSMBasicSearch(ds, truth.formulas, ds_cfg, SMConfig.from_dict(
        {"fdr": {"decoy_sample_size": 20},
         "parallel": {"fused_metrics": "on"}}))
    fused.isocalc = search.isocalc       # the main path's warm patterns
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    bundle = fused.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    table, backend = fused.last_table, fused.last_backend
    n_batches = -(-table.n_ions // backend.batch)
    tim = bundle.timings
    say(f"  fused path: {table.n_ions} ions in {n_batches} batches; wall "
        f"{wall:.3f} s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in tim.items())
        + f"; {table.n_ions / tim['score']:.1f} ions/s scored; peak device "
        f"memory {peak / 2**30:.2f} GiB (main path "
        f"{main['peak_bytes'] / 2**30:.2f} GiB); launches {launches}")
    assert launches["fused_window_moments"] == n_batches, launches
    assert launches["moments"] == 0 and launches["chaos"] == n_batches
    assert launches["chaos_tiles"] == 0 and launches["chaos_strips"] == 0, \
        launches
    gaps = _hold_to_main(bundle, main["bundle"], "fused path")

    # batch 0: the kernel against its plain version and f64
    t_b0 = _slice_table(table, 0, backend.batch)
    k = t_b0.max_peaks
    whp, starts, rlo, rhi, n_real, gc = _histogram_block(backend, t_b0)
    args = (whp, starts, rlo, rhi, n_real)
    got = fused_window_moments(*args, gc_width=gc, k=k)
    want = fused_window_moments_torch(*args, gc_width=gc, k=k)
    block = banded_images(whp, starts, rlo, rhi, gc_width=gc).view(
        -1, k, whp.shape[1])
    ref64 = [r.float() for r in batch_moments_torch(block.double(), n_real)]
    torch.cuda.synchronize()
    gp, wp = got[0].view(-1, k, 5), want[0].view(-1, k, 5)
    assert torch.equal(got[1], want[1]), "fused: principal rows differ"
    for i, name in ((0, "sums"), (3, "vmax"), (4, "nn")):
        assert torch.equal(gp[..., i], wp[..., i]), f"fused: {name} differ"
    scale = torch.sqrt((ref64[1][:, 0:1] * ref64[1]).clamp(min=0))
    mom_gaps = {}
    for name, i, dist in (("normsq", 1, ulps),
                          ("dots", 2, lambda a, b: ulps_at(a - b, scale))):
        to_ref = dist(gp[..., i], ref64[i])
        plain_to_ref = dist(wp[..., i], ref64[i])
        to_plain = dist(gp[..., i], wp[..., i])
        assert float(to_ref.max()) <= MOMENT_ULPS, (
            f"fused: {name} {float(to_ref.max())} ulp from f64")
        assert bool((to_plain <= MOMENT_ULPS + plain_to_ref).all()), (
            f"fused: {name} {float(to_plain.max())} ulp from plain")
        mom_gaps[name] = (float(to_plain.max()), float(to_ref.max()),
                          float(plain_to_ref.max()))
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    kern_ms = time_ms(lambda: fused_window_moments(*args, gc_width=gc, k=k))
    plain_ms = time_ms(lambda: fused_window_moments_torch(
        *args, gc_width=gc, k=k), reps=3)
    # context, not a yardstick: the plain chain's steps the kernel replaces
    matmul_ms = time_ms(lambda: banded_images(whp, starts, rlo, rhi,
                                              gc_width=gc), reps=3)
    block = block.contiguous()
    mom_ms = time_ms(lambda: batch_moments(block, backend.n_real), reps=3)
    del block
    hist_ms = time_ms(lambda: _histogram_block(backend, t_b0), reps=3)
    batch_ms = time_ms(lambda: backend.score_batch(t_b0), reps=3)
    n_win, p = rlo.numel(), whp.shape[1]
    rows, row_reads = _band_rows(starts, rlo, rhi, whp.shape[0], gc)
    n_bytes = (rows * p * 4 + got[1].numel() * 4 + got[0].numel() * 4
               + 3 * rlo.numel() * 4)
    # per (window, pixel): its band rows added once, then max, compare,
    # subtract and two multiplies in f32 and three f64 adds
    f32_ops = (row_reads + 5 * n_win) * p
    f64_ops = 3 * n_win * p
    bound, by = bound_ms(n_bytes, f32_ops / F32_OPS_PER_S
                         + f64_ops / F64_OPS_PER_S)
    say(f"  fused kernel batch 0 ({n_win} windows x {p} pixels, "
        f"{rows} band rows): principal rows, sums, vmax, nn bit-equal to "
        "the plain version; ulp gap (kernel-plain, kernel-f64, plain-f64) "
        + ", ".join(f"{k_} {v[0]:.0f}/{v[1]:.0f}/{v[2]:.0f}"
                    for k_, v in mom_gaps.items())
        + f"; max abs err vs plain {err}")
    one_read_ms = time_ms(lambda: whp.sum(-1))
    plan = moments_plan(n_win // k, k, p)
    say(f"  fused times: kernel {kern_ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound:.3f} ms ({by}, {bound / kern_ms:.1%} of it); "
        f"one-read yardstick whp.sum(-1) {one_read_ms:.3f} ms over "
        f"{whp.shape[0]} rows ({whp.shape[0] * p * 4 / 1e9:.3f} GB; the "
        f"kernel reads {rows}); plan {plan.cluster} CTAs x {plan.slice_len} "
        f"px {plan.regime}, whp row stride {whp.stride(0)}; plain-chain "
        f"steps it replaces: banded matmuls {matmul_ms:.3f} ms + moments "
        f"kernel {mom_ms:.3f} ms; batch 0 device ms: histogram (with host "
        f"plan) {hist_ms:.3f}, batch {batch_ms:.3f}")
    if ab is not None:
        other = ab.score.fused_window_moments(*args, gc_width=gc, k=k)
        assert torch.equal(other[1], got[1])
        old_ms, new_ms = _time_turns(
            lambda: ab.score.fused_window_moments(*args, gc_width=gc, k=k),
            lambda: fused_window_moments(*args, gc_width=gc, k=k), reps=10)
        say(f"  fused kernel in turns against {ab.root} (batch 0): other "
            f"{old_ms:.3f} ms, this {new_ms:.3f} ms")
    say(f"phase 6 fused path: {time.perf_counter() - t_start:.1f} s; "
        "fused kernel launched once per batch, FDR ranks identical to the "
        "main path, per-ion ulp gaps to the main path " + json.dumps(gaps))
    entry = {"name": "fused_window_moments", "route": "cuda",
             "source": "sm_distributed_tpu_torch/csrc/fused_moments.cu",
             "replaces": "sm_distributed_tpu/ops/score_pallas.py:250",
             "launches": launches["fused_window_moments"],
             "max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": by, "library_ms": None}
    summary = {"wall_s": wall, "timings": tim, "peak_bytes": peak,
               "ions_per_s": table.n_ions / tim["score"],
               "ulp_to_main": gaps, "moments_gaps": mom_gaps,
               "batch_ms": {"histogram": hist_ms, "kernel": kern_ms,
                            "batch": batch_ms,
                            "replaced_matmuls": matmul_ms,
                            "replaced_moments": mom_ms}}
    return entry, summary


def phase_cube_main(ds, truth, search, ds_cfg, main: dict) -> dict:
    """The main path's dataset and ions on the m/z-chunked cube path
    (``mz_chunk`` as on the whole-slide path): off the row lattice, so the
    moments kernel runs unmasked; chaos takes the packed kernel at this
    size.  Held ion by ion to the main path's rows."""
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import SMConfig

    t_start = time.perf_counter()
    cube = MSMBasicSearch(ds, truth.formulas, ds_cfg, SMConfig.from_dict(
        {"fdr": {"decoy_sample_size": 20},
         "parallel": {"mz_chunk": WS_PARALLEL["mz_chunk"]}}))
    cube.isocalc = search.isocalc        # the main path's warm patterns
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    bundle = cube.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    table, backend = cube.last_table, cube.last_backend
    n_batches = -(-table.n_ions // backend.batch)
    tim = bundle.timings
    say(f"  cube path, main dataset: {table.n_ions} ions in {n_batches} "
        f"batches of {backend.batch}, mz_chunk {backend.mz_chunk}; wall "
        f"{wall:.3f} s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in tim.items())
        + f"; peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    assert backend.mz_chunk and backend.n_real is None
    assert launches["moments"] == n_batches, launches
    assert launches["chaos"] == n_batches, launches
    assert launches["chaos_tiles"] == 0, launches
    assert launches["chaos_strips"] == 0 and launches["fused_window_moments"] == 0
    gaps = _hold_to_main(bundle, main["bundle"], "cube path")
    say(f"phase 7 cube path on the main dataset: "
        f"{time.perf_counter() - t_start:.1f} s; unmasked moments and packed "
        "chaos kernels launched once per batch, FDR ranks identical to the "
        "main path, per-ion ulp gaps to the main path " + json.dumps(gaps))
    return {"wall_s": wall, "timings": tim, "peak_bytes": peak,
            "launches": launches, "ulp_to_main": gaps}


def _kernels_vs_f64(backend, imgs, theor, n_valid) -> tuple[dict, torch.Tensor]:
    """One batch's metrics through the kernels against the f64 reference of
    the moments and epilogues (with the kernels' chaos, which is held to
    the plain version on its own): spatial, spectral and msm within the
    contracts, ion by ion.  Returns the largest ulp gap of each, and the
    kernels' (b, 4) metrics."""
    from sm_distributed_tpu_torch.ops.metrics import batch_metrics

    nrows, ncols = backend.grid
    kern = batch_metrics(imgs.clone(), theor, n_valid, nrows, ncols,
                         backend.nlevels, n_real=backend.n_real)
    ref = _metrics_f64(imgs, theor, n_valid, backend.n_real, kern[:, 0])
    gaps = {}
    for col, comp in list(enumerate(CONTRACT))[1:]:
        gap = ulps(kern[:, col], ref[:, col])
        assert int(gap.max()) <= CONTRACT[comp], (
            f"{comp}: kernels {int(gap.max())} ulp from f64")
        gaps[comp] = int(gap.max())
    del ref
    return gaps, kern


def _serpentine(r: int, c: int) -> np.ndarray:
    """One path through the whole image: rows joined at alternate ends."""
    img = np.zeros((r, c), np.float32)
    img[::2, :] = 1.0
    for row in range(1, r, 2):
        img[row, c - 1 if (row // 2) % 2 == 0 else 0] = 1.0
    return img


def phase_whole_slide(dev, nlevels: int, ab=None) -> tuple[dict, dict]:
    """A 1024x1024 slide on the m/z-chunked cube path: chaos takes the
    row-tile kernel, held against its plain version and scipy; the unmasked
    moments kernel in its streaming regime on the path's own block."""
    from sm_distributed_tpu_torch.io.fixtures import (
        expand_formula_list,
        synthetic_dataset_arrays,
    )
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_strips,
        chaos_count_sums_torch,
        chaos_route,
    )
    from sm_distributed_tpu_torch.ops.moments import (
        batch_moments,
        moments_plan,
    )
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    t_start = time.perf_counter()
    ds, truth = synthetic_dataset_arrays(
        WS_SIDE, WS_SIDE, formulas=expand_formula_list(WS_FORMULAS),
        present_fraction=0.6, noise_peaks=WS_NOISE_PEAKS, seed=7)
    t_ds = time.perf_counter() - t_start
    ds_cfg = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    search = MSMBasicSearch(ds, truth.formulas, ds_cfg, SMConfig.from_dict(
        {"fdr": {"decoy_sample_size": 20}, "parallel": WS_PARALLEL}))
    say(f"  whole-slide set-up: {ds.nrows}x{ds.ncols} pixels, {ds.n_peaks} "
        f"peaks ({WS_NOISE_PEAKS} noise peaks a pixel); dataset {t_ds:.1f} s")
    route = chaos_route(ds.nrows, ds.ncols)
    assert route == "strips", f"{ds.nrows}x{ds.ncols} routes to {route}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    bundle = search.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    table, backend = search.last_table, search.last_backend
    n_batches = -(-table.n_ions // backend.batch)
    tim = bundle.timings
    say(f"  whole-slide path: {table.n_ions} ions in {n_batches} batches of "
        f"{backend.batch}, mz_chunk {backend.mz_chunk}; wall {wall:.3f} s; "
        "phases " + ", ".join(f"{k} {v:.3f} s" for k, v in tim.items())
        + f"; {table.n_ions / tim['score']:.1f} ions/s scored; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    assert n_batches >= 2
    assert launches["chaos_strips"] >= n_batches, launches
    assert launches["moments"] >= n_batches, launches
    assert launches["chaos"] == 0 and launches["fused_window_moments"] == 0
    assert launches["chaos_tiles"] == 0, launches
    # 1024x1024: the seam merge's 32,768 nodes fit its shared memory
    assert launches["chaos_seam_plane"] == 0, launches
    ann = bundle.annotations
    hits = set(ann[(ann.adduct == "+H") & (ann.fdr_level <= 0.1)].sf)
    present = [str(sf) for sf in truth.present]
    recall = sum(sf in hits for sf in present) / len(present)
    say(f"  recall of the {len(present)} present (+H) ions at fdr_level "
        f"<= 0.1: {recall:.3f} ({len(ann)} annotations)")
    assert recall >= 0.5, f"whole-slide recall {recall:.3f}"

    # batch 0: the unmasked moments kernel against its plain version and
    # f64 on the path's own block (a million pixels a row: row sums pass
    # 2**24), the metrics against f64 and the search's rows, the step
    # times, then the row-tile kernel on the principal images
    t_b0 = _slice_table(table, 0, backend.batch)
    imgs, theor, n_valid = backend.image_block(t_b0)
    mom_err = _check_moments(imgs, None, False, "whole-slide block")
    metric_gaps, kern = _kernels_vs_f64(backend, imgs, theor, n_valid)
    rows = bundle.all_metrics[list(CONTRACT)].to_numpy()[:t_b0.n_ions]
    assert np.array_equal(kern[:t_b0.n_ions].double().cpu().numpy(), rows), \
        "whole-slide: the checked block's metrics differ from the search's"
    del kern, theor, n_valid
    say(f"  whole-slide batch 0: metrics of the checked block equal the "
        f"search's rows; kernels' ulp gaps to f64 {json.dumps(metric_gaps)}")
    extract_ms = time_ms(lambda: backend.image_block(t_b0), reps=3,
                         warmup=1)
    nrows, ncols = backend.grid
    principal = imgs[:, 0, :]
    mom_ms = time_ms(lambda: batch_moments(imgs, None), reps=3)
    mom_sum_ms = time_ms(lambda: imgs.sum(-1), reps=3)
    # the bound from the block's own bytes (one read, the (n, k, 5) rows
    # written); the streaming regime reads it twice
    mom_bound, mom_by = bound_ms(imgs.numel() * 4 + imgs.shape[0]
                                 * imgs.shape[1] * 5 * 4, 0.0)
    ws_plan = moments_plan(*imgs.shape)
    say(f"  whole-slide moments (unmasked, plan {ws_plan.cluster} CTAs x "
        f"{ws_plan.slice_len} px {ws_plan.regime}, "
        f"{active_clusters(imgs.shape[1], ws_plan)} clusters resident at "
        f"once): kernel {mom_ms:.3f} ms, bound {mom_bound:.3f} ms ({mom_by}, "
        f"one read; {mom_bound / mom_ms:.1%} of it), one-read yardstick "
        f"imgs.sum(-1) {mom_sum_ms:.3f} ms")
    if ab is not None:
        old_ms, new_ms = _time_turns(
            lambda: ab.moments.batch_moments(imgs, None),
            lambda: batch_moments(imgs, None), reps=3)
        say(f"  whole-slide moments in turns against {ab.root}: other "
            f"{old_ms:.3f} ms, this {new_ms:.3f} ms")
    kern_ms = time_ms(lambda: chaos_count_sums_strips(
        principal, nrows, ncols, nlevels), reps=3)
    got = chaos_count_sums_strips(principal, nrows, ncols, nlevels)
    plain_ms, want = time_once(lambda: chaos_count_sums_torch(
        principal, nrows, ncols, nlevels))
    assert torch.equal(got, want), (
        f"strips: {int((got != want).sum())} principal images differ")
    sc = _scipy_count_sums(principal[:3].cpu().numpy(), nrows, ncols, nlevels)
    assert got[:3].cpu().tolist() == [float(v) for v in sc], (got[:3], sc)
    if ab is not None:
        assert torch.equal(ab.chaos.chaos_count_sums_strips(
            principal, nrows, ncols, nlevels), got)
        old_ms, new_ms = _time_turns(
            lambda: ab.chaos.chaos_count_sums_strips(principal, nrows, ncols,
                                                     nlevels),
            lambda: chaos_count_sums_strips(principal, nrows, ncols,
                                            nlevels), reps=3)
        say(f"  whole-slide chaos (strips route) in turns against {ab.root}: "
            f"other {old_ms:.3f} ms, this {new_ms:.3f} ms")
    n_img, p = principal.shape
    # the split of the row-tile kernel's time between its two kernels, on
    # this batch, 256 smooth blobs and 64 random 512x512 masks (made here,
    # after the path's peak memory was read)
    masks512 = _random_images(
        64, 512 * 512, dev, torch.Generator(device=dev).manual_seed(17))
    blobs = _blob_images(256, WS_SIDE, dev,
                         torch.Generator(device=dev).manual_seed(19))
    split = kernel_split({
        "whole-slide batch 0": lambda: chaos_count_sums_strips(
            principal, nrows, ncols, nlevels),
        "256 smooth blobs": lambda: chaos_count_sums_strips(
            blobs, WS_SIDE, WS_SIDE, nlevels),
        "64 random 512x512 masks": lambda: chaos_count_sums(
            masks512, 512, 512, nlevels)}, TILE_KERNELS)
    del masks512
    del imgs, principal
    batch_ms = time_ms(lambda: backend.score_batch(t_b0), reps=2, warmup=1)
    say(f"  strips: {n_img} batch-0 principal images bit-equal to the plain "
        f"version, first 3 equal to scipy {sc}")
    gen = torch.Generator(device=dev).manual_seed(13)
    masks = _random_images(16, WS_SIDE * WS_SIDE, dev, gen)
    _check_chaos_strips(masks, WS_SIDE, nlevels, "random masks")
    _check_chaos_strips(_seam_images(WS_SIDE, WS_SIDE, dev), WS_SIDE,
                        nlevels, "comb and spiral", n_scipy=4)
    snake = torch.from_numpy(_serpentine(WS_SIDE, WS_SIDE).reshape(1, -1))
    got = chaos_count_sums_strips(snake.to(dev), WS_SIDE, WS_SIDE, nlevels)
    sc = _scipy_count_sums(snake.numpy(), WS_SIDE, WS_SIDE, nlevels)
    assert got.cpu().tolist() == [float(sc[0])] == [float(nlevels)], (
        got, sc)
    say(f"  strips: serpentine {WS_SIDE}x{WS_SIDE} (one path through every "
        f"row) {int(got[0])} = scipy {sc[0]}")
    # smooth images: large components in every tile and across every seam
    _check_chaos_strips(blobs[:4], WS_SIDE, nlevels, "smooth blobs", n_scipy=2)
    blob_ms = time_ms(lambda: chaos_count_sums_strips(
        blobs, WS_SIDE, WS_SIDE, nlevels), reps=3)
    say(f"  strips: 256 smooth blobs {WS_SIDE}x{WS_SIDE}: row-tile kernel "
        f"{blob_ms:.3f} ms")
    if ab is not None:
        assert torch.equal(ab.chaos.chaos_count_sums_strips(
            blobs, WS_SIDE, WS_SIDE, nlevels), chaos_count_sums_strips(
            blobs, WS_SIDE, WS_SIDE, nlevels))
        old_ms, new_ms = _time_turns(
            lambda: ab.chaos.chaos_count_sums_strips(blobs, WS_SIDE, WS_SIDE,
                                                     nlevels),
            lambda: chaos_count_sums_strips(blobs, WS_SIDE, WS_SIDE,
                                            nlevels), reps=3)
        say(f"  strips: 256 smooth blobs in turns against {ab.root}: other "
            f"{old_ms:.3f} ms, this {new_ms:.3f} ms")
    del blobs
    # 2048x2048: 64 tiles of 32 rows, 262,144 seam nodes, past the merge's
    # shared memory: the global seam plane
    big = _random_images(2, 4 * WS_SIDE * WS_SIDE, dev, gen)
    _check_chaos_strips(big, 2 * WS_SIDE, nlevels, "random masks",
                        plane=True, n_scipy=2)
    del big
    n_bytes = n_img * (p * 4 + nlevels * 4 + 4)
    # the byte floor: the union-find's compares and atomics are integer
    # work whose count depends on the images, which no peak rate models
    bound, by = bound_ms(n_bytes, 0.0)
    say("  row-tile chaos split by kernel, ms (torch.profiler, one call "
        "each): " + (json.dumps(split) if split else "not measured"))
    say(f"  whole-slide batch 0 device ms: extract {extract_ms:.3f}, "
        f"moments (unmasked) {mom_ms:.3f}, row-tile chaos {kern_ms:.3f} "
        f"({bound / kern_ms:.2%} of its bound; plain {plain_ms:.3f}, byte "
        f"floor {bound:.3f}), batch {batch_ms:.3f}")
    say(f"phase 8 whole-slide path: {time.perf_counter() - t_start:.1f} s; "
        f"chaos routed {route!r}; row-tile chaos and unmasked moments "
        "kernels launched on every batch; row-tile kernel bit-equal to the "
        "plain version and scipy; unmasked moments within "
        f"{MOMENT_ULPS} ulp of f64 and of the plain version beyond its drift")
    entry = {"name": "chaos_strips", "route": "cuda",
             "source": "sm_distributed_tpu_torch/csrc/chaos_strips.cu",
             "replaces": "sm_distributed_tpu/ops/chaos_pallas.py:516",
             "launches": launches["chaos_strips"], "max_abs_err": 0.0,
             "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound,
             "bound_by": by, "library_ms": None}
    summary = {"wall_s": wall, "timings": tim, "peak_bytes": peak,
               "n_ions": table.n_ions, "n_peaks": ds.n_peaks,
               "launches": launches, "recall": recall,
               "ions_per_s": table.n_ions / tim["score"],
               "moments_max_abs_err": mom_err, "ulp_to_f64": metric_gaps,
               "batch_ms": {"extract": extract_ms, "moments": mom_ms,
                            "moments_bound": mom_bound,
                            "moments_one_read": mom_sum_ms,
                            "chaos_strips": kern_ms,
                            "chaos_strips_split": split,
                            "chaos_strips_blobs": blob_ms,
                            "batch": batch_ms}}
    return entry, summary


def _check_chaos_strips(images: torch.Tensor, side: int, nlevels: int,
                        label: str, plane: bool = False, n_scipy: int = 3):
    """The strips route's wrapper on side x side ``images`` against the
    plain version (bit-equal) and scipy (the first ``n_scipy``), with its
    launch counted once and the seam merge's global plane used iff
    ``plane``."""
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums_strips,
        chaos_count_sums_torch,
        chaos_route,
        tile_plan,
    )

    assert chaos_route(side, side) == "strips"
    assert tile_plan(side, side, nlevels).seam_in_smem != plane
    reset_launches()
    got = chaos_count_sums_strips(images, side, side, nlevels)
    ran = read_launches()
    assert (ran["chaos_strips"], ran["chaos_seam_plane"],
            ran["chaos_tiles"]) == (1, int(plane), 0), (label, ran)
    want = chaos_count_sums_torch(images, side, side, nlevels)
    assert torch.equal(got, want), (
        f"strips {label}: {int((got != want).sum())} images differ")
    sc = _scipy_count_sums(images[:n_scipy].cpu().numpy(), side, side,
                           nlevels)
    assert got[:n_scipy].cpu().tolist() == [float(v) for v in sc], (
        got[:n_scipy], sc)
    say(f"  strips {label}: {images.shape[0]} images {side}x{side}"
        f"{' (global seam plane)' if plane else ''} bit-equal to the plain "
        f"version, first {n_scipy} equal to scipy {sc}")


class OtherPort:
    """The moments, fused and chaos wrappers of another checkout's port
    (``--ab DIR``), imported under the package name ``ab_port``: its kernels
    build from that checkout's sources into its own ``build/``."""

    def __init__(self, root: str):
        self.root = root
        pkg = Path(root).resolve() / "sm_distributed_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "ab_port", pkg / "__init__.py",
            submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["ab_port"] = mod
        spec.loader.exec_module(mod)
        self.moments = importlib.import_module("ab_port.ops.moments")
        self.score = importlib.import_module("ab_port.ops.score")
        self.chaos = importlib.import_module("ab_port.ops.chaos")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", metavar="DIR", help="another checkout of the "
                        "repo whose moments, fused and chaos kernels are "
                        "timed in turns against this one's")
    opts = parser.parse_args()
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
    ab = OtherPort(opts.ab) if opts.ab else None
    ds, truth, search, ds_cfg = _setup_main_path()
    main = phase_main_path(ds, truth, search)
    backend = search.last_backend
    block, _theor, _n_valid = backend.image_block(
        _slice_table(search.last_table, 0, backend.batch))
    kernels = phase_kernels(dev, block, backend.n_real,
                            ds_cfg.image_generation.nlevels, ab)
    del block
    torch.cuda.empty_cache()
    for entry in kernels:
        entry["launches"] = main["launches"][entry["name"]]
    phase_golden()
    fused_entry, fused = phase_fused(ds, truth, search, ds_cfg, main, ab)
    torch.cuda.empty_cache()
    cube = phase_cube_main(ds, truth, search, ds_cfg, main)
    say("main path: " + json.dumps({
        k: main[k] for k in ("ions_per_s", "timings", "peak_bytes", "wall_s",
                             "n_ions", "n_peaks", "drift", "recall",
                             "batch_ms")}))
    del ds, truth, search, backend, main
    torch.cuda.empty_cache()
    strips_entry, slide = phase_whole_slide(
        dev, ds_cfg.image_generation.nlevels, ab)
    say("fused path: " + json.dumps(fused))
    say("cube path, main dataset: " + json.dumps(cube))
    say("whole-slide path: " + json.dumps(slide))
    # the moments kernel's error: the largest over phase 4's blocks and the
    # whole-slide block of phase 8
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    slide["moments_max_abs_err"])
    kernels = kernels[:3] + [strips_entry, fused_entry]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
