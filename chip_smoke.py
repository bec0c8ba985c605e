#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sm_distributed_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``sm_distributed_tpu_torch/csrc`` with
nvcc and drives twenty-one paths (seven of the library search, the job
path, the service, the service's read path and stream ingest, a
device-mode isotope search under the profiler, the main path on meshes of
devices, a replica takeover, the kernel-build primer beside the elastic
fleet, the operator's gates: a cold replica, the compile census and
device chaos, the load sweep beside host chaos, the main path on a mesh
spanning two processes, the numerics sentinel with two OOM cases, and
the port's bench on its cut headline case),
each with the kernel launch counts set to 0 just before it and read just
after (phases 18's, 19's, 20b's and 22's in their own processes, which
start with none):

- the main path, the plain flat chain (phases 3-5): 256x256 pixels, 200
  noise peaks a pixel, formula batches of 2048 ions, a cold isotope-pattern
  cache; each kernel held against its plain PyTorch version on its first
  image block, and the 32x32 golden fixture checked against
  ``tests/data/golden_spheroid.json``.  Chaos takes the packed route's
  shared-memory kernel (images of at most 65,536 pixels); phase 4 also
  holds the row-tile kernel that serves larger packed images (512x512, and
  8x36864 with one-row tiles) on random masks and images whose components
  cross the tile seams, both chaos kernels at 300 levels (launched over
  level ranges of at most 255; a checkerboard whose range counts pass
  2**24), "scan" shapes (64x16384 on the row-tile
  kernel, 2x70000 on the scan route's torch ops), the moments kernel
  at K = 12 (row groups) and hot-spot clipping of 64 ions against the
  numpy oracle, and two host threads on one card launching the moments and
  the fused kernels 200 times each with plans of different shared memory,
  bit-equal with no ``KernelError`` (the launch set-up is made once per
  device); phase 5 also reproduces the golden ``preprocessing`` section;
- the job path (phase 3b): the README's Quickstart on the card — the main
  path's dataset written as an imzML/ibd pair and its formulas as a
  molecular-DB CSV, the port's CLI (``import-db``, ``run`` twice, with a
  cold and a warm isotope-pattern cache, ``search``) as subprocesses, and
  one ``SearchJob`` in-process (counts reset: the masked moments kernel
  and the shared-memory chaos kernel); the stored annotations, metrics and
  ion images held bit-equal to phase 3's and to the device image block,
  each run's phase walls and the job's device peak printed;
- the fused path (phase 6): the same search with
  ``parallel.fused_metrics="on"``, held against the main path's results, and
  the fused window-moments kernel against its plain version;
- the cube path at the main size (phase 7): the main path's dataset and
  ions with ``parallel.mz_chunk=512``, held ion by ion to the main path's
  results;
- the preprocessed main path (phase 7b): the main path's dataset and ions
  with ``image_generation.do_preprocessing``: its device peak, and batch
  0's clipped block through the kernels against f64 and the plain chain;
- the whole-slide path (phase 8): a 1024x1024 dataset on the m/z-chunked
  cube path (``parallel.mz_chunk=512``), whose chaos takes the row-tile
  kernel on the strips route, held against its plain version and scipy
  (also on a comb and a spiral across the tile seams, and on a 2048x2048
  image whose seam merge takes the global seam plane); its unmasked moments
  kernel and its metrics held against their plain versions and f64 on the
  path's first batch;
- the ordered stream (phase 9): ``bench.py``'s ``scale`` case (256x256,
  500 formulas +H with 20 decoys each: 10,500 ions in 6 batches, ordered
  by m/z; 100 noise peaks a pixel, bench.py's 200 cut for the script's
  time) at the shipped defaults, whose variant rule takes the band or
  compact extraction, held bit-equal (FDR ranks identical) to the same
  stream with both variants "off" and with compaction forced "on"; it
  prints the variant counts, each batch's device ms by variant, the
  histogram's host plan and device kernels (torch.profiler), the marginal
  ns a slot the rule weighs, ions/s and the device peak;
- resilience and compact cubes (phase 10, run after phase 7b on the main
  path's dataset and ions, its lines stamped with the card's name and power
  limit): a search with ``checkpoint_every=1`` killed before its third
  group by the ``device.score_batch`` failpoint and resumed from its two
  shards (one batch scored, bit-equal to phase 3); a real CUDA OOM under
  ``torch.cuda.set_per_process_memory_fraction``, at a cap between the
  device peaks measured at batches of 2048 and 1024, backed off to a
  smaller batch with the same bits, then a search starting at the learned
  batch; on the first 10 formulas, a transient and three sticky injected
  chip faults, the third opening the breaker and failing with
  ``DeviceUnavailableError`` (the port never moves device work to the
  host), a search refused while it is open, and a half-open probe that
  closes it; and bf16 / int8 resident cubes (bf16 also fused), each
  bit-equal to an f32 search on the host-expanded cube, with resident
  bytes, peaks and the FDR ranks that moved.  Step 10.1's searches run the
  port's own set-up; the later ones share the dataset's global m/z sort,
  so their walls leave it out.  Each new path's kernels are held against
  their plain versions, and after every phase the script checks that the
  breaker is closed and that the only refused jobs are phase 10's;
- the annotation service (phase 11, after phase 10): the port's
  ``AnnotationService`` in process with 2 workers, 2 resident datasets,
  an ephemeral admin port and the lease-time health probe, its launch
  counts reset before it starts: job A on phase 3b's imzML of the main
  path's dataset and ions, then job B, the same, which must hit the
  residency (no parse, no backend set-up), both stored bit-equal to phase
  3; job C with a missing input, dead-lettered after 2 attempts with its
  traceback; job D deleted while it waits, cancelled; ``/debug/devices``,
  ``/debug/events`` (the probe a copy round-trip on the card),
  ``/metrics`` and ``/slo`` read; then ``serve`` as a subprocess with a
  good and a bad job, ``/healthz`` 200 and SIGTERM -> exit 0.  With more
  than one card it first holds every kernel on ``cuda:1``, launched from a
  worker thread, bit-equal to ``cuda:0``;
- the read path and stream ingest (phase 12, after phase 11, in a service
  with its knobs over its results dir): ``/datasets``, cold and warm
  (cache hit) ``/datasets/<id>/annotations`` equal to a pandas scan of the
  stored parquet, every row once through cursors of 100, the top ion's
  tile byte-equal to a direct render, a cohort, the ``read`` SLI, warm
  p50/p99 printed; a ``mode: "stream"`` job over the main path's dataset
  appended in chunks of 72, 104 and 80 image rows (prefixes off the row
  lattice: real masked pads), each provisional re-score bit-equal to a
  direct search over its prefix with moments and packed chaos launched,
  the sealed stream bit-equal to phase 3, the phase's device peak under
  2.5x the main path's; a 32x32 stream over HTTP (duplicate 200, conflict
  409, empty finish 409) bit-equal to its batch run; and a stream that gets
  no chunk dead-lettered with ``StreamIdleError``;
- device isotope patterns and the profiler (phase 13, after phase 9):
  13a generates phase 9's 10,500 ions cold with
  ``IsocalcWrapper(device_blur=True)`` on the card, each held to phase 9's
  cold oracle table (equal peak counts, |dm/z| < 5e-6, |dint| < 1e-3), the
  stage's outputs for the first 500 ions' segments on the CPU as well, and
  the ``dev`` cache namespace (a device-mode wrapper warm-loads every ion,
  an oracle-mode one none); 13b searches the main path's dataset and ions
  with ``parallel.isocalc_device="on"`` and a cold pattern cache in a
  worker thread while this thread holds a ``ProfileSession`` open, each
  hand kernel's profiler event count equal to its launch counter, the
  attribution's classes summing to its total, the device stage's share of
  the device time printed; 13c drives ``GET /debug/profile`` in a service
  (200 with the JAX response's keys, 400, one 200 and one 409 at once,
  captures during a 32x32 job whose injected spans land in its trace,
  ``sm_profile_captures_total``, 404 when disabled);
- the main path on ("pixels", "formulas") meshes (phase 14, after phase
  12, on phase 3's dataset, search object and warm patterns): 14a its
  4,944 ions through ``MSMBasicSearch`` on a 2x2 mesh of ``cuda:0``
  repeated (``make_torch_backend`` from an explicit device list), every
  metric row, annotation and FDR rank bit-equal to phase 3's, batch 0's
  ion images bit-equal to phase 3's backend's, moments and packed chaos
  launched once a mesh cell and batch (12 and 12), each batch's
  CUDA-event ms by stage (extraction, shuffle copies, metrics, gather);
  14b batch 0 alone on 4x1 and 1x4 meshes and on 2x2 with the band and
  the compact variant forced, bit-equal; 14c a checkpointed 2x2 search
  killed after its first group and resumed on a 2x1 mesh, bit-equal to
  14a; 14d a 2x1 mesh over ``cuda:0`` and ``cuda:1`` (and a 2x2 mesh
  over four cards where four are visible), each bit-equal to 14a and timed
  in turns against phase 3's backend, and the kernels on ``cuda:1``, only
  where more than one card is visible (otherwise one line says the step
  did not run).  Each mesh's set-up and score seconds,
  ions/s and device peak are printed;
- a replica takeover (phase 15, after phase 14, on phase 3b's imzML, work
  dir and warm patterns, the main path's ions): 15a replica r0 of a
  2-replica config (``drivers.replica_chaos --replica-serve``, a
  subprocess on ``cuda:0`` with ``SM_FAILPOINTS=device.score_batch=crash@1``
  and ``SM_LOCK_ORDER=raise``) claims the one message, parses, builds its
  backend and dies at its first score group (exit 21, the message in
  ``running/`` under r0's lease); 15b once r0's beat and heartbeat are
  stale (polled), r1 (``AnnotationService`` in process, the lock-order
  detector in raise mode) fences the claim one higher, requeues it
  (``sm_replica_takeover_requeues_total`` 1) and runs it to ``done/``:
  one message there and none elsewhere, the ledger with no STARTED row
  after ``fail_stale_started(before=<takeover>)`` and its newest job
  FINISHED, the stored results bit-equal to phase 3's, moments and packed
  chaos launched 3 times each and nothing else, no lock-order cycle.
  Every check is a state, a count or bit-equality; a deadline of 120 s
  only ends a hang;
- the primer and the fleet (phase 16, after phase 15): 16a the kernel-build
  primer (``service/primer.py``) in process, from no prime manifest, over
  the bucket specs phases 3 and 11 recorded: one cycle primes each with no
  nvcc run (phase 2 built every kernel), no launch and no device
  allocation, a second primes none, ``GET /debug/compile`` shows every
  spec primed and the four kernels loaded and set up on ``cuda:0``, and
  phase 14c's mesh spec, on a two-card lease, is skipped for want of
  cards on one card; 16b ``serve --fleet`` as a subprocess
  (``min_replicas`` 2) over phase 11b's 32x32 dataset: r0 and a spawned
  replica alive in ``/fleet/status``, one job done and stored bit-equal to
  phase 11b's, the replica that ran it launching moments and packed chaos
  once a score batch and nothing else (read from its own ``/metrics``,
  ``sm_kernel_launches_total``; none on the other), the spawned replica
  SIGKILLed (``sm_fleet_crashes_total`` 1) and replaced, SIGTERM draining
  every child (each drain acked), ``running/`` empty, exit 0; 16c
  ``/fleet/metrics``, ``/fleet/slo`` and ``/fleet/status`` 200 with both
  replicas, the merged ``sm_jobs_total`` and ``sm_kernel_launches_total``
  the sums of the replicas' own.  16b's replicas keep their kernel builds
  in phase 17a's directory: they are 17a's primed side;
- the operator's gates (phase 17): 17a ``serve`` as a subprocess over a
  fresh, empty kernel build directory
  (``parallel.compile_cache_dir``) runs a 32x32 job in 2 score batches:
  its trace holds one uncached ``compile`` event (an nvcc build) for each
  of moments and packed chaos, its first annotation lands after the first
  build started and before the terminal state, a provisional partial
  preview precedes it, ``drivers/trace_report`` gives ``compile_s > 0``,
  the idle primer primes its spec with no further nvcc run, and its own
  ``/metrics`` counts one moments and one packed chaos launch a batch;
  then 16b's replicas start over that directory with every spec primed
  and no nvcc run, and the one that runs 16b's job finds both kernels
  built (loads, no build, on the job's trace).  17a starts after phase
  14, in a thread of the script, and runs beside phases 15 and 16a and
  17b (``drivers/compile_census`` in process) and 17c
  (``drivers/device_chaos --smoke`` in process: chip 3 of a 4-chip pool
  quarantined mid-job, never leased again, the job resumed bit-equal to
  its golden run, chip 3 readmitted; on one card every lease scores on
  ``cuda:0``); 17d renders and validates with ``drivers/trace_report`` the
  traces of phase 11's job A, phase 15's taken-over job and 17a's cold
  job.  The phase prints what it added to the script: 17b, 17c, the wait
  for 17a after them and 17d.
  States, counts and bits only; a deadline of 180 s (phase 16) or 300 s
  (phase 17) only ends a hang;
- the load sweep and host chaos (phase 18), each a subprocess on the card
  over the kernels phase 2 built (loads, no nvcc run), started beside 17a
  and joined before 16b: 18a ``drivers/load_sweep --smoke`` (a 12-submit
  burst at a queue bound of 6, its depth held by the distinct queued ids
  and the admission controller's depth, every shed a structured 429; a
  queued and a mid-run deadline; a dead-lettered and a quarantined poison
  job; its jobs scored on ``cuda``, so moments and packed chaos launches
  above 0), 18b ``drivers/host_chaos --smoke`` (a 4-chip pool of two
  hosts, host h1 a ``--bare`` replica SIGKILLed while the job is held at
  its second group, h1's chips evicted as one unit, the job resumed on
  host 0's chips bit-equal to its golden run, h1 readmitted; on one card
  every lease scores on ``cuda:0``).  Each exits 0 and prints its
  service's ``sm_kernel_launches_total`` by kernel; the phase prints what
  it added to the script: the wait for 18a and 18b after 17c.  A deadline
  of 600 s only ends a hang;
- a mesh spanning processes (phase 19): two processes of this script
  (``--pod-worker DIR``, the launch contract's ``SM_COORDINATOR``,
  ``SM_NUM_PROCESSES`` and ``SM_PROCESS_ID`` over a localhost port) parse
  phase 3b's imzML and search phase 3's first formulas whose ions fill one
  batch of 2048 (its depth, cut from all three batches for the script's
  time) with phase 3b's warm pattern cache on one 2x2 mesh, pixel shard r
  in process r, so every formula shard's shuffle crosses the processes.
  19a: both on ``cuda:0`` with local devices ``[cuda:0, cuda:0]`` (one
  card: the shuffle and the gather over gloo, which takes CUDA tensors);
  19b, where four cards are visible: each on two cards of its own
  (``CUDA_VISIBLE_DEVICES``), over NCCL.  Started after phase 14 beside
  phases 15-18 and joined after 18: both processes' rows bit-equal to each
  other and, ion by ion, to phase 3's and to 14a's, each process
  launching the moments and the packed chaos kernels twice a batch (its
  two cells) and nothing else; each prints its parse,
  set-up and score seconds, its transport, its cross-process bytes a batch
  and its device peak, and the phase what it added to the script.  A
  deadline of 600 s only ends a hang;
- the numerics contracts and two OOM cases (phase 20; 20a, 20c and 20d
  run right after phase 10, on its shared m/z sort): 20a
  ``drivers/ulp_sentinel``'s measure on ``cuda:0`` (the off-lattice 9x11
  fixture through the masked moments and packed chaos kernels, and fused
  over a bf16 cube through the fused kernel, against the numpy oracle) and
  its gate against the committed ``NUMERICS_H100_r*.json``: FDR ranks
  identical, chaos / spatial / spectral / msm within 0 / 16 / 16 / 32
  ulp, the fused bf16 drift within ``compact_cube``'s contract, and the
  history band, all hard; 20b ``drivers/isocalc_smoke --device cuda`` as
  a subprocess beside phase 15 (serial and 2-worker pool tables equal and
  their shards byte-identical, in oracle and device mode); 20c an OOM
  beside a resident backend: two ``SearchJob``s over one
  ``DatasetResidency(2, 2)``, job B (phase 3's ions) under a memory
  fraction at the midpoint of its measured 2048 / 1024 peaks with job A's
  backend resident, backed off to at most 1024, bit-equal to phase 3,
  then A's next job a backend hit with no set-up, bit-equal; 20d an OOM
  inside the fused wrapper's ``principal`` allocation: phase 6's search
  under a cap between the bytes measured at the wrapper's entry and the
  same plus ``principal`` (or, where the measured bytes leave no such cap,
  its figures printed as not provoked), the OOM's traceback in
  ``ops/score.py``'s ``fused_window_moments``, no launch counted for it,
  backed off to at most 1024, bit-equal to phase 6, every kernel held to
  its plain version after it.  The fraction returns to 1.0 in a
  ``finally``; counts, states and bits decide, no wall-clock bound;
- the sync census of the main path (phase 21, right after phase 3, on its
  resident backend and data): its 3 batches of 2048 re-scored under
  ``torch.cuda.set_sync_debug_mode("warn")`` through
  ``analysis/synccensus.SyncCensus``, every sync warning attributed to the
  innermost frame of the port on its thread's stack; the syncs a batch
  printed by ``file:line``, the phase failing if a sync in a hot module
  (``analysis/rules.HOT_MODULES``) sits on a line the ``host-sync`` rule
  does not see as annotated (a blind spot of the static rule on the main
  path) or if it saw no sync at all, and the rows bit-equal to phase 3's.
  The debug mode is restored on the way out; sites, counts and bits
  decide, no wall-clock bound.  The debug mode flags implicit syncs only,
  so the census proves the rule has no blind spot there, not that it is
  complete;
- the port's bench (phase 22): ``python -m
  sm_distributed_tpu_torch.drivers.bench`` as a subprocess on the card,
  started beside phases 15-18 and joined after 20b, on its headline case
  cut to 32x32 pixels, 40 formulas (840 ions), 1 rep, a 200-ion floor
  sample in one process, no cold isotope patterns and no cold start
  (:data:`BENCH_ARGS`, flags the bench already has), its isotope patterns
  computed in one process (``SM_ISOCALC_PROCS``), so that it takes few of
  the cores phases 15-18 share: exit 0 and one JSON
  line with the documented keys (``drivers/bench.LINE_KEYS``), the card's
  name, the preset's ions, the moments and packed chaos kernels launched
  once a batch of its five timed streams and the fused kernel never,
  ``0 < roofline_frac <= 1`` and, from its profiled stream, device events
  and ``0 < measured_roofline_frac <= 1``; the port's ``perf_sentinel
  --self-check`` passes with the line as its only history and
  ``drivers/trace_report`` renders its trace.  The phase prints its own
  seconds, the wait it added and the span of phases 15-18 beside it (what
  it costs them shows there).  Counts, states and bits decide; a
  deadline of 600 s only ends a hang.

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
path's principal images and the whole-slide batch's; and in phase 4 runs
the two-thread launch race three times on its kernels and prints its
moments plans' occupancy beside this one's.

    python3 chip_smoke.py --pod-only

runs phases 1-3 and then phase 19 alone (19a, and 19b where four cards are
visible, each on a cold pattern cache): the four-card check of 19b.

One line per phase; any failure raises and exits non-zero.  The line before
the last is a JSON object with each kernel's launches on its path (phase
11's jobs A and B in ``service_launches``, phase 12's stream job, its
re-scores and its sealed pass, in ``stream_launches``, the profiler's
event count of its device function over phase 13b's search in
``profile_launches``, phase 14a's 2x2 search in
``sharded_launches``, phase 15's r1 in ``takeover_launches``, phase
16a's prime cycles in ``prime_launches``: 0, priming launches nothing,
phase 16b's job on its replica in ``fleet_launches``, 17a's cold job on
its replica in ``coldstart_launches``, 17b's three census jobs in
``census_launches``, 17c's three chaos jobs in
``device_chaos_launches``, 18a's sweep in ``load_sweep_launches``,
18b's three host-chaos jobs in ``host_chaos_launches``, phase 19's
searches by process in ``pod_launches``, 20a's sentinel in
``numerics_launches`` and 20c's job B and 20d's search in
``oom_launches``), its error against
the plain version and its times; the last line is
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
# the MSM component contracts (chaos, spatial, spectral, msm) in ulp: the
# port's ``analysis/numerics.COMPONENT_CONTRACTS``, read in main() once the
# package is known to sit beside this script
CONTRACT: dict = {}

# full-width main path: the JAX bench's scale geometry
NROWS = NCOLS = 256
NOISE_PEAKS = 200
N_FORMULAS = 100          # ~4.9k ions with 3 adducts and 20 decoys each

# the whole-slide path: a 1024x1024 DESI-like slide on the m/z-chunked cube
# path (mz_chunk = the flat path's BAND_WINDOWS), +H only, ~12 formulas with
# 20 decoys each: 2 batches of 128 (its depth, cut from 20 formulas in 2
# batches of the JAX bench's desi batch of 256 to keep the script's time),
# 50 noise peaks a pixel (cut from 200, the main path's, to 100 and then
# 50 for the same reason: the slide's generation and m/z sort were 86 of
# the phase's 180 s at 200; the kernels' shapes do not depend on it)
WS_SIDE = 1024
WS_NOISE_PEAKS = 50
WS_FORMULAS = 12
WS_PARALLEL = {"mz_chunk": 512, "formula_batch": 128}

# the ordered stream (phase 9): bench.py's scale case — the main path's
# 256x256 geometry with 500 formulas (60% present, seed 7), +H only at 3
# ppm, 20 decoys each: 10,500 ions in 6 batches of 2048, so the shipped
# order_ions="auto" orders the ion table by m/z.  Its depth is cut to 100
# noise peaks a pixel (bench.py's 200) for the script's time; the ions and
# batches stay
OS_FORMULAS = 500
OS_NOISE_PEAKS = 100
OS_DS = {"isotope_generation": {"adducts": ["+H"]},
         "image_generation": {"ppm": 3.0}}
OS_SM = {"fdr": {"decoy_sample_size": 20}}
VARIANTS = ("plain", "band", "compact")

# the golden fixture recipe of scripts/make_golden_report.py (GEN, SM, DS)
GOLDEN_GEN = dict(nrows=32, ncols=32, formulas=None, present_fraction=0.6,
                  noise_peaks=200, mz_jitter_ppm=0.5, seed=7)
GOLDEN_SM = {"fdr": {"decoy_sample_size": 20, "seed": 42},
             "parallel": {"formula_batch": 256}}
GOLDEN_DS = {"image_generation": {"ppm": 3.0}}
# golden section -> (adducts, image_generation.do_preprocessing)
GOLDEN_SECTIONS = {"root": (("+H",), False),
                   "multi_adduct": (("+H", "+Na", "+K"), False),
                   "preprocessing": (("+H",), True)}


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
    attribute.  Every counter counts kernel launches: one a level range
    (more than 255 levels) for chaos, one a row group (more than 8 rows an
    ion) for the moments kernels.  The packed chaos wrapper counts its two
    kernels apart (the shared-memory kernel, and the row-tile kernel for
    images past 65,536 pixels); ``chaos_seam_plane`` counts the row-tile
    launches, on either route, whose seam merge keeps its union-find in a
    global plane; ``chaos_scan`` counts calls of the scan route's torch
    ops."""
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_scan,
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
            "chaos_scan": (chaos_count_sums_scan, "launches"),
            "fused_window_moments": (fused_window_moments, "launches")}


# the launches of the calls over more than one level range (more than 255
# levels) and over more than one row group (more than 8 rows an ion) made
# by the checks of phases 4 and 6, for the kernels line: by packed chaos
# kernel, and [moments, fused]
_LEVEL_RANGE_LAUNCHES = {"smem": 0, "tiles": 0}
_ROW_GROUP_LAUNCHES = [0, 0]


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


def active_clusters(k: int, plan, build=None) -> int:
    """Clusters of a moments plan's shape the card holds at once
    (cudaOccupancyMaxActiveClusters, through csrc/moments.cu); ``build``:
    another checkout's ``kernels._build`` (``--ab``)."""
    from sm_distributed_tpu_torch.kernels import _build

    fn = (build or _build).load("moments").sm_moments_active_clusters
    fn.argtypes = [ctypes.c_int] * 4
    return fn(k, plan.cluster, plan.slice_len, int(plan.regime == "resident"))


def phase_build() -> None:
    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.service.primer import bind_builds
    from sm_distributed_tpu_torch.utils.config import SMConfig

    # the script's configs all build under the default directory and
    # record their bucket specs there, as a CLI process on the card does
    bind_builds(SMConfig.from_dict({}))
    t0 = time.perf_counter()
    _build.build_all()
    took = time.perf_counter() - t0
    regs = {}
    for name, log in _build.build_logs.items():
        rep = _build.ptxas_report(log)
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
        K_MAX,
        batch_moments,
        batch_moments_torch,
        moments_groups,
        moments_plan,
    )

    n, k, p = x.shape
    plan = moments_plan(n, min(k, K_MAX), p)
    groups = moments_groups(k)
    before = batch_moments.launches
    got = batch_moments(x, n_real)
    assert batch_moments.launches - before == len(groups), (
        f"moments {label}: {batch_moments.launches - before} launches for "
        f"{len(groups)} row groups")
    if len(groups) > 1:
        _ROW_GROUP_LAUNCHES[0] += len(groups)
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
        f"({'' if len(groups) == 1 else f'row groups {groups}, first '}"
        f"plan: {plan.cluster} CTAs x {plan.slice_len} px, {plan.regime}"
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
        level_ranges,
        packed_variant,
        tile_plan,
    )

    assert packed_variant(nrows * ncols) == variant
    plane = variant == "tiles" and not tile_plan(nrows, ncols,
                                                 nlevels).seam_in_smem
    n_ranges = len(level_ranges(nlevels))
    reset_launches()
    got = chaos_count_sums(images, nrows, ncols, nlevels)
    ran = read_launches()
    want_ran = {"chaos": n_ranges * (variant == "smem"),
                "chaos_tiles": n_ranges * (variant == "tiles"),
                "chaos_strips": 0, "chaos_seam_plane": n_ranges * plane,
                "chaos_scan": 0}
    assert {k: ran[k] for k in want_ran} == want_ran, (label, ran)
    if n_ranges > 1:
        _LEVEL_RANGE_LAUNCHES[variant] += n_ranges
    plain_ms, want = time_once(
        lambda: chaos_count_sums_torch(images, nrows, ncols, nlevels))
    assert torch.equal(got, want), (
        f"chaos {label}: {int((got != want).sum())} images differ")
    host = images[:n_scipy].cpu().numpy()
    sc = _scipy_count_sums(host, nrows, ncols, nlevels)
    assert got[:n_scipy].cpu().tolist() == [float(v) for v in sc], (
        f"chaos {label}: kernel {got[:n_scipy].tolist()} != scipy {sc}")
    say(f"  chaos {label} ({variant} kernel"
        f"{', global seam plane' if plane else ''}"
        f"{f', {n_ranges} level ranges' if n_ranges > 1 else ''}): "
        f"{images.shape[0]} images "
        f"{nrows}x{ncols}, {nlevels} levels, bit-equal to the plain version "
        f"({plain_ms:.1f} ms), first {n_scipy} equal to scipy {sc}")
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


def _check_hotspot(block: torch.Tensor) -> None:
    """Hot-spot clipping (``ops/metrics.hotspot_clip_batch``, torch ops on
    the card) of ``block``, at q = 99 and 50, bit-equal to the port's numpy
    oracle image by image (``hotspot_clip``), its sort in ion groups."""
    from sm_distributed_tpu_torch.ops.metrics import hotspot_clip_batch
    from sm_distributed_tpu_torch.ops.metrics_np import hotspot_clip

    host = block.cpu().numpy()
    for q in (99.0, 50.0):
        got = hotspot_clip_batch(block.clone(), q).cpu().numpy()
        clip_ms = time_ms(lambda: hotspot_clip_batch(block.clone(), q),
                          reps=3, warmup=1)
        want = np.stack([[hotspot_clip(im, q) for im in ion] for ion in host])
        assert want.dtype == np.float32
        bad = int((got.view(np.uint32) != want.view(np.uint32)).sum())
        assert bad == 0, f"hot-spot clip q={q}: {bad} pixels differ"
        say(f"  hot-spot clip q={q:g}: {block.shape[0]} ions of the main "
            f"block ({int((got < host).sum())} pixels clipped) bit-equal to "
            f"the numpy oracle; {clip_ms:.3f} ms on the card with the "
            "block's copy")


RACE_LAUNCHES = 200


def launch_race(moments_mod, score_mod, dev) -> dict:
    """Two host threads on one device, each on its own stream, launching
    the moments kernel RACE_LAUNCHES times on a block whose plan differs in
    shared memory from the other thread's (the same K = 4: 65,536 pixels,
    16 CTAs x 4096 resident, against 20,000 pixels, 8 CTAs x 2500), and the
    same for the fused kernel; each result held bit-equal to its
    single-thread result, each ``KernelError`` counted.  ``moments_mod`` and
    ``score_mod`` are ``ops.moments`` and ``ops.score`` of this port or of
    another checkout's (``--ab``)."""
    import threading

    kernel_error = moments_mod._build.KernelError
    gen = torch.Generator(device=dev).manual_seed(23)
    k, gc = 4, 6

    def grid(shape):
        return (torch.randint(0, 256, shape, device=dev, generator=gen)
                .float() * (torch.rand(shape, device=dev, generator=gen) < .3))

    def fused_args(p):
        n_chunks, wc, cols = 16, 8 * k, 64
        whp = grid((cols, p))
        starts = torch.randint(0, cols - gc - 2, (n_chunks,),
                               generator=torch.Generator().manual_seed(p))
        rlo = torch.randint(0, gc, (n_chunks, wc), device=dev,
                            generator=gen, dtype=torch.int32)
        rhi = (rlo + torch.randint(0, 3, (n_chunks, wc), device=dev,
                                   generator=gen, dtype=torch.int32)
               ).clamp(max=gc + 1)
        return whp, starts.numpy(), rlo, rhi, p - 7

    calls = []
    for p in (65536, 20000):
        x = grid((64, k, p))
        args = fused_args(p)
        calls.append((
            lambda x=x: moments_mod.batch_moments(x, x.shape[2] - 100),
            lambda a=args: score_mod.fused_window_moments(*a, gc_width=gc,
                                                          k=k)))
    plans = {p: moments_mod.moments_plan(64, k, p) for p in (65536, 20000)}
    assert len({pl.smem_bytes for pl in plans.values()}) == 2, plans
    want = [(mom(), fus()) for mom, fus in calls]
    torch.cuda.synchronize(dev)
    out = {"moments_kernel_errors": 0, "fused_kernel_errors": 0,
           "moments_mismatches": 0, "fused_mismatches": 0}
    lock = threading.Lock()
    start = threading.Barrier(2)

    def work(i):
        mom, fus = calls[i]
        want_m, want_f = want[i]
        errs = {"moments": 0, "fused": 0}
        bad = {"moments": torch.zeros((), dtype=torch.bool, device=dev),
               "fused": torch.zeros((), dtype=torch.bool, device=dev)}
        stream = torch.cuda.Stream(device=dev)
        start.wait()
        with torch.cuda.stream(stream):
            for _ in range(RACE_LAUNCHES):
                for name, fn, ref in (("moments", mom, want_m),
                                      ("fused", fus, want_f)):
                    try:
                        got = fn()
                    except kernel_error:
                        errs[name] += 1
                        continue
                    for g, w in zip(got, ref):
                        bad[name] |= (g != w).any()
        stream.synchronize()
        with lock:
            for name in ("moments", "fused"):
                out[f"{name}_kernel_errors"] += errs[name]
                out[f"{name}_mismatches"] += int(bad[name])

    threads = [threading.Thread(target=work, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out["plans"] = {p: f"{pl.cluster} CTAs x {pl.slice_len} px "
                       f"{pl.regime}, {pl.smem_bytes} B"
                    for p, pl in plans.items()}
    return out


def phase_kernels(dev, block: torch.Tensor, n_real, nlevels: int,
                  ab=None) -> list:
    """Kernels against their plain versions on the card, at the main path's
    shapes: ``block`` is the first (2048, 4, 65536) image block of the main
    path's dataset, as the metrics receive it.  ``ab``: another checkout's
    port (``--ab``), timed in turns against this one."""
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_strips,
        chaos_count_sums_torch,
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
    # more than K_MAX = 8 peaks: one launch per row group, each carrying row
    # 0 (K = 12: rows 0-7, then 0 and 8-11), resident at the main shape
    for nr in (p - 256, None):
        k12 = (torch.randint(0, 256, (256, 12, p), device=dev, generator=gen)
               .float() * (torch.rand(256, 12, p, device=dev, generator=gen)
                           < 0.3))
        err = max(err, _check_moments(k12, nr, True, "integer grid, K = 12"))
    del k12
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

    race = launch_race(importlib.import_module(
        "sm_distributed_tpu_torch.ops.moments"), importlib.import_module(
        "sm_distributed_tpu_torch.ops.score"), dev)
    say(f"  launch race: 2 host threads on {dev}, {RACE_LAUNCHES} launches "
        f"each of the moments and the fused kernel, plans {race['plans']}: "
        + json.dumps({k_: v for k_, v in race.items() if k_ != "plans"}))
    assert race["moments_kernel_errors"] == race["fused_kernel_errors"] == 0 \
        and race["moments_mismatches"] == race["fused_mismatches"] == 0, race
    if ab is not None:
        # the other checkout's launch set-up under the same two threads,
        # three times, and its occupancy answers beside this one's
        for run in range(3):
            other = launch_race(ab.moments, ab.score, dev)
            say(f"  launch race on {ab.root}'s kernels, run {run + 1}: "
                + json.dumps({k_: v for k_, v in other.items()
                              if k_ != "plans"}))
        occ = {}
        for shape in ((2048, 4, 65536), (2048, 4, 20480), (2048, 4, 49152),
                      (128, 4, 1 << 20), (64, 4, 20000), (64, 8, 65536),
                      (5, 3, 999), (256, 1, 65536)):
            pl = moments_plan(*shape)
            occ["x".join(map(str, shape))] = (
                active_clusters(shape[1], pl, ab.moments._build),
                active_clusters(shape[1], pl))
        say(f"  active clusters (other, this) by (n, k, p): {occ}")
        assert all(a == b for a, b in occ.values()), occ

    _check_hotspot(block[:64])

    # --- chaos (kernel 3, packed route): the shared-memory kernel up to
    # 65,536 pixels, the row-tile kernel of csrc/chaos_strips.cu above ---
    principal = block[:, 0, :]                 # the main path's strided view
    side = int(round(p ** 0.5))
    _check_smem_layout(((side, side), (32, 32), (9, 11), (1, 4096)),
                       (1, nlevels, 255))
    _check_tile_layout((1, nlevels, 255))
    ch_plain_ms = _check_chaos(principal, side, side, nlevels,
                               "main-path principal", "smem")
    _check_chaos(_random_images(64, side * side, dev, gen), side, side,
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
    up = principal[:16].reshape(16, side, side).repeat_interleave(
        2, dim=1).repeat_interleave(2, dim=2).reshape(16, -1)
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
    # more than 255 levels: the kernels over consecutive ranges of at most
    # 255 thresholds, the shares added (packed shape and a row-tile shape)
    _check_chaos(principal[:8], side, side, 300,
                 "main-path principal, 300 levels", "smem")
    _check_chaos(_random_images(4, side * side, dev, gen), side, side, 300,
                 "random masks, 300 levels", "smem")
    _check_chaos(masks512[:2], 512, 512, 300, "random masks, 300 levels",
                 "tiles", n_scipy=2)
    # isolated pixels of random heights: a level range's count passes 2**24,
    # where a share rounded to f32 before the sum would lose bits
    board = ((torch.arange(512, device=dev)[:, None]
              + torch.arange(512, device=dev)[None, :]) % 2).float()
    board = board.reshape(1, -1) * (0.5 + 0.5 * torch.rand(
        2, 512 * 512, device=dev, generator=gen))
    vmax = board.amax(dim=1, keepdim=True)
    fracs = torch.arange(255, device=dev, dtype=torch.float32) / 300.0
    first_range = int(sum((board[:1] > vmax[:1] * f).sum() for f in fracs))
    assert first_range > 2**24, first_range
    _check_chaos(board, 512, 512, 300,
                 f"checkerboard, 300 levels, first range's count "
                 f"{first_range}", "tiles", n_scipy=1)
    del board
    # "scan" shapes (past the packed budget, wider than 8192 columns): the
    # row-tile kernel when a row fits a tile (64x16384: 4-row tiles) ...
    _check_chaos(_random_images(2, 64 * 16384, dev, gen), 64, 16384,
                 nlevels, "scan shape, random masks", "tiles", n_scipy=2)
    _check_chaos(_seam_images(64, 16384, dev), 64, 16384, nlevels,
                 "scan shape, comb and spiral", "tiles", n_scipy=2)
    # ... else the scan route's torch ops (2x70000: a row wider than a tile)
    wide = _random_images(2, 2 * 70000, dev, gen)
    reset_launches()
    got = chaos_count_sums(wide, 2, 70000, nlevels)
    assert read_launches()["chaos_scan"] == 1, read_launches()
    assert torch.equal(got, chaos_count_sums_torch(wide, 2, 70000, nlevels))
    sc = _scipy_count_sums(wide.cpu().numpy(), 2, 70000, nlevels)
    assert got.cpu().tolist() == [float(v) for v in sc], (got, sc)
    say(f"  chaos scan shape 2x70000 (scan route, torch ops): bit-equal to "
        f"the plain version and scipy {sc}")
    del wide
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
        "drift (sums/max/counts exact on the integer grid; K = 12 in row "
        "groups), both packed chaos kernels bit-equal to the plain version "
        "and scipy (300 levels in level ranges; scan shapes), hot-spot "
        "clipping bit-equal to the numpy oracle")
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
    variants = dict(search.last_backend.variant_counts)
    peak = torch.cuda.max_memory_allocated()
    table = search.last_table
    n_batches = -(-table.n_ions // search.last_backend.batch)
    tim = bundle.timings
    say(f"  main path: {ds.n_pixels} pixels, {ds.n_peaks} peaks, "
        f"{table.n_ions} ions in {n_batches} batches of "
        f"{search.last_backend.batch}; wall {wall:.3f} s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in tim.items())
        + f"; {table.n_ions / tim['score']:.1f} ions/s scored; peak device "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}; variants "
        f"{variants}")
    assert launches["moments"] > 0, "moments kernel never launched"
    assert sum(variants.values()) == n_batches, variants
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
            "variant_counts": variants,
            "timings": tim, "peak_bytes": peak, "wall_s": wall,
            "n_ions": table.n_ions, "n_peaks": ds.n_peaks,
            "drift": drift, "recall": recall, "batch_ms": breakdown,
            "bundle": bundle}


def phase_sync_census(card: str, search, main: dict) -> dict:
    """Phase 21: phase 3's batches re-scored on its resident backend under
    the sync debug mode; the syncs a batch by site, held to the
    ``host-sync`` rule's annotations, and the rows to phase 3's bits."""
    from sm_distributed_tpu_torch.analysis.synccensus import (
        UNATTRIBUTED,
        SyncCensus,
        blind_spots,
    )
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    backend, table = search.last_backend, search.last_table
    tables = [_slice_table(table, s, min(s + backend.batch, table.n_ions))
              for s in range(0, table.n_ions, backend.batch)]
    ref = main["bundle"].all_metrics[
        ["chaos", "spatial", "spectral", "msm"]].to_numpy()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with SyncCensus() as census:
        rows = backend.score_batches(tables)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    assert torch.cuda.get_sync_debug_mode() == mode, \
        "21: the sync debug mode was not restored"
    sites = census.sites()
    assert sites, "21: the census saw no sync: its hook is blind"
    got = np.concatenate(rows)
    assert np.array_equal(got, ref), \
        "21: rows under the sync debug mode differ from phase 3's"
    blind = blind_spots(sites, ROOT)
    per_batch = {site: n / len(tables) for site, n in sites.items()}
    say(f"  21 [{card}]: {sum(sites.values())} syncs over "
        f"{len(tables)} batches ({[t.n_ions for t in tables]} ions), "
        f"{sum(sites.values()) / len(tables):.2f} a batch, by site "
        + json.dumps(per_batch)
        + (f"; {sites[UNATTRIBUTED]} outside the package"
           if UNATTRIBUTED in sites else ""))
    assert not blind, (
        f"21: syncs in hot modules on lines the host-sync rule does not see "
        f"as annotated: {blind}")
    say(f"phase 21 sync census [{card}]: {took:.3f} s for "
        f"{len(tables)} batches under the debug mode; every sync in a hot "
        "module on an annotated line, rows bit-equal to phase 3")
    return {"syncs": sites, "per_batch": per_batch, "batches": len(tables),
            "seconds": took}


# the job path's phases, in the order SearchJob runs them
JOB_PHASES = ("stage_input", "read_dataset", "decoy_selection",
              "isotope_patterns", "backend_setup", "score", "fdr",
              "store_results")


_LOG_TS = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) - ")


def _cli(args: list, what: str) -> dict:
    """Run the port's CLI as a subprocess (the repo on its path).  Returns
    its wall seconds, its standard output, the phases its log reports
    (``phase X done in Ys``), the seconds from launch to its first log line
    (interpreter start and imports) and from its last log line to its exit,
    and its trace file; raises on a nonzero exit."""
    import datetime
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    t_launch = time.time()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sm_distributed_tpu_torch.engine.cli", *args],
        capture_output=True, text=True, env=env, timeout=600)
    wall = time.perf_counter() - t0
    t_end = time.time()
    if proc.returncode != 0:
        raise RuntimeError(f"{what}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    stamps = [datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f")
              .timestamp() for m in map(_LOG_TS.match,
                                        proc.stderr.splitlines()) if m]
    phases = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"phase (\w+) done in ([0-9.]+)s", proc.stderr)}
    trace = re.search(r"trace written to (\S+)", proc.stderr)
    return {"wall_s": wall, "stdout": proc.stdout, "phases": phases,
            "to_first_log_s": stamps[0] - t_launch if stamps else None,
            "after_last_log_s": t_end - stamps[-1] if stamps else None,
            "trace": trace.group(1) if trace else None}


def _same_frame(got, want, what: str) -> None:
    """Two result frames equal: the same columns, rows in the same order,
    strings equal and numbers bit-equal."""
    assert list(got.columns) == list(want.columns), (what, list(got.columns))
    assert len(got) == len(want), (what, len(got), len(want))
    for col in want.columns:
        a, b = got[col].to_numpy(), want[col].to_numpy()
        if b.dtype.kind in "fiub":
            assert np.array_equal(a.astype(b.dtype), b, equal_nan=True), (
                f"{what}: column {col} differs")
        else:
            assert [str(v) for v in a] == [str(v) for v in b], (
                f"{what}: column {col} differs")


def write_imzml(ds, imzml: Path) -> Path:
    """``ds`` as a processed imzML/ibd pair at ``imzml``."""
    from sm_distributed_tpu_torch.io.imzml import ImzMLWriter

    rp = ds.row_ptr
    with ImzMLWriter(imzml) as wr:
        for i in range(ds.n_pixels):
            r, c = divmod(i, ds.ncols)
            wr.add_spectrum(c + 1, r + 1, ds.mzs_flat[rp[i]:rp[i + 1]],
                            ds.ints_flat[rp[i]:rp[i + 1]])
    return imzml


def phase_job_path(ds, truth, search, main: dict, tmp: Path) -> dict:
    """The README's Quickstart on the card: the main path's dataset written
    as an imzML/ibd pair, its formulas as a molecular-DB CSV, then the
    port's CLI as subprocesses — ``import-db``, ``run`` with a cold and then
    a warm isotope-pattern cache (one work dir, one results dir), and
    ``search --max-fdr 0.1`` — and one ``SearchJob`` in-process with the
    launch counts reset.  The stored results are held to phase 3's:
    annotations and all metrics bit-equal with identical FDR ranks, the
    ledger's job rows FINISHED, the search output listing the annotations
    at FDR <= 0.1, and the stored ion images bit-equal to the device image
    block's rows.  The imzML and the work dir stay in ``tmp`` for phase
    11."""
    from sm_distributed_tpu_torch.engine.search_job import SearchJob
    from sm_distributed_tpu_torch.engine.storage import (
        JobLedger,
        SearchResultsStore,
    )
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    t_start = time.perf_counter()
    # the dataset as an imzML/ibd pair, read back array by array
    t0 = time.perf_counter()
    imzml = write_imzml(ds, tmp / "main_path.imzML")
    t_write = time.perf_counter() - t0
    back = SpectralDataset.from_imzml(imzml)
    assert (back.nrows, back.ncols) == (ds.nrows, ds.ncols)
    for f in ("pixel_inds", "mask", "mzs_flat", "ints_flat", "row_ptr"):
        a, b = getattr(back, f), getattr(ds, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), (
            f"imzML round trip: {f} differs")
    del back
    (tmp / "formulas.csv").write_text(
        "id,formula\n" + "".join(f"m{i},{sf}\n" for i, sf in
                                 enumerate(truth.formulas)))
    sm_json, ds_json = tmp / "sm.json", tmp / "ds.json"
    sm_json.write_text(json.dumps({
        "device": "cuda", "work_dir": str(tmp / "work"),
        "fdr": {"decoy_sample_size": 20},
        "storage": {"results_dir": str(tmp / "results"),
                    "store_images": True, "image_format": "npz"}}))
    ds_json.write_text(json.dumps(
        {"database": {"name": "main_path", "version": "1"}}))
    cfg = ["--sm-config", str(sm_json)]
    steps = {"write_imzml": t_write,
             "read_back": time.perf_counter() - t0 - t_write}
    t0 = time.perf_counter()
    _cli(["import-db", str(tmp / "formulas.csv"), "main_path", "1", *cfg],
         "import-db")
    steps["import_db"] = time.perf_counter() - t0
    runs = {}
    res = tmp / "results" / "main"
    from sm_distributed_tpu_torch.utils.tracing import read_trace

    for label in ("cold", "warm"):
        t0 = time.perf_counter()
        out = _cli(["run", "main path", str(imzml), "--ds-id", "main",
                    "--ds-config", str(ds_json), *cfg],
                   f"run ({label} isotope patterns)")
        steps[f"run_{label}"] = time.perf_counter() - t0
        spans = {r["name"]: r["dur"] for r in read_trace(out["trace"])
                 if r.get("kind") == "span"}
        # decoy selection runs in the prefetch thread: its time is in
        # the stored timings, not in the log's phase lines
        tim = {**json.loads((res / "timings.json").read_text()),
               **out["phases"]}
        runs[label] = {
            "wall_s": out["wall_s"],
            "phases": {k: tim.get(k) for k in JOB_PHASES},
            "to_first_log_s": out["to_first_log_s"],
            "after_last_log_s": out["after_last_log_s"],
            # pattern generation and the prefetch's set-up (decoys,
            # cache-shard load, stream start), from the job's trace
            "isocalc_gen_s": spans.get("isocalc_gen"),
            "prefetch_setup_s": spans.get("isotope_prefetch_setup")}
        say(f"  job run, {label} isotope patterns: wall "
            f"{out['wall_s']:.3f} s (the CLI process; "
            f"{out['to_first_log_s']:.3f} s to its first log line, "
            f"{out['after_last_log_s']:.3f} s after its last); phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in
                        runs[label]["phases"].items() if v is not None)
            + f"; trace: isocalc_gen {spans.get('isocalc_gen')}, "
            f"isotope_prefetch_setup "
            f"{spans.get('isotope_prefetch_setup')}")
    t0 = time.perf_counter()
    out = _cli(["search", "--ds-id", "main", "--max-fdr", "0.1", *cfg],
               "search")["stdout"]
    steps["search"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    import pandas as pd

    ann = pd.read_parquet(res / "annotations.parquet")
    ref = main["bundle"]
    _same_frame(ann, ref.annotations.reset_index(drop=True),
                "stored annotations")
    _same_frame(pd.read_parquet(res / "all_metrics.parquet"),
                ref.all_metrics.reset_index(drop=True),
                "stored all_metrics")
    jobs = JobLedger(tmp / "results").jobs("main")
    assert list(jobs.status) == ["FINISHED", "FINISHED"], jobs
    passed = ann[ann.fdr_level <= 0.1]
    lines = [ln.split() for ln in out.strip().splitlines()[1:]]
    assert sorted((ln[2], ln[3]) for ln in lines) == sorted(
        zip(passed.sf, passed.adduct)), "search output"
    # the stored ion images against the device image block's rows
    stored, ions = SearchResultsStore.load_ion_images(
        res / "ion_images.npz")
    backend, table = search.last_backend, search.last_table
    row_of = {ion: i for i, ion in enumerate(zip(table.sfs,
                                                 table.adducts))}
    idx = [row_of[ion] for ion in ions]
    sub = type(table)(
        sfs=[table.sfs[i] for i in idx],
        adducts=[table.adducts[i] for i in idx], mzs=table.mzs[idx],
        ints=table.ints[idx], n_valid=table.n_valid[idx],
        targets=table.targets[idx])
    plan = backend._flat_plan(sub)
    block, _t, _nv = backend.image_block(sub, plan)
    order = plan[5][5]                  # block row j is ion order[j]
    real = np.nonzero(order < sub.n_ions)[0]
    dev_imgs = (block[torch.from_numpy(real).to(block.device), :,
                      :ds.n_pixels] / np.float32(backend.int_scale))
    want = torch.from_numpy(
        stored.reshape(len(ions), stored.shape[1], -1)[order[real]])
    assert torch.equal(dev_imgs.cpu(), want), "stored ion images"
    steps["hold_results"] = time.perf_counter() - t0
    say(f"  stored results: {len(ann)} annotations and "
        f"{len(ref.all_metrics)} ions bit-equal to phase 3's (FDR ranks "
        f"identical); ledger rows FINISHED; search lists the "
        f"{len(passed)} annotations at FDR <= 0.1; {len(ions)} stored ion "
        "image sets bit-equal to the device image block")
    # one SearchJob in-process: the kernels it launches, its device peak
    t0 = time.perf_counter()
    sm_cfg = SMConfig.from_dict(json.loads(sm_json.read_text()))
    job = SearchJob("main_inproc", "main path", imzml,
                    DSConfig.load(ds_json), sm_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_job = time.perf_counter()
    bundle = job.run()
    torch.cuda.synchronize()
    inproc_wall = time.perf_counter() - t_job
    launches = read_launches()
    n_batches = -(-table.n_ions // backend.batch)
    assert launches["moments"] == n_batches and \
        launches["chaos"] == n_batches, launches
    assert launches["chaos_tiles"] == 0 and launches["chaos_strips"] == 0 \
        and launches["fused_window_moments"] == 0, launches
    _same_frame(bundle.annotations.reset_index(drop=True),
                ref.annotations.reset_index(drop=True),
                "in-process job annotations")
    hbm = job.last_hbm
    steps["in_process"] = time.perf_counter() - t0
    say(f"  in-process SearchJob (warm patterns): wall {inproc_wall:.3f} "
        "s; phases " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 bundle.timings.items())
        + f"; launches {launches}; device peak {hbm}")
    took = time.perf_counter() - t_start
    say(f"phase 3b job path: {took:.1f} s (steps, s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in steps.items()) + "); "
        f"cold run {runs['cold']['wall_s']:.3f} s, warm run "
        f"{runs['warm']['wall_s']:.3f} s; isotope patterns "
        f"{runs['cold']['phases']['isotope_patterns']:.3f} -> "
        f"{runs['warm']['phases']['isotope_patterns']:.3f} s; device peak "
        f"{hbm['hbm_peak_bytes']} B; stored results bit-equal to phase 3")
    return {"runs": runs, "inproc_wall_s": inproc_wall,
            "inproc_timings": bundle.timings, "inproc_launches": launches,
            "hbm": hbm, "phase_s": took, "steps_s": steps}


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


def _kernels_vs_plain_chain(backend, table, ions: int | None = None) -> dict:
    """One batch's metrics through the kernels and through the plain chain,
    on the same image block (its first ``ions`` ions when given), under the
    component contracts, ion by ion:
    chaos bit-equal; for spatial, spectral and msm the kernels within the
    ulp contract of the f64 reference, and within the contract of the plain
    chain plus the plain chain's own distance from the reference at that
    ion (its f32 sums drift; see PERF.md), that slack capped at the
    contract itself, so no limit exceeds twice the contract."""
    from sm_distributed_tpu_torch.ops.metrics import batch_metrics

    imgs, theor, n_valid = backend.image_block(table)
    if ions is not None:
        imgs, theor, n_valid = imgs[:ions], theor[:ions], n_valid[:ions]
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
    for key, (adducts, preprocessing) in GOLDEN_SECTIONS.items():
        section = golden if key == "root" else golden[key]
        ds_cfg = DSConfig.from_dict(
            {**GOLDEN_DS, "isotope_generation": {"adducts": list(adducts)},
             "image_generation": {**GOLDEN_DS["image_generation"],
                                  "do_preprocessing": preprocessing}})
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
    say(f"phase 5 golden: 32x32 spheroid root, multi_adduct and "
        f"preprocessing (hot-spot clipping) match "
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
    from sm_distributed_tpu_torch.ops.quantize import expand_cube_range

    d = backend._device_plan(table)
    n_pix = backend.grid[0] * backend.grid[1]
    wh = flat_histogram(backend._px_s,
                        expand_cube_range(backend._in_s, backend._scales),
                        d["pos"], gc_width=d["gc_width"], n_pixels=n_pix)
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
    # more than K_MAX = 8 windows an ion: batch 0's windows three times over
    # (K = 12), one launch per row group, against the plain version
    n_ch = rlo.shape[0]
    r12 = [t.view(n_ch, -1, k).repeat(1, 1, 3).view(n_ch, -1).contiguous()
           for t in (rlo, rhi)]
    before = fused_window_moments.launches
    got12 = fused_window_moments(whp, starts, *r12, n_real, gc_width=gc,
                                 k=3 * k)
    assert fused_window_moments.launches - before == 2, (
        "fused K=12: one launch a row group")
    _ROW_GROUP_LAUNCHES[1] += 2
    want12 = fused_window_moments_torch(whp, starts, *r12, n_real,
                                        gc_width=gc, k=3 * k)
    assert torch.equal(got12[1], want12[1]), "fused K=12: principal rows"
    g12, w12 = got12[0].view(-1, 3 * k, 5), want12[0].view(-1, 3 * k, 5)
    for i, name in ((0, "sums"), (3, "vmax"), (4, "nn")):
        assert torch.equal(g12[..., i], w12[..., i]), f"fused K=12: {name}"
    # norms and dots against batch 0's f64 reference, repeated likewise
    ref12 = [r.repeat(1, 3) for r in ref64[1:3]]
    scale12 = torch.sqrt((ref12[0][:, 0:1] * ref12[0]).clamp(min=0))
    gap12 = {}
    for name, i, dist in (("normsq", 1, ulps),
                          ("dots", 2, lambda a, b: ulps_at(a - b, scale12))):
        to_ref = float(dist(g12[..., i], ref12[i - 1]).max())
        assert to_ref <= MOMENT_ULPS, f"fused K=12: {name} {to_ref} ulp"
        gap12[name] = to_ref
    say(f"  fused kernel K = 12 (batch 0's windows three times, 2 row-group "
        "launches): sums, vmax, nn and principal rows bit-equal to the plain "
        f"version; norms and dots within {gap12} ulp of f64")
    del got12, want12, r12
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
               "bundle": bundle,
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


def phase_preprocessed(ds, truth, search, main: dict) -> dict:
    """The main path's dataset and ions with hot-spot preprocessing
    (``image_generation.do_preprocessing``), at the shipped defaults
    otherwise: its device peak (the clip sorts the block in ion groups), and
    batch 0's clipped block through the kernels against f64 (spatial,
    spectral and msm within the contracts) and, on its first 256 ions, the
    plain chain (chaos bit-equal).  The plain chain's own distance from f64
    is reported, not
    held: its f32 sums drift far on some clipped images (on an H100, up to
    177 ulp in spatial and 253 in msm on the first batch, where the
    kernels stay within 16 and 32 of f64).  There is
    no other search to hold the rows to: the clip changes the metrics."""
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.ops.metrics import (
        batch_metrics,
        hotspot_clip_batch,
    )
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    t_start = time.perf_counter()
    pre = MSMBasicSearch(ds, truth.formulas, DSConfig.from_dict(
        {"image_generation": {"do_preprocessing": True}}),
        SMConfig.from_dict({"fdr": {"decoy_sample_size": 20}}))
    pre.isocalc = search.isocalc         # the main path's warm patterns
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    bundle = pre.search()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    table, backend = pre.last_table, pre.last_backend
    variants = dict(backend.variant_counts)
    n_batches = -(-table.n_ions // backend.batch)
    tim = bundle.timings
    say(f"  preprocessed main path: {table.n_ions} ions in {n_batches} "
        f"batches; wall {wall:.3f} s; phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in tim.items())
        + f"; {table.n_ions / tim['score']:.1f} ions/s scored; peak device "
        f"memory {peak / 2**30:.2f} GiB (unclipped "
        f"{main['peak_bytes'] / 2**30:.2f}); launches {launches}; variants "
        f"{variants}")
    assert launches["moments"] >= n_batches and \
        launches["chaos"] == n_batches, launches
    assert variants["fused"] == 0
    rows = bundle.all_metrics[list(CONTRACT)].to_numpy()
    t_b0 = _slice_table(table, 0, backend.batch)
    assert np.array_equal(backend.score_batch(t_b0), rows[:t_b0.n_ions]), \
        "re-scored preprocessed batch differs from the search's rows"
    assert not np.array_equal(rows, main["bundle"].all_metrics[
        list(CONTRACT)].to_numpy()), "the clip changed no metric"
    imgs, theor, n_valid = backend.image_block(t_b0)
    hotspot_clip_batch(imgs, backend.q)
    to_f64, kern = _kernels_vs_f64(backend, imgs, theor, n_valid)
    nrows, ncols = backend.grid
    # the plain chaos version takes ~9 ms an image: 256 of the 2048
    sub = slice(0, 256)
    plain = batch_metrics(imgs[sub].clone(), theor[sub], n_valid[sub], nrows,
                          ncols, backend.nlevels, n_real=backend.n_real,
                          plain=True)
    assert torch.equal(kern[sub, 0], plain[:, 0]), "chaos: kernels vs plain"
    ref = _metrics_f64(imgs[sub], theor[sub], n_valid[sub], backend.n_real,
                       kern[sub, 0])
    plain_to_f64 = {comp: int(ulps(plain[:, col], ref[:, col]).max())
                    for col, comp in list(enumerate(CONTRACT))[1:]}
    del imgs, ref
    say(f"phase 7b preprocessed main path: "
        f"{time.perf_counter() - t_start:.1f} s; batch 0's clipped block: "
        f"kernels' ulp gaps to f64 {to_f64}; first 256 ions: chaos "
        f"bit-equal to the plain chain, whose ulp gaps to f64 are "
        f"{plain_to_f64}")
    return {"wall_s": wall, "timings": tim, "peak_bytes": peak,
            "launches": launches, "ions_per_s": table.n_ions / tim["score"],
            "variant_counts": variants,
            "kernels_to_f64": to_f64, "plain_to_f64": plain_to_f64}


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
    masks = _random_images(4, WS_SIDE * WS_SIDE, dev, gen)
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
    _check_chaos_strips(blobs[:2], WS_SIDE, nlevels, "smooth blobs", n_scipy=2)
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
    big = _random_images(1, 4 * WS_SIDE * WS_SIDE, dev, gen)
    _check_chaos_strips(big, 2 * WS_SIDE, nlevels, "random masks",
                        plane=True, n_scipy=1)
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


def _device_kernels_ms(fn) -> dict:
    """Device milliseconds of one call of ``fn`` by kernel name, from a
    torch.profiler trace of the card (after a warm-up call); empty when the
    trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from sm_distributed_tpu_torch.analysis.profiling import kernel_name

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if "CUDA" in str(e.device_type):
            name = kernel_name(e.name)
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _histograms(backend, table, plan) -> dict:
    """The histogram step of one batch, by variant, as zero-argument calls:
    the scratch's fixed cost alone (no peak slot), every resident slot
    (plain), the band's slots (band) and the kept slots gathered then
    scattered (compact), each with its slot count."""
    from sm_distributed_tpu_torch.ops.imager import compact_peaks, flat_histogram

    d = backend._device_plan(table, plan)
    geo = dict(gc_width=d["gc_width"],
               n_pixels=backend.grid[0] * backend.grid[1])
    px, ints, pos = backend._px_s, backend._in_s, d["pos"]
    b_lo, width = plan.band
    run_pos, run_delta, n_b, pos_b = plan.runs
    run_pos, run_delta, pos_b = (backend._put(a, torch.int64)
                                 for a in (run_pos, run_delta, pos_b))
    pos_band = torch.clamp(pos - b_lo, 0, width)

    def compact():
        px_b, in_b = compact_peaks(px, ints, run_pos, run_delta, n_b)
        return flat_histogram(px_b, in_b, pos_b, **geo)

    return {
        "fixed": (0, lambda: flat_histogram(px[:0], ints[:0],
                                            torch.zeros_like(pos), **geo)),
        "plain": (px.numel(), lambda: flat_histogram(px, ints, pos, **geo)),
        "band": (width, lambda: flat_histogram(
            px[b_lo:b_lo + width], ints[b_lo:b_lo + width], pos_band,
            **geo)),
        "compact": (n_b, compact),
    }


def phase_ordered_stream() -> tuple[dict, dict]:
    """Bench.py's ``scale`` case through ``MSMBasicSearch`` at the shipped
    defaults: an m/z-ordered stream of 6 batches, whose variant rule may
    take the band or compact extraction.  The same stream scored with both
    modes "off" (plain; the first search, with the cold isotope patterns)
    and with compaction forced "on" must give the same bits and FDR ranks;
    each search's backend is dropped before the next, so each device peak
    is its own.  Prints the variant counts, the per-batch device ms by
    variant, the histogram's host plan and device kernels, the marginal ns
    a slot of the scatter and of the compaction that the rule weighs
    (``models/msm_torch.py``), ions/s and the device peak.  Returns the
    phase's results and its oracle patterns (the first search's wrapper,
    its table and its cold generation stats) for phase 13."""
    from sm_distributed_tpu_torch.io.fixtures import (
        expand_formula_list,
        synthetic_dataset_arrays,
    )
    from sm_distributed_tpu_torch.models import msm_torch
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    t_start = time.perf_counter()
    ds, truth = synthetic_dataset_arrays(
        NROWS, NCOLS, formulas=expand_formula_list(OS_FORMULAS),
        present_fraction=0.6, noise_peaks=OS_NOISE_PEAKS, seed=7)
    ds_cfg = DSConfig.from_dict(OS_DS)
    t_ds = time.perf_counter() - t_start
    runs = {}
    isocalc = None
    oracle_stats = {}
    for label, parallel in (("off", {"band_slice": "off",
                                     "peak_compaction": "off"}),
                            ("compact", {"peak_compaction": "on"}),
                            ("auto", {})):
        search = MSMBasicSearch(ds, truth.formulas, ds_cfg, SMConfig.from_dict(
            {**OS_SM, "parallel": parallel}))
        if isocalc is not None:
            search.isocalc = isocalc         # the first search's patterns
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        bundle = search.search()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        isocalc = search.isocalc
        if label == "off":
            oracle_stats = dict(isocalc.last_stats)
        backend, table = search.last_backend, search.last_table
        runs[label] = {
            "bundle": bundle, "backend": backend, "table": table,
            "wall_s": wall, "timings": bundle.timings,
            "launches": read_launches(),
            "variant_counts": dict(backend.variant_counts),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "ions_per_s": table.n_ions / bundle.timings["score"]}
        r = runs[label]
        say(f"  ordered stream, {label}: wall {wall:.3f} s; phases "
            + ", ".join(f"{k} {v:.3f} s" for k, v in r["timings"].items())
            + f"; {r['ions_per_s']:.1f} ions/s scored; variants "
            f"{r['variant_counts']}; peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB; launches {r['launches']}")
        if label != "auto":
            del search, backend, r["backend"]
            torch.cuda.empty_cache()
    auto = runs["auto"]
    table, backend = auto["table"], auto["backend"]
    n_batches = -(-table.n_ions // backend.batch)
    assert n_batches >= 6 and bool(np.all(np.diff(table.mzs[:, 0]) >= 0)), \
        "order_ions=auto must order a stream of 6 batches or more by m/z"
    counts = auto["variant_counts"]
    assert sum(counts.values()) == n_batches and counts["fused"] == 0, counts
    assert counts["band"] + counts["compact"] > 0, (
        f"no batch of the ordered stream left the plain variant: {counts}")
    assert runs["off"]["variant_counts"]["plain"] == n_batches
    assert runs["compact"]["variant_counts"]["compact"] == n_batches
    for label, r in runs.items():
        assert r["launches"]["moments"] >= n_batches, (label, r["launches"])
        assert r["launches"]["chaos"] == n_batches, (label, r["launches"])
    ref = auto["bundle"]
    for label in ("off", "compact"):
        got = runs[label]["bundle"]
        a, b = ref.all_metrics, got.all_metrics
        assert a.sf.tolist() == b.sf.tolist() and \
            a.adduct.tolist() == b.adduct.tolist(), label
        assert np.array_equal(a[list(CONTRACT)].to_numpy(),
                              b[list(CONTRACT)].to_numpy()), (
            f"{label}: metrics differ from the auto stream's")
        ra, rb = ref.annotations, got.annotations
        assert [(x.sf, x.adduct) for x in ra.itertuples()] == [
            (x.sf, x.adduct) for x in rb.itertuples()], label
        for col in ("msm", "fdr", "fdr_level"):
            assert np.array_equal(ra[col].to_numpy(), rb[col].to_numpy()), (
                label, col)
    ann = ref.annotations
    hits = set(ann[ann.fdr_level <= 0.1].sf)
    recall = (sum(str(sf) in hits for sf in truth.present)
              / len(truth.present))
    assert recall >= 0.5, f"ordered stream recall {recall:.3f}"
    # per batch: the plan, each variant's device ms for the whole batch,
    # and its histogram's
    batch_ms, hist_ms, slots, plan_ms, chosen = [], [], [], [], []
    for s in range(0, table.n_ions, backend.batch):
        t = _slice_table(table, s, min(s + backend.batch, table.n_ions))
        t0 = time.perf_counter()
        plan = backend._flat_plan(t)
        plan_ms.append(1e3 * (time.perf_counter() - t0))
        chosen.append(backend._variant_for(plan.runs, plan.band))
        batch_ms.append({v: time_ms(lambda: backend._dispatch(t, plan, v),
                                    reps=3, warmup=1) for v in VARIANTS})
        calls = _histograms(backend, t, plan)
        slots.append({v: n for v, (n, _fn) in calls.items()})
        hist_ms.append({v: time_ms(fn, reps=5, warmup=1)
                        for v, (_n, fn) in calls.items()})
        del calls

    def rate(v):
        """ns a slot over the stream's slots of variant ``v``."""
        return (1e6 * sum(h[v] - h["fixed"] for h in hist_ms)
                / sum(n[v] for n in slots))

    rates = {"scatter_ns_per_slot": rate("plain"),
             "band_ns_per_slot": rate("band"),
             "compact_ns_per_slot": rate("compact"),
             "in_code": {"SCATTER_NS_PER_SLOT": msm_torch.SCATTER_NS_PER_SLOT,
                         "COMPACT_NS_PER_SLOT": msm_torch.COMPACT_NS_PER_SLOT}}
    for i, (b, h, n) in enumerate(zip(batch_ms, hist_ms, slots)):
        say(f"  batch {i} ({chosen[i]}): device ms " + ", ".join(
            f"{v} {b[v]:.3f}" for v in VARIANTS) + "; histogram ms "
            + ", ".join(f"{v} {h[v]:.3f} ({n[v]} slots)" for v in h)
            + f"; host plan {plan_ms[i]:.3f} ms")
    # the stream again on the warm auto backend, as score_batches runs it
    # (plan every batch, enqueue every batch, fetch), by the rule and
    # forced plain, in turns: host walls that the search's score phase
    # holds besides its presize pass
    batches = [_slice_table(table, s, min(s + backend.batch, table.n_ions))
               for s in range(0, table.n_ions, backend.batch)]

    def stream_wall(variant):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans = [backend._flat_plan(t) for t in batches]
        outs = [backend._dispatch(t, pl, variant)
                for t, pl in zip(batches, plans)]
        for o in outs:
            o.cpu()
        return time.perf_counter() - t0

    walls = {"auto": [], "plain": []}
    for _ in range(3):
        for v in ("auto", "plain", "plain", "auto"):
            walls[v].append(stream_wall(None if v == "auto" else v))
    say("  the stream again on the warm backend, s (rule, forced plain; "
        "in turns): " + json.dumps(walls))
    # the histogram split: host plan (above) and the device kernels of the
    # plain histogram of batch 0 (torch.profiler)
    t0_table = _slice_table(table, 0, backend.batch)
    plan0 = backend._flat_plan(t0_table)
    split = {v: _device_kernels_ms(fn) for v, (_n, fn) in
             _histograms(backend, t0_table, plan0).items()
             if v in ("plain", chosen[0])}
    say("  batch 0 histogram device kernels, ms (torch.profiler): "
        + json.dumps({v: {k: round(x, 3) for k, x in list(ks.items())[:4]}
                      for v, ks in split.items()}))
    say(f"  marginal ns a slot over the stream (histogram ms less the "
        f"scratch's fixed cost, over the slots): plain scatter "
        f"{rates['scatter_ns_per_slot']:.4f}, band scatter "
        f"{rates['band_ns_per_slot']:.4f}, compact gather + scatter "
        f"{rates['compact_ns_per_slot']:.4f}; the rule uses "
        f"{rates['in_code']}")
    off = runs["off"]
    say(f"phase 9 ordered stream: {time.perf_counter() - t_start:.1f} s "
        f"(dataset {t_ds:.1f} s); {table.n_ions} ions in {n_batches} "
        f"batches; variants {counts}; {auto['ions_per_s']:.1f} ions/s at "
        f"auto against {off['ions_per_s']:.1f} forced plain; bit-equal "
        "to the plain and the forced-compact streams, FDR ranks identical; "
        f"recall {recall:.3f}")
    return {"n_ions": table.n_ions, "n_batches": n_batches,
            "n_peaks": ds.n_peaks, "resident_slots": slots[0]["plain"],
            "variant_counts": counts, "chosen": chosen,
            "runs": {k: {x: r[x] for x in (
                "wall_s", "timings", "ions_per_s", "variant_counts",
                "peak_bytes", "launches")} for k, r in runs.items()},
            "batch_ms": batch_ms, "histogram_ms": hist_ms, "slots": slots,
            "host_plan_ms": plan_ms, "histogram_kernels_ms": split,
            "rates": rates, "recall": recall, "stream_walls_s": walls,
            "phase_s": time.perf_counter() - t_start}, {
                "isocalc": isocalc, "table": table, "ds_cfg": ds_cfg,
                "stats": oracle_stats,
                "patterns_s": off["timings"]["isotope_patterns"]}


# ------------------------------------------------ phase 10: resilience
# the formulas of the breaker runs: a cut depth, since the breaker's
# transitions do not depend on it
BREAKER_FORMULAS = 10
# ions of each new path's first batch whose metrics go through the kernels
# and their plain versions (plain chaos takes ~9 ms an image at 256x256)
PLAIN_IONS = 64


def _breaker_closed(refused: int, after: str) -> None:
    """Every device breaker of the process closed (the process breaker
    and each leased chip's), and exactly ``refused`` jobs refused so far
    (step 10.3's): no path met a device fault that the script did not
    inject."""
    from sm_distributed_tpu_torch.models import breaker

    breaker.get_device_breaker()
    for lbl, snap in breaker.breakers_snapshot().items():
        assert snap["state"] == "closed", \
            f"after {after}: breaker {lbl} {snap}"
    n = breaker.refused_count()
    assert n == refused, (
        f"after {after}: {n} refused jobs, expected {refused}")


class _SortedLayoutOnce:
    """Phase 10's searches after step 10.1 all score the main dataset: its
    global m/z sort (``prepare_flat_sorted_arrays``, a deterministic
    function of the dataset and ppm) is taken once and handed to each
    backend, which still restricts, pads, compacts and uploads its own
    resident arrays.  Keeps the phase's many searches within its time; the
    walls of those searches leave the sort out (step 10.1's searches run
    the port's own set-up, sort included).  The sort is taken on entry,
    outside every timed search.  ``memo`` (a dict) keeps the sort past
    the block, for a later phase on the same dataset (phase 20)."""

    def __init__(self, ds, ppm: float, memo: dict | None = None):
        self._ds, self._ppm = ds, ppm
        self._memo = {} if memo is None else memo

    def __enter__(self):
        from sm_distributed_tpu_torch.models import msm_torch

        self._mod, self._orig = msm_torch, msm_torch.prepare_flat_sorted_arrays
        memo = self._memo
        key = (id(self._ds), self._ppm)
        if key not in memo:
            memo[key] = self._orig(self._ds, self._ppm)

        def once(ds, ppm):
            key = (id(ds), ppm)
            if key not in memo:
                memo[key] = self._orig(ds, ppm)
            return memo[key]

        msm_torch.prepare_flat_sorted_arrays = once
        return self

    def __exit__(self, *exc):
        self._mod.prepare_flat_sorted_arrays = self._orig
        return False


def _search_run(search) -> tuple:
    """(bundle, wall seconds, launches, device peak bytes) of one search,
    the launch counts set to 0 just before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    bundle = search.search()
    torch.cuda.synchronize()
    return (bundle, time.perf_counter() - t0, read_launches(),
            torch.cuda.max_memory_allocated())


def _refused_run(search) -> tuple:
    """(wall seconds, launches, the error) of one search that must fail
    with ``DeviceUnavailableError``, the launch counts set to 0 just before
    it."""
    from sm_distributed_tpu_torch.models.breaker import DeviceUnavailableError

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        search.search()
    except DeviceUnavailableError as exc:
        err = exc
    else:
        raise AssertionError("the search was not refused")
    torch.cuda.synchronize()
    return time.perf_counter() - t0, read_launches(), err


def _bit_equal(bundle, ref, label: str) -> None:
    import pandas as pd

    pd.testing.assert_frame_equal(bundle.annotations, ref.annotations,
                                  check_exact=True, obj=f"{label} annotations")
    pd.testing.assert_frame_equal(bundle.all_metrics, ref.all_metrics,
                                  check_exact=True, obj=f"{label} metrics")


def _ranks_differing(bundle, ref) -> dict:
    """Between two searches of the same ions: the annotations whose
    position in the ranked order differs, and those whose fdr differs."""
    a, r = bundle.annotations, ref.annotations
    keys_a = list(zip(a.sf, a.adduct))
    keys_r = list(zip(r.sf, r.adduct))
    fdr_a = dict(zip(keys_a, a.fdr))
    return {"position": sum(x != y for x, y in zip(keys_a, keys_r)),
            "fdr": sum(fdr_a[k] != f for k, f in zip(keys_r, r.fdr)),
            "of": len(keys_r)}


def _check_fused(backend, table) -> dict:
    """The fused kernel against its plain version on one batch's
    histogram: principal rows, sums, vmax and nn bit-equal; norms and dots
    within MOMENT_ULPS of f64."""
    from sm_distributed_tpu_torch.ops.imager import banded_images
    from sm_distributed_tpu_torch.ops.moments import batch_moments_torch
    from sm_distributed_tpu_torch.ops.score import (
        fused_window_moments,
        fused_window_moments_torch,
    )

    k = table.max_peaks
    whp, starts, rlo, rhi, n_real, gc = _histogram_block(backend, table)
    args = (whp, starts, rlo, rhi, n_real)
    got = fused_window_moments(*args, gc_width=gc, k=k)
    want = fused_window_moments_torch(*args, gc_width=gc, k=k)
    block = banded_images(whp, starts, rlo, rhi, gc_width=gc).view(
        -1, k, whp.shape[1])
    ref64 = [r.float() for r in batch_moments_torch(block.double(), n_real)]
    del block
    assert torch.equal(got[1], want[1]), "fused: principal rows differ"
    gp, wp = got[0].view(-1, k, 5), want[0].view(-1, k, 5)
    for i, name in ((0, "sums"), (3, "vmax"), (4, "nn")):
        assert torch.equal(gp[..., i], wp[..., i]), f"fused: {name} differ"
    scale = torch.sqrt((ref64[1][:, 0:1] * ref64[1]).clamp(min=0))
    gaps = {}
    for name, i, dist in (("normsq", 1, ulps),
                          ("dots", 2, lambda a, b: ulps_at(a - b, scale))):
        to_ref = float(dist(gp[..., i], ref64[i]).max())
        assert to_ref <= MOMENT_ULPS, f"fused: {name} {to_ref} ulp from f64"
        gaps[name] = to_ref
    return gaps


def _variant_costs(backend, table) -> dict:
    """One batch forced through each flat variant: the transient device
    bytes (the peak over what is allocated before it) and the device ms
    (CUDA events, median of 3).  A compact cube expands the band's or the
    gathered slots, or the whole cube for plain and fused."""
    plan = backend._flat_plan(table)
    out = {}
    for v in ("plain", "band", "compact", "fused"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        backend._dispatch(table, plan, v)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        ms = time_ms(lambda: backend._dispatch(table, plan, v), reps=3,
                     warmup=1)
        out[v] = {"transient_bytes": extra, "ms": ms}
    return out


def _kernels_held(backend, table) -> dict:
    """The path's kernels against their plain versions on the first
    ``PLAIN_IONS`` ions of one batch (the fused kernel on the whole batch's
    histogram when the backend fuses)."""
    if backend._fused:
        return {"fused_to_f64": _check_fused(backend, table)}
    return {"kernels_plain_f64": _kernels_vs_plain_chain(
        backend, table, ions=PLAIN_IONS)}


def phase_resilience(card: str, ds, truth, search, ds_cfg, main: dict,
                     sorts: dict | None = None) -> dict:
    """Phase 10: checkpoint and resume, a real CUDA OOM backed off from,
    the breaker and the fault taxonomy by injection, and bf16 / int8
    resident cubes, on the main path's dataset and ions.  Every line
    carries the card's name and power limit.  Returns each path's launch
    counts and the figures the summary prints.  ``sorts`` keeps the shared
    m/z sort for phase 20."""
    import gc as pygc

    from sm_distributed_tpu_torch.models import breaker, oom
    from sm_distributed_tpu_torch.models.breaker import DeviceUnavailableError
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.ops.quantize import (
        compact_cube,
        expand_cube,
    )
    from sm_distributed_tpu_torch.utils import failpoints
    from sm_distributed_tpu_torch.utils.config import SMConfig

    t_phase = time.perf_counter()
    ref = main["bundle"]
    out = {"launches": {}}

    def make(formulas=None, checkpoint_dir=None, **blocks):
        s = MSMBasicSearch(
            ds, truth.formulas if formulas is None else formulas, ds_cfg,
            SMConfig.from_dict({"fdr": {"decoy_sample_size": 20}, **blocks}),
            checkpoint_dir=checkpoint_dir)
        s.isocalc = search.isocalc     # the main path's warm patterns
        return s

    def line(msg: str) -> None:
        say(f"  [{card}] {msg}")

    # -- 1. checkpoint and resume: the port's own set-up, sort included
    t0 = time.perf_counter()
    par = {"checkpoint_every": 1}
    with tempfile.TemporaryDirectory() as td:
        ck = Path(td)
        failpoints.configure("device.score_batch=raise:RuntimeError@3")
        try:
            make(checkpoint_dir=td, parallel=par).search()
            raise AssertionError("the killed search did not die")
        except RuntimeError as exc:
            assert "device.score_batch" in str(exc), exc
        finally:
            failpoints.configure(None)
        shards = sorted(ck.glob("msm_search.p0.g*.ckpt.npz"))
        assert len(shards) == 2, shards
        resumed = make(checkpoint_dir=td, parallel=par)
        bundle, wall, launches, peak = _search_run(resumed)
        n_groups = len(shards) + 1
        assert launches["moments"] == 1 and launches["chaos"] == 1, (
            f"the resumed search must score 1 of {n_groups} groups: "
            f"{launches}")
        _bit_equal(bundle, ref, "resumed search")
        resumed.last_checkpoint.finalize()
        assert not list(ck.glob("msm_search.p0.g*")), "shards left"
    table = resumed.last_table
    held = _kernels_held(resumed.last_backend,
                         _slice_table(table, 4096, table.n_ions))
    out["launches"]["resume"] = launches
    out["resume"] = {"groups": n_groups, "rescored_groups": 1,
                     "wall_s": wall, "peak_bytes": peak, **held}
    line(f"10.1 checkpoint and resume: killed before group 2 of "
         f"{n_groups} (device.score_batch), 2 durable shards; the rerun "
         f"resumed 2 groups and scored 1 batch (launches {launches}), "
         f"wall {wall:.3f} s with its full set-up (backend set-up "
         f"{bundle.timings['backend_setup']:.3f} s, the global m/z sort "
         f"included; score {bundle.timings['score']:.3f} s), bit-equal "
         f"to phase 3; shards removed by finalize(); kernels vs plain on "
         f"{PLAIN_IONS} ions {json.dumps(held)} "
         f"({time.perf_counter() - t0:.1f} s)")
    out["resume"]["setup_s"] = bundle.timings["backend_setup"]
    out["resume"]["score_s"] = bundle.timings["score"]
    _breaker_closed(0, "10.1")

    with _SortedLayoutOnce(ds, ds_cfg.image_generation.ppm, sorts):

        # -- 2. a real CUDA OOM ------------------------------------------
        t0 = time.perf_counter()
        backend = resumed.last_backend
        b0 = _slice_table(table, 0, 2048)
        pygc.collect()
        torch.cuda.empty_cache()
        peaks = {}
        for batch in (2048, 1024):
            backend.shrink_batch(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            backend.score_batches([_slice_table(b0, 0, batch)])
            torch.cuda.synchronize()
            peaks[batch] = torch.cuda.max_memory_allocated()
        del backend, resumed, bundle
        pygc.collect()
        torch.cuda.empty_cache()
        total = torch.cuda.get_device_properties(0).total_memory
        gap = peaks[2048] - peaks[1024]
        assert gap > (512 << 20), (
            f"no memory fraction separates a batch of 2048 "
            f"({peaks[2048]} B at peak) from one of 1024 ({peaks[1024]} B)")
        cap = peaks[1024] + gap // 2
        key = oom.shape_key(ds.n_pixels, "torch_cuda", None)
        oom.reset()
        torch.cuda.set_per_process_memory_fraction(cap / total, 0)
        try:
            first = make()
            bundle, wall, launches, peak = _search_run(first)
            events = oom.snapshot()
            converged = oom.safe_batch_for(key)
            assert events["events"] >= 1, "no CUDA OOM was raised"
            assert converged is not None and converged <= 1024, converged
            _bit_equal(bundle, ref, "OOM backoff search")
            _breaker_closed(0, "10.2 OOM search")
            out["launches"]["oom"] = launches
            second = make()
            bundle2, wall2, launches2, peak2 = _search_run(second)
            assert second._batch_eff == converged, second._batch_eff
            assert oom.snapshot()["events"] == events["events"], (
                "the second search on the shape raised an OOM")
            _bit_equal(bundle2, ref, "search at the learned batch")
            out["launches"]["oom_learned"] = launches2
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, 0)
            oom.reset()
        held = _kernels_held(second.last_backend,
                             _slice_table(table, 0, converged))
        del first, second, bundle, bundle2
        out["oom"] = {"cap_bytes": cap, "total_bytes": total,
                      "fraction": cap / total,
                      "peak_2048_bytes": peaks[2048],
                      "peak_1024_bytes": peaks[1024],
                      "converged_batch": converged,
                      "oom_events": events["events"],
                      "wall_s": wall, "peak_bytes": peak,
                      "learned_wall_s": wall2, "learned_peak_bytes": peak2,
                      **held}
        line(f"10.2 CUDA OOM: peaks {peaks[2048]} B at a batch of 2048 and "
             f"{peaks[1024]} B at 1024; cap {cap} B (fraction "
             f"{cap / total:.6f} of {total} B); the search raised "
             f"{events['events']} OOM(s), logged oom_backoff and converged "
             f"to a batch of {converged}, wall {wall:.3f} s (set-up on the "
             f"shared sort), peak {peak} B, "
             f"bit-equal to phase 3, breaker closed, none refused "
             f"(launches {launches}); a second search started at "
             f"{converged}, raised no OOM, wall {wall2:.3f} s, bit-equal; "
             f"kernels vs plain {json.dumps(held)}; fraction restored to "
             f"1.0 ({time.perf_counter() - t0:.1f} s)")
        _breaker_closed(0, "10.2")

        # -- 3. breaker and taxonomy, by injection -----------------------
        t0 = time.perf_counter()
        few = truth.formulas[:BREAKER_FORMULAS]
        svc = {"service": {"breaker_cooldown_s": 0.0}}
        device_ref, wall_ref, launches_ref, _ = _search_run(make(few, **svc))
        n_ions = len(device_ref.all_metrics)
        out["launches"]["breaker_device"] = launches_ref
        snap0 = breaker.get_device_breaker().snapshot()
        failpoints.configure("backend.chip_fault=raise:TimeoutError")
        try:
            make(few, **svc).search()
            raise AssertionError("the transient fault did not raise")
        except TimeoutError:
            pass
        finally:
            failpoints.configure(None)
        snap = breaker.get_device_breaker().snapshot()
        assert snap["failures"] == snap0["failures"] == 0 \
            and snap["state"] == "closed", snap
        line(f"10.3 breaker runs: the main dataset's first {len(few)} "
             f"formulas, {n_ions} ions a run, walls with set-up on the "
             f"shared sort; the device search wall "
             f"{wall_ref:.3f} s; backend.chip_fault=raise:TimeoutError "
             "raised, breaker count unchanged (transient)")
        failpoints.configure("backend.chip_fault=raise:RuntimeError")
        try:
            for i in (1, 2):
                try:
                    make(few, **svc).search()
                    raise AssertionError(f"sticky fault {i} did not raise")
                except DeviceUnavailableError:
                    raise AssertionError(
                        f"sticky fault {i} opened the breaker early")
                except RuntimeError as exc:
                    assert "backend.chip_fault" in str(exc), exc
                snap = breaker.get_device_breaker().snapshot()
                assert snap["failures"] == i and snap["state"] == "closed"
            third = make(few, **svc)
            wall_open, launches_open, err = _refused_run(third)
        finally:
            failpoints.configure(None)
        assert "backend.chip_fault" in str(err.__cause__), err.__cause__
        assert breaker.get_device_breaker().state == "open"
        assert breaker.refused_count() == 1
        assert third.last_backend.name == "torch_cuda"
        assert all(v == 0 for v in launches_open.values()), launches_open
        out["launches"]["sticky_open"] = launches_open
        line(f"10.3 sticky: two raise:RuntimeError searches raised (breaker "
             f"count 1, 2); the third opened the breaker and failed with "
             f"DeviceUnavailableError (refused 1, nothing scored on the "
             f"host): wall {wall_open:.3f} s, launches {launches_open}")
        refused = make(few, service={"breaker_cooldown_s": 3600.0})
        wall_refused, launches_refused, err = _refused_run(refused)
        assert breaker.get_device_breaker().state == "open"
        assert breaker.refused_count() == 2 and refused.last_backend is None
        assert all(v == 0 for v in launches_refused.values()), \
            launches_refused
        out["launches"]["refused"] = launches_refused
        line(f"10.3 open: a search within the cooldown was refused before "
             f"any device work (refused 2): wall {wall_refused:.3f} s, "
             f"launches {launches_refused}")
        probe = make(few, **svc)
        probed, wall_probe, launches_probe, _ = _search_run(probe)
        transitions = [t for _, _, t in
                       breaker.get_device_breaker().transitions]
        assert transitions[-3:] == ["open", "half_open", "closed"], \
            transitions
        assert probe.last_backend.name == "torch_cuda"
        _bit_equal(probed, device_ref, "half-open probe")
        out["launches"]["probe"] = launches_probe
        out["breaker"] = {"formulas": len(few), "ions": n_ions,
                          "device_wall_s": wall_ref,
                          "opened_wall_s": wall_open,
                          "refused_wall_s": wall_refused,
                          "probe_wall_s": wall_probe}
        line(f"10.3 half-open: after breaker_cooldown_s 0 the next search "
             f"probed the card, closed the breaker and is bit-equal to the "
             f"device search (wall {wall_probe:.3f} s, launches "
             f"{launches_probe}); a real sticky CUDA error is not provoked: "
             "it would poison the process's CUDA context for every later "
             f"phase ({time.perf_counter() - t0:.1f} s)")
        _breaker_closed(2, "10.3")

        # -- 5. compact resident cubes -----------------------------------
        t0 = time.perf_counter()
        twin = search.last_backend           # phase 3's f32 backend
        f32_codes = twin._in_s
        out["cubes"] = {}
        host = f32_codes.cpu().numpy()
        for label, dtype, fused in (("f32", "f32", "auto"),
                                    ("bf16", "bf16", "auto"),
                                    ("int8", "int8", "auto"),
                                    ("bf16_fused", "bf16", "on")):
            run = make(parallel={"cube_dtype": dtype, "fused_metrics": fused})
            bundle, wall, launches, peak = _search_run(run)
            backend = run.last_backend
            assert backend.cube_dtype == dtype
            assert torch.equal(backend._px_s, twin._px_s), \
                "the compact search's resident slots differ from phase 3's"
            variants = dict(backend.variant_counts)
            # the f32 search on the host-expanded cube: phase 3's backend
            # with its intensities swapped, every batch rescored
            codes, scales = compact_cube(host, dtype)
            twin._in_s = torch.from_numpy(
                expand_cube(codes, scales).copy()).to(f32_codes.device)
            try:
                rows = []
                for s in range(0, run.last_table.n_ions, twin.batch):
                    t = _slice_table(run.last_table, s,
                                     min(s + twin.batch,
                                         run.last_table.n_ions))
                    o = twin._dispatch(t, twin._flat_plan(t),
                                       "fused" if fused == "on" else None)
                    rows.append(o[:t.n_ions].cpu().numpy().astype(np.float64))
            finally:
                twin._in_s = f32_codes
            got_rows = bundle.all_metrics[list(CONTRACT)].to_numpy()
            assert np.array_equal(got_rows, np.concatenate(rows)), (
                f"{label}: not bit-equal to the f32 search on the "
                "host-expanded cube")
            n_b = -(-run.last_table.n_ions // backend.batch)
            if fused == "on":
                assert launches["fused_window_moments"] == n_b and \
                    launches["moments"] == 0, launches
            else:
                assert launches["moments"] == n_b and \
                    launches["fused_window_moments"] == 0, launches
            assert launches["chaos"] == n_b, launches
            t_b0 = _slice_table(run.last_table, 0, backend.batch)
            held = _kernels_held(backend, t_b0)
            costs = {} if fused == "on" else _variant_costs(backend, t_b0)
            differ = _ranks_differing(bundle, ref)
            rb = dict(backend.resident_bytes)
            out["launches"][label] = launches
            out["cubes"][label] = {
                "resident_bytes": rb, "resident_total": sum(rb.values()),
                "peak_bytes": peak, "score_s": bundle.timings["score"],
                "wall_s": wall, "variants": variants,
                "batch0_by_variant": costs,
                "fdr_ranks_differing_from_f32": differ, **held}
            line(f"10.5 cube_dtype={dtype} fused_metrics={fused}: resident "
                 f"intensity {rb['intensity']} B (f32 "
                 f"{twin.resident_bytes['intensity']} B) + scales "
                 f"{rb['scales']} B, resident total {sum(rb.values())} B; "
                 f"peak {peak} B; score {bundle.timings['score']:.3f} s; "
                 f"variants {variants}; launches {launches}; bit-equal to "
                 f"the f32 search on the host-expanded cube; annotations "
                 f"whose rank position / fdr differ from phase 3's unrounded "
                 f"f32 search: {differ['position']} / {differ['fdr']} of "
                 f"{differ['of']}; kernels vs plain "
                 f"{json.dumps(held)}")
            if costs:
                line(f"10.5 cube_dtype={dtype}, batch 0 by variant "
                     "(transient device bytes over what is allocated "
                     "before it, device ms): " + ", ".join(
                         f"{v} {c['transient_bytes']} B {c['ms']:.3f} ms"
                         for v, c in costs.items()))
            del run, backend, bundle
            torch.cuda.empty_cache()
        assert out["cubes"]["bf16"]["resident_bytes"]["intensity"] * 2 == \
            twin.resident_bytes["intensity"], "bf16 must halve the intensities"
        _breaker_closed(2, "10.5")
        line(f"10.5 compact cubes: {time.perf_counter() - t0:.1f} s")
    took = time.perf_counter() - t_phase
    out["seconds"] = took
    say(f"phase 10 resilience and compact cubes [{card}]: {took:.1f} s")
    return out


# ------------------------------------------- phase 20 numerics and two OOMs
MIB = 1 << 20
# 20d: the cap lies at least this far from each measured side
OOM_MARGIN = 128 * MIB


def phase_numerics(card: str) -> dict:
    """20a: ``drivers/ulp_sentinel``'s measure on ``cuda:0`` (the
    off-lattice 9x11 fixture through the masked moments and packed chaos
    kernels, and fused over a bf16 cube through the fused kernel, against
    the numpy oracle), then its gate against the committed
    ``NUMERICS_H100_r*.json``: FDR ranks identical, each component within
    its contract, the fused bf16 drift within ``compact_cube``'s, and the
    history band, all hard."""
    import glob

    from sm_distributed_tpu_torch.drivers import ulp_sentinel

    t0 = time.perf_counter()
    history = sorted(glob.glob(str(ROOT / ulp_sentinel.HISTORY_GLOB)))
    assert history, f"no committed {ulp_sentinel.HISTORY_GLOB}"
    torch.cuda.synchronize()
    reset_launches()
    art = ulp_sentinel.measure(device="cuda:0")
    torch.cuda.synchronize()
    launches = read_launches()
    rc = ulp_sentinel.gate(art, history, 0.5, 1, "phase 20a")
    assert rc == 0, f"20a: the ULP sentinel's gate returned {rc}"
    assert art["fdr_ranks_identical"] and art["fdr_ranks_identical_fused"]
    assert art["lattice_rows"] > art["dataset_rows"], art["lattice_rows"]
    for name in ("moments", "chaos", "fused_window_moments"):
        assert launches[name] > 0, f"20a: {name} never launched {launches}"
    took = time.perf_counter() - t0
    say(f"  [{card}] 20a ULP sentinel on cuda:0 ({art['n_ions']} ions, "
        f"lattice rows {art['lattice_rows']} over {art['dataset_rows']}): "
        f"drift by component {json.dumps(art['sm_numerics_max_ulp'])} "
        f"(contracts {json.dumps(art['component_contracts'])}), fused bf16 "
        f"{json.dumps(art['sm_numerics_max_ulp_fused'])} (compact_cube "
        f"{art['cube_contract_ulps']}); FDR ranks identical on both; "
        f"banded against {[Path(h).name for h in history]}; "
        f"{art['declared_contracts']} contracts in "
        f"{art['declared_modules']} modules; card {art['card']}, "
        f"{art['power_limit']}; launches {launches} ({took:.1f} s)")
    return {"launches": launches, "phase_s": took,
            "drift": art["sm_numerics_max_ulp"],
            "drift_fused": art["sm_numerics_max_ulp_fused"]}


def phase_isocalc_pool_start(tmp: Path) -> dict:
    """20b started: ``drivers/isocalc_smoke --device cuda`` as a subprocess
    (the fixture's ions serially and through a 2-worker spawn pool, in
    oracle mode and in device mode on the card)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    path = tmp / "phase20b.log"
    log = open(path, "w")
    return {"t0": time.perf_counter(), "log": log, "path": path,
            "proc": subprocess.Popen(
                [sys.executable, "-m",
                 "sm_distributed_tpu_torch.drivers.isocalc_smoke",
                 "--device", "cuda"],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT))}


def phase_isocalc_pool_join(card: str, run: dict) -> dict:
    """20b joined: the smoke exited 0 with both modes' serial and pool
    tables equal and their shards byte-identical.  A deadline only ends a
    hang."""
    try:
        rc = run["proc"].wait(timeout=SWEEP_DEADLINE_S)
    finally:
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait(timeout=30)
        run["log"].close()
    text = run["path"].read_text()
    assert rc == 0, f"20b: isocalc_smoke exited {rc}\n" + text[-3000:]
    line = next((ln for ln in text.splitlines()
                 if ln.startswith("isocalc_smoke: OK")), "")
    assert "oracle mode" in line and "device mode on cuda" in line, text
    say(f"  [{card}] 20b {line}")
    return {"phase_s": round(time.perf_counter() - run["t0"], 1)}


# phase 22: the port's bench (drivers/bench.py) on its headline case, the
# depth cut with flags it already has: 32x32 pixels, 40 formulas (840 ions,
# one batch of 2048), 1 rep, a 200-ion floor sample in one process, no cold
# isotope patterns and no cold start; its patterns in one process too
BENCH_ARGS = ("--nrows", "32", "--ncols", "32", "--n-formulas", "40",
              "--reps", "1", "--baseline-ions", "200", "--floor-procs", "1",
              "--skip-isocalc-cold", "--skip-cold")
BENCH_ENV = {"SM_ISOCALC_PROCS": "1"}
BENCH_IONS = 40 * (1 + 20)          # formulas x (the target + 20 decoys)
BENCH_STREAMS = 5
BENCH_REPS = 1


def phase_bench_start(tmp: Path) -> dict:
    """22 started: ``python -m sm_distributed_tpu_torch.drivers.bench`` with
    :data:`BENCH_ARGS` as a subprocess on the card, its JSON line to a file
    of its own."""
    import os
    import threading

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env.update(BENCH_ENV)
    work = tmp / "phase22"
    work.mkdir(parents=True)
    out, log = open(work / "out.json", "w"), open(work / "err.log", "w")
    run = {"t0": time.perf_counter(), "out": out, "log": log, "work": work,
           "proc": subprocess.Popen(
               [sys.executable, "-m", "sm_distributed_tpu_torch.drivers.bench",
                *BENCH_ARGS], stdout=out, stderr=log, env=env,
               cwd=str(ROOT))}

    def watch() -> None:
        # the bench's own seconds end at its exit, not at the join
        run["proc"].wait()
        run["t_end"] = time.perf_counter()

    run["watcher"] = threading.Thread(target=watch, daemon=True)
    run["watcher"].start()
    return run


def phase_bench_join(card: str, run: dict) -> dict:
    """22 joined: the bench exited 0 with one JSON line whose keys are the
    port's documented set (``drivers/bench.LINE_KEYS``); it names the card;
    its ions are the preset's; the moments and packed chaos kernels each
    launched once a batch of its five timed streams, the fused kernel not
    at all (``fused_metrics="auto"``); ``0 < roofline_frac <= 1``; its
    profiled stream saw device events and ``0 < measured_roofline_frac <=
    1``; the port's ``perf_sentinel --self-check`` passes with the line as
    its history; ``drivers/trace_report`` renders its trace.  Counts,
    states and bits; a deadline only ends a hang."""
    import contextlib
    import io

    from sm_distributed_tpu_torch.drivers import perf_sentinel, trace_report
    from sm_distributed_tpu_torch.drivers.bench import LINE_KEYS

    try:
        run["watcher"].join(SWEEP_DEADLINE_S)
        rc = run["proc"].wait(timeout=1)
    finally:
        if run["proc"].poll() is None:
            run["proc"].kill()
            run["proc"].wait(timeout=30)
        run["out"].close()
        run["log"].close()
    err = (run["work"] / "err.log").read_text()
    stdout = (run["work"] / "out.json").read_text()
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    assert rc == 0, f"22: the bench exited {rc}\n" + err[-3000:]
    assert len(lines) == 1, f"22: {len(lines)} JSON lines on stdout\n" + \
        stdout[-3000:]
    got = json.loads(lines[0])
    assert set(got) == LINE_KEYS, \
        f"22: keys {sorted(set(got) ^ LINE_KEYS)} off the documented set"
    assert got["device_kind"] == torch.cuda.get_device_name(0), \
        got["device_kind"]
    assert got["n_ions"] == BENCH_IONS, got["n_ions"]
    scored = BENCH_STREAMS * BENCH_REPS * got["n_batches"]
    la = got["kernel_launches"]
    assert la["moments"] == la["chaos"] == scored and \
        la["fused_window_moments"] == 0, \
        f"22: launches {la} over {scored} scored batches"
    assert 0 < got["roofline_frac"] <= 1, got["roofline_frac"]
    assert got["profile_n_events"] > 0, got["profile_n_events"]
    assert got["measured_roofline_frac"] is not None and \
        0 < got["measured_roofline_frac"] <= 1, got["measured_roofline_frac"]
    history = run["work"] / "BENCH_H100_r00.json"
    history.write_text(lines[0] + "\n")
    text = io.StringIO()
    with contextlib.redirect_stdout(text), contextlib.redirect_stderr(text):
        rc_sentinel = perf_sentinel.main(["--self-check", "--history",
                                          str(history), "--min-history", "1"])
        rc_trace = trace_report.main([got["trace_path"]])
    assert rc_sentinel == 0, "22: perf_sentinel --self-check exited " \
        f"{rc_sentinel}\n" + text.getvalue()[-3000:]
    assert rc_trace == 0 and "phase breakdown:" in text.getvalue(), \
        f"22: trace_report exited {rc_trace}\n" + text.getvalue()[-3000:]
    out = {"phase_s": round(run["t_end"] - run["t0"], 1),
           "launches": la,
           **{k: got[k] for k in (
               "value", "jax_spread", "vs_baseline", "n_ions", "n_batches",
               "roofline_frac", "measured_roofline_frac", "kernel_time_frac",
               "profile_n_events", "hbm_peak_bytes", "power_limit_w",
               "phases")}}
    say(f"  22 [{card}] drivers/bench: one JSON line, the documented keys, "
        f"{got['n_ions']} ions in {got['n_batches']} batch(es), launches "
        f"{la}, roofline {got['roofline_frac']}, measured "
        f"{got['measured_roofline_frac']} over {got['profile_n_events']} "
        "device events; the sentinel's self-check passed on it and its "
        "trace rendered")
    return out


class _FusedEntry:
    """Wraps the fused wrapper where the flat fused step calls it
    (``models.msm_torch.fused_window_moments``): ``measure`` keeps the
    device bytes allocated and the peak at the call's entry (just before
    the wrapper's own allocations) and the bytes of the ``principal`` rows
    it allocates; ``observe`` keeps, for each CUDA OOM raised inside it,
    its traceback's frames (file and function names only: the exception
    and its frames are not held) and the launch count before and after."""

    def __init__(self):
        from sm_distributed_tpu_torch.models import msm_torch
        from sm_distributed_tpu_torch.ops import score

        self._mod, self._score = msm_torch, score
        self._orig = msm_torch.fused_window_moments
        self.entries, self.ooms = [], []

    def __enter__(self):
        def wrapped(whp, starts, r_lo_loc, r_hi_loc, n_real, *, gc_width, k):
            n_chunks, wc = r_lo_loc.shape
            self.entries.append({
                "allocated": torch.cuda.memory_allocated(),
                "peak": torch.cuda.max_memory_allocated(),
                "principal_bytes": n_chunks * (wc // k) * whp.shape[1] * 4})
            before = self._score.fused_window_moments.launches
            try:
                return self._orig(whp, starts, r_lo_loc, r_hi_loc, n_real,
                                  gc_width=gc_width, k=k)
            except torch.OutOfMemoryError as exc:
                import traceback

                self.ooms.append({
                    "frames": [f"{Path(f.filename).name}::{f.name}"
                               for f in traceback.extract_tb(
                                   exc.__traceback__)],
                    "launches_before": before,
                    "launches_after":
                        self._score.fused_window_moments.launches})
                raise

        self._mod.fused_window_moments = wrapped
        return self

    def __exit__(self, *exc):
        self._mod.fused_window_moments = self._orig
        return False


def phase_ooms(card: str, ds, truth, search, ds_cfg, main: dict,
               fused_bundle, tmp: Path, sorts: dict) -> dict:
    """20c and 20d, on the main path's dataset with phase 10's shared m/z
    sort.

    20c, an OOM beside a resident backend: two ``SearchJob``s over one
    ``DatasetResidency(max_datasets=2, max_backends=2)``, A on the first
    ``BREAKER_FORMULAS`` formulas, B on phase 3's; the residency's dataset
    slot holds the main path's arrays (phase 3b held the imzML's parse
    equal to them), so no job parses.  With A resident, a fresh backend of
    B's ions scores a batch of 2048 and one of 1024; the memory fraction
    goes to the midpoint of their device peaks (a gap of at least 512
    MiB), and job B must raise a CUDA OOM, back off to at most 1024 and
    store annotations bit-equal to phase 3's, with the breaker closed;
    then (the fraction 1.0 again) A's next job is a backend hit, with no
    new set-up, bit-equal to A's first.

    20d, an OOM inside a kernel wrapper's allocation: phase 6's search
    (``fused_metrics="on"``).  A fresh fused backend measures, at a batch
    of 2048, the bytes allocated and the peak at the fused wrapper's entry
    and the ``principal`` rows it allocates, and the whole batch's peak at
    1024.  The cap lies at least ``OOM_MARGIN`` above both peaks and as
    far below the bytes allocated at the entry plus ``principal``: the
    allocated bytes, not the entry's peak, decide whether the allocation
    fits, and they are at most the peak.  The search must raise a CUDA OOM
    with a frame in ``ops/score.py``'s ``fused_window_moments``, launch
    nothing in the failed call, back off to at most 1024 with one fused
    launch a batch, and give annotations bit-equal to phase 6's, with the
    breaker closed; then each kernel, launched again, is held to its plain
    version.  Where the measured bytes leave no such cap, the figures are
    printed and 20d is recorded as not provoked."""
    import gc as pygc

    from sm_distributed_tpu_torch.engine.residency import DatasetResidency
    from sm_distributed_tpu_torch.engine.search_job import SearchJob
    from sm_distributed_tpu_torch.models import oom
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.utils.config import SMConfig

    from sm_distributed_tpu_torch.models import breaker

    t_phase = time.perf_counter()
    refused = breaker.refused_count()       # step 10.3's: none added here
    total = torch.cuda.get_device_properties(0).total_memory
    table = search.last_table
    b0 = _slice_table(table, 0, 2048)
    out = {"launches": {}}

    def line(msg: str) -> None:
        say(f"  [{card}] {msg}")

    def peaks_of(sm, batches) -> dict:
        """A fresh backend of phase 3's ions: the device peak of batch 0
        at each size (the backend's residents included)."""
        backend = TorchBackend(ds, ds_cfg, sm, restrict_table=table)
        got = {}
        for batch in batches:
            backend.shrink_batch(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            backend.score_batches([_slice_table(b0, 0, batch)])
            torch.cuda.synchronize()
            got[batch] = torch.cuda.max_memory_allocated()
        del backend
        pygc.collect()
        torch.cuda.empty_cache()
        return got

    class _MainResidency(DatasetResidency):
        def dataset(self, key, loader):
            return super().dataset(key, lambda: ds)

    with _SortedLayoutOnce(ds, ds_cfg.image_generation.ppm, sorts):
        # -- 20c: an OOM beside a resident backend ------------------------
        t0 = time.perf_counter()
        imzml = tmp / "main_path.imzML"
        sm = SMConfig.from_dict({
            "device": "cuda", "work_dir": str(tmp / "work"),
            "fdr": {"decoy_sample_size": 20},
            "storage": {"results_dir": str(tmp / "results_20c"),
                        "store_images": False}})
        residency = _MainResidency(max_datasets=2, max_backends=2)

        def job(formulas):
            return SearchJob("oom20c", "phase 20c", imzml, ds_cfg, sm,
                             formulas=formulas, residency=residency)

        few = truth.formulas[:BREAKER_FORMULAS]
        a_first = job(few).run()
        assert residency.stats["backend_misses"] == 1, residency.stats
        peaks = peaks_of(sm, (2048, 1024))
        gap = peaks[2048] - peaks[1024]
        assert gap >= 512 * MIB, (
            f"20c: no memory fraction separates a batch of 2048 "
            f"({peaks[2048]} B at peak) from one of 1024 ({peaks[1024]} B)")
        cap = peaks[1024] + gap // 2
        key = oom.shape_key(ds.n_pixels, "torch_cuda", None)
        oom.reset()
        torch.cuda.set_per_process_memory_fraction(cap / total, 0)
        try:
            torch.cuda.synchronize()
            reset_launches()
            b_bundle = job(truth.formulas).run()
            torch.cuda.synchronize()
            launches_c = read_launches()
            events = oom.snapshot()["events"]
            learned = oom.safe_batch_for(key)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, 0)
            oom.reset()
        assert events >= 1, "20c: no CUDA OOM was raised"
        assert learned is not None and learned <= 1024, learned
        _same_frame(b_bundle.annotations.reset_index(drop=True),
                    main["bundle"].annotations.reset_index(drop=True),
                    "20c job B annotations")
        _breaker_closed(refused, "20c job B")
        n_b = -(-table.n_ions // learned)
        assert launches_c["moments"] >= n_b and \
            launches_c["chaos"] >= n_b, launches_c
        stats = dict(residency.stats)
        a_again = job(few).run()
        after = residency.stats
        assert after["backend_hits"] == stats["backend_hits"] + 1 and \
            after["backend_misses"] == stats["backend_misses"], (stats, after)
        _same_frame(a_again.annotations.reset_index(drop=True),
                    a_first.annotations.reset_index(drop=True),
                    "20c job A again")
        _same_frame(a_again.all_metrics.reset_index(drop=True),
                    a_first.all_metrics.reset_index(drop=True),
                    "20c job A's metrics again")
        _breaker_closed(refused, "20c job A again")
        out["launches"]["20c"] = launches_c
        out["20c"] = {"peak_2048_bytes": peaks[2048],
                      "peak_1024_bytes": peaks[1024], "cap_bytes": cap,
                      "fraction": cap / total, "oom_events": events,
                      "learned_batch": learned, "residency": dict(after),
                      "seconds": time.perf_counter() - t0}
        line(f"20c OOM beside a resident backend: job A "
             f"({len(few)} formulas) resident; B's peaks {peaks[2048]} B at "
             f"2048 and {peaks[1024]} B at 1024 with A resident; cap {cap} B "
             f"(fraction {cap / total:.6f} of {total} B); job B raised "
             f"{events} OOM(s), learned batch {learned}, annotations "
             f"bit-equal to phase 3, breaker closed (launches "
             f"{launches_c}); fraction 1.0 again, A's next job a backend "
             f"hit with no set-up, bit-equal; residency {after} "
             f"({out['20c']['seconds']:.1f} s)")
        del residency, a_first, a_again, b_bundle
        pygc.collect()
        torch.cuda.empty_cache()

        # -- 20d: an OOM inside the fused wrapper's allocation ------------
        t0 = time.perf_counter()
        sm_fused = SMConfig.from_dict({"fdr": {"decoy_sample_size": 20},
                                       "parallel": {"fused_metrics": "on"}})
        with _FusedEntry() as probe:
            peaks = peaks_of(sm_fused, (2048, 1024))
        entry = probe.entries[0]
        lo = max(entry["peak"], peaks[1024]) + OOM_MARGIN
        hi = entry["allocated"] + entry["principal_bytes"] - OOM_MARGIN
        figures = {"allocated_at_entry_2048": entry["allocated"],
                   "peak_at_entry_2048": entry["peak"],
                   "principal_bytes_2048": entry["principal_bytes"],
                   "peak_2048_bytes": peaks[2048],
                   "peak_1024_bytes": peaks[1024],
                   "cap_low_bytes": lo, "cap_high_bytes": hi}
        if lo > hi:
            out["launches"]["20d"] = None
            out["20d"] = {"provoked": False, **figures,
                          "seconds": time.perf_counter() - t0}
            out["phase_s"] = time.perf_counter() - t_phase
            line(f"20d not provoked: at 2048 the fused wrapper's entry has "
                 f"{entry['allocated']} B allocated (peak {entry['peak']} B) "
                 f"and allocates {entry['principal_bytes']} B of principal "
                 f"rows; the whole batch of 1024 peaks at {peaks[1024]} B: "
                 f"no cap {OOM_MARGIN} B from both sides ({figures})")
            return out
        cap = (lo + hi) // 2
        oom.reset()
        run = MSMBasicSearch(ds, truth.formulas, ds_cfg, sm_fused)
        run.isocalc = search.isocalc
        torch.cuda.set_per_process_memory_fraction(cap / total, 0)
        try:
            with _FusedEntry() as seen:
                bundle, wall, launches_d, _peak = _search_run(run)
            events = oom.snapshot()["events"]
            learned = oom.safe_batch_for(key)
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, 0)
            oom.reset()
        in_wrapper = [o for o in seen.ooms
                      if "score.py::fused_window_moments" in o["frames"]]
        assert events >= 1 and in_wrapper, (
            f"20d: no OOM inside fused_window_moments ({seen.ooms}, "
            f"{events} events)")
        assert all(o["launches_after"] == o["launches_before"]
                   for o in in_wrapper), in_wrapper
        assert learned is not None and learned <= 1024, learned
        n_b = -(-table.n_ions // learned)
        assert launches_d["fused_window_moments"] == n_b and \
            launches_d["chaos"] == n_b and launches_d["moments"] == 0, (
                launches_d, n_b)
        _bit_equal(bundle, fused_bundle, "20d fused search after the OOM")
        _breaker_closed(refused, "20d")
        # the fused kernel on the search's backend, the moments and packed
        # chaos kernels on phase 3's
        t_b0 = _slice_table(table, 0, learned)
        held = {**_kernels_held(run.last_backend, t_b0),
                **_kernels_held(search.last_backend, t_b0)}
        del run, bundle
        pygc.collect()
        torch.cuda.empty_cache()
    out["launches"]["20d"] = launches_d
    out["20d"] = {"provoked": True, **figures, "cap_bytes": cap,
                  "fraction": cap / total, "oom_events": events,
                  "ooms_in_wrapper": len(in_wrapper),
                  "oom_frames": in_wrapper[0]["frames"],
                  "learned_batch": learned, "wall_s": wall, **held,
                  "seconds": time.perf_counter() - t0}
    line(f"20d OOM inside the fused wrapper's allocation: at 2048 its entry "
         f"has {entry['allocated']} B allocated (peak {entry['peak']} B) and "
         f"allocates {entry['principal_bytes']} B of principal rows; the "
         f"batch of 1024 peaks at {peaks[1024]} B; cap {cap} B (fraction "
         f"{cap / total:.6f}); the search raised {events} OOM(s), "
         f"{len(in_wrapper)} in fused_window_moments (frames "
         f"{in_wrapper[0]['frames'][-3:]}), the failed call launched "
         f"nothing, learned batch {learned}, launches {launches_d}, "
         f"annotations bit-equal to phase 6, breaker closed; every kernel "
         f"again vs plain {json.dumps(held)} "
         f"({out['20d']['seconds']:.1f} s)")
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# --------------------------------------------------------- phase 11 service
SERVICE_SM = {"device": "cuda", "fdr": {"decoy_sample_size": 20},
              "parallel": {"resident_datasets": 2},
              "service": {"workers": 2, "http_port": 0,
                          "health_probe_on_lease": True,
                          "poll_interval_s": 0.05, "backoff_base_s": 0.2,
                          "backoff_jitter": 0.0, "heartbeat_interval_s": 1.0},
              "telemetry": {"sample_interval_s": 0.5}}


# phase 14: the main path on ("pixels", "formulas") meshes (port slice 14):
# 14a's full width on 2x2, 14b's first batch alone on 4x1 and 1x4 and each
# forced variant on 2x2, 14c's resume on 2x1
SHARD_FULL = (2, 2)
SHARD_FIRST_BATCH = ((4, 1), (1, 4))
SHARD_VARIANTS = {"band": {"band_slice": "on"},
                  "compact": {"band_slice": "off", "peak_compaction": "on"}}
SHARD_RESUME = (2, 1)


class _ShardLayoutOnce:
    """Phase 14's backends after 14a's share the main dataset's sharded
    layouts (``prepare_flat_sharded_arrays``, a deterministic function of
    the dataset, ppm, shard count and capacities: the per-shard m/z sort),
    as phase 10 shares its sort.  14a's search runs the port's own set-up,
    and so does the first backend of each layout after it; the set-up
    seconds of the later ones leave the sort out."""

    def __init__(self):
        from sm_distributed_tpu_torch.parallel import sharded

        self._mod, self._orig = sharded, sharded.prepare_flat_sharded_arrays
        self._memo = {}

    def __enter__(self):
        def once(ds, ppm, n_shards=1, pad_to_multiple=1024, p_loc=None,
                 slot_bucket=None):
            key = (id(ds), ppm, n_shards, pad_to_multiple, p_loc,
                   slot_bucket)
            if key not in self._memo:
                self._memo[key] = self._orig(ds, ppm, n_shards,
                                             pad_to_multiple, p_loc,
                                             slot_bucket)
            return self._memo[key]

        self._mod.prepare_flat_sharded_arrays = once
        return self

    def __exit__(self, *exc):
        self._mod.prepare_flat_sharded_arrays = self._orig
        self._memo.clear()
        return False


def _stage_ms(backend, tables) -> list:
    """Each batch's CUDA-event ms by stage of the sharded step (extraction,
    shuffle copies, metrics, gather), one batch at a time on cuda:0's
    stream (``ShardedTorchBackend.timer``)."""
    out = []
    for t in tables:
        marks = []

        def timer(stage, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((stage, ev))

        backend.timer = timer
        try:
            backend.score_batch(t)
        finally:
            backend.timer = None
        torch.cuda.synchronize()
        out.append({marks[i][0]: round(marks[i - 1][1].elapsed_time(
            marks[i][1]), 3) for i in range(1, len(marks))})
    return out


def phase_sharded(card: str, ds, truth, search, ds_cfg, main: dict) -> dict:
    """Phase 14: the main path's dataset and ions (phase 3's search object
    and warm isotope patterns) through ``MSMBasicSearch`` on meshes of
    ``cuda:0`` repeated, built by ``make_torch_backend`` from an explicit
    device list; a mesh over distinct cards (14d) only where more than one
    is visible.  Every result held bit-equal to phase 3's.  Returns the
    launch counts of 14a's search and the figures the summary prints."""
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.parallel.sharded import (
        ShardedTorchBackend,
        make_torch_backend,
    )
    from sm_distributed_tpu_torch.utils import failpoints
    from sm_distributed_tpu_torch.utils.config import SMConfig

    t_phase = time.perf_counter()
    ref = main["bundle"]
    table = search.last_table
    dev0 = torch.device("cuda", 0)
    out = {"meshes": {}}

    def sm(mesh, **par):
        return SMConfig.from_dict({
            "fdr": {"decoy_sample_size": 20},
            "parallel": {"pixels_axis": mesh[0], "formulas_axis": mesh[1],
                         **par}})

    def make(mesh, devices, checkpoint_dir=None, **par):
        s = MSMBasicSearch(ds, truth.formulas, ds_cfg, sm(mesh, **par),
                           checkpoint_dir=checkpoint_dir, devices=devices)
        s.isocalc = search.isocalc     # the main path's warm patterns
        return s

    def line(msg: str) -> None:
        say(f"  [{card}] {msg}")

    def label(mesh) -> str:
        return f"{mesh[0]}x{mesh[1]}"

    # -- 14a: full width on 2x2 -------------------------------------------
    s14a = make(SHARD_FULL, [dev0] * 4)
    bundle, wall, launches, peak = _search_run(s14a)
    backend = s14a.last_backend
    assert isinstance(backend, ShardedTorchBackend), type(backend)
    assert backend.mesh.shape == {"pixels": 2, "formulas": 2}
    _bit_equal(bundle, ref, "14a 2x2 search")
    variants = dict(backend.variant_counts)
    n_batches = -(-table.n_ions // backend.batch)
    cells = backend.mesh.size
    assert launches["moments"] == cells * n_batches == 12 and \
        launches["chaos"] == cells * n_batches, (
            f"14a: moments and packed chaos must launch once a cell and "
            f"batch ({cells} x {n_batches}): {launches}")
    assert launches["chaos_tiles"] == launches["chaos_strips"] == \
        launches["fused_window_moments"] == 0, launches
    t0 = _slice_table(table, 0, backend.batch)
    t_img = time.perf_counter()
    assert np.array_equal(backend.extract_ion_images(t0),
                          search.last_backend.extract_ion_images(t0)), \
        "14a: the mesh's ion images differ from phase 3's backend's"
    img_s = time.perf_counter() - t_img
    tim = bundle.timings
    batches = [_slice_table(table, s, min(s + backend.batch, table.n_ions))
               for s in range(0, table.n_ions, backend.batch)]
    stages = _stage_ms(backend, batches)
    shuffle_share = [round(b["shuffle"] / sum(b.values()), 4)
                     for b in stages]
    # the score phase of phase 3's backend (warm, one device) and of the
    # mesh on the same batches, in turns (single, mesh, mesh, single)

    def score_s(b) -> float:
        torch.cuda.synchronize()
        ts = time.perf_counter()
        b.score_batches(batches)
        torch.cuda.synchronize()
        return time.perf_counter() - ts

    turns = {"single": [], "mesh": []}
    for who in ("single", "mesh", "mesh", "single"):
        turns[who].append(score_s(search.last_backend if who == "single"
                                  else backend))
    out["launches"] = launches
    out["metrics"] = bundle.all_metrics
    out["meshes"][label(SHARD_FULL)] = {
        "setup_s": tim["backend_setup"], "score_s": tim["score"],
        "ions_per_s": table.n_ions / tim["score"], "wall_s": wall,
        "peak_bytes": peak, "variant_counts": variants,
        "batch_stage_ms": stages, "shuffle_share": shuffle_share,
        "score_turns_s": turns}
    line(f"14a 2x2 mesh of cuda:0: {table.n_ions} ions in {n_batches} "
         f"batches of {backend.batch}, bit-equal to phase 3 (metrics rows, "
         f"annotations, FDR ranks); set-up {tim['backend_setup']:.3f} s "
         f"(the per-shard sort included), score {tim['score']:.3f} s, "
         f"{table.n_ions / tim['score']:.1f} ions/s; peak device memory "
         f"{peak / 2**30:.2f} GiB (phase 3: "
         f"{main['peak_bytes'] / 2**30:.2f}); launches {launches}; variants "
         f"{variants}; batch 0's ion images bit-equal to phase "
         f"3's backend's ({img_s:.1f} s); per batch, ms by stage "
         f"{json.dumps(stages)}, the shuffle's share {shuffle_share}; the "
         f"3 batches scored warm in turns, phase 3's backend "
         f"{turns['single']} s, the 2x2 mesh {turns['mesh']} s")
    del backend, s14a
    torch.cuda.empty_cache()

    with _ShardLayoutOnce():
        # -- 14b: the first batch alone on 4x1 and 1x4, and each variant
        rows0 = _search_rows(ref)[:t0.n_ions]

        def first_batch(mesh, what, **par):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ts = time.perf_counter()
            b = make_torch_backend(ds, ds_cfg, sm(mesh, **par),
                                   restrict_table=table, devices=[dev0] * 4)
            setup = time.perf_counter() - ts
            assert isinstance(b, ShardedTorchBackend), type(b)
            score = []
            for _ in range(2):            # the first call and a warm one
                torch.cuda.synchronize()
                ts = time.perf_counter()
                got = b.score_batch(t0)
                score.append(time.perf_counter() - ts)
                assert np.array_equal(got.astype(np.float32), rows0), \
                    f"14b {what}: batch 0 differs from phase 3's rows"
            rec = {"setup_s": setup, "score_s": score,
                   "ions_per_s": t0.n_ions / score[1],
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "variant_counts": dict(b.variant_counts)}
            line(f"14b {what}: batch 0 ({t0.n_ions} ions) bit-equal to "
                 f"phase 3, twice; set-up {setup:.3f} s, score "
                 f"{score[0]:.3f} s, then {score[1]:.3f} s warm, peak "
                 f"{rec['peak_bytes'] / 2**30:.2f} GiB, variants "
                 f"{b.variant_counts}")
            del b
            torch.cuda.empty_cache()
            return rec

        for mesh in SHARD_FIRST_BATCH:
            out["meshes"][label(mesh)] = first_batch(mesh, label(mesh))
        for variant, par in SHARD_VARIANTS.items():
            rec = first_batch(SHARD_FULL, f"2x2 {variant}", **par)
            assert rec["variant_counts"][variant] == 2, rec
            out["meshes"][f"2x2 {variant}"] = rec

        # -- 14c: a 2x2 search killed after its first group, resumed on 2x1
        with tempfile.TemporaryDirectory() as td:
            failpoints.configure("device.score_batch=raise:RuntimeError@2")
            try:
                make(SHARD_FULL, [dev0] * 4, checkpoint_dir=td,
                     checkpoint_every=1).search()
                raise AssertionError("the killed 2x2 search did not die")
            except RuntimeError as exc:
                assert "device.score_batch" in str(exc), exc
            finally:
                failpoints.configure(None)
            shards = sorted(Path(td).glob("msm_search.p0.g*.ckpt.npz"))
            assert len(shards) == 1, shards
            resumed = make(SHARD_RESUME, [dev0] * 2, checkpoint_dir=td,
                           checkpoint_every=1)
            r_bundle, r_wall, r_launches, r_peak = _search_run(resumed)
            assert resumed.last_backend.mesh.shape == {"pixels": 2,
                                                       "formulas": 1}
            assert r_launches["moments"] == r_launches["chaos"] == 2 * 2, (
                f"14c: 2 groups of 1 batch on 2 cells: {r_launches}")
            _bit_equal(r_bundle, bundle, "14c resumed on 2x1")
            resumed.last_checkpoint.finalize()
        out["meshes"]["2x1 resumed"] = {
            "setup_s": r_bundle.timings["backend_setup"],
            "score_s": r_bundle.timings["score"], "wall_s": r_wall,
            "peak_bytes": r_peak, "launches": r_launches}
        line(f"14c checkpointed 2x2 search killed before group 1 of 3 "
             f"(device.score_batch), 1 durable shard; resumed on a 2x1 mesh: "
             f"2 groups scored (launches {r_launches}), bit-equal to 14a; "
             f"set-up {r_bundle.timings['backend_setup']:.3f} s, score "
             f"{r_bundle.timings['score']:.3f} s, wall {r_wall:.3f} s")
        del resumed
        torch.cuda.empty_cache()

    # -- 14d: distinct cards, where there are any: 2x1 over two, and 2x2
    # over four where four are visible
    n_cards = torch.cuda.device_count()
    distinct = [mesh for mesh in (SHARD_RESUME, SHARD_FULL)
                if mesh[0] * mesh[1] <= n_cards]
    for mesh in distinct if n_cards > 1 else ():
        cards = [torch.device("cuda", i) for i in range(mesh[0] * mesh[1])]
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        s14d = make(mesh, cards)
        d_bundle, d_wall, d_launches, _peak = _search_run(s14d)
        b14d = s14d.last_backend
        assert set(b14d.mesh.distinct()) == set(cards), b14d.mesh.devices
        _bit_equal(d_bundle, bundle, f"14d {label(mesh)} over {cards}")
        d_turns = {"single": [], "mesh": []}
        for who in ("single", "mesh", "mesh", "single"):
            d_turns[who].append(score_s(search.last_backend
                                        if who == "single" else b14d))
        peaks = [torch.cuda.max_memory_allocated(c) for c in cards]
        out["meshes"][f"{label(mesh)} distinct"] = {
            "setup_s": d_bundle.timings["backend_setup"],
            "score_s": d_bundle.timings["score"], "wall_s": d_wall,
            "launches": d_launches, "peak_bytes_by_card": peaks,
            "score_turns_s": d_turns}
        line(f"14d {label(mesh)} mesh over cuda:0..{len(cards) - 1}: "
             f"bit-equal to 14a; set-up "
             f"{d_bundle.timings['backend_setup']:.3f} s, score "
             f"{d_bundle.timings['score']:.3f} s; launches {d_launches}; "
             f"peaks by card {[round(x / 2**30, 2) for x in peaks]} GiB; "
             f"the 3 batches warm in turns, phase 3's backend "
             f"{d_turns['single']} s, this mesh {d_turns['mesh']} s")
        del s14d, b14d
        torch.cuda.empty_cache()
    if n_cards > 1:
        line("14d " + _second_device_check())
    else:
        line(f"14d distinct cards: not run, the card count is {n_cards}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"phase 14 sharded main path [{card}]: {out['phase_s']:.1f} s; "
        "2x2, 4x1, 1x4, each variant and a resume on 2x1 bit-equal to "
        f"phase 3; moments and packed chaos launched {launches['moments']} "
        f"and {launches['chaos']} times over 14a's {cells} cells and "
        f"{n_batches} batches")
    return out


def _http(base: str, path: str, method: str = "GET", body=None):
    """One admin-API request; returns (status, body as JSON or text)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    try:
        return status, json.loads(raw)
    except ValueError:
        return status, raw.decode()


def _wait_jobs(base: str, ids, timeout_s: float) -> dict:
    """Poll ``/jobs`` until every id is terminal; returns their records."""
    terminal = ("done", "failed", "cancelled", "quarantined")
    deadline = time.time() + timeout_s
    while True:
        rows = {j["msg_id"]: j for j in _http(base, "/jobs")[1]}
        if all(rows.get(i, {}).get("state") in terminal for i in ids):
            return {i: rows[i] for i in ids}
        assert time.time() < deadline, (
            f"jobs not terminal after {timeout_s} s: "
            f"{ {i: rows.get(i, {}).get('state') for i in ids} }")
        time.sleep(0.2)


def _second_device_check() -> str:
    """Each kernel once on ``cuda:1`` from a worker thread (whose current
    device is 0), held bit-equal to the same inputs on ``cuda:0``."""
    import threading

    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_strips,
    )
    from sm_distributed_tpu_torch.ops.moments import batch_moments
    from sm_distributed_tpu_torch.ops.score import fused_window_moments

    n = torch.cuda.device_count()
    if n < 2:
        return (f"kernels on a second device: not run, there is {n} CUDA "
                "device")
    gen = torch.Generator().manual_seed(11)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float32)

    r_lo = torch.randint(-1, 6, (2, 8), generator=gen, dtype=torch.int32)
    r_hi = r_lo + torch.randint(0, 3, (2, 8), generator=gen,
                                dtype=torch.int32)
    cases = {
        "moments": (lambda x: batch_moments(x, 4000), (rand(64, 4, 4096),)),
        "chaos": (lambda x: chaos_count_sums(x, 256, 256, 30),
                  (rand(32, 256 * 256),)),
        "chaos_tiles": (lambda x: chaos_count_sums(x, 512, 512, 30),
                        (rand(8, 512 * 512),)),
        "chaos_strips": (lambda x: chaos_count_sums_strips(x, 1024, 1024,
                                                           30),
                         (rand(4, 1024 * 1024),)),
        "fused_window_moments": (
            lambda w, lo, hi: fused_window_moments(
                w, np.array([0, 10], np.int32), lo, hi, 4000, gc_width=16,
                k=4),
            (torch.floor(rand(40, 4096) * 9), r_lo, r_hi)),
    }
    for name, (fn, args) in cases.items():
        want = fn(*(a.to("cuda:0") for a in args))
        out: list = []

        def worker(fn=fn, args=args, out=out):
            try:
                out.append(fn(*(a.to("cuda:1") for a in args)))
            except BaseException as exc:  # noqa: BLE001 — raised below
                out.append(exc)

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=600)
        assert not t.is_alive() and out, f"{name}: worker on cuda:1 hung"
        if isinstance(out[0], BaseException):
            raise out[0]
        got = out[0] if isinstance(out[0], tuple) else (out[0],)
        ref = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, ref):
            assert a.device.index == 1, (name, a.device)
            assert torch.equal(a.cpu(), b.cpu()), \
                f"{name}: cuda:1 from a worker thread differs from cuda:0"
    return (f"kernels on a second device: {sorted(cases)} on cuda:1 from a "
            "worker thread bit-equal to cuda:0")


def _serve_subprocess(tmp: Path) -> dict:
    """Phase 11b: ``serve`` as a subprocess, one good and one bad job, the
    ephemeral port read from its log line, ``GET /healthz`` 200, SIGTERM ->
    exit 0 with ``running/`` empty and the dead letter's traceback."""
    import os
    import signal
    import threading

    from sm_distributed_tpu_torch.engine.daemon import QueuePublisher
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset

    path, truth = generate_synthetic_dataset(
        tmp / "small", nrows=32, ncols=32, present_fraction=0.6,
        noise_peaks=50, seed=3)
    sm_json = tmp / "serve.json"
    sm_json.write_text(json.dumps({
        **SERVICE_SM, "work_dir": str(tmp / "serve_work"),
        "storage": {"results_dir": str(tmp / "serve_results")}}))
    pub = QueuePublisher(tmp / "serve_q")
    pub.publish({"ds_id": "small", "msg_id": "good",
                 "input_path": str(path), "formulas": truth.formulas[:10]})
    pub.publish({"ds_id": "gone", "msg_id": "bad",
                 "input_path": str(tmp / "missing.imzML"),
                 "formulas": truth.formulas[:1],
                 "service": {"max_attempts": 2}})
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sm_distributed_tpu_torch.engine.cli",
         "serve", str(tmp / "serve_q"), "--sm-config", str(sm_json)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env)
    lines: list[str] = []
    found = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "admin API on http://" in line:
                found.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        assert found.wait(180), "serve: no admin API line\n" + \
            "".join(lines[-40:])
        base = re.search(r"admin API on (http://[\d.]+:\d+)",
                         "".join(lines)).group(1)
        status, health = _http(base, "/healthz")
        t_health = time.perf_counter() - t0
        assert status == 200 and health["status"] == "ok", health
        rows = _wait_jobs(base, ("good", "bad"), 300)
        assert rows["good"]["state"] == "done", rows
        assert rows["bad"]["state"] == "failed", rows
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
    assert rc == 0, f"serve exited {rc} on SIGTERM\n" + "".join(lines[-40:])
    root = tmp / "serve_q" / "sm_annotate"
    assert not list(root.glob("running/*")), "serve left running/ claims"
    dead = json.loads((root / "failed" / "bad.json").read_text())
    assert dead["attempts"] == 2 and "Traceback" in dead["traceback"], dead
    return {"to_healthz_s": t_health,
            "wall_s": time.perf_counter() - t0, "exit": rc}


def phase_service(card: str, tmp: Path, truth, main: dict) -> dict:
    """Phase 11: the annotation service on the card.  11a: the port's
    ``AnnotationService`` in process (2 workers, 2 resident datasets, an
    ephemeral port, the lease-time probe on), the launch counts reset just
    before it starts: job A on the main path's dataset (phase 3b's imzML)
    and ions, then job B, the same, a residency hit with no parse and no
    backend set-up, both stored bit-equal to phase 3; job C with a missing
    input dead-lettered after 2 attempts with its traceback; job D deleted
    while it waits or runs, cancelled.  11b: ``serve`` as a subprocess."""
    import pandas as pd

    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.engine.residency import DatasetResidency
    from sm_distributed_tpu_torch.service import AnnotationService
    from sm_distributed_tpu_torch.utils import tracing
    from sm_distributed_tpu_torch.utils.config import SMConfig

    t_phase = time.perf_counter()
    say("  11.0 " + _second_device_check())
    imzml = tmp / "main_path.imzML"
    ref = main["bundle"]
    sm = SMConfig.from_dict({
        **SERVICE_SM,
        # phase 3b's work dir: its isotope-pattern cache is warm
        "work_dir": str(tmp / "work"),
        "storage": {"results_dir": str(tmp / "service_results")}})
    residency = DatasetResidency(max_datasets=2, max_backends=2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    service = AnnotationService(
        tmp / "service_q", annotate_callback(sm, residency=residency),
        sm_config=sm, residency=residency)
    service.start()
    per_job = {}
    try:
        base = "http://%s:%d" % service.api.address
        status, _ = _http(base, "/healthz")
        to_health = time.perf_counter() - t0
        assert status == 200
        res = tmp / "service_results" / "svc_main"
        job = {"ds_id": "svc_main", "input_path": str(imzml),
               "formulas": list(truth.formulas)}
        ids = {}
        _, ids["A"] = _http(base, "/submit", "POST", job)
        _, ids["C"] = _http(base, "/submit", "POST", {
            "ds_id": "svc_missing", "input_path": str(tmp / "none.imzML"),
            "formulas": list(truth.formulas[:1]),
            "service": {"max_attempts": 2}})
        _, ids["D"] = _http(base, "/submit", "POST",
                            {**job, "ds_id": "svc_deleted"})
        status, out = _http(base, f"/jobs/{ids['D']['msg_id']}", "DELETE")
        assert status in (200, 202), (status, out)
        # a DELETE that finds D still in pending/ cancels it there and
        # counts a user cancel; one that races the dispatcher's claim
        # flags it, and the worker cancels it before its attempt, uncounted
        # (as in the JAX package)
        d_from_pending = out.get("state") == "cancelled"
        ids = {k: v["msg_id"] for k, v in ids.items()}
        rows = _wait_jobs(base, list(ids.values()), 900)
        launches_a = read_launches()
        # job A's trace file, for phase 17d's report
        trace_a = tracing.trace_path(service.trace_dir,
                                     rows[ids["A"]]["trace_id"])
        stored_a = {name: pd.read_parquet(res / f"{name}.parquet")
                    for name in ("annotations", "all_metrics")}
        timings_a = json.loads((res / "timings.json").read_text())
        _, out = _http(base, "/submit", "POST", job)
        ids["B"] = out["msg_id"]
        rows.update(_wait_jobs(base, [ids["B"]], 900))
        launches = read_launches()
        launches_b = {k: launches[k] - launches_a[k] for k in launches}
        timings_b = json.loads((res / "timings.json").read_text())
        for label, stored in (("A", stored_a), ("B", {
                name: pd.read_parquet(res / f"{name}.parquet")
                for name in ("annotations", "all_metrics")})):
            _same_frame(stored["annotations"],
                        ref.annotations.reset_index(drop=True),
                        f"job {label} annotations")
            _same_frame(stored["all_metrics"],
                        ref.all_metrics.reset_index(drop=True),
                        f"job {label} all_metrics")
        states = {k: rows[v]["state"] for k, v in ids.items()}
        assert states == {"A": "done", "B": "done", "C": "failed",
                          "D": "cancelled"}, states
        dead = json.loads((tmp / "service_q" / "sm_annotate" / "failed" /
                           f"{ids['C']}.json").read_text())
        assert dead["attempts"] == 2 and "Traceback" in dead["traceback"]
        assert residency.stats == {"dataset_hits": 1, "dataset_misses": 1,
                                   "backend_hits": 1, "backend_misses": 1}, \
            residency.stats
        n_batches = -(-main["n_ions"] // 2048)
        for label, ln in (("A", launches_a), ("B", launches_b)):
            assert ln["moments"] == n_batches and \
                ln["chaos"] == n_batches, (label, ln)
            assert ln["chaos_tiles"] == ln["chaos_strips"] == \
                ln["fused_window_moments"] == 0, (label, ln)
        # the probe: a copy round-trip on a real device
        _, devices = _http(base, "/debug/devices")
        assert devices["size"] == torch.cuda.device_count(), devices
        _, events = _http(base, "/debug/events?n=5000")
        probes = [e for e in events if e.get("name") == "device_probe"]
        assert probes and all(e["attrs"]["how"] == "device" and
                              e["attrs"]["ok"] for e in probes), probes
        assert devices["breakers"]["*"]["state"] == "closed", devices
        _, text = _http(base, "/metrics")
        for line in ('sm_jobs_total{state="done"} 2',
                     'sm_jobs_total{state="failed"} 1',
                     'sm_jobs_total{state="cancelled"} 1',
                     'sm_phase_seconds_count{phase="score"} 2',
                     'sm_breaker_state{device="*"} 0') + ((
                         'sm_jobs_cancelled_total{reason="user"} 1',)
                         if d_from_pending else ()):
            assert line in text, f"/metrics lacks {line!r}"
        hbm = [float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("sm_device_hbm_bytes_in_use{")]
        assert hbm and max(hbm) > 0, "no device memory gauge above 0"
        _, slo = _http(base, "/slo")
        for label, msg_id in ids.items():
            row = rows[msg_id]
            _, trace = _http(base, f"/jobs/{msg_id}/trace?raw=1")
            recs = trace.get("records", []) if isinstance(trace, dict) \
                else []
            submit = [r["ts"] for r in recs if r.get("name") == "submit"]
            first = [r["ts"] for r in recs
                     if r.get("name") == "first_annotation"]
            # the store's span: the stored timings are written inside it
            store = [r["dur"] for r in recs if r.get("kind") == "span"
                     and r.get("name") == "store_results"]
            per_job[label] = {
                "state": row["state"], "attempts": row["attempts"],
                "queue_wait_s": (row["started_at"] - row["published_at"]
                                 if row["started_at"] else None),
                "wall_s": (row["finished_at"] - row["started_at"]
                           if row["started_at"] else None),
                "to_first_annotation_s": (min(first) - min(submit)
                                          if first and submit else None),
                "store_results": store[-1] if store else None}
        for label, tim in (("A", timings_a), ("B", timings_b)):
            per_job[label].update({k: tim[k] for k in JOB_PHASES
                                   if k in tim})
    finally:
        assert service.shutdown(), "service did not drain"
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(0)
    _breaker_closed(2, "phase 11a")
    for label in "ABCD":
        say(f"  [{card}] 11a job {label}: " + json.dumps(per_job[label]))
    say(f"  [{card}] 11a A against B: parse (read_dataset) "
        f"{per_job['A']['read_dataset']:.3f} -> "
        f"{per_job['B']['read_dataset']:.3f} s, backend set-up "
        f"{per_job['A']['backend_setup']:.3f} -> "
        f"{per_job['B']['backend_setup']:.3f} s; residency "
        f"{residency.stats}; launches A {launches_a}, B {launches_b}; "
        f"start to /healthz {to_health:.3f} s; device peak {peak} B; "
        f"/slo first_annotation {slo['slos']['first_annotation']}")
    sub = _serve_subprocess(tmp)
    say(f"  [{card}] 11b serve subprocess: /healthz 200 after "
        f"{sub['to_healthz_s']:.3f} s, a good and a bad job terminal, "
        f"SIGTERM -> exit 0, running/ empty, dead letter with its traceback "
        f"({sub['wall_s']:.1f} s)")
    took = time.perf_counter() - t_phase
    say(f"phase 11 service: {took:.1f} s; A and B stored bit-equal to "
        "phase 3, B a residency hit, C dead-lettered, D cancelled, probe a "
        "device round-trip, serve exits 0 on SIGTERM")
    return {"jobs": per_job, "launches": {"A": launches_a, "B": launches_b},
            "to_healthz_s": to_health, "peak_bytes": peak,
            "residency": residency.stats, "serve": sub, "phase_s": took,
            "trace_a": str(trace_a)}


# ------------------------------------------- phase 12 read path and stream
# image rows of the three chunks the main dataset streams in: the prefixes
# have 72, 176 and 256 rows, the first two off the lattice's quarter ladder
STREAM_ROWS = (72, 104, 80)
WARM_READS = 20


class _StreamSearches:
    """Wraps ``MSMBasicSearch.search`` while phase 12 runs: every search the
    service's jobs make is recorded (its kind, dataset, bundle, the launch
    counts it made and the device memory allocated after it), under the
    label the script sets.  Direct searches the script makes to compare
    call ``direct`` and are not recorded."""

    def __init__(self):
        from sm_distributed_tpu_torch.models import msm_basic

        self.cls = msm_basic.MSMBasicSearch
        self.orig = self.cls.search
        self.label = ""
        self.records: list[dict] = []
        rec = self

        def search(search_self, *a, **kw):
            before = read_launches()
            bundle = rec.orig(search_self, *a, **kw)
            after = read_launches()
            torch.cuda.synchronize()
            rec.records.append({
                "label": rec.label,
                "provisional": search_self.checkpoint_dir is None,
                "ds": search_self.ds, "bundle": bundle,
                "launches": {k: after[k] - before[k] for k in after},
                "allocated": torch.cuda.memory_allocated(0)})
            return bundle

        self.cls.search = search

    def direct(self, search):
        return self.orig(search)

    def close(self):
        self.cls.search = self.orig


def _stream_spectra(ds, rows: tuple[int, int]):
    """(coords, spectra) of the main dataset's pixels in image rows
    [rows[0], rows[1]), coords as (column, row)."""
    pix = ds.pixel_inds
    sel = np.nonzero((pix // ds.ncols >= rows[0])
                     & (pix // ds.ncols < rows[1]))[0]
    coords = np.stack([pix[sel] % ds.ncols, pix[sel] // ds.ncols], axis=1)
    spectra = []
    for i in sel:
        lo, hi = ds.row_ptr[pix[i]], ds.row_ptr[pix[i] + 1]
        spectra.append((ds.mzs_flat[lo:hi], ds.ints_flat[lo:hi]))
    return coords, spectra


def _wait_partial(base: str, msg_id: str, chunks: int, timeout_s: float):
    """Poll ``/jobs/<id>`` until its provisional re-rank covers ``chunks``
    chunks; returns the partial payload."""
    deadline = time.time() + timeout_s
    while True:
        _, rec = _http(base, f"/jobs/{msg_id}")
        part = rec.get("partial") or {}
        if (part.get("stream") or {}).get("chunks", 0) >= chunks:
            return part
        assert rec.get("state") not in ("done", "failed", "cancelled"), rec
        assert time.time() < deadline, f"no re-rank over {chunks} chunks"
        time.sleep(0.1)


def _read_path_checks(base: str, res: Path, ds_id: str) -> dict:
    """12a: the read routes over a stored job, held to a pandas scan of its
    parquet and a direct render of its stored images."""
    import urllib.parse
    import urllib.request

    import pandas as pd

    from sm_distributed_tpu_torch.engine.png import PngGenerator
    from sm_distributed_tpu_torch.engine.storage import SearchResultsStore

    status, listing = _http(base, "/datasets")
    assert status == 200 and ds_id in [d["ds_id"]
                                       for d in listing["datasets"]], listing
    stored = pd.read_parquet(res / ds_id / "annotations.parquet")
    scan = stored.sort_values(["msm", "sf", "adduct"], ascending=False)
    want = [(r.sf, r.adduct, float(r.msm)) for r in scan.itertuples()]

    def hits():
        _, text = _http(base, "/metrics")
        line = [ln for ln in text.splitlines() if ln.startswith(
            'sm_read_cache_hits_total{kind="annotations"}')]
        return float(line[0].rsplit(" ", 1)[1]) if line else 0.0

    path = f"/datasets/{ds_id}/annotations"
    t0 = time.perf_counter()
    status, cold = _http(base, path)
    cold_s = time.perf_counter() - t0
    h0 = hits()
    status_w, warm = _http(base, path)
    assert status == status_w == 200 and warm == cold
    assert hits() == h0 + 1, "warm read was not a cache hit"
    first = [(r["sf"], r["adduct"], r["msm"]) for r in cold["rows"]]
    assert first == want[:len(first)] and cold["total"] == len(want)
    rows, cursor, pages = [], None, 0
    while True:
        q = "?limit=100" + (f"&cursor={cursor}" if cursor else "")
        status, page = _http(base, path + q)
        assert status == 200, page
        rows += [(r["sf"], r["adduct"], r["msm"]) for r in page["rows"]]
        pages += 1
        cursor = page["next_cursor"]
        if cursor is None:
            break
    assert rows == want, "paged rows differ from the parquet scan"
    images, ions = SearchResultsStore.load_ion_images(
        res / ds_id / "ion_images.npz")
    top = want[0][:2]
    i = [tuple(ion) for ion in ions].index(top)
    ion = urllib.parse.quote(f"{top[0]}|{top[1]}")
    with urllib.request.urlopen(f"{base}/datasets/{ds_id}/images/{ion}",
                                timeout=30) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "image/png"
        tile = r.read()
    assert tile == PngGenerator().render(images[i, 0]), "tile bytes differ"
    status, cohort = _http(base, "/annotations?sf=" +
                           urllib.parse.quote(top[0]))
    assert status == 200 and cohort["n_datasets"] >= 1 and any(
        d["ds_id"] == ds_id for d in cohort["datasets"]), cohort
    warm_s = []
    for _ in range(WARM_READS):
        t0 = time.perf_counter()
        assert _http(base, path)[0] == 200
        warm_s.append(time.perf_counter() - t0)
    _, slo = _http(base, "/slo")
    read_slo = slo["slos"]["read"]
    assert read_slo["count"] >= WARM_READS + pages + 2, read_slo
    q = statistics.quantiles(warm_s, n=100)
    return {"rows": len(rows), "pages": pages, "cold_s": cold_s,
            "warm_p50_s": q[49], "warm_p99_s": q[98],
            "tile_bytes": len(tile), "read_slo": read_slo}


def _small_http_stream(base: str, tmp: Path, res: Path) -> dict:
    """12c: a 32x32 dataset (10 formulas) streamed over HTTP in two chunks
    beside its batch job in the same service: a duplicate (200,
    ``duplicate: true``), a conflict (409), a finish on an empty log (409
    ``stream_empty``); the sealed stream bit-equal to the batch run."""
    import pandas as pd

    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu_torch.io.imzml import ImzMLReader

    path, truth = generate_synthetic_dataset(
        tmp / "small12", nrows=32, ncols=32, present_fraction=0.6,
        noise_peaks=50, seed=3)
    formulas = list(truth.formulas[:10])
    _, batch = _http(base, "/submit", "POST", {
        "ds_id": "small12_batch", "input_path": str(path),
        "formulas": formulas})
    _, live = _http(base, "/submit", "POST", {
        "ds_id": "small12_live", "mode": "stream", "formulas": formulas})
    with ImzMLReader(path) as rd:
        coords = rd.coordinates.tolist()
        spectra = [rd.read_spectrum(i) for i in range(rd.n_spectra)]
    half = len(coords) // 2
    bodies = [{"seq": seq, "coords": coords[lo:hi],
               "mzs": [m.tolist() for m, _ in spectra[lo:hi]],
               "ints": [v.tolist() for _, v in spectra[lo:hi]]}
              for seq, lo, hi in ((0, 0, half), (1, half, len(coords)))]
    codes = {}
    for body in bodies:
        status, out = _http(base, "/datasets/small12_live/pixels", "POST",
                            body)
        assert status == 200 and not out["duplicate"], out
        _wait_partial(base, live["msg_id"], body["seq"] + 1, 300)
    status, out = _http(base, "/datasets/small12_live/pixels", "POST",
                        bodies[0])
    assert status == 200 and out["duplicate"] is True, out
    codes["duplicate"] = status
    conflict = dict(bodies[0], ints=[[v + 1.0 for v in row]
                                     for row in bodies[0]["ints"]])
    status, out = _http(base, "/datasets/small12_live/pixels", "POST",
                        conflict)
    assert status == 409 and out["reason"] == "chunk_conflict", out
    codes["conflict"] = status
    status, out = _http(base, "/datasets/small12_never/finish", "POST", {})
    assert status == 409 and out["reason"] == "stream_empty", out
    codes["empty_finish"] = status
    status, out = _http(base, "/datasets/small12_live/finish", "POST", {})
    assert status == 200 and out["finished"], out
    rows = _wait_jobs(base, [batch["msg_id"], live["msg_id"]], 600)
    assert all(r["state"] == "done" for r in rows.values()), rows
    for name in ("annotations", "all_metrics"):
        got, want = (pd.read_parquet(res / d / f"{name}.parquet")
                     .sort_values(["sf", "adduct"]).reset_index(drop=True)
                     for d in ("small12_live", "small12_batch"))
        _same_frame(got, want, f"12c sealed stream {name}")
    return codes


def phase_read_stream(card: str, tmp: Path, ds, truth, main: dict) -> dict:
    """Phase 12: the read path and live-acquisition stream ingest, in an
    ``AnnotationService`` with phase 11's knobs over its results dir.

    12a: the read routes over phase 11's stored job (``svc_main``).  12b: a
    ``mode: "stream"`` job over the main path's dataset appended through
    ``stream_ingest.append_chunk`` (the facade ``POST /datasets/<id>/
    pixels`` calls) in chunks of 72, 104 and 80 image rows, each re-rank
    awaited, then ``POST /datasets/<id>/finish``: every provisional
    re-score bit-equal to a direct search over its prefix (phase 3's search
    for the whole slide), the sealed stream bit-equal to phase 3, moments
    and packed chaos launched on every re-score.  12c: a small stream over HTTP.  12d: a stream that gets no
    chunk dead-letters with ``StreamIdleError``."""
    import pandas as pd

    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.engine.residency import DatasetResidency
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.ops.buckets import row_bucket
    from sm_distributed_tpu_torch.service import AnnotationService
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    t_phase = time.perf_counter()
    ref = main["bundle"]
    res = tmp / "service_results"
    sm = SMConfig.from_dict({
        **SERVICE_SM, "work_dir": str(tmp / "work"),
        "storage": {"results_dir": str(res)},
        "service": {**SERVICE_SM["service"],
                    "stream": {"poll_interval_s": 0.05,
                               "rescore_min_chunks": 1}}})
    assert sm.service.read.enabled
    residency = DatasetResidency(max_datasets=2, max_backends=2)
    service = AnnotationService(
        tmp / "read_stream_q", annotate_callback(sm, residency=residency),
        sm_config=sm, residency=residency)
    service.start()
    searches = _StreamSearches()
    try:
        base = "http://%s:%d" % service.api.address
        reads = _read_path_checks(base, res, "svc_main")
        say(f"  [{card}] 12a read path over svc_main: {reads['rows']} rows "
            f"in {reads['pages']} pages of 100 equal to the parquet scan, "
            f"cold {reads['cold_s'] * 1e3:.3f} ms, warm a cache hit, "
            f"{WARM_READS} warm reads p50 {reads['warm_p50_s'] * 1e3:.3f} ms "
            f"p99 {reads['warm_p99_s'] * 1e3:.3f} ms (printed, not gated); "
            f"top ion's tile {reads['tile_bytes']} B byte-equal to a direct "
            f"render; cohort answers; /slo read {reads['read_slo']}")

        # --- 12b: the main dataset as a live acquisition
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t_stream = time.perf_counter()
        _, sub = _http(base, "/submit", "POST", {
            "ds_id": "svc_stream", "mode": "stream",
            "formulas": list(truth.formulas)})
        msg_id = sub["msg_id"]
        searches.label = "12b"
        reranks, edges = [], np.cumsum((0,) + STREAM_ROWS)
        for seq in range(len(STREAM_ROWS)):
            coords, spectra = _stream_spectra(ds, (edges[seq],
                                                   edges[seq + 1]))
            t0 = time.perf_counter()
            out = service.stream_ingest.append_chunk(
                "svc_stream", seq, coords, spectra)
            append_s = time.perf_counter() - t0
            assert out["committed"] and not out["duplicate"], out
            part = _wait_partial(base, msg_id, seq + 1, 900)
            rec = searches.records[-1]
            assert rec["provisional"] and rec["label"] == "12b", rec["label"]
            # the prefix the re-score assembled from the chunk log: its rows
            # are the chunks' and the sealed pass's whole is held to the
            # main dataset below
            prefix = rec["ds"]
            assert prefix.nrows == edges[seq + 1], prefix.nrows
            if prefix.nrows == ds.nrows:
                # the whole slide: phase 3's search is the direct search
                for attr in ("mzs_flat", "ints_flat", "pixel_inds",
                             "row_ptr", "mask"):
                    assert np.array_equal(getattr(prefix, attr),
                                          getattr(ds, attr)), attr
                direct = ref
            else:
                direct = searches.direct(MSMBasicSearch(
                    prefix, list(truth.formulas), DSConfig(), sm,
                    isocalc_cache_dir=str(tmp / "work" / "isocalc_cache")))
            for name in ("annotations", "all_metrics"):
                _same_frame(getattr(rec["bundle"], name).reset_index(
                    drop=True), getattr(direct, name).reset_index(drop=True),
                    f"re-score over {edges[seq + 1]} rows: {name}")
            ann = direct.annotations
            top = ann.sort_values("msm", ascending=False).head(5)
            assert part["n_scored"] == len(direct.all_metrics)
            assert part["annotations"] == len(ann)
            assert part["fdr_10pct"] == int((ann["fdr"] <= 0.1).sum())
            assert part["top"] == [
                {"sf": str(r.sf), "adduct": str(r.adduct),
                 "msm": round(float(r.msm), 6),
                 "fdr": round(float(r.fdr), 6)} for r in top.itertuples()]
            ln = rec["launches"]
            assert ln["moments"] > 0 and ln["chaos"] > 0, ln
            tim = rec["bundle"].timings
            reranks.append({
                "rows": int(edges[seq + 1]), "pixels": int(prefix.n_pixels),
                "padded_rows": row_bucket(prefix.nrows),
                "padded_pixels": row_bucket(prefix.nrows) * prefix.ncols,
                "append_s": append_s,
                "commit_to_partial_s": part["stream"]["commit_to_partial_s"],
                "backend_setup_s": tim.get("backend_setup"),
                "score_s": tim.get("score"),
                "launches": {k: v for k, v in ln.items() if v},
                "allocated_after": rec["allocated"]})
            del direct, prefix
        status, out = _http(base, "/datasets/svc_stream/finish", "POST", {})
        assert status == 200 and out["finished"], out
        row = _wait_jobs(base, [msg_id], 900)[msg_id]
        assert row["state"] == "done", row
        stream_s = time.perf_counter() - t_stream
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(0)
        final = [r for r in searches.records
                 if r["label"] == "12b" and not r["provisional"]]
        assert len(final) == 1
        job = [r for r in searches.records if r["label"] == "12b"]
        launches = {k: sum(r["launches"][k] for r in job)
                    for k in job[0]["launches"]}
        for name in ("annotations", "all_metrics"):
            _same_frame(pd.read_parquet(res / "svc_stream" /
                                        f"{name}.parquet"),
                        getattr(ref, name).reset_index(drop=True),
                        f"sealed stream {name} against phase 3")
            _same_frame(pd.read_parquet(res / "svc_stream" /
                                        f"{name}.parquet"),
                        pd.read_parquet(res / "svc_main" / f"{name}.parquet"),
                        f"sealed stream {name} against phase 11")
        whole = final[0]["ds"]              # assembled from the chunk log
        for attr in ("mzs_flat", "ints_flat", "pixel_inds", "row_ptr",
                     "mask"):
            assert np.array_equal(getattr(whole, attr), getattr(ds, attr)), \
                attr
        del whole
        _, text = _http(base, "/metrics")
        assert f"sm_stream_reranks_total {len(STREAM_ROWS)}" in text, [
            ln for ln in text.splitlines() if "stream" in ln]
        assert part["stream"]["rerank"] == len(STREAM_ROWS) >= 2
        assert peak < 2.5 * main["peak_bytes"], (peak, main["peak_bytes"])
        ftim = final[0]["bundle"].timings
        say(f"  [{card}] 12b stream of the main dataset in chunks of "
            f"{STREAM_ROWS} rows: each provisional re-score bit-equal to a "
            f"direct search over its prefix; re-ranks " + json.dumps(reranks))
        say(f"  [{card}] 12b sealed stream bit-equal to phase 3 and phase 11 "
            f"(final pass: set-up {ftim.get('backend_setup'):.3f} s, score "
            f"{ftim.get('score'):.3f} s); stream launches {launches}; "
            f"sm_stream_reranks_total {len(STREAM_ROWS)}; device peak "
            f"{peak} B ({peak / main['peak_bytes']:.2f}x the main path's); "
            f"{stream_s:.1f} s from submit to done")

        # --- 12c: a small stream over HTTP
        searches.label = "12c"
        codes = _small_http_stream(base, tmp, res)
        say(f"  [{card}] 12c small HTTP stream (32x32, 10 formulas): codes "
            f"{codes}, finish on an empty log 409 stream_empty, sealed "
            "stream bit-equal to its batch run")
    finally:
        searches.close()
        assert service.shutdown(), "service did not drain"

    # --- 12d: an acquisition that never gets a chunk
    idle_sm = SMConfig.from_dict({
        **SERVICE_SM, "work_dir": str(tmp / "idle_work"),
        "storage": {"results_dir": str(tmp / "idle_results")},
        "service": {**SERVICE_SM["service"],
                    "stream": {"idle_timeout_s": 5.0,
                               "poll_interval_s": 0.05}}})
    idle = AnnotationService(tmp / "idle_q", annotate_callback(idle_sm),
                             sm_config=idle_sm)
    idle.start()
    try:
        base = "http://%s:%d" % idle.api.address
        _, sub = _http(base, "/submit", "POST", {
            "ds_id": "silent", "mode": "stream",
            "formulas": list(truth.formulas[:1])})
        row = _wait_jobs(base, [sub["msg_id"]], 120)[sub["msg_id"]]
        assert row["state"] == "cancelled" and row["attempts"] == 1, row
        assert "stream idle" in row["error"], row
        dead = json.loads((tmp / "idle_q" / "sm_annotate" / "failed" /
                           f"{sub['msg_id']}.json").read_text())
        assert dead.get("cancelled") is True, dead
    finally:
        assert idle.shutdown(), "idle service did not drain"
    say(f"  [{card}] 12d a stream with no chunk for 5 s dead-lettered "
        "(cancelled, 1 attempt, StreamIdleError)")
    _breaker_closed(2, "phase 12")
    took = time.perf_counter() - t_phase
    say(f"phase 12 read path and stream: {took:.1f} s; reads exact, every "
        "provisional re-score bit-equal to its prefix's direct search, the "
        "sealed stream bit-equal to phase 3, the idle stream dead-lettered")
    return {"reads": reads, "reranks": reranks, "launches": launches,
            "final_timings": {k: ftim.get(k) for k in
                              ("backend_setup", "score")},
            "peak_bytes": peak, "stream_s": stream_s, "http": codes,
            "phase_s": took}


# ------------------------------------- phase 13: device patterns, profiler
# the JAX package's bounds of device-mode patterns against the oracle
# (tests/test_isocalc_parallel.py)
ISO_MZ_TOL, ISO_INT_TOL = 5e-6, 1e-3
# ions of phase 9's list whose segments 13a also runs through the stage on
# the CPU (a few thousand segments)
ISO_CPU_IONS = 500
# the hand kernels' device functions, as the profiler names them, by
# launch counter (the row-tile kernel serves both the packed and the
# strips routes)
PROFILED_KERNELS = {"moments": ("moments_cluster_kernel",),
                    "chaos": ("chaos_smem_kernel",),
                    "chaos_tiles": ("chaos_tile_kernel",),
                    "chaos_strips": ("chaos_tile_kernel",),
                    "fused_window_moments": ("fused_cluster_kernel",)}
PROFILE_KEYS = {"seconds", "duration_s", "trace_file", "attribution",
                "jobs_running", "injected_spans"}
# at most this many 1 s captures while 13c's 32x32 job runs
LIVE_CAPTURES = 20


def _pattern_gaps(got: list, want: list, what: str) -> tuple[float, float]:
    """Worst |dm/z| and |dint| of two pattern lists of one ion list, after
    checking each ion's peak count; raises past the JAX package's bounds."""
    dmz = dint = 0.0
    for i, ((gm, gi), (wm, wi)) in enumerate(zip(got, want)):
        assert gm.size == wm.size, f"{what}: ion {i} has {gm.size} peaks, " \
            f"not {wm.size}"
        if gm.size:
            dmz = max(dmz, float(np.abs(gm - wm).max()))
            dint = max(dint, float(np.abs(gi - wi).max()))
    assert dmz < ISO_MZ_TOL and dint < ISO_INT_TOL, (what, dmz, dint)
    return dmz, dint


def phase_device_patterns(card: str, oracle: dict) -> dict:
    """13a: phase 9's 10,500 ions (``bench.py``'s ``scale`` case, uncut)
    generated cold in device mode (``IsocalcWrapper(device_blur=True)`` on
    the card) into a fresh cache dir, held ion by ion to phase 9's cold
    oracle table (equal peak counts, |dm/z| < 5e-6, |dint| < 1e-3); the
    stage's raw outputs for the first ions' segments on the CPU as well,
    held to the card's within the same bounds; the ``dev`` namespace: a
    second device-mode wrapper warm-loads every ion, an oracle-mode one
    none."""
    from sm_distributed_tpu_torch.ops.isocalc import (
        IsocalcWrapper,
        fine_structure_segments,
    )
    from sm_distributed_tpu_torch.ops.formula import (
        apply_adduct,
        parse_formula,
    )
    from sm_distributed_tpu_torch.ops.isocalc_torch import DeviceBlurCentroid

    t_phase = time.perf_counter()
    table = oracle["table"]
    cfg = oracle["ds_cfg"].isotope_generation
    pairs = list(zip(table.sfs, table.adducts))
    want = oracle["isocalc"].pattern_table(pairs, list(table.targets))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_iso_") as cache:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dev = IsocalcWrapper(cfg, cache_dir=cache, device_blur=True,
                             device="cuda")
        got = dev.pattern_table(pairs, list(table.targets))
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        stage = dict(dev._device.stats)
        assert got.sfs == want.sfs and got.adducts == want.adducts
        assert np.array_equal(got.n_valid, want.n_valid), "peak counts differ"
        dmz = float(np.abs(got.mzs - want.mzs).max())
        dint = float(np.abs(got.ints - want.ints).max())
        assert dmz < ISO_MZ_TOL and dint < ISO_INT_TOL, (dmz, dint)
        heavy = got.n_ions - stage["ions"]
        assert stage["ions"] > 0 and heavy >= 0, stage
        # the namespace: device shards only, warm for device mode
        names = [p.name for p in Path(cache).glob("theor_peaks_*")]
        assert names and all(n.startswith(
            f"theor_peaks_{dev._param_key()}") for n in names), names
        warm = IsocalcWrapper(cfg, cache_dir=cache, device_blur=True,
                              device="cuda")
        assert len(warm._cache) == got.n_ions, len(warm._cache)
        host = IsocalcWrapper(cfg, cache_dir=cache)
        assert host._cache == {}, len(host._cache)
    # the stage on the card and on the CPU over the same segments
    params = (cfg.charge, cfg.isocalc_sigma, cfg.isocalc_pts_per_mz,
              cfg.n_peaks)
    segs = [s for s in (fine_structure_segments(
        apply_adduct(parse_formula(sf), ad), *params)
        for sf, ad in pairs[:ISO_CPU_IONS]) if s is not None]
    on_card = DeviceBlurCentroid(*params, device="cuda")
    on_cpu = DeviceBlurCentroid(*params, device="cpu")
    t0 = time.perf_counter()
    card_out = on_card.centroid_batch(segs)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_out = on_cpu.centroid_batch(segs)
    cpu_s = time.perf_counter() - t0
    cpu_gap = _pattern_gaps(card_out, cpu_out, "13a card vs CPU stage")
    oracle_s = oracle["patterns_s"]
    took = time.perf_counter() - t_phase
    out = {"n_ions": got.n_ions, "cold_s": cold_s,
           "oracle_cold_s": oracle_s, "oracle_gen": oracle["stats"],
           "gen": dict(dev.last_stats), "stage": stage, "heavy_ions": heavy,
           "peak_bytes": peak, "max_dmz": dmz, "max_dint": dint,
           "cpu_check": {"ions": len(segs),
                         "segments": on_cpu.stats["segments"],
                         "card_s": card_s, "cpu_s": cpu_s,
                         "max_dmz": cpu_gap[0], "max_dint": cpu_gap[1]},
           "phase_s": took}
    say(f"  [{card}] 13a device patterns: {got.n_ions} ions cold in "
        f"{cold_s:.3f} s against phase 9's oracle {oracle_s:.3f} s "
        f"(generation {oracle['stats'].get('seconds')} s, "
        f"{oracle['stats'].get('workers')} workers); stage "
        f"{stage['seconds']:.3f} s ({stage['device_s']:.3f} s on the card "
        f"by CUDA events), {stage['calls']} calls, {stage['ions']} ions, "
        f"{stage['segments']} segments, {stage['buckets']} buckets, "
        f"{stage['blocks']} blocks; {heavy} heavy ions took the oracle; "
        f"device peak {peak} B above the {base} B already allocated; worst "
        f"|dm/z| {dmz:.3e}, |dint| {dint:.3e} against the oracle; "
        f"namespace: {len(names)} dev shards, warm-loaded whole, invisible "
        "to an oracle-mode wrapper")
    say(f"  [{card}] 13a stage on the card vs on the CPU over the first "
        f"{len(segs)} ions ({on_cpu.stats['segments']} segments): worst "
        f"|dm/z| {cpu_gap[0]:.3e}, |dint| {cpu_gap[1]:.3e}; card "
        f"{card_s:.3f} s, CPU {cpu_s:.3f} s")
    return out


def phase_profiled_search(card: str, ds, truth, main_ann, tmp: Path) -> dict:
    """13b: the main path's data and its 100 formulas (4,944 ions) at the
    shipped defaults with ``isocalc_device="on"`` and a cold pattern cache,
    searched in a worker thread while this thread holds a ``ProfileSession``
    open from before the search starts until after it ends (the service's
    layout: the capture and the job in different threads).  Each hand
    kernel's event count in the capture must equal its launch counter's
    delta over the search, and the attribution's classes must add up to its
    total.  Prints the attribution, the device stage's share of the device
    time and the FDR ranks against phase 3's search (not gated: the
    patterns differ within contract)."""
    import threading

    from sm_distributed_tpu_torch.analysis.profiling import ProfileSession
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    t_phase = time.perf_counter()
    search = MSMBasicSearch(ds, truth.formulas, DSConfig(), SMConfig.from_dict(
        {"fdr": {"decoy_sample_size": 20},
         "parallel": {"isocalc_device": "on"}}))
    done: dict = {}

    def run():
        try:
            done["bundle"] = search.search()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            done["error"] = exc

    # the stage's wall windows: during the search's pattern phase nothing
    # else runs on the card, so the device events that start inside them
    # are the stage's
    stage_obj = search.isocalc._device_stage()
    windows: list = []
    centroid_batch = stage_obj.centroid_batch

    def timed_batch(seg_lists):
        w0 = time.time()
        out = centroid_batch(seg_lists)
        windows.append((w0, time.time()))
        return out

    stage_obj.centroid_batch = timed_batch
    session = ProfileSession(tmp / "profile13b")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    session.start()
    start_s = time.perf_counter() - t0
    worker = threading.Thread(target=run, name="profiled-search")
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    result = session.stop()
    wall = time.perf_counter() - t0
    launches = read_launches()
    if "error" in done:
        raise done["error"]
    bundle = done["bundle"]
    att = result["attribution"]
    counts: dict = {}
    for e in result["events"]:
        counts[e["op"]] = counts.get(e["op"], 0) + 1
    events = {k: sum(counts.get(n, 0) for n in names)
              for k, names in PROFILED_KERNELS.items()}
    say(f"  [{card}] 13b profiled search: wall {wall:.3f} s (capture start "
        f"{start_s:.3f} s, duration {result['duration_s']} s); phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in bundle.timings.items())
        + f"; launches {launches}; profiler events by hand kernel {events}; "
        f"{att['n_events']} device events, {att['total_device_s']:.6f} s")
    say(f"  [{card}] 13b attribution by class (s): {json.dumps(att['by_class_s'])}"
        f"; top kernels: " + json.dumps(
            [{k: x[k] for k in ("module", "op", "class", "device_s", "count")}
             for x in att["kernels"][:12]]))
    assert launches["moments"] > 0 and launches["chaos"] > 0, launches
    assert events["moments"] == launches["moments"], (events, launches)
    assert events["chaos"] == launches["chaos"], (events, launches)
    assert events["fused_window_moments"] == \
        launches["fused_window_moments"], (events, launches)
    assert events["chaos_tiles"] == (launches["chaos_tiles"]
                                     + launches["chaos_strips"]), (
        events, launches)
    assert abs(sum(att["by_class_s"].values()) - att["total_device_s"]) \
        < 1e-8, att["by_class_s"]
    stage = dict(stage_obj.stats)
    # Kineto's ts is microseconds past the trace's baseTimeNanoseconds on
    # the wall clock
    import gzip

    with gzip.open(result["trace_file"], "rt") as fh:
        base_s = json.load(fh).get("baseTimeNanoseconds", 0) / 1e9
    stage_kernel_s = sum(
        e["dur_s"] for e in result["events"]
        if any(w0 <= base_s + e["ts_us"] / 1e6 <= w1 for w0, w1 in windows))
    share = stage_kernel_s / att["total_device_s"]
    ref, got = main_ann, bundle.annotations
    key = ["sf", "adduct"]
    both = ref.merge(got, on=key, suffixes=("_ref", "_dev"))
    same_order = [tuple(r) for r in ref[key].itertuples(index=False)] == [
        tuple(r) for r in got[key].itertuples(index=False)]
    ranks = {"annotations": [len(ref), len(got)], "same_order": same_order,
             "fdr_level_differs": int(
                 (both.fdr_level_ref != both.fdr_level_dev).sum()),
             "at_10pct": [int((ref.fdr_level <= 0.1).sum()),
                          int((got.fdr_level <= 0.1).sum())]}
    took = time.perf_counter() - t_phase
    say(f"  [{card}] 13b device stage: its kernels {stage_kernel_s:.6f} s "
        f"(profiler events inside its {len(windows)} calls' windows), "
        f"{100 * share:.2f}% of the capture's device time; its blocks span "
        f"{stage['device_s']:.6f} s on the card's stream (CUDA events, "
        f"launch gaps included) and {stage['seconds']:.3f} s in all, "
        f"{stage['blocks']} blocks; FDR against phase 3 (not gated): "
        f"{json.dumps(ranks)}")
    return {"wall_s": wall, "timings": bundle.timings, "launches": launches,
            "events": events, "attribution": att, "stage": stage,
            "stage_kernel_s": stage_kernel_s,
            "stage_share": share, "capture_start_s": start_s,
            "duration_s": result["duration_s"], "ranks": ranks,
            "phase_s": took}


def phase_profile_route(card: str, tmp: Path) -> dict:
    """13c: ``GET /debug/profile`` in an ``AnnotationService`` with phase
    11's knobs: ``?seconds=1`` answers 200 with the JAX response's keys,
    ``?seconds=-1`` 400, two at once one 200 and one 409, captures of 1 s
    one after another while a 32x32 job runs (their running jobs, device
    events and injected spans printed, not gated; the job's trace holds
    every injected span), ``sm_profile_captures_total`` counting the
    completed captures; a service with ``telemetry.profile.enabled`` false
    answers 404."""
    import threading

    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu_torch.service import AnnotationService
    from sm_distributed_tpu_torch.utils.config import SMConfig

    t_phase = time.perf_counter()
    sm = SMConfig.from_dict({
        **SERVICE_SM, "work_dir": str(tmp / "work13"),
        "storage": {"results_dir": str(tmp / "results13")}})
    service = AnnotationService(tmp / "profile_q", annotate_callback(sm),
                                sm_config=sm)
    service.start()
    codes: dict = {}
    try:
        base = "http://%s:%d" % service.api.address
        status, one = _http(base, "/debug/profile?seconds=1")
        assert status == 200 and set(one) == PROFILE_KEYS, (status, one)
        codes["seconds=1"] = status
        status, bad = _http(base, "/debug/profile?seconds=-1")
        assert status == 400 and bad["reason"] == "invalid_request", bad
        codes["seconds=-1"] = status
        pair: list = []
        threads = [threading.Thread(target=lambda: pair.append(
            _http(base, "/debug/profile?seconds=1"))) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert sorted(st for st, _ in pair) == [200, 409], pair
        codes["concurrent"] = sorted(st for st, _ in pair)
        # captures of 1 s, one after another, while a 32x32 job runs
        path, truth = generate_synthetic_dataset(
            tmp / "small13", nrows=32, ncols=32, present_fraction=0.6,
            noise_peaks=50, seed=3)
        _, sub = _http(base, "/submit", "POST", {
            "ds_id": "small13", "input_path": str(path),
            "formulas": list(truth.formulas[:10])})
        live: list = []
        deadline = time.time() + 300
        while time.time() < deadline and len(live) < LIVE_CAPTURES:
            rows = {j["msg_id"]: j for j in _http(base, "/jobs")[1]}
            state = rows.get(sub["msg_id"], {}).get("state")
            if state in ("done", "failed", "cancelled", "quarantined"):
                break
            if state != "running":
                time.sleep(0.02)
                continue
            status, cap = _http(base, "/debug/profile?seconds=1")
            assert status == 200, (status, cap)
            live.append({"jobs_running": cap["jobs_running"],
                         "injected_spans": cap["injected_spans"],
                         "device_events": cap["attribution"]["n_events"],
                         "device_s": cap["attribution"]["total_device_s"]})
        row = _wait_jobs(base, [sub["msg_id"]], 300)[sub["msg_id"]]
        assert row["state"] == "done", row
        metrics = _http(base, "/metrics")[1]
        n_caps = 2 + len(live)
        assert f"sm_profile_captures_total {n_caps}" in metrics, [
            ln for ln in metrics.splitlines() if "profile" in ln]
        trace = _http(base, f"/jobs/{sub['msg_id']}/trace?raw=1")[1]
        spans = sum(r["name"] == "device_kernel" for r in trace["records"])
        assert spans == sum(c["injected_spans"] for c in live), spans
        status, other = _http(base, "/debug/compile")
        assert status == 200 and set(other) == {"primer", "builds"}, other
    finally:
        assert service.shutdown(), "service did not drain"
    off_sm = SMConfig.from_dict({
        **SERVICE_SM, "work_dir": str(tmp / "work13off"),
        "storage": {"results_dir": str(tmp / "results13off")},
        "telemetry": {**SERVICE_SM["telemetry"],
                      "profile": {"enabled": False}}})
    off = AnnotationService(tmp / "profile_off_q", annotate_callback(off_sm),
                            sm_config=off_sm)
    off.start()
    try:
        status, body = _http("http://%s:%d" % off.api.address,
                             "/debug/profile?seconds=1")
        assert status == 404 and body["reason"] == "not_found", body
        codes["disabled"] = status
    finally:
        assert off.shutdown(), "disabled service did not drain"
    took = time.perf_counter() - t_phase
    say(f"  [{card}] 13c /debug/profile: codes {codes}; the first capture "
        f"{one['duration_s']} s for seconds {one['seconds']}, "
        f"{one['attribution']['n_events']} device events on an idle card; "
        f"{len(live)} captures of 1 s while the 32x32 job ran: "
        f"{json.dumps(live)}; its trace holds {spans} device_kernel spans; "
        f"sm_profile_captures_total {n_caps}; /debug/compile 200")
    return {"codes": codes, "first_duration_s": one["duration_s"],
            "live": live, "trace_device_spans": spans, "phase_s": took}


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


# phase 15: a replica takeover on the card (port slice 15).  r0, a
# ``drivers.replica_chaos --replica-serve`` subprocess of a 2-replica
# config, dies at its first score group; r1, in process, fences and
# requeues its claim and runs the job.  Every check is a state, a count or
# bit-equality; the deadline only ends a hang.
TAKEOVER_DS = "takeover_main"
TAKEOVER_SPEC = "device.score_batch=crash@1"
TAKEOVER_DEADLINE_S = 120.0
TAKEOVER_SM = {"device": "cuda", "fdr": {"decoy_sample_size": 20},
               "service": {"workers": 1, "http_port": 0, "replicas": 2,
                           "spool_shards": 8, "poll_interval_s": 0.05,
                           "heartbeat_interval_s": 0.2,
                           "stale_after_s": 2.0,
                           "replica_heartbeat_interval_s": 0.2,
                           "replica_stale_after_s": 2.0,
                           "takeover_interval_s": 0.2,
                           "backoff_base_s": 0.2, "backoff_jitter": 0.0}}


def _spool_census(root: Path) -> dict:
    return {s: sorted(p.name for p in (root / s).glob("*.json"))
            for s in ("pending", "running", "done", "failed", "quarantine")}


def _wait_state(what: str, ready, deadline: float) -> None:
    """Poll ``ready()`` until it holds; the deadline only ends a hang."""
    while not ready():
        assert time.time() < deadline, f"{what} never held"
        time.sleep(0.05)


def phase_takeover(card: str, tmp: Path, truth, main: dict) -> dict:
    """Phase 15: a replica takeover on the card, on phase 3b's imzML, work
    dir (warm pattern cache) and the main path's ions.  15a: replica r0 of
    a 2-replica config, a ``drivers.replica_chaos --replica-serve``
    subprocess on ``cuda:0`` with ``SM_FAILPOINTS=device.score_batch=
    crash@1`` and ``SM_LOCK_ORDER=raise``, is the only live replica and
    owns every shard: it claims the one message, stages and parses the
    input, builds its backend on the card and dies at the first score
    group.  15b: once r0's registry beat and its claim's heartbeat are
    older than the config's staleness horizons (polled, no fixed sleep),
    r1 starts in process (``AnnotationService``, the lock-order detector
    in raise mode, the launch counts reset just before): its takeover
    fences and requeues the claim and it runs the job to ``done/``."""
    import os

    from sm_distributed_tpu_torch.analysis import lockorder
    from sm_distributed_tpu_torch.engine.daemon import (
        QUEUE_ANNOTATE,
        QueuePublisher,
        annotate_callback,
    )
    from sm_distributed_tpu_torch.engine.storage import JobLedger
    from sm_distributed_tpu_torch.service import AnnotationService
    from sm_distributed_tpu_torch.service.leases import (
        LeaseStore,
        ReplicaRegistry,
    )
    from sm_distributed_tpu_torch.service.scheduler import claim_last_alive
    from sm_distributed_tpu_torch.utils.config import SMConfig

    import pandas as pd

    t_phase = time.perf_counter()
    base = tmp / "takeover"
    queue = base / "queue"
    root = queue / QUEUE_ANNOTATE
    base.mkdir(parents=True)
    sm_dict = {**TAKEOVER_SM, "work_dir": str(tmp / "work"),
               "storage": {"results_dir": str(base / "results")}}
    sm_json = base / "sm.json"
    sm_json.write_text(json.dumps(sm_dict))
    svc = TAKEOVER_SM["service"]
    msg_name = f"{TAKEOVER_DS}.json"
    QueuePublisher(queue).publish({
        "ds_id": TAKEOVER_DS, "msg_id": TAKEOVER_DS,
        "input_path": str(tmp / "main_path.imzML"),
        "formulas": list(truth.formulas)})

    # 15a: r0 dies at its first score group, holding the claim
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env["SM_FAILPOINTS"] = TAKEOVER_SPEC
    env["SM_LOCK_ORDER"] = "raise"
    log = base / "r0.log"
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "sm_distributed_tpu_torch.drivers.replica_chaos",
             "--replica-serve", str(queue), str(sm_json),
             "--replica-id", "r0", "--idle-exit", str(TAKEOVER_DEADLINE_S),
             "--metrics-dump", str(base / "r0.prom")],
            env=env, stdout=fh, stderr=fh, cwd=str(ROOT))
        try:
            rc = proc.wait(timeout=TAKEOVER_DEADLINE_S)
        finally:
            if proc.poll() is None:      # a hang: reap it before failing
                proc.kill()
                proc.wait()
    r0_s = time.perf_counter() - t0
    r0_log = log.read_text()
    assert rc == 21, f"15a: r0 exited {rc}, not the crash code 21\n" \
        + r0_log[-3000:]
    assert "FAILPOINT-FIRED name=device.score_batch" in r0_log, r0_log[-3000:]
    census = _spool_census(root)
    assert census["running"] == [msg_name] and not any(
        v for k, v in census.items() if k != "running"), census
    lease0 = json.loads((root / "leases" / msg_name).read_text())
    assert lease0["holder"] == "r0", lease0
    fence0 = int(lease0["fence"])
    say(f"  15a [{card}]: r0 claimed {TAKEOVER_DS} and died at its first "
        f"score group in {r0_s:.1f} s (exit 21); the message is in "
        f"running/ under r0's lease (fence {fence0})")

    # 15b: r0's beat and its claim's heartbeat go stale; r1 takes over
    deadline = time.time() + TAKEOVER_DEADLINE_S
    probe = ReplicaRegistry(root, "phase15-probe",
                            stale_after_s=svc["replica_stale_after_s"])
    leases = LeaseStore(root, "phase15-probe")
    claim = root / "running" / msg_name

    def claim_stale() -> bool:
        # the rule r1's takeover scan reads
        return (time.time() - claim_last_alive(claim, leases)
                >= svc["stale_after_s"])

    _wait_state("r0's registry beat stale",
                lambda: "r0" not in probe.alive(), deadline)
    _wait_state("r0's claim heartbeat stale", claim_stale, deadline)
    sm1 = SMConfig.from_dict({**sm_dict, "service": {**svc,
                                                      "replica_id": "r1"}})
    t_takeover = time.time()
    lockorder.enable(mode="raise")
    service = None
    try:
        service = AnnotationService(queue, annotate_callback(sm1),
                                    sm_config=sm1)
        store = service.scheduler.leases
        bumps, claims = [], []
        orig_bump, orig_claim = store.bump, store.claim

        def bump(msg_id):
            fence = orig_bump(msg_id)
            bumps.append((msg_id, fence))
            return fence

        def claim_lease(msg_id):
            lease = orig_claim(msg_id)
            claims.append((msg_id, lease.fence))
            return lease

        store.bump, store.claim = bump, claim_lease
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        service.start()
        _wait_state("r1's job terminal",
                    lambda: service.scheduler._terminal_count >= 1, deadline)
        takeover_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_launches()
        row = {r["msg_id"]: r for r in service.scheduler.jobs()}[TAKEOVER_DS]
        metrics_text = service.metrics.expose()
        # the job's trace file, for phase 17d's report
        trace_file = Path(service.trace_dir) / f"{row['trace_id']}.jsonl"
    finally:
        if service is not None:
            service.shutdown()
        report = lockorder.disable()
    assert row["state"] == "done", row
    census = _spool_census(root)
    assert census["done"] == [msg_name] and not any(
        v for k, v in census.items() if k != "done"), census
    assert bumps == [(TAKEOVER_DS, fence0 + 1)], (bumps, fence0)
    assert claims == [(TAKEOVER_DS, fence0 + 2)], (claims, fence0)
    assert 'sm_replica_takeover_requeues_total{replica="r1"} 1' in \
        metrics_text, [ln for ln in metrics_text.splitlines()
                       if "takeover" in ln]
    ledger = JobLedger(base / "results")
    try:
        n_reconciled = ledger.fail_stale_started(ds_ids=[TAKEOVER_DS],
                                                 before=t_takeover)
        statuses = list(ledger.jobs(TAKEOVER_DS).status)
    finally:
        ledger.close()
    assert "STARTED" not in statuses and statuses[-1] == "FINISHED", statuses
    res = base / "results" / TAKEOVER_DS
    ref = main["bundle"]
    _same_frame(pd.read_parquet(res / "annotations.parquet"),
                ref.annotations.reset_index(drop=True),
                "takeover annotations")
    _same_frame(pd.read_parquet(res / "all_metrics.parquet"),
                ref.all_metrics.reset_index(drop=True),
                "takeover all_metrics")
    n_batches = -(-main["n_ions"] // 2048)
    want = {k: 0 for k in launches}
    want["moments"] = want["chaos"] = n_batches
    assert launches == want, (launches, want)
    assert not report["cycles"], report
    timings = json.loads((res / "timings.json").read_text())
    job_wall = row["finished_at"] - row["started_at"]
    took = time.perf_counter() - t_phase
    say(f"  15b [{card}]: r1 fenced r0's claim (fence {fence0} -> "
        f"{fence0 + 1}), requeued it (sm_replica_takeover_requeues_total 1) "
        f"and claimed it at fence {fence0 + 2}; {takeover_s:.1f} s from r1's "
        f"start to done; job wall {job_wall:.3f} s, phases "
        + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items()
                    if isinstance(v, (int, float)))
        + f"; ledger after fail_stale_started(before=takeover) "
        f"{statuses} ({n_reconciled} reconciled); launches {launches}; "
        f"lock order: {report['locks_instrumented']} locks, "
        f"{report['edges']} edges, no cycle")
    say(f"phase 15 replica takeover [{card}]: {took:.1f} s; one message in "
        "done/, none elsewhere; stored results bit-equal to phase 3")
    return {"phase_s": took, "r0_to_crash_s": r0_s,
            "takeover_to_done_s": takeover_s, "job_wall_s": job_wall,
            "job_phases": timings, "fence": [fence0, fence0 + 1, fence0 + 2],
            "ledger": statuses, "reconciled": n_reconciled,
            "lockorder": {k: report[k] for k in
                          ("locks_instrumented", "edges")},
            "launches": launches, "trace_file": str(trace_file)}


# phase 16: the rest of the service on the card (port slice 16).  16a the
# kernel-build primer in process over the bucket specs phases 3 and 11
# recorded (and a two-card spec of phase 14c); 16b ``serve --fleet`` as a
# subprocess with two replicas, a job, a replica SIGKILLed and replaced,
# and SIGTERM draining every child; 16c the fleet view across both
# replicas.  Every check is a state, a count or bit-equality; the deadline
# only ends a hang.
FLEET_DEADLINE_S = 180.0
# the kernels of sm_kernel_launches_total, the replicas' launch counts
FLEET_KERNELS = ("moments", "chaos", "chaos_tiles", "chaos_strips",
                 "fused_window_moments")
FLEET_SM = {"device": "cuda", "fdr": {"decoy_sample_size": 20},
            "service": {"workers": 1, "http_port": 0, "spool_shards": 8,
                        "poll_interval_s": 0.05, "heartbeat_interval_s": 0.2,
                        "replica_heartbeat_interval_s": 0.2,
                        "replica_stale_after_s": 3.0,
                        "takeover_interval_s": 0.2,
                        "fleet": {"min_replicas": 2, "max_replicas": 2,
                                  "decide_interval_s": 0.2,
                                  "cooldown_s": 0.0, "hysteresis_ticks": 1,
                                  "spawn_timeout_s": 120.0,
                                  "drain_timeout_s": 60.0},
                        "fleetview": {"cache_ttl_s": 0.0}},
            "telemetry": {"sample_interval_s": 0.5}}


def _recorded_specs() -> dict:
    """Every bucket spec this process recorded and every one the kernel
    build directory's manifest holds (a ``serve`` subprocess records
    there), by key."""
    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.ops import buckets

    specs = {buckets.spec_key(s): s
             for s in buckets.load_manifest(_build.BUILD_DIR)}
    specs.update((buckets.spec_key(s), s) for s in buckets.recorded_specs())
    return specs


def _children_of(pid: int) -> dict:
    """{replica id: pid} of the ``serve`` replicas process ``pid`` spawned
    (read from /proc: the fleet's children are not the script's)."""
    out = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            if int(fields[1]) != pid:
                continue
            argv = (stat.parent / "cmdline").read_bytes().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        args = [a.decode() for a in argv]
        if "--replica-id" in args:
            out[args[args.index("--replica-id") + 1]] = int(stat.parent.name)
    return out


def _reap_marked(marker: str) -> list:
    """Kill every process whose environment carries ``marker`` (a phase's
    subprocesses and whatever they spawned, orphans of a SIGKILLed parent
    included); returns their pids."""
    import os
    import signal

    needle = marker.encode()
    pids = []
    for env in Path("/proc").glob("[0-9]*/environ"):
        try:
            if needle not in env.read_bytes().split(b"\0"):
                continue
            pid = int(env.parent.name)
            if pid == os.getpid():
                continue
            os.kill(pid, signal.SIGKILL)
            pids.append(pid)
        except (OSError, ValueError):
            continue
    return pids


def _metric(text: str, line_prefix: str) -> float:
    """The value of the one exposition sample ``line_prefix`` names (0 when
    absent)."""
    for ln in text.splitlines():
        if ln.startswith(line_prefix + " "):
            return float(ln.rsplit(" ", 1)[1])
    return 0.0


def phase_prime(card: str, specs: dict, two_card: dict | None) -> dict:
    """16a: the primer over the specs phases 3 and 11 recorded, from no
    prime manifest: one cycle primes each (no nvcc run: phase 2 built every
    kernel), launches no kernel and allocates no device memory; a second
    primes none; ``GET /debug/compile`` of an in-process service shows
    every spec primed and the four kernels loaded and set up on
    ``cuda:0``; phase 14c's 2x1 mesh spec made a two-card lease's
    (``devices: 2``; phase 14c ran it on one card, which it records) is
    skipped for want of cards on a one-card machine."""
    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.kernels import _build
    from sm_distributed_tpu_torch.ops import buckets
    from sm_distributed_tpu_torch.service import AnnotationService
    from sm_distributed_tpu_torch.service.primer import CachePrimer
    from sm_distributed_tpu_torch.utils.config import SMConfig

    t_phase = time.perf_counter()
    assert specs, "16a: phases 3 and 11 recorded no bucket spec"
    build_dir = _build.BUILD_DIR
    for name in ("prime_manifest.json", "bucket_manifest.json"):
        (build_dir / name).unlink(missing_ok=True)
    buckets.reset()
    buckets.bind_manifest_dir(build_dir)
    for spec in specs.values():
        buckets.record_spec(spec)
    sm = SMConfig.from_dict({**SERVICE_SM, "service": {
        **SERVICE_SM["service"], "prime": {"enabled": False}}})
    primer = CachePrimer(sm, busy=lambda: False)
    n = len(specs)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(0)
    runs0 = _build.nvcc_runs
    reset_launches()
    t0 = time.perf_counter()
    first = primer.prime_once(abort_when_busy=False)
    cycle_s = time.perf_counter() - t0
    second = primer.prime_once(abort_when_busy=False)
    launches = read_launches()
    torch.cuda.synchronize()
    assert first == {"primed": n, "skipped": 0, "errors": 0,
                     "aborted": False, "built": 0}, (first, n)
    assert second == {"primed": 0, "skipped": n, "errors": 0,
                      "aborted": False, "built": 0}, second
    assert _build.nvcc_runs == runs0, "16a: the primer ran nvcc"
    assert not any(launches.values()), f"16a: priming launched {launches}"
    assert torch.cuda.memory_allocated(0) == mem0, "16a: priming allocated"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_16a_") as tmp:
        svc_sm = SMConfig.from_dict({**SERVICE_SM,
                                     "work_dir": str(Path(tmp) / "work")})
        service = AnnotationService(Path(tmp) / "q", annotate_callback(svc_sm),
                                    sm_config=svc_sm)
        service.start()
        try:
            status, body = _http("http://%s:%d" % service.api.address,
                                 "/debug/compile")
        finally:
            assert service.shutdown(), "16a: service did not drain"
    assert status == 200, (status, body)
    prim = body["primer"]
    assert prim["known"] == prim["primed"] == n and prim["missing"] == 0, \
        {k: prim[k] for k in ("known", "primed", "missing")}
    census = body["builds"]["kernels"]
    for name in _build.KERNELS:
        k = census[name]
        assert k["state"] in ("built", "found") and k["loads"] >= 1 and \
            k["setups"].get("cuda:0", 0) >= 1, (name, k)
    skip = None
    if two_card is not None:
        two_card = {**two_card, "devices": 2}
        buckets.record_spec(two_card)
        third = primer.prime_once(abort_when_busy=False)
        snap = {buckets.spec_key(b): b["status"]
                for b in primer.snapshot()["buckets"]}
        skip = snap[buckets.spec_key(two_card)]
        want = ("skipped:devices" if torch.cuda.device_count() < 2
                else "primed")
        assert skip == want, (skip, want, third)
    took = time.perf_counter() - t_phase
    say(f"  16a [{card}]: {n} recorded bucket specs primed in one cycle of "
        f"{cycle_s:.3f} s with no nvcc run, no launch and no device "
        f"allocation; a second cycle primed 0; /debug/compile primed "
        f"{prim['primed']} of {prim['known']}, missing 0, the kernels "
        + ", ".join(f"{k} {census[k]['state']} ({census[k]['setups']})"
                    for k in _build.KERNELS)
        + f"; phase 14c's mesh spec on two cards: {skip}")
    return {"phase_s": took, "cycle_s": cycle_s, "specs": n,
            "first": first, "second": second, "two_card": skip,
            "census": census, "launches": launches}


def phase_fleet(card: str, tmp: Path, build_dir: Path) -> dict:
    """16b and 16c: ``serve --fleet`` as a subprocess on ``torch_cuda``,
    ``cuda``, ``min_replicas`` 2, over phase 11b's 32x32 dataset, its
    kernel builds in ``build_dir`` (phase 17a's, primed there).  16b: r0
    and a spawned replica come up (states in ``/fleet/status``), each a
    primed replica (17a's part two: every recorded spec primed, no nvcc
    run); one job completes, its stored results bit-equal to phase 11b's,
    and the replica that ran it found every kernel built (no nvcc run, no
    uncached ``compile`` event on the job's trace); 16c: the fleet view
    answers 200 with both replicas and the merged ``sm_jobs_total`` equals
    the sum of the replicas' own; 16b: the spawned replica is SIGKILLed,
    ``sm_fleet_crashes_total`` reaches 1 and a replacement registers;
    SIGTERM drains every child (each drain acked), ``running/`` ends empty
    and the exit code is 0."""
    import os
    import signal
    import threading

    import pandas as pd

    from sm_distributed_tpu_torch.engine.daemon import QueuePublisher
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset

    t_phase = time.perf_counter()
    base = tmp / "fleet"
    path, truth = generate_synthetic_dataset(
        base / "small", nrows=32, ncols=32, present_fraction=0.6,
        noise_peaks=50, seed=3)
    sm_json = base / "sm.json"
    sm_json.write_text(json.dumps({
        **FLEET_SM, "work_dir": str(base / "work"),
        "parallel": {"compile_cache_dir": str(build_dir)},
        "storage": {"results_dir": str(base / "results")}}))
    queue = base / "q"
    root = queue / "sm_annotate"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env.pop("SM_FAILPOINTS", None)
    # inherited by serve, its replicas and their workers: the phase reaps
    # every process that carries it once serve has exited
    env["SM_CHIP_SMOKE_FLEET"] = f"{os.getpid()}-{time.time_ns()}"
    marker = f"SM_CHIP_SMOKE_FLEET={env['SM_CHIP_SMOKE_FLEET']}"
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sm_distributed_tpu_torch.engine.cli",
         "serve", str(queue), "--sm-config", str(sm_json), "--fleet"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(ROOT))
    lines: list[str] = []
    found = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "admin API on http://" in line:
                found.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.time() + FLEET_DEADLINE_S

    def status() -> dict:
        return _http(base_url, "/fleet/status")[1]

    def alive_ids() -> set:
        return {rid for rid, r in status()["replicas"].items()
                if r["alive"] and not r["draining"]}

    try:
        assert found.wait(FLEET_DEADLINE_S), \
            "16b: serve --fleet: no admin API line\n" + "".join(lines[-40:])
        base_url = re.search(r"admin API on (http://[\d.]+:\d+)",
                             "".join(lines)).group(1)
        _wait_state("two replicas alive in /fleet/status",
                    lambda: len(alive_ids()) == 2, deadline)
        up_s = time.perf_counter() - t0
        first_ids = alive_ids()
        spawned = sorted(first_ids - {"r0"})
        assert len(spawned) == 1, first_ids
        # 17a's second part: each replica starts primed over 17a's builds
        admins = {rid: f"http://{rec['admin']}"
                  for rid, rec in status()["replicas"].items()
                  if rid in first_ids}
        primed_at_start = {}
        for rid, admin in admins.items():
            code, dbg = _http(admin, "/debug/compile")
            prim = dbg["primer"]
            assert code == 200 and prim["known"] >= 1 and \
                prim["primed"] == prim["known"] and \
                dbg["builds"]["nvcc_runs"] == 0, (rid, code, prim,
                                                   dbg["builds"])
            primed_at_start[rid] = f"{prim['primed']}/{prim['known']}"
        QueuePublisher(queue).publish({
            "ds_id": "small", "msg_id": "fleet_good",
            "input_path": str(path), "formulas": truth.formulas[:10]})
        _wait_state("the job in done/",
                    lambda: (root / "done" / "fleet_good.json").exists(),
                    deadline)
        job_s = time.perf_counter() - t0 - up_s
        # 16c: the fleet view with both replicas
        codes = {}
        codes["metrics"], merged = _http(base_url, "/fleet/metrics")
        codes["slo"], slo = _http(base_url, "/fleet/slo")
        codes["status"], st = _http(base_url, "/fleet/status")
        assert codes == {"metrics": 200, "slo": 200, "status": 200}, codes
        assert slo["fleet"]["replicas_merged"] == 2 and \
            not slo["fleet"]["partial"], slo["fleet"]
        assert st["alive"] == 2 and not st["partial"], st
        own = {rid: _http(f"http://{rec['admin']}", "/metrics")[1]
               for rid, rec in st["replicas"].items() if rec["alive"]}
        done_sum = sum(_metric(t, 'sm_jobs_total{state="done"}')
                       for t in own.values())
        assert done_sum == 1 and _metric(
            merged, 'sm_jobs_total{state="done"}') == done_sum, \
            (done_sum, [ln for ln in merged.splitlines()
                        if ln.startswith("sm_jobs_total")])
        ran_on = [rid for rid, t in own.items()
                  if _metric(t, 'sm_jobs_total{state="done"}') == 1]
        assert len(ran_on) == 1, ran_on
        primed = _primed_job(admins[ran_on[0]], "fleet_good")
        # each replica's kernel launches since it started, from its own
        # /metrics: the job's, on the replica that ran it, and none on the
        # other (priming launches nothing)
        launches = {rid: {k: int(_metric(t, f'sm_kernel_launches_total'
                                            f'{{kernel="{k}"}}'))
                          for k in FLEET_KERNELS}
                    for rid, t in own.items()}
        merged_launches = {k: int(_metric(merged, f'sm_kernel_launches_total'
                                                  f'{{kernel="{k}"}}'))
                           for k in FLEET_KERNELS}
        # 16b: SIGKILL the spawned replica; the controller counts a crash
        # and spawns a replacement under a new id
        pids = _children_of(proc.pid)
        victim = spawned[0]
        assert victim in pids, (victim, pids)
        t_kill = time.perf_counter()
        os.kill(pids[victim], signal.SIGKILL)
        _wait_state("sm_fleet_crashes_total 1", lambda: _metric(
            _http(base_url, "/metrics")[1], "sm_fleet_crashes_total") == 1,
            deadline)
        _wait_state("a replacement replica alive", lambda: len(
            alive_ids() - {"r0", victim}) == 1, deadline)
        replace_s = time.perf_counter() - t_kill
        replacement = sorted(alive_ids() - {"r0", victim})
        children = _children_of(proc.pid)
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=FLEET_DEADLINE_S)
        drain_s = time.perf_counter() - t_term
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        # the log is in the pipe once serve has exited; an orphan of the
        # SIGKILLed replica may hold the pipe open, so the wait is short
        reader.join(timeout=5)
        leftover = _reap_marked(marker)
    log = "".join(lines)
    (base / "serve.log").write_text(log)
    # what serve and its replicas logged from the SIGTERM on
    tail = log[log.rfind("received signal"):].splitlines()[:12]
    assert rc == 0, f"16b: serve --fleet exited {rc}\n" + log[-4000:]
    for rid in children:
        assert re.search(rf"replica {rid} drained \(rc=0, acked=True\)",
                         log), f"16b: {rid}'s drain not acked\n" + log[-4000:]
    census = _spool_census(root)
    assert census["done"] == ["fleet_good.json"] and not any(
        v for k, v in census.items() if k != "done"), census
    res, ref = base / "results" / "small", tmp / "serve_results" / "small"
    for name in ("annotations", "all_metrics"):
        _same_frame(pd.read_parquet(res / f"{name}.parquet"),
                    pd.read_parquet(ref / f"{name}.parquet"),
                    f"fleet job {name}")
    # one moments and one packed chaos launch a score batch (32x32 pixels:
    # the shared-memory kernel; 30 levels, 4 peaks: one launch each)
    n_ions = len(pd.read_parquet(res / "all_metrics.parquet"))
    n_batches = -(-n_ions // 2048)
    want = {k: 0 for k in FLEET_KERNELS}
    want["moments"] = want["chaos"] = n_batches
    assert len(ran_on) == 1 and launches[ran_on[0]] == want and all(
        not any(v.values()) for rid, v in launches.items()
        if rid != ran_on[0]), (ran_on, launches, want)
    assert merged_launches == want, (merged_launches, want)
    took = time.perf_counter() - t_phase
    say(f"  16b [{card}]: serve --fleet up with r0 and {spawned[0]} alive "
        f"after {up_s:.1f} s; the job ran on {ran_on} in {job_s:.1f} s, "
        f"stored bit-equal to phase 11b's, its {n_ions} ions in {n_batches} "
        f"batch(es) launching {launches[ran_on[0]]} there (from its "
        f"/metrics; none on the other replica); {victim} SIGKILLed, "
        f"sm_fleet_crashes_total 1 and {replacement} alive "
        f"{replace_s:.1f} s later; SIGTERM drained {sorted(children)} "
        f"(acked) and serve exited 0 {drain_s:.1f} s after it; one message "
        f"in done/ and none elsewhere; {len(leftover)} leftover process(es) "
        "of the phase reaped")
    say(f"  16c [{card}]: /fleet/metrics, /fleet/slo, /fleet/status 200 "
        f"with {sorted(own)}; merged sm_jobs_total{{state=\"done\"}} "
        f"{done_sum:.0f} = the replicas' own")
    say(f"  17a [{card}] primed replicas over 17a's builds: specs primed at "
        f"start {primed_at_start}, nvcc_runs 0 on each; the job's replica "
        f"{ran_on[0]} found {primed['kernels']} built, nvcc_runs 0, "
        f"{primed['loads']} load(s) and no build on the job's trace "
        f"(compile_s {primed['compile_s']})")
    return {"phase_s": took, "up_s": up_s, "job_s": job_s,
            "primed": {**primed, "at_start": primed_at_start},
            "replace_s": replace_s, "drain_s": drain_s,
            "drain_log": [ln[:160] for ln in tail],
            "leftover": len(leftover), "ran_on": ran_on,
            "spawned": spawned, "replacement": replacement,
            "launches": launches[ran_on[0]]}


# phase 17: the operator's gates on the card.  17a a cold
# replica (``serve`` over an empty kernel build directory) pays the nvcc
# builds in its job, and its idle primer primes the job's specs; phase 16b's
# fleet then starts over that directory as the primed side.  17a runs in a
# thread beside phases 15 and 16a and 17b, the compile census, and 17c, the
# device chaos, both in process (``drivers/compile_census``,
# ``drivers/device_chaos --smoke``); 17d ``drivers/trace_report`` over the
# traces of phase 11's job A, phase 15's taken-over job and 17a's cold job.
# States, counts and bits only; the deadline only ends a hang.
COLD_DEADLINE_S = 300.0
COLD_SM = {"device": "cuda", "fdr": {"decoy_sample_size": 20},
           # several score groups, so the first group's annotations stream
           # before the job ends
           "parallel": {"formula_batch": 256, "checkpoint_every": 1},
           "service": {"workers": 1, "http_port": 0, "poll_interval_s": 0.05,
                       "heartbeat_interval_s": 0.2,
                       "prime": {"enabled": True, "idle_after_s": 0.5}},
           "telemetry": {"sample_interval_s": 0.5}}


def _compile_events(records: list, cached: bool) -> list:
    return [r for r in records if r.get("kind") == "event"
            and r.get("name") == "compile"
            and bool((r.get("attrs") or {}).get("cached")) == cached]


def _primed_job(admin: str, msg_id: str) -> dict:
    """A primed replica's job: its ``/debug/compile`` shows no nvcc run
    and every kernel of the recorded specs found built, and the job's trace
    holds loads of built kernels and no build."""
    from sm_distributed_tpu_torch.drivers.trace_report import summarize
    from sm_distributed_tpu_torch.service.primer import spec_kernels

    code, dbg = _http(admin, "/debug/compile")
    assert code == 200 and dbg["builds"]["nvcc_runs"] == 0, \
        (code, dbg["builds"])
    need = sorted({k for b in dbg["primer"]["buckets"]
                   for k in spec_kernels(b)})
    kernels = {k: dbg["builds"]["kernels"][k]["state"] for k in need}
    assert need and set(kernels.values()) == {"found"}, kernels
    _, trace = _http(admin, f"/jobs/{msg_id}/trace?raw=1")
    records = trace["records"]
    loads = _compile_events(records, cached=True)
    assert not _compile_events(records, cached=False), \
        "a primed job's trace holds an nvcc build"
    assert {(r["attrs"] or {}).get("site") for r in loads} == set(need), \
        (need, loads)
    acc = summarize(records)["accounting"]
    assert acc["compile_s"] == 0, acc
    return {"kernels": kernels, "loads": len(loads),
            "compile_s": acc["compile_s"],
            "first_annotation_s": acc["first_annotation_s"]}


def phase_coldstart(card: str, tmp: Path) -> dict:
    """17a: ``serve`` as a subprocess on ``cuda`` over a fresh, empty
    kernel build directory (``parallel.compile_cache_dir``), a 32x32 job
    published before it starts.  The job's trace holds an uncached
    ``compile`` event (an nvcc build) for each kernel it launched, its
    ``first_annotation`` event lands after the first build started and
    before the terminal state, a ``partial_annotations`` event carries a
    provisional count below the ion count, and ``drivers/trace_report``
    gives ``compile_s > 0``; ``/debug/compile`` counts one nvcc run a
    kernel; the idle primer then primes every recorded spec with no
    further run; the replica's launches (its ``/metrics``) are one moments
    and one packed chaos launch a score batch; its ``sm_kernel_cache_*``
    families count the directory's two libraries and their bytes, with no
    more misses than nvcc runs; SIGTERM -> exit 0.  The directory is phase
    16b's, whose replicas are the primed side."""
    import os
    import signal
    import threading

    from sm_distributed_tpu_torch.drivers.trace_report import summarize
    from sm_distributed_tpu_torch.engine.daemon import QueuePublisher
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset

    t_phase = time.perf_counter()
    base = tmp / "coldstart"
    build_dir = base / "kernel_builds"
    assert not build_dir.exists(), build_dir
    path, truth = generate_synthetic_dataset(
        base / "small", nrows=32, ncols=32, present_fraction=0.6,
        noise_peaks=50, seed=3)
    sm_json = base / "sm.json"
    sm_json.write_text(json.dumps({
        **COLD_SM, "work_dir": str(base / "work"),
        "parallel": {**COLD_SM["parallel"],
                     "compile_cache_dir": str(build_dir)},
        "storage": {"results_dir": str(base / "results")}}))
    queue = base / "q"
    QueuePublisher(queue).publish({
        "ds_id": "cold", "msg_id": "cold", "input_path": str(path),
        "formulas": truth.formulas[:10]})
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env.pop("SM_FAILPOINTS", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "sm_distributed_tpu_torch.engine.cli",
         "serve", str(queue), "--sm-config", str(sm_json)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(ROOT))
    lines: list[str] = []
    found = threading.Event()

    def read():
        for line in proc.stderr:
            lines.append(line)
            if "admin API on http://" in line:
                found.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.time() + COLD_DEADLINE_S
    try:
        assert found.wait(COLD_DEADLINE_S), \
            "17a: serve: no admin API line\n" + "".join(lines[-40:])
        url = re.search(r"admin API on (http://[\d.]+:\d+)",
                        "".join(lines)).group(1)
        up_s = time.perf_counter() - t0
        row = _wait_jobs(url, ["cold"], COLD_DEADLINE_S)["cold"]
        job_s = time.perf_counter() - t0 - up_s
        assert row["state"] == "done", row
        _, trace = _http(url, "/jobs/cold/trace?raw=1")
        records = trace["records"]

        def primed() -> bool:
            prim = _http(url, "/debug/compile")[1]["primer"]
            return prim["known"] >= 1 and prim["primed"] == prim["known"]

        _wait_state("17a: the idle primer primed the cold job's specs",
                    primed, deadline)
        # the kernel-cache gauges: the monitor samples every 0.5 s, so the
        # last sample may predate the builds; wait for it (a hang only)
        libs = sorted(build_dir.glob("lib*.so"))
        lib_bytes = sum(f.stat().st_size for f in libs)

        def cache_sampled() -> bool:
            text = _http(url, "/metrics")[1]
            return (_metric(text, "sm_kernel_cache_entries") == len(libs)
                    and _metric(text, "sm_kernel_cache_bytes") == lib_bytes)

        _wait_state("17a: /metrics counts the build directory's libraries",
                    cache_sampled, deadline)
        _, dbg = _http(url, "/debug/compile")
        _, slo = _http(url, "/slo")
        _, text = _http(url, "/metrics")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
    assert rc == 0, f"17a: serve exited {rc} on SIGTERM\n" + \
        "".join(lines[-40:])
    trace_file = base / "cold_trace.jsonl"
    trace_file.write_text("".join(json.dumps(r) + "\n" for r in records))
    builds = _compile_events(records, cached=False)
    sites = {r["attrs"]["site"]: r["attrs"]["dur_s"] for r in builds}
    assert set(sites) == {"moments", "chaos"} and len(builds) == 2, builds
    firsts = [r["ts"] for r in records
              if r.get("name") == "first_annotation"]
    partials = [r.get("attrs") or {} for r in records
                if r.get("name") == "partial_annotations"]
    root = [r for r in records
            if r.get("kind") == "span" and r.get("name") == "submit"]
    assert firsts and partials and len(root) == 1, \
        (len(firsts), len(partials), len(root))
    t_build = min(r["ts"] - r["attrs"]["dur_s"] for r in builds)
    assert t_build < min(firsts) < root[0]["ts"] + root[0]["dur"], \
        (t_build, min(firsts), root[0]["ts"] + root[0]["dur"])
    pa = partials[0]
    assert pa.get("provisional") and 0 < pa["n_scored"] < pa["n_ions"], pa
    acc = summarize(records)["accounting"]
    assert acc["compile_s"] > 0 and acc["queue_wait_s"] is not None, acc
    census = dbg["builds"]
    assert census["nvcc_runs"] == 2 and all(
        census["kernels"][k]["state"] == "built" for k in sites), census
    # one library a kernel built, no other file counted as one
    assert sorted(f.name.split("-")[0] for f in libs) == \
        ["libchaos", "libmoments"], libs
    cache = {k: _metric(text, f"sm_kernel_cache_{k}")
             for k in ("entries", "bytes", "misses_total")}
    assert cache["entries"] == len(libs) and \
        cache["bytes"] == lib_bytes and \
        cache["misses_total"] <= census["nvcc_runs"], \
        (cache, len(libs), lib_bytes, census["nvcc_runs"])
    prim = dbg["primer"]
    launches = {k: int(_metric(text, f'sm_kernel_launches_total'
                                     f'{{kernel="{k}"}}'))
                for k in FLEET_KERNELS}
    n_batches = -(-pa["n_ions"] // COLD_SM["parallel"]["formula_batch"])
    want = {k: 0 for k in FLEET_KERNELS}
    want["moments"] = want["chaos"] = n_batches
    assert launches == want, (launches, want)
    fa = slo["slos"]["first_annotation"]
    took = time.perf_counter() - t_phase
    say(f"  17a [{card}]: a cold serve over an empty build directory up "
        f"after {up_s:.1f} s; its job done {job_s:.1f} s later, paying "
        f"{len(builds)} nvcc builds on its trace ({sites} s), compile_s "
        f"{acc['compile_s']:.3f} s of a {summarize(records)['total_s']:.3f} s "
        f"job, first annotation at {acc['first_annotation_s']:.3f} s "
        f"(after the first build's start, before the terminal state; /slo "
        f"first_annotation count {fa['count']}, attainment "
        f"{fa['attainment']}), partial preview {pa['n_scored']}/"
        f"{pa['n_ions']} ions; nvcc_runs {census['nvcc_runs']}; the idle "
        f"primer primed {prim['primed']}/{prim['known']} spec(s); "
        f"/metrics kernel cache: {int(cache['entries'])} libraries, "
        f"{int(cache['bytes'])} bytes (the directory's {len(libs)}, "
        f"{lib_bytes}), {int(cache['misses_total'])} misses of "
        f"{census['nvcc_runs']} nvcc runs; "
        f"launches {launches}; SIGTERM -> exit 0")
    return {"phase_s": took, "up_s": up_s, "job_s": job_s, "builds": sites,
            "compile_s": acc["compile_s"],
            "first_annotation_s": acc["first_annotation_s"],
            "slo_first_annotation": {k: fa[k] for k in
                                     ("count", "attainment")},
            "primed": f"{prim['primed']}/{prim['known']}",
            "kernel_cache": cache,
            "launches": launches, "build_dir": str(build_dir),
            "trace_file": str(trace_file)}


def _driver_run(fn, *args) -> tuple[int, str]:
    """Run a driver's ``run`` in this process; its exit code and what it
    printed (printed again here, indented)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    out = buf.getvalue()
    for line in out.splitlines():
        say("    " + line[:400])
    return rc, out


def phase_census(card: str, tmp: Path) -> dict:
    """17b: ``drivers/compile_census`` in process on the card: two 8x8 jobs
    and a 6x8 job in the same lattice bucket add no nvcc run and no spec
    key, the ``devices: 2`` step is ``skipped:devices`` on one card, every
    ``sm_compile_*`` site is a kernel of ``_build.KERNELS``; the jobs'
    launches counted."""
    from sm_distributed_tpu_torch.drivers import compile_census
    from sm_distributed_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    runs0 = _build.nvcc_runs
    reset_launches()
    rc, out = _driver_run(compile_census.run, tmp / "census", "torch_cuda",
                          "cuda")
    launches = read_launches()
    assert rc == 0, "17b: compile_census failed"
    census = json.loads(next(
        ln for ln in out.splitlines()
        if ln.startswith("compile_census: census "))[len(
            "compile_census: census "):])
    want = ("skipped:devices" if torch.cuda.device_count() < 2 else "ran")
    assert census["devices_step"] == want, census
    assert _build.nvcc_runs == runs0, "17b: the census ran nvcc"
    assert launches["moments"] >= 3 and launches["chaos"] >= 3 and \
        launches["fused_window_moments"] == launches["chaos_strips"] == \
        launches["chaos_tiles"] == 0, launches
    took = time.perf_counter() - t0
    say(f"  17b [{card}]: compile census OK in {took:.1f} s: "
        f"{len(census['spec_keys'])} spec key(s) known, 0 new and 0 nvcc "
        f"runs over the three jobs, devices: 2 {census['devices_step']}, "
        f"sm_compile_* sites {census['sites']['sm_compile_events_total']}; "
        f"launches {launches}")
    return {"phase_s": took, "devices_step": census["devices_step"],
            "sites": census["sites"], "launches": launches}


def phase_device_chaos(card: str, tmp: Path) -> dict:
    """17c: ``drivers/device_chaos --smoke`` in process on the card: a
    4-chip pool over the visible cards (one card: every lease scores on
    ``cuda:0``), chip 3 quarantined mid-job and never leased again, the
    job resumed from its checkpoint bit-equal to the golden one, chip 3
    readmitted; the three jobs' launches counted."""
    from sm_distributed_tpu_torch.drivers import device_chaos

    t0 = time.perf_counter()
    reset_launches()
    rc, out = _driver_run(device_chaos.run, tmp / "device_chaos", True,
                          "torch_cuda", "cuda")
    launches = read_launches()
    assert rc == 0, "17c: device_chaos failed"
    for needle in ("sticky chip 3 quarantined mid-job",
                   "BIT-IDENTICAL to the 4-chip golden",
                   "chip 3 READMITTED"):
        assert needle in out, needle
    assert launches["moments"] >= 1 and \
        launches["moments"] == launches["chaos"] and \
        launches["fused_window_moments"] == launches["chaos_strips"] == \
        launches["chaos_tiles"] == 0, launches
    took = time.perf_counter() - t0
    say(f"  17c [{card}]: device chaos OK in {took:.1f} s on a 4-chip pool "
        f"over {torch.cuda.device_count()} card(s); launches {launches}")
    return {"phase_s": took, "launches": launches}


# phase 18's two gates, each a subprocess on the card: its argv after
# ``python -m``, and the key of the JSON line it prints last
SWEEP_GATES = {
    "18a": (["sm_distributed_tpu_torch.drivers.load_sweep", "--smoke"],
            "load_sweep"),
    "18b": (["sm_distributed_tpu_torch.drivers.host_chaos", "--smoke"],
            "host_chaos"),
}
SWEEP_DEADLINE_S = 600


def phase_sweeps_start(tmp: Path) -> dict:
    """18a and 18b started: ``drivers/load_sweep --smoke`` (burst, deadline
    and poison through the in-process service, its jobs scored on
    ``cuda``) and ``drivers/host_chaos --smoke`` (a 4-chip pod of two hosts,
    host h1 a ``--bare`` replica SIGKILLed mid-job, the job resumed
    bit-equal on host 0's chips, h1 readmitted), each a subprocess on the
    card over the kernels phase 2 built (``build/torch_kernels``: loads,
    no nvcc run)."""
    import os
    import threading

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env.pop("SM_FAILPOINTS", None)
    started = {}
    for gate, (argv, _key) in SWEEP_GATES.items():
        work = tmp / f"phase{gate}"
        work.mkdir(parents=True)
        log = open(work / "out.log", "w")
        run = started[gate] = {
            "t0": time.perf_counter(), "log": log, "work": work,
            "proc": subprocess.Popen(
                [sys.executable, "-m", *argv, "--work", str(work / "w")],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                cwd=str(ROOT))}

        def watch(run=run) -> None:
            # the gate's own seconds end at its exit, not at the join
            run["proc"].wait()
            run["t_end"] = time.perf_counter()

        run["watcher"] = threading.Thread(target=watch, daemon=True)
        run["watcher"].start()
    return started


def phase_sweeps_join(card: str, started: dict) -> dict:
    """18a and 18b joined: each exited 0 and printed its service's
    ``sm_kernel_launches_total`` by kernel; 18a's jobs launched the
    moments and the packed chaos kernels.  A deadline only ends a hang."""
    out = {}
    try:
        deadline = time.perf_counter() + SWEEP_DEADLINE_S
        for gate, run in started.items():
            run["watcher"].join(max(0.0, deadline - time.perf_counter()))
            rc = run["proc"].wait(timeout=1)
            run["log"].close()
            text = (run["work"] / "out.log").read_text()
            key = SWEEP_GATES[gate][1]
            assert rc == 0, f"{gate}: {key} exited {rc}\n" + text[-3000:]
            line = next((ln for ln in reversed(text.splitlines())
                         if ln.startswith(f'{{"{key}"')), None)
            assert line, f"{gate}: {key} printed no JSON line\n" + \
                text[-3000:]
            summary = json.loads(line)[key]
            launches = summary["kernel_launches"]
            out[gate] = {"phase_s": round(run["t_end"] - run["t0"], 1),
                         "launches": launches,
                         **{k: v for k, v in summary.items()
                            if k != "kernel_launches"}}
            for ln in text.splitlines():
                if ln.startswith(("  ", "host_chaos: ", "load sweep")):
                    say(f"    {gate} {ln[:300]}")
    finally:
        for run in started.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait(timeout=30)
            run["log"].close()
    la = out["18a"]["launches"]
    assert la["moments"] > 0 and la["chaos"] > 0, \
        f"18a: the sweep's jobs launched no moments or chaos kernel: {la}"
    for gate, got in out.items():
        say(f"  {gate} [{card}]: {SWEEP_GATES[gate][1]} --smoke OK in "
            f"{got['phase_s']:.1f} s; launches {got['launches']}")
    return out


# phase 19: the main path on a 2x2 mesh spanning two processes of this
# script (``--pod-worker DIR``), pixel shard r in process r, so every
# formula shard's shuffle crosses them.  19a: both on cuda:0, each with
# local devices [cuda:0, cuda:0] (one card: gloo); 19b, where four cards
# are visible: each on two cards of its own (CUDA_VISIBLE_DEVICES, NCCL)
POD_SM = {"fdr": {"decoy_sample_size": 20},
          "parallel": {"pixels_axis": 2, "formulas_axis": 2}}
POD_CASES = {"19a": {"devices": ["cuda:0", "cuda:0"], "visible": None},
             "19b": {"devices": ["cuda:0", "cuda:1"],
                     "visible": ["0,1", "2,3"]}}
POD_DEADLINE_S = 600
# its depth: phase 3's first formulas whose ions fill one batch of 2048
# (with their decoys, which the FDR's seeded sampling gives them as in
# phase 3), cut from all 3 batches when a staged run of the script passed
# 1,120 s; their rows are held to phase 3's ion by ion
POD_MAX_IONS = 2048


def pod_formulas(table, formulas) -> list:
    """Phase 3's first formulas whose ions (targets and decoys, counted in
    phase 3's table) number at most ``POD_MAX_IONS``."""
    import collections

    per = collections.Counter(table.sfs)
    out, n = [], 0
    for sf in dict.fromkeys(formulas):
        n += per[sf]
        if n > POD_MAX_IONS:
            break
        out.append(sf)
    return out


def pod_worker(work: Path) -> int:
    """One process of phase 19 (``chip_smoke.py --pod-worker DIR``, with
    ``SM_COORDINATOR``, ``SM_NUM_PROCESSES`` and ``SM_PROCESS_ID`` set):
    parses phase 3b's imzML, searches ``DIR/spec.json``'s formulas with the
    warm pattern cache on its part of the 2x2 mesh (``DIR/spec.json`` names the local
    devices), the launch counts set to 0 just before the search, scores
    the search's batches once more warm (the transport's steady state, the
    same bits), and writes its rows, its annotations and its figures into
    ``DIR``."""
    import pickle

    sys.path.insert(0, str(ROOT))
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.models.msm_basic import (
        MSMBasicSearch,
        _slice_table,
    )
    from sm_distributed_tpu_torch.parallel import distributed
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    spec = json.loads((work / "spec.json").read_text())
    t0 = time.perf_counter()
    ds = SpectralDataset.from_imzml(spec["imzml"])
    parse_s = time.perf_counter() - t0
    devices = [torch.device(d) for d in spec["devices"]]
    search = MSMBasicSearch(ds, spec["formulas"], DSConfig(),
                            SMConfig.from_dict(POD_SM),
                            isocalc_cache_dir=spec["cache"], devices=devices)
    bundle, wall, launches, peak = _search_run(search)
    backend = search.last_backend
    rank = distributed.world()[0]
    assert backend.spans_processes, backend.mesh.devices
    with open(work / f"bundle_p{rank}.pkl", "wb") as f:
        pickle.dump({"annotations": bundle.annotations,
                     "all_metrics": bundle.all_metrics}, f)
    table = search.last_table
    n_ions, b = table.n_ions, backend.batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = backend.score_batches([_slice_table(table, s, min(s + b, n_ions))
                                  for s in range(0, n_ions, b)])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert np.array_equal(np.concatenate(warm).astype(np.float32),
                          _search_rows(bundle)), "warm rows differ"
    out = {"rank": rank, "parse_s": parse_s, "wall_s": wall,
           "warm_score_s": warm_s,
           "timings": bundle.timings, "launches": launches,
           "peak_bytes": peak, "collective": backend.collective,
           "cross_bytes": backend.cross_bytes,
           "cells": backend.mesh.local(), "batch": backend.batch,
           "n_ions": n_ions, "n_batches": -(-n_ions // backend.batch),
           "variant_counts": dict(backend.variant_counts)}
    (work / f"pod_p{rank}.json").write_text(json.dumps(out))
    distributed.shutdown()
    return 0


def phase_pod_start(tmp: Path, imzml: Path, cache: Path, formulas,
                    case: str) -> dict:
    """19a or 19b started: two ``--pod-worker`` processes of this script
    over a localhost rendezvous, each a subprocess on the card over the
    kernels phase 2 built (loads, no nvcc run); stopped at the latest when
    this script exits."""
    import atexit
    import os
    import socket
    import threading

    work = tmp / f"phase{case}"
    work.mkdir(parents=True)
    (work / "spec.json").write_text(json.dumps({
        "imzml": str(imzml), "cache": str(cache),
        "formulas": [str(sf) for sf in formulas],
        "devices": POD_CASES[case]["devices"]}))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    env.pop("SM_FAILPOINTS", None)
    env.update(SM_COORDINATOR=f"127.0.0.1:{port}", SM_NUM_PROCESSES="2")
    run = {"case": case, "work": work, "t0": time.perf_counter(),
           "procs": [], "logs": []}
    for rank in (0, 1):
        renv = dict(env, SM_PROCESS_ID=str(rank))
        if POD_CASES[case]["visible"]:
            renv["CUDA_VISIBLE_DEVICES"] = POD_CASES[case]["visible"][rank]
        log = open(work / f"out_p{rank}.log", "w")
        run["logs"].append(log)
        run["procs"].append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--pod-worker",
             str(work)], stdout=log, stderr=subprocess.STDOUT, env=renv,
            cwd=str(ROOT)))

    def watch() -> None:
        for proc in run["procs"]:
            proc.wait()
        run["t_end"] = time.perf_counter()

    run["watcher"] = threading.Thread(target=watch, daemon=True)
    run["watcher"].start()
    atexit.register(_stop_pod, run)
    return run


def _stop_pod(run: dict) -> None:
    for proc in run["procs"]:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    for log in run["logs"]:
        log.close()


def pod_cases() -> list[str]:
    """19a, and 19b where four cards are visible."""
    return [c for c in POD_CASES
            if c == "19a" or torch.cuda.device_count() >= 4]


def _held_by_ion(got, ref, label: str) -> None:
    """``got``'s metric rows bit-equal to ``ref``'s rows of the same ions
    (both ``all_metrics`` frames; ``got``'s ions a subset of ``ref``'s)."""
    import pandas as pd

    cols = list(CONTRACT)
    keys = pd.MultiIndex.from_frame(got[["sf", "adduct"]])
    want = ref.set_index(["sf", "adduct"]).loc[keys, cols]
    assert np.array_equal(got[cols].to_numpy().astype(np.float32),
                          want.to_numpy().astype(np.float32)), \
        f"{label}: rows differ"


def phase_pod_join(card: str, run: dict, ref, sharded=None) -> dict:
    """19a or 19b joined: both processes exited 0; their metric rows are
    bit-equal to each other and, ion by ion, to phase 3's and to phase
    14a's (``sharded``, its ``all_metrics``; ``--pod-only`` runs no phase
    14), their annotations and FDR ranks equal phase 3's when all of its
    ions were scored; each launched the moments and the packed chaos
    kernels twice a batch (its two cells) and nothing else.  A deadline
    only ends a hang."""
    import pickle
    import types

    case, work = run["case"], run["work"]
    try:
        run["watcher"].join(POD_DEADLINE_S)
        rcs = [proc.wait(timeout=1) for proc in run["procs"]]
    finally:
        _stop_pod(run)
    logs = [(work / f"out_p{r}.log").read_text() for r in (0, 1)]
    for r, rc in enumerate(rcs):
        assert rc == 0, f"{case}: process {r} exited {rc}\n" + logs[r][-3000:]
    ranks = []
    for r in (0, 1):
        got = json.loads((work / f"pod_p{r}.json").read_text())
        with open(work / f"bundle_p{r}.pkl", "rb") as f:
            got["bundle"] = types.SimpleNamespace(**pickle.load(f))
        ranks.append(got)
    assert np.array_equal(_search_rows(ranks[0]["bundle"]),
                          _search_rows(ranks[1]["bundle"])), \
        f"{case}: the two processes' rows differ"
    for r, got in enumerate(ranks):
        mine = got["bundle"].all_metrics
        _held_by_ion(mine, ref.all_metrics, f"{case} process {r} vs phase 3")
        if sharded is not None:
            _held_by_ion(mine, sharded, f"{case} process {r} vs phase 14a")
        if len(mine) == len(ref.all_metrics):
            _bit_equal(got["bundle"], ref, f"{case} process {r}")
        n, la = got["n_batches"], got["launches"]
        assert la["moments"] == la["chaos"] == 2 * n and all(
            v == 0 for k, v in la.items() if k not in ("moments", "chaos")), \
            f"{case} process {r}: moments and packed chaos must launch " \
            f"twice a batch ({n} batches) and nothing else: {la}"
        assert got["collective"] == ("gloo" if case == "19a" else "nccl"), \
            got["collective"]
    t_end = run.get("t_end", time.perf_counter())
    out = {"phase_s": t_end - run["t0"],
           "launches": [got["launches"] for got in ranks],
           "ranks": [{k: v for k, v in got.items() if k != "bundle"}
                     for got in ranks]}
    for got in ranks:
        tim = got["timings"]
        say(f"  {case} [{card}] process {got['rank']} (cells "
            f"{got['cells']}): parse {got['parse_s']:.3f} s, patterns "
            f"{tim['isotope_patterns']:.3f} s, set-up "
            f"{tim['backend_setup']:.3f} s, score {tim['score']:.3f} s "
            f"(warm again {got['warm_score_s']:.3f} s, the same bits; "
            f"{got['n_ions']} ions in {got['n_batches']} batches of "
            f"{got['batch']}); collective {got['collective']}; "
            f"{got['cross_bytes']} cross-process bytes a batch (sent and "
            f"received); device peak {got['peak_bytes'] / 2**30:.2f} GiB; "
            f"launches {got['launches']}; variants {got['variant_counts']}")
    return out


def pod_only() -> int:
    """``--pod-only``: phases 1-3 (the reference rows), the main path's
    dataset as imzML, then 19a and, where four cards are visible, 19b,
    each alone, their processes on a cold pattern cache: the four-card
    check of 19b without the rest of the script."""
    card, _dev = phase_environment()
    phase_build()
    ds, truth, search, _ds_cfg = _setup_main_path()
    main = phase_main_path(ds, truth, search)
    pod = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pod_") as tmp:
        imzml = write_imzml(ds, Path(tmp) / "main_path.imzML")
        for case in pod_cases():
            run = phase_pod_start(Path(tmp), imzml, Path(tmp) / f"cache{case}",
                                  pod_formulas(search.last_table,
                                               truth.formulas), case)
            pod[case] = phase_pod_join(card, run, main["bundle"])
            say(f"phase {case} [{card}]: {pod[case]['phase_s']:.1f} s alone")
    say(f"mesh spanning processes [{card}]: " + json.dumps(pod))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase_trace_report(card: str, traces: dict) -> dict:
    """17d: ``drivers/trace_report`` renders each trace and validates it
    with ``--json`` (and ``--by-replica``): phase 11's job A, phase 15's
    taken-over job, 17a's cold job (whose accounting must show build
    seconds)."""
    import contextlib
    import io

    from sm_distributed_tpu_torch.drivers import trace_report

    t0 = time.perf_counter()
    out = {}
    for label, path in traces.items():
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            rc_text = trace_report.main([path])
        js = io.StringIO()
        with contextlib.redirect_stdout(js):
            rc_json = trace_report.main([path, "--validate", "--json",
                                         "--by-replica"])
        assert rc_text == rc_json == 0, (label, rc_text, rc_json)
        summary = json.loads(js.getvalue())
        assert summary["state"] == "done" and summary["n_records"] > 0 and \
            "phase breakdown:" in text.getvalue(), (label, summary["state"])
        acc = summary["accounting"]
        if label == "17a cold job":
            assert acc["compile_s"] > 0, acc
        out[label] = {"records": summary["n_records"],
                      "total_s": summary["total_s"],
                      "compile_s": acc["compile_s"],
                      "replicas": sorted(summary["by_replica"]),
                      "phases": {k: v["seconds"] for k, v in
                                 summary["phases"].items()}}
        say(f"  17d [{card}] {label}: rendered and validated, "
            + json.dumps(out[label]))
    took = time.perf_counter() - t0
    return {"phase_s": took, "traces": out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", metavar="DIR", help="another checkout of the "
                        "repo whose moments, fused and chaos kernels are "
                        "timed in turns against this one's")
    parser.add_argument("--pod-worker", metavar="DIR",
                        help="run one process of phase 19 (started by the "
                        "script itself)")
    parser.add_argument("--pod-only", action="store_true",
                        help="run phases 1-3 and phase 19 alone (19b where "
                        "four cards are visible)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "sm_distributed_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the sm_distributed_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sm_distributed_tpu_torch.analysis.numerics import (
        COMPONENT_CONTRACTS,
    )

    CONTRACT.update(COMPONENT_CONTRACTS)
    if opts.pod_worker:
        return pod_worker(Path(opts.pod_worker))
    if opts.pod_only:
        return pod_only()
    t_script = time.perf_counter()
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    took = {}                       # seconds from the start, by phase

    def lap(name: str) -> None:
        took[name] = round(time.perf_counter() - t_script, 1)

    card, dev = phase_environment()
    phase_build()
    lap("build")
    ab = OtherPort(opts.ab) if opts.ab else None
    ds, truth, search, ds_cfg = _setup_main_path()
    main = phase_main_path(ds, truth, search)
    lap("main")
    census21 = phase_sync_census(card, search, main)
    lap("sync_census")
    prime_specs = _recorded_specs()       # phase 3's, for phase 16a
    _breaker_closed(0, "phase 3")
    backend = search.last_backend
    block, _theor, _n_valid = backend.image_block(
        _slice_table(search.last_table, 0, backend.batch))
    kernels = phase_kernels(dev, block, backend.n_real,
                            ds_cfg.image_generation.nlevels, ab)
    lap("kernels")
    del block
    torch.cuda.empty_cache()
    for entry in kernels:
        entry["launches"] = main["launches"][entry["name"]]
    # phase 3b's imzML and work dir serve phase 11 too
    job_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_job_")
    job = phase_job_path(ds, truth, search, main, Path(job_dir.name))
    lap("job")
    _breaker_closed(0, "phase 3b")
    for entry in kernels:
        entry["job_launches"] = job["inproc_launches"][entry["name"]]
    kernels[0]["row_group_launches"] = _ROW_GROUP_LAUNCHES[0]
    kernels[1]["level_range_launches"] = _LEVEL_RANGE_LAUNCHES["smem"]
    kernels[2]["level_range_launches"] = _LEVEL_RANGE_LAUNCHES["tiles"]
    torch.cuda.empty_cache()
    phase_golden()
    lap("golden")
    _breaker_closed(0, "phase 5")
    fused_entry, fused = phase_fused(ds, truth, search, ds_cfg, main, ab)
    fused_bundle = fused.pop("bundle")      # phase 20d's reference
    lap("fused")
    _breaker_closed(0, "phase 6")
    torch.cuda.empty_cache()
    cube = phase_cube_main(ds, truth, search, ds_cfg, main)
    lap("cube")
    _breaker_closed(0, "phase 7")
    torch.cuda.empty_cache()
    preprocessed = phase_preprocessed(ds, truth, search, main)
    lap("preprocessed")
    _breaker_closed(0, "phase 7b")
    torch.cuda.empty_cache()
    sorts: dict = {}                    # phase 10's m/z sort, for 20c-d
    resilience = phase_resilience(card, ds, truth, search, ds_cfg, main,
                                  sorts)
    lap("resilience")
    torch.cuda.empty_cache()
    t20 = time.perf_counter()
    numerics20 = phase_numerics(card)
    ooms20 = phase_ooms(card, ds, truth, search, ds_cfg, main, fused_bundle,
                        Path(job_dir.name), sorts)
    t20 = time.perf_counter() - t20
    del sorts, fused_bundle
    lap("numerics_ooms")
    torch.cuda.empty_cache()
    before_11 = _recorded_specs()
    service = phase_service(card, Path(job_dir.name), truth, main)
    lap("service")
    prime_specs.update((k, v) for k, v in _recorded_specs().items()
                       if k not in before_11)
    torch.cuda.empty_cache()
    stream = phase_read_stream(card, Path(job_dir.name), ds, truth, main)
    lap("read_stream")
    torch.cuda.empty_cache()
    sharded = phase_sharded(card, ds, truth, search, ds_cfg, main)
    lap("sharded")
    two_card = next((s for s in _recorded_specs().values()
                     if s["kind"] == "sharded"
                     and s["mesh_pix"] * s["mesh_form"] == 2), None)
    _breaker_closed(2, "phase 14")
    torch.cuda.empty_cache()
    # phase 19's processes run beside phases 15-18: 19a on this card, 19b
    # where four cards are visible
    t19 = time.perf_counter()
    pods = [phase_pod_start(Path(job_dir.name),
                            Path(job_dir.name) / "main_path.imzML",
                            Path(job_dir.name) / "work" / "isocalc_cache",
                            pod_formulas(search.last_table, truth.formulas),
                            case)
            for case in pod_cases()]
    # phase 17a's cold replica (a subprocess, its own spool and build
    # directory) starts its serve and pays its nvcc builds while phases
    # 15, 16a, 17b and 17c run here; 16b's fleet is its primed side
    import threading

    cold_out: dict = {}

    def cold_side() -> None:
        try:
            cold_out["result"] = phase_coldstart(card, Path(job_dir.name))
        except BaseException as exc:     # re-raised in this thread
            cold_out["error"] = exc

    cold_thread = threading.Thread(target=cold_side, name="phase-17a")
    cold_thread.start()
    # phase 18's two gates run beside it, each a subprocess of its own
    t18 = time.perf_counter()
    sweeps = phase_sweeps_start(Path(job_dir.name))
    # phase 20b's isocalc pool gate, a subprocess beside them
    pool20 = phase_isocalc_pool_start(Path(job_dir.name))
    # phase 22's bench, a subprocess beside them too
    bench22 = phase_bench_start(Path(job_dir.name))
    try:
        takeover = phase_takeover(card, Path(job_dir.name), truth, main)
        lap("takeover")
        _breaker_closed(2, "phase 15")
        primed = phase_prime(card, prime_specs, two_card)
        lap("prime")
        t17 = time.perf_counter()
        census = phase_census(card, Path(job_dir.name))
        _breaker_closed(2, "phase 17b")
        chaos17 = phase_device_chaos(card, Path(job_dir.name))
        _breaker_closed(2, "phase 17c")
    except BaseException:
        for run in [*sweeps.values(), pool20, bench22]:
            run["proc"].kill()
            run["proc"].wait(timeout=30)
        raise
    finally:
        t_join = time.perf_counter()
        cold_thread.join()
    if "error" in cold_out:
        raise cold_out["error"]
    cold = cold_out["result"]
    # what phase 17 added to the script so far: 17b, 17c and the wait for
    # 17a after them
    t17_abc = time.perf_counter() - t17
    waited_17a = time.perf_counter() - t_join
    lap("coldstart_census_chaos")
    # phase 18 adds to the script only the wait for its two gates here
    t_join18 = time.perf_counter()
    gates18 = phase_sweeps_join(card, sweeps)
    waited_18 = time.perf_counter() - t_join18
    # phases 15-18 from their start to their join: what the subprocesses
    # beside them (20b, 22) cost them shows here
    span_15_18 = time.perf_counter() - t18
    t_join20 = time.perf_counter()
    pool = phase_isocalc_pool_join(card, pool20)
    waited_20b = time.perf_counter() - t_join20
    t_join22 = time.perf_counter()
    bench = phase_bench_join(card, bench22)
    waited_22 = time.perf_counter() - t_join22
    lap("sweeps")
    say(f"phase 22 the port's bench [{card}]: {waited_22:.1f} s added to "
        f"the script (the wait for it after 20b); its own "
        f"{bench['phase_s']:.1f} s ran beside phases 15-18, which spanned "
        f"{span_15_18:.1f} s from their start to their join; "
        f"{bench['value']} ions/s on the cut headline case, launches "
        "equal to the streams' batches, both roofline shares in (0, 1], "
        "the sentinel's self-check and the trace report passed")
    say(f"phase 20 the numerics contracts and two OOMs [{card}]: "
        f"{t20 + waited_20b:.1f} s added to the script (20a "
        f"{numerics20['phase_s']:.1f} s, 20c {ooms20['20c']['seconds']:.1f} "
        f"s, 20d {ooms20['20d']['seconds']:.1f} s, the wait for 20b "
        f"{waited_20b:.1f} s); 20b's own {pool['phase_s']:.1f} s ran beside "
        "phases 15-18; drift within the contracts and the H100 history, "
        "the pool's shards byte-identical in both modes, an OOM beside a "
        "resident backend backed off bit-equal with the backend still "
        "resident, "
        + ("an OOM inside the fused wrapper's allocation backed off "
           "bit-equal" if ooms20["20d"]["provoked"] else
           "20d not provoked (its figures above)"))
    say(f"phase 18 the load sweep and host chaos [{card}]: "
        f"{waited_18:.1f} s added to the script (the wait for 18a and 18b "
        f"after phase 17c); 18a's own {gates18['18a']['phase_s']:.1f} s and "
        f"18b's {gates18['18b']['phase_s']:.1f} s ran beside phases 15, "
        f"16a, 17a, 17b and 17c ({time.perf_counter() - t18:.1f} s from "
        "their start to their join)")
    # phase 19 adds to the script only the wait for its processes here
    t_join19 = time.perf_counter()
    pod = {run["case"]: phase_pod_join(card, run, main["bundle"],
                                       sharded["metrics"]) for run in pods}
    waited_19 = time.perf_counter() - t_join19
    lap("pod")
    _breaker_closed(2, "phase 19")
    if "19b" not in pod:
        say(f"  19b [{card}]: not run, {torch.cuda.device_count()} card(s) "
            "visible (it needs four: two processes of two distinct cards "
            "each, over NCCL)")
    say(f"phase 19 a mesh spanning processes [{card}]: {waited_19:.1f} s "
        "added to the script (the wait for its processes after phase 18); "
        + ", ".join(f"{c}'s own {pod[c]['phase_s']:.1f} s" for c in pod)
        + f" beside phases 15-18 ({time.perf_counter() - t19:.1f} s from "
        "their start to their join); both processes' rows bit-equal to "
        "each other, to phase 3's and 14a's ion by ion")
    fleet = phase_fleet(card, Path(job_dir.name), Path(cold["build_dir"]))
    lap("fleet")
    _breaker_closed(2, "phase 16")
    say(f"phase 16 the primer and the fleet [{card}]: "
        f"{primed['phase_s'] + fleet['phase_s']:.1f} s (16a "
        f"{primed['phase_s']:.1f} s, 16b-c {fleet['phase_s']:.1f} s); the "
        "recorded specs primed with no nvcc run, two replicas up, the job "
        "bit-equal to phase 11b's, a crashed replica replaced, every drain "
        "acked")
    reports = phase_trace_report(card, {
        "11 job A": service["trace_a"],
        "15 taken-over job": takeover["trace_file"],
        "17a cold job": cold["trace_file"]})
    lap("trace_report")
    say(f"phase 17 the operator's gates [{card}]: "
        f"{t17_abc + reports['phase_s']:.1f} s added to the script (17b "
        f"{census['phase_s']:.1f} s, 17c {chaos17['phase_s']:.1f} s, the "
        f"wait for 17a after them {waited_17a:.1f} s, 17d "
        f"{reports['phase_s']:.1f} s); 17a's own {cold['phase_s']:.1f} s "
        "ran beside phases 15, 16a, 17b and 17c; the cold replica paid "
        f"{sorted(cold['builds'])} nvcc builds (compile_s "
        f"{cold['compile_s']:.3f} s), the primed replicas none; the census "
        "closed; chip 3 quarantined and readmitted, the resumed job "
        "bit-equal; three traces rendered and validated")
    job_dir.cleanup()
    say("main path: " + json.dumps({
        k: main[k] for k in ("ions_per_s", "timings", "peak_bytes", "wall_s",
                             "n_ions", "n_peaks", "drift", "recall",
                             "batch_ms", "variant_counts")}))
    # phase 13b searches the main path's dataset again
    main_ann = main["bundle"].annotations
    del search, backend, main
    torch.cuda.empty_cache()
    strips_entry, slide = phase_whole_slide(
        dev, ds_cfg.image_generation.nlevels, ab)
    lap("whole_slide")
    _breaker_closed(2, "phase 8")
    torch.cuda.empty_cache()
    ordered, oracle = phase_ordered_stream()
    lap("ordered_stream")
    _breaker_closed(2, "phase 9")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_13_") as tmp13:
        patterns13 = phase_device_patterns(card, oracle)
        del oracle
        lap("device_patterns")
        profiled = phase_profiled_search(card, ds, truth, main_ann,
                                         Path(tmp13))
        lap("profiled_search")
        torch.cuda.empty_cache()
        route = phase_profile_route(card, Path(tmp13))
        lap("profile_route")
    _breaker_closed(2, "phase 13")
    say(f"phase 13 device patterns and the profiler [{card}]: "
        f"{patterns13['phase_s'] + profiled['phase_s'] + route['phase_s']:.1f}"
        f" s; {patterns13['n_ions']} device patterns within the oracle's "
        "bounds, profiler events equal to the launch counters, "
        "/debug/profile codes as the JAX package's")
    del ds, truth
    say("job path: " + json.dumps({k: job[k] for k in (
        "runs", "inproc_wall_s", "inproc_timings", "hbm", "phase_s",
        "steps_s")}))
    say("fused path: " + json.dumps(fused))
    say("cube path, main dataset: " + json.dumps(cube))
    say("preprocessed main path: " + json.dumps(preprocessed))
    say("whole-slide path: " + json.dumps(slide))
    say("ordered stream: " + json.dumps(ordered))
    say(f"resilience and compact cubes [{card}]: " + json.dumps(
        {k: v for k, v in resilience.items() if k != "launches"}))
    say(f"service [{card}]: " + json.dumps(
        {k: v for k, v in service.items() if k != "launches"}))
    say(f"read path and stream [{card}]: " + json.dumps(
        {k: v for k, v in stream.items() if k != "launches"}))
    say(f"sharded main path [{card}]: " + json.dumps(
        {k: v for k, v in sharded.items()
         if k not in ("launches", "metrics")}))
    say(f"mesh spanning processes [{card}]: " + json.dumps(
        {c: {k: v for k, v in got.items() if k != "launches"}
         for c, got in pod.items()}))
    say(f"replica takeover [{card}]: " + json.dumps(
        {k: v for k, v in takeover.items() if k != "launches"}))
    say(f"primer and fleet [{card}]: " + json.dumps(
        {"16a": {k: v for k, v in primed.items() if k != "census"},
         "16b": fleet}))
    say(f"operator's gates [{card}]: " + json.dumps(
        {"17a": {k: v for k, v in cold.items()
                 if k not in ("trace_file", "build_dir")},
         "17b": census, "17c": chaos17, "17d": reports}))
    say(f"load sweep and host chaos [{card}]: " + json.dumps(gates18))
    say(f"numerics contracts and two OOMs [{card}]: " + json.dumps(
        {"20a": {k: v for k, v in numerics20.items() if k != "launches"},
         "20b": pool, "20c": ooms20["20c"], "20d": ooms20["20d"]}))
    say(f"sync census of the main path [{card}]: " + json.dumps(census21))
    say(f"the port's bench [{card}]: " + json.dumps(bench))
    say(f"device patterns and the profiler [{card}]: " + json.dumps(
        {"13a": patterns13, "13b": {k: v for k, v in profiled.items()
                                    if k != "attribution"},
         "13c": route}))
    # the moments kernel's error: the largest over phase 4's blocks and the
    # whole-slide block of phase 8
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    slide["moments_max_abs_err"])
    fused_entry["row_group_launches"] = _ROW_GROUP_LAUNCHES[1]
    kernels = kernels[:3] + [strips_entry, fused_entry]
    for entry in kernels:
        entry["ordered_launches"] = ordered["runs"]["auto"]["launches"][
            entry["name"]]
        entry["resilience_launches"] = {
            path: counts[entry["name"]]
            for path, counts in resilience["launches"].items()}
        entry["service_launches"] = {
            job: counts[entry["name"]]
            for job, counts in service["launches"].items()}
        entry["stream_launches"] = stream["launches"][entry["name"]]
        entry["profile_launches"] = profiled["events"][entry["name"]]
        entry["sharded_launches"] = sharded["launches"][entry["name"]]
        entry["takeover_launches"] = takeover["launches"][entry["name"]]
        entry["prime_launches"] = primed["launches"][entry["name"]]
        entry["fleet_launches"] = fleet["launches"][entry["name"]]
        entry["coldstart_launches"] = cold["launches"][entry["name"]]
        entry["census_launches"] = census["launches"][entry["name"]]
        entry["device_chaos_launches"] = chaos17["launches"][entry["name"]]
        entry["load_sweep_launches"] = gates18["18a"]["launches"][
            entry["name"]]
        entry["host_chaos_launches"] = gates18["18b"]["launches"][
            entry["name"]]
        entry["pod_launches"] = {
            case: [by_rank[entry["name"]] for by_rank in got["launches"]]
            for case, got in pod.items()}
        entry["numerics_launches"] = numerics20["launches"][entry["name"]]
        entry["oom_launches"] = {
            case: None if counts is None else counts[entry["name"]]
            for case, counts in ooms20["launches"].items()}
    _breaker_closed(2, "the script")
    say(f"  [{card}] 10.4 no host fallback: after every phase the device "
        "breaker was closed, the two refused jobs are step 10.3's, and no "
        "search moved device work to the host (the port has no such path)")
    say(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all; "
        f"seconds from the start at the end of each phase {took}")
    say("ordered stream variants (phase 9, auto): "
        + json.dumps(ordered["variant_counts"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
