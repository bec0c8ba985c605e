"""ULP-contract numerics sentinel of the port (a copy of the JAX package's
``scripts/ulp_sentinel.py`` that drives ``sm_distributed_tpu_torch``).

The static half of the numerics gate is the ``NUMERICS`` registries the
scoring modules declare (``analysis/numerics.py``); this driver is the
measurement:

1. score the off-lattice 9x11 fixture (:data:`FIXTURE`: real row padding
   on the shape lattice, targets and sampled decoys) through the port's
   ``TorchBackend`` on the device (on the card: the masked moments kernel
   and the packed chaos kernel) AND the port's numpy oracle, and again with
   ``fused_metrics="on"`` over a bf16 resident cube (on the card: the fused
   window-moments kernel) against the plain f32 backend;
2. record the per-component max-ULP drift (chaos, spatial, spectral, msm;
   ``analysis/numerics.component_drift``) and FDR-rank agreement into a
   ``NUMERICS_H100_r*.json`` artifact;
3. gate three ways:
   - **rank identity** is hard: any difference of FDR order or levels from
     the numpy oracle, on either path, fails the run;
   - **contract ceilings**: each component's drift within
     ``COMPONENT_CONTRACTS`` (chaos 0, spatial 16, spectral 16, msm 32),
     the fused bf16 drift within ``ops/quantize.py``'s ``compact_cube``
     contract;
   - **history banding** (``drivers/perf_sentinel.py``): the drift against
     the medians of the committed ``NUMERICS_H100_r*.json`` history, so a
     change that moves spatial from 0 to 3 ULPs trips the sentinel while
     the ceiling still holds.

The history is the card's own namespace: ``NUMERICS_H100_r*.json`` at the
repo root, written on an H100 and naming the card and its power limit.  It
never bands against the JAX package's ``NUMERICS_r*.json`` (TPU and CPU
history).  A change that moves the drift on purpose (a kernel's reduction
order redesigned, say) measures on the card, commits the next
``NUMERICS_H100_rNN.json`` and says so::

    python -m sm_distributed_tpu_torch.drivers.ulp_sentinel \\
        --write NUMERICS_H100_r02.json

``--self-check`` replays the newest committed artifact (must pass) and a
copy whose every component busts its ceiling (must fail): the gate's gate.

Usage::

    python -m sm_distributed_tpu_torch.drivers.ulp_sentinel          # card
    python -m sm_distributed_tpu_torch.drivers.ulp_sentinel --device cpu
    ... --fresh art.json        # gate an artifact instead of measuring
    ... --self-check            # needs no device

Measuring runs on the card unless ``--device cpu`` is given; asking for a
card where none is visible is a usage error (exit 2).  Exit 0 clean, 1 a
violation or regression, 2 nothing comparable.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from sm_distributed_tpu_torch.drivers import perf_sentinel, require_card

REPO_ROOT = Path(__file__).resolve().parents[2]
HISTORY_GLOB = "NUMERICS_H100_r*.json"

# the committed fixture identity, the JAX script's: every parameter that
# shapes the scored arrays rides in the artifact
FIXTURE = {"nrows": 9, "ncols": 11, "present_fraction": 0.5,
           "noise_peaks": 12, "seed": 41, "n_formulas": 10,
           "decoy_sample_size": 2, "formula_batch": 8}

# the port's modules that declare numerics contracts, imported before the
# registry is counted
NUMERICS_MODULES = ("ops.metrics", "ops.score", "ops.isocalc_torch",
                    "ops.quantize", "ops.chaos", "ops.moments",
                    "parallel.sharded", "models.msm_torch", "service.primer")


def declared() -> dict[str, dict[str, str]]:
    """The port's whole registry: {module: {site: policy}}."""
    from sm_distributed_tpu_torch.analysis import numerics

    for mod in NUMERICS_MODULES:
        importlib.import_module(f"sm_distributed_tpu_torch.{mod}")
    return numerics.registered()


def _launch_counters() -> dict:
    """The counters of the kernels the sentinel's two paths launch."""
    from sm_distributed_tpu_torch.ops.chaos import chaos_count_sums
    from sm_distributed_tpu_torch.ops.moments import batch_moments
    from sm_distributed_tpu_torch.ops.score import fused_window_moments

    return {"moments": batch_moments, "chaos": chaos_count_sums,
            "fused_window_moments": fused_window_moments}


def card_facts() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    name, _, limit = smi.stdout.strip().splitlines()[0].rpartition(",")
    return {"card": name.strip(), "power_limit": limit.strip()}


def measure(workdir: str | Path | None = None, device: str = "cuda") -> dict:
    """Score the fixture on ``device`` and on the numpy oracle and return
    the NUMERICS artifact (pure measurement: gating is :func:`gate`)."""
    import numpy as np
    import pandas as pd
    import torch

    from sm_distributed_tpu_torch.analysis import numerics
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu_torch.models.msm_basic import (
        NumpyBackend,
        _slice_table,
    )
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.ops.fdr import FDR
    from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu_torch.ops.quantize import NUMERICS as _QN
    from sm_distributed_tpu_torch.utils.config import (
        DSConfig,
        IsotopeGenerationConfig,
        SMConfig,
    )

    fx = FIXTURE
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="ulp_sentinel_") as tmp:
        path, truth = generate_synthetic_dataset(
            Path(workdir or tmp) / "ds", nrows=fx["nrows"], ncols=fx["ncols"],
            formulas=None, present_fraction=fx["present_fraction"],
            noise_peaks=fx["noise_peaks"], seed=fx["seed"])
        ds = SpectralDataset.from_imzml(path)

    # a real search table: targets and sampled decoys, the population the
    # FDR ranking runs over
    formulas = truth.formulas[: fx["n_formulas"]]
    fdr = FDR(decoy_sample_size=fx["decoy_sample_size"],
              target_adducts=("+H",), seed=1)
    assignment = fdr.decoy_adduct_selection(formulas)
    pairs, flags = assignment.all_ion_tuples(formulas, ("+H",))
    calc = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H",)))
    table = calc.pattern_table(pairs, flags)

    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    batch = fx["formula_batch"]

    def backend(**parallel) -> TorchBackend:
        sm = SMConfig.from_dict({"device": str(dev), "parallel": {
            "formula_batch": batch, **parallel}})
        return TorchBackend(ds, dc, sm, device=dev)

    def score_all(b) -> np.ndarray:
        outs = b.score_batches(
            [_slice_table(table, s, min(s + batch, table.n_ions))
             for s in range(0, table.n_ions, batch)])
        return np.concatenate(outs)

    counters = _launch_counters()
    before = {k: w.launches for k, w in counters.items()}
    plain = backend()
    got = score_all(plain)                      # lattice-bucketed scoring
    want = score_all(NumpyBackend(ds, dc))      # the numpy oracle
    drift = numerics.component_drift(got, want)

    # fused kernel over the bf16-compacted resident cube: its drift from
    # the plain f32 path is data-level (the cube lost mantissa bits), so
    # it gates against quantize.compact_cube's contract, plus the same
    # hard rank identity against the numpy oracle
    cube_ulps = numerics.contract_ulps(
        numerics.parse_policy(_QN["compact_cube"])["contract"])
    got_fused = score_all(backend(fused_metrics="on", cube_dtype="bf16"))
    drift_fused = numerics.component_drift(got_fused, got)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: w.launches - before[k] for k, w in counters.items()}

    def ranks(metrics: np.ndarray):
        df = pd.DataFrame({"sf": table.sfs, "adduct": table.adducts,
                           "msm": metrics[:, 3]})
        ann = fdr.estimate_fdr(df, assignment)
        return ann.sort_values(["msm", "sf"], ascending=False)

    def rank_mismatches(r_got, r_ref) -> int:
        order = int(sum(
            a != b for a, b in zip(r_got.sf.tolist(), r_ref.sf.tolist())))
        levels_equal = bool(
            (r_got.fdr.to_numpy() == r_ref.fdr.to_numpy()).all() and
            (r_got.fdr_level.to_numpy() == r_ref.fdr_level.to_numpy()).all())
        return order if order else (0 if levels_equal else 1)

    r_np = ranks(want)
    mismatches = rank_mismatches(ranks(got), r_np)
    mismatches_fused = rank_mismatches(ranks(got_fused), r_np)

    reg = declared()
    art = {
        "kind": "numerics",
        "fixture": dict(fx),
        "backend": str(dev),
        "n_ions": int(table.n_ions),
        "lattice_rows": int(plain._nrows_b),    # the padding engaged
        "dataset_rows": int(ds.nrows),
        "sm_numerics_max_ulp": drift,
        "fdr_rank_mismatches": mismatches,
        "fdr_ranks_identical": mismatches == 0,
        "fused_metrics": "on",
        "cube_dtype": "bf16",
        "cube_contract_ulps": int(cube_ulps),
        "sm_numerics_max_ulp_fused": drift_fused,
        "fdr_rank_mismatches_fused": mismatches_fused,
        "fdr_ranks_identical_fused": mismatches_fused == 0,
        "component_contracts": dict(numerics.COMPONENT_CONTRACTS),
        "declared_contracts": sum(len(e) for e in reg.values()),
        "declared_modules": len(reg),
        "kernel_launches": launches,
    }
    if dev.type == "cuda":
        art.update(card_facts())
    return art


def gate(artifact: dict, history_paths: list[str], tolerance: float,
         min_history: int, label: str) -> int:
    """The three-way gate over one NUMERICS artifact: hard rank identity,
    declared per-component ceilings, then history banding.  0 clean, 1
    violation or regression, 2 nothing comparable."""
    from sm_distributed_tpu_torch.analysis import numerics

    rc = 0
    if artifact.get("fdr_rank_mismatches", 0) != 0 or \
            not artifact.get("fdr_ranks_identical", False):
        print(f"ulp_sentinel: {label}: FAIL — device-vs-numpy FDR ranks "
              f"diverge ({artifact.get('fdr_rank_mismatches')} "
              f"mismatch(es)); rank identity is the HARD contract",
              file=sys.stderr)
        rc = 1
    if artifact.get("fdr_rank_mismatches_fused", 0) != 0 or \
            not artifact.get("fdr_ranks_identical_fused", True):
        print(f"ulp_sentinel: {label}: FAIL — fused+compacted-vs-numpy "
              f"FDR ranks diverge "
              f"({artifact.get('fdr_rank_mismatches_fused')} mismatch(es)); "
              f"rank identity is the HARD contract", file=sys.stderr)
        rc = 1
    ceilings = {**numerics.COMPONENT_CONTRACTS,
                **artifact.get("component_contracts", {})}
    for comp, ulps in (artifact.get("sm_numerics_max_ulp") or {}).items():
        ceiling = ceilings.get(comp)
        if ceiling is not None and ulps > ceiling:
            print(f"ulp_sentinel: {label}: FAIL — {comp} drift {ulps} "
                  f"ULPs exceeds its declared contract of {ceiling}",
                  file=sys.stderr)
            rc = 1
    # the fused bf16 drift is data-level: its ceiling is the compact_cube
    # contract the artifact carries
    cube_ceiling = artifact.get("cube_contract_ulps")
    for comp, ulps in (artifact.get("sm_numerics_max_ulp_fused")
                       or {}).items():
        if cube_ceiling is not None and ulps > cube_ceiling:
            print(f"ulp_sentinel: {label}: FAIL — fused+compacted {comp} "
                  f"drift {ulps} ULPs exceeds the compact_cube contract "
                  f"of {cube_ceiling}", file=sys.stderr)
            rc = 1
    band_rc = perf_sentinel.run_check(
        history_paths, perf_sentinel.normalize(artifact), tolerance,
        min_history, 0.0, f"ulp_sentinel {label}")
    if band_rc == 2 and not history_paths:
        # a checkout with no committed history: ceilings and rank identity
        # still gate; banding starts with NUMERICS_H100_r01.json
        print("ulp_sentinel: no committed history — banding skipped "
              "(ceilings and rank identity still gated)", file=sys.stderr)
        band_rc = 0
    return rc or band_rc


def degrade(artifact: dict) -> dict:
    """A synthetically broken copy for --self-check: every component busts
    its ceiling and the rank contract breaks."""
    bad = json.loads(json.dumps(artifact))
    ulp = bad.get("sm_numerics_max_ulp") or {}
    ceilings = bad.get("component_contracts") or {}
    for comp in ulp:
        ulp[comp] = 2 * int(ceilings.get(comp, 0)) + 8
    ulp_fused = bad.get("sm_numerics_max_ulp_fused") or {}
    for comp in ulp_fused:
        ulp_fused[comp] = 2 * int(bad.get("cube_contract_ulps", 0)) + 8
    bad["fdr_rank_mismatches"] = 1
    bad["fdr_ranks_identical"] = False
    if "fdr_ranks_identical_fused" in bad:
        bad["fdr_rank_mismatches_fused"] = 1
        bad["fdr_ranks_identical_fused"] = False
    return bad


def self_check(history_paths: list[str], tolerance: float,
               min_history: int) -> int:
    """The newest committed artifact must pass its own history; a degraded
    copy must fail."""
    if not history_paths:
        print(f"ulp_sentinel: self-check: no {HISTORY_GLOB} history",
              file=sys.stderr)
        return 2
    honest = perf_sentinel.load_artifact(history_paths[-1])
    rc = gate(honest, history_paths, tolerance, min_history,
              "self-check honest (latest history replay)")
    if rc != 0:
        print("ulp_sentinel: self-check FAILED — the newest committed "
              "artifact does not pass its own gate", file=sys.stderr)
        return 1
    rc_bad = gate(degrade(honest), history_paths, tolerance, min_history,
                  "self-check degraded (synthetic contract bust)")
    if rc_bad != 1:
        print(f"ulp_sentinel: self-check FAILED — a synthetic "
              f"ceiling-busting regression did not trip the gate "
              f"(rc={rc_bad})", file=sys.stderr)
        return 1
    print("ulp_sentinel: self-check OK — honest history passes, synthetic "
          "contract bust fires")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--history", default=None,
                    help=f"glob of NUMERICS history artifacts (default: the "
                         f"repo's committed {HISTORY_GLOB})")
    ap.add_argument("--fresh", default=None,
                    help="gate an existing artifact instead of measuring")
    ap.add_argument("--write", default=None,
                    help="write the measured artifact to this path (the "
                         "committed-history workflow)")
    ap.add_argument("--tolerance", type=float, default=0.5,
                    help="banding tolerance off the history median "
                         "(default 0.5: ULP drift doubling flags)")
    ap.add_argument("--min-history", type=int, default=1)
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--self-check", action="store_true",
                    help="replay the newest history honest and degraded: "
                         "the gate's gate")
    ap.add_argument("--device", default="cuda",
                    help="torch device to measure on (default cuda; cpu "
                         "off the card)")
    args = ap.parse_args(argv)

    pattern = args.history or str(REPO_ROOT / HISTORY_GLOB)
    history_paths = sorted(glob.glob(pattern))
    if args.self_check:
        if args.fresh:
            ap.error("--self-check takes no --fresh artifact")
        return self_check(history_paths, args.tolerance, args.min_history)

    if args.fresh:
        try:
            artifact = perf_sentinel.load_artifact(args.fresh)
        except (OSError, ValueError) as exc:
            print(f"ulp_sentinel: cannot load fresh artifact: {exc}",
                  file=sys.stderr)
            return 2
    else:
        require_card(ap, args.device)
        artifact = measure(device=args.device)
    if args.as_json:
        print(json.dumps(artifact, indent=2))
    if args.write:
        Path(args.write).write_text(json.dumps(artifact, indent=2) + "\n")
        print(f"ulp_sentinel: wrote {args.write}")
    return gate(artifact, history_paths, args.tolerance, args.min_history,
                "fresh measurement" if not args.fresh else
                f"fresh {args.fresh}")


if __name__ == "__main__":
    sys.exit(main())
