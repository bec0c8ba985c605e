"""Perf-regression sentinel over the port's committed bench history — the
port of the JAX package's ``scripts/perf_sentinel.py``.

- **history** = the committed ``BENCH_H100_r*.json`` artifacts (a bare
  ``drivers/bench.py`` JSON line or a driver's ``{"parsed": {...}}``
  wrapper), written on the card.  It never globs the JAX package's
  ``BENCH_r*.json`` (TPU and CPU history): H100 figures stay out of those
  bands, and theirs out of these.  ``--history`` names any other set, a
  ``drivers/trace_report.py --json`` summary's included;
- **fresh** = one new artifact of the same kind;
- ``normalize`` flattens an artifact into ``{metric: (value,
  direction)}``: a bench line's cases (headline, ``scale``, ``desi``,
  ``multichip``) by the JAX script's rate and time keys and every phase
  (the port's renamed warm-up split, ``compile_nvcc_s``,
  ``compile_load_s``, ``warmup_exec_s``, rides the phases); a trace
  summary's total, phases and accounting; a smlint ``--json`` census (the
  JAX package's compile-surface keys and the port's kernel-surface ones);
  a numerics artifact's drift by component and its FDR rank mismatches;
- ``compare``: each fresh metric against the median of its history
  values: rates regress below ``median * (1 - tolerance)``, times above
  ``median * (1 + tolerance)``; medians of a time below ``--min-seconds``
  and metrics with fewer than ``--min-history`` samples are skipped;
- exit codes: 0 clean, 1 regression(s), 2 nothing comparable (a
  misconfigured gate must not pass silently).

``--self-check`` replays the newest history artifact as an honest fresh
run (must pass) and a copy degraded by twice the tolerance (must fail).
``drivers/ulp_sentinel.py`` bands its numerics artifacts through
``run_check``.

Usage::

    python -m sm_distributed_tpu_torch.drivers.perf_sentinel --fresh out.json
    python -m sm_distributed_tpu_torch.drivers.perf_sentinel \\
        --history 'runs/*.json' --fresh out.json
    python -m sm_distributed_tpu_torch.drivers.perf_sentinel --self-check
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from pathlib import Path
from statistics import median

REPO_ROOT = Path(__file__).resolve().parents[2]
# the port's bench history: the card's own namespace
DEFAULT_HISTORY = "BENCH_H100_r*.json"

# bench-case keys, the JAX sentinel's: "up" = higher is better (regression
# when the fresh value drops), "down" = lower is better
_BENCH_RATE_KEYS = ("value", "patterns_per_s", "pixels_per_s",
                    "numpy_floor_ions_per_s",
                    # the multichip section: the N-card rate ("value"), the
                    # same-run 1-card reference and the scaling ratio
                    "single_chip_ions_per_s", "speedup_vs_single_chip",
                    # the read plane's mixed cold/warm query rate
                    "reads_per_s",
                    # the roofline share, wall-clock and profiled, and the
                    # scoring kernels' share of device time
                    "roofline_frac", "measured_roofline_frac",
                    "kernel_time_frac")
_BENCH_TIME_KEYS = ("compile_s", "isocalc_s", "isocalc_cold_s",
                    "single_chip_compile_s",
                    # the cold start in a fresh process
                    "cold_compile_s", "first_annotation_cold_s",
                    "read_p50_ms",
                    # the resident cube's device bytes (well past
                    # --min-seconds): growing back toward f32 regresses
                    "resident_cube_bytes")
# nested bench cases ("multichip" on --devices N runs)
_CASE_KEYS = ("scale", "desi", "multichip")
# smlint --json drift series: the JAX linter's compile surface and the
# port's kernel surface, and the numerics-contract census
_ANALYSIS_KEYS = ("sm_compile_surface_sites_total",
                  "sm_compile_surface_entries_total",
                  "sm_compile_surface_modules_total",
                  "sm_kernel_surface_sites_total",
                  "sm_kernel_surface_entries_total",
                  "sm_kernel_surface_modules_total",
                  "sm_numerics_contracts_total",
                  "sm_numerics_violations_total")


def load_artifact(path: str | Path) -> dict:
    """One JSON artifact, bare or driver-wrapped."""
    data = json.loads(Path(path).read_text())
    if isinstance(data, dict) and isinstance(data.get("parsed"), dict):
        data = data["parsed"]
    if not isinstance(data, dict):
        raise ValueError(f"{path}: artifact is not a JSON object")
    return data


def _num(v) -> float | None:
    return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) \
        else None


def _norm_bench_case(prefix: str, case: dict, out: dict) -> None:
    for k in _BENCH_RATE_KEYS:
        if (v := _num(case.get(k))) is not None:
            out[f"{prefix}.{k}"] = (v, "up")
    for k in _BENCH_TIME_KEYS:
        if (v := _num(case.get(k))) is not None:
            out[f"{prefix}.{k}"] = (v, "down")
    for phase, v in (case.get("phases") or {}).items():
        if (v := _num(v)) is not None:
            out[f"{prefix}.phases.{phase}"] = (v, "down")


def normalize(data: dict) -> dict[str, tuple[float, str]]:
    """Flatten an artifact into ``{metric: (value, direction)}``.  The
    artifact kinds give disjoint namespaces (``headline.*``/``scale.*``,
    ``trace.*``, ``analysis.*``, ``numerics.*``), so comparing mismatched
    kinds yields nothing comparable — exit 2, never a silent pass."""
    out: dict[str, tuple[float, str]] = {}
    if "value" in data and "metric" in data:          # a bench line
        _norm_bench_case("headline", data, out)
        for case in _CASE_KEYS:
            if isinstance(data.get(case), dict):
                _norm_bench_case(case, data[case], out)
    elif "total_s" in data or "accounting" in data:   # trace_report --json
        if (v := _num(data.get("total_s"))) is not None:
            out["trace.total_s"] = (v, "down")
        for phase, entry in (data.get("phases") or {}).items():
            if isinstance(entry, dict) and \
                    (v := _num(entry.get("seconds"))) is not None:
                out[f"trace.phases.{phase}"] = (v, "down")
        for k, v in (data.get("accounting") or {}).items():
            if (v := _num(v)) is not None:
                out[f"trace.accounting.{k}"] = (v, "down")
    elif "sm_analysis_findings_total" in data:        # smlint --json
        # rising totals regress: a growing suppressed count, a quietly
        # widening launch surface or contract census
        for rule, v in (data.get("sm_analysis_findings_total") or {}).items():
            if (v := _num(v)) is not None:
                out[f"analysis.findings.{rule}"] = (v, "down")
        for key in _ANALYSIS_KEYS:
            if (v := _num(data.get(key))) is not None:
                out[f"analysis.{key[len('sm_'):]}"] = (v, "down")
    elif "sm_numerics_max_ulp" in data:               # ulp_sentinel
        # drift against the numpy oracle by component: rising regresses
        for comp, v in (data.get("sm_numerics_max_ulp") or {}).items():
            if (v := _num(v)) is not None:
                out[f"numerics.max_ulp.{comp}"] = (v, "down")
        if (v := _num(data.get("fdr_rank_mismatches"))) is not None:
            out["numerics.fdr_rank_mismatches"] = (v, "down")
        for comp, v in (data.get("sm_numerics_max_ulp_fused") or {}).items():
            if (v := _num(v)) is not None:
                out[f"numerics.max_ulp_fused.{comp}"] = (v, "down")
        if (v := _num(data.get("fdr_rank_mismatches_fused"))) is not None:
            out["numerics.fdr_rank_mismatches_fused"] = (v, "down")
    return out


def compare(history: list[dict[str, tuple[float, str]]],
            fresh: dict[str, tuple[float, str]],
            tolerance: float, min_history: int,
            min_seconds: float) -> tuple[list[dict], int]:
    """(findings, n_compared).  A finding is a regression row; metrics are
    compared only where the fresh artifact AND >= min_history history
    entries carry them."""
    findings = []
    n_compared = 0
    for name, (value, direction) in sorted(fresh.items()):
        past = [h[name][0] for h in history if name in h]
        if len(past) < min_history:
            continue
        med = median(past)
        if direction == "down" and med < min_seconds:
            continue
        n_compared += 1
        if direction == "up":
            bound = med * (1.0 - tolerance)
            bad = value < bound
        else:
            bound = med * (1.0 + tolerance)
            bad = value > bound
        if bad:
            findings.append({
                "metric": name, "value": round(value, 4),
                "median": round(med, 4), "bound": round(bound, 4),
                "direction": direction, "n_history": len(past),
            })
    return findings, n_compared


def run_check(history_paths: list[str], fresh_norm: dict, tolerance: float,
              min_history: int, min_seconds: float,
              label: str, as_json: bool = False) -> int:
    """Band ``fresh_norm`` against the artifacts at ``history_paths`` and
    print the verdict: 0 clean, 1 regression(s), 2 nothing comparable."""
    history = []
    for p in history_paths:
        try:
            history.append(normalize(load_artifact(p)))
        except (OSError, ValueError) as exc:
            print(f"perf_sentinel: skipping unreadable history {p}: {exc}",
                  file=sys.stderr)
    findings, n_compared = compare(history, fresh_norm, tolerance,
                                   min_history, min_seconds)
    if as_json:
        print(json.dumps({"label": label, "compared": n_compared,
                          "history_files": len(history),
                          "tolerance": tolerance,
                          "regressions": findings}, indent=2))
    if n_compared == 0:
        print(f"perf_sentinel: {label}: NOTHING COMPARABLE — "
              f"{len(history)} history artifact(s), 0 shared metrics "
              f"with >= {min_history} samples", file=sys.stderr)
        return 2
    if findings:
        print(f"perf_sentinel: {label}: {len(findings)} regression(s) over "
              f"{n_compared} compared metric(s):", file=sys.stderr)
        for f in findings:
            arrow = "<" if f["direction"] == "up" else ">"
            print(f"  {f['metric']}: {f['value']} {arrow} bound "
                  f"{f['bound']} (median {f['median']} of "
                  f"{f['n_history']}, tol {tolerance:.0%})", file=sys.stderr)
        return 1
    print(f"perf_sentinel: {label}: OK — {n_compared} metric(s) within "
          f"±{tolerance:.0%} of the history median")
    return 0


def degrade(norm: dict[str, tuple[float, str]],
            tolerance: float) -> dict[str, tuple[float, str]]:
    """Every metric regressed by twice the tolerance: the self-check
    artifact that MUST trip the sentinel."""
    out = {}
    for name, (value, direction) in norm.items():
        factor = (1.0 - 2.0 * tolerance) if direction == "up" \
            else (1.0 + 2.0 * tolerance)
        out[name] = (max(0.0, value * factor), direction)
    return out


def self_check(history_paths: list[str], tolerance: float, min_history: int,
               min_seconds: float) -> int:
    """Prove the gate both passes an honest run and fires on a
    regression."""
    if not history_paths:
        print("perf_sentinel: self-check: no history artifacts found",
              file=sys.stderr)
        return 2
    honest = normalize(load_artifact(history_paths[-1]))
    rc = run_check(history_paths, honest, tolerance, min_history,
                   min_seconds, "self-check honest (latest history replay)")
    if rc != 0:
        print("perf_sentinel: self-check FAILED — the newest committed "
              "artifact does not pass against its own history",
              file=sys.stderr)
        return 1
    rc_bad = run_check(history_paths, degrade(honest, tolerance), tolerance,
                       min_history, min_seconds,
                       "self-check degraded (synthetic regression)")
    if rc_bad != 1:
        print("perf_sentinel: self-check FAILED — a synthetic "
              f"2x-tolerance regression did not trip the sentinel "
              f"(rc={rc_bad})", file=sys.stderr)
        return 1
    print("perf_sentinel: self-check OK — honest history passes, synthetic "
          "regression fires")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--history", default=None,
                    help="glob of history artifacts (default: the repo's "
                         f"committed {DEFAULT_HISTORY})")
    ap.add_argument("--fresh", default=None,
                    help="the fresh drivers/bench.py or trace_report --json "
                         "artifact to judge")
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="allowed fractional drift off the history median "
                         "(default 0.25)")
    ap.add_argument("--min-history", type=int, default=2,
                    help="history samples a metric needs before it is "
                         "compared (default 2)")
    ap.add_argument("--min-seconds", type=float, default=0.05,
                    help="time metrics whose history median is below this "
                         "are timer noise and skipped (default 0.05)")
    ap.add_argument("--json", action="store_true",
                    help="also print a machine-readable comparison")
    ap.add_argument("--self-check", action="store_true",
                    help="replay the newest history artifact (must pass) "
                         "and a synthetically degraded copy (must fail)")
    args = ap.parse_args(argv)

    pattern = args.history or str(REPO_ROOT / DEFAULT_HISTORY)
    history_paths = sorted(glob.glob(pattern))
    if args.self_check:
        if args.fresh:
            ap.error("--self-check takes no --fresh artifact")
        return self_check(history_paths, args.tolerance, args.min_history,
                          args.min_seconds)
    if not args.fresh:
        ap.error("give --fresh ARTIFACT (or --self-check)")
    try:
        fresh = normalize(load_artifact(args.fresh))
    except (OSError, ValueError) as exc:
        print(f"perf_sentinel: cannot load fresh artifact: {exc}",
              file=sys.stderr)
        return 2
    return run_check(history_paths, fresh, args.tolerance, args.min_history,
                     args.min_seconds, f"fresh {args.fresh}",
                     as_json=args.json)


if __name__ == "__main__":
    sys.exit(main())
