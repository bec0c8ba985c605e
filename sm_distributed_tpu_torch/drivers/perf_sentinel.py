"""History banding for committed artifacts: the parts of the JAX package's
``scripts/perf_sentinel.py`` that ``drivers/ulp_sentinel.py`` reads.

- ``load_artifact``: one JSON artifact (a bare object, or a driver's
  ``{"parsed": {...}}`` wrapper);
- ``normalize``: the artifact flattened into ``{metric: (value,
  direction)}``; the numerics artifact's drift by component (plain and
  fused bf16) and its FDR rank mismatches, all "down" (rising regresses);
- ``compare``: each fresh metric against the median of its history
  values, a regression past ``median * (1 + tolerance)``;
- ``run_check``: the printed verdict, exit-code style: 0 clean, 1
  regression(s), 2 nothing comparable.

The benchmark artifacts' branches of ``normalize`` and the sentinel's own
command line come with the port's benchmark.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from statistics import median


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


def normalize(data: dict) -> dict[str, tuple[float, str]]:
    """Flatten a numerics artifact into ``{metric: (value, direction)}``;
    any other artifact gives no metric, so comparing it yields nothing
    comparable (exit 2), never a silent pass."""
    out: dict[str, tuple[float, str]] = {}
    if "sm_numerics_max_ulp" in data:
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
