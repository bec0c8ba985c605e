"""smlint for the port — project-invariant static analysis of
``sm_distributed_tpu_torch`` (the CLI of ``scripts/smlint.py``, with the
port's rules, tree and baseline).

Runs the port's rule set (``analysis/rules.py``: the JAX package's seven
service rules, and its six hot-path rules retargeted to torch and the
kernel builds) over the package, ``chip_smoke.py`` and the port's tests,
and exits nonzero on any NEW finding — one not covered by the committed
suppression baseline (``conf/smlint_torch_baseline.json``) or an inline
``# smlint: ignore[rule]``.  Test files are linted for ``broad-except``
and parse errors only.

    python -m sm_distributed_tpu_torch.drivers.smlint            # the default tree
    python -m sm_distributed_tpu_torch.drivers.smlint PATH ...   # files/dirs
    python -m sm_distributed_tpu_torch.drivers.smlint --json     # machine-readable
    python -m sm_distributed_tpu_torch.drivers.smlint --self-check
    python -m sm_distributed_tpu_torch.drivers.smlint --write-baseline
    python -m sm_distributed_tpu_torch.drivers.smlint --list-rules

``--self-check`` re-proves that the baseline is minimal (every entry
matches a finding) and that every rule's firing fixture fires and its
passing fixture stays clean.  The ``--json`` report carries per-rule
totals (``sm_analysis_findings_total``, baseline-suppressed findings
included), the kernel build surface's census and the numerics contracts'
count.  Needs no device: the lint is pure ``ast``.

Exit codes: 0 clean, 1 new findings (or self-check failure), 2 usage/IO.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..analysis import rules as _rules  # noqa: F401 — registers the rules
from ..analysis.core import (
    RULES,
    Project,
    load_baseline,
    run_lint,
    self_check,
)
from ..analysis.rules import kernel_surface_census, numerics_census

REPO_ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "sm_distributed_tpu_torch"
DEFAULT_PATHS = (PACKAGE, "chip_smoke.py", "tests/test_torch_*.py")
DEFAULT_BASELINE = "conf/smlint_torch_baseline.json"

# the port's tests ride the default tree for EXCEPTION HYGIENE only: a
# test helper that silently swallows is how an assert rots into a no-op,
# but the project-invariant rules are about the engine's modules
_TESTS_RULES = {"broad-except", "parse-error"}


def _scope_tests(result):
    """Drop findings in tests/ for every rule outside _TESTS_RULES."""
    def keep(f):
        return not f.path.startswith("tests/") or f.rule in _TESTS_RULES

    result.findings = [f for f in result.findings if keep(f)]
    result.new = [f for f in result.new if keep(f)]
    result.suppressed = [f for f in result.suppressed if keep(f)]
    return result


def _write_baseline(path: Path, result) -> None:
    entries = []
    seen = set()
    for f in result.findings:
        if f.key() in seen:
            continue
        seen.add(f.key())
        entries.append({
            "rule": f.rule, "path": f.path, "anchor": f.anchor,
            "justification": "TODO: justify or fix "
                             f"({f.message[:80]})",
        })
    path.write_text(json.dumps({
        "__doc__": "smlint suppression baseline of the port (drivers/"
                   "smlint.py). Every entry matches findings by (rule, "
                   "path, anchor) and MUST carry a real justification; "
                   "--self-check fails on entries matching zero findings.",
        "suppressions": entries,
    }, indent=2) + "\n")
    print(f"smlint: wrote {len(entries)} suppression(s) to {path}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*", default=[],
                    help=f"files/dirs to lint (default: {DEFAULT_PATHS})")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE)
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--json", action="store_true", dest="as_json")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset to run")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--self-check", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in RULES.values():
            print(f"{r.name:<22} {r.severity:<8} {r.doc.splitlines()[0]}")
        return 0

    try:
        baseline = [] if args.no_baseline else load_baseline(
            REPO_ROOT / args.baseline)
    except (OSError, ValueError) as exc:
        print(f"smlint: bad baseline {args.baseline}: {exc}", file=sys.stderr)
        return 2

    paths = list(args.paths) or list(DEFAULT_PATHS)
    project = Project.load(REPO_ROOT, paths, package=PACKAGE)
    only = set(args.rules.split(",")) if args.rules else None
    unknown = (only or set()) - set(RULES)
    if unknown:
        print(f"smlint: unknown rule(s) {sorted(unknown)}", file=sys.stderr)
        return 2
    result = _scope_tests(run_lint(project, baseline, only=only))

    if args.write_baseline:
        _write_baseline(REPO_ROOT / args.baseline, result)
        return 0

    errs = self_check(project, baseline) if args.self_check else []

    if args.as_json:
        surface = kernel_surface_census(project)
        ncensus = numerics_census(project)
        all_counts = result.counts("all")
        nviol = sum(all_counts.get(r, 0) for r in
                    ("dtype-flow", "masked-reduction", "ulp-contract"))
        print(json.dumps({
            "paths": paths,
            "files": len(project.modules),
            "new": [f.to_dict() for f in result.new],
            "suppressed": [f.to_dict() for f in result.suppressed],
            "self_check_errors": errs,
            "sm_analysis_findings_total": all_counts,
            "sm_analysis_new_findings_total": result.counts("new"),
            "sm_kernel_surface_sites_total": surface["sites"],
            "sm_kernel_surface_entries_total": surface["entries"],
            "sm_kernel_surface_modules_total": surface["modules"],
            "sm_numerics_contracts_total": ncensus["contracts"],
            "sm_numerics_modules_total": ncensus["modules"],
            "sm_numerics_violations_total": nviol,
        }, indent=2))
    else:
        for f in result.new:
            print(f.render())
        for e in errs:
            print(f"self-check: {e}", file=sys.stderr)
        sup = f", {len(result.suppressed)} baseline-suppressed" \
            if result.suppressed else ""
        counts = ", ".join(f"{k}={v}" for k, v in
                           result.counts("all").items()) or "none"
        print(f"smlint: {'FAIL' if result.new or errs else 'OK'} — "
              f"{len(result.new)} new finding(s){sup} across "
              f"{len(project.modules)} file(s) [{counts}]")
    return 1 if (result.new or errs) else 0


if __name__ == "__main__":
    sys.exit(main())
