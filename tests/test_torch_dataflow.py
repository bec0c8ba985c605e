"""The port's copy of the smlint framework against the JAX package's.

- the JAX package's own dataflow cases (``tests/test_dataflow.py``) run
  unchanged through the port's walker: each case's module is loaded under
  a private name and its analysis names (``dataflow``, ``TaintTracker``,
  the rules' taint predicates, ...) point at the port's;
- the seven carried rules, rooted at ``sm_distributed_tpu/`` and run over
  the JAX tree as ``scripts/smlint.py`` lints it, give exactly the JAX
  linter's findings (rule, path, line, anchor, message);
- the port's ``Module`` keeps the JAX one's walk order and scopes.
"""

from __future__ import annotations

import ast
import importlib.util
from pathlib import Path

import pytest

from sm_distributed_tpu.analysis import core as jax_core
from sm_distributed_tpu.analysis import rules as jax_rules  # noqa: F401
from sm_distributed_tpu_torch.analysis import core as port_core
from sm_distributed_tpu_torch.analysis import dataflow as port_dataflow
from sm_distributed_tpu_torch.analysis import rules as port_rules

ROOT = Path(__file__).resolve().parent.parent
CARRIED = ("fence-gate", "failpoint-registry", "metrics-conventions",
           "config-drift", "guarded-by", "broad-except", "atomic-write")
# the JAX package's dataflow cases; its rule-snapshot case lints with its
# retrace-hazard, which the port retargets, and is covered by the parity
# test below for fence-gate
JAX_CASES = (
    "test_function_nodes_excludes_nested_defs",
    "test_def_use_chains",
    "test_taint_through_single_target_locals",
    "test_sanitizer_clears_whole_expression",
    "test_dict_call_keyword_sink_taint",
    "test_structural_clearing_call_launders",
    "test_structural_tuple_unpack_taints_all_targets",
    "test_module_summaries_param_flows_through_local",
    "test_summaries_are_authoritative_in_structural_mode",
    "test_summary_keyword_argument_flow",
    "test_summary_cache_hits_and_clear",
)
NOT_CARRIED = ("test_refactored_rules_match_prerefactor_snapshot",)


def _jax_cases():
    """A private copy of tests/test_dataflow.py's module."""
    spec = importlib.util.spec_from_file_location(
        "_jax_dataflow_cases", ROOT / "tests" / "test_dataflow.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_jax_dataflow_case_is_run_here():
    cases = {n for n in vars(_jax_cases()) if n.startswith("test_")}
    assert cases == set(JAX_CASES) | set(NOT_CARRIED)


@pytest.mark.parametrize("case", JAX_CASES)
def test_jax_dataflow_case_through_the_port_walker(case, monkeypatch):
    mod = _jax_cases()
    for name in ("TaintTracker", "SummaryCache", "def_use", "function_nodes",
                 "module_summaries"):
        monkeypatch.setattr(mod, name, getattr(port_dataflow, name))
    monkeypatch.setattr(mod, "dataflow", port_dataflow)
    monkeypatch.setattr(mod, "Module", port_core.Module)
    monkeypatch.setattr(mod, "rules_mod", port_rules)
    getattr(mod, case)()


def _key(f):
    return (f.rule, f.path, f.line, f.anchor, f.message)


def test_carried_rules_rooted_at_the_jax_package_match_its_linter():
    paths = ["sm_distributed_tpu", "scripts", "bench.py", "tests"]
    want = jax_core.run_lint(jax_core.Project.load(ROOT, paths),
                             only=set(CARRIED))
    got = port_core.run_lint(
        port_core.Project.load(ROOT, paths, package="sm_distributed_tpu"),
        only=set(CARRIED))
    assert [_key(f) for f in got.findings] == \
        [_key(f) for f in want.findings]
    # the JAX tree's committed exemptions are among them
    assert {f.rule for f in got.findings} >= {"fence-gate", "atomic-write"}


@pytest.mark.parametrize("src", [
    "def outer(x):\n    def inner(y):\n        return y\n    return inner\n",
    "class C:\n    def m(self):\n        return [v for v in self.xs]\n",
    "x = 1\nasync def f():\n    async with a as b:\n        await b\n",
])
def test_module_walk_and_scopes_match_the_jax_module(src):
    jm, pm = jax_core.Module("p.py", src), port_core.Module("p.py", src)
    assert [ast.dump(n) for n in pm.nodes] == \
        [ast.dump(n) for n in ast.walk(jm.tree)]
    for jn, pn in zip(ast.walk(jm.tree), pm.nodes):
        je, pe = jm.enclosing_function(jn), pm.enclosing_function(pn)
        assert (je and je.name) == (pe and pe.name)
        assert jm.qualname(jn) == pm.qualname(pn)
