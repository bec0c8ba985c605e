"""smlint for the port: its thirteen rules, its CLI and its baseline, and
the runtime sync census's bookkeeping (``analysis/synccensus.py``; the
card's census is ``chip_smoke.py`` phase 21).

- every rule fires on its firing fixture and stays clean on its passing
  one (the fixtures ``--self-check`` replays);
- the hot-path rules' particular cases: the host-sync grammar, numpy
  receivers, multi-line statements, spec-key annotations at the read,
  the kernel build surface's and the contracts' messages;
- the port's tree is clean against ``conf/smlint_torch_baseline.json``,
  whose every entry is argued and matches a finding, and the three
  findings the JAX linter made on the port stay fixed by documentation;
- the census counts by the port's innermost frame, hands other warnings
  on, and restores the debug mode and the warning state.
"""

from __future__ import annotations

import json
import threading
import warnings
from pathlib import Path

import pytest

from sm_distributed_tpu_torch.analysis import rules as rules_mod
from sm_distributed_tpu_torch.analysis import synccensus
from sm_distributed_tpu_torch.analysis.core import (
    RULES,
    Module,
    Project,
    load_baseline,
    markdown_section,
    run_lint,
)
from sm_distributed_tpu_torch.drivers import smlint

ROOT = Path(__file__).resolve().parent.parent
CARRIED = ("fence-gate", "failpoint-registry", "metrics-conventions",
           "config-drift", "guarded-by", "broad-except", "atomic-write")
RETARGETED = ("kernel-build-surface", "spec-key-hazard", "host-sync",
              "dtype-flow", "masked-reduction", "ulp-contract")
HOT = "sm_distributed_tpu_torch/ops/moments.py"


@pytest.fixture(scope="module")
def tree():
    """The port's default tree, linted once against its baseline."""
    project = Project.load(ROOT, list(smlint.DEFAULT_PATHS))
    baseline = load_baseline(ROOT / smlint.DEFAULT_BASELINE)
    return project, baseline, smlint._scope_tests(run_lint(project,
                                                           baseline))


def _msgs(name: str, modules: dict, **aux) -> list[str]:
    fixture = dict(modules)
    if aux:
        fixture["aux"] = aux
    return [f.message for f in RULES[name].run_fixture(fixture)]


# ------------------------------------------------------- per-rule fixtures
def test_the_thirteen_rules_are_registered():
    assert set(RULES) == set(CARRIED) | set(RETARGETED)


@pytest.mark.parametrize("rule_name", sorted(CARRIED + RETARGETED))
def test_rule_fires_on_its_fixture(rule_name):
    r = RULES[rule_name]
    findings = r.run_fixture(r.fixture_fail)
    assert findings, f"rule {rule_name} did not fire on its firing fixture"
    assert all(f.rule == rule_name and f.severity == r.severity
               for f in findings)


@pytest.mark.parametrize("rule_name", sorted(CARRIED + RETARGETED))
def test_rule_passes_on_its_fixture(rule_name):
    r = RULES[rule_name]
    got = r.run_fixture(r.fixture_pass)
    assert not got, [f.render() for f in got]


def test_fixture_finding_counts():
    counts = {name: len(RULES[name].run_fixture(RULES[name].fixture_fail))
              for name in RETARGETED}
    # host-sync: .item(), .to(dev), x[keep], torch.nonzero,
    # torch.cuda.synchronize(), .cpu(); spec-key: three values of the
    # builder's dict and one of the direct dict; dtype-flow: two TF32
    # switches, a dtype-less arange and an uncast f64 upload
    assert counts == {"kernel-build-surface": 5, "spec-key-hazard": 4,
                      "host-sync": 6, "dtype-flow": 4,
                      "masked-reduction": 3, "ulp-contract": 3}


# ------------------------------------------------------------- host-sync
@pytest.mark.parametrize("body, n", [
    ("    # smlint: host-sync-ok[]\n    return x.cpu()\n", 1),
    ("    return np.asarray(x).tolist()\n", 0),
    ("    return x.to(torch.float32), x.to(dev, non_blocking=True)\n", 0),
    ("    h = np.arange(4)\n    return h[h > 1].tolist()\n", 0),
    ("    m = x > 0\n    x[m] = 0.0\n    return x\n", 1),
    ("    return torch.tensor(1.0, device=x.device)\n", 1),
    ("    return torch.tensor(1.0, device='cpu'), x.to('cpu')\n", 1),
    ("    e = torch.cuda.Event()\n    return e.elapsed_time(e)\n", 1),
])
def test_host_sync_cases(body, n):
    src = "import numpy as np\nimport torch\ndef f(x, dev):\n" + body
    got = RULES["host-sync"].run_fixture({HOT: src})
    assert len(got) == n, [f.render() for f in got]
    if body.startswith("    # smlint: host-sync-ok[]"):
        assert "empty reason" in got[0].message


def test_host_sync_scoped_to_hot_modules():
    src = "def f(x):\n    return x.item()\n"
    assert RULES["host-sync"].run_fixture({HOT: src})
    assert not RULES["host-sync"].run_fixture(
        {"sm_distributed_tpu_torch/engine/storage.py": src})
    assert rules_mod.is_hot_module(HOT)
    assert not rules_mod.is_hot_module("sm_distributed_tpu_torch/ops/fdr.py")


def test_annotation_on_a_statement_covers_its_lines():
    src = ("def f(outs, n):\n"
           "    # smlint: host-sync-ok[fetched once]\n"
           "    return [o[:n].cpu()\n"
           "            for o in outs]\n"
           "def g(x):\n"
           "    y = (x +\n"
           "         x.cpu())\n"
           "    return y\n")
    mod = Module(HOT, src)
    assert [rules_mod.sync_line_annotated(mod, ln)
            for ln in range(1, 9)] == [False, True, True, True, False,
                                       False, False, False]
    got = RULES["host-sync"].run_fixture({HOT: src})
    assert [f.line for f in got] == [7]


def test_blind_spots_hold_the_census_to_the_rule(tmp_path):
    src = ("def f(x):\n"
           "    # smlint: host-sync-ok[the result]\n"
           "    a = x.cpu()\n"
           "    return a, x.cpu()\n")
    (tmp_path / "sm_distributed_tpu_torch" / "ops").mkdir(parents=True)
    (tmp_path / HOT).write_text(src)
    sites = {f"{HOT}:3": 3, f"{HOT}:4": 3,
             "sm_distributed_tpu_torch/ops/fdr.py:9": 1,
             synccensus.UNATTRIBUTED: 2}
    assert synccensus.blind_spots(sites, tmp_path) == [f"{HOT}:4"]


# ------------------------------------------------------- spec-key-hazard
def test_spec_key_annotation_at_the_read_clears_the_value():
    src = ("def build(x):\n"
           "    # smlint: spec-key-ok[rows are padded at set-up]\n"
           "    n = x.shape[0]\n"
           "    m = len(x)\n"
           "    return {'n': n, 'm': m}\n"
           "def go(x):\n"
           "    record_spec(build(x))\n")
    got = RULES["spec-key-hazard"].run_fixture(
        {"sm_distributed_tpu_torch/models/x.py": src})
    assert [f.line for f in got] == [5]
    assert not RULES["spec-key-hazard"].run_fixture(
        {"sm_distributed_tpu_torch/ops/buckets.py": src})


# -------------------------------------------------- kernel-build-surface
def test_kernel_build_surface_messages():
    r = RULES["kernel-build-surface"]
    msgs = " | ".join(f.message for f in r.run_fixture(r.fixture_fail))
    assert "not in kernels/_build.py's KERNELS" in msgs
    assert "has no csrc/momnets.cu" in msgs
    assert "'_undeclared'" in msgs and "not declared" in msgs
    assert "dead entry" in msgs
    assert "spec_kernels never returns" in msgs


def test_kernel_surface_declares_the_launch_library():
    src = ("from ..kernels import _build\n"
           "KERNEL_SURFACE = kernel_surface(__name__, {\n"
           "    '_launch': 'library=chaos; shapes=one block',\n"
           "    '_other': 'library=moments',\n"
           "})\n"
           "def _launch(x):\n"
           "    return _build.ready('moments', x.device)\n"
           "def _other(x):\n"
           "    return _build.ready('moments', x.device)\n")
    msgs = _msgs("kernel-build-surface",
                 {"sm_distributed_tpu_torch/ops/x.py": src})
    assert any("declares library='chaos'" in m for m in msgs)
    assert any("lacks the shapes= clause" in m for m in msgs)


def test_kernel_surface_census_counts_the_tree(tree):
    project, _baseline, _result = tree
    assert rules_mod.kernel_surface_census(project) == {
        "sites": 4, "entries": 4, "modules": 3}


# ------------------------------------------- dtype, masked, ulp contracts
def test_dtype_flow_tf32_checked_across_the_package():
    src = "import torch\ntorch.backends.cudnn.allow_tf32 = True\n"
    assert _msgs("dtype-flow", {"sm_distributed_tpu_torch/engine/x.py": src})
    assert not _msgs("dtype-flow", {"tests/test_x.py": src})


@pytest.mark.parametrize("line, n", [
    ("t = torch.from_numpy(np.float64(1.0) * h)", 1),
    ("t = torch.as_tensor(h.astype(np.float64), dtype=torch.float32)", 0),
    ("t = torch.from_numpy(h.astype(np.float64)).to(torch.float32)", 0),
    ("t = torch.tensor(h.astype(np.float64), dtype=torch.float64)", 1),
    ("t = torch.zeros(3, dtype=torch.float32)", 0),
    ("t = torch.full((3,), 1.0)", 1),
])
def test_dtype_flow_cases(line, n):
    src = ("import numpy as np\nimport torch\n"
           "NUMERICS = numerics_surface(__name__, {})\n"
           f"def f(h):\n    {line}\n    return t\n")
    assert len(_msgs("dtype-flow",
                     {"sm_distributed_tpu_torch/ops/x.py": src})) == n


def test_masked_reduction_helpers_clear_and_buckets_seed():
    src = ("import torch\n"
           "NUMERICS = numerics_surface(__name__, {\n"
           "    'f': 'contract=bit_exact; test=tests/t.py::test_a; "
           "padded=images',\n"
           "})\n"
           "def f(images, n_real, n):\n"
           "    m = batch_moments(images, n_real)\n"
           "    p = torch.zeros(row_bucket(n))\n"
           "    return m[0].sum(), p.sum(), torch.sum(p)\n")
    msgs = _msgs("masked-reduction", {"sm_distributed_tpu_torch/ops/x.py": src})
    assert len(msgs) == 2


def test_ulp_contract_messages_and_qualified_sites():
    r = RULES["ulp-contract"]
    msgs = " | ".join(f.message for f in r.run_fixture(r.fixture_fail))
    assert "'other' reaches a kernel launch" in msgs
    assert "does not define 'test_gone'" in msgs
    assert "'ghost' names no function" in msgs
    src = ("from .imager import extract\n"
           "NUMERICS = numerics_surface(__name__, {\n"
           "    'B.score': 'contract=bit_exact; test=tests/t.py::test_a; "
           "padded=x',\n"
           "    'extract': 'contract=bit_exact; test=tests/t.py::test_a',\n"
           "})\n"
           "class B:\n"
           "    def score(self, x):\n"
           "        return x\n")
    assert not _msgs("ulp-contract", {"sm_distributed_tpu_torch/ops/y.py": src},
                     **{"tests/t.py": "def test_a():\n    pass\n"})


# ------------------------------------------------------------ the tree
def test_tree_is_clean_against_its_baseline(tree):
    _project, baseline, result = tree
    assert not result.new, "\n".join(f.render() for f in result.new)
    assert not result.unused_suppressions, result.unused_suppressions
    assert all(len(e["justification"]) > 40 for e in baseline)
    assert all(e["path"].startswith("sm_distributed_tpu_torch/")
               for e in baseline)


def test_the_three_port_findings_stay_fixed_by_documentation(tree):
    project, _baseline, result = tree
    fixed = {("metrics-conventions", "sm_distributed_tpu_torch/models/"
              "breaker.py"),
             ("metrics-conventions", "sm_distributed_tpu_torch/service/"
              "server.py"),
             ("config-drift", "sm_distributed_tpu_torch/utils/config.py")}
    assert not [f for f in result.findings if (f.rule, f.path) in fixed]
    port = markdown_section((ROOT / "README.md").read_text(),
                            "PyTorch/CUDA port")
    for name in ("sm_breaker_refused_total", "sm_kernel_launches_total",
                 "`device`"):
        assert name in port, name
    template = json.loads(
        (ROOT / "conf" / "config_torch.json.template").read_text())
    assert template["device"] == "cuda"


def test_port_template_holds_the_port_defaults():
    import dataclasses

    from sm_distributed_tpu_torch.utils.config import SMConfig

    template = json.loads(
        (ROOT / "conf" / "config_torch.json.template").read_text())
    got = dataclasses.asdict(SMConfig.from_dict(template))
    want = dataclasses.asdict(SMConfig())
    got.pop("work_dir"), want.pop("work_dir")
    assert got == want


def test_markdown_section_skips_fenced_lines():
    text = ("# Top\n## A\none\n```bash\n# not a heading\n```\ntwo\n"
            "### A.1\nthree\n## B\nfour\n")
    assert markdown_section(text, "A").splitlines() == [
        "one", "```bash", "# not a heading", "```", "two", "### A.1",
        "three"]
    assert markdown_section(text, "C") == ""


# ----------------------------------------------------------------- the CLI
def test_cli_lists_the_thirteen_rules(capsys):
    assert smlint.main(["--list-rules"]) == 0
    listed = {ln.split()[0] for ln in capsys.readouterr().out.splitlines()}
    assert listed == set(CARRIED) | set(RETARGETED)


def test_cli_self_check_passes(capsys):
    assert smlint.main(["--self-check"]) == 0
    assert "OK" in capsys.readouterr().out


def test_cli_json_summary_and_a_failing_path(tmp_path, capsys):
    assert smlint.main(["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["sm_analysis_new_findings_total"] == {}
    assert out["self_check_errors"] == []
    assert out["sm_analysis_findings_total"]["fence-gate"] >= 1
    assert out["sm_kernel_surface_sites_total"] == 4
    assert out["sm_numerics_contracts_total"] >= 29
    assert out["files"] > 100
    assert smlint.main(["--rules", "no-such-rule"]) == 2
    bad = tmp_path / "b.json"
    bad.write_text(json.dumps({"suppressions": [{"rule": "x"}]}))
    assert smlint.main(["--baseline", str(bad)]) == 2


def test_cli_scopes_tests_to_broad_except_only():
    res = run_lint(Project(modules={
        "tests/test_torch_x.py": (
            "def f(m):\n"
            "    m.counter('badname_total', 'x').inc()\n"
            "    try:\n"
            "        g()\n"
            "    except Exception:\n"
            "        pass\n"),
    }), only={"metrics-conventions", "broad-except"})
    assert {f.rule for f in res.new} == {"metrics-conventions",
                                         "broad-except"}
    assert [f.rule for f in smlint._scope_tests(res).new] == ["broad-except"]


# ------------------------------------------------------------- the census
def _warner(path: Path):
    """A function whose code claims to live at ``path`` and warns as
    torch's sync debug mode does."""
    src = ("import warnings\n"
           "def f():\n"
           "    warnings.warn('called a synchronizing CUDA operation')\n")
    ns: dict = {}
    exec(compile(src, str(path), "exec"), ns)
    return ns["f"]


def test_census_counts_by_the_ports_frame_and_restores_state():
    modes = []
    census = synccensus.SyncCensus(set_mode=modes.append,
                                   get_mode=lambda: 0)
    inside = _warner(synccensus.PACKAGE_DIR / "ops" / "imager.py")
    outside = _warner(ROOT / "tests" / "elsewhere.py")
    show_before = warnings.showwarning
    filters_before = list(warnings.filters)
    with warnings.catch_warnings(record=True) as others:
        warnings.simplefilter("always")
        with census:
            inside()
            worker = threading.Thread(target=inside)
            worker.start()
            worker.join(timeout=30)
            outside()
            warnings.warn("an unrelated warning")
        assert [str(w.message) for w in others] == ["an unrelated warning"]
    assert not worker.is_alive()
    assert census.sites() == {"sm_distributed_tpu_torch/ops/imager.py:3": 2,
                              synccensus.UNATTRIBUTED: 1}
    assert modes == ["warn", 0]
    assert warnings.showwarning is show_before
    assert warnings.filters == filters_before


def test_census_restores_the_mode_when_the_body_raises():
    modes = []
    census = synccensus.SyncCensus(set_mode=modes.append,
                                   get_mode=lambda: "error")
    show_before = warnings.showwarning
    with pytest.raises(RuntimeError, match="boom"):
        with census:
            raise RuntimeError("boom")
    assert modes == ["warn", "error"]
    assert warnings.showwarning is show_before
