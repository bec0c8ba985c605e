"""smlint framework of the port: modules, rule registry, suppressions,
baseline — a copy of ``sm_distributed_tpu/analysis/core.py`` whose package
root is a parameter.

Design (the JAX package's docs/ANALYSIS.md describes the same framework):

- the **package root** (``Project.package``, default
  ``sm_distributed_tpu_torch``) is what the package-scoped rules treat as
  the engine's own tree; pointed at ``sm_distributed_tpu`` the carried
  rules read exactly what the JAX package's linter reads (its parity test);

- a **Project** parses every target file once (stdlib ``ast`` with parent
  links) and abstracts doc/template reads, so rules stay pure functions
  ``rule(project) -> [Finding]`` and tests can lint synthetic in-memory
  projects (each rule ships a firing fixture and a passing fixture);
- **Findings** carry a *stable anchor* — the enclosing ``Class.method``
  qualname where one exists, else the stripped source line — so the
  committed baseline survives unrelated line drift;
- **suppressions** come from two places: inline
  ``# smlint: ignore[rule-name]`` on the finding line (or the line above),
  and the committed baseline file (``conf/smlint_torch_baseline.json``), whose
  entries match on ``(rule, path, anchor)`` and MUST each carry a
  ``justification``.  ``--self-check`` fails on any suppression that
  matches zero findings (a minimal baseline is the point: dead entries are
  how baselines rot into allow-everything lists) and re-proves every
  rule's firing fixture.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

SEVERITIES = ("error", "warning")

_IGNORE_RE = re.compile(r"#\s*smlint:\s*ignore\[([a-z0-9_,\- ]+)\]")
# reasoned `-ok` annotations: `# smlint: <kind>-ok[reason]` marks a
# deliberate instance of a flagged pattern — a device->host sync, a dtype
# escape, a pad-axis reduction or a raw shape in a spec key.  The REASON is
# mandatory in every case — the annotation is an argument, not a mute
# button — and each rule treats an empty reason as a finding.
_ANNOT_RES: dict[str, re.Pattern] = {}


def _annot_re(kind: str) -> re.Pattern:
    if kind not in _ANNOT_RES:
        _ANNOT_RES[kind] = re.compile(
            r"#\s*smlint:\s*" + re.escape(kind) + r"-ok\[([^\]]*)\]")
    return _ANNOT_RES[kind]


# ------------------------------------------------------------------ findings
@dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    severity: str
    path: str                 # repo-relative, POSIX separators
    line: int
    message: str
    anchor: str = ""          # enclosing qualname (or source line) — the
                              # stable key baseline suppressions match on

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.anchor)

    def render(self) -> str:
        sev = "" if self.severity == "error" else " (warning)"
        return f"{self.path}:{self.line}: [{self.rule}]{sev} {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line,
                "message": self.message, "anchor": self.anchor}


# ------------------------------------------------------------------- modules
class Module:
    """One parsed source file: tree with parent/qualname maps precomputed."""

    def __init__(self, path: str, source: str):
        self.path = path                      # repo-relative
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: dict[ast.AST, ast.AST] = {}
        # the nearest enclosing def of each node, made in the same pass
        self._enclosing: dict[ast.AST, ast.AST | None] = {self.tree: None}
        # every node in ast.walk order, walked once for all the rules
        self.nodes: list[ast.AST] = list(ast.walk(self.tree))
        for node in self.nodes:
            inner = node if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else self._enclosing[node]
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                self._enclosing[child] = inner

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def qualname(self, node: ast.AST) -> str:
        """``Class.method`` path of the scopes enclosing ``node`` ("" at
        module level)."""
        parts: list[str] = []
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    def anchor(self, node: ast.AST) -> str:
        q = self.qualname(node)
        return q or self.line_text(getattr(node, "lineno", 0))

    def enclosing_function(self, node: ast.AST):
        return self._enclosing.get(node)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def ignored_rules(self, lineno: int) -> set[str]:
        """Inline suppressions on the line or the line above."""
        out: set[str] = set()
        for ln in (lineno, lineno - 1):
            m = _IGNORE_RE.search(self.line_text(ln))
            if m:
                out |= {r.strip() for r in m.group(1).split(",") if r.strip()}
        return out

    def annotation_reason(self, kind: str, lineno: int) -> str | None:
        """The ``# smlint: <kind>-ok[reason]`` annotation on the line or
        the line above — None when unannotated, "" when the reason is
        empty (rules treat an empty reason as a violation too)."""
        pat = _annot_re(kind)
        for ln in (lineno, lineno - 1):
            m = pat.search(self.line_text(ln))
            if m:
                return m.group(1).strip()
        return None

    def host_sync_reason(self, lineno: int) -> str | None:
        return self.annotation_reason("host-sync", lineno)


DEFAULT_PACKAGE = "sm_distributed_tpu_torch"


class Project:
    """The lint target: parsed modules + doc/template accessors.

    ``package`` is the engine's package root: the package-scoped rules
    (fence gating, atomic writes, the hot-path rules) check only the
    modules under it.  ``aux`` overrides file reads for synthetic fixture
    projects (rule tests inject their own docs/RECOVERY.md or config
    template content without touching disk)."""

    def __init__(self, root: str | Path | None = None,
                 modules: dict[str, str] | None = None,
                 aux: dict[str, str] | None = None,
                 package: str = DEFAULT_PACKAGE):
        self.root = Path(root) if root is not None else None
        self.aux = dict(aux or {})
        self.package = package
        self.modules: list[Module] = []
        self.errors: list[Finding] = []
        for path, source in (modules or {}).items():
            self._add(path, source)

    # ---------------------------------------------------------------- build
    @staticmethod
    def load(root: str | Path, paths: list[str | Path],
             package: str = DEFAULT_PACKAGE) -> "Project":
        """Parse every ``*.py`` under ``paths`` (files, directories, or
        glob patterns such as ``tests/test_torch_*.py``), relative to
        ``root``."""
        root = Path(root).resolve()
        proj = Project(root, package=package)
        seen: set[str] = set()
        for target in paths:
            if "*" in str(target):
                files = sorted(root.glob(str(target)))
            else:
                t = (root / target).resolve() if not Path(
                    target).is_absolute() else Path(target)
                files = sorted(t.rglob("*.py")) if t.is_dir() else [t]
            for f in files:
                if "__pycache__" in f.parts:
                    continue
                rel = f.relative_to(root).as_posix()
                if rel in seen:
                    continue
                seen.add(rel)
                proj._add(rel, f.read_text())
        return proj

    def _add(self, path: str, source: str) -> None:
        try:
            self.modules.append(Module(path, source))
        except SyntaxError as exc:
            self.errors.append(Finding(
                "parse-error", "error", path, exc.lineno or 0,
                f"cannot parse: {exc.msg}", anchor="parse"))

    # ------------------------------------------------------------ accessors
    def in_package(self, path: str) -> bool:
        """Is ``path`` a module of the engine's own package?"""
        return path.startswith(self.package + "/")

    def pkg(self, rel: str) -> str:
        """``rel`` under the package root (``ops/buckets.py`` ->
        ``sm_distributed_tpu_torch/ops/buckets.py``)."""
        return f"{self.package}/{rel}"

    def module(self, suffix: str) -> Module | None:
        for m in self.modules:
            if m.path.endswith(suffix):
                return m
        return None

    def read(self, rel_path: str) -> str | None:
        """Aux-file contents (docs, templates): fixture override first,
        then the real file under the project root.  ``FILE#Heading``
        reads the section of a markdown file under the ``## Heading``
        line, up to the next heading of the same level."""
        if rel_path in self.aux:
            return self.aux[rel_path]
        path, _, heading = rel_path.partition("#")
        text = self.aux.get(path)
        if text is None and self.root is not None:
            p = self.root / path
            if p.exists():
                text = p.read_text()
        if text is None or not heading:
            return text
        return markdown_section(text, heading)

    def doc_text(self, *rel_paths: str) -> str:
        return "\n".join(self.read(p) or "" for p in rel_paths)


def markdown_section(text: str, heading: str) -> str:
    """The lines of ``text`` under the ``## heading`` line (any level),
    up to the next heading of that level or higher ("" when absent).
    Lines inside fenced code blocks are never headings."""
    out: list[str] = []
    level = 0
    fenced = False
    for ln in text.splitlines():
        if ln.lstrip().startswith("```"):
            fenced = not fenced
        m = None if fenced else re.match(r"^(#+)\s+(.*?)\s*$", ln)
        if m and level and len(m.group(1)) <= level:
            break
        if level:
            out.append(ln)
        elif m and m.group(2) == heading:
            level = len(m.group(1))
    return "\n".join(out)


# --------------------------------------------------------------------- rules
@dataclass
class Rule:
    """A registered rule: pure function + severity + firing/passing
    fixtures (the fixtures double as the ``--self-check`` proof that the
    rule can actually fire)."""

    name: str
    severity: str
    doc: str
    fn: object = field(repr=False, default=None)
    # {path: source} module fixtures (+ optional "aux" dict entry routed to
    # Project.aux) that must produce >=1 finding / exactly 0 findings
    fixture_fail: dict = field(repr=False, default_factory=dict)
    fixture_pass: dict = field(repr=False, default_factory=dict)

    def run(self, project: Project) -> list[Finding]:
        out = []
        for f in self.fn(project):
            f.rule = self.name
            f.severity = self.severity
            out.append(f)
        return out

    def run_fixture(self, fixture: dict) -> list[Finding]:
        fx = dict(fixture)
        aux = fx.pop("aux", {})
        return self.run(Project(modules=fx, aux=aux))


RULES: dict[str, Rule] = {}


def rule(name: str, severity: str = "error", doc: str = "",
         fixture_fail: dict | None = None, fixture_pass: dict | None = None):
    """Register a rule.  ``fn(project) -> iterable[Finding]`` — the
    decorator stamps rule name/severity onto each finding."""
    if severity not in SEVERITIES:
        raise ValueError(f"rule {name}: bad severity {severity!r}")

    def deco(fn):
        if name in RULES:
            raise ValueError(f"duplicate rule name {name!r}")
        RULES[name] = Rule(name=name, severity=severity,
                           doc=doc or (fn.__doc__ or "").strip(), fn=fn,
                           fixture_fail=fixture_fail or {},
                           fixture_pass=fixture_pass or {})
        return fn

    return deco


# ------------------------------------------------------------------ baseline
def load_baseline(path: str | Path | None) -> list[dict]:
    """Committed suppressions: ``[{rule, path, anchor, justification}]``.
    Entries without a justification are rejected — the baseline is a list
    of *argued* exemptions, not a mute button."""
    if path is None or not Path(path).exists():
        return []
    data = json.loads(Path(path).read_text())
    entries = data.get("suppressions", []) if isinstance(data, dict) else data
    out = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict) or not all(
                isinstance(e.get(k), str) and e.get(k)
                for k in ("rule", "path", "anchor", "justification")):
            raise ValueError(
                f"baseline entry #{i} must be an object with non-empty "
                f"rule/path/anchor/justification: {e!r}")
        out.append(e)
    return out


@dataclass
class LintResult:
    findings: list[Finding]               # all, before baseline filtering
    new: list[Finding]                    # not matched by the baseline
    suppressed: list[Finding]             # matched by the baseline
    unused_suppressions: list[dict]       # baseline entries matching nothing

    def counts(self, which: str = "all") -> dict[str, int]:
        """Per-rule finding counts — the ``sm_analysis_findings_total``
        summary ``drivers/smlint.py --json`` emits."""
        src = {"all": self.findings, "new": self.new,
               "suppressed": self.suppressed}[which]
        out: dict[str, int] = {}
        for f in src:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))


def run_lint(project: Project, baseline: list[dict] | None = None,
             only: set[str] | None = None) -> LintResult:
    """Run every registered rule (importing ``rules`` registers the
    shipped set), apply inline + baseline suppressions."""
    from . import rules as _rules  # noqa: F401 — registration side effect

    findings = list(project.errors)
    for r in RULES.values():
        if only is not None and r.name not in only:
            continue
        findings.extend(r.run(project))
    # inline suppressions
    by_path = {m.path: m for m in project.modules}
    kept = []
    for f in findings:
        mod = by_path.get(f.path)
        if mod is not None and f.rule in mod.ignored_rules(f.line):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    # baseline suppressions
    baseline = baseline or []
    used = [False] * len(baseline)
    new, suppressed = [], []
    for f in kept:
        hit = None
        for i, e in enumerate(baseline):
            if (e["rule"], e["path"], e["anchor"]) == f.key():
                hit = i
                break
        if hit is None:
            new.append(f)
        else:
            used[hit] = True
            suppressed.append(f)
    unused = [e for i, e in enumerate(baseline) if not used[i]]
    return LintResult(findings=kept, new=new, suppressed=suppressed,
                      unused_suppressions=unused)


def self_check(project: Project, baseline: list[dict]) -> list[str]:
    """``--self-check``: (1) the committed baseline is minimal — every
    suppression matches >=1 current finding; (2) every rule's firing
    fixture still fires and its passing fixture stays clean — a rule that
    can no longer fire is a rule that silently stopped guarding."""
    from . import rules as _rules  # noqa: F401

    errs = []
    result = run_lint(project, baseline)
    for e in result.unused_suppressions:
        errs.append(
            f"baseline suppression matches zero findings (stale — remove "
            f"it): {e['rule']} @ {e['path']} :: {e['anchor']}")
    for r in RULES.values():
        if r.fixture_fail:
            if not r.run_fixture(r.fixture_fail):
                errs.append(f"rule {r.name}: firing fixture produced no "
                            f"findings — the rule cannot fire")
        if r.fixture_pass:
            got = r.run_fixture(r.fixture_pass)
            if got:
                errs.append(f"rule {r.name}: passing fixture produced "
                            f"findings: {[f.render() for f in got]}")
    return errs
