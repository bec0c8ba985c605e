"""The port's smlint rules: the JAX package's seven service rules carried
as they are, with the package root a parameter, and its six hot-path
rules retargeted to torch and the port's kernel builds.

Every rule is a pure function over a parsed :class:`~.core.Project` and
ships a firing + passing fixture (``--self-check`` re-proves both, so a
rule that silently stops firing is itself a lint failure).

Carried (``sm_distributed_tpu/analysis/rules.py``; pointed at the JAX
package they report exactly what its linter reports):

- ``fence-gate``        — replicated write seams dominated by a fence guard
- ``failpoint-registry``— failpoints registered, called, documented, chaos-covered
- ``metrics-conventions``— ``sm_`` prefix, one kind per name, documented
- ``config-drift``      — SMConfig knobs <-> template <-> docs, both ways
- ``guarded-by``        — declared shared attrs mutated only under their lock
- ``broad-except``      — no silent ``except Exception`` swallows
- ``atomic-write``      — spool/lease/registry writes use unique-tmp + os.replace

Retargeted to torch:

- ``kernel-build-surface``— every kernel library named, built and primed;
  every launch site declared in KERNEL_SURFACE (was ``jit-compile-surface``)
- ``spec-key-hazard``   — raw runtime shapes can't reach a bucket spec key
  unbucketed (was ``retrace-hazard``)
- ``host-sync``         — device->host syncs in hot scoring modules are annotated
- ``dtype-flow``        — default-dtype, f64 and TF32 hazards in NUMERICS modules
- ``masked-reduction``  — reductions over lattice-padded axes use the n_real helpers
- ``ulp-contract``      — every kernel-reaching scoring function declares a
  test-backed contract

The carried rules read the JAX package's docs (``docs/RECOVERY.md``,
``docs/OBSERVABILITY.md``, ``docs/SERVICE.md``) and, for the port, the
README's port section too; the port's config template is
``conf/config_torch.json.template``.  The local-variable taint walks ride
the shared forward-dataflow engine in ``dataflow.py``.
"""

from __future__ import annotations

import ast
import json
import re

from . import dataflow
from . import numerics as numerics_mod
from .core import DEFAULT_PACKAGE, Finding, Project, rule
from .dataflow import TaintTracker
from .surface import POLICY_TOKENS, policy_library

# the documents each package's carried rules read: the JAX package's own
# (parity with its linter), and for the port those plus the README's port
# section, its chaos sweep and its config template
PORT_README = "README.md#PyTorch/CUDA port"
_JAX_DOCS = {
    "recovery": ("docs/RECOVERY.md",),
    "chaos_sweep": "scripts/chaos_sweep.py",
    "metrics": ("docs/OBSERVABILITY.md", "docs/SERVICE.md"),
    "config": ("README.md",),
    "templates": {"SMConfig": "conf/config.json.template",
                  "DSConfig": "conf/ds_config.json.template"},
}
_PORT_DOCS = {
    "recovery": ("docs/RECOVERY.md", PORT_README),
    "chaos_sweep": None,                  # <package>/drivers/chaos_sweep.py
    "metrics": ("docs/OBSERVABILITY.md", "docs/SERVICE.md", PORT_README),
    "config": ("README.md",),
    "templates": {"SMConfig": "conf/config_torch.json.template",
                  "DSConfig": "conf/ds_config.json.template"},
}


def _docs(project: Project) -> dict:
    return _JAX_DOCS if project.package == "sm_distributed_tpu" \
        else _PORT_DOCS


# findings are created with rule/severity placeholders; core.Rule.run stamps
# the registered values over them
def _finding(mod, node, message: str) -> Finding:
    return Finding("", "", mod.path, getattr(node, "lineno", 0), message,
                   anchor=mod.anchor(node))


# ------------------------------------------------------------- AST helpers
def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute/name chain (``self.leases.check``), or
    "" when the expression is not a plain chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _call_name(call: ast.Call) -> str:
    """Terminal callee name: ``failpoint`` for both ``failpoint(...)`` and
    ``x.failpoint(...)``."""
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _subtree_strs(node: ast.AST) -> set[str]:
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def _self_attr(node: ast.AST) -> str | None:
    """``X`` for an expression ``self.X``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _owns_spool_state(project: Project, path: str) -> bool:
    """Is ``path`` an engine module that may own replicated spool state?
    The package's modules, but not the port's drivers/: they are its
    scripts, single-actor drivers over their own sandboxes, as the JAX
    package's scripts/ are."""
    return project.in_package(path) and \
        not path.startswith(project.pkg("drivers/"))


# =========================================================== 1. fence-gate
# the fenced write seams, anchored on their failpoint constants (a
# failpoint sits at exactly these seams, so the anchor cannot drift
# away from the write it marks)
_FENCED_FAILPOINTS = {
    "spool.complete": "spool complete (running/ -> done/)",
    "sched.retry_publish": "retry republish into pending/",
}
# terminal-spool dirs whose writes are dead-letter/quarantine seams
_TERMINAL_DIRS = ("failed", "quarantine")


def _terminal_dir_source(node: ast.AST) -> bool:
    """Taint source for the fence-gate walk: a string constant naming a
    terminal spool directory (the same subtree-string test the rule's
    original in-line walk applied to assignment RHSs)."""
    return isinstance(node, ast.Constant) and node.value in _TERMINAL_DIRS
# storage-layer commits gated at their CALL SITE (the storage module itself
# is the layer below the fence; its callers own the guard)
_GATED_CALLS = ("finish_job",)
_FENCE_GUARDS = ("fence", "_fence_ok")

_FENCE_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/service/x.py": (
        "from u import register_failpoint, failpoint\n"
        "FP_C = register_failpoint('spool.complete', 'seam')\n"
        "class S:\n"
        "    def _finish(self, claimed):\n"
        "        failpoint(FP_C, path=claimed)\n"
        "        move(claimed)\n"
        "    def _dead_letter(self, claimed):\n"
        "        (self.root / 'failed' / claimed.name).write_text('x')\n"
        "    def _commit(self):\n"
        "        self.ledger.finish_job(1)\n"
    ),
}
_FENCE_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/service/x.py": (
        "from u import register_failpoint, failpoint\n"
        "FP_C = register_failpoint('spool.complete', 'seam')\n"
        "class S:\n"
        "    def _finish(self, claimed, rec):\n"
        "        if not self._fence_ok(rec, 'complete'):\n"
        "            return\n"
        "        failpoint(FP_C, path=claimed)\n"
        "        move(claimed)\n"
        "    def _dead_letter(self, claimed, rec):\n"
        "        if not self._fence_ok(rec, 'dead_letter'):\n"
        "            return\n"
        "        dst = self.root / 'failed' / claimed.name\n"
        "        dst.write_text('x')\n"
        "    def _commit(self):\n"
        "        if self.fence is not None:\n"
        "            self.fence()\n"
        "        self.ledger.finish_job(1)\n"
    ),
}


def _fp_const_map(project: Project) -> dict[str, str]:
    """{constant name: failpoint name} from every
    ``FP_X = register_failpoint("name", ...)`` assignment."""
    out: dict[str, str] = {}
    for mod in project.modules:
        for node in mod.nodes:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    isinstance(node.value, ast.Call) and \
                    _call_name(node.value) == "register_failpoint" and \
                    node.value.args:
                name = _const_str(node.value.args[0])
                if name:
                    out[node.targets[0].id] = name
    return out


@rule("fence-gate", severity="error",
      doc="Replicated write seams (spool complete/republish, dead-letter/"
          "quarantine writes, result store, ledger commit) must be "
          "dominated by a fence guard (LeaseStore.check via _fence_ok or "
          "a JobContext/SearchJob fence call) in the same function.",
      fixture_fail=_FENCE_FIXTURE_FAIL, fixture_pass=_FENCE_FIXTURE_PASS)
def fence_gate(project: Project):
    fp_names = _fp_const_map(project)
    for mod in project.modules:
        if not _owns_spool_state(project, mod.path):
            continue                  # scripts/benches drive, they don't own
                                      # replicated spool state
        if mod.path.endswith("engine/storage.py"):
            continue                  # the layer below the gate: its callers
                                      # (SearchJob, scheduler) own the guard
        for fn in mod.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            guards: list[int] = []    # linenos of fence-guard calls
            seams: list[tuple[ast.AST, str]] = []
            # shared dataflow engine: locals assigned from
            # expressions naming a terminal dir become tainted paths
            taint = TaintTracker(source=_terminal_dir_source)
            for node in taint.walk(mod, fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = _call_name(node)
                if callee in _FENCE_GUARDS:
                    guards.append(node.lineno)
                elif callee == "check" and isinstance(node.func, ast.Attribute) \
                        and "leases" in _attr_chain(node.func):
                    guards.append(node.lineno)
                elif callee == "failpoint" and node.args and \
                        isinstance(node.args[0], ast.Name):
                    seam = _FENCED_FAILPOINTS.get(
                        fp_names.get(node.args[0].id, ""))
                    if seam:
                        seams.append((node, seam))
                elif callee == "write_text" and isinstance(node.func, ast.Attribute):
                    recv = node.func.value
                    hit = _subtree_strs(recv) & set(_TERMINAL_DIRS)
                    if not hit and isinstance(recv, ast.Name) and \
                            recv.id in taint.names:
                        hit = {"(tainted path)"}
                    if hit:
                        seams.append(
                            (node, f"terminal-spool write ({sorted(hit)[0]})"))
                elif callee == "replace" and \
                        _attr_chain(node.func) == "os.replace" and any(
                            _subtree_strs(a) & set(_TERMINAL_DIRS) or (
                                isinstance(a, ast.Name) and a.id in taint.names)
                            for a in node.args):
                    seams.append((node, "terminal-spool move"))
                elif callee in _GATED_CALLS:
                    seams.append((node, f"ledger commit ({callee})"))
                elif callee == "store" and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Attribute) and \
                        node.func.value.attr == "store":
                    seams.append((node, "result store (store.store)"))
            for node, what in seams:
                if not any(g <= node.lineno for g in guards):
                    yield _finding(
                        mod, node,
                        f"{what} is not dominated by a fence guard "
                        f"(_fence_ok / fence() / leases.check) in "
                        f"{mod.qualname(node) or 'module scope'}")


# ==================================================== 2. failpoint-registry
_FPREG_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/x.py": (
        "from u import register_failpoint, failpoint\n"
        "FP_A = register_failpoint('seam.a', 'covered')\n"
        "FP_DEAD = register_failpoint('seam.dead', 'never called')\n"
        "def f(p):\n"
        "    failpoint(FP_A, path=p)\n"
        "    failpoint(FP_GHOST)\n"
    ),
    "aux": {"docs/RECOVERY.md": "only `seam.a` is documented here\n",
            "sm_distributed_tpu_torch/drivers/chaos_sweep.py":
                "SCENARIOS = []\n"},
}
_FPREG_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/x.py": (
        "from u import register_failpoint, failpoint\n"
        "FP_A = register_failpoint('seam.a', 'covered')\n"
        "def f(p):\n"
        "    failpoint(FP_A, path=p)\n"
    ),
    "aux": {"docs/RECOVERY.md": "`seam.a` does X\n",
            "sm_distributed_tpu_torch/drivers/chaos_sweep.py":
                "Scenario('seam.a', ...)\n"},
}


@rule("failpoint-registry", severity="error",
      doc="Every registered failpoint must have >=1 call site (no dead "
          "entries), be documented in docs/RECOVERY.md (or the README's "
          "port section), and be covered by "
          "a chaos_sweep scenario; every failpoint() call site must "
          "reference a registered constant.  Subsumes chaos_sweep "
          "--check-docs.",
      fixture_fail=_FPREG_FIXTURE_FAIL, fixture_pass=_FPREG_FIXTURE_PASS)
def failpoint_registry(project: Project):
    fp_names = _fp_const_map(project)
    registered: dict[str, tuple] = {}   # name -> (mod, node)
    called: set[str] = set()
    for mod in project.modules:
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            if _call_name(node) == "register_failpoint" and node.args:
                name = _const_str(node.args[0])
                if not name:
                    yield _finding(mod, node,
                                   "register_failpoint name must be a "
                                   "string literal")
                elif name in registered:
                    yield _finding(
                        mod, node,
                        f"failpoint {name!r} registered twice (also at "
                        f"{registered[name][0].path}:"
                        f"{registered[name][1].lineno})")
                else:
                    registered[name] = (mod, node)
            elif _call_name(node) == "failpoint" and node.args and \
                    mod.path != project.pkg("utils/failpoints.py"):
                arg = node.args[0]
                name = _const_str(arg) or (
                    fp_names.get(arg.id) if isinstance(arg, ast.Name)
                    else None)
                if name is None:
                    yield _finding(
                        mod, node,
                        "failpoint() called with an argument that does not "
                        "resolve to a register_failpoint constant")
                else:
                    called.add(name)
    docs = _docs(project)
    recovery = project.doc_text(*docs["recovery"])
    chaos_path = docs["chaos_sweep"] or project.pkg("drivers/chaos_sweep.py")
    chaos_mod = project.module(chaos_path)
    chaos_src = chaos_mod.source if chaos_mod else (
        project.read(chaos_path) or "")
    for name, (mod, node) in sorted(registered.items()):
        if name not in called:
            yield _finding(mod, node,
                           f"failpoint {name!r} is registered but never "
                           f"reached by a failpoint() call site (dead entry)")
        if name not in recovery:
            yield _finding(mod, node,
                           f"failpoint {name!r} is not documented in "
                           f"{' or '.join(docs['recovery'])}")
        if name not in chaos_src:
            yield _finding(mod, node,
                           f"failpoint {name!r} has no chaos_sweep scenario")


# ================================================== 3. metrics-conventions
_METRIC_KINDS = ("counter", "gauge", "histogram")
_METRIC_NAME_RE = re.compile(r"^sm_[a-z0-9_]+$")

_METRICS_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/x.py": (
        "def f(m):\n"
        "    m.counter('jobs_total', 'no prefix').inc()\n"
        "    m.gauge('sm_thing', 'kind conflict').set(1)\n"
        "    m.counter('sm_thing', 'kind conflict').inc()\n"
        "    m.counter('sm_undocumented_total', 'not in docs').inc()\n"
    ),
    "aux": {"docs/OBSERVABILITY.md": "`sm_thing` is documented\n"},
}
_METRICS_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/x.py": (
        "def f(m):\n"
        "    m.counter('sm_jobs_total', 'documented').inc()\n"
    ),
    "aux": {"docs/OBSERVABILITY.md": "`sm_jobs_total` counts jobs\n"},
}


@rule("metrics-conventions", severity="error",
      doc="Every metric registered by literal name must be sm_-prefixed, "
          "keep ONE kind (counter/gauge/histogram) across the tree, and be "
          "documented in docs/OBSERVABILITY.md or docs/SERVICE.md (or the "
          "README's port section).",
      fixture_fail=_METRICS_FIXTURE_FAIL, fixture_pass=_METRICS_FIXTURE_PASS)
def metrics_conventions(project: Project):
    metric_docs = _docs(project)["metrics"]
    docs = project.doc_text(*metric_docs)
    seen: dict[str, tuple[str, object, object]] = {}  # name -> (kind, mod, node)
    for mod in project.modules:
        for node in mod.nodes:
            if not (isinstance(node, ast.Call) and
                    _call_name(node) in _METRIC_KINDS and node.args):
                continue
            name = _const_str(node.args[0])
            if name is None:
                continue              # dynamic names (registry internals)
            kind = _call_name(node)
            if not _METRIC_NAME_RE.match(name):
                yield _finding(mod, node,
                               f"metric {name!r} violates the sm_ naming "
                               f"convention (^sm_[a-z0-9_]+$)")
            prior = seen.get(name)
            if prior is None:
                seen[name] = (kind, mod, node)
                if name not in docs:
                    yield _finding(
                        mod, node,
                        f"metric {name!r} is not documented in "
                        f"{' or '.join(metric_docs)}")
            elif prior[0] != kind:
                yield _finding(
                    mod, node,
                    f"metric {name!r} registered as {kind} here but as "
                    f"{prior[0]} at {prior[1].path}:{prior[2].lineno} — "
                    f"one name, one kind")


# ========================================================= 4. config-drift
_CONFIG_MODULE = "utils/config.py"

_CONFIG_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/utils/config.py": (
        "from dataclasses import dataclass, field\n"
        "@dataclass\n"
        "class SubConfig:\n"
        "    knob_a: int = 1\n"
        "@dataclass\n"
        "class SMConfig:\n"
        "    backend: str = 'x'\n"
        "    missing_from_template: int = 0\n"
        "    sub: SubConfig = field(default_factory=SubConfig)\n"
    ),
    "aux": {
        "conf/config_torch.json.template": json.dumps(
            {"backend": "x", "sub": {"knob_a": 1, "ghost_key": 2}}),
        "README.md": "## PyTorch/CUDA port\nbackend knob_a ghost_key docs\n",
    },
}
_CONFIG_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/utils/config.py": (
        "from dataclasses import dataclass, field\n"
        "@dataclass\n"
        "class SMConfig:\n"
        "    backend: str = 'x'\n"
    ),
    "aux": {"conf/config_torch.json.template": json.dumps({"backend": "x"}),
            "README.md": "## PyTorch/CUDA port\n"
                         "the backend knob is documented\n"},
}


def _dataclass_fields(mod) -> dict[str, list[tuple[str, str, int]]]:
    """{ClassName: [(field, annotation_name, lineno)]} for @dataclass
    classes (ClassVar and properties excluded)."""
    out: dict[str, list[tuple[str, str, int]]] = {}
    for node in mod.nodes:
        if not isinstance(node, ast.ClassDef):
            continue
        if not any("dataclass" in _attr_chain(d) or (
                isinstance(d, ast.Call) and "dataclass" in _attr_chain(d.func))
                for d in node.decorator_list):
            continue
        fields = []
        for stmt in node.body:
            if not (isinstance(stmt, ast.AnnAssign) and
                    isinstance(stmt.target, ast.Name)):
                continue
            ann = stmt.annotation
            ann_name = ann.id if isinstance(ann, ast.Name) else (
                _const_str(ann) or "")
            if "ClassVar" in ast.dump(ann):
                continue
            fields.append((stmt.target.id, ann_name.strip('"'), stmt.lineno))
        out[node.name] = fields
    return out


def _knob_tree(classes: dict, cls: str, prefix: str = "") -> dict[str, int]:
    """{dotted knob path: lineno}; nested dataclass fields recurse."""
    out: dict[str, int] = {}
    for name, ann, lineno in classes.get(cls, []):
        ann = ann.strip("'\" ")
        if ann in classes:
            out.update(_knob_tree(classes, ann, prefix + name + "."))
        else:
            out[prefix + name] = lineno
    return out


def _template_keys(data: dict, prefix: str = "") -> set[str]:
    out: set[str] = set()
    for k, v in data.items():
        if k.startswith("__"):
            continue                  # template comment keys
        if isinstance(v, dict):
            out |= _template_keys(v, prefix + k + ".")
        else:
            out.add(prefix + k)
    return out


@rule("config-drift", severity="error",
      doc="Every SMConfig/DSConfig knob must appear in its conf/*.template "
          "and in the docs (docs/*.md or README), and every template key "
          "must be a real knob.",
      fixture_fail=_CONFIG_FIXTURE_FAIL, fixture_pass=_CONFIG_FIXTURE_PASS)
def config_drift(project: Project):
    mod = project.module(project.pkg(_CONFIG_MODULE))
    if mod is None:
        return
    classes = _dataclass_fields(mod)
    profile = _docs(project)
    docs = [project.doc_text(*profile["config"])]
    if project.root is not None:
        docs += [p.read_text() for p in sorted(
            (project.root / "docs").glob("*.md"))]
    docs += [v for k, v in project.aux.items()
             if k.startswith("docs/") and k != "README.md"]
    doc_text = "\n".join(docs)
    for cls, tmpl_path in profile["templates"].items():
        if cls not in classes:
            continue
        knobs = _knob_tree(classes, cls)
        raw = project.read(tmpl_path)
        if raw is None:
            yield _finding(mod, mod.tree, f"missing template {tmpl_path}")
            continue
        tmpl = _template_keys(json.loads(raw))
        for knob, lineno in sorted(knobs.items()):
            if knob not in tmpl:
                yield Finding("", "", mod.path, lineno,
                              f"{cls} knob {knob!r} is missing from "
                              f"{tmpl_path}", anchor=f"{cls}.{knob}")
            leaf = knob.split(".")[-1]
            if leaf not in doc_text:
                yield Finding("", "", mod.path, lineno,
                              f"{cls} knob {knob!r} is not documented "
                              f"anywhere under docs/ or "
                              f"{' or '.join(profile['config'])}",
                              anchor=f"{cls}.{knob}.docs")
        for key in sorted(tmpl - set(knobs)):
            yield Finding("", "", mod.path, 0,
                          f"{tmpl_path} key {key!r} is not a {cls} knob "
                          f"(typo or removed config?)",
                          anchor=f"{cls}.template.{key}")


# ============================================================ 5. guarded-by
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "add", "discard", "setdefault",
             "move_to_end", "appendleft", "popleft", "sort", "reverse"}

_GUARDED_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/x.py": (
        "import threading\n"
        "class C:\n"
        "    _GUARDED_BY = {'_items': '_lock', '_count': '_lock'}\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._items = []\n"
        "        self._count = 0\n"
        "    def bad(self, x):\n"
        "        self._items.append(x)\n"
        "        self._count += 1\n"
    ),
}
_GUARDED_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/x.py": (
        "import threading\n"
        "class C:\n"
        "    _GUARDED_BY = {'_items': '_lock', '_count': '_lock'}\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._items = []\n"
        "        self._count = 0\n"
        "    def good(self, x):\n"
        "        with self._lock:\n"
        "            self._items.append(x)\n"
        "            self._count += 1\n"
        "    def _drain_locked(self):\n"
        "        self._items.clear()\n"
    ),
}


def _guarded_decls(cls: ast.ClassDef) -> dict[str, str]:
    """The class's ``_GUARDED_BY = {attr: lock}`` declaration, if any."""
    for stmt in cls.body:
        targets = stmt.targets if isinstance(stmt, ast.Assign) else (
            [stmt.target] if isinstance(stmt, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == "_GUARDED_BY"
               for t in targets) and isinstance(
                   getattr(stmt, "value", None), ast.Dict):
            out = {}
            for k, v in zip(stmt.value.keys, stmt.value.values):
                ks, vs = _const_str(k), _const_str(v)
                if ks and vs:
                    out[ks] = vs
            return out
    return {}


def _mutated_attr(node: ast.AST) -> str | None:
    """``X`` when ``node`` mutates ``self.X``: assignment/augassign/del of
    ``self.X`` (or a subscript of it), or a mutating method call on it."""
    if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Delete)):
        targets = getattr(node, "targets", None) or \
            [getattr(node, "target", None)]
        for t in targets:
            if t is None:
                continue
            base = t.value if isinstance(t, ast.Subscript) else t
            attr = _self_attr(base)
            if attr:
                return attr
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        return _self_attr(node.func.value)
    return None


def _holds_lock(mod, node: ast.AST, lock: str) -> bool:
    """Is ``node`` lexically inside ``with self.<lock>:``?"""
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                if _self_attr(item.context_expr) == lock:
                    return True
    return False


@rule("guarded-by", severity="error",
      doc="Attributes declared in a class's _GUARDED_BY registry may only "
          "be mutated inside `with self.<lock>:` — except in __init__ "
          "(happens-before publication) and in methods named *_locked "
          "(documented caller-holds-lock convention).",
      fixture_fail=_GUARDED_FIXTURE_FAIL, fixture_pass=_GUARDED_FIXTURE_PASS)
def guarded_by(project: Project):
    for mod in project.modules:
        for cls in mod.nodes:
            if not isinstance(cls, ast.ClassDef):
                continue
            decls = _guarded_decls(cls)
            if not decls:
                continue
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__" or fn.name.endswith("_locked"):
                    continue
                for node in ast.walk(fn):
                    attr = _mutated_attr(node)
                    if attr is None or attr not in decls:
                        continue
                    lock = decls[attr]
                    if not _holds_lock(mod, node, lock):
                        yield _finding(
                            mod, node,
                            f"{cls.name}.{attr} is declared guarded by "
                            f"self.{lock} but is mutated in {fn.name}() "
                            f"without holding it")


# ========================================================== 6. atomic-write
# directories whose contents other processes/threads read CONCURRENTLY by
# glob: a non-atomic write here is a torn-JSON/BadZipFile waiting for a
# reader (the spool states, the fenced-lease files, the replica registry).
# The convention: write a unique tmp name, then os.replace /
# Path.replace into place.
_AW_DIRS = ("pending", "running", "done", "failed", "quarantine",
            "leases", "replicas")
_AW_WRITE_METHODS = ("write_text", "write_bytes")

_AW_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/service/x.py": (
        "class S:\n"
        "    def bad_direct(self, msg_id, data):\n"
        "        (self.root / 'failed' / msg_id).write_text(data)\n"
        "    def bad_open(self, msg_id, data):\n"
        "        dst = self.root / 'pending' / msg_id\n"
        "        with open(dst, 'w') as f:\n"
        "            f.write(data)\n"
        "    def bad_tmp_no_replace(self, msg_id, data):\n"
        "        tmp = self.root / 'pending' / f'.{msg_id}.tmp'\n"
        "        tmp.write_text(data)\n"
    ),
}
_AW_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/service/x.py": (
        "import os\n"
        "class S:\n"
        "    def good(self, msg_id, data):\n"
        "        tmp = self.root / 'pending' / f'.{msg_id}.tmp'\n"
        "        tmp.write_text(data)\n"
        "        os.replace(tmp, self.root / 'pending' / f'{msg_id}.json')\n"
        "    def good_path_replace(self, msg_id, data):\n"
        "        tmp = self.root / 'leases' / f'.{msg_id}.tmp'\n"
        "        tmp.write_text(data)\n"
        "        tmp.replace(self.root / 'leases' / f'{msg_id}.json')\n"
        "    def reader(self):\n"
        "        return (self.root / 'done' / 'x.json').read_text()\n"
    ),
}


def _open_write_mode(call: ast.Call) -> bool:
    """``open(..., 'w'/'wb'/...)`` — any truncating/creating text/binary
    write mode (append keeps prior bytes but still tears concurrent
    readers; included)."""
    mode = None
    if len(call.args) >= 2:
        mode = _const_str(call.args[1])
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = _const_str(kw.value)
    return bool(mode) and any(c in mode for c in "wax")


@rule("atomic-write", severity="error",
      doc="Any open-for-write landing in a concurrently-globbed spool/"
          "lease/registry directory (pending, running, done, failed, "
          "quarantine, leases, replicas) must follow the unique-tmp + "
          "os.replace convention: the write target must be a tmp name and "
          "the same function must replace it into place afterwards.",
      fixture_fail=_AW_FIXTURE_FAIL, fixture_pass=_AW_FIXTURE_PASS)
def atomic_write(project: Project):
    for mod in project.modules:
        if not _owns_spool_state(project, mod.path):
            continue                  # scripts/benches are single-actor
                                      # drivers over their own sandboxes
        for fn in mod.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # locals assigned from expressions naming a protected dir;
            # value = whether the SAME expression names a tmp component
            tainted: dict[str, bool] = {}
            replaces: list[int] = []
            writes: list[tuple[ast.AST, str, bool]] = []
            for node in ast.walk(fn):
                if mod.enclosing_function(node) is not fn and node is not fn:
                    continue          # skip nested defs/lambdas
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    strs = _subtree_strs(node.value)
                    if strs & set(_AW_DIRS):
                        tainted[node.targets[0].id] = any(
                            "tmp" in s for s in strs)
                if not isinstance(node, ast.Call):
                    continue
                callee = _call_name(node)
                if callee == "replace":
                    replaces.append(node.lineno)
                    continue
                target = None
                if callee in _AW_WRITE_METHODS and \
                        isinstance(node.func, ast.Attribute):
                    target = node.func.value
                elif callee == "open" and node.args and \
                        _open_write_mode(node):
                    target = node.args[0]
                if target is None:
                    continue
                strs = _subtree_strs(target)
                is_tmp = any("tmp" in s for s in strs)
                hit = bool(strs & set(_AW_DIRS))
                if not hit and isinstance(target, ast.Name) and \
                        target.id in tainted:
                    hit = True
                    is_tmp = is_tmp or tainted[target.id]
                if hit:
                    writes.append((node, callee, is_tmp))
            for node, callee, is_tmp in writes:
                if not is_tmp:
                    yield _finding(
                        mod, node,
                        f"{callee}() writes directly into a concurrently-"
                        f"globbed spool/lease/registry directory — use a "
                        f"unique tmp name + os.replace (torn writes become "
                        f"reader-visible garbage)")
                elif not any(ln > node.lineno for ln in replaces):
                    yield _finding(
                        mod, node,
                        f"{callee}() writes a tmp file in a spool/lease/"
                        f"registry directory but "
                        f"{mod.qualname(node) or 'module scope'} never "
                        f"os.replace()s it into place — half a convention "
                        f"leaks orphan tmps")


# ================================================= 7. kernel-build-surface
# The port's build surface: every hand-written CUDA library is built by
# kernels/_build.py from csrc/<name>.cu, named in its KERNELS, readied at a
# launch site that its module declares in KERNEL_SURFACE
# (analysis/surface.py), and primable: service/primer.spec_kernels must be
# able to name it, or a primed replica still pays nvcc on its first job.
_BUILD_CALLS = ("load", "ready", "prime", "build_all")

_KS_BUILD = (
    "KERNELS = ('moments', 'chaos')\n"
    "def load(name):\n"
    "    return name\n"
    "def ready(name, device):\n"
    "    return load(name)\n"
)
_KS_PRIMER = (
    "def spec_kernels(spec):\n"
    "    return ('moments',)\n"
)
_KS_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/kernels/_build.py": _KS_BUILD,
    "sm_distributed_tpu_torch/service/primer.py": _KS_PRIMER,
    "sm_distributed_tpu_torch/ops/x.py": (
        "from ..analysis.surface import kernel_surface\n"
        "from ..kernels import _build\n"
        "KERNEL_SURFACE = kernel_surface(__name__, {\n"
        "    '_launch': 'library=moments; shapes=K <= 8',\n"
        "    '_launch_chaos': 'library=chaos; shapes=one block',\n"
        "    '_gone': 'library=moments; shapes=none',\n"
        "})\n"
        "def _launch(x):\n"
        "    return _build.ready('moments', x.device)\n"
        "def _launch_chaos(x):\n"
        "    return _build.ready('chaos', x.device)\n"
        "def _undeclared(x):\n"
        "    return _build.ready('moments', x.device)\n"
        "def _typo(x):\n"
        "    return _build.load('momnets')\n"
    ),
    "aux": {"sm_distributed_tpu_torch/csrc/moments.cu": "",
            "sm_distributed_tpu_torch/csrc/chaos.cu": ""},
}
_KS_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/kernels/_build.py": _KS_BUILD,
    "sm_distributed_tpu_torch/service/primer.py": (
        "def spec_kernels(spec):\n"
        "    return ('moments', 'chaos')\n"
    ),
    "sm_distributed_tpu_torch/ops/x.py": (
        "from ..analysis.surface import kernel_surface\n"
        "from ..kernels import _build\n"
        "KERNEL_SURFACE = kernel_surface(__name__, {\n"
        "    '_launch': 'library=moments; shapes=K <= 8',\n"
        "    '_launch_chaos': 'library=chaos; shapes=one block',\n"
        "})\n"
        "def _launch(x):\n"
        "    return _build.ready('moments', x.device)\n"
        "def _launch_chaos(x):\n"
        "    return _build.ready('chaos', x.device)\n"
        "def warm():\n"
        "    _build.build_all(('moments', 'chaos'))\n"
    ),
    "aux": {"sm_distributed_tpu_torch/csrc/moments.cu": "",
            "sm_distributed_tpu_torch/csrc/chaos.cu": ""},
}


def _kernels_decl(project: Project) -> tuple[str, ...] | None:
    """The ``KERNELS = (...)`` tuple of the package's kernels/_build.py
    (None when the project has no such module)."""
    path = project.pkg("kernels/_build.py")
    mod = project.module(path)
    src = mod.source if mod is not None else project.read(path)
    if src is None:
        return None
    tree = mod.tree if mod is not None else ast.parse(src)
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "KERNELS" and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            return tuple(s for s in map(_const_str, node.value.elts)
                         if s is not None)
    return None


def _primable(project: Project) -> set[str] | None:
    """The libraries ``service/primer.spec_kernels`` can return: its
    string constants (None when the project has no primer module)."""
    mod = project.module(project.pkg("service/primer.py"))
    if mod is None:
        return None
    for node in mod.nodes:
        if isinstance(node, ast.FunctionDef) and node.name == "spec_kernels":
            return _subtree_strs(node)
    return set()


def _build_call(node: ast.AST) -> str | None:
    """``load``/``ready``/``prime``/``build_all`` when ``node`` calls that
    function of kernels/_build.py through its module (``_build.ready``)."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _BUILD_CALLS and \
            _attr_chain(node.func.value).split(".")[-1] == "_build":
        return node.func.attr
    return None


def _named_libraries(call: ast.Call) -> list[str]:
    """The literal library names a build call passes (its first
    argument: one name, or a tuple/list of names)."""
    if not call.args:
        return []
    a = call.args[0]
    elts = a.elts if isinstance(a, (ast.Tuple, ast.List)) else [a]
    return [s for s in map(_const_str, elts) if s is not None]


def _surface_decl(mod) -> tuple[dict[str, tuple[str, int]] | None, int]:
    """The module's ``KERNEL_SURFACE = kernel_surface(_, {...})``
    declaration: ({site: (policy, lineno)}, decl lineno), or (None, 0)."""
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1 and
                isinstance(node.targets[0], ast.Name) and
                node.targets[0].id == "KERNEL_SURFACE"):
            continue
        if not (isinstance(node.value, ast.Call) and
                _call_name(node.value) == "kernel_surface" and
                len(node.value.args) >= 2 and
                isinstance(node.value.args[1], ast.Dict)):
            return {}, node.lineno    # declared but not the literal grammar
        out = {}
        for k, v in zip(node.value.args[1].keys,
                        node.value.args[1].values):
            ks, vs = _const_str(k), _const_str(v)
            if ks is not None:
                out[ks] = (vs or "", getattr(k, "lineno", node.lineno))
        return out, node.lineno
    return None, 0


def _launch_sites(mod):
    """Yield ``(function, ready call, library)`` for every function of
    ``mod`` that readies a kernel library (``_build.ready``) — the launch
    sites.  ``library`` is "" when the name is not a literal."""
    for node in mod.nodes:
        if _build_call(node) == "ready":
            fn = mod.enclosing_function(node)
            if fn is not None:
                names = _named_libraries(node)
                yield fn, node, names[0] if names else ""


@rule("kernel-build-surface", severity="error",
      doc="Every library a _build.load/ready/prime/build_all call names must "
          "be in kernels/_build.py's KERNELS and have its csrc/<name>.cu; "
          "every launch site (a function calling _build.ready) must be "
          "declared in its module's KERNEL_SURFACE = kernel_surface("
          "__name__, {site: 'library=<name>; shapes=<bound>'}) with the "
          "library it readies; dead entries are findings; and every "
          "declared library must be one service/primer.spec_kernels can "
          "return, or a primed replica still pays nvcc on its first job.",
      fixture_fail=_KS_FIXTURE_FAIL, fixture_pass=_KS_FIXTURE_PASS)
def kernel_build_surface(project: Project):
    kernels = _kernels_decl(project)
    primable = _primable(project)
    build_path = project.pkg("kernels/_build.py")
    for mod in project.modules:
        if mod.path == build_path:
            continue                  # the builder's own definitions
        for node in mod.nodes:
            if _build_call(node) is None:
                continue
            for name in _named_libraries(node):
                if kernels is not None and name not in kernels:
                    yield _finding(
                        mod, node,
                        f"kernel library {name!r} is not in "
                        f"kernels/_build.py's KERNELS {list(kernels)}")
                if project.read(project.pkg(f"csrc/{name}.cu")) is None:
                    yield _finding(
                        mod, node,
                        f"kernel library {name!r} has no "
                        f"csrc/{name}.cu to build it from")
        if not project.in_package(mod.path):
            continue
        sites = list(_launch_sites(mod))
        decl, _decl_line = _surface_decl(mod)
        if sites and decl is None:
            yield Finding(
                "", "", mod.path, sites[0][1].lineno,
                f"module has {len(sites)} kernel launch site(s) but no "
                f"KERNEL_SURFACE = kernel_surface(__name__, {{...}}) "
                f"registry declaring them", anchor="KERNEL_SURFACE")
            continue
        decl = decl or {}
        used: set[str] = set()
        for fn, node, library in sites:
            entry = decl.get(fn.name)
            if entry is None:
                yield _finding(
                    mod, node,
                    f"kernel launch site {fn.name!r} (readies "
                    f"{library or 'a library'}) is not declared in this "
                    f"module's KERNEL_SURFACE")
                continue
            used.add(fn.name)
            policy = entry[0]
            missing = [t for t in POLICY_TOKENS if t not in policy]
            if missing:
                yield _finding(
                    mod, node,
                    f"KERNEL_SURFACE entry {fn.name!r} lacks the "
                    f"{'/'.join(missing)} clause(s) of the policy grammar")
            elif library and policy_library(policy) != library:
                yield _finding(
                    mod, node,
                    f"KERNEL_SURFACE entry {fn.name!r} declares "
                    f"library={policy_library(policy)!r} but the site "
                    f"readies {library!r}")
        for site, (policy, lineno) in sorted(decl.items()):
            if site not in used:
                yield Finding(
                    "", "", mod.path, lineno,
                    f"KERNEL_SURFACE entry {site!r} matches no kernel "
                    f"launch site (dead entry — remove it or fix the site "
                    f"name)", anchor=f"KERNEL_SURFACE.{site}")
            library = policy_library(policy)
            if primable is not None and library and \
                    library not in primable:
                yield Finding(
                    "", "", mod.path, lineno,
                    f"KERNEL_SURFACE entry {site!r} launches library "
                    f"{library!r}, which service/primer.spec_kernels never "
                    f"returns: a primed replica would still pay nvcc for "
                    f"it on its first job",
                    anchor=f"KERNEL_SURFACE.{site}.primer")


def kernel_surface_census(project: Project) -> dict[str, int]:
    """Static totals for the smlint JSON artifact: kernel launch sites,
    declared KERNEL_SURFACE entries, and modules carrying a registry."""
    sites = entries = modules = 0
    for mod in project.modules:
        if not project.in_package(mod.path):
            continue
        sites += len(list(_launch_sites(mod)))
        decl, _ = _surface_decl(mod)
        if decl:
            modules += 1
            entries += len(decl)
    return {"sites": sites, "entries": entries, "modules": modules}


# ======================================================= 8. spec-key-hazard
# Eager torch compiles nothing per shape, but every batch the port scores
# on the lattice records a bucket spec (ops/buckets.record_spec), and the
# primer builds and the compile census counts one entry per distinct
# spec_key.  A raw runtime shape (.shape / .numel() / len() / .size) that
# reaches a spec unbucketed mints one spec per dataset size: the
# unbounded family the lattice exists to prevent.  Sinks are the
# arguments of record_spec/spec_key and, inside a function whose result
# is passed to one of them (a spec builder), every value of a dict
# literal or subscript assignment.  A value bounded by construction carries
# `# smlint: spec-key-ok[reason]`.
_SPEC_SINKS = ("record_spec", "spec_key")
_BUCKET_HELPERS = ("ions_per_chunk_for", "shape_key", "window_chunks",
                   "ion_window_chunks", "gc_ladder")

_SK_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/models/x.py": (
        "from ..ops import buckets\n"
        "class B:\n"
        "    def _spec(self, x):\n"
        "        n = x.shape[0]\n"
        "        return {'n': n, 'p': len(x), 'q': x.numel()}\n"
        "    def go(self, x):\n"
        "        buckets.record_spec(self._spec(x))\n"
        "        buckets.record_spec({'m': int(x.shape[1])})\n"
    ),
}
_SK_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/models/x.py": (
        "from ..ops import buckets\n"
        "class B:\n"
        "    def _spec(self, x):\n"
        "        n = buckets.peak_bucket(x.shape[0])\n"
        "        # smlint: spec-key-ok[rows were row_bucket-padded at set-up]\n"
        "        spec = {'n': n, 'rows': x.shape[1]}\n"
        "        spec['b'] = self.batch\n"
        "        return spec\n"
        "    def go(self, x):\n"
        "        buckets.record_spec(self._spec(x))\n"
    ),
}


def _is_shape_source(node: ast.AST) -> bool:
    """A raw runtime-shape read: ``.shape`` / ``.size`` attribute access,
    a ``.numel()`` / ``.size()`` call or a ``len(...)`` call."""
    if isinstance(node, ast.Attribute) and node.attr in ("shape", "size"):
        return True
    return isinstance(node, ast.Call) and _call_name(node) in (
        "len", "numel")


def _is_bucketing_call(node: ast.AST) -> bool:
    """A call through a recognized bucketing/padding helper: name contains
    ``bucket``/``round``/``pad``/``pow2``, or one of the named shape-plan
    helpers."""
    if not isinstance(node, ast.Call):
        return False
    callee = _call_name(node)
    return (callee in _BUCKET_HELPERS or
            any(t in callee for t in ("bucket", "round", "pad", "pow2")))


def _spec_builders(mod) -> set[str]:
    """Names of the functions whose result a spec sink consumes
    (``record_spec(self._bucket_spec(...))`` -> ``_bucket_spec``)."""
    out: set[str] = set()
    for node in mod.nodes:
        if isinstance(node, ast.Call) and _call_name(node) in _SPEC_SINKS:
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(a, ast.Call):
                    out.add(_call_name(a))
    return out


@rule("spec-key-hazard", severity="error",
      doc="Raw runtime shapes (.shape / .size / .numel() / len()) must not "
          "reach a bucket spec — an argument of ops/buckets.record_spec / "
          "spec_key, or a value of the dict a spec builder returns to them "
          "— without passing a bucketing/padding helper: one spec per "
          "distinct value is an unbounded family of primer specs.  A value "
          "bounded by construction carries `# smlint: spec-key-ok[reason]` "
          "where the shape is read or where it enters the spec.",
      fixture_fail=_SK_FIXTURE_FAIL, fixture_pass=_SK_FIXTURE_PASS)
def spec_key_hazard(project: Project):
    for mod in project.modules:
        if not project.in_package(mod.path) or \
                mod.path == project.pkg("ops/buckets.py"):
            continue                  # the spec registry itself
        if not any(isinstance(n, ast.Call) and _call_name(n) in _SPEC_SINKS
                   for n in mod.nodes):
            continue
        builders = _spec_builders(mod)
        for fn in mod.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            # a bucketing call clears its expression, and so does a shape
            # read annotated as bounded where it is read
            taint = TaintTracker(
                source=_is_shape_source,
                sanitizer=lambda n: _is_bucketing_call(n) or (
                    _is_shape_source(n) and bool(mod.annotation_reason(
                        "spec-key", getattr(n, "lineno", 0)))))
            sinks: list[ast.AST] = []
            for node in taint.walk(mod, fn):
                if isinstance(node, ast.Call) and \
                        _call_name(node) in _SPEC_SINKS:
                    for a in list(node.args) + [kw.value
                                                for kw in node.keywords]:
                        if isinstance(a, ast.Dict):
                            sinks += [v for v in a.values if v is not None]
                        elif not (isinstance(a, ast.Call) and
                                  _call_name(a) in builders):
                            sinks.append(a)
                elif fn.name in builders and isinstance(node, ast.Dict):
                    sinks += [v for v in node.values if v is not None]
                elif fn.name in builders and isinstance(node, ast.Assign) \
                        and any(isinstance(t, ast.Subscript)
                                for t in node.targets):
                    sinks.append(node.value)
                else:
                    continue
                for value in sinks:
                    if isinstance(value, ast.Dict) or \
                            not taint.expr_tainted(value):
                        continue
                    reason = mod.annotation_reason("spec-key", value.lineno)
                    if reason:
                        continue
                    yield _finding(
                        mod, value,
                        "a raw runtime shape (.shape/.size/.numel()/len) "
                        "reaches a bucket spec without a bucketing/padding "
                        "helper — every distinct value mints a new primer "
                        "spec (spec-key hazard); bucket it or annotate "
                        "`# smlint: spec-key-ok[why it is bounded]`"
                        + (" (annotation reason is empty)"
                           if reason == "" else ""))
                sinks = []


# ============================================================= 9. host-sync
# Device->host syncs in the HOT scoring modules: each blocking copy either
# way (a pageable host array sent to the card, a tensor fetched back),
# .item()/.tolist(), a synchronize or an event's elapsed_time, and each
# op whose output shape depends on the data (nonzero, unique,
# masked_select, boolean-mask indexing) stalls the host until the card's
# queue drains, so every one must be a deliberate, argued fetch point —
# annotated `# smlint: host-sync-ok[reason]`.  chip_smoke.py's sync
# census (analysis/synccensus.py) holds the syncs the main path really
# makes on the card to these annotations.
HOT_MODULES = ("models/msm_torch.py", "parallel/sharded.py",
               "ops/imager.py", "ops/metrics.py", "ops/moments.py",
               "ops/chaos.py", "ops/score.py", "ops/quantize.py",
               "ops/isocalc_torch.py")
_HS_METHODS = ("item", "tolist", "cpu", "numpy", "cuda", "synchronize",
               "elapsed_time", "nonzero", "unique", "unique_consecutive",
               "masked_select")
_HS_TORCH_FUNCS = ("nonzero", "unique", "unique_consecutive",
                   "masked_select")
_HS_UPLOADS = ("tensor", "as_tensor")
_MASK_CALLS = ("isin", "logical_and", "logical_or", "logical_not",
               "logical_xor", "isnan", "isfinite", "isinf", "bool")

_HS_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/ops/moments.py": (
        "import numpy as np\n"
        "import torch\n"
        "def score(x, host, dev):\n"
        "    n = int(x.sum().item())\n"
        "    t = torch.from_numpy(host).to(dev)\n"
        "    keep = x > 0\n"
        "    y = x[keep]\n"
        "    idx = torch.nonzero(x)\n"
        "    torch.cuda.synchronize()\n"
        "    return y.cpu().numpy(), t, n, idx\n"
    ),
}
_HS_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/ops/moments.py": (
        "import numpy as np\n"
        "import torch\n"
        "def score(x, host, dev, starts):\n"
        "    # smlint: host-sync-ok[the batch's plan goes up once a batch]\n"
        "    t = torch.from_numpy(host).to(dev)\n"
        "    y = torch.where(x > 0, x, 0.0).to(torch.float32)\n"
        "    for c in np.asarray(starts).tolist():\n"
        "        y = y + c\n"
        "    z = t.to(dev, non_blocking=True)\n"
        "    return y, z, torch.arange(4, device=dev)\n"
    ),
}


def is_hot_module(path: str, package: str = DEFAULT_PACKAGE) -> bool:
    """Is ``path`` one of the hot scoring modules the host-sync rule
    checks?"""
    return any(path == f"{package}/{m}" for m in HOT_MODULES)


def _numpy_receiver(node: ast.AST) -> bool:
    """Is ``node`` plainly a numpy value: a call of an ``np.``/``numpy.``
    function?"""
    return isinstance(node, ast.Call) and \
        _attr_chain(node.func).split(".")[0] in ("np", "numpy")


def _device_arg(node: ast.AST) -> bool:
    """Does ``node`` name a device (``self.device``, ``x.device``, ``dev``,
    ``"cuda"``, ``torch.device(...)``) rather than a dtype?"""
    s = _const_str(node)
    if s is not None:
        return s.startswith("cuda")
    if isinstance(node, ast.Call):
        return _attr_chain(node.func) == "torch.device"
    chain = _attr_chain(node)
    leaf = chain.split(".")[-1] if chain else ""
    return leaf == "device" or leaf.startswith("dev")


def _cpu_arg(node: ast.AST) -> bool:
    if _const_str(node) == "cpu":
        return True
    return isinstance(node, ast.Call) and \
        _attr_chain(node.func) == "torch.device" and bool(node.args) and \
        _const_str(node.args[0]) == "cpu"


def _host_sync_call(node: ast.Call) -> str | None:
    """The sync kind when ``node`` blocks the host on the card."""
    callee = _call_name(node)
    chain = _attr_chain(node.func)
    kw = {k.arg: k.value for k in node.keywords if k.arg}
    if chain.split(".")[0] in ("np", "numpy"):
        return None
    if chain.startswith("torch.") and not chain.startswith("torch.cuda."):
        if callee in _HS_TORCH_FUNCS:
            return f"torch.{callee}() (data-dependent shape)"
        if callee == "where" and len(node.args) == 1 and not kw:
            return "torch.where(cond) (data-dependent shape)"
        if callee in _HS_UPLOADS and "device" in kw and \
                not _cpu_arg(kw["device"]):
            return f"torch.{callee}(..., device=) (blocking host->device copy)"
        return None
    if chain == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if not isinstance(node.func, ast.Attribute):
        return None
    recv = node.func.value
    if callee == "to":
        if kw.get("non_blocking") is not None and \
                getattr(kw["non_blocking"], "value", False) is True:
            return None
        target = kw.get("device", node.args[0] if node.args else None)
        if target is None:
            return None
        if _cpu_arg(target):
            return ".to('cpu') (blocking device->host copy)"
        if _device_arg(target):
            return ".to(device) (blocking host->device copy)"
        return None
    if callee not in _HS_METHODS or _numpy_receiver(recv):
        return None
    if callee == "numpy":
        # a CUDA tensor has no .numpy(): the fetch is the .cpu() before it
        if isinstance(recv, ast.Call) and _call_name(recv) in ("cpu", "to"):
            return None
        return ".numpy() (the host view of a fetched tensor)"
    if callee == "cpu":
        return ".cpu() (blocking device->host copy)"
    if callee == "cuda":
        return ".cuda() (blocking host->device copy)"
    return f".{callee}()"


def _is_host(expr: ast.AST, hosts: set[str]) -> bool:
    """Is ``expr`` plainly a numpy value: it names no ``torch``, and it
    calls or names ``np.``/``numpy.`` or reads a local holding a numpy
    value (``lens = ends - starts`` after ``ends = cuts.astype(np.int64)``)?
    Its copies, indexing and masks are host work, not syncs."""
    names = [n for n in ast.walk(expr) if isinstance(n, ast.Name)]
    if any(n.id == "torch" for n in names):
        return False
    return any(n.id in ("np", "numpy") or n.id in hosts for n in names)


def _is_mask(expr: ast.AST, masks: set[str]) -> bool:
    """Is ``expr`` a boolean mask: a comparison, ``~m``, ``m & m`` (or
    ``|``, ``^``), a call that makes one (``isin``, ``logical_*``,
    ``isnan``, ``.bool()``, ...), or a local assigned one?"""
    if isinstance(expr, ast.Compare):
        return True
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return True
    if isinstance(expr, ast.BinOp) and isinstance(
            expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(expr.left, masks) or _is_mask(expr.right, masks)
    if isinstance(expr, ast.Call):
        return _call_name(expr) in _MASK_CALLS
    return isinstance(expr, ast.Name) and expr.id in masks


def _enclosing_stmt(mod, node: ast.AST):
    if isinstance(node, ast.stmt):
        return node
    for anc in mod.ancestors(node):
        if isinstance(anc, ast.stmt):
            return anc
    return None


def _sync_reason(mod, lineno: int, stmt) -> str | None:
    """The host-sync-ok reason on ``lineno`` or the line above it, else
    on the first line of the statement holding it or the line above that:
    the first non-empty one, "" when only empty ones, None when none."""
    reasons = [mod.host_sync_reason(lineno)]
    if stmt is not None and stmt.lineno != lineno:
        reasons.append(mod.host_sync_reason(stmt.lineno))
    return next((r for r in reasons if r),
                "" if "" in reasons else None)


def sync_line_annotated(mod, lineno: int) -> bool:
    """Does the host-sync rule see source line ``lineno`` of ``mod`` as
    annotated — a non-empty reason on it, the line above, or the first
    line of the innermost statement holding it (or the line above that)?
    The sync census holds the card's observed sync sites to this."""
    best = None
    for node in mod.nodes:
        if isinstance(node, ast.stmt) and \
                node.lineno <= lineno <= (node.end_lineno or node.lineno):
            if best is None or node.lineno >= best.lineno:
                best = node
    return bool(_sync_reason(mod, lineno, best))


@rule("host-sync", severity="error",
      doc="Device->host syncs (.item() / .tolist() / .cpu() / .numpy() / "
          ".to('cpu'); blocking host->device copies: .to(device) without "
          "non_blocking, .cuda(), torch.tensor/as_tensor(..., device=); "
          "torch.cuda.synchronize() / Event.synchronize() / "
          ".elapsed_time(); data-dependent shapes: nonzero, unique, "
          "masked_select, torch.where(cond), boolean-mask indexing) in the "
          "hot scoring modules (models/msm_torch.py, parallel/sharded.py, "
          "ops/{imager,metrics,moments,chaos,score,quantize,"
          "isocalc_torch}.py) must carry a `# smlint: "
          "host-sync-ok[reason]` annotation — each is a deliberate "
          "pipeline stall that must be argued.  Plainly numpy receivers "
          "(np.asarray(x).tolist()) are host work, not syncs.",
      fixture_fail=_HS_FIXTURE_FAIL, fixture_pass=_HS_FIXTURE_PASS)
def host_sync(project: Project):
    for mod in project.modules:
        if not is_hot_module(mod.path, project.package):
            continue
        hits: list[tuple[ast.AST, str]] = []
        scopes = [mod.tree] + [n for n in mod.nodes if isinstance(
            n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            nodes = (dataflow.function_nodes(mod, scope)
                     if scope is not mod.tree else
                     (n for n in mod.nodes
                      if mod.enclosing_function(n) is None))
            masks: set[str] = set()   # locals holding a boolean mask
            hosts: set[str] = set()   # locals holding a numpy value
            for node in nodes:
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target = node.targets[0]
                    if isinstance(target, ast.Name):
                        if _is_host(node.value, hosts):
                            hosts.add(target.id)
                            masks.discard(target.id)
                        elif _is_mask(node.value, masks):
                            masks.add(target.id)
                    elif isinstance(target, ast.Tuple) and \
                            _is_host(node.value, hosts):
                        hosts |= {e.id for e in target.elts
                                  if isinstance(e, ast.Name)}
                if isinstance(node, ast.Call):
                    kind = _host_sync_call(node)
                    if kind is not None and not (
                            isinstance(node.func, ast.Attribute) and
                            _is_host(node.func.value, hosts)):
                        hits.append((node, kind))
                elif isinstance(node, ast.Subscript) and \
                        not isinstance(node.ctx, ast.Del) and \
                        _is_mask(node.slice, masks) and \
                        not _is_host(node.slice, hosts):
                    hits.append((node, "boolean-mask indexing "
                                       "(data-dependent shape)"))
        for node, kind in hits:
            reason = _sync_reason(mod, node.lineno,
                                  _enclosing_stmt(mod, node))
            if reason:
                continue
            if reason == "":
                yield _finding(
                    mod, node,
                    f"host-sync-ok annotation for {kind} has an empty "
                    f"reason — the reason is the point")
            else:
                yield _finding(
                    mod, node,
                    f"{kind} in a hot scoring module is a device->host "
                    f"sync point — annotate `# smlint: host-sync-ok"
                    f"[reason]` (why this stall is deliberate) or move it "
                    f"off the hot path")


# ========================================================== 10. broad-except
_LOG_METHODS = {"debug", "info", "warning", "error", "exception", "critical",
                "log", "write"}

_BROAD_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/x.py": (
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        pass\n"
        "    try:\n"
        "        g()\n"
        "    except:\n"
        "        return None\n"
    ),
}
_BROAD_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/x.py": (
        "from .logger import logger\n"
        "def f():\n"
        "    try:\n"
        "        g()\n"
        "    except Exception:\n"
        "        logger.warning('g failed', exc_info=True)\n"
        "    try:\n"
        "        g()\n"
        "    except Exception as exc:\n"
        "        record(exc)\n"
        "        raise\n"
        "    try:\n"
        "        g()\n"
        "    except (OSError, ValueError):\n"
        "        pass\n"
    ),
}


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True                   # bare except:
    names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
    return any(isinstance(n, ast.Name) and
               n.id in ("Exception", "BaseException") for n in names)


def _handler_swallows(handler: ast.ExceptHandler) -> bool:
    """True when the body neither re-raises, nor logs, nor uses the bound
    exception (recording it somewhere counts as handling)."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return False
        if isinstance(node, ast.Name) and handler.name and \
                node.id == handler.name and isinstance(node.ctx, ast.Load):
            return False
        if isinstance(node, ast.Call):
            callee = _call_name(node)
            chain = _attr_chain(node.func)
            if callee in _LOG_METHODS and ("logger" in chain or
                                           "logging" in chain or
                                           "stderr" in chain or
                                           "stdout" in chain):
                return False
            if callee in ("record_recovery", "format_exc", "print_exc"):
                return False
    return True


@rule("broad-except", severity="error",
      doc="No `except Exception` / bare `except` that swallows silently: "
          "the handler must re-raise, log, or use the caught exception — "
          "or the except type must be narrowed.",
      fixture_fail=_BROAD_FIXTURE_FAIL, fixture_pass=_BROAD_FIXTURE_PASS)
def broad_except(project: Project):
    for mod in project.modules:
        for node in mod.nodes:
            if isinstance(node, ast.ExceptHandler) and _is_broad(node) and \
                    _handler_swallows(node):
                yield _finding(
                    mod, node,
                    "broad except swallows the exception without logging, "
                    "re-raising, or recording it — narrow the type or add "
                    "context (trace/job id) to a log line")


# ============================================================ 11. dtype-flow
# Precision hazards in the NUMERICS-declaring modules: a tensor
# constructor with no dtype= takes the process's default dtype or an
# inferred one, so a set_default_dtype elsewhere (or a Python int where a
# float was meant) silently changes the declared-f32 program; a float64
# numpy array that reaches torch.from_numpy/as_tensor/tensor uncast puts
# an f64 tensor on the card and promotes every op it meets; and any TF32
# switch rounds the integer-grid band sums of the ion images to ~11 bits
# (the static half of models/msm_torch.resolve_device's runtime check,
# checked across the whole package).  Deliberate escapes are annotated
# `# smlint: dtype-ok[reason]`.
_TORCH_CONSTRUCTORS = ("tensor", "zeros", "ones", "full", "arange", "empty")
_TORCH_UPLOADS = ("from_numpy", "as_tensor", "tensor")
_CAST_METHODS = ("float", "half", "bfloat16", "int", "long", "short",
                 "bool", "byte", "char")
_F64_NAMES = ("float64", "double")

_DF_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/ops/x.py": (
        "import numpy as np\n"
        "import torch\n"
        "from ..analysis.numerics import numerics_surface\n"
        "NUMERICS = numerics_surface(__name__, {\n"
        "    'score': 'contract=ulp(4); test=tests/test_x.py::test_score',\n"
        "})\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "def score(x, host):\n"
        "    idx = torch.arange(x.shape[0], device=x.device)\n"
        "    w = host.astype(np.float64)\n"
        "    t = torch.from_numpy(w).to(x.device)\n"
        "    torch.set_float32_matmul_precision('high')\n"
        "    return x * t + idx\n"
    ),
}
_DF_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/ops/x.py": (
        "import numpy as np\n"
        "import torch\n"
        "from ..analysis.numerics import numerics_surface\n"
        "NUMERICS = numerics_surface(__name__, {\n"
        "    'score': 'contract=ulp(4); test=tests/test_x.py::test_score',\n"
        "})\n"
        "torch.backends.cuda.matmul.allow_tf32 = False\n"
        "def score(x, host):\n"
        "    idx = torch.arange(x.shape[0], dtype=torch.int64, "
        "device=x.device)\n"
        "    w = host.astype(np.float64)\n"
        "    t = torch.from_numpy(w).float().to(x.device)\n"
        "    # smlint: dtype-ok[the f64 thresholds are the oracle's, exact]\n"
        "    u = torch.from_numpy(w).to(x.device)\n"
        "    torch.set_float32_matmul_precision('highest')\n"
        "    return x * t + idx + u\n"
    ),
}


def _is_f64_dtype_expr(e: ast.AST) -> bool:
    """``np.float64`` / ``torch.float64`` / ``torch.double`` /
    ``"float64"`` / bare ``float`` used as a dtype value."""
    chain = _attr_chain(e)
    if chain.split(".")[-1] in _F64_NAMES:
        return True
    if isinstance(e, ast.Name) and e.id == "float":
        return True
    return _const_str(e) in ("float64", "double")


def _f64_source(node: ast.AST) -> bool:
    """Taint source for the f64-flow walk: a ``np.float64``/``np.double``
    mint, an ``.astype(float64-ish)`` cast, or any call carrying a
    ``dtype=float64-ish`` keyword."""
    if not isinstance(node, ast.Call):
        return False
    callee = _call_name(node)
    if callee in _F64_NAMES and \
            _attr_chain(node.func).split(".")[0] in ("np", "numpy"):
        return True
    if callee == "astype" and node.args and _is_f64_dtype_expr(node.args[0]):
        return True
    return any(kw.arg == "dtype" and _is_f64_dtype_expr(kw.value)
               for kw in node.keywords)


def _cast_after(mod, call: ast.Call) -> bool:
    """Is the tensor ``call`` makes cast right away: ``.float()`` (or
    another cast method), or ``.to(<dtype>)`` with a non-f64 dtype?"""
    parent = mod.parents.get(call)
    if not (isinstance(parent, ast.Attribute) and parent.value is call):
        return False
    grand = mod.parents.get(parent)
    if not (isinstance(grand, ast.Call) and grand.func is parent):
        return False
    if parent.attr in _CAST_METHODS:
        return True
    if parent.attr == "to":
        kw = {k.arg: k.value for k in grand.keywords if k.arg}
        target = kw.get("dtype", grand.args[0] if grand.args else None)
        return target is not None and \
            _attr_chain(target).startswith("torch.") and \
            _attr_chain(target) != "torch.device" and \
            not _is_f64_dtype_expr(target)
    return False


def _tf32_switch(node: ast.AST) -> str | None:
    """The TF32 switch ``node`` throws: ``*.allow_tf32 = True``, a
    ``*.fp32_precision`` other than "ieee", or
    ``set_float32_matmul_precision`` other than "highest"."""
    if isinstance(node, ast.Assign):
        for t in node.targets:
            leaf = _attr_chain(t).split(".")[-1]
            v = node.value
            if leaf == "allow_tf32" and not (
                    isinstance(v, ast.Constant) and v.value is False):
                return f"{_attr_chain(t)} = {ast.unparse(v)}"
            if leaf == "fp32_precision" and _const_str(v) != "ieee":
                return f"{_attr_chain(t)} = {ast.unparse(v)}"
    if isinstance(node, ast.Call) and \
            _call_name(node) == "set_float32_matmul_precision" and \
            not (node.args and _const_str(node.args[0]) == "highest"):
        return ast.unparse(node)
    return None


def _numerics_decl(mod) -> tuple[dict[str, tuple[str, int]] | None, int]:
    """The module's ``NUMERICS = numerics_surface(_, {...})`` declaration:
    ({site: (policy, lineno)}, decl lineno), or (None, 0)."""
    for node in mod.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1 and
                isinstance(node.targets[0], ast.Name) and
                node.targets[0].id == "NUMERICS"):
            continue
        if not (isinstance(node.value, ast.Call) and
                _call_name(node.value) == "numerics_surface" and
                len(node.value.args) >= 2 and
                isinstance(node.value.args[1], ast.Dict)):
            return {}, node.lineno    # declared but not the literal grammar
        out = {}
        for k, v in zip(node.value.args[1].keys, node.value.args[1].values):
            ks, vs = _const_str(k), _const_str(v)
            if ks is not None:
                out[ks] = (vs or "", getattr(k, "lineno", node.lineno))
        return out, node.lineno
    return None, 0


@rule("dtype-flow", severity="error",
      doc="Across the package no TF32 switch (allow_tf32 = True, "
          "fp32_precision other than 'ieee', set_float32_matmul_precision "
          "other than 'highest').  In NUMERICS-declaring modules: torch "
          "constructors (tensor/zeros/ones/full/arange/empty) must pass "
          "dtype= (else the default or an inferred dtype decides), and "
          "float64 numpy values (np.float64 mints, .astype(float64), "
          "dtype=float64 kwargs; tracked through locals and single-level "
          "call summaries) must not reach torch.from_numpy/as_tensor/tensor "
          "without a cast.  Deliberate escapes carry "
          "`# smlint: dtype-ok[reason]` (empty reason = finding).",
      fixture_fail=_DF_FIXTURE_FAIL, fixture_pass=_DF_FIXTURE_PASS)
def dtype_flow(project: Project):
    for mod in project.modules:
        if not project.in_package(mod.path):
            continue

        def check(node, message):
            reason = mod.annotation_reason("dtype", node.lineno)
            if reason:
                return None
            return _finding(
                mod, node, message + " — or annotate `# smlint: "
                "dtype-ok[reason]`" + (" (annotation reason is empty)"
                                       if reason == "" else ""))

        for node in mod.nodes:
            what = _tf32_switch(node)
            if what is not None:
                f = check(node, f"TF32 switch `{what}`: f32 matmuls must "
                                f"stay at full precision (TF32 rounds the "
                                f"integer-grid band sums)")
                if f is not None:
                    yield f
        decl, _ = _numerics_decl(mod)
        if decl is None:
            continue                  # not a declared-precision module
        for node in mod.nodes:
            if isinstance(node, ast.Call) and \
                    _attr_chain(node.func) in {
                        f"torch.{c}" for c in _TORCH_CONSTRUCTORS} and \
                    not any(kw.arg == "dtype" for kw in node.keywords):
                f = check(node, f"{_attr_chain(node.func)}() without dtype= "
                                f"in a declared-precision module takes the "
                                f"default or an inferred dtype — pass "
                                f"dtype= explicitly")
                if f is not None:
                    yield f
        summaries = dataflow.summaries.get(mod)
        for fn in mod.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            taint = TaintTracker(source=_f64_source, summaries=summaries)
            for node in taint.walk(mod, fn):
                if not (isinstance(node, ast.Call) and
                        _attr_chain(node.func) in {
                            f"torch.{c}" for c in _TORCH_UPLOADS}):
                    continue
                kw = {k.arg: k.value for k in node.keywords if k.arg}
                if "dtype" in kw and not _is_f64_dtype_expr(kw["dtype"]):
                    continue          # cast on the way in
                if not (node.args and taint.expr_tainted(node.args[0])) \
                        or _cast_after(mod, node):
                    continue
                f = check(node, f"a float64 numpy value reaches "
                                f"{_attr_chain(node.func)}() uncast in a "
                                f"declared-f32 module — the f64 tensor "
                                f"promotes every op it meets; cast to the "
                                f"declared dtype first")
                if f is not None:
                    yield f


# ======================================================= 12. masked-reduction
# The shape-bucket lattice pads pixel rows and resident peaks; any
# reduction over an axis carrying that padding that skips the n_real
# masked helpers (batch_metrics(n_real=), the batch_moments family, the
# fused window moments) produces wrong-but-plausible metrics.  Taint
# enters a function through parameters its NUMERICS entry declares
# `padded=` and through ops/buckets padding-helper calls; raw reductions
# over tainted values fire unless annotated `# smlint: masked-ok[reason]`
# (the argument why THIS reduction is pad-invariant).
# masked helper -> position of its n_real argument (None: keyword only)
_MASKED_HELPERS = {"batch_metrics": None, "batch_moments": 1,
                   "batch_moments_torch": 1, "fused_window_moments": 4,
                   "fused_window_moments_torch": 4}
_REDUCTION_METHODS = ("sum", "mean", "amax", "amin", "max", "min", "prod",
                      "std", "var", "count_nonzero", "matmul")
_REDUCTION_FUNCS = _REDUCTION_METHODS + ("einsum", "tensordot", "mm", "bmm")
_BUCKET_PAD_HELPERS = ("row_bucket", "peak_bucket", "pixel_bucket",
                       "band_bucket")


def _bucket_pad_source(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        _call_name(node) in _BUCKET_PAD_HELPERS


def _masked_helper_clears(call: ast.Call) -> bool:
    """A masked-helper call consuming the padded block TOGETHER with its
    real-element count launders the taint."""
    callee = _call_name(call)
    if callee not in _MASKED_HELPERS:
        return False
    if any(kw.arg == "n_real" for kw in call.keywords):
        return True
    pos = _MASKED_HELPERS[callee]
    return pos is not None and len(call.args) > pos


_MR_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/ops/x.py": (
        "import torch\n"
        "from ..analysis.numerics import numerics_surface\n"
        "NUMERICS = numerics_surface(__name__, {\n"
        "    'score': 'contract=bit_exact; test=tests/test_x.py::test_s; "
        "padded=images',\n"
        "})\n"
        "def score(images, theor, n_real):\n"
        "    mean = images.mean(dim=-1)\n"
        "    dots = images @ theor\n"
        "    return mean, torch.amax(images, dim=-1), dots\n"
    ),
}
_MR_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/ops/x.py": (
        "import torch\n"
        "from ..analysis.numerics import numerics_surface\n"
        "from .metrics import batch_metrics\n"
        "NUMERICS = numerics_surface(__name__, {\n"
        "    'score': 'contract=bit_exact; test=tests/test_x.py::test_s; "
        "padded=images',\n"
        "})\n"
        "def score(images, theor, nv, n_real):\n"
        "    out = batch_metrics(images, theor, nv, 8, 8, n_real=n_real)\n"
        "    # smlint: masked-ok[zero pads are never positive; the count "
        "is exact]\n"
        "    npos = (images > 0).sum(dim=-1)\n"
        "    return out.sum(dim=0), npos\n"
    ),
}


@rule("masked-reduction", severity="error",
      doc="In NUMERICS-declaring modules, reductions (sum/mean/amax/amin/"
          "max/min/prod/std/var/count_nonzero, matmul and `@`, einsum) over "
          "values tainted by lattice padding — parameters the site's "
          "NUMERICS entry declares `padded=`, or locals derived from "
          "ops/buckets padding helpers (row_bucket/peak_bucket/"
          "pixel_bucket/band_bucket) — must flow through the n_real "
          "masked helpers (batch_metrics(n_real=), batch_moments(x, "
          "n_real), fused_window_moments(..., n_real)) or carry a "
          "`# smlint: masked-ok[reason]` annotation arguing "
          "pad-invariance.  Taint is structural: a masked-helper call's "
          "RESULT is clean; everything else propagates.",
      fixture_fail=_MR_FIXTURE_FAIL, fixture_pass=_MR_FIXTURE_PASS)
def masked_reduction(project: Project):
    for mod in project.modules:
        if not project.in_package(mod.path):
            continue
        decl, _ = _numerics_decl(mod)
        if not decl:
            continue
        padded: dict[str, set[str]] = {}
        for site, (policy, _ln) in decl.items():
            try:
                parsed = numerics_mod.parse_policy(policy)
            except ValueError:
                continue              # ulp-contract owns grammar findings
            if "padded" in parsed:
                padded[site] = {p.strip()
                                for p in parsed["padded"].split(",")}
        for fn in mod.nodes:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            taint = TaintTracker(source=_bucket_pad_source,
                                 call_clears=_masked_helper_clears,
                                 structural=True)
            params = {a.arg for a in (fn.args.posonlyargs + fn.args.args +
                                      fn.args.kwonlyargs)}
            taint.names |= padded.get(fn.name, set()) & params
            for node in taint.walk(mod, fn):
                what = None
                if isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.MatMult):
                    if taint.expr_tainted_rec(node.left) or \
                            taint.expr_tainted_rec(node.right):
                        what = "`@`"
                elif isinstance(node, ast.Call):
                    callee = _call_name(node)
                    chain = _attr_chain(node.func)
                    if callee in _REDUCTION_FUNCS and \
                            chain.split(".")[0] == "torch":
                        parts = list(node.args) + \
                            [kw.value for kw in node.keywords]
                        if any(taint.expr_tainted_rec(p) for p in parts):
                            what = f"{chain}()"
                    elif isinstance(node.func, ast.Attribute) and \
                            callee in _REDUCTION_METHODS and \
                            chain.split(".")[0] not in ("torch", "np",
                                                        "numpy"):
                        if taint.expr_tainted_rec(node.func.value):
                            what = f".{callee}()"
                if what is None:
                    continue
                reason = mod.annotation_reason("masked", node.lineno)
                if reason:
                    continue
                if reason == "":
                    yield _finding(
                        mod, node,
                        f"masked-ok annotation for {what} has an empty "
                        f"reason — the pad-invariance argument is the "
                        f"point")
                else:
                    yield _finding(
                        mod, node,
                        f"{what} reduces over a lattice-padded axis "
                        f"without the n_real masked helpers "
                        f"(batch_metrics(n_real=)/batch_moments) — pad "
                        f"slots silently join the reduction; route "
                        f"through a masked helper or annotate "
                        f"`# smlint: masked-ok[why pad-invariant]`")


# ========================================================== 13. ulp-contract
_UC_FIXTURE_FAIL = {
    "sm_distributed_tpu_torch/ops/x.py": (
        "from ..analysis.numerics import numerics_surface\n"
        "from ..kernels import _build\n"
        "NUMERICS = numerics_surface(__name__, {\n"
        "    'score': 'contract=ulp(4); test=tests/test_x.py::test_gone',\n"
        "    'ghost': 'contract=bit_exact; test=tests/test_x.py::test_a',\n"
        "})\n"
        "def _launch(x):\n"
        "    return _build.ready('moments', x.device)\n"
        "def score(x):\n"
        "    return _launch(x)\n"
        "def other(x):\n"
        "    return _route(_launch, x)\n"
    ),
    "aux": {"tests/test_x.py": "def test_a():\n    pass\n"},
}
_UC_FIXTURE_PASS = {
    "sm_distributed_tpu_torch/ops/x.py": (
        "from ..analysis.numerics import numerics_surface\n"
        "from ..kernels import _build\n"
        "NUMERICS = numerics_surface(__name__, {\n"
        "    'score': 'contract=bit_exact; test=tests/test_x.py::test_a',\n"
        "})\n"
        "def _launch(x):\n"
        "    return _build.ready('moments', x.device)\n"
        "def score(x):\n"
        "    return _launch(x)\n"
        "def plan(n):\n"
        "    return n + 1\n"
    ),
    "aux": {"tests/test_x.py": "def test_a():\n    assert True\n"},
}


def _module_functions(mod) -> dict[str, ast.AST]:
    """Every function defined in ``mod`` by its name and, for methods and
    nested functions, by its qualified ``Class.method`` name too."""
    out: dict[str, ast.AST] = {}
    for n in mod.nodes:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(n.name, n)
            q = mod.qualname(n)
            if q:
                out[f"{q}.{n.name}"] = n
    return out


def _reaches_launch(mod) -> set[str]:
    """Names of the module's functions that reach a kernel launch: the
    launch sites (they call ``_build.ready``) and, to a fixed point, every
    function of the module that names one (a call, or a launch function
    passed as an argument)."""
    fns = {n.name: n for n in mod.nodes
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    refs = {name: {n.id for n in dataflow.function_nodes(mod, fn)
                   if isinstance(n, ast.Name) and n.id in fns}
            for name, fn in fns.items()}
    reach = {fn.name for fn, _call, _lib in _launch_sites(mod)}
    grew = True
    while grew:
        grew = False
        for name, names in refs.items():
            if name not in reach and names & reach:
                reach.add(name)
                grew = True
    return reach


@rule("ulp-contract", severity="error",
      doc="Every NUMERICS = numerics_surface(__name__, {...}) entry must "
          "name a function of its module and parse in the grammar "
          "`contract=bit_exact|ulp(N); test=<file>.py::<name>"
          "[; padded=<params>]`, its test file must exist and define the "
          "test, and its padded= parameters must be the function's; every "
          "public function of a NUMERICS-declaring module that reaches a "
          "kernel launch (a _build.ready site, through the module's own "
          "calls or a launch function passed along) must be declared; and "
          "a module that declares a KERNEL_SURFACE must declare NUMERICS.",
      fixture_fail=_UC_FIXTURE_FAIL, fixture_pass=_UC_FIXTURE_PASS)
def ulp_contract(project: Project):
    for mod in project.modules:
        if not project.in_package(mod.path):
            continue
        surface, surface_line = _surface_decl(mod)
        decl, decl_line = _numerics_decl(mod)
        if decl is None:
            if surface is not None:
                yield Finding(
                    "", "", mod.path, surface_line or 1,
                    f"module declares a KERNEL_SURFACE ({len(surface)} "
                    f"site(s)) but no NUMERICS = numerics_surface(__name__, "
                    f"{{...}}) registry — every kernel-reaching scoring "
                    f"function needs a declared numerics contract",
                    anchor="NUMERICS")
            continue
        fns = _module_functions(mod)
        imported = {a.asname or a.name for n in mod.nodes
                    if isinstance(n, ast.ImportFrom) for a in n.names}
        for name in sorted(_reaches_launch(mod)):
            if not name.startswith("_") and name not in decl:
                yield Finding(
                    "", "", mod.path, fns[name].lineno,
                    f"public function {name!r} reaches a kernel launch but "
                    f"has no NUMERICS contract — declare contract=bit_exact "
                    f"or ulp(N) with its proving test",
                    anchor=f"NUMERICS.{name}")
        for site, (policy, lineno) in sorted(decl.items()):
            try:
                parsed = numerics_mod.parse_policy(policy)
            except ValueError as exc:
                yield Finding(
                    "", "", mod.path, lineno,
                    f"NUMERICS entry {site!r}: {exc}",
                    anchor=f"NUMERICS.{site}")
                continue
            if site not in fns and site not in imported:
                yield Finding(
                    "", "", mod.path, lineno,
                    f"NUMERICS entry {site!r} names no function defined in "
                    f"or imported into this module (dead entry — remove it "
                    f"or fix the site name)", anchor=f"NUMERICS.{site}")
                continue
            test_path, _, test_name = parsed["test"].partition("::")
            src = project.read(test_path)
            if src is None:
                tmod = project.module(test_path)
                src = tmod.source if tmod is not None else None
            if src is None:
                yield Finding(
                    "", "", mod.path, lineno,
                    f"NUMERICS entry {site!r}: contract test file "
                    f"{test_path!r} does not exist — a contract without "
                    f"its proving test is an unbacked promise",
                    anchor=f"NUMERICS.{site}.test")
            elif f"def {test_name}(" not in src:
                yield Finding(
                    "", "", mod.path, lineno,
                    f"NUMERICS entry {site!r}: {test_path!r} does not "
                    f"define {test_name!r} — the contract's "
                    f"cross-referenced test is gone",
                    anchor=f"NUMERICS.{site}.test")
            if "padded" in parsed:
                fn = fns.get(site)
                if fn is None:
                    yield Finding(
                        "", "", mod.path, lineno,
                        f"NUMERICS entry {site!r} declares padded= but "
                        f"names no function defined in this module the "
                        f"parameters could belong to",
                        anchor=f"NUMERICS.{site}.padded")
                    continue
                params = {a.arg for a in (
                    fn.args.posonlyargs + fn.args.args +
                    fn.args.kwonlyargs)}
                for p in parsed["padded"].split(","):
                    if p.strip() not in params:
                        yield Finding(
                            "", "", mod.path, lineno,
                            f"NUMERICS entry {site!r}: padded "
                            f"parameter {p.strip()!r} is not a "
                            f"parameter of {site}()",
                            anchor=f"NUMERICS.{site}.padded")


def numerics_census(project: Project) -> dict[str, int]:
    """Static totals for the smlint JSON artifact: declared numerics
    contracts and the modules carrying a registry."""
    contracts = modules = 0
    for mod in project.modules:
        if not project.in_package(mod.path):
            continue
        decl, _ = _numerics_decl(mod)
        if decl:
            modules += 1
            contracts += len(decl)
    return {"contracts": contracts, "modules": modules}
