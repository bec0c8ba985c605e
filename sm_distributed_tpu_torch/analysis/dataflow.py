"""Forward-dataflow / taint engine over the parsed Project AST — a copy of
``sm_distributed_tpu/analysis/dataflow.py`` for the port's smlint, unchanged
in behaviour (``tests/test_torch_dataflow.py`` runs the JAX package's cases
through it).

The ad-hoc taint walks that grew inside individual rules — ``fence-gate``'s
terminal-dir path locals, ``spec-key-hazard``'s raw-shape locals — share one
shape: walk a function's own nodes in ``ast.walk`` order, grow a set of
tainted single-target locals as assignments stream past, and let sink
checks consult the set mid-walk.  This module is that shape, factored out
so new rules (``dtype-flow``, ``masked-reduction``) get dataflow for the
price of a seed predicate instead of another bespoke walker:

- :func:`function_nodes` — the nodes belonging to one function itself
  (nested defs/lambdas excluded), in the same breadth-first order the
  original rules used.  Sink checks interleaved with taint growth keep
  the legacy semantics exactly: a sink that appears before its taint
  assignment in walk order stays unflagged, which is what the refactored
  rules' snapshot-parity test (tests/test_dataflow.py) pins;
- :class:`TaintTracker` — the per-function taint state: a *source*
  predicate over AST nodes, an optional *sanitizer* that clears a whole
  expression (the retrace rule's "any bucketing call kills the expr"
  semantics), flat (`expr_tainted`) and structural (`expr_tainted_rec`)
  queries, and assignment observation (single-target names; tuple
  targets in structural mode);
- :func:`def_use` — per-function def-use chains over single-target
  locals (the inspection surface tests/test_dataflow.py exercises, and
  the base of the call summaries);
- :func:`module_summaries` / :class:`SummaryCache` — SINGLE-LEVEL call
  summaries: for each function defined in a module, which parameters
  flow into its return value (through single-target locals).  A tracker
  given summaries lets taint cross exactly one call boundary —
  ``helper(x)`` is tainted when ``x`` is tainted and ``helper`` returns
  a param-derived value.  Summaries of summaries are deliberately NOT
  taken: the engine stays intra-procedural with one-level summaries, as
  the rule catalog documents.

The summary cache is process-shared mutable state (smlint, its
``--self-check`` fixture replays, and the in-process test harness all
lint concurrently-parsed projects), so it carries a ``_GUARDED_BY``
registry and a leaf lock like every other shared structure in the tree.
"""

from __future__ import annotations

import ast
import threading
from dataclasses import dataclass, field


def function_nodes(mod, fn):
    """Yield the nodes that belong to ``fn`` ITSELF — the function node,
    then its body in ``ast.walk`` (breadth-first) order — skipping
    anything owned by a nested def/lambda.  This is the shared walk
    every dataflow-backed rule iterates."""
    for node in ast.walk(fn):
        if mod.enclosing_function(node) is not fn and node is not fn:
            continue
        yield node


# ------------------------------------------------------------------- taint
class TaintTracker:
    """Forward taint over one function's locals.

    ``source(node) -> bool`` marks primitive taint origins (a raw
    ``.shape`` read, a terminal-dir string constant, an ``np.float64``
    call).  ``sanitizer(node) -> bool`` marks calls that launder a whole
    expression — in flat mode, ONE sanitizer anywhere in an expression
    clears it entirely (the ``spec-key-hazard`` contract).

    ``summaries`` ({fn name: (param names, flowing-param set)}) lets the
    structural query cross one call level; ``call_clears(call) -> bool``
    marks calls whose RESULT is clean regardless of arguments (e.g. the
    masked-metrics helpers consuming a padded block together with its
    real-pixel count)."""

    def __init__(self, source=None, sanitizer=None, summaries=None,
                 call_clears=None, structural: bool = False):
        self.source = source
        self.sanitizer = sanitizer
        self.summaries = summaries or {}
        self.call_clears = call_clears
        self.structural = structural
        self.names: set[str] = set()

    # ------------------------------------------------------------- queries
    def expr_tainted(self, expr: ast.AST) -> bool:
        """Flat query, legacy parity: a sanitizer anywhere in ``expr``
        clears it; otherwise any source node or tainted-name load taints
        the whole expression."""
        if self.sanitizer is not None and any(
                self.sanitizer(n) for n in ast.walk(expr)):
            return False
        for n in ast.walk(expr):
            if self.source is not None and self.source(n):
                return True
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) and \
                    n.id in self.names:
                return True
            if self._summary_call_tainted(n):
                return True
        return False

    def expr_tainted_rec(self, expr: ast.AST) -> bool:
        """Structural query: calls are evaluated as calls — a clearing
        call's result is clean even when its arguments are tainted, and
        summaries decide whether taint passes through a known callee."""
        if self.sanitizer is not None and self.sanitizer(expr):
            return False
        if isinstance(expr, ast.Call):
            if self.call_clears is not None and self.call_clears(expr):
                return False
            if self.source is not None and self.source(expr):
                return True           # e.g. a padding-helper call IS taint
            callee = expr.func.id if isinstance(expr.func, ast.Name) else (
                expr.func.attr if isinstance(expr.func, ast.Attribute)
                else "")
            if callee in self.summaries:
                # a summarized callee is AUTHORITATIVE: taint passes only
                # through parameters that flow to its return value
                return self._summary_call_tainted(expr)
            parts = list(expr.args) + [kw.value for kw in expr.keywords]
            if isinstance(expr.func, ast.Attribute):
                parts.append(expr.func.value)   # method receiver
            return any(self.expr_tainted_rec(p) for p in parts)
        if isinstance(expr, ast.Name):
            return isinstance(expr.ctx, ast.Load) and expr.id in self.names
        if self.source is not None and self.source(expr):
            return True
        return any(self.expr_tainted_rec(c)
                   for c in ast.iter_child_nodes(expr))

    def _summary_call_tainted(self, node: ast.AST) -> bool:
        """A call through a summarized function is tainted iff an
        argument bound to a return-flowing parameter is tainted."""
        if not (isinstance(node, ast.Call) and self.summaries):
            return False
        callee = node.func.id if isinstance(node.func, ast.Name) else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")
        summary = self.summaries.get(callee)
        if summary is None:
            return False
        params, flowing = summary
        check = self.expr_tainted_rec if self.structural else \
            self.expr_tainted
        for i, a in enumerate(node.args):
            if i < len(params) and params[i] in flowing and check(a):
                return True
        for kw in node.keywords:
            if kw.arg in flowing and check(kw.value):
                return True
        return False

    # ----------------------------------------------------------- mutation
    def observe(self, node: ast.AST) -> None:
        """Grow the taint set from one statement: single-target name
        assignments always; tuple-unpack targets in structural mode (a
        tainted call result taints every unpacked name)."""
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            return
        t = node.targets[0]
        check = self.expr_tainted_rec if self.structural else \
            self.expr_tainted
        if isinstance(t, ast.Name):
            if check(node.value):
                self.names.add(t.id)
        elif self.structural and isinstance(t, ast.Tuple):
            if check(node.value):
                for el in t.elts:
                    if isinstance(el, ast.Name):
                        self.names.add(el.id)

    def walk(self, mod, fn):
        """Observe-then-yield every node of ``fn``: the rule's sink
        checks run against exactly the taint state the legacy in-line
        walks maintained."""
        for node in function_nodes(mod, fn):
            self.observe(node)
            yield node


# --------------------------------------------------------------- def-use
@dataclass
class DefUse:
    """Per-function def-use chains over single-target local names."""

    defs: dict[str, list[ast.Assign]] = field(default_factory=dict)
    uses: dict[str, list[ast.Name]] = field(default_factory=dict)

    def chain(self, name: str) -> tuple[list[ast.Assign], list[ast.Name]]:
        return self.defs.get(name, []), self.uses.get(name, [])


def def_use(mod, fn) -> DefUse:
    """Def-use chains for ``fn``: definitions are single-target name
    assignments (the only binding form the taint engine propagates
    through), uses are name LOADS."""
    du = DefUse()
    for node in function_nodes(mod, fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            du.defs.setdefault(node.targets[0].id, []).append(node)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            du.uses.setdefault(node.id, []).append(node)
    return du


# --------------------------------------------------- single-level summaries
def _fn_summary(mod, fn) -> tuple[tuple[str, ...], frozenset[str]]:
    """(parameter names, subset that flows to a return value) — flow is
    through single-target locals, one forward pass in walk order."""
    params = tuple(a.arg for a in (
        fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs))
    reaching: dict[str, set[str]] = {p: {p} for p in params}
    flowing: set[str] = set()

    def roots(expr: ast.AST) -> set[str]:
        out: set[str] = set()
        for n in ast.walk(expr):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                out |= reaching.get(n.id, set())
        return out

    for node in function_nodes(mod, fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            reaching[node.targets[0].id] = roots(node.value)
        elif isinstance(node, ast.Return) and node.value is not None:
            flowing |= roots(node.value)
    return params, frozenset(flowing & set(params))


def module_summaries(mod) -> dict[str, tuple[tuple[str, ...], frozenset]]:
    """{function name: (params, return-flowing params)} for every def in
    ``mod`` — the SINGLE call level a tracker may cross.  Later
    definitions of a reused name win (matching runtime shadowing)."""
    out: dict[str, tuple] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _fn_summary(mod, node)
    return out


class SummaryCache:
    """Bounded process-wide memo of per-module call summaries (smlint
    re-lints the same parsed modules across rules and fixture replays).
    Keyed on (path, source hash) so a re-parsed module with edited
    source never serves a stale summary."""

    _GUARDED_BY = {"_cache": "_lock"}
    _MAX = 512

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: dict[tuple, dict] = {}

    def get(self, mod) -> dict[str, tuple]:
        key = (mod.path, hash(mod.source))
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return hit
        val = module_summaries(mod)
        with self._lock:
            self._cache[key] = val
            while len(self._cache) > self._MAX:
                self._cache.pop(next(iter(self._cache)))
        return val

    def clear(self) -> None:
        with self._lock:
            self._cache.clear()


summaries = SummaryCache()
