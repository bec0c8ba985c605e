"""Every port class whose JAX counterpart declares a ``_GUARDED_BY``
registry (which attributes each lock guards) declares the same one.

Every registry of the JAX package's service is listed, the primer and
its bucket-spec registry, the fleet controller, the fleet view and the
numerics-contract registry included; ``PORT_LACKS`` (classes of modules
the port does not have) is empty.  An entry for state the port's class does not keep is left out of
its registry, listed in ``PORT_OMITS``.
"""

from __future__ import annotations

import importlib

import pytest

# (module path under each package, class name)
CLASSES = [
    ("service.scheduler", "JobScheduler"),
    ("service.device_pool", "DevicePool"),
    ("service.health", "HealthTracker"),
    ("service.leases", "ReplicaRegistry"),
    ("service.resources", "ResourceGovernor"),
    ("service.admission", "AdmissionController"),
    ("service.telemetry", "DeviceMonitor"),
    ("service.telemetry", "SLOTracker"),
    ("service.metrics", "_Metric"),
    ("service.metrics", "_CounterChild"),
    ("service.metrics", "_GaugeChild"),
    ("service.metrics", "_HistogramChild"),
    ("service.metrics", "MetricsRegistry"),
    ("service.readpath", "ReadCache"),
    ("service.readpath", "ReadPath"),
    ("engine.residency", "_LRU"),
    ("models.breaker", "CircuitBreaker"),
    ("models.oom", "_GuardedRegistry"),
    ("ops.isocalc", "PatternStream"),
    ("ops.isocalc", "IsocalcWrapper"),
    ("utils.tracing", "FlightRecorder"),
    ("utils.cancel", "CancelToken"),
    ("service.primer", "CachePrimer"),
    ("service.primer", "_PrimeManifest"),
    ("ops.buckets", "_SpecRegistry"),
    ("service.fleet", "FleetController"),
    ("service.fleetview", "FleetView"),
    ("analysis.numerics", "_NumericsRegistry"),
]
PORT_LACKS: set = set()
# JAX registry entries whose attribute the port's class does not have
PORT_OMITS = {("ops.isocalc", "PatternStream"): {"_done"}}


def _cls(pkg: str, mod: str, name: str):
    return getattr(importlib.import_module(f"{pkg}.{mod}"), name)


@pytest.mark.parametrize("mod,name", CLASSES,
                         ids=[f"{m}.{c}" for m, c in CLASSES])
def test_guarded_by_equals_the_jax_packages(mod, name):
    jax_cls = _cls("sm_distributed_tpu", mod, name)
    port_cls = _cls("sm_distributed_tpu_torch", mod, name)
    assert "_GUARDED_BY" in vars(jax_cls)
    omits = PORT_OMITS.get((mod, name), set())
    want = {k: v for k, v in vars(jax_cls)["_GUARDED_BY"].items()
            if k not in omits}
    assert vars(port_cls).get("_GUARDED_BY") == want


@pytest.mark.parametrize("mod,name", sorted(PORT_OMITS),
                         ids=[f"{m}.{c}" for m, c in sorted(PORT_OMITS)])
def test_omitted_entries_name_state_the_port_lacks(mod, name):
    """An omitted entry is one the JAX registry has and the port's class
    never assigns: no ``self.<attr>`` anywhere in the port's class."""
    import ast
    import inspect
    import textwrap

    jax_cls = _cls("sm_distributed_tpu", mod, name)
    port_cls = _cls("sm_distributed_tpu_torch", mod, name)
    tree = ast.parse(textwrap.dedent(inspect.getsource(port_cls)))
    assigned = {t.attr for node in ast.walk(tree)
                if isinstance(node, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign))
                for t in (node.targets if isinstance(node, ast.Assign)
                          else [node.target])
                if isinstance(t, ast.Attribute)}
    for attr in PORT_OMITS[(mod, name)]:
        assert attr in vars(jax_cls)["_GUARDED_BY"]
        assert attr not in assigned


def test_every_jax_registry_is_listed():
    """The list above is complete: every JAX-package class with a
    registry is either in it or of a module the port lacks."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent / "sm_distributed_tpu"
    found = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ClassDef) and any(
                    isinstance(s, ast.Assign) and any(
                        getattr(t, "id", None) == "_GUARDED_BY"
                        for t in s.targets) for s in node.body):
                rel = path.relative_to(root).with_suffix("")
                found.add((".".join(rel.parts), node.name))
    listed = set(CLASSES)
    unlisted = {c for c in found - listed
                if not c[0].startswith("analysis.")}
    assert unlisted <= PORT_LACKS, sorted(unlisted - PORT_LACKS)
