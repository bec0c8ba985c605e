"""The port's surface census: everything a user of the JAX package can name
has a counterpart in the port or a written departure.

The census reads both trees with ``ast`` and JSON and imports neither
package.  It holds the JAX package (``sm_distributed_tpu/``) to the port
(``sm_distributed_tpu_torch/``) on six surfaces:

- **modules**: every ``*.py`` maps to a port module of the same path, or
  of the path :data:`MODULE_RENAMES` gives, or is in :data:`OUT_OF_SCOPE`;
- **names**: every public top-level function and class (no leading ``_``)
  and every public method of a public class is bound under the same name
  in the mapped module, or under the name :data:`RENAMES` gives
  (``"name"`` in the mapped module, ``"path.py::name"`` elsewhere), or is
  a :data:`DEPARTURES` entry;
- **config**: every key of ``conf/config.json.template`` is a key of
  ``conf/config_torch.json.template`` (``__doc*__`` entries are comments);
- **cli**: every subcommand and argument of ``engine/cli.py``;
- **routes**: every literal route path of ``service/``;
- **metrics**: every ``sm_*`` family registered through a registry's
  ``counter``/``gauge``/``histogram`` is registered by the port, or
  renamed in :data:`METRIC_RENAMES`, or a :data:`METRIC_DEPARTURES` entry.

An entry is **stale**, and fails the census like a missing name, when its
JAX name no longer exists, when its port name is missing, or when a
departure names something the port has after all.  Every departure carries
its one-line reason.  This file is the written record of the port's
departures from the JAX package's surface; ROADMAP.md points here.
"""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "sm_distributed_tpu"
PORT = ROOT / "sm_distributed_tpu_torch"

# JAX module -> port module, where the path differs
MODULE_RENAMES = {
    "models/msm_jax.py": "models/msm_torch.py",
    "ops/imager_jax.py": "ops/imager.py",
    "ops/metrics_jax.py": "ops/metrics.py",
    "ops/isocalc_jax.py": "ops/isocalc_torch.py",
    "ops/moments_pallas.py": "ops/moments.py",
    "ops/chaos_pallas.py": "ops/chaos.py",
    "ops/score_pallas.py": "ops/score.py",
}

# JAX modules with no port module, each with its reason
OUT_OF_SCOPE = {
    "analysis/retrace.py": "XLA retrace accounting: eager torch traces "
                           "nothing; the build gate is drivers/"
                           "compile_census.py, the static half the "
                           "spec-key-hazard rule",
}

# "JAX module::name" -> the port's name: "name" in the mapped module, or
# "port module::name" where it moved
RENAMES = {
    "models/msm_jax.py::JaxBackend": "TorchBackend",
    "models/msm_jax.py::fused_score_fn_flat_banded": "score_flat_plain",
    "models/msm_jax.py::fused_score_fn_flat_fused": "score_flat_fused",
    "models/msm_jax.py::fused_score_fn_flat_banded_sliced":
        "score_flat_sliced",
    "models/msm_jax.py::fused_score_fn_flat_banded_compact":
        "score_flat_compact",
    "models/msm_jax.py::fused_score_fn_chunked": "score_chunked",
    "parallel/sharded.py::ShardedJaxBackend": "ShardedTorchBackend",
    "parallel/sharded.py::make_jax_backend": "make_torch_backend",
    "ops/moments_pallas.py::batch_moments_pallas_masked": "batch_moments",
    "ops/moments_pallas.py::batch_moments_pallas": "batch_moments",
    "ops/moments_pallas.py::batch_moments_jnp": "batch_moments_torch",
    "ops/quantize.py::expand_cube_jnp": "expand_cube_range",
    "ops/imager_jax.py::band_bucket": "ops/buckets.py::band_bucket",
    "parallel/distributed.py::compile_cache_path":
        "kernels/_build.py::build_dir_for",
    "parallel/distributed.py::enable_compile_cache":
        "service/primer.py::bind_builds",
}

# "JAX module::name" -> why the port has no counterpart
DEPARTURES = {
    # the Pallas kernels' tiling and VMEM budgets: the CUDA kernels take
    # every shape (row groups, row tiles) and plan their own shared memory
    "ops/moments_pallas.py::moments_fit":
        "VMEM fit of the Pallas block; ops/moments.moments_plan plans the "
        "CUDA kernel for every (K, P)",
    "ops/chaos_pallas.py::fits_vmem":
        "VMEM fit of the Pallas block; ops/chaos.chaos_route picks the "
        "packed, row-tile or scan route",
    "ops/score_pallas.py::n_super_blocks":
        "super-rows of the Pallas histogram tile; csrc/fused_moments.cu "
        "reads histogram rows directly",
    "ops/score_pallas.py::cols_padded":
        "super-row padding of the Pallas scratch; ops/imager.flat_histogram "
        "sizes the port's",
    "ops/score_pallas.py::pick_tile":
        "VMEM pixel tile of the Pallas kernel; the CUDA kernel's cluster "
        "slices every width",
    "ops/score_pallas.py::fused_fit":
        "whether the Pallas kernel compiles for a plan; the CUDA kernel "
        "runs every plan (row groups)",
    # XLA plumbing: jit, partials, sharded arrays, shard_map
    "models/msm_jax.py::make_flat_jits":
        "builds jax.jit step functions; the port calls its score_* "
        "functions eagerly",
    "models/msm_jax.py::named_partial":
        "names a partial for XLA's compile census; nothing is compiled",
    "models/msm_jax.py::to_numpy_global":
        "gathers a sharded jax.Array to the host; port tensors come back "
        "with .cpu()",
    "models/msm_jax.py::fetch_scored_batches":
        "drains async XLA dispatches; TorchBackend.score_batches fetches "
        "its batches itself",
    "parallel/sharded.py::build_sharded_score_factory":
        "shard_map'd jit factory; ShardedTorchBackend launches each shard's "
        "step on its card",
    "parallel/mesh.py::shard_map":
        "jax version shim for shard_map; the port's mesh has no SPMD "
        "transform",
    "utils/devicemem.py::jax_if_loaded":
        "the jax module if imported; the port reads torch.cuda",
    # the retrace analysis of jit compile surfaces (analysis/retrace.py)
    "analysis/surface.py::compile_surface":
        "registers jit compile surfaces; the port declares kernel launch "
        "sites (kernel_surface, KERNEL_SURFACE)",
    "analysis/surface.py::module_for_path":
        "maps a path to a compile-surface module; no compile surfaces in "
        "the port",
    "analysis/surface.py::is_registered_path":
        "whether a path declares compile surfaces; no compile surfaces in "
        "the port",
    "analysis/rules.py::jit_compile_surface":
        "lint rule over jax.jit sites; the port's is kernel_build_surface",
    "analysis/rules.py::retrace_hazard":
        "lint rule for XLA retraces; the port's is spec_key_hazard",
    "analysis/rules.py::compile_surface_census":
        "census of jit compile surfaces; the port's is "
        "kernel_surface_census",
    # semantics the port deliberately changed
    "models/breaker.py::record_degraded":
        "the port never degrades a torch_cuda job to numpy_ref: an open "
        "breaker refuses it (sm_breaker_refused_total)",
    "ops/metrics_jax.py::isotope_image_correlation_batch":
        "spatial always goes through the moments and "
        "correlation_from_moments (the numerics list of "
        "tests/test_torch_numerics.py)",
    "models/msm_jax.py::warmup_cache_events":
        "the XLA warm-up manifest trim: a warm-up on the card also makes "
        "cuBLAS's handle and grows the allocator, so it is never skipped",
    "ops/imager_jax.py::extract_images":
        "the unchunked cube scatter; the port's cube path is always "
        "extract_images_mz_chunked, equal to it",
    "ops/imager_jax.py::extract_images_flat":
        "the dense flat extraction; every flat batch is banded "
        "(extract_images_flat_banded), equal to it",
}

# metric families the port registers under another name
METRIC_RENAMES = {
    # the port refuses where the JAX package degrades (breaker departure)
    "sm_breaker_degraded_total": "sm_breaker_refused_total",
    # the XLA persistent cache -> the kernel build directory
    "sm_xla_cache_entries": "sm_kernel_cache_entries",
    "sm_xla_cache_bytes": "sm_kernel_cache_bytes",
    "sm_xla_cache_misses_total": "sm_kernel_cache_misses_total",
}

METRIC_DEPARTURES = {
    "sm_xla_cache_warmup_total":
        "counts the XLA warm-up manifest trim, which the port does not "
        "make (models/msm_jax.py::warmup_cache_events above)",
}


# ---------------------------------------------------------------- readers
def _modules(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def _public_surface(path: Path) -> list[str]:
    """The public top-level functions and classes a module defines, and
    each public class's public methods (``"Class.method"``)."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) or node.name.startswith("_"):
            continue
        out.append(node.name)
        if isinstance(node, ast.ClassDef):
            out.extend(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and not m.name.startswith("_"))
    return out


def _assigned(node) -> set[str]:
    if isinstance(node, ast.Assign):
        return {t.id for t in node.targets if isinstance(t, ast.Name)}
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return {node.target.id}
    return set()


def _bindings(path: Path) -> tuple[set[str], dict[str, set[str]]]:
    """Every name a module binds at top level (defs, classes, assignments,
    imports, also under a top-level ``if``/``try``), and each class's
    attributes (methods and assignments in its body)."""
    names: set[str] = set()
    classes: dict[str, set[str]] = {}
    stack = list(ast.parse(path.read_text()).body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.If, ast.Try)):
            stack.extend(node.body + node.orelse
                         + getattr(node, "finalbody", [])
                         + [s for h in getattr(node, "handlers", [])
                            for s in h.body])
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            classes[node.name] = set().union(*(
                {m.name} if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                else _assigned(m) for m in node.body))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        else:
            names.update(_assigned(node))
    return names, classes


# ----------------------------------------------------------------- census
def module_census(jax_root: Path, port_root: Path, module_renames: dict,
                  out_of_scope: dict) -> list[str]:
    problems = []
    jax_mods = set(_modules(jax_root))
    for mod in sorted(jax_mods):
        target = module_renames.get(mod, mod)
        if mod in out_of_scope:
            if (port_root / target).exists():
                problems.append(f"stale out-of-scope entry {mod}: the port "
                                "has it")
        elif not (port_root / target).exists():
            problems.append(f"module {mod} has no port module {target}")
    for mod, target in sorted(module_renames.items()):
        if mod not in jax_mods or not (port_root / target).exists():
            problems.append(f"stale module rename {mod} -> {target}")
    for mod, reason in sorted(out_of_scope.items()):
        if mod not in jax_mods:
            problems.append(f"stale out-of-scope entry {mod}: no such module")
        if not reason.strip():
            problems.append(f"out-of-scope entry {mod} has no reason")
    return problems


def name_census(jax_root: Path, port_root: Path, module_renames: dict,
                out_of_scope: dict, renames: dict,
                departures: dict) -> list[str]:
    bindings: dict[str, tuple[set[str], dict[str, set[str]]]] = {}

    def has(mod: str, dotted: str) -> bool:
        if mod not in bindings:
            path = port_root / mod
            bindings[mod] = _bindings(path) if path.exists() else (set(), {})
        names, classes = bindings[mod]
        owner, _, meth = dotted.partition(".")
        return meth in classes.get(owner, set()) if meth else owner in names

    def counterpart(key: str) -> tuple[str, str]:
        """(port module, name or ``Class.method``) a JAX key maps to."""
        mod, _, dotted = key.partition("::")
        owner, _, meth = dotted.partition(".")
        if meth:
            tmod, towner = counterpart(f"{mod}::{owner}")
            return tmod, f"{towner}.{renames.get(key, meth)}"
        target = renames.get(key, owner)
        if "::" in target:
            return tuple(target.split("::"))
        return module_renames.get(mod, mod), target

    keys = [f"{mod}::{name}" for mod in _modules(jax_root)
            if mod not in out_of_scope
            for name in _public_surface(jax_root / mod)]
    problems = []
    for key in keys:
        mod, _, dotted = key.partition("::")
        owner_key = f"{mod}::{dotted.partition('.')[0]}"
        if key in departures or owner_key in departures:
            continue
        if owner_key != key and not has(*counterpart(owner_key)):
            continue                  # the class itself is reported
        tmod, dotted = counterpart(key)
        if has(tmod, dotted):
            continue
        if key in renames:
            problems.append(f"stale rename {key} -> {renames[key]}: the "
                            f"port has no {tmod}::{dotted}")
        else:
            problems.append(f"{key} has no counterpart {tmod}::{dotted} "
                            "and no entry")
    for key in sorted(set(renames) - set(keys)):
        problems.append(f"stale rename {key}: no such JAX name")
    for key, reason in sorted(departures.items()):
        if key not in keys:
            problems.append(f"stale departure {key}: no such JAX name")
        elif has(*counterpart(key)):
            problems.append(f"stale departure {key}: the port has it")
        if not reason.strip():
            problems.append(f"departure {key} has no reason")
    return problems


def _config_keys(path: Path) -> set[str]:
    def walk(d: dict, pre: str) -> set[str]:
        out = set()
        for k, v in d.items():
            if k.startswith("__"):
                continue
            out.add(pre + k)
            if isinstance(v, dict):
                out |= walk(v, pre + k + ".")
        return out

    return walk(json.loads(path.read_text()), "")


def config_census(jax_template: Path, port_template: Path) -> list[str]:
    missing = _config_keys(jax_template) - _config_keys(port_template)
    return [f"config key {k} is not in {port_template.name}"
            for k in sorted(missing)]


def _cli_arguments(path: Path) -> set[tuple[str, str]]:
    """(subcommand, argument) for every ``add_argument`` of the parsers
    ``add_parser`` makes ("" for the top-level parser's)."""
    tree = ast.parse(path.read_text())
    subs: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and isinstance(node.value.func, ast.Attribute) \
                and node.value.func.attr == "add_parser":
            name = node.value.args[0].value
            for t in node.targets:
                if isinstance(t, ast.Name):
                    subs[t.id] = name
    out = {("", s) for s in subs.values()}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "add_argument" \
                and isinstance(node.func.value, ast.Name):
            sub = subs.get(node.func.value.id, "")
            out |= {(sub, a.value) for a in node.args
                    if isinstance(a, ast.Constant)}
    return out


def cli_census(jax_cli: Path, port_cli: Path) -> list[str]:
    missing = _cli_arguments(jax_cli) - _cli_arguments(port_cli)
    return [f"cli {sub or '(top)'} {arg} is not in the port's cli"
            for sub, arg in sorted(missing)]


ROUTE = re.compile(r"^/[a-z][a-z0-9_/.-]*$")


def _routes(service: Path) -> set[str]:
    out = set()
    for path in service.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and ROUTE.match(node.value) \
                    and not node.value.startswith("/proc/"):
                out.add(node.value)
    return out


def route_census(jax_service: Path, port_service: Path) -> list[str]:
    return [f"route {r} is not in the port's service"
            for r in sorted(_routes(jax_service) - _routes(port_service))]


FAMILY = re.compile(r"^sm_[a-z0-9_]+$")


def _families(root: Path) -> set[str]:
    out = set()
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute) \
                    and node.func.attr in ("counter", "gauge", "histogram") \
                    and node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) \
                    and FAMILY.match(node.args[0].value):
                out.add(node.args[0].value)
    return out


def metric_census(jax_root: Path, port_root: Path, renames: dict,
                  departures: dict) -> list[str]:
    jax, port = _families(jax_root), _families(port_root)
    problems = [f"metric family {f} has no counterpart and no entry"
                for f in sorted(jax - port - set(renames) - set(departures))]
    for fam, target in sorted(renames.items()):
        if fam not in jax or target not in port:
            problems.append(f"stale metric rename {fam} -> {target}")
    for fam, reason in sorted(departures.items()):
        if fam not in jax or fam in port:
            problems.append(f"stale metric departure {fam}")
        if not reason.strip():
            problems.append(f"metric departure {fam} has no reason")
    return problems


# ---------------------------------------------------------- the real trees
SURFACES = {
    "modules": lambda: module_census(JAX, PORT, MODULE_RENAMES, OUT_OF_SCOPE),
    "names": lambda: name_census(JAX, PORT, MODULE_RENAMES, OUT_OF_SCOPE,
                                 RENAMES, DEPARTURES),
    "config": lambda: config_census(ROOT / "conf" / "config.json.template",
                                    ROOT / "conf"
                                    / "config_torch.json.template"),
    "cli": lambda: cli_census(JAX / "engine" / "cli.py",
                              PORT / "engine" / "cli.py"),
    "routes": lambda: route_census(JAX / "service", PORT / "service"),
    "metrics": lambda: metric_census(JAX, PORT, METRIC_RENAMES,
                                     METRIC_DEPARTURES),
}


@pytest.mark.parametrize("surface", sorted(SURFACES))
def test_port_surface_is_closed(surface):
    problems = SURFACES[surface]()
    assert not problems, "\n".join(problems)


def test_census_reads_real_surfaces():
    """The readers find the surfaces they claim to, so an empty census is
    not an empty read."""
    assert len(_modules(JAX)) > 60
    assert {("", "run"), ("", "serve"), ("run", "--ds-id"),
            ("serve", "--port")} <= _cli_arguments(JAX / "engine" / "cli.py")
    assert {"/healthz", "/metrics", "/submit", "/debug/compile"} <= \
        _routes(JAX / "service")
    assert {"sm_jobs_total", "sm_xla_cache_entries"} <= _families(JAX)
    assert {"sm_kernel_cache_entries", "sm_kernel_launches_total"} <= \
        _families(PORT)
    assert "parallel.compile_cache_dir" in _config_keys(
        ROOT / "conf" / "config.json.template")


# -------------------------------------------------- synthetic trees: faults
JAX_MOD = '''
def f():
    pass


def _private():
    pass


class C:
    def m(self):
        pass

    def _hidden(self):
        pass
'''


def _tree(tmp_path: Path, name: str, files: dict[str, str]) -> Path:
    root = tmp_path / name
    for rel, text in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    return root


NAME_CASES = {
    # case: (port module text, renames, departures, expected problem)
    "clean": (JAX_MOD, {}, {}, None),
    "removed function": (JAX_MOD.replace("def f():", "def g():"), {}, {},
                         "a.py::f has no counterpart"),
    "removed class": (JAX_MOD.replace("class C:", "class D:"), {}, {},
                      "a.py::C has no counterpart"),
    "removed method": (JAX_MOD.replace("def m(self)", "def n(self)"), {},
                       {}, "a.py::C.m has no counterpart"),
    "renamed": (JAX_MOD.replace("def f():", "def g():"), {"a.py::f": "g"},
                {}, None),
    "moved": (JAX_MOD.replace("def f():", "def _f():"),
              {"a.py::f": "b.py::f"}, {}, None),
    "stale rename, JAX name gone": (JAX_MOD, {"a.py::gone": "f"}, {},
                                    "stale rename a.py::gone"),
    "stale rename, port name gone": (JAX_MOD.replace("def f():",
                                                     "def h():"),
                                     {"a.py::f": "g"}, {},
                                     "stale rename a.py::f -> g"),
    "departure": (JAX_MOD.replace("def f():", "def h():"), {},
                  {"a.py::f": "not needed on the card"}, None),
    "stale departure, JAX name gone": (JAX_MOD, {},
                                       {"a.py::gone": "a reason"},
                                       "stale departure a.py::gone"),
    "stale departure, the port has it": (JAX_MOD, {},
                                         {"a.py::f": "a reason"},
                                         "stale departure a.py::f: the "
                                         "port has it"),
    "departure without a reason": (JAX_MOD.replace("def f():", "def h():"),
                                   {}, {"a.py::f": " "},
                                   "departure a.py::f has no reason"),
}


@pytest.mark.parametrize("case", sorted(NAME_CASES))
def test_name_census_on_synthetic_trees(tmp_path, case):
    port_text, renames, departures, expected = NAME_CASES[case]
    jax = _tree(tmp_path, "jax", {"a.py": JAX_MOD})
    port = _tree(tmp_path, "port", {"a.py": port_text,
                                    "b.py": "def f():\n    pass\n"})
    problems = name_census(jax, port, {}, {}, renames, departures)
    if expected is None:
        assert problems == []
    else:
        assert any(expected in p for p in problems), problems


MODULE_CASES = {
    "clean": ({"a.py": ""}, {}, {}, None),
    "unmapped module": ({}, {}, {}, "module a.py has no port module"),
    "renamed module": ({"a_torch.py": ""}, {"a.py": "a_torch.py"}, {}, None),
    "stale module rename": ({"a.py": ""}, {"gone.py": "a.py"}, {},
                            "stale module rename gone.py"),
    "out of scope": ({}, {}, {"a.py": "eager torch traces nothing"}, None),
    "stale out-of-scope entry": ({"a.py": ""}, {}, {"a.py": "a reason"},
                                 "stale out-of-scope entry a.py"),
}


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_module_census_on_synthetic_trees(tmp_path, case):
    port_files, renames, out_of_scope, expected = MODULE_CASES[case]
    jax = _tree(tmp_path, "jax", {"a.py": ""})
    port = _tree(tmp_path, "port", {"keep.py": "", **port_files})
    problems = module_census(jax, port, renames, out_of_scope)
    if expected is None:
        assert problems == []
    else:
        assert any(expected in p for p in problems), problems


METRICS_MOD = '''
def attach(m):
    m.counter("sm_a_total", "a")
    m.gauge("sm_b", "b")
    m.histogram("sm_c_seconds", "c")
'''

METRIC_CASES = {
    "clean": (METRICS_MOD, {}, {}, None),
    "removed family": (METRICS_MOD.replace("sm_b", "sm_z"), {}, {},
                       "metric family sm_b has no counterpart"),
    "renamed family": (METRICS_MOD.replace("sm_b", "sm_z"),
                       {"sm_b": "sm_z"}, {}, None),
    "stale metric rename": (METRICS_MOD, {"sm_b": "sm_gone"}, {},
                            "stale metric rename sm_b"),
    "metric departure": (METRICS_MOD.replace("sm_b", "sm_z"), {},
                         {"sm_b": "a reason"}, None),
    "stale metric departure": (METRICS_MOD, {}, {"sm_b": "a reason"},
                               "stale metric departure sm_b"),
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metric_census_on_synthetic_trees(tmp_path, case):
    port_text, renames, departures, expected = METRIC_CASES[case]
    jax = _tree(tmp_path, "jax", {"m.py": METRICS_MOD})
    port = _tree(tmp_path, "port", {"m.py": port_text})
    problems = metric_census(jax, port, renames, departures)
    if expected is None:
        assert problems == []
    else:
        assert any(expected in p for p in problems), problems


CLI_MOD = '''
def build_parser():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd")
    run = sub.add_parser("run")
    run.add_argument("input_path")
    run.add_argument("--sm-config", default=None)
    srv = sub.add_parser("serve")
    srv.add_argument("--port", type=int)
    return ap
'''

SERVICE_MOD = '''
def route(path):
    if path == "/healthz":
        return 1
    if path == "/debug/compile":
        return 2
    open("/proc/self/statm")
'''


def test_cli_route_and_config_census_on_synthetic_trees(tmp_path):
    jax = _tree(tmp_path, "jax", {
        "cli.py": CLI_MOD, "service/api.py": SERVICE_MOD,
        "config.json": json.dumps({"a": 1, "__doc__": "x",
                                   "b": {"c": 2, "__doc_c__": "y"}})})
    same = _tree(tmp_path, "same", {
        "cli.py": CLI_MOD, "service/api.py": SERVICE_MOD,
        "config.json": json.dumps({"a": 1, "b": {"c": 2}, "device": "cuda"})})
    assert cli_census(jax / "cli.py", same / "cli.py") == []
    assert route_census(jax / "service", same / "service") == []
    assert config_census(jax / "config.json", same / "config.json") == []
    less = _tree(tmp_path, "less", {
        "cli.py": CLI_MOD.replace('"--port"', '"--portnum"'),
        "service/api.py": SERVICE_MOD.replace("/debug/compile", "/debug/x"),
        "config.json": json.dumps({"a": 1, "b": {}})})
    assert cli_census(jax / "cli.py", less / "cli.py") == [
        "cli serve --port is not in the port's cli"]
    assert route_census(jax / "service", less / "service") == [
        "route /debug/compile is not in the port's service"]
    assert config_census(jax / "config.json", less / "config.json") == [
        "config key b.c is not in config.json"]
