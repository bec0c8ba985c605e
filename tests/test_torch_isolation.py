"""The PyTorch port stands alone: no jax, nothing of the JAX package, and the
card by default with no CPU fallback.

- importing every port module (and ``chip_smoke.py``) in a fresh process
  leaves ``jax`` and ``sm_distributed_tpu`` out of ``sys.modules``;
- an AST scan of the port's sources finds no such import;
- the backend and the search, at their default device, raise without a GPU;
- kernel wrappers given CPU tensors take the plain version and leave their
  launch counters alone;
- config values the port does not have raise ``NotImplementedError``.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sm_distributed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sm_distributed_tpu")


def _port_modules() -> list[str]:
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def _tiny_dataset():
    from sm_distributed_tpu_torch.io.fixtures import synthetic_dataset_arrays

    return synthetic_dataset_arrays(nrows=6, ncols=7, noise_peaks=5, seed=3)


def test_backend_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    ds, _ = _tiny_dataset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(ds, DSConfig(), SMConfig())


def test_search_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig

    ds, truth = _tiny_dataset()
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MSMBasicSearch(ds, truth.formulas[:3], dc).search()


def test_moments_wrapper_on_cpu_uses_plain_version():
    from sm_distributed_tpu_torch.ops.moments import (
        batch_moments,
        batch_moments_torch,
    )

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 9, (3, 4, 40)).astype(np.float32))
    before = batch_moments.launches
    for n_real in (None, 33):
        got = batch_moments(x, n_real)
        want = batch_moments_torch(x, n_real)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert batch_moments.launches == before


def test_chaos_wrapper_on_cpu_uses_plain_version():
    from sm_distributed_tpu_torch.ops.chaos import (
        chaos_count_sums,
        chaos_count_sums_strips,
        chaos_count_sums_torch,
    )

    rng = np.random.default_rng(2)
    x = torch.from_numpy(np.where(rng.random((3, 30)) < 0.5,
                                  rng.random((3, 30)), 0).astype(np.float32))
    before = chaos_count_sums.launches, chaos_count_sums_strips.launches
    for wrapper in (chaos_count_sums, chaos_count_sums_strips):
        assert torch.equal(wrapper(x, 5, 6, 4),
                           chaos_count_sums_torch(x, 5, 6, 4))
    assert (chaos_count_sums.launches,
            chaos_count_sums_strips.launches) == before


def test_fused_wrapper_on_cpu_uses_plain_version():
    from sm_distributed_tpu_torch.ops.score import (
        fused_window_moments,
        fused_window_moments_torch,
    )

    rng = np.random.default_rng(3)
    whp = torch.from_numpy(rng.integers(0, 9, (20, 40)).astype(np.float32))
    starts = np.array([0, 5], np.int32)
    r_lo = torch.from_numpy(rng.integers(-1, 6, (2, 6)).astype(np.int32))
    r_hi = r_lo + torch.from_numpy(rng.integers(0, 3, (2, 6)).astype(np.int32))
    before = fused_window_moments.launches
    args = (whp, starts, r_lo, r_hi, 37)
    got = fused_window_moments(*args, gc_width=8, k=3)
    want = fused_window_moments_torch(*args, gc_width=8, k=3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert fused_window_moments.launches == before


@pytest.mark.parametrize("section,knob,value", [
    ("parallel", "cube_dtype", "bf16"),
    ("parallel", "cube_dtype", "int8"),
    ("parallel", "peak_compaction", "on"),
    ("parallel", "band_slice", "on"),
    ("image_generation", "do_preprocessing", True),
])
def test_values_outside_the_slice_raise(section, knob, value):
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if section == "parallel":
            SMConfig.from_dict({"parallel": {knob: value}})
        else:
            DSConfig.from_dict({section: {knob: value}})


@pytest.mark.parametrize("knob,value", [
    ("mz_chunk", 512), ("fused_metrics", "on"),
    ("fused_metrics", "auto"), ("fused_metrics", "off"),
    ("peak_compaction", "auto"), ("peak_compaction", "off"),
    ("band_slice", "auto"), ("band_slice", "off"),
])
def test_values_inside_the_slice_are_accepted(knob, value):
    from sm_distributed_tpu_torch.utils.config import SMConfig

    sm = SMConfig.from_dict({"parallel": {knob: value}})
    assert getattr(sm.parallel, knob) == value
    assert sm.backend == "torch_cuda" and sm.device == "cuda"


def test_chip_smoke_golden_recipe_matches_the_script():
    """chip_smoke.py keeps its own copy of the golden recipe (it may not
    import the JAX package's script); the copy must not drift."""
    import chip_smoke
    from scripts.make_golden_report import DS, GEN, SM

    assert chip_smoke.GOLDEN_GEN == GEN
    assert chip_smoke.GOLDEN_DS == DS
    sm = {k: v for k, v in SM.items() if k != "backend"}
    assert chip_smoke.GOLDEN_SM == sm


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
