"""The port's fault-injection seams against the JAX package's.

After importing every module of both packages, the port registers the same
failpoints as the JAX package, ``fleet.spawn`` (the fleet controller)
included.  The reader's two seams fire where the JAX reader's
do: ``io.imzml_parse=crash@1`` kills the reading process with the crash
code, and ``io.ibd_read=raise:OSError@3`` fails the same read of the same
fixture with the same error, in both packages.
"""

from __future__ import annotations

import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

from sm_distributed_tpu.io import fixtures as jfixtures
from sm_distributed_tpu.io import imzml as jimzml
from sm_distributed_tpu.utils import failpoints as jfp
from sm_distributed_tpu_torch.io import imzml as timzml
from sm_distributed_tpu_torch.utils import failpoints as tfp

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": ("sm_distributed_tpu", jimzml, jfp),
            "torch": ("sm_distributed_tpu_torch", timzml, tfp)}
# seams of modules the port does not have, by failpoint: none
PORT_LACKS: dict = {}


def _import_all(pkg: str) -> None:
    root = importlib.import_module(pkg)
    for info in pkgutil.walk_packages(root.__path__, pkg + "."):
        if info.name.startswith("sm_distributed_tpu_torch.drivers."):
            continue              # drivers import the seams' modules anyway
        importlib.import_module(info.name)


@pytest.fixture(autouse=True)
def _reset_both():
    jfp.reset()
    tfp.reset()
    yield
    jfp.reset()
    tfp.reset()


@pytest.fixture(scope="module")
def fixture_imzml(tmp_path_factory):
    path, _truth = jfixtures.generate_synthetic_dataset(
        tmp_path_factory.mktemp("fp_fixture"), nrows=6, ncols=5,
        formulas=None, present_fraction=0.5, noise_peaks=10, seed=3)
    return path


def test_registered_failpoints_equal_the_jax_packages_less_the_fleet():
    _import_all("sm_distributed_tpu")
    _import_all("sm_distributed_tpu_torch")
    jax_fps = jfp.registered_failpoints()
    port_fps = tfp.registered_failpoints()
    assert set(port_fps) == set(jax_fps) - set(PORT_LACKS)
    for name in ("io.imzml_parse", "io.ibd_read", "fleet.spawn"):
        assert port_fps[name] == jax_fps[name]


def _crash_read(pkg: str, path: Path) -> subprocess.CompletedProcess:
    code = (f"from {pkg}.io.imzml import ImzMLReader\n"
            f"with ImzMLReader({str(path)!r}) as rd:\n"
            f"    rd.read_spectrum(0)\n")
    env = dict(os.environ, SM_FAILPOINTS="io.imzml_parse=crash@1",
               PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=str(ROOT))


def test_imzml_parse_crash_kills_the_reader_in_both(fixture_imzml):
    out = {name: _crash_read(pkg, fixture_imzml)
           for name, (pkg, _m, _f) in PACKAGES.items()}
    for name, proc in out.items():
        assert proc.returncode == 21, (name, proc.returncode, proc.stderr)
        assert "FAILPOINT-FIRED name=io.imzml_parse" in proc.stderr, name


def _read_until_fault(mods, path: Path) -> dict:
    _pkg, imzml, fp = mods
    fp.configure("io.ibd_read=raise:OSError@3")
    read = 0
    try:
        with imzml.ImzMLReader(path) as rd:
            for i in range(rd.n_spectra):
                rd.read_spectrum(i)
                read += 1
    except OSError as exc:
        return {"spectra_read": read, "error": type(exc).__name__,
                "message": str(exc).replace(_pkg, "PKG"),
                "injected": fp.injected_counts()}
    return {"spectra_read": read, "error": None,
            "injected": fp.injected_counts()}


def test_ibd_read_fault_fails_the_same_read_in_both(fixture_imzml):
    out = {name: _read_until_fault(mods, fixture_imzml)
           for name, mods in PACKAGES.items()}
    assert out["torch"] == out["jax"]
    # each spectrum reads two arrays (m/z, intensity): the third read is
    # spectrum 1's m/z array
    assert out["torch"]["error"] == "OSError"
    assert out["torch"]["spectra_read"] == 1
    assert out["torch"]["injected"] == {"io.ibd_read": 1}
