"""The port's ULP sentinel (``drivers/ulp_sentinel.py``), its band helpers
(``drivers/perf_sentinel.py``) and its isocalc pool gate
(``drivers/isocalc_smoke.py``) against the JAX package's scripts.

- ``measure(device="cpu")`` on the sentinel's fixture beside the JAX side
  (``JaxBackend`` against ``NumpyBackend``, as ``scripts/ulp_sentinel.py``
  measures; its fused step is left out: the Pallas kernel fails on this
  jax, a reference caveat): FDR ranks identical on both sides, the port's
  drift within the component contracts and its fused bf16 drift within
  ``compact_cube``'s, equal ion counts and lattice rows;
- ``gate`` returns what the JAX script's returns over the same tmp
  history: an honest artifact, a ``degrade``d copy, a band regression
  within the ceilings, no history, and a history of another kind;
- ``--self-check`` passes on the committed ``NUMERICS_H100_r*.json`` and
  fails when the newest history is a degraded copy; measuring with no card
  and no ``--device cpu`` is a usage error;
- both isocalc smokes exit 0, and the port's exits 1 when one pool shard's
  bytes are altered.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from sm_distributed_tpu_torch.drivers import ulp_sentinel as tsent

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = Path(__file__).resolve().parent.parent


def _jax_side(tmp: Path) -> dict:
    """The JAX script's measurement of the plain path on the same fixture:
    ion count, lattice rows, drift and rank mismatches against its numpy
    oracle."""
    from sm_distributed_tpu.analysis import numerics
    from sm_distributed_tpu.io.dataset import SpectralDataset
    from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu.models.msm_basic import NumpyBackend, _slice_table
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.ops.fdr import FDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import (
        DSConfig,
        IsotopeGenerationConfig,
        SMConfig,
    )

    fx = tsent.FIXTURE
    path, truth = generate_synthetic_dataset(
        tmp / "ds", nrows=fx["nrows"], ncols=fx["ncols"], formulas=None,
        present_fraction=fx["present_fraction"],
        noise_peaks=fx["noise_peaks"], seed=fx["seed"])
    ds = SpectralDataset.from_imzml(path)
    formulas = truth.formulas[: fx["n_formulas"]]
    fdr = FDR(decoy_sample_size=fx["decoy_sample_size"],
              target_adducts=("+H",), seed=1)
    assignment = fdr.decoy_adduct_selection(formulas)
    pairs, flags = assignment.all_ion_tuples(formulas, ("+H",))
    table = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H",)),
                           n_procs=1).pattern_table(pairs, flags)
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    sm = SMConfig.from_dict({"backend": "jax_tpu", "parallel": {
        "formula_batch": fx["formula_batch"], "compile_cache_dir": "off"}})
    batch = fx["formula_batch"]

    def score_all(backend) -> np.ndarray:
        return np.concatenate(backend.score_batches(
            [_slice_table(table, s, min(s + batch, table.n_ions))
             for s in range(0, table.n_ions, batch)]))

    jx = JaxBackend(ds, dc, sm)
    got = score_all(jx)
    want = score_all(NumpyBackend(ds, dc))

    def ranks(metrics):
        df = pd.DataFrame({"sf": table.sfs, "adduct": table.adducts,
                           "msm": metrics[:, 3]})
        return fdr.estimate_fdr(df, assignment).sort_values(
            ["msm", "sf"], ascending=False)

    r_got, r_np = ranks(got), ranks(want)
    same = (r_got.sf.tolist() == r_np.sf.tolist()
            and (r_got.fdr.to_numpy() == r_np.fdr.to_numpy()).all()
            and (r_got.fdr_level.to_numpy()
                 == r_np.fdr_level.to_numpy()).all())
    return {"n_ions": int(table.n_ions), "lattice_rows": int(jx._nrows_b),
            "dataset_rows": int(ds.nrows),
            "drift": numerics.component_drift(got, want),
            "ranks_identical": bool(same), "sfs": list(table.sfs)}


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    port = tsent.measure(tmp_path_factory.mktemp("port"), device="cpu")
    return port, _jax_side(tmp_path_factory.mktemp("jax"))


def test_measure_on_the_cpu_matches_the_jax_side(measured):
    """The port's artifact on the CPU beside the JAX side; also the proof
    of ``ops/quantize.py``'s ``compact_cube`` contract (the fused bf16
    drift within it, FDR ranks identical)."""
    from sm_distributed_tpu_torch.analysis import numerics

    port, jax_side = measured
    assert port["kind"] == "numerics" and port["backend"] == "cpu"
    assert port["fixture"] == tsent.FIXTURE
    assert port["fdr_ranks_identical"] and port["fdr_rank_mismatches"] == 0
    assert jax_side["ranks_identical"]
    assert (port["n_ions"], port["lattice_rows"], port["dataset_rows"]) == (
        jax_side["n_ions"], jax_side["lattice_rows"],
        jax_side["dataset_rows"])
    assert port["lattice_rows"] > port["dataset_rows"]    # the pads engaged
    for comp, ulps in port["sm_numerics_max_ulp"].items():
        assert ulps <= numerics.COMPONENT_CONTRACTS[comp], (comp, ulps)
    cube = tsent.declared()["sm_distributed_tpu_torch.ops.quantize"][
        "compact_cube"]
    cube_ulps = numerics.contract_ulps(
        numerics.parse_policy(cube)["contract"])
    assert port["cube_contract_ulps"] == cube_ulps
    assert port["fdr_ranks_identical_fused"]
    assert port["sm_numerics_max_ulp_fused"]["chaos"] == 0
    for comp, ulps in port["sm_numerics_max_ulp_fused"].items():
        assert ulps <= cube_ulps, (comp, ulps)
    assert (port["declared_modules"], port["declared_contracts"]) == (
        9, sum(len(e) for e in tsent.declared().values()))
    assert port["kernel_launches"] == {
        "moments": 0, "chaos": 0, "fused_window_moments": 0}
    assert "card" not in port


def _history(tmp: Path, artifacts: list[dict]) -> list[str]:
    paths = []
    for i, art in enumerate(artifacts, 1):
        p = tmp / f"NUMERICS_H100_r{i:02d}.json"
        p.write_text(json.dumps(art))
        paths.append(str(p))
    return paths


def _raised(art: dict, comp: str, to: int) -> dict:
    out = json.loads(json.dumps(art))
    out["sm_numerics_max_ulp"][comp] = to
    return out


GATE_CASES = ("honest", "degraded", "band_regression", "no_history",
              "other_kind_history")


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_returns_what_the_jax_script_returns(measured, case, tmp_path):
    from scripts import ulp_sentinel as jsent

    port, _ = measured
    honest = dict(port)
    # a drift history the band can move against: spatial 2 ULPs
    honest["sm_numerics_max_ulp"] = {**port["sm_numerics_max_ulp"],
                                     "spatial": 2}
    fresh, history, want = {
        "honest": (honest, [honest], 0),
        "degraded": (tsent.degrade(honest), [honest], 1),
        "band_regression": (_raised(honest, "spatial", 5), [honest], 1),
        "no_history": (honest, [], 0),
        "other_kind_history": (honest, [{"metric": "ions_per_s",
                                         "value": 1.0}], 2),
    }[case]
    paths = _history(tmp_path, history)
    got = tsent.gate(fresh, paths, 0.5, 1, case)
    assert got == jsent.gate(fresh, paths, 0.5, 1, case) == want
    assert tsent.degrade(honest) == jsent.degrade(honest)


def _run(*args, env=None, timeout=300):
    full = dict(os.environ)
    full["PYTHONPATH"] = str(ROOT) + (
        os.pathsep + full["PYTHONPATH"] if full.get("PYTHONPATH") else "")
    full.update(env or {})
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=timeout)


def test_self_check_passes_on_the_committed_history():
    committed = sorted(ROOT.glob(tsent.HISTORY_GLOB))
    assert committed, "no committed NUMERICS_H100_r*.json"
    newest = json.loads(committed[-1].read_text())
    assert newest["backend"].startswith("cuda") and "H100" in newest["card"]
    assert newest["power_limit"].endswith("W")
    assert newest["declared_modules"] == 9
    proc = _run("-m", "sm_distributed_tpu_torch.drivers.ulp_sentinel",
                "--self-check")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "self-check OK" in proc.stdout


def test_self_check_fails_on_a_degraded_history(tmp_path):
    committed = sorted(ROOT.glob(tsent.HISTORY_GLOB))
    assert committed
    shutil.copy(committed[-1], tmp_path / "NUMERICS_H100_r01.json")
    bad = tsent.degrade(json.loads(committed[-1].read_text()))
    (tmp_path / "NUMERICS_H100_r02.json").write_text(json.dumps(bad))
    proc = _run("-m", "sm_distributed_tpu_torch.drivers.ulp_sentinel",
                "--self-check", "--history",
                str(tmp_path / "NUMERICS_H100_r*.json"))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "self-check FAILED" in proc.stderr


def test_measuring_without_a_card_is_a_usage_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run("-m", "sm_distributed_tpu_torch.drivers.ulp_sentinel")
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "no CUDA card is visible" in proc.stderr


def test_the_history_never_globs_the_jax_packages():
    assert tsent.HISTORY_GLOB == "NUMERICS_H100_r*.json"
    assert not any(Path(p).name.startswith("NUMERICS_r")
                   for p in ROOT.glob(tsent.HISTORY_GLOB))


@pytest.mark.parametrize("side", ["port", "jax"])
def test_isocalc_smokes_exit_0(side):
    args = (["-m", "sm_distributed_tpu_torch.drivers.isocalc_smoke",
             "--device", "cpu"] if side == "port"
            else [str(ROOT / "scripts" / "isocalc_smoke.py")])
    proc = _run(*args, env={"OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "isocalc_smoke: OK" in proc.stdout


def test_isocalc_smoke_fails_on_an_altered_pool_shard(monkeypatch, capsys):
    from sm_distributed_tpu_torch.drivers import isocalc_smoke
    from sm_distributed_tpu_torch.ops import isocalc

    real = isocalc.IsocalcWrapper._write_shard
    altered = []

    def write_shard(self, shard, entries):
        real(self, shard, entries)
        if self.n_procs == isocalc_smoke.WORKERS and not altered:
            data = bytearray(Path(shard).read_bytes())
            data[len(data) // 2] ^= 0xFF
            Path(shard).write_bytes(bytes(data))
            altered.append(Path(shard).name)

    monkeypatch.setattr(isocalc.IsocalcWrapper, "_write_shard", write_shard)
    assert isocalc_smoke.main(["--device", "cpu"]) == 1
    assert altered
    err = capsys.readouterr().err
    assert f"shard {altered[0]} bytes differ" in err
    assert isocalc._PARALLEL_THRESHOLD == 256     # restored
