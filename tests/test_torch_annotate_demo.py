"""The port's annotate demo (``drivers/annotate_demo.py``) against the JAX
package's ``examples/annotate_demo.py``: the same seed at 16x16, the port
at ``--device cpu`` and the JAX demo on ``numpy_ref``, print the same
summary line and store the same annotation set at FDR <= 10%; a card asked
for where none is visible is a usage error."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sm_distributed_tpu.engine.storage import AnnotationIndex as JIndex
from sm_distributed_tpu.engine.storage import JobLedger as JLedger
from sm_distributed_tpu_torch.engine.storage import AnnotationIndex as TIndex
from sm_distributed_tpu_torch.engine.storage import JobLedger as TLedger

ROOT = Path(__file__).resolve().parent.parent
SIZE = ["--nrows", "16", "--ncols", "16"]


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *cmd], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def _summary(stdout: str) -> list[str]:
    return [ln for ln in stdout.splitlines()
            if ln.startswith(("ground truth:", "annotations at FDR<=10%:"))]


def _hits(index_cls, ledger_cls, results: Path) -> set:
    hits = index_cls(ledger_cls(str(results))).search(
        ds_id="demo", max_fdr_level=0.1)
    return set(zip(hits.sf, hits.adduct, hits.fdr_level))


def test_demo_matches_the_jax_demo(tmp_path):
    port = _run(["-m", "sm_distributed_tpu_torch.drivers.annotate_demo",
                 "--device", "cpu", *SIZE, "--out", str(tmp_path / "torch")])
    ref = _run(["examples/annotate_demo.py", "--backend", "numpy_ref", *SIZE,
                "--out", str(tmp_path / "jax")])
    assert port.returncode == 0, port.stderr[-3000:]
    assert ref.returncode == 0, ref.stderr[-3000:]
    summary = _summary(port.stdout)
    assert len(summary) == 2 and summary == _summary(ref.stdout)
    got = _hits(TIndex, TLedger, tmp_path / "torch" / "results")
    want = _hits(JIndex, JLedger, tmp_path / "jax" / "results")
    assert got and got == want


def test_demo_without_a_card_is_a_usage_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the demo would run on it")
    proc = _run(["-m", "sm_distributed_tpu_torch.drivers.annotate_demo",
                 *SIZE, "--out", str(tmp_path)])
    assert proc.returncode == 2
    assert "no CUDA card is visible" in proc.stderr
    assert not (tmp_path / "dataset").exists()
