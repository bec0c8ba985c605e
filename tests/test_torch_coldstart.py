"""The port's cold-start gates off the card: ``drivers/coldstart_smoke.py``
and ``drivers/compile_census.py`` run as a user runs them with ``--device
cpu`` (``torch_cuda`` on the CPU; the JAX scripts have no ``numpy_ref``
run), and the census's spec keys against the JAX package's
``ops/buckets.py`` keys for the same three jobs through its own service.
Every new driver asks for the card unless told otherwise.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
DRIVER_TIMEOUT_S = 300


def _driver(name: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SM_FAILPOINTS", None)
    return subprocess.run(
        [sys.executable, "-m", f"sm_distributed_tpu_torch.drivers.{name}",
         *args], env=env, cwd=str(ROOT), capture_output=True, text=True,
        timeout=DRIVER_TIMEOUT_S)


def test_coldstart_smoke_exits_zero_off_the_card():
    proc = _driver("coldstart_smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "coldstart_smoke: cold replica OK off the card" in out
    assert "coldstart_smoke: primed replica OK off the card" in out
    assert "coldstart_smoke: OK" in out
    # the build checks say that they did not run; none passes silently
    assert "the build checks (uncached compile events, compile_s > 0, " \
        "specs primed) did not run" in out
    assert "the found-kernel checks did not run" in out
    assert "skipped:cpu" in out


def _census(out: str) -> dict:
    line = next(ln for ln in out.splitlines()
                if ln.startswith("compile_census: census "))
    return json.loads(line[len("compile_census: census "):])


def _jax_census_keys(base: Path) -> list[str]:
    """The JAX package's spec keys for the census's three jobs through its
    own in-process service (two on the 8x8 fixture, one on 6x8)."""
    from scripts.load_sweep import Harness, _msg, build_fixtures
    from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu.ops import buckets

    buckets.reset()
    fx = build_fixtures(base)
    mid, _truth = generate_synthetic_dataset(
        base / "fx_mid", nrows=6, ncols=8, formulas=None,
        present_fraction=0.5, noise_peaks=30, seed=12)
    h = Harness(base, "census", sm_overrides={
        "backend": "jax_tpu", "parallel": {"compile_cache_dir": "off"}})
    try:
        for m in (_msg(fx, "fast", "census1"), _msg(fx, "fast", "census2"),
                  dict(_msg(fx, "fast", "census_xsize"),
                       input_path=str(mid))):
            status, _hd, body = h.submit(m)
            assert status == 202, body
            rows = h.wait_terminal([m["msg_id"]], timeout_s=300.0)
            assert rows[m["msg_id"]]["state"] == "done", rows[m["msg_id"]]
    finally:
        h.service.shutdown()
    keys = sorted(buckets.spec_key(s) for s in buckets.recorded_specs())
    buckets.reset()
    return keys


def test_compile_census_spec_keys_equal_the_jax_packages(tmp_path):
    proc = _driver("compile_census", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    census = _census(proc.stdout)
    assert census["spec_keys"] == _jax_census_keys(tmp_path)
    assert census["spec_keys"]
    # off the card nothing is built, and the devices: 2 step runs on the
    # simulated 2-chip pool
    assert census["nvcc_runs"] == 0
    assert census["devices_step"] == "ran" and census["sharded_keys"]
    assert all("kind=sharded" in k for k in census["sharded_keys"])
    assert set(census["sites"]) == {"sm_compile_events_total",
                                    "sm_compile_signatures",
                                    "sm_compile_cache_hits_total"}
    assert "compile_census: OK" in proc.stdout


@pytest.mark.parametrize("driver", ["coldstart_smoke", "compile_census",
                                    "device_chaos", "stream_chaos"])
def test_new_drivers_default_to_the_card(driver, monkeypatch, capsys):
    """With no arguments each driver asks for ``torch_cuda`` on ``cuda``;
    with no card visible it stops with a usage error naming the way off
    the card, before it makes anything."""
    import torch

    mod = importlib.import_module(f"sm_distributed_tpu_torch.drivers.{driver}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        mod.main([])
    assert exc.value.code == 2
    assert "--device cuda: no CUDA card is visible" in capsys.readouterr().err
