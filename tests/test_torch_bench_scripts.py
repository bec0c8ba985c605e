"""The port's bench scripts (``sm_distributed_tpu_torch/drivers/``:
``roofline_probe``, ``profile_bench``, ``desi_probe``, ``cold_path_bench``,
``desi_bigdb_bench``) at tiny sizes on the CPU, each held to the JAX
package's script of the same name: the same JSON keys under the key map
(the JAX scripts run beside them here, each in a process of its own, in
well under a minute on this CPU; ``scripts/desi_probe.py`` prints no JSON
and takes no size, so its port is held to its own documented keys), and
the same ions where both score a job.

- ``roofline_probe --tiny`` off the card: a null share (no published peak
  for the CPU), and ``--min-frac`` trips on it;
- ``profile_bench``: the JAX script's phase names, every phase timed;
- ``desi_probe``: each batch's serial time, variant and band width, the
  phase splits on the representative batches, the stream;
- ``cold_path_bench`` and ``desi_bigdb_bench``: one job each, the JAX
  script's keys and ion count.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sm_distributed_tpu_torch.drivers import bench as tbench

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = Path(__file__).resolve().parent.parent
PHASES = {"fused_full", "extract", "moments", "chaos", "correlation",
          "pattern"}


def _json_line(text: str) -> dict:
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, text[-2000:]
    return json.loads(lines[0])


def _jax_script(argv: list[str], timeout: int = 120) -> dict:
    """The JAX script's one JSON line, from a process of its own: a JAX
    backend points the process-wide persistent XLA cache at its work dir,
    which must not leak into this test process."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return _json_line(proc.stdout)


def _jax_call(module: str, fn: str, kw: dict) -> dict:
    """``scripts.<module>.<fn>(**kw)`` in a process of its own, its result
    back as JSON (see :func:`_jax_script`)."""
    code = (f"import json; from scripts.{module} import {fn}; "
            f"print(json.dumps({fn}(**json.loads({json.dumps(kw)!r}))))")
    return _jax_script(["-c", code])


def _port_main(main, argv: list[str]) -> tuple[int, dict | None]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, _json_line(out.getvalue())


# ---------------------------------------------------------- roofline probe
def test_roofline_probe_tiny_on_the_cpu(tmp_path, monkeypatch):
    from sm_distributed_tpu_torch.drivers import roofline_probe

    monkeypatch.setattr(tbench, "CACHE_DIR", tmp_path)
    rc, out = _port_main(roofline_probe.main, ["--device", "cpu", "--tiny"])
    assert rc == 0
    # no published peak for the CPU: no floor, no bound, no share
    for key in ("roofline_floor_s", "bound", "headroom_x", "roofline_frac",
                "published_peaks", "device_kind", "power_limit_w"):
        assert out[key] is None, key
    assert out["device"] == "cpu" and out["n_ions"] == 8 * 5
    assert out["peaks"]["peak_bw_gbps"] > 0
    assert out["peaks"]["peak_matmul_gflops"] > 0
    assert out["model"]["total_bytes"] > 0
    # the JAX probe's keys, the published peaks and the card beside them
    want = _jax_script(["scripts/roofline_probe.py", "--tiny"])
    assert set(out) == set(want) | {"published_peaks", "device_kind",
                                    "power_limit_w"}
    assert set(out["model"]) == set(want["model"])
    assert set(out["peaks"]) == set(want["peaks"])
    # a gate asked for and not measurable fails
    rc, _ = _port_main(roofline_probe.main, ["--device", "cpu", "--tiny",
                                             "--min-frac", "0.01"])
    assert rc == 1


def test_published_peaks_are_the_h100_data_sheet(monkeypatch):
    from sm_distributed_tpu_torch.drivers import roofline_probe

    assert roofline_probe.published_peaks("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    peaks = roofline_probe.published_peaks("cuda")
    assert (peaks["bytes_per_s"], peaks["f32_flops"]) == (3.35e12, 67e12)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    assert roofline_probe.published_peaks("cuda") is None


# ----------------------------------------------------------- profile bench
def test_profile_bench_names_the_jax_phases(tmp_path):
    from sm_distributed_tpu_torch.drivers.profile_bench import profile

    kw = dict(nrows=8, ncols=8, formula_batch=32, noise_peaks=10, reps=1)
    timings, info = profile(cache_dir=tmp_path / "port", device="cpu", **kw)
    want = _jax_call("profile_bench", "profile",
                     dict(cache_dir=str(tmp_path / "jax"), **kw))
    assert set(timings) == set(want) == PHASES
    assert all(t > 0 for t in timings.values())
    assert info["path"] == "flat" and info["b"] == 32


# -------------------------------------------------------------- desi probe
def test_desi_probe_tiny_on_the_cpu(tmp_path, monkeypatch):
    from sm_distributed_tpu_torch.drivers import desi_probe

    monkeypatch.setattr(tbench, "CACHE_DIR", tmp_path)
    rc, out = _port_main(desi_probe.main, [
        "--device", "cpu", "--nrows", "8", "--ncols", "8", "--n-formulas",
        "12", "--formula-batch", "64"])
    assert rc == 0
    assert set(out) == {
        "metric", "n_ions", "n_pixels", "n_batches", "warmup_s",
        "serial_total_s", "batches", "phases_ms", "probe_info", "stream_s",
        "stream_ions_per_s", "variant_counts", "device", "device_kind",
        "power_limit_w"}
    assert out["n_ions"] == 12 * 21 and out["n_batches"] == 4
    assert [b["batch"] for b in out["batches"]] == [0, 1, 2, 3]
    assert all(b["ms"] > 0 and b["variant"] in ("plain", "band", "compact")
               for b in out["batches"])
    # the first, the median-width, the widest and the last batch
    assert {"b0", "b3"} <= set(out["phases_ms"]) and \
        len(out["phases_ms"]) <= 4
    for splits in out["phases_ms"].values():
        assert set(splits) == PHASES
    assert out["stream_ions_per_s"] > 0


# ------------------------------------------------------ the two job scripts
COLD_ARGS = ["--n-formulas", "30", "--nrows", "8", "--ncols", "8",
             "--present", "4", "--isocalc-workers", "2"]


def test_cold_path_bench_matches_the_jax_script(tmp_path):
    from sm_distributed_tpu_torch.drivers import cold_path_bench

    rc, out = _port_main(cold_path_bench.main, [
        "--device", "cpu", *COLD_ARGS, "--work-dir", str(tmp_path / "port")])
    assert rc == 0
    want = _jax_script(["scripts/cold_path_bench.py", *COLD_ARGS,
                        "--work-dir", str(tmp_path / "jax")])
    assert set(out) == set(want)
    assert out["n_ions"] == want["n_ions"] == 30 * 21
    assert out["value"] > 0 and out["isocalc_s"] >= 0
    assert out["isocalc_workers"] == 2
    assert {"isotope_patterns", "score", "fdr", "store_results"} <= \
        set(out["phases_s"])


def test_desi_bigdb_bench_matches_the_jax_script(tmp_path):
    from sm_distributed_tpu_torch.drivers.desi_bigdb_bench import run

    kw = dict(n_formulas=40, nrows=8, ncols=8, decoy_sample_size=3,
              formula_batch=32, checkpoint_every=2, fixture_formulas=10,
              noise_peaks=10)
    out = run(cache_dir=tmp_path / "port", device="cpu", **kw)
    want = _jax_call("desi_bigdb_bench", "run",
                     dict(cache_dir=str(tmp_path / "jax"), **kw))
    assert set(out) == set(want)
    assert out["n_ions"] == want["n_ions"] > 40
    # score_s is rounded to 0.1 s as in the JAX script: the tiny job's
    # score phase may round to 0.0
    assert out["value"] > 0
    assert out["score_s"] == out["phases_s"]["score"] >= 0
    assert set(out["phases_s"]) >= {"decoy_selection", "isotope_patterns",
                                    "score", "fdr", "stage_input",
                                    "read_dataset", "store_results"}


@pytest.mark.parametrize("module", ["roofline_probe", "profile_bench",
                                    "desi_probe", "cold_path_bench",
                                    "desi_bigdb_bench"])
def test_no_card_is_a_usage_error(module, monkeypatch):
    import importlib

    mod = importlib.import_module(f"sm_distributed_tpu_torch.drivers.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        mod.main(["--device", "cuda"])
    assert exc.value.code == 2
