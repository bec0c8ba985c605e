"""The port's ``drivers/perf_sentinel.py`` held against the JAX package's
``scripts/perf_sentinel.py``.

- ``normalize`` and ``degrade`` equal on every committed ``BENCH_r*.json``,
  ``NUMERICS_r*.json`` and ``ANALYSIS_r*.json`` and on a ``trace_report
  --json`` summary;
- ``main``'s exit codes equal with ``--history`` given explicitly: honest
  and degraded fresh artifacts, a mismatched kind (2), ``--self-check``;
- the port's default history is ``BENCH_H100_r*.json``, never the JAX
  package's ``BENCH_r*.json``; the committed H100 artifacts are the
  card's and comparable, and a synthetic regression of the newest trips
  the sentinel.
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import sys
from pathlib import Path

import pytest

from sm_distributed_tpu_torch.drivers import perf_sentinel as tsent

ROOT = Path(__file__).resolve().parent.parent
BENCH = sorted(glob.glob(str(ROOT / "BENCH_r*.json")))
OTHER = sorted(glob.glob(str(ROOT / "NUMERICS_r*.json"))
               + glob.glob(str(ROOT / "ANALYSIS_r*.json")))


@pytest.fixture(scope="module")
def jsent():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import perf_sentinel
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return perf_sentinel


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*args)


@pytest.fixture(scope="module")
def trace_summary(tmp_path_factory):
    """A ``trace_report --json`` summary of a bench trace."""
    from sm_distributed_tpu_torch.drivers import bench, trace_report

    tmp = tmp_path_factory.mktemp("trace")
    cfg = bench.BenchConfig("headline", 16, 16, 8, 64, 4, 1, 10)
    path = bench.write_bench_trace(tmp, [cfg], {"phases": {
        "isocalc_s": 0.25, "floor_rep_s": 0.02, "compile_s": 1.3,
        "compile_nvcc_s": 0.9, "stream_s": 0.13}})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert trace_report.main([path, "--json"]) == 0
    summary = tmp / "summary.json"
    summary.write_text(out.getvalue())
    return summary


def test_every_committed_artifact_normalizes_and_degrades_alike(
        jsent, trace_summary):
    assert len(BENCH) >= 5 and OTHER
    for path in BENCH + OTHER + [str(trace_summary)]:
        data = jsent.load_artifact(path)
        assert tsent.load_artifact(path) == data
        norm = tsent.normalize(data)
        assert norm == jsent.normalize(data), path
        assert norm, path
        for tol in (0.25, 0.1):
            assert tsent.degrade(norm, tol) == jsent.degrade(norm, tol)


def _write(tmp_path, name, data):
    p = tmp_path / name
    p.write_text(json.dumps(data))
    return str(p)


def test_exit_codes_equal_the_jax_sentinel(jsent, trace_summary, tmp_path):
    history = str(ROOT / "BENCH_r*.json")
    newest = jsent.load_artifact(BENCH[-1])
    halved = dict(newest, value=newest["value"] / 2)
    cases = [
        ["--history", history, "--self-check"],
        ["--history", history, "--fresh", BENCH[-1]],
        ["--history", history, "--fresh", BENCH[-2], "--tolerance", "0.05"],
        ["--history", history, "--fresh",
         _write(tmp_path, "halved.json", halved)],
        ["--history", history, "--fresh", str(trace_summary)],
        ["--history", str(trace_summary), "--fresh", str(trace_summary),
         "--min-history", "1"],
        ["--history", str(trace_summary), "--self-check", "--min-history",
         "1"],
        ["--history", str(tmp_path / "none_*.json"), "--self-check"],
        ["--history", history, "--fresh", str(tmp_path / "missing.json")],
    ]
    rcs = []
    for argv in cases:
        want = _quiet(jsent.main, argv)
        got = _quiet(tsent.main, argv)
        assert got == want, argv
        rcs.append(got)
    # the cases cover every exit code
    assert set(rcs) == {0, 1, 2}


def test_the_default_history_is_the_cards(tmp_path, monkeypatch):
    """Only ``BENCH_H100_r*.json`` is globbed by default: a repo holding the
    JAX package's history alone has nothing to band."""
    assert tsent.DEFAULT_HISTORY == "BENCH_H100_r*.json"
    (tmp_path / "BENCH_r01.json").write_text(Path(BENCH[-1]).read_text())
    monkeypatch.setattr(tsent, "REPO_ROOT", tmp_path)
    assert _quiet(tsent.main, ["--self-check"]) == 2
    (tmp_path / "BENCH_H100_r01.json").write_text(
        Path(BENCH[-1]).read_text())
    assert _quiet(tsent.main, ["--self-check", "--min-history", "1"]) == 0


def test_the_committed_h100_history_is_the_cards_and_armed():
    """The committed ``BENCH_H100_r*.json`` lines come from the card (its
    name and power limit in every case they hold, both roofline shares in
    (0, 1], the moments kernel and a chaos kernel launched once a batch of
    the five timed streams, the fused kernel never at ``auto``), and the
    port's default ``perf_sentinel --self-check`` passes on them: the
    newest line within the band of their median at the default
    ``--min-history 2``, and a synthetic 2x-tolerance regression of it
    trips the band."""
    committed = sorted(glob.glob(str(ROOT / tsent.DEFAULT_HISTORY)))
    assert len(committed) >= 2
    for path in committed:
        data = tsent.load_artifact(path)
        for name in ("headline", "scale", "desi"):
            if name != "headline" and name not in data:
                continue
            case = data if name == "headline" else data[name]
            assert case["device_kind"].startswith("NVIDIA")
            assert case["power_limit_w"] > 0
            assert 0 < case["roofline_frac"] <= 1
            assert 0 < case["measured_roofline_frac"] <= 1
            reps = 10 if name == "headline" else 3
            scored = 5 * reps * case["n_batches"]
            la = case["kernel_launches"]
            assert la["moments"] == scored
            assert la["chaos"] + la["chaos_tiles"] == scored
            assert la["fused_window_moments"] == 0
    newest = tsent.normalize(tsent.load_artifact(committed[-1]))
    args = (committed, tsent.degrade(newest, 0.25), 0.25, 2, 0.05, "x")
    assert _quiet(tsent.run_check, *args) == 1
    assert _quiet(tsent.run_check, committed, newest, 0.25, 2, 0.05,
                  "x") == 0
    assert _quiet(tsent.main, ["--self-check"]) == 0
