"""The port's ``drivers/trace_report.py`` against the JAX package's
``scripts/trace_report.py``.

Each package's service writes a trace of one job on the same spheroid
fixture (``numpy_ref``, in process).  On the same records the two reports'
``summarize`` and ``by_replica`` are equal key for key; across the two
packages' traces the summaries agree in names, counts and structure (the
times differ).  The port's ``compile`` events (``kernels/_build.py``: one
per nvcc build, one per load of a library built before, here from the
stub toolchain of ``tests/torch_fake_card.py``) give the same build and
load seconds in both reports.  The CLI validates both packages' traces,
reads a live service's ``/jobs/<id>/trace?raw=1`` and renders
``--by-replica``.
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

import scripts.trace_report as jtr
import sm_distributed_tpu_torch.drivers.trace_report as ttr
from sm_distributed_tpu_torch.utils import tracing as ttracing
from tests.torch_fake_card import fake_card

ROOT = Path(__file__).resolve().parent.parent
REPORT = "sm_distributed_tpu_torch.drivers.trace_report"
TIMEOUT_S = 120
FIXTURE = dict(nrows=12, ncols=12, formulas=None, present_fraction=0.5,
               noise_peaks=20, seed=5)


def _job_msg(path, truth, ds_id: str) -> dict:
    return {"ds_id": ds_id, "msg_id": ds_id, "input_path": str(path),
            "formulas": truth.formulas[:4],
            "ds_config": {"isotope_generation": {"adducts": ["+H"]}}}


def _one_job(harness_cls, fixtures_mod, tracing_mod, base: Path, name: str):
    path, truth = fixtures_mod.generate_synthetic_dataset(
        base / f"fx_{name}", **FIXTURE)
    h = harness_cls(base, name, sm_overrides={
        "parallel": {"formula_batch": 4}})
    try:
        status, _hd, body = h.submit(_job_msg(path, truth, "sph"))
        assert status == 202, body
        rows = h.wait_terminal([body["msg_id"]])
        assert rows["sph"]["state"] == "done", rows["sph"]
        trace = tracing_mod.trace_path(h.service.trace_dir, body["trace_id"])
        h_base = h.base
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = ttr.main(["--url", h_base, "--job", "sph", "--json"])
        live = json.loads(out.getvalue()) if rc == 0 else None
    finally:
        h.service.shutdown()
    return tracing_mod.read_trace(trace), trace, live


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """One job's trace from each package's service, and the port report of
    the port's job read live over ``--url/--job``."""
    from scripts.load_sweep import Harness as JHarness
    from sm_distributed_tpu.io import fixtures as jfixtures
    from sm_distributed_tpu.utils import tracing as jtracing
    from sm_distributed_tpu_torch.drivers.harness import Harness as THarness
    from sm_distributed_tpu_torch.io import fixtures as tfixtures

    base = tmp_path_factory.mktemp("trace_report")
    port, port_file, live = _one_job(THarness, tfixtures, ttracing, base,
                                     "port")
    ref, ref_file, _ = _one_job(JHarness, jfixtures, jtracing, base, "jax")
    return {"port": port, "jax": ref, "files": {"port": port_file,
                                                "jax": ref_file},
            "live": live}


@pytest.mark.parametrize("side", ["port", "jax"])
def test_summarize_equals_the_jax_report_on_the_same_records(traces, side):
    records = traces[side]
    assert records
    assert ttr.summarize(records) == jtr.summarize(records)
    assert ttr.by_replica(records) == jtr.by_replica(records)


def _shape(x):
    """The structure of a summary: keys, list lengths and value types, with
    every number replaced by its type."""
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_shape(v) for v in x]
    if isinstance(x, bool) or x is None or isinstance(x, str):
        return type(x).__name__
    return "number"


# the port's search times its backend set-up as a phase of its own (since
# its first slice); the JAX package's set-up runs inside ``score``
PORT_ONLY_PHASES = {"backend_setup"}


def test_summaries_agree_in_names_counts_and_structure(traces):
    got = ttr.summarize(traces["port"])
    want = jtr.summarize(traces["jax"])
    assert set(got["phases"]) - set(want["phases"]) == PORT_ONLY_PHASES
    got_phases = {k: v for k, v in got["phases"].items()
                  if k not in PORT_ONLY_PHASES}
    assert _shape({**got, "phases": got_phases}) == _shape(want)
    assert got["state"] == want["state"] == "done"
    assert {k: v["count"] for k, v in got_phases.items()} == {
        k: v["count"] for k, v in want["phases"].items()}
    assert got["events"] == want["events"]
    assert [{k: a[k] for k in ("attempt", "timed_out", "abandoned")}
            for a in got["attempts"]] == [
        {k: a[k] for k in ("attempt", "timed_out", "abandoned")}
        for a in want["attempts"]]
    for key in ("n_batches", "n_isocalc_worker_spans"):
        assert got[key] == want[key], key
    assert [(b["backend"], b["ions"]) for b in got["slowest_batches"]] == [
        (b["backend"], b["ions"]) for b in want["slowest_batches"]]
    assert {k: v is None for k, v in got["accounting"].items()} == {
        k: v is None for k, v in want["accounting"].items()}
    assert got["accounting"]["compile_s"] == \
        want["accounting"]["compile_s"] == 0.0


def test_url_job_reads_the_live_service(traces):
    """``--url/--job`` over the live route gives the file's summary."""
    assert traces["live"] == ttr.summarize(traces["port"])


def test_builds_and_loads_split_as_the_jax_report_splits_them(
        tmp_path, monkeypatch):
    """A trace holding the port's own ``compile`` events: two nvcc builds
    (``cached`` false, their seconds) and, in a fresh process state over
    the same build directory, two loads of the libraries built before
    (``cached`` true)."""
    from sm_distributed_tpu_torch.kernels import _build

    fake_card(monkeypatch, tmp_path)
    monkeypatch.setattr(ttracing, "_enabled", True)
    ctx = ttracing.new_trace(job_id="cold", trace_dir=tmp_path / "traces")
    with ttracing.attach(ctx):
        with ttracing.span("submit"):
            _build.build_all(("moments", "chaos"))
            for name, value in (("_libs", {}), ("_facts", {})):
                monkeypatch.setattr(_build, name, value)
            _build.build_all(("moments", "chaos"))
    ttracing.close_files()
    records = ttracing.read_trace(ttracing.trace_path(tmp_path / "traces",
                                                      ctx.trace_id))
    compiles = [r for r in records if r["name"] == "compile"]
    assert [(r["attrs"]["site"], bool(r["attrs"]["cached"]))
            for r in compiles] == [("moments", False), ("chaos", False),
                                   ("moments", True), ("chaos", True)]
    got = ttr.summarize(records)
    assert got == jtr.summarize(records)
    built_s = sum(r["attrs"]["dur_s"] for r in compiles[:2])
    assert got["accounting"]["compile_s"] == round(built_s, 6) > 0
    assert got["accounting"]["compile_cache_load_s"] == 0.0
    assert got["events"] == {"compile": 4}
    assert "kernel builds (nvcc)" in ttr.render(got)


def _cli(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", REPORT, *args], env=env,
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=TIMEOUT_S)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_validate_exits_zero_on_both_packages_traces(traces, side):
    trace = str(traces["files"][side])
    proc = _cli(trace, "--validate")
    assert proc.returncode == 0, proc.stderr
    assert "phase breakdown:" in proc.stdout
    assert "score" in proc.stdout
    proc = _cli(trace, "--validate", "--json", "--by-replica")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    records = traces[side]
    assert out == json.loads(json.dumps(
        {**jtr.summarize(records), "by_replica": jtr.by_replica(records)}))


def test_validate_fails_on_a_broken_record(tmp_path, traces):
    bad = tmp_path / "bad.jsonl"
    recs = [dict(r) for r in traces["port"]]
    recs[0].pop("ts", None)
    bad.write_text("".join(json.dumps(r) + "\n" for r in recs))
    proc = _cli(str(bad), "--validate")
    assert proc.returncode == 1
    assert "schema problems" in proc.stderr
    assert _cli(str(tmp_path / "missing.jsonl")).returncode == 1


@pytest.mark.parametrize("argv", [[], ["T.jsonl", "--url", "http://x"],
                                  ["--url", "http://x"]])
def test_usage_errors(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        ttr.main(argv)
    assert exc.value.code == 2
