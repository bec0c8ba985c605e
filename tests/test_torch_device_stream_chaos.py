"""The port's ``drivers/device_chaos.py`` and ``drivers/stream_chaos.py``
beside the JAX package's scripts of the same names, each run as a user runs
it (``--smoke``; the port's with ``--device cpu``), the two packages' runs
side by side as subprocesses.  Each run's own gate holds its results
bit-equal to its own golden run; this test reads both runs' work
directories the same way and holds the outcomes equal between the
packages: the quarantined chip, the leases before and after the
quarantine and after the readmission, the exactly-once spool and ledger,
the stream's ingest census, and the FDR ranks.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest

ROOT = Path(__file__).resolve().parent.parent
DRIVER_TIMEOUT_S = 600


def _start(argv: list[str], log: Path) -> tuple[subprocess.Popen, object]:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SM_FAILPOINTS", None)
    fh = open(log, "w")
    return subprocess.Popen([sys.executable, *argv], env=env, cwd=str(ROOT),
                            stdout=fh, stderr=subprocess.STDOUT), fh


def _run_both(tmp_path: Path, jax_argv: list[str], port_argv: list[str],
              together: bool) -> dict:
    """Run the JAX script and the port's driver, at once or one after the
    other; returns each side's exit code, output and work directory."""
    sides = {"jax": jax_argv, "port": port_argv}
    procs = {}
    out = {}

    def finish(side: str) -> None:
        proc, fh, work = procs[side]
        rc = proc.wait(timeout=DRIVER_TIMEOUT_S)
        fh.close()
        out[side] = {"rc": rc, "work": work,
                     "log": (tmp_path / f"{side}.log").read_text()}

    try:
        for side, argv in sides.items():
            work = tmp_path / side
            procs[side] = (*_start([*argv, "--work", str(work)],
                                   tmp_path / f"{side}.log"), work)
            if not together:
                finish(side)
        for side in sides:
            if side not in out:
                finish(side)
    finally:
        for proc, fh, _work in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
    return out


def _fdr_ranks(parquet: Path) -> list:
    ann = pd.read_parquet(parquet)
    return sorted(zip(ann["sf"], ann["adduct"], ann["fdr"]))


# ------------------------------------------------------------ device chaos
def _device_outcome(work: Path) -> dict:
    """What a device_chaos run did, read from its work directory: per job
    the leases (``device_token_acquired``), quarantines and fault kinds on
    its trace, the spool, and the stored annotations."""
    base = work / "device_chaos"
    jobs: dict[str, dict] = {}
    for f in sorted((base / "work" / "traces").glob("*.jsonl")):
        recs = [json.loads(ln) for ln in f.read_text().splitlines() if ln]
        for r in sorted(recs, key=lambda r: r["ts"]):
            if r.get("kind") != "event":
                continue
            j = jobs.setdefault(r.get("job_id", ""), {
                "leases": [], "quarantined": [], "faults": []})
            attrs = r.get("attrs") or {}
            if r["name"] == "device_token_acquired":
                j["leases"].append(list(attrs.get("devices", [])))
            elif r["name"] == "device_quarantine":
                j["quarantined"].append(attrs["device"])
            elif r["name"] == "device_fault":
                j["faults"].append(attrs["kind"])
    root = base / "queue" / "sm_annotate"
    spool = {s: sorted(p.name for p in (root / s).glob("*.json"))
             for s in ("pending", "running", "done", "failed", "quarantine")}
    return {"jobs": jobs, "spool": spool,
            "results": base / "results"}


# the JAX script's own caveats under load (ROADMAP queue 3): its fault
# stage arms the sticky fault before the lease poll marks chip 3 bad, and
# its readmission stage reads only its own re-probe's answer, though the
# pool's grants and the telemetry sampler re-probe too.  The port's driver
# decides both by states (tests/test_torch_device_chaos_races.py)
DEVICE_REFERENCE_CAVEATS = ("no device_quarantine event for chip 3",
                            "chip 3 never readmitted")


def test_device_chaos_smoke_matches_the_jax_script(tmp_path):
    jax_argv = [str(ROOT / "scripts" / "device_chaos.py"), "--smoke"]
    runs = _run_both(
        tmp_path, jax_argv,
        ["-m", "sm_distributed_tpu_torch.drivers.device_chaos", "--smoke",
         "--device", "cpu"], together=True)
    if runs["jax"]["rc"] != 0 and any(
            c in runs["jax"]["log"] for c in DEVICE_REFERENCE_CAVEATS):
        # such a run is no reference: it is made once more, alone.  The
        # port's run is held as it came
        again = tmp_path / "again"
        again.mkdir()
        proc, fh = _start([*jax_argv, "--work", str(again / "jax")],
                          again / "jax.log")
        try:
            rc = proc.wait(timeout=DRIVER_TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
        runs["jax"] = {"rc": rc, "work": again / "jax",
                       "log": (again / "jax.log").read_text()}
    for side, run in runs.items():
        assert run["rc"] == 0, (side, run["log"][-3000:])
    assert "device_chaos: OK" in runs["port"]["log"]
    got, want = (_device_outcome(runs[s]["work"]) for s in ("port", "jax"))
    for o in (got, want):
        jobs = o["jobs"]
        assert jobs["golden4"]["leases"] == [[0, 1, 2, 3]]
        assert jobs["fault4"]["quarantined"] == [3]
        assert jobs["fault4"]["faults"][0] == "sticky"
        assert jobs["fault4"]["leases"][-1] == [0, 1, 2]
        assert jobs["after4"]["leases"][-1] == [0, 1, 2, 3]
        # within each package the resumed job is bit-equal to its golden
        res = o["results"]
        pd.testing.assert_frame_equal(
            pd.read_parquet(res / "fault4" / "annotations.parquet")
            .sort_values(["sf", "adduct"]).reset_index(drop=True),
            pd.read_parquet(res / "golden4" / "annotations.parquet")
            .sort_values(["sf", "adduct"]).reset_index(drop=True),
            check_exact=True)
    assert got["jobs"] == want["jobs"]
    assert got["spool"] == want["spool"]
    assert got["spool"]["done"] == ["after4.json", "fault4.json",
                                    "golden4.json"]
    for ds in ("golden4", "fault4", "after4"):
        assert _fdr_ranks(got["results"] / ds / "annotations.parquet") == \
            _fdr_ranks(want["results"] / ds / "annotations.parquet"), ds


# ------------------------------------------------------------ stream chaos
def _stream_outcome(work: Path, scenario: str) -> dict:
    """What one stream_chaos scenario left: the spool, the ledger's rows,
    the chunk log's manifest and files, the hand-off count in the victim's
    metrics, and the stored annotations' FDR ranks."""
    import sqlite3

    base = work / scenario
    root = base / "queue" / "sm_annotate"
    spool = {s.name: sorted(p.stem for p in s.glob("*.json"))
             for s in sorted(root.iterdir())
             if s.is_dir() and s.name in ("pending", "running", "done",
                                          "failed", "quarantine")}
    con = sqlite3.connect(base / "results" / "engine.sqlite")
    try:
        statuses = [r[0] for r in con.execute(
            "SELECT status FROM job WHERE ds_id='live' ORDER BY id")]
    finally:
        con.close()
    stream = base / "work" / "stream" / "live"
    manifest = json.loads((stream / "manifest.json").read_text())
    victim = base / "metrics" / "r0.prom"
    handoff = victim.exists() and \
        'event="stream.drain_handoff"' in victim.read_text()
    return {
        "spool": spool,
        "finished": statuses.count("FINISHED"), "newest": statuses[-1],
        "manifest": {"finished": bool(manifest.get("finished")),
                     "seqs": sorted(int(s) for s in manifest["chunks"])},
        "chunk_files": len(list(stream.glob("chunk_*.npz"))),
        "handoff": handoff,
        "fdr": _fdr_ranks(base / "results" / "live" / "annotations.parquet"),
    }


def test_stream_chaos_smoke_matches_the_jax_script(tmp_path):
    import scripts.stream_chaos as jsc
    import sm_distributed_tpu_torch.drivers.stream_chaos as tsc

    assert [(s.name, s.kill_sig, s.expect_rc, s.expect_handoff_event)
            for s in tsc.SCENARIOS] == [
        (s.name, s.kill_sig, s.expect_rc, s.expect_handoff_event)
        for s in jsc.SCENARIOS]
    assert tsc.SMOKE == jsc.SMOKE
    runs = _run_both(
        tmp_path, [str(ROOT / "scripts" / "stream_chaos.py"), "--smoke"],
        ["-m", "sm_distributed_tpu_torch.drivers.stream_chaos", "--smoke",
         "--device", "cpu"],
        # one after the other: each sweep runs five replica processes
        # whose liveness horizon is one second
        together=False)
    for side, run in runs.items():
        assert run["rc"] == 0, (side, run["log"][-3000:])
        assert "stream chaos: 2/2 failovers converged" in run["log"], side
    for scenario in jsc.SMOKE:
        got = _stream_outcome(runs["port"]["work"], scenario)
        want = _stream_outcome(runs["jax"]["work"], scenario)
        assert got == want, scenario
        assert got["spool"]["done"] == [tsc._pick_msg_id()]
        assert got["finished"] == 1 and got["newest"] == "FINISHED"
        assert got["manifest"] == {"finished": True,
                                   "seqs": list(range(tsc.N_CHUNKS))}
        assert got["chunk_files"] == tsc.N_CHUNKS
        assert got["handoff"] == (scenario == "drain")
    # within each package the failed-over report equals its golden batch
    # run bit for bit
    for side, run in runs.items():
        golden = run["work"] / "golden" / "results"
        for scenario in jsc.SMOKE:
            res = run["work"] / scenario / "results"
            for name in ("annotations", "all_metrics"):
                pd.testing.assert_frame_equal(
                    pd.read_parquet(res / "live" / f"{name}.parquet")
                    .sort_values(["sf", "adduct"]).reset_index(drop=True),
                    pd.read_parquet(golden / "live" / f"{name}.parquet")
                    .sort_values(["sf", "adduct"]).reset_index(drop=True),
                    check_exact=True, obj=f"{side} {scenario} {name}")


@pytest.mark.parametrize("package", ["jax", "port"])
def test_stream_chaos_lists_the_same_scenarios(package):
    argv = ([str(ROOT / "scripts" / "stream_chaos.py")] if package == "jax"
            else ["-m", "sm_distributed_tpu_torch.drivers.stream_chaos"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, *argv, "--list"], env=env,
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == [
        "kill", "drain"]
