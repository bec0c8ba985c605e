"""Live-acquisition failover chaos harness of the port (a copy of the JAX
package's ``scripts/stream_chaos.py`` that drives
``sm_distributed_tpu_torch``).

Runs TWO real service replicas — separate processes sharing one
partitioned spool AND one work dir (so either can serve chunk appends
for any acquisition) — drives a live streaming acquisition over HTTP
(``POST /submit mode=stream`` + ``POST /datasets/<id>/pixels``), then
takes the claim-owning replica away mid-acquisition:

- ``kill``:  SIGKILL the owner after the first provisional re-rank.  The
  peer's takeover scan fences + requeues the stream job; the resumed job
  rebuilds its view from the committed chunk log, the instrument keeps
  posting chunks to the survivor, and ``POST finish`` converges.
- ``drain``: SIGTERM the owner (controller drain).  The drain hand-off
  republishes the live stream job WITHOUT burning an attempt
  (``sm_recovery_events_total{event="stream.drain_handoff"}``); the
  peer resumes from the same chunk-log checkpoint.

Both variants must converge to a report **bit-identical**
(``check_exact=True``) to the one-shot batch run of the same spectra,
with the exactly-once invariants of ``drivers/replica_chaos.py``: the spool
holds the stream message in ``done/`` exactly once, the ledger carries
exactly one FINISHED row, zero tmp/lease/heartbeat debris anywhere
(committed chunk-log files are results, not debris), and an exactly-once
ingest census — every chunk committed once no matter which replica
served it or how many times the instrument retried.

Usage::

    python -m sm_distributed_tpu_torch.drivers.stream_chaos          # both
    python -m sm_distributed_tpu_torch.drivers.stream_chaos --smoke  # same two
    python -m sm_distributed_tpu_torch.drivers.stream_chaos --only kill
    python -m sm_distributed_tpu_torch.drivers.stream_chaos --list
    ... --backend numpy_ref --device cpu      # off the card

The replica worker process is ``drivers/replica_chaos.py
--replica-serve`` (the full AnnotationService stack); this file is only the
driver.  On the card both replicas and the golden run score on
``torch_cuda``; each replica process pays its own CUDA start.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.chaos_sweep import (
    REPO_ROOT,
    debris,
    deep_merge,
    sub_env,
)
from sm_distributed_tpu_torch.drivers.replica_chaos import (
    MODULE as REPLICA_MODULE,
    read_report,
)
from sm_distributed_tpu_torch.engine.daemon import (
    QUEUE_ANNOTATE,
    QueuePublisher,
    _STATES,
)
from sm_distributed_tpu_torch.engine.storage import JobLedger
from sm_distributed_tpu_torch.io.fixtures import (
    FIXTURE_FORMULAS,
    generate_synthetic_dataset,
)
from sm_distributed_tpu_torch.io.imzml import ImzMLReader
from sm_distributed_tpu_torch.service.leases import owned_shards, shard_of

REPLICAS = ("r0", "r1")       # r0 is always the owner/victim
VICTIM = "r0"
SURVIVOR = "r1"
SHARDS = 8
DS_ID = "live"
N_CHUNKS = 3

# off-lattice spheroid (odd dims force the pad/bucket path, same fixture
# shape tests/test_stream.py pins) — small enough that a scenario is seconds
FIXTURE = dict(nrows=9, ncols=11, formulas=FIXTURE_FORMULAS[:8],
               present_fraction=0.5, noise_peaks=12, mz_jitter_ppm=0.5,
               seed=41)

SM_TEMPLATE = {
    "backend": "numpy_ref",
    "fdr": {"decoy_sample_size": 8, "seed": 42},
    "parallel": {"formula_batch": 16, "checkpoint_every": 2,
                 "resident_datasets": 2, "order_ions": "table"},
    "storage": {"store_images": False},
    "service": {"workers": 2, "poll_interval_s": 0.05, "job_timeout_s": 60.0,
                "max_attempts": 3, "backoff_base_s": 0.05,
                "backoff_max_s": 0.2, "backoff_jitter": 0.05,
                "heartbeat_interval_s": 0.2, "stale_after_s": 1.0,
                "drain_timeout_s": 10.0, "http_port": 0,
                "quarantine_after": 20,
                "replicas": len(REPLICAS), "spool_shards": SHARDS,
                "replica_heartbeat_interval_s": 0.25,
                "replica_stale_after_s": 1.0,
                "takeover_interval_s": 0.3,
                "stream": {"idle_timeout_s": 60.0, "poll_interval_s": 0.05,
                           "rescore_min_chunks": 1}},
}


@dataclass
class Scenario:
    """Take the claim-owning replica away mid-acquisition."""

    name: str
    kill_sig: int                 # signal delivered to the owner
    note: str = ""
    expect_rc: int | None = None  # owner's exit code (None = -kill_sig)
    # drain republishes via the hand-off seam; a SIGKILL owner leaves its
    # claim for the survivor's takeover scan to fence + requeue
    expect_handoff_event: str | None = None


SCENARIOS: list[Scenario] = [
    Scenario("kill", signal.SIGKILL,
             "owner SIGKILLed after the first provisional re-rank; peer "
             "takeover fences + requeues, resumes from the chunk log"),
    Scenario("drain", signal.SIGTERM,
             "owner drained (controller retire); stream job republished "
             "without burning an attempt, peer resumes",
             expect_rc=0, expect_handoff_event="stream.drain_handoff"),
]

SMOKE = ("kill", "drain")


# ------------------------------------------------------------------ plumbing
def _write_sm(base: Path, overrides: dict | None = None) -> Path:
    sm = deep_merge(json.loads(json.dumps(SM_TEMPLATE)), overrides or {})
    sm["work_dir"] = str(base / "work")
    sm["storage"] = dict(sm["storage"], results_dir=str(base / "results"))
    p = base / "sm.json"
    p.write_text(json.dumps(sm, indent=2))
    return p


def _pick_msg_id() -> str:
    """A msg id whose spool shard the victim owns while both replicas are
    alive — guarantees the victim is the replica running the stream job."""
    mine = owned_shards(VICTIM, set(REPLICAS), SHARDS)
    for i in range(256):
        cand = f"live{i}"
        if shard_of(cand, SHARDS) in mine:
            return cand
    raise RuntimeError("no candidate msg id lands on the victim's shards")


def _run_replica(base: Path, sm_conf: Path, rid: str,
                 idle_exit: float = 2.0):
    log = base / "logs" / f"{rid}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", REPLICA_MODULE, "--replica-serve", str(base / "queue"), str(sm_conf),
           "--replica-id", rid, "--idle-exit", str(idle_exit),
           "--metrics-dump", str(base / "metrics" / f"{rid}.prom"),
           "--ports-dir", str(base / "ports")]
    with open(log, "w") as fh:
        return subprocess.Popen(cmd, env=sub_env(None), stdout=fh, stderr=fh,
                                cwd=str(REPO_ROOT)), log


def _wait_port(base: Path, rid: str, timeout_s: float = 60.0) -> int:
    pf = base / "ports" / f"{rid}.port"
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pf.exists():
            try:
                return int(pf.read_text())
            except ValueError:
                pass
        time.sleep(0.05)
    raise RuntimeError(f"{rid}: port file never appeared")


def _req(port: int, path: str, payload: dict | None = None,
         timeout_s: float = 10.0) -> tuple[int, dict]:
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        method="POST" if payload is not None else "GET", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_chunk(port: int, seq: int, coords, spectra,
                retries: int = 40) -> None:
    """Instrument-side chunk POST with the documented retry contract: on a
    connection error or 5xx, re-POST the SAME seq — idempotent by design."""
    body = {"seq": seq, "coords": coords,
            "mzs": [list(s[0]) for s in spectra],
            "ints": [list(s[1]) for s in spectra]}
    last = None
    for _ in range(retries):
        try:
            status, out = _req(port, f"/datasets/{DS_ID}/pixels", body)
        except OSError as exc:
            last, status = exc, -1
        if status == 200:
            return
        last = last if status == -1 else f"HTTP {status}: {out}"
        time.sleep(0.25)
    raise RuntimeError(f"chunk {seq} never accepted: {last}")


def _stream_state(port: int, msg_id: str) -> dict:
    """The acquisition's view through GET /jobs/<id>: job state + the
    provisional ``partial.stream`` coverage block."""
    try:
        status, job = _req(port, f"/jobs/{msg_id}")
    except OSError:
        return {}
    if status != 200:
        return {}
    part = (job.get("partial") or {}).get("stream") or {}
    return {"state": job.get("state"), "chunks": part.get("chunks", 0),
            "pixels": part.get("pixels", 0)}


def _wait_stream(port: int, msg_id: str, min_chunks: int,
                 timeout_s: float = 90.0) -> dict:
    deadline = time.time() + timeout_s
    last: dict = {}
    while time.time() < deadline:
        last = _stream_state(port, msg_id)
        if last.get("chunks", 0) >= min_chunks:
            return last
        time.sleep(0.1)
    raise RuntimeError(
        f"provisional coverage never reached {min_chunks} chunks: {last}")


def _spool_census(root: Path) -> dict:
    return {s: sorted(p.stem for p in (root / s).glob("*.json"))
            for s in _STATES}


def _metric_value(text: str, prefix: str) -> float:
    total = 0.0
    for line in text.splitlines():
        if line.startswith(prefix):
            try:
                total += float(line.rsplit(" ", 1)[1])
            except (IndexError, ValueError):
                pass
    return total


# -------------------------------------------------------------- fixture/golden
def build_fixture(base: Path):
    fx_dir = base / "fixture"
    imzml_path, truth = generate_synthetic_dataset(fx_dir, **FIXTURE)
    with ImzMLReader(imzml_path) as rd:
        coords = rd.coordinates.tolist()
        spectra = [tuple(a.tolist() for a in rd.read_spectrum(i))
                   for i in range(rd.n_spectra)]
    n = len(coords)
    edges = [round(i * n / N_CHUNKS) for i in range(N_CHUNKS + 1)]
    chunks = [(coords[edges[i]:edges[i + 1]],
               spectra[edges[i]:edges[i + 1]]) for i in range(N_CHUNKS)]
    return imzml_path, truth.formulas, chunks


def _msg(msg_id: str, formulas: list[str], input_path: str,
         mode: str) -> dict:
    m = {"ds_id": DS_ID, "ds_name": DS_ID, "msg_id": msg_id,
         "input_path": input_path, "formulas": formulas, "tenant": "t0",
         "ds_config": {"isotope_generation": {"adducts": ["+H"]},
                       "image_generation": {"ppm": 3.0}}}
    if mode == "stream":
        m["mode"] = "stream"
    return m


def run_golden(base: Path, imzml_path: Path, formulas: list[str],
               overrides: dict | None = None):
    """The one-shot batch run over the SAME spectra — the report every
    streaming scenario must converge to bit-identically."""
    gbase = base / "golden"
    gbase.mkdir(parents=True)
    sm_conf = _write_sm(gbase, overrides)
    QueuePublisher(gbase / "queue").publish(
        _msg("g0", formulas, str(imzml_path), mode="batch"))
    proc, log = _run_replica(gbase, sm_conf, "r0")
    rc = proc.wait(timeout=180)
    if rc != 0:
        raise RuntimeError(f"golden run failed rc={rc}:\n"
                           f"{log.read_text()[-3000:]}")
    return read_report(gbase / "results", DS_ID)


# ------------------------------------------------------------------ invariants
def check_invariants(base: Path, golden, msg_id: str,
                     errs: list[str]) -> None:
    import pandas as pd

    root = base / "queue" / QUEUE_ANNOTATE
    census = _spool_census(root)
    if census["done"] != [msg_id]:
        errs.append(f"spool not exactly-once done: {census}")
    others = {s: v for s, v in census.items() if s != "done" and v}
    if others:
        errs.append(f"messages left outside done/: {others}")
    from sm_distributed_tpu_torch.service.leases import LeaseStore

    LeaseStore(root, "operator").sweep_orphans(root, max_age_s=0.0)
    leftover = sorted(p.name for p in (root / "leases").glob("*.json"))
    if leftover:
        errs.append(f"lease files for terminal messages: {leftover}")
    # checkpoint shards from the pre-failover attempt are legitimate resume
    # state (replica_chaos rule); everything else must be gone — including
    # torn chunk-append tmps under work/stream
    left = [p for p in debris([root, base / "results", base / "work"])
            if ".ckpt." not in p]
    if left:
        errs.append(f"tmp/heartbeat/lease debris: {left}")
    ledger = JobLedger(base / "results")
    try:
        ledger.fail_stale_started(ds_ids=[DS_ID], before=time.time())
        jobs = ledger.jobs(DS_ID)
        if jobs.empty:
            errs.append(f"{DS_ID}: no ledger rows")
        else:
            if jobs.iloc[-1].status != "FINISHED":
                errs.append(f"{DS_ID}: newest job {jobs.iloc[-1].status}")
            n_fin = int((jobs.status == "FINISHED").sum())
            if n_fin != 1:
                errs.append(f"{DS_ID}: {n_fin} FINISHED rows (double "
                            f"completion)")
            idx = ledger._conn.execute(
                "SELECT COUNT(*) FROM annotation WHERE ds_id=?",
                (DS_ID,)).fetchone()[0]
            if idx != len(golden[0]):
                errs.append(f"{DS_ID}: index rows {idx} != golden "
                            f"{len(golden[0])}")
    finally:
        ledger.close()
    # the tentpole: bit-identical to batch, not merely close
    try:
        got = read_report(base / "results", DS_ID)
    except Exception as exc:
        errs.append(f"{DS_ID}: unreadable results: {exc}")
        return
    for label, g, w in (("annotations", got[0], golden[0]),
                        ("all_metrics", got[1], golden[1])):
        try:
            pd.testing.assert_frame_equal(g, w, check_exact=True)
        except AssertionError as e:
            errs.append(f"{DS_ID}: {label} not bit-identical to batch: "
                        f"{str(e).splitlines()[-1]}")
    # exactly-once ingest census: committed chunk log == the acquisition,
    # no more — duplicates/retries never doubled a chunk
    stream_dir = base / "work" / "stream" / DS_ID
    man = stream_dir / "manifest.json"
    if not man.is_file():
        errs.append("chunk-log manifest missing after convergence")
    else:
        m = json.loads(man.read_text())
        if not m.get("finished"):
            errs.append(f"manifest not sealed: {m}")
        seqs = sorted(int(s) for s in m.get("chunks", {}))
        if seqs != list(range(N_CHUNKS)):
            errs.append(f"manifest seqs {seqs} != 0..{N_CHUNKS - 1}")
        on_disk = sorted(stream_dir.glob("chunk_*.npz"))
        if len(on_disk) != N_CHUNKS:
            errs.append(f"{len(on_disk)} chunk files on disk, want "
                        f"{N_CHUNKS}: {[p.name for p in on_disk]}")


def run_scenario(sc: Scenario, work: Path, chunks, formulas: list[str],
                 golden, overrides: dict | None = None,
                 verbose: bool = False) -> dict:
    base = work / sc.name
    base.mkdir(parents=True)
    sm_conf = _write_sm(base, overrides)
    msg_id = _pick_msg_id()
    QueuePublisher(base / "queue").publish(
        _msg(msg_id, formulas, f"stream://{DS_ID}", mode="stream"))
    procs: dict[str, subprocess.Popen] = {}
    result = {"scenario": sc.name, "ok": False}
    root = base / "queue" / QUEUE_ANNOTATE
    t0 = time.time()
    try:
        # start the victim ALONE so it deterministically claims the stream
        # job (its shard is the victim's under the 2-replica assignment, so
        # the later-joining peer never steals it)
        procs[VICTIM], victim_log = _run_replica(base, sm_conf, VICTIM,
                                                 idle_exit=3.0)
        vport = _wait_port(base, VICTIM)
        # generous: this box can be 1-core and a cold replica pays the
        # full torch import (on the card, its CUDA start too) before its
        # first dispatcher tick
        deadline = time.time() + 120.0
        while time.time() < deadline:
            if _stream_state(vport, msg_id).get("state") == "running":
                break
            if procs[VICTIM].poll() is not None:
                result["error"] = "victim exited before claiming"
                return result
            time.sleep(0.05)
        else:
            result["error"] = "victim never claimed the stream job"
            return result
        procs[SURVIVOR], _ = _run_replica(base, sm_conf, SURVIVOR,
                                          idle_exit=3.0)
        sport = _wait_port(base, SURVIVOR)
        # acquisition begins: first chunk through the victim's API, and the
        # scenario only proceeds once a provisional re-rank PUBLISHED — the
        # failover below demonstrably lands mid-acquisition, not before it
        _post_chunk(vport, 0, *chunks[0])
        _wait_stream(vport, msg_id, min_chunks=1)
        procs[VICTIM].send_signal(sc.kill_sig)
        rc_victim = procs[VICTIM].wait(timeout=60)
        result["rc_victim"] = rc_victim
        want_rc = -sc.kill_sig if sc.expect_rc is None else sc.expect_rc
        if rc_victim != want_rc:
            result["error"] = (f"victim rc {rc_victim}, want {want_rc}:\n"
                               f"{victim_log.read_text()[-2000:]}")
            return result
        # the instrument keeps acquiring: remaining chunks through the peer
        # (shared work dir — any replica serves appends for any acquisition)
        for seq in range(1, N_CHUNKS):
            _post_chunk(sport, seq, *chunks[seq])
        # peer takeover/hand-off must resume provisional re-ranking from the
        # chunk-log checkpoint and cover the full acquisition
        _wait_stream(sport, msg_id, min_chunks=N_CHUNKS)
        status, out = _req(sport, f"/datasets/{DS_ID}/finish", {})
        if status != 200:
            result["error"] = f"finish rejected: HTTP {status} {out}"
            return result
        deadline = time.time() + 120.0
        while time.time() < deadline:
            if (root / "done" / f"{msg_id}.json").exists():
                break
            if procs[SURVIVOR].poll() is not None:
                result["error"] = (f"survivor exited rc="
                                   f"{procs[SURVIVOR].poll()} before "
                                   f"convergence: {_spool_census(root)}")
                return result
            time.sleep(0.1)
        else:
            result["error"] = (f"did not converge in 120s: "
                               f"{_spool_census(root)}")
            return result
        result["converge_s"] = round(time.time() - t0, 1)
        try:
            rc = procs[SURVIVOR].wait(timeout=30)
        except subprocess.TimeoutExpired:
            procs[SURVIVOR].send_signal(signal.SIGTERM)
            rc = procs[SURVIVOR].wait(timeout=30)
        result["rc_survivor"] = rc
        errs: list[str] = []
        if rc != 0:
            errs.append(f"survivor exit rc={rc}")
        check_invariants(base, golden, msg_id, errs)
        dump = base / "metrics" / f"{SURVIVOR}.prom"
        if not dump.exists():
            errs.append("survivor left no metrics dump")
        else:
            text = dump.read_text()
            if _metric_value(text, "sm_stream_reranks_total") < 1:
                errs.append("survivor published no provisional re-rank "
                            "after failover")
        if sc.expect_handoff_event:
            needle = f'event="{sc.expect_handoff_event}"'
            vdump = base / "metrics" / f"{VICTIM}.prom"
            seen = (vdump.exists() and needle in vdump.read_text()) or \
                needle.split('"')[1] in victim_log.read_text()
            if not seen:
                errs.append(f"victim recorded no {sc.expect_handoff_event}")
        if errs:
            result["error"] = "; ".join(errs)
            return result
        result["ok"] = True
        return result
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


def run_sweep(work: Path, only: list[str] | None = None,
              verbose: bool = False, backend: str = "numpy_ref",
              device: str = "cpu") -> list[dict]:
    os.environ.pop("SM_FAILPOINTS", None)
    names = {sc.name for sc in SCENARIOS}
    if only is not None and not set(only) <= names:
        raise RuntimeError(f"unknown scenario names: {set(only) - names}")
    scenarios = SCENARIOS if only is None else [
        sc for sc in SCENARIOS if sc.name in only]
    work.mkdir(parents=True, exist_ok=True)
    overrides = {"backend": backend, "device": device}
    imzml_path, formulas, chunks = build_fixture(work)
    t0 = time.time()
    golden = run_golden(work, imzml_path, formulas, overrides)
    print(f"golden batch report: {len(golden[0])} annotations, "
          f"{len(golden[1])} scored ions ({time.time() - t0:.1f}s)")
    results = []
    for sc in scenarios:
        t0 = time.time()
        r = run_scenario(sc, work, chunks, formulas, golden, overrides,
                         verbose=verbose)
        r["seconds"] = round(time.time() - t0, 1)
        status = "OK " if r["ok"] else "FAIL"
        print(f"[{status}] {sc.name:<8} {r['seconds']:>5.1f}s  {sc.note}")
        if not r["ok"]:
            print(f"       error: {r.get('error')}")
        results.append(r)
    n_ok = sum(r["ok"] for r in results)
    print(f"stream chaos: {n_ok}/{len(results)} failovers converged "
          f"bit-identical to batch with exactly-once outcomes")
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help=f"CI subset: {', '.join(SMOKE)}")
    ap.add_argument("--only", default=None)
    ap.add_argument("--list", action="store_true", dest="list_scenarios")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    add_device_arguments(ap)
    args = ap.parse_args(argv)

    if args.list_scenarios:
        for sc in SCENARIOS:
            print(f"{sc.name:<8} {sc.note}")
        return 0
    require_card(ap, args.device)
    only = list(SMOKE) if args.smoke else (
        args.only.split(",") if args.only else None)
    import shutil
    import tempfile

    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_stream_chaos_"))
    try:
        results = run_sweep(work, only=only, verbose=args.verbose,
                            backend=args.backend, device=args.device)
    finally:
        if not args.keep and args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
