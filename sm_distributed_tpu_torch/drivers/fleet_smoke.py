"""Fleet observability smoke gate of the port.

Port of phases 1 and 2 of the JAX package's ``scripts/fleet_smoke.py``,
both through real service stacks of the port:

1. **Fleet aggregation under a mid-scrape death.**  Three replica
   PROCESSES (``drivers.replica_chaos --replica-serve``) over one
   partitioned spool serve a batch of real jobs.  One replica is
   SIGKILLed while still alive in the registry; a survivor's
   ``/fleet/slo`` / ``/fleet/metrics`` / ``/fleet/status`` must all answer
   **200 with partial-view evidence** naming the dead peer — never a 500.
   After the survivors converge the remaining jobs, the fleet SLO report
   must be **bit-equal** to an independent recomputation from the union of
   the survivors' raw ``/metrics`` buckets (this driver's own parser and
   the documented attainment arithmetic — not the fleet-view code under
   test).
2. **On-demand device profiling.**  An in-process service on the
   ``torch_cuda`` backend with the fused window-moments kernel forced on
   runs real jobs; ``GET /debug/profile`` during one must answer 200 with
   the job among ``jobs_running`` and count in
   ``sm_profile_captures_total``.  On the card (``--device cuda``) the
   capture must also attribute device time to the fused kernel by class
   and inject ``device_kernel`` spans, stamped with the serving replica,
   into the running job's trace; on the CPU the profiler sees no device
   events, so those checks need the card.

The JAX script's phase 3 pins its ``PROFILE_r*.json`` history (TPU and CPU
records), which is not the port's, and has no counterpart here; its
``trace_report --by-replica`` step is replaced by the replica stamp on the
injected spans (the port has no ``trace_report`` yet).

Usage::

    python -m sm_distributed_tpu_torch.drivers.fleet_smoke   # on the card
    python -m sm_distributed_tpu_torch.drivers.fleet_smoke --only fleet
    ... --backend numpy_ref --device cpu     # off the card

Exit 0 = gate passes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.chaos_sweep import FIXTURE
from sm_distributed_tpu_torch.engine.daemon import (
    QUEUE_ANNOTATE,
    QueuePublisher,
)
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset

REPO_ROOT = Path(__file__).resolve().parents[2]
REPLICA_MODULE = "sm_distributed_tpu_torch.drivers.replica_chaos"
REPLICAS = ("r0", "r1", "r2")
VICTIM = "r0"
N_JOBS = 6
SHARDS = 8

SM_TEMPLATE = {
    "backend": "numpy_ref",
    "fdr": {"decoy_sample_size": 8, "seed": 42},
    "parallel": {"formula_batch": 16, "checkpoint_every": 2,
                 "resident_datasets": 2, "order_ions": "table"},
    "storage": {"store_images": False},
    "service": {"workers": 2, "poll_interval_s": 0.05, "job_timeout_s": 60.0,
                "max_attempts": 3, "backoff_base_s": 0.05,
                "backoff_max_s": 0.2, "backoff_jitter": 0.05,
                "heartbeat_interval_s": 0.2, "stale_after_s": 2.0,
                "drain_timeout_s": 10.0, "http_port": 0,
                "quarantine_after": 20,
                "replicas": len(REPLICAS), "spool_shards": SHARDS,
                # the kill→evidence window: the victim must still look
                # ALIVE in the registry while a survivor's fleet scrape
                # hits its closed port
                "replica_heartbeat_interval_s": 0.5,
                "replica_stale_after_s": 6.0,
                "takeover_interval_s": 0.5,
                # every /fleet/* request below must be a FRESH round
                "fleetview": {"scrape_timeout_s": 2.0, "cache_ttl_s": 0.0}},
}


def fail(msg: str) -> int:
    print(f"fleet_smoke: FAIL — {msg}", file=sys.stderr)
    return 1


def _http_json(base: str, path: str, timeout: float = 30.0):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _http_text(base: str, path: str, timeout: float = 30.0):
    with urllib.request.urlopen(f"{base}{path}", timeout=timeout) as r:
        return r.status, r.read().decode("utf-8", "replace")


# --------------------------------------------------- independent SLO math
def _parse_hist(text: str, family: str):
    """One UNLABELLED histogram family out of raw exposition text:
    ``(cumulative {le: count}, sum, count)``.  Deliberately a separate
    parser from service/fleetview.py — the recomputation below must not
    lean on the code under test."""
    cum: dict[float, int] = {}
    sum_, count, seen = 0.0, 0, False
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        if line.startswith(family + "_bucket{"):
            le = line.split('le="', 1)[1].split('"', 1)[0]
            seen = True
            if le != "+Inf":
                cum[float(le)] = int(float(line.rsplit(" ", 1)[1]))
        elif line.startswith(family + "_sum"):
            sum_ = float(line.rsplit(" ", 1)[1])
            seen = True
        elif line.startswith(family + "_count"):
            count = int(float(line.rsplit(" ", 1)[1]))
            seen = True
    return (cum, sum_, count) if seen else None


def _recompute_sli(texts: list[str], family: str, objective_s: float,
                   target: float) -> dict:
    """Fleet attainment for one SLI from the union of raw per-replica
    buckets, mirroring the documented arithmetic: summed cumulative
    bucket counts (integers — exact), the linear-interpolation
    ``fraction_below``, the family-level ``(f*n)/n`` aggregation, and
    the report's rounding."""
    union: dict[float, int] = {}
    count = 0
    for t in texts:
        parsed = _parse_hist(t, family)
        if parsed is None:
            continue
        cum, _s, c = parsed
        count += c
        for le, v in cum.items():
            union[le] = union.get(le, 0) + v
    entry = {"objective_s": objective_s, "target": target, "count": count}
    if not count:
        entry.update(attainment=None, violations=0, error_budget_burn=None)
        return entry
    les = sorted(union)
    cum_counts = [union[le] for le in les]
    counts = [cum_counts[0]] + [cum_counts[i] - cum_counts[i - 1]
                                for i in range(1, len(cum_counts))]
    below, lo = 0.0, 0.0
    for le, n in zip(les, counts):
        if objective_s >= le:
            below += n
        elif objective_s > lo:
            below += n * (objective_s - lo) / (le - lo)
            break
        else:
            break
        lo = le
    f = min(1.0, below / count)
    attained = (f * count) / count      # the family-level aggregation step
    entry.update(
        attainment=round(attained, 6),
        violations=round((1.0 - attained) * count),
        error_budget_burn=round((1.0 - attained) / (1.0 - target), 4))
    return entry


# ------------------------------------------------------- phase 1: fleet
def _start_replica(base: Path, sm_conf: Path, rid: str):
    log = base / "logs" / f"{rid}.log"
    log.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", REPLICA_MODULE,
           "--replica-serve", str(base / "queue"), str(sm_conf),
           "--replica-id", rid, "--idle-exit", "90.0",
           "--metrics-dump", str(base / "metrics" / f"{rid}.prom"),
           "--ports-dir", str(base / "ports")]
    env = dict(os.environ)
    env.pop("SM_FAILPOINTS", None)
    fh = open(log, "w")
    proc = subprocess.Popen(cmd, env=env, stdout=fh, stderr=fh,
                            cwd=str(REPO_ROOT))
    fh.close()
    return proc, log


def _port_of(base: Path, rid: str, deadline: float) -> int:
    pf = base / "ports" / f"{rid}.port"
    while time.time() < deadline:
        if pf.exists():
            try:
                return int(pf.read_text())
            except ValueError:
                pass
        time.sleep(0.05)
    raise TimeoutError(f"{rid} never wrote its port file")


def phase_fleet(work: Path, backend: str, device: str) -> int:
    base = work / "fleet"
    base.mkdir(parents=True)
    sm = json.loads(json.dumps(SM_TEMPLATE))
    sm["backend"] = backend
    sm["device"] = device
    sm["work_dir"] = str(base / "work")
    sm["storage"] = dict(sm["storage"], results_dir=str(base / "results"))
    sm_conf = base / "sm.json"
    sm_conf.write_text(json.dumps(sm, indent=2))

    imzml_path, truth = generate_synthetic_dataset(base / "fixture", **FIXTURE)
    msgs = [{
        "ds_id": f"f{i}", "ds_name": f"f{i}", "msg_id": f"f{i}",
        "input_path": str(imzml_path), "formulas": truth.formulas,
        "tenant": f"t{i % 2}",
        "ds_config": {"isotope_generation": {"adducts": ["+H"]},
                      "image_generation": {"ppm": 3.0}},
    } for i in range(N_JOBS)]
    pub = QueuePublisher(base / "queue")
    for m in msgs:
        pub.publish(m)

    procs: dict[str, subprocess.Popen] = {}
    try:
        for rid in REPLICAS:
            procs[rid], _ = _start_replica(base, sm_conf, rid)
        deadline = time.time() + 90.0
        ports = {rid: _port_of(base, rid, deadline) for rid in REPLICAS}
        surv = f"http://127.0.0.1:{ports['r1']}"

        # all three registered, seen through a survivor
        while time.time() < deadline:
            try:
                _s, peers = _http_json(surv, "/peers", timeout=5.0)
                if {p.get("replica_id") for p in peers.get("replicas", [])} \
                        >= set(REPLICAS):
                    break
            except OSError:
                pass
            time.sleep(0.2)
        else:
            return fail("survivor /peers never listed all replicas")

        # wholeness before the kill: a fresh full fleet round merges 3/3
        _s, slo0 = _http_json(surv, "/fleet/slo", timeout=30.0)
        if slo0["fleet"]["replicas_merged"] != len(REPLICAS):
            return fail(f"pre-kill fleet round merged "
                        f"{slo0['fleet']['replicas_merged']}/3: "
                        f"{slo0['fleet']['scrape_errors']}")

        # let some jobs finish so the SLI histograms are non-empty
        done_dir = base / "queue" / QUEUE_ANNOTATE / "done"
        deadline = time.time() + 180.0
        while time.time() < deadline:
            if len(list(done_dir.glob("*.json"))) >= 2:
                break
            if any(p.poll() is not None for p in procs.values()):
                return fail("a replica exited before the kill point")
            time.sleep(0.2)
        else:
            return fail("fewer than 2 jobs finished in 180s")

        # ---- the mid-scrape death: SIGKILL between heartbeats, then
        # immediately scrape through a survivor while the victim is still
        # ALIVE in the registry (stale_after 6 s) with a closed port
        procs[VICTIM].kill()
        procs[VICTIM].wait(timeout=10)
        code, slo_p = _http_json(surv, "/fleet/slo", timeout=30.0)
        if code != 200:
            return fail(f"/fleet/slo during partial window returned {code}")
        fl = slo_p["fleet"]
        if not fl["partial"] or VICTIM not in fl["scrape_errors"]:
            return fail(f"no partial-view evidence for the killed replica: "
                        f"{fl}")
        code, mtext = _http_text(surv, "/fleet/metrics", timeout=30.0)
        if code != 200:
            return fail(f"/fleet/metrics during partial window: {code}")
        if f"# fleetview: scrape of {VICTIM} failed:" not in mtext:
            return fail("merged exposition carries no scrape-failure "
                        "evidence comment")
        if "partial=true" not in mtext.splitlines()[0]:
            return fail(f"merged exposition header not partial: "
                        f"{mtext.splitlines()[0]!r}")
        code, st = _http_json(surv, "/fleet/status", timeout=30.0)
        if code != 200 or not st["partial"]:
            return fail(f"/fleet/status during partial window: code={code} "
                        f"partial={st.get('partial')}")
        if not st["replicas"][VICTIM]["alive"]:
            return fail("victim already stale at scrape time — the "
                        "mid-scrape window was missed (vacuous evidence)")
        print(f"fleet_smoke: partial view OK — {VICTIM} evidence: "
              f"{fl['scrape_errors'][VICTIM].splitlines()[0]}")

        # ---- survivors adopt the victim's shards and converge the rest
        deadline = time.time() + 240.0
        while time.time() < deadline:
            if len(list(done_dir.glob("*.json"))) >= N_JOBS:
                break
            alive = [r for r in REPLICAS if r != VICTIM
                     and procs[r].poll() is None]
            if not alive:
                return fail("both survivors exited before convergence")
            time.sleep(0.2)
        else:
            return fail(f"jobs did not converge after the kill "
                        f"({len(list(done_dir.glob('*.json')))}/{N_JOBS})")

        # ---- quiesce: wait out the victim's staleness window (a stale
        # peer is LISTED, not scraped — no longer an error), then check
        # bit-equality: fleet /fleet/slo vs this driver's own
        # recomputation from the survivors' raw buckets
        deadline = time.time() + 30.0
        while time.time() < deadline:
            _s, st2 = _http_json(surv, "/fleet/status", timeout=30.0)
            if not st2["replicas"][VICTIM]["alive"]:
                break
            time.sleep(0.5)
        else:
            return fail("victim never went stale in the registry")
        time.sleep(2.0)
        _s, raw1 = _http_text(surv, "/metrics", timeout=30.0)
        _s, raw2 = _http_text(f"http://127.0.0.1:{ports['r2']}", "/metrics",
                              timeout=30.0)
        code, slo = _http_json(surv, "/fleet/slo", timeout=30.0)
        if code != 200:
            return fail(f"post-convergence /fleet/slo returned {code}")
        fl = slo["fleet"]
        if fl["partial"]:
            return fail(f"post-convergence round still partial (victim "
                        f"should be stale, not an error): {fl}")
        if fl["replicas_merged"] != 2:
            return fail(f"expected 2 merged survivors, got "
                        f"{fl['replicas_merged']}")
        families = {
            "queue_wait": "sm_slo_queue_wait_seconds",
            "first_annotation": "sm_slo_first_annotation_seconds",
            "e2e": "sm_slo_e2e_seconds",
            "read": "sm_slo_read_seconds",
            "stream_partial": "sm_slo_stream_partial_seconds",
        }
        for sli, fam in families.items():
            got = slo["slos"][sli]
            want = _recompute_sli([raw1, raw2], fam, got["objective_s"],
                                  got["target"])
            if got != want:
                return fail(f"fleet SLO for {sli} is not bit-equal to the "
                            f"union of survivors' buckets:\n  fleet: {got}"
                            f"\n  union: {want}")
        if not slo["slos"]["e2e"]["count"]:
            return fail("e2e SLI empty after convergence — the "
                        "bit-equality check was vacuous")
        # evidence metric landed on the scraping survivor
        if f'sm_fleetview_scrape_errors_total{{replica="{VICTIM}"}}' \
                not in raw1:
            return fail("survivor carries no sm_fleetview_scrape_errors_"
                        "total evidence for the victim")
        print(f"fleet_smoke: fleet SLO bit-equal over "
              f"{slo['slos']['e2e']['count']} e2e + "
              f"{slo['slos']['queue_wait']['count']} queue-wait "
              f"observations from 2 survivors")
        return 0
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        for p in procs.values():
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# ----------------------------------------------------- phase 2: profiling
def phase_profile(work: Path, device: str) -> int:
    from sm_distributed_tpu_torch.drivers.harness import Harness

    base = work / "profile"
    base.mkdir(parents=True)
    fx_path, truth = generate_synthetic_dataset(
        base / "fx", nrows=24, ncols=24, formulas=None,
        present_fraction=0.5, noise_peaks=20, seed=13)
    h = Harness(base, "svc", sm_overrides={
        "backend": "torch_cuda", "device": device,
        # the fused window-moments kernel: the capture must attribute
        # device time to it by class on the card
        "parallel": {"formula_batch": 4, "checkpoint_every": 1,
                     "fused_metrics": "on"},
    })
    on_card = device.startswith("cuda")
    try:
        def submit(i: int) -> str:
            msg = {"ds_id": f"p{i}", "msg_id": f"p{i}",
                   "input_path": str(fx_path),
                   "formulas": truth.formulas[:4],
                   "ds_config": {"isotope_generation": {"adducts": ["+H"]}}}
            status, _hd, body = h.submit(msg)
            if status != 202:
                raise RuntimeError(f"submit {i} returned {status}: {body}")
            return body["msg_id"]

        # warm job: pays the cold set-up (kernel builds on the card) so
        # later captures see scoring
        warm = submit(0)
        h.wait_terminal([warm], timeout_s=300.0)

        capture = None
        for i in range(1, 5):
            mid = submit(i)
            deadline = time.time() + 120.0
            while time.time() < deadline:
                row = h.jobs().get(mid) or {}
                if row.get("state") in ("running", "done", "failed"):
                    break
                time.sleep(0.02)
            while (h.jobs().get(mid) or {}).get("state") == "running":
                code, body = _http_json(h.base, "/debug/profile?seconds=1.0",
                                        timeout=60.0)
                if code != 200:
                    return fail(f"/debug/profile returned {code}: {body}")
                if mid not in body.get("jobs_running", []):
                    continue
                kernels = (body.get("attribution") or {}).get("kernels", [])
                fused = [k for k in kernels if k["class"] == "fused_kernel"]
                if not on_card or (fused and body.get("injected_spans", 0)):
                    capture = (mid, body, fused)
                    break
            if capture:
                break
            h.wait_terminal([mid], timeout_s=300.0)
        if not capture:
            return fail("no profile capture during a running job "
                        + ("attributed the fused kernel " if on_card else "")
                        + "(4 attempts)")
        mid, body, fused = capture
        h.wait_terminal([mid], timeout_s=300.0)
        if "sm_profile_captures_total" not in h.metrics_text():
            return fail("sm_profile_captures_total missing from /metrics")
        if not on_card:
            print(f"fleet_smoke: profile capture OK during {mid} "
                  f"({body['attribution']['n_events']} device events off "
                  "the card; the fused kernel's attribution needs it)")
            return 0
        with urllib.request.urlopen(
                f"{h.base}/jobs/{mid}/trace?raw=1", timeout=30.0) as r:
            records = json.loads(r.read())["records"]
        dev = [rec for rec in records if rec.get("kind") == "span"
               and rec.get("name") == "device_kernel"
               and (rec.get("attrs") or {}).get("kernel_class")
               == "fused_kernel"]
        if not dev:
            return fail(f"job {mid} trace gained no fused device_kernel "
                        "spans")
        if not dev[0].get("replica"):
            return fail("injected device_kernel spans carry no replica "
                        "stamp")
        print(f"fleet_smoke: profile capture OK — {fused[0]['op']} "
              f"({fused[0]['device_s']:.4f}s device), "
              f"{body['injected_spans']} spans injected into {mid}, "
              f"stamped {dev[0]['replica']}")
        return 0
    finally:
        h.shutdown()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--work", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--only", choices=("fleet", "profile"), default=None,
                    help="run a single phase (debugging)")
    add_device_arguments(ap, "phase 1's replica backend",
                         "torch device of phase 2 and of phase 1's "
                         "torch_cuda replicas")
    args = ap.parse_args(argv)
    require_card(ap, args.device)

    import shutil

    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_fleet_smoke_"))
    work.mkdir(parents=True, exist_ok=True)
    try:
        t0 = time.time()
        if args.only in (None, "fleet"):
            rc = phase_fleet(work, args.backend, args.device)
            if rc:
                return rc
        if args.only in (None, "profile"):
            rc = phase_profile(work, args.device)
            if rc:
                return rc
        print(f"fleet_smoke: OK ({time.time() - t0:.1f}s)")
        return 0
    finally:
        if not args.keep and args.work is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
