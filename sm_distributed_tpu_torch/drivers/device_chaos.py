"""Device-fault survival gate of the port (a copy of the JAX package's
``scripts/device_chaos.py`` that drives ``sm_distributed_tpu_torch``).

Proves the chip-level fault-survival layer end to end through the REAL
in-process service stack (spool, scheduler, device pool + health tracker,
SearchJob, tracing) with a 4-chip pool (``service.device_pool_size`` 4):

1. **golden**: a ``devices: 4`` submit scores on the 4-chip lease
   fault-free — its stored annotations are the golden report;
2. **sticky chip death mid-job**: chip 3 is marked bad through the
   probe's chaos seam (``HealthTracker.simulate_bad``) and a sticky fault
   is injected at the second scoring group (``backend.chip_fault``
   failpoint).  The health tracker probe-attributes the fault,
   quarantines chip 3, and the scheduler's retry re-leases the three
   survivors: the job resumes from its group-0 checkpoint and its stored
   annotations are **bit-identical** to the golden ones.  The quarantine
   is visible on ``/debug/devices``, ``sm_device_quarantines_total`` and
   ``sm_device_health{device="3"}`` on ``/metrics``, and no lease after
   the quarantine includes chip 3;
3. **half-open readmission**: the simulated fault is lifted; after the
   re-probe cooldown the chip is readmitted and the next 4-chip submit
   holds all four chips again.

Without ``--smoke``, two more stages run: a **transient** fault
(ConnectionError class) that retries on the same chips with NO
quarantine, and a **host eviction** where quarantining enough of one host
domain's chips fences the whole domain.

Where the chips are: off the card (``--device cpu``) every chip of the
pool is simulated on the CPU (``models/msm_basic.lease_device``), and a
lease of N chips meshes over the CPU N times.  On the card the pool's
chips map to the visible cards (``parallel/mesh.lease_devices``): with
four or more cards the mesh really shrinks from four cards to three; with
one card the lease keeps only ``cuda:0`` (the other chips are dropped with
a warning), so the scores stay on ``cuda:0`` while the leases, the
quarantine and the readmission run as written.  The probe passes a chip
that is not visible (``service/health._device_probe``), so only the
simulated fault marks chip 3 bad.

Usage::

    python -m sm_distributed_tpu_torch.drivers.device_chaos [--smoke]
    ... --device cpu                  # off the card

Exit 0 = gate passes.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

from sm_distributed_tpu_torch.drivers import (
    add_device_arguments,
    require_card,
)
from sm_distributed_tpu_torch.drivers.harness import (
    Harness,
    build_fixtures,
    msg,
)
from sm_distributed_tpu_torch.models import faults
from sm_distributed_tpu_torch.utils import failpoints

POOL = 4
ALL_CHIPS = list(range(POOL))
SURVIVORS = [0, 1, 2]
GROUP_SLEEP = "device.score_batch=sleep:0.4"


def fail(text: str) -> int:
    print(f"device_chaos: FAIL — {text}", file=sys.stderr)
    return 1


def _get(h: Harness, path: str):
    with urllib.request.urlopen(h.base + path, timeout=30.0) as r:
        return json.loads(r.read())


def _trace_records(h: Harness, msg_id: str) -> list[dict]:
    return _get(h, f"/jobs/{msg_id}/trace?raw=1")["records"]


def stored(h: Harness, ds_id: str):
    import pandas as pd

    p = Path(h.sm_config.storage.results_dir) / ds_id / "annotations.parquet"
    return pd.read_parquet(p).sort_values(
        ["sf", "adduct"]).reset_index(drop=True)


def leases(records: list[dict]) -> list[tuple[float, list[int]]]:
    """(ts, chip list) of every device_token_acquired event, in order."""
    return [(float(r["ts"]), list((r.get("attrs") or {}).get("devices", [])))
            for r in records
            if r["kind"] == "event"
            and r["name"] == "device_token_acquired"]


def run(work: Path, smoke: bool, backend: str = "torch_cuda",
        device: str = "cpu") -> int:
    from sm_distributed_tpu_torch.analysis import lockorder

    lockorder.enable()
    fx = build_fixtures(work)
    h = Harness(work, "device_chaos", sm_overrides={
        "backend": backend, "device": device,
        "parallel": {"formula_batch": 2, "checkpoint_every": 1},
        "service": {"workers": 1, "max_attempts": 3,
                    "device_pool_size": POOL, "devices_per_job": POOL,
                    "health_reprobe_after_s": 0.5,
                    "backoff_base_s": 0.05, "backoff_max_s": 0.2},
    })
    health = h.service.device_pool.health
    try:
        # ---- 1. fault-free 4-chip golden --------------------------------
        status, _hd, _b = h.submit(msg(fx, "fast", "golden4", devices=POOL))
        if status != 202:
            return fail(f"golden submit returned {status}")
        rows = h.wait_terminal(["golden4"])
        if rows["golden4"]["state"] != "done":
            return fail(f"golden job {rows['golden4']['state']}: "
                        f"{rows['golden4']['error']!r}")
        golden = stored(h, "golden4")
        g_leases = leases(_trace_records(h, "golden4"))
        if not g_leases or g_leases[-1][1] != ALL_CHIPS:
            return fail(f"golden lease {g_leases}, wanted all {POOL} chips")
        print(f"device_chaos: golden 4-chip job OK "
              f"({len(golden)} annotations)")

        # ---- 2. sticky chip death mid-job -------------------------------
        # the job is granted all 4 chips first (lease-time probes pass),
        # THEN chip 3 dies mid-run: each group's scoring sleeps, the probe
        # seam reports chip 3 bad once the job is seen holding its 4-chip
        # lease, and only then is the sticky fault armed, for the next
        # group.  The order is decided by states (the lease on the trace,
        # chip 3 bad), never by when the poll runs: a late poll only
        # moves the fault to a later group.  The fault is
        # probe-attributed to chip 3, which is quarantined; the retry
        # re-leases the 3 survivors and resumes from the last checkpoint.
        failpoints.configure(GROUP_SLEEP)
        try:
            status, _hd, _b = h.submit(
                msg(fx, "fast", "fault4", devices=POOL))
            if status != 202:
                return fail(f"fault submit returned {status}")
            deadline = time.time() + 60.0
            granted = False
            while time.time() < deadline and not granted:
                try:
                    granted = any(devs == ALL_CHIPS for _ts, devs
                                  in leases(_trace_records(h, "fault4")))
                except (OSError, ValueError, KeyError):
                    granted = False   # trace not started yet (404/empty)
                if not granted:
                    time.sleep(0.05)
            if not granted:
                return fail("fault job never acquired the 4-chip lease")
            health.simulate_bad({3})   # the chip dies mid-job
            failpoints.configure(
                f"{GROUP_SLEEP};backend.chip_fault=raise:RuntimeError@1")
            rows = h.wait_terminal(["fault4"])
        finally:
            failpoints.configure(None)
        if rows["fault4"]["state"] != "done":
            return fail(f"fault job {rows['fault4']['state']}: "
                        f"{rows['fault4']['error']!r}")
        if rows["fault4"]["attempts"] < 2:
            return fail("fault job finished in one attempt — the sticky "
                        "fault never fired")
        # exactly-once completion: one done/ copy, no other spool state
        spool = {s: sorted(p.name for p in (h.root / s).glob("fault4.json"))
                 for s in ("pending", "running", "done", "failed",
                           "quarantine")}
        if spool["done"] != ["fault4.json"] or any(
                v for k, v in spool.items() if k != "done"):
            return fail(f"fault4 spool message lost/duplicated: {spool}")

        # bit-identical convergence after the quarantine
        import pandas as pd

        got = stored(h, "fault4")
        try:
            pd.testing.assert_frame_equal(got, golden, check_exact=True)
        except AssertionError as exc:
            return fail("3-chip rescore diverged from the 4-chip golden: "
                        + str(exc).splitlines()[-1])

        # quarantine visible + honored by every later lease
        records = _trace_records(h, "fault4")
        quarantines = [r for r in records if r["kind"] == "event"
                       and r["name"] == "device_quarantine"]
        if not quarantines or quarantines[0]["attrs"]["device"] != 3:
            return fail(f"no device_quarantine event for chip 3: "
                        f"{[q.get('attrs') for q in quarantines]}")
        q_ts = float(quarantines[0]["ts"])
        after = [devs for ts, devs in leases(records) if ts > q_ts]
        if not after or after[-1] != SURVIVORS:
            return fail(f"retry lease after quarantine was {after}, wanted "
                        f"the 3 survivors {SURVIVORS}")
        if any(3 in devs for devs in after):
            return fail(f"a lease after the quarantine included chip 3: "
                        f"{after}")
        dev = _get(h, "/debug/devices")
        chip3 = next(c for c in dev["health"]["chips"] if c["device"] == 3)
        if chip3["state"] != "quarantined":
            return fail(f"/debug/devices chip 3 state {chip3['state']}")
        text = h.metrics_text()
        if "sm_device_quarantines_total 1" not in text.replace(".0", ""):
            if "sm_device_quarantines_total" not in text:
                return fail("/metrics lacks sm_device_quarantines_total")
        if 'sm_device_health{device="3"} 2' not in text:
            return fail('/metrics lacks sm_device_health{device="3"} == 2')
        resumed = [r for r in records if r["kind"] == "event"
                   and r["name"] == "device_fault"]
        if not resumed or resumed[0]["attrs"]["kind"] != "sticky":
            return fail(f"no sticky device_fault event: {resumed}")
        print("device_chaos: sticky chip 3 quarantined mid-job; job "
              f"resumed from checkpoint on chips {SURVIVORS} — stored "
              "annotations BIT-IDENTICAL to the 4-chip golden")

        # ---- 3. half-open readmission -----------------------------------
        # the pool's grants and the telemetry sampler re-probe too, so any
        # of them may readmit the chip first: decided by its state
        health.simulate_bad(())
        deadline = time.time() + 10.0
        while time.time() < deadline and health.state_of(3) != "ok":
            time.sleep(0.2)
            health.reprobe_due()
        if health.state_of(3) != "ok":
            return fail(f"chip 3 never readmitted (state "
                        f"{health.state_of(3)})")
        if health.snapshot()["readmits_total"] < 1:
            return fail("chip 3 back in service without a readmission")
        status, _hd, _b = h.submit(msg(fx, "fast", "after4", devices=POOL))
        if status != 202:
            return fail(f"post-readmit submit returned {status}")
        rows = h.wait_terminal(["after4"])
        if rows["after4"]["state"] != "done":
            return fail(f"post-readmit job {rows['after4']['state']}")
        a_leases = leases(_trace_records(h, "after4"))
        if not a_leases or a_leases[-1][1] != ALL_CHIPS:
            return fail(f"post-readmit lease {a_leases}, wanted all 4 chips")
        if "sm_device_readmits_total" not in h.metrics_text():
            return fail("/metrics lacks sm_device_readmits_total")
        print("device_chaos: chip 3 READMITTED after a passing re-probe; "
              "next job holds all 4 chips again")

        if not smoke:
            rc = _extra_stages(h, fx, health)
            if rc:
                return rc

        rep = lockorder.assert_no_cycles("device_chaos")
        print(f"device_chaos: lock-order clean "
              f"({rep['locks_instrumented']} locks, {rep['edges']} edges)")
        return 0
    finally:
        h.shutdown()
        lockorder.disable()


def _extra_stages(h: Harness, fx: dict, health) -> int:
    # ---- transient fault: same chips retried, nothing quarantined -------
    before = health.snapshot()["quarantines_total"]
    failpoints.configure("backend.chip_fault=raise:ConnectionError@1")
    try:
        status, _hd, _b = h.submit(msg(fx, "fast", "transient4",
                                       devices=POOL))
        if status != 202:
            return fail(f"transient submit returned {status}")
        rows = h.wait_terminal(["transient4"])
    finally:
        failpoints.configure(None)
    if rows["transient4"]["state"] != "done":
        return fail(f"transient job {rows['transient4']['state']}")
    snap = health.snapshot()
    if snap["quarantines_total"] != before:
        return fail("a transient fault caused a quarantine")
    t_records = _trace_records(h, "transient4")
    t_faults = [r for r in t_records if r["kind"] == "event"
                and r["name"] == "device_fault"]
    if not t_faults or t_faults[0]["attrs"]["kind"] != "transient":
        return fail(f"no transient device_fault event: {t_faults}")
    print("device_chaos: transient fault retried in place — zero "
          "quarantines, job done")

    # ---- host eviction: the tracker fences a failing domain -------------
    from sm_distributed_tpu_torch.service.health import HealthTracker

    ht = HealthTracker(8, hosts=2, host_evict_fraction=0.75,
                       probe_on_lease=False, reprobe_after_s=0.0)
    for chip in (0, 1, 2):
        ht.report_fault((chip,), faults.FAULT_STICKY, "probe says dead")
    snap = ht.snapshot()
    states = [c["state"] for c in snap["chips"]]
    if states[:4] != ["quarantined"] * 4:
        return fail(f"host 0 not fully evicted at 3/4 chips out: {states}")
    if states[4:] != ["ok"] * 4 or snap["host_evictions_total"] != 1:
        return fail(f"host eviction spilled past the domain: {snap}")
    print("device_chaos: host 0 evicted at 3/4 chips quarantined; "
          "host 1 untouched")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI subset: golden + sticky-quarantine + readmit")
    ap.add_argument("--work", default=None)
    ap.add_argument("--keep", action="store_true")
    add_device_arguments(ap)
    args = ap.parse_args(argv)
    require_card(ap, args.device)
    import shutil

    work = Path(args.work) if args.work else Path(
        tempfile.mkdtemp(prefix="sm_device_chaos_"))
    work.mkdir(parents=True, exist_ok=True)
    try:
        rc = run(work, args.smoke, args.backend, args.device)
    finally:
        if args.keep:
            print(f"device_chaos: work dir kept at {work}", file=sys.stderr)
        elif args.work is None:
            shutil.rmtree(work, ignore_errors=True)
    if rc == 0:
        print("device_chaos: OK")
    return rc


if __name__ == "__main__":
    sys.exit(main())
