"""The port's ``drivers/device_chaos.py --smoke`` under the two interleavings
a loaded host gives it, each forced here: the driver decides its stages by
states, so both runs pass with the outcomes of an unloaded run.

- the lease poll runs late, past the fault job's second scoring group: the
  sticky fault is armed only once chip 3 is marked bad, so it still lands
  on a group that the probe attributes to chip 3;
- another caller (the pool's grant, the telemetry sampler) readmits chip 3
  before the driver's own re-probe: the readmission is read from the
  chip's state, not from the driver's call.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

LATE_LEASE_POLL = """
import time
from sm_distributed_tpu_torch.drivers import device_chaos as d
from sm_distributed_tpu_torch.utils import failpoints

real = d._trace_records
late = []

def polled_late(h, msg_id):
    recs = real(h, msg_id)
    if msg_id == "fault4" and not late and any(
            devs == d.ALL_CHIPS for _ts, devs in d.leases(recs)):
        late.append(msg_id)
        # the poll comes back only once the job's second scoring group
        # has slept through and the third has begun
        deadline = time.time() + 60.0
        while time.time() < deadline and failpoints.injected_counts().get(
                "device.score_batch", 0) < 3:
            time.sleep(0.01)
    return recs

d._trace_records = polled_late
"""

READMITTED_ELSEWHERE = """
import time
from sm_distributed_tpu_torch.service.health import HealthTracker

real = HealthTracker.simulate_bad

def lifted_then_readmitted(self, chips):
    real(self, chips)
    if not list(chips):
        # the pool or the sampler re-probes first, past the cooldown
        self.reprobe_due(now=time.time() + 3600.0)

HealthTracker.simulate_bad = lifted_then_readmitted
"""


def _run_driver(tmp_path: Path, patch: str) -> tuple[int, str]:
    code = textwrap.dedent(patch) + textwrap.dedent(f"""
        import sys
        from sm_distributed_tpu_torch.drivers import device_chaos
        sys.exit(device_chaos.main(["--smoke", "--device", "cpu",
                                    "--work", {str(tmp_path / 'w')!r}]))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SM_FAILPOINTS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)
    return proc.returncode, proc.stdout + proc.stderr


def _fault_job_events(work: Path) -> dict:
    import json

    out = {"leases": [], "quarantined": [], "faults": []}
    for f in sorted((work / "device_chaos" / "work" / "traces")
                    .glob("*.jsonl")):
        recs = [json.loads(ln) for ln in f.read_text().splitlines() if ln]
        for r in sorted(recs, key=lambda r: r["ts"]):
            if r.get("job_id") != "fault4" or r.get("kind") != "event":
                continue
            attrs = r.get("attrs") or {}
            if r["name"] == "device_token_acquired":
                out["leases"].append(list(attrs.get("devices", [])))
            elif r["name"] == "device_quarantine":
                out["quarantined"].append(attrs["device"])
            elif r["name"] == "device_fault":
                out["faults"].append(attrs["kind"])
    return out


def test_lease_poll_past_the_second_group(tmp_path):
    rc, log = _run_driver(tmp_path, LATE_LEASE_POLL)
    assert rc == 0, log[-3000:]
    assert "device_chaos: OK" in log
    ev = _fault_job_events(tmp_path / "w")
    assert ev["quarantined"] == [3], ev
    assert ev["faults"][0] == "sticky", ev
    assert ev["leases"][0] == [0, 1, 2, 3] and \
        ev["leases"][-1] == [0, 1, 2], ev


def test_chip_readmitted_by_another_caller_first(tmp_path):
    rc, log = _run_driver(tmp_path, READMITTED_ELSEWHERE)
    assert rc == 0, log[-3000:]
    assert "chip 3 READMITTED" in log
    assert "device_chaos: OK" in log
