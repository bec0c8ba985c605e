"""The port's ``drivers/host_chaos.py --smoke`` beside the JAX package's
``scripts/host_chaos.py --smoke``, each run as a user runs it (the port's
with ``--device cpu``) as a subprocess, their outcomes read from their work
directories the same way and held equal: the leases before and after the
host eviction and after the host's return, the ``host_evicted``
cancellation, the exactly-once spool and the stored FDR ranks.  Also the
``--bare`` replica of ``drivers/replica_chaos.py``: it drains a spool of
null jobs with no kernel launch and no ``torch.cuda`` call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pandas as pd

ROOT = Path(__file__).resolve().parent.parent
DRIVER_TIMEOUT_S = 600


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SM_FAILPOINTS", None)
    return env


def _run(argv: list[str], log: Path) -> int:
    with open(log, "w") as fh:
        return subprocess.run([sys.executable, *argv], env=_env(),
                              cwd=str(ROOT), stdout=fh,
                              stderr=subprocess.STDOUT,
                              timeout=DRIVER_TIMEOUT_S).returncode


def _outcome(work: Path) -> dict:
    """Per job (by ds id) the leases, the cancel kinds and the fault
    kinds on its trace; the spool census; the stored FDR ranks."""
    base = work / "host_chaos"
    jobs: dict[str, dict] = {}
    for f in sorted((base / "work" / "traces").glob("*.jsonl")):
        recs = [json.loads(ln) for ln in f.read_text().splitlines() if ln]
        for r in sorted(recs, key=lambda r: r["ts"]):
            if r.get("kind") != "event":
                continue
            j = jobs.setdefault(r.get("job_id", ""), {
                "leases": [], "cancels": []})
            attrs = r.get("attrs") or {}
            if r["name"] == "device_token_acquired":
                j["leases"].append(list(attrs.get("devices", [])))
            elif r["name"] == "cancel":
                j["cancels"].append(attrs.get("kind"))
    root = base / "queue" / "sm_annotate"
    spool = {s: sorted(p.stem for p in (root / s).glob("*.json"))
             for s in ("pending", "running", "done", "failed", "quarantine")}
    fdr = {}
    for ds in spool["done"]:
        ann = pd.read_parquet(base / "results" / ds / "annotations.parquet")
        fdr[ds] = sorted(zip(ann["sf"], ann["adduct"], ann["fdr"]))
    return {"jobs": jobs, "spool": spool, "fdr": fdr}


def test_host_chaos_smoke_matches_the_jax_script(tmp_path):
    rc = {
        "port": _run(["-m", "sm_distributed_tpu_torch.drivers.host_chaos",
                      "--smoke", "--device", "cpu", "--work",
                      str(tmp_path / "port")], tmp_path / "port.log"),
        "jax": _run([str(ROOT / "scripts" / "host_chaos.py"), "--smoke",
                     "--work", str(tmp_path / "jax")], tmp_path / "jax.log"),
    }
    for side, code in rc.items():
        assert code == 0, (side, (tmp_path / f"{side}.log").read_text()
                           [-3000:])
    log = (tmp_path / "port.log").read_text()
    assert "host_chaos: OK" in log
    launches = json.loads(log.strip().splitlines()[-1])["host_chaos"]
    assert launches["pool"] == 4
    got, want = (_outcome(tmp_path / s) for s in ("port", "jax"))
    assert got == want
    jobs = got["jobs"]
    golden = next(k for k in jobs if k.startswith("golden"))
    assert jobs[golden]["leases"] == [[0, 1, 2, 3]]
    fault = next(k for k in jobs if k.startswith("fault"))
    assert jobs[fault]["cancels"] == ["host_evicted"]
    assert jobs[fault]["leases"][0] == [0, 1, 2, 3]
    assert jobs[fault]["leases"][-1] == [0, 1]
    after = next(k for k in jobs if k.startswith("after"))
    assert jobs[after]["leases"][-1] == [0, 1, 2, 3]
    assert not any(v for k, v in got["spool"].items() if k != "done")
    assert len(got["spool"]["done"]) == 3


BARE_RUN = """
import json, sys
import torch

calls = []

def refuse(name):
    def call(*a, **k):
        calls.append(name)
        raise RuntimeError(f"torch.cuda.{name} called by a bare replica")
    return call

for name in ("is_available", "device_count", "init", "_lazy_init",
             "synchronize", "set_device", "current_device",
             "get_device_name", "mem_get_info", "max_memory_allocated"):
    setattr(torch.cuda, name, refuse(name))

from sm_distributed_tpu_torch.drivers import replica_chaos
from sm_distributed_tpu_torch.service.server import kernel_launches

rc = replica_chaos.main(sys.argv[1:])
print(json.dumps({"rc": rc, "cuda_calls": calls,
                  "launches": kernel_launches()}))
"""


def test_bare_replica_drains_with_no_kernel_and_no_cuda_call(tmp_path):
    from sm_distributed_tpu_torch.engine.daemon import QueuePublisher

    queue = tmp_path / "queue"
    sm = {"backend": "torch_cuda", "device": "cuda",
          "work_dir": str(tmp_path / "work"),
          "storage": {"results_dir": str(tmp_path / "results")},
          "service": {"workers": 4, "poll_interval_s": 0.02,
                      "http_port": 0, "device_pool_size": 4,
                      "device_pool_hosts": 2, "replicas": 1,
                      "spool_shards": 4}}
    (tmp_path / "sm.json").write_text(json.dumps(sm))
    pub = QueuePublisher(queue)
    ids = [f"b{i:03d}" for i in range(40)]
    for i, m in enumerate(ids):
        pub.publish({"ds_id": m, "msg_id": m, "input_path": "null://",
                     "tenant": f"t{i % 5}"})
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(BARE_RUN), "--replica-serve",
         str(queue), str(tmp_path / "sm.json"), "--replica-id", "r0",
         "--bare", "--null-sleep", "0.005", "--idle-exit", "1.0",
         "--metrics-dump", str(tmp_path / "r0.prom")],
        env=_env(), cwd=str(ROOT), capture_output=True, text=True,
        timeout=DRIVER_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "cuda_calls": [],
                   "launches": dict.fromkeys(out["launches"], 0)}
    root = queue / "sm_annotate"
    assert sorted(p.stem for p in (root / "done").glob("*.json")) == ids
    for state in ("pending", "running", "failed", "quarantine"):
        assert not list((root / state).glob("*.json")), state
    text = (tmp_path / "r0.prom").read_text()
    assert 'sm_jobs_total{state="done"} 40' in text
    assert "sm_kernel_launches_total" not in text
