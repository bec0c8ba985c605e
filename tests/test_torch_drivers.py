"""The port's service drivers at a small size: ``replica_chaos``'s
``score_crash`` scenario beside the JAX package's on the same fixture,
and ``resource_smoke`` and ``trace_smoke`` run as a user runs them, each
exiting 0, on ``numpy_ref`` and on ``torch_cuda`` on the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import scripts.replica_chaos as jrc
import sm_distributed_tpu.engine.storage as jstorage
import sm_distributed_tpu_torch.drivers.replica_chaos as trc

ROOT = Path(__file__).resolve().parent.parent
DRIVER_TIMEOUT_S = 300


def _registered_first(run_replica):
    """The JAX driver starts the survivors right after the victim; under a
    loaded CPU a survivor can register first and claim the victim's
    shards.  Hold each start until the victim's registry beat exists (the
    port's driver does this itself)."""
    def wrapped(base, sm_conf, rid, spec, wait=False, idle_exit=2.0):
        out = run_replica(base, sm_conf, rid, spec, wait=wait,
                          idle_exit=idle_exit)
        if not wait and rid == jrc.VICTIM:
            beat = base / "queue" / "sm_annotate" / "replicas" / \
                f"{rid}.json"
            deadline = time.time() + 90.0
            while not beat.exists() and out[0].poll() is None and \
                    time.time() < deadline:
                time.sleep(0.05)
        return out
    return wrapped


def _jax_final(base: Path, msgs: list[dict]) -> dict:
    root = base / "queue" / "sm_annotate"
    census = jrc._spool_census(root)
    ledger = jstorage.JobLedger(base / "results")
    try:
        statuses = {m["ds_id"]: list(ledger.jobs(m["ds_id"]).status)
                    for m in msgs}
    finally:
        ledger.close()
    return {"spool": census, "ledger": statuses}


def _summary(final: dict) -> dict:
    """What exactly-once fixes: the spool census, and per dataset no
    STARTED row and one FINISHED row, the newest (how many attempts the
    victim started before it died is timing, not outcome)."""
    return {"spool": final["spool"],
            "ledger": {ds: ("STARTED" not in st, st.count("FINISHED"),
                            st[-1]) for ds, st in final["ledger"].items()}}


# staleness horizons for a loaded test host: with the drivers' 1 s a
# replica whose heartbeat thread is starved looks dead to its peers, and a
# spurious takeover can leave an abandoned attempt's STARTED row behind the
# FINISHED one.  The victim's real death is taken over all the same.
STALE_S = {"stale_after_s": 3.0, "replica_stale_after_s": 3.0}


def test_replica_score_crash_parity(tmp_path, monkeypatch):
    monkeypatch.setattr(jrc, "_run_replica",
                        _registered_first(jrc._run_replica))
    for mod in (jrc, trc):
        monkeypatch.setitem(mod.SM_TEMPLATE, "service",
                            {**mod.SM_TEMPLATE["service"], **STALE_S})
    port = trc.run_sweep(tmp_path / "torch", only=["score_crash"])
    jax_base = tmp_path / "jax"
    ref = jrc.run_sweep(jax_base, only=["score_crash"])
    if not ref[0]["ok"] and "(double completion)" in str(ref[0].get("error")):
        # the JAX scheduler's takeover race (ROADMAP queue 3: its scan can
        # fence and requeue a claim still in flight; the port's claim
        # window closes it) now and then spoils the reference run under
        # load.  Such a run is no reference: it is made once more.  The
        # port's run is held as it came.
        jax_base = tmp_path / "jax-again"
        ref = jrc.run_sweep(jax_base, only=["score_crash"])
    assert port[0]["ok"], port[0].get("error")
    assert ref[0]["ok"], ref[0].get("error")
    assert port[0]["invariant_errors"] == []
    assert port[0]["rc_r0"] == ref[0]["rc_r0"] == trc.CRASH_RC
    msgs = trc.messages(Path("x"), [])
    want = _summary(_jax_final(jax_base / "score_crash", msgs))
    assert _summary(port[0]["final"]) == want
    assert want["spool"]["done"] == sorted(m["msg_id"] for m in msgs)


@pytest.mark.parametrize("driver", ["resource_smoke", "trace_smoke"])
@pytest.mark.parametrize("backend", ["numpy_ref", "torch_cuda"])
def test_smoke_driver_exits_zero(driver, backend):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SM_FAILPOINTS", None)
    proc = subprocess.run(
        [sys.executable, "-m", f"sm_distributed_tpu_torch.drivers.{driver}",
         "--backend", backend, "--device", "cpu"],
        env=env, cwd=str(ROOT), capture_output=True, text=True,
        timeout=DRIVER_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"{driver}: OK" in proc.stdout
    # the per-call preflight cost is printed, never asserted here
