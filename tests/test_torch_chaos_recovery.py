"""The port's crash recovery against the JAX package's: its chaos sweep
(``sm_distributed_tpu_torch.drivers.chaos_sweep``) beside
``scripts/chaos_sweep.py`` on the same scenarios, the orphaned-tmp
startup sweep, concurrent sqlite ledger writers and the ledger's
crash reconciliation.  The checkpoint-corruption cases of the JAX file
are in ``tests/test_torch_resilience.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

import pytest

import scripts.chaos_sweep as jchaos
import sm_distributed_tpu.engine.daemon as jdaemon
import sm_distributed_tpu.engine.storage as jstorage
import sm_distributed_tpu.service as jsvc
import sm_distributed_tpu.utils.config as jconfig
import sm_distributed_tpu.utils.failpoints as jfp
import sm_distributed_tpu_torch.drivers.chaos_sweep as tchaos
import sm_distributed_tpu_torch.engine.daemon as tdaemon
import sm_distributed_tpu_torch.engine.storage as tstorage
import sm_distributed_tpu_torch.service as tsvc
import sm_distributed_tpu_torch.utils.config as tconfig
import sm_distributed_tpu_torch.utils.failpoints as tfp

PACKAGES = {
    "jax": dict(daemon=jdaemon, storage=jstorage, svc=jsvc, config=jconfig,
                fp=jfp),
    "torch": dict(daemon=tdaemon, storage=tstorage, svc=tsvc,
                  config=tconfig, fp=tfp),
}
# the JAX sweep's CI subset and the reader's two seams
PARITY = list(jchaos.SMOKE) + ["io.imzml_parse", "io.ibd_read"]


@pytest.fixture(autouse=True)
def _clean_failpoints():
    jfp.reset()
    tfp.reset()
    yield
    jfp.reset()
    tfp.reset()


def _both(case, tmp_path):
    out = {}
    for name, m in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = case(m, d)
    assert out["torch"] == out["jax"], out
    return out["torch"]


# ----------------------------------------------------------- chaos sweep
def _final_states(base: Path, key: str, storage) -> dict:
    root = base / key.replace(".", "_").replace("+", "_") / "queue" / \
        "sm_annotate"
    census = {s: sorted(p.name for p in (root / s).glob("*.json"))
              for s in ("pending", "running", "done", "failed",
                        "quarantine")}
    ledger = storage.JobLedger(root.parent.parent / "results")
    try:
        statuses = list(ledger.jobs(jchaos.DS_ID).status)
    finally:
        ledger.close()
    return {"spool": census, "ledger": statuses}


def test_chaos_sweep_parity_with_the_jax_sweep(tmp_path):
    """The port's sweep and the JAX sweep on the same scenarios: every
    scenario converges in both (no invariant broken, no lock-order cycle
    in the children, which run with ``SM_LOCK_ORDER=raise``) to the same
    spool and ledger states.  How many restarts a scenario took is not
    compared: a loaded host can stretch a child past its wait."""
    port = tchaos.run_sweep(tmp_path / "torch", only=PARITY)
    ref = jchaos.run_sweep(tmp_path / "jax", only=PARITY)
    bad = [r for r in port + ref if not r["ok"]]
    assert not bad, "\n".join(f"{r['scenario']}: {r.get('error')}\n"
                              f"{r.get('output_tail', '')}" for r in bad)
    assert [r["invariant_errors"] for r in port] == [[]] * len(PARITY)
    for p, j in zip(port, ref):
        assert p["scenario"] == j["scenario"]
        want = _settled(_final_states(tmp_path / "jax", j["scenario"],
                                      jstorage))
        assert _settled(p["final"]) == want, p["scenario"]
        assert want == {"spool": {"pending": [], "running": [],
                                  "done": [f"{jchaos.MSG_ID}.json"],
                                  "failed": [], "quarantine": []},
                        "no_started": True, "newest": "FINISHED"}


def _settled(final: dict) -> dict:
    """The converged state: the spool census, no STARTED row, the newest
    job FINISHED.  How many attempts a run started (the ledger's history)
    depends on the host's load, not on the recovery."""
    return {"spool": final["spool"],
            "no_started": "STARTED" not in final["ledger"],
            "newest": final["ledger"][-1]}


@pytest.mark.slow
def test_chaos_full_sweep(tmp_path):
    """Every scenario of the port's sweep, crashed and recovered in turn."""
    results = tchaos.run_sweep(tmp_path)
    bad = [r for r in results if not r["ok"]]
    assert not bad, "\n".join(f"{r['scenario']}: {r.get('error')}"
                              for r in bad)


def test_every_failpoint_has_a_scenario():
    registered = set(tfp.registered_failpoints())
    primaries = {sc.primary for sc in tchaos.SCENARIOS}
    assert registered == primaries, (
        f"uncovered: {sorted(registered - primaries)}, "
        f"phantom: {sorted(primaries - registered)}")
    # the JAX sweep's table, every scenario (the fleet's spawn seam
    # included: 41)
    assert [sc.key for sc in tchaos.SCENARIOS] == [
        sc.key for sc in jchaos.SCENARIOS]
    assert {sc.spec for sc in tchaos.SCENARIOS} == {
        sc.spec for sc in jchaos.SCENARIOS}
    assert len(tchaos.SCENARIOS) == 41


# ------------------------------------------------------ orphan tmp sweep
def test_orphan_tmp_sweep_age_gated(tmp_path):
    def case(m, d):
        consumer = m["daemon"].QueueConsumer(d / "q", callback=None)
        pending = consumer.root / "pending"
        old_pub = pending / ".deadbeef.tmp"
        old_retry = pending / ".m01.json.tmp"
        fresh = pending / ".inflight.tmp"
        real = pending / "m02.json"
        for p in (old_pub, old_retry, fresh):
            p.write_text("{}")
        real.write_text(json.dumps({"ds_id": "d", "input_path": "/in"}))
        old = time.time() - 600
        os.utime(old_pub, (old, old))
        os.utime(old_retry, (old, old))
        out = [consumer.sweep_orphans(max_age_s=30.0),
               sorted(p.name for p in pending.iterdir()),
               m["fp"].recovery_counts().get("spool.orphan_tmp"),
               m["daemon"].sweep_orphan_tmp(consumer.root, max_age_s=0.0),
               sorted(p.name for p in pending.iterdir())]
        return out

    assert _both(case, tmp_path) == [2, [".inflight.tmp", "m02.json"], 2, 1,
                                     ["m02.json"]]


def test_scheduler_start_sweeps_orphans(tmp_path):
    def case(m, d):
        sched = m["svc"].JobScheduler(
            d / "q", lambda msg: None,
            config=m["config"].ServiceConfig(workers=1, poll_interval_s=0.05,
                                             stale_after_s=30.0,
                                             http_port=0))
        orphan = sched.root / "pending" / ".crashed.tmp"
        orphan.write_text("{}")
        old = time.time() - 600
        os.utime(orphan, (old, old))
        sched.start()
        try:
            return orphan.exists()
        finally:
            sched.shutdown()

    assert _both(case, tmp_path) is False


# ------------------------------------------------------ sqlite robustness
def test_ledger_concurrent_writers_no_database_locked(tmp_path):
    def case(m, d):
        errors: list[str] = []

        def worker(k: int):
            try:
                ledger = m["storage"].JobLedger(d)
                for i in range(8):
                    ledger.upsert_dataset(f"ds{k}", f"ds{k}", "/in", {})
                    job_id = ledger.start_job(f"ds{k}")
                    if i % 2:
                        ledger.finish_job(job_id)
                    else:
                        ledger.fail_job(job_id, "boom")
                ledger.close()
            except Exception as exc:  # noqa: BLE001 — collected, asserted
                errors.append(repr(exc))

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        ledger = m["storage"].JobLedger(d)
        try:
            jobs = ledger.jobs()
            mode = ledger._conn.execute("PRAGMA journal_mode").fetchone()[0]
            return (errors, len(jobs), sorted(jobs.status.value_counts()
                                              .items()), str(mode).lower())
        finally:
            ledger.close()

    out = {}
    for name, m in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = case(m, d)
    want = ([], 48, [("FAILED", 24), ("FINISHED", 24)], "wal")
    assert out["torch"] == want
    # the JAX package's ledger keeps a race at open (its WAL switch answers
    # "database is locked" to a concurrent opener; the port retries it):
    # its rows are compared when none of its writers met it
    if not out["jax"][0]:
        assert out["jax"] == want


def test_ledger_fail_stale_started_scoped(tmp_path):
    def case(m, d):
        ledger = m["storage"].JobLedger(d)
        try:
            ledger.upsert_dataset("a", "a", "/in", {})
            ledger.upsert_dataset("b", "b", "/in", {})
            ja = ledger.start_job("a")
            jb = ledger.start_job("b")
            return [ledger.fail_stale_started("a"), ledger.job_status(ja),
                    ledger.job_status(jb), ledger.fail_stale_started(),
                    ledger.fail_stale_started(),
                    m["fp"].recovery_counts().get("ledger.stale_started")]
        finally:
            ledger.close()

    assert _both(case, tmp_path) == [1, "FAILED", "STARTED", 1, 0, 2]
