"""The port's multi-replica scheduler protocol against the JAX package's:
spool shards, rendezvous ownership, fenced lease claims, fence-rejection
races, replica takeover, peer-aware admission and the /peers view.

Each case makes the same calls on both packages with the same inputs and
holds the outcomes equal: shard maps, lease fences and rejections, spool
states, ledger rows, admission decisions and metrics text.
"""

from __future__ import annotations

import os
import threading
import time
from pathlib import Path

import pytest

from sm_distributed_tpu.engine import daemon as jdaemon
from sm_distributed_tpu.engine import storage as jstorage
from sm_distributed_tpu.service import admission as jadm
from sm_distributed_tpu.service import leases as jleases
from sm_distributed_tpu.service import metrics as jmetrics
from sm_distributed_tpu.service import scheduler as jsched
from sm_distributed_tpu.utils import config as jconfig
from sm_distributed_tpu_torch.engine import daemon as tdaemon
from sm_distributed_tpu_torch.engine import storage as tstorage
from sm_distributed_tpu_torch.service import admission as tadm
from sm_distributed_tpu_torch.service import leases as tleases
from sm_distributed_tpu_torch.service import metrics as tmetrics
from sm_distributed_tpu_torch.service import scheduler as tsched
from sm_distributed_tpu_torch.utils import config as tconfig

QUEUE = "sm_annotate"
PACKAGES = {
    "jax": dict(daemon=jdaemon, storage=jstorage, adm=jadm, leases=jleases,
                metrics=jmetrics, sched=jsched, config=jconfig),
    "torch": dict(daemon=tdaemon, storage=tstorage, adm=tadm, leases=tleases,
                  metrics=tmetrics, sched=tsched, config=tconfig),
}


def _both(case, tmp_path: Path | None = None) -> dict:
    """Run ``case(m, dir)`` on each package (its own directory) and hold
    the outcomes equal; returns the port's."""
    out = {}
    for name, m in PACKAGES.items():
        d = None
        if tmp_path is not None:
            d = tmp_path / name
            d.mkdir()
        out[name] = case(m, d) if d is not None else case(m)
    assert out["torch"] == out["jax"], out
    return out["torch"]


def _cfg(m, **kw):
    base = dict(workers=1, poll_interval_s=0.02, job_timeout_s=10.0,
                max_attempts=2, backoff_base_s=0.02, backoff_max_s=0.05,
                backoff_jitter=0.0, heartbeat_interval_s=0.1,
                stale_after_s=0.5, drain_timeout_s=5.0,
                spool_shards=8, replica_heartbeat_interval_s=0.1,
                replica_stale_after_s=0.6, takeover_interval_s=0.1)
    base.update(kw)
    return m["config"].ServiceConfig(**base)


def _census(root: Path) -> dict:
    return {s: sorted(p.stem for p in (root / s).glob("*.json"))
            for s in ("pending", "running", "done", "failed")}


def _publish(m, queue_dir: Path, msg_id: str, **extra) -> None:
    m["daemon"].QueuePublisher(queue_dir).publish(
        {"ds_id": msg_id, "msg_id": msg_id, "input_path": "null://", **extra})


# ------------------------------------------------------------------ shards
@pytest.mark.parametrize("p", [1, 2, 8, 64])
def test_shard_of_stable_and_bounded(p):
    def case(m):
        got = [m["leases"].shard_of(mid, p) for mid in ("a", "m0", "x" * 40)]
        assert all(0 <= s < max(1, p) for s in got)
        return got, m["leases"].shard_of("anything", 1)

    _both(case)


def test_rendezvous_ownership_partitions_and_rebalances():
    def case(m):
        owned_shards = m["leases"].owned_shards
        replicas = {"r0", "r1", "r2"}
        owned = {r: sorted(owned_shards(r, replicas, 16)) for r in replicas}
        after = {r: sorted(owned_shards(r, {"r1", "r2"}, 16))
                 for r in ("r1", "r2")}
        return owned, after, sorted(owned_shards("solo", {"solo"}, 8))

    owned, after, solo = _both(case)
    assert sorted(s for v in owned.values() for s in v) == list(range(16))
    for r in ("r1", "r2"):
        assert set(owned[r]) <= set(after[r])
    assert solo == list(range(8))


# ------------------------------------------------------------------ leases
def _rejected(m, fn) -> bool:
    try:
        fn()
    except m["leases"].FenceRejectedError:
        return True
    return False


def test_lease_claim_renew_check_roundtrip(tmp_path):
    def case(m, d):
        store = m["leases"].LeaseStore(d, "r0", epoch=1)
        lease = store.claim("m1")
        store.check(lease)
        renewed = store.renew(lease)
        store.release(lease)
        lease2 = store.claim("m1")
        return (lease.fence, renewed, lease2.fence,
                _rejected(m, lambda: store.check(lease)))

    assert _both(case, tmp_path) == (1, True, 2, True)


def test_fence_bump_rejects_stale_holder(tmp_path):
    def case(m, d):
        a = m["leases"].LeaseStore(d, "rA", epoch=1)
        b = m["leases"].LeaseStore(d, "rB", epoch=1)
        la = a.claim("m1")
        bumped = b.bump("m1")
        renew = a.renew(la)
        stale = _rejected(m, lambda: a.check(la))
        lb = b.claim("m1")
        b.check(lb)
        b.clear("m1")
        return bumped, renew, stale, lb.fence, _rejected(m, lambda: b.check(lb))

    assert _both(case, tmp_path) == (2, False, True, 3, True)


def test_lease_epoch_distinguishes_restarted_holder(tmp_path):
    def case(m, d):
        old = m["leases"].LeaseStore(d, "r0", epoch=1)
        lease_old = old.claim("m1")
        m["leases"].LeaseStore(d, "r0", epoch=2).claim("m1")
        return _rejected(m, lambda: old.check(lease_old))

    assert _both(case, tmp_path) is True


def test_lease_orphan_sweep(tmp_path):
    def case(m, d):
        root = d / "q"
        (root / "pending").mkdir(parents=True)
        (root / "running").mkdir(parents=True)
        store = m["leases"].LeaseStore(root, "r0")
        store.claim("gone")
        store.claim("kept")
        (root / "pending" / "kept.json").write_text("{}")
        n = store.sweep_orphans(root, max_age_s=0.0)
        return n, sorted(p.name for p in store.dir.glob("*.json"))

    assert _both(case, tmp_path) == (1, ["kept.json"])


# ---------------------------------------------------------------- registry
def test_registry_register_beat_alive_retire(tmp_path):
    def case(m, d):
        reg = m["leases"].ReplicaRegistry
        a = reg(d, "r0", stale_after_s=5.0)
        out = [a.register()]
        b = reg(d, "r1", stale_after_s=5.0)
        b.register()
        out.append(sorted(a.alive()))
        out.append({p["replica_id"]: p["alive"] for p in a.peers()})
        b.retire()
        out.append(sorted(a.alive()))
        out.append(reg(d, "r0").register())
        return out

    assert _both(case, tmp_path) == [1, ["r0", "r1"], {"r0": True, "r1": True},
                                     ["r0"], 2]


def test_registry_staleness(tmp_path):
    def case(m, d):
        reg = m["leases"].ReplicaRegistry
        a = reg(d, "r0", stale_after_s=0.2)
        a.register()
        b = reg(d, "r1", stale_after_s=0.2)
        b.register()
        time.sleep(0.3)
        a.beat()
        return sorted(a.alive())

    assert _both(case, tmp_path) == ["r0"]


# ------------------------------------------------- ledger/daemon satellites
def test_fail_stale_started_scoped_to_ds_ids_and_before(tmp_path):
    def case(m, d):
        ledger = m["storage"].JobLedger(d)
        try:
            for ds in ("a", "b"):
                ledger.upsert_dataset(ds, ds, "x", {})
            ledger.start_job("a")
            cutoff = time.time() + 0.01
            time.sleep(0.02)
            live = ledger.start_job("b")
            out = [ledger.fail_stale_started(ds_ids=["a", "b"], before=cutoff),
                   ledger.job_status(live),
                   ledger.fail_stale_started(ds_ids=[]),
                   ledger.fail_stale_started(ds_ids=["zz"])]
            out.append(list(ledger.jobs().status))
            return out
        finally:
            ledger.close()

    assert _both(case, tmp_path) == [1, "STARTED", 0, 0,
                                     ["FAILED", "STARTED"]]


def test_sweep_orphan_tmp_scoped_to_shards(tmp_path):
    def case(m, d):
        root = d / QUEUE
        (root / "pending").mkdir(parents=True)
        ids = [f"m{i}" for i in range(8)]
        for mid in ids:
            (root / "pending" / f".{mid}.tmp").write_text("x")
        mine = {0, 2}
        swept = m["daemon"].sweep_orphan_tmp(root, max_age_s=0.0, shards=mine,
                                             total_shards=4)
        left = sorted(p.name for p in (root / "pending").glob(".*.tmp"))
        rest = m["daemon"].sweep_orphan_tmp(root, max_age_s=0.0)
        return swept, left, rest

    swept, left, rest = _both(case, tmp_path)
    assert swept + len(left) == 8 and rest == len(left)


# ------------------------------------------------------- scheduler protocol
def test_single_replica_owns_all_shards_and_drains(tmp_path):
    def case(m, d):
        done = []
        sched = m["sched"].JobScheduler(
            d, lambda msg: done.append(msg["msg_id"]), config=_cfg(m))
        owned = sorted(sched._owned)
        for i in range(4):
            _publish(m, d, f"m{i}")
        sched.start()
        assert sched.wait_for_terminal(4, timeout_s=20.0)
        sched.shutdown()
        root = d / QUEUE
        return (owned, sorted(done),
                sorted(p.name for p in (root / "leases").glob("*.json")),
                _census(root))

    owned, done, leases, census = _both(case, tmp_path)
    assert owned == list(range(8)) and done == [f"m{i}" for i in range(4)]
    assert leases == [] and census["done"] == done


def test_two_replicas_partition_claims(tmp_path):
    def case(m, d):
        claimed: dict[str, list[str]] = {"r1": [], "r2": []}

        def make_cb(rid):
            return lambda msg: claimed[rid].append(msg["msg_id"])

        scheds = [m["sched"].JobScheduler(
            d, make_cb(rid), config=_cfg(m, replica_id=rid, replicas=2))
            for rid in ("r1", "r2")]
        ids = [f"m{i}" for i in range(10)]
        for mid in ids:
            _publish(m, d, mid)
        for s in scheds:
            s.start()
        deadline = time.time() + 30.0
        root = d / QUEUE
        while time.time() < deadline and \
                len(list((root / "done").glob("*.json"))) < len(ids):
            time.sleep(0.05)
        for s in scheds:
            s.shutdown()
        assert not set(claimed["r1"]) & set(claimed["r2"])
        owned = {rid: m["leases"].owned_shards(rid, {"r1", "r2"}, 8)
                 for rid in ("r1", "r2")}
        follows = all(m["leases"].shard_of(mid, 8) in owned[rid]
                      for rid in ("r1", "r2") for mid in claimed[rid])
        return sorted(claimed["r1"] + claimed["r2"]), follows, _census(root)

    ids, follows, census = _both(case, tmp_path)
    assert ids == sorted(f"m{i}" for i in range(10)) and follows
    assert census["done"] == ids


def test_takeover_requeues_dead_replica_claims(tmp_path):
    out = {}
    for name, m in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = _takeover_case(m, d)
    requeues = {name: o.pop() for name, o in out.items()}
    assert out["torch"] == out["jax"], out
    done, census, rejected = out["torch"]
    assert done == ["dead1"] and census["done"] == ["dead1"] and rejected
    # the port requeues the dead claim once; the JAX package's survivor
    # can also fence its own fresh claim of the aged message once more
    # (its takeover scan reads the claim's publish mtime; see
    # test_takeover_leaves_a_claim_made_a_moment_ago)
    assert requeues["torch"] == 1 and requeues["jax"] >= 1, requeues


def _takeover_case(m, d) -> list:
    """A dead replica's claim in ``running/`` (aged heartbeat and lease,
    fence 1), and a survivor r1 started over the spool."""
    root = d / QUEUE
    _publish(m, d, "dead1")
    dead_store = m["leases"].LeaseStore(root, "rdead", epoch=1)
    (root / "running").mkdir(parents=True, exist_ok=True)
    (root / "pending" / "dead1.json").rename(root / "running" / "dead1.json")
    dead_lease = dead_store.claim("dead1")
    old = time.time() - 5.0          # the dead holder's last sign of life
    os.utime(root / "running" / "dead1.json", (old, old))
    lease_file = dead_store._path("dead1")
    import json
    rec = json.loads(lease_file.read_text())
    rec["renewed_at"] = old
    lease_file.write_text(json.dumps(rec))
    done = []
    metrics = m["metrics"].MetricsRegistry()
    # horizons of 2 s: a worker starved for longer on a loaded test
    # host would be fenced by a takeover, rightly, and counted
    sched = m["sched"].JobScheduler(
        d, lambda msg: done.append(msg["msg_id"]),
        config=_cfg(m, replica_id="r1", stale_after_s=2.0),
        metrics=metrics)
    sched.start()
    assert sched.wait_for_terminal(1, timeout_s=20.0)
    sched.shutdown()
    requeues = [ln for ln in metrics.expose().splitlines()
                if ln.startswith("sm_replica_takeover_requeues_total{")]
    assert len(requeues) == 1, requeues
    return [sorted(set(done)), _census(root),
            _rejected(m, lambda: dead_store.check(dead_lease)),
            float(requeues[0].split()[-1])]


def test_fence_race_two_replicas_one_completion(tmp_path):
    def case(m, d):
        root = d / QUEUE
        release = threading.Event()
        ran = []

        def slow_cb(msg, ctx):
            ran.append(msg["msg_id"])
            assert release.wait(20.0)
            if ctx.fence is not None:
                ctx.fence()

        a = m["sched"].JobScheduler(d, slow_cb, config=_cfg(
            m, replica_id="rA", heartbeat_interval_s=30.0, stale_after_s=0.3))
        _publish(m, d, "race1")
        a.start()
        deadline = time.time() + 10.0
        while time.time() < deadline and not ran:
            time.sleep(0.02)
        done_b = []
        b = m["sched"].JobScheduler(
            d, lambda msg: done_b.append(msg["msg_id"]),
            config=_cfg(m, replica_id="rB", stale_after_s=0.3))
        time.sleep(0.4)
        b.start()
        assert b.wait_for_terminal(1, timeout_s=20.0)
        release.set()
        deadline = time.time() + 10.0
        while time.time() < deadline and a._fenced_count == 0:
            time.sleep(0.02)
        fenced = a._fenced_count
        a.shutdown()
        b.shutdown()
        # the JAX package's winner may run the job twice under load: its
        # takeover scan can fence its own fresh claim (see
        # test_takeover_leaves_a_claim_made_a_moment_ago); what must hold
        # in both is one completion
        return ran, sorted(set(done_b)), fenced, _census(root)

    ran, done_b, fenced, census = _both(case, tmp_path)
    assert ran == done_b == ["race1"] and fenced == 1
    assert census == {"pending": [], "running": [], "done": ["race1"],
                      "failed": []}


def test_fenced_claim_frees_admission_slot(tmp_path):
    def case(m, d):
        adm = m["adm"].AdmissionController(
            m["config"].AdmissionConfig(max_queue_depth=4))
        accepted = adm.try_admit("t1").accepted
        adm.confirm("mfence", "t1")
        sched = m["sched"].JobScheduler(d, lambda msg: None,
                                        config=_cfg(m), admission=adm)
        rec = sched._record("mfence")
        rec.tenant = "t1"
        lease = sched.leases.claim("mfence")
        with sched._records_lock:
            sched._lease_by_msg["mfence"] = lease
        sched.leases.bump("mfence")
        ok = sched._fence_ok(rec, "complete")
        return accepted, ok, adm.stats()["depth"], sched._fenced_count

    assert _both(case, tmp_path) == (True, False, 0, 1)


# ------------------------------------------------------ peer-aware admission
def test_admission_peer_view_global_quota_and_shed():
    def case(m):
        cfg = m["config"].AdmissionConfig(max_queue_depth=10,
                                          max_tenant_inflight=4,
                                          latency_shed_s=5.0)
        adm = m["adm"].AdmissionController(cfg)
        peers: list = []
        adm.set_peer_view(lambda: peers[-1] if peers else [])
        out = []

        def admit(tenant):
            d = adm.try_admit(tenant)
            out.append((d.accepted, d.reason, d.status))

        admit("t1")
        peers.append([{"depth": 3, "tenants": {"t1": 3},
                       "latency_ewma_s": 0.1, "shedding": False}])
        admit("t1")
        admit("t2")
        peers.append([{"depth": 8, "tenants": {}, "latency_ewma_s": 0.1,
                       "shedding": False}])
        admit("t3")
        peers.append([{"depth": 0, "tenants": {}, "latency_ewma_s": 9.0,
                       "shedding": True}])
        admit("t4")

        def boom():
            raise RuntimeError("registry unreadable")

        adm.set_peer_view(boom)
        admit("t5")
        return out

    out = _both(case)
    assert [o[0] for o in out] == [True, False, True, False, False, True]
    assert [o[1] for o in out][1:5:2] == ["tenant_quota", "queue_full"]


def test_admission_sync_from_spool_scoped(tmp_path):
    def case(m, d):
        for i in range(6):
            _publish(m, d, f"m{i}")
        adm = m["adm"].AdmissionController(m["config"].AdmissionConfig())
        mine = {s for s in range(8) if s % 2}
        n = adm.sync_from_spool(
            d / QUEUE,
            owns_msg=lambda mid: m["leases"].shard_of(mid, 8) in mine)
        return n, adm.stats()["depth"]

    n, depth = _both(case, tmp_path)
    assert n == depth


# --------------------------------------------------------- peers + metrics
def test_peers_view_and_replica_metrics(tmp_path):
    def case(m, d):
        reg = m["metrics"].MetricsRegistry()
        sched = m["sched"].JobScheduler(
            d, lambda msg: None, config=_cfg(m, replica_id="rX", replicas=2),
            metrics=reg)
        other = m["leases"].ReplicaRegistry(d / QUEUE, "rY")
        other.register()
        other.beat(summary={"admission": {"depth": 2, "tenants": {"t": 2},
                                          "latency_ewma_s": 0.5,
                                          "shedding": False}})
        sched._recompute_owned()
        view = sched.peers()
        peer_adm = sched.peer_admission_summaries()
        text = reg.expose()
        lines = sorted(ln for ln in text.splitlines()
                       if ln.startswith(("sm_replica_up", "sm_replica_peers",
                                         "sm_replica_shards_owned")))
        return (view["replica_id"],
                sorted(p["replica_id"] for p in view["replicas"]),
                view["owned"], [(p["replica_id"], p["depth"])
                                for p in peer_adm], lines,
                sorted(sched._owned) == sorted(
                    m["leases"].owned_shards("rX", {"rX", "rY"}, 8)))

    rid, ids, owned, peer_adm, lines, matches = _both(case, tmp_path)
    assert rid == "rX" and ids == ["rX", "rY"] and matches
    assert peer_adm == [("rY", 2)]
    assert 'sm_replica_up{replica="rX"} 1' in lines
    assert "sm_replica_peers_alive 2" in lines


def test_orphan_rescue_claims_unowned_aged_messages(tmp_path):
    def case(m, d):
        done = []
        sched = m["sched"].JobScheduler(
            d, lambda msg: done.append(msg["msg_id"]),
            config=_cfg(m, replica_id="r1", stale_after_s=0.5))
        m["leases"].ReplicaRegistry(d / QUEUE, "rwedged",
                                    stale_after_s=60.0).register()
        ids = [f"m{i}" for i in range(6)]
        for mid in ids:
            _publish(m, d, mid)
        old = time.time() - 10.0
        for p in (d / QUEUE / "pending").glob("*.json"):
            os.utime(p, (old, old))
        sched.start()
        # every message in done/ (in the JAX package, a fresh claim its
        # own takeover scan fences goes back to pending/ and is rescued
        # again)
        deadline = time.time() + 30.0
        while time.time() < deadline and \
                len(list((d / QUEUE / "done").glob("*.json"))) < len(ids):
            time.sleep(0.05)
        sched.shutdown()
        return sorted(set(done)), _census(d / QUEUE)

    done, census = _both(case, tmp_path)
    assert done == [f"m{i}" for i in range(6)] and census["done"] == done


def test_takeover_leaves_a_claim_made_a_moment_ago(tmp_path):
    """The window between a dispatcher's claim rename and its heartbeat
    and lease writes: the message in ``running/`` still carries its old
    publish mtime.  The port's takeover scan reads the rename's ctime and
    leaves the claim; the JAX package's fences and requeues it, which can
    put a second copy of the message back in ``pending/`` under a running
    worker (a double completion under load).  The port departs here."""
    out = {}
    for name, m in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        sched = m["sched"].JobScheduler(d, lambda msg: None,
                                        config=_cfg(m, stale_after_s=0.5))
        _publish(m, d, "fresh1")
        root = d / QUEUE
        pending = root / "pending" / "fresh1.json"
        old = time.time() - 10.0
        os.utime(pending, (old, old))
        claimed = sched._claim(pending)
        out[name] = (sched._requeue_stale_owned(sched.cfg.stale_after_s),
                     _census(root))
    assert out["torch"] == (0, {"pending": [], "running": ["fresh1"],
                                "done": [], "failed": []})
    assert out["jax"][0] == 1 and out["jax"][1]["pending"] == ["fresh1"]


def test_takeover_leaves_a_claim_held_in_flight(tmp_path):
    """The port's dispatcher held between its claim rename and its lease
    claim for longer than ``stale_after_s``, while its own takeover scans
    run every 0.1 s: the claim window keeps every scan off the claim, and
    the message is requeued never and completed once.  (The JAX package
    has no claim window: its scan fences and requeues such a claim, and
    the claim-count write then puts a second copy back in ``running/``.)"""
    m = PACKAGES["torch"]
    done = []
    metrics = m["metrics"].MetricsRegistry()
    sched = m["sched"].JobScheduler(
        tmp_path, lambda msg: done.append(msg["msg_id"]),
        config=_cfg(m, stale_after_s=0.2), metrics=metrics)
    _publish(m, tmp_path, "held1")
    root = tmp_path / QUEUE
    old = time.time() - 10.0
    os.utime(root / "pending" / "held1.json", (old, old))
    in_window, release = threading.Event(), threading.Event()
    claim = sched.leases.claim

    def held_claim(msg_id):
        in_window.set()
        assert release.wait(20.0)
        return claim(msg_id)

    sched.leases.claim = held_claim
    sched.start()
    try:
        assert in_window.wait(10.0)
        time.sleep(0.6)                   # 3 horizons, about 6 scans
        requeued_while_held = sched.requeue_stale()
        census_held = _census(root)
    finally:
        release.set()
    assert sched.wait_for_terminal(1, timeout_s=20.0)
    sched.shutdown()
    requeues = [ln for ln in metrics.expose().splitlines()
                if ln.startswith("sm_replica_takeover_requeues_total{")]
    assert requeued_while_held == 0
    assert census_held["running"] == ["held1"] and not census_held["pending"]
    assert done == ["held1"]
    assert _census(root) == {"pending": [], "running": [], "done": ["held1"],
                             "failed": []}
    assert all(float(ln.split()[-1]) == 0 for ln in requeues), requeues
