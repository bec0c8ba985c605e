"""The port's device pool against the JAX package's: the allocator's
invariants (no double grant, contiguity, FIFO-ish fairness, release on
cancel and crash), quarantine fragmentation, its metrics, and the
scheduler's leases.  Each case makes the same calls on both packages and
holds the outcomes equal: granted chips, waiters, counters, metrics text.
The mesh cases of the JAX file (axis sizes, a sub-mesh, lease devices)
are in ``tests/test_torch_parallel.py``.
"""

from __future__ import annotations

import random
import threading
import time

import pytest

from sm_distributed_tpu.engine import daemon as jdaemon
from sm_distributed_tpu.service import device_pool as jpool
from sm_distributed_tpu.service import metrics as jmetrics
from sm_distributed_tpu.service import scheduler as jsched
from sm_distributed_tpu.utils import config as jconfig
from sm_distributed_tpu_torch.engine import daemon as tdaemon
from sm_distributed_tpu_torch.service import device_pool as tpool
from sm_distributed_tpu_torch.service import metrics as tmetrics
from sm_distributed_tpu_torch.service import scheduler as tsched
from sm_distributed_tpu_torch.utils import config as tconfig

PACKAGES = {
    "jax": dict(pool=jpool, daemon=jdaemon, metrics=jmetrics, sched=jsched,
                config=jconfig),
    "torch": dict(pool=tpool, daemon=tdaemon, metrics=tmetrics,
                  sched=tsched, config=tconfig),
}


def _both(case, tmp_path=None):
    out = {}
    for name, m in PACKAGES.items():
        if tmp_path is None:
            out[name] = case(m)
        else:
            d = tmp_path / name
            d.mkdir()
            out[name] = case(m, d)
    assert out["torch"] == out["jax"], out
    return out["torch"]


# ------------------------------------------------------------ pool invariants
def test_pool_no_double_grant_and_contiguity_under_stress():
    def case(m):
        pool = m["pool"].DevicePool(8)
        owners = [None] * 8
        lock = threading.Lock()
        errors = []

        def worker(seed):
            rng = random.Random(seed)
            for _ in range(25):
                lease = pool.lease(rng.randint(1, 4), msg_id=f"w{seed}")
                with lease:
                    devs = lease.devices
                    with lock:
                        if list(devs) != list(range(devs[0],
                                                    devs[0] + len(devs))):
                            errors.append(f"non-contiguous grant {devs}")
                        for i in devs:
                            if owners[i] is not None:
                                errors.append(f"double grant of chip {i}")
                            owners[i] = lease
                    time.sleep(0.001)
                    with lock:
                        for i in devs:
                            owners[i] = None

        threads = [threading.Thread(target=worker, args=(s,))
                   for s in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return errors[:5], pool.in_use_count(), pool.grants_total

    assert _both(case) == ([], 0, 64 * 25)


def test_pool_packs_small_jobs_onto_distinct_chips():
    def case(m):
        pool = m["pool"].DevicePool(4)
        a, b = pool.lease(1, "a"), pool.lease(1, "b")
        big = pool.lease(2, "big")
        got = [a.acquire(timeout=1), b.acquire(timeout=1),
               big.acquire(timeout=1)]
        held = sorted(set(a.devices) | set(b.devices) | set(big.devices))
        locked = pool.locked()
        a.release(), b.release(), big.release()
        return got, held, locked, pool.locked(), pool.in_use_count()

    assert _both(case) == ([True] * 3, [0, 1, 2, 3], True, False, 0)


def test_pool_fifo_ish_fairness_same_size():
    def case(m):
        pool = m["pool"].DevicePool(1)
        holder = pool.lease(1, "holder")
        assert holder.acquire(timeout=1)
        grant_order = []
        lock = threading.Lock()

        def wait(name, lease):
            assert lease.acquire(timeout=10)
            with lock:
                grant_order.append(name)
            time.sleep(0.02)
            lease.release()

        threads = []
        for name in ("first", "second", "third"):
            lease = pool.lease(1, name)
            assert not lease.acquire(timeout=0.01)
            threads.append(threading.Thread(target=wait, args=(name, lease)))
        for t in threads:
            t.start()
        time.sleep(0.05)
        holder.release()
        for t in threads:
            t.join(timeout=10)
        return grant_order

    assert _both(case) == ["first", "second", "third"]


def test_pool_small_jobs_bypass_waiting_submesh_job():
    def case(m):
        pool = m["pool"].DevicePool(4, max_bypass=64)
        hold = pool.lease(2, "hold")
        out = [hold.acquire(timeout=1)]
        big = pool.lease(4, "big")
        out.append(big.acquire(timeout=0.02))
        small = pool.lease(1, "small")
        out.append(small.acquire(timeout=1))
        small.release()
        hold.release()
        out.append(big.acquire(timeout=5))
        big.release()
        return out

    assert _both(case) == [True, False, True, True]


def test_pool_starved_waiter_seals_queue():
    def case(m):
        pool = m["pool"].DevicePool(2, max_bypass=0)
        hold = pool.lease(1, "hold")
        out = [hold.acquire(timeout=1)]
        big = pool.lease(2, "big")
        out.append(big.acquire(timeout=0.02))
        late = pool.lease(1, "late")
        out.append(late.acquire(timeout=0.05))
        hold.release()
        out.append(big.acquire(timeout=5))
        big.release()
        out.append(late.acquire(timeout=5))
        late.release()
        return out

    assert _both(case) == [True, False, False, True, True]


def test_pool_release_while_waiting_deregisters():
    def case(m):
        pool = m["pool"].DevicePool(1)
        holder = pool.lease(1, "holder")
        out = [holder.acquire(timeout=1)]
        waiter = pool.lease(1, "waiter")
        out += [waiter.acquire(timeout=0.02), pool.waiters()]
        waiter.release()
        waiter.release()
        out.append(pool.waiters())
        holder.release()
        out.append(pool.in_use_count())
        return out

    assert _both(case) == [True, False, 1, 0, 0]


def test_pool_lease_clamps_and_legacy_token_protocol():
    def case(m):
        pool = m["pool"].DevicePool(4)
        out = [pool.lease(99).n, pool.lease(0).n, pool.acquire(timeout=1),
               pool.in_use_count()]
        pool.release()
        out.append(pool.in_use_count())
        with pytest.raises(RuntimeError):
            pool.release()
        with pool:
            out.append(pool.in_use_count())
        out.append(pool.in_use_count())
        return out

    assert _both(case) == [4, 1, True, 1, 0, 1, 0]


def test_pool_double_acquire_raises():
    def case(m):
        pool = m["pool"].DevicePool(2)
        lease = pool.lease(1)
        assert lease.acquire(timeout=1)
        with pytest.raises(RuntimeError, match="already holds") as ei:
            lease.acquire(timeout=1)
        lease.release()
        return str(ei.value)

    _both(case)


def test_resolve_pool_size():
    def case(m):
        cfg = m["config"].ServiceConfig
        return (m["pool"].resolve_pool_size(cfg(device_pool_size=3)),
                m["pool"].resolve_pool_size(None) >= 1,
                m["pool"].resolve_pool_size(cfg(), backend="numpy_ref") >= 1)

    assert _both(case) == (3, True, True)


# ------------------------------------------------- scheduler integration
def _cfg(m, **kw):
    base = dict(workers=3, poll_interval_s=0.02, job_timeout_s=10.0,
                max_attempts=1, backoff_base_s=0.05,
                heartbeat_interval_s=0.05, stale_after_s=0.5,
                drain_timeout_s=10.0)
    base.update(kw)
    return m["config"].ServiceConfig(**base)


def test_two_one_chip_jobs_overlap_on_distinct_chips(tmp_path):
    def case(m, d):
        holds = {}
        lock = threading.Lock()
        barrier = threading.Barrier(2, timeout=10)

        def cb(msg, ctx):
            with ctx.device_token as lease:
                barrier.wait()           # both INSIDE their holds at once
                with lock:
                    holds[msg["msg_id"]] = tuple(lease.devices)

        sched = m["sched"].JobScheduler(
            d / "q", cb, config=_cfg(m, device_pool_size=8,
                                     devices_per_job=1))
        pub = m["daemon"].QueuePublisher(d / "q")
        pub.publish({"ds_id": "a", "input_path": "/in", "msg_id": "a"})
        pub.publish({"ds_id": "b", "input_path": "/in", "msg_id": "b"})
        sched.start()
        assert sched.wait_for_terminal(2, timeout_s=20.0), sched.stats()
        assert sched.shutdown()
        return (sorted(holds), sorted(len(v) for v in holds.values()),
                set(holds["a"]).isdisjoint(holds["b"]),
                sched.device_pool.in_use_count())

    assert _both(case, tmp_path) == (["a", "b"], [1, 1], True, 0)


def test_submit_devices_override_claims_submesh(tmp_path):
    def case(m, d):
        seen = {}

        def cb(msg, ctx):
            with ctx.device_token as lease:
                seen[msg["msg_id"]] = tuple(lease.devices)

        sched = m["sched"].JobScheduler(
            d / "q", cb, config=_cfg(m, workers=1, device_pool_size=8,
                                     devices_per_job=2))
        pub = m["daemon"].QueuePublisher(d / "q")
        pub.publish({"ds_id": "d", "input_path": "/in", "msg_id": "default"})
        pub.publish({"ds_id": "d", "input_path": "/in", "msg_id": "four",
                     "devices": 4})
        pub.publish({"ds_id": "d", "input_path": "/in", "msg_id": "oversize",
                     "devices": 64})
        sched.start()
        assert sched.wait_for_terminal(3, timeout_s=20.0), sched.stats()
        assert sched.shutdown()
        four = seen["four"]
        return ({k: len(v) for k, v in seen.items()},
                list(four) == list(range(four[0], four[0] + 4)))

    assert _both(case, tmp_path) == (
        {"default": 2, "four": 4, "oversize": 8}, True)


def test_lease_released_on_callback_crash(tmp_path):
    def case(m, d):
        def cb(msg, ctx):
            if msg["msg_id"] == "crash_held":
                with ctx.device_token:
                    raise RuntimeError("boom inside hold")
            ctx.device_token.acquire(timeout=0.01)
            raise RuntimeError("boom before/while waiting")

        sched = m["sched"].JobScheduler(
            d / "q", cb, config=_cfg(m, workers=2, device_pool_size=2))
        pub = m["daemon"].QueuePublisher(d / "q")
        pub.publish({"ds_id": "x", "input_path": "/in",
                     "msg_id": "crash_held"})
        pub.publish({"ds_id": "x", "input_path": "/in",
                     "msg_id": "crash_wait"})
        sched.start()
        assert sched.wait_for_terminal(2, timeout_s=20.0), sched.stats()
        assert sched.shutdown()
        failed = sorted(p.stem for p in
                        (d / "q" / "sm_annotate" / "failed").glob("*.json"))
        return (sched.device_pool.in_use_count(),
                sched.device_pool.waiters(), failed)

    assert _both(case, tmp_path) == (0, 0, ["crash_held", "crash_wait"])


def test_pool_metrics_exposition():
    def case(m):
        reg = m["metrics"].MetricsRegistry()
        pool = m["pool"].DevicePool(2)
        pool.attach_metrics(reg)
        pool.attach_metrics(reg)
        with pool.lease(1, "j1"):
            held = reg.expose()
        after = reg.expose()
        keep = ("sm_device_pool_in_use", "sm_device_pool_grants_total",
                "sm_device_pool_devices", "sm_device_pool_wait_seconds_count")
        pick = lambda t: [ln for ln in t.splitlines() if ln.startswith(keep)]
        return pick(held), pick(after)

    held, after = _both(case)
    assert 'sm_device_pool_in_use{device="0"} 1' in held
    assert "sm_device_pool_devices 2" in held
    assert 'sm_device_pool_in_use{device="0"} 0' in after
    assert "sm_device_pool_wait_seconds_count 1" in after


# ------------------------------------------ quarantine fragmentation
def _quarantine(pool, *chips):
    for c in chips:
        assert pool.health._quarantine(c, "test quarantine")


def test_pool_fragmented_by_quarantine_grants_non_contiguous():
    def case(m):
        pool = m["pool"].DevicePool(8)
        _quarantine(pool, 2, 5)
        lease = pool.lease(4, "frag")
        out = [lease.acquire(timeout=2), list(lease.devices)]
        other = pool.lease(4, "frag2")
        out.append(other.acquire(timeout=0.05))
        lease.release()
        out += [other.acquire(timeout=2), list(other.devices)]
        other.release()
        out.append(pool.in_use_count())
        return out

    assert _both(case) == [True, [0, 1, 3, 4], False, True, [0, 1, 3, 4], 0]


def test_pool_healthy_but_busy_still_waits_contiguous():
    def case(m):
        pool = m["pool"].DevicePool(4)
        mid = pool.lease(1, "mid")
        a = pool.lease(1, "a")
        out = [mid.acquire(timeout=1), a.acquire(timeout=1),
               sorted(set(mid.devices) | set(a.devices))]
        big = pool.lease(3, "big")
        out.append(big.acquire(timeout=0.05))
        big.release()
        mid.release(), a.release()
        return out

    assert _both(case) == [True, True, [0, 1], False]


def test_pool_fairness_and_bypass_hold_under_quarantine():
    def case(m):
        pool = m["pool"].DevicePool(4, max_bypass=0)
        _quarantine(pool, 3)
        hold = pool.lease(1, "hold")
        out = [hold.acquire(timeout=1)]
        big = pool.lease(3, "big")
        out.append(big.acquire(timeout=0.02))
        late = pool.lease(1, "late")
        out.append(late.acquire(timeout=0.05))
        hold.release()
        out += [big.acquire(timeout=5), sorted(big.devices)]
        big.release()
        out.append(late.acquire(timeout=5))
        late.release()
        return out

    assert _both(case) == [True, False, False, True, [0, 1, 2], True]


def test_pool_release_and_reap_idempotent_with_quarantine():
    def case(m):
        pool = m["pool"].DevicePool(4)
        lease = pool.lease(4, "all")
        out = [lease.acquire(timeout=1), len(lease.devices)]
        pool.health._quarantine(2, "went sticky while held")
        lease.release()
        lease.release()
        pool.reap(lease)
        nxt = pool.lease(4, "next")
        out += [nxt.acquire(timeout=2), sorted(nxt.devices)]
        nxt.release()
        out += [pool.in_use_count(), pool.waiters()]
        return out

    assert _both(case) == [True, 4, True, [0, 1, 3], 0, 0]


def test_pool_never_quarantines_last_healthy_chip():
    def case(m):
        pool = m["pool"].DevicePool(2)
        out = [pool.health._quarantine(0, "bad"),
               pool.health._quarantine(1, "bad")]
        lease = pool.lease(2, "survivor")
        out += [lease.acquire(timeout=1), list(lease.devices)]
        lease.release()
        return out

    assert _both(case) == [True, False, True, [1]]
