"""The port's lock-order detector against the JAX package's.

Each case runs the same lock sequence under each package's detector in
turn (one patches ``threading`` at a time) and holds the outcomes equal:
the report (edges, cycles, same-site nesting, locks instrumented), the
errors raised, the wrapper types.  Every lock is allocated in this file,
so the site labels (``tests/test_torch_lockorder.py:<line>``) are the same
under both packages.  The port's scope is its own package: a JAX-package
path is out of it.
"""

from __future__ import annotations

import threading

import pytest

from sm_distributed_tpu.analysis import lockorder as jlo
from sm_distributed_tpu_torch.analysis import lockorder as tlo

SCOPE = ("tests/test_torch_lockorder.py",)
DETECTORS = {"jax": jlo, "torch": tlo}


@pytest.fixture(autouse=True)
def _restore():
    # never leak the monkeypatch into other tests, even on failure
    yield
    jlo.disable()
    tlo.disable()


def _run(fn) -> None:
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def _both(case) -> dict:
    out = {}
    for name, lo in DETECTORS.items():
        try:
            out[name] = case(lo)
        finally:
            lo.disable()
    assert out["torch"] == out["jax"], out
    return out["torch"]


def _inverted_pair(lo, mode="record"):
    lo.enable(scope=SCOPE, mode=mode)
    lock_a = threading.Lock()
    lock_b = threading.Lock()
    errors = []

    def t1():
        with lock_a:
            with lock_b:
                pass

    def t2():
        try:
            with lock_b:
                with lock_a:
                    pass
        except lo.LockOrderError as exc:
            errors.append(str(exc).split(" [thread")[0])

    _run(t1)
    _run(t2)
    return type(lock_a).__name__, errors


def test_seeded_inverted_order_is_detected_without_deadlocking():
    def case(lo):
        kind, errors = _inverted_pair(lo)
        rep = lo.report()
        with pytest.raises(lo.LockOrderError, match="cycle"):
            lo.assert_no_cycles("fixture")
        return kind, errors, rep

    kind, errors, rep = _both(case)
    assert kind == "TrackedLock" and not errors
    assert rep["edges"] == 2 and rep["cycles"]


def test_raise_mode_throws_in_the_acquiring_thread():
    def case(lo):
        return _inverted_pair(lo, mode="raise"), lo.report()

    (_kind, errors), rep = _both(case)
    assert len(errors) == 1 and "cycle" in errors[0]
    assert rep["mode"] == "raise"


def test_consistent_order_stays_clean():
    def case(lo):
        lo.enable(scope=SCOPE)
        lock_a = threading.Lock()
        lock_b = threading.Lock()

        def body():
            for _ in range(50):
                with lock_a:
                    with lock_b:
                        pass

        threads = [threading.Thread(target=body) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        return lo.assert_no_cycles("consistent order")

    rep = _both(case)
    assert rep["edges"] == 1 and not rep["cycles"]


def test_rlock_reentry_records_no_self_edge():
    def case(lo):
        lo.enable(scope=SCOPE)
        r = threading.RLock()
        other = threading.Lock()
        with r:
            with r:
                with other:
                    pass
        return lo.report()

    rep = _both(case)
    assert rep["edges"] == 1 and not rep["cycles"]


def test_same_site_nesting_is_tracked_but_not_a_cycle():
    def case(lo):
        lo.enable(scope=SCOPE)

        def make():
            return threading.Lock()

        l1, l2 = make(), make()
        with l1:
            with l2:
                pass
        return lo.report()

    rep = _both(case)
    assert not rep["cycles"]
    assert sum(rep["same_site_nesting"].values()) == 1


def test_condition_wait_releases_and_reacquires_cleanly():
    def case(lo):
        lo.enable(scope=SCOPE)
        cond = threading.Condition()
        ready = threading.Event()
        done = threading.Event()
        seen: list[bool] = []

        def waiter():
            with cond:
                ready.set()
                seen.append(cond.wait(timeout=5))
            done.set()

        t = threading.Thread(target=waiter)
        t.start()
        assert ready.wait(timeout=5)
        with cond:
            cond.notify_all()
        assert done.wait(timeout=5)
        t.join(timeout=5)
        return seen, lo.assert_no_cycles("condition wait")

    seen, rep = _both(case)
    assert seen == [True] and rep["locks_instrumented"] >= 1


def test_condition_on_rlock_wait_then_lock_ordering_still_tracked():
    def case(lo):
        lo.enable(scope=SCOPE)
        cond = threading.Condition()
        after = threading.Lock()

        def body():
            with cond:
                cond.wait(timeout=0.01)
                with after:
                    pass

        _run(body)
        return lo.report()

    rep = _both(case)
    assert rep["edges"] == 1 and not rep["cycles"]


def test_out_of_scope_locks_stay_raw():
    def case(lo):
        lo.enable(scope=("no/such/path",))
        lk = threading.Lock()
        with lk:
            pass
        return type(lk).__name__ == "TrackedLock", lo.report()

    tracked, rep = _both(case)
    assert not tracked and rep["locks_instrumented"] == 0


def test_disable_restores_threading_and_wrappers_stay_usable():
    def case(lo):
        lo.enable(scope=SCOPE)
        lk = threading.Lock()
        rep = lo.disable()
        restored = threading.Lock is lo._real_lock
        with lk:
            pass
        return restored, rep["locks_instrumented"], lo.enabled()

    assert _both(case) == (True, 1, False)


def test_enable_from_env(monkeypatch):
    def case(lo):
        out = []
        monkeypatch.setenv("SM_LOCK_ORDER", "0")
        out.append(lo.enable_from_env())
        monkeypatch.setenv("SM_LOCK_ORDER", "raise")
        out.append((lo.enable_from_env(), lo.report()["mode"]))
        lo.disable()
        monkeypatch.setenv("SM_LOCK_ORDER", "1")
        out.append((lo.enable_from_env(), lo.report()["mode"]))
        return out

    assert _both(case) == [False, (True, "raise"), (True, "record")]


def test_default_scopes_split_the_two_packages():
    """The JAX scope's substring would match the port's paths; the port's
    matches only the port."""
    port_file = "/x/sm_distributed_tpu_torch/service/scheduler.py"
    jax_file = "/x/sm_distributed_tpu/service/scheduler.py"
    assert any(s in port_file for s in jlo.DEFAULT_SCOPE)
    assert any(s in port_file for s in tlo.DEFAULT_SCOPE)
    assert not any(s in jax_file for s in tlo.DEFAULT_SCOPE)
    assert tlo._site_label(port_file, 7) == \
        "sm_distributed_tpu_torch/service/scheduler.py:7"
