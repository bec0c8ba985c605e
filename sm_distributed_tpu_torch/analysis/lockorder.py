"""Runtime lock-order detection ("tsan-lite"), a copy of
``sm_distributed_tpu/analysis/lockorder.py`` scoped to this package.

With the scheduler dispatcher, worker pool, watchdog, replica loop,
telemetry sampler, HTTP handlers, and device-pool waiters all taking locks,
one inverted pair (thread A: records-lock -> pool-cond, thread B: pool-cond
-> records-lock) is a fleet-wide deadlock that no amount of single-thread
testing finds.

``enable()`` monkeypatches ``threading.Lock`` / ``RLock`` /
``Condition`` with instrumented factories.  Each lock created by code in
*scope* (a match on the allocation site's path: ``sm_distributed_tpu_torch/``,
which holds the package and its drivers; third-party, interpreter-internal
and JAX-package locks stay untouched raw primitives) is wrapped; every
acquire records, per thread, the edge ``site(already-held lock) ->
site(acquiring lock)`` into a process-global graph **at acquire-intent
time** (before blocking — so a cycle is reported even when the schedule
would really deadlock).  A cycle in the site graph is a potential
deadlock regardless of whether this run interleaved badly.

Semantics and deliberate approximations (the same as the JAX package's):

- lock identity is the ALLOCATION SITE (``file:line``), so two instances
  of the same class alias to one node.  Same-site nesting (A1 held while
  acquiring A2 created at the same line) is recorded separately in
  ``same_site`` and excluded from cycles — per-instance nesting is
  usually address-ordered by construction and site aliasing would make
  every such pattern a false self-loop;
- RLock re-entry by the owning thread records no edge (it cannot block);
- ``Condition.wait`` releases the underlying lock: the wrapper forwards
  ``_release_save`` / ``_acquire_restore`` / ``_is_owned`` with held-set
  bookkeeping, so the wait window neither leaks a phantom hold nor loses
  the re-acquire edge;
- edges are recorded for timed/non-blocking acquires too (intent is what
  orders, not success).

Modes: ``record`` (default) accumulates the graph — drivers call
``assert_no_cycles()`` at the end; ``raise`` throws ``LockOrderError``
in the acquiring thread the moment a new edge closes a cycle (the
drivers run their children this way via ``SM_LOCK_ORDER=raise``, where a
mid-job exception surfaces as a failed scenario).

Wired in: ``drivers/chaos_sweep.py`` (driver and consumer children),
``drivers/replica_chaos.py`` (replica children) and ``chip_smoke.py``'s
replica takeover.  Locks created BEFORE ``enable()`` (module-level locks
of already-imported modules) are not instrumented — the drivers enable
first, and the interesting graph (scheduler/pool/admission/metrics/
telemetry instance locks) is created per-service anyway.
"""

from __future__ import annotations

import os
import sys
import threading

_SM_ROOT = "sm_distributed_tpu_torch"
# the trailing slash keeps the JAX package's paths ("sm_distributed_tpu/")
# out of scope: only this package (and its drivers) is instrumented
DEFAULT_SCOPE = (_SM_ROOT + "/",)

_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_condition = threading.Condition


class LockOrderError(RuntimeError):
    """A lock acquisition-order cycle (potential deadlock) was detected."""


class _Detector:
    def __init__(self, scope: tuple[str, ...], mode: str):
        self.scope = tuple(scope)
        self.mode = mode
        # site graph: (from_site, to_site) -> witness
        self.edges: dict[tuple[str, str], dict] = {}
        self.same_site: dict[str, int] = {}
        self.locks_created = 0
        self._mu = _real_lock()       # raw primitive: never instrumented
        self._tls = threading.local()

    # ------------------------------------------------------------ held set
    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def note_intent(self, tracked) -> None:
        """Record ordering edges BEFORE blocking on ``tracked``."""
        held = self._held()
        new_cycle = None
        with self._mu:
            for h in held:
                if h is tracked:
                    return            # re-entry handled by caller
                if h.site == tracked.site:
                    self.same_site[h.site] = \
                        self.same_site.get(h.site, 0) + 1
                    continue
                edge = (h.site, tracked.site)
                if edge not in self.edges:
                    self.edges[edge] = {
                        "thread": threading.current_thread().name,
                        "held": h.label, "acquiring": tracked.label,
                    }
                    cyc = self._find_cycle_locked(tracked.site, h.site)
                    if cyc is not None:
                        new_cycle = cyc + [tracked.site]
        if new_cycle is not None and self.mode == "raise":
            raise LockOrderError(
                "lock-order cycle (potential deadlock): "
                + " -> ".join(new_cycle)
                + f" [thread {threading.current_thread().name}]")

    def note_acquired(self, tracked) -> None:
        self._held().append(tracked)

    def note_released(self, tracked) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is tracked:
                del held[i]
                return

    # --------------------------------------------------------------- graph
    def _adj_locked(self) -> dict[str, list[str]]:
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        return adj

    def _find_cycle_locked(self, start: str, goal: str) -> list | None:
        """Path start -> ... -> goal in the edge graph (the new edge
        goal -> start then closes the cycle)."""
        adj = self._adj_locked()
        stack = [(start, [start])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in adj.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    def cycles(self) -> list[list[str]]:
        """Elementary cycles in the recorded site graph (self-loops are
        tracked in ``same_site`` and never enter the edge set)."""
        with self._mu:
            adj = self._adj_locked()
        out, seen_keys = [], set()
        for root in sorted(adj):
            stack = [(root, [root])]
            while stack:
                node, path = stack.pop()
                for nxt in adj.get(node, ()):
                    if nxt == root:
                        key = frozenset(path)
                        if key not in seen_keys:
                            seen_keys.add(key)
                            out.append(path + [root])
                    elif nxt not in path and nxt > root:
                        # only walk nodes > root so each cycle is found
                        # once, from its smallest node
                        stack.append((nxt, path + [nxt]))
        return out

    def report(self) -> dict:
        with self._mu:
            n_edges = len(self.edges)
            same = dict(self.same_site)
            created = self.locks_created
        return {"mode": self.mode, "locks_instrumented": created,
                "edges": n_edges, "cycles": self.cycles(),
                "same_site_nesting": same}


_detector: _Detector | None = None


# ------------------------------------------------------------ lock wrappers
class _TrackedBase:
    def __init__(self, inner, site: str, label: str):
        self._inner = inner
        self.site = site
        self.label = label

    def locked(self):
        return self._inner.locked()

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<tracked {self.label} wrapping {self._inner!r}>"


class TrackedLock(_TrackedBase):
    """Instrumented ``threading.Lock``."""

    def acquire(self, blocking=True, timeout=-1):
        det = _detector
        if det is not None:
            det.note_intent(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok and det is not None:
            det.note_acquired(self)
        return ok

    def release(self):
        self._inner.release()
        det = _detector
        if det is not None:
            det.note_released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TrackedRLock(_TrackedBase):
    """Instrumented ``threading.RLock`` (Condition-compatible)."""

    def __init__(self, inner, site, label):
        super().__init__(inner, site, label)
        self._depth = threading.local()

    def _d(self) -> int:
        return getattr(self._depth, "n", 0)

    def acquire(self, blocking=True, timeout=-1):
        det = _detector
        first = self._d() == 0
        if first and det is not None:
            det.note_intent(self)     # re-entry cannot block: no edge
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._depth.n = self._d() + 1
            if first and det is not None:
                det.note_acquired(self)
        return ok

    def release(self):
        self._inner.release()
        self._depth.n = max(0, self._d() - 1)
        if self._d() == 0:
            det = _detector
            if det is not None:
                det.note_released(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # Condition support: wait() fully releases the lock via _release_save
    # and re-takes it via _acquire_restore — mirror that in the held set
    def _release_save(self):
        state = self._inner._release_save()
        det = _detector
        if det is not None:
            det.note_released(self)
        saved_depth = self._d()
        self._depth.n = 0
        return (state, saved_depth)

    def _acquire_restore(self, saved):
        state, depth = saved
        det = _detector
        if det is not None:
            det.note_intent(self)
        self._inner._acquire_restore(state)
        self._depth.n = depth
        if det is not None:
            det.note_acquired(self)

    def _is_owned(self):
        return self._inner._is_owned()

    def locked(self):
        # RLock has no locked() before 3.12; Condition never calls it
        fn = getattr(self._inner, "locked", None)
        return fn() if fn is not None else self._d() > 0


# ----------------------------------------------------------------- factories
def _caller_site() -> tuple[str, int] | None:
    """First stack frame outside this module — the allocation site."""
    f = sys._getframe(2)
    here = __file__
    while f is not None and f.f_code.co_filename == here:
        f = f.f_back
    if f is None:
        return None
    return f.f_code.co_filename, f.f_lineno


def _site_label(filename: str, lineno: int) -> str:
    name = filename.replace("\\", "/")
    for marker in (_SM_ROOT, "tests/"):
        i = name.rfind("/" + marker)
        if i >= 0:
            name = name[i + 1:]
            break
    return f"{name}:{lineno}"


def _in_scope(filename: str) -> bool:
    det = _detector
    if det is None:
        return False
    name = filename.replace("\\", "/")
    return any(s in name for s in det.scope)


def _make_lock():
    inner = _real_lock()
    det = _detector
    site = _caller_site()
    if det is None or site is None or not _in_scope(site[0]):
        return inner
    label = _site_label(*site)
    with det._mu:
        det.locks_created += 1
    return TrackedLock(inner, label, label)


def _make_rlock():
    inner = _real_rlock()
    det = _detector
    site = _caller_site()
    if det is None or site is None or not _in_scope(site[0]):
        return inner
    label = _site_label(*site)
    with det._mu:
        det.locks_created += 1
    return TrackedRLock(inner, label, label)


def _make_condition(lock=None):
    # threading.Condition() allocates its RLock from inside threading.py,
    # which the scope filter would skip — allocate it HERE so the lock is
    # attributed (and instrumented) at the Condition caller's site
    if lock is None:
        lock = _make_rlock()
    return _real_condition(lock)


# -------------------------------------------------------------------- public
def enable(scope: tuple[str, ...] = DEFAULT_SCOPE,
           mode: str = "record") -> None:
    """Patch the ``threading`` lock factories.  Idempotent; ``disable()``
    restores.  ``mode``: ``record`` (inspect later) or ``raise`` (throw
    ``LockOrderError`` at the acquire that closes a cycle)."""
    global _detector
    if mode not in ("record", "raise"):
        raise ValueError(f"lockorder mode must be record|raise, got {mode!r}")
    if _detector is not None:
        return
    _detector = _Detector(scope, mode)
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition


def enable_from_env() -> bool:
    """Opt-in via ``SM_LOCK_ORDER`` (""/0 = off, "raise" = raise mode,
    anything else = record).  Called by the sweep entrypoints before they
    import/build the service stack."""
    val = os.environ.get("SM_LOCK_ORDER", "")
    if val in ("", "0"):
        return False
    enable(mode="raise" if val == "raise" else "record")
    return True


def disable() -> dict:
    """Restore the real factories; returns the final ``report()``.  Locks
    already handed out keep their (functionally transparent) wrappers."""
    global _detector
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    threading.Condition = _real_condition
    rep = _detector.report() if _detector is not None else {
        "mode": "off", "locks_instrumented": 0, "edges": 0, "cycles": [],
        "same_site_nesting": {}}
    _detector = None
    return rep


def enabled() -> bool:
    return _detector is not None


def report() -> dict:
    if _detector is None:
        return {"mode": "off", "locks_instrumented": 0, "edges": 0,
                "cycles": [], "same_site_nesting": {}}
    return _detector.report()


def assert_no_cycles(context: str = "") -> dict:
    """Raise ``LockOrderError`` if the recorded graph has a cycle; returns
    the report otherwise (sweeps log the edge/lock counts as evidence the
    detector actually watched something)."""
    rep = report()
    if rep["cycles"]:
        lines = [" -> ".join(c) for c in rep["cycles"]]
        raise LockOrderError(
            f"lock-order cycle(s) detected{f' in {context}' if context else ''}: "
            + "; ".join(lines))
    return rep
