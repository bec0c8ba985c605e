"""Cooperative cancellation and deadlines.

Port of ``sm_distributed_tpu/utils/cancel.py``: a ``CancelToken`` threaded
through ``SearchJob`` and ``MSMBasicSearch``, checked at phase and batch
boundaries::

    token.check("score")      # raises JobCancelledError once cancelled

so a cancelled job unwinds cooperatively: the ``with`` blocks release what
they hold and no partial results are stored.  A token trips on ``cancel``
(the first reason wins) or, lazily, once its absolute ``deadline_at`` has
passed.  ``check()`` doubles as a progress touch.  The service's scheduler
(``service/scheduler.py``) trips tokens on a per-attempt timeout, an
operator's ``DELETE /jobs/<id>`` and its stall watchdog.
"""

from __future__ import annotations

import contextlib
import threading
import time


class JobCancelledError(RuntimeError):
    """Raised inside a job when its CancelToken has been tripped."""


class DeadlineExceededError(JobCancelledError):
    """The job's absolute deadline passed (terminal — never retried)."""


class StreamIdleError(JobCancelledError):
    """A live acquisition went silent: no chunk was committed for
    ``service.stream.idle_timeout_s``.  Stream jobs are exempt from the
    absolute submit deadline (an acquisition has no known length), so this
    is their liveness bound.  Terminal like a deadline trip: retrying cannot
    conjure the missing chunks."""


class CancelToken:
    """Thread-safe one-shot cancellation flag with an optional absolute
    deadline and a progress heartbeat."""

    # guarded-by registry, the JAX package's own (tests hold the two equal):
    # the first-cancel-wins reason may only be written under _lock;
    # last_progress/progress_phase are deliberately unsynchronized heartbeat
    # fields (benign races)
    _GUARDED_BY = {"reason": "_lock"}

    def __init__(self, deadline_at: float | None = None):
        self._event = threading.Event()
        self._lock = threading.Lock()
        self.reason = ""
        self.deadline_at = deadline_at or None
        self.last_progress = time.time()
        self.progress_phase = ""

    def cancel(self, reason: str) -> bool:
        """Trip the token.  The first cancel wins (its reason sticks);
        returns True when THIS call did the tripping."""
        with self._lock:
            if self._event.is_set():
                return False
            self.reason = reason
            self._event.set()
            return True

    def cancelled(self) -> bool:
        """True once cancelled — including by a passed deadline, which is
        detected lazily here so pure pollers see it without a watcher."""
        if self._event.is_set():
            return True
        if self.deadline_at is not None and time.time() >= self.deadline_at:
            self.cancel(f"deadline exceeded ({self.deadline_at:.3f})")
            return True
        return False

    def deadline_exceeded(self) -> bool:
        return self.deadline_at is not None and time.time() >= self.deadline_at

    def remaining_s(self) -> float | None:
        """Seconds until the deadline (None when no deadline is set)."""
        if self.deadline_at is None:
            return None
        return self.deadline_at - time.time()

    def touch(self, phase: str = "") -> None:
        """Progress heartbeat: the watchdog cancels attempts whose last
        touch is older than ``service.watchdog_stall_s``."""
        self.last_progress = time.time()
        if phase:
            self.progress_phase = phase

    def check(self, phase: str = "") -> None:
        """The cooperative checkpoint: record progress, then raise if the
        token is tripped (``DeadlineExceededError`` for deadline trips)."""
        self.touch(phase)
        if self.cancelled():
            if self.reason.startswith("deadline"):
                raise DeadlineExceededError(self.reason)
            raise JobCancelledError(self.reason or "cancelled")


@contextlib.contextmanager
def hold_cancellable(lock, cancel: CancelToken | None, poll_s: float = 0.1,
                     phase: str = "device_token"):
    """``with lock:`` that stays cancellable while WAITING for the lock — a
    cancelled job must not sit in a device queue forever.  With no lock or
    no token this degrades to the plain context manager forms."""
    if lock is None:
        if cancel is not None:
            cancel.check(phase)
        yield
        return
    if cancel is None:
        with lock:
            yield
        return
    while not lock.acquire(timeout=poll_s):
        cancel.check(f"{phase}_wait")
    try:
        cancel.check(phase)
        yield
    finally:
        lock.release()
