"""Multi-dataset residency for service mode.

Port of ``sm_distributed_tpu/engine/residency.py``.  The service keeps the
last N parsed datasets (the host CSR layout: seconds of parse for a large
slide) and the last N set-up ``TorchBackend``s (the sorted, restricted
peak arrays resident on the card: seconds of set-up and hundreds of MB of
upload) across jobs with LRU eviction, so a second job on the same
dataset and ions skips the parse and the backend set-up.

Keys carry content identity, not just names: datasets key on the staged
input manifest (so a restaged different file misses), backends key on the
search fingerprint (dataset content, image config, batch partition, ion
table), every backend-shaping parallel knob and the lease's device.

A resident backend whose device met a sticky fault is dropped
(:meth:`DatasetResidency.evict_backend`): its tensors may live in a dead
context, so the next job sets up a fresh one.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from ..utils.logger import logger


class _LRU:
    """Thread-safe LRU.  The service scheduler's workers share one residency
    across concurrent jobs; the lock guards only the dict bookkeeping, NOT
    ``builder()`` — holding it through a minutes-long parse would serialize
    exactly the CPU staging the scheduler exists to overlap.  Two workers
    missing on the same key may therefore both build; the first insert wins
    and the duplicate is dropped (device-backend builds don't race in
    practice because they run under the job's device lease)."""

    # shared-state registry, the JAX package's own (tests hold the two equal):
    # mutated only under _lock
    _GUARDED_BY = {"data": "_lock", "hits": "_lock", "misses": "_lock"}

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def get_or_build(self, key, builder):
        with self._lock:
            if self.maxsize <= 0:
                self.misses += 1
            elif key in self.data:
                self.hits += 1
                self.data.move_to_end(key)
                return self.data[key]
            else:
                self.misses += 1
        val = builder()
        if self.maxsize <= 0:
            return val
        with self._lock:
            if key in self.data:       # concurrent builder won — reuse theirs
                return self.data[key]
            self.data[key] = val
            while len(self.data) > self.maxsize:
                old_key, _old = self.data.popitem(last=False)
                logger.info("residency: evicted %s", old_key[0] if old_key else old_key)
        return val

    def evict(self, key) -> bool:
        with self._lock:
            return self.data.pop(key, None) is not None


class DatasetResidency:
    """LRU caches for host datasets and set-up backends across jobs."""

    def __init__(self, max_datasets: int = 2, max_backends: int = 2):
        self._datasets = _LRU(max_datasets)
        self._backends = _LRU(max_backends)

    def dataset(self, key, loader):
        return self._datasets.get_or_build(key, loader)

    def backend(self, key, builder):
        return self._backends.get_or_build(key, builder)

    def evict_backend(self, key) -> bool:
        """Drop the backend under ``key`` (True when one was resident)."""
        if self._backends.evict(key):
            logger.warning("residency: evicted backend %s after a device "
                           "fault", key[0] if key else key)
            return True
        return False

    @property
    def stats(self) -> dict:
        return {
            "dataset_hits": self._datasets.hits,
            "dataset_misses": self._datasets.misses,
            "backend_hits": self._backends.hits,
            "backend_misses": self._backends.misses,
        }
