"""MSM basic search: isotope patterns -> ion images -> metrics -> FDR.

Port of ``sm_distributed_tpu/models/msm_basic.py``::

    ds = SpectralDataset.from_imzml(path)
    MSMBasicSearch(ds, formulas, ds_config, sm_config).search()

Decoy selection and isotope patterns run on the host (patterns through an
``IsocalcWrapper`` whose on-disk shard cache ``isocalc_cache_dir`` keeps
them across jobs), formula batches are scored by the backend that
``SMConfig.backend`` names — ``torch_cuda`` (``models/msm_torch.py``, the
card) or ``numpy_ref`` (:class:`NumpyBackend`, the host oracle) — and FDR
runs on the host.  ``IsotopePrefetch`` starts decoys and pattern generation
in the background; ``SearchJob`` starts it before staging the input and
hands it to the search.  On ``numpy_ref`` scoring overlaps generation:
each batch group scores once its pattern rows have landed.

Resilience, as in the JAX package:

- **checkpoints**: with a ``checkpoint_dir`` and
  ``parallel.checkpoint_every > 0``, batches are scored in groups (the
  leading group one batch) and each group's metric rows land in a CRC'd
  shard (:class:`SearchCheckpoint`); a rerun resumes from the longest valid
  shard prefix.  Shards and fingerprints are the JAX package's, so a
  checkpoint written by either package resumes in the other;
- **OOM backoff**: a CUDA out-of-memory halves the batch and rescores the
  group in place, with the same bits, and the converged size is remembered
  for the next job on the shape (``models/oom.py``);
- **the fault taxonomy and the breaker**: a sticky device fault counts on
  the device breaker (``models/faults.py``, ``models/breaker.py``); once it
  opens, ``torch_cuda`` jobs fail with ``DeviceUnavailableError``, logged
  and counted, until a half-open probe closes it.  The JAX package's
  degrade to the numpy oracle is not ported: device work never moves to
  the host, and ``numpy_ref`` scores only when the config names it.
  Program faults (a kernel that does not build or launch) re-raise at
  once;
- **cancellation**: a ``CancelToken`` is checked between batch groups and
  between batches.

Service hooks, as in the JAX package: ``backend_cache`` (an
``engine/residency.DatasetResidency``) keeps set-up backends resident across
jobs, a backend whose device met a sticky fault is evicted from it;
``device_indices`` is the job's device-pool lease: one chip ``i`` is
``cuda:i``, several chips a mesh over them (``parallel/sharded.py``), and
a leased search answers to its chips' breakers; ``partial_observer``
receives provisional annotations over the first scored group; the
first-annotation observers hear when the first FDR-rankable metrics exist;
checkpoint shards pass the disk governor's preflight.  In a multi-process
runtime (``parallel/distributed.py``) every process resumes a checkpointed
search from the same group; on a mesh spanning processes each scores its
own cells, and a device OOM fails its process instead of halving the batch
there alone.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import pandas as pd

from ..io.dataset import SpectralDataset
from ..ops import buckets as shape_buckets
from ..ops import metrics_np
from ..ops.fdr import FDR, DecoyAssignment
from ..ops.imager_np import SortedPeakView, extract_ion_images
from ..ops.isocalc import (
    ISOCALC_PATTERN_VERSION,
    IsocalcWrapper,
    IsotopePatternTable,
)
from ..parallel import distributed
from ..utils import tracing
from ..utils.cancel import JobCancelledError
from ..utils.config import DSConfig, SMConfig
from ..utils.failpoints import failpoint, record_recovery, register_failpoint
from ..utils.logger import logger, phase_timer
from . import faults, oom
from .breaker import get_device_breaker, refuse_device
from .faults import FP_CHIP_FAULT

FP_SHARD_WRITE = register_failpoint(
    "ckpt.shard_write",
    "between a checkpoint shard's tmp savez and its os.replace (torn/crash)")
FP_SHARD_LOAD = register_failpoint(
    "ckpt.shard_load", "per-shard checkpoint read (I/O error on resume)")
FP_DEVICE_SCORE = register_failpoint(
    "device.score_batch",
    "before scoring a batch group (device failure mid-search)")
FP_DEVICE_ERROR = register_failpoint(
    "backend.device_error",
    "inside a device score_batches call — the consecutive-error seam the "
    "circuit breaker counts (open -> jobs refused -> half-open probe); "
    "raise:MemoryError injects a device OOM, which is a SIZING signal: "
    "batch backoff, no breaker count (models/oom.py)")


# Checkpoint partition format version, hashed into the search fingerprint
# (the JAX package's): bump whenever the group-partition RULE changes (a
# resume under a different partition would leave unscored zero rows).  v2 =
# the leading group is a single batch, so the first FDR-rankable
# annotations land while later batches still run.
_PARTITION_VERSION = 2


# First-annotation observers: called once per search when the first
# group's metrics land, the earliest moment FDR-rankable results exist.  The
# service's SLOTracker subscribes without this module importing the service.
_first_annotation_observers: list = []


def add_first_annotation_observer(fn) -> None:
    if fn not in _first_annotation_observers:
        _first_annotation_observers.append(fn)


def remove_first_annotation_observer(fn) -> None:
    if fn in _first_annotation_observers:
        _first_annotation_observers.remove(fn)


def _notify_first_annotation() -> None:
    """Exception-safe dispatch (observability never fails the search)."""
    for fn in list(_first_annotation_observers):
        try:
            fn()
        except Exception:
            logger.warning("first-annotation observer %r failed", fn,
                           exc_info=True)


def _slice_table(table: IsotopePatternTable, s: int, e: int
                 ) -> IsotopePatternTable:
    return IsotopePatternTable(
        sfs=table.sfs[s:e],
        adducts=table.adducts[s:e],
        mzs=table.mzs[s:e],
        ints=table.ints[s:e],
        n_valid=table.n_valid[s:e],
        targets=table.targets[s:e],
    )


def maybe_order_table(table: IsotopePatternTable, order_ions: str,
                      formula_batch: int) -> IsotopePatternTable:
    """Apply parallel.order_ions: "mz" always orders, "table" never, "auto"
    orders when the stream has >= 6 batches.  Per-ion metrics are the same
    in any order; only batch composition changes."""
    if order_ions == "mz":
        return order_table_by_mz(table)
    if order_ions == "table":
        return table
    n_batches = -(-table.n_ions // max(1, formula_batch))
    return order_table_by_mz(table) if n_batches >= 6 else table


def order_table_by_mz(table: IsotopePatternTable) -> IsotopePatternTable:
    """Reorder ions by principal-peak m/z (stable), targets and decoys
    interleaved, so each batch's window union is m/z-localized."""
    order = np.argsort(table.mzs[:, 0], kind="stable")
    return IsotopePatternTable(
        sfs=[table.sfs[i] for i in order],
        adducts=[table.adducts[i] for i in order],
        mzs=table.mzs[order],
        ints=table.ints[order],
        n_valid=table.n_valid[order],
        targets=table.targets[order],
    )


class NumpyBackend:
    """The reference-semantics host backend (``numpy_ref``): the parity
    oracle of ``torch_cuda``, run when the config names it.  It is built
    from the host dataset and tables alone and never touches a device."""

    name = "numpy_ref"

    def __init__(self, ds: SpectralDataset, ds_config: DSConfig):
        self.ds = ds
        self.ds_config = ds_config
        # sort once, reuse per batch; ppm selects the shared integer
        # intensity grid (exact cross-backend image parity)
        self._view = SortedPeakView.prepare(ds, ds_config.image_generation.ppm)

    def score_batches(self, tables, cancel=None) -> list[np.ndarray]:
        """Score an iterable of batches one at a time (a lazy generator
        keeps only one slice live).  ``cancel`` is checked between
        batches."""
        out = []
        for t in tables:
            if cancel is not None:
                cancel.check("score_batch")
            out.append(self.score_batch(t))
        return out

    def extract_ion_images(self, table: IsotopePatternTable) -> np.ndarray:
        """(n_ions, max_peaks, n_pixels) window images on the search's
        sorted view (the results store's images)."""
        return extract_ion_images(self._view, table,
                                  self.ds_config.image_generation.ppm)

    def score_batch(self, table: IsotopePatternTable) -> np.ndarray:
        """(n_ions, 4) array of (chaos, spatial, spectral, msm)."""
        with tracing.span("score_batch", backend=self.name,
                          ions=int(table.n_ions)):
            return self._score_batch(table)

    def _score_batch(self, table: IsotopePatternTable) -> np.ndarray:
        img_cfg = self.ds_config.image_generation
        images = extract_ion_images(self._view, table, img_cfg.ppm)
        out = np.zeros((table.n_ions, 4))
        for i in range(table.n_ions):
            out[i] = metrics_np.ion_metrics(
                images[i],
                table.ints[i],
                int(table.n_valid[i]),
                self.ds.nrows,
                self.ds.ncols,
                nlevels=img_cfg.nlevels,
                do_preprocessing=img_cfg.do_preprocessing,
                q=img_cfg.q,
            )
        return out


def make_backend(name: str, ds: SpectralDataset, ds_config: DSConfig,
                 sm_config: SMConfig, table: IsotopePatternTable | None = None,
                 device_indices=None, devices=None):
    """The scoring backend named ``name``.  ``table`` (the search's full ion
    table) lets the device backend drop dataset peaks outside every window;
    ``device_indices`` (a device-pool lease) or ``devices`` (an explicit
    device list) picks its device or mesh
    (``parallel/sharded.make_torch_backend``)."""
    if name == "numpy_ref":
        return NumpyBackend(ds, ds_config)
    if name == "torch_cuda":
        from ..parallel.sharded import make_torch_backend

        return make_torch_backend(ds, ds_config, sm_config,
                                  restrict_table=table,
                                  device_indices=device_indices,
                                  devices=devices)
    raise ValueError(f"unknown backend {name!r}")


def lease_device(device: str, device_indices=None):
    """The torch device of a device-pool lease, as the residency keys a
    set-up backend by it: chip ``i`` of a ``cuda`` config is ``cuda:i``; a
    ``cpu`` config stays on the CPU (the pool's chips are then simulated);
    a lease of several chips is the tuple of its chips' devices."""
    if not device_indices:
        return device
    if len(device_indices) > 1:
        return tuple(lease_device(device, (i,)) for i in device_indices)
    if str(device).split(":")[0] != "cuda":
        return device
    return f"cuda:{int(device_indices[0])}"


def make_isocalc(ds_config: DSConfig, sm_config: SMConfig,
                 cache_dir: str | None) -> IsocalcWrapper:
    """IsocalcWrapper wired to the engine's ``parallel.isocalc_*`` knobs.
    The device stage runs on the search's device (``sm_config.device``),
    outside any device-pool lease, as the JAX package's runs on its default
    device."""
    par = sm_config.parallel
    return IsocalcWrapper(ds_config.isotope_generation, cache_dir=cache_dir,
                          n_procs=par.isocalc_workers or None,
                          # "on" forces the device stage; "off" leaves the
                          # decision to the SM_ISOCALC_DEVICE env (None)
                          device_blur=(True if par.isocalc_device == "on"
                                       else None),
                          chunk_size=par.isocalc_chunk,
                          device=sm_config.device)


class IsotopePrefetch:
    """Background decoy selection and isotope-pattern generation.

    ``SearchJob`` starts this before staging and parsing the input, so
    pattern generation overlaps them; everything here depends only on the
    formula list and the configs.  ``result()`` joins the set-up thread
    (decoy sampling, cache-shard load, stream start — generation keeps
    running in the returned ``PatternStream``) and re-raises a set-up
    failure; ``cancel()`` tears the stream down when the job dies before
    consuming it."""

    def __init__(self, formulas: list[str], ds_config: DSConfig,
                 sm_config: SMConfig, cache_dir: str | None):
        self.formulas = list(dict.fromkeys(formulas))
        self.ds_config = ds_config
        self.sm_config = sm_config
        self.cache_dir = cache_dir
        self.timings: dict[str, float] = {}
        self.fdr: FDR | None = None
        self.assignment: DecoyAssignment | None = None
        self.isocalc: IsocalcWrapper | None = None
        self.stream = None
        self._error: BaseException | None = None
        # thread hop: the caller's trace context goes along
        self._trace = tracing.current()
        self._thread = threading.Thread(
            target=self._run, name="isotope-prefetch", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            with tracing.attach(self._trace), \
                    tracing.span("isotope_prefetch_setup"):
                self._setup()
        except BaseException as exc:  # noqa: BLE001 — result() re-raises
            self._error = exc

    def _setup(self) -> None:
        iso_cfg = self.ds_config.isotope_generation
        fdr_cfg = self.sm_config.fdr
        self.fdr = FDR(decoy_sample_size=fdr_cfg.decoy_sample_size,
                       target_adducts=iso_cfg.adducts, seed=fdr_cfg.seed)
        t0 = time.perf_counter()
        self.assignment = self.fdr.decoy_adduct_selection(self.formulas)
        self.pairs, self.flags = self.assignment.all_ion_tuples(
            self.formulas, iso_cfg.adducts)
        self.timings["decoy_selection"] = time.perf_counter() - t0
        # wrapper construction loads the cache shards: in this thread too
        self.isocalc = make_isocalc(self.ds_config, self.sm_config,
                                    self.cache_dir)
        self.stream = self.isocalc.stream_table(self.pairs, self.flags)

    def result(self):
        """(fdr, assignment, stream) — blocks on set-up only."""
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self.fdr, self.assignment, self.stream

    def cancel(self) -> None:
        self._thread.join()
        if self.stream is not None:
            self.stream.cancel()


class SearchCheckpoint:
    """Mid-search checkpoint of scored metrics (the JAX package's format).

    Append-style: one small npz shard per completed batch group (only that
    group's metric rows), so checkpoint I/O is linear in ions.  Shards are
    keyed by a fingerprint of (ion table, batch partition, image config,
    dataset content); a resume trusts only the contiguous shard prefix
    g0..gk.  Metrics are backend-independent, so a search may resume under
    a different backend, or package, than it started with.
    """

    def __init__(self, directory: str | Path, fingerprint: str,
                 process_id: int = 0):
        # per-process filenames: co-located processes (or a shared work_dir
        # mount) must not race on one tmp/ckpt inode
        self.dir = Path(directory)
        self.prefix = f"msm_search.p{process_id}"
        self.fingerprint = fingerprint
        self.dir.mkdir(parents=True, exist_ok=True)

    def _shard(self, gi: int) -> Path:
        return self.dir / f"{self.prefix}.g{gi:05d}.ckpt.npz"

    def load(self, metrics: np.ndarray, n_groups: int,
             row_ranges: list[tuple[int, int]]) -> int:
        """Restore ``metrics`` rows in place from the contiguous shard
        prefix; return the number of completed batch groups (0 if absent or
        stale).

        A shard that is unreadable, truncated, shape-mismatched, or fails its
        CRC32 checksum is treated as MISSING — the prefix ends there and the
        groups recompute — never as fatal: a torn checkpoint write must
        degrade to extra work, not crash the resume path."""
        done = 0
        for gi in range(n_groups):
            path = self._shard(gi)
            if not path.exists():
                break
            try:
                failpoint(FP_SHARD_LOAD, path=path)
                with np.load(path, allow_pickle=False) as z:
                    if (str(z["fingerprint"]) != self.fingerprint
                            or int(z["n_groups"]) != n_groups):
                        break             # stale checkpoint — normal miss
                    s, e = row_ranges[gi]
                    rows = z["rows"]
                    if rows.shape != (e - s, metrics.shape[1]):
                        raise ValueError("shard row shape mismatch")
                    # np.load returns rows from a zip whose payload bytes
                    # were silently corrupted in place; the checksum catches
                    # what the container format does not
                    if int(z["checksum"]) != zlib.crc32(
                            np.ascontiguousarray(rows).tobytes()):
                        raise ValueError("shard checksum mismatch")
                    metrics[s:e] = rows
            except Exception as exc:
                # unreadable/corrupt shard: trust only the prefix before it
                record_recovery("ckpt.corrupt_shard")
                logger.warning(
                    "checkpoint shard %s rejected (%s); resuming from the "
                    "%d-group prefix before it", path.name, exc, done)
                break
            done = gi + 1
        return done

    def save(self, metrics: np.ndarray, gi: int, n_groups: int,
             row_ranges: list[tuple[int, int]]) -> None:
        s, e = row_ranges[gi]
        rows = np.ascontiguousarray(metrics[s:e])
        # disk-budget preflight (service/resources.py): a full disk fails the
        # shard BEFORE a torn write, with headroom reserved for the seams
        # below this one.  No-op outside the service.
        from ..service import resources as _resources

        _resources.preflight("ckpt.shard_write", rows.nbytes + 4096)
        tmp = self._shard(gi).with_suffix(".tmp.npz")  # same dir -> atomic
        np.savez(tmp, fingerprint=np.str_(self.fingerprint),
                 rows=rows, n_groups=n_groups,
                 checksum=zlib.crc32(rows.tobytes()))
        failpoint(FP_SHARD_WRITE, path=tmp)
        os.replace(tmp, self._shard(gi))

    def finalize(self) -> None:
        # shards AND any orphaned tmp from a kill between savez and replace
        for path in self.dir.glob(f"{self.prefix}.g*"):
            path.unlink(missing_ok=True)


@dataclass
class SearchResultsBundle:
    """Everything a search produces: annotated targets and every scored ion."""

    annotations: pd.DataFrame      # target ions with fdr/fdr_level
    all_metrics: pd.DataFrame      # every scored ion incl. decoys
    timings: dict[str, float] = field(default_factory=dict)


class MSMBasicSearch:
    """End-to-end search over a dataset and a formula list."""

    _ANN_COLUMNS = ["sf", "adduct", "msm", "fdr", "fdr_level",
                    "chaos", "spatial", "spectral"]
    _ALL_COLUMNS = ["sf", "adduct", "is_target", "chaos", "spatial",
                    "spectral", "msm"]

    def __init__(self, ds: SpectralDataset, formulas: list[str],
                 ds_config: DSConfig, sm_config: SMConfig | None = None,
                 isocalc_cache_dir: str | None = None,
                 checkpoint_dir: str | None = None,
                 backend_cache=None,
                 prefetch: IsotopePrefetch | None = None, cancel=None,
                 device_indices=None, partial_observer=None, devices=None):
        self.ds = ds
        self.formulas = list(dict.fromkeys(formulas))  # dedup, keep order
        self.ds_config = ds_config
        self.sm_config = sm_config or SMConfig.get_conf()
        # checkpoint shards land here when parallel.checkpoint_every > 0
        self.checkpoint_dir = checkpoint_dir
        # service mode (engine/residency.DatasetResidency): reuse a set-up
        # backend across jobs when the search fingerprint, the
        # backend-shaping knobs and the lease's device all match
        self.backend_cache = backend_cache
        self._backend_key = None
        # decoys and generation already running (SearchJob's prefetch):
        # search() consumes its stream instead of starting one
        self.prefetch = prefetch
        # utils/cancel.CancelToken or None: checked between batch groups
        # and between batches
        self.cancel = cancel
        # the job's device-pool lease: one chip, or a mesh over several
        self.device_indices = (tuple(int(i) for i in device_indices)
                               if device_indices else None)
        # an explicit device list to mesh over in the lease's place (it may
        # repeat a device: the tests and chip_smoke.py on one card)
        self.devices = list(devices) if devices is not None else None
        # provisional annotations over the first scored group go here (the
        # service's job record); None = no consumer
        self.partial_observer = partial_observer
        self.isocalc = None if prefetch is not None else make_isocalc(
            ds_config, self.sm_config, isocalc_cache_dir)
        # read by SearchJob to store ion images and m/z values, and to
        # finalize the checkpoint once results are stored
        self.last_table: IsotopePatternTable | None = None
        self.last_backend = None
        self.last_checkpoint: SearchCheckpoint | None = None
        # the pad-to batch snapped to the lattice (slicing here and padding
        # in the backend use the same value), capped by a LEARNED safe size
        # for this shape before the fingerprint (the checkpoint partition
        # depends on it)
        self._batch_eff = shape_buckets.effective_batch(self.sm_config.parallel)
        # in-flight OOM backoff cap: once a group halves its way to a
        # fitting size, every later group of this search starts capped there
        self._oom_cap = 0

    def _fingerprint(self, table: IsotopePatternTable) -> str:
        """Identity of a search for checkpoint validity (the JAX package's
        hash, byte for byte): the exact ion table (decoys included), the
        image-config knobs, the batch partition and the dataset content (a
        strided peak sample and the exact intensity sum).  The backend is
        not hashed: metrics are backend-independent."""
        img = self.ds_config.image_generation
        par = self.sm_config.parallel
        h = hashlib.sha256()
        h.update(repr((self.ds.nrows, self.ds.ncols, int(self.ds.n_peaks),
                       img.ppm, img.nlevels, img.do_preprocessing, img.q,
                       # the EFFECTIVE batch: the partition is keyed on what
                       # actually runs, under the current partition format
                       self._batch_eff, par.checkpoint_every,
                       _PARTITION_VERSION)).encode())
        self._hash_dataset(h)
        h.update("\x00".join(table.sfs).encode())
        h.update("\x00".join(table.adducts).encode())
        h.update(np.ascontiguousarray(table.mzs).tobytes())
        return h.hexdigest()

    def _fingerprint_pairs(self, table: IsotopePatternTable) -> str:
        """Checkpoint fingerprint computable BEFORE patterns exist (the
        overlapped ``numpy_ref`` path scores leading groups while generation
        runs): instead of the pattern m/z block it hashes what determines
        it — the ion list, the isotope-generation params,
        ``ISOCALC_PATTERN_VERSION`` and the device-blur flag."""
        img = self.ds_config.image_generation
        par = self.sm_config.parallel
        iso = self.ds_config.isotope_generation
        h = hashlib.sha256()
        h.update(repr((self.ds.nrows, self.ds.ncols, int(self.ds.n_peaks),
                       img.ppm, img.nlevels, img.do_preprocessing, img.q,
                       self._batch_eff, par.checkpoint_every,
                       _PARTITION_VERSION)).encode())
        self._hash_dataset(h)
        h.update("\x00".join(table.sfs).encode())
        h.update("\x00".join(table.adducts).encode())
        h.update(repr((iso.charge, iso.isocalc_sigma, iso.isocalc_pts_per_mz,
                       iso.n_peaks, ISOCALC_PATTERN_VERSION,
                       bool(self.isocalc.device_blur))).encode())
        return h.hexdigest()

    def _hash_dataset(self, h) -> None:
        stride = max(1, self.ds.mzs_flat.size // 65536)
        h.update(np.ascontiguousarray(self.ds.mzs_flat[::stride]).tobytes())
        h.update(np.ascontiguousarray(self.ds.ints_flat[::stride]).tobytes())
        h.update(np.float64(
            self.ds.ints_flat.sum(dtype=np.float64)).tobytes())

    def _agree_resume_point(self, done: int) -> int:
        """Multi-process: every process must resume from the SAME batch
        group, or their searches leave the lockstep the runtime keeps.
        Checkpoints are per-process local files, so the processes agree on
        min(done) (rows below it are valid everywhere) with a gloo
        ``all_reduce(MIN)``; one process keeps its own ``done``."""
        if self.sm_config.backend != "torch_cuda":
            return done
        agreed = distributed.agree_min(done)
        if agreed != done:
            logger.info(
                "checkpoint resume point lowered %d -> %d to agree with "
                "other processes", done, agreed)
        return agreed

    def _oom_key(self) -> str:
        """Safe-batch registry key: what a batch's device footprint depends
        on (models/oom.py), keyed on the pixel bucket."""
        return oom.shape_key(self.ds.n_pixels, self.sm_config.backend,
                             self.device_indices)

    @staticmethod
    def _capped_slices(slices: list[tuple[int, int]],
                       cap: int) -> list[tuple[int, int]]:
        """Re-split scoring slices at ``cap`` ions; the checkpoint partition
        is untouched.  Callers pass lattice-point caps (``_oom_backoff``
        snaps them down)."""
        return [(a, min(a + cap, e))
                for s, e in slices for a in range(s, e, cap)]

    def _oom_backoff(self, backend, slices: list[tuple[int, int]],
                     cap: int, error: str) -> int:
        """Device OOM recovery: halve the scoring batch (snapped down to the
        lattice) and tell the device backend to shrink its padding batch.
        Returns the new cap, or 0 when the batch is already a single ion
        (nothing left to shrink — the OOM is then a real failure for the
        caller, but still NOT a breaker count).  Host work only."""
        cur = cap or max(e - s for s, e in slices)
        if getattr(backend, "spans_processes", False):
            # the other processes' collectives would no longer match a
            # batch halved here alone: the OOM fails this process, and the
            # others fail at the group's timeout
            oom.record_oom_event("score_group", error)
            logger.error("device OOM in one process of a mesh spanning "
                         "processes: no backoff in place: %s", error)
            return 0
        new = cur // 2
        if new >= 1 and shape_buckets.buckets_enabled(
                self.sm_config.parallel):
            new = shape_buckets.batch_bucket_down(new)
        oom.record_oom_event("score_group", error)
        if new < 1:
            logger.error(
                "device OOM at a single-ion batch — cannot back off "
                "further: %s", error)
            return 0
        if hasattr(backend, "shrink_batch"):
            backend.shrink_batch(new)
        logger.warning(
            "device OOM while scoring — a SIZING signal, not a device "
            "fault (no breaker count): halving batch %d -> %d and "
            "retrying in place (%s)", cur, new, error)
        tracing.event("oom_backoff", from_batch=cur, to_batch=new,
                      error=error[:300])
        return new

    def _score_group(self, backend, table, metrics: np.ndarray,
                     group: list[tuple[int, int]], breaker,
                     use_device: bool) -> None:
        """Score one checkpoint group through the fault taxonomy and the
        breaker.

        - OOM: the batch halves and the group rescores in place with the
          same bits; the converged size is remembered for the next job on
          this shape.  No breaker count.
        - program fault (a kernel that does not build or launch, a CUDA
          error naming the code): re-raised at once, no breaker count.
        - transient: re-raised for the caller's retry, no breaker count.
        - sticky: counts on the breaker; below its threshold it re-raises,
          at the threshold the breaker opens and the job fails with
          ``DeviceUnavailableError`` (counted and logged).  Nothing here
          moves the work to the host.

        The OOM retry runs after the ``except`` block is left: the live
        exception's traceback holds the failed attempt's frames, and with
        them its device scratch and image block, so a halved retry started
        inside the block could run out of memory again for no reason.  The
        device backend copies each group's metrics to the host inside
        ``score_batches``, so every asynchronous device error of the group
        is raised inside this ``try``."""
        slices = group
        if self._oom_cap:
            # an earlier group already backed off: the backend's padding
            # batch is shrunk, so later groups must arrive pre-capped
            slices = self._capped_slices(slices, self._oom_cap)
        oom_cap = 0
        while True:
            try:
                if use_device:
                    failpoint(FP_DEVICE_ERROR)
                    failpoint(FP_CHIP_FAULT)
                outs = backend.score_batches(
                    (_slice_table(table, s, e) for s, e in slices),
                    cancel=self.cancel)
            except JobCancelledError:
                raise
            except Exception as exc:
                if not use_device:
                    raise             # a host-backend bug is not a device fault
                kind = faults.classify(exc)
                if kind != faults.FAULT_OOM:
                    faults.report_device_fault(self.device_indices, kind, exc)
                if kind == faults.FAULT_PROGRAM:
                    logger.error(
                        "program fault while scoring (a kernel or the code, "
                        "not the device: no breaker count): %s", exc)
                    raise
                if kind != faults.FAULT_OOM:
                    if kind == faults.FAULT_TRANSIENT:
                        logger.warning(
                            "transient device fault while scoring — "
                            "re-raised for the retry policy (no breaker "
                            "count): %s", exc)
                        raise
                    now_open = breaker.record_failure()
                    logger.warning(
                        "sticky device fault while scoring (breaker %s "
                        "after it): %s", breaker.state, exc)
                    if self._backend_key is not None:
                        # its tensors may live in a dead context
                        self.backend_cache.evict_backend(self._backend_key)
                    if not now_open:
                        raise         # below threshold: the retry policy
                                      # probes the device again
                    raise refuse_device(
                        f"a sticky device fault opened it mid-job "
                        f"({exc})") from exc
                new_cap = self._oom_backoff(backend, slices, oom_cap,
                                            str(exc))
                if not new_cap:
                    raise             # single-ion batch still OOMs: no breaker
            else:
                # a cleanly scored device group closes a half-open probe,
                # resets the consecutive-error count and clears the lease
                # chip's suspect state
                if use_device:
                    breaker.record_success()
                    faults.report_device_ok(self.device_indices)
                break
            # out of the except block: the failed attempt's frames are gone
            oom_cap = new_cap
            slices = self._capped_slices(slices, new_cap)
        if oom_cap:
            # the group converged at oom_cap: later groups of THIS search
            # stay capped, and later jobs on this shape start there
            self._oom_cap = oom_cap
            oom.record_safe_batch(self._oom_key(), oom_cap)
        for (s, e), out in zip(slices, outs):
            metrics[s:e] = out

    def _emit_partial(self, fdr: FDR, assignment: DecoyAssignment,
                      table: IsotopePatternTable, metrics: np.ndarray,
                      n_scored: int, gi: int) -> None:
        """Provisional annotations over the scored prefix: rank the first
        ``n_scored`` ions' msm through the real FDR estimator (the decoy set
        is the prefix's: provisional by construction, converging to the
        final ranking as groups land) and publish a small summary to the
        job trace and the ``partial_observer`` (the service threads it into
        the job record's ``partial`` field).  Best-effort: a failure here
        degrades to no preview, never a failed search."""
        if n_scored >= table.n_ions or n_scored <= 0:
            return                    # single group: final results imminent
        if self.partial_observer is None and not tracing.enabled():
            return
        try:
            sub = pd.DataFrame({
                "sf": table.sfs[:n_scored],
                "adduct": table.adducts[:n_scored],
                "msm": metrics[:n_scored, 3],
            })
            ann = fdr.estimate_fdr(sub, assignment)
            top = ann.sort_values("msm", ascending=False).head(5)
            payload = {
                "provisional": True,
                "group": int(gi),
                "n_scored": int(n_scored),
                "n_ions": int(table.n_ions),
                "annotations": int(len(ann)),
                "fdr_10pct": int((ann["fdr"] <= 0.1).sum()),
                "top": [
                    {"sf": str(r.sf), "adduct": str(r.adduct),
                     "msm": round(float(r.msm), 6),
                     "fdr": round(float(r.fdr), 6)}
                    for r in top.itertuples()
                ],
            }
        except Exception:
            logger.warning("provisional partial annotations failed",
                           exc_info=True)
            return
        tracing.event("partial_annotations",
                      **{k: v for k, v in payload.items() if k != "top"})
        obs = self.partial_observer
        if obs is not None:
            try:
                obs(payload)
            except Exception:
                logger.warning("partial-results observer %r failed", obs,
                               exc_info=True)

    def search(self) -> SearchResultsBundle:
        timings: dict[str, float] = {}
        if not self.formulas:
            return SearchResultsBundle(
                annotations=pd.DataFrame(columns=self._ANN_COLUMNS),
                all_metrics=pd.DataFrame(columns=self._ALL_COLUMNS),
            )
        iso_cfg = self.ds_config.isotope_generation
        if self.prefetch is not None:
            fdr, assignment, stream = self.prefetch.result()
            self.isocalc = self.prefetch.isocalc
            timings.update(self.prefetch.timings)
        else:
            fdr = FDR(decoy_sample_size=self.sm_config.fdr.decoy_sample_size,
                      target_adducts=iso_cfg.adducts,
                      seed=self.sm_config.fdr.seed)
            with phase_timer("decoy_selection", timings):
                assignment = fdr.decoy_adduct_selection(self.formulas)
                pairs, flags = assignment.all_ion_tuples(
                    self.formulas, iso_cfg.adducts)
            stream = self.isocalc.stream_table(pairs, flags)
        try:
            return self._score_and_rank(stream, fdr, assignment, timings)
        except BaseException:
            stream.cancel()
            raise

    def _groups(self, slices: list[tuple[int, int]], ckpt_every: int,
                overlap: bool):
        """The batch groups and their row ranges.  With checkpoints, groups
        of ``ckpt_every`` batches after a leading single-batch group (the
        partition the fingerprint's ``_PARTITION_VERSION`` names); without,
        one group a batch when scoring overlaps generation, else the
        leading batch and the rest (first annotations after one batch)."""
        if ckpt_every > 0:
            groups = [slices[:1]] + [
                slices[1:][i:i + ckpt_every]
                for i in range(0, len(slices) - 1, ckpt_every)]
        elif overlap:
            groups = [[sl] for sl in slices]
        elif len(slices) > 1:
            groups = [slices[:1], slices[1:]]
        else:
            groups = [slices]
        groups = [g for g in groups if g]
        return groups, [(g[0][0], g[-1][1]) for g in groups]

    def _score_and_rank(self, stream, fdr: FDR, assignment: DecoyAssignment,
                        timings: dict[str, float]) -> SearchResultsBundle:
        # The host backend scores each group as soon as its pattern rows
        # are published.  The device backend takes the whole table up front
        # (window-union peak restriction, presizing), so it waits for the
        # stream, as the JAX package's device backend does.
        par = self.sm_config.parallel
        # device circuit breaker: an OPEN breaker refuses a torch_cuda job
        # before any work (the port never scores it on the host instead);
        # allow_device() admits one half-open probe after the cooldown
        use_device = self.sm_config.backend == "torch_cuda"
        # a leased search answers to its chips' breakers, so one bad chip's
        # history never refuses jobs holding other chips; an un-leased
        # search answers to the process breaker ("*")
        breaker = get_device_breaker(self.sm_config.service,
                                     devices=self.device_indices)
        if use_device and not breaker.allow_device():
            raise refuse_device(
                "a torch_cuda job refused until the cooldown's half-open "
                f"probe ({self.sm_config.service.breaker_cooldown_s} s)")
        overlap = (par.overlap_isocalc != "off"
                   and self.sm_config.backend == "numpy_ref")
        with phase_timer("isotope_patterns", timings):
            if overlap:
                table = stream.table_view()   # rows fill in as chunks land
            else:
                table = stream.result_table()
                table = maybe_order_table(table, par.order_ions,
                                          par.formula_batch)
        self.last_table = table
        logger.info(
            "scoring %d ions (%d targets, %d decoys) with backend=%s%s",
            table.n_ions, int(table.targets.sum()),
            int((~table.targets).sum()), self.sm_config.backend,
            " (overlapping isocalc)" if overlap else "")
        # a previous job on this (dataset shape, backend) proved a
        # smaller batch fits: start there.  Before the fingerprint: the
        # checkpoint partition depends on it
        safe = oom.safe_batch_for(self._oom_key())
        if safe and safe < self._batch_eff:
            logger.info(
                "oom: starting at learned safe batch %d (config %d) for %s",
                safe, self._batch_eff, self._oom_key())
            self._batch_eff = safe
        def build():
            return make_backend(self.sm_config.backend, self.ds,
                                self.ds_config, self.sm_config, table=table,
                                device_indices=self.device_indices,
                                devices=self.devices)

        with phase_timer("backend_setup", timings):
            if self.backend_cache is not None:
                fingerprint = (self._fingerprint_pairs(table) if overlap
                               else self._fingerprint(table))
                # a backend is pinned to its lease's device: a resident one
                # must never serve a job holding another chip
                self._backend_key = (
                    self.sm_config.backend, fingerprint, par.mz_chunk,
                    par.peak_compaction, par.band_slice, par.order_ions,
                    par.cube_dtype, par.fused_metrics, par.pixels_axis,
                    par.formulas_axis,
                    lease_device(self.sm_config.device, self.device_indices),
                    None if self.devices is None
                    else tuple(str(d) for d in self.devices))
                backend = self.backend_cache.backend(self._backend_key, build)
            else:
                backend = build()
        self.last_backend = backend
        batch = self._batch_eff
        if batch < max(1, par.formula_batch) and \
                hasattr(backend, "shrink_batch"):
            # the learned safe size also caps the device backend's padding
            # batch (padding to the config size would run out again)
            backend.shrink_batch(batch)
        metrics = np.zeros((table.n_ions, 4))
        with phase_timer("score", timings):
            slices = [(s, min(s + batch, table.n_ions))
                      for s in range(0, table.n_ions, batch)]
            ckpt_every = par.checkpoint_every if self.checkpoint_dir else 0
            groups, row_ranges = self._groups(slices, ckpt_every, overlap)
            ckpt, done = None, 0
            if ckpt_every > 0:
                fingerprint = (self._fingerprint_pairs(table) if overlap
                               else self._fingerprint(table))
                ckpt = SearchCheckpoint(self.checkpoint_dir, fingerprint,
                                        process_id=distributed.world()[0])
                done = self._agree_resume_point(
                    ckpt.load(metrics, len(groups), row_ranges))
                if done:
                    logger.info(
                        "resuming search from checkpoint: %d/%d batch groups "
                        "already scored", done, len(groups))
            if len(groups) > 1 and hasattr(backend, "presize"):
                # presizing first keeps every batch at one band width
                backend.presize(_slice_table(table, s, e) for s, e in slices)
            first_scored = False
            for gi, group in enumerate(groups):
                if gi < done:
                    continue
                if self.cancel is not None:
                    # the cooperative cancellation boundary: after the last
                    # durable checkpoint and before any new work
                    self.cancel.check("score")
                if overlap:
                    # block until this group's pattern rows are published,
                    # in bounded waits so a cancel still lands
                    need = row_ranges[gi][1]
                    if self.cancel is None:
                        stream.wait_rows(need)
                    else:
                        while stream.wait_rows(need, timeout=0.2) < min(
                                need, stream.n_ions):
                            self.cancel.check("isotope_patterns_wait")
                # device-fault seam: a failed device surfaces here, after
                # `done` groups are already durable
                failpoint(FP_DEVICE_SCORE)
                with tracing.span("score_group", group=gi,
                                  rows=list(row_ranges[gi])):
                    self._score_group(backend, table, metrics, group,
                                      breaker, use_device)
                if not first_scored:
                    # the first FDR-rankable metrics of this search exist
                    # now: the submit -> first-annotation SLI's stop clock
                    first_scored = True
                    tracing.event("first_annotation", group=gi)
                    _notify_first_annotation()
                    self._emit_partial(fdr, assignment, table, metrics,
                                       row_ranges[gi][1], gi)
                if ckpt is not None:
                    with tracing.span("checkpoint_save", group=gi):
                        ckpt.save(metrics, gi, len(groups), row_ranges)
            # NOT finalized here: FDR and storage can still fail, and the
            # scored metrics must survive a rerun; SearchJob finalizes after
            # results are durably stored.  A leftover checkpoint is harmless
            # (fingerprint-guarded).
            self.last_checkpoint = ckpt
            if not first_scored:
                # fully resumed from a checkpoint: the first annotations
                # were there at once
                _notify_first_annotation()
            if overlap:
                # join generation and surface any late stream error
                stream.result_table()
        if self.cancel is not None:
            self.cancel.check("fdr")
        with phase_timer("fdr", timings):
            all_df = pd.DataFrame({
                "sf": table.sfs,
                "adduct": table.adducts,
                "is_target": table.targets,
                "chaos": metrics[:, 0],
                "spatial": metrics[:, 1],
                "spectral": metrics[:, 2],
                "msm": metrics[:, 3],
            })
            annotations = fdr.estimate_fdr(all_df[["sf", "adduct", "msm"]],
                                           assignment)
            annotations = annotations.merge(
                all_df[["sf", "adduct", "chaos", "spatial", "spectral"]],
                on=["sf", "adduct"], how="left")
            annotations = annotations[self._ANN_COLUMNS]
            all_df = all_df[self._ALL_COLUMNS]
        return SearchResultsBundle(annotations=annotations,
                                   all_metrics=all_df, timings=timings)
