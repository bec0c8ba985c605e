"""SearchJob — the end-to-end annotation job.

Port of ``sm_distributed_tpu/engine/search_job.py``: the one place that
touches every layer, with job status rows (STARTED/FINISHED/FAILED) in the
ledger.  ``run()`` goes through, in turn:

1. the ledger's dataset and job rows;
2. ``IsotopePrefetch`` started before staging (``parallel.overlap_isocalc``
   not "off"), so decoys and pattern generation overlap the input steps;
3. staging through the work dir (``stage_input``) and
   ``SpectralDataset.from_imzml`` (``read_dataset``);
4. ``MSMBasicSearch.search()`` on the configured backend (``torch_cuda``
   by default), with the pattern cache under ``<work_dir>/isocalc_cache``
   and the search's checkpoint shards in the job's work dir, so a rerun of
   a killed job resumes from its last durable batch group;
5. the results store (``store_results``): the ion images of annotations at
   FDR <= 0.5, taken off the device (``TorchBackend.extract_ion_images``),
   or from the search's numpy extraction when the config names
   ``numpy_ref``, then parquet, the sqlite index and the read segment;
6. the ledger's FINISHED row, then the checkpoint shards are removed.

Failure contract: any exception marks the job FAILED with its traceback,
removes this job's index rows (earlier jobs' rows stay queryable), keeps
the work dir (staged input, for the rerun) and re-raises.  ``profile_dir``
writes a ``torch.profiler`` trace of the search there.

The service's hooks, as in the JAX package: ``residency`` (an
``engine/residency.DatasetResidency`` shared across jobs) keeps parsed
datasets and set-up backends resident; ``device_token`` (the scheduler's
device-pool lease) is held, cancellably, from the backend set-up through
the store, and its chip is the search's device; ``fence`` is called before
results become durable and before the ledger commit; ``on_partial``
receives the search's provisional annotations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import traceback
from pathlib import Path

import numpy as np

from ..io.dataset import SpectralDataset
from ..models.msm_basic import (
    IsotopePrefetch,
    MSMBasicSearch,
    SearchResultsBundle,
)
from ..utils import devicemem, tracing
from ..utils.cancel import JobCancelledError, hold_cancellable
from ..utils.config import DSConfig, SMConfig
from ..utils.logger import logger, phase_timer
from .moldb import MolecularDB
from .storage import JobLedger, SearchResultsStore
from .work_dir import WorkDirManager


class SearchJob:
    """Run a full annotation job for one dataset."""

    def __init__(
        self,
        ds_id: str,
        ds_name: str,
        input_path: str | Path,
        ds_config: DSConfig,
        sm_config: SMConfig | None = None,
        formulas: list[str] | None = None,
        profile_dir: str | None = None,
        residency=None,
        device_token=None,
        cancel=None,
        fence=None,
        on_partial=None,
    ):
        self.ds_id = ds_id
        self.ds_name = ds_name
        # URIs (file://, s3://) must not round-trip through Path, which
        # collapses "://" to ":/" before the fetcher can parse it
        s = str(input_path)
        self.input_path: str | Path = s if "://" in s else Path(s)
        self.ds_config = ds_config
        self.sm_config = sm_config or SMConfig.get_conf()
        self.formulas = formulas      # explicit list overrides the mol DB
        self.profile_dir = profile_dir
        # service mode: parsed datasets and set-up backends shared across
        # jobs (engine/residency.DatasetResidency)
        self.residency = residency
        # the scheduler's device-pool lease (Lock-protocol compatible, so a
        # plain threading.Lock works too): the device-bound set-up, search
        # and store run under it while staging and parsing overlap across
        # jobs; its chips are the search's device or mesh
        self.device_token = device_token
        # utils/cancel.CancelToken or None: checked at phase boundaries
        # here and between batch groups in the search
        self.cancel = cancel
        # multi-replica fence gate (service/leases.py): raises
        # FenceRejectedError when a peer replica fenced this job's claim
        # out; called before results become durable and before the ledger
        # commit, the two writes a split-brain takeover would double
        self.fence = fence
        # provisional annotations of the search's first scored group: kept
        # in ``last_partial`` and forwarded to ``on_partial`` (the service's
        # job record)
        self.on_partial = on_partial
        self.last_partial: dict = {}
        self.ledger = JobLedger(self.sm_config.storage.results_dir)
        # generation stats and device-memory high-water mark of the last
        # completed run; the byte fields are None without a CUDA device
        self.last_isocalc_stats: dict = {}
        self.last_hbm: dict = {}
        self.store = SearchResultsStore(
            self.ledger,
            store_images=self.sm_config.storage.store_images,
            image_format=self.sm_config.storage.image_format,
        )
        self.work_dir = WorkDirManager(self.sm_config.work_dir, ds_id)

    def _load_formulas(self) -> list[str]:
        if self.formulas is not None:
            return list(self.formulas)
        db_cfg = self.ds_config.database
        return MolecularDB(self.ledger).formulas(db_cfg.name, db_cfg.version)

    def _check(self, phase: str) -> None:
        if self.cancel is not None:
            self.cancel.check(phase)

    def run(self, clean: bool = False) -> SearchResultsBundle:
        """Stage -> read -> search -> store; the job row tracks status."""
        self.ledger.upsert_dataset(
            self.ds_id, self.ds_name, str(self.input_path),
            dataclasses.asdict(self.ds_config),
        )
        job_id = self.ledger.start_job(self.ds_id)
        logger.info("job %d started for ds %s (%s)", job_id, self.ds_id,
                    self.ds_name)
        prof = None
        succeeded = False
        prefetch = None
        cache_dir = str(Path(self.sm_config.work_dir) / "isocalc_cache")
        try:
            timings: dict[str, float] = {}
            # pattern generation needs only the formulas and the configs:
            # start it first, so staging and parsing overlap it
            formulas = self._load_formulas()
            self._check("load_formulas")
            if self.sm_config.parallel.overlap_isocalc != "off":
                prefetch = IsotopePrefetch(formulas, self.ds_config,
                                           self.sm_config, cache_dir)
            ds = self._prepare_dataset(timings)
            logger.info("dataset %s: %dx%d px, %d peaks", self.ds_id,
                        ds.nrows, ds.ncols, ds.n_peaks)
            if self.device_token is None and self.cancel is None:
                token = contextlib.nullcontext()
            else:
                # a cancelled job must not sit in the device queue; the
                # `with` exit releases the lease on the cancel's unwind
                token = hold_cancellable(self.device_token, self.cancel)
            # the device_hold span covers the lease's wait and hold; the
            # acquired event marks the boundary between them
            with tracing.span("device_hold"), token:
                lease_devs = getattr(self.device_token, "devices", None)
                tracing.event(
                    "device_token_acquired",
                    **({"devices": [int(i) for i in lease_devs]}
                       if lease_devs else {}))
                if self.profile_dir:
                    prof = self._start_profile()
                search = MSMBasicSearch(
                    ds, formulas, self.ds_config, self.sm_config,
                    isocalc_cache_dir=cache_dir,
                    checkpoint_dir=str(self.work_dir.path),
                    backend_cache=self.residency,
                    prefetch=prefetch, cancel=self.cancel,
                    device_indices=lease_devs,
                    partial_observer=self._note_partial)
                prefetch = None   # ownership passed: search() consumes it
                bundle = search.search()
                if search.isocalc is not None:
                    self.last_isocalc_stats = dict(search.isocalc.last_stats)
                if prof is not None:
                    self._stop_profile(prof)
                    prof = None
                bundle.timings.update(timings)
                # the last gates before results become durable: a cancelled
                # job, or one whose claim a peer replica took over, stores
                # nothing
                self._check("store_results")
                if self.fence is not None:
                    self.fence()
                with phase_timer("store_results", bundle.timings):
                    table = search.last_table
                    ion_mzs = {
                        (sf, ad): mz for sf, ad, mz in zip(
                            table.sfs, table.adducts, table.mzs[:, 0])
                    } if table is not None else None
                    # images first, index and parquet swap last: a failure
                    # anywhere in storage leaves the previous successful
                    # job's results queryable
                    if self.sm_config.storage.store_images:
                        self._store_annotation_images(ds, search, bundle)
                    self.store.store(self.ds_id, job_id, bundle, ion_mzs)
                # the device high-water mark while this job's tensors are
                # still resident.  A reading, never a reset: the allocator's
                # peak is per device and shared by every worker of the
                # process, so whoever owns the measurement window (a
                # benchmark script, between jobs) resets it
                self.last_hbm = devicemem.hbm_summary()
                if self.last_hbm.get("hbm_peak_bytes") is not None:
                    tracing.event("hbm_job_peak", **self.last_hbm)
            if self.fence is not None:
                # ledger-commit fence: a stale replica must not flip the job
                # row FINISHED under the takeover replica's run
                self.fence()
            self.ledger.finish_job(job_id)
            if search.last_checkpoint is not None:
                # only after results are durably stored: a storage failure
                # above must leave the checkpoint for the rerun to resume
                # from; and a failed cleanup must not FAIL a finished job
                try:
                    search.last_checkpoint.finalize()
                except OSError:
                    logger.warning(
                        "could not remove search checkpoint shards under %s",
                        search.last_checkpoint.dir, exc_info=True)
            logger.info("job %d FINISHED (%d annotations)", job_id,
                        len(bundle.annotations))
            succeeded = True
            return bundle
        except Exception as exc:
            if prefetch is not None:
                # the job died between prefetch start and search(): stop
                # the background generation before reporting the failure
                try:
                    prefetch.cancel()
                except Exception:
                    logger.warning("isotope prefetch cancel failed",
                                   exc_info=True)
            if prof is not None:
                self._stop_profile(prof)
            self.ledger.fail_job(job_id, f"{exc}\n{traceback.format_exc()}")
            # remove THIS job's index rows; earlier successful jobs' rows
            # stay queryable
            self.store.index.delete_ds(self.ds_id, job_id=job_id)
            if isinstance(exc, JobCancelledError):
                logger.info("job %d CANCELLED: %s", job_id, exc)
            else:
                logger.error("job %d FAILED: %s", job_id, exc)
            raise
        finally:
            # on failure the work dir survives even with clean=True: it
            # holds the staged input the rerun resumes from
            if clean and succeeded:
                self.work_dir.clean()
            elif clean:
                logger.info("job failed: keeping work dir %s for resume",
                            self.work_dir.path)

    def _note_partial(self, payload: dict) -> None:
        """Provisional annotations landed: keep the latest payload and
        forward it to ``on_partial`` (a consumer's failure never fails the
        job)."""
        self.last_partial = dict(payload or {})
        if self.on_partial is None:
            return
        try:
            self.on_partial(self.last_partial)
        except Exception:
            logger.warning("on_partial consumer failed", exc_info=True)

    def _start_profile(self):
        """A ``torch.profiler`` capture of the search (CPU activity, and
        CUDA activity on a CUDA device), written to ``profile_dir`` when
        stopped; its directory is recorded in the job's trace."""
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.sm_config.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        tracing.event("torch_profile", dir=str(self.profile_dir))
        return prof

    def _stop_profile(self, prof) -> None:
        prof.stop()
        out = Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{self.ds_id}.trace.json"
        prof.export_chrome_trace(str(path))
        logger.info("profile trace written to %s", path)

    def _prepare_dataset(self, timings: dict[str, float]) -> SpectralDataset:
        """Stage the input and parse it into the CSR layout."""
        with phase_timer("stage_input", timings):
            self.work_dir.copy_input_data(self.input_path)
        self._check("stage_input")
        with phase_timer("read_dataset", timings):
            ds = self._read_dataset()
        self._check("read_dataset")
        return ds

    def _read_dataset(self) -> SpectralDataset:
        """Parse the staged imzML, or reuse the residency's copy, keyed on
        the staging manifest so a restaged different input misses."""
        path = self.work_dir.imzml_path()
        if self.residency is None:
            return SpectralDataset.from_imzml(path)
        manifest = self.work_dir.file("input.manifest.json")
        content = manifest.read_text() if manifest.exists() else str(path)
        key = (self.ds_id, hashlib.sha256(content.encode()).hexdigest())
        return self.residency.dataset(
            key, lambda: SpectralDataset.from_imzml(path))

    def _store_annotation_images(self, ds: SpectralDataset,
                                 search: MSMBasicSearch,
                                 bundle: SearchResultsBundle) -> None:
        """Persist the ion images of annotations at FDR <= 0.5, taken off
        the device extraction (``TorchBackend.extract_ion_images``, bit-equal
        to the JAX package's and to the numpy extraction) rather than
        re-extracted on the host; on ``numpy_ref``, the search's own sorted
        view extracts them (``NumpyBackend.extract_ion_images``)."""
        table = search.last_table
        if table is None or bundle.annotations.empty:
            return
        keep = bundle.annotations[bundle.annotations.fdr_level <= 0.5]
        want = set(zip(keep.sf, keep.adduct))
        idx = [i for i, (sf, ad) in enumerate(zip(table.sfs, table.adducts))
               if (sf, ad) in want]
        if not idx:
            return
        sub = table.__class__(
            sfs=[table.sfs[i] for i in idx],
            adducts=[table.adducts[i] for i in idx],
            mzs=table.mzs[idx],
            ints=table.ints[idx],
            n_valid=table.n_valid[idx],
            targets=table.targets[idx],
        )
        images = search.last_backend.extract_ion_images(sub)
        path = self.store.store_ion_images(
            self.ds_id, np.asarray(images),
            list(zip(sub.sfs, sub.adducts)), ds.nrows, ds.ncols,
            mask=ds.get_sample_area_mask(),
        )
        logger.info("stored %d ion image sets -> %s", len(idx), path)
