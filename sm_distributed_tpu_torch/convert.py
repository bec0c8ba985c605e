"""Build the port's objects from plain arrays and dicts.

The port shares no code with the JAX package, so state crosses between the
two as plain numpy arrays and config dicts: a caller takes the arrays out of
one package's ``SpectralDataset`` or ``IsotopePatternTable`` and rebuilds
the other's with these functions.  The tests use them so that both packages
score identical state.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .io.dataset import SpectralDataset
from .ops.isocalc import IsotopePatternTable
from .utils.config import DSConfig, ParallelConfig, SMConfig


def dataset_from_arrays(nrows: int, ncols: int, pixel_inds, mask, mzs_flat,
                        ints_flat, row_ptr) -> SpectralDataset:
    """A port ``SpectralDataset`` from its CSR arrays (copied)."""
    return SpectralDataset(
        nrows=int(nrows), ncols=int(ncols),
        pixel_inds=np.array(pixel_inds, dtype=np.int64),
        mask=np.array(mask, dtype=bool),
        mzs_flat=np.array(mzs_flat, dtype=np.float64),
        ints_flat=np.array(ints_flat, dtype=np.float32),
        row_ptr=np.array(row_ptr, dtype=np.int64),
    )


def pattern_table_from_arrays(sfs, adducts, mzs, ints, n_valid,
                              targets) -> IsotopePatternTable:
    """A port ``IsotopePatternTable`` from its arrays (copied)."""
    return IsotopePatternTable(
        sfs=[str(s) for s in sfs],
        adducts=[str(a) for a in adducts],
        mzs=np.array(mzs, dtype=np.float64),
        ints=np.array(ints, dtype=np.float64),
        n_valid=np.array(n_valid, dtype=np.int32),
        targets=np.array(targets, dtype=bool),
    )


# the multi-process runtime's knobs describe a launch, not a search, and
# the JAX package's compile cache is not the port's kernel build directory
_PARALLEL_KEYS = {f for f in ParallelConfig.__dataclass_fields__} - {
    "coordinator_address", "num_processes", "process_id", "init_retries",
    "init_backoff_s", "compile_cache_dir"}


def configs_from_dicts(sm_dict: dict[str, Any], ds_dict: dict[str, Any],
                       device: str | None = None) -> tuple[SMConfig, DSConfig]:
    """Port configs from the dicts a JAX-package search takes.

    ``ds_dict`` carries over as it is.  From ``sm_dict`` the port keeps
    ``fdr`` and the ``parallel`` knobs it has, the mesh axes included; the
    backend becomes ``torch_cuda``, and the JAX package's other sections
    (service, storage, tracing, ...) and parallel knobs (the multi-process
    runtime, the compile cache) do not change scores and are left out.  ``device`` overrides the
    config's device."""
    sm: dict[str, Any] = {"backend": "torch_cuda"}
    if "fdr" in sm_dict:
        sm["fdr"] = dict(sm_dict["fdr"])
    par = {k: v for k, v in sm_dict.get("parallel", {}).items()
           if k in _PARALLEL_KEYS}
    if par:
        sm["parallel"] = par
    if device is not None:
        sm["device"] = device
    elif "device" in sm_dict:
        sm["device"] = sm_dict["device"]
    return SMConfig.from_dict(sm), DSConfig.from_dict(ds_dict)
