"""The four public members the surface census found missing from the port,
held to the JAX package's on the same inputs: ``SpectralDataset.get_dims``
and ``norm_img_pixel_inds`` on the fixtures of ``tests/test_io.py``,
``CancelToken.remaining_s`` within the JAX test's bounds, and the legacy
replace-all ``set_phase_observer`` beside ``add_phase_observer`` and
``remove_phase_observer``."""

from __future__ import annotations

import time

import numpy as np
import pytest

import sm_distributed_tpu.io.dataset as jdataset
import sm_distributed_tpu.io.fixtures as jfixtures
import sm_distributed_tpu.utils.cancel as jcancel
import sm_distributed_tpu.utils.logger as jlogger
import sm_distributed_tpu_torch.io.dataset as tdataset
import sm_distributed_tpu_torch.utils.cancel as tcancel
import sm_distributed_tpu_torch.utils.logger as tlogger

LOGGERS = {"jax": jlogger, "torch": tlogger}


def _pixel_grid_inputs():
    """``tests/test_io.py::test_dataset_pixel_grid``'s spectra: scattered
    coordinates with an offset and a missing pixel."""
    coords = np.array([[10, 5], [11, 5], [12, 5], [10, 6], [11, 6], [10, 7],
                       [12, 7]])
    spectra = [
        (np.array([100.0, 200.0]), np.array([1.0, 2.0])),
        (np.array([150.0]), np.array([3.0])),
        (np.array([], dtype=float), np.array([], dtype=float)),
        (np.array([120.0, 130.0, 140.0]), np.array([1.0, 1.0, 1.0])),
        (np.array([100.0]), np.array([5.0])),
        (np.array([300.0]), np.array([7.0])),
        (np.array([400.0]), np.array([8.0])),
    ]
    return coords, spectra


def test_dims_and_pixel_inds_from_arrays():
    coords, spectra = _pixel_grid_inputs()
    jds = jdataset.SpectralDataset.from_arrays(coords, spectra)
    tds = tdataset.SpectralDataset.from_arrays(coords, spectra)
    assert tds.get_dims() == jds.get_dims() == (3, 3)
    np.testing.assert_array_equal(tds.norm_img_pixel_inds(),
                                  jds.norm_img_pixel_inds())
    assert tds.norm_img_pixel_inds().dtype == jds.norm_img_pixel_inds().dtype


def test_dims_and_pixel_inds_from_imzml(tmp_path):
    """``tests/test_io.py::test_synthetic_dataset_end_to_end``'s 8x8 file,
    written once by the JAX fixture and read by both packages."""
    path, _truth = jfixtures.generate_synthetic_dataset(
        tmp_path, nrows=8, ncols=8,
        formulas=["C6H12O6", "C5H5N5", "C27H46O", "C3H4O3"],
        present_fraction=0.5, noise_peaks=30)
    jds = jdataset.SpectralDataset.from_imzml(path)
    tds = tdataset.SpectralDataset.from_imzml(path)
    assert tds.get_dims() == jds.get_dims() == (8, 8)
    np.testing.assert_array_equal(tds.norm_img_pixel_inds(),
                                  jds.norm_img_pixel_inds())


@pytest.mark.parametrize("mod", [jcancel, tcancel], ids=["jax", "torch"])
def test_remaining_s(mod):
    assert mod.CancelToken().remaining_s() is None
    t = mod.CancelToken(deadline_at=time.time() + 60.0)
    assert 59.0 < t.remaining_s() <= 60.0
    past = mod.CancelToken(deadline_at=time.time() - 1.0)
    assert past.remaining_s() < 0


@pytest.mark.parametrize("pkg", sorted(LOGGERS))
def test_set_phase_observer_replaces_all(pkg):
    logmod = LOGGERS[pkg]
    saved = list(logmod._phase_observers)
    seen_a, seen_b = [], []

    def obs_a(phase, dt):
        seen_a.append(phase)

    def obs_b(phase, dt):
        seen_b.append(phase)

    try:
        logmod.add_phase_observer(obs_a)
        logmod.add_phase_observer(obs_b)
        logmod.set_phase_observer(obs_a)
        assert logmod._phase_observers == [obs_a]
        with logmod.phase_timer("p1"):
            pass
        assert seen_a == ["p1"] and seen_b == []
        logmod.remove_phase_observer(obs_a)
        logmod.set_phase_observer(None)
        assert logmod._phase_observers == []
    finally:
        logmod.set_phase_observer(None)
        for fn in saved:
            logmod.add_phase_observer(fn)
    assert logmod._phase_observers == saved
