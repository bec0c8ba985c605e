"""The port's device isotope-pattern stage on the CPU, against the JAX
package's (``JAX_PLATFORMS=cpu``) and the NumPy oracle.

- ``fine_structure_segments`` bit-equal to the JAX function over 60
  formulas x (+H, +Na, +K), at the shipped parameters and at 12,000 points
  per m/z, where 40 of the 180 ions are too wide for the stage (None);
- ``blur_centroid`` on ``device="cpu"`` against the JAX ``_kernel`` on the
  same packed blocks of a small bucket and of a bucket past 64 states:
  ``v``, ``y0``-``y2`` and ``fb`` within 128 ulp (the JAX package's
  declared ulp(128) contract), ``li`` and ``gm`` equal; a constructed tie
  (two equal maxima) picks the lower grid index, as ``jax.lax.top_k`` does;
- ``DeviceBlurCentroid.centroid_batch`` and device-mode tables against the
  JAX package's and against the oracle: ``n_valid`` equal, ``|dm/z| <
  5e-6`` and ``|dint| < 1e-3`` (``tests/test_isocalc_parallel.py``'s
  bounds);
- the ``dev<key>`` cache namespace read across the two packages in both
  directions (each package writes its own dir: a shared dir would hand the
  second package the first one's patterns), serial and pooled device-mode
  generation writing identical shard bytes, and a device-mode pool worker
  that never imports torch;
- the search: ``_fingerprint_pairs`` equal to the JAX package's with the
  flag on and off, an ``isocalc_device="on"`` search on the CPU within the
  port's search contracts of the JAX package's device-mode search, and
  ``isocalc_device="on"`` with ``device="cuda"`` raising without a card
  (no fallback to the host oracle).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sm_distributed_tpu.ops.isocalc as jiso
import sm_distributed_tpu.ops.isocalc_jax as jdev
import sm_distributed_tpu_torch.ops.isocalc as tiso
import sm_distributed_tpu_torch.ops.isocalc_torch as tdev
from sm_distributed_tpu.io.fixtures import expand_formula_list
from sm_distributed_tpu.utils.config import IsotopeGenerationConfig as JIso
from sm_distributed_tpu_torch.ops.formula import apply_adduct, parse_formula
from sm_distributed_tpu_torch.utils.config import IsotopeGenerationConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = Path(__file__).resolve().parents[1]
ADDUCTS = ("+H", "+Na", "+K")
CFG = IsotopeGenerationConfig(adducts=("+H",))
JCFG = JIso(adducts=("+H",))
ULPS = 128
MZ_TOL, INT_TOL = 5e-6, 1e-3


def _params(cfg=CFG):
    return (cfg.charge, cfg.isocalc_sigma, cfg.isocalc_pts_per_mz,
            cfg.n_peaks)


def _counts(sf, adduct):
    return apply_adduct(parse_formula(sf), adduct)


def _pairs(n, adducts=("+H", "+Na")):
    return [(sf, a) for sf in expand_formula_list(n) for a in adducts]


def _within_ulps(a, b, n=ULPS) -> bool:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    scale = np.maximum(np.abs(a), np.abs(b))
    return bool(np.all(np.abs(a.astype(np.float64) - b)
                       <= n * np.spacing(scale).astype(np.float64)))


def _assert_tables_close(got, want) -> None:
    assert got.sfs == want.sfs and got.adducts == want.adducts
    np.testing.assert_array_equal(got.n_valid, want.n_valid)
    assert np.abs(got.mzs - want.mzs).max() < MZ_TOL
    assert np.abs(got.ints - want.ints).max() < INT_TOL


# ------------------------------------------------------------ host segments
@pytest.mark.parametrize("pts_per_mz", [10000, 12000])
def test_fine_structure_segments_bit_equal(pts_per_mz):
    cfg = IsotopeGenerationConfig(isocalc_pts_per_mz=pts_per_mz)
    n_none = 0
    for sf in expand_formula_list(60):
        for adduct in ADDUCTS:
            counts = _counts(sf, adduct)
            got = tiso.fine_structure_segments(counts, *_params(cfg))
            want = jiso.fine_structure_segments(counts, *_params(cfg))
            if want is None:
                assert got is None
                n_none += 1
                continue
            assert len(got) == len(want)
            for (lo, m, a, n), (wlo, wm, wa, wn) in zip(got, want):
                assert lo == wlo and n == wn
                assert m.tobytes() == wm.tobytes()
                assert a.tobytes() == wa.tobytes()
    # the second grid sends some ions to the host oracle
    assert (n_none > 0) == (pts_per_mz == 12000)
    assert tiso.SEGMENT_GRID_CAP == jiso.SEGMENT_GRID_CAP


# ---------------------------------------------------------- the device math
def _packed_block(segs, sc, lc):
    """The packed (m_rel, ab, seg_len) block of ``segs`` in one (state,
    grid) bucket, as ``centroid_batch`` packs it."""
    b = max(16, tdev._BLOCK_ROWS // sc)
    chosen = [s for s in segs
              if tdev._state_bucket(s[1].size) == sc
              and tdev._grid_bucket(s[3]) == lc][:b]
    assert chosen, (sc, lc)
    m_rel = np.full((b, sc), 1e6, np.float32)
    ab = np.zeros((b, sc), np.float32)
    ln = np.zeros(b, np.int32)
    for bi, (_lo, m, a, npts) in enumerate(chosen):
        m_rel[bi, : m.size] = m
        ab[bi, : a.size] = a
        ln[bi] = npts
    return m_rel, ab, ln, len(chosen)


@pytest.fixture(scope="module")
def all_segments():
    out = []
    for sf in expand_formula_list(60):
        for adduct in ADDUCTS:
            out.extend(tiso.fine_structure_segments(_counts(sf, adduct),
                                                    *_params()))
    return out


def _device_kw():
    sigma = CFG.isocalc_sigma
    step = 1.0 / CFG.isocalc_pts_per_mz
    return dict(k=CFG.n_peaks, step=step, sigma=sigma, pad=5.0 * sigma)


@pytest.mark.parametrize("sc", [12, 128])
def test_blur_centroid_matches_jax_kernel(all_segments, sc):
    lc = 1152 if sc == 12 else tiso.SEGMENT_GRID_CAP
    m_rel, ab, ln, n = _packed_block(all_segments, sc, lc)
    kw = _device_kw()
    want = jdev._kernel(lc, sc, m_rel.shape[0], kw["k"], kw["step"],
                        kw["sigma"], kw["pad"])(m_rel, ab, ln)
    want = [np.asarray(w) for w in want]
    got = tdev.blur_centroid(*(torch.from_numpy(x) for x in (m_rel, ab, ln)),
                             lc=lc, **kw)
    got = [g.numpy() for g in got]
    names = ("v", "li", "y0", "y1", "y2", "gm", "fb")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in ("li", "gm"):
            np.testing.assert_array_equal(g[:n], w[:n], err_msg=name)
        else:
            assert _within_ulps(g[:n], w[:n]), name
    # the padded rows too: no maxima, the same fallback
    np.testing.assert_array_equal(got[1], want[1])


def test_tie_goes_to_the_lower_index():
    """Two states exactly on grid points, farther apart than the blur's
    window, give two equal maxima (the blur's exp(0) at each); the top 1 is
    the lower one, as with jax.lax.top_k, and the top 2 come in index
    order."""
    kw = _device_kw()
    lc, sc = 1152, 4
    stepf = np.float32(kw["step"])
    g = np.arange(lc, dtype=np.float32) * stepf
    m_rel = np.full((16, sc), 1e6, np.float32)
    ab = np.zeros((16, sc), np.float32)
    ln = np.full(16, lc, np.int32)
    m_rel[0, :2] = g[[60, 1090]]
    ab[0, :2] = 0.5
    for k in (1, 2):
        kw_k = dict(kw, k=k)
        got = tdev.blur_centroid(
            *(torch.from_numpy(x) for x in (m_rel, ab, ln)), lc=lc, **kw_k)
        want = jdev._kernel(lc, sc, 16, k, kw["step"], kw["sigma"],
                            kw["pad"])(m_rel, ab, ln)
        assert got[0][0, 0].item() == got[0][0, k - 1].item() == 0.5
        np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1][0]))
        assert got[1][0].tolist() == [60, 1090][:k]


def test_centroid_batch_matches_jax_and_the_oracle():
    pairs = [(sf, a) for sf in expand_formula_list(24) for a in ADDUCTS]
    seg_lists = [tiso.fine_structure_segments(_counts(sf, a), *_params())
                 for sf, a in pairs]
    got = tdev.DeviceBlurCentroid(*_params(), device="cpu").centroid_batch(
        seg_lists)
    want = jdev.DeviceBlurCentroid(*_params()).centroid_batch(seg_lists)
    for (sf, a), (gm, gi), (wm, wi) in zip(pairs, got, want):
        om, oi = tiso.centroids(_counts(sf, a), *_params())
        assert gm.size == wm.size == om.size, (sf, a)
        assert np.abs(gm - wm).max() < MZ_TOL and np.abs(gi - wi).max() < INT_TOL
        assert np.abs(gm - om).max() < MZ_TOL and np.abs(gi - oi).max() < INT_TOL


def test_device_table_with_heavy_ions_matches_the_oracle():
    """At 12,000 points per m/z some ions are too wide for the stage: they
    take the oracle inside the same table, the rest the stage."""
    cfg = IsotopeGenerationConfig(isocalc_pts_per_mz=12000)
    pairs = _pairs(20, ADDUCTS)
    heavy = sum(tiso.fine_structure_segments(_counts(sf, a), *_params(cfg))
                is None for sf, a in pairs)
    assert 0 < heavy < len(pairs)
    oracle = tiso.IsocalcWrapper(cfg, n_procs=1).pattern_table(pairs)
    w = tiso.IsocalcWrapper(cfg, n_procs=1, device_blur=True, device="cpu")
    _assert_tables_close(w.pattern_table(pairs), oracle)
    assert w._device.stats["segments"] > 0


# --------------------------------------------------------------- the cache
def test_device_table_cross_reads_both_ways(tmp_path):
    """Device-mode tables of the two packages agree with the oracle and
    each other; each package warm-loads the other's ``dev`` shards, and an
    oracle-mode wrapper over either dir loads none of them."""
    pairs = _pairs(10)
    oracle = tiso.IsocalcWrapper(CFG, n_procs=1).pattern_table(pairs)
    d_port, d_jax = tmp_path / "port", tmp_path / "jax"
    port = tiso.IsocalcWrapper(CFG, cache_dir=d_port, n_procs=1,
                               device_blur=True, device="cpu")
    t_port = port.pattern_table(pairs)
    t_jax = jiso.IsocalcWrapper(JCFG, cache_dir=d_jax, n_procs=1,
                                device_blur=True).pattern_table(pairs)
    _assert_tables_close(t_port, oracle)
    _assert_tables_close(t_port, t_jax)
    assert port.last_stats["device"] is True
    assert port._param_key() == jiso.IsocalcWrapper(
        JCFG, device_blur=True)._param_key()
    assert port._param_key().startswith("dev")
    for d in (d_port, d_jax):
        assert all(p.name.startswith(f"theor_peaks_{port._param_key()}")
                   for p in d.glob("theor_peaks_*"))
        assert tiso.IsocalcWrapper(CFG, cache_dir=d)._cache == {}
        assert jiso.IsocalcWrapper(JCFG, cache_dir=d)._cache == {}
    jax_reads = jiso.IsocalcWrapper(JCFG, cache_dir=d_port, device_blur=True)
    port_reads = tiso.IsocalcWrapper(CFG, cache_dir=d_jax, device_blur=True,
                                     device="cpu")
    assert len(jax_reads._cache) == len(port_reads._cache) == t_port.n_ions
    for ion, (m, i) in port._cache.items():
        np.testing.assert_array_equal(jax_reads._cache[ion][0], m)
        np.testing.assert_array_equal(jax_reads._cache[ion][1], i)


def test_env_opt_in_and_single_ion_path(tmp_path, monkeypatch):
    monkeypatch.setenv("SM_ISOCALC_DEVICE", "1")
    w = tiso.IsocalcWrapper(CFG, cache_dir=tmp_path, device="cpu")
    assert w.device_blur and w._param_key().startswith("dev")
    mzs, ints = w.isotope_peaks("C6H12O6", "+H")
    om, oi = tiso.centroids(_counts("C6H12O6", "+H"), *_params())
    assert mzs.size == om.size and np.abs(mzs - om).max() < MZ_TOL
    assert np.abs(ints - oi).max() < INT_TOL
    w.save_cache()
    monkeypatch.setenv("SM_ISOCALC_DEVICE", "0")
    assert not tiso.IsocalcWrapper(CFG, cache_dir=tmp_path).device_blur
    assert tiso.IsocalcWrapper(CFG, cache_dir=tmp_path)._cache == {}
    assert tiso.IsocalcWrapper(CFG, cache_dir=tmp_path, device_blur=True,
                               device="cpu")._cache


def test_serial_and_pool_write_identical_device_shard_bytes(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(tiso, "_PARALLEL_THRESHOLD", 8)
    pairs = _pairs(12)
    d_ser, d_par = tmp_path / "ser", tmp_path / "par"
    ser = tiso.IsocalcWrapper(CFG, cache_dir=d_ser, n_procs=1, chunk_size=8,
                              device_blur=True, device="cpu")
    t_ser = ser.pattern_table(pairs)
    par = tiso.IsocalcWrapper(CFG, cache_dir=d_par, n_procs=2, chunk_size=8,
                              device_blur=True, device="cpu")
    t_par = par.pattern_table(pairs)
    assert par.last_stats["workers"] == 2
    assert t_ser.sfs == t_par.sfs
    np.testing.assert_array_equal(t_ser.mzs, t_par.mzs)
    np.testing.assert_array_equal(t_ser.ints, t_par.ints)
    s_names = sorted(p.name for p in d_ser.glob("theor_peaks_dev*"))
    p_names = sorted(p.name for p in d_par.glob("theor_peaks_dev*"))
    assert s_names == p_names and len(s_names) >= 2
    for name in s_names:
        assert (d_ser / name).read_bytes() == (d_par / name).read_bytes()


def test_device_mode_worker_imports_no_torch():
    """A pool worker's chunk in device mode returns segments without
    importing torch (a worker that did would pay the import and could make
    a CUDA context on the card)."""
    code = (
        "import sys\n"
        "from sm_distributed_tpu_torch.ops.isocalc import _compute_chunk\n"
        "ci, out, rec = _compute_chunk((0, [('C6H12O6', '+H'), "
        "('C5H9NO4', '+Na')], (1, 0.01, 10000, 4), True, None))\n"
        "assert [o[0] for o in out] == ['seg', 'seg'], out\n"
        "print('torch' in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False"


# -------------------------------------------------------------- the search
@pytest.fixture(scope="module")
def small(tmp_path_factory):
    from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
    from sm_distributed_tpu.io.fixtures import (
        FIXTURE_FORMULAS,
        generate_synthetic_dataset,
    )
    from sm_distributed_tpu_torch.convert import dataset_from_arrays

    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("ds"), nrows=12, ncols=12,
        formulas=FIXTURE_FORMULAS[:8], present_fraction=0.6, noise_peaks=40,
        mz_jitter_ppm=0.5, seed=7)
    jds = JDataset.from_imzml(path)
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    return jds, tds, truth


DS_DICT = {"isotope_generation": {"adducts": ["+H"]},
           "image_generation": {"ppm": 3.0}}


@pytest.mark.parametrize("device_mode", ["on", "off"])
def test_fingerprint_pairs_equal_jax(small, device_mode):
    from sm_distributed_tpu.models.msm_basic import MSMBasicSearch as JSearch
    from sm_distributed_tpu.utils.config import DSConfig as JDC
    from sm_distributed_tpu.utils.config import SMConfig as JSC
    from sm_distributed_tpu_torch.convert import pattern_table_from_arrays
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    jds, tds, truth = small
    par = {"formula_batch": 6, "checkpoint_every": 2,
           "isocalc_device": device_mode}
    jsearch = JSearch(jds, truth.formulas, JDC.from_dict(DS_DICT),
                      JSC.from_dict({"backend": "numpy_ref",
                                     "parallel": par}))
    tsearch = MSMBasicSearch(tds, truth.formulas, DSConfig.from_dict(DS_DICT),
                             SMConfig.from_dict({"backend": "numpy_ref",
                                                 "device": "cpu",
                                                 "parallel": par}))
    assert tsearch.isocalc.device_blur is (device_mode == "on")
    assert jsearch.isocalc.device_blur is tsearch.isocalc.device_blur
    assert tsearch.isocalc.device == "cpu"
    jt = jiso.IsocalcWrapper(JCFG).pattern_table(
        [(sf, "+H") for sf in truth.formulas])
    tt = pattern_table_from_arrays(jt.sfs, jt.adducts, jt.mzs, jt.ints,
                                   jt.n_valid, jt.targets)
    assert tsearch._fingerprint_pairs(tt) == jsearch._fingerprint_pairs(jt)


def test_device_mode_search_matches_jax_device_mode(small):
    """The port's ``torch_cuda`` search on the CPU with
    ``isocalc_device="on"`` against the JAX package's device-mode numpy_ref
    search (f64 metrics from its own device patterns): the same
    annotations in the same order with identical ``fdr`` and
    ``fdr_level``, metrics within the ulp contracts (chaos 0, spatial 16,
    spectral 16, msm 32)."""
    from sm_distributed_tpu.analysis.numerics import ulp_distance
    from sm_distributed_tpu.models.msm_basic import MSMBasicSearch as JSearch
    from sm_distributed_tpu.utils.config import DSConfig as JDC
    from sm_distributed_tpu.utils.config import SMConfig as JSC
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    jds, tds, truth = small
    sm = {"fdr": {"decoy_sample_size": 8, "seed": 42},
          "parallel": {"formula_batch": 32, "isocalc_device": "on"}}
    want = JSearch(jds, truth.formulas, JDC.from_dict(DS_DICT),
                   JSC.from_dict({**sm, "backend": "numpy_ref"})).search()
    search = MSMBasicSearch(tds, truth.formulas, DSConfig.from_dict(DS_DICT),
                            SMConfig.from_dict({**sm, "device": "cpu"}))
    got = search.search()
    assert search.isocalc._device.stats["segments"] > 0
    ga, wa = got.annotations, want.annotations
    assert list(zip(ga.sf, ga.adduct)) == list(zip(wa.sf, wa.adduct))
    np.testing.assert_array_equal(ga.fdr.to_numpy(), wa.fdr.to_numpy())
    np.testing.assert_array_equal(ga.fdr_level.to_numpy(),
                                  wa.fdr_level.to_numpy())
    gm = got.all_metrics.set_index(["sf", "adduct"]).sort_index()
    wm = want.all_metrics.set_index(["sf", "adduct"]).sort_index()
    assert gm.index.equals(wm.index)
    for col, ulps in {"chaos": 0, "spatial": 16, "spectral": 16,
                      "msm": 32}.items():
        assert (ulp_distance(gm[col].to_numpy(), wm[col].to_numpy())
                <= ulps).all(), col


def test_device_mode_on_a_missing_card_raises(small):
    """``device="cuda"`` without a card: the stage raises (the search never
    carries on with the host oracle), even on the host backend."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    _jds, tds, truth = small
    sm = SMConfig.from_dict({"backend": "numpy_ref", "device": "cuda",
                             "parallel": {"isocalc_device": "on"}})
    search = MSMBasicSearch(tds, truth.formulas, DSConfig.from_dict(DS_DICT),
                            sm)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        search.search()
    w = tiso.IsocalcWrapper(CFG, device_blur=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w.pattern_table(_pairs(2))
