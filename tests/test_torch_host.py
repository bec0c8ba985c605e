"""Host-side parity of the PyTorch port with the JAX package.

Array equality on two fixtures: the 9x11 off-lattice dataset (9 rows bucket
to 10, peaks under the 4096-slot floor) and the 32x32 golden spheroid.
Covered: the imzML reader (each package reading the other's fixture files),
the fixture's spectra, ``intensity_quantization``, ``quantize_window``, the
bucket ladder, the flat-path planners, ``IsocalcWrapper.pattern_table``, and
FDR decoy selection and ``estimate_fdr`` on fixed metrics.  All host math is
copied, so every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset as jgen
from sm_distributed_tpu_torch.io.dataset import SpectralDataset as TDataset
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset as tgen

FIXTURES = {
    "offgrid9x11": dict(nrows=9, ncols=11, formulas=None,
                        present_fraction=0.5, noise_peaks=12, seed=41),
    "spheroid32": dict(nrows=32, ncols=32, formulas=None,
                       present_fraction=0.6, noise_peaks=200,
                       mz_jitter_ppm=0.5, seed=7),
}
_DS_FIELDS = ("pixel_inds", "mask", "mzs_flat", "ints_flat", "row_ptr")


@pytest.fixture(scope="module", params=list(FIXTURES))
def pair(request, tmp_path_factory):
    """(jax path, torch path, jax dataset, truth) for one fixture recipe,
    written once by each package."""
    base = tmp_path_factory.mktemp(request.param)
    jpath, truth = jgen(base / "jax", **FIXTURES[request.param])
    tpath, ttruth = tgen(base / "torch", **FIXTURES[request.param])
    assert list(ttruth.present) == list(truth.present)
    return jpath, tpath, JDataset.from_imzml(jpath), truth


def _assert_ds_equal(a, b):
    assert (a.nrows, a.ncols) == (b.nrows, b.ncols)
    for f in _DS_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_port_reader_reads_jax_fixture(pair):
    jpath, _tpath, jds, _ = pair
    _assert_ds_equal(TDataset.from_imzml(jpath), jds)


def test_jax_reader_reads_port_fixture(pair):
    """The port writes the same spectra (only the file UUID differs)."""
    _jpath, tpath, jds, _ = pair
    _assert_ds_equal(JDataset.from_imzml(tpath), jds)


def test_port_reader_reads_port_fixture(pair):
    _jpath, tpath, jds, _ = pair
    _assert_ds_equal(TDataset.from_imzml(tpath), jds)


@pytest.mark.parametrize("ppm", [3.0, 5.0])
def test_intensity_quantization(pair, ppm):
    jpath, _tpath, jds, _ = pair
    tds = TDataset.from_imzml(jpath)
    jq, js = jds.intensity_quantization(ppm)
    tq, ts = tds.intensity_quantization(ppm)
    assert js == ts
    np.testing.assert_array_equal(jq, tq)


def _table_pair(truth, adducts=("+H", "+Na")):
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper as JIso
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig as JIG
    from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper as TIso
    from sm_distributed_tpu_torch.utils.config import (
        IsotopeGenerationConfig as TIG,
    )

    pairs = [(sf, ad) for sf in truth.formulas for ad in adducts]
    pairs += [("C6H12O6", "+H"), ("H2", "-H2")]     # duplicate + invalid
    flags = [i % 3 != 0 for i in range(len(pairs))]
    jt = JIso(JIG(adducts=adducts), n_procs=1).pattern_table(pairs, flags)
    tt = TIso(TIG(adducts=adducts), n_procs=1).pattern_table(pairs, flags)
    return jt, tt


def test_pattern_table(pair):
    jt, tt = _table_pair(pair[3])
    assert tt.sfs == jt.sfs and tt.adducts == jt.adducts
    for f in ("mzs", "ints", "n_valid", "targets"):
        np.testing.assert_array_equal(getattr(tt, f), getattr(jt, f),
                                      err_msg=f)


@pytest.mark.parametrize("ppm", [1.0, 3.0, 7.5])
def test_quantize_window(pair, ppm):
    from sm_distributed_tpu.ops.quantize import quantize_window as jq
    from sm_distributed_tpu_torch.ops.quantize import quantize_window as tq

    jt, _ = _table_pair(pair[3])
    for a, b in zip(jq(jt.mzs, ppm), tq(jt.mzs, ppm)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["pow2ish", "pow2ish_down", "peak_bucket",
                                "row_bucket", "batch_bucket_down"])
def test_bucket_ladder(fn):
    from sm_distributed_tpu.ops import buckets as jb
    from sm_distributed_tpu_torch.ops import buckets as tb

    for n in list(range(1, 3000)) + [4095, 4096, 4097, 65536, 123457, 10**7]:
        assert getattr(tb, fn)(n) == getattr(jb, fn)(n), (fn, n)


@pytest.mark.parametrize("buckets", ["auto", "off"])
@pytest.mark.parametrize("batch", [2048, 300, 16])
def test_effective_batch(buckets, batch):
    from sm_distributed_tpu.ops.buckets import effective_batch as je
    from sm_distributed_tpu.utils.config import SMConfig as JSM
    from sm_distributed_tpu_torch.ops.buckets import effective_batch as te
    from sm_distributed_tpu_torch.utils.config import SMConfig as TSM

    par = {"formula_batch": batch, "shape_buckets": buckets}
    j = JSM.from_dict({"parallel": par}).parallel
    t = TSM.from_dict({"parallel": par}).parallel
    assert te(t) == je(j)


def _windows(table, ppm=3.0, b=None):
    from sm_distributed_tpu_torch.ops.quantize import quantize_window

    lo, hi = quantize_window(table.mzs, ppm)
    b = b or table.n_ions
    k = table.max_peaks
    lo_p = np.zeros((b, k), np.int32)
    hi_p = np.zeros((b, k), np.int32)
    lo_p[:table.n_ions], hi_p[:table.n_ions] = lo, hi
    return lo, hi, lo_p, hi_p


@pytest.mark.parametrize("b_pad", [0, 64])
def test_planners(pair, b_pad):
    """window_rank_grid, prepare_flat_sorted_arrays, flat_bound_ranks,
    merged_window_bounds, restrict_flat_to_windows, gc_ladder,
    ions_per_chunk_for and ion_window_chunks: array-equal."""
    import sm_distributed_tpu.ops.imager_jax as J
    import sm_distributed_tpu_torch.ops.imager as T

    jpath, _tpath, jds, truth = pair
    tds = TDataset.from_imzml(jpath)
    jt, _ = _table_pair(truth)
    b = max(b_pad, jt.n_ions)
    lo, hi, lo_p, hi_p = _windows(jt, b=b)
    jg, tg = J.window_rank_grid(lo_p, hi_p), T.window_rank_grid(lo_p, hi_p)
    for a, c in zip(jg, tg):
        np.testing.assert_array_equal(a, c)
    jf = J.prepare_flat_sorted_arrays(jds, 3.0)
    tf = T.prepare_flat_sorted_arrays(tds, 3.0)
    for a, c in zip(jf, tf):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a, c)
    jsh = J.prepare_flat_sharded_arrays(jds, 3.0, n_shards=1)
    tsh = T.prepare_flat_sharded_arrays(tds, 3.0, n_shards=1)
    for a, c in zip(jsh, tsh):
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(J.flat_bound_ranks(jf[0], jg[0]),
                                  T.flat_bound_ranks(tf[0], tg[0]))
    np.testing.assert_array_equal(J.merged_window_bounds(lo, hi),
                                  T.merged_window_bounds(lo, hi))
    jr = J.restrict_flat_to_windows(jf[0][None], jf[1][None], jf[2][None],
                                    lo, hi, overflow_row=jds.n_pixels)
    tr = T.restrict_flat_to_windows(tf[0][None], tf[1][None], tf[2][None],
                                    lo, hi, overflow_row=tds.n_pixels)
    for a, c in zip(jr[:3], tr[:3]):
        np.testing.assert_array_equal(a, c)
    assert jr[3] == tr[3]
    k = jt.max_peaks
    for budget in (8, 64, 512):
        ipc = T.ions_per_chunk_for(b, k, budget)
        assert ipc == J.ions_per_chunk_for(b, k, budget)
        jc = J.ion_window_chunks(jg[1], jg[2], b, k, ipc)
        tc = T.ion_window_chunks(tg[1], tg[2], b, k, ipc)
        for a, c in zip(jc, tc):
            np.testing.assert_array_equal(a, c)
    for span in range(1, 5000, 7):
        assert T.gc_ladder(span) == J.gc_ladder(span)


def test_fdr_selection_and_estimate():
    from sm_distributed_tpu.ops.fdr import FDR as JFDR
    from sm_distributed_tpu_torch.ops.fdr import FDR as TFDR

    rng = np.random.default_rng(5)
    sfs = [f"C{i}H{2 * i}O{i % 5 + 1}" for i in range(1, 40)]
    adducts = ("+H", "+Na", "+K")
    jf = JFDR(decoy_sample_size=7, target_adducts=adducts, seed=42)
    tf = TFDR(decoy_sample_size=7, target_adducts=adducts, seed=42)
    ja, ta = jf.decoy_adduct_selection(sfs), tf.decoy_adduct_selection(sfs)
    assert ta.sample == ja.sample
    jp, jfl = ja.all_ion_tuples(sfs, adducts)
    tp, tfl = ta.all_ion_tuples(sfs, adducts)
    assert (tp, tfl) == (jp, jfl)
    msm = rng.random(len(jp)) * (rng.random(len(jp)) < 0.8)
    msm[::11] = msm[1]                       # exact ties
    df = pd.DataFrame({"sf": [p[0] for p in jp], "adduct": [p[1] for p in jp],
                       "msm": msm})
    pd.testing.assert_frame_equal(tf.estimate_fdr(df, ta),
                                  jf.estimate_fdr(df, ja))
