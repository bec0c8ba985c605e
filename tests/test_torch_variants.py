"""The flat path's extraction variants in the port against the JAX package.

``TorchBackend`` picks, for each batch, the plain variant (scatter every
resident peak), the band variant (scatter the contiguous rank band the
batch's window union spans) or the compact variant (gather the peaks inside
the union, then scatter), as ``JaxBackend`` does.  Held here on the CPU:

- the host plans ``batch_peak_band`` and ``batch_peak_runs`` equal to
  ``ops/imager_jax``'s on random cases, all-padding batches included, and
  the device gather ``compact_peaks`` equal to the first ``n_b`` slots of
  the JAX one (the port pads nothing);
- ``score_batches`` with ``band_slice`` and ``peak_compaction`` each "on",
  "off" and "auto", on an m/z-ordered and the unordered table, with and
  without the search's window-union restriction: every variant bit-equal
  to the port's plain variant (all four metrics, every ion), and to
  ``JaxBackend.score_batches`` under the component contracts — chaos
  bit-equal, spatial, spectral and msm within 16, 16 and 32 ulp of the
  oracle and within the contract plus the JAX backend's own distance from
  it (the two packages take their f32 reductions in different orders; see
  ``tests/test_torch_backend.py``) — with identical FDR ranks;
- ``variant_counts`` as the forced modes dictate, and the rule's choice at
  the card's rates;
- a port search with ``order_ions="mz"`` equal to ``"table"``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from sm_distributed_tpu.analysis.numerics import ulp_distance
from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.convert import (
    configs_from_dicts,
    dataset_from_arrays,
    pattern_table_from_arrays,
)

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}
BATCH = 8
DS_DICT = {"isotope_generation": {"adducts": ["+H"]},
           "image_generation": {"ppm": 3.0}}
MODES = ("on", "off", "auto")


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """The JAX package's variant fixture (``tests/test_jax_backend.py``):
    a 12x12 dataset and 15 formulas +H, here with 3 decoys each (60 ions,
    8 batches of 8), with the numpy oracle's metrics and the JAX backend's
    (plain variant, its own variants being bit-exact to it) for each
    (table order, restriction) case, and the FDR that ranks them."""
    from sm_distributed_tpu.models.msm_basic import (
        NumpyBackend,
        _slice_table,
        order_table_by_mz,
    )
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.ops.fdr import FDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import (
        DSConfig,
        IsotopeGenerationConfig,
        SMConfig,
    )

    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("variants"), nrows=12, ncols=12,
        formulas=None, present_fraction=0.5, noise_peaks=60, seed=23)
    jds = JDataset.from_imzml(path)
    calc = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H",)),
                          n_procs=1)
    fdr = FDR(decoy_sample_size=3, target_adducts=("+H",), seed=42)
    assignment = fdr.decoy_adduct_selection(truth.formulas[:15])
    pairs, flags = assignment.all_ion_tuples(truth.formulas[:15], ("+H",))
    table = calc.pattern_table(pairs, flags)
    ds_cfg = DSConfig.from_dict(DS_DICT)
    sm_cfg = SMConfig.from_dict(
        {"backend": "jax_tpu",
         "parallel": {"formula_batch": BATCH, "band_slice": "off",
                      "peak_compaction": "off", "compile_cache_dir": "off"}})
    cases = {}
    for order, t in (("mz", order_table_by_mz(table)), ("table", table)):
        batches = [_slice_table(t, s, min(s + BATCH, t.n_ions))
                   for s in range(0, t.n_ions, BATCH)]
        oracle = np.concatenate(NumpyBackend(jds, ds_cfg).score_batches(
            batches))
        for restrict in (False, True):
            jb = JaxBackend(jds, ds_cfg, sm_cfg,
                            restrict_table=t if restrict else None)
            want = np.concatenate(jb.score_batches(batches))
            cases[order, restrict] = (t, want, oracle)
    return jds, truth, cases, (fdr, assignment)


def _port(jds, t, parallel: dict, restrict: bool):
    """The port's backend on the CPU and ``t``'s batches, carried across."""
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    tt = pattern_table_from_arrays(t.sfs, t.adducts, t.mzs, t.ints,
                                   t.n_valid, t.targets)
    sm, dc = configs_from_dicts(
        {"parallel": {"formula_batch": BATCH, **parallel}}, DS_DICT,
        device="cpu")
    tb = TorchBackend(tds, dc, sm, restrict_table=tt if restrict else None)
    batches = [_slice_table(tt, s, min(s + BATCH, tt.n_ions))
               for s in range(0, tt.n_ions, BATCH)]
    return tb, batches


def _ranks(t, metrics, ranking):
    fdr, assignment = ranking
    df = pd.DataFrame({"sf": t.sfs, "adduct": t.adducts,
                       "msm": metrics[:, 3]})
    return fdr.estimate_fdr(df, assignment)


# ------------------------------------------------------------- host plans
def _random_case(rng):
    mz = np.sort(rng.integers(0, 10_000, size=300)).astype(np.int32)
    lo = rng.integers(0, 9_900, size=20).astype(np.int32)
    hi = lo + rng.integers(0, 60, size=20).astype(np.int32)
    # some all-padding windows (0, 0), as padded batch rows carry
    lo[rng.random(20) < 0.2] = 0
    hi[lo == 0] = 0
    return mz, lo, hi


@pytest.mark.parametrize("seed", range(4))
def test_batch_peak_band_matches_jax(seed):
    from sm_distributed_tpu.ops.imager_jax import batch_peak_band as jband
    from sm_distributed_tpu_torch.ops.imager import batch_peak_band

    rng = np.random.default_rng(seed)
    for _ in range(25):
        mz, lo, hi = _random_case(rng)
        assert batch_peak_band(mz, lo, hi) == jband(mz, lo, hi)
    # an all-padding batch has a zero-width band
    pad = np.zeros(3, np.int32)
    mz = np.arange(10, dtype=np.int32)
    assert batch_peak_band(mz, pad, pad) == jband(mz, pad, pad) == (0, 0)


@pytest.mark.parametrize("seed", range(4))
def test_batch_peak_runs_matches_jax(seed):
    from sm_distributed_tpu.ops.imager_jax import batch_peak_runs as jruns
    from sm_distributed_tpu.ops.imager_jax import flat_bound_ranks
    from sm_distributed_tpu_torch.ops.imager import batch_peak_runs

    rng = np.random.default_rng(100 + seed)
    cases = [_random_case(rng) for _ in range(25)]
    pad = np.zeros(4, np.int32)
    cases.append((np.arange(10, dtype=np.int32), pad, pad))
    for mz, lo, hi in cases:
        grid = np.sort(np.concatenate([lo, hi]))
        pos = flat_bound_ranks(mz, grid)
        got, want = batch_peak_runs(mz, lo, hi, pos), jruns(mz, lo, hi, pos)
        assert got[2] == want[2]
        for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_compact_peaks_matches_jax(seed):
    """The port gathers exactly ``n_b`` slots; they equal the first ``n_b``
    of the JAX package's padded gather (its pad slots point out of range
    and carry 0)."""
    from sm_distributed_tpu.ops.imager_jax import compact_peaks as jcompact
    from sm_distributed_tpu.ops.imager_jax import flat_bound_ranks
    from sm_distributed_tpu_torch.ops.imager import (
        batch_peak_runs,
        compact_peaks,
    )

    rng = np.random.default_rng(200 + seed)
    for _ in range(10):
        mz, lo, hi = _random_case(rng)
        px = rng.integers(0, 144, mz.size).astype(np.int32)
        ints = rng.integers(1, 1000, mz.size).astype(np.float32)
        pos = flat_bound_ranks(mz, np.sort(np.concatenate([lo, hi])))
        run_pos, run_delta, n_b, _pos_b = batch_peak_runs(mz, lo, hi, pos)
        n_keep = max(n_b, 1) + 7
        r_pad = run_pos.size + 3
        rp = np.full(r_pad, n_keep, np.int32)
        rp[:run_pos.size] = run_pos
        rd = np.zeros(r_pad, np.int32)
        rd[:run_delta.size] = run_delta
        jpx, jin = (np.asarray(a) for a in jcompact(
            px, ints, rp, rd, np.int32(n_b), n_keep=n_keep, n_pixels=144))
        tpx, tin = compact_peaks(
            torch.from_numpy(px.astype(np.int64)), torch.from_numpy(ints),
            torch.from_numpy(run_pos.astype(np.int64)),
            torch.from_numpy(run_delta.astype(np.int64)), n_b)
        assert tpx.shape == tin.shape == (n_b,)
        np.testing.assert_array_equal(tpx.numpy(), jpx[:n_b])
        np.testing.assert_array_equal(tin.numpy(), jin[:n_b])
        # the kept slots are exactly the peaks inside the window union
        member = np.zeros(mz.size, bool)
        for a, b in zip(lo, hi):
            member |= (mz >= a) & (mz < b)
        np.testing.assert_array_equal(tin.numpy(), ints[member])


# ---------------------------------------------------------- score_batches
@pytest.mark.parametrize("restrict", [False, True],
                         ids=["full", "restricted"])
@pytest.mark.parametrize("order", ["mz", "table"])
@pytest.mark.parametrize("compaction", MODES)
@pytest.mark.parametrize("band", MODES)
def test_variants_match_plain_and_jax(stream, band, compaction, order,
                                      restrict):
    jds, _truth, cases, ranking = stream
    t, want, oracle = cases[order, restrict]
    tb, batches = _port(jds, t, {"band_slice": band,
                                 "peak_compaction": compaction}, restrict)
    got = np.concatenate(tb.score_batches(batches))
    plain_tb, _ = _port(jds, t, {"band_slice": "off",
                                 "peak_compaction": "off"}, restrict)
    plain = np.concatenate(plain_tb.score_batches(batches))
    assert plain_tb.variant_counts["plain"] == len(batches)
    # every variant gives the plain variant's bits
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for col, comp in enumerate(CONTRACT):
        assert ulp_distance(got[:, col], oracle[:, col]).max() \
            <= CONTRACT[comp], comp
        jax_to_oracle = ulp_distance(want[:, col], oracle[:, col])
        assert (ulp_distance(got[:, col], want[:, col])
                <= CONTRACT[comp] + jax_to_oracle).all(), comp
    pd.testing.assert_frame_equal(_ranks(t, got, ranking),
                                  _ranks(t, want, ranking))
    assert (got[:, 3] > 0).any()
    counts = tb.variant_counts
    assert sum(counts.values()) == len(batches) and counts["fused"] == 0
    if band == "on":
        assert counts["band"] == len(batches)
    elif compaction == "on":
        assert counts["compact"] == len(batches)
    elif band == compaction == "off":
        assert counts["plain"] == len(batches)
    if band == "off":
        assert counts["band"] == 0
    if compaction == "off":
        assert counts["compact"] == 0


@pytest.mark.parametrize("band,compaction", [
    ("on", "on"), ("auto", "auto"), ("off", "off")])
def test_fused_on_takes_the_fused_kernel_whatever_the_rule(stream, band,
                                                           compaction):
    """``fused_metrics="on"`` scores every batch with the fused kernel over
    the full histogram, whatever variant the rule picks (the JAX package's
    precedence); the results are the plain chain's within the contracts."""
    jds, _truth, cases, ranking = stream
    t, want, oracle = cases["mz", True]
    tb, batches = _port(jds, t, {"band_slice": band,
                                 "peak_compaction": compaction,
                                 "fused_metrics": "on"}, True)
    got = np.concatenate(tb.score_batches(batches))
    assert tb.variant_counts == {"plain": 0, "band": 0, "compact": 0,
                                 "fused": len(batches)}
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for col, comp in enumerate(CONTRACT):
        assert ulp_distance(got[:, col], oracle[:, col]).max() \
            <= CONTRACT[comp], comp


def test_rule_picks_the_cheapest_variant_at_the_card_rates(stream):
    """Auto mode: the least of plain (every resident slot scattered), band
    (its exact width scattered) and compact (its exact kept count gathered
    and scattered), at the card's rates; "on" forces, band first; a band
    as wide as the resident peaks is never taken."""
    from sm_distributed_tpu_torch.models import msm_torch

    jds, _truth, cases, ranking = stream
    t = cases["mz", False][0]
    tb, _ = _port(jds, t, {}, False)
    n = tb._mz_host.size
    s, c = msm_torch.SCATTER_NS_PER_SLOT, msm_torch.COMPACT_NS_PER_SLOT
    assert 0 < s < c

    def runs(n_b):
        return (None, None, n_b, None)

    assert tb._variant_for(runs(n), (0, n)) == "plain"
    assert tb._variant_for(runs(n // 100), (0, n)) == "compact"
    narrow = int(n * s / c) // 2
    assert tb._variant_for(runs(narrow), (0, narrow)) == "band"
    assert tb._variant_for(runs(n), (5, n // 2)) == "band"
    assert tb._variant_for(None, None) == "plain"
    tb._band_mode = "on"
    assert tb._variant_for(runs(1), (0, n)) == "band"
    tb._band_mode, tb._compaction = "off", "on"
    assert tb._variant_for(runs(n), (0, 1)) == "compact"


def test_forced_variant_without_its_plan_raises(stream):
    jds, _truth, cases, ranking = stream
    t = cases["mz", False][0]
    tb, batches = _port(jds, t, {"band_slice": "off",
                                 "peak_compaction": "off"}, False)
    for variant in ("band", "compact", "strided"):
        with pytest.raises(ValueError, match="not planned"):
            tb._dispatch(batches[0], variant=variant)


# ------------------------------------------------------------------ search
def test_search_order_ions_mz_equals_table(stream):
    """``parallel.order_ions="mz"`` reorders the ion table before batching;
    the (sf, adduct) -> metrics results equal ``"table"``'s (the JAX
    package's ``test_order_table_by_mz_results_invariant``)."""
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch

    jds, truth, _cases, _ranking = stream
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)

    def run(order):
        sm, dc = configs_from_dicts(
            {"fdr": {"decoy_sample_size": 3},
             "parallel": {"formula_batch": BATCH, "order_ions": order,
                          "isocalc_workers": 1}}, DS_DICT, device="cpu")
        search = MSMBasicSearch(tds, list(truth.formulas[:10]), dc, sm)
        return search.search(), search.last_backend

    a, backend = run("mz")
    b, _ = run("table")
    assert sum(backend.variant_counts.values()) > 1
    pd.testing.assert_frame_equal(
        a.all_metrics.set_index(["sf", "adduct"]).sort_index(),
        b.all_metrics.set_index(["sf", "adduct"]).sort_index())
    pd.testing.assert_frame_equal(
        a.annotations.sort_values(["sf", "adduct"]).reset_index(drop=True),
        b.annotations.sort_values(["sf", "adduct"]).reset_index(drop=True))
