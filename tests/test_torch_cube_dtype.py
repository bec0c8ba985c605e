"""Resident-cube compaction (``parallel.cube_dtype``) in the port, on the CPU.

- ``ops/quantize.compact_cube``: codes bit-equal to the JAX package's
  function for bf16 (the port casts with torch, round to nearest even, as
  ``ml_dtypes`` does) and int8 (host numpy, power-of-two tile scales), and
  exact round trips; the device expansions (a range, with each int8 slot
  scaled by its absolute tile, and a gather) equal to the host one;
- ``TorchBackend`` with a bf16 or int8 cube: every extraction variant
  (plain, band, compact, fused) and the image block bit-equal to the f32
  backend on the host-expanded cube ``expand_cube(*compact_cube(in_s))``
  (expansion is exact); the int8 cube QTILE-padded off the lattice; the
  resident intensity bytes halved (bf16) and quartered plus scales (int8);
- the data-level bar, as the JAX package holds it on the off-lattice 9x11
  spheroid (``tests/test_score_pallas.py``): bf16 FDR ranks identical to
  the f32 cube's, int8 metrics within ``atol=0.1`` of them, each also held
  to ``JaxBackend(..., cube_dtype=..., fused_metrics="off")`` (FDR ranks
  identical, chaos bit-equal, the other components within the contracts
  plus the JAX backend's own distance from the port, as in
  ``tests/test_torch_variants.py``);
- a port search with ``cube_dtype="bf16"`` against the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import pytest
import torch

from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.convert import (
    configs_from_dicts,
    dataset_from_arrays,
    pattern_table_from_arrays,
)
from sm_distributed_tpu_torch.ops import quantize as tq

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

BATCH = 8
DS_DICT = {"isotope_generation": {"adducts": ["+H"]}}
VARIANTS = ("plain", "band", "compact", "fused")


def _grid_cube(seed: int, n: int) -> np.ndarray:
    """An integer-grid f32 intensity cube with zero runs and large values,
    as the resident cube holds."""
    rng = np.random.default_rng(seed)
    x = np.rint(rng.random(n) * 2.0 ** rng.integers(0, 24, n))
    x[rng.random(n) < 0.3] = 0
    return x.astype(np.float32)


# ---------------------------------------------------------------- codes
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
@pytest.mark.parametrize("seed", range(3))
def test_compact_cube_codes_bit_equal_jax(dtype, seed):
    from sm_distributed_tpu.ops import quantize as jq

    x = _grid_cube(seed, 4 * tq.QTILE)
    codes, scales = tq.compact_cube(x, dtype)
    jcodes, jscales = jq.compact_cube(x, dtype)
    np.testing.assert_array_equal(codes, jcodes.view(codes.dtype))
    if dtype == "int8":
        np.testing.assert_array_equal(scales, jscales)
    else:
        assert scales is None and jscales is None
    np.testing.assert_array_equal(
        tq.expand_cube(codes, scales).view(np.uint32),
        jq.expand_cube(jcodes, jscales).view(np.uint32))


def test_compact_cube_roundtrip():
    x = _grid_cube(7, 3 * tq.QTILE)
    codes, scales = tq.compact_cube(x, "f32")
    assert scales is None
    np.testing.assert_array_equal(tq.expand_cube(codes, scales), x)
    codes, scales = tq.compact_cube(x, "bf16")
    assert codes.dtype == np.uint16 and codes.nbytes == x.nbytes // 2
    host = tq.expand_cube(codes, None)
    # bf16 keeps 8 significant bits, rounded to nearest even
    np.testing.assert_array_equal(
        host, torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    codes, scales = tq.compact_cube(x, "int8")
    assert codes.dtype == np.int8 and scales.shape == (3,)
    np.testing.assert_array_equal(np.exp2(np.rint(np.log2(scales))), scales)
    host = tq.expand_cube(codes, scales)
    assert np.max(np.abs(host - x)) <= 0.5 * np.max(scales)
    with pytest.raises(ValueError):
        tq.compact_cube(x[:-1], "int8")
    with pytest.raises(ValueError):
        tq.compact_cube(x, "fp4")


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_device_expansion_matches_host(dtype):
    x = _grid_cube(3, 5 * tq.QTILE)
    codes, scales = tq.compact_cube(x, dtype)
    host = torch.from_numpy(tq.expand_cube(codes, scales))
    dev = tq.cube_to_device(codes, "cpu")
    ts = None if scales is None else torch.from_numpy(scales)
    assert torch.equal(tq.expand_cube_range(dev, ts), host)
    rng = np.random.default_rng(0)
    for _ in range(20):
        lo, hi = sorted(rng.integers(0, x.size + 1, 2).tolist())
        assert torch.equal(tq.expand_cube_range(dev, ts, lo, hi), host[lo:hi])
    idx = torch.from_numpy(rng.integers(0, x.size, 300))
    assert torch.equal(tq.expand_cube_at(dev, ts, idx), host[idx])


# -------------------------------------------------------------- backends
@pytest.fixture(scope="module")
def offgrid(tmp_path_factory):
    """The off-lattice spheroid of ``tests/test_score_pallas.py``: 9 rows
    bucket to 10, peaks under the resident floor.  10 formulas +H with 2
    decoys each, and the FDR that ranks them."""
    from sm_distributed_tpu.ops.fdr import FDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig

    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("dsp"), nrows=9, ncols=11, formulas=None,
        present_fraction=0.5, noise_peaks=12, seed=41)
    jds = JDataset.from_imzml(path)
    formulas = truth.formulas[:10]
    fdr = FDR(decoy_sample_size=2, target_adducts=("+H",), seed=1)
    assignment = fdr.decoy_adduct_selection(formulas)
    pairs, flags = assignment.all_ion_tuples(formulas, ("+H",))
    calc = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H",)),
                          n_procs=1)
    jt = calc.pattern_table(pairs, flags)
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    tt = pattern_table_from_arrays(jt.sfs, jt.adducts, jt.mzs, jt.ints,
                                   jt.n_valid, jt.targets)
    return jds, jt, tds, tt, truth, (fdr, assignment)


def _port(tds, tt, parallel: dict):
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    sm, dc = configs_from_dicts(
        {"parallel": {"formula_batch": BATCH, **parallel}}, DS_DICT,
        device="cpu")
    return TorchBackend(tds, dc, sm, restrict_table=tt)


def _batches(tt):
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    return [_slice_table(tt, s, min(s + BATCH, tt.n_ions))
            for s in range(0, tt.n_ions, BATCH)]


def _expanded_twin(tds, tt, compact, parallel: dict):
    """An f32 backend whose resident intensities are the compact backend's
    cube expanded on the host: the exactness reference."""
    twin = _port(tds, tt, parallel)
    codes, scales = tq.compact_cube(twin._in_s.numpy(), compact.cube_dtype)
    twin._in_s = torch.from_numpy(tq.expand_cube(codes, scales).copy())
    return twin


def _scores(backend, tt, variant=None) -> np.ndarray:
    out = []
    for t in _batches(tt):
        o = backend._dispatch(t, backend._flat_plan(t), variant)
        out.append(o[:t.n_ions].numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_compact_scoring_bit_equal_to_expanded_cube(offgrid, dtype, variant):
    _jds, _jt, tds, tt, _truth, _rk = offgrid
    compact = _port(tds, tt, {"cube_dtype": dtype})
    twin = _expanded_twin(tds, tt, compact, {})
    assert compact._in_s.dtype == {"bf16": torch.bfloat16,
                                   "int8": torch.int8}[dtype]
    got = _scores(compact, tt, variant)
    want = _scores(twin, tt, variant)
    np.testing.assert_array_equal(got, want)
    assert compact.variant_counts[variant] == len(_batches(tt))
    # every variant gives the plain variant's bits
    np.testing.assert_array_equal(got, _scores(compact, tt, "plain"))


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_compact_image_block_bit_equal(offgrid, dtype):
    _jds, _jt, tds, tt, _truth, _rk = offgrid
    compact = _port(tds, tt, {"cube_dtype": dtype})
    twin = _expanded_twin(tds, tt, compact, {})
    for t in _batches(tt):
        a = compact.image_block(t)[0]
        b = twin.image_block(t)[0]
        assert torch.equal(a, b)
    np.testing.assert_array_equal(compact.extract_ion_images(tt),
                                  twin.extract_ion_images(tt))


def test_int8_lattice_off_pads_to_qtile(offgrid, monkeypatch):
    """Off the lattice an int8 cube pads to whole tiles with
    zero-intensity overflow-row slots.  The flat layout already pads to
    1024-slot multiples, so the pad is provoked here with a layout padded
    to 8."""
    from sm_distributed_tpu_torch.models import msm_torch
    from sm_distributed_tpu_torch.ops.imager import prepare_flat_sorted_arrays

    monkeypatch.setattr(
        msm_torch, "prepare_flat_sorted_arrays",
        lambda ds, ppm: prepare_flat_sorted_arrays(ds, ppm, pad_to_multiple=8))
    _jds, _jt, tds, tt, _truth, _rk = offgrid
    sm, dc = configs_from_dicts(
        {"parallel": {"formula_batch": BATCH, "shape_buckets": "off"}},
        DS_DICT, device="cpu")
    f32 = msm_torch.TorchBackend(tds, dc, sm)
    sm8, _ = configs_from_dicts(
        {"parallel": {"formula_batch": BATCH, "shape_buckets": "off",
                      "cube_dtype": "int8"}}, DS_DICT, device="cpu")
    compact = msm_torch.TorchBackend(tds, dc, sm8)
    n = f32._in_s.numel()
    assert n % tq.QTILE != 0
    assert compact._in_s.numel() == -(-n // tq.QTILE) * tq.QTILE
    assert compact._scales.numel() == compact._in_s.numel() // tq.QTILE
    # the pad slots: zero intensity, the overflow row, the m/z sentinel
    assert (compact._in_s[n:] == 0).all()
    assert (compact._px_s[n:] == tds.n_pixels).all()
    assert (compact._mz_host[n:] == tq.MZ_PAD_Q).all()
    expanded = tq.expand_cube(compact._in_s.numpy(),
                              compact._scales.numpy())
    f32._in_s = torch.from_numpy(expanded[:n].copy())
    np.testing.assert_array_equal(_scores(compact, tt), _scores(f32, tt))


def test_resident_bytes(offgrid):
    _jds, _jt, tds, tt, _truth, _rk = offgrid
    f32, bf16, int8 = (_port(tds, tt, {"cube_dtype": d})
                       for d in ("f32", "bf16", "int8"))
    n = f32._in_s.numel()
    assert f32.resident_bytes["intensity"] == 4 * n
    assert bf16.resident_bytes["intensity"] == 2 * n
    assert int8.resident_bytes["intensity"] == n
    assert int8.resident_bytes["scales"] == 4 * (n // tq.QTILE)
    assert f32.resident_bytes["scales"] == bf16.resident_bytes["scales"] == 0
    assert f32.resident_bytes["pixel"] == int8.resident_bytes["pixel"]


# ------------------------------------------------------- data-level bars
def _ranks(table, metrics, ranking):
    fdr, assignment = ranking
    df = pd.DataFrame({"sf": table.sfs, "adduct": table.adducts,
                       "msm": metrics[:, 3]})
    return fdr.estimate_fdr(df, assignment).sort_values(["msm", "sf"],
                                                        ascending=False)


def _jax_scores(jds, jt, dtype):
    from sm_distributed_tpu.models.msm_basic import _slice_table
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig

    jb = JaxBackend(jds, DSConfig.from_dict(DS_DICT), SMConfig.from_dict(
        {"backend": "jax_tpu",
         "parallel": {"formula_batch": BATCH, "cube_dtype": dtype,
                      "fused_metrics": "off", "compile_cache_dir": "off"}}),
        restrict_table=jt)
    return np.concatenate(jb.score_batches(
        [_slice_table(jt, s, min(s + BATCH, jt.n_ions))
         for s in range(0, jt.n_ions, BATCH)]))


def _same_ranks(a, b) -> None:
    assert list(a.sf) == list(b.sf)
    np.testing.assert_array_equal(a.fdr.to_numpy(), b.fdr.to_numpy())


def _held_to_jax(got, jax_got, port_f32, jax_f32) -> None:
    """Chaos bit-equal; spatial, spectral and msm within the contracts
    plus the two packages' own distance on the f32 cube (their f32
    reductions run in different orders)."""
    from sm_distributed_tpu.analysis.numerics import (
        COMPONENT_CONTRACTS,
        ulp_distance,
    )

    np.testing.assert_array_equal(got[:, 0], jax_got[:, 0])
    for col, comp in list(enumerate(COMPONENT_CONTRACTS))[1:]:
        own = max(ulp_distance(a, b)
                  for a, b in zip(port_f32[:, col], jax_f32[:, col]))
        for a, b in zip(got[:, col], jax_got[:, col]):
            assert ulp_distance(a, b) <= COMPONENT_CONTRACTS[comp] + own, comp


def test_bf16_rank_identity(offgrid):
    """bf16 scoring keeps FDR ranks identical to the f32 cube (the JAX
    package's acceptance bar), in the port and against the JAX backend on
    its bf16 cube."""
    jds, jt, tds, tt, _truth, ranking = offgrid
    base = _scores(_port(tds, tt, {}), tt)
    got = _scores(_port(tds, tt, {"cube_dtype": "bf16"}), tt)
    _same_ranks(_ranks(tt, got, ranking), _ranks(tt, base, ranking))
    jax_got = _jax_scores(jds, jt, "bf16")
    _same_ranks(_ranks(tt, got, ranking), _ranks(tt, jax_got, ranking))
    _held_to_jax(got, jax_got, base, _jax_scores(jds, jt, "f32"))


def test_int8_cube_scores_within_atol(offgrid):
    """int8 compaction stays a usable coarse mode: metrics within 0.1 of
    the f32 cube's (the JAX package's bar), and the JAX backend's int8
    scores held as bf16's are."""
    jds, jt, tds, tt, _truth, ranking = offgrid
    base = _scores(_port(tds, tt, {}), tt)
    got = _scores(_port(tds, tt, {"cube_dtype": "int8"}), tt)
    np.testing.assert_allclose(got, base, atol=0.1)
    jax_got = _jax_scores(jds, jt, "int8")
    _same_ranks(_ranks(tt, got, ranking), _ranks(tt, jax_got, ranking))
    _held_to_jax(got, jax_got, base, _jax_scores(jds, jt, "f32"))


def test_bf16_search_matches_jax_search(offgrid, tmp_path):
    """A port search with ``cube_dtype="bf16"`` against the JAX package's
    search with the same knob (unfused): the same annotations in the same
    order with identical FDR arrays."""
    from sm_distributed_tpu.models.msm_basic import MSMBasicSearch as JSearch
    from sm_distributed_tpu.utils.config import DSConfig as JDC
    from sm_distributed_tpu.utils.config import SMConfig as JSC
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    jds, _jt, tds, _tt, truth, _rk = offgrid
    par = {"formula_batch": BATCH, "cube_dtype": "bf16"}
    fdr = {"decoy_sample_size": 2, "seed": 1}
    got = MSMBasicSearch(tds, truth.formulas[:10], DSConfig.from_dict(DS_DICT),
                         SMConfig.from_dict({"device": "cpu", "fdr": fdr,
                                             "parallel": par})).search()
    want = JSearch(jds, truth.formulas[:10], JDC.from_dict(DS_DICT),
                   JSC.from_dict({"backend": "jax_tpu", "fdr": fdr,
                                  "parallel": {**par, "fused_metrics": "off",
                                               "compile_cache_dir": "off"}}),
                   isocalc_cache_dir=None).search()
    ga, wa = got.annotations, want.annotations
    assert list(zip(ga.sf, ga.adduct)) == list(zip(wa.sf, wa.adduct))
    np.testing.assert_array_equal(ga.fdr.to_numpy(), wa.fdr.to_numpy())
    np.testing.assert_array_equal(ga.fdr_level.to_numpy(),
                                  wa.fdr_level.to_numpy())
