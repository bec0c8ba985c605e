"""The port's library search on the CPU against the golden report and the
live JAX search.

``SpectralDataset.from_imzml`` -> ``MSMBasicSearch(...).search()`` of the
port, on the golden 32x32 spheroid fixture (the recipe of
``scripts/make_golden_report.py``, read from it: GEN, SM, DS), must match
``tests/data/golden_spheroid.json`` (the root section and
``multi_adduct``) with the golden test's tolerance — the same annotation
order, metrics within 1e-6 and equal FDR arrays — and must match the JAX
package's search of the same fixture run live: the same annotations in the
same order with identical ``fdr_level`` and ``fdr``, and metrics within the
same 1e-6.

The ulp contracts (``COMPONENT_CONTRACTS``: chaos 0, spatial 16, spectral
16, msm 32) hold against the golden report, which the f64 numpy oracle
wrote.  Against the live JAX search they hold up to the JAX search's own
distance from that oracle: the two packages take their f32 reductions in
different orders, and XLA's puts the JAX search up to ~20 ulp from the
oracle in spatial on this fixture (the port sits within 4).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from scripts.make_golden_report import DS, GEN, GOLDEN_PATH, SM, build_bundle
from sm_distributed_tpu.analysis.numerics import ulp_distance
from sm_distributed_tpu_torch.convert import configs_from_dicts
from sm_distributed_tpu_torch.io.dataset import SpectralDataset
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch

# one intra-op thread: under pytest-xdist several workers share the cores,
# and torch's CPU thread pools would oversubscribe them
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

SECTIONS = {"root": ("+H",), "multi_adduct": ("+H", "+Na", "+K")}
CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN_PATH.read_text())


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("golden_torch"), **GEN)
    return SpectralDataset.from_imzml(path), truth


@pytest.fixture(scope="module")
def bundles(dataset):
    """Port search per golden section, on the CPU."""
    ds, truth = dataset
    out = {}
    for key, adducts in SECTIONS.items():
        sm = dict(SM, parallel=dict(SM["parallel"], isocalc_workers=2))
        ds_cfg = {**DS, "isotope_generation": {"adducts": list(adducts)}}
        sm_cfg, ds_cfg = configs_from_dicts(sm, ds_cfg, device="cpu")
        out[key] = MSMBasicSearch(ds, truth.formulas, ds_cfg, sm_cfg).search()
    return out


def _section(golden, key):
    return golden if key == "root" else golden[key]


@pytest.mark.parametrize("key", list(SECTIONS))
def test_metrics_match_golden(golden, bundles, key):
    want = _section(golden, key)["all_metrics"]
    got = {(r.sf, r.adduct): r for r in bundles[key].all_metrics.itertuples()}
    assert len(got) == len(want)
    for w in want:
        g = got[(w["sf"], w["adduct"])]
        assert bool(g.is_target) == w["is_target"]
        for col in CONTRACT:
            assert getattr(g, col) == pytest.approx(w[col], abs=1e-6), (
                f"{col} drifted for {w['sf']}{w['adduct']}")
            assert ulp_distance(getattr(g, col), w[col]) <= CONTRACT[col], (
                f"{col} past its ulp contract for {w['sf']}{w['adduct']}")


@pytest.mark.parametrize("key", list(SECTIONS))
def test_annotations_match_golden(golden, bundles, key):
    ann = bundles[key].annotations
    want = _section(golden, key)["annotations"]
    assert [(r.sf, r.adduct) for r in ann.itertuples()] == [
        (w["sf"], w["adduct"]) for w in want], "annotation ORDER drifted"
    np.testing.assert_allclose(ann.msm.to_numpy(), [w["msm"] for w in want],
                               atol=1e-6)
    np.testing.assert_array_equal(ann.fdr.to_numpy(), [w["fdr"] for w in want])
    np.testing.assert_array_equal(ann.fdr_level.to_numpy(),
                                  [w["fdr_level"] for w in want])


@pytest.mark.parametrize("key", ["root"])
def test_matches_live_jax_search(golden, bundles, tmp_path, key):
    want = build_bundle(tmp_path, backend="jax_tpu", adducts=SECTIONS[key])
    got = bundles[key]
    ga, wa = got.annotations, want.annotations
    assert list(zip(ga.sf, ga.adduct)) == list(zip(wa.sf, wa.adduct))
    np.testing.assert_array_equal(ga.fdr_level.to_numpy(),
                                  wa.fdr_level.to_numpy())
    np.testing.assert_array_equal(ga.fdr.to_numpy(), wa.fdr.to_numpy())
    cols = ["chaos", "spatial", "spectral", "msm"]
    gm = got.all_metrics.set_index(["sf", "adduct"]).sort_index()
    wm = want.all_metrics.set_index(["sf", "adduct"]).sort_index()
    assert gm.index.equals(wm.index)
    np.testing.assert_array_equal(gm.is_target.to_numpy(),
                                  wm.is_target.to_numpy())
    np.testing.assert_array_equal(gm.chaos.to_numpy(), wm.chaos.to_numpy())
    np.testing.assert_allclose(gm[cols].to_numpy(), wm[cols].to_numpy(),
                               atol=1e-6, rtol=0)
    oracle = {(w["sf"], w["adduct"]): w
              for w in _section(golden, key)["all_metrics"]}
    for col in cols:
        o = np.array([oracle[i][col] for i in gm.index])
        to_jax = ulp_distance(gm[col].to_numpy(), wm[col].to_numpy())
        jax_to_oracle = ulp_distance(wm[col].to_numpy(), o)
        assert (to_jax <= CONTRACT[col] + jax_to_oracle).all(), col


def test_search_timings_and_columns(bundles):
    b = bundles["root"]
    assert list(b.annotations.columns) == MSMBasicSearch._ANN_COLUMNS
    assert list(b.all_metrics.columns) == MSMBasicSearch._ALL_COLUMNS
    assert {"decoy_selection", "isotope_patterns", "score", "fdr"} <= set(
        b.timings)
