"""The port's numerics contracts (``analysis/numerics.py`` and the
``NUMERICS`` registries of its scoring modules) against the JAX package's.

- the port's ``numerics`` copy equals the JAX module: ``parse_policy`` and
  ``contract_ulps`` over a grammar table (results and ``ValueError``s),
  ``ulp_distance`` / ``max_ulp`` / ``component_drift`` on seeded f32
  arrays with +-0.0, NaN, subnormals and +-inf, and the component
  contracts;
- registry parity through an explicit map of every JAX site to the port
  site that computes it, or to a named departure: no JAX site unmapped, no
  port contract looser than its JAX site's (past the named departures),
  every ``test=`` an existing port test file that defines that function
  (read with ``ast``), every ``padded=`` name a parameter of its site;
- the proofs this file is named for: the flat, fused and cube steps and the
  metric epilogues on the fixtures, each held at the bound its site
  declares (read from the registry), the fused epilogue bit-equal to the
  plain one, and the host quantizers bit-equal to the JAX package's.
"""

from __future__ import annotations

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from sm_distributed_tpu.analysis import numerics as jnum
from sm_distributed_tpu_torch.analysis import numerics as tnum
from sm_distributed_tpu_torch.drivers.ulp_sentinel import (
    NUMERICS_MODULES,
    declared,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

ROOT = Path(__file__).resolve().parent.parent

# ------------------------------------------------------------ the copy
POLICIES = [
    "contract=bit_exact; test=tests/a.py::t",
    "contract=ulp(16); test=tests/a.py::t; padded=x,y",
    " contract = ulp(0) ;test=tests/sub/a-b.py::t_1;; ",
    "test=tests/a.py::t; contract=ulp(4096)",
    "contract=ulp(16)",
    "test=tests/a.py::t",
    "contract=ulp(-1); test=tests/a.py::t",
    "contract=ulp(1.5); test=tests/a.py::t",
    "contract=exact; test=tests/a.py::t",
    "contract=bit_exact; test=tests/a.py",
    "contract=bit_exact; test=a.py::t::u",
    "contract=bit_exact; test=tests/a.py::t; padded=",
    "contract=bit_exact; test=tests/a.py::t; padded=a,,b",
    "contract=bit_exact; test=tests/a.py::t; extra=1",
    "contract=bit_exact; test=tests/a.py::t; padded",
    "",
    None,
    42,
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: repr(p)[:40])
def test_parse_policy_equals_the_jax_modules(policy):
    assert _outcome(tnum.parse_policy, policy) == \
        _outcome(jnum.parse_policy, policy)


@pytest.mark.parametrize("contract", ["bit_exact", "ulp(0)", "ulp(16)",
                                      "ulp(4096)", "ulp(x)", "bit-exact",
                                      "ulp(16) ", ""])
def test_contract_ulps_equals_the_jax_modules(contract):
    assert _outcome(tnum.contract_ulps, contract) == \
        _outcome(jnum.contract_ulps, contract)


def _special_f32(seed: int, n: int = 257) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32) * np.float32(
        10.0) ** rng.integers(-40, 38, n).astype(np.float32)
    tiny = np.finfo(np.float32).smallest_subnormal
    special = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, tiny,
                        -tiny, 3 * tiny, np.finfo(np.float32).tiny,
                        np.finfo(np.float32).max, 1.0, -1.0], np.float32)
    idx = rng.choice(n, special.size, replace=False)
    x[idx] = special[rng.permutation(special.size)]
    return x


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ulp_helpers_equal_the_jax_modules(seed):
    a = _special_f32(seed)
    b = _special_f32(seed + 100)
    # near neighbours too: a few ulps apart, across zero
    with np.errstate(over="ignore"):
        c = np.nextafter(a, np.float32(np.sign(seed - 1.5))
                         * np.float32(np.inf))
    for x, y in ((a, b), (a, c), (a, a), (a.astype(np.float64), b)):
        got = tnum.ulp_distance(x, y)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jnum.ulp_distance(x, y))
        assert tnum.max_ulp(x, y) == jnum.max_ulp(x, y)
    assert tnum.max_ulp(np.zeros(0), np.zeros(0)) == \
        jnum.max_ulp(np.zeros(0), np.zeros(0)) == 0
    assert tnum.ulp_distance(np.float32(0.0), np.float32(-0.0)) == 0
    got, want = a[:256].reshape(64, 4), c[:256].reshape(64, 4)
    assert tnum.component_drift(got, want) == jnum.component_drift(got, want)


@pytest.mark.parametrize("shapes", [((4, 4), (4, 3)), ((4, 4), (5, 4)),
                                    ((4,), (4,))])
def test_component_drift_refuses_what_the_jax_module_refuses(shapes):
    a, b = (np.zeros(s, np.float32) for s in shapes)
    assert _outcome(tnum.component_drift, a, b) == \
        _outcome(jnum.component_drift, a, b)
    with pytest.raises(ValueError):
        tnum.component_drift(a, b)


def test_component_contracts_equal_the_jax_modules():
    assert tnum.COMPONENT_CONTRACTS == jnum.COMPONENT_CONTRACTS
    assert list(tnum.COMPONENT_CONTRACTS) == list(tnum.COMPONENTS) == \
        list(jnum.COMPONENTS)
    for name in ("CONTRACT_RE", "TEST_RE", "PADDED_RE"):
        assert getattr(tnum, name).pattern == getattr(jnum, name).pattern
    assert (tnum.POLICY_KEYS, tnum.OPTIONAL_KEYS) == \
        (jnum.POLICY_KEYS, jnum.OPTIONAL_KEYS)


def test_a_malformed_declaration_raises_naming_its_site():
    with pytest.raises(ValueError, match=r"'mod\.x'.*'site'.*contract must"):
        tnum.numerics_surface("mod.x", {
            "site": "contract=ulp(one); test=tests/a.py::t"})
    assert "mod.x" not in tnum.registered()


# ------------------------------------------------------ registry parity
JAX_MODULES = ("ops.metrics_jax", "ops.score_pallas", "ops.isocalc_jax",
               "ops.quantize", "ops.chaos_pallas", "ops.moments_pallas",
               "parallel.sharded", "models.msm_jax", "service.primer")

# every JAX site -> the port site (module, site) that computes it
SITE_MAP = {
    ("ops.metrics_jax", "batch_metrics"): ("ops.metrics", "batch_metrics"),
    ("ops.metrics_jax", "measure_of_chaos_batch"):
        ("ops.metrics", "measure_of_chaos_batch"),
    ("ops.metrics_jax", "hotspot_clip_batch"):
        ("ops.metrics", "hotspot_clip_batch"),
    ("ops.metrics_jax", "correlation_from_moments"):
        ("ops.metrics", "correlation_from_moments"),
    ("ops.metrics_jax", "isotope_pattern_match_batch"):
        ("ops.metrics", "isotope_pattern_match_batch"),
    ("ops.metrics_jax", "batch_metrics_from_partials"):
        ("ops.metrics", "batch_metrics_from_partials"),
    ("ops.score_pallas", "fused_window_moments"):
        ("ops.score", "fused_window_moments"),
    ("ops.isocalc_jax", "run"): ("ops.isocalc_torch", "blur_centroid"),
    ("ops.quantize", "quantize_mz"): ("ops.quantize", "quantize_mz"),
    ("ops.quantize", "quantize_window"): ("ops.quantize", "quantize_window"),
    ("ops.quantize", "quantize_intensities"):
        ("ops.quantize", "quantize_intensities"),
    ("ops.quantize", "intensity_scale"): ("ops.quantize", "intensity_scale"),
    ("ops.quantize", "compact_cube"): ("ops.quantize", "compact_cube"),
    ("ops.quantize", "expand_cube_jnp"):
        ("ops.quantize", "expand_cube_range"),
    ("ops.chaos_pallas", "chaos_count_sums"):
        ("ops.chaos", "chaos_count_sums"),
    ("ops.chaos_pallas", "chaos_count_sums_strips"):
        ("ops.chaos", "chaos_count_sums_strips"),
    ("ops.moments_pallas", "batch_moments_pallas"):
        ("ops.moments", "batch_moments"),
    ("ops.moments_pallas", "batch_moments_pallas_masked"):
        ("ops.moments", "batch_moments"),
    ("ops.moments_pallas", "batch_moments_jnp"):
        ("ops.moments", "batch_moments_torch"),
    ("ops.moments_pallas", "batch_moments"): ("ops.moments", "batch_moments"),
    ("parallel.sharded", "step"):
        ("parallel.sharded", "ShardedTorchBackend._dispatch"),
    ("parallel.sharded", "sharded"):
        ("parallel.sharded", "ShardedTorchBackend.score_batches"),
    ("models.msm_jax", "fused_score_fn_chunked"):
        ("models.msm_torch", "score_chunked"),
    ("models.msm_jax", "fused_score_fn_flat_banded"):
        ("models.msm_torch", "score_flat_plain"),
    ("models.msm_jax", "fused_score_fn_flat_banded_compact"):
        ("models.msm_torch", "score_flat_compact"),
    ("models.msm_jax", "fused_score_fn_flat_banded_sliced"):
        ("models.msm_torch", "score_flat_sliced"),
    ("models.msm_jax", "fused_score_fn_flat_fused"):
        ("models.msm_torch", "score_flat_fused"),
    ("models.msm_jax", "expand_cube_jnp"):
        ("ops.quantize", "expand_cube_range"),
    ("models.msm_jax", "extract_images"):
        ("models.msm_torch", "TorchBackend.extract_ion_images"),
    ("models.msm_jax", "extract_images_flat"):
        ("models.msm_torch", "extract_images_flat_banded"),
    ("models.msm_jax", "ext_base"):
        ("models.msm_torch", "TorchBackend.image_block"),
    ("models.msm_jax", "batch_moments"): ("ops.moments", "batch_moments"),
    ("models.msm_jax", "measure_of_chaos_batch"):
        ("ops.metrics", "measure_of_chaos_batch"),
    ("models.msm_jax", "correlation_from_moments"):
        ("ops.metrics", "correlation_from_moments"),
    ("models.msm_jax", "isotope_pattern_match_batch"):
        ("ops.metrics", "isotope_pattern_match_batch"),
    ("service.primer", "prime_spec"): ("service.primer", "prime_spec"),
}
# JAX sites with no port site, and why
NO_SITE = {
    ("ops.metrics_jax", "isotope_image_correlation_batch"):
        "spatial always goes through the moments and "
        "correlation_from_moments",
}
# mapped sites whose port contract is looser than the JAX one, and why
LOOSER = {
    ("ops.moments_pallas", "batch_moments_jnp"):
        "torch's reduction order depends on the row length: lattice pad "
        "pixels move the plain twin's centered sums' last bits",
}


@pytest.fixture(scope="module")
def registries():
    for mod in JAX_MODULES:
        importlib.import_module(f"sm_distributed_tpu.{mod}")
    jax_reg = {(m.removeprefix("sm_distributed_tpu."), site): policy
               for m, entries in jnum.registered().items()
               for site, policy in entries.items()}
    port_reg = {(m.removeprefix("sm_distributed_tpu_torch."), site): policy
                for m, entries in declared().items()
                for site, policy in entries.items()}
    return jax_reg, port_reg


def _ulps(policy: str) -> int:
    return tnum.contract_ulps(tnum.parse_policy(policy)["contract"])


def test_every_jax_site_is_mapped_or_a_departure(registries):
    jax_reg, port_reg = registries
    jax_sites = {k for k in jax_reg
                 if k[0] in JAX_MODULES}
    assert len(jax_sites) == 37
    assert set(SITE_MAP) | set(NO_SITE) == jax_sites
    assert not set(SITE_MAP) & set(NO_SITE)
    assert set(LOOSER) <= set(SITE_MAP)
    for jax_site, port_site in SITE_MAP.items():
        assert port_site in port_reg, (jax_site, port_site)


def test_every_port_site_stands_for_a_jax_site(registries):
    _jax_reg, port_reg = registries
    assert set(port_reg) == set(SITE_MAP.values())


def test_port_registry_holds_nine_modules():
    reg = declared()
    assert sorted(reg) == sorted(f"sm_distributed_tpu_torch.{m}"
                                 for m in NUMERICS_MODULES)
    assert len(reg) == 9


@pytest.mark.parametrize("jax_site", sorted(SITE_MAP),
                         ids=lambda s: f"{s[0]}.{s[1]}")
def test_no_port_contract_is_looser(registries, jax_site):
    jax_reg, port_reg = registries
    port = _ulps(port_reg[SITE_MAP[jax_site]])
    want = _ulps(jax_reg[jax_site])
    if jax_site in LOOSER:
        assert port > want, f"{jax_site} is no longer a departure"
    else:
        assert port <= want, (jax_site, port, want)


def _port_sites():
    return sorted((m.removeprefix("sm_distributed_tpu_torch."), site)
                  for m, entries in declared().items() for site in entries)


def _functions_of(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


@pytest.mark.parametrize("site", _port_sites(),
                         ids=lambda s: f"{s[0]}.{s[1]}")
def test_every_named_test_is_a_port_test_that_exists(registries, site):
    _jax_reg, port_reg = registries
    ref = tnum.parse_policy(port_reg[site])["test"]
    rel, name = ref.split("::")
    assert Path(rel).name.startswith("test_torch_"), ref
    path = ROOT / rel
    assert path.is_file(), ref
    assert name.startswith("test_") and name in _functions_of(path), ref


def _site_function(module: str, site: str):
    obj = importlib.import_module(f"sm_distributed_tpu_torch.{module}")
    for part in site.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("site", _port_sites(),
                         ids=lambda s: f"{s[0]}.{s[1]}")
def test_every_site_is_a_function_and_padded_names_its_parameters(
        registries, site):
    _jax_reg, port_reg = registries
    fn = _site_function(*site)
    assert callable(fn), site
    padded = tnum.parse_policy(port_reg[site]).get("padded")
    if padded:
        params = inspect.signature(fn).parameters
        assert set(padded.split(",")) <= set(params), (site, padded)


# ------------------------------------------------------------- the proofs
FIXTURES = {
    "offgrid9x11": dict(nrows=9, ncols=11, formulas=None,
                        present_fraction=0.5, noise_peaks=12, seed=41),
    "synthetic12x12": dict(nrows=12, ncols=12, formulas=None,
                           present_fraction=0.5, noise_peaks=60, seed=23),
}
ADDUCTS = ("+H", "+Na")
BATCH = 256


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """name -> (dataset, table, the numpy oracle's metrics), built once."""
    from sm_distributed_tpu_torch.io.dataset import SpectralDataset
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu_torch.models.msm_basic import NumpyBackend
    from sm_distributed_tpu_torch.ops.fdr import FDR
    from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu_torch.utils.config import (
        DSConfig,
        IsotopeGenerationConfig,
    )

    cache = {}

    def get(name):
        if name not in cache:
            path, truth = generate_synthetic_dataset(
                tmp_path_factory.mktemp(name), **FIXTURES[name])
            ds = SpectralDataset.from_imzml(path)
            fdr = FDR(decoy_sample_size=3, target_adducts=ADDUCTS, seed=42)
            pairs, flags = fdr.decoy_adduct_selection(
                truth.formulas).all_ion_tuples(truth.formulas, ADDUCTS)
            table = IsocalcWrapper(IsotopeGenerationConfig(adducts=ADDUCTS),
                                   n_procs=1).pattern_table(pairs, flags)
            dc = DSConfig.from_dict(
                {"isotope_generation": {"adducts": list(ADDUCTS)}})
            cache[name] = (ds, table, dc, _score(NumpyBackend(ds, dc), table))
        return cache[name]

    return get


def _score(backend, table, batch=BATCH) -> np.ndarray:
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    return np.concatenate(backend.score_batches(
        [_slice_table(table, s, min(s + batch, table.n_ions))
         for s in range(0, table.n_ions, batch)]))


def _port(ds, table, dc, **parallel) -> np.ndarray:
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.utils.config import SMConfig

    sm = SMConfig.from_dict({"device": "cpu", "parallel": {
        "formula_batch": BATCH, **parallel}})
    tb = TorchBackend(ds, dc, sm, restrict_table=table)
    return _score(tb, table, tb.batch), tb


def _declared_ulps(module: str, site: str) -> int:
    return _ulps(declared()[f"sm_distributed_tpu_torch.{module}"][site])


@pytest.mark.parametrize("lattice", ["auto", "off"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_flat_step_holds_its_contracts(scored, name, lattice):
    """The plain flat step (``score_flat_plain``) against the numpy oracle:
    chaos at ``measure_of_chaos_batch``'s bound, spatial at
    ``correlation_from_moments``'s, spectral at
    ``isotope_pattern_match_batch``'s, and every component at
    ``batch_metrics``' and the step's own.  The 9x11 fixture pads its rows
    on the lattice."""
    ds, table, dc, oracle = scored(name)
    got, tb = _port(ds, table, dc, shape_buckets=lattice,
                    band_slice="off", peak_compaction="off")
    assert tb.variant_counts["plain"] == -(-table.n_ions // tb.batch)
    if name == "offgrid9x11":
        assert (tb._nrows_b > ds.nrows) == (lattice == "auto")
    drift = tnum.component_drift(got, oracle)
    sites = {"chaos": "measure_of_chaos_batch",
             "spatial": "correlation_from_moments",
             "spectral": "isotope_pattern_match_batch"}
    for comp, site in sites.items():
        assert drift[comp] <= _declared_ulps("ops.metrics", site), drift
    for module, site in (("ops.metrics", "batch_metrics"),
                         ("models.msm_torch", "score_flat_plain")):
        assert max(drift.values()) <= _declared_ulps(module, site), drift
    assert (got[:, 3] > 0).any()


@pytest.mark.parametrize("name", list(FIXTURES))
def test_fused_step_holds_its_contract(scored, name):
    """``score_flat_fused`` (the fused kernel's plain twin on the CPU)
    against the plain flat step, at the fused step's declared bound."""
    ds, table, dc, _oracle = scored(name)
    plain, _ = _port(ds, table, dc)
    got, tb = _port(ds, table, dc, fused_metrics="on")
    assert tb.variant_counts["fused"] == -(-table.n_ions // tb.batch)
    drift = tnum.component_drift(got, plain)
    assert max(drift.values()) <= _declared_ulps(
        "models.msm_torch", "score_flat_fused"), drift
    assert drift["chaos"] == 0


@pytest.mark.parametrize("name", list(FIXTURES))
def test_chunked_step_holds_its_contract(scored, name):
    """``score_chunked`` (the m/z-chunked cube path, off the row lattice)
    against the plain flat step on the lattice, at its declared bound."""
    ds, table, dc, _oracle = scored(name)
    plain, _ = _port(ds, table, dc)
    got, tb = _port(ds, table, dc, mz_chunk=64)
    assert tb.mz_chunk == 64
    drift = tnum.component_drift(got, plain)
    assert max(drift.values()) <= _declared_ulps(
        "models.msm_torch", "score_chunked"), drift


def _block(seed, n=32, k=4, nrows=10, ncols=11, real_rows=9):
    """An integer-grid (n, k, P) image block with blobs, noise, empty ions
    and rows past ``real_rows`` zero (the lattice's pads)."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, k, nrows, ncols), np.float32)
    yy, xx = np.mgrid[:nrows, :ncols]
    for i in range(n):
        cy, cx = rng.uniform(0, real_rows), rng.uniform(0, ncols)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                      / rng.uniform(2, 12))
        for j in range(k):
            noise = rng.integers(0, 40, (nrows, ncols)) * (
                rng.random((nrows, ncols)) < 0.15)
            imgs[i, j] = np.rint(rng.uniform(50, 5000) * blob
                                 * (i % 5 != 4)) + noise
    imgs[:, :, real_rows:, :] = 0.0
    theor = np.zeros((n, k), np.float32)
    theor[:, 0] = 100.0
    theor[:, 1:] = rng.uniform(1, 80, (n, k - 1))
    n_valid = rng.integers(0, k + 1, n).astype(np.int32)
    n_valid[:3] = [k, 1, 0]
    return imgs.reshape(n, k, -1), theor, n_valid


@pytest.mark.parametrize("lattice", [False, True], ids=["plain", "lattice"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_epilogue_from_partials_is_batch_metrics(seed, lattice):
    """``batch_metrics_from_partials`` on the fused kernel's partials of a
    block (its plain twin's) gives ``batch_metrics``' rows of the same
    block at its declared bound (bit-exact)."""
    from sm_distributed_tpu_torch.ops.metrics import (
        batch_metrics,
        batch_metrics_from_partials,
    )
    from sm_distributed_tpu_torch.ops.score import _moment_partials

    nrows, ncols = 10, 11
    real_rows = 9 if lattice else nrows
    imgs, theor, n_valid = _block(seed, real_rows=real_rows)
    n_real = real_rows * ncols
    want = batch_metrics(torch.from_numpy(imgs.copy()),
                         torch.from_numpy(theor), torch.from_numpy(n_valid),
                         nrows, ncols, 30,
                         n_real=n_real if lattice else None).numpy()
    partials = _moment_partials(torch.from_numpy(imgs.copy()), n_real)
    got = batch_metrics_from_partials(
        partials, torch.from_numpy(imgs[:, 0, :].copy()),
        torch.from_numpy(theor), torch.from_numpy(n_valid), nrows, ncols,
        30).numpy()
    bound = _declared_ulps("ops.metrics", "batch_metrics_from_partials")
    assert max(tnum.component_drift(got, want).values()) <= bound
    assert (got[:, 3] > 0).any()


def _quantize_cases():
    rng = np.random.default_rng(5)
    mz = np.concatenate([rng.uniform(50, 2000, 500),
                         [0.0, 1e-5, 0.5e-5, 1.5e-5, 21474.83646, 21474.83647,
                          1e9, np.inf]])
    ints = np.concatenate([rng.lognormal(6, 3, 500), [0.0, 0.5, 1.5, 2.5]])
    return mz, ints


@pytest.mark.parametrize("site", ["quantize_mz", "quantize_intensities",
                                  "intensity_scale"])
def test_quantize_sites_equal_the_jax_packages(site, tmp_path):
    from sm_distributed_tpu.ops import quantize as jq
    from sm_distributed_tpu_torch.ops import quantize as tq

    mz, ints = _quantize_cases()
    if site == "quantize_mz":
        cases = [(mz,), (mz.astype(np.float32),)]
    elif site == "quantize_intensities":
        cases = [(ints, s) for s in (1.0, 0.25, 2.0 ** 7, 2.0 ** -13)]
    else:
        from sm_distributed_tpu_torch.io.dataset import SpectralDataset
        from sm_distributed_tpu_torch.io.fixtures import (
            generate_synthetic_dataset,
        )

        path, _ = generate_synthetic_dataset(tmp_path, **FIXTURES[
            "offgrid9x11"])
        ds = SpectralDataset.from_imzml(path)
        pix = np.repeat(np.arange(len(ds.row_ptr) - 1), np.diff(ds.row_ptr))
        cases = [(ds.mzs_flat, ds.ints_flat, pix, ppm)
                 for ppm in (1.0, 3.0, 7.5)]
        cases.append((ds.mzs_flat, ds.ints_flat * 1e6, pix, 3.0))
        cases.append((ds.mzs_flat[:0], ds.ints_flat[:0], pix[:0], 3.0))
    assert _ulps(declared()["sm_distributed_tpu_torch.ops.quantize"][site]) \
        == 0
    for args in cases:
        got = getattr(tq, site)(*args)
        want = getattr(jq, site)(*args)
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_the_registry_is_a_copy_per_reader():
    """``registered()`` hands out copies: a reader cannot change what the
    next one sees."""
    reg = declared()
    reg["sm_distributed_tpu_torch.ops.metrics"]["batch_metrics"] = "x"
    reg.pop("sm_distributed_tpu_torch.ops.score")
    again = declared()
    assert "sm_distributed_tpu_torch.ops.score" in again
    assert again["sm_distributed_tpu_torch.ops.metrics"][
        "batch_metrics"].startswith("contract=ulp(16)")
