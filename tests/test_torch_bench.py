"""The port's bench (``sm_distributed_tpu_torch/drivers/bench.py``) held
against the JAX package's ``bench.py`` on the CPU.

- ``prepare``: the same dataset peaks, the same ions in the same order
  (formulas, adducts, targets, m/z and intensities exact), the same batch
  bounds and the same floor sample, at 16x16 pixels and 8 formulas;
- ``ops/imager.fused_score_cost_model`` equal to
  ``ops/imager_jax.fused_score_cost_model`` over a grid of shapes, orders,
  fused and cube dtypes (exact: the same integer and float arithmetic);
- ``report``: the JAX schema tests' cases through the key map, and the key
  sets equal under it;
- the floor against the port: the port's CPU rows of the floor sample
  against its ``NumpyBackend`` rows under the component contracts (chaos
  bit-equal, spatial and spectral within 16 ulp, msm within 32);
- ``TorchBackend.warmup`` changes no bit of a stream's rows;
- ``TorchBackend.probe_phases``: the JAX backend's phase names on the same
  tiny batch, each variant's ``fused_full`` giving ``score_batch``'s rows
  bit for bit;
- the whole CLI on the CPU prints one JSON line with the documented keys
  (with ``--devices 2``, the JAX script's multichip section over the CPU
  twice); ``--device cuda`` without a card is a usage error.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest
import torch

from sm_distributed_tpu_torch.drivers import bench as tbench

# one intra-op thread: under pytest-xdist several workers share the cores
torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}
COMPONENTS = ("chaos", "spatial", "spectral", "msm")


def _cfgs(batch=2048, baseline=40):
    import bench as jbench

    args = ("tiny", 16, 16, 8, batch, 20, 1, baseline)
    return jbench.BenchConfig(*args), tbench.BenchConfig(*args)


@pytest.fixture(scope="module")
def preps(tmp_path_factory):
    """Both packages' ``prepare`` of the 16x16, 8-formula case, each in a
    directory of its own, at batch 64 (3 batches)."""
    import bench as jbench

    jcfg, tcfg = _cfgs(batch=64)
    jprep = jbench.prepare(jcfg, tmp_path_factory.mktemp("jax_bench"))
    tprep = tbench.prepare(tcfg, tmp_path_factory.mktemp("torch_bench"))
    return jprep, tprep


def _table_fields(t):
    return (list(t.sfs), list(t.adducts), np.asarray(t.targets),
            np.asarray(t.mzs), np.asarray(t.ints), np.asarray(t.n_valid))


def _assert_tables_equal(a, b):
    for x, y in zip(_table_fields(a), _table_fields(b)):
        if isinstance(x, list):
            assert x == y
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)


# ---------------------------------------------------------------- prepare
def test_prepare_matches_the_jax_bench(preps):
    """Exact: the same peaks, ions, order, batches and floor sample."""
    jprep, tprep = preps
    jds, tds = jprep["ds"], tprep["ds"]
    assert (jds.nrows, jds.ncols, jds.n_peaks) == \
        (tds.nrows, tds.ncols, tds.n_peaks)
    for name in ("pixel_inds", "mzs_flat", "ints_flat", "row_ptr"):
        assert np.array_equal(getattr(jds, name), getattr(tds, name)), name
    assert jprep["table"].n_ions == tprep["table"].n_ions == 8 * 21
    _assert_tables_equal(jprep["table"], tprep["table"])
    assert [b.n_ions for b in jprep["batches"]] == \
        [b.n_ions for b in tprep["batches"]] == [64, 64, 40]
    for jb, tb in zip(jprep["batches"], tprep["batches"]):
        _assert_tables_equal(jb, tb)
    _assert_tables_equal(jprep["sub"], tprep["sub"])
    assert tprep["sub"].n_ions == 40
    assert jprep["pairs"] == tprep["pairs"]
    assert list(jprep["flags"]) == list(tprep["flags"])


# ------------------------------------------------------------- cost model
@pytest.mark.parametrize("ordered,fused,cube_dtype", list(itertools.product(
    (True, False), (True, False), ("f32", "bf16", "int8"))))
def test_cost_model_equals_the_jax_one(ordered, fused, cube_dtype):
    """Exact equality over a grid of shapes (both are integer arithmetic
    and the same float products)."""
    from sm_distributed_tpu.ops.imager_jax import (
        fused_score_cost_model as jmodel,
    )
    from sm_distributed_tpu_torch.ops.imager import (
        fused_score_cost_model as tmodel,
    )

    for n_pixels, resident, n_ions, k, batch, nlevels in (
            (4096, 1_000_000, 5250, 4, 2048, 30),
            (65536, 24_446_760, 10_500, 4, 2048, 30),
            (262_144, 150_000_000, 10_500, 4, 256, 30),
            (99, 3000, 30, 6, 8, 12),
            (1, 1, 1, 1, 1, 1)):
        kw = dict(n_pixels=n_pixels, resident_peaks=resident, n_ions=n_ions,
                  max_peaks=k, formula_batch=batch, nlevels=nlevels,
                  ordered=ordered, fused=fused, cube_dtype=cube_dtype)
        assert tmodel(**kw) == jmodel(**kw), kw


@pytest.mark.parametrize("fused", (False, True))
def test_banded_cost_model_keeps_the_jax_terms(fused):
    """The port's floor changes only the matmul and scratch terms of the
    JAX model (and the batch count it reads off ``bands``)."""
    from sm_distributed_tpu_torch.ops.imager import (
        banded_score_cost_model,
        fused_score_cost_model,
    )

    kw = dict(n_pixels=4096, resident_peaks=1_000_000, n_ions=5250,
              max_peaks=4, formula_batch=2048, nlevels=30, ordered=True,
              fused=fused, cube_dtype="bf16")
    bands = [(8192, 1536, 16384), (8192, 1536, 16384), (8192, 1024, 9233)]
    dense = fused_score_cost_model(**kw)
    got = banded_score_cost_model(bands=bands, **kw)
    changed = {"n_batches", "scratch_init_bytes", "total_bytes",
               "matmul_flops"}
    assert set(got) == set(dense)
    assert {k: got[k] for k in set(got) - changed} == \
        {k: dense[k] for k in set(dense) - changed}
    banded = 2.0 * 4096 * (8192 * 1538 * 2 + 8192 * 1026)
    assert got["matmul_flops"] == (
        2 * banded + 4.0 * 5250 * 4 * 4096 if fused else banded)
    init = 4 * 4100 * (16385 * 2 + 9234)
    assert got["scratch_init_bytes"] == init and got["n_batches"] == 3
    assert got["total_bytes"] - init == \
        dense["total_bytes"] - dense["scratch_init_bytes"]


@pytest.mark.parametrize("parallel", [
    {"band_slice": "off", "peak_compaction": "off"},
    {"band_slice": "on"},
    {"peak_compaction": "on", "band_slice": "off"},
])
def test_banded_cost_model_counts_the_stream_s_launches(preps, monkeypatch,
                                                        parallel):
    """Over a stream on the CPU, the port's floor prices exactly the
    membership matmuls ``banded_images`` runs (2·M·K·N flops a matmul,
    read off its operands) and the histogram scratch ``flat_histogram``
    allocates, at the scored grid's pixel count (exact)."""
    from sm_distributed_tpu_torch.ops import imager
    from sm_distributed_tpu_torch.ops.imager import banded_score_cost_model

    _jprep, tprep = preps
    tb = _port_backend(tprep, **parallel)
    batches = tprep["batches"]
    bands = tb.band_shapes(batches)
    seen = {"flops": 0.0, "scratch": 0, "in_band": False}
    real_matmul, real_banded = torch.matmul, imager.banded_images
    real_hist = imager.flat_histogram

    def matmul(a, b, **kw):
        if seen["in_band"]:
            seen["flops"] += 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
        return real_matmul(a, b, **kw)

    def banded(*args, **kw):
        seen["in_band"] = True
        try:
            return real_banded(*args, **kw)
        finally:
            seen["in_band"] = False

    def hist(*args, **kw):
        wh = real_hist(*args, **kw)
        seen["scratch"] += 4 * wh.numel()
        return wh

    monkeypatch.setattr(torch, "matmul", matmul)
    monkeypatch.setattr(imager, "banded_images", banded)
    monkeypatch.setattr(imager, "flat_histogram", hist)
    tb.score_batches(batches)
    nrows, ncols = tb.grid
    model = banded_score_cost_model(
        n_pixels=nrows * ncols, resident_peaks=tb.resident_peaks,
        n_ions=tprep["table"].n_ions, max_peaks=tprep["table"].max_peaks,
        formula_batch=64, bands=bands)
    assert seen["flops"] > 0
    assert model["matmul_flops"] == seen["flops"]
    assert model["scratch_init_bytes"] == seen["scratch"]
    assert model["n_batches"] == len(batches)


# ----------------------------------------------------------------- report
def _fake_inputs():
    class Obj:
        pass

    table = Obj()
    table.n_ions = 100
    ds = Obj()
    ds.n_pixels = 4096
    prep = {"table": table, "ds": ds, "isocalc_dt": 0.5}
    floor = dict(np_rate=50.0, mp_rate=50.0, n_procs=1, floor_n_ions=100,
                 floor_spread=0.1, floor_spread_mid5=0.05)
    run = dict(rate=5000.0, compile_dt=12.0, spread=0.02, libraries_before=4)
    return prep, floor, run


def test_report_keys_are_the_jax_keys_under_the_key_map():
    """The port's case keys are the JAX report's with the XLA ones
    renamed, the retry flag dropped and the port's own keys added."""
    import bench as jbench

    prep, floor, _run = _fake_inputs()
    jaxr = dict(jax_rate=5000.0, compile_dt=12.0, jax_spread=0.02,
                cache_entries=7)
    jkeys = set(jbench.report(prep, floor, jaxr))
    renamed = {"xla_cache_entries_before": "kernel_libraries_before"}
    dropped = {"warmup_retried"}
    added = {"kernel_launches", "n_batches", "profile_n_events",
             "power_limit_w"}
    mapped = {renamed.get(k, k) for k in jkeys - dropped} | added
    assert mapped == set(tbench.report(*_fake_inputs())) == tbench.CASE_KEYS


def test_report_schema_and_values():
    out = tbench.report(*_fake_inputs())
    assert set(out) == tbench.CASE_KEYS
    # stream_s appears only when the case config is passed
    assert out["phases"] == {"isocalc_s": 0.5, "floor_rep_s": 2.0,
                             "compile_s": 12.0}
    assert out["value"] == 5000.0
    assert out["vs_baseline"] == 100.0
    assert out["jax_spread"] == 0.02
    assert out["compile_s"] == 12.0
    assert out["warmup_skipped"] is False
    assert out["kernel_libraries_before"] == 4
    assert out["numpy_floor_ions_per_s"] == 50.0
    assert out["numpy_floor_spread_mid5"] == 0.05
    assert out["floor_procs"] == 1
    assert out["vs_baseline_multiproc"] == 100.0
    assert out["n_ions"] == 100 and out["n_pixels"] == 4096
    assert out["pixels_per_s"] == 5000.0 * 4096
    assert out["isocalc_s"] == 0.5
    assert out["isocalc_cold_s"] is None
    assert out["isocalc_workers"] is None
    assert out["patterns_per_s"] is None
    assert out["cold_compile_s"] is None
    assert out["first_annotation_cold_s"] is None
    prep, floor, run = _fake_inputs()
    out2 = tbench.report(prep, floor, run,
                         cold={"cold_compile_s": 31.456,
                               "first_annotation_cold_s": 4.321})
    assert out2["cold_compile_s"] == 31.46
    assert out2["first_annotation_cold_s"] == 4.32
    # device fields null off the card, passed through when measured
    for key in ("hbm_peak_bytes", "device_kind", "power_limit_w",
                "roofline_frac", "resident_cube_bytes", "kernel_launches",
                "measured_roofline_frac"):
        assert out[key] is None, key
    assert out["profile_n_events"] == 0
    cfg = tbench.BenchConfig("headline", 64, 64, 250, 2048, 20, 10, 1000)
    out3 = tbench.report(prep, floor, run, cfg=cfg)
    assert out3["phases"]["stream_s"] == round(10 * 100 / 5000.0, 3)


def test_report_roofline_fields_pass_through():
    prep, floor, run = _fake_inputs()
    run.update(roofline_frac=0.62, roofline_floor_s=0.484,
               roofline_bound="compute", fused=False, cube_dtype="bf16",
               resident_cube_bytes=462_000_000,
               resident_cube_bytes_f32=924_000_000,
               measured_roofline_frac=0.9, kernel_time_frac=0.8,
               device_kernel_s=1.5, profile_n_events=1234)
    out = tbench.report(prep, floor, run)
    assert out["roofline_frac"] == 0.62
    assert out["roofline_bound"] == "compute"
    assert out["fused"] is False and out["cube_dtype"] == "bf16"
    assert out["resident_cube_bytes"] * 2 <= out["resident_cube_bytes_f32"]
    assert (out["measured_roofline_frac"], out["kernel_time_frac"],
            out["device_kernel_s"], out["profile_n_events"]) == \
        (0.9, 0.8, 1.5, 1234)


def test_report_warmup_split_phases():
    """The JAX compile split's phases under the key map: nvcc and load
    seconds, and the warm-up's execution."""
    prep, floor, run = _fake_inputs()
    run["compile_split"] = {"nvcc_s": 9.5, "load_s": 0.004,
                            "warmup_exec_s": 2.5}
    out = tbench.report(prep, floor, run)
    assert out["phases"]["compile_nvcc_s"] == 9.5
    assert out["phases"]["compile_load_s"] == 0.004
    assert out["phases"]["warmup_exec_s"] == 2.5


def test_report_card_fields_pass_through():
    prep, floor, run = _fake_inputs()
    run.update(hbm_peak_bytes=1_940_000_000,
               device_kind="NVIDIA H100 80GB HBM3", power_limit_w=700.0,
               warmup_skipped=True, n_batches=3,
               kernel_launches={"moments": 15, "chaos": 15})
    out = tbench.report(prep, floor, run)
    assert out["hbm_peak_bytes"] == 1_940_000_000
    assert out["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert out["power_limit_w"] == 700.0
    assert out["warmup_skipped"] is True
    assert out["n_batches"] == 3
    assert out["kernel_launches"] == {"moments": 15, "chaos": 15}


def test_report_isocalc_cold_fields():
    prep, floor, run = _fake_inputs()
    iso = dict(isocalc_cold_s=12.345, isocalc_workers=4,
               patterns_per_s=812.5)
    out = tbench.report(prep, floor, run, iso)
    assert out["isocalc_cold_s"] == 12.35
    assert out["isocalc_workers"] == 4
    assert out["patterns_per_s"] == 812.5


# -------------------------------------------------------- floor vs port
def _port_backend(prep, **parallel):
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.utils.config import SMConfig

    sm = SMConfig.from_dict({"device": "cpu",
                             "parallel": {"formula_batch": 64, **parallel}})
    return TorchBackend(prep["ds"], prep["ds_config"], sm,
                        restrict_table=prep["table"])


def test_floor_sample_rows_hold_the_contracts(preps):
    """The port's CPU rows of the floor sample against the numpy floor's:
    chaos bit-equal, spatial and spectral within 16 ulp, msm within 32."""
    from sm_distributed_tpu_torch.analysis.numerics import ulp_distance
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table

    _jprep, tprep = preps
    sub = tprep["sub"]
    want = tprep["np_backend"].score_batch(sub)
    tb = _port_backend(tprep)
    got = np.concatenate(tb.score_batches(
        [_slice_table(sub, s, min(s + 64, sub.n_ions))
         for s in range(0, sub.n_ions, 64)]))
    assert got.shape == want.shape == (40, 4)
    for c, comp in enumerate(COMPONENTS):
        ulps = ulp_distance(got[:, c].astype(np.float32),
                            want[:, c].astype(np.float32))
        assert int(ulps.max()) <= CONTRACT[comp], (comp, int(ulps.max()))
    assert (want[:, 3] > 0).any()


# ----------------------------------------------------------------- warmup
def test_warmup_changes_no_bit(preps):
    _jprep, tprep = preps
    batches = tprep["batches"]
    cold = _port_backend(tprep)
    want = cold.score_batches(batches)
    warm = _port_backend(tprep)
    warm.warmup(batches)
    assert warm.last_warmup_skipped is False
    # one batch a variant the stream takes
    warmed = sum(warm.variant_counts.values())
    assert 1 <= warmed <= len({v for v, n in cold.variant_counts.items()
                               if n})
    got = warm.score_batches(batches)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


# ----------------------------------------------------------- probe_phases
PHASES = {"fused_full", "extract", "moments", "chaos", "correlation",
          "pattern"}


def test_probe_phase_names_equal_the_jax_backend(preps):
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    jprep, tprep = preps
    jsm = JSMConfig.from_dict({"backend": "jax_tpu", "parallel": {
        "formula_batch": 64, "compile_cache_dir": "off"}})
    jb = JaxBackend(jprep["ds"], jprep["ds_config"], jsm,
                    restrict_table=jprep["table"])
    jphases, jinfo = jb.probe_phases(jprep["batches"][0])
    tphases, tinfo = _port_backend(tprep).probe_phases(tprep["batches"][0])
    assert set(tphases) == set(jphases) == PHASES
    assert jinfo["path"] == tinfo["path"] == "flat"


def _port_backend_preprocessed(prep, **parallel):
    """``_port_backend`` with ``image_generation.do_preprocessing`` on."""
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
    from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

    ds_config = DSConfig.from_dict(
        {"isotope_generation": {"adducts": ["+H"]},
         "image_generation": {"ppm": 3.0, "do_preprocessing": True}})
    sm = SMConfig.from_dict({"device": "cpu",
                             "parallel": {"formula_batch": 64, **parallel}})
    return TorchBackend(prep["ds"], ds_config, sm,
                        restrict_table=prep["table"])


@pytest.mark.parametrize("variant,parallel,preprocessed", [
    ("plain", {"band_slice": "off", "peak_compaction": "off"}, False),
    ("band", {"band_slice": "on"}, False),
    ("compact", {"peak_compaction": "on", "band_slice": "off"}, False),
    ("fused", {"fused_metrics": "on"}, False),
    ("compact", {"peak_compaction": "on", "band_slice": "off"}, True),
])
def test_probe_phases_launch_the_batch_variant(preps, variant, parallel,
                                               preprocessed):
    """Each variant's probes launch what ``score_batch`` launches (exact,
    bit for bit): ``fused_full`` gives its rows; the phases chained —
    ``extract``, ``moments``, then ``chaos``, ``correlation`` and
    ``pattern`` combined by ``msm_combine`` and un-permuted by the plan —
    give its rows too; and the ``extract`` block is the step's image block
    on the same tensors (``image_block``; on the fused variant the banded
    images of its histogram), hot-spot clipped when preprocessing is on."""
    from sm_distributed_tpu_torch.ops.imager import banded_images
    from sm_distributed_tpu_torch.ops.metrics import (
        hotspot_clip_batch,
        msm_combine,
    )

    _jprep, tprep = preps
    make = _port_backend_preprocessed if preprocessed else _port_backend
    tb = make(tprep, **parallel)
    t = tprep["batches"][1]
    rows = tb.score_batch(t)
    phases, info = tb.probe_phases(t)
    assert set(phases) == PHASES and info["variant"] == variant
    full = phases["fused_full"]()
    assert full[:t.n_ions].numpy().astype(np.float64).tobytes() == \
        rows.tobytes()

    plan = tb._flat_plan(t)
    want_block, _theor, n_valid = tb.image_block(t, plan)
    block = phases["extract"]()
    if variant == "fused":
        d = tb._device_plan(t, plan)
        n_pix = want_block.shape[-1]
        block = banded_images(block[:, :n_pix], d["starts"], d["r_lo_loc"],
                              d["r_hi_loc"], gc_width=d["gc_width"]).view(
            want_block.shape)
        valid = torch.arange(block.shape[1])[None, :] < n_valid[:, None]
        block.masked_fill_(~valid[:, :, None], 0.0)
    if preprocessed:
        hotspot_clip_batch(want_block, tb.q)
    assert block.numpy().tobytes() == want_block.numpy().tobytes()

    moments = phases["moments"]()
    got = msm_combine(phases["chaos"](), phases["correlation"](),
                      phases["pattern"](), n_valid, moments[3])
    inv = torch.from_numpy(plan.chunks[3].astype(np.int64))
    assert got[inv][:t.n_ions].numpy().astype(np.float64).tobytes() == \
        rows.tobytes()


def test_probe_phases_on_the_cube_path(preps):
    _jprep, tprep = preps
    tb = _port_backend(tprep, mz_chunk=64)
    t = tprep["batches"][0]
    phases, info = tb.probe_phases(t)
    assert set(phases) == {"fused_full"} and info == {"path": "mz_chunk"}
    assert phases["fused_full"]()[:t.n_ions].numpy().astype(
        np.float64).tobytes() == tb.score_batch(t).tobytes()


# -------------------------------------------------------------- the CLI
def test_cli_on_the_cpu_prints_the_documented_line(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setattr(tbench, "CACHE_DIR", tmp_path)
    rc = tbench.main(["--device", "cpu", "--nrows", "16", "--ncols", "16",
                      "--n-formulas", "8", "--reps", "1", "--floor-procs",
                      "1", "--skip-cold"])
    assert rc == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == tbench.LINE_KEYS
    assert out["device"] == "cpu" and out["n_ions"] == 168
    # off the card every device figure is null, and nothing launches
    for key in ("device_kind", "power_limit_w", "hbm_peak_bytes",
                "roofline_frac", "measured_roofline_frac"):
        assert out[key] is None, key
    assert set(out["kernel_launches"].values()) == {0}
    assert out["isocalc_cold_s"] is not None and out["value"] > 0
    assert out["kernel_nvcc_runs"] == 0
    assert (tmp_path / "traces").is_dir()
    assert out["trace_path"].startswith(str(tmp_path))


def test_cli_asks_for_a_card_that_is_not_there(tmp_path, monkeypatch):
    monkeypatch.setattr(tbench, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tbench.main(["--device", "cuda"])
    assert exc.value.code == 2
    assert not any(tmp_path.iterdir())


def test_cli_multichip_section_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``--devices 2`` meshes the last case over two devices (the CPU
    twice here): the JAX script's multichip keys, the card's beside them,
    and the sentinel bands the section."""
    from sm_distributed_tpu_torch.drivers import perf_sentinel

    monkeypatch.setattr(tbench, "CACHE_DIR", tmp_path)
    rc = tbench.main(["--device", "cpu", "--nrows", "16", "--ncols", "16",
                      "--n-formulas", "8", "--reps", "1", "--floor-procs",
                      "1", "--skip-cold", "--skip-isocalc-cold",
                      "--devices", "2"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mc = out["multichip"]
    assert set(mc) == {
        "case", "devices", "devices_requested", "mesh", "value", "unit",
        "jax_spread", "compile_s", "single_chip_ions_per_s",
        "single_chip_spread", "single_chip_compile_s",
        "speedup_vs_single_chip", "n_ions", "n_pixels", "hbm_peak_bytes",
        "device_kind", "power_limit_w"}
    assert mc["devices"] == 2 and mc["mesh"] == {"pixels": 2, "formulas": 1}
    assert mc["n_ions"] == out["n_ions"] and mc["value"] > 0
    norm = perf_sentinel.normalize(out)
    assert {"multichip.value", "multichip.speedup_vs_single_chip"} <= \
        set(norm)
