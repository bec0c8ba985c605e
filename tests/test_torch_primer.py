"""The port's bucket-spec registry and kernel-build primer against the JAX
package's.

- ``_SPEC_KEYS``, ``spec_key`` and the registry's behaviour (dedup, the
  write-through ``bucket_manifest.json``, ``load_manifest``, ``reset``)
  equal the JAX package's on the same specs; the specs one fixture records
  through ``JaxBackend(compile_cache_dir="off")`` and through
  ``TorchBackend(device="cpu")`` have equal keys on each variant both run.
- The primer (``service/primer.py``) is idempotent and resumable and
  yields to real work, as ``tests/test_buckets.py``'s primer tests hold
  the JAX primer, here over a stub toolchain: a fake ``nvcc`` that counts
  its runs and writes a library, a fake loader and a fake card (no CUDA
  here).  A changed kernel source shows every spec missing again.
- Skips: no card, too few cards, a legacy sharded spec (as the JAX
  package's); a card config on a machine with none is an error, not a
  skip; ``parallel.compile_cache_dir`` and ``bind_builds``, the one place a
  process points its builds; the ``prime_cache`` driver's summary line; the
  ``sm_prime_*`` families under the JAX names.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from sm_distributed_tpu.ops import buckets as jbuckets
from sm_distributed_tpu_torch.kernels import _build
from sm_distributed_tpu_torch.ops import buckets as tbuckets
from sm_distributed_tpu_torch.service import primer as tprimer
from sm_distributed_tpu_torch.utils.config import SMConfig
from tests.torch_fake_card import fake_card

ROOT = Path(__file__).resolve().parent.parent

@pytest.fixture(autouse=True)
def _clean_registry():
    tbuckets.reset()
    jbuckets.reset()
    yield
    tbuckets.reset()
    jbuckets.reset()


# ----------------------------------------------------------- the registry
def test_spec_keys_equal_the_jax_packages():
    assert tbuckets._SPEC_KEYS == jbuckets._SPEC_KEYS
    spec = {"kind": "flat", "variant": "band", "nrows": 10, "ncols": 11,
            "q": 99.0, "w_cap": 2 << 21, "cube_dtype": "bf16"}
    assert tbuckets.spec_key(spec) == jbuckets.spec_key(spec)
    assert tbuckets.spec_key({}) == jbuckets.spec_key({})


def test_registry_and_manifest_equal_the_jax_packages(tmp_path):
    specs = [{"kind": "flat", "variant": v, "b": b} for v in
             ("plain", "band") for b in (8, 16)]

    def run(mod, d):
        mod.reset()
        out = [mod.record_spec(s) for s in specs + specs[:1]]
        mod.bind_manifest_dir(d)
        out.append(mod.record_spec({"kind": "sharded", "devices": 2}))
        out.append(json.loads((d / "bucket_manifest.json").read_text()))
        out.append(mod.load_manifest(d))
        out.append(mod.recorded_specs())
        mod.reset()
        out.append(mod.recorded_specs())
        mod.bind_manifest_dir(d)          # a new process folds it back in
        out.append(len(mod.recorded_specs()))
        out.append(mod.load_manifest(d / "absent"))
        return out

    assert run(tbuckets, tmp_path / "t") == run(jbuckets, tmp_path / "j")


def _offgrid(tmp_path):
    from sm_distributed_tpu.io.dataset import SpectralDataset
    from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig

    path, truth = generate_synthetic_dataset(
        tmp_path / "ds", nrows=9, ncols=11, formulas=None,
        present_fraction=0.5, noise_peaks=12, seed=41)
    calc = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H",)))
    table = calc.pattern_table([(sf, "+H") for sf in truth.formulas[:14]])
    return SpectralDataset.from_imzml(path), table


def _record_torch(jds, table, par: dict, device: str = "cpu") -> None:
    """Score the fixture through the port's backend (it records as it
    dispatches)."""
    from sm_distributed_tpu_torch.convert import (
        configs_from_dicts,
        dataset_from_arrays,
        pattern_table_from_arrays,
    )
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table
    from sm_distributed_tpu_torch.models.msm_torch import TorchBackend

    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    tt = pattern_table_from_arrays(table.sfs, table.adducts, table.mzs,
                                   table.ints, table.n_valid, table.targets)
    sm, dc = configs_from_dicts({"parallel": par},
                                {"isotope_generation": {"adducts": ["+H"]}},
                                device=device)
    tb = TorchBackend(tds, dc, sm)
    tb.score_batches([_slice_table(tt, s, min(s + 8, tt.n_ions))
                      for s in range(0, tt.n_ions, 8)])


@pytest.mark.parametrize("mode", [
    {"peak_compaction": "off", "band_slice": "off"},
    {"peak_compaction": "on", "band_slice": "off"},
    {"peak_compaction": "off", "band_slice": "on"},
], ids=["plain", "compact", "band"])
def test_recorded_spec_keys_equal_the_jax_backends(tmp_path, mode):
    """The same batches on the same variant record specs with equal keys
    in both packages (the JAX backend with its fused path off, so both run
    the variant the mode names)."""
    from sm_distributed_tpu.models.msm_basic import _slice_table
    from sm_distributed_tpu.models.msm_jax import JaxBackend
    from sm_distributed_tpu.utils.config import DSConfig, SMConfig as JSC

    jds, table = _offgrid(tmp_path)
    par = {"formula_batch": 8, "fused_metrics": "off", **mode}
    jb = JaxBackend(jds, DSConfig.from_dict(
        {"isotope_generation": {"adducts": ["+H"]}}), JSC.from_dict(
        {"backend": "jax_tpu",
         "parallel": {**par, "compile_cache_dir": "off"}}))
    jb.score_batches([_slice_table(table, s, min(s + 8, table.n_ions))
                      for s in range(0, table.n_ions, 8)])
    _record_torch(jds, table, par)
    want = sorted(jbuckets.spec_key(s) for s in jbuckets.recorded_specs())
    got = sorted(tbuckets.spec_key(s) for s in tbuckets.recorded_specs())
    assert got == want and len(got) >= 1
    assert {s["variant"] for s in tbuckets.recorded_specs()} == {
        "compact" if mode["peak_compaction"] == "on" else
        "band" if mode["band_slice"] == "on" else "plain"}


# --------------------------------------------------------------- the primer
@pytest.fixture()
def recorded(tmp_path):
    """Specs recorded by the port's backend on the CPU (plain and band
    variants: two specs), and a card config whose builds and manifests
    live under tmp_path."""
    jds, table = _offgrid(tmp_path)
    for mode in ({"peak_compaction": "off", "band_slice": "off"},
                 {"peak_compaction": "off", "band_slice": "on"}):
        _record_torch(jds, table, {"formula_batch": 8, **mode})
    specs = tbuckets.recorded_specs()
    sm = SMConfig.from_dict({
        "device": "cuda",
        "parallel": {"compile_cache_dir": str(tmp_path / "kernels")}})
    return sm, specs, tmp_path


def test_primer_idempotent_and_resumable(recorded, monkeypatch):
    """One prime pass builds, loads and sets up each recorded spec's
    kernels; an interrupted pass (max_specs=1) resumes from the persisted
    prime manifest; a repeat pass is a no-op.  nvcc runs once a library:
    the two specs launch the same two kernels."""
    sm, specs, tmp = recorded
    log = fake_card(monkeypatch, tmp)
    assert len(specs) == 2
    p1 = tprimer.CachePrimer(sm, busy=lambda: False)
    res1 = p1.prime_once(max_specs=1)
    assert res1 == {"primed": 1, "skipped": 0, "errors": 0,
                    "aborted": True, "built": 2}
    p2 = tprimer.CachePrimer(sm, busy=lambda: False)   # a fresh process
    res2 = p2.prime_once()
    assert res2 == {"primed": 1, "skipped": 1, "errors": 0,
                    "aborted": False, "built": 0}
    snap = p2.snapshot()
    assert snap["known"] == snap["primed"] == 2 and snap["missing"] == 0
    assert {b["status"] for b in snap["buckets"]} == {"primed"}
    res3 = p2.prime_once()
    assert res3["primed"] == 0 and res3["errors"] == 0 and res3["built"] == 0
    manifest = json.loads((tmp / "kernels" / "prime_manifest.json")
                          .read_text())
    assert len(manifest["primed"]) == 2
    assert sorted(Path(p).name for p in log.read_text().split()) == [
        "chaos.cu", "moments.cu"]
    # set up on the card once per (kernel, device), loaded once each
    assert _build._setups == {("moments", "cuda:0"): 1,
                              ("chaos", "cuda:0"): 1}


def test_primer_yields_to_real_work(recorded, monkeypatch):
    """A busy service aborts the cycle at the next spec boundary without
    building anything (and the primer takes no device-pool lease: it has
    none to take)."""
    sm, _specs, tmp = recorded
    log = fake_card(monkeypatch, tmp)
    res = tprimer.CachePrimer(sm, busy=lambda: True).prime_once()
    assert res["aborted"] is True and res["primed"] == 0
    assert res["built"] == 0 and log.read_text() == ""


def test_changed_source_shows_specs_missing(recorded, monkeypatch):
    """The prime manifest is keyed on a hash of the kernel sources: an
    edited source shows every spec missing, and the next cycle rebuilds
    only the edited kernel's library."""
    sm, specs, tmp = recorded
    log = fake_card(monkeypatch, tmp)
    p = tprimer.CachePrimer(sm, busy=lambda: False)
    p.prime_once()
    assert p.snapshot()["missing"] == 0
    src = _build.CSRC / "chaos.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    snap = p.snapshot()
    assert snap["primed"] == 0 and snap["missing"] == len(specs)
    res = p.prime_once()
    assert res["primed"] == len(specs) and res["built"] == 1
    assert [Path(x).name for x in log.read_text().split()].count(
        "chaos.cu") == 2


def test_deleted_library_shows_its_specs_missing(recorded, monkeypatch):
    sm, _specs, tmp = recorded
    fake_card(monkeypatch, tmp)
    p = tprimer.CachePrimer(sm, busy=lambda: False)
    p.prime_once()
    _build._library_path("moments").unlink()
    assert p.snapshot()["primed"] == 0
    assert p.prime_once()["built"] == 1


def test_a_failed_build_counts_an_error(recorded, monkeypatch):
    from sm_distributed_tpu_torch.service.metrics import MetricsRegistry

    sm, specs, tmp = recorded
    fake_card(monkeypatch, tmp)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/bin/false")
    m = MetricsRegistry()
    res = tprimer.CachePrimer(sm, busy=lambda: False,
                              metrics=m).prime_once()
    assert res["errors"] == len(specs) and res["primed"] == 0
    assert f"sm_prime_errors_total {len(specs)}" in m.expose()


@pytest.mark.parametrize("case,want", [
    ("cpu_device", "skipped:cpu"),
    ("numpy_ref", "skipped:cpu"),
    ("two_cards", "skipped:devices"),
    ("legacy_sharded", "skipped:legacy_spec"),
    ("chunked", "skipped:chunked"),
])
def test_prime_spec_skips(tmp_path, monkeypatch, case, want):
    """Named skips: nothing to build off the card, too few cards for a
    sharded spec's lease, a sharded spec recorded before its topology
    fields (as the JAX package's ``prime_spec`` says), a kind the primer
    does not prime."""
    from sm_distributed_tpu.service import primer as jprimer

    spec = {"kind": "flat", "variant": "plain", "nrows": 8, "ncols": 8,
            "nlevels": 30, "devices": 1}
    sm = {"device": "cuda"}
    if case == "cpu_device":
        sm = {"device": "cpu"}
    elif case == "numpy_ref":
        sm = {"backend": "numpy_ref", "device": "cuda"}
    elif case == "two_cards":
        spec = {**spec, "kind": "sharded", "devices": 2, "mesh_pix": 2,
                "mesh_form": 1, "p_loc": 32, "w": 64, "k": 4, "g": 128,
                "c": 2, "wc": 128}
    elif case == "legacy_sharded":
        spec = {**spec, "kind": "sharded", "devices": 2}
        assert jprimer.prime_spec(spec) == want    # the JAX package's
    elif case == "chunked":
        spec = {**spec, "kind": "chunked"}
        assert jprimer.prime_spec(spec) == want
    fake_card(monkeypatch, tmp_path)
    assert tprimer.prime_spec(spec, SMConfig.from_dict(sm)) == want
    assert _build.nvcc_runs == 0


def test_spec_kernels_follow_the_variant_and_the_chaos_route():
    spec = {"variant": "plain", "nrows": 256, "ncols": 256, "nlevels": 30}
    assert tprimer.spec_kernels(spec) == ("moments", "chaos")
    assert tprimer.spec_kernels({**spec, "variant": "fused"}) == (
        "fused_moments", "chaos")
    assert tprimer.spec_kernels({**spec, "nrows": 512, "ncols": 512}) == (
        "moments", "chaos_strips")
    assert tprimer.spec_kernels({**spec, "nrows": 1024,
                                 "ncols": 1024}) == ("moments",
                                                     "chaos_strips")


def test_primer_on_a_cpu_service_builds_nothing(recorded):
    """A service off the card skips every spec by name and writes no
    manifest beside the default build directory."""
    _sm, specs, tmp = recorded
    sm = SMConfig.from_dict({"device": "cpu", "parallel": {
        "compile_cache_dir": str(tmp / "kernels")}})
    p = tprimer.CachePrimer(sm, busy=lambda: False)
    res = p.prime_once()
    assert res == {"primed": 0, "skipped": len(specs), "errors": 0,
                   "aborted": False, "built": 0}
    assert {b["status"] for b in p.snapshot()["buckets"]} == {"skipped:cpu"}


def test_prime_families_equal_the_jax_packages(tmp_path):
    from sm_distributed_tpu.service.metrics import MetricsRegistry as JM
    from sm_distributed_tpu.service.primer import CachePrimer as JP
    from sm_distributed_tpu.utils.config import SMConfig as JSC
    from sm_distributed_tpu_torch.service.metrics import MetricsRegistry

    def families(text: str) -> set:
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE sm_prime_")}

    jm, tm = JM(), MetricsRegistry()
    JP(JSC.from_dict({"work_dir": str(tmp_path / "w"), "parallel": {
        "compile_cache_dir": str(tmp_path / "x")}}), metrics=jm)
    tprimer.CachePrimer(SMConfig.from_dict({"device": "cpu", "parallel": {
        "compile_cache_dir": str(tmp_path / "k")}}), metrics=tm)
    assert families(tm.expose()) == families(jm.expose())
    assert len(families(tm.expose())) == 7


@pytest.mark.parametrize("value,want", [
    ("", _build.DEFAULT_BUILD_DIR), ("/srv/kernels", Path("/srv/kernels"))])
def test_compile_cache_dir_names_the_build_directory(value, want):
    sm = SMConfig.from_dict({"parallel": {"compile_cache_dir": value}})
    assert _build.build_dir_for(sm) == want


def test_compile_cache_dir_off_raises_saying_what_it_would_mean():
    with pytest.raises(ValueError, match="no kernel build directory"):
        SMConfig.from_dict({"parallel": {"compile_cache_dir": "off"}})


def test_prime_cache_driver_prints_one_summary_line(tmp_path):
    """The offline driver, as a user runs it on the CPU: nothing known ->
    exit 2; a spec given on a ``device: "cpu"`` config -> one JSON line,
    skipped, exit 0; the same spec on the default (card) config with no
    card -> counted as an error, exit 1."""
    cpu = tmp_path / "cpu.json"
    cpu.write_text(json.dumps({"device": "cpu"}))
    cmd = [sys.executable, "-m", "sm_distributed_tpu_torch.drivers.prime_cache",
           "--cache-dir", str(tmp_path / "k")]
    empty = subprocess.run(cmd + ["--sm-config", str(cpu)], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    assert empty.returncode == 2, empty.stderr[-2000:]
    assert json.loads(empty.stdout.strip().splitlines()[-1])["known"] == 0
    spec = json.dumps({"kind": "flat", "variant": "plain", "nrows": 8,
                       "ncols": 8, "nlevels": 30, "devices": 1})
    out = subprocess.run(cmd + ["--sm-config", str(cpu), "--spec", spec],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == {"known": 1, "primed": 0, "skipped": 1,
                                    "errors": 0, "built": 0,
                                    "cache_dir": str(tmp_path / "k")}
    card = subprocess.run(cmd + ["--spec", spec], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert card.returncode == 1, card.stderr[-2000:]
    assert json.loads(card.stdout.strip().splitlines()[-1])["errors"] == 1
    assert "no CUDA card is visible" in card.stderr


def test_sharded_backend_records_its_lease_shape(tmp_path):
    """A mesh search records a ``sharded`` spec naming its lease shape,
    under the same keys."""
    from sm_distributed_tpu_torch.convert import (
        configs_from_dicts,
        dataset_from_arrays,
        pattern_table_from_arrays,
    )
    from sm_distributed_tpu_torch.models.msm_basic import _slice_table
    from sm_distributed_tpu_torch.parallel.sharded import ShardedTorchBackend

    jds, table = _offgrid(tmp_path)
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    tt = pattern_table_from_arrays(table.sfs, table.adducts, table.mzs,
                                   table.ints, table.n_valid, table.targets)
    sm, dc = configs_from_dicts(
        {"parallel": {"formula_batch": 8, "pixels_axis": 2,
                      "formulas_axis": 1}},
        {"isotope_generation": {"adducts": ["+H"]}}, device="cpu")
    sb = ShardedTorchBackend(tds, dc, sm)
    sb.score_batches([_slice_table(tt, 0, 8)])
    (spec,) = tbuckets.recorded_specs()
    # a 2x1 mesh of one device (the CPU): one card's lease, as a mesh that
    # repeats a card records; the JAX mesh size counts distinct devices
    assert sb.mesh.size == 2 and len(sb.mesh.distinct()) == 1
    assert spec["kind"] == "sharded" and spec["devices"] == 1
    assert (spec["mesh_pix"], spec["mesh_form"]) == (2, 1)
    assert set(spec) <= set(tbuckets._SPEC_KEYS)
    assert tprimer.prime_spec(spec, sm) == "skipped:cpu"


def test_a_card_config_without_a_card_is_an_error(monkeypatch):
    """No quiet skip: a service configured to score on the card, on a
    machine with none, fails each spec (the cycle counts it under
    ``errors``)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"kind": "flat", "variant": "plain", "nrows": 8, "ncols": 8,
            "nlevels": 30, "devices": 1}
    with pytest.raises(_build.KernelError, match="no CUDA card is visible"):
        tprimer.prime_spec(spec, SMConfig.from_dict({"device": "cuda"}))


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_bind_builds_is_the_one_place_builds_are_pointed(
        tmp_path, monkeypatch, device):
    """``bind_builds`` points the process's builds and its bucket manifest
    at ``parallel.compile_cache_dir`` on a card config and at nothing on a
    CPU one; constructing a backend or a primer repoints nothing."""
    fake_card(monkeypatch, tmp_path)
    sm = SMConfig.from_dict({"device": device, "parallel": {
        "compile_cache_dir": str(tmp_path / "kernels")}})
    jds, table = _offgrid(tmp_path)
    _record_torch(jds, table, {"formula_batch": 8,
                               "compile_cache_dir": str(tmp_path / "other")})
    tprimer.CachePrimer(SMConfig.from_dict({"device": "cuda", "parallel": {
        "compile_cache_dir": str(tmp_path / "other")}}))
    assert _build.BUILD_DIR == tmp_path / "build"
    assert not (tmp_path / "other" / "bucket_manifest.json").exists()
    assert tprimer.bind_builds(sm) == tmp_path / "kernels"
    manifest = tmp_path / "kernels" / "bucket_manifest.json"
    tbuckets.record_spec({"kind": "flat", "variant": "plain", "b": 99})
    if device == "cuda":
        assert _build.BUILD_DIR == tmp_path / "kernels"
        assert manifest.exists()
        _build.build_all(("moments",))
        assert _build._library_path("moments").parent == tmp_path / "kernels"
    else:
        assert _build.BUILD_DIR == tmp_path / "build"
        assert not manifest.exists()
