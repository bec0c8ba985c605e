"""The port's mesh-sharded scoring (``parallel/mesh.py``, ``sharded.py``)
against the single-device port and the JAX package.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
as ``tests/test_parallel.py`` runs it; the port's meshes on the CPU repeat
the CPU device, the counterpart of those virtual devices.  The fixture is
``tests/test_parallel.py``'s (10x14 pixels, 50 noise peaks, seed 31).

- the mesh helpers give the JAX package's answers on a table of cases;
- sharded scoring is BIT-EQUAL to the single-device port at meshes (8, 1),
  (4, 2) and (2, 4), for the plain, band and compact extraction variants,
  with the window restriction, hot-spot preprocessing, an ordered
  multi-batch stream and bf16 residents; int8 warns and scores as f32;
- against ``ShardedJaxBackend`` on the same mesh shapes: images and chaos
  bit-equal, spatial / spectral / msm within ``COMPONENT_CONTRACTS``
  (16 / 16 / 32 ulp) beyond the JAX package's own distance from the numpy
  oracle, FDR ranks identical;
- a search on a mesh, and one resumed from its checkpoint on another
  mesh, are bit-equal to the single-device search.
"""

from __future__ import annotations

import logging
import random
import types

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
from sm_distributed_tpu_torch.models import breaker, oom
from sm_distributed_tpu_torch.models.msm_basic import _slice_table
from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
from sm_distributed_tpu_torch.parallel import mesh as pmesh
from sm_distributed_tpu_torch.parallel.sharded import (
    ShardedTorchBackend,
    make_torch_backend,
)
from sm_distributed_tpu_torch.utils import failpoints
from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

torch.set_num_threads(1)

CONTRACT = {"chaos": 0, "spatial": 16, "spectral": 16, "msm": 32}
MESHES = [(8, 1), (4, 2), (2, 4)]
DS_DICT = {"isotope_generation": {"adducts": ["+H"]}}
# the JAX backends leave XLA's persistent compilation cache off (it is
# process-global once on)
NO_XLA_CACHE = "off"


@pytest.fixture(autouse=True)
def _reset_port_state():
    for reset in (failpoints.reset, breaker.reset_device_breaker, oom.reset):
        reset()
    yield
    for reset in (failpoints.reset, breaker.reset_device_breaker, oom.reset):
        reset()


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(jax dataset, port dataset, jax table, port table, fdr,
    assignment): 16 formulas +H with 2 decoys each (48 ions)."""
    from sm_distributed_tpu.ops.fdr import FDR
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper
    from sm_distributed_tpu.utils.config import IsotopeGenerationConfig

    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("dsp"), nrows=10, ncols=14,
        present_fraction=0.5, noise_peaks=50, seed=31)
    jds = JDataset.from_imzml(path)
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    formulas = list(truth.formulas[:16])
    fdr = FDR(decoy_sample_size=2, target_adducts=("+H",), seed=5)
    assignment = fdr.decoy_adduct_selection(formulas)
    pairs, flags = assignment.all_ion_tuples(formulas, ("+H",))
    table = IsocalcWrapper(IsotopeGenerationConfig(adducts=("+H",)),
                           n_procs=1).pattern_table(pairs, flags)
    tt = pattern_table_from_arrays(table.sfs, table.adducts, table.mzs,
                                   table.ints, table.n_valid, table.targets)
    return jds, tds, table, tt, fdr, assignment


def _sm(pix=None, form=None, **par):
    if pix is not None:
        par.update(pixels_axis=pix, formulas_axis=form)
    return SMConfig.from_dict({"device": "cpu",
                               "parallel": {"formula_batch": 32, **par}})


def _scores(backend, table, batch):
    return np.concatenate(backend.score_batches(
        [_slice_table(table, s, min(s + batch, table.n_ions))
         for s in range(0, table.n_ions, batch)]))


# ---------------------------------------------------------------- mesh helpers
AXIS_CASES = [(8, -1, 1), (8, -1, 2), (8, 2, -1), (8, -1, -1), (1, -1, 1),
              (8, 4, 2), (6, -1, 3), (8, -1, 3), (4, 8, 1), (8, 3, -1),
              (8, -2, 1), (8, 1, -3), (8, 0, 1)]


@pytest.mark.parametrize("n,pix,form", AXIS_CASES)
def test_resolve_axis_sizes_matches_jax(n, pix, form):
    from sm_distributed_tpu.parallel.mesh import resolve_axis_sizes as jres

    cfg = types.SimpleNamespace(pixels_axis=pix, formulas_axis=form)
    try:
        want = jres(n, cfg)
    except ValueError as exc:
        with pytest.raises(ValueError) as info:
            pmesh.resolve_axis_sizes(n, cfg)
        assert str(info.value) == str(exc)
    else:
        assert pmesh.resolve_axis_sizes(n, cfg) == want


def _fakes(n_proc=1, per_proc=8):
    return [types.SimpleNamespace(process_index=p, id=p * per_proc + i)
            for p in range(n_proc) for i in range(per_proc)]


@pytest.mark.parametrize("pix,form", MESHES + [(-1, 2), (2, -1), (1, 1)])
def test_make_mesh_matches_jax(pix, form):
    import jax

    from sm_distributed_tpu.parallel.mesh import make_mesh as jmake
    from sm_distributed_tpu.utils.config import ParallelConfig as JPar

    jmesh = jmake(JPar(pixels_axis=pix, formulas_axis=form),
                  devices=jax.devices()[:8])
    cfg = SMConfig.from_dict({"parallel": {"pixels_axis": pix,
                                           "formulas_axis": form}}).parallel
    got = pmesh.make_mesh(cfg, devices=_fakes())
    assert got.axis_names == jmesh.axis_names == ("pixels", "formulas")
    assert got.shape == dict(jmesh.shape)
    assert [d.id for d in got.devices.flat] == \
        [d.id for d in jmesh.devices.flat]
    # from the config on the CPU: the CPU as many times as the axes ask
    cpu = pmesh.make_mesh(cfg, device="cpu")
    assert cpu.size == max(1, pix) * max(1, form)
    assert set(cpu.devices.flat) == {torch.device("cpu")}


@pytest.mark.parametrize("indices,per_host", [
    (range(8), 4), ([6], 3), ([0, 5, 7], 2), ([], 4),
    (range(7), ((0, 4), (4, 7))), ([6], ((0, 4), (4, 7))),
    ([1, 9], ((0, 4), (4, 8))), ([2, 3], ((0, 1), (1, 2), (2, 4)))])
def test_host_topology_matches_jax(indices, per_host):
    from sm_distributed_tpu.parallel.mesh import host_topology as jtopo

    assert pmesh.host_topology(indices, per_host) == \
        jtopo(indices, per_host)


def test_global_device_order_matches_jax_under_permutation():
    from sm_distributed_tpu.parallel.mesh import global_device_order as jord

    devs = _fakes(n_proc=3, per_proc=4)
    want = jord(devs)
    for seed in range(5):
        shuffled = list(devs)
        random.Random(seed).shuffle(shuffled)
        assert pmesh.global_device_order(shuffled) == jord(shuffled) == want
    assert [d.process_index for d in want] == [0] * 4 + [1] * 4 + [2] * 4


@pytest.mark.parametrize("indices", [None, (0,), (0, 3), (2, 3, 4, 5),
                                     (6, 9, 12), (9,), (7, 7)])
def test_lease_devices_matches_jax(indices, caplog):
    import jax

    from sm_distributed_tpu.parallel.mesh import lease_devices as jlease

    want = jlease(indices)
    got = pmesh.lease_devices(indices, devices=_fakes())
    if want is None:
        assert got is None
    else:
        assert [d.id for d in got] == [d.id for d in want]
        assert len(jax.local_devices()) == 8
    # on the CPU every chip of a simulated pool is the CPU
    cpu = pmesh.lease_devices(indices, device="cpu")
    assert cpu == (None if indices is None
                   else [torch.device("cpu")] * len(indices))


def test_lease_across_processes_raises_naming_7b(monkeypatch):
    """In a 2-process runtime of 4 chips each (enumerated in a shuffled
    order), a lease maps through the pod's host-major order exactly as the
    JAX package's multi-process ``lease_devices`` does: this process's
    chips become its cards, by their place among its own chips, and the
    other process's chips ``RemoteChip``s carrying its index and id.  (No
    lease raises any more: the name is kept from the slice before the
    mesh spanning processes.)"""
    import jax

    from sm_distributed_tpu.parallel.mesh import lease_devices as jlease
    from sm_distributed_tpu_torch.parallel import distributed

    devs = _fakes(n_proc=2, per_proc=4)
    random.Random(3).shuffle(devs)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "devices", lambda: list(devs))
    for rank in (0, 1):
        monkeypatch.setattr(distributed, "world", lambda rank=rank: (rank, 2))
        for lease in [(1, 2), (3, 5), (4, 7), (0, 6), tuple(range(8)), (9,)]:
            want = jlease(lease)
            got = pmesh.lease_devices(lease, devices=devs)
            if want is None:
                assert got is None
                continue
            assert len(got) == len(want)
            for g, w in zip(got, want):
                if w.process_index == rank:
                    assert g == torch.device("cuda", w.id - 4 * rank)
                else:
                    assert g == pmesh.RemoteChip(w.process_index, w.id)
    monkeypatch.setattr(distributed, "world", lambda: (1, 2))
    assert pmesh.lease_devices((4, 7), devices=devs) == [
        torch.device("cuda", 0), torch.device("cuda", 3)]
    assert pmesh.lease_devices((3, 5), devices=devs) == [
        pmesh.RemoteChip(0, 3), torch.device("cuda", 1)]


# ---------------------------------------------- sharded = single-device, bits
VARIANTS = {"plain": {"band_slice": "off", "peak_compaction": "off"},
            "band": {"band_slice": "on"},
            "compact": {"band_slice": "off", "peak_compaction": "on"}}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("pix,form", MESHES)
def test_sharded_matches_single_device(fixture, pix, form, variant):
    _jds, tds, _table, tt, _fdr, _asg = fixture
    dc = DSConfig.from_dict(DS_DICT)
    knobs = VARIANTS[variant]
    sharded = make_torch_backend(tds, dc, _sm(pix, form, **knobs),
                                 restrict_table=tt)
    assert isinstance(sharded, ShardedTorchBackend)
    assert sharded.mesh.shape == {"pixels": pix, "formulas": form}
    single = TorchBackend(tds, dc, _sm(**knobs), restrict_table=tt)
    got = _scores(sharded, tt, sharded.batch)
    want = _scores(single, tt, sharded.batch)
    np.testing.assert_array_equal(got, want)
    assert sharded.variant_counts[variant] == 2
    assert sum(sharded.variant_counts.values()) == 2


def test_sharded_window_restriction_bit_exact(fixture):
    _jds, tds, _table, tt, _fdr, _asg = fixture
    dc = DSConfig.from_dict(DS_DICT)
    sm = _sm(4, 2)
    full = ShardedTorchBackend(tds, dc, sm)
    restricted = ShardedTorchBackend(tds, dc, sm, restrict_table=tt)
    assert restricted._mz_shards.shape[1] < full._mz_shards.shape[1]
    sub = _slice_table(tt, 0, 32)
    np.testing.assert_array_equal(restricted.score_batch(sub),
                                  full.score_batch(sub))


def test_sharded_with_preprocessing(fixture):
    _jds, tds, _table, tt, _fdr, _asg = fixture
    dc = DSConfig.from_dict({**DS_DICT,
                             "image_generation": {"do_preprocessing": True}})
    sub = _slice_table(tt, 0, 16)
    got = make_torch_backend(tds, dc, _sm(4, 2, formula_batch=16)
                             ).score_batch(sub)
    want = TorchBackend(tds, dc, _sm(formula_batch=16)).score_batch(sub)
    np.testing.assert_array_equal(got, want)


def test_sharded_ordered_stream_and_lattice_off(fixture):
    """An m/z-ordered stream of six batches, lattice on and off: each
    batch bit-equal to the single-device port's."""
    from sm_distributed_tpu_torch.models.msm_basic import order_table_by_mz

    _jds, tds, _table, tt, _fdr, _asg = fixture
    dc = DSConfig.from_dict(DS_DICT)
    ordered = order_table_by_mz(tt)
    for buckets in ("auto", "off"):
        sharded = make_torch_backend(
            tds, dc, _sm(2, 4, formula_batch=8, shape_buckets=buckets))
        single = TorchBackend(tds, dc, _sm(formula_batch=8,
                                           shape_buckets=buckets))
        batches = [_slice_table(ordered, s, s + 8)
                   for s in range(0, ordered.n_ions, 8)]
        sharded.warmup(batches)           # pre-sizes, scores one a variant
        assert sum(sharded.variant_counts.values()) >= 1
        np.testing.assert_array_equal(_scores(sharded, ordered, 8),
                                      _scores(single, ordered, 8))


def test_sharded_bf16_residents(fixture):
    _jds, tds, _table, tt, _fdr, _asg = fixture
    dc = DSConfig.from_dict(DS_DICT)
    sharded = make_torch_backend(tds, dc, _sm(4, 2, cube_dtype="bf16"),
                                 restrict_table=tt)
    assert sharded.cube_dtype == "bf16"
    assert all(t.dtype == torch.bfloat16
               for row in sharded._in for t in row.values())
    single = TorchBackend(tds, dc, _sm(cube_dtype="bf16"), restrict_table=tt)
    np.testing.assert_array_equal(_scores(sharded, tt, 32),
                                  _scores(single, tt, 32))


def test_int8_on_a_mesh_warns_and_scores_f32(fixture, caplog):
    _jds, tds, _table, tt, _fdr, _asg = fixture
    dc = DSConfig.from_dict(DS_DICT)
    with caplog.at_level(logging.WARNING):
        sharded = make_torch_backend(tds, dc, _sm(4, 2, cube_dtype="int8"))
    assert "cube_dtype=int8 is single-device only" in caplog.text
    assert sharded.cube_dtype == "f32"
    single = TorchBackend(tds, dc, _sm())
    sub = _slice_table(tt, 0, 32)
    np.testing.assert_array_equal(sharded.score_batch(sub),
                                  single.score_batch(sub))


def test_guards_give_the_jax_messages(fixture):
    from sm_distributed_tpu.parallel.sharded import ShardedJaxBackend
    from sm_distributed_tpu.utils.config import DSConfig as JDSConfig
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    jds, tds, *_ = fixture
    for par in ({"mz_chunk": 64, "formula_batch": 32},
                # a dataset whose per-shard scratch passes 8 GiB
                {"formula_batch": 1 << 22}):
        par = {**par, "pixels_axis": 2, "formulas_axis": 1}
        with pytest.raises(ValueError) as want:
            ShardedJaxBackend(jds, JDSConfig.from_dict(DS_DICT),
                              JSMConfig.from_dict({
                                  "parallel": {**par, "compile_cache_dir":
                                               NO_XLA_CACHE}}))
        with pytest.raises(ValueError) as got:
            ShardedTorchBackend(tds, DSConfig.from_dict(DS_DICT),
                                SMConfig.from_dict({"device": "cpu",
                                                    "parallel": par}))
        assert str(got.value) == str(want.value)


def test_shrink_batch_clamps_to_the_granule(fixture):
    from sm_distributed_tpu.parallel.sharded import ShardedJaxBackend
    from sm_distributed_tpu.utils.config import DSConfig as JDSConfig
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    jds, tds, *_ = fixture
    par = {"formula_batch": 64, "pixels_axis": 4, "formulas_axis": 2}
    jb = ShardedJaxBackend(jds, JDSConfig.from_dict(DS_DICT),
                           JSMConfig.from_dict({"parallel": {
                               **par, "compile_cache_dir": NO_XLA_CACHE}}))
    tb = ShardedTorchBackend(tds, DSConfig.from_dict(DS_DICT),
                             SMConfig.from_dict({"device": "cpu",
                                                 "parallel": par}))
    assert tb.batch == jb.batch == 64
    for want in (40, 100, 17, 3, 1):
        jb.shrink_batch(want)
        tb.shrink_batch(want)
        assert tb.batch == jb.batch and tb.batch % 8 == 0
    assert tb.batch == 8


def test_extract_ion_images_equals_numpy(fixture):
    from sm_distributed_tpu_torch.ops.imager_np import (
        SortedPeakView,
        extract_ion_images,
    )

    _jds, tds, _table, tt, _fdr, _asg = fixture
    dc = DSConfig.from_dict(DS_DICT)
    want = extract_ion_images(SortedPeakView.prepare(tds, 3.0), tt, 3.0)
    for pix, form in MESHES:
        got = make_torch_backend(tds, dc, _sm(pix, form)
                                 ).extract_ion_images(tt)
        assert got.shape == (tt.n_ions, tt.max_peaks, tds.n_pixels)
        np.testing.assert_array_equal(got, want)


def test_make_torch_backend_selects_by_lease(fixture):
    _jds, tds, *_ = fixture
    dc = DSConfig.from_dict(DS_DICT)
    sm = _sm()
    assert type(make_torch_backend(tds, dc, sm)) is TorchBackend
    assert type(make_torch_backend(tds, dc, sm, device_indices=(2,))) \
        is TorchBackend
    two = make_torch_backend(tds, dc, sm, device_indices=(0, 1))
    assert isinstance(two, ShardedTorchBackend)
    assert two.mesh.shape == {"pixels": 2, "formulas": 1}
    four = make_torch_backend(tds, dc, _sm(-1, 2), device_indices=(0, 1, 2, 3))
    assert four.mesh.shape == {"pixels": 2, "formulas": 2}
    one = make_torch_backend(tds, dc, sm, devices=[torch.device("cpu")] * 1)
    assert type(one) is TorchBackend


# ------------------------------------------------- against ShardedJaxBackend
@pytest.mark.parametrize("pix,form", MESHES)
def test_matches_sharded_jax_backend(fixture, pix, form):
    from sm_distributed_tpu.models.msm_basic import NumpyBackend
    from sm_distributed_tpu.parallel.mesh import make_mesh as jmake
    from sm_distributed_tpu.parallel.sharded import ShardedJaxBackend
    from sm_distributed_tpu.utils.config import DSConfig as JDSConfig
    from sm_distributed_tpu.utils.config import SMConfig as JSMConfig

    jds, tds, table, tt, fdr, assignment = fixture
    sm_dict = {"backend": "jax_tpu",
               "parallel": {"formula_batch": 32, "pixels_axis": pix,
                            "formulas_axis": form,
                            "compile_cache_dir": NO_XLA_CACHE}}
    jsm = JSMConfig.from_dict(sm_dict)
    jb = ShardedJaxBackend(jds, JDSConfig.from_dict(DS_DICT), jsm,
                           mesh=jmake(jsm.parallel), restrict_table=table)
    sm, dc = configs_from_dicts(sm_dict, DS_DICT, device="cpu")
    tb = make_torch_backend(tds, dc, sm, restrict_table=tt)
    assert tb.mesh.shape == dict(jb.mesh.shape) and tb.batch == jb.batch
    want = _scores(jb, table, jb.batch)
    got = _scores(tb, tt, tb.batch)
    oracle = _scores(NumpyBackend(jds, JDSConfig.from_dict(DS_DICT)), table,
                     32)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    for col, comp in enumerate(CONTRACT):
        jax_to_oracle = ulp_distance(want[:, col], oracle[:, col])
        to_jax = ulp_distance(got[:, col], want[:, col])
        assert (to_jax <= CONTRACT[comp] + jax_to_oracle).all(), \
            f"{comp}: {to_jax.max()} ulp from ShardedJaxBackend"
    np.testing.assert_array_equal(tb.extract_ion_images(tt),
                                  jb.extract_ion_images(table))

    def ranks(tab, metrics):
        df = pd.DataFrame({"sf": tab.sfs, "adduct": tab.adducts,
                           "msm": metrics[:, 3]})
        return fdr.estimate_fdr(df, assignment)

    pd.testing.assert_frame_equal(ranks(tt, got), ranks(table, want))


# --------------------------------------------------------------- the search
def _search(tds, formulas, sm, **kw):
    from sm_distributed_tpu_torch.models.msm_basic import MSMBasicSearch

    return MSMBasicSearch(tds, formulas, DSConfig.from_dict(DS_DICT), sm,
                          **kw)


def test_search_on_a_mesh_and_resume_on_another(fixture, tmp_path):
    """A search over a 2x2 mesh of repeated CPU devices equals the
    single-device search bit for bit; a checkpointed 2x2 search killed
    after its first group resumes on a 2x1 mesh, scoring only the rest,
    with the same bits."""
    from sm_distributed_tpu_torch.ops.metrics import batch_moments

    _jds, tds, table, _tt, _fdr, _asg = fixture
    formulas = sorted(set(table.sfs))[:12]
    base = {"fdr": {"decoy_sample_size": 2, "seed": 5},
            "parallel": {"formula_batch": 8, "isocalc_workers": 1,
                         "checkpoint_every": 1}, "device": "cpu"}
    want = _search(tds, formulas, SMConfig.from_dict(base)).search()
    cpu4 = [torch.device("cpu")] * 4
    sm22 = SMConfig.from_dict({**base, "parallel": {
        **base["parallel"], "pixels_axis": 2, "formulas_axis": 2}})
    meshed = _search(tds, formulas, sm22, devices=cpu4)
    got = meshed.search()
    assert isinstance(meshed.last_backend, ShardedTorchBackend)
    pd.testing.assert_frame_equal(got.all_metrics, want.all_metrics,
                                  check_exact=True)
    pd.testing.assert_frame_equal(got.annotations, want.annotations,
                                  check_exact=True)
    ck = tmp_path / "ck"
    failpoints.configure("device.score_batch=raise:RuntimeError@2")
    with pytest.raises(RuntimeError, match="device.score_batch"):
        _search(tds, formulas, sm22, devices=cpu4,
                checkpoint_dir=str(ck)).search()
    failpoints.configure(None)
    assert len(list(ck.glob("msm_search.p0.g*.ckpt.npz"))) == 1
    sm21 = SMConfig.from_dict({**base, "parallel": {
        **base["parallel"], "pixels_axis": 2, "formulas_axis": 1}})
    resumed = _search(tds, formulas, sm21, devices=cpu4[:2],
                      checkpoint_dir=str(ck))
    calls = []
    real = ShardedTorchBackend.score_batches
    try:
        ShardedTorchBackend.score_batches = \
            lambda self, tables, cancel=None: calls.append(1) or real(
                self, tables, cancel)
        bundle = resumed.search()
    finally:
        ShardedTorchBackend.score_batches = real
    assert resumed.last_backend.mesh.shape == {"pixels": 2, "formulas": 1}
    n_groups = -(-resumed.last_table.n_ions // 8)
    assert len(calls) == n_groups - 1
    pd.testing.assert_frame_equal(bundle.all_metrics, want.all_metrics,
                                  check_exact=True)
    pd.testing.assert_frame_equal(bundle.annotations, want.annotations,
                                  check_exact=True)
    assert batch_moments.launches == 0
