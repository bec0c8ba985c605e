"""Search resilience in the port against the JAX package, on the CPU.

Port copies of ``tests/test_oom.py``, ``tests/test_faults.py`` and the
checkpoint cases of ``tests/test_chaos_recovery.py``, run on the port's
``torch_cuda`` backend with ``device="cpu"`` (its plain versions), plus:

- the program-fault class the port adds to the taxonomy: a real
  ``KernelError`` and a CUDA device-side-assert error re-raise at once and
  count nothing on the breaker;
- a real ``torch.OutOfMemoryError`` backed off from with the same bits, the
  failed attempt's frames released before the halved retry;
- the port's ``_fingerprint`` / ``_fingerprint_pairs`` equal to the JAX
  package's on the same search, and checkpoints that resume across the two
  packages in both directions;
- the open breaker in the port: the JAX package degrades the job to its
  numpy oracle, the port never moves device work to the host.  A sticky
  fault that opens it fails the job with ``DeviceUnavailableError``, jobs
  are refused while it stays open, and a half-open probe after the
  cooldown closes it and resumes from the checkpoint the failed job left;
  ``numpy_ref`` scores when the config names it, open breaker or not.

Tolerance: bit-equality throughout (OOM backoff, resume, probe, and the
``numpy_ref`` search against itself); the breaker's state machine step for
step against the JAX package's.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
import zlib

import numpy as np
import pandas as pd
import pytest
import torch

from sm_distributed_tpu.io.dataset import SpectralDataset as JDataset
from sm_distributed_tpu.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.convert import dataset_from_arrays
from sm_distributed_tpu_torch.kernels._build import KernelError
from sm_distributed_tpu_torch.models import breaker as breaker_mod
from sm_distributed_tpu_torch.models.breaker import DeviceUnavailableError
from sm_distributed_tpu_torch.models import faults, oom
from sm_distributed_tpu_torch.models.msm_basic import (
    MSMBasicSearch,
    SearchCheckpoint,
)
from sm_distributed_tpu_torch.models.msm_torch import TorchBackend
from sm_distributed_tpu_torch.utils import failpoints
from sm_distributed_tpu_torch.utils.config import DSConfig, SMConfig

torch.set_num_threads(1)

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

DS_DICT = {"isotope_generation": {"adducts": ["+H"]}}
COLS = ["chaos", "spatial", "spectral", "msm"]


@pytest.fixture(autouse=True)
def _reset_port_state():
    """The port's process-global fault state, isolated between tests."""
    for reset in (failpoints.reset, breaker_mod.reset_device_breaker,
                  oom.reset):
        reset()
    yield
    for reset in (failpoints.reset, breaker_mod.reset_device_breaker,
                  oom.reset):
        reset()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``tests/test_oom.py``'s fixture: an 8x8 dataset, 4 formulas +H with
    2 decoys each (12 ions, 2 batches of 8)."""
    path, truth = generate_synthetic_dataset(
        tmp_path_factory.mktemp("ds"), nrows=8, ncols=8, formulas=None,
        present_fraction=0.5, noise_peaks=30, seed=11)
    jds = JDataset.from_imzml(path)
    tds = dataset_from_arrays(jds.nrows, jds.ncols, jds.pixel_inds, jds.mask,
                              jds.mzs_flat, jds.ints_flat, jds.row_ptr)
    return jds, tds, truth


def _sm(tmp_path, **over) -> SMConfig:
    d = {"backend": "torch_cuda", "device": "cpu",
         "fdr": {"decoy_sample_size": 2, "seed": 1},
         "parallel": {"formula_batch": 8, "overlap_isocalc": "off"},
         "service": {"breaker_threshold": 1},
         "work_dir": str(tmp_path / "work")}
    for k, v in over.items():
        d[k] = {**d[k], **v} if isinstance(d.get(k), dict) else v
    return SMConfig.from_dict(d)


def _search(tds, truth, sm, **kw):
    return MSMBasicSearch(tds, truth.formulas[:4], DSConfig.from_dict(DS_DICT),
                          sm, **kw)


def _frames_equal(a, b) -> None:
    pd.testing.assert_frame_equal(a.annotations, b.annotations,
                                  check_exact=True)
    pd.testing.assert_frame_equal(a.all_metrics, b.all_metrics,
                                  check_exact=True)


# ------------------------------------------------------------ classification
def test_is_oom_classification():
    from sm_distributed_tpu.models import oom as joom

    cases = [MemoryError("boom"),
             RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying "
                          "to allocate 2147483648 bytes"),
             Exception("XlaRuntimeError: Resource exhausted"),
             RuntimeError("device tunnel died"), ValueError("bad shape")]
    for exc in cases:
        assert oom.is_oom_error(exc) == joom.is_oom_error(exc), exc
    assert [oom.is_oom_error(e) for e in cases] == [True, True, True, False,
                                                    False]
    # the card's shapes: the caching allocator's exception (a RuntimeError)
    # and cuBLAS's workspace allocation failure
    assert oom.is_oom_error(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert issubclass(torch.OutOfMemoryError, RuntimeError)
    assert oom.is_oom_error(RuntimeError(
        "CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling "
        "`cublasCreate(handle)`"))


def test_safe_batch_registry_roundtrip():
    from sm_distributed_tpu.models import oom as joom

    key = oom.shape_key(4096, "torch_cuda", (0, 1))
    assert key == joom.shape_key(4096, "torch_cuda", (0, 1))
    assert oom.shape_key(5000, "x") == joom.shape_key(5000, "x")
    assert oom.safe_batch_for(key) is None
    oom.record_safe_batch(key, 512)
    assert oom.safe_batch_for(key) == 512
    assert oom.safe_batch_for(oom.shape_key(4096, "torch_cuda", None)) is None
    snap = oom.snapshot()
    assert snap["recoveries"] == 1 and snap["safe_batches"] == {key: 512}
    oom.reset()
    assert oom.safe_batch_for(key) is None


# ------------------------------------------------------------- real searches
class _Scratch:
    """Stands for the device scratch a failed attempt's frame holds."""


@pytest.mark.parametrize("how", ["torch_oom", "failpoint"])
def test_oom_backoff_bit_identical_and_breaker_closed(tiny, tmp_path,
                                                      monkeypatch, how):
    """An OOM halves the batch and rescores in place: results bit-identical
    to the untouched run, the breaker (threshold 1) never opens, and the
    converged size lands in the safe-batch registry.  ``torch_oom`` raises
    a real ``torch.OutOfMemoryError`` whenever the padding batch exceeds 4,
    from a frame holding a stand-in for its scratch, and checks that the
    halved retry starts after that frame is released."""
    _jds, tds, truth = tiny
    sm = _sm(tmp_path)
    clean = _search(tds, truth, sm).search()
    assert breaker_mod.get_device_breaker().state == "closed"
    oom.reset()
    held, retried_after_release = [], []
    if how == "failpoint":
        failpoints.configure("backend.device_error=raise:MemoryError@1")
    else:
        orig = TorchBackend._dispatch

        def dispatch(self, table, plan=None, variant=None):
            if held:
                retried_after_release.append(held[-1]() is None)
            if self.batch > 4:
                scratch = _Scratch()
                held.append(weakref.ref(scratch))
                raise torch.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB")
            return orig(self, table, plan, variant)

        monkeypatch.setattr(TorchBackend, "_dispatch", dispatch)
    gc.disable()          # frames must go by reference count alone
    try:
        backed_off = _search(tds, truth, sm).search()
    finally:
        gc.enable()
    _frames_equal(backed_off, clean)
    assert breaker_mod.get_device_breaker().state == "closed"
    assert breaker_mod.refused_count() == 0
    snap = oom.snapshot()
    assert snap["events"] >= 1 and snap["recoveries"] >= 1
    key = oom.shape_key(tds.n_pixels, "torch_cuda", None)
    assert oom.safe_batch_for(key) == 4   # 8-ion slices halved once
    if how == "torch_oom":
        assert len(held) == 1 and retried_after_release \
            and all(retried_after_release)


def test_learned_safe_batch_reused_by_next_job(tiny, tmp_path):
    _jds, tds, truth = tiny
    sm = _sm(tmp_path)
    failpoints.configure("backend.device_error=raise:MemoryError@1")
    _search(tds, truth, sm).search()
    failpoints.configure(None)
    events_before = oom.snapshot()["events"]
    again = _search(tds, truth, sm)
    again.search()
    assert again._batch_eff == 4          # started at the learned size
    assert again.last_backend.batch <= 4  # device padding capped too
    assert oom.snapshot()["events"] == events_before


def test_oom_at_single_ion_batch_fails_without_breaker(tiny, tmp_path):
    """An OOM down to a 1-ion batch is a real failure for the retry policy,
    never a breaker count."""
    _jds, tds, truth = tiny
    failpoints.configure("backend.device_error=raise:MemoryError")
    with pytest.raises(MemoryError, match="backend.device_error"):
        _search(tds, truth, _sm(tmp_path)).search()
    assert breaker_mod.get_device_breaker().state == "closed"
    assert oom.safe_batch_for(
        oom.shape_key(tds.n_pixels, "torch_cuda", None)) is None


def test_non_oom_device_error_still_feeds_breaker(tiny, tmp_path):
    """A sticky RuntimeError at the same seam opens the threshold-1
    breaker and the job fails with ``DeviceUnavailableError``, counted;
    the next job is refused before it builds a backend."""
    _jds, tds, truth = tiny
    failpoints.configure("backend.device_error=raise:RuntimeError@1")
    with pytest.raises(DeviceUnavailableError) as info:
        _search(tds, truth, _sm(tmp_path)).search()
    assert "backend.device_error" in str(info.value.__cause__)
    assert breaker_mod.get_device_breaker().state == "open"
    assert breaker_mod.refused_count() == 1
    failpoints.configure(None)
    refused = _search(tds, truth, _sm(tmp_path))
    with pytest.raises(DeviceUnavailableError, match="refused"):
        refused.search()
    assert refused.last_backend is None
    assert breaker_mod.refused_count() == 2


# ------------------------------------------------------------ fault taxonomy
def test_classification_matrix():
    """The JAX package's matrix: OOM and transient cases classify alike;
    of its sticky cases, the injected one stays sticky and the ones that
    name neither the device nor an injection are program faults here."""
    from sm_distributed_tpu.models import faults as jfaults

    same = [MemoryError("boom"),
            RuntimeError("RESOURCE_EXHAUSTED: Out of memory while trying to "
                         "allocate 2147483648 bytes"),
            TimeoutError("rpc"), ConnectionError("peer"),
            RuntimeError("DEADLINE_EXCEEDED: collective all-reduce timed out "
                         "after 120s"),
            RuntimeError("UNAVAILABLE: socket closed"),
            OSError("device tunnel died: connection reset"),
            RuntimeError("injected failpoint backend.chip_fault (hit 1)")]
    for exc in same:
        assert faults.classify(exc) == jfaults.classify(exc), exc
    assert faults.classify(RuntimeError(
        "injected failpoint backend.chip_fault (hit 1)")) == faults.FAULT_STICKY
    for exc in (RuntimeError("INTERNAL: failed to enqueue program"),
                ValueError("bad shape")):
        assert jfaults.classify(exc) == jfaults.FAULT_STICKY
        assert faults.classify(exc) == faults.FAULT_PROGRAM, exc


@pytest.mark.parametrize("exc,kind", [
    (KernelError("nvcc failed for csrc/moments.cu:\nerror"), "program"),
    (KernelError("sm_moments: no thread-block cluster of this shape fits "
                 "the device (cudaOccupancyMaxActiveClusters)"), "program"),
    (KernelError("sm_chaos_smem: CUDA error 700"), "program"),
    (RuntimeError("CUDA error: device-side assert triggered"), "program"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "program"),
    (RuntimeError("CUDA error: misaligned address"), "program"),
    (RuntimeError("CUDA error: invalid configuration argument"), "program"),
    (RuntimeError("CUDA error: no kernel image is available for execution "
                  "on the device"), "program"),
    (RuntimeError("CUDA error: too many resources requested for launch"),
     "program"),
    (RuntimeError("CUDA error: an illegal instruction was encountered"),
     "program"),
    (RuntimeError("CUDA error: unspecified launch failure"), "program"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     "sticky"),
    (RuntimeError("CUDA error: unknown error"), "sticky"),
    (torch.OutOfMemoryError("CUDA out of memory."), "oom"),
])
def test_program_and_device_fault_classes(exc, kind):
    assert faults.classify(exc) == kind


@pytest.mark.parametrize("error", [
    KernelError("nvcc failed for csrc/chaos.cu:\nerror: expected ';'"),
    RuntimeError("CUDA error: device-side assert triggered"),
])
def test_program_fault_reraised_without_breaker(tiny, tmp_path, monkeypatch,
                                                error):
    """A program fault inside the device scoring call re-raises at once:
    the threshold-1 breaker counts nothing, nothing is refused, and the
    same fault on every later search keeps raising as itself."""
    _jds, tds, truth = tiny

    def broken(self, table, plan=None, variant=None):
        raise error

    monkeypatch.setattr(TorchBackend, "_dispatch", broken)
    for _ in range(3):
        with pytest.raises(type(error)):
            _search(tds, truth, _sm(tmp_path)).search()
    assert breaker_mod.get_device_breaker().snapshot()["failures"] == 0
    assert breaker_mod.get_device_breaker().state == "closed"
    assert breaker_mod.refused_count() == 0


def test_transient_error_does_not_feed_breaker(tiny, tmp_path):
    _jds, tds, truth = tiny
    sm = _sm(tmp_path)
    failpoints.configure("backend.chip_fault=raise:ConnectionError")
    with pytest.raises(ConnectionError, match="backend.chip_fault"):
        _search(tds, truth, sm).search()
    assert breaker_mod.get_device_breaker().state == "closed"
    failpoints.configure(None)
    failpoints.configure("backend.chip_fault=raise:RuntimeError@1")
    with pytest.raises(DeviceUnavailableError):
        _search(tds, truth, sm).search()
    assert breaker_mod.get_device_breaker().state == "open"


# the JAX package's breaker, driven step by step: "f" a sticky failure
# (returns whether the breaker is open), "s" a clean group, "a" the device
# admission (allow_device), "0" the cooldown set to 0 s
@pytest.mark.parametrize("steps", [
    "fffa",            # threshold 3: open, refused within the cooldown
    "ffsffa",          # a clean group resets the consecutive count
    "fff0aa" "s" "a",  # half-open probe after the cooldown closes it
    "fff0a" "fa",      # a failed probe re-opens it at once
    "fff0a" "fff",     # failures while open keep it open
])
def test_breaker_state_machine_matches_jax(steps):
    from sm_distributed_tpu.models.breaker import CircuitBreaker as JBreaker

    port, ref = breaker_mod.CircuitBreaker(), JBreaker()
    for step in steps:
        for b in (port, ref):
            if step == "0":
                b.cooldown_s = 0.0
        got = {"f": port.record_failure, "s": port.record_success,
               "a": port.allow_device, "0": lambda: None}[step]()
        want = {"f": ref.record_failure, "s": ref.record_success,
                "a": ref.allow_device, "0": lambda: None}[step]()
        assert got == want, (steps, step)
        assert port.snapshot() == ref.snapshot(), (steps, step)
    assert [(f, t) for _, f, t in port.transitions] == \
        [(f, t) for _, f, t in ref.transitions]


def test_breaker_singleton_refreshes_its_knobs():
    cfg = SMConfig.from_dict({"service": {"breaker_threshold": 2,
                                          "breaker_cooldown_s": 5.0}}).service
    b = breaker_mod.get_device_breaker(cfg)
    assert b is breaker_mod.get_device_breaker()
    assert (b.threshold, b.cooldown_s) == (2, 5.0)
    assert not b.record_failure() and b.record_failure()
    # a new config refreshes the thresholds, not the state machine
    breaker_mod.get_device_breaker(SMConfig().service)
    assert b.state == "open" and (b.threshold, b.cooldown_s) == (3, 30.0)
    breaker_mod.reset_device_breaker()
    assert breaker_mod.get_device_breaker().state == "closed"


def test_numpy_ref_scores_with_the_breaker_open(tiny, tmp_path):
    """``numpy_ref`` named in the config is not the device: an open breaker
    neither refuses it nor counts it, and its result is the oracle's."""
    _jds, tds, truth = tiny
    sm = _sm(tmp_path, backend="numpy_ref")
    want = _search(tds, truth, sm).search()
    assert breaker_mod.get_device_breaker().record_failure()  # threshold 1
    search = _search(tds, truth, sm)
    _frames_equal(search.search(), want)
    assert search.last_backend.name == "numpy_ref"
    assert breaker_mod.refused_count() == 0
    assert breaker_mod.get_device_breaker().snapshot() == {
        "state": "open", "failures": 1, "threshold": 1, "cooldown_s": 30.0}


# ------------------------------------------------------- breaker on searches
def test_breaker_open_mid_search_fails_job_and_retry_resumes(tiny,
                                                             tmp_path):
    """Group 0 scores on the device and lands in its shard; group 1's
    sticky fault opens the breaker and the job fails with
    ``DeviceUnavailableError`` (nothing scores on the host).  A retry within
    the cooldown is refused; the retry after it probes the card, closes
    the breaker, rescores only group 1 and is bit-equal to the device
    search."""
    _jds, tds, truth = tiny
    sm = _sm(tmp_path, parallel={"checkpoint_every": 1})
    ck = tmp_path / "ckpt"
    device = _search(tds, truth, sm).search()
    failpoints.configure("backend.chip_fault=raise:RuntimeError@2")
    failed = _search(tds, truth, sm, checkpoint_dir=str(ck))
    with pytest.raises(DeviceUnavailableError):
        failed.search()
    failpoints.configure(None)
    assert failed.last_backend.name == "torch_cuda"
    assert len(list(ck.glob("msm_search.p0.g*.ckpt.npz"))) == 1
    assert breaker_mod.get_device_breaker().state == "open"
    with pytest.raises(DeviceUnavailableError, match="refused"):
        _search(tds, truth, sm, checkpoint_dir=str(ck)).search()
    assert breaker_mod.refused_count() == 2
    retry = _search(tds, truth,
                    _sm(tmp_path, parallel={"checkpoint_every": 1},
                        service={"breaker_cooldown_s": 0.0}),
                    checkpoint_dir=str(ck))
    groups = []
    orig = retry.__class__._score_group

    def spy(self, backend, table, metrics, group, *a):
        groups.append(list(group))
        return orig(self, backend, table, metrics, group, *a)

    retry._score_group = spy.__get__(retry)
    got = retry.search()
    assert groups == [[(8, 12)]]
    assert breaker_mod.get_device_breaker().state == "closed"
    _frames_equal(got, device)


def test_half_open_probe_closes_breaker(tiny, tmp_path):
    """After the cooldown (0 s here) the next search probes the device: a
    clean group closes the breaker, and its results are the device
    search's bits.  The search that opened it failed and was counted."""
    _jds, tds, truth = tiny
    sm = _sm(tmp_path, service={"breaker_cooldown_s": 0.0})
    device = _search(tds, truth, sm).search()
    failpoints.configure("backend.chip_fault=raise:RuntimeError@1")
    with pytest.raises(DeviceUnavailableError):
        _search(tds, truth, sm).search()
    failpoints.configure(None)
    assert breaker_mod.get_device_breaker().state == "open"
    probe = _search(tds, truth, sm)
    got = probe.search()
    assert [t for _, _, t in breaker_mod.get_device_breaker().transitions] \
        == ["open", "half_open", "closed"]
    assert probe.last_backend.name == "torch_cuda"
    assert breaker_mod.refused_count() == 1
    _frames_equal(got, device)


# ------------------------------------------------------------ checkpoints
def _make_checkpoint(tmp_path, n_groups=3, rows_per=10):
    ck = SearchCheckpoint(tmp_path, "fp-test")
    rng = np.random.default_rng(0)
    metrics = rng.random((n_groups * rows_per, 4))
    row_ranges = [(i * rows_per, (i + 1) * rows_per) for i in range(n_groups)]
    for gi in range(n_groups):
        ck.save(metrics, gi, n_groups, row_ranges)
    return ck, metrics, row_ranges


def test_checkpoint_truncated_trailing_shard_degrades_to_prefix(tmp_path):
    ck, metrics, row_ranges = _make_checkpoint(tmp_path)
    shard = ck._shard(2)
    blob = shard.read_bytes()
    shard.write_bytes(blob[: len(blob) // 2])
    out = np.zeros_like(metrics)
    assert ck.load(out, 3, row_ranges) == 2
    assert np.array_equal(out[:20], metrics[:20])
    assert (out[20:] == 0).all()
    assert failpoints.recovery_counts().get("ckpt.corrupt_shard") == 1
    blob0 = ck._shard(0).read_bytes()
    ck._shard(0).write_bytes(blob0[: len(blob0) // 3])
    assert ck.load(np.zeros_like(metrics), 3, row_ranges) == 0


def test_checkpoint_checksum_catches_silent_row_corruption(tmp_path):
    ck, metrics, row_ranges = _make_checkpoint(tmp_path)
    rows = np.random.default_rng(1).random((10, 4))
    np.savez(ck._shard(1), fingerprint=np.str_("fp-test"), rows=rows,
             n_groups=3, checksum=zlib.crc32(metrics[10:20].tobytes()))
    out = np.zeros_like(metrics)
    assert ck.load(out, 3, row_ranges) == 1
    assert np.array_equal(out[:10], metrics[:10])
    assert (out[10:] == 0).all()


def test_checkpoint_zero_byte_shard(tmp_path):
    ck, metrics, row_ranges = _make_checkpoint(tmp_path)
    ck._shard(0).write_bytes(b"")
    assert ck.load(np.zeros_like(metrics), 3, row_ranges) == 0


def test_checkpoint_shards_match_jax_bytes(tmp_path):
    """The same rows saved by either package give the same shard bytes,
    and each package loads the other's."""
    from sm_distributed_tpu.models.msm_basic import SearchCheckpoint as JCk

    rng = np.random.default_rng(3)
    metrics = rng.random((12, 4))
    ranges = [(0, 8), (8, 12)]
    port, jax_ = SearchCheckpoint(tmp_path / "p", "fp"), JCk(tmp_path / "j",
                                                            "fp")
    for gi in range(2):
        port.save(metrics, gi, 2, ranges)
        jax_.save(metrics, gi, 2, ranges)
        assert port._shard(gi).read_bytes() == jax_._shard(gi).read_bytes()
    for reader, writer in ((port, jax_), (jax_, port)):
        reader.dir = writer.dir
        out = np.zeros_like(metrics)
        assert reader.load(out, 2, ranges) == 2
        np.testing.assert_array_equal(out, metrics)


@pytest.mark.parametrize("overlap", [False, True])
def test_fingerprints_equal_jax(tiny, tmp_path, overlap):
    """``_fingerprint`` (device path) and ``_fingerprint_pairs``
    (overlapped numpy_ref path) hash the same bytes in both packages for
    the same search: the same dataset, table, configs and effective
    batch."""
    from sm_distributed_tpu.models.msm_basic import MSMBasicSearch as JSearch
    from sm_distributed_tpu.utils.config import DSConfig as JDC
    from sm_distributed_tpu.utils.config import SMConfig as JSC
    from sm_distributed_tpu_torch.convert import pattern_table_from_arrays

    jds, tds, truth = tiny
    par = {"formula_batch": 6, "checkpoint_every": 2}
    jsearch = JSearch(jds, truth.formulas[:4], JDC.from_dict(DS_DICT),
                      JSC.from_dict({"backend": "numpy_ref",
                                     "parallel": par}))
    tsearch = MSMBasicSearch(tds, truth.formulas[:4],
                             DSConfig.from_dict(DS_DICT),
                             SMConfig.from_dict({"backend": "numpy_ref",
                                                 "device": "cpu",
                                                 "parallel": par}))
    assert jsearch.isocalc.device_blur is False
    jt = jsearch.isocalc.pattern_table([(sf, "+H")
                                        for sf in truth.formulas[:4]])
    tt = pattern_table_from_arrays(jt.sfs, jt.adducts, jt.mzs, jt.ints,
                                   jt.n_valid, jt.targets)
    assert tsearch._batch_eff == jsearch._batch_eff
    if overlap:
        assert tsearch._fingerprint_pairs(tt) == jsearch._fingerprint_pairs(jt)
    else:
        assert tsearch._fingerprint(tt) == jsearch._fingerprint(jt)
    # and it tracks what it hashes
    tsearch._batch_eff = 5
    assert tsearch._fingerprint(tt) != jsearch._fingerprint(jt)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tiny, tmp_path, monkeypatch,
                                            writer):
    """A numpy_ref search killed after 2 of its batch groups by one package
    resumes in the other: the resumed package scores only the remaining
    batches and its results are bit-equal to its own uninterrupted run
    (and to the other package's: the two numpy oracles are copies)."""
    from sm_distributed_tpu.models import msm_basic as jmb
    from sm_distributed_tpu.utils.config import DSConfig as JDC
    from sm_distributed_tpu.utils.config import SMConfig as JSC
    from sm_distributed_tpu_torch.models import msm_basic as tmb

    jds, tds, truth = tiny
    sm = {"backend": "numpy_ref", "fdr": {"decoy_sample_size": 2, "seed": 1},
          "parallel": {"formula_batch": 4, "checkpoint_every": 1}}
    ck = str(tmp_path / "ckpt")

    def make(pkg, **kw):
        if pkg == "jax":
            return jmb.MSMBasicSearch(jds, truth.formulas[:4],
                                      JDC.from_dict(DS_DICT),
                                      JSC.from_dict(sm), **kw)
        return tmb.MSMBasicSearch(tds, truth.formulas[:4],
                                  DSConfig.from_dict(DS_DICT),
                                  SMConfig.from_dict({**sm, "device": "cpu"}),
                                  **kw)

    reader = "port" if writer == "jax" else "jax"
    baseline = make(reader).search()
    mod = jmb if writer == "jax" else tmb
    orig = mod.NumpyBackend.score_batch
    calls = {"n": 0}

    def bomb(self, t):
        calls["n"] += 1
        if calls["n"] > 2:
            raise KeyboardInterrupt  # a kill after 2 batch groups
        return orig(self, t)

    monkeypatch.setattr(mod.NumpyBackend, "score_batch", bomb)
    with pytest.raises(KeyboardInterrupt):
        make(writer, checkpoint_dir=ck).search()
    monkeypatch.setattr(mod.NumpyBackend, "score_batch", orig)
    rmod = tmb if reader == "port" else jmb
    rorig = rmod.NumpyBackend.score_batch
    scored = {"n": 0}

    def count(self, t):
        scored["n"] += 1
        return rorig(self, t)

    monkeypatch.setattr(rmod.NumpyBackend, "score_batch", count)
    resumed = make(reader, checkpoint_dir=ck).search()
    n_batches = -(-len(resumed.all_metrics) // 4)
    assert scored["n"] == n_batches - 2
    _frames_equal(resumed, baseline)


def test_device_search_resumes_from_checkpoint(tiny, tmp_path):
    """The device path: killed before group 2 (``device.score_batch``,
    outside ``_score_group``), the rerun scores one batch and is bit-equal
    to the uninterrupted search; ``finalize`` removes the shards."""
    _jds, tds, truth = tiny
    sm = _sm(tmp_path, parallel={"checkpoint_every": 1, "formula_batch": 4})
    ck = tmp_path / "ckpt"
    want = _search(tds, truth, sm).search()
    failpoints.configure("device.score_batch=raise:RuntimeError@3")
    with pytest.raises(RuntimeError, match="device.score_batch"):
        _search(tds, truth, sm, checkpoint_dir=str(ck)).search()
    failpoints.configure(None)
    assert len(list(ck.glob("msm_search.p0.g*.ckpt.npz"))) == 2
    assert breaker_mod.get_device_breaker().snapshot()["failures"] == 0
    resumed = _search(tds, truth, sm, checkpoint_dir=str(ck))
    calls = []
    orig = resumed.__class__._score_group

    def spy(self, backend, table, metrics, group, *a):
        calls.append(list(group))
        return orig(self, backend, table, metrics, group, *a)

    resumed._score_group = spy.__get__(resumed)
    got = resumed.search()
    assert calls == [[(8, 12)]]
    _frames_equal(got, want)
    resumed.last_checkpoint.finalize()
    assert not list(ck.glob("msm_search.p0.g*"))


# ------------------------------------------------------------------ config
def test_config_accepts_what_the_jax_package_accepts():
    """Every ``backend``, ``checkpoint_every``, ``cube_dtype`` and breaker
    knob the JAX package accepts on one device, and any other ``service``
    key at the JAX package's default."""
    from sm_distributed_tpu.utils.config import SMConfig as JSC

    for d in ({"backend": "numpy_ref"}, {"backend": "torch_cuda"},
              {"parallel": {"checkpoint_every": 0}},
              {"parallel": {"checkpoint_every": 7}},
              {"parallel": {"cube_dtype": "f32"}},
              {"parallel": {"cube_dtype": "bf16"}},
              {"parallel": {"cube_dtype": "int8"}},
              {"service": {"breaker_threshold": 5, "breaker_cooldown_s": 0.0,
                           "breaker_degraded_batch": 64}},
              {"service": {"workers": 2, "http_port": 8685,
                           "fleet": {"enabled": False},
                           "read": {"page_size": 100}}}):
        sm = SMConfig.from_dict(d)
        if "service" in d:
            jsm = JSC.from_dict(d)
            for knob in ("breaker_threshold", "breaker_cooldown_s",
                         "breaker_degraded_batch"):
                assert getattr(sm.service, knob) == getattr(jsm.service, knob)
    assert SMConfig().backend == "torch_cuda"


def test_service_defaults_table_matches_jax():
    """Every ``service`` knob the port has (the ``read`` and ``stream``
    blocks included) defaults to the JAX package's value, and the port
    accepts a block it does not have yet only at the JAX package's default
    (``fleetview`` disabled): its table of those defaults is the JAX
    ServiceConfig's, key for key."""
    import dataclasses

    from sm_distributed_tpu.utils.config import SMConfig as JSC
    from sm_distributed_tpu_torch.utils.config import _SERVICE_NOT_YET

    want = dataclasses.asdict(JSC().service)
    got = dataclasses.asdict(SMConfig().service)
    for knob, value in got.items():
        assert value == want.pop(knob), knob
    assert _SERVICE_NOT_YET == want
    want["fleetview"]["enabled"] = False
    SMConfig.from_dict({"service": want})


@pytest.mark.parametrize("service", [
    {"fleetview": {"scrape_timeout_s": 5.0}}, {"fleetview": {"enabled": True}},
    {"fleet": {"enabled": True}}, {"fleet": {"max_replicas": 2}},
    {"prime": {"interval_s": 5.0}}, {"prime": {"enabled": True}}])
def test_other_service_keys_raise_naming_item_9(service):
    with pytest.raises(NotImplementedError, match="item 9"):
        SMConfig.from_dict({"service": service})


@pytest.mark.parametrize("service", [
    {"read": {"enabled": False}}, {"read": {"page_size": 7}},
    {"read": {"max_concurrent": 0, "cache_max_bytes": 0}},
    {"stream": {"idle_timeout_s": 5.0}},
    {"stream": {"rescore_min_chunks": 3, "retention_age_s": 0.0}}])
def test_read_and_stream_blocks_take_the_jax_values(service):
    """The read path's and the stream ingest's blocks take every value the
    JAX package takes, to the same dataclass fields."""
    from sm_distributed_tpu.utils.config import SMConfig as JSC

    block, = service
    got = getattr(SMConfig.from_dict({"service": service}).service, block)
    want = getattr(JSC.from_dict({"service": service}).service, block)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("bad", [
    {"service": {"breaker_threshold": 0}},
    {"service": {"breaker_cooldown_s": -1.0}},
    {"service": {"breaker_degraded_batch": 0}},
    {"service": {"no_such_knob": 1}},
    {"parallel": {"checkpoint_every": -1}},
    {"parallel": {"cube_dtype": "fp8"}},
    {"backend": "jax_tpu"}])
def test_config_rejects_bad_values(bad):
    with pytest.raises(ValueError):
        SMConfig.from_dict(bad)
