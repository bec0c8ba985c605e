"""The port's live-acquisition stream ingest (``engine/stream.py``, the
scheduler's stream branches, the stream POSTs) on the CPU.

The JAX package's ``tests/test_stream.py`` cases run on the port's modules,
on ``"device": "cpu"`` (the kernels' plain versions) and on ``numpy_ref``:
the crash-safe chunk log (duplicates, out-of-order seqs, CRC conflicts,
torn chunks, fenced appends), provisional re-ranks through the partial
seam, the idle timeout, the deadline and per-attempt-timeout exemptions,
the watchdog, the drain hand-off to a peer, and bit-identical
(``check_exact``) convergence of the sealed stream to the batch run.  Where
a case's outcome is a state, the same calls are made on both packages and
held equal: manifests (timestamps aside), HTTP codes and bodies, metrics
text.  Parity cases: the sealed stream's FDR levels and msm ranks equal the
JAX package's stream run; every provisional re-score equals, exactly, a
direct ``MSMBasicSearch`` over the same prefix; and a ``KernelError`` inside
a re-score fails the attempt (the port's one departure), while a transient
device fault leaves the preview stale as in the JAX package.  Tolerances:
none (exact frames, equal ranks).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import rankdata

from sm_distributed_tpu.engine import stream as jstream
from sm_distributed_tpu.service import metrics as jmetrics
from sm_distributed_tpu_torch.engine import stream as tstream
from sm_distributed_tpu_torch.engine.daemon import annotate_callback
from sm_distributed_tpu_torch.engine.stream import (
    ChunkLog,
    StreamEmptyError,
    StreamSearchJob,
)
from sm_distributed_tpu_torch.io.dataset import SpectralDataset
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.io.imzml import ImzMLReader
from sm_distributed_tpu_torch.kernels import _build
from sm_distributed_tpu_torch.models import breaker, faults, oom
from sm_distributed_tpu_torch.models import msm_basic
from sm_distributed_tpu_torch.service import AnnotationService
from sm_distributed_tpu_torch.service import metrics as tmetrics
from sm_distributed_tpu_torch.utils import failpoints
from sm_distributed_tpu_torch.utils.config import (
    DSConfig,
    ServiceConfig,
    SMConfig,
    StreamConfig,
)

torch.set_num_threads(1)

ADDUCTS = {"isotope_generation": {"adducts": ["+H"]}}


@pytest.fixture(autouse=True)
def _reset_port_state():
    yield
    breaker.reset_device_breaker()
    oom.reset()
    faults.reset()
    failpoints.reset()


@pytest.fixture(scope="module")
def fixture_path(tmp_path_factory):
    # off-lattice 9x11 spheroid: both dims miss the shape-bucket lattice,
    # so streaming convergence is tested through the pad/bucket path too
    out = tmp_path_factory.mktemp("ds_stream")
    path, truth = generate_synthetic_dataset(
        out, nrows=9, ncols=11, formulas=None, present_fraction=0.5,
        noise_peaks=12, seed=41)
    return path, truth


def _read_spectra(path):
    """All (coords, (mzs, ints)) pairs from the fixture, file order."""
    with ImzMLReader(path) as rd:
        coords = rd.coordinates.tolist()
        spectra = [tuple(a.tolist() for a in rd.read_spectrum(i))
                   for i in range(rd.n_spectra)]
    return coords, spectra


def _chunked(coords, spectra, n_chunks):
    """Split the acquisition into n_chunks contiguous pixel runs."""
    edges = np.linspace(0, len(coords), n_chunks + 1).astype(int)
    out = []
    for seq in range(n_chunks):
        lo, hi = edges[seq], edges[seq + 1]
        out.append((seq, coords[lo:hi], spectra[lo:hi]))
    return out


def _manifest(log) -> dict:
    """A manifest with its timestamps left out."""
    m = log.manifest()
    m.pop("finished_at", None)
    for c in m["chunks"].values():
        c.pop("committed_at")
    return m


# ------------------------------------------------------------- chunk log
def test_chunk_log_duplicate_and_out_of_order(tmp_path):
    """The JAX package's sequence of appends and finishes on both chunk
    logs: the same outcomes and the same manifests."""
    def drive(mod, root):
        log = mod.ChunkLog(root, "ds1")
        seen = []
        c0 = ([[0, 0], [0, 1]], [([100.0, 200.0], [1.0, 2.0]),
                                 ([150.0], [3.0])])
        seen.append(log.append(0, *c0))
        before = sorted(p.name for p in (root / "ds1").iterdir())
        seen.append(log.append(0, *c0))          # duplicate (lost ack)
        assert sorted(p.name for p in (root / "ds1").iterdir()) == before
        with pytest.raises(mod.ChunkConflictError):
            log.append(0, [[0, 0], [0, 1]],
                       [([100.0], [9.0]), ([150.0], [3.0])])
        log.append(2, [[1, 0]], [([120.0], [5.0])])
        with pytest.raises(mod.StreamGapError,
                           match=r"missing chunk seqs \[1\]"):
            log.finish()
        log.append(1, [[0, 2]], [([130.0], [4.0])])
        seen.append(log.finish())
        seen.append(log.finish())                # idempotent
        with pytest.raises(mod.StreamGapError):  # post-finish append
            log.append(3, [[2, 0]], [([140.0], [6.0])])
        return seen, _manifest(log)

    got = drive(tstream, tmp_path / "t")
    assert got == drive(jstream, tmp_path / "j")
    seen, _m = got
    assert seen[0] == {"seq": 0, "committed": True, "duplicate": False}
    assert seen[1]["duplicate"] is True
    assert seen[2] == {"finished": True, "duplicate": False, "chunks": 3}
    assert seen[3]["duplicate"] is True


def test_chunk_log_concurrent_appends_lose_nothing(tmp_path):
    """The manifest read-modify-write is serialized (a per-dataset flock):
    every acked append of concurrent writers survives."""
    import concurrent.futures

    n_chunks = 24

    def post(seq):
        return ChunkLog(tmp_path, "ds1").append(
            seq, [[seq, 0]], [([100.0 + seq], [1.0])])

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        outs = list(ex.map(post, range(n_chunks)))
    assert all(o["committed"] and not o["duplicate"] for o in outs)
    log = ChunkLog(tmp_path, "ds1")
    assert log.committed_seqs() == list(range(n_chunks))
    assert log.finish()["finished"] is True
    assert log.assemble_dataset().n_spectra == n_chunks


def test_chunk_log_concurrent_same_seq_appends_commit_once(tmp_path):
    import concurrent.futures

    payload = ([[0, 0], [0, 1]],
               [([100.0, 200.0], [1.0, 2.0]), ([150.0], [3.0])])

    def post(_):
        return ChunkLog(tmp_path, "ds1").append(0, *payload)

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
        outs = list(ex.map(post, range(6)))
    assert all(o["committed"] for o in outs)
    assert sum(not o["duplicate"] for o in outs) == 1  # exactly once
    log = ChunkLog(tmp_path, "ds1")
    assert log.committed_seqs() == [0]
    coords, _spectra = log.load_chunk(0)               # CRC-verified read
    assert coords.tolist() == [[0, 0], [0, 1]]


def test_chunk_log_finish_empty_rejected(tmp_path):
    log = ChunkLog(tmp_path, "ds1")
    with pytest.raises(StreamEmptyError, match="zero committed chunks"):
        log.finish()
    assert not log.finished()
    log.append(0, [[0, 0]], [([100.0], [1.0])])
    assert log.finish()["finished"] is True


def test_chunk_log_torn_trailing_chunk_on_restart(tmp_path):
    log = ChunkLog(tmp_path, "ds1")
    log.append(0, [[0, 0]], [([100.0], [1.0])])
    d = tmp_path / "ds1"
    (d / ".chunk_000001.npz.tmp").write_bytes(b"torn garbage")
    (d / "chunk_000001.npz").write_bytes(b"stranded, never committed")
    log2 = ChunkLog(tmp_path, "ds1")                  # restart
    assert log2.sweep_debris(max_age_s=0.0) == 1      # the tmp, nothing else
    assert log2.committed_seqs() == [0]
    assert not (d / ".chunk_000001.npz.tmp").exists()
    log2.append(1, [[0, 1]], [([150.0], [3.0])])
    assert log2.committed_seqs() == [0, 1]
    coords, _spectra = log2.load_chunk(1)
    assert coords.tolist() == [[0, 1]]


def test_chunk_log_crc_detects_corruption(tmp_path):
    log = ChunkLog(tmp_path, "ds1")
    log.append(0, [[0, 0]], [([100.0, 200.0], [1.0, 2.0])])
    p = log.chunk_path(0)
    raw = bytearray(p.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    p.write_bytes(bytes(raw))
    for mod in (tstream, jstream):                    # either package's read
        with pytest.raises(OSError):
            mod.ChunkLog(tmp_path, "ds1").load_chunk(0)


def test_fenced_append_rejected_at_manifest_seam(tmp_path):
    log = ChunkLog(tmp_path, "ds1")
    log.append(0, [[0, 0]], [([100.0], [1.0])])

    def fence():
        raise RuntimeError("fenced: shards reassigned")

    with pytest.raises(RuntimeError, match="fenced"):
        log.append(1, [[0, 1]], [([150.0], [3.0])], fence=fence)
    assert log.committed_seqs() == [0]                # not published
    with pytest.raises(RuntimeError, match="fenced"):
        log.finish(fence=fence)
    assert not log.finished()
    assert log.append(1, [[0, 1]], [([150.0], [3.0])])["duplicate"] is False
    assert log.committed_seqs() == [0, 1]
    assert log.finish()["finished"] is True


def test_assembled_dataset_bit_identical_to_from_imzml(fixture_path, tmp_path):
    """``from_arrays`` over chunked spectra (any arrival order) and the
    port's ``from_imzml`` build the same CSR, bit for bit, and so does the
    JAX package's chunk log reading the port's."""
    path, _truth = fixture_path
    coords, spectra = _read_spectra(path)
    log = ChunkLog(tmp_path, "ds1")
    for seq, cc, ss in reversed(_chunked(coords, spectra, 4)):
        log.append(seq, cc, ss)
    log.finish()
    got = log.assemble_dataset()
    want = SpectralDataset.from_imzml(path)
    other = jstream.ChunkLog(tmp_path, "ds1").assemble_dataset()
    for attr in ("mzs_flat", "ints_flat", "pixel_inds", "row_ptr", "mask"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
        assert np.array_equal(getattr(got, attr), getattr(other, attr)), attr
    assert (got.nrows, got.ncols) == (want.nrows, want.ncols)
    assert got.n_spectra == len(coords)


def test_stream_ingest_counters(tmp_path):
    texts = {}
    for name, mod, metrics in (("torch", tstream, tmetrics),
                               ("jax", jstream, jmetrics)):
        m = metrics.MetricsRegistry()
        ing = mod.StreamIngest(tmp_path / name, metrics=m)
        chunk = ([[0, 0], [0, 1]], [([100.0], [1.0]), ([150.0], [3.0])])
        outs = [ing.append_chunk("ds1", 0, *chunk),
                ing.append_chunk("ds1", 0, *chunk)]  # duplicate
        texts[name] = (m.expose(), outs, ing.status("ds1"), ing.in_flight())
    assert texts["torch"] == texts["jax"]
    text, _outs, st, in_flight = texts["torch"]
    assert "sm_stream_chunks_total 1" in text     # duplicates don't count
    assert "sm_stream_pixels_total 2" in text
    assert st["chunks"] == 1 and st["pixels"] == 2 and not st["finished"]
    assert in_flight == 1


# ------------------------------------------------------- service harness
def _fast_cfg(**kw) -> ServiceConfig:
    base = dict(workers=2, poll_interval_s=0.02, job_timeout_s=60.0,
                max_attempts=3, backoff_base_s=0.05, backoff_max_s=0.5,
                backoff_jitter=0.0, heartbeat_interval_s=0.05,
                stale_after_s=2.0, drain_timeout_s=15.0, cancel_grace_s=5.0,
                http_port=0,
                stream=StreamConfig(idle_timeout_s=30.0,
                                    poll_interval_s=0.02,
                                    rescore_min_chunks=1))
    base.update(kw)
    return ServiceConfig(**base)


def _sm(tmp_path, backend="torch_cuda", **service_kw) -> SMConfig:
    d = {"backend": backend, "fdr": {"decoy_sample_size": 3, "seed": 2},
         "parallel": {"isocalc_workers": 1},
         "storage": {"results_dir": str(tmp_path / "res")},
         "work_dir": str(tmp_path / "work")}
    if backend == "torch_cuda":
        d["device"] = "cpu"
    return dataclasses.replace(SMConfig.from_dict(d),
                               service=_fast_cfg(**service_kw))


def _service(tmp_path, sm, svc_cls=AnnotationService, callback=None):
    svc = svc_cls(tmp_path / "q", callback or annotate_callback(sm),
                  sm_config=sm)
    svc.start()
    host, port = svc.api.address
    return svc, f"http://{host}:{port}"


def _req(base, path, method="GET", payload=None):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(base + path, method=method, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10.0) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_job(base, msg_id, want_states, timeout_s=90.0):
    deadline = time.time() + timeout_s
    body = None
    while time.time() < deadline:
        status, body = _req(base, f"/jobs/{msg_id}")
        if status == 200 and body.get("state") in want_states:
            return body
        time.sleep(0.05)
    raise AssertionError(f"job {msg_id} never reached {want_states}: {body}")


def _post_chunk(base, ds_id, seq, coords, spectra):
    return _req(base, f"/datasets/{ds_id}/pixels", "POST", {
        "seq": seq, "coords": coords,
        "mzs": [list(s[0]) for s in spectra],
        "ints": [list(s[1]) for s in spectra]})


def _report(res_dir, ds_id):
    out = []
    for name in ("annotations.parquet", "all_metrics.parquet"):
        df = pd.read_parquet(res_dir / ds_id / name)
        out.append(df.sort_values(["sf", "adduct"]).reset_index(drop=True))
    return tuple(out)


def _stream_through(base, msg_id, ds_id, chunks):
    """Post each chunk and wait for the re-rank covering it; returns the
    provisional payloads seen."""
    seen = []
    for seq, cc, ss in chunks:
        status, out = _post_chunk(base, ds_id, seq, cc, ss)
        assert status == 200 and out["committed"], out
        deadline = time.time() + 60.0
        while time.time() < deadline:
            rec = _req(base, f"/jobs/{msg_id}")[1]
            part = rec.get("partial") or {}
            if (part.get("stream") or {}).get("chunks", 0) >= seq + 1:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"no provisional re-rank for seq {seq}")
        seen.append(part)
    return seen


@pytest.fixture(scope="module")
def jax_stream_report(fixture_path, tmp_path_factory):
    """The JAX package's stream run (numpy oracle) of the fixture's first 8
    formulas in 3 chunks, as the convergence test feeds the port."""
    from sm_distributed_tpu.engine.daemon import annotate_callback as jcb
    from sm_distributed_tpu.service import AnnotationService as JService
    from sm_distributed_tpu.utils import config as jconfig

    path, truth = fixture_path
    tmp = tmp_path_factory.mktemp("jax_stream")
    sm = dataclasses.replace(
        jconfig.SMConfig.from_dict({
            "backend": "numpy_ref", "fdr": {"decoy_sample_size": 3,
                                            "seed": 2},
            "storage": {"results_dir": str(tmp / "res")},
            "work_dir": str(tmp / "work")}),
        service=jconfig.ServiceConfig(
            workers=2, poll_interval_s=0.02, backoff_base_s=0.05,
            heartbeat_interval_s=0.05, http_port=0,
            stream=jconfig.StreamConfig(idle_timeout_s=30.0,
                                        poll_interval_s=0.02)))
    svc = JService(tmp / "q", jcb(sm), sm_config=sm)
    svc.start()
    try:
        base = "http://%s:%d" % svc.api.address
        status, body = _req(base, "/submit", "POST", {
            "ds_id": "live", "mode": "stream",
            "formulas": truth.formulas[:8], "ds_config": ADDUCTS})
        assert status == 202
        coords, spectra = _read_spectra(path)
        _stream_through(base, body["msg_id"], "live",
                        _chunked(coords, spectra, 3))
        assert _req(base, "/datasets/live/finish", "POST", {})[0] == 200
        _wait_job(base, body["msg_id"], ("done",))
    finally:
        svc.shutdown()
    return _report(tmp / "res", "live")


# ----------------------------------------------- streaming-vs-batch e2e
@pytest.mark.parametrize("backend", ["torch_cuda", "numpy_ref"])
def test_stream_converges_bit_identical_to_batch(fixture_path, tmp_path,
                                                 backend, jax_stream_report):
    """Chunked live ingest + provisional re-ranks + POST finish give
    exactly the port's one-shot batch report (``check_exact``), with
    monotone provisional coverage and the sm_stream_* telemetry; the FDR
    levels and msm ranks equal the JAX package's stream run."""
    path, truth = fixture_path
    formulas = truth.formulas[:8]
    sm = _sm(tmp_path, backend=backend)
    svc, base = _service(tmp_path, sm)
    try:
        status, body = _req(base, "/submit", "POST", {
            "ds_id": "golden", "input_path": str(path),
            "formulas": formulas, "ds_config": ADDUCTS})
        assert status == 202
        _wait_job(base, body["msg_id"], ("done",))

        status, body = _req(base, "/submit", "POST", {
            "ds_id": "live", "mode": "stream",
            "formulas": formulas, "ds_config": ADDUCTS})
        assert status == 202
        msg_id = body["msg_id"]
        coords, spectra = _read_spectra(path)
        seen = _stream_through(base, msg_id, "live",
                               _chunked(coords, spectra, 3))
        for part in seen:
            assert part["provisional"] is True
            assert part["n_ions"] > 0 and "fdr_10pct" in part
        pixels = [p["stream"]["pixels"] for p in seen]
        assert pixels == sorted(pixels) and pixels[-1] == len(coords)

        status, out = _req(base, "/datasets/live/finish", "POST", {})
        assert status == 200 and out["finished"], out
        _wait_job(base, msg_id, ("done",))

        got = _report(tmp_path / "res", "live")
        want = _report(tmp_path / "res", "golden")
        for g, w in zip(got, want):
            pd.testing.assert_frame_equal(g, w, check_exact=True)
        ann, jann = got[0], jax_stream_report[0]
        pd.testing.assert_frame_equal(ann[["sf", "adduct"]],
                                      jann[["sf", "adduct"]])
        np.testing.assert_array_equal(ann.fdr_level.to_numpy(),
                                      jann.fdr_level.to_numpy())
        np.testing.assert_array_equal(rankdata(-ann.msm.to_numpy(), "min"),
                                      rankdata(-jann.msm.to_numpy(), "min"))

        text = svc.metrics.expose()
        assert "sm_stream_chunks_total 3" in text
        assert f"sm_stream_pixels_total {len(coords)}" in text
        assert "sm_stream_reranks_total 3" in text
        slo = _req(base, "/slo")[1]
        assert slo["slos"]["stream_partial"]["count"] >= 1
    finally:
        svc.shutdown()


def test_stream_idle_timeout_and_deadline_exemption(fixture_path, tmp_path):
    """A stream job ignores the submit-pinned absolute deadline and is
    cancelled terminally by the chunk-silence idle timeout instead."""
    _path, truth = fixture_path
    sm = _sm(tmp_path, stream=StreamConfig(idle_timeout_s=1.0,
                                           poll_interval_s=0.02))
    svc, base = _service(tmp_path, sm)
    try:
        status, body = _req(base, "/submit", "POST", {
            "ds_id": "live", "mode": "stream", "deadline_s": 0.2,
            "formulas": truth.formulas[:3], "ds_config": ADDUCTS})
        assert status == 202
        t0 = time.time()
        rec = _wait_job(base, body["msg_id"], ("cancelled",), timeout_s=30.0)
        assert time.time() - t0 >= 0.8                 # not the deadline
        assert "idle" in rec["error"]
        assert rec["attempts"] == 1                    # terminal, no retries
    finally:
        svc.shutdown()


def test_stream_idle_timeout_fires_below_rescore_threshold(fixture_path,
                                                           tmp_path):
    """With ``rescore_min_chunks > 1`` a sub-threshold pending chunk does
    not refresh the idle clock: one chunk and then client death still ends
    in the idle timeout."""
    path, truth = fixture_path
    sm = _sm(tmp_path, stream=StreamConfig(idle_timeout_s=1.0,
                                           poll_interval_s=0.02,
                                           rescore_min_chunks=4))
    svc, base = _service(tmp_path, sm)
    try:
        status, body = _req(base, "/submit", "POST", {
            "ds_id": "live", "mode": "stream",
            "formulas": truth.formulas[:3], "ds_config": ADDUCTS})
        assert status == 202
        coords, spectra = _read_spectra(path)
        assert _post_chunk(base, "live", 0, coords[:2], spectra[:2])[0] == 200
        rec = _wait_job(base, body["msg_id"], ("cancelled",), timeout_s=30.0)
        assert "idle" in rec["error"]
        assert rec["attempts"] == 1
    finally:
        svc.shutdown()


def test_stream_outlives_per_attempt_timeout(fixture_path, tmp_path):
    """``job_timeout_s`` bounds one batch attempt, not an acquisition: a
    stream paced past it converges on its first attempt."""
    path, truth = fixture_path
    sm = _sm(tmp_path, job_timeout_s=0.5,
             stream=StreamConfig(idle_timeout_s=30.0, poll_interval_s=0.02))
    svc, base = _service(tmp_path, sm)
    try:
        status, body = _req(base, "/submit", "POST", {
            "ds_id": "live", "mode": "stream",
            "formulas": truth.formulas[:3], "ds_config": ADDUCTS})
        assert status == 202
        coords, spectra = _read_spectra(path)
        for seq, cc, ss in _chunked(coords, spectra, 2):
            time.sleep(0.6)                # each gap alone > job_timeout_s
            assert _post_chunk(base, "live", seq, cc, ss)[0] == 200
        assert _req(base, "/datasets/live/finish", "POST", {})[0] == 200
        rec = _wait_job(base, body["msg_id"], ("done",))
        assert rec["attempts"] == 1, rec
    finally:
        svc.shutdown()


def test_stream_chunk_progress_feeds_watchdog(fixture_path, tmp_path):
    """Waiting for chunks counts as progress: a stall watchdog far shorter
    than the acquisition does not kill the job."""
    path, truth = fixture_path
    sm = _sm(tmp_path, watchdog_interval_s=0.05, watchdog_stall_s=0.3,
             stream=StreamConfig(idle_timeout_s=0.0, poll_interval_s=0.02))
    svc, base = _service(tmp_path, sm)
    try:
        status, body = _req(base, "/submit", "POST", {
            "ds_id": "live", "mode": "stream",
            "formulas": truth.formulas[:3], "ds_config": ADDUCTS})
        assert status == 202
        time.sleep(1.0)                                # >> watchdog_stall_s
        rec = _req(base, f"/jobs/{body['msg_id']}")[1]
        assert rec["state"] == "running", rec
        coords, spectra = _read_spectra(path)
        assert _post_chunk(base, "live", 0, coords, spectra)[0] == 200
        assert _req(base, "/datasets/live/finish", "POST", {})[0] == 200
        _wait_job(base, body["msg_id"], ("done",))
    finally:
        svc.shutdown()


def test_stream_drain_hands_off_to_peer(fixture_path, tmp_path):
    """Shutting a replica down mid-acquisition republishes the stream job
    without burning an attempt; a fresh peer over the same spool and work
    dir resumes from the chunk log and converges to the batch report."""
    path, truth = fixture_path
    formulas = truth.formulas[:5]
    coords, spectra = _read_spectra(path)
    chunks = _chunked(coords, spectra, 2)
    sm = _sm(tmp_path)
    svc1, base1 = _service(tmp_path, sm)
    shutdown1 = True
    try:
        status, body = _req(base1, "/submit", "POST", {
            "ds_id": "live", "mode": "stream",
            "formulas": formulas, "ds_config": ADDUCTS})
        assert status == 202
        msg_id = body["msg_id"]
        _stream_through(base1, msg_id, "live", chunks[:1])
        svc1.shutdown()                                # controller drain
        shutdown1 = False
        pending = tmp_path / "q" / "sm_annotate" / "pending" / f"{msg_id}.json"
        assert pending.exists(), "drain must republish the live stream job"
        assert json.loads(pending.read_text())["service"]["attempts"] == 0

        svc2, base2 = _service(tmp_path, sm)           # the peer
        try:
            _wait_job(base2, msg_id, ("running",))
            seq, cc, ss = chunks[1]
            assert _post_chunk(base2, "live", seq, cc, ss)[0] == 200
            assert _req(base2, "/datasets/live/finish", "POST", {})[0] == 200
            _wait_job(base2, msg_id, ("done",))
            status, body = _req(base2, "/submit", "POST", {
                "ds_id": "golden", "input_path": str(path),
                "formulas": formulas, "ds_config": ADDUCTS})
            assert status == 202
            _wait_job(base2, body["msg_id"], ("done",))
        finally:
            svc2.shutdown()
        got = _report(tmp_path / "res", "live")
        want = _report(tmp_path / "res", "golden")
        for g, w in zip(got, want):
            pd.testing.assert_frame_equal(g, w, check_exact=True)
    finally:
        if shutdown1:
            svc1.shutdown()


def test_stream_http_validation_and_conflicts(fixture_path, tmp_path):
    """The same requests to the port's and the JAX package's services get
    the same codes and bodies."""
    from sm_distributed_tpu.engine.daemon import annotate_callback as jcb
    from sm_distributed_tpu.service import AnnotationService as JService
    from sm_distributed_tpu.utils import config as jconfig

    ok = {"seq": 0, "coords": [[0, 0]], "mzs": [[100.0]], "ints": [[1.0]]}
    requests = [
        ("/submit", {"ds_id": "x", "input_path": "/in", "mode": "wat"}),
        ("/datasets/d/pixels", {"coords": [[0, 0]]}),
        ("/datasets/d/pixels", {"seq": -1, "coords": [], "mzs": [],
                                "ints": []}),
        ("/datasets/d/pixels", {"seq": 0, "coords": [[0, 0]],
                                "mzs": [[1.0], [2.0]], "ints": [[1.0]]}),
        ("/datasets/d/pixels", ok),
        ("/datasets/d/pixels", ok),                    # duplicate
        ("/datasets/d/pixels", dict(ok, mzs=[[999.0]])),
        ("/datasets/d/pixels", {"seq": 5, "coords": [[1, 0]],
                                "mzs": [[100.0]], "ints": [[1.0]]}),
        ("/datasets/d/finish", {}),
        ("/datasets/nothing/finish", {}),
    ]

    def drive(svc):
        svc.start()
        try:
            base = "http://%s:%d" % svc.api.address
            return [_req(base, path, "POST", body) for path, body in requests]
        finally:
            svc.shutdown()

    got = drive(AnnotationService(tmp_path / "tq", lambda m: None,
                                  sm_config=_sm(tmp_path / "t")))
    jsm = dataclasses.replace(
        jconfig.SMConfig.from_dict({
            "backend": "numpy_ref",
            "storage": {"results_dir": str(tmp_path / "j" / "res")},
            "work_dir": str(tmp_path / "j" / "work")}),
        service=jconfig.ServiceConfig(http_port=0))
    want = drive(JService(tmp_path / "jq", jcb(jsm), sm_config=jsm))
    assert [s for s, _b in got] == [400, 400, 400, 400, 200, 200, 409, 200,
                                    409, 409]
    assert got[5][1]["duplicate"] is True
    assert got[6][1]["reason"] == "chunk_conflict"
    assert got[8][1]["reason"] == "stream_gap"
    assert got[9][1]["reason"] == "stream_empty"
    assert got == want


# ------------------------------------------------------------- retention
def test_governor_reaps_finished_and_abandoned_stream_logs(tmp_path):
    import os

    from sm_distributed_tpu_torch.service.resources import ResourceGovernor
    from sm_distributed_tpu_torch.utils.config import ResourcesConfig

    root = tmp_path / "work" / "stream"

    def mklog(ds_id, finished, idle_s):
        log = ChunkLog(root, ds_id)
        log.append(0, [[0, 0]], [([100.0], [1.0])])
        if finished:
            log.finish()
        old = time.time() - idle_s
        os.utime(log.manifest_path, (old, old))
        return log.dir

    done = mklog("done", finished=True, idle_s=20.0)
    abandoned = mklog("abandoned", finished=False, idle_s=45.0)
    inflight = mklog("inflight", finished=False, idle_s=20.0)
    gov = ResourceGovernor(ResourcesConfig(), work_dir=tmp_path / "work",
                           stream_dir=root, stream_retention_age_s=10.0,
                           stream_idle_timeout_s=30.0)
    gov._sweep_stream(time.time())
    assert not done.exists()                           # finished + idle
    assert not abandoned.exists()                      # idle past 10 + 30
    assert (inflight / "manifest.json").exists()       # inside the window
    forever = mklog("forever", finished=False, idle_s=1e6)
    gov0 = ResourceGovernor(ResourcesConfig(), work_dir=tmp_path / "work",
                            stream_dir=root, stream_retention_age_s=10.0,
                            stream_idle_timeout_s=0.0)
    gov0._sweep_stream(time.time())
    assert (forever / "manifest.json").exists()


# ------------------------------------------------------- parity: re-scores
class _Recorder:
    """Wraps ``MSMBasicSearch.search`` to keep every search's bundle, with
    whether it was a provisional re-score (no checkpoint dir)."""

    def __init__(self, monkeypatch, fault=None):
        self.bundles: list = []
        self.fault = fault
        self.raised = 0
        orig = msm_basic.MSMBasicSearch.search
        rec = self

        def search(search_self, *a, **kw):
            provisional = search_self.checkpoint_dir is None
            if provisional and rec.fault is not None:
                rec.raised += 1
                raise rec.fault
            bundle = orig(search_self, *a, **kw)
            rec.bundles.append((provisional, search_self.ds, bundle))
            return bundle

        monkeypatch.setattr(msm_basic.MSMBasicSearch, "search", search)


def _start(make_job):
    """Build and run a job in its own thread, as a service attempt does (the
    job's ledger connection belongs to that thread); returns (thread,
    box): ``box`` gets the job, then its bundle or its error."""
    box = {}

    def run():
        box["job"] = make_job()
        try:
            box["bundle"] = box["job"].run()
        except Exception as exc:  # noqa: BLE001 - handed to the test
            box["error"] = exc

    t = threading.Thread(target=run)
    t.start()
    return t, box


def _run_job(make_job, log, chunks, payloads):
    """Run the job in a thread, append each chunk after the previous
    re-rank landed; returns (thread, box)."""
    t, box = _start(make_job)
    for i, (seq, cc, ss) in enumerate(chunks):
        log.append(seq, cc, ss)
        deadline = time.time() + 60.0
        while len(payloads) < i + 1 and "error" not in box \
                and time.time() < deadline:
            time.sleep(0.02)
        if "error" in box:
            break
    return t, box


def _stream_job(tmp_path, formulas, payloads):
    """(a maker of the stream job, its chunk log, its config)."""
    sm = _sm(tmp_path)

    def make():
        return StreamSearchJob(
            ds_id="live", ds_name="live", input_path="stream://live",
            ds_config=DSConfig.from_dict(ADDUCTS), sm_config=sm,
            formulas=formulas, on_partial=payloads.append)

    return make, ChunkLog(tmp_path / "work" / "stream", "live"), sm


def test_each_provisional_rescore_equals_a_direct_search(fixture_path,
                                                          tmp_path,
                                                          monkeypatch):
    """Every provisional payload, and the re-score's whole bundle, equals a
    direct ``MSMBasicSearch`` over the same prefix of chunks (exact
    frames); the sealed stream's final pass is the batch run."""
    path, truth = fixture_path
    formulas = truth.formulas[:8]
    rec = _Recorder(monkeypatch)
    payloads: list = []
    make, log, sm = _stream_job(tmp_path, formulas, payloads)
    coords, spectra = _read_spectra(path)
    chunks = _chunked(coords, spectra, 3)
    t, box = _run_job(make, log, chunks, payloads)
    log.finish()
    t.join(timeout=120.0)
    assert "error" not in box, box
    assert len(payloads) == 3 and box["job"].reranks == 3
    provisional = [(ds, b) for p, ds, b in rec.bundles if p]
    assert len(provisional) == 3
    dc = DSConfig.from_dict(ADDUCTS)
    for k, (payload, (ds, got)) in enumerate(zip(payloads, provisional)):
        prefix = ChunkLog(tmp_path / "work" / "stream",
                          "live").assemble_dataset(list(range(k + 1)))
        assert np.array_equal(ds.mzs_flat, prefix.mzs_flat)
        want = msm_basic.MSMBasicSearch(prefix, formulas, dc, sm).search()
        for name in ("annotations", "all_metrics"):
            pd.testing.assert_frame_equal(
                getattr(got, name).reset_index(drop=True),
                getattr(want, name).reset_index(drop=True), check_exact=True)
        ann = want.annotations
        top = ann.sort_values("msm", ascending=False).head(5)
        assert payload["stream"]["chunks"] == k + 1
        assert payload["stream"]["pixels"] == prefix.n_spectra
        assert payload["n_scored"] == len(want.all_metrics)
        assert payload["annotations"] == len(ann)
        assert payload["fdr_10pct"] == int((ann["fdr"] <= 0.1).sum())
        assert payload["top"] == [
            {"sf": str(r.sf), "adduct": str(r.adduct),
             "msm": round(float(r.msm), 6), "fdr": round(float(r.fdr), 6)}
            for r in top.itertuples()]
    final = [b for p, _ds, b in rec.bundles if not p]
    assert len(final) == 1
    pd.testing.assert_frame_equal(final[0].annotations,
                                  box["bundle"].annotations, check_exact=True)


@pytest.mark.parametrize("fault,fails", [
    (_build.KernelError("moments kernel launch: invalid argument"), True),
    (ConnectionError("transient device link reset"), False),
])
def test_kernel_error_in_a_rescore_fails_the_attempt(fixture_path, tmp_path,
                                                      monkeypatch, fault,
                                                      fails):
    """The departure: a ``KernelError`` (a program fault) inside a
    provisional re-score fails the stream attempt, where the JAX package
    keeps a stale preview; a transient device fault still leaves the
    preview stale, and the sealed stream converges."""
    path, truth = fixture_path
    rec = _Recorder(monkeypatch, fault=fault)
    payloads: list = []
    make, log, _sm_cfg = _stream_job(tmp_path, truth.formulas[:3], payloads)
    coords, spectra = _read_spectra(path)
    t, box = _start(make)
    log.append(0, coords, spectra)
    deadline = time.time() + 60.0
    while rec.raised == 0 and time.time() < deadline:
        time.sleep(0.02)
    assert rec.raised == 1
    if not fails:
        log.finish()
    t.join(timeout=120.0)
    assert not t.is_alive()
    assert payloads == [] and box["job"].reranks == 0
    if fails:
        assert isinstance(box.get("error"), _build.KernelError), box
    else:
        assert "error" not in box, box
        stored = pd.read_parquet(tmp_path / "res" / "live" /
                                 "annotations.parquet")
        pd.testing.assert_frame_equal(
            stored, box["bundle"].annotations.reset_index(drop=True),
            check_exact=True)
