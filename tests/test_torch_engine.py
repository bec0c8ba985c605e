"""The port's engine layer on the CPU, held to the JAX package's.

Ports of ``tests/test_engine.py``'s storage, work-dir, mol-DB, PNG and
fetcher tests, each with a cross-read: what the port writes (ledger rows,
index rows, parquet, the sparse ion-image npz, the read segment, the mol
DB) the JAX package reads back equal, and the other way round.  Then the
isotope-pattern cache: shards written by either package's
``IsocalcWrapper(cache_dir=...)`` load in the other's with equal patterns
(the same parameter key, shard names and format), a corrupt shard is
skipped, ``PatternStream.result_table()`` equals ``pattern_table``, and
``IsotopePrefetch`` gives the search the same table and decoys as a plain
search.  Also: the config's unported blocks, failpoint grammar parity,
tracing to a file, device memory on the CPU.  Patterns are compared
exactly (f64 arrays through npz).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from sm_distributed_tpu_torch.engine.moldb import MolecularDB
from sm_distributed_tpu_torch.engine.storage import (
    AnnotationIndex,
    JobLedger,
    SearchResultsStore,
)
from sm_distributed_tpu_torch.engine.work_dir import WorkDirManager
from sm_distributed_tpu_torch.models.msm_basic import SearchResultsBundle
from sm_distributed_tpu_torch.ops.isocalc import IsocalcWrapper
from sm_distributed_tpu_torch.utils.config import (
    IsotopeGenerationConfig,
    SMConfig,
)


@pytest.fixture(autouse=True)
def _reset_port_config():
    """The CLI sets the port's process-global SMConfig and adds handlers to
    the engine's logger (bound to this test's captured stderr): isolate
    tests from both."""
    log = logging.getLogger("sm-tpu")
    handlers, level = list(log.handlers), log.level
    SMConfig._instance = None
    yield
    SMConfig._instance = None
    for h in log.handlers[:]:
        if h not in handlers:
            log.removeHandler(h)
            h.close()
    log.setLevel(level)


def _ann_df():
    return pd.DataFrame({
        "sf": ["C6H12O6", "C5H5N5"],
        "adduct": ["+H", "+H"],
        "msm": [0.9, 0.4],
        "fdr": [0.01, 0.3],
        "fdr_level": [0.05, 0.5],
        "chaos": [0.95, 0.6],
        "spatial": [0.97, 0.7],
        "spectral": [0.98, 0.95],
    })


# ------------------------------------------------------------------ storage
def test_ledger_job_lifecycle(tmp_path):
    from sm_distributed_tpu.engine.storage import JobLedger as JLedger

    ledger = JobLedger(tmp_path / "res")
    ledger.upsert_dataset("ds1", "my ds", "/in", {"k": 1})
    job = ledger.start_job("ds1")
    assert ledger.job_status(job) == "STARTED"
    ledger.finish_job(job)
    assert ledger.job_status(job) == "FINISHED"
    job2 = ledger.start_job("ds1")
    ledger.fail_job(job2, "boom")
    jobs = ledger.jobs("ds1")
    assert list(jobs.status) == ["FINISHED", "FAILED"]
    assert "boom" in jobs.error.iloc[1]
    # cross-read both ways: the JAX ledger sees the port's rows, and the
    # port sees a row the JAX ledger adds to the same file
    jl = JLedger(tmp_path / "res")
    pd.testing.assert_frame_equal(jl.jobs("ds1"), jobs)
    j3 = jl.start_job("ds1")
    jl.finish_job(j3)
    assert ledger.job_status(j3) == "FINISHED"
    assert list(ledger.jobs().status) == ["FINISHED", "FAILED", "FINISHED"]


def test_annotation_index_roundtrip_and_job_scoped_delete(tmp_path):
    from sm_distributed_tpu.engine.storage import AnnotationIndex as JIndex
    from sm_distributed_tpu.engine.storage import JobLedger as JLedger

    ledger = JobLedger(tmp_path / "res")
    index = AnnotationIndex(ledger)
    n = index.index_ds("ds1", 1, _ann_df(),
                       ion_mzs={("C6H12O6", "+H"): 181.07})
    assert n == 2
    hits = index.search(ds_id="ds1", max_fdr_level=0.1)
    assert list(hits.sf) == ["C6H12O6"]
    assert hits.mz.iloc[0] == pytest.approx(181.07)
    assert list(index.search(mz_min=181.0, mz_max=181.1).sf) == ["C6H12O6"]
    assert index.search(mz_min=200.0).empty
    jindex = JIndex(JLedger(tmp_path / "res"))
    pd.testing.assert_frame_equal(jindex.search(ds_id="ds1"),
                                  index.search(ds_id="ds1"))
    # job-scoped delete must not erase other jobs' rows
    index._conn.execute(
        "INSERT INTO annotation VALUES('ds1',2,'X','+H',1,0.5,0.1,0.2,0.5,"
        "0.5,0.5)")
    index.delete_ds("ds1", job_id=2)
    assert len(index.search(ds_id="ds1")) == 2
    # the JAX index writes, the port's reads
    jindex.index_ds("ds2", 7, _ann_df())
    assert list(index.search(ds_id="ds2").job_id) == [7, 7]
    index.delete_ds("ds1")
    assert index.search(ds_id="ds1").empty


def _bundle():
    return SearchResultsBundle(
        annotations=_ann_df(),
        all_metrics=_ann_df()[["sf", "adduct", "chaos", "spatial",
                               "spectral", "msm"]],
        timings={"score": 1.0})


def test_results_store_parquet_and_images(tmp_path):
    from sm_distributed_tpu.engine.index import SegmentReader
    from sm_distributed_tpu.engine.storage import JobLedger as JLedger
    from sm_distributed_tpu.engine.storage import (
        SearchResultsStore as JStore,
    )
    from sm_distributed_tpu_torch.engine.index import load_segment

    ledger = JobLedger(tmp_path / "res")
    store = SearchResultsStore(ledger)
    d = store.store("ds1", 1, _bundle(), {("C6H12O6", "+H"): 181.07})
    assert (d / "annotations.parquet").exists()
    back = pd.read_parquet(d / "annotations.parquet")
    assert list(back.sf) == ["C6H12O6", "C5H5N5"]
    assert json.loads((d / "timings.json").read_text()) == {"score": 1.0}
    rng = np.random.default_rng(0)
    imgs = rng.random((2, 4, 12)).astype(np.float32)
    imgs[imgs < 0.5] = 0.0
    path = store.store_ion_images("ds1", imgs, [("A", "+H"), ("B", "+Na")],
                                  3, 4)
    dense, ions = SearchResultsStore.load_ion_images(path)
    assert ions == [("A", "+H"), ("B", "+Na")]
    np.testing.assert_array_equal(dense.reshape(2, 4, 12), imgs)
    # the JAX package reads the port's images and read segment
    jdense, jions = JStore.load_ion_images(path)
    assert jions == ions
    np.testing.assert_array_equal(jdense, dense)
    seg = SegmentReader(tmp_path / "res").load("ds1")
    assert seg.rows() == load_segment(d / "segment.npz").rows()
    assert seg.rows()[0]["mz"] == pytest.approx(181.07)
    # and the port reads the JAX package's
    jstore = JStore(JLedger(tmp_path / "jres"))
    jd = jstore.store("ds9", 3, _bundle())
    jpath = jstore.store_ion_images("ds9", imgs[::-1].copy(),
                                    [("B", "+Na"), ("A", "+H")], 3, 4)
    pdense, pions = SearchResultsStore.load_ion_images(jpath)
    assert pions == [("B", "+Na"), ("A", "+H")]
    np.testing.assert_array_equal(pdense.reshape(2, 4, 12), imgs[::-1])
    assert load_segment(jd / "segment.npz").rows() == \
        SegmentReader(tmp_path / "jres").load("ds9").rows()
    cols = ["sf", "adduct", "msm", "fdr", "fdr_level", "chaos", "spatial",
            "spectral"]
    pd.testing.assert_frame_equal(
        AnnotationIndex(JobLedger(tmp_path / "jres")).search(ds_id="ds9")[
            cols], AnnotationIndex(ledger).search(ds_id="ds1")[cols])


def test_store_images_byte_equal_to_the_jax_store(tmp_path):
    """The same images stored by both packages: equal npz members."""
    from sm_distributed_tpu.engine.storage import JobLedger as JLedger
    from sm_distributed_tpu.engine.storage import (
        SearchResultsStore as JStore,
    )

    rng = np.random.default_rng(4)
    imgs = (rng.random((3, 2, 20)) * (rng.random((3, 2, 20)) < 0.3)
            ).astype(np.float32)
    ions = [("A", "+H"), ("B", "+K"), ("C", "+Na")]
    a = SearchResultsStore(JobLedger(tmp_path / "p")).store_ion_images(
        "d", imgs, ions, 4, 5)
    b = JStore(JLedger(tmp_path / "j")).store_ion_images("d", imgs, ions,
                                                         4, 5)
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        np.testing.assert_array_equal(za[k], zb[k])


def test_work_dir_staging_resume_and_subdirs(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.imzML").write_text("x")
    (src / "sub" / "a.imzML").write_text("y")
    wd = WorkDirManager(tmp_path / "work", "ds1")
    dst = wd.copy_input_data(src)
    assert (dst / "a.imzML").read_text() == "x"
    assert (dst / "sub" / "a.imzML").read_text() == "y"
    marker = dst / "marker"
    marker.write_text("m")
    assert wd.copy_input_data(src) == dst
    assert marker.exists(), "unchanged input must not re-stage"
    (src / "a.imzML").write_text("xx")
    wd.copy_input_data(src)
    assert not marker.exists()
    assert wd.imzml_path().name == "a.imzML"
    # the JAX package's work dir takes the port's staging as current
    from sm_distributed_tpu.engine.work_dir import WorkDirManager as JWork

    (dst / "marker").write_text("m")
    JWork(tmp_path / "work", "ds1").copy_input_data(src)
    assert (dst / "marker").exists()
    wd.clean()
    assert not wd.path.exists()


def test_work_dir_resumes_a_partial_staging(tmp_path):
    """A staging cut after its first file refetches only what is missing."""
    src = tmp_path / "src"
    src.mkdir()
    for name in ("a.bin", "b.bin"):
        (src / name).write_bytes(name.encode() * 100)

    class Counting:
        def __init__(self):
            from sm_distributed_tpu_torch.engine.work_dir import LocalFetcher

            self.inner, self.fetched = LocalFetcher(), []

        def list_files(self, s):
            return self.inner.list_files(s)

        def fetch_file(self, s, rel, dst):
            self.fetched.append(rel)
            if rel == "b.bin" and len(self.fetched) == 2:
                raise OSError("link dropped")
            self.inner.fetch_file(s, rel, dst)

    f = Counting()
    wd = WorkDirManager(tmp_path / "work", "ds", fetcher=f)
    with pytest.raises(OSError, match="link dropped"):
        wd.copy_input_data(src)
    wd.copy_input_data(src)
    assert f.fetched == ["a.bin", "b.bin", "b.bin"]
    assert (wd.path / "input" / "b.bin").read_bytes() == b"b.bin" * 100


def test_moldb_import_and_lookup(tmp_path):
    from sm_distributed_tpu.engine.moldb import MolecularDB as JMolDB
    from sm_distributed_tpu.engine.storage import JobLedger as JLedger

    csv = tmp_path / "db.csv"
    csv.write_text("id,name,formula\n1,Glucose,C6H12O6\n2,Dup,C6H12O6\n"
                   "3,Adenine,C5H5N5\n")
    db = MolecularDB(JobLedger(tmp_path / "res"))
    assert db.import_csv(csv, "HMDB", "v1") == 3
    assert db.formulas("HMDB", "v1") == ["C6H12O6", "C5H5N5"]
    assert db.databases() == [("HMDB", "v1")]
    jdb = JMolDB(JLedger(tmp_path / "res"))
    assert jdb.formulas("HMDB", "v1") == db.formulas("HMDB", "v1")
    csv.write_text("sf\nC16H32O2\n")
    assert jdb.import_csv(csv, "HMDB", "v2") == 1
    assert db.formulas("HMDB") == ["C16H32O2"]
    assert db.databases() == [("HMDB", "v1"), ("HMDB", "v2")]
    with pytest.raises(KeyError):
        db.formulas("nope")
    with pytest.raises(ValueError):
        bad = tmp_path / "bad.csv"
        bad.write_text("x,y\n1,2\n")
        db.import_csv(bad, "B", "1")


def test_png_generator(tmp_path):
    pytest.importorskip("PIL")
    from sm_distributed_tpu.engine.png import PngGenerator as JPng
    from sm_distributed_tpu_torch.engine.png import PngGenerator

    img = np.zeros((8, 10))
    img[2:5, 3:7] = np.arange(12).reshape(3, 4)
    mask = img > -1
    mask[0, 0] = False
    gen = PngGenerator(mask=mask)
    data = gen.render(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert data == JPng(mask=mask).render(img)
    p = gen.save(img, tmp_path / "ion.png")
    from PIL import Image

    arr = np.asarray(Image.open(p))
    assert arr.shape == (8, 10, 4)
    assert arr[0, 0, 3] == 0
    assert arr[3, 4, 3] == 255


def test_work_dir_file_uri(tmp_path):
    from sm_distributed_tpu_torch.engine.search_job import SearchJob
    from sm_distributed_tpu_torch.utils.config import DSConfig

    src = tmp_path / "in"
    src.mkdir()
    (src / "a.imzML").write_text("x")
    wd = WorkDirManager(tmp_path / "work", "dsf")
    dst = wd.copy_input_data(f"file://{src}")
    assert (dst / "a.imzML").read_text() == "x"
    job = SearchJob("u1", "u", f"file://{src}/a.imzML", DSConfig(),
                    SMConfig.from_dict({
                        "storage": {"results_dir": str(tmp_path / "res")},
                        "work_dir": str(tmp_path / "work")}))
    assert job.input_path == f"file://{src}/a.imzML"


def test_work_dir_s3_scheme_guidance():
    from sm_distributed_tpu_torch.engine.work_dir import resolve_fetcher

    with pytest.raises(ImportError, match="boto3"):
        resolve_fetcher("s3://bucket/ds")
    with pytest.raises(ValueError, match="unsupported input scheme"):
        resolve_fetcher("gopher://x")


class _FakeS3ClientError(Exception):
    def __init__(self, status):
        self.response = {"ResponseMetadata": {"HTTPStatusCode": status}}


class _FakeS3Client:
    """boto3-shaped double over an in-memory {key: bytes} store."""

    class exceptions:  # noqa: N801 — boto3 client namespace shape
        ClientError = _FakeS3ClientError

    def __init__(self, objects):
        self.objects = dict(objects)
        self.list_calls = []

    def head_object(self, Bucket, Key):
        if Key not in self.objects:
            raise _FakeS3ClientError(404)
        return {"ContentLength": len(self.objects[Key]),
                "ETag": f'"etag-{Key}"'}

    def get_paginator(self, op):
        client = self

        class _Pager:
            def paginate(self, Bucket, Prefix):
                client.list_calls.append(Prefix)
                contents = [{"Key": k, "Size": len(v), "ETag": f'"etag-{k}"'}
                            for k, v in sorted(client.objects.items())
                            if k.startswith(Prefix)]
                yield {"Contents": contents} if contents else {}

        return _Pager()

    def download_file(self, bucket, key, dst):
        Path(dst).write_bytes(self.objects[key])


def test_s3_fetcher_exact_key_and_prefix(tmp_path):
    """An exact .imzML key stages its .ibd sibling (HEAD requests, no
    prefix scan); a prefix stages its directory and never a sibling
    prefix."""
    from sm_distributed_tpu_torch.engine.work_dir import S3Fetcher

    client = _FakeS3Client({"data/ds1.imzML": b"imzml-bytes",
                            "data/ds1.ibd": b"ibd-bytes",
                            "data/ds10.imzML": b"other"})
    f = S3Fetcher(client=client)
    assert sorted(f.list_files("s3://bucket/data/ds1.imzML")) == [
        "ds1.ibd", "ds1.imzML"]
    assert client.list_calls == []
    wd = WorkDirManager(tmp_path / "work", "s3ds", fetcher=f)
    dst = wd.copy_input_data("s3://bucket/data/ds1.imzML")
    assert (dst / "ds1.imzML").read_bytes() == b"imzml-bytes"
    assert (dst / "ds1.ibd").read_bytes() == b"ibd-bytes"
    client2 = _FakeS3Client({"pre/ds1/a.imzML": b"a", "pre/ds1/a.ibd": b"b",
                             "pre/ds10/x.imzML": b"c"})
    listing = S3Fetcher(client=client2).list_files("s3://bucket/pre/ds1")
    assert sorted(listing) == ["a.ibd", "a.imzML"]
    assert client2.list_calls == ["pre/ds1/"]


# ------------------------------------------------------ isotope-pattern cache
ADDUCTS = ("+H", "+Na")
FORMULAS = ["C6H12O6", "C5H5N5", "C16H32O2", "C27H46O", "C9H13N3O5",
            "C40H80NO8P", "C3H7NO3", "C4H6O4"]
PAIRS = [(sf, ad) for sf in FORMULAS for ad in ADDUCTS]


def _jwrapper(cache_dir, **kw):
    from sm_distributed_tpu.ops.isocalc import IsocalcWrapper as JWrapper
    from sm_distributed_tpu.utils.config import (
        IsotopeGenerationConfig as JIso,
    )

    return JWrapper(JIso(adducts=ADDUCTS), cache_dir=cache_dir, n_procs=1,
                    device_blur=False, **kw)


def _pwrapper(cache_dir, **kw):
    return IsocalcWrapper(IsotopeGenerationConfig(adducts=ADDUCTS),
                          cache_dir=cache_dir, n_procs=1, **kw)


def _assert_tables_equal(a, b):
    assert list(a.sfs) == list(b.sfs) and list(a.adducts) == list(b.adducts)
    for f in ("mzs", "ints", "n_valid", "targets"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_isocalc_shards_cross_read(tmp_path, writer):
    """Shards written by one package load in the other's wrapper: the same
    shard names (parameter key, job tag, chunk index), the same patterns,
    nothing recomputed."""
    cache = tmp_path / "cache"
    make_w, make_r = ((_jwrapper, _pwrapper) if writer == "jax"
                      else (_pwrapper, _jwrapper))
    want = make_w(cache, chunk_size=5).pattern_table(PAIRS)
    names = sorted(p.name for p in cache.glob("theor_peaks_*.npz"))
    assert len(names) == -(-len(PAIRS) // 5)
    reader = make_r(cache, chunk_size=5)
    assert len(reader._cache) == len(PAIRS)
    got = reader.pattern_table(PAIRS)
    _assert_tables_equal(got, want)
    assert sorted(p.name for p in cache.glob("theor_peaks_*.npz")) == names
    # the other package, cold, names its shards the same
    other = tmp_path / "other"
    make_r(other, chunk_size=5).pattern_table(PAIRS)
    assert sorted(p.name for p in other.glob("theor_peaks_*.npz")) == names
    assert _pwrapper(None)._param_key() == _jwrapper(None)._param_key()


def test_isocalc_corrupt_shard_is_skipped_and_recomputed(tmp_path):
    cache = tmp_path / "cache"
    want = _pwrapper(cache, chunk_size=4).pattern_table(PAIRS)
    shards = sorted(cache.glob("theor_peaks_*.npz"))
    # flip payload bytes in place: the zip still opens, the CRC catches it
    raw = bytearray(shards[1].read_bytes())
    mid = len(raw) // 2
    raw[mid:mid + 8] = bytes(8)
    shards[1].write_bytes(bytes(raw))
    w = _pwrapper(cache, chunk_size=4)
    assert len(w._cache) == len(PAIRS) - 4
    assert not shards[1].exists()          # the poison file is unlinked
    _assert_tables_equal(w.pattern_table(PAIRS), want)
    # a truncated shard (a torn write) is skipped the same way
    shards = sorted(cache.glob("theor_peaks_*.npz"))
    shards[0].write_bytes(shards[0].read_bytes()[:100])
    w2 = _pwrapper(cache, chunk_size=4)
    assert len(w2._cache) == len(PAIRS) - 4
    _assert_tables_equal(w2.pattern_table(PAIRS), want)


def test_pattern_stream_matches_pattern_table_and_jax(tmp_path):
    """A stream's result table equals the blocking table, the JAX
    package's, and its prefix fills row by row; duplicates and invalid
    chemistry are dropped as in the reference."""
    pairs = PAIRS + [("C6H12O6", "+H"), ("C", "-H")]
    flags = [i % 3 != 0 for i in range(len(pairs))]
    stream = _pwrapper(None, chunk_size=3).stream_table(pairs, flags)
    got = stream.result_table()
    assert stream.ready_rows() == stream.n_ions == len(PAIRS)
    assert stream.wait_rows(len(PAIRS)) == len(PAIRS)
    _assert_tables_equal(got, _pwrapper(None).pattern_table(pairs, flags))
    _assert_tables_equal(got, _jwrapper(None).pattern_table(pairs, flags))
    assert got.mzs.shape == (len(PAIRS), 4)


def test_pattern_stream_cancel_stops_generation(tmp_path):
    stream = _pwrapper(tmp_path / "c", chunk_size=1).stream_table(PAIRS)
    stream.cancel()
    assert stream.ready_rows() <= len(PAIRS)
    assert not stream._thread.is_alive()


def test_isotope_prefetch_matches_plain_search(tmp_path):
    """``IsotopePrefetch`` gives the search the decoys and the table a plain
    search computes, and its pattern stream writes the cache shards."""
    from sm_distributed_tpu_torch.io.fixtures import synthetic_dataset_arrays
    from sm_distributed_tpu_torch.models.msm_basic import (
        IsotopePrefetch,
        MSMBasicSearch,
    )
    from sm_distributed_tpu_torch.utils.config import DSConfig

    ds, truth = synthetic_dataset_arrays(nrows=6, ncols=7, noise_peaks=5,
                                         seed=3)
    formulas = list(truth.formulas)[:6]
    dc = DSConfig.from_dict({"isotope_generation": {"adducts": ["+H"]}})
    sm = SMConfig.from_dict({"device": "cpu",
                             "fdr": {"decoy_sample_size": 3},
                             "parallel": {"isocalc_workers": 1}})
    pre = IsotopePrefetch(formulas, dc, sm, str(tmp_path / "cache"))
    fdr, assignment, stream = pre.result()
    plain = MSMBasicSearch(ds, formulas, dc, sm)
    want = plain.search()
    got_search = MSMBasicSearch(ds, formulas, dc, sm, prefetch=pre)
    got = got_search.search()
    _assert_tables_equal(got_search.last_table, plain.last_table)
    pd.testing.assert_frame_equal(got.all_metrics, want.all_metrics,
                                  check_exact=True)
    pd.testing.assert_frame_equal(got.annotations, want.annotations,
                                  check_exact=True)
    assert "decoy_selection" in got.timings
    assert list((tmp_path / "cache").glob("theor_peaks_*.npz"))


# ------------------------------------------------------------- config, utils
@pytest.mark.parametrize("d,item", [
    ({"service": {"fleet": {"enabled": True}}}, "item 9"),
    ({"service": {"fleetview": {"enabled": True}}}, "item 9"),
    ({"telemetry": {"retrace": False}}, "item 9"),
    ({"service": {"prime": {"idle_after_s": 60.0}}}, "item 9"),
    ({"parallel": {"num_processes": 2}}, "item 7"),
    ({"parallel": {"coordinator_address": "localhost:1"}}, "item 7"),
    ({"parallel": {"pixels_axis": 2}}, "item 7"),
    ({"parallel": {"compile_cache_dir": "/x"}}, "item 9"),
])
def test_unported_config_raises_naming_its_item(d, item):
    """Every knob of the JAX package's config is the port's now: the item 9
    knobs (the fleet, the fleet view, the primer, the build census and the
    kernel build directory) are accepted at the JAX package's values and
    reach the config, as the item 7 knobs (the mesh and the multi-process
    runtime) reach the mesh or the runtime.  Nothing raises
    ``NotImplementedError``."""
    if item != "item 7":
        sm = SMConfig.from_dict(d)
        (section, block), = d.items()
        got = getattr(sm, section)
        for key, value in block.items():
            if isinstance(value, dict):
                for k, v in value.items():
                    assert getattr(getattr(got, key), k) == v
            else:
                assert getattr(got, key) == value
        return
    from sm_distributed_tpu_torch.parallel import distributed, mesh

    par = SMConfig.from_dict(d).parallel
    for key, value in d["parallel"].items():
        assert getattr(par, key) == value
    if "pixels_axis" in d["parallel"]:
        assert mesh.make_mesh(par, device="cpu").shape == {
            "pixels": 2, "formulas": 1}
    else:
        coord, n_proc, _pid = distributed.resolve_distributed_settings(par)
        assert (coord, n_proc) == (par.coordinator_address,
                                   par.num_processes)


def test_config_blocks_and_process_global(tmp_path):
    p = tmp_path / "sm.json"
    p.write_text(json.dumps({
        "device": "cpu", "work_dir": str(tmp_path / "w"), "logs_dir": "",
        "storage": {"results_dir": "r", "image_format": "png"},
        "tracing": {"enabled": False, "ring_size": 16},
        "logs": {"json": True}, "failpoints": "",
        "parallel": {"isocalc_chunk": 64, "overlap_isocalc": "off",
                     "checkpoint_every": 0, "compile_cache_dir": "",
                     "isocalc_device": "off"}}))
    sm = SMConfig.set_path(p)
    assert SMConfig.get_conf() is sm
    assert sm.storage.image_format == "png" and sm.logs.json
    assert sm.trace_dir == str(tmp_path / "w" / "traces")
    assert sm.parallel.isocalc_chunk == 64
    with pytest.raises(ValueError, match="unknown"):
        SMConfig.from_dict({"storage": {"bogus": 1}})
    with pytest.raises(ValueError):
        SMConfig.from_dict({"storage": {"image_format": "tiff"}})


@pytest.mark.parametrize("spec", [
    "storage.results_rename=crash@2;isocalc.shard_save=torn",
    "workdir.fetch=raise:OSError?0.5", "a=sleep:0.1@3", "b=enospc",
    "c=raise:NotAnError", "d=torn:1.5", "e", "f=explode"])
def test_failpoint_grammar_matches_the_jax_package(spec):
    from sm_distributed_tpu.utils import failpoints as jfp
    from sm_distributed_tpu_torch.utils import failpoints as pfp

    def parse(mod):
        try:
            return {k: (v.action, v.arg, v.nth, v.prob)
                    for k, v in mod.parse_failpoints(spec).items()}
        except ValueError as exc:
            return type(exc)

    assert parse(pfp) == parse(jfp)


def test_failpoint_fires_in_the_port_store(tmp_path):
    from sm_distributed_tpu_torch.utils import failpoints

    store = SearchResultsStore(JobLedger(tmp_path / "res"))
    store.store("ds1", 1, _bundle())
    failpoints.configure("storage.results_rename=raise:OSError@1")
    try:
        with pytest.raises(OSError, match="injected failpoint"):
            store.store("ds1", 2, _bundle())
    finally:
        failpoints.reset()
    # the previous job's index rows survive the failed store
    assert list(store.index.search(ds_id="ds1").job_id) == [1, 1]


def test_tracing_to_a_file(tmp_path):
    from sm_distributed_tpu_torch.utils import tracing

    ctx = tracing.new_trace(job_id="j", trace_dir=tmp_path)
    with tracing.attach(ctx):
        with tracing.span("phase_a", phase=True):
            tracing.event("hello", n=1)
        with pytest.raises(RuntimeError):
            with tracing.span("boom"):
                raise RuntimeError("x")
    tracing.emit_span(ctx, "submit", ts=1.0, dur=2.0, span_id=ctx.span_id)
    tracing.close_files()
    recs = tracing.read_trace(ctx.file)
    names = [(r["kind"], r["name"]) for r in recs]
    assert names == [("event", "hello"), ("span", "phase_a"), ("span", "boom"),
                     ("span", "submit")]
    assert recs[1]["parent_id"] == ctx.span_id == recs[3]["span_id"]
    assert recs[0]["span_id"] == recs[1]["span_id"]
    assert "RuntimeError" in recs[2]["attrs"]["error"]
    assert tracing.flight_recorder.recent(4)[-1]["name"] == "submit"


def test_devicemem_and_cancel_on_the_cpu():
    from sm_distributed_tpu_torch.utils import devicemem
    from sm_distributed_tpu_torch.utils.cancel import (
        CancelToken,
        DeadlineExceededError,
        JobCancelledError,
    )

    s = devicemem.hbm_summary()
    if s["device_count"] == 0:
        assert s["hbm_peak_bytes"] is None and s["hbm_bytes_in_use"] is None
    tok = CancelToken()
    tok.check("a")
    assert tok.cancel("first") and not tok.cancel("second")
    with pytest.raises(JobCancelledError, match="first"):
        tok.check("b")
    with pytest.raises(DeadlineExceededError):
        CancelToken(deadline_at=1.0).check("c")
