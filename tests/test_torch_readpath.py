"""The port's read path (``engine/index.py`` ``SegmentReader`` and
``service/readpath.py``) against the JAX package's, on the CPU.

Each case makes the same calls on both packages over the same stored
results (segments published by the port's writer, ion images stored by the
port's results store) and holds the outcomes equal, exactly: page bodies,
cursors (byte-equal), status codes, error bodies, ``Retry-After`` headers,
tile bytes, cache statistics and the ``sm_read_*`` metrics text.  The
outcomes the JAX package's ``tests/test_readpath.py`` asserts are asserted
on the port's copy too: parity against a brute-force scan of the table,
keyset pagination, cohorts, atomic republish, tile bytes bit-identical to
``engine/png.py``, the governed LRU and read admission.  Last, the port's
``AnnotationService`` with the default config serves the read routes over
a stored job with bodies equal to the JAX package's handlers.
"""

from __future__ import annotations

import itertools
import json
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pandas as pd
import pytest

from sm_distributed_tpu.engine import index as jindex
from sm_distributed_tpu.service import metrics as jmetrics
from sm_distributed_tpu.service import readpath as jreadpath
from sm_distributed_tpu.utils import config as jconfig
from sm_distributed_tpu.utils import failpoints as jfailpoints
from sm_distributed_tpu_torch.engine import index as tindex
from sm_distributed_tpu_torch.engine import png as tpng
from sm_distributed_tpu_torch.engine.storage import SearchResultsStore
from sm_distributed_tpu_torch.service import metrics as tmetrics
from sm_distributed_tpu_torch.service import readpath as treadpath
from sm_distributed_tpu_torch.utils import config as tconfig
from sm_distributed_tpu_torch.utils import failpoints as tfailpoints

PACKAGES = {
    "jax": dict(index=jindex, readpath=jreadpath, config=jconfig,
                failpoints=jfailpoints, metrics=jmetrics),
    "torch": dict(index=tindex, readpath=treadpath, config=tconfig,
                  failpoints=tfailpoints, metrics=tmetrics),
}


def _both(fn):
    return {name: fn(mods) for name, mods in PACKAGES.items()}


@pytest.fixture(autouse=True)
def _reset_failpoints():
    jfailpoints.reset()
    tfailpoints.reset()
    yield
    jfailpoints.reset()
    tfailpoints.reset()


# ------------------------------------------------------------------ fixtures
def _annotations(n: int, seed: int = 0) -> pd.DataFrame:
    """A synthetic annotation table with ties, NaNs and repeated formulas
    (the JAX package's test table)."""
    rng = np.random.default_rng(seed)
    sfs = [f"C{i % 7 + 1}H{i % 5 + 2}O{i % 3}" for i in range(n)]
    adducts = [("+H", "+Na", "+K")[i % 3] for i in range(n)]
    msm = np.round(rng.uniform(0, 1, n), 2)
    msm[:: max(1, n // 5)] = 0.5
    fdr = np.round(rng.uniform(0, 0.5, n), 3)
    fdr_level = rng.choice([0.05, 0.1, 0.2, 0.5, np.nan], n)
    return pd.DataFrame({
        "sf": sfs, "adduct": adducts, "msm": msm, "fdr": fdr,
        "fdr_level": fdr_level,
        "chaos": rng.uniform(0, 1, n), "spatial": rng.uniform(0, 1, n),
        "spectral": rng.uniform(0, 1, n)})


def _publish(results_dir, ds_id: str, n: int, seed: int = 0,
             job_id: int = 1) -> pd.DataFrame:
    """Publish through the port's writer."""
    d = results_dir / ds_id
    d.mkdir(parents=True, exist_ok=True)
    df = _annotations(n, seed)
    mzs = {(r.sf, r.adduct): 100.0 + i
           for i, r in enumerate(df.itertuples())}
    tindex.publish_segment(d, ds_id, job_id, df, mzs)
    return df


def _brute_rows(df: pd.DataFrame) -> list[dict]:
    rows = []
    for i, r in enumerate(df.itertuples()):
        rows.append({"sf": r.sf, "adduct": r.adduct, "mz": 100.0 + i,
                     "msm": r.msm, "fdr": r.fdr,
                     "fdr_level": None if np.isnan(r.fdr_level)
                     else r.fdr_level,
                     "chaos": r.chaos, "spatial": r.spatial,
                     "spectral": r.spectral})
    return rows


def _brute_query(rows, *, sf=None, adduct=None, max_fdr_level=None,
                 min_msm=None, mz_min=None, mz_max=None,
                 order="msm", direction="desc"):
    """Filter + total-order sort, written independently of both engines."""
    out = []
    for r in rows:
        if sf is not None and r["sf"] != sf:
            continue
        if adduct is not None and r["adduct"] != adduct:
            continue
        if max_fdr_level is not None and (
                r["fdr_level"] is None or r["fdr_level"] > max_fdr_level):
            continue
        if min_msm is not None and (r["msm"] is None or r["msm"] < min_msm):
            continue
        if mz_min is not None and (r["mz"] is None or r["mz"] < mz_min):
            continue
        if mz_max is not None and (r["mz"] is None or r["mz"] > mz_max):
            continue
        out.append(r)

    def key(r):
        v = r[order]
        if order != "sf" and v is None:
            v = float("-inf")
        return (v, r["sf"], r["adduct"])

    out.sort(key=key, reverse=(direction == "desc"))
    return out


def _paged(reader, ds_id, *, limit=7, **kw):
    """Walk every page through the cursor protocol: (rows, total, pages)."""
    rows, cursor, pages = [], None, []
    while True:
        res = reader.query(ds_id, limit=limit, cursor=cursor, **kw)
        rows.extend(res["rows"])
        pages.append(res)
        assert len(pages) < 100, "cursor never terminated"
        if res["next_cursor"] is None:
            return rows, res["total"], pages
        cursor = res["next_cursor"]


def _readers(root):
    return _both(lambda m: m["index"].SegmentReader(root))


# --------------------------------------------------- parity vs brute force
def test_query_parity_vs_brute_force_scan(tmp_path):
    df = _publish(tmp_path, "ds1", n=60, seed=3)
    truth = _brute_rows(df)
    readers = _readers(tmp_path)
    filters = [
        {},
        {"sf": truth[0]["sf"]},
        {"adduct": "+Na"},
        {"max_fdr_level": 0.1},
        {"min_msm": 0.5},
        {"mz_min": 110.0, "mz_max": 140.0},
        {"sf": truth[0]["sf"], "adduct": truth[0]["adduct"],
         "max_fdr_level": 0.5},
    ]
    for kw, order, direction in itertools.product(
            filters, ("msm", "mz", "fdr", "sf"), ("asc", "desc")):
        expect = _brute_query(truth, order=order, direction=direction, **kw)
        got, total, pages = _paged(readers["torch"], "ds1", limit=7,
                                   order=order, direction=direction, **kw)
        # every page, cursors included, equal to the JAX package's reader
        assert pages == _paged(readers["jax"], "ds1", limit=7, order=order,
                               direction=direction, **kw)[2]
        strip = [{k: v for k, v in r.items()
                  if k not in ("ds_id", "job_id")} for r in got]
        approx = [{k: (pytest.approx(v) if isinstance(v, float) else v)
                   for k, v in r.items()} for r in strip]
        assert total == len(expect), (kw, order, direction)
        assert approx == expect, (kw, order, direction)


def test_pagination_is_stable_and_duplicate_free(tmp_path):
    _publish(tmp_path, "ds1", n=41, seed=5)
    readers = _readers(tmp_path)
    rows, total, pages = _paged(readers["torch"], "ds1", limit=4,
                                order="msm", direction="desc")
    assert total == 41 and len(rows) == 41
    keys = [(r["msm"], r["sf"], r["adduct"]) for r in rows]
    assert len(set(keys)) == len(keys)          # keyset: no dup, no skip
    assert keys == sorted(keys, reverse=True)
    cursors = [p["next_cursor"] for p in pages]
    assert cursors == [p["next_cursor"] for p in _paged(
        readers["jax"], "ds1", limit=4, order="msm", direction="desc")[2]]


def test_cursor_minted_under_other_order_rejected(tmp_path):
    _publish(tmp_path, "ds1", n=10)
    readers = _readers(tmp_path)
    res = readers["torch"].query("ds1", order="msm", direction="desc",
                                 limit=3)
    cur = res["next_cursor"]
    assert cur is not None
    # a cursor of either package pages the other's reader the same way
    for name, reader in readers.items():
        err = PACKAGES[name]["index"].CursorError
        assert reader.query("ds1", order="msm", direction="desc", limit=3,
                            cursor=cur) == readers["torch"].query(
            "ds1", order="msm", direction="desc", limit=3, cursor=cur)
        with pytest.raises(err):
            reader.query("ds1", order="mz", direction="desc", cursor=cur)
        with pytest.raises(err):
            reader.query("ds1", order="msm", direction="asc", cursor=cur)
        with pytest.raises(err):
            reader.query("ds1", cursor="!!!not-a-cursor!!!")


# ------------------------------------------------------------------ cohort
def test_cohort_across_three_datasets(tmp_path):
    dfs = {ds: _publish(tmp_path, ds, n=30, seed=i)
           for i, ds in enumerate(("a", "b", "c"))}
    readers = _readers(tmp_path)
    sf = dfs["a"]["sf"].iloc[0]
    res = readers["torch"].cohort(sf)
    assert res == readers["jax"].cohort(sf)
    assert res["sf"] == sf and res["n_datasets"] == 3
    per_ds = {d["ds_id"]: d["rows"] for d in res["datasets"]}
    assert set(per_ds) == {"a", "b", "c"}
    for ds, df in dfs.items():
        assert len(per_ds[ds]) == int((df["sf"] == sf).sum())
        assert all(r["sf"] == sf for r in per_ds[ds])
        msms = [r["msm"] for r in per_ds[ds]]
        assert msms == sorted(msms, reverse=True)
    assert res["n_rows"] == sum(len(v) for v in per_ds.values())
    assert readers["torch"].datasets() == readers["jax"].datasets()


# --------------------------------------------------------- atomic republish
def test_reannotation_atomically_replaces_segment(tmp_path):
    _publish(tmp_path, "ds1", n=20, seed=1, job_id=1)
    reader = tindex.SegmentReader(tmp_path)
    v1 = reader.query("ds1")
    _publish(tmp_path, "ds1", n=35, seed=2, job_id=2)
    v2 = reader.query("ds1")
    assert (v1["job_id"], v1["total"]) == (1, 20)
    assert (v2["job_id"], v2["total"]) == (2, 35)
    assert v2["published_at"] >= v1["published_at"]
    assert v2 == jindex.SegmentReader(tmp_path).query("ds1")
    assert not list((tmp_path / "ds1").glob("*.tmp"))


def test_crashed_publish_leaves_previous_segment_served(tmp_path):
    _publish(tmp_path, "ds1", n=12, seed=1, job_id=1)
    tfailpoints.configure("index.segment_commit=raise:OSError@1")
    with pytest.raises(OSError):
        _publish(tmp_path, "ds1", n=30, seed=2, job_id=2)
    for reader in _readers(tmp_path).values():
        res = reader.query("ds1")
        assert (res["job_id"], res["total"]) == (1, 12)   # old segment


# ----------------------------------------------------------------- tiles
def _store_images(tmp_path, ds_id="ds1", n_ions=3, k=2, nrows=6, ncols=5):
    """Ion images stored by the port's results store."""
    rng = np.random.default_rng(7)
    images = rng.uniform(0, 1, (n_ions, k, nrows * ncols)).astype(np.float32)
    images[images < 0.3] = 0.0
    ions = [(f"C{i}H{i + 1}", "+H") for i in range(n_ions)]
    store = SearchResultsStore.__new__(SearchResultsStore)
    store.results_dir = tmp_path
    store.image_format = "npz"
    d = tmp_path / ds_id
    d.mkdir(parents=True, exist_ok=True)
    store.ds_dir = lambda _ds: d
    store.store_ion_images(ds_id, images, ions, nrows, ncols)
    return images.reshape(n_ions, k, nrows, ncols), ions


def _read_paths(root, cfg=None, **kw):
    return _both(lambda m: m["readpath"].ReadPath(
        root, m["config"].ReadPathConfig(**(cfg or {})), **kw))


def test_tile_bytes_bit_identical_to_direct_render(tmp_path):
    images, ions = _store_images(tmp_path)
    rps = _read_paths(tmp_path)
    for i, (sf, adduct) in enumerate(ions):
        for k in range(images.shape[1]):
            got = {name: rp.handle_tile("ds1", f"{sf}|{adduct}",
                                        {"k": [str(k)]})
                   for name, rp in rps.items()}
            status, body, _hd = got["torch"]
            assert status == 200
            assert body == tpng.PngGenerator().render(images[i, k])
            assert got["torch"] == got["jax"]
    for name_, params, want in (("XX|+H", {}, 404),
                                (f"{ions[0][0]}|+H", {"k": ["99"]}, 404),
                                ("no-pipe-here", {}, 400)):
        got = {n: rp.handle_tile("ds1", name_, params)
               for n, rp in rps.items()}
        assert got["torch"][0] == want
        assert got["torch"] == got["jax"]


def test_tile_disk_tier_round_trip(tmp_path):
    images, ions = _store_images(tmp_path)
    disk = tmp_path / "tile_cache"
    rp = treadpath.ReadPath(tmp_path, tconfig.ReadPathConfig(), disk_dir=disk)
    sf, adduct = ions[0]
    status, body, _hd = rp.handle_tile("ds1", f"{sf}|{adduct}", {})
    assert status == 200
    spilled = list(disk.glob("*.png"))
    assert len(spilled) == 1 and spilled[0].read_bytes() == body
    # a fresh ReadPath (restart) serves the same bytes from the disk tier,
    # and so does the JAX package's over the port's spill (same file name)
    for name, mods in PACKAGES.items():
        rp2 = mods["readpath"].ReadPath(
            tmp_path, mods["config"].ReadPathConfig(), disk_dir=disk)
        status, body2, _hd = rp2.handle_tile("ds1", f"{sf}|{adduct}", {})
        assert status == 200 and body2 == body, name
        assert rp2.snapshot()["cache"]["entries"] == 1
    assert len(list(disk.glob("*.png"))) == 1


# ------------------------------------------------------------------ cache
def test_read_cache_lru_eviction_and_bounds():
    def drive(m):
        c = m["readpath"].ReadCache(max_bytes=100, max_entries=3)
        seen = []
        c.put(("a",), "A", 40)
        c.put(("b",), "B", 40)
        seen.append(c.get(("a",)))
        c.put(("c",), "C", 40)                  # 120 > 100: evict LRU = b
        seen += [c.get(("b",)), c.get(("a",))]
        c.put(("d",), "D", 10)
        c.put(("e",), "E", 10)                  # entry cap 3: evict oldest
        s = c.stats()
        c.put(("huge",), "X", 1000)             # never fits: not cached
        seen.append(c.get(("huge",)))
        return seen, s

    got = _both(drive)
    assert got["torch"] == got["jax"]
    seen, s = got["torch"]
    assert seen == ["A", None, "A", None]
    assert s["entries"] <= 3 and s["bytes"] <= 100 and s["evictions"] >= 2


def test_warm_query_is_a_cache_hit_and_republish_invalidates(tmp_path):
    _publish(tmp_path, "ds1", n=10, seed=1, job_id=1)
    rps = _read_paths(tmp_path)
    rp = rps["torch"]
    s1, b1, _h = rp.handle_annotations("ds1", {})
    s2, b2, _h = rp.handle_annotations("ds1", {})
    assert s1 == s2 == 200 and b2 is b1         # literally the cached object
    assert b1 == rps["jax"].handle_annotations("ds1", {})[1]
    stats = rp.snapshot()["cache"]
    assert stats["hits"] == 1 and stats["misses"] >= 1
    _publish(tmp_path, "ds1", n=25, seed=2, job_id=2)
    s3, b3, _h = rp.handle_annotations("ds1", {})
    assert s3 == 200 and b3["job_id"] == 2 and b3["total"] == 25
    assert b3 == rps["jax"].handle_annotations("ds1", {})[1]


def test_cache_fill_failure_never_fails_the_read(tmp_path):
    _publish(tmp_path, "ds1", n=10)
    rps = _read_paths(tmp_path)
    for name, mods in PACKAGES.items():
        mods["failpoints"].configure("read.cache_fill=raise:OSError@1")
    got = {}
    for name, rp in rps.items():
        s1, b1, _h = rp.handle_annotations("ds1", {})
        assert s1 == 200 and b1["total"] == 10  # read answered anyway
        e1 = rp.snapshot()["cache"]["entries"]
        s2, b2, _h = rp.handle_annotations("ds1", {})   # retry warms it
        got[name] = (s1, b1, e1, s2, b2, rp.snapshot()["cache"]["entries"])
    assert got["torch"] == got["jax"]
    assert got["torch"][2] == 0 and got["torch"][5] == 1


class _DenyingGovernor:
    def __init__(self):
        self.calls = 0

    def allow_read_cache_fill(self):
        self.calls += 1
        return False


def test_governor_denied_fill_serves_but_does_not_cache(tmp_path):
    _publish(tmp_path, "ds1", n=10)
    gov = _DenyingGovernor()
    rp = treadpath.ReadPath(tmp_path, tconfig.ReadPathConfig(), governor=gov)
    for _ in range(2):
        status, body, _h = rp.handle_annotations("ds1", {})
        assert status == 200 and body["total"] == 10
    assert gov.calls == 2                       # both reads tried to fill
    assert rp.snapshot()["cache"]["entries"] == 0


# --------------------------------------------------------------- admission
def test_read_admission_sheds_structured_429(tmp_path):
    _publish(tmp_path, "ds1", n=10)
    rps = _read_paths(tmp_path, cfg={"max_concurrent": 1,
                                     "retry_after_s": 2.0})
    got = {}
    for name, rp in rps.items():
        assert rp._admit()                      # occupy the only slot
        try:
            shed = rp.handle_annotations("ds1", {})
            sheds = rp.snapshot()["sheds"]
        finally:
            rp._release()
        status, _b, _h = rp.handle_annotations("ds1", {})   # slot free again
        got[name] = (shed, sheds, status)
    assert got["torch"] == got["jax"]
    (status, body, headers), sheds, after = got["torch"]
    assert status == 429
    assert body["reason"] == "read_overload" and not body["accepted"]
    assert body["retry_after_s"] == 2.0
    assert headers["Retry-After"] == "2"
    assert sheds == 1 and after == 200


def test_bad_requests_are_structured_400s(tmp_path):
    _publish(tmp_path, "ds1", n=10)
    rps = _read_paths(tmp_path, cfg={"page_size": 20, "page_size_max": 50})
    for params in ({"limit": ["0"]}, {"limit": ["9999"]},
                   {"limit": ["nope"]}, {"fdr": ["zz"]},
                   {"order": ["bogus"]}, {"dir": ["sideways"]},
                   {"cursor": ["@@@"]}):
        got = {n: rp.handle_annotations("ds1", params)
               for n, rp in rps.items()}
        status, body, _h = got["torch"]
        assert status == 400, params
        assert body["error"] == "bad_request" and body["detail"]
        assert got["torch"] == got["jax"], params
    got = {n: (rp.handle_cohort({}), rp.handle_annotations(
        "never-published", {})) for n, rp in rps.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == 400            # cohort requires sf
    assert got["torch"][1][0] == 404
    assert got["torch"][1][1]["error"] == "not_found"


def test_metrics_and_snapshot_surface_read_activity(tmp_path):
    _publish(tmp_path, "ds1", n=10)
    texts = {}
    for name, mods in PACKAGES.items():
        reg = mods["metrics"].MetricsRegistry()
        rp = mods["readpath"].ReadPath(
            tmp_path, mods["config"].ReadPathConfig(), metrics=reg)
        rp.handle_annotations("ds1", {})
        rp.handle_annotations("ds1", {})
        rp.handle_annotations("missing", {})
        # latency buckets aside (wall clock), the exposition is equal
        texts[name] = [ln for ln in reg.expose().splitlines()
                       if "sm_read_latency_seconds_" not in ln]
    assert texts["torch"] == texts["jax"]
    text = "\n".join(texts["torch"])
    assert 'sm_read_requests_total{endpoint="annotations",outcome="ok"} 2' \
        in text
    assert 'outcome="http_404"' in text
    assert 'sm_read_cache_hits_total{kind="annotations"} 1' in text
    assert "sm_read_cache_entries 1" in text


# ------------------------------------------------------ the service, HTTP
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10.0) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def test_service_serves_read_routes_as_the_jax_package(tmp_path):
    """The port's service with the JAX package's default config (``read``
    enabled) stores a job, then answers ``/datasets``, paged
    ``/datasets/<id>/annotations``, ``/annotations`` and the ion tiles with
    bodies, cursors and codes equal to the JAX package's handlers over the
    same results directory."""
    from sm_distributed_tpu_torch.engine.daemon import annotate_callback
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
    from sm_distributed_tpu_torch.models import breaker, faults, oom
    from sm_distributed_tpu_torch.service import AnnotationService

    path, truth = generate_synthetic_dataset(
        tmp_path / "ds", nrows=8, ncols=8, present_fraction=0.5,
        noise_peaks=30, seed=11)
    sm = tconfig.SMConfig.from_dict({
        "device": "cpu", "work_dir": str(tmp_path / "work"),
        "fdr": {"decoy_sample_size": 2, "seed": 1},
        "parallel": {"isocalc_workers": 1},
        "storage": {"results_dir": str(tmp_path / "res")},
        "service": {"workers": 1, "poll_interval_s": 0.02,
                    "http_port": 0}})
    assert sm.service.read == tconfig.ReadPathConfig()
    service = AnnotationService(tmp_path / "q", annotate_callback(sm),
                                sm_config=sm)
    service.publisher.publish({
        "ds_id": "rd1", "input_path": str(path),
        "formulas": truth.formulas[:4],
        "ds_config": {"isotope_generation": {"adducts": ["+H", "+Na"]}}})
    service.start()
    try:
        assert service.scheduler.wait_for_terminal(1, timeout_s=120.0)
        base = "http://%s:%d" % service.api.address
        jrp = jreadpath.ReadPath(tmp_path / "res", jconfig.ReadPathConfig())
        status, _ct, body = _get(base + "/datasets")
        assert status == 200
        assert json.loads(body) == jrp.handle_datasets()[1]
        assert json.loads(body)["datasets"][0]["ds_id"] == "rd1"
        # pages of 3 through the cursors: every row once, bodies equal
        cursor, rows = None, []
        while True:
            q = "limit=3" + (f"&cursor={cursor}" if cursor else "")
            status, _ct, body = _get(base + f"/datasets/rd1/annotations?{q}")
            page = json.loads(body)
            want = jrp.handle_annotations("rd1", urllib.parse.parse_qs(q))
            assert (status, page) == want[:2]
            rows += page["rows"]
            cursor = page["next_cursor"]
            if cursor is None:
                break
        stored = pd.read_parquet(tmp_path / "res" / "rd1" /
                                 "annotations.parquet")
        assert len(rows) == len(stored) > 0
        assert [(r["sf"], r["adduct"]) for r in rows] == list(
            stored.sort_values(["msm", "sf", "adduct"], ascending=False)
            [["sf", "adduct"]].itertuples(index=False, name=None))
        sf = rows[0]["sf"]
        status, _ct, body = _get(base + f"/annotations?sf={sf}")
        assert (status, json.loads(body)) == jrp.handle_cohort(
            {"sf": [sf]})[:2]
        ion = urllib.parse.quote(f"{sf}|{rows[0]['adduct']}")
        status, ctype, body = _get(base + f"/datasets/rd1/images/{ion}")
        assert status == 200 and ctype == "image/png"
        assert body == jrp.handle_tile("rd1", ion, {})[1]
        for route, code in (("/datasets/none/annotations", 404),
                            ("/datasets/rd1/annotations?limit=0", 400),
                            ("/annotations", 400)):
            status, _ct, body = _get(base + route)
            assert status == code, route
        text = service.metrics.expose()
        assert 'sm_read_requests_total{endpoint="annotations",outcome="ok"}' \
            in text
        slo = json.loads(_get(base + "/slo")[2])
        assert slo["slos"]["read"]["count"] >= 4
    finally:
        assert service.shutdown()
        breaker.reset_device_breaker()
        oom.reset()
        faults.reset()
        tfailpoints.reset()
