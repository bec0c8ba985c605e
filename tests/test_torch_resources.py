"""The port's resource-exhaustion survival against the JAX package's: the
enospc failpoint action over every governed write seam, the disk-budget
governor's degrade order, the bounded-retention GC and the 507 admission
shed.  Each case makes the same calls on both packages and holds the
outcomes equal: errnos, degrade levels, denials, swept files, admission
decisions, trace records.
"""

from __future__ import annotations

import errno
import json
import os
import time
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import sm_distributed_tpu.engine.daemon as jdaemon
import sm_distributed_tpu.engine.storage as jstorage
import sm_distributed_tpu.models.msm_basic as jmsm
import sm_distributed_tpu.ops.isocalc as jiso
import sm_distributed_tpu.service.admission as jadm
import sm_distributed_tpu.service.resources as jres
import sm_distributed_tpu.utils.config as jconfig
import sm_distributed_tpu.utils.failpoints as jfp
import sm_distributed_tpu.utils.tracing as jtracing
import sm_distributed_tpu_torch.engine.daemon as tdaemon
import sm_distributed_tpu_torch.engine.storage as tstorage
import sm_distributed_tpu_torch.models.msm_basic as tmsm
import sm_distributed_tpu_torch.ops.isocalc as tiso
import sm_distributed_tpu_torch.service.admission as tadm
import sm_distributed_tpu_torch.service.resources as tres
import sm_distributed_tpu_torch.utils.config as tconfig
import sm_distributed_tpu_torch.utils.failpoints as tfp
import sm_distributed_tpu_torch.utils.tracing as ttracing

PACKAGES = {
    "jax": dict(daemon=jdaemon, storage=jstorage, msm=jmsm, iso=jiso,
                adm=jadm, res=jres, config=jconfig, fp=jfp, tracing=jtracing),
    "torch": dict(daemon=tdaemon, storage=tstorage, msm=tmsm, iso=tiso,
                  adm=tadm, res=tres, config=tconfig, fp=tfp,
                  tracing=ttracing),
}


def _reset_all():
    for m in PACKAGES.values():
        m["fp"].reset()
        m["res"].set_governor(None)
        m["tracing"].set_file_gate(None)


@pytest.fixture(autouse=True)
def _reset():
    _reset_all()
    yield
    _reset_all()


def _both(case, tmp_path=None):
    out = {}
    for name, m in PACKAGES.items():
        if tmp_path is None:
            out[name] = case(m)
        else:
            d = tmp_path / name
            d.mkdir()
            out[name] = case(m, d)
        _reset_all()
    assert out["torch"] == out["jax"], out
    return out["torch"]


def _oserror(fn) -> tuple:
    try:
        fn()
    except OSError as exc:
        return type(exc).__name__, exc.errno, "No space left on device" in str(exc)
    return None


# -------------------------------------------------- the enospc action itself
def test_enospc_action_parses_and_rejects_args():
    def case(m):
        spec = m["fp"].parse_failpoints("x.y=enospc@2")
        with pytest.raises(ValueError, match="takes no argument") as ei:
            m["fp"].parse_failpoints("x.y=enospc:9")
        return spec["x.y"].action, spec["x.y"].nth, str(ei.value)

    assert _both(case)[:2] == ("enospc", 2)


def test_enospc_raises_oserror_with_enospc_errno(tmp_path):
    def case(m, d):
        m["fp"].configure("spool.publish_rename=enospc@1")
        pub = m["daemon"].QueuePublisher(d)
        return _oserror(lambda: pub.publish(
            {"ds_id": "d", "input_path": "x", "msg_id": "m1"}))

    assert _both(case, tmp_path) == ("OSError", errno.ENOSPC, True)


# ------------------------------------------------ ENOSPC at every governed seam
def test_enospc_at_publish_recovers_clean(tmp_path):
    def case(m, d):
        m["fp"].configure("spool.publish_rename=enospc@1")
        pub = m["daemon"].QueuePublisher(d)
        err = _oserror(lambda: pub.publish(
            {"ds_id": "d", "input_path": "x", "msg_id": "m1"}))
        root = pub.root
        debris = len(list((root / "pending").glob(".*.tmp")))
        swept = m["daemon"].QueueConsumer(d, callback=None).sweep_orphans(
            max_age_s=0.0)
        dst = pub.publish({"ds_id": "d", "input_path": "x", "msg_id": "m1"})
        return (err, debris, swept, dst.exists(),
                len(list((root / "pending").glob(".*.tmp"))))

    assert _both(case, tmp_path) == (("OSError", errno.ENOSPC, True),
                                     1, 1, True, 0)


def test_enospc_at_checkpoint_shard_then_rerun(tmp_path):
    def case(m, d):
        ckpt = m["msm"].SearchCheckpoint(d, "fp")
        metrics = np.arange(8.0).reshape(2, 4)
        ranges = [(0, 2)]
        m["fp"].configure("ckpt.shard_write=enospc@1")
        err = _oserror(lambda: ckpt.save(metrics, 0, 1, ranges))
        ckpt.save(metrics, 0, 1, ranges)
        restored = np.zeros_like(metrics)
        n = ckpt.load(restored, 1, ranges)
        ckpt.finalize()
        return (err, n, restored.tolist(),
                sorted(p.name for p in d.glob("*.npz")))

    err, n, restored, left = _both(case, tmp_path)
    assert err[1] == errno.ENOSPC and n == 1 and left == []
    assert restored == np.arange(8.0).reshape(2, 4).tolist()


def test_enospc_at_results_store_then_rerun(tmp_path):
    def case(m, d):
        ledger = m["storage"].JobLedger(d / "results")
        store = m["storage"].SearchResultsStore(ledger, store_images=False)
        ann = pd.DataFrame({"sf": ["H2O"], "adduct": ["+H"], "msm": [0.5],
                            "fdr": [0.1], "fdr_level": [0.1],
                            "chaos": [0.9], "spatial": [0.8],
                            "spectral": [0.7]})
        allm = ann.assign(is_target=True)[
            ["sf", "adduct", "is_target", "chaos", "spatial", "spectral",
             "msm"]]
        bundle = m["msm"].SearchResultsBundle(annotations=ann,
                                              all_metrics=allm)
        job = ledger.start_job("ds1")
        m["fp"].configure("storage.results_rename=enospc@1")
        err = _oserror(lambda: store.store("ds1", job, bundle))
        out = store.store("ds1", job, bundle)
        ledger.close()
        return (err, (out / "annotations.parquet").exists(),
                sorted(p.name for p in out.glob("*.tmp")),
                pd.read_parquet(out / "annotations.parquet").to_dict())

    err, exists, tmps, _ann = _both(case, tmp_path)
    assert err[1] == errno.ENOSPC and exists and tmps == []


def test_enospc_at_isocalc_shard_then_rerun(tmp_path):
    def case(m, d):
        w = m["iso"].IsocalcWrapper(m["config"].IsotopeGenerationConfig(),
                                    cache_dir=str(d))
        entries = {"H2O|+H": (np.array([18.01]), np.array([1.0]))}
        shard = d / "theor_peaks_test_c00000.npz"
        m["fp"].configure("isocalc.shard_save=enospc@1")
        err = _oserror(lambda: w._write_shard(shard, entries))
        first = shard.exists()
        w._write_shard(shard, entries)
        loaded = w._load_shard(shard)
        return err, first, shard.exists(), loaded["H2O|+H"][0].tolist()

    err, first, exists, mzs = _both(case, tmp_path)
    assert err[1] == errno.ENOSPC and not first and exists and mzs == [18.01]


def test_enospc_at_trace_append_never_fails_the_pipeline(tmp_path):
    def case(m, d):
        tr = m["tracing"]
        m["fp"].configure("trace.append=enospc@1")
        ctx = tr.new_trace(job_id="j1", trace_dir=d)
        with tr.attach(ctx):
            with tr.span("unlucky"):
                pass
            with tr.span("lucky"):
                pass
        tr.close_files()
        names = [r["name"] for r in tr.read_trace(
            tr.trace_path(d, ctx.trace_id))]
        in_ring = any(r.get("name") == "unlucky"
                      for r in tr.flight_recorder.recent(64))
        return names, in_ring

    names, in_ring = _both(case, tmp_path)
    assert "lucky" in names and "unlucky" not in names and in_ring


# ------------------------------------------------------- governor: degrade order
def _governor(m, d: Path, **cfg_over):
    cfg = m["config"].ResourcesConfig(**{
        "disk_budget_bytes": 1_000_000, "trace_floor_bytes": 600_000,
        "cache_floor_bytes": 400_000, "read_cache_floor_bytes": 300_000,
        "submit_floor_bytes": 200_000, **cfg_over})
    work = d / "work"
    work.mkdir(exist_ok=True)
    return m["res"].ResourceGovernor(cfg, work_dir=work,
                                     trace_dir=d / "work" / "traces",
                                     queue_root=d / "queue")


def _fill(d: Path, total_bytes: int) -> None:
    (d / "work" / "filler.bin").write_bytes(b"\0" * total_bytes)


def _gates(g) -> tuple:
    return (g.level(), g.trace_gate(), g.allow_cache(),
            g.allow_read_cache_fill(), g.submits_shed())


def test_degrade_order_traces_then_cache_then_submits(tmp_path):
    def case(m, d):
        g = _governor(m, d)
        out = [_gates(g)]
        for fill in (500_000, 650_000, 750_000, 900_000):
            _fill(d, fill)
            g.rescan_usage()
            out.append(_gates(g))
        (d / "work" / "filler.bin").unlink()
        g.rescan_usage()
        out.append(_gates(g))
        snap = g.snapshot()
        out.append({k: v >= 1 for k, v in snap["degraded_writes"].items()})
        return out

    out = _both(case, tmp_path)
    assert [o[0] for o in out[:-1]] == [0, 1, 2, 3, 4, 0]
    assert out[4][4] is True and out[5][4] is False


def test_preflight_denies_at_the_floor_and_tracks_pending(tmp_path):
    def case(m, d):
        g = _governor(m, d)
        g.preflight("seamA", 300_000)
        g.preflight("seamA", 300_000)
        with pytest.raises(m["res"].ResourceBudgetError) as ei:
            g.preflight("seamB", 500_000)
        snap = g.snapshot()
        return (ei.value.errno, ei.value.seam, snap["pending_bytes"],
                snap["denied_writes"])

    assert _both(case, tmp_path) == (errno.ENOSPC, "seamB", 600_000,
                                     {"seamB": 1})


def test_min_free_constraint_uses_statvfs(tmp_path):
    def case(m, d):
        g = _governor(m, d, disk_budget_bytes=0, min_free_bytes=2**62)
        denied = _oserror(lambda: g.preflight("any", 1)) is not None
        g2 = _governor(m, d, disk_budget_bytes=0, min_free_bytes=1)
        g2.preflight("any", 1)
        return g.submits_shed(), denied

    assert _both(case, tmp_path) == (True, True)


def test_disabled_governor_is_inert(tmp_path):
    def case(m, d):
        g = _governor(m, d, disk_budget_bytes=0, min_free_bytes=0)
        g.preflight("x", 2**62)
        return g.enabled, g.trace_gate(), g.allow_cache(), g.submits_shed()

    assert _both(case, tmp_path) == (False, True, True, False)


def test_module_gates_noop_without_governor():
    def case(m):
        m["res"].preflight("x", 2**62)
        return m["res"].allow_cache()

    assert _both(case) is True


# -------------------------------------------------------------- retention GC
def _age(path: Path, seconds: float = 3600.0) -> None:
    old = time.time() - seconds
    os.utime(path, (old, old))


def test_gc_retention_classes_and_shard_scoping(tmp_path):
    def case(m, d):
        g = _governor(m, d, done_retention_age_s=10.0,
                      failed_retention_age_s=10.0,
                      registry_retention_age_s=10.0)
        q = d / "queue"
        for sub in ("done", "failed", "quarantine", "replicas"):
            (q / sub).mkdir(parents=True, exist_ok=True)
        names = {"done": ["old_owned", "old_peer", "fresh"],
                 "failed": ["old_dl"], "quarantine": ["old_q"],
                 "replicas": ["r9"]}
        for sub, ids in names.items():
            for i in ids:
                p = q / sub / f"{i}.json"
                p.write_text(json.dumps({"x": 1}))
                if i != "fresh":
                    _age(p)
        g.gc_tick(owns_msg=lambda mid: mid != "old_peer")
        left = {sub: sorted(p.stem for p in (q / sub).glob("*.json"))
                for sub in names}
        classes = g.snapshot()["gc"]["classes"]
        return left, {k: classes[k]["files"]
                      for k in ("done", "failed", "registry")}

    left, files = _both(case, tmp_path)
    assert left["done"] == ["fresh", "old_peer"]
    assert files == {"done": 1, "failed": 2, "registry": 1}


def test_gc_trace_retention_age_and_size_cap(tmp_path):
    def case(m, d):
        g = _governor(m, d)
        g.tracing_cfg = m["config"].TracingConfig(retention_age_s=10.0,
                                                  retention_max_bytes=1500)
        traces = d / "work" / "traces"
        traces.mkdir(parents=True, exist_ok=True)
        aged = traces / "aged.jsonl"
        aged.write_text("x" * 100)
        _age(aged)
        for i in range(4):
            p = traces / f"t{i}.jsonl"
            p.write_text("y" * 1000)
            _age(p, seconds=5 - i)
        g.gc_tick()
        return (sorted(p.name for p in traces.glob("*.jsonl")),
                g.snapshot()["gc"]["classes"]["traces"]["files"])

    assert _both(case, tmp_path) == (["t3.jsonl"], 4)


def test_gc_cache_size_cap_oldest_shards_first(tmp_path):
    def case(m, d):
        g = _governor(m, d, cache_retention_max_bytes=2500)
        cache = d / "cache"
        cache.mkdir()
        g.cache_dir = cache
        for i in range(4):
            p = cache / f"theor_peaks_k_{i}.npz"
            p.write_bytes(b"z" * 1000)
            _age(p, seconds=40 - i)
        stale_tmp = cache / "tmp_deadbeef.npz"
        stale_tmp.write_bytes(b"t")
        _age(stale_tmp)
        g.gc_tick()
        return (stale_tmp.exists(),
                sorted(p.name for p in cache.glob("theor_peaks_*.npz")))

    assert _both(case, tmp_path) == (
        False, ["theor_peaks_k_2.npz", "theor_peaks_k_3.npz"])


# --------------------------------------------------------- 507 admission shed
def test_admission_sheds_507_when_disk_exhausted(tmp_path):
    def case(m, d):
        g = _governor(m, d)
        _fill(d, 900_000)
        g.rescan_usage()
        m["res"].set_governor(g)
        adm = m["adm"].AdmissionController(
            m["config"].AdmissionConfig(retry_after_s=2.5))
        dec = adm.try_admit("tenant1")
        out = [(dec.accepted, dec.status, dec.reason, dec.retry_after_s,
                sorted(dec.body()))]
        (d / "work" / "filler.bin").unlink()
        g.rescan_usage()
        out.append(adm.try_admit("tenant1").accepted)
        return out

    out = _both(case, tmp_path)
    assert out[0][:4] == (False, 507, "disk_exhausted", 2.5) and out[1]


# ------------------------------------------------------ tracing gate plumbing
def test_trace_file_gate_drops_file_writes_not_ring(tmp_path):
    def case(m, d):
        tr = m["tracing"]
        g = _governor(m, d)
        _fill(d, 500_000)
        g.rescan_usage()
        tr.set_file_gate(g.trace_gate)
        ctx = tr.new_trace(job_id="j", trace_dir=d / "traces")
        with tr.attach(ctx), tr.span("gated"):
            pass
        return (tr.trace_path(d / "traces", ctx.trace_id).exists(),
                any(r.get("name") == "gated"
                    for r in tr.flight_recorder.recent(64)),
                g.snapshot()["degraded_writes"]["trace"] >= 1)

    assert _both(case, tmp_path) == (False, True, True)
