"""The port's load sweep beside the JAX package's: the device, disk, read
and live-stream planes (mixes device_fault, disk, read and stream), each
run on both sides (the port's on ``torch_cuda`` with ``device="cpu"``),
their outcomes compared: terminal states, the spool census, shed statuses
and reasons, the counters on ``/metrics`` and the stored FDR ranks.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from sm_distributed_tpu_torch.models import breaker as tbreaker
from sm_distributed_tpu_torch.utils import failpoints as tfp
from tests.torch_sweep_parity import Sides, census, fdr_ranks, metric


@pytest.fixture(autouse=True)
def _isolate():
    for reset in (tfp.reset, tbreaker.reset_device_breaker):
        reset()
    yield
    for reset in (tfp.reset, tbreaker.reset_device_breaker):
        reset()


def _root(sides: Sides, side: str, harness: str) -> Path:
    return sides.work[side] / harness / "queue" / "sm_annotate"


def _results(sides: Sides, side: str, harness: str) -> Path:
    return sides.work[side] / harness / "results"


def _states(sides: Sides, side: str, harness: str) -> dict:
    return {m: r[0] for m, r in sides.seen[side].rows(harness).items()}


def test_device_fault_matches_the_jax_mix(tmp_path, monkeypatch):
    sides = Sides(tmp_path, monkeypatch).both("device_fault")
    got, want = ({
        "states": _states(sides, s, "device_fault/r0"),
        "census": census(_root(sides, s, "device_fault")),
        "chip3_quarantined": 'sm_device_health{device="3"} 2'
        in sides.seen[s].metrics("device_fault/r0"),
        "quarantines": metric(sides.seen[s].metrics("device_fault/r0"),
                              "sm_device_quarantines_total") >= 1,
    } for s in ("port", "jax"))
    assert got == want
    assert got["census"]["done"] == sorted(f"df{i}" for i in range(24))
    assert set(got["states"].values()) == {"done"}
    assert got["chip3_quarantined"] and got["quarantines"]
    assert fdr_ranks(_results(sides, "port", "device_fault"), "df0") == \
        fdr_ranks(_results(sides, "jax", "device_fault"), "df0")


def test_disk_matches_the_jax_mix(tmp_path, monkeypatch):
    sides = Sides(tmp_path, monkeypatch).both("disk")
    got, want = ({
        "states": _states(sides, s, "disk/r0"),
        "census": census(_root(sides, s, "disk")),
        "submits": [(x["msg_id"], x["status"], x["reason"])
                    for x in sides.seen[s].submits],
        "trace_dropped": metric(sides.seen[s].metrics("disk/r0"),
                                'sm_disk_degraded_writes_total{kind="trace"}')
        > 0,
    } for s in ("port", "jax"))
    assert got == want
    assert ("disk_shed", 507, "disk_exhausted") in got["submits"]
    assert set(got["states"].values()) == {"done"} and got["trace_dropped"]
    assert fdr_ranks(_results(sides, "port", "disk"), "disk0") == \
        fdr_ranks(_results(sides, "jax", "disk"), "disk0")


def test_read_matches_the_jax_mix(tmp_path, monkeypatch):
    """Every seed and write done on both sides, read sheds and cache hits
    on both sides' ``/metrics``, the same stored FDR ranks.  (Which replica
    ran which job is timing: the job rows of one replica are not
    compared.)"""
    sides = Sides(tmp_path, monkeypatch).both("read")
    got, want = ({
        "done": census(_root(sides, s, "read"))["done"],
        "others": {k: v for k, v in census(_root(sides, s, "read")).items()
                   if k != "done" and v},
        "shed": metric(sides.seen[s].metrics("read/r1"),
                       "sm_read_requests_total") > 0
        and metric(sides.seen[s].metrics("read/r1"),
                   "sm_read_cache_hits_total") > 0,
    } for s in ("port", "jax"))
    assert got == want
    assert got["done"] == ["read_a", "read_b", "rw0", "rw1", "rw2", "rw3"]
    for ds in ("read_a", "read_b"):
        assert fdr_ranks(_results(sides, "port", "read"), ds) == \
            fdr_ranks(_results(sides, "jax", "read"), ds)


def test_stream_matches_the_jax_mix(tmp_path, monkeypatch):
    sides = Sides(tmp_path, monkeypatch).both("stream")
    got, want = ({
        "census": census(_root(sides, s, "stream")),
        "chunks": metric(sides.seen[s].metrics("stream/r1"),
                         "sm_stream_chunks_total"),
    } for s in ("port", "jax"))
    assert got == want
    assert got["chunks"] == 6
    streams = [d for d in got["census"]["done"] if d.startswith("stream_")
               and d != "stream_gold"]
    assert len(streams) == 2
    for ds in ["stream_gold", *streams]:
        assert fdr_ranks(_results(sides, "port", "stream"), ds) == \
            fdr_ranks(_results(sides, "jax", "stream"), ds)
