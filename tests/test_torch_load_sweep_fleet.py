"""The port's load sweep beside the JAX package's: the scheduling-plane
mixes over ``--bare`` replica processes (replicas, pod and elastic), each
run on both sides, their outcomes compared: the exactly-once spool census,
the pod survivors' host evictions and the elastic fleet's clean drains.
"""

from __future__ import annotations

from pathlib import Path

from tests.torch_sweep_parity import Sides, census, metric


def _root(sides: Sides, side: str, mix: str) -> Path:
    return sides.work[side] / mix / "queue" / "sm_annotate"


def _exactly_once(sides: Sides, mix: str) -> dict:
    got, want = (census(_root(sides, s, mix)) for s in ("port", "jax"))
    assert got == want
    assert not any(v for k, v in got.items() if k != "done")
    return got


def test_replicas_match_the_jax_mix(tmp_path, monkeypatch):
    sides = Sides(tmp_path, monkeypatch).both("replicas")
    got = _exactly_once(sides, "replicas")
    assert got["done"] == [f"lj{i:05d}" for i in range(600)]


def test_pod_matches_the_jax_mix(tmp_path, monkeypatch):
    sides = Sides(tmp_path, monkeypatch).both("pod")
    got = _exactly_once(sides, "pod")
    assert got["done"] == [f"pj{i:05d}" for i in range(240)]
    for side in ("port", "jax"):
        dumps = sides.work[side] / "pod" / "metrics"
        texts = [(dumps / f"{r}.prom").read_text() for r in ("r0", "r1")]
        assert sum(metric(t, "sm_pod_host_evictions_total")
                   for t in texts) >= 1, side
        assert any('sm_pod_process_up{process="1"} 0' in t
                   for t in texts), side


def test_elastic_matches_the_jax_mix(tmp_path, monkeypatch):
    """Both fleets scale 1 -> 4 -> 2 with every job done exactly once and
    no debris; the port's mix tops its surge up until the fleet reaches
    4, so its census is the 420 jobs and its top-ups, in order."""
    sides = Sides(tmp_path, monkeypatch).both("elastic")
    for side in ("port", "jax"):
        root = _root(sides, side, "elastic")
        got = census(root)
        assert not any(v for k, v in got.items() if k != "done"), side
        assert got["done"] == [f"ej{i:05d}" for i in range(len(
            got["done"]))], side
        assert len(got["done"]) >= 420, side
        assert not list((root / "leases").glob("*.json")), side
        assert not list((root / "replicas").glob("*")), side
    assert len(census(_root(sides, "jax", "elastic"))["done"]) == 420
