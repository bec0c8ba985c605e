"""The port's load sweep (``drivers/load_sweep.py``) beside the JAX
package's (``scripts/load_sweep.py``): the in-process service mixes burst,
sustained, deadline, cancel, poison and breaker, each run on both sides
(the port's on ``torch_cuda`` with ``device="cpu"``), their outcomes
compared: terminal states and attempts, the spool census, shed statuses
and reasons, the counters on ``/metrics`` and the stored FDR ranks.  Also
the depth census the burst mix's bound is decided by.
"""

from __future__ import annotations

import os
from pathlib import Path

import pytest

from sm_distributed_tpu_torch.models import breaker as tbreaker
from sm_distributed_tpu_torch.utils import failpoints as tfp
from tests.torch_sweep_parity import Sides, census, fdr_ranks, metric, sheds


@pytest.fixture(autouse=True)
def _isolate():
    for reset in (tfp.reset, tbreaker.reset_device_breaker):
        reset()
    yield
    for reset in (tfp.reset, tbreaker.reset_device_breaker):
        reset()


def _both(tmp_path, monkeypatch, name: str) -> Sides:
    return Sides(tmp_path, monkeypatch).both(name)


def _root(sides: Sides, side: str, harness: str = "main") -> Path:
    return sides.work[side] / harness / "queue" / "sm_annotate"


def _results(sides: Sides, side: str, harness: str = "main") -> Path:
    return sides.work[side] / harness / "results"


def _accepted(sides: Sides, side: str) -> list[str]:
    return sorted(s["msg_id"] for s in sides.seen[side].submits
                  if s["status"] == 202)


def test_queued_ids_count_a_renamed_message_once(tmp_path, monkeypatch):
    """A message renamed from ``pending/`` to ``running/`` between the two
    listings is one queued message: the census counts it once, where a sum
    of the two listings counts it twice."""
    from sm_distributed_tpu_torch.drivers.harness import queued_ids

    root = tmp_path / "sm_annotate"
    for s in ("pending", "running"):
        (root / s).mkdir(parents=True)
    real_glob = Path.glob

    def glob_then_claim(self, pattern):
        found = list(real_glob(self, pattern))
        if self.name == "pending" and (self / "m1.json").exists():
            # the scheduler claims m1 just after it was listed
            os.rename(self / "m1.json", root / "running" / "m1.json")
        return iter(found)

    monkeypatch.setattr(Path, "glob", glob_then_claim)
    for summed in (False, True):
        for f in root.rglob("*.json"):
            f.unlink()
        (root / "pending" / "m1.json").write_text("{}")
        (root / "running" / "m0.json").write_text("{}")
        if summed:
            # the JAX harness's reading: two listings summed
            n = (len(list((root / "pending").glob("*.json")))
                 + len(list((root / "running").glob("*.json"))))
            assert n == 3
        else:
            assert queued_ids(root) == {"m0", "m1"}


def test_burst_matches_the_jax_mix(tmp_path, monkeypatch):
    sides = _both(tmp_path, monkeypatch, "burst")
    got, want = ({"sheds": sheds(sides.seen[s]),
                  "states": {tuple(sides.seen[s].rows()[m])
                             for m in _accepted(sides, s)},
                  "census": {k: v for k, v in census(_root(sides, s)).items()
                             if k != "done"},
                  "done_is_accepted": census(_root(sides, s))["done"]
                  == _accepted(sides, s),
                  "shed_counted": metric(sides.seen[s].metrics(),
                                         'sm_admission_total{decision="shed"')
                  == sum(x["status"] != 202 for x in sides.seen[s].submits)}
                 for s in ("port", "jax"))
    assert got == want
    assert got["sheds"] == {"statuses": [429], "structured": True,
                            "any": True}
    assert got["states"] == {("done", 1)} and got["done_is_accepted"]
    # the port's depth bound is decided by states: its admission gauge
    assert metric(sides.seen["port"].metrics(), "sm_admission_depth ") == 0
    # burst0 is always admitted: the same FDR ranks on both sides
    assert fdr_ranks(_results(sides, "port"), "burst0") == \
        fdr_ranks(_results(sides, "jax"), "burst0")


def test_sustained_matches_the_jax_mix(tmp_path, monkeypatch):
    sides = _both(tmp_path, monkeypatch, "sustained")
    got, want = ({"states": {tuple(sides.seen[s].rows()[m])
                             for m in _accepted(sides, s)},
                  "not_done": {k: v for k, v in
                               census(_root(sides, s)).items()
                               if k != "done"},
                  "ewma": "sm_admission_latency_ewma_s"
                  in sides.seen[s].metrics()}
                 for s in ("port", "jax"))
    assert got == want
    assert got["states"] == {("done", 1)} and got["ewma"]
    assert fdr_ranks(_results(sides, "port"), "sus0") == \
        fdr_ranks(_results(sides, "jax"), "sus0")


@pytest.mark.parametrize("mix", ["deadline", "cancel", "poison"])
def test_fault_mix_matches_the_jax_mix(tmp_path, monkeypatch, mix):
    sides = _both(tmp_path, monkeypatch, mix)
    got, want = ({"rows": sides.seen[s].rows(),
                  "census": census(_root(sides, s)),
                  "submits": [(x["msg_id"], x["status"])
                              for x in sides.seen[s].submits],
                  "cancelled": metric(sides.seen[s].metrics(),
                                      "sm_jobs_cancelled_total"),
                  "quarantined": metric(sides.seen[s].metrics(),
                                        "sm_jobs_quarantined_total")}
                 for s in ("port", "jax"))
    assert got == want
    if mix == "deadline":
        assert got["rows"]["dl_queued"] == ["failed", 0]
        assert got["rows"]["dl_midrun"] == ["failed", 1]
        assert fdr_ranks(_results(sides, "port"), "occupy0") == \
            fdr_ranks(_results(sides, "jax"), "occupy0")
    elif mix == "cancel":
        assert got["rows"]["cancel_me"][0] == "cancelled"
        assert got["census"]["failed"] == ["cancel_me"]
        assert got["cancelled"] == 1
    else:
        assert got["rows"]["poison_dl"] == ["failed", 2]
        assert got["rows"]["poison_q"][0] == "quarantined"
        assert got["census"]["quarantine"] == ["poison_q"]
        assert got["quarantined"] == 1


def test_breaker_refuses_where_the_jax_mix_degrades(tmp_path, monkeypatch):
    """Both sides open the chip-0 breaker under injected device errors,
    end every job done and close the breaker through a half-open probe;
    the port counts the refused attempts where the JAX package counts the
    degraded jobs, and a job under the faults is refused and retried."""
    sides = _both(tmp_path, monkeypatch, "breaker")
    outcome = {}
    for s in ("port", "jax"):
        text = sides.seen[s].metrics("breaker/r0")
        rows = sides.seen[s].rows("breaker/r0")
        outcome[s] = {
            "states": {m: r[0] for m, r in rows.items()},
            "census": census(_root(sides, s, "breaker")),
            "transitions": sorted(
                to for to in ("open", "half_open", "closed")
                if metric(text, 'sm_breaker_transitions_total{device="0",'
                                f'to="{to}"}}') > 0),
            "kept_serving": metric(text, "sm_breaker_refused_total"
                                   if s == "port"
                                   else "sm_breaker_degraded_total") >= 1,
        }
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"]["states"] == {"brk1": "done", "brk2": "done",
                                         "brk_probe": "done"}
    assert outcome["port"]["transitions"] == ["closed", "half_open", "open"]
    port_rows = sides.seen["port"].rows("breaker/r0")
    assert max(port_rows[m][1] for m in ("brk1", "brk2")) >= 3
    assert fdr_ranks(_results(sides, "port", "breaker"), "brk_probe") == \
        fdr_ranks(_results(sides, "jax", "breaker"), "brk_probe")
