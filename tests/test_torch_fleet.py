"""The port's elastic fleet (``service/fleet.py``) against the JAX package's.

- The pure ``decide`` equals the JAX ``decide`` on ``tests/test_fleet.py``'s
  cases and on hypothesis-drawn signals and states.
- ``spool_signals`` reads the same queue depth and membership; the
  controller (with a fake spawn: no subprocess) spawns to the floor, counts
  a crash and replaces it, drains LIFO with the ack protocol, culls a spawn
  that never registers, and exports the JAX package's ``sm_fleet_*``
  families; ``write_child_config`` turns the children's controllers off.
- The ``fleet.spawn`` chaos scenario converges beside the JAX script's.
- ``serve --fleet`` as a user runs it on the CPU: two replicas up, a job
  done, the spawned replica SIGKILLed and replaced, SIGTERM draining every
  child with an ack, exit 0 (the shape of ``chip_smoke.py`` phase 16b).
"""

from __future__ import annotations

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import scripts.chaos_sweep as jchaos
import sm_distributed_tpu.service.fleet as jfleet
import sm_distributed_tpu.utils.config as jconfig
import sm_distributed_tpu_torch.drivers.chaos_sweep as tchaos
import sm_distributed_tpu_torch.service.fleet as tfleet
import sm_distributed_tpu_torch.utils.config as tconfig
from sm_distributed_tpu.engine.daemon import QueuePublisher as JPublisher
from sm_distributed_tpu.service.leases import ReplicaRegistry as JRegistry
from sm_distributed_tpu.service.metrics import MetricsRegistry as JMetrics
from sm_distributed_tpu.utils import failpoints as jfp
from sm_distributed_tpu_torch.engine.daemon import QueuePublisher
from sm_distributed_tpu_torch.service.leases import ReplicaRegistry
from sm_distributed_tpu_torch.service.metrics import MetricsRegistry
from sm_distributed_tpu_torch.utils import failpoints as tfp

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(min_replicas=1, max_replicas=4, cooldown_s=60.0,
           hysteresis_ticks=2, scale_up_burn=1.0, scale_down_burn=0.5,
           queue_high_per_replica=8.0, queue_low_per_replica=1.0,
           occupancy_high=0.95)


def _decide_both(cfg: dict, state: dict, sig: dict, now: float):
    got = tfleet.decide(tconfig.FleetConfig(**cfg), tfleet.FleetState(**state),
                        tfleet.FleetSignals(**sig), now)
    want = jfleet.decide(jconfig.FleetConfig(**cfg),
                         jfleet.FleetState(**state),
                         jfleet.FleetSignals(**sig), now)
    return (got[0], vars(got[1])), (want[0], vars(want[1]))


# the decision cases of tests/test_fleet.py: (cfg overrides, state,
# signals, now)
CASES = {
    "repair-below-min": ({}, {"last_scale_at": 1000.0},
                         {"queue_depth": 0, "alive": 0}, 1000.1),
    "above-max-drains": ({}, {"last_scale_at": 1000.0},
                         {"queue_depth": 0, "alive": 5}, 1000.1),
    "hysteresis-first-tick": ({}, {}, {"queue_depth": 100, "alive": 2},
                              100.0),
    "hysteresis-second-tick": ({}, {"high_ticks": 1},
                               {"queue_depth": 100, "alive": 2}, 101.0),
    "calm-tick-resets": ({}, {"high_ticks": 1},
                         {"queue_depth": 4, "alive": 2}, 101.0),
    "cooldown-blocks": ({}, {"last_scale_at": 1000.0, "high_ticks": 5},
                        {"queue_depth": 100, "alive": 2}, 1059.99),
    "cooldown-releases": ({}, {"last_scale_at": 1000.0, "high_ticks": 5},
                          {"queue_depth": 100, "alive": 2}, 1060.0),
    "burn-at-threshold": ({}, {"high_ticks": 5},
                          {"queue_depth": 0, "alive": 2, "burn": 1.0}, 1e6),
    "burn-below-threshold": ({}, {"high_ticks": 5},
                             {"queue_depth": 0, "alive": 2, "burn": 0.99},
                             1e6),
    "relief-burn-too-high": ({}, {"low_ticks": 5},
                             {"queue_depth": 0, "alive": 2, "burn": 0.51},
                             1e6),
    "relief-burn-at-threshold": ({}, {"low_ticks": 5},
                                 {"queue_depth": 0, "alive": 2, "burn": 0.5},
                                 1e6),
    "occupancy-pressure": ({}, {"high_ticks": 5},
                           {"queue_depth": 0, "alive": 2, "occupancy": 0.96},
                           1e6),
    "occupancy-disabled": ({"hysteresis_ticks": 1, "occupancy_high": 0.0},
                           {"high_ticks": 5},
                           {"queue_depth": 4, "alive": 2, "occupancy": 1.0},
                           1e6),
    "ceiling-clamp": ({}, {"high_ticks": 50},
                      {"queue_depth": 10_000, "alive": 4}, 1e6),
    "floor-clamp": ({}, {"low_ticks": 50}, {"queue_depth": 0, "alive": 1},
                    1e6),
    "queue-per-replica-1": ({}, {"high_ticks": 5},
                            {"queue_depth": 10, "alive": 1}, 1e6),
    "queue-per-replica-4": ({}, {"high_ticks": 5},
                            {"queue_depth": 10, "alive": 4}, 1e6),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decide_equals_the_jax_decide(case):
    over, state, sig, now = CASES[case]
    got, want = _decide_both({**CFG, **over}, state, sig, now)
    assert got == want


@settings(max_examples=300, deadline=None)
@given(
    cfg=st.fixed_dictionaries({
        "min_replicas": st.integers(1, 3),
        "max_replicas": st.integers(3, 6),
        "cooldown_s": st.sampled_from([0.0, 5.0, 60.0]),
        "hysteresis_ticks": st.integers(1, 3),
        "scale_up_burn": st.sampled_from([0.5, 1.0, 2.0]),
        "scale_down_burn": st.sampled_from([0.0, 0.25, 0.5]),
        "queue_high_per_replica": st.sampled_from([2.0, 8.0]),
        "queue_low_per_replica": st.sampled_from([0.0, 1.0, 2.0]),
        "occupancy_high": st.sampled_from([0.0, 0.5, 0.95, 1.0])}),
    state=st.fixed_dictionaries({
        "last_scale_at": st.sampled_from([0.0, 90.0, 99.5]),
        "high_ticks": st.integers(0, 4), "low_ticks": st.integers(0, 4)}),
    sig=st.fixed_dictionaries({
        "queue_depth": st.integers(0, 64), "alive": st.integers(0, 7),
        "burn": st.one_of(st.none(), st.floats(0.0, 4.0)),
        "occupancy": st.one_of(st.none(), st.floats(0.0, 1.0))}),
    now=st.sampled_from([100.0, 150.0, 1e6]))
def test_decide_equals_the_jax_decide_on_drawn_signals(cfg, state, sig, now):
    got, want = _decide_both(cfg, state, sig, now)
    assert got == want


def test_spool_signals_equal_the_jax_packages(tmp_path):
    def case(publisher, registry_cls, signals, d):
        reg = registry_cls(d / "sm_annotate", "r1", stale_after_s=5.0)
        reg.register()
        pub = publisher(d)
        for i in range(4):
            pub.publish({"ds_id": f"q{i}", "msg_id": f"q{i}",
                         "input_path": "x"})
        first = vars(signals(d / "sm_annotate", reg)())
        reg.request_drain("r1")
        return first, vars(signals(d / "sm_annotate", reg)())

    got = case(QueuePublisher, ReplicaRegistry, tfleet.spool_signals,
               tmp_path / "t")
    want = case(JPublisher, JRegistry, jfleet.spool_signals, tmp_path / "j")
    assert got == want
    assert got[0]["queue_depth"] == 4 and got[0]["alive"] == 1
    assert got[1]["alive"] == 0


# ------------------------------------------------------ the controller
class _FakeProc:
    """A supervised replica: ``poll`` None until it exits."""

    _pids = iter(range(10_000, 20_000))

    def __init__(self):
        self.pid = next(self._pids)
        self.rc = None

    def poll(self):
        return self.rc

    def wait(self, timeout=None):
        deadline = time.time() + (timeout or 0.0)
        while self.rc is None:
            if time.time() >= deadline:
                raise subprocess.TimeoutExpired("replica", timeout)
            time.sleep(0.01)
        return self.rc

    def kill(self):
        self.rc = -9

    def terminate(self):
        self.rc = -15


def _controller(tmp_path, metrics=None, **cfg):
    spawned: dict[str, _FakeProc] = {}

    def spawn(rid):
        spawned[rid] = _FakeProc()
        return spawned[rid]

    fc = tfleet.FleetController(
        tmp_path, tconfig.FleetConfig(**{
            "min_replicas": 2, "max_replicas": 3, "cooldown_s": 0.0,
            "hysteresis_ticks": 1, "spawn_timeout_s": 30.0,
            "drain_timeout_s": 60.0, **cfg}),
        tconfig.ServiceConfig(replica_stale_after_s=5.0), spawn=spawn,
        metrics=metrics)
    return fc, spawned


def _register(tmp_path, rid):
    reg = ReplicaRegistry(tmp_path / "sm_annotate", rid, stale_after_s=5.0)
    reg.register()
    return reg


def test_controller_spawns_to_the_floor_and_replaces_a_crash(tmp_path):
    m = MetricsRegistry()
    fc, spawned = _controller(tmp_path, metrics=m)
    assert fc.tick(now=100.0) == 1 and list(spawned) == ["fr1"]
    # fr1 has not registered yet: it counts as pending, no second spawn
    # storm past the floor while it warms up
    assert fc.tick(now=100.5) == 1 and list(spawned) == ["fr1", "fr2"]
    assert fc.tick(now=101.0) == 0
    regs = {rid: _register(tmp_path, rid) for rid in spawned}
    fc.tick(now=101.5)
    assert all(c["registered"] for c in fc.status()["children"].values())
    # fr2 dies without a drain request: a crash, then a replacement fr3
    spawned["fr2"].rc = -9
    regs["fr2"].retire()
    assert fc.tick(now=102.0) == 1
    st_ = fc.status()
    assert st_["crashes_total"] == 1 and sorted(st_["children"]) == [
        "fr1", "fr3"]
    text = m.expose()
    assert "sm_fleet_crashes_total 1" in text
    assert 'sm_fleet_scale_events_total{direction="up"} 3' in text


def test_controller_drains_lifo_with_the_ack(tmp_path):
    fc, spawned = _controller(tmp_path, min_replicas=1, max_replicas=3,
                              queue_low_per_replica=1.0)
    fc.tick(now=100.0)
    spawned_ids = list(spawned)
    regs = {rid: _register(tmp_path, rid) for rid in spawned_ids}
    fc._scale_up(100.1)                      # a second replica
    regs["fr2"] = _register(tmp_path, "fr2")
    fc.tick(now=101.0)                       # relief: drain the newest
    assert fc.status()["children"]["fr2"]["draining"]
    assert regs["fr2"].drain_requested()
    regs["fr2"].ack_drain()
    spawned["fr2"].rc = 0
    fc.tick(now=102.0)
    st_ = fc.status()
    assert st_["drains_total"] == 1 and list(st_["children"]) == ["fr1"]
    assert not regs["fr2"].drain_requested()          # sentinel cleared


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_controller_does_not_repair_against_its_own_shutdown(tmp_path, pkg):
    """``serve --fleet``: replica r0 hosts the controller and retires when
    its service shuts down.  A tick that sees r0 gone would spawn a
    replacement that registers after the shutdown's drain request (which
    registering clears) and keeps the shutdown waiting ``drain_timeout_s``.
    The port's controller takes ``halt_when`` (the service's ``stopping``)
    and acts no more once it holds; the JAX controller has no such guard
    and spawns."""
    fleet_mod, config_mod, registry_cls = {
        "jax": (jfleet, jconfig, JRegistry),
        "torch": (tfleet, tconfig, ReplicaRegistry)}[pkg]
    spawned: list = []
    stopping: list = []

    def spawn(rid):
        spawned.append(rid)
        return _FakeProc()

    kwargs = {} if pkg == "jax" else {"halt_when": lambda: bool(stopping)}
    fc = fleet_mod.FleetController(
        tmp_path, config_mod.FleetConfig(min_replicas=2, max_replicas=2,
                                         cooldown_s=0.0, hysteresis_ticks=1),
        config_mod.ServiceConfig(replica_stale_after_s=5.0), spawn=spawn,
        self_replica_id="r0", **kwargs)
    r0 = registry_cls(tmp_path / "sm_annotate", "r0", stale_after_s=5.0)
    r0.register()
    assert fc.tick(now=100.0) == 1 and spawned == ["fr1"]
    registry_cls(tmp_path / "sm_annotate", "fr1",
                 stale_after_s=5.0).register()
    assert fc.tick(now=101.0) == 0
    stopping.append(True)        # the service's shutdown begins ...
    r0.retire()                  # ... and retires its replica
    assert fc.tick(now=102.0) == (1 if pkg == "jax" else 0)
    assert spawned == (["fr1", "fr2"] if pkg == "jax" else ["fr1"])


def test_controller_culls_a_spawn_that_never_registers(tmp_path):
    m = MetricsRegistry()
    fc, spawned = _controller(tmp_path, metrics=m, min_replicas=1,
                              spawn_timeout_s=5.0)
    fc.tick(now=100.0)
    fc.tick(now=106.0)
    assert spawned["fr1"].rc == -9
    assert "sm_fleet_spawn_failures_total 1" in m.expose()


def test_controller_shutdown_drains_every_child(tmp_path):
    fc, spawned = _controller(tmp_path)
    fc.tick(now=100.0)
    fc.tick(now=100.1)
    regs = {rid: _register(tmp_path, rid) for rid in spawned}

    def exit_on_drain():
        deadline = time.time() + 10
        while time.time() < deadline:
            for rid, reg in regs.items():
                if reg.drain_requested() and spawned[rid].rc is None:
                    reg.ack_drain()
                    spawned[rid].rc = 0
            if all(p.rc is not None for p in spawned.values()):
                return
            time.sleep(0.01)

    t = threading.Thread(target=exit_on_drain)
    t.start()
    fc.shutdown(timeout_s=5.0)
    t.join()
    assert all(p.rc == 0 for p in spawned.values())
    assert fc.drains_total == 2


def test_fleet_families_equal_the_jax_packages(tmp_path):
    def families(metrics_cls, fleet_mod, config_mod, d):
        m = metrics_cls()

        def no_spawn(rid):
            raise OSError("no spawns in this test")

        fc = fleet_mod.FleetController(
            d, config_mod.FleetConfig(min_replicas=1, max_replicas=2),
            config_mod.ServiceConfig(), spawn=no_spawn, metrics=m)
        fc.tick(now=100.0)                   # a spawn that fails
        return ({ln for ln in m.expose().splitlines()
                 if ln.startswith("sm_fleet_")}, fc.status()["alive"])

    got = families(MetricsRegistry, tfleet, tconfig, tmp_path / "t")
    assert got == families(JMetrics, jfleet, jconfig, tmp_path / "j")
    assert "sm_fleet_spawn_failures_total 1" in got[0]


def test_write_child_config_disables_nested_fleet(tmp_path):
    sm = tconfig.SMConfig.from_dict({"service": {"fleet": {"enabled": True}},
                                     "device": "cpu"})
    child = json.loads(tfleet.write_child_config(sm, tmp_path).read_text())
    assert child["service"]["fleet"]["enabled"] is False
    again = tconfig.SMConfig.from_dict(child)
    assert again.service.fleet.enabled is False and again.device == "cpu"


def test_serve_spawn_runs_the_ports_serve(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(tfleet.subprocess, "Popen",
                        lambda cmd, env: seen.update(cmd=cmd, env=env))
    tfleet.serve_spawn(tmp_path / "q", tmp_path / "sm.json")("fr7", "h1")
    assert seen["cmd"][1:4] == ["-m", "sm_distributed_tpu_torch.engine.cli",
                                "serve"]
    assert seen["cmd"][-4:] == ["--replica-id", "fr7", "--port", "0"]
    assert seen["env"]["SM_HOST_NAME"] == "h1"


# ------------------------------------------------- the chaos scenario
def test_fleet_spawn_scenario_converges_beside_the_jax_scripts(tmp_path):
    """The controller killed mid-spawn: the restarted controller repairs
    the fleet and the job completes exactly once, in both packages' sweeps,
    to the same spool and ledger states."""
    jfp.reset()
    tfp.reset()
    port = tchaos.run_sweep(tmp_path / "torch", only=["fleet.spawn"])
    ref = jchaos.run_sweep(tmp_path / "jax", only=["fleet.spawn"])
    for r in port + ref:
        assert r["ok"], f"{r['scenario']}: {r.get('error')}"
    assert port[0]["invariant_errors"] == []
    final = port[0]["final"]
    assert final["spool"]["done"] == [f"{tchaos.MSG_ID}.json"]
    assert "STARTED" not in final["ledger"] and \
        final["ledger"][-1] == "FINISHED"


# ---------------------------------------------------- serve --fleet, CPU
def _http(base: str, path: str):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        raw = r.read().decode()
    try:
        return json.loads(raw)
    except ValueError:
        return raw


def _children_of(pid: int) -> dict:
    out = {}
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
            if int(fields[1]) != pid:
                continue
            args = [a.decode() for a in
                    (stat.parent / "cmdline").read_bytes().split(b"\0")]
        except (OSError, ValueError, IndexError):
            continue
        if "--replica-id" in args:
            out[args[args.index("--replica-id") + 1]] = int(stat.parent.name)
    return out


def _wait(what, ready, deadline):
    while not ready():
        assert time.time() < deadline, f"{what} never held"
        time.sleep(0.1)


@pytest.mark.skipif(not Path("/proc").is_dir(), reason="needs /proc")
def test_serve_fleet_end_to_end_on_the_cpu(tmp_path):
    from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset

    path, truth = generate_synthetic_dataset(
        tmp_path / "fx", nrows=8, ncols=8, formulas=None,
        present_fraction=0.5, noise_peaks=10, seed=5)
    sm_json = tmp_path / "sm.json"
    sm_json.write_text(json.dumps({
        "backend": "torch_cuda", "device": "cpu",
        "fdr": {"decoy_sample_size": 2},
        "work_dir": str(tmp_path / "work"),
        "storage": {"results_dir": str(tmp_path / "results")},
        "service": {"workers": 1, "http_port": 0, "poll_interval_s": 0.05,
                    "heartbeat_interval_s": 0.2,
                    "replica_heartbeat_interval_s": 0.2,
                    "replica_stale_after_s": 3.0, "takeover_interval_s": 0.2,
                    "fleet": {"min_replicas": 2, "max_replicas": 2,
                              "decide_interval_s": 0.2, "cooldown_s": 0.0,
                              "hysteresis_ticks": 1,
                              "spawn_timeout_s": 120.0,
                              "drain_timeout_s": 60.0},
                    "fleetview": {"cache_ttl_s": 0.0}},
        "telemetry": {"enabled": False}}))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("SM_FAILPOINTS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sm_distributed_tpu_torch.engine.cli", "serve",
         str(tmp_path / "q"), "--sm-config", str(sm_json), "--fleet"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(ROOT))
    lines: list[str] = []
    reader = threading.Thread(
        target=lambda: [lines.append(ln) for ln in proc.stderr], daemon=True)
    reader.start()
    deadline = time.time() + 240
    root = tmp_path / "q" / "sm_annotate"
    try:
        _wait("the admin API line", lambda: any(
            "admin API on http://" in ln for ln in lines), deadline)
        base = re.search(r"admin API on (http://[\d.]+:\d+)",
                         "".join(lines)).group(1)

        def alive():
            return {rid for rid, r in _http(base, "/fleet/status")[
                "replicas"].items() if r["alive"] and not r["draining"]}

        _wait("two replicas", lambda: len(alive()) == 2, deadline)
        (spawned,) = alive() - {"r0"}
        QueuePublisher(tmp_path / "q").publish({
            "ds_id": "fl", "msg_id": "fl", "input_path": str(path),
            "formulas": truth.formulas[:2]})
        _wait("the job done", lambda: (root / "done" / "fl.json").exists(),
              deadline)
        slo = _http(base, "/fleet/slo")
        assert slo["fleet"]["replicas_merged"] == 2
        # the replicas' kernel launch counts, summed (none on the CPU)
        merged = _http(base, "/fleet/metrics")
        assert {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                for ln in merged.splitlines()
                if ln.startswith("sm_kernel_launches_total{")} == {
            f'sm_kernel_launches_total{{kernel="{k}"}}': 0.0
            for k in ("moments", "chaos", "chaos_tiles", "chaos_strips",
                      "fused_window_moments")}
        os.kill(_children_of(proc.pid)[spawned], signal.SIGKILL)
        _wait("a crash counted", lambda: "sm_fleet_crashes_total 1" in
              _http(base, "/metrics"), deadline)
        _wait("a replacement", lambda: len(alive() - {"r0", spawned}) == 1,
              deadline)
        children = _children_of(proc.pid)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=30)
    log = "".join(lines)
    assert rc == 0, log[-3000:]
    assert children and all(
        f"replica {rid} drained (rc=0, acked=True)" in log for rid in children)
    assert sorted(p.name for p in (root / "done").glob("*.json")) == [
        "fl.json"]
    assert not list((root / "running").glob("*.json"))
