"""Shared by the load-sweep parity tests: one mix of the port's
``drivers/load_sweep.py`` and the JAX package's ``scripts/load_sweep.py``
mix of the same name, each on its own work directory, with what each
side's harnesses saw recorded the same way (every submit's status, shed
reason and ``Retry-After``; each harness's job rows and ``/metrics`` text
just before it shuts down), and the readings the tests compare: spool
censuses, counters and FDR ranks.

The port's mix runs in the test's process on ``torch_cuda`` with
``device="cpu"``.  The JAX mix runs as its sweep runs it (``numpy_ref``,
its breaker mix ``jax_tpu``), in a process of its own with the one CPU
device a command-line run sees: the test process's virtual 8-device mesh
would hand its breaker mix's retries a fresh chip each, whose breakers
then never reach their threshold.

    python -m tests.torch_sweep_parity MIX WORK     # the JAX side of MIX
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import asdict, dataclass, field
from pathlib import Path

import pandas as pd

ROOT = Path(__file__).resolve().parent.parent
STATES = ("pending", "running", "done", "failed", "quarantine")
JAX_TIMEOUT_S = 600

# the JAX sweep's own caveat (ROADMAP queue 3): its depth reading sums a
# glob of pending/ and one of running/, so a message renamed between the
# two counts twice, and its bound check fails on a count no state ever
# held.  Its harness reads the depth here as the port's does, by the
# distinct ids in the two directories; a run that still fails on the
# bound is no reference and is made once more.  The port's run is held as
# it came
REFERENCE_CAVEATS = ("> configured bound",
                     # its elastic surge is a fixed 420 jobs: on a loaded
                     # host the queue can drain before a fourth replica
                     # is up (the port's mix tops the surge up)
                     "never observed surge")

# mixes that run on the in-process "main" harness, by name; the others
# build their own harnesses under the work directory
MAIN = ("burst", "sustained", "deadline", "cancel", "poison")

# the JAX mixes gate their p99 waits and read latency on the wall clock;
# the port prints those figures and decides by states, counts and bits
# (ROADMAP's "Deliberate departures"), so the reference's outcomes are
# compared here with its wall-clock bounds lifted
UNGATED = {"p99_bound_s": float("inf")}


@dataclass
class Seen:
    """What one side's harnesses saw."""

    submits: list[dict] = field(default_factory=list)
    final: dict[str, dict] = field(default_factory=dict)

    def rows(self, harness: str = "main/r0") -> dict:
        return self.final[harness]["jobs"]

    def metrics(self, harness: str = "main/r0") -> str:
        return self.final[harness]["metrics"]


def record(setattr_, harness_cls, seen: Seen) -> None:
    """Record every submit and each harness's last job rows and metrics
    (``setattr_`` is ``monkeypatch.setattr`` or ``setattr``)."""
    real_submit = harness_cls.submit
    real_shutdown = harness_cls.shutdown

    def submit(self, msg):
        status, headers, body = real_submit(self, msg)
        seen.submits.append({"msg_id": msg.get("msg_id"), "status": status,
                             "reason": body.get("reason"),
                             "retry_after": "Retry-After" in headers})
        return status, headers, body

    def shutdown(self):
        key = f"{self.dir.name}/{self.sm_config.service.replica_id}"
        if key not in seen.final:
            seen.final[key] = {
                "jobs": {m: [r["state"], r["attempts"]]
                         for m, r in self.jobs().items()},
                "metrics": self.metrics_text()}
        real_shutdown(self)

    setattr_(harness_cls, "submit", submit)
    setattr_(harness_cls, "shutdown", shutdown)


def census(root: Path) -> dict:
    return {s: sorted(p.stem for p in (root / s).glob("*.json"))
            for s in STATES}


def metric(text: str, prefix: str) -> float:
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(prefix))


def fdr_ranks(results: Path, ds_id: str) -> list:
    ann = pd.read_parquet(results / ds_id / "annotations.parquet")
    return sorted(zip(ann["sf"], ann["adduct"], ann["fdr"]))


def sheds(seen: Seen) -> dict:
    """The shed submits, read the same way on both sides."""
    shed = [s for s in seen.submits if s["status"] != 202]
    return {"statuses": sorted({s["status"] for s in shed}),
            "structured": all(s["retry_after"] and s["reason"]
                              for s in shed),
            "any": bool(shed)}


def _run_mix(side: str, mod, harness_mod, name: str, work: Path) -> None:
    """One mix on one side, as its sweep calls it."""
    ungated = UNGATED if side == "jax" else {}
    if name in ("replicas", "pod", "elastic"):
        getattr(mod, f"mix_{name}")(work, **ungated)
        return
    fx = harness_mod.build_fixtures(work)
    dev = ("torch_cuda", "cpu") if side == "port" else ()
    if name in MAIN:
        h = harness_mod.Harness(work, "main", sm_overrides=(
            {"backend": dev[0], "device": dev[1]} if dev else None))
        try:
            if name == "burst":
                mod.mix_burst(h, fx, n_submit=12)
            elif name == "sustained":
                mod.mix_sustained(h, fx, 10, 0.1)
            else:
                getattr(mod, f"mix_{name}")(h, fx)
        finally:
            h.shutdown()
    elif name == "breaker":
        mod.mix_breaker(work, fx, *dev[1:])
    elif name in ("disk", "stream"):
        getattr(mod, f"mix_{name}")(work, fx, *dev)
    else:
        getattr(mod, f"mix_{name}")(work, fx, *dev, **ungated)


def jax_main(name: str, work: str) -> int:
    """The JAX side of one mix: run, then write what its harnesses saw to
    ``WORK/seen.json`` (with the failed check's text, if one failed)."""
    import scripts.load_sweep as jls
    from sm_distributed_tpu_torch.drivers.harness import queued_ids

    seen = Seen()
    record(setattr, jls.Harness, seen)
    jls.Harness.sample_depth = lambda h: len(queued_ids(h.root))
    out = Path(work)
    try:
        _run_mix("jax", jls, jls, name, out)
        error = None
    except jls.SweepError as exc:
        error = str(exc)
    out.mkdir(parents=True, exist_ok=True)
    (out / "seen.json").write_text(json.dumps(
        {"seen": asdict(seen), "error": error}))
    return 0


class Sides:
    """Runs one mix on each side, each on its own directory under
    ``base``."""

    def __init__(self, base: Path, monkeypatch):
        from sm_distributed_tpu_torch.drivers import harness as th

        self.base = base
        self.seen = {"port": Seen(), "jax": Seen()}
        self.th = th
        record(monkeypatch.setattr, th.Harness, self.seen["port"])
        self.work: dict[str, Path] = {}

    def port(self, name: str) -> Path:
        from sm_distributed_tpu_torch.drivers import load_sweep as tls

        work = self.base / "port"
        _run_mix("port", tls, self.th, name, work)
        self.work["port"] = work
        return work

    def jax(self, name: str) -> Path:
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        env.pop("SM_FAILPOINTS", None)
        # the one CPU device of a command-line run
        env["XLA_FLAGS"] = " ".join(
            f for f in env.get("XLA_FLAGS", "").split()
            if "xla_force_host_platform_device_count" not in f)
        for attempt in ("jax", "jax-again"):
            work = self.base / attempt
            proc = subprocess.run(
                [sys.executable, "-m", "tests.torch_sweep_parity", name,
                 str(work)], env=env, cwd=str(ROOT), capture_output=True,
                text=True, timeout=JAX_TIMEOUT_S)
            assert proc.returncode == 0, proc.stdout[-2000:] + \
                proc.stderr[-3000:]
            got = json.loads((work / "seen.json").read_text())
            error = got["error"]
            if error and attempt == "jax" and any(
                    c in error for c in REFERENCE_CAVEATS):
                continue
            assert error is None, f"the JAX {name} mix failed: {error}"
            self.seen["jax"] = Seen(**got["seen"])
            self.work["jax"] = work
            return work
        raise AssertionError("unreachable")

    def both(self, name: str) -> "Sides":
        self.port(name)
        self.jax(name)
        return self


if __name__ == "__main__":
    sys.exit(jax_main(sys.argv[1], sys.argv[2]))
