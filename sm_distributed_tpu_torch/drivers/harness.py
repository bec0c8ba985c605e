"""One in-process annotation service of the port and the HTTP helpers the
service drivers share (a copy of the ``Harness`` of the JAX package's
``scripts/load_sweep.py``)."""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from pathlib import Path

from sm_distributed_tpu_torch.drivers.chaos_sweep import deep_merge
from sm_distributed_tpu_torch.engine.daemon import annotate_callback
from sm_distributed_tpu_torch.io.fixtures import generate_synthetic_dataset
from sm_distributed_tpu_torch.service import AnnotationService
from sm_distributed_tpu_torch.utils.config import SMConfig

TERMINAL = ("done", "failed", "cancelled", "quarantined")


def http(base: str, method: str, path: str, body: dict | None = None):
    """(status, headers, parsed-json) — 4xx/5xx returned, not raised."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, method=method, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30.0) as r:
            return r.status, dict(r.headers), json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            parsed = json.loads(raw or b"{}")
        except json.JSONDecodeError:
            parsed = {"raw": raw.decode(errors="replace")}
        return e.code, dict(e.headers), parsed


def get_json(base: str, path: str) -> dict:
    with urllib.request.urlopen(base + path, timeout=30.0) as r:
        return json.loads(r.read())


class Harness:
    """One service instance + the assertion helpers the drivers share."""

    def __init__(self, base: Path, name: str, sm_overrides: dict | None = None):
        self.dir = base / name
        self.queue_dir = self.dir / "queue"
        self.root = self.queue_dir / "sm_annotate"
        sm = {
            "backend": "numpy_ref",
            "fdr": {"decoy_sample_size": 2, "seed": 1},
            "parallel": {"formula_batch": 8, "checkpoint_every": 1,
                         "resident_datasets": 2, "order_ions": "table"},
            "storage": {"results_dir": str(self.dir / "results"),
                        "store_images": False},
            "work_dir": str(self.dir / "work"),
            "service": {
                "workers": 2, "poll_interval_s": 0.02, "job_timeout_s": 30.0,
                "max_attempts": 2, "backoff_base_s": 0.05,
                "backoff_max_s": 0.2, "backoff_jitter": 0.0,
                "heartbeat_interval_s": 0.1, "stale_after_s": 2.0,
                "drain_timeout_s": 20.0, "cancel_grace_s": 10.0,
                "quarantine_after": 3, "http_port": 0,
                "admission": {"max_queue_depth": 6, "max_tenant_inflight": 4,
                              "retry_after_s": 1.0},
            },
        }
        if sm_overrides:
            sm = deep_merge(sm, sm_overrides)
        self.sm_config = SMConfig.from_dict(sm)
        self.service = AnnotationService(
            self.queue_dir, annotate_callback(self.sm_config),
            sm_config=self.sm_config)
        self.service.start()
        host, port = self.service.api.address
        self.base = f"http://{host}:{port}"

    def submit(self, msg: dict):
        return http(self.base, "POST", "/submit", msg)

    def jobs(self) -> dict:
        _s, _h, rows = http(self.base, "GET", "/jobs")
        return {r["msg_id"]: r for r in rows}

    def metrics_text(self) -> str:
        with urllib.request.urlopen(self.base + "/metrics", timeout=30.0) as r:
            return r.read().decode()

    def wait_terminal(self, msg_ids, timeout_s: float = 120.0) -> dict:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            rows = self.jobs()
            if all(m in rows and rows[m]["state"] in TERMINAL
                   for m in msg_ids):
                return rows
            time.sleep(0.05)
        rows = self.jobs()
        missing = {m: rows.get(m, {}).get("state", "absent") for m in msg_ids
                   if rows.get(m, {}).get("state") not in TERMINAL}
        raise AssertionError(f"jobs never reached a terminal state: {missing}")

    def shutdown(self):
        self.service.shutdown()


def build_fixtures(base: Path) -> dict:
    """One tiny dataset every job shares (the isocalc cache and the
    resident backend warm after job 1)."""
    fast_path, fast_truth = generate_synthetic_dataset(
        base / "fx_fast", nrows=8, ncols=8, formulas=None,
        present_fraction=0.5, noise_peaks=30, seed=11)
    return {
        "fast": {"input_path": str(fast_path),
                 "formulas": fast_truth.formulas[:3],
                 "ds_config": {"isotope_generation": {"adducts": ["+H"]}}},
    }


def msg(fx: dict, kind: str, ds_id: str, **extra) -> dict:
    return {"ds_id": ds_id, "msg_id": ds_id, **fx[kind], **extra}
