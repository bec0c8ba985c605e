"""``utils.tracing.validate_records`` of the port against the JAX
package's: the same records give the same problems, and the traces the
port writes (nested spans, events, a retried service job) validate.
"""

from __future__ import annotations

import pytest

from sm_distributed_tpu.utils import tracing as jtracing
from sm_distributed_tpu_torch.utils import tracing as ttracing

SPAN = {"kind": "span", "trace_id": "t", "span_id": "s", "parent_id": "p",
        "name": "x", "ts": 1.0, "dur": 0.5, "pid": 1, "tid": 2}
EVENT = {"kind": "event", "trace_id": "t", "span_id": "s", "name": "e",
         "ts": 1.0, "pid": 1, "tid": 2}

CASES = {
    "valid": [SPAN, EVENT, {**EVENT, "attrs": {"a": 1}}],
    "not_an_object": [SPAN, ["span"], "x"],
    "bad_kind": [{**SPAN, "kind": "metric"}, {"name": "no kind"}],
    "span_missing_keys": [{k: v for k, v in SPAN.items()
                           if k not in ("dur", "parent_id")}],
    "event_missing_keys": [{k: v for k, v in EVENT.items() if k != "tid"}],
    "dur_not_numeric": [{**SPAN, "dur": "0.5"}],
    "attrs_not_an_object": [{**EVENT, "attrs": [1, 2]}],
    "empty": [],
}


@pytest.fixture(autouse=True)
def _fresh_tracing():
    for tr in (jtracing, ttracing):
        tr.configure(enabled=True, ring_size=2048)
        tr.flight_recorder.clear()
    yield
    for tr in (jtracing, ttracing):
        tr.close_files()
        tr.flight_recorder.clear()


@pytest.mark.parametrize("name", sorted(CASES))
def test_validate_records_matches_the_jax_packages(name):
    recs = CASES[name]
    got = ttracing.validate_records(recs)
    assert got == jtracing.validate_records(recs)
    assert (not got) == (name in ("valid", "empty"))


def test_written_trace_validates(tmp_path):
    out = {}
    for name, tr in (("jax", jtracing), ("torch", ttracing)):
        ctx = tr.new_trace(job_id="j1", trace_dir=tmp_path / name)
        with tr.attach(ctx):
            with tr.span("outer"):
                with tr.span("inner", depth=2):
                    tr.event("mark", note="x")
        recs = tr.read_trace(ctx.file)
        out[name] = ([r["name"] for r in recs], tr.validate_records(recs))
    assert out["torch"] == out["jax"] == (["mark", "inner", "outer"], [])
