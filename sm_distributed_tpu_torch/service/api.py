"""Admin API over stdlib ``http.server`` — no web framework in the image.

Copy of ``sm_distributed_tpu/service/api.py``: the same routes, bodies and
status codes for what the port serves.  Endpoints:

- ``GET /healthz``   liveness + spool depths + admission state; 200 while
  serving, 503 once shutdown has begun (load balancers stop routing before
  the drain ends);
- ``GET /metrics``   Prometheus text exposition from the service registry;
- ``GET /jobs``      JSON array of the scheduler's job records (filter with
  ``?state=running`` etc.);
- ``POST /submit``   body = a spool message (``ds_id`` + ``input_path`` at
  minimum, optional ``priority``/``tenant``/``deadline_s``/
  ``service.timeout_s``); returns ``{"msg_id": ...}`` 202.  Publishing goes
  through ``QueuePublisher`` so a submitted job is durable before the
  response leaves.  Overload protection sits in front: a shed submit gets a
  structured **429** (``queue_full`` / ``tenant_quota``) or **503**
  (``latency_overload`` / draining) with a ``Retry-After`` header and a
  JSON body naming the reason (``service/admission.py``).  Malformed
  payloads get a structured **400**, never a traceback;
- ``DELETE /jobs/<id>``  cooperative cancel: a queued message terminates
  immediately, a running attempt unwinds at its next checkpoint boundary
  (``utils/cancel.py``); 202 while cancelling, 200 when already terminal-
  cancelled here, 409 for finished jobs, 404 for unknown ids;
- ``GET /jobs/<id>/trace``  the job's end-to-end trace (utils/tracing.py)
  as Chrome trace-event JSON — Perfetto-loadable, one root ``submit`` span
  covering admission → claim → every SearchJob phase → per-batch scoring →
  isocalc workers → store_results.  ``?raw=1`` returns the raw records;
- ``GET /debug/events?n=``  the most recent N flight-recorder records
  (default 256) — every span/event from every job plus traceless service
  events (admission sheds, breaker flips);
- ``GET /slo``  objective / attainment / error-budget burn per latency SLI
  (queue-wait, submit→first-annotation, end-to-end), computed from the
  live histograms (``service/telemetry.py``);
- ``GET /debug/timeseries?n=``  the telemetry monitor's bounded ring of
  periodic metric snapshots (per-device memory, device-pool occupancy,
  queue depths, RSS);
- ``GET /debug/resources``  the resource governor's snapshot
  (``service/resources.py``): disk degrade level + headroom, per-seam
  preflight denials, retention-GC stats, and the HBM-OOM safe-batch
  registry.  Submits shed by a disk-budget breach return **507** with a
  ``Retry-After`` header (the last step of the traces → cache → submits
  degrade order);
- ``GET /debug/devices``  the chip-level device-pool view:
  per-chip health state + fault strikes + quarantine evidence
  (``service/health.py``), lease holders, probe/quarantine/readmit/
  host-eviction totals, and the breaker's state;
- ``GET /peers``  the replica registry view;
- ``GET /debug/compile``  the cold-start view: every recorded shape bucket
  with its primed/missing status (``service/primer.py``) plus the kernel
  build census (``kernels/_build.py``: built or found, nvcc seconds,
  ptxas registers and spills, loads and launch set-ups by device), which
  takes the place of the JAX package's retrace census;
- ``GET /fleet/metrics`` / ``GET /fleet/slo`` / ``GET /fleet/status``
  the fleet observability plane (``service/fleetview.py``): every live
  replica's exposition merged (counters summed, gauges re-labelled,
  histograms bucket-merged), fleet-wide SLO attainment from the merged
  buckets, and the replica / host / pool / stream status, degrading to a
  partial view with ``sm_fleetview_scrape_errors_total{replica=}``
  evidence when a peer dies mid-scrape;
- ``GET /debug/profile?seconds=``  single-flight on-demand
  ``torch.profiler`` capture around in-flight work: per-kernel device-time
  attribution (fused moments kernel vs scoring chain vs transfers) +
  ``device_kernel`` spans injected into running jobs' traces (409 while
  another capture runs, 404 when ``telemetry.profile.enabled`` is off);
- ``GET /datasets`` / ``GET /datasets/<id>/annotations`` /
  ``GET /annotations`` / ``GET /datasets/<id>/images/<sf_adduct>``  the
  result read path (``service/readpath.py``): dataset listing,
  filtered/sorted/keyset-paginated annotation queries, cross-dataset
  per-molecule cohorts, and PNG ion-image tiles; read-admission sheds
  return a structured **429** with ``Retry-After``, independent of the
  write-side admission;
- ``POST /datasets/<id>/pixels`` / ``POST /datasets/<id>/finish``  the
  live-acquisition chunk seam of a ``mode: "stream"`` submit
  (``engine/stream.py``).

``ThreadingHTTPServer`` keeps scrapes responsive while workers run; every
handler is read-only except ``/submit`` (appends to ``pending/``) and
``DELETE /jobs/<id>`` (cancels one message).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..utils import tracing
from ..utils.logger import logger

# message fields /submit validates beyond the publisher's ds_id/input_path
# requirement: (field, predicate, expectation) — anything else passes
# through untouched (the spool message schema is open)
def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate_submit(msg) -> list[str]:
    """Structural validation for a /submit payload; returns problem list
    (empty = valid).  Catches the malformed shapes that used to surface as
    a 500 traceback deep inside the scheduler."""
    if not isinstance(msg, dict):
        return ["message must be a JSON object"]
    errs = []
    if "mode" in msg and msg["mode"] not in ("batch", "stream"):
        errs.append("'mode' must be \"batch\" or \"stream\"")
    # a stream submit has no input file — the chunk log IS the input, so
    # input_path is auto-filled with a "stream://<ds_id>" sentinel
    required = (("ds_id",) if msg.get("mode") == "stream"
                else ("ds_id", "input_path"))
    for req in required:
        v = msg.get(req)
        if not isinstance(v, str) or not v:
            errs.append(f"{req!r} is required and must be a non-empty string")
    for name in ("tenant", "ds_name"):
        if name in msg and not isinstance(msg[name], str):
            errs.append(f"{name!r} must be a string")
    if "priority" in msg and not (
            isinstance(msg["priority"], (int, str))
            and not isinstance(msg["priority"], bool)):
        errs.append("'priority' must be a string class or an int rank")
    if "deadline_s" in msg:
        if not _is_num(msg["deadline_s"]) or msg["deadline_s"] <= 0:
            errs.append("'deadline_s' must be a positive number of seconds")
    if "devices" in msg and not (
            isinstance(msg["devices"], int)
            and not isinstance(msg["devices"], bool)
            and msg["devices"] > 0):
        errs.append("'devices' must be a positive integer chip count")
    svc = msg.get("service", {})
    if not isinstance(svc, dict):
        errs.append("'service' must be an object")
    else:
        for name in ("timeout_s", "deadline_s", "deadline_at"):
            if name in svc and (not _is_num(svc[name]) or svc[name] <= 0):
                errs.append(f"'service.{name}' must be a positive number")
        if "max_attempts" in svc and not (
                isinstance(svc["max_attempts"], int)
                and not isinstance(svc["max_attempts"], bool)
                and svc["max_attempts"] > 0):
            errs.append("'service.max_attempts' must be a positive integer")
        if "devices" in svc and not (
                isinstance(svc["devices"], int)
                and not isinstance(svc["devices"], bool)
                and svc["devices"] > 0):
            errs.append("'service.devices' must be a positive integer "
                        "chip count")
    return errs


class AdminAPI:
    """Own the HTTP server thread; routes delegate to the service object."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        api = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # route access logs to ours
                logger.debug("admin-api: " + fmt, *args)

            def _reply(self, status: int, body: bytes, ctype: str,
                       headers: dict | None = None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, status: int, obj,
                            headers: dict | None = None) -> None:
                self._reply(status, json.dumps(obj).encode(),
                            "application/json", headers)

            def _reply_read(self, result) -> None:
                """Render a ReadPath handler result: PNG bytes or JSON."""
                status, body, headers = result
                if isinstance(body, (bytes, bytearray)):
                    self._reply(status, bytes(body), "image/png", headers)
                else:
                    self._reply_json(status, body, headers)

            def do_GET(self):
                try:
                    url = urlparse(self.path)
                    if url.path == "/healthz":
                        body, status = api._healthz()
                        self._reply_json(status, body)
                    elif url.path == "/metrics":
                        text = api.service.metrics.expose()
                        self._reply(200, text.encode(),
                                    "text/plain; version=0.0.4")
                    elif url.path == "/jobs":
                        q = parse_qs(url.query)
                        self._reply_json(200, api._jobs(q.get("state", [None])[0]))
                    elif url.path == "/debug/events":
                        q = parse_qs(url.query)
                        n = int(q.get("n", ["256"])[0] or 256)
                        self._reply_json(
                            200, tracing.flight_recorder.recent(n))
                    elif url.path == "/debug/resources":
                        status, body = api._resources()
                        self._reply_json(status, body)
                    elif url.path == "/debug/devices":
                        status, body = api._devices()
                        self._reply_json(status, body)
                    elif url.path == "/debug/compile":
                        status, body = api._compile()
                        self._reply_json(status, body)
                    elif url.path == "/debug/timeseries":
                        q = parse_qs(url.query)
                        n = q.get("n", [None])[0]
                        status, body = api._timeseries(
                            int(n) if n else None)
                        self._reply_json(status, body)
                    elif url.path == "/slo":
                        status, body = api._slo()
                        self._reply_json(status, body)
                    elif url.path == "/peers":
                        self._reply_json(200, api._peers())
                    elif url.path == "/fleet/metrics":
                        status, text = api._fleet_metrics()
                        self._reply(status, text.encode(),
                                    "text/plain; version=0.0.4")
                    elif url.path == "/fleet/slo":
                        status, body = api._fleet_slo()
                        self._reply_json(status, body)
                    elif url.path == "/fleet/status":
                        status, body = api._fleet_status()
                        self._reply_json(status, body)
                    elif url.path == "/debug/profile":
                        q = parse_qs(url.query)
                        s = q.get("seconds", [None])[0]
                        try:
                            seconds = float(s) if s else None
                        except ValueError:
                            self._reply_json(
                                400, {"error": "'seconds' must be a number",
                                      "reason": "invalid_request"})
                            return
                        status, body = api._profile(seconds)
                        self._reply_json(status, body)
                    elif url.path == "/datasets" or url.path == "/annotations" \
                            or (url.path.startswith("/datasets/")
                                and url.path.strip("/").split("/")[2:3]
                                in (["annotations"], ["images"])):
                        rp = getattr(api.service, "readpath", None)
                        if rp is None:
                            self._reply_json(
                                404, {"error": "read path not configured",
                                      "reason": "not_found"})
                            return
                        q = parse_qs(url.query)
                        parts = url.path.strip("/").split("/")
                        if url.path == "/datasets":
                            self._reply_read(rp.handle_datasets())
                        elif url.path == "/annotations":
                            self._reply_read(rp.handle_cohort(q))
                        elif len(parts) == 3:
                            self._reply_read(
                                rp.handle_annotations(parts[1], q))
                        elif len(parts) == 4:
                            self._reply_read(
                                rp.handle_tile(parts[1], parts[3], q))
                        else:
                            self._reply_json(404, {"error": "not found"})
                    elif (parts := url.path.strip("/").split("/"))[0] == \
                            "jobs" and len(parts) == 3 and parts[2] == "trace":
                        q = parse_qs(url.query)
                        status, body = api._trace(
                            parts[1], raw=q.get("raw", ["0"])[0] not in
                            ("0", "", "false"))
                        self._reply_json(status, body)
                    elif parts[0] == "jobs" and len(parts) == 2:
                        # one record, partial preview included — the poll
                        # surface a live acquisition watches its
                        # provisional FDR ranking through
                        job = next((j for j in api.service.scheduler.jobs()
                                    if j["msg_id"] == parts[1]), None)
                        if job is None:
                            self._reply_json(404, {"error": "not found"})
                        else:
                            self._reply_json(200, job)
                    else:
                        self._reply_json(404, {"error": "not found"})
                except Exception as exc:  # noqa: BLE001
                    logger.error("admin-api: GET %s failed", self.path,
                                 exc_info=True)
                    self._reply_json(500, {"error": str(exc)})

            def do_POST(self):
                try:
                    path = urlparse(self.path).path
                    parts = path.strip("/").split("/")
                    if path == "/submit":
                        status, body, headers = api._submit(self._read_body())
                        self._reply_json(status, body, headers)
                    elif len(parts) == 3 and parts[0] == "datasets" \
                            and parts[1] and parts[2] == "pixels":
                        status, body, headers = api._stream_pixels(
                            parts[1], self._read_body())
                        self._reply_json(status, body, headers)
                    elif len(parts) == 3 and parts[0] == "datasets" \
                            and parts[1] and parts[2] == "finish":
                        status, body = api._stream_finish(parts[1])
                        self._reply_json(status, body)
                    else:
                        self._reply_json(404, {"error": "not found"})
                except Exception as exc:  # noqa: BLE001
                    logger.error("admin-api: POST %s failed", self.path,
                                 exc_info=True)
                    self._reply_json(500, {"error": str(exc)})

            def do_DELETE(self):
                try:
                    parts = urlparse(self.path).path.strip("/").split("/")
                    if len(parts) != 2 or parts[0] != "jobs":
                        self._reply_json(
                            404, {"error": "not found",
                                  "reason": "want DELETE /jobs/<msg_id>"})
                        return
                    if not parts[1]:
                        self._reply_json(400, {"error": "missing msg_id",
                                               "reason": "invalid_request"})
                        return
                    status, body = api._cancel(parts[1])
                    self._reply_json(status, body)
                except Exception as exc:  # noqa: BLE001
                    logger.error("admin-api: DELETE %s failed", self.path,
                                 exc_info=True)
                    self._reply_json(500, {"error": str(exc)})

            def _read_body(self) -> bytes:
                n = int(self.headers.get("Content-Length", 0) or 0)
                return self.rfile.read(n) if n else b""

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread: threading.Thread | None = None

    # --------------------------------------------------------------- routes
    def _healthz(self) -> tuple[dict, int]:
        svc = self.service
        stats = svc.scheduler.stats()
        body = {
            "status": "stopping" if stats["stopping"] else "ok",
            "uptime_s": round(time.time() - svc.started_at, 3),
            "workers": stats["workers"],
            "jobs": stats["states"],
            "queue": svc.queue_depths(),
        }
        adm = getattr(svc, "admission", None)
        if adm is not None:
            body["admission"] = adm.stats()
        return body, (503 if stats["stopping"] else 200)

    def _jobs(self, state: str | None) -> list[dict]:
        jobs = self.service.scheduler.jobs()
        if state:
            jobs = [j for j in jobs if j["state"] == state]
        return jobs

    def _submit(self, raw: bytes) -> tuple[int, dict, dict | None]:
        """Validate → admit → publish; returns (status, body, headers)."""
        svc = self.service
        try:
            msg = json.loads(raw or b"{}")
        except json.JSONDecodeError as exc:
            return 400, {"error": f"malformed JSON: {exc}",
                         "reason": "invalid_json"}, None
        errs = validate_submit(msg)
        if errs:
            return 400, {"error": "; ".join(errs),
                         "reason": "invalid_message"}, None
        if svc.stopping():
            return 503, {"error": "service is draining",
                         "reason": "stopping", "retry_after_s": 5.0}, \
                {"Retry-After": "5"}
        tenant = str(msg.get("tenant", "default"))
        adm = getattr(svc, "admission", None)
        decision = adm.try_admit(tenant) if adm is not None else None
        if decision is not None and not decision.accepted:
            # traceless flight-recorder event: the shed job never gets a
            # trace, but GET /debug/events still shows WHY it bounced
            tracing.event("admission.shed", reason=decision.body().get(
                "reason", ""), tenant=tenant, status=decision.status)
            return decision.status, decision.body(), \
                {"Retry-After": str(max(1, int(round(decision.retry_after_s))))}
        try:
            if msg.get("mode") == "stream" and not msg.get("input_path"):
                # the scheduler and the engine read the chunk log, never
                # this path; the sentinel satisfies the publisher's contract
                # and makes the dataset's provenance legible in the message
                msg["input_path"] = f"stream://{msg['ds_id']}"
            # deadline propagation: pin the ABSOLUTE deadline at submit time
            # so queueing delay counts against it end to end.  Stream jobs
            # are exempt: an acquisition has no known length, and their
            # liveness bound is service.stream.idle_timeout_s
            if "deadline_s" in msg and msg.get("mode") != "stream":
                service_block = dict(msg.get("service", {}))
                service_block.setdefault(
                    "deadline_at", time.time() + float(msg["deadline_s"]))
                msg["service"] = service_block
            # mint the job's trace HERE: the ids travel inside the
            # message, so the scheduler — this process or the one after a
            # crash — continues the same trace file end to end
            service_block = dict(msg.get("service", {}))
            trace = service_block.get("trace")
            if not (isinstance(trace, dict) and trace.get("trace_id")):
                trace = {"trace_id": tracing.new_id(),
                         "span": tracing.new_id(), "start": time.time()}
                service_block["trace"] = trace
                msg["service"] = service_block
            dst = svc.publisher.publish(msg)
        except (ValueError, OSError) as exc:
            if decision is not None:
                adm.abort(tenant)
            return 400, {"error": str(exc), "reason": "invalid_message"}, None
        if decision is not None:
            adm.confirm(dst.stem, tenant)
        trace_dir = getattr(svc, "trace_dir", None)
        ctx = tracing.TraceContext(
            trace_id=trace["trace_id"], span_id=trace["span"],
            job_id=dst.stem,
            file=str(tracing.trace_path(trace_dir, trace["trace_id"]))
            if trace_dir else "")
        tracing.event("submit", ctx=ctx, tenant=tenant,
                      ds_id=str(msg.get("ds_id", "")),
                      priority=str(msg.get("priority", "normal")))
        return 202, {"msg_id": dst.stem, "spooled": str(dst),
                     "trace_id": trace["trace_id"]}, None

    def _stream_pixels(self, ds_id: str,
                       raw: bytes) -> tuple[int, dict, dict | None]:
        """``POST /datasets/<id>/pixels``: append one spectra
        chunk to the dataset's crash-safe chunk log.  Body::

            {"seq": 0, "coords": [[x, y], ...],
             "mzs":  [[...], ...],  "ints": [[...], ...]}

        Idempotent by ``seq`` — a byte-identical retry (lost ack) gets a
        200 with ``duplicate: true``; a conflicting payload under the same
        seq gets a 409.  Out-of-order seqs are fine."""
        svc = self.service
        ingest = getattr(svc, "stream_ingest", None)
        if ingest is None:
            return 404, {"error": "streaming ingest not configured",
                         "reason": "not_found"}, None
        if svc.stopping():
            return 503, {"error": "service is draining",
                         "reason": "stopping", "retry_after_s": 5.0}, \
                {"Retry-After": "5"}
        try:
            body = json.loads(raw or b"{}")
        except json.JSONDecodeError as exc:
            return 400, {"error": f"malformed JSON: {exc}",
                         "reason": "invalid_json"}, None
        errs = []
        if not isinstance(body, dict):
            errs.append("body must be a JSON object")
        else:
            if not (isinstance(body.get("seq"), int)
                    and not isinstance(body.get("seq"), bool)
                    and body["seq"] >= 0):
                errs.append("'seq' must be a non-negative integer")
            for name in ("coords", "mzs", "ints"):
                if not isinstance(body.get(name), list):
                    errs.append(f"{name!r} must be a list")
            if not errs and not (len(body["coords"]) == len(body["mzs"])
                                 == len(body["ints"])):
                errs.append("'coords', 'mzs' and 'ints' must have one entry "
                            "per spectrum")
        if errs:
            return 400, {"error": "; ".join(errs),
                         "reason": "invalid_message"}, None
        from ..engine.stream import ChunkConflictError, StreamGapError
        from .resources import ResourceBudgetError

        try:
            out = ingest.append_chunk(
                ds_id, body["seq"], body["coords"],
                list(zip(body["mzs"], body["ints"])))
        except ChunkConflictError as exc:
            return 409, {"error": str(exc), "reason": "chunk_conflict"}, None
        except StreamGapError as exc:
            return 409, {"error": str(exc), "reason": "stream_finished"}, None
        except ResourceBudgetError as exc:
            return 507, {"error": str(exc), "reason": "disk_budget",
                         "retry_after_s": 5.0}, {"Retry-After": "5"}
        except ValueError as exc:
            return 400, {"error": str(exc), "reason": "invalid_message"}, None
        return 200, {"ds_id": ds_id, **out}, None

    def _stream_finish(self, ds_id: str) -> tuple[int, dict]:
        """``POST /datasets/<id>/finish``: seal the acquisition.  409 when
        the committed sequence has gaps; idempotent once sealed."""
        ingest = getattr(self.service, "stream_ingest", None)
        if ingest is None:
            return 404, {"error": "streaming ingest not configured",
                         "reason": "not_found"}
        from ..engine.stream import StreamEmptyError, StreamGapError

        try:
            out = ingest.finish(ds_id)
        except StreamEmptyError as exc:
            return 409, {"error": str(exc), "reason": "stream_empty"}
        except StreamGapError as exc:
            return 409, {"error": str(exc), "reason": "stream_gap"}
        return 200, {"ds_id": ds_id, **out}

    def _trace(self, msg_id: str, raw: bool = False) -> tuple[int, dict]:
        """``GET /jobs/<id>/trace``: resolve msg_id → trace_id (scheduler
        record first, then the message file in any spool state), read the
        per-job JSONL, return Chrome trace JSON (or raw records)."""
        svc = self.service
        trace_id = next((j["trace_id"] for j in svc.scheduler.jobs()
                         if j["msg_id"] == msg_id and j.get("trace_id")), "")
        if not trace_id:
            # not claimed yet (or a restarted service): the ids live in the
            # spool message itself
            root = svc.queue_dir / svc.queue
            for state in ("pending", "running", "done", "failed",
                          "quarantine"):
                p = root / state / f"{msg_id}.json"
                try:
                    msg = json.loads(p.read_text())
                    trace_id = str(msg.get("service", {})
                                   .get("trace", {}).get("trace_id", ""))
                    if trace_id:
                        break
                except (OSError, json.JSONDecodeError, AttributeError):
                    continue
        if not trace_id:
            return 404, {"error": f"no trace for job {msg_id!r}",
                         "reason": "not_found"}
        trace_dir = getattr(svc, "trace_dir", None)
        path = tracing.trace_path(trace_dir, trace_id) if trace_dir else None
        records = tracing.read_trace(path) if path else []
        if not records:
            return 404, {"error": f"trace file for {trace_id} is empty or "
                                  "missing", "reason": "not_found",
                         "trace_id": trace_id}
        if raw:
            return 200, {"trace_id": trace_id, "msg_id": msg_id,
                         "records": records}
        return 200, tracing.to_chrome_trace(records)

    def _timeseries(self, n: int | None) -> tuple[int, dict]:
        """``GET /debug/timeseries?n=`` — the telemetry monitor's snapshot
        ring (device memory, pool occupancy, queue depths, RSS); newest
        last."""
        mon = getattr(self.service, "telemetry", None)
        if mon is None:
            return 404, {"error": "telemetry monitor not configured",
                         "reason": "not_found"}
        samples = mon.timeseries(n)
        return 200, {
            "interval_s": mon.cfg.sample_interval_s,
            "capacity": mon.cfg.timeseries_len,
            "enabled": bool(self.service.sm_config.telemetry.enabled),
            "n": len(samples),
            "samples": samples,
        }

    def _devices(self) -> tuple[int, dict]:
        """``GET /debug/devices`` — the device pool's chip-level
        view: per-chip health (``ok``/``suspect``/``quarantined`` with
        fault strikes, quarantine reason and timestamp), current lease
        holders, per-host occupancy, probe/quarantine/readmit/eviction
        totals (``service/health.py``), and the circuit breaker's state
        (``models/breaker.py``)."""
        pool = getattr(self.service, "device_pool", None)
        if pool is None:
            return 404, {"error": "device pool not configured",
                         "reason": "not_found"}
        from ..models.breaker import breakers_snapshot

        return 200, {**pool.snapshot(), "breakers": breakers_snapshot()}

    def _resources(self) -> tuple[int, dict]:
        """``GET /debug/resources`` — the resource governor's snapshot
       : degrade level, headroom, per-seam denials, GC stats,
        and the OOM safe-batch registry (service/resources.py)."""
        governor = getattr(self.service, "resources", None)
        if governor is None:
            return 404, {"error": "resource governor not configured",
                         "reason": "not_found"}
        return 200, governor.snapshot()

    def _compile(self) -> tuple[int, dict]:
        """``GET /debug/compile``: the cold-start view — every recorded
        shape bucket with its primed/missing status (service/primer.py),
        plus the kernel build census (kernels/_build.py), so
        primed-but-never-built and built-but-never-primed kernels are both
        visible from one endpoint.  With ``telemetry.retrace`` false the
        census half is ``{"enabled": false}``."""
        from ..kernels import _build

        primer = getattr(self.service, "primer", None)
        builds = ({"enabled": True, **_build.census()}
                  if self.service.sm_config.telemetry.retrace
                  else {"enabled": False})
        return 200, {
            "primer": (primer.snapshot() if primer is not None else None),
            "builds": builds,
        }

    def _fleet_metrics(self) -> tuple[int, str]:
        """``GET /fleet/metrics`` — every live replica's exposition merged
        into one: counters summed, gauges re-labelled ``{replica=}``,
        histograms bucket-merged.  Peer failures degrade to a partial view
        with evidence comments, never an error."""
        fv = getattr(self.service, "fleetview", None)
        if fv is None:
            return 404, "# fleetview not configured (service.fleetview)\n"
        return 200, fv.metrics_text()

    def _fleet_slo(self) -> tuple[int, dict]:
        """``GET /fleet/slo`` — fleet-wide attainment / error-budget burn
        for the five SLIs, computed from the merged histogram buckets."""
        fv = getattr(self.service, "fleetview", None)
        if fv is None:
            return 404, {"error": "fleetview not configured",
                         "reason": "not_found"}
        return fv.slo()

    def _fleet_status(self) -> tuple[int, dict]:
        """``GET /fleet/status`` — replicas, hosts, evictions, pool
        occupancy, in-flight stream acquisitions, scrape evidence."""
        fv = getattr(self.service, "fleetview", None)
        if fv is None:
            return 404, {"error": "fleetview not configured",
                         "reason": "not_found"}
        return fv.status()

    def _profile(self, seconds: float | None) -> tuple[int, dict]:
        """``GET /debug/profile?seconds=`` — single-flight
        ``torch.profiler`` capture around in-flight work: per-kernel device
        time attribution + ``device_kernel`` span injection into running
        jobs' traces.  409 while another capture runs."""
        prof = getattr(self.service, "profiler", None)
        if prof is None:
            return 404, {"error": "device profiler not configured",
                         "reason": "not_found"}
        return prof.run(seconds)

    def _peers(self) -> dict:
        """``GET /peers`` — the replica registry view: this
        replica's identity/shards plus every peer's last heartbeat, shard
        ownership, and gossiped admission summary.  Replicas poll each
        other's registries through the shared spool; this endpoint gives
        operators (and cross-node pollers) the same picture over HTTP."""
        return self.service.scheduler.peers()

    def _slo(self) -> tuple[int, dict]:
        """``GET /slo`` — objective / attainment / error-budget burn per
        SLI, computed from the live histograms (service/telemetry.py)."""
        slo = getattr(self.service, "slo", None)
        if slo is None:
            return 404, {"error": "SLO tracker not configured",
                         "reason": "not_found"}
        return 200, slo.report()

    def _cancel(self, msg_id: str) -> tuple[int, dict]:
        disposition = self.service.scheduler.cancel(msg_id)
        status = {"cancelling": 202, "cancelled": 200,
                  "terminal": 409, "not_found": 404}[disposition]
        body = {"msg_id": msg_id, "state": disposition}
        if disposition == "terminal":
            body["error"] = "job already reached a terminal state"
        elif disposition == "not_found":
            body["error"] = "unknown msg_id"
        return status, body

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name="admin-api")
        self._thread.start()
        logger.info("admin-api: listening on http://%s:%d", *self.address)

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
