"""Scheduler REST API.

Reference analog: the warp routes (``scheduler/src/api/mod.rs:85-138`` +
``handlers.rs``): ``/api/state``, ``/api/executors``, ``/api/jobs``,
``/api/job/{id}`` (GET; PATCH cancels), ``/api/metrics`` (Prometheus text),
``/api/stages/{job_id}``; plus the flight-recorder surfaces
(docs/metrics.md): ``/api/timeseries`` (bounded gauge rings) and
``/api/profile?seconds=N`` (collapsed flamegraph stacks from the
self-profiler); ``/api/dot``, ``/api/dot_stage`` (Graphviz), ``/api/trace``
(Perfetto JSON of a job's spans), ``/api/trace_spans``, ``/api/scale`` and
``PATCH /api/scale/drain/{executor}`` (a drain-safe scale-down).

The port's copy of the JAX package's ``scheduler/api.py``, route for route.
``/api/executors`` adds each executor's ``device_kind``.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


def start_api_server(scheduler, host: str, port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: str, ctype="application/json"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            parts = [p for p in self.path.split("?")[0].split("/") if p]
            if not parts or parts == ["ui"]:
                from ballista_tpu_torch.scheduler.ui import UI_HTML

                self._send(200, UI_HTML, ctype="text/html")
            elif parts[:2] == ["api", "state"] and len(parts) == 2:
                self._send(200, json.dumps({
                    "started": scheduler.scheduler_id,
                    "version": _version(),
                    # locked count: the live registry races register/
                    # heartbeat mutation (concurrency-verifier finding)
                    "executors": scheduler.cluster.executor_count(),
                    "active_jobs": len(scheduler.tasks.active_jobs()),
                }))
            elif parts[:2] == ["api", "executors"]:
                self._send(200, json.dumps([
                    {
                        "executor_id": e.executor_id, "host": e.host, "port": e.port,
                        "flight_port": e.flight_port, "task_slots": e.task_slots,
                        "free_slots": e.free_slots, "status": e.status,
                        # the device the executor registered: a torch
                        # executor's card name ("" for a host engine)
                        "device_kind": e.device_kind,
                        # drain-safe scale-down (docs/elasticity.md)
                        "draining": e.draining,
                        "drain_deadline": e.drain_deadline,
                        "last_seen_ts": e.last_seen,
                        # quarantine state machine (docs/fault_tolerance.md):
                        # active | quarantined | probation
                        "quarantine_state": scheduler.cluster.quarantine_state(
                            e.executor_id
                        ),
                        "quarantined_until": e.quarantined_until,
                        # remaining cooloff computed SERVER-side: the UI must
                        # not mix the browser clock with a scheduler epoch
                        "quarantine_remaining_s": max(
                            0.0, round(e.quarantined_until - _now(), 1)
                        ),
                        "consecutive_failures": e.consecutive_failures,
                        "failures_total": e.failures_total,
                    }
                    for e in scheduler.cluster.executors_snapshot()
                ]))
            elif parts[:2] == ["api", "jobs"]:
                # summaries built UNDER the task-manager lock: a live graph's
                # stage map mutates on the status path while this handler
                # thread iterates (concurrency-verifier finding)
                with scheduler.tasks._lock:
                    payload = [
                        g.to_summary() for g in scheduler.tasks.all_jobs()
                    ]
                self._send(200, json.dumps(payload))
            elif parts[:2] == ["api", "job"] and len(parts) == 3:
                with scheduler.tasks._lock:
                    g = scheduler.tasks.get_job(parts[2])
                    summary = None if g is None else g.to_summary()
                if summary is None:
                    self._send(404, json.dumps({"error": "not found"}))
                else:
                    self._send(200, json.dumps(summary))
            elif parts[:2] == ["api", "stages"] and len(parts) == 3:
                g = scheduler.tasks.get_job(parts[2])
                if g is None:
                    self._send(404, json.dumps({"error": "not found"}))
                else:
                    # per-stage drill-down payload (reference: the React UI's
                    # per-query stage views, scheduler/ui/src/components/),
                    # built under the task-manager lock (see /api/jobs)
                    with scheduler.tasks._lock:
                        payload = json.dumps({
                        str(sid): {
                            "state": s.state,
                            "attempt": s.attempt,
                            "partitions": s.partitions,
                            "completed": sum(
                                1 for t in s.task_infos
                                if t is not None and t.status == "success"
                            ),
                            "running": sum(
                                1 for t in s.task_infos
                                if t is not None and t.status == "running"
                            ),
                            "task_failures": sum(s.task_failures),
                            # snapshot first: the scheduler thread inserts
                            # metric keys while this handler thread iterates
                            "metrics": {
                                k: round(v, 6)
                                for k, v in dict(s.stage_metrics).items()
                            },
                            "plan": repr(s.resolved_plan or s.plan),
                        }
                        for sid, s in g.stages.items()
                    })
                    self._send(200, payload)
            elif parts[:2] == ["api", "dot"] and len(parts) == 3:
                from ballista_tpu_torch.scheduler.graph_dot import graph_to_dot

                with scheduler.tasks._lock:
                    g = scheduler.tasks.get_job(parts[2])
                    dot = None if g is None else graph_to_dot(g)
                if dot is None:
                    self._send(404, json.dumps({"error": "not found"}))
                else:
                    self._send(200, dot, ctype="text/vnd.graphviz")
            elif parts[:2] == ["api", "dot_stage"] and len(parts) == 4:
                from ballista_tpu_torch.scheduler.graph_dot import stage_to_dot

                with scheduler.tasks._lock:
                    g = scheduler.tasks.get_job(parts[2])
                    dot = (
                        None
                        if g is None or int(parts[3]) not in g.stages
                        else stage_to_dot(g, int(parts[3]))
                    )
                if dot is None:
                    self._send(404, json.dumps({"error": "not found"}))
                else:
                    self._send(200, dot, ctype="text/vnd.graphviz")
            elif parts[:2] == ["api", "trace"] and len(parts) == 3:
                # Chrome/Perfetto trace_event JSON — open in ui.perfetto.dev.
                # Flight-recorder gauge rings ride along as counter tracks
                # (queue depth, running tasks, cache hit rates) clipped to
                # the span window, so the timeline shows cluster state
                # UNDER the query, not just the query itself.
                from ballista_tpu_torch.obs.perfetto import to_trace_events

                spans = scheduler.traces.get(parts[2])
                if not spans and scheduler.tasks.get_job(parts[2]) is None:
                    self._send(404, json.dumps({"error": "not found"}))
                else:
                    counters = scheduler.recorder.timeseries_json()["series"]
                    self._send(
                        200, json.dumps(to_trace_events(spans, counters))
                    )
            elif parts[:2] == ["api", "trace_spans"] and len(parts) == 3:
                # raw span dicts (the GetTrace RPC's payload, for tooling)
                spans = scheduler.traces.get(parts[2])
                if not spans and scheduler.tasks.get_job(parts[2]) is None:
                    self._send(404, json.dumps({"error": "not found"}))
                else:
                    self._send(200, json.dumps(spans))
            elif parts[:2] == ["api", "scale"]:
                # elastic executors (docs/elasticity.md): the backlog/
                # occupancy signal + controller policy state + per-executor
                # drain progress
                from ballista_tpu_torch.scheduler.scale import signal_dict

                self._send(200, json.dumps({
                    "signal": signal_dict(scheduler.scale.signal()),
                    "controller": scheduler.scale.stats(),
                    "draining": [
                        {
                            "executor_id": e.executor_id,
                            "drain_started_at": e.drain_started_at,
                            "drain_deadline": e.drain_deadline,
                            "running_tasks": scheduler.tasks.running_tasks_on(
                                e.executor_id
                            ),
                            "output_referenced": (
                                scheduler.tasks.executor_output_referenced(
                                    e.executor_id
                                )
                            ),
                        }
                        for e in scheduler.cluster.draining_executors()
                    ],
                }))
            elif parts[:2] == ["api", "serving"]:
                # serving-layer counters (docs/serving.md): plan-cache hit/
                # miss/evictions, admission queue depth, per-tenant running
                # slots (quarantine-adjusted) + offered-task totals
                self._send(200, json.dumps(scheduler.serving_stats()))
            elif parts[:2] == ["api", "metrics"]:
                # ONE conformant exposition (obs.metrics.PromText): every
                # family gets # HELP/# TYPE, every label value routes
                # through escape_label_value, histograms render with
                # cumulative _bucket/_sum/_count
                from ballista_tpu_torch.obs.ledger import ledger_prometheus
                from ballista_tpu_torch.obs.metrics import PromText
                from ballista_tpu_torch.scheduler.scale import scale_render_into

                out = PromText()
                scheduler.metrics.render_into(
                    out, scheduler.tasks.pending_tasks()
                )
                _serving_prometheus(out, scheduler.serving_stats())
                _pipeline_prometheus(out, scheduler)
                _megastage_prometheus(out, scheduler)
                scale_render_into(
                    out, scheduler.scale.signal(), scheduler.scale.stats()
                )
                _executor_prometheus(out, scheduler)
                _trace_store_prometheus(out, scheduler)
                with scheduler._tenant_ledger_lock:
                    tenants = {
                        t: dict(a) for t, a in scheduler.tenant_ledgers.items()
                    }
                ledger_prometheus(out, tenants)
                scheduler.recorder.render_into(out)
                self._send(200, out.text(), ctype="text/plain")
            elif parts[:2] == ["api", "timeseries"]:
                # bounded gauge rings (docs/metrics.md): sampled queue depth,
                # running tasks, cache hit rates for the UI; ?window_s=N
                # narrows the window (default: everything retained, ~1h)
                qs = parse_qs(urlparse(self.path).query)
                try:
                    window = float(qs.get("window_s", ["3600"])[0])
                except ValueError:
                    window = 3600.0
                self._send(
                    200, json.dumps(scheduler.recorder.timeseries_json(window))
                )
            elif parts[:2] == ["api", "profile"]:
                # collapsed-flamegraph text from the self-profiler
                # (docs/metrics.md). With ballista.obs.profiler on, serves
                # the continuous profiler's aggregate; otherwise runs a
                # one-shot sample for ?seconds=N (default 5, capped at 60)
                # on this handler thread (ThreadingHTTPServer: one thread
                # per request, so blocking here stalls nobody else).
                qs = parse_qs(urlparse(self.path).query)
                try:
                    seconds = float(qs.get("seconds", ["5"])[0])
                except ValueError:
                    seconds = 5.0
                if scheduler.profiler.running:
                    text = scheduler.profiler.collapsed()
                else:
                    from ballista_tpu_torch.obs.profiler import profile_for

                    text = profile_for(
                        max(0.1, min(60.0, seconds)),
                        hz=scheduler.config.obs_profiler_hz,
                    )
                self._send(200, text, ctype="text/plain")
            else:
                self._send(404, json.dumps({"error": "unknown route"}))

        def do_PATCH(self):
            parts = [p for p in self.path.split("/") if p]
            if parts[:3] == ["api", "scale", "drain"] and len(parts) == 4:
                # operator-initiated drain-safe scale-down of one executor
                # (docs/elasticity.md); the scale controller's state machine
                # finishes it once tasks + shuffle readers are done
                ok = scheduler.drain_executor(parts[3])
                self._send(200 if ok else 404, json.dumps({"draining": ok}))
            elif parts[:2] == ["api", "job"] and len(parts) == 3:
                # route through the RPC handler: it also cancels jobs still
                # queued in admission or mid-planning (docs/serving.md)
                from ballista_tpu_torch.proto import ballista_pb2 as pb

                ok = scheduler.cancel_job(
                    pb.CancelJobParams(job_id=parts[2]), None
                ).cancelled
                self._send(200, json.dumps({"cancelled": ok}))
            else:
                self._send(404, json.dumps({"error": "unknown route"}))

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True, name="rest-api").start()
    return server


def _serving_prometheus(out, stats: dict) -> None:
    """Serving counters on the shared exposition builder (docs/serving.md).
    Tenant labels are CLIENT-controlled; PromText routes every label value
    through obs.metrics.escape_label_value."""
    pc, adm = stats["plan_cache"], stats["admission"]
    xc = stats.get("exchange_cache", {})
    counters = [
        ("plan_cache_hits_total", pc["hits"], "Plan cache hits"),
        ("plan_cache_misses_total", pc["misses"], "Plan cache misses"),
        ("plan_cache_evictions_total", pc["evictions"], "Plan cache evictions"),
        # cross-query exchange cache (docs/serving.md)
        ("exchange_cache_hits_total", xc.get("hits", 0), "Exchange cache hits"),
        (
            "exchange_cache_misses_total", xc.get("misses", 0),
            "Exchange cache misses",
        ),
        (
            "exchange_cache_evictions_total", xc.get("evictions", 0),
            "Exchange cache evictions",
        ),
        (
            "exchange_cache_invalidations_total", xc.get("invalidations", 0),
            "Exchange cache entries invalidated by staleness",
        ),
        (
            "exchange_cache_tasks_skipped_total", xc.get("tasks_skipped", 0),
            "Producer tasks skipped via cache adoption",
        ),
        (
            "admission_rejected_total", adm["rejected_total"],
            "Submissions rejected at the admission queue bound",
        ),
        (
            "admission_cancelled_queued_total", adm["cancelled_queued_total"],
            "Jobs cancelled while queued in admission",
        ),
    ]
    for name, value, help_text in counters:
        out.counter(name, value, help_text)
    gauges = [
        ("plan_cache_entries", pc["entries"], "Plan cache resident entries"),
        (
            "exchange_cache_entries", xc.get("entries", 0),
            "Exchange cache resident entries",
        ),
        (
            "exchange_cache_bytes", xc.get("bytes", 0),
            "Exchange cache resident bytes",
        ),
        (
            "exchange_cache_pinned_jobs", xc.get("pinned_jobs", 0),
            "Producer jobs pinned by cache entries",
        ),
        ("admission_queue_depth", adm["queue_depth"], "Jobs queued in admission"),
        (
            "admission_running_jobs", adm["running_jobs"],
            "Jobs counted against the admission cap",
        ),
    ]
    for name, value, help_text in gauges:
        out.gauge(name, value, help_text)
    out.family(
        "tenant_running_slots", "gauge",
        "Quarantine-adjusted running task slots per tenant",
    )
    out.family(
        "tenant_offered_tasks_total", "counter",
        "Tasks offered per tenant by the fair-share scheduler",
    )
    for tenant, t in stats["tenants"].items():
        out.sample(
            "tenant_running_slots", t["running_slots"], {"tenant": tenant}
        )
        out.sample(
            "tenant_offered_tasks_total", t["offered_tasks"], {"tenant": tenant}
        )


def _pipeline_prometheus(out, scheduler) -> None:
    """Pipelined-shuffle counters (docs/shuffle.md) summed over all jobs."""
    p = scheduler.tasks.pipeline_stats()
    out.counter(
        "pipeline_early_resolved_stages_total", p["early_resolved"],
        "Consumer stages early-resolved by pipelined shuffle",
    )
    out.counter(
        "pipeline_hbm_fallbacks_total", p["hbm_fallbacks"],
        "Pipelined stages pinned to barrier semantics by the HBM governor",
    )
    out.counter(
        "pipeline_deadline_fallbacks_total", p["deadline_fallbacks"],
        "Pipelined stages pinned to barrier semantics by piece deadlines",
    )


def _megastage_prometheus(out, scheduler) -> None:
    """Megastage compiler counters (docs/megastage.md) summed over all jobs."""
    m = scheduler.tasks.megastage_stats()
    out.counter(
        "megastage_promoted_queries_total", m["promoted"],
        "Query chains collapsed into a single compiled mesh program",
    )
    out.counter(
        "megastage_demotions_total", m["demoted"],
        "Megastages demoted back onto the per-stage split at runtime",
    )


def _executor_prometheus(out, scheduler) -> None:
    """Per-executor counters harvested from heartbeat metrics — today the
    orphaned-shuffle sweeper's reclaimed bytes (docs/fault_tolerance.md)."""
    out.family(
        "executor_shuffle_reclaimed_bytes", "counter",
        "Orphaned shuffle bytes reclaimed, per executor",
    )
    total = 0.0
    for e in scheduler.cluster.executors_snapshot():
        v = float(e.metrics.get("shuffle_reclaimed_bytes", 0.0) or 0.0)
        total += v
        out.sample(
            "executor_shuffle_reclaimed_bytes", int(v),
            {"executor": e.executor_id},
        )
    out.counter(
        "shuffle_reclaimed_bytes_total", int(total),
        "Orphaned shuffle bytes reclaimed, cluster-wide",
    )


def _trace_store_prometheus(out, scheduler) -> None:
    """TraceStore retention accounting (docs/metrics.md): resident jobs,
    spans, approximate bytes, and the evictions the LRU/byte-budget made."""
    s = scheduler.traces.stats()
    out.gauge("trace_store_jobs", s["jobs"], "Job traces retained")
    out.gauge("trace_store_spans", s["spans"], "Spans retained across all jobs")
    out.gauge(
        "trace_store_bytes", s["approx_bytes"],
        "Approximate retained trace bytes",
    )
    out.counter(
        "trace_store_evicted_jobs_total", s["evicted_jobs"],
        "Job traces evicted by the LRU or byte budget",
    )
    out.counter(
        "trace_store_evicted_spans_total", s["evicted_spans"],
        "Spans evicted with their jobs or by per-job ring caps",
    )


def _now() -> float:
    import time

    return time.time()


def _version() -> str:
    from ballista_tpu_torch import __version__

    return __version__
