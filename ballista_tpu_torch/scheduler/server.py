"""SchedulerServer: gRPC service + state + background loops.

Reference analog: ``SchedulerServer`` / ``SchedulerGrpc`` impl /
``QueryStageScheduler`` (``arrow-ballista: ballista/scheduler/src/
scheduler_server/{mod.rs,grpc.rs,query_stage_scheduler.rs}``):

* pull mode: ``PollWork`` saves executor metadata, applies task statuses,
  binds tasks to the polling executor's free slots inline (grpc.rs:63-152)
* push mode: task updates post ``ReviveOffers``; the scheduler reserves slots
  and pushes ``LaunchMultiTask`` to executors (state/mod.rs:158-332)
* planning happens off the RPC thread (query_stage_scheduler.rs:101 spawn)
* dead-executor expiry loop every 15s, 180s timeout (mod.rs:215-272)

Cluster state is in memory (``cluster_backend="memory"``) or durable:
``kv`` (a sqlite file that an HA pair shares), ``grpc-kv`` (the networked
``KvServer`` of ``scheduler/kv_service.py``) or ``etcd`` (etcd v3, served by
the ``KvServer``'s gateway or a stock etcd). With a durable backend every job
graph is persisted, the submitting scheduler holds a renewed lease on its
jobs, and a standby adopts a RUNNING job whose lease lapsed
(``_renew_and_take_over_jobs``). The KEDA external scaler
(``scheduler/external_scaler.py``) shares the scheduler's port. The elastic
scale controller (``scheduler/scale.py``) is ticked from the expiry loop, and
``drain_executor`` starts a drain-safe scale-down of one executor.
Mesh-group gang scheduling (``_revive_gang_stages``) binds a stage whose
collectives ``torch_engine.gang_collectives`` finds onto a complete group of
torch executor processes (``parallel/multihost.py``) in one push-mode launch
batch; a member's failure restarts the stage whole, and a ``GANG_UNFUSABLE``
failure restarts it un-ganged. Under a durable backend a group is claimed
through a cross-scheduler lease first (``_claim_gang_group``), so a standby
never gang-launches onto a group whose last attempt may still be entering
its program.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import grpc

from ballista_tpu_torch.analysis import concurrency
from ballista_tpu_torch.analysis.plan_verifier import PlanVerificationError
from ballista_tpu_torch.client.catalog import Catalog, TableMeta
from ballista_tpu_torch.config import BallistaConfig, SchedulerConfig
from ballista_tpu_torch.errors import BallistaError, SchedulerError
from ballista_tpu_torch.utils.retry import RetryPolicy, call_with_retry
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
from ballista_tpu_torch.plan.serde import (
    decode_logical, decode_physical, encode_physical, schema_to_json,
)
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.proto.rpc import (
    EXECUTOR_METHODS, GRPC_OPTIONS, SCHEDULER_METHODS, SCHEDULER_SERVICE,
    add_service, executor_stub,
)
from ballista_tpu_torch.scheduler.cluster import ExecutorInfo, InMemoryClusterState
from ballista_tpu_torch.scheduler.execution_graph import (
    CANCELLED, ExecutionGraph, FAILED, RUNNING, SUCCESSFUL, TaskDescriptor,
)
from ballista_tpu_torch.scheduler.task_manager import TaskManager, generate_job_id

log = logging.getLogger("ballista.scheduler")


def _schema_digest_json(schema) -> str:
    """Canonical JSON of an exchanged schema — what an exchange-cache entry
    stores and PV008 compares against the consumer's expectation."""
    return json.dumps(schema_to_json(schema), sort_keys=True)


class SchedulerMetrics:
    """Reference: metrics/prometheus.rs — same series names."""

    def __init__(self):
        self.job_submitted_total = 0
        self.job_completed_total = 0
        self.job_failed_total = 0
        self.job_cancelled_total = 0
        self.planning_time_ms_sum = 0.0
        self.job_exec_time_seconds_sum = 0.0

    def render_into(self, out, pending: int) -> None:
        out.counter(
            "job_submitted_total", self.job_submitted_total,
            "Jobs accepted for execution",
        )
        out.counter(
            "job_completed_total", self.job_completed_total,
            "Jobs that reached SUCCESSFUL",
        )
        out.counter(
            "job_failed_total", self.job_failed_total, "Jobs that reached FAILED"
        )
        out.counter(
            "job_cancelled_total", self.job_cancelled_total,
            "Jobs cancelled by the client",
        )
        out.counter(
            "planning_time_ms_sum", self.planning_time_ms_sum,
            "Total parse/plan/govern/verify milliseconds",
        )
        out.counter(
            "job_exec_time_seconds_sum", self.job_exec_time_seconds_sum,
            "Total completed-job wall seconds",
        )
        out.gauge(
            "pending_task_queue_size", pending,
            "Runnable task slots awaiting an executor offer",
        )

    def prometheus_text(self, pending: int) -> str:
        from ballista_tpu_torch.obs.metrics import PromText

        out = PromText()
        self.render_into(out, pending)
        return out.text()


class SchedulerServer:
    def __init__(self, config: Optional[SchedulerConfig] = None):
        from ballista_tpu_torch.obs.tracing import TraceStore
        from ballista_tpu_torch.utils import faults

        faults.install_from_env()
        self.config = config or SchedulerConfig()
        # liveness + quarantine policy threaded from the process config so
        # every alive/expired call site sees the SAME timeout (previously
        # reserve_slots/consistent-hash binding silently used a 180s default
        # independent of executor_timeout_seconds)
        self.cluster = InMemoryClusterState(
            self.config.task_distribution,
            executor_timeout_s=self.config.executor_timeout_seconds,
            terminating_grace_s=self.config.executor_termination_grace_period,
            quarantine_threshold=self.config.quarantine_failure_threshold,
            quarantine_cooloff_s=self.config.quarantine_cooloff_seconds,
        )
        self.traces = TraceStore(
            max_jobs=self.config.trace_max_jobs,
            max_bytes=self.config.trace_max_bytes,
        )
        # flight recorder (docs/metrics.md): histogram metrics over the
        # control-plane hot paths + gauge time series; disabled it no-ops
        # every observation (the obs_bench overhead baseline)
        from ballista_tpu_torch.obs.metrics import FlightRecorder
        from ballista_tpu_torch.obs.profiler import SamplingProfiler

        self.recorder = FlightRecorder(enabled=self.config.obs_recorder_enabled)
        # per-named-lock contention histograms (docs/static_analysis.md):
        # when the concurrency verifier is tracing locks, its wait/hold
        # timings land on /api/metrics next to the other control-plane
        # histograms. Values arrive in seconds; exported in milliseconds.
        if self.recorder.enabled:
            from ballista_tpu_torch.analysis import concurrency as _cc

            _cc.set_metrics_sink(
                lambda kind, name, s, _r=self.recorder: _r.observe(
                    f"ballista_lock_{kind}_ms", s * 1000.0, {"lock": name}
                )
            )
        # self-profiler: built always (one-shot /api/profile works on
        # demand), continuous background sampling only when the knob is on
        self.profiler = SamplingProfiler(hz=self.config.obs_profiler_hz)
        # per-tenant ledger aggregates (obs.ledger.accumulate_tenant) — fed
        # at job completion, rendered on /api/metrics
        self.tenant_ledgers: dict[str, dict] = {}
        self._tenant_ledger_lock = concurrency.make_lock(
            "SchedulerServer._tenant_ledger_lock"
        )
        # weighted fair-share task offers consult quarantine (docs/serving.md):
        # tasks stranded on a quarantined executor don't consume their
        # tenant's slot quota
        self.tasks = TaskManager(
            trace_store=self.traces,
            quarantine_state=self.cluster.quarantine_state,
            recorder=self.recorder,
        )
        self.sessions: dict[str, dict[str, str]] = {}
        self.metrics = SchedulerMetrics()
        # serving layer (docs/serving.md): plan cache (repeat statements skip
        # parse/plan/analyze/govern/verify) + admission gate (bounded queue
        # with backpressure; 0-cap default = gate off, zero behavior change)
        from ballista_tpu_torch.scheduler.serving import (
            AdmissionController,
            ExchangeCache,
            PlanCache,
        )

        self.plan_cache = PlanCache(self.config.plan_cache_entries)
        # cross-query exchange materialization cache (docs/serving.md):
        # sealed shuffle outputs of hash-exchange producer stages, recycled
        # across jobs. The unpin callback runs the producer job's DEFERRED
        # shuffle-dir cleanup once its last entry is evicted/invalidated.
        self.exchange_cache = ExchangeCache(
            self.config.exchange_cache_bytes,
            self.config.exchange_cache_ttl_seconds,
            on_unpin=self._on_exchange_unpin,
        )
        # consumer job -> exchange-cache ENTRIES it leased at adoption
        # (entry objects, not keys: a key may meanwhile name a replacement
        # entry); released on every job exit path (finish/fail/cancel/HA)
        self._exchange_refs: dict[str, list] = {}
        # producer jobs whose clean-job-data fan-out was deferred by a pin
        self._deferred_cleans: set[str] = set()
        self._exchange_lock = concurrency.make_lock("SchedulerServer._exchange_lock")
        # admission cap default-on (docs/serving.md): 0 = AUTO — the cap is
        # derived from live capacity (schedulable task slots) at every
        # submit/release, so scale events re-evaluate it for free; gate
        # transparent while no executor is registered. >0 fixed; <0 off.
        self.admission = AdmissionController(
            self.config.serving_max_concurrent_jobs,
            self.config.serving_admission_queue_limit,
            capacity_fn=(
                self.cluster.total_task_slots
                if self.config.serving_max_concurrent_jobs == 0
                else None
            ),
        )
        # elastic executors (docs/elasticity.md): backlog signal + scale
        # controller (passive unless ballista.scale.max_executors > 0),
        # ticked from the expiry loop; the drain state machine runs in it
        from ballista_tpu_torch.scheduler.scale import ScaleController

        self.scale = ScaleController(self, self.config.scale_settings)
        # jobs cancelled between dispatch and submit_job (client timeout on a
        # job still planning); checked under _cancel_lock so a cancel can
        # never race the planner's submit into an orphaned running job
        self._cancelled_jobs: set[str] = set()
        self._cancel_lock = concurrency.make_lock("SchedulerServer._cancel_lock")
        self.scheduler_id = f"sched-{uuid.uuid4().hex[:8]}"
        self._planner_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="planner")
        self._push_pool = ThreadPoolExecutor(max_workers=8, thread_name_prefix="launcher")
        # revive_offers runs on the push pool from several triggers; binding is
        # check-then-set, so the whole offer/bind/launch pass must be exclusive
        # (and gang binding must never interleave with normal binding)
        self._revive_lock = concurrency.make_lock("SchedulerServer._revive_lock")
        # at most ONE gang stage in flight per mesh group: concurrent
        # collective programs would enter in different orders on different
        # processes (XLA requires identical launch order cluster-wide)
        self._gang_inflight: dict[str, tuple[str, int, int]] = {}
        # pre-plan / terminal-without-graph job states (QUEUED while planning
        # or in admission; FAILED/CANCELLED for jobs that never got a graph).
        # BOUNDED: under sustained overload every admission rejection writes
        # a FAILED entry and no graph ever pops it — _set_override trims the
        # oldest TERMINAL entries past the cap (clients poll these briefly;
        # an evicted one reads as NOT_FOUND, same as any long-gone job)
        # guarded by _cancel_lock: planner threads, cancel RPCs and status
        # RPCs all touch this map concurrently
        self._job_overrides = concurrency.guarded_dict(
            "SchedulerServer._job_overrides", self._cancel_lock
        )
        self._job_overrides_cap = 4096
        self._executor_stubs: dict[str, object] = {}
        self._server: Optional[grpc.Server] = None
        self._stop = threading.Event()
        self.port: Optional[int] = None
        # optional durable job state (reference: sled/etcd-backed JobState)
        self.state_store = None
        if self.config.cluster_backend not in ("memory", "kv", "grpc-kv", "etcd"):
            raise BallistaError(
                f"unknown cluster_backend={self.config.cluster_backend!r}: "
                "expected memory, kv, grpc-kv or etcd"
            )
        if self.config.cluster_backend == "kv":
            from ballista_tpu_torch.scheduler.state_store import JobStateStore, SqliteKV

            path = self.config.kv_path or os.path.join(
                tempfile.gettempdir(), "ballista-tpu-state.db")
            self.state_store = JobStateStore(SqliteKV(path), self.scheduler_id)
            self._restore_jobs()
            self._restore_exchange_cache()
        elif self.config.cluster_backend in ("grpc-kv", "etcd"):
            # networked etcd tier: schedulers on different machines share
            # ONLY this address (cluster/storage/etcd.rs:37; push watches).
            # "grpc-kv" speaks the native wire to the built-in KvServer;
            # "etcd" speaks etcd v3 — to the KvServer's EtcdGateway or to a
            # STOCK etcd at the same address (the conformance seam)
            from ballista_tpu_torch.scheduler.etcd_gateway import EtcdKV
            from ballista_tpu_torch.scheduler.kv_service import GrpcKV
            from ballista_tpu_torch.scheduler.state_store import JobStateStore

            client_cls, default_addr = {
                "grpc-kv": (GrpcKV, "localhost:50070"),
                "etcd": (EtcdKV, "localhost:2379"),
            }[self.config.cluster_backend]
            addr = self.config.kv_addr or default_addr
            self.state_store = JobStateStore(client_cls(addr), self.scheduler_id)
            self._restore_jobs()
            self._restore_exchange_cache()

    # ---- lifecycle -----------------------------------------------------------------
    def start(self, port: Optional[int] = None) -> int:
        server = grpc.server(
            ThreadPoolExecutor(max_workers=16, thread_name_prefix="grpc"),
            options=GRPC_OPTIONS,
        )
        add_service(server, SCHEDULER_SERVICE, SCHEDULER_METHODS, self)
        # KEDA autoscale signal multiplexed on the same port (reference:
        # scheduler_process.rs single-port multiplexing)
        from ballista_tpu_torch.scheduler.external_scaler import add_external_scaler

        add_external_scaler(server, self)
        bind = f"{self.config.bind_host}:{port if port is not None else self.config.bind_port}"
        self.port = server.add_insecure_port(bind)
        server.start()
        self._server = server
        from ballista_tpu_torch.scheduler.query_stage_scheduler import QueryStageScheduler

        self.events = QueryStageScheduler(
            self, self.config.finished_job_data_clean_up_interval_seconds
        )
        self.events.start()
        threading.Thread(target=self._expiry_loop, daemon=True, name="expiry").start()
        self._start_recorder()
        log.info("scheduler %s listening on %s", self.scheduler_id, self.port)
        return self.port

    def _start_recorder(self) -> None:
        """Register the flight recorder's gauges (sampled into bounded time
        series for /api/timeseries and the Perfetto counter tracks) and
        start its sampler; start the continuous self-profiler if opted in."""

        def _backlog():
            queued, _, _ = self.tasks.backlog_snapshot()
            return queued

        def _running():
            _, running, _ = self.tasks.backlog_snapshot()
            return running

        def _cache_rate(stats_fn):
            def rate():
                s = stats_fn()
                hits = s.get("hits", 0)
                total = hits + s.get("misses", 0)
                return (hits / total) if total else 0.0

            return rate

        r = self.recorder
        r.register_gauge(
            "ballista_task_queue_depth", _backlog,
            "Queued runnable task slots (incl. speculatable backups)",
        )
        r.register_gauge(
            "ballista_running_tasks", _running, "Tasks currently running"
        )
        r.register_gauge(
            "ballista_active_jobs",
            lambda: len(self.tasks.active_jobs()),
            "Jobs in RUNNING state",
        )
        r.register_gauge(
            "ballista_plan_cache_hit_rate",
            _cache_rate(self.plan_cache.stats),
            "Plan cache hit rate since scheduler start",
        )
        r.register_gauge(
            "ballista_exchange_cache_hit_rate",
            _cache_rate(self.exchange_cache.stats),
            "Exchange cache hit rate since scheduler start",
        )
        if self.recorder.enabled:
            r.start_sampler(self.config.obs_sample_interval_s)
        if self.config.obs_profiler:
            self.profiler.start()

    def stop(self):
        self._stop.set()
        if self._server is not None:
            self._server.stop(grace=0.5)

    # ---- RPC: executor lifecycle ------------------------------------------------------
    def register_executor(self, req: pb.RegisterExecutorParams, ctx) -> pb.RegisterExecutorResult:
        from ballista_tpu_torch.parallel.mesh import device_share_of, shards_per_card_of

        m = req.metadata
        self.cluster.register(
            ExecutorInfo(
                m.id, m.host, m.port, m.flight_port,
                m.specification.task_slots, m.specification.task_slots,
                mesh_group_id=m.specification.mesh_group_id,
                mesh_group_size=m.specification.mesh_group_size,
                mesh_group_process_id=m.specification.mesh_group_process_id,
                device_count=m.specification.num_devices,
                device_kind=m.specification.device_kind,
                shards_per_card=shards_per_card_of(m.specification.mesh_shape),
                device_share=device_share_of(m.specification.mesh_shape),
            )
        )
        log.info("registered executor %s at %s:%s", m.id, m.host, m.port)
        return pb.RegisterExecutorResult(success=True)

    def heart_beat_from_executor(self, req: pb.HeartBeatParams, ctx) -> pb.HeartBeatResult:
        with self.recorder.time_into("ballista_heartbeat_seconds"):
            hb = req.heartbeat
            known = self.cluster.heartbeat(
                hb.executor_id, hb.status or "active", dict(hb.metrics)
            )
            if not known and req.HasField("metadata"):
                # scheduler restarted: re-register silently (reference grpc.rs:203-235)
                self.register_executor(pb.RegisterExecutorParams(metadata=req.metadata), ctx)
            return pb.HeartBeatResult()

    def executor_stopped(self, req: pb.ExecutorStoppedParams, ctx) -> pb.ExecutorStoppedResult:
        log.info("executor %s stopped: %s", req.executor_id, req.reason)
        self._remove_executor(req.executor_id)
        return pb.ExecutorStoppedResult()

    # ---- RPC: pull-mode scheduling -----------------------------------------------------
    def poll_work(self, req: pb.PollWorkParams, ctx) -> pb.PollWorkResult:
        m = req.metadata
        if self.cluster.get(m.id) is None:
            self.register_executor(pb.RegisterExecutorParams(metadata=m), ctx)
        else:
            self.cluster.heartbeat(m.id)
        statuses = [task_status_to_dict(ts) for ts in req.task_status]
        if statuses:
            self._apply_statuses(m.id, statuses)
        e = self.cluster.get(m.id)
        if e is not None and e.status == "terminating":
            # pull mode honors drains: a TERMINATING executor keeps polling
            # (its statuses above still land, its shuffle files still serve)
            # but is never offered new tasks — the drain state machine
            # deregisters it once running tasks + shuffle readers finish
            self.cluster.set_free_slots(m.id, req.num_free_slots)
            return pb.PollWorkResult(tasks=[])
        if self.cluster.quarantine_state(m.id) == "quarantined":
            # pull mode honors quarantine too: the polling executor stays
            # registered (and keeps serving shuffle files) but gets no new
            # tasks until its cooling-off period lapses
            self.cluster.set_free_slots(m.id, req.num_free_slots)
            return pb.PollWorkResult(tasks=[])
        tasks = self.tasks.pop_tasks(
            m.id, req.num_free_slots, device_count=m.specification.num_devices
        )
        self.cluster.set_free_slots(m.id, req.num_free_slots - len(tasks))
        return pb.PollWorkResult(tasks=[self._task_def(t) for t in tasks])

    def update_task_status(self, req: pb.UpdateTaskStatusParams, ctx) -> pb.UpdateTaskStatusResult:
        statuses = [task_status_to_dict(ts) for ts in req.task_status]
        self.cluster.release_slots(req.executor_id, len(statuses))
        self._apply_statuses(req.executor_id, statuses)
        if self.config.scheduling_policy == "push":
            self._push_pool.submit(self.revive_offers)
        return pb.UpdateTaskStatusResult(success=True)

    def _apply_statuses(self, executor_id: str, statuses: list[dict]):
        # enrich shuffle locations with the executor's data-plane address
        # (the executor reports paths; the scheduler knows host/flight_port)
        e = self.cluster.get(executor_id)
        if e is not None:
            for st in statuses:
                for loc in st.get("locations", []):
                    loc.setdefault("host", e.host)
                    loc.setdefault("flight_port", e.flight_port)
        # per-executor failure-rate tracking feeds quarantine: retryable
        # execution failures indict the executor; fetch failures indict the
        # PRODUCER's data (handled by lineage rollback) and kills are
        # deliberate — neither counts against the reporter
        for st in statuses:
            if st["status"] == "success":
                self.cluster.record_rpc_success(executor_id)
            else:
                failure = st.get("failure", {})
                if "ICI_DEMOTE[" in str(failure.get("message", "")):
                    # an ICI demotion report is a DATA/shape signal (skew
                    # overflow, inexpressible collective), not executor
                    # health: the exchange re-plans onto the Flight tier and
                    # the same executor keeps serving it
                    continue
                if failure.get("kind") == "execution" and failure.get("retryable", True):
                    state = self.cluster.record_rpc_failure(
                        executor_id, kind="task",
                        # distinct-STAGE dedupe: all failures of one stage (a
                        # deterministic query/UDF bug hitting every partition)
                        # count once per executor — only failures across
                        # several stages/jobs (the flaky-host signature)
                        # reach the threshold, so one bad query can never
                        # quarantine the whole cluster
                        dedupe_key=(st["job_id"], st["stage_id"]),
                    )
                    if state == "quarantined":
                        log.warning(
                            "executor %s quarantined after repeated task "
                            "failures", executor_id,
                        )
                        self._on_quarantine(executor_id)
        self._record_task_observations(statuses)
        events = self.tasks.update_task_statuses(executor_id, statuses)
        # speculative races decided this batch: cancel each loser so it stops
        # burning a slot; its attempt-suffixed partial output can never alias
        # the winner's pieces and is reaped with the job's data
        losers = self.tasks.take_spec_cancellations()
        if losers:
            self._push_pool.submit(self._cancel_spec_losers, losers)
        # cached stages that re-ran this batch proved their entries stale:
        # the recompute's attempt-suffixed pieces live at paths the entry
        # does not name, so future adoptions must miss (docs/serving.md)
        for key, gen in self.tasks.take_stale_exchange_keys():
            self.exchange_cache.invalidate_key(key, gen)
        if self.state_store is not None:
            for job_id in {st["job_id"] for st in statuses}:
                g = self.tasks.get_job(job_id)
                if g is not None:
                    self._persist(g)
        for job_id, ev in events:
            if ev == "finished":
                self.metrics.job_completed_total += 1
                g = self.tasks.get_job(job_id)
                if g is not None and g.end_time:
                    self.metrics.job_exec_time_seconds_sum += g.end_time - g.start_time
                if g is not None:
                    # register the finished job's sealed hash exchanges for
                    # cross-job reuse (docs/serving.md), then release the
                    # leases it held on entries it adopted
                    self._register_exchanges(g)
                    self._finalize_ledger(g, "successful")
                if getattr(self, "events", None) is not None:
                    from ballista_tpu_torch.scheduler.query_stage_scheduler import JobFinished

                    self.events.post(JobFinished(job_id))
                self._exchange_release(job_id)
                self._admission_release(job_id)
            elif ev == "failed":
                self.metrics.job_failed_total += 1
                g = self.tasks.get_job(job_id)
                if g is not None:
                    self._finalize_ledger(g, "failed")
                self._exchange_release(job_id)
                self._admission_release(job_id)

    def _record_task_observations(self, statuses: list[dict]) -> None:
        """Harvest per-task flight-recorder observations from a status batch:
        queue wait (launch -> start on the executor), run duration
        (start -> end), and shuffle-read fetch latency from the task's
        piggybacked spans. Runs before graph updates so every reported
        attempt counts, including speculative losers."""
        if not self.recorder.enabled:
            return
        for st in statuses:
            launch = st.get("launch_time_ms") or 0
            start = st.get("start_time_ms") or 0
            end = st.get("end_time_ms") or 0
            if launch and start and start >= launch:
                self.recorder.observe(
                    "ballista_task_queue_wait_seconds", (start - launch) / 1000.0
                )
            if start and end and end >= start:
                self.recorder.observe(
                    "ballista_task_run_seconds", (end - start) / 1000.0
                )
            for span in st.get("spans", ()) or ():
                if span.get("name") == "shuffle-read":
                    self.recorder.observe(
                        "ballista_flight_fetch_seconds",
                        max(0, int(span.get("dur_us", 0))) / 1e6,
                    )

    def _finalize_ledger(self, g, status: str) -> None:
        """Job-completion rollup: freeze the graph's per-stage metric
        accumulators into a QueryLedger, attach it to the graph (so
        /api/job/{id} and EXPLAIN ANALYZE see it), persist it through the
        state store, fold it into the per-tenant Prometheus aggregates, and
        observe end-to-end latency."""
        from ballista_tpu_torch.obs.ledger import accumulate_tenant, build_ledger

        try:
            ledger = build_ledger(g, status=status)
        except Exception:  # noqa: BLE001 - telemetry must not fail the job
            log.exception("ledger rollup failed for %s", g.job_id)
            return
        g.ledger = ledger.to_dict()
        # one gauge sweep at completion: even sub-interval jobs get at least
        # one counter-track point inside their Perfetto span window
        self.recorder.sample_once()
        if status == "successful" and ledger.wall_s:
            self.recorder.observe(
                "ballista_query_latency_seconds", ledger.wall_s,
                {"tenant": ledger.tenant},
            )
        with self._tenant_ledger_lock:
            accumulate_tenant(self.tenant_ledgers, ledger)
        # the ledger rides the job trace as a scheduler span, so EXPLAIN
        # ANALYZE (which fetches the distributed trace) can render the
        # resource footer without a second RPC
        trace_id = getattr(g, "trace_id", "") or ""
        if trace_id:
            from ballista_tpu_torch.obs import tracing as obs

            self.traces.add(
                g.job_id,
                [{
                    "trace_id": trace_id,
                    "span_id": obs.new_span_id(),
                    "parent_id": obs.job_span_id(trace_id, g.job_id),
                    "name": "ledger",
                    "service": "scheduler",
                    "start_us": int((g.end_time or time.time()) * 1e6),
                    "dur_us": 0,
                    "tid": 0,
                    "attrs": {"ledger": json.dumps(g.ledger)},
                }],
            )
        if self.state_store is not None:
            try:
                self.state_store.save_ledger(g.job_id, g.ledger)
            except Exception:  # noqa: BLE001
                log.exception("ledger persist failed for %s", g.job_id)

    # ---- RPC: query lifecycle -----------------------------------------------------------
    def execute_query(self, req: pb.ExecuteQueryParams, ctx) -> pb.ExecuteQueryResult:
        from ballista_tpu_torch.obs import tracing as obs

        session_id = req.session_id or uuid.uuid4().hex
        settings = dict(req.settings)
        # trace context is per-QUERY, not per-session: strip it before the
        # settings become durable session state
        trace_id_in = settings.pop(obs.TRACE_ID_PROP, "")
        trace_parent = settings.pop(obs.PARENT_PROP, "") or None
        if req.session_id and req.session_id in self.sessions:
            merged = dict(self.sessions[req.session_id])
            merged.update(settings)
            settings = merged
        self.sessions.setdefault(session_id, settings)
        # ballista.trace.enabled=false turns job tracing off entirely — no
        # trace props on launches, so executors stay on the zero-cost path.
        # Read AFTER the session merge: a session-level =false with no
        # per-query override must win (per-query settings still take
        # precedence because the merge overlays them on the session's).
        enabled = str(
            settings.get("ballista.trace.enabled", "true")
        ).lower() not in ("false", "0", "no")
        trace_id = (trace_id_in or obs.new_trace_id()) if enabled else ""
        job_id = generate_job_id()
        self._set_override(job_id, "QUEUED")
        self.metrics.job_submitted_total += 1

        which = req.WhichOneof("query")
        payload = req.logical_plan if which == "logical_plan" else req.sql
        table_defs = [json.loads(b.decode()) for b in req.table_defs]
        # admission gate (docs/serving.md): under the concurrent-job cap the
        # dispatch runs immediately (the 0-cap default always does); over it
        # the job waits in the bounded queue, dequeued by weighted fair share
        # when a running job releases; past the queue bound the submission
        # fails with a clean RESOURCE_EXHAUSTED naming the knob
        from ballista_tpu_torch.config import (
            BALLISTA_SERVING_TENANT,
            BALLISTA_SERVING_WEIGHT,
        )

        tenant = settings.get(BALLISTA_SERVING_TENANT, "") or session_id
        try:
            weight = float(settings.get(BALLISTA_SERVING_WEIGHT, "") or 1.0)
        except ValueError:
            weight = 1.0  # the planner's config validation reports it
        submitted_at = time.time()
        trace = (trace_id, trace_parent) if trace_id else None

        def dispatch():
            self._planner_pool.submit(
                self._plan_and_submit, job_id, session_id, which, payload,
                table_defs, settings, trace, submitted_at,
            )

        verdict, msg = self.admission.submit(job_id, tenant, weight, dispatch)
        if verdict == "rejected":
            self._set_override(job_id, "FAILED", msg)
            self.metrics.job_failed_total += 1
        elif verdict == "run":
            dispatch()
        # "queued": the dispatch fires from a release() when capacity frees
        return pb.ExecuteQueryResult(job_id=job_id, session_id=session_id)

    def _plan_and_submit(self, job_id, session_id, kind, payload, table_defs,
                         settings, trace_ctx=None, submitted_at=None):
        t0 = time.time()
        # time the job spent waiting in the admission queue (0 when the gate
        # dispatched it immediately) — rides the plan span + serving stats
        admission_wait_ms = (
            round(max(0.0, t0 - submitted_at) * 1000.0, 1) if submitted_at else 0.0
        )
        plan_cache_state = "bypass"
        try:
            catalog = Catalog()
            for td in table_defs:
                meta = TableMeta.from_dict(td)
                catalog.tables[meta.name] = meta
            config = BallistaConfig(settings)
            from ballista_tpu_torch.config import (
                BALLISTA_AQE_ENABLED,
                BALLISTA_AQE_SKEW_FACTOR,
                BALLISTA_AQE_TARGET_PARTITION_BYTES,
                BALLISTA_BROADCAST_ROWS_THRESHOLD,
                BALLISTA_ENGINE_MEGASTAGE,
                BALLISTA_ENGINE_MEGASTAGE_MAX_BOUNDARIES,
                BALLISTA_SERVING_EXCHANGE_CACHE,
                BALLISTA_SERVING_PLAN_CACHE,
                BALLISTA_SERVING_TENANT,
                BALLISTA_SERVING_TENANT_SLOTS,
                BALLISTA_SERVING_WEIGHT,
                BALLISTA_SHUFFLE_ICI,
                BALLISTA_SHUFFLE_ICI_MAX_ROWS,
                BALLISTA_SHUFFLE_PIPELINE,
                BALLISTA_SHUFFLE_PIPELINE_MIN_FRACTION,
                BALLISTA_TPU_FUSE_EXCHANGE_MAX_ROWS,
            )
            from ballista_tpu_torch.scheduler.serving import (
                PlanEntry,
                fingerprint_bytes,
                fingerprint_sql,
                settings_digest,
                table_defs_digest,
            )

            # plan cache (docs/serving.md): a repeated statement against an
            # unchanged catalog + settings + cluster capability reuses the
            # already-governed physical TEMPLATE — parse/plan/analyze/govern/
            # verify all skipped. The key's table-defs digest is the catalog-
            # version signal (any (de)registration or data refresh changes
            # it); the cluster signature re-plans when the executor set's
            # device inventory changes (governing and ICI promotion depend
            # on it). Values are ENCODED plans: every hit decodes a fresh
            # node tree, so jobs never share mutable plan state.
            n_devices = max(1, self.cluster.max_device_count())
            device_kinds = tuple(sorted(self.cluster.device_kinds()))
            shards_per_card = self.cluster.max_shards_per_card()
            device_share = self.cluster.min_device_share()
            # the catalog-version signal, shared by the plan cache key AND
            # the cross-query exchange cache key (docs/serving.md)
            tdigest = table_defs_digest([
                json.dumps(td, sort_keys=True).encode() for td in table_defs
            ])
            cache_key = None
            entry = None
            if config.get(BALLISTA_SERVING_PLAN_CACHE):
                # the fingerprint is ALWAYS derived from the payload here —
                # the cache is shared across every session, so a client-
                # supplied key would let one session poison another's plans.
                # (Flight SQL's prepare-time fingerprint is the same value by
                # construction; re-deriving it costs one lexer pass.)
                fp = (
                    fingerprint_sql(payload) if kind == "sql"
                    else fingerprint_bytes(payload)
                )
                cache_key = (
                    fp,
                    tdigest,
                    settings_digest(settings),
                    n_devices,
                    device_kinds,
                    shards_per_card,
                    device_share,
                )
                entry = self.plan_cache.get(cache_key)
            logical = None
            plan_warnings: list[str] = []
            if entry is not None:
                plan_cache_state = "hit"
                physical = decode_physical(entry.plan_bytes)
                plan_warnings = list(entry.warnings)
                memory_report = entry.memory_report
            else:
                plan_cache_state = "miss" if cache_key is not None else "bypass"
                if kind == "sql":
                    from ballista_tpu_torch.sql.parser import parse_sql
                    from ballista_tpu_torch.sql.planner import SqlPlanner

                    logical = SqlPlanner(catalog.schemas()).plan(parse_sql(payload))
                else:
                    logical = decode_logical(payload)
                logical = optimize(logical, catalog)
                physical = PhysicalPlanner(catalog, config).plan(logical)
                # HBM governor (docs/memory.md): budget-aware partition
                # sizing / paged-join flagging BEFORE the stage split and ICI
                # promotion. A plan no mitigation fits is rejected here at
                # admission (PV007) — regardless of the verify knob, since
                # executing it would only OOM-kill an executor mid-query.
                from ballista_tpu_torch.engine.memory_model import (
                    budget_from_device_kinds,
                    govern_with_config,
                )

                # budget auto-detection in the control plane comes from the
                # device kinds the executors REGISTERED — probing the
                # scheduler process's own jax device would read the wrong
                # platform (a CPU-only scheduler VM fronting TPU executors)
                # or fight a co-located executor for the TPU runtime
                physical, memory_report = govern_with_config(
                    physical, config, n_devices,
                    detected_budget_bytes=budget_from_device_kinds(
                        set(device_kinds), shards_per_card, device_share
                    ),
                    shared=device_share < 1.0,
                )
                if memory_report is not None and memory_report.rejections():
                    from ballista_tpu_torch.analysis import errors_of as _errors_of
                    from ballista_tpu_torch.analysis import (
                        verify_memory as _verify_memory,
                    )

                    raise PlanVerificationError(
                        _errors_of(_verify_memory(memory_report))
                    )

            graph = ExecutionGraph(
                job_id, settings.get("ballista.job.name", ""), session_id, physical,
                fuse_exchange_max_rows=config.get(BALLISTA_TPU_FUSE_EXCHANGE_MAX_ROWS),
                broadcast_rows_threshold=config.get(BALLISTA_BROADCAST_ROWS_THRESHOLD),
                trace_ctx=trace_ctx,
                # two-tier shuffle: eligible exchanges collapse onto the ICI
                # tier when a fat executor (>=2-device mesh) is schedulable
                # right now — the capability signal, not an assignment (the
                # stage pins to whichever fat executor binds it first)
                ici_shuffle=config.get(BALLISTA_SHUFFLE_ICI),
                ici_devices=self.cluster.max_device_count(),
                ici_max_rows=config.get(BALLISTA_SHUFFLE_ICI_MAX_ROWS),
                # ICI promotion consults the same budget: an exchange whose
                # per-device collective footprint cannot fit declines at plan
                # time (ICI_DEMOTE[plan]: hbm_budget) instead of OOMing
                hbm_budget_bytes=(
                    memory_report.budget_bytes if memory_report is not None else 0
                ),
                # megastage compiler (docs/megastage.md): fully ICI-eligible
                # chains collapse into ONE stage compiled as a single mesh
                # program; any decline falls back to the per-stage split
                megastage=config.get(BALLISTA_ENGINE_MEGASTAGE),
                megastage_max_boundaries=config.get(
                    BALLISTA_ENGINE_MEGASTAGE_MAX_BOUNDARIES
                ),
                # adaptive execution at shuffle boundaries (docs/adaptive.md):
                # per-stage coalesce/skew decisions fire at resolve() from
                # measured piece sizes; identical exchange subtrees dedupe at
                # stage-split time. Off = the static split, byte-for-byte.
                aqe_enabled=config.get(BALLISTA_AQE_ENABLED),
                aqe_target_partition_bytes=config.get(
                    BALLISTA_AQE_TARGET_PARTITION_BYTES
                ),
                aqe_skew_factor=config.get(BALLISTA_AQE_SKEW_FACTOR),
                # pipelined shuffle (docs/shuffle.md): eligible consumers
                # early-resolve once the sealed-piece fraction is reached;
                # executors stream late pieces via the GetStageInputs feed.
                # Off = barrier semantics, byte-for-byte.
                pipeline_enabled=config.get(BALLISTA_SHUFFLE_PIPELINE),
                pipeline_min_fraction=config.get(
                    BALLISTA_SHUFFLE_PIPELINE_MIN_FRACTION
                ),
            )
            graph.memory_report = memory_report
            # the job's run counts from its acceptance (op.Job.run_s)
            graph.queued_at = submitted_at or t0
            # fair-share accounting identity (docs/serving.md): tenant +
            # weight + slot quota ride the session settings onto the graph;
            # the TaskManager's weighted round-robin offer reads them
            graph.tenant = settings.get(BALLISTA_SERVING_TENANT, "") or session_id
            graph.share_weight = config.get(BALLISTA_SERVING_WEIGHT)
            graph.tenant_slots = config.get(BALLISTA_SERVING_TENANT_SLOTS)
            # straggler speculation (docs/elasticity.md): the session knob
            # wins; unset sessions inherit the scheduler's scale_settings
            from ballista_tpu_torch.config import BALLISTA_SCALE_SPECULATION_FACTOR

            graph.speculation_factor = (
                config.get(BALLISTA_SCALE_SPECULATION_FACTOR)
                if BALLISTA_SCALE_SPECULATION_FACTOR in settings
                else self.scale.speculation_factor
            )
            if entry is None:
                # analyzer pass before anything is admitted (reference:
                # DataFusion validates plans before the executor sees them):
                # error findings block the submission with a client-visible
                # message instead of surfacing as mid-query task failures on
                # device. The graph's own stage split is reused — no second
                # split on the submission path. Plan-cache HITS skip this:
                # the template was verified when first planned, and its
                # warnings ride the cache entry.
                from ballista_tpu_torch.config import BALLISTA_VERIFY_PLAN

                if config.get(BALLISTA_VERIFY_PLAN):
                    # NOTE: PlanVerificationError itself is imported at module
                    # level — importing it here would make the name function-
                    # local and break the except clause below for pre-verify
                    # failures
                    from ballista_tpu_torch.analysis import (
                        errors_of, verify_submission, warnings_of,
                    )

                    findings = verify_submission(
                        logical, physical,
                        stages=[s.plan for s in graph.stages.values()],
                        memory_report=memory_report,
                    )
                    errs = errors_of(findings)
                    if errs:
                        raise PlanVerificationError(errs)
                    plan_warnings = [
                        f"[{f.rule}] {f.operator}: {f.message}"
                        for f in warnings_of(findings)
                    ]
                if cache_key is not None:
                    # cache only a VERIFIED template, encoded: the PV006
                    # serde fixed-point is exactly what makes it safe to
                    # decode fresh per job. Unserializable plans just bypass.
                    try:
                        entry = PlanEntry(
                            cache_key[0], encode_physical(physical),
                            list(plan_warnings), memory_report,
                        )
                        self.plan_cache.put(cache_key, entry)
                    except Exception:  # noqa: BLE001
                        log.debug("plan for %s not cacheable", job_id,
                                  exc_info=True)
            graph.warnings = plan_warnings
            # cross-query exchange cache (docs/serving.md): adopt cached
            # materializations for identical hash-exchange producer stages —
            # adopted stages complete without launching a task; their
            # consumers resolve immediately against the sealed pieces. Runs
            # on plan-cache hits too (the cache is per-JOB state). A PV008
            # schema-drift finding aborts the submission (admission error).
            graph.exchange_cache_enabled = config.get(
                BALLISTA_SERVING_EXCHANGE_CACHE
            )
            exchange_state = "bypass"
            adopted: list = []
            if graph.exchange_cache_enabled:
                # digest memo rides the plan-cache entry (hit or the one
                # just put): repeats skip per-job subtree re-serialization
                digest_memo = None
                if entry is not None:
                    if entry.exchange_digests is None:
                        entry.exchange_digests = {}
                    digest_memo = entry.exchange_digests
                adopted = self._adopt_cached_exchanges(
                    graph, tdigest, n_devices, device_kinds, digest_memo
                )
                exchange_state = "hit" if adopted else "miss"
                if adopted:
                    with self._exchange_lock:
                        self._exchange_refs[job_id] = list(adopted)
            # ledger provenance (obs.ledger.build_ledger reads these at job
            # completion): admission wait, cache outcomes, shuffle codec
            from ballista_tpu_torch.config import BALLISTA_SHUFFLE_COMPRESSION

            graph.admission_wait_ms = admission_wait_ms
            graph.plan_cache_state = plan_cache_state
            graph.exchange_state = exchange_state
            graph.shuffle_codec = (
                config.get(BALLISTA_SHUFFLE_COMPRESSION) or "none"
            )
            # session-level profiler toggle (ballista.obs.profiler): an ops
            # session can switch the process sampler on/off without a
            # restart — only when the key is explicitly SET, so ordinary
            # sessions (key absent, default false) never stop a profiler
            # another session started
            from ballista_tpu_torch.config import BALLISTA_OBS_PROFILER

            if BALLISTA_OBS_PROFILER in config.settings():
                if config.get(BALLISTA_OBS_PROFILER):
                    self.profiler.start()
                else:
                    self.profiler.stop()
            if trace_ctx is not None and trace_ctx[0]:
                from ballista_tpu_torch.obs.tracing import new_span_id

                attrs = {
                    "stages": len(graph.stages), "kind": kind,
                    # serving observability: cache outcomes, tenant, and time
                    # spent queued in admission, per job in the trace
                    "plan_cache": plan_cache_state,
                    "exchange_cache": exchange_state,
                    "tenant": graph.tenant,
                    "admission_wait_ms": admission_wait_ms,
                }
                if adopted:
                    attrs["exchange_cache_hits"] = len(adopted)
                if plan_warnings:
                    # analyzer warnings ride the job trace so EXPLAIN ANALYZE
                    # and /api/trace/{job_id} surface them next to the timing
                    attrs["verify_warnings"] = plan_warnings
                self.traces.add(job_id, [{
                    "trace_id": trace_ctx[0],
                    "span_id": new_span_id(),
                    "parent_id": trace_ctx[1],
                    "name": "plan",
                    "service": "scheduler",
                    "start_us": int(t0 * 1e6),
                    "dur_us": int((time.time() - t0) * 1e6),
                    "tid": 0,
                    "attrs": attrs,
                }])
            n_stages = len(graph.stages)  # before submit attaches the guard
            with self._cancel_lock:
                cancelled = job_id in self._cancelled_jobs
                if cancelled:
                    # the client's timeout expired while this job sat in
                    # admission / planning: drop it before any task binds
                    self._cancelled_jobs.discard(job_id)
                    self._set_override_locked(
                        job_id, "CANCELLED",
                        "cancelled while queued in admission",
                    )
                else:
                    self.tasks.submit_job(graph)
                    # override removed under the SAME lock the cancel path
                    # checks it under: a cancel that misses the override is
                    # then guaranteed to find the job in the TaskManager
                    self._job_overrides.pop(job_id, None)
            if cancelled:
                self._exchange_release(job_id)
                self._admission_release(job_id)
                return
            self._persist(graph)
            if self.state_store is not None:
                # claim ownership so a standby scheduler can only take this
                # job over after our lease lapses (renewed in the expiry
                # loop). Fail OPEN on KV unavailability: an unreachable KV
                # must degrade HA coverage, not fail a plannable job (the
                # next expiry tick retries the lease)
                try:
                    self.state_store.try_acquire_job(
                        job_id, self.config.job_lease_ttl_seconds
                    )
                except Exception:  # noqa: BLE001
                    log.warning(
                        "job lease acquire for %s failed (KV unavailable); "
                        "continuing un-leased", job_id, exc_info=True,
                    )
            planning_ms = (time.time() - t0) * 1000
            graph.planning_ms = planning_ms
            self.metrics.planning_time_ms_sum += planning_ms
            self.recorder.observe(
                "ballista_planning_seconds", planning_ms / 1000.0
            )
            self.recorder.observe(
                "ballista_admission_wait_seconds", admission_wait_ms / 1000.0
            )
            log.info("job %s planned: %d stages", job_id, n_stages)
            if self.config.scheduling_policy == "push":
                self._push_pool.submit(self.revive_offers)
        except PlanVerificationError as e:
            # not an internal fault: the submitted plan failed its invariant
            # checks — fail the job with the analyzer's findings verbatim
            log.warning("job %s rejected by plan verifier: %s", job_id, e)
            self._set_override(job_id, "FAILED", str(e))
            self.metrics.job_failed_total += 1
            with self._cancel_lock:
                self._cancelled_jobs.discard(job_id)  # nothing left to drop
            self._exchange_release(job_id)
            self._admission_release(job_id)
        except Exception as e:  # noqa: BLE001 - surfaced as job failure
            log.exception("planning failed for job %s", job_id)
            self._set_override(job_id, "FAILED", f"planning error: {e}")
            self.metrics.job_failed_total += 1
            with self._cancel_lock:
                self._cancelled_jobs.discard(job_id)
            self._exchange_release(job_id)
            self._admission_release(job_id)

    def get_stage_inputs(
        self, req: pb.GetStageInputsParams, ctx
    ) -> pb.GetStageInputsResult:
        """Pipelined shuffle's live piece feed (docs/shuffle.md): executors
        running an EARLY-resolved consumer poll here for the sealed
        locations of pieces that were still pending at launch. Answered
        from the consumer stage's live input state, so producer re-runs
        automatically route their attempt-suffixed replacement pieces to
        waiting consumers (the stale-location update)."""
        with self.recorder.time_into("ballista_stage_inputs_seconds"):
            pieces, complete, gone = self.tasks.stage_input_pieces(
                req.job_id, req.stage_id, req.input_stage_id, req.partition_id
            )
        return pb.GetStageInputsResult(
            pieces=[
                pb.StageInputPiece(
                    map_partition=int(p.get("map_partition", 0) or 0),
                    path=p.get("path", "") or "",
                    host=p.get("host", "") or "",
                    flight_port=int(p.get("flight_port", 0) or 0),
                    executor_id=p.get("executor_id", "") or "",
                    num_rows=int(p.get("num_rows", 0) or 0),
                    num_bytes=int(p.get("num_bytes", 0) or 0),
                )
                for p in pieces
            ],
            complete=complete,
            gone=gone,
        )

    def get_job_status(self, req: pb.GetJobStatusParams, ctx) -> pb.GetJobStatusResult:
        job_id = req.job_id
        with self._cancel_lock:
            override = self._job_overrides.get(job_id)
        if override is not None:
            state, err = override
            return pb.GetJobStatusResult(
                status=pb.JobStatus(job_id=job_id, state=state, error=err)
            )
        # status is read from the LIVE graph, which heartbeats/revive mutate
        # concurrently — snapshot under the task lock (pure in-memory reads)
        with self.tasks._lock:
            g = self.tasks.get_job(job_id)
            if g is None:
                return pb.GetJobStatusResult(
                    status=pb.JobStatus(job_id=job_id, state="NOT_FOUND")
                )
            status = pb.JobStatus(
                job_id=job_id,
                job_name=g.job_name,
                state=g.status,
                error=g.error or "",
                total_task_count=g.total_task_count(),
                completed_task_count=g.completed_task_count(),
                warnings=getattr(g, "warnings", []) or [],
                queued_at_ms=g.queued_at * 1000.0,
                started_at_ms=g.start_time * 1000.0,
                ended_at_ms=(g.end_time or 0.0) * 1000.0,
            )
            if g.status == SUCCESSFUL:
                status.result_schema = json.dumps(
                    schema_to_json(g.output_schema())
                ).encode()
                for loc in g.output_locations:
                    status.partition_locations.append(
                        pb.PartitionLocation(
                            partition=pb.PartitionId(
                                job_id=job_id, stage_id=loc["stage_id"],
                                partition_id=loc["partition_id"],
                            ),
                            executor_id=loc["executor_id"], host=loc["host"],
                            flight_port=loc["flight_port"], path=loc["path"],
                            num_rows=loc["num_rows"], num_bytes=loc["num_bytes"],
                            map_partition=loc["map_partition"],
                        )
                    )
        return pb.GetJobStatusResult(status=status)

    def get_job_metrics(self, req: pb.GetJobStatusParams, ctx) -> pb.GetTraceResult:
        """A job's counters as JSON (``ExecutionGraph.folded_metrics``: its
        stages' task and scheduler metrics folded), ``{}`` for a job unknown
        here; a remote client reads them into ``last_engine_metrics``."""
        with self.tasks._lock:
            g = self.tasks.get_job(req.job_id)
            metrics = g.folded_metrics() if g is not None else {}
        return pb.GetTraceResult(trace=json.dumps(metrics).encode())

    def get_trace(self, req: pb.GetTraceParams, ctx) -> pb.GetTraceResult:
        return pb.GetTraceResult(
            trace=json.dumps(self.traces.get(req.job_id)).encode()
        )

    def report_trace(self, req: pb.ReportTraceParams, ctx) -> pb.ReportTraceResult:
        """Clients ship their own spans (submit / await / result fetch) after
        the job completes so the stored trace covers the full path."""
        try:
            spans = json.loads(bytes(req.spans).decode() or "[]")
        except ValueError:
            spans = []
        if isinstance(spans, list):
            self.traces.add(req.job_id, [s for s in spans if isinstance(s, dict)])
        return pb.ReportTraceResult()

    def cancel_job(self, req: pb.CancelJobParams, ctx) -> pb.CancelJobResult:
        job_id = req.job_id
        if self._cancel_running_job(job_id):
            return pb.CancelJobResult(cancelled=True)
        # client timeout expiry (ballista.client.query_timeout_s) must also
        # cancel jobs that never started RUNNING: still queued in admission
        # (the dispatch closure is removed and never fires), or dispatched
        # but still planning (flagged under _cancel_lock; the planner drops
        # the graph instead of submitting it). Either way the job ends in a
        # clean CANCELLED instead of running orphaned after the client left.
        if self.admission.cancel_queued(job_id):
            self._set_override(
                job_id, "CANCELLED", "cancelled while queued in admission"
            )
            self.metrics.job_cancelled_total += 1
            return pb.CancelJobResult(cancelled=True)
        with self._cancel_lock:
            was_queued = self._job_overrides.get(job_id, (None, ""))[0] == "QUEUED"
            if was_queued:
                self._cancelled_jobs.add(job_id)
        if was_queued:
            # stats counters are deliberately lock-free everywhere; keep this
            # increment outside _cancel_lock like its siblings (BL004)
            self.metrics.job_cancelled_total += 1
            return pb.CancelJobResult(cancelled=True)
        # the override is gone: the planner submitted between our first
        # check and the lock — the job is RUNNING now, cancel it normally
        return pb.CancelJobResult(cancelled=self._cancel_running_job(job_id))

    def _cancel_running_job(self, job_id: str) -> bool:
        ok = self.tasks.cancel_job(job_id)
        if ok:
            self.metrics.job_cancelled_total += 1
            self._cancel_running_tasks(job_id)
            self._exchange_release(job_id)
            self._admission_release(job_id)
        return ok

    def clean_job_data(self, req: pb.CleanJobDataParams, ctx) -> pb.CleanJobDataResult:
        from ballista_tpu_torch.utils import faults

        # cross-query exchange cache (docs/serving.md): a job whose sealed
        # exchanges are registered (or still being read) keeps its shuffle
        # dirs — the cleanup is DEFERRED and re-fired by the cache's unpin
        # callback when the last entry/lease for this job drains
        if self.exchange_cache.job_pinned(req.job_id):
            with self._exchange_lock:
                self._deferred_cleans.add(req.job_id)
            log.info("job data clean of %s deferred (exchange-cache pin)",
                     req.job_id)
            return pb.CleanJobDataResult()
        # quarantined executors still hold job data: cleanup is not task
        # placement, so it fans out to them too
        for e in self.cluster.alive_executors(include_quarantined=True):
            try:
                faults.check("rpc.clean", {"executor_id": e.executor_id})
                self._stub(e).RemoveJobData(pb.RemoveJobDataParams(job_id=req.job_id), timeout=5)
            except Exception:  # noqa: BLE001
                pass
        return pb.CleanJobDataResult()

    # ---- RPC: sessions -------------------------------------------------------------------
    def create_session(self, req: pb.CreateSessionParams, ctx) -> pb.CreateSessionResult:
        sid = uuid.uuid4().hex
        self.sessions[sid] = dict(req.settings)
        return pb.CreateSessionResult(session_id=sid)

    def update_session(self, req: pb.UpdateSessionParams, ctx) -> pb.UpdateSessionResult:
        self.sessions[req.session_id] = dict(req.settings)
        return pb.UpdateSessionResult(success=True)

    def remove_session(self, req: pb.RemoveSessionParams, ctx) -> pb.RemoveSessionResult:
        return pb.RemoveSessionResult(success=self.sessions.pop(req.session_id, None) is not None)

    def get_file_metadata(self, req: pb.GetFileMetadataParams, ctx) -> pb.GetFileMetadataResult:
        import pyarrow.parquet as pq

        from ballista_tpu_torch.plan.schema import Schema

        schema = Schema.from_arrow(pq.ParquetFile(req.path).schema_arrow)
        return pb.GetFileMetadataResult(schema=json.dumps(schema_to_json(schema)).encode())

    # ---- push-mode launching ----------------------------------------------------------
    def revive_offers(self):
        """Reserve free slots and push bound tasks (reference: state/mod.rs:158-332).

        Slot reservation and task binding are check-then-set and stay under
        ``_revive_lock``; the LaunchMultiTask RPC pushes happen AFTER the lock
        is released (BL001: a slow executor must not stall every other revive
        trigger queueing on the lock). Bindings made under the lock cannot be
        double-made by a concurrent pass, so deferring the pushes is safe.

        Launch failure handling (chaos-layer hardening): the RPC itself
        retries with backoff inside ``_launch_multi``, so a TRANSIENT error
        never reaches this handler. An exhausted budget unbinds exactly the
        failed batch's tasks (re-queued for other executors), releases the
        reserved slots, and records a health failure — repeated failures
        QUARANTINE the executor rather than removing it (its shuffle files
        are still servable; removal would trigger a needless lineage storm).
        Gang batches still remove: a collective attempt missing one member
        is doomed, and removal both restarts the gang stage and breaks the
        mesh group until the member proves itself again via re-register."""
        with self._revive_lock:
            batches = self._revive_offers_locked()
        requeued = 0
        for stop_on_failure, launches in batches:
            for ex_id, descs, extra in launches:
                try:
                    # NOTE: launch DELIVERY is health-neutral — only a task
                    # OUTCOME counts as a success (_apply_statuses). If mere
                    # delivery re-admitted, a reachable executor whose tasks
                    # persistently fail would have its failure count reset by
                    # every relaunch and never reach the threshold.
                    self._launch_multi(ex_id, descs, extra)
                except Exception as e:  # noqa: BLE001
                    if stop_on_failure:
                        log.warning(
                            "gang launch to %s failed (%s); removing executor",
                            ex_id, e,
                        )
                        self._remove_executor(ex_id)
                        # a gang member never launched: the attempt is doomed —
                        # launching the rest would only park them at the KV
                        # barrier until its timeout
                        break
                    n = self.tasks.unbind_tasks(descs)
                    # release only the slots actually unbound: a desc whose
                    # status already arrived (delivered-but-slow launch) had
                    # its slot released on the status path, and re-crediting
                    # it here would oversubscribe the executor
                    self.cluster.release_slots(ex_id, n)
                    requeued += n
                    state = self.cluster.record_rpc_failure(ex_id)
                    log.warning(
                        "launch to %s failed after retry budget (%s); "
                        "re-queued %d tasks, executor now %s",
                        ex_id, e, n, state,
                    )
                    if state == "quarantined":
                        self._on_quarantine(ex_id)
        if requeued and self.config.scheduling_policy == "push":
            # the unbound tasks need a fresh offer pass on the healthy set
            self._push_pool.submit(self.revive_offers)

    # a launch batch is (stop_on_failure, [(executor_id, descs, extra_props)]):
    # gang batches stop at the first failed member, normal batches keep going
    _LaunchBatch = tuple[bool, list[tuple[str, list, Optional[dict]]]]

    def _revive_offers_locked(self) -> list["_LaunchBatch"]:
        # speculatable backups count as offerable work: in a stage's tail
        # pending_tasks() is 0, but an overdue straggler still wants a slot
        # reserved for its backup attempt (pop_tasks hands it out)
        spec = self.tasks.speculatable_count()
        pending = self.tasks.pending_tasks() + spec
        if not pending:
            return []
        batches = self._revive_gang_stages()
        pending = self.tasks.pending_tasks() + spec
        if not pending:
            return batches
        if self.config.task_distribution == "consistent-hash":
            return batches + self._revive_offers_consistent_hash()
        slot_owners = self.cluster.reserve_slots(pending)
        by_executor: dict[str, list[TaskDescriptor]] = {}
        for ex_id in slot_owners:
            e = self.cluster.get(ex_id)
            ts = self.tasks.pop_tasks(
                ex_id, 1, device_count=e.device_count if e is not None else None
            )
            if ts:
                by_executor.setdefault(ex_id, []).extend(ts)
            else:
                self.cluster.release_slots(ex_id, 1)
        if by_executor:
            batches.append(
                (False, [(ex_id, descs, None) for ex_id, descs in by_executor.items()])
            )
        return batches

    def _revive_offers_consistent_hash(self) -> list["_LaunchBatch"]:
        """Locality binding: tasks go to the executor owning their first scan
        file on the hash ring (reference: bind_task_consistent_hash)."""
        from ballista_tpu_torch.scheduler.consistent_hash import bind_tasks_consistent_hash

        free = {
            e.executor_id: e.free_slots
            for e in self.cluster.alive_executors()
            if e.free_slots > 0
        }
        if not free:
            return []
        by_executor: dict[str, list[TaskDescriptor]] = {}
        # peek/bind walk live graph stages, which mutate under the
        # TaskManager lock (status updates land concurrently from RPC threads)
        with self.tasks._lock:
            for g in self.tasks.active_jobs():
                cands = g.peek_tasks(sum(free.values()))
                bound = bind_tasks_consistent_hash(
                    cands, free,
                    self.config.consistent_hash_num_replicas,
                    self.config.consistent_hash_tolerance,
                )
                for ex_id, (stage_id, p, _) in bound:
                    e = self.cluster.get(ex_id)
                    d = g.bind_task(
                        stage_id, p, ex_id,
                        device_count=e.device_count if e is not None else None,
                    )
                    if d is not None:
                        by_executor.setdefault(ex_id, []).append(d)
        launches = []
        for ex_id, descs in by_executor.items():
            e = self.cluster.get(ex_id)
            if e is None:
                continue
            e.free_slots = max(0, e.free_slots - len(descs))
            launches.append((ex_id, descs, None))
        return [(False, launches)] if launches else []

    def _revive_gang_stages(self) -> list["_LaunchBatch"]:
        """Gang-bind stages carrying an inline exchange onto a complete mesh
        group: every member gets its share of the stage's tasks in ONE launch
        batch (partition p -> the member whose process_id == p % group size),
        because every process of the group must enter the collective SPMD
        program together. Only fires when the stage's full task set is still
        unbound; partial retries fall back to per-executor scheduling (the
        engine then computes the exchange locally). Binding and bookkeeping
        happen here (under ``_revive_lock``); the actual pushes are returned
        as stop-on-failure batches for the caller to run lock-free."""
        groups = self.cluster.complete_mesh_groups()
        if not groups:
            return []
        # drop finished in-flight markers; a group with a live gang stage is
        # unavailable (one collective program at a time per group). Stage
        # state is read under the TaskManager lock; the KV lease releases run
        # AFTER it drops (durable-store I/O must not ride a hot lock)
        from ballista_tpu_torch.scheduler.execution_graph import STAGE_RUNNING

        expired_gids: list[str] = []
        with self.tasks._lock:
            for gid, (job_id, stage_id, attempt) in list(self._gang_inflight.items()):
                g = self.tasks.get_job(job_id)
                s = g.stages.get(stage_id) if g is not None else None
                if s is None or s.state != STAGE_RUNNING or s.attempt != attempt or not s.gang:
                    expired_gids.append(gid)
        for gid in expired_gids:
            del self._gang_inflight[gid]
            self._release_gang_group(gid)
        # still-running gangs keep their cross-scheduler lease alive
        self._renew_gang_markers()
        # phase 1 (TaskManager lock): pick the gang-eligible fully-unbound
        # stages. Stage/graph state mutates under this lock, so the scan
        # holds it — but only the scan: the KV lease claims below are I/O
        candidates: list[tuple[ExecutionGraph, object]] = []
        with self.tasks._lock:
            for g in self.tasks.active_jobs():
                for s in sorted(g.running_stages(), key=lambda s: s.stage_id):
                    plan = s.resolved_plan
                    if plan is None or getattr(s, "no_gang", False):
                        continue
                    if getattr(s, "ici_exchange_ids", None):
                        # a promoted ICI stage rides ONE fat executor's mesh
                        # (bind_task pins it); scattering its tasks across a
                        # mesh group would fight the pin — gang scheduling stays
                        # for the opportunistic (non-promoted) fused stages
                        continue
                    if not self._gang_eligible_impl(plan, self._session_props(g.job_id)):
                        continue
                    if len(s.available_partitions()) != s.partitions:
                        continue  # partially bound/retried: not gang-safe
                    candidates.append((g, s))
        # phase 2: claim a group OUTSIDE the TaskManager lock, then re-check
        # and bind back under it. ``_revive_lock`` serializes every push-mode
        # binding pass, so between the phases the stage can only have LOST
        # its fully-unbound shape to a status update — the re-check catches
        # that and the freshly claimed lease is released again.
        batches: list["SchedulerServer._LaunchBatch"] = []
        for g, s in candidates:
            for gid, members in groups.items():
                if gid in self._gang_inflight:
                    continue
                size = len(members)
                if s.partitions < size or any(m.free_slots < 1 for m in members):
                    continue
                if not self._claim_gang_group(gid):
                    # another scheduler's lease holds this group: its gang
                    # attempt may still be entering its collective program
                    # — wait for the owner to release or its TTL to lapse;
                    # the claim is atomic, so two live
                    # schedulers can never both win the group
                    continue
                by_exec: Optional[dict[str, list[TaskDescriptor]]] = None
                with self.tasks._lock:
                    avail = s.available_partitions()
                    if len(avail) == s.partitions:
                        by_exec = {}
                        for p in avail:
                            m = members[p % size]
                            d = g.bind_task(s.stage_id, p, m.executor_id)
                            if d is not None:
                                by_exec.setdefault(m.executor_id, []).append(d)
                        s.gang = True
                if by_exec is None:
                    self._release_gang_group(gid)
                    break  # stage no longer gang-safe: stop trying groups
                self._gang_inflight[gid] = (g.job_id, s.stage_id, s.attempt)
                tag = f"{g.job_id}-{s.stage_id}-{s.attempt}"
                log.info("gang launch %s over mesh group (%d members)", tag, size)
                launches = []
                for m in members:
                    descs = by_exec.get(m.executor_id, [])
                    # one slot per task: statuses release one slot each
                    m.free_slots = max(0, m.free_slots - len(descs))
                    extra = {
                        "ballista.tpu.mesh_group.tag": tag,
                        "ballista.tpu.mesh_group.size": str(size),
                        "ballista.tpu.mesh_group.process_id": str(m.mesh_group_process_id),
                    }
                    launches.append((m.executor_id, descs, extra))
                batches.append((True, launches))
                break
        return batches

    # ---- persisted gang-in-flight markers (HA) ----------------------------------
    # The in-memory _gang_inflight map protects a mesh group within ONE
    # scheduler process; these KV LEASES extend the protection across HA
    # peers: a scheduler must not gang-launch onto a group whose current
    # lease belongs to another (possibly dead) scheduler — a group's members
    # must enter their collective programs in one order. The lease primitive
    # makes the claim ATOMIC (two live schedulers cannot both win a group),
    # and it is RENEWED every revive tick while the gang runs, so a long gang
    # is protected indefinitely; only a dead owner's lease lapses (TTL).
    _GANG_RELEASE_TTL = 0.001  # same-owner re-lock with ~zero ttl == release

    def _claim_gang_group(self, gid: str) -> bool:
        if self.state_store is None:
            return True
        try:
            return self.state_store.kv.lock(
                "GangInflight", gid, self.scheduler_id,
                self.config.gang_inflight_ttl_seconds,
            )
        except Exception:  # noqa: BLE001 - unreachable KV: fail open (local
            # bookkeeping still protects this process)
            log.warning("gang lease claim failed for group %s", gid, exc_info=True)
            return True

    def _renew_gang_markers(self) -> None:
        if self.state_store is None:
            return
        for gid in self._gang_inflight:
            try:
                self.state_store.kv.lock(
                    "GangInflight", gid, self.scheduler_id,
                    self.config.gang_inflight_ttl_seconds,
                )
            except Exception:  # noqa: BLE001
                log.warning("gang lease renewal failed for %s", gid, exc_info=True)

    def _release_gang_group(self, gid: str) -> None:
        if self.state_store is None:
            return
        try:
            self.state_store.kv.lock(
                "GangInflight", gid, self.scheduler_id, self._GANG_RELEASE_TTL
            )
        except Exception:  # noqa: BLE001
            log.warning("gang lease release failed for %s", gid, exc_info=True)

    @staticmethod
    def _gang_eligible_impl(plan, props: dict[str, str]) -> bool:
        """Mirror of the engine-side multihost condition: gang scheduling only
        helps when the engine will actually run a collective program across
        the group — a node ``torch_engine.gang_collectives`` finds, on the
        torch backend with the ICI shuffle enabled. Anything else split across
        a group would make every member materialize the whole exchange locally
        (group_size x the work) and inherit whole-stage-restart semantics for
        nothing."""
        if props.get("ballista.executor.backend", "torch") == "numpy":
            return False
        if props.get("ballista.tpu.ici_shuffle", "true").lower() in ("false", "0", "no"):
            return False
        from ballista_tpu_torch.engine.torch_engine import gang_collectives

        return bool(gang_collectives(plan))

    def _launch_multi(
        self,
        executor_id: str,
        descs: list[TaskDescriptor],
        extra_props: Optional[dict[str, str]] = None,
    ):
        groups: dict[tuple, list[TaskDescriptor]] = {}
        for d in descs:
            groups.setdefault((d.job_id, d.stage_id, d.stage_attempt), []).append(d)
        multi = []
        for (job_id, stage_id, attempt), ds in groups.items():
            props = self._session_props(job_id)
            props.update(self._trace_props(job_id, stage_id, attempt))
            props.update(self._precompile_props(job_id, stage_id))
            if extra_props:
                props = {**props, **extra_props}
            multi.append(
                pb.MultiTaskDefinition(
                    job_id=job_id, stage_id=stage_id, stage_attempt=attempt,
                    plan=encode_physical(ds[0].plan),
                    tasks=[
                        pb.TaskSlot(task_id=d.task_id, partition_id=d.partition,
                                    task_attempt=d.task_attempt)
                        for d in ds
                    ],
                    props=props,
                )
            )
        e = self.cluster.get(executor_id)
        if e is None:
            raise ConnectionError(f"executor {executor_id} no longer registered")
        from ballista_tpu_torch.utils import faults

        def _rpc():
            # the fault point sits INSIDE the retried callable: an injected
            # rpc.launch:unavailable@n=1 fails exactly one attempt and the
            # backoff retry absorbs it — the executor is never removed
            faults.check("rpc.launch", {"executor_id": executor_id})
            r = self._stub(e).LaunchMultiTask(
                pb.LaunchMultiTaskParams(
                    multi_tasks=multi, scheduler_id=self.scheduler_id
                ),
                timeout=10,
            )
            if not r.success:
                # terminating executor declined: not transient, don't retry
                raise SchedulerError(f"executor {executor_id} declined launch")
            return r

        call_with_retry(
            _rpc, policy=self._rpc_retry_policy(),
            description=f"launch->{executor_id}",
        )

    def _rpc_retry_policy(self) -> RetryPolicy:
        return RetryPolicy(
            attempts=self.config.executor_rpc_attempts,
            base_delay_s=self.config.executor_rpc_base_delay_seconds,
            deadline_s=self.config.executor_rpc_deadline_seconds,
        )

    def _cancel_running_tasks(self, job_id: str):
        g = self.tasks.get_job(job_id)
        if g is None:
            return
        # collect under the TaskManager lock (live stages mutate under it);
        # the cancel RPCs below retry with backoff and must run lock-free
        infos: dict[str, list[pb.RunningTaskInfo]] = {}
        with self.tasks._lock:
            for s in g.stages.values():
                for t in s.running_tasks():
                    infos.setdefault(t.executor_id, []).append(
                        pb.RunningTaskInfo(
                            task_id=t.task_id,
                            partition=pb.PartitionId(
                                job_id=job_id, stage_id=s.stage_id, partition_id=t.partition
                            ),
                        )
                    )
        from ballista_tpu_torch.utils import faults

        for ex_id, tasks in infos.items():
            e = self.cluster.get(ex_id)
            if e is None:
                continue
            try:
                # retried under the shared policy: a transient blip must not
                # leave a cancelled job's tasks burning device time
                call_with_retry(
                    lambda e=e, tasks=tasks: (
                        faults.check("rpc.cancel", {"executor_id": e.executor_id}),
                        self._stub(e).CancelTasks(
                            pb.CancelTasksParams(task_infos=tasks), timeout=5
                        ),
                    ),
                    policy=self._rpc_retry_policy(),
                    description=f"cancel->{ex_id}",
                )
            except Exception:  # noqa: BLE001 - cancellation is best-effort
                pass

    def _cancel_spec_losers(self, losers: list[tuple[str, str, str]]) -> None:
        """Best-effort CancelTasks for speculative-race losers
        ((job_id, executor_id, task_id) triples; docs/elasticity.md)."""
        by_exec: dict[str, list[pb.RunningTaskInfo]] = {}
        for job_id, ex_id, task_id in losers:
            by_exec.setdefault(ex_id, []).append(
                pb.RunningTaskInfo(
                    task_id=task_id, partition=pb.PartitionId(job_id=job_id)
                )
            )
        from ballista_tpu_torch.utils import faults

        for ex_id, infos in by_exec.items():
            e = self.cluster.get(ex_id)
            if e is None:
                continue
            try:
                faults.check("rpc.cancel", {"executor_id": ex_id})
                self._stub(e).CancelTasks(
                    pb.CancelTasksParams(task_infos=infos), timeout=5
                )
            except Exception:  # noqa: BLE001 - the loser's success/failure is
                # ignored by the seal gate either way; cancellation only
                # frees the slot sooner
                log.debug("spec-loser cancel to %s failed", ex_id, exc_info=True)

    # ---- elastic executors (docs/elasticity.md) ---------------------------------------
    def drain_executor(self, executor_id: str, grace_s: Optional[float] = None) -> bool:
        """Begin a voluntary, drain-safe scale-down of one executor: ACTIVE ->
        TERMINATING (no new tasks), then the scale controller's drain state
        machine waits out running tasks + the shuffle-serve grace window
        before deregistering. Exposed to the ScaleController and the REST API
        (PATCH /api/scale/drain/{id})."""
        ok = self.cluster.begin_drain(
            executor_id,
            self.scale.drain_grace_s if grace_s is None else grace_s,
        )
        if ok:
            self.scale.drains_started_total += 1
            # no NEW job may adopt cached pieces off a departing executor;
            # in-flight readers are covered by the spliced graph inputs the
            # drain's executor_output_referenced check already sees
            self.exchange_cache.invalidate_executor(executor_id)
            self._persist_exchange_cache()
            log.info("drain initiated for executor %s", executor_id)
        return ok

    def stop_drained_executor(self, executor_id: str) -> None:
        """Finish a drain. Push-mode executors get a graceful StopExecutor
        (their own drain is already empty; ExecutorStopped deregisters) and
        the registry entry is removed — removal runs executor_lost, which is
        a no-op when the drain waited out every reference, and a clean
        lineage re-run (never a job failure) when the grace deadline forced
        it. PULL-mode executors with no local stopper have no control
        channel: the entry stays TERMINATING (polls get no tasks, shuffle
        still serves) until the process owner stops it — its
        ExecutorStopped, or missed heartbeats on the terminating grace,
        deregister it then."""
        e = self.cluster.get(executor_id)
        if e is None:
            return
        if self.config.scheduling_policy == "push":
            try:
                self._stub(e).StopExecutor(
                    pb.StopExecutorParams(force=False), timeout=5
                )
            except Exception:  # noqa: BLE001 - best-effort; expiry reaps it
                log.debug("StopExecutor to %s failed", executor_id, exc_info=True)
            self._remove_executor(executor_id)

    # ---- serving helpers (docs/serving.md) --------------------------------------------
    def _set_override(self, job_id: str, state: str, err: str = "") -> None:
        with self._cancel_lock:
            self._set_override_locked(job_id, state, err)

    @concurrency.guarded_by("_cancel_lock")
    def _set_override_locked(self, job_id: str, state: str, err: str = "") -> None:
        self._job_overrides[job_id] = (state, err)
        self._job_overrides.move_to_end(job_id)
        while len(self._job_overrides) > self._job_overrides_cap:
            victim = next(
                (k for k, (s, _) in self._job_overrides.items() if s != "QUEUED"),
                None,
            )
            if victim is None:
                break  # all QUEUED (still pending): never evict those
            self._job_overrides.pop(victim)

    def _admission_release(self, job_id: str) -> None:
        """A job left the running set: dequeue the next admitted job(s) by
        weighted fair share and dispatch them (outside the controller lock)."""
        for dispatch in self.admission.release(job_id):
            dispatch()

    def _on_quarantine(self, executor_id: str) -> None:
        """Quarantine entry must not strand fair shares: ICI stages pinned to
        the executor restart so their queued tasks re-offer elsewhere under
        the same tenant weight (docs/serving.md)."""
        # a quarantined executor still SERVES shuffle files, but adopting a
        # cached exchange whose pieces live on a failing host would convert
        # a cheap miss into a likely mid-job lineage rollback — invalidate
        self.exchange_cache.invalidate_executor(executor_id)
        self._persist_exchange_cache()
        n = self.tasks.executor_quarantined(executor_id)
        if n:
            log.info(
                "restarted %d ICI-pinned stage(s) off quarantined executor %s",
                n, executor_id,
            )
            if self.config.scheduling_policy == "push":
                self._push_pool.submit(self.revive_offers)

    # ---- cross-query exchange cache (docs/serving.md) ---------------------------
    def _adopt_cached_exchanges(
        self, graph, tdigest: str, n_devices: int, device_kinds,
        digest_memo: Optional[dict] = None,
    ) -> list:
        """Key every cacheable hash-exchange producer stage of a freshly
        built graph and adopt cached materializations: a hit reconstructs
        the stage as already-successful (``satisfy_stage_from_cache``), so
        no task of it ever launches. Entries naming a non-schedulable
        executor are invalidated and treated as misses; a PV008 schema/
        partition-count drift finding aborts the submission. Returns the
        leased entries (released on every job exit path)."""
        from ballista_tpu_torch.analysis import errors_of
        from ballista_tpu_torch.analysis.plan_verifier import (
            verify_exchange_resolution,
        )
        from ballista_tpu_torch.scheduler.serving import (
            exchange_cache_key,
            exchange_digest,
        )

        adopted: list = []
        try:
            live = {e.executor_id for e in self.cluster.alive_executors()}
            for sid in sorted(graph.stages):
                s = graph.stages[sid]
                if sid == graph.final_stage_id:
                    continue
                if digest_memo is not None and sid in digest_memo:
                    dig = digest_memo[sid]
                else:
                    dig = exchange_digest(s.plan)
                    if digest_memo is not None:
                        digest_memo[sid] = dig
                if dig is None:
                    continue
                s.exchange_digest = dig
                s.exchange_key = exchange_cache_key(
                    dig, tdigest, n_devices, device_kinds
                )
                entry = self.exchange_cache.acquire(s.exchange_key)
                if entry is None:
                    continue
                if not entry.executor_ids() <= live:
                    # pieces on a lost/quarantined/draining executor: a
                    # guaranteed mid-job rollback — drop the entry, recompute
                    self.exchange_cache.release(entry)
                    self.exchange_cache.invalidate_key(s.exchange_key)
                    self.exchange_cache.note_rejected()
                    continue
                errs = errors_of(verify_exchange_resolution(s.plan, entry))
                if errs:
                    # schema/partition drift can only mean cache corruption:
                    # fail LOUDLY at admission (the finding names the knob),
                    # and drop the entry so it cannot hit again
                    self.exchange_cache.release(entry)
                    self.exchange_cache.invalidate_key(s.exchange_key)
                    raise PlanVerificationError(errs)
                if graph.satisfy_stage_from_cache(sid, entry.tasks):
                    s.exchange_entry_gen = entry.gen
                    adopted.append(entry)
                    self.exchange_cache.note_adopted(entry)
                    log.info(
                        "job %s: exchange cache hit — stage %d resolved from "
                        "job %s stage %d (%d tasks skipped)",
                        graph.job_id, sid, entry.job_id, entry.stage_id,
                        len(entry.tasks),
                    )
                else:  # shape mismatch the verifier could not see: miss
                    self.exchange_cache.release(entry)
                    self.exchange_cache.note_rejected()
        except Exception:
            for entry in adopted:
                self.exchange_cache.release(entry)
            raise
        return adopted

    def _register_exchanges(self, graph) -> None:
        """On job completion, register every cacheable hash-exchange
        producer stage's SEALED piece locations + measured sizes for
        cross-job reuse. Stages that were themselves satisfied from cache
        re-register nothing (their pieces belong to the original producer
        job — re-keying them here would re-pin the wrong job)."""
        if not getattr(graph, "exchange_cache_enabled", False):
            return
        from ballista_tpu_torch.config import (
            BALLISTA_SERVING_EXCHANGE_CACHE_BYTES,
            BALLISTA_SERVING_EXCHANGE_CACHE_TTL_S,
        )
        from ballista_tpu_torch.scheduler.execution_graph import (
            STAGE_SUCCESSFUL as _DONE,
        )
        from ballista_tpu_torch.scheduler.serving import ExchangeEntry

        # session overrides (docs/serving.md): a session may bound how long
        # its exchanges stay adoptable (per-entry TTL) and how many bytes
        # one of its exchanges may pin (registration cap) — the cache-wide
        # budget/TTL stay scheduler process config
        session = self.sessions.get(graph.session_id, {})
        entry_ttl = 0.0
        entry_cap = 0
        try:
            cfg = BallistaConfig(session)
            if BALLISTA_SERVING_EXCHANGE_CACHE_TTL_S in session:
                entry_ttl = max(0.0, cfg.get(BALLISTA_SERVING_EXCHANGE_CACHE_TTL_S))
            if BALLISTA_SERVING_EXCHANGE_CACHE_BYTES in session:
                entry_cap = max(0, cfg.get(BALLISTA_SERVING_EXCHANGE_CACHE_BYTES))
        except Exception:  # noqa: BLE001 - bad session values: defaults
            pass
        registered = False
        for sid, s in graph.stages.items():
            if (
                s.exchange_key is None
                or getattr(s, "from_cache", False)
                or s.state != _DONE
            ):
                continue
            tasks = []
            total = 0
            for t in s.task_infos:
                if t is None or t.status != "success":
                    tasks = []
                    break
                tasks.append({
                    "executor_id": t.executor_id,
                    "locations": [dict(l) for l in t.locations],
                })
                total += sum(
                    int(l.get("num_bytes", 0) or 0) for l in t.locations
                )
            if not tasks:
                continue
            if entry_cap and total > entry_cap:
                continue  # over the session's per-exchange registration cap
            entry = ExchangeEntry(
                s.exchange_key, graph.job_id, sid,
                _schema_digest_json(s.plan.schema()),
                s.plan.output_partitions(), tasks, total, time.time(),
                ttl_s=entry_ttl,
            )
            registered = self.exchange_cache.register(entry) or registered
        if registered:
            self._persist_exchange_cache()

    def _exchange_release(self, job_id: str) -> None:
        """A consumer job ended (any outcome): release its leases so the
        entries it adopted become evictable and zombie pins can drain."""
        with self._exchange_lock:
            entries = self._exchange_refs.pop(job_id, [])
        for entry in entries:
            self.exchange_cache.release(entry)

    def _on_exchange_unpin(self, job_id: str) -> None:
        """The last cache entry pinning a producer job's shuffle data is
        gone: run the cleanup that was deferred while the pin held."""
        with self._exchange_lock:
            deferred = job_id in self._deferred_cleans
            self._deferred_cleans.discard(job_id)
        if not deferred:
            return
        ev = getattr(self, "events", None)
        if ev is not None:
            from ballista_tpu_torch.scheduler.query_stage_scheduler import (
                JobDataClean,
            )

            ev.post(JobDataClean(job_id))
        else:  # no event loop (unit tests / direct embedding): clean inline
            self._push_pool.submit(
                self.clean_job_data, pb.CleanJobDataParams(job_id=job_id), None
            )

    def _persist_exchange_cache(self) -> None:
        if self.state_store is None:
            return
        try:
            self.state_store.save_exchange_cache(self.exchange_cache.to_json())
        except Exception:  # noqa: BLE001 - durability is best-effort
            log.debug("exchange cache persist failed", exc_info=True)

    def _restore_exchange_cache(self) -> None:
        """HA restart: reload registered entries (reader refcounts drop to
        zero — the old process's consumers are gone; restored graphs simply
        re-run). Entries naming executors that never re-register are
        invalidated on the usual loss paths."""
        try:
            n = self.exchange_cache.load_json(
                self.state_store.load_exchange_cache()
            )
        except Exception:  # noqa: BLE001 - a flaky KV must not block startup
            log.warning("exchange cache restore failed", exc_info=True)
            return
        if n:
            log.info("restored %d exchange-cache entries from durable state", n)

    def serving_stats(self) -> dict:
        """Serving-layer counters for /api/serving, /api/metrics and the UI:
        cache hit/miss/eviction totals, admission queue depth, per-tenant
        running slots (quarantine-adjusted) and offered-task totals."""
        running = self.tasks.running_slots_by_tenant()
        offered = self.tasks.offered_snapshot()
        tenants = {
            t: {
                "running_slots": running.get(t, 0),
                "offered_tasks": offered.get(t, 0),
            }
            for t in sorted(set(running) | set(offered))
        }
        return {
            "plan_cache": self.plan_cache.stats(),
            "exchange_cache": self.exchange_cache.stats(),
            "admission": self.admission.stats(),
            "tenants": tenants,
            # offers folded out of the bounded per-tenant map (ephemeral
            # session-id tenants with no active jobs)
            "offered_evicted": self.tasks.offered_evicted,
        }

    # ---- helpers ---------------------------------------------------------------------
    def _session_props(self, job_id: str) -> dict[str, str]:
        """Session config forwarded to tasks (reference: task_manager.rs
        props -> execution_loop.rs -> engine config)."""
        g = self.tasks.get_job(job_id)
        if g is None:
            return {}
        return dict(self.sessions.get(g.session_id, {}))

    def _precompile_props(self, job_id: str, stage_id: int) -> dict[str, str]:
        """Launch-prop precompile hints: when stage N's tasks go out, piggyback
        the serialized TEMPLATE plans (shuffle leaves still unresolved) of the
        not-yet-runnable downstream stages plus a pass-through per-partition
        row estimate, so the executor's compile service AOT-compiles stage
        N+1's programs while stage N runs (docs/compile_pipeline.md). Purely
        advisory: executors that ignore or fail the hints compile inline."""
        g = self.tasks.get_job(job_id)
        if g is None:
            return {}
        from ballista_tpu_torch.config import BALLISTA_ENGINE_PRECOMPILE

        session = self.sessions.get(g.session_id, {})
        if str(session.get(BALLISTA_ENGINE_PRECOMPILE, "true")).lower() in (
            "false", "0", "no",
        ):
            return {}
        # hint assembly reads live stages/inputs and writes the per-graph
        # memos, all of which mutate under the TaskManager lock; the result
        # is memoized per (stage, attempt) so the hold is one-shot per launch
        with self.tasks._lock:
            return self._precompile_props_locked(g, stage_id)

    def _precompile_props_locked(self, g, stage_id: int) -> dict[str, str]:
        import base64

        stage = g.stages.get(stage_id)
        if stage is None or not stage.output_links:
            return {}
        # the full hint payload is memoized per (stage, attempt): pull mode
        # computes launch props once per TASK, and re-walking the downstream
        # closure + re-summing input locations for every task of a wide stage
        # is pure waste (the executor digest-dedups repeats anyway). Inputs
        # are frozen while an attempt runs, so the attempt key is sufficient.
        props_memo = getattr(g, "_hint_props_memo", None)
        if props_memo is None:
            props_memo = g._hint_props_memo = {}
        memo_key = (stage_id, stage.attempt)
        cached = props_memo.get(memo_key)
        if cached is not None:
            return dict(cached)
        # rows feeding THIS stage are exact (its producers completed); use
        # them as a pass-through estimate for the downstream reader's
        # per-partition input — a wrong estimate only wastes a background
        # candidate compile (the minimum bucket is always also compiled)
        in_rows = sum(
            int(p.get("num_rows", 0) or 0)
            for out in stage.inputs.values()
            for locs in out.partition_locations
            for p in locs
        )
        estimated = False
        if in_rows == 0 and not stage.inputs:
            # leaf-scan stage: no shuffle inputs to measure, but the scan
            # templates carry exact per-group parquet row counts recorded at
            # catalog registration (docs/shuffle.md "leaf-stage row
            # estimates") — estimate_rows folds them through the stage body
            # (filter/agg selectivity guesses), so the DIRECT consumers of a
            # leaf stage get a real pass-through estimate instead of rows=0
            # and their hint compiles start a whole stage earlier. The
            # completion-kick refinement still re-hints them with MEASURED
            # rows (the "est" flag below keeps it armed). Static per plan,
            # so hint payloads stay byte-identical across launches.
            from ballista_tpu_torch.plan.physical import (
                ParquetScanExec as _Scan,
                walk_physical as _walk,
            )

            scans = [
                n for n in _walk(stage.plan.input) if isinstance(n, _Scan)
            ]
            if scans and all(n.group_rows for n in scans):
                from ballista_tpu_torch.plan.physical_planner import estimate_rows

                try:
                    # catalog=None is safe because EVERY scan carries
                    # group_rows (checked above) — the estimator never
                    # dereferences the catalog then
                    in_rows = estimate_rows(stage.plan.input, None)
                    estimated = in_rows > 0
                except Exception:  # noqa: BLE001 - estimates are advisory
                    in_rows = 0
        from ballista_tpu_torch.config import BALLISTA_PRECOMPILE_HINTS
        from ballista_tpu_torch.scheduler.execution_graph import UNRESOLVED

        # TRANSITIVE downstream closure, not just direct consumers: a deep
        # stage's programs then get the whole upstream pipeline as their
        # compile window instead of only the parent stage's runtime. Row
        # estimates ride only the direct links (they're the pass-through
        # guess); farther stages hint rows=0, keeping their hint payloads
        # byte-identical across launches so the executor's digest dedup holds
        direct = set(stage.output_links)
        frontier = list(stage.output_links)
        downstream: list[int] = []
        while frontier:
            sid = frontier.pop()
            if sid in downstream:
                continue
            downstream.append(sid)
            d = g.stages.get(sid)
            if d is not None:
                frontier.extend(d.output_links)
        # stage templates are immutable: memoize their serialized form on the
        # graph (pull mode computes hints once per task launch)
        memo = getattr(g, "_hint_plan_b64", None)
        if memo is None:
            memo = g._hint_plan_b64 = {}
        hints = []
        for link in sorted(downstream):
            d = g.stages.get(link)
            if d is None or d.state != UNRESOLVED:
                continue  # already resolvable/running: inline compile is due
            if link not in memo:
                try:
                    memo[link] = base64.b64encode(encode_physical(d.plan)).decode()
                except Exception:  # noqa: BLE001 - unserializable template
                    memo[link] = None
            if memo[link] is None:
                continue
            hint = {
                "stage_id": link,
                "plan": memo[link],
                # direct consumers get the pass-through estimate and are
                # eligible for the executor's completion-kick refinement
                # (rows measured from real task output); transitive stages
                # stay at 0 so their payload is launch-invariant
                "direct": link in direct,
                "rows": (
                    in_rows // max(1, d.plan.input_partitions())
                    if link in direct else 0
                ),
            }
            if estimated and link in direct:
                # leaf-derived guess, not a measurement: the completion-kick
                # refinement stays armed for this hint (executor re-submits
                # it with measured rows once the first map task seals)
                hint["est"] = True
            hints.append(hint)
        out = {BALLISTA_PRECOMPILE_HINTS: json.dumps(hints)} if hints else {}
        props_memo[memo_key] = out
        return dict(out)

    def _trace_props(self, job_id: str, stage_id: int, stage_attempt: int) -> dict[str, str]:
        """Per-launch trace context: the executor's task span parents under
        the (deterministic) stage span of this attempt."""
        from ballista_tpu_torch.obs import tracing as obs

        g = self.tasks.get_job(job_id)
        if g is None or not getattr(g, "trace_id", None):
            return {}
        return {
            obs.TRACE_ID_PROP: g.trace_id,
            obs.PARENT_PROP: obs.stage_span_id(g.trace_id, stage_id, stage_attempt),
        }

    def _task_def(self, t: TaskDescriptor) -> pb.TaskDefinition:
        props = self._session_props(t.job_id)
        props.update(self._trace_props(t.job_id, t.stage_id, t.stage_attempt))
        props.update(self._precompile_props(t.job_id, t.stage_id))
        return pb.TaskDefinition(
            task_id=t.task_id,
            partition=pb.PartitionId(job_id=t.job_id, stage_id=t.stage_id, partition_id=t.partition),
            stage_attempt=t.stage_attempt,
            task_attempt=t.task_attempt,
            plan=encode_physical(t.plan),
            props=props,
            launch_time_ms=int(time.time() * 1000),
        )

    def _stub(self, e):
        key = f"{e.host}:{e.port}"
        if key not in self._executor_stubs:
            self._executor_stubs[key] = executor_stub(key)
        return self._executor_stubs[key]

    def _remove_executor(self, executor_id: str):
        self.cluster.remove(executor_id)
        # its cached exchange pieces died with it: future adoptions must
        # miss; consumers mid-read fall back via FetchFailed lineage
        self.exchange_cache.invalidate_executor(executor_id)
        self._persist_exchange_cache()
        n = self.tasks.executor_lost(executor_id)
        if n:
            log.info("reset %d tasks from lost executor %s", n, executor_id)
        if self.config.scheduling_policy == "push":
            self._push_pool.submit(self.revive_offers)

    def _renew_and_take_over_jobs(self) -> None:
        """HA: renew leases on owned jobs, then adopt any RUNNING job whose
        owner stopped renewing — a crashed scheduler's jobs resume here from
        the persisted graph (in-flight tasks were demoted on encode and simply
        re-run; completed shuffle output on executors is the durable artifact).
        Reference: try_acquire_job (cluster/mod.rs:349-352) + kv.rs:512."""
        ttl = self.config.job_lease_ttl_seconds
        owned = {g.job_id for g in self.tasks.active_jobs()}
        for job_id in owned:
            if not self.state_store.try_acquire_job(job_id, ttl):
                # lease lost (we stalled past ttl and a standby adopted the
                # job): stop driving it — two owners binding tasks for one
                # job is the split-brain the lease exists to prevent
                log.warning("lost lease on job %s; releasing local ownership", job_id)
                self.tasks.release_job(job_id)
                # no local finished/failed event will ever fire for a
                # released job: free its admission slot here or the gate
                # leaks one concurrency unit per takeover (and its exchange
                # leases, or the cache pins would never drain)
                self._exchange_release(job_id)
                self._admission_release(job_id)
        adopted = 0
        for job_id in self.state_store.list_jobs():
            if job_id in owned or self.tasks.get_job(job_id) is not None:
                continue
            raw = self.state_store.kv.get("JobStatus", job_id)
            if raw is None or json.loads(raw.decode()).get("status") != RUNNING:
                continue
            if not self.state_store.try_acquire_job(job_id, ttl):
                continue  # owner alive (lease held) or lost the race
            g = self.state_store.load_job(job_id)
            if g is None or g.status != RUNNING:
                continue
            self.tasks.submit_job(g)
            adopted += 1
            log.info("took over running job %s (owner lease expired)", job_id)
        if adopted and self.config.scheduling_policy == "push":
            self._push_pool.submit(self.revive_offers)

    def _persist(self, graph) -> None:
        if self.state_store is None:
            return
        try:
            from ballista_tpu_torch.scheduler.state_store import graph_to_json

            # snapshot under the TaskManager lock (a live graph's stages
            # mutate under it); the KV write runs after the lock drops so
            # durable-store latency never extends control-plane hold times
            with self.tasks._lock:
                graph_payload = json.dumps(graph_to_json(graph)).encode()
                status_payload = json.dumps(
                    {"status": graph.status, "error": graph.error}
                ).encode()
            self.state_store.save_job_json(
                graph.job_id, graph_payload, status_payload
            )
        except Exception as e:  # noqa: BLE001 - e.g. memory-table plans aren't durable
            log.debug("persist of %s skipped: %s", graph.job_id, e)

    def _restore_jobs(self) -> None:
        """Recover active jobs after a restart (reference: try_acquire_job
        ownership transfer + graph decode with Running demoted to Resolved)."""
        from ballista_tpu_torch.scheduler.execution_graph import RUNNING as JOB_RUNNING

        restored = 0
        try:
            job_ids = self.state_store.list_jobs()
        except Exception as e:  # noqa: BLE001 - a flaky KV at startup must
            # not crash the scheduler; the expiry loop's takeover scan
            # retries the restore once the KV is reachable again
            log.warning("job restore scan failed (KV unavailable): %s", e)
            return
        for job_id in job_ids:
            try:
                if not self.state_store.try_acquire_job(job_id):
                    continue
                g = self.state_store.load_job(job_id)
            except Exception as e:  # noqa: BLE001
                log.warning("could not restore job %s: %s", job_id, e)
                continue
            if g is not None and g.status == JOB_RUNNING:
                self.tasks.submit_job(g)
                restored += 1
        if restored:
            log.info("restored %d active jobs from durable state", restored)

    def _expiry_loop(self):
        last_resubmit = time.time()
        while not self._stop.wait(self.config.expire_dead_executors_interval_seconds):
            for e in self.cluster.expired_executors(
                self.config.executor_timeout_seconds,
                self.config.executor_termination_grace_period,
            ):
                log.warning("executor %s expired; removing", e.executor_id)
                self._remove_executor(e.executor_id)
            if self.state_store is not None:
                try:
                    self._renew_and_take_over_jobs()
                except Exception:  # noqa: BLE001 - HA scan must not kill the loop
                    log.exception("lease renewal / takeover scan failed")
            try:
                # elastic controller tick: progress drains; scale decisions
                # when enabled (hysteresis/cooldown inside)
                self.scale.tick()
            except Exception:  # noqa: BLE001 - scaling must not kill the loop
                log.exception("scale controller tick failed")
            try:
                # exchange-cache TTL sweep: expiry releases the producer
                # jobs' deferred shuffle-dir cleanups via the unpin callback
                if self.exchange_cache.expire():
                    self._persist_exchange_cache()
            except Exception:  # noqa: BLE001 - cache upkeep must not kill it
                log.exception("exchange cache expiry failed")
            # optional stuck-job re-kick (reference: job_resubmit_interval_ms)
            interval_ms = self.config.job_resubmit_interval_ms
            if (
                self.config.scheduling_policy == "push"
                and interval_ms
                and (time.time() - last_resubmit) * 1000 >= interval_ms
                and self.tasks.pending_tasks() > 0
            ):
                last_resubmit = time.time()
                self._push_pool.submit(self.revive_offers)
            elif (
                self.config.scheduling_policy == "push"
                and self.tasks.pending_tasks() > 0
                and any(
                    self.cluster.quarantine_state(e.executor_id) == "probation"
                    for e in self.cluster.alive_executors(include_quarantined=True)
                )
            ):
                # probation probe driver: with pending work and a cooled-off
                # executor, nothing else re-triggers an offer pass — the
                # expiry tick does. Mid-cooloff executors don't qualify
                # (placement would exclude them; the pass would no-op).
                self._push_pool.submit(self.revive_offers)
            elif (
                self.config.scheduling_policy == "push"
                and self.tasks.speculatable_count() > 0
            ):
                # speculation driver: in a stage's tail pending_tasks() is 0,
                # so only status-update revives or this tick can dispatch a
                # backup attempt once a straggler crosses its p50-multiple
                self._push_pool.submit(self.revive_offers)


def task_status_to_dict(ts: pb.TaskStatus) -> dict:
    d = {
        "task_id": ts.task_id,
        "job_id": ts.partition.job_id,
        "stage_id": ts.partition.stage_id,
        "partition": ts.partition.partition_id,
        "stage_attempt": ts.stage_attempt,
        "task_attempt": ts.task_attempt,
        # lifecycle timestamps (epoch ms, executor clock): queue-wait and
        # run-duration histograms on the scheduler read these
        "launch_time_ms": ts.launch_time_ms,
        "start_time_ms": ts.start_time_ms,
        "end_time_ms": ts.end_time_ms,
    }
    if ts.metrics:
        d["metrics"] = dict(ts.metrics)
    if ts.span_data:
        try:
            spans = json.loads(bytes(ts.span_data).decode())
            if isinstance(spans, list):
                d["spans"] = [s for s in spans if isinstance(s, dict)]
        except ValueError:
            pass  # malformed span payload must never fail the status update
    which = ts.WhichOneof("status")
    if which == "successful":
        d["status"] = "success"
        d["locations"] = [
            {
                "output_partition": p.output_partition,
                "path": p.path,
                "num_rows": p.num_rows,
                "num_bytes": p.num_bytes,
            }
            for p in ts.successful.partitions
        ]
    else:
        d["status"] = "failed"
        f = ts.failed
        reason = f.WhichOneof("reason")
        if reason == "fetch_partition_error":
            fe = f.fetch_partition_error
            d["failure"] = {
                "kind": "fetch", "executor_id": fe.executor_id,
                "map_stage_id": fe.map_stage_id, "map_partition_id": fe.map_partition_id,
                "message": fe.message,
            }
        elif reason == "task_killed":
            d["failure"] = {"kind": "killed"}
        else:
            d["failure"] = {
                "kind": "execution", "retryable": f.retryable, "message": f.error
            }
    return d
