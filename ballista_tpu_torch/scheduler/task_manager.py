"""TaskManager: active-job cache, submit/cancel, task status routing.

Reference analog: ``TaskManager``
(``arrow-ballista: ballista/scheduler/src/state/task_manager.rs``): 7-char
alphanumeric job ids, per-stage plan encoded once per launch batch, job
accounting for the REST API and metrics.
"""
from __future__ import annotations

import random
import string
import time
from typing import Callable, Optional

from ballista_tpu_torch.analysis import concurrency
from ballista_tpu_torch.plan.physical import PhysicalPlan
from ballista_tpu_torch.scheduler.execution_graph import (
    CANCELLED, ExecutionGraph, FAILED, RUNNING, SUCCESSFUL, TaskDescriptor,
)


def generate_job_id() -> str:
    # reference: 7 random alphanumeric chars starting with a letter
    first = random.choice(string.ascii_lowercase)
    rest = "".join(random.choices(string.ascii_lowercase + string.digits, k=6))
    return first + rest


class TaskManager:
    def __init__(self, trace_store=None, quarantine_state=None, recorder=None):
        self._lock = concurrency.make_rlock("TaskManager._lock")
        # active graphs are mutated by RPC/poll/status threads concurrently:
        # guarded (docs/static_analysis.md "Concurrency verifier"). Archived
        # graphs in completed_jobs are read-mostly and handed to clients/
        # tests lock-free by design, so that map stays plain.
        self.jobs: dict[str, ExecutionGraph] = concurrency.guarded_dict(
            "TaskManager.jobs", self._lock
        )
        self.completed_jobs: dict[str, ExecutionGraph] = {}
        self.queued: dict[str, float] = concurrency.guarded_dict(
            "TaskManager.queued", self._lock
        )
        # per-job span retention (obs.tracing.TraceStore); None = tracing off
        self.trace_store = trace_store
        # flight recorder (obs.metrics.FlightRecorder); None = not recording.
        # pop_tasks self-times into ballista_pop_tasks_seconds — it IS the
        # executor-poll hot path the GIL-saturation question hangs on.
        self.recorder = recorder
        # serving layer (docs/serving.md): weighted fair-share task offers.
        # quarantine_state(executor_id) -> "active"|"quarantined"|... is the
        # health signal — running tasks stranded on a quarantined executor
        # must not count toward their tenant's slot quota (a sick executor
        # would otherwise distort the share it can no longer serve).
        self._quarantine_state = quarantine_state
        # stride scheduling: each offered task advances its tenant's virtual
        # time by 1/weight; the tenant with the smallest vtime offers next
        self._vtime: dict[str, float] = {}
        # round-robin cursor WITHIN a tenant's jobs (fairness across a
        # tenant's own concurrent sessions/jobs)
        self._job_cursor: dict[str, int] = {}
        # per-tenant offered-task accounting (serving_bench's fairness metric
        # + the REST serving stats). BOUNDED: the default tenant is the
        # session id and the Flight SQL path mints a session per statement,
        # so without a cap this dict (and the /api/serving payload) would
        # grow by one entry per served statement forever — on overflow,
        # counts of tenants with no active jobs fold into offered_evicted.
        self.offered_by_tenant: dict[str, int] = concurrency.guarded_dict(
            "TaskManager.offered_by_tenant", self._lock
        )
        self.offered_evicted = 0
        self._offered_cap = 1024

    # ---- lifecycle ----------------------------------------------------------------
    def submit_job(self, graph: ExecutionGraph) -> None:
        with self._lock:
            # from here the graph is shared across scheduler threads: its
            # stage map joins the guarded set under THIS lock
            graph.attach_guard(self._lock)
            self.jobs[graph.job_id] = graph

    def get_job(self, job_id: str) -> Optional[ExecutionGraph]:
        with self._lock:
            return self.jobs.get(job_id) or self.completed_jobs.get(job_id)

    def active_jobs(self) -> list[ExecutionGraph]:
        with self._lock:
            return [g for g in self.jobs.values() if g.status == RUNNING]

    def all_jobs(self) -> list[ExecutionGraph]:
        with self._lock:
            return list(self.jobs.values()) + list(self.completed_jobs.values())

    def cancel_job(self, job_id: str) -> bool:
        with self._lock:
            g = self.jobs.get(job_id)
            if g is None or g.status != RUNNING:
                return False
            g.cancel()
            self._archive(job_id)
            return True

    def fail_job(self, job_id: str, message: str) -> None:
        with self._lock:
            g = self.jobs.get(job_id)
            if g is not None:
                g._fail_job(message)
                self._archive(job_id)

    def release_job(self, job_id: str) -> None:
        """HA: drop a job WITHOUT archiving — another scheduler owns it now;
        late task statuses for it are simply ignored."""
        with self._lock:
            self.jobs.pop(job_id, None)

    @concurrency.guarded_by("_lock")
    def _archive(self, job_id: str) -> None:
        g = self.jobs.pop(job_id, None)
        if g is not None:
            # archived graphs are read-mostly (summaries, exchange-cache
            # registration, tests): release the guard with the job
            g.detach_guard()
            self.completed_jobs[job_id] = g
            if self.trace_store is not None:
                # jobs ended off the task-status path (cancel, planner
                # fail_job) still carry undrained scheduler spans
                self.trace_store.add(job_id, g.take_trace_spans())

    # ---- task flow ------------------------------------------------------------------
    def pop_tasks(
        self, executor_id: str, max_tasks: int, device_count: int | None = None
    ) -> list[TaskDescriptor]:
        if self.recorder is None:
            return self._pop_tasks(executor_id, max_tasks, device_count)
        t0 = time.perf_counter()
        try:
            return self._pop_tasks(executor_id, max_tasks, device_count)
        finally:
            self.recorder.observe(
                "ballista_pop_tasks_seconds", time.perf_counter() - t0
            )

    def _pop_tasks(
        self, executor_id: str, max_tasks: int, device_count: int | None = None
    ) -> list[TaskDescriptor]:
        """Bind up to max_tasks available partitions to this executor,
        offering across active jobs by WEIGHTED ROUND-ROBIN over tenants
        (stride scheduling) instead of job-submission FIFO: each offered task
        advances its tenant's virtual time by 1/weight, so tenants with
        queued work split the executor's slots proportionally to their
        weights, and one tenant's flood can no longer starve the rest
        (docs/serving.md). Per-tenant slot quotas
        (``ballista.serving.tenant_slots``) cap a tenant's cluster-wide
        RUNNING tasks; tasks stranded on quarantined executors are excluded
        from the count (the health signal — a sick executor must not consume
        the tenant's quota with slots it cannot progress)."""
        out: list[TaskDescriptor] = []
        with self._lock:
            by_tenant: dict[str, list[ExecutionGraph]] = {}
            for g in self.active_jobs():
                by_tenant.setdefault(g.tenant, []).append(g)
            if not by_tenant:
                return out
            # shared stride entry rule (serving.admission.clamp_vtimes):
            # returning tenants enter at the current floor — immediately
            # competitive, no burst on virtual time "saved up" while idle
            from ballista_tpu_torch.scheduler.serving.admission import clamp_vtimes

            clamp_vtimes(self._vtime, by_tenant)
            self._job_cursor = {
                t: c for t, c in self._job_cursor.items() if t in by_tenant
            }
            # ONE pass over all jobs for every tenant's quarantine-adjusted
            # running count — this sits on the executor-poll hot path, and a
            # per-tenant rescan would be O(tenants x tasks) under lock
            counts = self._running_slots_all_locked()
            used = {t: counts.get(t, 0) for t in by_tenant}
            while len(out) < max_tasks and by_tenant:
                best = None
                for t, gs in by_tenant.items():
                    quota = max(g.tenant_slots for g in gs)
                    if quota > 0 and used[t] >= quota:
                        continue
                    if not any(g.available_task_count() for g in gs):
                        continue
                    if best is None or self._vtime[t] < self._vtime[best]:
                        best = t
                if best is None:
                    break
                gs = by_tenant[best]
                start = self._job_cursor.get(best, 0)
                popped = None
                for i in range(len(gs)):
                    g = gs[(start + i) % len(gs)]
                    d = g.pop_next_task(executor_id, device_count)
                    if d is not None:
                        popped = d
                        self._job_cursor[best] = (start + i + 1) % len(gs)
                        break
                if popped is None:
                    # the tenant has available tasks but none THIS executor
                    # can bind (ICI pin / thin executor): drop it from this
                    # call's candidate set, charge nothing against its share
                    del by_tenant[best]
                    continue
                out.append(popped)
                weight = max(0.001, max(g.share_weight for g in gs))
                self._vtime[best] += 1.0 / weight
                used[best] += 1
                self._note_offer_locked(best)
            # straggler work-stealing (docs/elasticity.md): leftover slots go
            # to BACKUP attempts of overdue tasks on other executors. Backups
            # are spare-capacity work and charge no tenant vtime/quota — they
            # only exist when the offer loop above found nothing to run.
            while len(out) < max_tasks:
                d = None
                for g in self.active_jobs():
                    d = g.pop_speculative_task(executor_id, device_count)
                    if d is not None:
                        break
                if d is None:
                    break
                out.append(d)
        return out

    def speculatable_count(self, now: Optional[float] = None) -> int:
        """How many overdue running tasks could get a backup attempt right
        now — the push-mode revive trigger (pending_tasks() is 0 in a
        stage's tail, so nothing else would drive a speculative offer pass).
        Shares ``ExecutionStage.overdue_partitions`` with the offer path so
        the trigger and the offer can never disagree."""
        if now is None:
            now = time.time()
        n = 0
        with self._lock:
            for g in self.active_jobs():
                for s in g.running_stages():
                    n += len(s.overdue_partitions(g.speculation_factor, now))
        return n

    def backlog_snapshot(self) -> tuple[int, int, list[int]]:
        """One LOCKED pass over the active jobs for the scale signal's
        inputs: (queued task-slots incl. speculatable backups, running
        attempts incl. backups, per-RUNNING-stage queued counts). A lock-free
        walk would race update_task_statuses mutating spec maps mid-iteration
        (docs/elasticity.md)."""
        from ballista_tpu_torch.scheduler.execution_graph import STAGE_RUNNING

        now = time.time()
        queued = 0
        running = 0
        per_stage: list[int] = []
        with self._lock:
            for g in self.active_jobs():
                for s in g.stages.values():
                    running += len(s.running_tasks())
                    if s.state == STAGE_RUNNING:
                        avail = len(s.available_partitions())
                        per_stage.append(avail)
                        queued += avail
                        queued += len(
                            s.overdue_partitions(g.speculation_factor, now)
                        )
        return queued, running, per_stage

    def offered_snapshot(self) -> dict[str, int]:
        """Locked copy of the per-tenant offered-task counters (REST/bench
        readers must not iterate the live map against pop_tasks)."""
        with self._lock:
            return dict(self.offered_by_tenant)

    @concurrency.guarded_by("_lock")
    def _note_offer_locked(self, tenant: str) -> None:
        self.offered_by_tenant[tenant] = self.offered_by_tenant.get(tenant, 0) + 1
        if len(self.offered_by_tenant) > self._offered_cap:
            active = {g.tenant for g in self.jobs.values()}
            for t in [t for t in self.offered_by_tenant if t not in active]:
                self.offered_evicted += self.offered_by_tenant.pop(t)

    @concurrency.guarded_by("_lock")
    def _running_slots_all_locked(self) -> dict[str, int]:
        """Cluster-wide RUNNING tasks per tenant in one pass over all jobs,
        excluding tasks on quarantined executors (see pop_tasks). Quarantine
        verdicts are memoized per executor for the scan — one callback per
        executor, not per task."""
        counts: dict[str, int] = {}
        verdicts: dict[str, bool] = {}
        for g in self.jobs.values():
            if g.status != RUNNING:
                continue
            for s in g.stages.values():
                for t in s.task_infos:
                    if t is None or t.status != "running":
                        continue
                    if self._quarantine_state is not None:
                        q = verdicts.get(t.executor_id)
                        if q is None:
                            q = (
                                self._quarantine_state(t.executor_id)
                                == "quarantined"
                            )
                            verdicts[t.executor_id] = q
                        if q:
                            continue
                    counts[g.tenant] = counts.get(g.tenant, 0) + 1
        return counts

    def running_slots_by_tenant(self) -> dict[str, int]:
        """Quarantine-adjusted running-slot counts per tenant (REST/UI)."""
        with self._lock:
            counts = self._running_slots_all_locked()
            tenants = {g.tenant for g in self.jobs.values() if g.status == RUNNING}
            return {t: counts.get(t, 0) for t in sorted(tenants)}

    def executor_quarantined(self, executor_id: str) -> int:
        """Re-offer work a quarantine would otherwise starve: ICI stages
        pinned to the quarantined executor restart so their queued tasks
        re-offer under the same share weight (docs/serving.md)."""
        n = 0
        with self._lock:
            for g in self.active_jobs():
                n += g.unpin_stages_on_executor(executor_id)
        return n

    def update_task_statuses(self, executor_id: str, statuses: list[dict]) -> list[tuple[str, str]]:
        """Returns [(job_id, event)] where event in updated|finished|failed."""
        by_job: dict[str, list[dict]] = {}
        for st in statuses:
            by_job.setdefault(st["job_id"], []).append(st)
        events: list[tuple[str, str]] = []
        with self._lock:
            for job_id, sts in by_job.items():
                g = self.jobs.get(job_id)
                if g is None:
                    continue
                for ev in g.update_task_status(executor_id, sts):
                    events.append((job_id, ev))
                if self.trace_store is not None:
                    # executor task/operator/shuffle spans ride the status
                    # updates; scheduler stage/job spans accumulate on the
                    # graph — both land in the per-job store here
                    for st in sts:
                        spans = st.get("spans")
                        if spans:
                            self.trace_store.add(job_id, spans)
                    self.trace_store.add(job_id, g.take_trace_spans())
                if g.status in (SUCCESSFUL, FAILED, CANCELLED):
                    self._archive(job_id)
        return events

    def stage_input_pieces(
        self, job_id: str, stage_id: int, input_stage_id: int, partition_id: int
    ) -> tuple[list[dict], bool, bool]:
        """Live piece feed source (docs/shuffle.md): the sealed pieces a
        pipelined consumer stage currently holds for one reduce partition of
        one producer stage. Locked — the scheduler thread propagates
        locations into the same lists. ``gone`` is True when the job is no
        longer running here (finished/failed/released to another scheduler):
        the polling executor stops waiting and FetchFails."""
        with self._lock:
            g = self.jobs.get(job_id)
            if g is None or g.status != RUNNING:
                return [], False, True
            pieces, complete, gone = g.stage_input_pieces(
                stage_id, input_stage_id, partition_id
            )
            # snapshot: the caller serializes these outside the lock
            return [dict(p) for p in pieces], complete, gone

    def pipeline_stats(self) -> dict:
        """Pipelined-shuffle counters across all jobs (/api/metrics)."""
        out = {"early_resolved": 0, "hbm_fallbacks": 0, "deadline_fallbacks": 0}
        with self._lock:
            for g in list(self.jobs.values()) + list(self.completed_jobs.values()):
                out["early_resolved"] += getattr(g, "pipeline_early_resolved", 0)
                out["hbm_fallbacks"] += getattr(g, "pipeline_hbm_fallbacks", 0)
                out["deadline_fallbacks"] += getattr(
                    g, "pipeline_deadline_fallbacks", 0
                )
        return out

    def megastage_stats(self) -> dict:
        """Megastage promotion/demotion counters across all jobs
        (/api/metrics, docs/megastage.md)."""
        out = {"promoted": 0, "demoted": 0}
        with self._lock:
            for g in list(self.jobs.values()) + list(self.completed_jobs.values()):
                out["promoted"] += getattr(g, "megastage_promoted", 0)
                out["demoted"] += getattr(g, "megastage_demoted", 0)
        return out

    def unbind_tasks(self, descs: list[TaskDescriptor]) -> int:
        """Un-bind tasks whose launch RPC failed after its retry budget: the
        executor never saw them, so they go straight back to available —
        surgical, unlike executor_lost (which also strips shuffle outputs and
        rolls consumers back). Stale descriptors (stage rolled back / task
        re-bound meanwhile) are skipped via the task-id check."""
        n = 0
        with self._lock:
            for d in descs:
                g = self.jobs.get(d.job_id)
                if g is None:
                    continue
                s = g.stages.get(d.stage_id)
                if s is None or s.attempt != d.stage_attempt:
                    continue
                t = s.task_infos[d.partition]
                if t is not None and t.task_id == d.task_id and t.status == "running":
                    s.task_infos[d.partition] = None
                    n += 1
        return n

    def executor_lost(self, executor_id: str) -> int:
        n = 0
        with self._lock:
            for g in self.active_jobs():
                n += g.reset_stages_on_lost_executor(executor_id)
        return n

    def pending_tasks(self) -> int:
        with self._lock:
            return sum(g.available_task_count() for g in self.active_jobs())

    # ---- elastic executors (docs/elasticity.md) ---------------------------------
    def running_tasks_on(self, executor_id: str) -> int:
        """Running attempts (primary + speculative) bound to an executor —
        the drain state machine waits for this to hit zero."""
        n = 0
        with self._lock:
            for g in self.active_jobs():
                for s in g.stages.values():
                    n += sum(
                        1 for t in s.running_tasks()
                        if t.executor_id == executor_id
                    )
        return n

    # a drained executor keeps serving a freshly-COMPLETED job's result
    # pieces this long past job end: the client's poll-then-fetch follows
    # the finish within milliseconds, but killing the process in that
    # window would fail the fetch (no lineage re-run covers a final-stage
    # read without the object-store tier)
    RESULT_SERVE_GRACE_S = 30.0

    def executor_output_referenced(self, executor_id: str) -> bool:
        """True when the executor's files may still be read: an ACTIVE job's
        unfinished consumer holds a shuffle-piece location naming it, or a
        job that COMPLETED within ``RESULT_SERVE_GRACE_S`` stored final
        RESULT partitions on it (the client fetches those over Flight right
        after the finish). The shuffle-serve half of the drain contract:
        deregistering early would force lineage re-runs — or fail a result
        fetch outright — so the drain waits, bounded by its grace deadline."""
        now = time.time()
        with self._lock:
            for g in self.active_jobs():
                for s in g.stages.values():
                    if s.state == SUCCESSFUL:  # == STAGE_SUCCESSFUL
                        continue  # done reading its inputs
                    for out in s.inputs.values():
                        for locs in out.partition_locations:
                            if any(
                                l.get("executor_id") == executor_id
                                for l in locs
                            ):
                                return True
        return self.executor_result_referenced(executor_id)

    def executor_result_referenced(self, executor_id: str) -> bool:
        """True while a job that COMPLETED within ``RESULT_SERVE_GRACE_S``
        stored final RESULT partitions on the executor. Checked SEPARATELY
        from shuffle references by the drain state machine: the drain
        deadline may abandon shuffle pieces (lineage re-runs recover them)
        but must NOT abandon fresh result pieces — no re-run covers a
        client's final-stage Flight fetch without the object-store tier.
        Inherently bounded by the grace window, so holding a drain on it
        cannot block scale-down indefinitely."""
        now = time.time()
        with self._lock:
            for g in list(self.jobs.values()) + list(self.completed_jobs.values()):
                if (
                    g.status == SUCCESSFUL
                    and g.end_time
                    and now - g.end_time < self.RESULT_SERVE_GRACE_S
                    and any(
                        l.get("executor_id") == executor_id
                        for l in g.output_locations
                    )
                ):
                    return True
        return False

    def take_stale_exchange_keys(self) -> list[str]:
        """Exchange-cache keys whose cached stages re-ran (their pieces
        proved gone), across all jobs — the scheduler invalidates these
        (docs/serving.md). Archived jobs included: the recompute can land on
        the job-final status batch."""
        out: list[str] = []
        with self._lock:
            for g in list(self.jobs.values()) + list(self.completed_jobs.values()):
                out.extend(g.take_stale_exchange_keys())
        return out

    def take_spec_cancellations(self) -> list[tuple[str, str, str]]:
        """(job_id, executor_id, task_id) losers of speculative races, across
        all jobs (archived ones included: a race can seal on the job-final
        status batch)."""
        out: list[tuple[str, str, str]] = []
        with self._lock:
            for g in list(self.jobs.values()) + list(self.completed_jobs.values()):
                for ex, tid in g.take_spec_cancellations():
                    out.append((g.job_id, ex, tid))
        return out
