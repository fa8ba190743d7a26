"""ExecutionGraph: the per-job DAG of stages and its fault-tolerance machine.

Reference analog: ``ExecutionGraph`` / ``ExecutionStage``
(``arrow-ballista: ballista/scheduler/src/state/execution_graph.rs`` and
``execution_graph/execution_stage.rs``). Stage lifecycle::

    Unresolved -> Resolved -> Running -> Successful
         ^            ^          |          |
         +-- rollback +----------+          +-- rerun (executor lost /
             (fetch failure)                     fetch failure on output)

Retry budgets: TASK_MAX_FAILURES=4 per partition, STAGE_MAX_FAILURES=4 stage
attempts (task_manager.rs:57-59). Fetch failures identify the *map* side
(executor, stage, partition) and trigger Spark-style lineage recovery: the
consumer rolls back to Unresolved minus the dead executor's inputs; the
producer re-runs its lost partitions (execution_graph.rs:342-399).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ballista_tpu_torch.errors import SchedulerError
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.scheduler.planner import (
    adaptive_join_reopt,
    apply_aqe,
    plan_query_stages,
    promote_ici_exchanges,
    promote_megastage,
    remove_unresolved_shuffles,
    rollback_resolved_shuffles,
    stage_dependencies,
)

TASK_MAX_FAILURES = 4
STAGE_MAX_FAILURES = 4

# straggler speculation (docs/elasticity.md): a backup attempt's task_attempt
# is primary_attempt + this offset, so it can never collide with a legitimate
# retry attempt (< TASK_MAX_FAILURES) — keeping the executor-side slot dedupe
# and the attempt-suffixed shuffle piece paths disjoint from the primary's
SPECULATIVE_ATTEMPT_OFFSET = TASK_MAX_FAILURES
# don't speculate on tasks younger than this even when the p50 multiple says
# so: sub-50ms tasks finish before the backup could launch
SPECULATION_MIN_RUNTIME_S = 0.05
# ceiling on how much extra leeway a large input buys in the size-normalized
# straggler test (docs/adaptive.md): real task duration is overhead + c*bytes,
# not proportional to bytes — an uncapped per-byte rate fitted from small,
# overhead-dominated samples would make a huge partition effectively exempt
# from backups (the stages skew splitting exists for)
SPECULATION_SIZE_CAP = 8.0
# completed-duration samples kept per stage for the p50 estimate
MAX_DURATION_SAMPLES = 1024


# pipelined shuffle (docs/shuffle.md): a feed-originated FetchFailed carries
# this marker so the graph can fall the stage back to barrier semantics
# instead of early-resolving again into the same wait (single definition in
# shuffle/feed.py — the layer that mints the failures)
from ballista_tpu_torch.shuffle.feed import PIPELINE_WAIT_MARKER  # noqa: E402


def pipeline_eligible_plan(writer: "P.ShuffleWriterExec") -> bool:
    """Can this stage template consume its shuffle input as a LIVE stream?

    Conservative mirror of the engines' chunkwise-streamable shapes
    (``_stream_maker`` / ``_chunkwise_device``): exactly ONE shuffle leaf,
    reached from the writer through nothing but Filter/Project and at most
    one final-mode HashAggregate (the final-agg-over-partial-agg shape).
    Anything else — joins (their build side materializes one-shot), sorts,
    windows, merges, inline exchanges (gang/ICI collectives) — keeps
    barrier semantics: early-launching them would not overlap anything or,
    worse, would block the whole stage on the first unsealed piece."""
    leaves = [
        n for n in P.walk_physical(writer.input)
        if isinstance(n, P.UnresolvedShuffleExec)
    ]
    if len(leaves) != 1:
        return False
    node = writer.input
    seen_agg = False
    while True:
        if isinstance(node, P.UnresolvedShuffleExec):
            return True
        if isinstance(node, (P.FilterExec, P.ProjectExec)):
            node = node.input
            continue
        if (
            isinstance(node, P.HashAggregateExec)
            and node.mode == "final"
            and not seen_agg
        ):
            seen_agg = True
            node = node.input
            continue
        return False


def _parse_ici_demote(message: str) -> list[int]:
    """Exchange ids out of an ``ICI_DEMOTE[1,2]: reason`` failure marker."""
    try:
        inner = message.split("ICI_DEMOTE[", 1)[1].split("]", 1)[0]
        return [int(x) for x in inner.split(",") if x.strip()]
    except (IndexError, ValueError):
        return []

def _pending_wait_of(status: dict) -> float:
    """Producer-wait seconds a pipelined consumer task reported
    (op.PendingWait.time_s) — excluded from its straggler-p50 sample."""
    try:
        return float(status.get("metrics", {}).get("op.PendingWait.time_s", 0.0))
    except (TypeError, ValueError):
        return 0.0


# job states (reference proto job_status oneof)
QUEUED = "QUEUED"
RUNNING = "RUNNING"
SUCCESSFUL = "SUCCESSFUL"
FAILED = "FAILED"
CANCELLED = "CANCELLED"

# stage states
UNRESOLVED = "UNRESOLVED"
RESOLVED = "RESOLVED"
STAGE_RUNNING = "RUNNING"
STAGE_SUCCESSFUL = "SUCCESSFUL"
STAGE_FAILED = "FAILED"


@dataclass
class TaskInfo:
    task_id: str
    partition: int
    attempt: int
    status: str  # "running" | "success" | "failed"
    executor_id: str
    locations: list[dict] = field(default_factory=list)  # ShuffleWritePartition dicts
    # bind wall time: feeds the straggler detector (completed-task duration
    # distribution vs running-task age)
    started_at: float = 0.0


@dataclass
class StageOutput:
    """Locations of a completed input stage, indexed by output partition."""

    partition_locations: list[list[dict]] = field(default_factory=list)
    complete: bool = False

    def add(self, loc: dict) -> None:
        j = loc["partition_id"]
        while len(self.partition_locations) <= j:
            self.partition_locations.append([])
        self.partition_locations[j].append(loc)

    def remove_executor(self, executor_id: str) -> bool:
        """Strip an executor's pieces; returns True if anything was removed."""
        return bool(self.remove_executor_pieces(executor_id))

    def remove_executor_pieces(self, executor_id: str) -> list[int]:
        """Strip an executor's pieces; returns the distinct MAP partitions
        (producer task partitions) whose output was lost — the set the
        producer must re-run (reference: remove_input_partitions)."""
        removed: set[int] = set()
        for locs in self.partition_locations:
            gone = [l for l in locs if l["executor_id"] == executor_id]
            if gone:
                locs[:] = [l for l in locs if l["executor_id"] != executor_id]
                removed.update(l.get("map_partition", 0) for l in gone)
        if removed:
            self.complete = False
        return sorted(removed)


class ExecutionStage:
    def __init__(self, stage_id: int, plan: P.ShuffleWriterExec, output_links: list[int]):
        self.stage_id = stage_id
        self.plan = plan  # with UnresolvedShuffleExec leaves (template)
        self.resolved_plan: Optional[P.ShuffleWriterExec] = None
        self.output_links = output_links
        self.inputs: dict[int, StageOutput] = {
            sid: StageOutput() for sid in stage_dependencies(plan)
        }
        if self.inputs:
            self.state = UNRESOLVED
        else:
            self.state = RESOLVED
            self.resolved_plan = plan  # leaf stage: nothing to resolve
        self.partitions = plan.input_partitions()
        # the STATIC task count the planner chose — resolve() may adapt the
        # actual count (AQE coalesce/skew, docs/adaptive.md); spans and
        # EXPLAIN ANALYZE report planned vs actual per exchange
        self.planned_partitions = self.partitions
        self.attempt = 0
        self.task_infos: list[Optional[TaskInfo]] = [None] * self.partitions
        self.task_failures: list[int] = [0] * self.partitions
        self.stage_metrics: dict[str, float] = {}
        # adaptive execution (docs/adaptive.md): set by the graph from
        # session config; apply_aqe runs at resolve() — the one moment the
        # inputs' MEASURED sizes are known and no task has launched
        self.aqe_enabled = False
        self.aqe_target_partition_bytes = 0
        self.aqe_skew_factor = 0.0
        self.aqe_hbm_budget_bytes = 0
        self.aqe_decisions: dict = {}
        # measured input bytes per (post-AQE) task partition, from the
        # resolved readers' piece stats: normalizes the straggler p50 test
        # so a legitimately-large partition stops triggering backups
        self.input_bytes: list[int] = []
        # straggler speculation (docs/elasticity.md): at most one BACKUP
        # attempt per partition, racing the primary on another executor;
        # the first sealed success wins (seal-once gate in
        # update_task_status), the loser is cancelled
        self.spec_infos: dict[int, TaskInfo] = {}
        # completed-task (duration, input_bytes) samples of the current
        # attempt (bounded): the size-normalized p50-multiple straggler
        # threshold reads this
        self.task_durations: list[tuple[float, int]] = []
        # wall time the current attempt started running (trace stage spans)
        self.started_at: Optional[float] = None
        # gang-launched over a mesh group this attempt: per-task outputs are
        # process-local SLICES of a collective program, so any task failure
        # restarts the whole attempt (mixed-path retries would double-count)
        self.gang = False
        # a previous gang attempt raised GANG_UNFUSABLE (deterministic for
        # this data): never gang-launch this stage again. Runtime-only state:
        # a scheduler restart re-tries the gang once, then re-learns this.
        self.no_gang = False
        # session broadcast threshold for resolution-time join re-optimization
        # (reference: to_resolved re-runs JoinSelection with fresh stats,
        # execution_stage.rs:341-368); set by the graph from session config
        self.broadcast_rows_threshold: int = 0
        # executor ids whose fetch failures caused the LAST rollback of this
        # stage — delayed duplicates from that attempt are ignored
        self.last_attempt_failure_reasons: set[str] = set()
        # pipelined shuffle (docs/shuffle.md): early-resolve this stage once
        # its producers are all launched and pipeline_min_fraction of the
        # input pieces sealed — unsealed pieces splice in as PENDING markers
        # the executor's live piece feed resolves as maps seal. Set by the
        # graph from session config; ``pipelined`` marks the CURRENT attempt
        # as early-resolved, ``no_pipeline`` pins the stage to barrier
        # semantics for the rest of the job (pending-piece deadline expiry,
        # or an HBM-governed AQE decision that freezing could invalidate).
        self.pipeline_enabled = False
        self.pipeline_min_fraction = 0.5
        self.pipelined = False
        self.no_pipeline = False
        self.pipeline_info: dict = {}
        self._pipeline_eligible_memo: Optional[bool] = None
        # cross-query exchange cache (docs/serving.md): the content digest of
        # this stage's exchange subtree (None = not cacheable) and whether
        # the stage was satisfied from a cached materialization instead of
        # running. The full cache key (digest + catalog/cluster signature)
        # is composed by the scheduler, which owns those signals.
        self.exchange_digest: Optional[str] = None
        self.exchange_key: Optional[str] = None
        self.from_cache = False
        # generation token of the ADOPTED cache entry: a stale report names
        # (key, gen) so it can never invalidate a fresh replacement entry
        # re-registered under the same key after a recompute
        self.exchange_entry_gen: Optional[str] = None
        # inline ICI exchange boundaries this stage's template carries: the
        # scheduler binds all of the stage's tasks onto ONE fat executor
        # (they share one engine; the collective computes once) and a runtime
        # ICI_DEMOTE report re-splits the named exchange onto the Flight tier
        self.ici_exchange_ids: list[int] = [
            n.exchange_id
            for n in P.walk_physical(plan)
            if isinstance(n, P.IciExchangeExec)
        ]

    def ici_pinned_executor(self) -> Optional[str]:
        """The fat executor this ICI stage's tasks are riding (first bound
        task's executor), or None when unbound / not an ICI stage."""
        if not self.ici_exchange_ids:
            return None
        for t in self.task_infos:
            if t is not None:
                return t.executor_id
        return None

    # ---- predicates ----------------------------------------------------------
    def resolvable(self) -> bool:
        return self.state == UNRESOLVED and all(o.complete for o in self.inputs.values())

    def pipeline_eligible(self) -> bool:
        """Template-level streamability (memoized; see
        :func:`pipeline_eligible_plan`). ICI-promoted stages are never
        eligible: their exchange is an inline collective with no
        materialized pieces to stream."""
        if self.ici_exchange_ids:
            return False
        if self._pipeline_eligible_memo is None:
            self._pipeline_eligible_memo = pipeline_eligible_plan(self.plan)
        return self._pipeline_eligible_memo

    def all_tasks_done(self) -> bool:
        return all(t is not None and t.status == "success" for t in self.task_infos)

    def available_partitions(self) -> list[int]:
        return [i for i, t in enumerate(self.task_infos) if t is None]

    def running_tasks(self) -> list[TaskInfo]:
        """Running attempts, primaries AND speculative backups — cancel
        fan-out and inflight accounting must see both."""
        out = [t for t in self.task_infos if t is not None and t.status == "running"]
        out.extend(t for t in self.spec_infos.values() if t.status == "running")
        return out

    # ---- transitions -----------------------------------------------------------
    def resolve(self) -> None:
        assert self.resolvable(), (self.stage_id, self.state)
        # DEEP-COPIED piece lists: the resolved plan is a frozen snapshot.
        # Splicing the live input lists by reference lets a later executor
        # loss empty them in place, and a re-run task would then "successfully"
        # read zero pieces — silent row loss (round-4 verify finding).
        locations = {
            sid: [list(pieces) for pieces in out.partition_locations]
            for sid, out in self.inputs.items()
        }
        committed = self._resolve_with(locations, early=False)
        assert committed

    def _resolve_with(self, locations: dict, early: bool) -> bool:
        """Shared resolution body. ``early`` = pipelined early-resolve with
        pending markers in ``locations`` (docs/shuffle.md): AQE then runs on
        sealed measured sizes + the markers' scheduler ESTIMATES and its
        decisions FREEZE at launch — except that when the HBM governor is
        active (aqe_hbm_budget_bytes > 0) a frozen estimate-based decision
        could change the governor's verdict once real sizes land, so such
        stages decline early resolution (return False, nothing mutated) and
        keep barrier semantics."""
        inner = remove_unresolved_shuffles(self.plan.input, locations)
        if self.broadcast_rows_threshold > 0:
            # adaptive re-optimization: the spliced readers carry the
            # producers' exact row counts — correct mis-estimated join builds
            # before the plan is frozen for launch
            inner = adaptive_join_reopt(inner, self.broadcast_rows_threshold)
        aqe_decisions: dict = {}
        if self.aqe_enabled and not self.ici_exchange_ids:
            # AQE (docs/adaptive.md): re-plan from the MEASURED piece sizes
            # now materialized in the spliced readers. ICI-promoted stages
            # are exempt (their exchange is an inline collective with no
            # materialized sizes); a demoted exchange re-enters here on the
            # demoted stage's next resolution.
            inner, aqe_decisions = apply_aqe(
                inner, self.aqe_target_partition_bytes, self.aqe_skew_factor,
                self.aqe_hbm_budget_bytes,
            )
            if early and aqe_decisions and self.aqe_hbm_budget_bytes > 0:
                return False  # freeze could flip the governor's verdict
        self.aqe_decisions = aqe_decisions
        self.resolved_plan = P.ShuffleWriterExec(
            self.plan.job_id, self.stage_id, inner, self.plan.partitioning,
            self.plan.dict_refs,
        )
        actual = self.resolved_plan.input_partitions()
        if actual != self.partitions:
            # post-AQE task boundaries: every downstream consumer of the
            # task list — binding, speculation offers, the push-mode revive,
            # spans — sees the ADAPTED count from here on
            self.partitions = actual
            self.task_infos = [None] * actual
            self.task_failures = [0] * actual
        self.input_bytes = self._resolved_input_bytes(inner)
        self.pipelined = early
        self.state = RESOLVED
        return True

    @staticmethod
    def _resolved_input_bytes(inner: P.PhysicalPlan) -> list[int]:
        """Measured input bytes per task partition, summed across the
        resolved shuffle readers' piece stats (the size-aware straggler
        normalization + EXPLAIN ANALYZE task sizing)."""
        readers = [
            n for n in P.walk_physical(inner) if isinstance(n, P.ShuffleReaderExec)
        ]
        if not readers:
            return []
        n = max(r.output_partitions() for r in readers)
        out = [0] * n
        for r in readers:
            for i, locs in enumerate(r.partition_locations):
                out[i] += sum(int(loc.get("num_bytes", 0) or 0) for loc in locs)
        return out

    def start_running(self) -> None:
        assert self.state == RESOLVED
        self.state = STAGE_RUNNING
        self.started_at = time.time()

    def succeed(self) -> None:
        assert self.state == STAGE_RUNNING and self.all_tasks_done()
        self.state = STAGE_SUCCESSFUL

    def fail(self) -> None:
        self.state = STAGE_FAILED

    def rollback_to_unresolved(self, failed_input_executors) -> None:
        """Fetch failure on an input: back to Unresolved, drop the bad input
        pieces, reset all tasks (new stage attempt). The failure reasons
        (executor ids) are remembered so DELAYED duplicates from the rolled-
        back attempt are ignored instead of burning further attempts
        (reference: last_attempt_failure_reasons, execution_stage.rs:119)."""
        if isinstance(failed_input_executors, str):
            failed_input_executors = {failed_input_executors}
        reasons = set(failed_input_executors or ())
        for ex in reasons:
            for out in self.inputs.values():
                out.remove_executor(ex)
        self.last_attempt_failure_reasons = reasons
        self.resolved_plan = None
        self.aqe_decisions = {}
        self.input_bytes = []
        self.pipelined = False
        self.pipeline_info = {}
        self.task_infos = [None] * self.partitions
        self.task_failures = [0] * self.partitions
        # stale backups of the rolled-back attempt reject on the attempt
        # check anyway; dropping them here keeps the spec map from leaking
        self.spec_infos = {}
        self.task_durations = []
        # drop the rolled-back attempt's merged metrics: the re-run attempt
        # re-reports them, and double-merging inflates the per-stage rows /
        # exec_time shown in the UI and API
        self.stage_metrics = {}
        self.attempt += 1
        self.state = UNRESOLVED

    def rerun_lost_partitions(self, lost_partitions: list[int]) -> None:
        """A successful producer lost some outputs: back to Running with only
        those partitions reset (reference: rerun_successful_stage)."""
        assert self.state == STAGE_SUCCESSFUL
        for p in lost_partitions:
            self.task_infos[p] = None
        self.spec_infos = {}
        self.attempt += 1
        # the rerun attempt's trace span must measure the rerun, not stretch
        # back to the original attempt's start
        self.started_at = time.time()
        self.state = STAGE_RUNNING

    def _input_bytes_of(self, partition: int) -> int:
        """Measured input bytes of a task partition, or 0 when unknown (leaf
        stages, merge stages whose one task reads every input partition)."""
        if len(self.input_bytes) != self.partitions:
            return 0
        return self.input_bytes[partition]

    def overdue_partitions(self, factor: float, now: float) -> list[int]:
        """Partitions eligible for a speculative BACKUP under the
        SIZE-NORMALIZED p50-multiple rule (docs/elasticity.md): tail phase
        only (no unstarted partitions), at least half the stage completed,
        primary older than ``max(floor, factor x p50(completed) x
        size_ratio)`` where ``size_ratio`` = the partition's measured input
        bytes over the completed samples' median bytes, clamped to
        ``[1, SPECULATION_SIZE_CAP]`` — a legitimately-LARGE partition
        (post-AQE skew slice, mis-balanced hash) gets proportional leeway
        instead of triggering useless backups, the clamp keeps a genuinely
        hung giant task speculatable (duration is overhead + c*bytes, never
        purely proportional), and small partitions keep the classic p50
        multiple. Stages without measured inputs (leaf scans) reduce to the
        unnormalized rule (ratio 1). Collective stages (gang / ICI-pinned)
        are never eligible. THE single eligibility rule — the offer path and
        the push-mode revive trigger both read it, so they cannot drift
        apart."""
        if factor <= 0 or self.gang or self.ici_exchange_ids:
            return []
        if self.state != STAGE_RUNNING or self.available_partitions():
            return []
        if self.pipelined and any(not o.complete for o in self.inputs.values()):
            # pipelined consumer with producers still running: task age is
            # dominated by producer-wait, and a backup would block on the
            # SAME pending pieces — never a useful race (docs/shuffle.md)
            return []
        done = sum(
            1 for t in self.task_infos if t is not None and t.status == "success"
        )
        if done < max(1, self.partitions // 2) or not self.task_durations:
            return []
        durs = sorted(d for d, _ in self.task_durations)
        p50 = durs[len(durs) // 2]
        sizes = sorted(b for _, b in self.task_durations)
        p50_bytes = sizes[len(sizes) // 2]

        def leeway(p: int) -> float:
            ratio = self._input_bytes_of(p) / max(1.0, p50_bytes)
            return min(SPECULATION_SIZE_CAP, max(1.0, ratio))

        return [
            p
            for p, t in enumerate(self.task_infos)
            if t is not None
            and t.status == "running"
            and t.started_at
            and now - t.started_at > max(
                SPECULATION_MIN_RUNTIME_S, factor * p50 * leeway(p)
            )
            and p not in self.spec_infos
        ]

    def merge_task_metrics(self, metrics: dict) -> None:
        """Merge one finished task's metrics into the stage (reference:
        RunningStage combined MetricsSet — display.rs). ``*.max_bytes``
        metrics are per-program PEAKS (HBM watermarks): the stage-level
        figure is the widest task, not the sum across tasks."""
        for k, v in metrics.items():
            if k.endswith(".max_bytes"):
                self.stage_metrics[k] = max(self.stage_metrics.get(k, 0.0), v)
            else:
                self.stage_metrics[k] = self.stage_metrics.get(k, 0.0) + v

    def note_duration(
        self, info: TaskInfo, now: float, pending_wait_s: float = 0.0
    ) -> None:
        """Record a completed attempt's (duration, input_bytes) sample for
        the size-normalized straggler p50 (see overdue_partitions).
        ``pending_wait_s`` — time the task spent blocked on unsealed pieces
        of a pipelined read (op.PendingWait.time_s) — is EXCLUDED so the p50
        baseline measures compute, not producer-wait: a pipelined consumer
        must not make its siblings look like stragglers (docs/shuffle.md)."""
        if info.started_at:
            self.task_durations.append(
                (
                    max(0.0, now - info.started_at - max(0.0, pending_wait_s)),
                    self._input_bytes_of(info.partition),
                )
            )
            if len(self.task_durations) > MAX_DURATION_SAMPLES:
                del self.task_durations[: -MAX_DURATION_SAMPLES]

    def reset_tasks_on_executor(self, executor_id: str, include_success: bool = False) -> int:
        """Reset this stage's tasks bound to an executor. ``include_success``
        also clears completed tasks whose shuffle output lived on it (their
        pieces are gone; the partition must re-run)."""
        n = 0
        for i, t in enumerate(self.task_infos):
            if t is None or t.executor_id != executor_id:
                continue
            if t.status == "running" or (include_success and t.status == "success"):
                # a surviving backup on a HEALTHY executor takes over the
                # slot instead of minting a third copy (it computes the same
                # partition; its attempt-suffixed output substitutes) —
                # mirrors the failed-primary promotion in update_task_status
                sp = self.spec_infos.get(i)
                if sp is not None and sp.executor_id != executor_id:
                    self.spec_infos.pop(i)
                    self.task_infos[i] = sp
                else:
                    self.task_infos[i] = None
                n += 1
        for p in [
            p for p, t in self.spec_infos.items() if t.executor_id == executor_id
        ]:
            del self.spec_infos[p]  # backup died with its executor
        return n


@dataclass
class TaskDescriptor:
    """What the scheduler hands an executor for one partition."""

    task_id: str
    job_id: str
    stage_id: int
    stage_attempt: int
    partition: int
    task_attempt: int
    plan: P.ShuffleWriterExec


class ExecutionGraph:
    """Reference: execution_graph.rs:103-132; single-writer discipline — the
    scheduler event loop owns all mutation."""

    def __init__(self, job_id: str, job_name: str, session_id: str, plan: P.PhysicalPlan,
                 fuse_exchange_max_rows: int = 0, broadcast_rows_threshold: int = 0,
                 trace_ctx: Optional[tuple[str, Optional[str]]] = None,
                 ici_shuffle: bool = False, ici_devices: int = 0,
                 ici_max_rows: int = 0, hbm_budget_bytes: int = 0,
                 megastage: bool = False, megastage_max_boundaries: int = 4,
                 aqe_enabled: bool = False, aqe_target_partition_bytes: int = 0,
                 aqe_skew_factor: float = 0.0,
                 pipeline_enabled: bool = False,
                 pipeline_min_fraction: float = 0.5):
        self.job_id = job_id
        self.job_name = job_name
        self.session_id = session_id
        self.status = RUNNING
        self.error: Optional[str] = None
        self.queued_at = time.time()
        self.start_time = time.time()
        self.end_time: Optional[float] = None
        self.output_locations: list[dict] = []
        # distributed tracing: (trace_id, client_root_span_id). Stage
        # scheduling events + the job span are recorded into trace_spans and
        # drained by the TaskManager into the scheduler's TraceStore.
        self.trace_id: Optional[str] = trace_ctx[0] if trace_ctx else None
        self.trace_parent: Optional[str] = trace_ctx[1] if trace_ctx else None
        self.trace_spans: list[dict] = []
        # warning-severity findings from the submission-time plan analyzer
        # (error findings fail the job before a graph exists)
        self.warnings: list[str] = []
        # serving layer (docs/serving.md): fair-share accounting identity.
        # Default tenant = the session, so independent sessions split task
        # offers evenly with no configuration; ballista.serving.{tenant,
        # weight,tenant_slots} override (set by the scheduler post-plan).
        self.tenant: str = session_id
        self.share_weight: float = 1.0
        self.tenant_slots: int = 0
        # straggler speculation (docs/elasticity.md): >0 enables backup
        # attempts of tasks running longer than factor x the stage's median
        # completed duration (ballista.scale.speculation_factor; set by the
        # scheduler post-plan). Losers of the race land in spec_cancellations
        # for the scheduler to CancelTasks best-effort.
        self.speculation_factor: float = 0.0
        self.spec_cancellations: list[tuple[str, str]] = []  # (executor, task)
        self.spec_launched = 0
        self.spec_won = 0
        # cross-query exchange cache (docs/serving.md): producer stages this
        # job satisfied from cached materializations, and cache keys whose
        # entries a recompute proved STALE (a fetch failure rolled a cached
        # stage into a re-run whose new attempt-suffixed pieces the entry
        # cannot name) — the scheduler drains these and invalidates.
        self.exchange_cache_hits = 0
        self.stale_exchange_keys: list[tuple[str, Optional[str]]] = []
        # per-query resource ledger (docs/metrics.md): the scheduler attaches
        # the QueryLedger dict at job completion (obs.ledger.build_ledger)
        self.ledger: Optional[dict] = None

        # two-tier shuffle: with a fat executor available (a mesh of >= 2
        # devices on one host), eligible exchanges collapse onto the ICI tier
        # — the stage split then keeps them inline and the engine compiles
        # them as mesh collectives. Flight remains the inter-pod tier and the
        # demotion target when the ICI path fails at runtime.
        self.ici_promoted = 0
        # megastage compiler (docs/megastage.md): when every exchange on a
        # chain is ICI-eligible, the whole chain collapses into ONE stage
        # compiled as a single mesh program; counters feed /api/metrics
        self.megastage_promoted = 0
        self.megastage_demoted = 0
        if ici_shuffle and ici_devices >= 2:
            plan, self.ici_promoted = promote_ici_exchanges(
                plan, ici_devices, ici_max_rows,
                hbm_budget_bytes=hbm_budget_bytes,
            )
            if megastage and self.ici_promoted:
                plan, self.megastage_promoted = promote_megastage(
                    plan, ici_devices, ici_max_rows,
                    hbm_budget_bytes=hbm_budget_bytes,
                    max_boundaries=megastage_max_boundaries,
                )
        # HBM governor verdicts for this job (set by the scheduler after
        # govern_plan ran; surfaced via job warnings and bench JSON)
        self.memory_report = None
        # adaptive execution (docs/adaptive.md): identical exchange subtrees
        # dedupe at stage-split time; measured-size coalescing/skew splitting
        # fire per stage at resolve() via the stage fields wired below
        self.aqe_enabled = bool(aqe_enabled)
        self.aqe_reused_exchanges = 0
        stages = plan_query_stages(
            job_id, plan, fuse_exchange_max_rows, reuse_exchanges=self.aqe_enabled
        )
        if self.aqe_enabled:
            # pre-reuse, every non-final stage had exactly one consumer leaf;
            # each extra UnresolvedShuffleExec is one deduped exchange
            leaves = sum(
                1
                for s in stages
                for n in P.walk_physical(s.input)
                if isinstance(n, P.UnresolvedShuffleExec)
            )
            self.aqe_reused_exchanges = max(0, leaves - (len(stages) - 1))
        self.final_stage_id = stages[-1].stage_id
        # output links: child stage -> stages that read it. Deduped: a stage
        # reading one producer through TWO reuse-deduped leaves must appear
        # once, or location propagation would double-add its pieces
        links: dict[int, list[int]] = {}
        for s in stages:
            for dep in sorted(set(stage_dependencies(s.input))):
                links.setdefault(dep, []).append(s.stage_id)
        self.stages: dict[int, ExecutionStage] = {
            s.stage_id: ExecutionStage(s.stage_id, s, links.get(s.stage_id, []))
            for s in stages
        }
        # pipelined shuffle (docs/shuffle.md): early-resolve counters for
        # /api/metrics and the bench; per-stage enablement below
        self.pipeline_enabled = bool(pipeline_enabled)
        self.pipeline_early_resolved = 0
        self.pipeline_hbm_fallbacks = 0
        self.pipeline_deadline_fallbacks = 0
        for s in self.stages.values():
            s.broadcast_rows_threshold = broadcast_rows_threshold
            s.aqe_enabled = self.aqe_enabled
            s.aqe_target_partition_bytes = aqe_target_partition_bytes
            s.aqe_skew_factor = aqe_skew_factor
            s.aqe_hbm_budget_bytes = hbm_budget_bytes
            s.pipeline_enabled = self.pipeline_enabled
            s.pipeline_min_fraction = float(pipeline_min_fraction)
        self._task_counter = 0
        # stage_id -> distinct stage attempts that saw a fetch failure; the
        # stage-retry bound counts DISTINCT failed attempts, so concurrent
        # reports from one attempt cannot burn the whole budget (reference:
        # failed_stage_attempts, execution_graph.rs:292-296)
        self.failed_stage_attempts: dict[int, set[int]] = {}
        self.revive()

    # ---- concurrency verifier (docs/static_analysis.md) -------------------------
    def attach_guard(self, lock) -> None:
        """Wrap the stage map so every access asserts ``lock`` (the owning
        TaskManager's) is held — called at submit, when the graph starts
        being shared across scheduler threads. No-op with the verifier off
        or an untraced lock."""
        from ballista_tpu_torch.analysis import concurrency

        if concurrency.enabled():
            self.stages = concurrency.guarded_dict(
                f"ExecutionGraph.stages[{self.job_id}]", lock, self.stages
            )

    def detach_guard(self) -> None:
        """Back to a plain dict at archive time: completed graphs are
        read-mostly and handed to clients/tests lock-free by design."""
        if type(self.stages) is not dict:
            self.stages = dict(self.stages)

    # ---- introspection ---------------------------------------------------------
    def output_schema(self):
        return self.stages[self.final_stage_id].plan.schema()

    def final_output_partitions(self) -> int:
        return self.stages[self.final_stage_id].partitions

    def is_successful(self) -> bool:
        return self.status == SUCCESSFUL

    def running_stages(self) -> list[ExecutionStage]:
        return [s for s in self.stages.values() if s.state == STAGE_RUNNING]

    def available_task_count(self) -> int:
        return sum(
            len(s.available_partitions()) for s in self.running_stages()
        )

    def total_task_count(self) -> int:
        return sum(s.partitions for s in self.stages.values())

    def completed_task_count(self) -> int:
        return sum(
            sum(1 for t in s.task_infos if t is not None and t.status == "success")
            for s in self.stages.values()
        )

    # ---- cross-query exchange cache (docs/serving.md) --------------------------
    def satisfy_stage_from_cache(self, stage_id: int, tasks: list[dict]) -> bool:
        """Reconstruct a producer stage from a cached cross-job exchange
        materialization: every partition gets a synthetic SUCCESSFUL task
        info carrying the sealed piece locations, the stage completes
        without launching anything, and its consumers resolve immediately
        (AQE runs unchanged off the cached measured sizes). The plan
        template is left intact, so every existing fallback — FetchFailed
        lineage rollback, ``rerun_lost_partitions``, executor loss — re-runs
        the stage byte-identically when the cached pieces turn out gone.

        ``tasks`` is per MAP partition: ``{"executor_id", "locations":
        [writer-format piece dicts incl. host/flight_port]}``. Returns False
        (stage untouched) on any shape mismatch — the caller treats that as
        a cache miss."""
        s = self.stages.get(stage_id)
        if (
            s is None
            or s.inputs
            or s.stage_id == self.final_stage_id
            or s.state not in (RESOLVED, STAGE_RUNNING)
            or len(tasks) != s.partitions
            or any(t is not None for t in s.task_infos)
        ):
            return False
        now = time.time()
        for p, t in enumerate(tasks):
            self._task_counter += 1
            info = TaskInfo(
                f"{self.job_id}-{s.stage_id}-{p}-{self._task_counter}c",
                p, 0, "success", t.get("executor_id", ""),
                locations=[dict(l) for l in t.get("locations", [])],
                started_at=now,
            )
            s.task_infos[p] = info
            self._propagate_locations(s, p, info.locations, info.executor_id)
        s.state = STAGE_SUCCESSFUL
        s.from_cache = True
        self.exchange_cache_hits += 1
        self._complete_outputs(s)
        if self.trace_id:
            # zero-duration stage span so the trace tree shows the skipped
            # producer explicitly (EXPLAIN ANALYZE renders "exchange: cached")
            from ballista_tpu_torch.obs.tracing import job_span_id, stage_span_id

            self.trace_spans.append({
                "trace_id": self.trace_id,
                "span_id": stage_span_id(self.trace_id, s.stage_id, s.attempt),
                "parent_id": job_span_id(self.trace_id, self.job_id),
                "name": f"stage {s.stage_id}",
                "service": "scheduler",
                "start_us": int(now * 1e6),
                "dur_us": 0,
                "tid": 0,
                "attrs": {
                    "exchange_cache": "hit",
                    "partitions": s.partitions,
                    "status": "cached",
                },
            })
        self.revive()
        return True

    def _note_cached_stage_recompute(self, stage: ExecutionStage) -> None:
        """A cached stage is about to re-run (its pieces proved gone): its
        cache entry names paths the recompute's attempt-suffixed output will
        not match — report (key, entry generation) stale so the scheduler
        invalidates exactly the adopted entry, never a fresh replacement."""
        if stage.from_cache:
            stage.from_cache = False
            if stage.exchange_key:
                self.stale_exchange_keys.append(
                    (stage.exchange_key, stage.exchange_entry_gen)
                )

    def take_stale_exchange_keys(self) -> list[tuple[str, Optional[str]]]:
        out = self.stale_exchange_keys
        self.stale_exchange_keys = []
        return out

    # ---- scheduling ------------------------------------------------------------
    def revive(self) -> bool:
        """Resolve any resolvable stages and start them (reference: revive).
        Pipelined shuffle (docs/shuffle.md): eligible stages whose producers
        are all launched and past the sealed-piece fraction EARLY-resolve
        with pending markers instead of waiting for the barrier."""
        changed = False
        for s in self.stages.values():
            if s.resolvable():
                s.resolve()
                changed = True
            elif self._early_resolvable(s) and self._early_resolve(s):
                changed = True
            if s.state == RESOLVED:
                s.start_running()
                changed = True
        return changed

    # ---- pipelined shuffle (docs/shuffle.md) -----------------------------------
    def _early_resolvable(self, s: ExecutionStage) -> bool:
        """Early-resolve preconditions: knob on for the stage, template
        chunkwise-streamable, no prior fallback, every producer stage
        RUNNING with ALL partitions launched (or already successful), and
        the sealed fraction of producer tasks at or past the threshold with
        at least one piece still pending (all-sealed = the plain barrier)."""
        if (
            not s.pipeline_enabled
            or s.no_pipeline
            or s.state != UNRESOLVED
            or not s.inputs
            or not s.pipeline_eligible()
        ):
            return False
        total = sealed = 0
        for sid in s.inputs:
            p = self.stages.get(sid)
            if p is None:
                return False
            if p.state == STAGE_SUCCESSFUL:
                total += p.partitions
                sealed += p.partitions
                continue
            if p.state != STAGE_RUNNING or p.available_partitions():
                return False  # producer not fully launched yet
            total += p.partitions
            sealed += sum(
                1 for t in p.task_infos if t is not None and t.status == "success"
            )
        if total == 0 or sealed >= total:
            return False  # nothing pending: resolvable() handles it
        return sealed / total >= s.pipeline_min_fraction

    def _early_resolve(self, s: ExecutionStage) -> bool:
        """Commit an early resolution: sealed piece locations splice in
        verbatim; each unsealed (map, reduce-partition) pair becomes a
        PENDING marker carrying the producer's identity and a SIZE ESTIMATE
        (mean of that reduce partition's sealed pieces, falling back to the
        producer-wide mean) so frozen AQE decisions and the size-normalized
        straggler test still have bytes to reason about. Returns False —
        stage untouched — when the HBM-freeze rule declines (the stage then
        pins to barrier semantics; see ``_resolve_with``)."""
        locations: dict[int, list[list[dict]]] = {}
        sealed_pieces = pending_pieces = 0
        for sid, out in s.inputs.items():
            p = self.stages[sid]
            n_out = p.plan.output_partitions()
            lists = [
                list(out.partition_locations[j])
                if j < len(out.partition_locations)
                else []
                for j in range(n_out)
            ]
            sealed_pieces += sum(len(pl) for pl in lists)
            pending_maps = [
                m
                for m, t in enumerate(p.task_infos)
                if t is None or t.status != "success"
            ]
            all_bytes = [
                int(loc.get("num_bytes", 0) or 0) for pl in lists for loc in pl
            ]
            all_rows = [
                int(loc.get("num_rows", 0) or 0) for pl in lists for loc in pl
            ]
            g_bytes = sum(all_bytes) // max(1, len(all_bytes))
            g_rows = sum(all_rows) // max(1, len(all_rows))
            for j in range(n_out):
                pj = lists[j]
                eb = (
                    sum(int(l.get("num_bytes", 0) or 0) for l in pj) // len(pj)
                    if pj else g_bytes
                )
                er = (
                    sum(int(l.get("num_rows", 0) or 0) for l in pj) // len(pj)
                    if pj else g_rows
                )
                for m in pending_maps:
                    pending_pieces += 1
                    lists[j].append({
                        "pending": True,
                        "job_id": self.job_id,
                        "stage_id": sid,
                        "consumer_stage_id": s.stage_id,
                        "partition_id": j,
                        "map_partition": m,
                        "executor_id": "",
                        "host": "",
                        "flight_port": 0,
                        "path": "",
                        "num_rows": er,
                        "num_bytes": eb,
                    })
            locations[sid] = lists
        if not s._resolve_with(locations, early=True):
            # frozen estimate-based AQE under an active HBM budget: barrier
            s.no_pipeline = True
            self.pipeline_hbm_fallbacks += 1
            return False
        s.pipeline_info = {
            "sealed": sealed_pieces,
            "pending": pending_pieces,
        }
        self.pipeline_early_resolved += 1
        return True

    def stage_input_pieces(
        self, stage_id: int, input_stage_id: int, partition_id: int
    ) -> tuple[list[dict], bool, bool]:
        """Live piece feed source (GetStageInputs): the sealed pieces the
        consumer stage currently holds for one reduce partition of one
        producer, deduped to the LATEST location per map partition (a
        producer re-run's attempt-suffixed replacement supersedes the dead
        original — this is the stale-location update waiting consumers ride).
        Returns ``(pieces, complete, gone)``."""
        s = self.stages.get(stage_id)
        if s is None or self.status != RUNNING:
            return [], False, True
        out = s.inputs.get(input_stage_id)
        if out is None:
            return [], False, True
        pieces: dict[int, dict] = {}
        if partition_id < len(out.partition_locations):
            for loc in out.partition_locations[partition_id]:
                if not loc.get("pending"):
                    pieces[int(loc.get("map_partition", 0))] = loc
        return list(pieces.values()), out.complete, False

    def peek_tasks(self, max_tasks: int) -> list[tuple[int, int, P.ShuffleWriterExec]]:
        """Unbound view of available (stage_id, partition, plan) — used by
        locality-aware binding (consistent hash) to choose executors before
        committing (reference: bind_task_consistent_hash)."""
        out = []
        for s in sorted(self.running_stages(), key=lambda s: s.stage_id):
            for p in s.available_partitions():
                if len(out) >= max_tasks:
                    return out
                out.append((s.stage_id, p, s.resolved_plan))
        return out

    def bind_task(
        self,
        stage_id: int,
        partition: int,
        executor_id: str,
        device_count: Optional[int] = None,
    ) -> Optional[TaskDescriptor]:
        s = self.stages.get(stage_id)
        if s is None or s.state != STAGE_RUNNING or s.task_infos[partition] is not None:
            return None
        if s.ici_exchange_ids and device_count is not None and device_count < 2:
            # a promoted stage needs a fat executor's mesh: on a thin executor
            # IciExchangeExec would fall through to its RepartitionExec base
            # and silently materialize the whole exchange on the host
            return None
        pinned = s.ici_pinned_executor()
        if pinned is not None and pinned != executor_id:
            # fat-executor affinity: an ICI stage's tasks share one engine on
            # one host (the collective computes once); scattering them would
            # make every executor materialize the whole exchange
            return None
        self._task_counter += 1
        attempt = s.task_failures[partition]
        t = TaskInfo(
            f"{self.job_id}-{s.stage_id}-{partition}-{self._task_counter}",
            partition, attempt, "running", executor_id,
            started_at=time.time(),
        )
        s.task_infos[partition] = t
        return TaskDescriptor(
            t.task_id, self.job_id, s.stage_id, s.attempt, partition, attempt, s.resolved_plan
        )

    def pop_next_task(
        self, executor_id: str, device_count: Optional[int] = None
    ) -> Optional[TaskDescriptor]:
        for s in sorted(self.running_stages(), key=lambda s: s.stage_id):
            avail = s.available_partitions()
            if not avail:
                continue
            if s.ici_exchange_ids and device_count is not None and device_count < 2:
                continue  # thin executor cannot run the collective (see bind_task)
            pinned = s.ici_pinned_executor()
            if pinned is not None and pinned != executor_id:
                continue  # ICI stage rides its fat executor (see bind_task)
            p = avail[0]
            self._task_counter += 1
            attempt = s.task_failures[p]
            t = TaskInfo(
                f"{self.job_id}-{s.stage_id}-{p}-{self._task_counter}",
                p, attempt, "running", executor_id,
                started_at=time.time(),
            )
            s.task_infos[p] = t
            plan = s.resolved_plan
            assert plan is not None
            return TaskDescriptor(
                t.task_id, self.job_id, s.stage_id, s.attempt, p, attempt, plan
            )
        return None

    def pop_speculative_task(
        self, executor_id: str, device_count: Optional[int] = None,
        now: Optional[float] = None,
    ) -> Optional[TaskDescriptor]:
        """Straggler work-stealing (docs/elasticity.md): offer a BACKUP
        attempt of a long-running partition to a DIFFERENT executor. Fires
        only in a stage's tail (no unstarted partitions left), once at least
        half the stage's tasks completed, for tasks running longer than
        ``speculation_factor`` x the median completed duration — the
        MapReduce/LATE speculation rule. Collective stages (gang, ICI-pinned)
        never speculate: their per-task outputs are slices of one program and
        cannot race. The backup's ``task_attempt`` is offset by
        ``SPECULATIVE_ATTEMPT_OFFSET`` so its shuffle piece paths are
        attempt-suffixed apart from the primary's."""
        if self.speculation_factor <= 0:
            return None
        if now is None:
            now = time.time()
        for s in sorted(self.running_stages(), key=lambda s: s.stage_id):
            for p in s.overdue_partitions(self.speculation_factor, now):
                t = s.task_infos[p]
                if t is None or t.executor_id == executor_id:
                    continue  # the backup must race on a DIFFERENT executor
                self._task_counter += 1
                attempt = t.attempt + SPECULATIVE_ATTEMPT_OFFSET
                info = TaskInfo(
                    f"{self.job_id}-{s.stage_id}-{p}-{self._task_counter}s",
                    p, attempt, "running", executor_id,
                    started_at=now,
                )
                s.spec_infos[p] = info
                self.spec_launched += 1
                assert s.resolved_plan is not None
                return TaskDescriptor(
                    info.task_id, self.job_id, s.stage_id, s.attempt, p,
                    attempt, s.resolved_plan,
                )
        return None

    # ---- status updates ----------------------------------------------------------
    def update_task_status(self, executor_id: str, statuses: list[dict]) -> list[str]:
        """Apply a batch of task status updates; returns job-level events:
        "updated" | "finished" | "failed". Status dicts:
        {task_id, stage_id, stage_attempt, partition, status: success|failed,
         locations: [...], failure: {kind, executor_id?, map_stage_id?,
         map_partition_id?, message, retryable}}

        Collect-then-apply batch semantics (reference: update_task_status,
        execution_graph.rs:269-655): all statuses are evaluated against the
        stage attempts as they stood WHEN THE BATCH ARRIVED, effects
        (rollbacks, producer re-runs, stage successes, job failure) are
        gathered per stage and applied afterwards in the reference's order —
        so a success and a delayed fetch failure arriving together cannot
        race each other's bookkeeping (the long-delayed race-condition
        scenario, execution_graph.rs:2552)."""
        events: list[str] = []
        by_stage: dict[int, list[dict]] = {}
        for st in statuses:
            by_stage.setdefault(st["stage_id"], []).append(st)

        current_running = {s.stage_id for s in self.running_stages()}
        failed_attempts = {k: set(v) for k, v in self.failed_stage_attempts.items()}
        failed_stages: dict[int, str] = {}
        # consumer stage -> executor ids whose fetch failures roll it back
        rollback_running: dict[int, set[str]] = {}
        # producer stage -> map partitions to re-run (SUCCESSFUL producers)
        resubmit_successful: dict[int, set[int]] = {}
        # producer stage -> map partitions to reset (still-RUNNING producers,
        # from delayed fetch failures on an already-rolled-back consumer)
        reset_running: dict[int, set[int]] = {}
        # producer stage -> executors whose pieces every consumer must drop
        producer_lost_execs: dict[int, set[str]] = {}
        # stage -> ICI exchange ids a task asked to demote onto the Flight tier
        demote_requests: dict[int, set[int]] = {}
        maybe_successful: list[int] = []

        # Pass 1 — DELAYED statuses for rolled-back (UnResolved) stages are
        # evaluated against the PRE-BATCH input state: a delayed fetch failure
        # must name only the producer partitions that existed before this
        # batch's successes landed, or a success and a late failure arriving
        # together would wipe the fresh pieces too (the race-condition
        # scenario, execution_graph.rs:2552). Pass 2 then applies the
        # running-stage statuses.
        for stage_id in sorted(by_stage):
            stage = self.stages.get(stage_id)
            if stage is None or stage.state != UNRESOLVED:
                continue
            for st in by_stage[stage_id]:
                if st["status"] != "failed":
                    continue
                if stage.attempt - st.get("stage_attempt", 0) != 1:
                    continue  # only exactly-one-behind failures are meaningful
                failure = st.get("failure", {})
                kind = failure.get("kind")
                if kind == "execution" and not failure.get("retryable", True):
                    failed_stages.setdefault(
                        stage_id, failure.get("message", "task failed")
                    )
                elif kind == "fetch":
                    map_sid = failure["map_stage_id"]
                    ex = failure["executor_id"]
                    if (
                        failed_stages
                        or map_sid not in current_running
                        or ex in stage.last_attempt_failure_reasons
                    ):
                        continue  # duplicate reason / map stage not re-running
                    stage.last_attempt_failure_reasons.add(ex)
                    out = stage.inputs.get(map_sid)
                    removed = (
                        out.remove_executor_pieces(ex) if out is not None else []
                    )
                    # NOT added to producer_lost_execs: the blanket per-
                    # executor sweep in the apply step would also strip pieces
                    # this very batch's successes are about to propagate.
                    # Sibling consumers of the same producer ARE stripped here
                    # (pre-batch state): the producer's re-run re-propagates
                    # those partitions to every consumer, so stale pieces left
                    # in a sibling would be read twice on its next resolution.
                    producer = self.stages.get(map_sid)
                    if producer is not None:
                        for link in producer.output_links:
                            if link == stage_id:
                                continue
                            sib = self.stages[link].inputs.get(map_sid)
                            if sib is not None:
                                removed = sorted(
                                    set(removed)
                                    | set(sib.remove_executor_pieces(ex))
                                )
                    reset_running.setdefault(map_sid, set()).update(removed)
                    events.append("updated")

        for stage_id in sorted(by_stage):
            stage = self.stages.get(stage_id)
            if stage is None:
                continue
            if stage.state == STAGE_RUNNING:
                for st in by_stage[stage_id]:
                    if st.get("stage_attempt", 0) != stage.attempt:
                        continue  # stale attempt: a newer attempt is running
                    t = stage.task_infos[st["partition"]]
                    spec = stage.spec_infos.get(st["partition"])
                    if spec is not None and st["task_id"] == spec.task_id:
                        # a speculative BACKUP reporting. Seal-once gate:
                        # the backup wins only while the primary slot is
                        # still unsealed — then its result IS the
                        # partition's result and the primary is cancelled.
                        # A losing or failed backup is simply dropped (its
                        # attempt-suffixed partial output is reaped with the
                        # job data); backup failures never charge the
                        # partition's retry budget.
                        stage.spec_infos.pop(st["partition"], None)
                        if st["status"] == "success" and (
                            t is None or t.status == "running"
                        ):
                            if t is not None:
                                self.spec_cancellations.append(
                                    (t.executor_id, t.task_id)
                                )
                            spec.status = "success"
                            spec.locations = st.get("locations", [])
                            stage.task_infos[st["partition"]] = spec
                            self.spec_won += 1
                            stage.note_duration(
                                spec, time.time(), _pending_wait_of(st)
                            )
                            stage.merge_task_metrics(st.get("metrics", {}))
                            self._propagate_locations(
                                stage, st["partition"], spec.locations,
                                executor_id,
                            )
                        events.append("updated")
                        continue
                    if t is None:
                        continue  # stale task (e.g. reset after executor loss)
                    if t.task_id != st["task_id"]:
                        # equivalent-attempt TWIN: an exhausted launch budget
                        # unbinds and re-binds under a fresh task_id, but a
                        # delivered-but-slow first copy may still report.
                        # Same stage attempt (checked above) + same task
                        # attempt produce byte-identical output paths, so a
                        # twin's outcome is the slot's outcome — accepted
                        # only while the slot is still running (a second
                        # twin report must not double-propagate locations)
                        if (
                            t.status != "running"
                            or st.get("task_attempt", -1) != t.attempt
                        ):
                            continue  # genuinely stale (zombie attempt)
                    elif t.status == "success":
                        # seal-once: a second report of a sealed slot under
                        # the same task_id — after an HA takeover the adopted
                        # graph re-numbers a demoted task with the id its
                        # first owner gave it, and that first attempt still
                        # reports — must not propagate its pieces again
                        continue
                    if st["status"] == "success":
                        t.status = "success"
                        t.locations = st.get("locations", [])
                        stage.merge_task_metrics(st.get("metrics", {}))
                        stage.note_duration(t, time.time(), _pending_wait_of(st))
                        # seal-once: the primary sealed first — an
                        # outstanding backup lost the race and is cancelled
                        # (its late success will find the slot sealed)
                        sp = stage.spec_infos.pop(st["partition"], None)
                        if sp is not None:
                            self.spec_cancellations.append(
                                (sp.executor_id, sp.task_id)
                            )
                        self._propagate_locations(
                            stage, st["partition"], t.locations, executor_id
                        )
                        events.append("updated")
                        continue
                    failure = st.get("failure", {"kind": "execution", "retryable": True})
                    kind = failure.get("kind")
                    if kind == "fetch":
                        if PIPELINE_WAIT_MARKER in str(failure.get("message", "")):
                            # a pipelined consumer's pending-piece wait
                            # expired (or no feed was reachable): the
                            # rollback below is the EXISTING FetchFailed
                            # lineage — but re-early-resolving would only
                            # re-enter the same wait, so this stage keeps
                            # barrier semantics for the rest of the job
                            if not stage.no_pipeline:
                                stage.no_pipeline = True
                                self.pipeline_deadline_fallbacks += 1
                        fa = failed_attempts.setdefault(stage_id, set())
                        fa.add(st.get("stage_attempt", 0))
                        if len(fa) >= STAGE_MAX_FAILURES:
                            failed_stages.setdefault(
                                stage_id,
                                f"stage {stage_id} failed {STAGE_MAX_FAILURES} "
                                "times due to fetch failures",
                            )
                        elif not failed_stages:
                            map_sid = failure["map_stage_id"]
                            ex = failure["executor_id"]
                            out = stage.inputs.get(map_sid)
                            removed = (
                                out.remove_executor_pieces(ex) if out is not None else []
                            )
                            rollback_running.setdefault(stage_id, set()).add(ex)
                            resubmit_successful.setdefault(map_sid, set()).update(removed)
                            producer_lost_execs.setdefault(map_sid, set()).add(ex)
                        events.append("updated")
                    elif kind == "killed":
                        failed_stages.setdefault(stage_id, f"task {t.task_id} killed")
                    elif stage.ici_exchange_ids and "ICI_DEMOTE[" in str(
                        failure.get("message", "")
                    ):
                        # the ICI path failed deterministically for this data
                        # (skew overflow, inexpressible shape, device fault):
                        # re-plan the named exchange onto the Flight tier
                        # instead of burning the task-retry budget on a
                        # failure that would repeat every attempt
                        ids = [
                            i
                            for i in _parse_ici_demote(failure.get("message", ""))
                            if i in stage.ici_exchange_ids
                        ]
                        if ids:
                            demote_requests.setdefault(stage_id, set()).update(ids)
                        else:  # stale marker (already demoted): plain retry
                            stage.task_infos[st["partition"]] = None
                        events.append("updated")
                    elif not failure.get("retryable", True):
                        failed_stages.setdefault(
                            stage_id, failure.get("message", "task failed")
                        )
                    else:
                        stage.task_failures[st["partition"]] += 1
                        if stage.task_failures[st["partition"]] >= TASK_MAX_FAILURES:
                            failed_stages.setdefault(
                                stage_id,
                                f"task for partition {st['partition']} of stage "
                                f"{stage.stage_id} failed {TASK_MAX_FAILURES} times: "
                                f"{failure.get('message', '')}",
                            )
                        elif stage.gang:
                            if "GANG_UNFUSABLE" in failure.get("message", ""):
                                # deterministic for this data: never gang again
                                stage.no_gang = True
                            self._restart_gang_stage(stage)
                            events.append("updated")
                        else:
                            # a still-running backup takes over the slot
                            # instead of minting a third copy; the failure
                            # still counted against the retry budget above
                            sp = stage.spec_infos.pop(st["partition"], None)
                            stage.task_infos[st["partition"]] = sp  # or None
                            events.append("updated")
                maybe_successful.append(stage_id)
            # unresolved stages: handled in pass 1 above;
            # successful / failed stages: late updates are ignored

        self.failed_stage_attempts = failed_attempts

        if not failed_stages:
            # rollback consumers hit by fetch failures this batch
            for stage_id, reasons in rollback_running.items():
                s = self.stages[stage_id]
                if s.state == STAGE_RUNNING:
                    self._rollback_stage(s, reasons)
            # every consumer of an affected producer drops the dead pieces
            for map_sid, execs in producer_lost_execs.items():
                producer = self.stages.get(map_sid)
                if producer is None:
                    continue
                for link in producer.output_links:
                    out = self.stages[link].inputs.get(map_sid)
                    if out is not None:
                        for ex in execs:
                            out.remove_executor(ex)
            # successful producers re-run their lost partitions
            for map_sid, parts in resubmit_successful.items():
                producer = self.stages.get(map_sid)
                if producer is None:
                    continue
                if producer.state == STAGE_SUCCESSFUL:
                    lost = sorted(
                        set(parts)
                        | {
                            p
                            for p, t in enumerate(producer.task_infos)
                            if t is not None
                            and t.status == "success"
                            and t.executor_id in producer_lost_execs.get(map_sid, ())
                        }
                    )
                    if lost:
                        # a CACHED producer re-running proves its cache
                        # entry stale (new attempt-suffixed piece paths)
                        self._note_cached_stage_recompute(producer)
                    if lost and all(o.complete for o in producer.inputs.values()):
                        producer.rerun_lost_partitions(lost)
                    elif lost:
                        # stale frozen plan: its own inputs lost pieces too —
                        # re-resolve rather than re-run with partial reads
                        self._rollback_stage(
                            producer, producer_lost_execs.get(map_sid, set())
                        )
                elif producer.state == STAGE_RUNNING:
                    for ex in producer_lost_execs.get(map_sid, ()):
                        producer.reset_tasks_on_executor(ex, include_success=True)
            # still-running producers reset the partitions late failures named
            for map_sid, parts in reset_running.items():
                producer = self.stages.get(map_sid)
                if producer is None or producer.state != STAGE_RUNNING:
                    continue
                for p in parts:
                    t = producer.task_infos[p]
                    if t is not None:
                        producer.task_infos[p] = None
            # ICI demotions: rewrite the stage template with the named
            # exchanges as materialized Flight boundaries and restart it
            for stage_id, ids in demote_requests.items():
                s = self.stages[stage_id]
                if s.state == STAGE_RUNNING:
                    self._demote_ici_exchanges(s, sorted(ids))

        # stage successes AFTER rollbacks/resets: a stage whose partitions
        # were reset in this batch is by construction no longer all-done
        for stage_id in maybe_successful:
            stage = self.stages[stage_id]
            if stage.state != STAGE_RUNNING or not stage.all_tasks_done():
                continue
            stage.succeed()
            self._trace_stage_span(stage)
            # annotated plan + combined metrics on stage success
            # (reference: display.rs via execution_graph.rs:463-471)
            from ballista_tpu_torch.scheduler.display import print_stage_metrics

            print_stage_metrics(self.job_id, stage)
            if stage.stage_id == self.final_stage_id:
                self._finish(executor_id)
                events.append("finished")
            else:
                self._complete_outputs(stage)

        if failed_stages:
            sid = sorted(failed_stages)[0]
            self._fail_job(failed_stages[sid])
            events.append("failed")
        else:
            self.revive()
        return events

    # ---- tracing ---------------------------------------------------------------
    def _trace_stage_span(self, stage: ExecutionStage, status: str = "success") -> None:
        """Record a scheduler span for a FINISHED stage attempt — successful,
        failed, rolled back, or restarted: start = when the attempt started
        running, end = now. Must be called BEFORE the attempt counter
        advances: the span id is deterministic (stage_span_id over (trace,
        stage, attempt)) so executor task spans launched for that attempt
        parent under it — including tasks of attempts that never succeed,
        which previously parented under a never-emitted span id."""
        if not self.trace_id or stage.started_at is None:
            return
        from ballista_tpu_torch.obs.tracing import job_span_id, stage_span_id

        now = time.time()
        attrs = {
            "attempt": stage.attempt,
            "status": status,
            "partitions": stage.partitions,
            # adaptive execution (docs/adaptive.md): planned (static split)
            # vs actual (post-AQE) task boundaries, per exchange-consuming
            # stage — EXPLAIN ANALYZE renders the pair
            "planned_partitions": stage.planned_partitions,
            "actual_partitions": stage.partitions,
            "rows": int(stage.stage_metrics.get("rows", 0)),
            "output_bytes": int(stage.stage_metrics.get("output_bytes", 0)),
        }
        if stage.aqe_decisions.get("coalesced_from"):
            attrs["aqe_coalesced_from"] = stage.aqe_decisions["coalesced_from"]
            attrs["aqe_coalesced_to"] = stage.aqe_decisions["coalesced_to"]
        if stage.aqe_decisions.get("skew_splits"):
            attrs["aqe_skew_splits"] = stage.aqe_decisions["skew_splits"]
        # pipelined shuffle (docs/shuffle.md): on = this attempt early-
        # resolved; ineligible = shape can never stream (joins/sorts/ICI/
        # leaf scans); off = eligible but barrier (knob off, fraction never
        # reached, or a deadline/HBM fallback pinned it)
        if not stage.inputs or not stage.pipeline_eligible():
            attrs["pipeline"] = "ineligible"
        else:
            attrs["pipeline"] = "on" if stage.pipelined else "off"
        if stage.pipelined:
            attrs["pieces_streamed_early"] = stage.pipeline_info.get("sealed", 0)
            attrs["pending_at_resolve"] = stage.pipeline_info.get("pending", 0)
            attrs["overlap_ms"] = round(
                stage.stage_metrics.get("op.PipelineOverlap.time_s", 0.0)
                * 1000.0, 3,
            )
            attrs["pending_wait_ms"] = round(
                stage.stage_metrics.get("op.PendingWait.time_s", 0.0) * 1000.0,
                3,
            )
        # two-tier shuffle accounting: a stage whose exchange ran as a mesh
        # collective reports the mode, the bytes that never left HBM (vs the
        # Flight encode+hop they'd otherwise ride) and the collective time
        if stage.stage_metrics.get("op.IciExchange.count"):
            attrs["exchange_mode"] = "ici"
            attrs["ici_bytes_hbm"] = int(
                stage.stage_metrics.get("op.IciExchange.bytes_hbm", 0)
            )
            attrs["ici_collective_ms"] = round(
                stage.stage_metrics.get("op.IciExchange.collective_time_s", 0.0)
                * 1000.0,
                3,
            )
        elif stage.ici_exchange_ids:
            # ici_exchange_ids is derived from the same plan walk at stage
            # construction and kept in sync by _demote_ici_exchanges
            attrs["exchange_mode"] = "ici-planned"
        # megastage rollup (docs/megastage.md): whole-chain programs this
        # stage ran — fused boundary count, deleted dispatches, donated bytes
        if stage.stage_metrics.get("op.Megastage.count"):
            attrs["megastage_programs"] = int(
                stage.stage_metrics["op.Megastage.count"]
            )
            attrs["megastage_boundaries"] = int(
                stage.stage_metrics.get("op.Megastage.boundaries", 0)
            )
            attrs["megastage_dispatches_avoided"] = int(
                stage.stage_metrics.get("op.Megastage.dispatches_avoided", 0)
            )
            attrs["megastage_donated_bytes"] = int(
                stage.stage_metrics.get("op.Megastage.donated_bytes", 0)
            )
        # HBM governor drift metric (docs/memory.md): widest stage program as
        # estimated by the trace-time model vs measured by XLA / the device
        # allocator — per stage in the Perfetto trace
        if stage.stage_metrics.get("op.HbmEst.max_bytes"):
            attrs["hbm_est_bytes"] = int(stage.stage_metrics["op.HbmEst.max_bytes"])
        if stage.stage_metrics.get("op.HbmPeak.max_bytes"):
            attrs["hbm_peak_bytes"] = int(stage.stage_metrics["op.HbmPeak.max_bytes"])
        self.trace_spans.append({
            "trace_id": self.trace_id,
            "span_id": stage_span_id(self.trace_id, stage.stage_id, stage.attempt),
            "parent_id": job_span_id(self.trace_id, self.job_id),
            "name": f"stage {stage.stage_id}",
            "service": "scheduler",
            "start_us": int(stage.started_at * 1e6),
            "dur_us": max(0, int((now - stage.started_at) * 1e6)),
            "tid": 0,
            "attrs": attrs,
        })

    def _trace_job_span(self) -> None:
        if not self.trace_id:
            return
        from ballista_tpu_torch.obs.tracing import job_span_id

        end = self.end_time or time.time()
        self.trace_spans.append({
            "trace_id": self.trace_id,
            "span_id": job_span_id(self.trace_id, self.job_id),
            "parent_id": self.trace_parent,
            "name": f"job {self.job_id}",
            "service": "scheduler",
            "start_us": int(self.start_time * 1e6),
            "dur_us": max(0, int((end - self.start_time) * 1e6)),
            "tid": 0,
            "attrs": {
                "status": self.status,
                "stages": len(self.stages),
                **(
                    {"aqe_reused_exchanges": self.aqe_reused_exchanges}
                    if getattr(self, "aqe_reused_exchanges", 0)
                    else {}
                ),
                **(
                    {"exchange_cache_hits": self.exchange_cache_hits}
                    if getattr(self, "exchange_cache_hits", 0)
                    else {}
                ),
                **({"error": self.error} if self.error else {}),
            },
        })

    def take_trace_spans(self) -> list[dict]:
        out = self.trace_spans
        self.trace_spans = []
        return out

    def take_spec_cancellations(self) -> list[tuple[str, str]]:
        """Drain the (executor_id, task_id) losers of speculative races; the
        scheduler CancelTasks them best-effort so they stop burning slots."""
        out = self.spec_cancellations
        self.spec_cancellations = []
        return out

    def _rollback_stage(self, stage: ExecutionStage, executors) -> None:
        """Roll a stage back to Unresolved AND purge every piece it already
        propagated downstream. Rollback resets ALL task infos, so the re-run
        re-propagates every partition — pieces left behind from this
        attempt's partial successes would be read twice (duplicated rows;
        round-4 verify finding). Consumers holding purged pieces cascade."""
        if stage.state == STAGE_RUNNING:
            # close the aborted attempt's span BEFORE the attempt advances so
            # its tasks' spans keep a live parent (cascaded RESOLVED stages
            # never ran this attempt — nothing to record for them)
            self._trace_stage_span(stage, status="rolled_back")
        stage.rollback_to_unresolved(executors)
        for link in stage.output_links:
            consumer = self.stages[link]
            out = consumer.inputs.get(stage.stage_id)
            if out is not None and any(out.partition_locations):
                out.partition_locations = []
                out.complete = False
                if consumer.state in (STAGE_RUNNING, RESOLVED):
                    self._rollback_stage(consumer, executors)

    def _demote_ici_exchanges(self, stage: ExecutionStage, exchange_ids: list[int]) -> None:
        """Demote ICI exchanges onto the Flight tier: each named inline
        :class:`IciExchangeExec` in the stage template is split out as a NEW
        producer stage (``ShuffleWriterExec`` over the exchange input, same
        hash partitioning) and replaced by an ``UnresolvedShuffleExec`` leaf,
        exactly the boundary the original planner would have built without
        promotion — so all downstream machinery (resolution, FetchFailed
        lineage rollback, retry budgets, adaptive re-opt) applies unchanged.

        The demoted stage restarts as a fresh UNRESOLVED attempt (stale
        sibling statuses reject on the attempt check) and any output pieces
        it already propagated are purged downstream, mirroring
        ``_restart_gang_stage``. The rewritten template has a REAL boundary,
        so the exchange can never silently re-promote."""
        new_stages: list[tuple[int, P.ShuffleWriterExec]] = []
        next_sid = max(self.stages) + 1

        def rewrite(node: P.PhysicalPlan) -> P.PhysicalPlan:
            if isinstance(node, P.MegastageExec) and any(
                isinstance(n, P.IciExchangeExec) and n.exchange_id in exchange_ids
                for n in P.walk_physical(node)
            ):
                # megastage demotion (docs/megastage.md): strip the whole-
                # chain boundary and split the NAMED exchange(s) below —
                # unnamed inline exchanges stay promoted, so the re-split
                # stage retries on the single-boundary fused paths (which
                # demote themselves if they too decline)
                self.megastage_demoted += 1
                return rewrite(node.input)
            if isinstance(node, P.IciExchangeExec) and node.exchange_id in exchange_ids:
                from ballista_tpu_torch.engine.dictionaries import propagate_dict_refs

                sid = next_sid + len(new_stages)
                refs = propagate_dict_refs(node.input) or None
                writer = P.ShuffleWriterExec(
                    self.job_id, sid, node.input, node.partitioning, refs
                )
                new_stages.append((sid, writer))
                return P.UnresolvedShuffleExec(
                    sid, node.schema(), node.output_partitions(), refs
                )
            kids = [rewrite(c) for c in node.children()]
            return node.with_children(*kids) if kids else node

        inner = rewrite(stage.plan.input)
        stage.plan = P.ShuffleWriterExec(
            stage.plan.job_id, stage.stage_id, inner, stage.plan.partitioning,
            stage.plan.dict_refs,
        )
        # close the aborted collective attempt's span before the attempt
        # counter advances (same discipline as rollback/gang restart)
        self._trace_stage_span(stage, status="ici_demoted")
        # purge pieces this attempt already propagated: the restarted attempt
        # re-propagates every partition (duplicates otherwise)
        for link in stage.output_links:
            consumer = self.stages[link]
            out = consumer.inputs.get(stage.stage_id)
            if out is not None and any(out.partition_locations):
                out.partition_locations = []
                out.complete = False
                if consumer.state in (STAGE_RUNNING, RESOLVED):
                    self._rollback_stage(consumer, set())
        stage.partitions = stage.plan.input_partitions()
        stage.planned_partitions = stage.partitions
        stage.task_infos = [None] * stage.partitions
        stage.task_failures = [0] * stage.partitions
        stage.spec_infos = {}
        stage.task_durations = []
        stage.stage_metrics = {}
        stage.aqe_decisions = {}
        stage.input_bytes = []
        stage.attempt += 1
        stage.resolved_plan = None
        stage.gang = False
        stage.pipelined = False
        stage.pipeline_info = {}
        # the rewritten template has REAL shuffle boundaries now: re-derive
        # streamability (a demoted aggregate may become pipeline-eligible)
        stage._pipeline_eligible_memo = None
        # re-derive from the REWRITTEN template, not by filtering the old
        # list: a stripped megastage moves its surviving inline exchanges
        # into the new producer stage, so the consumer must not keep them
        stage.ici_exchange_ids = [
            n.exchange_id
            for n in P.walk_physical(stage.plan)
            if isinstance(n, P.IciExchangeExec)
        ]
        for sid, writer in new_stages:
            producer = ExecutionStage(sid, writer, [stage.stage_id])
            producer.broadcast_rows_threshold = stage.broadcast_rows_threshold
            # a demoted exchange RE-ENTERS adaptive execution: the new
            # Flight boundary materializes measured sizes, so the demoted
            # consumer coalesces/splits on its next resolution
            producer.aqe_enabled = stage.aqe_enabled
            producer.aqe_target_partition_bytes = stage.aqe_target_partition_bytes
            producer.aqe_skew_factor = stage.aqe_skew_factor
            producer.aqe_hbm_budget_bytes = stage.aqe_hbm_budget_bytes
            self.stages[sid] = producer
            stage.inputs[sid] = StageOutput()
        stage.state = UNRESOLVED

    def _restart_gang_stage(self, stage: ExecutionStage) -> None:
        """One member of a collective stage attempt failed: the sibling tasks'
        outputs are per-process slices that only union correctly within ONE
        attempt, so restart the whole stage — new attempt (stale sibling
        updates reject on the attempt check), all tasks reset, and any
        already-propagated output pieces of this stage dropped downstream."""
        for link in stage.output_links:
            out = self.stages[link].inputs.get(stage.stage_id)
            if out is not None:
                out.partition_locations = []
                out.complete = False
        self._trace_stage_span(stage, status="restarted")
        stage.task_infos = [None] * stage.partitions
        stage.spec_infos = {}
        # the aborted attempt's merged task metrics would double-count when
        # the new attempt re-reports
        stage.stage_metrics = {}
        stage.attempt += 1
        stage.started_at = time.time()
        stage.gang = False  # the relaunch decides gang vs per-executor anew

    def _propagate_locations(self, stage, partition, locations, executor_id):
        for link in stage.output_links:
            consumer = self.stages[link]
            out = consumer.inputs.get(stage.stage_id)
            if out is None:
                continue
            for loc in locations:
                out.add(
                    {
                        "job_id": self.job_id,
                        "stage_id": stage.stage_id,
                        "partition_id": loc["output_partition"],
                        "map_partition": partition,
                        "executor_id": executor_id,
                        "host": loc.get("host", ""),
                        "flight_port": loc.get("flight_port", 0),
                        "path": loc["path"],
                        "num_rows": loc.get("num_rows", 0),
                        "num_bytes": loc.get("num_bytes", 0),
                    }
                )

    def _complete_outputs(self, stage) -> list[int]:
        done = []
        for link in stage.output_links:
            out = self.stages[link].inputs.get(stage.stage_id)
            if out is not None:
                out.complete = True
                done.append(link)
        return done

    def _finish(self, executor_id: str):
        final = self.stages[self.final_stage_id]
        locs = []
        for p, t in enumerate(final.task_infos):
            assert t is not None
            for loc in t.locations:
                locs.append(
                    {
                        "job_id": self.job_id,
                        "stage_id": final.stage_id,
                        "partition_id": p,
                        "map_partition": p,
                        "executor_id": t.executor_id,
                        "host": loc.get("host", ""),
                        "flight_port": loc.get("flight_port", 0),
                        "path": loc["path"],
                        "num_rows": loc.get("num_rows", 0),
                        "num_bytes": loc.get("num_bytes", 0),
                    }
                )
        self.output_locations = locs
        self.status = SUCCESSFUL
        self.end_time = time.time()
        self._trace_job_span()
        # failed stage attempts are bookkeeping for a live job only
        # (reference asserts cleanup on success, execution_graph.rs:2546)
        self.failed_stage_attempts = {}

    def _fail_job(self, message: str):
        self.status = FAILED
        self.error = message
        self.end_time = time.time()
        for s in self.stages.values():
            if s.state == STAGE_RUNNING:
                # record the failing attempt's stage span so its task spans
                # keep a live parent in the trace tree
                self._trace_stage_span(s, status="failed")
                s.fail()
        self._trace_job_span()

    def cancel(self):
        self.status = CANCELLED
        self.end_time = time.time()
        self._trace_job_span()

    def unpin_stages_on_executor(self, executor_id: str) -> int:
        """An ICI stage pinned to a now-QUARANTINED executor would starve: its
        queued tasks can only bind to the pinned executor, which no longer
        receives work. Restart such stages (same machinery as a gang restart:
        attempt bump + downstream purge) so the pin clears and the tasks
        re-offer to any other fat executor under the tenant's same share
        weight. Stages whose tasks are ALL already bound are left alone —
        the in-flight work on the quarantined executor may still complete
        (quarantine only stops NEW placement)."""
        n = 0
        for s in self.stages.values():
            if (
                s.state == STAGE_RUNNING
                and s.ici_exchange_ids
                and s.available_partitions()
                and s.ici_pinned_executor() == executor_id
            ):
                self._restart_gang_stage(s)
                n += 1
        if n:
            self.revive()
        return n

    # ---- executor loss --------------------------------------------------------------
    def reset_stages_on_lost_executor(self, executor_id: str) -> int:
        """Reference: reset_stages_on_lost_executor (execution_graph.rs:1006-1149):
        fixed-point loop — running tasks reset; successful stages that stored
        output on the executor re-run; consumers of those outputs roll back."""
        reset = 0
        changed = True
        while changed:
            changed = False
            for s in list(self.stages.values()):
                if s.state == STAGE_RUNNING:
                    # running tasks are gone; completed tasks' shuffle output is
                    # gone too — both must re-run or consumers read partial data
                    n = s.reset_tasks_on_executor(executor_id, include_success=True)
                    if n:
                        reset += n
                        changed = True
                        if s.gang:
                            # collective attempt lost a member: restart whole
                            self._restart_gang_stage(s)
                # strip lost inputs; consumers whose inputs became incomplete roll back
                for sid, out in s.inputs.items():
                    if out.remove_executor(executor_id):
                        changed = True
                        if s.state in (STAGE_RUNNING, RESOLVED):
                            self._rollback_stage(s, executor_id)
                        producer = self.stages[sid]
                        if producer.state == STAGE_SUCCESSFUL:
                            lost = [
                                p
                                for p, t in enumerate(producer.task_infos)
                                if t is not None and t.executor_id == executor_id
                            ]
                            if lost:
                                self._note_cached_stage_recompute(producer)
                            if lost and all(
                                o.complete for o in producer.inputs.values()
                            ):
                                producer.rerun_lost_partitions(lost)
                            elif lost:
                                # the producer's OWN inputs also lost pieces:
                                # its frozen resolved plan references dead (or
                                # stripped) locations — re-running with it
                                # would read partial inputs. Roll all the way
                                # back so it re-resolves once its producers
                                # re-complete (fixed point handles cascades).
                                self._rollback_stage(producer, executor_id)
        self.revive()
        return reset

    # ---- persistence -----------------------------------------------------------------
    def to_summary(self) -> dict:
        return {
            "job_id": self.job_id,
            "job_name": self.job_name,
            "session_id": self.session_id,
            "tenant": self.tenant,
            "status": self.status,
            "error": self.error,
            "warnings": list(getattr(self, "warnings", [])),
            "aqe_reused_exchanges": getattr(self, "aqe_reused_exchanges", 0),
            "exchange_cache_hits": getattr(self, "exchange_cache_hits", 0),
            "pipeline_early_resolved": getattr(self, "pipeline_early_resolved", 0),
            # per-query resource ledger (docs/metrics.md): attached by the
            # scheduler at job completion; absent while the job runs
            **(
                {"ledger": dict(self.ledger)}
                if getattr(self, "ledger", None)
                else {}
            ),
            "stages": {
                sid: {
                    "state": s.state,
                    **(
                        {"from_cache": True}
                        if getattr(s, "from_cache", False)
                        else {}
                    ),
                    "partitions": s.partitions,
                    "planned_partitions": getattr(s, "planned_partitions", s.partitions),
                    **(
                        {"aqe": dict(s.aqe_decisions)}
                        if getattr(s, "aqe_decisions", None)
                        else {}
                    ),
                    **(
                        {"pipeline": dict(s.pipeline_info)}
                        if getattr(s, "pipelined", False)
                        else {}
                    ),
                    "attempt": s.attempt,
                    "completed": sum(
                        1 for t in s.task_infos if t is not None and t.status == "success"
                    ),
                    # snapshot: REST handler threads read while the event
                    # loop inserts metric keys
                    "metrics": {
                        k: round(v, 6) for k, v in dict(s.stage_metrics).items()
                    },
                }
                for sid, s in self.stages.items()
            },
        }
