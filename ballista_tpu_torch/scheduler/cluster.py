"""Cluster state: executor registry, slots, heartbeats, task binding, quarantine.

Reference analog: ``ClusterState`` / ``InMemoryClusterState`` and the binding
policies (``arrow-ballista: ballista/scheduler/src/cluster/mod.rs:219-266,
381-679``; ``memory.rs``). In-memory backend (single scheduler); the
``KeyValueStore`` HA backend is a later-round item (survey §2.2).

TPU note: one executor == one TPU host ("fat executor"); ``task_slots`` is how
many stage programs it runs concurrently (survey §5.8).

Quarantine (chaos-layer hardening): an executor whose control RPCs or tasks
fail persistently is EXCLUDED from scheduling for a cooling-off period
instead of being re-picked forever or removed outright. State machine::

    ACTIVE --(threshold consecutive failures)--> QUARANTINED
    QUARANTINED --(cooloff elapses)--> PROBATION
    PROBATION --(probe success)--> ACTIVE        (counters fully reset)
    PROBATION --(probe failure)--> QUARANTINED   (cooloff doubles)

Quarantine is orthogonal to liveness: a quarantined executor keeps
heartbeating (so it is not expired) and keeps serving its shuffle files
over Flight; only NEW task placement avoids it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

# quarantine defaults (SchedulerConfig overrides; see docs/fault_tolerance.md)
QUARANTINE_FAILURE_THRESHOLD = 3
QUARANTINE_COOLOFF_S = 30.0
QUARANTINE_MAX_ESCALATION = 4  # cooloff doubles at most this many times


@dataclass
class ExecutorInfo:
    executor_id: str
    host: str
    port: int
    flight_port: int
    task_slots: int
    free_slots: int
    last_seen: float = field(default_factory=time.time)
    status: str = "active"  # active | terminating | dead
    metrics: dict = field(default_factory=dict)
    # mesh-group membership (multi-host slice sharing one jax.distributed
    # cluster); "" = standalone executor
    mesh_group_id: str = ""
    mesh_group_size: int = 0
    mesh_group_process_id: int = 0
    # accelerator inventory (ExecutorSpecification.num_devices): how many
    # devices this host's mesh spans — >= 2 makes it a "fat executor" whose
    # intra-host exchanges can ride the ICI tier. Non-jax backends report 0.
    device_count: int = 0
    # ExecutorSpecification.device_kind ("tpu"/"cpu"): the HBM governor's
    # control-plane budget signal — the scheduler sizes partitions against
    # the platform its executors REPORT, never its own process's device
    device_kind: str = ""
    # mesh shards on each of its cards (the S of the registered "CxS" mesh
    # shape): the card's budget is split between them
    shards_per_card: int = 1
    # quarantine bookkeeping (scheduler-side health tracking)
    consecutive_failures: int = 0
    quarantined_until: float = 0.0
    quarantine_round: int = 0  # escalation counter; 0 = never/readmitted
    last_failure_at: float = 0.0
    failures_total: int = 0
    successes_total: int = 0
    # task-failure dedupe keys counted toward quarantine (bounded): a buggy
    # query retrying ONE partition must count once, not once per attempt
    counted_failure_keys: set = field(default_factory=set)
    # drain-safe scale-down (docs/elasticity.md): the scheduler initiated a
    # voluntary drain. Sticky — a late "active" heartbeat must not flip a
    # TERMINATING executor back into the offer pool (the heartbeat/drain
    # race); only deregistration ends a drain.
    draining: bool = False
    drain_started_at: float = 0.0
    # shuffle-serve grace deadline: past it the executor deregisters even if
    # an active job still references its pieces (lineage re-runs take over)
    drain_deadline: float = 0.0
    # the drain state machine already ran its finish action for this
    # executor (pull-mode entries linger TERMINATING until their process
    # owner stops them; the finish must not re-fire every tick)
    drain_finished: bool = False


@dataclass
class BoundTask:
    executor_id: str
    task: object  # TaskDescriptor


class InMemoryClusterState:
    """Executor registry + slot accounting. Thread-safe via one lock
    (the reference keeps single-writer discipline via its event loop; here the
    lock serializes the same transitions)."""

    def __init__(
        self,
        task_distribution: str = "bias",
        executor_timeout_s: float = 180.0,
        terminating_grace_s: float = 30.0,
        quarantine_threshold: int = QUARANTINE_FAILURE_THRESHOLD,
        quarantine_cooloff_s: float = QUARANTINE_COOLOFF_S,
    ):
        from ballista_tpu_torch.analysis import concurrency

        self._lock = concurrency.make_rlock("InMemoryClusterState._lock")
        self.executors: dict[str, ExecutorInfo] = concurrency.guarded_dict(
            "InMemoryClusterState.executors", self._lock
        )
        self.task_distribution = task_distribution
        # liveness defaults come from SchedulerConfig so lowering
        # executor_timeout_seconds lowers liveness EVERYWHERE — callers no
        # longer fall back to an independent hardcoded 180s
        self.executor_timeout_s = executor_timeout_s
        self.terminating_grace_s = terminating_grace_s
        self.quarantine_threshold = max(1, quarantine_threshold)
        self.quarantine_cooloff_s = quarantine_cooloff_s
        self._rr_cursor = 0

    # ---- registry ---------------------------------------------------------------
    def executor_count(self) -> int:
        with self._lock:
            return len(self.executors)

    def executors_snapshot(self) -> list[ExecutorInfo]:
        """Locked list copy for REST/metrics readers: iterating the live
        registry against register/heartbeat/quarantine mutation is the
        guarded-state race the concurrency verifier flags (the ExecutorInfo
        records themselves stay shared — field reads are snapshots)."""
        with self._lock:
            return list(self.executors.values())

    def register(self, info: ExecutorInfo) -> None:
        with self._lock:
            existing = self.executors.get(info.executor_id)
            if existing is not None:
                info.free_slots = existing.free_slots
                # re-registration is a liveness signal, not an exoneration:
                # quarantine history survives (a crash-looping executor must
                # not reset its cooloff by re-registering)
                info.consecutive_failures = existing.consecutive_failures
                info.quarantined_until = existing.quarantined_until
                info.quarantine_round = existing.quarantine_round
                info.last_failure_at = existing.last_failure_at
                info.failures_total = existing.failures_total
                info.successes_total = existing.successes_total
                info.counted_failure_keys = existing.counted_failure_keys
                # a drain is a SCHEDULER decision: re-registration (e.g. the
                # pull loop re-registering after a scheduler restart) must
                # not cancel it — the drained executor would re-enter the
                # offer pool mid-drain
                if existing.draining:
                    info.draining = existing.draining
                    info.drain_started_at = existing.drain_started_at
                    info.drain_deadline = existing.drain_deadline
                    info.drain_finished = existing.drain_finished
                    info.status = "terminating"
            self.executors[info.executor_id] = info

    def heartbeat(self, executor_id: str, status: str = "active", metrics: Optional[dict] = None) -> bool:
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None:
                return False
            e.last_seen = time.time()
            # TERMINATING is STICKY: a stale/racing "active" report (an
            # in-flight heartbeat when the drain began, or a pull-mode poll
            # that defaults to active) must not re-admit a draining executor
            # to the offer pool — and an executor that then misses
            # heartbeats must expire to DEAD on the terminating grace, not
            # linger on the longer active timeout (the heartbeat/drain race,
            # docs/elasticity.md). Only register() starts a fresh life.
            if not (e.status == "terminating" and status == "active"):
                e.status = status
            if metrics:
                e.metrics.update(metrics)
            return True

    def remove(self, executor_id: str) -> Optional[ExecutorInfo]:
        with self._lock:
            return self.executors.pop(executor_id, None)

    def alive_executors(
        self, timeout_s: Optional[float] = None, include_quarantined: bool = False
    ) -> list[ExecutorInfo]:
        """Executors eligible for scheduling: active, recently seen, and not
        quarantined. ``include_quarantined=True`` is for NON-placement uses
        (job-data cleanup fan-out) — a quarantined executor is still alive
        and still holds job data."""
        if timeout_s is None:
            timeout_s = self.executor_timeout_s
        now = time.time()
        with self._lock:
            return [
                e
                for e in self.executors.values()
                if e.status == "active"
                and now - e.last_seen < timeout_s
                and (include_quarantined or now >= e.quarantined_until)
            ]

    def expired_executors(
        self,
        timeout_s: Optional[float] = None,
        terminating_grace_s: Optional[float] = None,
    ) -> list[ExecutorInfo]:
        if timeout_s is None:
            timeout_s = self.executor_timeout_s
        if terminating_grace_s is None:
            terminating_grace_s = self.terminating_grace_s
        now = time.time()
        with self._lock:
            out = []
            for e in self.executors.values():
                limit = terminating_grace_s if e.status == "terminating" else timeout_s
                if now - e.last_seen >= limit:
                    out.append(e)
            return out

    # ---- drain-safe scale-down (docs/elasticity.md) ------------------------------
    def begin_drain(self, executor_id: str, grace_s: Optional[float] = None) -> bool:
        """Move an executor ACTIVE -> TERMINATING for a voluntary drain: it
        stops being offered tasks immediately (``alive_executors`` only
        returns active) but stays registered and keeps serving its shuffle
        files. The caller (ScaleController / the drain API) watches running
        tasks + downstream shuffle references and deregisters it later —
        by the ``drain_deadline`` at the latest."""
        if grace_s is None:
            grace_s = self.terminating_grace_s
        now = time.time()
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None or e.draining:
                return False
            e.draining = True
            e.status = "terminating"
            e.drain_started_at = now
            e.drain_deadline = now + max(0.0, grace_s)
            return True

    def draining_executors(self) -> list[ExecutorInfo]:
        with self._lock:
            return [e for e in self.executors.values() if e.draining]

    def active_undraining(self) -> list[ExecutorInfo]:
        """Drain candidates: registered, active, not already draining
        (liveness/quarantine intentionally ignored — a stale or quarantined
        executor is a BETTER drain victim, not a protected one)."""
        with self._lock:
            return [
                e for e in self.executors.values()
                if e.status == "active" and not e.draining
            ]

    def quarantined_count(self) -> int:
        now = time.time()
        with self._lock:
            return sum(
                1 for e in self.executors.values() if now < e.quarantined_until
            )

    def total_task_slots(self) -> int:
        """Schedulable slot capacity: the sum of task slots over executors
        the offer path would consider (active, fresh, not quarantined) —
        the live-capacity signal for the scale controller and the
        admission gate's AUTO concurrency cap."""
        return sum(e.task_slots for e in self.alive_executors())

    # ---- quarantine (failure-rate tracking) --------------------------------------
    def record_rpc_failure(
        self, executor_id: str, kind: str = "rpc", dedupe_key=None
    ) -> str:
        """Record a failed control interaction (exhausted launch budget,
        retryable task failure). Returns the resulting quarantine state.
        One failure while in PROBATION re-quarantines immediately (the probe
        failed); otherwise ``quarantine_threshold`` consecutive failures
        trigger the first quarantine.

        ``dedupe_key`` (Spark's blacklisting heuristic, scoped wider): task
        failures pass (job, stage) so a DETERMINISTIC query/UDF bug — even
        one failing every partition of a stage — counts ONCE against each
        executor; only failures spread across stages/jobs (the flaky-host
        signature) reach the threshold. Keys reset on any success and on
        quarantine entry (a probation probe must be able to re-count)."""
        now = time.time()
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None:
                return "unknown"
            if now < e.quarantined_until:
                # straggler reports from pre-quarantine work must not extend
                # or escalate a cooloff nothing has probed yet (symmetric
                # with record_rpc_success ignoring stragglers mid-cooloff)
                e.failures_total += 1
                e.last_failure_at = now
                return "quarantined"
            if dedupe_key is not None:
                if dedupe_key in e.counted_failure_keys:
                    return self._state_locked(e, now)
                if len(e.counted_failure_keys) >= 256:
                    e.counted_failure_keys.clear()
                e.counted_failure_keys.add(dedupe_key)
            e.consecutive_failures += 1
            e.failures_total += 1
            e.last_failure_at = now
            probing = e.quarantine_round > 0 and now >= e.quarantined_until
            if probing or e.consecutive_failures >= self.quarantine_threshold:
                cooloff = self.quarantine_cooloff_s * (
                    2 ** min(e.quarantine_round, QUARANTINE_MAX_ESCALATION)
                )
                e.quarantined_until = now + cooloff
                e.quarantine_round += 1
                e.consecutive_failures = 0
                # fresh dedupe window per quarantine: a probation probe that
                # fails on an ALREADY-COUNTED partition must still be able to
                # re-quarantine (keys only dampen within one counting window)
                e.counted_failure_keys.clear()
                return "quarantined"
            return self._state_locked(e, now)

    def record_rpc_success(self, executor_id: str) -> None:
        """A successful probe/launch/task re-admits the executor — but only
        once its cooloff has lapsed (a straggler success from a task launched
        BEFORE the quarantine must not lift it early). Re-admission keeps the
        ESCALATION memory: ``quarantine_round`` only decays after a sustained
        healthy stretch (one base cooloff past the last failure), so a
        persistently broken executor that catches a lucky probe success
        oscillates into escalating cooloffs instead of resetting to the base
        one each time."""
        now = time.time()
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None:
                return
            e.successes_total += 1
            e.consecutive_failures = 0
            e.counted_failure_keys.clear()
            if now >= e.quarantined_until:
                e.quarantined_until = 0.0
                if (
                    e.quarantine_round > 0
                    and now - e.last_failure_at > self.quarantine_cooloff_s
                ):
                    e.quarantine_round = 0

    def quarantine_state(self, executor_id: str) -> str:
        with self._lock:
            e = self.executors.get(executor_id)
            if e is None:
                return "unknown"
            return self._state_locked(e, time.time())

    @staticmethod
    def _state_locked(e: ExecutorInfo, now: float) -> str:
        if now < e.quarantined_until:
            return "quarantined"
        if e.quarantine_round > 0:
            return "probation"
        return "active"

    # ---- slots --------------------------------------------------------------------
    def reserve_slots(self, n: int, executor_id: Optional[str] = None) -> list[str]:
        """Reserve up to n slots; returns one executor_id per reserved slot.

        bias: fill executors in free-slot-descending order (cluster/mod.rs:381);
        round-robin: spread one slot at a time (cluster/mod.rs:468).
        """
        with self._lock:
            alive = [
                e
                for e in self.alive_executors()
                if executor_id is None or e.executor_id == executor_id
            ]
            out: list[str] = []
            if self.task_distribution == "round-robin":
                pool = [e for e in alive if e.free_slots > 0]
                while len(out) < n and pool:
                    pool.sort(key=lambda e: -e.free_slots)
                    e = pool[self._rr_cursor % len(pool)]
                    self._rr_cursor += 1
                    if e.free_slots <= 0:
                        pool.remove(e)
                        continue
                    e.free_slots -= 1
                    out.append(e.executor_id)
                    if e.free_slots == 0:
                        pool.remove(e)
                return out
            alive.sort(key=lambda e: -e.free_slots)
            for e in alive:
                while e.free_slots > 0 and len(out) < n:
                    e.free_slots -= 1
                    out.append(e.executor_id)
                if len(out) >= n:
                    break
            return out

    def release_slots(self, executor_id: str, n: int) -> None:
        with self._lock:
            e = self.executors.get(executor_id)
            if e is not None:
                e.free_slots = min(e.task_slots, e.free_slots + n)

    def set_free_slots(self, executor_id: str, n: int) -> None:
        with self._lock:
            e = self.executors.get(executor_id)
            if e is not None:
                e.free_slots = min(e.task_slots, n)

    def get(self, executor_id: str) -> Optional[ExecutorInfo]:
        with self._lock:
            return self.executors.get(executor_id)

    def max_device_count(self) -> int:
        """Largest device mesh any schedulable executor offers — the planner's
        "is a fat executor available" signal for ICI exchange promotion. A
        mesh group's members do not count: their collective unit is the
        group (gang scheduling), and a stage promoted onto one member's
        shards would pin it there and idle its peers."""
        with self._lock:
            alive = self.alive_executors()
        return max((e.device_count for e in alive if not e.mesh_group_id), default=0)

    def device_kinds(self) -> set[str]:
        """Device kinds alive executors registered with (``"tpu"``/``"cpu"``)
        — the HBM governor's budget signal (memory_model.budget_from_device_kinds)."""
        with self._lock:
            alive = self.alive_executors()
        return {e.device_kind for e in alive if e.device_kind}

    def max_shards_per_card(self) -> int:
        """The most mesh shards any alive executor runs on one card: the
        split of the card's budget the governor plans with."""
        with self._lock:
            alive = self.alive_executors()
        return max((e.shards_per_card for e in alive), default=1)

    def complete_mesh_groups(self) -> dict[str, list[ExecutorInfo]]:
        """Mesh groups whose EVERY member is alive, keyed by group id; members
        ordered by process id. A gang stage can only launch on a complete
        group (every process must enter the collective program)."""
        groups: dict[str, list[ExecutorInfo]] = {}
        for e in self.alive_executors():
            if e.mesh_group_id and e.mesh_group_size > 1:
                groups.setdefault(e.mesh_group_id, []).append(e)
        out = {}
        for gid, members in groups.items():
            members.sort(key=lambda e: e.mesh_group_process_id)
            size = members[0].mesh_group_size
            if len(members) == size and [m.mesh_group_process_id for m in members] == list(range(size)):
                out[gid] = members
        return out
