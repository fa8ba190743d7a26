"""Elastic executors: backlog signal + scale controller + drain state machine.

The port's copy of the JAX package's ``scheduler/scale.py`` (docs/elasticity.md):

* **Signal** — :func:`compute_signal` derives a backlog/occupancy picture
  from scheduler state: queued task-slots vs live capacity, per-stage skew,
  admission-queue depth. Served three ways: the KEDA external scaler's
  ``GetMetrics`` (``external_scaler.py``), ``GET /api/scale``, and
  Prometheus lines on ``/api/metrics``.
* **Controller** — :class:`ScaleController` turns the signal into actions
  under hysteresis (two consecutive same-direction ticks) and a cooldown
  (``ballista.scale.cooldown_s``): scale-up spawns executors through a
  registered factory (standalone/test mode — on k8s, an autoscaler consumes the
  ``desired_executors`` metric instead), scale-down runs the drain state
  machine below. ``ballista.scale.max_executors=0`` (the default) keeps the
  controller passive: the signal is still served, nothing is ever acted on.
* **Drain state machine** — a voluntary scale-down must never fail a job or
  change its bytes. The controller picks the least-loaded executor, moves it
  ACTIVE -> TERMINATING (``cluster.begin_drain``; sticky against racing
  heartbeats), stops offering it tasks, then waits for (1) its running tasks
  to finish and (2) downstream stages reading its shuffle files to complete
  — bounded by the ``ballista.scale.drain_grace_s`` shuffle-serve window —
  before deregistering it. A deadline expiry falls back to the existing
  lineage machinery (producer re-runs), which recovers without failing the
  job. An executor's work dir, and with it its shuffle pieces, goes only
  when its stop runs, after the state machine finds no reader left.

The straggler-speculation half of the elasticity arc lives in
``execution_graph.pop_speculative_task`` (p50-multiple rule,
``ballista.scale.speculation_factor``); this module only surfaces its
counters.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

from ballista_tpu_torch.config import (
    BALLISTA_SCALE_COOLDOWN_S,
    BALLISTA_SCALE_DRAIN_GRACE_S,
    BALLISTA_SCALE_MAX_EXECUTORS,
    BALLISTA_SCALE_MIN_EXECUTORS,
    BALLISTA_SCALE_SPECULATION_FACTOR,
    BALLISTA_SCALE_TARGET_OCCUPANCY,
    BallistaConfig,
)

log = logging.getLogger("ballista.scheduler.scale")

# consecutive same-direction ticks before the controller acts: one noisy
# sample (a burst arriving between two polls) must not flap the fleet
HYSTERESIS_TICKS = 2
# slots assumed per executor when none are registered yet (sizing the first
# scale-up before any capacity has been observed)
DEFAULT_SLOTS_PER_EXECUTOR = 4


@dataclass
class ScaleSignal:
    """One consistent backlog/occupancy snapshot (GET /api/scale)."""

    queued_tasks: int  # schedulable task-slots waiting (incl. speculatable)
    running_tasks: int  # bound attempts, primaries + speculative backups
    admission_queued: int  # jobs parked in the admission queue
    live_executors: int  # schedulable: active, fresh, not quarantined
    live_slots: int  # their summed task slots (the capacity denominator)
    free_slots: int
    quarantined_executors: int
    draining_executors: int
    occupancy: float  # (live_slots - free_slots) / live_slots
    stage_skew: float  # largest single stage's share of the queued backlog
    pressure: int  # queued + running + admission_queued (the KEDA metric)
    desired_executors: int  # controller's clamp'd target for the fleet


def compute_signal(
    scheduler,
    min_executors: int = 1,
    max_executors: int = 0,
    target_occupancy: float = 0.75,
) -> ScaleSignal:
    """Derive the scale signal from live scheduler state. Quarantined and
    TERMINATING executors are EXCLUDED from capacity (they take no new
    tasks), but tasks still running on them count toward pressure — work
    stranded on a sick executor is precisely backlog a new replica relieves."""
    tasks = scheduler.tasks
    cluster = scheduler.cluster
    # ONE locked pass (TaskManager.backlog_snapshot): iterating job/stage
    # state lock-free would race status updates mutating the spec maps
    queued, running, per_stage_avail = tasks.backlog_snapshot()
    admission_queued = scheduler.admission.depth()
    alive = cluster.alive_executors()
    live_slots = sum(e.task_slots for e in alive)
    free_slots = sum(max(0, e.free_slots) for e in alive)
    quarantined = cluster.quarantined_count()
    draining = len(cluster.draining_executors())
    occupancy = (
        (live_slots - free_slots) / live_slots if live_slots > 0 else 0.0
    )
    pressure = queued + running + admission_queued
    skew = (
        max(per_stage_avail) / max(1, sum(per_stage_avail))
        if per_stage_avail and sum(per_stage_avail)
        else 0.0
    )
    slots_per = (
        live_slots / len(alive) if alive else DEFAULT_SLOTS_PER_EXECUTOR
    )
    target = max(0.05, min(1.0, target_occupancy))
    desired = math.ceil((queued + running) / max(0.001, target * slots_per))
    desired = max(desired, min_executors)
    if max_executors > 0:
        desired = min(desired, max_executors)
    return ScaleSignal(
        queued_tasks=queued,
        running_tasks=running,
        admission_queued=admission_queued,
        live_executors=len(alive),
        live_slots=live_slots,
        free_slots=free_slots,
        quarantined_executors=quarantined,
        draining_executors=draining,
        occupancy=round(occupancy, 4),
        stage_skew=round(skew, 4),
        pressure=pressure,
        desired_executors=desired,
    )


class ScaleController:
    """In-process scale policy, ticked from the scheduler's expiry loop.

    Two drive paths: on k8s the controller only shapes the
    ``desired_executors`` metric KEDA consumes; in standalone/test mode a
    registered ``executor_factory`` lets it spawn local executor processes
    directly, and per-executor ``local stoppers`` let a finished drain
    actually stop the process.
    """

    def __init__(self, scheduler, settings: Optional[dict] = None):
        cfg = BallistaConfig(dict(settings or {}))
        self.scheduler = scheduler
        self.min_executors = max(0, cfg.get(BALLISTA_SCALE_MIN_EXECUTORS))
        self.max_executors = max(0, cfg.get(BALLISTA_SCALE_MAX_EXECUTORS))
        self.target_occupancy = cfg.get(BALLISTA_SCALE_TARGET_OCCUPANCY)
        self.cooldown_s = max(0.0, cfg.get(BALLISTA_SCALE_COOLDOWN_S))
        self.drain_grace_s = max(0.0, cfg.get(BALLISTA_SCALE_DRAIN_GRACE_S))
        # scheduler-level default for graphs whose session doesn't set it
        self.speculation_factor = cfg.get(BALLISTA_SCALE_SPECULATION_FACTOR)
        # standalone/test drive path: factory spawns ONE new executor per
        # call; stoppers stop the named local process after its drain
        self.executor_factory: Optional[Callable[[], None]] = None
        from ballista_tpu_torch.analysis import concurrency

        self._mu = concurrency.make_lock("ScaleController._mu")
        self._stoppers = concurrency.guarded_dict("ScaleController._stoppers", self._mu)
        self._streak_dir = 0  # +1 scale-up pressure, -1 scale-down, 0 none
        self._streak = 0
        self.last_action_at = 0.0
        self.last_action = ""
        self.scale_up_total = 0
        self.drains_started_total = 0
        self.drains_completed_total = 0

    @property
    def enabled(self) -> bool:
        return self.max_executors > 0

    def register_local(self, executor_id: str, stop_fn: Callable[[], None]) -> None:
        """Register the stop callable for a locally-spawned executor so a
        finished drain can terminate the actual process."""
        with self._mu:
            self._stoppers[executor_id] = stop_fn

    def signal(self) -> ScaleSignal:
        return compute_signal(
            self.scheduler, self.min_executors, self.max_executors,
            self.target_occupancy,
        )

    # ---- the control loop ---------------------------------------------------------
    def tick(self, now: Optional[float] = None) -> str:
        """One evaluation: progress in-flight drains, then (enabled, out of
        cooldown, hysteresis satisfied) act on the desired-vs-live delta.
        Returns a short action tag for logs/tests ("" = no action)."""
        if now is None:
            now = time.time()
        self._progress_drains(now)
        if not self.enabled:
            return ""
        sig = self.signal()
        live = sig.live_executors
        action = ""
        if sig.desired_executors > live and live < self.max_executors:
            direction = 1
        elif (
            sig.desired_executors < live
            and live > self.min_executors
            and sig.queued_tasks == 0
            and sig.admission_queued == 0
        ):
            # only drain a QUIET fleet: backlog means the surplus is about
            # to be needed; idle surplus is what scale-down exists for
            direction = -1
        else:
            direction = 0
        with self._mu:
            if direction != self._streak_dir:
                self._streak_dir, self._streak = direction, 1 if direction else 0
            elif direction:
                self._streak += 1
            act = (
                direction != 0
                and self._streak >= HYSTERESIS_TICKS
                and now - self.last_action_at >= self.cooldown_s
            )
        if not act:
            return ""
        if direction > 0:
            action = self._scale_up()
        else:
            action = self._begin_drain_least_loaded(now)
        if action:
            with self._mu:
                self.last_action_at = now
                self.last_action = action
                self._streak = 0
        return action

    def _scale_up(self) -> str:
        if self.executor_factory is None:
            # k8s mode: KEDA follows desired_executors; nothing local to do
            return ""
        try:
            self.executor_factory()
        except Exception:  # noqa: BLE001 - a failed spawn must not kill the tick
            log.exception("executor factory failed")
            # a failed SPAWN still consumes the cooldown: without this a
            # persistently broken factory (port exhaustion, spawn limit)
            # would be retried at the raw tick rate until the backlog clears
            with self._mu:
                self.last_action_at = time.time()
                self._streak = 0
            return ""
        self.scale_up_total += 1
        log.info("scale-up: spawned one executor (factory)")
        return "scale_up"

    def _begin_drain_least_loaded(self, now: float) -> str:
        """Pick the drain victim: prefer a quarantined executor (it is not
        serving new tasks anyway), else the least-loaded by running tasks
        then free slots descending."""
        cluster = self.scheduler.cluster
        cands = cluster.active_undraining()
        if len(cands) <= self.min_executors:
            return ""

        def load(e):
            quarantined = (
                cluster.quarantine_state(e.executor_id) == "quarantined"
            )
            running = self.scheduler.tasks.running_tasks_on(e.executor_id)
            return (0 if quarantined else 1, running, -e.free_slots)

        victim = sorted(cands, key=load)[0]
        # route through the scheduler's drain entry so API- and controller-
        # initiated drains share one bookkeeping path (drains_started_total)
        if not self.scheduler.drain_executor(victim.executor_id, self.drain_grace_s):
            return ""
        log.info(
            "scale-down: draining executor %s (grace %.0fs)",
            victim.executor_id, self.drain_grace_s,
        )
        return f"drain:{victim.executor_id}"

    def _progress_drains(self, now: float) -> None:
        """Advance the drain state machine: a TERMINATING executor whose
        running tasks finished AND whose shuffle outputs no active job still
        reads (or whose grace deadline passed) is deregistered — stopping
        the local process when we own it."""
        for e in self.scheduler.cluster.draining_executors():
            ex_id = e.executor_id
            if e.drain_finished:
                continue  # pull-mode entry lingering until its owner stops it
            if self.scheduler.tasks.running_tasks_on(ex_id) > 0:
                if now < e.drain_deadline:
                    continue
                # past the deadline with tasks still running: the executor is
                # stuck/straggling — fall through and deregister; the lineage
                # machinery re-runs its work elsewhere
            elif (
                now < e.drain_deadline
                and self.scheduler.tasks.executor_output_referenced(ex_id)
            ):
                continue  # shuffle-serve grace: readers still need its files
            if self.scheduler.tasks.executor_result_referenced(ex_id):
                # even past the deadline: a just-completed job's RESULT
                # pieces live only here, and lineage cannot re-run a final-
                # stage read for the client's fetch. The result-serve window
                # is itself bounded, so this defers the finish, never blocks
                # it indefinitely.
                continue
            self._finish_drain(ex_id)

    def _finish_drain(self, executor_id: str) -> None:
        log.info("drain of executor %s complete; deregistering", executor_id)
        e = self.scheduler.cluster.get(executor_id)
        if e is not None:
            e.drain_finished = True
        self.drains_completed_total += 1
        with self._mu:
            stop_fn = self._stoppers.pop(executor_id, None)
        # both paths go off-thread: stop(grace=True) blocks on the executor's
        # own drain and the push-mode StopExecutor RPC can stall 5s against a
        # hung executor — the expiry loop (heartbeat expiry, HA lease
        # renewal) must never wait on either
        target = (
            (lambda: self._stop_local(stop_fn, executor_id))
            if stop_fn is not None
            else (lambda: self.scheduler.stop_drained_executor(executor_id))
        )
        threading.Thread(
            target=target, daemon=True, name=f"drain-stop-{executor_id}",
        ).start()

    def _stop_local(self, stop_fn, executor_id: str) -> None:
        try:
            stop_fn()
        except Exception:  # noqa: BLE001
            log.warning("local stop of %s failed", executor_id, exc_info=True)
        # ExecutorStopped normally removed it already; make sure
        self.scheduler.stop_drained_executor(executor_id)

    def stats(self) -> dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "min_executors": self.min_executors,
                "max_executors": self.max_executors,
                "target_occupancy": self.target_occupancy,
                "cooldown_s": self.cooldown_s,
                "drain_grace_s": self.drain_grace_s,
                "speculation_factor": self.speculation_factor,
                "last_action": self.last_action,
                "last_action_at": self.last_action_at,
                "scale_up_total": self.scale_up_total,
                "drains_started_total": self.drains_started_total,
                "drains_completed_total": self.drains_completed_total,
            }


def scale_render_into(out, signal: ScaleSignal, stats: dict) -> None:
    """Scale signal + controller counters on the shared conformant
    exposition builder (obs.metrics.PromText)."""
    gauges = [
        ("scale_queued_tasks", signal.queued_tasks, "Queued task slots"),
        ("scale_running_tasks", signal.running_tasks, "Running tasks"),
        (
            "scale_admission_queued", signal.admission_queued,
            "Jobs queued in admission",
        ),
        ("scale_live_executors", signal.live_executors, "Live executors"),
        ("scale_live_slots", signal.live_slots, "Total live task slots"),
        ("scale_free_slots", signal.free_slots, "Free task slots"),
        (
            "scale_quarantined_executors", signal.quarantined_executors,
            "Executors in quarantine",
        ),
        (
            "scale_draining_executors", signal.draining_executors,
            "Executors draining",
        ),
        ("scale_occupancy", signal.occupancy, "Cluster slot occupancy [0,1]"),
        (
            "scale_stage_skew", signal.stage_skew,
            "Widest runnable stage / live slots",
        ),
        ("scale_pressure", signal.pressure, "Composite scale pressure"),
        (
            "scale_desired_executors", signal.desired_executors,
            "Executors the controller wants",
        ),
    ]
    for name, value, help_text in gauges:
        out.gauge(name, value, help_text)
    counters = [
        ("scale_up_total", stats.get("scale_up_total", 0), "Scale-up actions"),
        (
            "scale_drains_started_total", stats.get("drains_started_total", 0),
            "Drains started",
        ),
        (
            "scale_drains_completed_total",
            stats.get("drains_completed_total", 0), "Drains completed",
        ),
    ]
    for name, value, help_text in counters:
        out.counter(name, value, help_text)


def scale_prometheus(signal: ScaleSignal, stats: dict) -> str:
    from ballista_tpu_torch.obs.metrics import PromText

    out = PromText()
    scale_render_into(out, signal, stats)
    return out.text()


def signal_dict(signal: ScaleSignal) -> dict:
    return asdict(signal)
