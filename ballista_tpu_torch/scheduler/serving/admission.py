"""Admission control: concurrency cap + bounded queue + weighted fair dequeue.

With the cap (``max_concurrent_jobs``) at 0 the controller is transparent —
every submission dispatches immediately, which keeps single-user behavior
byte-identical to the pre-serving scheduler. With a cap set, excess jobs wait
in a bounded queue; past the bound, submission is REJECTED with a clean
``RESOURCE_EXHAUSTED`` message naming the knob, so a client under overload
gets an actionable error instead of an unbounded latency cliff.

Dequeue order is weighted fair share by tenant (stride scheduling): each
dispatch advances the tenant's virtual time by 1/weight, and the tenant with
the smallest virtual time goes next — FIFO within a tenant. A tenant that
returns after idling re-enters at the current floor, so it is immediately
competitive but cannot burst on credit accumulated while absent.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from ballista_tpu_torch.analysis import concurrency

ADMISSION_QUEUE_KNOB = "ballista.serving.admission_queue_limit"


def clamp_vtimes(vtime: dict[str, float], present) -> None:
    """THE stride-scheduling entry rule, shared by both fair-share tiers
    (admission dequeue here, TaskManager task offers): prune virtual times to
    tenants with standing work, and enter new/returning tenants at the
    current floor — immediately competitive, but no burst on virtual time
    "saved up" while absent. Mutates ``vtime`` in place; callers pick the
    min-vtime tenant and advance it by 1/weight per unit granted."""
    present = set(present)
    floor = min((vtime[t] for t in present if t in vtime), default=0.0)
    for t in [t for t in vtime if t not in present]:
        del vtime[t]
    for t in present:
        vtime.setdefault(t, floor)


@dataclass
class _Queued:
    job_id: str
    tenant: str
    weight: float
    dispatch: Callable[[], None]
    enqueued_at: float


class AdmissionController:
    """``max_concurrent_jobs``: >0 = fixed cap; <=0 with no ``capacity_fn``
    = gate off (transparent); 0 WITH a ``capacity_fn`` = AUTO — the cap is
    the callback's live-capacity figure (the scheduler passes the cluster's
    schedulable task-slot total), re-read at every submit/release so scale
    events re-size the gate with no extra plumbing. An AUTO gate whose
    capacity reads 0 (no executors yet) stays transparent."""

    def __init__(
        self,
        max_concurrent_jobs: int = 0,
        queue_limit: int = 256,
        capacity_fn: Optional[Callable[[], int]] = None,
    ):
        self.max_concurrent_jobs = max(0, max_concurrent_jobs)
        self.capacity_fn = capacity_fn if max_concurrent_jobs == 0 else None
        self.queue_limit = max(0, queue_limit)
        self._mu = concurrency.make_lock("AdmissionController._mu")
        self._running: set[str] = set()
        self._queue = concurrency.guarded_list("AdmissionController._queue", self._mu)
        self._vtime = concurrency.guarded_dict("AdmissionController._vtime", self._mu)
        self.admitted_total = 0
        self.queued_total = 0
        self.rejected_total = 0
        self.cancelled_queued_total = 0
        self.wait_ms_sum = 0.0

    # ---- intake -----------------------------------------------------------------
    def submit(
        self,
        job_id: str,
        tenant: str,
        weight: float,
        dispatch: Callable[[], None],
    ) -> tuple[str, str]:
        """Returns ``("run", "")`` (caller dispatches now), ``("queued", "")``
        or ``("rejected", message)``."""
        with self._mu:
            cap = self._effective_cap_locked()
            if cap <= 0 or len(self._running) < cap:
                self._running.add(job_id)
                self.admitted_total += 1
                return "run", ""
            if len(self._queue) >= self.queue_limit:
                self.rejected_total += 1
                return "rejected", (
                    "RESOURCE_EXHAUSTED: admission queue full "
                    f"({len(self._queue)} jobs >= {ADMISSION_QUEUE_KNOB}="
                    f"{self.queue_limit}); retry later or raise the knob"
                )
            self._queue.append(
                _Queued(job_id, tenant, max(0.001, weight), dispatch, time.time())
            )
            self.queued_total += 1
            return "queued", ""

    # ---- drain ------------------------------------------------------------------
    def release(self, job_id: str) -> list[Callable[[], None]]:
        """A job left the running set (finished / failed / cancelled): pop the
        next queued job(s) by weighted fair share. Returns the dispatch
        closures to run OUTSIDE the controller's lock."""
        out: list[Callable[[], None]] = []
        with self._mu:
            self._running.discard(job_id)
            cap = self._effective_cap_locked()
            while self._queue and (cap <= 0 or len(self._running) < cap):
                q = self._pop_fair_locked()
                self._running.add(q.job_id)
                self.admitted_total += 1
                self.wait_ms_sum += (time.time() - q.enqueued_at) * 1000.0
                out.append(q.dispatch)
        return out

    @concurrency.guarded_by("_mu")
    def _pop_fair_locked(self) -> _Queued:
        present = {q.tenant for q in self._queue}
        clamp_vtimes(self._vtime, present)
        tenant = min(present, key=lambda t: self._vtime[t])
        i = next(j for j, q in enumerate(self._queue) if q.tenant == tenant)
        q = self._queue.pop(i)
        self._vtime[tenant] += 1.0 / q.weight
        return q

    @concurrency.guarded_by("_mu")
    def _effective_cap_locked(self) -> int:
        """Resolve the concurrency cap for this decision: the fixed knob, or
        (AUTO) the live capacity callback. <=0 = gate transparent."""
        if self.max_concurrent_jobs > 0:
            return self.max_concurrent_jobs
        if self.capacity_fn is None:
            return 0
        try:
            return max(0, int(self.capacity_fn()))
        except Exception:  # noqa: BLE001 - a capacity-probe hiccup must admit,
            # not reject: the gate degrades to transparent, never to closed
            return 0

    def cancel_queued(self, job_id: str) -> bool:
        """Remove a job still waiting in admission (client timeout expiry /
        explicit CancelJob): its dispatch closure will never run."""
        with self._mu:
            for i, q in enumerate(self._queue):
                if q.job_id == job_id:
                    self._queue.pop(i)
                    self.cancelled_queued_total += 1
                    return True
        return False

    # ---- introspection -----------------------------------------------------------
    def depth(self) -> int:
        with self._mu:
            return len(self._queue)

    def running(self) -> int:
        with self._mu:
            return len(self._running)

    def stats(self) -> dict:
        with self._mu:
            return {
                "max_concurrent_jobs": self.max_concurrent_jobs,
                "effective_cap": self._effective_cap_locked(),
                "auto": self.max_concurrent_jobs == 0
                and self.capacity_fn is not None,
                "queue_limit": self.queue_limit,
                "queue_depth": len(self._queue),
                "running_jobs": len(self._running),
                "admitted_total": self.admitted_total,
                "queued_total": self.queued_total,
                "rejected_total": self.rejected_total,
                "cancelled_queued_total": self.cancelled_queued_total,
                "wait_ms_sum": round(self.wait_ms_sum, 3),
            }
