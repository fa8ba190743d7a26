"""Error taxonomy.

Reference analog: ``BallistaError`` (``arrow-ballista: ballista/core/src/error.rs:37-58``).
``FetchFailed`` is load-bearing: the scheduler's ExecutionGraph keys its
stage-rollback recovery on it (survey §5.3).
"""
from __future__ import annotations

from dataclasses import dataclass


class BallistaError(Exception):
    """Base error for the engine."""


class NotImplementedYet(BallistaError):
    pass


class PlanningError(BallistaError):
    pass


class PlanVerificationError(PlanningError):
    """A plan refused at admission: error-severity findings of the plan
    verifier (``analysis/plan_verifier.py``), or PV007 alone where a
    standalone context runs the memory governor. ``findings`` holds what
    the raiser gave: ``Finding`` objects, or (rule, operator, message)
    triples; the message carries each finding's fix hint."""

    def __init__(self, findings: list):
        self.findings = findings
        triples = [(f.rule, f.operator, f.message) if hasattr(f, "rule") else tuple(f)
                   for f in findings]
        msgs = "; ".join(f"[{rule}] {op}: {msg}" for rule, op, msg in triples)
        super().__init__(f"plan verification failed: {msgs}")


class SqlError(BallistaError):
    pass


class ConfigError(BallistaError):
    pass


class ExecutionError(BallistaError):
    pass


class SchedulerError(BallistaError):
    pass


class Cancelled(BallistaError):
    pass


class IciDemoted(BallistaError):
    """The ICI collective path cannot carry a scheduler-promoted inline
    exchange (skew overflow, inexpressible shape, injected device fault,
    knob flipped off on the executor).

    Carries the ``ICI_DEMOTE[ids]`` marker the scheduler keys on: the named
    exchanges are re-planned onto the materialized Flight tier (a real
    ShuffleWriter/Reader boundary) and the stage restarts — a deterministic
    ICI failure must not burn the task-retry budget repeating itself.
    """

    def __init__(self, exchange_ids, reason: str):
        self.exchange_ids = sorted(set(int(i) for i in exchange_ids))
        self.reason = reason
        ids = ",".join(str(i) for i in self.exchange_ids)
        super().__init__(f"ICI_DEMOTE[{ids}]: {reason}")


@dataclass
class FetchFailed(BallistaError):
    """A shuffle-read failed to fetch a map partition from an executor.

    Drives fetch-failure rollback: the consumer stage rolls back to unresolved
    and the producer stage's lost partitions are re-executed
    (reference: ``execution_graph.rs:342-399``).
    """

    executor_id: str
    map_stage_id: int
    map_partition_id: int
    message: str = ""

    def __str__(self) -> str:
        return (
            f"FetchFailed(executor={self.executor_id}, map_stage={self.map_stage_id}, "
            f"map_partition={self.map_partition_id}): {self.message}"
        )
