"""Executor-side metrics collection.

Reference analog: ``ExecutorMetricsCollector`` / ``LoggingMetricsCollector``
(``arrow-ballista: ballista/executor/src/metrics/mod.rs:27-56``) — per-stage
metrics recorded after each task, logged with the plan; plus device counters
(device transfer/compile/compute split) the reference has no analog for.
"""
from __future__ import annotations

import logging
from typing import Protocol

log = logging.getLogger("ballista.executor.metrics")


class ExecutorMetricsCollector(Protocol):
    def record_stage(
        self, job_id: str, stage_id: int, partition: int, metrics: dict[str, float]
    ) -> None: ...


class LoggingMetricsCollector:
    def record_stage(self, job_id, stage_id, partition, metrics) -> None:
        # metric values are floats on the wire, but deserialized task status
        # (and third-party collectors) can hand back ints-as-strings — a
        # malformed value must never crash the task completion path
        def fmt(v) -> str:
            try:
                return f"{float(v):.4g}"
            except (TypeError, ValueError):
                return str(v)

        rendered = " ".join(f"{k}={fmt(v)}" for k, v in sorted(metrics.items()))
        log.info("stage metrics job=%s stage=%d part=%d %s", job_id, stage_id, partition, rendered)


class InMemoryMetricsCollector:
    """Accumulates for tests / the REST surface."""

    def __init__(self):
        self.records: list[tuple[str, int, int, dict]] = []

    def record_stage(self, job_id, stage_id, partition, metrics) -> None:
        self.records.append((job_id, stage_id, partition, dict(metrics)))

    def totals(self, job_id: str | None = None) -> dict[str, float]:
        """Roll recorded task metrics up with the SAME rule the scheduler's
        stage accumulators (and the QueryLedger) use: ``.max_bytes`` keys
        are watermarks (max), everything else sums. The e2e ledger test
        compares this against the scheduler's rollup."""
        from ballista_tpu_torch.obs.ledger import merge_metric_dicts

        return merge_metric_dicts(
            m for j, _, _, m in self.records if job_id is None or j == job_id
        )
