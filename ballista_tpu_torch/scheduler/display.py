"""Stage metrics display: log the stage plan annotated with combined metrics.

Reference analog: ``print_stage_metrics``
(``arrow-ballista: ballista/scheduler/src/display.rs:31,63``) — when a stage
completes, its plan is logged with the per-operator metrics merged from all
its tasks (execution_graph.rs:463-471).
"""
from __future__ import annotations

import logging

from ballista_tpu_torch.plan import physical as P

log = logging.getLogger("ballista.scheduler.display")


def format_stage_with_metrics(stage) -> str:
    """Render a completed stage's operator tree, annotating operators with the
    stage's combined metrics (keyed op.<Type>.*)."""
    plan = stage.resolved_plan or stage.plan
    m = stage.stage_metrics
    lines = [
        f"stage {stage.stage_id} (attempt {stage.attempt}, "
        f"{stage.partitions} tasks) metrics:"
    ]

    def annotate(node: P.PhysicalPlan, depth: int):
        name = type(node).__name__
        t = m.get(f"op.{name}.time_s")
        rows = m.get(f"op.{name}.output_rows")
        extra = ""
        if t is not None or rows is not None:
            parts = []
            if rows is not None:
                parts.append(f"rows={int(rows)}")
            if t is not None:
                parts.append(f"time={t:.3f}s")
            extra = f"   [{', '.join(parts)}]"
        lines.append("  " * (depth + 1) + node._line() + extra)
        for c in node.children():
            annotate(c, depth + 1)

    annotate(plan, 0)
    for k in sorted(m):
        if not k.startswith("op."):
            lines.append(f"    {k} = {m[k]:.4g}")
    # span rollup: the TPU compile-vs-execute split + stage wall time (the
    # merged task metrics carry the engine's device counters)
    compile_s = m.get("op.DeviceCompile.time_s")
    execute_s = m.get("op.DeviceExecute.time_s")
    if compile_s is not None or execute_s is not None:
        lines.append(
            f"    device: compile={compile_s or 0.0:.3f}s "
            f"execute={execute_s or 0.0:.3f}s"
        )
    if stage.started_at is not None and stage.state == "SUCCESSFUL":
        import time as _time

        lines.append(f"    stage wall time: {_time.time() - stage.started_at:.3f}s")
    return "\n".join(lines)


def print_stage_metrics(job_id: str, stage) -> None:
    log.info("job %s %s", job_id, format_stage_with_metrics(stage))
