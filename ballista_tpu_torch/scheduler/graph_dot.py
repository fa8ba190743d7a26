"""Graphviz dot export of an ExecutionGraph / stage plan.

Reference analog: ``ExecutionGraphDot``
(``arrow-ballista: ballista/scheduler/src/state/execution_graph_dot.rs``) and
the ``/api/dot`` route: render the job's stage DAG (or one stage's operator
tree) as dot for the UI.
"""
from __future__ import annotations

from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.scheduler.execution_graph import ExecutionGraph

_STATE_COLOR = {
    "UNRESOLVED": "lightgray",
    "RESOLVED": "lightyellow",
    "RUNNING": "lightblue",
    "SUCCESSFUL": "lightgreen",
    "FAILED": "lightcoral",
}


def graph_to_dot(g: ExecutionGraph) -> str:
    lines = [
        "digraph G {",
        "  rankdir=BT;",
        f'  label="job {g.job_id} [{g.status}]";',
        "  node [shape=box, style=filled];",
    ]
    for sid, s in sorted(g.stages.items()):
        done = sum(1 for t in s.task_infos if t is not None and t.status == "success")
        color = _STATE_COLOR.get(s.state, "white")
        # span rollup: merged task wall time + rows/bytes through the stage
        extra = ""
        m = s.stage_metrics
        if m.get("exec_time_s"):
            extra = f"\\n{m['exec_time_s']:.3f}s"
            if m.get("rows"):
                extra += f" rows={int(m['rows'])}"
            if m.get("output_bytes"):
                extra += f" out={int(m['output_bytes'])}B"
        lines.append(
            f'  stage_{sid} [label="stage {sid}\\n{s.state} attempt={s.attempt}'
            f'\\n{done}/{s.partitions} tasks{extra}", fillcolor="{color}"];'
        )
        for link in s.output_links:
            lines.append(f"  stage_{sid} -> stage_{link};")
    lines.append("}")
    return "\n".join(lines)


def stage_to_dot(g: ExecutionGraph, stage_id: int) -> str:
    s = g.stages[stage_id]
    plan = s.resolved_plan or s.plan
    lines = [
        "digraph G {",
        "  rankdir=BT;",
        f'  label="job {g.job_id} stage {stage_id}";',
        "  node [shape=box];",
    ]
    counter = [0]

    def visit(node: P.PhysicalPlan) -> str:
        me = f"op_{counter[0]}"
        counter[0] += 1
        label = node._line().replace('"', "'")
        if len(label) > 80:
            label = label[:77] + "..."
        lines.append(f'  {me} [label="{label}"];')
        for c in node.children():
            child = visit(c)
            lines.append(f"  {child} -> {me};")
        return me

    visit(plan)
    lines.append("}")
    return "\n".join(lines)
