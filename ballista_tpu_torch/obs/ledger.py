"""Per-query resource ledger: a durable rollup of what a job actually cost.

Task metrics today die with the job — ``ExecutionStage.stage_metrics``
accumulates them while the graph is live, then the graph expires. The
ledger freezes that information at job completion into one flat record
(CPU seconds, device compute, visible vs hidden compile time, shuffle
bytes by tier and codec, HBM estimate vs measured peak, cache hit tiers,
waits, retries/speculation, tenant attribution) and persists it through
the state store. It is the measured-stats substrate the future
cost-based optimizer (ROADMAP item 5) and the BENCH campaign both read.

The rollup rule mirrors ``ExecutionStage.merge_task_metrics`` exactly:
keys ending ``.max_bytes`` are high-watermarks and take ``max``; every
other key is additive. Because the ledger sums the very same
``stage_metrics`` floats the scheduler already holds, its totals equal
the task-metric sums *exactly* (no re-rounding), which the e2e test
asserts.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Optional

LEDGER_VERSION = 1


def merge_metric_dicts(dicts) -> dict:
    """Fold metric dicts with the stage merge rule: ``.max_bytes`` keys are
    watermarks (max), everything else sums."""
    out: dict = {}
    for d in dicts:
        for k, v in (d or {}).items():
            if not isinstance(v, (int, float)):
                continue
            if k.endswith(".max_bytes"):
                out[k] = max(out.get(k, 0), v)
            else:
                out[k] = out.get(k, 0) + v
    return out


@dataclass
class QueryLedger:
    # identity
    job_id: str = ""
    tenant: str = "default"
    status: str = "successful"
    version: int = LEDGER_VERSION
    completed_at: float = 0.0
    # timing
    wall_s: float = 0.0
    admission_wait_ms: float = 0.0
    planning_ms: float = 0.0
    pending_wait_s: float = 0.0
    pipeline_overlap_s: float = 0.0
    # work
    tasks: int = 0
    retries: int = 0
    spec_launched: int = 0
    spec_won: int = 0
    rows: int = 0
    output_bytes: int = 0
    # cpu / device
    cpu_task_s: float = 0.0
    device_compute_s: float = 0.0
    device_transfer_s: float = 0.0
    device_transfer_bytes: int = 0
    # compile
    compile_visible_ms: float = 0.0
    compile_hidden_ms: float = 0.0
    compile_wait_ms: float = 0.0
    # shuffle by tier
    shuffle_flight_bytes: int = 0
    shuffle_ici_bytes: int = 0
    shuffle_spill_bytes: int = 0
    shuffle_codec: str = "none"
    ici_collectives: int = 0
    ici_collective_s: float = 0.0
    # memory
    hbm_est_max_bytes: int = 0
    hbm_peak_max_bytes: int = 0
    # cache tiers
    plan_cache: str = "miss"
    exchange_cache_hits: int = 0
    compile_cache_hits: int = 0
    compile_cache_misses: int = 0
    # raw merged metrics kept for downstream consumers (CBO feature source)
    metrics: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "QueryLedger":
        known = {f for f in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in (d or {}).items() if k in known})


def ledger_from_metrics(
    metrics: dict,
    *,
    job_id: str = "",
    tenant: str = "default",
    status: str = "successful",
    wall_s: float = 0.0,
    admission_wait_ms: float = 0.0,
    planning_ms: float = 0.0,
    tasks: int = 0,
    retries: int = 0,
    spec_launched: int = 0,
    spec_won: int = 0,
    plan_cache: str = "miss",
    exchange_cache_hits: int = 0,
    shuffle_codec: str = "none",
    completed_at: Optional[float] = None,
) -> QueryLedger:
    """Map a merged flat metric dict (engine ``op.*`` keys + task-level
    rows/bytes/exec_time) into a ledger. Shared by the scheduler's job
    rollup and by ``bench.py``'s single-process BENCH_RESULT so both
    surfaces report identical field semantics."""
    m = metrics or {}
    return QueryLedger(
        job_id=job_id,
        tenant=tenant,
        status=status,
        completed_at=completed_at if completed_at is not None else time.time(),
        wall_s=wall_s,
        admission_wait_ms=admission_wait_ms,
        planning_ms=planning_ms,
        pending_wait_s=m.get("op.PendingWait.time_s", 0.0),
        pipeline_overlap_s=m.get("op.PipelineOverlap.time_s", 0.0),
        tasks=tasks,
        retries=retries,
        spec_launched=spec_launched,
        spec_won=spec_won,
        rows=int(m.get("rows", 0)),
        output_bytes=int(m.get("output_bytes", 0)),
        cpu_task_s=m.get("exec_time_s", 0.0),
        device_compute_s=m.get("op.DeviceExecute.time_s", 0.0),
        device_transfer_s=m.get("op.DeviceTransfer.time_s", 0.0),
        device_transfer_bytes=int(m.get("op.DeviceTransfer.bytes", 0)),
        compile_visible_ms=m.get("op.DeviceCompile.time_s", 0.0) * 1000.0,
        compile_hidden_ms=m.get("op.CompileHidden.time_s", 0.0) * 1000.0,
        compile_wait_ms=m.get("op.CompileWait.time_s", 0.0) * 1000.0,
        shuffle_flight_bytes=int(m.get("output_bytes", 0)),
        shuffle_ici_bytes=int(m.get("op.IciExchange.bytes_hbm", 0)),
        shuffle_spill_bytes=int(m.get("op.ExchangeSpill.bytes", 0)),
        shuffle_codec=shuffle_codec,
        ici_collectives=int(m.get("op.IciExchange.count", 0)),
        ici_collective_s=m.get("op.IciExchange.collective_time_s", 0.0),
        hbm_est_max_bytes=int(m.get("op.HbmEst.max_bytes", 0)),
        hbm_peak_max_bytes=int(m.get("op.HbmPeak.max_bytes", 0)),
        plan_cache=plan_cache,
        exchange_cache_hits=exchange_cache_hits,
        compile_cache_hits=int(m.get("compile_cache.hits", 0)),
        compile_cache_misses=int(m.get("compile_cache.misses", 0)),
        metrics=dict(m),
    )


def build_ledger(graph, status: str = "successful") -> QueryLedger:
    """Roll a finished ExecutionGraph's per-stage metric accumulators into a
    QueryLedger. Reads only scheduler-side state (``stage_metrics``, graph
    bookkeeping attrs) so it works in pull and push mode alike."""
    merged = merge_metric_dicts(
        getattr(st, "stage_metrics", None) for st in graph.stages.values()
    )
    tasks = 0
    retries = 0
    for st in graph.stages.values():
        tasks += int(getattr(st, "partitions", 0) or 0)
        retries += sum(getattr(st, "task_failures", ()) or ())
    start = getattr(graph, "start_time", None)
    end = getattr(graph, "end_time", None)
    wall_s = max(0.0, (end or time.time()) - start) if start else 0.0
    return ledger_from_metrics(
        merged,
        job_id=getattr(graph, "job_id", ""),
        tenant=getattr(graph, "tenant", None) or "default",
        status=status,
        wall_s=wall_s,
        admission_wait_ms=float(getattr(graph, "admission_wait_ms", 0.0) or 0.0),
        planning_ms=float(getattr(graph, "planning_ms", 0.0) or 0.0),
        tasks=tasks,
        retries=retries,
        spec_launched=int(getattr(graph, "spec_launched", 0) or 0),
        spec_won=int(getattr(graph, "spec_won", 0) or 0),
        plan_cache=getattr(graph, "plan_cache_state", None) or "miss",
        exchange_cache_hits=int(getattr(graph, "exchange_cache_hits", 0) or 0),
        shuffle_codec=getattr(graph, "shuffle_codec", None) or "none",
        completed_at=end,
    )


def ledger_prometheus(out, tenants: dict) -> None:
    """Per-tenant ledger aggregates for /api/metrics. ``tenants`` maps
    tenant -> accumulated dict (jobs, cpu_task_s, device_compute_s,
    shuffle bytes, rows)."""
    if not tenants:
        return
    out.family(
        "ballista_tenant_jobs_total", "counter",
        "Completed jobs per tenant (ledger rollup)",
    )
    out.family(
        "ballista_tenant_cpu_task_seconds_total", "counter",
        "Sum of task execution seconds per tenant (ledger rollup)",
    )
    out.family(
        "ballista_tenant_device_compute_seconds_total", "counter",
        "Sum of device compute seconds per tenant (ledger rollup)",
    )
    out.family(
        "ballista_tenant_shuffle_bytes_total", "counter",
        "Shuffle bytes by tier per tenant (ledger rollup)",
    )
    out.family(
        "ballista_tenant_rows_total", "counter",
        "Rows produced per tenant (ledger rollup)",
    )
    for tenant in sorted(tenants):
        agg = tenants[tenant]
        lbl = {"tenant": tenant}
        out.sample("ballista_tenant_jobs_total", agg.get("jobs", 0), lbl)
        out.sample(
            "ballista_tenant_cpu_task_seconds_total",
            agg.get("cpu_task_s", 0.0), lbl,
        )
        out.sample(
            "ballista_tenant_device_compute_seconds_total",
            agg.get("device_compute_s", 0.0), lbl,
        )
        for tier in ("flight", "ici", "spill"):
            out.sample(
                "ballista_tenant_shuffle_bytes_total",
                agg.get(f"shuffle_{tier}_bytes", 0),
                {"tenant": tenant, "tier": tier},
            )
        out.sample("ballista_tenant_rows_total", agg.get("rows", 0), lbl)


def accumulate_tenant(tenants: dict, ledger: QueryLedger) -> None:
    agg = tenants.setdefault(ledger.tenant, {})
    agg["jobs"] = agg.get("jobs", 0) + 1
    agg["cpu_task_s"] = agg.get("cpu_task_s", 0.0) + ledger.cpu_task_s
    agg["device_compute_s"] = (
        agg.get("device_compute_s", 0.0) + ledger.device_compute_s
    )
    agg["shuffle_flight_bytes"] = (
        agg.get("shuffle_flight_bytes", 0) + ledger.shuffle_flight_bytes
    )
    agg["shuffle_ici_bytes"] = (
        agg.get("shuffle_ici_bytes", 0) + ledger.shuffle_ici_bytes
    )
    agg["shuffle_spill_bytes"] = (
        agg.get("shuffle_spill_bytes", 0) + ledger.shuffle_spill_bytes
    )
    agg["rows"] = agg.get("rows", 0) + ledger.rows
