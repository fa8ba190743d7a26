"""EXPLAIN ANALYZE rendering: the physical plan annotated with span rollups.

Reference analog: DataFusion's ``EXPLAIN ANALYZE`` (the physical plan printed
with each operator's ``MetricsSet``) surfaced through Ballista's scheduler.
Here the rollups come from the trace spans collected end-to-end: engine
operator spans carry ``rows``; jit-compiled stages carry the TPU-specific
compile-vs-execute split; shuffle spans carry bytes written/fetched.
"""
from __future__ import annotations

from typing import Optional

from ballista_tpu_torch.plan import physical as P


def rollup_spans(spans: list[dict]) -> dict[str, dict]:
    """Aggregate engine-operator spans by operator name:
    {op_name: {rows, elapsed_ms, compile_ms, calls}}."""
    out: dict[str, dict] = {}
    for s in spans:
        if s.get("service") != "engine":
            continue
        name = s.get("name", "?")
        a = s.get("attrs") or {}
        r = out.setdefault(
            name, {"rows": 0, "elapsed_ms": 0.0, "compile_ms": 0.0,
                   "compile_hidden_ms": 0.0, "calls": 0,
                   "hbm_est_bytes": 0, "hbm_peak_bytes": 0}
        )
        r["rows"] += int(a.get("rows", 0) or 0)
        r["elapsed_ms"] += s.get("dur_us", 0) / 1000.0
        r["compile_ms"] += float(a.get("compile_ms", 0.0) or 0.0)
        r["compile_hidden_ms"] += float(a.get("compile_hidden_ms", 0.0) or 0.0)
        # HBM drift metric (docs/memory.md): the WIDEST program of the stage
        # is what the budget must fit, so roll up with max, not sum
        r["hbm_est_bytes"] = max(r["hbm_est_bytes"], int(a.get("hbm_est_bytes", 0) or 0))
        r["hbm_peak_bytes"] = max(r["hbm_peak_bytes"], int(a.get("hbm_peak_bytes", 0) or 0))
        r["calls"] += 1
    return out


def shuffle_rollup(spans: list[dict]) -> dict[str, float]:
    """{written_bytes, fetched_bytes, write_ms, read_ms} across shuffle spans."""
    out = {"written_bytes": 0.0, "fetched_bytes": 0.0, "write_ms": 0.0, "read_ms": 0.0}
    for s in spans:
        if s.get("service") != "shuffle":
            continue
        a = s.get("attrs") or {}
        if s.get("name") == "shuffle-write":
            out["written_bytes"] += float(a.get("bytes", 0) or 0)
            out["write_ms"] += s.get("dur_us", 0) / 1000.0
        else:
            out["fetched_bytes"] += float(a.get("bytes", 0) or 0)
            out["read_ms"] += s.get("dur_us", 0) / 1000.0
    return out


def _annotation(name: str, ops: dict[str, dict], shuffle: dict[str, float]) -> str:
    parts = []
    r = ops.get(name)
    if r is not None:
        parts.append(f"rows={r['rows']}")
        parts.append(f"elapsed_ms={r['elapsed_ms']:.3f}")
        if r["compile_ms"]:
            parts.append(f"compile_ms={r['compile_ms']:.3f}")
        if r.get("compile_hidden_ms"):
            # compile paid by the background precompile pipeline behind the
            # upstream stage, not by this operator's tasks
            parts.append(f"compile_hidden_ms={r['compile_hidden_ms']:.3f}")
        if r.get("hbm_est_bytes"):
            parts.append(f"hbm_est_bytes={r['hbm_est_bytes']}")
        if r.get("hbm_peak_bytes"):
            parts.append(f"hbm_peak_bytes={r['hbm_peak_bytes']}")
    if name == "ShuffleWriterExec" and shuffle["written_bytes"]:
        parts.append(f"output_bytes={int(shuffle['written_bytes'])}")
    if name == "ShuffleReaderExec" and shuffle["fetched_bytes"]:
        parts.append(f"fetched_bytes={int(shuffle['fetched_bytes'])}")
    return f"   [{', '.join(parts)}]" if parts else ""


def aqe_rollup(spans: list[dict]) -> str:
    """Planned vs ADAPTED shape per exchange-consuming stage, from the
    scheduler stage spans (docs/adaptive.md): coalesce/skew decisions plus
    the planned/actual task counts, and the job-level count of reuse-deduped
    exchanges. Empty string when nothing adapted."""
    parts: list[str] = []
    for s in spans:
        if s.get("service") != "scheduler":
            continue
        a = s.get("attrs") or {}
        name = s.get("name", "")
        if name.startswith("stage "):
            planned = int(a.get("planned_partitions", 0) or 0)
            actual = int(a.get("actual_partitions", 0) or 0)
            bits = []
            if a.get("aqe_coalesced_from"):
                bits.append(
                    f"coalesced {a['aqe_coalesced_from']}->{a['aqe_coalesced_to']}"
                )
            if a.get("aqe_skew_splits"):
                bits.append(f"skew_splits={a['aqe_skew_splits']}")
            if bits or (planned and actual and planned != actual):
                parts.append(
                    f"{name}: planned_partitions={planned} "
                    f"actual_partitions={actual}"
                    + ("".join(" " + b for b in bits))
                )
        elif name.startswith("job ") and a.get("aqe_reused_exchanges"):
            parts.append(f"reused_exchanges={a['aqe_reused_exchanges']}")
    return "; ".join(parts)


def pipeline_rollup(spans: list[dict]) -> str:
    """Pipelined-shuffle outcome per stage (docs/shuffle.md): whether the
    stage early-resolved (pipeline=on|off|ineligible), how many pieces
    streamed before the barrier would have opened, the measured consumer/
    producer overlap and the pending-piece wait. Empty string when no stage
    pipelined (the all-off/ineligible case is noise)."""
    parts: list[str] = []
    for s in spans:
        if s.get("service") != "scheduler":
            continue
        a = s.get("attrs") or {}
        if not s.get("name", "").startswith("stage "):
            continue
        if a.get("pipeline") == "on":
            bits = [
                f"pieces_streamed_early={a.get('pieces_streamed_early', 0)}",
                f"pending_at_resolve={a.get('pending_at_resolve', 0)}",
            ]
            if a.get("overlap_ms"):
                bits.append(f"overlap_ms={a['overlap_ms']}")
            if a.get("pending_wait_ms"):
                bits.append(f"pending_wait_ms={a['pending_wait_ms']}")
            parts.append(f"{s['name']}: on " + " ".join(bits))
    return "; ".join(parts)


def megastage_rollup(spans: list[dict]) -> str:
    """Megastage outcome per stage (docs/megastage.md): whole-chain mesh
    programs run, former boundaries fused inline, scheduler dispatches the
    fusion deleted, bytes donated in-program, and the collective wall time.
    Empty string when no stage ran a megastage program."""
    parts: list[str] = []
    for s in spans:
        if s.get("service") != "scheduler":
            continue
        a = s.get("attrs") or {}
        if not s.get("name", "").startswith("stage "):
            continue
        if a.get("megastage_programs"):
            bits = [
                f"boundaries_fused={a.get('megastage_boundaries', 0)}",
                f"dispatches_avoided={a.get('megastage_dispatches_avoided', 0)}",
                f"donated_bytes={a.get('megastage_donated_bytes', 0)}",
            ]
            if a.get("ici_collective_ms"):
                bits.append(f"collective_ms={a['ici_collective_ms']}")
            parts.append(f"{s['name']}: " + " ".join(bits))
    return "; ".join(parts)


def exchange_cache_rollup(spans: list[dict]) -> str:
    """Cross-query exchange cache outcome (docs/serving.md): the count of
    producer stages served from cached materializations (their zero-duration
    scheduler stage spans carry ``exchange_cache=hit``) plus the plan span's
    hit/miss/bypass state. Empty string when the cache never engaged."""
    cached = sum(
        1
        for s in spans
        if s.get("service") == "scheduler"
        and (s.get("attrs") or {}).get("exchange_cache") == "hit"
        and s.get("name", "").startswith("stage ")
    )
    if cached:
        return f"cached ({cached} producer stage(s) skipped)"
    state = next(
        (
            (s.get("attrs") or {}).get("exchange_cache")
            for s in spans
            if s.get("service") == "scheduler" and s.get("name") == "plan"
            and (s.get("attrs") or {}).get("exchange_cache")
        ),
        None,
    )
    return state if state and state != "bypass" else ""


def ledger_rollup(spans: list[dict]) -> str:
    """Per-query resource ledger footer (docs/metrics.md): the scheduler
    attaches the completed job's QueryLedger to the trace as a zero-duration
    ``ledger`` span; render its headline costs. Empty string when the trace
    has no ledger span (job still running, or standalone mode where no
    scheduler rollup happened)."""
    import json as _json

    raw = next(
        (
            (s.get("attrs") or {}).get("ledger")
            for s in spans
            if s.get("service") == "scheduler" and s.get("name") == "ledger"
        ),
        None,
    )
    if not raw:
        return ""
    try:
        led = _json.loads(raw) if isinstance(raw, str) else dict(raw)
    except ValueError:
        return ""
    bits = [
        f"cpu_task_s={led.get('cpu_task_s', 0.0):.3f}",
        f"device_compute_s={led.get('device_compute_s', 0.0):.3f}",
    ]
    if led.get("compile_visible_ms") or led.get("compile_hidden_ms"):
        bits.append(
            f"compile_ms={led.get('compile_visible_ms', 0.0):.1f}"
            f"+{led.get('compile_hidden_ms', 0.0):.1f}hidden"
        )
    bits.append(
        "shuffle_bytes="
        f"{int(led.get('shuffle_flight_bytes', 0))}flight"
        f"/{int(led.get('shuffle_ici_bytes', 0))}ici"
        f"/{int(led.get('shuffle_spill_bytes', 0))}spill"
        f" codec={led.get('shuffle_codec', 'none')}"
    )
    if led.get("hbm_peak_max_bytes") or led.get("hbm_est_max_bytes"):
        bits.append(
            f"hbm={int(led.get('hbm_est_max_bytes', 0))}est"
            f"/{int(led.get('hbm_peak_max_bytes', 0))}peak"
        )
    bits.append(
        f"cache={led.get('plan_cache', 'miss')}plan"
        f"/{int(led.get('exchange_cache_hits', 0))}xchg"
        f"/{int(led.get('compile_cache_hits', 0))}compile"
    )
    if led.get("retries") or led.get("spec_launched"):
        bits.append(
            f"retries={int(led.get('retries', 0))}"
            f" spec={int(led.get('spec_launched', 0))}"
            f"/{int(led.get('spec_won', 0))}won"
        )
    bits.append(f"tenant={led.get('tenant', 'default')}")
    return " ".join(bits)


def render_explain_analyze(
    plan: P.PhysicalPlan, spans: list[dict], job_id: Optional[str] = None
) -> str:
    """Render the physical operator tree, each line annotated with the
    per-operator rollup harvested from this query's spans."""
    ops = rollup_spans(spans)
    shuffle = shuffle_rollup(spans)

    lines: list[str] = []

    def walk(node: P.PhysicalPlan, depth: int) -> None:
        name = type(node).__name__
        lines.append("  " * depth + node._line() + _annotation(name, ops, shuffle))
        for c in node.children():
            walk(c, depth + 1)

    walk(plan, 0)

    # whole-query summary: wall time per service + device split + shuffle IO
    by_service: dict[str, float] = {}
    compile_ms = execute_ms = hidden_ms = 0.0
    hbm_est = hbm_peak = 0
    for s in spans:
        by_service[s.get("service") or "?"] = (
            by_service.get(s.get("service") or "?", 0.0) + s.get("dur_us", 0) / 1000.0
        )
        if s.get("name") == "DeviceCompile":
            compile_ms += s.get("dur_us", 0) / 1000.0
        elif s.get("name") == "DeviceExecute":
            execute_ms += s.get("dur_us", 0) / 1000.0
        if s.get("service") == "engine":
            a = s.get("attrs") or {}
            hidden_ms += float(a.get("compile_hidden_ms", 0.0) or 0.0)
            hbm_est = max(hbm_est, int(a.get("hbm_est_bytes", 0) or 0))
            hbm_peak = max(hbm_peak, int(a.get("hbm_peak_bytes", 0) or 0))
    root = next(
        (s for s in spans if s.get("service") == "client" and not s.get("parent_id")),
        None,
    )
    lines.append("")
    if job_id:
        lines.append(f"job_id: {job_id}")
    if root is not None:
        lines.append(f"total_ms: {root.get('dur_us', 0) / 1000.0:.3f}")
    if compile_ms or execute_ms or hidden_ms:
        hidden = f" compile_hidden_ms={hidden_ms:.3f}" if hidden_ms else ""
        lines.append(
            f"device: compile_ms={compile_ms:.3f} execute_ms={execute_ms:.3f}"
            + hidden
        )
    if hbm_est or hbm_peak:
        # estimate-vs-actual device-memory drift (docs/memory.md): widest
        # stage program estimated by the trace-time model vs XLA's measured
        # accounting of the compiled programs
        lines.append(f"hbm: est_bytes={hbm_est} peak_bytes={hbm_peak}")
    aqe = aqe_rollup(spans)
    if aqe:
        lines.append("aqe: " + aqe)
    pipe = pipeline_rollup(spans)
    if pipe:
        lines.append("pipeline: " + pipe)
    mega = megastage_rollup(spans)
    if mega:
        lines.append("megastage: " + mega)
    xc = exchange_cache_rollup(spans)
    if xc:
        lines.append("exchange: " + xc)
    led = ledger_rollup(spans)
    if led:
        lines.append("ledger: " + led)
    if shuffle["written_bytes"] or shuffle["fetched_bytes"]:
        lines.append(
            f"shuffle: written_bytes={int(shuffle['written_bytes'])} "
            f"fetched_bytes={int(shuffle['fetched_bytes'])}"
        )
    lines.append(
        "spans: "
        + " ".join(f"{svc}={ms:.3f}ms" for svc, ms in sorted(by_service.items()))
    )
    return "\n".join(lines)


def trace_tree(spans: list[dict]) -> dict[Optional[str], list[dict]]:
    """Index spans by parent_id — helper for tests and tooling."""
    out: dict[Optional[str], list[dict]] = {}
    for s in spans:
        out.setdefault(s.get("parent_id"), []).append(s)
    return out
