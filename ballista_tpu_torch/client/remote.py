"""Remote execution: submit a plan to the scheduler, poll, fetch results.

Reference analog: ``DistributedQueryExec``
(``arrow-ballista: ballista/core/src/execution_plans/distributed_query.rs``):
serialize the logical plan, ``ExecuteQuery``, poll ``GetJobStatus`` every
100ms, then Flight-fetch every output partition (local-file fast path when
co-located).
"""
from __future__ import annotations

import json
import logging
import os
import time

import grpc
import pyarrow as pa

from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan.serde import encode_logical, schema_from_json
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.proto.rpc import scheduler_stub
from ballista_tpu_torch.shuffle.reader import read_shuffle_partition

POLL_INTERVAL_S = 0.1  # reference: 100ms

log = logging.getLogger("ballista.client")


def execute_remote(ctx, plan, timeout_s: float = None) -> pa.Table:
    from ballista_tpu_torch.obs import tracing as obs

    # the expiry message must blame the knob that actually fired, or an
    # operator chasing a timeout tunes the wrong one
    timeout_src = "timeout_s argument"
    if timeout_s is None:
        from ballista_tpu_torch.config import BALLISTA_CLIENT_QUERY_TIMEOUT_S

        if (
            BALLISTA_CLIENT_QUERY_TIMEOUT_S not in ctx.config.settings()
            and "BALLISTA_JOB_TIMEOUT_S" in os.environ
        ):
            # big-SF benchmark sweeps on starved hosts legitimately exceed
            # the default; BALLISTA_JOB_TIMEOUT_S raises it code-free (an
            # explicit session setting still wins over the env var)
            timeout_s = float(os.environ["BALLISTA_JOB_TIMEOUT_S"])
            timeout_src = "BALLISTA_JOB_TIMEOUT_S"
        else:
            # session setting, or the entry's registered default (600s) —
            # ONE default shared with the Flight SQL service
            timeout_s = float(ctx.config.get(BALLISTA_CLIENT_QUERY_TIMEOUT_S))
            timeout_src = BALLISTA_CLIENT_QUERY_TIMEOUT_S + (
                "" if BALLISTA_CLIENT_QUERY_TIMEOUT_S in ctx.config.settings()
                else " default"
            )
    host, port = ctx.remote
    stub = scheduler_stub(f"{host}:{port}")

    table_defs = []
    for name, meta in ctx.catalog.tables.items():
        if meta.format != "parquet":
            raise BallistaError(
                f"remote execution requires file-backed tables; {name!r} is in-memory"
            )
        table_defs.append(json.dumps(meta.to_dict()).encode())

    # one session per context, created lazily (reference: CreateSession /
    # ExecuteQuery.session_id flow)
    if getattr(ctx, "_session_id", None) is None:
        ctx._session_id = stub.CreateSession(
            pb.CreateSessionParams(settings=ctx.config.settings()), timeout=30
        ).session_id

    # root client span; trace context rides the submit's settings map and
    # comes back as the job's TraceStore key. ballista.trace.enabled=false
    # keeps the trace client-local: no props on the submit, no ReportTrace.
    traced = bool(ctx.config.get("ballista.trace.enabled"))
    collector = obs.SpanCollector()
    trace_id = obs.new_trace_id()
    root = collector.start("query", trace_id=trace_id, service="client")
    settings = dict(ctx.config.settings())
    if traced:
        settings[obs.TRACE_ID_PROP] = trace_id
        settings[obs.PARENT_PROP] = root.span_id

    with collector.span(
        "submit", trace_id=trace_id, parent_id=root.span_id, service="client"
    ):
        result = stub.ExecuteQuery(
            pb.ExecuteQueryParams(
                logical_plan=encode_logical(plan),
                session_id=ctx._session_id,
                settings=settings,
                table_defs=table_defs,
            ),
            timeout=30,
        )
    job_id = result.job_id
    ctx.last_trace_id = trace_id
    ctx.last_job_id = job_id
    await_span = collector.start(
        "await-job", trace_id=trace_id, parent_id=root.span_id, service="client",
        attrs={"job_id": job_id},
    )
    def finalize():
        # idempotent: close whatever is still open and ship the client-side
        # spans to the scheduler's TraceStore so /api/trace/{job_id} shows
        # the full client -> scheduler -> executor -> shuffle timeline.
        # Best-effort on failure paths too (the job trace survives either way).
        await_span.finish()
        root.finish()
        ctx.last_trace_spans = collector.snapshot()
        if not traced:
            return
        try:
            # short timeout: on the scheduler-unreachable failure path this
            # is one last best-effort RPC and must not hold up the error
            stub.ReportTrace(
                pb.ReportTraceParams(
                    job_id=job_id,
                    spans=json.dumps(collector.drain()).encode(),
                ),
                timeout=2,
            )
        except grpc.RpcError:
            log.debug("trace report for job %s failed", job_id, exc_info=True)

    deadline = time.time() + timeout_s
    try:
        return _await_and_fetch(
            ctx, stub, job_id, deadline, timeout_s,
            collector, trace_id, root, await_span, timeout_src,
        )
    finally:
        finalize()


def _await_and_fetch(
    ctx, stub, job_id, deadline, timeout_s,
    collector, trace_id, root, await_span,
    timeout_src: str = "ballista.client.query_timeout_s",
) -> pa.Table:
    from ballista_tpu_torch.obs import tracing as obs

    poll_backoff = POLL_INTERVAL_S
    unavailable_streak = 0
    while True:
        try:
            # cap each poll at the remaining JOB deadline: a hanging RPC must
            # not overshoot the job timeout by a full 30s
            status = stub.GetJobStatus(
                pb.GetJobStatusParams(job_id=job_id),
                timeout=min(30.0, max(deadline - time.time(), 1.0)),
            ).status
        except grpc.RpcError as e:
            # a busy scheduler (1-core host crunching a heavy stage) or a
            # transient network blip must not kill a long-running job whose
            # state lives server-side — keep polling until the JOB deadline
            # (reference: the client's bounded-retry poll loop)
            code = e.code() if hasattr(e, "code") else None
            if code not in (
                grpc.StatusCode.DEADLINE_EXCEEDED, grpc.StatusCode.UNAVAILABLE
            ):
                raise
            if code == grpc.StatusCode.UNAVAILABLE:
                # DEADLINE_EXCEEDED proves the server is alive-but-busy and
                # is worth waiting out; UNAVAILABLE means we cannot connect
                # at all — tolerate a restart window, then fail fast instead
                # of burning the whole job timeout against a dead scheduler
                unavailable_streak += 1
                if unavailable_streak > 20:
                    raise BallistaError(
                        f"job {job_id}: scheduler unreachable after "
                        f"{unavailable_streak} consecutive attempts"
                    ) from e
            else:
                unavailable_streak = 0
            if time.time() > deadline:
                _cancel_quietly(stub, job_id)
                raise BallistaError(
                    f"job {job_id} CANCELLED: exceeded client await budget "
                    f"of {timeout_s:g}s [{timeout_src}] (last poll: {code})"
                ) from e
            log.warning("job %s status poll failed (%s); retrying", job_id, code)
            time.sleep(poll_backoff)
            poll_backoff = min(poll_backoff * 2, 5.0)
            continue
        poll_backoff = POLL_INTERVAL_S
        unavailable_streak = 0
        if status.state == "SUCCESSFUL":
            # submission-time plan analyzer warnings ride the job status;
            # surface them without failing the query
            ctx.last_warnings = list(status.warnings)
            for w in status.warnings:
                log.warning("job %s plan verifier: %s", job_id, w)
            break
        if status.state in ("FAILED", "CANCELLED", "NOT_FOUND"):
            raise BallistaError(f"job {job_id} {status.state}: {status.error}")
        if time.time() > deadline:
            # clean CANCELLED naming the budget that fired, with the server-
            # side job actually cancelled so its tasks stop burning slots
            _cancel_quietly(stub, job_id)
            raise BallistaError(
                f"job {job_id} CANCELLED: exceeded client await budget "
                f"of {timeout_s:g}s [{timeout_src}]"
            )
        time.sleep(POLL_INTERVAL_S)
    await_span.finish()

    schema = schema_from_json(json.loads(status.result_schema.decode()))
    locations = [
        {
            "path": loc.path,
            "host": loc.host,
            "flight_port": loc.flight_port,
            "executor_id": loc.executor_id,
            "stage_id": loc.partition.stage_id,
            "map_partition": loc.map_partition,
        }
        for loc in status.partition_locations
    ]
    # fetch partitions concurrently, preserving partition order for ORDER BY.
    # The session's object-store tier applies here too: the final result is
    # a shuffle consumer like any other, and a producer preempted between
    # job success and the client fetch must not fail the query.
    from concurrent.futures import ThreadPoolExecutor

    from ballista_tpu_torch.config import BALLISTA_SHUFFLE_OBJECT_STORE_URL

    os_url = str(ctx.config.get(BALLISTA_SHUFFLE_OBJECT_STORE_URL) or "")
    with collector.span(
        "fetch-results", trace_id=trace_id, parent_id=root.span_id,
        service="client", attrs={"partitions": len(locations)},
    ) as fetch_span:
        def fetch_one(loc):
            # ambient per pool thread: the shuffle reader records its span
            # (service "shuffle") under the client fetch
            obs.set_ambient(collector, trace_id, fetch_span.span_id)
            try:
                return read_shuffle_partition([loc], schema, object_store_url=os_url)
            finally:
                obs.clear_ambient()

        with ThreadPoolExecutor(max_workers=min(16, max(1, len(locations)))) as pool:
            batches = list(pool.map(fetch_one, locations))
    tables = [b.to_arrow() for b in batches if b.num_rows]
    root.set("rows", sum(t.num_rows for t in tables))
    if not tables:
        return ColumnBatch.empty(schema).to_arrow()
    return pa.concat_tables(tables)


def _cancel_quietly(stub, job_id: str) -> None:
    """Best-effort CancelJob on client-side timeout expiry — a timed-out
    query must not leave its tasks running server-side."""
    try:
        stub.CancelJob(pb.CancelJobParams(job_id=job_id), timeout=5)
    except grpc.RpcError:
        log.debug("cancel of timed-out job %s failed", job_id, exc_info=True)


def fetch_trace(ctx, job_id: str) -> list[dict]:
    """Fetch a job's retained spans from the scheduler's TraceStore
    (EXPLAIN ANALYZE's data source in remote mode)."""
    host, port = ctx.remote
    stub = scheduler_stub(f"{host}:{port}")
    try:
        raw = stub.GetTrace(pb.GetTraceParams(job_id=job_id), timeout=10).trace
    except grpc.RpcError as e:
        log.warning("GetTrace for job %s failed: %s", job_id, e)
        return []
    if not raw:
        return []
    return json.loads(raw.decode())
