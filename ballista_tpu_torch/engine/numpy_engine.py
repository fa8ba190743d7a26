"""Host (numpy/pyarrow) execution of physical plans.

Partition-granular vectorized execution: each partition materializes as one
``ColumnBatch`` (the reference streams 8192-row record batches through
DataFusion operators; whole-partition batches are the XLA-friendly shape, and
the numpy engine mirrors that so both backends share semantics).
"""
from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ballista_tpu_torch.engine.engine import ExecutionEngine
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops import kernels_np as K
from ballista_tpu_torch.ops.batch import Column, ColumnBatch
from ballista_tpu_torch.ops.eval_np import evaluate, to_filter_mask
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.schema import DataType, Schema


# process-wide read-through scan cache (reference: the data-cache layer behind
# ballista.data_cache.enabled, cache_layer/ + executor_process.rs:199-231 —
# whole-file read-through on the executor; here in host RAM with a byte budget)
from ballista_tpu_torch.utils.cache import LoadingCache

_DATA_CACHE: LoadingCache = LoadingCache(
    capacity=4 * 1024**3, weigher=lambda t: t.nbytes
)


class NumpyEngine(ExecutionEngine):
    name = "numpy"
    data_cache_enabled = False  # per-engine flag, set from session config
    # distributed tracing: when set (obs.tracing.TraceCtx), every operator
    # execution additionally records a span (inclusive wall interval + rows)
    # parented under the task span; None = zero-overhead untraced path
    trace_ctx = None

    def __init__(self, config=None):
        import threading

        self.config = config
        # materialized results for pipeline breakers, keyed by plan identity
        self._cache: dict[int, list[ColumnBatch]] = {}
        # per-operator metrics for this execution (reference: DataFusion
        # MetricsSet harvested per task, core/src/utils.rs collect_plan_metrics);
        # times are exclusive (child operator time subtracted)
        self.op_metrics: dict[str, float] = {}
        # thread-local child-time accumulator stacks: execute_all runs
        # partitions on a thread pool (the reference executor's partition
        # parallelism, executor binary's tokio worker threads), and the numpy
        # kernels release the GIL inside array ops
        self._tls = threading.local()
        self._lock = threading.Lock()  # guards _cache/_inflight/op_metrics maps
        self._inflight: dict[int, "threading.Event"] = {}

    @property
    def _op_stack(self) -> list[list[float]]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    # ---- public ------------------------------------------------------------------
    def execute_partition(self, plan: P.PhysicalPlan, partition: int) -> ColumnBatch:
        return self._exec(plan, partition)

    def execute_all(self, plan: P.PhysicalPlan) -> list[ColumnBatch]:
        import os
        from concurrent.futures import ThreadPoolExecutor

        # per-execution scoping: the materialization cache keys on plan-node
        # identity, which is only stable within one execution (a GC'd node's
        # id can be reused by a later query's node on a long-lived engine)
        with self._lock:
            self._cache.clear()
        nparts = plan.output_partitions()
        workers = min(
            nparts,
            int(os.environ.get("BALLISTA_CPU_PARALLELISM", 0))
            or (os.cpu_count() or 1),
        )
        if workers <= 1 or nparts <= 1:
            return [self._exec(plan, i) for i in range(nparts)]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(lambda i: self._exec(plan, i), range(nparts)))

    # ---- dispatch ------------------------------------------------------------------
    def _exec(self, plan: P.PhysicalPlan, part: int) -> ColumnBatch:
        import time as _time

        t0 = _time.time()
        self._op_stack.append([0.0])
        try:
            out = self._exec_inner(plan, part)
        finally:
            child_time = self._op_stack.pop()[0]
        total = _time.time() - t0
        if self._op_stack:
            self._op_stack[-1][0] += total
        name = type(plan).__name__
        with self._lock:
            self.op_metrics[f"op.{name}.time_s"] = (
                self.op_metrics.get(f"op.{name}.time_s", 0.0)
                + max(0.0, total - child_time)
            )
            self.op_metrics[f"op.{name}.output_rows"] = (
                self.op_metrics.get(f"op.{name}.output_rows", 0.0) + out.num_rows
            )
        self._record_span(
            name, t0, total,
            {
                "rows": out.num_rows,
                "partition": part,
                "self_ms": round(max(0.0, total - child_time) * 1000, 3),
            },
        )
        return out

    def _record_span(self, name: str, t0_wall: float, dur_s: float, attrs: dict) -> None:
        ctx = self.trace_ctx
        if ctx is None:
            return
        ctx.collector.record(
            name, trace_id=ctx.trace_id, parent_id=ctx.parent_id, service="engine",
            start_us=t0_wall * 1e6, dur_us=dur_s * 1e6, attrs=attrs,
        )

    def _exec_inner(self, plan: P.PhysicalPlan, part: int) -> ColumnBatch:
        if isinstance(plan, P.ParquetScanExec):
            return self._scan_parquet(plan, part)
        if isinstance(plan, P.MemoryScanExec):
            if not plan.partitions:
                return ColumnBatch.empty(plan.schema())
            batch = plan.partitions[part]
            if plan.projection is not None:
                batch = batch.select(plan.projection)
            return batch
        if isinstance(plan, P.EmptyExec):
            return ColumnBatch(Schema(()), [], num_rows=1 if plan.produce_one_row else 0)
        if isinstance(plan, P.FilterExec):
            batch = self._exec(plan.input, part)
            mask = to_filter_mask(evaluate(plan.predicate, batch))
            return batch.filter(mask)
        if isinstance(plan, P.ProjectExec):
            batch = self._exec(plan.input, part)
            schema = plan.schema()
            cols = [evaluate(e, batch) for e in plan.exprs]
            cols = [_coerce(c, f.dtype) for c, f in zip(cols, schema)]
            return ColumnBatch(schema, cols, num_rows=batch.num_rows)
        if isinstance(plan, P.HashAggregateExec):
            batch = self._exec(plan.input, part)
            return K.aggregate_groups(
                batch, plan.group_exprs, plan.agg_exprs, plan.mode, plan.schema(),
            )
        if isinstance(plan, P.HashJoinExec):
            left = self._exec(plan.left, part)
            if plan.collect_build:
                right = self._materialized_single(plan.right)
            else:
                right = self._exec(plan.right, part)
            return K.hash_join(left, right, plan.on, plan.how, plan.filter, plan.schema())
        if isinstance(plan, P.CrossJoinExec):
            left = self._exec(plan.left, part)
            right = self._materialized_single(plan.right)
            return K.cross_join(left, right, plan.schema())
        if isinstance(plan, P.SortExec):
            batch = self._exec(plan.input, part)
            return K.sort_batch(batch, plan.keys, plan.fetch)
        if isinstance(plan, P.SortPreservingMergeExec):
            assert part == 0
            batches = self._materialize(plan.input)
            merged = ColumnBatch.concat(batches) if batches else ColumnBatch.empty(plan.schema())
            return K.sort_batch(merged, plan.keys)
        if isinstance(plan, P.CoalescePartitionsExec):
            assert part == 0
            batches = self._materialize(plan.input)
            return ColumnBatch.concat(batches) if batches else ColumnBatch.empty(plan.schema())
        if isinstance(plan, P.LimitExec):
            batch = self._exec(plan.input, part)
            start = plan.offset if plan.global_ else 0
            n = batch.num_rows - start if plan.n < 0 else plan.n
            return batch.slice(start, max(0, n))
        if isinstance(plan, P.WindowExec):
            batch = self._exec(plan.input, part)
            return K.window_eval(batch, plan.window_exprs, plan.schema())
        if isinstance(plan, P.UnionExec):
            schema = plan.schema()
            for child in plan.inputs:
                n = child.output_partitions()
                if part < n:
                    batch = self._exec(child, part)
                    # positional alignment: rename to the union's output schema
                    return ColumnBatch(schema, batch.columns, num_rows=batch.num_rows)
                part -= n
            raise ExecutionError("union partition out of range")
        if isinstance(plan, P.MegastageExec):
            # no mesh program on the host engine: the boundary is a no-op
            # wrapper — the inline exchanges below materialize like plain
            # repartitions, which is value-identical to the fused program
            return self._exec(plan.input, part)
        if isinstance(plan, P.RepartitionExec):
            parts = self._repartitioned(plan)
            return parts[part]
        if isinstance(plan, P.ShuffleReaderExec):
            return self._read_shuffle(plan, part)
        if isinstance(plan, P.UnresolvedShuffleExec):
            raise ExecutionError(
                f"UnresolvedShuffleExec(stage={plan.stage_id}) cannot execute"
            )
        if isinstance(plan, P.ShuffleWriterExec):
            # standalone in-process path: behave like Repartition
            if plan.partitioning is None:
                return self._exec(plan.input, part)
            parts = self._repartitioned(plan)
            return parts[part]
        raise ExecutionError(f"numpy engine cannot execute {type(plan).__name__}")

    # ---- streaming (bounded-memory) path ---------------------------------------------
    def execute_partition_stream(self, plan: P.PhysicalPlan, partition: int):
        """One-shot execution as a one-chunk stream. Chunked streaming over a
        shuffle read is not ported yet."""
        if any(isinstance(n, P.ShuffleReaderExec) for n in P.walk_physical(plan)):
            raise ExecutionError("streamed shuffle reads are not ported to ballista_tpu_torch yet")
        yield self.execute_partition(plan, partition)

    # ---- pipeline breakers ----------------------------------------------------------
    def _materialize(self, plan: P.PhysicalPlan) -> list[ColumnBatch]:
        return self._compute_once(
            id(plan),
            lambda: [self._exec(plan, i) for i in range(plan.output_partitions())],
        )

    def _compute_once(self, key: int, compute):
        """Per-key coalesced compute-once across partition threads (same
        discipline as LoadingCache.get_with): concurrent partitions needing
        the same pipeline-breaker result share one computation, while
        different breakers proceed in parallel."""
        import threading

        while True:
            with self._lock:
                if key in self._cache:
                    return self._cache[key]
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    break
            ev.wait()
        try:
            value = compute()
        except BaseException:
            with self._lock:
                self._inflight.pop(key).set()
            raise
        with self._lock:
            self._cache[key] = value
            self._inflight.pop(key).set()
        return value

    def _materialized_single(self, plan: P.PhysicalPlan) -> ColumnBatch:
        batches = self._materialize(plan)
        return ColumnBatch.concat(batches) if batches else ColumnBatch.empty(plan.schema())

    def _repartitioned(self, plan):
        """Materialize a hash exchange (RepartitionExec or in-process
        ShuffleWriterExec) in memory. Spilling the exchange to disk is not
        ported yet."""

        def compute():
            n = plan.partitioning.n
            outs: list[list[ColumnBatch]] = [[] for _ in range(n)]
            for i in range(plan.input.output_partitions()):
                batch = self._exec(plan.input, i)
                for j, b in enumerate(
                    K.hash_partition(batch, plan.partitioning.exprs, n)
                ):
                    outs[j].append(b)
            return [
                ColumnBatch.concat(bs) if bs else ColumnBatch.empty(plan.schema())
                for bs in outs
            ]

        return self._compute_once(id(plan), compute)

    # ---- leaves ----------------------------------------------------------------------
    def _scan_parquet(self, plan: P.ParquetScanExec, part: int) -> ColumnBatch:
        files = plan.file_groups[part] if plan.file_groups else []
        cols = plan.projection
        # pushable predicates prune parquet row groups at read time
        # (reference: ballista.parquet.pruning); residual filters run below
        pushed = _to_arrow_filter(plan.filters)

        def read(f):
            if "://" in f:
                raise ExecutionError(
                    f"object-store scans are not ported to ballista_tpu_torch yet: {f!r}"
                )
            if self.data_cache_enabled:
                whole = _DATA_CACHE.get_with(("pq", f), lambda: pq.read_table(f))
                t = whole.select(cols) if cols is not None else whole
                return t  # residual filters below cover the pushed predicates
            return pq.read_table(f, columns=cols, filters=pushed)

        tables = [read(f) for f in files]
        if tables:
            table = pa.concat_tables(tables)
            if cols is not None:
                table = table.select(cols)
            batch = ColumnBatch.from_arrow(table)
            # parquet may have produced a wider/narrower logical type
            batch = _align(batch, plan.schema())
        else:
            batch = ColumnBatch.empty(plan.schema())
        if plan.dict_refs:
            # shared-dictionary references ride the scanned Columns from here:
            # leaf encodes emit stable codes, shuffles may move codes on the
            # wire (docs/strings.md)
            from ballista_tpu_torch.engine.dictionaries import lookup_ref

            for f, c in zip(batch.schema, batch.columns):
                did = lookup_ref(plan.dict_refs, f.name)
                if did and f.dtype is DataType.STRING:
                    c.dict_id = did
        for f in plan.filters:
            batch = batch.filter(to_filter_mask(evaluate(f, batch)))
        return batch

    def _read_shuffle(self, plan: P.ShuffleReaderExec, part: int) -> ColumnBatch:
        raise ExecutionError("shuffle reads are not ported to ballista_tpu_torch yet")


def _to_arrow_filter(filters):
    """Convert simple conjuncts (col <op> literal, col IN list) to a pyarrow
    read filter for row-group pruning. Unconvertible conjuncts are simply not
    pushed — all filters still re-apply after the read, so this is safe."""
    import datetime

    from ballista_tpu_torch.plan.expr import BinaryOp, Col as ColE, InList, Lit, conjuncts

    out = []
    for f in filters:
        for c in conjuncts(f):
            if (
                isinstance(c, BinaryOp)
                and c.op in ("=", "!=", "<", "<=", ">", ">=")
                and isinstance(c.left, ColE)
                and isinstance(c.right, Lit)
            ):
                v = c.right.value
                if c.right.dtype is DataType.DATE32:
                    v = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))
                name = c.left.col.split(".")[-1]
                out.append((name, c.op if c.op != "=" else "==", v))
            elif (
                isinstance(c, InList)
                and not c.negated
                and isinstance(c.expr, ColE)
                and all(isinstance(v, Lit) for v in c.values)
            ):
                out.append(
                    (c.expr.col.split(".")[-1], "in", [v.value for v in c.values])
                )
    return out or None


def _coerce(c: Column, dtype: DataType) -> Column:
    if c.dtype is dtype:
        return c
    if dtype is DataType.STRING or c.dtype is DataType.STRING:
        return c  # handled by arrow layer
    return Column(dtype, np.asarray(c.data).astype(dtype.to_numpy(), copy=False), c.valid)


def _align(batch: ColumnBatch, schema: Schema) -> ColumnBatch:
    if batch.schema == schema:
        return batch
    cols = [
        _coerce(batch.column(f.name), f.dtype) for f in schema
    ]
    return ColumnBatch(schema, cols, num_rows=batch.num_rows)
