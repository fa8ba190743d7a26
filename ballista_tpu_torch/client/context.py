"""BallistaContext: the user-facing entry point.

Reference analog: ``BallistaContext::{standalone,remote}``
(``arrow-ballista: ballista/client/src/context.rs:85-475``): DDL (CREATE
EXTERNAL TABLE / SHOW TABLES / DROP) is handled client-side against the local
table registry. A standalone context plans locally and executes in-process
on the torch engine's device (or on the host engine with
``backend="numpy"``); before a plan runs, the memory governor
(``engine/memory_model.py``) sizes its exchanges to the device budget, flags
the joins no width fits as paged, and refuses a plan nothing fits
(``PlanVerificationError``, rule PV007). A remote context ships the logical
plan to a scheduler (``client/remote.py``), which plans, governs and verifies
it and runs its stages on the executors.

A standalone query records a trace: a ``query`` span of the client, and the
engine's operator and device spans under it (``last_trace_spans``). The
session's plan and result caches (``ballista.serving.plan_cache`` and
``ballista.serving.result_cache``) serve repeat statements. EXPLAIN VERIFY
runs the plan verifier over the governed plan without executing it; EXPLAIN
ANALYZE runs the query with tracing and renders the plan that ran, each
operator annotated with its spans (``obs/explain.py``); over a remote context
it renders the scheduler's whole trace of the job.
"""
from __future__ import annotations

from typing import Optional

import pyarrow as pa

from ballista_tpu_torch.client.catalog import Catalog
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import (
    BallistaError, PlanningError, PlanVerificationError, SqlError,
)
from ballista_tpu_torch.obs import tracing as obs
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan.logical import LogicalPlan
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
from ballista_tpu_torch.plan.schema import DataType, Schema
from ballista_tpu_torch.sql.ast_nodes import (
    CreateExternalTable,
    DropTable,
    Explain,
    Query,
    ShowTables,
)
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import SqlPlanner


class DataFrame:
    """Lazy plan builder + result handle.

    Reference analog: the full DataFusion DataFrame the client re-exports
    (``arrow-ballista: ballista/client/src/context.rs:85-475``,
    ``python/src/context.rs:43-120``): select / filter / aggregate / join /
    sort / limit / distinct / union builders compose a logical plan; collect
    executes it (in-process standalone, or shipped to the scheduler).
    Expressions come from ``ballista_tpu_torch.client.functions`` (col/lit/sum/...).
    """

    def __init__(self, ctx: "BallistaContext", plan: LogicalPlan):
        self._ctx = ctx
        self._plan = plan

    def logical_plan(self) -> LogicalPlan:
        return self._plan

    def schema(self) -> Schema:
        return self._plan.schema()

    def collect(self) -> pa.Table:
        return self._ctx._execute_plan(self._plan)

    def to_pandas(self):
        return self.collect().to_pandas()

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Limit

        return DataFrame(self._ctx, Limit(self._plan, n, offset))

    def explain(self) -> str:
        return repr(optimize(self._plan, self._ctx.catalog))

    # ---- builders -----------------------------------------------------------------
    def _exprs(self, items) -> list:
        from ballista_tpu_torch.plan.expr import Col, Expr

        out = []
        for e in items:
            e = Col(e) if isinstance(e, str) else e
            if not isinstance(e, Expr):
                raise TypeError(
                    f"expected an expression or column name, got {type(e).__name__}: {e!r}"
                )
            out.append(e)
        return out

    def select(self, *exprs) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Project

        return DataFrame(self._ctx, Project(self._plan, self._exprs(exprs)))

    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*names)

    def filter(self, predicate) -> "DataFrame":
        from ballista_tpu_torch.plan.expr import Expr
        from ballista_tpu_torch.plan.logical import Filter

        if not isinstance(predicate, Expr):
            # the likeliest way to get here: col("a") == x / != x, which are
            # STRUCTURAL comparisons returning bool — value equality is
            # col("a").eq(x) / .not_eq(x)
            raise TypeError(
                f"filter predicate must be an expression, got {type(predicate).__name__} "
                "(use .eq()/.not_eq() for value equality — == compares structure)"
            )
        return DataFrame(self._ctx, Filter(self._plan, predicate))

    where = filter

    def aggregate(self, group_by, aggs) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Aggregate

        return DataFrame(
            self._ctx, Aggregate(self._plan, self._exprs(group_by), self._exprs(aggs))
        )

    def sort(self, *keys) -> "DataFrame":
        """Keys: Expr / column name (ascending) or (expr, ascending) tuples
        (the shape ``col("a").sort(ascending=False)`` produces)."""
        from ballista_tpu_torch.plan.expr import Col
        from ballista_tpu_torch.plan.logical import Sort

        specs = []
        for k in keys:
            if isinstance(k, tuple):
                e, asc = k
                specs.append((Col(e) if isinstance(e, str) else e, bool(asc)))
            else:
                specs.append((Col(k) if isinstance(k, str) else k, True))
        return DataFrame(self._ctx, Sort(self._plan, specs))

    def join(self, right: "DataFrame", on, how: str = "inner") -> "DataFrame":
        """``on``: column name(s) present on both sides, or a
        (left_names, right_names) pair."""
        from ballista_tpu_torch.plan.expr import Col
        from ballista_tpu_torch.plan.logical import Join

        if isinstance(on, str):
            pairs = [(Col(on), Col(on))]
        elif (
            isinstance(on, tuple)
            and len(on) == 2
            and isinstance(on[0], (list, tuple))
        ):
            pairs = [(Col(l), Col(r)) for l, r in zip(on[0], on[1])]
        else:
            pairs = [(Col(c), Col(c)) for c in on]
        return DataFrame(self._ctx, Join(self._plan, right._plan, how, pairs))

    def distinct(self) -> "DataFrame":
        from ballista_tpu_torch.plan.expr import Col
        from ballista_tpu_torch.plan.logical import Aggregate

        cols = [Col(f.name) for f in self.schema()]
        return DataFrame(self._ctx, Aggregate(self._plan, cols, []))

    def union(self, other: "DataFrame") -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Union

        # UnionExec aligns POSITIONALLY: same column set in a different order
        # is silently reordered by name; a different column set is an error
        mine = [f.name for f in self.schema()]
        theirs = [f.name for f in other.schema()]
        if mine != theirs:
            if sorted(mine) != sorted(theirs):
                raise BallistaError(
                    f"union schema mismatch: {mine} vs {theirs}"
                )
            other = other.select(*mine)
        return DataFrame(self._ctx, Union([self._plan, other._plan]))

    def union_distinct(self, other: "DataFrame") -> "DataFrame":
        return self.union(other).distinct()

    def with_column(self, name: str, expr) -> "DataFrame":
        from ballista_tpu_torch.plan.expr import Col

        names = [f.name for f in self.schema()]
        if name in names:  # replace IN PLACE (column order is load-bearing)
            exprs = [
                expr.alias(name) if n == name else Col(n) for n in names
            ]
            return self.select(*exprs)
        return self.select(*[Col(n) for n in names], expr.alias(name))

    def with_column_renamed(self, old: str, new: str) -> "DataFrame":
        from ballista_tpu_torch.plan.expr import Col

        exprs = [
            Col(f.name).alias(new) if f.name == old else Col(f.name)
            for f in self.schema()
        ]
        return self.select(*exprs)

    def drop_columns(self, *names: str) -> "DataFrame":
        keep = [f.name for f in self.schema() if f.name not in names]
        return self.select(*keep)

    def count(self) -> int:
        from ballista_tpu_torch.plan.expr import Agg
        from ballista_tpu_torch.plan.logical import Aggregate

        out = DataFrame(
            self._ctx, Aggregate(self._plan, [], [Agg("count_star").alias("count")])
        ).collect()
        return int(out.column("count")[0].as_py())

    def show(self, n: int = 20) -> None:
        print(self.limit(n).collect().to_pandas().to_string(index=False))

    # ---- writers (reference: DataFrame::write_{parquet,csv,json}) ------------------
    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        pq.write_table(self.collect(), path)

    def write_csv(self, path: str) -> None:
        import pyarrow.csv as pacsv

        pacsv.write_csv(self.collect(), path)

    def write_json(self, path: str) -> None:
        df = self.collect().to_pandas()
        df.to_json(path, orient="records", lines=True)


class BallistaContext:
    def __init__(
        self,
        config: Optional[BallistaConfig] = None,
        backend: Optional[str] = None,
        device: Optional[str] = None,
        remote: Optional[tuple[str, int]] = None,
    ):
        self.config = config or BallistaConfig()
        self.backend = backend or self.config.executor_backend()
        if self.backend not in ("torch", "numpy"):
            raise BallistaError(f"unknown backend {self.backend!r} (torch|numpy)")
        # (host, port) of the scheduler a remote context submits to; its
        # executors pick their own engines and devices
        self.remote = remote
        self.device: Optional[str] = None
        if self.backend == "torch" and remote is None:
            from ballista_tpu_torch.engine.torch_engine import resolve_device

            self.device = resolve_device(device)
        self.catalog = Catalog(config=self.config)
        # per-operator metrics of the last query (filled by _execute_plan)
        self.last_engine_metrics: dict = {}
        # op.Plan.* of the statement not yet executed
        self._plan_metrics: dict = {}
        # the memory governor's mitigations of the last query, as PV007
        # warnings, and its report (memory_model.MemoryReport, or None when
        # no budget applied)
        self.last_warnings: list[str] = []
        self.last_memory_report = None
        # the last remote query's job and its client-side spans
        # (client/remote.py fills them)
        self.last_job_id: Optional[str] = None
        self.last_trace_id: Optional[str] = None
        self.last_trace_spans: list[dict] = []
        # the serving caches' outcome for the last statement:
        # {"plan_cache": "hit|miss", "result_cache": "hit|miss"}, a key
        # absent when its cache was off or bypassed
        self.last_serving: dict = {}
        # the session's serving caches, built on first use
        self._plan_cache = None
        self._result_cache = None
        # the governed plan the last standalone query ran (EXPLAIN ANALYZE
        # renders it)
        self._last_executed_physical = None
        # reference: plugin_manager.rs scans the configured dir at startup;
        # entry-point UDFs load unconditionally so pip-installed plugins are
        # visible to every process that parses SQL
        from ballista_tpu_torch.utils.udf import load_plugins

        load_plugins(self.config.get("ballista.plugin_dir"))

    # ---- constructors (reference: context.rs BallistaContext::standalone) ------------
    @staticmethod
    def standalone(
        config: Optional[BallistaConfig] = None,
        backend: str = "torch",
        device: Optional[str] = None,
    ) -> "BallistaContext":
        """In-process context. ``device=None`` means ``cuda``, which raises
        when CUDA is unavailable; pass ``device="cpu"`` to run the torch engine
        on the host."""
        return BallistaContext(config, backend=backend, device=device)

    @staticmethod
    def remote(
        host: str, port: int, config: Optional[BallistaConfig] = None
    ) -> "BallistaContext":
        """A context whose queries run on the cluster behind the scheduler
        at ``host:port``. Tables must be file-backed (the executors read
        them); the session's settings ride every query to the tasks."""
        return BallistaContext(config, remote=(host, port))

    # ---- registration (reference: context.rs read_*/register_*) ---------------------
    def register_parquet(self, name: str, path: str, **kw) -> None:
        self.catalog.register_parquet(name, path, **kw)

    def register_csv(self, name: str, path: str, **kw) -> None:
        self.catalog.register_csv(name, path, **kw)

    def register_json(self, name: str, path: str) -> None:
        self.catalog.register_json(name, path)

    def register_avro(self, name: str, path: str) -> None:
        self.catalog.register_avro(name, path)

    def read_parquet(self, path: str, **kw) -> "DataFrame":
        name = f"__read_{len(self.catalog.tables)}"
        self.register_parquet(name, path, **kw)
        return self.table(name)

    def read_csv(self, path: str, **kw) -> "DataFrame":
        name = f"__read_{len(self.catalog.tables)}"
        self.register_csv(name, path, **kw)
        return self.table(name)

    def read_json(self, path: str) -> "DataFrame":
        name = f"__read_{len(self.catalog.tables)}"
        self.register_json(name, path)
        return self.table(name)

    def table(self, name: str) -> "DataFrame":
        from ballista_tpu_torch.plan.logical import Scan

        meta = self.catalog.get(name)
        return DataFrame(self, Scan(name.lower(), meta.schema))

    def register_arrow(self, name: str, table: pa.Table, partitions: int = 1) -> None:
        batch = ColumnBatch.from_arrow(table)
        n = max(1, partitions)
        step = (batch.num_rows + n - 1) // n if batch.num_rows else 1
        parts = [batch.slice(i * step, step) for i in range(n)] if batch.num_rows else [batch]
        self.catalog.register_batches(name, parts, batch.schema)

    def deregister_table(self, name: str) -> bool:
        return self.catalog.deregister(name)

    # ---- SQL ----------------------------------------------------------------------
    def sql(self, sql: str) -> DataFrame:
        # reset per statement, so a statement served locally (SHOW TABLES,
        # EXPLAIN, DDL) never shows an earlier query's warnings or verdicts
        self.last_warnings = []
        self.last_memory_report = None
        self.last_serving = {}
        self._plan_metrics = {}
        with self._plan_phase():
            stmt = parse_sql(sql)
            if isinstance(stmt, Query):
                return DataFrame(self, SqlPlanner(self.catalog.schemas()).plan(stmt))
        if isinstance(stmt, CreateExternalTable):
            if stmt.file_format == "parquet":
                self.register_parquet(stmt.name, stmt.location)
            elif stmt.file_format == "csv":
                schema = None
                if stmt.schema:
                    from ballista_tpu_torch.sql.parser import _SQL_TYPES

                    schema = Schema.of(*[(n, _SQL_TYPES[t]) for n, t in stmt.schema])
                self.register_csv(
                    stmt.name, stmt.location, has_header=stmt.has_header, schema=schema
                )
            else:
                raise SqlError(f"unsupported format {stmt.file_format}")
            return self._values_df([("result", DataType.STRING)], [["created"]])
        if isinstance(stmt, ShowTables):
            names = self.catalog.names()
            return self._values_df([("table_name", DataType.STRING)], [[n] for n in names])
        if isinstance(stmt, DropTable):
            ok = self.deregister_table(stmt.name)
            if not ok and not stmt.if_exists:
                raise PlanningError(f"table {stmt.name!r} not found")
            return self._values_df([("result", DataType.STRING)], [["dropped"]])
        if isinstance(stmt, Explain):
            if stmt.analyze:
                return self._explain_analyze(stmt.query)
            if stmt.verify:
                return self._explain_verify(stmt.query)
            # logical + physical plans (reference: EXPLAIN shows DataFusion's
            # logical/physical plans)
            logical = optimize(SqlPlanner(self.catalog.schemas()).plan(stmt.query), self.catalog)
            physical = PhysicalPlanner(self.catalog, self.config).plan(logical)
            rows = [
                ["logical_plan", repr(logical)],
                ["physical_plan", repr(physical)],
            ]
            return self._values_df(
                [("plan_type", DataType.STRING), ("plan", DataType.STRING)], rows
            )
        raise SqlError(f"unsupported statement {type(stmt).__name__}")

    def _plan_phase(self):
        """A phase of planning (``ballista.query.plan``): its time and count
        go to ``op.Plan`` of the next query executed."""
        return obs.Phase("ballista.query.plan", "op.Plan", _adder(self._plan_metrics))

    _FINDING_FIELDS = [
        ("severity", DataType.STRING),
        ("rule", DataType.STRING),
        ("operator", DataType.STRING),
        ("message", DataType.STRING),
    ]

    def _explain_verify(self, query) -> "DataFrame":
        """EXPLAIN VERIFY: the plan verifier's findings over the logical
        plan, the governed physical plan and its stage split, without
        executing anything. The scheduler runs the same rules at submission,
        where an error finding refuses the job."""
        from ballista_tpu_torch.analysis import verify_logical, verify_submission
        from ballista_tpu_torch.config import BALLISTA_TPU_FUSE_EXCHANGE_MAX_ROWS
        from ballista_tpu_torch.engine.memory_model import govern_with_config

        logical = optimize(SqlPlanner(self.catalog.schemas()).plan(query), self.catalog)
        try:
            physical = PhysicalPlanner(self.catalog, self.config).plan(logical)
        except Exception as e:  # noqa: BLE001 - the report is the product here
            rows = [f.as_row() for f in verify_logical(logical)]
            rows.append(["error", "PLAN", "physical planner",
                         f"physical planning failed: {e}"])
            return self._values_df(self._FINDING_FIELDS, rows)
        # the governor's dry run (PV007 verdicts) over the engine's mesh; the
        # plan verified is the governed one, which standalone execution runs
        # and the scheduler's gate verifies
        governed, memory_report = govern_with_config(
            physical, self.config, self._n_devices(),
            detected_budget_bytes=self._detected_budget(), device=self.device)
        findings = verify_submission(
            logical, governed,
            fuse_exchange_max_rows=self.config.get(BALLISTA_TPU_FUSE_EXCHANGE_MAX_ROWS),
            memory_report=memory_report,
        )
        rows = [f.as_row() for f in findings]
        if not rows:
            rows = [["info", "OK", "", "plan verified: no issues found"]]
        return self._values_df(self._FINDING_FIELDS, rows)

    def _explain_analyze(self, query) -> "DataFrame":
        """EXPLAIN ANALYZE: run the query with tracing, then render the
        physical plan annotated with each operator's rows and elapsed time
        and the query's device, memory and shuffle rollups, from its spans."""
        from ballista_tpu_torch.obs.explain import render_explain_analyze

        logical = SqlPlanner(self.catalog.schemas()).plan(query)
        physical = PhysicalPlanner(self.catalog, self.config).plan(
            optimize(logical, self.catalog))
        # the result is discarded: the spans are the output. Standalone runs
        # this physical plan; a scheduler plans its own copy, so over a
        # remote context the rendered tree is the client's view of it
        self._execute_plan(logical, physical=physical)
        spans = self.last_trace_spans
        job_id = self.last_job_id
        if self.remote is not None and job_id:
            # the scheduler's TraceStore holds the whole distributed trace,
            # the client's spans included (execute_remote reported them)
            from ballista_tpu_torch.client.remote import fetch_trace

            spans = fetch_trace(self, job_id) or spans
        if self.remote is None:
            physical = self._last_executed_physical or physical
        text = render_explain_analyze(physical, spans, job_id=job_id)
        return self._values_df(
            [("plan_type", DataType.STRING), ("plan", DataType.STRING)],
            [["plan_with_metrics", text]],
        )

    # ---- execution ------------------------------------------------------------------
    def _execute_plan(self, plan: LogicalPlan, physical=None) -> pa.Table:
        """Run ``plan`` (or the given ``physical`` plan of it, which bypasses
        the serving caches: EXPLAIN ANALYZE runs to produce spans)."""
        with self._plan_phase():
            rkey, cached, planned = self._plan_execution(plan, physical)
        metrics, self._plan_metrics = self._plan_metrics, {}
        if cached is not None:
            return cached
        if self.remote is not None:
            # planned, governed and verified scheduler-side; its analyzer
            # warnings come back in last_warnings
            from ballista_tpu_torch.client.remote import execute_remote

            self.last_engine_metrics = {}
            result = execute_remote(self, plan)
            # the client's and the job's counters (execute_remote), with the
            # query's planning, as a standalone query reads them
            self.last_engine_metrics = dict(self.last_engine_metrics, **metrics)
            if rkey is not None:
                self._get_result_cache().put(rkey, result)
            return result
        physical, engine, collector, trace_id, root = planned
        obs.set_ambient(collector, trace_id, root.span_id)
        try:
            batches = engine.execute_all(physical)
        finally:
            obs.clear_ambient()
        with obs.Phase("ballista.query.result", "op.Result", _adder(metrics)):
            out_schema = physical.schema()
            tables = [b.to_arrow() for b in batches if b.num_rows or len(batches) == 1]
            if not tables:
                tables = [ColumnBatch.empty(out_schema).to_arrow()]
            result = pa.concat_tables(tables)
            root.set("rows", result.num_rows)
            root.finish()
            self.last_trace_id = trace_id
            self.last_trace_spans = collector.drain()
            self.last_job_id = None
            if rkey is not None:
                self._get_result_cache().put(rkey, result)
        # per-query operator metrics for callers (device accounting) — the
        # engine itself is per-query — with the query's planning and result
        self.last_engine_metrics = dict(engine.op_metrics, **metrics)
        return result

    def _plan_execution(self, plan: LogicalPlan, physical=None) -> tuple:
        """``_execute_plan``'s planning: (result-cache key, the cached answer
        or None, and for a standalone query not answered from the cache its
        governed physical plan, engine, span collector, trace id and root
        span, else None)."""
        from ballista_tpu_torch.config import (
            BALLISTA_SERVING_PLAN_CACHE,
            BALLISTA_SERVING_RESULT_CACHE,
        )

        self.last_warnings = []
        # a remote query is governed scheduler-side: no local report is its
        self.last_memory_report = None
        self.last_serving = {}
        result_cache_on = bool(self.config.get(BALLISTA_SERVING_RESULT_CACHE))
        plan_cache_on = bool(self.config.get(BALLISTA_SERVING_PLAN_CACHE))
        # one key serves both caches (the plan's repr and hash are the
        # statement's fingerprint cost)
        skey = (self._serving_key(plan)
                if physical is None and (result_cache_on or plan_cache_on) else None)
        rkey = skey if result_cache_on else None
        if rkey is not None:
            cached = self._get_result_cache().get(rkey)
            if cached is not None:
                self.last_serving["result_cache"] = "hit"
                return rkey, cached, None
            self.last_serving["result_cache"] = "miss"
        if self.remote is not None:
            return rkey, None, None
        collector = obs.SpanCollector()
        trace_id = obs.new_trace_id()
        root = collector.start("query", trace_id=trace_id, service="client")
        # the plan cache holds governed plans, encoded: each hit decodes a
        # fresh tree; a plan that does not serialize (memory tables) bypasses
        pkey = skey if plan_cache_on else None
        governed = False
        if pkey is not None:
            entry = self._get_plan_cache().get(pkey)
            if entry is not None:
                from ballista_tpu_torch.plan.serde import decode_physical

                physical = decode_physical(entry.plan_bytes)
                self.last_warnings = list(entry.warnings)
                self.last_memory_report = entry.memory_report
                governed = True
                self.last_serving["plan_cache"] = "hit"
        if physical is None:
            optimized = optimize(plan, self.catalog)
            physical = PhysicalPlanner(self.catalog, self.config).plan(optimized)
        if not governed:
            physical = self._govern(physical)
            if pkey is not None:
                self.last_serving["plan_cache"] = "miss"
                try:
                    from ballista_tpu_torch.plan.serde import encode_physical
                    from ballista_tpu_torch.scheduler.serving import PlanEntry

                    self._get_plan_cache().put(pkey, PlanEntry(
                        pkey[0], encode_physical(physical),
                        list(self.last_warnings), self.last_memory_report,
                    ))
                except Exception:  # noqa: BLE001 - not cacheable: bypass
                    pass
        self._last_executed_physical = physical
        engine = self._get_engine()
        engine.trace_ctx = obs.TraceCtx(collector, trace_id, root.span_id)
        return rkey, None, (physical, engine, collector, trace_id, root)

    # ---- serving caches ---------------------------------------------------------------
    def _serving_key(self, plan: LogicalPlan):
        """The statement's cache key: the plan's identity, the catalog's
        version (any registration invalidates), the planning settings'
        digest (the scheduler's, so both tiers agree on what splits a key),
        the backend, device and endpoint. None: not cacheable."""
        import hashlib

        from ballista_tpu_torch.scheduler.serving import settings_digest

        try:
            ident = repr(plan)
        except Exception:  # noqa: BLE001 - a plan with no repr is not cached
            return None
        return (
            hashlib.sha256(ident.encode()).hexdigest()[:24],
            self.catalog.version,
            settings_digest(self.config.settings()),
            self.backend,
            self.device,
            self.remote,
        )

    def _get_plan_cache(self):
        if self._plan_cache is None:
            from ballista_tpu_torch.config import BALLISTA_SERVING_PLAN_CACHE_ENTRIES
            from ballista_tpu_torch.scheduler.serving import PlanCache

            self._plan_cache = PlanCache(self.config.get(BALLISTA_SERVING_PLAN_CACHE_ENTRIES))
        return self._plan_cache

    def _get_result_cache(self):
        if self._result_cache is None:
            from ballista_tpu_torch.config import (
                BALLISTA_SERVING_RESULT_CACHE_BYTES,
                BALLISTA_SERVING_RESULT_MAX_BYTES,
            )
            from ballista_tpu_torch.scheduler.serving import ResultCache

            self._result_cache = ResultCache(
                self.config.get(BALLISTA_SERVING_RESULT_CACHE_BYTES),
                self.config.get(BALLISTA_SERVING_RESULT_MAX_BYTES),
            )
        return self._result_cache

    def _govern(self, physical):
        """The memory governor over the plan about to run: its mitigations
        (repartitioned, paged) become PV007 warnings in ``last_warnings``; a
        plan no mitigation fits raises ``PlanVerificationError`` with the
        governor's messages (the JAX package's ``verify_memory`` rule)."""
        from ballista_tpu_torch.engine.memory_model import govern_with_config

        physical, report = govern_with_config(
            physical, self.config, self._n_devices(),
            detected_budget_bytes=self._detected_budget(), device=self.device)
        self.last_memory_report = report
        if report is not None:
            rejected = [("PV007", d.operator, d.message) for d in report.rejections()]
            if rejected:
                raise PlanVerificationError(rejected)
            self.last_warnings.extend(f"[PV007] {d.operator}: {d.message}"
                                      for d in report.mitigations())
        return physical

    def _detected_budget(self):
        """What the governor's budget resolution may auto-detect from: None
        lets it probe this context's card, which only a torch engine on
        ``cuda`` may do. A host engine (``backend="numpy"``) and a torch
        engine on the CPU use no card budget and get 0 (detection off; an
        explicit ``ballista.engine.hbm_budget_bytes`` still applies)."""
        on_card = self.backend == "torch" and self.device is not None \
            and self.device.startswith("cuda")
        return None if on_card else 0

    def _n_devices(self) -> int:
        """The device-alignment floor for the governor's partition solver:
        a torch engine's mesh of shards (``parallel.mesh_shards``)."""
        if self.backend != "torch" or self.device is None:
            return 1
        from ballista_tpu_torch.parallel import mesh_shards

        return mesh_shards(self.device)

    def _get_engine(self):
        from ballista_tpu_torch.engine.engine import create_engine

        # fresh engine per query: materialization caches are per-execution
        return create_engine(self.backend, self.config, device=self.device)

    def _values_df(self, fields, rows) -> "DataFrame":
        import numpy as np

        schema = Schema.of(*fields)
        data = {
            f.name: np.array([r[i] for r in rows], dtype=object)
            for i, f in enumerate(schema)
        }
        batch = (
            ColumnBatch.from_dict(data, schema)
            if rows
            else ColumnBatch.empty(schema)
        )
        table = batch.to_arrow()
        ctx = self

        class _Static(DataFrame):
            def collect(self) -> pa.Table:
                return table

        from ballista_tpu_torch.plan.logical import EmptyRelation

        return _Static(ctx, EmptyRelation())


def _adder(metrics: dict):
    """``add(key, value)`` summing into ``metrics`` (an ``obs.Phase``'s)."""
    def add(key: str, value: float) -> None:
        metrics[key] = metrics.get(key, 0.0) + value

    return add
