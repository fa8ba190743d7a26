"""BallistaContext: the user-facing entry point.

Reference analog: ``BallistaContext::standalone``
(``arrow-ballista: ballista/client/src/context.rs:85-475``): DDL (CREATE
EXTERNAL TABLE / SHOW TABLES / DROP) is handled client-side against the local
table registry; queries plan locally and execute in-process on the torch
engine's device (or on the host engine with ``backend="numpy"``). Before a
plan runs, the memory governor (``engine/memory_model.py``) sizes its
exchanges to the device budget, flags the joins no width fits as paged, and
refuses a plan nothing fits (``PlanVerificationError``, rule PV007). Remote
contexts, the serving caches, the rest of the plan verifier, EXPLAIN
VERIFY/ANALYZE and span collection are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import pyarrow as pa

from ballista_tpu_torch.client.catalog import Catalog
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import (
    BallistaError, PlanningError, PlanVerificationError, SqlError,
)
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
    ):
        self.config = config or BallistaConfig()
        self.backend = backend or self.config.executor_backend()
        if self.backend not in ("torch", "numpy"):
            raise BallistaError(f"unknown backend {self.backend!r} (torch|numpy)")
        self.device: Optional[str] = None
        if self.backend == "torch":
            from ballista_tpu_torch.engine.torch_engine import resolve_device

            self.device = resolve_device(device)
        self.catalog = Catalog(config=self.config)
        # per-operator metrics of the last query (filled by _execute_plan)
        self.last_engine_metrics: dict = {}
        # the memory governor's mitigations of the last query, as PV007
        # warnings, and its report (memory_model.MemoryReport, or None when
        # no budget applied)
        self.last_warnings: list[str] = []
        self.last_memory_report = None
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

    # ---- registration (reference: context.rs read_*/register_*) ---------------------
    def register_parquet(self, name: str, path: str, **kw) -> None:
        self.catalog.register_parquet(name, path, **kw)

    def register_csv(self, name: str, path: str, **kw) -> None:
        self.catalog.register_csv(name, path, **kw)

    def register_json(self, name: str, path: str) -> None:
        self.catalog.register_json(name, path)

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
        stmt = parse_sql(sql)
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
            if stmt.analyze or stmt.verify:
                raise SqlError(
                    "EXPLAIN ANALYZE/VERIFY are not ported to ballista_tpu_torch yet"
                )
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
        assert isinstance(stmt, Query)
        plan = SqlPlanner(self.catalog.schemas()).plan(stmt)
        return DataFrame(self, plan)

    # ---- execution ------------------------------------------------------------------
    def _execute_plan(self, plan: LogicalPlan) -> pa.Table:
        self.last_warnings = []
        self.last_memory_report = None
        optimized = optimize(plan, self.catalog)
        physical = self._govern(PhysicalPlanner(self.catalog, self.config).plan(optimized))
        engine = self._get_engine()
        batches = engine.execute_all(physical)
        # per-query operator metrics for callers (device accounting) — the
        # engine itself is per-query
        self.last_engine_metrics = dict(engine.op_metrics)
        out_schema = physical.schema()
        tables = [b.to_arrow() for b in batches if b.num_rows or len(batches) == 1]
        if not tables:
            tables = [ColumnBatch.empty(out_schema).to_arrow()]
        return pa.concat_tables(tables)

    def _govern(self, physical):
        """The memory governor over the plan about to run: its mitigations
        (repartitioned, paged) become PV007 warnings in ``last_warnings``; a
        plan no mitigation fits raises ``PlanVerificationError`` with the
        governor's messages (the JAX package's ``verify_memory`` rule)."""
        from ballista_tpu_torch.engine.memory_model import govern_with_config

        physical, report = govern_with_config(
            physical, self.config, 1, detected_budget_bytes=self._detected_budget(),
            device=self.device)
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
