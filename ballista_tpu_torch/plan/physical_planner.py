"""Logical -> physical planning.

Reference analog: DataFusion's ``DefaultPhysicalPlanner`` (run scheduler-side,
survey §3.1 ``create_physical_plan``) — including where it inserts the
pipeline breakers (``RepartitionExec``, ``CoalescePartitionsExec``,
``SortPreservingMergeExec``) that Ballista's DistributedPlanner later turns
into stage boundaries (``scheduler/src/planner.rs:80-163``).

Partitioned-vs-broadcast join choice follows the reference's
``hash_join_single_partition_threshold`` idea but on estimated row counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ballista_tpu_torch.client.catalog import Catalog
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan import logical as L
from ballista_tpu_torch.plan.expr import Alias, Col, Expr, unalias
from ballista_tpu_torch.plan.physical import (
    CoalescePartitionsExec,
    CrossJoinExec,
    EmptyExec,
    FilterExec,
    HashAggregateExec,
    HashJoinExec,
    HashPartitioning,
    LimitExec,
    MemoryScanExec,
    ParquetScanExec,
    PhysicalPlan,
    ProjectExec,
    RepartitionExec,
    SortExec,
    SortPreservingMergeExec,
)
from ballista_tpu_torch.plan.schema import DataType, Schema

BROADCAST_ROWS_THRESHOLD = 500_000


class PhysicalPlanner:
    def __init__(self, catalog: Catalog, config: Optional[BallistaConfig] = None):
        self.catalog = catalog
        self.config = config or BallistaConfig()

    def plan(self, logical: L.LogicalPlan) -> PhysicalPlan:
        phys = self._plan(logical)
        return phys

    # ------------------------------------------------------------------------------
    def _plan(self, node: L.LogicalPlan) -> PhysicalPlan:
        if isinstance(node, L.Scan):
            meta = self.catalog.get(node.table)
            if meta.format == "memory":
                phys: PhysicalPlan = MemoryScanExec(
                    meta.partitions, meta.schema, node.projection
                )
                for f in node.filters:
                    phys = FilterExec(phys, f)
                return phys
            return ParquetScanExec(
                node.table, meta.file_groups, meta.schema, node.projection,
                node.filters, dict(meta.dict_refs) or None,
                # per-group parquet row counts (leaf-stage row estimates)
                meta.group_row_counts(),
            )

        if isinstance(node, L.EmptyRelation):
            return EmptyExec(node.produce_one_row)

        if isinstance(node, L.Filter):
            child = self._plan(node.input)
            pushed = _push_filter_into_scan(child, node.predicate)
            if pushed is not None:
                return pushed
            return FilterExec(child, node.predicate)

        if isinstance(node, L.Project):
            return ProjectExec(self._plan(node.input), node.exprs)

        if isinstance(node, L.SubqueryAlias):
            child = self._plan(node.input)
            in_schema = child.schema()
            out_schema = node.schema()
            exprs = [
                Alias(Col(f.name), o.name) for f, o in zip(in_schema, out_schema)
            ]
            return ProjectExec(child, exprs)

        if isinstance(node, L.Aggregate):
            return self._plan_aggregate(node)

        if isinstance(node, L.Join):
            return self._plan_join(node)

        if isinstance(node, L.Sort):
            child = self._plan(node.input)
            out = SortExec(child, node.keys)
            if out.output_partitions() > 1:
                out = SortPreservingMergeExec(out, node.keys)
            return out

        if isinstance(node, L.Limit):
            child = self._plan(node.input)
            fetch = None if node.n < 0 else node.n + node.offset
            # Limit(Sort) -> per-partition top-(k+offset), merge, global slice
            if isinstance(child, SortPreservingMergeExec):
                inner = child.input
                if isinstance(inner, SortExec):
                    inner = SortExec(inner.input, inner.keys, fetch=fetch)
                    child = SortPreservingMergeExec(inner, child.keys)
                return LimitExec(child, node.n, global_=True, offset=node.offset)
            if isinstance(child, SortExec):
                child = SortExec(child.input, child.keys, fetch=fetch)
                return LimitExec(child, node.n, global_=True, offset=node.offset)
            if child.output_partitions() > 1:
                if fetch is not None:
                    child = LimitExec(child, fetch, global_=False)
                child = CoalescePartitionsExec(child)
            return LimitExec(child, node.n, global_=True, offset=node.offset)

        if isinstance(node, L.Union):
            from ballista_tpu_torch.plan.physical import UnionExec

            return UnionExec([self._plan(c) for c in node.inputs])

        if isinstance(node, L.Window):
            return self._plan_window(node)

        raise PlanningError(f"cannot physically plan {type(node).__name__}")

    # ------------------------------------------------------------------------------
    def _plan_aggregate(self, node: L.Aggregate) -> PhysicalPlan:
        child = self._plan(node.input)
        in_schema = child.schema()
        nparts = child.output_partitions()
        shuffle_n = self.config.shuffle_partitions()

        if nparts == 1:
            return HashAggregateExec(child, "single", node.group_exprs, node.agg_exprs)

        partial = HashAggregateExec(child, "partial", node.group_exprs, node.agg_exprs)
        if node.group_exprs:
            group_cols = [Col(g.name()) for g in node.group_exprs]
            exchange: PhysicalPlan = RepartitionExec(
                partial, HashPartitioning(tuple(group_cols), shuffle_n),
                est_rows=estimate_rows(partial, self.catalog),
            )
        else:
            exchange = CoalescePartitionsExec(partial)
        return HashAggregateExec(
            exchange,
            "final",
            [Col(g.name()) for g in node.group_exprs],
            node.agg_exprs,
            input_schema_for_aggs=in_schema,
        )

    def _plan_window(self, node: L.Window) -> PhysicalPlan:
        """Group window expressions by PARTITION BY spec; each group gets an
        exchange co-locating its partitions (hash on the keys, or a single
        partition when unpartitioned), then per-partition evaluation."""
        from ballista_tpu_torch.plan.expr import (
            FOLLOWING, PRECEDING, WindowFunc, unalias as _unalias,
        )
        from ballista_tpu_torch.plan.physical import WindowExec

        child = self._plan(node.input)
        in_schema = child.schema()
        groups: dict[tuple, list] = {}
        for e in node.window_exprs:
            w = _unalias(e)
            assert isinstance(w, WindowFunc)
            # same frame validation the SQL parser applies — programmatically
            # built plans (DataFrame API, deserialized plans) must not reach
            # execution with a frame the parser would have rejected
            if w.frame is not None:
                try:
                    w.frame.validate()
                except ValueError as err:
                    raise PlanningError(f"invalid window frame in {w!r}: {err}")
                offsets = [b for b in (w.frame.start, w.frame.end)
                           if b[0] in (PRECEDING, FOLLOWING)]
                if w.frame.units == "range" and offsets:
                    if len(w.order_by) != 1:
                        raise PlanningError(
                            f"RANGE frame with offsets in {w!r} requires "
                            "exactly one ORDER BY key"
                        )
                    key_t = w.order_by[0][0].data_type(in_schema)
                    if not (key_t.is_numeric or key_t is DataType.DATE32):
                        raise PlanningError(
                            f"RANGE frame offsets in {w!r} require a numeric "
                            f"ORDER BY key, got {key_t.value}"
                        )
            groups.setdefault(tuple(repr(p) for p in w.partition_by), []).append(e)

        out = child
        for key, exprs in groups.items():
            w0 = _unalias(exprs[0])
            if w0.partition_by and out.output_partitions() > 1:
                out = RepartitionExec(
                    out,
                    HashPartitioning(tuple(w0.partition_by), self.config.shuffle_partitions()),
                    est_rows=estimate_rows(out, self.catalog),
                )
            elif not w0.partition_by and out.output_partitions() > 1:
                out = CoalescePartitionsExec(out)
            out = WindowExec(out, exprs)
        return out

    def _plan_join(self, node: L.Join) -> PhysicalPlan:
        left = self._plan(node.left)
        right = self._plan(node.right)

        # inner joins: build from the smaller side (usually the PK side) — the
        # standard hash-join choice, and it keeps build keys unique so the
        # device searchsorted path applies (reference analog: DataFusion's
        # JoinSelection swaps inputs on statistics)
        if (
            node.how == "inner"
            and node.on
            and estimate_rows(right, self.catalog) > 2 * estimate_rows(left, self.catalog)
        ):
            out_names = [f.name for f in node.schema()]
            swapped = L.Join(
                node.right, node.left, "inner",
                [(r, l) for l, r in node.on], node.filter,
            )
            inner = self._plan_join_sides(swapped, right, left)
            # restore the original column order
            return ProjectExec(inner, [Col(n) for n in out_names])
        return self._plan_join_sides(node, left, right)

    def _plan_join_sides(self, node: L.Join, left, right) -> PhysicalPlan:
        if node.how == "cross":
            if right.output_partitions() > 1:
                right = CoalescePartitionsExec(right)
            return CrossJoinExec(left, right)

        est_right = estimate_rows(right, self.catalog)
        broadcast_ok = node.how in ("inner", "left", "semi", "anti")
        # session override wins; the module constant keeps working for tests
        # that patch it directly
        from ballista_tpu_torch.config import BALLISTA_BROADCAST_ROWS_THRESHOLD

        raw = self.config.settings().get(BALLISTA_BROADCAST_ROWS_THRESHOLD)
        threshold = int(raw) if raw is not None else BROADCAST_ROWS_THRESHOLD
        if broadcast_ok and est_right <= threshold:
            if right.output_partitions() > 1:
                right = CoalescePartitionsExec(right)
            return HashJoinExec(
                left, right, node.how, node.on, node.filter, collect_build=True
            )

        # partitioned hash join: both sides exchanged on the join keys
        n = self.config.shuffle_partitions()
        lkeys = tuple(l for l, _ in node.on)
        rkeys = tuple(r for _, r in node.on)
        if not lkeys:
            # no equi keys (pure filter join): broadcast for kinds where each
            # probe partition seeing the whole build side is correct; for
            # right/full outer, collapse both sides to one partition instead
            # (unmatched build rows must be emitted exactly once globally)
            if right.output_partitions() > 1:
                right = CoalescePartitionsExec(right)
            if broadcast_ok:
                return HashJoinExec(left, right, node.how, [], node.filter, collect_build=True)
            if left.output_partitions() > 1:
                left = CoalescePartitionsExec(left)
            return HashJoinExec(left, right, node.how, [], node.filter)
        left = RepartitionExec(left, HashPartitioning(lkeys, n),
                               est_rows=estimate_rows(left, self.catalog))
        right = RepartitionExec(right, HashPartitioning(rkeys, n),
                                est_rows=estimate_rows(right, self.catalog))
        return HashJoinExec(left, right, node.how, node.on, node.filter)


def _push_filter_into_scan(child: PhysicalPlan, predicate) -> Optional[PhysicalPlan]:
    """Merge a filter into a parquet scan, looking through the table-alias
    rename projection: Filter(Project[renames](Scan)) ->
    Project[renames](Scan+filter). Scan-level filters evaluate right after the
    read (and prune row groups when convertible)."""
    from ballista_tpu_torch.plan.expr import Alias as AliasE, Col as ColE, transform

    if isinstance(child, ParquetScanExec):
        return ParquetScanExec(
            child.table, child.file_groups, child.table_schema,
            child.projection, child.filters + [predicate], child.dict_refs,
            child.group_rows,
        )
    if isinstance(child, ProjectExec) and isinstance(child.input, ParquetScanExec):
        renames = {}
        for e in child.exprs:
            if isinstance(e, AliasE) and isinstance(e.expr, ColE):
                renames[e.alias_name] = e.expr.col
            elif isinstance(e, ColE):
                renames[e.col] = e.col
            else:
                return None  # computing projection: don't push
        def fix(n):
            if isinstance(n, ColE):
                return ColE(renames.get(n.col, n.col.split(".")[-1]))
            return None

        scan = child.input
        rewritten = transform(predicate, fix)
        new_scan = ParquetScanExec(
            scan.table, scan.file_groups, scan.table_schema,
            scan.projection, scan.filters + [rewritten], scan.dict_refs,
            scan.group_rows,
        )
        return ProjectExec(new_scan, child.exprs)
    return None


def estimate_rows(plan: PhysicalPlan, catalog: Catalog) -> int:
    """Crude cardinality estimate used only for broadcast-side choice."""
    if isinstance(plan, ParquetScanExec):
        # prefer the plan-stamped parquet footer counts (exact, catalog-free:
        # the scheduler estimates off decoded templates too); the crude /3
        # filter selectivity guess is unchanged
        rows = (
            sum(plan.group_rows)
            if plan.group_rows
            else catalog.get(plan.table).num_rows
        )
        return max(1, rows // (3 if plan.filters else 1))
    if isinstance(plan, MemoryScanExec):
        return max(1, sum(len(p) for p in plan.partitions))
    if isinstance(plan, FilterExec):
        return max(1, estimate_rows(plan.input, catalog) // 3)
    if isinstance(plan, HashAggregateExec):
        return max(1, estimate_rows(plan.input, catalog) // 4)
    if isinstance(plan, HashJoinExec):
        l = estimate_rows(plan.left, catalog)
        if plan.how in ("semi", "anti"):
            return l
        return max(l, estimate_rows(plan.right, catalog))
    if isinstance(plan, CrossJoinExec):
        return estimate_rows(plan.left, catalog)
    if isinstance(plan, LimitExec):
        return min(plan.n, estimate_rows(plan.input, catalog))
    kids = plan.children()
    if not kids:
        return 1
    return max(estimate_rows(c, catalog) for c in kids)
