"""SQL AST -> logical plan, including subquery decorrelation.

Reference analog: DataFusion's ``SqlToRel`` + its subquery-unnesting optimizer
rules, which Ballista inherits wholesale (survey §2.5, client planning layer).
The decorrelator here covers the correlation patterns of the TPC-H family:

* ``EXISTS`` / ``NOT EXISTS``  -> semi / anti join (q4, q21, q22)
* ``[NOT] IN (subquery)``      -> semi / anti join (q16, q18, q20)
* correlated scalar aggregate  -> group-by-correlation-key aggregate + inner
  join + filter (q2, q17, q20)
* uncorrelated scalar          -> single-row cross join + filter (q11, q15, q22)
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan.expr import (
    Agg,
    Alias,
    BinaryOp,
    Case,
    Col,
    Exists,
    Expr,
    InSubquery,
    Lit,
    Not,
    OuterCol,
    ScalarSubquery,
    columns_of,
    conjoin,
    conjuncts,
    fold_constants,
    transform,
    unalias,
    walk,
)
from ballista_tpu_torch.plan.logical import (
    Aggregate,
    EmptyRelation,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Scan,
    Sort,
    SubqueryAlias,
)
from ballista_tpu_torch.plan.schema import Schema
from ballista_tpu_torch.sql.ast_nodes import JoinClause, OrderItem, Query, TableRef


class SqlPlanner:
    """Plans one query (recursively for subqueries)."""

    def __init__(self, catalog: dict[str, Schema]):
        self.catalog = {k.lower(): v for k, v in catalog.items()}
        self._sq_counter = itertools.count(1)

    # -- public entry ------------------------------------------------------------
    def plan(self, q: Query) -> LogicalPlan:
        return self._plan_query(q, outer=[])

    # -- scope-aware expression resolution ----------------------------------------
    def _resolve(self, e: Expr, schema: Schema, outer: list[Schema]) -> Expr:
        def fix(node: Expr):
            if isinstance(node, Col):
                if schema.has(node.col):
                    return None  # resolvable locally, keep
                for oschema in outer:
                    if oschema.has(node.col):
                        f = oschema.field(node.col)
                        return OuterCol(f.name, f.dtype)
                raise PlanningError(
                    f"column {node.col!r} not found in scope {schema.names}"
                )
            if isinstance(node, ScalarSubquery) and isinstance(node.plan, Query):
                return ScalarSubquery(self._plan_query(node.plan, [schema] + outer))
            if isinstance(node, InSubquery) and isinstance(node.plan, Query):
                return InSubquery(
                    node.expr, self._plan_query(node.plan, [schema] + outer), node.negated
                )
            if isinstance(node, Exists) and isinstance(node.plan, Query):
                return Exists(self._plan_query(node.plan, [schema] + outer), node.negated)
            return None

        return transform(fold_constants(e), fix)

    # -- query planning -----------------------------------------------------------
    def _plan_query(self, q: Query, outer: list[Schema]) -> LogicalPlan:
        if not q.unions:
            return self._plan_single(q, outer)
        from ballista_tpu_torch.plan.logical import Union

        out = self._plan_single(q, outer, skip_order_limit=True)
        for uq, op, all_ in q.unions:
            right = self._plan_single(uq, outer, skip_order_limit=True)
            if len(right.schema()) != len(out.schema()):
                raise PlanningError("set-operation branches have different column counts")
            if op == "union":
                out = Union([out, right])
                if not all_:
                    out = Aggregate(out, [Col(f.name) for f in out.schema()], [])
            else:
                # INTERSECT / EXCEPT: distinct left, semi/anti join on all cols
                out = Aggregate(out, [Col(f.name) for f in out.schema()], [])
                alias = f"__set{next(self._sq_counter)}"
                right = SubqueryAlias(right, alias)
                on = [
                    (Col(lf.name), Col(rf.name))
                    for lf, rf in zip(out.schema(), right.schema())
                ]
                out = Join(out, right, "semi" if op == "intersect" else "anti", on)
        if q.order_by:
            keys = []
            schema = out.schema()
            for o in q.order_by:
                e = o.expr
                if not (isinstance(e, Col) and schema.has(e.col)):
                    raise PlanningError("UNION ORDER BY must reference output columns")
                keys.append((e, o.asc))
            out = Sort(out, keys)
        if q.limit is not None or q.offset:
            out = Limit(out, q.limit if q.limit is not None else -1, q.offset)
        return out

    def _plan_single(
        self, q: Query, outer: list[Schema], skip_order_limit: bool = False
    ) -> LogicalPlan:
        # 1. FROM items
        items: list[LogicalPlan] = [self._plan_table_ref(t, outer) for t in q.from_tables]
        if not items:
            base: LogicalPlan = EmptyRelation()
        else:
            base = None  # built below

        # explicit JOIN clause tables, planned ONCE (reused by _build_join_tree)
        join_items = [(jc, self._plan_table_ref(jc.table, outer)) for jc in q.joins]

        # 2. WHERE: resolve against the combined FROM schema — including tables
        # introduced by explicit JOIN clauses (their predicates classify as
        # residual in _build_join_tree and apply as a post-join filter, which
        # is WHERE's semantics), split conjuncts
        combined = Schema(
            sum((tuple(p.schema().fields) for p in items), ())
            + sum((tuple(p.schema().fields) for _, p in join_items), ())
        )
        where_conjs: list[Expr] = []
        if q.where is not None:
            resolved = self._resolve(q.where, combined, outer)
            for c in conjuncts(resolved):
                where_conjs.extend(_factor_or(c))

        sub_conjs = [c for c in where_conjs if _has_subquery(c)]
        plain = [c for c in where_conjs if not _has_subquery(c)]

        if items:
            base = self._build_join_tree(items, plain, join_items, outer)

        # explicit JOIN clauses trailing the FROM list (e.g. q13) are handled in
        # _build_join_tree; leftover non-equi predicates come back as filters.

        # 3. unnest subquery predicates
        for c in sub_conjs:
            base = self._unnest_predicate(base, c)

        # 4. projections / aggregation
        proj_exprs = self._expand_star(q.projections, base.schema())
        proj_exprs = [self._resolve(e, base.schema(), outer) for e in proj_exprs]

        # SELECT-list scalar subqueries (uncorrelated): single-row cross join,
        # the subquery value becomes a column of the joined schema
        if any(_has_subquery(e) for e in proj_exprs):
            base, proj_exprs = self._unnest_select_subqueries(base, proj_exprs)

        # ordinals: GROUP BY 1 / ORDER BY 2 refer to select-list positions
        def _ordinal(e: Expr) -> Optional[Expr]:
            if isinstance(e, Lit) and isinstance(e.value, int) and 1 <= e.value <= len(proj_exprs):
                return unalias(proj_exprs[e.value - 1])
            return None

        q_group_by = [(_ordinal(self._resolve(g, base.schema(), outer)) or
                       self._resolve(g, base.schema(), outer)) for g in q.group_by]
        having = (
            self._resolve(q.having, base.schema(), outer) if q.having is not None else None
        )
        order_keys = []
        for o in q.order_by:
            resolved = self._try_resolve_order(o, base.schema(), proj_exprs, outer)
            # non-default NULLS placement desugars into a leading IsNull key
            # (default already is NULLS LAST asc / FIRST desc)
            if o.nulls_first is not None and o.nulls_first != (not o.asc):
                from ballista_tpu_torch.plan.expr import IsNull

                order_keys.append((IsNull(resolved), not o.nulls_first))
            order_keys.append((resolved, o.asc))

        has_agg = bool(q.group_by) or any(
            _contains_agg(e) for e in proj_exprs + ([having] if having is not None else [])
        )

        if has_agg:
            group_exprs = q_group_by
            base, rewrite = self._plan_aggregate(base, group_exprs, proj_exprs, having, order_keys)
            proj_exprs = [rewrite(e) for e in proj_exprs]
            if having is not None:
                having = rewrite(having)
            order_keys = [(rewrite(e), asc) for e, asc in order_keys]

        if having is not None:
            for c in conjuncts(having):
                if _has_subquery(c):
                    base = self._unnest_predicate(base, c)
                else:
                    base = Filter(base, c)

        # window functions: computed after aggregation (their args may
        # reference aggregate outputs), appended as columns by a Window node
        from ballista_tpu_torch.plan.expr import WindowFunc

        windows: dict[str, Expr] = {}
        for e in proj_exprs + [e for e, _ in order_keys]:
            for n in walk(e):
                if isinstance(n, WindowFunc):
                    windows.setdefault(repr(n), n)
        for bad in (
            ([q.where] if q.where is not None else [])
            + ([q.having] if q.having is not None else [])
            + list(q.group_by)
        ):
            if any(isinstance(n, WindowFunc) for n in walk(bad)):
                raise PlanningError(
                    "window functions are not allowed in WHERE/GROUP BY/HAVING"
                )
        if windows:
            from ballista_tpu_torch.plan.logical import Window

            # RANGE frames with numeric offsets need exactly one numeric
            # ORDER BY key (the offset is added to/subtracted from its value)
            from ballista_tpu_torch.plan.expr import FOLLOWING, PRECEDING
            from ballista_tpu_torch.plan.schema import DataType

            for w in windows.values():
                fr = getattr(w, "frame", None)
                if fr is None or fr.units != "range":
                    continue
                offs = {fr.start[0], fr.end[0]} & {PRECEDING, FOLLOWING}
                if not offs:
                    continue
                if len(w.order_by) != 1:
                    raise PlanningError(
                        "RANGE frame with offset requires exactly one ORDER BY key"
                    )
                kdt = w.order_by[0][0].data_type(base.schema())
                if kdt is DataType.STRING:
                    raise PlanningError(
                        "RANGE frame offsets require a numeric ORDER BY key"
                    )

            wlist = [Alias(w, w.name()) for w in windows.values()]
            base = Window(base, wlist)

            def wfix(node: Expr):
                if isinstance(node, WindowFunc):
                    return Col(node.name())
                return None

            proj_exprs = [transform(e, wfix) for e in proj_exprs]
            order_keys = [(transform(e, wfix), asc) for e, asc in order_keys]

        out = Project(base, proj_exprs)

        if q.distinct:
            out = Aggregate(out, [Col(f.name) for f in out.schema()], [])

        # 5. ORDER BY / LIMIT over the projected schema
        if skip_order_limit:
            return out
        if order_keys:
            keys = []
            for e, asc in order_keys:
                keys.append((self._rebase_on_output(e, proj_exprs, out.schema()), asc))
            out = Sort(out, keys)
        if q.limit is not None or q.offset:
            out = Limit(out, q.limit if q.limit is not None else -1, q.offset)
        return out

    def _plan_table_ref(self, t: TableRef, outer: list[Schema]) -> LogicalPlan:
        if t.subquery is not None:
            sub = self._plan_query(t.subquery, outer)
            return SubqueryAlias(sub, t.alias) if t.alias else sub
        name = t.name.lower()
        if name not in self.catalog:
            raise PlanningError(f"table {name!r} not found")
        scan = Scan(name, self.catalog[name])
        # every named table is qualified (alias or table name) so that
        # same-named columns across tables resolve: "big.id1" vs "small.id1"
        return SubqueryAlias(scan, t.alias or name)

    # -- join tree ----------------------------------------------------------------
    def _build_join_tree(
        self,
        items: list[LogicalPlan],
        predicates: list[Expr],
        join_items: list[tuple[JoinClause, LogicalPlan]],
        outer: list[Schema],
    ) -> LogicalPlan:
        schemas = [p.schema() for p in items]

        def owner(cols: set[str]) -> Optional[int]:
            """Index of the single FROM item covering all cols, else None."""
            hit = None
            for i, s in enumerate(schemas):
                if all(s.has(c) for c in cols):
                    if hit is not None:
                        return hit  # ambiguous (e.g. natural key both sides): first wins
                    hit = i
            return hit

        # classify predicates
        single: dict[int, list[Expr]] = {}
        edges: list[tuple[int, int, Expr, Expr]] = []  # (item_i, item_j, expr_i, expr_j)
        residual: list[Expr] = []
        for c in predicates:
            cols = columns_of(c)
            if not cols or any(isinstance(n, OuterCol) for n in walk(c)):
                residual.append(c)
                continue
            o = owner(cols)
            if o is not None:
                single.setdefault(o, []).append(c)
                continue
            pair = _equi_pair(c)
            if pair is not None:
                li, ri = owner(columns_of(pair[0])), owner(columns_of(pair[1]))
                if li is not None and ri is not None and li != ri:
                    edges.append((li, ri, pair[0], pair[1]))
                    continue
            residual.append(c)

        plans = [
            Filter(p, conjoin(single[i])) if i in single else p
            for i, p in enumerate(items)
        ]

        tree = plans[0]
        in_tree = {0}
        remaining = list(range(1, len(plans)))
        while remaining:
            picked = None
            for j in remaining:
                pairs = []
                for li, ri, le, re_ in edges:
                    if li in in_tree and ri == j:
                        pairs.append((le, re_))
                    elif ri in in_tree and li == j:
                        pairs.append((re_, le))
                if pairs:
                    picked = (j, pairs)
                    break
            if picked is None:
                j = remaining[0]
                tree = Join(tree, plans[j], "cross")
            else:
                j, pairs = picked
                tree = Join(tree, plans[j], "inner", pairs)
            in_tree.add(j)
            remaining.remove(j)

        # explicit JOIN ... ON clauses (tables pre-planned by the caller)
        for jc, right in join_items:
            tree = self._apply_explicit_join(tree, right, jc, outer)

        res = conjoin(residual)
        if res is not None:
            tree = Filter(tree, res)
        return tree

    def _apply_explicit_join(
        self, left: LogicalPlan, right: LogicalPlan, jc: JoinClause, outer: list[Schema]
    ) -> LogicalPlan:
        if jc.kind == "cross":
            return Join(left, right, "cross")
        ls, rs = left.schema(), right.schema()
        combined = ls.join(rs)
        on = self._resolve(jc.on, combined, outer)
        pairs, lfilters, rfilters, mixed = [], [], [], []
        for c in conjuncts(on):
            cols = columns_of(c)
            pair = _equi_pair(c)
            if pair is not None:
                a, b = pair
                if all(ls.has(x) for x in columns_of(a)) and all(rs.has(x) for x in columns_of(b)):
                    pairs.append((a, b))
                    continue
                if all(rs.has(x) for x in columns_of(a)) and all(ls.has(x) for x in columns_of(b)):
                    pairs.append((b, a))
                    continue
            if cols and all(ls.has(x) for x in cols):
                lfilters.append(c)
            elif cols and all(rs.has(x) for x in cols):
                rfilters.append(c)
            else:
                mixed.append(c)
        # single-side ON predicates: pushable into the input on the non-preserved
        # side of an outer join (and both sides for inner)
        if jc.kind in ("inner", "left") and rfilters:
            right = Filter(right, conjoin(rfilters))
            rfilters = []
        if jc.kind in ("inner", "right") and lfilters:
            left = Filter(left, conjoin(lfilters))
            lfilters = []
        filt = conjoin(lfilters + rfilters + mixed)
        return Join(left, right, jc.kind, pairs, filt)

    # -- aggregation --------------------------------------------------------------
    def _plan_aggregate(self, base, group_exprs, proj_exprs, having, order_keys):
        aggs: dict[str, Expr] = {}

        def collect(e: Optional[Expr]):
            if e is None:
                return
            for n in walk(e):
                if isinstance(n, Agg):
                    aggs.setdefault(repr(n), n)

        for e in proj_exprs:
            collect(e)
        collect(having)
        for e, _ in order_keys:
            collect(e)

        agg_list = [Alias(a, a.name()) for a in aggs.values()]
        plan = Aggregate(base, group_exprs, agg_list)
        group_names = {repr(unalias(g)): unalias(g).name() for g in group_exprs}

        def rewrite(e: Expr) -> Expr:
            def fix(node: Expr):
                if isinstance(node, Agg):
                    return Col(node.name())
                r = repr(node)
                if r in group_names and not isinstance(node, Col):
                    return Col(group_names[r])
                if isinstance(node, Col):
                    # group columns keep their names through the aggregate
                    return None
                return None

            return transform(e, fix)

        return plan, rewrite

    def _unnest_select_subqueries(self, base: LogicalPlan, proj_exprs: list[Expr]):
        """Uncorrelated scalar subqueries in the SELECT list -> single-row
        cross joins; the projection references the joined value column."""
        out_exprs = []
        for e in proj_exprs:
            def fix(node: Expr):
                nonlocal base
                if isinstance(node, ScalarSubquery):
                    clean, pairs, filters = _decorrelate(node.plan)
                    if pairs or filters:
                        raise PlanningError(
                            "correlated scalar subqueries in the SELECT list "
                            "are not supported yet"
                        )
                    alias = f"__sq{next(self._sq_counter)}"
                    val_name = clean.schema().fields[0].name
                    base = Join(base, SubqueryAlias(clean, alias), "cross")
                    return Col(f"{alias}.{val_name.split('.')[-1]}")
                return None

            out_exprs.append(transform(e, fix))
        return base, out_exprs

    # -- subquery unnesting --------------------------------------------------------
    def _unnest_predicate(self, plan: LogicalPlan, pred: Expr) -> LogicalPlan:
        alias = f"__sq{next(self._sq_counter)}"

        neg = False
        inner_pred = pred
        if isinstance(inner_pred, Not) and isinstance(inner_pred.expr, (Exists, InSubquery)):
            neg = True
            inner_pred = inner_pred.expr

        if isinstance(inner_pred, Exists):
            negated = neg or inner_pred.negated
            clean, pairs, filters = _decorrelate(inner_pred.plan)
            if not pairs and not filters:
                raise PlanningError("uncorrelated EXISTS not supported")
            right = SubqueryAlias(clean, alias)
            on = [(Col(o.col), _requalify(i, alias)) for o, i in pairs]
            filt = conjoin([_rewrite_corr_filter(f, alias) for f in filters])
            return Join(plan, right, "anti" if negated else "semi", on, filt)

        if isinstance(inner_pred, InSubquery):
            negated = neg or inner_pred.negated
            clean, pairs, filters = _decorrelate(inner_pred.plan)
            key_name = clean.schema().fields[0].name
            right = SubqueryAlias(clean, alias)
            on = [(inner_pred.expr, Col(f"{alias}.{key_name.split('.')[-1]}"))]
            on += [(Col(o.col), _requalify(i, alias)) for o, i in pairs]
            filt = conjoin([_rewrite_corr_filter(f, alias) for f in filters])
            return Join(plan, right, "anti" if negated else "semi", on, filt)

        # comparison containing a scalar subquery on one side
        if isinstance(inner_pred, BinaryOp) and inner_pred.op in ("=", "!=", "<", "<=", ">", ">="):
            left_e, right_e = inner_pred.left, inner_pred.right
            sq = right_e if isinstance(right_e, ScalarSubquery) else left_e
            if isinstance(sq, ScalarSubquery):
                clean, pairs, filters = _decorrelate(sq.plan)
                if filters:
                    raise PlanningError("non-equi correlated scalar subquery unsupported")
                val_name = sq.plan.schema().fields[0].name
                right = SubqueryAlias(clean, alias)
                val_col = Col(f"{alias}.{val_name.split('.')[-1]}")
                if pairs:
                    on = [(Col(o.col), _requalify(i, alias)) for o, i in pairs]
                    joined = Join(plan, right, "inner", on)
                else:
                    joined = Join(plan, right, "cross")
                cmp = BinaryOp(
                    inner_pred.op,
                    val_col if isinstance(left_e, ScalarSubquery) else left_e,
                    val_col if isinstance(right_e, ScalarSubquery) else right_e,
                )
                return Filter(joined, cmp)

        raise PlanningError(f"cannot unnest predicate {pred!r}")

    # -- helpers ------------------------------------------------------------------
    def _expand_star(self, projections: list[Expr], schema: Schema) -> list[Expr]:
        out = []
        for e in projections:
            if isinstance(e, Col) and e.col == "*":
                out.extend(Col(f.name) for f in schema)
            else:
                out.append(e)
        return out

    def _try_resolve_order(self, o: OrderItem, schema: Schema, proj_exprs, outer) -> Expr:
        # ORDER BY may reference a projection alias, an ordinal, or a column
        e = o.expr
        if isinstance(e, Lit) and isinstance(e.value, int) and 1 <= e.value <= len(proj_exprs):
            return unalias(proj_exprs[e.value - 1])
        if isinstance(e, Col):
            for p in proj_exprs:
                if isinstance(p, Alias) and p.alias_name == e.col:
                    return p.expr
        return self._resolve(e, schema, outer)

    def _rebase_on_output(self, e: Expr, proj_exprs: list[Expr], out_schema: Schema) -> Expr:
        """Rewrite a sort key to reference the projected output columns."""
        for p, f in zip(proj_exprs, out_schema):
            if repr(unalias(p)) == repr(e):
                return Col(f.name)
        if isinstance(e, Col) and out_schema.has(e.col):
            return e
        # composite keys (e.g. the desugared IsNull for NULLS FIRST/LAST):
        # rewrite matching subexpressions to output columns, then verify
        def fix(node: Expr):
            for p, f in zip(proj_exprs, out_schema):
                if repr(unalias(p)) == repr(node):
                    return Col(f.name)
            return None

        rebased = transform(e, fix)
        if all(out_schema.has(c) for c in columns_of(rebased)):
            return rebased
        raise PlanningError(f"ORDER BY expression {e!r} is not in the select list")


# ---- module-level helpers --------------------------------------------------------
def _contains_agg(e: Expr) -> bool:
    return any(isinstance(n, Agg) for n in walk(e))


def _has_subquery(e: Expr) -> bool:
    if isinstance(e, (Exists, InSubquery, ScalarSubquery)):
        return True
    if isinstance(e, Not):
        return _has_subquery(e.expr)
    return any(isinstance(n, (Exists, InSubquery, ScalarSubquery)) for n in walk(e))


def _equi_pair(c: Expr) -> Optional[tuple[Expr, Expr]]:
    if isinstance(c, BinaryOp) and c.op == "=":
        return (c.left, c.right)
    return None


def _factor_or(c: Expr) -> list[Expr]:
    """Hoist conjuncts common to every OR branch: OR(A&C, B&C) == C & OR(A, B).

    This is what lets q19's disjunctive predicate expose its join key.
    """
    if not (isinstance(c, BinaryOp) and c.op == "or"):
        return [c]

    def branches(e: Expr) -> list[Expr]:
        if isinstance(e, BinaryOp) and e.op == "or":
            return branches(e.left) + branches(e.right)
        return [e]

    brs = [conjuncts(b) for b in branches(c)]
    common = [x for x in brs[0] if all(any(repr(x) == repr(y) for y in b) for b in brs[1:])]
    if not common:
        return [c]
    common_reprs = {repr(x) for x in common}
    remainders = []
    for b in brs:
        rem = [x for x in b if repr(x) not in common_reprs]
        remainders.append(conjoin(rem))
    if any(r is None for r in remainders):
        return common  # some branch was entirely common: OR collapses to the common part
    ored = remainders[0]
    for r in remainders[1:]:
        ored = BinaryOp("or", ored, r)
    return common + [ored]


def _requalify(e: Expr, alias: str) -> Expr:
    """Rewrite inner-plan column refs to the subquery alias qualifier."""

    def fix(node: Expr):
        if isinstance(node, Col):
            return Col(f"{alias}.{node.col.split('.')[-1]}")
        return None

    return transform(e, fix)


def _rewrite_corr_filter(e: Expr, alias: str) -> Expr:
    """OuterCol -> left-side Col; inner Col -> alias-qualified Col."""

    def fix(node: Expr):
        if isinstance(node, OuterCol):
            return Col(node.col)
        if isinstance(node, Col):
            return Col(f"{alias}.{node.col.split('.')[-1]}")
        return None

    return transform(e, fix)


def _decorrelate(plan: LogicalPlan):
    """Strip correlated conjuncts out of a subquery plan.

    Returns (clean_plan, pairs, filters) where pairs are
    (OuterCol, inner_expr) equality correlations and filters are other
    correlated predicates (for semi/anti join filters).
    For aggregates, correlation keys are appended to the group-by so the
    subsequent join reconstitutes per-outer-row scalar values
    (the classic magic-set style rewrite DataFusion applies to q17/q2).
    """
    if isinstance(plan, Filter):
        child, pairs, filters = _decorrelate(plan.input)
        keep = []
        for c in conjuncts(plan.predicate):
            if not _contains_outer(c):
                keep.append(c)
                continue
            p = _corr_eq_pair(c, child.schema())
            if p is not None:
                pairs.append(p)
            else:
                filters.append(c)
        pred = conjoin(keep)
        out = Filter(child, pred) if pred is not None else child
        return out, pairs, filters

    if isinstance(plan, Aggregate):
        child, pairs, filters = _decorrelate(plan.input)
        if pairs:
            if filters:
                raise PlanningError("correlated aggregate with non-equi correlation")
            extra = []
            seen = {repr(g) for g in plan.group_exprs}
            for _, inner in pairs:
                if repr(inner) not in seen:
                    extra.append(inner)
                    seen.add(repr(inner))
            return Aggregate(child, plan.group_exprs + extra, plan.agg_exprs), pairs, filters
        return (plan if child is plan.input else Aggregate(child, plan.group_exprs, plan.agg_exprs)), pairs, filters

    if isinstance(plan, Project):
        child, pairs, filters = _decorrelate(plan.input)
        exprs = list(plan.exprs)
        names = {e.name() for e in exprs}
        for _, inner in pairs:
            if isinstance(inner, Col) and inner.col not in names:
                if child.schema().has(inner.col):
                    exprs.append(inner)
                    names.add(inner.col)
        return Project(child, exprs), pairs, filters

    if isinstance(plan, (Sort, Limit)):
        child, pairs, filters = _decorrelate(plan.input)
        if pairs or filters:
            raise PlanningError("correlation below sort/limit unsupported")
        return plan, [], []

    return plan, [], []


def _contains_outer(e: Expr) -> bool:
    return any(isinstance(n, OuterCol) for n in walk(e))


def _corr_eq_pair(c: Expr, inner_schema: Schema):
    """Match ``inner_col = OuterCol`` (either orientation)."""
    if isinstance(c, BinaryOp) and c.op == "=":
        l, r = c.left, c.right
        if isinstance(l, OuterCol) and not _contains_outer(r) and isinstance(r, Col):
            return (l, r)
        if isinstance(r, OuterCol) and not _contains_outer(l) and isinstance(l, Col):
            return (r, l)
    return None
