"""Logical optimizer passes.

Reference analog: DataFusion's optimizer, which Ballista applies before
distributed planning (survey §3.1: physical planning happens scheduler-side;
the reference inherits the full rule set via ``arrow-ballista: Cargo.toml:38``).
Passes here: constant folding (SimplifyExpressions/ConstEvaluator analog),
statistics-driven join ordering (this build's answer to cost-based join
enumeration — the resolution-time re-opt in scheduler/planner.py can only swap
within a frozen stage topology, so ordering MUST happen before stage split),
column pruning (critical — TPC-H comment columns are wide), and the
distinct-aggregate rewrite. Filter pushdown into scans happens structurally in
the SQL planner / physical planner.
"""
from __future__ import annotations

from typing import Optional

from ballista_tpu_torch.plan.expr import (
    Agg,
    Alias,
    BinaryOp,
    Col,
    Expr,
    Lit,
    columns_of,
    conjoin,
    conjuncts,
    fold_constants,
    unalias,
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
    Union,
)
from ballista_tpu_torch.plan.schema import DataType, Schema


def optimize(plan: LogicalPlan, catalog=None) -> LogicalPlan:
    plan = rewrite_distinct_aggs(plan)
    plan = fold_plan_constants(plan)
    if catalog is not None:
        plan = reorder_joins(plan, catalog)
    plan = prune_columns(plan, None)
    return plan


# ---- distinct aggregate rewrite ---------------------------------------------------
def rewrite_distinct_aggs(plan: LogicalPlan) -> LogicalPlan:
    """count(DISTINCT x) -> count(x) over a dedup pre-aggregate.

    ``Aggregate(g, [count(distinct x)])`` becomes
    ``Aggregate(g, [count(x)]) . Aggregate(g + [x], [])``
    (the classic two-phase rewrite; DataFusion's SingleDistinctToGroupBy).
    Mixed distinct + plain aggregates compute as TWO aggregates over the same
    input joined back on the group keys (cross join when ungrouped).
    """
    # rebuild bottom-up
    kids = [rewrite_distinct_aggs(c) for c in plan.children()]
    plan = _with_children(plan, kids)
    if not isinstance(plan, Aggregate):
        return plan
    distincts = [e for e in plan.agg_exprs if isinstance(unalias(e), Agg) and unalias(e).distinct]
    if not distincts:
        return plan
    exprs = {repr(unalias(e).expr) for e in distincts}
    if len(exprs) != 1:
        raise NotImplementedError("multiple distinct expressions")
    inner_val = unalias(distincts[0]).expr
    dedup = Aggregate(plan.input, plan.group_exprs + [inner_val], [])
    new_aggs = [
        Alias(Agg(unalias(e).fn, Col(inner_val.name())), e.name()) for e in distincts
    ]
    new_groups = [Col(g.name()) for g in plan.group_exprs]
    distinct_agg = Aggregate(dedup, new_groups, new_aggs)

    plains = [e for e in plan.agg_exprs if e not in distincts]
    if not plains:
        return distinct_agg

    # mixed: plain aggregates keep the full input; join results on group keys
    from ballista_tpu_torch.plan.logical import Join, Project, SubqueryAlias

    plain_agg = Aggregate(plan.input, plan.group_exprs, plains)
    right = SubqueryAlias(distinct_agg, "__dist")
    if plan.group_exprs:
        on = [
            (Col(g.name()), Col(f"__dist.{g.name().split('.')[-1]}"))
            for g in plan.group_exprs
        ]
        joined = Join(plain_agg, right, "inner", on)
    else:
        joined = Join(plain_agg, right, "cross")
    # restore the original output column order
    out_exprs: list[Expr] = []
    for g in plan.group_exprs:
        out_exprs.append(Col(g.name()))
    for e in plan.agg_exprs:
        if e in distincts:
            out_exprs.append(Alias(Col(f"__dist.{e.name().split('.')[-1]}"), e.name()))
        else:
            out_exprs.append(Col(e.name()))
    return Project(joined, out_exprs)


# ---- column pruning ---------------------------------------------------------------
def prune_columns(plan: LogicalPlan, needed: Optional[set[int]]) -> LogicalPlan:
    """Drop unused columns; ``needed`` is a set of output-field indices
    (None = keep everything)."""
    schema = plan.schema()

    def idx_of(col: str) -> Optional[int]:
        try:
            return schema.index_of(col)
        except KeyError:
            return None

    def expr_indices(*exprs: Expr) -> set[int]:
        out = set()
        for e in exprs:
            if e is None:
                continue
            for c in columns_of(e):
                i = idx_of(c)
                if i is not None:
                    out.add(i)
        return out

    if isinstance(plan, Scan):
        if needed is None:
            return plan
        names = [f.name for i, f in enumerate(schema.fields) if i in needed]
        for f in plan.filters:
            for c in columns_of(f):
                if c not in names and plan.table_schema.has(c):
                    names.append(c)
        if not names:  # keep one column so row counts survive (e.g. count(*))
            names = [schema.fields[0].name]
        order = {n: i for i, n in enumerate(plan.table_schema.names)}
        names.sort(key=lambda n: order.get(n, 0))
        return Scan(plan.table, plan.table_schema, names, plan.filters)

    if isinstance(plan, Project):
        if needed is None:
            kept = list(plan.exprs)
        else:
            kept = [e for i, e in enumerate(plan.exprs) if i in needed]
            if not kept:
                kept = [plan.exprs[0]]
        child_schema = plan.input.schema()
        child_needed = set()
        for e in kept:
            for c in columns_of(e):
                try:
                    child_needed.add(child_schema.index_of(c))
                except KeyError:
                    pass
        return Project(prune_columns(plan.input, child_needed), kept)

    if isinstance(plan, Filter):
        child_needed = None
        if needed is not None:
            child_needed = set(needed) | expr_indices(plan.predicate)
        return Filter(prune_columns(plan.input, child_needed), plan.predicate)

    if isinstance(plan, Aggregate):
        child_schema = plan.input.schema()
        child_needed = set()
        for e in plan.group_exprs + [unalias(a).expr for a in plan.agg_exprs if unalias(a).expr is not None]:
            for c in columns_of(e):
                try:
                    child_needed.add(child_schema.index_of(c))
                except KeyError:
                    pass
        if not child_needed and len(child_schema):
            child_needed = {0}
        return Aggregate(prune_columns(plan.input, child_needed), plan.group_exprs, plan.agg_exprs)

    if isinstance(plan, Join):
        ls, rs = plan.left.schema(), plan.right.schema()
        lneed: set[int] = set()
        rneed: set[int] = set()

        def add_side(e: Optional[Expr], need: set[int], s: Schema) -> bool:
            if e is None:
                return False
            hit = False
            for c in columns_of(e):
                try:
                    need.add(s.index_of(c))
                    hit = True
                except KeyError:
                    pass
            return hit

        if needed is not None:
            # join output is positionally ls.fields + rs.fields (or ls only for
            # semi/anti), so indices map to sides directly
            for i in needed:
                if i < len(ls):
                    lneed.add(i)
                elif plan.how not in ("semi", "anti"):
                    rneed.add(i - len(ls))
        for l, r in plan.on:
            # on-pairs are oriented (left expr, right expr) — resolve per side so
            # a right key like "__sq1.x" can't be claimed by an unqualified left "x"
            add_side(l, lneed, ls)
            add_side(r, rneed, rs)
        # filter refs may hit either side; add wherever they resolve (both is safe)
        if plan.filter is not None:
            add_side(plan.filter, lneed, ls)
            add_side(plan.filter, rneed, rs)
        if needed is None:
            lneed_f, rneed_f = None, None
        else:
            lneed_f = lneed or {0}
            rneed_f = rneed or {0}
        return Join(
            prune_columns(plan.left, lneed_f),
            prune_columns(plan.right, rneed_f),
            plan.how,
            plan.on,
            plan.filter,
        )

    if isinstance(plan, Sort):
        child_needed = None
        if needed is not None:
            child_needed = set(needed) | expr_indices(*[e for e, _ in plan.keys])
        return Sort(prune_columns(plan.input, child_needed), plan.keys)

    if isinstance(plan, Limit):
        return Limit(prune_columns(plan.input, needed), plan.n, plan.offset)

    if isinstance(plan, SubqueryAlias):
        # index-aligned rename: child needs the same indices
        return SubqueryAlias(prune_columns(plan.input, needed), plan.alias)

    from ballista_tpu_torch.plan.logical import Window

    if isinstance(plan, Window):
        child_schema = plan.input.schema()
        if needed is None:
            child_needed = None
        else:
            child_needed = {i for i in needed if i < len(child_schema)}
            for e in plan.window_exprs:
                for c in columns_of(e):
                    try:
                        child_needed.add(child_schema.index_of(c))
                    except KeyError:
                        pass
            if not child_needed and len(child_schema):
                child_needed = {0}
        return Window(prune_columns(plan.input, child_needed), plan.window_exprs)

    if isinstance(plan, Union):
        return Union([prune_columns(c, needed) for c in plan.inputs])

    return plan


# ---- constant folding -------------------------------------------------------------
def fold_plan_constants(plan: LogicalPlan) -> LogicalPlan:
    """Apply :func:`fold_constants` to every expression in the tree and drop
    filters whose predicate folds to literal TRUE."""
    kids = [fold_plan_constants(c) for c in plan.children()]
    plan = _with_children(plan, kids)
    if isinstance(plan, Filter):
        pred = fold_constants(plan.predicate)
        if isinstance(pred, Lit) and pred.dtype is DataType.BOOL and pred.value is True:
            return plan.input
        return Filter(plan.input, pred)
    if isinstance(plan, Project):
        return Project(plan.input, [fold_constants(e) for e in plan.exprs])
    if isinstance(plan, Join):
        on = [(fold_constants(l), fold_constants(r)) for l, r in plan.on]
        filt = None if plan.filter is None else fold_constants(plan.filter)
        if isinstance(filt, Lit) and filt.dtype is DataType.BOOL and filt.value is True:
            filt = None
        return Join(plan.left, plan.right, plan.how, on, filt)
    if isinstance(plan, Aggregate):
        return Aggregate(
            plan.input,
            [fold_constants(e) for e in plan.group_exprs],
            [fold_constants(e) for e in plan.agg_exprs],
        )
    if isinstance(plan, Sort):
        return Sort(plan.input, [(fold_constants(e), a) for e, a in plan.keys])
    return plan


# ---- statistics-driven join ordering ----------------------------------------------
def estimate_logical_rows(plan: LogicalPlan, catalog) -> int:
    """Crude logical-level cardinality estimate (physical analog:
    physical_planner.estimate_rows; same coefficients so plan-time ordering
    and physical build-side choice agree)."""
    if isinstance(plan, Scan):
        try:
            rows = catalog.get(plan.table).num_rows
        except Exception:
            return 1000
        return max(1, rows // (3 if plan.filters else 1))
    if isinstance(plan, Filter):
        return max(1, estimate_logical_rows(plan.input, catalog) // 3)
    if isinstance(plan, Aggregate):
        return max(1, estimate_logical_rows(plan.input, catalog) // 4)
    if isinstance(plan, Limit):
        return min(plan.n, estimate_logical_rows(plan.input, catalog))
    if isinstance(plan, Join):
        l = estimate_logical_rows(plan.left, catalog)
        if plan.how in ("semi", "anti"):
            return l
        return max(l, estimate_logical_rows(plan.right, catalog))
    kids = plan.children()
    if not kids:
        return 1
    return max(estimate_logical_rows(c, catalog) for c in kids)


def _is_chain_join(n) -> bool:
    return isinstance(n, Join) and n.how == "inner" and bool(n.on)


def _flatten_inner_chain(plan: LogicalPlan):
    """Flatten a tree of inner equi-joins into (relations, equi_pairs,
    extra_filters). Any non-inner / non-equi node is an atomic relation."""
    rels: list[LogicalPlan] = []
    pairs: list[tuple[Expr, Expr]] = []
    filters: list[Expr] = []

    def rec(n):
        if _is_chain_join(n):
            rec(n.left)
            rec(n.right)
            pairs.extend(n.on)
            filters.extend(conjuncts(n.filter))
        else:
            rels.append(n)

    rec(plan)
    return rels, pairs, filters


def _rebuild_chain(plan: LogicalPlan, rels_iter) -> LogicalPlan:
    """Reassemble the original chain shape with (already-recursed) relations
    substituted for the leaves, in the same traversal order as
    :func:`_flatten_inner_chain`."""
    if _is_chain_join(plan):
        left = _rebuild_chain(plan.left, rels_iter)
        right = _rebuild_chain(plan.right, rels_iter)
        return Join(left, right, "inner", plan.on, plan.filter)
    return next(rels_iter)


def reorder_joins(plan: LogicalPlan, catalog) -> LogicalPlan:
    """Greedy smallest-intermediate-first ordering of inner-join chains.

    The SQL planner builds joins in FROM-clause order (sql/planner.py
    _build_join_tree), which for TPC-H q5/q7/q8/q9 puts the fact table first
    and drags multi-million-row intermediates through every join. Inner
    equi-joins commute, so: flatten the chain, estimate each base relation
    from catalog statistics, start at the smallest-estimate connected
    relation, and repeatedly join the connected relation minimizing the
    estimated intermediate. Dimension tables join first; lineitem joins last
    and every earlier intermediate stays dimension-sized — which also lets
    the physical planner pick broadcast builds instead of partitioned
    exchanges. Bails (returns the original tree) on ambiguity, disconnected
    predicate graphs, or duplicate output names.

    Reference analog: the join-selection/statistics optimizer role Ballista
    inherits from DataFusion; ordering must happen HERE because the
    stage topology freezes at distributed planning (scheduler/planner.py
    adaptive_join_reopt can only flip strategy within a stage).
    """
    if _is_chain_join(plan):
        # flatten BEFORE recursing: a reordered sub-chain gets wrapped in a
        # column-order Project, which would stop the parent's flatten and
        # split one q5-style chain into two independently-ordered halves
        rels, pairs, filters = _flatten_inner_chain(plan)
        rels = [reorder_joins(r, catalog) for r in rels]
        rebuilt = _reorder_chain(plan, rels, pairs, filters, catalog)
        if rebuilt is not None:
            return rebuilt
        # bail: keep the written order but splice in the recursed relations
        # (re-recursing children here would redo every sub-chain per level)
        return _rebuild_chain(plan, iter(rels))
    kids = [reorder_joins(c, catalog) for c in plan.children()]
    return _with_children(plan, kids)


def _reorder_chain(plan, rels, pairs, filters, catalog) -> Optional[LogicalPlan]:
    n = len(rels)
    if n < 3:
        return None

    schemas = [r.schema() for r in rels]
    out_names = [f.name for f in plan.schema()]
    if len(set(out_names)) != len(out_names):
        return None  # duplicate output names: cannot restore column order

    def owner(e: Expr) -> Optional[int]:
        """Index of the single relation whose schema covers all of e's
        columns; None when unresolvable or ambiguous."""
        cols = columns_of(e)
        if not cols:
            return None
        hit = None
        for i, s in enumerate(schemas):
            if all(s.has(c) for c in cols):
                if hit is not None:
                    return None  # ambiguous
                hit = i
        return hit

    def ref_set(e: Expr) -> Optional[set[int]]:
        """Relation indices referenced by e; None when any column is
        unresolvable or resolves in multiple relations."""
        out: set[int] = set()
        for c in columns_of(e):
            hit = None
            for i, s in enumerate(schemas):
                if s.has(c):
                    if hit is not None:
                        return None
                    hit = i
            if hit is None:
                return None
            out.add(hit)
        return out

    edges: list[tuple[int, int, Expr, Expr]] = []
    extra: list[tuple[frozenset, Expr]] = []  # (needed relations, predicate)
    for l, r in pairs:
        li, ri = owner(l), owner(r)
        if li is not None and ri is not None and li != ri:
            edges.append((li, ri, l, r))
        else:
            pred = BinaryOp("=", l, r)
            refs = ref_set(pred)
            if refs is None:
                return None
            extra.append((frozenset(refs), pred))
    for f in filters:
        refs = ref_set(f)
        if refs is None:
            return None
        extra.append((frozenset(refs), f))

    est = [estimate_logical_rows(r, catalog) for r in rels]
    adj: dict[int, set[int]] = {i: set() for i in range(n)}
    for li, ri, _, _ in edges:
        adj[li].add(ri)
        adj[ri].add(li)

    # Join-key equivalence classes (union-find over edge endpoints) give a
    # no-stats NDV proxy: the smallest relation carrying a key of the class
    # is its dimension table, and a dimension's row count IS the key's
    # distinct-value count (nation ~ 25 for nationkey). Without this, an
    # FK=FK edge like supplier.s_nationkey = customer.c_nationkey looks as
    # selective as a PK-FK join and the greedy happily multiplies two fact
    # sides through a 25-value key — a billions-row intermediate on TPC-H q5.
    def key_id(rel: int, e: Expr) -> tuple:
        return (rel, tuple(sorted(columns_of(e))))

    uf_parent: dict[tuple, tuple] = {}

    def find(x: tuple) -> tuple:
        uf_parent.setdefault(x, x)
        while uf_parent[x] != x:
            uf_parent[x] = uf_parent[uf_parent[x]]
            x = uf_parent[x]
        return x

    def union(a: tuple, b: tuple) -> None:
        uf_parent[find(a)] = find(b)

    for li, ri, le, re_ in edges:
        union(key_id(li, le), key_id(ri, re_))
    class_ndv: dict[tuple, int] = {}
    for x in list(uf_parent):
        root = find(x)
        class_ndv[root] = min(class_ndv.get(root, 1 << 62), est[x[0]])

    def join_out_est(cur_est: int, j: int, placed: set[int]) -> int:
        """|cur JOIN rels[j]| ~= cur * est[j] / ndv(most selective
        connecting key class) — the textbook estimate with class-dimension
        size standing in for NDV."""
        best_ndv = 1
        for li, ri, le, re_ in edges:
            if li in placed and ri == j:
                best_ndv = max(best_ndv, class_ndv[find(key_id(li, le))])
            elif ri in placed and li == j:
                best_ndv = max(best_ndv, class_ndv[find(key_id(ri, re_))])
        return max(1, (cur_est * est[j]) // max(best_ndv, 1))

    connected = [i for i in range(n) if adj[i]]
    if len(connected) < n:
        return None  # would need a cross join; keep the written order
    start = min(range(n), key=lambda i: (est[i], i))
    seq = [start]
    placed = {start}
    cur_est = est[start]
    while len(placed) < n:
        cands = {j for i in placed for j in adj[i]} - placed
        if not cands:
            return None  # disconnected predicate graph
        j = min(cands, key=lambda c: (join_out_est(cur_est, c, placed), est[c], c))
        seq.append(j)
        cur_est = join_out_est(cur_est, j, placed)
        placed.add(j)
    if seq == list(range(n)):
        return None  # already in the chosen order

    out: LogicalPlan = rels[seq[0]]
    placed = {seq[0]}
    pending = list(extra)
    for j in seq[1:]:
        on = []
        for li, ri, le, re_ in edges:
            if li in placed and ri == j:
                on.append((le, re_))
            elif ri in placed and li == j:
                on.append((re_, le))
        out = Join(out, rels[j], "inner", on)
        placed.add(j)
        ready = [p for p in pending if p[0] <= placed]
        if ready:
            pending = [p for p in pending if not (p[0] <= placed)]
            out = Filter(out, conjoin([p[1] for p in ready]))
    assert not pending, "unplaced join predicate after reorder"
    return Project(out, [Col(nm) for nm in out_names])


def _with_children(plan: LogicalPlan, kids: list[LogicalPlan]) -> LogicalPlan:
    if not kids:
        return plan
    if isinstance(plan, Filter):
        return Filter(kids[0], plan.predicate)
    if isinstance(plan, Project):
        return Project(kids[0], plan.exprs)
    if isinstance(plan, Aggregate):
        return Aggregate(kids[0], plan.group_exprs, plan.agg_exprs)
    if isinstance(plan, Join):
        return Join(kids[0], kids[1], plan.how, plan.on, plan.filter)
    if isinstance(plan, Sort):
        return Sort(kids[0], plan.keys)
    if isinstance(plan, Limit):
        return Limit(kids[0], plan.n, plan.offset)
    if isinstance(plan, SubqueryAlias):
        return SubqueryAlias(kids[0], plan.alias)
    from ballista_tpu_torch.plan.logical import Window as _W

    if isinstance(plan, _W):
        return _W(kids[0], plan.window_exprs)
    if isinstance(plan, Union):
        return Union(kids)
    raise AssertionError(type(plan))
