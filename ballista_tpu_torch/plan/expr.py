"""Expression IR shared by logical and physical plans.

Reference analog: DataFusion's ``Expr`` / ``PhysicalExpr`` as consumed by
Ballista's plan serde (``arrow-ballista: ballista/core/src/serde/mod.rs``).
The IR is deliberately small and *frozen* (hashable): physical stage programs
are fingerprinted by expression identity for the XLA compile cache.

Interval arithmetic only ever appears between literals in TPC-H-class SQL, so
``IntervalLit`` is folded away at planning time with exact calendar math and
never reaches execution.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan.schema import DataType, Field, Schema


class Expr:
    """Base class. Subclasses are frozen dataclasses."""

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    def children(self) -> tuple["Expr", ...]:
        return ()

    def with_children(self, *ch: "Expr") -> "Expr":
        assert not ch
        return self

    def name(self) -> str:
        """Output column name when this expression is projected unaliased.

        Dots are reserved for ``alias.column`` qualification (SubqueryAlias),
        so auto-generated names sanitize them (e.g. float literals).
        """
        return str(self).replace(".", "_")

    # convenience builders
    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def __eq__(self, other):  # structural equality via repr of frozen dataclasses
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __ne__(self, other):
        # explicit: the auto-derived __ne__ from structural __eq__ would let
        # col("a") != 5 silently evaluate to a plain bool; keep != structural
        # (value inequality is .not_eq()) and consistent with __eq__
        return not self.__eq__(other)

    def __hash__(self):
        return hash(repr(self))

    # ---- DataFrame expression-builder surface ------------------------------------
    # (reference: the DataFusion Expr operators the client re-exports,
    # context.rs:85-475 / python/src/context.rs). ``==`` stays STRUCTURAL
    # equality (internals rely on it), so value equality uses .eq()/.not_eq();
    # ordering and arithmetic overload the Python operators.
    def _bin(self, op: str, other) -> "BinaryOp":
        return BinaryOp(op, self, _as_expr(other))

    def eq(self, other) -> "BinaryOp":
        return self._bin("=", other)

    def not_eq(self, other) -> "BinaryOp":
        return self._bin("!=", other)

    def __gt__(self, other):
        return self._bin(">", other)

    def __ge__(self, other):
        return self._bin(">=", other)

    def __lt__(self, other):
        return self._bin("<", other)

    def __le__(self, other):
        return self._bin("<=", other)

    def __add__(self, other):
        return self._bin("+", other)

    def __radd__(self, other):
        return _as_expr(other)._bin("+", self)

    def __sub__(self, other):
        return self._bin("-", other)

    def __rsub__(self, other):
        return _as_expr(other)._bin("-", self)

    def __mul__(self, other):
        return self._bin("*", other)

    def __rmul__(self, other):
        return _as_expr(other)._bin("*", self)

    def __truediv__(self, other):
        return self._bin("/", other)

    def __rtruediv__(self, other):
        return _as_expr(other)._bin("/", self)

    def __mod__(self, other):
        return self._bin("%", other)

    def __rmod__(self, other):
        return _as_expr(other)._bin("%", self)

    def __and__(self, other):
        return self._bin("and", other)

    def __or__(self, other):
        return self._bin("or", other)

    def __invert__(self):
        return Not(self)

    def is_null(self) -> "IsNull":
        return IsNull(self)

    def is_not_null(self) -> "IsNull":
        return IsNull(self, negated=True)

    def like(self, pattern: str) -> "Like":
        return Like(self, pattern)

    def in_list(self, values, negated: bool = False) -> "InList":
        return InList(self, tuple(_as_expr(v) for v in values), negated)

    def between(self, low, high) -> "BinaryOp":
        return BinaryOp("and", self._bin(">=", low), self._bin("<=", high))

    def cast(self, to: DataType) -> "Cast":
        return Cast(self, to)

    def sort(self, ascending: bool = True) -> tuple["Expr", bool]:
        """Sort-key spec for DataFrame.sort (reference: Expr::sort)."""
        return (self, ascending)


def _as_expr(v) -> "Expr":
    """Coerce python literals to Lit for the builder surface."""
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return Lit.bool_(v)
    if isinstance(v, int):
        return Lit.int(v)
    if isinstance(v, float):
        return Lit.float(v)
    if isinstance(v, str):
        return Lit.str_(v)
    raise TypeError(f"cannot lift {type(v).__name__} to an expression")


def _walk(e: Expr):
    yield e
    for c in e.children():
        yield from _walk(c)


def walk(e: Expr):
    return _walk(e)


def transform(e: Expr, fn) -> Expr:
    """Bottom-up rewrite: fn applied to each node after its children."""
    ch = e.children()
    if ch:
        e = e.with_children(*[transform(c, fn) for c in ch])
    out = fn(e)
    return e if out is None else out


@dataclass(frozen=True, eq=False)
class Col(Expr):
    col: str

    def data_type(self, schema: Schema) -> DataType:
        return schema.field(self.col).dtype

    def name(self) -> str:
        return self.col

    def __repr__(self):
        return self.col


@dataclass(frozen=True, eq=False)
class Lit(Expr):
    value: Any
    dtype: DataType

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def __repr__(self):
        return f"{self.value!r}" if isinstance(self.value, str) else f"{self.value}"

    @staticmethod
    def int(v: int) -> "Lit":
        return Lit(int(v), DataType.INT64)

    @staticmethod
    def float(v: float) -> "Lit":
        return Lit(float(v), DataType.FLOAT64)

    @staticmethod
    def str_(v: str) -> "Lit":
        return Lit(v, DataType.STRING)

    @staticmethod
    def date(days: int) -> "Lit":
        return Lit(int(days), DataType.DATE32)

    @staticmethod
    def bool_(v: bool) -> "Lit":
        return Lit(bool(v), DataType.BOOL)


@dataclass(frozen=True, eq=False)
class IntervalLit(Expr):
    """Calendar interval; exists only pre-folding (see module docstring)."""

    months: int = 0
    days: int = 0

    def data_type(self, schema: Schema) -> DataType:
        raise PlanningError("interval literal must be constant-folded before execution")

    def __repr__(self):
        return f"interval({self.months}mo,{self.days}d)"


ARITH_OPS = {"+", "-", "*", "/", "%"}
CMP_OPS = {"=", "!=", "<", "<=", ">", ">="}
BOOL_OPS = {"and", "or"}


@dataclass(frozen=True, eq=False)
class BinaryOp(Expr):
    op: str
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)

    def with_children(self, *ch):
        return BinaryOp(self.op, *ch)

    def data_type(self, schema: Schema) -> DataType:
        if self.op in CMP_OPS or self.op in BOOL_OPS:
            return DataType.BOOL
        lt, rt = self.left.data_type(schema), self.right.data_type(schema)
        if self.op in ARITH_OPS:
            if lt is DataType.DATE32 or rt is DataType.DATE32:
                return DataType.DATE32
            if DataType.FLOAT64 in (lt, rt) or self.op == "/":
                return DataType.FLOAT64
            if DataType.FLOAT32 in (lt, rt):
                return DataType.FLOAT32
            return DataType.INT64
        raise PlanningError(f"unknown op {self.op}")

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


@dataclass(frozen=True, eq=False)
class Not(Expr):
    expr: Expr

    def children(self):
        return (self.expr,)

    def with_children(self, *ch):
        return Not(*ch)

    def data_type(self, schema):
        return DataType.BOOL

    def __repr__(self):
        return f"NOT {self.expr!r}"


@dataclass(frozen=True, eq=False)
class IsNull(Expr):
    expr: Expr
    negated: bool = False

    def children(self):
        return (self.expr,)

    def with_children(self, *ch):
        return IsNull(ch[0], self.negated)

    def data_type(self, schema):
        return DataType.BOOL

    def __repr__(self):
        return f"{self.expr!r} IS {'NOT ' if self.negated else ''}NULL"


@dataclass(frozen=True, eq=False)
class Case(Expr):
    branches: Tuple[Tuple[Expr, Expr], ...]
    else_: Optional[Expr] = None

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.else_ is not None:
            out.append(self.else_)
        return tuple(out)

    def with_children(self, *ch):
        n = len(self.branches)
        branches = tuple((ch[2 * i], ch[2 * i + 1]) for i in range(n))
        else_ = ch[2 * n] if self.else_ is not None else None
        return Case(branches, else_)

    def data_type(self, schema):
        return self.branches[0][1].data_type(schema)

    def __repr__(self):
        parts = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.branches)
        tail = f" ELSE {self.else_!r}" if self.else_ is not None else ""
        return f"CASE {parts}{tail} END"


@dataclass(frozen=True, eq=False)
class Cast(Expr):
    expr: Expr
    to: DataType

    def children(self):
        return (self.expr,)

    def with_children(self, *ch):
        return Cast(ch[0], self.to)

    def data_type(self, schema):
        return self.to

    def __repr__(self):
        return f"CAST({self.expr!r} AS {self.to.value})"


@dataclass(frozen=True, eq=False)
class Like(Expr):
    expr: Expr
    pattern: str
    negated: bool = False

    def children(self):
        return (self.expr,)

    def with_children(self, *ch):
        return Like(ch[0], self.pattern, self.negated)

    def data_type(self, schema):
        return DataType.BOOL

    def __repr__(self):
        return f"{self.expr!r} {'NOT ' if self.negated else ''}LIKE {self.pattern!r}"


@dataclass(frozen=True, eq=False)
class InList(Expr):
    expr: Expr
    values: Tuple[Expr, ...]
    negated: bool = False

    def children(self):
        return (self.expr,) + self.values

    def with_children(self, *ch):
        return InList(ch[0], tuple(ch[1:]), self.negated)

    def data_type(self, schema):
        return DataType.BOOL

    def __repr__(self):
        return f"{self.expr!r} {'NOT ' if self.negated else ''}IN {list(self.values)!r}"


SCALAR_FUNCS = {"year", "month", "substr", "abs", "round", "coalesce", "length"}


@dataclass(frozen=True, eq=False)
class Func(Expr):
    fn: str
    args: Tuple[Expr, ...]

    def children(self):
        return self.args

    def with_children(self, *ch):
        return Func(self.fn, tuple(ch))

    def data_type(self, schema):
        if self.fn in ("year", "month", "day", "length", "strpos"):
            return DataType.INT64
        if self.fn in ("substr", "upper", "lower", "trim", "ltrim", "rtrim",
                       "replace", "concat", "concat_op"):
            return DataType.STRING
        if self.fn in ("sqrt", "power", "pow", "exp", "ln", "log10"):
            return DataType.FLOAT64
        if self.fn == "starts_with":
            return DataType.BOOL
        if self.fn == "date_trunc":
            return DataType.DATE32
        if self.fn in ("greatest", "least"):
            # promote across ALL arguments (greatest(int, float) is float)
            ts = [a.data_type(schema) for a in self.args]
            if any(t is DataType.STRING for t in ts):
                return DataType.STRING
            if any(t in (DataType.FLOAT32, DataType.FLOAT64) for t in ts):
                return DataType.FLOAT64
            return ts[0]
        if self.fn in ("abs", "round", "floor", "ceil", "sign", "mod",
                       "coalesce", "nullif"):
            return self.args[0].data_type(schema)
        from ballista_tpu_torch.utils.udf import GLOBAL_UDFS

        udf = GLOBAL_UDFS.get(self.fn)
        if udf is not None:
            return udf.return_type
        raise PlanningError(f"unknown function {self.fn}")

    def __repr__(self):
        return f"{self.fn}({', '.join(map(repr, self.args))})"


AGG_FUNCS = {"sum", "avg", "min", "max", "count", "count_star"}


@dataclass(frozen=True, eq=False)
class Agg(Expr):
    fn: str
    expr: Optional[Expr] = None  # None for count(*)
    distinct: bool = False

    def children(self):
        return (self.expr,) if self.expr is not None else ()

    def with_children(self, *ch):
        return Agg(self.fn, ch[0] if ch else None, self.distinct)

    def data_type(self, schema):
        if self.fn in ("count", "count_star"):
            return DataType.INT64
        if self.fn == "avg":
            return DataType.FLOAT64
        assert self.expr is not None
        t = self.expr.data_type(schema)
        if self.fn == "sum" and t.is_integer:
            return DataType.INT64
        return t

    def __repr__(self):
        if self.fn == "count_star":
            return "count(*)"
        d = "DISTINCT " if self.distinct else ""
        return f"{self.fn}({d}{self.expr!r})"


WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "sum", "avg", "min", "max", "count"}

# window frame bound kinds (SQL: <units> BETWEEN <start> AND <end>)
UNBOUNDED_PRECEDING = "unbounded_preceding"
PRECEDING = "preceding"
CURRENT_ROW = "current_row"
FOLLOWING = "following"
UNBOUNDED_FOLLOWING = "unbounded_following"


@dataclass(frozen=True)
class WindowFrame:
    """Explicit ``ROWS | RANGE BETWEEN <start> AND <end>`` frame.

    ``start``/``end`` are (kind, offset) with offset None except for
    ``preceding``/``following``. RANGE offsets require exactly one numeric
    ORDER BY key (validated at planning). Reference behavior via DataFusion's
    window operators (exercised from ``client/src/context.rs:477-1018``).
    """

    units: str  # "rows" | "range"
    start: Tuple[str, Optional[float]]
    end: Tuple[str, Optional[float]]

    def validate(self) -> None:
        if self.start[0] == UNBOUNDED_FOLLOWING or self.end[0] == UNBOUNDED_PRECEDING:
            raise ValueError("frame cannot start at UNBOUNDED FOLLOWING "
                             "or end at UNBOUNDED PRECEDING")
        order = (UNBOUNDED_PRECEDING, PRECEDING, CURRENT_ROW, FOLLOWING,
                 UNBOUNDED_FOLLOWING)
        if order.index(self.start[0]) > order.index(self.end[0]):
            raise ValueError(
                f"frame start {self.start[0]} cannot follow end {self.end[0]}"
            )


@dataclass(frozen=True, eq=False)
class WindowFunc(Expr):
    """``fn(args) OVER (PARTITION BY ... ORDER BY ... [frame])``.

    Without an explicit frame, aggregates use the SQL default (with ORDER BY:
    RANGE UNBOUNDED PRECEDING .. CURRENT ROW — running values, peers share;
    without: whole partition). The reference's distributed planner leaves
    window aggregates unimplemented (scheduler/src/planner.rs); this build
    runs them partition-parallel.
    """

    fn: str
    args: Tuple[Expr, ...]
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[Tuple[Expr, bool], ...]  # (expr, ascending)
    frame: Optional[WindowFrame] = None

    def children(self):
        return self.args + self.partition_by + tuple(e for e, _ in self.order_by)

    def with_children(self, *ch):
        na, np_, no = len(self.args), len(self.partition_by), len(self.order_by)
        args = tuple(ch[:na])
        parts = tuple(ch[na : na + np_])
        orders = tuple((c, asc) for c, (_, asc) in zip(ch[na + np_ :], self.order_by))
        return WindowFunc(self.fn, args, parts, orders, self.frame)

    def data_type(self, schema: Schema) -> DataType:
        if self.fn in ("row_number", "rank", "dense_rank", "count"):
            return DataType.INT64
        if self.fn == "avg":
            return DataType.FLOAT64
        t = self.args[0].data_type(schema)
        if self.fn == "sum" and t.is_integer:
            return DataType.INT64
        return t

    def __repr__(self):
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY " + ", ".join(map(repr, self.partition_by)))
        if self.order_by:
            parts.append(
                "ORDER BY "
                + ", ".join(f"{e!r}{'' if a else ' DESC'}" for e, a in self.order_by)
            )
        if self.frame is not None:
            f = self.frame

            def b(k, v):
                return k if v is None else f"{k}:{v:g}"

            parts.append(f"{f.units.upper()} {b(*f.start)}..{b(*f.end)}")
        return f"{self.fn}({', '.join(map(repr, self.args))}) OVER ({' '.join(parts)})"


@dataclass(frozen=True, eq=False)
class Alias(Expr):
    expr: Expr
    alias_name: str

    def children(self):
        return (self.expr,)

    def with_children(self, *ch):
        return Alias(ch[0], self.alias_name)

    def data_type(self, schema):
        return self.expr.data_type(schema)

    def name(self):
        return self.alias_name

    def __repr__(self):
        return f"{self.expr!r} AS {self.alias_name}"


@dataclass(frozen=True, eq=False)
class OuterCol(Expr):
    """A correlated reference to a column of an *outer* query scope.

    Exists only between SQL planning and decorrelation; the decorrelator turns
    it into a join condition (reference analog: DataFusion's
    ``Expr::OuterReferenceColumn`` consumed by its subquery-unnesting rules).
    """

    col: str
    dtype: DataType

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def __repr__(self):
        return f"outer({self.col})"


# ---- subquery placeholders (exist only between SQL planning and decorrelation)
@dataclass(frozen=True, eq=False)
class ScalarSubquery(Expr):
    plan: Any  # LogicalPlan

    def data_type(self, schema):
        sub_schema = self.plan.schema()
        return sub_schema.fields[0].dtype

    def __repr__(self):
        return "(<scalar subquery>)"


@dataclass(frozen=True, eq=False)
class InSubquery(Expr):
    expr: Expr
    plan: Any
    negated: bool = False

    def children(self):
        return (self.expr,)

    def with_children(self, *ch):
        return InSubquery(ch[0], self.plan, self.negated)

    def data_type(self, schema):
        return DataType.BOOL

    def __repr__(self):
        return f"{self.expr!r} {'NOT ' if self.negated else ''}IN (<subquery>)"


@dataclass(frozen=True, eq=False)
class Exists(Expr):
    plan: Any
    negated: bool = False

    def data_type(self, schema):
        return DataType.BOOL

    def __repr__(self):
        return f"{'NOT ' if self.negated else ''}EXISTS (<subquery>)"


# ---- helpers ------------------------------------------------------------------
def conjuncts(e: Optional[Expr]) -> list[Expr]:
    """Split a predicate into AND-ed conjuncts."""
    if e is None:
        return []
    if isinstance(e, BinaryOp) and e.op == "and":
        return conjuncts(e.left) + conjuncts(e.right)
    return [e]


def conjoin(parts: list[Expr]) -> Optional[Expr]:
    out: Optional[Expr] = None
    for p in parts:
        out = p if out is None else BinaryOp("and", out, p)
    return out


def columns_of(e: Expr) -> set[str]:
    return {n.col for n in walk(e) if isinstance(n, Col)}


def unalias(e: Expr) -> Expr:
    return unalias(e.expr) if isinstance(e, Alias) else e


def fold_constants(e: Expr) -> Expr:
    """Fold literal subtrees: arithmetic (with exact date/interval calendar
    math), comparisons, boolean identities, NOT, IS NULL. The reference gets
    this from DataFusion's SimplifyExpressions/ConstEvaluator rule pair."""

    def fold(node: Expr):
        if isinstance(node, Not) and isinstance(node.expr, Lit):
            v = node.expr.value
            return Lit(None, DataType.BOOL) if v is None else Lit.bool_(not v)
        if isinstance(node, IsNull) and isinstance(node.expr, Lit):
            return Lit.bool_((node.expr.value is None) != node.negated)
        if not isinstance(node, BinaryOp):
            return None
        l, r = node.left, node.right
        if node.op in CMP_OPS and isinstance(l, Lit) and isinstance(r, Lit):
            if l.value is None or r.value is None:
                return Lit(None, DataType.BOOL)
            # only fold comparable kinds: python's == would happily call
            # '25' = 25 False, but SQL coercion semantics say compare as
            # numbers — leave cross-kind literals for the cast machinery
            both_str = l.dtype is DataType.STRING and r.dtype is DataType.STRING
            both_num = l.dtype is not DataType.STRING and r.dtype is not DataType.STRING
            if not (both_str or both_num):
                return None
            out = {
                "=": lambda: l.value == r.value,
                "!=": lambda: l.value != r.value,
                "<": lambda: l.value < r.value,
                "<=": lambda: l.value <= r.value,
                ">": lambda: l.value > r.value,
                ">=": lambda: l.value >= r.value,
            }[node.op]()
            return Lit.bool_(out)
        if node.op in BOOL_OPS:
            for a, b in ((l, r), (r, l)):
                if isinstance(a, Lit) and a.dtype is DataType.BOOL and a.value is not None:
                    if node.op == "and":
                        # FALSE and x = FALSE even for null x; TRUE and x = x
                        return Lit.bool_(False) if not a.value else b
                    return Lit.bool_(True) if a.value else b
            return None
        # date +/- interval with calendar-aware month math
        if isinstance(l, Lit) and l.dtype is DataType.DATE32 and isinstance(r, IntervalLit):
            if node.op not in ("+", "-"):
                raise PlanningError(f"bad interval op {node.op}")
            sign = 1 if node.op == "+" else -1
            d = np.datetime64("1970-01-01") + np.timedelta64(int(l.value), "D")
            if r.months:
                m = d.astype("datetime64[M]") + sign * np.timedelta64(r.months, "M")
                day = (d - d.astype("datetime64[M]")).astype(int)
                d = m.astype("datetime64[D]") + np.timedelta64(int(day), "D")
            if r.days:
                d = d + sign * np.timedelta64(r.days, "D")
            return Lit.date(int((d - np.datetime64("1970-01-01")).astype(int)))
        if isinstance(l, Lit) and isinstance(r, Lit) and node.op in ARITH_OPS:
            lv, rv = l.value, r.value
            out = {
                "+": lambda: lv + rv,
                "-": lambda: lv - rv,
                "*": lambda: lv * rv,
                "/": lambda: lv / rv,
                "%": lambda: lv % rv,
            }[node.op]()
            if l.dtype is DataType.DATE32 or r.dtype is DataType.DATE32:
                return Lit.date(int(out))
            if isinstance(out, float):
                # SQL numeric literals carry decimal intent: 0.06 - 0.01 must
                # fold to 0.05, not 0.049999...96 (the reference folds in
                # decimal128; we round away the binary artifact)
                return Lit.float(round(out, 12))
            return Lit.int(out)
        return None

    return transform(e, fold)
