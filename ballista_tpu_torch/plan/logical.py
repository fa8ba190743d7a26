"""Logical plan nodes.

Reference analog: DataFusion's ``LogicalPlan`` as serialized by Ballista's
codec (``arrow-ballista: ballista/core/src/serde/mod.rs``; messages in
``core/proto/datafusion.proto``). The node set is the slice the TPC-H dialect
needs; window aggregates are intentionally absent (the reference's distributed
planner leaves them unimplemented too, ``scheduler/src/planner.rs``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ballista_tpu_torch.plan.expr import Agg, Alias, Expr, unalias
from ballista_tpu_torch.plan.schema import DataType, Field, Schema


class LogicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> tuple["LogicalPlan", ...]:
        return ()

    def indent(self, level: int = 0) -> str:
        s = "  " * level + self._line()
        for c in self.children():
            s += "\n" + c.indent(level + 1)
        return s

    def _line(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.indent()


@dataclass(repr=False)
class Scan(LogicalPlan):
    table: str
    table_schema: Schema
    projection: Optional[list[str]] = None  # column pruning
    filters: list[Expr] = field(default_factory=list)  # pushed-down predicates

    def schema(self) -> Schema:
        if self.projection is None:
            return self.table_schema
        return self.table_schema.select(self.projection)

    def _line(self):
        proj = "" if self.projection is None else f" proj={self.projection}"
        filt = "" if not self.filters else f" filters={self.filters}"
        return f"Scan: {self.table}{proj}{filt}"


@dataclass(repr=False)
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: Expr

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def _line(self):
        return f"Filter: {self.predicate!r}"


@dataclass(repr=False)
class Project(LogicalPlan):
    input: LogicalPlan
    exprs: list[Expr]

    def schema(self) -> Schema:
        in_schema = self.input.schema()
        return Schema(
            tuple(Field(e.name(), e.data_type(in_schema)) for e in self.exprs)
        )

    def children(self):
        return (self.input,)

    def _line(self):
        return f"Project: {', '.join(map(repr, self.exprs))}"


@dataclass(repr=False)
class Aggregate(LogicalPlan):
    """Group-by aggregate. Output schema = group fields then agg fields."""

    input: LogicalPlan
    group_exprs: list[Expr]
    agg_exprs: list[Expr]  # Alias(Agg) or Agg

    def schema(self) -> Schema:
        in_schema = self.input.schema()
        fields = [Field(e.name(), e.data_type(in_schema)) for e in self.group_exprs]
        fields += [Field(e.name(), e.data_type(in_schema)) for e in self.agg_exprs]
        return Schema(tuple(fields))

    def children(self):
        return (self.input,)

    def _line(self):
        return (
            f"Aggregate: group={[repr(g) for g in self.group_exprs]} "
            f"aggs={[repr(a) for a in self.agg_exprs]}"
        )


JOIN_KINDS = ("inner", "left", "right", "full", "semi", "anti", "cross")


@dataclass(repr=False)
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    how: str
    on: list[tuple[Expr, Expr]] = field(default_factory=list)  # (left key, right key)
    filter: Optional[Expr] = None  # evaluated over left+right combined schema

    def __post_init__(self):
        assert self.how in JOIN_KINDS, self.how

    def schema(self) -> Schema:
        ls, rs = self.left.schema(), self.right.schema()
        if self.how in ("semi", "anti"):
            return ls
        if self.how == "left":
            rs = Schema(tuple(Field(f.name, f.dtype, True) for f in rs))
        if self.how == "right":
            ls = Schema(tuple(Field(f.name, f.dtype, True) for f in ls))
        if self.how == "full":
            ls = Schema(tuple(Field(f.name, f.dtype, True) for f in ls))
            rs = Schema(tuple(Field(f.name, f.dtype, True) for f in rs))
        return ls.join(rs)

    def children(self):
        return (self.left, self.right)

    def _line(self):
        on = ", ".join(f"{l!r}={r!r}" for l, r in self.on)
        filt = f" filter={self.filter!r}" if self.filter is not None else ""
        return f"Join[{self.how}]: on=[{on}]{filt}"


@dataclass(repr=False)
class Sort(LogicalPlan):
    input: LogicalPlan
    keys: list[tuple[Expr, bool]]  # (expr, ascending)

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def _line(self):
        return f"Sort: {[(repr(e), 'asc' if a else 'desc') for e, a in self.keys]}"


@dataclass(repr=False)
class Limit(LogicalPlan):
    input: LogicalPlan
    n: int
    offset: int = 0

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def _line(self):
        off = f" offset={self.offset}" if self.offset else ""
        return f"Limit: {self.n}{off}"


@dataclass(repr=False)
class SubqueryAlias(LogicalPlan):
    """Renames every output field with an ``alias.`` qualifier."""

    input: LogicalPlan
    alias: str

    def schema(self) -> Schema:
        return Schema(
            tuple(
                Field(f"{self.alias}.{f.name.split('.')[-1]}", f.dtype, f.nullable)
                for f in self.input.schema()
            )
        )

    def children(self):
        return (self.input,)

    def _line(self):
        return f"SubqueryAlias: {self.alias}"


@dataclass(repr=False)
class Window(LogicalPlan):
    """Window computation: appends one column per window expression.

    The reference's distributed planner leaves window aggregates
    unimplemented (scheduler/src/planner.rs); here they plan as
    Repartition(partition keys) -> per-partition window evaluation."""

    input: LogicalPlan
    window_exprs: list[Expr]  # Alias(WindowFunc)

    def schema(self) -> Schema:
        in_schema = self.input.schema()
        extra = tuple(
            Field(e.name(), e.data_type(in_schema)) for e in self.window_exprs
        )
        return Schema(self.input.schema().fields + extra)

    def children(self):
        return (self.input,)

    def _line(self):
        return f"Window: {[repr(e) for e in self.window_exprs]}"


@dataclass(repr=False)
class EmptyRelation(LogicalPlan):
    """One row, zero columns (``SELECT 1``-style queries)."""

    produce_one_row: bool = True

    def schema(self) -> Schema:
        return Schema(())

    def _line(self):
        return f"EmptyRelation(one_row={self.produce_one_row})"


@dataclass(repr=False)
class Union(LogicalPlan):
    inputs: list[LogicalPlan]

    def schema(self) -> Schema:
        return self.inputs[0].schema()

    def children(self):
        return tuple(self.inputs)

    def _line(self):
        return "Union"


def walk_plan(plan: LogicalPlan):
    yield plan
    for c in plan.children():
        yield from walk_plan(c)
