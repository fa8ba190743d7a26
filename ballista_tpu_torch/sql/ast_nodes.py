"""SQL AST produced by the parser, consumed by the logical planner."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from ballista_tpu_torch.plan.expr import Expr


@dataclass
class TableRef:
    """FROM-clause item: a named table or a derived table (subquery)."""

    name: Optional[str] = None
    subquery: Optional["Query"] = None
    alias: Optional[str] = None


@dataclass
class JoinClause:
    kind: str  # inner | left | right | full | cross
    table: TableRef
    on: Optional[Expr] = None


@dataclass
class OrderItem:
    expr: Expr
    asc: bool = True
    # None = engine default (NULLS LAST for asc, NULLS FIRST for desc)
    nulls_first: "bool | None" = None


@dataclass
class Query:
    projections: list[Expr] = field(default_factory=list)
    from_tables: list[TableRef] = field(default_factory=list)
    joins: list[JoinClause] = field(default_factory=list)  # trailing explicit JOINs
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    distinct: bool = False
    # set-operation branches appended to this query (left-associative);
    # order_by/limit above apply to the combined result
    unions: list[tuple["Query", str, bool]] = field(default_factory=list)  # (query, op, all)


@dataclass
class CreateExternalTable:
    name: str
    file_format: str  # parquet | csv
    location: str
    schema: Optional[list[tuple[str, str]]] = None  # (name, sql type) for csv
    has_header: bool = True


@dataclass
class ShowTables:
    pass


@dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclass
class Explain:
    query: Query
    # EXPLAIN ANALYZE: execute the query and annotate the physical plan with
    # per-operator rows / elapsed_ms / compile_ms from the collected trace
    analyze: bool = False
    # EXPLAIN VERIFY: run the plan invariant analyzer (no execution) and
    # return its findings as rows (severity, rule, operator, message)
    verify: bool = False


Statement = Union[Query, CreateExternalTable, ShowTables, DropTable, Explain]
