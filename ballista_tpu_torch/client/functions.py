"""DataFrame expression builders — ``col``/``lit`` and aggregate functions.

Reference analog: the DataFusion prelude the client re-exports
(``arrow-ballista: ballista/client/src/context.rs:85-475`` re-exports
DataFusion's DataFrame + Expr surface; ``python/src/context.rs:43-120``).

    from ballista_tpu_torch.client.functions import col, lit, sum, count
    df.filter(col("a") > lit(5)).aggregate([col("b")], [sum(col("a"))])
"""
from __future__ import annotations

import builtins
from typing import Optional

from ballista_tpu_torch.plan.expr import Agg, Expr, Func, Lit, _as_expr


def col(name: str) -> Expr:
    from ballista_tpu_torch.plan.expr import Col

    return Col(name)


def lit(value) -> Lit:
    return _as_expr(value)


# ---- aggregates (shadow builtins by design, like the DataFusion prelude) ----
def sum(expr: Expr) -> Agg:  # noqa: A001
    return Agg("sum", expr)


def avg(expr: Expr) -> Agg:
    return Agg("avg", expr)


def mean(expr: Expr) -> Agg:
    return Agg("avg", expr)


def min(expr: Expr) -> Agg:  # noqa: A001
    return Agg("min", expr)


def max(expr: Expr) -> Agg:  # noqa: A001
    return Agg("max", expr)


def count(expr: Optional[Expr] = None, distinct: bool = False) -> Agg:
    if expr is None:
        return Agg("count_star")
    return Agg("count", expr, distinct)


def count_star() -> Agg:
    return Agg("count_star")


# ---- scalar functions -------------------------------------------------------
def _fn(name: str, *args) -> Func:
    return Func(name, tuple(_as_expr(a) for a in args))


def abs(expr) -> Func:  # noqa: A001
    return _fn("abs", expr)


def round(expr, digits: int = 0) -> Func:  # noqa: A001
    return _fn("round", expr, builtins.int(digits))


def substr(expr, start: int, length: Optional[int] = None) -> Func:
    if length is None:
        return _fn("substr", expr, start)
    return _fn("substr", expr, start, length)


def year(expr) -> Func:
    return _fn("year", expr)


def month(expr) -> Func:
    return _fn("month", expr)
