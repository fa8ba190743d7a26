"""Host-side (numpy + pyarrow.compute) expression evaluator.

This is the CPU reference engine's evaluator and the host half of the TPU
engine: string-typed predicates are evaluated here by the scan operator and
enter the device program as boolean/encoded columns (see
``ballista_tpu_torch/engine/torch_engine.py``).

Null semantics: boolean results carry a validity mask; ``filter`` treats
unknown as false (SQL three-valued logic collapsed at the filter boundary,
which matches how the reference's kernels feed DataFusion filters).
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from ballista_tpu_torch.errors import ExecutionError, PlanningError
from ballista_tpu_torch.ops.batch import Column, ColumnBatch
from ballista_tpu_torch.plan.expr import (
    Alias,
    BinaryOp,
    Case,
    Cast,
    Col,
    Expr,
    Func,
    InList,
    IntervalLit,
    IsNull,
    Like,
    Lit,
    Not,
)
from ballista_tpu_torch.plan.schema import DataType


def _lit_array(lit: Lit, n: int) -> Column:
    if lit.dtype is DataType.STRING:
        return Column(DataType.STRING, pa.array([lit.value] * n, type=pa.string()))
    if lit.value is None:
        # a NULL literal is an ALL-NULL column, not a NaN/garbage fill —
        # CASE ... ELSE NULL and comparisons against NULL depend on this
        return Column(lit.dtype, np.zeros(n, lit.dtype.to_numpy()), np.zeros(n, bool))
    arr = np.full(n, lit.value, dtype=lit.dtype.to_numpy())
    return Column(lit.dtype, arr)


def _bool_col(values: np.ndarray, valid: Optional[np.ndarray]) -> Column:
    return Column(DataType.BOOL, values.astype(bool), valid)


def _arrow_of(c: Column) -> pa.Array:
    return c.to_arrow()


def _and_valid(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if a is None:
        return b
    if b is None:
        return a
    return a & b


def to_filter_mask(c: Column) -> np.ndarray:
    """Collapse 3-valued bool to a 2-valued mask (unknown -> false)."""
    vals = np.asarray(c.data, dtype=bool)
    if c.valid is not None:
        vals = vals & c.valid
    return vals


def evaluate(expr: Expr, batch: ColumnBatch) -> Column:
    n = batch.num_rows

    if isinstance(expr, Alias):
        return evaluate(expr.expr, batch)

    if isinstance(expr, Col):
        return batch.column(expr.col)

    if isinstance(expr, Lit):
        return _lit_array(expr, n)

    if isinstance(expr, IntervalLit):
        raise PlanningError("unfolded interval reached execution")

    if isinstance(expr, BinaryOp):
        return _eval_binary(expr, batch)

    if isinstance(expr, Not):
        c = evaluate(expr.expr, batch)
        return _bool_col(~np.asarray(c.data, dtype=bool), c.valid)

    if isinstance(expr, IsNull):
        c = evaluate(expr.expr, batch)
        if c.dtype is DataType.STRING:
            isnull = np.asarray(pc.is_null(c.data))
        else:
            isnull = ~c.valid if c.valid is not None else np.zeros(len(c), bool)
        return _bool_col(~isnull if expr.negated else isnull, None)

    if isinstance(expr, Like):
        c = evaluate(expr.expr, batch)
        assert c.dtype is DataType.STRING
        got = np.asarray(pc.match_like(c.data, expr.pattern).fill_null(False))
        return _bool_col(~got if expr.negated else got, None)

    if isinstance(expr, InList):
        c = evaluate(expr.expr, batch)
        vals = [v.value for v in expr.values]  # parser guarantees literals
        if c.dtype is DataType.STRING:
            got = np.asarray(pc.is_in(c.data, value_set=pa.array(vals)).fill_null(False))
            return _bool_col(~got if expr.negated else got, None)
        got = np.isin(np.asarray(c.data), np.asarray(vals))
        return _bool_col(~got if expr.negated else got, c.valid)

    if isinstance(expr, Case):
        return _eval_case(expr, batch)

    if isinstance(expr, Cast):
        c = evaluate(expr.expr, batch)
        if c.dtype is expr.to:
            return c
        if expr.to is DataType.STRING:
            return Column(DataType.STRING, pc.cast(c.to_arrow(), pa.string()))
        if c.dtype is DataType.STRING:
            arr = pc.cast(c.data, expr.to.to_arrow())
            return Column(expr.to, arr)
        return Column(expr.to, np.asarray(c.data).astype(expr.to.to_numpy()), c.valid)

    if isinstance(expr, Func):
        return _eval_func(expr, batch)

    raise ExecutionError(f"cannot evaluate {expr!r}")


def _eval_binary(expr: BinaryOp, batch: ColumnBatch) -> Column:
    op = expr.op
    if op in ("and", "or"):
        l = evaluate(expr.left, batch)
        r = evaluate(expr.right, batch)
        lv, rv = np.asarray(l.data, bool), np.asarray(r.data, bool)
        if op == "and":
            # unknown AND false == false; else unknown stays unknown
            out = lv & rv
            valid = _and_valid(l.valid, r.valid)
            if valid is not None:
                lf = (~lv) & (np.ones_like(lv) if l.valid is None else l.valid)
                rf = (~rv) & (np.ones_like(rv) if r.valid is None else r.valid)
                valid = valid | lf | rf
            return _bool_col(out, valid)
        out = lv | rv
        valid = _and_valid(l.valid, r.valid)
        if valid is not None:
            valid = valid | (lv if l.valid is None else (lv & l.valid)) | (
                rv if r.valid is None else (rv & r.valid)
            )
        return _bool_col(out, valid)

    l = evaluate(expr.left, batch)
    r = evaluate(expr.right, batch)

    if l.dtype is DataType.STRING or r.dtype is DataType.STRING:
        if op not in ("=", "!=", "<", "<=", ">", ">="):
            raise ExecutionError(f"string op {op} unsupported")
        fn = {"=": pc.equal, "!=": pc.not_equal, "<": pc.less, "<=": pc.less_equal,
              ">": pc.greater, ">=": pc.greater_equal}[op]
        res = fn(_arrow_of(l), _arrow_of(r))
        valid = None
        if res.null_count:
            valid = np.asarray(res.is_valid())
            res = res.fill_null(False)
        return _bool_col(np.asarray(res), valid)

    lv, rv = np.asarray(l.data), np.asarray(r.data)
    valid = _and_valid(l.valid, r.valid)
    if op in ("=", "!=", "<", "<=", ">", ">="):
        out = {
            "=": lv == rv, "!=": lv != rv, "<": lv < rv,
            "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv,
        }[op]
        return _bool_col(out, valid)
    if op in ("+", "-", "*", "/", "%"):
        if op == "/":
            out = lv / rv
        elif op == "%":
            out = np.mod(lv, rv)
        else:
            out = {"+": lv + rv, "-": lv - rv, "*": lv * rv}[op]
        dt = expr.data_type(batch.schema)
        return Column(dt, out.astype(dt.to_numpy(), copy=False), valid)
    raise ExecutionError(f"unknown binary op {op}")


def _eval_case(expr: Case, batch: ColumnBatch) -> Column:
    n = batch.num_rows
    out_dtype = expr.data_type(batch.schema)
    if out_dtype is DataType.STRING:
        return _eval_case_string(expr, batch)
    branches = [
        (to_filter_mask(evaluate(c, batch)), evaluate(v, batch))
        for c, v in expr.branches
    ]
    else_col = evaluate(expr.else_, batch) if expr.else_ is not None else None
    # null tracking engages whenever ANY source is nullable (a nullable
    # branch value's nulls must survive the pick), or no ELSE exists
    need_valid = (
        else_col is None
        or else_col.valid is not None
        or any(v.valid is not None for _, v in branches)
    )
    if else_col is not None:
        out = np.asarray(else_col.data, dtype=out_dtype.to_numpy()).copy()
        valid = (
            (np.ones(n, bool) if else_col.valid is None else else_col.valid.copy())
            if need_valid
            else None
        )
    else:
        out = np.zeros(n, out_dtype.to_numpy())
        valid = np.zeros(n, bool)
    assigned = np.zeros(n, bool)
    for cond, vcol in branches:
        pick = cond & ~assigned
        out[pick] = np.asarray(vcol.data, dtype=out_dtype.to_numpy())[pick]
        if valid is not None:
            valid[pick] = True if vcol.valid is None else vcol.valid[pick]
        assigned |= cond
    return Column(out_dtype, out, valid)


def _eval_case_string(expr: Case, batch: ColumnBatch) -> Column:
    """String-valued CASE: object-array picks, None = SQL NULL (arrow
    validity). A NULL-literal branch (typed FLOAT64 by the parser) is a pure
    null contribution. Mirrors the device path's union-dictionary semantics."""
    n = batch.num_rows

    def obj_vals(e) -> np.ndarray:
        # a NULL-literal branch is identified by its EXPRESSION (Lit None),
        # not by a runtime all-null validity mask: a genuinely type-mixed
        # CASE must raise on every engine, no matter what this batch's
        # contents happen to be (ADVICE r4; mirrors the device path's
        # _eval_case_dev_string check)
        from ballista_tpu_torch.plan.expr import unalias

        ue = unalias(e)
        if isinstance(ue, Lit) and ue.value is None:
            return np.full(n, None, dtype=object)  # NULL literal branch
        col = evaluate(e, batch)
        if col.dtype is DataType.STRING:
            return np.asarray(col.data.to_numpy(zero_copy_only=False), dtype=object)
        raise ExecutionError("CASE branches mix string and non-string")

    branches = [
        (to_filter_mask(evaluate(c, batch)), obj_vals(v))
        for c, v in expr.branches
    ]
    out = np.full(n, None, dtype=object)
    if expr.else_ is not None:
        out[:] = obj_vals(expr.else_)
    assigned = np.zeros(n, bool)
    for cond, vals in branches:
        pick = cond & ~assigned
        out[pick] = vals[pick]
        assigned |= cond
    return Column(DataType.STRING, pa.array(out.tolist(), type=pa.string()))


def _require_literals(expr: Func, *arg_ix: int) -> None:
    for i in arg_ix:
        if not isinstance(expr.args[i], Lit):
            raise ExecutionError(
                f"{expr.fn} requires a literal for argument {i + 1}"
            )


def _eval_func(expr: Func, batch: ColumnBatch) -> Column:
    fn = expr.fn
    if fn in ("year", "month"):
        c = evaluate(expr.args[0], batch)
        days = np.asarray(c.data).astype("datetime64[D]")
        if fn == "year":
            out = days.astype("datetime64[Y]").astype(int) + 1970
        else:
            out = (days.astype("datetime64[M]").astype(int) % 12) + 1
        return Column(DataType.INT64, out.astype(np.int64), c.valid)
    if fn == "substr":
        c = evaluate(expr.args[0], batch)
        start = int(expr.args[1].value)  # 1-based SQL position
        length = int(expr.args[2].value) if len(expr.args) > 2 else None
        stop = None if length is None else start - 1 + length
        arr = pc.utf8_slice_codeunits(c.data, start - 1, stop)
        return Column(DataType.STRING, arr)
    if fn == "length":
        c = evaluate(expr.args[0], batch)
        lens = pc.utf8_length(c.data)
        valid = np.asarray(lens.is_valid()) if lens.null_count else None
        return Column(
            DataType.INT64, np.asarray(lens.fill_null(0)).astype(np.int64), valid
        )
    if fn == "abs":
        c = evaluate(expr.args[0], batch)
        return Column(c.dtype, np.abs(np.asarray(c.data)), c.valid)
    if fn == "round":
        c = evaluate(expr.args[0], batch)
        digits = int(expr.args[1].value) if len(expr.args) > 1 else 0
        return Column(c.dtype, np.round(np.asarray(c.data), digits), c.valid)
    if fn == "day":
        c = evaluate(expr.args[0], batch)
        days = np.asarray(c.data).astype("datetime64[D]")
        out = (days - days.astype("datetime64[M]")).astype(int) + 1
        return Column(DataType.INT64, out.astype(np.int64), c.valid)
    if fn == "date_trunc":
        part = str(expr.args[0].value).lower()
        c = evaluate(expr.args[1], batch)
        days = np.asarray(c.data).astype("datetime64[D]")
        if part == "year":
            out = days.astype("datetime64[Y]").astype("datetime64[D]")
        elif part == "month":
            out = days.astype("datetime64[M]").astype("datetime64[D]")
        elif part in ("day", "week"):
            out = days if part == "day" else (
                days - ((days.astype("datetime64[D]").astype(int) + 3) % 7)
            )
        else:
            raise ExecutionError(f"unsupported date_trunc part {part!r}")
        return Column(DataType.DATE32, out.astype(int).astype(np.int32), c.valid)
    if fn in ("sqrt", "exp", "ln", "log10", "floor", "ceil", "sign"):
        c = evaluate(expr.args[0], batch)
        a = np.asarray(c.data).astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            out = {
                "sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "log10": np.log10,
                "floor": np.floor, "ceil": np.ceil, "sign": np.sign,
            }[fn](a)
        return Column(DataType.FLOAT64 if fn not in ("floor", "ceil", "sign") else c.dtype,
                      out.astype(np.float64 if fn not in ("floor", "ceil", "sign") else c.dtype.to_numpy()),
                      c.valid)
    if fn in ("power", "mod"):
        a = evaluate(expr.args[0], batch)
        b = evaluate(expr.args[1], batch)
        av, bv = np.asarray(a.data), np.asarray(b.data)
        valid = _and_valid(a.valid, b.valid)
        if fn == "power":
            return Column(DataType.FLOAT64,
                          np.power(av.astype(np.float64), bv.astype(np.float64)), valid)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(bv != 0, np.fmod(av, np.where(bv != 0, bv, 1)), 0)
        valid = _and_valid(valid, bv != 0)  # mod by zero -> NULL
        return Column(a.dtype, out.astype(a.dtype.to_numpy()), valid)
    if fn == "nullif":
        a = evaluate(expr.args[0], batch)
        b = evaluate(expr.args[1], batch)
        if a.dtype is DataType.STRING:
            eq = np.asarray(pc.equal(a.data, b.to_arrow()).fill_null(False))
            return Column(DataType.STRING, pa.array(
                [None if e else v for e, v in zip(eq, a.data.to_pylist())], pa.string()))
        eq = np.asarray(a.data) == np.asarray(b.data)
        bvalid = b.valid if b.valid is not None else np.ones(len(eq), bool)
        kill = eq & bvalid
        valid = (a.valid if a.valid is not None else np.ones(len(eq), bool)) & ~kill
        return Column(a.dtype, np.asarray(a.data), valid)
    if fn in ("greatest", "least"):
        cols = [evaluate(a, batch) for a in expr.args]
        out_dt = expr.data_type(batch.schema)  # promoted across ALL args
        # pg/DataFusion semantics: NULL arguments are IGNORED; the result is
        # NULL only when every argument is NULL
        if out_dt is DataType.STRING:
            f = pc.max_element_wise if fn == "greatest" else pc.min_element_wise
            arr = f(*[c.to_arrow() for c in cols], skip_nulls=True)
            return Column(DataType.STRING, arr)
        pick = np.maximum if fn == "greatest" else np.minimum
        acc_dt = out_dt.to_numpy()
        n = batch.num_rows
        out = np.asarray(cols[0].data).astype(acc_dt)
        have = cols[0].valid.copy() if cols[0].valid is not None else np.ones(n, bool)
        for nxt in cols[1:]:
            v = np.asarray(nxt.data).astype(acc_dt)
            nv = nxt.valid if nxt.valid is not None else np.ones(n, bool)
            both = have & nv
            out = np.where(both, pick(out, v), np.where(nv & ~have, v, out))
            have = have | nv
        return Column(out_dt, out, None if have.all() else have)
    if fn in ("upper", "lower", "trim", "ltrim", "rtrim"):
        c = evaluate(expr.args[0], batch)
        arr = {
            "upper": pc.utf8_upper, "lower": pc.utf8_lower,
            "trim": pc.utf8_trim_whitespace, "ltrim": pc.utf8_ltrim_whitespace,
            "rtrim": pc.utf8_rtrim_whitespace,
        }[fn](c.data)
        return Column(DataType.STRING, arr)
    if fn == "replace":
        _require_literals(expr, 1, 2)
        c = evaluate(expr.args[0], batch)
        return Column(DataType.STRING, pc.replace_substring(
            c.data, str(expr.args[1].value), str(expr.args[2].value)))
    if fn in ("concat", "concat_op"):
        def _is_null_lit(a):
            return isinstance(a, Lit) and a.value is None

        if fn == "concat":  # concat() skips NULL arguments entirely
            args = [a for a in expr.args if not _is_null_lit(a)]
            if not args:  # concat(NULL, ...) with only NULLs is '' (pg)
                return Column(DataType.STRING,
                              pa.array([""] * batch.num_rows, pa.string()))
            expr = Func(fn, tuple(args))
        elif any(_is_null_lit(a) for a in expr.args):
            # x || NULL is NULL
            return Column(DataType.STRING,
                          pa.array([None] * batch.num_rows, pa.string()))
        cols = [evaluate(a, batch) for a in expr.args]
        arrs = [c.to_arrow() if c.dtype is DataType.STRING else
                pa.array([str(v) if v is not None else None for v in c.to_arrow().to_pylist()], pa.string())
                for c in cols]
        if fn == "concat":  # concat() skips NULL arguments (pg/DataFusion)
            return Column(DataType.STRING, pc.binary_join_element_wise(
                *arrs, "", null_handling="replace", null_replacement=""))
        return Column(DataType.STRING, pc.binary_join_element_wise(*arrs, ""))
    if fn == "starts_with":
        _require_literals(expr, 1)
        c = evaluate(expr.args[0], batch)
        got = pc.starts_with(c.data, str(expr.args[1].value))
        valid = np.asarray(got.is_valid()) if got.null_count else None
        return Column(DataType.BOOL, np.asarray(got.fill_null(False)), valid)
    if fn == "strpos":
        _require_literals(expr, 1)
        c = evaluate(expr.args[0], batch)
        got = pc.find_substring(c.data, str(expr.args[1].value))
        valid = np.asarray(got.is_valid()) if got.null_count else None
        # SQL strpos: 1-based, 0 when absent (find_substring: 0-based, -1)
        return Column(DataType.INT64, np.asarray(got.fill_null(-1)).astype(np.int64) + 1, valid)
    if fn not in ("coalesce",):
        from ballista_tpu_torch.utils.udf import GLOBAL_UDFS

        udf = GLOBAL_UDFS.get(fn)
        if udf is not None:
            args = [evaluate(a, batch) for a in expr.args]
            arrays = [
                np.asarray(c.data) if c.dtype is not DataType.STRING else np.asarray(c.data).astype(object)
                for c in args
            ]
            out = np.asarray(udf.fn(*arrays))
            if udf.return_type is DataType.STRING:
                return Column(DataType.STRING, pa.array(out.tolist(), pa.string()))
            return Column(udf.return_type, out.astype(udf.return_type.to_numpy()))
    if fn == "coalesce":
        cols = [evaluate(a, batch) for a in expr.args]
        out = cols[0]
        for nxt in cols[1:]:
            if out.valid is None and out.dtype is not DataType.STRING:
                return out
            if out.dtype is DataType.STRING:
                out = Column(DataType.STRING, pc.coalesce(out.data, nxt.to_arrow()))
            else:
                take = ~out.valid
                data = np.where(take, np.asarray(nxt.data), np.asarray(out.data))
                valid = None if nxt.valid is None else _and_valid(
                    np.where(take, nxt.valid, True), None
                )
                out = Column(out.dtype, data.astype(out.dtype.to_numpy()), valid)
        return out
    raise ExecutionError(f"unknown function {fn}")
