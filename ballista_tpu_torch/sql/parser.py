"""Recursive-descent SQL parser for the TPC-H dialect + Ballista DDL.

Covers: SELECT [DISTINCT] with expressions/aggregates, FROM with comma joins
and explicit [INNER|LEFT|RIGHT|FULL] JOIN ... ON, WHERE, GROUP BY, HAVING,
ORDER BY ... [ASC|DESC], LIMIT; scalar/IN/EXISTS subqueries (correlated or
not); CASE WHEN; BETWEEN; [NOT] LIKE/IN; IS [NOT] NULL; EXTRACT(YEAR FROM x);
SUBSTRING(x FROM a FOR b); DATE/INTERVAL literals; CREATE EXTERNAL TABLE;
SHOW TABLES; DROP TABLE; EXPLAIN.

Reference analog: DataFusion's sqlparser+SqlToRel, which Ballista reuses
(survey §2.5); the dialect here is the slice its benchmarks and tests exercise.
"""
from __future__ import annotations

from typing import Optional

from ballista_tpu_torch.errors import SqlError
from ballista_tpu_torch.plan.expr import (
    Agg,
    Alias,
    BinaryOp,
    Case,
    Cast,
    Col,
    Exists,
    Expr,
    Func,
    InList,
    InSubquery,
    IntervalLit,
    IsNull,
    Like,
    Lit,
    Not,
    ScalarSubquery,
)
from ballista_tpu_torch.plan.schema import DataType
from ballista_tpu_torch.sql.ast_nodes import (
    CreateExternalTable,
    DropTable,
    Explain,
    JoinClause,
    OrderItem,
    Query,
    ShowTables,
    Statement,
    TableRef,
)
from ballista_tpu_torch.sql.lexer import Token, tokenize

_KEYWORD_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "ON", "AND", "OR",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "CROSS", "AS", "ASC", "DESC",
    "UNION", "INTERSECT", "EXCEPT", "THEN", "ELSE", "END", "WHEN", "BY", "NOT", "IN", "LIKE", "OVER",
    "BETWEEN", "IS", "NULL", "EXISTS", "CASE", "SELECT", "DISTINCT", "OUTER",
    "SEMI", "ANTI", "USING", "FOR", "INTO", "OFFSET", "NULLS",
}

_SQL_TYPES = {
    "INT": DataType.INT64, "INTEGER": DataType.INT64, "BIGINT": DataType.INT64,
    "SMALLINT": DataType.INT32, "FLOAT": DataType.FLOAT64, "DOUBLE": DataType.FLOAT64,
    "REAL": DataType.FLOAT32, "DECIMAL": DataType.FLOAT64, "NUMERIC": DataType.FLOAT64,
    "VARCHAR": DataType.STRING, "CHAR": DataType.STRING, "TEXT": DataType.STRING,
    "STRING": DataType.STRING, "DATE": DataType.DATE32, "BOOLEAN": DataType.BOOL,
}


def parse_sql(sql: str) -> Statement:
    return Parser(tokenize(sql)).parse_statement()


def parse_date(s: str) -> int:
    import numpy as np

    try:
        return int((np.datetime64(s) - np.datetime64("1970-01-01")).astype(int))
    except Exception as e:
        raise SqlError(f"bad date literal {s!r}") from e


class Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.i = 0

    # ---- token helpers ----------------------------------------------------------
    def peek(self, k: int = 0) -> Token:
        return self.tokens[min(self.i + k, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "IDENT" and t.upper in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise SqlError(f"expected {kw}, got {self.peek().text!r} at {self.peek().pos}")

    def at_sym(self, s: str) -> bool:
        t = self.peek()
        return t.kind == "SYM" and t.text == s

    def eat_sym(self, s: str) -> bool:
        if self.at_sym(s):
            self.next()
            return True
        return False

    def expect_sym(self, s: str) -> None:
        if not self.eat_sym(s):
            raise SqlError(f"expected {s!r}, got {self.peek().text!r} at {self.peek().pos}")

    def ident(self) -> str:
        t = self.next()
        if t.kind != "IDENT":
            raise SqlError(f"expected identifier, got {t.text!r} at {t.pos}")
        return t.text.lower()

    # ---- statements -------------------------------------------------------------
    def parse_statement(self) -> Statement:
        if self.at_kw("SELECT"):
            q = self.parse_query()
            self.finish()
            return q
        if self.at_kw("CREATE"):
            s = self.parse_create()
            self.finish()
            return s
        if self.at_kw("SHOW"):
            self.next()
            self.expect_kw("TABLES")
            self.finish()
            return ShowTables()
        if self.at_kw("DROP"):
            self.next()
            self.expect_kw("TABLE")
            if_exists = False
            if self.eat_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            name = self.ident()
            self.finish()
            return DropTable(name, if_exists)
        if self.at_kw("EXPLAIN"):
            self.next()
            analyze = self.eat_kw("ANALYZE")
            verify = False if analyze else self.eat_kw("VERIFY")
            q = self.parse_query()
            self.finish()
            return Explain(q, analyze=analyze, verify=verify)
        raise SqlError(f"unsupported statement starting with {self.peek().text!r}")

    def finish(self):
        self.eat_sym(";")
        if self.peek().kind != "EOF":
            raise SqlError(f"trailing tokens at {self.peek().pos}: {self.peek().text!r}")

    def parse_create(self) -> CreateExternalTable:
        self.expect_kw("CREATE")
        self.expect_kw("EXTERNAL")
        self.expect_kw("TABLE")
        name = self.ident()
        schema = None
        if self.eat_sym("("):
            schema = []
            while True:
                col = self.ident()
                ty = self.ident().upper()
                # swallow type params like DECIMAL(15,2) / VARCHAR(25)
                if self.eat_sym("("):
                    while not self.eat_sym(")"):
                        self.next()
                if ty not in _SQL_TYPES:
                    raise SqlError(f"unknown SQL type {ty}")
                schema.append((col, ty))
                if not self.eat_sym(","):
                    break
            self.expect_sym(")")
        self.expect_kw("STORED")
        self.expect_kw("AS")
        fmt = self.ident().lower()
        if fmt not in ("parquet", "csv"):
            raise SqlError(f"unsupported format {fmt}")
        has_header = False  # reference: header only with WITH HEADER ROW
        if self.eat_kw("WITH"):
            self.expect_kw("HEADER")
            self.expect_kw("ROW")
            has_header = True
        self.expect_kw("LOCATION")
        loc = self.next()
        if loc.kind != "STRING":
            raise SqlError("LOCATION expects a string literal")
        return CreateExternalTable(name, fmt, loc.text, schema, has_header)

    # ---- queries ----------------------------------------------------------------
    def parse_query(self) -> Query:
        q = self.parse_select_core()
        while self.at_kw("UNION", "INTERSECT", "EXCEPT"):
            op = self.next().upper.lower()
            all_ = bool(self.eat_kw("ALL"))
            if op in ("intersect", "except") and all_:
                raise SqlError(f"{op.upper()} ALL is not supported")
            q.unions.append((self.parse_select_core(), op, all_))
        # trailing ORDER BY / LIMIT bind to the whole union
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            q.order_by.append(self.parse_order_item())
            while self.eat_sym(","):
                q.order_by.append(self.parse_order_item())
        if self.eat_kw("LIMIT"):
            t = self.next()
            if t.kind != "NUMBER":
                raise SqlError("LIMIT expects a number")
            q.limit = int(t.text)
        if self.eat_kw("OFFSET"):
            t = self.next()
            if t.kind != "NUMBER":
                raise SqlError("OFFSET expects a number")
            q.offset = int(t.text)
        return q

    def parse_select_core(self) -> Query:
        self.expect_kw("SELECT")
        q = Query()
        q.distinct = bool(self.eat_kw("DISTINCT"))
        q.projections = [self.parse_projection()]
        while self.eat_sym(","):
            q.projections.append(self.parse_projection())
        if self.eat_kw("FROM"):
            q.from_tables.append(self.parse_table_ref())
            while True:
                if self.eat_sym(","):
                    q.from_tables.append(self.parse_table_ref())
                    continue
                join = self.try_parse_join()
                if join is None:
                    break
                q.joins.append(join)
        if self.eat_kw("WHERE"):
            q.where = self.parse_expr()
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            q.group_by.append(self.parse_expr())
            while self.eat_sym(","):
                q.group_by.append(self.parse_expr())
        if self.eat_kw("HAVING"):
            q.having = self.parse_expr()
        # ORDER BY / LIMIT are parsed by parse_query so they scope over UNIONs
        return q

    def parse_projection(self) -> Expr:
        if self.at_sym("*"):
            self.next()
            return Col("*")
        e = self.parse_expr()
        if self.eat_kw("AS"):
            return Alias(e, self.ident())
        t = self.peek()
        if t.kind == "IDENT" and t.upper not in _KEYWORD_STOP:
            return Alias(e, self.ident())
        return e

    def parse_order_item(self) -> OrderItem:
        e = self.parse_expr()
        asc = True
        if self.eat_kw("DESC"):
            asc = False
        else:
            self.eat_kw("ASC")
        nulls_first = None  # None = engine default (NULLS LAST asc, FIRST desc)
        if self.eat_kw("NULLS"):
            if self.eat_kw("FIRST"):
                nulls_first = True
            elif self.eat_kw("LAST"):
                nulls_first = False
            else:
                raise SqlError("expected FIRST or LAST after NULLS")
        return OrderItem(e, asc, nulls_first)

    def parse_table_ref(self) -> TableRef:
        if self.eat_sym("("):
            sub = self.parse_query()
            self.expect_sym(")")
            alias = None
            if self.eat_kw("AS"):
                alias = self.ident()
            elif self.peek().kind == "IDENT" and self.peek().upper not in _KEYWORD_STOP:
                alias = self.ident()
            return TableRef(subquery=sub, alias=alias)
        name = self.ident()
        alias = None
        if self.eat_kw("AS"):
            alias = self.ident()
        elif self.peek().kind == "IDENT" and self.peek().upper not in _KEYWORD_STOP:
            alias = self.ident()
        return TableRef(name=name, alias=alias)

    def try_parse_join(self) -> Optional[JoinClause]:
        kind = None
        if self.at_kw("JOIN") or self.at_kw("INNER"):
            self.eat_kw("INNER")
            kind = "inner"
        elif self.at_kw("LEFT"):
            self.next()
            self.eat_kw("OUTER")
            kind = "left"
            if self.eat_kw("SEMI"):
                kind = "semi"
            elif self.eat_kw("ANTI"):
                kind = "anti"
        elif self.at_kw("RIGHT"):
            self.next()
            self.eat_kw("OUTER")
            kind = "right"
        elif self.at_kw("FULL"):
            self.next()
            self.eat_kw("OUTER")
            kind = "full"
        elif self.at_kw("CROSS"):
            self.next()
            kind = "cross"
        elif self.at_kw("SEMI"):
            self.next()
            kind = "semi"
        elif self.at_kw("ANTI"):
            self.next()
            kind = "anti"
        if kind is None:
            return None
        self.expect_kw("JOIN")
        table = self.parse_table_ref()
        on = None
        if kind != "cross":
            self.expect_kw("ON")
            on = self.parse_expr()
        return JoinClause(kind, table, on)

    # ---- expressions (precedence climbing) --------------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        e = self.parse_and()
        while self.eat_kw("OR"):
            e = BinaryOp("or", e, self.parse_and())
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.eat_kw("AND"):
            e = BinaryOp("and", e, self.parse_not())
        return e

    def parse_not(self) -> Expr:
        if self.eat_kw("NOT"):
            return Not(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        e = self.parse_additive()
        while True:
            negated = False
            save = self.i
            if self.eat_kw("NOT"):
                negated = True
            if self.eat_kw("BETWEEN"):
                lo = self.parse_additive()
                self.expect_kw("AND")
                hi = self.parse_additive()
                rng = BinaryOp("and", BinaryOp(">=", e, lo), BinaryOp("<=", e, hi))
                e = Not(rng) if negated else rng
                continue
            if self.eat_kw("LIKE"):
                pat = self.next()
                if pat.kind != "STRING":
                    raise SqlError("LIKE expects a string literal pattern")
                e = Like(e, pat.text, negated)
                continue
            if self.eat_kw("IN"):
                self.expect_sym("(")
                if self.at_kw("SELECT"):
                    sub = self.parse_query()
                    self.expect_sym(")")
                    e = InSubquery(e, sub, negated)
                else:
                    vals = [self.parse_additive()]
                    while self.eat_sym(","):
                        vals.append(self.parse_additive())
                    self.expect_sym(")")
                    from ballista_tpu_torch.plan.expr import fold_constants

                    vals = [fold_constants(v) for v in vals]
                    for v in vals:
                        if not isinstance(v, Lit):
                            raise SqlError(
                                "IN list supports constant expressions only"
                            )
                    e = InList(e, tuple(vals), negated)
                continue
            if negated:
                self.i = save
                break
            if self.eat_kw("IS"):
                neg = bool(self.eat_kw("NOT"))
                self.expect_kw("NULL")
                e = IsNull(e, neg)
                continue
            t = self.peek()
            if t.kind == "SYM" and t.text in ("=", "!=", "<>", "<", "<=", ">", ">="):
                self.next()
                op = "!=" if t.text == "<>" else t.text
                e = BinaryOp(op, e, self.parse_additive())
                continue
            break
        return e

    def parse_additive(self) -> Expr:
        # || binds LOWER than +/- (pg precedence): 'a' || i + 1 is 'a' || (i+1)
        e = self._parse_add_sub()
        while self.eat_sym("||"):
            e = Func("concat_op", (e, self._parse_add_sub()))
        return e

    def _parse_add_sub(self) -> Expr:
        e = self.parse_multiplicative()
        while True:
            if self.eat_sym("+"):
                e = BinaryOp("+", e, self.parse_multiplicative())
            elif self.eat_sym("-"):
                e = BinaryOp("-", e, self.parse_multiplicative())
            else:
                return e

    def parse_multiplicative(self) -> Expr:
        e = self.parse_unary()
        while True:
            if self.eat_sym("*"):
                e = BinaryOp("*", e, self.parse_unary())
            elif self.eat_sym("/"):
                e = BinaryOp("/", e, self.parse_unary())
            elif self.eat_sym("%"):
                e = BinaryOp("%", e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> Expr:
        if self.eat_sym("-"):
            e = self.parse_unary()
            if isinstance(e, Lit) and e.dtype in (DataType.INT64, DataType.FLOAT64):
                return Lit(-e.value, e.dtype)
            return BinaryOp("-", Lit.int(0), e)
        if self.eat_sym("+"):
            return self.parse_unary()
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            if "." in t.text or "e" in t.text or "E" in t.text:
                return Lit.float(float(t.text))
            return Lit.int(int(t.text))
        if t.kind == "STRING":
            self.next()
            return Lit.str_(t.text)
        if self.eat_sym("("):
            if self.at_kw("SELECT"):
                sub = self.parse_query()
                self.expect_sym(")")
                return ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect_sym(")")
            return e
        if t.kind != "IDENT":
            raise SqlError(f"unexpected token {t.text!r} at {t.pos}")
        kw = t.upper

        if kw == "CASE":
            return self.parse_case()
        if kw == "EXISTS":
            self.next()
            self.expect_sym("(")
            sub = self.parse_query()
            self.expect_sym(")")
            return Exists(sub)
        if kw == "NULL":
            self.next()
            return Lit(None, DataType.FLOAT64)
        if kw in ("TRUE", "FALSE"):
            self.next()
            return Lit.bool_(kw == "TRUE")
        if kw == "DATE" and self.peek(1).kind == "STRING":
            self.next()
            return Lit.date(parse_date(self.next().text))
        if kw == "INTERVAL":
            self.next()
            v = self.next()
            if v.kind not in ("STRING", "NUMBER"):
                raise SqlError("INTERVAL expects a quoted or numeric count")
            count = int(float(v.text))
            unit = self.ident().upper().rstrip("S")
            if unit == "YEAR":
                return IntervalLit(months=12 * count)
            if unit == "MONTH":
                return IntervalLit(months=count)
            if unit == "DAY":
                return IntervalLit(days=count)
            if unit == "WEEK":
                return IntervalLit(days=7 * count)
            raise SqlError(f"unsupported interval unit {unit}")
        if kw == "EXTRACT":
            self.next()
            self.expect_sym("(")
            part = self.ident().lower()
            self.expect_kw("FROM")
            arg = self.parse_expr()
            self.expect_sym(")")
            if part not in ("year", "month", "day"):
                raise SqlError(f"unsupported extract part {part}")
            return Func(part, (arg,))
        if kw == "SUBSTRING":
            self.next()
            self.expect_sym("(")
            arg = self.parse_expr()
            if self.eat_kw("FROM"):
                start = self.parse_expr()
                length = None
                if self.eat_kw("FOR"):
                    length = self.parse_expr()
            else:
                self.expect_sym(",")
                start = self.parse_expr()
                length = None
                if self.eat_sym(","):
                    length = self.parse_expr()
            self.expect_sym(")")
            args = (arg, start) + ((length,) if length is not None else ())
            return Func("substr", args)
        if kw == "CAST":
            self.next()
            self.expect_sym("(")
            arg = self.parse_expr()
            self.expect_kw("AS")
            ty = self.ident().upper()
            if self.eat_sym("("):
                while not self.eat_sym(")"):
                    self.next()
            self.expect_sym(")")
            if ty not in _SQL_TYPES:
                raise SqlError(f"unknown cast type {ty}")
            return Cast(arg, _SQL_TYPES[ty])

        # function call or (qualified) column reference
        if self.peek(1).kind == "SYM" and self.peek(1).text == "(":
            fname = self.ident().lower()
            self.expect_sym("(")
            if fname == "count" and self.eat_sym("*"):
                self.expect_sym(")")
                if self.at_kw("OVER"):
                    return self.parse_over(fname, ())
                return Agg("count_star")
            distinct = bool(self.eat_kw("DISTINCT"))
            args = []
            if not self.at_sym(")"):
                args.append(self.parse_expr())
                while self.eat_sym(","):
                    args.append(self.parse_expr())
            self.expect_sym(")")
            if self.at_kw("OVER"):
                from ballista_tpu_torch.plan.expr import WINDOW_FUNCS

                if fname not in WINDOW_FUNCS:
                    raise SqlError(f"{fname} is not a window function")
                if distinct:
                    raise SqlError("DISTINCT window aggregates are not supported")
                return self.parse_over(fname, tuple(args))
            if fname in ("row_number", "rank", "dense_rank"):
                raise SqlError(f"{fname} requires an OVER clause")
            if fname in ("sum", "avg", "min", "max", "count"):
                if len(args) != 1:
                    raise SqlError(f"{fname} expects one argument")
                return Agg(fname, args[0], distinct)
            if fname in ("substr", "substring"):
                return Func("substr", tuple(args))
            if fname in (
                "year", "month", "day", "abs", "round", "coalesce", "length",
                "sqrt", "floor", "ceil", "power", "pow", "exp", "ln", "log10",
                "sign", "mod", "nullif", "greatest", "least",
                "upper", "lower", "trim", "ltrim", "rtrim", "replace",
                "concat", "starts_with", "strpos", "date_trunc",
            ):
                return Func("power" if fname == "pow" else fname, tuple(args))
            from ballista_tpu_torch.utils.udf import GLOBAL_UDFS

            if GLOBAL_UDFS.get(fname) is not None:
                return Func(fname, tuple(args))
            raise SqlError(f"unknown function {fname}")

        if kw in _KEYWORD_STOP:
            raise SqlError(f"unexpected keyword {t.text!r} at {t.pos}")
        name = self.ident()
        if self.eat_sym("."):
            name = f"{name}.{self.ident()}"
        return Col(name)

    def parse_over(self, fname: str, args: tuple) -> Expr:
        from ballista_tpu_torch.plan.expr import WindowFunc

        self.expect_kw("OVER")
        self.expect_sym("(")
        partition_by: list[Expr] = []
        order_by: list[tuple[Expr, bool]] = []
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            partition_by.append(self.parse_expr())
            while self.eat_sym(","):
                partition_by.append(self.parse_expr())
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")

            def add(item):
                # non-default NULLS placement desugars into a leading IS NULL
                # key, same as top-level ORDER BY
                if item.nulls_first is not None and item.nulls_first != (not item.asc):
                    order_by.append((IsNull(item.expr), not item.nulls_first))
                order_by.append((item.expr, item.asc))

            add(self.parse_order_item())
            while self.eat_sym(","):
                add(self.parse_order_item())
        frame = None
        if self.at_kw("ROWS", "RANGE"):
            frame = self.parse_window_frame(bool(order_by))
        self.expect_sym(")")
        return WindowFunc(fname, args, tuple(partition_by), tuple(order_by), frame)

    def parse_window_frame(self, has_order_by: bool):
        """``ROWS|RANGE [BETWEEN <bound> AND <bound> | <bound>]`` — the short
        form means BETWEEN <bound> AND CURRENT ROW (SQL standard)."""
        from ballista_tpu_torch.plan.expr import (
            CURRENT_ROW, FOLLOWING, PRECEDING, UNBOUNDED_FOLLOWING,
            UNBOUNDED_PRECEDING, WindowFrame,
        )

        units = "rows" if self.eat_kw("ROWS") else "range"
        if units == "range":
            self.expect_kw("RANGE")

        def bound() -> tuple:
            if self.eat_kw("UNBOUNDED"):
                if self.eat_kw("PRECEDING"):
                    return (UNBOUNDED_PRECEDING, None)
                self.expect_kw("FOLLOWING")
                return (UNBOUNDED_FOLLOWING, None)
            if self.eat_kw("CURRENT"):
                self.expect_kw("ROW")
                return (CURRENT_ROW, None)
            e = self.parse_expr()
            if (
                not isinstance(e, Lit)
                or isinstance(e.value, (str, bool))
                or e.value is None
            ):
                raise SqlError("window frame offset must be a numeric literal")
            off = float(e.value)
            if off < 0:
                raise SqlError("window frame offset cannot be negative")
            if self.eat_kw("PRECEDING"):
                return (PRECEDING, off)
            self.expect_kw("FOLLOWING")
            return (FOLLOWING, off)

        if self.eat_kw("BETWEEN"):
            start = bound()
            self.expect_kw("AND")
            end = bound()
        else:
            start, end = bound(), (CURRENT_ROW, None)
        frame = WindowFrame(units, start, end)
        try:
            frame.validate()
        except ValueError as e:
            raise SqlError(str(e)) from None
        offsets = [b for b in (start, end) if b[0] in (PRECEDING, FOLLOWING)]
        if units == "rows":
            for kind, off in offsets:
                if off != int(off):
                    raise SqlError("ROWS frame offsets must be integers")
        if not has_order_by and (units == "range" and offsets):
            raise SqlError("RANGE offsets require an ORDER BY")
        return frame

    def parse_case(self) -> Expr:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.eat_kw("WHEN"):
            cond = self.parse_expr()
            if operand is not None:
                cond = BinaryOp("=", operand, cond)
            self.expect_kw("THEN")
            val = self.parse_expr()
            branches.append((cond, val))
        else_ = None
        if self.eat_kw("ELSE"):
            else_ = self.parse_expr()
        self.expect_kw("END")
        return Case(tuple(branches), else_)
