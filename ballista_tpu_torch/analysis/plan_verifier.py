"""Plan invariant analyzer (Prong A of the static-analysis layer).

A rule-based pass over logical plans, physical plans and shuffle-bounded
stage graphs, run at scheduler submission time and exposed to clients as
``EXPLAIN VERIFY``. The reference stack catches malformed plans in
DataFusion's analyzer before any executor runs (the same up-front
resolution/validation Spark SQL's Catalyst performs); without this pass,
schema/dtype/partition mistakes surface as mid-query task failures on device.

Rule catalog (ids are stable; see docs/static_analysis.md):

* ``PV001 schema-consistency``   — recomputed output schema vs declared
  schema at every node that carries one (union branches, shuffle boundaries).
* ``PV002 unresolved-column``    — a column reference that does not resolve
  against the operator's input schema.
* ``PV003 type-incompatible``    — expressions that cannot type-check:
  arithmetic over strings, comparisons across string/numeric, non-boolean
  predicates, unknown functions, aggregates outside aggregation, invalid
  window frames, distinct aggregates in a partial split.
* ``PV004 device-dtype``         — dtype reachability for the device engine: a
  STRING value flowing into a device-only numeric kernel (error), or a
  string join/group/sort/partition key that cannot ride a catalog-SHARED
  dictionary (warning; docs/strings.md): *computed* strings never can, and
  plain columns whose dictionary was declined (oversized — see
  ``ballista.engine.max_dict_size`` — or shared dicts disabled) fall back to
  per-batch encoding, which re-keys compiled programs per partition and
  blocks precompile hints. Shared-dictionary columns produce no finding.
* ``PV005 partition-mismatch``   — partition-count consistency: a stage
  writer's output partitions must equal every downstream reader's
  expectation; global limits need a single input partition; degenerate
  partition counts.
* ``PV006 serde-fixed-point``    — serialize -> deserialize -> re-serialize
  must be byte-stable (and fingerprint-stable) so plan hashing and the
  stage compile cache stay deterministic.
* ``PV007 hbm-admission``        — the HBM governor's verdicts
  (engine/memory_model.govern_plan, docs/memory.md): a stage program the
  memory model estimates over the per-chip budget is reported with its
  chosen mitigation (repartitioned to a wider exchange / paged device join —
  warnings), and a plan NO mitigation can fit is an error carrying the fix
  hint — oversized plans fail at admission, never by OOM-killing an
  executor.
* ``PV008 exchange-cache-resolution`` — schema-drift guard for the
  cross-query exchange cache (docs/serving.md): a producer stage resolved
  FROM CACHE must offer exactly the piece schema and partition count its
  consumer ``ShuffleReaderExec`` expects. The key is content-addressed, so
  a mismatch can only mean cache corruption — an error at admission (the
  fix hint names ``ballista.serving.exchange_cache``), never silently wrong
  reads.

Severity: ``error`` blocks submission; ``warning`` is attached to job status
and the trace store.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ballista_tpu_torch.errors import PlanVerificationError  # noqa: F401 - raised by callers
from ballista_tpu_torch.plan import logical as L
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.expr import (
    Agg,
    Alias,
    ARITH_OPS,
    BinaryOp,
    BOOL_OPS,
    Case,
    CMP_OPS,
    Col,
    Expr,
    Func,
    InList,
    IsNull,
    Like,
    Lit,
    Not,
    WindowFunc,
    unalias,
    walk,
)
from ballista_tpu_torch.plan.schema import DataType, Schema

ERROR = "error"
WARNING = "warning"

# numeric-only device kernels: a STRING reaching one of these runs on data the
# device engine only holds as dictionary codes, silently producing garbage codes
# arithmetic (the dtype passthrough in Func.data_type hides it)
_NUMERIC_ONLY_AGGS = {"sum", "avg"}
_NUMERIC_ONLY_FUNCS = {
    "abs", "round", "floor", "ceil", "sign", "mod", "sqrt", "power", "pow",
    "exp", "ln", "log10",
}
_DATE_FUNCS = {"year", "month", "day", "date_trunc"}
_STRING_FUNCS = {
    "substr", "upper", "lower", "trim", "ltrim", "rtrim", "replace",
    "length", "strpos", "starts_with",
}


@dataclass(frozen=True)
class Finding:
    rule: str       # PV001..PV006
    severity: str   # error | warning
    operator: str   # the flagged operator's display line
    message: str

    def as_row(self) -> list[str]:
        return [self.severity, self.rule, self.operator, self.message]


class _Sink:
    """Ordered, de-duplicated finding accumulator."""

    def __init__(self):
        self.findings: list[Finding] = []
        self._seen: set[tuple] = set()

    def add(self, rule: str, severity: str, operator: str, message: str) -> None:
        f = Finding(rule, severity, operator, message)
        key = (f.rule, f.operator, f.message)
        if key not in self._seen:
            self._seen.add(key)
            self.findings.append(f)


def _op_line(node) -> str:
    try:
        return node._line()
    except Exception:  # noqa: BLE001 - display only
        return type(node).__name__


def _safe_dtype(e: Expr, schema: Schema) -> Optional[DataType]:
    try:
        return e.data_type(schema)
    except Exception:  # noqa: BLE001 - reported through the rules below
        return None


# ---- expression rules (PV002/PV003/PV004) -----------------------------------------
def _check_expr(e: Expr, schema: Schema, op: str, sink: _Sink,
                allow_aggs: bool = False) -> bool:
    """Validate one expression against its input schema. Returns True when the
    expression resolves (so callers may use its dtype downstream)."""
    ok = True
    for node in walk(e):
        if isinstance(node, Col):
            try:
                schema.index_of(node.col)
            except KeyError as err:
                sink.add("PV002", ERROR, op, str(err))
                ok = False
    if not ok:
        return False

    for node in walk(e):
        if isinstance(node, Agg) and not allow_aggs:
            sink.add("PV003", ERROR, op,
                     f"aggregate {node!r} outside an aggregation operator")
            ok = False
        if isinstance(node, BinaryOp):
            lt = _safe_dtype(node.left, schema)
            rt = _safe_dtype(node.right, schema)
            if lt is None or rt is None:
                continue
            if node.op in ARITH_OPS and DataType.STRING in (lt, rt):
                sink.add("PV003", ERROR, op,
                         f"arithmetic {node!r} over a string operand "
                         f"({lt.value} {node.op} {rt.value})")
                ok = False
            elif node.op in CMP_OPS and (lt is DataType.STRING) != (rt is DataType.STRING):
                sink.add("PV003", ERROR, op,
                         f"comparison {node!r} between string and "
                         f"{(rt if lt is DataType.STRING else lt).value}")
                ok = False
            elif node.op in BOOL_OPS:
                for side, t in ((node.left, lt), (node.right, rt)):
                    if t is not DataType.BOOL:
                        sink.add("PV003", ERROR, op,
                                 f"{node.op.upper()} operand {side!r} is "
                                 f"{t.value}, expected bool")
                        ok = False
        if isinstance(node, Like):
            t = _safe_dtype(node.expr, schema)
            if t is not None and t is not DataType.STRING:
                sink.add("PV003", ERROR, op,
                         f"LIKE over non-string operand {node.expr!r} ({t.value})")
                ok = False
        if isinstance(node, Agg):
            t = None if node.expr is None else _safe_dtype(node.expr, schema)
            if t is DataType.STRING and node.fn in _NUMERIC_ONLY_AGGS:
                sink.add("PV004", ERROR, op,
                         f"{node.fn}({node.expr!r}) aggregates a string column "
                         "on a numeric-only device kernel")
                ok = False
        if isinstance(node, Func) and node.args:
            t = _safe_dtype(node.args[0], schema)
            if t is DataType.STRING and node.fn in _NUMERIC_ONLY_FUNCS:
                sink.add("PV004", ERROR, op,
                         f"{node.fn}() applied to string {node.args[0]!r}: "
                         "device kernel is numeric-only")
                ok = False
            if t is not None and node.fn in _DATE_FUNCS and t is not DataType.DATE32:
                sink.add("PV003", ERROR, op,
                         f"{node.fn}() expects a date, got {t.value} "
                         f"({node.args[0]!r})")
                ok = False
            if t is not None and t is not DataType.STRING and node.fn in _STRING_FUNCS:
                sink.add("PV003", ERROR, op,
                         f"{node.fn}() expects a string, got {t.value} "
                         f"({node.args[0]!r})")
                ok = False
        if isinstance(node, WindowFunc) and node.frame is not None:
            try:
                node.frame.validate()
            except ValueError as err:
                sink.add("PV003", ERROR, op, f"invalid window frame: {err}")
                ok = False

    if _safe_dtype(e, schema) is None:
        try:
            e.data_type(schema)
        except Exception as err:  # noqa: BLE001 - converted into a finding
            sink.add("PV003", ERROR, op, f"cannot type {e!r}: {err}")
        ok = False
    return ok


def _check_predicate(e: Expr, schema: Schema, op: str, sink: _Sink) -> None:
    if _check_expr(e, schema, op, sink):
        t = _safe_dtype(e, schema)
        if t is not None and t is not DataType.BOOL:
            sink.add("PV003", ERROR, op,
                     f"predicate {e!r} is {t.value}, expected bool")


def _computed_string_key(e: Expr, schema: Schema) -> bool:
    """A string-typed key that is not a plain column reference: it cannot
    ride a catalog-shared dictionary (docs/strings.md), so its per-batch
    dictionary re-keys the compiled stage program on every partition and
    keeps the stage off the precompile-hint path."""
    inner = unalias(e)
    if isinstance(inner, Col):
        return False
    return _safe_dtype(inner, schema) is DataType.STRING


def _input_dict_refs(input_node, sink: "_Sink") -> Optional[dict]:
    """Shared-dictionary refs of an operator's input, or None when the caller
    has no physical input node (logical-plan walks). Memoized per verify run
    (on the sink) — each string-keyed operator would otherwise re-walk its
    whole input subtree, an O(n^2) admission cost on deep plans."""
    if input_node is None:
        return None
    memo = sink.__dict__.setdefault("_dict_refs_memo", {})
    key = id(input_node)
    if key not in memo:
        from ballista_tpu_torch.engine.dictionaries import propagate_dict_refs

        memo[key] = propagate_dict_refs(input_node)
    return memo[key]


def _warn_computed_string_keys(exprs, schema: Schema, what: str, op: str,
                               sink: _Sink, input_node=None) -> None:
    """PV004 string-key triage (docs/strings.md):

    * plain column carrying a SHARED dictionary — fully device-native, no
      finding;
    * plain column WITHOUT one (dictionary oversized/declined, or shared
      dictionaries disabled) — warning naming ``ballista.engine.max_dict_size``:
      the per-batch fallback still executes on device but re-keys the
      compiled program per partition and blocks precompile hints;
    * computed string — warning: no shared dictionary can ever apply.

    ``input_node=None`` (logical walks, detached schemas) only reports the
    computed-string case — a missing ref cannot be distinguished from a
    missing annotation there."""
    refs = _input_dict_refs(input_node, sink)
    for e in exprs:
        inner = unalias(e)
        if _computed_string_key(e, schema):
            sink.add("PV004", WARNING, op,
                     f"computed string {what} {e!r}: cannot ride a shared "
                     "dictionary — per-batch encoding re-keys the compiled "
                     "program on every partition")
            continue
        if refs is None or not isinstance(inner, Col):
            continue
        if _safe_dtype(inner, schema) is not DataType.STRING:
            continue
        from ballista_tpu_torch.engine.dictionaries import lookup_ref

        # exact-then-UNIQUE-short resolution: an ambiguous short name must
        # NOT suppress the warning (a declined a.s next to a shared b.s
        # would otherwise hide a.s's per-batch fallback)
        if lookup_ref(refs, inner.col):
            continue  # shared-dictionary column: device-native end to end
        sink.add("PV004", WARNING, op,
                 f"string {what} {e!r} has no shared dictionary (declined "
                 "or disabled): per-batch dictionaries re-key compiled "
                 "programs per partition and block precompile hints — see "
                 "ballista.engine.max_dict_size")


def _check_join_key_types(on, ls: Schema, rs: Schema, op: str, sink: _Sink) -> None:
    for lk, rk in on:
        lt, rt = _safe_dtype(lk, ls), _safe_dtype(rk, rs)
        if lt is None or rt is None:
            continue
        if lt is not rt and not (lt.is_numeric and rt.is_numeric):
            sink.add("PV003", ERROR, op,
                     f"join key dtype mismatch: {lk!r} is {lt.value}, "
                     f"{rk!r} is {rt.value}")


def _diff_schemas(declared: Schema, computed: Schema, what: str, op: str,
                  sink: _Sink) -> None:
    """PV001: declared vs recomputed schema. dtype/arity skew is an error
    (executors would mis-decode shuffle bytes); name-only skew is a warning
    (alignment is positional)."""
    if len(declared) != len(computed):
        sink.add("PV001", ERROR, op,
                 f"{what}: declared {len(declared)} columns "
                 f"{declared.names}, recomputed {len(computed)} "
                 f"{computed.names}")
        return
    for d, c in zip(declared.fields, computed.fields):
        if d.dtype is not c.dtype:
            sink.add("PV001", ERROR, op,
                     f"{what}: column {d.name!r} declared {d.dtype.value}, "
                     f"recomputed {c.dtype.value}")
        elif d.name != c.name:
            sink.add("PV001", WARNING, op,
                     f"{what}: column declared {d.name!r}, recomputed "
                     f"{c.name!r} (positional alignment)")


# ---- logical plan walk ------------------------------------------------------------
def verify_logical(plan: L.LogicalPlan) -> list[Finding]:
    sink = _Sink()
    _verify_logical(plan, sink)
    _serde_fixed_point(plan, sink, physical=False)
    return sink.findings


def _verify_logical(node: L.LogicalPlan, sink: _Sink) -> Optional[Schema]:
    """Bottom-up: returns the recomputed schema, or None when the subtree is
    already broken (parents skip their expression checks to avoid cascades)."""
    child_schemas = [_verify_logical(c, sink) for c in node.children()]
    if any(s is None for s in child_schemas):
        return None
    op = _op_line(node)

    if isinstance(node, L.Scan):
        if node.projection is not None:
            for name in node.projection:
                if not node.table_schema.has(name):
                    sink.add("PV002", ERROR, op,
                             f"projected column {name!r} not in table schema "
                             f"{node.table_schema.names}")
                    return None
        for f in node.filters:
            _check_predicate(f, node.table_schema, op, sink)
    elif isinstance(node, L.Filter):
        _check_predicate(node.predicate, child_schemas[0], op, sink)
    elif isinstance(node, L.Project):
        for e in node.exprs:
            _check_expr(e, child_schemas[0], op, sink)
    elif isinstance(node, L.Aggregate):
        in_schema = child_schemas[0]
        for g in node.group_exprs:
            _check_expr(g, in_schema, op, sink)
        for a in node.agg_exprs:
            if not isinstance(unalias(a), Agg):
                sink.add("PV003", ERROR, op,
                         f"aggregate list entry {a!r} is not an aggregate")
            else:
                _check_expr(a, in_schema, op, sink, allow_aggs=True)
        _warn_computed_string_keys(node.group_exprs, in_schema, "group key", op, sink)
    elif isinstance(node, L.Join):
        ls, rs = child_schemas
        for lk, _ in node.on:
            _check_expr(lk, ls, op, sink)
        for _, rk in node.on:
            _check_expr(rk, rs, op, sink)
        _check_join_key_types(node.on, ls, rs, op, sink)
        if node.filter is not None:
            _check_predicate(node.filter, ls.join(rs), op, sink)
        _warn_computed_string_keys([k for k, _ in node.on], ls, "join key", op, sink)
    elif isinstance(node, L.Sort):
        for e, _asc in node.keys:
            _check_expr(e, child_schemas[0], op, sink)
        _warn_computed_string_keys(
            [e for e, _ in node.keys], child_schemas[0], "sort key", op, sink)
    elif isinstance(node, L.Limit):
        if node.n < -1 or node.offset < 0:
            sink.add("PV003", ERROR, op,
                     f"invalid limit n={node.n} offset={node.offset}")
    elif isinstance(node, L.Window):
        for e in node.window_exprs:
            if not isinstance(unalias(e), WindowFunc):
                sink.add("PV003", ERROR, op,
                         f"window list entry {e!r} is not a window function")
            else:
                _check_expr(e, child_schemas[0], op, sink)
    elif isinstance(node, L.Union):
        if not node.inputs:
            sink.add("PV001", ERROR, op, "union with no inputs")
            return None
        for i, s in enumerate(child_schemas[1:], start=1):
            _diff_schemas(child_schemas[0], s, f"union branch {i}", op, sink)

    try:
        return node.schema()
    except Exception as err:  # noqa: BLE001 - converted into a finding
        sink.add("PV001", ERROR, op, f"cannot compute output schema: {err}")
        return None


# ---- physical plan walk -----------------------------------------------------------
def verify_physical(plan: P.PhysicalPlan) -> list[Finding]:
    sink = _Sink()
    _verify_physical(plan, sink)
    # exchange-id uniqueness is a whole-plan property: a duplicated id makes
    # an ICI_DEMOTE report ambiguous (one failing exchange would demote every
    # node sharing the id)
    seen_ici: set[int] = set()
    for n in P.walk_physical(plan):
        if isinstance(n, P.IciExchangeExec) and n.exchange_id >= 1:
            if n.exchange_id in seen_ici:
                sink.add("PV005", ERROR, _op_line(n),
                         f"ICI exchange id {n.exchange_id} is not job-unique "
                         "(demotion reports could not name one exchange)")
            seen_ici.add(n.exchange_id)
    _serde_fixed_point(plan, sink, physical=True)
    return sink.findings


def _verify_physical(node: P.PhysicalPlan, sink: _Sink) -> Optional[Schema]:
    child_schemas = [_verify_physical(c, sink) for c in node.children()]
    if any(s is None for s in child_schemas):
        return None
    op = _op_line(node)

    if isinstance(node, P.ParquetScanExec):
        if node.projection is not None:
            for name in node.projection:
                if not node.table_schema.has(name):
                    sink.add("PV002", ERROR, op,
                             f"projected column {name!r} not in table schema "
                             f"{node.table_schema.names}")
                    return None
        for f in node.filters:
            _check_predicate(f, node.table_schema, op, sink)
    elif isinstance(node, P.MemoryScanExec):
        if node.projection is not None:
            for name in node.projection:
                if not node.mem_schema.has(name):
                    sink.add("PV002", ERROR, op,
                             f"projected column {name!r} not in memory schema "
                             f"{node.mem_schema.names}")
                    return None
    elif isinstance(node, P.FilterExec):
        _check_predicate(node.predicate, child_schemas[0], op, sink)
    elif isinstance(node, P.ProjectExec):
        for e in node.exprs:
            _check_expr(e, child_schemas[0], op, sink)
    elif isinstance(node, P.HashAggregateExec):
        in_schema = child_schemas[0]
        if node.mode != "merge":
            # final-mode group exprs are Cols named after the PARTIAL output
            # fields, which IS this node's input schema — same as every other
            # mode (only agg state types resolve against the original input)
            group_schema = in_schema
            agg_schema = (
                node.input_schema_for_aggs
                if node.mode == "final" and node.input_schema_for_aggs is not None
                else in_schema
            )
            for g in node.group_exprs:
                _check_expr(g, group_schema, op, sink)
            for a in node.agg_exprs:
                inner = unalias(a)
                if not isinstance(inner, Agg):
                    sink.add("PV003", ERROR, op,
                             f"aggregate list entry {a!r} is not an aggregate")
                    continue
                _check_expr(a, agg_schema, op, sink, allow_aggs=True)
                if node.mode == "partial" and inner.distinct:
                    sink.add("PV003", ERROR, op,
                             f"distinct aggregate {a!r} in a partial split "
                             "(must be rewritten before the partial/final split)")
            _warn_computed_string_keys(
                node.group_exprs, group_schema, "group key", op, sink,
                input_node=node.input)
    elif isinstance(node, P.HashJoinExec):
        ls, rs = child_schemas
        for lk, _ in node.on:
            _check_expr(lk, ls, op, sink)
        for _, rk in node.on:
            _check_expr(rk, rs, op, sink)
        _check_join_key_types(node.on, ls, rs, op, sink)
        if node.filter is not None:
            _check_predicate(node.filter, ls.join(rs), op, sink)
        _warn_computed_string_keys([k for k, _ in node.on], ls, "join key", op,
                                   sink, input_node=node.left)
        if node.on and not node.collect_build:
            lp = node.left.output_partitions()
            rp = node.right.output_partitions()
            if lp != rp:
                sink.add("PV005", ERROR, op,
                         f"partitioned hash join with {lp} probe vs {rp} "
                         "build partitions (co-partitioning broken)")
    elif isinstance(node, (P.SortExec, P.SortPreservingMergeExec)):
        for e, _asc in node.keys:
            _check_expr(e, child_schemas[0], op, sink)
        _warn_computed_string_keys(
            [e for e, _ in node.keys], child_schemas[0], "sort key", op, sink,
            input_node=node.input)
    elif isinstance(node, P.LimitExec):
        if node.n < -1 or node.offset < 0:
            sink.add("PV003", ERROR, op,
                     f"invalid limit n={node.n} offset={node.offset}")
        if node.global_ and node.input.output_partitions() > 1:
            sink.add("PV005", ERROR, op,
                     f"global limit over {node.input.output_partitions()} "
                     "input partitions (needs a single partition)")
    elif isinstance(node, P.RepartitionExec):
        if node.partitioning.n < 1:
            sink.add("PV005", ERROR, op,
                     f"repartition to {node.partitioning.n} partitions")
        for e in node.partitioning.exprs:
            _check_expr(e, child_schemas[0], op, sink)
        _warn_computed_string_keys(
            node.partitioning.exprs, child_schemas[0], "partition key", op,
            sink, input_node=node.input)
        if isinstance(node, P.IciExchangeExec):
            # the collective exchange materializes its whole input inside ONE
            # stage program: a shuffle boundary below it means the planner
            # promoted an exchange whose input is dynamic — the fat-executor
            # contract (all producer partitions local) cannot hold
            if any(
                isinstance(n, (P.UnresolvedShuffleExec, P.ShuffleReaderExec))
                for n in P.walk_physical(node.input)
            ):
                sink.add("PV005", ERROR, op,
                         "ICI exchange over a shuffle boundary (collective "
                         "input must be stage-local)")
            if node.exchange_id < 1:
                sink.add("PV005", ERROR, op,
                         f"ICI exchange id {node.exchange_id} is invalid "
                         "(must be >= 1 for demotion reports)")
    elif isinstance(node, P.MegastageExec):
        # the megastage boundary only makes sense around promoted collective
        # exchanges: an empty wrapper would compile nothing into one program
        # (and its demotion rewrite would have no exchange to split out)
        inner = list(P.walk_physical(node.input))
        if not any(isinstance(n, P.IciExchangeExec) for n in inner):
            sink.add("PV005", ERROR, op,
                     "megastage without an ICI exchange inside (nothing to "
                     "compile as one mesh program)")
        if any(
            isinstance(n, (P.UnresolvedShuffleExec, P.ShuffleReaderExec,
                           P.ShuffleWriterExec))
            for n in inner
        ):
            sink.add("PV005", ERROR, op,
                     "megastage over a shuffle boundary (the fused mesh "
                     "program's input must be stage-local)")
        if any(isinstance(n, P.MegastageExec) for n in inner):
            sink.add("PV005", ERROR, op,
                     "nested megastage (one mesh program per chain)")
    elif isinstance(node, P.WindowExec):
        for e in node.window_exprs:
            if not isinstance(unalias(e), WindowFunc):
                sink.add("PV003", ERROR, op,
                         f"window list entry {e!r} is not a window function")
            else:
                _check_expr(e, child_schemas[0], op, sink)
    elif isinstance(node, P.UnionExec):
        if not node.inputs:
            sink.add("PV001", ERROR, op, "union with no inputs")
            return None
        for i, s in enumerate(child_schemas[1:], start=1):
            _diff_schemas(child_schemas[0], s, f"union branch {i}", op, sink)
    elif isinstance(node, P.ShuffleWriterExec):
        if node.partitioning is not None:
            if node.partitioning.n < 1:
                sink.add("PV005", ERROR, op,
                         f"shuffle write to {node.partitioning.n} partitions")
            for e in node.partitioning.exprs:
                _check_expr(e, child_schemas[0], op, sink)
    elif isinstance(node, (P.UnresolvedShuffleExec, P.ShuffleReaderExec)):
        if node.output_partitions() < 1:
            sink.add("PV005", ERROR, op, "shuffle read with no partitions")
        if isinstance(node, P.ShuffleReaderExec) and node.partition_ranges is not None:
            _check_partition_ranges(node, op, sink)

    try:
        return node.schema()
    except Exception as err:  # noqa: BLE001 - converted into a finding
        sink.add("PV001", ERROR, op, f"cannot compute output schema: {err}")
        return None


def _check_partition_ranges(node: P.ShuffleReaderExec, op: str, sink: "_Sink") -> None:
    """PV005 for AQE-adapted readers (docs/adaptive.md): partition_ranges[i]
    = (start, end) of planned reduce partitions reader partition i serves.
    Consistency means every planned partition is served exactly once —
    ranges are contiguous from 0 (a coalesced entry spans several planned
    partitions; a skew split REPEATS one range across probe slices) and
    every piece's partition_id lies inside its entry's range. A violation
    silently drops or double-reads rows."""
    rngs = [tuple(r) for r in node.partition_ranges]
    if len(rngs) != len(node.partition_locations):
        sink.add("PV005", ERROR, op,
                 f"{len(rngs)} partition ranges for "
                 f"{len(node.partition_locations)} reader partitions")
        return
    prev = None
    for i, (s, e) in enumerate(rngs):
        if not (0 <= s < e):
            sink.add("PV005", ERROR, op,
                     f"partition range {i} is degenerate: [{s}, {e})")
            return
        if prev is None:
            if s != 0:
                sink.add("PV005", ERROR, op,
                         f"partition ranges start at {s}, not 0 "
                         "(planned partitions dropped)")
                return
        elif (s, e) != prev and s != prev[1]:
            sink.add("PV005", ERROR, op,
                     f"partition range {i} [{s}, {e}) is neither a skew "
                     f"repeat of [{prev[0]}, {prev[1]}) nor contiguous with "
                     "it (planned partitions dropped or double-read)")
            return
        for loc in node.partition_locations[i]:
            pid = int(loc.get("partition_id", 0) or 0)
            if not (s <= pid < e):
                sink.add("PV005", ERROR, op,
                         f"piece of planned partition {pid} filed under "
                         f"range {i} [{s}, {e})")
                return
        prev = (s, e)


# ---- stage graph (shuffle boundaries) ---------------------------------------------
def verify_stages(stages: list[P.ShuffleWriterExec]) -> list[Finding]:
    """Partition-count and schema consistency across every shuffle boundary:
    the writing stage's output partitioning must equal every downstream
    reader's expectation (a skew here silently drops or duplicates data)."""
    sink = _Sink()
    writers = {s.stage_id: s for s in stages}
    for stage in stages:
        for node in P.walk_physical(stage):
            if not isinstance(node, P.UnresolvedShuffleExec):
                continue
            op = f"stage {stage.stage_id}: {_op_line(node)}"
            producer = writers.get(node.stage_id)
            if producer is None:
                sink.add("PV005", ERROR, op,
                         f"reads stage {node.stage_id} which does not exist")
                continue
            want = producer.output_partitions()
            if node.n_partitions != want:
                sink.add("PV005", ERROR, op,
                         f"expects {node.n_partitions} partitions but stage "
                         f"{producer.stage_id} writes {want}")
            try:
                produced = producer.schema()
            except Exception:  # noqa: BLE001 - reported by verify_physical
                continue
            _diff_schemas(node.out_schema, produced,
                          f"shuffle boundary from stage {producer.stage_id}",
                          op, sink)
    return sink.findings


# ---- serde fixed-point (PV006) ----------------------------------------------------
def _serde_fixed_point(plan, sink: _Sink, physical: bool) -> None:
    from ballista_tpu_torch.plan.serde import (
        decode_logical, decode_physical, encode_logical, encode_physical,
    )

    op = _op_line(plan)
    if physical and any(
        isinstance(n, P.MemoryScanExec) for n in P.walk_physical(plan)
    ):
        # standalone-only plans over in-memory partitions never cross a wire
        # (and MemoryScanExec deliberately has no serde form)
        return
    enc = encode_physical if physical else encode_logical
    dec = decode_physical if physical else decode_logical
    try:
        b1 = enc(plan)
    except Exception as err:  # noqa: BLE001 - converted into a finding
        sink.add("PV006", ERROR, op, f"plan is not serializable: {err}")
        return
    try:
        p2 = dec(b1)
        b2 = enc(p2)
    except Exception as err:  # noqa: BLE001 - converted into a finding
        sink.add("PV006", ERROR, op, f"serde round-trip failed: {err}")
        return
    if b1 != b2:
        sink.add("PV006", ERROR, op,
                 "serde round-trip is not byte-stable (plan hashing would "
                 "be nondeterministic)")
        return
    if physical:
        try:
            if p2.fingerprint() != plan.fingerprint():
                sink.add("PV006", ERROR, op,
                         "fingerprint changes across serde round-trip "
                         "(stage compile cache would miss or collide)")
        except Exception as err:  # noqa: BLE001 - converted into a finding
            sink.add("PV006", ERROR, op, f"cannot fingerprint plan: {err}")
    else:
        if repr(p2) != repr(plan):
            sink.add("PV006", ERROR, op,
                     "logical plan display changes across serde round-trip")


# ---- HBM admission (PV007) --------------------------------------------------------
def verify_memory(memory_report) -> list[Finding]:
    """PV007: the HBM governor's verdicts as findings. ``memory_report`` is
    an ``engine.memory_model.MemoryReport`` (or None). Rejections — no
    partition count fits, paging unavailable/exhausted — are errors carrying
    the governor's fix hint; applied mitigations (repartitioned / paged) are
    warnings so the chosen shape is visible in EXPLAIN VERIFY and job
    status."""
    if memory_report is None:
        return []
    sink = _Sink()
    for d in memory_report.decisions:
        if d.action == "rejected":
            sink.add("PV007", ERROR, d.operator, d.message)
        elif d.action in ("repartitioned", "paged"):
            sink.add("PV007", WARNING, d.operator, d.message)
    return sink.findings


# ---- exchange-cache resolution (PV008) --------------------------------------------
def verify_exchange_resolution(stage_plan, entry) -> list[Finding]:
    """PV008: a cached exchange materialization about to substitute for a
    producer stage must match the consumer's expectation exactly — piece
    SCHEMA and output PARTITION COUNT (every consumer reader's width; PV005
    already ties readers to the writer's count). ``entry`` carries
    ``schema_json`` (canonical sorted-key JSON of the exchanged schema) and
    ``n_partitions`` as registered. The cache key is content-addressed, so a
    mismatch means corruption, not staleness — an admission ERROR with a fix
    hint naming the cache knob, never a silently mis-shaped read."""
    import json as _json

    from ballista_tpu_torch.plan.serde import schema_to_json

    sink = _Sink()
    op = _op_line(stage_plan)
    hint = ("; set ballista.serving.exchange_cache=false to bypass the "
            "cross-query exchange cache")
    want_n = stage_plan.output_partitions()
    if int(entry.n_partitions) != want_n:
        sink.add(
            "PV008", ERROR, op,
            f"cached exchange offers {entry.n_partitions} partitions but the "
            f"consumer ShuffleReaderExec expects {want_n}{hint}",
        )
    try:
        want_schema = _json.dumps(
            schema_to_json(stage_plan.schema()), sort_keys=True
        )
    except Exception as err:  # noqa: BLE001 - converted into a finding
        sink.add("PV008", ERROR, op, f"cannot canonicalize schema: {err}{hint}")
        return sink.findings
    if entry.schema_json != want_schema:
        sink.add(
            "PV008", ERROR, op,
            "cached exchange piece schema differs from the consumer "
            f"ShuffleReaderExec's expectation (schema drift){hint}",
        )
    return sink.findings


# ---- entry points -----------------------------------------------------------------
def verify_submission(
    logical: Optional[L.LogicalPlan],
    physical: P.PhysicalPlan,
    fuse_exchange_max_rows: int = 0,
    stages: Optional[list[P.ShuffleWriterExec]] = None,
    memory_report=None,
) -> list[Finding]:
    """Everything the scheduler checks before admitting a job: the physical
    plan, the stage split it will execute, and (when available) the logical
    plan the client shipped. Pass ``stages`` when the caller already split
    the plan (the scheduler reuses the ExecutionGraph's own split instead of
    paying for a second one on the hot submission path), and
    ``memory_report`` when the HBM governor already ran over the plan (its
    verdicts become PV007 findings)."""
    sink = _Sink()
    findings: list[Finding] = []
    if logical is not None:
        findings.extend(verify_logical(logical))
    findings.extend(verify_memory(memory_report))
    findings.extend(verify_physical(physical))
    if stages is None:
        try:
            from ballista_tpu_torch.scheduler.planner import plan_query_stages

            stages = plan_query_stages("verify", physical, fuse_exchange_max_rows)
        except Exception as err:  # noqa: BLE001 - converted into a finding
            sink.add("PV005", ERROR, _op_line(physical),
                     f"cannot split plan into stages: {err}")
            stages = []
    findings.extend(verify_stages(stages))
    findings.extend(sink.findings)
    # stable order, errors first; de-duplicate across the three passes
    seen, out = set(), []
    for f in findings:
        key = (f.rule, f.operator, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return sorted(out, key=lambda f: (f.severity != ERROR,))


def errors_of(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == ERROR]


def warnings_of(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == WARNING]
