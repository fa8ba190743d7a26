"""Physical plan operators.

Reference analog: DataFusion ``ExecutionPlan`` operators plus Ballista's three
shuffle operators (``arrow-ballista: ballista/core/src/execution_plans/``).
Partitioning semantics mirror the reference: every operator declares an output
partition count; exchanges are explicit (``RepartitionExec`` locally,
``ShuffleWriterExec``/``ShuffleReaderExec`` across the cluster after the
distributed planner splits stages at these boundaries).

On the TPU build a *stage* (the subtree between shuffle boundaries) is the unit
the JAX engine traces into one jit-compiled XLA program.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ballista_tpu_torch.plan.expr import Agg, Alias, Expr, unalias
from ballista_tpu_torch.plan.schema import DataType, Field, Schema


# ---- partitioning spec -----------------------------------------------------------
@dataclass(frozen=True)
class HashPartitioning:
    exprs: tuple[Expr, ...]
    n: int

    def __repr__(self):
        return f"Hash({list(self.exprs)!r}, n={self.n})"


@dataclass(frozen=True)
class SinglePartition:
    n: int = 1

    def __repr__(self):
        return "Single"


class PhysicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> tuple["PhysicalPlan", ...]:
        return ()

    def output_partitions(self) -> int:
        raise NotImplementedError

    def with_children(self, *ch: "PhysicalPlan") -> "PhysicalPlan":
        assert not ch
        return self

    def indent(self, level: int = 0) -> str:
        s = "  " * level + self._line()
        for c in self.children():
            s += "\n" + c.indent(level + 1)
        return s

    def _line(self) -> str:
        return type(self).__name__

    def __repr__(self):
        return self.indent()

    def fingerprint(self) -> str:
        """Stable identity for the stage compile cache."""
        ch = ",".join(c.fingerprint() for c in self.children())
        return f"{self._line()}[{ch}]"


@dataclass(repr=False)
class ParquetScanExec(PhysicalPlan):
    """Leaf scan over parquet file groups; one output partition per group.

    ``filters`` are evaluated post-read (host-side, incl. string predicates);
    row-group pruning by parquet stats happens at read time.
    """

    table: str
    file_groups: list[list[str]]
    table_schema: Schema
    projection: Optional[list[str]] = None
    filters: list[Expr] = field(default_factory=list)
    # catalog-shared dictionary references (docs/strings.md): column name ->
    # dict_id; scanned string Columns carry the id so leaf encodes emit
    # stable codes and shuffles can move codes on the wire
    dict_refs: Optional[dict] = None
    # per-file-group row counts from parquet metadata at registration
    # (docs/shuffle.md "leaf-stage row estimates"): exact pre-filter scan
    # cardinality, so scheduler precompile hints and the pipelined-shuffle
    # pending-piece estimator can size leaf-scan consumers without waiting
    # for the completion-kick refinement. None = unknown (memory tables,
    # hand-built plans).
    group_rows: Optional[list[int]] = None

    def schema(self) -> Schema:
        return (
            self.table_schema
            if self.projection is None
            else self.table_schema.select(self.projection)
        )

    def output_partitions(self) -> int:
        return max(1, len(self.file_groups))

    def _line(self):
        return (
            f"ParquetScan: {self.table} parts={self.output_partitions()}"
            f" proj={self.projection} filters={self.filters}"
        )


@dataclass(repr=False)
class MemoryScanExec(PhysicalPlan):
    """In-memory partitions (tests, standalone collect paths, cached tables)."""

    partitions: list[Any]  # list[ColumnBatch]
    mem_schema: Schema
    projection: Optional[list[str]] = None  # column pruning at the leaf

    def schema(self) -> Schema:
        if self.projection is None:
            return self.mem_schema
        return self.mem_schema.select(self.projection)

    def output_partitions(self) -> int:
        return max(1, len(self.partitions))

    def _line(self):
        return f"MemoryScan: parts={len(self.partitions)} proj={self.projection}"

    def fingerprint(self) -> str:
        return f"MemoryScan[{self.schema().names}]"


@dataclass(repr=False)
class EmptyExec(PhysicalPlan):
    produce_one_row: bool = True

    def schema(self) -> Schema:
        return Schema(())

    def output_partitions(self) -> int:
        return 1

    def _line(self):
        return f"Empty(one_row={self.produce_one_row})"


@dataclass(repr=False)
class FilterExec(PhysicalPlan):
    input: PhysicalPlan
    predicate: Expr

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return FilterExec(ch[0], self.predicate)

    def output_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        return f"Filter: {self.predicate!r}"


@dataclass(repr=False)
class ProjectExec(PhysicalPlan):
    input: PhysicalPlan
    exprs: list[Expr]

    def schema(self) -> Schema:
        s = self.input.schema()
        return Schema(tuple(Field(e.name(), e.data_type(s)) for e in self.exprs))

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return ProjectExec(ch[0], self.exprs)

    def output_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        return f"Project: {', '.join(map(repr, self.exprs))}"


# "merge" is engine-internal (never serialized): partial-layout states in,
# partial-layout states out — the streaming final aggregate folds shuffle-read
# chunks through it, keeping resident state bounded by the distinct-group count
# (reference: DataFusion's merge_batch on accumulator states, which the final
# HashAggregateExec invokes batch-by-batch over the shuffle stream)
AGG_MODES = ("single", "partial", "final", "merge")


def agg_state_fields(agg: Agg, name: str, in_schema: Schema) -> list[Field]:
    """Accumulator-state columns a partial aggregate emits for one aggregate."""
    if agg.fn == "avg":
        return [Field(f"{name}#sum", DataType.FLOAT64), Field(f"{name}#count", DataType.INT64)]
    if agg.fn in ("count", "count_star"):
        return [Field(f"{name}#count", DataType.INT64)]
    if agg.distinct:
        # distinct values travel as extra group keys; handled by planner rewrite
        raise AssertionError("distinct aggs are rewritten before partial split")
    dt = agg.data_type(in_schema)
    return [Field(f"{name}#{agg.fn}", dt)]


@dataclass(repr=False)
class HashAggregateExec(PhysicalPlan):
    input: PhysicalPlan
    mode: str  # single | partial | final
    group_exprs: list[Expr]
    agg_exprs: list[Expr]  # Alias(Agg)
    # in final mode, group_exprs/agg_exprs are expressed against the ORIGINAL
    # input schema; the operator resolves state columns by name.
    input_schema_for_aggs: Optional[Schema] = None

    def __post_init__(self):
        assert self.mode in AGG_MODES

    def _agg_pairs(self) -> list[tuple[str, Agg]]:
        out = []
        for e in self.agg_exprs:
            a = unalias(e)
            assert isinstance(a, Agg)
            out.append((e.name(), a))
        return out

    def schema(self) -> Schema:
        if self.mode == "merge":
            # state merge preserves the partial layout exactly
            return self.input.schema()
        in_schema = self.input_schema_for_aggs or self.input.schema()
        # final-mode GROUP columns live in the PARTIAL OUTPUT (they are Cols
        # named after the partial's group fields — an expression group key
        # like upper(s) does not exist in the original input schema); agg
        # state types still resolve against the original input
        group_schema = self.input.schema() if self.mode == "final" else in_schema
        groups = [Field(e.name(), e.data_type(group_schema)) for e in self.group_exprs]
        if self.mode == "partial":
            states = []
            for name, a in self._agg_pairs():
                states.extend(agg_state_fields(a, name, in_schema))
            return Schema(tuple(groups + states))
        aggs = [Field(e.name(), e.data_type(in_schema)) for e in self.agg_exprs]
        return Schema(tuple(groups + aggs))

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return HashAggregateExec(
            ch[0], self.mode, self.group_exprs, self.agg_exprs, self.input_schema_for_aggs
        )

    def output_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        return (
            f"HashAggregate[{self.mode}]: group={[repr(g) for g in self.group_exprs]} "
            f"aggs={[repr(a) for a in self.agg_exprs]}"
        )


@dataclass(repr=False)
class HashJoinExec(PhysicalPlan):
    """Equi join. ``collect_build`` broadcasts the build (right) side to every
    probe partition; otherwise both inputs must already be hash-partitioned on
    the keys (reference: CollectLeft vs Partitioned in DataFusion's HashJoin,
    threshold from ``ballista.optimizer.hash_join_single_partition_threshold``)."""

    left: PhysicalPlan
    right: PhysicalPlan
    how: str
    on: list[tuple[Expr, Expr]]
    filter: Optional[Expr] = None
    collect_build: bool = False
    # HBM governor verdict (engine/memory_model.govern_plan): no partition
    # count fits this join's program in the device budget, so the jax engine
    # runs it as the PAGED device join tier — build and probe hash-split into
    # budget-sized passes over device-resident chunks (Grace-style, riding
    # the k-way spill machinery). Host engines ignore the flag.
    paged: bool = False

    def schema(self) -> Schema:
        ls, rs = self.left.schema(), self.right.schema()
        if self.how in ("semi", "anti"):
            return ls
        if self.how in ("left", "full"):
            rs = Schema(tuple(Field(f.name, f.dtype, True) for f in rs))
        if self.how in ("right", "full"):
            ls = Schema(tuple(Field(f.name, f.dtype, True) for f in ls))
        return ls.join(rs)

    def children(self):
        return (self.left, self.right)

    def with_children(self, *ch):
        return HashJoinExec(
            ch[0], ch[1], self.how, self.on, self.filter, self.collect_build,
            self.paged,
        )

    def output_partitions(self) -> int:
        return self.left.output_partitions()

    def _line(self):
        on = ", ".join(f"{l!r}={r!r}" for l, r in self.on)
        extra = " collect_build" if self.collect_build else ""
        paged = " paged" if self.paged else ""
        filt = f" filter={self.filter!r}" if self.filter is not None else ""
        return f"HashJoin[{self.how}]: on=[{on}]{filt}{extra}{paged}"


@dataclass(repr=False)
class CrossJoinExec(PhysicalPlan):
    left: PhysicalPlan
    right: PhysicalPlan  # collected & broadcast

    def schema(self) -> Schema:
        return self.left.schema().join(self.right.schema())

    def children(self):
        return (self.left, self.right)

    def with_children(self, *ch):
        return CrossJoinExec(ch[0], ch[1])

    def output_partitions(self) -> int:
        return self.left.output_partitions()

    def _line(self):
        return "CrossJoin"


@dataclass(repr=False)
class SortExec(PhysicalPlan):
    """Per-partition sort; optionally top-k bounded by ``fetch``."""

    input: PhysicalPlan
    keys: list[tuple[Expr, bool]]
    fetch: Optional[int] = None

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return SortExec(ch[0], self.keys, self.fetch)

    def output_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        k = [(repr(e), "asc" if a else "desc") for e, a in self.keys]
        f = f" fetch={self.fetch}" if self.fetch is not None else ""
        return f"Sort: {k}{f}"


@dataclass(repr=False)
class SortPreservingMergeExec(PhysicalPlan):
    """N sorted partitions -> 1 sorted partition (pipeline breaker)."""

    input: PhysicalPlan
    keys: list[tuple[Expr, bool]]

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return SortPreservingMergeExec(ch[0], self.keys)

    def output_partitions(self) -> int:
        return 1

    def _line(self):
        return "SortPreservingMerge"


@dataclass(repr=False)
class CoalescePartitionsExec(PhysicalPlan):
    """N partitions -> 1 (pipeline breaker; stage boundary in the planner)."""

    input: PhysicalPlan

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return CoalescePartitionsExec(ch[0])

    def output_partitions(self) -> int:
        return 1

    def _line(self):
        return "CoalescePartitions"


@dataclass(repr=False)
class LimitExec(PhysicalPlan):
    input: PhysicalPlan
    n: int  # -1 = no limit (OFFSET only)
    global_: bool = False  # global limit requires a single input partition
    offset: int = 0  # applied only when global

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return LimitExec(ch[0], self.n, self.global_, self.offset)

    def output_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        off = f" offset={self.offset}" if self.offset else ""
        return f"Limit[{'global' if self.global_ else 'local'}]: {self.n}{off}"


@dataclass(repr=False)
class RepartitionExec(PhysicalPlan):
    """Hash exchange (pipeline breaker; becomes a shuffle in distributed mode;
    becomes an ICI ``all_to_all`` when producer and consumer stages are
    co-scheduled on one TPU mesh). ``est_rows`` (set by the physical planner
    from catalog statistics) lets the distributed planner decide whether the
    exchange is small enough to co-schedule inline on one fat executor."""

    input: PhysicalPlan
    partitioning: HashPartitioning
    est_rows: int = 0

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return RepartitionExec(ch[0], self.partitioning, self.est_rows)

    def output_partitions(self) -> int:
        return self.partitioning.n

    def _line(self):
        return f"Repartition: {self.partitioning!r}"


@dataclass(repr=False)
class IciExchangeExec(RepartitionExec):
    """A hash exchange the distributed planner collapsed onto one fat
    executor's device mesh: instead of becoming a ShuffleWriter/Reader
    boundary (the Flight tier), the exchange stays INLINE in its stage and
    the engine compiles it into the stage program as a mesh collective
    (``jax.lax.all_to_all`` via ``parallel/ici.py``) — rows never leave HBM
    between the producer and consumer bodies.

    Subclasses :class:`RepartitionExec` so every engine path that handles an
    inline exchange (fused device exchange, host materialized fallback on
    non-jax engines, shared-engine stage detection) applies unchanged; the
    jax engine additionally treats reaching this node on any NON-collective
    path as a demotion signal (``IciDemoted``) so the scheduler re-plans the
    exchange onto the Flight tier with lineage intact.

    ``exchange_id`` is job-unique and stable across serde: it is how a
    demotion report names the exchange to split out of the stage.
    """

    exchange_id: int = 0

    def with_children(self, *ch):
        return IciExchangeExec(ch[0], self.partitioning, self.est_rows, self.exchange_id)

    def _line(self):
        return f"IciExchange[{self.exchange_id}]: {self.partitioning!r}"


@dataclass(repr=False)
class MegastageExec(PhysicalPlan):
    """Whole-query mesh-compilation boundary (docs/megastage.md): the
    distributed planner wraps an ENTIRE ICI-eligible chain — scan ->
    partial-agg -> hash-exchange -> join -> hash-exchange -> final-agg —
    so the jax engine traces it as ONE pjit/shard_map program. Every
    :class:`IciExchangeExec` inside runs as an inline ``jax.lax.all_to_all``
    and the program's exchange inputs are DONATED (``donate_argnums``), so
    the HBM governor prices the fused program as the running max over
    segments instead of the sum.

    Pure passthrough wrapper: schema/partitioning are the input's, and the
    stage splitter never creates a boundary at it (the inner exchanges are
    already inline). Demotion strips the wrapper and re-splits the named
    exchanges onto the Flight tier byte-identically — the wrapper carries no
    state of its own, so stripping it IS the staged plan.
    """

    input: PhysicalPlan

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return MegastageExec(ch[0])

    def output_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        return "Megastage"


@dataclass(repr=False)
class WindowExec(PhysicalPlan):
    """Per-partition window evaluation; upstream exchange guarantees rows of
    one PARTITION BY group are co-located (or a single partition when there
    is no PARTITION BY)."""

    input: PhysicalPlan
    window_exprs: list[Expr]  # Alias(WindowFunc)

    def schema(self) -> Schema:
        in_schema = self.input.schema()
        extra = tuple(
            Field(e.name(), e.data_type(in_schema)) for e in self.window_exprs
        )
        return Schema(in_schema.fields + extra)

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return WindowExec(ch[0], self.window_exprs)

    def output_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        return f"Window: {[repr(e) for e in self.window_exprs]}"


@dataclass(repr=False)
class UnionExec(PhysicalPlan):
    """Concatenation of inputs' partitions (positionally aligned schemas)."""

    inputs: list[PhysicalPlan]

    def schema(self) -> Schema:
        return self.inputs[0].schema()

    def children(self):
        return tuple(self.inputs)

    def with_children(self, *ch):
        return UnionExec(list(ch))

    def output_partitions(self) -> int:
        return sum(c.output_partitions() for c in self.inputs)

    def _line(self):
        return f"Union: {len(self.inputs)} inputs"


# ---- distributed shuffle operators (reference: core/src/execution_plans/) --------
@dataclass(repr=False)
class ShuffleWriterExec(PhysicalPlan):
    """Stage root: executes its subtree for one input partition and hash-
    repartitions the output into materialized shuffle partitions
    (reference: shuffle_writer.rs:68-336)."""

    job_id: str
    stage_id: int
    input: PhysicalPlan
    partitioning: Optional[HashPartitioning]  # None = keep input partitioning
    # shared-dictionary refs of the exchanged schema (mirror of the consumer
    # leaf's): the writer may transport these columns as int32 codes
    dict_refs: Optional[dict] = None

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return (self.input,)

    def with_children(self, *ch):
        return ShuffleWriterExec(self.job_id, self.stage_id, ch[0],
                                 self.partitioning, self.dict_refs)

    def output_partitions(self) -> int:
        return self.partitioning.n if self.partitioning else self.input.output_partitions()

    def input_partitions(self) -> int:
        return self.input.output_partitions()

    def _line(self):
        return f"ShuffleWriter[stage={self.stage_id}]: {self.partitioning!r}"


@dataclass(repr=False)
class UnresolvedShuffleExec(PhysicalPlan):
    """Placeholder leaf for a not-yet-located input stage
    (reference: unresolved_shuffle.rs:34-126)."""

    stage_id: int
    out_schema: Schema
    n_partitions: int
    # shared-dictionary refs of the exchanged schema: lets the compile-hint
    # service trace string stages from the registry instead of declining
    dict_refs: Optional[dict] = None

    def schema(self) -> Schema:
        return self.out_schema

    def output_partitions(self) -> int:
        return self.n_partitions

    def _line(self):
        return f"UnresolvedShuffle[stage={self.stage_id}] parts={self.n_partitions}"

    def fingerprint(self) -> str:
        return f"UnresolvedShuffle[{self.stage_id}]"


@dataclass(repr=False)
class ShuffleReaderExec(PhysicalPlan):
    """Leaf reading materialized shuffle partitions, local-file fast path or
    Flight fetch (reference: shuffle_reader.rs:59-171)."""

    stage_id: int
    out_schema: Schema
    # partition_locations[i] = list of PartitionLocation dicts for output part i
    partition_locations: list[list[Any]]
    dict_refs: Optional[dict] = None  # carried over from the unresolved leaf
    # adaptive execution (docs/adaptive.md): partition_ranges[i] = (start, end)
    # — the contiguous range of PLANNED reduce partitions reader partition i
    # serves. None = identity (one planned partition per reader partition).
    # A coalesced entry spans several planned partitions; a skew-split
    # partition repeats its one-partition range across the probe slices.
    # The consolidated-fetch path groups each entry's pieces by producing
    # executor, so a range costs ONE Flight stream per executor, not one per
    # planned partition. PV005 checks range/piece consistency.
    partition_ranges: Optional[list] = None

    def schema(self) -> Schema:
        return self.out_schema

    def output_partitions(self) -> int:
        return max(1, len(self.partition_locations))

    def _line(self):
        aqe = ""
        if self.partition_ranges is not None:
            aqe = f" ranges={[tuple(r) for r in self.partition_ranges]!r}"
        return f"ShuffleReader[stage={self.stage_id}] parts={self.output_partitions()}{aqe}"

    def fingerprint(self) -> str:
        # deliberately EXCLUDES locations and ranges: every task of the stage
        # (and a post-coalesce re-resolution) shares one compiled program
        # identity, so AQE re-plans reuse the compile-cache keys instead of
        # minting fresh exact compiles
        return f"ShuffleReader[{self.stage_id}]"


def walk_physical(plan: PhysicalPlan):
    yield plan
    for c in plan.children():
        yield from walk_physical(c)
