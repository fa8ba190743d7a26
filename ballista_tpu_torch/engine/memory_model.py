"""Device-memory model: the memory governor's estimator.

The port's copy of ``ballista_tpu/engine/memory_model.py``. One model of what
one stage program costs in device bytes, used at three layers:

* **admission (the standalone client)** — :func:`govern_plan` walks a
  physical plan, estimates each exchange-consumer stage's per-partition
  program from the planner's row estimates (``RepartitionExec.est_rows``),
  and solves for the smallest partition count whose programs fit the
  device budget (``mesh.pick_shuffle_partitions``). A join no count can fit
  is flagged for the **paged device join** (``HashJoinExec.paged``); with
  paging off the decision is a rejection the client raises as a
  ``PlanVerificationError`` — an oversized plan fails at admission, never by
  running the card out of memory.

* **trace time (torch engine)** — :func:`estimate_program_bytes` re-estimates
  a stage from its ACTUAL leaf encodings (exact pads, duplicate widths,
  ranges) just before it runs; the engine records it as
  ``op.HbmEst.max_bytes``, equal to the JAX engine's. Eager torch holds more
  than a compiled program (no operator fuses), so
  :func:`estimate_eager_program_bytes` adds those terms; the engine records
  it as ``op.HbmEstEager.max_bytes`` beside the measured
  ``op.HbmPeak.max_bytes`` and pages a stage whose eager estimate exceeds
  the budget.

* **the fused exchange** — :func:`estimate_ici_exchange_bytes` is the
  per-device footprint a fused exchange is checked against before it runs,
  and :func:`estimate_megastage_bytes` a megastage's (both equal the JAX
  package's). On a mesh whose shards share a card, each shard's budget is
  the card's over its shards. What a mesh program holds in eager torch is
  :func:`estimate_eager_exchange_bytes` per exchange, summed over a
  program's exchanges by :func:`estimate_eager_megastage_bytes`; the
  engine records it on the program's ``DeviceExecute`` span beside the
  card's measured peak.

The model is deliberately simple and conservative: padded power-of-two leaf
buckets times static column widths (mirroring ``encode_host_batch``), the
join's gather and expansion scratch, the aggregate's id and sort scratch and
a range- or dictionary-bounded group table, plus the program output. Its
numbers equal the JAX package's for the same plan and leaves; the eager
terms are the port's own.

The device probes are torch's: the budget comes from the card's total
memory (``torch.cuda.mem_get_info``), the measured side from the CUDA
allocator's peak.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ballista_tpu_torch.ops.kernels_torch import bucket_size
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.expr import (
    Agg, BinaryOp, Case, Cast, Col, Func, InList, IsNull, Like, Not, unalias, walk,
)
from ballista_tpu_torch.plan.schema import DataType, Schema

log = logging.getLogger("ballista.memory")

GiB = 1 << 30

# fraction of the card's memory the governor plans against: the allocator's
# own reserve and other processes share the card with it (the leaf caches'
# device copies are inside it: DEVICE_CACHE_SHARE)
DEFAULT_BUDGET_FRACTION = 0.85

# share of the device budget the leaf caches' device copies may hold
# (``leaf_cache.DEV``, sized on a CUDA engine's first use): a warm
# TPC-H SF10 working set (about 16 GB) fits it with room, and a stage is
# admitted against the budget less what the cache holds
# (:func:`admission_budget_bytes`), so it keeps at least the rest
DEVICE_CACHE_SHARE = 0.4

# paged join: never split into more passes than this (each pass costs a spill
# round trip; a join needing more passes than this against its budget is
# mis-planned, not pageable)
MAX_PAGED_PASSES = 256


# ---- column / batch widths --------------------------------------------------------
def col_data_bytes(dtype: DataType) -> int:
    """Device bytes per row of one column's data. Strings ride as int32
    dictionary codes; BOOL is a byte mask; the native-dtype policy keeps
    FLOAT64 at 8 bytes (scaled int64) either way."""
    if dtype is DataType.BOOL:
        return 1
    if dtype in (DataType.INT32, DataType.DATE32, DataType.STRING, DataType.FLOAT32):
        return 4
    return 8


def row_data_bytes(schema: Schema) -> int:
    """Per-row data bytes of a schema's columns incl. per-column null masks."""
    total = 0
    for f in schema:
        total += col_data_bytes(f.dtype) + (1 if f.nullable else 0)
    return total


def padded_batch_bytes(schema: Schema, rows: int) -> int:
    """One encoded leaf: power-of-two padded columns + the row_valid mask."""
    pad = bucket_size(max(1, int(rows)))
    return pad * (row_data_bytes(schema) + 1)


# ---- program estimators -----------------------------------------------------------
# The stage's inputs and its output are live for the whole program, while an
# elementwise chain's interior costs only the widest single operator's
# scratch (gather indices, sort permutations, duplicate-build expansions),
# not the sum of every operator's output.
def estimate_join_program(
    probe_schema: Schema,
    probe_rows: int,
    build_schema: Schema,
    build_rows: int,
    how: str,
    max_dup: int = 1,
) -> int:
    """Device bytes of ONE partitioned-join stage program: both padded
    inputs, the sorted build keys, the probe-key hash and position scratch
    (plus the expansion of duplicate builds), and the program output."""
    pad_p = bucket_size(max(1, int(probe_rows)))
    pad_b = bucket_size(max(1, int(build_rows)))
    pw = row_data_bytes(probe_schema) + 1
    bw = row_data_bytes(build_schema) + 1
    total = pad_p * pw + pad_b * bw
    total += int(build_rows) * 8          # host-sorted build keys (bk_sorted)
    total += 2 * 8 * pad_p                # mixed probe key + searchsorted pos
    d = max(1, int(max_dup))
    if d > 1 and how in ("inner", "left", "full"):
        total += pad_p * d * bw           # materialized gathered build
        total += pad_p * (d - 1) * pw     # probe fan-out repeat
    if how in ("semi", "anti"):
        total += pad_p * pw               # output: filtered probe
    elif how in ("right", "full"):
        out_pad = bucket_size(pad_p * d + pad_b)
        total += out_pad * (pw + bw)      # matched section + unmatched build
    else:
        total += pad_p * d * (pw + bw)    # inner/left output
    return int(total)


# duplicate-run bounds: the floor every device join supports whatever the
# budget, and the ceiling the solve may raise it to for EMIT joins (their
# expand path is vectorized slot groups, so the ceiling is a memory question
# the estimator answers; semi and anti joins probe each candidate of a run in
# turn and keep the floor)
BUILD_DUP_FLOOR = 32
BUILD_DUP_CEILING = 1024


def solve_build_dup_cap(
    probe_schema: Schema,
    probe_rows: int,
    build_schema: Schema,
    build_rows: int,
    how: str,
    budget_bytes: int,
) -> int:
    """Largest duplicate-key run a device EMIT join may carry before its
    program outgrows the budget: double the bound while
    :func:`estimate_join_program` still fits. Semi and anti joins keep the
    floor. With no budget (the governor off, or a CPU engine) memory cannot
    veto: the ceiling applies, and the engine's MAX_EXPAND_ROWS check on the
    real probe pad stays the backstop."""
    if how in ("semi", "anti"):
        return BUILD_DUP_FLOOR
    if budget_bytes <= 0:
        return BUILD_DUP_CEILING
    d = BUILD_DUP_FLOOR
    while d < BUILD_DUP_CEILING and estimate_join_program(
        probe_schema, probe_rows, build_schema, build_rows, how, max_dup=d * 2
    ) <= budget_bytes:
        d <<= 1
    return d


def estimate_agg_program(
    in_schema: Schema, in_rows: int, out_schema: Schema, k_bound: Optional[int] = None
) -> int:
    """Device bytes of one aggregate stage program: the padded input, the
    group-id and sort scratch, and the (range-bounded, padded) group table."""
    pad = bucket_size(max(1, int(in_rows)))
    k = pad if not k_bound or k_bound <= 0 else min(pad, int(k_bound))
    k_pad = bucket_size(max(1, k))
    total = pad * (row_data_bytes(in_schema) + 1)
    total += 4 * 8 * pad                  # ids, sorted keys, segment temps
    total += k_pad * (row_data_bytes(out_schema) + 1)
    return int(total)


def estimate_ici_exchange_bytes(schema: Schema, est_rows: int, n_devices: int) -> int:
    """Per-device footprint of a fused exchange: the local input shard, the
    receive buffer, and the merged result — the whole exchange lives in
    device memory."""
    per_dev_rows = max(1, int(est_rows) // max(1, n_devices))
    return 3 * padded_batch_bytes(schema, per_dev_rows)


def estimate_megastage_bytes(
    segments: list[list[tuple[Schema, int]]], n_devices: int
) -> int:
    """Per-device footprint of a whole-query megastage program: the running
    MAX over its segments, each the ``(schema, est_rows)`` exchanges live at
    once (a join's two input exchanges, then the agg-state exchange). The
    stage planner's megastage promotion prices a chain with it."""
    return max(
        (sum(estimate_ici_exchange_bytes(s, r, n_devices) for s, r in seg) for seg in segments),
        default=0,
    )


def estimate_eager_exchange_bytes(schema: Schema, rows: int, n_devices: int) -> int:
    """Per-shard device bytes of one exchange in eager torch
    (``parallel/ici.make_hash_exchange``) of ``rows`` rows a shard of
    ``schema``, and of the body that consumes what it received: the input
    shard; the bucketing scratch (about a dozen int64 and bool arrays a
    row) and one column's send-order gather; every column's send buffer
    and received buffer (one round sends them all); and the consumer's
    sort keys, positions and gathered columns over the received rows. The
    buffers are priced at the always-sufficient capacity (``rows`` from
    every shard), which bounds the skew-bounded one."""
    n_local = bucket_size(max(1, int(rows)))
    recv = max(1, n_devices) * n_local
    w = row_data_bytes(schema) + 1 + 9   # + row validity, the int64 key, its null marker
    return int(n_local * w + 120 * n_local + 2 * recv * w + recv * (w + 32))


def estimate_eager_megastage_bytes(
    segments: list[list[tuple[Schema, int]]], n_devices: int
) -> int:
    """The eager counterpart of :func:`estimate_megastage_bytes`, over the
    same segments (rows over the whole mesh): eager torch has no donation, and a
    join segment's received rows are the join's output, which its aggregate
    reads, so no segment's bytes are known to be free before the next one
    allocates; the segments' eager exchanges
    (:func:`estimate_eager_exchange_bytes`) are summed."""
    n = max(1, n_devices)
    return sum(estimate_eager_exchange_bytes(s, -(-int(r) // n), n)
               for seg in segments for s, r in seg)


def fmt_bytes(n: float) -> str:
    n = float(n)
    for unit, width in (("GB", GiB), ("MB", 1 << 20), ("KB", 1 << 10)):
        if n >= width:
            return f"{n / width:.1f} {unit}"
    return f"{int(n)} B"


# ---- budget resolution ------------------------------------------------------------
_DETECTED: dict[str, int] = {}


def detect_device_budget_bytes(device=None) -> int:
    """The budget of a CUDA device: its total memory
    (``torch.cuda.mem_get_info``) times :data:`DEFAULT_BUDGET_FRACTION`,
    probed once per device. 0 for any other device: a CPU engine has no
    device budget. Only a caller that runs on that device may call this."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    if key not in _DETECTED:
        _free, total = torch.cuda.mem_get_info(dev)
        _DETECTED[key] = int(total * DEFAULT_BUDGET_FRACTION)
    return _DETECTED[key]


# total device memory (``torch.cuda.mem_get_info``'s second value) of the cards
# executors register by name; measured on the card, never taken from a data
# sheet (an H100 80GB HBM3 reports 85,017,493,504 bytes, whose 0.85 is the
# 72,264,869,478-byte budget chip_smoke.py records)
DEVICE_MEMORY_BYTES = {"NVIDIA H100 80GB HBM3": 85_017_493_504}


def shard_budget_bytes(card_bytes: int, shards_per_card: int) -> int:
    """A mesh shard's budget: its card's, split evenly between the mesh's
    shards on that card. The engine (from its own mesh) and the scheduler
    (from the mesh shapes executors register) both split through here."""
    return int(card_bytes) // max(1, int(shards_per_card))


def budget_from_device_kinds(kinds, shards_per_card: int = 1) -> int:
    """The scheduler's budget from its executors' REGISTERED device kinds
    (``ExecutorSpecification.device_kind``: a torch executor on a card
    registers the card's name): :data:`DEVICE_MEMORY_BYTES` times
    :data:`DEFAULT_BUDGET_FRACTION`, as :func:`detect_device_budget_bytes`
    computes it on that card, split between ``shards_per_card`` mesh shards
    (:func:`shard_budget_bytes`), so admission, promotion and the
    executor's engine plan against one number; the least over the kinds
    that map (a mixed cluster plans for its smallest card). 0 when none
    maps (a CPU or host executor, a card not in the table): no budget at
    admission. The scheduler never probes a device of its own."""
    budgets = [int(DEVICE_MEMORY_BYTES[k] * DEFAULT_BUDGET_FRACTION)
               for k in set(kinds) if k in DEVICE_MEMORY_BYTES]
    return shard_budget_bytes(min(budgets), shards_per_card) if budgets else 0


def resolve_budget_bytes(config, detected_bytes: Optional[int] = None, device=None) -> int:
    """The budget the governor plans against:
    ``ballista.engine.hbm_budget_bytes`` > 0 wins; 0 auto-detects — from
    ``detected_bytes`` when the caller supplies one, else from ``device``
    (the standalone path, where the engine and its card share the process);
    < 0 turns the governor off."""
    from ballista_tpu_torch.config import BALLISTA_ENGINE_HBM_BUDGET_BYTES

    try:
        raw = int(config.get(BALLISTA_ENGINE_HBM_BUDGET_BYTES) or 0)
    except Exception:  # noqa: BLE001 - unknown key on minimal configs
        raw = 0
    if raw > 0:
        return raw
    if raw < 0:
        return 0
    if detected_bytes is not None:
        return max(0, int(detected_bytes))
    return detect_device_budget_bytes(device)


def device_cache_bytes(budget_bytes: int) -> int:
    """The capacity of the leaf caches' device copies on a card whose
    budget is ``budget_bytes``: :data:`DEVICE_CACHE_SHARE` of it."""
    return int(max(0, budget_bytes) * DEVICE_CACHE_SHARE)


def admission_budget_bytes(budget_bytes: int, resident_bytes: float) -> int:
    """The budget a stage is admitted against: ``budget_bytes`` less the
    ``resident_bytes`` the leaf caches hold on its card (they occupy the
    card while the stage runs). 0 stays 0 (no budget); a budget the cache
    has filled stays 1 byte, so it never reads as none."""
    if budget_bytes <= 0:
        return budget_bytes
    return max(1, int(budget_bytes - max(0.0, resident_bytes)))


def govern_with_config(
    plan: P.PhysicalPlan, config, n_devices: int,
    detected_budget_bytes: Optional[int] = None, device=None,
) -> tuple[P.PhysicalPlan, Optional["MemoryReport"]]:
    """The call sites' entry: resolve the budget and the paged-join and
    solver knobs from a session config and run :func:`govern_plan`. Returns
    ``(plan, None)`` untouched when no budget applies (knob < 0, or 0 with
    nothing detected)."""
    from ballista_tpu_torch.config import (
        BALLISTA_ENGINE_MAX_SHUFFLE_PARTITIONS,
        BALLISTA_ENGINE_PAGED_JOIN,
    )
    from ballista_tpu_torch.parallel.mesh import MAX_SHUFFLE_PARTITIONS

    budget = resolve_budget_bytes(config, detected_budget_bytes, device)
    if budget <= 0:
        return plan, None
    try:
        paged = bool(config.get(BALLISTA_ENGINE_PAGED_JOIN))
    except Exception:  # noqa: BLE001 - minimal configs without the key
        paged = True
    try:
        maxp = int(
            config.get(BALLISTA_ENGINE_MAX_SHUFFLE_PARTITIONS)
            or MAX_SHUFFLE_PARTITIONS
        )
    except Exception:  # noqa: BLE001
        maxp = MAX_SHUFFLE_PARTITIONS
    return govern_plan(
        plan, budget_bytes=budget, n_devices=max(1, n_devices),
        paged_enabled=paged, max_partitions=maxp,
    )


# ---- governor ---------------------------------------------------------------------
@dataclass(frozen=True)
class GovernorDecision:
    """One exchange-consumer stage's verdict."""

    stage_ordinal: int
    operator: str          # the consumer's display line
    action: str            # "fits" | "repartitioned" | "paged" | "rejected"
    est_bytes: int         # per-partition estimate at the requested count
    est_bytes_after: int   # estimate after the chosen mitigation
    budget_bytes: int
    partitions_before: int
    partitions_after: int
    passes: int = 0        # paged join: planned build/probe passes
    message: str = ""

    def as_dict(self) -> dict:
        return {
            "stage": self.stage_ordinal,
            "operator": self.operator,
            "action": self.action,
            "est_bytes": self.est_bytes,
            "est_bytes_after": self.est_bytes_after,
            "budget_bytes": self.budget_bytes,
            "partitions": [self.partitions_before, self.partitions_after],
            "passes": self.passes,
            "message": self.message,
        }


@dataclass
class MemoryReport:
    """What the governor decided for one plan (``last_memory_report``)."""

    budget_bytes: int
    n_devices: int
    decisions: list[GovernorDecision] = field(default_factory=list)

    def mitigations(self) -> list[GovernorDecision]:
        return [d for d in self.decisions if d.action in ("repartitioned", "paged")]

    def rejections(self) -> list[GovernorDecision]:
        return [d for d in self.decisions if d.action == "rejected"]

    def chosen_partitions(self) -> int:
        """Largest partition count the governor settled on (0 = untouched).
        Only mitigations count: a "fits" decision carries the requested
        width."""
        return max((d.partitions_after for d in self.mitigations()), default=0)

    def as_dict(self) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "n_devices": self.n_devices,
            "decisions": [d.as_dict() for d in self.decisions],
        }


def _sized(msg_prefix: str, est: int, budget: int) -> str:
    return (
        f"{msg_prefix} estimated {fmt_bytes(est)} on a "
        f"{fmt_bytes(budget)} device budget"
    )


def _fix_hint(pageable: bool, paged_enabled: bool) -> str:
    """Name only knobs that can change the verdict: 'enable paged_join' on
    an aggregate (never pageable), or when it is already on, cannot fix the
    rejection."""
    opts = [
        "raise ballista.engine.hbm_budget_bytes",
        "raise ballista.engine.max_shuffle_partitions",
    ]
    if pageable and not paged_enabled:
        opts.append("enable ballista.engine.paged_join")
    opts.append(
        "reduce the per-partition working set "
        "(more selective filters / fewer columns)"
    )
    return "fix: " + ", ".join(opts[:-1]) + ", or " + opts[-1]


def govern_plan(
    plan: P.PhysicalPlan,
    *,
    budget_bytes: int,
    n_devices: int,
    paged_enabled: bool = True,
    max_partitions: Optional[int] = None,
) -> tuple[P.PhysicalPlan, MemoryReport]:
    """Budget-aware partition sizing over a physical plan.

    For every exchange-consumer stage the engine materializes whole
    partitions for (partitioned equi-joins over two hash exchanges; final
    aggregates over a hash exchange), estimate the per-partition program at
    the requested width, and when it exceeds the budget let
    ``mesh.pick_shuffle_partitions`` solve for the smallest device-aligned
    width that fits. Joins no width fits are flagged for the paged device
    join; with paging off the decision is a rejection. Consumers without row
    estimates are left alone (the engine's trace-time check still covers
    them). Untouched subtrees keep their identity.
    """
    from ballista_tpu_torch.parallel.mesh import (
        MAX_SHUFFLE_PARTITIONS, pick_shuffle_partitions,
    )

    if max_partitions is None:
        max_partitions = MAX_SHUFFLE_PARTITIONS
    report = MemoryReport(budget_bytes=budget_bytes, n_devices=max(1, n_devices))
    if budget_bytes <= 0:
        return plan, report
    ordinal = {"n": 0}

    def decide(consumer, est0, n0, footprint: Callable[[int], int], rebuild):
        """Shared solve/record for one consumer; ``rebuild(n, paged)`` builds
        the mitigated node."""
        ordinal["n"] += 1
        op = consumer._line()
        if est0 <= budget_bytes:
            report.decisions.append(GovernorDecision(
                ordinal["n"], op, "fits", est0, est0, budget_bytes, n0, n0,
                message=_sized(f"stage {ordinal['n']}", est0, budget_bytes),
            ))
            return consumer
        n = pick_shuffle_partitions(
            report.n_devices, n0, budget_bytes=budget_bytes,
            bytes_per_partition=footprint, max_partitions=max_partitions,
        )
        if n > 0:
            report.decisions.append(GovernorDecision(
                ordinal["n"], op, "repartitioned", est0, footprint(n),
                budget_bytes, n0, n,
                message=_sized(f"stage {ordinal['n']}", est0, budget_bytes)
                + f"; repartitioned {n0} -> {n}",
            ))
            return rebuild(n, False)
        pageable = isinstance(consumer, P.HashJoinExec)
        if paged_enabled and pageable:
            passes = 2
            while passes < MAX_PAGED_PASSES and footprint(n0 * passes) > budget_bytes:
                passes <<= 1
            if footprint(n0 * passes) <= budget_bytes:
                report.decisions.append(GovernorDecision(
                    ordinal["n"], op, "paged", est0,
                    footprint(n0 * passes), budget_bytes, n0, n0, passes=passes,
                    message=_sized(f"stage {ordinal['n']}", est0, budget_bytes)
                    + f"; over budget even at {max_partitions} partitions — "
                    f"paged device join (~{passes} build/probe passes)",
                ))
                return rebuild(n0, True)
            # the pass solve hit MAX_PAGED_PASSES with the per-bucket program
            # still over budget: admitting it as "paged" would only move the
            # failure into the passes — fall through to rejection
        if not pageable:
            why = "paged join inapplicable"
        elif paged_enabled:
            why = f"paged join exhausted at {MAX_PAGED_PASSES} passes"
        else:
            why = "paged join disabled"
        report.decisions.append(GovernorDecision(
            ordinal["n"], op, "rejected", est0, est0, budget_bytes, n0, n0,
            message=_sized(f"stage {ordinal['n']}", est0, budget_bytes)
            + f"; no mitigation fits (max {max_partitions} partitions, "
            + why
            + f"). {_fix_hint(pageable, paged_enabled)}",
        ))
        return consumer

    def resize_rep(rep: P.RepartitionExec, n: int) -> P.RepartitionExec:
        return P.RepartitionExec(
            rep.input, P.HashPartitioning(rep.partitioning.exprs, n), rep.est_rows
        )

    def walk(node: P.PhysicalPlan) -> P.PhysicalPlan:
        kids = [walk(c) for c in node.children()]
        if kids and any(a is not b for a, b in zip(kids, node.children())):
            node = node.with_children(*kids)

        # partitioned equi-join over two hash exchanges: the engine
        # materializes BOTH partition slices as padded program leaves
        if (
            isinstance(node, P.HashJoinExec)
            and not node.collect_build
            and node.on
            and type(node.left) is P.RepartitionExec
            and type(node.right) is P.RepartitionExec
            and node.left.est_rows
            and node.right.est_rows
        ):
            join = node
            l_schema, r_schema = join.left.schema(), join.right.schema()
            l_rows, r_rows = join.left.est_rows, join.right.est_rows

            def jf(n: int) -> int:
                return estimate_join_program(
                    l_schema, max(1, l_rows // n), r_schema,
                    max(1, r_rows // n), join.how,
                )

            def rebuild(n: int, paged: bool) -> P.PhysicalPlan:
                return P.HashJoinExec(
                    resize_rep(join.left, n), resize_rep(join.right, n),
                    join.how, join.on, join.filter, join.collect_build,
                    paged=paged or join.paged,
                )

            n0 = join.left.partitioning.n
            return decide(join, jf(n0), n0, jf, rebuild)

        # final aggregate over a hash exchange of partial states
        if (
            isinstance(node, P.HashAggregateExec)
            and node.mode == "final"
            and type(node.input) is P.RepartitionExec
            and node.input.est_rows
            and node.group_exprs
        ):
            agg = node
            rep = agg.input
            in_schema, out_schema = rep.schema(), agg.schema()
            rows = rep.est_rows

            def af(n: int) -> int:
                return estimate_agg_program(
                    in_schema, max(1, rows // n), out_schema
                )

            def rebuild(n: int, _paged: bool) -> P.PhysicalPlan:
                return agg.with_children(resize_rep(rep, n))

            n0 = rep.partitioning.n
            return decide(agg, af(n0), n0, af, rebuild)

        return node

    governed = walk(plan)
    for d in report.decisions:
        if d.action != "fits":
            log.info("memory governor: %s", d.message)
    return governed, report


# ---- trace-time estimator (torch engine) ------------------------------------------
def _range_span(name: str, leaves: dict) -> Optional[int]:
    """Cardinality bound for a group-key column, from any collected leaf
    encoding that carries it: an int range span or a dictionary size. None =
    unbounded (the sorted-segmentation worst case)."""
    short = name.split(".")[-1]
    for (_kind, enc, _extra, _ck, _node) in leaves.values():
        try:
            names = [f.name.split(".")[-1] for f in enc.schema]
            if short not in names:
                continue
            i = names.index(short)
            meta = enc.col_meta[i]
            if meta[2] is not None:           # dictionary
                return max(1, len(meta[2]))
            rng = (enc.int_ranges or [None] * len(names))[i]
            if rng is not None:
                return max(1, int(rng[1]))
        except Exception:  # noqa: BLE001 - bound is best-effort
            continue
    return None


def _agg_k_bound(node: P.HashAggregateExec, leaves: dict) -> Optional[int]:
    k = 1
    for g in node.group_exprs:
        inner = unalias(g)
        if not isinstance(inner, Col):
            return None
        span = _range_span(inner.col, leaves)
        if span is None:
            return None
        k *= span
        if k > 1 << 40:
            return None
    return k


def estimate_program_bytes(plan: P.PhysicalPlan, leaves: dict) -> int:
    """Estimate the peak device bytes of one stage program from its ACTUAL
    leaves (``TorchEngine._collect_leaves``: id -> (kind, EncodedBatch,
    extra, cache key, node), a build leaf's ``extra`` its (sorted build
    keys, duplicate bucket)): the encoded leaf arrays (byte-exact), the
    program output, and the widest single operator's scratch. Equals the
    JAX package's estimate of the same stage (``op.HbmEst.max_bytes``)."""
    return _estimate(plan, leaves, eager=False)


def estimate_eager_program_bytes(plan: P.PhysicalPlan, leaves: dict) -> int:
    """:func:`estimate_program_bytes` plus what eager torch holds that a
    compiled XLA program does not (``op.HbmEstEager.max_bytes``; the
    engine's safety net pages against it). No operator fuses, so each
    computed expression's result and temporaries are tensors of their own:
    a projection's computed columns, every aggregate argument (all are live
    until the stage's one ``SegSums`` call) with its mask, a filter's
    predicate temporaries. A join inside the stage holds its full output
    while its consumer runs. A sort gathers every key and the whole batch
    through its permutation. A window expression holds its partition and
    order keys, the permutation chain that sorts them, its output column
    and, for a framed min or max, the sparse table's ``levels x n x 8``
    bytes (``_window_bytes``)."""
    return _estimate(plan, leaves, eager=True)


# expression nodes that materialize a tensor when evaluated eagerly
_EAGER_OPS = (BinaryOp, Case, Cast, Func, InList, IsNull, Like, Not)


def _expr_temps(e) -> int:
    """Tensors an eager evaluation of ``e`` creates (one per operator)."""
    return sum(1 for n in walk(e) if isinstance(n, _EAGER_OPS))


def _window_bytes(node: P.WindowExec, pad: int) -> int:
    """Eager device bytes of a window node over ``pad`` rows beyond its
    input: each expression's output column and its scratch. The expressions
    run one after another, but their scratch is summed: the transients of
    the sort chain and the frame gathers are bounded here, not modelled
    tensor by tensor, and the sum is what covered every window stage's
    measured peak on the H100 (PERF.md section 6)."""
    total = 0
    for e in node.window_exprs:
        wf = unalias(e)
        keys = 1 + len(wf.partition_by) + len(wf.order_by)   # row validity first
        exprs = list(wf.args) + list(wf.partition_by) + [o for o, _ in wf.order_by]
        # per stable argsort pass: the key gathered through the permutation,
        # the sorted values and indices, the composed permutation
        scratch = 32 * pad * keys + 8 * pad * sum(_expr_temps(x) for x in exprs)
        if wf.frame is not None and wf.fn in ("min", "max"):
            # the sparse table's levels, and a gather of each level's ends
            scratch += 2 * max(1, pad.bit_length()) * pad * 8
        elif wf.fn in ("sum", "avg", "count"):
            # prefix sums and counts, and the frame's two bounds
            scratch += 4 * 8 * pad
        total += scratch + 9 * pad               # + the output: data, null mask
    return total


def _estimate(plan: P.PhysicalPlan, leaves: dict, eager: bool) -> int:
    args = 0
    for (_kind, enc, extra, _ck, _node) in leaves.values():
        args += sum(int(getattr(a, "nbytes", 0) or 0) for a in enc.arrays)
        # string dictionaries: the canonical-hash LUT (8 B an entry) and
        # predicate masks (1 B an entry per LIKE / IN, folded into the same
        # allowance); the codes are counted in enc.arrays
        for meta in enc.col_meta:
            if meta[2] is not None:
                args += 9 * len(meta[2])
        if extra is not None:
            args += int(getattr(extra[0], "nbytes", 0) or 0)
    scratch = {"m": 0}
    # eager-torch bytes beyond the JAX model: held together along the chain
    held = {"b": 0}

    def note(b: int) -> None:
        scratch["m"] = max(scratch["m"], int(b))

    def hold(b: int) -> None:
        if eager:
            held["b"] += int(b)

    def w(schema: Schema) -> int:
        return row_data_bytes(schema) + 1

    def walk(node: P.PhysicalPlan) -> tuple[int, Schema]:
        info = leaves.get(id(node))
        if info is not None and info[0] != "build":
            # a node's own output, or (as the JAX package's model reads its
            # layout) a cross join's one-row right side
            enc = info[1]
            return enc.n_pad, enc.schema
        if isinstance(node, P.FilterExec):
            pad, _ = walk(node.input)
            note(2 * pad)                 # mask + compaction index
            hold(8 * pad * _expr_temps(node.predicate))
            return pad, node.schema()
        if isinstance(node, P.ProjectExec):
            pad, _ = walk(node.input)
            hold(8 * pad * sum(_expr_temps(e) for e in node.exprs))
            return pad, node.schema()     # elementwise: fuses into consumers
        if isinstance(node, P.HashAggregateExec):
            pad, _ = walk(node.input)
            bound = _agg_k_bound(node, leaves)
            k_pad = bucket_size(max(1, min(pad, bound) if bound else pad))
            # group ids / sorted keys / segment offsets + the group table
            note(4 * 8 * pad + k_pad * w(node.schema()))
            for e in list(node.group_exprs) + list(node.agg_exprs):
                a = unalias(e)
                if isinstance(a, Agg):
                    # the evaluated argument (or its scaled / widened copy)
                    # and its mask, live until the stage's one SegSums call
                    hold(pad * (8 * (_expr_temps(a.expr) + 1) + 1) if a.expr is not None
                         else pad)
                else:
                    hold(8 * pad * _expr_temps(a))
            return k_pad, node.schema()
        if isinstance(node, P.HashJoinExec):
            pad_p, _ = walk(node.left)
            info_j = leaves.get(id(node))
            benc = info_j[1] if info_j is not None else None
            pad_b = benc.n_pad if benc is not None else pad_p
            dup = max(1, int(info_j[2][1])) if info_j is not None else 1
            bw = w(node.right.schema())
            sc = 2 * 8 * pad_p            # mixed probe key + searchsorted pos
            if dup > 1 and node.how in ("inner", "left", "full"):
                # duplicate builds materialize the static expansion
                sc += pad_p * dup * bw + pad_p * (dup - 1) * w(node.left.schema())
            note(sc)
            if node.how in ("semi", "anti"):
                out_pad = pad_p
            elif node.how in ("right", "full"):
                out_pad = bucket_size(pad_p * dup + pad_b)
            else:
                out_pad = pad_p * dup
            if node is not plan:
                # an inner join's output stays live under its consumer (the
                # program's own output is counted once, below)
                hold(out_pad * w(node.schema()))
            return out_pad, node.schema()
        if isinstance(node, P.CrossJoinExec):
            pad_p, _ = walk(node.left)
            return pad_p, node.schema()
        if isinstance(node, (P.SortExec, P.WindowExec)):
            pad, _ = walk(node.input)
            note(2 * 8 * pad)             # sort keys + permutation
            if isinstance(node, P.WindowExec):
                hold(_window_bytes(node, pad))
            else:
                hold(16 * pad * len(node.keys) + pad * w(node.schema())
                     + 8 * pad * sum(_expr_temps(k) for k, _ in node.keys))
            return pad, node.schema()
        kids = node.children()
        if kids:
            return walk(kids[0])
        return 8, node.schema()

    out_pad, out_schema = walk(plan)
    output = out_pad * w(out_schema)
    return int(args + scratch["m"] + output + held["b"])


def measured_program_bytes(device, base_bytes: int, resident_bytes: int = 0) -> int:
    """The measured side of the estimate: device bytes one stage used. The
    JAX package reads XLA's accounting of the compiled program (arguments,
    outputs, temporaries); eager torch compiles no program and has no such
    accounting, so the stage itself is measured: the CUDA allocator's peak
    since the stage began (the engine resets it there) less what was
    allocated then (``base_bytes``), plus ``resident_bytes``, the stage's
    arguments that were already on the card (cached leaves), which the
    estimate counts too. 0 on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return max(0, int(torch.cuda.max_memory_allocated(dev)) - int(base_bytes)) \
        + int(resident_bytes)


def device_peak_bytes(device) -> int:
    """The CUDA allocator's high-water mark on ``device`` since its last
    reset; 0 on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(dev))
