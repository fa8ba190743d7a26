"""DistributedPlanner: split a physical plan into shuffle-bounded stages.

Reference analog: ``plan_query_stages`` / ``remove_unresolved_shuffles`` /
``rollback_resolved_shuffles`` (``arrow-ballista: ballista/scheduler/src/planner.rs``).
Pipeline breakers become stage boundaries:

* ``RepartitionExec(Hash)``      -> child stage writes hash-partitioned shuffle
* ``CoalescePartitionsExec`` /
  ``SortPreservingMergeExec``    -> child stage writes with its input
                                    partitioning (one piece per input partition)

On the TPU build a stage is the unit the JAX engine compiles; co-scheduled
producer/consumer stages on one mesh can later fuse the exchange into an ICI
``all_to_all`` (survey §7 step 6) — the stage structure here is what makes that
fusion addressable.
"""
from __future__ import annotations

import copy
from typing import Any

from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan import physical as P


def promote_ici_exchanges(
    plan: P.PhysicalPlan, ici_devices: int, ici_max_rows: int = 0,
    hbm_budget_bytes: int = 0,
) -> tuple[P.PhysicalPlan, int]:
    """Collapse hash exchanges onto the ICI tier: eligible ``RepartitionExec``
    nodes become inline :class:`IciExchangeExec` boundaries that the engine
    compiles into the stage program as a mesh collective (one fat executor =
    one TPU host's mesh) instead of a ShuffleWriter/Reader Flight hop.

    Eligibility mirrors the engine's fused shapes exactly — promoting an
    exchange the engine cannot fuse would only round-trip through a runtime
    demotion:

    * ``final-agg(Repartition(partial-agg))`` with device-expressible
      aggregate bodies (the shuffle-bounded aggregate), and
    * partitioned ``HashJoin(Repartition(L), Repartition(R))`` for
      inner/left/semi/anti equi-joins (the q5-class shuffle join),

    in both cases only when the exchange input is STAGE-LOCAL (no nested
    exchange/shuffle below: the collective program materializes its whole
    input on one host), the estimated rows fit ``ici_max_rows`` (0 = no
    plan-time cap; the engine's runtime input cap still applies and demotes),
    and — with ``hbm_budget_bytes`` > 0 — the memory model's per-device
    exchange footprint fits the fat executor's HBM budget (docs/memory.md):
    declining here reports a named ``ICI_DEMOTE[plan]: hbm_budget`` reason at
    plan time instead of a runtime OOM inside the collective program.

    Returns ``(plan, n_promoted)``; exchange ids are job-unique and count up
    from 1 — the demotion path keys on them.
    """
    if ici_devices < 2:
        return plan, 0
    # deferred: the engine module is heavy and only needed when promoting
    from ballista_tpu_torch.engine.torch_engine import _supported

    counter = {"n": 0}

    def static_input(rep: P.RepartitionExec) -> bool:
        return not any(
            isinstance(
                n,
                (P.RepartitionExec, P.UnresolvedShuffleExec, P.ShuffleReaderExec,
                 P.CoalescePartitionsExec, P.SortPreservingMergeExec),
            )
            for n in P.walk_physical(rep.input)
        )

    def fits(*reps: P.RepartitionExec) -> bool:
        """A join promotes BOTH exchanges into one fused program whose
        collective holds both sides HBM-resident at once, so the budget
        check sums the pair — mirroring the engine's ``_try_fused_join``;
        checking sides separately would promote collectives guaranteed to
        demote at trace time."""
        if ici_max_rows > 0 and any(r.est_rows > ici_max_rows for r in reps):
            return False
        if hbm_budget_bytes > 0:
            from ballista_tpu_torch.engine.memory_model import (
                estimate_ici_exchange_bytes, fmt_bytes,
            )

            est = sum(
                estimate_ici_exchange_bytes(r.schema(), r.est_rows, ici_devices)
                for r in reps if r.est_rows
            )
            if est > hbm_budget_bytes:
                import logging

                logging.getLogger("ballista.scheduler").info(
                    "ICI_DEMOTE[plan]: hbm_budget — exchange estimated "
                    "%s/device over the %s budget; kept on the Flight tier "
                    "(%s)",
                    fmt_bytes(est), fmt_bytes(hbm_budget_bytes),
                    " + ".join(r._line() for r in reps),
                )
                return False
        return True

    def mk(rep: P.RepartitionExec) -> P.IciExchangeExec:
        counter["n"] += 1
        return P.IciExchangeExec(rep.input, rep.partitioning, rep.est_rows, counter["n"])

    def walk(node: P.PhysicalPlan) -> P.PhysicalPlan:
        kids = [walk(c) for c in node.children()]
        if kids:
            node = node.with_children(*kids)
        # exact type checks: an already-promoted IciExchangeExec (or a nested
        # collective below) must not promote again — one collective boundary
        # per stage region is what the engine's fused programs express
        if (
            isinstance(node, P.HashAggregateExec)
            and node.mode == "final"
            and type(node.input) is P.RepartitionExec
            and isinstance(node.input.input, P.HashAggregateExec)
            and node.input.input.mode == "partial"
            and _supported(node.input.input)
            and static_input(node.input)
            and fits(node.input)
        ):
            return node.with_children(mk(node.input))
        if (
            isinstance(node, P.HashJoinExec)
            and not node.collect_build
            and node.on
            and node.how in ("inner", "left", "semi", "anti")
            and type(node.left) is P.RepartitionExec
            and type(node.right) is P.RepartitionExec
            and not node.paged
            and _supported(node)
            and static_input(node.left)
            and static_input(node.right)
            and fits(node.left, node.right)
        ):
            return node.with_children(mk(node.left), mk(node.right))
        return node

    return walk(plan), counter["n"]


def promote_megastage(
    plan: P.PhysicalPlan, ici_devices: int, ici_max_rows: int = 0,
    hbm_budget_bytes: int = 0, max_boundaries: int = 4,
) -> tuple[P.PhysicalPlan, int]:
    """Megastage compiler (docs/megastage.md): when EVERY exchange on a
    chain is ICI-eligible, collapse the whole chain into one stage whose
    program the engine compiles as a single mesh computation — runs AFTER
    :func:`promote_ici_exchanges`, which it relies on for the per-exchange
    vetting (a join whose both sides are already ``IciExchangeExec`` passed
    the static-input, shape-support and pairwise HBM checks there).

    The recognized chain is the q3 class::

        final-agg(Repartition(partial-agg(Filter/Project*(
            HashJoin(IciExchange(L), IciExchange(R))))))

    ``promote_ici_exchanges`` alone leaves the aggregate's Repartition on
    the Flight tier — its ``static_input`` check rejects any nested
    exchange, which the promoted join necessarily contains.  This pass
    closes that gap: the aggregate exchange promotes too (continuing the
    job-unique id sequence) and the final aggregate is wrapped in a
    :class:`MegastageExec` boundary, so the stage splitter produces ONE
    stage for the whole chain and the engine traces it as one program with
    inline ``all_to_all`` at every former boundary.

    Admission is priced with ``estimate_megastage_bytes`` — the running MAX
    over fused segments, not the sum, because ``donate_argnums`` frees the
    join segment's exchange buffers before the aggregate exchange
    allocates.  Any ineligible node, over-cap estimate, or boundary count
    beyond ``max_boundaries`` leaves the plan untouched: the per-stage
    split (with whatever single exchanges ``promote_ici_exchanges`` already
    promoted) is byte-identical to the no-megastage behavior.

    Returns ``(plan, n_promoted)``.
    """
    if ici_devices < 2:
        return plan, 0
    # deferred: the engine module is heavy and only needed when promoting
    from ballista_tpu_torch.engine.torch_engine import _supported

    # ids stay job-unique: continue above what promote_ici_exchanges assigned
    next_id = 1 + max(
        (n.exchange_id for n in P.walk_physical(plan)
         if isinstance(n, P.IciExchangeExec)),
        default=0,
    )
    counter = {"n": 0, "next": next_id}

    def chain_join(node: P.PhysicalPlan):
        """Descend the partition-preserving Filter/Project chain between the
        partial aggregate and an already-promoted join; None when anything
        else (or an unpromoted join) sits in between."""
        while isinstance(node, (P.FilterExec, P.ProjectExec)):
            if not _supported(node):
                return None
            node = node.input
        if (
            isinstance(node, P.HashJoinExec)
            and type(node.left) is P.IciExchangeExec
            and type(node.right) is P.IciExchangeExec
        ):
            return node
        return None

    def fits(join: P.HashJoinExec, rep: P.RepartitionExec) -> bool:
        if ici_max_rows > 0 and rep.est_rows > ici_max_rows:
            return False
        if hbm_budget_bytes > 0:
            from ballista_tpu_torch.engine.memory_model import (
                estimate_megastage_bytes, fmt_bytes,
            )

            segments = [
                [(r.schema(), r.est_rows) for r in (join.left, join.right)
                 if r.est_rows],
                [(rep.schema(), rep.est_rows)] if rep.est_rows else [],
            ]
            est = estimate_megastage_bytes(segments, ici_devices)
            if est > hbm_budget_bytes:
                import logging

                logging.getLogger("ballista.scheduler").info(
                    "MEGASTAGE[plan]: hbm_budget — widest fused segment "
                    "estimated %s/device over the %s budget; kept on the "
                    "per-stage split",
                    fmt_bytes(est), fmt_bytes(hbm_budget_bytes),
                )
                return False
        return True

    def walk(node: P.PhysicalPlan) -> P.PhysicalPlan:
        kids = [walk(c) for c in node.children()]
        if kids:
            node = node.with_children(*kids)
        if not (
            isinstance(node, P.HashAggregateExec)
            and node.mode == "final"
            and type(node.input) is P.RepartitionExec
            and isinstance(node.input.input, P.HashAggregateExec)
            and node.input.input.mode == "partial"
        ):
            return node
        rep = node.input
        partial = rep.input
        if not _supported(partial):
            return node
        join = chain_join(partial.input)
        if join is None:
            return node
        # the fused program materializes its whole input on one host: the
        # join's two inline exchanges must be the ONLY exchange/shuffle
        # nodes below the aggregate boundary (their inputs are stage-local
        # by promote_ici_exchanges' static_input construction)
        inner = [
            n for n in P.walk_physical(partial)
            if isinstance(
                n,
                (P.RepartitionExec, P.UnresolvedShuffleExec,
                 P.ShuffleReaderExec, P.CoalescePartitionsExec,
                 P.SortPreservingMergeExec),
            )
        ]
        if {id(n) for n in inner} != {id(join.left), id(join.right)}:
            return node
        if max_boundaries > 0 and len(inner) + 1 > max_boundaries:
            return node
        if not fits(join, rep):
            return node
        ex = P.IciExchangeExec(
            rep.input, rep.partitioning, rep.est_rows, counter["next"],
        )
        counter["next"] += 1
        counter["n"] += 1
        return P.MegastageExec(node.with_children(ex))

    return walk(plan), counter["n"]


def plan_query_stages(
    job_id: str, plan: P.PhysicalPlan, fuse_exchange_max_rows: int = 0,
    reuse_exchanges: bool = False,
) -> list[P.ShuffleWriterExec]:
    """Returns stages in creation (bottom-up) order; last stage is the root.

    ``fuse_exchange_max_rows`` > 0 enables exchange co-scheduling: a hash
    exchange whose estimated input is at most that many rows is NOT split into
    a shuffle boundary — the Repartition stays inline, so the whole producer/
    consumer pair lands on one fat executor where the engine runs it as a
    fused device-resident all_to_all (survey §7 step 6's "stage group
    resolved atomically", realized by not creating the boundary at all).

    ``reuse_exchanges`` dedupes IDENTICAL hash-exchange subtrees (same serde
    bytes for input + partitioning — which includes dict refs) inside one
    plan at stage-split time: the subtree executes ONCE and every consumer
    reads the same materialized pieces (docs/adaptive.md). The dedupe key is
    the serialized form, so it cascades — inner boundaries dedupe first,
    making identical outer subtrees byte-identical too. Subtrees the serde
    cannot encode (e.g. in-memory test scans) are never deduped."""
    stages: list[P.ShuffleWriterExec] = []
    counter = {"next": 1}
    reuse_memo: dict[str, P.UnresolvedShuffleExec] = {}

    def new_stage(child: P.PhysicalPlan, partitioning) -> P.ShuffleWriterExec:
        sid = counter["next"]
        counter["next"] += 1
        # static shared-dictionary propagation (docs/strings.md): annotate
        # the boundary so the writer can move codes on the wire and the
        # compile-hint service can trace the consumer's string stages
        from ballista_tpu_torch.engine.dictionaries import propagate_dict_refs

        refs = propagate_dict_refs(child) or None
        stage = P.ShuffleWriterExec(job_id, sid, child, partitioning, refs)
        stages.append(stage)
        return stage

    def reuse_key(node: P.RepartitionExec):
        if not reuse_exchanges:
            return None
        import json

        from ballista_tpu_torch.plan.serde import expr_to_json, physical_to_json

        try:
            return json.dumps(
                {
                    "in": physical_to_json(node.input),
                    "exprs": [expr_to_json(e) for e in node.partitioning.exprs],
                    "n": node.partitioning.n,
                },
                sort_keys=True,
            )
        except Exception:  # noqa: BLE001 - unserializable subtree: no dedupe
            return None

    def walk(node: P.PhysicalPlan) -> P.PhysicalPlan:
        kids = [walk(c) for c in node.children()]
        if kids:
            node = node.with_children(*kids)
        if isinstance(node, P.IciExchangeExec):
            # ICI tier: the boundary is collapsed — the exchange compiles
            # into the parent stage's program as a mesh collective; a runtime
            # demotion re-splits it onto the Flight tier
            return node
        if isinstance(node, P.RepartitionExec):
            if (
                fuse_exchange_max_rows
                and node.est_rows
                and node.est_rows <= fuse_exchange_max_rows
                and not any(
                    isinstance(n, P.UnresolvedShuffleExec) for n in P.walk_physical(node)
                )
            ):
                return node  # co-scheduled: stays inline in the parent stage
            key = reuse_key(node)
            if key is not None and key in reuse_memo:
                prev = reuse_memo[key]
                # fresh leaf object per consumer (no shared mutable nodes),
                # pointing at the ALREADY-CREATED producer stage
                return P.UnresolvedShuffleExec(
                    prev.stage_id, node.schema(), prev.n_partitions,
                    prev.dict_refs,
                )
            stage = new_stage(node.input, node.partitioning)
            leaf = P.UnresolvedShuffleExec(
                stage.stage_id, node.schema(), stage.output_partitions(),
                stage.dict_refs,
            )
            if key is not None:
                reuse_memo[key] = leaf
            return leaf
        if isinstance(node, (P.CoalescePartitionsExec, P.SortPreservingMergeExec)):
            stage = new_stage(node.input, None)
            reader = P.UnresolvedShuffleExec(
                stage.stage_id, node.input.schema(), stage.output_partitions(),
                stage.dict_refs,
            )
            return node.with_children(reader)
        return node

    root = walk(plan)
    new_stage(root, None)
    return stages


def stage_dependencies(stage_plan: P.PhysicalPlan) -> list[int]:
    """Child stage ids this stage reads (UnresolvedShuffleExec leaves)."""
    return [
        n.stage_id
        for n in P.walk_physical(stage_plan)
        if isinstance(n, P.UnresolvedShuffleExec)
    ]


def remove_unresolved_shuffles(
    plan: P.PhysicalPlan, locations: dict[int, list[list[dict[str, Any]]]]
) -> P.PhysicalPlan:
    """Resolve UnresolvedShuffleExec leaves into ShuffleReaderExec with concrete
    partition locations (reference: planner.rs:205-255)."""
    if isinstance(plan, P.UnresolvedShuffleExec):
        if plan.stage_id not in locations:
            raise PlanningError(f"no locations for input stage {plan.stage_id}")
        # copy per LEAF: reuse-deduped plans resolve one producer into two
        # readers, which must not share mutable piece lists
        return P.ShuffleReaderExec(plan.stage_id, plan.out_schema,
                                   [list(pieces) for pieces in locations[plan.stage_id]],
                                   plan.dict_refs)
    kids = [remove_unresolved_shuffles(c, locations) for c in plan.children()]
    return plan.with_children(*kids) if kids else plan


def rollback_resolved_shuffles(plan: P.PhysicalPlan) -> P.PhysicalPlan:
    """Inverse of resolution, for fetch-failure rollback (planner.rs:260-283)."""
    if isinstance(plan, P.ShuffleReaderExec):
        return P.UnresolvedShuffleExec(plan.stage_id, plan.out_schema,
                                       plan.output_partitions(), plan.dict_refs)
    kids = [rollback_resolved_shuffles(c) for c in plan.children()]
    return plan.with_children(*kids) if kids else plan


def _shuffle_actual_rows(node: P.PhysicalPlan) -> Any:
    """Exact row count of a resolved shuffle input, or None when the node is
    not a direct shuffle read (stats of derived subtrees are unknown)."""
    if not isinstance(node, P.ShuffleReaderExec):
        return None
    total = 0
    for locs in node.partition_locations:
        for piece in locs:
            total += int(piece.get("num_rows", 0) or 0)
    return total


def adaptive_join_reopt(
    plan: P.PhysicalPlan, broadcast_rows_threshold: int
) -> P.PhysicalPlan:
    """Resolution-time join re-optimization with EXACT input statistics.

    Reference: ``UnresolvedStage::to_resolved`` re-runs the JoinSelection +
    AggregateStatistics physical optimizers with fresh runtime statistics
    (``execution_stage.rs:341-368``). Here, once shuffle locations are spliced
    in, every exchange input's true row count is known from the producers'
    ``ShuffleWriteStats`` — so a partitioned hash join whose build side was
    mis-estimated at plan time can be corrected:

    * **broadcast flip** — if the build side's actual rows fit the broadcast
      threshold, set ``collect_build``: each probe task reads the whole (small)
      build instead of one partition slice. Correct for inner/left/semi/anti —
      probe rows stay partitioned, so matches are emitted exactly once.
    * **build-side swap** — for inner joins where the probe side turned out
      much smaller than the build side, swap so the smaller side builds (the
      device join sorts + statically expands the build; smaller builds keep it
      on device). A projection restores the original column order.
    """
    if isinstance(plan, P.HashJoinExec) and not plan.collect_build and plan.on:
        left = adaptive_join_reopt(plan.left, broadcast_rows_threshold)
        right = adaptive_join_reopt(plan.right, broadcast_rows_threshold)
        node = plan if (left is plan.left and right is plan.right) else (
            plan.with_children(left, right)
        )
        l_rows = _shuffle_actual_rows(left)
        r_rows = _shuffle_actual_rows(right)
        broadcast_ok = node.how in ("inner", "left", "semi", "anti")
        if (
            node.how == "inner"
            and l_rows is not None
            and r_rows is not None
            and r_rows > 2 * l_rows
            and len({f.name for f in node.schema()}) == len(node.schema())
        ):
            # smaller side should build: swap, then restore column order
            from ballista_tpu_torch.plan.expr import Col

            out_names = [f.name for f in node.schema()]
            # the swap stays a partitioned join: the governor's paged verdict
            # rides along (dropping it would re-expose the one-shot OOM PV007
            # admission claimed to have mitigated)
            swapped = P.HashJoinExec(
                right, left, "inner",
                [(r, l) for l, r in node.on], node.filter, paged=node.paged,
            )
            if l_rows <= broadcast_rows_threshold and not node.paged:
                # broadcast joins have no paged tier (every intercept
                # requires not collect_build), and a paged verdict can be
                # probe- or partition-cap-driven — a small measured build
                # does not void it, so paged joins stay partitioned
                swapped = P.HashJoinExec(
                    swapped.left, swapped.right, "inner", swapped.on,
                    swapped.filter, collect_build=True,
                )
            return P.ProjectExec(swapped, [Col(n) for n in out_names])
        if (
            broadcast_ok
            and not node.paged  # see the swap branch: broadcast can't page
            and r_rows is not None
            and r_rows <= broadcast_rows_threshold
        ):
            return P.HashJoinExec(
                node.left, node.right, node.how, node.on, node.filter,
                collect_build=True,
            )
        return node
    kids = plan.children()
    new = [adaptive_join_reopt(c, broadcast_rows_threshold) for c in kids]
    if all(a is b for a, b in zip(kids, new)):
        return plan
    return plan.with_children(*new)


# ---- adaptive execution at shuffle boundaries (docs/adaptive.md) ------------------
def _piece_bytes(locs) -> int:
    return sum(int(loc.get("num_bytes", 0) or 0) for loc in locs)


def _piece_rows(locs) -> int:
    return sum(int(loc.get("num_rows", 0) or 0) for loc in locs)


def _reader_chain(node: P.PhysicalPlan):
    """Descend a strictly partition-preserving chain (Filter/Project) to a
    shuffle reader; None when anything else sits in between."""
    while isinstance(node, (P.FilterExec, P.ProjectExec)):
        node = node.input
    return node if isinstance(node, P.ShuffleReaderExec) else None


def _estimate_range_bytes(plan: P.PhysicalPlan, readers, rows) -> int:
    """Memory-model estimate of one post-coalesce task's stage program,
    from the MEASURED rows a candidate partition range feeds each reader
    (docs/memory.md): the join/aggregate estimators when the stage shape is
    recognizable, a padded input+output envelope otherwise. This is how the
    governor's verdict survives AQE — coalescing can never merge a task past
    the device budget the admission solve planned for."""
    from ballista_tpu_torch.engine.memory_model import (
        estimate_agg_program, estimate_join_program, padded_batch_bytes,
    )

    by_id = {id(r): n for r, n in zip(readers, rows)}
    for n in P.walk_physical(plan):
        if isinstance(n, P.HashJoinExec) and n.on and not n.collect_build:
            pr, br = _reader_chain(n.left), _reader_chain(n.right)
            if pr is not None and br is not None:
                return estimate_join_program(
                    pr.schema(), by_id.get(id(pr), 0),
                    br.schema(), by_id.get(id(br), 0), n.how,
                )
        if isinstance(n, P.HashAggregateExec) and n.mode in ("final", "merge"):
            rd = _reader_chain(n.input)
            if rd is not None:
                return estimate_agg_program(
                    rd.schema(), by_id.get(id(rd), 0), n.schema(),
                )
    # generic envelope: padded inputs + one materialized output of like size
    return sum(2 * padded_batch_bytes(r.schema(), n) for r, n in zip(readers, rows))


def _skew_join(plan: P.PhysicalPlan):
    """The single partitioned hash join this stage may skew-split, as
    (probe_reader, build_reader), or None. Exactness requires every probe
    row to be processed once against the FULL matching build partition and
    each task's output to union downstream:

    * join how must be inner/left/semi/anti (probe rows each emit exactly
      once; right/full would re-emit unmatched BUILD rows per slice);
    * join -> reader chains may pass only Filter/Project (partition-
      preserving, stateless);
    * above the join only Filter/Project/partial-aggregate/Sort are allowed
      — a final/single aggregate or window over a SPLIT partition would see
      one key's rows in two tasks and emit duplicate groups;
    * the join's two readers must be the plan's ONLY shuffle leaves.
    """
    node = plan
    while True:
        if isinstance(node, (P.FilterExec, P.ProjectExec, P.SortExec)):
            node = node.input
        elif isinstance(node, P.HashAggregateExec) and node.mode == "partial":
            node = node.input
        else:
            break
    if not (
        isinstance(node, P.HashJoinExec)
        and node.on
        and not node.collect_build
        and not node.paged
        and node.how in ("inner", "left", "semi", "anti")
    ):
        return None
    probe = _reader_chain(node.left)
    build = _reader_chain(node.right)
    if probe is None or build is None or probe is build:
        return None
    readers = [n for n in P.walk_physical(plan) if isinstance(n, P.ShuffleReaderExec)]
    if {id(n) for n in readers} != {id(probe), id(build)}:
        return None
    return probe, build


def _split_pieces(pieces: list, n_slices: int) -> list[list]:
    """Contiguous piece groups balanced by bytes (greedy fill toward the
    per-slice mean; never more slices than pieces)."""
    n_slices = max(1, min(n_slices, len(pieces)))
    total = max(1, _piece_bytes(pieces))
    target = total / n_slices
    groups: list[list] = [[]]
    acc = 0
    for piece in pieces:
        b = int(piece.get("num_bytes", 0) or 0)
        if groups[-1] and acc + b > target * len(groups) and len(groups) < n_slices:
            groups.append([])
        groups[-1].append(piece)
        acc += b
    return groups


def apply_aqe(
    plan: P.PhysicalPlan,
    target_partition_bytes: int,
    skew_factor: float,
    hbm_budget_bytes: int = 0,
) -> tuple[P.PhysicalPlan, dict]:
    """Runtime re-optimization of a RESOLVED stage body from the MEASURED
    shuffle piece sizes its readers carry (docs/adaptive.md). Two rewrites,
    both pure re-groupings of the reader leaves — the operator tree above is
    untouched, so the stage's compiled-program identity is stable:

    * **partition coalescing** — adjacent tiny reduce partitions merge until
      one task reads ~``target_partition_bytes`` (summed across co-
      partitioned readers so join sides merge in lockstep), bounded by the
      HBM budget via the memory model. Whole planned partitions move
      together, so key co-location — what every hash exchange guarantees —
      is preserved for aggregates, joins and windows alike.
    * **skew-join splitting** — a probe partition whose measured bytes
      exceed ``skew_factor x median`` splits across N tasks that each read
      a contiguous slice of the probe pieces and ALL of the matching build
      partition, exact for inner/left/semi/anti (see :func:`_skew_join`).

    Identity-preserving like ``govern_plan``: returns the plan object
    UNCHANGED (``is``-identical) with an empty decisions dict when nothing
    fires, so the AQE-off path is byte-for-byte the static planner output.
    """
    readers = [n for n in P.walk_physical(plan) if isinstance(n, P.ShuffleReaderExec)]
    if not readers:
        return plan, {}
    n = readers[0].output_partitions()
    if (
        n < 2
        or any(r.output_partitions() != n for r in readers)
        or any(r.partition_ranges is not None for r in readers)
        or plan.output_partitions() != n
        or any(
            isinstance(x, P.LimitExec) and not x.global_
            for x in P.walk_physical(plan)
        )
    ):
        # not a positionally reader-driven stage (single-partition merge,
        # mixed exchange widths, already adapted) — or a local limit, whose
        # kept ROWS depend on partition boundaries (byte-identity contract)
        return plan, {}

    decisions: dict = {}
    # entries[i] = (range, [pieces per reader]) over the planned domain
    entries: list[tuple[tuple[int, int], list[list]]] = [
        ((j, j + 1), [list(r.partition_locations[j]) for r in readers])
        for j in range(n)
    ]
    # the skew baseline is the PLANNED partition-size distribution — after
    # coalescing, the few merged entries would make the median meaningless
    # (with one hot + one merged-tail entry, the "median" IS the hot one)
    planned_sizes = [
        [_piece_bytes(pl) for pl in locs] for _, locs in entries
    ]

    # -- coalesce: greedy adjacent merge up to target + budget -------------------
    if target_partition_bytes > 0:
        merged: list[tuple[tuple[int, int], list[list]]] = []
        for (s, e), locs in entries:
            size = sum(_piece_bytes(pl) for pl in locs)
            if merged:
                (ps, pe), plocs = merged[-1]
                cand = [a + b for a, b in zip(plocs, locs)]
                cand_bytes = sum(_piece_bytes(pl) for pl in cand)
                fits = cand_bytes <= target_partition_bytes
                if fits and hbm_budget_bytes > 0:
                    fits = (
                        _estimate_range_bytes(
                            plan, readers, [_piece_rows(pl) for pl in cand]
                        )
                        <= hbm_budget_bytes
                    )
                if fits:
                    merged[-1] = ((ps, e), cand)
                    continue
            merged.append(((s, e), locs))
        if len(merged) < len(entries):
            decisions["coalesced_from"] = len(entries)
            decisions["coalesced_to"] = len(merged)
            entries = merged

    # -- skew split: oversized probe partitions fan out across slices ------------
    if skew_factor > 0:
        pair = _skew_join(plan)
        if pair is not None:
            probe, build = pair
            p_idx = next(i for i, r in enumerate(readers) if r is probe)
            sizes = sorted(ps[p_idx] for ps in planned_sizes)
            median = sizes[len(sizes) // 2]
            threshold = max(
                skew_factor * median, float(target_partition_bytes or 0)
            )
            slice_target = (
                target_partition_bytes if target_partition_bytes > 0
                else max(1, median)
            )
            split_entries = []
            splits = 0
            for (s, e), locs in entries:
                pb = _piece_bytes(locs[p_idx])
                want = -(-pb // max(1, slice_target))  # ceil
                if (
                    median > 0
                    and pb > threshold
                    and want >= 2
                    and len(locs[p_idx]) >= 2
                ):
                    groups = _split_pieces(locs[p_idx], want)
                    if len(groups) >= 2:
                        splits += 1
                        for grp in groups:
                            sliced = [
                                grp if i == p_idx else list(pl)
                                for i, pl in enumerate(locs)
                            ]
                            split_entries.append(((s, e), sliced))
                        continue
                split_entries.append(((s, e), locs))
            if splits:
                decisions["skew_splits"] = splits
                decisions["skew_extra_tasks"] = len(split_entries) - len(entries)
                entries = split_entries

    if not decisions:
        return plan, {}

    ranges = [rng for rng, _ in entries]
    # coverage self-check: the adapted ranges must serve EVERY planned
    # partition exactly once (contiguous from 0 through n, skew repeats
    # aside). PV005's node-local check cannot see the planned width, so a
    # regression here is caught where the width IS known — by refusing to
    # adapt rather than silently dropping trailing partitions.
    ok = bool(ranges) and ranges[0][0] == 0 and ranges[-1][1] == n
    for (ps, pe), (s, e) in zip(ranges, ranges[1:]):
        if (s, e) != (ps, pe) and s != pe:
            ok = False
    if not ok:
        import logging

        logging.getLogger("ballista.scheduler").error(
            "AQE produced inconsistent partition ranges %s for %d planned "
            "partitions; keeping the static plan", ranges, n,
        )
        return plan, {}
    new_locs = {
        id(r): [locs[i] for _, locs in entries] for i, r in enumerate(readers)
    }

    def rewrite(node: P.PhysicalPlan) -> P.PhysicalPlan:
        if isinstance(node, P.ShuffleReaderExec):
            return P.ShuffleReaderExec(
                node.stage_id, node.out_schema, new_locs[id(node)],
                node.dict_refs, list(ranges),
            )
        kids = [rewrite(c) for c in node.children()]
        return node.with_children(*kids) if kids else node

    return rewrite(plan), decisions
