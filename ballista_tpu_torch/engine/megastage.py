"""Megastage: a whole eligible query chain as one mesh program (the port of
``ballista_tpu/engine/megastage.py``).

The fused-exchange module (``engine/fused_exchange.py``) runs one boundary at
a time: a fused aggregate or a fused join, each its own program with its own
dispatch, host hop and scheduler round trip. A megastage (the scheduler's
``MegastageExec``) chains both bodies in one ``shard_map`` program::

    per shard: its scan shards -> join-key all_to_all (both sides)
            -> searchsorted probe -> partial aggregate over its matches
            -> group-hash all_to_all of the partial states
            -> final merge on the owning shard

so every former stage boundary is an inline collective and nothing returns
to the host between them. Where the JAX program donates its inputs, eager
torch cannot: the program's inputs come fresh from the host for every run
(never from the device cache, as the JAX package's donated inputs do). Each
shard copies its inputs to its device on its own stream, and drops them and
the join's exchanged rows as soon as the segment that reads them has run,
before the aggregate's exchange allocates: the caching allocator hands
those blocks only to later work of that stream, so the release is safe
while the shard's kernels are still queued and the shard's later segments
reuse the bytes. Those bytes are ``op.Megastage.donated_bytes``. The JAX
package's background compile of a generalized program has no counterpart:
eager torch compiles nothing. Every decline (shape, skew overflow, budget, faults)
returns None and the caller demotes the whole chain to the per-stage split.
"""
from __future__ import annotations

import logging
from typing import Optional

from ballista_tpu_torch.engine import fused_exchange as FX
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.parallel import split_rows
from ballista_tpu_torch.plan import physical as P

log = logging.getLogger("ballista.engine")


def megastage_parts(ms: P.MegastageExec):
    """Destructure a promoted megastage into ``(final_plan, agg_ex,
    partial_plan, join_plan)``; None when the tree is not the promoted
    q3-class chain (plans travel through serde and AQE)."""
    final_plan = ms.input
    if not (isinstance(final_plan, P.HashAggregateExec) and final_plan.mode == "final"):
        return None
    agg_ex = final_plan.input
    if type(agg_ex) is not P.IciExchangeExec:
        return None
    partial_plan = agg_ex.input
    if not (isinstance(partial_plan, P.HashAggregateExec) and partial_plan.mode == "partial"):
        return None
    node = partial_plan.input
    while isinstance(node, (P.FilterExec, P.ProjectExec)):
        node = node.input
    if not (isinstance(node, P.HashJoinExec)
            and type(node.left) is P.IciExchangeExec
            and type(node.right) is P.IciExchangeExec
            and node.on
            and node.how in ("inner", "left", "semi", "anti")):
        return None
    return final_plan, agg_ex, partial_plan, node


def run_megastage(engine, ms: P.MegastageExec, n_dev: int) -> Optional[list[ColumnBatch]]:
    """A promoted megastage as one mesh program: one batch per output
    partition (all rows in partition 0, the fused path's convention), or
    None when a gate declines; the caller then demotes the chain."""
    from ballista_tpu_torch.parallel.mesh import build_mesh

    parts = megastage_parts(ms)
    if parts is None:
        return None
    final_plan, agg_ex, partial_plan, join_plan = parts
    lrep = join_plan.left
    mesh = build_mesh(n_dev, engine.device)
    # inputs: the host encodings are cached, the device copies never are
    try:
        lenc, _ = FX.fused_input(engine, lrep.input, mesh, device_ok=False)
    except FX._EmptyInput:
        return None
    renc = FX.build_side_encoding(engine, join_plan, n_dev)
    if not renc.build_unique:
        return None

    # the budget again over the real encodings: the planner admitted the
    # chain from row estimates
    budget = engine._hbm_budget()
    if budget > 0:
        est = MM.estimate_megastage_bytes(
            [[(lenc.schema, lenc.n_rows), (renc.schema, renc.n_rows)],
             [(agg_ex.schema(), agg_ex.est_rows or lenc.n_rows)]], n_dev)
        if est > budget:
            log.info("megastage declined at trace time: widest segment %s/device over the "
                     "%s budget", MM.fmt_bytes(est), MM.fmt_bytes(budget))
            return None

    n_boundaries = sum(isinstance(n, P.IciExchangeExec) for n in P.walk_physical(ms))
    holders = [{} for _ in mesh]
    fns = [make_megastage_dev_fn(final_plan, partial_plan, join_plan, lenc, renc, n_dev, h)
           for h in holders]
    largs = split_rows(lenc.arrays, n_dev)
    rargs = split_rows(renc.arrays, n_dev)
    # each shard copies its host arrays to its device itself (on its own
    # stream), so that it may free them early
    engine._metric("op.DeviceTransfer.bytes",
                   float(sum(a.nbytes for a in lenc.arrays + renc.arrays)))

    def estimate(i):
        per_l = lenc.n_pad // n_dev
        return (sum(a.nbytes for a in largs[i] + rargs[i])
                + FX._join_bytes(lenc, renc, n_dev, join_plan.right.schema())
                + MM.estimate_eager_program_bytes(partial_plan,
                                                  FX._rows_leaf(join_plan, n_dev * per_l))
                + FX._agg_tail_bytes(final_plan, partial_plan, holders[i]["partial_pad"], n_dev))

    shard_args = [(la + ra, dev) for la, ra, dev in zip(largs, rargs, mesh)]
    out, dt = FX._run_mesh(engine, fns, shard_args, mesh, lenc.n_rows + renc.n_rows, estimate)
    result = FX._finish_fused(engine, holders[0], out, ms.output_partitions())
    # only a completed program counts toward the collective's metrics
    FX._note_ici_metrics(engine, result is not None, holders[0], dt)
    if result is not None:
        engine._metric("op.Megastage.count", 1.0)
        engine._metric("op.Megastage.boundaries", float(n_boundaries))
        engine._metric("op.Megastage.donated_bytes",
                        float(sum(h["released_bytes"] for h in holders)))
        # one scheduler round trip (the aggregate exchange's stage) fewer a
        # run than the per-stage split
        engine._metric("op.Megastage.dispatches_avoided", 1.0)
    return result


def make_megastage_dev_fn(final_plan: P.HashAggregateExec, partial_plan: P.HashAggregateExec,
                          join_plan: P.HashJoinExec, lenc: KT.EncodedBatch,
                          renc: KT.EncodedBatch, n_dev: int, holder: dict):
    """The per-shard body of the whole chain: the fused join's body feeds
    the partial aggregate (the Filter/Project chain between them runs
    through), then the fused aggregate's exchange and merge run on its
    output: three inline collectives, no host hop. Once the join's probe
    and build have run, the shard drops its inputs and the build side's
    exchanged rows, and once the partial aggregate has run, the join's
    output; their bytes are ``holder["released_bytes"]``. The last output
    is the join's mesh-wide unfusable count. ``dev_fn(host_arrays,
    device)`` copies the shard's host arrays to ``device`` on the running
    stream: what that stream allocates, only its later work reuses once it
    is freed."""
    body = FX.make_join_body(join_plan, lenc, renc, n_dev, holder)
    nl = len(lenc.arrays)

    def dev_fn(host_arrays: list, device):
        inputs = [KT.host_to_device(a, device) for a in host_arrays]
        ldb = KT.device_batch_from_encoded(lenc, inputs[:nl])
        rdb = KT.device_batch_from_encoded(renc, inputs[nl:])
        join_db, bad = body(ldb, rdb)
        released = FX._nbytes(inputs)
        del ldb, rdb, inputs
        partial_out = TE._trace_agg(partial_plan, {id(join_plan): ("out", join_db, None)})
        released += FX._nbytes({c.data.data_ptr(): c.data for c in join_db.cols}.values())
        del join_db
        holder["partial_pad"] = partial_out.n_pad
        holder["released_bytes"] = released
        final_out = FX.exchange_agg_states(final_plan, partial_plan, partial_out, n_dev, holder)
        arrays_out, meta = KT.flatten_device_batch(final_out)
        holder["meta"] = meta
        return tuple(arrays_out) + (bad,)

    return dev_fn
