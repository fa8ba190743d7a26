"""Fused device-resident exchanges (the port of
``ballista_tpu/engine/fused_exchange.py``).

When a producer stage (a partial aggregate) and its consumer (the final
aggregate) share the engine's mesh, the materialized shuffle between them
disappears: the pair runs as one program over the mesh's shards
(``parallel.shard_map``) whose exchange is a collective,

    per shard: the partial aggregate over its share of the input
            -> partial states bucketed by group hash -> all_to_all
            -> the final merge on the owning shard

and a partitioned join over two exchanges runs the same way, both sides
exchanged on the join-key hash. Bucketing reads dictionary codes and
canonical values that are the same on every shard (one shared encoding).
The shards' outputs concatenate in shard order, as the JAX program's
``P(axis)`` outputs do.

The fused input (everything below the partial aggregate, or below each side
of the join) is materialized once, padded to equal power-of-two shards, and
built on the device where its partitions ran as device stages, else on the
host (``fused_input``). ``engine/leaf_cache.py`` caches it under a content
key: a warm query reads its input from the devices and runs one program. The
JAX package's compile cache and compile-service path have no counterpart
(eager PyTorch compiles nothing).

The per-shard bodies (``make_aggregate_dev_fn``, ``make_join_dev_fn``),
their estimates and ``_run_mesh`` also run a mesh group's programs
(``parallel/multihost.py``): there the input is each member's own, already
encoded under the group's agreed layout, and the exchange spans the group.

A scheduler-promoted exchange (``IciExchangeExec``) that ran as a collective
is accounted in ``op.IciExchange.{count,bytes_hbm,collective_time_s}``. Each
program records one ``DeviceExecute`` span (``program="fused"``) with its
eager estimate (``hbm_est_bytes``, the largest over the mesh's devices of
what that device's shards hold at once) and, on a card, its measured peak
(``hbm_peak_bytes``).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ballista_tpu_torch.config import (
    BALLISTA_TPU_FUSE_INPUT_MAX_ROWS, BALLISTA_TPU_FUSED_INPUT_ON_HOST,
)
from ballista_tpu_torch.engine import compile_service as CS
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.ops import grouped_sums as GS
from ballista_tpu_torch.ops import kernels_np as KNP
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.ops.eval_np import evaluate
from ballista_tpu_torch.parallel import (
    COLLECTIVE_TIMEOUT_S, collective_for, shard_map, split_rows,
)
from ballista_tpu_torch.parallel.ici import make_hash_exchange
from ballista_tpu_torch.plan import physical as P


class _EmptyInput(Exception):
    """A zero-row fused input, or one past the row cap: not cacheable; the
    caller declines the fused path."""


def _input_content_key(child: P.PhysicalPlan, n_dev: int) -> Optional[tuple]:
    """The content identity of a fused input subtree (its plan, the content
    key of every scan leaf, the exchange width and the dtype policy), or
    None when an input is dynamic (an exchange below it: its contents change
    from one execution to the next)."""
    leaf_keys: list[tuple] = []
    for node in P.walk_physical(child):
        if isinstance(node, (P.MemoryScanExec, P.ParquetScanExec)):
            ks = tuple(TE._leaf_cache_key(node, i) for i in range(node.output_partitions()))
            if any(k is None for k in ks):
                return None
            leaf_keys.append(ks)
        elif isinstance(node, (P.ShuffleReaderExec, P.UnresolvedShuffleExec,
                               P.RepartitionExec, P.ShuffleWriterExec)):
            return None
    return (child.fingerprint(), tuple(leaf_keys), n_dev, KT.NATIVE_DTYPES)


def _materialize(engine, child: P.PhysicalPlan, unfetched: Optional[list], cap: int) -> list:
    """Each partition of the fused input, through the engine's stages (with
    ``unfetched``, a device stage's output left on the device:
    ``TorchEngine._exec``) or on host kernels (``fused_input_on_host``).
    Raises _EmptyInput past ``cap`` host rows."""
    on_host = bool(engine.config.get(BALLISTA_TPU_FUSED_INPUT_ON_HOST))
    if on_host:
        engine._host_only += 1
    try:
        parts = []
        rows = 0
        for i in range(child.output_partitions()):
            b = engine._exec(child, i, unfetched)
            if isinstance(b, ColumnBatch):
                rows += b.num_rows
                if cap and rows > cap:
                    raise _EmptyInput()
            parts.append(b)
        return parts
    finally:
        if on_host:
            engine._host_only -= 1


def _encode_input(engine, parts: list, spans: Optional[list], mesh: list, cap: int) -> tuple:
    """(encoding, each shard's device tensors or None) of the fused input
    from its partitions; ``spans`` (of the parts left on the device) get
    their rows. Where every part is on the device, built there
    (``KT.encode_device_batches``, the host build's metadata over stand-ins;
    ``op.FusedInput.device_builds``); otherwise, or where only the host can
    encode a column, fetched and encoded on the host (shards None;
    ``.host_builds``). Raises _EmptyInput for zero rows or past ``cap``."""
    n_dev = len(mesh)
    got = None
    if parts and all(isinstance(p, KT.DeviceBatch) for p in parts):
        with engine._phase("ballista.fused.device_build"):
            got = KT.encode_device_batches(parts, n_dev, engine._wait, cap)
    if got is None:
        batches = [engine._fetch(p) if isinstance(p, KT.DeviceBatch) else p for p in parts]
        counts = [b.num_rows for b, p in zip(batches, parts) if isinstance(p, KT.DeviceBatch)]
    else:
        counts, enc, arrays = got
    for span, rows in zip(spans or (), counts):
        if span is not None:
            span["attrs"]["rows"] = rows
    if got is not None:
        if enc is None:
            raise _EmptyInput()
        engine._metric("op.FusedInput.device_builds", 1.0)
        return enc, [[a.to(dev) for a in shard]
                     for shard, dev in zip(split_rows(arrays, n_dev), mesh)]
    big = ColumnBatch.concat(batches)
    if big.num_rows == 0 or (cap and big.num_rows > cap):
        raise _EmptyInput()
    engine._metric("op.FusedInput.host_builds", 1.0)
    with engine._phase("ballista.leaf.encode", "op.HostEncode"):
        return KT.encode_host_batch(big, pad=KT.shard_pad(big.num_rows, n_dev)), None


def fused_input(engine, child: P.PhysicalPlan, mesh: list, device_ok: bool = True) -> tuple:
    """(encoding, each shard's device tensors on ``mesh``) of the fused
    input ``child``, through the leaf caches (``leaf_cache.fused_input``).
    With ``device_ok`` False (a megastage, whose program copies its input
    itself) the partitions are fetched as they run and the host encoding
    alone comes back (shards None). Raises _EmptyInput for zero rows or past
    ``ballista.tpu.fuse_input_max_rows``."""
    def build():
        cap = int(engine.config.get(BALLISTA_TPU_FUSE_INPUT_MAX_ROWS) or 0)
        spans = [] if device_ok else None
        with engine._phase("ballista.fused.input"):
            return _encode_input(engine, _materialize(engine, child, spans, cap), spans, mesh,
                                 cap)

    return LC.fused_input(engine, _input_content_key(child, len(mesh)), child.fingerprint(),
                          mesh, build, device_ok)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _run_mesh(engine, fns: list, shard_args: list, mesh: list, rows: int, estimate,
              group=None, timeout: float = COLLECTIVE_TIMEOUT_S):
    """Run a fused program, synchronized, as one device execute over
    ``rows`` input rows: ``fns[i](*shard_args[i])`` on shard ``i`` through
    ``parallel.shard_map``, the shards' outputs concatenated in shard order
    on the engine's device. ``estimate(i)`` (called after the run, from what
    shard ``i`` recorded) is that shard's eager estimate. With ``group`` (a
    mesh group's transport) ``mesh`` is this process's part of the group's
    mesh and the collectives span the group. Returns (outputs, seconds).
    The shard threads' grouped_sums calls count on this thread; its
    ``DeviceExecute`` span (``program="fused"``) keeps the spans one to one
    with ``op.DeviceExecute.count``."""
    cards = sorted({d for d in mesh if d.type == "cuda"}, key=str)
    # the program's tensor arguments on each card (a megastage's shards copy
    # theirs inside the program, where its peak sees them)
    resident = {c: _nbytes({t.data_ptr(): t for i, a in enumerate(shard_args) if mesh[i] == c
                            for t in a if isinstance(t, torch.Tensor)}.values())
                for c in cards}
    # no warm run falls inside the measured window (compile_service.WINDOW)
    with CS.WINDOW.stage():
        bases = {}
        with engine._phase("ballista.stage.memory"):
            for c in cards:
                # each card's allocator peak is reset to measure the program
                engine._sync(c)
                engine._metric_max("op.DevicePeak.max_bytes", MM.device_peak_bytes(c))
                torch.cuda.reset_peak_memory_stats(c)
                bases[c] = torch.cuda.memory_allocated(c)
        records: list = [None] * len(mesh)

        def body(i, *arrays):
            before = GS.thread_record()
            out = fns[i](*arrays)
            records[i] = GS.record_since(before)
            return out

        ex = engine._phase("ballista.device.execute", "op.DeviceExecute", span="DeviceExecute")
        with ex:
            with engine._phase("ballista.stage.dispatch", "op.DeviceDispatch"):
                outs = shard_map(body, [(i, *a) for i, a in enumerate(shard_args)], mesh,
                                 timeout, group)
                if len(mesh) > 1 or group is not None:
                    # the bodies ran on the shard threads: their grouped_sums
                    # calls count on the caller's
                    for record in records:
                        GS.add_to_thread_record(record)
                if len(mesh) == 1:
                    out = list(outs[0])
                else:
                    out = [torch.cat([o[j].to(engine.device) for o in outs])
                           for j in range(len(outs[0]))]
            engine._sync()
            dt = ex.stop()
            attrs = {"rows": float(rows), "program": "fused"}
            per_dev: dict = {}
            for i, dev in enumerate(mesh):
                per_dev[dev] = per_dev.get(dev, 0) + estimate(i)
            est = max(per_dev.values())
            attrs["hbm_est_bytes"] = int(est)
            engine._metric_max("op.HbmEstEager.max_bytes", est)
            if cards:
                peak = max(MM.device_peak_bytes(c) - bases[c] + resident[c] for c in cards)
                attrs["hbm_peak_bytes"] = int(peak)
                engine._metric_max("op.HbmPeak.max_bytes", peak)
                for c in cards:
                    engine._metric_max("op.DevicePeak.max_bytes", MM.device_peak_bytes(c))
            ex.attrs = attrs
        engine._metric("op.DeviceExecute.rows", float(rows))
    return out, dt


def _note_ici_metrics(engine, ici: bool, holder: dict, elapsed_s: float) -> None:
    """Two-tier shuffle accounting for a scheduler-promoted exchange that
    just ran as a mesh collective: ``bytes_hbm`` is the exchanged buffers'
    footprint (the bytes that would otherwise ride the Flight tier),
    ``collective_time_s`` the wall time of the collective-bearing program.
    Keys are what the scheduler's stage spans surface as
    ``exchange_mode=ici``."""
    if not ici:
        return
    engine._metric("op.IciExchange.count", 1.0)
    engine._metric("op.IciExchange.bytes_hbm", float(holder.get("ici_bytes", 0)))
    engine._metric("op.IciExchange.collective_time_s", elapsed_s)


def _rest_empty(merged: ColumnBatch, n_parts: int) -> list[ColumnBatch]:
    """One batch per output partition: every row in partition 0 (placement
    is not load-bearing above a fused exchange), the others empty."""
    return [merged] + [ColumnBatch.empty(merged.schema) for _ in range(n_parts - 1)]


def _shard_enc(enc: KT.EncodedBatch, arrays: list) -> KT.EncodedBatch:
    """One shard's view of an encoding: its arrays, the whole's metadata."""
    return KT.EncodedBatch(enc.schema, enc.n_rows, len(arrays[-1]), list(arrays), enc.col_meta,
                           enc.int_ranges, enc.ssums, enc.dict_ids)


def _rows_leaf(node: P.PhysicalPlan, rows: int) -> dict:
    """The estimator's leaves for a body that reads ``rows`` rows of
    ``node``'s output already on the device (counted elsewhere)."""
    return {id(node): ("out", KT.EncodedBatch(node.schema(), rows, rows, [], []), None, None,
                       node)}


def _agg_tail_bytes(final_plan: P.HashAggregateExec, partial_plan: P.HashAggregateExec,
                    partial_pad: int, n_dev: int) -> int:
    """A shard's eager bytes after its partial aggregate: the states'
    exchange and the final merge over what it received."""
    recv = n_dev * partial_pad
    return (MM.estimate_eager_megastage_bytes([[(partial_plan.schema(), recv)]], n_dev)
            + MM.estimate_eager_program_bytes(final_plan, _rows_leaf(final_plan.input, recv)))


def run_fused_aggregate(engine, final_plan: P.HashAggregateExec,
                        partial_plan: P.HashAggregateExec, n_dev: int):
    """One batch per final output partition, or None when the input is empty
    or past the row cap."""
    from ballista_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(n_dev, engine.device)
    try:
        enc, shard_args = fused_input(engine, partial_plan.input, mesh)
    except _EmptyInput:
        return None
    holders = [{} for _ in mesh]
    fns = [make_aggregate_dev_fn(final_plan, partial_plan, enc, n_dev, h) for h in holders]
    out, dt = _run_mesh(engine, fns, shard_args, mesh, enc.n_rows,
                        aggregate_estimate(final_plan, partial_plan, enc, holders, n_dev))
    _note_ici_metrics(engine, isinstance(final_plan.input, P.IciExchangeExec), holders[0], dt)
    out_db = KT.device_batch_from_outputs(holders[0]["meta"], out, 0)
    return _rest_empty(engine._fetch(out_db), final_plan.output_partitions())


def aggregate_estimate(final_plan: P.HashAggregateExec, partial_plan: P.HashAggregateExec,
                       enc: KT.EncodedBatch, holders: list, n_dev: int):
    """``estimate(i)``: local shard ``i``'s eager bytes in a fused aggregate
    over ``n_dev`` shards whose ``len(holders)`` local shards split ``enc``
    (its partial aggregate over its rows, then the exchange and the final
    merge of what ``n_dev`` shards send it)."""
    child = partial_plan.input

    def estimate(i):
        host = split_rows(enc.arrays, len(holders))[i]
        return (MM.estimate_eager_program_bytes(
                    partial_plan, {id(child): ("out", _shard_enc(enc, host), None, None, child)})
                + _agg_tail_bytes(final_plan, partial_plan, holders[i]["partial_pad"], n_dev))

    return estimate


def make_aggregate_dev_fn(final_plan: P.HashAggregateExec, partial_plan: P.HashAggregateExec,
                          enc: KT.EncodedBatch, n_dev: int, holder: dict):
    """The per-shard body of the fused aggregate: the partial aggregate over
    this shard, its states exchanged by group hash, the final merge. Fills
    ``holder`` (one per shard) with the output's static metadata (``meta``),
    the partial states' pad and the exchanged bytes."""
    child = partial_plan.input

    def dev_fn(*arrays):
        db = KT.device_batch_from_encoded(enc, list(arrays))
        partial_out = TE._trace_agg(partial_plan, {id(child): ("out", db, None)})
        holder["partial_pad"] = partial_out.n_pad
        final_out = exchange_agg_states(final_plan, partial_plan, partial_out, n_dev, holder)
        arrays_out, meta = KT.flatten_device_batch(final_out)
        holder["meta"] = meta
        return tuple(arrays_out)

    return dev_fn


def exchange_agg_states(final_plan: P.HashAggregateExec, partial_plan: P.HashAggregateExec,
                        partial_out: KT.DeviceBatch, n_dev: int, holder: dict):
    """The partial states, exchanged by the hash of their group keys (so all
    of a group's states meet on one shard), merged by the final aggregate.
    Adds the exchanged buffers' bytes to ``holder["ici_bytes"]``, so a
    program with exchanges before this one (a megastage) sums them all."""
    arrays: dict[str, torch.Tensor] = {}
    null_names: list[Optional[str]] = []
    for i, c in enumerate(partial_out.cols):
        arrays[f"c{i}"] = c.data
        null_names.append(f"n{i}" if c.null is not None else None)
        if c.null is not None:
            arrays[f"n{i}"] = c.null
    exchange = make_hash_exchange(n_dev)
    key_names = tuple(f"c{i}" for i in range(len(partial_plan.group_exprs)))
    holder["ici_bytes"] = holder.get("ici_bytes", 0) + n_dev * _nbytes(arrays.values())
    got, got_valid, _dropped = exchange(arrays, partial_out.row_valid, key_names)
    # an exchange moves rows, never values: ranges and scales still hold
    cols = [replace(c, data=got[f"c{i}"], null=got[nn] if nn is not None else None)
            for i, (c, nn) in enumerate(zip(partial_out.cols, null_names))]
    merged_in = KT.DeviceBatch(partial_out.schema, cols, got_valid, int(got_valid.shape[0]))
    return TE._trace_agg(final_plan, {id(final_plan.input): ("out", merged_in, None)})


def build_side_encoding(engine, join_plan: P.HashJoinExec, n_dev: int) -> KT.EncodedBatch:
    """The join's build side encoded for ``n_dev`` shards, carrying whether
    its keys are globally unique (the unique-key probe needs it; checked
    once per build content). Cached with the input's content key."""
    rrep = join_plan.right

    def build():
        rbig = ColumnBatch.concat(
            [engine._exec(rrep.input, i) for i in range(rrep.input.output_partitions())])
        bkey, bvalid = KNP.combined_key([evaluate(r, rbig) for _, r in join_plan.on])
        bk = bkey[bvalid]
        with engine._phase("ballista.leaf.encode", "op.HostEncode"):
            enc = KT.encode_host_batch(rbig, pad=KT.shard_pad(rbig.num_rows, n_dev))
        enc.build_unique = len(np.unique(bk)) == len(bk)
        return enc

    return LC.build_side(engine, _input_content_key(rrep.input, n_dev), _on_sig(join_plan),
                         build)


def _on_sig(join_plan: P.HashJoinExec, side: int = 1) -> tuple:
    """The join-key signature of one side (0 left, 1 right)."""
    return tuple(repr(pair[side]) for pair in join_plan.on)


def _join_bytes(penc: KT.EncodedBatch, benc: KT.EncodedBatch, n_dev: int,
                build_schema, n_local: Optional[int] = None) -> int:
    """A shard's eager bytes of the fused join: both sides' exchanges with
    their consumer (the build's sort, the probe), and the build columns
    gathered onto every received probe row. ``penc`` is the probing side's
    encoding, ``benc`` the sorted side's, whichever of the join's sides each
    is. The encodings hold the rows of ``n_local`` of the mesh's ``n_dev``
    shards (default: all of them; a mesh group's member holds its own
    shards' only), so the mesh's rows are theirs times ``n_dev / n_local``."""
    scale = n_dev // (n_local or n_dev)
    prows, brows = penc.n_pad * scale, benc.n_pad * scale
    return (MM.estimate_eager_megastage_bytes(
                [[(penc.schema, prows), (benc.schema, brows)]], n_dev)
            + prows * (MM.row_data_bytes(build_schema) + 1))


def run_fused_join(engine, join_plan: P.HashJoinExec, n_dev: int):
    """A partitioned hash join as one program: both inputs exchanged by
    join-key hash, each shard sorting the build rows it received and
    probing them with ``searchsorted``. Inner, left, semi and anti joins
    whose build keys are unique (the PK-FK shape). An inner join whose build
    keys repeat runs with the roles exchanged when its left side's keys are
    unique: the left rows are sorted and the right rows probe them
    (``op.FusedJoin.swapped``). The left side's uniqueness is read from the
    program's own sort and remembered on its cached input
    (``keys_unique``), so a join whose two sides both repeat runs at most
    one such program per input content. None for any other shape, or when
    an exchange drops rows past its capacity, or the sorted side's keys
    repeat."""
    from ballista_tpu_torch.parallel.mesh import build_mesh

    if join_plan.how not in ("inner", "left", "semi", "anti") or not join_plan.on:
        return None
    mesh = build_mesh(n_dev, engine.device)
    try:
        lenc, ldev = fused_input(engine, join_plan.left.input, mesh)
    except _EmptyInput:
        return None
    renc = build_side_encoding(engine, join_plan, n_dev)
    build_left = not renc.build_unique
    if build_left:
        if join_plan.how != "inner":
            return None
        lsig = _on_sig(join_plan, 0)
        if not vars(lenc).get("keys_unique", {}).get(lsig, True):
            return None
    rkey = _input_content_key(join_plan.right.input, n_dev)
    rdev = LC.build_side_shards(engine, renc, mesh, rkey, _on_sig(join_plan))

    holders = [{} for _ in mesh]
    fns = [make_join_dev_fn(join_plan, lenc, renc, n_dev, h, build_left) for h in holders]
    out, dt = _run_mesh(engine, fns, [ld + rd for ld, rd in zip(ldev, rdev)], mesh,
                        lenc.n_rows + renc.n_rows,
                        join_estimate(join_plan, lenc, renc, n_dev, n_dev, build_left))
    if build_left:
        with engine._wait():
            dup = int(out[-1].reshape(-1, 2)[:, 1].sum())
        vars(lenc).setdefault("keys_unique", {})[lsig] = dup == 0
    result = _finish_fused(engine, holders[0], out, join_plan.output_partitions())
    if build_left and result is not None:
        engine._metric("op.FusedJoin.swapped", 1.0)
    # rows past an exchange's capacity surface as None (the caller demotes a
    # promoted exchange): only a completed collective counts
    _note_ici_metrics(engine, result is not None and (
        isinstance(join_plan.left, P.IciExchangeExec)
        or isinstance(join_plan.right, P.IciExchangeExec)), holders[0], dt)
    return result


def join_estimate(join_plan: P.HashJoinExec, lenc: KT.EncodedBatch, renc: KT.EncodedBatch,
                  n_local: int, n_dev: int, build_left: bool = False):
    """``estimate(i)``: local shard ``i``'s eager bytes in a fused join over
    ``n_dev`` shards whose ``n_local`` local shards split ``lenc`` and
    ``renc``: its inputs, and the exchanges and probe of ``_join_bytes``
    with the roles as run (``build_left``: the left side sorted, the right
    side probing it)."""
    largs = split_rows(lenc.arrays, n_local)
    rargs = split_rows(renc.arrays, n_local)
    if build_left:
        tail = _join_bytes(renc, lenc, n_dev, join_plan.left.schema(), n_local)
    else:
        tail = _join_bytes(lenc, renc, n_dev, join_plan.right.schema(), n_local)

    def estimate(i):
        return sum(a.nbytes for a in largs[i] + rargs[i]) + tail

    return estimate


def make_join_dev_fn(join_plan: P.HashJoinExec, lenc: KT.EncodedBatch, renc: KT.EncodedBatch,
                     n_dev: int, holder: dict, build_left: bool = False):
    """The per-shard body of the fused partitioned join. Its last output is
    the mesh's "unfusable" counts (rows dropped past an exchange's capacity,
    duplicate keys on the sorted side): non-zero means the result is
    incomplete."""
    body = make_join_body(join_plan, lenc, renc, n_dev, holder, build_left)

    def dev_fn(*arrays):
        nl = len(lenc.arrays)
        ldb = KT.device_batch_from_encoded(lenc, list(arrays[:nl]))
        rdb = KT.device_batch_from_encoded(renc, list(arrays[nl:]))
        out_db, bad = body(ldb, rdb)
        arrays_out, meta = KT.flatten_device_batch(out_db)
        holder["meta"] = meta
        return tuple(arrays_out) + (bad,)

    return dev_fn


def make_join_body(join_plan: P.HashJoinExec, lenc: KT.EncodedBatch, renc: KT.EncodedBatch,
                   n_dev: int, holder: dict, build_left: bool = False):
    """``body(ldb, rdb) -> (out_db, bad)``: both sides exchanged by the
    non-negative int64 key (the splitmix64 of the canonical join keys with
    the top bit dropped, so sort order and ``searchsorted`` agree), the
    received build rows sorted by key, the received probe rows probed. The
    build side is the right one, or with ``build_left`` (inner joins only)
    the left one, probed by the right; the output keeps
    ``join_plan.schema()``'s column order either way. ``bad`` is
    ``[rows dropped past an exchange's capacity, duplicate build keys]``,
    each summed over the mesh. Adds both exchanges' bytes to
    ``holder["ici_bytes"]``."""

    def key_mix(db: KT.DeviceBatch, exprs):
        mixed = torch.zeros(db.n_pad, dtype=torch.int64, device=db.device)
        knull = torch.zeros(db.n_pad, dtype=torch.bool, device=db.device)
        for e in exprs:
            c = KT.eval_dev(e, db)
            mixed = KT.splitmix64_dev(mixed ^ KT._canonical_dev(c))
            if c.null is not None:
                knull = knull | c.null
        return KT._shr(mixed, 1), knull

    def flatten_for_exchange(db: KT.DeviceBatch, mixed):
        arrays = {"__k": mixed}
        null_names = []
        for i, c in enumerate(db.cols):
            arrays[f"c{i}"] = c.data
            null_names.append(f"n{i}" if c.null is not None else None)
            if c.null is not None:
                arrays[f"n{i}"] = c.null
        return arrays, null_names

    def cols_of(enc: KT.EncodedBatch, got: dict, null_names: list, order=None) -> list:
        # exchanged rows keep their values: encode-time ranges still bound
        ranges = enc.int_ranges or [None] * len(enc.col_meta)
        dids = enc.dict_ids or [None] * len(enc.col_meta)
        cols = []
        for i, (dtype, _null, dictionary, scale) in enumerate(enc.col_meta):
            data = got[f"c{i}"]
            null = got[null_names[i]] if null_names[i] is not None else None
            if order is not None:
                data = data[order]
                null = null[order] if null is not None else None
            cols.append(KT.DeviceCol(dtype, data, null, dictionary, ranges[i], scale,
                                     dict_id=dids[i]))
        return cols

    lexprs = [l for l, _ in join_plan.on]
    rexprs = [r for _, r in join_plan.on]
    # the probing side's encoding and keys, then the sorted side's
    penc, pexprs, benc, bexprs = ((renc, rexprs, lenc, lexprs) if build_left
                                  else (lenc, lexprs, renc, rexprs))

    def body(ldb: KT.DeviceBatch, rdb: KT.DeviceBatch):
        coll = collective_for(n_dev)
        # skew-bounded row exchange: 4x the average per-peer capacity;
        # overflow is counted and the caller declines
        exchange = make_hash_exchange(n_dev, cap_factor=4, collective=coll)
        pdb, bdb = (rdb, ldb) if build_left else (ldb, rdb)

        pmix, pknull = key_mix(pdb, pexprs)
        parr, pnulls = flatten_for_exchange(pdb, pmix)
        parr["__kn"] = pknull  # the null-key marker travels with its row
        holder["ici_bytes"] = holder.get("ici_bytes", 0) + n_dev * _nbytes(parr.values())
        pgot, pvalid, pdropped = exchange(parr, pdb.row_valid, ("__k",))
        probe = KT.DeviceBatch(pdb.schema, cols_of(penc, pgot, pnulls), pvalid,
                               int(pvalid.shape[0]))
        pk, pknull = pgot["__k"], pgot["__kn"]

        bmix, bknull = key_mix(bdb, bexprs)
        barr, bnulls = flatten_for_exchange(bdb, bmix)
        holder["ici_bytes"] += n_dev * _nbytes(barr.values())
        bgot, bvalid, bdropped = exchange(barr, bdb.row_valid & ~bknull, ("__k",))
        # received build rows sorted by key, invalid rows last (keys are
        # non-negative, so the int64 maximum is a safe sentinel)
        sort_key = torch.where(bvalid, bgot["__k"], torch.iinfo(torch.int64).max)
        order = torch.argsort(sort_key, stable=True)
        m = int(order.shape[0])
        bks = sort_key[order]
        bvs = bvalid[order]
        build = KT.DeviceBatch(bdb.schema, cols_of(benc, bgot, bnulls, order), bvs, m)

        # the unique-key probe; null-keyed probe rows never match
        pos = torch.clamp(torch.searchsorted(bks, pk), 0, m - 1)
        found = (bks[pos] == pk) & bvs[pos] & pvalid & ~pknull
        gathered = TE._gather_build_cols(build, pos, found)

        def halves(gathered):
            # a joined row's columns in join_plan.schema()'s order: left, right
            return gathered + probe.cols if build_left else probe.cols + gathered

        if join_plan.filter is not None:
            left, right = (build, probe) if build_left else (probe, build)
            found = found & TE._pair_filter(join_plan, left, right, halves(gathered), pvalid,
                                            probe.n_rows)
            # a match the filter rejects leaves its probe row unmatched: NULL
            # build columns in a left join, as SQL and the host engines give
            gathered = [replace(g, null=g.null | ~found) for g in gathered]
        schema = join_plan.schema()
        if join_plan.how == "semi":
            out_db = KT.DeviceBatch(schema, probe.cols, pvalid & found, probe.n_rows)
        elif join_plan.how == "anti":
            out_db = KT.DeviceBatch(schema, probe.cols, pvalid & ~found, probe.n_rows)
        elif join_plan.how == "inner":
            out_db = KT.DeviceBatch(schema, halves(gathered), pvalid & found, probe.n_rows)
        else:  # left
            out_db = KT.DeviceBatch(schema, probe.cols + gathered, pvalid, probe.n_rows)
        # duplicate build keys break the unique-key probe. Equal keys land on
        # one shard, so adjacent equal keys after the sort find them all; the
        # count is summed over the mesh, so every shard declines together
        dup = coll.all_sum(torch.sum((bks[1:] == bks[:-1]) & bvs[1:] & bvs[:-1]))
        bad = torch.stack([(pdropped + bdropped).to(torch.int64), dup.to(torch.int64)])
        return out_db, bad

    return body


def _fused_rows(engine, holder: dict, out: list) -> Optional[ColumnBatch]:
    """The program's rows on the host; None when its last output, the
    mesh's unfusable counts, is non-zero (a host sync)."""
    with engine._wait():
        unfusable = int(out[-1].sum())
    if unfusable:
        # rows past an exchange's capacity, or repeated keys on the sorted
        # side: the result is incomplete
        return None
    out_db = KT.device_batch_from_outputs(holder["meta"], list(out[:-1]), 0)
    return engine._fetch(out_db)


def _finish_fused(engine, holder: dict, out: list, n_parts: int) -> Optional[list[ColumnBatch]]:
    """The program's rows, one batch per output partition; None when the
    result is incomplete (the materialized exchange runs instead)."""
    rows = _fused_rows(engine, holder, out)
    return None if rows is None else _rest_empty(rows, n_parts)
