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
of the join) is materialized, concatenated and encoded on the host once,
padded to equal power-of-two shards, and its encoding and each shard's
device copy (on that shard's device) are cached under a content key: a warm
query reads its input from the devices and runs one program. The JAX
package's compile cache and compile-service path have no counterpart (eager
PyTorch compiles nothing).

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

import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ballista_tpu_torch.config import (
    BALLISTA_TPU_FUSE_INPUT_MAX_ROWS, BALLISTA_TPU_FUSED_INPUT_ON_HOST,
    BALLISTA_TPU_PIN_DEVICE_CACHE,
)
from ballista_tpu_torch.engine import compile_service as CS
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


def _build_sharded_input(engine, child: P.PhysicalPlan, n_dev: int) -> KT.EncodedBatch:
    """Materialize, concatenate and encode the fused input on the host,
    padded to ``n_dev`` equal power-of-two shards. Its partitions run through
    the engine's own stages, or on host kernels with
    ``ballista.tpu.fused_input_on_host``. Raises _EmptyInput for zero rows or
    past ``ballista.tpu.fuse_input_max_rows`` (checked before the concat)."""
    on_host = bool(engine.config.get(BALLISTA_TPU_FUSED_INPUT_ON_HOST))
    cap = int(engine.config.get(BALLISTA_TPU_FUSE_INPUT_MAX_ROWS) or 0)
    if on_host:
        engine._host_only += 1
    try:
        batches = []
        rows = 0
        for i in range(child.output_partitions()):
            b = engine._exec(child, i)
            rows += b.num_rows
            if cap and rows > cap:
                raise _EmptyInput()
            batches.append(b)
    finally:
        if on_host:
            engine._host_only -= 1
    big = ColumnBatch.concat(batches)
    if big.num_rows == 0:
        raise _EmptyInput()
    return _encode_sharded(engine, big, n_dev)


def _encode_sharded(engine, batch: ColumnBatch, n_dev: int) -> KT.EncodedBatch:
    per_dev = KT.bucket_size(max(1, -(-batch.num_rows // n_dev)))
    t0 = time.time()
    enc = KT.encode_host_batch(batch, pad=per_dev * n_dev)
    engine._metric("op.HostEncode.time_s", time.time() - t0)
    return enc


def _on_mesh(engine, enc: KT.EncodedBatch, mesh: list, cache_key: Optional[tuple]) -> list:
    """Shard ``i``'s arrays on ``mesh[i]``, through the device cache under
    ``cache_key + (i,)`` unless ``cache_key`` is None."""
    return [engine._cached_on_device(None if cache_key is None else cache_key + (i,),
                                     arrays, dev)
            for i, (arrays, dev) in enumerate(zip(split_rows(enc.arrays, len(mesh)), mesh))]


def _sharded_input(engine, child: P.PhysicalPlan, mesh: list):
    """(EncodedBatch, each shard's device tensors) of the fused input, read
    through the content-keyed encode and device caches when its key exists,
    so a warm fused run is device execution only. With
    ``ballista.tpu.pin_device_cache`` each shard's device copy is pinned
    (never evicted); one pin per input plan and shard, so a table registered
    again releases the copy of its old content."""
    n_dev = len(mesh)
    key = _input_content_key(child, n_dev)
    if key is None:
        enc = _build_sharded_input(engine, child, n_dev)
        return enc, _on_mesh(engine, enc, mesh, None)
    enc = TE._ENC_CACHE.get_with(("fused_in", key),
                                 lambda: _build_sharded_input(engine, child, n_dev))
    shards = _on_mesh(engine, enc, mesh, ("fused_dev", key))
    pin = engine.config.get(BALLISTA_TPU_PIN_DEVICE_CACHE)
    for i, dev in enumerate(mesh):
        dev_key = engine._dev_key(("fused_dev", key, i), dev)
        slot = (child.fingerprint(), n_dev, str(dev), i)
        if not pin:
            # pinning off (perhaps after being on): release this input's pin
            old = _PINNED_DEV_KEYS.pop(slot, None)
            if old is not None:
                TE._DEV_CACHE.unpin(old)
            continue
        old = _PINNED_DEV_KEYS.get(slot)
        if old is not None and old != dev_key:
            TE._DEV_CACHE.unpin(old)
            TE._DEV_CACHE.invalidate(old)
        _PINNED_DEV_KEYS[slot] = dev_key
        TE._DEV_CACHE.pin(dev_key)
    return enc, shards


# (input plan fingerprint, width, device, shard) -> its pinned device-cache key
_PINNED_DEV_KEYS: dict = {}


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
        for c in cards:
            # each card's allocator peak is reset to measure the program
            torch.cuda.synchronize(c)
            engine._metric_max("op.DevicePeak.max_bytes", MM.device_peak_bytes(c))
            torch.cuda.reset_peak_memory_stats(c)
            bases[c] = torch.cuda.memory_allocated(c)
        records: list = [None] * len(mesh)

        def body(i, *arrays):
            before = GS.thread_record()
            out = fns[i](*arrays)
            records[i] = GS.record_since(before)
            return out

        t0 = time.time()
        outs = shard_map(body, [(i, *a) for i, a in enumerate(shard_args)], mesh, timeout, group)
        if len(mesh) > 1 or group is not None:
            # the bodies ran on the shard threads: their grouped_sums calls
            # count on the caller's
            for record in records:
                GS.add_to_thread_record(record)
        if len(mesh) == 1:
            out = list(outs[0])
        else:
            out = [torch.cat([o[j].to(engine.device) for o in outs]) for j in range(len(outs[0]))]
        engine._sync()
        dt = time.time() - t0
        engine._metric("op.DeviceExecute.time_s", dt)
        engine._metric("op.DeviceExecute.count", 1.0)
        engine._metric("op.DeviceExecute.rows", float(rows))
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
        engine._record_span("DeviceExecute", t0, dt, attrs)
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
        enc, shard_args = _sharded_input(engine, partial_plan.input, mesh)
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
        enc = _encode_sharded(engine, rbig, n_dev)
        enc.build_unique = len(np.unique(bk)) == len(bk)
        return enc

    rkey = _input_content_key(rrep.input, n_dev)
    if rkey is None:
        return build()
    return TE._ENC_CACHE.get_with(("fused_jb", rkey, _on_sig(join_plan)), build)


def _on_sig(join_plan: P.HashJoinExec) -> tuple:
    return tuple(repr(r) for _, r in join_plan.on)


def _join_bytes(lenc: KT.EncodedBatch, renc: KT.EncodedBatch, n_dev: int,
                right_schema, n_local: Optional[int] = None) -> int:
    """A shard's eager bytes of the fused join: both sides' exchanges with
    their consumer (the build's sort, the probe), and the build columns
    gathered onto every received probe row. The encodings hold the rows of
    ``n_local`` of the mesh's ``n_dev`` shards (default: all of them; a mesh
    group's member holds its own shards' only), so the mesh's rows are
    theirs times ``n_dev / n_local``."""
    scale = n_dev // (n_local or n_dev)
    lrows, rrows = lenc.n_pad * scale, renc.n_pad * scale
    return (MM.estimate_eager_megastage_bytes(
                [[(lenc.schema, lrows), (renc.schema, rrows)]], n_dev)
            + lrows * (MM.row_data_bytes(right_schema) + 1))


def run_fused_join(engine, join_plan: P.HashJoinExec, n_dev: int):
    """A partitioned hash join as one program: both inputs exchanged by
    join-key hash, each shard sorting the build rows it received and
    probing them with ``searchsorted``. Inner, left, semi and anti joins
    whose build keys are unique (the PK-FK shape); None for any other shape,
    or when an exchange drops rows past its capacity."""
    from ballista_tpu_torch.parallel.mesh import build_mesh

    if join_plan.how not in ("inner", "left", "semi", "anti") or not join_plan.on:
        return None
    mesh = build_mesh(n_dev, engine.device)
    try:
        lenc, ldev = _sharded_input(engine, join_plan.left.input, mesh)
    except _EmptyInput:
        return None
    renc = build_side_encoding(engine, join_plan, n_dev)
    if not renc.build_unique:
        return None
    rkey = _input_content_key(join_plan.right.input, n_dev)
    rdev = _on_mesh(engine, renc, mesh,
                    None if rkey is None else ("fused_jb_dev", rkey, _on_sig(join_plan)))

    holders = [{} for _ in mesh]
    fns = [make_join_dev_fn(join_plan, lenc, renc, n_dev, h) for h in holders]
    out, dt = _run_mesh(engine, fns, [ld + rd for ld, rd in zip(ldev, rdev)], mesh,
                        lenc.n_rows + renc.n_rows,
                        join_estimate(join_plan, lenc, renc, n_dev, n_dev))
    result = _finish_fused(engine, holders[0], out, join_plan.output_partitions())
    # rows past an exchange's capacity surface as None (the caller demotes a
    # promoted exchange): only a completed collective counts
    _note_ici_metrics(engine, result is not None and (
        isinstance(join_plan.left, P.IciExchangeExec)
        or isinstance(join_plan.right, P.IciExchangeExec)), holders[0], dt)
    return result


def join_estimate(join_plan: P.HashJoinExec, lenc: KT.EncodedBatch, renc: KT.EncodedBatch,
                  n_local: int, n_dev: int):
    """``estimate(i)``: local shard ``i``'s eager bytes in a fused join over
    ``n_dev`` shards whose ``n_local`` local shards split ``lenc`` and
    ``renc``: its inputs, and the exchanges and probe of ``_join_bytes``."""
    largs = split_rows(lenc.arrays, n_local)
    rargs = split_rows(renc.arrays, n_local)

    def estimate(i):
        return (sum(a.nbytes for a in largs[i] + rargs[i])
                + _join_bytes(lenc, renc, n_dev, join_plan.right.schema(), n_local))

    return estimate


def make_join_dev_fn(join_plan: P.HashJoinExec, lenc: KT.EncodedBatch, renc: KT.EncodedBatch,
                     n_dev: int, holder: dict):
    """The per-shard body of the fused partitioned join. Its last output is
    the mesh's "unfusable" count (rows dropped past an exchange's capacity
    plus duplicate build keys): non-zero means the result is incomplete."""
    body = make_join_body(join_plan, lenc, renc, n_dev, holder)

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
                   n_dev: int, holder: dict):
    """``body(ldb, rdb) -> (out_db, bad)``: both sides exchanged by the
    non-negative int64 key (the splitmix64 of the canonical join keys with
    the top bit dropped, so sort order and ``searchsorted`` agree), the
    received build rows sorted by key, the received probe rows probed.
    Adds both exchanges' bytes to ``holder["ici_bytes"]``."""

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

    def body(ldb: KT.DeviceBatch, rdb: KT.DeviceBatch):
        coll = collective_for(n_dev)
        # skew-bounded row exchange: 4x the average per-peer capacity;
        # overflow is counted and the caller declines
        exchange = make_hash_exchange(n_dev, cap_factor=4, collective=coll)

        lmix, lknull = key_mix(ldb, [l for l, _ in join_plan.on])
        larr, lnulls = flatten_for_exchange(ldb, lmix)
        larr["__kn"] = lknull  # the null-key marker travels with its row
        holder["ici_bytes"] = holder.get("ici_bytes", 0) + n_dev * _nbytes(larr.values())
        lgot, lvalid, ldropped = exchange(larr, ldb.row_valid, ("__k",))
        probe = KT.DeviceBatch(ldb.schema, cols_of(lenc, lgot, lnulls), lvalid,
                               int(lvalid.shape[0]))
        pk, pknull = lgot["__k"], lgot["__kn"]

        rmix, rknull = key_mix(rdb, [r for _, r in join_plan.on])
        rarr, rnulls = flatten_for_exchange(rdb, rmix)
        holder["ici_bytes"] += n_dev * _nbytes(rarr.values())
        rgot, rvalid, rdropped = exchange(rarr, rdb.row_valid & ~rknull, ("__k",))
        # received build rows sorted by key, invalid rows last (keys are
        # non-negative, so the int64 maximum is a safe sentinel)
        sort_key = torch.where(rvalid, rgot["__k"], torch.iinfo(torch.int64).max)
        order = torch.argsort(sort_key, stable=True)
        m = int(order.shape[0])
        bks = sort_key[order]
        rvs = rvalid[order]
        build = KT.DeviceBatch(rdb.schema, cols_of(renc, rgot, rnulls, order), rvs, m)

        # the unique-key probe; null-keyed probe rows never match
        pos = torch.clamp(torch.searchsorted(bks, pk), 0, m - 1)
        found = (bks[pos] == pk) & rvs[pos] & lvalid & ~pknull
        gathered = TE._gather_build_cols(build, pos, found)
        if join_plan.filter is not None:
            found = found & TE._pair_filter(join_plan, probe, build, probe.cols + gathered,
                                            probe.row_valid, probe.n_rows)
            # a match the filter rejects leaves its probe row unmatched: NULL
            # build columns in a left join, as SQL and the host engines give
            gathered = [replace(g, null=g.null | ~found) for g in gathered]
        schema = join_plan.schema()
        if join_plan.how == "semi":
            out_db = KT.DeviceBatch(schema, probe.cols, lvalid & found, probe.n_rows)
        elif join_plan.how == "anti":
            out_db = KT.DeviceBatch(schema, probe.cols, lvalid & ~found, probe.n_rows)
        elif join_plan.how == "inner":
            out_db = KT.DeviceBatch(schema, probe.cols + gathered, lvalid & found, probe.n_rows)
        else:  # left
            out_db = KT.DeviceBatch(schema, probe.cols + gathered, lvalid, probe.n_rows)
        # duplicate build keys break the unique-key probe. Equal keys land on
        # one shard, so adjacent equal keys after the sort find them all; the
        # count is summed over the mesh, so every shard declines together
        dup = coll.all_sum(torch.sum((bks[1:] == bks[:-1]) & rvs[1:] & rvs[:-1]))
        bad = (ldropped + rdropped + dup).reshape(1)
        return out_db, bad

    return body


def _fused_rows(engine, holder: dict, out: list) -> Optional[ColumnBatch]:
    """The program's rows on the host; None when its last output, the
    mesh's unfusable count, is non-zero (a host sync)."""
    if int(out[-1].sum()):
        # rows past an exchange's capacity, or repeated build keys: the
        # result is incomplete
        return None
    out_db = KT.device_batch_from_outputs(holder["meta"], list(out[:-1]), 0)
    return engine._fetch(out_db)


def _finish_fused(engine, holder: dict, out: list, n_parts: int) -> Optional[list[ColumnBatch]]:
    """The program's rows, one batch per output partition; None when the
    result is incomplete (the materialized exchange runs instead)."""
    rows = _fused_rows(engine, holder, out)
    return None if rows is None else _rest_empty(rows, n_parts)
