"""Fused device-resident exchanges (the port of
``ballista_tpu/engine/fused_exchange.py``).

When a producer stage (a partial aggregate) and its consumer (the final
aggregate) share the engine's devices, the materialized shuffle between them
disappears: the pair runs as one device program whose exchange is a
collective,

    per device: the partial aggregate over its share of the input
             -> partial states bucketed by group hash -> all_to_all
             -> the final merge on the owning device

and a partitioned join over two exchanges runs the same way, both sides
exchanged on the join-key hash. Bucketing reads dictionary codes and
canonical values that are the same on every device (one shared encoding).

The fused input (everything below the partial aggregate, or below each side
of the join) is materialized, concatenated and encoded on the host once, and
its encoding and device copy are cached under a content key: a warm query
reads its input from the device and runs one program. The JAX package's
compile cache and compile-service path have no counterpart (eager PyTorch
compiles nothing), nor does its accounting of scheduler-promoted exchanges.
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
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.ops import kernels_np as KNP
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.ops.eval_np import evaluate
from ballista_tpu_torch.parallel import collective_for
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
    per_dev = KT.bucket_size(-(-big.num_rows // n_dev))
    t0 = time.time()
    enc = KT.encode_host_batch(big, pad=per_dev * n_dev)
    engine._metric("op.HostEncode.time_s", time.time() - t0)
    return enc


def _timed_call(engine, fn, dev_args: list, rows: int):
    """Run a fused program, synchronized, as one device execute over ``rows``
    input rows. Its ``DeviceExecute`` span (``program="fused"``) keeps the
    spans one to one with ``op.DeviceExecute.count``; the JAX engine counts
    a fused program but records no span for it."""
    t0 = time.time()
    out = fn(*dev_args)
    engine._sync()
    dt = time.time() - t0
    engine._metric("op.DeviceExecute.time_s", dt)
    engine._metric("op.DeviceExecute.count", 1.0)
    engine._metric("op.DeviceExecute.rows", float(rows))
    engine._record_span("DeviceExecute", t0, dt, {"rows": float(rows), "program": "fused"})
    return out


def _sharded_input(engine, child: P.PhysicalPlan, n_dev: int):
    """(EncodedBatch, device tensors) of the fused input, read through the
    content-keyed encode and device caches when its key exists, so a warm
    fused run is device execution only. With ``ballista.tpu.pin_device_cache``
    the device copy is pinned (never evicted); one pin per input plan, so a
    table registered again releases the copy of its old content."""
    key = _input_content_key(child, n_dev)
    if key is None:
        enc = _build_sharded_input(engine, child, n_dev)
        return enc, engine._to_device(enc.arrays)
    enc = TE._ENC_CACHE.get_with(("fused_in", key),
                                 lambda: _build_sharded_input(engine, child, n_dev))
    content = ("fused_dev", key)
    dev = engine._cached_on_device(content, enc.arrays)
    dev_key = engine._dev_key(content)
    slot = (child.fingerprint(), n_dev, str(engine.device))
    if not engine.config.get(BALLISTA_TPU_PIN_DEVICE_CACHE):
        # pinning off (perhaps after being on): release this input's pin
        old = _PINNED_DEV_KEYS.pop(slot, None)
        if old is not None:
            TE._DEV_CACHE.unpin(old)
    else:
        old = _PINNED_DEV_KEYS.get(slot)
        if old is not None and old != dev_key:
            TE._DEV_CACHE.unpin(old)
            TE._DEV_CACHE.invalidate(old)
        _PINNED_DEV_KEYS[slot] = dev_key
        TE._DEV_CACHE.pin(dev_key)
    return enc, dev


# (input plan fingerprint, width, device) -> its pinned device-cache key
_PINNED_DEV_KEYS: dict = {}


def _rest_empty(merged: ColumnBatch, n_parts: int) -> list[ColumnBatch]:
    """One batch per output partition: every row in partition 0 (placement
    is not load-bearing above a fused exchange), the others empty."""
    return [merged] + [ColumnBatch.empty(merged.schema) for _ in range(n_parts - 1)]


def run_fused_aggregate(engine, final_plan: P.HashAggregateExec,
                        partial_plan: P.HashAggregateExec, n_dev: int,
                        collective=None) -> Optional[list[ColumnBatch]]:
    """One batch per final output partition, or None when the input is empty
    or past the row cap."""
    try:
        enc, dev_args = _sharded_input(engine, partial_plan.input, n_dev)
    except _EmptyInput:
        return None
    holder: dict = {}
    fn = make_aggregate_dev_fn(final_plan, partial_plan, enc, n_dev, holder, collective)
    out = _timed_call(engine, fn, dev_args, enc.n_rows)
    out_db = KT.device_batch_from_outputs(holder["meta"], list(out), 0)
    return _rest_empty(engine._fetch(out_db), final_plan.output_partitions())


def make_aggregate_dev_fn(final_plan: P.HashAggregateExec, partial_plan: P.HashAggregateExec,
                          enc: KT.EncodedBatch, n_dev: int, holder: dict, collective=None):
    """The per-device body of the fused aggregate: the partial aggregate over
    this device's shard, its states exchanged by group hash, the final merge.
    Fills ``holder["meta"]`` with the output's static metadata."""
    child = partial_plan.input

    def dev_fn(*arrays):
        db = KT.device_batch_from_encoded(enc, list(arrays))
        partial_out = TE._trace_agg(partial_plan, {id(child): ("out", db, None)})
        final_out = exchange_agg_states(final_plan, partial_plan, partial_out, n_dev, collective)
        arrays_out, meta = KT.flatten_device_batch(final_out)
        holder["meta"] = meta
        return tuple(arrays_out)

    return dev_fn


def exchange_agg_states(final_plan: P.HashAggregateExec, partial_plan: P.HashAggregateExec,
                        partial_out: KT.DeviceBatch, n_dev: int, collective=None):
    """The partial states, exchanged by the hash of their group keys (so all
    of a group's states meet on one device), merged by the final
    aggregate."""
    arrays: dict[str, torch.Tensor] = {}
    null_names: list[Optional[str]] = []
    for i, c in enumerate(partial_out.cols):
        arrays[f"c{i}"] = c.data
        null_names.append(f"n{i}" if c.null is not None else None)
        if c.null is not None:
            arrays[f"n{i}"] = c.null
    exchange = make_hash_exchange(n_dev, collective=collective)
    key_names = tuple(f"c{i}" for i in range(len(partial_plan.group_exprs)))
    got, got_valid, _dropped = exchange(arrays, partial_out.row_valid, key_names)
    # an exchange moves rows, never values: ranges and scales still hold
    cols = [replace(c, data=got[f"c{i}"], null=got[nn] if nn is not None else None)
            for i, (c, nn) in enumerate(zip(partial_out.cols, null_names))]
    merged_in = KT.DeviceBatch(partial_out.schema, cols, got_valid, int(got_valid.shape[0]))
    return TE._trace_agg(final_plan, {id(final_plan.input): ("out", merged_in, None)})


def run_fused_join(engine, join_plan: P.HashJoinExec, n_dev: int,
                   collective=None) -> Optional[list[ColumnBatch]]:
    """A partitioned hash join as one program: both inputs exchanged by
    join-key hash, each device sorting the build rows it received and
    probing them with ``searchsorted``. Inner, left, semi and anti joins
    whose build keys are unique (the PK-FK shape); None for any other shape,
    or when an exchange drops rows past its capacity."""
    if join_plan.how not in ("inner", "left", "semi", "anti") or not join_plan.on:
        return None
    lrep, rrep = join_plan.left, join_plan.right

    def build_side_enc():
        rbig = ColumnBatch.concat(
            [engine._exec(rrep.input, i) for i in range(rrep.input.output_partitions())])
        # the unique-key probe needs globally unique build keys: checked once
        # per build content and carried on the encoding
        bkey, bvalid = KNP.combined_key([evaluate(r, rbig) for _, r in join_plan.on])
        bk = bkey[bvalid]
        per_dev = KT.bucket_size(max(1, -(-rbig.num_rows // n_dev)))
        enc = KT.encode_host_batch(rbig, pad=per_dev * n_dev)
        enc.build_unique = len(np.unique(bk)) == len(bk)
        return enc

    try:
        lenc, ldev = _sharded_input(engine, lrep.input, n_dev)
    except _EmptyInput:
        return None

    on_sig = tuple(repr(r) for _, r in join_plan.on)
    rkey = _input_content_key(rrep.input, n_dev)
    if rkey is None:
        renc = build_side_enc()
    else:
        renc = TE._ENC_CACHE.get_with(("fused_jb", rkey, on_sig), build_side_enc)
    if not renc.build_unique:
        return None
    rdev = engine._cached_on_device(
        None if rkey is None else ("fused_jb_dev", rkey, on_sig), renc.arrays)

    holder: dict = {}
    fn = make_join_dev_fn(join_plan, lenc, renc, n_dev, holder, collective)
    out = _timed_call(engine, fn, list(ldev) + list(rdev), lenc.n_rows + renc.n_rows)
    return _finish_fused_join(engine, join_plan, holder, out)


def make_join_dev_fn(join_plan: P.HashJoinExec, lenc: KT.EncodedBatch, renc: KT.EncodedBatch,
                     n_dev: int, holder: dict, collective=None):
    """The per-device body of the fused partitioned join. Its last output is
    the world's "unfusable" count (rows dropped past an exchange's capacity
    plus duplicate build keys): non-zero means the result is incomplete."""
    body = make_join_body(join_plan, lenc, renc, n_dev, collective)

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
                   n_dev: int, collective=None):
    """``body(ldb, rdb) -> (out_db, bad)``: both sides exchanged by the
    non-negative int64 key (the splitmix64 of the canonical join keys with
    the top bit dropped, so sort order and ``searchsorted`` agree), the
    received build rows sorted by key, the received probe rows probed."""
    coll = collective if collective is not None else collective_for(n_dev)

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
        # skew-bounded row exchange: 4x the average per-peer capacity;
        # overflow is counted and the caller declines
        exchange = make_hash_exchange(n_dev, cap_factor=4, collective=coll)

        lmix, lknull = key_mix(ldb, [l for l, _ in join_plan.on])
        larr, lnulls = flatten_for_exchange(ldb, lmix)
        larr["__kn"] = lknull  # the null-key marker travels with its row
        lgot, lvalid, ldropped = exchange(larr, ldb.row_valid, ("__k",))
        probe = KT.DeviceBatch(ldb.schema, cols_of(lenc, lgot, lnulls), lvalid,
                               int(lvalid.shape[0]))
        pk, pknull = lgot["__k"], lgot["__kn"]

        rmix, rknull = key_mix(rdb, [r for _, r in join_plan.on])
        rarr, rnulls = flatten_for_exchange(rdb, rmix)
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
        # one device, so adjacent equal keys after the sort find them all
        dup = coll.all_sum(torch.sum((bks[1:] == bks[:-1]) & rvs[1:] & rvs[:-1]))
        bad = (ldropped + rdropped + dup).reshape(1)
        return out_db, bad

    return body


def _finish_fused_join(engine, join_plan: P.HashJoinExec, holder: dict,
                       out) -> Optional[list[ColumnBatch]]:
    if int(out[-1].sum()):  # a host sync: the unfusable count
        # rows past an exchange's capacity, or repeated build keys: the
        # result is incomplete, so the materialized exchange runs instead
        return None
    out_db = KT.device_batch_from_outputs(holder["meta"], list(out[:-1]), 0)
    return _rest_empty(engine._fetch(out_db), join_plan.output_partitions())
