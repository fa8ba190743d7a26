"""Hash exchange as one device collective (the port of
``ballista_tpu/parallel/ici.py``).

A fused stage pair runs as one program:

    stage N body -> bucket rows by key hash -> all_to_all -> stage N+1 body

Static shapes: each device sends exactly ``cap`` rows to every peer (padded,
with a validity mask). Capacity is either always sufficient (the local row
count) or skew-bounded (``cap_factor`` x the per-peer average), with the rows
past it counted in ``dropped``: callers treat ``dropped > 0`` as "run the
materialized exchange instead".
"""
from __future__ import annotations

from typing import Callable

import torch

from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.parallel import collective_for, shard_rows


def make_hash_exchange(n_dev: int, cap_factor: int = 0, collective=None) -> Callable:
    """Returns ``exchange(arrays: dict[str, tensor [n_local]], valid
    [n_local], key_names) -> (arrays [n_dev * cap], valid, dropped)``,
    bit-identical to the JAX package's exchange under ``shard_map``.

    ``cap_factor == 0``: per-peer capacity n_local (always sufficient).
    ``cap_factor >= 1``: ceil(n_local / n_dev) * cap_factor rounded up to a
    bucket; rows past it are dropped and counted. ``collective`` defaults to
    ``collective_for(n_dev)`` where the exchange runs: the running shard's
    inside ``shard_map``."""

    def exchange(arrays: dict, valid: torch.Tensor, key_names: tuple):
        coll = collective if collective is not None else collective_for(n_dev)
        n_local = int(valid.shape[0])
        if cap_factor <= 0:
            cap = n_local
        else:
            cap = min(n_local, KT.bucket_size(-(-n_local // n_dev) * cap_factor))
        dev = valid.device
        # 1. bucket per row: the splitmix64 of the int64 keys (the host
        # shuffle's mix), then the uint64 mod n_dev; invalid rows go to the
        # trash bucket n_dev
        mixed = torch.zeros(n_local, dtype=torch.int64, device=dev)
        for k in key_names:
            mixed = KT.splitmix64_dev(mixed ^ arrays[k].to(torch.int64))
        bucket = torch.where(valid, KT._umod(mixed, n_dev), n_dev)

        # 2. rows stably sorted by bucket; each row's slot is its rank in
        # its bucket (a running max of segment starts)
        order = torch.argsort(bucket, stable=True)
        sorted_bucket = bucket[order]
        pos = torch.arange(n_local, device=dev)
        start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sorted_bucket[1:] != sorted_bucket[:-1]])
        seg_first = torch.cummax(torch.where(start, pos, 0), 0).values
        slot = pos - seg_first

        # 3. scatter into the send buffer [n_dev * cap]: rows past a peer's
        # capacity and invalid rows all land on one trash slot past the end,
        # which is sliced off (a scatter with repeated indices keeps any one
        # writer, so no real slot may take two rows: none does)
        sendable = sorted_bucket < n_dev
        dst_ok = sendable & (slot < cap)
        trash = n_dev * cap
        flat_idx = torch.where(dst_ok, sorted_bucket * cap + slot, trash)

        def scatter(src: torch.Tensor) -> torch.Tensor:
            buf = torch.zeros(trash + 1, dtype=src.dtype, device=dev)
            buf[flat_idx] = src
            return buf[:trash].reshape(n_dev, cap)

        # 4. one all_to_all round for every column and the validity (row j
        # of each buffer goes to device j), and for the rows past capacity:
        # each device sends its count to every device and sums what it
        # received, in device order (the psum)
        names = list(arrays)
        lost = torch.sum(sendable & (slot >= cap)).reshape(1, 1).expand(n_dev, 1)
        got = coll.all_to_all([scatter(arrays[n][order]) for n in names]
                              + [scatter(dst_ok), lost.contiguous()])
        out = {n: g.reshape(trash) for n, g in zip(names, got)}
        return out, got[-2].reshape(trash), got[-1].sum()

    return exchange


def seg_sum(vals: torch.Tensor, ids: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Sums of ``vals`` by ``ids`` in ``[0, n_groups]``; slot ``n_groups``
    (the invalid rows') is dropped."""
    return torch.zeros(n_groups + 1, dtype=vals.dtype, device=vals.device) \
        .index_add_(0, ids, vals)[:n_groups]


def make_distributed_groupby(n_dev: int, n_groups: int, key_name: str,
                             value_names: tuple) -> Callable:
    """A fused two-stage aggregate, per shard: the partial segment sums of
    its rows, the partial states exchanged by group hash, the final sums on
    the owning shard; the device-resident form of ``HashAggregate[partial]
    -> Repartition(hash) -> HashAggregate[final]``. Returns ``fn(arrays,
    valid) -> (group_keys [G * n_dev], sums dict, counts, seen)`` for the
    shard's received slice of groups."""
    exchange = make_hash_exchange(n_dev)

    def step(arrays: dict, valid: torch.Tensor):
        dev = valid.device
        key = arrays[key_name].to(torch.int64)
        ids = torch.where(valid, torch.clamp(key, 0, n_groups - 1), n_groups)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        partial = {v: seg_sum(torch.where(valid, arrays[v], torch.zeros_like(arrays[v])),
                              ids, n_groups) for v in value_names}
        counts = seg_sum(valid.to(torch.int64), ids, n_groups)
        gkeys = torch.arange(n_groups, dtype=torch.int64, device=dev)
        ex = dict(partial, __key=gkeys, __count=counts)
        got, got_valid, _dropped = exchange(ex, counts > 0, ("__key",))
        oids = torch.where(got_valid, torch.clamp(got["__key"], 0, n_groups - 1), n_groups)
        final = {v: seg_sum(torch.where(got_valid, got[v], torch.zeros_like(got[v])),
                            oids, n_groups) for v in value_names}
        fcount = seg_sum(torch.where(got_valid, got["__count"], zero), oids, n_groups)
        return gkeys, final, fcount, fcount > 0

    return step


def distributed_groupby(mesh: list, n_groups: int, key_name: str, value_names: tuple):
    """``make_distributed_groupby`` over ``mesh`` (``build_mesh``'s devices)
    with row-sharded inputs, the counterpart of the JAX package's
    ``jit_distributed_groupby``: ``fn(arrays, valid)`` splits its inputs into
    equal contiguous shards and returns each output concatenated in shard
    order, on the first shard's device."""
    step = make_distributed_groupby(len(mesh), n_groups, key_name, value_names)
    nv = len(value_names)

    def fn(arrays: dict, valid: torch.Tensor):
        names = list(arrays)

        def body(*xs):
            gkeys, final, fcount, seen = step(dict(zip(names, xs[:-1])), xs[-1])
            return (gkeys, *(final[v] for v in value_names), fcount, seen)

        out = shard_rows(body, [arrays[k] for k in names] + [valid], mesh)
        return out[0], dict(zip(value_names, out[1:1 + nv])), out[-2], out[-1]

    return fn
