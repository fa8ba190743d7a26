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
from ballista_tpu_torch.parallel import collective_for


def make_hash_exchange(n_dev: int, cap_factor: int = 0, collective=None) -> Callable:
    """Returns ``exchange(arrays: dict[str, tensor [n_local]], valid
    [n_local], key_names) -> (arrays [n_dev * cap], valid, dropped)``,
    bit-identical to the JAX package's exchange under ``shard_map``.

    ``cap_factor == 0``: per-peer capacity n_local (always sufficient).
    ``cap_factor >= 1``: ceil(n_local / n_dev) * cap_factor rounded up to a
    bucket; rows past it are dropped and counted. ``collective`` defaults to
    ``collective_for(n_dev)``, which raises for more than one device."""
    coll = collective if collective is not None else collective_for(n_dev)

    def exchange(arrays: dict, valid: torch.Tensor, key_names: tuple):
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
        dropped = coll.all_sum(torch.sum(sendable & (slot >= cap)))
        trash = n_dev * cap
        flat_idx = torch.where(dst_ok, sorted_bucket * cap + slot, trash)

        def send(src: torch.Tensor) -> torch.Tensor:
            buf = torch.zeros(trash + 1, dtype=src.dtype, device=dev)
            buf[flat_idx] = src
            # 4. the all_to_all: row j of the buffer goes to device j
            return coll.all_to_all(buf[:trash].reshape(n_dev, cap)).reshape(trash)

        out = {name: send(a[order]) for name, a in arrays.items()}
        return out, send(dst_ok), dropped

    return exchange
