"""Flagship stage program: TPC-H q1 as one (distributable) device program
(the port of ``ballista_tpu/parallel/flagship.py``).

The canonical "model" of the engine: scan-side filter and projection, the
partial aggregate, a hash exchange, the final aggregate; on one device one
function of f64 torch ops, over a mesh one ``shard_map`` program whose
exchange is the mesh's ``all_to_all`` (``parallel/ici.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ballista_tpu_torch.parallel import shard_rows
from ballista_tpu_torch.parallel.ici import make_hash_exchange, seg_sum

N_GROUPS = 8  # returnflag (3) x linestatus (2) codes padded to radix 4x2
CUTOFF = 10470  # date '1998-09-02' as days since the epoch


def q1_local_step():
    """The one-device q1 program: ``fn(*args) -> (sums [5, N_GROUPS] f64,
    counts [N_GROUPS] int64)``.

    args: quantity f64[n], price f64[n], discount f64[n], tax f64[n],
    shipdate i32[n], rf_code i32[n], ls_code i32[n], valid bool[n]."""

    def step(quantity, price, discount, tax, shipdate, rf_code, ls_code, valid):
        keep = valid & (shipdate <= CUTOFF)
        disc_price = price * (1.0 - discount)
        charge = disc_price * (1.0 + tax)
        ids = torch.where(keep, rf_code * 2 + ls_code, N_GROUPS)
        zero = torch.zeros((), dtype=torch.float64, device=price.device)
        # masked reductions, one per group, as the JAX program computes them
        masks = [ids == g for g in range(N_GROUPS)]

        def seg(v):
            vv = torch.where(keep, v, zero)
            return torch.stack([torch.where(m, vv, zero).sum() for m in masks])

        kk = keep.to(torch.int64)
        count = torch.stack([torch.where(m, kk, 0).sum() for m in masks])
        sums = torch.stack([seg(quantity), seg(price), seg(disc_price), seg(charge),
                            seg(discount)])
        return sums, count

    return step


def q1_example_args(n: int = 8192, seed: int = 0, device="cpu") -> tuple:
    """The JAX package's example inputs (the same numpy draws from ``seed``)
    as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = rng.uniform(900.0, 105000.0, n)
    disc = rng.integers(0, 11, n) / 100.0
    tax = rng.integers(0, 9, n) / 100.0
    ship = rng.integers(8000, 10600, n).astype(np.int32)
    rf = rng.integers(0, 3, n).astype(np.int32)
    ls = rng.integers(0, 2, n).astype(np.int32)
    valid = np.ones(n, bool)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (qty, price, disc, tax, ship, rf, ls, valid))


def q1_distributed_step(mesh: list):
    """The full distributed step over ``mesh`` (``build_mesh``'s devices):
    the q1 body per shard, then the group states exchanged by group id and
    merged on their owning shard. ``fn(*args)`` splits each input into equal
    contiguous shards (partition parallelism mapped onto the mesh) and
    returns ``(sums [5 * n_dev, N_GROUPS], counts [N_GROUPS * n_dev])``, each
    shard's output in shard order, as the JAX program's ``P(axis)`` outputs
    concatenate."""
    n_dev = len(mesh)
    local = q1_local_step()
    exchange = make_hash_exchange(n_dev)

    def shard_step(*args):
        sums, count = local(*args)
        dev = sums.device
        arrays = {f"s{i}": sums[i] for i in range(sums.shape[0])}
        arrays["__key"] = torch.arange(N_GROUPS, dtype=torch.int64, device=dev)
        arrays["__count"] = count.to(torch.float64)
        got, got_valid, _dropped = exchange(arrays, count > 0, ("__key",))
        oids = torch.where(got_valid, torch.clamp(got["__key"], 0, N_GROUPS - 1), N_GROUPS)
        zero = torch.zeros((), dtype=torch.float64, device=dev)

        def merge(v):
            return seg_sum(torch.where(got_valid, v, zero), oids, N_GROUPS)

        final = torch.stack([merge(got[f"s{i}"]) for i in range(sums.shape[0])])
        return final, merge(got["__count"]).to(torch.int64)

    def fn(*args):
        return tuple(shard_rows(shard_step, args, mesh))

    return fn
