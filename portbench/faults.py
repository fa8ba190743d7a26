"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them (``tests/test_portbench_faults.py``). A
run never plants one unless a test asks, by ``plant``.

- ``answer``: an answer altered where it is produced: grouped_sums adds 1 to
  the first group's first column.
- ``half_batch``: half of the batch left out: grouped_sums sums only the
  first half of its rows (an AVG becomes the mean over the rest).
- ``stale_leaf``: a step that returns its state unchanged: the leaf caches'
  key leaves out the pushed filters, so a query with new literals is served
  the encoding of the last.

The cells run on one card, so they have no exchange between chips to leave
out.
"""
from __future__ import annotations

NAMES = ("answer", "half_batch", "stale_leaf")


def plant(name: str) -> None:
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}")
    globals()[f"_{name}"]()


def _answer() -> None:
    import ballista_tpu_torch.ops.grouped_sums as GS

    real = GS.grouped_sums_multi

    def altered(vals, masks, ids, k):
        out = real(vals, masks, ids, k)
        out[0, 0] += 1
        return out

    GS.grouped_sums_multi = altered


def _half_batch() -> None:
    import ballista_tpu_torch.ops.grouped_sums as GS

    real = GS.grouped_sums_multi

    def halved(vals, masks, ids, k):
        keep = masks[0].clone()
        keep[keep.shape[0] // 2:] = False
        return real(vals, [m & keep for m in masks], ids, k)

    GS.grouped_sums_multi = halved


def _stale_leaf() -> None:
    from ballista_tpu_torch.engine import torch_engine as TE

    real = TE._leaf_cache_key

    def loose(node, part):
        key = real(node, part)
        if key is not None and key[0] == "pq":
            key = key[:4] + key[5:]
        return key

    TE._leaf_cache_key = loose

