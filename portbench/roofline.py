"""Rooflines: the bytes a kernel call needs and the card's published
peaks. Imports nothing of the port.

A call of ``grouped_sums_multi(vals, masks, ids, k)`` reads its group ids,
each distinct mask and each distinct value column once and writes its
``[C, k]`` output once; that is the least traffic the call needs, whatever
the kernel reads again. Its roofline share is that traffic at the card's
published HBM bandwidth over the kernel's device time in the traced run.
"""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
# the kernel's name in a device trace (csrc/grouped_sums.cu)
GROUPED_SUMS_KERNEL = "grouped_sums_kernel"


def peaks(kind: str) -> dict:
    """The published peaks of a card by the name CUDA gives it."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    for entry in table:
        if entry["kind"] == kind:
            return entry
    raise KeyError(f"no published peaks for {kind!r} in peaks.json")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def grouped_sums_bytes(vals, masks, ids, k: int) -> int:
    """Least bytes moved by one call: ids, distinct masks and value columns
    read once, the output written once."""
    seen, total = set(), _nbytes(ids)
    for t in list(masks) + [v for v in vals if v is not None]:
        if t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            total += _nbytes(t)
    out_item = 4 if any(v is not None and v.element_size() == 4 for v in vals) else 8
    return total + len(vals) * k * out_item
