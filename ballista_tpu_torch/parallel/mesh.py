"""Shuffle widths over a world of devices.

The device-neutral half of ``ballista_tpu/parallel/mesh.py``: the exchange
width is a multiple of the device count, so every device owns an equal share
of the exchange's partitions, and the memory governor's budget-aware solve
for that width. The JAX package's ``build_mesh`` has no counterpart: the
port's world of devices is passed to the fused exchange as a collective
(``parallel/__init__.py``).
"""
from __future__ import annotations

# budget solver ceiling: a stage needing more exchange partitions than this
# against its device-memory budget is mis-planned (paged join or rejection),
# and per-partition overhead would dominate anyway. Session override:
# ballista.engine.max_shuffle_partitions.
MAX_SHUFFLE_PARTITIONS = 4096


def pick_shuffle_partitions(
    n_devices: int,
    requested: int,
    budget_bytes: int = 0,
    bytes_per_partition=None,
    max_partitions: int = MAX_SHUFFLE_PARTITIONS,
) -> int:
    """Round the configured shuffle width to a multiple of the device count.

    Budget-aware form (the memory governor): with ``budget_bytes`` > 0 and a
    ``bytes_per_partition(n)`` footprint curve (engine/memory_model), the
    requested count is only a floor — the result is the smallest
    device-aligned count whose per-partition stage program fits the budget,
    found by doubling (doubles keep the device alignment, and the padded
    footprint curve is stepwise anyway). Returns 0 when no count up to
    ``max_partitions`` fits: the caller falls through to the paged join or
    an admission rejection, never to running out of device memory."""
    if requested <= n_devices:
        n = n_devices
    else:
        n = ((requested + n_devices - 1) // n_devices) * n_devices
    if not budget_bytes or bytes_per_partition is None:
        return n
    floor_n = n
    while n <= max_partitions:
        if bytes_per_partition(n) <= budget_bytes:
            return n
        n <<= 1
    # the doubling walk can jump past the ceiling without testing it (3072
    # -> 6144 over a 4096 cap): probe the largest device-aligned count under
    # the cap before declaring that nothing fits
    cap = (max_partitions // n_devices) * n_devices
    if floor_n <= cap < n and bytes_per_partition(cap) <= budget_bytes:
        return cap
    return 0
