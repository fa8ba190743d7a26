"""The mesh and shuffle widths over it (the port of
``ballista_tpu/parallel/mesh.py``).

``build_mesh`` lists the shards' devices; the exchange width is a multiple of
the shard count, so every shard owns an equal share of the exchange's
partitions, and the memory governor solves that width against its budget.
"""
from __future__ import annotations

from typing import Optional

import torch

from ballista_tpu_torch.parallel import mesh_shards


def build_mesh(n_devices: Optional[int] = None, device="cuda") -> list:
    """The devices of a mesh of ``n_devices`` shards (default: the process's
    mesh, ``parallel.mesh_shards``) for an engine on ``device``: on a card,
    the visible cards round-robin from the first (several shards share a
    card when there are fewer cards than shards); on the CPU, ``cpu`` for
    every shard."""
    dev = torch.device(device)
    n = n_devices or mesh_shards(dev)
    if dev.type != "cuda":
        return [torch.device("cpu")] * n
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("a CUDA mesh needs a visible card")
    return [torch.device("cuda", i % cards) for i in range(n)]


def shards_per_card(devices: list) -> int:
    """The most shards of ``devices`` on one device."""
    return max((devices.count(d) for d in set(devices)), default=1)


def mesh_shape(devices: list, share: float = 1.0) -> str:
    """The shape a torch executor registers for its mesh: ``"CxS"``, C
    devices with S shards on each (``"1x4"``: four shards of one card),
    and ``"@F"`` after it when the process plans for a share F below 1 of
    each card (``"1x1@0.5"``: one of two executors on one card)."""
    shape = f"{len(set(devices))}x{shards_per_card(devices)}"
    return shape if share >= 1.0 else f"{shape}@{share:g}"


def shards_per_card_of(shape: str) -> int:
    """S of a registered ``"CxS"`` mesh shape; 1 for any other (a host
    executor's empty shape)."""
    cards, sep, per = shape.partition("@")[0].partition("x")
    return int(per) if sep and cards.isdigit() and per.isdigit() and int(per) > 0 else 1


def device_share_of(shape: str) -> float:
    """F of a registered ``"CxS@F"`` mesh shape: the share of each card the
    executor plans for; 1.0 without one, or for one outside (0, 1]."""
    _shape, sep, share = shape.partition("@")
    try:
        f = float(share) if sep else 1.0
    except ValueError:
        return 1.0
    return f if 0.0 < f <= 1.0 else 1.0

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
