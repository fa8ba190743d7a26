"""Consistent hashing for data-locality task placement.

Reference analog: ``ConsistentHash`` — md5 ring with virtual nodes and
tolerance-based work stealing (``arrow-ballista: ballista/core/src/
consistent_hash/mod.rs:24-70``), used by ``bind_task_consistent_hash``
(``scheduler/src/cluster/mod.rs:567-679``): a task whose stage scans files is
preferentially bound to the executor owning the first scan file's hash, so
repeated queries hit warm caches (and, on TPU executors, device-resident
column caches).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Optional, Sequence

from ballista_tpu_torch.plan import physical as P


def _md5_64(data: bytes) -> int:
    return int.from_bytes(hashlib.md5(data).digest()[:8], "big")


class ConsistentHash:
    def __init__(self, nodes: Sequence[str], num_replicas: int = 31):
        self.num_replicas = num_replicas
        self._ring: list[tuple[int, str]] = []
        for n in nodes:
            self.add(n)

    def add(self, node: str) -> None:
        for i in range(self.num_replicas):
            h = _md5_64(f"{node}:{i}".encode())
            bisect.insort(self._ring, (h, node))

    def remove(self, node: str) -> None:
        self._ring = [(h, n) for h, n in self._ring if n != node]

    def nodes(self) -> set[str]:
        return {n for _, n in self._ring}

    def candidates(self, key: str, tolerance: int) -> list[str]:
        """The owner plus up to ``tolerance`` distinct successors (work
        stealing when the owner has no free slots; tolerance=0 pins strictly)."""
        if not self._ring:
            return []
        h = _md5_64(key.encode())
        i = bisect.bisect_left(self._ring, (h, ""))
        out: list[str] = []
        seen = set()
        j = i
        while len(out) < tolerance + 1 and len(seen) < len(self.nodes()):
            _, node = self._ring[j % len(self._ring)]
            if node not in seen:
                seen.add(node)
                out.append(node)
            j += 1
        return out

    def node_for(self, key: str) -> Optional[str]:
        c = self.candidates(key, 0)
        return c[0] if c else None


def get_scan_files(plan: P.PhysicalPlan, partition: int) -> list[str]:
    """Files the task for ``partition`` will scan (reference: get_scan_files,
    cluster/mod.rs:688-711). Used as the locality key."""
    out: list[str] = []
    for node in P.walk_physical(plan):
        if isinstance(node, P.ParquetScanExec) and node.file_groups:
            idx = min(partition, len(node.file_groups) - 1)
            out.extend(node.file_groups[idx])
    return out


def bind_tasks_consistent_hash(
    tasks: list[tuple[int, int, P.PhysicalPlan]],
    free_slots: dict[str, int],
    num_replicas: int = 31,
    tolerance: int = 0,
) -> list[tuple[str, tuple[int, int, P.PhysicalPlan]]]:
    """Assign each (stage_id, partition, plan) an executor: by first-scan-file
    hash when the stage scans files, falling back to most-free otherwise.
    Mutates ``free_slots``; returns [(executor_id, task_tuple)] for tasks that
    found a slot."""
    ring = ConsistentHash(list(free_slots), num_replicas)
    out = []
    for task in tasks:
        _, partition, plan = task
        files = get_scan_files(plan, partition)
        chosen = None
        if files:
            for cand in ring.candidates(files[0], tolerance):
                if free_slots.get(cand, 0) > 0:
                    chosen = cand
                    break
        if chosen is None:
            avail = [(n, s) for n, s in free_slots.items() if s > 0]
            if not avail:
                continue
            chosen = max(avail, key=lambda x: x[1])[0]
        free_slots[chosen] -= 1
        out.append((chosen, task))
    return out
