"""Bounded-LRU plan cache: governed physical templates keyed by fingerprint.

Same bookkeeping discipline as the compile service's two-tier executable
cache (engine/compile_service.py): bounded LRU with opened/hits/misses/
evictions stats and explicit invalidation. The value is the ENCODED physical
plan — every hit decodes a fresh node tree, so two concurrent jobs can never
share mutable plan state, and a template that round-trips serde (PV006's
fixed-point invariant) is exactly a template that is safe to cache.

Prepared statements PIN their fingerprint: a pinned entry is never evicted
while a live prepared-statement handle references it (Flight SQL releases the
pin on ClosePreparedStatement AND when its own handle table evicts the
statement — a crashed client pool must not leak pins forever).
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Hashable, Optional

from ballista_tpu_torch.analysis import concurrency


@dataclass
class PlanEntry:
    """One cached, already-governed physical template."""

    fingerprint: str
    plan_bytes: bytes
    warnings: list[str] = field(default_factory=list)
    # engine.memory_model.MemoryReport (read-only after governing), or None
    memory_report: Any = None
    # exchange-cache digest memo {stage_id: digest|None} (docs/serving.md):
    # the digests depend only on this template + the split settings already
    # baked into the cache key, so hits skip re-serializing every leaf
    # exchange subtree per job on the high-QPS submit path
    exchange_digests: Any = None
    hits: int = 0


class PlanCache:
    def __init__(self, capacity: int = 256):
        self.capacity = max(1, capacity)
        self._mu = concurrency.make_lock("PlanCache._mu")
        # guarded_dict subclasses OrderedDict, so the LRU move_to_end /
        # ordered iteration below work under either mode
        self._entries = concurrency.guarded_dict("PlanCache._entries", self._mu)
        # fingerprint -> live prepared-statement references
        self._pins = concurrency.guarded_dict("PlanCache._pins", self._mu)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, key: Hashable) -> Optional[PlanEntry]:
        with self._mu:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            e.hits += 1
            return e

    def put(self, key: Hashable, entry: PlanEntry) -> None:
        with self._mu:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                victim = next(
                    (
                        k
                        for k, v in self._entries.items()
                        if self._pins.get(v.fingerprint, 0) <= 0
                    ),
                    None,
                )
                if victim is None:
                    # every entry is pinned by a live prepared statement:
                    # over-capacity but un-evictable — the pin release
                    # (Close / handle-table eviction) restores the bound
                    break
                self._entries.pop(victim)
                self.evictions += 1

    # ---- pinning (prepared statements) -------------------------------------------
    def pin(self, fingerprint: str) -> None:
        with self._mu:
            self._pins[fingerprint] = self._pins.get(fingerprint, 0) + 1

    def unpin(self, fingerprint: str) -> None:
        with self._mu:
            n = self._pins.get(fingerprint, 0) - 1
            if n > 0:
                self._pins[fingerprint] = n
            else:
                self._pins.pop(fingerprint, None)

    def pin_count(self, fingerprint: str) -> int:
        with self._mu:
            return self._pins.get(fingerprint, 0)

    # ---- invalidation -----------------------------------------------------------
    def invalidate_all(self) -> int:
        """Drop every entry (catalog-wide invalidation). Keys already carry
        the catalog-version/table-defs digest, so stale entries can never be
        SERVED — this just reclaims their slots eagerly on (de)registration."""
        with self._mu:
            n = len(self._entries)
            self._entries.clear()
            self.invalidations += n
            return n

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def stats(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "pinned_fingerprints": len(self._pins),
            }
