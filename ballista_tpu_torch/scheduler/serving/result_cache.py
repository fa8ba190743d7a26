"""Byte-budgeted LRU over sealed Arrow results.

Identical dashboards / point lookups return straight from here without
touching executors. Entries are WHOLE, already-cast ``pyarrow.Table`` results
(the bytes the client would have assembled from the shuffle partitions), so a
cache hit is byte-identical at the table level to a cache-off run. Keys carry
the statement fingerprint plus the catalog version (and any caller-chosen
context), so a table (de)registration — which bumps the version — makes every
prior entry unreachable; the LRU then ages them out.

The LRU itself is the shared cache layer (``utils.cache.LoadingCache`` with a
byte weigher); this wrapper only adds the serving-specific per-entry bound:
``max_entry_bytes`` caps one result, so a 10 GB table scan is never admitted
to evict a thousand dashboards (tracked as ``oversize_skips``).
"""
from __future__ import annotations

from typing import Any, Hashable, Optional

from ballista_tpu_torch.utils.cache import LoadingCache


def _table_bytes(table: Any) -> int:
    nbytes = getattr(table, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    return 0


class ResultCache:
    def __init__(self, capacity_bytes: int = 64 * 1024 * 1024,
                 max_entry_bytes: int = 4 * 1024 * 1024):
        self.capacity_bytes = max(0, capacity_bytes)
        self.max_entry_bytes = max(0, max_entry_bytes)
        self._lru: LoadingCache[Hashable, Any] = LoadingCache(
            self.capacity_bytes, weigher=_table_bytes
        )
        self.oversize_skips = 0

    def get(self, key: Hashable) -> Optional[Any]:
        return self._lru.get(key)

    def put(self, key: Hashable, table: Any) -> bool:
        """Insert a sealed result; returns False when the entry exceeds the
        per-entry bound (tracked as an ``oversize_skip``, not an error)."""
        w = _table_bytes(table)
        if w > self.max_entry_bytes or w > self.capacity_bytes:
            self.oversize_skips += 1
            return False
        self._lru.put(key, table)
        return True

    def clear(self) -> None:
        self._lru.clear()

    def __len__(self) -> int:
        return len(self._lru)

    def total_bytes(self) -> int:
        return int(self._lru.total_weight())

    def stats(self) -> dict:
        return {
            "entries": len(self._lru),
            "bytes": int(self._lru.total_weight()),
            "capacity_bytes": self.capacity_bytes,
            "max_entry_bytes": self.max_entry_bytes,
            "hits": self._lru.hits,
            "misses": self._lru.misses,
            "evictions": self._lru.evictions,
            "oversize_skips": self.oversize_skips,
        }
