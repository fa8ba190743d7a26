"""Async-style loading cache with coalesced loads + LRU resource accounting.

Reference analog: the ``ballista/cache`` crate (survey §2.4): a Guava-style
loading cache — ``get_with(key, loader)`` coalesces concurrent loads of the
same key (one loader runs; the others wait), an LRU policy accounts per-entry
resource cost, and listeners observe evictions. Used for the executor's
data-cache layer (``ballista.data_cache.enabled``).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Generic, Hashable, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LoadingCache(Generic[K, V]):
    def __init__(
        self,
        capacity: int | float,
        weigher: Optional[Callable[[V], float]] = None,
        eviction_listener: Optional[Callable[[K, V], None]] = None,
    ):
        self.capacity = capacity
        self.weigher = weigher or (lambda v: 1)
        self.eviction_listener = eviction_listener
        self._mu = threading.Lock()
        self._entries: "OrderedDict[K, V]" = OrderedDict()
        self._weights: dict[K, float] = {}
        self._total = 0.0
        self._inflight: dict[K, threading.Event] = {}
        self._pinned: set[K] = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ---- pinning (reference: the cache policy layer — pinned entries are
    # never evicted; the TPU use is keeping a hot table's device arrays
    # resident across the whole session) -----------------------------------------
    def pin(self, key: K) -> None:
        with self._mu:
            self._pinned.add(key)

    def unpin(self, key: K) -> None:
        with self._mu:
            self._pinned.discard(key)

    # ---- core ------------------------------------------------------------------
    def get(self, key: K) -> Optional[V]:
        with self._mu:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                return self._entries[key]
            self.misses += 1
            return None

    def get_with(self, key: K, loader: Callable[[], V]) -> V:
        """Coalesced load: concurrent callers for one key share a single load
        (reference: CacheDriver / CancellationSafeFuture)."""
        while True:
            with self._mu:
                if key in self._entries:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    return self._entries[key]
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                    break
            ev.wait()
        try:
            value = loader()
        except BaseException:
            with self._mu:
                self._inflight.pop(key).set()
            raise
        with self._mu:
            self.misses += 1
            self._insert(key, value)
            self._inflight.pop(key).set()
        return value

    def put(self, key: K, value: V) -> None:
        with self._mu:
            self._insert(key, value)

    def invalidate(self, key: K) -> None:
        with self._mu:
            self._pinned.discard(key)
            self._drop(key)

    def clear(self) -> None:
        with self._mu:
            self._pinned.clear()
            for k in list(self._entries):
                self._drop(k)

    def __len__(self) -> int:
        return len(self._entries)

    def total_weight(self) -> float:
        return self._total

    # ---- internals (call with lock held) -----------------------------------------
    def _insert(self, key: K, value: V) -> None:
        if key in self._entries:
            self._drop(key, notify=False)
        w = self.weigher(value)
        self._entries[key] = value
        self._weights[key] = w
        self._total += w
        if self._total <= self.capacity:
            return  # common case: under budget, no scans
        # pinned weight sits OUTSIDE the LRU budget: pinning a table larger
        # than the cache must not turn every other entry into insert-evict
        # thrash (the budget governs the unpinned working set)
        pinned_w = (
            sum(self._weights.get(k, 0) for k in self._pinned) if self._pinned else 0
        )
        if pinned_w > self.capacity and not getattr(self, "_pin_warned", False):
            self._pin_warned = True
            import logging

            logging.getLogger("ballista.cache").warning(
                "pinned cache entries (%.1f MB) exceed the cache budget "
                "(%.1f MB); unpinned entries still get the full budget",
                pinned_w / 1e6, self.capacity / 1e6,
            )
        if self._total - pinned_w <= self.capacity:
            return
        evictable = [k for k in self._entries if k not in self._pinned and k != key]
        while self._total - pinned_w > self.capacity and evictable:
            self._drop(evictable.pop(0))
            self.evictions += 1

    def _drop(self, key: K, notify: bool = True) -> None:
        v = self._entries.pop(key, None)
        if v is None:
            return
        self._total -= self._weights.pop(key, 0)
        if notify and self.eviction_listener is not None:
            self.eviction_listener(key, v)
