"""Async-style loading cache with coalesced loads + LRU resource accounting.

Reference analog: the ``ballista/cache`` crate (survey §2.4): a Guava-style
loading cache — ``get_with(key, loader)`` coalesces concurrent loads of the
same key (one loader runs; the others wait), an LRU policy accounts per-entry
resource cost, and listeners observe evictions. Used for the executor's
data-cache layer (``ballista.data_cache.enabled``) and the torch engine's
host-encode/device-transfer caches.

Eviction accounting: ``evictions`` counts the entries dropped for weight and
``evicted_weight`` their summed weight (an invalidation or ``clear`` is no
eviction). ``evict_for(weight)`` makes room for an entry before it is
loaded, so a loader that allocates (a device copy) finds the memory freed
first; ``evict(weight, where)`` frees weight among the keys ``where``
accepts. Both go through one loop and one rule. With ``keep_weightless`` an entry that weighs nothing is never
evicted for weight (dropping it frees nothing): its owner invalidates it.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from ballista_tpu_torch.analysis import concurrency
from typing import Callable, Generic, Hashable, Optional, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LoadingCache(Generic[K, V]):
    def __init__(
        self,
        capacity: int | float,
        weigher: Optional[Callable[[V], float]] = None,
        eviction_listener: Optional[Callable[[K, V], None]] = None,
        keep_weightless: bool = False,
    ):
        self.capacity = capacity
        self.keep_weightless = keep_weightless
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
        self.evicted_weight = 0.0

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

    def invalidate_if(self, key: K, predicate: Callable[[V], bool]) -> None:
        """Drops ``key`` when its value satisfies ``predicate``."""
        with self._mu:
            if key in self._entries and predicate(self._entries[key]):
                self._pinned.discard(key)
                self._drop(key)

    def evict_for(self, weight: float) -> float:
        """Evicts unpinned entries, least recently used first, until an
        entry of ``weight`` fits under the capacity beside what stays;
        returns the weight evicted."""
        with self._mu:
            return self._evict(self._total - self._pinned_weight() + weight - self.capacity)

    def evict(self, weight: float, where: Optional[Callable[[K], bool]] = None) -> float:
        """Evicts unpinned entries whose keys ``where`` accepts (all when
        None), least recently used first, until ``weight`` has gone or none
        is left; returns the weight evicted."""
        with self._mu:
            return self._evict(weight, where=where)

    def clear(self) -> None:
        with self._mu:
            self._pinned.clear()
            for k in list(self._entries):
                self._drop(k)

    def __len__(self) -> int:
        return len(self._entries)

    def total_weight(self, where: Optional[Callable[[K], bool]] = None) -> float:
        """The weight held, of the keys ``where`` accepts when given."""
        if where is None:
            return self._total
        with self._mu:
            return sum(w for k, w in self._weights.items() if where(k))

    # ---- internals (call with lock held) -----------------------------------------
    @concurrency.guarded_by("_mu")
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
        pinned_w = self._pinned_weight()
        if pinned_w > self.capacity and not getattr(self, "_pin_warned", False):
            self._pin_warned = True
            import logging

            logging.getLogger("ballista.cache").warning(
                "pinned cache entries (%.1f MB) exceed the cache budget "
                "(%.1f MB); unpinned entries still get the full budget",
                pinned_w / 1e6, self.capacity / 1e6,
            )
        self._evict(self._total - pinned_w - self.capacity, keep=key)

    @concurrency.guarded_by("_mu")
    def _pinned_weight(self) -> float:
        return sum(self._weights.get(k, 0) for k in self._pinned) if self._pinned else 0

    @concurrency.guarded_by("_mu")
    def _evict(self, weight: float, keep=None, where=None) -> float:
        """Evicts least recently used entries (never a pinned one, nor
        ``keep``, nor one ``where`` refuses) until ``weight`` has gone;
        returns the weight evicted."""
        gone = 0.0
        if weight <= 0:
            return gone
        for k in [k for k in self._entries if k not in self._pinned and k != keep
                  and not (self.keep_weightless and self._weights[k] == 0)
                  and (where is None or where(k))]:
            if gone >= weight:
                break
            gone += self._weights[k]
            self.evicted_weight += self._weights[k]
            self._drop(k)
            self.evictions += 1
        return gone

    @concurrency.guarded_by("_mu")
    def _drop(self, key: K, notify: bool = True) -> None:
        v = self._entries.pop(key, None)
        if v is None:
            return
        self._total -= self._weights.pop(key, 0)
        if notify and self.eviction_listener is not None:
            self.eviction_listener(key, v)


class DiskFileCache:
    """Whole-file read-through cache on local disk, LRU by byte budget.

    Reference analog: the cache-layer's file medium
    (``arrow-ballista: ballista/core/src/cache_layer/medium/``): object-store
    files are copied next to the executor once and re-read locally; eviction
    drops least-recently-used files when the byte budget is exceeded.
    Concurrent fetches of one file coalesce (same discipline as
    ``LoadingCache.get_with``).
    """

    def __init__(
        self, directory: str, capacity_bytes: int = 16 * 1024**3,
        recent_grace_s: float = 60.0,
    ):
        import os

        self.dir = directory
        self.capacity = capacity_bytes
        # never evict files touched this recently: a returned path may not
        # have been opened by its reader yet
        self.recent_grace_s = recent_grace_s
        os.makedirs(directory, exist_ok=True)
        self._mu = threading.Lock()
        self._inflight: dict[str, threading.Event] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _local(self, url: str) -> str:
        import hashlib
        import os

        h = hashlib.sha1(url.encode()).hexdigest()
        base = os.path.basename(url) or "file"
        return os.path.join(self.dir, f"{h}-{base}")

    def get_local(self, url: str, fetch=None) -> str:
        """Local path for ``url``, fetching through the object-store registry
        (or ``fetch(url, local_path)``) on miss."""
        import os

        local = self._local(url)
        while True:
            with self._mu:
                if os.path.exists(local):
                    os.utime(local)  # LRU touch
                    self.hits += 1
                    return local
                ev = self._inflight.get(local)
                if ev is None:
                    self._inflight[local] = threading.Event()
                    break
            ev.wait()
        try:
            # unique temp per fetch: another PROCESS sharing this directory
            # may fetch the same URL concurrently (the in-process inflight map
            # cannot see it); each writes its own temp and the os.replace is
            # atomic, so the cached file is always one writer's complete bytes
            import tempfile

            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            os.close(fd)
            if fetch is not None:
                fetch(url, tmp)
            else:
                from ballista_tpu_torch.utils.object_store import GLOBAL_OBJECT_STORES

                fs, path = GLOBAL_OBJECT_STORES.resolve(url)
                with fs.open_input_stream(path) as src, open(tmp, "wb") as dst:
                    while True:
                        chunk = src.read(4 * 1024 * 1024)
                        if not chunk:
                            break
                        dst.write(chunk)
            os.replace(tmp, local)
        except BaseException:
            try:
                os.remove(tmp)  # failed fetch: do not orphan the unique temp
            except OSError:
                pass
            with self._mu:
                self._inflight.pop(local).set()
            raise
        with self._mu:
            self.misses += 1
            self._evict_locked(protect={local})
            self._inflight.pop(local).set()
        return local

    def _evict_locked(self, protect: set) -> None:
        import os
        import time as _time

        now = _time.time()
        entries = []
        total = 0
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            if not os.path.isfile(p):
                continue
            st = os.stat(p)
            if name.endswith(".tmp"):
                # in-progress fetches are recent; anything older is an orphan
                # from a crashed process — reclaim it
                if now - st.st_mtime > 3600:
                    try:
                        os.remove(p)
                    except OSError:
                        pass
                continue
            entries.append((st.st_atime, st.st_size, p))
            total += st.st_size
        entries.sort()
        for atime, size, p in entries:
            if total <= self.capacity:
                break
            if p in protect or p in self._inflight or now - atime < self.recent_grace_s:
                continue
            try:
                os.remove(p)
                total -= size
                self.evictions += 1
            except OSError:
                pass
