"""Bytes both leaf caches evicted over the window per query, in GB
(op.LeafCache.evicted_bytes: encodings and device copies dropped for
weight; an invalidation is none). Read only from a program that counts
the device cache's lookups apart, so that no eviction reads 0."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or not any(k in e for k in ("op.LeafCache.device_hits",
                                                    "op.LeafCache.device_misses")):
        return None
    return e.get("op.LeafCache.evicted_bytes", 0.0) / 1e9 / r["queries"]
