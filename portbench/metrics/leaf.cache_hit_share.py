"""Share of the leaf caches' lookups (encodings and their device copies)
that hit over the window, counted by the program at each lookup
(op.LeafCache.hits and op.LeafCache.misses)."""


def read(r):
    e = r.get("engine") or {}
    hits, misses = e.get("op.LeafCache.hits", 0.0), e.get("op.LeafCache.misses", 0.0)
    if hits + misses <= 0:
        return None
    return 100 * hits / (hits + misses)
