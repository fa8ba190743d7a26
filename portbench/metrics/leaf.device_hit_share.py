"""Share of the device cache's lookups (the leaves' and fused inputs'
device copies) that hit over the window, counted by the program at each
lookup (op.LeafCache.device_hits and op.LeafCache.device_misses)."""


def read(r):
    e = r.get("engine") or {}
    hits = e.get("op.LeafCache.device_hits", 0.0)
    misses = e.get("op.LeafCache.device_misses", 0.0)
    if hits + misses <= 0:
        return None
    return 100 * hits / (hits + misses)
