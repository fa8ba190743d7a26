"""Planning per query, in ms (op.Plan.time_s: parsing, SQL planning, the
serving caches' lookups, the physical plan, the memory governor and the
engine's creation, all before the execution starts)."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or "op.Plan.time_s" not in e:
        return None
    return 1000 * e["op.Plan.time_s"] / r["queries"]
