"""Host time launching the stage driver's device programs per query, in
ms (op.DeviceDispatch.time_s: each eager stage program's and fused
program's call until it returns, the waits inside it included)."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or "op.DeviceDispatch.time_s" not in e:
        return None
    return 1000 * e["op.DeviceDispatch.time_s"] / r["queries"]
