"""Waits of the host on the card per query (op.DeviceWait.count: each
synchronize of the stage driver, its copies and fetches, and each
valid-row count a compacted fetch reads). A program that counts its
dispatches counts its waits too, so no wait reads 0 (as on the CPU)."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or "op.DeviceDispatch.count" not in e:
        return None
    return e.get("op.DeviceWait.count", 0.0) / r["queries"]
