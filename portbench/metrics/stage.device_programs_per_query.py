"""Device programs the stage driver ran per query (op.DeviceExecute.count)."""


def read(r):
    if not r["queries"] or "engine" not in r:
        return None
    return r["engine"].get("op.DeviceExecute.count", 0.0) / r["queries"]
