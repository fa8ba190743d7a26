"""Host encoding and host-to-device copies per query, in ms
(op.HostEncode.time_s + op.DeviceTransfer.time_s)."""


def read(r):
    if not r["queries"] or "engine" not in r:
        return None
    e = r["engine"]
    return 1000 * (e.get("op.HostEncode.time_s", 0.0)
                   + e.get("op.DeviceTransfer.time_s", 0.0)) / r["queries"]
