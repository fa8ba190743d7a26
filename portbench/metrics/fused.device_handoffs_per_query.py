"""Fused outputs per query that a device stage built its leaf from on the
device, without a fetch and a host encode (op.FusedOutput.device_handoffs,
counted by the program once per such output); None where the program never
counted one."""


def read(r):
    e = r.get("engine") or {}
    if not r.get("queries") or "op.FusedOutput.device_handoffs" not in e:
        return None
    return e["op.FusedOutput.device_handoffs"] / r["queries"]
