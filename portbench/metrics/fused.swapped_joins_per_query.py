"""Fused partitioned joins per query that ran with their roles exchanged
(the left side sorted, the right side probing it: op.FusedJoin.swapped,
counted by the program once per such join); None where the program never
counted one."""


def read(r):
    e = r.get("engine") or {}
    if not r.get("queries") or "op.FusedJoin.swapped" not in e:
        return None
    return e["op.FusedJoin.swapped"] / r["queries"]
