"""The executors' shuffle reads per query, in ms: the reader's own time over
every task's input pieces, local files and Flight fetches alike
(op.ShuffleRead.time_s, summed over the query's tasks). None where the
program never counted one."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or "op.ShuffleRead.time_s" not in e:
        return None
    return 1000 * e["op.ShuffleRead.time_s"] / r["queries"]
