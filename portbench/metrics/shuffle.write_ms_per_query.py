"""The executors' shuffle writes per query, in ms: the split, the IPC
encode and the file writes of every task's pieces (op.ShuffleWrite.time_s,
summed over the query's tasks). None where the program never counted one."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or "op.ShuffleWrite.time_s" not in e:
        return None
    return 1000 * e["op.ShuffleWrite.time_s"] / r["queries"]
