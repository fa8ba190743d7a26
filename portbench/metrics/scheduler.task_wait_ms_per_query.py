"""The tasks' wait in the scheduler per query, in ms: each task's time from
its stage running (every input complete) to its hand-over to an executor,
summed over the query's tasks (op.TaskWait.time_s, folded by the scheduler
into the job's metrics). None where the program never counted one."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or "op.TaskWait.time_s" not in e:
        return None
    return 1000 * e["op.TaskWait.time_s"] / r["queries"]
