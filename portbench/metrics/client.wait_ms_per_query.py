"""The client's time outside the job's run per query, in ms: each query's
wall (``sql()`` to the last row) less its job's run as the scheduler
reports it, accepted to done (op.Job.run_s). It holds the client's planning
and submit, the polls past the job's end and the result fetch. None where
the program never counted a job's run."""


def read(r):
    e = r.get("engine") or {}
    if not r["queries"] or "op.Job.run_s" not in e:
        return None
    return 1000 * (sum(r["latencies_s"]) - e["op.Job.run_s"]) / r["queries"]
