"""Operating the PyTorch port: a drain mid-job, the REST API's drain route,
the CLI and the PyBallista shim.

- Two torch executors on ``device="cpu"`` in this process, behind the port's
  scheduler and REST API. A session fault slows one task of q3's first
  stage; ``PATCH /api/scale/drain/{executor}`` on the executor that holds it
  drains it mid-job. The job's rows equal a standalone run's, the executor
  shows ``terminating`` and is then stopped and removed, ``/api/metrics``
  counts the drain started and completed, and the surviving executor runs
  q5 alone with the standalone run's rows.
- ``python -m ballista_tpu_torch.client.cli`` in a subprocess: a ``-f``
  script over the port's TPC-H data with ``--device cpu`` returns q6's rows;
  without CUDA and without ``--device cpu`` it exits 2 naming the reason.
- ``pyballista.SessionContext(backend="torch")`` defaults to ``cuda`` and
  raises without it.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.client.standalone import start_standalone_cluster
from ballista_tpu_torch.config import BallistaConfig, SchedulerConfig
from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.models.tpch import TPCH_TABLES
from ballista_tpu_torch.scheduler.api import start_api_server

from test_torch_data import torch_tpch_dir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = os.path.join(REPO, "benchmarks", "queries")
SLOW = "task.execute:slow@delay=1.5:stage_id=1:partition=0"


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


def _register(ctx, data_dir: str):
    for t in TPCH_TABLES:
        ctx.register_parquet(t, os.path.join(data_dir, t))
    return ctx


def _get(port: int, route: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as r:
        body = r.read().decode()
    return json.loads(body) if route != "/api/metrics" else body


def _patch(port: int, route: str) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", method="PATCH")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read().decode())


def _metric(text: str, name: str) -> float:
    return next(float(ln.split()[-1]) for ln in text.splitlines() if ln.startswith(name + " "))


def _wait(cond, timeout: float, what: str):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _slow_task_holder(sched) -> str:
    """The executor running partition 0 of stage 1 of the active job."""
    with sched.tasks._lock:
        for g in sched.tasks.active_jobs():
            s = g.stages.get(1)
            t = s.task_infos[0] if s is not None and s.task_infos else None
            if t is not None and t.status == "running":
                return t.executor_id
    return ""


def test_drain_mid_job_keeps_the_rows_and_removes_the_executor(torch_tpch_dir, tmp_path):
    cluster = start_standalone_cluster(
        n_executors=2, task_slots=2, backend="torch", device="cpu",
        work_dir=str(tmp_path / "shuffle"), poll_interval_ms=10,
        scheduler_config=SchedulerConfig(expire_dead_executors_interval_seconds=0.1))
    sched = cluster.scheduler
    for p in cluster.executors:
        sched.scale.register_local(p.executor_id, p.stop)
    api = start_api_server(sched, "127.0.0.1", 0)
    port = api.server_address[1]
    # the undisturbed rows, from a standalone context: a job run on this
    # cluster first would leave result pieces that hold a drain for the
    # result-serve window (TaskManager.RESULT_SERVE_GRACE_S)
    alone = _register(BallistaContext.standalone(device="cpu"), torch_tpch_dir)
    want3, want5 = alone.sql(_sql("q3")).collect(), alone.sql(_sql("q5")).collect()
    try:
        plain = _register(BallistaContext.remote("127.0.0.1", cluster.scheduler_port),
                          torch_tpch_dir)
        slowed = _register(BallistaContext.remote(
            "127.0.0.1", cluster.scheduler_port, BallistaConfig({
                "ballista.faults.schedule": SLOW,
                # a cached exchange would skip the slowed stage
                "ballista.serving.exchange_cache": "false"})), torch_tpch_dir)
        got = {}
        job = threading.Thread(target=lambda: got.update(q3=slowed.sql(_sql("q3")).collect()))
        job.start()
        victim = _wait(lambda: _slow_task_holder(sched), 60, "the slowed task")
        t0 = time.time()
        assert _patch(port, f"/api/scale/drain/{victim}") == {"draining": True}
        states = {e["executor_id"]: e["status"] for e in _get(port, "/api/executors")}
        assert states[victim] == "terminating"
        assert _get(port, "/api/scale")["draining"][0]["executor_id"] == victim
        job.join(timeout=120)
        assert not job.is_alive()
        assert got["q3"].equals(want3)
        _wait(lambda: victim not in {e["executor_id"] for e in _get(port, "/api/executors")},
              60, "the drained executor's removal")
        drained_s = time.time() - t0
        metrics = _get(port, "/api/metrics")
        assert _metric(metrics, "scale_drains_started_total") == 1
        assert _metric(metrics, "scale_drains_completed_total") == 1
        assert drained_s < 60
        # the survivor runs the next job alone, on the torch engine
        assert plain.sql(_sql("q5")).collect().equals(want5)
        g = sched.tasks.get_job(plain.last_job_id)
        ran_on = {t.executor_id for s in g.stages.values() for t in s.task_infos
                  if t is not None}
        assert victim not in ran_on and len(ran_on) <= 1
        assert sum(s.stage_metrics.get("op.HostFallback.count", 0.0)
                   for s in g.stages.values()) == 0.0
    finally:
        api.shutdown()
        cluster.stop()


def test_drain_route_refuses_an_unknown_executor():
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    sched = SchedulerServer(SchedulerConfig())
    api = start_api_server(sched, "127.0.0.1", 0)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _patch(api.server_address[1], "/api/scale/drain/no-such-executor")
        assert err.value.code == 404
        assert json.loads(err.value.read().decode()) == {"draining": False}
    finally:
        api.shutdown()
        sched.stop()


# ---- the CLI -------------------------------------------------------------------------
def _cli(*args, script: str = "", tmp_path=None):
    cmd = [sys.executable, "-m", "ballista_tpu_torch.client.cli", *args]
    if script:
        path = tmp_path / "script.sql"
        path.write_text(script)
        cmd += ["-f", str(path)]
    return subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": REPO})


def test_cli_runs_a_script_on_the_cpu(torch_tpch_dir, tmp_path):
    import io

    import pyarrow.csv as pacsv

    script = f"CREATE EXTERNAL TABLE lineitem STORED AS PARQUET LOCATION " \
             f"'{os.path.join(torch_tpch_dir, 'lineitem')}';\n" + _sql("q6").strip().rstrip(";")
    out = _cli("--device", "cpu", "--format", "csv", script=script, tmp_path=tmp_path)
    assert out.returncode == 0, out.stderr
    # the script's last statement, q6, prints last: its header and one row
    csv = "\n".join(out.stdout.strip().splitlines()[-2:])
    got = pacsv.read_csv(io.BytesIO(csv.encode()))
    ctx = _register(BallistaContext.standalone(device="cpu"), torch_tpch_dir)
    assert got.equals(ctx.sql(_sql("q6")).collect())


def test_cli_without_cuda_exits_naming_the_reason():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the CLI runs on it")
    out = _cli("-c", "select 1")
    assert out.returncode == 2
    assert "CUDA is not available" in out.stderr and "device" in out.stderr


def test_pyballista_defaults_to_cuda(torch_tpch_dir, tmp_path):
    import pyarrow.parquet as pq

    from ballista_tpu_torch.pyballista import SessionContext
    from ballista_tpu_torch.utils.avro import write_avro

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the shim runs on it")
    with pytest.raises(BallistaError, match="CUDA is not available"):
        SessionContext(backend="torch")
    ctx = SessionContext(backend="torch", device="cpu")
    ctx.register_parquet("nation", os.path.join(torch_tpch_dir, "nation"))
    assert ctx.sql("select count(*) as n from nation").collect().to_pydict() == {"n": [25]}
    # an avro source through the shim: nation's rows, read back whole
    nation = pq.read_table(os.path.join(torch_tpch_dir, "nation"))
    write_avro(str(tmp_path / "nation.avro"), nation)
    got = ctx.read_avro(str(tmp_path / "nation.avro")).collect()
    assert got.to_pydict() == nation.to_pydict()
