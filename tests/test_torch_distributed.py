"""The PyTorch port through its scheduler, executors and remote client.

Mirrors ``tests/test_distributed.py``: the port's cluster (scheduler plus
two torch executors on ``device="cpu"``, in this process, real gRPC and
Flight on localhost) against the JAX package's cluster (two ``numpy``
executors) on the same TPC-H data; q1, q3, q4, q5, q12, q13 and q17 return
the same rows. Ints, strings and dates compare exactly; float columns within
rtol 1e-6 (``assert_frames_match``, the JAX test's own tolerance: the JAX
host engine sums decimals in f64, the torch engine in scaled int64).

Beyond the mirror: stages above a shuffle read run on the torch engine
(``op.DeviceExecute.count``, ``op.CompiledStage.time_s``) with no host
fallback and report their grouped_sums calls; push mode; the fused inline
exchange sharing one engine per stage; a torch executor registered with the
JAX package's scheduler and a JAX-package numpy executor registered with the
port's (the wire is one); two executors started as OS processes
(``python -m ballista_tpu_torch.executor --backend torch --device cpu``),
stopped by SIGTERM with their work dirs removed.
"""
import os
import signal
import subprocess
import sys

import pytest

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.client.standalone import start_standalone_cluster
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.models.tpch import TPCH_TABLES

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_tpch_numpy import ORDERED, assert_frames_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = os.path.join(REPO, "benchmarks", "queries")


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


def _register(ctx, data_dir: str, tables=TPCH_TABLES):
    for t in tables:
        ctx.register_parquet(t, os.path.join(data_dir, t))
    return ctx


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = start_standalone_cluster(
        n_executors=2, task_slots=2, backend="torch", device="cpu",
        work_dir=str(tmp_path_factory.mktemp("torch-shuffle")),
    )
    yield c
    c.stop()


@pytest.fixture(scope="module")
def jax_cluster(tmp_path_factory):
    from ballista_tpu.client.standalone import start_standalone_cluster as jax_start

    c = jax_start(n_executors=2, task_slots=2, backend="numpy",
                  work_dir=str(tmp_path_factory.mktemp("jax-shuffle")))
    yield c
    c.stop()


@pytest.fixture(scope="module")
def rctx(cluster, torch_tpch_dir):
    return _register(BallistaContext.remote("127.0.0.1", cluster.scheduler_port),
                     torch_tpch_dir)


@pytest.fixture(scope="module")
def jax_rctx(jax_cluster, torch_tpch_dir):
    from ballista_tpu.client.context import BallistaContext as JaxContext

    return _register(JaxContext.remote("127.0.0.1", jax_cluster.scheduler_port),
                     torch_tpch_dir)


def _stage_is_heavy_over_shuffle(plan) -> bool:
    from ballista_tpu_torch.plan.physical import (
        HashAggregateExec, HashJoinExec, UnresolvedShuffleExec, walk_physical,
    )

    nodes = list(walk_physical(plan))
    return (any(isinstance(n, UnresolvedShuffleExec) for n in nodes)
            and any(isinstance(n, (HashAggregateExec, HashJoinExec)) for n in nodes))


def _last_job(scheduler, job_id: str):
    g = scheduler.tasks.get_job(job_id)
    assert g is not None, job_id
    return g


@pytest.mark.parametrize("qname", ["q1", "q3", "q4", "q5", "q12", "q13", "q17"])
def test_distributed_tpch_equals_the_jax_cluster(cluster, rctx, jax_rctx, qname):
    got = rctx.sql(_sql(qname)).collect().to_pandas()
    want = jax_rctx.sql(_sql(qname)).collect().to_pandas()
    assert_frames_match(got, want, qname in ORDERED, qname)
    g = _last_job(cluster.scheduler, rctx.last_job_id)
    fallbacks = sum(s.stage_metrics.get("op.HostFallback.count", 0.0)
                    for s in g.stages.values())
    assert fallbacks == 0.0, qname


@pytest.mark.parametrize("qname", ["q1", "q18"])
def test_torch_streamed_stage_runs_on_device(cluster, torch_tpch_dir, jax_rctx, qname):
    """The port's counterpart of test_jax_streamed_stage_runs_on_device:
    every aggregate or join stage above a shuffle read runs on the torch
    engine (``op.CompiledStage.time_s`` and ``op.DeviceExecute.count``), with
    no host fallback; q1's aggregate stages report their grouped_sums
    calls (one per aggregate over at most 32 groups)."""
    ctx = _register(BallistaContext.remote(
        "127.0.0.1", cluster.scheduler_port,
        BallistaConfig({"ballista.shuffle.ici": "false"})), torch_tpch_dir)
    got = ctx.sql(_sql(qname)).collect().to_pandas()
    assert_frames_match(got, jax_rctx.sql(_sql(qname)).collect().to_pandas(),
                        qname in ORDERED, qname)
    g = _last_job(cluster.scheduler, ctx.last_job_id)
    heavy = [s for s in g.stages.values() if _stage_is_heavy_over_shuffle(s.plan)]
    assert heavy, f"{qname}: no heavy post-shuffle stage"
    for s in heavy:
        m = s.stage_metrics
        assert m.get("op.CompiledStage.time_s", 0.0) > 0.0, (qname, s.stage_id, sorted(m))
        assert m.get("op.DeviceExecute.count", 0.0) > 0.0, (qname, s.stage_id)
    for s in g.stages.values():
        assert s.stage_metrics.get("op.HostFallback.count", 0.0) == 0.0, (qname, s.stage_id)
    if qname == "q1":
        from ballista_tpu_torch.plan.physical import HashAggregateExec, walk_physical

        # each of q1's aggregate stages that ran (the partial one may come
        # from the exchange cache, launching nothing) made grouped_sums calls
        ran = [s for s in g.stages.values() if not getattr(s, "from_cache", False)
               and any(isinstance(n, HashAggregateExec) for n in walk_physical(s.plan))]
        calls = [(s.stage_id, s.stage_metrics.get("op.GroupedSums.calls", 0.0)) for s in ran]
        assert ran and all(c > 0 for _, c in calls), calls


def test_remote_bad_column_fails_at_planning(rctx):
    from ballista_tpu_torch.errors import PlanningError

    with pytest.raises(PlanningError, match="unknown_col"):
        rctx.sql("select unknown_col from lineitem")


def test_session_props_forwarded_to_tasks(cluster, torch_tpch_dir):
    """Session settings reach the executors as task props and pick the
    engine per query: ``numpy`` here, so no task reports a grouped_sums
    count (a torch task always does)."""
    ctx = _register(BallistaContext.remote("127.0.0.1", cluster.scheduler_port, BallistaConfig(
        {"ballista.executor.backend": "numpy", "ballista.job.name": "props-test"})),
        torch_tpch_dir, ["nation"])
    out = ctx.sql("select count(*) as n from nation").collect().to_pydict()
    assert out == {"n": [25]}
    g = _last_job(cluster.scheduler, ctx.last_job_id)
    assert g.job_name == "props-test"
    assert all("op.GroupedSums.calls" not in s.stage_metrics for s in g.stages.values())


def test_push_mode_cluster(torch_tpch_dir, tmp_path_factory, jax_rctx):
    c = start_standalone_cluster(
        n_executors=2, task_slots=2, backend="torch", device="cpu", scheduling_policy="push",
        work_dir=str(tmp_path_factory.mktemp("torch-shuffle-push")),
    )
    try:
        ctx = _register(BallistaContext.remote("127.0.0.1", c.scheduler_port), torch_tpch_dir)
        got = ctx.sql(_sql("q3")).collect().to_pandas()
        assert_frames_match(got, jax_rctx.sql(_sql("q3")).collect().to_pandas(), False, "q3")
    finally:
        c.stop()


def test_coscheduled_fused_exchange_shares_one_engine(torch_tpch_dir, tmp_path_factory,
                                                     jax_rctx):
    """With ``ballista.tpu.fuse_exchange_max_rows`` set, q1's aggregate
    exchange stays inline: one stage runs scan and aggregate with one torch
    engine shared by its tasks (``Executor._engine_for``), then the merge."""
    c = start_standalone_cluster(
        n_executors=1, task_slots=2, backend="torch", device="cpu",
        work_dir=str(tmp_path_factory.mktemp("torch-shuffle-cosched")),
    )
    try:
        ctx = _register(BallistaContext.remote("127.0.0.1", c.scheduler_port, BallistaConfig(
            {"ballista.tpu.fuse_exchange_max_rows": "10000000"})), torch_tpch_dir)
        got = ctx.sql(_sql("q1")).collect().to_pandas()
        assert_frames_match(got, jax_rctx.sql(_sql("q1")).collect().to_pandas(), True, "q1")
        assert len(_last_job(c.scheduler, ctx.last_job_id).stages) == 2
    finally:
        c.stop()


def test_status_poll_survives_transient_rpc_failures(cluster, torch_tpch_dir, monkeypatch):
    import grpc

    from ballista_tpu_torch.client import remote as remote_mod

    real_stub_factory = remote_mod.scheduler_stub
    fail_budget = {"n": 3}

    class FlakyStatusStub:
        def __init__(self, stub):
            self._stub = stub

        def __getattr__(self, name):
            real = getattr(self._stub, name)
            if name != "GetJobStatus":
                return real

            def flaky(*a, **kw):
                if fail_budget["n"] > 0:
                    fail_budget["n"] -= 1
                    err = grpc.RpcError()
                    err.code = lambda: grpc.StatusCode.DEADLINE_EXCEEDED
                    raise err
                return real(*a, **kw)

            return flaky

    monkeypatch.setattr(remote_mod, "scheduler_stub",
                        lambda addr: FlakyStatusStub(real_stub_factory(addr)))
    ctx = _register(BallistaContext.remote("127.0.0.1", cluster.scheduler_port),
                    torch_tpch_dir, ["lineitem"])
    out = ctx.sql("SELECT l_returnflag, count(*) AS c FROM lineitem "
                  "GROUP BY l_returnflag ORDER BY l_returnflag").collect()
    assert out.num_rows == 3
    assert fail_budget["n"] == 0, "injected failures were never exercised"


# ---- one wire: each package's executors under the other's scheduler ----------------
def test_torch_executor_runs_q3_for_the_jax_scheduler(torch_tpch_dir, tmp_path, jax_rctx):
    from ballista_tpu.client.context import BallistaContext as JaxContext
    from ballista_tpu.config import SchedulerConfig as JaxSchedulerConfig
    from ballista_tpu.scheduler.server import SchedulerServer as JaxScheduler
    from ballista_tpu_torch.config import ExecutorConfig
    from ballista_tpu_torch.executor.process import ExecutorProcess

    sched = JaxScheduler(JaxSchedulerConfig())
    port = sched.start(0)
    ex = None
    try:
        ex = ExecutorProcess(ExecutorConfig(
            port=0, flight_port=0, scheduler_host="127.0.0.1", scheduler_port=port,
            task_slots=2, backend="torch", device="cpu", work_dir=str(tmp_path)),
            executor_id="torch-exec")
        ex.start()
        ctx = _register(JaxContext.remote("127.0.0.1", port), torch_tpch_dir)
        got = ctx.sql(_sql("q3")).collect().to_pandas()
        assert_frames_match(got, jax_rctx.sql(_sql("q3")).collect().to_pandas(), False, "q3")
        g = sched.tasks.get_job(ctx.last_job_id)
        assert {t.executor_id for s in g.stages.values() for t in s.task_infos
                if t is not None} == {"torch-exec"}
        assert sum(s.stage_metrics.get("op.DeviceExecute.count", 0.0)
                   for s in g.stages.values()) > 0
    finally:
        if ex is not None:
            ex.stop(grace=False)
        sched.stop()


def test_jax_numpy_executor_runs_q5_for_the_port_scheduler(torch_tpch_dir, tmp_path,
                                                           jax_rctx):
    from ballista_tpu.config import ExecutorConfig as JaxExecutorConfig
    from ballista_tpu.executor.process import ExecutorProcess as JaxExecutor
    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    sched = SchedulerServer(SchedulerConfig())
    port = sched.start(0)
    ex = None
    try:
        ex = JaxExecutor(JaxExecutorConfig(
            port=0, flight_port=0, scheduler_host="127.0.0.1", scheduler_port=port,
            task_slots=2, backend="numpy", work_dir=str(tmp_path)), executor_id="jax-exec")
        ex.start()
        ctx = _register(BallistaContext.remote("127.0.0.1", port), torch_tpch_dir)
        got = ctx.sql(_sql("q5")).collect().to_pandas()
        assert_frames_match(got, jax_rctx.sql(_sql("q5")).collect().to_pandas(), True, "q5")
        g = sched.tasks.get_job(ctx.last_job_id)
        assert {t.executor_id for s in g.stages.values() for t in s.task_infos
                if t is not None} == {"jax-exec"}
    finally:
        if ex is not None:
            ex.stop(grace=False)
        sched.stop()


# ---- executors as OS processes -----------------------------------------------------
def _start_executor(port: int, *extra: str) -> tuple:
    """``python -m ballista_tpu_torch.executor`` against the scheduler at
    ``port``; returns (process, its work dir) once it has started."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--backend", "torch",
         "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port), "--port", "0",
         "--task-slots", "2", "--poll-interval-ms", "20", "--log-level", "WARNING", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    assert "started" in line, (line, proc.stderr.read() if proc.poll() is not None else "")
    return proc, line.rsplit("work dir ", 1)[1].strip()


def test_executor_processes_run_q3_and_stop_cleanly(torch_tpch_dir, jax_rctx):
    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    sched = SchedulerServer(SchedulerConfig())
    port = sched.start(0)
    procs = []
    try:
        procs = [_start_executor(port, "--device", "cpu") for _ in range(2)]
        ctx = _register(BallistaContext.remote("127.0.0.1", port), torch_tpch_dir)
        got = ctx.sql(_sql("q3")).collect().to_pandas()
        assert_frames_match(got, jax_rctx.sql(_sql("q3")).collect().to_pandas(), False, "q3")
        assert len(sched.cluster.alive_executors()) == 2
        g = sched.tasks.get_job(ctx.last_job_id)
        heavy = [s for s in g.stages.values() if _stage_is_heavy_over_shuffle(s.plan)]
        assert heavy and all(s.stage_metrics.get("op.DeviceExecute.count", 0.0) > 0
                             for s in heavy)
    finally:
        for p, _ in procs:
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p, _ in procs]
        sched.stop()
    assert codes == [0, 0], [p.stderr.read()[-2000:] for p, _ in procs]
    for _, work_dir in procs:
        assert not os.path.exists(work_dir), work_dir


def test_scheduler_and_executor_processes_run_q1(torch_tpch_dir, jax_rctx):
    """``python -m ballista_tpu_torch.scheduler`` and one executor process:
    the remote client's q1 equals the JAX cluster's; both exit 0 on SIGTERM."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    sched = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.scheduler", "--bind-host", "127.0.0.1",
         "--bind-port", "0", "--log-level", "WARNING"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs = [sched]
    try:
        line = sched.stdout.readline()
        assert "listening on" in line, (line, sched.stderr.read() if sched.poll() else "")
        port = int(line.rsplit(":", 1)[1])
        ex, _ = _start_executor(port, "--device", "cpu")
        procs.append(ex)
        ctx = _register(BallistaContext.remote("127.0.0.1", port), torch_tpch_dir)
        got = ctx.sql(_sql("q1")).collect().to_pandas()
        assert_frames_match(got, jax_rctx.sql(_sql("q1")).collect().to_pandas(), True, "q1")
    finally:
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
        codes = [p.wait(timeout=60) for p in reversed(procs)]
    assert codes == [0] * len(procs), [p.stderr.read()[-2000:] for p in procs]
