"""The cluster's layers, counted, over a scheduler in this process and two
torch executor processes on the CPU (SF 0.01).

Each executor runs in a directory of its own with a work directory relative
to it, so a piece the other executor wrote is fetched over Flight, as
between two hosts, and the client fetches every result over Flight. A remote
query's ``last_engine_metrics`` then holds the scheduler's task waits
(``op.TaskWait``), the executors' shuffle writes and reads
(``op.ShuffleWrite``, ``op.ShuffleRead``), the client's submit, polls and
fetch (``op.ClientSubmit``, ``op.ClientPoll``, ``op.ResultFetch``) and the
job's run (``op.Job.run_s``). TPC-H's slice answers through the cluster as
``test_torch_tpch.py`` holds the standalone engine: with drawn clause 2.4
literals against the JAX package's engine (and the port's host engine), and
with the queries' own literals against the JAX engine and the pandas oracle.
"""
import importlib.util
import os
import subprocess
import sys
import time

import pytest

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig, SchedulerConfig
from ballista_tpu_torch.scheduler.server import SchedulerServer

from test_torch_data import torch_oracle_tables, torch_tpch_dir  # noqa: F401
from test_tpch_numpy import ORDERED, assert_frames_match
from tpch_oracle import ORACLES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = os.path.join(REPO, "benchmarks", "queries")
TABLES = ("region", "nation", "supplier", "customer", "orders", "lineitem")
ROTATION = ("q1", "q6", "q3", "q5", "q12")
START_S = 120.0


def _traffic():
    """The benchmark's traffic generator (numpy alone): the queries' SQL
    templates and their clause 2.4 grids."""
    path = os.path.join(REPO, "portbench", "traffic.py")
    spec = importlib.util.spec_from_file_location("portbench_traffic_for_tests", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass looks its module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cluster(torch_tpch_dir, tmp_path_factory):  # noqa: F811
    sched = SchedulerServer(SchedulerConfig())
    port = sched.start(0)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []
    try:
        for i in range(2):
            cwd = tmp_path_factory.mktemp(f"executor{i}")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ballista_tpu_torch.executor", "--backend", "torch",
                 "--device", "cpu", "--task-slots", "1", "--scheduler-host", "127.0.0.1",
                 "--scheduler-port", str(port), "--port", "0", "--work-dir", "work",
                 "--log-level", "WARNING"],
                cwd=str(cwd), env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                stdin=subprocess.DEVNULL, text=True))
        deadline = time.time() + START_S
        while len(sched.cluster.alive_executors()) < 2:
            dead = [p for p in procs if p.poll() is not None]
            assert not dead, dead[0].stderr.read()[-2000:]
            assert time.time() < deadline, "executors did not register"
            time.sleep(0.05)
        ctx = BallistaContext.remote("127.0.0.1", port, BallistaConfig(
            {"ballista.shuffle.partitions": "4"}))
        for t in TABLES:
            ctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
        yield sched, ctx
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
        sched.stop()


@pytest.fixture(scope="module")
def jctx(torch_tpch_dir):  # noqa: F811
    """The reference: the JAX package's standalone engine on the same data."""
    c = JaxContext.standalone(backend="jax")
    for t in TABLES:
        c.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return c


@pytest.fixture(scope="module")
def host_oracle(torch_tpch_dir):  # noqa: F811
    ctx = BallistaContext.standalone(BallistaConfig({"ballista.shuffle.partitions": "4"}),
                                     backend="numpy")
    for t in TABLES:
        ctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return ctx


def _written_piece_bytes(graph) -> int:
    return sum(int(loc.get("num_bytes", 0)) for s in graph.stages.values()
               for t in s.task_infos if t is not None and t.status == "success"
               for loc in t.locations)


def test_a_remote_query_reads_every_layers_counters(cluster):
    """One slot an executor: a stage's tasks spread over both, and a task
    reading a piece the other wrote fetches it over Flight
    (``op.ShuffleRead.remote_bytes``). A job the first poll took whole
    reads nothing remotely, so a few jobs (fresh literals) are sent until
    one spread."""
    sched, ctx = cluster
    traffic = _traffic()
    spec = traffic.query_spec("q3")
    for day in range(1, 9):
        sql = traffic.instance("q3", spec, {"SEGMENT": "MACHINERY",
                                            "DATE": f"1995-03-{day:02d}"}).sql
        ctx.sql(sql).collect()
        m = ctx.last_engine_metrics
        if m.get("op.ShuffleRead.remote_bytes", 0.0) > 0:
            break
    for key in ("op.TaskWait.time_s", "op.TaskWait.count", "op.ShuffleWrite.time_s",
                "op.ShuffleWrite.bytes", "op.ShuffleWrite.pieces", "op.ShuffleRead.time_s",
                "op.ShuffleRead.bytes", "op.ShuffleRead.remote_bytes", "op.ClientSubmit.time_s",
                "op.ClientPoll.count", "op.ClientPoll.time_s", "op.ResultFetch.time_s",
                "op.ResultFetch.bytes", "op.Job.run_s"):
        assert m.get(key, 0.0) > 0, (key, sorted(m))
    graph = sched.tasks.get_job(ctx.last_job_id)
    assert m["op.ShuffleWrite.bytes"] == _written_piece_bytes(graph)
    assert m["op.TaskWait.count"] == sum(
        1 for s in graph.stages.values() for t in s.task_infos if t is not None)
    assert m["op.ShuffleRead.remote_bytes"] <= m["op.ShuffleRead.bytes"]
    # the job ran inside the client's wait for it
    assert m["op.Job.run_s"] <= m["op.ClientSubmit.time_s"] + m["op.ClientPoll.time_s"]


@pytest.mark.parametrize("qname", ROTATION)
def test_drawn_literals_answer_as_the_host_engine(cluster, jctx, host_oracle, qname):
    """Drawn clause 2.4 literals (the cell's traffic): the cluster's rows
    equal the JAX package's engine's on the same SQL, and the port's host
    engine's."""
    _sched, ctx = cluster
    traffic = _traffic()
    spec = traffic.query_spec(qname)
    params = traffic.ordered_grid(spec, 2**31 + 23, qname)[0] if "qgen" in spec else {}
    sql = traffic.instance(qname, spec, params).sql
    ordered = qname in ORDERED or qname == "q3"
    got = ctx.sql(sql).collect().to_pandas()
    want = jctx.sql(sql).collect().to_pandas()
    assert len(want) > 0, (qname, params)
    assert_frames_match(got, want, ordered, f"{qname} {params} vs jax")
    assert_frames_match(got, host_oracle.sql(sql).collect().to_pandas(), ordered,
                        f"{qname} {params} vs host engine")


@pytest.mark.parametrize("qname", ROTATION)
def test_slice_through_the_cluster_matches_jax_engine_and_oracle(cluster, jctx,
                                                                 torch_oracle_tables, qname):  # noqa: F811
    """The queries' own literals: the cluster's rows equal the JAX engine's
    and the pandas oracle's, as ``test_torch_tpch.py`` holds a standalone
    engine."""
    _sched, ctx = cluster
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        sql = f.read()
    got = ctx.sql(sql).collect().to_pandas()
    assert_frames_match(got, jctx.sql(sql).collect().to_pandas(), qname in ORDERED,
                        f"{qname} vs jax")
    assert_frames_match(got, ORACLES[qname](torch_oracle_tables), qname in ORDERED, qname)
