"""The PyTorch port stands alone: no jax, nothing of ballista_tpu.

``ballista_tpu_torch/`` and ``chip_smoke.py`` keep their own copies of what
they need; only the tests import both packages.
"""
import ast
import functools
import os
import re
import subprocess
import sys

import pytest
import torch

from test_torch_data import torch_tpch_dir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ballista_tpu_torch")


def _port_sources():
    for dp, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dp, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imports(path):
    """Every module an import statement names (top-level or inside a
    function), plus ``module.name`` for each ``from module import name``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, None
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                yield node.module, a.name


def _module_file(dotted: str):
    base = os.path.join(REPO, *dotted.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


@functools.lru_cache(maxsize=None)
def _top_level_names(path) -> frozenset:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return frozenset(names)


def test_no_jax_or_reference_imports_and_all_port_imports_resolve():
    assert os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    # the sub-packages of the shuffle and distributed slices are walked like the rest
    walked = {os.path.relpath(os.path.dirname(p), PORT) for p in _port_sources()}
    assert {"obs", "analysis", "shuffle", "scheduler", "utils", "engine",
            "executor", "client", "proto"} <= walked
    # and so are the inspection and operation surfaces
    files = {os.path.relpath(p, PORT) for p in _port_sources()}
    assert {"obs/explain.py", "obs/perfetto.py", "scheduler/api.py", "scheduler/ui.py",
            "scheduler/graph_dot.py", "scheduler/scale.py", "client/cli.py",
            "client/functions.py", "pyballista.py"} <= files
    # and the device mesh's modules
    assert {"parallel/flagship.py", "parallel/mesh.py", "parallel/ici.py",
            "engine/megastage.py"} <= files
    # and the mesh groups'
    assert "parallel/multihost.py" in files
    # and Flight SQL, avro, the durable HA state, the KEDA scaler and the
    # host shuffle partitioner
    assert {"scheduler/flight_sql.py", "scheduler/state_store.py", "scheduler/kv_service.py",
            "scheduler/etcd_gateway.py", "scheduler/external_scaler.py", "utils/avro.py",
            "native/__init__.py", "proto/flight_sql_pb2.py", "proto/kv_pb2.py",
            "proto/etcd_pb2.py", "proto/keda_pb2.py"} <= files
    # and the compile service, the linter and the proto drift check, which
    # complete the JAX package's module list
    assert {"engine/compile_service.py", "analysis/lint.py", "analysis/proto_drift.py",
            "tools/precompile_ab.py"} <= files
    bad = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        for module, name in _imports(path):
            top = module.split(".")[0]
            if top in ("jax", "jaxlib", "ballista_tpu"):
                bad.append(f"{rel}: imports {module}")
            elif top == "ballista_tpu_torch":
                src = _module_file(module)
                if src is None:
                    bad.append(f"{rel}: {module} is no file of the port")
                elif (name is not None and _module_file(f"{module}.{name}") is None
                      and name not in _top_level_names(src)):
                    bad.append(f"{rel}: {module} defines no {name}")
    assert not bad, "\n".join(bad)


_Q1_BLOCKED = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["ballista_tpu"] = None
sys.path.insert(0, {repo!r})
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.models.tpch import TPCH_TABLES
ctx = BallistaContext.standalone(device="cpu")
for t in TPCH_TABLES:
    ctx.register_parquet(t, os.path.join({data!r}, t))
q1 = open(os.path.join({repo!r}, "benchmarks", "queries", "q1.sql")).read()
out = ctx.sql(q1).collect()
m = ctx.last_engine_metrics
assert m.get("op.HostFallback.count", 0.0) == 0.0, m
print("ROWS", out.num_rows)

# a window on the device: the top line of every order
top = ctx.sql("select count(*) as n from (select row_number() over (partition by l_orderkey "
              "order by l_extendedprice desc, l_linenumber) as rn from lineitem) t "
              "where rn = 1").collect()
assert ctx.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
assert top.column("n")[0].as_py() == ctx.sql(
    "select count(distinct l_orderkey) as n from lineitem").collect().column("n")[0].as_py()

# q3 with its lineitem-orders join paged under a small budget
from ballista_tpu_torch.config import BallistaConfig
settings = {{"ballista.optimizer.broadcast_rows_threshold": "0",
            "ballista.tpu.ici_shuffle": "false", "ballista.engine.max_shuffle_partitions": "16"}}
q3 = open(os.path.join({repo!r}, "benchmarks", "queries", "q3.sql")).read()
runs = []
for budget in ("-1", "100000"):
    c = BallistaContext.standalone(
        BallistaConfig(dict(settings, **{{"ballista.engine.hbm_budget_bytes": budget}})),
        device="cpu")
    for t in TPCH_TABLES:
        c.register_parquet(t, os.path.join({data!r}, t))
    runs.append((c.sql(q3).collect(), c))
(plain, _), (paged, pc) = runs
assert paged.equals(plain)
pm = pc.last_engine_metrics
assert "paged" in [d.action for d in pc.last_memory_report.decisions]
assert pm["op.PagedJoin.count"] >= 1 and pm["op.PagedJoin.passes"] >= 2, pm
assert pm.get("op.HostFallback.count", 0.0) == 0.0, pm
print("PAGED", int(pm["op.PagedJoin.passes"]))

# q1 and a streamed final aggregate, stage by stage through shuffle files
import tempfile
import pyarrow as pa
from ballista_tpu_torch.engine.engine import create_engine
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
from ballista_tpu_torch.scheduler.planner import plan_query_stages, remove_unresolved_shuffles
from ballista_tpu_torch.shuffle.reader import read_shuffle_partition
from ballista_tpu_torch.shuffle.stream import write_shuffle_stream

def staged(sql):
    phys = PhysicalPlanner(ctx.catalog, ctx.config).plan(
        optimize(ctx.sql(sql).logical_plan(), ctx.catalog))
    work, locs, chunks, fallbacks = tempfile.mkdtemp(), {{}}, 0, 0
    stages = plan_query_stages("iso", phys)
    for stage in stages:
        plan = remove_unresolved_shuffles(stage, locs)
        outs = [[] for _ in range(plan.output_partitions())]
        for pid in range(plan.input_partitions()):
            eng = create_engine("torch", ctx.config, device="cpu")
            stats, _ = write_shuffle_stream(
                plan, pid, eng.execute_partition_stream(plan.input, pid), work)
            for s in stats:
                outs[s.output_partition].append(
                    {{"path": s.path, "host": "localhost", "flight_port": 0,
                     "executor_id": "local", "stage_id": plan.stage_id, "map_partition": pid}})
            chunks += eng.op_metrics.get("op.StreamChunk.count", 0.0)
            fallbacks += eng.op_metrics.get("op.HostFallback.count", 0.0)
        locs[plan.stage_id] = outs
    last = stages[-1]
    got = pa.concat_tables([read_shuffle_partition(l, last.schema()).to_arrow()
                            for l in locs[last.stage_id]])
    return got, len(stages), chunks, fallbacks

q1s, n_stages, _, fb = staged(q1)
assert n_stages == 3 and fb == 0 and q1s.equals(out), (n_stages, fb)
agg = ("select l_returnflag, l_linestatus, sum(l_extendedprice) as s, count(*) as n "
       "from lineitem group by l_returnflag, l_linestatus")
keys = [("l_returnflag", "ascending"), ("l_linestatus", "ascending")]
got, _, chunks, fb = staged(agg)
assert chunks > 0 and fb == 0, (chunks, fb)
assert got.sort_by(keys).equals(ctx.sql(agg).collect().sort_by(keys))
print("STAGED", int(chunks))

# q1 through the port's scheduler and two torch executors, by the remote client
from ballista_tpu_torch.client.standalone import start_standalone_cluster
cluster = start_standalone_cluster(n_executors=2, task_slots=2, device="cpu",
                                   work_dir=tempfile.mkdtemp())
try:
    rctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
    for t in TPCH_TABLES:
        rctx.register_parquet(t, os.path.join({data!r}, t))
    assert rctx.sql(q1).collect().equals(out)
    # precompile hints are on (the default): the executors handed the
    # scheduler's hints to the compile service, which drained them
    from ballista_tpu_torch.engine.compile_service import get_service
    assert get_service().wait_idle(60)
    hints = get_service().stats()
    assert hints["hint_submitted"] > 0 and hints["hint_failed"] == 0, hints
    graph = cluster.scheduler.tasks.get_job(rctx.last_job_id)
    ran = sum(s.stage_metrics.get("op.DeviceExecute.count", 0.0) for s in graph.stages.values())
    assert ran > 0 and all(s.stage_metrics.get("op.HostFallback.count", 0.0) == 0.0
                           for s in graph.stages.values())
    print("REMOTE", len(graph.stages))

    # q1 as a Flight SQL statement, fetched from the executors' endpoints
    import json
    import pyarrow.flight as flight
    from ballista_tpu_torch.proto import flight_sql_pb2 as fsql
    from ballista_tpu_torch.scheduler.flight_sql import SchedulerFlightService, pack_any
    svc = SchedulerFlightService(cluster.scheduler, "127.0.0.1", 0)
    svc.serve_background()
    client = flight.connect("grpc://127.0.0.1:%d" % svc.port)
    try:
        for t in TPCH_TABLES:
            list(client.do_action(flight.Action("register_parquet", json.dumps(
                {{"name": t, "path": os.path.join({data!r}, t)}}).encode())))
        info = client.get_flight_info(flight.FlightDescriptor.for_command(
            pack_any(fsql.CommandStatementQuery(query=q1))))
        parts = []
        for ep in info.endpoints:
            direct = flight.connect(ep.locations[0].uri.decode())
            parts.append(direct.do_get(ep.ticket).read_all())
            direct.close()
        assert pa.concat_tables(parts).equals(out)
    finally:
        client.close()
        svc.shutdown()
    print("FLIGHTSQL", len(info.endpoints))
finally:
    cluster.stop()

# q1 over an avro source, equal to q1 over the same rows from Arrow
import pyarrow.parquet as pq
from ballista_tpu_torch.utils.avro import write_avro
rows = pq.read_table(os.path.join({data!r}, "lineitem"), columns=[
    "l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
    "l_linestatus", "l_shipdate"]).slice(0, 4096)
avro_path = os.path.join(tempfile.mkdtemp(), "lineitem.avro")
write_avro(avro_path, rows)
actx, arrow_ctx = BallistaContext.standalone(device="cpu"), BallistaContext.standalone(device="cpu")
actx.register_avro("lineitem", avro_path)
arrow_ctx.register_arrow("lineitem", rows)
got = actx.sql(q1).collect()
assert got.num_rows == 4 and got.equals(arrow_ctx.sql(q1).collect())
assert actx.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
import ballista_tpu_torch.scheduler.kv_service, ballista_tpu_torch.scheduler.etcd_gateway
import ballista_tpu_torch.scheduler.external_scaler, ballista_tpu_torch.native
print("AVRO", got.num_rows)

# EXPLAIN VERIFY and ANALYZE, and the inspection and operation surfaces
verified = ctx.sql("EXPLAIN VERIFY " + q1).collect().to_pydict()
assert "error" not in verified["severity"], verified
text = ctx.sql("EXPLAIN ANALYZE " + q1).collect().to_pydict()["plan"][0]
assert "device: compile_ms=0.000 execute_ms=" in text, text
import ballista_tpu_torch.client.cli, ballista_tpu_torch.client.functions
import ballista_tpu_torch.pyballista, ballista_tpu_torch.scheduler.api
import ballista_tpu_torch.scheduler.graph_dot, ballista_tpu_torch.scheduler.scale
import ballista_tpu_torch.scheduler.ui, ballista_tpu_torch.obs.perfetto
import ballista_tpu_torch.tools.precompile_ab
from ballista_tpu_torch.analysis import lint, proto_drift
assert lint.main([os.path.join({repo!r}, "ballista_tpu_torch")]) == 0
assert all(not p for p in proto_drift.check_all().values())
print("EXPLAIN", len(ctx.last_trace_spans))

# q1 fused over a mesh of two shards on the CPU: one program, two threads
from ballista_tpu_torch import parallel
prev = parallel.force_mesh_shards(2)
try:
    mctx = BallistaContext.standalone(device="cpu")
    for t in TPCH_TABLES:
        mctx.register_parquet(t, os.path.join({data!r}, t))
    assert mctx.sql(q1).collect().equals(out)
    mm = mctx.last_engine_metrics
    assert mm["op.FusedIciExchange.count"] > 0 and "op.FusedDeclined.count" not in mm, mm
finally:
    parallel.force_mesh_shards(prev)
print("MESH", 2)

# the fused aggregate across a mesh group of two processes (this one and a
# second, jax and the JAX package blocked in both), 2 shards each
import socket, subprocess
sys.path.insert(0, os.path.join({repo!r}, "tests"))
import torch_multihost_worker as W
with socket.socket() as sock:
    sock.bind(("127.0.0.1", 0))
    coordinator = "127.0.0.1:%d" % sock.getsockname()[1]
group_dir = tempfile.mkdtemp()
member = ("import runpy, sys; sys.modules['jax'] = None; sys.modules['ballista_tpu'] = None; "
          "sys.argv = ['w', '1', '2', %r, %r, %r, 'agg']; "
          "runpy.run_path(%r, run_name='__main__')" % (
              coordinator, {data!r}, group_dir,
              os.path.join({repo!r}, "tests", "torch_multihost_worker.py")))
peer = subprocess.Popen([sys.executable, "-c", member], cwd={repo!r})
sys.argv = ["w", "0", "2", coordinator, {data!r}, group_dir, "agg"]
W.main()
assert peer.wait(timeout=120) == 0
import pyarrow.parquet as pq
union = pa.concat_tables([pq.read_table(os.path.join(group_dir, "agg-%d.parquet" % i))
                          for i in (0, 1)])
want = ctx.sql(W.AGG_SQL).collect()
keys = [(f.name, "ascending") for f in want.schema][:2]
assert union.num_rows == want.num_rows == 4
assert union.rename_columns(want.column_names).sort_by(keys).equals(want.sort_by(keys))
print("GROUP", 2)
assert not any(k == "jax" or k.startswith(("jax.", "ballista_tpu."))
               for k, v in sys.modules.items() if v is not None)
"""


def test_leaf_cache_policy_has_one_owner():
    """``engine/leaf_cache.py`` owns the leaf caches' policy: it imports
    neither ``torch_engine`` nor ``fused_exchange`` (the arrows point one
    way), and no other port module spells the tags of its derived entries
    or pins, unpins, invalidates or evicts a leaf cache."""
    store = os.path.join(PORT, "engine", "leaf_cache.py")
    named = {m for m, _ in _imports(store)} | {f"{m}.{n}" for m, n in _imports(store) if n}
    assert not [m for m in named if m.split(".")[-1] in ("torch_engine", "fused_exchange")]
    tag = re.compile(r"""["']fused_(in|dev|jb|jb_dev)["']""")
    caches = {"ENC", "DEV", "_ENC_CACHE", "_DEV_CACHE"}
    for path in _port_sources():
        if path == store:
            continue
        with open(path) as f:
            src = f.read()
        assert not tag.search(src), path
        for node in ast.walk(ast.parse(src, path)):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("pin", "unpin", "invalidate", "invalidate_if",
                                           "evict_for")):
                receiver = ast.unparse(node.func.value).split(".")[-1]
                assert receiver not in caches, (path, node.lineno)


def test_q1_runs_with_jax_and_reference_blocked(torch_tpch_dir):
    """q1, a device window, a paged q3 join, q1 and a streamed final
    aggregate stage by stage through shuffle files, q1 through the port's
    scheduler and two executors by the remote client and as a Flight SQL
    statement (precompile hints on), q1 over an avro source, EXPLAIN VERIFY
    and ANALYZE of q1, the REST API, scale controller, CLI, shim, kv, etcd,
    KEDA, native and precompile A/B modules, the linter and the proto drift
    check over the port, q1 fused over a mesh of two shards, and a fused aggregate across
    a mesh group of two processes, with JAX and the JAX package
    unimportable."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _Q1_BLOCKED.format(repo=REPO, data=torch_tpch_dir)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ROWS 4" in proc.stdout and "PAGED" in proc.stdout and "STAGED" in proc.stdout
    assert "REMOTE" in proc.stdout and "EXPLAIN" in proc.stdout and "MESH 2" in proc.stdout
    assert "GROUP 2" in proc.stdout and "FLIGHTSQL" in proc.stdout and "AVRO 4" in proc.stdout


def test_standalone_defaults_to_cuda_and_raises_without_it():
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.errors import ExecutionError

    if torch.cuda.is_available():
        assert BallistaContext.standalone().device.startswith("cuda")
        return
    with pytest.raises(ExecutionError, match="CUDA is not available"):
        BallistaContext.standalone()
    assert BallistaContext.standalone(device="cpu").device == "cpu"
    assert BallistaContext.standalone(backend="numpy").device is None


def test_unknown_backend_rejected():
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.errors import BallistaError

    with pytest.raises(BallistaError, match="unknown backend"):
        BallistaContext.standalone(backend="jax")


def test_executor_process_without_cuda_exits_with_a_reason():
    """``python -m ballista_tpu_torch.executor`` with no card and no
    ``--device cpu``: exit status 2 and the reason on stderr, never a quiet
    start on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the executor would start on it")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--scheduler-port", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, (proc.returncode, proc.stderr[-2000:])
    assert "CUDA is not available" in proc.stderr


def test_scheduler_process_serves_the_rest_api():
    """``python -m ballista_tpu_torch.scheduler --api-port N`` serves the
    REST API on port N, and stops on SIGTERM."""
    import json
    import signal
    import socket
    import time
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        api_port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.scheduler", "--bind-host", "127.0.0.1",
         "--bind-port", "0", "--api-port", str(api_port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        state, deadline = None, time.time() + 60
        while state is None and time.time() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{api_port}/api/state",
                                            timeout=5) as r:
                    state = json.loads(r.read().decode())
            except OSError:
                time.sleep(0.1)
        assert state is not None, proc.stderr.read()[-2000:] if proc.poll() is not None else ""
        assert state["executors"] == 0 and state["active_jobs"] == 0
        assert state["started"].startswith("sched-")
    finally:
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=60)
    assert code == 0, proc.stderr.read()[-2000:]
