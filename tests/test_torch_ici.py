"""The port's fused exchanges over a mesh of eight shards and the exchanges
the port's scheduler promotes onto it, against the JAX package on the CPU.

* The fused aggregate and the fused join over eight ``cpu`` shards
  (``force_mesh_shards(8)``) against the JAX engine over the conftest's
  8-device mesh: TPC-H q1, q3, q5 and q12 with every join partitioned, rows
  byte for byte, the same ``op.FusedIciExchange/FusedIciJoin/FusedDeclined``
  counts but for q12's join, which the port runs with its roles exchanged
  (``op.FusedJoin.swapped``) where the JAX engine declines it, no host
  fallback.
* A shard that fails inside the program: a counted decline (the
  materialized exchange runs, rows exact) for an exchange the engine fused
  by its own choice, ``IciDemoted`` for a promoted one.
* The cases of ``tests/test_ici_shuffle.py`` that apply to the torch engine,
  beside their JAX counterparts: a torch executor on the 8-shard mesh
  registers as a fat executor; ``AGG_SQL`` and the partitioned ``JOIN_SQL``
  are promoted, run in fewer stages than with ``ballista.shuffle.ici=false``
  and return its rows byte for byte; an injected ``ici.exchange`` fault
  demotes onto the Flight tier with the same rows and one more stage; the
  engine's knob off and a budget the exchange exceeds demote at trace time.
"""
import os
import time

import numpy as np
import pandas as pd
import pytest

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.models.tpch import TPCH_TABLES
from ballista_tpu_torch import parallel
from ballista_tpu_torch.client.catalog import Catalog
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.client.standalone import start_standalone_cluster
from ballista_tpu_torch.config import BALLISTA_SHUFFLE_PARTITIONS, BallistaConfig
from ballista_tpu_torch.engine.engine import create_engine
from ballista_tpu_torch.errors import IciDemoted
from ballista_tpu_torch.executor.process import _device_inventory
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
from ballista_tpu_torch.scheduler.execution_graph import SUCCESSFUL
from ballista_tpu_torch.scheduler.planner import promote_ici_exchanges
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import SqlPlanner

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_fused import _sql, assert_fused_like_jax, jax_declines  # noqa: F401
from test_torch_joins import _cold_leaf_caches, _host_ops

pytestmark = pytest.mark.ici

MESH = 8


@pytest.fixture(scope="module")
def mesh8():
    """The process's mesh is eight shards for the module (process-wide, so
    restored after it)."""
    prev = parallel.force_mesh_shards(MESH)
    yield MESH
    parallel.force_mesh_shards(prev)


# ---- the fused programs over eight shards against the JAX engine over eight devices -------
@pytest.fixture(scope="module")
def mesh_ctxs(mesh8, torch_tpch_dir):
    """(torch, jax) contexts with every join partitioned; the JAX engine on
    its default mesh, the conftest's eight CPU devices."""
    t = BallistaContext.standalone(device="cpu")
    j = JaxContext.standalone(backend="jax")
    for c in (t, j):
        c.config.set("ballista.optimizer.broadcast_rows_threshold", 0)
        for name in TPCH_TABLES:
            c.register_parquet(name, os.path.join(torch_tpch_dir, name))
    return t, j


@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q12"])
def test_fused_programs_over_eight_shards_match_the_jax_engine(mesh_ctxs, jax_declines,
                                                               qname):
    """q1 fuses its final aggregate (16 partitions), q3 that and its 2
    partitioned joins, q5 4 of its joins (2 decline: both sides' keys
    repeat), q12 its aggregate and its join, with the roles exchanged
    (lineitem's order keys repeat, orders' are unique), where the JAX engine
    declines the join."""
    tctx, jctx = mesh_ctxs
    _cold_leaf_caches()
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    tm = dict(tctx.last_engine_metrics)
    want = jctx.sql(_sql(qname)).collect().to_pandas()
    jm = jctx.last_engine_metrics
    pd.testing.assert_frame_equal(got, want)
    assert_fused_like_jax(tm, jm, jax_declines[0], int(qname == "q12"))
    assert tm.get("op.FusedIciExchange.count", 0.0) == 16
    assert _host_ops(tm) == _host_ops(jm)
    assert tm.get("op.HostFallback.count", 0.0) == 0.0


def _fail_on_shard(monkeypatch, rank: int):
    """The key mix raises on mesh shard ``rank``'s thread (an injected
    fault inside the program), and only there."""
    import threading

    real = KT.splitmix64_dev

    def mix(x):
        if threading.current_thread().name == f"mesh-shard-{rank}":
            raise RuntimeError(f"injected fault on shard {rank}")
        return real(x)

    monkeypatch.setattr(KT, "splitmix64_dev", mix)


def test_a_failing_shard_is_a_counted_decline(mesh_ctxs, monkeypatch):
    """Shard 3 raises inside the fused aggregate: the program fails as a
    whole within the collective's bound (its peers stop waiting at once),
    the decline is counted, and the materialized exchange gives the rows."""
    tctx, _ = mesh_ctxs
    want = tctx.sql(_sql("q1")).collect()
    _fail_on_shard(monkeypatch, 3)
    t0 = time.time()
    got = tctx.sql(_sql("q1")).collect()
    assert time.time() - t0 < 60.0
    m = tctx.last_engine_metrics
    assert got.equals(want)
    assert m.get("op.FusedDeclined.count") == 1.0 and "op.FusedIciExchange.count" not in m
    assert m.get("op.HostFallback.count", 0.0) == 0.0


# ---- promoted exchanges in the engine -------------------------------------------------------
def _agg_plan(partitions: int = 2):
    cat = Catalog()
    rng = np.random.default_rng(0)
    batch = ColumnBatch.from_dict(
        {"k": rng.integers(0, 10, 100).astype(np.int64), "v": rng.random(100)})
    cat.register_batches("t", [batch.slice(i * 25, 25) for i in range(4)], batch.schema)
    logical = SqlPlanner(cat.schemas()).plan(parse_sql("select k, sum(v) from t group by k"))
    cfg = BallistaConfig({BALLISTA_SHUFFLE_PARTITIONS: str(partitions)})
    return PhysicalPlanner(cat, cfg).plan(optimize(logical))


def _promoted_agg():
    plan, n = promote_ici_exchanges(_agg_plan(), ici_devices=MESH)
    assert n == 1
    return plan


def _frame(batches):
    return ColumnBatch.concat(batches).to_pandas().sort_values("k").reset_index(drop=True)


def test_promoted_exchange_runs_as_a_collective(mesh8):
    eng = create_engine("torch", BallistaConfig(), device="cpu")
    assert eng.mesh_devices == MESH
    got = _frame(eng.execute_all(_promoted_agg()))
    m = eng.op_metrics
    assert m["op.IciExchange.count"] == 1 and m["op.IciExchange.bytes_hbm"] > 0
    assert m["op.IciExchange.collective_time_s"] > 0 and m["op.FusedIciExchange.count"] == 2
    want = _frame(create_engine("numpy", BallistaConfig()).execute_all(_agg_plan()))
    pd.testing.assert_frame_equal(got, want, check_dtype=False)


@pytest.mark.parametrize("settings,reason", [
    ({"ballista.tpu.ici_shuffle": "false"}, "engine ICI shuffle disabled"),
    ({"ballista.engine.hbm_budget_bytes": "1"}, "hbm_budget"),
], ids=["knob-off", "hbm-budget"])
def test_promoted_exchange_declines_demote(mesh8, settings, reason):
    """A promoted exchange the engine will not run as a collective raises
    ``IciDemoted`` naming it, never a silent host run."""
    eng = create_engine("torch", BallistaConfig(settings), device="cpu")
    with pytest.raises(IciDemoted, match=r"ICI_DEMOTE\[1\]: " + reason):
        eng.execute_all(_promoted_agg())


def test_a_failing_shard_demotes_a_promoted_exchange(mesh8, monkeypatch):
    _fail_on_shard(monkeypatch, 5)
    eng = create_engine("torch", BallistaConfig(), device="cpu")
    with pytest.raises(IciDemoted, match=r"ICI_DEMOTE\[1\]: collective aggregate declined"):
        eng.execute_all(_promoted_agg())
    assert eng.op_metrics.get("op.FusedDeclined.count") == 1.0


# ---- through the port's scheduler on the 8-shard mesh ------------------------------------------
AGG_SQL = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "count(*) as n from lineitem group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus"
)
# q5-class partitioned join (PK-FK on orderkey) + aggregate above it
JOIN_SQL = (
    "select o_orderpriority, count(*) as n, sum(l_extendedprice) as rev "
    "from lineitem join orders on l_orderkey = o_orderkey "
    "group by o_orderpriority order by o_orderpriority"
)


def test_executor_reports_its_mesh(mesh8):
    assert _device_inventory("torch", "cpu") == (MESH, "cpu", f"1x{MESH}")
    assert _device_inventory("numpy", None) == (0, "cpu", "")


def test_scheduler_splits_the_card_budget_between_registered_shards(torch_tpch_dir):
    """An executor that registers four shards of an H100 (mesh shape
    ``"1x4"``) makes the scheduler admit and promote against a quarter of
    the card's budget: the split the engine makes from its own mesh
    (``MM.shard_budget_bytes``), not the whole card's."""
    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.engine import memory_model as MM
    from ballista_tpu_torch.parallel.mesh import shards_per_card_of
    from ballista_tpu_torch.proto import ballista_pb2 as pb
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    h100 = "NVIDIA H100 80GB HBM3"
    card = MM.budget_from_device_kinds({h100})
    assert MM.budget_from_device_kinds({h100}, 4) == MM.shard_budget_bytes(card, 4) == card // 4
    assert [shards_per_card_of(s) for s in ("1x4", "2x2", "8", "", "1x0")] == [4, 2, 1, 1, 1]
    server = SchedulerServer(SchedulerConfig())
    spec = pb.ExecutorSpecification(task_slots=2, num_devices=4, device_kind=h100,
                                    mesh_shape="1x4")
    server.register_executor(pb.RegisterExecutorParams(metadata=pb.ExecutorMetadata(
        id="e1", host="127.0.0.1", port=1, flight_port=2, specification=spec)), None)
    assert server.cluster.max_shards_per_card() == 4
    cat = Catalog()
    for t in TPCH_TABLES:
        cat.register_parquet(t, os.path.join(torch_tpch_dir, t))
    server._plan_and_submit("job-m", "sess", "sql", AGG_SQL,
                            [m.to_dict() for m in cat.tables.values()], {})
    g = server.tasks.get_job("job-m")
    assert g.memory_report is not None and g.memory_report.budget_bytes == card // 4
    assert g.ici_promoted >= 1


@pytest.fixture(scope="module")
def ici_cluster(mesh8, tmp_path_factory):
    c = start_standalone_cluster(
        n_executors=1, task_slots=2, device="cpu",
        work_dir=str(tmp_path_factory.mktemp("shuffle-ici")))
    yield c
    c.stop()


def _ctx(cluster, tpch_dir, settings):
    ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
    ctx.config = BallistaConfig(settings)
    for t in TPCH_TABLES:
        ctx.register_parquet(t, os.path.join(tpch_dir, t))
    return ctx


def _last_graph(cluster):
    return cluster.scheduler.tasks.all_jobs()[-1]


def test_ici_aggregate_e2e_byte_identical(ici_cluster, torch_tpch_dir):
    flight = _ctx(ici_cluster, torch_tpch_dir, {"ballista.shuffle.ici": "false"})
    want = flight.sql(AGG_SQL).collect().to_pandas()
    flight_stages = len(_last_graph(ici_cluster).stages)

    ici = _ctx(ici_cluster, torch_tpch_dir, {})
    got = ici.sql(AGG_SQL).collect().to_pandas()
    g = _last_graph(ici_cluster)

    # byte-identical rows, one FEWER stage: the aggregate exchange never
    # became a shuffle boundary
    pd.testing.assert_frame_equal(got, want)
    assert g.ici_promoted == 1
    assert len(g.stages) == flight_stages - 1
    ici_stage = [s for s in g.stages.values() if s.ici_exchange_ids][0]
    assert ici_stage.stage_metrics.get("op.IciExchange.count", 0) >= 1
    assert ici_stage.stage_metrics.get("op.IciExchange.bytes_hbm", 0) > 0
    assert ici_stage.stage_metrics.get("op.IciExchange.collective_time_s", 0) > 0
    assert all(s.stage_metrics.get("op.HostFallback.count", 0) == 0 for s in g.stages.values())


def test_ici_join_e2e_byte_identical(ici_cluster, torch_tpch_dir):
    # broadcast off so the join stays partitioned (both sides exchanged);
    # megastage off: the per-stage two-tier split (test_torch_megastage.py
    # has the whole-chain program)
    base = {"ballista.optimizer.broadcast_rows_threshold": "0",
            "ballista.engine.megastage": "false"}
    flight = _ctx(ici_cluster, torch_tpch_dir, dict(base, **{"ballista.shuffle.ici": "false"}))
    want = flight.sql(JOIN_SQL).collect().to_pandas()
    flight_stages = len(_last_graph(ici_cluster).stages)

    ici = _ctx(ici_cluster, torch_tpch_dir, dict(base))
    got = ici.sql(JOIN_SQL).collect().to_pandas()
    g = _last_graph(ici_cluster)

    pd.testing.assert_frame_equal(got, want)
    # both join-side exchanges collapsed onto the mesh: their two producer
    # stages are gone
    assert g.ici_promoted == 2
    assert len(g.stages) == flight_stages - 2
    ici_stage = [s for s in g.stages.values() if s.ici_exchange_ids][0]
    assert sorted(ici_stage.ici_exchange_ids) == [1, 2]
    assert ici_stage.stage_metrics.get("op.IciExchange.count", 0) >= 1
    assert ici_stage.stage_metrics.get("op.FusedIciJoin.count", 0) >= 1


@pytest.mark.chaos
def test_ici_fault_demotes_to_flight_byte_identical(ici_cluster, torch_tpch_dir):
    """Every collective attempt fails (injected): the scheduler re-plans the
    exchange onto the Flight tier mid-job and the query returns the same
    rows; the retry budget is never spent."""
    clean = _ctx(ici_cluster, torch_tpch_dir, {})
    want = clean.sql(AGG_SQL).collect().to_pandas()
    stages_promoted = len(_last_graph(ici_cluster).stages)

    chaotic = _ctx(ici_cluster, torch_tpch_dir, {
        "ballista.faults.schedule": "ici.exchange:error@p=1:seed=7",
    })
    got = chaotic.sql(AGG_SQL).collect().to_pandas()
    g = _last_graph(ici_cluster)

    pd.testing.assert_frame_equal(got, want)
    assert g.status == SUCCESSFUL
    assert g.ici_promoted == 1
    # the demotion left a real boundary: one more (producer) stage, no ICI
    # node, and no collective completed under injection
    assert len(g.stages) == stages_promoted + 1
    for s in g.stages.values():
        assert not s.ici_exchange_ids
        assert not s.stage_metrics.get("op.IciExchange.count")

    # a later clean job (no schedule in its props) promotes again
    again = _ctx(ici_cluster, torch_tpch_dir, {})
    pd.testing.assert_frame_equal(again.sql(AGG_SQL).collect().to_pandas(), want)
    assert _last_graph(ici_cluster).ici_promoted == 1
    assert len(_last_graph(ici_cluster).stages) == stages_promoted
