"""The port's megastage (``engine/megastage.py``): a whole q3-class chain as
one program over the mesh, against the JAX package on the CPU.

The cases of ``tests/test_megastage.py`` that apply to the torch engine,
beside their JAX counterparts (the plan-layer and serde cases need no second
copy: the port's planner is the JAX package's):

* engine: the promoted chain over eight ``cpu`` shards returns the JAX
  engine's rows for the same chain byte for byte, and the per-stage split's
  and the host engine's, with the megastage and collective metrics; the
  knob off, a budget the chain exceeds and a failing shard each demote
  (``IciDemoted`` naming the aggregate exchange), never a host run;
* scheduler: a runtime demotion strips the wrapper and splits only the
  aggregate boundary, the join's exchanges staying promoted;
* e2e through the port's scheduler and a torch executor on the 8-shard
  mesh: the chain runs as one stage, byte-identical to the staged path, and
  an injected collective fault demotes it mid-job with the same rows.
"""
import os

import numpy as np
import pandas as pd
import pytest

from ballista_tpu.engine.engine import create_engine as jax_create_engine
from ballista_tpu.models.tpch import TPCH_TABLES
from ballista_tpu_torch import parallel
from ballista_tpu_torch.client.catalog import Catalog
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.client.standalone import start_standalone_cluster
from ballista_tpu_torch.config import (
    BALLISTA_ENGINE_HBM_BUDGET_BYTES, BALLISTA_ENGINE_MEGASTAGE, BALLISTA_SHUFFLE_PARTITIONS,
    BallistaConfig,
)
from ballista_tpu_torch.engine.engine import create_engine
from ballista_tpu_torch.errors import IciDemoted
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.optimizer import optimize
from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
from ballista_tpu_torch.scheduler.execution_graph import (
    RUNNING, SUCCESSFUL, UNRESOLVED, ExecutionGraph,
)
from ballista_tpu_torch.scheduler.planner import promote_ici_exchanges, promote_megastage
from ballista_tpu_torch.sql.parser import parse_sql
from ballista_tpu_torch.sql.planner import SqlPlanner

from test_megastage import _promoted as jax_promoted
from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_ici import _fail_on_shard
from test_torch_scheduler import _port_copy

pytestmark = pytest.mark.megastage

MESH = 8
Q3_SQL = (
    "select o_prio, count(*) as n, sum(l_price) as rev "
    "from li join orders on l_orderkey = o_orderkey group by o_prio"
)


@pytest.fixture(scope="module")
def mesh8():
    prev = parallel.force_mesh_shards(MESH)
    yield MESH
    parallel.force_mesh_shards(prev)


def _q3_plan(partitions: int = 2, seed: int = 0) -> P.PhysicalPlan:
    """The JAX test's q3-class chain over in-memory batches (the same
    draws): a partitioned PK-FK join with a shuffle-bounded aggregate above
    it."""
    cat = Catalog()
    rng = np.random.default_rng(seed)
    n = 200
    li = ColumnBatch.from_dict({
        "l_orderkey": rng.integers(0, 50, n).astype(np.int64),
        "l_price": rng.random(n),
    })
    orders = ColumnBatch.from_dict({
        "o_orderkey": np.arange(50, dtype=np.int64),
        "o_prio": rng.integers(0, 5, 50).astype(np.int64),
    })
    cat.register_batches("li", [li.slice(i * 50, 50) for i in range(4)], li.schema)
    cat.register_batches("orders", [orders.slice(0, 25), orders.slice(25, 25)], orders.schema)
    logical = SqlPlanner(cat.schemas()).plan(parse_sql(Q3_SQL))
    cfg = BallistaConfig({
        BALLISTA_SHUFFLE_PARTITIONS: str(partitions),
        "ballista.optimizer.broadcast_rows_threshold": "0",
    })
    return PhysicalPlanner(cat, cfg).plan(optimize(logical))


def _promoted(megastage: bool = True) -> P.PhysicalPlan:
    p1, n1 = promote_ici_exchanges(_q3_plan(), ici_devices=MESH)
    assert n1 == 2
    if not megastage:
        return p1
    p2, n2 = promote_megastage(p1, ici_devices=MESH)
    assert n2 == 1
    return p2


def _frames(batches):
    return (ColumnBatch.concat(batches).to_pandas()
            .sort_values("o_prio").reset_index(drop=True))


# ---- engine ----------------------------------------------------------------------
def test_engine_byte_identical_with_donation_metrics(mesh8):
    eng = create_engine("torch", BallistaConfig(), device="cpu")
    got = _frames(eng.execute_all(_promoted()))
    m = eng.op_metrics
    assert m.get("op.Megastage.count") == 1
    assert m.get("op.Megastage.boundaries") == 3
    assert m.get("op.Megastage.donated_bytes", 0) > 0
    assert m.get("op.Megastage.dispatches_avoided") == 1
    # one program, the collective's bytes summed over all three exchanges
    assert m.get("op.IciExchange.count") == 1
    assert m.get("op.IciExchange.bytes_hbm", 0) > 0
    assert m.get("op.HostFallback.count", 0) == 0

    # the JAX engine's megastage over its 8 devices, on the same chain
    jeng = jax_create_engine("jax", None)
    want = _frames(jeng.execute_all(jax_promoted()))
    assert jeng.op_metrics.get("op.Megastage.count") == 1
    pd.testing.assert_frame_equal(got, want)
    # the per-stage split (both join exchanges inline, the aggregate's not)
    split = _frames(create_engine("torch", BallistaConfig(), device="cpu")
                    .execute_all(_promoted(megastage=False)))
    pd.testing.assert_frame_equal(got, split)
    ref = _frames(create_engine("numpy", BallistaConfig()).execute_all(_q3_plan()))
    pd.testing.assert_frame_equal(got, ref, check_dtype=False)
    # the host engine treats the wrapper as a no-op
    np_got = _frames(create_engine("numpy", BallistaConfig()).execute_all(_promoted()))
    pd.testing.assert_frame_equal(np_got, ref, check_dtype=False)


@pytest.mark.parametrize("settings,reason", [
    ({BALLISTA_ENGINE_MEGASTAGE: "false"}, "engine megastage disabled"),
    ({BALLISTA_ENGINE_HBM_BUDGET_BYTES: "1"}, "hbm_budget"),
], ids=["knob-off", "hbm-budget"])
def test_engine_declines_demote(mesh8, settings, reason):
    eng = create_engine("torch", BallistaConfig(settings), device="cpu")
    with pytest.raises(IciDemoted, match=r"ICI_DEMOTE\[3\]: " + reason):
        eng.execute_all(_promoted())


def test_engine_failing_shard_demotes(mesh8, monkeypatch):
    _fail_on_shard(monkeypatch, 6)
    eng = create_engine("torch", BallistaConfig(), device="cpu")
    with pytest.raises(IciDemoted, match=r"ICI_DEMOTE\[3\]: megastage declined at runtime"):
        eng.execute_all(_promoted())
    assert "op.Megastage.count" not in eng.op_metrics


# ---- scheduler -------------------------------------------------------------------
def test_runtime_demotion_strips_wrapper_and_resplits():
    g = ExecutionGraph("job-ms", "t", "sess", _q3_plan(),
                       ici_shuffle=True, ici_devices=MESH, megastage=True)
    assert g.megastage_promoted == 1 and len(g.stages) == 1
    (sid,) = g.stages
    t = g.pop_next_task("fat-1")
    ev = g.update_task_status(
        "fat-1",
        [{"task_id": t.task_id, "stage_id": t.stage_id, "stage_attempt": 0,
          "partition": t.partition, "status": "failed",
          "failure": {"kind": "execution", "retryable": True,
                      "message": "IciDemoted: ICI_DEMOTE[3]: megastage declined at runtime"}}],
    )
    assert ev == ["updated"] and g.status == RUNNING
    assert g.megastage_demoted == 1
    # the aggregate exchange became a real boundary again: the per-stage split
    assert len(g.stages) == 2
    stage = g.stages[sid]
    assert stage.attempt == 1 and stage.state == UNRESOLVED
    # the join exchanges stay promoted; only the megastage's boundary demoted
    producer = [s for s in g.stages.values() if s.plan is not stage.plan
                and isinstance(s.plan, P.ShuffleWriterExec)][0]
    assert sorted(producer.ici_exchange_ids) == [1, 2]
    for s in g.stages.values():
        assert not any(isinstance(n, P.MegastageExec) for n in P.walk_physical(s.plan))
    assert all(f == 0 for f in stage.task_failures)
    _port_copy("test_execution_graph.py").drain(g, "fat-1")
    assert g.status == SUCCESSFUL


# ---- e2e on the 8-shard mesh -----------------------------------------------------
JOIN_SQL = (
    "select o_orderpriority, count(*) as n, sum(l_extendedprice) as rev "
    "from lineitem join orders on l_orderkey = o_orderkey "
    "group by o_orderpriority order by o_orderpriority"
)
BASE = {"ballista.optimizer.broadcast_rows_threshold": "0"}


@pytest.fixture(scope="module")
def ms_cluster(mesh8, tmp_path_factory):
    c = start_standalone_cluster(n_executors=1, task_slots=2, device="cpu",
                                 work_dir=str(tmp_path_factory.mktemp("megastage")))
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


def test_megastage_e2e_byte_identical_fewer_stages(ms_cluster, torch_tpch_dir):
    staged = _ctx(ms_cluster, torch_tpch_dir, dict(BASE, **{BALLISTA_ENGINE_MEGASTAGE: "false"}))
    want = staged.sql(JOIN_SQL).collect().to_pandas()
    staged_stages = len(_last_graph(ms_cluster).stages)

    mega = _ctx(ms_cluster, torch_tpch_dir, dict(BASE))
    got = mega.sql(JOIN_SQL).collect().to_pandas()
    g = _last_graph(ms_cluster)

    pd.testing.assert_frame_equal(got, want)
    assert g.megastage_promoted == 1
    assert len(g.stages) < staged_stages
    # the whole join and aggregate chain ran as one mesh program (only the
    # ORDER BY's collect stage remains above it); stage metrics re-report
    # per sibling task off the shared engine
    ms_stages = [s for s in g.stages.values()
                 if s.stage_metrics.get("op.Megastage.count", 0) >= 1]
    assert len(ms_stages) == 1
    stage = ms_stages[0]
    assert sorted(stage.ici_exchange_ids) == [1, 2, 3]
    assert stage.stage_metrics.get("op.Megastage.donated_bytes", 0) > 0
    assert stage.stage_metrics.get("op.IciExchange.bytes_hbm", 0) > 0


@pytest.mark.chaos
def test_megastage_fault_demotes_byte_identical(ms_cluster, torch_tpch_dir):
    """Every collective attempt fails (injected) mid-megastage: the
    scheduler strips the wrapper and splits the aggregate boundary, the
    join's exchanges demote in turn under the same injection, and the query
    returns the same rows."""
    clean = _ctx(ms_cluster, torch_tpch_dir, dict(BASE))
    want = clean.sql(JOIN_SQL).collect().to_pandas()
    assert _last_graph(ms_cluster).megastage_promoted == 1

    chaotic = _ctx(ms_cluster, torch_tpch_dir, dict(BASE, **{
        "ballista.faults.schedule": "ici.exchange:error@p=1:seed=7",
    }))
    got = chaotic.sql(JOIN_SQL).collect().to_pandas()
    g = _last_graph(ms_cluster)

    pd.testing.assert_frame_equal(got, want)
    assert g.status == SUCCESSFUL
    assert g.megastage_promoted == 1 and g.megastage_demoted == 1
    for s in g.stages.values():
        assert not s.ici_exchange_ids
        assert not s.stage_metrics.get("op.Megastage.count")
        assert not any(isinstance(n, P.MegastageExec) for n in P.walk_physical(s.plan))

    again = _ctx(ms_cluster, torch_tpch_dir, dict(BASE))
    pd.testing.assert_frame_equal(again.sql(JOIN_SQL).collect().to_pandas(), want)
    assert _last_graph(ms_cluster).megastage_promoted == 1
