"""Mesh groups of the PyTorch port on the CPU: two member processes of two
shards each (gloo), one 4-shard program across them.

* The fused aggregate and the fused partitioned join through
  ``run_fused_*_multihost`` (``tests/torch_multihost_worker.py``, as
  ``tests/multihost_worker.py`` drives the JAX package's): the union of the
  members' slices equals the JAX engine's fused program over 4 forced host
  devices byte for byte (sorted); each member's slice equals shards
  ``[2p, 2p + 2)`` of the port's one-process 4-shard program; no group key
  appears twice.
* Duplicate build keys: both members raise ``GangUnfusable``.
* The layout agreement: members whose dictionaries, decimal scales, nulls
  and row counts differ.
* The card's budget split between two members of one card (the card
  identity patched in the workers) as the engine and the scheduler read it,
  and the gang decisions (budget, cap, agreed rows) alike in both members.
* End to end: the port's scheduler with two ``python -m
  ballista_tpu_torch.executor --mesh-group-*`` processes gang-launches an
  aggregate and a partitioned join (rows equal to the JAX engine's), and a
  member's injected failure restarts the gang stage whole.
* The group collective's byte packing, and which nodes of a stage run
  across the group.

Ports are picked free (no fixed ports: test workers share the host).
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu_torch.engine import fused_exchange as FX
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine.torch_engine import TorchEngine, gang_collectives
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.parallel import collective_for, shard_map
from ballista_tpu_torch.parallel.mesh import build_mesh, shards_per_card_of

from test_torch_data import torch_tpch_dir  # noqa: F401
import torch_multihost_worker as W

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MODES = "agg,join,join-dup,layout,budget"
N_DEV = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    # two intra-op threads a member process: test workers share the host
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    env.pop("XLA_FLAGS", None)
    return env


def run_members(data_dir: str, out: str, modes: str, device: str = "cpu") -> None:
    """Both members of a 2-process group run the worker's ``modes``."""
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"), str(pid), "2",
         coordinator, data_dir, out, modes, device],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env()) for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{log[-3000:]}"


@pytest.fixture(scope="module")
def group_out(torch_tpch_dir, tmp_path_factory):
    """Both members run every worker mode once; their outputs' directory."""
    out = str(tmp_path_factory.mktemp("multihost"))
    run_members(torch_tpch_dir, out, MODES)
    return out


def slices_of(out: str, mode: str) -> list:
    return [pq.read_table(os.path.join(out, f"{mode}-{pid}.parquet")).to_pandas()
            for pid in (0, 1)]


def _sorted(df: pd.DataFrame) -> pd.DataFrame:
    return df.sort_values(list(df.columns), kind="stable").reset_index(drop=True)


# ---- the references ----------------------------------------------------------------
def _jax_fused(torch_tpch_dir, sql: str, threshold=None, join: bool = False) -> pd.DataFrame:
    """The JAX engine's fused program over 4 of the conftest's 8 host devices."""
    from ballista_tpu.client.context import BallistaContext as JaxContext
    from ballista_tpu.engine import fused_exchange as JFX
    from ballista_tpu.engine.jax_engine import JaxEngine, _fusable_partitioned_join
    from ballista_tpu.plan import physical as JP
    from ballista_tpu.plan.optimizer import optimize
    from ballista_tpu.plan.physical_planner import PhysicalPlanner
    from ballista_tpu.sql.parser import parse_sql
    from ballista_tpu.sql.planner import SqlPlanner

    ctx = JaxContext.standalone(backend="numpy")
    for t in ("lineitem", "orders"):
        ctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
    if threshold is not None:
        ctx.config.set("ballista.optimizer.broadcast_rows_threshold", threshold)
    logical = SqlPlanner(ctx.catalog.schemas()).plan(parse_sql(sql))
    phys = PhysicalPlanner(ctx.catalog, ctx.config).plan(optimize(logical, ctx.catalog))
    eng = JaxEngine(ctx.config)
    if join:
        node = next(n for n in JP.walk_physical(phys) if _fusable_partitioned_join(n))
        parts = JFX.run_fused_join(eng, node, N_DEV)
    else:
        node = next(n for n in JP.walk_physical(phys)
                    if isinstance(n, JP.HashAggregateExec) and n.mode == "final")
        parts = JFX.run_fused_aggregate(eng, node, node.input.input, N_DEV)
    assert parts is not None, "the JAX engine declined the fused program"
    return parts[0].to_arrow().to_pandas()


def _port_shards(enc, fns, holders, device) -> list:
    """The port's one-process aggregate over 4 shards on ``device``: each
    shard's output rows."""
    mesh = build_mesh(N_DEV, device)
    eng = TorchEngine(device=device)
    args = LC.on_mesh(eng, enc, mesh)
    outs = shard_map(lambda i, *a: fns[i](*a), [(i, *a) for i, a in enumerate(args)], mesh)
    shards = []
    for i, out in enumerate(outs):
        db = KT.device_batch_from_outputs(holders[i]["meta"], list(out), 0)
        shards.append(KT.to_host(db).to_arrow().to_pandas())
    return shards


def port_agg_shards(final, partial, device="cpu") -> list:
    eng = TorchEngine(device=device)
    enc, _ = FX.fused_input(eng, partial.input, build_mesh(N_DEV, device), device_ok=False)
    holders = [{} for _ in range(N_DEV)]
    fns = [FX.make_aggregate_dev_fn(final, partial, enc, N_DEV, h) for h in holders]
    return _port_shards(enc, fns, holders, device)


def port_join_shards(join, device="cpu") -> list:
    eng = TorchEngine(device=device)
    mesh = build_mesh(N_DEV, device)
    lenc, _ = FX.fused_input(eng, join.left.input, mesh, device_ok=False)
    renc = FX.build_side_encoding(eng, join, N_DEV)
    holders = [{} for _ in range(N_DEV)]
    fns = [FX.make_join_dev_fn(join, lenc, renc, N_DEV, h) for h in holders]
    largs = LC.on_mesh(eng, lenc, mesh)
    rargs = LC.on_mesh(eng, renc, mesh)
    outs = shard_map(lambda i, *a: fns[i](*a),
                     [(i, *l, *r) for i, (l, r) in enumerate(zip(largs, rargs))], mesh)
    shards = []
    for i, out in enumerate(outs):
        assert int(out[-1].sum()) == 0
        db = KT.device_batch_from_outputs(holders[i]["meta"], list(out[:-1]), 0)
        shards.append(KT.to_host(db).to_arrow().to_pandas())
    return shards


def check_slices(slices: list, shards: list) -> None:
    """Member p's slice holds the rows of shards [2p, 2p + 2)."""
    for pid, got in enumerate(slices):
        want = pd.concat(shards[2 * pid:2 * pid + 2])
        pd.testing.assert_frame_equal(_sorted(got), _sorted(want))


# ---- (a), (b), (c): the fused programs across two processes ---------------------------
def test_fused_aggregate_across_two_processes(group_out, torch_tpch_dir):
    slices = slices_of(group_out, "agg")
    got = _sorted(pd.concat(slices))
    keys = ["l_returnflag", "l_linestatus"]
    assert not got.duplicated(keys).any()
    pd.testing.assert_frame_equal(got, _sorted(_jax_fused(torch_tpch_dir, W.AGG_SQL)))
    ctx = W._context(torch_tpch_dir)
    final, partial = W.agg_nodes(W.plan_of(ctx, W.AGG_SQL))
    check_slices(slices, port_agg_shards(final, partial))


def test_fused_join_across_two_processes(group_out, torch_tpch_dir):
    slices = slices_of(group_out, "join")
    got = _sorted(pd.concat(slices))
    want = _sorted(_jax_fused(torch_tpch_dir, W.JOIN_SQL, threshold=0, join=True))
    assert len(got) > 1000
    pd.testing.assert_frame_equal(got, want)
    ctx = W._context(torch_tpch_dir)
    check_slices(slices, port_join_shards(W.join_node(W.plan_of(ctx, W.JOIN_SQL, 0))))


def test_duplicate_build_keys_raise_gang_unfusable_in_every_member(group_out):
    for pid in (0, 1):
        assert not os.path.exists(os.path.join(group_out, f"join-dup-{pid}.parquet"))
        with open(os.path.join(group_out, f"join-dup-{pid}.json")) as f:
            err = json.load(f)["error"]
        assert err.startswith("GANG_UNFUSABLE: fused join: duplicate build keys"), err


# ---- (d): the layout agreement ----------------------------------------------------------
def test_layout_agreement_over_differing_members(group_out):
    """Member 0: keys a/b, one decimal place, no nulls, 37 rows; member 1:
    keys b/c/d and a NULL key, two places, NULL values, 211 rows. The union
    equals the exact result and the one-process program over both members'
    rows, and each slice that program's shards."""
    from ballista_tpu_torch.engine.numpy_engine import NumpyEngine

    slices = slices_of(group_out, "layout")
    got = _sorted(pd.concat(slices))
    phys, _batches = W.layout_plan()
    final, partial = W.agg_nodes(phys)
    exact = NumpyEngine().execute_all(final)
    want = _sorted(pd.concat([b.to_arrow().to_pandas() for b in exact]))
    assert len(got) == 5 and got["k"].isna().sum() == 1
    pd.testing.assert_frame_equal(got, want)
    check_slices(slices, port_agg_shards(final, partial))


# ---- (g): the card's budget and the gang decisions ---------------------------------------
def test_card_budget_split_between_two_members_of_one_card(group_out):
    """Both members report card-0: its four shards share its budget, the
    engine plans against a quarter of it, and the shape each member
    registers makes the scheduler's admission budget the same number."""
    outs = []
    for pid in (0, 1):
        with open(os.path.join(group_out, f"budget-{pid}.json")) as f:
            outs.append(json.load(f))
    quarter = MM.shard_budget_bytes(W.CARD_BYTES, 4)
    for out in outs:
        assert out["shards_on_card"] == 4 and out["mesh_shape"] == "1x4"
        assert out["inventory"] == [2, "cpu", "1x4"]
        assert out["own"] == out["group"] == out["split"] == out["engine"] == quarter
        admitted = MM.budget_from_device_kinds({"NVIDIA H100 80GB HBM3"},
                                               shards_per_card_of(out["mesh_shape"]))
        assert admitted == out["engine"]
        assert out["transport"][0] == "gloo"


def test_gang_decisions_are_the_same_in_both_members(group_out):
    outs = []
    for pid in (0, 1):
        with open(os.path.join(group_out, f"budget-{pid}.json")) as f:
            outs.append(json.load(f)["decisions"])
    assert outs[0] == outs[1]
    assert outs[0]["budget"].startswith("GANG_UNFUSABLE: hbm_budget")
    assert outs[0]["cap"] == "GANG_UNFUSABLE: input exceeds the fused-exchange cap"
    assert outs[0]["rows"].startswith("GANG_UNFUSABLE: fused aggregate: 60018 input rows")


# ---- the group collective's rounds and the stage's collectives --------------------------------
class _OneProcess:
    """A mesh group's transport for a group of one process: the call
    returns what was sent (its block 0 is this process's own)."""

    size = 1
    on_host = True

    def exchange(self, send):
        return send.clone()


@pytest.mark.parametrize("n_local", [1, 2, 4])
def test_group_rounds_give_the_one_process_rows(n_local):
    """The group's path of a round (bytes into the shared send buffer, the
    transport's call, each shard's block, views of it) against the
    one-process collective over the same shards: every row of every dtype
    bit for bit, and the sums."""
    rng = np.random.default_rng(n_local)
    bufs = [[torch.from_numpy(rng.integers(-9, 9, (n_local, 5)).astype(np.int64)),
             torch.from_numpy(rng.random((n_local, 3)).astype(np.float32)),
             torch.from_numpy(rng.random((n_local, 7)) > 0.5),
             torch.from_numpy(rng.integers(0, 9, (n_local, 2)).astype(np.int32))]
            for _ in range(n_local)]

    def body(r):
        coll = collective_for(n_local)
        got = coll.all_to_all(bufs[r])
        total = coll.all_sum(torch.tensor(10 * r + 1, dtype=torch.int64))
        return got, total

    mesh = build_mesh(n_local, "cpu")
    want = shard_map(body, [(r,) for r in range(n_local)], mesh)
    got = shard_map(body, [(r,) for r in range(n_local)], mesh, group=_OneProcess())
    for (g, gs), (w, ws) in zip(got, want):
        assert torch.equal(gs, ws) and gs.shape == ws.shape
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_gang_collectives_stop_below_an_exchange_no_collective_consumes(torch_tpch_dir):
    """q5-shaped chains: every partitioned join and the final aggregate of
    an all-inline stage run across the group; below a join with a collected
    build side only its probe side does, and below an exchange a collective
    does not consume nothing does."""
    from ballista_tpu_torch.plan import physical as P

    ctx = W._context(torch_tpch_dir)
    sql = ("select o_orderpriority, count(*) as n from lineitem join orders "
           "on l_orderkey = o_orderkey group by o_orderpriority")
    phys = W.plan_of(ctx, sql, threshold=0)
    kinds = sorted(type(n).__name__ for n in gang_collectives(phys))
    assert kinds == ["HashAggregateExec", "HashJoinExec"]
    join = W.join_node(phys)
    # the same join under a materialized exchange: nothing runs across
    wrapped = P.RepartitionExec(join, join.left.partitioning)
    assert gang_collectives(wrapped) == []
    # a collected build side: the probe side's collectives only
    broadcast = P.HashJoinExec(join.left, join, "inner", join.on, None, collect_build=True)
    assert gang_collectives(broadcast) == []
    probe = P.HashJoinExec(join, join.right, "inner", join.on, None, collect_build=True)
    assert gang_collectives(probe) == [join]


def test_gang_collectives_stop_below_a_union(torch_tpch_dir):
    """A union's partition p reads partition p - offset of one input, so a
    collective below it would leave its slice where another member reads:
    each input's aggregate runs in each member alone."""
    from ballista_tpu_torch.plan import physical as P

    ctx = W._context(torch_tpch_dir)
    ctx.config.set("ballista.shuffle.partitions", 3)
    phys = W.plan_of(ctx, E2E_UNION)
    union = next(n for n in P.walk_physical(phys) if isinstance(n, P.UnionExec))
    assert [c.output_partitions() for c in union.inputs] == [3, 3]
    assert [len(gang_collectives(c)) for c in union.inputs] == [1, 1]
    assert gang_collectives(phys) == []


# ---- (e), (f): end to end through the scheduler ------------------------------------------
E2E_AGG = W.AGG_SQL + " order by l_returnflag, l_linestatus"
E2E_JOIN = ("select o_orderpriority, count(*) as n, sum(l_extendedprice) as rev "
            "from lineitem join orders on l_orderkey = o_orderkey "
            "group by o_orderpriority order by o_orderpriority")
# two grouped aggregates of 3 partitions each: the second input's
# partitions start at the union's partition 3, odd against 2 members
E2E_UNION = ("select l_returnflag as k, count(*) as n from lineitem group by l_returnflag "
             "union all select o_orderpriority as k, count(*) as n from orders "
             "group by o_orderpriority")
GANG = {"ballista.tpu.fuse_exchange_max_rows": "10000000", "ballista.shuffle.partitions": "4"}


@pytest.fixture(scope="module")
def gang_cluster(torch_tpch_dir, tmp_path_factory):
    """A push-mode scheduler in this process and two torch executor
    processes on the CPU forming mesh group g0 (2 shards each)."""
    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    work = tmp_path_factory.mktemp("gang")
    sched = SchedulerServer(SchedulerConfig(scheduling_policy="push"))
    port = sched.start(0)
    coordinator = f"127.0.0.1:{_free_port()}"
    logs = [open(work / f"exec{pid}.log", "w+") for pid in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--backend", "torch",
         "--device", "cpu", "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port),
         "--port", "0", "--task-slots", "2", "--scheduling-policy", "push",
         "--work-dir", str(work / f"w{pid}"), "--log-level", "INFO",
         "--mesh-group-id", "g0", "--mesh-group-coordinator", coordinator,
         "--mesh-group-size", "2", "--mesh-group-process-id", str(pid),
         "--mesh-group-local-devices", "2"],
        cwd=REPO, env=_env(), stdout=logs[pid], stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    try:
        deadline = time.time() + 60
        while not sched.cluster.complete_mesh_groups() and time.time() < deadline:
            assert all(p.poll() is None for p in procs), _read(logs)
            time.sleep(0.1)
        assert sched.cluster.complete_mesh_groups(), _read(logs)
        yield sched, port, logs
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        sched.stop()
        for f in logs:
            f.close()


def _read(logs) -> list:
    out = []
    for f in logs:
        f.flush()
        f.seek(0)
        out.append(f.read())
    return out


def _remote(port: int, torch_tpch_dir, settings: dict):
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig

    ctx = BallistaContext.remote("127.0.0.1", port)
    ctx.config = BallistaConfig(settings)
    for t in ("lineitem", "orders"):
        ctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return ctx


def _jax_rows(torch_tpch_dir, sql: str, settings: dict) -> pd.DataFrame:
    from ballista_tpu.client.context import BallistaContext as JaxContext

    ctx = JaxContext.standalone(backend="jax")
    for k, v in settings.items():
        ctx.config.set(k, v)
    for t in ("lineitem", "orders"):
        ctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return ctx.sql(sql).collect().to_pandas()


def _gang_stages(sched, job_id: str) -> list:
    g = sched.tasks.get_job(job_id)
    return [s for s in g.stages.values() if s.gang]


@pytest.mark.parametrize("label,sql,settings,metric", [
    ("aggregate", E2E_AGG, {}, "op.FusedMultiHostExchange.count"),
    ("join", E2E_JOIN, {"ballista.optimizer.broadcast_rows_threshold": "0"},
     "op.FusedMultiHostJoin.count"),
], ids=["aggregate", "join"])
def test_gang_launched_stage_over_two_executor_processes(gang_cluster, torch_tpch_dir, label,
                                                         sql, settings, metric):
    sched, port, logs = gang_cluster
    ctx = _remote(port, torch_tpch_dir, dict(GANG, **settings))
    got = ctx.sql(sql).collect().to_pandas()
    pd.testing.assert_frame_equal(got, _jax_rows(torch_tpch_dir, sql, settings))
    stages = _gang_stages(sched, ctx.last_job_id)
    assert len(stages) == 1 and stages[0].attempt == 0
    m = stages[0].stage_metrics
    assert m.get(metric, 0) >= 1 and m.get("op.HostFallback.count", 0) == 0
    text = _read(logs)
    for pid in (0, 1):
        assert "joining mesh group g0" in text[pid]
        assert f"multihost fused {label}: group={ctx.last_job_id}-" in text[pid], \
            text[pid][-3000:]


def test_union_of_aggregates_over_a_mesh_group_gives_exact_rows(gang_cluster, torch_tpch_dir):
    """A union of two grouped aggregates, the first of an odd partition
    count, through the group: its stage is not ganged (no collective is
    reached from its root through partition-wise operators), and every row
    of both inputs comes back once."""
    sched, port, _logs = gang_cluster
    settings = {"ballista.shuffle.partitions": "3"}
    ctx = _remote(port, torch_tpch_dir, dict(GANG, **settings))
    got = _sorted(ctx.sql(E2E_UNION).collect().to_pandas())
    want = _sorted(_jax_rows(torch_tpch_dir, E2E_UNION, settings))
    pd.testing.assert_frame_equal(got, want)
    assert len(got) == 3 + 5
    assert _gang_stages(sched, ctx.last_job_id) == []


def test_member_failure_restarts_the_gang_stage_whole(gang_cluster, torch_tpch_dir):
    """Member 1 fails its gang task once, before it enters the program; its
    peer stops waiting at the rendezvous after the session's 5 s, the stage
    restarts whole as a new gang attempt, and the rows stay exact."""
    sched, port, logs = gang_cluster
    member1 = next(e.executor_id for e in sched.cluster.alive_executors()
                   if e.mesh_group_process_id == 1)
    settings = dict(GANG, **{
        "ballista.shuffle.partitions": "2", "ballista.tpu.mesh_group.timeout_ms": "5000",
        "ballista.faults.schedule": f"task.execute:fail_n@n=1:executor_id={member1}:stage_id=1"})
    ctx = _remote(port, torch_tpch_dir, settings)
    t0 = time.time()
    got = ctx.sql(E2E_AGG).collect().to_pandas()
    assert time.time() - t0 < 60
    pd.testing.assert_frame_equal(got, _jax_rows(torch_tpch_dir, E2E_AGG, {}))
    stages = _gang_stages(sched, ctx.last_job_id)
    assert len(stages) == 1 and stages[0].attempt >= 1
    assert stages[0].stage_metrics.get("op.FusedMultiHostExchange.count", 0) >= 1
    # the peer's first attempt gave up within the session's timeout
    deadline = time.time() + 30
    while time.time() < deadline and "DistStoreError" not in _read(logs)[0]:
        time.sleep(0.2)
    assert "DistStoreError" in _read(logs)[0]


def test_a_member_lost_mid_stage_restarts_the_stage_on_the_survivor(torch_tpch_dir,
                                                                    tmp_path):
    """Member 1 is killed while its gang task stalls (a session fault) and
    member 0 waits for it at the rendezvous (for 5 s at most): the scheduler
    expires member 1 (heartbeats every 0.3 s, expiry after 2 s), restarts
    the stage whole, and, the group no longer complete, runs it un-ganged on
    member 0 alone; the rows stay exact."""
    import threading

    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    sched = SchedulerServer(SchedulerConfig(scheduling_policy="push",
                                            executor_timeout_seconds=2.0,
                                            expire_dead_executors_interval_seconds=0.25))
    port = sched.start(0)
    coordinator = f"127.0.0.1:{_free_port()}"
    logs = [open(tmp_path / f"exec{pid}.log", "w+") for pid in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.executor", "--backend", "torch",
         "--device", "cpu", "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port),
         "--port", "0", "--task-slots", "2", "--scheduling-policy", "push",
         "--heartbeat-interval-s", "0.3", "--work-dir", str(tmp_path / f"w{pid}"),
         "--mesh-group-id", "g1", "--mesh-group-coordinator", coordinator,
         "--mesh-group-size", "2", "--mesh-group-process-id", str(pid),
         "--mesh-group-local-devices", "2"],
        cwd=REPO, env=_env(), stdout=logs[pid], stderr=subprocess.STDOUT)
        for pid in (0, 1)]
    try:
        deadline = time.time() + 60
        while not sched.cluster.complete_mesh_groups() and time.time() < deadline:
            time.sleep(0.1)
        assert sched.cluster.complete_mesh_groups(), _read(logs)
        member1 = next(e.executor_id for e in sched.cluster.alive_executors()
                       if e.mesh_group_process_id == 1)
        ctx = _remote(port, torch_tpch_dir, dict(GANG, **{
            "ballista.shuffle.partitions": "2", "ballista.tpu.mesh_group.timeout_ms": "5000",
            "ballista.faults.schedule":
                f"task.execute:slow@delay=30:executor_id={member1}:stage_id=1"}))
        result: dict = {}
        runner = threading.Thread(
            target=lambda: result.update(rows=ctx.sql(E2E_AGG).collect().to_pandas()))
        t0 = time.time()
        runner.start()
        while time.time() < t0 + 30:
            jobs = sched.tasks.active_jobs()
            if jobs and any(s.gang for g in jobs for s in g.stages.values()):
                break
            time.sleep(0.05)
        time.sleep(0.5)
        procs[1].kill()
        runner.join(timeout=60)
        assert "rows" in result, _read(logs)[0][-3000:]
        assert time.time() - t0 < 30
        pd.testing.assert_frame_equal(result["rows"], _jax_rows(torch_tpch_dir, E2E_AGG, {}))
        g = sched.tasks.get_job(ctx.last_job_id)
        stage = g.stages[1]
        assert stage.attempt >= 1 and not stage.gang
        assert not sched.cluster.complete_mesh_groups()
        assert member1 not in {e.executor_id for e in sched.cluster.alive_executors()}
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
        sched.stop()
        for f in logs:
            f.close()
