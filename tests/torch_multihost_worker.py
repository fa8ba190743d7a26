"""Worker for tests/test_torch_multihost.py: one process of a 2-process mesh
group of the PyTorch port, on the CPU (gloo), 2 shards each.

Usage: python torch_multihost_worker.py <pid> <nproc> <coordinator> <data_dir>
<out_dir> <mode,mode,...> [device]

``device`` is the members' engine device, ``cpu`` unless given (``cuda``:
both members' shards on the card, exchanging over gloo through host memory).

Each mode runs in turn, every member under the same rendezvous tags; a
member owns partition i of a scan subtree when i % nproc == pid, as the
engine's gang path does. What each mode writes to <out_dir>:

* ``agg``: the fused aggregate's local slice, ``agg-<pid>.parquet``.
* ``join``: the fused partitioned join's local slice, ``join-<pid>.parquet``.
* ``join-dup``: the join with its sides swapped, so that the build side
  (lineitem) repeats its keys: ``join-dup-<pid>.json`` holds the error.
* ``layout``: the aggregate over in-memory rows whose dictionaries, decimal
  scales, nulls and row counts differ between the members
  (``layout_batch``): ``layout-<pid>.parquet``.
* ``budget``: the card's budget split and the gang decisions (budget, cap,
  agreed row cap) as the member's engine takes them: ``budget-<pid>.json``.
  With this mode both members report one card ("card-0", whose budget is
  ``CARD_BYTES``) instead of the CPU.
* ``transport``: the group's transport, its reason and the most shards on
  one of the member's cards, ``transport-<pid>.json``.

The data functions are importable (the test computes its references from
them); the group work runs only as a script.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

AGG_SQL = ("select l_returnflag, l_linestatus, sum(l_quantity) as s, count(*) as c, "
           "avg(l_discount) as a from lineitem group by l_returnflag, l_linestatus")
JOIN_SQL = ("select o_orderdate, l_quantity, l_extendedprice "
            "from orders join lineitem on o_orderkey = l_orderkey "
            "where o_orderdate >= date '1995-01-01'")
LAYOUT_SQL = "select k, sum(v) as s, count(*) as c, min(v) as m, max(w) as x from t group by k"
# 0.85 of an H100 80GB HBM3's memory (memory_model.DEVICE_MEMORY_BYTES)
CARD_BYTES = 72_264_869_478


def layout_batch(pid: int):
    """Member ``pid``'s rows of ``t``: member 0 has keys a/b, one decimal
    place, no nulls, 37 rows; member 1 keys b/c/d, two decimal places, a
    NULL key and NULL values, 211 rows (a seed per member)."""
    import pyarrow as pa

    from ballista_tpu_torch.ops.batch import Column, ColumnBatch
    from ballista_tpu_torch.plan.schema import DataType, Field, Schema

    rng = np.random.default_rng(100 + pid)
    n = 37 if pid == 0 else 211
    keys = ["a", "b"] if pid == 0 else ["b", "c", "d"]
    k = [keys[i] for i in rng.integers(0, len(keys), n)]
    scale = 10.0 if pid == 0 else 100.0
    v = np.round(rng.integers(-5000, 5000, n) / scale, 2)
    w = rng.integers(0, 1000 * (pid + 1), n).astype(np.int64)
    valid = None
    if pid == 1:
        k[3] = None
        valid = np.ones(n, bool)
        valid[::7] = False
    schema = Schema((Field("k", DataType.STRING, True), Field("v", DataType.FLOAT64, True),
                     Field("w", DataType.INT64, False)))
    return ColumnBatch(schema, [Column(DataType.STRING, pa.array(k, type=pa.string())),
                                Column(DataType.FLOAT64, v, valid),
                                Column(DataType.INT64, w)])


def _context(data_dir: str):
    from ballista_tpu_torch.client.context import BallistaContext

    ctx = BallistaContext.standalone(backend="numpy")
    for t in ("lineitem", "orders"):
        ctx.register_parquet(t, os.path.join(data_dir, t))
    return ctx


def plan_of(ctx, sql: str, threshold=None):
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    if threshold is not None:
        ctx.config.set("ballista.optimizer.broadcast_rows_threshold", threshold)
    logical = SqlPlanner(ctx.catalog.schemas()).plan(parse_sql(sql))
    return PhysicalPlanner(ctx.catalog, ctx.config).plan(optimize(logical, ctx.catalog))


def agg_nodes(phys):
    """(final, partial) of the plan's fused-aggregate shape."""
    from ballista_tpu_torch.plan import physical as P

    for n in P.walk_physical(phys):
        if (isinstance(n, P.HashAggregateExec) and n.mode == "final"
                and isinstance(n.input, P.RepartitionExec)
                and isinstance(n.input.input, P.HashAggregateExec)):
            return n, n.input.input
    raise AssertionError(f"no partial/final aggregate pair in\n{phys}")


def join_node(phys, swap: bool = False):
    """The plan's fusable partitioned join (its sides swapped with ``swap``,
    so that lineitem, whose l_orderkey repeats, is the build side)."""
    from ballista_tpu_torch.engine.torch_engine import _fusable_partitioned_join
    from ballista_tpu_torch.plan import physical as P

    join = next(n for n in P.walk_physical(phys) if _fusable_partitioned_join(n))
    if swap:
        join = P.HashJoinExec(join.right, join.left, join.how,
                              [(r, l) for l, r in join.on], join.filter, join.collect_build)
    return join


def layout_plan():
    """``LAYOUT_SQL`` over ``t``, an in-memory table of the two members'
    schema in two partitions (a member's rows stand for its partition)."""
    from ballista_tpu_torch.client.catalog import Catalog
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    batches = [layout_batch(0), layout_batch(1)]
    cat = Catalog()
    cat.register_batches("t", batches, batches[0].schema)
    logical = SqlPlanner(cat.schemas()).plan(parse_sql(LAYOUT_SQL))
    return PhysicalPlanner(cat, BallistaConfig()).plan(optimize(logical, cat)), batches


def _write(out_dir: str, name: str, batch) -> None:
    import pyarrow.parquet as pq

    pq.write_table(batch.to_arrow(), os.path.join(out_dir, name))


def _budget(pid: int, nproc: int, data_dir: str, out_dir: str) -> None:
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import memory_model as MM
    from ballista_tpu_torch.engine.numpy_engine import NumpyEngine
    from ballista_tpu_torch.engine.torch_engine import TorchEngine
    from ballista_tpu_torch.executor.process import _device_inventory
    from ballista_tpu_torch.parallel import multihost

    group = multihost.current_group()
    ctx = _context(data_dir)
    phys = plan_of(ctx, AGG_SQL)
    final, partial = agg_nodes(phys)
    out = {"shards_on_card": group.shards_per_card(), "mesh_shape": group.mesh_shape(),
           "inventory": list(_device_inventory("torch", "cpu")),
           "own": group.own_budget_bytes, "group": group.shard_budget_bytes,
           "split": MM.shard_budget_bytes(CARD_BYTES, group.shards_per_card()),
           "engine": TorchEngine(BallistaConfig(), device="cpu")._hbm_budget(),
           "transport": [group.transport, group.transport_reason], "decisions": {}}
    tag = {"ballista.tpu.mesh_group.tag": "budget-gate",
           "ballista.tpu.mesh_group.size": str(nproc),
           "ballista.tpu.mesh_group.process_id": str(pid)}
    for label, settings in (("budget", {"ballista.engine.hbm_budget_bytes": "1000"}),
                            ("cap", {"ballista.tpu.fuse_input_max_rows": "10"})):
        engine = TorchEngine(BallistaConfig(dict(tag, **settings)), device="cpu")
        try:
            engine.execute_partition(phys, pid)
            out["decisions"][label] = "ran"
        except multihost.GangUnfusable as err:
            out["decisions"][label] = str(err)
    eng = NumpyEngine()
    mine = [eng.execute_partition(partial.input, i)
            for i in range(partial.input.output_partitions()) if i % nproc == pid]
    try:
        multihost.run_fused_aggregate_multihost(final, partial, mine, "budget-rows",
                                                max_rows=100)
        out["decisions"]["rows"] = "ran"
    except multihost.GangUnfusable as err:
        out["decisions"]["rows"] = str(err)
    with open(os.path.join(out_dir, f"budget-{pid}.json"), "w") as f:
        json.dump(out, f)


def main() -> None:
    pid, nproc = int(sys.argv[1]), int(sys.argv[2])
    coordinator, data_dir, out_dir = sys.argv[3], sys.argv[4], sys.argv[5]
    modes = sys.argv[6].split(",")
    device = sys.argv[7] if len(sys.argv) > 7 else "cpu"

    from ballista_tpu_torch.engine.numpy_engine import NumpyEngine
    from ballista_tpu_torch.parallel import multihost

    if "budget" in modes:
        # two members of one card, on the CPU
        multihost._card_identity = lambda device: "card-0"
        multihost._card_budget_bytes = lambda device: CARD_BYTES
    multihost.init_mesh_group(coordinator, nproc, pid, local_devices=2, device=device)
    assert multihost.in_mesh_group()
    eng = NumpyEngine()

    def mine_of(child):
        return [eng.execute_partition(child, i) for i in range(child.output_partitions())
                if i % nproc == pid]

    ctx = _context(data_dir)
    for mode in modes:
        if mode == "agg":
            final, partial = agg_nodes(plan_of(ctx, AGG_SQL))
            local = multihost.run_fused_aggregate_multihost(final, partial,
                                                            mine_of(partial.input), "agg")
            _write(out_dir, f"agg-{pid}.parquet", local)
        elif mode in ("join", "join-dup"):
            join = join_node(plan_of(ctx, JOIN_SQL, threshold=0), swap=mode == "join-dup")
            try:
                local = multihost.run_fused_join_multihost(
                    join, mine_of(join.left.input), mine_of(join.right.input), mode)
            except multihost.GangUnfusable as err:
                with open(os.path.join(out_dir, f"{mode}-{pid}.json"), "w") as f:
                    json.dump({"error": str(err)}, f)
                continue
            _write(out_dir, f"{mode}-{pid}.parquet", local)
        elif mode == "layout":
            phys, batches = layout_plan()
            final, partial = agg_nodes(phys)
            local = multihost.run_fused_aggregate_multihost(final, partial, [batches[pid]],
                                                            "layout")
            _write(out_dir, f"layout-{pid}.parquet", local)
        elif mode == "budget":
            _budget(pid, nproc, data_dir, out_dir)
        elif mode == "transport":
            group = multihost.current_group()
            with open(os.path.join(out_dir, f"transport-{pid}.json"), "w") as f:
                json.dump([group.transport, group.transport_reason,
                           group.shards_per_card()], f)
        else:
            raise SystemExit(f"unknown mode {mode}")
        print(f"WORKER {pid} {mode} done", flush=True)


if __name__ == "__main__":
    main()
