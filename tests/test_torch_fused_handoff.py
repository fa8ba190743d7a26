"""A fused program's output handed to its consumer on the device, on the CPU.

A fused join's or fused aggregate's output stays a ``DeviceBatch``; a
device stage that reads it builds its leaf there (``KT.encode_device_batches``,
``op.FusedOutput.device_handoffs``), and only a host consumer fetches it.

* TPC-H q3, q5 and q12 over the benchmark's generator at SF 0.1, 4 files a
  table, 16 shuffle partitions and ``broadcast_rows_threshold`` 10,000 (the
  SF1 and SF10 cells' plan shapes: q3 one fused join, q5 two, q12 one with
  its roles exchanged): answers equal to the host engine's, cold and warm.
  Warm, no fused input is built on the host (before the hand-off q5 built 2
  there and q3 and q12 1 each) and each fused output above which a device
  stage runs is handed off: the joins' and the final aggregate's, whose sort
  runs on the device. Every hand-off's encoding is the host encode of the
  fetched output: metadata and every element.
* A left fused join whose unmatched rows put NULLs in a string column: the
  device build declines, the output is fetched and encoded on the host, and
  the answer is the host engine's.
* A fused aggregate under a host projection and a host sort (on values only
  the host evaluates) fetches its output once.
* A handed-off output asked for again by a host consumer (a stage that falls
  back after collecting its leaves) comes back as the rows it held; a
  task's end fetches what is still held, and after a failed task the
  program runs again.
* Two jobs through one executor, whose stage engines outlive their tasks:
  after every task no fused output is left on the device.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import Column, ColumnBatch
from ballista_tpu_torch.plan.schema import DataType, Field, Schema

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_tpch_numpy import assert_frames_match

PORTBENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "portbench")
TABLES = ["region", "nation", "supplier", "customer", "orders", "lineitem"]


@pytest.fixture(scope="module")
def bench_tpch(tmp_path_factory):
    """The benchmark's TPC-H tables (``portbench/datagen.py``) at SF 0.1,
    4 files a large table."""
    sys.path.insert(0, PORTBENCH)
    try:
        import datagen
    finally:
        sys.path.remove(PORTBENCH)
    root = str(tmp_path_factory.mktemp("bench_tpch"))
    return datagen.write_tables(datagen.make_tables(0.1, 2100001101, TABLES), root, 4)


def _bench_sql(qname: str) -> str:
    """A cell's query template with its validation literals."""
    with open(os.path.join(PORTBENCH, "queries", f"{qname}.json")) as f:
        literals = json.load(f)["validation"]
    with open(os.path.join(PORTBENCH, "queries", f"{qname}.sql")) as f:
        return f.read().format(**literals)


def _ctx(paths: dict, backend: str = "torch", **settings) -> BallistaContext:
    config = BallistaConfig({k: str(v) for k, v in settings.items()})
    ctx = BallistaContext.standalone(config, device="cpu", backend=backend)
    for name, path in paths.items():
        ctx.register_parquet(name, path)
    return ctx


@pytest.fixture
def handoffs_checked(monkeypatch):
    """Every hand-off's device encoding, held against the host encode of
    the output fetched (what the consumer built before the hand-off)."""
    seen = []
    real = TE.TorchEngine._leaf_of

    def checked(self, held):
        host = KT.to_host(held) if isinstance(held, KT.DeviceBatch) else None
        out = real(self, held)
        if host is not None and KT.held_on_device(out):
            _assert_same_encoding(out, KT.encode_host_batch(host))
            seen.append(out.n_rows)
        return out

    monkeypatch.setattr(TE.TorchEngine, "_leaf_of", checked)
    return seen


def _assert_same_encoding(got: KT.EncodedBatch, want: KT.EncodedBatch) -> None:
    assert KT.held_on_device(got) and not KT.held_on_device(want)
    assert (got.n_rows, got.n_pad) == (want.n_rows, want.n_pad)
    for g, w in zip(got.col_meta, want.col_meta, strict=True):
        assert (g[0], g[1], g[3]) == (w[0], w[1], w[3])
        assert (g[2] is None) == (w[2] is None)
        assert g[2] is None or np.array_equal(g[2], w[2])
    assert got.int_ranges == want.int_ranges and got.ssums == want.ssums
    assert got.dict_ids == want.dict_ids
    for g, w in zip(got.arrays, want.arrays, strict=True):
        assert g.dtype == torch.from_numpy(w).dtype and np.array_equal(g.numpy(), w)


# query -> (its fused programs whose output a device stage reads: joins and
# the final aggregate, host builds of its fused inputs before the hand-off)
HANDOFFS = {"q3": (2, 1), "q5": (3, 2), "q12": (2, 1)}


@pytest.mark.parametrize("qname", sorted(HANDOFFS))
def test_fused_outputs_reach_their_consumers_on_the_device(bench_tpch, handoffs_checked,
                                                           qname):
    handoffs, host_builds_before = HANDOFFS[qname]
    settings = {"ballista.shuffle.partitions": 16,
                "ballista.optimizer.broadcast_rows_threshold": 10_000}
    ctx = _ctx(bench_tpch, **settings)
    want = _ctx(bench_tpch, "numpy", **settings).sql(_bench_sql(qname)).collect().to_pandas()
    LC.clear()
    runs = []
    for _run in ("cold", "warm"):
        got = ctx.sql(_bench_sql(qname)).collect().to_pandas()
        assert_frames_match(got, want, True, qname)
        runs.append(dict(ctx.last_engine_metrics))
    cold, warm = runs
    assert warm.get("op.FusedIciJoin.count", 0.0) == 16 * (handoffs - 1)
    assert warm["op.FusedOutput.device_handoffs"] == handoffs
    assert cold["op.FusedOutput.device_handoffs"] == handoffs
    assert len(handoffs_checked) == 2 * handoffs
    # every fused input above a fused program is built on the device now
    assert "op.FusedInput.host_builds" not in warm
    assert "op.FusedInput.host_builds" not in cold
    assert warm["op.FusedInput.device_builds"] == host_builds_before
    assert warm.get("op.HostFallback.count", 0.0) == 0.0
    # only the 16 sort stages' outputs leave the device
    assert warm["op.DeviceFetch.count"] == 16


LEFT_JOIN_SQL = """
select c_mktsegment, count(*) as n, sum(o_totalprice) as total
from orders left join (select c_custkey, c_mktsegment from customer where c_acctbal > 5000) c
  on o_custkey = c_custkey
group by c_mktsegment
order by c_mktsegment
"""


def test_left_join_with_null_strings_takes_the_fetch(torch_tpch_dir, monkeypatch):  # noqa: F811
    """Unmatched orders give NULL segments: the device build declines (the
    host codes a NULL as "", which the shared dictionary may lack), so the
    join's output is fetched and its consumer encodes it on the host; the
    aggregate above keeps a NULL group, and declines too."""
    paths = {t: os.path.join(torch_tpch_dir, t) for t in ("orders", "customer")}
    declined = []
    real = KT.encode_device_batches

    def recording(parts, *args, **kw):
        got = real(parts, *args, **kw)
        declined.append(got is None)
        return got

    monkeypatch.setattr(KT, "encode_device_batches", recording)
    ctx = _ctx(paths, **{"ballista.optimizer.broadcast_rows_threshold": 0})
    want = _ctx(paths, "numpy").sql(LEFT_JOIN_SQL).collect().to_pandas()
    LC.clear()
    got = ctx.sql(LEFT_JOIN_SQL).collect().to_pandas()
    assert want["c_mktsegment"].isna().sum() == 1
    for frame in (got, want):  # a NULL group compares as a value
        frame["c_mktsegment"] = frame["c_mktsegment"].fillna("<NULL>")
    assert_frames_match(got, want, False, "left join")
    m = ctx.last_engine_metrics
    assert m["op.FusedIciJoin.count"] == 16 and m["op.FusedIciExchange.count"] == 16
    assert "op.FusedOutput.device_handoffs" not in m
    assert m["op.FusedInput.host_builds"] == 1.0
    assert declined.count(True) >= 2


HOST_SORT_SQL = """
select l_returnflag, l_linestatus, coalesce(sum(l_quantity), 0) as sum_qty, count(*) as n
from lineitem
group by l_returnflag, l_linestatus
order by coalesce(l_returnflag, ''), l_linestatus
"""


def test_aggregate_under_a_host_sort_fetches_its_output_once(torch_tpch_dir):  # noqa: F811
    """``coalesce`` runs on host kernels only, so the projection and the
    sort above a q1-like fused aggregate are host operators: warm, the
    aggregate's output is the one fetch of the run (its 16 partitions read
    by the projection, partition 0 fetched), and nothing is handed off."""
    paths = {"lineitem": os.path.join(torch_tpch_dir, "lineitem")}
    ctx = _ctx(paths)
    want = _ctx(paths, "numpy").sql(HOST_SORT_SQL).collect().to_pandas()
    LC.clear()
    for _run in ("cold", "warm"):
        got = ctx.sql(HOST_SORT_SQL).collect().to_pandas()
        assert_frames_match(got, want, True, "host sort")
    m = ctx.last_engine_metrics
    assert m["op.FusedIciExchange.count"] == 16
    assert m["op.DeviceFetch.count"] == 1
    assert "op.FusedOutput.device_handoffs" not in m


def _decimal_batch() -> ColumnBatch:
    rng = np.random.default_rng(7)
    n = 1000
    schema = Schema((Field("k", DataType.INT64, False), Field("price", DataType.FLOAT64, True)))
    price = np.round(rng.uniform(0, 1e5, n), 2)
    valid = rng.random(n) > 0.1
    return ColumnBatch(schema, [Column(DataType.INT64, rng.integers(0, 1 << 40, n)),
                                Column(DataType.FLOAT64, price, valid)])


def test_handed_off_output_asked_for_by_the_host_gives_its_rows():
    """Partition 0 held on the device: a device consumer builds from it
    (one hand-off, the encoding held in its place and counted once however
    often the stage reads it); a host consumer after it reads the same rows
    back, fetched once, and an empty partition passes through untouched."""
    batch = _decimal_batch()
    engine = TE.TorchEngine(device="cpu")
    empty = ColumnBatch.empty(batch.schema)
    held = KT.to_device(batch, "cpu")
    engine._fused[1] = result = [held, empty]
    built = engine._leaf_of(held)
    assert KT.held_on_device(built) and result[0] is built
    assert engine._leaf_of(built) is built
    assert engine.op_metrics["op.FusedOutput.device_handoffs"] == 1.0
    _assert_same_encoding(built, KT.encode_host_batch(batch))
    rows = engine._on_host(built)
    assert isinstance(rows, ColumnBatch) and result[0] is rows
    assert engine._on_host(rows) is rows
    assert engine.op_metrics["op.DeviceFetch.count"] == 1.0
    assert rows.to_arrow().equals(batch.to_arrow())
    assert engine._on_host(empty) is empty
    # a host batch held: a device consumer encodes it on the host, uncounted
    assert not KT.held_on_device(engine._leaf_of(rows))
    assert engine.op_metrics["op.FusedOutput.device_handoffs"] == 1.0


def test_a_task_end_leaves_nothing_held_on_the_device():
    """A task ends on an engine that outlives it (the executor's stage
    engines): a fused output still on the device, built into a leaf or not,
    is fetched for a later task's reader, and a host batch is kept; after a
    failed task the result is dropped and the program runs again, once."""
    batch = _decimal_batch()
    engine = TE.TorchEngine(device="cpu")
    empty = ColumnBatch.empty(batch.schema)
    engine._fused[1] = built = [KT.to_device(batch, "cpu"), empty]
    engine._fused[2] = unread = [KT.to_device(batch, "cpu"), empty]
    engine._fused[3] = kept = [batch, empty]
    engine._leaf_of(built[0])
    assert KT.held_on_device(built[0])
    engine._unhold(fetch=True)
    for result in (built, unread):
        assert isinstance(result[0], ColumnBatch)
        assert result[0].to_arrow().equals(batch.to_arrow())
    assert kept[0] is batch and engine.op_metrics["op.DeviceFetch.count"] == 2.0
    engine._fused[4] = [KT.to_device(batch, "cpu"), empty]
    engine._unhold(fetch=False)
    assert sorted(engine._fused) == [1, 2, 3]
    runs = []

    def run():
        runs.append(1)
        return [KT.to_device(batch, "cpu"), empty]

    def part(p):
        return engine._fused_part(4, p, "op.FusedIciJoin.count", None, "declined", run)

    assert isinstance(part(0), KT.DeviceBatch) and part(1) is empty and len(runs) == 1


def test_executor_stage_engines_hold_nothing_on_the_device_after_a_task(
        torch_tpch_dir, tmp_path):  # noqa: F811
    """Two jobs through one executor with inline exchanges: each stage's
    tasks share one engine (``Executor._engine_for``), which outlives them.
    Fused programs run there and their outputs are handed to the stages
    above them, and after every task no engine holds a fused output on the
    device: the answers are the host engine's."""
    from ballista_tpu_torch.client.standalone import start_standalone_cluster

    settings = {"ballista.tpu.fuse_exchange_max_rows": 10_000_000,
                "ballista.optimizer.broadcast_rows_threshold": 0}
    tables = ("lineitem", "orders", "customer")
    paths = {t: os.path.join(torch_tpch_dir, t) for t in tables}
    queries = {q: _bench_sql(q) for q in ("q1", "q3")}
    c = start_standalone_cluster(n_executors=1, task_slots=2, backend="torch",
                                 device="cpu", work_dir=str(tmp_path))
    try:
        ctx = BallistaContext.remote("127.0.0.1", c.scheduler_port,
                                     BallistaConfig({k: str(v) for k, v in settings.items()}))
        for name, path in paths.items():
            ctx.register_parquet(name, path)
        host = _ctx(paths, "numpy", **settings)
        for qname, sql in queries.items():
            got = ctx.sql(sql).collect().to_pandas()
            assert_frames_match(got, host.sql(sql).collect().to_pandas(), True, qname)
        engines = [e for e, lock, _plan in c.executors[0].executor._stage_engines.values()]
    finally:
        c.stop()
    results = [r for e in engines for r in e._fused.values() if isinstance(r, list)]
    assert results, "no fused program ran on a shared stage engine"
    assert sum(e.op_metrics.get("op.FusedOutput.device_handoffs", 0.0) for e in engines) >= 1
    for r in results:
        assert not isinstance(r[0], (KT.DeviceBatch, KT.EncodedBatch))
