"""Bounded-memory spill paths of the port, and its two exact-memory repairs.

Mirrors ``tests/test_spill.py`` with ``backend`` in ``numpy`` and ``torch``
(``device="cpu"``): the standalone exchange spilling to per-partition IPC
files past ``ballista.exchange.spill_rows``, streamed final aggregates
spilling partial states to salted buckets past
``ballista.agg.spill_state_rows``, their boundaries, the duplicate-heavy
paged join and ``SpilledParts``. Each case also runs the JAX package on the
same seeded table: ints exact, f64 sums within rtol 1e-9 (the JAX test's
tolerance: folds add in another order).

Then two faults of the port against the reference, each with a case the
unrepaired code fails:

* the host window kernels summed decimals as differences of f64 prefix sums
  and searched a RANGE frame over a decimal key in f64; both are exact
  int64 now, held to an exact int64 reference (the JAX package's host
  engine keeps its f64 behaviour, and the cases show it missing);
* the memory governor's stage estimate counted what a compiled XLA program
  holds; eager torch holds more, so ``estimate_eager_program_bytes`` adds
  the window, join-output and expression terms (on the card, chip_smoke.py
  holds it above every measured stage peak).
"""
from decimal import Decimal
from fractions import Fraction

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu_torch.client.context import BallistaContext
from test_torch_stream import JAX, PORT

N = 120_000
SQL = "select id6, sum(v1) as v1, sum(v3) as v3 from x group by id6"
BACKENDS = ["numpy", "torch"]


def _ctx(backend, config=None):
    kw = {"device": "cpu"} if backend == "torch" else {}
    return BallistaContext.standalone(config=config, backend=backend, **kw)


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(11)
    return pa.table({
        "id6": rng.integers(1, N // 2, N),
        "v1": rng.integers(1, 6, N),
        "v3": np.round(rng.uniform(0, 100, N), 6),
    })


def _pandas_want(t: pa.Table) -> pd.DataFrame:
    return (t.to_pandas().groupby("id6").agg(v1=("v1", "sum"), v3=("v3", "sum"))
            .reset_index().sort_values("id6").reset_index(drop=True))


@pytest.fixture(scope="module")
def want(table):
    return _pandas_want(table)


def check(got: pd.DataFrame, want: pd.DataFrame):
    got = got.sort_values("id6").reset_index(drop=True)
    assert len(got) == len(want)
    assert np.array_equal(got.id6, want.id6)
    assert np.array_equal(got.v1, want.v1)
    assert np.allclose(got.v3, want.v3, rtol=1e-9)


def _spill_run(ctx, t, rows, fuse_cap, parts):
    ctx.config.set("ballista.exchange.spill_rows", rows)
    # the fused device exchange would bypass the materialized path
    ctx.config.set("ballista.tpu.fuse_input_max_rows", fuse_cap)
    ctx.register_arrow("x", t, partitions=parts)
    return ctx.sql(SQL).collect().to_pandas()


@pytest.mark.parametrize("backend", BACKENDS)
def test_exchange_spill_standalone(backend, table, want):
    """The in-process exchange switches to disk mid-stream; rows equal the
    in-memory path's and the JAX package's spilled run."""
    c = _ctx(backend)
    got = _spill_run(c, table, 10_000, 10_000, 4)
    check(got, want)
    assert c.last_engine_metrics.get("op.ExchangeSpill.rows", 0) > 0
    j = JaxContext.standalone(backend="numpy")
    check(got, _spill_run(j, table, 10_000, 10_000, 4).sort_values("id6").reset_index(drop=True))
    assert c.last_engine_metrics["op.ExchangeSpill.rows"] == \
        j.last_engine_metrics["op.ExchangeSpill.rows"]


def _final_over_coalesce(pkg, batch, nparts=None, halves=False):
    P, E = pkg.phys, pkg.expr
    if halves:
        parts = [batch.slice(0, N // 2), batch.slice(N // 2, N)]
    else:
        step = (batch.num_rows + nparts - 1) // nparts
        parts = [batch.slice(i * step, step) for i in range(nparts)]
    group = [E.Col("id6")]
    aggs = [E.Alias(E.Agg("sum", E.Col("v1")), "v1"), E.Alias(E.Agg("sum", E.Col("v3")), "v3")]
    partial = P.HashAggregateExec(input=P.MemoryScanExec(parts, batch.schema), mode="partial",
                                  group_exprs=group, agg_exprs=aggs,
                                  input_schema_for_aggs=batch.schema)
    return P.HashAggregateExec(input=P.CoalescePartitionsExec(partial), mode="final",
                               group_exprs=group, agg_exprs=aggs,
                               input_schema_for_aggs=batch.schema)


def _stream_agg(backend, final, budget):
    from ballista_tpu_torch.engine.engine import create_engine

    cfg = PORT.cfg.BallistaConfig().set("ballista.agg.spill_state_rows", str(budget))
    kw = {"device": "cpu"} if backend == "torch" else {}
    eng = create_engine(backend, cfg, **kw)
    fold = eng._stream_final_agg if backend == "numpy" else eng._stream_device_final_agg
    return list(fold(final, 0)), eng


@pytest.mark.parametrize("backend", BACKENDS)
def test_agg_state_spill_streamed(backend, table, want):
    """Streamed final aggregation with a tiny state budget: chunk states
    spill to hash buckets and each bucket finalizes alone; the union equals
    the one-shot result and the JAX package's spilled fold."""
    out, eng = _stream_agg(backend, _final_over_coalesce(
        PORT, PORT.batch.ColumnBatch.from_arrow(table), nparts=6), 4000)
    assert len(out) > 1, "bucketed spill must emit one batch per non-empty bucket"
    got = pa.concat_tables([b.to_arrow() for b in out]).to_pandas()
    check(got, want)
    assert eng.op_metrics.get("op.AggSpill.rows", 0) > 0
    if backend == "torch":
        assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0
    jeng = JAX.numpy_engine.NumpyEngine(
        JAX.cfg.BallistaConfig().set("ballista.agg.spill_state_rows", "4000"))
    jout = list(jeng._stream_final_agg(
        _final_over_coalesce(JAX, JAX.batch.ColumnBatch.from_arrow(table), nparts=6), 0))
    check(got, pa.concat_tables([b.to_arrow() for b in jout]).to_pandas()
          .sort_values("id6").reset_index(drop=True))


def test_salted_buckets_decorrelate_from_exchange_hash(table):
    """An agg-spill input partition already satisfies
    splitmix64(key) % P == p; unsalted bucketing would collapse it into one
    bucket. The salted spill spreads it, into the same buckets as the JAX
    package's."""
    counts = []
    for pkg in (JAX, PORT):
        from importlib import import_module

        spill_mod = import_module(f"{pkg.name}.engine.spill")
        batch = pkg.batch.ColumnBatch.from_arrow(table)
        ids = pkg.knp.hash_partition_indices(batch, [pkg.expr.Col("id6")], 16)
        part3 = batch.take(np.nonzero(ids == 3)[0])
        assert part3.num_rows > 1000
        spill = spill_mod.PartitionSpill(16, [pkg.expr.Col("id6")], salted=True)
        spill.append_split(part3)
        spill.finish()
        counts.append([spill.rows(b) for b in range(16)])
        spill.close()
    assert sum(1 for r in counts[1] if r) >= 12, counts[1]
    assert counts[0] == counts[1]


@pytest.mark.parametrize("backend", BACKENDS)
def test_exchange_spill_boundary_exact_vs_plus_one(backend):
    """The exchange spills when accumulated rows exceed the budget: an input
    exactly budget-sized stays in memory, one row more flushes every row to
    disk; both match the oracle exactly."""
    rows = 10_000
    for extra, expect_spill in ((0, False), (1, True)):
        n = rows + extra
        t = pa.table({
            "id6": np.arange(n, dtype=np.int64),
            "v1": np.arange(n, dtype=np.int64) % 7,
            "v3": np.round(np.linspace(0, 100, n), 6),
        })
        c = _ctx(backend)
        got = _spill_run(c, t, rows, 1, 2)
        spilled = c.last_engine_metrics.get("op.ExchangeSpill.rows", 0)
        assert spilled == (n if expect_spill else 0), spilled
        check(got, _pandas_want(t))


@pytest.mark.parametrize("backend", BACKENDS)
def test_agg_state_spill_boundary_exact_vs_plus_one(backend, table):
    """The streamed aggregate spills when the resident fold exceeds the
    state budget: a budget equal to the group count finalizes in memory
    (one batch), one less bucket-spills; the unions are identical."""
    batch = PORT.batch.ColumnBatch.from_arrow(table)
    groups = int(len(np.unique(np.asarray(batch.columns[0].data))))
    outs = {}
    for budget, expect_spill in ((groups, False), (groups - 1, True)):
        got, eng = _stream_agg(backend, _final_over_coalesce(PORT, batch, halves=True), budget)
        spilled = eng.op_metrics.get("op.AggSpill.rows", 0)
        if expect_spill:
            assert spilled > 0 and len(got) > 1
        else:
            assert spilled == 0 and len(got) == 1
        df = pa.concat_tables([b.to_arrow() for b in got]).to_pandas()
        outs[expect_spill] = df.sort_values("id6").reset_index(drop=True)
    pd.testing.assert_frame_equal(outs[False], outs[True])


def test_paged_join_duplicate_heavy_single_bucket_skew():
    """Every build key identical: the salted spill lands all rows in one
    bucket, and the paged join emits the full fan-out exactly once, as the
    JAX engine's does."""
    probe = pa.table({"k": np.zeros(1_000, np.int64), "v": np.arange(1_000, dtype=np.int64)})
    build = pa.table({"k": np.zeros(40, np.int64), "w": np.arange(40, dtype=np.int64)})

    def run(paged: bool, jax: bool = False):
        pkg = JAX if jax else PORT
        cfg = pkg.cfg.BallistaConfig()
        cfg.set("ballista.optimizer.broadcast_rows_threshold", "0")
        cfg.set("ballista.shuffle.partitions", "2")
        cfg.set("ballista.tpu.ici_shuffle", "false")
        if paged:
            cfg.set("ballista.engine.hbm_budget_bytes", "10000")
            cfg.set("ballista.engine.max_shuffle_partitions", "2")
        c = (JaxContext.standalone(config=cfg, backend="jax") if jax
             else _ctx("torch", cfg))
        c.register_arrow("a", probe, partitions=2)
        c.register_arrow("b", build, partitions=2)
        return c, c.sql("select a.k, v, w from a join b on a.k = b.k order by v, w").collect()

    _, base = run(paged=False)
    ctx, got = run(paged=True)
    assert base.num_rows == 40_000
    assert got.equals(base)
    assert ctx.last_engine_metrics.get("op.PagedJoin.count", 0) > 0
    assert run(paged=True, jax=True)[1].equals(got)


def test_spilled_parts_roundtrip(table):
    sizes = []
    for pkg in (JAX, PORT):
        from importlib import import_module

        spill_mod = import_module(f"{pkg.name}.engine.spill")
        batch = pkg.batch.ColumnBatch.from_arrow(table)
        spill = spill_mod.PartitionSpill(8, [pkg.expr.Col("id6")])
        spill.append_split(batch.slice(0, N // 2))
        spill.append_split(batch.slice(N // 2, N))
        spill.finish()
        parts = spill_mod.SpilledParts(spill, batch.schema)
        assert len(parts) == 8
        sizes.append([parts[i].num_rows for i in range(8)])
        assert sum(sizes[-1]) == N
        seen = {}
        for i in range(8):
            for v in np.unique(np.asarray(parts[i].columns[0].data)):
                assert v not in seen, f"group {v} straddles partitions"
                seen[v] = i
        with pytest.raises(IndexError):
            parts[8]
        spill.close()
    assert sizes[0] == sizes[1]


# ---- exact decimal windows on the host kernels --------------------------------------
def _window(ctx_factory, t: pa.Table, sql: str) -> pa.Table:
    c = ctx_factory()
    c.register_arrow("t", t, partitions=1)
    return c.sql(sql).collect()


RANGE_SQL = ("select k, sum(v) over (order by k range between 0.1 preceding and "
             "0.1 following) as s, count(*) over (order by k range between 0.1 preceding "
             "and 0.1 following) as c from t order by k")


def test_decimal_range_frame_keeps_the_edge_row():
    """Keys 0.7 and 0.8 at an offset of 0.1: each row's frame holds the
    other (exactly 0.1 away). In f64, 0.7 + 0.1 < 0.8, so the unrepaired
    search dropped the edge row; the exact reference counts 2 rows."""
    keys = [0.1, 0.3, 0.7, 0.8, 1.2, 1.3, 1.35]
    t = pa.table({"k": pa.array(keys, pa.float64()),
                  "v": pa.array([float(i + 1) for i in range(len(keys))], pa.float64())})
    cents = [round(k * 100) for k in keys]
    want_c = [sum(1 for o in cents if abs(o - c) <= 10) for c in cents]
    want_s = [sum(i + 1 for i, o in enumerate(cents) if abs(o - c) <= 10) for c in cents]
    assert want_c[2] == want_c[3] == 2
    for backend in BACKENDS:
        got = _window(lambda: _ctx(backend), t, RANGE_SQL)
        assert got.column("c").to_pylist() == want_c, backend
        assert got.column("s").to_pylist() == [float(s) for s in want_s], backend
    ref = _window(lambda: JaxContext.standalone(backend="numpy"), t, RANGE_SQL)
    assert ref.column("c").to_pylist() != want_c  # the f64 search misses


RUNNING_SQL = ("select p, k, sum(d) over (partition by p order by k) as s, "
               "avg(d) over (partition by p order by k) as a, "
               "sum(d) over (partition by p order by k rows between 2 preceding and "
               "current row) as m from t order by p, k")


def test_decimal_running_sum_is_exact():
    """A running SUM, AVG and moving SUM of 2-decimal values in a partition
    sorted after one with a huge sum: f64 prefix differences there lose the
    last cent; int64 prefix sums of the scaled values do not. Held to an
    exact reference (``Decimal`` sums; the host's average as the correctly
    rounded quotient)."""
    rng = np.random.default_rng(61)
    # the big partition's sum stays under 2^53 cents: exact in int64 and in f64
    big = [Decimal(int(x)).scaleb(-2) for x in rng.integers(10**13, 10**14, 50)]
    small = [Decimal(int(x)).scaleb(-2) for x in rng.integers(1, 10_000, 50)]
    rows = [(0, i, d) for i, d in enumerate(big)] + [(1, i, d) for i, d in enumerate(small)]
    t = pa.table({"p": pa.array([r[0] for r in rows], pa.int64()),
                  "k": pa.array([r[1] for r in rows], pa.int64()),
                  "d": pa.array([float(r[2]) for r in rows], pa.float64())})
    want_s, want_a, want_m = [], [], []
    for p, vals in ((0, big), (1, small)):
        for i in range(len(vals)):
            run = sum(vals[: i + 1])
            want_s.append(float(run))
            want_a.append(float(Fraction(run) / (i + 1)))
            want_m.append(float(sum(vals[max(0, i - 2): i + 1])))
    for backend in BACKENDS:
        got = _window(lambda: _ctx(backend), t, RUNNING_SQL)
        assert got.column("s").to_pylist() == want_s, backend
        assert got.column("m").to_pylist() == want_m, backend
        if backend == "numpy":
            assert got.column("a").to_pylist() == want_a
        else:
            # the device's decimal average (the JAX engine's) is rounded to
            # 4 decimals here: within half a unit of the 4th (and the f64 ulp)
            a = np.array(got.column("a").to_pylist())
            assert np.all(np.abs(a - want_a) <= 0.5e-4 + 2 * np.spacing(np.abs(want_a)))
    ref = _window(lambda: JaxContext.standalone(backend="numpy"), t, RUNNING_SQL)
    assert ref.column("s").to_pylist() != want_s  # f64 prefix differences drift


# ---- the eager-torch terms of the stage estimate ------------------------------------
def _leaves_of(plan, batch):
    """A one-leaf layout as ``TorchEngine._collect_leaves`` makes it."""
    import ballista_tpu_torch.ops.kernels_torch as KT

    leaf = plan
    while leaf.children():
        leaf = leaf.children()[0]
    return {id(leaf): ("out", KT.encode_host_batch(batch), None, None, leaf)}


def test_eager_estimate_adds_window_and_join_terms():
    """The eager estimate never falls below the JAX-equal one; a framed
    window max adds at least its sparse table (levels x n x 8 bytes), an
    interior join at least its output."""
    import ballista_tpu_torch.engine.memory_model as MM
    from ballista_tpu_torch.plan.expr import CURRENT_ROW, PRECEDING, WindowFrame, WindowFunc

    P, E = PORT.phys, PORT.expr
    n = 5_000
    rng = np.random.default_rng(3)
    batch = PORT.batch.ColumnBatch.from_dict(
        {"g": rng.integers(0, 50, n).astype(np.int64), "x": rng.normal(size=n)})
    scan = P.MemoryScanExec([batch], batch.schema)
    frame = WindowFrame("rows", (PRECEDING, 20), (CURRENT_ROW, None))
    wf = E.Alias(WindowFunc("max", (E.Col("x"),), (E.Col("g"),), ((E.Col("x"), True),), frame),
                 "mx")
    win = P.WindowExec(scan, [wf])
    leaves = _leaves_of(win, batch)
    pad = 8192
    jax_est = MM.estimate_program_bytes(win, leaves)
    assert MM.estimate_eager_program_bytes(win, leaves) - jax_est >= pad.bit_length() * pad * 8

    build = PORT.batch.ColumnBatch.from_dict({"g2": np.arange(50, dtype=np.int64)})
    join = P.HashJoinExec(left=scan, right=P.MemoryScanExec([build], build.schema),
                          on=[(E.Col("g"), E.Col("g2"))], how="inner", collect_build=True)
    agg = P.HashAggregateExec(join, "single", [E.Col("g")],
                              [E.Alias(E.Agg("sum", E.Col("x")), "sx")])
    leaves = _leaves_of(agg, batch)
    out_bytes = pad * (MM.row_data_bytes(join.schema()) + 1)
    assert MM.estimate_eager_program_bytes(agg, leaves) - \
        MM.estimate_program_bytes(agg, leaves) >= out_bytes
