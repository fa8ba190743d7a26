"""The port's device joins and sort-based grouping, against the JAX package.

Kernels first, on one encoding carried into both packages
(``encoded_from_reference``): the int64 splitmix64, ``_canonical_dev``,
``hash_bucket_dev`` and ``group_ids_sorted`` must equal ``kernels_np`` and
``kernels_jax`` bit for bit. Then SQL: every join kind over small
``register_arrow`` tables, and TPC-H q1-q22, through the port's torch engine
on the CPU. The join cases' rows must equal the JAX engine's exactly (but
for one fault of the JAX engine, named at its test) and the port's numpy
engine's (floats within 1e-9 relative: it sums decimals in f64); the TPC-H
sweep holds floats to rtol 1e-6, the oracle's tolerance. The operator kinds
each engine ran on host kernels must be the same set.
"""
import math
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.engine import jax_engine as JE
from ballista_tpu.engine.dictionaries import REGISTRY as J_REGISTRY
from ballista_tpu.models.tpch import TPCH_TABLES
from ballista_tpu.ops import batch as JB
from ballista_tpu.ops import kernels_jax as KJ
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.engine.dictionaries import REGISTRY as T_REGISTRY
from ballista_tpu_torch.ops import batch as TB
from ballista_tpu_torch.ops import kernels_np as KNP
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.plan.expr import Col

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_kernels import _carry, _mixed_table
from test_tpch_numpy import ORDERED, assert_frames_match

QUERIES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries")
I64 = np.iinfo(np.int64)
# operator kinds a device engine may run on host kernels (scans, exchanges
# and merges are host work on every engine)
DEVICE_KINDS = ("FilterExec", "ProjectExec", "HashAggregateExec", "SortExec",
                "HashJoinExec", "CrossJoinExec", "WindowExec")


def _host_ops(metrics) -> set:
    return {k.split(".")[1] for k in metrics
            if k.endswith(".time_s") and k.split(".")[1] in DEVICE_KINDS}


def _cold_leaf_caches():
    """Both engines' content-keyed leaf caches emptied (the JAX engine's
    compiled programs kept): a cached fused input skips the stages below it,
    so engines compare operator kinds from the same, cold state, whatever
    other tests in this process ran before."""
    TE.clear_caches()
    JE._ENC_CACHE.clear()
    JE._DEV_CACHE.clear()


def _bits(a) -> np.ndarray:
    """int64 view of a torch, jax or numpy array of 64-bit ints."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int64)


# ---- splitmix64 and canonical keys ----------------------------------------------------
def test_splitmix64_bit_identical():
    edges = np.array([0, -1, I64.min, I64.max, 1, I64.min + 1], np.int64)
    rand = np.random.default_rng(5).integers(I64.min, I64.max, 10_000, dtype=np.int64,
                                             endpoint=True)
    x = np.concatenate([edges, rand])
    got = _bits(KT.splitmix64_dev(torch.from_numpy(x)))
    assert np.array_equal(got, _bits(KNP.splitmix64(x.view(np.uint64))))
    assert np.array_equal(got, _bits(KJ.splitmix64_dev(jnp.asarray(x.view(np.uint64)))))


def _shared(db_j, db_t, name):
    """Column ``name`` of both batches, its dictionary installed under one
    dict_id in both packages' registries."""
    cj, ct = db_j.col(name), db_t.col(name)
    did = f"test.{name}@v1:shared"
    J_REGISTRY.ensure(did, cj.dictionary)
    T_REGISTRY.ensure(did, ct.dictionary)
    return (KJ.DeviceCol(cj.dtype, cj.data, cj.null, cj.dictionary, dict_id=did),
            KT.DeviceCol(ct.dtype, ct.data, ct.null, ct.dictionary, dict_id=did))


@pytest.fixture(scope="module")
def mixed_dbs():
    return _carry(KJ.encode_host_batch(JB.ColumnBatch.from_arrow(_mixed_table())))


@pytest.mark.parametrize("name", ["i", "i32", "dec", "flt", "s", "s_shared", "d", "b", "row",
                                  "negzero"])
def test_canonical_dev_bit_identical(mixed_dbs, name):
    """Ints with nulls and extremes, a scaled decimal, f64 with nulls, strings
    with nulls with and without a shared dictionary, dates, bools, and f64
    -0.0 (canonical as 0.0)."""
    db_j, db_t = mixed_dbs
    if name == "s_shared":
        cj, ct = _shared(db_j, db_t, "s")
    elif name == "negzero":
        vals = np.array([-0.0, 0.0, 1.5, -2.25, np.nan, np.inf], np.float64)
        cj = KJ.DeviceCol(KJ.DataType.FLOAT64, jnp.asarray(vals))
        ct = KT.DeviceCol(KT.DataType.FLOAT64, torch.from_numpy(vals))
    else:
        cj, ct = db_j.col(name), db_t.col(name)
    got = _bits(KT._canonical_dev(ct))
    assert np.array_equal(got, _bits(KJ._canonical_dev(cj))), name
    if name == "negzero":
        assert got[0] == got[1] == 0


@pytest.mark.parametrize("n", [1, 3, 16, 1000])
@pytest.mark.parametrize("keys", [["i"], ["s"], ["dec"], ["flt"], ["d"], ["b"], ["i", "s", "d"],
                                  ["dec", "flt", "i32"]],
                         ids=lambda k: "+".join(k))
def test_hash_bucket_dev_matches_host_partitioning(keys, n):
    """Buckets equal ``kernels_np.hash_partition_indices`` on the same rows,
    nulls included (the host fills them with 0 / "", the device
    canonicalizes them to the same)."""
    batch = TB.ColumnBatch.from_arrow(_mixed_table(n=1000, seed=8))
    want = KNP.hash_partition_indices(batch, [Col(k) for k in keys], n)
    db = KT.to_device(batch, "cpu")
    got = KT.hash_bucket_dev(db, [db.col(k) for k in keys], n)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[: batch.num_rows], want)


# ---- sorted grouping ----------------------------------------------------------------
@pytest.mark.parametrize("k", [None, 16], ids=["k=n_pad", "k=16"])
@pytest.mark.parametrize("keys", [["i"], ["s", "i"], ["s", "flt", "d"], ["s_shared", "dec"]],
                         ids=lambda k: "+".join(k))
def test_group_ids_sorted_matches_jax(mixed_dbs, keys, k):
    """ids and representative rows equal ``KJ.group_ids_sorted`` on keys with
    nulls; with k = 16 the later segments go to the trash id."""
    db_j, db_t = mixed_dbs
    cols_j, cols_t = [], []
    for name in keys:
        cj, ct = _shared(db_j, db_t, "s") if name == "s_shared" else (db_j.col(name),
                                                                       db_t.col(name))
        cols_j.append(cj)
        cols_t.append(ct)
    # rows past n_rows are invalid padding, and some valid rows masked too
    rv = db_t.row_valid.clone()
    rv[::7] = False
    db_t = KT.DeviceBatch(db_t.schema, db_t.cols, rv, db_t.n_rows)
    db_j = KJ.DeviceBatch(db_j.schema, db_j.cols, jnp.asarray(rv.numpy()), db_j.n_rows)
    ids_t, reps_t = KT.group_ids_sorted(db_t, cols_t, k)
    ids_j, reps_j = KJ.group_ids_sorted(db_j, cols_j, k)
    assert ids_t.dtype == reps_t.dtype == torch.int64
    assert np.array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert np.array_equal(reps_t.numpy(), np.asarray(reps_j))
    kk = db_t.n_pad if k is None else k
    assert int(ids_t.max()) == kk and int(ids_t[rv].min()) == 0


# ---- join semantics over small tables ---------------------------------------------------
def _probe_table(n=700, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(rng.integers(0, 80, n).astype(np.int64), mask=rng.random(n) < 0.1),
        "v": pa.array(np.round(rng.uniform(0, 100, n), 2)),
        "s": pa.array(rng.choice(np.array(["ant", "bee", "cat", "dog"], object), n).tolist(),
                      mask=rng.random(n) < 0.1),
    })


def _build_table(case: str, seed=2):
    """The build side: ``unique`` keys, ``runs`` of 1-20 rows a key, or
    ``long_runs`` (one key 40 times); each with NULL keys."""
    rng = np.random.default_rng(seed)
    if case == "unique":
        keys = rng.permutation(60)
    elif case == "runs":
        keys = np.repeat(np.arange(60), rng.integers(1, 21, 60))
    else:
        keys = np.concatenate([np.arange(60), np.full(39, 7)])
    keys = rng.permutation(np.concatenate([keys, np.zeros(5, np.int64)])).astype(np.int64)
    m = len(keys)
    null = np.zeros(m, bool)
    null[np.nonzero(keys == 0)[0][:5]] = True
    return pa.table({
        "k": pa.array(keys, mask=null),
        "w": pa.array(rng.integers(0, 100, m).astype(np.int64)),
        "t": pa.array(rng.choice(np.array(["x", "y", "z"], object), m).tolist()),
    })


JOIN_SQL = {
    "inner": "select a.id, a.s, a.v, b.k, b.w, b.t from a join {b} b on a.k = b.k{f}",
    "left": "select a.id, a.s, a.v, b.k, b.w, b.t from a left join {b} b on a.k = b.k{f}",
    "right": "select a.id, a.s, a.v, b.k, b.w, b.t from a right join {b} b on a.k = b.k{f}",
    "full": "select a.id, a.s, a.v, b.k, b.w, b.t from a full join {b} b on a.k = b.k{f}",
    "semi": "select a.id, a.s, a.v from a where exists "
            "(select * from {b} b where b.k = a.k{f})",
    "anti": "select a.id, a.s, a.v from a where not exists "
            "(select * from {b} b where b.k = a.k{f})",
}
FILTER = " and b.w < a.v"


@pytest.fixture(scope="module")
def join_ctxs():
    probe, tables = _probe_table(), {c: _build_table(c) for c in ("unique", "runs", "long_runs")}
    tables["empty"] = tables["unique"].slice(0, 0)
    ctxs = (BallistaContext.standalone(device="cpu"),
            BallistaContext.standalone(backend="numpy"),
            JaxContext.standalone(backend="jax"))
    for c in ctxs:
        c.register_arrow("a", probe, partitions=2)
        c.register_arrow("a_empty", probe.slice(0, 0))
        for name, t in tables.items():
            c.register_arrow(f"b_{name}", t, partitions=2)
    return ctxs


@pytest.fixture
def probes(monkeypatch):
    """(how, duplicate bucket, build rows) of each device join probe."""
    real = TE._probe_join
    seen = []

    def recording(plan, probe, build_dev, bk_sorted, max_dup):
        seen.append((plan.how, max_dup, int(bk_sorted.shape[0])))
        return real(plan, probe, build_dev, bk_sorted, max_dup)

    monkeypatch.setattr(TE, "_probe_join", recording)
    return seen


def _sorted_rows(table: pa.Table) -> list:
    cols = table.column_names
    rows = list(zip(*(table.column(c).to_pylist() for c in cols)))
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None else 0) for v in r))


def _close_rows(got: list, want: list) -> bool:
    """Equal rows, floats within 1e-9 relative: the numpy engine sums
    decimals in f64, the device engines in scaled int64."""
    return len(got) == len(want) and all(
        len(g) == len(w) and all(
            math.isclose(a, b, rel_tol=1e-9) if isinstance(a, float) and isinstance(b, float)
            else a == b for a, b in zip(g, w))
        for g, w in zip(got, want))


def _run_all(ctxs, sql, jax_agrees=lambda: True):
    """Runs ``sql`` on the three engines: the torch engine's rows must equal
    the numpy engine's, and the JAX engine's exactly when ``jax_agrees()``
    (asked after the torch run); the host operator kinds must equal the JAX
    engine's. Returns the torch engine's sorted rows and metrics."""
    tctx, nctx, jctx = ctxs
    got = tctx.sql(sql).collect()
    tm = dict(tctx.last_engine_metrics)
    host = nctx.sql(sql).collect()
    jax_rows = jctx.sql(sql).collect()
    rows = _sorted_rows(got)
    assert _close_rows(rows, _sorted_rows(host)), "torch vs numpy engine"
    assert (rows == _sorted_rows(jax_rows)) == jax_agrees(), "torch vs jax"
    assert _host_ops(tm) == _host_ops(jctx.last_engine_metrics)
    return rows, tm


@pytest.mark.parametrize("filt", [False, True], ids=["eq", "filter"])
@pytest.mark.parametrize("case", ["unique", "runs", "long_runs"])
@pytest.mark.parametrize("how", list(JOIN_SQL))
def test_join_matches_jax_and_host(join_ctxs, probes, how, case, filt):
    """Rows equal the numpy engine's and the JAX engine's, but for one fault
    of the JAX engine: a left or full join with a filter, probing a build
    side (or, partitioned, a build partition) of unique keys, keeps the
    values of a match the filter rejected in the build columns, where SQL
    and both host engines give NULL."""
    sql = JOIN_SQL[how].format(b=f"b_{case}", f=FILTER if filt else "")

    def jax_agrees():
        unique_probe = any(h == how and d == 1 for h, d, _ in probes)
        return not (filt and how in ("left", "full") and unique_probe)

    rows, m = _run_all(join_ctxs, sql, jax_agrees)
    assert rows
    dups = {d for h, d, _ in probes if h == how}
    if case == "long_runs" and how in ("semi", "anti"):
        # runs past MAX_BUILD_DUP: the JAX engine's host fallback, counted
        assert m.get("op.HostFallback.count", 0.0) > 0 and not dups
        return
    assert m.get("op.HostFallback.count", 0.0) == 0.0, m
    # partitioned builds (right, full) give each partition its own bucket
    assert max(dups) == {"unique": 1, "runs": 32, "long_runs": 64}[case]


@pytest.mark.parametrize("how", list(JOIN_SQL))
@pytest.mark.parametrize("side", ["build", "probe"])
def test_join_with_an_empty_side(join_ctxs, probes, how, side):
    sql = JOIN_SQL[how].format(b="b_empty" if side == "build" else "b_runs", f="")
    if side == "probe":
        sql = sql.replace("from a ", "from a_empty a ")
    _rows, m = _run_all(join_ctxs, sql)
    assert m.get("op.HostFallback.count", 0.0) == 0.0, m
    assert any(h == how for h, _, _ in probes)
    if side == "build":
        assert {rows for h, _, rows in probes if h == how} == {0}


def test_cross_join_with_scalar_subquery(join_ctxs):
    sql = ("select a.id, a.v, a.s from a where a.v > "
           "(select avg(b.w) from b_runs b) and a.s is not null")
    rows, m = _run_all(join_ctxs, sql)
    assert rows and m.get("op.HostFallback.count", 0.0) == 0.0, m


def test_grouping_after_a_join_runs_on_the_sorted_path(join_ctxs):
    """GROUP BY a join's gathered columns: the nulls a gather leaves are one
    group, and the decimal sums equal the JAX engine's exactly."""
    sql = ("select b.k, b.t, sum(a.v) as sv, count(*) as n from a left join b_runs b "
           "on a.k = b.k group by b.k, b.t")
    rows, m = _run_all(join_ctxs, sql)
    assert any(r[0] is None for r in rows)
    assert m.get("op.HostFallback.count", 0.0) == 0.0, m


# ---- TPC-H -----------------------------------------------------------------------------
def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def tpch_ctxs(torch_tpch_dir):
    tctx = BallistaContext.standalone(device="cpu")
    jctx = JaxContext.standalone(backend="jax")
    for c in (tctx, jctx):
        for t in TPCH_TABLES:
            c.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return tctx, jctx


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 23)])
def test_tpch_host_operators_and_rows_match_jax(tpch_ctxs, qname):
    tctx, jctx = tpch_ctxs
    _cold_leaf_caches()
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    tm = dict(tctx.last_engine_metrics)
    want = jctx.sql(_sql(qname)).collect().to_pandas()
    assert _host_ops(tm) == _host_ops(jctx.last_engine_metrics), qname
    assert_frames_match(got, want, qname in ORDERED, f"{qname} vs jax")


def test_no_host_fallback_q2_q3_q10_q18(tpch_ctxs):
    """Device sort and top-k, bounded-duplicate emit joins and nullable group
    keys keep these queries on the device: no operator the device could run
    may appear among the host operators' metrics."""
    from ballista_tpu_torch.engine.torch_engine import TorchEngine
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    ctx = tpch_ctxs[0]
    for q in (2, 3, 10, 18):
        plan = SqlPlanner(ctx.catalog.schemas()).plan(parse_sql(_sql(f"q{q}")))
        phys = PhysicalPlanner(ctx.catalog, ctx.config).plan(optimize(plan))
        eng = TorchEngine(ctx.config, device="cpu")
        eng.execute_all(phys)
        assert not _host_ops(eng.op_metrics), f"q{q} host fallbacks"
        assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0
        assert eng.op_metrics.get("op.DeviceExecute.count", 0.0) > 0
