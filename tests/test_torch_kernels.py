"""kernels_torch against kernels_jax, on identical inputs.

One encoding feeds both packages: the JAX package's ``encode_host_batch``
output is carried into the port with ``encoded_from_reference`` (the
database's counterpart of carrying weights), then each package evaluates the
same expressions / groupings / sorts on its own device arrays. Integer,
boolean and scaled-decimal results must match exactly, dtype included;
float results within rtol 1e-6 (both compute in the same width; the bound
covers libm differences between XLA and torch on the CPU).
"""
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.ops import batch as JB
from ballista_tpu.ops import kernels_jax as KJ
from ballista_tpu.plan.schema import Schema as JSchema
from ballista_tpu.sql.parser import parse_sql as j_parse
from ballista_tpu.sql.planner import SqlPlanner as JPlanner
from ballista_tpu_torch.ops import batch as TB
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.plan.schema import Schema as TSchema
from ballista_tpu_torch.sql.parser import parse_sql as t_parse
from ballista_tpu_torch.sql.planner import SqlPlanner as TPlanner

from test_torch_data import torch_tpch_dir  # noqa: F401


# ---- shared inputs -----------------------------------------------------------------
def _carry(enc_j):
    """(JAX DeviceBatch, port DeviceBatch) over one encoding."""
    enc_t = KT.encoded_from_reference(
        enc_j.arrays, enc_j.col_meta, enc_j.n_rows, schema=enc_j.schema,
        int_ranges=enc_j.int_ranges, ssums=enc_j.ssums, dict_ids=enc_j.dict_ids,
    )
    db_j = KJ.device_batch_from_encoded(enc_j, [jnp.asarray(a) for a in enc_j.arrays])
    db_t = KT.device_batch_from_encoded(enc_t, [torch.from_numpy(np.array(a)) for a in enc_t.arrays])
    return db_j, db_t


@pytest.fixture(scope="module")
def lineitem(torch_tpch_dir):
    d = os.path.join(torch_tpch_dir, "lineitem")
    first = sorted(f for f in os.listdir(d) if f.endswith(".parquet"))[0]
    return pq.read_table(os.path.join(d, first)).slice(0, 3000)


@pytest.fixture(scope="module")
def lineitem_dbs(lineitem):
    return _carry(KJ.encode_host_batch(JB.ColumnBatch.from_arrow(lineitem)))


def _mixed_table(n=257, seed=3):
    """Ints with nulls and extremes, decimal and non-decimal f64, strings with
    nulls, dates, bools."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-50, 50, n).astype(np.int64)
    ints[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    null_i = rng.random(n) < 0.2
    null_i[:2] = False
    dec = np.round(rng.uniform(-1000, 1000, n), 2)
    flt = rng.standard_normal(n)
    strs = rng.choice(np.array(["apple", "kiwi", "fig", "plum", ""], dtype=object), n)
    null_s = rng.random(n) < 0.15
    return pa.table({
        "i": pa.array(ints, mask=null_i),
        "i32": pa.array(rng.integers(0, 9, n).astype(np.int32)),
        "dec": pa.array(dec),
        "flt": pa.array(flt, mask=rng.random(n) < 0.1),
        "s": pa.array(strs.tolist(), mask=null_s),
        "d": pa.array(rng.integers(8000, 10500, n).astype(np.int32)).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.5),
        "row": pa.array(np.arange(n, dtype=np.int64)),
    })


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same_array(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    if got.dtype.kind == "f":
        assert np.allclose(got, want, rtol=1e-6, equal_nan=True), what
    else:
        assert np.array_equal(got, want), what


def _assert_same_col(ct, cj, what):
    assert ct.dtype.value == cj.dtype.value, what
    _assert_same_array(ct.data, cj.data, f"{what}.data")
    assert (ct.null is None) == (cj.null is None), f"{what}: null layout"
    if ct.null is not None:
        _assert_same_array(ct.null, cj.null, f"{what}.null")
    assert ct.scale == cj.scale, f"{what}: scale {ct.scale} != {cj.scale}"
    assert ct.range == (None if cj.range is None else tuple(int(x) for x in cj.range)), what
    if cj.dictionary is not None:
        assert list(ct.dictionary) == list(cj.dictionary), f"{what}: dictionary"


# ---- encoding -------------------------------------------------------------------------
def test_encode_host_batch_byte_identical():
    table = _mixed_table()
    enc_j = KJ.encode_host_batch(JB.ColumnBatch.from_arrow(table))
    enc_t = KT.encode_host_batch(TB.ColumnBatch.from_arrow(table))
    assert enc_t.n_rows == enc_j.n_rows and enc_t.n_pad == enc_j.n_pad
    assert len(enc_t.arrays) == len(enc_j.arrays)
    for i, (a, b) in enumerate(zip(enc_t.arrays, enc_j.arrays)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f"array {i}"
    for (dt, hn, dic, sc), (dj, hj, dicj, scj) in zip(enc_t.col_meta, enc_j.col_meta):
        assert (dt.value, hn, sc) == (dj.value, hj, scj)
        assert (dic is None) == (dicj is None)
        if dic is not None:
            assert list(dic) == list(dicj)
    assert enc_t.int_ranges == enc_j.int_ranges
    assert enc_t.ssums == enc_j.ssums
    assert [f.name for f in enc_t.schema] == [f.name for f in enc_j.schema]


# ---- expressions ------------------------------------------------------------------
Q1_SQL = """select l_quantity, l_extendedprice,
    l_extendedprice * (1 - l_discount) as disc_price,
    l_extendedprice * (1 - l_discount) * (1 + l_tax) as charge,
    l_discount, l_returnflag, l_linestatus
from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day"""

Q6_SQL = """select l_extendedprice * l_discount as revenue from lineitem
where l_shipdate >= date '1994-01-01'
    and l_shipdate < date '1994-01-01' + interval '1' year
    and l_discount between 0.06 - 0.01 and 0.06 + 0.01
    and l_quantity < 24"""

MORE_SQL = """select extract(year from l_shipdate) as y, extract(month from l_shipdate) as m,
    case when l_returnflag = 'R' then l_extendedprice else 0 end as c,
    l_quantity / 7 as ratio, round(l_discount * l_tax, 3) as r,
    substr(l_shipinstruct, 1, 4) as si, l_linenumber % 3 as mod3,
    abs(l_extendedprice - 20000) as dist
from lineitem where l_shipmode in ('MAIL', 'SHIP') or l_comment like '%furious%'"""


def _project_and_filter(plan):
    proj = filt = None
    node = plan
    while node is not None:
        if proj is None and type(node).__name__ == "Project":
            proj = node.exprs
        if filt is None and type(node).__name__ == "Filter":
            filt = node.predicate
        node = getattr(node, "input", None)
    return proj, filt


@pytest.mark.parametrize("sql", [Q1_SQL, Q6_SQL, MORE_SQL], ids=["q1", "q6", "more"])
def test_eval_dev_matches(lineitem, lineitem_dbs, sql):
    db_j, db_t = lineitem_dbs
    pj, fj = _project_and_filter(
        JPlanner({"lineitem": JSchema.from_arrow(lineitem.schema)}).plan(j_parse(sql)))
    pt, ft = _project_and_filter(
        TPlanner({"lineitem": TSchema.from_arrow(lineitem.schema)}).plan(t_parse(sql)))
    assert len(pj) == len(pt)
    for ej, et in zip(pj, pt):
        _assert_same_col(KT.eval_dev(et, db_t), KJ.eval_dev(ej, db_j), et.name())
    vt, nt = KT.eval_dev_predicate(ft, db_t)
    vj, nj = KJ.eval_dev_predicate(fj, db_j)
    _assert_same_array(vt, vj, "predicate")
    assert (nt is None) == (nj is None)
    assert _np(vt)[: db_t.n_rows].any()  # the predicate selects something


# ---- grouping -------------------------------------------------------------------------
def test_group_ids_direct_and_decode(lineitem_dbs):
    db_j, db_t = lineitem_dbs
    names = ["l_returnflag", "l_linestatus", "l_linenumber"]
    kj = [db_j.col(n) for n in names]
    kt = [db_t.col(n) for n in names]
    plan_j = KJ.group_plan(kj, db_j.n_pad)
    plan_t = KT.group_plan(kt, db_t.n_pad)
    assert plan_t[0] == plan_j[0] == "direct"
    assert [tuple(int(x) for x in p) for p in plan_t[1]] == \
        [tuple(int(x) for x in p) for p in plan_j[1]]
    ids_j, k_j = KJ.group_ids_direct(db_j, kj, plan_j[1])
    ids_t, k_t = KT.group_ids_direct(db_t, kt, plan_t[1])
    assert k_t == k_j
    _assert_same_array(ids_t, ids_j, "ids")
    for ct, cj, n in zip(KT.decode_group_keys(kt, plan_t[1], k_t),
                         KJ.decode_group_keys(kj, plan_j[1], k_j), names):
        _assert_same_col(ct, cj, n)


def test_group_ids_with_null_keys():
    db_j, db_t = _carry(KJ.encode_host_batch(JB.ColumnBatch.from_arrow(_mixed_table())))
    kj = [db_j.col("s"), db_j.col("i32")]
    kt = [db_t.col("s"), db_t.col("i32")]
    _, per_j = KJ.group_plan(kj, db_j.n_pad)
    _, per_t = KT.group_plan(kt, db_t.n_pad)
    ids_j, k = KJ.group_ids_direct(db_j, kj, per_j)
    ids_t, k_t = KT.group_ids_direct(db_t, kt, per_t)
    assert k_t == k
    _assert_same_array(ids_t, ids_j, "ids")
    for ct, cj in zip(KT.decode_group_keys(kt, per_t, k), KJ.decode_group_keys(kj, per_j, k)):
        _assert_same_col(ct, cj, "key")


# ---- exact integer division -----------------------------------------------------------
TIES = np.array([-35, -25, -24, -15, -6, -5, -1, 0, 1, 5, 6, 15, 24, 25, 35,
                 np.iinfo(np.int64).max // 100, -(np.iinfo(np.int64).max // 100)], np.int64)


@pytest.mark.parametrize("div", [10, 2, 7])
def test_round_half_even_div(div):
    got = KT._round_half_even_div(torch.from_numpy(TIES), div)
    want = KJ._round_half_even_div(jnp.asarray(TIES), div)
    _assert_same_array(got, want, "round_half_even_div")


def test_avg_scaled_negative_and_ties():
    sums = np.array([-25, -15, -5, 5, 15, 25, -7, 7, 0, -1, 1, 10**12, -(10**12)], np.int64)
    cnts = np.array([10, 10, 2, 2, 10, 10, 3, 3, 0, 2, 2, 7, 7], np.int64)
    for scale, bound in ((2, 10**4), (0, 10**15), (7, 1 << 50)):
        qt, st, mt = KT.avg_scaled(torch.from_numpy(sums), torch.from_numpy(cnts), scale, bound)
        qj, sj, mj = KJ.avg_scaled(jnp.asarray(sums), jnp.asarray(cnts), scale, bound)
        assert (st, mt) == (sj, mj)
        _assert_same_array(qt, qj, f"avg_scaled scale={scale}")


# ---- sort -------------------------------------------------------------------------------
@pytest.mark.parametrize("fetch", [None, 5, 100])
@pytest.mark.parametrize("keys", [
    [("i", False), ("s", True)],
    [("s", False), ("flt", True), ("i", True)],
    [("dec", False)],
    [("d", True), ("b", False), ("i", False)],
], ids=["i-desc,s", "s-desc,flt,i", "dec-desc", "d,b-desc,i-desc"])
def test_sort_device(keys, fetch):
    """Nulls, descending keys (incl. int64 min, whose negation wraps in
    both), strings by code, floats, top-k fetch."""
    db_j, db_t = _carry(KJ.encode_host_batch(JB.ColumnBatch.from_arrow(_mixed_table())))
    out_j = KJ.sort_device(db_j, [(db_j.col(n), asc) for n, asc in keys], fetch)
    out_t = KT.sort_device(db_t, [(db_t.col(n), asc) for n, asc in keys], fetch)
    assert out_t.n_rows == out_j.n_rows and out_t.n_pad == out_j.n_pad
    _assert_same_array(out_t.row_valid, out_j.row_valid, "row_valid")
    for f, ct, cj in zip(db_t.schema, out_t.cols, out_j.cols):
        _assert_same_col(ct, cj, f.name)


def test_sort_desc_int64_min_wraps_like_jax():
    """-x on int64 min wraps to int64 min in both packages, so a descending
    sort puts it first rather than last."""
    vals = np.array([3, np.iinfo(np.int64).min, -2, 7], np.int64)
    table = pa.table({"x": pa.array(vals)})
    db_j, db_t = _carry(KJ.encode_host_batch(JB.ColumnBatch.from_arrow(table)))
    out_t = KT.sort_device(db_t, [(db_t.col("x"), False)])
    out_j = KJ.sort_device(db_j, [(db_j.col("x"), False)])
    _assert_same_array(out_t.cols[0].data, out_j.cols[0].data, "x")
    assert int(out_t.cols[0].data[0]) == np.iinfo(np.int64).min


# ---- transfer ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [257, 600_000], ids=["plain-fetch", "compact-fetch"])
def test_to_device_to_host_round_trip(n):
    """A ColumnBatch survives to_device -> to_host unchanged; 600k rows pad to
    2^20 and exceed the compact-fetch threshold, so that path runs too."""
    table = _mixed_table(n)
    batch = TB.ColumnBatch.from_arrow(table)
    db = KT.to_device(batch, "cpu")
    assert db.n_pad == KT.bucket_size(n) and db.n_rows == n
    back = KT.to_host(db)
    assert back.to_arrow().equals(batch.to_arrow())
    decoded = KT.decode_encoded_batch(KT.encode_host_batch(batch))
    assert decoded.to_arrow().equals(batch.to_arrow())
