"""The port's device window functions against the JAX package, on the CPU.

* Functions, on one encoding carried into both packages
  (``encoded_from_reference``, inputs made with numpy from a seed):
  ``_seg_scan``, ``_bounded_searchsorted_dev`` (NaN in values and queries,
  both sides) and ``window_device`` against ``kernels_jax`` — ints bit for
  bit, f64 equal (the float inputs are multiples of 1/4, so every prefix sum
  is exact in any order of addition).
* The sparse table's level, computed by integer means, against
  ``floor(log2)`` for every length from 1 to 2^24.
* Engine: every device-window SQL of ``tests/test_window.py`` through
  ``BallistaContext.standalone(device="cpu")`` against the JAX engine: rows
  equal (ints exactly, floats within rtol 1e-9, as that file holds them),
  the same operator kinds on host kernels, and no host fallback.
"""
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.ops import batch as JB
from ballista_tpu.ops import kernels_jax as KJ
from ballista_tpu.plan import expr as JX
from ballista_tpu.plan import physical as JP
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.plan import expr as TX
from ballista_tpu_torch.plan import physical as TP

from test_torch_joins import _host_ops
from test_torch_kernels import _carry


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, f"{what}: {got.dtype} != {want.dtype}"
    if got.dtype.kind == "f":
        assert np.array_equal(got, want, equal_nan=True), what
    else:
        assert np.array_equal(got, want), what


# ---- _seg_scan ----------------------------------------------------------------------------
def _segments(n, rng):
    """Each row's segment start, for segments of about 20 rows."""
    starts = rng.random(n) < 0.05
    starts[0] = True
    return np.maximum.accumulate(np.where(starts, np.arange(n), 0))


@pytest.mark.parametrize("n", [1, 7, 1000, 4096])
@pytest.mark.parametrize("op", ["min", "max", "add"])
def test_seg_scan_matches_jax(n, op):
    rng = np.random.default_rng(n)
    seg_first = _segments(n, rng)
    ints = rng.integers(-10**15, 10**15, n).astype(np.int64)
    floats = rng.integers(-400, 400, n) / 4.0
    floats[rng.random(n) < 0.05] = np.inf
    for vals in (ints, floats):
        t_op = {"min": torch.minimum, "max": torch.maximum, "add": torch.add}[op]
        j_op = {"min": jnp.minimum, "max": jnp.maximum, "add": jnp.add}[op]
        got = KT._seg_scan(torch.from_numpy(vals), torch.from_numpy(seg_first), t_op)
        want = jax.jit(KJ._seg_scan, static_argnums=2)(
            jnp.asarray(vals), jnp.asarray(seg_first.astype(np.int32)), j_op)
        _same(got, want, f"{op} {vals.dtype}")


# ---- _bounded_searchsorted_dev -----------------------------------------------------------------
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("kind", ["float", "int"])
def test_bounded_searchsorted_matches_jax(side, kind):
    """Each row searches its own segment's ascending values; float segments
    end in NaNs (as the sort leaves them) and NaN queries must insert where
    np.searchsorted's total order puts them."""
    rng = np.random.default_rng(11 if kind == "float" else 12)
    n = 3000
    seg_first = _segments(n, rng)
    seg_end = np.empty(n, np.int64)
    for s in np.unique(seg_first):
        seg_end[seg_first == s] = np.nonzero(seg_first == s)[0][-1] + 1
    if kind == "float":
        vals = rng.integers(0, 30, n) / 4.0
        vals[rng.random(n) < 0.1] = np.nan
        queries = rng.integers(-4, 34, n) / 4.0
        queries[rng.random(n) < 0.1] = np.nan
    else:
        vals = rng.integers(-50, 50, n).astype(np.int64)
        queries = rng.integers(-60, 60, n).astype(np.int64)
    for s in np.unique(seg_first):
        m = seg_first == s
        vals[m] = np.sort(vals[m])  # NaN last
    lo0 = seg_first.astype(np.int64)
    got = KT._bounded_searchsorted_dev(torch.from_numpy(vals), torch.from_numpy(queries),
                                       torch.from_numpy(lo0), torch.from_numpy(seg_end), side)
    want = KJ._bounded_searchsorted_dev(jnp.asarray(vals), jnp.asarray(queries),
                                        jnp.asarray(lo0), jnp.asarray(seg_end), side)
    _same(got, want, side)
    # and the host's searchsorted, row by row
    host = np.array([lo + np.searchsorted(vals[lo:hi], q, side=side)
                     for lo, hi, q in zip(lo0, seg_end, queries)])
    assert np.array_equal(got.numpy(), host)


# ---- the sparse table's level -----------------------------------------------------------------
def test_sparse_level_is_floor_log2_up_to_2_pow_24():
    """The level equals floor(log2(length)) exactly. The JAX package's f64
    log2 lands an ulp low at some powers of two (8, 64, 128, 4096, 8192,
    16384 and 2^24 on the CPU) and picks the level below; there the two
    blocks of half the length still tile the frame, so its min and max stay
    right. Everywhere else the two levels agree."""
    lengths = np.arange(1, (1 << 24) + 1, dtype=np.int64)
    got = KT.sparse_level(torch.from_numpy(lengths)).numpy()
    exact = np.repeat(np.arange(25), [1 << k for k in range(24)] + [1])
    assert np.array_equal(got, exact)
    jax_level = np.asarray(jnp.floor(jnp.log2(jnp.asarray(lengths).astype(jnp.float64)))
                           .astype(jnp.int64))
    differ = lengths[jax_level != got]
    assert np.all((differ & (differ - 1)) == 0), differ  # powers of two only
    assert np.array_equal(jax_level[jax_level != got], got[jax_level != got] - 1)


# ---- window_device -----------------------------------------------------------------------------
def _window_table(n=777, seed=21):
    """Partition keys: strings with NULLs, floats with NaN, 0.0 and -0.0;
    order keys: ints with NULLs and ties, floats with NULLs and NaN (no
    -0.0: the two packages order -0.0 and 0.0 differently among peers);
    values: quarter-unit floats and ints with NULLs, 2-digit decimals."""
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([0.0, -0.0, 1.5, np.nan, 2.25]), n)
    o = rng.integers(0, 30, n).astype(np.float64)
    o[rng.random(n) < 0.05] = np.nan
    return pa.table({
        "g": pa.array(rng.choice(np.array(["a", "b", "c", "d"], object), n).tolist(),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(f),
        "o": pa.array(o, mask=rng.random(n) < 0.08),
        "oi": pa.array(rng.integers(0, 25, n), mask=rng.random(n) < 0.08),
        "v": pa.array(rng.integers(-400, 400, n) / 4.0, mask=rng.random(n) < 0.1),
        "iv": pa.array(rng.integers(-9, 9, n), mask=rng.random(n) < 0.1),
        "dec": pa.array(np.round(rng.uniform(-500, 500, n), 2), mask=rng.random(n) < 0.1),
    })


# (fn, arg, partition by, order by [(column, asc)], frame or None); a frame
# is (units, (kind, offset), (kind, offset))
WINDOWS = [
    ("row_number", None, ["g"], [("oi", True), ("v", True)], None),
    ("rank", None, ["f"], [("oi", False)], None),
    ("dense_rank", None, ["g", "f"], [("o", True)], None),
    ("sum", "v", ["g"], [], None),
    ("avg", "v", ["f"], [("oi", True)], None),
    ("count", "v", ["g"], [("o", True)], None),
    ("count", None, [], [("oi", True)], None),
    ("min", "v", ["g"], [("oi", True)], None),
    ("max", "iv", ["f"], [], None),
    ("sum", "dec", ["g"], [("oi", True)], None),
    ("avg", "dec", ["g"], [], None),
    ("max", "dec", [], [("o", True)], None),
    ("sum", "v", ["g"], [("oi", True), ("v", True)],
     ("rows", ("preceding", 2.0), ("current_row", None))),
    ("avg", "v", ["g"], [("oi", True), ("v", True)],
     ("rows", ("preceding", 1.0), ("following", 3.0))),
    ("min", "v", ["f"], [("oi", True), ("iv", True)],
     ("rows", ("preceding", 5.0), ("following", 5.0))),
    ("max", "dec", ["g"], [("oi", True), ("v", True)],
     ("rows", ("following", 1.0), ("following", 4.0))),
    ("count", "v", ["g"], [("oi", True)],
     ("rows", ("current_row", None), ("unbounded_following", None))),
    ("sum", "iv", ["g"], [("oi", True)],
     ("range", ("current_row", None), ("unbounded_following", None))),
    ("sum", "v", ["g"], [("o", True)],
     ("range", ("preceding", 3.0), ("following", 2.0))),
    ("max", "iv", ["g"], [("oi", False)],
     ("range", ("preceding", 4.0), ("current_row", None))),
    ("avg", "dec", ["f"], [("dec", False)],
     ("range", ("preceding", 100.0), ("following", 50.0))),
    ("min", "dec", [], [("dec", True)],
     ("range", ("unbounded_preceding", None), ("following", 10.5))),
]


def _window_expr(X, spec, i):
    fn, arg, parts, order, frame = spec
    f = None
    if frame is not None:
        f = X.WindowFrame(frame[0], frame[1], frame[2])
    w = X.WindowFunc(fn, (X.Col(arg),) if arg else (), tuple(X.Col(p) for p in parts),
                     tuple((X.Col(c), asc) for c, asc in order), f)
    return X.Alias(w, f"w{i}")


def test_window_device_matches_jax():
    table = _window_table()
    enc_j = KJ.encode_host_batch(JB.ColumnBatch.from_arrow(table))
    _, db_t = _carry(enc_j)
    exprs_j = [_window_expr(JX, s, i) for i, s in enumerate(WINDOWS)]
    exprs_t = [_window_expr(TX, s, i) for i, s in enumerate(WINDOWS)]
    schema_j = JP.WindowExec(JP.MemoryScanExec([], enc_j.schema), exprs_j).schema()
    schema_t = TP.WindowExec(TP.MemoryScanExec([], db_t.schema), exprs_t).schema()
    got = KT.window_device(db_t, exprs_t, schema_t)
    # the JAX package's function under jit (as its engine runs it); each
    # column's static metadata is recorded while it traces
    meta = []

    @jax.jit
    def jax_windows(arrays):
        cols = KJ.window_device(KJ.device_batch_from_encoded(enc_j, arrays), exprs_j,
                                schema_j).cols
        meta[:] = [(c.dtype.value, c.scale, c.null is None) for c in cols]
        return [(c.data, c.null) for c in cols]

    want = jax_windows([jnp.asarray(a) for a in enc_j.arrays])
    base = len(table.column_names)
    for i, spec in enumerate(WINDOWS):
        ct, (data, null), (dtype, scale, no_null) = got.cols[base + i], want[base + i], \
            meta[base + i]
        what = f"w{i} {spec}"
        assert ct.dtype.value == dtype and ct.scale == scale, what
        _same(ct.data, data, what)
        assert (ct.null is None) == no_null, what
        if ct.null is not None:
            _same(ct.null, null, what)


# ---- the engine --------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def wdev_ctxs():
    """tests/test_window.py's ``wdev_ctxs`` table, in the torch engine on the
    CPU and the JAX engine."""
    rng = np.random.default_rng(5)
    n = 4000
    t = pa.table({
        "g": rng.choice(["a", "b", "c"], n),
        "o": pa.array([None if i % 13 == 0 else float(v)
                       for i, v in enumerate(rng.integers(0, 50, n))], type=pa.float64()),
        "v": pa.array([None if i % 11 == 0 else float(x)
                       for i, x in enumerate(rng.normal(size=n))], type=pa.float64()),
        "iv": rng.integers(-5, 5, n),
    })
    tctx = BallistaContext.standalone(device="cpu")
    jctx = JaxContext.standalone(backend="jax")
    for c in (tctx, jctx):
        c.register_arrow("t", t, partitions=2)
    return tctx, jctx


def _assert_like_jax(tctx, jctx, sql, rtol=1e-9):
    got = tctx.sql(sql).collect().to_pandas()
    tm = dict(tctx.last_engine_metrics)
    want = jctx.sql(sql).collect().to_pandas()
    cols = list(got.columns)
    pd.testing.assert_frame_equal(
        got.sort_values(cols).reset_index(drop=True),
        want.sort_values(cols).reset_index(drop=True),
        check_dtype=False, rtol=rtol,
    )
    assert _host_ops(tm) == _host_ops(jctx.last_engine_metrics)
    assert tm.get("op.HostFallback.count", 0.0) == 0.0
    assert tm.get("op.DeviceExecute.count", 0.0) > 0


# tests/test_window.py:172-186, :437-451 and :473-480
DEVICE_WINDOW_SQL = [
    "select g, o, row_number() over (partition by g order by o, v) as rn from t",
    "select g, o, rank() over (partition by g order by o desc) as r, "
    "dense_rank() over (partition by g order by o desc) as dr from t",
    "select g, sum(v) over (partition by g) as s, avg(v) over (partition by g) as a, "
    "count(v) over (partition by g) as c from t",
    "select g, o, sum(v) over (partition by g order by o) as rs, "
    "count(*) over (partition by g order by o) as rc from t",
    "select g, o, min(v) over (partition by g order by o) as mn, "
    "max(iv) over (partition by g order by o) as mx from t",
    "select g, sum(iv) over (partition by g) as si, min(iv) over (partition by g) as mni from t",
    "select o, row_number() over (order by o) as rn from t",
    "select g, o, sum(v) over (partition by g order by o, v "
    "rows between 2 preceding and current row) as s from t",
    "select g, o, avg(v) over (partition by g order by o, v "
    "rows between 1 preceding and 3 following) as a from t",
    "select g, o, min(v) over (partition by g order by o, v "
    "rows between 2 preceding and 2 following) as mn, "
    "max(iv) over (partition by g order by o, v "
    "rows between 2 preceding and 2 following) as mx from t",
    "select g, o, count(v) over (partition by g order by o, v "
    "rows between current row and unbounded following) as c from t",
    "select g, o, sum(iv) over (partition by g order by o, v "
    "range between unbounded preceding and unbounded following) as s from t",
    "select g, o, sum(v) over (partition by g order by o "
    "range between current row and unbounded following) as rs from t",
    "select g, o, sum(v) over (partition by g order by o "
    "range between 10 preceding and current row) as s from t",
    "select g, o, count(v) over (partition by g order by o "
    "range between 5 preceding and 5 following) as c from t",
    "select g, o, max(iv) over (partition by g order by o desc "
    "range between 7 preceding and current row) as m from t",
    "select g, o, sum(iv) over (partition by g order by o "
    "range between unbounded preceding and 3 following) as s from t",
]


@pytest.mark.parametrize("sql", DEVICE_WINDOW_SQL)
def test_device_window_sql_matches_jax_engine(wdev_ctxs, sql):
    _assert_like_jax(*wdev_ctxs, sql)


def _ctx_pair(table):
    tctx = BallistaContext.standalone(device="cpu")
    jctx = JaxContext.standalone(backend="jax")
    for c in (tctx, jctx):
        c.register_arrow("t", table)
    return tctx, jctx


@pytest.mark.parametrize("sql", [
    "select g, min(v) over (partition by g) as m from t",
    "select f, count(*) over (partition by f) as c from t",
])
def test_inf_and_nan_edges_match_jax_engine(sql):
    """tests/test_window.py:205: min over an all-inf frame is inf (not
    NULL), and NaN partition keys form one partition."""
    table = pa.table({
        "g": ["a", "a", "b"],
        "v": [np.inf, np.inf, 1.0],
        "f": pa.array([np.nan, 1.0, np.nan], type=pa.float64()),
    })
    _assert_like_jax(*_ctx_pair(table), sql, rtol=1e-12)


def test_following_start_minmax_last_partition_row():
    """tests/test_window.py:525: an empty FOLLOWING-start frame at the end of
    the last partition is NULL."""
    tctx, jctx = _ctx_pair(pa.table({"o": [1, 2, 3, 4, 5], "v": [5.0, 4.0, 3.0, 2.0, 1.0]}))
    sql = ("select o, min(v) over (order by o rows between 1 following and 2 following) as m "
           "from t order by o")
    assert tctx.sql(sql).collect().to_pydict()["m"] == [3.0, 2.0, 1.0, 1.0, None]
    _assert_like_jax(tctx, jctx, sql)


def test_range_offset_nan_key_matches_jax_engine():
    """tests/test_window.py:566: a NaN order key sorts above everything, and
    the binary search must not collapse NaN-query bounds to the segment
    start."""
    tctx, jctx = _ctx_pair(pa.table({
        "o": pa.array([1.0, 2.0, 3.0, float("nan"), 5.0, 6.0], type=pa.float64()),
        "v": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
    }))
    sql = ("select o, sum(v) over (order by o "
           "range between 1 preceding and unbounded following) as s from t")
    a = tctx.sql(sql).collect().to_pandas().sort_values("o", na_position="last")
    b = jctx.sql(sql).collect().to_pandas().sort_values("o", na_position="last")
    assert a.s.tolist() == b.s.tolist()
    assert tctx.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0


def test_string_window_aggregate_stays_on_the_host():
    """A string argument is not a device window (as on the JAX engine): the
    host kernels refuse it with the same error."""
    from ballista_tpu_torch.errors import ExecutionError

    tctx, _ = _ctx_pair(pa.table({"g": [1], "s": ["a"]}))
    with pytest.raises(ExecutionError, match="string window"):
        tctx.sql("select min(s) over (partition by g) from t").collect()


def test_range_offset_off_the_key_scale_falls_back_as_on_jax():
    """A RANGE offset finer than the decimal key's scale cannot bound an
    integer key: the stage runs on host kernels on both engines, with the
    same rows."""
    tctx, jctx = _ctx_pair(pa.table({
        "k": [1.25, 2.5, 2.75, 4.0, 4.25],
        "v": [1.0, 2.0, 3.0, 4.0, 5.0],
    }))
    sql = ("select k, sum(v) over (order by k range between 0.125 preceding "
           "and current row) as s from t")
    got = tctx.sql(sql).collect().to_pandas().sort_values("k")
    want = jctx.sql(sql).collect().to_pandas().sort_values("k")
    assert got.s.tolist() == want.s.tolist()
    host = _host_ops(tctx.last_engine_metrics)
    assert "WindowExec" in host and host == _host_ops(jctx.last_engine_metrics)
