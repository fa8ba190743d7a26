"""Host (numpy) columnar kernels: grouping, joins, sort, hash partitioning.

This is the CPU execution backend (reference analog: DataFusion's operators,
the layer the survey says the TPU build replaces with XLA) and the semantics
model for the device kernels in ``kernels_torch.py``. Keep the two behaviourally
identical — the oracle engine runs on this backend without a device.

Join algorithm: sort the build side, ``searchsorted`` the probe side, expand
match ranges — O(n log n), handles many-to-many, and mirrors the TPU join
(which uses the same searchsorted shape on device).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops.batch import Column, ColumnBatch
from ballista_tpu_torch.ops.eval_np import evaluate, to_filter_mask
from ballista_tpu_torch.plan.expr import Agg, Expr, unalias
from ballista_tpu_torch.plan.schema import DataType, Field, Schema

# ---- key canonicalization ---------------------------------------------------------

_SPLITMIX_C1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer; identical constants in the JAX kernel so both
    engines produce the same shuffle bucketing."""
    x = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        x += _GOLDEN
        x ^= x >> np.uint64(30)
        x *= _SPLITMIX_C1
        x ^= x >> np.uint64(27)
        x *= _SPLITMIX_C2
        x ^= x >> np.uint64(31)
    return x


def canonical_int64(col: Column) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Map a column to (int64 values, valid) such that SQL-equal values map to
    equal ints across batches/engines."""
    if col.dtype is DataType.STRING:
        import pandas as pd

        arr = col.data
        valid = None
        if arr.null_count:
            valid = np.asarray(arr.is_valid())
        vals = pd.util.hash_array(np.asarray(arr.fill_null("")).astype(object)).astype(np.int64)
        return vals, valid
    data = np.asarray(col.data)
    if data.dtype.kind == "f":
        # bit view; normalize -0.0 so it groups with 0.0
        data = np.where(data == 0.0, 0.0, data)
        return data.astype(np.float64).view(np.int64), col.valid
    return data.astype(np.int64), col.valid


def combined_key(cols: Sequence[Column]) -> tuple[np.ndarray, np.ndarray]:
    """Mix N key columns into one int64 hash key + a "key is non-null" mask."""
    n = len(cols[0])
    mixed = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for c in cols:
        v, va = canonical_int64(c)
        mixed = splitmix64(mixed ^ v.view(np.uint64))
        if va is not None:
            valid &= va
    return mixed.view(np.int64), valid


def factorize(vals: np.ndarray) -> tuple[np.ndarray, int, np.ndarray]:
    """(codes in [0,k), k, first-occurrence row index per code)."""
    uniq, first, inv = np.unique(vals, return_index=True, return_inverse=True)
    return inv.astype(np.int64), len(uniq), first


def _col_codes(c: Column) -> tuple[np.ndarray, int]:
    """Per-column dense codes; NULL forms its own code (one NULL group, SQL
    GROUP BY semantics)."""
    v, valid = canonical_int64(c)
    if c.dtype is DataType.STRING and c.data.null_count:
        valid = np.asarray(c.data.is_valid())
    codes, k, _ = factorize(v)
    if valid is not None and not valid.all():
        codes = np.where(valid, codes, k)
        k += 1
    return codes.astype(np.int64), k


def group_codes(cols: Sequence[Column]) -> tuple[np.ndarray, int, np.ndarray]:
    """Dense group ids over N key columns (pairwise factorize, overflow-safe)."""
    if not cols:
        n = 0
        return np.zeros(n, np.int64), 1, np.zeros(1, np.int64)
    codes, k = _col_codes(cols[0])
    codes, k, first = factorize(codes)
    for c in cols[1:]:
        cc, kc = _col_codes(c)
        codes, k, first = factorize(codes * np.int64(kc) + cc)
    return codes, k, first


# ---- exact decimals ----------------------------------------------------------------
MAX_DECIMAL_SCALE = 8   # sniffed column scale bound (literal scale may be higher)


def sniff_decimal(
    vals: np.ndarray, valid: Optional[np.ndarray]
) -> Optional[tuple[int, np.ndarray, tuple[int, int]]]:
    """Detect an exact-decimal FLOAT64 column: returns (scale, scaled int64
    array with invalid slots zeroed, exact (lo, hi) scaled range) when every
    valid value round-trips ``round(v*10^s)/10^s == v`` within int64-exact
    magnitude, else None. The division recovery is exact: IEEE division of
    the two exactly-representable integers is correctly rounded, so it
    reproduces the f64 the decimal parser produced."""
    v = vals if valid is None else vals[valid]
    if v.size == 0:
        return (0, np.zeros(len(vals), np.int64), (0, 0))
    if not np.all(np.isfinite(v)):
        return None

    def fits(w: np.ndarray, s: int) -> bool:
        m = 10.0**s
        sw = np.round(w * m)
        return bool(np.all(np.abs(sw) < float(1 << 53)) and np.array_equal(sw / m, w))

    # minimal-scale search, screened on a sample first: a sample failing
    # scale s proves the column fails s
    sample = v[:1024]
    for s0 in range(0, MAX_DECIMAL_SCALE + 1):
        if fits(sample, s0):
            break
    else:
        return None
    for s in range(s0, MAX_DECIMAL_SCALE + 1):
        if fits(v, s):
            iv = np.round(v * 10.0**s).astype(np.int64)
            lo, hi = int(iv.min()), int(iv.max())
            if valid is None:
                full = iv
            else:
                full = np.zeros(len(vals), np.int64)
                full[valid] = iv
            return (s, full, (lo, hi))
    return None


def lit_decimal_scale(value: float, max_scale: int = 12) -> Optional[int]:
    """Minimal scale s <= max_scale such that round(value*10^s)/10^s == value
    (exact in python floats), or None."""
    if value != value or value in (float("inf"), float("-inf")):
        return None
    for s in range(0, max_scale + 1):
        scaled = round(value * 10**s)
        if abs(scaled) < (1 << 53) and scaled / 10**s == value:
            return s
    return None


def exact_decimal(vals: np.ndarray, valid: Optional[np.ndarray]):
    """(scale, scaled int64 values, invalid slots zeroed) of an f64 column of
    exact short decimals (``sniff_decimal``) whose int64 prefix sums cannot
    wrap, else None: the host windows then sum it exactly, as the device
    does, instead of differencing f64 prefix sums."""
    if vals.dtype != np.float64:
        return None
    d = sniff_decimal(vals, valid)
    if d is None:
        return None
    scale, iv, (lo, hi) = d
    if len(iv) * max(abs(lo), abs(hi), 1) >= 1 << 62:
        return None
    return scale, iv


# ---- hash partitioning ------------------------------------------------------------
def hash_partition_indices(batch: ColumnBatch, exprs: Sequence[Expr], n: int) -> np.ndarray:
    """Bucket id per row for a hash exchange (reference: BatchPartitioner,
    shuffle_writer.rs:233-329), by the host C++ kernel (``native/``):
    splitmix64 semantics, bit-identical to the JAX package's bucketing and
    to ``hash_partition_indices_plain``."""
    from ballista_tpu_torch import native

    canon = [canonical_int64(evaluate(e, batch))[0] for e in exprs]
    return native.hash_buckets_native(canon, n).astype(np.int64)


def hash_partition(batch: ColumnBatch, exprs: Sequence[Expr], n: int) -> list[ColumnBatch]:
    """``batch`` split into ``n`` pieces by bucket, rows in their order, by
    the host C++ kernel's counting sort."""
    if batch.num_rows == 0:
        return [batch] * n
    from ballista_tpu_torch import native

    order, bounds = native.partition_order_native(hash_partition_indices(batch, exprs, n), n)
    return [batch.take(order[bounds[i] : bounds[i + 1]]) for i in range(n)]


def hash_partition_indices_plain(batch: ColumnBatch, exprs: Sequence[Expr],
                                 n: int) -> np.ndarray:
    """numpy version of ``hash_partition_indices`` (the tests' reference)."""
    cols = [evaluate(e, batch) for e in exprs]
    key, _ = combined_key(cols)
    return (key.view(np.uint64) % np.uint64(n)).astype(np.int64)


def hash_partition_plain(batch: ColumnBatch, exprs: Sequence[Expr],
                         n: int) -> list[ColumnBatch]:
    """numpy version of ``hash_partition`` (the tests' reference)."""
    if batch.num_rows == 0:
        return [batch] * n
    buckets = hash_partition_indices_plain(batch, exprs, n)
    order = np.argsort(buckets, kind="stable")
    sorted_b = buckets[order]
    bounds = np.searchsorted(sorted_b, np.arange(n + 1))
    out = []
    for i in range(n):
        idx = order[bounds[i] : bounds[i + 1]]
        out.append(batch.take(idx))
    return out


# ---- aggregation ------------------------------------------------------------------
def _segment_sum(vals: np.ndarray, ids: np.ndarray, k: int, valid) -> np.ndarray:
    if valid is not None:
        vals = np.where(valid, vals, 0)
    if vals.dtype.kind == "f":
        return np.bincount(ids, weights=vals, minlength=k)
    out = np.zeros(k, dtype=np.int64)
    np.add.at(out, ids, vals.astype(np.int64))
    return out


def _segment_count(ids: np.ndarray, k: int, valid) -> np.ndarray:
    if valid is None:
        return np.bincount(ids, minlength=k).astype(np.int64)
    return np.bincount(ids[valid], minlength=k).astype(np.int64)


def _segment_minmax(vals, ids, k, valid, is_min: bool):
    if valid is not None:
        ids = ids[valid]
        vals = vals[valid]
    if vals.dtype.kind == "f":
        init = np.inf if is_min else -np.inf
        out = np.full(k, init, dtype=np.float64)
    else:
        info = np.iinfo(np.int64)
        out = np.full(k, info.max if is_min else info.min, dtype=np.int64)
        vals = vals.astype(np.int64)
    (np.minimum if is_min else np.maximum).at(out, ids, vals)
    seen = np.zeros(k, dtype=bool)
    seen[ids] = True
    return out, seen


def _segment_minmax_string(col: Column, ids, k, is_min: bool):
    arr = np.asarray(col.data).astype(object)
    order = np.lexsort((np.arange(len(ids)), ids))
    # stable sort by group; then reduce per segment on sorted values
    out = np.empty(k, dtype=object)
    seen = np.zeros(k, dtype=bool)
    sid = ids[order]
    sval = arr[order]
    for i in range(len(sid)):  # small: only used post-aggregation in TPC-H
        g = sid[i]
        v = sval[i]
        if v is None:
            continue  # null state (all-null group upstream): never a candidate
        if not seen[g]:
            out[g] = v
            seen[g] = True
        elif (v < out[g]) == is_min:
            out[g] = v
    return out, seen  # unseen groups stay None => arrow null


def aggregate_groups(
    batch: ColumnBatch,
    group_exprs: Sequence[Expr],
    agg_exprs: Sequence[Expr],
    mode: str,
    out_schema: Schema,
) -> ColumnBatch:
    """Execute a hash aggregate in single|partial|final|merge mode over one batch."""
    if mode == "merge":
        return merge_partial_states(batch, group_exprs, agg_exprs)
    n = batch.num_rows
    group_cols = [evaluate(g, batch) for g in group_exprs]
    if group_cols:
        ids, k, first = group_codes(group_cols)
    else:
        ids, k, first = np.zeros(n, np.int64), 1, np.zeros(1, np.int64)

    out_cols: list[Column] = []
    # group key representative values
    for g, c in zip(group_exprs, group_cols):
        if n == 0:
            out_cols.append(
                Column(c.dtype, pa.array([], pa.string()))
                if c.dtype is DataType.STRING
                else Column(c.dtype, np.empty(0, c.dtype.to_numpy()))
            )
        else:
            out_cols.append(c.take(first))

    empty = n == 0 and bool(group_exprs)
    kk = 0 if empty else k

    for e in agg_exprs:
        a = unalias(e)
        assert isinstance(a, Agg)
        name = e.name()
        if mode == "final":
            out_cols.extend(_agg_final(batch, a, name, ids, kk))
        elif mode == "partial":
            out_cols.extend(_agg_partial(batch, a, name, ids, kk))
        else:
            out_cols.extend(_agg_single(batch, a, name, ids, kk))

    cols = []
    for f, c in zip(out_schema, out_cols):
        if f.dtype is DataType.STRING or c.dtype is f.dtype:
            cols.append(c)
        else:
            cols.append(Column(f.dtype, np.asarray(c.data).astype(f.dtype.to_numpy()), c.valid))
    return ColumnBatch(out_schema, cols)


def _agg_input(batch, a: Agg):
    if a.expr is None:
        return None, None
    c = evaluate(a.expr, batch)
    if c.dtype is DataType.STRING:
        return c, "string"
    return c, None


def _agg_single(batch, a: Agg, name, ids, k) -> list[Column]:
    c, kind = _agg_input(batch, a)
    if a.fn in ("count", "count_star"):
        if a.fn == "count_star" or c is None:
            return [Column(DataType.INT64, _segment_count(ids, k, None))]
        valid = _string_valid(c) if kind == "string" else c.valid
        return [Column(DataType.INT64, _segment_count(ids, k, valid))]
    if kind == "string":
        if a.fn in ("min", "max"):
            out, seen = _segment_minmax_string(c, ids, k, a.fn == "min")
            # min/max of a shared-dict column stays inside the dictionary
            return [Column(DataType.STRING, pa.array(out.tolist(), pa.string()),
                           dict_id=c.dict_id)]
        raise ExecutionError(f"agg {a.fn} over strings unsupported")
    vals = np.asarray(c.data)
    if a.fn == "sum":
        s = _segment_sum(vals, ids, k, c.valid)
        cnt = _segment_count(ids, k, c.valid)
        return [Column(DataType.FLOAT64 if vals.dtype.kind == "f" else DataType.INT64, s, cnt > 0)]
    if a.fn == "avg":
        s = _segment_sum(vals.astype(np.float64), ids, k, c.valid)
        cnt = _segment_count(ids, k, c.valid)
        with np.errstate(invalid="ignore", divide="ignore"):
            return [Column(DataType.FLOAT64, s / np.maximum(cnt, 1), cnt > 0)]
    if a.fn in ("min", "max"):
        out, seen = _segment_minmax(vals, ids, k, c.valid, a.fn == "min")
        dt = DataType.FLOAT64 if out.dtype.kind == "f" else DataType.INT64
        return [Column(dt, out, seen)]
    raise ExecutionError(f"unknown aggregate {a.fn}")


def _agg_partial(batch, a: Agg, name, ids, k) -> list[Column]:
    c, kind = _agg_input(batch, a)
    if a.fn in ("count", "count_star"):
        valid = None
        if a.fn == "count" and c is not None:
            valid = _string_valid(c) if kind == "string" else c.valid
        return [Column(DataType.INT64, _segment_count(ids, k, valid))]
    if a.fn == "avg":
        vals = np.asarray(c.data, dtype=np.float64)
        return [
            Column(DataType.FLOAT64, _segment_sum(vals, ids, k, c.valid)),
            Column(DataType.INT64, _segment_count(ids, k, c.valid)),
        ]
    return _agg_single(batch, a, name, ids, k)


def _agg_final(batch, a: Agg, name, ids, k) -> list[Column]:
    """Merge partial states: state columns are located by name convention."""
    if a.fn in ("count", "count_star"):
        st = batch.column(f"{name}#count")
        return [Column(DataType.INT64, _segment_sum(np.asarray(st.data), ids, k, st.valid))]
    if a.fn == "avg":
        s = batch.column(f"{name}#sum")
        cn = batch.column(f"{name}#count")
        ssum = _segment_sum(np.asarray(s.data), ids, k, s.valid)
        scnt = _segment_sum(np.asarray(cn.data), ids, k, cn.valid)
        with np.errstate(invalid="ignore", divide="ignore"):
            return [Column(DataType.FLOAT64, ssum / np.maximum(scnt, 1), scnt > 0)]
    st = batch.column(f"{name}#{a.fn}")
    if a.fn == "sum":
        vals = np.asarray(st.data)
        s = _segment_sum(vals, ids, k, st.valid)
        cnt = _segment_count(ids, k, st.valid)
        dt = DataType.FLOAT64 if vals.dtype.kind == "f" else DataType.INT64
        return [Column(dt, s, cnt > 0)]
    if a.fn in ("min", "max"):
        if st.dtype is DataType.STRING:
            out, seen = _segment_minmax_string(st, ids, k, a.fn == "min")
            return [Column(DataType.STRING, pa.array(out.tolist(), pa.string()),
                           dict_id=st.dict_id)]
        out, seen = _segment_minmax(np.asarray(st.data), ids, k, st.valid, a.fn == "min")
        dt = DataType.FLOAT64 if out.dtype.kind == "f" else DataType.INT64
        return [Column(dt, out, seen)]
    raise ExecutionError(f"unknown aggregate {a.fn}")


def _string_valid(c: Column):
    if c.data.null_count:
        return np.asarray(c.data.is_valid())
    return None


def merge_partial_states(
    batch: ColumnBatch,
    group_exprs: Sequence[Expr],
    agg_exprs: Sequence[Expr],
) -> ColumnBatch:
    """Combine rows of a PARTIAL-layout aggregate batch that share a group
    key, producing a smaller batch in the same partial layout. Associative —
    the streaming final aggregate folds input chunks through this, keeping
    resident state bounded by the number of distinct groups, and runs the
    real ``final`` step once at the end. (Reference: DataFusion's
    ``merge_batch`` on accumulator states, which Ballista's final
    ``HashAggregateExec`` stage invokes batch-by-batch over the shuffle
    stream rather than on one concatenated partition.)"""
    n = batch.num_rows
    group_cols = [evaluate(g, batch) for g in group_exprs]
    if group_cols:
        ids, k, first = group_codes(group_cols)
    else:
        ids, k, first = np.zeros(n, np.int64), 1, np.zeros(1, np.int64)

    out_cols: list[Column] = []
    for c in group_cols:
        out_cols.append(c.take(first))

    def seg_sum(col: Column, dtype: DataType) -> Column:
        vals = np.asarray(col.data)
        s = _segment_sum(vals, ids, k, col.valid)
        cnt = _segment_count(ids, k, col.valid)
        return Column(dtype, s.astype(dtype.to_numpy(), copy=False), cnt > 0)

    for e in agg_exprs:
        a = unalias(e)
        assert isinstance(a, Agg)
        name = e.name()
        if a.fn in ("count", "count_star"):
            st = batch.column(f"{name}#count")
            out_cols.append(seg_sum(st, DataType.INT64))
        elif a.fn == "avg":
            out_cols.append(seg_sum(batch.column(f"{name}#sum"), DataType.FLOAT64))
            out_cols.append(seg_sum(batch.column(f"{name}#count"), DataType.INT64))
        elif a.fn == "sum":
            st = batch.column(f"{name}#sum")
            out_cols.append(seg_sum(st, st.dtype))
        elif a.fn in ("min", "max"):
            st = batch.column(f"{name}#{a.fn}")
            if st.dtype is DataType.STRING:
                out, _ = _segment_minmax_string(st, ids, k, a.fn == "min")
                out_cols.append(Column(DataType.STRING, pa.array(out.tolist(), pa.string()),
                                       dict_id=st.dict_id))
            else:
                out, seen = _segment_minmax(
                    np.asarray(st.data), ids, k, st.valid, a.fn == "min"
                )
                out_cols.append(Column(st.dtype, out.astype(st.dtype.to_numpy(), copy=False), seen))
        else:
            raise ExecutionError(f"unknown aggregate {a.fn}")
    return ColumnBatch(batch.schema, out_cols)


# ---- joins ------------------------------------------------------------------------
@dataclass
class PreparedBuild:
    """Build-side join index computed once and probed per chunk: valid build
    row indices sorted by key, plus the sorted keys. The streaming probe-side
    join prepares this once instead of re-sorting the build side per chunk."""

    r_idx: np.ndarray  # valid right-row indices, sorted by key
    rs: np.ndarray     # keys at r_idx (sorted)


def prepare_build(right: ColumnBatch, on: list) -> PreparedBuild:
    rk, rvalid = combined_key([evaluate(r, right) for _, r in on]) if on else (
        np.zeros(right.num_rows, np.int64), np.ones(right.num_rows, bool))
    r_idx = np.arange(len(rk))
    if rvalid is not None:
        r_idx = r_idx[rvalid]
    rs_order = np.argsort(rk[r_idx], kind="stable")
    r_idx = r_idx[rs_order]
    return PreparedBuild(r_idx, rk[r_idx])


def _match_pairs_prepared(lk: np.ndarray, lvalid, pb: PreparedBuild):
    l_idx = np.arange(len(lk))
    if lvalid is not None:
        l_idx = l_idx[lvalid]
    lo = np.searchsorted(pb.rs, lk[l_idx], "left")
    hi = np.searchsorted(pb.rs, lk[l_idx], "right")
    counts = hi - lo
    li = np.repeat(l_idx, counts)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    starts = np.repeat(lo, counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    ri = pb.r_idx[starts + offs]
    return li.astype(np.int64), ri.astype(np.int64)


def hash_join(
    left: ColumnBatch,
    right: ColumnBatch,
    on: list[tuple[Expr, Expr]],
    how: str,
    filter_expr: Optional[Expr],
    out_schema: Schema,
    prepared: Optional[PreparedBuild] = None,
) -> ColumnBatch:
    lk, lvalid_np = combined_key([evaluate(l, left) for l, _ in on]) if on else (
        np.zeros(left.num_rows, np.int64), np.ones(left.num_rows, bool))
    if prepared is None:
        prepared = prepare_build(right, on)
    li, ri = _match_pairs_prepared(lk, lvalid_np, prepared)

    if filter_expr is not None and len(li):
        pair_batch = _combine(left.take(li), right.take(ri))
        keep = to_filter_mask(evaluate(filter_expr, pair_batch))
        li, ri = li[keep], ri[keep]

    if how == "semi":
        mask = np.zeros(left.num_rows, bool)
        mask[li] = True
        return ColumnBatch(out_schema, left.filter(mask).columns)
    if how == "anti":
        mask = np.ones(left.num_rows, bool)
        mask[li] = False
        return ColumnBatch(out_schema, left.filter(mask).columns)

    if how == "inner":
        lcols = left.take(li).columns
        rcols = right.take(ri).columns
        return ColumnBatch(out_schema, lcols + rcols)

    if how in ("left", "full"):
        matched_l = np.zeros(left.num_rows, bool)
        matched_l[li] = True
        extra_l = np.nonzero(~matched_l)[0]
        li2 = np.concatenate([li, extra_l])
        ri2 = np.concatenate([ri, np.full(len(extra_l), -1)])
        rnull = ri2 < 0
        lcols = left.take(li2).columns
        rcols = _take_nullable(right, ri2, rnull)
        if how == "full":
            matched_r = np.zeros(right.num_rows, bool)
            matched_r[ri] = True
            extra_r = np.nonzero(~matched_r)[0]
            li3 = np.full(len(extra_r), -1)
            lcols2 = _take_nullable(left, li3, li3 < 0)
            rcols2 = right.take(extra_r).columns
            lcols = [Column.concat([a, b]) for a, b in zip(lcols, lcols2)]
            rcols = [Column.concat([a, b]) for a, b in zip(rcols, rcols2)]
        return ColumnBatch(out_schema, lcols + rcols)

    if how == "right":
        flipped = hash_join(
            right, left, [(r, l) for l, r in on], "left", filter_expr,
            right.schema.join(left.schema),
        )
        ncols_r = len(right.schema)
        cols = flipped.columns[ncols_r:] + flipped.columns[:ncols_r]
        return ColumnBatch(out_schema, cols)

    raise ExecutionError(f"join kind {how} unsupported")


def _take_nullable(batch: ColumnBatch, idx: np.ndarray, isnull: np.ndarray) -> list[Column]:
    safe = np.where(isnull, 0, idx)
    out = []
    for c in batch.columns:
        if c.dtype is DataType.STRING:
            if batch.num_rows == 0:
                out.append(Column(DataType.STRING, pa.array([None] * len(idx), pa.string()),
                                  dict_id=c.dict_id))
            else:
                # take with a null index yields a null value
                out.append(Column(DataType.STRING, c.data.take(pa.array(safe, mask=isnull)),
                                  dict_id=c.dict_id))
        else:
            if batch.num_rows == 0:
                data = np.zeros(len(idx), c.dtype.to_numpy())
            else:
                data = np.asarray(c.data)[safe]
            valid = ~isnull
            if c.valid is not None and batch.num_rows:
                valid = valid & c.valid[safe]
            out.append(Column(c.dtype, data, valid))
    return out


def _combine(l: ColumnBatch, r: ColumnBatch) -> ColumnBatch:
    return ColumnBatch(l.schema.join(r.schema), l.columns + r.columns)


def cross_join(left: ColumnBatch, right: ColumnBatch, out_schema: Schema) -> ColumnBatch:
    nl, nr = left.num_rows, right.num_rows
    li = np.repeat(np.arange(nl), nr)
    ri = np.tile(np.arange(nr), nl)
    return ColumnBatch(out_schema, left.take(li).columns + right.take(ri).columns)


# ---- window functions -------------------------------------------------------------
def window_eval(batch: ColumnBatch, window_exprs: Sequence[Expr], out_schema: Schema) -> ColumnBatch:
    """Append one column per window expression (original row order preserved).

    Semantics: SQL default frame — with ORDER BY, aggregates are running with
    peers (equal order keys) sharing the value of their last peer; without
    ORDER BY they aggregate the whole partition.
    """
    from ballista_tpu_torch.plan.expr import WindowFunc, unalias

    n = batch.num_rows
    new_cols = list(batch.columns)
    for e in window_exprs:
        w = unalias(e)
        assert isinstance(w, WindowFunc)
        new_cols.append(_one_window(batch, w, n))
    return ColumnBatch(out_schema, new_cols, num_rows=n)


def _one_window(batch: ColumnBatch, w, n: int) -> Column:
    from ballista_tpu_torch.plan.schema import DataType as DT

    if n == 0:
        dt = w.data_type(batch.schema)
        return Column(dt, np.empty(0, dt.to_numpy()))

    part_cols = [evaluate(p, batch) for p in w.partition_by]
    if part_cols:
        gid, _, _ = group_codes(part_cols)
    else:
        gid = np.zeros(n, np.int64)

    # sort rows by (partition, order keys) with the SAME null-aware key
    # encoding as top-level ORDER BY; results scatter back to original
    # positions. The raw comparable values are reused for peer detection.
    lex_keys: list[np.ndarray] = [gid]
    peer_vals: list[tuple[np.ndarray, Optional[np.ndarray]]] = []
    for expr, asc in w.order_by:
        ks, raw, valid = _sort_key_arrays(evaluate(expr, batch), asc)
        lex_keys.extend(ks)
        peer_vals.append((raw, valid))
    order = np.lexsort(tuple(reversed(lex_keys)))
    sgid = gid[order]
    seg_start = np.concatenate([[True], sgid[1:] != sgid[:-1]])

    # peer groups: a new peer group wherever any order key (or its nullness)
    # changes within a segment
    peer_start = seg_start.copy()
    for raw, valid in peer_vals:
        sv = raw[order]
        peer_start |= np.concatenate([[True], sv[1:] != sv[:-1]])
        if valid is not None:
            nv = valid[order]
            peer_start |= np.concatenate([[True], nv[1:] != nv[:-1]])

    seg_id = np.cumsum(seg_start) - 1
    pos_in_seg = np.arange(n) - np.maximum.accumulate(np.where(seg_start, np.arange(n), 0))

    if w.fn == "row_number":
        out_sorted = (pos_in_seg + 1).astype(np.int64)
        return _scatter(order, out_sorted, DT.INT64, n)
    if w.fn == "rank":
        # rank = position of the first row of the current peer group + 1
        first_of_peer = np.maximum.accumulate(np.where(peer_start, np.arange(n), 0))
        seg_first = np.maximum.accumulate(np.where(seg_start, np.arange(n), 0))
        out_sorted = (first_of_peer - seg_first + 1).astype(np.int64)
        return _scatter(order, out_sorted, DT.INT64, n)
    if w.fn == "dense_rank":
        peers_so_far = np.cumsum(peer_start)
        seg_first = np.maximum.accumulate(np.where(seg_start, np.arange(n), 0))
        out_sorted = (peers_so_far - peers_so_far[seg_first] + 1).astype(np.int64)
        return _scatter(order, out_sorted, DT.INT64, n)

    # aggregate window functions
    is_int = False
    # a SUM or AVG over exact decimals: (scale, sorted scaled int64 values),
    # summed exactly in int64 prefix sums as the device does; an f64 prefix
    # difference would lose the last digit
    dec = None
    if w.args:
        c = evaluate(w.args[0], batch)
        if c.dtype is DT.STRING:
            raise ExecutionError("string window aggregates unsupported")
        is_int = c.dtype.is_integer and w.fn in ("sum", "min", "max")
        vals = np.asarray(c.data, dtype=np.int64 if is_int else np.float64)
        valid = np.ones(n, bool) if c.valid is None else c.valid.copy()
        if w.fn in ("sum", "avg") and not is_int and w.order_by:
            dec = exact_decimal(vals, c.valid)
            if dec is not None:
                dec = (dec[0], dec[1][order])
        vals = vals[order]
        valid = valid[order]
    else:  # count(*)
        vals = np.ones(n, np.float64)
        valid = np.ones(n, bool)

    k = int(seg_id[-1]) + 1 if n else 0
    if w.frame is not None:
        full, empty = _frame_aggregate(
            w, n, vals, valid, order, seg_start, peer_start, peer_vals, is_int, dec
        )
        return _agg_result(order, full, empty, w, n, is_int)
    if not w.order_by:
        # whole-partition aggregate broadcast to every row
        if w.fn in ("sum", "avg", "count"):
            if is_int and w.fn == "sum":
                s = np.zeros(k, np.int64)
                np.add.at(s, seg_id[valid], vals[valid])
            else:
                s = np.bincount(seg_id, weights=np.where(valid, vals, 0), minlength=k)
            cnt = np.bincount(seg_id[valid], minlength=k)
            full = {"sum": s, "count": cnt,
                    "avg": s / np.maximum(cnt, 1)}[w.fn][seg_id]
            empty = cnt[seg_id] == 0
        else:  # min / max
            outv, seen = _segment_minmax(vals, seg_id, k, valid, w.fn == "min")
            full = outv[seg_id]
            empty = ~seen[seg_id]
        return _agg_result(order, full, empty, w, n, is_int)

    # running (RANGE ... CURRENT ROW): prefix through the END of the peer group
    peer_gid = np.cumsum(peer_start) - 1
    next_start = np.append(np.nonzero(peer_start)[0][1:], n)
    peer_last_idx = (next_start - 1)[peer_gid]  # last row index of each row's peer group

    vz = dec[1] if dec is not None else np.where(valid, vals, vals.dtype.type(0))
    csum = np.cumsum(vz)  # int64-exact for integer and decimal inputs
    seg_first = np.maximum.accumulate(np.where(seg_start, np.arange(n), 0))
    base_sum = np.where(seg_first > 0, csum[seg_first - 1], vz.dtype.type(0))
    ccnt = np.cumsum(valid.astype(np.int64))
    base_cnt = np.where(seg_first > 0, ccnt[seg_first - 1], 0)

    if w.fn in ("sum", "avg", "count"):
        run_sum = csum[peer_last_idx] - base_sum
        run_cnt = ccnt[peer_last_idx] - base_cnt
        return _agg_result(order, _sum_or_avg(w.fn, run_sum, run_cnt, dec), run_cnt == 0,
                           w, n, is_int)
    if w.fn in ("min", "max"):
        # segmented running min/max: per-segment accumulate (python loop over
        # segments; window partitions are typically modest in count)
        if is_int:
            info = np.iinfo(np.int64)
            sentinel = info.max if w.fn == "min" else info.min
        else:
            sentinel = np.inf if w.fn == "min" else -np.inf
        vv = np.where(valid, vals, vals.dtype.type(sentinel))
        out = np.empty(n, vals.dtype)
        seg_bounds = np.append(np.nonzero(seg_start)[0], n)
        accum = np.minimum.accumulate if w.fn == "min" else np.maximum.accumulate
        for i in range(len(seg_bounds) - 1):
            lo, hi = seg_bounds[i], seg_bounds[i + 1]
            out[lo:hi] = accum(vv[lo:hi])
        out = out[peer_last_idx]  # peers share
        empty = out == sentinel  # no valid value seen yet in the frame
        return _agg_result(order, out, empty, w, n, is_int)
    raise ExecutionError(f"window function {w.fn} unsupported")


def _sum_or_avg(fn: str, fsum: np.ndarray, fcnt: np.ndarray, dec) -> np.ndarray:
    """A window's SUM, COUNT or AVG from its frame sums and counts. Over
    exact decimals (``dec``: the scale) the sums are scaled int64, descaled
    once here: the sum as the device's fetch does, the average as the one
    correctly rounded quotient of two exact integers."""
    if fn == "count":
        return fcnt
    if dec is None:
        return fsum if fn == "sum" else fsum / np.maximum(fcnt, 1)
    unit = 10.0 ** dec[0]
    if fn == "sum":
        return fsum.astype(np.float64) / unit
    return fsum.astype(np.float64) / (np.maximum(fcnt, 1) * unit)


def _decimal_range_keys(raw, kvalid, frame) -> Optional[tuple]:
    """(int64 keys, {offset: int64 offset}) of a RANGE frame's order key at
    one scale when the key is an exact decimal and every offset is exact at
    a scale the int64 search can hold, else None (the f64 search)."""
    if np.asarray(raw).dtype != np.float64:
        return None
    from ballista_tpu_torch.plan.expr import FOLLOWING, PRECEDING

    kd = sniff_decimal(np.asarray(raw), None if kvalid is None else np.asarray(kvalid))
    if kd is None:
        return None
    offs = [float(o) for kind, o in (frame.start, frame.end) if kind in (PRECEDING, FOLLOWING)]
    scales = [lit_decimal_scale(o) for o in offs]
    if any(sc is None for sc in scales):
        return None
    scale = max([kd[0]] + scales)
    mul = 10 ** (scale - kd[0])
    top = max(abs(kd[2][0]), abs(kd[2][1])) * mul + max(
        (abs(round(o * 10**scale)) for o in offs), default=0)
    if top >= 1 << 62:
        return None
    return kd[1] * np.int64(mul), {o: int(round(o * 10**scale)) for o in offs}


def _frame_aggregate(w, n, vals, valid, order, seg_start, peer_start, peer_vals, is_int,
                     dec=None):
    """Aggregate over an explicit ROWS/RANGE frame. All arrays are in sorted
    (partition, order-key) coordinates; returns (full, empty) in the same
    coordinates for _agg_result to scatter back.

    ROWS bounds are row-offset arithmetic clipped to the segment; RANGE
    offsets binary-search the (single, numeric) order key within each
    segment's non-null region — null-key rows take their peer group as the
    frame (nulls are peers of each other). A decimal key is searched as
    scaled int64 with the offsets at its scale, so an edge row exactly an
    offset away stays in the frame. sum/count/avg use prefix sums (int64
    over decimals, ``dec``); min/max a sparse table (O(n log n) build, O(1)
    per row)."""
    from ballista_tpu_torch.plan.expr import (
        CURRENT_ROW, FOLLOWING, PRECEDING, UNBOUNDED_FOLLOWING,
        UNBOUNDED_PRECEDING,
    )

    idx = np.arange(n)
    starts = np.nonzero(seg_start)[0]
    seg_idx = np.cumsum(seg_start) - 1
    seg_ends = np.append(starts[1:], n)  # exclusive, per segment
    seg_first = starts[seg_idx]
    seg_last = seg_ends[seg_idx] - 1
    pstarts = np.nonzero(peer_start)[0]
    peer_idx = np.cumsum(peer_start) - 1
    peer_ends = np.append(pstarts[1:], n)
    peer_first = pstarts[peer_idx]
    peer_last = peer_ends[peer_idx] - 1

    f = w.frame
    if f.units == "rows":
        def row_bound(kind, off, is_start):
            if kind == UNBOUNDED_PRECEDING:
                return seg_first
            if kind == UNBOUNDED_FOLLOWING:
                return seg_last
            if kind == CURRENT_ROW:
                return idx
            delta = int(off)
            return idx - delta if kind == PRECEDING else idx + delta

        lo = row_bound(*f.start, True)
        hi = row_bound(*f.end, False)
    else:  # range
        has_offset = {f.start[0], f.end[0]} & {PRECEDING, FOLLOWING}
        if has_offset:
            if len(w.order_by) != 1:
                raise ExecutionError(
                    "RANGE frame with offset requires exactly one ORDER BY key"
                )
            raw, kvalid = peer_vals[0]
            asc = w.order_by[0][1]
            exact = _decimal_range_keys(raw, kvalid, f)
            key = (np.asarray(raw, np.float64) if exact is None else exact[0])[order]
            if not asc:
                key = -key  # normalize: PRECEDING is always "smaller key"
            kv_sorted = (
                np.ones(n, bool) if kvalid is None else np.asarray(kvalid)[order]
            )
            lo = np.empty(n, np.int64)
            hi = np.empty(n, np.int64)
            for s in range(len(starts)):
                a, b = starts[s], seg_ends[s]
                seg_valid = kv_sorted[a:b]
                nvalid = int(seg_valid.sum())
                # non-null region: prefix for asc (nulls last), suffix for
                # desc (nulls first) — matches _sort_key_arrays' encoding
                va = a if asc else b - nvalid
                vb = va + nvalid
                kseg = key[va:vb]

                def sbound(kind, off, is_start, sl=slice(a, b)):
                    if kind == UNBOUNDED_PRECEDING:
                        return np.full(b - a, a)
                    if kind == UNBOUNDED_FOLLOWING:
                        return np.full(b - a, b - 1)
                    if kind == CURRENT_ROW:
                        return (peer_first if is_start else peer_last)[sl]
                    d = float(off) if exact is None else exact[1][float(off)]
                    q = key[sl] + (d if kind == FOLLOWING else -d)
                    if is_start:
                        return va + np.searchsorted(kseg, q, "left")
                    return va + np.searchsorted(kseg, q, "right") - 1

                lo[a:b] = sbound(*f.start, True)
                hi[a:b] = sbound(*f.end, False)
                # null-key rows: an OFFSET bound collapses to the null peer
                # group (nulls are peers of each other), but UNBOUNDED /
                # CURRENT ROW bounds keep their meaning (Postgres semantics)
                nulls = ~seg_valid
                if nulls.any():
                    rows = idx[a:b][nulls]
                    if f.start[0] in (PRECEDING, FOLLOWING):
                        lo[rows] = peer_first[rows]
                    if f.end[0] in (PRECEDING, FOLLOWING):
                        hi[rows] = peer_last[rows]
        else:
            def peer_bound(kind, is_start):
                if kind == UNBOUNDED_PRECEDING:
                    return seg_first
                if kind == UNBOUNDED_FOLLOWING:
                    return seg_last
                return peer_first if is_start else peer_last

            lo = peer_bound(f.start[0], True)
            hi = peer_bound(f.end[0], False)

    lo = np.clip(lo, seg_first, seg_last + 1)
    hi = np.clip(hi, seg_first - 1, seg_last)
    empty_frame = lo > hi
    # valid-input count per frame (empty/all-null frames null out below)
    ccnt = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    hi_c = np.where(empty_frame, lo, hi + 1)  # avoid bogus gathers
    fcnt = ccnt[hi_c] - ccnt[lo]

    if w.fn in ("sum", "avg", "count"):
        vz = dec[1] if dec is not None else np.where(valid, vals, vals.dtype.type(0))
        csum = np.concatenate([[vz.dtype.type(0)], np.cumsum(vz)])
        fsum = csum[hi_c] - csum[lo]
        return _sum_or_avg(w.fn, fsum, fcnt, dec), (fcnt == 0) | empty_frame
    if w.fn in ("min", "max"):
        if is_int:
            info = np.iinfo(np.int64)
            sentinel = info.max if w.fn == "min" else info.min
        else:
            sentinel = np.inf if w.fn == "min" else -np.inf
        vv = np.where(valid, vals, vals.dtype.type(sentinel))
        reduce_ = np.minimum if w.fn == "min" else np.maximum
        # sparse table: level j answers ranges of length 2^j
        table = [vv]
        j = 1
        while (1 << j) <= n:
            prev = table[-1]
            half = 1 << (j - 1)
            table.append(reduce_(prev[: n - (1 << j) + 1], prev[half: n - half + 1]))
            j += 1
        length = np.maximum(hi - lo + 1, 1)
        level = np.floor(np.log2(length)).astype(np.int64)
        out = np.empty(n, vals.dtype)
        for lv in np.unique(level):
            m = level == lv
            span = 1 << int(lv)
            # clamp: an empty frame's clipped lo can be one past the array
            # end (the empty mask nulls the bogus gather out afterwards)
            l_ = np.minimum(lo[m], n - 1)
            r_ = np.maximum(np.minimum(hi[m], n - 1) - span + 1, l_)
            out[m] = reduce_(table[int(lv)][l_], table[int(lv)][r_])
        # frames whose only contents are null inputs stay at the sentinel
        return out, (fcnt == 0) | empty_frame
    raise ExecutionError(f"window function {w.fn} does not accept a frame")


def _scatter(order: np.ndarray, sorted_vals: np.ndarray, dt, n: int) -> Column:
    out = np.empty(n, sorted_vals.dtype)
    out[order] = sorted_vals
    return Column(dt, out)


def _agg_result(order, full_sorted, empty_sorted, w, n, is_int=False) -> Column:
    from ballista_tpu_torch.plan.schema import DataType as DT

    emp = np.empty(n, bool)
    emp[order] = empty_sorted
    if w.fn == "count":
        out = np.empty(n, np.int64)
        out[order] = np.asarray(full_sorted, dtype=np.int64)
        return Column(DT.INT64, out)
    dt = DT.INT64 if is_int else DT.FLOAT64
    out = np.empty(n, dt.to_numpy())
    out[order] = full_sorted
    return Column(dt, out, ~emp if emp.any() else None)


# ---- sort -------------------------------------------------------------------------
def _sort_key_arrays(c: Column, asc: bool):
    """Encode one sort key: returns (lex key arrays most-significant-first,
    comparable raw values, valid mask or None). NULL sorts as largest
    (NULLS LAST for asc, FIRST for desc) — shared by top-level ORDER BY and
    window functions so the semantics cannot diverge."""
    if c.dtype is DataType.STRING:
        _, codes = np.unique(
            np.asarray(c.data.fill_null("")).astype(object), return_inverse=True
        )
        v = codes.astype(np.int64)
        valid = np.asarray(c.data.is_valid()) if c.data.null_count else None
    else:
        v = np.asarray(c.data)
        valid = c.valid if c.valid is not None and not c.valid.all() else None
    raw = v
    if not asc:
        v = -v.astype(np.float64) if v.dtype.kind == "f" else -v.astype(np.int64)
    keys: list[np.ndarray] = []
    if valid is not None:
        nullind = (~valid).astype(np.int8) if asc else (valid.astype(np.int8) - 1)
        keys.append(nullind)
    keys.append(v)
    return keys, raw, valid


def sort_batch(
    batch: ColumnBatch, keys: Sequence[tuple[Expr, bool]], fetch: Optional[int] = None
) -> ColumnBatch:
    if batch.num_rows == 0:
        return batch
    lex_keys = []
    for e, asc in keys:
        ks, _, _ = _sort_key_arrays(evaluate(e, batch), asc)
        lex_keys.extend(ks)
    order = np.lexsort(tuple(reversed(lex_keys)))
    if fetch is not None:
        order = order[:fetch]
    return batch.take(order)
