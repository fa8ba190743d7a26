"""PyTorch execution engine — the port's device backend.

The port of ``ballista_tpu/engine/jax_engine.py``. Whole-stage execution:
the device-supported subtree of a stage (filter, project, hash aggregate,
sort) runs as one PyTorch program over tensors on the engine's device, with
power-of-two row buckets and validity masks. Host work is confined to the
leaves: scans and unsupported children materialize host-side (numpy
kernels), are encoded, and enter the program as tensors. String dictionaries
are host metadata — string predicates become lookup tables gathered by code
on the device.

PyTorch runs eagerly, so a stage program is traced anew on every call: there
is no compile cache, precompile or hint pipeline. Nodes outside
``_supported`` run on the host kernels, as the JAX engine's unsupported
nodes do, and each such run adds to ``op.HostFallback.count``. Joins,
windows, streaming, leaf caches, the memory governor and the fused and
multi-device exchanges are not ported yet.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional

import torch

from ballista_tpu_torch.config import BALLISTA_TPU_NATIVE_DTYPES, BallistaConfig
from ballista_tpu_torch.engine.numpy_engine import NumpyEngine
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.expr import (
    Agg, Alias, BinaryOp, Case, Cast, Col, Expr, Func, InList, IsNull, Like, Lit,
    Not, unalias, walk,
)
from ballista_tpu_torch.plan.schema import DataType


def resolve_device(device: Optional[str]) -> str:
    """The engine's device: ``None`` means ``cuda``. Raises when CUDA is asked
    for and unavailable — never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ExecutionError(f"torch engine runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutionError(
            "CUDA is not available; pass device='cpu' to run the torch engine on the host"
        )
    return str(dev)


class _HostFallback(Exception):
    """Raised at trace time when a runtime property forces the host kernel
    path for one stage (e.g. a string aggregate argument)."""


# operators the device could run: when one runs on the host kernels instead,
# it is a host fallback (scans, exchanges and merges are host work on every
# engine)
_DEVICE_OPS = (P.FilterExec, P.ProjectExec, P.HashAggregateExec, P.SortExec,
               P.HashJoinExec, P.CrossJoinExec, P.WindowExec)


class TorchEngine(NumpyEngine):
    name = "torch"

    def __init__(self, config: Optional[BallistaConfig] = None,
                 device: Optional[str] = None):
        super().__init__(config or BallistaConfig())
        self.device = torch.device(resolve_device(device))

    def _apply_dtype_policy(self) -> None:
        # module-level so trace-time literal/arith decisions see it
        KT.NATIVE_DTYPES = bool(self.config.get(BALLISTA_TPU_NATIVE_DTYPES))

    def execute_all(self, plan: P.PhysicalPlan) -> list[ColumnBatch]:
        # serial over partitions: one device, and the host thread pool of the
        # numpy engine would only interleave launches
        self._apply_dtype_policy()
        self._cache.clear()
        return [self._exec(plan, i) for i in range(plan.output_partitions())]

    # ---- dispatch --------------------------------------------------------------
    def _exec(self, plan: P.PhysicalPlan, part: int) -> ColumnBatch:
        if _supported(plan):
            try:
                t0 = time.time()
                out = self._run_stage(plan, part)
                self._metric("op.CompiledStage.time_s", time.time() - t0)
                return out
            except (_HostFallback, KT.DeviceUnsupported):
                pass  # a runtime shape the device path cannot express: host kernels
        return super()._exec(plan, part)

    def _exec_inner(self, plan: P.PhysicalPlan, part: int) -> ColumnBatch:
        if isinstance(plan, _DEVICE_OPS):
            self._metric("op.HostFallback.count", 1.0)
        return super()._exec_inner(plan, part)

    def _metric(self, key: str, val: float) -> None:
        with self._lock:
            self.op_metrics[key] = self.op_metrics.get(key, 0.0) + val

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- the stage driver ----------------------------------------------------------
    def _run_stage(self, plan: P.PhysicalPlan, part: int) -> ColumnBatch:
        leaves = self._collect_leaves(plan, part)
        tensors = self._device_args(leaves)
        stage_fn, holder = _make_stage_fn(plan, _stage_layout(leaves))

        t0 = time.time()
        out = stage_fn(*tensors)
        self._sync()
        dt = time.time() - t0
        in_rows = float(sum(enc.n_rows for enc, _ in leaves.values()))
        self._metric("op.DeviceExecute.time_s", dt)
        self._metric("op.DeviceExecute.count", 1.0)
        self._metric("op.DeviceExecute.rows", in_rows)

        out_db = KT.device_batch_from_outputs(holder["meta"], list(out), 0)
        t0 = time.time()
        batch = KT.to_host(out_db)
        self._metric("op.DeviceFetch.time_s", time.time() - t0)
        self._metric(
            "op.DeviceFetch.bytes",
            float(sum(c.data.nbytes for c in batch.columns
                      if c.dtype is not None and not c.dtype.is_string)),
        )
        return batch

    def _device_args(self, leaves: dict) -> list:
        """Every leaf array on the device, in the stage's parameter order.
        The copies are issued non-blocking from pinned memory and awaited
        together, so the transfer time stays out of the execute time."""
        t0 = time.time()
        out = []
        nbytes = 0
        for enc, _node in leaves.values():
            for a in enc.arrays:
                out.append(KT.host_to_device(a, self.device))
                nbytes += a.nbytes
        self._sync()
        self._metric("op.DeviceTransfer.time_s", time.time() - t0)
        self._metric("op.DeviceTransfer.bytes", float(nbytes))
        return out

    # ---- leaf collection -------------------------------------------------------------
    def _collect_leaves(self, plan: P.PhysicalPlan, part: int) -> dict:
        """Walk the device subtree; materialize and encode its leaf inputs on
        the host. Returns {id(node): (EncodedBatch, node)}; insertion order is
        the stage's parameter layout."""
        leaves: dict[int, tuple] = {}

        def visit(node: P.PhysicalPlan):
            if _supported(node):
                for c in node.children():
                    visit(c)
                return
            batch = self._exec_child(node, part)
            t0 = time.time()
            enc = KT.encode_host_batch(batch)
            self._metric("op.HostEncode.time_s", time.time() - t0)
            leaves[id(node)] = (enc, node)

        visit(plan)
        return leaves

    def _exec_child(self, node: P.PhysicalPlan, part: int) -> ColumnBatch:
        """Host-materialize a leaf; its own subtree may still use device
        stages (NumpyEngine dispatches children through ``self._exec``)."""
        return NumpyEngine._exec(self, node, part)


def _stage_layout(leaves: dict) -> dict:
    """{leaf node id: (start, end, EncodedBatch)} over the flat tensor list."""
    slices = {}
    pos = 0
    for node_id, (enc, _node) in leaves.items():
        slices[node_id] = (pos, pos + len(enc.arrays), enc)
        pos += len(enc.arrays)
    return slices


def _make_stage_fn(plan: P.PhysicalPlan, slices: dict):
    """The whole-stage function over the flat tensor layout, plus the holder
    its call fills with the output's static metadata."""
    holder: dict = {}

    def stage_fn(*args):
        env = {
            node_id: KT.device_batch_from_encoded(enc, list(args[s:e]))
            for node_id, (s, e, enc) in slices.items()
        }
        out_db = _trace_node(plan, env)
        arrays, meta = KT.flatten_device_batch(out_db)
        holder["meta"] = meta
        return tuple(arrays)

    return stage_fn, holder


def _supported(plan: P.PhysicalPlan) -> bool:
    if isinstance(plan, P.FilterExec):
        return _expr_ok(plan.predicate)
    if isinstance(plan, P.ProjectExec):
        return all(_expr_ok(e) for e in plan.exprs)
    if isinstance(plan, P.HashAggregateExec):
        if plan.mode not in ("single", "partial", "final"):
            return False
        for e in plan.group_exprs:
            if not _expr_ok(e):
                return False
        for e in plan.agg_exprs:
            a = unalias(e)
            if a.fn not in ("sum", "avg", "min", "max", "count", "count_star"):
                return False
            if a.expr is not None and not _expr_ok(a.expr):
                return False
        return True
    if isinstance(plan, P.SortExec):
        return all(_expr_ok(e) for e, _ in plan.keys)
    return False


def _expr_ok(e: Expr) -> bool:
    """Can this expression evaluate on the device (strings only as
    dictionary ops)?"""
    for n in walk(e):
        if isinstance(n, (Col, Lit, BinaryOp, Not, IsNull, Case, Cast, Like, InList, Alias)):
            continue
        if isinstance(n, Func) and n.fn in KT.DEVICE_FUNCS:
            continue
        if isinstance(n, Agg):
            continue  # checked by the aggregate support path
        return False
    return True


# ---- tracing (module-level: the stage function must not retain an engine) ---------
def _trace_node(plan: P.PhysicalPlan, env: dict):
    if id(plan) in env:
        return env[id(plan)]

    if isinstance(plan, P.FilterExec):
        db = _trace_node(plan.input, env)
        vals, null = KT.eval_dev_predicate(plan.predicate, db)
        keep = vals if null is None else (vals & ~null)
        return KT.DeviceBatch(db.schema, db.cols, db.row_valid & keep, db.n_rows)

    if isinstance(plan, P.ProjectExec):
        db = _trace_node(plan.input, env)
        schema = plan.schema()
        cols = [
            _coerce_dev(KT.eval_dev(e, db), f.dtype) for e, f in zip(plan.exprs, schema)
        ]
        return KT.DeviceBatch(schema, cols, db.row_valid, db.n_rows)

    if isinstance(plan, P.HashAggregateExec):
        return _trace_agg(plan, env)

    if isinstance(plan, P.SortExec):
        db = _trace_node(plan.input, env)
        key_specs = [(KT.eval_dev(e, db), asc) for e, asc in plan.keys]
        return KT.sort_device(db, key_specs, plan.fetch)

    raise ExecutionError(f"cannot trace {type(plan).__name__}")


def _trace_agg(plan: P.HashAggregateExec, env: dict):
    """An aggregate in two phases: every aggregate's arguments are evaluated
    (and ``presum_safe`` run) in plan order while its sums and counts are
    registered with one ``SegSums``, which computes them all at once; then
    each aggregate builds its output columns from the results."""
    db = _trace_node(plan.input, env)
    out_schema = plan.schema()
    key_cols = [KT.eval_dev(g, db) for g in plan.group_exprs]

    if not key_cols:
        ids = (~db.row_valid).to(torch.int64)  # valid rows 0, the rest 1
        k, per_key = 1, None
    else:
        kind, info = KT.group_plan(key_cols, db.n_pad)
        if kind != "direct":
            # sort-based segmentation hashes the keys with splitmix64, which
            # comes with the join slice
            raise KT.DeviceUnsupported("sorted grouping is not ported yet")
        per_key = info
        ids, k = KT.group_ids_direct(db, key_cols, per_key)

    sums = KT.SegSums(ids, k, db.row_valid)
    seen_at = sums.count(None)
    builds = [_trace_agg_cols(plan.mode, unalias(e), e.name(), db, sums)
              for e in plan.agg_exprs]
    res = sums.compute()

    out_cols: list = []
    if key_cols:
        out_cols.extend(KT.decode_group_keys(key_cols, per_key, k))
    for build in builds:
        out_cols.extend(build(res))

    pad = KT.bucket_size(k)
    padded = [
        replace(
            c,
            data=_pad_dev(c.data, pad),
            null=_pad_dev(c.null, pad) if c.null is not None else None,
        )
        for c in out_cols
    ]
    if key_cols:
        row_valid = _pad_dev(res[seen_at] > 0, pad)
    else:
        # a global aggregate over zero rows still emits its single row (SQL)
        row_valid = torch.arange(pad, device=db.device) < 1
    return KT.DeviceBatch(out_schema, padded, row_valid, k)


def _trace_agg_cols(mode, a: Agg, name, db, sums):
    """Phase one of one aggregate: evaluates its argument, registers its
    sums and counts with ``sums``, and returns ``build(res)``, which makes
    its output columns from ``sums.compute()``'s results."""
    rv = db.row_valid

    def arg_col():
        c = KT.eval_dev(a.expr, db)
        if c.is_string:
            raise _HostFallback()
        return c

    def seg_sum_col(c):
        """Segment sum preserving the scaled-int64 representation: scaled
        inputs sum EXACTLY in int64 (presum_safe proves headroom or falls
        back), unscaled inputs keep their own width. The output inherits the
        subset-sum bound, so re-summing states stays provably safe. Returns
        ``make(res, label, null_mark)`` for the column."""
        cc = KT.presum_safe(c, db.n_pad)
        at = sums.sum(cc.data, cc.null)
        rng = KT.sum_range(cc, db.n_pad)
        bound = KT._sum_bound(cc, db.n_pad) if cc.scale is not None else None

        def make(res, label, null_mark=None):
            return KT.DeviceCol(label, res[at], null_mark, range=rng, scale=cc.scale,
                                ssum=bound)

        return make

    def avg_div(scol, cnt, null_mark):
        """Final AVG division: scaled sums divide EXACTLY in int64 and stay a
        scaled decimal; unscaled sums keep their float width."""
        if scol.scale is not None:
            data, out_scale, mul = KT.avg_scaled(scol.data, cnt, scol.scale, KT._eb(scol))
            rng = None
            rp = KT._range_pair(scol)
            if rp is not None:
                rng = KT.bucket_range(rp[0] * mul, rp[1] * mul)
            return KT.DeviceCol(DataType.FLOAT64, data, null_mark,
                                range=rng, scale=out_scale)
        return KT.DeviceCol(DataType.FLOAT64, scol.data / torch.clamp(cnt, min=1), null_mark)

    def sum_of(c):
        cnt = sums.count(c.null)
        s = seg_sum_col(c)
        dtype = _sum_dtype(c.dtype)
        return lambda res: [s(res, dtype, res[cnt] == 0)]

    def min_max_of(c):
        m = KT.seg_min(c.data, sums.ids, sums.k, rv, c.null, a.fn == "min")
        cnt = sums.count(c.null)
        return lambda res: [KT.DeviceCol(_sum_dtype(c.dtype), m, res[cnt] == 0,
                                         range=c.range, scale=c.scale)]

    if mode in ("single", "partial"):
        if a.fn == "count_star":
            cnt = sums.count(None)
            return lambda res: [KT.DeviceCol(DataType.INT64, res[cnt])]
        if a.fn == "count":
            cnt = sums.count(KT.eval_dev(a.expr, db).null)
            return lambda res: [KT.DeviceCol(DataType.INT64, res[cnt])]
        c = arg_col()
        if a.fn == "sum":
            return sum_of(c)
        if a.fn == "avg":
            cnt = sums.count(c.null)
            if c.scale is None and not c.dtype.is_floating:
                # int argument: exact scale-0 sums under the native policy,
                # f64 sums otherwise
                sc = KT.as_scaled(c) if KT.NATIVE_DTYPES else None
                c = sc if sc is not None else replace(c, data=c.data.to(torch.float64))
            s = seg_sum_col(c)
            if mode == "partial":
                return lambda res: [s(res, DataType.FLOAT64),
                                    KT.DeviceCol(DataType.INT64, res[cnt])]
            return lambda res: [avg_div(s(res, DataType.FLOAT64), res[cnt], res[cnt] == 0)]
        if a.fn in ("min", "max"):
            return min_max_of(c)
        raise ExecutionError(a.fn)

    # final: merge partial states located by name
    if a.fn in ("count", "count_star"):
        st = db.col(f"{name}#count")
        at = sums.sum(st.data, st.null)
        return lambda res: [KT.DeviceCol(DataType.INT64, res[at])]
    if a.fn == "avg":
        s = db.col(f"{name}#sum")
        cn = db.col(f"{name}#count")
        ssum = seg_sum_col(s)
        scnt = sums.sum(cn.data, cn.null)
        return lambda res: [avg_div(ssum(res, DataType.FLOAT64), res[scnt], res[scnt] == 0)]
    st = db.col(f"{name}#{a.fn}")
    if st.is_string:
        raise _HostFallback()
    if a.fn == "sum":
        return sum_of(st)
    if a.fn in ("min", "max"):
        return min_max_of(st)
    raise ExecutionError(a.fn)


def _sum_dtype(dt: DataType) -> DataType:
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return DataType.FLOAT64
    if dt is DataType.DATE32:
        return DataType.DATE32
    return DataType.INT64


def _coerce_dev(c, dtype: DataType):
    if c.dtype is dtype or c.is_string:
        return c
    return KT.convert_repr(c, dtype)


def _pad_dev(a, pad: int):
    if a is None:
        return None
    n = a.shape[0]
    if n == pad:
        return a
    if n > pad:
        return a[:pad]
    return torch.cat([a, torch.zeros(pad - n, dtype=a.dtype, device=a.device)])
