#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ballista_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:

1. device  — the card's name and power limit (nvidia-smi); CUDA must exist.
2. build   — every hand-written kernel (``ballista_tpu_torch/csrc/*.cu``)
             compiles with nvcc for sm_90a, all at once.
3. kernels — each kernel's wrapper on card tensors against its plain PyTorch
             version: int64 results exact, float32 within rtol 1e-5 and
             bitwise equal run to run; grouped_sums at one column and at
             several (q1's stage shape, mixed masks, f32, no rows, views
             off a 16-byte boundary).
4. slice   — TPC-H SF1 lineitem (6,001,215 rows, 4 parquet parts, generated
             from a seed by the port's own ``models/tpch.py``); q1 and q6
             through ``BallistaContext.standalone()`` on ``cuda``, cold then
             warm (and once more under torch.profiler), each held against
             an exact numpy int64 reference (ints, strings and decimal sums
             exactly equal, AVG within 1e-6 relative) and the port's host
             engine, ``backend="numpy"`` (floats within 1e-6 relative: it
             sums decimals in f64). Each query's launch count is zeroed
             just before its run and read just after; every kernel must
             have launched in each query's warm run (grouped_sums once per
             aggregate stage) and no operator may have fallen back to the
             host. The (n, k, columns) shapes the stages gave grouped_sums
             are recorded and the kernel checked at each.
5. timing  — grouped_sums at one column (2^21 rows, k = 12, int64), at
             the largest and smallest stages of q1's warm run, and at a
             stage of 16 int64 columns at k = 32, which the wrapper splits
             into launches (L2 flushed before every call, CUDA events,
             device time only), beside
             its plain version, one PyTorch library call computing the same
             function, a torch sum over the same bytes, the least time the
             card could take (bytes over 3.35 TB/s), and the time of one
             one-element add_ (the least any launch takes here).

It prints the kernels line and the nvidia-smi line before its last line, and
ends with one JSON object naming the device. It imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO, ".chip_smoke_data")
SF = 1.0
LINEITEM_PARTS = 4
QUERIES = ("q1", "q6")
# H100 SXM, NVIDIA's data sheet: HBM3 rate at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


# ---- 1. device ---------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---- 3. kernel vs plain ------------------------------------------------------------
def grouped_sums_inputs(n: int, k: int, seed: int, device):
    """Ids in [0, k) plus trash ids (-1, k, k + 5), ~20% invalid rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, k, n).astype(np.int64)
    trash = rng.random(n) < 0.1
    ids[trash] = rng.choice(np.array([-1, k, k + 5]), int(trash.sum()))
    valid = rng.random(n) < 0.8
    ivals = rng.integers(-(10**12), 10**12, n).astype(np.int64)
    fvals = rng.random(n).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return to(ids), to(valid), to(ivals), to(fvals)


def check_grouped_sums(n: int, k: int, seed: int, device) -> float:
    """int64 sums, counts and f32 sums of the kernel against its plain
    version; returns the largest absolute difference seen."""
    from ballista_tpu_torch.ops.grouped_sums import grouped_sums, grouped_sums_ref

    ids, valid, ivals, fvals = grouped_sums_inputs(n, k, seed, device)
    worst = 0.0
    for label, vals in (("int64", ivals), ("count", valid.to(torch.int64)), ("f32", fvals)):
        got = grouped_sums(vals, ids, valid, k)
        want = grouped_sums_ref(vals, ids, valid, k)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != (k,):
            raise AssertionError(f"grouped_sums n={n} k={k} {label}: {got.dtype}{tuple(got.shape)}")
        if label == "f32":
            if not torch.allclose(got, want, rtol=1e-5):
                raise AssertionError(f"grouped_sums n={n} k={k} f32: {got} vs {want}")
            again = grouped_sums(vals, ids, valid, k)
            if not torch.equal(got, again):
                raise AssertionError(f"grouped_sums n={n} k={k}: f32 sums differ run to run")
        elif not torch.equal(got, want):
            raise AssertionError(f"grouped_sums n={n} k={k} {label}: {got} vs {want}")
        worst = max(worst, float((got.double() - want.double()).abs().max()))
        print(f"grouped_sums n={n} k={k} {label}: ok (max_abs_err {worst:g})", flush=True)
    return worst


def stage_inputs(n: int, k: int, ncols: int, seed: int, device, offset: int = 0,
                 dtype: torch.dtype = torch.int64):
    """An aggregate stage's columns as q1's partial stage has them: ncols - 1
    int64 sums and one count (or ncols float32 sums), all over one mask;
    each array a view that starts ``offset`` rows into its storage."""
    rng = np.random.default_rng(seed)
    m = n + offset
    ids, valid, _, _ = grouped_sums_inputs(m, k, seed, "cpu")
    to = lambda t: t.to(device)[offset:]  # noqa: E731
    if dtype == torch.float32:
        vals = [to(torch.from_numpy(rng.random(m).astype(np.float32))) for _ in range(ncols)]
    else:
        vals = [to(torch.from_numpy(rng.integers(-(10**12), 10**12, m).astype(np.int64)))
                for _ in range(ncols - 1)] + [None]
    return to(ids), vals, to(valid)


def check_multi(label: str, vals, masks, ids, k: int) -> float:
    """One multi-column call against its plain version (int64 exact; f32
    within rtol 1e-5 and bitwise equal on a second call); returns the
    largest absolute difference."""
    from ballista_tpu_torch.ops.grouped_sums import grouped_sums_multi, grouped_sums_multi_ref

    got = grouped_sums_multi(vals, masks, ids, k)
    want = grouped_sums_multi_ref(vals, masks, ids, k)
    if got.is_cuda:
        torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"grouped_sums_multi {label}: {got.dtype}{tuple(got.shape)}")
    if got.dtype == torch.float32:
        if not torch.allclose(got, want, rtol=1e-5):
            raise AssertionError(f"grouped_sums_multi {label}: {got} vs {want}")
        if not torch.equal(got, grouped_sums_multi(vals, masks, ids, k)):
            raise AssertionError(f"grouped_sums_multi {label}: f32 sums differ run to run")
    elif not torch.equal(got, want):
        raise AssertionError(f"grouped_sums_multi {label}: {got} vs {want}")
    err = float((got.double() - want.double()).abs().max()) if got.numel() else 0.0
    print(f"grouped_sums_multi {label}: ok (max_abs_err {err:g})", flush=True)
    return err


def check_multi_shapes(device) -> float:
    """The multi-column kernel at q1's stage shape and the cases around it:
    mixed masks, int64 sums with counts, f32 twice, no rows, unaligned
    views, and calls wider than one launch takes (the wrapper splits them)."""
    worst = 0.0
    n, k = 1 << 21, 12
    ids, vals, valid = stage_inputs(n, k, 8, 21, device)
    worst = max(worst, check_multi(f"n={n} k={k} C=8 (7 int64 + count, one mask)",
                                   vals, [valid] * 8, ids, k))
    rng = np.random.default_rng(22)
    other = [torch.from_numpy(rng.random(n) < p).to(device) for p in (0.5, 0.95)]
    masks = [valid, other[0], valid, other[1], other[0], valid, other[1], other[0]]
    worst = max(worst, check_multi(f"n={n} k={k} C=8 mixed masks", vals, masks, ids, k))
    f = [torch.from_numpy(rng.random(n).astype(np.float32)).to(device) for _ in range(4)]
    worst = max(worst, check_multi(f"n={n} k={k} C=4 f32", f, masks[:4], ids, k))
    for wk, ncols, dtype in ((32, 40, torch.int64), (32, 20, torch.float32),
                             (12, 33, torch.int64)):
        w_ids, w_vals, _ = stage_inputs(n, wk, ncols, 30 + ncols, device, dtype=dtype)
        w_masks = [(valid, other[0], other[1])[c * 3 // ncols] for c in range(ncols)]
        worst = max(worst, check_multi(f"n={n} k={wk} C={ncols} {dtype} three masks",
                                       w_vals, w_masks, w_ids, wk))
    e_ids, e_vals, e_valid = stage_inputs(0, 5, 3, 23, device)
    worst = max(worst, check_multi("n=0 k=5 C=3", e_vals, [e_valid] * 3, e_ids, 5))
    for off in (1, 3):
        u_ids, u_vals, u_valid = stage_inputs(100_003, 7, 4, 24 + off, device,
                                                  offset=off)
        worst = max(worst, check_multi(f"n=100003 k=7 C=4 view at row {off}",
                                       u_vals, [u_valid] * 4, u_ids, 7))
    return worst


# ---- 4. the slice ------------------------------------------------------------------
def lineitem_dir(data_dir: str, sf: float, parts: int) -> str:
    from ballista_tpu_torch.models.tpch import generate_tpch

    root = os.path.join(data_dir, f"tpch_sf{sf:g}_p{parts}")
    t0 = time.time()
    out = generate_tpch(root, sf=sf, tables=["lineitem"], parts_per_table=parts)
    print(f"lineitem sf={sf:g}: {out['lineitem']} ({time.time() - t0:.1f} s)", flush=True)
    return out["lineitem"]


def _day(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def _hundredths(v: np.ndarray) -> np.ndarray:
    """Exact int64 hundredths of a 2-decimal f64 column."""
    c = np.round(v * 100).astype(np.int64)
    if not np.array_equal(c / 100.0, v):
        raise AssertionError("lineitem column is not an exact 2-decimal column")
    return c


def exact_reference(lineitem: str) -> dict:
    """q1 and q6 computed exactly, independently of the port: numpy int64
    sums of hundredths over the parquet files, converted to the nearest
    double once at the end (Python's int / int rounds correctly). Returns
    {query: {column: list of values in ORDER BY order}}."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pq.read_table(lineitem, columns=[
        "l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
        "l_linestatus", "l_shipdate"])
    days = t.column("l_shipdate").cast(pa.int32()).to_numpy()
    qty, price, disc, tax = (_hundredths(t.column(c).to_numpy()) for c in
                             ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    rf = t.column("l_returnflag").to_numpy(zero_copy_only=False)
    ls = t.column("l_linestatus").to_numpy(zero_copy_only=False)

    keep = days <= _day("1998-09-02")  # date '1998-12-01' - interval '90' day
    q1: dict = {}
    for f, s in sorted(set(zip(rf[keep], ls[keep]))):
        m = keep & (rf == f) & (ls == s)
        n = int(m.sum())
        sq, sp, sd = int(qty[m].sum()), int(price[m].sum()), int(disc[m].sum())
        row = {
            "l_returnflag": f, "l_linestatus": s,
            "sum_qty": sq / 100, "sum_base_price": sp / 100,
            "sum_disc_price": int((price[m] * (100 - disc[m])).sum()) / 10**4,
            "sum_charge": int((price[m] * (100 - disc[m]) * (100 + tax[m])).sum()) / 10**6,
            "avg_qty": sq / (100 * n), "avg_price": sp / (100 * n), "avg_disc": sd / (100 * n),
            "count_order": n,
        }
        for k, v in row.items():
            q1.setdefault(k, []).append(v)
    m = ((days >= _day("1994-01-01")) & (days < _day("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    q6 = {"revenue": [int((price[m] * disc[m]).sum()) / 10**4]}
    return {"q1": q1, "q6": q6}


# q1's sum_charge is a product of three 2-digit decimals (scale 6). At SF1
# the engine's trace-time int64 headroom analysis (presum_safe, the JAX
# package's semantics) cannot prove a 2^21-row sum at scale 6 safe from the
# loosely bucketed literal ranges, so it rounds each row to fewer decimals
# first. That one column (mapped to the column holding its group's row
# count) is held to the error that rounding allows; every other sum exactly.
ROUNDED_SUMS = {"sum_charge": "count_order"}


def rounding_error(presums: list) -> float:
    """The most one summed value can move in the run's presum_safe calls:
    dropping digits from scale ``a`` to ``b`` one at a time, half to even,
    moves a value by at most sum(0.5 * 10**-s for s in [b, a))."""
    return max((sum(0.5 * 10.0**-s for s in range(b, a)) for a, b in presums
                if a is not None and b < a), default=0.0)


def check_result(got, host, exact: dict, qname: str, presums: list) -> None:
    """Against the exact reference: ints, strings and decimal sums exactly
    equal, AVG within 1e-6 relative. A ``ROUNDED_SUMS`` column may differ by
    what the run's presum_safe rounding allows: each of its group's rows
    rounded once, and each partial sum of it at most once more (there are
    no more partial sums of a group than presum_safe calls), plus 2 ulp for
    the two conversions to f64. Against the port's host engine: ints and
    strings exact, floats within 1e-6 relative (the host engine sums
    decimals in f64, which drifts in the last digits at this scale)."""
    if got.schema.names != list(exact) or got.schema.names != host.schema.names:
        raise AssertionError(f"{qname}: columns {got.schema.names}")
    for name in got.schema.names:
        g = got.column(name).to_numpy(zero_copy_only=False)
        h = host.column(name).to_numpy(zero_copy_only=False)
        x = np.array(exact[name])
        if len(g) != len(x) or len(g) != len(h) or len(g) == 0:
            raise AssertionError(f"{qname}.{name}: {len(g)} rows, exact {len(x)}, host {len(h)}")
        if g.dtype.kind == "f":
            if not np.all(np.isfinite(g)):
                raise AssertionError(f"{qname}.{name}: non-finite {g}")
            if name.startswith("avg"):
                ok_exact = np.allclose(g, x, rtol=1e-6, atol=0)
            elif name in ROUNDED_SUMS:
                rows = got.column(ROUNDED_SUMS[name]).to_numpy().astype(np.float64)
                allowed = (rounding_error(presums) * (rows + len(presums))
                           + 2 * np.spacing(np.abs(x)))
                ok_exact = bool(np.all(np.abs(g - x) <= allowed))
                print(f"{qname}.{name}: largest difference from exact "
                      f"{np.abs(g - x).max():.6g}, allowed {allowed.min():.6g} and up "
                      f"(presum_safe scales in -> out: "
                      f"{sorted({p for p in presums if p[0] is not None})})", flush=True)
            else:
                ok_exact = np.array_equal(g, x)
            ok_host = np.allclose(g, h, rtol=1e-6, atol=0)
        else:
            ok_exact, ok_host = np.array_equal(g, x), np.array_equal(g, h)
        if not ok_exact:
            raise AssertionError(f"{qname}.{name}: {g.tolist()} vs exact {x.tolist()}")
        if not ok_host:
            raise AssertionError(f"{qname}.{name}: {g.tolist()} vs host engine {h.tolist()}")


def run_counted(ctx, sql: str) -> dict:
    """One collect, with grouped_sums' launch count set to 0 just before
    it and read just after. Also records the shapes (n, k, columns, dtype)
    grouped_sums was given and each presum_safe call's (scale in, scale
    out)."""
    import ballista_tpu_torch.ops.grouped_sums as GS
    import ballista_tpu_torch.ops.kernels_torch as KT

    shapes: dict = {}
    presums: list = []
    real_gs, real_ps = GS.grouped_sums_multi, KT.presum_safe

    def gs(vals, masks, ids, k):
        dtype = next((v.dtype for v in vals if v is not None), torch.int64)
        key = (int(ids.shape[0]), int(k), len(vals), dtype)
        shapes[key] = shapes.get(key, 0) + 1
        return real_gs(vals, masks, ids, k)

    def ps(c, n_pad):
        out = real_ps(c, n_pad)
        presums.append((c.scale, out.scale))
        return out

    GS.grouped_sums_multi, KT.presum_safe = gs, ps
    try:
        GS.launches = 0
        t0 = time.time()
        got = ctx.sql(sql).collect()
        wall = time.time() - t0
        launches = GS.launches
    finally:
        GS.grouped_sums_multi, KT.presum_safe = real_gs, real_ps
    return {"table": got, "wall": wall, "launches": launches, "shapes": shapes,
            "presums": presums, "metrics": dict(ctx.last_engine_metrics)}


def run_slice(device: str, lineitem: str, runs=("cold", "warm"), profile: bool = False):
    """q1 and q6 on the torch engine, each held against the host engine.
    Returns {(query, run): run_counted's record} and, with ``profile``,
    {query: profile_run's record} from one more run under torch.profiler."""
    from ballista_tpu_torch.client.context import BallistaContext

    exact = exact_reference(lineitem)
    host = BallistaContext.standalone(backend="numpy")
    host.register_parquet("lineitem", lineitem)
    want = {}
    for q in QUERIES:
        with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        t0 = time.time()
        want[q] = (sql, host.sql(sql).collect())
        print(f"{q} host engine: {time.time() - t0:.3f} s", flush=True)

    ctx = BallistaContext.standalone(device=device)
    ctx.register_parquet("lineitem", lineitem)
    out = {}
    for q in QUERIES:
        sql, expect = want[q]
        for run in runs:
            r = run_counted(ctx, sql)
            check_result(r["table"], expect, exact[q], q, r["presums"])
            m = r["metrics"]
            if m.get("op.HostFallback.count", 0.0) != 0.0:
                raise AssertionError(f"{q}: {m['op.HostFallback.count']:g} host fallbacks")
            if m.get("op.DeviceExecute.count", 0.0) < 2:
                raise AssertionError(f"{q}: device stages {m.get('op.DeviceExecute.count')}")
            if r["launches"] <= 0:
                raise AssertionError(f"{q} {run}: grouped_sums never launched")
            if r["launches"] != m["op.DeviceExecute.count"]:
                raise AssertionError(f"{q} {run}: {r['launches']} grouped_sums launches in "
                                     f"{m['op.DeviceExecute.count']:g} aggregate stages")
            out[(q, run)] = r
    prof = {q: profile_run(ctx, want[q][0]) for q in QUERIES} if profile else {}
    return out, prof


def profile_run(ctx, sql: str) -> dict:
    """One run under torch.profiler: its wall, the device busy time in it
    (the sum of CUDA kernel and copy time the profiler records) and the
    five busiest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.time()
        ctx.sql(sql).collect()
        torch.cuda.synchronize()
        wall = time.time() - t0
    events = [e for e in p.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return {"wall": wall, "busy": busy_us / 1e6,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]}


# ---- 5. timing ---------------------------------------------------------------------
def time_grouped_sums(ids, vals, masks, k: int) -> dict:
    """One multi-column call timed beside its plain version and one PyTorch
    call computing the same function: index_add_ of an [n, C] tensor into
    k + 1 rows, trash ids clamped to the last one and masked rows zeroed
    (prepared outside the timing). Also the launches the call makes."""
    import ballista_tpu_torch.ops.grouped_sums as GS
    from ballista_tpu_torch.ops.grouped_sums import grouped_sums_multi, grouped_sums_multi_ref
    from ballista_tpu_torch.tools.timing import host_ms, time_cuda

    n, ncols = int(ids.shape[0]), len(vals)
    dtype = next((v.dtype for v in vals if v is not None), torch.int64)
    zero = torch.zeros((), dtype=dtype, device=ids.device)
    ids_c = torch.where((ids >= 0) & (ids < k), ids, torch.full_like(ids, k))
    vals_nc = torch.stack([torch.where(m, m.to(dtype) if v is None else v, zero)
                           for v, m in zip(vals, masks)], dim=1)
    lib = torch.zeros(k + 1, ncols, dtype=dtype, device=ids.device).index_add_(0, ids_c, vals_nc)
    ref = grouped_sums_multi_ref(vals, masks, ids, k)
    if dtype == torch.int64 and not torch.equal(lib[:k].T, ref):
        raise AssertionError("index_add_ yardstick disagrees with the plain version")
    before = GS.launches
    grouped_sums_multi(vals, masks, ids, k)
    per_call = GS.launches - before
    ms = time_cuda(lambda: grouped_sums_multi(vals, masks, ids, k))
    call_ms = host_ms(lambda: grouped_sums_multi(vals, masks, ids, k))
    plain_ms = time_cuda(lambda: grouped_sums_multi_ref(vals, masks, ids, k))
    library_ms = time_cuda(
        lambda: torch.zeros(k + 1, ncols, dtype=dtype, device=ids.device).index_add_(0, ids_c, vals_nc)
    )
    # each input read once: ids, each distinct mask, each value column; the
    # [C, k] sums written once. One add per row and column is far below any
    # listed peak rate's time: bytes bind
    row_bytes = ids.element_size() + len({m.data_ptr() for m in masks}) \
        + sum(v.element_size() for v in vals if v is not None)
    nbytes = n * row_bytes + ncols * k * zero.element_size()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # what reading the same bytes costs PyTorch's own reduction: the rate a
    # plain streaming kernel reaches on this card
    flat = torch.ones(max(1, nbytes // 8), dtype=torch.int64, device=ids.device)
    read_ms = time_cuda(lambda: flat.sum())
    return {"n": n, "k": k, "columns": ncols, "dtype": str(dtype), "launches": per_call,
            "ms": ms,
            "host_ms": call_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "bytes": nbytes,
            "share_of_bound": bound_ms / ms, "read_ms": read_ms}


def main() -> int:
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}", flush=True)

    from ballista_tpu_torch.ops import cuda_build

    phase("build")
    t0 = time.time()
    took = cuda_build.build()
    for name, s in took.items():
        print(f"built {name} in {s:.1f} s", flush=True)
        for line in cuda_build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {line.strip()}")
    print(f"build total {time.time() - t0:.1f} s", flush=True)

    phase("kernels")
    max_err = 0.0
    for n, k, seed in ((1 << 21, 12, 1), (5000, 7, 2), (4097, 1, 3), (4097, 32, 4)):
        max_err = max(max_err, check_grouped_sums(n, k, seed, "cuda"))
    max_err = max(max_err, check_multi_shapes("cuda"))

    phase("slice")
    lineitem = lineitem_dir(DATA_DIR, SF, LINEITEM_PARTS)
    results, prof = run_slice("cuda", lineitem, profile=True)
    for (q, run), r in results.items():
        m = r["metrics"]
        dev = {k: round(v, 6) for k, v in sorted(m.items()) if k.startswith("op.Device")}
        print(f"{q} {run}: wall {r['wall']:.3f} s, grouped_sums launches {r['launches']}, "
              f"host fallbacks {m.get('op.HostFallback.count', 0.0):g}, {dev} [{card}]",
              flush=True)
        if run == "warm":
            print(f"{q} warm, all operator metrics: {m}", flush=True)
            print(f"{q} warm, grouped_sums shapes (n, k, columns, dtype): calls "
                  f"{ {str(s): c for s, c in r['shapes'].items()} }", flush=True)
    for q, p in prof.items():
        print(f"{q} profiled run: device busy {p['busy'] * 1e3:.3f} ms = "
              f"{100 * p['busy'] / p['wall']:.2f}% of that run's wall {p['wall']:.3f} s; "
              f"busiest (name, calls, ms): {p['top']} [{card}]", flush=True)
    # the main path: each query's warm run, its count zeroed just before it
    by_path = {q: results[(q, "warm")]["launches"] for q in QUERIES}
    print(f"grouped_sums launches on the main path, by query: {by_path}", flush=True)
    shapes: dict = {}
    for q in QUERIES:
        for s, c in results[(q, "warm")]["shapes"].items():
            shapes[s] = shapes.get(s, 0) + c
    # the kernel against its plain version at every shape the slice gave it
    for i, (n, k, ncols, dtype) in enumerate(sorted(shapes, key=lambda s: s[:3])):
        ids, vals, valid = stage_inputs(n, k, ncols, 100 + i, "cuda", dtype=dtype)
        max_err = max(max_err, check_multi(f"slice shape n={n} k={k} C={ncols} {dtype}",
                                           vals, [valid] * ncols, ids, k))

    phase("timing")
    from ballista_tpu_torch.tools.timing import time_cuda

    # the least one launch costs in this harness: a one-element add_
    one = torch.zeros(1, device="cuda")
    floor_ms = time_cuda(lambda: one.add_(1))
    print(f"one launch of a one-element add_: {floor_ms:.4f} ms [{card}]", flush=True)
    # (a) one column at (2^21, 12, int64), the one-column kernel's shape
    ids, valid, ivals, _ = grouped_sums_inputs(1 << 21, 12, 7, "cuda")
    timed = {"one_column": time_grouped_sums(ids, [ivals], [valid], 12)}
    # (b) the largest and (c) the smallest stage of q1's warm run
    q1_shapes = results[("q1", "warm")]["shapes"]
    for label, pick in (("q1_stage", max), ("q1_final_stage", min)):
        n, k, ncols, dtype = pick(q1_shapes, key=lambda s: (s[0], s[2]))
        ids, vals, valid = stage_inputs(n, k, ncols, 8, "cuda", dtype=dtype)
        timed[label] = time_grouped_sums(ids, vals, [valid] * ncols, k)
    # (d) a stage wider than one launch takes at k = 32 (not on q1's path)
    ids, vals, valid = stage_inputs(1 << 21, 32, 16, 9, "cuda")
    timed["wide_k32"] = time_grouped_sums(ids, vals, [valid] * 16, 32)
    for label, t in timed.items():
        print(f"grouped_sums {label} n={t['n']} k={t['k']} C={t['columns']} {t['dtype']} "
              f"({t['launches']} launch(es)): kernel {t['ms']:.4f} ms (host dispatch {t['host_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, index_add_ {t['library_ms']:.4f} ms, torch sum of "
              f"the same bytes {t['read_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bytes']} bytes), {100 * t['share_of_bound']:.1f}% of bound [{card}]",
              flush=True)
    stage = timed["q1_stage"]

    kernels = [{
        "name": "grouped_sums", "route": "cuda",
        "source": "ballista_tpu_torch/csrc/grouped_sums.cu",
        "replaces": "ballista_tpu/ops/pallas_kernels.py:20",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": max_err,
        "ms": stage["ms"], "plain_ms": stage["plain_ms"], "bound_ms": stage["bound_ms"],
        "bound_by": stage["bound_by"], "library_ms": stage["library_ms"],
        "timed": timed, "floor_ms": floor_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
