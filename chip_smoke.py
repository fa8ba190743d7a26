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
4. hash    — all eight TPC-H tables at SF1 (6,001,215 lineitem rows, large
             tables in 4 parquet parts, generated from a seed by the port's
             own ``models/tpch.py``); the int64 splitmix64 and
             ``hash_bucket_dev`` on ``cuda`` bit-identical to ``kernels_np``
             (the host engine's shuffle bucketing) over SF1's orders; SF1's
             lineitem split into NATIVE_BUCKETS by ``l_orderkey`` and by
             q3's aggregate key with the host C++ partitioner
             (``native/partition.cpp``, which every shuffle write uses) and
             with its numpy version: buckets and pieces equal, both times
             printed with the host CPU's model.
5. slice   — TPC-H through ``BallistaContext.standalone()`` on ``cuda``,
             on five paths (``PATHS``): the default, fused path (q1, q6, q3,
             q5, q12, cold then warm; a final aggregate over an exchange runs
             as one fused program, its input cached on the device); q3 and
             q5 with ``broadcast_rows_threshold=0`` (their joins partition
             and fuse); q1, q3 and q5 with ``ici_shuffle=false`` after
             ``clear_caches()`` (per-partition aggregate stages); q1 with
             ``min_device_rows=32768`` (tiny stages on the host, as bench.py
             sets it); q3 with its joins partitioned and unfused under a
             device budget a quarter of its largest join's estimate (the
             memory governor must page a join: a "paged" verdict, at least
             two passes). Every other run is planned under the budget
             detected from the card, and every verdict must be "fits".
             Each run is held against an exact numpy int64
             reference computed from the parquet files (ints, strings,
             dates and decimal sums exactly equal, AVG within 1e-6
             relative) and the port's host engine, ``backend="numpy"``
             (floats within 1e-6 relative: it sums decimals in f64), and to
             the JAX engine's fused counts and declines (``FUSED``), the
             device stages ``tests/test_torch_fused.py`` establishes, zero
             host fallbacks, and one grouped_sums launch per aggregate stage
             of at most 32 groups (launch counts zeroed just before each run
             and read just after). Warm runs of q1, q3 and q5 on the default
             path must encode nothing but the fused result and transfer
             under 1% of their cold bytes. Default warm runs, and the
             unfused runs, are profiled once more under torch.profiler
             (device time inside the join probe, sorted grouping and
             segment sums). The (n, k, columns) shapes the stages gave
             grouped_sums are recorded and the kernel checked at each.
             Each run prints the budget, the largest stage estimate, the
             largest stage peak measured and every stage's pair.
6. windows — the four ``WINDOW_QUERIES`` (rankings, running sums, ROWS and
             RANGE frames, a window over an aggregate), cold then warm,
             against the host engine (ints and strings exactly, floats
             within 1e-9 relative) and, for the decimal sums and averages,
             an exact int64 reference (``window_exact``); zero host
             fallbacks; warm runs profiled (device time inside the window
             functions, their sorts, segmented scans and frames).
7. staged  — the shuffle data plane and device streaming at SF1, the way
             an executor runs a job: ``run_staged`` splits the plan with the
             port's ``plan_query_stages``, runs every task as
             ``execute_partition_stream`` of a fresh torch engine on ``cuda``
             into ``write_shuffle_stream`` (Arrow IPC pieces under
             ``.chip_smoke_data/staged``) and resolves the next stage's
             readers with ``remove_unresolved_shuffles``. q1, q3, q5 and q12
             cold then warm, held to the exact reference and the host engine
             as in the slice; S1 (``S1_SQL``: ~1.5 M groups, a streamed final
             aggregate) at default settings and in small chunks under a state
             budget it outgrows (``op.AggSpill.rows`` > 0), held to an exact
             int64 reference; S2 (``s2_stage``: a streamed probe join of
             lineitem's shuffle against a collected build, at least two
             device chunks a partition) with ``prefetch_depth`` 2 and 0, rows
             exact, every chunk copied ahead at depth 2 and the build
             transferred once a partition; q3 with every piece fetched from
             a Flight server in another process (spill directory empty
             afterwards); q3 through the standalone exchange spilling past
             ``ballista.exchange.spill_rows``. Zero host fallbacks and failed
             pre-encodes, one grouped_sums launch per aggregate or merge
             stage of at most 32 groups. On every path of the script, each
             stage of at least 1 MB must measure no more than its eager
             estimate (``memory_model.estimate_eager_program_bytes``). A warm
             staged q1 and S2 at both depths are profiled (busy share).
8. distributed — TPC-H through the port's scheduler, executors and remote
             client, the way Ballista is deployed. (1) The scheduler and
             two torch executors on ``cuda`` in this process
             (``start_standalone_cluster``: 2 task slots each, pull mode,
             one CUDA context, one set of leaf caches and one launch count
             between them), q1, q3, q5 and q12 cold (after
             ``clear_caches()``) then warm through
             ``BallistaContext.remote``: rows held to the exact reference and
             the host engine as in the slice; zero host fallbacks in every
             stage's metrics; ``op.DeviceExecute.count`` above 0 in every
             stage that ran with an aggregate or a join above a shuffle read
             (a warm run may adopt stages from the scheduler's exchange
             cache: they run no task); grouped_sums launches (zeroed just
             before each run, read just after) equal to the grouped_sums
             calls the job graph's tasks report (``op.GroupedSums.calls``,
             one per aggregate or merge of at most 32 groups); the
             scheduler's admission budget equal to what the executors'
             engines detect on the card. (2) ``python -m
             ballista_tpu_torch.executor --backend torch`` started twice as
             OS processes against a scheduler in this process: q3 and q5
             once each, rows exact, device stages as above, then SIGTERM:
             both exit 0 and their work dirs are gone. Every run prints its
             wall, stages, tasks and shuffle bytes. Precompile hints are on
             (the default): after (1)'s runs the compile service's hint work
             must drain with warm runs made (``hint_submitted`` and
             ``hint_compiled`` above 0) and none failed, its stats printed;
             (2) prints each first query's ``op.CompileHidden.time_s`` and
             ``compile_cache.*`` sums (timing-dependent: printed, not held).
             (1) also serves the
             flightsql phase (``run_flightsql_phase``): the port's Flight
             SQL service over the same scheduler, the eight tables
             registered through its ``register_parquet`` action, q1, q3 and
             q5 as ``CommandStatementQuery`` cold (leaf caches and exchange
             cache cleared) then warm, fetched from the executors'
             endpoints: rows exact, zero host fallbacks, the scheduler's
             ``do_get`` serving none of them, launches equal to the graph's
             calls (above 0 for cold q1); a prepared q1 executed twice and
             closed (its plan-cache pin 1, then 0); a second service with
             ``ballista.serving.result_cache=true`` whose repeated q1
             submits no job and returns the same rows.
9. surfaces — inspecting and operating a job (``run_surfaces_phase``):
             (a) standalone EXPLAIN ANALYZE of q1, q3 and q5 on ``cuda``,
             cold (after ``clear_caches()``) and warm, beside plain warm
             runs in turns: the rendered plan carries the CompiledStage and
             DeviceExecute rollups (a measured stage peak on the card), one
             DeviceExecute span per ``op.DeviceExecute.count`` summing to
             ``op.DeviceExecute.time_s`` within 1 ms a span, zero host
             fallbacks, warm grouped_sums launches equal to the plain run's,
             the plain rows exact; (b) EXPLAIN ANALYZE of q3 on the paged
             path: PagedJoin spans whose passes sum to
             ``op.PagedJoin.passes`` (>= 2), then its rows exact; (c) EXPLAIN
             VERIFY of q1-q22 under the detected budget: no error, no PV007
             (every governor verdict fits); (d) a scheduler with its REST API
             (``start_api_server``) and two torch executors on ``cuda``: q3
             exact through ``BallistaContext.remote``, every GET route
             answers, ``/api/executors`` lists both with the card's name,
             ``/api/dot`` is a digraph, ``/api/trace`` holds client,
             scheduler and executor events and one DeviceExecute event per
             device stage the job graph counts, ``/api/metrics`` has
             ``scale_`` and ``trace_store_`` lines, ``/ui`` is HTML, and
             EXPLAIN ANALYZE over the remote context renders the executors'
             spans; (e) on a fresh cluster, one task of q3's first stage
             slowed by a session fault (``DRAIN_FAULT``) and its executor
             drained by ``PATCH /api/scale/drain/{id}``: q3 exact, the
             executor ``terminating`` and then removed, one drain started
             and completed in ``/api/metrics``, q5 exact on the survivor
             alone with no host fallback; (f) ``python -m
             ballista_tpu_torch.client.cli`` in a subprocess on ``cuda``
             runs q6 from a ``-f`` script, rows exact. It prints every wall,
             the span totals, the drain's time and its own seconds.
10. mesh   — the device mesh (``run_mesh_phase``) on MESH_SHARDS shards of
             the card (``parallel.force_mesh_shards``): (1) the q1 flagship,
             ``q1_local_step`` at 2^23 rows against numpy f64 (counts exact,
             sums within 1e-9 relative) and ``q1_distributed_step`` over the
             mesh equal to it, then what the shard runner costs on 1 and
             MESH_SHARDS shards (``mesh_costs``: thread start, a collective
             round, the flagship's steps); (2) q1, q3, q5 and q12 standalone
             on the mesh,
             cold then warm, rows held as in the slice, the fused counts and
             declines of the one-device path, zero host fallbacks, one
             grouped_sums launch per shard's aggregate (q1: 8, launched from
             the shard threads and counted), each printed beside the slice's
             one-device wall; (3) a scheduler with one torch executor on the
             mesh: MESH_AGG_SQL, MESH_JOIN_SQL and q5 (joins partitioned)
             promoted, in fewer stages than on the Flight tier
             (``ballista.shuffle.ici=false``), with ``op.IciExchange.count``
             in their stage metrics and the Flight tier's rows; MESH_JOIN_SQL
             as one megastage (one fused program in the job's trace); and
             MESH_AGG_SQL under ``ICI_FAULT``, demoted: one stage more, no
             collective, exact rows. Every mesh program of at least 1 MB must
             measure no more than its eager estimate (its DeviceExecute
             span's ``hbm_est_bytes`` and ``hbm_peak_bytes``).
11. multihost — a mesh group (``run_multihost_phase``): a push-mode
             scheduler in this process and MH_MEMBERS ``python -m
             ballista_tpu_torch.executor --mesh-group-*`` processes of
             MH_SHARDS shards each, all on the card, one complete group g0
             of 4 global shards (the layout of tests/test_multihost.py). Each
             member's per-shard budget (as it logs it at join) must be a
             quarter of the card's 0.85 and each must register 4 shards on
             its card; the transport (gloo through pinned host memory: the
             members share the card) is printed with its reason. q1 (cold,
             warm), MESH_AGG_SQL and MESH_JOIN_SQL (joins partitioned) with
             every exchange inline (``MH_GANG``): rows exact against an int64
             reference (``mesh_exact``; q1's rounded sum within the rounding
             the one-process q1 runs made), one gang stage at attempt 0, each
             member logging each of its fused aggregates and joins once, zero
             host fallbacks, grouped_sums launches (the members' task metrics)
             equal to 2 per shard per fused aggregate, and the calls by shape
             they report (the kernel is checked at those shapes with the
             rest), every program of >= 1 MB within its eager estimate; q5
             (cold, warm; joins partitioned): at SF1 its aggregate and 5 joins
             gang; q12 (joins partitioned), whose build side repeats its keys:
             both members raise GANG_UNFUSABLE and the stage runs again
             un-ganged, rows exact. Then member 1 fails its gang task once
             (``task.execute:fail_n``): the stage restarts whole, rows exact,
             and member 0 stops waiting after the session's MH_TIMEOUT_MS.
             Every run prints its wall beside the distributed phase's, and the
             cross-process rounds, bytes and seconds the members logged.
12. avro   — the first AVRO_ROWS lineitem rows with q1's and q6's columns
             written by the port's ``write_avro`` and registered with
             ``register_avro`` in a standalone context on ``cuda``: q1 and
             q6 exact against an int64 reference over the same rows and the
             host engine, equal to the same rows through ``register_arrow``,
             zero host fallbacks, q1 launching grouped_sums; the write and
             decode rates (host code, printed with the CPU's model).
13. ha     — schedulers A and B on the ``kv`` backend sharing one sqlite
             file (job leases of HA_LEASE_S), two torch executors on
             ``cuda`` with 1 task slot each naming both: SF1 q1 submitted
             to A, A stopped once a task has started, B adopts the job and
             finishes it; rows exact, zero host fallbacks, grouped_sums
             launches equal to the calls the task statuses both schedulers
             received report; the seconds from A's stop to B's adoption and
             to the job's end. Then q3 through a scheduler on the ``etcd``
             backend against an in-process ``KvServer``: rows exact, the job
             persisted there.
14. timing — grouped_sums at one column (2^21 rows, k = 12, int64), at
             the largest and smallest stages of q1's warm run (the fused
             program's partial aggregate and final merge), at the largest
             stage of its unfused run, and at a
             stage of 16 int64 columns at k = 32, which the wrapper splits
             into launches (L2 flushed before every call, CUDA events,
             device time only), beside
             its plain version, one PyTorch library call computing the same
             function, a torch sum over the same bytes, the least time the
             card could take (bytes over 3.35 TB/s), and the time of one
             one-element add_ (the least any launch takes here).

It prints, per run, the wall, fused counts, cache hits and peak device
memory, then the kernels line and the nvidia-smi line before its last line,
and ends with one JSON object naming the device. It imports nothing of JAX and
nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(REPO, ".chip_smoke_data")
SF = 1.0
PARTS = 4  # parquet files per large table
QUERIES = ("q1", "q6", "q3", "q5", "q12")
# the queries whose aggregates group into at most MASKED_SEG_K slots, so
# grouped_sums must launch (q3 groups by order on the sorted path, k large)
LAUNCHING = ("q1", "q6", "q5", "q12")
# the paths the slice drives, in order: (name, session settings, queries,
# runs). The tiny path's fused input is cached by the default path's runs;
# the unfused path starts from clear_caches()
PATHS = (
    ("default", {}, QUERIES, ("cold", "warm")),
    ("threshold0", {"ballista.optimizer.broadcast_rows_threshold": "0"}, ("q3", "q5"),
     ("cold", "warm")),
    ("tiny", {"ballista.tpu.min_device_rows": "32768"}, ("q1",), ("once",)),
    ("unfused", {"ballista.tpu.ici_shuffle": "false"}, ("q1", "q3", "q5"), ("cold",)),
    # q3's joins partitioned and unfused, under a device budget (set by
    # paged_budget) below what its largest join needs at 16 partitions: the
    # memory governor pages it
    ("paged", {"ballista.optimizer.broadcast_rows_threshold": "0",
               "ballista.tpu.ici_shuffle": "false",
               "ballista.engine.max_shuffle_partitions": "16"}, ("q3",), ("once",)),
)
BUDGET_KEY = "ballista.engine.hbm_budget_bytes"
# the windows path (default settings, cold then warm): each query held
# against the host engine. W1 keeps the top line of every order; W2 ranks
# and sums orders per customer; W3 runs moving ROWS frames and a RANGE frame
# over a decimal key; W4 ranks an aggregate on one partition
WINDOW_QUERIES = {
    "W1": "select count(*) as n, sum(l_extendedprice) as top from (select l_extendedprice, "
          "row_number() over (partition by l_orderkey order by l_extendedprice desc, "
          "l_linenumber) as rn from lineitem) t where rn = 1",
    "W2": "select o_orderkey, rank() over (partition by o_custkey order by o_totalprice desc) "
          "as rk, dense_rank() over (partition by o_custkey order by o_orderpriority) as dr, "
          "sum(o_totalprice) over (partition by o_custkey order by o_orderdate) as run "
          "from orders",
    "W3": "select l_orderkey, l_linenumber, sum(l_quantity) over (partition by l_suppkey "
          "order by l_shipdate, l_orderkey, l_linenumber rows between 6 preceding and "
          "current row) as qty7, max(l_extendedprice) over (partition by l_suppkey "
          "order by l_shipdate, l_orderkey, l_linenumber rows between 10 preceding and "
          "10 following) as max21, avg(l_discount) over (partition by l_suppkey order by "
          "l_extendedprice range between 100 preceding and 100 following) as disc "
          "from lineitem where l_shipdate < date '1993-01-01'",
    "W4": "select l_suppkey, sum(l_extendedprice * (1 - l_discount)) as rev, rank() over "
          "(order by sum(l_extendedprice * (1 - l_discount)) desc) as rk from lineitem "
          "group by l_suppkey order by rk limit 100",
}
# the window queries whose aggregate groups into at most MASKED_SEG_K slots
WINDOW_LAUNCHING = ("W1",)
# averages of decimals: the engine rounds them to 8 decimals (avg_scaled at
# the largest sniffed scale, as the JAX engine does), so they are held to
# half a unit of the 8th decimal of the exact average
WINDOW_AVERAGES = {"W3": ("disc",)}
FUSED_KEYS = ("op.FusedIciExchange.count", "op.FusedIciJoin.count", "op.FusedDeclined.count")
# (path, query) -> FUSED_KEYS: the JAX engine's fused aggregates (one count
# per output partition served, 16), fused joins and fused attempts that
# returned None on the same plans, as tests/test_torch_fused.py holds them on
# the CPU
FUSED = {
    ("default", "q1"): (16, 0, 0), ("default", "q6"): (0, 0, 0),
    ("default", "q3"): (16, 0, 0), ("default", "q5"): (16, 0, 0),
    ("threshold0", "q3"): (16, 32, 0),
    ("unfused", "q1"): (0, 0, 0), ("unfused", "q3"): (0, 0, 0), ("unfused", "q5"): (0, 0, 0),
    ("tiny", "q1"): (16, 0, 0), ("paged", "q3"): (0, 0, 0),
}
# counts that depend on the scale factor, through the planner's row
# estimates. q12's join is collected at SF 0.01 but partitioned at SF1, its
# build the filtered lineitem, whose order keys repeat: both engines decline
# it. At SF 0.01 the planner joins q5's customer with supplier on their
# nation key, so two builds repeat keys and are declined (the CPU test); at
# SF1 every q5 build is keyed on a primary key and all five joins fuse
FUSED_BY_SF = {
    ("default", "q12"): {0.01: (16, 0, 0), 1.0: (16, 0, 1)},
    ("threshold0", "q5"): {0.01: (16, 64, 2), 1.0: (16, 80, 0)},
}
# the default path's queries whose fused input has a content key (no
# exchange below it): their warm runs read it from the device cache
CACHED = ("q1", "q3", "q5")
SHUFFLE_PARTITIONS = 16
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


# ---- 4-5. data, hashing and the slice ----------------------------------------------
def tpch_tables(data_dir: str, sf: float, parts: int) -> dict:
    """All eight TPC-H tables at ``sf`` from the port's generator (seed 42),
    large tables in ``parts`` files; {table: directory}."""
    from ballista_tpu_torch.models.tpch import generate_tpch

    root = os.path.join(data_dir, f"tpch_sf{sf:g}_p{parts}")
    t0 = time.time()
    out = generate_tpch(root, sf=sf, parts_per_table=parts)
    print(f"tpch sf={sf:g}: {sorted(out)} under {root} ({time.time() - t0:.1f} s)", flush=True)
    return out


def _day(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def _hundredths(v: np.ndarray) -> np.ndarray:
    """Exact int64 hundredths of a 2-decimal f64 column."""
    c = np.round(v * 100).astype(np.int64)
    if not np.array_equal(c / 100.0, v):
        raise AssertionError("column is not an exact 2-decimal column")
    return c


def _read(tables: dict, name: str, cols: list) -> dict:
    """Columns of one table as numpy arrays (dates as int32 days, strings
    as objects)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    t = pq.read_table(tables[name], columns=cols)
    out = {}
    for c in cols:
        col = t.column(c)
        if pa.types.is_date32(col.type):
            col = col.cast(pa.int32())
        out[c] = col.to_numpy(zero_copy_only=False)
    return out


def _index(keys: np.ndarray, values: np.ndarray, fill) -> np.ndarray:
    """A dense lookup array: out[key] = value, ``fill`` elsewhere."""
    out = np.full(int(keys.max()) + 1 if len(keys) else 1, fill, dtype=values.dtype)
    out[keys] = values
    return out


def _lookup(index: np.ndarray, keys: np.ndarray, fill) -> np.ndarray:
    """index[keys], ``fill`` for keys past its end."""
    inside = keys < len(index)
    return np.where(inside, index[np.where(inside, keys, 0)], fill)


def exact_q1_q6(li: dict) -> tuple:
    """q1 and q6 computed exactly (as ``exact_reference`` computes them)
    over lineitem's columns ``li`` (``_read``'s form): (q1, q6)."""
    days = li["l_shipdate"]
    qty, price, disc, tax = (_hundredths(li[c]) for c in
                             ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    rev = price * (100 - disc)

    keep = days <= _day("1998-09-02")  # date '1998-12-01' - interval '90' day
    q1: dict = {}
    for f, s in sorted(set(zip(rf[keep], ls[keep]))):
        m = keep & (rf == f) & (ls == s)
        n = int(m.sum())
        sq, sp, sd = int(qty[m].sum()), int(price[m].sum()), int(disc[m].sum())
        row = {
            "l_returnflag": f, "l_linestatus": s,
            "sum_qty": sq / 100, "sum_base_price": sp / 100,
            "sum_disc_price": int(rev[m].sum()) / 10**4,
            "sum_charge": int((rev[m] * (100 + tax[m])).sum()) / 10**6,
            "avg_qty": sq / (100 * n), "avg_price": sp / (100 * n), "avg_disc": sd / (100 * n),
            "count_order": n,
        }
        for k, v in row.items():
            q1.setdefault(k, []).append(v)
    m = ((days >= _day("1994-01-01")) & (days < _day("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    q6 = {"revenue": [int((price[m] * disc[m]).sum()) / 10**4]}
    return q1, q6


def exact_reference(tables: dict) -> dict:
    """q1, q6, q3, q5 and q12 computed exactly, independently of the port: numpy
    int64 sums of hundredths (revenue: price * (100 - discount), in units of
    10^-4) over the parquet files, joins as dense key lookups (every join
    key of q3 and q5 is a primary key on one side), converted to the
    nearest double once at the end (Python's int / int rounds correctly).
    Returns {query: {column: list of values in ORDER BY order}}."""
    li = _read(tables, "lineitem", [
        "l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate", "l_receiptdate",
        "l_shipmode"])
    q1, q6 = exact_q1_q6(li)
    days = li["l_shipdate"]
    price, disc = _hundredths(li["l_extendedprice"]), _hundredths(li["l_discount"])
    rev = price * (100 - disc)

    cu = _read(tables, "customer", ["c_custkey", "c_mktsegment", "c_nationkey"])
    od = _read(tables, "orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"])

    # q3: BUILDING customers' orders before 1995-03-15, their lines shipped
    # after it; revenue by order, top 10 by revenue desc, o_orderdate
    building = _index(cu["c_custkey"], cu["c_mktsegment"] == "BUILDING", False)
    ok = (od["o_orderdate"] < _day("1995-03-15")) & building[od["o_custkey"]]
    okeys = od["o_orderkey"][ok]
    at = _lookup(_index(okeys, np.arange(len(okeys)), -1), li["l_orderkey"], -1)
    lk = (days > _day("1995-03-15")) & (at >= 0)
    sums = np.zeros(len(okeys), np.int64)
    np.add.at(sums, at[lk], rev[lk])
    seen = np.zeros(len(okeys), bool)
    seen[at[lk]] = True
    cand = np.nonzero(seen)[0]
    odate = od["o_orderdate"][ok]
    top = cand[np.lexsort((odate[cand], -sums[cand]))][:10]
    q3 = {
        "l_orderkey": okeys[top].tolist(),
        "revenue": [int(v) / 10**4 for v in sums[top]],
        "o_orderdate": list(odate[top].astype("datetime64[D]")),
        "o_shippriority": od["o_shippriority"][ok][top].tolist(),
    }

    # q5: lines of 1994 orders whose customer and supplier share a nation in
    # ASIA; revenue by nation, desc
    na = _read(tables, "nation", ["n_nationkey", "n_name", "n_regionkey"])
    rg = _read(tables, "region", ["r_regionkey", "r_name"])
    su = _read(tables, "supplier", ["s_suppkey", "s_nationkey"])
    asia = np.isin(na["n_regionkey"], rg["r_regionkey"][rg["r_name"] == "ASIA"])
    in_asia = _index(na["n_nationkey"], asia, False)
    oy = (od["o_orderdate"] >= _day("1994-01-01")) & (od["o_orderdate"] < _day("1995-01-01"))
    cust_of = _index(od["o_orderkey"][oy], od["o_custkey"][oy], -1)
    c_nat = _index(cu["c_custkey"], cu["c_nationkey"], -1)
    s_nat = _index(su["s_suppkey"], su["s_nationkey"], -1)
    oc = _lookup(cust_of, li["l_orderkey"], -1)
    sn = s_nat[li["l_suppkey"]]
    lk = (oc >= 0) & (c_nat[np.maximum(oc, 0)] == sn) & in_asia[sn]
    by_nation = np.zeros(len(in_asia), np.int64)
    np.add.at(by_nation, sn[lk], rev[lk])
    present = np.unique(sn[lk])
    names = _index(na["n_nationkey"], na["n_name"].astype(object), None)
    order = present[np.argsort(-by_nation[present], kind="stable")]
    q5 = {"n_name": [names[k] for k in order],
          "revenue": [int(by_nation[k]) / 10**4 for k in order]}

    # q12: lines by MAIL or SHIP received in 1994, committed before received
    # and shipped before committed; per ship mode, the lines of urgent or
    # high-priority orders and of the others
    od12 = _read(tables, "orders", ["o_orderkey", "o_orderpriority"])
    pri = _index(od12["o_orderkey"], od12["o_orderpriority"].astype(object), None)
    recv, commit = li["l_receiptdate"], li["l_commitdate"]
    m = (np.isin(li["l_shipmode"], ["MAIL", "SHIP"]) & (commit < recv) & (days < commit)
         & (recv >= _day("1994-01-01")) & (recv < _day("1995-01-01")))
    high = np.isin(pri[li["l_orderkey"][m]], ["1-URGENT", "2-HIGH"])
    modes = li["l_shipmode"][m]
    q12: dict = {"l_shipmode": [], "high_line_count": [], "low_line_count": []}
    for mode in sorted(set(modes)):
        sel = modes == mode
        q12["l_shipmode"].append(mode)
        q12["high_line_count"].append(int((high & sel).sum()))
        q12["low_line_count"].append(int((~high & sel).sum()))
    return {"q1": q1, "q6": q6, "q3": q3, "q5": q5, "q12": q12}


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


def check_hash_buckets(device, tables: dict) -> None:
    """The int64 splitmix64 on the edge values and 2^21 random ones, and
    ``hash_bucket_dev`` over SF1's orders (1.5 M rows: int keys, a date, a
    string, a decimal) at 3, 16 and 1000 buckets: bit-identical to
    ``kernels_np`` (the host engine's shuffle bucketing)."""
    import pyarrow.parquet as pq

    from ballista_tpu_torch.ops import kernels_np as KNP
    from ballista_tpu_torch.ops import kernels_torch as KT
    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan.expr import Col

    i64 = np.iinfo(np.int64)
    x = np.concatenate([np.array([0, -1, i64.min, i64.max, 1, i64.min + 1], np.int64),
                        np.random.default_rng(13).integers(i64.min, i64.max, 1 << 21,
                                                           dtype=np.int64, endpoint=True)])
    got = KT.splitmix64_dev(torch.from_numpy(x).to(device)).cpu().numpy()
    if not np.array_equal(got, KNP.splitmix64(x.view(np.uint64)).view(np.int64)):
        raise AssertionError("splitmix64 on the device differs from kernels_np")
    batch = ColumnBatch.from_arrow(pq.read_table(tables["orders"], columns=[
        "o_orderkey", "o_custkey", "o_orderdate", "o_orderpriority", "o_totalprice"]))
    db = KT.to_device(batch, device)
    keysets = (["o_orderkey"], ["o_custkey", "o_orderdate"], ["o_orderpriority"],
               ["o_totalprice"], ["o_orderkey", "o_orderpriority", "o_totalprice"])
    for keys in keysets:
        for n in (3, 16, 1000):
            got = KT.hash_bucket_dev(db, [db.col(k) for k in keys], n).cpu().numpy()
            want = KNP.hash_partition_indices(batch, [Col(k) for k in keys], n)
            if not np.array_equal(got[: batch.num_rows], want):
                raise AssertionError(f"hash_bucket_dev {keys} n={n} differs from the host's")
    print(f"hash: splitmix64 on {len(x)} values and hash_bucket_dev on {batch.num_rows} "
          f"orders rows ({len(keysets)} key sets x 3 bucket counts) bit-identical to "
          "kernels_np", flush=True)


NATIVE_BUCKETS = 16


def cpu_model() -> str:
    """The host CPU's model (``/proc/cpuinfo``), its architecture and its
    count: the partitioner and the avro codec are host code, so their times
    belong to this CPU, not to the card."""
    import platform

    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                fields.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    name = next((fields[k] for k in ("model name", "cpu model", "hardware", "cpu part")
                 if fields.get(k)), "model not in /proc/cpuinfo")
    return f"{name} ({platform.machine()}), {os.cpu_count()} CPUs"


def check_native_partition(tables: dict, tag: str) -> None:
    """SF1's lineitem bucketed into NATIVE_BUCKETS by ``l_orderkey`` (the
    join exchange of q3 and q12) and by q3's aggregate key (``l_orderkey,
    o_orderdate, o_shippriority``, over lineitem joined to its orders) with
    the host C++ partitioner (``kernels_np.hash_partition_indices`` and
    ``hash_partition``, ``native/partition.cpp``) and with their numpy
    versions: buckets and pieces equal. Prints both times with the card line
    and the host CPU's model."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ballista_tpu_torch import native
    from ballista_tpu_torch.ops import kernels_np as KNP
    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan.expr import Col

    print(f"hash: host partitioner {native.library_path()}", flush=True)
    li = pq.read_table(tables["lineitem"], columns=["l_orderkey", "l_extendedprice",
                                                    "l_shipdate"])
    od = _read(tables, "orders", ["o_orderkey", "o_orderdate", "o_shippriority"])
    okeys = li.column("l_orderkey").to_numpy()
    date = _index(od["o_orderkey"], od["o_orderdate"], -1)[okeys]
    prio = _index(od["o_orderkey"], od["o_shippriority"].astype(np.int64), -1)[okeys]
    if (date < 0).any():
        raise AssertionError("hash: a lineitem row without its order")
    batch = ColumnBatch.from_arrow(li.append_column("o_orderdate", pa.array(
        date.astype(np.int32), pa.date32())).append_column("o_shippriority", pa.array(prio)))
    for keys in (("l_orderkey",), ("l_orderkey", "o_orderdate", "o_shippriority")):
        exprs = [Col(k) for k in keys]
        times = {}
        for label, fn in (("native buckets", KNP.hash_partition_indices),
                          ("plain buckets", KNP.hash_partition_indices_plain),
                          ("native pieces", KNP.hash_partition),
                          ("plain pieces", KNP.hash_partition_plain)):
            t0 = time.perf_counter()
            times[label] = (fn(batch, exprs, NATIVE_BUCKETS), time.perf_counter() - t0)
        if not np.array_equal(times["native buckets"][0], times["plain buckets"][0]):
            raise AssertionError(f"hash: native buckets by {keys} differ from the plain ones")
        got, want = times["native pieces"][0], times["plain pieces"][0]
        if len(got) != NATIVE_BUCKETS or any(
                not g.to_arrow().equals(w.to_arrow()) for g, w in zip(got, want)):
            raise AssertionError(f"hash: native pieces by {keys} differ from the plain ones")
        print(f"hash: lineitem {batch.num_rows} rows by ({', '.join(keys)}) into "
              f"{NATIVE_BUCKETS} buckets, equal to the plain version: "
              + ", ".join(f"{label} {t:.3f} s" for label, (_, t) in times.items())
              + f" [{tag}] host CPU: {cpu_model()}", flush=True)


@contextlib.contextmanager
def counting():
    """Records what the device path does inside the block: grouped_sums'
    launches (the count set to 0 on entry, read on exit), the shapes (n, k,
    columns, dtype) grouped_sums was given, each presum_safe call's (scale
    in, scale out), the aggregate stages whose group count k is in (0,
    MASKED_SEG_K] (the ones that launch it), the schema of every batch
    encoded for the device, and each device stage's (estimate equal to the
    JAX engine's, eager estimate, measured peak) in ``stage_bytes``. Warm
    runs of the compile service (``grouped_sums.is_warming()`` on their
    thread) are kept out of every record: they count their launches apart."""
    import ballista_tpu_torch.engine.memory_model as MM
    import ballista_tpu_torch.ops.grouped_sums as GS
    import ballista_tpu_torch.ops.kernels_torch as KT

    rec: dict = {"shapes": {}, "presums": [], "encoded": [], "small_k_stages": 0,
                 "stage_bytes": []}
    real_gs, real_ps, real_compute = GS.grouped_sums_multi, KT.presum_safe, KT.SegSums.compute
    real_enc = KT.encode_host_batch
    real_est, real_eager = MM.estimate_program_bytes, MM.estimate_eager_program_bytes
    real_meas = MM.measured_program_bytes
    ests, eagers = [0], [0]

    def gs(vals, masks, ids, k):
        if not GS.is_warming():
            dtype = next((v.dtype for v in vals if v is not None), torch.int64)
            key = (int(ids.shape[0]), int(k), len(vals), dtype)
            rec["shapes"][key] = rec["shapes"].get(key, 0) + 1
        return real_gs(vals, masks, ids, k)

    def ps(c, n_pad):
        out = real_ps(c, n_pad)
        if not GS.is_warming():
            rec["presums"].append((c.scale, out.scale))
        return out

    def compute(sums):
        if not GS.is_warming():
            rec["small_k_stages"] += 0 < sums.k <= KT.MASKED_SEG_K
        return real_compute(sums)

    def enc(batch, pad=None):
        if not GS.is_warming():
            rec["encoded"].append(tuple(batch.schema.names))
        return real_enc(batch, pad)

    def est(plan, leaves):
        if GS.is_warming():
            return real_est(plan, leaves)
        ests.append(real_est(plan, leaves))
        return ests[-1]

    def eager(plan, leaves):
        if GS.is_warming():
            return real_eager(plan, leaves)
        eagers.append(real_eager(plan, leaves))
        return eagers[-1]

    def meas(device, base_bytes, resident_bytes=0):
        rec["stage_bytes"].append(
            (ests[-1], eagers[-1], real_meas(device, base_bytes, resident_bytes)))
        return rec["stage_bytes"][-1][2]

    GS.grouped_sums_multi, KT.presum_safe, KT.SegSums.compute = gs, ps, compute
    KT.encode_host_batch = enc
    MM.estimate_program_bytes, MM.estimate_eager_program_bytes = est, eager
    MM.measured_program_bytes = meas
    GS.launches = 0
    try:
        yield rec
    finally:
        rec["launches"] = GS.launches
        GS.grouped_sums_multi, KT.presum_safe, KT.SegSums.compute = real_gs, real_ps, real_compute
        KT.encode_host_batch = real_enc
        MM.estimate_program_bytes, MM.estimate_eager_program_bytes = real_est, real_eager
        MM.measured_program_bytes = real_meas


def run_counted(ctx, sql: str) -> dict:
    """One collect inside ``counting()``, with the leaf caches' hits and
    misses, the memory governor's report, and on the card the peak of device
    memory allocated during the run and what was allocated before. The
    engine resets the allocator's peak at each device stage to measure the
    stage (``op.HbmPeak.max_bytes``), so the run's peak is the engine's
    ``op.DevicePeak.max_bytes``, which folds in the allocator's peak before
    every reset (cached inputs of earlier runs included)."""
    import ballista_tpu_torch.engine.torch_engine as TE

    caches = (TE._ENC_CACHE, TE._DEV_CACHE)
    before = [(c.hits, c.misses) for c in caches]
    on_card = torch.cuda.is_available() and ctx.device.startswith("cuda")
    with counting() as rec:
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.time()
        got = ctx.sql(sql).collect()
        wall = time.time() - t0
        peak = ctx.last_engine_metrics.get("op.DevicePeak.max_bytes", 0.0) if on_card else 0
    hits = {name: (c.hits - h, c.misses - m)
            for name, c, (h, m) in zip(("encode", "device"), caches, before)}
    return dict(rec, table=got, wall=wall, cache=hits, peak_bytes=peak, base_bytes=base,
                metrics=dict(ctx.last_engine_metrics), report=ctx.last_memory_report)


def _physical(ctx, sql: str):
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    logical = SqlPlanner(ctx.catalog.schemas()).plan(parse_sql(sql))
    return PhysicalPlanner(ctx.catalog, ctx.config).plan(optimize(logical, ctx.catalog))


def expected_fused(path: str, q: str, sf: float) -> tuple:
    by_sf = FUSED_BY_SF.get((path, q))
    return by_sf[sf] if by_sf else FUSED[(path, q)]


def expected_stages(path: str, q: str, run: str, parts: int):
    """The device stages (``op.DeviceExecute.count``) of a run, where
    tests/test_torch_fused.py establishes them: one fused program and the 16
    stages above it, plus one stage per input file when the fused input is
    built; q6 (a global aggregate, never fused) a partial stage per file and
    one final; unfused q1 a partial stage per file and 16 final; the tiny
    path only the fused program. None: at least one."""
    if q == "q6":
        return parts + 1
    if path == "default" and q in CACHED and run == "warm":
        return 1 + SHUFFLE_PARTITIONS
    if path == "default" and q == "q1":
        return parts + 1 + SHUFFLE_PARTITIONS
    if path == "unfused" and q == "q1":
        return parts + SHUFFLE_PARTITIONS
    if path == "tiny":
        return 1
    return None


def check_run(path: str, q: str, run: str, r: dict, parts: int, fused: tuple,
              cold, final_schema) -> None:
    """The run's counts against what the slice requires (see PATHS)."""
    m = r["metrics"]
    tag = f"{path} {q} {run}"
    if m.get("op.HostFallback.count", 0.0) != 0.0:
        raise AssertionError(f"{tag}: {m['op.HostFallback.count']:g} host fallbacks")
    got = tuple(int(m.get(k, 0.0)) for k in FUSED_KEYS)
    if got != fused:
        raise AssertionError(f"{tag}: fused/joins/declined {got}, the JAX engine's {fused}")
    stages = expected_stages(path, q, run, parts)
    n = m.get("op.DeviceExecute.count", 0.0)
    if (stages is not None and n != stages) or n < 1:
        raise AssertionError(f"{tag}: {n:g} device stages, want {stages}")
    # one launch per aggregate stage of at most MASKED_SEG_K groups
    if r["launches"] != r["small_k_stages"]:
        raise AssertionError(f"{tag}: {r['launches']} grouped_sums launches in "
                             f"{r['small_k_stages']} aggregate stages of k <= 32")
    if q in LAUNCHING and r["launches"] <= 0:
        raise AssertionError(f"{tag}: grouped_sums never launched")
    if path == "tiny" and m.get("op.HostTinyStage.count", 0.0) != SHUFFLE_PARTITIONS:
        raise AssertionError(f"{tag}: {m.get('op.HostTinyStage.count', 0.0):g} tiny stages")
    if path == "paged":
        actions = [d.action for d in r["report"].decisions]
        if "paged" not in actions:
            raise AssertionError(f"{tag}: governor verdicts {actions}, no paged join")
        if not (m.get("op.PagedJoin.count", 0.0) >= 1 and m.get("op.PagedJoin.passes", 0.0) >= 2):
            raise AssertionError(f"{tag}: paged joins {m.get('op.PagedJoin.count', 0.0):g}, "
                                 f"passes {m.get('op.PagedJoin.passes', 0.0):g}")
    elif r["report"] is not None and [d for d in r["report"].decisions if d.action != "fits"]:
        # the auto-detected budget (or none) leaves every other path's plan as it was
        raise AssertionError(f"{tag}: governor verdicts {r['report'].as_dict()}")
    if path == "default" and q in CACHED and run == "warm":
        # no scan output and no fused input encoded again: only the fused
        # result, once per partition of the stage above it
        if r["encoded"] != [final_schema] * SHUFFLE_PARTITIONS:
            raise AssertionError(f"{tag}: encoded {sorted(set(r['encoded']))}")
        sent, cold_sent = m["op.DeviceTransfer.bytes"], cold["metrics"]["op.DeviceTransfer.bytes"]
        if not sent < 0.01 * cold_sent:
            raise AssertionError(f"{tag}: transferred {sent:g} bytes, cold {cold_sent:g}")


def paged_budget(ctx, sql: str) -> int:
    """A quarter of the largest per-partition program of the plan's
    partitioned joins, by the port's own ``estimate_join_program`` at the
    planner's row estimates (the table statistics) over the plan's shuffle
    partitions."""
    from ballista_tpu_torch.engine.memory_model import estimate_join_program
    from ballista_tpu_torch.plan import physical as P

    ests = []
    for j in P.walk_physical(_physical(ctx, sql)):
        if isinstance(j, P.HashJoinExec) and not j.collect_build:
            n = j.left.partitioning.n
            ests.append(estimate_join_program(j.left.schema(), j.left.est_rows // n,
                                              j.right.schema(), j.right.est_rows // n, j.how))
    return max(ests) // 4


def references(tables: dict) -> tuple:
    """(the exact reference of every query in QUERIES, {query: (sql, the
    port's host engine's result)})."""
    from ballista_tpu_torch.client.context import BallistaContext

    t0 = time.time()
    exact = exact_reference(tables)
    print(f"exact reference: {time.time() - t0:.1f} s", flush=True)
    host = BallistaContext.standalone(backend="numpy")
    for name, path in tables.items():
        host.register_parquet(name, path)
    want = {}
    for q in QUERIES:
        with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        t0 = time.time()
        want[q] = (sql, host.sql(sql).collect())
        print(f"{q} host engine: {time.time() - t0:.3f} s", flush=True)
    return exact, want


def run_slice(device: str, tables: dict, sf: float, parts: int, tag: str,
              profile: bool = False, refs: tuple = None):
    """The slice's paths on the torch engine, every run held against the
    exact reference and the host engine and checked by check_run (its
    summary printed first, tagged ``tag``). Returns
    {(path, query, run): run_counted's record} and, with ``profile``,
    {(path, query): profile_run's record} for the default path's warm runs
    and the unfused runs."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import torch_engine as TE
    from ballista_tpu_torch.plan import physical as P

    exact, want = refs if refs is not None else references(tables)
    TE.clear_caches()
    out, prof = {}, {}
    for path, settings, queries, runs in PATHS:
        ctx = BallistaContext.standalone(BallistaConfig(dict(settings)), device=device)
        for name, location in tables.items():
            ctx.register_parquet(name, location)
        if path == "unfused":
            TE.clear_caches()
        for q in queries:
            sql, expect = want[q]
            if path == "paged":
                budget = paged_budget(ctx, sql)
                ctx.config.set(BUDGET_KEY, str(budget))
                print(f"paged {q}: device budget {budget} bytes, a quarter of its largest "
                      "join's estimate at 16 partitions", flush=True)
            fused = expected_fused(path, q, sf)
            plan = _physical(ctx, sql)
            finals = [n for n in P.walk_physical(plan)
                      if isinstance(n, P.HashAggregateExec) and n.mode == "final"]
            final_schema = tuple(finals[0].schema().names) if finals else None
            joins = [n._line() for n in P.walk_physical(plan) if isinstance(n, P.HashJoinExec)]
            print(f"{path} {q}: joins {joins}", flush=True)
            for run in runs:
                r = run_counted(ctx, sql)
                report_run(path, q, run, r, tag)
                check_result(r["table"], expect, exact[q], q, r["presums"])
                check_run(path, q, run, r, parts, fused, out.get((path, q, "cold")),
                          final_schema)
                out[(path, q, run)] = r
            if profile and path in ("default", "unfused"):
                prof[(path, q)] = profile_run(ctx, sql)
    return out, prof


def run_windows(device: str, tables: dict, tag: str, profile: bool = False):
    """The windows path: each of WINDOW_QUERIES through the torch engine
    with default settings, cold then warm, held against the host engine
    (check_window_result) and to zero host fallbacks, at least one device
    stage and one grouped_sums launch per aggregate stage of at most 32
    groups; W1's and W2's counts and sums equal window_exact's. Returns
    {("windows", query, run): run_counted's record} and, with ``profile``,
    {("windows", query): profile_run's record} of a warm run, with the
    device time inside the window functions, their sorts, segmented scans
    and frames."""
    import ballista_tpu_torch.ops.kernels_torch as KT
    from ballista_tpu_torch.client.context import BallistaContext

    host = BallistaContext.standalone(backend="numpy")
    ctx = BallistaContext.standalone(device=device)
    for name, location in tables.items():
        host.register_parquet(name, location)
        ctx.register_parquet(name, location)
    exact = window_exact(tables)
    owners = {"window": (KT, "_one_window_dev"), "window sort": (KT, "_lex_order"),
              "window scan": (KT, "_seg_scan"), "window frames": (KT, "_frame_aggregate_dev")}
    out, prof = {}, {}
    for q, sql in WINDOW_QUERIES.items():
        t0 = time.time()
        expect = host.sql(sql).collect()
        print(f"{q} host engine: {time.time() - t0:.3f} s, {expect.num_rows} rows", flush=True)
        for run in ("cold", "warm"):
            r = run_counted(ctx, sql)
            report_run("windows", q, run, r, tag)
            check_window_result(r["table"], expect, q, exact.get(q, {}))
            m, what = r["metrics"], f"windows {q} {run}"
            if m.get("op.HostFallback.count", 0.0) != 0.0 or m.get("op.DeviceExecute.count", 0) < 1:
                raise AssertionError(f"{what}: {m.get('op.HostFallback.count', 0.0):g} host "
                                     f"fallbacks, {m.get('op.DeviceExecute.count', 0):g} stages")
            if r["launches"] != r["small_k_stages"] or (q in WINDOW_LAUNCHING
                                                        and r["launches"] <= 0):
                raise AssertionError(f"{what}: {r['launches']} grouped_sums launches in "
                                     f"{r['small_k_stages']} aggregate stages of k <= 32")
            out[("windows", q, run)] = r
        if profile:
            prof[("windows", q)] = profile_run(ctx, sql, owners)
    return out, prof


def window_exact(tables: dict) -> dict:
    """The window queries' decimal sums and averages computed exactly,
    independently of the port: numpy int64 sums of hundredths over the
    parquet files, converted to the nearest double once at the end.
    {query: {column: values in the order of the query's non-float
    columns}}. W1: the top line of each order (the highest price; its sum
    does not depend on how ties break). W2's running sum: each customer's
    orders by date, a date's orders sharing the sum through the last of
    them. W3's average discount of the supplier's lines priced within
    100.00 of the line's price, both ends included."""
    li = _read(tables, "lineitem", ["l_orderkey", "l_extendedprice"])
    key, price = li["l_orderkey"], _hundredths(li["l_extendedprice"])
    o = np.lexsort((-price, key))
    first = np.concatenate([[True], key[o][1:] != key[o][:-1]])
    w1 = {"n": [int(first.sum())], "top": [int(price[o][first].sum()) / 100]}

    od = _read(tables, "orders", ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"])
    cust, day = od["o_custkey"], od["o_orderdate"]
    o = np.lexsort((day, cust))
    cents = np.cumsum(_hundredths(od["o_totalprice"])[o])
    idx = np.arange(len(o))
    seg = np.concatenate([[True], cust[o][1:] != cust[o][:-1]])
    peer = seg | np.concatenate([[True], day[o][1:] != day[o][:-1]])
    seg_first = np.maximum.accumulate(np.where(seg, idx, 0))
    run = cents - np.where(seg_first > 0, cents[seg_first - 1], 0)
    nxt = np.concatenate([np.where(peer, idx, len(o))[1:], [len(o)]])
    peer_last = np.minimum.accumulate(nxt[::-1])[::-1] - 1
    by_order = np.empty(len(o), np.int64)
    by_order[o] = run[peer_last]
    w2 = {"run": by_order[np.argsort(od["o_orderkey"], kind="stable")] / 100}

    li = _read(tables, "lineitem", ["l_orderkey", "l_linenumber", "l_suppkey",
                                    "l_extendedprice", "l_discount", "l_shipdate"])
    m = li["l_shipdate"] < _day("1993-01-01")
    price, disc = _hundredths(li["l_extendedprice"][m]), _hundredths(li["l_discount"][m])
    # (supplier, price) as one sorted int64: a supplier's prices lie below
    # 2^32 cents, so a window of 100.00 never reaches another supplier's
    key = li["l_suppkey"][m].astype(np.int64) * (1 << 32) + price
    o = np.argsort(key, kind="stable")
    ks = key[o]
    lo = np.searchsorted(ks, ks - 10_000, "left")
    hi = np.searchsorted(ks, ks + 10_000, "right")
    cs = np.concatenate([[0], np.cumsum(disc[o])])
    avg = np.empty(len(o))
    avg[o] = [int(s) / (100 * int(c)) for s, c in zip(cs[hi] - cs[lo], hi - lo)]
    w3 = {"disc": avg[np.lexsort((li["l_linenumber"][m], li["l_orderkey"][m]))]}
    return {"W1": w1, "W2": w2, "W3": w3}


def check_window_result(got, host, q: str, exact: dict) -> None:
    """``got`` ordered by its non-float columns (a unique key in every window
    query). Columns ``exact`` holds equal its values (WINDOW_AVERAGES within
    half a unit of the 8th decimal). Every other column equals the host
    engine's, ordered the same way: ints, strings and dates exactly, floats
    finite and within 1e-9 relative. The host engine is not held to the
    exact columns: it sums decimals in f64, takes running sums as
    differences of prefix sums and bounds RANGE frames by f64 key plus
    offset, which at SF1 drift past 1e-9 or move a frame's edge row."""
    import pyarrow as pa

    if got.schema.names != host.schema.names or got.num_rows != host.num_rows \
            or got.num_rows == 0:
        raise AssertionError(f"{q}: {got.schema.names} x {got.num_rows}, host "
                             f"{host.schema.names} x {host.num_rows}")
    keys = [(f.name, "ascending") for f in got.schema if not pa.types.is_floating(f.type)]
    if keys:
        got, host = got.sort_by(keys), host.sort_by(keys)
    for name in got.schema.names:
        g = got.column(name).to_numpy(zero_copy_only=False)
        h = host.column(name).to_numpy(zero_copy_only=False)
        if name in exact:
            want, against = np.asarray(exact[name]), "exact"
            if name in WINDOW_AVERAGES.get(q, ()):
                # half a unit of the 8th decimal, and 2 ulp for the conversions
                off = np.abs(g - want) > 0.5e-8 + 2 * np.spacing(np.abs(want))
            else:
                off = g != want
        else:
            want, against = h, "host engine"
            off = ~np.isclose(g, h, rtol=1e-9, atol=0) if g.dtype.kind == "f" else g != h
        if g.dtype.kind == "f":
            off = off | ~np.isfinite(g)
        if off.any():
            bad = np.nonzero(off)[0][:5]
            raise AssertionError(f"{q}.{name}: {int(off.sum())} rows, e.g. {bad.tolist()}: "
                                 f"{g[bad].tolist()} vs {against} {want[bad].tolist()}")


# ---- 7. staged -----------------------------------------------------------------------
STAGED_QUERIES = ("q1", "q3", "q5", "q12")
# S1: a final aggregate of ~1.5 M groups (one per order) over 16 shuffle
# partitions; no ORDER BY above it, so its stage streams the shuffle read
S1_SQL = ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue, "
          "count(*) AS n FROM lineitem GROUP BY l_orderkey")
# S1 again in small chunks (also to the device: a partition's ~94 k states
# would otherwise coalesce into one chunk) under a state budget it outgrows
S1_SPILL = {"ballista.shuffle.stream_chunk_rows": "32768",
            "ballista.tpu.stream_device_rows": "32768",
            "ballista.agg.spill_state_rows": "65536"}
# S2: lineitem's q3 columns in this many shuffle partitions by l_orderkey
S2_PARTITIONS = 4
S2_DATE = "1995-03-15"
# a Flight server in a process of its own, serving shuffle pieces by paths
# relative to its working directory (which the reader's process cannot
# resolve, so every piece is fetched remotely); prints its port
FLIGHT_SERVER = r"""
import sys
sys.path.insert(0, {repo!r})
from ballista_tpu_torch.shuffle.flight import ShuffleFlightServer
server = ShuffleFlightServer("127.0.0.1", 0, ".")
print(server.port, flush=True)
server.serve()
"""


def _fold(into: dict, metrics: dict) -> None:
    """Per-task engine metrics into a run's: peaks by max, the rest summed."""
    for k, v in metrics.items():
        into[k] = max(into.get(k, 0.0), v) if k.endswith("max_bytes") else into.get(k, 0.0) + v


def run_staged(ctx, sql: str, work_dir: str, job: str, settings=None, serve=None) -> dict:
    """The executor's loop in one process: ``sql`` split into stages by the
    port's ``plan_query_stages``; each task of a stage streams
    ``execute_partition_stream(stage.input, pid)`` of a fresh torch engine
    into ``write_shuffle_stream``; ``remove_unresolved_shuffles`` then points
    the next stage's readers at the pieces written. With ``serve`` (host,
    port) every piece is located on that Flight server by its path relative
    to ``work_dir``. Returns the result table (the last stage's pieces in
    partition order), the wall, stages, tasks, shuffle bytes written and
    read, and the tasks' metrics folded (``_fold``)."""
    import pyarrow as pa

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.engine import create_engine
    from ballista_tpu_torch.plan import physical as P
    from ballista_tpu_torch.scheduler.planner import (
        plan_query_stages, remove_unresolved_shuffles,
    )
    from ballista_tpu_torch.shuffle.reader import read_shuffle_partition
    from ballista_tpu_torch.shuffle.stream import write_shuffle_stream

    config = BallistaConfig(dict(ctx.config.settings(), **(settings or {})))
    t0 = time.time()
    stages = plan_query_stages(job, _physical(ctx, sql))
    locations: dict = {}
    metrics: dict = {}
    tasks = written = read = 0
    for stage in stages:
        plan = remove_unresolved_shuffles(stage, locations)
        read += sum(int(loc.get("num_bytes", 0)) for n in P.walk_physical(plan)
                    if isinstance(n, P.ShuffleReaderExec)
                    for locs in n.partition_locations for loc in locs)
        outs = [[] for _ in range(plan.output_partitions())]
        for pid in range(plan.input_partitions()):
            engine = create_engine("torch", config, device=ctx.device)
            stats, _rows = write_shuffle_stream(
                plan, pid, engine.execute_partition_stream(plan.input, pid), work_dir)
            for st in stats:
                written += st.num_bytes
                loc = {"path": st.path, "host": "localhost", "flight_port": 0,
                       "executor_id": "local", "stage_id": plan.stage_id, "map_partition": pid,
                       "num_rows": st.num_rows, "num_bytes": st.num_bytes}
                if serve is not None:
                    loc.update(path=os.path.relpath(st.path, work_dir), host=serve[0],
                               flight_port=serve[1], executor_id="served")
                outs[st.output_partition].append(loc)
            _fold(metrics, engine.op_metrics)
            tasks += 1
        locations[plan.stage_id] = outs
    last = stages[-1]
    table = pa.concat_tables([read_shuffle_partition(locs, last.schema()).to_arrow()
                              for locs in locations[last.stage_id]])
    if torch.cuda.is_available() and str(ctx.device).startswith("cuda"):
        torch.cuda.synchronize()
    return {"table": table, "wall": time.time() - t0, "stages": len(stages), "tasks": tasks,
            "written": written, "read": read, "metrics": metrics}


def report_staged(label: str, r: dict, card: str) -> None:
    m = r["metrics"]
    prefetch = {k: m.get(k, 0.0) for k in ("op.PrefetchEncode.count", "op.PrefetchH2D.count",
                                           "op.PrefetchH2D.bytes", "op.PrefetchEncode.failed")}
    print(f"staged {label}: wall {r['wall']:.3f} s, {r['stages']} stages, {r['tasks']} tasks, "
          f"shuffle bytes written {r['written']}, read {r['read']}, device chunks "
          f"{m.get('op.StreamChunk.count', 0.0):g}, device stages "
          f"{m.get('op.DeviceExecute.count', 0.0):g}, grouped_sums launches {r['launches']} "
          f"(aggregate stages of k <= 32: {r['small_k_stages']}), prefetch {prefetch}, agg "
          f"spill rows {m.get('op.AggSpill.rows', 0.0):g}, exchange spill rows "
          f"{m.get('op.ExchangeSpill.rows', 0.0):g}, host fallbacks "
          f"{m.get('op.HostFallback.count', 0.0):g}; "
          f"{estimate_summary(f'staged {label}', r['stage_bytes'])} [{card}]", flush=True)


def check_staged(label: str, r: dict, launching: bool) -> None:
    """Zero host fallbacks, no failed pre-encode, and one grouped_sums
    launch per aggregate or merge stage of at most 32 groups."""
    m = r["metrics"]
    if m.get("op.HostFallback.count", 0.0) != 0.0:
        raise AssertionError(f"staged {label}: {m['op.HostFallback.count']:g} host fallbacks")
    if m.get("op.PrefetchEncode.failed", 0.0) != 0.0:
        raise AssertionError(f"staged {label}: {m['op.PrefetchEncode.failed']:g} failed "
                             "pre-encodes")
    if r["launches"] != r["small_k_stages"] or (launching and r["launches"] <= 0):
        raise AssertionError(f"staged {label}: {r['launches']} grouped_sums launches in "
                             f"{r['small_k_stages']} aggregate stages of k <= 32")


def staged_counted(ctx, sql: str, work_dir: str, job: str, **kw) -> dict:
    with counting() as rec:
        r = run_staged(ctx, sql, work_dir, job, **kw)
    return dict(rec, **r)


def s1_reference(tables: dict):
    """S1 exactly: per order, the int64 sum of price x (1 - discount) in
    ten-thousandths and the line count. (keys, sums, counts), keys sorted."""
    li = _read(tables, "lineitem", ["l_orderkey", "l_extendedprice", "l_discount"])
    rev = _hundredths(li["l_extendedprice"]) * (100 - _hundredths(li["l_discount"]))
    keys, inv = np.unique(li["l_orderkey"], return_inverse=True)
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, rev)
    return keys, sums, np.bincount(inv, minlength=len(keys))


def check_s1(label: str, r: dict, ref) -> None:
    keys, sums, counts = ref
    t = r["table"].sort_by("l_orderkey")
    got_keys = t.column("l_orderkey").to_numpy()
    if not np.array_equal(got_keys, keys) or not np.array_equal(t.column("n").to_numpy(), counts):
        raise AssertionError(f"S1 {label}: orders or counts differ from the exact reference")
    rev = t.column("revenue").to_numpy()
    want = sums.astype(np.float64) / 1e4
    if rounding_error(r["presums"]) == 0.0:
        ok = np.array_equal(rev, want)
    else:
        ok = bool(np.all(np.abs(rev - want) <= rounding_error(r["presums"]) *
                         (counts + len(r["presums"])) + 2 * np.spacing(np.abs(want))))
    if not ok:
        raise AssertionError(f"S1 {label}: revenue differs from the exact reference by up to "
                             f"{np.abs(rev - want).max()}")


def s2_stage(tables: dict, work_dir: str):
    """S2's stage plan, built by hand as the streaming tests build theirs:
    lineitem's q3 columns (every row) written by the port's writer in
    S2_PARTITIONS partitions by l_orderkey, one map task per parquet file,
    read back by a ShuffleReaderExec; a filter on the ship date; an inner
    join with a collected build of the orders placed before S2_DATE; a
    projection of the revenue. Returns (plan, lineitem arrays for the exact
    reference, the orders build's keys)."""
    import glob

    import pyarrow.parquet as pq

    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan import physical as P
    from ballista_tpu_torch.plan.expr import Alias, BinaryOp, Col, Lit
    from ballista_tpu_torch.plan.schema import DataType
    from ballista_tpu_torch.shuffle.writer import write_shuffle_partitions

    cols = ["l_orderkey", "l_linenumber", "l_extendedprice", "l_discount", "l_shipdate"]
    files = sorted(glob.glob(os.path.join(tables["lineitem"], "*.parquet")))
    locs = [[] for _ in range(S2_PARTITIONS)]
    schema = None
    for m, f in enumerate(files):
        batch = ColumnBatch.from_arrow(pq.read_table(f, columns=cols))
        schema = batch.schema
        wplan = P.ShuffleWriterExec("s2", 1, P.MemoryScanExec([batch], schema),
                                    P.HashPartitioning((Col("l_orderkey"),), S2_PARTITIONS))
        for st in write_shuffle_partitions(wplan, m, batch, work_dir):
            locs[st.output_partition].append(
                {"path": st.path, "host": "localhost", "flight_port": 0, "executor_id": "local",
                 "stage_id": 1, "map_partition": m, "num_rows": st.num_rows,
                 "num_bytes": st.num_bytes})
    od = pq.read_table(tables["orders"], columns=["o_orderkey", "o_orderdate", "o_shippriority"])
    od = od.filter(np.asarray(od.column("o_orderdate").cast("int32").to_numpy()) < _day(S2_DATE))
    build = ColumnBatch.from_arrow(od)
    reader = P.ShuffleReaderExec(1, schema, locs)
    filt = P.FilterExec(reader, BinaryOp(">", Col("l_shipdate"),
                                         Lit(_day(S2_DATE), DataType.DATE32)))
    join = P.HashJoinExec(left=filt, right=P.MemoryScanExec([build], build.schema),
                          on=[(Col("l_orderkey"), Col("o_orderkey"))], how="inner",
                          collect_build=True)
    revenue = BinaryOp("*", Col("l_extendedprice"),
                       BinaryOp("-", Lit(1, DataType.INT64), Col("l_discount")))
    plan = P.ProjectExec(join, [Alias(Col("l_orderkey"), "l_orderkey"),
                                Alias(Col("l_linenumber"), "l_linenumber"),
                                Alias(revenue, "revenue"), Alias(Col("o_orderdate"), "o_orderdate"),
                                Alias(Col("o_shippriority"), "o_shippriority")])
    return plan, od.column("o_orderkey").to_numpy()


def s2_reference(tables: dict, order_keys: np.ndarray):
    """S2 exactly: (l_orderkey, l_linenumber, revenue in ten-thousandths) of
    the lines shipped after S2_DATE whose order is in the build, sorted."""
    li = _read(tables, "lineitem", ["l_orderkey", "l_linenumber", "l_extendedprice",
                                    "l_discount", "l_shipdate"])
    keep = (li["l_shipdate"] > _day(S2_DATE)) & np.isin(li["l_orderkey"], order_keys)
    key, line = li["l_orderkey"][keep], li["l_linenumber"][keep]
    rev = _hundredths(li["l_extendedprice"][keep]) * (100 - _hundredths(li["l_discount"][keep]))
    o = np.lexsort((line, key))
    return key[o], line[o], rev[o]


def run_s2(plan, device: str, depth: int, settings: dict) -> dict:
    """S2's stage, each partition a task of its own streaming on a fresh
    torch engine at ``prefetch_depth`` = ``depth``; the rows, the wall, the
    tasks' metrics folded and per partition: device chunks, prefetched
    copies, bytes transferred and the prepared build's bytes."""
    import pyarrow as pa

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.engine import create_engine

    config = BallistaConfig(dict(settings, **{"ballista.engine.prefetch_depth": str(depth)}))
    t0 = time.time()
    parts, metrics, per = [], {}, []
    for pid in range(S2_PARTITIONS):
        engine = create_engine("torch", config, device=device)
        parts.extend(b.to_arrow() for b in engine.execute_partition_stream(plan, pid))
        m = engine.op_metrics
        builds = [sum(a.nbytes for a in enc.arrays) + bk.nbytes
                  for enc, bk, _dup, _uid in engine._build_prep.values()]
        per.append({"chunks": m.get("op.StreamChunk.count", 0.0),
                    "prefetched": m.get("op.PrefetchH2D.count", 0.0),
                    "transferred": m.get("op.DeviceTransfer.bytes", 0.0), "build": builds})
        _fold(metrics, m)
    return {"table": pa.concat_tables(parts), "wall": time.time() - t0, "metrics": metrics,
            "per_partition": per}


def check_s2(label: str, r: dict, ref, depth: int) -> None:
    key, line, rev = ref
    t = r["table"].sort_by([("l_orderkey", "ascending"), ("l_linenumber", "ascending")])
    if not (np.array_equal(t.column("l_orderkey").to_numpy(), key)
            and np.array_equal(t.column("l_linenumber").to_numpy(), line)
            and np.array_equal(t.column("revenue").to_numpy(), rev.astype(np.float64) / 1e4)):
        raise AssertionError(f"S2 {label}: rows differ from the exact reference")
    m = r["metrics"]
    if m.get("op.HostFallback.count", 0.0) or m.get("op.PrefetchEncode.failed", 0.0):
        raise AssertionError(f"S2 {label}: fallbacks or failed pre-encodes {m}")
    for pid, p in enumerate(r["per_partition"]):
        if p["chunks"] < 2 or len(p["build"]) != 1:
            raise AssertionError(f"S2 {label} partition {pid}: {p}")
        if depth > 0 and (p["prefetched"] != p["chunks"] or p["transferred"] != p["build"][0]):
            # every chunk prefetched; the build crossed to the card once
            raise AssertionError(f"S2 {label} partition {pid}: {p}")


# the CPU rehearsal's SF 0.01 in S1's and S2's chunk sizes: several chunks
# a partition there too
S1_SPILL_SMALL = {"ballista.shuffle.stream_chunk_rows": "256",
                  "ballista.tpu.stream_device_rows": "256",
                  "ballista.agg.spill_state_rows": "512"}
S2_SMALL = {"ballista.shuffle.stream_chunk_rows": "4096",
            "ballista.tpu.stream_device_rows": "4096"}


def run_staged_phase(device: str, tables: dict, tag: str, refs: tuple,
                     profile: bool = False, small: bool = False):
    """The staged phase (see the module docstring). Returns {(path, label,
    run): the run's record} and {(path, label): profile_run's record} of
    its profiled runs. ``small``: S1's and S2's chunk sizes for SF 0.01
    (the CPU rehearsal)."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig

    exact, want = refs
    ctx = BallistaContext.standalone(device=device)
    for name, location in tables.items():
        ctx.register_parquet(name, location)
    work = os.path.join(DATA_DIR, "staged")
    shutil.rmtree(work, ignore_errors=True)
    out, prof = {}, {}
    for q in STAGED_QUERIES:
        sql, expect = want[q]
        for run in ("cold", "warm"):
            r = staged_counted(ctx, sql, work, f"{q}-{run}")
            report_staged(f"{q} {run}", r, tag)
            check_result(r["table"], expect, exact[q], q, r["presums"])
            check_staged(f"{q} {run}", r, q in LAUNCHING)
            out[("staged", q, run)] = r
        if profile and q == "q1":
            prof[("staged", "q1 warm")] = profile_run(
                ctx, sql, work=lambda: run_staged(ctx, sql, work, "q1-profiled"))

    ref = s1_reference(tables)
    for label, settings in (("default", {}), ("spill", S1_SPILL_SMALL if small else S1_SPILL)):
        r = staged_counted(ctx, S1_SQL, work, f"s1-{label}", settings=settings)
        report_staged(f"S1 {label}", r, tag)
        check_s1(label, r, ref)
        check_staged(f"S1 {label}", r, False)
        out[("staged", "S1", label)] = r
        if label == "spill" and not (
                r["metrics"].get("op.AggSpill.rows", 0.0) > 0
                and r["metrics"].get("op.StreamChunk.count", 0.0) >= 2 * SHUFFLE_PARTITIONS):
            raise AssertionError(f"S1 spill: several chunks a partition and a spill expected, "
                                 f"got {r['metrics']}")

    plan, order_keys = s2_stage(tables, os.path.join(work, "s2"))
    ref = s2_reference(tables, order_keys)
    for depth in (2, 0):
        with counting() as rec:
            r = run_s2(plan, device, depth, S2_SMALL if small else {})
        r.update(rec)
        per = r["per_partition"]
        print(f"S2 prefetch_depth={depth}: wall {r['wall']:.3f} s, chunks per partition "
              f"{[p['chunks'] for p in per]}, prefetched copies (op.PrefetchH2D.count) "
              f"{[p['prefetched'] for p in per]}, bytes transferred per partition "
              f"{[p['transferred'] for p in per]}, the build's bytes per partition "
              f"{[p['build'] for p in per]}, prefetch failures "
              f"{r['metrics'].get('op.PrefetchEncode.failed', 0.0):g}; "
              f"{estimate_summary(f'S2 depth {depth}', r['stage_bytes'])} [{tag}]", flush=True)
        check_s2(f"depth {depth}", r, ref, depth)
        out[("staged", "S2", f"depth{depth}")] = r
        if profile:
            prof[("staged", f"S2 depth {depth}")] = profile_run(
                ctx, None, work=lambda d=depth: run_s2(plan, device, d, {}))

    # q3 with every piece fetched from a Flight server in another process
    remote = os.path.join(work, "remote")
    spill = os.path.join(work, "remote-spill")
    os.makedirs(remote, exist_ok=True)
    server = subprocess.Popen([sys.executable, "-c", FLIGHT_SERVER.format(repo=REPO)],
                              cwd=remote, stdout=subprocess.PIPE, text=True)
    try:
        port = int(server.stdout.readline())
        sql, expect = want["q3"]
        r = staged_counted(ctx, sql, remote, "remote-q3", serve=("127.0.0.1", port),
                           settings={"ballista.shuffle.spill_dir": spill})
    finally:
        server.terminate()
        server.wait(timeout=30)
    report_staged("q3 remote", r, tag)
    check_result(r["table"], expect, exact["q3"], "q3", r["presums"])
    check_staged("q3 remote", r, False)
    out[("staged", "q3-remote", "once")] = r
    left = [f for f in os.listdir(spill) if f.startswith("fetch-")] if os.path.isdir(spill) else []
    if left:
        raise AssertionError(f"q3 remote: spill files left behind: {left[:5]}")

    # the standalone exchange spilling to disk
    # its joins partitioned (at SF1 both builds would be collected, and only
    # the aggregate's ~30 k partial states would cross an exchange)
    spill_rows = "1000" if small else "100000"
    ex = BallistaContext.standalone(BallistaConfig({
        "ballista.tpu.ici_shuffle": "false", "ballista.optimizer.broadcast_rows_threshold": "0",
        "ballista.exchange.spill_rows": spill_rows}), device=device)
    for name, location in tables.items():
        ex.register_parquet(name, location)
    sql, expect = want["q3"]
    r = run_counted(ex, sql)
    report_run("exchange-spill", "q3", "once", r, tag)
    check_result(r["table"], expect, exact["q3"], "q3", r["presums"])
    m = r["metrics"]
    if not m.get("op.ExchangeSpill.rows", 0.0) > 0 or m.get("op.HostFallback.count", 0.0):
        raise AssertionError(f"exchange spill q3: {m}")
    print(f"exchange-spill q3: op.ExchangeSpill.rows {m['op.ExchangeSpill.rows']:g}, bytes "
          f"{m.get('op.ExchangeSpill.bytes', 0.0):g} [{tag}]", flush=True)
    out[("exchange-spill", "q3", "once")] = r
    return out, prof


# ---- 8. distributed ------------------------------------------------------------------
DIST_QUERIES = ("q1", "q3", "q5", "q12")
PROC_QUERIES = ("q3", "q5")
# how long an executor process may take to import torch, reach the card and
# register before the phase fails
EXECUTOR_START_S = 120


def job_summary(graph) -> dict:
    """A finished job's graph: stages, tasks, stages adopted from the
    exchange cache, shuffle bytes written by its tasks, its stages' merged
    task metrics, and the stages whose device evidence is missing: every
    stage that ran (not adopted) with an aggregate or a join above a
    shuffle read must show ``op.DeviceExecute.count`` above 0."""
    from ballista_tpu_torch.plan import physical as P

    stages = graph.stages.values()
    ran = [s for s in stages if not getattr(s, "from_cache", False)]
    no_device = []
    for s in ran:
        nodes = list(P.walk_physical(s.plan))
        heavy = (any(isinstance(n, P.UnresolvedShuffleExec) for n in nodes)
                 and any(isinstance(n, (P.HashAggregateExec, P.HashJoinExec)) for n in nodes))
        if heavy and s.stage_metrics.get("op.DeviceExecute.count", 0.0) <= 0:
            no_device.append(s.stage_id)
    metrics: dict = {}
    for s in ran:
        _fold(metrics, s.stage_metrics)
    shuffle = sum(int(loc.get("num_bytes", 0) or 0) for s in ran for t in s.task_infos
                  if t is not None for loc in t.locations)
    return {"stages": len(graph.stages), "tasks": graph.total_task_count(),
            "adopted": len(graph.stages) - len(ran), "shuffle_bytes": shuffle,
            "metrics": metrics, "no_device": no_device,
            "calls": int(metrics.get("op.GroupedSums.calls", 0.0)),
            # a graph adopted from the durable state store carries no report
            "budget": getattr(getattr(graph, "memory_report", None), "budget_bytes", 0)}


def span_device(spans: list) -> dict:
    """A job's device time from its trace: the ``DeviceExecute`` spans (one
    per device program, each closed after the device finished) and the
    largest stage peak the ``CompiledStage`` spans measured."""
    dev = [s for s in spans if s["name"] == "DeviceExecute"]
    peaks = [int(s["attrs"].get("hbm_peak_bytes", 0) or 0) for s in spans
             if s["name"] == "CompiledStage"]
    return {"programs": len(dev), "device_s": sum(s["dur_us"] for s in dev) / 1e6,
            "peak_bytes": max(peaks, default=0)}


def check_job(label: str, job: dict) -> None:
    """Zero host fallbacks and device execution in every aggregate or join
    stage above a shuffle read."""
    fallbacks = job["metrics"].get("op.HostFallback.count", 0.0)
    if fallbacks:
        raise AssertionError(f"distributed {label}: {fallbacks:g} host fallbacks")
    if job["no_device"]:
        raise AssertionError(f"distributed {label}: stages {job['no_device']} above a shuffle "
                             "read ran no device stage")


def report_job(label: str, wall: float, job: dict, launches, card: str) -> None:
    m = job["metrics"]
    print(f"distributed {label}: wall {wall:.3f} s, {job['stages']} stages "
          f"({job['adopted']} adopted from the exchange cache), {job['tasks']} tasks, shuffle "
          f"bytes written {job['shuffle_bytes']}, device stages "
          f"{m.get('op.DeviceExecute.count', 0.0):g}, device time "
          f"{m.get('op.DeviceExecute.time_s', 0.0):.3f} s, grouped_sums calls reported by the "
          f"tasks {job['calls']}, launches counted {launches}, host fallbacks "
          f"{m.get('op.HostFallback.count', 0.0):g}, admission budget {job['budget']} "
          f"bytes [{card}]", flush=True)


def start_executor(port: int, device: str) -> tuple:
    """``python -m ballista_tpu_torch.executor --backend torch`` as an OS
    process of its own, registered with the scheduler at ``port``."""
    cmd = [sys.executable, "-m", "ballista_tpu_torch.executor", "--backend", "torch",
           "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port), "--port", "0",
           "--task-slots", "2", "--log-level", "WARNING"]
    if device != "cuda":
        cmd += ["--device", device]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def await_started(proc) -> str:
    """The executor's work dir, from the line it prints once registered."""
    line = proc.stdout.readline()
    if "started" not in line:
        proc.kill()
        raise AssertionError(f"executor did not start (exit {proc.wait(timeout=30)}): "
                             f"{line!r} {proc.stderr.read()[-2000:]}")
    return line.rsplit("work dir ", 1)[1].strip()


def run_distributed_phase(device: str, tables: dict, tag: str, refs: tuple) -> dict:
    """The distributed phase (see the module docstring). Returns
    {("distributed", query, run): the run's record}."""
    import ballista_tpu_torch.engine.memory_model as MM
    import ballista_tpu_torch.ops.grouped_sums as GS
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.client.standalone import start_standalone_cluster
    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.engine import compile_service as CS
    from ballista_tpu_torch.engine import torch_engine as TE
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    exact, want = refs
    out = {}
    on_card = device.startswith("cuda")
    # 1. two torch executors in this process (one CUDA context, one set of
    # leaf caches, one launch count between them)
    work = os.path.join(DATA_DIR, "distributed")
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    svc = CS.get_service()
    svc.clear()
    svc.reset_stats()
    cluster = start_standalone_cluster(n_executors=2, task_slots=2, device=device,
                                       work_dir=work)
    print(f"in-process cluster: scheduler and 2 torch executors on {device} (2 task slots "
          f"each, pull mode) up in {time.time() - t0:.3f} s", flush=True)
    try:
        ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
        for name, location in tables.items():
            ctx.register_parquet(name, location)
        TE.clear_caches()
        for q in DIST_QUERIES:
            sql, expect = want[q]
            for run in ("cold", "warm"):
                with counting() as rec:
                    t0 = time.time()
                    table = ctx.sql(sql).collect()
                    wall = time.time() - t0
                job = job_summary(cluster.scheduler.tasks.get_job(ctx.last_job_id))
                report_job(f"{q} {run}", wall, job, rec["launches"], tag)
                dev = span_device(cluster.scheduler.traces.get(ctx.last_job_id))
                print(f"distributed {q} {run}: the trace's {dev['programs']} DeviceExecute "
                      f"spans {dev['device_s']:.4f} s = {100 * dev['device_s'] / wall:.2f}% of "
                      f"the wall; largest stage peak {dev['peak_bytes']} bytes [{tag}]",
                      flush=True)
                # stages adopted from the exchange cache carry the rounding
                # of the cold run that wrote their pieces
                presums = rec["presums"] + (
                    out[("distributed", q, "cold")]["presums"] if job["adopted"] else [])
                check_result(table, expect, exact[q], q, presums)
                check_job(f"{q} {run}", job)
                if on_card and rec["launches"] != job["calls"]:
                    raise AssertionError(f"distributed {q} {run}: {rec['launches']} grouped_sums "
                                         f"launches, the graph's tasks made {job['calls']} calls")
                if q in LAUNCHING and run == "cold" and job["calls"] <= 0:
                    raise AssertionError(f"distributed {q} cold: grouped_sums never called")
                out[("distributed", q, run)] = {
                    "table": table, "wall": wall, "launches": rec["launches"],
                    "shapes": rec["shapes"], "presums": rec["presums"],
                    "metrics": job["metrics"], "job": job}
        # the warm runs the cold jobs' hints queued (q3's top-10 over its final
        # aggregate streams; q1's, q5's and q12's templates decline)
        t0 = time.time()
        if not svc.wait_idle(120):
            raise AssertionError(f"distributed: hint work still pending: {svc.stats()}")
        stats = svc.stats()
        print(f"distributed hints: drained in {time.time() - t0:.3f} s; compile service "
              f"{json.dumps(stats)}; warm grouped_sums launches {GS.warm_launches} [{tag}]",
              flush=True)
        if stats["hint_submitted"] <= 0 or stats["hint_compiled"] <= 0 or stats["hint_failed"]:
            raise AssertionError(f"distributed: precompile hints warmed nothing or failed: "
                                 f"{stats}")
        # admission plans against the budget the executors' card gives, which
        # is what their engines' safety net detects on it
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        admitted = out[("distributed", "q3", "cold")]["job"]["budget"]
        detected = MM.detect_device_budget_bytes(device) if on_card else 0
        if kind in MM.DEVICE_MEMORY_BYTES and admitted != detected:
            raise AssertionError(f"admission budget {admitted} for {kind!r}, the card's "
                                 f"engines detect {detected}")
        print(f"admission budget for {kind!r}: {admitted} bytes; detected on the card "
              f"{detected} bytes [{tag}]", flush=True)
        out.update(run_flightsql_phase(cluster, device, tables, tag, refs))
    finally:
        cluster.stop()

    # 2. two executor processes against a scheduler in this process
    sched = SchedulerServer(SchedulerConfig())
    port = sched.start(0)
    procs, dirs = [], []
    t0 = time.time()
    try:
        procs = [start_executor(port, device) for _ in range(2)]
        dirs = [await_started(p) for p in procs]
        deadline = time.time() + EXECUTOR_START_S
        while len(sched.cluster.alive_executors()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        print(f"2 executor processes ({' '.join(procs[0].args[1:5])}) registered in "
              f"{time.time() - t0:.3f} s", flush=True)
        ctx = BallistaContext.remote("127.0.0.1", port)
        for name, location in tables.items():
            ctx.register_parquet(name, location)
        for q in PROC_QUERIES:
            sql, expect = want[q]
            t1 = time.time()
            table = ctx.sql(sql).collect()
            wall = time.time() - t1
            job = job_summary(sched.tasks.get_job(ctx.last_job_id))
            report_job(f"{q} processes", wall, job, "not visible here", tag)
            m = job["metrics"]
            print(f"distributed {q} processes: op.CompileHidden.time_s "
                  f"{m.get('op.CompileHidden.time_s', 0.0):.6f}, compile_cache "
                  + ", ".join(f"{k} {m.get(f'compile_cache.{k}', 0.0):g}"
                              for k in ("opened", "hits", "misses", "evictions"))
                  + f" [{tag}]", flush=True)
            check_result(table, expect, exact[q], q, [])
            check_job(f"{q} processes", job)
            if q in LAUNCHING and job["calls"] <= 0:
                raise AssertionError(f"distributed {q} processes: grouped_sums never called")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait(timeout=30))
        sched.stop()
    if codes != [0] * len(procs):
        raise AssertionError(f"executor processes exited {codes}: "
                             f"{[p.stderr.read()[-2000:] for p in procs]}")
    left = [d for d in dirs if os.path.exists(d)]
    if left:
        raise AssertionError(f"executor work dirs left behind: {left}")
    print(f"2 executor processes stopped by SIGTERM, exit codes {codes}, work dirs removed",
          flush=True)
    return out


# ---- 8b. flightsql -------------------------------------------------------------------
FLIGHTSQL_QUERIES = ("q1", "q3", "q5")


def check_executors_report(sched, n: int, device: str, label: str) -> None:
    """``n`` live executors registered with ``sched``, each reporting the
    card's name (``cpu`` off the card) as its device kind."""
    kind = torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu"
    kinds = [e.device_kind for e in sched.cluster.alive_executors()]
    if len(kinds) != n or set(kinds) != {kind}:
        raise AssertionError(f"{label}: executors report {kinds}, expected {n} x {kind!r}")


def flight_service(cluster, **kw):
    """The port's Flight SQL service over ``cluster``'s scheduler, counting
    what its own ``do_get`` serves and the jobs its statements submit."""
    from ballista_tpu_torch.scheduler.flight_sql import SchedulerFlightService

    class Service(SchedulerFlightService):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.gets, self.jobs = 0, []

        def do_get(self, context, ticket):
            self.gets += 1
            return super().do_get(context, ticket)

        def _run(self, sql, timeout_s=None):
            status = super()._run(sql, timeout_s)
            self.jobs.append(status.job_id)
            return status

    svc = Service(cluster.scheduler, "127.0.0.1", 0, **kw)
    svc.serve_background()
    return svc


def flight_fetch(client, descriptor):
    """(FlightInfo, the result table) of a statement: each endpoint fetched
    from the executor Flight server its first location names, or, with no
    location (a sealed result), from the service ``client`` talks to."""
    import pyarrow as pa
    import pyarrow.flight as flight

    info = client.get_flight_info(descriptor)
    parts = []
    for ep in info.endpoints:
        if not ep.locations:
            parts.append(client.do_get(ep.ticket).read_all())
            continue
        direct = flight.connect(ep.locations[0].uri.decode())
        try:
            parts.append(direct.do_get(ep.ticket).read_all())
        finally:
            direct.close()
    return info, pa.concat_tables(parts).cast(info.schema)


def run_flightsql_phase(cluster, device: str, tables: dict, tag: str, refs: tuple) -> dict:
    """The flightsql phase, over the distributed phase's in-process cluster
    (two torch executors on ``device``): the eight tables registered through
    the ``register_parquet`` action; q1, q3 and q5 as
    ``CommandStatementQuery``, cold (leaf caches and the scheduler's exchange
    cache cleared) then warm, fetched from the executors' endpoints: rows
    exact, zero host fallbacks, the scheduler's ``do_get`` serving nothing,
    grouped_sums launches equal to the calls the job graph reports (above 0
    for cold q1); a prepared q1 run twice then closed (its plan-cache pin 1
    then 0); a second service with ``ballista.serving.result_cache=true``,
    whose repeated q1 submits no job and returns the same rows. Returns
    {("flightsql", query, run): the run's record}."""
    import pyarrow.flight as flight

    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import torch_engine as TE
    from ballista_tpu_torch.proto import flight_sql_pb2 as fsql
    from ballista_tpu_torch.scheduler.flight_sql import _try_unpack, pack_any
    from ballista_tpu_torch.scheduler.serving import fingerprint_sql

    phase("flightsql")
    t_phase = time.time()
    exact, want = refs
    on_card = device.startswith("cuda")
    sched = cluster.scheduler
    check_executors_report(sched, 2, device, "flightsql")
    out = {}
    svc = flight_service(cluster)
    client = flight.connect(f"grpc://127.0.0.1:{svc.port}")
    try:
        t0 = time.time()
        for name, location in tables.items():
            list(client.do_action(flight.Action("register_parquet", json.dumps(
                {"name": name, "path": os.path.abspath(location)}).encode())))
        print(f"flightsql: {len(tables)} tables registered through the register_parquet "
              f"action in {time.time() - t0:.3f} s", flush=True)
        TE.clear_caches()
        for e in cluster.executors:
            sched.exchange_cache.invalidate_executor(e.executor_id)
        for q in FLIGHTSQL_QUERIES:
            sql, expect = want[q]
            cmd = flight.FlightDescriptor.for_command(
                pack_any(fsql.CommandStatementQuery(query=sql)))
            for run in ("cold", "warm"):
                with counting() as rec:
                    t0 = time.time()
                    info, table = flight_fetch(client, cmd)
                    wall = time.time() - t0
                if not all(ep.locations for ep in info.endpoints):
                    raise AssertionError(f"flightsql {q} {run}: an endpoint not at an executor")
                job = job_summary(sched.tasks.get_job(svc.jobs[-1]))
                report_job(f"flightsql {q} {run}", wall, job, rec["launches"], tag)
                presums = rec["presums"] + (
                    out[("flightsql", q, "cold")]["presums"] if job["adopted"] else [])
                check_result(table, expect, exact[q], q, presums)
                check_job(f"flightsql {q} {run}", job)
                if on_card and rec["launches"] != job["calls"]:
                    raise AssertionError(f"flightsql {q} {run}: {rec['launches']} grouped_sums "
                                         f"launches, the graph's tasks made {job['calls']} calls")
                if q == "q1" and run == "cold" and job["calls"] <= 0:
                    raise AssertionError("flightsql q1 cold: grouped_sums never called")
                print(f"flightsql {q} {run}: {len(info.endpoints)} endpoints, all at the "
                      f"executors; wall {wall:.3f} s [{tag}]", flush=True)
                out[("flightsql", q, run)] = {
                    "table": table, "wall": wall, "launches": rec["launches"],
                    "shapes": rec["shapes"], "presums": rec["presums"],
                    "metrics": job["metrics"], "job": job}
        if svc.gets:
            raise AssertionError(f"flightsql: the scheduler's do_get served {svc.gets} "
                                 "tickets of a statement")
        print("flightsql: the scheduler's do_get served 0 tickets, 0 bytes of the "
              "statements' results", flush=True)

        # a prepared q1: executed twice by handle, then closed
        sql, expect = want["q1"]
        fp = fingerprint_sql(sql)
        (raw,) = list(client.do_action(flight.Action("CreatePreparedStatement", pack_any(
            fsql.ActionCreatePreparedStatementRequest(query=sql)))))
        name, prep = _try_unpack(raw.body.to_pybytes())
        pins = [sched.plan_cache.pin_count(fp)]
        cmd = flight.FlightDescriptor.for_command(pack_any(fsql.CommandPreparedStatementQuery(
            prepared_statement_handle=prep.prepared_statement_handle)))
        walls = []
        for _ in range(2):
            with counting() as rec:
                t0 = time.time()
                _, table = flight_fetch(client, cmd)
                walls.append(time.time() - t0)
            check_result(table, expect, exact["q1"], "q1",
                         rec["presums"] + out[("flightsql", "q1", "cold")]["presums"])
        list(client.do_action(flight.Action("ClosePreparedStatement", pack_any(
            fsql.ActionClosePreparedStatementRequest(
                prepared_statement_handle=prep.prepared_statement_handle)))))
        pins.append(sched.plan_cache.pin_count(fp))
        if name != "ActionCreatePreparedStatementResult" or pins != [1, 0]:
            raise AssertionError(f"flightsql prepared q1: {name}, plan-cache pins {pins}")
        print(f"flightsql prepared q1: walls {walls[0]:.3f} / {walls[1]:.3f} s, plan-cache "
              f"pin {pins[0]} while open, {pins[1]} after close [{tag}]", flush=True)
    finally:
        client.close()
        svc.shutdown()

    # the sealed-result tier: a repeated statement submits no job
    svc = flight_service(cluster, config=BallistaConfig(
        {"ballista.serving.result_cache": "true"}))
    client = flight.connect(f"grpc://127.0.0.1:{svc.port}")
    try:
        for name, location in tables.items():
            list(client.do_action(flight.Action("register_parquet", json.dumps(
                {"name": name, "path": os.path.abspath(location)}).encode())))
        cmd = flight.FlightDescriptor.for_command(
            pack_any(fsql.CommandStatementQuery(query=want["q1"][0])))
        first, walls = None, []
        for i in range(2):
            submitted = sched.metrics.job_submitted_total
            t0 = time.time()
            _, table = flight_fetch(client, cmd)
            walls.append(time.time() - t0)
            jobs = sched.metrics.job_submitted_total - submitted
            if i == 0:
                first = table
                if jobs != 1:
                    raise AssertionError(f"flightsql result cache: first q1 submitted {jobs} jobs")
            elif jobs != 0 or not table.equals(first) or svc.result_cache.stats()["hits"] < 1:
                raise AssertionError(f"flightsql result cache: repeated q1 submitted {jobs} "
                                     f"jobs, same rows {table.equals(first)}, "
                                     f"{svc.result_cache.stats()}")
        print(f"flightsql result cache: q1 {walls[0]:.3f} s submitting 1 job, repeated "
              f"{walls[1]:.4f} s submitting none, the same rows [{tag}]", flush=True)
    finally:
        client.close()
        svc.shutdown()
    print(f"flightsql phase {time.time() - t_phase:.1f} s [{tag}]", flush=True)
    return out


# ---- 9. surfaces -------------------------------------------------------------------
SURFACE_QUERIES = ("q1", "q3", "q5")
# one task of q3's first stage slowed, on the executor the drain then takes
DRAIN_FAULT = "task.execute:slow@delay=2.0:stage_id=1:partition=0"
API_ROUTES = ("/", "/ui", "/api/state", "/api/executors", "/api/jobs", "/api/job/{job}",
              "/api/stages/{job}", "/api/dot/{job}", "/api/dot_stage/{job}/1",
              "/api/trace/{job}", "/api/trace_spans/{job}", "/api/scale", "/api/serving",
              "/api/metrics", "/api/timeseries", "/api/profile?seconds=0.2")


def explain_analyze(ctx, sql: str) -> dict:
    """``EXPLAIN ANALYZE`` of ``sql`` inside ``counting()``: the rendered
    plan, the query's spans and metrics, its wall."""
    with counting() as rec:
        t0 = time.time()
        text = ctx.sql("EXPLAIN ANALYZE " + sql).collect().column("plan")[0].as_py()
        wall = time.time() - t0
    return dict(rec, text=text, wall=wall, spans=list(ctx.last_trace_spans),
                metrics=dict(ctx.last_engine_metrics))


def check_spans(label: str, r: dict, on_card: bool, tag: str) -> None:
    """An EXPLAIN ANALYZE run's spans against its metrics: one
    ``DeviceExecute`` span per device program (``op.DeviceExecute.count``),
    their durations summing to ``op.DeviceExecute.time_s`` within 1 ms per
    span, the ``CompiledStage`` and ``DeviceExecute`` rollups in the
    rendered plan (on the card with a measured stage peak), no host
    fallback."""
    m, spans, text = r["metrics"], r["spans"], r["text"]
    dev = [s for s in spans if s["name"] == "DeviceExecute"]
    stages = [s for s in spans if s["name"] == "CompiledStage"]
    n = m.get("op.DeviceExecute.count", 0.0)
    if len(dev) != n or n < 1:
        raise AssertionError(f"surfaces {label}: {len(dev)} DeviceExecute spans, "
                             f"op.DeviceExecute.count {n:g}")
    span_s = sum(s["dur_us"] for s in dev) / 1e6
    if abs(span_s - m["op.DeviceExecute.time_s"]) > 1e-3 * len(dev):
        raise AssertionError(f"surfaces {label}: DeviceExecute spans {span_s:.6f} s, "
                             f"op.DeviceExecute.time_s {m['op.DeviceExecute.time_s']:.6f} s")
    hbm = next((ln for ln in text.splitlines() if ln.startswith("hbm: ")), "")
    if "device: compile_ms=0.000 execute_ms=" not in text or not stages or not hbm:
        raise AssertionError(f"surfaces {label}: no CompiledStage/DeviceExecute rollup in\n{text}")
    if on_card and hbm.endswith("peak_bytes=0"):
        raise AssertionError(f"surfaces {label}: no stage peak measured: {hbm}")
    if m.get("op.HostFallback.count", 0.0):
        raise AssertionError(f"surfaces {label}: {m['op.HostFallback.count']:g} host fallbacks")
    # stages nest (a stage's leaves may run stages), so their sum may pass the wall
    stage_s = sum(s["dur_us"] for s in stages) / 1e6
    print(f"surfaces {label}: EXPLAIN ANALYZE wall {r['wall']:.3f} s, {len(stages)} "
          f"CompiledStage spans ({stage_s:.6f} s, nested), {len(dev)} DeviceExecute spans "
          f"({span_s:.6f} s; op.DeviceExecute.time_s {m['op.DeviceExecute.time_s']:.6f} s), "
          f"{hbm}, grouped_sums launches {r['launches']} [{tag}]", flush=True)


def _http(port: int, route: str, method: str = "GET") -> tuple:
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{route}", method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read().decode()


def _json(port: int, route: str, method: str = "GET"):
    return json.loads(_http(port, route, method)[2])


def _prom(text: str, name: str) -> float:
    return next(float(ln.split()[-1]) for ln in text.splitlines() if ln.startswith(name + " "))


def _slow_task_holder(sched) -> str:
    """The executor running partition 0 of stage 1 of an active job."""
    with sched.tasks._lock:
        for g in sched.tasks.active_jobs():
            s = g.stages.get(1)
            t = s.task_infos[0] if s is not None and s.task_infos else None
            if t is not None and t.status == "running":
                return t.executor_id
    return ""


def _api_cluster(device: str, work: str):
    """A scheduler whose expiry loop (and with it the scale controller)
    ticks every 0.25 s, its REST API, and two torch executors in this
    process on ``device``."""
    from ballista_tpu_torch.client.standalone import start_standalone_cluster
    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.scheduler.api import start_api_server

    shutil.rmtree(work, ignore_errors=True)
    cluster = start_standalone_cluster(
        n_executors=2, task_slots=2, device=device, work_dir=work,
        scheduler_config=SchedulerConfig(expire_dead_executors_interval_seconds=0.25))
    return cluster, start_api_server(cluster.scheduler, "127.0.0.1", 0)


def run_surfaces_phase(device: str, tables: dict, tag: str, refs: tuple) -> dict:
    """The surfaces phase: (a) standalone EXPLAIN ANALYZE of q1, q3 and q5,
    cold and warm, against a plain warm run; (b) EXPLAIN ANALYZE of q3 with
    its joins paged; (c) EXPLAIN VERIFY of q1-q22 under the detected budget;
    (d) every REST API route over a cluster of two torch executors, and
    EXPLAIN ANALYZE over the remote context; (e) a drain mid-job through
    ``PATCH /api/scale/drain``; (f) the CLI in a subprocess. Returns
    {("surfaces", query, run): the run's record}."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import torch_engine as TE

    exact, want = refs
    on_card = device.startswith("cuda")
    out = {}
    t_phase = time.time()

    # (a) standalone EXPLAIN ANALYZE, cold and warm, beside a plain warm run
    ctx = BallistaContext.standalone(device=device)
    for name, location in tables.items():
        ctx.register_parquet(name, location)
    for q in SURFACE_QUERIES:
        sql, expect = want[q]
        TE.clear_caches()
        cold = explain_analyze(ctx, sql)
        check_spans(f"{q} cold", cold, on_card, tag)
        # warm, in turns: plain, EXPLAIN ANALYZE, EXPLAIN ANALYZE, plain (a
        # plain standalone run records the same spans; EXPLAIN ANALYZE adds
        # the render)
        plain = run_counted(ctx, sql)
        check_result(plain["table"], expect, exact[q], q, plain["presums"])
        warm = explain_analyze(ctx, sql)
        check_spans(f"{q} warm", warm, on_card, tag)
        walls = [warm["wall"], explain_analyze(ctx, sql)["wall"]]
        plain_walls = [plain["wall"], run_counted(ctx, sql)["wall"]]
        if warm["launches"] != plain["launches"]:
            raise AssertionError(f"surfaces {q} warm: EXPLAIN ANALYZE made {warm['launches']} "
                                 f"grouped_sums launches, the plain run {plain['launches']}")
        print(f"surfaces {q}: warm EXPLAIN ANALYZE walls {walls[0]:.4f}, {walls[1]:.4f} s, "
              f"plain warm walls {plain_walls[0]:.4f}, {plain_walls[1]:.4f} s "
              f"({sum(walls) / sum(plain_walls):.3f}x); grouped_sums launches "
              f"{warm['launches']} and {plain['launches']} [{tag}]", flush=True)
        out[("surfaces", q, "cold")] = cold
        out[("surfaces", q, "warm")] = warm

    # (b) EXPLAIN ANALYZE of q3, its joins partitioned, unfused and paged
    settings = next(s for path, s, _, _ in PATHS if path == "paged")
    pctx = BallistaContext.standalone(BallistaConfig(dict(settings)), device=device)
    for name, location in tables.items():
        pctx.register_parquet(name, location)
    sql, expect = want["q3"]
    pctx.config.set(BUDGET_KEY, str(paged_budget(pctx, sql)))
    paged = explain_analyze(pctx, sql)
    m = paged["metrics"]
    pspans = [s for s in paged["spans"] if s["name"] == "PagedJoin"]
    passes = sum(s["attrs"]["passes"] for s in pspans)
    if not (len(pspans) == m.get("op.PagedJoin.count", 0.0) >= 1
            and passes == m.get("op.PagedJoin.passes", 0.0) >= 2):
        raise AssertionError(f"surfaces paged q3: {len(pspans)} PagedJoin spans of {passes} "
                             f"passes, metrics {m.get('op.PagedJoin.count', 0.0):g} in "
                             f"{m.get('op.PagedJoin.passes', 0.0):g}")
    check_spans("paged q3", paged, on_card, tag)
    rows = run_counted(pctx, sql)
    check_result(rows["table"], expect, exact["q3"], "q3", rows["presums"])
    print(f"surfaces paged q3: {len(pspans)} PagedJoin spans, {passes} passes, "
          f"{sum(s['dur_us'] for s in pspans) / 1e6:.3f} s in them; the plain run's rows "
          f"exact in {rows['wall']:.3f} s [{tag}]", flush=True)
    out[("surfaces", "q3", "paged")] = paged

    # (c) EXPLAIN VERIFY of all 22 queries under the budget detected on the card
    t0 = time.time()
    verdicts = {}
    for i in range(1, 23):
        with open(os.path.join(REPO, "benchmarks", "queries", f"q{i}.sql")) as f:
            found = ctx.sql("EXPLAIN VERIFY " + f.read()).collect().to_pydict()
        bad = [r for r in zip(found["severity"], found["rule"], found["message"])
               if r[0] == "error" or r[1] == "PV007"]
        if bad:
            raise AssertionError(f"surfaces EXPLAIN VERIFY q{i}: {bad}")
        verdicts[f"q{i}"] = sorted(set(found["rule"]))
    print(f"surfaces EXPLAIN VERIFY q1-q22: no error, every governor verdict fits, in "
          f"{time.time() - t0:.3f} s; rules found {verdicts} [{tag}]", flush=True)

    # (d) the REST API over a cluster of two torch executors
    cluster, api = _api_cluster(device, os.path.join(DATA_DIR, "surfaces_api"))
    port = api.server_address[1]
    try:
        rctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
        for name, location in tables.items():
            rctx.register_parquet(name, location)
        sql, expect = want["q3"]
        TE.clear_caches()
        with counting() as rec:
            t0 = time.time()
            table = rctx.sql(sql).collect()
            wall = time.time() - t0
        check_result(table, expect, exact["q3"], "q3", rec["presums"])
        job = rctx.last_job_id
        graph = cluster.scheduler.tasks.get_job(job)
        t0 = time.time()
        got = {r: _http(port, r.format(job=job)) for r in API_ROUTES}
        routes_s = time.time() - t0
        failed = {r: g[0] for r, g in got.items() if g[0] != 200}
        if failed:
            raise AssertionError(f"surfaces api: routes failed {failed}")
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        execs = json.loads(got["/api/executors"][2])
        if len(execs) != 2 or {e["device_kind"] for e in execs} != {kind}:
            raise AssertionError(f"surfaces api: executors {execs}")
        if not got["/api/dot/{job}"][2].startswith("digraph"):
            raise AssertionError("surfaces api: /api/dot is no digraph")
        events = [e for e in json.loads(got["/api/trace/{job}"][2])["traceEvents"]
                  if e["ph"] == "X"]
        cats = {e["cat"] for e in events}
        dev_events = sum(1 for e in events if e["name"] == "DeviceExecute")
        dev_count = sum(s.stage_metrics.get("op.DeviceExecute.count", 0.0)
                        for s in graph.stages.values())
        if not {"client", "scheduler", "executor"} <= cats or dev_events != dev_count \
                or dev_count < 1:
            raise AssertionError(f"surfaces api: trace services {cats}, {dev_events} "
                                 f"DeviceExecute events, the stages count {dev_count:g}")
        metrics = got["/api/metrics"][2]
        if "\nscale_" not in metrics or "\ntrace_store_" not in metrics:
            raise AssertionError("surfaces api: no scale_ or trace_store_ lines in /api/metrics")
        if "<html" not in got["/ui"][2]:
            raise AssertionError("surfaces api: /ui is no HTML page")
        remote = explain_analyze(rctx, sql)
        spans_line = remote["text"].splitlines()[-1]
        if f"job_id: {rctx.last_job_id}" not in remote["text"] or "executor=" not in spans_line \
                or "engine=" not in spans_line:
            raise AssertionError(f"surfaces api: remote EXPLAIN ANALYZE\n{remote['text']}")
        dev = span_device(cluster.scheduler.traces.get(job))
        print(f"surfaces api: q3's trace: {dev['programs']} DeviceExecute spans "
              f"{dev['device_s']:.4f} s = {100 * dev['device_s'] / wall:.2f}% of the wall; "
              f"largest stage peak {dev['peak_bytes']} bytes [{tag}]", flush=True)
        print(f"surfaces api: q3 through 2 executors on {device} in {wall:.3f} s, rows exact; "
              f"{len(API_ROUTES)} routes answered in {routes_s:.3f} s; /api/trace holds "
              f"{len(events)} events of {sorted(cats)}, {dev_events} DeviceExecute (the stages "
              f"count {dev_count:g}); remote EXPLAIN ANALYZE wall {remote['wall']:.3f} s, "
              f"{spans_line} [{tag}]", flush=True)
    finally:
        api.shutdown()
        cluster.stop()

    # (e) a drain mid-job, on a fresh cluster: no earlier job's result
    # pieces hold the drain for the result-serve window
    import threading

    cluster, api = _api_cluster(device, os.path.join(DATA_DIR, "surfaces_drain"))
    port = api.server_address[1]
    sched = cluster.scheduler
    try:
        for p in cluster.executors:
            sched.scale.register_local(p.executor_id, p.stop)
        slowed = BallistaContext.remote("127.0.0.1", cluster.scheduler_port, BallistaConfig({
            "ballista.faults.schedule": DRAIN_FAULT,
            # an exchange adopted from the cache would skip the slowed stage
            "ballista.serving.exchange_cache": "false"}))
        plain = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
        for c in (slowed, plain):
            for name, location in tables.items():
                c.register_parquet(name, location)
        sql, expect = want["q3"]
        result, errors = {}, []

        def submit():
            try:
                t1 = time.time()
                result["table"] = slowed.sql(sql).collect()
                result["wall"] = time.time() - t1
            except Exception as e:  # noqa: BLE001 - re-raised on the main thread
                errors.append(e)

        with counting() as rec:
            job = threading.Thread(target=submit, daemon=True)
            job.start()
            deadline = time.time() + 120
            victim = ""
            while not victim and time.time() < deadline and job.is_alive():
                victim = _slow_task_holder(sched)
                time.sleep(0.02)
            if not victim:
                raise AssertionError("surfaces drain: the slowed task never ran")
            t_patch = time.time()
            if _json(port, f"/api/scale/drain/{victim}", "PATCH") != {"draining": True}:
                raise AssertionError(f"surfaces drain: PATCH refused for {victim}")
            statuses = []
            while time.time() < t_patch + 120:
                now = {e["executor_id"]: e["status"] for e in _json(port, "/api/executors")}
                if victim not in now:
                    break
                statuses.append(now[victim])
                time.sleep(0.05)
            removed_s = time.time() - t_patch
            job.join(timeout=120)
        if errors:
            raise errors[0]
        if job.is_alive() or "table" not in result:
            raise AssertionError("surfaces drain: the drained job never finished")
        check_result(result["table"], expect, exact["q3"], "q3", rec["presums"])
        left = {e["executor_id"] for e in _json(port, "/api/executors")}
        if victim in left or "terminating" not in statuses:
            raise AssertionError(f"surfaces drain: {victim} went {sorted(set(statuses))}, "
                                 f"executors left {left}")
        metrics = _http(port, "/api/metrics")[2]
        started, completed = (_prom(metrics, "scale_drains_started_total"),
                              _prom(metrics, "scale_drains_completed_total"))
        if (started, completed) != (1.0, 1.0):
            raise AssertionError(f"surfaces drain: drains started {started:g}, completed "
                                 f"{completed:g}")
        sql5, expect5 = want["q5"]
        with counting() as rec5:
            t0 = time.time()
            table5 = plain.sql(sql5).collect()
            wall5 = time.time() - t0
        check_result(table5, expect5, exact["q5"], "q5", rec5["presums"])
        graph5 = sched.tasks.get_job(plain.last_job_id)
        check_job("surfaces q5 after the drain", job_summary(graph5))
        ran_on = {t.executor_id for s in graph5.stages.values() for t in s.task_infos
                  if t is not None}
        if victim in ran_on:
            raise AssertionError(f"surfaces drain: q5 ran tasks on the drained {victim}")
        print(f"surfaces drain: {victim} drained mid-job; PATCH to removal {removed_s:.3f} s "
              f"(statuses seen {sorted(set(statuses))}); the slowed q3 took "
              f"{result['wall']:.3f} s, rows exact; drains started {started:g}, completed "
              f"{completed:g}; q5 on the survivor {sorted(ran_on)} in {wall5:.3f} s, rows "
              f"exact, no host fallback [{tag}]", flush=True)
    finally:
        api.shutdown()
        cluster.stop()

    # (f) the CLI in a subprocess: a -f script registering lineitem and running q6
    sql, expect = want["q6"]
    script = os.path.join(DATA_DIR, "surfaces_q6.sql")
    with open(script, "w") as f:
        f.write(f"CREATE EXTERNAL TABLE lineitem STORED AS PARQUET LOCATION "
                f"'{tables['lineitem']}';\n{sql.strip().rstrip(';')}\n")
    cmd = [sys.executable, "-m", "ballista_tpu_torch.client.cli", "--format", "csv", "-f", script]
    if not on_card:
        cmd += ["--device", device]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    cli_s = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"surfaces cli: exit {proc.returncode}: {proc.stderr[-2000:]}")
    import io

    import pyarrow.csv as pacsv

    # the last statement's CSV closes the output: its header and one row
    table = pacsv.read_csv(io.BytesIO("\n".join(proc.stdout.strip().splitlines()[-2:]).encode()))
    check_result(table, expect, exact["q6"], "q6", [])
    print(f"surfaces cli: python -m ballista_tpu_torch.client.cli on {device} ran q6 from a -f "
          f"script in {cli_s:.3f} s (process start included), rows exact [{tag}]", flush=True)
    print(f"surfaces phase {time.time() - t_phase:.1f} s [{tag}]", flush=True)
    return out


# ---- 10. mesh --------------------------------------------------------------------
MESH_SHARDS = 4
MESH_QUERIES = ("q1", "q3", "q5", "q12")
# the scheduler cases of tests/test_torch_ici.py and tests/test_torch_megastage.py
MESH_AGG_SQL = (
    "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
    "count(*) as n from lineitem group by l_returnflag, l_linestatus "
    "order by l_returnflag, l_linestatus")
MESH_JOIN_SQL = (
    "select o_orderpriority, count(*) as n, sum(l_extendedprice) as rev "
    "from lineitem join orders on l_orderkey = o_orderkey "
    "group by o_orderpriority order by o_orderpriority")
ICI_FAULT = "ici.exchange:error@p=1:seed=7"
PARTITIONED = {"ballista.optimizer.broadcast_rows_threshold": "0"}
# grouped_sums calls a fused aggregate makes on each shard: its partial
# aggregate and its final merge (tests/test_torch_mesh.py)
CALLS_PER_SHARD = 2


def q1_flagship_reference(args) -> tuple:
    """The flagship's q1 sums and counts in numpy f64 from the same inputs."""
    qty, price, disc, tax, ship, rf, ls, valid = (a.cpu().numpy() for a in args)
    from ballista_tpu_torch.parallel.flagship import CUTOFF, N_GROUPS

    keep = valid & (ship <= CUTOFF)
    ids = (rf * 2 + ls)[keep]
    dp = price * (1.0 - disc)
    cols = [qty, price, dp, dp * (1.0 + tax), disc]
    sums = np.stack([np.bincount(ids, weights=c[keep], minlength=N_GROUPS) for c in cols])
    return sums, np.bincount(ids, minlength=N_GROUPS)


def run_flagship(device: str, n: int, tag: str) -> None:
    """q1_local_step on ``device`` at ``n`` rows against numpy f64 (counts
    exact, sums within 1e-9 relative: another summation order), and
    q1_distributed_step over a mesh of MESH_SHARDS shards equal to it (its
    groups summed over the shards that own them)."""
    from ballista_tpu_torch.parallel import flagship as FLAG
    from ballista_tpu_torch.parallel.mesh import build_mesh

    args = FLAG.q1_example_args(n=n, seed=3, device=device)
    want_sums, want_counts = q1_flagship_reference(args)
    t0 = time.time()
    sums, counts = FLAG.q1_local_step()(*args)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    local_s = time.time() - t0
    if not (torch.isfinite(sums).all() and sums.shape == (5, FLAG.N_GROUPS)):
        raise AssertionError(f"flagship local: sums {sums.shape} not finite")
    if not np.array_equal(counts.cpu().numpy(), want_counts):
        raise AssertionError(f"flagship local counts {counts.tolist()}, numpy {want_counts}")
    if not np.allclose(sums.cpu().numpy(), want_sums, rtol=1e-9, atol=0):
        raise AssertionError("flagship local sums differ from numpy f64")
    mesh = build_mesh(MESH_SHARDS, device)
    step = FLAG.q1_distributed_step(mesh)
    t0 = time.time()
    dsums, dcounts = step(*args)
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    dist_s = time.time() - t0
    dsums = dsums.cpu().numpy().reshape(MESH_SHARDS, 5, FLAG.N_GROUPS).sum(0)
    dcounts = dcounts.cpu().numpy().reshape(MESH_SHARDS, FLAG.N_GROUPS).sum(0)
    if not np.array_equal(dcounts, counts.cpu().numpy()):
        raise AssertionError(f"flagship distributed counts {dcounts} vs local {counts}")
    if not np.allclose(dsums, sums.cpu().numpy(), rtol=1e-9, atol=0):
        raise AssertionError("flagship distributed sums differ from the local step's")
    print(f"mesh flagship: q1_local_step at n={n} on {device} {local_s:.4f} s, exact counts, "
          f"sums within 1e-9 of numpy f64; q1_distributed_step over {MESH_SHARDS} shards "
          f"({[str(d) for d in mesh]}) {dist_s:.4f} s, equal [{tag}]", flush=True)
    costs = {n_dev: mesh_costs(device, args, n_dev) for n_dev in (1, MESH_SHARDS)}
    print(f"mesh costs (ms, median; shards: costs): {json.dumps(costs)}, switch interval "
          f"{sys.getswitchinterval()} s [{tag}]", flush=True)


def mesh_costs(device: str, args: tuple, n_dev: int) -> dict:
    """What the shard runner costs on ``n_dev`` shards of ``device``, host
    clock around work that ends in a device sync: ``shard_map`` of a body
    that does nothing (the threads' start and join), one ``all_sum`` round
    and one ``all_to_all`` round (64 K float32 a peer), q1_local_step over
    each shard's slice of ``args`` through ``shard_map``, and
    q1_distributed_step. The median of 5 runs after a warm-up."""
    from ballista_tpu_torch import parallel
    from ballista_tpu_torch.parallel import flagship as FLAG
    from ballista_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(n_dev, device)

    def median_ms(fn, per: int = 1) -> float:
        times = []
        for i in range(6):
            t0 = time.perf_counter()
            fn()
            if device.startswith("cuda"):
                torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) / per)
        return sorted(times)[len(times) // 2] * 1e3

    def rounds(op: str, k: int):
        def body():
            coll = parallel.collective_for(n_dev)
            # "cuda" is the shard's own card on its thread
            x = (torch.ones((), device=device) if op == "all_sum"
                 else torch.ones((n_dev, 1 << 16), device=device))
            for _ in range(k):
                x = coll.all_sum(x) * 0 + 1 if op == "all_sum" else coll.all_to_all([x])[0]
            return x
        return lambda: parallel.shard_map(body, [()] * n_dev, mesh)

    shards = [[a.to(d) for a in part] for part, d in zip(parallel.split_rows(args, n_dev), mesh)]
    local, step = FLAG.q1_local_step(), FLAG.q1_distributed_step(mesh)
    return {
        "shard_map_noop": median_ms(lambda: parallel.shard_map(lambda: None, [()] * n_dev, mesh)),
        "all_sum_round": median_ms(rounds("all_sum", 20), 20),
        "all_to_all_round": median_ms(rounds("all_to_all", 10), 10),
        "q1_local_step_sharded": median_ms(lambda: parallel.shard_map(local, shards, mesh)),
        "q1_distributed_step": median_ms(lambda: step(*args)),
    }


def mesh_programs(spans: list) -> list:
    """The fused programs' (eager estimate, measured peak) from their
    DeviceExecute spans."""
    return [(int(s["attrs"].get("hbm_est_bytes", 0)), int(s["attrs"].get("hbm_peak_bytes", 0)))
            for s in spans if s["name"] == "DeviceExecute"
            and s["attrs"].get("program") == "fused"]


def check_mesh_memory(label: str, programs: list, on_card: bool, tag: str) -> None:
    """Every mesh program's eager estimate at or above its measured peak
    (programs of at least 1 MB; ESTIMATE_MISSES fails the run)."""
    if not programs:
        raise AssertionError(f"mesh {label}: no fused program ran")
    for est, peak in programs:
        if on_card and max(est, peak) >= 1 << 20 and peak > est:
            ESTIMATE_MISSES.append((f"mesh {label}", est, peak))
    print(f"mesh {label}: fused programs (eager estimate, measured peak) {programs} [{tag}]",
          flush=True)


def run_mesh_phase(device: str, tables: dict, sf: float, tag: str, refs: tuple,
                   one_device: dict, flagship_rows: int) -> dict:
    """The mesh phase: (1) the flagship; (2) q1, q3, q5 and q12 standalone
    on a mesh of MESH_SHARDS shards, cold then warm, beside the one-device
    walls of the slice (``one_device``: its records); (3) a scheduler with
    one torch executor on that mesh: MESH_AGG_SQL, MESH_JOIN_SQL and q5
    promoted, MESH_JOIN_SQL as one megastage, MESH_AGG_SQL demoted by an
    injected collective fault. Returns {("mesh", query, run): record}."""
    from ballista_tpu_torch import parallel
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.client.standalone import start_standalone_cluster
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import torch_engine as TE

    exact, want = refs
    on_card = device.startswith("cuda")
    out = {}
    t_phase = time.time()
    run_flagship(device, flagship_rows, tag)
    prev = parallel.force_mesh_shards(MESH_SHARDS)
    try:
        # (2) standalone on the mesh
        ctx = BallistaContext.standalone(device=device)
        for name, location in tables.items():
            ctx.register_parquet(name, location)
        TE.clear_caches()
        for q in MESH_QUERIES:
            sql, expect = want[q]
            for run in ("cold", "warm"):
                r = run_counted(ctx, sql)
                m = r["metrics"]
                check_result(r["table"], expect, exact[q], q, r["presums"])
                fused = tuple(int(m.get(k, 0.0)) for k in FUSED_KEYS)
                if fused != expected_fused("default", q, sf):
                    raise AssertionError(f"mesh {q} {run}: fused/joins/declined {fused}")
                if m.get("op.HostFallback.count", 0.0):
                    raise AssertionError(f"mesh {q} {run}: {m['op.HostFallback.count']:g} "
                                         "host fallbacks")
                if r["launches"] != r["small_k_stages"]:
                    raise AssertionError(f"mesh {q} {run}: {r['launches']} grouped_sums "
                                         f"launches in {r['small_k_stages']} aggregates")
                if q == "q1" and r["launches"] != CALLS_PER_SHARD * MESH_SHARDS:
                    raise AssertionError(f"mesh q1 {run}: {r['launches']} launches, want "
                                         f"{CALLS_PER_SHARD * MESH_SHARDS}")
                programs = mesh_programs(ctx.last_trace_spans)
                check_mesh_memory(f"{q} {run}", programs, on_card, tag)
                one = one_device.get(("default", q, run))
                print(f"mesh {q} {run}: wall {r['wall']:.3f} s on {MESH_SHARDS} shards "
                      f"(one device: {one['wall'] if one else float('nan'):.3f} s), device "
                      f"programs {m.get('op.DeviceExecute.count', 0.0):g}, fused {fused}, "
                      f"grouped_sums launches {r['launches']}, host fallbacks 0 [{tag}]",
                      flush=True)
                out[("mesh", q, run)] = r

        # (3) the scheduler with one fat torch executor on the mesh
        work = os.path.join(DATA_DIR, "mesh")
        shutil.rmtree(work, ignore_errors=True)
        cluster = start_standalone_cluster(n_executors=1, task_slots=2, device=device,
                                           work_dir=work)
        try:
            def remote(settings):
                c = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
                c.config = BallistaConfig(settings)
                for name, location in tables.items():
                    c.register_parquet(name, location)
                return c

            def job(c, sql):
                t0 = time.time()
                table = c.sql(sql).collect()
                wall = time.time() - t0
                g = cluster.scheduler.tasks.get_job(c.last_job_id)
                return table, wall, g, job_summary(g), cluster.scheduler.traces.get(c.last_job_id)

            host = BallistaContext.standalone(backend="numpy")
            for name, location in tables.items():
                host.register_parquet(name, location)
            cases = (("agg", MESH_AGG_SQL, {}), ("join", MESH_JOIN_SQL,
                     dict(PARTITIONED, **{"ballista.engine.megastage": "false"})),
                     ("q5", want["q5"][0], dict(PARTITIONED, **{"ballista.engine.megastage":
                                                                 "false"})),
                     ("megastage", MESH_JOIN_SQL, dict(PARTITIONED)))
            for label, sql, settings in cases:
                flight, f_wall, _, f_job, _ = job(
                    remote(dict(settings, **{"ballista.shuffle.ici": "false"})), sql)
                with counting() as rec:
                    table, wall, g, summary, spans = job(remote(settings), sql)
                if label == "q5":
                    check_result(table, want["q5"][1], exact["q5"], "q5", rec["presums"])
                elif not table.equals(flight):
                    raise AssertionError(f"mesh cluster {label}: rows differ from the Flight "
                                         "tier's")
                else:
                    check_same_as_host(label, table, host.sql(sql).collect())
                check_job(f"mesh {label}", summary)
                ici = summary["metrics"].get("op.IciExchange.count", 0.0)
                if g.ici_promoted < 1 or ici <= 0 or summary["stages"] >= f_job["stages"]:
                    raise AssertionError(f"mesh cluster {label}: promoted {g.ici_promoted}, "
                                         f"op.IciExchange.count {ici}, stages "
                                         f"{summary['stages']} vs {f_job['stages']}")
                fused_spans = mesh_programs(spans)
                if label == "megastage":
                    ms = [s for s in g.stages.values()
                          if s.stage_metrics.get("op.Megastage.count", 0) >= 1]
                    if g.megastage_promoted != 1 or len(ms) != 1 or len(fused_spans) != 1:
                        raise AssertionError(f"mesh megastage: promoted {g.megastage_promoted}, "
                                             f"stages {len(ms)}, programs {len(fused_spans)}")
                if on_card and rec["launches"] != summary["calls"]:
                    raise AssertionError(f"mesh cluster {label}: {rec['launches']} launches, "
                                         f"the tasks report {summary['calls']} calls")
                print(f"mesh cluster {label}: wall {wall:.3f} s in {summary['stages']} stages "
                      f"(Flight tier: {f_wall:.3f} s in {f_job['stages']}), promoted "
                      f"{g.ici_promoted}, megastage {g.megastage_promoted}, "
                      f"op.IciExchange.count {ici:g}, bytes_hbm "
                      f"{summary['metrics'].get('op.IciExchange.bytes_hbm', 0.0):g}, fused "
                      f"programs (eager estimate, peak) {fused_spans}, grouped_sums launches "
                      f"{rec['launches']} [{tag}]", flush=True)
                out[("mesh", f"cluster-{label}", "once")] = {
                    "table": table, "wall": wall, "launches": rec["launches"],
                    "shapes": rec["shapes"], "presums": rec["presums"],
                    "metrics": summary["metrics"]}
            # an injected collective fault demotes the promoted aggregate
            clean_stages = job(remote({}), MESH_AGG_SQL)[3]["stages"]
            table, wall, g, summary, _ = job(remote({"ballista.faults.schedule": ICI_FAULT}),
                                             MESH_AGG_SQL)
            check_same_as_host("fault", table, host.sql(MESH_AGG_SQL).collect())
            if (summary["stages"] != clean_stages + 1 or g.ici_promoted != 1
                    or summary["metrics"].get("op.IciExchange.count")):
                raise AssertionError(f"mesh fault: stages {summary['stages']} vs {clean_stages}"
                                     f", promoted {g.ici_promoted}, collectives "
                                     f"{summary['metrics'].get('op.IciExchange.count')}")
            print(f"mesh cluster fault ({ICI_FAULT}): demoted onto the Flight tier, rows exact, "
                  f"{summary['stages']} stages (promoted: {clean_stages}), wall {wall:.3f} s "
                  f"[{tag}]", flush=True)
        finally:
            cluster.stop()
    finally:
        parallel.force_mesh_shards(prev)
    print(f"mesh phase {time.time() - t_phase:.1f} s [{tag}]", flush=True)
    return out


# ---- 11. multihost -----------------------------------------------------------------
# each member's shards: two members of MH_SHARDS shards on one card make the
# 4-shard global mesh of tests/test_multihost.py's layout
MH_SHARDS = 2
MH_MEMBERS = 2
# every exchange inline, so that the collective stages gang-schedule
MH_GANG = {"ballista.tpu.fuse_exchange_max_rows": str(1 << 28)}
# (label, sql or None for the TPC-H query of that name, settings, runs, the
# fused aggregates and joins each member runs in the gang stage, or None
# where a collective join's build keys repeat: GANG_UNFUSABLE in both
# members, and the stage runs again un-ganged). q5's join order follows the
# scale's statistics: at SF1 every build side's keys are unique (customer
# on (c_custkey, c_nationkey)) and its whole chain gangs; at SF 0.01 two
# build sides repeat theirs. q12's build side (lineitem) repeats
# l_orderkey at every scale.
MH_CASES = (("q1", None, {}, ("cold", "warm"), (1, 0)),
            ("agg", MESH_AGG_SQL, {}, ("once",), (1, 0)),
            ("join", MESH_JOIN_SQL, PARTITIONED, ("once",), (1, 1)),
            ("q5", None, PARTITIONED, ("cold", "warm"), {1.0: (1, 5), 0.01: None}),
            ("q12", None, PARTITIONED, ("once",), None))
# the failure case's collective timeout: the waiting peer gives up this soon
MH_TIMEOUT_MS = 15_000


def mesh_exact(tables: dict) -> dict:
    """MESH_AGG_SQL and MESH_JOIN_SQL exactly (numpy int64 sums of
    hundredths; every line's order exists), in ORDER BY order."""
    li = _read(tables, "lineitem", ["l_orderkey", "l_quantity", "l_extendedprice",
                                     "l_returnflag", "l_linestatus"])
    qty, price = _hundredths(li["l_quantity"]), _hundredths(li["l_extendedprice"])
    agg: dict = {}
    for f, s in sorted(set(zip(li["l_returnflag"], li["l_linestatus"]))):
        m = (li["l_returnflag"] == f) & (li["l_linestatus"] == s)
        for k, v in (("l_returnflag", f), ("l_linestatus", s),
                     ("sum_qty", int(qty[m].sum()) / 100), ("n", int(m.sum()))):
            agg.setdefault(k, []).append(v)
    od = _read(tables, "orders", ["o_orderkey", "o_orderpriority"])
    prio = _index(od["o_orderkey"], od["o_orderpriority"].astype(object), None)[li["l_orderkey"]]
    join: dict = {}
    for p in sorted(set(prio)):
        m = prio == p
        for k, v in (("o_orderpriority", p), ("n", int(m.sum())),
                     ("rev", int(price[m].sum()) / 100)):
            join.setdefault(k, []).append(v)
    return {"agg": agg, "join": join}


def start_member(port: int, coordinator: str, pid: int, device: str, log_path: str):
    """One torch executor process of mesh group g0 (MH_MEMBERS members of
    MH_SHARDS shards), push mode, its log in ``log_path``."""
    cmd = [sys.executable, "-m", "ballista_tpu_torch.executor", "--backend", "torch",
           "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port), "--port", "0",
           "--task-slots", "2", "--scheduling-policy", "push", "--log-level", "INFO",
           "--mesh-group-id", "g0", "--mesh-group-coordinator", coordinator,
           "--mesh-group-size", str(MH_MEMBERS), "--mesh-group-process-id", str(pid),
           "--mesh-group-local-devices", str(MH_SHARDS)]
    if device != "cuda":
        cmd += ["--device", device]
    log = open(log_path, "w")
    return subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT), log


class MemberLogs:
    """The members' logs, read on from where the last read stopped."""

    def __init__(self, paths: list):
        self.paths = paths
        self.offsets = [0] * len(paths)

    def new(self) -> list:
        out = []
        for i, path in enumerate(self.paths):
            with open(path) as f:
                f.seek(self.offsets[i])
                text = f.read()
                self.offsets[i] = f.tell()
            out.append(text)
        return out


def _programs(text: str, job_id: str, kind: str) -> list:
    """(rounds, bytes, seconds, process group set-up seconds) of each
    ``multihost fused <kind>`` line one member logged for ``job_id``."""
    out = []
    for line in text.splitlines():
        if f"multihost fused {kind}: group={job_id}-" in line:
            tail = line.rsplit("; exchange ", 1)[1].split()
            setup = float(line.rsplit("set-up ", 1)[1].split()[0])
            out.append((int(tail[0]), int(tail[2]), float(tail[4]), setup))
    return out


def reported_shapes(metrics: dict) -> dict:
    """{(n, k, columns, dtype): calls} from the tasks' reported
    ``op.GroupedSums.shape.<n>x<k>x<columns>.<dtype>`` metrics (the calls that
    launched the kernel in executor processes)."""
    out = {}
    for key, calls in metrics.items():
        if key.startswith("op.GroupedSums.shape."):
            dims, dtype = key[len("op.GroupedSums.shape."):].split(".")
            n, k, ncols = (int(d) for d in dims.split("x"))
            out[(n, k, ncols, getattr(torch, dtype))] = int(calls)
    return out


def run_multihost_phase(device: str, tables: dict, sf: float, tag: str, refs: tuple,
                        earlier: dict) -> dict:
    """The multihost phase (see the module docstring). ``earlier`` holds
    the distributed phase's runs (their walls are printed beside these) and
    the slice's and mesh phase's q1 runs (their presum_safe rescalings bound
    q1's rounded sum here: the members' own are not visible to this
    process). Returns {("multihost", query, run): record}."""
    import ballista_tpu_torch.engine.memory_model as MM
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig, SchedulerConfig
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    exact, want = refs
    on_card = device.startswith("cuda")
    t_phase = time.time()
    mexact = mesh_exact(tables)
    host = BallistaContext.standalone(backend="numpy")
    for name, location in tables.items():
        host.register_parquet(name, location)
    q1_presums = [p for k in (("default", "q1", "warm"), ("mesh", "q1", "warm"))
                  if k in earlier for p in earlier[k]["presums"]]
    work = os.path.join(DATA_DIR, "multihost")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    sched = SchedulerServer(SchedulerConfig(scheduling_policy="push"))
    port = sched.start(0)
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    paths = [os.path.join(work, f"member{pid}.log") for pid in range(MH_MEMBERS)]
    members = []
    out = {}
    try:
        t0 = time.time()
        members = [start_member(port, coordinator, pid, device, paths[pid])
                   for pid in range(MH_MEMBERS)]
        deadline = time.time() + EXECUTOR_START_S
        while not sched.cluster.complete_mesh_groups() and time.time() < deadline:
            if any(p.poll() is not None for p, _ in members):
                break
            time.sleep(0.05)
        logs = MemberLogs(paths)
        if not sched.cluster.complete_mesh_groups():
            raise AssertionError(f"mesh group g0 never formed: {[t[-2000:] for t in logs.new()]}")
        joined = logs.new()
        print(f"mesh group g0: {MH_MEMBERS} executor processes of {MH_SHARDS} shards on "
              f"{device} registered as one complete group in {time.time() - t0:.3f} s",
              flush=True)
        # each member's per-shard budget and the transport, as it logged them
        card_split = (MM.shard_budget_bytes(MM.detect_device_budget_bytes(device),
                                            MH_MEMBERS * MH_SHARDS) if on_card else 0)
        for pid, text in enumerate(joined):
            line = next((ln for ln in text.splitlines() if "mesh group joined" in ln), "")
            if "joining mesh group g0" not in text or not line:
                raise AssertionError(f"member {pid} did not join: {text[-2000:]}")
            budget = int(line.split("per-shard budget ")[1].split()[0])
            if on_card and budget != card_split:
                raise AssertionError(f"member {pid}: per-shard budget {budget}, want a "
                                     f"quarter of the card's {card_split * 4}: {card_split}")
            print(f"member {pid}: {line.split('mesh group joined: ')[1]} [{tag}]", flush=True)
        shapes = sorted((e.mesh_group_process_id, e.shards_per_card)
                        for e in sched.cluster.alive_executors())
        if [s for _, s in shapes] != [MH_MEMBERS * MH_SHARDS] * MH_MEMBERS:
            raise AssertionError(f"registered shards per card {shapes}")

        def job(sql: str, settings: dict):
            c = BallistaContext.remote("127.0.0.1", port)
            c.config = BallistaConfig(dict(MH_GANG, **settings))
            for name, location in tables.items():
                c.register_parquet(name, location)
            t1 = time.time()
            table = c.sql(sql).collect()
            wall = time.time() - t1
            g = sched.tasks.get_job(c.last_job_id)
            return table, wall, g, c.last_job_id

        for label, sql, settings, runs, expect in MH_CASES:
            sql = sql or want[label][0]
            if isinstance(expect, dict):
                expect = expect[sf]
            for run in runs:
                table, wall, g, job_id = job(sql, settings)
                summary = job_summary(g)
                texts = logs.new()
                if label in exact:
                    presums = q1_presums if label == "q1" else []
                    check_result(table, want[label][1], exact[label], label, presums)
                else:
                    check_result(table, host.sql(sql).collect(), mexact[label], label, [])
                check_job(f"multihost {label} {run}", summary)
                gang = [s for s in g.stages.values() if s.gang]
                calls = int(sum(s.stage_metrics.get("op.GroupedSums.calls", 0) for s in gang))
                launches = int(sum(s.stage_metrics.get("op.GroupedSums.launches", 0)
                                   for s in g.stages.values()))
                progs = [_programs(t, job_id, k) for t in texts for k in ("aggregate", "join")]
                if expect is None:
                    # a collective join's build keys repeat: the gang stage
                    # raises GANG_UNFUSABLE in both members and runs again
                    # un-ganged
                    unganged = [s for s in g.stages.values() if s.no_gang]
                    if gang or len(unganged) != 1 or unganged[0].attempt < 1 or not all(
                            "GANG_UNFUSABLE" in t for t in texts):
                        raise AssertionError(f"multihost {label} {run}: gang stages {len(gang)}"
                                             f", un-ganged {len(unganged)}")
                else:
                    aggs, joins = expect
                    counts = [len(p) for p in progs]
                    if len(gang) != 1 or gang[0].attempt != 0 or counts != [aggs, joins] * 2:
                        raise AssertionError(f"multihost {label} {run}: gang stages {len(gang)}"
                                             f", programs per member {counts}")
                    # a member's tasks of the stage share its stage engine,
                    # and each task reports that engine's counts: a member
                    # that counted each program once gives tasks x programs
                    m = gang[0].stage_metrics
                    counters = (m.get("op.FusedMultiHostExchange.count", 0),
                                m.get("op.FusedMultiHostJoin.count", 0))
                    if counters != (gang[0].partitions * aggs, gang[0].partitions * joins):
                        raise AssertionError(f"multihost {label} {run}: the {gang[0].partitions} "
                                             f"tasks counted (aggregates, joins) {counters}")
                    counted = launches if on_card else calls
                    want_calls = CALLS_PER_SHARD * MH_MEMBERS * MH_SHARDS * aggs
                    if counted != want_calls or calls != want_calls:
                        raise AssertionError(f"multihost {label} {run}: grouped_sums launches "
                                             f"{launches}, calls {calls}, want {want_calls}")
                    shaped = sum(reported_shapes(summary["metrics"]).values())
                    if on_card and shaped != launches:
                        raise AssertionError(f"multihost {label} {run}: {shaped} calls by "
                                             f"shape, {launches} launches")
                programs = mesh_programs(sched.traces.get(job_id))
                check_mesh_memory(f"multihost {label} {run}", programs, on_card, tag)
                moved = [sum(p[i] for ps in progs for p in ps) for i in range(4)]
                dist = earlier.get(("distributed", label, run))
                print(f"multihost {label} {run}: wall {wall:.3f} s (distributed phase: "
                      f"{dist['wall'] if dist else float('nan'):.3f} s), stages "
                      f"{summary['stages']}, gang stages {len(gang)}, programs per member "
                      f"(aggregates, joins) {[len(p) for p in progs]}, cross-process exchange "
                      f"{moved[0]} rounds, {moved[1]} bytes, {moved[2]:.6f} s, process group "
                      f"set-up {moved[3]:.6f} s (both members), "
                      f"grouped_sums launches {launches} (calls {calls}), host fallbacks 0, "
                      f"admission budget {summary['budget']} bytes [{tag}]", flush=True)
                out[("multihost", label, run)] = {
                    "table": table, "wall": wall, "launches": launches,
                    "shapes": reported_shapes(summary["metrics"]), "presums": [],
                    "metrics": summary["metrics"]}

        # member 1 fails its gang task once, before entering the program
        member1 = next(e.executor_id for e in sched.cluster.alive_executors()
                       if e.mesh_group_process_id == 1)
        fault = f"task.execute:fail_n@n=1:executor_id={member1}:stage_id=1"
        t1 = time.time()
        table, wall, g, job_id = job(MESH_AGG_SQL, {
            "ballista.shuffle.partitions": str(MH_MEMBERS),
            "ballista.tpu.mesh_group.timeout_ms": str(MH_TIMEOUT_MS),
            "ballista.faults.schedule": fault})
        check_result(table, host.sql(MESH_AGG_SQL).collect(), mexact["agg"], "agg", [])
        gang = [s for s in g.stages.values() if s.gang]
        if len(gang) != 1 or gang[0].attempt < 1:
            raise AssertionError(f"multihost failure: gang stages {[s.attempt for s in gang]}")
        # the peer of the failed member gave up at the rendezvous after the
        # phase's timeout, not the default's 120 s: the store's error says
        # how long it waited
        gave_up = ""
        while time.time() < t1 + MH_TIMEOUT_MS / 1000 + 30 and "wait timeout" not in gave_up:
            time.sleep(0.2)
            gave_up += logs.new()[0]
        waited = [int(part.split("ms")[0]) for part in gave_up.split("wait timeout after ")[1:]]
        if not waited or max(waited) > MH_TIMEOUT_MS:
            raise AssertionError(f"multihost failure: member 0 waited {waited} ms")
        print(f"multihost failure ({fault}): the gang stage restarted whole (attempt "
              f"{gang[0].attempt}), rows exact, wall {wall:.3f} s; member 0's first attempt "
              f"stopped waiting after {max(waited)} ms (the session's timeout), "
              f"{time.time() - t1:.1f} s after the job's start [{tag}]", flush=True)
    finally:
        for p, _ in members:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = []
        for p, log in members:
            try:
                codes.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait(timeout=30))
            log.close()
        sched.stop()
    if codes != [0] * len(members):
        raise AssertionError(f"mesh group members exited {codes}")
    print(f"multihost phase {time.time() - t_phase:.1f} s [{tag}]", flush=True)
    return out


# ---- 12. avro ------------------------------------------------------------------------
# the first AVRO_ROWS lineitem rows, q1's and q6's columns: both packages'
# avro reader decodes value by value in Python, so SF1's 6 M rows would take
# minutes (PERF.md names this cut)
AVRO_ROWS = 1 << 18
AVRO_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
                "l_linestatus", "l_shipdate"]


def run_avro_phase(device: str, tables: dict, tag: str) -> dict:
    """The avro phase: the first AVRO_ROWS lineitem rows (AVRO_COLUMNS)
    written through the port's ``write_avro`` and registered with
    ``register_avro`` in a standalone context on ``device``; q1 and q6 there,
    rows exact against ``exact_q1_q6`` over the same rows and the host engine,
    and equal to the same queries over the same rows from ``register_arrow``;
    zero host fallbacks; q1 launches grouped_sums. Prints the write and
    decode rates. Returns {("avro", query, "once"): the run's record}."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.utils.avro import write_avro

    t_phase = time.time()
    rows = pq.read_table(tables["lineitem"], columns=AVRO_COLUMNS).slice(0, AVRO_ROWS)
    work = os.path.join(DATA_DIR, "avro")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = os.path.join(work, "lineitem.avro")
    t0 = time.time()
    write_avro(path, rows)
    wrote = time.time() - t0
    ctx = BallistaContext.standalone(device=device)
    if not str(ctx.device).startswith(device):
        raise AssertionError(f"avro: the standalone context runs on {ctx.device}")
    t0 = time.time()
    ctx.register_avro("lineitem", path)
    decoded = time.time() - t0
    print(f"avro: {rows.num_rows} rows x {rows.num_columns} columns, {os.path.getsize(path)} "
          f"bytes (deflate): written in {wrote:.3f} s, decoded in {decoded:.3f} s = "
          f"{rows.num_rows / decoded:.0f} rows/s on the host [{tag}] host CPU: {cpu_model()}",
          flush=True)
    arrow = BallistaContext.standalone(device=device)
    arrow.register_arrow("lineitem", rows)
    host = BallistaContext.standalone(backend="numpy")
    host.register_arrow("lineitem", rows)
    li = {c: (rows.column(c).cast(pa.int32()) if c == "l_shipdate" else rows.column(c))
          .to_numpy(zero_copy_only=False) for c in AVRO_COLUMNS}
    exact = dict(zip(("q1", "q6"), exact_q1_q6(li)))
    out = {}
    for q in ("q1", "q6"):
        with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        r = run_counted(ctx, sql)
        check_result(r["table"], host.sql(sql).collect(), exact[q], q, r["presums"])
        if not r["table"].equals(arrow.sql(sql).collect()):
            raise AssertionError(f"avro {q}: rows differ from the same rows through "
                                 "register_arrow")
        fallbacks = r["metrics"].get("op.HostFallback.count", 0.0)
        if fallbacks:
            raise AssertionError(f"avro {q}: {fallbacks:g} host fallbacks")
        if q == "q1" and r["launches"] <= 0:
            raise AssertionError("avro q1: grouped_sums never launched")
        print(f"avro {q}: wall {r['wall']:.3f} s, grouped_sums launches {r['launches']}, "
              f"device stages {r['metrics'].get('op.DeviceExecute.count', 0.0):g}, rows "
              f"exact and equal to register_arrow's [{tag}]", flush=True)
        out[("avro", q, "once")] = r
    print(f"avro phase {time.time() - t_phase:.1f} s [{tag}]", flush=True)
    return out


# ---- 13. ha --------------------------------------------------------------------------
HA_LEASE_S = 2.0
# one task of q1's first stage slowed, so scheduler A is stopped while its
# job is mid-flight
HA_FAULT = "task.execute:slow@delay=2.0:stage_id=1:partition=0"


def _status_calls(sched, into: list) -> None:
    """Sum the grouped_sums calls of every task status ``sched`` receives
    into ``into[0]`` (statuses a scheduler receives for a job it adopted
    included)."""
    real = sched._apply_statuses

    def apply(executor_id, statuses):
        into[0] += sum(st.get("metrics", {}).get("op.GroupedSums.calls", 0.0)
                       for st in statuses)
        return real(executor_id, statuses)

    sched._apply_statuses = apply


def _job_table(status):
    """A finished job's result, read from its partition locations."""
    import pyarrow as pa

    from ballista_tpu_torch.plan.serde import schema_from_json
    from ballista_tpu_torch.scheduler.flight_sql import _location_batches

    schema = schema_from_json(json.loads(status.result_schema.decode())).to_arrow()
    locs = [{"path": l.path, "host": l.host, "flight_port": l.flight_port,
             "executor_id": l.executor_id, "stage_id": l.partition.stage_id,
             "map_partition": l.map_partition} for l in status.partition_locations]
    batches = list(_location_batches(locs, schema))
    return pa.Table.from_batches(batches, schema=schema) if batches else schema.empty_table()


def run_ha_phase(device: str, tables: dict, tag: str, refs: tuple) -> dict:
    """The ha phase: schedulers A and B on the ``kv`` backend, sharing one
    sqlite file, job leases of HA_LEASE_S; two torch executors on ``device``
    in this process, 1 task slot each, naming both schedulers. q1 submitted
    to A (one first-stage task slowed by HA_FAULT), A stopped once a task
    has started: B adopts the job when A's lease lapses and finishes it.
    Rows exact, zero host fallbacks, grouped_sums launches equal to the
    calls the task statuses both schedulers received report. Then q3 through
    a scheduler on the ``etcd`` backend, against an in-process ``KvServer``'s
    etcd surface: rows exact, the job persisted there. Returns
    {("ha", query, "once"): the run's record}."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.client.standalone import start_standalone_cluster
    from ballista_tpu_torch.config import ExecutorConfig, SchedulerConfig
    from ballista_tpu_torch.executor.process import ExecutorProcess
    from ballista_tpu_torch.plan.serde import encode_logical
    from ballista_tpu_torch.proto import ballista_pb2 as pb
    from ballista_tpu_torch.proto.rpc import scheduler_stub
    from ballista_tpu_torch.scheduler.kv_service import KvServer
    from ballista_tpu_torch.scheduler.server import SchedulerServer
    from ballista_tpu_torch.scheduler.state_store import InMemoryKV

    t_phase = time.time()
    exact, want = refs
    on_card = device.startswith("cuda")
    work = os.path.join(DATA_DIR, "ha")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def scheduler():
        return SchedulerServer(SchedulerConfig(
            scheduling_policy="pull", cluster_backend="kv",
            kv_path=os.path.join(work, "state.db"), job_lease_ttl_seconds=HA_LEASE_S,
            expire_dead_executors_interval_seconds=0.25, executor_timeout_seconds=30.0))

    a, b = scheduler(), scheduler()
    calls = [0.0]
    _status_calls(a, calls)
    _status_calls(b, calls)
    port_a, port_b = a.start(0), b.start(0)
    execs = []
    out = {}
    try:
        for i in range(2):
            e = ExecutorProcess(ExecutorConfig(
                port=0, flight_port=0, scheduler_port=port_a,
                scheduler_addrs=[f"127.0.0.1:{port_a}", f"127.0.0.1:{port_b}"],
                backend="torch", device=device, task_slots=1,
                work_dir=os.path.join(work, f"exec{i}"), poll_interval_ms=50),
                executor_id=f"ha-{i}")
            e.start()
            execs.append(e)
        deadline = time.time() + EXECUTOR_START_S
        while len(a.cluster.alive_executors()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        check_executors_report(a, 2, device, "ha")
        planner = BallistaContext.standalone(backend="numpy")
        for name, location in tables.items():
            planner.register_parquet(name, location)
        sql, expect = want["q1"]
        stub = scheduler_stub(f"127.0.0.1:{port_a}")
        session = stub.CreateSession(pb.CreateSessionParams(settings={}), timeout=30).session_id
        with counting() as rec:
            t0 = time.time()
            job_id = stub.ExecuteQuery(pb.ExecuteQueryParams(
                logical_plan=encode_logical(planner.sql(sql).logical_plan()),
                session_id=session, settings={"ballista.faults.schedule": HA_FAULT},
                table_defs=[json.dumps(m.to_dict()).encode()
                            for m in planner.catalog.tables.values()]), timeout=60).job_id
            deadline = time.time() + 60
            while time.time() < deadline:
                with a.tasks._lock:
                    g = a.tasks.get_job(job_id)
                    started = g is not None and any(
                        t is not None for s in g.stages.values() for t in s.task_infos)
                if started:
                    break
                time.sleep(0.02)
            else:
                raise AssertionError("ha: q1 never started on scheduler A")
            a_graph = a.tasks.get_job(job_id)
            a.stop()
            a = None
            stopped = time.time()
            stub_b = scheduler_stub(f"127.0.0.1:{port_b}")
            adopted, status = None, None
            deadline = time.time() + 120
            while time.time() < deadline:
                if adopted is None and b.tasks.get_job(job_id) is not None:
                    adopted = time.time()
                status = stub_b.GetJobStatus(pb.GetJobStatusParams(job_id=job_id),
                                             timeout=30).status
                if status.state == "SUCCESSFUL":
                    break
                if status.state in ("FAILED", "CANCELLED"):
                    raise AssertionError(f"ha: q1 {status.state} on B: {status.error}")
                time.sleep(0.05)
            ended = time.time()
            if status is None or status.state != "SUCCESSFUL" or adopted is None:
                raise AssertionError(f"ha: B did not finish A's job "
                                     f"({status.state if status else None})")
            table = _job_table(status)
        check_result(table, expect, exact["q1"], "q1", rec["presums"])
        # B's restored graph holds the metrics of the tasks that ran on B
        jobs = [job_summary(g) for g in (a_graph, b.tasks.get_job(job_id))]
        fallbacks = sum(j["metrics"].get("op.HostFallback.count", 0.0) for j in jobs)
        if fallbacks or jobs[1]["metrics"].get("op.DeviceExecute.count", 0.0) <= 0:
            raise AssertionError(f"ha q1: {fallbacks:g} host fallbacks, device stages on B "
                                 f"{jobs[1]['metrics'].get('op.DeviceExecute.count', 0.0):g}")
        if on_card and rec["launches"] != int(calls[0]):
            raise AssertionError(f"ha q1: {rec['launches']} grouped_sums launches, the task "
                                 f"statuses both schedulers received report {calls[0]:g} calls")
        if calls[0] <= 0:
            raise AssertionError("ha q1: grouped_sums never called")
        print(f"ha q1: A stopped {stopped - t0:.3f} s after the submit; B adopted the job "
              f"{adopted - stopped:.3f} s after A's stop (lease {HA_LEASE_S:g} s) and finished "
              f"it {ended - stopped:.3f} s after; {jobs[1]['tasks']} tasks, grouped_sums "
              f"launches {rec['launches']}, calls reported {calls[0]:g}, host fallbacks 0, "
              f"rows exact [{tag}]", flush=True)
        out[("ha", "q1", "once")] = {
            "table": table, "wall": ended - t0, "launches": rec["launches"],
            "shapes": rec["shapes"], "presums": rec["presums"], "metrics": jobs[1]["metrics"],
            "job": jobs[1]}
    finally:
        for e in execs:
            e.stop(grace=False)
        b.stop()
        if a is not None:
            a.stop()

    # q3 through a scheduler whose job state is etcd v3, served by the
    # KvServer's gateway
    kv = KvServer(InMemoryKV())
    kv_port = kv.start(0, "127.0.0.1")
    cluster = None
    try:
        cluster = start_standalone_cluster(
            n_executors=2, task_slots=2, device=device, work_dir=os.path.join(work, "etcd"),
            scheduler_config=SchedulerConfig(cluster_backend="etcd",
                                             kv_addr=f"127.0.0.1:{kv_port}"))
        check_executors_report(cluster.scheduler, 2, device, "ha etcd")
        ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
        for name, location in tables.items():
            ctx.register_parquet(name, location)
        sql, expect = want["q3"]
        with counting() as rec:
            t0 = time.time()
            table = ctx.sql(sql).collect()
            wall = time.time() - t0
        check_result(table, expect, exact["q3"], "q3", rec["presums"])
        job = job_summary(cluster.scheduler.tasks.get_job(ctx.last_job_id))
        check_job("ha q3 etcd", job)
        persisted = cluster.scheduler.state_store.list_jobs()
        if ctx.last_job_id not in persisted:
            raise AssertionError(f"ha q3 etcd: job {ctx.last_job_id} not in etcd: {persisted}")
        print(f"ha q3 over the etcd backend: wall {wall:.3f} s, {job['stages']} stages, job "
              f"persisted through the etcd wire, rows exact [{tag}]", flush=True)
        out[("ha", "q3", "once")] = {
            "table": table, "wall": wall, "launches": rec["launches"],
            "shapes": rec["shapes"], "presums": rec["presums"], "metrics": job["metrics"],
            "job": job}
    finally:
        if cluster is not None:
            cluster.stop()
        kv.stop()
    print(f"ha phase {time.time() - t_phase:.1f} s [{tag}]", flush=True)
    return out


def check_same_as_host(label: str, got, host) -> None:
    """Ints and strings equal to the host engine's, floats within 1e-6
    relative (it sums decimals in f64)."""
    for name in got.schema.names:
        g = got.column(name).to_numpy(zero_copy_only=False)
        h = host.column(name).to_numpy(zero_copy_only=False)
        ok = np.allclose(g, h, rtol=1e-6, atol=0) if g.dtype.kind == "f" else \
            np.array_equal(g, h)
        if not ok or len(g) == 0:
            raise AssertionError(f"mesh {label}.{name}: {g.tolist()} vs host {h.tolist()}")


def profile_run(ctx, sql: str, owners: dict = None, work=None) -> dict:
    """One run (``ctx.sql(sql).collect()``, or ``work()`` when it is
    given) under torch.profiler: its wall, the device busy time in it
    (the sum of CUDA kernel and copy time the profiler records), the five
    busiest device ops, and the device time of the kernels launched inside
    each of ``owners`` ({label: (module or class, function name)}; by
    default the join probe, sorted grouping and segment sums), each run
    inside a record_function of its label for this run only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import ballista_tpu_torch.engine.torch_engine as TE
    import ballista_tpu_torch.ops.kernels_torch as KT

    if owners is None:
        owners = {"join probe": (TE, "_probe_join"), "sorted grouping": (KT, "group_ids_sorted"),
                  "segment sums": (KT.SegSums, "compute")}
    saved = []
    for label, (owner, attr) in owners.items():
        real = getattr(owner, attr)

        def inside(*a, _real=real, _label=label, **kw):
            with record_function(_label):
                return _real(*a, **kw)

        saved.append((owner, attr, real))
        setattr(owner, attr, inside)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t0 = time.time()
            if work is None:
                ctx.sql(sql).collect()
            else:
                work()
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        for owner, attr, real in saved:
            setattr(owner, attr, real)
    averages = p.key_averages()
    events = [e for e in averages if e.device_type.name == "CUDA" and e.key not in owners]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    regions = {label: sum(e.device_time_total for e in averages
                          if e.key == label and e.device_type.name == "CPU") / 1e6
               for label in owners}
    return {"wall": wall, "busy": busy_us / 1e6, "regions": regions,
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]}


# ---- 6. timing ---------------------------------------------------------------------
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


def main_runs(results: dict) -> dict:
    """Each (path, query)'s main run: its warm run where it has one, else its
    one run. Its launch count was zeroed just before it and read just after."""
    out = {}
    for (path, q, run), r in results.items():
        if run == "warm" or (path, q, "warm") not in results:
            out[f"{path}/{q}"] = r
    return out


# stages whose eager estimate fell below their measured peak, over every run
# of the script: (run, eager estimate, measured peak); the run fails on any
ESTIMATE_MISSES: list = []


def estimate_summary(tag: str, stage_bytes: list) -> str:
    """Measured peak over estimate, per stage of at least 1 MB estimated or
    measured (below that the allocator's block sizes dominate the peak), for
    the JAX-equal estimate and the eager one; records in ESTIMATE_MISSES
    every such stage whose eager estimate is below its measured peak."""
    big = [(j, e, p) for j, e, p in stage_bytes if max(e, p) >= 1 << 20]
    for j, e, p in big:
        if p > e:
            ESTIMATE_MISSES.append((tag, e, p))

    def spread(ratios):
        ratios = sorted(ratios)
        return (f"median {ratios[len(ratios) // 2]:.3f}, range {ratios[0]:.3f}-"
                f"{ratios[-1]:.3f}" if ratios else "none")

    widest = max(big, key=lambda t: t[1], default=(0, 0, 0))
    return (f"measured / estimated over {len(big)} stages of >= 1 MB: JAX-equal "
            f"{spread(p / max(j, 1) for j, _, p in big)}, eager "
            f"{spread(p / max(e, 1) for _, e, p in big)}; the stage of the largest eager "
            f"estimate: {widest[1]} eager, {widest[0]} JAX-equal, {widest[2]} measured")


def report_run(path: str, q: str, run: str, r: dict, card: str) -> None:
    m = r["metrics"]
    fused = {k.split(".")[1]: m.get(k, 0.0) for k in FUSED_KEYS}
    budget = r["report"].budget_bytes if r["report"] is not None else 0
    print(f"{path} {q} {run}: device budget {budget} bytes, largest stage estimate "
          f"(op.HbmEst.max_bytes) {m.get('op.HbmEst.max_bytes', 0.0):.0f}, eager "
          f"(op.HbmEstEager.max_bytes) {m.get('op.HbmEstEager.max_bytes', 0.0):.0f}, largest "
          f"stage peak measured (op.HbmPeak.max_bytes) {m.get('op.HbmPeak.max_bytes', 0.0):.0f}"
          f"; {estimate_summary(f'{path} {q} {run}', r['stage_bytes'])}; paged joins "
          f"{m.get('op.PagedJoin.count', 0.0):g} in {m.get('op.PagedJoin.passes', 0.0):g} "
          f"passes [{card}]", flush=True)
    print(f"{path} {q} {run}: wall {r['wall']:.3f} s, device stages "
          f"{m.get('op.DeviceExecute.count', 0.0):g}, grouped_sums launches "
          f"{r['launches']} (aggregate stages of k <= 32: {r['small_k_stages']}), "
          f"fused {fused}, tiny stages {m.get('op.HostTinyStage.count', 0.0):g}, "
          f"host fallbacks {m.get('op.HostFallback.count', 0.0):g}, cache (hits, misses) "
          f"{r['cache']}, batches encoded {len(r['encoded'])}, peak device memory "
          f"{r['peak_bytes'] / 1e6:.1f} MB ({r['base_bytes'] / 1e6:.1f} MB allocated "
          f"before the run) [{card}]", flush=True)


def report_runs(results: dict, prof: dict, card: str) -> None:
    for (path, q, run), r in results.items():
        print(f"{path} {q} {run}, all operator metrics: {r['metrics']}", flush=True)
        if run in ("warm", "once") or path == "unfused":
            print(f"{path} {q} {run}, grouped_sums shapes (n, k, columns, dtype): calls "
                  f"{ {str(s): c for s, c in r['shapes'].items()} }; presum_safe scales "
                  f"(in, out): {sorted(set(r['presums']), key=str)}", flush=True)
    for (path, q), p in prof.items():
        regions = {k: f"{v * 1e3:.3f} ms = {100 * v / max(p['busy'], 1e-12):.1f}% of busy"
                   for k, v in p["regions"].items() if v}
        print(f"{path} {q} profiled run: device busy {p['busy'] * 1e3:.3f} ms = "
              f"{100 * p['busy'] / p['wall']:.2f}% of that run's wall {p['wall']:.3f} s; "
              f"busiest (name, calls, ms): {p['top']}; kernels inside {regions} [{card}]",
              flush=True)


def rehearse(data_dir: str, parts: int = 2) -> None:
    """The hash, slice, windows, staged, distributed (with flightsql),
    surfaces, mesh, multihost, avro and ha phases on the CPU over the TPC-H
    tables under
    ``data_dir`` (the tests' SF 0.01, ``parts`` files per large table:
    ``tests/.data/torch_tpch_sf001``):

        PYTHONPATH=. python3 -c "import chip_smoke as cs; cs.rehearse('tests/.data/torch_tpch_sf001')"

    On the CPU the wrapper runs grouped_sums' plain version and counts no
    launch, so each call counts as one here."""
    import ballista_tpu_torch.ops.grouped_sums as GS
    from ballista_tpu_torch.models.tpch import TPCH_TABLES

    real = GS.grouped_sums_multi

    def counted(*args):
        if not GS.is_warming():
            GS.launches += 1
        return real(*args)

    tables = {t: os.path.join(data_dir, t) for t in TPCH_TABLES}
    GS.grouped_sums_multi = counted
    try:
        check_hash_buckets("cpu", tables)
        check_native_partition(tables, "cpu")
        refs = references(tables)
        results, _ = run_slice("cpu", tables, 0.01, parts, "cpu", refs=refs)
        results.update(run_windows("cpu", tables, "cpu")[0])
        results.update(run_staged_phase("cpu", tables, "cpu", refs, small=True)[0])
        results.update(run_distributed_phase("cpu", tables, "cpu", refs))
        results.update(run_surfaces_phase("cpu", tables, "cpu", refs))
        results.update(run_mesh_phase("cpu", tables, 0.01, "cpu", refs, results, 1 << 16))
        results.update(run_multihost_phase("cpu", tables, 0.01, "cpu", refs, results))
        results.update(run_avro_phase("cpu", tables, "cpu"))
        results.update(run_ha_phase("cpu", tables, "cpu", refs))
    finally:
        GS.grouped_sums_multi = real
    report_runs(results, {}, "cpu")
    print(f"grouped_sums calls by path: "
          f"{ {k: r['launches'] for k, r in main_runs(results).items()} }", flush=True)


def main() -> int:
    started = time.time()
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {kind}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}", flush=True)

    from ballista_tpu_torch import native
    from ballista_tpu_torch.ops import cuda_build

    phase("build")
    t0 = time.time()
    took = cuda_build.build()
    for name, s in took.items():
        print(f"built {name} in {s:.1f} s", flush=True)
        for line in cuda_build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {line.strip()}")
    t1 = time.time()
    native.build()
    print(f"built native/partition.cpp with g++ in {time.time() - t1:.1f} s (host code)",
          flush=True)
    print(f"build total {time.time() - t0:.1f} s", flush=True)

    phase("kernels")
    max_err = 0.0
    for n, k, seed in ((1 << 21, 12, 1), (5000, 7, 2), (4097, 1, 3), (4097, 32, 4)):
        max_err = max(max_err, check_grouped_sums(n, k, seed, "cuda"))
    max_err = max(max_err, check_multi_shapes("cuda"))

    phase("hash")
    tables = tpch_tables(DATA_DIR, SF, PARTS)
    check_hash_buckets("cuda", tables)
    check_native_partition(tables, card)

    phase("slice")
    t0 = time.time()
    refs = references(tables)
    results, prof = run_slice("cuda", tables, SF, PARTS, card, profile=True, refs=refs)
    print(f"slice phase {time.time() - t0:.1f} s", flush=True)

    phase("windows")
    t0 = time.time()
    wresults, wprof = run_windows("cuda", tables, card, profile=True)
    results.update(wresults)
    prof.update(wprof)
    print(f"windows phase {time.time() - t0:.1f} s", flush=True)

    phase("staged")
    t0 = time.time()
    sresults, sprof = run_staged_phase("cuda", tables, card, refs, profile=True)
    results.update(sresults)
    prof.update(sprof)
    print(f"staged phase {time.time() - t0:.1f} s", flush=True)

    phase("distributed")
    t0 = time.time()
    results.update(run_distributed_phase("cuda", tables, card, refs))
    print(f"distributed phase {time.time() - t0:.1f} s [{card}]", flush=True)

    phase("surfaces")
    results.update(run_surfaces_phase("cuda", tables, card, refs))

    phase("mesh")
    results.update(run_mesh_phase("cuda", tables, SF, card, refs, results, 1 << 23))

    phase("multihost")
    results.update(run_multihost_phase("cuda", tables, SF, card, refs, results))

    phase("avro")
    results.update(run_avro_phase("cuda", tables, card))

    phase("ha")
    results.update(run_ha_phase("cuda", tables, card, refs))
    report_runs(results, prof, card)
    if ESTIMATE_MISSES:
        for miss in ESTIMATE_MISSES:
            print(f"eager estimate below the measured peak: {miss}", flush=True)
        raise AssertionError(f"{len(ESTIMATE_MISSES)} stages of >= 1 MB measured above their "
                             "eager estimate")
    mains = main_runs(results)
    by_path = {k: r["launches"] for k, r in mains.items()}
    print(f"grouped_sums launches on each path's main run: {by_path}", flush=True)
    shapes: dict = {}
    for r in results.values():
        for s, c in r["shapes"].items():
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
    # (b) the largest and (c) the smallest stage of q1's warm run: the fused
    # program's partial aggregate and final merge; (d) the largest stage of
    # q1's unfused run, the partial stage of the unfused path
    picks = (("q1_stage", ("default", "q1", "warm"), max),
             ("q1_final_stage", ("default", "q1", "warm"), min),
             ("q1_unfused_stage", ("unfused", "q1", "cold"), max))
    for label, run, pick in picks:
        n, k, ncols, dtype = pick(results[run]["shapes"], key=lambda s: (s[0], s[2]))
        ids, vals, valid = stage_inputs(n, k, ncols, 8, "cuda", dtype=dtype)
        timed[label] = time_grouped_sums(ids, vals, [valid] * ncols, k)
    # (e) a stage wider than one launch takes at k = 32 (not on q1's path)
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
    print(f"chip_smoke: {time.time() - started:.1f} s from start to the kernels line [{card}]",
          flush=True)

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
