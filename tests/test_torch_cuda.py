"""The PyTorch port on the card: the CUDA kernel and the engine on ``cuda``.

These tests need an NVIDIA GPU and nvcc, and skip without them (a CUDA
kernel has no CPU mode). They import nothing of JAX, so they also run where
JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int64 results exact, float32 within rtol 1e-5 of the plain
version (the same f32 values summed in another order), and bitwise equal
between two runs of the kernel (it uses no atomics). Engine results: ints,
strings and the decimal sums equal the port's CPU run exactly (both sum
scaled int64), AVG within 1e-6 relative.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, k, seed, device):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, k, n).astype(np.int64)
    trash = rng.random(n) < 0.1
    ids[trash] = rng.choice(np.array([-1, k, k + 5]), int(trash.sum()))
    valid = rng.random(n) < 0.8
    ivals = rng.integers(-(10**12), 10**12, n).astype(np.int64)
    fvals = rng.random(n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (ids, valid, ivals, fvals)]


@pytest.mark.parametrize("n,k", [(5000, 7), (1 << 21, 12), (4097, 1), (4097, 32), (0, 3)])
def test_grouped_sums_kernel_matches_plain_version(card, n, k):
    from ballista_tpu_torch.ops import grouped_sums as GS

    ids, valid, ivals, fvals = _inputs(n, k, 11, card)
    before = GS.launches
    gi = GS.grouped_sums(ivals, ids, valid, k)
    gc = GS.grouped_sums(valid.to(torch.int64), ids, valid, k)
    gf = GS.grouped_sums(fvals, ids, valid, k)
    gf2 = GS.grouped_sums(fvals, ids, valid, k)
    torch.cuda.synchronize()
    assert GS.launches == before + 4
    assert gi.dtype == torch.int64 and gf.dtype == torch.float32
    assert torch.equal(gi, GS.grouped_sums_ref(ivals, ids, valid, k))
    assert torch.equal(gc, GS.grouped_sums_ref(valid.to(torch.int64), ids, valid, k))
    assert torch.allclose(gf, GS.grouped_sums_ref(fvals, ids, valid, k), rtol=1e-5)
    assert torch.equal(gf, gf2)


def _columns(n, k, ncols, seed, device, offset=0):
    """ids with trash, three masks, and ncols int64 columns (every third a
    count) plus ncols f32 columns; each array a view that starts ``offset``
    rows into its storage."""
    rng = np.random.default_rng(seed)
    m = n + offset
    ids = rng.integers(0, k, m).astype(np.int64)
    trash = rng.random(m) < 0.1
    ids[trash] = rng.choice(np.array([-1, k, k + 5]), int(trash.sum()))
    masks = [rng.random(m) < p for p in (0.8, 0.5, 0.95)]
    to = lambda a: torch.from_numpy(a).to(device)[offset:]  # noqa: E731
    ivals = [None if c % 3 == 1 else to(rng.integers(-(10**12), 10**12, m).astype(np.int64))
             for c in range(ncols)]
    fvals = [to(rng.random(m).astype(np.float32)) for _ in range(ncols)]
    tm = [to(x) for x in masks]
    col_masks = [tm[c * 3 // ncols] for c in range(ncols)]  # neighbours share masks
    return to(ids), col_masks, ivals, fvals


def _launches_per_call(GS, ids, masks, k, is_f32):
    """The launches one call makes: one, unless its columns are more than
    the kernel's limit at this k (asked of the kernel on the first call)."""
    limit = GS._max_columns[(ids.device.index, is_f32, k)]
    first: dict = {}
    keys = sorted((first.setdefault(m.data_ptr(), c) for c, m in enumerate(masks)))
    return len(GS.column_chunks(keys, limit))


@pytest.mark.parametrize("n", [0, 5, 4097, 1 << 21])
@pytest.mark.parametrize("k", [1, 7, 12, 32])
@pytest.mark.parametrize("ncols", [1, 3, 8, 16])
def test_multi_column_kernel_matches_plain_version(card, n, k, ncols):
    """One launch per call where the columns fit one (every case but int64
    at k = 32 with 8 or 16 columns, and f32 at k = 32 with 16)."""
    from ballista_tpu_torch.ops import grouped_sums as GS

    ids, masks, ivals, fvals = _columns(n, k, ncols, n + 31 * k + ncols, card)
    before = GS.launches
    gi = GS.grouped_sums_multi(ivals, masks, ids, k)
    gf = GS.grouped_sums_multi(fvals, masks, ids, k)
    gf2 = GS.grouped_sums_multi(fvals, masks, ids, k)
    torch.cuda.synchronize()
    assert GS.launches == before + _launches_per_call(GS, ids, masks, k, 0) \
        + 2 * _launches_per_call(GS, ids, masks, k, 1)
    if ncols <= 3 or k < 32:
        assert GS.launches == before + 3  # one launch per call
    assert gi.dtype == torch.int64 and tuple(gi.shape) == (ncols, k)
    assert torch.equal(gi, GS.grouped_sums_multi_ref(ivals, masks, ids, k))
    assert torch.allclose(gf, GS.grouped_sums_multi_ref(fvals, masks, ids, k), rtol=1e-5)
    assert torch.equal(gf, gf2)  # bitwise, run to run


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_multi_column_kernel_on_unaligned_views(card, offset):
    """Views whose data starts off a 16-byte boundary: the same offset on
    every array (a head of rows, then 16-byte loads), and masks shifted
    against ids (one row at a time throughout)."""
    from ballista_tpu_torch.ops import grouped_sums as GS

    n, k = 100_003, 12
    ids, masks, ivals, fvals = _columns(n, k, 5, offset, card, offset=offset)
    for cols in (ivals, fvals):
        got = GS.grouped_sums_multi(cols, masks, ids, k)
        want = GS.grouped_sums_multi_ref(cols, masks, ids, k)
        assert torch.equal(got, want) if got.dtype == torch.int64 else \
            torch.allclose(got, want, rtol=1e-5)
    ids2, _, _, _ = _columns(n, k, 5, offset, card)
    got = GS.grouped_sums_multi(ivals, masks, ids2, k)
    assert torch.equal(got, GS.grouped_sums_multi_ref(ivals, masks, ids2, k))


@pytest.mark.parametrize("ncols,k", [(32, 32), (33, 12), (40, 32), (40, 1)])
def test_wide_calls_split_into_launches(card, ncols, k):
    """More columns than one launch takes (at k = 32 the slots allow 6
    int64 or 13 f32 columns; the parameter block holds 32): the wrapper
    splits the call, a mask's columns together, and the sums still equal
    the plain version's; f32 bitwise run to run."""
    from ballista_tpu_torch.ops import grouped_sums as GS

    ids, masks, ivals, fvals = _columns(100_003, k, ncols, ncols + k, card)
    before = GS.launches
    gi = GS.grouped_sums_multi(ivals, masks, ids, k)
    mid = GS.launches
    gf = GS.grouped_sums_multi(fvals, masks, ids, k)
    gf2 = GS.grouped_sums_multi(fvals, masks, ids, k)
    torch.cuda.synchronize()
    assert mid - before == _launches_per_call(GS, ids, masks, k, 0) > 1
    assert GS._max_columns[(ids.device.index, 0, k)] <= 32
    assert torch.equal(gi, GS.grouped_sums_multi_ref(ivals, masks, ids, k))
    assert torch.allclose(gf, GS.grouped_sums_multi_ref(fvals, masks, ids, k), rtol=1e-5)
    assert torch.equal(gf, gf2)


def test_grouped_sums_rejects_what_the_kernel_does_not_take(card):
    from ballista_tpu_torch.ops import grouped_sums as GS

    ids, valid, ivals, _ = _inputs(64, 4, 1, card)
    with pytest.raises(ValueError):
        GS.grouped_sums(ivals, ids, valid, 33)
    with pytest.raises(TypeError):
        GS.grouped_sums(ivals.to(torch.float64), ids, valid, 4)
    with pytest.raises(ValueError):
        GS.grouped_sums(ivals[::2], ids[::2], valid[::2], 4)
    with pytest.raises(TypeError):
        GS.grouped_sums_multi([ivals, None], [valid, valid.to(torch.int64)], ids, 4)
    with pytest.raises(ValueError):
        GS.grouped_sums_multi([], [], ids, 4)


def _assert_rows_match(got, want, averages):
    """The columns named in ``averages`` within 1e-6 relative, every other
    column exactly."""
    assert got.schema == want.schema and got.num_rows == want.num_rows
    for name in got.column_names:
        g = got.column(name).to_numpy(zero_copy_only=False)
        w = want.column(name).to_numpy(zero_copy_only=False)
        if name in averages:
            assert np.allclose(g, w, rtol=1e-6), name
        else:
            assert np.array_equal(g, w), name


def test_wide_aggregate_on_card_matches_cpu(card, tmp_path):
    """Twenty AVGs, two SUMs and a COUNT: each final stage gives grouped_sums
    44 int64 columns, which the wrapper splits into launches. Rows equal the
    port's CPU run (AVG within 1e-6 relative, the rest exact)."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.models.tpch import generate_tpch
    from ballista_tpu_torch.ops import grouped_sums as GS

    lineitem = generate_tpch(str(tmp_path), sf=0.01, tables=["lineitem"],
                             parts_per_table=2)["lineitem"]
    aggs = [f"avg(l_quantity + {i}) as a{i}" for i in range(20)]
    aggs += ["sum(l_extendedprice) as s0", "sum(l_discount) as s1", "count(*) as n"]
    sql = (f"select l_returnflag, l_linestatus, {', '.join(aggs)} from lineitem "
           "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
    # the unfused path: 16 final aggregate stages, each split
    unfused = BallistaConfig({"ballista.tpu.ici_shuffle": "false"})
    on_card = BallistaContext.standalone(unfused)
    on_cpu = BallistaContext.standalone(unfused, device="cpu")
    for c in (on_card, on_cpu):
        c.register_parquet("lineitem", lineitem)
    GS.launches = 0
    got = on_card.sql(sql).collect()
    m = on_card.last_engine_metrics
    assert m.get("op.HostFallback.count", 0.0) == 0.0
    assert GS.launches > m["op.DeviceExecute.count"]  # the final stages split
    _assert_rows_match(got, on_cpu.sql(sql).collect(), {f"a{i}" for i in range(20)})


def test_q1_q6_on_card_match_cpu(card, tmp_path):
    """At SF 0.01 in 2 files, one launch per aggregate stage. The fused path
    (the default): q1's one program 2 (partial and final), cold and warm;
    q6 (a global aggregate, not fused) 2 partial + 1 final = 3. With
    ``ici_shuffle=false``: q1 2 partial + 16 final = 18."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.models.tpch import generate_tpch
    from ballista_tpu_torch.ops import grouped_sums as GS

    lineitem = generate_tpch(str(tmp_path), sf=0.01, tables=["lineitem"],
                             parts_per_table=2)["lineitem"]
    on_card = BallistaContext.standalone()
    unfused = BallistaContext.standalone(BallistaConfig({"ballista.tpu.ici_shuffle": "false"}))
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, unfused, on_cpu):
        c.register_parquet("lineitem", lineitem)
    for ctx, q, launches in ((on_card, "q1", 2), (on_card, "q1", 2), (on_card, "q6", 3),
                             (unfused, "q1", 18)):
        with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        GS.launches = 0
        got = ctx.sql(sql).collect()
        assert GS.launches == launches, q
        assert ctx.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
        _assert_rows_match(got, on_cpu.sql(sql).collect(),
                           {n for n in got.column_names if n.startswith("avg")})


@pytest.mark.parametrize("scale", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("ft", [torch.float32, torch.float64])
def test_as_float_on_card_bit_identical_to_cpu(card, scale, ft):
    """Scaled int64 to float on the card: the same bits as on the CPU (which
    the CPU tests hold to the JAX package's ``_as_float``); a division by a
    Python scalar would be a multiply by its reciprocal here."""
    from ballista_tpu_torch.ops import kernels_torch as KT

    rng = np.random.default_rng(40 + scale)
    data = torch.from_numpy(rng.integers(-(10**15), 10**15, 1 << 20).astype(np.int64))
    col = lambda t: KT.DeviceCol(KT.DataType.FLOAT64, t, scale=scale)  # noqa: E731
    got = KT._as_float(col(data.to(card)), ft).cpu()
    want = KT._as_float(col(data), ft)
    assert got.dtype == want.dtype == ft
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.fixture(scope="module")
def sf001_tables(tmp_path_factory):
    from ballista_tpu_torch.models.tpch import generate_tpch

    return generate_tpch(str(tmp_path_factory.getbasetemp() / "tpch_sf001"), sf=0.01,
                         parts_per_table=2)


@pytest.mark.parametrize("q", ["q1", "q5"])
def test_fused_queries_on_card_match_cpu(card, sf001_tables, q):
    """The fused exchange on the card (its final aggregate over 16
    partitions as one program), cold and warm, against the CPU run; the
    warm run reads its input from the device cache."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.engine import torch_engine as TE

    on_card = BallistaContext.standalone()
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, on_cpu):
        for t, path in sf001_tables.items():
            c.register_parquet(t, path)
    with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
        sql = f.read()
    want = on_cpu.sql(sql).collect()
    TE.clear_caches()
    sent = []
    for _run in ("cold", "warm"):
        got = on_card.sql(sql).collect()
        m = on_card.last_engine_metrics
        assert m.get("op.FusedIciExchange.count", 0.0) == 16.0
        assert m.get("op.HostFallback.count", 0.0) == 0.0
        sent.append(m["op.DeviceTransfer.bytes"])
        _assert_rows_match(got, want, {n for n in got.column_names if n.startswith("avg")})
    assert sent[1] < 0.01 * sent[0]


def test_cpu_and_cuda_engines_share_no_cache_entry(card, sf001_tables):
    """q1 and q3 on a CPU engine and a CUDA engine in one process: every
    device-cache entry names one device and holds tensors on it only."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.engine import torch_engine as TE

    TE.clear_caches()
    ctxs = {"cpu": BallistaContext.standalone(device="cpu"), "cuda": BallistaContext.standalone()}
    for c in ctxs.values():
        for t, path in sf001_tables.items():
            c.register_parquet(t, path)
    for q in ("q1", "q3"):
        with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        for c in ctxs.values():
            c.sql(sql).collect()
    seen = set()
    for key, tensors in TE._DEV_CACHE._entries.items():
        device = torch.device(key[1])
        assert all(t.device.type == device.type for t in tensors), key
        seen.add(device.type)
    assert seen == {"cpu", "cuda"}


# ---- joins and hashing on the card --------------------------------------------------
def test_splitmix64_and_hash_buckets_on_card_match_numpy(card):
    """The int64 splitmix64 and the uint64 bucket of ``hash_bucket_dev`` on
    2^21 random rows and the edge values, bit-identical to ``kernels_np``;
    then whole batches (ints with nulls, a decimal, strings with nulls,
    dates) bucketed as ``hash_partition_indices`` buckets them."""
    import pyarrow as pa

    from ballista_tpu_torch.ops import kernels_np as KNP
    from ballista_tpu_torch.ops import kernels_torch as KT
    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan.expr import Col

    i64 = np.iinfo(np.int64)
    rng = np.random.default_rng(3)
    x = np.concatenate([np.array([0, -1, i64.min, i64.max, 1, i64.min + 1], np.int64),
                        rng.integers(i64.min, i64.max, 1 << 21, dtype=np.int64, endpoint=True)])
    mixed = KT.splitmix64_dev(torch.from_numpy(x).to(card))
    want = KNP.splitmix64(x.view(np.uint64))
    assert np.array_equal(mixed.cpu().numpy(), want.view(np.int64))
    for n in (1, 3, 16, 1000):
        got = KT._umod(mixed, n).cpu().numpy()
        assert np.array_equal(got, (want % np.uint64(n)).astype(np.int64)), n

    m = 1 << 20
    table = pa.table({
        "i": pa.array(rng.integers(-(10**15), 10**15, m), mask=rng.random(m) < 0.1),
        "dec": pa.array(np.round(rng.uniform(-1e5, 1e5, m), 2)),
        "s": pa.array(rng.choice(np.array(["MAIL", "SHIP", "AIR", ""], object), m).tolist(),
                      mask=rng.random(m) < 0.1),
        "d": pa.array(rng.integers(8000, 10500, m).astype(np.int32)).cast(pa.date32()),
    })
    batch = ColumnBatch.from_arrow(table)
    db = KT.to_device(batch, card)
    for keys in (["i"], ["dec"], ["s"], ["d"], ["i", "s", "dec", "d"]):
        for n in (3, 16, 1000):
            got = KT.hash_bucket_dev(db, [db.col(k) for k in keys], n)
            want = KNP.hash_partition_indices(batch, [Col(k) for k in keys], n)
            assert np.array_equal(got.cpu().numpy()[:m], want), (keys, n)


@pytest.mark.parametrize("q", ["q3", "q5", "q13", "q18", "q21"])
def test_join_queries_on_card_match_cpu(card, tmp_path_factory, q):
    """Joins, sorted grouping and semi/anti probes on the card, against the
    port's CPU run on the same SF 0.01 data: every value equal (the decimal
    sums are scaled int64 on both), AVG within 1e-6 relative; no host
    fallback."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.models.tpch import TPCH_TABLES, generate_tpch

    data = generate_tpch(str(tmp_path_factory.getbasetemp() / "tpch_sf001"), sf=0.01,
                         parts_per_table=2)
    on_card = BallistaContext.standalone()
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, on_cpu):
        for t in TPCH_TABLES:
            c.register_parquet(t, data[t])
    with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
        sql = f.read()
    got = on_card.sql(sql).collect()
    assert on_card.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
    _assert_rows_match(got, on_cpu.sql(sql).collect(),
                       {n for n in got.column_names if n.startswith("avg")})


@pytest.mark.parametrize("how", ["right", "full"])
def test_outer_joins_with_duplicate_runs_on_card_match_cpu(card, how):
    """Right and full joins (partitioned builds) over build keys with runs of
    1-20 rows and NULL keys, with and without a join filter: the same rows
    on the card as on the CPU."""
    import pyarrow as pa

    from ballista_tpu_torch.client.context import BallistaContext

    rng = np.random.default_rng(4)
    n = 5000
    probe = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "k": pa.array(rng.integers(0, 300, n), mask=rng.random(n) < 0.1),
        "v": pa.array(np.round(rng.uniform(0, 100, n), 2)),
    })
    keys = np.repeat(np.arange(250), rng.integers(1, 21, 250))
    build = pa.table({
        "k": pa.array(rng.permutation(keys), mask=rng.random(len(keys)) < 0.05),
        "w": pa.array(rng.integers(0, 100, len(keys))),
    })
    on_card = BallistaContext.standalone()
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, on_cpu):
        c.register_arrow("a", probe, partitions=2)
        c.register_arrow("b", build, partitions=2)
    for filt in ("", " and b.w < a.v"):
        sql = f"select a.id, a.v, b.k, b.w from a {how} join b on a.k = b.k{filt}"
        got = on_card.sql(sql).collect()
        assert on_card.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
        assert _sorted_rows(got) == _sorted_rows(on_cpu.sql(sql).collect()), sql


@pytest.mark.parametrize("q", ["W1", "W3"])
def test_windows_on_card_match_cpu(card, sf001_tables, q):
    """chip_smoke's W1 (the top line per order: row_number over two order
    keys, a filter and a global aggregate) and W3 (moving ROWS frames, the
    sparse table's max, a RANGE frame over a decimal key) on the card
    against the CPU run: every value equal (decimal sums, maxima and
    averages are exact scaled int64 on both)."""
    from chip_smoke import WINDOW_QUERIES

    from ballista_tpu_torch.client.context import BallistaContext

    on_card = BallistaContext.standalone()
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, on_cpu):
        for t, path in sf001_tables.items():
            c.register_parquet(t, path)
    got = on_card.sql(WINDOW_QUERIES[q]).collect()
    m = on_card.last_engine_metrics
    assert m.get("op.HostFallback.count", 0.0) == 0.0
    assert m.get("op.HbmPeak.max_bytes", 0.0) > 0 and m.get("op.HbmEst.max_bytes", 0.0) > 0
    assert _sorted_rows(got) == _sorted_rows(on_cpu.sql(WINDOW_QUERIES[q]).collect())


def test_paged_join_on_card_matches_unpaged(card, sf001_tables):
    """q3 with its joins partitioned, under a budget that pages the
    lineitem-orders join: the same rows as without a budget, every pass on
    the card."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig

    settings = {"ballista.optimizer.broadcast_rows_threshold": "0",
                "ballista.tpu.ici_shuffle": "false",
                "ballista.engine.max_shuffle_partitions": "16"}
    with open(os.path.join(REPO, "benchmarks", "queries", "q3.sql")) as f:
        sql = f.read()
    out = {}
    for budget in ("-1", "100000"):
        ctx = BallistaContext.standalone(
            BallistaConfig(dict(settings, **{"ballista.engine.hbm_budget_bytes": budget})))
        for t, path in sf001_tables.items():
            ctx.register_parquet(t, path)
        out[budget] = (ctx.sql(sql).collect(), ctx)
    (plain, _), (paged, pctx) = out["-1"], out["100000"]
    m = pctx.last_engine_metrics
    assert "paged" in [d.action for d in pctx.last_memory_report.decisions]
    assert m.get("op.PagedJoin.count", 0.0) >= 1 and m.get("op.PagedJoin.passes", 0.0) >= 2
    assert m.get("op.HostFallback.count", 0.0) == 0.0
    assert paged.equals(plain)


def _sorted_rows(table) -> list:
    rows = list(zip(*(table.column(c).to_pylist() for c in table.column_names)))
    return sorted(rows, key=lambda r: tuple((v is None, v if v is not None else 0) for v in r))


# ---- device streaming on the card -----------------------------------------------------
def _probe_join_over_shuffle(tmp_path, n=60_000, pieces=4, seed=41):
    """A collected-build inner join over a one-output shuffle of ``n`` rows
    written in ``pieces`` map pieces by the port's writer."""
    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan import physical as P
    from ballista_tpu_torch.plan.expr import Col
    from ballista_tpu_torch.shuffle.writer import write_shuffle_partitions

    rng = np.random.default_rng(seed)
    batch = ColumnBatch.from_dict({"k": rng.integers(0, 97, n).astype(np.int64),
                                   "v": rng.normal(size=n)})
    build = ColumnBatch.from_dict({"bk": np.arange(97, dtype=np.int64),
                                   "w": rng.normal(size=97)})
    wplan = P.ShuffleWriterExec("jcard", 3, P.MemoryScanExec([batch], batch.schema),
                                P.HashPartitioning((Col("k"),), 1))
    step = n // pieces
    locs = []
    for m in range(pieces):
        for s in write_shuffle_partitions(wplan, m, batch.slice(m * step, step), str(tmp_path)):
            locs.append({"path": s.path, "host": "h", "flight_port": 0, "executor_id": "e",
                         "stage_id": 3, "map_partition": m})
    reader = P.ShuffleReaderExec(3, batch.schema, [locs])
    return P.HashJoinExec(left=reader, right=P.MemoryScanExec([build], build.schema),
                          on=[(Col("k"), Col("bk"))], how="inner", collect_build=True)


def _stream_engine(device, depth):
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine.torch_engine import TorchEngine

    return TorchEngine(BallistaConfig({"ballista.shuffle.stream_chunk_rows": "4096",
                                       "ballista.tpu.stream_device_rows": "8192",
                                       "ballista.engine.prefetch_depth": str(depth)}),
                       device=device)


def test_side_stream_prefetch_gives_the_chunks_of_depth_zero(card, tmp_path):
    """Chunks copied ahead on the side stream give the rows of the
    synchronous path, every chunk through the prefetch, none failed."""
    import pyarrow as pa

    plan = _probe_join_over_shuffle(tmp_path)
    runs = {}
    for depth in (0, 2):
        eng = _stream_engine(str(card), depth)
        out = [b.to_arrow() for b in eng.execute_partition_stream(plan, 0)]
        runs[depth] = (pa.concat_tables(out).sort_by([("k", "ascending"), ("v", "ascending")]),
                       eng.op_metrics)
    assert runs[2][0].equals(runs[0][0])
    m = runs[2][1]
    assert m["op.StreamChunk.count"] == runs[0][1]["op.StreamChunk.count"] == 4
    assert m["op.PrefetchH2D.count"] == m["op.PrefetchEncode.count"] == 4
    assert m.get("op.PrefetchEncode.failed", 0.0) == 0.0
    assert m.get("op.HostFallback.count", 0.0) == 0.0


def test_record_stream_keeps_a_prefetched_tensor_alive(card, tmp_path):
    """A chunk's tensors, copied on the side stream and freed while the
    compute stream still reads them, are not handed out again by the
    caching allocator until that read has run: a forced ``empty_cache`` and
    fresh side-stream allocations filled with junk leave the read intact."""
    plan = _probe_join_over_shuffle(tmp_path)
    eng = _stream_engine(str(card), 2)
    chunks = eng._pipelined_chunks(eng._chunk_source(plan), 0)
    try:
        chunk = next(chunks)
        enc = chunk._pre_enc
        expected = [torch.from_numpy(np.ascontiguousarray(a)) for a in enc.arrays]
        tensors, done = enc._pre_dev
        enc._pre_dev = None
        got = eng._await_prefetched(tensors, done)
        torch.cuda._sleep(200_000_000)          # the compute stream is busy
        reads = [t.clone() for t in got]        # queued behind the spin
        del got, tensors
        torch.cuda.empty_cache()
        with torch.cuda.stream(eng._copy_stream):
            junk = [torch.full_like(r, 7) for r in reads]
        torch.cuda.synchronize()
        assert junk
        for r, e in zip(reads, expected):
            assert torch.equal(r.cpu(), e)
    finally:
        chunks.close()


def test_merge_mode_on_card_matches_the_host_fold(card):
    """A merge-mode fold of partial states on the card equals
    ``kernels_np.merge_partial_states``: decimal sums and counts exactly,
    in one grouped_sums launch; f64 sums within 1e-9."""
    from ballista_tpu_torch.engine.torch_engine import TorchEngine
    from ballista_tpu_torch.ops import grouped_sums as GS
    from ballista_tpu_torch.ops import kernels_np as K
    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan import physical as P
    from ballista_tpu_torch.plan.expr import Agg, Alias, Col

    rng = np.random.default_rng(31)
    n = 200_000
    raw = ColumnBatch.from_dict({"g": rng.integers(0, 7, n).astype(np.int64),
                                 "d": rng.integers(-10**7, 10**7, n) / 100,
                                 "x": rng.normal(size=n)})
    aggs = [Alias(Agg("sum", Col("d")), "sd"), Alias(Agg("avg", Col("d")), "ad"),
            Alias(Agg("sum", Col("x")), "sx"), Alias(Agg("max", Col("x")), "mx"),
            Alias(Agg("count_star", None), "c")]
    parts = [raw.slice(i, n // 8) for i in range(0, n, n // 8)]
    # the device's partial states (exact decimals), computed on the CPU
    partial = TorchEngine(device="cpu").execute_all(P.HashAggregateExec(
        P.MemoryScanExec(parts, raw.schema), "partial", [Col("g")], aggs))
    states = ColumnBatch.concat(partial)
    merge = P.HashAggregateExec(P.MemoryScanExec([states], states.schema), "merge",
                                [Col("g")], aggs)
    GS.launches = 0
    eng = TorchEngine(device=str(card))
    dev = eng.execute_partition(merge, 0).to_arrow().sort_by("g")
    assert GS.launches == 1
    assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0
    host = K.merge_partial_states(states, [Col("g")], aggs).to_arrow().sort_by("g")
    for c in dev.column_names:
        if c in ("sx#sum", "mx#max"):
            np.testing.assert_allclose(dev.column(c).to_numpy(), host.column(c).to_numpy(),
                                       rtol=1e-9)
        elif c in ("sd#sum", "ad#sum"):
            # exact decimals: the device's scaled int64 sum, descaled once
            exact = [round(v * 100) for v in host.column(c).to_pylist()]
            assert [round(v * 100) for v in dev.column(c).to_pylist()] == exact, c
        else:
            assert dev.column(c).to_pylist() == host.column(c).to_pylist(), c


def test_two_executors_on_card_run_q1_with_launches_counted(card, sf001_tables, tmp_path):
    """q1 through the port's scheduler and two in-process torch executors on
    ``cuda`` (one CUDA context and one launch count between them): the rows
    of the port's CPU run, and grouped_sums launched exactly as often as the
    job graph's tasks report grouped_sums calls (``op.GroupedSums.calls``)."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.client.standalone import start_standalone_cluster
    from ballista_tpu_torch.ops import grouped_sums as GS

    on_cpu = BallistaContext.standalone(device="cpu")
    for t, path in sf001_tables.items():
        on_cpu.register_parquet(t, path)
    with open(os.path.join(REPO, "benchmarks", "queries", "q1.sql")) as f:
        sql = f.read()
    want = on_cpu.sql(sql).collect()
    cluster = start_standalone_cluster(n_executors=2, task_slots=2, work_dir=str(tmp_path))
    try:
        ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
        for t, path in sf001_tables.items():
            ctx.register_parquet(t, path)
        GS.launches = 0
        got = ctx.sql(sql).collect()
        launches = GS.launches
        graph = cluster.scheduler.tasks.get_job(ctx.last_job_id)
        calls = sum(s.stage_metrics.get("op.GroupedSums.calls", 0.0)
                    for s in graph.stages.values())
        assert all(s.stage_metrics.get("op.HostFallback.count", 0.0) == 0.0
                   for s in graph.stages.values())
    finally:
        cluster.stop()
    _assert_rows_match(got, want, {n for n in got.column_names if n.startswith("avg")})
    assert launches == calls > 0


def test_exchange_on_four_shards_of_the_card_matches_one_shard(card):
    """The hash exchange over four shards of the card (four threads and
    streams, ``parallel.shard_map``) moves every valid row exactly as the
    same exchange over four ``cpu`` shards does, bit for bit; ``dropped``
    is one decision on every shard."""
    from ballista_tpu_torch import parallel
    from ballista_tpu_torch.parallel.ici import make_hash_exchange
    from ballista_tpu_torch.parallel.mesh import build_mesh

    n_dev, n = 4, 1 << 16
    rng = np.random.default_rng(17)
    k = rng.integers(-5000, 5000, 4 * n).astype(np.int64)
    k[rng.random(4 * n) < 0.3] = 7
    arrays = {"k": k, "v": rng.standard_normal(4 * n), "b": rng.random(4 * n) < 0.5}
    valid = rng.random(4 * n) < 0.8
    outs = {}
    for dev in ("cpu", "cuda"):
        mesh = build_mesh(n_dev, dev)
        for cap_factor in (0, 4):
            ex = make_hash_exchange(n_dev, cap_factor)
            shard_args = [({c: torch.from_numpy(a[r * n:(r + 1) * n]).to(mesh[r])
                            for c, a in arrays.items()},
                           torch.from_numpy(valid[r * n:(r + 1) * n]).to(mesh[r]))
                          for r in range(n_dev)]
            res = parallel.shard_map(lambda arrs, v, ex=ex: ex(arrs, v, ("k",)), shard_args,
                                     mesh)
            outs[dev, cap_factor] = (
                {c: torch.cat([r[0][c].cpu() for r in res]) for c in arrays},
                torch.cat([r[1].cpu() for r in res]), [int(r[2]) for r in res])
    for cap_factor in (0, 4):
        got, want = outs["cuda", cap_factor], outs["cpu", cap_factor]
        assert torch.equal(got[1], want[1])
        for c in arrays:
            assert torch.equal(got[0][c].view(torch.uint8), want[0][c].view(torch.uint8)), c
        assert got[2] == want[2] and len(set(got[2])) == 1
    assert int(valid.sum()) == int(outs["cuda", 0][1].sum())


def test_mesh_q1_on_card_matches_one_shard_and_counts_threaded_launches(card, sf001_tables):
    """q1 fused over four shards of the card, cold and warm: the rows of the
    one-shard run, and grouped_sums launched from the four shard threads, a
    partial aggregate and a final merge each (8 launches), every one counted
    in ``grouped_sums.launches`` and in the query thread's calls."""
    from ballista_tpu_torch import parallel
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.engine import torch_engine as TE
    from ballista_tpu_torch.ops import grouped_sums as GS
    from ballista_tpu_torch.ops import kernels_torch as KT

    with open(os.path.join(REPO, "benchmarks", "queries", "q1.sql")) as f:
        sql = f.read()
    one = BallistaContext.standalone()
    for t, path in sf001_tables.items():
        one.register_parquet(t, path)
    want = one.sql(sql).collect()
    prev = parallel.force_mesh_shards(4)
    try:
        ctx = BallistaContext.standalone()
        for t, path in sf001_tables.items():
            ctx.register_parquet(t, path)
        TE.clear_caches()
        for _run in ("cold", "warm"):
            GS.launches = 0
            calls = KT.grouped_sums_calls()
            got = ctx.sql(sql).collect()
            assert GS.launches == 8 and KT.grouped_sums_calls() - calls == 8
            m = ctx.last_engine_metrics
            assert m["op.FusedIciExchange.count"] == 16.0
            assert m.get("op.HostFallback.count", 0.0) == 0.0
            _assert_rows_match(got, want, {n for n in got.column_names if n.startswith("avg")})
    finally:
        parallel.force_mesh_shards(prev)


def _megastage_case(n_li: int, n_ord: int, shards: int):
    """A q3-class chain (a partitioned PK-FK join with an aggregate above
    it) promoted to one megastage over ``shards`` shards, with integer
    prices so that its sums are exact, and its rows from pandas."""
    import pandas as pd

    from ballista_tpu_torch.client.catalog import Catalog
    from ballista_tpu_torch.config import BALLISTA_SHUFFLE_PARTITIONS, BallistaConfig
    from ballista_tpu_torch.ops.batch import ColumnBatch
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.scheduler.planner import promote_ici_exchanges, promote_megastage
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    rng = np.random.default_rng(23)
    li = {"l_orderkey": rng.integers(0, n_ord, n_li).astype(np.int64),
          "l_price": rng.integers(0, 1000, n_li).astype(np.int64)}
    orders = {"o_orderkey": np.arange(n_ord, dtype=np.int64),
              "o_prio": rng.integers(0, 5, n_ord).astype(np.int64)}
    lb, ob = ColumnBatch.from_dict(li), ColumnBatch.from_dict(orders)
    cat = Catalog()
    cat.register_batches("li", [lb.slice(i * (n_li // 4), n_li // 4) for i in range(4)],
                         lb.schema)
    cat.register_batches("orders", [ob.slice(0, n_ord // 2), ob.slice(n_ord // 2, n_ord // 2)],
                         ob.schema)
    sql = ("select o_prio, count(*) as n, sum(l_price) as rev "
           "from li join orders on l_orderkey = o_orderkey group by o_prio")
    cfg = BallistaConfig({BALLISTA_SHUFFLE_PARTITIONS: str(shards),
                          "ballista.optimizer.broadcast_rows_threshold": "0"})
    plan = PhysicalPlanner(cat, cfg).plan(optimize(SqlPlanner(cat.schemas()).plan(parse_sql(sql))))
    plan, n_ici = promote_ici_exchanges(plan, ici_devices=shards)
    plan, n_ms = promote_megastage(plan, ici_devices=shards)
    assert (n_ici, n_ms) == (2, 1)
    joined = pd.DataFrame(li).merge(pd.DataFrame(orders), left_on="l_orderkey",
                                    right_on="o_orderkey")
    want = joined.groupby("o_prio").agg(n=("l_price", "size"), rev=("l_price", "sum"))
    return plan, want.reset_index()


def test_megastage_on_card_exact_while_another_thread_writes_the_default_stream(
        card, monkeypatch):
    """A megastage over four shards of the card frees each shard's inputs
    while that shard's kernels may still be queued. Its inputs are copied
    on the shard's own stream, so that no other stream can be handed those
    blocks: three runs stay exact while another thread allocates and
    overwrites blocks on the card's default stream, as a fat executor's
    second task slot does (blocks of every size the inputs take, held, so
    that it is handed freed ones). A spin kernel queued on each shard's
    stream ahead of the kernels that read its inputs holds them queued past
    the release, so that a block handed to the default stream would be
    overwritten before it is read. The engine's budget is the one the
    scheduler plans with for a card registered with four shards."""
    import threading

    from ballista_tpu_torch import parallel
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import memory_model as MM
    from ballista_tpu_torch.engine.engine import create_engine
    from ballista_tpu_torch.ops import kernels_torch as KT
    from ballista_tpu_torch.ops.batch import ColumnBatch

    plan, want = _megastage_case(1 << 21, 1 << 18, 4)
    real = KT.device_batch_from_encoded

    def held(enc, arrays):
        if threading.current_thread().name.startswith("mesh-shard-"):
            # ~0.25 s on the shard's stream: longer than the host takes to
            # queue the shard's body and reach the release
            torch.cuda._sleep(500_000_000)
        return real(enc, arrays)

    monkeypatch.setattr(KT, "device_batch_from_encoded", held)
    stop = threading.Event()

    def scribble():
        # blocks of every power-of-two size from 4 KB to 16 MB, held in
        # rounds of about 1 GB so that a freed block of that size is taken
        held = []
        with torch.cuda.device(card):
            while not stop.is_set():
                held.extend(torch.full((1 << s,), 255, dtype=torch.uint8, device=card)
                            for s in range(12, 25))
                if len(held) > 13 * 32:
                    held.clear()

    prev = parallel.force_mesh_shards(4)
    writer = threading.Thread(target=scribble, daemon=True)
    writer.start()
    try:
        eng = create_engine("torch", BallistaConfig(), device="cuda")
        name = torch.cuda.get_device_name(card)
        if name in MM.DEVICE_MEMORY_BYTES:
            assert eng._hbm_budget() == MM.budget_from_device_kinds({name}, 4)
        for _ in range(3):
            got = (ColumnBatch.concat(eng.execute_all(plan)).to_pandas()
                   .sort_values("o_prio").reset_index(drop=True))
            assert got["o_prio"].tolist() == want["o_prio"].tolist()
            assert got["n"].tolist() == want["n"].tolist()
            assert got["rev"].tolist() == want["rev"].tolist()
        assert eng.op_metrics.get("op.Megastage.count", 0) >= 1
        assert eng.op_metrics.get("op.Megastage.donated_bytes", 0) > 0
    finally:
        stop.set()
        writer.join()
        parallel.force_mesh_shards(prev)
