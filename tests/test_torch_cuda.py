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
    from ballista_tpu_torch.models.tpch import generate_tpch
    from ballista_tpu_torch.ops import grouped_sums as GS

    lineitem = generate_tpch(str(tmp_path), sf=0.01, tables=["lineitem"],
                             parts_per_table=2)["lineitem"]
    aggs = [f"avg(l_quantity + {i}) as a{i}" for i in range(20)]
    aggs += ["sum(l_extendedprice) as s0", "sum(l_discount) as s1", "count(*) as n"]
    sql = (f"select l_returnflag, l_linestatus, {', '.join(aggs)} from lineitem "
           "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
    on_card = BallistaContext.standalone()
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, on_cpu):
        c.register_parquet("lineitem", lineitem)
    GS.launches = 0
    got = on_card.sql(sql).collect()
    m = on_card.last_engine_metrics
    assert m.get("op.HostFallback.count", 0.0) == 0.0
    assert GS.launches > m["op.DeviceExecute.count"]  # the final stages split
    _assert_rows_match(got, on_cpu.sql(sql).collect(), {f"a{i}" for i in range(20)})


def test_q1_q6_on_card_match_cpu(card, tmp_path):
    """At SF 0.01 in 2 files, one launch per aggregate stage: q1 2 partial +
    16 final = 18, q6 2 partial + 1 final = 3."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.models.tpch import generate_tpch
    from ballista_tpu_torch.ops import grouped_sums as GS

    lineitem = generate_tpch(str(tmp_path), sf=0.01, tables=["lineitem"],
                             parts_per_table=2)["lineitem"]
    on_card = BallistaContext.standalone()
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, on_cpu):
        c.register_parquet("lineitem", lineitem)
    for q, launches in (("q1", 18), ("q6", 3)):
        with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        GS.launches = 0
        got = on_card.sql(sql).collect()
        assert GS.launches == launches, q
        assert on_card.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
        _assert_rows_match(got, on_cpu.sql(sql).collect(),
                           {n for n in got.column_names if n.startswith("avg")})
