"""The port's device mesh (``ballista_tpu_torch/parallel``) against the JAX
package's, on the CPU.

The JAX side runs under ``shard_map`` on the conftest's 8-device CPU mesh;
the port's side is ``parallel.shard_map`` over a mesh of ``cpu`` shards, one
thread each, with the same inputs (numpy, from a seed). The cases of
``tests/test_parallel.py`` that apply to the port sit beside their JAX
counterparts here: the hash exchange, the distributed group-by, the q1
flagship and the graft entry's single- and multi-chip runs; plus what the
port adds: the shard runner's order, its collectives, a shard that fails
or hangs, and the shard threads' grouped_sums calls.
"""
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.engine import memory_model as JMM
from ballista_tpu.parallel import flagship as JFLAG
from ballista_tpu.parallel import ici as JICI
from ballista_tpu.parallel.mesh import build_mesh as jax_build_mesh
from ballista_tpu_torch import parallel
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.parallel import flagship as FLAG
from ballista_tpu_torch.parallel.ici import distributed_groupby, make_hash_exchange
from ballista_tpu_torch.parallel.mesh import build_mesh, shards_per_card
from ballista_tpu_torch.plan.schema import DataType, Field, Schema

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_fused import _jax_exchange

QUERIES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries")


@pytest.fixture
def shards():
    """Sets the process's mesh (``force_mesh_shards``) for one test and
    restores it: the count is process-wide."""
    prev = parallel.force_mesh_shards(None)
    yield parallel.force_mesh_shards
    parallel.force_mesh_shards(prev)


def test_mesh_is_forced_or_one_per_card(shards):
    assert parallel.mesh_shards("cpu") == 1
    assert build_mesh(device="cpu") == [torch.device("cpu")]
    shards(8)
    assert parallel.mesh_shards("cpu") == 8
    mesh = build_mesh(device="cpu")
    assert mesh == [torch.device("cpu")] * 8 and shards_per_card(mesh) == 8
    assert build_mesh(2, "cpu") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        shards(0)


# ---- the exchange ------------------------------------------------------------------------
def _exchange_inputs(n: int, seed: int):
    """Keys with repeats and one hot key pair (60% of the rows: past the
    skew-bounded capacity at eight shards), the second key int32, an f64
    and a bool payload; ~20% invalid rows."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 50, n).astype(np.int64)
    s = rng.integers(0, 5, n).astype(np.int32)
    hot = rng.random(n) < 0.6
    k[hot], s[hot] = 7, 3
    arrays = {
        "k": k,
        "s": s,
        "v": rng.standard_normal(n),
        "b": rng.random(n) < 0.5,
    }
    return arrays, rng.random(n) < 0.8


def _port_exchange(arrays, valid, n_dev, cap_factor, keys):
    """The port's exchange per shard through ``parallel.shard_map`` on
    contiguous shards (as ``shard_map`` splits them); outputs concatenated
    in shard order."""
    n = len(valid) // n_dev
    ex = make_hash_exchange(n_dev, cap_factor)
    shard_args = [({k: torch.from_numpy(a[r * n:(r + 1) * n]) for k, a in arrays.items()},
                   torch.from_numpy(valid[r * n:(r + 1) * n])) for r in range(n_dev)]
    results = parallel.shard_map(lambda arrs, v: ex(arrs, v, keys), shard_args,
                                 build_mesh(n_dev, "cpu"))
    out = {k: np.concatenate([res[0][k].numpy() for res in results]) for k in arrays}
    return (out, np.concatenate([res[1].numpy() for res in results]),
            np.array([int(res[2]) for res in results]))


@pytest.mark.parametrize("keys", [("k",), ("k", "s")], ids=["one-key", "two-keys"])
@pytest.mark.parametrize("cap_factor", [0, 4])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_hash_exchange_bit_identical_to_jax(n_dev, cap_factor, keys):
    """Every received row in the same slot with the same bits, the same
    validity and the same ``dropped`` on every shard; at eight shards with
    cap_factor 4 the hot key overflows its peer's capacity."""
    arrays, valid = _exchange_inputs(8 * 256, seed=n_dev * 10 + cap_factor)
    want, want_valid, want_dropped = _jax_exchange(arrays, valid, n_dev, cap_factor, keys)
    got, got_valid, got_dropped = _port_exchange(arrays, valid, n_dev, cap_factor, keys)
    assert np.array_equal(got_valid, want_valid)
    for k in arrays:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k].view(np.uint8), want[k].view(np.uint8)), k
    assert np.array_equal(got_dropped, want_dropped)
    assert len(set(got_dropped.tolist())) == 1  # one decision on every shard
    assert (int(got_dropped[0]) > 0) == (n_dev == 8 and cap_factor == 4)
    assert int(got_valid.sum()) == int(valid.sum()) - int(got_dropped[0])


def test_exchange_conserves_rows_and_colocates_keys():
    """``test_ici_hash_exchange_conserves_rows`` of the JAX package: every
    valid row arrives once, and equal keys land on one shard."""
    n_dev, n = 8, 64 * 8
    rng = np.random.default_rng(3)
    arrays = {"k": rng.integers(0, 1000, n).astype(np.int64), "v": rng.random(n)}
    valid = rng.random(n) < 0.8
    got, got_valid, _ = _port_exchange(arrays, valid, n_dev, 0, ("k",))
    assert got_valid.sum() == valid.sum()
    assert np.isclose(got["v"][got_valid].sum(), arrays["v"][valid].sum())
    per = len(got_valid) // n_dev
    owner = {}
    for i in np.nonzero(got_valid)[0]:
        assert owner.setdefault(got["k"][i], i // per) == i // per


# ---- the shard runner and its collectives --------------------------------------------------
def test_shard_map_keeps_shard_order_and_transposes():
    n = 4
    mesh = build_mesh(n, "cpu")

    def body(r):
        coll = parallel.collective_for(n)
        assert coll.rank == r and threading.current_thread().name == f"mesh-shard-{r}"
        buf = torch.arange(n * 3).reshape(n, 3) + 100 * r
        (got,) = coll.all_to_all([buf])
        total = coll.all_sum(torch.tensor(r + 1))
        return r, got, int(total)

    out = parallel.shard_map(body, [(r,) for r in range(n)], mesh)
    assert [o[0] for o in out] == list(range(n))
    for r, got, total in out:
        # row j came from shard j: its row r
        assert got.tolist() == [(torch.arange(3) + 3 * r + 100 * j).tolist() for j in range(n)]
        assert total == n * (n + 1) // 2
    # one shard runs on the calling thread with the identity collective
    one = parallel.shard_map(lambda: (threading.current_thread(), parallel.collective_for(1)),
                             [()], build_mesh(1, "cpu"))
    assert one[0][0] is threading.current_thread()
    assert isinstance(one[0][1], parallel.SingleDevice)


def test_collective_outside_a_mesh_program_raises():
    with pytest.raises(ExecutionError, match="only inside a mesh program"):
        parallel.collective_for(2)
    with pytest.raises(ExecutionError, match="only inside a mesh program"):
        make_hash_exchange(2)({"k": torch.arange(4)}, torch.ones(4, dtype=torch.bool), ("k",))


class _Boom(RuntimeError):
    pass


def test_a_shard_that_raises_fails_the_program_at_once():
    """Shard 2 raises before its first collective; the others, waiting in
    theirs, break out at once (no timeout), and the program fails with
    shard 2's own error."""
    n = 4

    def body(r):
        if r == 2:
            raise _Boom("shard two")
        return parallel.collective_for(n).all_sum(torch.tensor(1))

    t0 = time.time()
    with pytest.raises(parallel.ShardFailed) as info:
        parallel.shard_map(body, [(r,) for r in range(n)], build_mesh(n, "cpu"), timeout=60.0)
    assert time.time() - t0 < 10.0
    assert info.value.rank == 2 and isinstance(info.value.error, _Boom)
    assert isinstance(info.value.__cause__, _Boom)


def test_a_shard_that_hangs_fails_the_program_within_the_timeout():
    n = 3
    release = threading.Event()

    def body(r):
        if r == 0:
            release.wait(30.0)  # never reaches the collective in time
        return parallel.collective_for(n).all_sum(torch.tensor(1))

    t0 = time.time()
    try:
        with pytest.raises(parallel.ShardFailed) as info:
            parallel.shard_map(body, [(r,) for r in range(n)], build_mesh(n, "cpu"),
                               timeout=0.5)
    finally:
        release.set()
    assert time.time() - t0 < 15.0
    assert isinstance(info.value.error, (threading.BrokenBarrierError, TimeoutError))


def test_collectives_under_contention():
    """Sixteen shards (more than the cores), the interpreter switching
    threads every microsecond, many rounds of both collectives: every
    round's sums and transposes exact (a lost or reordered post would
    break them)."""
    n, rounds = 16, 60
    mesh = build_mesh(n, "cpu")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(r):
            coll = parallel.collective_for(n)
            for i in range(rounds):
                assert int(coll.all_sum(torch.tensor(r * i))) == i * n * (n - 1) // 2
                got, other = coll.all_to_all([torch.full((n, 2), r * 1000 + i),
                                              torch.full((n, 1), -r)])
                assert got[:, 0].tolist() == [j * 1000 + i for j in range(n)]
                assert other[:, 0].tolist() == [-j for j in range(n)]
            return r

        assert parallel.shard_map(body, [(r,) for r in range(n)], mesh, timeout=60.0) \
            == list(range(n))
    finally:
        sys.setswitchinterval(old)


def test_shard_threads_grouped_sums_calls_count_on_the_caller(shards, torch_tpch_dir):
    """q1 fused over eight shards: each shard's partial aggregate and final
    merge make one grouped_sums call on its own thread, and all sixteen
    count on the thread that ran the query (an executor reports that
    thread's count as the task's ``op.GroupedSums.calls``)."""
    shards(8)
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_parquet("lineitem", os.path.join(torch_tpch_dir, "lineitem"))
    with open(os.path.join(QUERIES, "q1.sql")) as f:
        q1 = f.read()
    TE.clear_caches()
    for _run in ("cold", "warm"):
        before = KT.grouped_sums_calls()
        ctx.sql(q1).collect()
        assert KT.grouped_sums_calls() - before == 16
        assert ctx.last_engine_metrics["op.FusedIciExchange.count"] == 16


# ---- the distributed group-by and the flagship ------------------------------------------------
def test_distributed_groupby_matches_jax():
    """``jit_distributed_groupby`` over eight devices against the port's
    ``distributed_groupby`` over eight shards: keys, counts and the seen
    mask equal, f64 sums within 1e-12 relative (segment sums in another
    order); every group owned by one shard and equal to a numpy bincount."""
    G, n = 32, 2048
    rng = np.random.default_rng(7)
    key = rng.integers(0, G, n)
    val = rng.random(n)
    valid = rng.random(n) < 0.9
    jfn = JICI.jit_distributed_groupby(jax_build_mesh(8), G, "k", ("v",))
    jgk, jsums, jcnt, jseen = jfn({"k": jnp.asarray(key), "v": jnp.asarray(val)},
                                  jnp.asarray(valid))
    fn = distributed_groupby(build_mesh(8, "cpu"), G, "k", ("v",))
    gk, sums, cnt, seen = fn({"k": torch.from_numpy(key), "v": torch.from_numpy(val)},
                             torch.from_numpy(valid))
    assert np.array_equal(gk.numpy(), np.asarray(jgk))
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    assert np.array_equal(seen.numpy(), np.asarray(jseen))
    np.testing.assert_allclose(sums["v"].numpy(), np.asarray(jsums["v"]), rtol=1e-12)
    got = np.zeros(G)
    owners = np.zeros(G, int)
    for i in np.nonzero(seen.numpy())[0]:
        got[gk[i]] += sums["v"][i].item()
        owners[gk[i]] += 1
    present = np.bincount(key[valid], minlength=G) > 0
    assert (owners[present] == 1).all()
    np.testing.assert_allclose(got, np.bincount(key[valid], weights=val[valid], minlength=G),
                               rtol=1e-12)


def test_q1_local_step_matches_jax():
    """Counts exact, f64 sums within 1e-12 relative (the same masked
    reductions, summed in torch's order)."""
    args = FLAG.q1_example_args(n=8192, seed=0)
    sums, counts = FLAG.q1_local_step()(*args)
    jsums, jcounts = jax.jit(JFLAG.q1_local_step())(*JFLAG.q1_example_args(n=8192, seed=0))
    assert sums.shape == (5, FLAG.N_GROUPS) and sums.dtype == torch.float64
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-12)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_q1_distributed_step_matches_jax(n_dev):
    n = 128 * n_dev
    sums, counts = FLAG.q1_distributed_step(build_mesh(n_dev, "cpu"))(
        *FLAG.q1_example_args(n=n, seed=1))
    jsums, jcounts = JFLAG.q1_distributed_step(jax_build_mesh(n_dev))(
        *JFLAG.q1_example_args(n=n, seed=1))
    assert sums.shape == (5 * n_dev, FLAG.N_GROUPS)
    assert np.array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-12, atol=1e-9)


def test_graft_entry_single_and_multichip(shards, torch_tpch_dir):
    """The graft entry's steps (``__graft_entry__.entry`` and
    ``dryrun_multichip(8)``, ``(2)``) through the port's flagship: the
    one-device q1 program; one step of the distributed program over eight
    and two shards, every row that passes the filter counted once; and a
    SQL aggregate fused over the mesh, exact against the host engine."""
    fn, args = FLAG.q1_local_step(), FLAG.q1_example_args(n=8192)
    assert fn(*args)[0].shape[0] == 5
    sql = ("select l_returnflag, l_linestatus, sum(l_quantity) as s, count(*) as c "
           "from lineitem group by l_returnflag, l_linestatus")
    keys = [("l_returnflag", "ascending"), ("l_linestatus", "ascending")]
    host = BallistaContext.standalone(backend="numpy")
    host.register_parquet("lineitem", os.path.join(torch_tpch_dir, "lineitem"))
    want = host.sql(sql).collect().sort_by(keys).to_pydict()
    for n_dev in (8, 2):
        step = FLAG.q1_distributed_step(build_mesh(n_dev, "cpu"))
        args = FLAG.q1_example_args(n=128 * n_dev, seed=1)
        sums, counts = step(*args)
        assert torch.isfinite(sums).all()
        ship, valid = args[4].numpy(), args[7].numpy()
        assert int(counts.sum()) == int(((ship <= FLAG.CUTOFF) & valid).sum())
        shards(n_dev)
        ctx = BallistaContext.standalone(device="cpu")
        ctx.register_parquet("lineitem", os.path.join(torch_tpch_dir, "lineitem"))
        got = ctx.sql(sql).collect().sort_by(keys).to_pydict()
        assert ctx.last_engine_metrics.get("op.FusedIciExchange.count", 0) >= 1
        assert got["l_returnflag"] == want["l_returnflag"] and got["c"] == want["c"]
        np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)


# ---- the megastage's memory model ----------------------------------------------------------
def _schema(pkg_schema, pkg_field, pkg_dtype, cols):
    return pkg_schema([pkg_field(n, getattr(pkg_dtype, t), nullable) for n, t, nullable in cols])


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_estimate_megastage_bytes_equals_the_jax_package(n_dev):
    """The same segments (a join's two exchanges, then the aggregate's)
    price equal in both packages, byte for byte; the eager estimate, which
    sums the segments, is never below it."""
    from ballista_tpu.plan.schema import DataType as JDataType
    from ballista_tpu.plan.schema import Field as JField
    from ballista_tpu.plan.schema import Schema as JSchema

    cols = [[("l_orderkey", "INT64", False), ("l_price", "FLOAT64", True)],
            [("o_orderkey", "INT64", False), ("o_prio", "STRING", False),
             ("o_date", "DATE32", True)],
            [("o_prio", "STRING", False), ("n", "INT64", False), ("rev", "FLOAT64", True)]]
    rows = [(60_000, 15_000, 5), (1 << 20, 3, 1000), (7, 7, 7)]
    for r in rows:
        segs = [[(_schema(Schema, Field, DataType, cols[0]), r[0]),
                 (_schema(Schema, Field, DataType, cols[1]), r[1])],
                [(_schema(Schema, Field, DataType, cols[2]), r[2])]]
        jsegs = [[(_schema(JSchema, JField, JDataType, cols[0]), r[0]),
                  (_schema(JSchema, JField, JDataType, cols[1]), r[1])],
                 [(_schema(JSchema, JField, JDataType, cols[2]), r[2])]]
        got = MM.estimate_megastage_bytes(segs, n_dev)
        assert got == JMM.estimate_megastage_bytes(jsegs, n_dev)
        assert MM.estimate_eager_megastage_bytes(segs, n_dev) >= got > 0
