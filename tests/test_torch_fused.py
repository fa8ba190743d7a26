"""The port's fused single-device exchange, its leaf caches and tiny-stage
dispatch, against the JAX package, on the CPU.

* ``parallel/ici.make_hash_exchange`` against the JAX package's exchange
  under ``shard_map`` on the same inputs (from a numpy seed): at one device,
  and at four, where one thread per device and an in-process transpose
  stand in for the collective. Outputs, validity and ``dropped`` bit for bit.
* TPC-H on ``device="cpu"`` against the JAX engine over a one-device mesh
  (``mesh_devices = 1``) and the oracle: rows equal (floats within rtol
  1e-6, the oracle's tolerance), and the fused counts, the fused attempts
  that returned None, and the operator kinds run on host kernels equal the
  JAX engine's.
* The content-keyed leaf caches: a warm run encodes no scan output and no
  fused input, and transfers under 1% of its cold bytes.
* Tiny-stage dispatch: all 22 queries with ``min_device_rows`` far above
  SF 0.01, against the oracle and the JAX engine's host operators.
* A cold fused input built on the device from its stages' outputs: the
  host build's encoding, metadata and every element, for TPC-H's inputs
  and synthetic stage outputs; the inputs only the host can encode take the
  host build; each build counted; a device-cache miss builds it again.
* A partitioned join whose right keys repeat, against the host engine and
  the JAX engine: an inner join over unique left keys runs fused with the
  roles exchanged (a residual filter too); left, semi and anti joins
  decline, and an inner join whose two sides repeat declines after one
  program per input content.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from jax.sharding import PartitionSpec as PS

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.engine import fused_exchange as JFX
from ballista_tpu.models.tpch import TPCH_TABLES
from ballista_tpu.ops import kernels_jax as KJ
from ballista_tpu.parallel import ici as JICI
from ballista_tpu.parallel import shard_map
from ballista_tpu.parallel.mesh import build_mesh
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import fused_exchange as FX
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops import grouped_sums as GS
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.parallel.ici import make_hash_exchange
from ballista_tpu_torch.parallel.mesh import build_mesh as port_mesh
from ballista_tpu_torch.plan import physical as P

from test_torch_data import torch_oracle_tables, torch_tpch_dir  # noqa: F401
from test_torch_joins import _cold_leaf_caches, _host_ops
from test_tpch_numpy import ORDERED, assert_frames_match
from tpch_oracle import ORACLES

QUERIES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries")


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


# ---- the exchange ------------------------------------------------------------------------
def _exchange_inputs(n: int, seed: int):
    """Keys with repeats and one hot key (a third of the rows), a second
    int32 key, an f64 and a bool payload; ~20% invalid rows."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-50, 50, n).astype(np.int64)
    k[rng.random(n) < 0.33] = 7
    arrays = {
        "k": k,
        "s": rng.integers(0, 5, n).astype(np.int32),
        "v": rng.standard_normal(n),
        "b": rng.random(n) < 0.5,
    }
    return arrays, rng.random(n) < 0.8


def _jax_exchange(arrays, valid, n_dev, cap_factor, keys):
    mesh = build_mesh(n_dev)
    axis = mesh.axis_names[0]
    ex = JICI.make_hash_exchange(axis, n_dev, cap_factor)

    def body(arrs, v):
        out, got_valid, dropped = ex(arrs, v, keys)
        return out, got_valid, dropped.reshape(1)

    spec = {name: PS(axis) for name in arrays}
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, PS(axis)),
                           out_specs=(spec, PS(axis), PS(axis))))
    out, got_valid, dropped = fn({k: jnp.asarray(a) for k, a in arrays.items()},
                                 jnp.asarray(valid))
    return ({k: np.asarray(a) for k, a in out.items()}, np.asarray(got_valid),
            np.asarray(dropped))


class _ThreadWorld:
    """An in-process world of ``n_dev`` devices, one thread each:
    ``all_to_all`` transposes the devices' lists of send buffers,
    ``all_sum`` adds a scalar over them."""

    def __init__(self, n_dev: int):
        self.n_dev = n_dev
        self.barrier = threading.Barrier(n_dev)
        self.slots = [None] * n_dev

    def rank(self, r: int):
        world = self

        class Rank:
            def _gather(self, x):
                world.slots[r] = x
                world.barrier.wait()
                got = list(world.slots)
                world.barrier.wait()
                return got

            def all_to_all(self, bufs):
                peers = self._gather(bufs)
                return [torch.stack([peer[c][r] for peer in peers])
                        for c in range(len(bufs))]

            def all_sum(self, x):
                return sum(self._gather(x))

        return Rank()


def _torch_exchange(arrays, valid, n_dev, cap_factor, keys):
    """The port's exchange run per device on contiguous shards (as
    ``shard_map`` splits them); outputs concatenated in device order."""
    n = len(valid) // n_dev
    world = _ThreadWorld(n_dev)
    results = [None] * n_dev
    errors = []

    def run(r):
        try:
            ex = make_hash_exchange(n_dev, cap_factor, collective=world.rank(r))
            shard = {k: torch.from_numpy(a[r * n:(r + 1) * n]) for k, a in arrays.items()}
            results[r] = ex(shard, torch.from_numpy(valid[r * n:(r + 1) * n]), keys)
        except Exception as e:  # noqa: BLE001 - re-raised below, on the test thread
            errors.append(e)
            world.barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n_dev)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    out = {k: np.concatenate([res[0][k].numpy() for res in results]) for k in arrays}
    return (out, np.concatenate([res[1].numpy() for res in results]),
            np.array([int(res[2]) for res in results]))


@pytest.mark.parametrize("keys", [("k",), ("k", "s")], ids=["one-key", "two-keys"])
@pytest.mark.parametrize("n_dev,cap_factor", [(1, 0), (1, 4), (4, 0), (4, 1), (4, 4)])
def test_hash_exchange_bit_identical_to_jax(n_dev, cap_factor, keys):
    """Every received row in the same slot with the same bits, the same
    validity and the same dropped count; at four devices with cap_factor 1
    the hot key overflows its peer (dropped > 0)."""
    arrays, valid = _exchange_inputs(4 * 256, seed=n_dev * 10 + cap_factor)
    want, want_valid, want_dropped = _jax_exchange(arrays, valid, n_dev, cap_factor, keys)
    got, got_valid, got_dropped = _torch_exchange(arrays, valid, n_dev, cap_factor, keys)
    assert np.array_equal(got_valid, want_valid)
    for k in arrays:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k][got_valid].view(np.uint8),
                              want[k][want_valid].view(np.uint8)), k
    assert np.array_equal(got_dropped, want_dropped)
    assert (int(got_dropped[0]) > 0) == (n_dev == 4 and cap_factor == 1)
    assert int(got_valid.sum()) == int(valid.sum()) - int(got_dropped[0])


def test_more_than_one_device_raises_without_a_process_group(torch_tpch_dir):
    """An exchange over two shards has no collective outside a mesh program
    (``parallel.shard_map``) and raises there; an engine over a mesh of two
    runs q1 as one such program, with the one-device rows."""
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_parquet("lineitem", os.path.join(torch_tpch_dir, "lineitem"))
    want = ctx.sql(_sql("q1")).collect()
    engine = TE.TorchEngine(ctx.config, device="cpu")
    engine.mesh_devices = 2
    ctx._get_engine = lambda: engine
    assert ctx.sql(_sql("q1")).collect().equals(want)
    assert ctx.last_engine_metrics["op.FusedIciExchange.count"] == 16
    exchange = make_hash_exchange(2)
    with pytest.raises(ExecutionError, match="only inside a mesh program"):
        exchange({"k": torch.arange(4)}, torch.ones(4, dtype=torch.bool), ("k",))


# ---- TPC-H against the JAX engine ------------------------------------------------------
def _contexts(data, threshold):
    t = BallistaContext.standalone(device="cpu")
    j = JaxContext.standalone(backend="jax")
    for c in (t, j):
        c.config.set("ballista.optimizer.broadcast_rows_threshold", threshold)
        for name in TPCH_TABLES:
            c.register_parquet(name, os.path.join(data, name))
    make = j._get_engine

    def one_device():
        engine = make()
        engine.mesh_devices = 1
        return engine

    j._get_engine = one_device
    return t, j


@pytest.fixture(scope="module")
def ctxs(torch_tpch_dir):
    """(torch, jax) contexts at the planner's broadcast threshold and at 0,
    where every join partitions."""
    return {500_000: _contexts(torch_tpch_dir, 500_000), 0: _contexts(torch_tpch_dir, 0)}


@pytest.fixture
def jax_declines(monkeypatch):
    """The JAX engine's fused attempts that returned None."""
    count = [0]
    for name in ("run_fused_aggregate", "run_fused_join"):
        real = getattr(JFX, name)

        def counting(*a, _real=real, **kw):
            out = _real(*a, **kw)
            count[0] += out is None
            return out

        monkeypatch.setattr(JFX, name, counting)
    return count


def assert_fused_like_jax(tm: dict, jm: dict, jax_declined: int, swapped: int) -> None:
    """The port's fused counts equal the JAX engine's, but for ``swapped``
    joins: inner joins over repeated right keys and unique left keys, which
    the JAX engine declines and the port runs with the roles exchanged (one
    execution each, serving the join's 16 partitions)."""
    assert tm.get("op.FusedJoin.swapped", 0.0) == swapped
    assert tm.get("op.FusedIciExchange.count", 0.0) == jm.get("op.FusedIciExchange.count", 0.0)
    assert (tm.get("op.FusedIciJoin.count", 0.0)
            == jm.get("op.FusedIciJoin.count", 0.0) + 16 * swapped)
    assert tm.get("op.FusedDeclined.count", 0.0) == jax_declined - swapped


# (query, broadcast threshold) -> its joins the port runs with the roles exchanged
SWAPPED = {("q12", 0): 1}


@pytest.mark.parametrize("qname,threshold", [
    ("q1", 500_000), ("q3", 500_000), ("q4", 500_000), ("q5", 500_000), ("q6", 500_000),
    ("q12", 500_000), ("q3", 0), ("q5", 0), ("q12", 0),
])
def test_fused_tpch_matches_jax_engine(ctxs, torch_oracle_tables, jax_declines, qname,
                                       threshold):
    """At the default threshold q1, q3, q4, q5 and q12 fuse their final
    aggregate (16 partitions), q6 (a global aggregate) nothing; at threshold
    0 q3 also fuses its 2 partitioned joins and q5 4 of its joins, while q5
    declines 2 (both sides' keys repeat). At threshold 0 q12's join (orders'
    unique keys, filtered lineitem's repeated ones) runs with its roles
    exchanged, where the JAX engine declines it."""
    tctx, jctx = ctxs[threshold]
    _cold_leaf_caches()
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    tm = dict(tctx.last_engine_metrics)
    want = jctx.sql(_sql(qname)).collect().to_pandas()
    jm = jctx.last_engine_metrics
    ordered = qname in ORDERED
    assert_frames_match(got, want, ordered, f"{qname} vs jax")
    assert_frames_match(got, ORACLES[qname](torch_oracle_tables), ordered, qname)
    assert_fused_like_jax(tm, jm, jax_declines[0], SWAPPED.get((qname, threshold), 0))
    assert _host_ops(tm) == _host_ops(jm)
    assert tm.get("op.HostFallback.count", 0.0) == 0.0
    assert (tm.get("op.FusedIciExchange.count", 0.0) > 0) == (qname != "q6")


# q1's fused input at SF 0.01: its filtered lineitem rows, padded
FUSED_Q1_PAD = 1 << 16


def test_fused_q1_is_one_program_with_two_grouped_sums_calls(ctxs, monkeypatch):
    """q1 warm: the fused program (its partial aggregate over the whole
    2-file input, one grouped_sums call; the final merge, one more) and the
    16 sort stages above it; cold also runs the input's 2 filter stages."""
    tctx, _ = ctxs[500_000]
    calls = []
    real = GS.grouped_sums_multi

    def counting(vals, masks, ids, k):
        calls.append((int(ids.shape[0]), k, len(vals)))
        return real(vals, masks, ids, k)

    monkeypatch.setattr(GS, "grouped_sums_multi", counting)
    TE.clear_caches()
    stages = []
    for _run in ("cold", "warm"):
        calls.clear()
        tctx.sql(_sql("q1")).collect()
        stages.append(tctx.last_engine_metrics["op.DeviceExecute.count"])
        # the partial aggregate over the whole input's pad, the final merge
        # over the exchanged states: the 16-row pad of the k = 12 direct ids
        assert [(n, k) for n, k, _c in calls] == [(FUSED_Q1_PAD, 12), (16, 12)], calls
    assert stages == [2 + 1 + 16, 1 + 16]


def test_unfused_q22_aggregates_on_the_host_as_the_jax_engine_does(torch_tpch_dir,
                                                                    torch_oracle_tables):
    """With ``ici_shuffle=false``, q22's partial aggregate sits in a stage
    with its anti join, whose build keys repeat past 32: the stage falls
    back on both engines, aggregate included (the fused path aggregates its
    input on the device instead, as the JAX engine's does)."""
    tctx, jctx = _contexts(torch_tpch_dir, 500_000)
    for c in (tctx, jctx):
        c.config.set("ballista.tpu.ici_shuffle", False)
    _cold_leaf_caches()
    got = tctx.sql(_sql("q22")).collect().to_pandas()
    jctx.sql(_sql("q22")).collect()
    assert_frames_match(got, ORACLES["q22"](torch_oracle_tables), True, "q22")
    assert "HashAggregateExec" in _host_ops(tctx.last_engine_metrics)
    assert _host_ops(tctx.last_engine_metrics) == _host_ops(jctx.last_engine_metrics)


# ---- the leaf caches ---------------------------------------------------------------------
def _final_aggs(ctx, qname):
    """The final aggregates of ``qname``'s physical plan."""
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    plan = SqlPlanner(ctx.catalog.schemas()).plan(parse_sql(_sql(qname)))
    phys = PhysicalPlanner(ctx.catalog, ctx.config).plan(optimize(plan, ctx.catalog))
    return [n for n in P.walk_physical(phys)
            if isinstance(n, P.HashAggregateExec) and n.mode == "final"]


def _final_agg_schema(ctx, qname):
    finals = _final_aggs(ctx, qname)
    assert len(finals) == 1
    return tuple(finals[0].schema().names)


@pytest.mark.parametrize("qname", ["q1", "q3", "q5"])
def test_warm_run_encodes_no_input_again(ctxs, monkeypatch, qname):
    """After a cold run, a warm run encodes only what the fused exchange
    hands to the stages above it on the host (the final aggregate's 15 empty
    partitions; its rows, in partition 0, are built on the device for their
    stage: one hand-off), runs only the fused program and the 16 stages
    above it, and transfers under 1% of the cold run's bytes; after
    ``clear_caches()`` the run is cold again."""
    tctx, _ = ctxs[500_000]
    encoded = []
    real = KT.encode_host_batch

    def recording(batch, pad=None):
        encoded.append(tuple(batch.schema.names))
        return real(batch, pad)

    monkeypatch.setattr(KT, "encode_host_batch", recording)
    final = _final_agg_schema(tctx, qname)
    sent, encodes, stages, handoffs = [], [], [], []
    for _run in ("cold", "warm", "cleared"):
        if _run != "warm":
            TE.clear_caches()
        encoded.clear()
        tctx.sql(_sql(qname)).collect()
        sent.append(tctx.last_engine_metrics["op.DeviceTransfer.bytes"])
        stages.append(tctx.last_engine_metrics["op.DeviceExecute.count"])
        handoffs.append(tctx.last_engine_metrics["op.FusedOutput.device_handoffs"])
        encodes.append(list(encoded))
    cold, warm, cleared = encodes
    assert warm == [final] * 15 and handoffs == [1, 1, 1]
    assert stages[1] == 1 + 16 and stages[0] == stages[2] > stages[1]
    assert any(s != final for s in cold) and sorted(cleared) == sorted(cold)
    assert sent[1] < 0.01 * sent[0] and sent[2] == sent[0]


# ---- the fused input built on the device ------------------------------------------------------
def _fused_input(ctx, qname):
    """The fused input of ``qname``'s final aggregate: its partial
    aggregate's input, below the exchange."""
    (final,) = _final_aggs(ctx, qname)
    assert isinstance(final.input, P.RepartitionExec)
    return final.input.input.input


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q12"])
def test_device_built_input_equals_the_host_build(ctxs, qname, n_dev):
    """Built on the device from its stages' outputs, the fused input has
    the host build's encoding: rows, pad, each column's dtype, null flag,
    dictionary and scale, ranges, subset-sum bounds and shared dictionary
    ids, and every array equal element for element (its shards
    concatenated), so the fused program makes the same decisions. The
    device build comes first, over empty caches; the host build then takes
    the place of its stand-ins."""
    tctx, _ = ctxs[500_000]
    child = _fused_input(tctx, qname)
    mesh = port_mesh(n_dev, "cpu")
    LC.clear()
    engine = TE.TorchEngine(tctx.config, device="cpu")
    got, shards = FX.fused_input(engine, child, mesh)
    want, _ = FX.fused_input(TE.TorchEngine(tctx.config, device="cpu"), child, mesh,
                             device_ok=False)
    assert shards is not None and len(shards) == n_dev
    assert engine.op_metrics["op.FusedInput.device_builds"] == 1.0
    assert "op.FusedInput.host_builds" not in engine.op_metrics
    assert (got.n_rows, got.n_pad) == (want.n_rows, want.n_pad)
    assert len(got.col_meta) == len(want.col_meta)
    for (gdt, gnull, gdict, gscale), (wdt, wnull, wdict, wscale) in zip(got.col_meta,
                                                                        want.col_meta):
        assert (gdt, gnull, gscale) == (wdt, wnull, wscale)
        assert (gdict is None) == (wdict is None)
        assert gdict is None or np.array_equal(gdict, wdict)
    assert got.int_ranges == want.int_ranges
    assert got.ssums == want.ssums
    assert got.dict_ids == want.dict_ids
    assert all(a.device.type == "meta" for a in got.arrays)
    arrays = [torch.cat([s[j] for s in shards]).numpy() for j in range(len(shards[0]))]
    assert len(arrays) == len(want.arrays)
    for g, w in zip(arrays, want.arrays):
        assert g.dtype == w.dtype and np.array_equal(g, w)


_WORDS = np.array(["AIR", "MAIL", "RAIL", "SHIP", "TRUCK"], dtype=object)
_WORDS_ID = "test.words@v1:fused-input"


def _stage_outputs(seed: int, shared: bool = True, nulls: bool = False, big: bool = False,
                   floats: bool = False, raised: bool = False) -> list:
    """Four stage outputs on the CPU device, as a fused input's partitions
    come back: ints with NULLs, dates, bools, a decimal at scales 2, 0 (an
    empty part), 0 and 1 (``raised``: each two higher, as a product's
    output holds more digits than its values need), and strings of a shared
    dictionary; about a fifth of each part's rows invalid, not as a
    suffix."""
    from ballista_tpu_torch.engine.dictionaries import REGISTRY
    from ballista_tpu_torch.ops.batch import Column, ColumnBatch
    from ballista_tpu_torch.plan.schema import DataType, Field, Schema

    REGISTRY.ensure(_WORDS_ID, _WORDS)
    rng = np.random.default_rng(seed)
    schema = Schema((Field("i", DataType.INT32), Field("d", DataType.DATE32),
                     Field("b", DataType.BOOL), Field("x", DataType.FLOAT64),
                     Field("s", DataType.STRING)))
    parts = []
    for n, scale in ((40, 2), (0, 0), (25, 0), (30, 1)):
        x = rng.integers(-10**5, 10**5, n) / 10.0**scale
        if big:
            x = x + 2.0**52
        if floats:
            x = x + 1 / 3
        words = [None if nulls and rng.random() < 0.2 else str(w)
                 for w in rng.choice(_WORDS, n)]
        batch = ColumnBatch(schema, [
            Column(DataType.INT32, rng.integers(-1000, 1000, n).astype(np.int32),
                   rng.random(n) < 0.8),
            Column(DataType.DATE32, rng.integers(8000, 11000, n).astype(np.int32)),
            Column(DataType.BOOL, rng.random(n) < 0.5),
            Column(DataType.FLOAT64, x, rng.random(n) < 0.9),
            Column(DataType.STRING, pa.array(words, pa.string()),
                   dict_id=_WORDS_ID if shared else None),
        ])
        db = KT.to_device(batch, "cpu")
        db.row_valid = db.row_valid & torch.from_numpy(rng.random(db.n_pad) < 0.8)
        if raised:
            db.cols[3] = KT.rescale_up(db.cols[3], db.cols[3].scale + 2)
        parts.append(db)
    return parts


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("seed,raised", [(0, False), (1, True), (2, False), (3, True)])
def test_encode_device_batches_is_the_host_encode(seed, raised, n_dev):
    """Stage outputs encoded on the device give what the host encode of
    their fetched concatenation gives: a decimal whose parts differ in
    scale at the least exact scale (lowered where every value has spare
    digits), NULLs kept where the host keeps them, shared codes, ranges and
    subset-sum bounds; each part's valid rows in the counts."""
    parts = _stage_outputs(seed, raised=raised)
    if raised:
        assert [p.cols[3].scale for p in parts] == [4, 2, 2, 3]
    counts, got, arrays = KT.encode_device_batches(parts, n_dev)
    host = [KT.to_host(p) for p in parts]
    n = sum(b.num_rows for b in host)
    assert counts == [b.num_rows for b in host]
    from ballista_tpu_torch.ops.batch import ColumnBatch

    want = KT.encode_host_batch(ColumnBatch.concat(host),
                                pad=KT.bucket_size(-(-n // n_dev)) * n_dev)
    assert (got.n_rows, got.n_pad) == (want.n_rows, want.n_pad)
    for g, w in zip(got.col_meta, want.col_meta):
        assert g[0] == w[0] and g[1] == w[1] and g[3] == w[3]
        assert (g[2] is None and w[2] is None) or np.array_equal(g[2], w[2])
    assert want.col_meta[3][3] == 2  # the decimal's least exact scale over all parts
    assert got.int_ranges == want.int_ranges and got.ssums == want.ssums
    assert got.dict_ids == want.dict_ids == [None, None, None, None, _WORDS_ID]
    assert len(arrays) == len(want.arrays) == len(got.arrays)
    for g, w in zip(arrays, want.arrays):
        assert g.dtype == torch.from_numpy(w).dtype and np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("case", ["no-shared-dictionary", "string-nulls", "past-2^51",
                                  "raised-past-2^51", "float"])
def test_encode_device_batches_declines_what_only_the_host_encodes(case):
    """A string column without a shared dictionary or with NULLs, a scaled
    value past 2^51 (also one that passes it only when raised to another
    part's scale, where the int64 multiply wraps to a small value) and a
    float that is no decimal: the host's encoding could differ, so the
    device encode returns None."""
    parts = _stage_outputs(7, shared=case != "no-shared-dictionary",
                           nulls=case == "string-nulls", big=case == "past-2^51",
                           floats=case == "float")
    if case == "raised-past-2^51":
        parts[0].cols[3] = KT.rescale_up(parts[0].cols[3], 8)
        # times 10^8 this is 2^64 - 9551616: it wraps to -9551616
        parts[2].cols[3].data[:] = 184467440737
        assert parts[2].cols[3].scale == 0
    assert KT.encode_device_batches(parts, 1) is None


@pytest.mark.parametrize("route,settings", [
    ("device", {}),
    ("host", {"ballista.engine.shared_dicts": "false"}),
    ("host", {"ballista.tpu.fused_input_on_host": "true"}),
    ("host", {"ballista.tpu.min_device_rows": "10000000"}),
], ids=["default", "no-shared-dictionary", "fused-input-on-host", "tiny-stages"])
def test_fused_input_build_route_is_counted(torch_tpch_dir, torch_oracle_tables, route,
                                            settings):
    """q1's fused input is built on the device by default. Its string
    columns without a shared dictionary, ``fused_input_on_host``, and its
    partitions taken by tiny host stages each give the host build. Either
    build counts in its counter, the answer is the oracle's, and each
    stage's span holds its rows (the stages below a device build report
    the rows its one wait counted)."""
    ctx = BallistaContext.standalone(BallistaConfig(settings), device="cpu")
    ctx.register_parquet("lineitem", os.path.join(torch_tpch_dir, "lineitem"))
    TE.clear_caches()
    got = ctx.sql(_sql("q1")).collect().to_pandas()
    assert_frames_match(got, ORACLES["q1"](torch_oracle_tables), True, "q1")
    m = ctx.last_engine_metrics
    other = "host" if route == "device" else "device"
    assert m.get(f"op.FusedInput.{route}_builds") == 1.0
    assert f"op.FusedInput.{other}_builds" not in m
    spans = ctx.last_trace_spans
    stages = [s for s in spans if s["name"] == "CompiledStage"]
    assert all(isinstance(s["attrs"]["rows"], int) for s in stages)
    if route == "device":
        fused = [i for i, s in enumerate(spans)
                 if s["name"] == "DeviceExecute" and s["attrs"]["program"] == "fused"]
        below = [s["attrs"]["rows"] for s in spans[:fused[0]] if s["name"] == "CompiledStage"]
        assert len(below) == 2 and sum(below) == spans[fused[0]]["attrs"]["rows"]


def test_device_cache_eviction_of_a_device_built_input_builds_it_again(ctxs):
    """A fused input built on the device leaves only stand-ins in the
    encode cache. With its shards gone from the device cache, the next run
    builds it on the device again (copying no stand-in) and answers as
    before; the run after is warm and builds nothing."""
    tctx, _ = ctxs[500_000]
    TE.clear_caches()
    want = tctx.sql(_sql("q1")).collect()
    (enc,) = [v for k, v in LC.ENC._entries.items() if k[0] == "fused_in"]
    assert all(a.device.type == "meta" for a in enc.arrays)
    evicted = [k for k in LC.DEV._entries if k[0][0] == "fused_dev"]
    assert evicted
    for k in evicted:
        LC.DEV.invalidate(k)
    assert tctx.sql(_sql("q1")).collect().equals(want)
    assert tctx.last_engine_metrics["op.FusedInput.device_builds"] == 1.0
    assert all(k in LC.DEV._entries for k in evicted)
    assert tctx.sql(_sql("q1")).collect().equals(want)
    assert not any(k.startswith("op.FusedInput.") for k in tctx.last_engine_metrics)


def test_host_sharded_input_replaces_a_device_build(ctxs):
    """A megastage reads the fused input's host encoding: where the cache
    holds a device build's stand-ins under the input's key, the host build
    takes their place."""
    tctx, _ = ctxs[500_000]
    TE.clear_caches()
    child = _fused_input(tctx, "q1")
    engine = TE.TorchEngine(tctx.config, device="cpu")
    mesh = port_mesh(1, "cpu")
    FX.fused_input(engine, child, mesh)
    assert engine.op_metrics["op.FusedInput.device_builds"] == 1.0
    enc, shards = FX.fused_input(engine, child, mesh, device_ok=False)
    assert shards is None and all(isinstance(a, np.ndarray) for a in enc.arrays)
    assert engine.op_metrics["op.FusedInput.host_builds"] == 1.0
    assert FX.fused_input(engine, child, mesh, device_ok=False)[0] is enc


def _write_table(path, values):
    """Two parquet files under ``path`` (so the group-by runs as partial
    and final aggregates over an exchange, the fused shape)."""
    os.makedirs(path, exist_ok=True)
    half = len(values) // 2
    for i, part in enumerate((values[:half], values[half:])):
        pq.write_table(pa.table({"g": pa.array([v % 3 for v in part], pa.int64()),
                                 "x": pa.array(part, pa.int64())}),
                       os.path.join(path, f"part-{i}.parquet"))


GROUP_SQL = "select g, sum(x) as s, count(*) as n from t group by g order by g"


def test_table_registered_again_misses_the_cache(tmp_path):
    """A parquet file rewritten in place and registered again, and an
    in-memory table registered again under the same name: the next run
    reads the new rows, not the cached encoding."""
    path = str(tmp_path / "t")
    _write_table(path, list(range(100)))
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_parquet("t", path)
    first = ctx.sql(GROUP_SQL).collect().column("s").to_pylist()
    assert ctx.sql(GROUP_SQL).collect().column("s").to_pylist() == first  # warm
    _write_table(path, list(range(100, 250)))
    ctx.register_parquet("t", path)
    second = ctx.sql(GROUP_SQL).collect().column("s").to_pylist()
    assert second == [sum(v for v in range(100, 250) if v % 3 == g) for g in range(3)]

    for lo, hi in ((0, 40), (40, 90)):
        values = list(range(lo, hi))
        ctx.register_arrow("t", pa.table({"g": pa.array([v % 3 for v in values], pa.int64()),
                                          "x": pa.array(values, pa.int64())}), partitions=2)
        got = ctx.sql(GROUP_SQL).collect().column("s").to_pylist()
        assert got == [sum(v for v in values if v % 3 == g) for g in range(3)]


def _fused_pins():
    return [k for k in LC.DEV._pinned if k[0][0] == "fused_dev"]


def test_pin_device_cache_pins_and_unpins_on_reregistration(tmp_path):
    """``ballista.tpu.pin_device_cache`` pins the fused input's device copy;
    a table registered again with new content moves the one pin to the new
    copy and drops the old; with pinning off the pin is released."""
    TE.clear_caches()
    path = str(tmp_path / "t")
    _write_table(path, list(range(60)))
    ctx = BallistaContext.standalone(
        BallistaConfig({"ballista.tpu.pin_device_cache": "true"}), device="cpu")
    ctx.register_parquet("t", path)
    ctx.sql(GROUP_SQL).collect()
    first = _fused_pins()
    assert len(first) == 1 and first[0][1] == "cpu"
    _write_table(path, list(range(60, 200)))
    ctx.register_parquet("t", path)
    ctx.sql(GROUP_SQL).collect()
    second = _fused_pins()
    assert len(second) == 1 and second != first
    assert LC.DEV.get(first[0]) is None  # the old content's copy is gone
    ctx.config.set("ballista.tpu.pin_device_cache", False)
    ctx.sql(GROUP_SQL).collect()
    assert _fused_pins() == []


def test_device_cache_keys_name_the_device_and_ephemeral_scans_have_none(torch_tpch_dir):
    ctx = BallistaContext.standalone(device="cpu")
    ctx.register_parquet("lineitem", os.path.join(torch_tpch_dir, "lineitem"))
    ctx.sql(_sql("q6")).collect()
    keys = list(LC.DEV._entries)
    assert keys and all(k[1] == "cpu" for k in keys)
    batch = TE.ColumnBatch.from_arrow(pa.table({"a": [1, 2]}))
    scan = P.MemoryScanExec([batch], batch.schema)
    assert TE._leaf_cache_key(scan, 0) is not None
    scan.ephemeral = True
    assert TE._leaf_cache_key(scan, 0) is None


# ---- a partitioned join whose right (build) keys repeat ---------------------------------------
# a: unique keys, every 7th NULL; b: keys that repeat, every 11th NULL. b has
# under twice a's rows, so the planner keeps a on the left
REPEAT_A = pa.table({"k": pa.array([i if i % 7 else None for i in range(40)], pa.int64()),
                     "s": pa.array([f"s{i % 5}" for i in range(40)]),
                     "x": pa.array([i * 1.5 for i in range(40)], pa.float64())})
REPEAT_B = pa.table({"k2": pa.array([(i * 3) % 45 if i % 11 else None for i in range(70)],
                                    pa.int64()),
                     "y": pa.array([i * 2 for i in range(70)], pa.int32())})
SWAPPED_JOINS = {
    "inner": "select * from a join b on a.k = b.k2",
    "inner-with-residual-filter": "select * from a join b on a.k = b.k2 and a.x < b.y",
}
# (query, fused programs its first and its second execution run)
DECLINED_JOINS = {
    "both-sides-repeat": ("select * from b join b as c on b.k2 = c.k2", [1, 0]),
    "left": ("select * from a left join b on a.k = b.k2", [0, 0]),
    "semi": ("select * from a where k in (select k2 from b)", [0, 0]),
    "anti": ("select * from a where not exists (select 1 from b where b.k2 = a.k)", [0, 0]),
}


@pytest.fixture(scope="module")
def repeat_ctxs():
    """(torch, host engine, JAX engine over one device) contexts over ``a``
    and ``b`` in two partitions each, every join partitioned."""
    t = BallistaContext.standalone(device="cpu")
    h = BallistaContext.standalone(device="cpu", backend="numpy")
    j = JaxContext.standalone(backend="jax")
    for c in (t, h, j):
        c.config.set("ballista.optimizer.broadcast_rows_threshold", 0)
        c.register_arrow("a", REPEAT_A, partitions=2)
        c.register_arrow("b", REPEAT_B, partitions=2)
    make = j._get_engine

    def one_device():
        engine = make()
        engine.mesh_devices = 1
        return engine

    j._get_engine = one_device
    return t, h, j


def _answers_agree(ctxs, sql):
    """The port's rows for ``sql``, its metrics, and both references' rows
    checked against them."""
    t, h, j = ctxs
    got = t.sql(sql).collect().to_pandas()
    m = dict(t.last_engine_metrics)
    assert_frames_match(got, h.sql(sql).collect().to_pandas(), False, "vs host engine")
    assert_frames_match(got, j.sql(sql).collect().to_pandas(), False, "vs jax")
    return got, m


@pytest.mark.parametrize("case", sorted(SWAPPED_JOINS))
def test_inner_join_over_repeated_right_keys_sorts_its_unique_left_side(repeat_ctxs,
                                                                        monkeypatch, case):
    """q12's shape: the fused join runs with the roles exchanged (the left
    side sorted, the right probing it) instead of declining to the
    materialized exchange; its output keeps the join's schema, left columns
    first; NULL keys on either side never match; a residual filter is
    evaluated over the (left, right) pair as the join's schema binds it."""
    joins = []
    real = FX.run_fused_join

    def recording(engine, join_plan, n_dev):
        out = real(engine, join_plan, n_dev)
        # the output's schema as the program left it (the engine releases it)
        joins.append((join_plan, out[0].schema))
        return out

    monkeypatch.setattr(FX, "run_fused_join", recording)
    _cold_leaf_caches()
    got, m = _answers_agree(repeat_ctxs, SWAPPED_JOINS[case])
    assert m.get("op.FusedJoin.swapped") == 1.0
    assert m.get("op.FusedIciJoin.count") == 16.0
    assert "op.FusedDeclined.count" not in m and "op.RepartitionExec.output_rows" not in m
    [(join_plan, schema)] = joins
    want = [(f.name, f.dtype) for f in join_plan.schema()]
    assert [(f.name, f.dtype) for f in schema] == want
    assert [n for n, _ in want] == ["a.k", "a.s", "a.x", "b.k2", "b.y"]
    lk, rk = got.iloc[:, 0], got.iloc[:, 3]
    assert len(got) > 0 and lk.notna().all() and (lk == rk).all()


@pytest.mark.parametrize("case", sorted(DECLINED_JOINS))
def test_join_over_repeated_right_keys_declines_where_the_swap_does_not_fit(repeat_ctxs,
                                                                            monkeypatch, case):
    """Left, semi and anti joins over repeated right keys decline before any
    program, as an inner join whose two sides both repeat does once its
    first program has read the left side's keys: a second execution over
    the same content runs no fused program. The materialized exchange
    answers each time."""
    sql, want_programs = DECLINED_JOINS[case]
    programs = []
    real = FX.make_join_dev_fn

    def counting(*args, **kw):
        programs.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(FX, "make_join_dev_fn", counting)
    _cold_leaf_caches()
    ran = []
    for _run in ("first", "second"):
        programs.clear()
        _got, m = _answers_agree(repeat_ctxs, sql)
        ran.append(len(programs))
        assert m.get("op.FusedDeclined.count") == 1.0
        assert "op.FusedJoin.swapped" not in m and "op.FusedIciJoin.count" not in m
        assert m.get("op.RepartitionExec.output_rows", 0.0) > 0
    assert ran == want_programs


def test_fused_join_estimate_prices_the_roles_as_run(repeat_ctxs):
    """The columns gathered onto each probing row are priced on the side
    that probes: with the roles exchanged, the left columns onto each right
    row, so a large sorted left side costs its exchange and sort alone."""
    from ballista_tpu_torch.plan.optimizer import optimize
    from ballista_tpu_torch.plan.physical_planner import PhysicalPlanner
    from ballista_tpu_torch.sql.parser import parse_sql
    from ballista_tpu_torch.sql.planner import SqlPlanner

    t = repeat_ctxs[0]
    plan = SqlPlanner(t.catalog.schemas()).plan(parse_sql(SWAPPED_JOINS["inner"]))
    phys = PhysicalPlanner(t.catalog, t.config).plan(optimize(plan, t.catalog))
    [join_plan] = [n for n in P.walk_physical(phys) if isinstance(n, P.HashJoinExec)]
    lenc = KT.encode_host_batch(TE.ColumnBatch.from_arrow(pa.concat_tables([REPEAT_A] * 50)))
    renc = KT.encode_host_batch(TE.ColumnBatch.from_arrow(REPEAT_B))
    as_planned = FX.join_estimate(join_plan, lenc, renc, 1, 1)(0)
    swapped = FX.join_estimate(join_plan, lenc, renc, 1, 1, build_left=True)(0)
    right_w = MM.row_data_bytes(join_plan.right.schema()) + 1
    left_w = MM.row_data_bytes(join_plan.left.schema()) + 1
    assert lenc.n_pad == 2048 and renc.n_pad == 128
    assert as_planned - swapped == lenc.n_pad * right_w - renc.n_pad * left_w > 0


# ---- tiny-stage dispatch -------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_ctxs(torch_tpch_dir):
    t, j = _contexts(torch_tpch_dir, 500_000)
    for c in (t, j):
        c.config.set("ballista.tpu.min_device_rows", 10_000_000)
    return t, j


# queries whose stages fall back before the tiny check: q22's anti join, whose
# build keys repeat past 32, is prepared (and refused) before it, on both engines
FALLS_BACK_BEFORE_TINY = {"q22"}


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 23)])
def test_tpch_with_tiny_dispatch(tiny_ctxs, torch_oracle_tables, qname):
    tctx, jctx = tiny_ctxs
    _cold_leaf_caches()
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    tm = dict(tctx.last_engine_metrics)
    assert_frames_match(got, ORACLES[qname](torch_oracle_tables), qname in ORDERED, qname)
    jctx.sql(_sql(qname)).collect()
    jm = jctx.last_engine_metrics
    assert tm.get("op.HostTinyStage.count", 0.0) > 0
    assert tm["op.HostTinyStage.count"] == jm["op.HostTinyStage.count"]
    assert _host_ops(tm) == _host_ops(jm)
    assert (tm.get("op.HostFallback.count", 0.0) > 0) == (qname in FALLS_BACK_BEFORE_TINY)


# ---- decimal to float ---------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("ft", ["float32", "float64"])
def test_as_float_matches_kernels_jax(scale, ft):
    """Scaled int64 to float divides by the divisor rounded to the working
    width: bit for bit the JAX package's ``_as_float``."""
    rng = np.random.default_rng(scale)
    data = rng.integers(-(10**12), 10**12, 100_000).astype(np.int64)
    got = KT._as_float(KT.DeviceCol(KT.DataType.FLOAT64, torch.from_numpy(data), scale=scale),
                       getattr(torch, ft))
    want = KJ._as_float(KJ.DeviceCol(KJ.DataType.FLOAT64, jnp.asarray(data), scale=scale),
                        getattr(jnp, ft))
    assert got.numpy().dtype == np.asarray(want).dtype
    assert np.array_equal(got.numpy().view(np.uint8), np.asarray(want).view(np.uint8))
