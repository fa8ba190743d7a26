"""Streaming through the PyTorch port, held against the JAX package.

Mirrors every case of ``tests/test_stream_device.py`` (device streaming:
merge-mode folds, spliced filter/project/probe-join chains, prepared builds
cached across chunks) and ``tests/test_stream_shuffle.py`` (chunked shuffle
reads, remote fetch to spill files, partial-state folds, the incremental
shuffle writer) on the port's torch engine (``device="cpu"``) and its numpy
engine, each case fed the same seeded numpy inputs as the JAX package.

Beyond the mirrors: the side-stream prefetch (depth 2 equals depth 0, its
counters, a failed pre-encode counted and not hidden), the streamed
aggregate's state spill on the device path, one grouped_sums call per merge
stage, and TPC-H q1, q3, q5 and q12 run stage by stage through shuffle files
(``run_staged``: the port's ``plan_query_stages`` with every task streamed
into ``write_shuffle_stream``) against the JAX engine driving the same loop
with its own planner.

Tolerances: ints, strings and decimals exact; f64 sums and averages of
random doubles within rtol 1e-9 (the JAX package's own tests' tolerance:
chunked folds add in another order).
"""
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from test_torch_data import torch_tpch_dir  # noqa: F401

QUERIES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries")


def _pkg(name: str) -> SimpleNamespace:
    m = lambda s: importlib.import_module(f"{name}.{s}")  # noqa: E731
    return SimpleNamespace(
        name=name, cfg=m("config"), batch=m("ops.batch"), expr=m("plan.expr"),
        phys=m("plan.physical"), schema=m("plan.schema"), writer=m("shuffle.writer"),
        stream=m("shuffle.stream"), reader=m("shuffle.reader"), knp=m("ops.kernels_np"),
        numpy_engine=m("engine.numpy_engine"), planner=m("scheduler.planner"),
    )


JAX = _pkg("ballista_tpu")
PORT = _pkg("ballista_tpu_torch")


def _engine(pkg, backend: str, settings=None):
    cfg = pkg.cfg.BallistaConfig(dict(settings or {}))
    if backend == "jax":
        from ballista_tpu.engine.jax_engine import JaxEngine

        return JaxEngine(cfg)
    if backend == "torch":
        from ballista_tpu_torch.engine.torch_engine import TorchEngine

        return TorchEngine(cfg, device="cpu")
    return pkg.numpy_engine.NumpyEngine(cfg)


def _make_data(n: int, seed: int = 0, strings: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    d = {"k": rng.integers(0, 97, n).astype(np.int64), "v": rng.normal(size=n)}
    if strings:
        d["s"] = np.array([f"str{i % 13}" for i in range(n)])
    return d


def _batch(pkg, data: dict):
    return pkg.batch.ColumnBatch.from_dict(data)


def _loc(path: str, stage: int, **kw) -> dict:
    return dict({"path": path, "host": "h", "flight_port": 0, "executor_id": "e",
                 "stage_id": stage, "map_partition": 0}, **kw)


def _shuffle_reader(pkg, tmp_path, batch, stage=5, job="jdev", pieces=1):
    """``batch`` materialized as a one-output shuffle by ``pkg``'s writer,
    in ``pieces`` map tasks of equal slices, and the reader node over it."""
    P, E = pkg.phys, pkg.expr
    wplan = P.ShuffleWriterExec(job, stage, P.MemoryScanExec([batch], batch.schema),
                                P.HashPartitioning((E.Col("k"),), 1))
    step = -(-batch.num_rows // pieces)
    locs = []
    for m in range(pieces):
        part = batch.slice(m * step, min(step, batch.num_rows - m * step))
        for s in pkg.writer.write_shuffle_partitions(wplan, m, part, str(tmp_path)):
            locs.append(_loc(s.path, stage, map_partition=m))
    return P.ShuffleReaderExec(stage, batch.schema, [locs])


def _stream_cfg(chunk_rows=4_096, device_rows=16_384, **extra) -> dict:
    return dict({"ballista.shuffle.stream_chunk_rows": str(chunk_rows),
                 "ballista.tpu.stream_device_rows": str(device_rows)}, **extra)


def _collect(engine, plan) -> pa.Table:
    return pa.concat_tables([b.to_arrow() for b in engine.execute_partition_stream(plan, 0)])


def _assert_tables(got: pa.Table, want: pa.Table, keys, floats=(), rtol=1e-9):
    """Equal after sorting by ``keys``: every column exact but ``floats``."""
    order = [(k, "ascending") for k in keys]
    got, want = got.sort_by(order), want.sort_by(order)
    assert got.num_rows == want.num_rows
    assert got.column_names == want.column_names
    for c in got.column_names:
        if c in floats:
            np.testing.assert_allclose(got.column(c).to_numpy(zero_copy_only=False),
                                       want.column(c).to_numpy(zero_copy_only=False), rtol=rtol)
        else:
            assert got.column(c).to_pylist() == want.column(c).to_pylist(), c


# ---- plans of the device-streaming cases, built alike in either package -------------
def _aggs(pkg, fns):
    E = pkg.expr
    return [E.Alias(E.Agg(fn, None if fn == "count_star" else E.Col(col)), name)
            for fn, col, name in fns]


FOLD_AGGS = [("sum", "v", "sv"), ("avg", "v", "av"), ("min", "v", "mn"), ("count_star", None, "c")]


def _final_over_partial(pkg, tmp_path, data, fns, stage, filt=None):
    """A final aggregate over a shuffle read of ``data``'s partial states
    (computed by ``pkg``'s host engine), optionally with a filter between."""
    P, E, S = pkg.phys, pkg.expr, pkg.schema
    raw = _batch(pkg, data)
    aggs = _aggs(pkg, fns)
    partial_node = P.HashAggregateExec(P.MemoryScanExec([raw], raw.schema), "partial",
                                       [E.Col("k")], aggs)
    partial = pkg.numpy_engine.NumpyEngine().execute_partition(partial_node, 0)
    node = _shuffle_reader(pkg, tmp_path, partial, stage=stage)
    if filt is not None:
        node = P.FilterExec(node, E.BinaryOp("<", E.Col("k"), E.Lit(filt, S.DataType.INT64)))
    return P.HashAggregateExec(node, "final", [E.Col("k")], aggs, raw.schema)


def _filter_project(pkg, tmp_path, data, stage, pieces=4):
    P, E, S = pkg.phys, pkg.expr, pkg.schema
    reader = _shuffle_reader(pkg, tmp_path, _batch(pkg, data), stage=stage, pieces=pieces)
    filt = P.FilterExec(reader, E.BinaryOp(">", E.Col("v"), E.Lit(0.0, S.DataType.FLOAT64)))
    return P.ProjectExec(filt, [
        E.Alias(E.Col("k"), "k"),
        E.Alias(E.BinaryOp("*", E.Col("v"), E.Lit(2.0, S.DataType.FLOAT64)), "v2"),
    ])


def _builds(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [{"bk": np.arange(97, dtype=np.int64), "w": rng.normal(size=97)},
            {"ck": np.arange(97, dtype=np.int64), "z": rng.normal(size=97)}][:n]


def _probe_joins(pkg, tmp_path, data, builds, stage, pieces=4):
    """``len(builds)`` stacked collected-build inner joins over a shuffle
    read of ``data`` in ``pieces`` map pieces, keyed on ``k``."""
    P, E = pkg.phys, pkg.expr
    node = _shuffle_reader(pkg, tmp_path, _batch(pkg, data), stage=stage, pieces=pieces)
    for b in builds:
        bb = _batch(pkg, b)
        key = next(iter(b))
        node = P.HashJoinExec(left=node, right=P.MemoryScanExec([bb], bb.schema),
                              on=[(E.Col("k"), E.Col(key))], how="inner", collect_build=True)
    return node


def _run_both(tmp_path, build, backend, settings):
    """(port result, JAX engine result, port engine) of the plan ``build``
    makes in each package from the same data."""
    jplan = build(JAX, tmp_path / "jax")
    pplan = build(PORT, tmp_path / "port")
    want = _collect(_engine(JAX, "jax", settings), jplan)
    eng = _engine(PORT, backend, settings)
    return _collect(eng, pplan), want, eng


BACKENDS = ["torch", "numpy"]


@pytest.fixture
def kernel_calls(monkeypatch):
    """(k, columns) of each grouped_sums call: the CPU runs its plain
    version, so the launch counter stays 0 here and the call shows the path."""
    import ballista_tpu_torch.ops.grouped_sums as GS

    real = GS.grouped_sums_multi
    calls = []

    def counting(vals, masks, ids, k):
        calls.append((k, len(vals)))
        return real(vals, masks, ids, k)

    monkeypatch.setattr(GS, "grouped_sums_multi", counting)
    return calls


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_final_agg_folds_on_device(tmp_path, backend):
    data = _make_data(100_000, seed=5)
    got, want, eng = _run_both(
        tmp_path, lambda pkg, d: _final_over_partial(pkg, d, data, FOLD_AGGS, 5),
        backend, _stream_cfg())
    _assert_tables(got, want, ["k"], floats=("sv", "av", "mn"))
    if backend == "torch":
        # the fold ran as device stages, not host kernels
        assert eng.op_metrics.get("op.CompiledStage.time_s", 0.0) > 0.0
        assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_filter_project_chain_on_device(tmp_path, backend):
    data = _make_data(60_000, seed=9)
    got, want, eng = _run_both(
        tmp_path, lambda pkg, d: _filter_project(pkg, d, data, 6), backend, _stream_cfg())
    _assert_tables(got, want, ["k", "v2"], floats=("v2",), rtol=1e-12)
    if backend == "torch":
        assert eng.op_metrics.get("op.CompiledStage.time_s", 0.0) > 0.0
        assert eng.op_metrics["op.ProjectExec.output_rows"] == want.num_rows
        # four 15k-row pieces coalesced to 16k rows: two device chunks
        assert eng.op_metrics["op.StreamChunk.count"] == 2
        assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_probe_join_on_device(tmp_path, backend):
    data = _make_data(50_000, seed=13)
    builds = _builds(14, 1)
    got, want, eng = _run_both(
        tmp_path, lambda pkg, d: _probe_joins(pkg, d, data, builds, 7), backend, _stream_cfg())
    _assert_tables(got, want, ["k", "v"], floats=("v", "w"), rtol=1e-12)
    if backend == "torch":
        assert eng.op_metrics.get("op.CompiledStage.time_s", 0.0) > 0.0
        assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_chain_under_final_agg_single_program(tmp_path, backend):
    """filter -> merge fold runs as one device stage per chunk."""
    data = _make_data(80_000, seed=21)
    fns = [("sum", "v", "sv"), ("count_star", None, "c")]
    got, want, eng = _run_both(
        tmp_path, lambda pkg, d: _final_over_partial(pkg, d, data, fns, 8, filt=50),
        backend, _stream_cfg())
    _assert_tables(got, want, ["k"], floats=("sv",))
    if backend == "torch":
        assert eng.op_metrics.get("op.CompiledStage.time_s", 0.0) > 0.0
        assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0


def _merge_case(pkg, data, fns):
    """(partial states of ``data``, the merge node over them, its aggs)."""
    P, E = pkg.phys, pkg.expr
    raw = _batch(pkg, data)
    aggs = _aggs(pkg, fns)
    partial = pkg.numpy_engine.NumpyEngine().execute_partition(
        P.HashAggregateExec(P.MemoryScanExec([raw], raw.schema), "partial", [E.Col("g")], aggs), 0)
    merge = P.HashAggregateExec(P.MemoryScanExec([partial], partial.schema), "merge",
                                [E.Col("g")], aggs)
    return partial, merge, aggs


def test_merge_mode_device_matches_host(kernel_calls):
    """merge-mode parity: the torch engine's device fold, the port's host
    fold and the JAX engine's device fold on the same partial-layout batch;
    its sums and counts are one grouped_sums call (7 groups)."""
    rng = np.random.default_rng(31)
    data = {"g": rng.integers(0, 7, 20_000).astype(np.int64), "x": rng.normal(size=20_000)}
    fns = [("sum", "x", "sx"), ("avg", "x", "ax"), ("max", "x", "mx"), ("count", "x", "cx")]
    partial, merge, aggs = _merge_case(PORT, data, fns)
    host = PORT.knp.merge_partial_states(partial, [PORT.expr.Col("g")], aggs).to_arrow()
    _, jmerge, _ = _merge_case(JAX, data, fns)
    jdev = _engine(JAX, "jax").execute_partition(jmerge, 0).to_arrow()
    kernel_calls.clear()
    eng = _engine(PORT, "torch")
    dev = eng.execute_partition(merge, 0).to_arrow()
    assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0
    # f64 sums are index_add_ sums; the counts and the seen-count one call
    assert len(kernel_calls) == 1 and kernel_calls[0][0] <= 32
    floats = ("sx#sum", "ax#sum", "mx#max")
    _assert_tables(dev, host, ["g"], floats=floats)
    _assert_tables(dev, jdev, ["g"], floats=floats)


def test_merge_mode_decimal_states_exact(kernel_calls):
    """Decimal states fold exactly: partial-layout rows of 2-decimal sums
    (some NULL), AVG (sum, count) pairs, minima and counts fold on the
    device into scaled int64 sums equal to an exact int64 reference, equal
    to the JAX engine's fold bit for bit, in one grouped_sums call; the
    host's f64 fold agrees within 1e-12."""
    rng = np.random.default_rng(33)
    n = 30_000
    g = rng.integers(0, 4, n)
    cents = rng.integers(-10**9, 10**9, n)
    null = np.arange(n) % 11 == 0
    null[g == 3] = True                      # group 3 saw no value at all
    cnt = rng.integers(1, 50, n)
    dec = [None if z else int(c) / 100 for z, c in zip(null, cents)]
    state = pa.table({
        "g": pa.array(g, pa.int64()),
        "sd#sum": pa.array(dec, pa.float64()),
        "ad#sum": pa.array(cents / 100, pa.float64()),
        "ad#count": pa.array(cnt, pa.int64()),
        "mn#min": pa.array(dec, pa.float64()),
        "cd#count": pa.array(np.where(null, 0, cnt), pa.int64()),
    })
    fns = [("sum", "d", "sd"), ("avg", "d", "ad"), ("min", "d", "mn"), ("count", "d", "cd")]

    def merge_of(pkg):
        P, E = pkg.phys, pkg.expr
        b = pkg.batch.ColumnBatch.from_arrow(state)
        return b, P.HashAggregateExec(P.MemoryScanExec([b], b.schema), "merge", [E.Col("g")],
                                      _aggs(pkg, fns))

    b, merge = merge_of(PORT)
    kernel_calls.clear()
    eng = _engine(PORT, "torch")
    dev = eng.execute_partition(merge, 0).to_arrow().sort_by("g")
    assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0
    assert len(kernel_calls) == 1 and kernel_calls[0][0] <= 32
    jdev = _engine(JAX, "jax").execute_partition(merge_of(JAX)[1], 0).to_arrow()
    _assert_tables(dev, jdev, ["g"])
    exact = {k: int(cents[(g == k) & ~null].sum()) for k in range(4)}
    sums = dev.column("sd#sum").to_pylist()
    assert sums[3] is None
    for k in range(3):
        assert round(sums[k] * 100) == exact[k] and sums[k] == exact[k] / 100
    assert dev.column("ad#sum").to_pylist() == [int(cents[g == k].sum()) / 100 for k in range(4)]
    assert dev.column("ad#count").to_pylist() == [int(cnt[g == k].sum()) for k in range(4)]
    host = PORT.knp.merge_partial_states(b, [PORT.expr.Col("g")], merge.agg_exprs).to_arrow()
    _assert_tables(dev, host, ["g"], floats=("sd#sum", "ad#sum"), rtol=1e-12)


def test_string_minmax_merge_null_state():
    """A group whose string min/max state is entirely null folds without
    raising and surfaces as a null, in both packages' host folds; the torch
    engine takes the host fold there, as the JAX engine does."""
    t = pa.table({"g": pa.array([0, 0, 1], pa.int64()),
                  "m#min": pa.array([None, None, "abc"], pa.string())})
    outs = []
    for pkg in (JAX, PORT):
        state = pkg.batch.ColumnBatch.from_arrow(t)
        aggs = _aggs(pkg, [("min", "m", "m")])
        outs.append(pkg.knp.merge_partial_states(state, [pkg.expr.Col("g")], aggs)
                    .to_arrow().sort_by("g").to_pydict())
    assert outs[0] == outs[1] == {"g": [0, 1], "m#min": [None, "abc"]}
    state = PORT.batch.ColumnBatch.from_arrow(t)
    P, E = PORT.phys, PORT.expr
    merge = P.HashAggregateExec(P.MemoryScanExec([state], state.schema), "merge", [E.Col("g")],
                                _aggs(PORT, [("min", "m", "m")]))
    eng = _engine(PORT, "torch")
    assert eng.execute_partition(merge, 0).to_arrow().sort_by("g").to_pydict() == outs[1]
    assert eng.op_metrics["op.HostFallback.count"] == 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_two_stacked_probe_joins_prep_cached(tmp_path, backend):
    """Two collected-build joins above a streamed shuffle read: each build
    is prepared once per execution (keyed on the splice-kept build subtree,
    not the per-chunk join node) and rows match the JAX engine."""
    data = _make_data(40_000, seed=17)
    builds = _builds(18, 2)
    got, want, eng = _run_both(
        tmp_path, lambda pkg, d: _probe_joins(pkg, d, data, builds, 9), backend,
        _stream_cfg(chunk_rows=2_048, device_rows=8_192))
    _assert_tables(got, want, ["k", "v"], floats=("v", "w", "z"), rtol=1e-12)
    if backend == "torch":
        assert len(eng._build_prep) == 2, sorted(eng._build_prep)
        # four 10k-row pieces, each past the 8192-row budget: four chunks
        assert eng.op_metrics["op.StreamChunk.count"] == 4


# ---- mirrors of tests/test_stream_shuffle.py --------------------------------------
def _write_piece(pkg, tmp_path, batch, job="jstream", stage=1, nparts=2):
    P, E = pkg.phys, pkg.expr
    plan = P.ShuffleWriterExec(job, stage, P.MemoryScanExec([batch], batch.schema),
                               P.HashPartitioning((E.Col("k"),), nparts))
    return pkg.writer.write_shuffle_partitions(plan, 0, batch, str(tmp_path))


def test_chunked_local_read_matches_materialized(tmp_path):
    data = _make_data(200_000, strings=True)
    for pkg in (JAX, PORT):
        stats = _write_piece(pkg, tmp_path / pkg.name, _batch(pkg, data))
        loc = [_loc(stats[0].path, 1)]
        chunks = list(pkg.stream.iter_shuffle_partition(loc, chunk_rows=10_000))
        assert len(chunks) > 1, "should stream in multiple chunks"
        assert sum(c.num_rows for c in chunks) == stats[0].num_rows
        whole = pkg.reader.read_shuffle_partition(loc, _batch(pkg, data).schema)
        assert pa.concat_tables([c.to_arrow() for c in chunks]).equals(whole.to_arrow())
        if pkg is JAX:
            jwhole = whole.to_arrow()
        else:
            # the same bucket, row for row up to order
            _assert_tables(whole.to_arrow(), jwhole, ["k", "v"])


def test_remote_fetch_spills_to_disk_and_cleans_up(tmp_path):
    from ballista_tpu_torch.shuffle.flight import ShuffleFlightServer

    data = _make_data(50_000, seed=3, strings=True)
    stats = _write_piece(PORT, tmp_path / "work", _batch(PORT, data))
    server = ShuffleFlightServer("127.0.0.1", 0, str(tmp_path / "work"))
    server.serve_background()
    try:
        spill = tmp_path / "spill"
        # a path that does not exist here makes the reader fetch it remotely
        os.rename(stats[1].path, stats[1].path + ".remote")
        loc = [_loc(stats[1].path + ".remote", 1, host="127.0.0.1", flight_port=server.port)]
        chunks = list(PORT.stream.iter_shuffle_partition(loc, chunk_rows=8_000,
                                                         spill_dir=str(spill)))
        assert sum(c.num_rows for c in chunks) == stats[1].num_rows
        assert list(spill.glob("fetch-*")) == []
        jstats = _write_piece(JAX, tmp_path / "jax", _batch(JAX, data))
        want = JAX.reader.read_shuffle_partition([_loc(jstats[1].path, 1)],
                                                 _batch(JAX, data).schema).to_arrow()
        _assert_tables(pa.concat_tables([c.to_arrow() for c in chunks]), want, ["k", "v"])
    finally:
        server.shutdown()


def test_remote_fetch_failure_maps_to_fetch_failed(tmp_path, monkeypatch):
    from ballista_tpu_torch.errors import FetchFailed

    monkeypatch.setattr(PORT.stream, "RETRY_BACKOFF_S", 0.01)
    loc = [{"path": "/nope/gone.arrow", "host": "127.0.0.1", "flight_port": 1,
            "executor_id": "eX", "stage_id": 9, "map_partition": 4}]
    with pytest.raises(FetchFailed) as ei:
        list(PORT.stream.iter_shuffle_partition(loc, spill_dir=str(tmp_path)))
    assert (ei.value.executor_id, ei.value.map_stage_id, ei.value.map_partition_id) == \
        ("eX", 9, 4)


def test_merge_partial_states_fold_matches_single_shot():
    """Folding partial chunks through the port's merge_partial_states, then
    finalizing, equals one final aggregate over the concatenation, and the
    JAX package's fold."""
    rng = np.random.default_rng(7)
    data = {"g": rng.integers(0, 11, 30_000).astype(np.int64), "x": rng.normal(size=30_000)}
    fns = [("sum", "x", "sx"), ("avg", "x", "ax"), ("count", "x", "cx"),
           ("min", "x", "mn"), ("max", "x", "mx")]
    outs = []
    for pkg in (JAX, PORT):
        P, E, K = pkg.phys, pkg.expr, pkg.knp
        raw = _batch(pkg, data)
        aggs = _aggs(pkg, fns)
        group = [E.Col("g")]
        partial_node = P.HashAggregateExec(P.MemoryScanExec([raw], raw.schema), "partial",
                                           group, aggs)
        partial = K.aggregate_groups(raw, group, aggs, "partial", partial_node.schema())
        final_schema = P.HashAggregateExec(partial_node, "final", group, aggs, raw.schema).schema()
        expect = K.aggregate_groups(partial, group, aggs, "final", final_schema)
        state = None
        bounds = np.linspace(0, partial.num_rows, 8).astype(int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            chunk = partial.slice(int(lo), int(hi - lo))
            merged = chunk if state is None else pkg.batch.ColumnBatch.concat([state, chunk])
            state = K.merge_partial_states(merged, group, aggs)
        got = K.aggregate_groups(state, group, aggs, "final", final_schema)
        _assert_tables(got.to_arrow(), expect.to_arrow(), ["g"], floats=("sx", "ax", "mn", "mx"))
        outs.append(got.to_arrow())
    _assert_tables(outs[1], outs[0], ["g"], floats=("sx", "ax", "mn", "mx"))


def test_write_shuffle_stream_matches_one_shot(tmp_path):
    data = _make_data(40_000, seed=11, strings=True)
    batch = _batch(PORT, data)
    P, E = PORT.phys, PORT.expr
    plan = P.ShuffleWriterExec("jws", 3, P.MemoryScanExec([batch], batch.schema),
                               P.HashPartitioning((E.Col("k"),), 4))
    one = PORT.writer.write_shuffle_partitions(plan, 0, batch, str(tmp_path / "one"))
    chunks = [batch.slice(i, 7_000) for i in range(0, batch.num_rows, 7_000)]
    streamed, rows = PORT.stream.write_shuffle_stream(plan, 0, iter(chunks), str(tmp_path / "two"))
    jstats = _write_piece(JAX, tmp_path / "jax", _batch(JAX, data), nparts=4)
    assert rows == batch.num_rows
    assert len(streamed) == len(one) == 4
    for s1, s2, sj in zip(one, streamed, jstats):
        assert s1.output_partition == s2.output_partition == sj.output_partition
        assert s1.num_rows == s2.num_rows == sj.num_rows
        t1 = PORT.writer.read_ipc_file(s1.path)
        _assert_tables(PORT.writer.read_ipc_file(s2.path), t1, ["k", "v"])
        _assert_tables(JAX.writer.read_ipc_file(sj.path), t1, ["k", "v"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_stream_final_aggregate_e2e(tmp_path, backend):
    """A shuffle read and final aggregate streamed in 16-row chunks equals
    the one-shot execution and the JAX host engine's stream."""
    data = _make_data(120_000, seed=5)
    fns = [("sum", "v", "sv"), ("count_star", None, "c")]
    cfg = {"ballista.shuffle.stream_chunk_rows": "16"}
    jplan = _final_over_partial(JAX, tmp_path / "jax", data, fns, 5)
    want = _collect(_engine(JAX, "numpy", cfg), jplan)
    pplan = _final_over_partial(PORT, tmp_path / "port", data, fns, 5)
    eng = _engine(PORT, backend, cfg)
    got = _collect(eng, pplan)
    _assert_tables(got, want, ["k"], floats=("sv",))
    one = _engine(PORT, "numpy").execute_partition(pplan, 0).to_arrow()
    _assert_tables(got, one, ["k"], floats=("sv",))


# ---- the prefetch and the device-side state spill ---------------------------------
def test_prefetch_depth_two_gives_the_chunks_of_depth_zero(tmp_path):
    """The pipelined chunks (pre-encoded, copied ahead) give the rows of the
    synchronous path; every chunk's copy was prefetched and none failed."""
    data = _make_data(60_000, seed=41)
    builds = _builds(42, 1)
    plan = _probe_joins(PORT, tmp_path, data, builds, 10)
    runs = {}
    for depth in ("0", "2"):
        eng = _engine(PORT, "torch", _stream_cfg(device_rows=8_192)
                      | {"ballista.engine.prefetch_depth": depth})
        runs[depth] = (_collect(eng, plan), eng.op_metrics)
    _assert_tables(runs["2"][0], runs["0"][0], ["k", "v"])
    m0, m2 = runs["0"][1], runs["2"][1]
    assert m2["op.StreamChunk.count"] == m0["op.StreamChunk.count"] == 4
    assert m2["op.PrefetchEncode.count"] == m2["op.PrefetchH2D.count"] == 4
    assert m2.get("op.PrefetchEncode.failed", 0.0) == 0.0
    assert "op.PrefetchH2D.count" not in m0
    # the prefetched chunks never went through the synchronous transfer
    assert m2["op.DeviceTransfer.bytes"] < m0["op.DeviceTransfer.bytes"]


def test_failed_pre_encode_is_counted_and_encoded_inline(tmp_path, monkeypatch):
    """A chunk whose prefetch copy fails is counted in
    ``op.PrefetchEncode.failed`` and encoded inline, with the same rows."""
    import threading

    import ballista_tpu_torch.ops.kernels_torch as KT

    real = KT.host_to_device

    def flaky(arr, device):
        if threading.current_thread().name == "chunk-prefetch":
            raise RuntimeError("pinned allocation failed")
        return real(arr, device)

    monkeypatch.setattr(KT, "host_to_device", flaky)
    data = _make_data(30_000, seed=43)
    plan = _filter_project(PORT, tmp_path, data, 11)
    eng = _engine(PORT, "torch", _stream_cfg() | {"ballista.engine.prefetch_depth": "2"})
    got = _collect(eng, plan)
    want = _engine(PORT, "numpy").execute_partition(plan, 0).to_arrow()
    _assert_tables(got, want, ["k", "v2"])
    assert eng.op_metrics["op.PrefetchEncode.failed"] == eng.op_metrics["op.StreamChunk.count"] == 2
    assert "op.PrefetchEncode.count" not in eng.op_metrics


def test_device_stream_spills_aggregate_state(tmp_path):
    """A streamed final aggregate whose fold state outgrows
    ``ballista.agg.spill_state_rows`` spills it to salted buckets and merges
    bucket by bucket: rows equal the JAX engine's unspilled stream."""
    rng = np.random.default_rng(47)
    n = 40_000
    data = {"k": rng.integers(0, 20_000, n).astype(np.int64), "v": rng.normal(size=n)}
    fns = [("sum", "v", "sv"), ("count_star", None, "c")]
    settings = _stream_cfg(chunk_rows=2_048, device_rows=4_096)
    got_plan = _final_over_partial(PORT, tmp_path / "port", data, fns, 12)
    eng = _engine(PORT, "torch", settings | {"ballista.agg.spill_state_rows": "3000"})
    got = _collect(eng, got_plan)
    want = _collect(_engine(JAX, "jax", settings),
                    _final_over_partial(JAX, tmp_path / "jax", data, fns, 12))
    _assert_tables(got, want, ["k"], floats=("sv",))
    assert eng.op_metrics["op.AggSpill.rows"] > 0
    assert eng.op_metrics.get("op.HostFallback.count", 0.0) == 0.0


# ---- TPC-H stage by stage through shuffle files -----------------------------------
def physical_plan(pkg, ctx, sql: str):
    """The physical plan the standalone context of ``pkg`` would run."""
    optimizer = importlib.import_module(f"{pkg.name}.plan.optimizer")
    planner = importlib.import_module(f"{pkg.name}.plan.physical_planner")
    logical = optimizer.optimize(ctx.sql(sql).logical_plan(), ctx.catalog)
    return planner.PhysicalPlanner(ctx.catalog, ctx.config).plan(logical)


def run_staged(pkg, new_engine, physical, work_dir: str, job: str = "staged"):
    """The executor's loop in one process: the plan split into stages by
    ``pkg``'s planner; every task of a stage streams
    ``execute_partition_stream(stage.input, pid)`` of a fresh engine into
    ``write_shuffle_stream``; the next stage's readers are resolved to the
    pieces written. Returns (result table, per-stage summaries)."""
    stages = pkg.planner.plan_query_stages(job, physical)
    locations: dict = {}
    summary = []
    for stage in stages:
        plan = pkg.planner.remove_unresolved_shuffles(stage, locations)
        outs = [[] for _ in range(plan.output_partitions())]
        metrics: dict = {}
        for pid in range(plan.input_partitions()):
            eng = new_engine()
            stats, _rows = pkg.stream.write_shuffle_stream(
                plan, pid, eng.execute_partition_stream(plan.input, pid), work_dir)
            for s in stats:
                outs[s.output_partition].append(
                    {"path": s.path, "host": "localhost", "flight_port": 0,
                     "executor_id": "local", "stage_id": plan.stage_id, "map_partition": pid,
                     "num_rows": s.num_rows, "num_bytes": s.num_bytes})
            for k, v in eng.op_metrics.items():
                metrics[k] = metrics.get(k, 0.0) + v
        locations[plan.stage_id] = outs
        summary.append((plan, metrics))
    last = stages[-1]
    parts = [pkg.reader.read_shuffle_partition(locs, last.schema()).to_arrow()
             for locs in locations[last.stage_id]]
    return pa.concat_tables(parts), summary


def _ctx(pkg, backend, data_dir, **kw):
    ctxmod = importlib.import_module(f"{pkg.name}.client.context")
    tables = importlib.import_module(f"{pkg.name}.models.tpch").TPCH_TABLES
    c = ctxmod.BallistaContext.standalone(backend=backend, **kw)
    for t in tables:
        c.register_parquet(t, os.path.join(data_dir, t))
    return c


# a streamed final aggregate over lineitem: no ORDER BY above it, so its
# stage streams the shuffle read and folds each chunk's states in merge mode
S1_SQL = ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue, "
          "count(*) AS n FROM lineitem GROUP BY l_orderkey")
# the streamed stages of each query: a final aggregate (s1), probe joins
# against collected builds (q3, q5); q1's and q12's final aggregates sit
# under a sort, which reads its input whole, on either engine
STREAMS = {"q1": False, "q3": True, "q5": True, "q12": False, "s1": True}


def query_sql(qname: str) -> str:
    if qname == "s1":
        return S1_SQL
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q12", "s1"])
def test_staged_tpch_matches_the_jax_engine(qname, torch_tpch_dir, tmp_path, kernel_calls):
    """TPC-H stage by stage through shuffle files on the port's torch engine
    equals the JAX engine driving the same loop with its own planner: ints,
    strings, dates and decimals exact, averages within 1e-9; no host
    fallback; every aggregate stage and merge fold sums in grouped_sums
    calls of at most 32 groups or none."""
    sql = query_sql(qname)
    jctx = _ctx(JAX, "jax", torch_tpch_dir)
    want, jstages = run_staged(
        JAX, lambda: _engine(JAX, "jax", jctx.config.settings()),
        physical_plan(JAX, jctx, sql), str(tmp_path / "jax"))
    tctx = _ctx(PORT, "torch", torch_tpch_dir, device="cpu")
    kernel_calls.clear()
    got, stages = run_staged(
        PORT, lambda: _engine(PORT, "torch", tctx.config.settings()),
        physical_plan(PORT, tctx, sql), str(tmp_path / "port"))
    assert len(stages) == len(jstages) >= 2
    assert got.column_names == want.column_names
    floats = [f.name for f in got.schema if pa.types.is_floating(f.type)]
    if any(s[0].input.output_partitions() == 1 for s in stages[-1:]):
        # a sorted result: the order is part of the answer
        for c in got.column_names:
            if c not in floats:
                assert got.column(c).to_pylist() == want.column(c).to_pylist(), c
    _assert_tables(got, want, [c for c in got.column_names if c not in floats], floats=floats)
    fallbacks = sum(m.get("op.HostFallback.count", 0.0) for _, m in stages)
    assert fallbacks == 0.0
    assert all(k <= 32 for k, _ in kernel_calls)
    chunks = sum(m.get("op.StreamChunk.count", 0.0) for _, m in stages)
    assert (chunks > 0) == STREAMS[qname], chunks
