"""The port's shuffle data plane and plan serde, held against the JAX package.

Mirrors ``tests/test_serde_shuffle.py`` (all but ``test_proto_messages``: the
scheduler's proto is not ported yet) and ``tests/test_object_store_shuffle.py``
(all but the killed-producer executor case and the remote client's result
fetch, which need the executor and client processes not ported yet). Each
case runs the port's modules on the same seeded inputs as the JAX package's
and compares: serde encodings byte for byte, piece row counts exactly, rows
as multisets.

Cross-reading: pieces the JAX package writes are read by the port's
readers, one-shot and streamed, and the reverse; the port's bucketing is
bit-identical to ``ballista_tpu/ops/kernels_np.py:113``
(``hash_partition_indices``) over ints, floats, strings, dates, NULLs and
composite keys. Row order inside a piece may differ between the writers (the
JAX package may split with its native kernel); readers never depend on it.
"""
import glob
import os

import numpy as np
import pyarrow as pa
import pytest

import ballista_tpu.shuffle.flight as jflight
import ballista_tpu.shuffle.stream as jstream
import ballista_tpu_torch.shuffle.flight as tflight
import ballista_tpu_torch.shuffle.stream as tstream
from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_stream import JAX, PORT, _assert_tables, _batch, _loc, _write_piece

QUERIES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries")


@pytest.fixture(autouse=True)
def fast_retries(monkeypatch):
    for mod in (jstream, jflight, tstream, tflight):
        monkeypatch.setattr(mod, "RETRY_BACKOFF_S", 0.01)


def _logical(pkg, sql: str, catalog=None):
    from importlib import import_module

    optimize = import_module(f"{pkg.name}.plan.optimizer").optimize
    SqlPlanner = import_module(f"{pkg.name}.sql.planner").SqlPlanner
    parse_sql = import_module(f"{pkg.name}.sql.parser").parse_sql
    schemas = (catalog.schemas() if catalog is not None
               else import_module(f"{pkg.name}.models.tpch").TPCH_SCHEMAS)
    return optimize(SqlPlanner(schemas).plan(parse_sql(sql)))


def _serde(pkg):
    from importlib import import_module

    return import_module(f"{pkg.name}.plan.serde")


def _catalog(pkg, data_dir, tables=None):
    from importlib import import_module

    cat = import_module(f"{pkg.name}.client.catalog").Catalog()
    for t in tables or import_module(f"{pkg.name}.models.tpch").TPCH_TABLES:
        cat.register_parquet(t, os.path.join(data_dir, t))
    return cat


def _physical(pkg, cat, logical):
    from importlib import import_module

    planner = import_module(f"{pkg.name}.plan.physical_planner")
    return planner.PhysicalPlanner(cat, pkg.cfg.BallistaConfig()).plan(logical)


# ---- mirrors of tests/test_serde_shuffle.py -----------------------------------------
@pytest.mark.parametrize("qfile", sorted(glob.glob(os.path.join(QUERIES, "q*.sql"))))
def test_logical_serde_roundtrip(qfile):
    sql = open(qfile).read()
    plan = _logical(PORT, sql)
    wire = _serde(PORT).encode_logical(plan)
    rt = _serde(PORT).decode_logical(wire)
    assert repr(rt) == repr(plan)
    assert rt.schema() == plan.schema()
    # the JAX package writes the same bytes for the same query
    assert wire == _serde(JAX).encode_logical(_logical(JAX, sql))


@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q13", "q17", "q21"])
def test_physical_serde_roundtrip(qname, torch_tpch_dir):
    sql = open(os.path.join(QUERIES, f"{qname}.sql")).read()
    reprs = []
    for pkg in (JAX, PORT):
        cat = _catalog(pkg, torch_tpch_dir)
        phys = _physical(pkg, cat, _logical(pkg, sql, cat))
        rt = _serde(pkg).decode_physical(_serde(pkg).encode_physical(phys))
        assert repr(rt) == repr(phys)
        assert rt.schema() == phys.schema()
        reprs.append(repr(rt))
    assert reprs[0] == reprs[1]


def test_shuffle_write_read_local(tmp_path):
    data = {"k": np.arange(100, dtype=np.int64), "s": np.array([f"v{i}" for i in range(100)])}
    counts = {}
    for pkg in (JAX, PORT):
        batch = _batch(pkg, data)
        stats = _write_piece(pkg, tmp_path / pkg.name, batch, job="job1", stage=2, nparts=4)
        assert len(stats) == 4
        assert sum(s.num_rows for s in stats) == 100
        assert all(os.path.exists(s.path) for s in stats)
        got = [pkg.reader.read_shuffle_partition([_loc(s.path, 2)], batch.schema).num_rows
               for s in stats]
        assert got == [s.num_rows for s in stats]
        counts[pkg.name] = got
    assert counts["ballista_tpu"] == counts["ballista_tpu_torch"]


def test_flight_fetch_and_fetch_failed(tmp_path):
    from ballista_tpu_torch.errors import FetchFailed

    data = {"k": np.arange(50, dtype=np.int64)}
    stats = _write_piece(PORT, tmp_path, _batch(PORT, data), job="jobf", stage=1)
    server = tflight.ShuffleFlightServer("127.0.0.1", 0, str(tmp_path))
    server.serve_background()
    try:
        got = tflight.fetch_partition("127.0.0.1", server.port, stats[0].path, "e1", 1, 0)
        assert got.num_rows == stats[0].num_rows
        # the JAX package's client fetches from the port's server alike
        assert jflight.fetch_partition("127.0.0.1", server.port, stats[0].path, "e1", 1, 0) \
            .equals(got)
        with pytest.raises(FetchFailed) as ei:
            tflight.fetch_partition("127.0.0.1", server.port, "/nonexistent/file", "e1", 3, 7)
        assert ei.value.map_stage_id == 3 and ei.value.map_partition_id == 7
    finally:
        server.shutdown()


def test_window_and_setop_serde_roundtrip(torch_tpch_dir):
    """Window, Union and WindowFunc nodes survive the port's wire format and
    encode as the JAX package's do."""
    sql = (
        "select n_regionkey, "
        "row_number() over (partition by n_regionkey order by n_name desc) as rn "
        "from nation union all select n_regionkey, n_nationkey from nation"
    )
    wires, reprs = [], []
    for pkg in (JAX, PORT):
        cat = _catalog(pkg, torch_tpch_dir, ["nation"])
        plan = _logical(pkg, sql, cat)
        wire = _serde(pkg).encode_logical(plan)
        assert repr(_serde(pkg).decode_logical(wire)) == repr(plan)
        phys = _physical(pkg, cat, plan)
        prt = _serde(pkg).decode_physical(_serde(pkg).encode_physical(phys))
        assert repr(prt) == repr(phys)
        assert prt.schema() == phys.schema()
        wires.append(wire)
        reprs.append(repr(prt))
    assert wires[0] == wires[1] and reprs[0] == reprs[1]


# ---- mirrors of tests/test_object_store_shuffle.py ----------------------------------
def _os_data(n: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 37, n).astype(np.int64), "v": rng.normal(size=n)}


def _write_with_store(pkg, tmp_path, batch, store_url, job="jos", stage=2, nparts=2):
    P, E = pkg.phys, pkg.expr
    plan = P.ShuffleWriterExec(job, stage, P.MemoryScanExec([batch], batch.schema),
                               P.HashPartitioning((E.Col("k"),), nparts))
    return plan, pkg.writer.write_shuffle_partitions(
        plan, 0, batch, str(tmp_path / "producer-work"), object_store_url=store_url)


def _dead_locations(stats, stage=2):
    """Locations whose local files are gone and whose Flight endpoint is a
    dead port: the producer executor was preempted."""
    return [[{"path": s.path, "host": "127.0.0.1", "flight_port": 1, "executor_id": "gone",
              "stage_id": stage, "map_partition": 0}] for s in stats]


def test_upload_layout_mirrors_local_layout(tmp_path):
    store = tmp_path / "store"
    _, stats = _write_with_store(PORT, tmp_path, _batch(PORT, _os_data(5_000)), store.as_uri())
    _, jstats = _write_with_store(JAX, tmp_path / "jax", _batch(JAX, _os_data(5_000)),
                                  (tmp_path / "jstore").as_uri())
    for s, js in zip(stats, jstats):
        rel = "/".join(s.path.split(os.sep)[-4:])
        assert rel == "/".join(js.path.split(os.sep)[-4:])
        assert (store / rel).exists(), rel
        assert (store / rel).stat().st_size == s.num_bytes
        assert s.num_rows == js.num_rows


def test_materializing_reader_falls_back_to_object_store(tmp_path):
    store = tmp_path / "store"
    batch = _batch(PORT, _os_data(20_000, seed=1))
    _, stats = _write_with_store(PORT, tmp_path, batch, store.as_uri())
    for s in stats:
        os.unlink(s.path)
    total = 0
    for part, part_locs in enumerate(_dead_locations(stats)):
        out = PORT.reader.read_shuffle_partition(part_locs, batch.schema,
                                                 object_store_url=store.as_uri())
        assert out.num_rows == stats[part].num_rows
        total += out.num_rows
    assert total == batch.num_rows


def test_streaming_reader_falls_back_to_object_store(tmp_path):
    store = tmp_path / "store"
    data = _os_data(30_000, seed=2)
    _, stats = _write_with_store(PORT, tmp_path, _batch(PORT, data), store.as_uri())
    for s in stats:
        os.unlink(s.path)
    chunks = []
    for part_locs in _dead_locations(stats):
        chunks.extend(tstream.iter_shuffle_partition(
            part_locs, chunk_rows=4_096, spill_dir=str(tmp_path / "spill"),
            object_store_url=store.as_uri()))
    _assert_tables(pa.concat_tables([c.to_arrow() for c in chunks]),
                   _batch(JAX, data).to_arrow(), ["k", "v"])
    assert not list((tmp_path / "spill").glob("fetch-*"))


def test_no_object_store_still_fetch_fails(tmp_path):
    from ballista_tpu_torch.errors import FetchFailed

    _, stats = _write_with_store(PORT, tmp_path, _batch(PORT, _os_data(1_000, seed=3)), "")
    for s in stats:
        os.unlink(s.path)
    with pytest.raises(FetchFailed):
        list(tstream.iter_shuffle_partition(_dead_locations(stats)[0],
                                            spill_dir=str(tmp_path / "spill")))


def test_stream_writer_uploads_on_finish(tmp_path):
    store = tmp_path / "store"
    batch = _batch(PORT, _os_data(12_000, seed=4))
    P, E = PORT.phys, PORT.expr
    plan = P.ShuffleWriterExec("jsw", 3, P.MemoryScanExec([batch], batch.schema),
                               P.HashPartitioning((E.Col("k"),), 3))
    chunks = [batch.slice(i, 3_000) for i in range(0, batch.num_rows, 3_000)]
    stats, rows = tstream.write_shuffle_stream(plan, 0, iter(chunks), str(tmp_path / "w"),
                                               object_store_url=store.as_uri())
    assert rows == batch.num_rows
    for s in stats:
        assert (store / "/".join(s.path.split(os.sep)[-4:])).exists()


def test_object_store_table_scan(torch_tpch_dir, tmp_path):
    """A table registered by object-store URL scans through the registry on
    both of the port's engines, equal to the local registration."""
    from ballista_tpu_torch.client.context import BallistaContext

    url = "file://" + os.path.join(torch_tpch_dir, "nation")
    sql = "select n_regionkey, count(*) as n from nation group by n_regionkey"
    local = BallistaContext.standalone(backend="numpy")
    local.register_parquet("nation", os.path.join(torch_tpch_dir, "nation"))
    want = local.sql(sql).collect().sort_by("n_regionkey")
    for backend, kw in (("numpy", {}), ("torch", {"device": "cpu"})):
        ctx = BallistaContext.standalone(backend=backend, **kw)
        ctx.register_parquet("nation", url)
        assert ctx.sql(sql).collect().sort_by("n_regionkey").equals(want), backend


# ---- cross-reading: one data plane for both packages --------------------------------
def _keyed_data(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "i": rng.integers(-10**12, 10**12, n).astype(np.int64),
        "f": rng.normal(size=n) * 1e3,
        "s": np.array([f"key-{x}" for x in rng.integers(0, 500, n)]),
        "d": pa.array(rng.integers(8000, 10000, n).astype(np.int32), pa.date32()),
        "n": pa.array([None if x % 7 == 0 else int(x) for x in rng.integers(0, 90, n)],
                      pa.int64()),
    }


def _table_batch(pkg, data):
    return pkg.batch.ColumnBatch.from_arrow(pa.table(dict(data)))


KEYS = [("i",), ("f",), ("s",), ("d",), ("n",), ("s", "i"), ("d", "n", "f")]


@pytest.mark.parametrize("keys", KEYS, ids=["+".join(k) for k in KEYS])
@pytest.mark.parametrize("n_parts", [1, 7, 16])
def test_bucketing_is_bit_identical(keys, n_parts):
    data = _keyed_data(5_000, seed=len(keys) * 31 + n_parts)
    want = JAX.knp.hash_partition_indices(
        _table_batch(JAX, data), [JAX.expr.Col(k) for k in keys], n_parts)
    got = PORT.knp.hash_partition_indices(
        _table_batch(PORT, data), [PORT.expr.Col(k) for k in keys], n_parts)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _pieces(pkg, tmp_path, data, keys, n_parts, streamed):
    P, E = pkg.phys, pkg.expr
    batch = _table_batch(pkg, data)
    plan = P.ShuffleWriterExec("jx", 4, P.MemoryScanExec([batch], batch.schema),
                               P.HashPartitioning(tuple(E.Col(k) for k in keys), n_parts))
    if streamed:
        chunks = [batch.slice(i, 1_500) for i in range(0, batch.num_rows, 1_500)]
        stats, _ = pkg.stream.write_shuffle_stream(plan, 0, iter(chunks), str(tmp_path))
    else:
        stats = pkg.writer.write_shuffle_partitions(plan, 0, batch, str(tmp_path))
    return batch.schema, stats


@pytest.mark.parametrize("streamed", [False, True], ids=["one-shot", "streamed"])
@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
def test_pieces_cross_read(tmp_path, writer, reader, streamed):
    """Pieces one package writes, the other reads, one-shot and chunked:
    each output partition holds the same rows as the reader's own writer
    puts there."""
    data = _keyed_data(6_000, seed=77)
    keys = ("s", "i")
    _, wstats = _pieces(writer, tmp_path / "w", data, keys, 5, streamed)
    schema, own = _pieces(reader, tmp_path / "own", data, keys, 5, streamed)
    sort = ["i", "s", "f"]
    for ws, os_ in zip(wstats, own):
        assert ws.output_partition == os_.output_partition and ws.num_rows == os_.num_rows
        one = reader.reader.read_shuffle_partition([_loc(ws.path, 4)], schema).to_arrow()
        chunks = list(reader.stream.iter_shuffle_partition([_loc(ws.path, 4)], chunk_rows=500))
        mine = reader.reader.read_shuffle_partition([_loc(os_.path, 4)], schema).to_arrow()
        _assert_tables(one, mine, sort)
        if chunks:
            _assert_tables(pa.concat_tables([c.to_arrow() for c in chunks]), mine, sort)


def test_engines_read_the_other_packages_pieces(tmp_path):
    """A final aggregate over pieces the JAX package wrote runs on the
    port's torch engine (streamed) with the JAX engine's rows, and the
    reverse."""
    from test_torch_stream import FOLD_AGGS, _collect, _engine, _final_over_partial

    rng = np.random.default_rng(5)
    data = {"k": rng.integers(0, 97, 50_000).astype(np.int64), "v": rng.normal(size=50_000)}
    jplan = _final_over_partial(JAX, tmp_path / "jax", data, FOLD_AGGS, 5)
    tplan = _final_over_partial(PORT, tmp_path / "port", data, FOLD_AGGS, 5)
    # swap the readers' locations: each engine reads the other's pieces
    jlocs = jplan.input.partition_locations
    jplan.input.partition_locations = tplan.input.partition_locations
    tplan.input.partition_locations = jlocs
    got = _collect(_engine(PORT, "torch", {}), tplan)
    want = _collect(_engine(JAX, "jax", {}), jplan)
    _assert_tables(got, want, ["k"], floats=("sv", "av", "mn"))
