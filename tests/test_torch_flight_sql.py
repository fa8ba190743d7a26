"""The PyTorch port's Flight SQL service and avro source, held against the
JAX package's.

- The JAX package's cases run again on the port (``test_torch_scheduler``'s
  ``mirror``: every ``ballista_tpu`` import rewritten to
  ``ballista_tpu_torch``, each case collected here under its own name):
  every case of ``tests/test_flight_sql_endpoints.py`` and
  ``tests/test_avro.py``; the Flight SQL cases of ``tests/test_observability.py``
  (with its KEDA case, which shares their cluster), ``tests/test_serving.py``
  (its ``flight_cluster`` renamed ``serving_flight_cluster``),
  ``tests/test_chaos.py`` (the ``query_timeout_s`` case) and
  ``tests/test_exchange_cache.py`` (prepared statements over cached
  exchanges). Their clusters are the port's: a scheduler and torch executors
  on ``device="cpu"`` over the port's own SF 0.01 data; ``register_avro``'s
  context is the torch engine on the CPU.
- Parity on the same inputs: q1, q3, q5 and q12 through the port's service
  over torch executors and through the JAX service over numpy executors
  (the same rows once sorted: ints, strings and dates exactly, floats within
  rtol 1e-6, as ``tests/test_torch_distributed.py`` holds them, since the
  JAX host engine sums decimals in f64 and the torch engine in scaled
  int64), and exactly the port's remote client's rows on the same cluster;
  the FlightInfo schemas equal; every metadata command's table equal.
- avro: ``write_avro`` of one table gives the same bytes in both packages
  under both codecs (the file's random sync marker fixed); each package
  reads the other's file to an equal table; ``read_avro`` of the port's
  PyBallista shim returns the rows where the JAX shim raises
  ``AssertionError("unreachable")`` (a fault of the reference the port does
  not copy).
"""
import datetime
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.flight as flight
import pytest

from ballista_tpu.client import standalone as JS
from ballista_tpu.scheduler import flight_sql as JF
from ballista_tpu.utils import avro as JA
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.client.standalone import start_standalone_cluster
from ballista_tpu_torch.models.tpch import TPCH_TABLES
from ballista_tpu_torch.proto import flight_sql_pb2 as fsql
from ballista_tpu_torch.scheduler import flight_sql as PF
from ballista_tpu_torch.utils import avro as PA

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_scheduler import mirror
from test_tpch_numpy import assert_frames_match

QUERIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks",
                       "queries")
TORCH_CPU = r'backend="torch", device="cpu",'


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


@pytest.fixture(scope="session")
def tpch_dir(torch_tpch_dir):
    """The JAX cases' shared TPC-H fixture is the port's own data here."""
    return torch_tpch_dir


def _service(module, cluster, data_dir: str, tables, **kw):
    svc = module.SchedulerFlightService(cluster.scheduler, "127.0.0.1", 0, **kw)
    svc.serve_background()
    client = flight.connect(f"grpc://127.0.0.1:{svc.port}")
    for t in tables:
        list(client.do_action(flight.Action("register_parquet", json.dumps(
            {"name": t, "path": os.path.join(data_dir, t)}).encode())))
    return svc, client


@pytest.fixture(scope="module")
def cluster2(torch_tpch_dir, tmp_path_factory):
    """``tests/test_flight_sql_endpoints.py``'s cluster on the port: the
    scheduler, two torch executors on the CPU and the Flight SQL service,
    every TPC-H table registered."""
    c = start_standalone_cluster(n_executors=2, task_slots=2, backend="torch", device="cpu",
                                 work_dir=str(tmp_path_factory.mktemp("port-fsql")))
    svc, client = _service(PF, c, torch_tpch_dir, TPCH_TABLES)
    yield c, svc, client
    client.close()
    svc.shutdown()
    c.stop()


@pytest.fixture(scope="module")
def flight_cluster(tmp_path_factory):
    """``tests/test_observability.py``'s cluster on the port."""
    c = start_standalone_cluster(n_executors=1, backend="torch", device="cpu",
                                 work_dir=str(tmp_path_factory.mktemp("port-fshuf")))
    svc = PF.SchedulerFlightService(c.scheduler, "127.0.0.1", 0)
    svc.serve_background()
    yield c, svc
    svc.shutdown()
    c.stop()


@pytest.fixture(scope="module")
def serving_flight_cluster(torch_tpch_dir, tmp_path_factory):
    """``tests/test_serving.py``'s ``flight_cluster`` on the port."""
    c = start_standalone_cluster(n_executors=1, backend="torch", device="cpu",
                                 work_dir=str(tmp_path_factory.mktemp("port-serving-fsql")))
    svc, client = _service(PF, c, torch_tpch_dir, ("nation", "region"))
    yield c, svc, client
    client.close()
    svc.shutdown()
    c.stop()


# ---- the JAX package's cases, on the port ------------------------------------------
_LEFT_OUT: dict = {}
_MIRRORED = (
    mirror(globals(), "test_flight_sql_endpoints.py", _LEFT_OUT,
           # its proxy case reads nation from the JAX tests' data directory
           rewrites={r'"tpch_sf001"': '"torch_tpch_sf001"'})
    + mirror(globals(), "test_avro.py", _LEFT_OUT,
             rewrites={r'BallistaContext\.standalone\(backend="numpy"\)':
                       'BallistaContext.standalone(device="cpu")'})
    + mirror(globals(), "test_observability.py", _LEFT_OUT,
             only=("test_flight_sql_roundtrip", "test_flight_sql_command_protocol",
                   "test_keda_scaler"))
    + mirror(globals(), "test_serving.py", _LEFT_OUT,
             rewrites={r"\bflight_cluster\b": "serving_flight_cluster"},
             only=("test_prepared_statement_rides_plan_cache_and_pins",
                   "test_prepared_eviction_releases_pins_crashed_client_pool",
                   "test_flight_result_cache_serves_repeat_without_new_job"))
    + mirror(globals(), "test_chaos.py", _LEFT_OUT,
             only=("test_query_timeout_surfaces_clean_cancelled",))
    + mirror(globals(), "test_exchange_cache.py", _LEFT_OUT,
             rewrites={r'backend="numpy",': TORCH_CPU},
             only=("test_e2e_prepared_statements_ride_cached_exchanges",))
)


def test_every_listed_jax_case_is_mirrored():
    assert len(_MIRRORED) == len(set(_MIRRORED)) == 5 + 2 + 3 + 3 + 1 + 1
    assert all(callable(globals()[c]) for c in _MIRRORED)


# ---- parity with the JAX package's service -----------------------------------------
@pytest.fixture(scope="module")
def jax_service(torch_tpch_dir, tmp_path_factory):
    """The JAX package's scheduler, two numpy executors and Flight SQL
    service over the same tables."""
    c = JS.start_standalone_cluster(n_executors=2, task_slots=2, backend="numpy",
                                    work_dir=str(tmp_path_factory.mktemp("jax-fsql")))
    svc, client = _service(JF, c, torch_tpch_dir, TPCH_TABLES)
    yield c, svc, client
    client.close()
    svc.shutdown()
    c.stop()


def _statement(client, sql: str):
    info = client.get_flight_info(flight.FlightDescriptor.for_command(
        PF.pack_any(fsql.CommandStatementQuery(query=sql))))
    parts = []
    for ep in info.endpoints:
        if ep.locations:
            direct = flight.connect(ep.locations[0].uri.decode())
            try:
                parts.append(direct.do_get(ep.ticket).read_all())
            finally:
                direct.close()
        else:
            parts.append(client.do_get(ep.ticket).read_all())
    return info, pa.concat_tables(parts)


@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q12"])
def test_statement_rows_and_schema_equal_the_jax_service(cluster2, jax_service,
                                                         torch_tpch_dir, qname):
    c, _, client = cluster2
    sql = _sql(qname)
    info, got = _statement(client, sql)
    jinfo, want = _statement(jax_service[2], sql)
    assert info.schema == jinfo.schema == got.schema
    assert_frames_match(got.to_pandas(), want.to_pandas(), False, qname)
    # the same cluster through the port's remote client: the same rows exactly
    rctx = BallistaContext.remote("127.0.0.1", c.scheduler_port)
    for t in TPCH_TABLES:
        rctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
    direct = rctx.sql(sql).collect()
    keys = [(n, "ascending") for n in got.schema.names]
    assert got.sort_by(keys).equals(direct.sort_by(keys))


_METADATA = (
    fsql.CommandGetCatalogs(),
    fsql.CommandGetDbSchemas(),
    fsql.CommandGetDbSchemas(catalog="not_ours"),
    fsql.CommandGetTables(),
    fsql.CommandGetTables(include_schema=True),
    fsql.CommandGetTables(table_name_filter_pattern="%item"),
    fsql.CommandGetTableTypes(),
    fsql.CommandGetSqlInfo(),
    fsql.CommandGetSqlInfo(info=[0, 3]),
    fsql.CommandGetPrimaryKeys(table="nation"),
    fsql.CommandGetExportedKeys(table="nation"),
    fsql.CommandGetImportedKeys(table="nation"),
    fsql.CommandGetXdbcTypeInfo(),
)


@pytest.mark.parametrize("cmd", _METADATA,
                         ids=[f"{type(c).__name__}-{i}" for i, c in enumerate(_METADATA)])
def test_metadata_command_equals_the_jax_service(cluster2, jax_service, cmd):
    def run(client, pack):
        info = client.get_flight_info(flight.FlightDescriptor.for_command(pack(cmd)))
        return info.schema, client.do_get(info.endpoints[0].ticket).read_all()

    schema, got = run(cluster2[2], PF.pack_any)
    jschema, want = run(jax_service[2], JF.pack_any)
    assert schema == jschema
    assert got.equals(want), (got.to_pydict(), want.to_pydict())


# ---- avro ---------------------------------------------------------------------------
def _avro_table(n: int = 300) -> pa.Table:
    rng = np.random.default_rng(11)
    return pa.table({
        "i": pa.array(rng.integers(-(1 << 40), 1 << 40, n), type=pa.int64()),
        "f": pa.array(rng.normal(size=n), type=pa.float64()),
        "b": pa.array(rng.integers(0, 2, n).astype(bool)),
        "s": pa.array([f"v{i}" if i % 5 else None for i in range(n)], type=pa.string()),
        "d": pa.array([datetime.date(1995, 1, 1) + datetime.timedelta(days=int(i) % 900)
                       for i in range(n)]),
    })


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_write_avro_gives_the_jax_packages_bytes_and_reads_its_files(tmp_path, monkeypatch,
                                                                     codec):
    # the container's sync marker is random: fix it so the bytes compare
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(n)))
    t = _avro_table()
    jpath, ppath = str(tmp_path / "jax.avro"), str(tmp_path / "port.avro")
    JA.write_avro(jpath, t, codec=codec)
    PA.write_avro(ppath, t, codec=codec)
    with open(jpath, "rb") as f, open(ppath, "rb") as g:
        assert f.read() == g.read()
    # each package reads the other's file, to the same table
    for reader, path in ((PA.read_avro, jpath), (JA.read_avro, ppath)):
        got = reader(path)
        assert got.to_pydict() == t.to_pydict()
        assert got.equals(JA.read_avro(jpath))


def test_read_avro_returns_rows_where_the_jax_shim_raises(tmp_path):
    from ballista_tpu.pyballista import SessionContext as JaxSession
    from ballista_tpu_torch.pyballista import SessionContext

    t = pa.table({"k": pa.array([3, 1, 2, 1], type=pa.int64()),
                  "v": pa.array([0.5, 1.5, 2.5, 3.5])})
    path = str(tmp_path / "t.avro")
    PA.write_avro(path, t)
    # the reference registers the table, then always raises
    with pytest.raises(AssertionError, match="unreachable"):
        JaxSession(backend="numpy").read_avro(path)
    df = SessionContext(backend="torch", device="cpu").read_avro(path)
    assert df.collect().to_pydict() == t.to_pydict()


def test_register_avro_runs_q1_on_the_torch_engine_equal_to_parquet(torch_tpch_dir, tmp_path):
    """q1 and q6 over the first 8192 lineitem rows, read from avro on the
    torch engine: the rows the same queries give over the same rows
    registered from Arrow, and no host fallback."""
    import pyarrow.parquet as pq

    cols = ["l_quantity", "l_extendedprice", "l_discount", "l_tax", "l_returnflag",
            "l_linestatus", "l_shipdate"]
    rows = pq.read_table(os.path.join(torch_tpch_dir, "lineitem"), columns=cols).slice(0, 8192)
    path = str(tmp_path / "lineitem.avro")
    PA.write_avro(path, rows)
    a, b = BallistaContext.standalone(device="cpu"), BallistaContext.standalone(device="cpu")
    a.register_avro("lineitem", path)
    b.register_arrow("lineitem", rows)
    for q in ("q1", "q6"):
        got = a.sql(_sql(q)).collect()
        assert a.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
        assert got.num_rows > 0 and got.equals(b.sql(_sql(q)).collect()), q
