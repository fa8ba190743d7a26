"""The PyTorch port's inspection surfaces, held against the JAX package's.

- The JAX package's cases run again on the port, every ``ballista_tpu``
  import rewritten to ``ballista_tpu_torch`` (``test_torch_scheduler``'s
  ``_port_copy``): every case of ``tests/test_elastic.py`` and
  ``tests/test_tracing.py`` and ``tests/test_dataframe_api.py`` (the
  DataFrame builders of ``client/functions.py``), three of
  ``tests/test_misc_surfaces.py`` and
  ``tests/test_observability.py::test_dot_export``. ``_LEFT_OUT`` names the
  cases that need what the port does not have yet, each with its reason.
  Their shared TPC-H fixture is the port's own data, their traced cluster
  runs a torch executor on ``device="cpu"``, and the DataFrame cases' context
  the torch engine on the CPU.
- Parity on the same inputs: the EXPLAIN VERIFY rows of q1-q22 (one device,
  the same ``hbm_budget_bytes``); the engine's span names and counts for q1,
  q3, q5 and q12, fused, unfused and under tiny-stage dispatch, against the
  JAX engine over one device (``DeviceCompile`` aside: eager torch compiles
  nothing; the port records a ``DeviceExecute`` span for each fused program,
  which the JAX engine counts but does not record); the text of
  ``render_explain_analyze``, ``to_trace_events`` and ``graph_to_dot``; the
  JSON keys of every GET route of a JAX and a port scheduler's REST API.
- Standalone EXPLAIN ANALYZE on the torch engine: its ``DeviceExecute``
  spans equal ``op.DeviceExecute.count`` and sum to
  ``op.DeviceExecute.time_s``; a paged join records ``PagedJoin`` spans
  whose passes sum to ``op.PagedJoin.passes``; the serving caches.
- A JAX-package executor's spans under the port's scheduler land in its
  TraceStore and in ``/api/trace``.
"""
import collections
import inspect
import json
import os
import urllib.request

import pytest

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.engine import fused_exchange as JFX
from ballista_tpu.engine import jax_engine as JE
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.models.tpch import TPCH_TABLES

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_scheduler import _cases, _port_copy

QUERIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks",
                       "queries")


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


def _register(ctx, data_dir: str):
    for t in TPCH_TABLES:
        ctx.register_parquet(t, os.path.join(data_dir, t))
    return ctx


# ---- the JAX package's cases, on the port ------------------------------------------
_LEFT_OUT = {
    ("test_elastic.py", "test_q13_shaped_64dup_build_stays_on_device"):
        "runs the JAX engine (backend='jax'), which the port does not have; "
        "the torch engine's join over 64 duplicates a build key stays on the "
        "device in tests/test_torch_joins.py (the long_runs cases)",
    ("test_dataframe_api.py", "test_dataframe_on_jax_backend"):
        "runs the JAX engine (backend='jax'); the port's builder cases run on "
        "the torch engine here (the ctx fixture below)",
}
_MIRRORED = [c for c in (
    _cases("test_elastic.py") + _cases("test_tracing.py") + _cases("test_dataframe_api.py")
    + [("test_misc_surfaces.py", n) for n in (
        "test_web_ui_route", "test_stage_drilldown_api_and_ui", "test_pyballista_shim")]
    + [("test_observability.py", "test_dot_export")]
) if c not in _LEFT_OUT]
_COPIES: dict = {}


@pytest.fixture(scope="module")
def ctx():
    """``tests/test_dataframe_api.py``'s context on the port: its tables on
    the torch engine on the CPU (the JAX test's runs the host engine)."""
    import numpy as np
    import pyarrow as pa

    rng = np.random.default_rng(7)
    n = 2000
    t = pa.table({"k": rng.integers(0, 20, n), "v": np.round(rng.normal(10, 3, n), 6),
                  "s": rng.choice(["x", "y", "z"], n)})
    c = BallistaContext.standalone(device="cpu")
    c.register_arrow("t", t, partitions=2)
    c.register_arrow("o", pa.table({"k2": np.arange(20), "w": np.arange(20) * 1.5}))
    return c


@pytest.fixture(scope="module")
def pdf(ctx):
    return ctx.table("t").collect().to_pandas(), ctx.table("o").collect().to_pandas()


@pytest.fixture(scope="module")
def traced_cluster(torch_tpch_dir):
    """``tests/test_tracing.py``'s cluster on the port: a scheduler and a
    torch executor on the CPU, and a remote context over it."""
    from ballista_tpu_torch.client.standalone import start_standalone_cluster

    cluster = start_standalone_cluster(n_executors=1, task_slots=2, backend="torch",
                                       device="cpu")
    ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
    ctx.register_parquet("lineitem", f"{torch_tpch_dir}/lineitem")
    yield cluster, ctx
    cluster.stop()


@pytest.mark.parametrize("filename,case", _MIRRORED,
                         ids=[f"{f[5:-3]}-{c}" for f, c in _MIRRORED])
def test_jax_surface_case_on_the_port(request, torch_tpch_dir, filename, case):
    if filename not in _COPIES:
        _COPIES[filename] = _port_copy(filename)
    fn = getattr(_COPIES[filename], case)
    fixtures = {"tpch_dir": torch_tpch_dir}
    args = [fixtures[p] if p in fixtures else request.getfixturevalue(p)
            for p in inspect.signature(fn).parameters]
    fn(*args)


# ---- EXPLAIN VERIFY ----------------------------------------------------------------
# small enough that the governor repartitions or pages some of SF 0.01's joins
_VERIFY_BUDGET = str(1 << 20)


@pytest.fixture(scope="module")
def verify_ctxs(torch_tpch_dir):
    """(port, JAX) contexts planning for one device under the same budget:
    the torch engine on the CPU and the JAX package's host engine (whose
    context plans for one device and detects no budget)."""
    out = []
    for ctx in (BallistaContext.standalone(device="cpu"), JaxContext.standalone(backend="numpy")):
        ctx.config.set("ballista.engine.hbm_budget_bytes", _VERIFY_BUDGET)
        out.append(_register(ctx, torch_tpch_dir))
    return out


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 23)])
def test_explain_verify_rows_equal_the_jax_packages(verify_ctxs, qname):
    rows = [c.sql("EXPLAIN VERIFY " + _sql(qname)).collect().to_pydict() for c in verify_ctxs]
    assert rows[0] == rows[1]
    assert set(rows[0]) == {"severity", "rule", "operator", "message"}
    assert "error" not in rows[0]["severity"], rows[0]


# ---- engine spans ------------------------------------------------------------------
_MODES = {
    "fused": {},
    "unfused": {"ballista.tpu.ici_shuffle": "false"},
    "tiny": {"ballista.tpu.min_device_rows": "1000000"},
}


@pytest.fixture(scope="module")
def span_ctxs(torch_tpch_dir):
    """(port, JAX) context pairs per mode; the JAX engine over one device."""
    out = {}
    for mode, settings in _MODES.items():
        t = BallistaContext.standalone(device="cpu")
        j = JaxContext.standalone(backend="jax")
        for c in (t, j):
            for k, v in settings.items():
                c.config.set(k, v)
            _register(c, torch_tpch_dir)
        make = j._get_engine

        def one_device(make=make):
            engine = make()
            engine.mesh_devices = 1
            return engine

        j._get_engine = one_device
        out[mode] = (t, j)
    return out


def _engine_spans(spans) -> collections.Counter:
    return collections.Counter(s["name"] for s in spans if s["service"] == "engine")


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q12"])
def test_engine_spans_equal_the_jax_engines(span_ctxs, monkeypatch, qname, mode):
    port, jax_ctx = span_ctxs[mode]
    fused_calls = []
    timed = JFX._timed_call
    monkeypatch.setattr(JFX, "_timed_call",
                        lambda *a, **k: fused_calls.append(1) or timed(*a, **k))
    TE.clear_caches()
    JE._ENC_CACHE.clear()
    JE._DEV_CACHE.clear()
    port.sql(_sql(qname)).collect()
    jax_ctx.sql(_sql(qname)).collect()
    got = _engine_spans(port.last_trace_spans)
    want = _engine_spans(jax_ctx.last_trace_spans)
    del want["DeviceCompile"]
    want["DeviceExecute"] += len(fused_calls)
    assert got == want
    assert got["CompiledStage"] > 0
    m = port.last_engine_metrics
    assert got["DeviceExecute"] == m.get("op.DeviceExecute.count", 0.0)


def test_standalone_spans_hold_the_device_accounting(torch_tpch_dir):
    ctx = _register(BallistaContext.standalone(device="cpu"), torch_tpch_dir)
    for warm in (False, True):
        if not warm:
            TE.clear_caches()
        out = ctx.sql("EXPLAIN ANALYZE " + _sql("q5")).collect().to_pydict()
        assert out["plan_type"] == ["plan_with_metrics"]
        text = out["plan"][0]
        m = ctx.last_engine_metrics
        spans = ctx.last_trace_spans
        dev = [s for s in spans if s["name"] == "DeviceExecute"]
        assert len(dev) == m["op.DeviceExecute.count"]
        assert abs(sum(s["dur_us"] for s in dev) / 1e6 - m["op.DeviceExecute.time_s"]) \
            <= 1e-3 * len(dev)
        assert {s["attrs"]["program"] for s in dev} == {"eager", "fused"}
        stages = [s for s in spans if s["name"] == "CompiledStage"]
        assert stages and all(s["attrs"]["compile_ms"] == 0.0 for s in stages)
        assert any(s["attrs"].get("hbm_est_bytes") for s in stages)
        assert "device: compile_ms=0.000 execute_ms=" in text and "hbm: est_bytes=" in text
        assert m.get("op.HostFallback.count", 0.0) == 0.0
        # one trace: the client's query span is the root of every span
        root = [s for s in spans if s["parent_id"] is None]
        assert len(root) == 1 and root[0]["name"] == "query"
        assert {s["trace_id"] for s in spans} == {ctx.last_trace_id}


_PAGED_BUDGET = 400_000


def test_paged_join_records_its_passes(torch_tpch_dir):
    """q3 unfused with every join partitioned, under a budget its joins
    exceed: each paged join is a span, and their passes sum to the
    metric. The rows equal an unpaged run's."""
    settings = {"ballista.optimizer.broadcast_rows_threshold": "0",
                "ballista.tpu.ici_shuffle": "false"}
    plain = _register(BallistaContext.standalone(BallistaConfig(dict(settings)), device="cpu"),
                      torch_tpch_dir)
    want = plain.sql(_sql("q3")).collect()
    paged = _register(BallistaContext.standalone(BallistaConfig({
        **settings, "ballista.engine.hbm_budget_bytes": str(_PAGED_BUDGET),
        "ballista.engine.max_shuffle_partitions": "2"}), device="cpu"), torch_tpch_dir)
    text = paged.sql("EXPLAIN ANALYZE " + _sql("q3")).collect().to_pydict()["plan"][0]
    m = paged.last_engine_metrics
    spans = [s for s in paged.last_trace_spans if s["name"] == "PagedJoin"]
    assert len(spans) == m["op.PagedJoin.count"] >= 1
    assert sum(s["attrs"]["passes"] for s in spans) == m["op.PagedJoin.passes"] >= 2
    assert all(s["attrs"]["hbm_budget_bytes"] == _PAGED_BUDGET for s in spans)
    assert "HashJoin" in text and "hbm: est_bytes=" in text
    got = paged.sql(_sql("q3")).collect()
    assert got.equals(want)


def test_serving_caches_serve_repeat_statements(torch_tpch_dir):
    ctx = _register(BallistaContext.standalone(BallistaConfig({
        "ballista.serving.plan_cache": "true"}), device="cpu"), torch_tpch_dir)
    sql = _sql("q6")
    first = ctx.sql(sql).collect()
    assert ctx.last_serving == {"plan_cache": "miss"}
    again = ctx.sql(sql).collect()
    assert ctx.last_serving == {"plan_cache": "hit"} and again.equals(first)
    assert ctx.last_engine_metrics.get("op.DeviceExecute.count", 0.0) > 0
    ctx.config.set("ballista.serving.result_cache", "true")
    ctx.sql(sql).collect()
    assert ctx.last_serving["result_cache"] == "miss"
    hit = ctx.sql(sql).collect()
    assert ctx.last_serving == {"result_cache": "hit"} and hit.equals(first)
    # EXPLAIN ANALYZE runs to produce spans: it bypasses both caches
    ctx.sql("EXPLAIN ANALYZE " + sql).collect()
    assert ctx.last_serving == {} and ctx.last_trace_spans
    # a registration invalidates both
    ctx.register_parquet("nation", os.path.join(torch_tpch_dir, "nation"))
    ctx.sql(sql).collect()
    assert ctx.last_serving == {"result_cache": "miss", "plan_cache": "miss"}


# ---- the renderers: the same text from both packages --------------------------------
def _spans() -> list[dict]:
    tid = "t" * 32
    return [
        {"trace_id": tid, "span_id": "a", "parent_id": None, "name": "query",
         "service": "client", "start_us": 0, "dur_us": 9000, "tid": 0, "attrs": {"rows": 4}},
        {"trace_id": tid, "span_id": "b", "parent_id": "a", "name": "CompiledStage",
         "service": "engine", "start_us": 100, "dur_us": 4000, "tid": 0,
         "attrs": {"rows": 4, "partition": 0, "compile_ms": 0.0, "execute_ms": 4.0,
                   "hbm_est_bytes": 1234, "hbm_peak_bytes": 999}},
        {"trace_id": tid, "span_id": "c", "parent_id": "a", "name": "DeviceExecute",
         "service": "engine", "start_us": 200, "dur_us": 1500, "tid": 0,
         "attrs": {"rows": 100.0, "program": "eager"}},
        {"trace_id": tid, "span_id": "d", "parent_id": "a", "name": "ShuffleWriterExec",
         "service": "engine", "start_us": 300, "dur_us": 700, "tid": 3, "attrs": {"rows": 4}},
        {"trace_id": tid, "span_id": "e", "parent_id": "a", "name": "shuffle-write",
         "service": "shuffle", "start_us": 400, "dur_us": 300, "tid": 0,
         "attrs": {"bytes": 2048}},
        {"trace_id": tid, "span_id": "f", "parent_id": "a", "name": "stage 1",
         "service": "scheduler", "start_us": 50, "dur_us": 8000, "tid": 0,
         "attrs": {"planned_partitions": 4, "actual_partitions": 2,
                   "aqe_coalesced_from": 4, "aqe_coalesced_to": 2}},
        {"trace_id": tid, "span_id": "g", "parent_id": "f", "name": "sidecar",
         "service": "other", "start_us": 60, "dur_us": 5, "tid": 0, "attrs": {}},
    ]


def _stage_plan(pkg: str, data_dir: str):
    import importlib

    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    cat = m("client.catalog").Catalog()
    cat.register_parquet("lineitem", os.path.join(data_dir, "lineitem"))
    sql = _sql("q1")
    logical = m("sql.planner").SqlPlanner(cat.schemas()).plan(m("sql.parser").parse_sql(sql))
    phys = m("plan.physical_planner").PhysicalPlanner(cat, m("config").BallistaConfig()).plan(
        m("plan.optimizer").optimize(logical, cat))
    return m("scheduler.planner").plan_query_stages("job", phys)


def test_renderers_give_the_jax_packages_text(torch_tpch_dir):
    from ballista_tpu.obs import explain as JX
    from ballista_tpu.obs import perfetto as JP
    from ballista_tpu_torch.obs import explain as TX
    from ballista_tpu_torch.obs import perfetto as TP

    jax_stages = _stage_plan("ballista_tpu", torch_tpch_dir)
    port_stages = _stage_plan("ballista_tpu_torch", torch_tpch_dir)
    spans = _spans()
    for js, ts in zip(jax_stages, port_stages):
        want = JX.render_explain_analyze(js, spans, job_id="j1")
        assert TX.render_explain_analyze(ts, spans, job_id="j1") == want
    assert "hbm: est_bytes=1234 peak_bytes=999" in want
    assert "device: compile_ms=0.000 execute_ms=1.500" in want
    counters = {"queue_depth": [[0.0002, 3.0], [0.005, 1.0]]}
    assert TP.to_trace_events(spans, counters) == JP.to_trace_events(spans, counters)
    assert TX.trace_tree(spans) == JX.trace_tree(spans)


def test_graph_dot_gives_the_jax_packages_text():
    import test_execution_graph as JG

    port = _COPIES.setdefault("test_execution_graph.py", _port_copy("test_execution_graph.py"))
    from ballista_tpu.scheduler import graph_dot as JD
    from ballista_tpu_torch.scheduler import graph_dot as TD

    graphs = [JG.two_stage_graph(), port.two_stage_graph()]
    assert TD.graph_to_dot(graphs[1]) == JD.graph_to_dot(graphs[0])
    for sid in graphs[0].stages:
        assert TD.stage_to_dot(graphs[1], sid) == JD.stage_to_dot(graphs[0], sid)
    JG.drain(graphs[0])
    port.drain(graphs[1])
    assert TD.graph_to_dot(graphs[1]) == JD.graph_to_dot(graphs[0])


# ---- the REST API's routes on both packages ----------------------------------------
_GET_ROUTES = ("/", "/ui", "/api/state", "/api/executors", "/api/jobs", "/api/job/{job}",
               "/api/stages/{job}", "/api/dot/{job}", "/api/dot_stage/{job}/1",
               "/api/trace/{job}", "/api/trace_spans/{job}", "/api/scale", "/api/serving",
               "/api/metrics", "/api/timeseries", "/api/profile?seconds=0.1")


def _keys(payload):
    """The key structure of a JSON payload: a dict's keys with the keys of
    each value; a list's element keys (its first element)."""
    if isinstance(payload, dict):
        return {k: _keys(v) for k, v in payload.items()}
    if isinstance(payload, list):
        return [_keys(payload[0])] if payload else []
    return type(payload).__name__


def _api_payloads(pkg: str, data_dir: str) -> dict:
    """Every GET route of ``pkg``'s REST API over a scheduler holding one
    registered executor and one planned job (no executor runs it)."""
    import importlib

    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    server = m("scheduler.server").SchedulerServer(m("config").SchedulerConfig())
    server.cluster.register(m("scheduler.cluster").ExecutorInfo("e1", "h", 1, 2, 4, 4))
    cat = m("client.catalog").Catalog()
    cat.register_parquet("lineitem", os.path.join(data_dir, "lineitem"))
    server._plan_and_submit("job-1", "sess", "sql", _sql("q1"),
                            [t.to_dict() for t in cat.tables.values()], {})
    api = m("scheduler.api").start_api_server(server, "127.0.0.1", 0)
    port = api.server_address[1]
    out = {}
    try:
        for route in _GET_ROUTES:
            url = f"http://127.0.0.1:{port}" + route.format(job="job-1")
            with urllib.request.urlopen(url, timeout=30) as r:
                body = r.read().decode()
                out[route] = (r.status, r.headers["Content-Type"], body)
    finally:
        api.shutdown()
        server.stop()
    return out


def test_rest_routes_answer_with_the_jax_packages_keys(torch_tpch_dir):
    jax_out = _api_payloads("ballista_tpu", torch_tpch_dir)
    port_out = _api_payloads("ballista_tpu_torch", torch_tpch_dir)
    for route in _GET_ROUTES:
        (js, jt, jb), (ps, pt, pb) = jax_out[route], port_out[route]
        assert (ps, pt) == (js, jt) == (200, pt), route
        if pt == "application/json":
            want = _keys(json.loads(jb))
            if route == "/api/executors":
                # the port names each executor's registered device
                want[0]["device_kind"] = "str"
            assert _keys(json.loads(pb)) == want, route
    assert port_out["/api/dot/{job}"][2].startswith("digraph")
    assert port_out["/"][2] == port_out["/ui"][2]
    metrics = port_out["/api/metrics"][2]
    assert "scale_drains_started_total" in metrics and "trace_store_jobs" in metrics
    # the same Prometheus families, in the same order
    families = [[ln.split()[2] for ln in out["/api/metrics"][2].splitlines()
                 if ln.startswith("# TYPE")] for out in (jax_out, port_out)]
    assert families[0] == families[1]


# ---- a JAX-package executor under the port's scheduler ------------------------------
def test_jax_executor_spans_render_in_the_ports_trace(torch_tpch_dir, tmp_path):
    """The wire carries spans too: a JAX-package numpy executor registered
    with the port's scheduler reports its task and operator spans, and they
    render in ``/api/trace`` and in EXPLAIN ANALYZE over the remote context."""
    from ballista_tpu.config import ExecutorConfig as JaxExecutorConfig
    from ballista_tpu.executor.process import ExecutorProcess as JaxExecutor
    from ballista_tpu_torch.config import SchedulerConfig
    from ballista_tpu_torch.scheduler.api import start_api_server
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    sched = SchedulerServer(SchedulerConfig(scheduling_policy="pull"))
    port = sched.start(0)
    ex = JaxExecutor(JaxExecutorConfig(
        port=0, flight_port=0, scheduler_host="127.0.0.1", scheduler_port=port,
        task_slots=2, scheduling_policy="pull", backend="numpy",
        work_dir=str(tmp_path / "jax-ex")), executor_id="jax-ex")
    ex.start()
    api = start_api_server(sched, "127.0.0.1", 0)
    try:
        ctx = _register(BallistaContext.remote("127.0.0.1", port), torch_tpch_dir)
        out = ctx.sql("EXPLAIN ANALYZE " + _sql("q1")).collect().to_pydict()["plan"][0]
        job = ctx.last_job_id
        assert f"job_id: {job}" in out and "rows=" in out
        url = f"http://127.0.0.1:{api.server_address[1]}/api/trace/{job}"
        with urllib.request.urlopen(url, timeout=30) as r:
            events = json.loads(r.read().decode())["traceEvents"]
        x = [e for e in events if e["ph"] == "X"]
        assert {"client", "scheduler", "executor", "engine", "shuffle"} <= {e["cat"] for e in x}
        tasks = [s for s in sched.traces.get(job) if s["service"] == "executor"]
        assert tasks and all(s["trace_id"] == ctx.last_trace_id for s in tasks)
    finally:
        api.shutdown()
        ex.stop()
        sched.stop()
