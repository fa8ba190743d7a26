"""The port's compile service: warm runs for the scheduler's precompile hints.

Against the JAX package: ``shape_signature``, ``strip_stats`` and
``synthetic_batch`` agree on the same numpy-made batches, and for the stage
templates of all 22 TPC-H queries both engines' ``precompile_stage_template``
give the same skip reason and the same (program fingerprint, source,
bucket) specs (a ``submit`` stub records them; nothing compiles or runs).

The port alone: malformed, non-list and duplicate hint payloads are counted
or deduped and never fail a task; a warm keeps out of the leaf caches and of
grouped_sums' counts, declines over the device budget, warms at the bucket
``min_device_rows`` lets reach the device, and waits for the device window;
a real stage that finds its key warmed credits the warm's wall to
``op.CompileHidden.time_s`` once (driven deterministically: the hint work is
drained before the stage runs); and through an in-process cluster on
``device="cpu"``, q1, q3, q5 and q12 return byte-identical rows with
``ballista.engine.precompile`` on and off, the service warms at least one
stage with it on, and the leaf-cache stats, grouped_sums' launch count and
the tasks' ``op.GroupedSums.*`` are equal between on and off. Each cluster
test runs under a time limit of its own (``_within``).
"""
import base64
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import compile_service as CS
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.models.tpch import TPCH_TABLES
from ballista_tpu_torch.ops import grouped_sums as GS
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import Column, ColumnBatch
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.expr import Agg, Alias, Col
from ballista_tpu_torch.plan.schema import DataType, Field, Schema

from test_torch_data import torch_tpch_dir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = os.path.join(REPO, "benchmarks", "queries")
TPCH = [f"q{i}" for i in range(1, 23)]


def _sql(q: str) -> str:
    with open(os.path.join(QUERIES, f"{q}.sql")) as f:
        return f.read()


def _within(limit_s: float, fn, *args):
    """``fn(*args)``, failing the test if it takes longer than ``limit_s``."""
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(fn, *args).result(timeout=limit_s)
    finally:
        pool.shutdown(wait=False)


@pytest.fixture(autouse=True)
def fresh_service():
    svc = CS.get_service()
    assert svc.wait_idle(60)
    TE.clear_caches()
    svc.clear()
    svc.reset_stats()
    yield svc
    assert svc.wait_idle(60)
    svc.clear()


# ---- parity with the JAX package's helpers ---------------------------------------------
def _layout_batch(pkg, seed: int, n: int, nulls: bool):
    """A batch of ``pkg``'s classes from numpy: int64, a two-decimal float,
    date32, bool and a string column, with nulls in the int column."""
    import importlib

    batch = importlib.import_module(f"{pkg}.ops.batch")
    schema_mod = importlib.import_module(f"{pkg}.plan.schema")
    DT = schema_mod.DataType
    rng = np.random.default_rng(seed)
    ints = rng.integers(-1000, 1000, n)
    valid = rng.random(n) > 0.2 if nulls else None
    price = np.round(rng.random(n) * 1000, 2)
    dates = rng.integers(8000, 11000, n).astype(np.int32)
    flags = rng.random(n) > 0.5
    strs = pa.array([["A", "N", "R"][i] for i in rng.integers(0, 3, n)], type=pa.string())
    fields = (("i", DT.INT64), ("p", DT.FLOAT64), ("d", DT.DATE32), ("b", DT.BOOL),
              ("s", DT.STRING))
    schema = schema_mod.Schema(tuple(schema_mod.Field(a, t) for a, t in fields))
    cols = [batch.Column(DT.INT64, ints, valid), batch.Column(DT.FLOAT64, price),
            batch.Column(DT.DATE32, dates), batch.Column(DT.BOOL, flags),
            batch.Column(DT.STRING, strs)]
    return batch.ColumnBatch(schema, cols, num_rows=n)


@pytest.mark.parametrize("seed,n,nulls", [(0, 5, False), (1, 100, True), (2, 3000, True)])
def test_shape_signature_and_strip_stats_match_jax(seed, n, nulls):
    from ballista_tpu.engine import compile_service as JCS
    from ballista_tpu.ops import kernels_jax as KJ

    jenc = KJ.encode_host_batch(_layout_batch("ballista_tpu", seed, n, nulls))
    tenc = KT.encode_host_batch(_layout_batch("ballista_tpu_torch", seed, n, nulls))
    assert CS.shape_signature(tenc) == JCS.shape_signature(jenc)
    for enc, strip in ((jenc, JCS.strip_stats), (tenc, CS.strip_stats)):
        strip(enc)
        assert enc.int_ranges is None and enc.ssums is None and enc._sig is None
    assert CS.shape_signature(tenc) == JCS.shape_signature(jenc)


@pytest.mark.parametrize("rows", [8, 1000])
def test_synthetic_batch_matches_jax(rows):
    import importlib

    from ballista_tpu.engine import compile_service as JCS

    values = np.array(["AIR", "MAIL", "RAIL", "SHIP"], dtype=object)
    out = []
    for pkg, cs in (("ballista_tpu", JCS), ("ballista_tpu_torch", CS)):
        schema_mod = importlib.import_module(f"{pkg}.plan.schema")
        dicts = importlib.import_module(f"{pkg}.engine.dictionaries")
        did = "t.mode@v1:parity"
        dicts.REGISTRY.ensure(did, values)
        DT = schema_mod.DataType
        schema = schema_mod.Schema(tuple(schema_mod.Field(a, t) for a, t in (
            ("i", DT.INT64), ("j", DT.INT32), ("f", DT.FLOAT64), ("d", DT.DATE32),
            ("b", DT.BOOL), ("t.mode", DT.STRING))))
        b = cs.synthetic_batch(schema, rows, {"t.mode": did})
        out.append(b.to_arrow())
        lone = schema_mod.Schema((schema_mod.Field("s", DT.STRING),))
        with pytest.raises(cs.Unhintable):
            cs.synthetic_batch(lone, rows)
    assert out[0].equals(out[1])


# ---- the same decisions on every TPC-H stage template ---------------------------------
# the default plans (small build sides collected) and plans whose joins all
# run partitioned, over two exchanges
PLANS = {"default": {}, "partitioned": {"ballista.optimizer.broadcast_rows_threshold": "0"}}


@pytest.fixture(scope="module")
def stage_templates(torch_tpch_dir):
    """{(plans, query): (JAX templates, port templates)}: each package's
    stages of the query, planned by its own planner from the same parquet
    files under the same settings."""
    from ballista_tpu.client.context import BallistaContext as JCtx
    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu_torch.client.context import BallistaContext as TCtx

    import ballista_tpu.scheduler.planner as JP
    import ballista_tpu_torch.scheduler.planner as TP
    from test_torch_stream import JAX, PORT, physical_plan

    out = {}
    for label, settings in PLANS.items():
        jctx = JCtx.standalone(JConfig(dict(settings)), backend="numpy")
        tctx = TCtx.standalone(BallistaConfig(dict(settings)), device="cpu")
        for ctx in (jctx, tctx):
            for t in TPCH_TABLES:
                ctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
        for q in TPCH:
            out[(label, q)] = (JP.plan_query_stages("hint", physical_plan(JAX, jctx, _sql(q))),
                               TP.plan_query_stages("hint", physical_plan(PORT, tctx, _sql(q))))
    return out


def _decisions(engine, stages, chunk_buckets, state_buckets):
    out = []
    for stage in stages:
        specs = []
        n, reason = engine.precompile_stage_template(
            stage, chunk_buckets, state_buckets,
            submit=lambda _fn, top, source, _schema, bucket: specs.append(
                (top.fingerprint(), source.fingerprint(), bucket)))
        out.append((stage.stage_id, reason, n, specs))
    return out


@pytest.mark.parametrize("plans", sorted(PLANS))
@pytest.mark.parametrize("q", TPCH)
def test_template_decisions_match_jax(stage_templates, q, plans):
    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu.engine.jax_engine import JaxEngine

    jstages, tstages = stage_templates[(plans, q)]
    assert len(jstages) == len(tstages)
    want = _decisions(JaxEngine(JConfig()), jstages, [8, 1024], [8])
    got = _decisions(TE.TorchEngine(BallistaConfig(), device="cpu"), tstages, [8, 1024], [8])
    assert got == want
    assert CS.get_service().stats()["cache_opened"] == 0  # the stub ran nothing


def test_some_tpch_templates_warm(stage_templates):
    """Not every template declines: q3's top-10 over its final aggregate
    streams (merge, finalize and the projection above), in either plan."""
    eng = TE.TorchEngine(BallistaConfig(), device="cpu")
    reasons = {(plans, q, sid): reason for plans, q in stage_templates
               for sid, reason, _n, _s in _decisions(eng, stage_templates[(plans, q)][1],
                                                     [8], [8])}
    assert reasons[("default", "q3", 4)] is None
    warm = {plans: sum(r is None for (p, _q, _s), r in reasons.items() if p == plans)
            for plans in PLANS}
    assert min(warm.values()) > 0, warm
    assert {r for r in reasons.values() if r} >= {
        "stage shape is not streamable", "join build side unavailable before the stage runs"}


# ---- hint payloads ---------------------------------------------------------------------
def test_hint_payload_fault_paths():
    svc = CS.CompileService(workers=1)
    assert svc.submit_hints("not json", {}) == 0
    assert svc.stats()["hint_failed"] == 1
    assert svc.submit_hints(json.dumps({"stage_id": 1}), {}) == 0  # not a list
    assert svc.stats()["hint_failed"] == 2
    # a bad plan: counted failed on the worker, the caller never affected
    payload = json.dumps([{"stage_id": 9, "plan": "!!!", "rows": 0}, "not a dict"])
    assert svc.submit_hints(payload, {}, device="cpu") == 1
    assert svc.wait_idle(30)
    assert svc.stats()["hint_failed"] == 3
    # duplicates dedupe by digest; the same hint for another device does not
    assert svc.submit_hints(payload, {}, device="cpu") == 0
    assert svc.submit_hints(payload, {}, device="cpu:1") == 1
    assert svc.wait_idle(30)
    assert svc.stats()["hint_submitted"] == 2


# ---- engine-level warms ------------------------------------------------------------------
def _int_schema(*names):
    return Schema(tuple(Field(n, DataType.INT64) for n in names))


def _int_batch(schema, *cols):
    return ColumnBatch(schema, [Column(DataType.INT64, np.asarray(c, np.int64)) for c in cols])


def _final_agg_template():
    in_schema = _int_schema("k", "v")
    state_schema = _int_schema("k", "sv#sum", "c#count")
    unresolved = P.UnresolvedShuffleExec(1, state_schema, 2)
    final = P.HashAggregateExec(
        unresolved, "final", [Col("k")],
        [Alias(Agg("sum", Col("v")), "sv"), Alias(Agg("count_star", None), "c")],
        input_schema_for_aggs=in_schema,
    )
    return P.ShuffleWriterExec("job", 2, final, None), final, unresolved, state_schema


def _run_merge(eng, final, unresolved, chunk):
    merge = P.HashAggregateExec(unresolved, "merge", final.group_exprs, final.agg_exprs,
                                final.input_schema_for_aggs)
    spliced = eng._splice(merge, unresolved, eng._scan_at(chunk, 0))
    return eng._exec(spliced, 0)


def test_warmed_key_credits_hidden_time_once(fresh_service):
    tmpl, final, unresolved, state_schema = _final_agg_template()
    eng = TE.TorchEngine(BallistaConfig(), device="cpu")
    before = GS.thread_record()
    warmed, reason = eng.precompile_stage_template(tmpl, [8], [8])
    assert reason is None and warmed == 2  # merge and finalize
    # the warm ran grouped_sums (k from the synthetic keys), counted apart
    assert GS.thread_record() == before
    chunk = _int_batch(state_schema, [0, 1, 2, 0, 1], [10, 20, 30, 40, 50], [1, 2, 3, 4, 5])
    real = TE.TorchEngine(BallistaConfig(), device="cpu")
    out = _run_merge(real, final, unresolved, chunk).to_arrow().to_pydict()
    assert dict(zip(out["k"], out["sv#sum"])) == {0: 50, 1: 70, 2: 30}
    hidden = real.op_metrics.get("op.CompileHidden.time_s", 0.0)
    assert hidden > 0.0
    stats = fresh_service.stats()
    assert stats["hidden_count"] == 1 and stats["cache_hits"] == 1 and stats["cache_opened"] == 2
    # a second stage on the same key finds it warmed but credits nothing more
    _run_merge(real, final, unresolved, chunk)
    assert real.op_metrics["op.CompileHidden.time_s"] == hidden
    assert fresh_service.stats()["hidden_count"] == 2
    # with precompile off a real stage looks nothing up
    off = TE.TorchEngine(BallistaConfig({"ballista.engine.precompile": "false"}), device="cpu")
    _run_merge(off, final, unresolved, chunk)
    assert fresh_service.stats()["cache_hits"] == 2 and "op.CompileHidden.time_s" not in \
        off.op_metrics


def _hint_payload(tmpl, rows=0) -> str:
    from ballista_tpu_torch.plan.serde import encode_physical

    return json.dumps([{"stage_id": 2, "plan": base64.b64encode(encode_physical(tmpl)).decode(),
                        "rows": rows, "direct": True}])


def test_service_warm_then_stage_adopts(fresh_service):
    """Through the service: the hint is drained before the real stage runs,
    so the stage adopts the warmed key; a span carries compile_hidden_ms."""
    from ballista_tpu_torch.obs import tracing as obs

    tmpl, final, unresolved, state_schema = _final_agg_template()
    assert fresh_service.submit_hints(_hint_payload(tmpl, rows=100), {}, device="cpu") == 1
    assert fresh_service.wait_idle(60)
    stats = fresh_service.stats()
    assert stats["hint_compiled"] == 3 and stats["hint_failed"] == 0, stats  # merge at 8 and 128
    keys = list(fresh_service.cache._entries)
    assert sorted(k[2][0][1][0] for k in keys) == [8, 8, 128]
    chunk = _int_batch(state_schema, np.arange(100) % 7, np.arange(100), np.ones(100))
    real = TE.TorchEngine(BallistaConfig(), device="cpu")
    collector = obs.SpanCollector()
    root = collector.start("task", trace_id="t")
    real.trace_ctx = obs.TraceCtx(collector, "t", root.span_id)
    _run_merge(real, final, unresolved, chunk)
    assert real.op_metrics.get("op.CompileHidden.time_s", 0.0) > 0.0
    spans = [s for s in collector.drain() if s["name"] == "CompiledStage"]
    assert spans and spans[0]["attrs"]["compile_hidden_ms"] > 0


def test_warm_declines_over_budget_and_keeps_out_of_leaf_caches(fresh_service):
    tmpl, _final, _unresolved, _schema = _final_agg_template()
    enc0 = (LC.ENC.hits, LC.ENC.misses, len(LC.ENC))
    dev0 = (LC.DEV.hits, LC.DEV.misses, len(LC.DEV))
    fresh_service.submit_hints(_hint_payload(tmpl), {"ballista.engine.hbm_budget_bytes": "64"},
                               device="cpu")
    assert fresh_service.wait_idle(60)
    stats = fresh_service.stats()
    assert stats["hint_compiled"] == 0 and stats["hint_skipped"] == 2, stats
    # the same hint again is deduped by its digest (the session's settings
    # are not part of it), so the run within budget hints other rows
    assert fresh_service.submit_hints(_hint_payload(tmpl), {}, device="cpu") == 0
    fresh_service.submit_hints(_hint_payload(tmpl, rows=100), {}, device="cpu")
    assert fresh_service.wait_idle(60)
    assert fresh_service.stats()["hint_compiled"] == 3
    assert (LC.ENC.hits, LC.ENC.misses, len(LC.ENC)) == enc0
    assert (LC.DEV.hits, LC.DEV.misses, len(LC.DEV)) == dev0


def test_warm_reaches_the_device_past_min_device_rows(fresh_service):
    """A stage under ``min_device_rows`` runs on the host: the warm takes the
    least bucket at which the real stage reaches the device."""
    tmpl, _final, _unresolved, _schema = _final_agg_template()
    fresh_service.submit_hints(_hint_payload(tmpl), {"ballista.tpu.min_device_rows": "100"},
                               device="cpu")
    assert fresh_service.wait_idle(60)
    assert fresh_service.stats()["hint_compiled"] == 2
    assert {k[2][0][1][0] for k in fresh_service.cache._entries} == {128}


def test_dtype_policy_mismatch_is_skipped(fresh_service):
    tmpl, _final, _unresolved, _schema = _final_agg_template()
    other = "false" if KT.NATIVE_DTYPES else "true"
    fresh_service.submit_hints(_hint_payload(tmpl), {"ballista.tpu.native_dtypes": other},
                               device="cpu")
    assert fresh_service.wait_idle(60)
    assert fresh_service.stats()["hint_skipped"] == 1
    assert fresh_service.stats()["hint_compiled"] == 0


def test_device_window_keeps_warms_out_of_stages():
    window = CS.DeviceWindow()
    inside = threading.Event()
    leave = threading.Event()

    def stage():
        with window.stage():
            with window.stage():  # nested: a stage inside a stage's leaves
                inside.set()
                leave.wait(10)

    t = threading.Thread(target=stage)
    t.start()
    assert inside.wait(10)
    with pytest.raises(CS.Unhintable, match="device busy"):
        with window.warm(timeout=0.1):
            pass
    order = []

    def warm():
        with window.warm(timeout=10):
            order.append("warm")
            time.sleep(0.2)
        order.append("warm done")

    w = threading.Thread(target=warm)
    w.start()
    time.sleep(0.1)
    leave.set()
    t.join(10)
    time.sleep(0.05)
    with window.stage():  # waits for the running warm
        order.append("stage")
    w.join(10)
    assert order == ["warm", "warm done", "stage"]


# ---- through an in-process cluster -------------------------------------------------------
CLUSTER_QUERIES = ("q1", "q3", "q5", "q12")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from ballista_tpu_torch.client.standalone import start_standalone_cluster

    c = start_standalone_cluster(n_executors=2, task_slots=2, backend="torch", device="cpu",
                                 work_dir=str(tmp_path_factory.mktemp("torch-hints")))
    yield c
    c.stop()


def _cache_stats():
    return {name: (c.hits, c.misses) for name, c in (("enc", LC.ENC), ("dev", LC.DEV))}


def _run_side(cluster, data_dir, precompile: str) -> dict:
    from ballista_tpu_torch.client.context import BallistaContext

    svc = CS.get_service()
    ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port, BallistaConfig({
        "ballista.engine.precompile": precompile,
        # every stage runs in both sides: none is adopted from the other's
        "ballista.serving.exchange_cache": "false"}))
    for t in TPCH_TABLES:
        ctx.register_parquet(t, os.path.join(data_dir, t))
    TE.clear_caches()
    svc.clear()
    svc.reset_stats()
    cache0, launches0 = _cache_stats(), GS.launches
    out = {"rows": {}, "gs": {}, "compile_cache": 0.0, "hidden": 0.0}
    for q in CLUSTER_QUERIES:
        table = ctx.sql(_sql(q)).collect()
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as w:
            w.write_table(table)
        out["rows"][q] = sink.getvalue().to_pybytes()
        graph = cluster.scheduler.tasks.get_job(ctx.last_job_id)
        for s in graph.stages.values():
            for k, v in s.stage_metrics.items():
                if k.startswith("op.GroupedSums."):
                    out["gs"][(q, s.stage_id, k)] = v
                if k.startswith("compile_cache."):
                    out["compile_cache"] += v
            out["hidden"] += s.stage_metrics.get("op.CompileHidden.time_s", 0.0)
        assert svc.wait_idle(60)  # the next query's hints start from a quiet service
    cache1 = _cache_stats()
    out["cache"] = {k: tuple(b - a for a, b in zip(cache0[k], cache1[k])) for k in cache0}
    out["launches"] = GS.launches - launches0
    out["stats"] = svc.stats()
    return out


def test_cluster_rows_equal_with_hints_on_and_off(cluster, torch_tpch_dir):
    on = _within(240, _run_side, cluster, torch_tpch_dir, "true")
    off = _within(240, _run_side, cluster, torch_tpch_dir, "false")
    assert on["rows"] == off["rows"]
    assert on["stats"]["hint_submitted"] > 0 and on["stats"]["hint_compiled"] > 0
    assert on["stats"]["hint_failed"] == 0, on["stats"]
    assert off["stats"]["hint_submitted"] == 0 and off["stats"]["cache_opened"] == 0
    # the tasks report the warmed-key record's activity only with hints on
    assert on["compile_cache"] > 0 and off["compile_cache"] == 0
    assert off["hidden"] == 0.0
    # warms change no leaf-cache stat and no grouped_sums count
    assert on["cache"] == off["cache"]
    assert on["launches"] == off["launches"]
    assert on["gs"] == off["gs"] and any(k[2] == "op.GroupedSums.calls" for k in on["gs"])


def test_garbage_hints_never_fail_the_task(cluster, torch_tpch_dir):
    """A corrupt hint on the launch props (session-level, so it rides every
    launch the scheduler has no real hints for) is counted, and the query
    still returns its rows."""
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BALLISTA_PRECOMPILE_HINTS

    def run():
        ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port)
        ctx.config.set(BALLISTA_PRECOMPILE_HINTS, "{corrupt")
        ctx.register_parquet("lineitem", os.path.join(torch_tpch_dir, "lineitem"))
        got = ctx.sql("select count(*) as n from lineitem").collect()
        return got.column("n")[0].as_py()

    assert _within(120, run) > 0
    assert CS.get_service().stats()["hint_failed"] >= 1
