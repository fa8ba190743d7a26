"""The port's query path on the profiler's clock (``obs.tracing.Phase``).

- Under ``torch.profiler`` a standalone query's events hold the program's
  ``ballista.*`` ranges (planning, the stage, its dispatch nested in it,
  leaf encoding); with no profiler running no range is entered at all.
- The phases' counters reach ``last_engine_metrics``: ``op.Plan.*``,
  ``op.Result.*``, ``op.DeviceDispatch.*`` (inside ``op.DeviceExecute``),
  ``op.LeafCache.*`` (a warm repeat of q1 only hits) and the execution's
  grouped_sums record (``op.GroupedSums.*``, one helper for the standalone
  engine and the executor's task status).
- A host operator above device stages counts them as children: its
  exclusive ``op.<Node>.time_s`` and its span's ``self_ms`` leave them out.
- ``grouped_sums.min_bytes``, the least traffic of a call, against counts by
  hand.
"""
import os
import time

import pytest
import torch

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.models.tpch import TPCH_TABLES
from ballista_tpu_torch.obs import tracing as obs
from ballista_tpu_torch.ops import grouped_sums as GS

from test_torch_data import torch_tpch_dir  # noqa: F401

QUERIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks",
                       "queries")


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


@pytest.fixture()
def ctx(torch_tpch_dir):  # noqa: F811
    c = BallistaContext.standalone(device="cpu")
    for t in TPCH_TABLES:
        c.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return c


class _Counting:
    """``torch.profiler.record_function`` that counts the ``ballista.``
    ranges entered."""

    def __init__(self, monkeypatch):
        self.names: list = []
        real = torch.profiler.record_function

        def counted(name, *args, **kwargs):
            if name.startswith("ballista."):
                self.names.append(name)
            return real(name, *args, **kwargs)

        monkeypatch.setattr(torch.profiler, "record_function", counted)


def test_query_ranges_on_the_profilers_timeline(ctx):
    TE.clear_caches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ctx.sql(_sql("q1")).collect()
    events = [(e.name, e.thread, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith("ballista.")]
    names = {n for n, *_ in events}
    assert {"ballista.query.plan", "ballista.stage", "ballista.stage.dispatch",
            "ballista.leaf.encode", "ballista.stage.leaves", "ballista.stage.fetch",
            "ballista.device.execute", "ballista.query.result"} <= names
    assert any(n.startswith("ballista.op.") for n in names)
    stages = [(t, a, b) for n, t, a, b in events if n == "ballista.stage"]
    dispatches = [(t, a, b) for n, t, a, b in events if n == "ballista.stage.dispatch"]
    # every dispatch sits inside a stage (a fused program runs in a stage's
    # leaf collection, and so inside that stage too)
    assert dispatches and all(
        any(t == st and sa <= a and b <= sb for st, sa, sb in stages) for t, a, b in dispatches)


def test_no_range_is_entered_without_a_profiler(ctx, monkeypatch):
    counting = _Counting(monkeypatch)
    assert not obs.profiling()
    ctx.sql(_sql("q3")).collect()
    assert counting.names == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert obs.profiling()
        ctx.sql(_sql("q3")).collect()
    assert "ballista.stage" in counting.names


def test_phase_counts_times_and_records_its_span():
    metrics: dict = {}
    collector = obs.SpanCollector(mirror_global=False)
    trace = obs.TraceCtx(collector, "t1", "p1")

    def add(key, val):
        metrics[key] = metrics.get(key, 0.0) + val

    with obs.Phase("ballista.x", "op.X", add, trace, "X") as ph:
        time.sleep(0.01)
        dt = ph.stop()
        ph.attrs = {"rows": 3}
    assert metrics == {"op.X.time_s": dt, "op.X.count": 1.0} and dt >= 0.01
    (span,) = collector.drain()
    assert (span["name"], span["service"], span["parent_id"], span["attrs"]) == \
        ("X", "engine", "p1", {"rows": 3})
    assert span["dur_us"] == int(dt * 1e6)
    # work that raises records nothing
    with pytest.raises(ValueError):
        with obs.Phase("ballista.x", "op.X", add, trace, "X"):
            raise ValueError("no")
    assert metrics["op.X.count"] == 1.0 and not collector.drain()


def test_phase_counters_reach_last_engine_metrics(ctx):
    TE.clear_caches()
    for repeat in (False, True):
        ctx.sql(_sql("q1")).collect()
        m = ctx.last_engine_metrics
        assert m["op.Plan.time_s"] > 0 and m["op.Plan.count"] == 2.0
        assert m["op.Result.time_s"] > 0 and m["op.Result.count"] == 1.0
        assert m["op.DeviceDispatch.count"] == m["op.DeviceExecute.count"] > 0
        assert 0 < m["op.DeviceDispatch.time_s"] <= m["op.DeviceExecute.time_s"]
        # the host waits on no card here
        assert "op.DeviceWait.count" not in m
        assert m["op.GroupedSums.calls"] > 0
        assert m["op.GroupedSums.launches"] == m["op.GroupedSums.min_bytes"] == 0.0
        if repeat:
            assert m["op.LeafCache.hits"] > 0 and "op.LeafCache.misses" not in m
        else:
            assert m["op.LeafCache.misses"] > 0


def test_operator_time_leaves_out_the_stages_below(ctx, monkeypatch):
    """q1's merge runs on the host over device stages: each stage is a
    child of it, so the merge's own time and its span's ``self_ms`` hold
    none of the stages' (each made 0.1 s longer here: a stage that ends
    in its fetch and one whose output stays on the device for a fused
    input built there alike)."""
    run = TE.TorchEngine._stage_on_device

    def slow(self, plan, part):
        time.sleep(0.1)
        return run(self, plan, part)

    monkeypatch.setattr(TE.TorchEngine, "_stage_on_device", slow)
    TE.clear_caches()
    ctx.sql(_sql("q1")).collect()
    m = ctx.last_engine_metrics
    stages = m["op.CompiledStage.count"]
    assert stages >= 1 and m["op.CompiledStage.time_s"] >= 0.1 * stages
    assert m["op.SortPreservingMergeExec.time_s"] < 0.05
    merge = [s for s in ctx.last_trace_spans if s["name"] == "SortPreservingMergeExec"]
    assert merge and all(s["attrs"]["self_ms"] < 50 for s in merge)
    assert all(s["dur_us"] >= 1e5 for s in merge)
    # the scans below the stages are leaves, timed as before
    assert 0 < m["op.ParquetScanExec.time_s"] < m["op.CompiledStage.time_s"]


def test_record_metrics_is_the_one_fold_of_a_record():
    record = {"calls": 3, "launches": 4, "min_bytes": 1000,
              "shapes": {(1024, 12, 8, torch.int64): 2, (16, 12, 16, torch.float32): 1}}
    assert GS.record_metrics(record) == {
        "op.GroupedSums.calls": 3.0, "op.GroupedSums.launches": 4.0,
        "op.GroupedSums.min_bytes": 1000.0,
        "op.GroupedSums.shape.1024x12x8.int64": 2.0,
        "op.GroupedSums.shape.16x12x16.float32": 1.0}


_N, _K = 1000, 12


def _cols(dtype):
    ids = torch.zeros(_N, dtype=torch.int64)
    m1 = torch.ones(_N, dtype=torch.bool)
    m2 = torch.ones(_N, dtype=torch.bool)
    v1 = torch.ones(_N, dtype=dtype)
    v2 = torch.ones(_N, dtype=dtype)
    return ids, m1, m2, v1, v2


@pytest.mark.parametrize("dtype,item", [(torch.int64, 8), (torch.int32, 4)])
def test_min_bytes_by_hand(dtype, item):
    """Ids, each distinct mask and value column once, the output once: two
    masks shared by four columns, one column repeated and one a count."""
    ids, m1, m2, v1, v2 = _cols(dtype)
    vals, masks = [v1, v2, v1, None], [m1, m1, m2, m2]
    want = 8 * _N + 2 * _N + 2 * item * _N + 4 * _K * item
    assert GS.min_bytes(vals, masks, ids, _K) == want
    # one column over one mask
    assert GS.min_bytes([v1], [m1], ids, _K) == 8 * _N + _N + item * _N + _K * item
    # a count alone reads no values and writes int64 sums
    assert GS.min_bytes([None], [m1], ids, _K) == 8 * _N + _N + _K * 8
