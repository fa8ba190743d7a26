"""The port's memory governor against the JAX package's, on the CPU.

The same plans and tables go through ``ballista_tpu_torch.engine.memory_model``
and ``ballista_tpu.engine.memory_model``, and through the torch engine on
``device="cpu"`` and the JAX engine (over one device, as the port has one):

* the estimators, the duplicate-run solve, the partition solve and
  ``govern_plan``'s verdicts (fits, repartitioned, paged, rejected) equal
  the JAX package's;
* a repartitioned join, a paged join, a paged join over a build with many
  duplicate keys, and a join the trace-time estimate pages return the JAX
  engine's rows exactly, with equal ``op.PagedJoin.passes`` and equal
  ``op.HbmEst.max_bytes``;
* the estimate never pages a join a fused exchange supplies, and a fused
  exchange over the budget is declined;
* a ``backend="numpy"`` context and a torch engine on the CPU never probe a
  card's memory; a plan nothing fits raises ``PlanVerificationError`` at
  admission.

These mirror ``tests/test_memory_governor.py``.
"""
import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.config import BallistaConfig as JaxConfig
from ballista_tpu.engine import memory_model as JMM
from ballista_tpu.engine import spill as JSP
from ballista_tpu.ops import batch as JB
from ballista_tpu.parallel import mesh as JMESH
from ballista_tpu.plan import expr as JX
from ballista_tpu.plan import physical as JP
from ballista_tpu.plan import schema as JS
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine import spill as SP
from ballista_tpu_torch.errors import PlanVerificationError
from ballista_tpu_torch.ops import batch as TB
from ballista_tpu_torch.parallel import mesh as MESH
from ballista_tpu_torch.plan import expr as TX
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan import schema as TS

from test_torch_joins import _host_ops

N_PROBE = 40_000
N_BUILD = 2_000
KEYS = 997

# a partitioned equi-join of a fact and a dimension side
SQL = "select a.k, v, w from a join b on a.k = b.k order by v, w"


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(7)
    probe = pa.table({
        "k": rng.integers(0, KEYS, N_PROBE),
        "v": np.arange(N_PROBE, dtype=np.int64),
    })
    build = pa.table({
        "k": np.arange(N_BUILD, dtype=np.int64) % KEYS,
        "w": np.arange(N_BUILD, dtype=np.int64) * 10,
    })
    return probe, build


def _settings(ici: bool, knobs: dict) -> dict:
    # the PARTITIONED join shape (no broadcast) at a width the governor must
    # then widen or page against
    out = {"ballista.optimizer.broadcast_rows_threshold": "0",
           "ballista.shuffle.partitions": "2"}
    if not ici:
        out["ballista.tpu.ici_shuffle"] = "false"
    out.update({k: str(v) for k, v in knobs.items()})
    return out


def _torch_ctx(ici=False, backend="torch", **knobs) -> BallistaContext:
    cfg = BallistaConfig()
    for k, v in _settings(ici, knobs).items():
        cfg.set(k, v)
    if backend == "numpy":
        return BallistaContext.standalone(config=cfg, backend="numpy")
    return BallistaContext.standalone(config=cfg, device="cpu")


def _jax_ctx(ici=False, **knobs) -> JaxContext:
    """The JAX engine over one device (the port's world), governed for one."""
    cfg = JaxConfig()
    for k, v in _settings(ici, knobs).items():
        cfg.set(k, v)
    ctx = JaxContext.standalone(config=cfg, backend="jax")
    ctx._n_devices = lambda: 1
    make = ctx._get_engine

    def one_device():
        engine = make()
        engine.mesh_devices = 1
        return engine

    ctx._get_engine = one_device
    return ctx


def _run(ctx, tables, sql=SQL) -> pa.Table:
    probe, build = tables
    ctx.register_arrow("a", probe, partitions=2)
    ctx.register_arrow("b", build, partitions=2)
    return ctx.sql(sql).collect()


def _actions(ctx) -> list:
    return [d.action for d in ctx.last_memory_report.decisions]


GOVERNOR_KEYS = ("op.PagedJoin.count", "op.PagedJoin.passes", "op.HbmEst.max_bytes")


def _same_as_jax(tctx, jctx, tables, sql=SQL) -> dict:
    """Run ``sql`` on both; rows equal, the same governor verdicts, paged
    passes and stage estimate, and the same operator kinds on host kernels.
    Returns the torch metrics."""
    got = _run(tctx, tables, sql)
    want = _run(jctx, tables, sql)
    assert got.equals(want)
    tm, jm = tctx.last_engine_metrics, jctx.last_engine_metrics
    for key in GOVERNOR_KEYS:
        assert tm.get(key, 0.0) == jm.get(key, 0.0), key
    assert _host_ops(tm) == _host_ops(jm)
    assert (tctx.last_memory_report is None) == (jctx.last_memory_report is None)
    if tctx.last_memory_report is not None:
        assert tctx.last_memory_report.as_dict() == jctx.last_memory_report.as_dict()
    return tm


# ---- model units ------------------------------------------------------------------
def test_bucket_size_and_widths():
    assert MM.bucket_size(1) == 8
    assert MM.bucket_size(8) == 8
    assert MM.bucket_size(9) == 16
    assert MM.bucket_size(100_000) == 1 << 17
    s = TS.Schema.of(("a", TS.DataType.INT64), ("b", TS.DataType.STRING),
                     ("c", TS.DataType.BOOL))
    # 8 (int64) + 4 (string codes) + 1 (bool) + 3 null masks
    assert MM.row_data_bytes(s) == 8 + 4 + 1 + 3
    assert MM.padded_batch_bytes(s, 9) == 16 * (MM.row_data_bytes(s) + 1)


def _schemas(fields):
    return (TS.Schema.of(*[(n, TS.DataType(t)) for n, t in fields]),
            JS.Schema.of(*[(n, JS.DataType(t)) for n, t in fields]))


PROBE_FIELDS = [("k", "int64"), ("v", "float64"), ("s", "string"), ("d", "date32")]
BUILD_FIELDS = [("k", "int64"), ("w", "int32"), ("b", "bool")]


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi", "anti"])
def test_estimators_equal_the_jax_package(how):
    (tp, jp), (tb, jb) = _schemas(PROBE_FIELDS), _schemas(BUILD_FIELDS)
    for rows in (1, 9, 1000, 123_457):
        for dup in (1, 2, 8, 64):
            assert MM.estimate_join_program(tp, rows, tb, rows // 3 + 1, how, dup) == \
                JMM.estimate_join_program(jp, rows, jb, rows // 3 + 1, how, dup)
        for k in (None, 1, 12, 5000):
            assert MM.estimate_agg_program(tp, rows, tb, k) == \
                JMM.estimate_agg_program(jp, rows, jb, k)
        assert MM.estimate_ici_exchange_bytes(tp, rows, 1) == \
            JMM.estimate_ici_exchange_bytes(jp, rows, 1)
        for budget in (0, 10_000, 10**6, 10**8, 10**10):
            assert MM.solve_build_dup_cap(tp, rows, tb, rows, how, budget) == \
                JMM.solve_build_dup_cap(jp, rows, jb, rows, how, budget)


def test_join_estimate_monotone_in_rows():
    s, _ = _schemas([("k", "int64"), ("v", "int64")])
    small = MM.estimate_join_program(s, 1_000, s, 1_000, "inner")
    big = MM.estimate_join_program(s, 1_000_000, s, 1_000_000, "inner")
    assert big > small * 100
    # outer joins carry the unmatched-build output section
    inner = MM.estimate_join_program(s, 10_000, s, 10_000, "inner")
    full = MM.estimate_join_program(s, 10_000, s, 10_000, "full")
    assert full > inner


def test_budget_solver_matches_the_jax_package():
    pick, jpick = MESH.pick_shuffle_partitions, JMESH.pick_shuffle_partitions
    assert pick(8, 16) == 16 and pick(8, 4) == 8
    curve = lambda n: 400 // n  # noqa: E731
    assert pick(4, 4, budget_bytes=30, bytes_per_partition=curve) == 16
    assert pick(4, 4, budget_bytes=1, bytes_per_partition=curve, max_partitions=64) == 0
    # the largest device-aligned count under the cap is probed before 0
    assert pick(8, 24, budget_bytes=1, bytes_per_partition=lambda n: 0 if n >= 4000 else 9,
                max_partitions=4096) == 4096
    assert MESH.MAX_SHUFFLE_PARTITIONS == JMESH.MAX_SHUFFLE_PARTITIONS
    for n_dev in (1, 3, 8):
        for req in (1, 2, 16, 24, 4000):
            for budget in (0, 1, 30, 100, 1000):
                for maxp in (4, 64, 4096):
                    args = (n_dev, req, budget, curve, maxp)
                    assert pick(*args) == jpick(*args), args


def test_resolve_budget_knob_semantics():
    cfg = BallistaConfig()
    cfg.set("ballista.engine.hbm_budget_bytes", str(123))
    assert MM.resolve_budget_bytes(cfg) == 123
    cfg.set("ballista.engine.hbm_budget_bytes", str(-1))
    assert MM.resolve_budget_bytes(cfg) == 0  # negative turns the governor off
    cfg.set("ballista.engine.hbm_budget_bytes", str(0))
    assert MM.resolve_budget_bytes(cfg, detected_bytes=456) == 456
    assert MM.resolve_budget_bytes(cfg, detected_bytes=0) == 0
    # a CPU device has no budget to detect
    assert MM.resolve_budget_bytes(cfg, device="cpu") == 0
    cfg.set("ballista.engine.hbm_budget_bytes", str(123))
    assert MM.resolve_budget_bytes(cfg, detected_bytes=456) == 123


def test_salted_spill_buckets_match_the_jax_package(tmp_path):
    """The paged join's split: every row in the bucket the JAX package's
    PartitionSpill puts it in, salted and not."""
    rng = np.random.default_rng(3)
    table = pa.table({"k": rng.integers(0, 500, 3000), "s": rng.choice(["x", "y", "z"], 3000)})
    for salted in (False, True):
        for keys in (["k"], ["k", "s"]):
            t = SP.PartitionSpill(8, [TX.Col(k) for k in keys], str(tmp_path / "t"), salted)
            j = JSP.PartitionSpill(8, [JX.Col(k) for k in keys], str(tmp_path / "j"), salted)
            got = t._bucket_ids(TB.ColumnBatch.from_arrow(table))
            want = j._bucket_ids(JB.ColumnBatch.from_arrow(table))
            assert np.array_equal(got, want)
            t.append_split(TB.ColumnBatch.from_arrow(table))
            t.finish()
            back = [t.read_all(b, None) for b in range(8)]
            assert sum(b.num_rows for b in back) == 3000
            assert [t.rows(b) for b in range(8)] == [int((got == b).sum()) for b in range(8)]
            t.close()
            j.close()


# ---- govern_plan over plans -------------------------------------------------------
def _join_plan(X, PX, S, n_parts=2, probe_rows=200_000, build_rows=100_000):
    s = S.Schema.of(("k", S.DataType.INT64), ("v", S.DataType.INT64))
    left = PX.RepartitionExec(PX.MemoryScanExec([], s),
                              PX.HashPartitioning((X.Col("k"),), n_parts), est_rows=probe_rows)
    right = PX.RepartitionExec(PX.MemoryScanExec([], s),
                               PX.HashPartitioning((X.Col("k"),), n_parts), est_rows=build_rows)
    return PX.HashJoinExec(left, right, "inner", [(X.Col("k"), X.Col("k"))])


def _govern_both(**kw):
    """govern_plan over the same join plan in both packages: the port's
    (plan, report), once its verdicts are checked equal to the JAX
    package's."""
    tplan, treport = MM.govern_plan(_join_plan(TX, P, TS), n_devices=1, **kw)
    jplan, jreport = JMM.govern_plan(_join_plan(JX, JP, JS), n_devices=1, **kw)
    assert treport.as_dict() == jreport.as_dict()
    assert repr(tplan) == repr(jplan)
    return tplan, treport


def test_govern_plan_repartitions_both_sides():
    plan = _join_plan(TX, P, TS)
    est0 = MM.estimate_join_program(plan.left.schema(), 100_000, plan.right.schema(),
                                    50_000, "inner")
    governed, report = _govern_both(budget_bytes=est0 // 3)
    [d] = report.decisions
    assert d.action == "repartitioned"
    assert d.partitions_after > d.partitions_before
    assert d.est_bytes_after <= report.budget_bytes
    # co-partitioned: both exchanges resized to the same width
    assert governed.left.partitioning.n == governed.right.partitioning.n == d.partitions_after


def test_govern_plan_pages_then_rejects():
    governed, report = _govern_both(budget_bytes=50_000, max_partitions=4)
    [d] = report.decisions
    assert d.action == "paged" and d.passes >= 2
    assert d.est_bytes_after <= report.budget_bytes
    assert governed.paged is True
    _, report2 = _govern_both(budget_bytes=50_000, max_partitions=4, paged_enabled=False)
    [d2] = report2.decisions
    assert d2.action == "rejected"
    assert "paged join disabled" in d2.message and "fix:" in d2.message
    assert "enable ballista.engine.paged_join" in d2.message


def test_govern_plan_rejects_when_pass_solve_never_converges():
    _, report = _govern_both(budget_bytes=10_000, max_partitions=4)
    [d] = report.decisions
    assert d.action == "rejected"
    assert f"paged join exhausted at {MM.MAX_PAGED_PASSES} passes" in d.message
    assert "enable ballista.engine.paged_join" not in d.message


def test_govern_plan_fits_is_untouched():
    plan = _join_plan(TX, P, TS)
    governed, report = MM.govern_plan(plan, budget_bytes=100 * MM.GiB, n_devices=1)
    assert governed is plan
    assert [d.action for d in report.decisions] == ["fits"]


# ---- end to end -------------------------------------------------------------------
def test_repartitioned_join_matches_jax_engine(tables):
    base = _run(_torch_ctx(), tables)
    tctx = _torch_ctx(**{"ballista.engine.hbm_budget_bytes": 400_000})
    _same_as_jax(tctx, _jax_ctx(**{"ballista.engine.hbm_budget_bytes": 400_000}), tables)
    assert _run(tctx, tables).equals(base)
    assert "repartitioned" in _actions(tctx)
    assert tctx.last_memory_report.chosen_partitions() > 2
    assert any("PV007" in w for w in tctx.last_warnings)


def test_paged_join_matches_jax_engine(tables):
    knobs = {"ballista.engine.hbm_budget_bytes": 400_000,
             "ballista.engine.max_shuffle_partitions": 2}
    tctx = _torch_ctx(**knobs)
    m = _same_as_jax(tctx, _jax_ctx(**knobs), tables)
    assert _actions(tctx) == ["paged"]
    assert m.get("op.PagedJoin.count", 0) > 0 and m.get("op.PagedJoin.passes", 0) >= 2
    assert m.get("op.HostFallback.count", 0.0) == 0.0  # every pass on the device
    assert _run(tctx, tables).equals(_run(_torch_ctx(), tables))


def test_paged_join_duplicate_heavy_build_keys():
    """Every build key repeats 80 times, also inside each pass: the paged
    join neither loses nor repeats a fan-out row. Under this budget a
    device join may hold runs of 32, so each pass runs on host kernels, on
    both engines."""
    rng = np.random.default_rng(13)
    dup_tables = (
        pa.table({"k": rng.integers(0, 50, 8_000), "v": np.arange(8_000, dtype=np.int64)}),
        pa.table({"k": np.arange(4_000, dtype=np.int64) % 50,
                  "w": np.arange(4_000, dtype=np.int64)}),
    )
    knobs = {"ballista.engine.hbm_budget_bytes": 300_000,
             "ballista.engine.max_shuffle_partitions": 2}
    tctx = _torch_ctx(**knobs)
    m = _same_as_jax(tctx, _jax_ctx(**knobs), dup_tables)
    assert m.get("op.PagedJoin.count", 0) > 0
    assert "HashJoinExec" in _host_ops(m)
    assert _run(tctx, dup_tables).equals(_run(_torch_ctx(), dup_tables))


def test_trace_time_estimate_pages_without_admission_flag(tables):
    """Admission sees a budget the plan fits, but a tiny
    ``paged_join_threshold`` makes the stage's own estimate page the join."""
    knobs = {"ballista.engine.hbm_budget_bytes": 50_000_000,
             "ballista.engine.paged_join_threshold": 0.05}
    tctx = _torch_ctx(**knobs)
    m = _same_as_jax(tctx, _jax_ctx(**knobs), tables)
    assert all(a == "fits" for a in _actions(tctx))
    assert m.get("op.PagedJoin.count", 0) > 0 and m.get("op.PagedJoin.passes", 0) >= 2
    assert m.get("op.HostFallback.count", 0.0) == 0.0


def test_estimate_never_pages_a_fused_join():
    """With the fused exchange on (the default), the join runs as one fused
    program that serves the whole result on partition 0: the stage estimate
    must not page it (a paged join reads one exchange partition per task and
    would drop every row outside partition 0)."""
    rng = np.random.default_rng(11)
    n = 8_000
    fused_tables = (
        pa.table({"k": rng.integers(0, 500, n), "v": np.arange(n, dtype=np.int64)}),
        pa.table({"k": np.arange(500, dtype=np.int64), "w": np.arange(500, dtype=np.int64) * 10}),
    )
    sql = "select count(*) as n, sum(v) as sv from a join b on a.k = b.k"
    knobs = {"ballista.engine.hbm_budget_bytes": 50_000_000,
             "ballista.engine.paged_join_threshold": 0.0001}
    tctx = _torch_ctx(ici=True, **knobs)
    m = _same_as_jax(tctx, _jax_ctx(ici=True, **knobs), fused_tables, sql)
    assert _run(tctx, fused_tables, sql).equals(_run(_torch_ctx(ici=True), fused_tables, sql))
    assert m.get("op.FusedIciJoin.count", 0) > 0
    assert m.get("op.PagedJoin.count", 0) == 0


def test_fused_exchange_declined_over_budget(tables):
    """A fused exchange whose estimate exceeds the budget is declined (once,
    in ``op.FusedDeclined.count``) and the materialized exchange runs, with
    the same rows; under a roomy budget it fuses."""
    probe, _ = tables
    sql = "select k, sum(v) as sv from a group by k order by k"

    def run(ctx):
        ctx.register_arrow("a", probe, partitions=2)
        return ctx.sql(sql).collect()

    knobs = {"ballista.engine.hbm_budget_bytes": 10_000}
    tctx, jctx = _torch_ctx(ici=True, **knobs), _jax_ctx(ici=True, **knobs)
    got, want = run(tctx), run(jctx)
    assert got.equals(want)
    assert tctx.last_engine_metrics.get("op.FusedIciExchange.count", 0) == 0
    assert jctx.last_engine_metrics.get("op.FusedIciExchange.count", 0) == 0
    assert tctx.last_engine_metrics.get("op.FusedDeclined.count", 0) == 1
    roomy = _torch_ctx(ici=True)
    assert run(roomy).equals(got)
    assert roomy.last_engine_metrics.get("op.FusedIciExchange.count", 0) > 0
    assert roomy.last_engine_metrics.get("op.FusedDeclined.count", 0) == 0


def test_stage_estimate_equals_the_jax_engines(tables):
    """``op.HbmEst.max_bytes`` of the same plan and leaves; on the CPU there
    is no allocator peak to measure (``op.HbmPeak.max_bytes`` stays unset)."""
    tctx = _torch_ctx()
    _same_as_jax(tctx, _jax_ctx(), tables)
    m = tctx.last_engine_metrics
    assert m.get("op.HbmEst.max_bytes", 0) > 0
    assert "op.HbmPeak.max_bytes" not in m and "op.DevicePeak.max_bytes" not in m


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_no_budget_detection_off_the_card(monkeypatch, tables, backend):
    """A host engine, and a torch engine on the CPU, never probe a card's
    memory: no budget without the knob, so no governor."""

    def boom(*_a, **_kw):  # pragma: no cover - called means the gate failed
        raise AssertionError("device budget detection ran off the card")

    monkeypatch.setattr(MM, "detect_device_budget_bytes", boom)
    ctx = _torch_ctx(backend=backend)
    assert _run(ctx, tables).num_rows > N_PROBE  # build keys repeat
    assert ctx.last_memory_report is None
    assert ctx.last_engine_metrics.get("op.PagedJoin.count", 0) == 0


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_rejection_at_admission(tables, backend):
    ctx = _torch_ctx(backend=backend, **{
        "ballista.engine.hbm_budget_bytes": 50_000,
        "ballista.engine.max_shuffle_partitions": 2,
        "ballista.engine.paged_join": "false",
    })
    with pytest.raises(PlanVerificationError) as ei:
        _run(ctx, tables)
    msg = str(ei.value)
    assert "PV007" in msg and "fix:" in msg
    assert "hbm_budget_bytes" in msg  # the hint names the knob
    assert [f[0] for f in ei.value.findings] == ["PV007"]
    assert ctx.last_memory_report.rejections()
