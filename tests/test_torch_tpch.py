"""TPC-H through the PyTorch port's torch engine, on the CPU.

Rows are held against the pandas oracle (all 22 queries) and, for the device
slice's queries, against the JAX engine too (``test_torch_joins.py`` holds
all 22 against it). Comparison is
``assert_frames_match``: ints, strings, dates and decimals exact; floats
(AVG, ratios) within rtol 1e-6, the oracle's own tolerance.
"""
import os

import pytest

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.models.tpch import TPCH_TABLES
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig

from test_torch_data import torch_oracle_tables, torch_tpch_dir  # noqa: F401
from test_tpch_numpy import ORDERED, assert_frames_match
from tpch_oracle import ORACLES

QUERIES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries")


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def tctx(torch_tpch_dir):
    c = BallistaContext.standalone(device="cpu")
    for t in TPCH_TABLES:
        c.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return c


@pytest.fixture(scope="module")
def jctx(torch_tpch_dir):
    c = JaxContext.standalone(backend="jax")
    for t in TPCH_TABLES:
        c.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return c


@pytest.fixture
def kernel_calls(monkeypatch):
    """Records (k, columns) of each grouped_sums call (the CPU runs its
    plain version, so the launch counter stays 0 here; the call is what
    shows the path)."""
    import ballista_tpu_torch.ops.grouped_sums as GS

    real = GS.grouped_sums_multi
    calls = []

    def counting(vals, masks, ids, k):
        calls.append((k, len(vals)))
        return real(vals, masks, ids, k)

    monkeypatch.setattr(GS, "grouped_sums_multi", counting)
    return calls


@pytest.mark.parametrize("qname", ["q1", "q6", "q4", "q12"])
def test_slice_matches_jax_engine_and_oracle(tctx, jctx, torch_oracle_tables, qname):
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    want_jax = jctx.sql(_sql(qname)).collect().to_pandas()
    assert_frames_match(got, want_jax, qname in ORDERED, f"{qname} vs jax")
    assert_frames_match(got, ORACLES[qname](torch_oracle_tables), qname in ORDERED, qname)


@pytest.mark.parametrize("qname", ["q1", "q6"])
def test_slice_runs_on_device_through_grouped_sums(tctx, kernel_calls, qname):
    tctx.sql(_sql(qname)).collect()
    m = tctx.last_engine_metrics
    assert m.get("op.HostFallback.count", 0.0) == 0.0, m
    assert m.get("op.DeviceExecute.count", 0.0) >= 2  # partial and final stages
    assert kernel_calls, f"{qname}: grouped_sums never called"
    assert all(0 < k <= 32 and cols > 0 for k, cols in kernel_calls)
    for key in ("op.DeviceTransfer.bytes", "op.DeviceExecute.rows", "op.DeviceFetch.bytes"):
        assert m.get(key, 0.0) > 0, key


def test_join_query_falls_back_to_host_kernels(tctx, torch_tpch_dir, kernel_calls):
    """The join queries q3 and q5 fall back to the host kernels nowhere: their
    joins and aggregates run on the device, and q5's aggregate by n_name goes
    through grouped_sums. With the fused exchange off, k = 27 in the partial
    stages (the shared 26-entry dictionary and the NULL slot the join's
    gather brings), 26 in the final ones; the fused program aggregates the
    join's fetched output, which has no NULL slot: k = 26 in both."""
    unfused = BallistaContext.standalone(BallistaConfig({"ballista.tpu.ici_shuffle": "false"}),
                                         device="cpu")
    for t in TPCH_TABLES:
        unfused.register_parquet(t, os.path.join(torch_tpch_dir, t))
    for ctx, want, not_want in ((tctx, {26}, {27}), (unfused, {26, 27}, set())):
        kernel_calls.clear()
        for q in ("q3", "q5"):
            ctx.sql(_sql(q)).collect()
            m = ctx.last_engine_metrics
            assert m.get("op.HostFallback.count", 0.0) == 0.0, (q, m)
            assert m.get("op.DeviceExecute.count", 0.0) > 0, q
        assert kernel_calls and all(0 < k <= 32 for k, _ in kernel_calls)
        ks = {k for k, _ in kernel_calls}
        assert want <= ks and not ks & not_want, ks


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 23)])
def test_tpch_sweep_matches_oracle(tctx, torch_oracle_tables, qname):
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    assert_frames_match(got, ORACLES[qname](torch_oracle_tables), qname in ORDERED, qname)


def test_wide_aggregate_matches_jax_engine(tctx, jctx, kernel_calls):
    """Twenty AVGs, two SUMs and a COUNT by (returnflag, linestatus): each
    final stage sums 44 int64 columns, more than one kernel launch takes
    (the wrapper splits such a call on the card). Rows equal the JAX
    engine's."""
    aggs = [f"avg(l_quantity + {i}) as a{i}" for i in range(20)]
    aggs += ["sum(l_extendedprice) as s0", "sum(l_discount) as s1", "count(*) as n"]
    sql = (f"select l_returnflag, l_linestatus, {', '.join(aggs)} from lineitem "
           "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus")
    got = tctx.sql(sql).collect().to_pandas()
    assert tctx.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
    assert max(cols for _, cols in kernel_calls) > 32
    assert_frames_match(got, jctx.sql(sql).collect().to_pandas(), True, "wide vs jax")
