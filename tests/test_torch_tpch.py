"""TPC-H through the PyTorch port's torch engine, on the CPU.

Rows are held against the pandas oracle (all 22 queries; nodes the port has
not taken to the device yet run on its host kernels) and, for the device
slice's queries, against the JAX engine too. Comparison is
``assert_frames_match``: ints, strings, dates and decimals exact; floats
(AVG, ratios) within rtol 1e-6, the oracle's own tolerance.
"""
import os

import pytest

from ballista_tpu.client.context import BallistaContext as JaxContext
from ballista_tpu.models.tpch import TPCH_TABLES
from ballista_tpu_torch.client.context import BallistaContext

from test_tpch_numpy import ORDERED, assert_frames_match, oracle_tables  # noqa: F401
from tpch_oracle import ORACLES

QUERIES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries")


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


@pytest.fixture(scope="module")
def tctx(tpch_dir):
    c = BallistaContext.standalone(device="cpu")
    for t in TPCH_TABLES:
        c.register_parquet(t, os.path.join(tpch_dir, t))
    return c


@pytest.fixture(scope="module")
def jctx(tpch_dir):
    c = JaxContext.standalone(backend="jax")
    for t in TPCH_TABLES:
        c.register_parquet(t, os.path.join(tpch_dir, t))
    return c


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts grouped_sums calls (the CPU runs its plain version, so the
    launch counter stays 0 here; the call is what shows the path)."""
    import ballista_tpu_torch.ops.grouped_sums as GS

    real = GS.grouped_sums
    calls = []

    def counting(*a, **kw):
        calls.append(a[3] if len(a) > 3 else kw.get("k"))
        return real(*a, **kw)

    monkeypatch.setattr(GS, "grouped_sums", counting)
    return calls


@pytest.mark.parametrize("qname", ["q1", "q6", "q4", "q12"])
def test_slice_matches_jax_engine_and_oracle(tctx, jctx, oracle_tables, qname):
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    want_jax = jctx.sql(_sql(qname)).collect().to_pandas()
    assert_frames_match(got, want_jax, qname in ORDERED, f"{qname} vs jax")
    assert_frames_match(got, ORACLES[qname](oracle_tables), qname in ORDERED, qname)


@pytest.mark.parametrize("qname", ["q1", "q6"])
def test_slice_runs_on_device_through_grouped_sums(tctx, kernel_calls, qname):
    tctx.sql(_sql(qname)).collect()
    m = tctx.last_engine_metrics
    assert m.get("op.HostFallback.count", 0.0) == 0.0, m
    assert m.get("op.DeviceExecute.count", 0.0) >= 2  # partial and final stages
    assert kernel_calls, f"{qname}: grouped_sums never called"
    assert all(0 < k <= 32 for k in kernel_calls)
    for key in ("op.DeviceTransfer.bytes", "op.DeviceExecute.rows", "op.DeviceFetch.bytes"):
        assert m.get(key, 0.0) > 0, key


def test_join_query_falls_back_to_host_kernels(tctx):
    """Joins are not ported yet: q3's join runs on the host kernels and is
    counted, while its aggregate stages still reach the device."""
    tctx.sql(_sql("q3")).collect()
    m = tctx.last_engine_metrics
    assert m.get("op.HostFallback.count", 0.0) > 0
    assert m.get("op.DeviceExecute.count", 0.0) > 0


@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 23)])
def test_tpch_sweep_matches_oracle(tctx, oracle_tables, qname):
    got = tctx.sql(_sql(qname)).collect().to_pandas()
    assert_frames_match(got, ORACLES[qname](oracle_tables), qname in ORDERED, qname)
