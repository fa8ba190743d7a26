"""The PyTorch port on the card: the CUDA kernel and the engine on ``cuda``.

These tests need an NVIDIA GPU and nvcc, and skip without them (a CUDA
kernel has no CPU mode). They import nothing of JAX, so they also run where
JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: int64 results exact, float32 within rtol 1e-5 of the plain
version (the same f32 values summed in another order), and bitwise equal
between two runs of the kernel (it uses no atomics). Engine results: ints,
strings and the decimal sums equal the port's CPU run exactly (both sum
scaled int64), AVG within 1e-6 relative.
"""
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, k, seed, device):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, k, n).astype(np.int64)
    trash = rng.random(n) < 0.1
    ids[trash] = rng.choice(np.array([-1, k, k + 5]), int(trash.sum()))
    valid = rng.random(n) < 0.8
    ivals = rng.integers(-(10**12), 10**12, n).astype(np.int64)
    fvals = rng.random(n).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (ids, valid, ivals, fvals)]


@pytest.mark.parametrize("n,k", [(5000, 7), (1 << 21, 12), (4097, 1), (4097, 32), (0, 3)])
def test_grouped_sums_kernel_matches_plain_version(card, n, k):
    from ballista_tpu_torch.ops import grouped_sums as GS

    ids, valid, ivals, fvals = _inputs(n, k, 11, card)
    before = GS.launches
    gi = GS.grouped_sums(ivals, ids, valid, k)
    gc = GS.grouped_sums(valid.to(torch.int64), ids, valid, k)
    gf = GS.grouped_sums(fvals, ids, valid, k)
    gf2 = GS.grouped_sums(fvals, ids, valid, k)
    torch.cuda.synchronize()
    assert GS.launches == before + 4
    assert gi.dtype == torch.int64 and gf.dtype == torch.float32
    assert torch.equal(gi, GS.grouped_sums_ref(ivals, ids, valid, k))
    assert torch.equal(gc, GS.grouped_sums_ref(valid.to(torch.int64), ids, valid, k))
    assert torch.allclose(gf, GS.grouped_sums_ref(fvals, ids, valid, k), rtol=1e-5)
    assert torch.equal(gf, gf2)


def test_grouped_sums_rejects_what_the_kernel_does_not_take(card):
    from ballista_tpu_torch.ops import grouped_sums as GS

    ids, valid, ivals, _ = _inputs(64, 4, 1, card)
    with pytest.raises(ValueError):
        GS.grouped_sums(ivals, ids, valid, 33)
    with pytest.raises(TypeError):
        GS.grouped_sums(ivals.to(torch.float64), ids, valid, 4)
    with pytest.raises(ValueError):
        GS.grouped_sums(ivals[::2], ids[::2], valid[::2], 4)


def test_q1_q6_on_card_match_cpu(card, tmp_path):
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.models.tpch import generate_tpch
    from ballista_tpu_torch.ops import grouped_sums as GS

    lineitem = generate_tpch(str(tmp_path), sf=0.01, tables=["lineitem"])["lineitem"]
    on_card = BallistaContext.standalone()
    on_cpu = BallistaContext.standalone(device="cpu")
    for c in (on_card, on_cpu):
        c.register_parquet("lineitem", lineitem)
    for q in ("q1", "q6"):
        with open(os.path.join(REPO, "benchmarks", "queries", f"{q}.sql")) as f:
            sql = f.read()
        GS.launches = 0
        got = on_card.sql(sql).collect()
        assert GS.launches > 0
        assert on_card.last_engine_metrics.get("op.HostFallback.count", 0.0) == 0.0
        want = on_cpu.sql(sql).collect()
        assert got.schema == want.schema and got.num_rows == want.num_rows
        for name in got.column_names:
            g = got.column(name).to_numpy(zero_copy_only=False)
            w = want.column(name).to_numpy(zero_copy_only=False)
            if name.startswith("avg"):
                assert np.allclose(g, w, rtol=1e-6), name
            else:
                assert np.array_equal(g, w), name
