"""grouped_sums in the PyTorch port against the Pallas kernel it replaces.

The plain versions (``grouped_sums_ref`` and the multi-column
``grouped_sums_multi_ref``, what the wrappers run on CPU tensors) are held
column by column against ``ballista_tpu.ops.pallas_kernels.grouped_sums`` in
interpret mode, and the port's ``SegSums`` (one sum or count alone, an
aggregate stage's batch, and a stage wider than one launch takes) against
``kernels_jax``'s seg_sum / seg_count with the Pallas route off and on; the
engine makes one call per device aggregate stage.
Tolerances: int64 results exact and of dtype int64 (int sums are exact in
any order); float32 within rtol 1e-5 (the two sum the same f32 values in
different orders). The CUDA kernel itself runs only on the card: see
``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.ops import kernels_jax as KJ
from ballista_tpu.ops.pallas_kernels import grouped_sums as pallas_grouped_sums
from ballista_tpu_torch.ops import grouped_sums as GS
from ballista_tpu_torch.ops import kernels_torch as KT

from test_torch_data import torch_tpch_dir  # noqa: F401


def _inputs(n: int, k: int, seed: int = 11):
    """Ids in [0, k) plus trash ids (-1, k, k + 5), ~20% invalid rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, k, n).astype(np.int64)
    trash = rng.random(n) < 0.1
    ids[trash] = rng.choice(np.array([-1, k, k + 5]), int(trash.sum()))
    valid = rng.random(n) < 0.8
    fvals = rng.random(n).astype(np.float32)
    ivals = rng.integers(-(10**12), 10**12, n).astype(np.int64)
    return ids, valid, fvals, ivals


def _pallas(vals, ids, valid, k):
    return np.asarray(pallas_grouped_sums(
        jnp.asarray(vals), jnp.asarray(ids.astype(np.int32)), jnp.asarray(valid), k,
        interpret=True,
    ))


@pytest.mark.parametrize("k", [1, 7, 32])
@pytest.mark.parametrize("kind", ["int64", "float32"])
def test_ref_matches_pallas_interpret(k, kind):
    n = 5000  # deliberately NOT a multiple of the Pallas block (2048)
    ids, valid, fvals, ivals = _inputs(n, k)
    vals = ivals if kind == "int64" else fvals
    want = _pallas(vals, ids, valid, k)
    before = GS.launches
    got = GS.grouped_sums(torch.from_numpy(vals), torch.from_numpy(ids),
                          torch.from_numpy(valid), k)
    assert GS.launches == before  # a CPU tensor never launches
    got = got.numpy()
    assert got.shape == (k,)
    if kind == "int64":
        assert got.dtype == np.int64 and want.dtype == np.int64
        assert np.array_equal(got, want)
    else:
        assert got.dtype == np.float32
        assert np.allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["int64", "float32"])
def test_ref_empty_input(kind):
    k = 5
    dt = np.int64 if kind == "int64" else np.float32
    empty = np.zeros(0, dt)
    want = _pallas(empty, np.zeros(0, np.int64), np.zeros(0, bool), k)
    got = GS.grouped_sums_ref(torch.from_numpy(empty), torch.zeros(0, dtype=torch.int64),
                              torch.zeros(0, dtype=torch.bool), k).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, np.zeros(k, dt))


def _segsums_one_by_one(ids, k, row_valid, plan):
    """Each (kind, values, null) of ``plan`` registered with its own
    ``SegSums`` and computed alone (numpy in, numpy out)."""
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out = []
    for kind, v, null in plan:
        s = KT.SegSums(t(ids), k, t(row_valid))
        s.count(t(null)) if kind == "count" else s.sum(t(v), t(null))
        out.append(s.compute()[0].numpy())
    return out


def _kernels_jax(ids, k, row_valid, plan, pallas_on):
    """kernels_jax's seg_sum / seg_count of each (kind, values, null), with
    its Pallas route on or off."""
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    KJ.PALLAS_SEGSUM = pallas_on
    try:
        return [np.asarray(KJ.seg_count(j(ids), k, j(row_valid), j(null)) if kind == "count"
                           else KJ.seg_sum(j(v), j(ids), k, j(row_valid), j(null)))
                for kind, v, null in plan]
    finally:
        KJ.PALLAS_SEGSUM = False


def _assert_same(got, want, label):
    assert got.dtype == want.dtype, label
    if got.dtype == np.float32:
        assert np.allclose(got, want, rtol=1e-5), label
    else:
        assert np.array_equal(got, want), label


@pytest.mark.parametrize("pallas_on", [False, True])
def test_seg_sum_and_count_match_kernels_jax(pallas_on):
    """One sum or count per ``SegSums`` (always through grouped_sums at
    k <= 32) against kernels_jax's seg_sum / seg_count with its Pallas route
    off and on; nulls included, int sums of every width the engine sums."""
    rng = np.random.default_rng(11)
    n, k = 5000, 7
    ids = rng.integers(0, k, n).astype(np.int64)
    row_valid = rng.random(n) < 0.8
    ids = np.where(row_valid, ids, k)  # invalid rows carry the trash id, as in the engine
    null = rng.random(n) < 0.25
    plan = [("sum", rng.random(n).astype(np.float32), null),
            ("sum", rng.integers(-(10**9), 10**9, n).astype(np.int64), null),
            ("sum", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), null),
            ("sum", rng.integers(-(2**15), 2**15 - 1, n).astype(np.int16), None),
            ("count", None, null), ("count", None, None)]
    got = _segsums_one_by_one(ids, k, row_valid, plan)
    want = _kernels_jax(ids, k, row_valid, plan, pallas_on)
    for (kind, v, _), g, w in zip(plan, got, want):
        _assert_same(g, w, (kind, None if v is None else v.dtype))


def test_seg_sum_large_k_uses_index_add_and_matches():
    """Above MASKED_SEG_K the port scatters with index_add_ (no kernel): same
    answers as kernels_jax's segment_sum, for sums and counts."""
    rng = np.random.default_rng(5)
    n, k = 4000, 100
    ids = rng.integers(0, k + 1, n).astype(np.int64)
    rv = rng.random(n) < 0.9
    null = rng.random(n) < 0.2
    plan = [("sum", rng.integers(-1000, 1000, n).astype(np.int64), None),
            ("sum", rng.random(n), null), ("count", None, null)]
    calls = []
    real = GS.grouped_sums_multi
    GS.grouped_sums_multi = lambda *a: calls.append(a) or real(*a)
    try:
        got = _segsums_one_by_one(ids, k, rv, plan)
    finally:
        GS.grouped_sums_multi = real
    assert not calls
    for (kind, _, _), g, w in zip(plan, got, _kernels_jax(ids, k, rv, plan, False)):
        _assert_same(g, w, kind)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor runs the plain version; any other device launches
    the kernel or raises — here a meta tensor, which has no kernel."""
    t = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        GS.grouped_sums(t, t, torch.zeros(8, dtype=torch.bool, device="meta"), 4)


# ---- several columns in one call -----------------------------------------------------
def _multi_inputs(n: int, k: int, seed: int = 13):
    """Ids with trash (-1, k, k + 5), three masks (the first shared by
    several columns), int64 and float32 value columns."""
    rng = np.random.default_rng(seed)
    ids, _, _, _ = _inputs(n, k, seed)
    masks = [rng.random(n) < p for p in (0.8, 0.5, 0.95)]
    ivals = [rng.integers(-(10**12), 10**12, n).astype(np.int64) for _ in range(4)]
    fvals = [rng.random(n).astype(np.float32) for _ in range(3)]
    return ids, masks, ivals, fvals


@pytest.mark.parametrize("n", [5000, 37, 0])
@pytest.mark.parametrize("k", [1, 7, 12, 32])
def test_multi_ref_matches_pallas_interpret_column_by_column(n, k):
    """int64 sums and counts in one call, f32 sums in another; shared and
    distinct masks, trash ids, n not a multiple of the Pallas block."""
    ids, masks, ivals, fvals = _multi_inputs(n, k)
    t = torch.from_numpy
    # (value or None for a count, mask index)
    int_cols = [(ivals[0], 0), (None, 0), (ivals[1], 0), (ivals[2], 1), (None, 1),
                (ivals[3], 2), (None, 2)]
    flt_cols = [(fvals[0], 0), (fvals[1], 1), (fvals[2], 0)]
    before = GS.launches
    got_i = GS.grouped_sums_multi([None if v is None else t(v) for v, _ in int_cols],
                                  [t(masks[m]) for _, m in int_cols], t(ids), k)
    got_f = GS.grouped_sums_multi([t(v) for v, _ in flt_cols],
                                  [t(masks[m]) for _, m in flt_cols], t(ids), k)
    assert GS.launches == before  # CPU tensors run the plain version
    assert got_i.dtype == torch.int64 and tuple(got_i.shape) == (len(int_cols), k)
    assert got_f.dtype == torch.float32 and tuple(got_f.shape) == (len(flt_cols), k)
    for row, (v, m) in enumerate(int_cols):
        vals = masks[m].astype(np.int64) if v is None else v
        assert np.array_equal(got_i[row].numpy(), _pallas(vals, ids, masks[m], k)), row
    for row, (v, m) in enumerate(flt_cols):
        assert np.allclose(got_f[row].numpy(), _pallas(v, ids, masks[m], k), rtol=1e-5), row


def test_multi_takes_one_accumulator_type_per_call():
    ids, masks, ivals, fvals = _multi_inputs(64, 4)
    t = torch.from_numpy
    with pytest.raises(TypeError, match="one call"):
        GS.grouped_sums_multi([t(ivals[0]), t(fvals[0])], [t(masks[0])] * 2, t(ids), 4)
    with pytest.raises(TypeError, match="one call"):
        GS.grouped_sums_multi([t(fvals[0]), None], [t(masks[0])] * 2, t(ids), 4)
    with pytest.raises(ValueError, match="masks"):
        GS.grouped_sums_multi([t(ivals[0])], [], t(ids), 4)


@pytest.mark.parametrize("pallas_on", [False, True])
@pytest.mark.parametrize("n", [5000, 4096])
def test_stage_batch_matches_kernels_jax(pallas_on, n):
    """One SegSums batch (f32 sums, int64 sums, counts over no null, a shared
    null and a distinct null) against kernels_jax's seg_sum/seg_count one by
    one, with its Pallas route off and on."""
    rng = np.random.default_rng(17)
    k = 7
    row_valid = rng.random(n) < 0.8
    ids = np.where(row_valid, rng.integers(0, k, n), k).astype(np.int64)
    nulls = [None, rng.random(n) < 0.25, rng.random(n) < 0.4]
    fv = [rng.random(n).astype(np.float32) for _ in range(2)]
    iv = [rng.integers(-(10**9), 10**9, n).astype(np.int64) for _ in range(3)]
    # (kind, values, null index)
    plan = [("count", None, 0), ("sum", iv[0], 0), ("sum", fv[0], 1), ("count", None, 1),
            ("sum", iv[1], 1), ("count", None, 0), ("sum", iv[2], 2), ("sum", fv[1], 2),
            ("count", None, 2)]

    T_null = [None if x is None else torch.from_numpy(x) for x in nulls]
    sums = KT.SegSums(torch.from_numpy(ids), k, torch.from_numpy(row_valid))
    at = [sums.count(T_null[ni]) if kind == "count" else sums.sum(torch.from_numpy(v), T_null[ni])
          for kind, v, ni in plan]
    assert at[5] == at[0]  # counts over the same null are one column
    calls = []
    real = GS.grouped_sums_multi

    def counting(vals, masks, ids_, k_):
        calls.append(len(vals))
        return real(vals, masks, ids_, k_)

    GS.grouped_sums_multi = counting
    try:
        res = sums.compute()
    finally:
        GS.grouped_sums_multi = real
    assert sorted(calls) == [2, 6]  # f32: 2 sums; int64: 3 sums + 3 distinct counts

    J_null = [None if x is None else jnp.asarray(x) for x in nulls]
    jids, jrv = jnp.asarray(ids), jnp.asarray(row_valid)
    KJ.PALLAS_SEGSUM = pallas_on
    try:
        for (kind, v, ni), i in zip(plan, at):
            if kind == "count":
                want = np.asarray(KJ.seg_count(jids, k, jrv, J_null[ni]))
            else:
                want = np.asarray(KJ.seg_sum(jnp.asarray(v), jids, k, jrv, J_null[ni]))
            got = res[i].numpy()
            assert got.dtype == want.dtype, (kind, ni)
            if got.dtype == np.float32:
                assert np.allclose(got, want, rtol=1e-5), (kind, ni)
            else:
                assert np.array_equal(got, want), (kind, ni)
    finally:
        KJ.PALLAS_SEGSUM = False


@pytest.mark.parametrize("keys,limit,want", [
    ([1, 1, 1, 2, 2, 3], 32, [[0, 1, 2, 3, 4, 5]]),
    ([1, 1, 1, 2, 2, 3], 4, [[0, 1, 2], [3, 4, 5]]),
    ([1, 1, 1, 2, 2, 3], 3, [[0, 1, 2], [3, 4, 5]]),
    ([1, 1, 1, 2, 2, 3], 2, [[0, 1], [2], [3, 4], [5]]),
    ([1] * 7 + [2], 3, [[0, 1, 2], [3, 4, 5], [6, 7]]),
    ([1] * 40, 32, [list(range(32)), list(range(32, 40))]),
    ([1], 1, [[0]]),
])
def test_column_chunks_keep_a_masks_columns_together(keys, limit, want):
    got = GS.column_chunks(keys, limit)
    assert got == want
    assert [c for ch in got for c in ch] == list(range(len(keys)))
    assert all(0 < len(ch) <= limit for ch in got)


@pytest.mark.parametrize("pallas_on", [False, True])
def test_wide_stage_matches_kernels_jax(pallas_on):
    """A stage of 48 columns as one SegSums batch: 28 int64 sums, 12 f32
    sums and 8 distinct counts over 8 nulls, against kernels_jax. Its 36
    int64 columns are more than one launch takes at any k (the kernel's
    parameter block holds 32), so on the card that call is split."""
    rng = np.random.default_rng(19)
    n, k = 4097, 12
    row_valid = rng.random(n) < 0.85
    ids = np.where(row_valid, rng.integers(0, k, n), k).astype(np.int64)
    nulls = [None] + [rng.random(n) < p for p in np.linspace(0.05, 0.6, 7)]
    plan = [("sum", rng.integers(-(10**12), 10**12, n).astype(np.int64), nulls[c % 8])
            for c in range(28)]
    plan += [("sum", rng.random(n).astype(np.float32), nulls[c % 8]) for c in range(12)]
    plan += [("count", None, nulls[c]) for c in range(8)]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    tnull = {id(x): t(x) for x in nulls}  # one tensor per null, as the engine shares them
    sums = KT.SegSums(t(ids), k, t(row_valid))
    at = [sums.count(tnull[id(x)]) if kind == "count" else sums.sum(t(v), tnull[id(x)])
          for kind, v, x in plan]
    calls = []
    real = GS.grouped_sums_multi
    GS.grouped_sums_multi = lambda *a: calls.append(len(a[0])) or real(*a)
    try:
        res = sums.compute()
    finally:
        GS.grouped_sums_multi = real
    assert sorted(calls) == [12, 36]  # f32: 12 sums; int64: 28 sums + 8 counts
    want = _kernels_jax(ids, k, row_valid, plan, pallas_on)
    for c, ((kind, _, _), i, w) in enumerate(zip(plan, at, want)):
        _assert_same(res[i].numpy(), w, (c, kind))


@pytest.mark.parametrize("qname,stages,partial_cols", [("q1", 18, 8), ("q6", 3, 2)])
def test_one_grouped_sums_call_per_device_aggregate_stage(torch_tpch_dir, qname, stages,
                                                          partial_cols):
    """At SF 0.01 in 2 files: q1 runs 2 partial and 16 final aggregate stages,
    q6 2 partial and 1 final. Each makes one call; q1's partial stage carries
    its 7 sums and one count (its 9 counts over the same mask merged)."""
    import os

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.models.tpch import TPCH_TABLES

    ctx = BallistaContext.standalone(device="cpu")
    for t in TPCH_TABLES:
        ctx.register_parquet(t, os.path.join(torch_tpch_dir, t))
    calls = []
    real = GS.grouped_sums_multi

    def counting(vals, masks, ids, k):
        calls.append((int(ids.shape[0]), k, len(vals), len({m.data_ptr() for m in masks})))
        return real(vals, masks, ids, k)

    GS.grouped_sums_multi = counting
    try:
        path = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "queries",
                            f"{qname}.sql")
        with open(path) as f:
            ctx.sql(f.read()).collect()
    finally:
        GS.grouped_sums_multi = real
    m = ctx.last_engine_metrics
    assert m.get("op.HostFallback.count", 0.0) == 0.0
    assert m["op.DeviceExecute.count"] == stages
    assert len(calls) == stages
    partial = [c for c in calls if c[0] > 8]
    assert len(partial) == 2 and all(c[2] == partial_cols and c[3] == 1 for c in partial)
