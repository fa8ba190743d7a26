"""grouped_sums in the PyTorch port against the Pallas kernel it replaces.

The plain version (``grouped_sums_ref``, what the wrapper runs on a CPU
tensor) is held against ``ballista_tpu.ops.pallas_kernels.grouped_sums`` in
interpret mode, and the port's ``seg_sum``/``seg_count`` against
``kernels_jax``'s with the Pallas route off and on. Tolerances: int64 results
exact and of dtype int64 (int sums are exact in any order); float32 within
rtol 1e-5 (the two sum the same f32 values in different orders). The CUDA
kernel itself runs only on the card: see ``test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.ops import kernels_jax as KJ
from ballista_tpu.ops.pallas_kernels import grouped_sums as pallas_grouped_sums
from ballista_tpu_torch.ops import grouped_sums as GS
from ballista_tpu_torch.ops import kernels_torch as KT


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


@pytest.mark.parametrize("pallas_on", [False, True])
def test_seg_sum_and_count_match_kernels_jax(pallas_on):
    """The port's seg_sum/seg_count (always through grouped_sums at k <= 32)
    against kernels_jax with its Pallas route off and on; nulls included."""
    rng = np.random.default_rng(11)
    n, k = 5000, 7
    ids = rng.integers(0, k, n).astype(np.int64)
    row_valid = rng.random(n) < 0.8
    ids = np.where(row_valid, ids, k)  # invalid rows carry the trash id, as in the engine
    null = rng.random(n) < 0.25
    fvals = rng.random(n).astype(np.float32)
    ivals = rng.integers(-(10**9), 10**9, n).astype(np.int64)

    J = {name: jnp.asarray(a) for name, a in
         (("ids", ids), ("rv", row_valid), ("null", null), ("f", fvals), ("i", ivals))}
    T = {name: torch.from_numpy(a) for name, a in
         (("ids", ids), ("rv", row_valid), ("null", null), ("f", fvals), ("i", ivals))}
    KJ.PALLAS_SEGSUM = pallas_on
    try:
        want_f = np.asarray(KJ.seg_sum(J["f"], J["ids"], k, J["rv"], J["null"]))
        want_i = np.asarray(KJ.seg_sum(J["i"], J["ids"], k, J["rv"], J["null"]))
        want_c = np.asarray(KJ.seg_count(J["ids"], k, J["rv"], J["null"]))
    finally:
        KJ.PALLAS_SEGSUM = False
    got_f = KT.seg_sum(T["f"], T["ids"], k, T["rv"], T["null"]).numpy()
    got_i = KT.seg_sum(T["i"], T["ids"], k, T["rv"], T["null"]).numpy()
    got_c = KT.seg_count(T["ids"], k, T["rv"], T["null"]).numpy()

    assert got_f.dtype == want_f.dtype == np.float32
    assert np.allclose(got_f, want_f, rtol=1e-5)
    assert got_i.dtype == want_i.dtype == np.int64 and np.array_equal(got_i, want_i)
    assert got_c.dtype == want_c.dtype == np.int64 and np.array_equal(got_c, want_c)


def test_seg_sum_large_k_uses_index_add_and_matches():
    """Above MASKED_SEG_K the port scatters with index_add_ (no kernel): same
    answers as kernels_jax's segment_sum."""
    rng = np.random.default_rng(5)
    n, k = 4000, 100
    ids = rng.integers(0, k + 1, n).astype(np.int64)
    rv = rng.random(n) < 0.9
    vals = rng.integers(-1000, 1000, n).astype(np.int64)
    want = np.asarray(KJ.seg_sum(jnp.asarray(vals), jnp.asarray(ids), k, jnp.asarray(rv), None))
    got = KT.seg_sum(torch.from_numpy(vals), torch.from_numpy(ids), k,
                     torch.from_numpy(rv), None).numpy()
    assert got.dtype == np.int64 and np.array_equal(got, want)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor runs the plain version; any other device launches
    the kernel or raises — here a meta tensor, which has no kernel."""
    t = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        GS.grouped_sums(t, t, torch.zeros(8, dtype=torch.bool, device="meta"), 4)
