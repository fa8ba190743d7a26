"""The port's host shuffle partitioner (``ballista_tpu_torch/native/``),
held against the JAX package's and against its own numpy version.

- Buckets bit-identical, for every key case (int64, f64, dictionary
  strings, nulls, two- and three-column keys) at 8 and 16 buckets, between
  the port's ``kernels_np.hash_partition_indices`` (the C++ kernel), the
  JAX package's (its native path: the JAX loader must have built) and the
  port's plain numpy ``hash_partition_indices_plain``.
- ``hash_partition``'s pieces equal ``hash_partition_plain``'s row for row.
- The counting sort's bounds and stability (the port's counterpart of
  ``tests/test_native.py::test_partition_order_bounds``).
- Builds: two processes building at once leave one whole, loadable library
  and no temporary file; a failed build raises ``BallistaError`` carrying
  the compiler's error, and a shuffle split over it raises too (no quiet
  numpy fallback).

``_LEFT_OUT`` names the JAX cases not run on the port, each with its reason.
"""
import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pytest

from ballista_tpu import native as JN
from ballista_tpu.ops import kernels_np as JK
from ballista_tpu.ops.batch import ColumnBatch as JaxBatch
from ballista_tpu.plan.expr import Col as JaxCol
from ballista_tpu_torch import native as PN
from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.ops import kernels_np as PK
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan.expr import Col

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_LEFT_OUT = {
    ("test_native.py", "test_native_buckets_match_numpy"):
        "sets native._lib = None to force the JAX loader's numpy fallback, which "
        "the port does not have; test_buckets_equal_the_jax_packages_and_the_plain_"
        "version and test_pieces_equal_the_plain_version hold the same parity",
    ("test_native.py", "test_partition_order_bounds"):
        "skips unless native.available(), the JAX loader's fallback probe; the port's "
        "loader raises instead of reporting, and "
        "test_partition_order_bounds_and_stability runs the same case",
}


def _table(n: int = 5000, seed: int = 5) -> pa.Table:
    rng = np.random.default_rng(seed)
    ints = rng.integers(-(10 ** 12), 10 ** 12, n).astype(np.int64)
    return pa.table({
        "i": pa.array(ints),
        "f": pa.array(np.where(rng.random(n) < 0.05, 0.0, rng.normal(size=n)) * -1.0),
        "s": pa.array([f"key{j % 97}" for j in range(n)]).dictionary_encode(),
        "ni": pa.array(ints % 1000, mask=rng.random(n) < 0.2),
        "ns": pa.array([f"n{j % 13}" for j in range(n)], mask=rng.random(n) < 0.3),
    })


KEYS = (("i",), ("f",), ("s",), ("ni",), ("ns",), ("i", "s"), ("f", "ni"),
        ("s", "ni", "f"), ("ns", "i", "s"))


@pytest.mark.parametrize("n_buckets", [8, 16])
@pytest.mark.parametrize("keys", KEYS, ids=["-".join(k) for k in KEYS])
def test_buckets_equal_the_jax_packages_and_the_plain_version(keys, n_buckets):
    assert JN.available(), "the JAX package's native kernel did not build"
    t = _table()
    port = PK.hash_partition_indices(ColumnBatch.from_arrow(t), [Col(k) for k in keys],
                                     n_buckets)
    plain = PK.hash_partition_indices_plain(ColumnBatch.from_arrow(t), [Col(k) for k in keys],
                                            n_buckets)
    jax = JK.hash_partition_indices(JaxBatch.from_arrow(t), [JaxCol(k) for k in keys],
                                    n_buckets)
    assert port.dtype == plain.dtype == jax.dtype == np.int64
    assert np.array_equal(port, plain) and np.array_equal(port, jax)
    assert 0 <= port.min() and port.max() < n_buckets


@pytest.mark.parametrize("keys", [("i",), ("s", "ni", "f")], ids=["one", "three"])
def test_pieces_equal_the_plain_version(keys):
    batch = ColumnBatch.from_arrow(_table(seed=9))
    got = PK.hash_partition(batch, [Col(k) for k in keys], 16)
    want = PK.hash_partition_plain(batch, [Col(k) for k in keys], 16)
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert g.to_arrow().equals(w.to_arrow())
    assert sum(p.num_rows for p in got) == batch.num_rows
    empty = batch.slice(0, 0)
    assert PK.hash_partition(empty, [Col("i")], 4) == [empty] * 4


def test_partition_order_bounds_and_stability():
    buckets = np.array([2, 0, 1, 2, 0, 2], dtype=np.int32)
    order, bounds = PN.partition_order_native(buckets, 3)
    assert bounds.tolist() == [0, 2, 3, 6]
    assert order.tolist() == [1, 4, 2, 0, 3, 5]
    with pytest.raises(BallistaError, match="outside"):
        PN.partition_order_native(np.array([0, 3], dtype=np.int32), 3)


_BUILD = r"""
import sys, time
sys.path.insert(0, {repo!r})
from ballista_tpu_torch import native
native.BUILD_DIR = {build!r}
time.sleep(max(0.0, {start!r} - time.time()))
print(native.build())
"""


def test_two_processes_building_at_once_leave_one_loadable_library(tmp_path):
    build = str(tmp_path / "build")
    code = _BUILD.format(repo=REPO, build=build, start=time.time() + 2.0)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for _ in range(2)]
    paths = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-4000:]
        paths.append(out.strip())
    assert paths[0] == paths[1]
    assert os.listdir(build) == [os.path.basename(paths[0])]  # no temporary file left
    lib = ctypes.CDLL(paths[0])
    lib.hash_buckets.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32,
                                 ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p]
    keys = np.arange(100, dtype=np.int64)
    ptrs = (ctypes.c_void_p * 1)(keys.ctypes.data)
    out = np.empty(100, dtype=np.int32)
    lib.hash_buckets(ptrs, 1, 100, 7, out.ctypes.data)
    want = PK.splitmix64(keys.view(np.uint64)) % np.uint64(7)
    assert np.array_equal(out, want.astype(np.int32))


def test_a_failed_build_raises_with_the_compilers_error(tmp_path, monkeypatch):
    bad = tmp_path / "partition.cpp"
    bad.write_text("extern \"C\" void hash_buckets( { this is not C++ }\n")
    monkeypatch.setattr(PN, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(BallistaError, match=r"g\+\+ failed to build partition\.cpp") as ei:
        PN.build(str(bad))
    assert "error" in str(ei.value)
    assert not os.path.exists(tmp_path / "build") or not os.listdir(tmp_path / "build")
    # the shuffle split has no quiet fallback either
    monkeypatch.setattr(PN, "SRC", str(bad))
    monkeypatch.setattr(PN, "_lib", None)
    with pytest.raises(BallistaError, match="error"):
        PK.hash_partition(ColumnBatch.from_arrow(_table(50)), [Col("i")], 4)
    with pytest.raises(BallistaError, match="no 'no-such-compiler' on PATH"):
        PN.build(str(bad), cxx="no-such-compiler")
