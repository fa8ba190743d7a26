"""ctypes bindings for the host shuffle kernels (``partition.cpp``).

Compiled with ``g++`` at first use (plain C ABI, no pybind11) into
``ballista_tpu_torch/_build/`` under a name that carries a hash of the
source, written to a temporary file and moved into place, so processes that
build at once each leave a whole library and an edited source is never served
from a stale one. A failed build raises with the compiler's output: the port
has no quiet numpy fallback (the numpy bodies in ``ops/kernels_np.py`` are
the tests' reference). Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

from ballista_tpu_torch.errors import BallistaError

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "partition.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library_path(src: Optional[str] = None) -> str:
    with open(src or SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libballista_partition-{digest}.so")


def build(src: Optional[str] = None, cxx: str = "g++") -> str:
    """Compile ``src`` (default ``partition.cpp``) unless its library
    exists; returns the library's path. Raises ``BallistaError`` carrying the
    compiler's output on failure."""
    src = src or SRC
    out = library_path(src)
    if os.path.exists(out):
        return out
    compiler = shutil.which(cxx)
    if compiler is None:
        raise BallistaError(f"cannot build {os.path.basename(src)}: no {cxx!r} on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([compiler, *CXX_FLAGS, src, "-o", tmp],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise BallistaError(
            f"{cxx} failed to build {os.path.basename(src)} "
            f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.hash_buckets.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int32, ctypes.c_int64,
                ctypes.c_uint32, ctypes.c_void_p,
            ]
            lib.hash_buckets.restype = None
            lib.partition_order.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.partition_order.restype = None
            _lib = lib
        return _lib


def hash_buckets_native(key_cols: list[np.ndarray], n_buckets: int) -> np.ndarray:
    """int32 bucket id per row of the canonical int64 key columns:
    splitmix64 over the columns in order, then ``% n_buckets``."""
    if not key_cols or n_buckets < 1:
        raise BallistaError(f"hash_buckets: {len(key_cols)} key columns, "
                            f"{n_buckets} buckets")
    lib = get_lib()
    n = len(key_cols[0])
    cols = [np.ascontiguousarray(c, dtype=np.int64) for c in key_cols]
    if any(len(c) != n for c in cols):
        raise BallistaError("hash_buckets: key columns differ in length")
    ptrs = (ctypes.c_void_p * len(cols))(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in cols]
    )
    out = np.empty(n, dtype=np.int32)
    lib.hash_buckets(ptrs, len(cols), n, n_buckets, out.ctypes.data_as(ctypes.c_void_p))
    return out


def partition_order_native(buckets: np.ndarray, n_buckets: int):
    """(order, bounds): a stable permutation grouping rows by bucket, and
    bucket i's rows at ``order[bounds[i]:bounds[i + 1]]``."""
    b = np.ascontiguousarray(buckets, dtype=np.int32)
    if len(b) and (int(b.min()) < 0 or int(b.max()) >= n_buckets):
        raise BallistaError(f"partition_order: a bucket outside [0, {n_buckets})")
    lib = get_lib()
    n = len(b)
    order = np.empty(n, dtype=np.int64)
    bounds = np.empty(n_buckets + 1, dtype=np.int64)
    lib.partition_order(
        b.ctypes.data_as(ctypes.c_void_p), n, n_buckets,
        order.ctypes.data_as(ctypes.c_void_p), bounds.ctypes.data_as(ctypes.c_void_p),
    )
    return order, bounds
