"""grouped_sums: small-group segment sums, a hand-written CUDA kernel.

``out[g] = sum(vals[i])`` over the rows with ``valid[i]`` and ``ids[i] == g``,
for ``g`` in ``[0, k)``, ``k <= 32``; rows whose id lies outside ``[0, k)`` are
dropped. The device aggregates' ``seg_sum`` and ``seg_count``
(``kernels_torch.py``) call it for every small group count.

Replaces the Pallas TPU kernel ``ballista_tpu/ops/pallas_kernels.py:
grouped_sums``. The CUDA source (``csrc/grouped_sums.cu``) carries the design:
a grid-stride pass that keeps the group accumulators in registers and writes
one row of per-block partials, then a fixed-order pass over the partials — no
atomics, so float results are the same on every run. It is memory-bound: it
must read ``n * (8 + 8 + 1)`` bytes (int64 vals, int64 ids, a bool mask;
``4 + 8 + 1`` for float32 vals), 35.7 MB at n = 2^21, about 10.6 us at the
H100's 3.35 TB/s.

On a CPU tensor the wrapper runs the plain version, ``grouped_sums_ref``; on
a CUDA tensor it launches the kernel or raises. The module-level integer
``launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

MAX_GROUPS = 32

# kernel launches since the count was last set to 0
launches = 0

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ballista_tpu_torch.ops import cuda_build

        lib = cuda_build.load("grouped_sums")
        ptr = ctypes.c_void_p
        lib.grouped_sums_blocks.argtypes = [ctypes.c_longlong]
        lib.grouped_sums_blocks.restype = ctypes.c_int
        for fn in (lib.grouped_sums_i64, lib.grouped_sums_f32):
            fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr, ptr]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def grouped_sums_ref(vals: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                     k: int) -> torch.Tensor:
    """The plain version: a one-hot ``(k, n)`` masked sum, accumulated in the
    Pallas kernel's types (f32 for floats, int64 for ints)."""
    acc = torch.float32 if vals.is_floating_point() else torch.int64
    v = torch.where(valid, vals.to(acc), torch.zeros((), dtype=acc, device=vals.device))
    groups = torch.arange(k, dtype=ids.dtype, device=ids.device)
    onehot = groups[:, None] == ids[None, :]
    zero = torch.zeros((), dtype=acc, device=vals.device)
    return torch.where(onehot, v[None, :], zero).sum(dim=1, dtype=acc)


def grouped_sums(vals: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                 k: int) -> torch.Tensor:
    """``[k]`` sums: int64 for int64 ``vals``, float32 for float32 ``vals``.
    ``ids`` is int64, ``valid`` bool, all three 1-D of one length."""
    global launches
    if vals.device.type == "cpu":
        return grouped_sums_ref(vals, ids, valid, k)
    if vals.device.type != "cuda":
        raise ValueError(f"grouped_sums: no kernel for device {vals.device}")
    if not 0 < k <= MAX_GROUPS:
        raise ValueError(f"grouped_sums: k={k} outside [1, {MAX_GROUPS}]")
    if vals.dtype not in (torch.int64, torch.float32):
        raise TypeError(f"grouped_sums: vals must be int64 or float32, got {vals.dtype}")
    if ids.dtype != torch.int64 or valid.dtype != torch.bool:
        raise TypeError(f"grouped_sums: ids int64 and valid bool, got {ids.dtype}, {valid.dtype}")
    n = vals.shape[0]
    for name, t in (("vals", vals), ("ids", ids), ("valid", valid)):
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"grouped_sums: {name} must be 1-D of length {n}")
        if t.device != vals.device:
            raise ValueError(f"grouped_sums: {name} lies on {t.device}, vals on {vals.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_sums: {name} must be contiguous")
    lib = _library()
    nblocks = lib.grouped_sums_blocks(n)
    partials = torch.empty(nblocks * k, dtype=vals.dtype, device=vals.device)
    out = torch.empty(k, dtype=vals.dtype, device=vals.device)
    fn = lib.grouped_sums_i64 if vals.dtype == torch.int64 else lib.grouped_sums_f32
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        err = fn(vals.data_ptr(), ids.data_ptr(), valid.data_ptr(), n, k,
                 partials.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"grouped_sums: kernel launch failed with CUDA error {err}")
    launches += 1
    return out
