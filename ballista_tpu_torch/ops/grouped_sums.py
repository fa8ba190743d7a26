"""grouped_sums: small-group segment sums, a hand-written CUDA kernel.

``out[c, g] = sum(vals[c][i])`` over the rows with ``masks[c][i]`` and
``ids[i] == g``, for ``g`` in ``[0, k)``, ``k <= 32``, for several columns
over one ``ids`` array in one launch; rows whose id lies outside ``[0, k)``
are dropped. A column is a value column (int64 or float32) or a count
(``None``: adds 1 per row, so no int64 column of ones is ever made). The
device aggregates (``kernels_torch.SegSums``) gather every small-k sum and
count of an aggregate stage into one call per accumulator type. A call is one
launch when its columns fit one (``grouped_sums_max_columns`` in the CUDA
source: the per-thread slots bound them; on an H100, 17 int64 columns at
k = 12 and 6 at k = 32); a wider call is split into launches of at most that
many columns, the columns of one mask together (``column_chunks``).

Replaces the Pallas TPU kernel ``ballista_tpu/ops/pallas_kernels.py:
grouped_sums``. The CUDA source (``csrc/grouped_sums.cu``) carries the design:
warp tiles whose every load is one unbroken run (ids and int64 values 16
bytes a lane), per-thread accumulator slots in shared memory indexed by the
row's id (one add per row and column, whatever k and the column count), and
a fixed-order fold across threads and blocks in the same launch — no atomics
on the sums, so float results are the same on every run. It is
memory-bound: it must read ``ids`` once (8 B/row), each distinct mask once
(1 B/row) and each value column once (8 or 4 B/row).

On CPU tensors the wrappers run the plain version, ``grouped_sums_multi_ref``
(``grouped_sums_ref`` per column, stacked); on CUDA tensors they launch the
kernel or raise. The module-level integer ``launches`` counts the launches.
A warm run (``engine/compile_service.py``) calls them inside ``warming()``:
its launches count in ``warm_launches`` only, never in ``launches`` or in a
thread's record, so the counts of real stages stay what their stages did.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Sequence

import torch

MAX_GROUPS = 32
# per-device (and stream) scratch: a 16-byte blocks-done counter, then the
# per-block partials; the kernel cuts its grid to what this holds
WORKSPACE_BYTES = 1 << 20

# kernel launches since the count was last set to 0; executors' task threads
# launch concurrently, so each increment holds the lock
launches = 0
_launches_lock = threading.Lock()
# the launches of warm runs, apart from ``launches``
warm_launches = 0
# each thread's record of its calls, the launches they took and its calls
# by shape (an executor reports a task's share; a mesh program adds its
# shard threads' records to its caller's)
_thread = threading.local()


def thread_record() -> dict:
    """What this thread has called so far, and what was added to it:
    ``{"calls": n, "launches": n, "shapes": {(rows, k, columns, dtype):
    calls}}``; ``launches`` and ``shapes`` count the calls on a card only."""
    return {"calls": getattr(_thread, "calls", 0), "launches": getattr(_thread, "launches", 0),
            "shapes": dict(getattr(_thread, "shapes", {}))}


def record_since(before: dict) -> dict:
    """This thread's record less ``before``, an earlier ``thread_record()``."""
    now = thread_record()
    shapes = {key: n - before["shapes"].get(key, 0) for key, n in now["shapes"].items()}
    return {"calls": now["calls"] - before["calls"],
            "launches": now["launches"] - before["launches"],
            "shapes": {key: n for key, n in shapes.items() if n}}


def add_to_thread_record(record: dict) -> None:
    """Adds a record of calls made on other threads for this thread's work
    (a mesh program's shards)."""
    _thread.calls = getattr(_thread, "calls", 0) + record["calls"]
    _thread.launches = getattr(_thread, "launches", 0) + record["launches"]
    shapes = getattr(_thread, "shapes", {})
    for key, n in record["shapes"].items():
        shapes[key] = shapes.get(key, 0) + n
    _thread.shapes = shapes



@contextlib.contextmanager
def warming():
    """Counts this thread's calls inside the block as a warm run's: their
    launches add to ``warm_launches`` alone."""
    prev = getattr(_thread, "warming", False)
    _thread.warming = True
    try:
        yield
    finally:
        _thread.warming = prev


def is_warming() -> bool:
    """Whether this thread is inside ``warming()``."""
    return getattr(_thread, "warming", False)


_lib = None
_workspaces: dict = {}
# (device index, float32?, k) -> the most columns one launch takes
_max_columns: dict = {}


def _library():
    global _lib
    if _lib is None:
        from ballista_tpu_torch.ops import cuda_build

        lib = cuda_build.load("grouped_sums")
        ptr = ctypes.c_void_p
        lib.grouped_sums_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
            ptr, ctypes.c_longlong, ptr, ptr,
        ]
        lib.grouped_sums_launch.restype = ctypes.c_int
        lib.grouped_sums_max_columns.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.grouped_sums_max_columns.restype = ctypes.c_int
        _lib = lib
    return _lib


def _workspace(device: torch.device, stream: int) -> torch.Tensor:
    """The reused scratch of one device and stream; made zeroed once (the
    kernel leaves its counter at 0 after every launch)."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = torch.zeros(WORKSPACE_BYTES, dtype=torch.uint8, device=device)
    return ws


def _columns_per_launch(lib, device: torch.device, is_f32: int, k: int) -> int:
    """The kernel's own limit, asked once per device, type and k (the
    current device must be ``device``)."""
    key = (device.index, is_f32, k)
    limit = _max_columns.get(key)
    if limit is None:
        limit = lib.grouped_sums_max_columns(is_f32, k)
        if limit < 1:
            raise RuntimeError(f"grouped_sums: column limit query failed with CUDA error {-limit}")
        _max_columns[key] = limit
    return limit


def column_chunks(keys: Sequence[int], limit: int) -> list:
    """Splits columns ``0 .. len(keys) - 1``, whose mask keys come with equal
    ones adjacent, into consecutive chunks of at most ``limit`` columns. A
    mask's columns share a chunk (so one launch reads that mask once) unless
    they are more than ``limit``; then they fill whole chunks in turn."""
    chunks: list = []
    cur: list = []
    start = 0
    while start < len(keys):
        end = start
        while end < len(keys) and keys[end] == keys[start]:
            end += 1
        if cur and len(cur) + end - start > limit:
            chunks.append(cur)
            cur = []
        for c in range(start, end):
            if len(cur) == limit:
                chunks.append(cur)
                cur = []
            cur.append(c)
        start = end
    if cur:
        chunks.append(cur)
    return chunks


def grouped_sums_ref(vals: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                     k: int) -> torch.Tensor:
    """The plain version of one column: a one-hot ``(k, n)`` masked sum,
    accumulated in the Pallas kernel's types (f32 for floats, int64 for
    ints)."""
    acc = torch.float32 if vals.is_floating_point() else torch.int64
    v = torch.where(valid, vals.to(acc), torch.zeros((), dtype=acc, device=vals.device))
    groups = torch.arange(k, dtype=ids.dtype, device=ids.device)
    onehot = groups[:, None] == ids[None, :]
    zero = torch.zeros((), dtype=acc, device=vals.device)
    return torch.where(onehot, v[None, :], zero).sum(dim=1, dtype=acc)


def _out_dtype(vals: Sequence[Optional[torch.Tensor]]) -> torch.dtype:
    types = {torch.int64 if v is None else v.dtype for v in vals}
    if len(types) != 1 or not types <= {torch.int64, torch.float32}:
        raise TypeError("grouped_sums: one call sums int64 values and counts, or float32 "
                        f"values only; got {sorted(str(t) for t in types)}")
    return types.pop()


def grouped_sums_multi_ref(vals: Sequence[Optional[torch.Tensor]],
                           masks: Sequence[torch.Tensor], ids: torch.Tensor,
                           k: int) -> torch.Tensor:
    """The plain version: ``grouped_sums_ref`` of each column, stacked
    (a count sums its mask as int64)."""
    dtype = _out_dtype(vals)
    rows = [grouped_sums_ref(m.to(torch.int64) if v is None else v, ids, m, k)
            for v, m in zip(vals, masks)]
    return torch.stack(rows) if rows else torch.zeros((0, k), dtype=dtype, device=ids.device)


def grouped_sums_multi(vals: Sequence[Optional[torch.Tensor]], masks: Sequence[torch.Tensor],
                       ids: torch.Tensor, k: int) -> torch.Tensor:
    """``[C, k]`` sums of ``C`` columns: ``vals[c]`` (or a count where it is
    ``None``) over the rows of ``masks[c]``, grouped by ``ids``. All value
    columns are int64 (counts allowed) or all float32 (no counts); ``ids``
    is int64, the masks bool, all 1-D of one length. One launch, or one per
    ``column_chunks`` chunk where the columns exceed what a launch takes."""
    global launches, warm_launches
    if len(vals) != len(masks):
        raise ValueError(f"grouped_sums: {len(vals)} columns but {len(masks)} masks")
    warm = is_warming()
    if ids.device.type == "cpu":
        if not warm:
            _thread.calls = getattr(_thread, "calls", 0) + 1
        return grouped_sums_multi_ref(vals, masks, ids, k)
    if ids.device.type != "cuda":
        raise ValueError(f"grouped_sums: no kernel for device {ids.device}")
    if not 0 < k <= MAX_GROUPS:
        raise ValueError(f"grouped_sums: k={k} outside [1, {MAX_GROUPS}]")
    if not vals:
        raise ValueError("grouped_sums: no columns")
    dtype = _out_dtype(vals)
    if ids.dtype != torch.int64:
        raise TypeError(f"grouped_sums: ids must be int64, got {ids.dtype}")
    n = ids.shape[0]
    named = [("ids", ids)] + [(f"masks[{c}]", m) for c, m in enumerate(masks)] + \
        [(f"vals[{c}]", v) for c, v in enumerate(vals) if v is not None]
    for name, t in named:
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"grouped_sums: {name} must be 1-D of length {n}")
        if t.device != ids.device:
            raise ValueError(f"grouped_sums: {name} lies on {t.device}, ids on {ids.device}")
        if not t.is_contiguous():
            raise ValueError(f"grouped_sums: {name} must be contiguous")
    if any(m.dtype != torch.bool for m in masks):
        raise TypeError("grouped_sums: masks must be bool")
    if dtype == torch.float32 and any(v is None for v in vals):
        raise TypeError("grouped_sums: counts are int64; they cannot join a float32 call")

    if not warm:
        _thread.calls = getattr(_thread, "calls", 0) + 1
        shapes = getattr(_thread, "shapes", {})
        key = (int(n), int(k), len(vals), dtype)
        shapes[key] = shapes.get(key, 0) + 1
        _thread.shapes = shapes

    # columns with one mask side by side, so a launch reads that mask once
    first: dict = {}
    order = sorted(range(len(vals)), key=lambda c: first.setdefault(masks[c].data_ptr(), c))
    out = torch.empty((len(vals), k), dtype=dtype, device=ids.device)
    is_f32 = int(dtype == torch.float32)
    lib = _library()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        ws = _workspace(ids.device, stream)
        limit = _columns_per_launch(lib, ids.device, is_f32, k)
        for chunk in column_chunks([masks[c].data_ptr() for c in order], limit):
            cols = [order[i] for i in chunk]
            vp = (ctypes.c_void_p * len(cols))(*[
                None if vals[c] is None else vals[c].data_ptr() for c in cols])
            mp = (ctypes.c_void_p * len(cols))(*[masks[c].data_ptr() for c in cols])
            rows = (ctypes.c_int * len(cols))(*cols)
            err = lib.grouped_sums_launch(is_f32, len(cols), vp, mp, rows, ids.data_ptr(), n,
                                          k, ws.data_ptr(), ws.numel(), out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"grouped_sums: kernel launch failed with CUDA error {err}")
            with _launches_lock:
                if warm:
                    warm_launches += 1
                else:
                    launches += 1
            if not warm:
                _thread.launches = getattr(_thread, "launches", 0) + 1
    return out


def grouped_sums(vals: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor,
                 k: int) -> torch.Tensor:
    """``[k]`` sums of one column: the one-column call of the same kernel
    (int64 for int64 ``vals``, float32 for float32 ``vals``)."""
    if vals.device.type == "cpu":
        return grouped_sums_ref(vals, ids, valid, k)
    if vals.dtype not in (torch.int64, torch.float32):
        raise TypeError(f"grouped_sums: vals must be int64 or float32, got {vals.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"grouped_sums: valid must be bool, got {valid.dtype}")
    return grouped_sums_multi([vals], [valid], ids, k)[0]
