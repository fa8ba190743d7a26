"""grouped_sums against an earlier version of its CUDA source, on one card,
in one process and one timing harness (``tools/timing.py``).

    git show <commit>:ballista_tpu_torch/csrc/grouped_sums.cu > <dir>/grouped_sums.cu
    python3 -m ballista_tpu_torch.tools.grouped_sums_ab --earlier <dir>/grouped_sums.cu

The earlier source is the one-column kernel with the C interface
``grouped_sums_blocks(n)`` and ``grouped_sums_i64(vals, ids, valid, n, k,
partials, out, stream)``, whose caller made one call per column. Timed, in
the order earlier, current, current, earlier (the card's clocks drift over a
run):

* ``one_column``: one int64 column at (2^21 rows, k = 12), one call each;
* ``q1_stage``: q1's partial stage at SF1 (2^21 rows, k = 12; 7 int64 sums
  and 9 counts over one mask). Earlier: 16 one-column calls on inputs
  prepared outside the timing (``earlier_kernels``), and the same 16 calls
  with the elementwise passes its caller made before each (a masked copy of
  each sum's values, an int64 copy of the mask for each count;
  ``earlier_as_called``). Current: one call of 8 columns (the 9 counts are
  one column).

And, with the current source only, a stage of 16 int64 columns at k = 32:
the wrapper's split into launches of at most ``grouped_sums_max_columns``
columns, against all 16 in one launch of smaller blocks (``wide_k32``).

Every result is checked against the plain version first. Prints one JSON
line with the times in ms and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch


def build_earlier(path: str):
    from ballista_tpu_torch.ops import cuda_build

    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(cuda_build.BUILD_DIR, f"libgrouped_sums_earlier-{digest}.so")
    if not os.path.exists(out):
        subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", out, path],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    ptr = ctypes.c_void_p
    lib.grouped_sums_blocks.argtypes = [ctypes.c_longlong]
    lib.grouped_sums_blocks.restype = ctypes.c_int
    lib.grouped_sums_i64.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr,
                                     ptr]
    lib.grouped_sums_i64.restype = ctypes.c_int
    return lib


def earlier_call(lib, vals, ids, valid, k):
    """One call of the earlier kernel as its wrapper made it: partials and
    out allocated per call, two launches on the current stream."""
    n = vals.shape[0]
    partials = torch.empty(lib.grouped_sums_blocks(n) * k, dtype=vals.dtype, device=vals.device)
    out = torch.empty(k, dtype=vals.dtype, device=vals.device)
    err = lib.grouped_sums_i64(vals.data_ptr(), ids.data_ptr(), valid.data_ptr(), n, k,
                               partials.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"earlier grouped_sums: CUDA error {err}")
    return out


def inputs(n: int, k: int, nsums: int, seed: int):
    """ids with trash (-1, k, k + 5), one mask, nsums int64 value columns."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, k, n).astype(np.int64)
    trash = rng.random(n) < 0.1
    ids[trash] = rng.choice(np.array([-1, k, k + 5]), int(trash.sum()))
    valid = rng.random(n) < 0.8
    vals = [rng.integers(-(10**12), 10**12, n).astype(np.int64) for _ in range(nsums)]
    to = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    return to(ids), to(valid), [to(v) for v in vals]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True, help="an earlier grouped_sums.cu")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("grouped_sums_ab: CUDA is not available", file=sys.stderr)
        return 2

    import ballista_tpu_torch.ops.grouped_sums as GS
    from ballista_tpu_torch.tools.timing import SPIN_CYCLES, time_cuda

    old = build_earlier(args.earlier)
    GS._library()
    n, k = 1 << 21, 12
    ids, valid, vals = inputs(n, k, 7, 7)
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    masked = [torch.where(valid, v, zero) for v in vals]
    count_col = valid.to(torch.int64)

    # every result against the plain version before any timing
    for v in (vals[0], count_col):
        want = GS.grouped_sums_ref(v, ids, valid, k)
        if not (torch.equal(earlier_call(old, v, ids, valid, k), want)
                and torch.equal(GS.grouped_sums(v, ids, valid, k), want)):
            raise AssertionError("a kernel disagrees with the plain version")
    stage_cols = vals + [None]
    stage_want = GS.grouped_sums_multi_ref(stage_cols, [valid] * 8, ids, k)
    if not torch.equal(GS.grouped_sums_multi(stage_cols, [valid] * 8, ids, k), stage_want):
        raise AssertionError("the stage call disagrees with the plain version")

    def earlier_kernels():
        for v in masked:
            earlier_call(old, v, ids, valid, k)
        for _ in range(9):
            earlier_call(old, count_col, ids, valid, k)

    def earlier_as_called():
        for v in vals:
            earlier_call(old, torch.where(valid, v, zero), ids, valid, k)
        for _ in range(9):
            earlier_call(old, valid.to(torch.int64), ids, valid, k)

    runs = {
        "one_column": {
            "earlier": lambda: earlier_call(old, vals[0], ids, valid, k),
            "current": lambda: GS.grouped_sums(vals[0], ids, valid, k),
        },
        "q1_stage": {
            "earlier_kernels": earlier_kernels,
            "earlier_as_called": earlier_as_called,
            "current": lambda: GS.grouped_sums_multi(stage_cols, [valid] * 8, ids, k),
        },
    }
    # 16 calls and their elementwise passes take the host longer to enqueue
    # than one call: a spin long enough to cover them
    spin = {"one_column": SPIN_CYCLES, "q1_stage": 8 * SPIN_CYCLES}
    out: dict = {}
    for shape, fns in runs.items():
        names = list(fns)
        order = names + names[::-1]  # earlier ..., current, current, ... earlier
        times: dict = {name: [] for name in names}
        for name in order:
            times[name].append(time_cuda(fns[name], reps=args.reps, spin_cycles=spin[shape]))
        out[shape] = times

    # a stage wider than one launch takes: the wrapper's split, against one
    # launch of all 16 columns (the launcher takes it in smaller blocks)
    wk = 32
    w_ids, w_valid, w_vals = inputs(n, wk, 15, 9)
    w_cols = w_vals + [None]
    w_want = GS.grouped_sums_multi_ref(w_cols, [w_valid] * 16, w_ids, wk)
    ws = GS._workspace(w_ids.device, torch.cuda.current_stream().cuda_stream)

    def one_launch():
        res = torch.empty((16, wk), dtype=torch.int64, device="cuda")
        vp = (ctypes.c_void_p * 16)(*[None if v is None else v.data_ptr() for v in w_cols])
        mp = (ctypes.c_void_p * 16)(*[w_valid.data_ptr()] * 16)
        rows = (ctypes.c_int * 16)(*range(16))
        err = GS._library().grouped_sums_launch(
            0, 16, vp, mp, rows, w_ids.data_ptr(), n, wk, ws.data_ptr(), ws.numel(),
            res.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"grouped_sums: CUDA error {err}")
        return res

    split = lambda: GS.grouped_sums_multi(w_cols, [w_valid] * 16, w_ids, wk)  # noqa: E731
    if not (torch.equal(one_launch(), w_want) and torch.equal(split(), w_want)):
        raise AssertionError("a wide call disagrees with the plain version")
    before = GS.launches
    split()
    wide: dict = {"split_launches": GS.launches - before, "split": [], "one_launch": []}
    for name, fn in (("split", split), ("one_launch", one_launch), ("one_launch", one_launch),
                     ("split", split)):
        wide[name].append(time_cuda(fn, reps=args.reps))
    out["wide_k32"] = wide
    print(json.dumps({"grouped_sums_ab": out, "card": card_line(), "reps": args.reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
