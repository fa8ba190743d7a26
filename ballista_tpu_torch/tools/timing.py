"""Timing of device work on a CUDA card, shared by ``chip_smoke.py`` and the
kernel comparisons in this package.

``time_cuda`` gives the device's time for a callable, with the L2 flushed
before each call and the host's dispatch kept out of the timed window;
``host_ms`` gives the host's dispatch time alone.
"""
from __future__ import annotations

import time

import numpy as np
import torch

L2_FLUSH_BYTES = 256 * 1024 * 1024  # 5x the H100's 50 MB L2
# the spin ahead of each timed call: about 2 ms at the H100's 1.98 GHz, more
# than the host needs to enqueue one kernel call
SPIN_CYCLES = 4_000_000


def time_cuda(fn, reps: int = 20, spin_cycles: int = SPIN_CYCLES) -> float:
    """Median milliseconds of ``fn`` on the card, with the L2 flushed before
    each call. A spin kernel queued ahead of the start event keeps the card
    busy while the host enqueues ``fn``, so the time is the device's alone,
    without the host's dispatch of ``fn`` (``host_ms`` measures that); give
    ``fn`` that enqueues many launches a longer spin."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, reps: int = 20) -> float:
    """Median milliseconds the host spends in ``fn`` (dispatch only: the
    card is not waited for)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))
