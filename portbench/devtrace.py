"""What the harness reads off the card: the device trace of a window,
reduced (``torch.profiler`` with CUDA activity, read as intervals), and the
allocator's peak over a process (``PeakWatch``).

``Tracer`` starts the profiler at the window's start and stops it at its end
(after a synchronize). ``reduce`` turns its events into what the metrics
read: the union of device intervals (kernels, copies, sets), the time per
kernel name, the busiest device operations and the longest idle gaps, each
gap named by the innermost host event (an operator, or a query label the
harness put around each query with ``record_function``) that spans its
middle. Timestamps are the profiler's, in nanoseconds.
"""
from __future__ import annotations

import time

TOP = 10


def _events(prof) -> list:
    """(name, is_device, start_ns, end_ns) of every event the profiler kept."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = int(e.start_ns())
        # a record_function label is mirrored on the device's timeline as a
        # user annotation spanning its kernels: it is no device work
        on_device = e.device_type().name != "CPU" and not e.is_user_annotation()
        out.append((e.name(), on_device, start, start + int(e.duration_ns())))
    return out


class Tracer:
    """The profiler over one window, on this process's card."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.start_ns = self.end_ns = 0

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self._prof.start()
        self.start_ns = time.time_ns()

    def stop(self) -> dict:
        self._torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        self._prof.stop()
        return {"start_ns": self.start_ns, "end_ns": self.end_ns,
                "events": _events(self._prof)}


class PeakWatch:
    """The allocator's peak over a whole process: the engine resets it at
    every device stage, so each reset first folds it into ``peak``."""

    def __init__(self, on_card: bool):
        import torch

        self.cuda, self.on_card, self.peak = torch.cuda, on_card, 0
        self._real = torch.cuda.reset_peak_memory_stats

        def reset(dev=None):
            self._fold(dev)
            return self._real(dev)

        torch.cuda.reset_peak_memory_stats = reset

    def _fold(self, dev=None) -> None:
        if self.on_card and self.cuda.is_initialized():
            self.peak = max(self.peak, int(self.cuda.max_memory_allocated(dev)))

    def read(self) -> int:
        self._fold()
        return self.peak

    def remove(self) -> None:
        self.cuda.reset_peak_memory_stats = self._real


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) pairs."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(trace: dict, labels: tuple = ("portbench.",)) -> dict:
    """The reduction of one window's trace: device time is the union of the
    device intervals inside the window."""
    start, end = trace["start_ns"], trace["end_ns"]
    device, host, by_name = [], [], {}
    for name, on_device, a, b in trace["events"]:
        a, b = max(a, start), min(b, end)
        if b <= a:
            continue
        if on_device:
            if name.startswith(labels):
                continue
            device.append((a, b))
            by_name[name] = by_name.get(name, 0) + (b - a)
        else:
            host.append((name, a, b))
    busy = merge(device)
    busy_ns = sum(b - a for a, b in busy)
    edges = [start] + [x for iv in busy for x in iv] + [end]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    named_gaps = [[_host_at(host, (a + b) // 2, labels), g / 1e9] for g, a, b in gaps[:TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_ns / 1e9, "window_s": (end - start) / 1e9,
            "kernels_s": {k: v / 1e9 for k, v in by_name.items()},
            "device_ops": [[short(k), v / 1e9] for k, v in top], "idle_gaps": named_gaps}


def short(name: str, limit: int = 160) -> str:
    """A kernel's name without ``void`` and its argument list."""
    name = name[5:] if name.startswith("void ") else name
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:limit]


def _host_at(host: list, t: int, labels: tuple) -> str:
    """What the host was doing at ``t``: the label the harness set (the
    query), and the innermost host event over ``t``, or else the last one
    that ended before it (a gap often follows a synchronising call)."""
    inner, label, before = None, None, None
    for name, a, b in host:
        if a <= t < b:
            if name.startswith(labels):
                if label is None or b - a < label[1] - label[0]:
                    label = (a, b, name)
            elif inner is None or b - a < inner[1] - inner[0]:
                inner = (a, b, name)
        elif b <= t and not name.startswith(labels) and (before is None or b > before[1]):
            before = (a, b, name)
    parts = [label[2]] if label else []
    if inner:
        parts.append(inner[2])
    elif before:
        parts.append(f"after {before[2]}")
    return " / ".join(parts) if parts else "no host event"
