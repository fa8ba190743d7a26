"""Scheduler self-profiler: wall-clock sampling over ``sys._current_frames``.

The ROADMAP claims the single Python scheduler saturates the GIL before the
executors do; this turns that claim into a measured artifact. A daemon
thread periodically snapshots every thread's stack, folds it into
collapsed-flamegraph lines (``subsystem;outer;...;inner N``), and the REST
endpoint ``GET /api/profile?seconds=N`` serves the aggregate — paste
straight into speedscope / flamegraph.pl.

Attribution: each sample is rooted at the sampled thread's *subsystem*,
derived from its thread name (grpc handler pool, planner pool, push
launcher, event loops, REST API, expiry sweep, KV service). That keeps the
>=90%-of-wall-time attribution contract even when stacks bottom out in
opaque frames (C extensions, ``wait`` primitives).

Overhead guard: sampling is opt-in (``ballista.obs.profiler``), the rate is
capped, and if one sweep costs more than half the sample interval the
profiler doubles its interval and counts a throttle instead of stealing
scheduler time — the recorder must never become the hot path it measures.
"""
from __future__ import annotations

import re
import sys
import threading
import time
from collections import Counter
from typing import Optional

MAX_HZ = 200.0
MAX_STACK_DEPTH = 48

# thread-name prefix -> subsystem root for folded stacks. Order matters:
# first prefix match wins, so more specific entries go first.
_SUBSYSTEMS: tuple[tuple[str, str], ...] = (
    ("kv-grpc", "kv-service"),
    ("kv-watch", "kv-service"),
    ("kv-events", "kv-service"),
    ("etcd-", "kv-service"),
    ("grpc", "grpc-handlers"),
    ("planner", "planner"),
    ("launcher", "push-launcher"),
    ("evloop-", "event-loop"),
    ("rest-api", "rest-api"),
    ("expiry", "expiry"),
    ("flight-sql", "flight-sql"),
    ("obs-sampler", "obs"),
    ("MainThread", "main"),
    # executor/shuffle threads: in a dedicated scheduler process these never
    # appear, but standalone mode runs executors in-process and their wall
    # time must still be attributed (the >=90% contract holds there too)
    ("exec-grpc", "executor-grpc"),
    ("task", "executor-tasks"),
    ("poll-loop", "executor-poll"),
    ("heartbeat", "executor-heartbeat"),
    ("ttl-clean", "executor-ttl"),
    ("flight-server", "shuffle-flight"),
    ("shuffle-", "shuffle-io"),
    ("aot-compile", "compile-service"),
)

# Threads created without an explicit name get Python's default
# "Thread-N (target)" (3.10+). grpcio's completion-queue drain loop
# (`_serve`) and client channel spin threads are spawned that way, and in an
# idle scheduler the drain loop dominates wall time — without this fallback
# it lands in "other" and breaks the >=90% attribution contract.
_DEFAULT_NAME_TARGETS: dict[str, str] = {
    "_serve": "grpc-server",
    "channel_spin": "grpc-client",
}

_DEFAULT_NAME_RE = re.compile(r"^(?:Thread|Dummy)-\d+ \((.+)\)$")


def subsystem_for(thread_name: str) -> str:
    for prefix, subsystem in _SUBSYSTEMS:
        if thread_name.startswith(prefix):
            return subsystem
    m = _DEFAULT_NAME_RE.match(thread_name)
    if m:
        return _DEFAULT_NAME_TARGETS.get(m.group(1), "other")
    return "other"


def fold_frame(frame) -> str:
    code = frame.f_code
    fname = code.co_filename
    # keep paths short: last two components locate any file in this repo
    parts = fname.replace("\\", "/").rsplit("/", 2)
    short = "/".join(parts[-2:]) if len(parts) > 1 else fname
    return f"{code.co_name} ({short}:{frame.f_lineno})"


def fold_stack(frame, subsystem: str) -> str:
    frames = []
    while frame is not None and len(frames) < MAX_STACK_DEPTH:
        frames.append(fold_frame(frame))
        frame = frame.f_back
    frames.reverse()  # root-first, flamegraph convention
    return ";".join([subsystem] + frames)


class SamplingProfiler:
    """Background wall-clock sampler with a self-throttling overhead guard."""

    def __init__(self, hz: float = 67.0, ignore_self: bool = True):
        self.hz = min(MAX_HZ, max(1.0, float(hz)))
        self.ignore_self = ignore_self
        self._stacks: Counter = Counter()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples = 0  # sweeps taken (each sweep samples every thread)
        self.throttles = 0  # times the overhead guard widened the interval
        self.started_at: Optional[float] = None

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stop.clear()
        self.started_at = time.time()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="obs-profiler"
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    def _run(self) -> None:
        interval = 1.0 / self.hz
        my_ident = threading.get_ident()
        while not self._stop.wait(interval):
            t0 = time.perf_counter()
            self.sample_once(skip_ident=my_ident if self.ignore_self else None)
            interval = self._tick_interval(interval, time.perf_counter() - t0)

    def _tick_interval(self, base_interval: float, cost: float) -> float:
        """Overhead guard: a sweep that eats >50% of the interval means the
        profiler is stealing meaningful scheduler time — back off 2x (capped
        at 1 s) and count the throttle."""
        if cost > 0.5 * base_interval:
            self.throttles += 1
            return min(1.0, base_interval * 2.0)
        return base_interval

    def sample_once(self, skip_ident: Optional[int] = None) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        folded = []
        for ident, frame in frames.items():
            if skip_ident is not None and ident == skip_ident:
                continue
            name = names.get(ident, f"tid-{ident}")
            folded.append(fold_stack(frame, subsystem_for(name)))
        with self._lock:
            for line in folded:
                self._stacks[line] += 1
            self.samples += 1

    def collapsed(self, reset: bool = False) -> str:
        """Aggregate in collapsed-flamegraph text form, one stack per line."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: (-kv[1], kv[0]))
            if reset:
                self._stacks.clear()
        return "\n".join(f"{stack} {n}" for stack, n in items)

    def subsystem_totals(self) -> dict:
        """Samples attributed per subsystem root (first folded segment)."""
        totals: Counter = Counter()
        with self._lock:
            for stack, n in self._stacks.items():
                totals[stack.split(";", 1)[0]] += n
        return dict(totals)

    def stats(self) -> dict:
        return {
            "running": self.running,
            "hz": self.hz,
            "samples": self.samples,
            "throttles": self.throttles,
            "started_at": self.started_at,
        }


def profile_for(seconds: float, hz: float = 67.0) -> str:
    """One-shot profile: sample for ``seconds`` and return collapsed stacks.
    Blocks the calling thread (fine for a REST handler thread)."""
    p = SamplingProfiler(hz=hz)
    p.start()
    try:
        time.sleep(max(0.0, min(60.0, seconds)))
    finally:
        p.stop()
    return p.collapsed()
