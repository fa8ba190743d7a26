"""Lightweight span API: trace ids, an in-process collector, a bounded store.

Zero external dependencies. A span is a plain JSON-serializable dict so it
can ride protobuf ``bytes`` fields and REST responses without a schema:

    {"trace_id", "span_id", "parent_id", "name", "service",
     "start_us", "dur_us", "tid", "attrs": {...}}

``start_us`` is wall-clock epoch microseconds (so spans from different
processes align on one timeline); durations are measured with
``time.perf_counter`` so short spans don't collapse to zero under coarse
wall clocks.

``Phase`` puts a phase of the program's work on ``torch.profiler``'s
timeline as a ``ballista.*`` range while a profiler records (and opens
nothing otherwise), adds its time and count to a counter, and records its
span dict where the call site has one.

Reference analog: per-operator ``MetricsSet`` harvested per task
(datafusion ``collect_plan_metrics`` via ballista's execution_graph), and
the ``trace_id``/``span_id``/parent propagation shape of
OpenTelemetry-instrumented engines (Spark SQL task metrics).
"""
from __future__ import annotations

import hashlib
import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from typing import Optional

# RPC string-map keys carrying trace context (ExecuteQueryParams.settings on
# submit; TaskDefinition/MultiTaskDefinition.props on launch)
TRACE_ID_PROP = "ballista.trace.id"
PARENT_PROP = "ballista.trace.parent"

SERVICES = ("client", "scheduler", "executor", "engine", "shuffle")


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


def stage_span_id(trace_id: str, stage_id: int, attempt: int) -> str:
    """Deterministic span id for a stage attempt: the scheduler (which emits
    the stage span) and the executors (which parent task spans under it)
    derive the same id independently — no extra RPC field needed."""
    return hashlib.sha1(
        f"{trace_id}/stage/{stage_id}/{attempt}".encode()
    ).hexdigest()[:16]


def job_span_id(trace_id: str, job_id: str) -> str:
    return hashlib.sha1(f"{trace_id}/job/{job_id}".encode()).hexdigest()[:16]


def now_us() -> int:
    return int(time.time() * 1e6)


class Span:
    """An open span; closed (and recorded) by the collector's context
    manager, or explicitly via ``finish()``."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "service",
        "start_us", "attrs", "tid", "_t0", "_collector", "_done",
    )

    def __init__(self, collector, name, trace_id, parent_id, service, attrs):
        self._collector = collector
        self.name = name
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.service = service
        self.attrs = dict(attrs or {})
        self.span_id = new_span_id()
        self.start_us = now_us()
        self.tid = threading.get_ident() & 0xFFFF
        self._t0 = time.perf_counter()
        self._done = False

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def finish(self) -> dict:
        if self._done:
            return {}
        self._done = True
        d = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "service": self.service,
            "start_us": self.start_us,
            "dur_us": int((time.perf_counter() - self._t0) * 1e6),
            "tid": self.tid,
            "attrs": self.attrs,
        }
        if self._collector is not None:
            self._collector.add(d)
        return d


# when True, every collector mirrors its spans into the process-global ring
# (GLOBAL) so harnesses can dump "whatever was traced" on failure without
# plumbing collectors around. Off by default: long-lived production
# processes should not hold a duplicate 50k-span ring for a test-only
# feature. tests/conftest.py flips it on; BALLISTA_TRACE_MIRROR=1 does too.
import os as _os

MIRROR_TO_GLOBAL = _os.environ.get("BALLISTA_TRACE_MIRROR", "").lower() in (
    "1", "true", "yes"
)


class SpanCollector:
    """Thread-safe bounded in-process collector of completed spans.

    Ring semantics past ``max_spans``: the OLDEST span is evicted (the
    most recent activity is what failure dumps and timelines need)."""

    def __init__(self, max_spans: int = 20_000, mirror_global: Optional[bool] = None):
        from collections import deque

        self._lock = threading.Lock()
        self._spans: "deque[dict]" = deque(maxlen=max_spans)
        self.max_spans = max_spans
        self.dropped = 0
        # None = follow the module flag at record time (so conftest can flip
        # it after collectors exist)
        self._mirror = mirror_global

    # ---- recording ---------------------------------------------------------------
    def start(
        self,
        name: str,
        *,
        trace_id: str,
        parent_id: Optional[str] = None,
        service: str = "",
        attrs: Optional[dict] = None,
    ) -> Span:
        return Span(self, name, trace_id, parent_id, service, attrs)

    @contextmanager
    def span(self, name: str, *, trace_id, parent_id=None, service="", attrs=None):
        s = self.start(
            name, trace_id=trace_id, parent_id=parent_id, service=service, attrs=attrs
        )
        try:
            yield s
        finally:
            s.finish()

    def add(self, span: dict) -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1  # deque maxlen evicts the oldest
            self._spans.append(span)
        mirror = MIRROR_TO_GLOBAL if self._mirror is None else self._mirror
        if mirror and self is not GLOBAL:
            GLOBAL.add(span)

    def record(
        self, name, *, trace_id, parent_id=None, service="", start_us, dur_us, attrs=None
    ) -> dict:
        """Record an already-measured interval (for call sites that timed the
        work themselves, e.g. the engine's exclusive-time accounting)."""
        d = {
            "trace_id": trace_id,
            "span_id": new_span_id(),
            "parent_id": parent_id,
            "name": name,
            "service": service,
            "start_us": int(start_us),
            "dur_us": max(0, int(dur_us)),
            "tid": threading.get_ident() & 0xFFFF,
            "attrs": dict(attrs or {}),
        }
        self.add(d)
        return d

    # ---- reading -----------------------------------------------------------------
    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> list[dict]:
        with self._lock:
            out = list(self._spans)
            self._spans.clear()
            return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


# process-global ring: every collector mirrors here (bounded); the tier-1
# harness dumps this to benchmarks/results/trace_smoke.json on failure
GLOBAL = SpanCollector(max_spans=50_000, mirror_global=False)


def _span_size(span: dict) -> int:
    """Cheap approximate retained size of one span dict, in bytes. NOT a
    serialization — this runs on the status-report hot path, so it prices
    the fixed dict overhead plus string/attr payloads without json.dumps."""
    size = 200  # dict + fixed keys + small ints
    size += len(span.get("name", "") or "") + len(span.get("service", "") or "")
    attrs = span.get("attrs")
    if attrs:
        for k, v in attrs.items():
            size += 16 + len(k)
            size += len(v) if isinstance(v, str) else 16
    return size


class TraceStore:
    """Bounded per-job retention of completed spans on the scheduler.

    Three independent bounds, so a long-lived scheduler process under
    serving traffic cannot grow trace memory without limit:

    * LRU over jobs — oldest job evicted past ``max_jobs``
      (knob ``ballista.trace.max_jobs``);
    * per-job span count capped at ``max_spans_per_job`` (ring, newest kept:
      the job-envelope spans arrive last and must survive);
    * a global APPROXIMATE byte budget ``max_bytes``
      (knob ``ballista.trace.max_bytes``) — whole least-recently-touched
      jobs are evicted until under budget.

    Evictions are counted (``evicted_jobs`` / ``evicted_spans``) and
    exported on /api/metrics."""

    def __init__(
        self,
        max_jobs: int = 64,
        max_spans_per_job: int = 50_000,
        max_bytes: int = 64 * 1024 * 1024,
    ):
        self._lock = threading.Lock()
        self._jobs: "OrderedDict[str, object]" = OrderedDict()
        self._bytes: dict[str, int] = {}  # per-job approximate retained bytes
        self.max_jobs = max_jobs
        self.max_spans_per_job = max_spans_per_job
        self.max_bytes = max_bytes
        self.total_bytes = 0
        self.evicted_jobs = 0
        self.evicted_spans = 0

    def _evict_oldest_locked(self) -> None:
        job_id, bucket = self._jobs.popitem(last=False)
        self.total_bytes -= self._bytes.pop(job_id, 0)
        self.evicted_jobs += 1
        self.evicted_spans += len(bucket)

    def add(self, job_id: str, spans: list[dict]) -> None:
        if not spans:
            return
        from collections import deque

        added = sum(_span_size(s) for s in spans)
        with self._lock:
            bucket = self._jobs.get(job_id)
            if bucket is None:
                # ring per job (keep NEWEST): the job-envelope spans — the
                # scheduler job span and the client root via ReportTrace —
                # arrive after the per-operator flood and must survive the cap
                bucket = self._jobs[job_id] = deque(maxlen=self.max_spans_per_job)
                self._bytes[job_id] = 0
                while len(self._jobs) > self.max_jobs:
                    self._evict_oldest_locked()
            self._jobs.move_to_end(job_id)
            overflow = max(0, len(bucket) + len(spans) - self.max_spans_per_job)
            if overflow:
                # deque maxlen drops the oldest silently; count them and
                # re-price the bucket (rare: only runaway queries hit the cap)
                self.evicted_spans += overflow
                bucket.extend(spans)
                priced = sum(_span_size(s) for s in bucket)
                self.total_bytes += priced - self._bytes.get(job_id, 0)
                self._bytes[job_id] = priced
            else:
                bucket.extend(spans)
                self._bytes[job_id] = self._bytes.get(job_id, 0) + added
                self.total_bytes += added
            # byte budget: evict least-recently-touched whole jobs, but keep
            # the job just written even if it alone exceeds the budget
            while self.total_bytes > self.max_bytes and len(self._jobs) > 1:
                self._evict_oldest_locked()

    def get(self, job_id: str) -> list[dict]:
        with self._lock:
            return list(self._jobs.get(job_id, ()))

    def jobs(self) -> list[str]:
        with self._lock:
            return list(self._jobs)

    def stats(self) -> dict:
        with self._lock:
            return {
                "jobs": len(self._jobs),
                "spans": sum(len(b) for b in self._jobs.values()),
                "approx_bytes": self.total_bytes,
                "max_jobs": self.max_jobs,
                "max_bytes": self.max_bytes,
                "evicted_jobs": self.evicted_jobs,
                "evicted_spans": self.evicted_spans,
            }


# ---- ambient (thread-local) trace context ---------------------------------------
# Set by the executor around one task's execution (engine + shuffle writer /
# reader all run on the task thread) and by the client around its result
# fetch, so deep call sites can attach spans without threading a collector
# through every signature. Worker threads spawned by an engine's partition
# pool do NOT inherit it — their spans are simply not recorded, never
# mis-parented under another task.
_tls = threading.local()


class TraceCtx:
    __slots__ = ("collector", "trace_id", "parent_id")

    def __init__(self, collector: SpanCollector, trace_id: str, parent_id: Optional[str]):
        self.collector = collector
        self.trace_id = trace_id
        self.parent_id = parent_id


def set_ambient(collector: SpanCollector, trace_id: str, parent_id: Optional[str]) -> None:
    _tls.ctx = TraceCtx(collector, trace_id, parent_id)


def clear_ambient() -> None:
    _tls.ctx = None


def ambient() -> Optional[TraceCtx]:
    return getattr(_tls, "ctx", None)



# ---- phases: the program's work on the profiler's clock ---------------------------
# torch.autograd.profiler, found once torch is loaded (this module imports no
# torch: the scheduler and the client's remote path use it without one)
_autograd_profiler = None


def profiling() -> bool:
    """Whether ``torch.profiler`` is recording in this process: one flag
    read (False while torch is not loaded)."""
    global _autograd_profiler
    prof = _autograd_profiler
    if prof is None:
        import sys

        prof = sys.modules.get("torch.autograd.profiler")
        if prof is None:
            return False
        _autograd_profiler = prof
    return bool(getattr(prof, "_is_profiler_enabled", False))


class Phase:
    """One phase of the program's work, timed from its start:

    * with ``counter``, its elapsed time and a count are added through
      ``add(key, value)`` under ``<counter>.time_s`` and ``<counter>.count``;
    * while ``torch.profiler`` records, it is the range ``name`` (a
      ``ballista.`` name) on the profiler's timeline, opened when the work
      starts; otherwise no range is opened, so the phase costs a flag read
      and its counter;
    * with ``trace`` (a ``TraceCtx``), it records the engine's span dict
      ``span`` (service ``engine``) with ``attrs``, which the work may fill
      in, over the phase's interval; ``recorded`` is that dict once the
      phase has closed (None untraced).

    A phase whose work raises closes its range and records nothing.
    ``stop()`` ends the timing early and returns the elapsed seconds, for
    attributes that hold them."""

    __slots__ = ("name", "counter", "add", "trace", "span", "attrs", "recorded", "_t0", "_wall0",
                 "_dt", "_range")

    def __init__(self, name: str, counter: Optional[str] = None, add=None,
                 trace: Optional["TraceCtx"] = None, span: Optional[str] = None):
        self.name = name
        self.counter = counter
        self.add = add
        self.trace = trace if span else None
        self.span = span
        self.attrs: dict = {}
        self.recorded: Optional[dict] = None
        self._range = None

    def __enter__(self) -> "Phase":
        if profiling():
            from torch.profiler import record_function

            self._range = record_function(self.name)
            self._range.__enter__()
        self._wall0 = time.time() if self.trace is not None else 0.0
        self._dt = None
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._dt is None:
            self._dt = time.perf_counter() - self._t0
        return self._dt

    def __exit__(self, exc_type, exc, tb) -> bool:
        dt = self.stop()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if exc_type is not None:
            return False
        if self.counter is not None:
            self.add(self.counter + ".time_s", dt)
            self.add(self.counter + ".count", 1.0)
        if self.trace is not None:
            ctx = self.trace
            self.recorded = ctx.collector.record(
                self.span, trace_id=ctx.trace_id, parent_id=ctx.parent_id, service="engine",
                start_us=self._wall0 * 1e6, dur_us=dt * 1e6, attrs=self.attrs,
            )
        return False


@contextmanager
def ambient_span(name: str, service: str, attrs: Optional[dict] = None):
    """Record a span under the ambient context; no-op (yields None) when no
    context is set — instrumented hot paths stay zero-cost untraced."""
    ctx = ambient()
    if ctx is None:
        yield None
        return
    s = ctx.collector.start(
        name, trace_id=ctx.trace_id, parent_id=ctx.parent_id,
        service=service, attrs=attrs,
    )
    try:
        yield s
    finally:
        s.finish()
