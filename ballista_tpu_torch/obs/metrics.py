"""Flight recorder: histogram metrics + bounded time series + registry.

Always-on, low-overhead production telemetry in the Google-Wide-Profiling /
Dapper spirit: the control plane measures its own hot paths continuously so
"where does scheduler wall time go" is an artifact, not a guess. Three
pieces:

* ``Histogram`` — fixed log2 buckets (no per-observe allocation, one lock,
  deterministic merge), rendered as a real Prometheus histogram family
  (``_bucket``/``_sum``/``_count`` with cumulative ``le`` edges).
* ``TimeSeries`` — a bounded ring of (ts, value) gauge samples; the
  ``/api/timeseries`` window the UI and the Perfetto counter tracks read.
* ``FlightRecorder`` — the process-wide registry: named histogram families
  (with labels), registered gauges sampled by one background thread, and
  the conformant exposition text for ``/api/metrics``.

Reference analog: the scheduler UI's per-job metric rollups in Ballista
(``scheduler/src/metrics/prometheus.rs``) — extended from flat counters to
latency distributions, which the flat text format cannot express.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

# ---- Prometheus text exposition helpers ------------------------------------------


def escape_label_value(v) -> str:
    """THE label-value escaping helper (Prometheus text exposition format):
    every label value on /api/metrics routes through here — one unescaped
    quote or newline in a client-controlled tenant/executor id would corrupt
    the whole response for every scraper."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class PromText:
    """Conformant exposition builder: every sample's family gets exactly one
    ``# HELP``/``# TYPE`` header, emitted before the family's first sample.
    The flat counters the scheduler always exported render through this now,
    so scrapers see typed families instead of bare lines."""

    def __init__(self):
        self._lines: list[str] = []
        self._seen: set[str] = set()

    def family(self, name: str, mtype: str, help_text: str) -> None:
        if name in self._seen:
            return
        self._seen.add(name)
        self._lines.append(f"# HELP {name} {help_text}")
        self._lines.append(f"# TYPE {name} {mtype}")

    def sample(
        self, name: str, value, labels: Optional[dict] = None, *, suffix: str = ""
    ) -> None:
        self._lines.append(f"{name}{suffix}{fmt_labels(labels)} {_fmt_value(value)}")

    def counter(self, name: str, value, help_text: str, labels=None) -> None:
        self.family(name, "counter", help_text)
        self.sample(name, value, labels)

    def gauge(self, name: str, value, help_text: str, labels=None) -> None:
        self.family(name, "gauge", help_text)
        self.sample(name, value, labels)

    def text(self) -> str:
        return "\n".join(self._lines) + ("\n" if self._lines else "")


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ---- histogram --------------------------------------------------------------------

# one shared edge table per (base, n) — every histogram of a family merges
# bucket-for-bucket because the edges are identical by construction
_EDGE_CACHE: dict[tuple[float, int], tuple[float, ...]] = {}


def log2_edges(base: float, n: int) -> tuple[float, ...]:
    key = (base, n)
    edges = _EDGE_CACHE.get(key)
    if edges is None:
        edges = _EDGE_CACHE[key] = tuple(base * (2.0 ** i) for i in range(n))
    return edges


class Histogram:
    """Fixed log2-bucket histogram.

    Bucket ``i`` is the cumulative-style upper edge ``base * 2**i``; an
    observation lands in the FIRST bucket whose edge is >= the value
    (values above the last edge land in +Inf). With the default
    ``base=1e-6`` (one microsecond) and 40 buckets the top finite edge is
    ~6.4 days — every latency this engine can produce has a finite bucket.

    One uncontended lock per observe (~100ns in CPython): cheap against the
    millisecond-scale paths being measured, and it makes ``merge`` and the
    bucket counts exact — the merge-determinism contract the per-query
    ledger and the timeseries sampler rely on.
    """

    __slots__ = ("base", "n", "edges", "counts", "inf", "sum", "count", "_lock")

    def __init__(self, base: float = 1e-6, buckets: int = 40):
        if base <= 0 or buckets < 1:
            raise ValueError("histogram needs base > 0 and >= 1 bucket")
        self.base = float(base)
        self.n = int(buckets)
        self.edges = log2_edges(self.base, self.n)
        self.counts = [0] * self.n
        self.inf = 0  # observations above the last finite edge
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def bucket_index(self, value: float) -> int:
        """Index of the first edge >= value; ``self.n`` means +Inf."""
        if value <= self.base:
            return 0
        # ceil(value/base) has bit_length b  =>  smallest i with 2^i >= it
        q = -(-value // self.base)  # float ceil-div, no math import
        i = (int(q) - 1).bit_length()
        return i if i < self.n else self.n

    def observe(self, value: float) -> None:
        if value < 0:
            value = 0.0
        i = self.bucket_index(value)
        with self._lock:
            if i >= self.n:
                self.inf += 1
            else:
                self.counts[i] += 1
            self.sum += value
            self.count += 1

    def merge(self, other: "Histogram") -> None:
        """Bucket-exact merge — deterministic regardless of merge order
        because the edge table is shared by construction."""
        if (other.base, other.n) != (self.base, self.n):
            raise ValueError("cannot merge histograms with different buckets")
        with other._lock:
            counts = list(other.counts)
            inf, s, c = other.inf, other.sum, other.count
        with self._lock:
            for i, v in enumerate(counts):
                self.counts[i] += v
            self.inf += inf
            self.sum += s
            self.count += c

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counts": list(self.counts),
                "inf": self.inf,
                "sum": self.sum,
                "count": self.count,
            }

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of the q-quantile (conservative: reports the
        bucket ceiling, never below the true value's bucket)."""
        snap = self.snapshot()
        total = snap["count"]
        if total == 0:
            return 0.0
        target = max(1, int(q * total + 0.999999))
        cum = 0
        for i, c in enumerate(snap["counts"]):
            cum += c
            if cum >= target:
                return self.edges[i]
        return self.edges[-1]

    def render(
        self, out: PromText, name: str, help_text: str, labels: Optional[dict] = None
    ) -> None:
        """Emit the family as a conformant Prometheus histogram. Empty
        buckets below the highest occupied edge still render (cumulative
        counts must be complete), but the all-zero tail is collapsed into
        the +Inf bucket to keep the exposition small."""
        snap = self.snapshot()
        out.family(name, "histogram", help_text)
        cum = 0
        top = 0
        for i, c in enumerate(snap["counts"]):
            if c:
                top = i + 1
        for i in range(top):
            cum += snap["counts"][i]
            le = {"le": _fmt_edge(self.edges[i])}
            if labels:
                le.update(labels)
            out.sample(name, cum, le, suffix="_bucket")
        inf_labels = {"le": "+Inf"}
        if labels:
            inf_labels.update(labels)
        out.sample(name, snap["count"], inf_labels, suffix="_bucket")
        out.sample(name, snap["sum"], labels, suffix="_sum")
        out.sample(name, snap["count"], labels, suffix="_count")


def _fmt_edge(e: float) -> str:
    if e >= 1 and e == int(e):
        return str(int(e))
    return repr(e)


# ---- time series ------------------------------------------------------------------


class TimeSeries:
    """Bounded ring of (ts, value) samples; oldest evicted past ``maxlen``.
    With the default 5 s sample interval, 720 points hold one hour."""

    __slots__ = ("_points", "_lock")

    def __init__(self, maxlen: int = 720):
        self._points: "deque[tuple[float, float]]" = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def add(self, ts: float, value: float) -> None:
        with self._lock:
            self._points.append((ts, value))

    def window(self, since_ts: float = 0.0) -> list[tuple[float, float]]:
        with self._lock:
            return [(t, v) for t, v in self._points if t >= since_ts]

    def __len__(self) -> int:
        with self._lock:
            return len(self._points)


# ---- registry ---------------------------------------------------------------------

# help text per histogram family (unknown families get a generic line)
HISTOGRAM_HELP: dict[str, str] = {
    "ballista_query_latency_seconds": (
        "End-to-end job wall time (graph start to final stage success)"
    ),
    "ballista_pop_tasks_seconds": (
        "TaskManager.pop_tasks duration (the executor-poll hot path)"
    ),
    "ballista_heartbeat_seconds": "HeartBeatFromExecutor handler duration",
    "ballista_stage_inputs_seconds": (
        "GetStageInputs handler duration (pipelined-shuffle piece feed)"
    ),
    "ballista_admission_wait_seconds": (
        "Time a job waited in the admission queue before dispatch"
    ),
    "ballista_task_queue_wait_seconds": (
        "Launch-to-start wait on the executor (slot/pool queueing)"
    ),
    "ballista_task_run_seconds": "Task execution wall time on the executor",
    "ballista_flight_fetch_seconds": (
        "Shuffle piece fetch latency over Flight (from task-reported spans)"
    ),
    "ballista_planning_seconds": "Parse/plan/govern/verify time per job",
    # fed by the concurrency verifier's traced-lock timings
    # (docs/static_analysis.md): one family per named lock via {lock=} labels
    "ballista_lock_wait_ms": (
        "Time spent waiting to acquire a named control-plane lock (ms)"
    ),
    "ballista_lock_hold_ms": (
        "Time a named control-plane lock was held per acquisition (ms)"
    ),
}


class FlightRecorder:
    """Process-wide metrics registry: histogram families keyed by
    (family, labels), registered gauge callbacks sampled into bounded time
    series by one daemon thread, and the conformant exposition for
    /api/metrics. ``enabled=False`` turns every record call into a no-op —
    the obs_bench overhead baseline."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._hists: dict[tuple[str, tuple], Histogram] = {}
        self._gauges: dict[str, tuple[Callable[[], float], str]] = {}
        self._series: dict[str, TimeSeries] = {}
        self._sampler: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.sample_interval_s = 5.0
        self.samples_taken = 0

    # ---- histograms ----------------------------------------------------------------
    def hist(self, family: str, labels: Optional[dict] = None) -> Histogram:
        key = (family, tuple(sorted((labels or {}).items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
            return h

    def observe(self, family: str, value: float, labels: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self.hist(family, labels).observe(value)

    def time_into(self, family: str, labels: Optional[dict] = None):
        """Context manager observing the block's wall time (perf_counter)."""
        return _Timer(self, family, labels)

    def histogram_families(self) -> list[str]:
        with self._lock:
            return sorted({f for f, _ in self._hists})

    # ---- gauges / time series -----------------------------------------------------
    def register_gauge(self, name: str, fn: Callable[[], float], help_text: str = "") -> None:
        with self._lock:
            self._gauges[name] = (fn, help_text or name)
            self._series.setdefault(name, TimeSeries())

    def series(self, name: str) -> TimeSeries:
        with self._lock:
            return self._series.setdefault(name, TimeSeries())

    def record_point(self, name: str, value: float, ts: Optional[float] = None) -> None:
        if not self.enabled:
            return
        self.series(name).add(ts if ts is not None else time.time(), float(value))

    def sample_once(self, now: Optional[float] = None) -> None:
        """One sweep over the registered gauges. Callback failures are
        swallowed per-gauge: a dying subsystem must not kill the sampler."""
        if not self.enabled:
            return
        ts = now if now is not None else time.time()
        with self._lock:
            gauges = list(self._gauges.items())
        for name, (fn, _) in gauges:
            try:
                v = float(fn())
            except Exception:  # noqa: BLE001 - telemetry must not propagate
                continue
            self.series(name).add(ts, v)
        self.samples_taken += 1

    def start_sampler(self, interval_s: float = 5.0) -> None:
        if self._sampler is not None:
            return
        self.sample_interval_s = max(0.05, float(interval_s))

        def run():
            while not self._stop.wait(self.sample_interval_s):
                self.sample_once()

        self._sampler = threading.Thread(
            target=run, daemon=True, name="obs-sampler"
        )
        self._sampler.start()

    def stop(self) -> None:
        self._stop.set()
        self._sampler = None

    # ---- exposition ----------------------------------------------------------------
    def prometheus_text(self) -> str:
        out = PromText()
        self.render_into(out)
        return out.text()

    def render_into(self, out: PromText) -> None:
        with self._lock:
            hists = sorted(self._hists.items())
            gauges = list(self._gauges.items())
            series = dict(self._series)
        for (family, labels), h in hists:
            h.render(
                out, family,
                HISTOGRAM_HELP.get(family, f"{family} (log2-bucket histogram)"),
                dict(labels) or None,
            )
        for name, (_, help_text) in sorted(gauges):
            ts = series.get(name)
            pts = ts.window() if ts is not None else []
            if pts:
                out.gauge(name, pts[-1][1], help_text)

    def timeseries_json(self, window_s: float = 3600.0) -> dict:
        since = time.time() - max(0.0, window_s)
        with self._lock:
            series = dict(self._series)
        return {
            "interval_s": self.sample_interval_s,
            "series": {
                name: [[round(t, 3), v] for t, v in ts.window(since)]
                for name, ts in sorted(series.items())
            },
        }


class _Timer:
    __slots__ = ("_rec", "_family", "_labels", "_t0")

    def __init__(self, rec: FlightRecorder, family: str, labels):
        self._rec = rec
        self._family = family
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.observe(
            self._family, time.perf_counter() - self._t0, self._labels
        )
        return False
