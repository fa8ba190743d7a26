"""Chrome/Perfetto ``trace_event`` export.

Emits the JSON object format (https://ui.perfetto.dev opens it directly):
complete events (``ph: "X"``) with microsecond ``ts``/``dur``, one pid per
service lane (client / scheduler / executor / engine / shuffle) plus
``process_name`` metadata events so the timeline is labeled.
"""
from __future__ import annotations

from typing import Optional

from ballista_tpu_torch.obs.tracing import SERVICES

_KNOWN_PIDS = {s: i + 1 for i, s in enumerate(SERVICES)}


def _pid_table(spans: list[dict]) -> dict[str, int]:
    """Known services keep their stable pids; every UNKNOWN service gets its
    own pid (first-seen order) instead of all collapsing onto one shared
    timeline track where unrelated services' spans interleave."""
    pids = dict(_KNOWN_PIDS)
    next_pid = len(_KNOWN_PIDS) + 1
    for s in spans:
        service = s.get("service") or "unknown"
        if service not in pids:
            pids[service] = next_pid
            next_pid += 1
    return pids


def to_trace_events(
    spans: list[dict], counters: Optional[dict] = None
) -> dict:
    """Convert span dicts to a Chrome trace_event JSON object.

    ``counters`` optionally adds counter tracks (``ph: "C"``) alongside the
    spans: a mapping of track name -> list of ``(epoch_seconds, value)``
    points, e.g. the flight recorder's sampled queue-depth / running-tasks /
    cache-hit-rate time series. Points are clipped to the span window (with
    one sample of slack each side) so the counter lanes line up with the
    query timeline instead of stretching it to the recorder's full hour."""
    if spans:
        t0 = min(int(s.get("start_us", 0)) for s in spans)
        t1 = max(
            int(s.get("start_us", 0)) + int(s.get("dur_us", 0)) for s in spans
        )
    else:
        t0 = 0
        t1 = 0
    pids = _pid_table(spans)
    events = []
    seen_services: set[str] = set()
    for s in spans:
        service = s.get("service") or "unknown"
        seen_services.add(service)
        args = {
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "parent_id": s.get("parent_id"),
        }
        args.update(s.get("attrs") or {})
        events.append(
            {
                "name": s.get("name", "?"),
                "cat": service,
                "ph": "X",
                # timeline starts at the trace's first span; microseconds
                "ts": int(s.get("start_us", 0)) - t0,
                "dur": max(1, int(s.get("dur_us", 0))),
                "pid": pids[service],
                "tid": int(s.get("tid", 0)),
                "args": args,
            }
        )
    for service in sorted(seen_services):
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pids[service],
                "tid": 0,
                "args": {"name": service},
            }
        )
    if counters:
        pid = max(pids.values(), default=0) + 1
        slack_us = 10_000_000  # one recorder sample interval of slack
        emitted = False
        for track in sorted(counters):
            points = counters[track] or []
            for ts_s, value in points:
                ts_us = int(float(ts_s) * 1e6)
                if spans and not (t0 - slack_us <= ts_us <= t1 + slack_us):
                    continue
                events.append(
                    {
                        "name": track,
                        "cat": "metrics",
                        "ph": "C",
                        "ts": max(0, ts_us - t0),
                        "pid": pid,
                        "tid": 0,
                        "args": {"value": float(value)},
                    }
                )
                emitted = True
        if emitted:
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": 0,
                    "args": {"name": "metrics"},
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
