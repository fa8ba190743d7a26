"""Live piece feed: resolve PENDING shuffle-piece markers of pipelined stages.

Pipelined shuffle (docs/shuffle.md): the scheduler EARLY-resolves an eligible
consumer stage once a fraction of its input pieces sealed. The resolved plan's
``ShuffleReaderExec`` locations then contain, next to the sealed piece
locations, *pending markers*::

    {"pending": True, "job_id": ..., "stage_id": <producer>,
     "consumer_stage_id": ..., "partition_id": <reduce j>,
     "map_partition": <m>, "num_rows": <est>, "num_bytes": <est>}

This module is how the executor's data plane turns a marker back into a real
sealed location: a process-wide *resolver* — installed by ``ExecutorProcess``
at startup, wrapping the scheduler's ``GetStageInputs`` RPC on the same
channel the poll/heartbeat loops use — is polled until the named map
partition's piece appears, the producer re-runs it somewhere else (the feed
simply returns the LATEST location, so attempt-suffixed replacement pieces
route to waiting consumers automatically), or the deadline expires.

Deadline expiry (and a missing/unreachable feed) converts to the EXISTING
``FetchFailed`` lineage naming the exact map partition, tagged with
``PIPELINE_WAIT`` so the scheduler pins the stage back to barrier semantics
instead of early-resolving it into the same wait again.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterator, Optional

from ballista_tpu_torch.errors import FetchFailed

log = logging.getLogger("ballista.shuffle.feed")

# marker the scheduler's fetch-failure handler keys on (execution_graph)
PIPELINE_WAIT_MARKER = "PIPELINE_WAIT"

# poll cadence: cheap unary RPC on the existing scheduler channel; backs off
# toward POLL_MAX_S while nothing new seals
POLL_MIN_S = 0.05
POLL_MAX_S = 0.5

# resolver(job_id, consumer_stage_id, input_stage_id, partition_id)
#   -> (pieces: list[dict], complete: bool, gone: bool)
Resolver = Callable[[str, int, int, int], tuple[list[dict], bool, bool]]

from ballista_tpu_torch.analysis import concurrency as _concurrency

_lock = _concurrency.make_lock("shuffle.feed._lock")
# the process-wide resolver lives in a guarded map so any future lock-free
# access (a new poll path forgetting _lock) trips the concurrency verifier
_state = _concurrency.guarded_dict("shuffle.feed._state", _lock)


def install_feed(resolver: Optional[Resolver]) -> None:
    """Install the process-wide feed resolver (ExecutorProcess startup).
    ``None`` uninstalls (tests)."""
    with _lock:
        _state["resolver"] = resolver


def get_feed() -> Optional[Resolver]:
    with _lock:
        return _state.get("resolver")


def _fetch_failed(marker: dict, why: str) -> FetchFailed:
    return FetchFailed(
        marker.get("executor_id", "") or "",
        int(marker.get("stage_id", 0) or 0),
        int(marker.get("map_partition", 0) or 0),
        f"{PIPELINE_WAIT_MARKER}: {why} (pending piece of map partition "
        f"{marker.get('map_partition')} from stage {marker.get('stage_id')}, "
        f"reduce partition {marker.get('partition_id')})",
    )


def iter_resolved(
    markers: list[dict],
    deadline_s: float,
    cancelled=None,
) -> Iterator[dict]:
    """Yield one REAL location dict per pending marker, in seal order, by
    polling the installed resolver. Raises ``FetchFailed`` (PIPELINE_WAIT-
    tagged, naming the exact map partition) when the deadline expires for a
    still-unsealed piece, when the scheduler reports the job gone, or when
    no resolver is installed. ``cancelled`` (Event-like) aborts between
    polls with the same typed error (the consumer is being torn down; the
    scheduler ignores its late status either way).

    The markers must share one (job, consumer stage, producer stage, reduce
    partition) — which they always do: one ``ShuffleReaderExec`` partition's
    pending set comes from exactly one producer."""
    if not markers:
        return
    resolver = get_feed()
    if resolver is None:
        raise _fetch_failed(markers[0], "no piece feed installed")
    from ballista_tpu_torch.utils import faults

    first = markers[0]
    job_id = str(first.get("job_id", ""))
    consumer = int(first.get("consumer_stage_id", 0) or 0)
    producer = int(first.get("stage_id", 0) or 0)
    partition = int(first.get("partition_id", 0) or 0)
    waiting = {int(m.get("map_partition", 0) or 0): m for m in markers}
    deadline = time.monotonic() + max(0.0, deadline_s)
    delay = POLL_MIN_S
    while waiting:
        if cancelled is not None and cancelled.is_set():
            raise _fetch_failed(next(iter(waiting.values())), "fetch cancelled")
        try:
            faults.check("feed.poll", {
                "job_id": job_id, "stage_id": producer,
                "consumer_stage_id": consumer, "partition": partition,
            })
            pieces, complete, gone = resolver(job_id, consumer, producer, partition)
        except FetchFailed:
            raise
        except Exception as e:  # noqa: BLE001 - transient RPC error: keep
            # polling until the deadline (the scheduler may be failing over)
            log.debug("piece feed poll failed: %s", e)
            pieces, complete, gone = [], False, False
        if gone:
            raise _fetch_failed(
                next(iter(waiting.values())), "job no longer running"
            )
        progressed = False
        for p in pieces:
            m = int(p.get("map_partition", 0) or 0)
            marker = waiting.pop(m, None)
            if marker is None:
                continue
            progressed = True
            loc = dict(marker)
            loc.pop("pending", None)
            loc.update({
                "path": p.get("path", ""),
                "host": p.get("host", ""),
                "flight_port": int(p.get("flight_port", 0) or 0),
                "executor_id": p.get("executor_id", ""),
                "num_rows": int(p.get("num_rows", 0) or 0),
                "num_bytes": int(p.get("num_bytes", 0) or 0),
            })
            yield loc
        if not waiting:
            return
        if complete and not progressed:
            # producer complete yet a marker never resolved: only possible
            # when the consumer's inputs were purged mid-wait (rollback in
            # flight) — surface the lineage error rather than spinning
            raise _fetch_failed(
                next(iter(waiting.values())),
                "producer complete without the piece",
            )
        if time.monotonic() >= deadline:
            raise _fetch_failed(
                next(iter(waiting.values())), f"deadline ({deadline_s:g}s) expired"
            )
        delay = POLL_MIN_S if progressed else min(POLL_MAX_S, delay * 1.5)
        if cancelled is not None:
            cancelled.wait(delay)
        else:
            time.sleep(delay)


def resolve_pending(
    locations: list[dict],
    deadline_s: float,
    cancelled=None,
) -> tuple[list[dict], float]:
    """Blocking form for one-shot readers: return ``locations`` with every
    pending marker replaced by its sealed location (ready pieces unchanged,
    resolved pieces appended in seal order), plus the seconds spent
    waiting. Markers are grouped per (producer stage, reduce partition) —
    a join stage's two readers resolve independently."""
    ready = [loc for loc in locations if not loc.get("pending")]
    pending = [loc for loc in locations if loc.get("pending")]
    if not pending:
        return ready, 0.0
    groups: dict[tuple, list[dict]] = {}
    for m in pending:
        groups.setdefault(
            (m.get("stage_id"), m.get("partition_id")), []
        ).append(m)
    t0 = time.monotonic()
    # ONE absolute deadline shared by every group: the producers seal in
    # parallel wall-clock, so a per-group restart would stretch the
    # documented per-piece budget to groups x deadline_s before the barrier
    # fallback could fire
    t_end = t0 + max(0.0, deadline_s)
    out = list(ready)
    for markers in groups.values():
        out.extend(
            iter_resolved(markers, max(0.0, t_end - time.monotonic()), cancelled)
        )
    return out, time.monotonic() - t0


class FeedStats:
    """Per-read accounting the engines turn into op metrics: seconds blocked
    on unsealed pieces, pieces that arrived via the feed, and the overlap
    window (time the consumer spent fetching/computing while pieces were
    still pending — the comms/compute overlap the pipeline exists for)."""

    def __init__(self) -> None:
        self.pending_wait_s = 0.0
        self.pending_pieces = 0
        self._window_start: Optional[float] = None
        self._window_end: Optional[float] = None

    def note_window_start(self) -> None:
        if self._window_start is None:
            self._window_start = time.monotonic()

    def note_piece(self) -> None:
        self.pending_pieces += 1
        self._window_end = time.monotonic()

    def overlap_s(self) -> float:
        if self._window_start is None or self._window_end is None:
            return 0.0
        return max(
            0.0, (self._window_end - self._window_start) - self.pending_wait_s
        )

    def as_metrics(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if self.pending_pieces:
            out["op.PiecesPending.count"] = float(self.pending_pieces)
            out["op.PendingWait.time_s"] = self.pending_wait_s
            out["op.PipelineOverlap.time_s"] = self.overlap_s()
        elif self.pending_wait_s:
            out["op.PendingWait.time_s"] = self.pending_wait_s
        return out
