"""Process-wide Flight connection pool for the shuffle data plane.

Reference analog: ``BallistaClient`` caches one client per executor and
reuses it across fetches (``arrow-ballista: ballista/core/src/client.rs``,
``shuffle_reader.rs`` bounds streams per executor, not per piece). The
round-3 data plane paid a brand-new TCP+gRPC+Flight handshake for EVERY
piece and every retry attempt; at E executors x M map pieces that is ExM
setups per reduce task. This pool drops it to O(live endpoints).

Semantics:

* keyed by ``(host, port)``; a checked-out client is owned exclusively by
  the borrowing thread (never shared mid-stream), so no cross-thread stream
  interleaving is possible;
* health-based eviction: a borrow that exits with a TRANSPORT error closes
  the client instead of returning it, AND drops the endpoint's idle
  siblings — a failed stream usually means a dead endpoint, and a
  preempted-and-restarted executor would otherwise hand every retry attempt
  another stale socket until the whole fetch budget burned on known-bad
  channels. Consumer-side failures (cancellation, spill-disk errors)
  return the client: they say nothing about endpoint health;
* bounded: at most ``max_idle`` idle clients are retained process-wide
  (LRU across endpoints); beyond that, returned clients are closed;
* observable: ``stats()`` counts opened / reused / evicted connections —
  the shuffle microbenchmark's "fewer connections" claim is this counter,
  and per-read spans attach the delta (pooled vs fresh).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Iterator, Optional

DEFAULT_MAX_IDLE = 32


class FlightClientPool:
    """Thread-safe bounded pool of persistent Flight clients."""

    def __init__(self, max_idle: int = DEFAULT_MAX_IDLE):
        self._lock = threading.Lock()
        # endpoint -> stack of idle clients; OrderedDict for LRU across
        # endpoints (least-recently-used endpoint evicted first when full)
        self._idle: "OrderedDict[tuple[str, int], list]" = OrderedDict()
        self._idle_count = 0
        self.max_idle = max_idle
        self._opened = 0
        self._reused = 0
        self._evicted = 0

    # ---- stats -----------------------------------------------------------------
    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "opened": self._opened,
                "reused": self._reused,
                "evicted": self._evicted,
                "idle": self._idle_count,
            }

    def reset_stats(self) -> None:
        with self._lock:
            self._opened = 0
            self._reused = 0
            self._evicted = 0

    def count_opened(self) -> None:
        """Record a connection opened OUTSIDE the pool (pooling disabled) so
        the opened counter stays comparable across modes."""
        with self._lock:
            self._opened += 1

    # ---- borrow / return -------------------------------------------------------
    def _connect(self, host: str, port: int):
        import pyarrow.flight as flight

        client = flight.connect(f"grpc://{host}:{port}")
        with self._lock:
            self._opened += 1
        return client

    def _checkout(self, key: tuple[str, int]):
        with self._lock:
            bucket = self._idle.get(key)
            if bucket:
                client = bucket.pop()
                self._idle_count -= 1
                if not bucket:
                    del self._idle[key]
                else:
                    self._idle.move_to_end(key)
                self._reused += 1
                return client
        return None

    def _checkin(self, key: tuple[str, int], client) -> None:
        to_close = []
        with self._lock:
            self._idle.setdefault(key, []).append(client)
            self._idle.move_to_end(key)
            self._idle_count += 1
            while self._idle_count > self.max_idle:
                old_key, bucket = next(iter(self._idle.items()))
                to_close.append(bucket.pop(0))
                self._idle_count -= 1
                self._evicted += 1
                if not bucket:
                    del self._idle[old_key]
        for c in to_close:
            _close_quietly(c)

    def discard(self, client) -> None:
        with self._lock:
            self._evicted += 1
        _close_quietly(client)

    def evict_endpoint(self, host: str, port: int) -> int:
        """Close every idle client of an endpoint (known-dead executor)."""
        key = (host, int(port))
        with self._lock:
            bucket = self._idle.pop(key, [])
            self._idle_count -= len(bucket)
            self._evicted += len(bucket)
        for c in bucket:
            _close_quietly(c)
        return len(bucket)

    def clear(self) -> None:
        with self._lock:
            buckets = list(self._idle.values())
            self._idle.clear()
            self._idle_count = 0
        for bucket in buckets:
            for c in bucket:
                _close_quietly(c)

    @contextmanager
    def connection(self, host: str, port: int) -> Iterator[tuple]:
        """Borrow a client for one endpoint; yields ``(client, reused)``.

        Clean exit returns the client to the pool. A TRANSPORT error from
        the body (Arrow/Flight/gRPC — the endpoint is likely dead) closes
        the client AND evicts the endpoint's idle siblings: they almost
        certainly share the dead socket's fate, and the next attempt should
        dial fresh (clients checked out by other threads evict themselves
        the same way when they fail). Consumer-side failures — cancellation
        of an early-terminated read, a spill-disk write error — say nothing
        about endpoint health, so the client goes back to the pool: a
        limit/top-k query must not tear down a live executor's connections."""
        key = (str(host), int(port))
        client = self._checkout(key)
        reused = client is not None
        if client is None:
            client = self._connect(host, int(port))
        try:
            yield client, reused
        except BaseException as e:
            if _is_transport_error(e):
                self.discard(client)
                self.evict_endpoint(*key)
            else:
                self._checkin(key, client)
            raise
        else:
            self._checkin(key, client)


def _close_quietly(client) -> None:
    try:
        client.close()
    except Exception:  # noqa: BLE001 - already-broken channels raise on close
        pass


def _is_transport_error(e: BaseException) -> bool:
    """Whether an exception from a borrow body indicts the ENDPOINT.
    Arrow/Flight errors (all subclass ``pa.ArrowException``, including every
    gRPC status surfaced by pyarrow) and raw connection failures do; typed
    engine errors (``FetchFailed`` cancellation) and local OS errors (spill
    disk) do not."""
    import pyarrow as pa

    return isinstance(e, (pa.ArrowException, ConnectionError))


# the process-wide pool every shuffle fetch path shares
GLOBAL_FLIGHT_POOL = FlightClientPool()


def attach_conn_stats(span, conn0: dict[str, int], pooled: bool) -> None:
    """Attach pooled-vs-fresh connection deltas to a shuffle-read span:
    ``conn0`` is a ``GLOBAL_FLIGHT_POOL.stats()`` snapshot taken before the
    read. Process-global counters, so deltas are approximate under
    concurrent tasks and exact in single-reader runs (the benchmark)."""
    conn1 = GLOBAL_FLIGHT_POOL.stats()
    span.set("conn_opened", conn1["opened"] - conn0["opened"])
    span.set("conn_reused", conn1["reused"] - conn0["reused"])
    span.set("pooled", pooled)


@contextmanager
def flight_connection(
    host: str, port: int, pooled: bool = True,
    pool: Optional[FlightClientPool] = None,
) -> Iterator[tuple]:
    """Uniform entry point for shuffle Flight connections: yields
    ``(client, reused)``. ``pooled=False`` opens a one-shot client (closed on
    exit) but still counts against the shared opened-connections stat so
    pooled and unpooled runs are comparable."""
    from ballista_tpu_torch.utils import faults

    # chaos fault point: an injected checkout failure looks exactly like a
    # dead endpoint (InjectedUnavailable is a ConnectionError), exercising
    # the callers' retry tiers without touching a socket
    faults.check("pool.checkout", {"host": str(host), "port": int(port)})
    p = pool or GLOBAL_FLIGHT_POOL
    if pooled:
        with p.connection(host, port) as (client, reused):
            yield client, reused
        return
    import pyarrow.flight as flight

    client = flight.connect(f"grpc://{host}:{int(port)}")
    p.count_opened()
    try:
        yield client, False
    finally:
        _close_quietly(client)
