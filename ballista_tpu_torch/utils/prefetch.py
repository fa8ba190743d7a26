"""Bounded background prefetch for chunk pipelines.

The streaming device task path is a strict alternation: fetch/decode chunk k,
then compute chunk k on device, then fetch chunk k+1... ``prefetch_iter``
overlaps the two sides: a producer thread drains the inner iterator (and runs
an optional per-item ``transform`` — the engine uses it for host-encode +
async H2D dispatch) into a bounded queue while the consumer computes.

Memory stays bounded by the queue depth; errors from the producer (e.g.
``FetchFailed``) surface on the consumer at the point the failed item would
have arrived; closing the consumer generator stops the producer and closes the
inner iterator on the producer's own thread (generators must be finalized by
the thread that iterates them), which propagates cancellation into the
shuffle-fetch machinery exactly like the synchronous path.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


def prefetch_iter(
    inner: Iterator,
    depth: int,
    transform: Optional[Callable] = None,
    thread_name: str = "chunk-prefetch",
) -> Iterator:
    """Yield items of ``inner`` from a background producer holding at most
    ``depth`` items in flight. ``transform(item)`` runs on the producer
    thread; a transform failure propagates to the consumer."""
    if depth <= 0:
        yield from inner
        return

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()
    failure: list[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            for item in inner:
                if transform is not None:
                    item = transform(item)
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            failure.append(e)
        finally:
            try:
                close = getattr(inner, "close", None)
                if close is not None:
                    close()
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                pass
            _put(end)

    t = threading.Thread(target=produce, daemon=True, name=thread_name)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
        # unblock a producer stuck on a full queue, then let it finish its
        # cleanup (closing the inner iterator cancels in-flight fetches)
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=30.0)
