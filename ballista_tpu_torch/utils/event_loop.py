"""Generic bounded event loop.

Reference analog: ``EventLoop`` / ``EventAction`` / ``EventSender``
(``arrow-ballista: ballista/core/src/event_loop.rs:27-142``): a single
consumer thread drains a bounded queue, giving actor-style single-writer
discipline; a processing-latency watchdog mirrors the reference's
``scheduler_event_expected_processing_duration`` warning
(query_stage_scheduler.rs:84-87).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Generic, Optional, TypeVar

log = logging.getLogger("ballista.event_loop")

E = TypeVar("E")


class EventAction(Generic[E]):
    def on_start(self) -> None:
        pass

    def on_receive(self, event: E) -> None:
        raise NotImplementedError

    def on_error(self, event: E, error: Exception) -> None:
        log.exception("event handler failed on %r", event)


class EventLoop(Generic[E]):
    def __init__(
        self,
        name: str,
        action: EventAction[E],
        buffer_size: int = 10_000,
        expected_processing_s: Optional[float] = None,
    ):
        self.name = name
        self.action = action
        self._q: "queue.Queue[E]" = queue.Queue(maxsize=buffer_size)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.expected_processing_s = expected_processing_s

    def start(self) -> None:
        assert self._thread is None, "event loop already started"
        self._thread = threading.Thread(target=self._run, daemon=True, name=f"evloop-{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def post(self, event: E, timeout: Optional[float] = None) -> bool:
        """Enqueue an event; False if the buffer is full past the timeout."""
        try:
            self._q.put(event, timeout=timeout)
            return True
        except queue.Full:
            return False

    def _run(self) -> None:
        self.action.on_start()
        while not self._stop.is_set():
            try:
                event = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            t0 = time.time()
            try:
                self.action.on_receive(event)
            except Exception as e:  # noqa: BLE001
                self.action.on_error(event, e)
            if self.expected_processing_s is not None:
                dt = time.time() - t0
                if dt > self.expected_processing_s:
                    log.warning(
                        "[%s] event %r took %.3fs (expected <= %.3fs)",
                        self.name, type(event).__name__, dt, self.expected_processing_s,
                    )
