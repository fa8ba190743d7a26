"""Shared retry-with-exponential-backoff + deadline driver for control RPCs.

Reference analog: the bounded-retry discipline of ``BallistaClient``
(``core/src/client.rs:113-188``) applied to the scheduler's executor-facing
RPCs. Before this driver, ONE transient launch RPC error removed the
executor outright (scheduler/server.py) — the exact hole the chaos layer's
``rpc.launch:unavailable@n=1`` schedule exposes. Now an RPC is retried with
exponential backoff under a total deadline, and only an exhausted budget
surfaces to the caller (which quarantines rather than removes).

Shuffle DATA-plane fetches keep their own retry machinery
(``shuffle/flight.py``): their tiered fallback (consolidated -> per-piece ->
object store) and FetchFailed typing are fetch-specific.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

log = logging.getLogger("ballista.retry")


@dataclass(frozen=True)
class RetryPolicy:
    attempts: int = 3  # total attempts (1 + retries)
    base_delay_s: float = 0.2
    max_delay_s: float = 2.0
    deadline_s: float = 10.0  # total wall budget across attempts + sleeps


def is_transient(e: BaseException) -> bool:
    """Whether an RPC error is worth retrying: gRPC UNAVAILABLE /
    DEADLINE_EXCEEDED / RESOURCE_EXHAUSTED / ABORTED, raw connection
    failures, and injected transport faults (InjectedUnavailable subclasses
    ConnectionError). Application errors (bad request, unimplemented) are
    not — retrying them only delays the real diagnosis."""
    if isinstance(e, (ConnectionError, TimeoutError)):
        return True
    try:
        import grpc
    except ImportError:  # pragma: no cover - grpc is a hard dep in practice
        return False
    if isinstance(e, grpc.RpcError):
        code = e.code() if hasattr(e, "code") else None
        return code in (
            grpc.StatusCode.UNAVAILABLE,
            grpc.StatusCode.DEADLINE_EXCEEDED,
            grpc.StatusCode.RESOURCE_EXHAUSTED,
            grpc.StatusCode.ABORTED,
        )
    return False


def call_with_retry(
    fn: Callable[[], object],
    policy: RetryPolicy = RetryPolicy(),
    retryable: Callable[[BaseException], bool] = is_transient,
    description: str = "",
    sleep=time.sleep,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
):
    """Call ``fn`` under the policy. Non-retryable errors raise immediately;
    retryable ones back off exponentially until the attempt budget or the
    deadline is exhausted, then the LAST error raises. ``sleep`` is
    injectable for tests."""
    t0 = time.monotonic()
    last: Optional[BaseException] = None
    for attempt in range(max(1, policy.attempts)):
        if attempt:
            delay = min(
                policy.base_delay_s * (2 ** (attempt - 1)), policy.max_delay_s
            )
            remaining = policy.deadline_s - (time.monotonic() - t0)
            if remaining <= 0:
                break
            sleep(min(delay, remaining))
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 - classified below
            if not retryable(e):
                raise
            last = e
            if on_retry is not None:
                on_retry(attempt, e)
            log.debug(
                "transient failure on %s (attempt %d/%d): %s",
                description or "rpc", attempt + 1, policy.attempts, e,
            )
            if time.monotonic() - t0 >= policy.deadline_s:
                break
    assert last is not None
    raise last
