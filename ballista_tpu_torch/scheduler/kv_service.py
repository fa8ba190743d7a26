"""Networked KV backend: gRPC server + client completing the etcd tier.

Reference analog: ``EtcdClient`` implementing ``KeyValueStore`` over a
network service (``arrow-ballista: ballista/scheduler/src/cluster/storage/
etcd.rs:37-346`` — get/put/delete/scan, leases via etcd lease grants, and
server-PUSH watches) and the keyspace layout of ``cluster/kv.rs:56-764``.
The image has no etcd binary, so the service side here is a small gRPC
server wrapping any embedded ``KeyValueStore`` (in-memory or sqlite for
durability); schedulers on DIFFERENT machines connect with ``GrpcKV`` and
share cluster state, locks, and push watch events — no shared disk, no
polling.

Run standalone (the etcd-equivalent process):
    python -m ballista_tpu_torch.scheduler.kv_service --port 50070 [--db state.db]
"""
from __future__ import annotations

import logging
import queue
import threading
from concurrent import futures
from typing import Optional

import grpc

from ballista_tpu_torch.proto import kv_pb2 as kv
from ballista_tpu_torch.proto.rpc import GRPC_OPTIONS
from ballista_tpu_torch.utils import faults
from ballista_tpu_torch.scheduler.state_store import (
    InMemoryKV,
    KeyValueStore,
    SqliteKV,
    WatchHandle,
)

log = logging.getLogger("ballista.kv")

KV_SERVICE = "ballista_tpu.kv.KvStore"

_UNARY_METHODS = {
    "Get": (kv.KvGetRequest, kv.KvGetResponse),
    "Put": (kv.KvPutRequest, kv.KvEmpty),
    "Delete": (kv.KvDeleteRequest, kv.KvEmpty),
    "Scan": (kv.KvScanRequest, kv.KvScanResponse),
    "Lock": (kv.KvLockRequest, kv.KvLockResponse),
}


class KvServer:
    """Serves an embedded KeyValueStore over gRPC (the etcd-equivalent)."""

    def __init__(self, store: Optional[KeyValueStore] = None, etcd_surface: bool = True):
        self.store = store or InMemoryKV()
        self._server: Optional[grpc.Server] = None
        self._watch_mu = threading.Lock()
        self._active_watches = 0
        # also serve the etcd v3 wire (etcdserverpb.{KV,Watch,Lease}) over
        # the SAME store/port: stock etcd clients interoperate with native
        # ones, and a stock etcd server can replace this process for any
        # client speaking EtcdKV (the conformance seam, etcd_gateway.py)
        self._etcd_surface = etcd_surface
        self.etcd: Optional["EtcdGateway"] = None  # noqa: F821 - lazy import

    # ---- unary handlers --------------------------------------------------------
    def get(self, req: kv.KvGetRequest, ctx) -> kv.KvGetResponse:
        v = self.store.get(req.keyspace, req.key)
        return kv.KvGetResponse(found=v is not None, value=v or b"")

    def put(self, req: kv.KvPutRequest, ctx) -> kv.KvEmpty:
        self.store.put(req.keyspace, req.key, bytes(req.value))
        return kv.KvEmpty()

    def delete(self, req: kv.KvDeleteRequest, ctx) -> kv.KvEmpty:
        self.store.delete(req.keyspace, req.key)
        return kv.KvEmpty()

    def scan(self, req: kv.KvScanRequest, ctx) -> kv.KvScanResponse:
        return kv.KvScanResponse(
            pairs=[kv.KvPair(key=k, value=v) for k, v in self.store.scan(req.keyspace)]
        )

    def lock(self, req: kv.KvLockRequest, ctx) -> kv.KvLockResponse:
        if self.etcd is not None:
            # one lock state for BOTH wires: native locks become the same
            # lease-attached __locks keys etcd-wire clients contend on
            ok = self.etcd.lock(req.keyspace, req.key, req.owner, req.ttl_s or 30.0)
        else:
            ok = self.store.lock(req.keyspace, req.key, req.owner, req.ttl_s or 30.0)
        return kv.KvLockResponse(acquired=ok)

    # ---- streaming watch -------------------------------------------------------
    # Each active Watch pins one gRPC worker thread for its whole lifetime
    # (blocking queue loop). Bound them well below the pool size so unary KV
    # RPCs can never be starved by watch fan-out; excess watches
    # get a clear RESOURCE_EXHAUSTED instead of silently stalling the cluster.
    MAX_WATCHES = 24

    def watch(self, req: kv.KvWatchRequest, ctx):
        """Server-push change feed: events from the embedded store's watch
        flow through a queue into the response stream until the client
        disconnects (etcd.rs watch semantics — push, not polling)."""
        with self._watch_mu:
            if self._active_watches >= self.MAX_WATCHES:
                ctx.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"watch limit reached ({self.MAX_WATCHES}): each watch "
                    "pins a server worker; add KV replicas or reduce watchers",
                )
            self._active_watches += 1
        q: "queue.Queue[Optional[dict]]" = queue.Queue()
        closed = threading.Lock()  # makes on_close idempotent

        try:
            handle = self.store.watch(req.keyspace, q.put)
        except BaseException:
            with self._watch_mu:
                self._active_watches -= 1
            raise

        def on_close():
            if not closed.acquire(blocking=False):
                return  # already released
            handle.stop()
            with self._watch_mu:
                self._active_watches -= 1
            q.put(None)

        if not ctx.add_callback(on_close):
            # RPC already terminated before registration: release immediately
            on_close()
            return
        while True:
            ev = q.get()
            if ev is None:
                return
            value = ev.get("value")
            yield kv.KvEvent(
                op=ev["op"], keyspace=ev["keyspace"], key=ev["key"],
                value=value or b"", has_value=value is not None,
            )

    # ---- lifecycle -------------------------------------------------------------
    def start(self, port: int = 0, host: str = "0.0.0.0") -> int:
        # worker budget: MAX_WATCHES native watch threads + the etcd
        # gateway's MAX_STREAMS (watch/keepalive) each pin a worker for
        # their stream's lifetime; size the pool so unary RPCs always have
        # headroom beyond both caps
        server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=64, thread_name_prefix="kv-grpc"),
            options=GRPC_OPTIONS,
        )
        handlers = {}
        for name, (req_t, resp_t) in _UNARY_METHODS.items():
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                getattr(self, name.lower()),
                request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString,
            )
        handlers["Watch"] = grpc.unary_stream_rpc_method_handler(
            self.watch,
            request_deserializer=kv.KvWatchRequest.FromString,
            response_serializer=kv.KvEvent.SerializeToString,
        )
        server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(KV_SERVICE, handlers),)
        )
        if self._etcd_surface:
            from ballista_tpu_torch.scheduler.etcd_gateway import EtcdGateway

            self.etcd = EtcdGateway(self.store)
            self.etcd.register(server)
        bound = server.add_insecure_port(f"{host}:{port}")
        server.start()
        self._server = server
        log.info("kv server on port %d", bound)
        return bound

    def stop(self, grace: float = 1.0) -> None:
        if self.etcd is not None:
            self.etcd.close()
            self.etcd = None
        if self._server is not None:
            self._server.stop(grace)
            self._server = None


class GrpcKV(KeyValueStore):
    """KeyValueStore over the wire — the client schedulers embed. Watches are
    PUSH: a background thread consumes the server stream and invokes the
    callback per event (replacing the sqlite backend's 0.5s polling)."""

    def __init__(self, addr: str, timeout_s: float = 10.0):
        self.addr = addr
        self.timeout_s = timeout_s
        self._channel = grpc.insecure_channel(addr, options=GRPC_OPTIONS)
        self._calls = {}
        for name, (req_t, resp_t) in _UNARY_METHODS.items():
            self._calls[name] = self._channel.unary_unary(
                f"/{KV_SERVICE}/{name}",
                request_serializer=req_t.SerializeToString,
                response_deserializer=resp_t.FromString,
            )
        self._watch_call = self._channel.unary_stream(
            f"/{KV_SERVICE}/Watch",
            request_serializer=kv.KvWatchRequest.SerializeToString,
            response_deserializer=kv.KvEvent.FromString,
        )

    def get(self, keyspace, key):
        faults.check("kv.get", {"keyspace": keyspace, "key": key})
        r = self._calls["Get"](
            kv.KvGetRequest(keyspace=keyspace, key=key), timeout=self.timeout_s
        )
        return bytes(r.value) if r.found else None

    def put(self, keyspace, key, value):
        faults.check("kv.put", {"keyspace": keyspace, "key": key})
        self._calls["Put"](
            kv.KvPutRequest(keyspace=keyspace, key=key, value=value),
            timeout=self.timeout_s,
        )

    def delete(self, keyspace, key):
        faults.check("kv.delete", {"keyspace": keyspace, "key": key})
        self._calls["Delete"](
            kv.KvDeleteRequest(keyspace=keyspace, key=key), timeout=self.timeout_s
        )

    def scan(self, keyspace):
        faults.check("kv.scan", {"keyspace": keyspace})
        r = self._calls["Scan"](
            kv.KvScanRequest(keyspace=keyspace), timeout=self.timeout_s
        )
        for p in r.pairs:
            yield p.key, bytes(p.value)

    def lock(self, keyspace, key, owner, ttl_s=30.0):
        faults.check("kv.lock", {"keyspace": keyspace, "key": key})
        r = self._calls["Lock"](
            kv.KvLockRequest(keyspace=keyspace, key=key, owner=owner, ttl_s=ttl_s),
            timeout=self.timeout_s,
        )
        return r.acquired

    def watch(self, keyspace, callback):
        """Push watch with automatic re-subscription: if the KV server
        restarts (explicitly supported — sqlite durability), the pump logs a
        warning and reconnects with exponential backoff instead of dying
        silently (reference etcd.rs logs watch-stream errors).
        Events between loss and reconnect are NOT replayed — watchers must
        tolerate gaps (the scheduler's lease-expiry loop re-scans state)."""
        faults.check("kv.watch", {"keyspace": keyspace})
        stopped = threading.Event()
        current: dict = {"stream": None, "channel": None}

        def fresh_stream():
            # each attempt rides its OWN channel: a call queued on a shared
            # channel mid-reconnect can wedge in grpc's connecting state and
            # never surface an error; a fresh channel to a live server
            # connects cleanly. Watches are few (bounded server-side), so
            # one channel apiece is cheap.
            old = current.get("channel")
            if old is not None:
                try:
                    old.close()
                except Exception:  # noqa: BLE001
                    pass
            ch = grpc.insecure_channel(self.addr, options=GRPC_OPTIONS)
            current["channel"] = ch
            call = ch.unary_stream(
                f"/{KV_SERVICE}/Watch",
                request_serializer=kv.KvWatchRequest.SerializeToString,
                response_deserializer=kv.KvEvent.FromString,
            )
            return call(kv.KvWatchRequest(keyspace=keyspace))

        def close_current_channel():
            ch = current.get("channel")
            if ch is not None:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001
                    pass

        def pump():
            backoff = 0.2
            while not stopped.is_set():
                try:
                    stream = fresh_stream()
                    current["stream"] = stream
                    if stopped.is_set():
                        # raced with stop(): stop() closed whatever channel it
                        # saw, which may be the PREVIOUS one — close the fresh
                        # channel too or it leaks
                        stream.cancel()
                        close_current_channel()
                        return
                    for ev in stream:
                        backoff = 0.2  # healthy stream: reset the backoff
                        try:
                            callback(
                                {
                                    "op": ev.op,
                                    "keyspace": ev.keyspace,
                                    "key": ev.key,
                                    "value": bytes(ev.value) if ev.has_value else None,
                                }
                            )
                        except Exception:  # noqa: BLE001 - watcher errors stay local
                            pass
                except grpc.RpcError as e:
                    if stopped.is_set():
                        return  # deliberate cancel via stop()
                    log.warning(
                        "kv watch on %r lost (%s: %s); re-subscribing in %.1fs",
                        keyspace, self.addr,
                        e.code() if hasattr(e, "code") else e, backoff,
                    )
                except Exception as e:  # noqa: BLE001 - e.g. ValueError on a
                    # closed channel: terminal (close() tears pumps down),
                    # but never die with an unhandled thread traceback
                    if not stopped.is_set():
                        log.warning(
                            "kv watch on %r ended: %s (channel closed?)",
                            keyspace, e,
                        )
                    return
                if stopped.is_set():
                    return
                stopped.wait(backoff)
                backoff = min(backoff * 2, 10.0)

        t = threading.Thread(target=pump, daemon=True, name=f"kv-watch-{keyspace}")
        t.start()

        def stop():
            stopped.set()
            s = current.get("stream")
            if s is not None:
                s.cancel()
            ch = current.get("channel")
            if ch is not None:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001
                    pass

        return WatchHandle(stop)

    def close(self) -> None:
        self._channel.close()


def main() -> None:  # pragma: no cover - binary entry
    import argparse

    p = argparse.ArgumentParser(description="ballista-tpu networked KV service")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=50070)
    p.add_argument("--db", default=None, help="sqlite file for durability (default: in-memory)")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    store = SqliteKV(args.db) if args.db else InMemoryKV()
    srv = KvServer(store)
    port = srv.start(args.port, args.host)
    print(f"kv server listening on {args.host}:{port}", flush=True)
    threading.Event().wait()


if __name__ == "__main__":  # pragma: no cover
    main()
