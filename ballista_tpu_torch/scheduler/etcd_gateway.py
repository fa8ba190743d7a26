"""etcd v3 wire compatibility for the KV tier.

Two halves of the conformance seam:

* ``EtcdGateway`` — serves the real ``etcdserverpb.{KV,Watch,Lease}`` gRPC
  surface (Range/Put/DeleteRange/Txn, bidi Watch, lease grant/revoke/
  keepalive) on top of any embedded ``KeyValueStore``. Registered on the
  same server/port as the native ``KvServer`` surface, over the SAME store,
  so stock etcd clients (etcdctl, python-etcd3) and ballista's native
  clients interoperate against one state.
* ``EtcdKV`` — a ``KeyValueStore`` client that speaks ONLY the etcd v3
  wire. Point it at the gateway *or at a stock etcd* and the scheduler's
  cluster-state tier (job ownership locks, watches, HA takeover) runs
  unchanged: the shared conformance suite (``tests/test_etcd_wire.py``)
  drives the same semantic checks through every backend.

Reference analog: ``EtcdClient`` implementing ``KeyValueStore`` against a
real etcd (``arrow-ballista: ballista/scheduler/src/cluster/storage/
etcd.rs:37-346``): get/put/delete/scan over flat keys, job-ownership locks
as lease-attached keys, server-push watches.

Key mapping (both halves agree): namespaced ``(keyspace, key)`` ↔ flat etcd
key ``<keyspace>/<key>``; advisory locks live under the ``__locks``
keyspace (``__locks/<keyspace>/<key>``) as lease-attached keys so data
scans never see them — the exact layout the reference uses for
``try_acquire_job`` ownership keys (etcd.rs lock keys + lease grants).
"""
from __future__ import annotations

import logging
import math
import queue
import threading
import time
from typing import Iterator, Optional

import grpc

from ballista_tpu_torch.analysis import concurrency
from ballista_tpu_torch.proto import etcd_pb2 as E
from ballista_tpu_torch.proto.rpc import GRPC_OPTIONS
from ballista_tpu_torch.scheduler.state_store import KeyValueStore, WatchHandle

log = logging.getLogger("ballista.etcd")

KV_SVC = "etcdserverpb.KV"
WATCH_SVC = "etcdserverpb.Watch"
LEASE_SVC = "etcdserverpb.Lease"


def flat_key(keyspace: str, key: str) -> bytes:
    return f"{keyspace}/{key}".encode()


def split_key(k: bytes) -> Optional[tuple[str, str]]:
    ks, sep, rest = k.partition(b"/")
    if not sep:
        return None
    return ks.decode(errors="replace"), rest.decode(errors="replace")


def key_in_range(key: bytes, start: bytes, end: bytes) -> bool:
    """etcd range membership: empty ``end`` = exactly ``start``;
    ``end == b'\\0'`` = every key >= start; else the half-open
    ``[start, end)``. One definition for ranges, watches and Txn interval
    checks — the watch bug fixed in this file existed because two inlined
    copies of this predicate diverged."""
    if not end:
        return key == start
    if end == b"\x00":
        return key >= start
    return start <= key < end


def prefix_end(prefix: bytes) -> bytes:
    """etcd's canonical prefix range_end: prefix with its last byte +1
    (trailing 0xff bytes dropped; all-0xff means 'to the end' = b'\\0')."""
    p = bytearray(prefix)
    while p and p[-1] == 0xFF:
        p.pop()
    if not p:
        return b"\x00"
    p[-1] += 1
    return bytes(p)


class _KeyMeta:
    __slots__ = ("create_rev", "mod_rev", "version", "lease")

    def __init__(self, create_rev: int, mod_rev: int, version: int, lease: int):
        self.create_rev = create_rev
        self.mod_rev = mod_rev
        self.version = version
        self.lease = lease


class EtcdGateway:
    """The etcd-wire face of an embedded KeyValueStore.

    Revision/version/lease accounting lives here (the embedded stores know
    nothing of MVCC); mutations arriving through the NATIVE surface are
    folded in via the store's own watch feed, so etcd watchers observe
    every mutation regardless of which wire performed it. A store whose
    watch feed coalesces rapid same-key mutations (the sqlite poller) can
    under-report echoes of gateway writes; the pending-echo counters below
    only ever skip accounting, never double it, so revisions stay
    monotonic in all cases.
    """

    LEASE_SWEEP_S = 0.25
    # each active Watch / LeaseKeepAlive stream pins one gRPC pool worker for
    # its lifetime (same rationale as KvServer.MAX_WATCHES); bound them so
    # stream fan-out can never starve unary RPCs on the shared port
    MAX_STREAMS = 16
    # TTL granted to lease-attached keys found in a durable store at startup
    # whose leases died with the previous process (stock etcd persists leases;
    # this gateway re-arms them): live holders refresh within their renewal
    # loop, dead holders' locks expire instead of wedging HA takeover forever
    ORPHAN_LEASE_TTL_S = 60

    def __init__(self, store: KeyValueStore):
        self.store = store
        self._coalescing_feed = bool(getattr(store, "WATCH_COALESCES", False))
        self._mu = threading.RLock()
        self._rev = 1  # etcd revisions start >0; headers report the current rev
        self._meta: dict[bytes, _KeyMeta] = {}
        self._leases: dict[int, dict] = {}  # id -> {ttl, expires, keys:set[bytes]}
        self._lease_seq = int(time.time() * 1000) % (1 << 40)
        # etcd watchers: server-side token -> {start, end, queue, filters, wid};
        # watch ids are CLIENT-scoped (etcd spec) — the token keys the global
        # table so one stream's client-chosen id can never displace another's
        self._watchers: dict[int, dict] = {}
        self._watcher_seq = 0
        # store-watch subscriptions per keyspace (lazy), + pending echoes of
        # gateway-originated mutations awaiting their store-feed event:
        # (value, deadline) entries, None value = delete. Matching is
        # feed-aware (see _on_store_event): exactly-once feeds match the
        # head; coalescing feeds (sqlite differ) match the LAST occurrence
        # and consume everything coalesced before it. Unmatched entries age
        # out by deadline rather than being cleared, so in-flight echoes are
        # never re-processed as native mutations (lease-strip hazard)
        self._subs: dict[str, WatchHandle] = {}
        self._echo: dict[tuple[str, str], list] = {}
        self._streams = 0
        self._stopped = threading.Event()
        with self._mu:
            self._rearm_orphan_locks()
        self._sweeper = threading.Thread(
            target=self._lease_sweep, daemon=True, name="etcd-lease-sweep"
        )
        self._sweeper.start()

    @concurrency.guarded_by("_mu")
    def _rearm_orphan_locks(self) -> None:
        """A durable store (sqlite) restarted under a fresh gateway still
        holds lock keys whose leases died with the old process. Without
        meta they would look create_revision==0 (instantly stealable —
        split-brain) or, with meta alone, never expire (HA wedged). Attach
        each to a fresh default-TTL lease: safe now, live again soon."""
        try:
            orphans = list(self.store.scan(EtcdKV.LOCK_NS))
        except Exception:  # noqa: BLE001 - scan support is all we need
            return
        for key, _ in orphans:
            fk = flat_key(EtcdKV.LOCK_NS, key)
            self._lease_seq += 1
            lid = self._lease_seq
            self._leases[lid] = {
                "ttl": self.ORPHAN_LEASE_TTL_S,
                "expires": time.time() + self.ORPHAN_LEASE_TTL_S,
                "keys": {fk},
            }
            self._rev += 1
            self._meta[fk] = _KeyMeta(self._rev, self._rev, 1, lid)

    def close(self) -> None:
        self._stopped.set()
        with self._mu:
            subs = list(self._subs.values())
            self._subs.clear()
            for w in self._watchers.values():
                w["queue"].put(None)
            self._watchers.clear()
        for h in subs:
            h.stop()

    # ---- revision / meta accounting ------------------------------------------------

    def _header(self) -> E.ResponseHeader:
        return E.ResponseHeader(cluster_id=0xBA117A, member_id=1, revision=self._rev)

    @concurrency.guarded_by("_mu")
    def _account_put(self, fk: bytes, lease: int) -> _KeyMeta:
        self._rev += 1
        m = self._meta.get(fk)
        if m is None:
            m = _KeyMeta(self._rev, self._rev, 1, lease)
            self._meta[fk] = m
        else:
            if m.lease and m.lease != lease:
                old = self._leases.get(m.lease)
                if old is not None:
                    old["keys"].discard(fk)
            m.mod_rev = self._rev
            m.version += 1
            m.lease = lease
        if lease:
            li = self._leases.get(lease)
            if li is not None:
                li["keys"].add(fk)
        return m

    @concurrency.guarded_by("_mu")
    def _account_delete(self, fk: bytes) -> None:
        self._rev += 1
        m = self._meta.pop(fk, None)
        if m is not None and m.lease:
            li = self._leases.get(m.lease)
            if li is not None:
                li["keys"].discard(fk)

    def _meta_for_locked(self, fk: bytes) -> _KeyMeta:
        """Meta for a key that EXISTS in the store: keys written before this
        gateway (native surface, or a durable store's previous life) get a
        persistent synthesized record — create_revision is stable and
        NONZERO, so a create-if-absent Txn can never steal a live key, and
        ranges report consistent revisions across calls."""
        m = self._meta.get(fk)
        if m is None:
            self._rev += 1
            m = _KeyMeta(self._rev, self._rev, 1, 0)
            self._meta[fk] = m
        return m

    def _ensure_sub(self, keyspace: str) -> None:
        """Subscribe the gateway to the store's native change feed for a
        keyspace (idempotent) so native-surface mutations reach etcd
        watchers and the revision index."""
        with self._mu:
            if keyspace in self._subs or self._stopped.is_set():
                return
            self._subs[keyspace] = self.store.watch(keyspace, self._on_store_event)

    def _on_store_event(self, ev: dict) -> None:
        ks, key = ev["keyspace"], ev["key"]
        fk = flat_key(ks, key)
        seen = ev["value"] if ev["op"] == "put" else None
        now = time.time()
        with self._mu:
            pending = self._echo.get((ks, key))
            if pending is not None:
                if self._coalescing_feed:
                    # the feed reports only the FINAL state of a burst: a
                    # match means every earlier pending write was coalesced
                    # away — consume through the LAST occurrence
                    idx = next((i for i in range(len(pending) - 1, -1, -1)
                                if pending[i][0] == seen), None)
                    consume_to = None if idx is None else idx + 1
                else:
                    # exactly-once in-order feed: an echo is always the HEAD
                    # entry; anything else is a native mutation interleaved
                    # between our mark and the store write
                    consume_to = 1 if (pending and pending[0][0] == seen) else None
                if consume_to is not None:
                    del pending[:consume_to]
                    if not pending:
                        del self._echo[(ks, key)]
                    return
                # no match: a native mutation. Do NOT clear pending blindly —
                # echoes of writes still in flight must stay matchable
                # (clearing would make them re-process as native mutations
                # later, stripping lease bindings). Stale entries age out.
                pending[:] = [p for p in pending if p[1] > now]
                if not pending:
                    del self._echo[(ks, key)]
            if ev["op"] == "put":
                m = self._account_put(fk, 0)
                kv = E.KeyValue(
                    key=fk, value=ev["value"] or b"", create_revision=m.create_rev,
                    mod_revision=m.mod_rev, version=m.version, lease=m.lease,
                )
                self._fanout_locked(E.Event(type=E.Event.PUT, kv=kv))
            else:
                self._account_delete(fk)
                self._fanout_locked(
                    E.Event(type=E.Event.DELETE, kv=E.KeyValue(key=fk))
                )

    # echoes older than this are assumed lost (coalesced away / feed gap)
    # and age out: both feeds normally deliver well under a second, so a
    # stale entry can only swallow a same-valued native write for this long
    ECHO_TTL_S = 5.0

    def _mark_echo_locked(self, ks: str, key: str, value) -> None:
        """Record that the store will (maybe) echo a gateway-originated
        mutation through its watch feed (``value=None`` for deletes). Only
        when a subscription exists — an unsubscribed keyspace produces no
        echo, and a stale pending entry would otherwise swallow a REAL
        native-surface mutation's event later."""
        if ks in self._subs:
            self._echo.setdefault((ks, key), []).append(
                (value, time.time() + self.ECHO_TTL_S)
            )

    def _fanout_locked(self, event: E.Event) -> None:
        fk = bytes(event.kv.key)
        for w in list(self._watchers.values()):
            if not key_in_range(fk, w["start"], w["end"]):
                continue
            if event.type == E.Event.PUT and E.WatchCreateRequest.NOPUT in w["filters"]:
                continue
            if (
                event.type == E.Event.DELETE
                and E.WatchCreateRequest.NODELETE in w["filters"]
            ):
                continue
            w["queue"].put(E.WatchResponse(
                header=self._header(), watch_id=w["wid"], events=[event]
            ))

    # ---- KV service ----------------------------------------------------------------

    def _range_kvs(self, req: E.RangeRequest) -> list[E.KeyValue]:
        start = bytes(req.key)
        end = bytes(req.range_end)
        out: list[E.KeyValue] = []
        if not end:
            sk = split_key(start)
            if sk is None:
                return out
            v = self.store.get(*sk)
            if v is not None:
                m = self._meta_for_locked(start)
                out.append(E.KeyValue(
                    key=start, value=b"" if req.keys_only else v,
                    create_revision=m.create_rev, mod_revision=m.mod_rev,
                    version=m.version, lease=m.lease,
                ))
            return out
        # range scan: the namespaced store can only express ranges confined
        # to one "<keyspace>/" namespace — a spanning range (etcdctl get ""
        # --prefix, range_end past the namespace, unbounded b'\0') must fail
        # LOUDLY: a silent subset would read as a complete result to a stock
        # etcd client
        keyspace = self._confined_range_keyspace(start, end)
        # sort on the FLAT BYTE key — etcd orders by bytes; the store's str
        # keys agree only while they round-trip utf-8 cleanly
        pairs = sorted(
            self.store.scan(keyspace), key=lambda kv: flat_key(keyspace, kv[0])
        )
        for key, v in pairs:
            fk = flat_key(keyspace, key)
            if not key_in_range(fk, start, end):
                continue
            m = self._meta_for_locked(fk)
            out.append(E.KeyValue(
                key=fk, value=b"" if req.keys_only else v,
                create_revision=m.create_rev, mod_revision=m.mod_rev,
                version=m.version, lease=m.lease,
            ))
        if req.sort_order == E.RangeRequest.DESCEND:
            out.reverse()
        return out

    @staticmethod
    def _confined_range_keyspace(start: bytes, end: bytes) -> str:
        """The single namespace a [start, end) range scan is confined to, or
        ``_Abort(INVALID_ARGUMENT)`` when the interval is not expressible
        over the namespaced store (no '<keyspace>/' in start, range_end
        beyond the namespace, or the unbounded b'\\0')."""
        sk = split_key(start)
        if sk is None:
            raise _Abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "range start must be '<keyspace>/...': cross-namespace ranges "
                "are not expressible over the namespaced store",
            )
        keyspace = sk[0]
        ns_end = prefix_end(flat_key(keyspace, ""))
        if end == b"\x00" or end > ns_end:
            raise _Abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"range end {end!r} reaches beyond namespace {keyspace!r}: "
                "cross-namespace ranges are not expressible over the "
                "namespaced store",
            )
        return keyspace

    def range(self, req: E.RangeRequest, ctx=None) -> E.RangeResponse:
        with self._mu:
            kvs = self._range_kvs(req)
            count = len(kvs)
            more = False
            if req.count_only:
                kvs = []
            elif req.limit and len(kvs) > req.limit:
                more = True
                kvs = kvs[: req.limit]
            return E.RangeResponse(
                header=self._header(), kvs=kvs, count=count, more=more
            )

    def _do_put(self, req: E.PutRequest) -> E.PutResponse:
        fk = bytes(req.key)
        sk = split_key(fk)
        if sk is None:
            raise _Abort(grpc.StatusCode.INVALID_ARGUMENT,
                         "key must be '<keyspace>/<key>'")
        ks, key = sk
        self._ensure_sub(ks)
        with self._mu:
            prev = None
            if req.prev_kv:
                old = self.store.get(ks, key)
                if old is not None:
                    m0 = self._meta_for_locked(fk)  # stable revs for
                    # pre-existing unindexed keys — never "freshly creatable"
                    prev = E.KeyValue(
                        key=fk, value=old,
                        create_revision=m0.create_rev,
                        mod_revision=m0.mod_rev,
                        version=m0.version,
                    )
            value = bytes(req.value)
            if req.ignore_value:
                cur = self.store.get(ks, key)
                if cur is None:
                    raise _Abort(grpc.StatusCode.INVALID_ARGUMENT, "key not found")
                value = cur
            lease = int(req.lease)
            if req.ignore_lease:
                m0 = self._meta.get(fk)
                lease = m0.lease if m0 else 0
            elif lease and lease not in self._leases:
                raise _Abort(grpc.StatusCode.NOT_FOUND,
                             "etcdserver: requested lease not found")
            self._mark_echo_locked(ks, key, value)
            self.store.put(ks, key, value)
            m = self._account_put(fk, lease)
            self._fanout_locked(E.Event(type=E.Event.PUT, kv=E.KeyValue(
                key=fk, value=value, create_revision=m.create_rev,
                mod_revision=m.mod_rev, version=m.version, lease=m.lease,
            )))
            resp = E.PutResponse(header=self._header())
            if prev is not None:
                resp.prev_kv.CopyFrom(prev)
            return resp

    def put(self, req: E.PutRequest, ctx=None) -> E.PutResponse:
        return self._do_put(req)

    def _do_delete(self, req: E.DeleteRangeRequest) -> E.DeleteRangeResponse:
        rng = E.RangeRequest(key=req.key, range_end=req.range_end)
        with self._mu:
            victims = self._range_kvs(rng)
            prev_kvs = list(victims) if req.prev_kv else []
            for kv in victims:
                sk = split_key(bytes(kv.key))
                if sk is None:
                    continue
                self._mark_echo_locked(sk[0], sk[1], None)
                self.store.delete(*sk)
                self._account_delete(bytes(kv.key))
                self._fanout_locked(E.Event(
                    type=E.Event.DELETE, kv=E.KeyValue(key=kv.key)
                ))
            return E.DeleteRangeResponse(
                header=self._header(), deleted=len(victims), prev_kvs=prev_kvs
            )

    def delete_range(self, req: E.DeleteRangeRequest, ctx=None) -> E.DeleteRangeResponse:
        return self._do_delete(req)

    def _check(self, cmp: E.Compare) -> bool:
        fk = bytes(cmp.key)
        sk = split_key(fk)
        exists = sk is not None and self.store.get(*sk) is not None
        # existing-but-unindexed keys (written natively / by a previous
        # process over a durable store) must NOT look freshly creatable
        m = self._meta_for_locked(fk) if exists else None
        tgt = cmp.target
        if tgt == E.Compare.VALUE:
            actual = self.store.get(*sk) if exists else None
            expect = bytes(cmp.value)
            if actual is None:
                # etcd: value compares against a missing key never hold for
                # EQUAL; NOT_EQUAL holds
                return cmp.result == E.Compare.NOT_EQUAL
            table = {
                E.Compare.EQUAL: actual == expect,
                E.Compare.NOT_EQUAL: actual != expect,
                E.Compare.GREATER: actual > expect,
                E.Compare.LESS: actual < expect,
            }
            return table[cmp.result]
        if tgt == E.Compare.VERSION:
            actual_i = m.version if (m and exists) else 0
            expect_i = int(cmp.version)
        elif tgt == E.Compare.CREATE:
            actual_i = m.create_rev if (m and exists) else 0
            expect_i = int(cmp.create_revision)
        elif tgt == E.Compare.MOD:
            actual_i = m.mod_rev if (m and exists) else 0
            expect_i = int(cmp.mod_revision)
        else:  # LEASE
            actual_i = m.lease if (m and exists) else 0
            expect_i = int(cmp.lease)
        table_i = {
            E.Compare.EQUAL: actual_i == expect_i,
            E.Compare.NOT_EQUAL: actual_i != expect_i,
            E.Compare.GREATER: actual_i > expect_i,
            E.Compare.LESS: actual_i < expect_i,
        }
        return table_i[cmp.result]

    def _validate_txn_ops_locked(self, req: E.TxnRequest) -> None:
        """Pre-validate a Txn's ops so a mid-list ``_Abort`` (malformed key,
        missing lease, ignore_value on an absent key) can never leave a
        half-applied transaction — etcd Txns are atomic. BOTH branches are
        checked (etcd's checkTxnRequest discipline): a nested Txn's compare
        can flip between pre-validation and apply when an earlier op in the
        same Txn mutates the compared key, so validating only the pre-state
        branch would still allow half-application. Runs under the same lock
        as the apply.

        Like etcd, a put may not duplicate another put's key nor fall inside
        a delete range within the same branch (checkIntervals) — that rule is
        what makes pre-state validation sound: no earlier op in an accepted
        Txn can mutate a key a later put's ignore_value check depends on."""
        for branch in (req.success, req.failure):
            self._check_txn_intervals(branch, set(), [])
        for op in list(req.success) + list(req.failure):
            which = op.WhichOneof("request")
            if which == "request_put":
                p = op.request_put
                sk = split_key(bytes(p.key))
                if sk is None:
                    raise _Abort(grpc.StatusCode.INVALID_ARGUMENT,
                                 "key must be '<keyspace>/<key>'")
                if p.ignore_value and self.store.get(*sk) is None:
                    raise _Abort(grpc.StatusCode.INVALID_ARGUMENT, "key not found")
                lease = int(p.lease)
                if lease and not p.ignore_lease and lease not in self._leases:
                    raise _Abort(grpc.StatusCode.NOT_FOUND,
                                 "etcdserver: requested lease not found")
            elif which == "request_range":
                r = op.request_range
                if bytes(r.range_end):
                    # a cross-namespace range aborts — validated up front so
                    # it can never strand a half-applied branch
                    self._confined_range_keyspace(bytes(r.key), bytes(r.range_end))
            elif which == "request_txn":
                self._validate_txn_ops_locked(op.request_txn)

    @staticmethod
    def _check_txn_intervals(ops, put_keys: set, del_ranges: list) -> None:
        """etcd's duplicate-key rule for one Txn branch (nested Txns'
        branches included): puts may not repeat a key or overlap a delete
        range. ``del_ranges`` entries: (start, end) with end=b'' for exact
        key, b'\\0' for unbounded."""
        for op in ops:
            which = op.WhichOneof("request")
            if which == "request_put":
                k = bytes(op.request_put.key)
                covered = any(key_in_range(k, s, e) for s, e in del_ranges)
                if k in put_keys or covered:
                    raise _Abort(grpc.StatusCode.INVALID_ARGUMENT,
                                 "etcdserver: duplicate key given in txn request")
                put_keys.add(k)
            elif which == "request_delete_range":
                d = op.request_delete_range
                del_ranges.append((bytes(d.key), bytes(d.range_end)))
            elif which == "request_txn":
                for branch in (op.request_txn.success, op.request_txn.failure):
                    EtcdGateway._check_txn_intervals(branch, put_keys, del_ranges)

    def txn(self, req: E.TxnRequest, ctx=None) -> E.TxnResponse:
        return self._txn_locked(req, validate=True)

    def _txn_locked(self, req: E.TxnRequest, validate: bool) -> E.TxnResponse:
        with self._mu:
            if validate:  # once, at the top level — validation recurses itself
                self._validate_txn_ops_locked(req)
            ok = all(self._check(c) for c in req.compare)
            ops = req.success if ok else req.failure
            responses = []
            for op in ops:
                which = op.WhichOneof("request")
                if which == "request_range":
                    responses.append(E.ResponseOp(
                        response_range=self.range(op.request_range)
                    ))
                elif which == "request_put":
                    responses.append(E.ResponseOp(
                        response_put=self._do_put(op.request_put)
                    ))
                elif which == "request_delete_range":
                    responses.append(E.ResponseOp(
                        response_delete_range=self._do_delete(op.request_delete_range)
                    ))
                elif which == "request_txn":
                    responses.append(E.ResponseOp(
                        response_txn=self._txn_locked(op.request_txn, validate=False)
                    ))
            return E.TxnResponse(
                header=self._header(), succeeded=ok, responses=responses
            )

    # ---- Watch service (bidi) ------------------------------------------------------

    def _stream_slot(self, ctx) -> bool:
        """Claim a pool-worker slot for a long-lived stream (Watch /
        LeaseKeepAlive). Aborting past the cap keeps stream fan-out from
        starving every unary RPC on the shared server (the native surface
        enforces the same discipline via KvServer.MAX_WATCHES)."""
        with self._mu:
            if self._streams >= self.MAX_STREAMS:
                if ctx is not None:
                    ctx.abort(
                        grpc.StatusCode.RESOURCE_EXHAUSTED,
                        f"etcd stream limit reached ({self.MAX_STREAMS}): each "
                        "stream pins a server worker",
                    )
                return False
            self._streams += 1
            return True

    def _stream_done(self) -> None:
        with self._mu:
            self._streams -= 1

    def watch_stream(self, request_iterator, ctx):
        if not self._stream_slot(ctx):
            return
        out: "queue.Queue[Optional[E.WatchResponse]]" = queue.Queue()
        # watch ids are CLIENT-scoped (etcd spec): this stream's wid -> the
        # gateway-global token actually keying self._watchers
        my_tokens: dict[int, int] = {}

        def reader():
            try:
                for req in request_iterator:
                    which = req.WhichOneof("request_union")
                    if which == "create_request":
                        cr = req.create_request
                        start = bytes(cr.key)
                        end = bytes(cr.range_end)
                        if int(cr.watch_id) < 0:
                            # etcd rejects client-chosen negative ids (the
                            # AUTO sentinel -1 included: this gateway always
                            # auto-assigns when watch_id is 0/unset)
                            out.put(E.WatchResponse(
                                header=self._header(), watch_id=int(cr.watch_id),
                                canceled=True,
                                cancel_reason="invalid watch_id (must be >= 0)",
                            ))
                            continue
                        sk = split_key(start)
                        if sk is not None:
                            self._ensure_sub(sk[0])
                        with self._mu:
                            req_wid = int(cr.watch_id)
                            # duplicate check BEFORE allocating a token: a
                            # rejected create must not burn (and leak) an
                            # unused _watcher_seq slot
                            if req_wid and req_wid in my_tokens:
                                out.put(E.WatchResponse(
                                    header=self._header(), watch_id=req_wid,
                                    canceled=True,
                                    cancel_reason="duplicate watch_id on stream",
                                ))
                                continue
                            self._watcher_seq += 1
                            token = self._watcher_seq
                            wid = req_wid or token
                            while wid in my_tokens:
                                # auto-assigned id collided with an earlier
                                # client-chosen one on this stream
                                self._watcher_seq += 1
                                token = wid = self._watcher_seq
                            self._watchers[token] = {
                                "start": start, "end": end, "queue": out,
                                "filters": list(cr.filters), "wid": wid,
                            }
                            my_tokens[wid] = token
                            out.put(E.WatchResponse(
                                header=self._header(), watch_id=wid, created=True
                            ))
                    elif which == "cancel_request":
                        wid = int(req.cancel_request.watch_id)
                        with self._mu:
                            token = my_tokens.pop(wid, None)
                            if token is not None and \
                                    self._watchers.pop(token, None) is not None:
                                out.put(E.WatchResponse(
                                    header=self._header(), watch_id=wid, canceled=True
                                ))
                    elif which == "progress_request":
                        # etcd: watch_id=-1 marks a stream-wide progress
                        # notify, valid only when every watcher is synced —
                        # always true here because _fanout_locked delivers
                        # events synchronously under the same lock that
                        # stamps the header revision, so the returned
                        # revision is never behind an undelivered event
                        with self._mu:
                            out.put(E.WatchResponse(header=self._header(), watch_id=-1))
            except Exception:  # noqa: BLE001 - client stream ended
                pass
            out.put(None)

        t = threading.Thread(target=reader, daemon=True, name="etcd-watch-reader")
        t.start()

        released = threading.Lock()  # idempotent cleanup across ctx/finally

        def cleanup():
            if not released.acquire(blocking=False):
                return
            with self._mu:
                for token in my_tokens.values():
                    self._watchers.pop(token, None)
            self._stream_done()
            out.put(None)

        if ctx is not None and not ctx.add_callback(cleanup):
            cleanup()
            return
        try:
            while True:
                resp = out.get()
                if resp is None:
                    return
                yield resp
        finally:
            cleanup()

    # ---- Lease service -------------------------------------------------------------

    def lease_grant(self, req: E.LeaseGrantRequest, ctx=None) -> E.LeaseGrantResponse:
        ttl = max(int(req.TTL), 1)
        with self._mu:
            lid = int(req.ID)
            if not lid:
                self._lease_seq += 1
                lid = self._lease_seq
            elif lid in self._leases:
                return E.LeaseGrantResponse(
                    header=self._header(), ID=lid, TTL=0,
                    error="etcdserver: lease already exists",
                )
            self._leases[lid] = {
                "ttl": ttl, "expires": time.time() + ttl, "keys": set()
            }
            return E.LeaseGrantResponse(header=self._header(), ID=lid, TTL=ttl)

    def _revoke(self, lid: int, only_if_expired: bool = False) -> bool:
        with self._mu:
            li = self._leases.get(lid)
            if li is None:
                return False
            if only_if_expired and li["expires"] >= time.time():
                # renewed between the sweeper's snapshot and this revoke: the
                # holder was just told (via keepalive) its lease is alive —
                # deleting its keys now would hand its locks away
                return False
            del self._leases[lid]
            victims = sorted(li["keys"])
            for fk in victims:
                sk = split_key(fk)
                if sk is None:
                    continue
                self._mark_echo_locked(sk[0], sk[1], None)
                self.store.delete(*sk)
                self._account_delete(fk)
                self._fanout_locked(E.Event(
                    type=E.Event.DELETE, kv=E.KeyValue(key=fk)
                ))
            return True

    def lease_revoke(self, req: E.LeaseRevokeRequest, ctx=None) -> E.LeaseRevokeResponse:
        if not self._revoke(int(req.ID)):
            raise _Abort(grpc.StatusCode.NOT_FOUND,
                         "etcdserver: requested lease not found")
        with self._mu:
            return E.LeaseRevokeResponse(header=self._header())

    def lease_keepalive_stream(self, request_iterator, ctx):
        if not self._stream_slot(ctx):
            return
        try:
            for req in request_iterator:
                lid = int(req.ID)
                # renew under the lock, but yield OUTSIDE it: the generator
                # suspends at yield while gRPC writes to the client, and a
                # slow/stalled reader must not freeze the whole gateway
                with self._mu:
                    li = self._leases.get(lid)
                    if li is not None:
                        li["expires"] = time.time() + li["ttl"]
                    resp = E.LeaseKeepAliveResponse(
                        header=self._header(), ID=lid,
                        TTL=li["ttl"] if li is not None else 0,
                    )
                yield resp
        finally:
            self._stream_done()

    def lease_ttl(self, req: E.LeaseTimeToLiveRequest, ctx=None) -> E.LeaseTimeToLiveResponse:
        with self._mu:
            li = self._leases.get(int(req.ID))
            if li is None:
                return E.LeaseTimeToLiveResponse(
                    header=self._header(), ID=req.ID, TTL=-1
                )
            return E.LeaseTimeToLiveResponse(
                header=self._header(), ID=req.ID,
                TTL=max(int(math.ceil(li["expires"] - time.time())), 0),
                grantedTTL=li["ttl"],
                keys=sorted(li["keys"]) if req.keys else [],
            )

    # ---- native-surface lock bridge --------------------------------------------------

    def lock(self, keyspace: str, key: str, owner: str, ttl_s: float = 30.0) -> bool:
        """Advisory lock with the SAME state as etcd-wire locks: a
        lease-attached ``__locks/<keyspace>/<key>`` key. KvServer routes its
        native Lock RPC here when the etcd surface is on, so a scheduler on
        the native wire and one on the etcd wire genuinely contend for job
        ownership (two disjoint lock tables would defeat the HA tier)."""
        # internal leases keep the float ttl (sub-second leases are valid on
        # the native surface; only the etcd WIRE quantizes TTLs to seconds)
        ttl = max(float(ttl_s), 0.05)
        fk = flat_key(EtcdKV.LOCK_NS, f"{keyspace}/{key}")
        sk = split_key(fk)
        with self._mu:
            cur = self.store.get(*sk)
            if cur is not None and cur != owner.encode():
                # an expired-but-not-yet-swept lease is free (embedded
                # backends' semantics); a live one blocks
                lid0 = self._meta[fk].lease if fk in self._meta else 0
                li0 = self._leases.get(lid0)
                if li0 is not None and li0["expires"] >= time.time():
                    return False
            old_lid = self._meta[fk].lease if fk in self._meta else 0
            self._lease_seq += 1
            lid = self._lease_seq
            self._leases[lid] = {
                "ttl": ttl, "expires": time.time() + ttl, "keys": set()
            }
            self._do_put(E.PutRequest(key=fk, value=owner.encode(), lease=lid))
            # the re-put detached the key from its previous lease; drop the
            # now-empty lease record so the sweeper doesn't churn on it
            if old_lid and not self._leases.get(old_lid, {}).get("keys"):
                self._leases.pop(old_lid, None)
            return True

    def _lease_sweep(self) -> None:
        while not self._stopped.wait(self.LEASE_SWEEP_S):
            now = time.time()
            with self._mu:
                expired = [lid for lid, li in self._leases.items()
                           if li["expires"] < now]
            for lid in expired:
                log.debug("lease %d expired; revoking", lid)
                self._revoke(lid, only_if_expired=True)

    # ---- registration --------------------------------------------------------------

    def register(self, server: grpc.Server) -> None:
        def unary(fn, req_t, resp_t):
            def handler(req, ctx):
                try:
                    return fn(req, ctx)
                except _Abort as a:
                    ctx.abort(a.code, a.detail)
            return grpc.unary_unary_rpc_method_handler(
                handler,
                request_deserializer=req_t.FromString,
                response_serializer=resp_t.SerializeToString,
            )

        kv_handlers = {
            "Range": unary(self.range, E.RangeRequest, E.RangeResponse),
            "Put": unary(self.put, E.PutRequest, E.PutResponse),
            "DeleteRange": unary(
                self.delete_range, E.DeleteRangeRequest, E.DeleteRangeResponse
            ),
            "Txn": unary(self.txn, E.TxnRequest, E.TxnResponse),
        }
        watch_handlers = {
            "Watch": grpc.stream_stream_rpc_method_handler(
                self.watch_stream,
                request_deserializer=E.WatchRequest.FromString,
                response_serializer=E.WatchResponse.SerializeToString,
            ),
        }
        lease_handlers = {
            "LeaseGrant": unary(
                self.lease_grant, E.LeaseGrantRequest, E.LeaseGrantResponse
            ),
            "LeaseRevoke": unary(
                self.lease_revoke, E.LeaseRevokeRequest, E.LeaseRevokeResponse
            ),
            "LeaseKeepAlive": grpc.stream_stream_rpc_method_handler(
                self.lease_keepalive_stream,
                request_deserializer=E.LeaseKeepAliveRequest.FromString,
                response_serializer=E.LeaseKeepAliveResponse.SerializeToString,
            ),
            "LeaseTimeToLive": unary(
                self.lease_ttl, E.LeaseTimeToLiveRequest, E.LeaseTimeToLiveResponse
            ),
        }
        server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(KV_SVC, kv_handlers),
            grpc.method_handlers_generic_handler(WATCH_SVC, watch_handlers),
            grpc.method_handlers_generic_handler(LEASE_SVC, lease_handlers),
        ))


class _Abort(Exception):
    def __init__(self, code: grpc.StatusCode, detail: str):
        self.code = code
        self.detail = detail


# ---- the client half: KeyValueStore over the etcd v3 wire ----------------------------


class EtcdKV(KeyValueStore):
    """Scheduler-side KeyValueStore speaking pure etcd v3 — works against
    the EtcdGateway *or a stock etcd*. Locks are lease-attached keys under
    ``__locks/``: acquisition is a single Txn (create_revision==0 →
    put-with-lease), refresh is a same-owner re-put with a fresh lease, and
    expiry is etcd's own lease expiry deleting the key (matching the
    embedded backends' ttl semantics and the reference's etcd lock layout)."""

    LOCK_NS = "__locks"

    def __init__(self, addr: str, timeout_s: float = 10.0):
        self.addr = addr
        self.timeout_s = timeout_s
        self._channel = grpc.insecure_channel(addr, options=GRPC_OPTIONS)
        u = self._channel.unary_unary
        self._range = u(f"/{KV_SVC}/Range",
                        request_serializer=E.RangeRequest.SerializeToString,
                        response_deserializer=E.RangeResponse.FromString)
        self._put = u(f"/{KV_SVC}/Put",
                      request_serializer=E.PutRequest.SerializeToString,
                      response_deserializer=E.PutResponse.FromString)
        self._delete = u(f"/{KV_SVC}/DeleteRange",
                         request_serializer=E.DeleteRangeRequest.SerializeToString,
                         response_deserializer=E.DeleteRangeResponse.FromString)
        self._txn = u(f"/{KV_SVC}/Txn",
                      request_serializer=E.TxnRequest.SerializeToString,
                      response_deserializer=E.TxnResponse.FromString)
        self._grant = u(f"/{LEASE_SVC}/LeaseGrant",
                        request_serializer=E.LeaseGrantRequest.SerializeToString,
                        response_deserializer=E.LeaseGrantResponse.FromString)
        self._revoke = u(f"/{LEASE_SVC}/LeaseRevoke",
                         request_serializer=E.LeaseRevokeRequest.SerializeToString,
                         response_deserializer=E.LeaseRevokeResponse.FromString)

    # ---- plain KV ------------------------------------------------------------------

    def get(self, keyspace: str, key: str) -> Optional[bytes]:
        r = self._range(
            E.RangeRequest(key=flat_key(keyspace, key)), timeout=self.timeout_s
        )
        return bytes(r.kvs[0].value) if r.kvs else None

    def put(self, keyspace: str, key: str, value: bytes) -> None:
        self._put(
            E.PutRequest(key=flat_key(keyspace, key), value=value),
            timeout=self.timeout_s,
        )

    def delete(self, keyspace: str, key: str) -> None:
        self._delete(
            E.DeleteRangeRequest(key=flat_key(keyspace, key)), timeout=self.timeout_s
        )

    def scan(self, keyspace: str) -> Iterator[tuple[str, bytes]]:
        prefix = f"{keyspace}/".encode()
        r = self._range(
            E.RangeRequest(key=prefix, range_end=prefix_end(prefix)),
            timeout=self.timeout_s,
        )
        for kv in r.kvs:
            sk = split_key(bytes(kv.key))
            if sk is not None:
                yield sk[1], bytes(kv.value)

    # ---- advisory locks over Txn + leases -------------------------------------------

    def lock(self, keyspace: str, key: str, owner: str, ttl_s: float = 30.0) -> bool:
        fk = flat_key(self.LOCK_NS, f"{keyspace}/{key}")
        lease = self._grant(
            E.LeaseGrantRequest(TTL=max(int(math.ceil(ttl_s)), 1)),
            timeout=self.timeout_s,
        ).ID
        t = self._txn(E.TxnRequest(
            compare=[E.Compare(
                result=E.Compare.EQUAL, target=E.Compare.CREATE,
                key=fk, create_revision=0,
            )],
            success=[E.RequestOp(request_put=E.PutRequest(
                key=fk, value=owner.encode(), lease=lease,
            ))],
            failure=[E.RequestOp(request_range=E.RangeRequest(key=fk))],
        ), timeout=self.timeout_s)
        if t.succeeded:
            return True
        holder = (
            bytes(t.responses[0].response_range.kvs[0].value)
            if t.responses and t.responses[0].response_range.kvs
            else None
        )
        if holder == owner.encode():
            # re-entrant refresh: re-put under the fresh lease — ATOMICALLY
            # guarded on still being the holder. A bare put could race the
            # old lease expiring and another scheduler's create-if-absent
            # winning in between (split-brain); the compare makes a lost
            # race a clean False.
            t2 = self._txn(E.TxnRequest(
                compare=[E.Compare(
                    result=E.Compare.EQUAL, target=E.Compare.VALUE,
                    key=fk, value=owner.encode(),
                )],
                success=[E.RequestOp(request_put=E.PutRequest(
                    key=fk, value=owner.encode(), lease=lease,
                ))],
            ), timeout=self.timeout_s)
            if t2.succeeded:
                return True
        # contended: release the unused lease eagerly
        try:
            self._revoke(E.LeaseRevokeRequest(ID=lease), timeout=self.timeout_s)
        except grpc.RpcError:
            pass
        return False

    # ---- push watch over the bidi Watch stream --------------------------------------

    def watch(self, keyspace: str, callback) -> WatchHandle:
        """Prefix watch with auto-resubscribe on stream loss (fresh channel
        per attempt — same rationale as GrpcKV.watch). Event gaps across a
        reconnect are possible; watchers tolerate gaps by design."""
        prefix = f"{keyspace}/".encode()
        stopped = threading.Event()
        current: dict = {"stream": None, "channel": None}

        def fresh_stream():
            old_done = current.get("done")
            if old_done is not None:
                old_done.set()  # unblock the previous attempt's request thread
            old = current.get("channel")
            if old is not None:
                try:
                    old.close()
                except Exception:  # noqa: BLE001
                    pass
            ch = grpc.insecure_channel(self.addr, options=GRPC_OPTIONS)
            current["channel"] = ch
            call = ch.stream_stream(
                f"/{WATCH_SVC}/Watch",
                request_serializer=E.WatchRequest.SerializeToString,
                response_deserializer=E.WatchResponse.FromString,
            )
            req = E.WatchRequest(create_request=E.WatchCreateRequest(
                key=prefix, range_end=prefix_end(prefix)
            ))
            # per-ATTEMPT event: gRPC parks a thread inside this generator's
            # next(); it must be released when THIS attempt dies, not only at
            # handle.stop(), or every reconnect leaks a blocked thread
            done = threading.Event()
            current["done"] = done

            def requests():
                yield req
                # keep the request side open for the attempt's lifetime
                done.wait()

            return call(requests())

        def close_current():
            ch = current.get("channel")
            if ch is not None:
                try:
                    ch.close()
                except Exception:  # noqa: BLE001
                    pass

        def release_attempt():
            d = current.get("done")
            if d is not None:
                d.set()

        def pump():
            backoff = 0.2
            while not stopped.is_set():
                try:
                    stream = fresh_stream()
                    current["stream"] = stream
                    if stopped.is_set():
                        stream.cancel()
                        release_attempt()
                        close_current()
                        return
                    for resp in stream:
                        backoff = 0.2
                        for ev in resp.events:
                            sk = split_key(bytes(ev.kv.key))
                            if sk is None or sk[0] != keyspace:
                                continue
                            try:
                                callback({
                                    "op": "put" if ev.type == E.Event.PUT else "delete",
                                    "keyspace": sk[0],
                                    "key": sk[1],
                                    "value": (
                                        bytes(ev.kv.value)
                                        if ev.type == E.Event.PUT else None
                                    ),
                                })
                            except Exception:  # noqa: BLE001
                                pass
                except grpc.RpcError as e:
                    if stopped.is_set():
                        return
                    log.warning(
                        "etcd watch on %r lost (%s: %s); re-subscribing in %.1fs",
                        keyspace, self.addr,
                        e.code() if hasattr(e, "code") else e, backoff,
                    )
                except Exception as e:  # noqa: BLE001 - closed channel et al.
                    if not stopped.is_set():
                        log.warning("etcd watch on %r ended: %s", keyspace, e)
                    return
                finally:
                    release_attempt()  # the attempt is over either way
                if stopped.is_set():
                    return
                stopped.wait(backoff)
                backoff = min(backoff * 2, 10.0)

        t = threading.Thread(target=pump, daemon=True, name=f"etcd-watch-{keyspace}")
        t.start()

        def stop():
            stopped.set()
            release_attempt()
            s = current.get("stream")
            if s is not None:
                s.cancel()
            close_current()

        return WatchHandle(stop)

    def close(self) -> None:
        self._channel.close()
