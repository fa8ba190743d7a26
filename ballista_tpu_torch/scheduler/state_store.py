"""Persistent job state: KeyValueStore backends + ExecutionGraph serde.

Reference analog: the ``KeyValueStore`` trait with etcd/sled backends
(``arrow-ballista: ballista/scheduler/src/cluster/storage/mod.rs:28-115``,
``etcd.rs``, ``sled.rs``) and ``JobState::save_job`` / ``try_acquire_job``
(``cluster/mod.rs:310-379``): graphs are encodable; Running stages demote to
Resolved on encode (their in-flight tasks are lost across a scheduler
restart and simply re-run — the shuffle files on executors are the durable
artifact, survey §5.4). Backends here: in-memory and sqlite (the embedded
sled analog; an etcd-style networked backend implements the same interface).
Keyspaces mirror the reference: Executors/JobStatus/ExecutionGraph/Slots/
Sessions/Heartbeats.
"""
from __future__ import annotations

import json
import queue
import sqlite3
import threading
import time
from typing import Iterator, Optional

from ballista_tpu_torch.analysis import concurrency
from ballista_tpu_torch.plan.serde import encode_physical, decode_physical
from ballista_tpu_torch.scheduler.execution_graph import (
    ExecutionGraph, ExecutionStage, RESOLVED, STAGE_RUNNING, StageOutput,
    TaskInfo, UNRESOLVED,
)
from ballista_tpu_torch.utils import faults

KEYSPACES = ("Executors", "JobStatus", "ExecutionGraph", "Slots", "Sessions",
             "Heartbeats", "ExchangeCache", "QueryLedger")


class KeyValueStore:
    """get/put/scan/delete with namespaced keys + advisory locks."""

    # True when the watch feed may COALESCE rapid same-key mutations into one
    # event reporting only the final state (a polling differ), False when it
    # delivers exactly one in-order event per mutation. Consumers that
    # correlate their own writes with the feed (EtcdGateway's echo tracking)
    # need to know which contract they are under.
    WATCH_COALESCES = False

    def get(self, keyspace: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, keyspace: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, keyspace: str, key: str) -> None:
        raise NotImplementedError

    def scan(self, keyspace: str) -> Iterator[tuple[str, bytes]]:
        raise NotImplementedError

    def lock(self, keyspace: str, key: str, owner: str, ttl_s: float = 30.0) -> bool:
        """Advisory lease; returns True if acquired (used by try_acquire_job
        for multi-scheduler ownership transfer)."""
        raise NotImplementedError

    def watch(self, keyspace: str, callback) -> "WatchHandle":
        """Keyspace change feed (reference: etcd.rs watch / kv.rs keyspace
        events): ``callback({"op": "put"|"delete", "keyspace": ..., "key":
        ..., "value": bytes|None})`` fires for every mutation after
        registration. Returns a handle whose ``stop()`` unsubscribes."""
        raise NotImplementedError


class WatchHandle:
    def __init__(self, stop_fn):
        self._stop_fn = stop_fn

    def stop(self) -> None:
        self._stop_fn()


class InMemoryKV(KeyValueStore):
    def __init__(self):
        self._mu = concurrency.make_rlock("InMemoryKV._mu")
        self._data = concurrency.guarded_dict("InMemoryKV._data", self._mu)
        self._locks: dict[tuple[str, str], tuple[str, float]] = {}
        # keyspace -> callbacks
        self._watchers = concurrency.guarded_dict("InMemoryKV._watchers", self._mu)
        # events enqueue UNDER the store lock (queue order == mutation order)
        # and a single drain thread invokes callbacks: watchers observe
        # mutations in the order they landed, and callbacks run outside the
        # store lock (no lock-order deadlocks, no cross-thread reordering)
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._drainer: Optional[threading.Thread] = None

    def _enqueue_locked(self, op: str, keyspace: str, key: str, value) -> None:
        cbs = list(self._watchers.get(keyspace, ()))
        if not cbs:
            return
        # the recipient set is SNAPSHOTTED at mutation time (under the store
        # lock): every watcher registered when a mutation lands receives it,
        # even if it unsubscribes before the drain thread dispatches — and
        # stop() never needs to block on the queue (no self-join deadlock
        # when a callback stops its own handle)
        self._events.put(
            {"op": op, "keyspace": keyspace, "key": key, "value": value, "cbs": cbs}
        )

    def _drain_loop(self) -> None:
        while True:
            ev = self._events.get()
            if ev is None:
                return
            cbs = ev.pop("cbs")
            for cb in cbs:
                try:
                    cb(ev)
                except Exception:  # noqa: BLE001 - watcher errors stay local
                    pass

    def watch(self, keyspace, callback):
        """``stop()`` returns immediately; events enqueued BEFORE the stop are
        still delivered (recipient sets snapshot at mutation time)."""
        with self._mu:
            self._watchers.setdefault(keyspace, []).append(callback)
            if self._drainer is None:
                self._drainer = threading.Thread(
                    target=self._drain_loop, daemon=True, name="kv-events"
                )
                self._drainer.start()

        def stop():
            with self._mu:
                cbs = self._watchers.get(keyspace, [])
                if callback in cbs:
                    cbs.remove(callback)

        return WatchHandle(stop)

    def get(self, keyspace, key):
        faults.check("kv.get", {"keyspace": keyspace, "key": key})
        with self._mu:
            return self._data.get((keyspace, key))

    def put(self, keyspace, key, value):
        faults.check("kv.put", {"keyspace": keyspace, "key": key})
        with self._mu:
            self._data[(keyspace, key)] = value
            self._enqueue_locked("put", keyspace, key, value)

    def delete(self, keyspace, key):
        faults.check("kv.delete", {"keyspace": keyspace, "key": key})
        with self._mu:
            had = self._data.pop((keyspace, key), None)
            if had is not None:
                self._enqueue_locked("delete", keyspace, key, None)

    def scan(self, keyspace):
        faults.check("kv.scan", {"keyspace": keyspace})
        with self._mu:
            items = [(k[1], v) for k, v in self._data.items() if k[0] == keyspace]
        yield from items

    def lock(self, keyspace, key, owner, ttl_s=30.0):
        faults.check("kv.lock", {"keyspace": keyspace, "key": key})
        with self._mu:
            now = time.time()
            cur = self._locks.get((keyspace, key))
            if cur is None or cur[1] < now or cur[0] == owner:
                self._locks[(keyspace, key)] = (owner, now + ttl_s)
                return True
            return False


class SqliteKV(KeyValueStore):
    """Durable single-file backend (the embedded sled analog)."""

    WATCH_COALESCES = True  # the 0.5s polling differ reports net changes only

    def __init__(self, path: str):
        self._path = path
        self._mu = concurrency.make_rlock("SqliteKV._mu")
        self._conn = sqlite3.connect(path, check_same_thread=False)
        with self._mu:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (ks TEXT, k TEXT, v BLOB, PRIMARY KEY (ks, k))"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS locks (ks TEXT, k TEXT, owner TEXT, "
                "expires REAL, PRIMARY KEY (ks, k))"
            )
            self._conn.commit()

    def get(self, keyspace, key):
        faults.check("kv.get", {"keyspace": keyspace, "key": key})
        with self._mu:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE ks=? AND k=?", (keyspace, key)
            ).fetchone()
        return row[0] if row else None

    def put(self, keyspace, key, value):
        faults.check("kv.put", {"keyspace": keyspace, "key": key})
        with self._mu:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (ks, k, v) VALUES (?,?,?)", (keyspace, key, value)
            )
            self._conn.commit()

    def delete(self, keyspace, key):
        faults.check("kv.delete", {"keyspace": keyspace, "key": key})
        with self._mu:
            self._conn.execute("DELETE FROM kv WHERE ks=? AND k=?", (keyspace, key))
            self._conn.commit()

    def scan(self, keyspace):
        faults.check("kv.scan", {"keyspace": keyspace})
        with self._mu:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE ks=?", (keyspace,)
            ).fetchall()
        yield from rows

    def lock(self, keyspace, key, owner, ttl_s=30.0):
        faults.check("kv.lock", {"keyspace": keyspace, "key": key})
        now = time.time()
        with self._mu:
            row = self._conn.execute(
                "SELECT owner, expires FROM locks WHERE ks=? AND k=?", (keyspace, key)
            ).fetchone()
            if row is None or row[1] < now or row[0] == owner:
                self._conn.execute(
                    "INSERT OR REPLACE INTO locks (ks, k, owner, expires) VALUES (?,?,?,?)",
                    (keyspace, key, owner, now + ttl_s),
                )
                self._conn.commit()
                return True
            return False

    def watch(self, keyspace, callback, poll_interval_s: float = 0.5):
        """Poll-based change feed: sqlite is a shared FILE across HA peers, so
        mutations by OTHER processes are visible only by reading — the watcher
        diffs the keyspace on an interval (an etcd backend would use a real
        server-side watch through the same interface)."""
        stop_ev = threading.Event()

        def digest():
            # snapshot VALUES (not just hashes): the put event must carry the
            # value observed in the diff, not a re-read that may already be
            # deleted or changed again
            return dict(self.scan(keyspace))

        baseline = digest()  # synchronously: mutations after watch() returns
        # must be reported, even ones racing the poll thread's startup

        def loop():
            last = baseline
            while not stop_ev.wait(poll_interval_s):
                try:
                    cur = digest()
                except Exception:  # noqa: BLE001 - a transient scan failure
                    # (locked db file, injected kv.scan fault) must not kill
                    # the watch thread; the next tick re-diffs
                    continue
                for k, v in cur.items():
                    if last.get(k) != v:
                        try:
                            callback({"op": "put", "keyspace": keyspace, "key": k,
                                      "value": v})
                        except Exception:  # noqa: BLE001
                            pass
                for k in last:
                    if k not in cur:
                        try:
                            callback({"op": "delete", "keyspace": keyspace, "key": k,
                                      "value": None})
                        except Exception:  # noqa: BLE001
                            pass
                last = cur

        t = threading.Thread(target=loop, daemon=True, name=f"kv-watch-{keyspace}")
        t.start()
        return WatchHandle(stop_ev.set)


# ---- ExecutionGraph persistence ---------------------------------------------------
def graph_to_json(g: ExecutionGraph) -> dict:
    stages = {}
    # pipelined stages demote to UNRESOLVED below with ALL task infos
    # cleared, so the restored re-run re-propagates EVERY partition — any
    # pieces this attempt already pushed into consumers' inputs must be
    # purged from the serialized form too, or the re-run appends duplicates
    # and consumers read early-sealed pieces twice (the exact hazard
    # _rollback_stage documents)
    demoted_sids = {
        sid for sid, s in g.stages.items()
        if getattr(s, "pipelined", False)
        and s.state in (RESOLVED, STAGE_RUNNING)
    }
    for sid, s in g.stages.items():
        # reference behavior: Running demotes to Resolved on encode — in-flight
        # tasks are not durable; completed task outputs (shuffle files) are
        state = RESOLVED if s.state == STAGE_RUNNING else s.state
        resolved_plan = s.resolved_plan
        task_infos = s.task_infos
        if sid in demoted_sids:
            # pipelined shuffle (docs/shuffle.md): an EARLY-resolved plan
            # carries pending markers whose feed the adopting scheduler can
            # serve, but pipelining is runtime-only state like speculation/
            # AQE — demote all the way to UNRESOLVED so the restored stage
            # re-resolves with barrier semantics once its inputs complete
            state = UNRESOLVED
            resolved_plan = None
            task_infos = [None] * s.partitions
        stages[str(sid)] = {
            "state": state,
            "attempt": s.attempt,
            "partitions": s.partitions,
            # cross-query exchange cache (docs/serving.md): an adopting
            # scheduler keeps knowing which stages rode cached pieces, so a
            # recompute there still reports the entry stale
            "from_cache": getattr(s, "from_cache", False),
            "exchange_key": getattr(s, "exchange_key", None),
            "exchange_entry_gen": getattr(s, "exchange_entry_gen", None),
            "output_links": s.output_links,
            "broadcast_rows_threshold": s.broadcast_rows_threshold,
            "plan": encode_physical(s.plan).decode(),
            "resolved_plan": encode_physical(resolved_plan).decode()
            if resolved_plan is not None
            else None,
            "task_infos": [
                None
                if t is None or (s.state == STAGE_RUNNING and t.status == "running")
                else {
                    "task_id": t.task_id, "partition": t.partition, "attempt": t.attempt,
                    "status": t.status, "executor_id": t.executor_id,
                    "locations": t.locations,
                }
                for t in task_infos
            ],
            "task_failures": s.task_failures,
            "inputs": {
                str(dep): (
                    # a demoted pipelined producer re-runs EVERY partition
                    # on restore: drop its already-propagated pieces here or
                    # the re-propagation would duplicate them (see above)
                    {"complete": False, "partition_locations": []}
                    if dep in demoted_sids
                    else {
                        "complete": out.complete,
                        "partition_locations": out.partition_locations,
                    }
                )
                for dep, out in s.inputs.items()
            },
        }
    return {
        "job_id": g.job_id,
        "job_name": g.job_name,
        "session_id": g.session_id,
        "status": g.status,
        "error": g.error,
        "queued_at": g.queued_at,
        "start_time": g.start_time,
        "end_time": g.end_time,
        "final_stage_id": g.final_stage_id,
        "output_locations": g.output_locations,
        "trace_id": getattr(g, "trace_id", None),
        "warnings": list(getattr(g, "warnings", [])),
        # serving fair-share identity (docs/serving.md): an adopted job keeps
        # its tenant accounting across a scheduler takeover
        "tenant": getattr(g, "tenant", g.session_id),
        "share_weight": getattr(g, "share_weight", 1.0),
        "tenant_slots": getattr(g, "tenant_slots", 0),
        "aqe_reused_exchanges": getattr(g, "aqe_reused_exchanges", 0),
        "exchange_cache_hits": getattr(g, "exchange_cache_hits", 0),
        # the session knob's verdict must survive a takeover: an adopted
        # job completing on the new owner still registers its exchanges
        "exchange_cache_enabled": getattr(g, "exchange_cache_enabled", False),
        "stages": stages,
    }


def graph_from_json(j: dict) -> ExecutionGraph:
    g = ExecutionGraph.__new__(ExecutionGraph)
    g.job_id = j["job_id"]
    g.job_name = j["job_name"]
    g.session_id = j["session_id"]
    g.status = j["status"]
    g.error = j["error"]
    g.queued_at = j["queued_at"]
    g.start_time = j["start_time"]
    g.end_time = j["end_time"]
    g.final_stage_id = j["final_stage_id"]
    g.output_locations = j["output_locations"]
    g._task_counter = 0
    g.failed_stage_attempts = {}
    # trace context is runtime-only: a restored job traces from scratch
    g.trace_id = j.get("trace_id")
    g.trace_parent = None
    g.trace_spans = []
    g.warnings = list(j.get("warnings", []))
    # __new__ bypasses __init__: the serving fair-share attrs must be set
    # here or the weighted task offer would crash on an adopted job
    g.tenant = j.get("tenant") or g.session_id
    g.share_weight = float(j.get("share_weight", 1.0))
    g.tenant_slots = int(j.get("tenant_slots", 0))
    # AQE state is runtime-only like speculation: restored stages keep their
    # already-resolved (possibly adapted) plans, but NEW resolutions on the
    # adopting scheduler run the static split (ExecutionStage defaults)
    g.aqe_enabled = False
    g.aqe_reused_exchanges = int(j.get("aqe_reused_exchanges", 0))
    # speculation state is runtime-only: a restored/adopted job starts with
    # speculation off (the adopting scheduler's offers would otherwise read
    # a missing attr) — in-flight backups on the old scheduler are moot
    g.speculation_factor = 0.0
    g.spec_cancellations = []
    g.spec_launched = 0
    g.spec_won = 0
    # pipelined shuffle is runtime-only too: restored stages resolve with
    # barrier semantics (ExecutionStage defaults) on the adopting scheduler
    g.pipeline_enabled = False
    g.pipeline_early_resolved = 0
    g.pipeline_hbm_fallbacks = 0
    g.pipeline_deadline_fallbacks = 0
    # megastage counters are runtime stats: counting restarts on adoption
    g.megastage_promoted = 0
    g.megastage_demoted = 0
    # exchange-cache bookkeeping: the adopting scheduler drains stale keys
    # like any other; hit counting restarts (runtime stat, not job state)
    g.exchange_cache_hits = int(j.get("exchange_cache_hits", 0))
    g.exchange_cache_enabled = bool(j.get("exchange_cache_enabled", False))
    g.stale_exchange_keys = []
    g.stages = {}
    for sid_s, sj in j["stages"].items():
        sid = int(sid_s)
        plan = decode_physical(sj["plan"].encode())
        s = ExecutionStage(sid, plan, list(sj["output_links"]))
        s.state = sj["state"]
        s.attempt = sj["attempt"]
        s.partitions = sj["partitions"]
        s.from_cache = bool(sj.get("from_cache", False))
        s.exchange_key = sj.get("exchange_key")
        s.exchange_entry_gen = sj.get("exchange_entry_gen")
        s.broadcast_rows_threshold = int(sj.get("broadcast_rows_threshold", 0))
        if sj["resolved_plan"] is not None:
            s.resolved_plan = decode_physical(sj["resolved_plan"].encode())
        s.task_infos = [
            None
            if t is None
            else TaskInfo(
                t["task_id"], t["partition"], t["attempt"], t["status"],
                t["executor_id"], [dict(l) for l in t["locations"]],
            )
            for t in sj["task_infos"]
        ]
        s.task_failures = list(sj["task_failures"])
        s.inputs = {
            int(dep): StageOutput(
                [
                    [dict(l) for l in locs]
                    for locs in out["partition_locations"]
                ],
                out["complete"],
            )
            for dep, out in sj["inputs"].items()
        }
        g.stages[sid] = s
        g._task_counter = max(
            g._task_counter,
            max(
                (
                    # speculative winners carry an 's'-suffixed counter
                    # (pop_speculative_task); cache-synthesized task infos a
                    # 'c' suffix (satisfy_stage_from_cache)
                    int(t.task_id.rsplit("-", 1)[-1].rstrip("sc"))
                    for t in s.task_infos
                    if t is not None
                ),
                default=0,
            ),
        )
    g.revive()
    return g


class JobStateStore:
    """Persist graphs + scheduler ownership (reference: JobState)."""

    def __init__(self, kv: KeyValueStore, scheduler_id: str):
        self.kv = kv
        self.scheduler_id = scheduler_id

    def save_job(self, g: ExecutionGraph) -> None:
        self.save_job_json(
            g.job_id,
            json.dumps(graph_to_json(g)).encode(),
            json.dumps({"status": g.status, "error": g.error}).encode(),
        )

    def save_job_json(self, job_id: str, graph_payload: bytes,
                      status_payload: bytes) -> None:
        """Write an already-serialized graph snapshot. Split from save_job so
        a caller can encode under its control-plane lock (the graph mutates
        under it) and run the KV I/O after the lock drops."""
        self.kv.put("ExecutionGraph", job_id, graph_payload)
        self.kv.put("JobStatus", job_id, status_payload)

    def load_job(self, job_id: str) -> Optional[ExecutionGraph]:
        raw = self.kv.get("ExecutionGraph", job_id)
        if raw is None:
            return None
        return graph_from_json(json.loads(raw.decode()))

    def try_acquire_job(self, job_id: str, ttl_s: float = 30.0) -> bool:
        """Ownership transfer for scheduler fail-over (cluster/mod.rs:349-352).
        The same owner re-acquiring RENEWS the lease; a different scheduler
        only wins once the previous owner's lease expired."""
        return self.kv.lock("ExecutionGraph", job_id, self.scheduler_id, ttl_s)

    def list_jobs(self) -> list[str]:
        return [k for k, _ in self.kv.scan("ExecutionGraph")]

    def save_ledger(self, job_id: str, ledger: dict) -> None:
        """Persist a completed job's QueryLedger (docs/metrics.md): the
        durable measured-stats record the future CBO reads. Outlives the
        graph's own cleanup path only as long as the job record does —
        remove_job deletes it with the rest."""
        self.kv.put("QueryLedger", job_id, json.dumps(ledger).encode())

    def load_ledger(self, job_id: str) -> Optional[dict]:
        raw = self.kv.get("QueryLedger", job_id)
        if raw is None:
            return None
        try:
            return json.loads(raw.decode())
        except ValueError:
            return None

    def list_ledgers(self) -> list[str]:
        return [k for k, _ in self.kv.scan("QueryLedger")]

    def remove_job(self, job_id: str) -> None:
        self.kv.delete("ExecutionGraph", job_id)
        self.kv.delete("JobStatus", job_id)
        self.kv.delete("QueryLedger", job_id)

    # ---- cross-query exchange cache (docs/serving.md) --------------------------
    def save_exchange_cache(self, entries: list[dict]) -> None:
        """Persist the exchange-cache registry so an HA takeover / restart
        keeps serving cached prefixes. Reader refcounts (consumer pins) are
        deliberately NOT part of the payload — a restoring scheduler has no
        live consumers, so restore drops pins cleanly by construction."""
        self.kv.put("ExchangeCache", "entries", json.dumps(entries).encode())

    def load_exchange_cache(self) -> list[dict]:
        raw = self.kv.get("ExchangeCache", "entries")
        if raw is None:
            return []
        try:
            out = json.loads(raw.decode())
        except ValueError:
            return []
        return out if isinstance(out, list) else []
