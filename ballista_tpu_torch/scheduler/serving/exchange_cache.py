"""Cross-query exchange materialization cache (docs/serving.md).

The planner's exchange reuse dedupes identical hash-exchange subtrees WITHIN one
plan; at dashboard traffic the dominant redundant work is re-scanning and
re-shuffling the same subtrees across JOBS — the shared CTE, the common
dimension-filter-then-repartition prefix, statement after statement. This
module promotes that reuse to a scheduler-side cross-job cache of the
materialized intermediates (the Nectar idea, Gunda et al., OSDI '10): when a
job completes, every hash-exchange producer stage registers its SEALED piece
locations + measured sizes under a content-addressed key; a later job whose
stage split produces the same key SKIPS the producer stage entirely — its
``UnresolvedShuffleExec`` resolves immediately against the cached locations,
and AQE's coalesce/skew rules run unchanged off the cached measured sizes.

The key is content-addressed so a hit can never be wrong by construction:

* the exchange subtree's serde bytes (input plan + partitioning exprs +
  partition count — the planner's in-plan ``reuse_key`` generalized). Dict refs
  ride the serde and carry the catalog-version epoch (``table.col@vN:sha``),
  so a re-registered dictionary re-keys automatically;
* the table-defs digest (schema, file groups AND row counts — the
  scheduler's catalog-version signal: any re-register or data refresh is a
  structural miss, no explicit invalidation needed);
* the cluster/device signature (device count + kinds): plans are governed
  and ICI-promoted against the inventory, so an inventory change re-keys.

Only LEAF producer stages (no upstream shuffle dependencies) are cached:
their subtree serde is job-independent, and the recompute fallback is
exactly the existing lineage machinery — a cached stage is reconstructed in
the consumer's graph as an already-SUCCESSFUL stage with synthetic task
infos, so executor loss, FetchFailed rollback and ``rerun_lost_partitions``
apply to it unchanged (the plan template is intact; re-running it is
byte-identical by the engine contract).

Lifetime layer (the part that does not exist anywhere else):

* **pins** — a registered entry pins the producer JOB's shuffle data:
  ``clean_job_data`` defers while ``job_pinned`` holds, and the eviction /
  invalidation / TTL-expiry of the last entry fires ``on_unpin`` so the
  deferred cleanup finally runs;
* **reader refcounts** — a consumer job holds a lease on every adopted entry
  from adoption to job end; entries with live readers are never evicted
  (the byte budget may transiently overshoot), and an invalidated entry with
  readers keeps its job pin as a ZOMBIE until the readers drain — the
  consumer mid-fetch must not have the files deleted under it;
* **invalidation** — executor loss / quarantine / drain drops every entry
  referencing that executor (in-flight consumers fall back to recomputing
  the producer via FetchFailed lineage); a consumer-observed fetch failure
  on a cached stage invalidates its key (the recompute writes new
  attempt-suffixed paths the entry does not know);
* **HA restore** — entries persist in the state store; a restarted scheduler
  restores them with reader refcounts DROPPED (the consumers died with the
  old process; restored graphs re-run normally) and pins rebuilt from the
  restored entries.
"""
from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ballista_tpu_torch.analysis import concurrency
from ballista_tpu_torch.plan import physical as P


def exchange_digest(stage_plan: P.ShuffleWriterExec) -> Optional[str]:
    """Content digest of a hash-exchange producer stage's subtree, or None
    when the stage is not cacheable: merge stages (no hash partitioning —
    their output is positional, not key-addressed), non-leaf stages (their
    serde bytes embed job-local upstream stage ids), and subtrees the serde
    cannot encode (in-memory test scans) all decline. The digest is the
    serde JSON of (input, partitioning exprs, n) — byte-stable by the PV006
    fixed-point invariant, and inclusive of dict refs (catalog epochs)."""
    if stage_plan.partitioning is None:
        return None
    if any(
        isinstance(n, (P.UnresolvedShuffleExec, P.ShuffleReaderExec))
        for n in P.walk_physical(stage_plan.input)
    ):
        return None
    from ballista_tpu_torch.plan.serde import expr_to_json, physical_to_json

    try:
        payload = json.dumps(
            {
                "in": physical_to_json(stage_plan.input),
                "exprs": [expr_to_json(e) for e in stage_plan.partitioning.exprs],
                "n": stage_plan.partitioning.n,
            },
            sort_keys=True,
        )
    except Exception:  # noqa: BLE001 - unserializable subtree: not cacheable
        return None
    return hashlib.sha256(payload.encode()).hexdigest()


def exchange_cache_key(
    digest: str, table_defs_digest: str, n_devices: int, device_kinds
) -> str:
    """Full cross-job cache key: subtree digest + catalog signal + cluster
    signature (mirrors the plan cache's key discipline, docs/serving.md)."""
    sig = ",".join(sorted(device_kinds))
    return hashlib.sha256(
        f"{digest}|{table_defs_digest}|{n_devices}|{sig}".encode()
    ).hexdigest()


def _new_gen() -> str:
    import uuid

    return uuid.uuid4().hex[:12]


@dataclass
class ExchangeEntry:
    """One registered, sealed exchange materialization."""

    key: str
    job_id: str        # producer job: its shuffle dirs hold the pieces
    stage_id: int      # producer stage id in THAT job (diagnostics)
    schema_json: str   # exchanged schema (the PV008 drift guard)
    n_partitions: int  # output partitions every consumer reader expects
    # per MAP partition, in partition order: the synthetic task info a
    # consumer graph reconstructs the producer stage from —
    # {"executor_id": ..., "locations": [writer-format piece dicts incl.
    #  host/flight_port/num_rows/num_bytes]}
    tasks: list = field(default_factory=list)
    total_bytes: int = 0
    created_at: float = 0.0
    # per-entry TTL override from the REGISTERING session
    # (ballista.serving.exchange_cache_ttl_s); 0 = the cache's default
    ttl_s: float = 0.0
    # generation token: a stale report from a consumer that adopted THIS
    # entry must never kill a fresh replacement re-registered under the
    # same key after a recompute (invalidate_key matches on it)
    gen: str = field(default_factory=_new_gen)
    hits: int = 0
    readers: int = 0

    def executor_ids(self) -> set:
        return {t.get("executor_id", "") for t in self.tasks}

    def to_json(self) -> dict:
        return {
            "key": self.key, "job_id": self.job_id, "stage_id": self.stage_id,
            "schema_json": self.schema_json, "n_partitions": self.n_partitions,
            "tasks": self.tasks, "total_bytes": self.total_bytes,
            "created_at": self.created_at, "ttl_s": self.ttl_s,
            "gen": self.gen,
        }

    @staticmethod
    def from_json(j: dict) -> "ExchangeEntry":
        # readers deliberately reset: HA restore drops pins' refcounts
        # cleanly — the old scheduler's consumer jobs are gone
        e = ExchangeEntry(
            j["key"], j["job_id"], int(j["stage_id"]), j["schema_json"],
            int(j["n_partitions"]), [dict(t) for t in j["tasks"]],
            int(j.get("total_bytes", 0)), float(j.get("created_at", 0.0)),
            float(j.get("ttl_s", 0.0)),
        )
        if j.get("gen"):
            e.gen = j["gen"]
        return e


class ExchangeCache:
    """Byte-budgeted, TTL'd LRU over sealed exchange materializations.

    Same bookkeeping discipline as the plan cache / compile cache: explicit
    hits/misses/evictions/invalidations counters, bounded, thread-safe.
    ``on_unpin(job_id)`` fires when the LAST entry (live or zombie) pinning
    a producer job disappears — the scheduler posts the deferred
    ``JobDataClean`` there."""

    def __init__(
        self,
        budget_bytes: int = 256 * 1024 * 1024,
        ttl_s: float = 600.0,
        on_unpin: Optional[Callable[[str], None]] = None,
    ):
        self.budget_bytes = max(0, budget_bytes)
        self.ttl_s = ttl_s
        self.on_unpin = on_unpin
        self._mu = concurrency.make_lock("ExchangeCache._mu")
        self._entries = concurrency.guarded_dict("ExchangeCache._entries", self._mu)
        # LRU order, oldest first
        self._order = concurrency.guarded_list("ExchangeCache._order", self._mu)
        # invalidated/evicted entries still read by a live consumer: their
        # job pins survive until the readers drain (files must outlive reads)
        self._zombies = concurrency.guarded_dict("ExchangeCache._zombies", self._mu)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.expirations = 0
        self.registered = 0
        self.oversize_skips = 0
        self.tasks_skipped = 0

    # ---- registration ------------------------------------------------------------
    def register(self, entry: ExchangeEntry) -> bool:
        """Register a sealed exchange; returns False when the entry alone
        exceeds the byte budget (never cached — one giant exchange must not
        evict a thousand dashboard prefixes)."""
        if self.budget_bytes and entry.total_bytes > self.budget_bytes:
            with self._mu:
                self.oversize_skips += 1
            return False
        unpin: list[str] = []
        with self._mu:
            old = self._entries.pop(entry.key, None)
            if old is not None:
                self._order.remove(entry.key)
            # insert BEFORE retiring the replaced entry: when old and new
            # share a producer job (two identical subtrees in one plan
            # registering sequentially), the pin check must see the new
            # entry or a spurious unpin would release the job's deferred
            # cleanup out from under the pieces the new entry names
            self._entries[entry.key] = entry
            self._order.append(entry.key)
            self.registered += 1
            if old is not None:
                self._retire_locked(old, unpin)
            self._evict_over_budget_locked(unpin, keep=entry.key)
        self._fire_unpins(unpin)
        return True

    @concurrency.guarded_by("_mu")
    def _evict_over_budget_locked(self, unpin: list[str], keep: Optional[str] = None) -> None:
        if not self.budget_bytes:
            return
        total = sum(e.total_bytes for e in self._entries.values())
        for key in list(self._order):
            if total <= self.budget_bytes:
                break
            e = self._entries[key]
            if e.readers > 0 or key == keep:
                # leased by a live consumer — or the entry this very call
                # registered — never evicted; the budget may transiently
                # overshoot while every other entry is leased
                continue
            self._order.remove(key)
            self._entries.pop(key)
            total -= e.total_bytes
            self.evictions += 1
            self._retire_locked(e, unpin)

    # ---- adoption ----------------------------------------------------------------
    def acquire(self, key: str, now: Optional[float] = None) -> Optional[ExchangeEntry]:
        """Look up + lease an entry for a consumer job (readers += 1); the
        job MUST release(entry) on every exit path. Expired entries drop
        here (a miss). Hit accounting is deferred to ``note_adopted`` — an
        acquired entry the caller then REJECTS (dead executors, shape
        mismatch) must count as a miss, not a hit."""
        if now is None:
            now = time.time()
        unpin: list[str] = []
        out = None
        with self._mu:
            e = self._entries.get(key)
            if e is not None and self._expired_locked(e, now):
                self._entries.pop(key)
                self._order.remove(key)
                self.expirations += 1
                self._retire_locked(e, unpin)
                e = None
            if e is None:
                self.misses += 1
            else:
                self._order.remove(key)
                self._order.append(key)
                e.readers += 1
                out = e
        self._fire_unpins(unpin)
        return out

    def note_adopted(self, entry: ExchangeEntry) -> None:
        """The consumer graph really reconstructed a stage from this entry:
        only now do the hit / tasks-skipped counters (the CI-gated hit rate
        and /api/metrics series) move."""
        with self._mu:
            self.hits += 1
            entry.hits += 1
            self.tasks_skipped += len(entry.tasks)

    def note_rejected(self) -> None:
        """An acquired entry failed validation (non-schedulable executors,
        shape mismatch): the producer stage runs — account a miss."""
        with self._mu:
            self.misses += 1

    def release(self, entry: ExchangeEntry) -> None:
        """A consumer job holding a lease on THIS entry ended (any outcome).
        Releases target the leased ENTRY object, never its key: the key may
        meanwhile name a fresh replacement entry (recompute re-registered),
        and decrementing that one would both leak this zombie's pin forever
        and strip the replacement's readers-protection mid-read."""
        unpin: list[str] = []
        with self._mu:
            if entry.readers > 0:
                entry.readers -= 1
            if entry.readers <= 0 and self._entries.get(entry.key) is not entry:
                # retired while leased (zombie): the last lease drained —
                # drop the zombie record and resolve the job pin
                zs = self._zombies.get(entry.key, [])
                if entry in zs:
                    zs.remove(entry)
                    if not zs:
                        self._zombies.pop(entry.key, None)
                    self._maybe_unpin_locked(entry.job_id, unpin)
        self._fire_unpins(unpin)

    @concurrency.guarded_by("_mu")
    def _expired_locked(self, e: ExchangeEntry, now: float) -> bool:
        ttl = e.ttl_s if e.ttl_s > 0 else self.ttl_s
        return ttl > 0 and now - e.created_at > ttl

    # ---- invalidation ------------------------------------------------------------
    def invalidate_executor(self, executor_id: str) -> int:
        """Drop every entry whose pieces live (partly) on this executor —
        loss, quarantine or drain start. Consumers mid-read keep the zombie
        pin; NEW jobs miss and recompute."""
        return self._invalidate(lambda e: executor_id in e.executor_ids())

    def invalidate_key(self, key: str, gen: Optional[str] = None) -> int:
        """A consumer observed a fetch failure on this cached exchange: the
        recompute writes new attempt-suffixed paths the entry cannot name.
        ``gen`` scopes the drop to the entry GENERATION the consumer
        adopted — a stale report drained after a recompute re-registered
        the key must not kill the fresh entry (and fire its producer's
        deferred cleanup early). None = drop whatever is there (validation
        failures at adoption, where the caller holds the current entry)."""
        return self._invalidate(
            lambda e: e.key == key and (gen is None or e.gen == gen)
        )

    def invalidate_job(self, job_id: str) -> int:
        return self._invalidate(lambda e: e.job_id == job_id)

    def _invalidate(self, pred) -> int:
        unpin: list[str] = []
        n = 0
        with self._mu:
            for key in [k for k, e in self._entries.items() if pred(e)]:
                e = self._entries.pop(key)
                self._order.remove(key)
                self.invalidations += 1
                n += 1
                self._retire_locked(e, unpin)
        self._fire_unpins(unpin)
        return n

    def expire(self, now: Optional[float] = None) -> int:
        """TTL sweep, driven from the scheduler's expiry loop. Runs even
        with the global TTL off — entries may carry per-session TTLs."""
        if now is None:
            now = time.time()
        unpin: list[str] = []
        n = 0
        with self._mu:
            for key in [
                k for k, e in self._entries.items()
                if self._expired_locked(e, now) and e.readers <= 0
            ]:
                e = self._entries.pop(key)
                self._order.remove(key)
                self.expirations += 1
                n += 1
                self._retire_locked(e, unpin)
        self._fire_unpins(unpin)
        return n

    # ---- pins --------------------------------------------------------------------
    def job_pinned(self, job_id: str) -> bool:
        """Does any live or zombie entry still reference this producer job's
        shuffle data? ``clean_job_data`` defers while this holds."""
        with self._mu:
            return self._job_pinned_locked(job_id)

    @concurrency.guarded_by("_mu")
    def _job_pinned_locked(self, job_id: str) -> bool:
        if any(e.job_id == job_id for e in self._entries.values()):
            return True
        return any(
            z.job_id == job_id for zs in self._zombies.values() for z in zs
        )

    @concurrency.guarded_by("_mu")
    def _retire_locked(self, e: ExchangeEntry, unpin: list[str]) -> None:
        """An entry left the live map: keep a zombie while readers hold the
        lease, else resolve the job pin."""
        if e.readers > 0:
            self._zombies.setdefault(e.key, []).append(e)
        else:
            self._maybe_unpin_locked(e.job_id, unpin)

    @concurrency.guarded_by("_mu")
    def _maybe_unpin_locked(self, job_id: str, unpin: list[str]) -> None:
        if not self._job_pinned_locked(job_id) and job_id not in unpin:
            unpin.append(job_id)

    def _fire_unpins(self, job_ids: list[str]) -> None:
        if self.on_unpin is None:
            return
        for job_id in job_ids:
            try:
                self.on_unpin(job_id)
            except Exception:  # noqa: BLE001 - cleanup is best-effort
                pass

    # ---- introspection / persistence ---------------------------------------------
    def pinned_jobs(self) -> set:
        with self._mu:
            out = {e.job_id for e in self._entries.values()}
            out.update(z.job_id for zs in self._zombies.values() for z in zs)
            return out

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def stats(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._entries),
                "bytes": sum(e.total_bytes for e in self._entries.values()),
                "budget_bytes": self.budget_bytes,
                "ttl_s": self.ttl_s,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "expirations": self.expirations,
                "registered": self.registered,
                "oversize_skips": self.oversize_skips,
                "tasks_skipped": self.tasks_skipped,
                "pinned_jobs": len(
                    {e.job_id for e in self._entries.values()}
                    | {z.job_id for zs in self._zombies.values() for z in zs}
                ),
                "readers": sum(e.readers for e in self._entries.values()),
            }

    def to_json(self) -> list[dict]:
        with self._mu:
            return [self._entries[k].to_json() for k in self._order]

    def load_json(self, entries: list[dict]) -> int:
        """HA restore: rebuild the live map from persisted entries. Reader
        refcounts come back ZERO (from_json drops them) — the restoring
        scheduler has no live consumers yet, so pins reflect only the
        entries themselves."""
        n = 0
        for j in entries:
            try:
                e = ExchangeEntry.from_json(j)
            except (KeyError, TypeError, ValueError):
                continue
            if self.register(e):
                n += 1
        with self._mu:
            self.registered -= n  # restores are not new registrations
        return n
