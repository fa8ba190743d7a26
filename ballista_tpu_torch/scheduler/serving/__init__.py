"""High-QPS serving layer (docs/serving.md).

Everything before this subsystem treated the engine as a one-query-at-a-time
pipeline; "millions of users" means thousands of concurrent small queries.
The serving layer spans three seams:

* :mod:`fingerprint` — normalized-SQL / plan fingerprints + the digests that
  key the caches (catalog version, table defs, planning-relevant settings).
* :mod:`plan_cache`  — bounded-LRU cache of already-governed physical plan
  templates keyed by fingerprint + catalog version: repeat statements skip
  parse/plan/analyze/govern/verify entirely (the compile service's two-tier
  generalized-key design is the template for the bookkeeping).
* :mod:`result_cache` — byte-budgeted LRU over sealed Arrow results with the
  same invalidation, so identical dashboards / point lookups return without
  touching executors.
* :mod:`exchange_cache` — cross-query exchange materialization cache: sealed
  shuffle outputs of hash-exchange producer stages, keyed content-addressed
  across JOBS, so a repeated sub-plan skips the producer stage entirely (the
  sub-plan cache tier between in-plan exchange reuse and the result cache).
* :mod:`admission`   — bounded admission queue with backpressure (clean
  RESOURCE_EXHAUSTED past the bound, naming the knob) and weighted
  fair-share dequeue across tenants; the TaskManager's weighted round-robin
  task offer rides the same stride-scheduling vtime discipline.
"""
from ballista_tpu_torch.scheduler.serving.admission import AdmissionController
from ballista_tpu_torch.scheduler.serving.exchange_cache import (
    ExchangeCache,
    ExchangeEntry,
    exchange_cache_key,
    exchange_digest,
)
from ballista_tpu_torch.scheduler.serving.fingerprint import (
    fingerprint_bytes,
    fingerprint_sql,
    normalize_sql,
    settings_digest,
    table_defs_digest,
)
from ballista_tpu_torch.scheduler.serving.plan_cache import PlanCache, PlanEntry
from ballista_tpu_torch.scheduler.serving.result_cache import ResultCache

__all__ = [
    "AdmissionController",
    "ExchangeCache",
    "ExchangeEntry",
    "PlanCache",
    "PlanEntry",
    "ResultCache",
    "exchange_cache_key",
    "exchange_digest",
    "fingerprint_bytes",
    "fingerprint_sql",
    "normalize_sql",
    "settings_digest",
    "table_defs_digest",
]
