"""Warm service for precompile hints: a stage's first launches paid behind
the stage before it.

The port of ``ballista_tpu/engine/compile_service.py``. The scheduler
piggybacks the serialized templates of the not-yet-runnable downstream
stages onto task launches (``ballista.precompile.hints``); the executor hands
them here, and a background worker prepares stage N+1 while stage N runs.
For the JAX engine that means compiling stage N+1's XLA programs ahead. Eager
torch compiles nothing, so here "compile" means one *warm run* of the stage's
device program: the program runs once on synthetic bucket-shaped inputs on
the executor's device, synchronises, and its result is dropped. What a warm
pays in place of the real stage is the cost of a first launch: CUDA's lazy
load of each kernel module the program touches, the grouped_sums library
load and per-stream workspace (``ops/grouped_sums.py``), and the caching
allocator's first growth. The settings, metrics and ledger fields keep the
JAX package's names (``ballista.engine.precompile``, ``op.CompileHidden.
time_s``, ``compile_cache.*``), since they cross between the packages.

* **The warmed keys** (``ExecutableCache``): a bounded LRU record of the
  shape keys (program fingerprint, layout of the leaves without their data
  stats, dtype policy, device) a warm ran. A ``StageEntry`` holds no
  program, only the warm's wall time and its source. ``opened`` counts keys
  warmed, ``hits`` real stages that found their key warmed, ``misses`` real
  stages that did not, ``evictions`` records dropped. A real stage that
  finds its key warmed and not yet credited adds the warm's wall to
  ``op.CompileHidden.time_s`` once (``note_hidden``): that wall is an upper
  bound of the first-launch cost it spared, since it also holds the warm's
  own execute. A real stage never waits for a warm: one that is not done
  is simply not credited.

* **Hints** (``CompileService.submit_hints``): JSON lists of ``{stage_id,
  plan, rows}``, deduplicated by digest, each decoded on one worker thread
  (the port is host-bound on one interpreter lock, so a second worker would
  take the task threads' host time rather than hide anything). Hint
  failures are logged and counted but never fail a task.

* **The device window** (``WINDOW``): each real stage resets the allocator's
  peak to measure itself. A real stage holds the window shared while it runs
  its program; a warm holds it alone, and waits for no stage to be inside
  (a bounded wait, past which the warm is declined). So no warm falls in a
  stage's measured peak. Warms run on the worker thread's current stream,
  the device's default stream: the blocks the caching allocator grows for
  them stay in the pool the real stages allocate from.

Stages whose programs bake data content into the run (per-batch string
dictionaries, join build sides, shapes that do not stream) are declined
(``Unhintable``), as the JAX package declines them, and so is a warm whose
estimate would not fit the engine's device budget. Unlike the JAX package,
a warm keeps the stats its synthetic batch carries: it commits to nothing,
so it may take the path the real stage takes (a small-k aggregate through
grouped_sums) where stripped stats (``strip_stats``) would send every group
key down the sorted path and load other kernels.

The shape-generalized background programs of the JAX package's fused
exchange and megastage have no counterpart: their torch programs run as
eager calls over the mesh shards' threads, and nothing here warms them.
"""
from __future__ import annotations

import base64
import contextlib
import hashlib
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ballista_tpu_torch.utils.cache import LoadingCache

log = logging.getLogger("ballista.compile")

# how long a warm waits for the stages inside the device window to leave it
# before the warm is declined
WARM_WAIT_S = 30.0


class Unhintable(Exception):
    """A stage a precompile hint cannot safely warm ahead of time (string
    dictionaries / join builds / non-streamable shapes bake data content into
    the run; a warm over the device budget)."""


class StageEntry:
    """One warmed stage key: the warm's wall time and its source. There is
    no program to keep: eager torch runs the stage anew every time."""

    __slots__ = ("warm_ms", "source", "hidden_counted")

    def __init__(self, warm_ms: float, source: str):
        self.warm_ms = warm_ms
        self.source = source  # "hint"
        self.hidden_counted = False  # its warm_ms was reported hidden once


class ExecutableCache(LoadingCache):
    """The LRU record of warmed stage keys, bounded by its entry count (each
    entry weighs 1). The JAX package's class name, kept because its stats
    (``compile_cache.*``) cross the wire under the same names."""

    def __init__(self, max_entries: int = 256):
        super().__init__(capacity=max_entries)
        self.opened = 0  # keys ever warmed

    def _insert(self, key, value) -> None:  # called with the lock held
        super()._insert(key, value)
        self.opened += 1

    def lookup(self, make_key) -> Optional[StageEntry]:
        """A real stage's lookup, counted as a hit or a miss: the entry under
        ``make_key()``. The key (a plan fingerprint, a fraction of a
        millisecond) is made only when some key is recorded."""
        with self._mu:
            if not self._entries:
                self.misses += 1
                return None
        return self.get(make_key())

    def record(self, key, loader) -> Optional[StageEntry]:
        """Runs ``loader`` (a warm) and records its entry under ``key``,
        unless the key is recorded or being recorded already (then None).
        Counts no hit or miss: those are the real stages' lookups (``get``)."""
        with self._mu:
            if key in self._entries or key in self._inflight:
                return None
            self._inflight[key] = threading.Event()
        try:
            value = loader()
        except BaseException:
            with self._mu:
                self._inflight.pop(key).set()
            raise
        with self._mu:
            self._insert(key, value)
            self._inflight.pop(key).set()
        return value

    def stats(self) -> dict[str, int]:
        with self._mu:
            return {
                "opened": self.opened,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "inflight": len(self._inflight),
            }


class DeviceWindow:
    """Keeps warms out of the real stages' measured windows: stages share
    the window, a warm takes it alone once no stage is inside. Stages never
    wait for a warm that is only waiting, so nesting and stages that wait on
    one another (a mesh group's collectives) cannot deadlock with it."""

    def __init__(self):
        self._cv = threading.Condition()
        self._stages = 0
        self._warming = False

    @contextlib.contextmanager
    def stage(self):
        with self._cv:
            while self._warming:
                self._cv.wait()
            self._stages += 1
        try:
            yield
        finally:
            with self._cv:
                self._stages -= 1
                self._cv.notify_all()

    @contextlib.contextmanager
    def warm(self, timeout: float = WARM_WAIT_S):
        with self._cv:
            if not self._cv.wait_for(lambda: not self._stages and not self._warming, timeout):
                raise Unhintable(f"device busy with stages for {timeout:g} s")
            self._warming = True
        try:
            yield
        finally:
            with self._cv:
                self._warming = False
                self._cv.notify_all()


WINDOW = DeviceWindow()


class CompileService:
    """Process-wide warm pipeline: the record of warmed keys, the background
    hint worker and counters. One per process (``get_service``): every
    engine instance and task slot of the process shares it."""

    def __init__(self, workers: int = 1):
        self.cache = ExecutableCache()
        self._pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="warm")
        self._mu = threading.Lock()
        self._hints_seen: set[str] = set()
        # hint-pipeline tasks submitted but not finished (decodes + warms)
        self._pending_hint_tasks = 0
        self.hint_submitted = 0
        self.hint_compiled = 0
        self.hint_skipped = 0
        self.hint_failed = 0
        self.hidden_count = 0
        self.hidden_ms = 0.0
        self.warm_ms = 0.0
        # memory_reserved before the first warm and after the latest
        self.reserved: list = []

    # ---- accounting -----------------------------------------------------------
    def note_warm(self, seconds: float, reserved_before: int = 0,
                  reserved_after: int = 0) -> None:
        """Account one warm run: its wall, and on a card the allocator's
        reserved bytes just before and after it (logged, and kept as the
        first warm's before and the latest warm's after)."""
        with self._mu:
            self.warm_ms += seconds * 1000.0
            if not self.reserved:
                self.reserved = [reserved_before, reserved_after]
            self.reserved[1] = reserved_after
        log.info("warm run: %.3f ms, memory_reserved %d -> %d bytes", seconds * 1000.0,
                 reserved_before, reserved_after)

    def note_hidden(self, entry: StageEntry) -> float:
        """Account one real stage that found its key warmed. The warm's wall
        counts as HIDDEN exactly once, however many stages share the key.
        Returns the ms to attribute."""
        with self._mu:
            self.hidden_count += 1
            if entry.hidden_counted:
                return 0.0
            entry.hidden_counted = True
            self.hidden_ms += entry.warm_ms
            return entry.warm_ms

    def stats(self) -> dict:
        with self._mu:
            out = {
                "hint_submitted": self.hint_submitted,
                "hint_compiled": self.hint_compiled,
                "hint_skipped": self.hint_skipped,
                "hint_failed": self.hint_failed,
                "hidden_count": self.hidden_count,
                "hidden_ms": round(self.hidden_ms, 3),
                "hint_pending": self._pending_hint_tasks,
                "warm_ms": round(self.warm_ms, 3),
                "reserved_before_warms": self.reserved[0] if self.reserved else 0,
                "reserved_after_warms": self.reserved[1] if self.reserved else 0,
            }
        out.update({f"cache_{k}": v for k, v in self.cache.stats().items()})
        return out

    def reset_stats(self) -> None:
        with self._mu:
            self.hint_submitted = self.hint_compiled = 0
            self.hint_skipped = self.hint_failed = 0
            self.hidden_count = 0
            self.hidden_ms = self.warm_ms = 0.0
            self.reserved = []
        with self.cache._mu:
            self.cache.hits = self.cache.misses = 0
            self.cache.evictions = self.cache.opened = 0

    def clear(self) -> None:
        self.cache.clear()
        with self._mu:
            self._hints_seen.clear()

    # ---- precompile hints -------------------------------------------------------
    def submit_hints(self, payload: str, props: dict, device: Optional[str] = None) -> int:
        """Queue scheduler precompile hints (JSON list of ``{stage_id, plan:
        base64, rows}``) for background warm runs on ``device`` (None:
        ``cuda``). Never raises: malformed payloads count as failures and the
        task that carried them proceeds untouched."""
        try:
            hints = json.loads(payload)
        except ValueError:
            with self._mu:
                self.hint_failed += 1
            log.warning("malformed precompile hint payload (not JSON)")
            return 0
        if not isinstance(hints, list):
            with self._mu:
                self.hint_failed += 1
            return 0
        n = 0
        for hint in hints:
            if not isinstance(hint, dict):
                continue
            digest = hashlib.sha1(
                json.dumps([hint, device], sort_keys=True).encode()
            ).hexdigest()
            with self._mu:
                if digest in self._hints_seen:
                    continue  # every task of the launching stage repeats them
                if len(self._hints_seen) > 8192:
                    self._hints_seen.clear()
                self._hints_seen.add(digest)
                self.hint_submitted += 1
                self._pending_hint_tasks += 1
            n += 1
            self._pool.submit(self._run_hint, hint, dict(props), device)
        return n

    def note_pending(self, delta: int) -> None:
        with self._mu:
            self._pending_hint_tasks = max(0, self._pending_hint_tasks + delta)

    def pending_hint_work(self) -> int:
        """Hint-pipeline tasks submitted but not yet finished (decodes and
        warms)."""
        with self._mu:
            return self._pending_hint_tasks

    def wait_idle(self, timeout: float) -> bool:
        """Waits up to ``timeout`` for the hint work to drain; True if it did."""
        deadline = time.time() + timeout
        while self.pending_hint_work() and time.time() < deadline:
            time.sleep(0.01)
        return not self.pending_hint_work()

    def _run_hint(self, hint: dict, props: dict, device: Optional[str]) -> None:
        try:
            self._run_hint_inner(hint, props, device)
        finally:
            self.note_pending(-1)

    def _run_hint_inner(self, hint: dict, props: dict, device: Optional[str]) -> None:
        try:
            from ballista_tpu_torch.config import (
                BALLISTA_TPU_MIN_DEVICE_ROWS,
                BALLISTA_TPU_NATIVE_DTYPES,
                BALLISTA_TPU_STREAM_DEVICE_ROWS,
                BallistaConfig,
            )
            from ballista_tpu_torch.engine.torch_engine import TorchEngine
            from ballista_tpu_torch.ops import kernels_torch as KT
            from ballista_tpu_torch.plan.serde import decode_physical

            plan = decode_physical(base64.b64decode(hint["plan"]))
            config = BallistaConfig(props)
            # the dtype policy is module state (kernels_torch.NATIVE_DTYPES)
            # that run-time code reads; task engines set it per task, and a
            # BACKGROUND warm must never flip it under a foreground stage. A
            # hint whose session policy differs from the process's current one
            # is declined (its key would differ anyway). The JAX package's
            # second policy, pallas_segsum, has no module state here.
            if bool(config.get(BALLISTA_TPU_NATIVE_DTYPES)) != KT.NATIVE_DTYPES:
                with self._mu:
                    self.hint_skipped += 1
                log.debug("precompile hint skipped: dtype policy differs from "
                          "the process's active policy")
                return
            engine = TorchEngine(config, device=device)
            rows = int(hint.get("rows", 0) or 0)
            stream_rows = int(config.get(BALLISTA_TPU_STREAM_DEVICE_ROWS) or (1 << 20))
            # candidate input buckets: the scheduler's pass-through row
            # estimate (capped at the chunk-coalescing budget) plus the
            # minimum bucket, where tiny stages and short partitions land
            chunk_buckets = {KT.bucket_size(1)}
            if rows > 0:
                chunk_buckets.add(KT.bucket_size(min(rows, stream_rows)))
            state_buckets = {KT.bucket_size(1)}
            min_rows = int(config.get(BALLISTA_TPU_MIN_DEVICE_ROWS) or 0)
            if min_rows:
                # a stage under min_device_rows runs on the host kernels and
                # launches nothing: warm at the least bucket that reaches the
                # device instead
                least = KT.bucket_size(min_rows)
                chunk_buckets = {max(b, least) for b in chunk_buckets}
                state_buckets = {max(b, least) for b in state_buckets}

            def warm_one(*spec):
                # one pool task per program, smallest bucket first
                try:
                    if engine._precompile_one(*spec):
                        with self._mu:
                            self.hint_compiled += 1
                except Unhintable as e:
                    with self._mu:
                        self.hint_skipped += 1
                    log.debug("warm run skipped: %s", e)
                except Exception as e:  # noqa: BLE001 - advisory
                    with self._mu:
                        self.hint_failed += 1
                    log.warning("warm run failed: %s", e)
                finally:
                    self.note_pending(-1)

            def submit_one(fn, *spec):
                self.note_pending(1)
                self._pool.submit(warm_one, *spec)

            submitted, reason = engine.precompile_stage_template(
                plan, sorted(chunk_buckets), sorted(state_buckets), submit=submit_one,
            )
            if reason is not None:
                with self._mu:
                    self.hint_skipped += 1
                log.debug("precompile hint for stage %s skipped: %s",
                          hint.get("stage_id"), reason)
            else:
                log.debug("precompile hint for stage %s: %d warm runs submitted",
                          hint.get("stage_id"), submitted)
        except Unhintable as e:
            with self._mu:
                self.hint_skipped += 1
            log.debug("precompile hint skipped: %s", e)
        except Exception as e:  # noqa: BLE001 - hints must NEVER fail a task
            with self._mu:
                self.hint_failed += 1
            log.warning("precompile hint failed (the stage runs cold): %s", e)


_SERVICE: Optional[CompileService] = None
_SERVICE_MU = threading.Lock()


def get_service() -> CompileService:
    global _SERVICE
    if _SERVICE is None:
        with _SERVICE_MU:
            if _SERVICE is None:
                _SERVICE = CompileService()
    return _SERVICE


# ---- shape-generalized signatures --------------------------------------------------
def shape_signature(enc) -> tuple:
    """Layout-only signature of an ``EncodedBatch``: shapes, dtypes, null
    layout and decimal scale — WITHOUT the data-derived stats (int ranges,
    subset-sum bounds). A warm run keys under it, and every real batch that
    shares it finds the key.

    String columns: a catalog-SHARED dictionary contributes its
    content-addressed dict_id. A per-batch dictionary contributes a content
    marker no warmed key ever carries (hints decline those stages), so it
    can never alias one."""
    sig: list = [enc.n_pad, (), ()]
    i = 0
    for ci, (meta, _f) in enumerate(zip(enc.col_meta, enc.schema)):
        dt, has_null, dictionary, scale = meta
        did = enc.dict_ids[ci] if getattr(enc, "dict_ids", None) else None
        if dictionary is not None and did:
            sig.append((dt.value, has_null, "dict", did))
        elif dictionary is not None:
            sig.append((dt.value, has_null, "dict", len(dictionary), "content"))
        else:
            sig.append((dt.value, has_null, None, scale,
                        str(getattr(enc.arrays[i], "dtype", ""))))
        i += 2 if has_null else 1
    return tuple(sig)


def strip_stats(enc) -> None:
    """Remove every data-derived stat from a synthetic ``EncodedBatch``: the
    JAX package traces its hint programs so, to commit to nothing a real
    batch could violate. A torch warm commits to nothing and does not call
    it (see the module docstring); it is kept for the packages' parity."""
    enc.int_ranges = None
    enc.ssums = None
    enc._sig = None


def synthetic_batch(schema, rows: int, dict_refs=None):
    """A bucket-shaped stand-in batch for a warm run. Values are ``arange``
    (unique per column) so join/group prep never degenerates into duplicate
    runs; the result of the run is dropped.

    String columns with a catalog-SHARED dictionary (``dict_refs`` names the
    registered dict_id, docs/strings.md) ARE hintable: the synthetic column
    cycles the dictionary's own values. Strings WITHOUT a shared dictionary
    stay Unhintable: their per-batch dictionaries are data a synthetic batch
    cannot reproduce."""
    import pyarrow as pa

    from ballista_tpu_torch.ops.batch import Column, ColumnBatch
    from ballista_tpu_torch.plan.schema import DataType

    cols = []
    for f in schema:
        if f.dtype is DataType.STRING:
            from ballista_tpu_torch.engine.dictionaries import REGISTRY, lookup_ref

            did = lookup_ref(dict_refs, f.name)
            values = REGISTRY.get(did) if did else None
            if values is None or len(values) == 0:
                raise Unhintable(
                    f"string column {f.name!r} pins a per-batch dictionary "
                    f"(no shared dictionary registered; see "
                    f"ballista.engine.max_dict_size)"
                )
            sample = values[np.arange(rows) % len(values)]
            cols.append(Column(DataType.STRING, pa.array(sample, type=pa.string()),
                               dict_id=did))
            continue
        np_dt = f.dtype.to_numpy()
        data = np.arange(rows) % 2 if f.dtype is DataType.BOOL else np.arange(rows)
        cols.append(Column(f.dtype, data.astype(np_dt), None))
    return ColumnBatch(schema, cols, num_rows=rows)
