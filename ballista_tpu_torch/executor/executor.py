"""Executor core: run one shuffle-writing stage task.

Reference analog: ``Executor::execute_query_stage``
(``arrow-ballista: ballista/executor/src/executor.rs:142-168``) — decode the
stage plan, execute the subtree for one input partition, materialize shuffle
output, report status; cancellable; metrics recorded per stage.

Stages run on the engine the task's props name (``ballista.executor.backend``,
else the executor's own): ``torch`` on the executor's device, or the host
engine ``numpy``. Launch props may carry the scheduler's precompile hints
(``ballista.precompile.hints``): a torch task hands them to the process's
compile service (``engine/compile_service.py``), which warms the hinted
downstream stages on the executor's device while this one runs, and once the
task has written its output it hints its direct consumers again with the
rows it measured. Hints are advisory: a bad one is counted and never fails a
task. A torch task reports the warmed-key record's activity while it ran
(``compile_cache.{opened,hits,misses,evictions}``, process-wide, so
concurrent tasks share it) and the
grouped_sums calls it made (``op.GroupedSums.calls``) and the kernel
launches they took on the card (``op.GroupedSums.launches``, 0 on the CPU),
its mesh programs' shard threads included, and those calls by shape
(``op.GroupedSums.shape.<rows>x<k>x<columns>.<dtype>``), with its metrics.
"""
from __future__ import annotations

import logging
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

from ballista_tpu_torch.config import BallistaConfig, ExecutorConfig
from ballista_tpu_torch.engine.engine import create_engine
from ballista_tpu_torch.errors import Cancelled, FetchFailed
from ballista_tpu_torch.plan.physical import ShuffleWriterExec
from ballista_tpu_torch.plan.serde import decode_physical
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.shuffle.writer import write_shuffle_partitions

log = logging.getLogger("ballista.executor")


@dataclass
class RunningTask:
    task_id: str
    job_id: str = ""
    cancelled: threading.Event = field(default_factory=threading.Event)


class Executor:
    def __init__(self, executor_id: str, config: ExecutorConfig, work_dir: str, metrics_collector=None):
        from ballista_tpu_torch.executor.metrics import LoggingMetricsCollector

        self.executor_id = executor_id
        self.config = config
        self.work_dir = work_dir
        self.backend = config.backend
        self.device = config.device
        self.metrics_collector = metrics_collector or LoggingMetricsCollector()
        self._running: dict[str, RunningTask] = {}
        self._lock = threading.Lock()
        # stages with an INLINE exchange (co-scheduled fused stage groups) share
        # one engine across their tasks so the exchange computes once and later
        # tasks read the cached partitions; serialized via a per-stage lock
        self._stage_engines: dict[tuple, tuple] = {}  # key -> (engine, lock)
        # job -> object-store base url of its uploaded shuffle pieces, so
        # job-data cleanup can delete the <base>/<job>/ prefix too (the
        # bucket must not grow without bound across jobs)
        self._job_object_urls: dict[str, str] = {}
        # orphaned-shuffle sweeper state (docs/fault_tolerance.md): last
        # LOCAL activity per job (task execution, shuffle write, Flight
        # serve) — the sweeper's pin-awareness: a job whose pieces are still
        # being consumed (a cached cross-job exchange prefix) stays alive
        # even when its dir mtime is old. Bounded; evicting an idle entry
        # only removes leniency, never correctness (lineage recovers).
        self._job_last_active: dict[str, float] = {}
        # total bytes the sweeper reclaimed from orphaned job dirs
        # (rides heartbeat metrics onto the scheduler's /api/metrics)
        self.reclaimed_bytes = 0

    # ---- task execution ------------------------------------------------------------
    def execute_task(self, task: pb.TaskDefinition, props: Optional[dict] = None) -> pb.TaskStatus:
        from ballista_tpu_torch.obs import tracing as obs

        rt = RunningTask(task.task_id, task.partition.job_id)
        with self._lock:
            self._running[task.task_id] = rt
        self.note_job_activity(task.partition.job_id)
        start = time.time()
        status = pb.TaskStatus(
            task_id=task.task_id,
            partition=task.partition,
            stage_attempt=task.stage_attempt,
            task_attempt=task.task_attempt,
            executor_id=self.executor_id,
            launch_time_ms=task.launch_time_ms,
            start_time_ms=int(start * 1000),
        )
        # trace context rides the launch props; absent -> untraced (zero cost)
        trace_id = (props or {}).get(obs.TRACE_ID_PROP)
        task_span = None
        collector = None
        if trace_id:
            collector = obs.SpanCollector()
            task_span = collector.start(
                f"task stage-{task.partition.stage_id} p{task.partition.partition_id}",
                trace_id=trace_id,
                parent_id=(props or {}).get(obs.PARENT_PROP) or None,
                service="executor",
                attrs={
                    "task_id": task.task_id,
                    "executor_id": self.executor_id,
                    "stage_attempt": task.stage_attempt,
                },
            )
            # engine + shuffle writer/reader all run on this thread
            obs.set_ambient(collector, trace_id, task_span.span_id)
        try:
            from ballista_tpu_torch.utils import faults

            # chaos hooks: a ballista.faults.schedule session setting rides
            # the launch props and installs process-wide (multi-process
            # chaos runs); then the task-execution fault point itself
            # (fail_once/fail_n -> retryable failure, hang/slow -> stall)
            faults.maybe_install_from_props(props)
            faults.check("task.execute", {
                "task_id": task.task_id,
                "job_id": task.partition.job_id,
                "stage_id": task.partition.stage_id,
                "partition": task.partition.partition_id,
                "executor_id": self.executor_id,
                "task_attempt": task.task_attempt,
            })
            plan = decode_physical(bytes(task.plan))
            assert isinstance(plan, ShuffleWriterExec)
            config = BallistaConfig(props or {})
            from ballista_tpu_torch.config import BALLISTA_SHUFFLE_SPILL_DIR

            if not config.get(BALLISTA_SHUFFLE_SPILL_DIR):
                import os

                config.set(
                    BALLISTA_SHUFFLE_SPILL_DIR, os.path.join(self.work_dir, "_fetch")
                )
            backend = (
                props.get("ballista.executor.backend", self.backend) if props else self.backend
            )
            cache_stats0 = self._submit_precompile_hints(props, backend, config)
            engine, stage_lock, plan = self._engine_for(plan, task, backend, config)
            gs0 = _grouped_sums_record() if backend == "torch" else None
            if rt.cancelled.is_set():
                raise Cancelled(task.task_id)
            pid = task.partition.partition_id
            from ballista_tpu_torch.config import BALLISTA_SHUFFLE_OBJECT_STORE_URL

            os_url = str(config.get(BALLISTA_SHUFFLE_OBJECT_STORE_URL) or "")
            if os_url:
                with self._lock:
                    self._job_object_urls[task.partition.job_id] = os_url
            from ballista_tpu_torch.config import (
                BALLISTA_SHUFFLE_CHECKSUM,
                BALLISTA_SHUFFLE_COMPRESSION,
                BALLISTA_SHUFFLE_DICT_CODES,
            )

            checksums = bool(config.get(BALLISTA_SHUFFLE_CHECKSUM))
            dict_codes = bool(config.get(BALLISTA_SHUFFLE_DICT_CODES))
            compression = str(config.get(BALLISTA_SHUFFLE_COMPRESSION) or "")
            if collector is not None and stage_lock is None:
                engine.trace_ctx = obs.TraceCtx(
                    collector, trace_id, task_span.span_id
                )
            if stage_lock is not None:
                # fused inline-exchange stages share one engine + lock; keep
                # the one-shot path (the exchange result is cached in-engine).
                # trace ctx is set under the lock — the engine is shared, so
                # operator spans attribute to whichever task ran the compute
                with stage_lock:
                    if collector is not None:
                        engine.trace_ctx = obs.TraceCtx(
                            collector, trace_id, task_span.span_id
                        )
                    batch = engine.execute_partition(plan.input, pid)
                if rt.cancelled.is_set():
                    raise Cancelled(task.task_id)
                stats = write_shuffle_partitions(
                    plan, pid, batch, self.work_dir, stage_attempt=task.stage_attempt,
                    object_store_url=os_url, checksums=checksums,
                    dict_codes=dict_codes, task_attempt=task.task_attempt,
                    compression=compression,
                )
                input_rows = batch.num_rows
            else:
                # streaming path: chunks flow from the engine straight into
                # per-output-partition IPC appends (bounded memory end-to-end)
                from ballista_tpu_torch.shuffle.stream import write_shuffle_stream

                def _cancellable(chunks):
                    for chunk in chunks:
                        if rt.cancelled.is_set():
                            raise Cancelled(task.task_id)
                        yield chunk

                stats, input_rows = write_shuffle_stream(
                    plan, pid,
                    _cancellable(engine.execute_partition_stream(plan.input, pid)),
                    self.work_dir, stage_attempt=task.stage_attempt,
                    object_store_url=os_url, checksums=checksums,
                    dict_codes=dict_codes, task_attempt=task.task_attempt,
                    compression=compression,
                )
            if rt.cancelled.is_set():
                raise Cancelled(task.task_id)
            self._refine_precompile_hints(props, backend, config, plan, stats)
            status.successful.CopyFrom(
                pb.SuccessfulTask(
                    executor_id=self.executor_id,
                    partitions=[
                        pb.ShuffleWritePartition(
                            output_partition=s.output_partition, path=s.path,
                            num_rows=s.num_rows, num_bytes=s.num_bytes,
                        )
                        for s in stats
                    ],
                )
            )
            status.metrics["rows"] = float(input_rows)
            status.metrics["output_bytes"] = float(sum(s.num_bytes for s in stats))
            status.metrics["exec_time_s"] = time.time() - start
            # atomic snapshot (dict() under the GIL): background compile /
            # prefetch threads may still insert keys while we harvest
            for k, v in dict(getattr(engine, "op_metrics", {})).items():
                status.metrics[k] = v
            if gs0 is not None:
                gs = _grouped_sums_record(gs0)
                status.metrics["op.GroupedSums.calls"] = float(gs["calls"])
                status.metrics["op.GroupedSums.launches"] = float(gs["launches"])
                for (n, k, ncols, dtype), calls in gs["shapes"].items():
                    name = str(dtype).replace("torch.", "")
                    status.metrics[f"op.GroupedSums.shape.{n}x{k}x{ncols}.{name}"] = float(calls)
            if cache_stats0 is not None:
                # warmed-key activity while this task ran (best-effort: the
                # record is process-wide, concurrent tasks interleave)
                from ballista_tpu_torch.engine.compile_service import get_service

                now_stats = get_service().cache.stats()
                for k in ("opened", "hits", "misses", "evictions"):
                    d = now_stats.get(k, 0) - cache_stats0.get(k, 0)
                    if d:
                        status.metrics[f"compile_cache.{k}"] = float(d)
            self.metrics_collector.record_stage(
                task.partition.job_id, task.partition.stage_id,
                task.partition.partition_id, dict(status.metrics),
            )
        except Cancelled:
            status.failed.CopyFrom(pb.FailedTask(error="killed", task_killed=pb.TaskKilled()))
        except FetchFailed as e:
            status.failed.CopyFrom(
                pb.FailedTask(
                    error=str(e),
                    fetch_partition_error=pb.FetchPartitionError(
                        executor_id=e.executor_id, map_stage_id=e.map_stage_id,
                        map_partition_id=e.map_partition_id, message=e.message,
                    ),
                )
            )
        except Exception as e:  # noqa: BLE001 - reported as retryable task failure
            log.warning("task %s failed: %s", task.task_id, traceback.format_exc())
            status.failed.CopyFrom(
                pb.FailedTask(
                    error=f"{type(e).__name__}: {e}", retryable=True,
                    execution_error=pb.ExecutionError(message=str(e)),
                )
            )
        finally:
            with self._lock:
                self._running.pop(task.task_id, None)
            status.end_time_ms = int(time.time() * 1000)
            if collector is not None:
                obs.clear_ambient()
                task_span.set("status", status.WhichOneof("status") or "unknown")
                if "rows" in status.metrics:
                    task_span.set("rows", status.metrics["rows"])
                if "output_bytes" in status.metrics:
                    task_span.set("output_bytes", status.metrics["output_bytes"])
                task_span.finish()
                import json as _json

                status.span_data = _json.dumps(collector.drain()).encode()
        return status

    def _submit_precompile_hints(self, props, backend: str, config):
        """Hand scheduler precompile hints to the process-wide compile service
        (background warm runs of downstream stages on this executor's device
        while this task runs). Returns the warmed-key record's stats for the
        task's deltas, or None on the host backend. A bad hint can never
        fail the task."""
        if backend != "torch":
            return None
        try:
            from ballista_tpu_torch.config import (
                BALLISTA_ENGINE_PRECOMPILE,
                BALLISTA_PRECOMPILE_HINTS,
            )
            from ballista_tpu_torch.engine.compile_service import get_service

            svc = get_service()
            hints = (props or {}).get(BALLISTA_PRECOMPILE_HINTS) or ""
            if hints and bool(config.get(BALLISTA_ENGINE_PRECOMPILE)):
                svc.submit_hints(hints, dict(props or {}), device=self.device)
            return svc.cache.stats()
        except Exception:  # noqa: BLE001 - hints are advisory
            log.warning("precompile hint submission failed", exc_info=True)
            return None

    def _refine_precompile_hints(self, props, backend: str, config, plan, stats):
        """Completion kick: a finished map task knows its REAL output rows, so
        it re-submits the DIRECT downstream hints the scheduler could only
        guess at (rows=0, or a leaf-scan estimate) with a measured
        per-reduce-partition estimate. The refined warm overlaps the
        remaining sibling maps and the status/launch/fetch round trip; the
        digest dedupe makes repeats from sibling tasks free. Best-effort,
        never fails the task."""
        if backend != "torch":
            return
        try:
            import json as _json

            from ballista_tpu_torch.config import (
                BALLISTA_AQE_ENABLED,
                BALLISTA_AQE_TARGET_PARTITION_BYTES,
                BALLISTA_ENGINE_PRECOMPILE,
                BALLISTA_PRECOMPILE_HINTS,
            )
            from ballista_tpu_torch.ops.kernels_torch import bucket_size

            hints_raw = (props or {}).get(BALLISTA_PRECOMPILE_HINTS) or ""
            if not hints_raw or not bool(config.get(BALLISTA_ENGINE_PRECOMPILE)):
                return
            hints = _json.loads(hints_raw)
            if not isinstance(hints, list):
                return
            zero = [h for h in hints
                    if isinstance(h, dict) and h.get("direct")
                    and (not h.get("rows") or h.get("est"))]
            if not zero:
                return
            out_rows = sum(s.num_rows for s in stats)
            n_out = max(1, len(stats))
            n_maps = max(1, plan.input_partitions())
            # uniform-maps estimate, bucketed so sibling tasks with slightly
            # different outputs refine to ONE digest
            per_reduce = (out_rows // n_out) * n_maps
            if per_reduce <= 0:
                return
            # AQE coalescing (docs/adaptive.md): the consumer resolves with
            # adjacent tiny partitions merged up to the byte target, so hint
            # the post-coalesce task shape. An approximation from THIS
            # producer's bytes alone: a join consumer's merge also counts the
            # other side, so its hint may overshoot — a missed warm, never a
            # wrong result
            if bool(config.get(BALLISTA_AQE_ENABLED)):
                target = int(config.get(BALLISTA_AQE_TARGET_PARTITION_BYTES) or 0)
                per_bytes = (sum(s.num_bytes for s in stats) // n_out) * n_maps
                if target > 0 and 0 < per_bytes <= target:
                    per_reduce *= min(n_out, max(1, target // per_bytes))
            # measured now: drop the "est" tag so repeats of the refined
            # payload are byte-identical whichever sibling sent them
            refined = [{k: v for k, v in h.items() if k != "est"}
                       | {"rows": bucket_size(per_reduce)} for h in zero]
            from ballista_tpu_torch.engine.compile_service import get_service

            get_service().submit_hints(_json.dumps(refined), dict(props or {}),
                                       device=self.device)
        except Exception:  # noqa: BLE001 - refinement is advisory
            log.debug("precompile hint refinement failed", exc_info=True)

    def _engine_for(self, plan, task, backend: str, config):
        """Per-task engine normally; one shared (locked) engine AND shared
        decoded plan per stage attempt for plans carrying an inline exchange —
        engine caches key on plan-node identity, so the fused producer/consumer
        pair computes once per executor and later tasks read cached partitions."""
        from ballista_tpu_torch.plan.physical import RepartitionExec, walk_physical

        inline_exchange = any(
            isinstance(n, RepartitionExec) for n in walk_physical(plan)
        )
        if not inline_exchange:
            return create_engine(backend, config, device=self.device), None, plan
        key = (task.partition.job_id, task.partition.stage_id, task.stage_attempt, backend)
        with self._lock:
            if key not in self._stage_engines:
                if len(self._stage_engines) >= 8:
                    self._stage_engines.pop(next(iter(self._stage_engines)))
                self._stage_engines[key] = (
                    create_engine(backend, config, device=self.device),
                    threading.Lock(), plan,
                )
            return self._stage_engines[key]

    # ---- cancellation ----------------------------------------------------------------
    def cancel_task(self, task_id: str) -> bool:
        with self._lock:
            rt = self._running.get(task_id)
            if rt is not None:
                rt.cancelled.set()
                return True
        return False

    def running_count(self) -> int:
        with self._lock:
            return len(self._running)

    # ---- orphaned-shuffle sweeper (docs/fault_tolerance.md) ----------------------------
    def note_job_activity(self, job_id: str) -> None:
        """Record local activity (task run, shuffle write, Flight serve) for
        a job — the sweeper's pin-awareness signal."""
        if not job_id:
            return
        with self._lock:
            self._job_last_active[job_id] = time.time()
            while len(self._job_last_active) > 4096:
                oldest = min(self._job_last_active, key=self._job_last_active.get)
                del self._job_last_active[oldest]

    def sweep_orphans(
        self, orphan_ttl_s: float, hard_ttl_s: float,
        now: Optional[float] = None,
    ) -> int:
        """Reclaim shuffle dirs of jobs that died WITHOUT a clean-job RPC
        (crashed scheduler, lost clean fan-out — without this, that disk
        leaks forever). A job dir goes when:

        * its mtime passed the HARD ttl (the reference's work-dir TTL), or
        * its mtime passed the ORPHAN ttl AND no local activity — task
          execution, shuffle write, Flight serve — touched the job within
          the orphan ttl (pin-awareness: cached cross-job exchange prefixes
          being consumed keep their dirs), and no task of the job is
          running here.

        Deleting a dir a live job still wanted is RECOVERABLE (the consumer
        FetchFails and lineage re-runs the producer), so the sweep errs
        toward reclaiming; it never touches internal dirs (``_fetch`` spill)
        or other executors' object-store uploads. Returns bytes reclaimed
        (accumulated on ``reclaimed_bytes`` for /api/metrics)."""
        import os

        if now is None:
            now = time.time()
        with self._lock:
            active_jobs = {rt.job_id for rt in self._running.values()}
            last_active = dict(self._job_last_active)
        reclaimed = 0
        try:
            names = os.listdir(self.work_dir)
        except OSError:
            return 0
        for name in names:
            if name.startswith(("_", ".")):
                continue  # _fetch spill dir, owner pidfile, etc.
            path = os.path.join(self.work_dir, name)
            if not os.path.isdir(path) or name in active_jobs:
                continue
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            hard = now - mtime > hard_ttl_s > 0
            aged = (
                orphan_ttl_s > 0
                and now - mtime > orphan_ttl_s
                and now - last_active.get(name, 0.0) > orphan_ttl_s
            )
            if not (hard or aged):
                continue
            size = _dir_bytes(path)
            log.info(
                "sweeping orphaned shuffle dir %s (%d bytes, %s)",
                path, size, "hard ttl" if hard else "orphan ttl",
            )
            self.remove_job_data(name, local_only=True)
            reclaimed += size
            with self._lock:
                self._job_last_active.pop(name, None)
        if reclaimed:
            with self._lock:
                self.reclaimed_bytes += reclaimed
        return reclaimed

    # ---- job data cleanup --------------------------------------------------------------
    def remove_job_data(self, job_id: str, local_only: bool = False) -> None:
        """Delete a job's local shuffle dir; unless ``local_only``, also the
        job's uploaded object-store prefix. ``local_only`` is for evidence
        that covers only THIS executor (the work-dir TTL sweep): the object
        prefix is SHARED across executors and must only be deleted on a
        job-scoped signal (the scheduler's clean-job-data RPC)."""
        import os
        import shutil

        path = os.path.join(self.work_dir, job_id)
        # path traversal guard (reference: executor_server.rs is_subdirectory)
        if not os.path.realpath(path).startswith(os.path.realpath(self.work_dir) + os.sep):
            log.warning("refusing to remove %s (outside work dir)", path)
            return
        shutil.rmtree(path, ignore_errors=True)
        with self._lock:
            os_url = self._job_object_urls.pop(job_id, None)
        if os_url and not local_only:
            from ballista_tpu_torch.utils.object_store import delete_prefix

            # uploaded shuffle pieces (incl. rolled-back '-aN' attempts) live
            # under <base>/<job>/ by the writer's path convention
            delete_prefix(os_url.rstrip("/") + "/" + job_id)


def _dir_bytes(path: str) -> int:
    import os

    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def _grouped_sums_record(before: Optional[dict] = None) -> dict:
    """This thread's grouped_sums record (``grouped_sums.thread_record``: a
    task's engine runs its stages on the task's thread, and its mesh
    programs add their shard threads'), or what it gained since ``before``."""
    from ballista_tpu_torch.ops import grouped_sums as GS

    return GS.thread_record() if before is None else GS.record_since(before)
