"""Executor process: registration, pull/push loops, Flight server, shutdown.

Reference analog: ``executor_process.rs`` + ``execution_loop.rs`` +
``executor_server.rs``:

* pull mode: poll loop with a slot semaphore — ``PollWork{num_free_slots,
  task_status[]}`` returns task definitions; 100ms idle sleep
  (execution_loop.rs:49-133)
* push mode: gRPC service receiving ``LaunchMultiTask``; statuses batched back
  on a reporter thread; heartbeats on an interval (executor_server.rs)
* graceful shutdown: TERMINATING heartbeat -> drain -> ExecutorStopped ->
  shuffle cleanup (executor_process.rs:369-647)
* work-dir TTL cleanup loop (executor_process.rs:300-328)

The task pool is the DedicatedExecutor analog: task execution threads are
separate from the control-plane threads, so a busy device never starves
heartbeats (cpu_bound_executor.rs).

A torch executor runs its stages on one device, ``cuda`` unless its config
names another, and refuses to start when CUDA is asked for and missing; its
fused and promoted programs run over the process's mesh of shards
(``parallel``), one host thread a shard. It registers the mesh's shard count
and the card's name as its device kind, which the scheduler maps to the
card's memory budget at admission. An executor given a share of its card
(``device_share`` below 1: several executors on one card) sets it for its
process before any engine plans (``memory_model.set_device_share``) and
registers it after its mesh shape (``"1x1@0.5"``), so its engines and the
scheduler plan for that share; a mesh-group member refuses one. An
executor in a mesh group
(``parallel/multihost.py``) joins the group in ``start()``, before any
device use and before it registers; the scheduler then gang-schedules fused
stages onto the complete group, and each member registers its card's shard
count over the whole group, so admission splits the card's budget as the
members' engines do.
"""
from __future__ import annotations

import logging
import os
import queue
import shutil
import tempfile
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import grpc

from ballista_tpu_torch.analysis import concurrency
from ballista_tpu_torch.config import ExecutorConfig
from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.executor.executor import Executor
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.proto.rpc import (
    EXECUTOR_METHODS, EXECUTOR_SERVICE, GRPC_OPTIONS, add_service, scheduler_stub,
)
from ballista_tpu_torch.shuffle.flight import ShuffleFlightServer

log = logging.getLogger("ballista.executor")


def jittered_interval(interval_s: float, frac: float = 0.1, rnd=None) -> float:
    """Heartbeat cadence with ±``frac`` jitter: after a scheduler restart
    every executor re-registers on its next heartbeat, and identical
    intervals would keep the whole fleet phase-locked into one thundering
    herd forever. Jitter decorrelates the phases within a few beats."""
    import random as _random

    r = (rnd or _random).uniform(-frac, frac)
    return max(0.01, interval_s * (1.0 + r))


class ExecutorProcess:
    def __init__(self, config: Optional[ExecutorConfig] = None, executor_id: Optional[str] = None):
        from ballista_tpu_torch.utils import faults

        faults.install_from_env()
        self.config = config or ExecutorConfig()
        if self.config.backend not in ("torch", "numpy"):
            raise BallistaError(
                f"executor backend {self.config.backend!r}: torch or numpy"
            )
        if self.config.mesh_group_id:
            c = self.config
            if (self.config.backend != "torch" or not c.mesh_group_coordinator
                    or c.mesh_group_size < 2
                    or not 0 <= c.mesh_group_process_id < c.mesh_group_size):
                raise BallistaError(
                    f"mesh group {c.mesh_group_id!r} needs the torch backend, a "
                    "coordinator, a size of at least 2 and a process id below it"
                )
        if not 0.0 < self.config.device_share <= 1.0:
            raise BallistaError(
                f"device share {self.config.device_share!r}: a fraction in (0, 1]")
        if self.config.device_share < 1.0:
            if self.config.mesh_group_id:
                raise BallistaError(
                    f"mesh group {self.config.mesh_group_id!r} splits its cards between "
                    "its members: a device share below 1 does not apply there")
            from ballista_tpu_torch.engine import memory_model as MM

            # process-wide, before any engine detects its budget
            MM.set_device_share(self.config.device_share)
        if self.config.backend == "torch":
            from ballista_tpu_torch.engine.torch_engine import resolve_device

            # before any work dir exists: no card, no executor
            self.config.device = resolve_device(self.config.device)
        self.executor_id = executor_id or f"exec-{uuid.uuid4().hex[:8]}"
        auto_dir = self.config.work_dir is None
        # an auto-created work dir is this executor's alone: stop() removes it
        self._owns_work_dir = auto_dir
        self.work_dir = self.config.work_dir or tempfile.mkdtemp(prefix="ballista-")
        os.makedirs(self.work_dir, exist_ok=True)
        if auto_dir:
            # an OOM-killed/SIGKILLed executor never runs its shutdown
            # cleanup: its auto-created work dir (tens of GB of shuffle
            # files at SF10+) leaks until /tmp fills. Each live executor
            # writes an owner pidfile; at startup reap sibling dirs whose
            # owner is gone. (Reference analog: the executor's work-dir
            # TTL cleanup — which also cannot run after a hard kill.)
            self._write_owner_pidfile()
            # reap in the background: rmtree of a dead peer's tens-of-GB
            # shuffle dir must not delay registration/first heartbeat when
            # a replacement executor is racing to restore cluster capacity
            threading.Thread(
                target=self._reap_orphan_work_dirs, daemon=True,
                name="workdir-reaper",
            ).start()
        self.executor = Executor(self.executor_id, self.config, self.work_dir)
        self._sched_addrs = list(
            self.config.scheduler_addrs
            or [f"{self.config.scheduler_host}:{self.config.scheduler_port}"]
        )
        self._sched_idx = 0
        self._sched_failures = 0
        # failover rotation is shared mutable state: in pull mode BOTH the
        # poll loop and the (metrics) heartbeat loop report failures, and an
        # unsynchronized double-rotation would skip past a healthy standby
        self._sched_rotate_lock = concurrency.make_lock(
            "ExecutorProcess._sched_rotate_lock"
        )
        self.scheduler = scheduler_stub(self._sched_addrs[0])
        self._task_pool = ThreadPoolExecutor(
            max_workers=self.config.task_slots, thread_name_prefix="task"
        )
        self._status_q: "queue.Queue[pb.TaskStatus]" = queue.Queue()
        # logical task slots already accepted (bounded FIFO), keyed
        # (job, stage, stage_attempt, partition, task_attempt): the
        # scheduler's launch RPC retries on DEADLINE_EXCEEDED, and a
        # delivered-but-slow first attempt plus its retry — or a re-BOUND
        # twin minted after an exhausted launch budget (new task_id, same
        # attempt numbers) — must not run twice here: both copies would
        # write the SAME shuffle piece paths from two threads. Genuine
        # re-runs always advance stage_attempt or task_attempt, so they
        # pass the dedupe.
        self._seen_tasks: "OrderedDict[tuple, None]" = OrderedDict()
        # final statuses of finished slots (bounded): a suppressed duplicate
        # whose first copy ALREADY finished re-reports that outcome under
        # the new task_id — without this, a first-copy status that landed in
        # the scheduler's unbind→rebind window (dropped as stale) plus a
        # suppressed twin leaves the slot running forever
        self._done_tasks: "OrderedDict[tuple, pb.TaskStatus]" = OrderedDict()
        self._stop = threading.Event()
        self._terminating = threading.Event()
        self.flight: Optional[ShuffleFlightServer] = None
        self._grpc_server: Optional[grpc.Server] = None
        self._active_tasks = 0
        self._slots_lock = concurrency.make_lock("ExecutorProcess._slots_lock")
        self._threads: list[threading.Thread] = []

    @staticmethod
    def _proc_stat(pid: int) -> tuple[Optional[str], Optional[str]]:
        """(state, starttime_ticks) from /proc, or (None, None) when the
        process does not exist / procfs is unreadable. comm may itself
        contain ')' — split at the LAST one."""
        try:
            with open(f"/proc/{pid}/stat") as f:
                rest = f.read().rsplit(")", 1)
                fields = rest[1].split()
                return fields[0], fields[19]  # state; starttime (field 22)
        except (OSError, IndexError):
            return None, None

    def _write_owner_pidfile(self) -> None:
        """``<pid> <starttime-ticks>``: the starttime disambiguates PID
        reuse — a recycled pid belonging to an unrelated process must not
        keep a dead executor's dir alive forever."""
        _, start = self._proc_stat(os.getpid())
        try:
            with open(os.path.join(self.work_dir, ".owner_pid"), "w") as f:
                f.write(f"{os.getpid()} {start or ''}".strip())
        except OSError:  # noqa: PERF203 - best effort
            pass

    def _reap_orphan_work_dirs(self) -> None:
        """Only dirs carrying a pidfile whose owner is PROVABLY gone are
        removed (dead pid, zombie, or starttime mismatch = recycled pid);
        anything ambiguous — no pidfile, procfs oddities — is left alone:
        deleting a live executor's shuffle files fails jobs, while a leaked
        dir merely wastes disk until an operator sweeps it."""
        parent = os.path.dirname(self.work_dir)
        try:
            names = os.listdir(parent)
        except OSError:
            return
        for name in names:
            if not name.startswith("ballista-"):
                continue
            d = os.path.join(parent, name)
            if d == self.work_dir or not os.path.isdir(d):
                continue
            try:
                content = open(os.path.join(d, ".owner_pid")).read().split()
                pid = int(content[0])
                want_start = content[1] if len(content) > 1 else None
            except (OSError, ValueError, IndexError):
                continue  # no/unreadable pidfile: not provably orphaned
            try:
                os.kill(pid, 0)
            except ProcessLookupError:
                pass  # pid gone: orphan
            except OSError:
                continue  # permission oddity: leave it
            else:
                state, start = self._proc_stat(pid)
                if state is not None and state != "Z" and (
                    want_start is None or start == want_start
                ):
                    continue  # owner genuinely alive
                # zombie, or a recycled pid (starttime mismatch): orphan
            log.info("reaping orphaned executor work dir %s", d)
            shutil.rmtree(d, ignore_errors=True)

    def _note_served_path(self, path: str) -> None:
        """Flight serve hook: a fetched shuffle piece marks its job ACTIVE
        for the orphan sweeper (pin-awareness — a cached cross-job exchange
        prefix being consumed keeps its dir, docs/fault_tolerance.md)."""
        try:
            rel = os.path.relpath(os.path.realpath(path),
                                  os.path.realpath(self.work_dir))
            job = rel.split(os.sep, 1)[0]
            if job and not job.startswith(".."):
                self.executor.note_job_activity(job)
        except (OSError, ValueError):
            pass

    def _feed_resolver(
        self, job_id: str, stage_id: int, input_stage_id: int, partition_id: int
    ) -> tuple[list[dict], bool, bool]:
        """GetStageInputs poll for the live piece feed (docs/shuffle.md)."""
        r = self.scheduler.GetStageInputs(
            pb.GetStageInputsParams(
                job_id=job_id, stage_id=stage_id,
                input_stage_id=input_stage_id, partition_id=partition_id,
            ),
            timeout=5,
        )
        pieces = [
            {
                "map_partition": p.map_partition,
                "path": p.path,
                "host": p.host,
                "flight_port": p.flight_port,
                "executor_id": p.executor_id,
                "num_rows": p.num_rows,
                "num_bytes": p.num_bytes,
            }
            for p in r.pieces
        ]
        return pieces, r.complete, r.gone

    # ---- metadata ---------------------------------------------------------------------
    def _advertised_host(self) -> str:
        return self.config.advertise_host or "127.0.0.1"

    def metadata(self) -> pb.ExecutorMetadata:
        num_devices, kind, mesh = _device_inventory(self.config.backend, self.config.device,
                                                    self.config.device_share)
        return pb.ExecutorMetadata(
            id=self.executor_id,
            host=self._advertised_host(),
            port=self.config.port,
            flight_port=self.flight.port if self.flight else self.config.flight_port,
            specification=pb.ExecutorSpecification(
                task_slots=self.config.task_slots,
                num_devices=num_devices, device_kind=kind, mesh_shape=mesh,
                mesh_group_id=self.config.mesh_group_id or "",
                mesh_group_size=self.config.mesh_group_size,
                mesh_group_process_id=self.config.mesh_group_process_id,
            ),
        )

    # ---- lifecycle ----------------------------------------------------------------------
    def start(self) -> None:
        if self.config.mesh_group_id:
            # the group forms before any device use and before registration:
            # the scheduler sees only members of a group that has joined
            from ballista_tpu_torch.parallel import multihost

            c = self.config
            log.info("executor %s joining mesh group %s (%d/%d) via %s", self.executor_id,
                     c.mesh_group_id, c.mesh_group_process_id, c.mesh_group_size,
                     c.mesh_group_coordinator)
            multihost.init_mesh_group(c.mesh_group_coordinator, c.mesh_group_size,
                                      c.mesh_group_process_id,
                                      local_devices=c.mesh_group_local_devices,
                                      device=c.device)
        self.flight = ShuffleFlightServer(
            "0.0.0.0", self.config.flight_port, self.work_dir,
            on_serve=self._note_served_path,
        )
        self.flight.serve_background()
        # pipelined shuffle (docs/shuffle.md): install the live piece feed —
        # task threads running early-resolved consumers poll GetStageInputs
        # (same scheduler channel as the poll/heartbeat loops; rotates with
        # HA failover because the stub is read per call) for pieces that
        # were pending at launch
        from ballista_tpu_torch.shuffle import feed as _feed

        _feed.install_feed(self._feed_resolver)
        log.info("executor %s flight on %s, work dir %s",
                 self.executor_id, self.flight.port, self.work_dir)

        if self.config.scheduling_policy == "push":
            self._start_push_server()

        self._register_with_retry()

        if self.config.scheduling_policy == "pull":
            t = threading.Thread(target=self._poll_loop, daemon=True, name="poll-loop")
            t.start()
            self._threads.append(t)
            # pull mode polls for liveness, but PollWork carries no metrics:
            # the (jittered, slow) heartbeat loop runs here too so executor
            # metrics — reclaimed shuffle bytes, running tasks, memory —
            # reach the scheduler's /api/metrics in both modes
            t_hb = threading.Thread(
                target=self._heartbeat_loop, daemon=True, name="heartbeat"
            )
            t_hb.start()
            self._threads.append(t_hb)
        else:
            t = threading.Thread(target=self._heartbeat_loop, daemon=True, name="heartbeat")
            t.start()
            self._threads.append(t)
            t2 = threading.Thread(target=self._status_reporter, daemon=True, name="status")
            t2.start()
            self._threads.append(t2)
        t3 = threading.Thread(target=self._ttl_cleanup_loop, daemon=True, name="ttl-clean")
        t3.start()
        self._threads.append(t3)

    def stop(self, grace: bool = True) -> None:
        """Graceful: terminating heartbeat, drain, ExecutorStopped, cleanup
        (the shuffle files go with an auto-created work dir; a configured
        one may be shared, and stays)."""
        self._terminating.set()
        if grace:
            try:
                self.scheduler.HeartBeatFromExecutor(
                    pb.HeartBeatParams(
                        heartbeat=pb.ExecutorHeartbeat(
                            executor_id=self.executor_id,
                            timestamp_ms=int(time.time() * 1000), status="terminating",
                        ),
                        metadata=self.metadata(),
                    ),
                    timeout=5,
                )
            except Exception:  # noqa: BLE001
                pass
            deadline = time.time() + 30
            while self.executor.running_count() and time.time() < deadline:
                time.sleep(0.1)
            # the finished tasks' statuses go out with the next poll
            while not self._status_q.empty() and time.time() < deadline:
                time.sleep(0.01)
        # no poll or heartbeat may reach the scheduler after ExecutorStopped:
        # either would register this executor again
        self._stop.set()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=15)
        try:
            self.scheduler.ExecutorStopped(
                pb.ExecutorStoppedParams(executor_id=self.executor_id, reason="shutdown"),
                timeout=5,
            )
        except Exception:  # noqa: BLE001
            pass
        if self._grpc_server is not None:
            self._grpc_server.stop(grace=0.5)
        if self.flight is not None:
            self.flight.shutdown()
        if self._owns_work_dir:
            shutil.rmtree(self.work_dir, ignore_errors=True)

    def _note_scheduler_success(self) -> None:
        """Reset the failure streak under the rotation lock. The streak is
        shared between the poll and heartbeat loops; an unlocked ``= 0``
        here could land between a concurrent streak's read and its rotate
        decision and either mask or double a failover (the lock-order
        verifier flagged exactly these two lock-free resets)."""
        with self._sched_rotate_lock:
            self._sched_failures = 0

    def _note_scheduler_failure(self) -> None:
        """HA: after 3 consecutive RPC failures rotate to the next scheduler
        address and re-register — a standby scheduler that took our jobs over
        sees the same executor inventory as the failed one did. Serialized:
        the poll loop and the heartbeat loop both report failures, and two
        concurrent streaks must rotate ONCE, not leapfrog a healthy standby."""
        with self._sched_rotate_lock:
            self._sched_failures += 1
            if self._sched_failures < 3 or len(self._sched_addrs) < 2:
                return
            self._sched_failures = 0
            self._sched_idx = (self._sched_idx + 1) % len(self._sched_addrs)
            addr = self._sched_addrs[self._sched_idx]
            self.scheduler = scheduler_stub(addr)
        # re-register OUTSIDE the lock (it sleeps between attempts): a
        # concurrent duplicate registration is idempotent, only the
        # rotation decision itself must be serialized
        log.warning("scheduler unreachable; failing over to %s", addr)
        try:
            self._register_with_retry(attempts=3)
        except Exception:  # noqa: BLE001 - next loop iteration keeps rotating
            pass

    def _register_with_retry(self, attempts: int = 30) -> None:
        for i in range(attempts):
            try:
                r = self.scheduler.RegisterExecutor(
                    pb.RegisterExecutorParams(metadata=self.metadata()), timeout=5
                )
                if r.success:
                    return
            except Exception as e:  # noqa: BLE001
                log.info("scheduler not ready (%s); retry %d", e, i)
            time.sleep(min(0.2 * (i + 1), 2.0))
        raise RuntimeError("could not register with scheduler")

    # ---- pull mode --------------------------------------------------------------------
    def _poll_loop(self) -> None:
        pending_statuses: list[pb.TaskStatus] = []
        while not self._stop.is_set():
            while True:
                try:
                    pending_statuses.append(self._status_q.get_nowait())
                except queue.Empty:
                    break
            with self._slots_lock:
                free = self.config.task_slots - self._active_tasks
            if self._terminating.is_set():
                free = 0
            try:
                result = self.scheduler.PollWork(
                    pb.PollWorkParams(
                        metadata=self.metadata(),
                        num_free_slots=free,
                        task_status=pending_statuses,
                    ),
                    timeout=10,
                )
                pending_statuses = []
                self._note_scheduler_success()
            except Exception as e:  # noqa: BLE001
                log.warning("poll failed: %s", e)
                self._note_scheduler_failure()
                time.sleep(1.0)
                continue
            got = list(result.tasks)
            for td in got:
                self._spawn_task(td)
            if not got:
                time.sleep(self.config.poll_interval_ms / 1000.0)

    @staticmethod
    def _slot_key(td: pb.TaskDefinition) -> tuple:
        return (td.partition.job_id, td.partition.stage_id, td.stage_attempt,
                td.partition.partition_id, td.task_attempt)

    def _spawn_task(self, td: pb.TaskDefinition) -> None:
        with self._slots_lock:
            self._active_tasks += 1

        def run():
            try:
                status = self.executor.execute_task(td, dict(td.props))
                with self._slots_lock:
                    self._done_tasks[self._slot_key(td)] = status
                    while len(self._done_tasks) > 1024:
                        self._done_tasks.popitem(last=False)
                self._status_q.put(status)
            finally:
                with self._slots_lock:
                    self._active_tasks -= 1

        self._task_pool.submit(run)

    # ---- push mode -----------------------------------------------------------------------
    def _start_push_server(self) -> None:
        server = grpc.server(
            ThreadPoolExecutor(max_workers=8, thread_name_prefix="exec-grpc"),
            options=GRPC_OPTIONS,
        )
        add_service(server, EXECUTOR_SERVICE, EXECUTOR_METHODS, self)
        self.config.port = server.add_insecure_port(f"{self.config.bind_host}:{self.config.port}")
        server.start()
        self._grpc_server = server

    # push-mode RPCs (reference: executor_server.rs:633-784)
    def launch_multi_task(self, req: pb.LaunchMultiTaskParams, ctx) -> pb.LaunchMultiTaskResult:
        if self._terminating.is_set():
            return pb.LaunchMultiTaskResult(success=False)
        for mt in req.multi_tasks:
            for slot in mt.tasks:
                key = (mt.job_id, mt.stage_id, mt.stage_attempt,
                       slot.partition_id, slot.task_attempt)
                with self._slots_lock:
                    if key in self._seen_tasks:
                        # duplicate delivery (launch retry after a deadline
                        # the first attempt actually beat) or a re-bound
                        # twin: already running/ran — acknowledge, don't
                        # respawn. Still-running: the first copy's eventual
                        # status covers the slot (the scheduler accepts
                        # equivalent-attempt twins). Already finished: the
                        # original report may have landed in the scheduler's
                        # unbind→rebind window and been dropped as stale, so
                        # RE-REPORT the stored outcome under the new task_id.
                        done = self._done_tasks.get(key)
                        if done is not None:
                            st = pb.TaskStatus()
                            st.CopyFrom(done)
                            st.task_id = slot.task_id
                            self._status_q.put(st)
                        continue
                    self._seen_tasks[key] = None
                    while len(self._seen_tasks) > 4096:
                        self._seen_tasks.popitem(last=False)
                td = pb.TaskDefinition(
                    task_id=slot.task_id,
                    partition=pb.PartitionId(
                        job_id=mt.job_id, stage_id=mt.stage_id, partition_id=slot.partition_id
                    ),
                    stage_attempt=mt.stage_attempt,
                    task_attempt=slot.task_attempt,
                    plan=mt.plan,
                    props=mt.props,
                )
                self._spawn_task(td)
        return pb.LaunchMultiTaskResult(success=True)

    def stop_executor(self, req: pb.StopExecutorParams, ctx) -> pb.StopExecutorResult:
        threading.Thread(target=lambda: self.stop(grace=not req.force), daemon=True).start()
        return pb.StopExecutorResult()

    def cancel_tasks(self, req: pb.CancelTasksParams, ctx) -> pb.CancelTasksResult:
        ok = True
        for info in req.task_infos:
            ok = self.executor.cancel_task(info.task_id) and ok
        return pb.CancelTasksResult(cancelled=ok)

    def remove_job_data(self, req: pb.RemoveJobDataParams, ctx) -> pb.RemoveJobDataResult:
        self.executor.remove_job_data(req.job_id)
        return pb.RemoveJobDataResult()

    # ---- background loops --------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        from ballista_tpu_torch.utils import faults

        while not self._stop.wait(
            jittered_interval(self.config.heartbeat_interval_seconds)
        ):
            status = "terminating" if self._terminating.is_set() else "active"
            try:
                faults.check("heartbeat.send", {"executor_id": self.executor_id})
                self.scheduler.HeartBeatFromExecutor(
                    pb.HeartBeatParams(
                        heartbeat=pb.ExecutorHeartbeat(
                            executor_id=self.executor_id,
                            timestamp_ms=int(time.time() * 1000),
                            status=status,
                            metrics=_host_metrics(self.executor),
                        ),
                        metadata=self.metadata(),
                    ),
                    timeout=5,
                )
                self._note_scheduler_success()
            except Exception as e:  # noqa: BLE001
                log.warning("heartbeat failed: %s", e)
                self._note_scheduler_failure()

    def _status_reporter(self) -> None:
        """Push mode: batch statuses back to the scheduler (executor_server.rs:501-580)."""
        while not self._stop.is_set():
            batch: list[pb.TaskStatus] = []
            try:
                batch.append(self._status_q.get(timeout=0.2))
            except queue.Empty:
                continue
            while True:
                try:
                    batch.append(self._status_q.get_nowait())
                except queue.Empty:
                    break
            try:
                from ballista_tpu_torch.utils import faults

                faults.check("rpc.status", {"executor_id": self.executor_id})
                self.scheduler.UpdateTaskStatus(
                    pb.UpdateTaskStatusParams(executor_id=self.executor_id, task_status=batch),
                    timeout=10,
                )
            except Exception as e:  # noqa: BLE001
                log.warning("status update failed: %s; requeueing", e)
                for st in batch:
                    self._status_q.put(st)
                time.sleep(1.0)

    def _ttl_cleanup_loop(self) -> None:
        """Orphaned-shuffle sweeper (docs/fault_tolerance.md): reclaim job
        dirs whose owner died without a clean-job RPC — age-gated on the
        ORPHAN ttl, pin-aware via local activity (a cached cross-job
        exchange prefix being consumed stays), plus the reference's hard
        work-dir TTL (executor_process.rs:300-328). LOCAL cleanup only: this
        executor's dir says nothing about other executors' still-fresh
        uploads under the shared object prefix — those are deleted on the
        scheduler's job-scoped clean-data RPC instead."""
        orphan = self.config.orphan_sweep_ttl_seconds
        hard = self.config.shuffle_cleanup_ttl_seconds
        interval = min(3600.0, max(30.0, (orphan if orphan > 0 else hard) / 4))
        while not self._stop.wait(interval):
            try:
                self.executor.sweep_orphans(orphan, hard)
            except Exception:  # noqa: BLE001 - the sweep must not die
                log.warning("orphan shuffle sweep failed", exc_info=True)


def _host_metrics(executor) -> dict[str, float]:
    """Heartbeat metrics (reference: ExecutorMetric{available_memory} in
    heartbeats, executor_server.rs:432-439 — stubbed there, real here)."""
    out: dict[str, float] = {
        "running_tasks": float(executor.running_count()),
        # orphaned-shuffle sweeper counter (docs/fault_tolerance.md): total
        # bytes reclaimed from job dirs whose owner died without a clean RPC
        "shuffle_reclaimed_bytes": float(executor.reclaimed_bytes),
    }
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    out["available_memory_kb"] = float(line.split()[1])
                    break
    except OSError:
        pass
    return out


def _device_inventory(backend: str, device: Optional[str],
                      share: float = 1.0) -> tuple[int, str, str]:
    """(devices, kind, mesh shape) as registered: a torch executor reports
    its mesh's shard count (``parallel.mesh_shards``: one per visible card
    unless forced) and, on a card, the card's name
    (``torch.cuda.get_device_name``), as a JAX executor reports
    ``len(jax.devices())``; a mesh of 2 or more lets the scheduler promote
    exchanges and whole chains onto it. The mesh shape (``"CxS"``,
    ``parallel.mesh.mesh_shape``) tells the scheduler how many shards share
    a card, so that it splits the card's budget as the engine does; a mesh
    group's member counts every member's shards on its cards
    (``MeshGroup.mesh_shape``). An executor that plans for a ``share`` below
    1 of its card adds it (``"1x1@0.5"``), so that the scheduler admits its
    stages against that share. A host (numpy) executor reports no device."""
    if backend != "torch" or device is None:
        return (0, "cpu", "")
    import torch

    from ballista_tpu_torch.parallel import multihost
    from ballista_tpu_torch.parallel.mesh import build_mesh, mesh_shape

    mesh = build_mesh(None, device)
    kind = torch.cuda.get_device_name(torch.device(device)) if device.startswith("cuda") \
        else "cpu"
    group = multihost.current_group()
    shape = group.mesh_shape() if group is not None else mesh_shape(mesh, share)
    return (len(mesh), kind, shape)
