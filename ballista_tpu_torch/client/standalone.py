"""In-process cluster: scheduler + N executors on random ports.

Reference analog: the ``standalone`` feature
(``scheduler/src/standalone.rs:35-72``, ``executor/src/standalone.rs:41-103``)
used by BallistaContext::standalone and the client tests.

The executors are ``ExecutorProcess``es in this process: they share one CUDA
context, the torch engine's module-level leaf caches and grouped_sums'
launch count, where executors in processes of their own
(``python -m ballista_tpu_torch.executor``) share nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ballista_tpu_torch.config import ExecutorConfig, SchedulerConfig
from ballista_tpu_torch.executor.process import ExecutorProcess
from ballista_tpu_torch.scheduler.server import SchedulerServer


@dataclass
class StandaloneCluster:
    scheduler: SchedulerServer
    executors: list[ExecutorProcess] = field(default_factory=list)

    @property
    def scheduler_port(self) -> int:
        return self.scheduler.port

    def stop(self):
        for e in self.executors:
            e.stop(grace=False)
        self.scheduler.stop()


def start_standalone_cluster(
    n_executors: int = 1,
    task_slots: int = 4,
    backend: str = "torch",
    device: str | None = None,
    scheduling_policy: str = "pull",
    work_dir: str | None = None,
    poll_interval_ms: float | None = None,
    scheduler_config: SchedulerConfig | None = None,
) -> StandaloneCluster:
    if scheduler_config is None:
        scheduler_config = SchedulerConfig(scheduling_policy=scheduling_policy)
    else:
        scheduler_config.scheduling_policy = scheduling_policy
    sched = SchedulerServer(scheduler_config)
    port = sched.start(0)
    cluster = StandaloneCluster(sched)
    try:
        for i in range(n_executors):
            cfg = ExecutorConfig(
                port=0, flight_port=0,
                scheduler_host="127.0.0.1", scheduler_port=port,
                task_slots=task_slots, scheduling_policy=scheduling_policy,
                backend=backend, device=device, work_dir=work_dir,
            )
            if poll_interval_ms is not None:
                cfg.poll_interval_ms = poll_interval_ms
            proc = ExecutorProcess(cfg, executor_id=f"standalone-{i}")
            proc.start()
            cluster.executors.append(proc)
    except BaseException:
        cluster.stop()
        raise
    return cluster
