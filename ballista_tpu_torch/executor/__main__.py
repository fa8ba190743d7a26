"""Executor binary: ``python -m ballista_tpu_torch.executor``.

Reference analog: ``ballista-executor`` (``executor/src/bin/main.rs`` +
``executor_config_spec.toml``).

``--backend torch`` (the default) runs stages on ``--device``, ``cuda`` unless
``--device cpu`` is given; without CUDA the executor exits with status 2 and
says why. ``--backend numpy`` runs the host engine.

The ``--mesh-group-*`` flags make the executor a member of a mesh group
(``parallel/multihost.py``): every member names the same group id, size and
coordinator (host:port of the store that member 0 hosts), its own process
id, and its shard count; the executor joins the group before it registers.
"""
from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time

from ballista_tpu_torch.config import ExecutorConfig
from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.executor.process import ExecutorProcess


def main() -> None:
    p = argparse.ArgumentParser("ballista-executor (PyTorch/CUDA)")
    env = os.environ.get
    p.add_argument("--bind-host", default=env("BALLISTA_EXECUTOR_BIND_HOST", "0.0.0.0"))
    p.add_argument("--port", type=int, default=int(env("BALLISTA_EXECUTOR_PORT", "50051")))
    p.add_argument("--flight-port", type=int, default=int(env("BALLISTA_EXECUTOR_FLIGHT_PORT", "0")))
    p.add_argument("--scheduler-host", default=env("BALLISTA_SCHEDULER_HOST", "localhost"))
    p.add_argument("--scheduler-port", type=int, default=int(env("BALLISTA_SCHEDULER_PORT", "50050")))
    p.add_argument("--scheduler-addrs", default=env("BALLISTA_SCHEDULER_ADDRS", None),
                   help="comma-separated host:port fallback list for scheduler HA")
    p.add_argument("--task-slots", type=int, default=int(env("BALLISTA_EXECUTOR_TASK_SLOTS", "4")))
    p.add_argument("--work-dir", default=env("BALLISTA_EXECUTOR_WORK_DIR", None))
    p.add_argument("--scheduling-policy", choices=["pull", "push"],
                   default=env("BALLISTA_EXECUTOR_SCHEDULING_POLICY", "pull"))
    p.add_argument("--heartbeat-interval-s", type=float, default=None,
                   help="heartbeat cadence (ballista.executor."
                        "heartbeat_interval_s; default 60, or the "
                        "BALLISTA_EXECUTOR_HEARTBEAT_INTERVAL_S env var — "
                        "read by ExecutorConfig, the single source of "
                        "truth); the loop adds ±10%% jitter so a scheduler "
                        "restart doesn't thunder-herd")
    p.add_argument("--poll-interval-ms", type=float,
                   default=float(env("BALLISTA_EXECUTOR_POLL_INTERVAL_MS", "100")),
                   help="pull-mode task poll cadence; benchmarks spawning "
                        "real executor processes tighten this so stage "
                        "handoff latency does not drown the measured effect")
    p.add_argument("--backend", choices=["torch", "numpy"],
                   default=env("BALLISTA_EXECUTOR_BACKEND", "torch"))
    p.add_argument("--device", default=env("BALLISTA_EXECUTOR_DEVICE", None),
                   help="the torch engine's device (default cuda; 'cpu' runs "
                        "it on the host)")
    p.add_argument("--advertise-host", default=env("BALLISTA_EXECUTOR_ADVERTISE_HOST", None))
    # mesh-group membership: executor processes whose fused stages run as one
    # collective program across them (gang-scheduled by the scheduler)
    p.add_argument("--mesh-group-id", default=env("BALLISTA_MESH_GROUP_ID", None))
    p.add_argument("--mesh-group-coordinator",
                   default=env("BALLISTA_MESH_GROUP_COORDINATOR", None),
                   help="host:port of the group's store, hosted by process 0")
    p.add_argument("--mesh-group-size", type=int,
                   default=int(env("BALLISTA_MESH_GROUP_SIZE", "0")))
    p.add_argument("--mesh-group-process-id", type=int,
                   default=int(env("BALLISTA_MESH_GROUP_PROCESS_ID", "0")))
    p.add_argument("--mesh-group-local-devices", type=int,
                   default=int(env("BALLISTA_MESH_GROUP_LOCAL_DEVICES", "0")) or None,
                   help="this process's shard count (default: one per visible card)")
    p.add_argument("--plugin-dir", default=env("BALLISTA_EXECUTOR_PLUGIN_DIR", None),
                   help="directory of UDF plugin modules loaded at startup "
                        "(reference: plugin_manager.rs startup scan)")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--log-dir", default=env("BALLISTA_EXECUTOR_LOG_DIR", None),
                   help="rolling log files instead of stdout")
    p.add_argument("--log-rotation-policy",
                   choices=["minutely", "hourly", "daily", "never"],
                   default=env("BALLISTA_EXECUTOR_LOG_ROTATION_POLICY", "daily"))
    args = p.parse_args()

    handlers = None
    if args.log_dir:
        # rolling executor logs (reference: executor_process.rs:108-143 +
        # LogRotationPolicy)
        import logging.handlers as _lh  # noqa: F401 - registers logging.handlers
        import os as _os

        _os.makedirs(args.log_dir, exist_ok=True)
        path = _os.path.join(args.log_dir, "ballista-executor.log")
        if args.log_rotation_policy == "never":
            handlers = [logging.FileHandler(path)]
        else:
            when = {"minutely": "M", "hourly": "H", "daily": "D"}[args.log_rotation_policy]
            handlers = [logging.handlers.TimedRotatingFileHandler(path, when=when, backupCount=24)]
    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
        handlers=handlers,
    )
    cfg = ExecutorConfig(
        bind_host=args.bind_host,
        port=args.port,
        flight_port=args.flight_port,
        scheduler_host=args.scheduler_host,
        scheduler_port=args.scheduler_port,
        task_slots=args.task_slots,
        work_dir=args.work_dir,
        scheduling_policy=args.scheduling_policy,
        poll_interval_ms=args.poll_interval_ms,
        # only override when the flag was given: ExecutorConfig's
        # default_factory already reads the env var / 60s default
        **(
            {"heartbeat_interval_seconds": args.heartbeat_interval_s}
            if args.heartbeat_interval_s is not None else {}
        ),
        backend=args.backend,
        device=args.device,
        advertise_host=args.advertise_host,
        mesh_group_id=args.mesh_group_id,
        mesh_group_coordinator=args.mesh_group_coordinator,
        mesh_group_size=args.mesh_group_size,
        mesh_group_process_id=args.mesh_group_process_id,
        mesh_group_local_devices=args.mesh_group_local_devices,
        scheduler_addrs=args.scheduler_addrs.split(",") if args.scheduler_addrs else None,
    )
    from ballista_tpu_torch.utils.udf import load_plugins

    load_plugins(args.plugin_dir)
    try:
        proc = ExecutorProcess(cfg)
    except BallistaError as e:
        print(f"ballista-executor: {e}", file=sys.stderr, flush=True)
        sys.exit(2)
    proc.start()
    print(f"ballista-tpu-torch executor {proc.executor_id} started "
          f"(backend={args.backend}, device={cfg.device}, slots={args.task_slots}, "
          f"work dir {proc.work_dir})", flush=True)

    stop = [False]
    signal.signal(signal.SIGINT, lambda *a: stop.__setitem__(0, True))
    signal.signal(signal.SIGTERM, lambda *a: stop.__setitem__(0, True))
    while not stop[0]:
        time.sleep(0.2)
    proc.stop()


if __name__ == "__main__":
    main()
