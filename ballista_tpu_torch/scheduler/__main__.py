"""Scheduler binary: ``python -m ballista_tpu_torch.scheduler``.

Reference analog: ``ballista-scheduler`` (``scheduler/src/bin/main.rs`` +
``scheduler_config_spec.toml``). Env prefix BALLISTA_SCHEDULER_* mirrors the
reference's configure_me env support.

``--api-port N`` serves the REST API and web UI (``scheduler/api.py``) on
port N. ``--cluster-backend`` keeps the cluster state in memory (default) or
durably: ``kv`` in the sqlite file ``--kv-path`` (an HA pair on one host
shares it), ``grpc-kv`` or ``etcd`` at ``--kv-addr`` (``python -m
ballista_tpu_torch.scheduler.kv_service`` serves both wires).
"""
from __future__ import annotations

import argparse
import logging
import os
import signal
import time

from ballista_tpu_torch.config import SchedulerConfig
from ballista_tpu_torch.scheduler.server import SchedulerServer


def main() -> None:
    p = argparse.ArgumentParser("ballista-scheduler (PyTorch/CUDA port)")
    env = os.environ.get
    p.add_argument("--bind-host", default=env("BALLISTA_SCHEDULER_BIND_HOST", "0.0.0.0"))
    p.add_argument("--bind-port", type=int, default=int(env("BALLISTA_SCHEDULER_BIND_PORT", "50050")))
    p.add_argument("--scheduling-policy", choices=["pull", "push"],
                   default=env("BALLISTA_SCHEDULER_SCHEDULING_POLICY", "pull"))
    p.add_argument("--task-distribution", choices=["bias", "round-robin", "consistent-hash"],
                   default=env("BALLISTA_SCHEDULER_TASK_DISTRIBUTION", "bias"))
    p.add_argument("--executor-timeout-seconds", type=float, default=180.0)
    p.add_argument("--api-port", type=int, default=int(env("BALLISTA_SCHEDULER_API_PORT", "0")),
                   help="REST API and web UI port (0 = disabled)")
    p.add_argument("--cluster-backend", choices=["memory", "kv", "grpc-kv", "etcd"],
                   default=env("BALLISTA_SCHEDULER_CLUSTER_BACKEND", "memory"))
    p.add_argument("--kv-addr", default=env("BALLISTA_SCHEDULER_KV_ADDR", None),
                   help="host:port of the networked kv service (grpc-kv and etcd backends)")
    p.add_argument("--kv-path", default=env("BALLISTA_SCHEDULER_KV_PATH", None),
                   help="sqlite file for the kv backend (shared across an HA pair)")
    p.add_argument("--job-lease-ttl-seconds", type=float,
                   default=float(env("BALLISTA_SCHEDULER_JOB_LEASE_TTL", "60")))
    p.add_argument("--expiry-interval-seconds", type=float,
                   default=float(env("BALLISTA_SCHEDULER_EXPIRY_INTERVAL", "15")))
    p.add_argument("--plugin-dir", default=env("BALLISTA_SCHEDULER_PLUGIN_DIR", None),
                   help="directory of UDF plugin modules loaded at startup — "
                        "the SQL planner must know plugin function names/types "
                        "(reference: plugin_manager.rs startup scan)")
    p.add_argument("--obs-recorder", type=lambda v: v.lower() not in ("0", "false"),
                   default=env("BALLISTA_SCHEDULER_OBS_RECORDER", "true").lower() not in ("0", "false"),
                   help="flight recorder: latency histograms + gauge time series")
    p.add_argument("--obs-sample-interval", type=float,
                   default=float(env("BALLISTA_SCHEDULER_OBS_SAMPLE_INTERVAL", "5.0")),
                   help="gauge sampling interval (seconds)")
    p.add_argument("--obs-profiler", action="store_true",
                   default=env("BALLISTA_SCHEDULER_OBS_PROFILER", "").lower() in ("1", "true"),
                   help="start the wall-clock sampling profiler")
    p.add_argument("--obs-profiler-hz", type=float,
                   default=float(env("BALLISTA_SCHEDULER_OBS_PROFILER_HZ", "67")))
    p.add_argument("--trace-max-jobs", type=int,
                   default=int(env("BALLISTA_SCHEDULER_TRACE_MAX_JOBS", "64")),
                   help="trace store LRU bound (jobs)")
    p.add_argument("--trace-max-bytes", type=int,
                   default=int(env("BALLISTA_SCHEDULER_TRACE_MAX_BYTES", str(64 * 1024 * 1024))),
                   help="trace store byte budget across retained jobs")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--config", default=None,
                   help="JSON config file; keys match the CLI flag names "
                        "(reference: configure_me's optional config file)")
    args = p.parse_args()
    if args.config:
        import json as _json

        for k, v in _json.load(open(args.config)).items():
            attr = k.replace("-", "_")
            if hasattr(args, attr):
                setattr(args, attr, v)

    logging.basicConfig(
        level=args.log_level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    cfg = SchedulerConfig(
        bind_host=args.bind_host,
        bind_port=args.bind_port,
        scheduling_policy=args.scheduling_policy,
        task_distribution=args.task_distribution,
        executor_timeout_seconds=args.executor_timeout_seconds,
        expire_dead_executors_interval_seconds=args.expiry_interval_seconds,
        cluster_backend=args.cluster_backend,
        kv_path=args.kv_path,
        kv_addr=args.kv_addr,
        job_lease_ttl_seconds=args.job_lease_ttl_seconds,
        obs_recorder_enabled=args.obs_recorder,
        obs_sample_interval_s=args.obs_sample_interval,
        obs_profiler=args.obs_profiler,
        obs_profiler_hz=args.obs_profiler_hz,
        trace_max_jobs=args.trace_max_jobs,
        trace_max_bytes=args.trace_max_bytes,
    )
    from ballista_tpu_torch.utils.udf import load_plugins

    load_plugins(args.plugin_dir)
    server = SchedulerServer(cfg)
    port = server.start(args.bind_port)
    print(f"ballista-tpu-torch scheduler listening on {args.bind_host}:{port}", flush=True)

    api = None
    if args.api_port:
        from ballista_tpu_torch.scheduler.api import start_api_server

        api = start_api_server(server, args.bind_host, args.api_port)
        print(f"ballista-tpu-torch REST API on {args.bind_host}:{api.server_address[1]}",
              flush=True)

    stop = [False]
    signal.signal(signal.SIGINT, lambda *a: stop.__setitem__(0, True))
    signal.signal(signal.SIGTERM, lambda *a: stop.__setitem__(0, True))
    while not stop[0]:
        time.sleep(0.2)
    if api is not None:
        api.shutdown()
    server.stop()


if __name__ == "__main__":
    main()
