"""What a fresh executor's first query costs, and precompile hints on and off
for fresh executors, on one card.

    python3 -m ballista_tpu_torch.tools.precompile_ab [--pairs 3] [--sf 1]

Two parts, each timed on the card it runs on (its name and power limit are
printed with every line):

* ``profile``: a fresh process (as an executor is one) runs the port's
  scheduler and two torch executors in itself and answers q3 twice, with
  hints off and the leaf caches and the exchange cache out of the way, so
  the second run does the first one's work again. It times the CUDA
  context's creation, the grouped_sums library's load and first launch, and
  each q3 under ``torch.profiler`` (the CUDA runtime calls' host time by
  name: a lazily loaded kernel module is loaded inside the launch that first
  needs it, ``cudaMalloc`` and ``cudaHostAlloc`` are the allocators'
  growth), with its ``DeviceExecute`` spans and the allocator's segments.
  Once with CUDA's default module loading (lazy) and once with
  ``CUDA_MODULE_LOADING=EAGER``, where every module loads with the context.
* ``ab``: each side starts a scheduler in this process and two fresh
  ``python -m ballista_tpu_torch.executor --backend torch`` processes, and
  runs q3 then q5 once with ``ballista.engine.precompile`` false (the
  parent: no hints) or true (the change). Sides run off, on, on, off, ...
  for ``--pairs`` pairs. Each query prints its wall, its ``DeviceExecute``
  spans, ``op.CompileHidden.time_s`` and the ``compile_cache.*`` deltas its
  tasks reported; each side prints the warm runs its executors logged, with
  ``memory_reserved`` before and after each.

The TPC-H tables are generated at ``--sf`` (seed 42, 4 files per large
table) under ``--data`` (``.chip_smoke_data``, shared with
``chip_smoke.py``). The last line is one JSON object with every number; it
is also written to ``chiprun_out/precompile_ab.json``. Needs a card: with
``--device cpu`` it rehearses both parts on the CPU (no profile of the
card's runtime, no device numbers).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PARTS = 4
# runtime calls whose host time the profile reports
API_PREFIXES = ("cuda", "cu")
EXECUTOR_START_S = 120


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tables(data: str, sf: float) -> dict:
    from ballista_tpu_torch.models.tpch import generate_tpch

    return generate_tpch(os.path.join(data, f"tpch_sf{sf:g}_p{PARTS}"), sf=sf,
                         parts_per_table=PARTS)


def query(name: str) -> str:
    with open(os.path.join(REPO, "benchmarks", "queries", f"{name}.sql")) as f:
        return f.read()


def job_numbers(sched, job_id: str) -> dict:
    """A finished job's device spans, hidden time and warmed-key deltas."""
    graph = sched.tasks.get_job(job_id)
    metrics: dict = {}
    for s in graph.stages.values():
        for k, v in s.stage_metrics.items():
            metrics[k] = metrics.get(k, 0.0) + v
    spans = [s for s in (sched.traces.get(job_id) or []) if s["name"] == "DeviceExecute"]
    return {"device_execute_s": sum(s["dur_us"] for s in spans) / 1e6,
            "device_programs": len(spans),
            "compile_hidden_s": metrics.get("op.CompileHidden.time_s", 0.0),
            "compile_cache": {k: metrics.get(f"compile_cache.{k}", 0.0)
                              for k in ("opened", "hits", "misses", "evictions")}}


# ---- profile: a fresh process's first q3 ---------------------------------------------------
def _api_ms(prof) -> dict:
    """Host milliseconds of each CUDA runtime call in a profile, largest first."""
    out = {e.key: e.self_cpu_time_total / 1000.0 for e in prof.key_averages()
           if e.key.startswith(API_PREFIXES)}
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:12])


def profile_child(data: str, sf: float, device: str) -> dict:
    """Runs in a fresh process: see the module docstring's ``profile``."""
    import torch

    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.client.standalone import start_standalone_cluster
    from ballista_tpu_torch.config import BallistaConfig
    from ballista_tpu_torch.engine import torch_engine as TE
    from ballista_tpu_torch.ops import grouped_sums as GS

    on_card = device == "cuda"
    out: dict = {"module_loading": os.environ.get("CUDA_MODULE_LOADING", "LAZY (default)")}
    t0 = time.perf_counter()
    torch.zeros(1, device=device)
    if on_card:
        torch.cuda.synchronize()
    out["context_s"] = time.perf_counter() - t0
    ids = torch.zeros(64, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    GS.grouped_sums_multi([None], [ids == 0], ids, 4)
    if on_card:
        torch.cuda.synchronize()
    out["grouped_sums_first_call_s"] = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="precompile_ab_")
    t0 = time.perf_counter()
    cluster = start_standalone_cluster(n_executors=2, task_slots=2, device=device, work_dir=work)
    out["cluster_start_s"] = time.perf_counter() - t0
    try:
        ctx = BallistaContext.remote("127.0.0.1", cluster.scheduler_port, BallistaConfig({
            "ballista.engine.precompile": "false",
            "ballista.serving.exchange_cache": "false"}))
        for name, location in tables(data, sf).items():
            ctx.register_parquet(name, location)
        for run in ("first", "second"):
            TE.clear_caches()
            stats0 = torch.cuda.memory_stats() if on_card else {}
            reserved0 = torch.cuda.memory_reserved() if on_card else 0
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                ctx.sql(query("q3")).collect()
                wall = time.perf_counter() - t0
            stats1 = torch.cuda.memory_stats() if on_card else {}
            dev_us = sum(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
                         for e in prof.key_averages())
            out[run] = {
                "wall_s": wall, "runtime_api_ms": _api_ms(prof),
                "profiled_device_ms": dev_us / 1000.0,
                "segments_allocated": stats1.get("segment.all.allocated", 0)
                - stats0.get("segment.all.allocated", 0),
                "memory_reserved": [reserved0, torch.cuda.memory_reserved() if on_card else 0],
                **job_numbers(cluster.scheduler, ctx.last_job_id)}
    finally:
        cluster.stop()
    return out


def run_profile(data: str, sf: float, device: str, card: str) -> list:
    results = []
    for loading in (None, "EAGER"):
        env = {k: v for k, v in os.environ.items() if k != "CUDA_MODULE_LOADING"}
        if loading:
            env["CUDA_MODULE_LOADING"] = loading
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ballista_tpu_torch.tools.precompile_ab", "--profile-child",
             "--data", data, "--sf", str(sf), "--device", device],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"profile child failed: {proc.stderr[-3000:]}")
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        r["process_s"] = time.perf_counter() - t0
        results.append(r)
        first, second = r["first"], r["second"]
        print(f"profile [{r['module_loading']}]: context {r['context_s']:.3f} s, grouped_sums "
              f"first call {r['grouped_sums_first_call_s']:.3f} s, cluster start "
              f"{r['cluster_start_s']:.3f} s; q3 first {first['wall_s']:.3f} s (DeviceExecute "
              f"{first['device_execute_s']:.3f} s over {first['device_programs']} programs, "
              f"{first['segments_allocated']} segments allocated), second "
              f"{second['wall_s']:.3f} s (DeviceExecute {second['device_execute_s']:.3f} s, "
              f"{second['segments_allocated']} segments) [{card}]", flush=True)
        for run in ("first", "second"):
            print(f"profile [{r['module_loading']}] q3 {run} runtime calls (host ms): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in r[run]["runtime_api_ms"].items()),
                  flush=True)
    return results


# ---- ab: fresh executor processes with hints on and off ----------------------------------
WARM_RE = re.compile(r"warm run: ([0-9.]+) ms, memory_reserved (\d+) -> (\d+) bytes")


def start_executor(port: int, device: str, log_path: str):
    cmd = [sys.executable, "-m", "ballista_tpu_torch.executor", "--backend", "torch",
           "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port), "--port", "0",
           "--task-slots", "2", "--log-level", "INFO"]
    if device != "cuda":
        cmd += ["--device", device]
    log = open(log_path, "w")
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=log, text=True), log


def run_side(precompile: bool, data: str, sf: float, device: str, logs: str, n: int) -> dict:
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.config import BallistaConfig, SchedulerConfig
    from ballista_tpu_torch.scheduler.server import SchedulerServer

    sched = SchedulerServer(SchedulerConfig())
    port = sched.start(0)
    procs, paths = [], []
    out: dict = {"precompile": precompile, "queries": {}}
    try:
        t0 = time.perf_counter()
        for i in range(2):
            paths.append(os.path.join(logs, f"side{n}-executor{i}.log"))
            procs.append(start_executor(port, device, paths[-1]))
        for p, _log in procs:
            line = p.stdout.readline()
            if "started" not in line:
                raise RuntimeError(f"executor did not start: {line!r}")
        deadline = time.time() + EXECUTOR_START_S
        while len(sched.cluster.alive_executors()) < 2 and time.time() < deadline:
            time.sleep(0.05)
        out["executors_up_s"] = time.perf_counter() - t0
        ctx = BallistaContext.remote("127.0.0.1", port, BallistaConfig({
            "ballista.engine.precompile": "true" if precompile else "false"}))
        for name, location in tables(data, sf).items():
            ctx.register_parquet(name, location)
        for q in ("q3", "q5"):
            t0 = time.perf_counter()
            rows = ctx.sql(query(q)).collect().num_rows
            out["queries"][q] = {"wall_s": time.perf_counter() - t0, "rows": rows,
                                 **job_numbers(sched, ctx.last_job_id)}
    finally:
        for p, _log in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p, log in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
            log.close()
        sched.stop()
    warms = []
    for path in paths:
        with open(path) as f:
            warms += [(float(a), int(b), int(c)) for a, b, c in WARM_RE.findall(f.read())]
    out["warms"] = [{"ms": ms, "reserved_before": b, "reserved_after": a} for ms, b, a in warms]
    return out


def run_ab(pairs: int, data: str, sf: float, device: str, card: str) -> list:
    order = []
    for i in range(pairs):
        order += [False, True] if i % 2 == 0 else [True, False]
    logs = tempfile.mkdtemp(prefix="precompile_ab_logs_")
    sides = []
    for n, on in enumerate(order):
        side = run_side(on, data, sf, device, logs, n)
        sides.append(side)
        for q, r in side["queries"].items():
            cc = r["compile_cache"]
            print(f"ab side {n} precompile={'on' if on else 'off'} {q}: wall {r['wall_s']:.3f} s, "
                  f"rows {r['rows']}, DeviceExecute {r['device_execute_s']:.3f} s over "
                  f"{r['device_programs']} programs, op.CompileHidden.time_s "
                  f"{r['compile_hidden_s']:.6f}, compile_cache "
                  + ", ".join(f"{k} {v:g}" for k, v in cc.items()) + f" [{card}]", flush=True)
        w = side["warms"]
        print(f"ab side {n} precompile={'on' if on else 'off'}: executors up in "
              f"{side['executors_up_s']:.3f} s; {len(w)} warm runs, "
              f"{sum(x['ms'] for x in w):.3f} ms"
              + (f", memory_reserved {w[0]['reserved_before']} -> {w[-1]['reserved_after']} bytes"
                 if w else "") + f" [{card}]", flush=True)
    return sides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ballista_tpu_torch.tools.precompile_ab")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--data", default=os.path.join(REPO, ".chip_smoke_data"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--skip-profile", action="store_true")
    ap.add_argument("--profile-child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.profile_child:
        print(json.dumps(profile_child(args.data, args.sf, args.device)), flush=True)
        return 0
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("precompile_ab: CUDA is not available; pass --device cpu to rehearse",
              file=sys.stderr)
        return 2
    card = card_line() if args.device == "cuda" else "cpu"
    if args.device == "cuda":
        from ballista_tpu_torch.ops import cuda_build

        cuda_build.build()
    tables(args.data, args.sf)
    result = {"card": card, "sf": args.sf}
    if not args.skip_profile:
        result["profile"] = run_profile(args.data, args.sf, args.device, card)
    result["ab"] = run_ab(args.pairs, args.data, args.sf, args.device, card)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "precompile_ab.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
