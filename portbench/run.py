#!/usr/bin/env python3
"""The benchmark of ``ballista_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Every piece is found by name, so a cell, a configuration or a metric is
added by adding files:

- ``workloads/<cell>.json``: the cell's configuration and traffic mix
  (streams, the rotation of queries, validation or drawn literals);
- ``configs/<config>.json``: the deployment (``deployments/<kind>.py``),
  the data (TPC-H scale factor, tables, files per table), the session's
  settings, the guarantees and the limit of each number compared;
- ``queries/<query>.{sql,json,py}``: the spec's text with its substitution
  slots, the parameters' validation values and qgen ranges, and the exact
  numpy answer;
- ``metrics/<metric>.py``: a reader ``read(record)`` of one metric.

A run: generate the tables from the seed and write them as parquet under
``TMPDIR``; start the deployment; run each query of the rotation once (set-up
ends here: ``setup_s``); send the cell's streams of queries, closed loop, for
``--seconds`` and on to the end of each stream's rotation (with ``--trace 1`` under ``torch.profiler``, counting the
engine's counters and grouped_sums' bytes); stop the deployment; compare a
seeded sample of the answers with the exact reference; print the result as
the last line of standard output, and each number compared beside its limit
as the last lines of standard error. With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

Exits with 3 and prints no result when CUDA is missing or has fewer cards
than the cell asks for, and with 4 when a module of JAX or of the JAX
package was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the benchmark's own modules, and the port at the root of the checkout
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

import datagen  # noqa: E402
import reference  # noqa: E402
import traffic  # noqa: E402

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "ballista_tpu")
# build and kernel caches of the program, at a fixed path in the checkout
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")


def load(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``<kind>/<name>.py`` loaded as a module of its own."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(path):
        return {"workloads": [], "end_to_end": [], "per_layer": []}
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The names of the metrics a run of ``cell`` reports."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m["name"] for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU's."""
    import torch

    if not torch.cuda.is_available():
        return {"kind": "cpu", "power_limit": "not measured"}
    limit = "not measured"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip() or limit
    except (OSError, subprocess.TimeoutExpired):
        pass
    return {"kind": torch.cuda.get_device_name(0), "power_limit": limit}


class Window:
    """Closed-loop streams over one window. Each stream sends its next
    instance when its last answer came, and stops at its first rotation
    boundary after ``seconds``. The window ends with the last answer, so it
    holds whole rotations: every query of the mix as often as the others,
    whatever query a deadline would have cut, and all the time its work
    took."""

    def __init__(self, system, streams: list, seconds: float):
        self.system, self.streams, self.seconds = system, streams, seconds
        self.done: list = []  # (stream, instance, start, end, table or None, error)
        self._lock = threading.Lock()

    def _loop(self, i: int, deadline: float) -> None:
        import torch.profiler

        stream = self.streams[i]
        while True:
            now = time.perf_counter()
            if now >= deadline and stream.at_rotation_start:
                return
            inst = stream.next()
            table, error = None, None
            start = time.perf_counter()
            try:
                with torch.profiler.record_function(f"portbench.{inst.query}"):
                    table = self.system.run(i, inst.sql)
            except Exception as e:  # noqa: BLE001 - a failed query counts as failed
                error = f"{type(e).__name__}: {e}"
            end = time.perf_counter()
            with self._lock:
                self.done.append((i, inst, start, end, table, error))

    def run(self) -> float:
        """Runs the streams; returns the window's length in seconds."""
        begin = time.perf_counter()
        deadline = begin + self.seconds
        if len(self.streams) == 1:
            self._loop(0, deadline)
        else:
            threads = [threading.Thread(target=self._loop, args=(i, deadline), daemon=True)
                       for i in range(len(self.streams))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return max((d[3] for d in self.done), default=deadline) - begin


def sample_keys(done: list, n: int, seed: int) -> set:
    """Up to ``n`` distinct instances to check, drawn from the seed, spread
    over the queries."""
    by_query: dict = {}
    for _s, inst, *_ in done:
        by_query.setdefault(inst.query, {})[inst.key] = None
    rng = np.random.default_rng([seed % 2**64, 7])
    pools = {q: [keys_[i] for i in rng.permutation(len(keys_))]
             for q, keys_ in ((q, list(k)) for q, k in sorted(by_query.items()))}
    out: set = set()
    while len(out) < n and any(pools.values()):
        for q in sorted(pools):
            if pools[q] and len(out) < n:
                out.add(pools[q].pop())
    return out


def check(done: list, tables: dict, config: dict, seed: int, n: int) -> tuple:
    """Every answer of a seeded sample of the window's instances against
    the exact reference: (readings, limits, answers checked)."""
    keys = sample_keys(done, n, seed)
    cols = reference.Tables(tables)
    exact: dict = {}
    readings, checked = [], 0
    for _s, inst, _a, _b, table, error in done:
        if inst.key not in keys or error is not None:
            continue
        if inst.key not in exact:
            exact[inst.key] = reference.answer(cols, inst.query, dict(inst.params))
        kinds = traffic.query_spec(inst.query).get("inexact", {})
        readings.append(reference.compare(table, exact[inst.key], kinds))
        checked += 1
    return reference.worst(readings), config["limits"], checked


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             scale_factor: float = None, settings: dict = None, bench: dict = None,
             t_start: float = None) -> tuple:
    """One run of one cell. ``device``, ``scale_factor`` and ``settings``
    are for rehearsals and checks off the card (the command line gives
    none). Returns (result, compared)."""
    t_start = T_START if t_start is None else t_start
    bench = benchmark() if bench is None else bench
    mix = load("workloads", workload)
    config = load("configs", mix["config"])
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is not None and (entry["config"], entry["traffic"]) != (mix["config"], mix["traffic"]):
        raise SystemExit(f"portbench: {workload}: BENCHMARK.json and workloads/{workload}.json "
                         "name different configurations or traffic")
    sf = config["scale_factor"] if scale_factor is None else scale_factor
    data_root = tempfile.mkdtemp(prefix="portbench-data-")
    system = None
    try:
        steps = [("start", t_start)]
        session = dict(config.get("settings", {}), **(settings or {}))
        system = module("deployments", config["deployment"]).start(
            config, device, session, data_root, mix["streams"])
        steps.append(("deploy", time.time()))
        tables = datagen.make_tables(sf, seed, config["tables"])
        steps.append(("generate", time.time()))
        paths = datagen.write_tables(tables, os.path.join(data_root, "tables"),
                                     config["files_per_table"])
        steps.append(("write", time.time()))
        system.register(paths)
        steps.append(("register", time.time()))
        system.warm(traffic.warmup(mix, seed), mix["warmup_rotations"])
        steps.append(("warm", time.time()))
        streams = [traffic.Stream(mix, seed, i) for i in range(mix["streams"])]
        setup_s = time.time() - t_start
        print("set-up: " + ", ".join(f"{name} {t - steps[i][1]:.3f} s"
                                     for i, (name, t) in enumerate(steps[1:])), file=sys.stderr)
        system.begin(trace)
        window = Window(system, streams, seconds)
        window_s = window.run()
        observed = system.end()
        peak = system.peak_bytes()
        system.close()
        system = None
        gc.collect()
        done = window.done
        walls: dict = {}
        for d in done:
            walls.setdefault(d[1].query, []).append(d[3] - d[2])
        for q, w in sorted(walls.items()):
            print(f"window {q}: {len(w)} runs, wall median {statistics.median(w):.4f} s, "
                  f"min {min(w):.4f}, max {max(w):.4f}", file=sys.stderr)
        answered = [d for d in done if d[5] is None]
        info = card()
        record = dict(observed, seconds=window_s, setup_s=setup_s, card=info,
                      latencies_s=[d[3] - d[2] for d in answered], queries=len(answered))
        names = cell_metrics(bench, workload, trace)
        units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
        metrics = {}
        for name in names:
            value = module("metrics", name).read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
        worst, limits, checked = check(done, tables, config, seed, mix["check_answers"])
        failed = sum(d[5] is not None for d in done)
        compared = [(k, worst[k], limits[k]) for k in ("mismatches", "sum_gap", "avg_rel_gap")]
        compared += [("failed", failed, 0), ("answers_unchecked", int(checked == 0), 0)]
        correct = all(v <= lim for _k, v, lim in compared)
        result = {
            "correct": bool(correct), "attempted": len(done), "failed": failed,
            "metrics": metrics,
            "device": {"platform": "gpu" if device.startswith("cuda") else "cpu",
                       "kind": info["kind"],
                       "count": 1 if device.startswith("cuda") else 0,
                       "memory_peak_bytes": int(peak)},
        }
        if trace and record.get("profile"):
            prof = record["profile"]
            result["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
            result["breakdown"] = {"device_ops": prof["device_ops"],
                                   "idle_gaps": prof["idle_gaps"]}
        result["power_limit"] = info["power_limit"]
        result["errors"] = sorted({d[5] for d in done if d[5] is not None})[:3]
        result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
        return result, compared
    finally:
        if system is not None:
            system.close()
        shutil.rmtree(data_root, ignore_errors=True)


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds; what the program builds itself goes
    to its own ``_build/`` there."""
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE_DIR, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE_DIR, "torch_extensions"))
    # keep libraries from loading JAX on their own
    os.environ["USE_FLAX"] = "0"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()
    set_cache_dirs()
    # the deployment's host environment (thread counts), before torch loads
    os.environ.update(load("configs", load("workloads", args.workload)["config"])
                      .get("environment", {}))
    bench = benchmark()
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, compared = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, value, limit in compared:
        print(f"compared {name}: {value!r} (limit {limit})", file=sys.stderr)
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
