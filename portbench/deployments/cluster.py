"""A Ballista cluster on one card: a scheduler in the benchmark's process and
two executor processes that share the card, each planning for its share of
it, with one remote client a stream.

The layout of Ballista's ``docker-compose.yml`` (a scheduler and two
executors): each executor is ``python -m ballista_tpu_torch.executor
--backend torch --task-slots 4 --scheduling-policy pull`` run by
``portbench/cluster_executor.py``, with ``BALLISTA_EXECUTOR_DEVICE_SHARE``
set to the configuration's ``device_share`` (an environment variable, which
an executor that has no such option ignores). Each executor runs in a
directory of its own under the run's ``TMPDIR`` with a work directory
relative to it, so, as in two containers, a piece another executor wrote is
fetched over Flight, and the client fetches every result over Flight. The
executors' output goes to files in their directories.

What a window observes: each query's ``last_engine_metrics`` (the client's
counters and the job's stage metrics the scheduler folded), folded; with a
trace, the card's device profile from both executors' traces, reduced once
(``devtrace.reduce``). The peak of device memory is the sum of the two
processes' allocator peaks: an upper bound of the card's, since the two
need not peak at once.
"""
from __future__ import annotations

import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading
import time

import devtrace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# the standalone deployment's fold of a query's metrics
_spec = importlib.util.spec_from_file_location(
    "portbench_deployments_standalone_fold", os.path.join(HERE, "deployments", "standalone.py"))
standalone = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(standalone)
EXECUTORS = 2
# seconds both executors have to register, and to answer a window's begin or end
START_S = 60.0
ANSWER_S = 60.0
# seconds an executor has to stop after SIGTERM before it is killed
STOP_S = 30.0


def executor_command(device: str, port: int) -> list:
    """The command of one executor process."""
    return [sys.executable, os.path.join(HERE, "cluster_executor.py"), "--backend", "torch",
            "--device", device, "--task-slots", "4", "--scheduling-policy", "pull",
            "--scheduler-host", "127.0.0.1", "--scheduler-port", str(port), "--port", "0",
            "--flight-port", "0", "--work-dir", "work", "--log-level", "WARNING"]


def _tail(path: str, lines: int = 20) -> str:
    try:
        with open(path, errors="replace") as f:
            return "".join(f.readlines()[-lines:])
    except OSError:
        return ""


def merged_profile(start_ns: int, end_ns: int, traces: list) -> dict:
    """One reduction (``devtrace.reduce``) of both executors' events (names
    interned, ``cluster_executor.py``) over the window: from the last of the
    starts to its end. The events of all are on one clock (epoch
    nanoseconds), so the card's busy time is the union of both executors'
    device intervals. This process adds no events: it runs nothing on the
    card, and its streams' query labels are on threads the profiler does
    not record."""
    events = []
    for t in traces:
        names = t["names"]
        events += [(names[i], on_device, a, b) for i, on_device, a, b in t["events"]]
    return devtrace.reduce({"start_ns": max([start_ns] + [t["start_ns"] for t in traces]),
                            "end_ns": end_ns, "events": events})


class Executor:
    """One executor process and its control directory."""

    def __init__(self, index: int, root: str, device: str, port: int, share: float):
        self.dir = os.path.join(root, f"executor-{index}")
        self.control = os.path.join(self.dir, "control")
        os.makedirs(self.control, exist_ok=True)
        self.out = os.path.join(self.dir, "stdout.log")
        self.err = os.path.join(self.dir, "stderr.log")
        env = dict(os.environ, PORTBENCH_CONTROL=self.control,
                   BALLISTA_EXECUTOR_DEVICE_SHARE=repr(float(share)),
                   PYTHONPATH=os.pathsep.join(
                       p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(executor_command(device, port), cwd=self.dir,
                                         stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                                         env=env)

    def failure(self) -> str:
        """Why it is not running, or ''."""
        code = self.proc.poll()
        if code is None:
            return ""
        return f"executor {self.dir} exited with {code}:\n{_tail(self.err)}"

    def signal(self, name: str, text: str = "") -> None:
        path = os.path.join(self.control, name)
        with open(path + ".tmp", "w") as f:
            f.write(text)
        os.replace(path + ".tmp", path)

    def answer(self, name: str, deadline: float) -> str:
        path = os.path.join(self.control, name)
        while not os.path.exists(path):
            why = self.failure()
            if why or time.time() > deadline:
                raise RuntimeError(why or f"executor {self.dir} did not write {name}")
            time.sleep(0.01)
        with open(path) as f:
            return f.read()

    def stop(self) -> int:
        """SIGTERM, then SIGKILL after ``STOP_S``; returns the exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=STOP_S)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=STOP_S)
        return self.proc.returncode


class Cluster:
    def __init__(self, config: dict, device: str, settings: dict, work_dir: str, streams: int):
        from ballista_tpu_torch.client.context import BallistaContext
        from ballista_tpu_torch.config import BallistaConfig, SchedulerConfig
        from ballista_tpu_torch.scheduler.server import SchedulerServer

        self.device = device
        self.scheduler = SchedulerServer(SchedulerConfig())
        port = self.scheduler.start(0)
        self.executors: list = []
        try:
            for i in range(EXECUTORS):
                self.executors.append(Executor(i, work_dir, device, port, config["device_share"]))
            self._await_registered()
        except BaseException:
            self.close()
            raise
        self.contexts = [BallistaContext.remote("127.0.0.1", port, BallistaConfig(dict(settings)))
                         for _ in range(streams)]
        self.engine: dict = {}
        self._lock = threading.Lock()
        self.result: list = []

    def _await_registered(self) -> None:
        deadline = time.time() + START_S
        while len(self.scheduler.cluster.alive_executors()) < EXECUTORS:
            for e in self.executors:
                why = e.failure()
                if why:
                    raise RuntimeError(f"portbench: cluster did not start: {why}")
            if time.time() > deadline:
                raise RuntimeError(
                    f"portbench: cluster did not start: {EXECUTORS} executors did not register "
                    f"in {START_S:g} s:\n" + "\n".join(_tail(e.err) for e in self.executors))
            time.sleep(0.05)

    def register(self, paths: dict) -> None:
        for ctx in self.contexts:
            for name, path in paths.items():
                ctx.register_parquet(name, os.path.abspath(path))

    def _ran_on(self, job_id: str) -> set:
        """The executors that ran a task of the job (the scheduler's
        records; a stage adopted from the exchange cache ran none)."""
        with self.scheduler.tasks._lock:
            g = self.scheduler.tasks.get_job(job_id)
            return {t.executor_id for s in g.stages.values() for t in s.task_infos
                    if t is not None and t.status == "success"
                    and not getattr(s, "from_cache", False)} if g is not None else set()

    def warm(self, rounds: list, rotations: int) -> None:
        """The first ``rotations`` rounds of set-up's instances on every
        stream at once (stream ``i`` takes round ``r * streams + i``), and
        one more rotation where an executor ran no task of some query."""
        n = len(self.contexts)
        seen: dict = {}

        def rotation(r: int) -> None:
            errors: list = []

            def stream(i: int) -> None:
                try:
                    ctx = self.contexts[i]
                    for inst in rounds[(r * n + i) % len(rounds)]:
                        ctx.sql(inst.sql).collect()
                        ran = self._ran_on(ctx.last_job_id)
                        with self._lock:
                            seen.setdefault(inst.query, set()).update(ran)
                except Exception as e:  # noqa: BLE001 - raised below, in this thread
                    errors.append(e)

            threads = [threading.Thread(target=stream, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]

        for r in range(rotations):
            rotation(r)
        everyone = {e.executor_id for e in self.scheduler.cluster.alive_executors()}
        if any(not everyone <= ran for ran in seen.values()):
            rotation(rotations)

    def begin(self, trace: bool) -> None:
        self.engine = {}
        self.start_ns = time.time_ns()
        traced = trace and self.device.startswith("cuda")
        for e in self.executors:
            e.signal("begin", "trace" if traced else "notrace")
        deadline = time.time() + ANSWER_S
        for e in self.executors:
            e.answer("started", deadline)

    def run(self, stream: int, sql: str):
        ctx = self.contexts[stream]
        table = ctx.sql(sql).collect()
        with self._lock:
            standalone.fold(self.engine, ctx.last_engine_metrics)
        return table

    def end(self) -> dict:
        end_ns = time.time_ns()
        for e in self.executors:
            e.signal("end")
        deadline = time.time() + ANSWER_S
        self.result = [json.loads(e.answer("result.json", deadline)) for e in self.executors]
        out = {"engine": self.engine}
        traces = [r["trace"] for r in self.result if r["trace"]]
        if traces:
            out["profile"] = merged_profile(self.start_ns, end_ns, traces)
        return out

    def peak_bytes(self) -> int:
        return sum(int(r["peak_bytes"]) for r in self.result)

    def close(self) -> None:
        """Stops the executors and the scheduler; raises where an executor
        loaded a module of JAX or of the JAX package (its exit code 5)."""
        codes = [e.stop() for e in self.executors]
        self.executors = []
        if self.scheduler is not None:
            self.scheduler.stop()
            self.scheduler = None
        if 5 in codes:
            raise RuntimeError("portbench: an executor loaded a module of JAX or of the "
                               "JAX package")


def start(config: dict, device: str, settings: dict, work_dir: str, streams: int):
    return Cluster(config, device, settings, work_dir, streams)
