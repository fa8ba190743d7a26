"""The ``cluster`` deployment (``tpch1-cl2-adhoc-2s``) on the CPU: a
rehearsal prints a correct result line with its per-layer metrics, a lost
shuffle piece makes it incorrect, a cluster that cannot start says so within
its deadline, and the card's trace is the union of both executors'."""
import json
import sys
import time

import pytest

from conftest import SF

import run

CELL = "tpch1-cl2-adhoc-2s"
CONFIG = run.load("configs", "tpch1-cluster2")
NEW = ("client.wait_ms_per_query", "scheduler.task_wait_ms_per_query",
       "shuffle.write_ms_per_query", "shuffle.read_ms_per_query")


def rehearse(seed, trace):
    result, compared = run.run_cell(CELL, seed, 2, trace, device="cpu", scale_factor=SF,
                                    t_start=time.time())
    return json.loads(json.dumps(result)), compared


def test_traced_rehearsal_is_correct_and_reads_the_cluster_layers():
    line, compared = rehearse(2**31 + 41, True)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 10
    assert [c[0] for c in compared][:3] == ["mismatches", "sum_gap", "avg_rel_gap"]
    assert set(line["metrics"]) == set(run.cell_metrics(run.benchmark(), CELL, True)) == set(NEW)
    assert all(m["value"] is not None and m["value"] > 0 for m in line["metrics"].values())


def test_untraced_rehearsal_reports_the_end_to_end_metrics():
    line, _ = rehearse(2**31 + 42, False)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"queries_per_s", "setup_s"}


def test_a_lost_shuffle_piece_is_not_correct(monkeypatch):
    """Every second piece a stage writes never reaches the stage above it:
    the scheduler, in this process, drops its location (the partition's
    list of pieces stays, so the consumer reads what is left)."""
    from ballista_tpu_torch.scheduler import execution_graph as EG

    real = EG.StageOutput.add
    seen = [0]

    def lossy(self, loc):
        real(self, loc)
        seen[0] += 1
        if seen[0] % 2 == 0:
            self.partition_locations[loc["partition_id"]].pop()

    monkeypatch.setattr(EG.StageOutput, "add", lossy)
    line, _ = rehearse(2**31 + 43, False)
    assert line["correct"] is False


@pytest.fixture
def cluster_module():
    return run.module("deployments", "cluster")


def test_an_executor_that_exits_at_start_stops_the_start(cluster_module, monkeypatch, tmp_path):
    monkeypatch.setattr(cluster_module, "executor_command",
                        lambda device, port: [sys.executable, "-c", "import sys; sys.exit(3)"])
    t0 = time.time()
    with pytest.raises(RuntimeError, match="exited with 3"):
        cluster_module.start(CONFIG, "cpu", {}, str(tmp_path), 2)
    assert time.time() - t0 < cluster_module.START_S


def test_an_executor_that_never_registers_stops_the_start(cluster_module, monkeypatch, tmp_path):
    monkeypatch.setattr(cluster_module, "START_S", 2.0)
    monkeypatch.setattr(cluster_module, "executor_command",
                        lambda device, port: [sys.executable, "-c", "import time; time.sleep(600)"])
    t0 = time.time()
    with pytest.raises(RuntimeError, match="did not register"):
        cluster_module.start(CONFIG, "cpu", {}, str(tmp_path), 2)
    assert time.time() - t0 < 40  # the deadline, and the processes stopped


def test_the_merged_trace_is_the_union_of_both_executors(cluster_module):
    def executor(start, events):
        names = sorted({k for k, _, _, _ in events})
        return {"start_ns": start, "end_ns": 120, "names": names,
                "events": [[names.index(k), dev, a, b] for k, dev, a, b in events]}

    one = executor(5, [("kernel_a", True, 10, 30), ("kernel_b", True, 60, 70),
                       ("cudaLaunchKernel", False, 41, 45)])
    two = executor(8, [("kernel_a", True, 20, 40), ("kernel_c", True, 90, 130)])
    got = cluster_module.merged_profile(0, 100, [one, two])
    # [10, 40], [60, 70] and [90, 100] (clipped) inside the window [8, 100]
    assert got["busy_s"] == pytest.approx(50e-9)
    assert got["window_s"] == pytest.approx(92e-9)
    assert got["kernels_s"]["kernel_a"] == pytest.approx(40e-9)
    assert got["idle_gaps"][0] == ["after cudaLaunchKernel", pytest.approx(20e-9)]


def test_an_executor_that_loaded_the_jax_package_fails_the_run(cluster_module, monkeypatch,
                                                               tmp_path):
    """``cluster_executor.py`` exits with 5 where a forbidden module was
    loaded; the deployment's close raises on it."""
    code = ("import signal, sys, time; "
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(5)); time.sleep(600)")
    monkeypatch.setattr(cluster_module, "START_S", 1.0)
    monkeypatch.setattr(cluster_module, "executor_command",
                        lambda device, port: [sys.executable, "-c", code])
    with pytest.raises(RuntimeError, match="JAX package"):
        cluster_module.start(CONFIG, "cpu", {}, str(tmp_path), 2)
