"""A rehearsal of each cell on the CPU prints a result line of the
contract's shape, naming the CPU; the command itself refuses to run
without a card."""
import json
import os
import subprocess
import sys
import time

import pytest

from conftest import ROOT, SF

import run

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", ["tpch1-sa-repeat", "tpch1-sa-adhoc"])
@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal_result_line(cell, trace):
    result, compared = run.run_cell(cell, 2**31 + 3, 2, trace, device="cpu", scale_factor=SF,
                                    t_start=time.time())
    line = json.loads(json.dumps(result))
    assert KEYS <= set(line) and list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and line["device"]["kind"] == "cpu"
    want = run.cell_metrics(run.benchmark(), cell, trace)
    # readers of the device trace find nothing on the CPU and stay silent
    silent = {"device.idle_share", "grouped_sums_roofline"}
    assert set(line["metrics"]) == set(want) - silent
    assert all(m["value"] is not None for m in line["metrics"].values())
    assert [c[0] for c in compared][:3] == ["mismatches", "sum_gap", "avg_rel_gap"]


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tpch1-sa-repeat",
                          "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
