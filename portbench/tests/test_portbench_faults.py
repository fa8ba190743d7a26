"""The comparison that decides ``correct`` fails the control and every
planted fault: the timed path broken underneath, the rest of a run as it
is (on the CPU at a small scale; the control also on a card)."""
import os
import time

import pytest

from conftest import SF

import faults
import run

# the program's own lower precision: decimals as float64 on the device
CONTROL = {"ballista.tpu.native_dtypes": "false"}


def rehearse(cell, seed, **kw):
    result, _ = run.run_cell(cell, seed, 2, False, scale_factor=kw.pop("sf", SF),
                             device=kw.pop("device", "cpu"), t_start=time.time(), **kw)
    return result


@pytest.mark.parametrize("cell", ["tpch1-sa-repeat", "tpch1-sa-adhoc"])
def test_control_is_not_correct(cell):
    result = rehearse(cell, 2**31 + 21, settings=CONTROL)
    assert result["correct"] is False and result["compared"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("tpch1-sa-repeat", "answer"), ("tpch1-sa-repeat", "half_batch"),
    ("tpch1-sa-adhoc", "answer"), ("tpch1-sa-adhoc", "half_batch"),
    ("tpch1-sa-adhoc", "stale_leaf"),
])
def test_fault_in_this_process_is_not_correct(cell, fault, restore_port):
    faults.plant(fault)
    assert rehearse(cell, 2**31 + 22)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tpch1-sa-repeat", "tpch1-sa-adhoc"])
def test_control_on_the_card_is_not_correct(cell, card):
    result = rehearse(cell, 2**31 + 24, settings=CONTROL, device="cuda", sf=0.1)
    assert result["correct"] is False and result["compared"]["mismatches"]["value"] > 0
