"""The reduction of a device trace: busy time is the union of device
intervals inside the window, idle gaps are named by the host."""
import pytest

import devtrace

TRACE = {"start_ns": 0, "end_ns": 100, "events": [
    ("portbench.q1", False, 0, 100), ("aten::nonzero", False, 5, 10),
    ("kernel_a", True, 12, 20), ("kernel_b", True, 15, 30), ("kernel_a", True, 60, 70),
    ("cudaMemcpy", False, 30, 40), ("kernel_c", True, 95, 130)]}


def test_busy_is_the_union_inside_the_window():
    got = devtrace.reduce(TRACE)
    # [12, 30] and [60, 70] and [95, 100] (clipped)
    assert got["busy_s"] == pytest.approx(33e-9)
    assert got["window_s"] == pytest.approx(100e-9)
    assert got["kernels_s"]["kernel_a"] == pytest.approx(18e-9)


def test_gaps_are_named_by_the_query_and_the_host_op():
    gaps = devtrace.reduce(TRACE)["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([30e-9, 25e-9, 12e-9])
    assert gaps[0][0] == "portbench.q1 / after cudaMemcpy"
    assert gaps[2][0] == "portbench.q1 / aten::nonzero"


def test_kernel_names_are_shortened():
    name = "void ns::k<2, ns::F<long>, std::array<char*, 3ul> >(int, ns::F<long>)"
    assert devtrace.short(name) == "ns::k<2, ns::F<long>, std::array<char*, 3ul> >"
