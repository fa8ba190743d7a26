"""The resident deployment runs only where the program's device leaf cache
may hold the configuration's working set, and says so before any data is
made."""
import pytest

import run

CONFIG = run.load("configs", "tpch10-standalone")


@pytest.fixture
def resident(monkeypatch):
    dep = run.module("deployments", CONFIG["deployment"])
    monkeypatch.setattr(dep.standalone, "start", lambda *a: "started")
    return dep


def test_a_cache_below_the_working_set_stops_the_run(resident, monkeypatch):
    monkeypatch.setattr(resident, "device_cache_bytes", lambda d: CONFIG["resident_bytes"] - 1)
    with pytest.raises(SystemExit, match="leaf cache holds"):
        resident.start(CONFIG, "cuda", {}, "", 1)


def test_a_cache_that_holds_it_starts_standalone(resident, monkeypatch):
    monkeypatch.setattr(resident, "device_cache_bytes", lambda d: CONFIG["resident_bytes"])
    assert resident.start(CONFIG, "cuda", {}, "", 1) == "started"


def test_the_cpu_checks_nothing(resident, monkeypatch):
    monkeypatch.setattr(resident, "device_cache_bytes", lambda d: 0)
    assert resident.start(CONFIG, "cpu", {}, "", 1) == "started"


def test_the_sizing_rule_gives_a_cpu_nothing():
    # a CPU has no device budget, so the rule sizes the device cache to 0
    assert run.module("deployments", CONFIG["deployment"]).device_cache_bytes("cpu") == 0
