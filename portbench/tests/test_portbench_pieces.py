"""Every piece of the benchmark is found by its name, and a new one is
found with no code edited."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import PORTBENCH, ROOT

import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_resolve_to_files():
    b = bench()
    assert b["command"] == ["python3", "portbench/run.py"] and b["paths"] == ["portbench"]
    for c in b["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(ROOT, c["file"]))
        assert run.load("configs", c["name"])["deployment"]
    for w in b["workloads"]:
        mix = run.load("workloads", w["name"])
        assert (mix["config"], mix["traffic"]) == (w["config"], w["traffic"])
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
        run.module("deployments", run.load("configs", mix["config"])["deployment"])
        for q in mix["rotation"]:
            for ext in ("sql", "json", "py"):
                assert os.path.exists(os.path.join(PORTBENCH, "queries", f"{q}.{ext}"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and hasattr(run.module("metrics", m["name"]), "read")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        e2e = run.cell_metrics(b, w["name"], trace=False)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(b, w["name"], trace=True)
    per_layer_moves = {m["moves"] for m in b["per_layer"]}
    assert per_layer_moves <= {m["name"] for m in b["end_to_end"]}


def test_a_new_cell_file_is_found_without_a_code_edit(tmp_path):
    copy = tmp_path / "portbench"
    shutil.copytree(PORTBENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    mix = json.loads((copy / "workloads" / "tpch1-sa-repeat.json").read_text())
    mix.update(traffic="repeat-q6", rotation=["q6"])
    (copy / "workloads" / "tpch1-sa-q6.json").write_text(json.dumps(mix))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import run, traffic;"
            "m = run.load('workloads', 'tpch1-sa-q6');"
            "s = traffic.Stream(m, 5, 0); print(m['traffic'], s.next().query)")
    out = subprocess.run([sys.executable, "-c", code, str(copy)], capture_output=True,
                         text=True, cwd=tmp_path, timeout=60)
    assert out.stdout.split() == ["repeat-q6", "q6"], out.stderr


def test_an_unknown_name_stops_the_run():
    with pytest.raises(SystemExit):
        run.load("workloads", "no-such-cell")
