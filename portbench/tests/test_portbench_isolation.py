"""Nothing the benchmark runs loads JAX or the JAX package, and the
yardstick imports nothing of the port."""
import ast
import glob
import os
import subprocess
import sys

from conftest import PORTBENCH, ROOT

import run

YARDSTICK = ["reference.py", "datagen.py", "traffic.py", "roofline.py", "standins.py"] + \
    [os.path.relpath(p, PORTBENCH) for p in glob.glob(os.path.join(PORTBENCH, "queries", "*.py"))]


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(PORTBENCH, "**", "*.py"), recursive=True):
        names = top_level_imports(path)
        assert not names & set(run.FORBIDDEN), (path, names & set(run.FORBIDDEN))


def test_the_top_level_compare_is_whole():
    assert run.FORBIDDEN.count("ballista_tpu") == 1
    assert "ballista_tpu_torch".split(".")[0] not in run.FORBIDDEN


def test_the_yardstick_imports_nothing_of_the_port():
    for rel in YARDSTICK:
        names = top_level_imports(os.path.join(PORTBENCH, rel))
        assert "ballista_tpu_torch" not in names, rel


def test_a_rehearsal_loads_no_forbidden_module(tmp_path):
    code = ("import sys, time; sys.path.insert(0, sys.argv[1]); import run;"
            "r, _ = run.run_cell('tpch1-sa-adhoc', 5, 1, True, device='cpu', scale_factor=0.01,"
            " t_start=time.time()); print(r['correct'], run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, PORTBENCH], capture_output=True,
                         text=True, cwd=ROOT, timeout=300, env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.stdout.strip().splitlines()[-1] == "True []", out.stderr[-2000:]
