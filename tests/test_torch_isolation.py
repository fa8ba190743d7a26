"""The PyTorch port stands alone: no jax, nothing of ballista_tpu.

``ballista_tpu_torch/`` and ``chip_smoke.py`` keep their own copies of what
they need; only the tests import both packages.
"""
import ast
import functools
import os
import subprocess
import sys

import pytest
import torch

from test_torch_data import torch_tpch_dir  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ballista_tpu_torch")


def _port_sources():
    for dp, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dp, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imports(path):
    """Every module an import statement names (top-level or inside a
    function), plus ``module.name`` for each ``from module import name``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, None
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                yield node.module, a.name


def _module_file(dotted: str):
    base = os.path.join(REPO, *dotted.split("."))
    for cand in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(cand):
            return cand
    return None


@functools.lru_cache(maxsize=None)
def _top_level_names(path) -> frozenset:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return frozenset(names)


def test_no_jax_or_reference_imports_and_all_port_imports_resolve():
    assert os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    bad = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)
        for module, name in _imports(path):
            top = module.split(".")[0]
            if top in ("jax", "jaxlib", "ballista_tpu"):
                bad.append(f"{rel}: imports {module}")
            elif top == "ballista_tpu_torch":
                src = _module_file(module)
                if src is None:
                    bad.append(f"{rel}: {module} is no file of the port")
                elif (name is not None and _module_file(f"{module}.{name}") is None
                      and name not in _top_level_names(src)):
                    bad.append(f"{rel}: {module} defines no {name}")
    assert not bad, "\n".join(bad)


_Q1_BLOCKED = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["ballista_tpu"] = None
sys.path.insert(0, {repo!r})
from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.models.tpch import TPCH_TABLES
ctx = BallistaContext.standalone(device="cpu")
for t in TPCH_TABLES:
    ctx.register_parquet(t, os.path.join({data!r}, t))
out = ctx.sql(open(os.path.join({repo!r}, "benchmarks", "queries", "q1.sql")).read()).collect()
m = ctx.last_engine_metrics
assert m.get("op.HostFallback.count", 0.0) == 0.0, m
assert not any(k == "jax" or k.startswith(("jax.", "ballista_tpu."))
               for k, v in sys.modules.items() if v is not None)
print("ROWS", out.num_rows)
"""


def test_q1_runs_with_jax_and_reference_blocked(torch_tpch_dir):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _Q1_BLOCKED.format(repo=REPO, data=torch_tpch_dir)],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ROWS 4" in proc.stdout


def test_standalone_defaults_to_cuda_and_raises_without_it():
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.errors import ExecutionError

    if torch.cuda.is_available():
        assert BallistaContext.standalone().device.startswith("cuda")
        return
    with pytest.raises(ExecutionError, match="CUDA is not available"):
        BallistaContext.standalone()
    assert BallistaContext.standalone(device="cpu").device == "cpu"
    assert BallistaContext.standalone(backend="numpy").device is None


def test_unknown_backend_rejected():
    from ballista_tpu_torch.client.context import BallistaContext
    from ballista_tpu_torch.errors import BallistaError

    with pytest.raises(BallistaError, match="unknown backend"):
        BallistaContext.standalone(backend="jax")
