"""The PyTorch port's scheduler, held against the JAX package's.

- For all 22 TPC-H queries, the stages the port's ``SchedulerServer`` plans
  for a job serialize (``plan/serde``) to the same bytes as the JAX
  scheduler's, with the same stage and task counts.
- The JAX package's scheduler unit tests — every case of
  ``tests/test_execution_graph.py`` and ``tests/test_consistent_hash.py``,
  and the unit cases of ``tests/test_serving.py`` (fingerprints, plan and
  result caches, admission, the TaskManager's offer policy) — run again with
  every ``ballista_tpu`` import rewritten to ``ballista_tpu_torch``: the
  port's ``ExecutionGraph`` and ``TaskManager`` go through the same state
  transitions, and one drain-and-rollback walk records both packages'
  transitions side by side.
- The two faults the port repaired: ``ExecutorConfig`` defaults to the torch
  backend (with a ``device``), and the scheduler's admission budget comes
  from the device kinds executors register (``budget_from_device_kinds``).

Nothing here asserts on state the job-finished path writes right after a
``collect()`` returns; such state is waited for with a deadline.
"""
import importlib
import inspect
import json
import os
import re
import sys
import types

import pytest

from test_torch_data import torch_tpch_dir  # noqa: F401

TESTS = os.path.dirname(os.path.abspath(__file__))
QUERIES = os.path.join(TESTS, "..", "benchmarks", "queries")
PKGS = ("ballista_tpu", "ballista_tpu_torch")


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# ---- stage plans of all 22 queries -------------------------------------------------
def _scheduler_stages(pkg: str, data_dir: str, sql: str, settings: dict):
    """Plan ``sql`` as a job on ``pkg``'s SchedulerServer (not started: no
    executors, no RPC) and return its graph."""
    cat = _m(pkg, "client.catalog").Catalog()
    tpch = _m(pkg, "models.tpch")
    for t in tpch.TPCH_TABLES:
        cat.register_parquet(t, os.path.join(data_dir, t))
    table_defs = [json.dumps(m.to_dict()).encode() for m in cat.tables.values()]
    server = _m(pkg, "scheduler.server").SchedulerServer(
        _m(pkg, "config").SchedulerConfig())
    server._plan_and_submit("job-x", "sess", "sql", sql,
                            [json.loads(b.decode()) for b in table_defs], dict(settings))
    g = server.tasks.get_job("job-x")
    assert g is not None, server._job_overrides.get("job-x")
    return g


@pytest.mark.parametrize("settings", [{}, {"ballista.optimizer.broadcast_rows_threshold": "0"}],
                         ids=["default", "partitioned"])
@pytest.mark.parametrize("qname", [f"q{i}" for i in range(1, 23)])
def test_stage_plans_serialize_to_the_jax_schedulers_bytes(torch_tpch_dir, qname, settings):
    sql = open(os.path.join(QUERIES, f"{qname}.sql")).read()
    graphs = [_scheduler_stages(pkg, torch_tpch_dir, sql, settings) for pkg in PKGS]
    encoded = []
    for pkg, g in zip(PKGS, graphs):
        serde = _m(pkg, "plan.serde")
        encoded.append({sid: serde.encode_physical(s.plan) for sid, s in g.stages.items()})
    jax_g, port_g = graphs
    assert sorted(encoded[0]) == sorted(encoded[1])
    for sid in encoded[0]:
        assert encoded[0][sid] == encoded[1][sid], f"{qname} stage {sid}"
    assert port_g.total_task_count() == jax_g.total_task_count()
    assert port_g.final_stage_id == jax_g.final_stage_id


# ---- the JAX package's scheduler unit tests, on the port ---------------------------
def _port_copy(filename: str, rewrites: dict | None = None) -> types.ModuleType:
    """``tests/<filename>`` with every ``ballista_tpu`` import rewritten to
    the port's. A JAX test module it imports (``from test_x import ...`` or
    ``from tests.test_x import ...``) is read from that module's port copy,
    registered as ``port_test_x``. ``rewrites`` (regex -> replacement) are
    applied to the source last: a fixture renamed, a data path, the
    executors' backend."""
    path = os.path.join(TESTS, filename)
    src = re.sub(r"\bballista_tpu\b(?!_)", "ballista_tpu_torch", open(path).read())
    src = re.sub(r"\bfrom tests\.(test_\w+) import\b", r"from \1 import", src)
    for dep in set(re.findall(r"\bfrom (test_\w+) import\b", src)):
        if f"port_{dep}" not in sys.modules:
            sys.modules[f"port_{dep}"] = _port_copy(f"{dep}.py")
    src = re.sub(r"\bfrom (test_\w+) import\b", r"from port_\1 import", src)
    for pattern, repl in (rewrites or {}).items():
        src, n = re.subn(pattern, repl, src)
        assert n, f"{filename}: {pattern!r} matches nothing"
    mod = types.ModuleType(f"port_{filename[:-3]}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _is_fixture(obj) -> bool:
    return (type(obj).__name__ == "FixtureFunctionDefinition"
            or hasattr(obj, "_pytestfixturefunction"))


def mirror(namespace: dict, filename: str, left_out: dict, rewrites: dict | None = None,
           only: tuple | None = None) -> list:
    """Put the test cases of ``filename``'s port copy (``only`` those named,
    else all but the ``(filename, case)`` keys of ``left_out``) and every
    fixture it defines into ``namespace``, a test module's globals, so
    pytest collects each case there under its own name, with its own
    parameters and marks. A fixture ``namespace`` already defines wins: the
    port's own clusters, data and executors replace the JAX test's. Returns
    the names of the cases mirrored."""
    mod = _port_copy(filename, rewrites)
    cases = [c for _, c in _cases(filename) if (filename, c) not in left_out
             and (only is None or c in only)]
    assert only is None or sorted(cases) == sorted(only), (filename, only)
    for name, obj in vars(mod).items():
        if name in cases:
            assert name not in namespace, f"{filename}::{name} is already a case here"
            namespace[name] = obj
        elif _is_fixture(obj) and name not in namespace:
            namespace[name] = obj
    return cases


def _cases(filename: str, unit_only: bool = False) -> list:
    """The test functions of ``filename`` by name (``unit_only``: those
    that take no fixture, i.e. no cluster)."""
    src = open(os.path.join(TESTS, filename)).read()
    out = []
    for m in re.finditer(r"^def (test_\w+)\(([^)]*)\)", src, re.M):
        if unit_only and m.group(2).strip():
            continue
        out.append((filename, m.group(1)))
    return out


_MIRRORED = (_cases("test_execution_graph.py") + _cases("test_consistent_hash.py")
             + _cases("test_serving.py", unit_only=True))
_COPIES: dict = {}


@pytest.mark.parametrize("filename,case", _MIRRORED, ids=[f"{f[5:-3]}-{c}" for f, c in _MIRRORED])
def test_jax_scheduler_unit_case_on_the_port(request, torch_tpch_dir, filename, case):
    if filename not in _COPIES:
        _COPIES[filename] = _port_copy(filename)
    fn = getattr(_COPIES[filename], case)
    # the JAX tests' shared TPC-H fixture is the port's own data here
    fixtures = {"tpch_dir": torch_tpch_dir}
    args = [fixtures[p] if p in fixtures else request.getfixturevalue(p)
            for p in inspect.signature(fn).parameters]
    fn(*args)


def _walk(pkg: str) -> list:
    """Drive ``pkg``'s two-stage graph through a task failure, a fetch
    failure with its rollback, an executor loss and a drain, recording
    (job status, {stage: (state, attempt)}) after every step."""
    eg = _m(pkg, "scheduler.execution_graph")
    port = _COPIES.get("test_execution_graph.py") if pkg == PKGS[1] else None
    if pkg == PKGS[1] and port is None:
        port = _COPIES["test_execution_graph.py"] = _port_copy("test_execution_graph.py")
    helpers = port or importlib.import_module("test_execution_graph")
    g = helpers.two_stage_graph()
    seen = []

    def snap(label):
        seen.append((label, g.status, {sid: (s.state, s.attempt) for sid, s in g.stages.items()}))

    snap("start")
    t = g.pop_next_task("e1")
    g.update_task_status("e1", [{"task_id": t.task_id, "stage_id": t.stage_id,
                                 "stage_attempt": t.stage_attempt, "partition": t.partition,
                                 "status": "failed",
                                 "failure": {"kind": "execution", "retryable": True,
                                             "message": "boom"}}])
    snap("task failed")
    while True:
        t = g.pop_next_task("e1")
        if t is None or t.stage_id != 1:
            break
        helpers.succeed_task(g, t, "e1")
    snap("map stage done")
    assert t is not None and t.stage_id == 2
    g.update_task_status("e2", [{"task_id": t.task_id, "stage_id": t.stage_id,
                                 "stage_attempt": t.stage_attempt, "partition": t.partition,
                                 "status": "failed",
                                 "failure": {"kind": "fetch", "executor_id": "e1",
                                             "map_stage_id": 1, "map_partition_id": 0,
                                             "message": "gone"}}])
    snap("fetch failed")
    g.reset_stages_on_lost_executor("e1")
    snap("executor lost")
    helpers.drain(g, "e2")
    snap("drained")
    assert g.status == eg.SUCCESSFUL
    return seen


def test_graph_walks_the_same_transitions_as_the_jax_package():
    jax_walk, port_walk = _walk(PKGS[0]), _walk(PKGS[1])
    assert port_walk == jax_walk
    assert [label for label, _, _ in port_walk][-1] == "drained"


# ---- the two repaired faults -------------------------------------------------------
def test_executor_config_defaults_to_the_torch_backend():
    from ballista_tpu_torch.config import ExecutorConfig

    cfg = ExecutorConfig()
    assert cfg.backend == "torch" and cfg.device is None
    assert ExecutorConfig(device="cpu").device == "cpu"


def test_executor_refuses_a_backend_the_port_lacks(tmp_path):
    from ballista_tpu_torch.config import ExecutorConfig
    from ballista_tpu_torch.errors import BallistaError
    from ballista_tpu_torch.executor.process import ExecutorProcess

    with pytest.raises(BallistaError, match="torch or numpy"):
        ExecutorProcess(ExecutorConfig(backend="jax", work_dir=str(tmp_path)))
    # a mesh group needs its coordinator and a size of at least 2
    with pytest.raises(BallistaError, match="mesh group 'g' needs"):
        ExecutorProcess(ExecutorConfig(mesh_group_id="g", device="cpu", work_dir=str(tmp_path)))


def test_budget_from_device_kinds_table():
    from ballista_tpu_torch.engine import memory_model as MM

    h100 = "NVIDIA H100 80GB HBM3"
    want = int(MM.DEVICE_MEMORY_BYTES[h100] * MM.DEFAULT_BUDGET_FRACTION)
    # the budget chip_smoke.py records for this card (0.85 of mem_get_info's total)
    assert want == 72_264_869_478
    assert MM.budget_from_device_kinds({h100}) == want
    assert MM.budget_from_device_kinds({h100, "cpu"}) == want
    # CPU, host and unknown executors, and a JAX executor's "tpu", map to no budget
    for kinds in (set(), {"cpu"}, {"tpu"}, {"NVIDIA A100-SXM4-40GB"}):
        assert MM.budget_from_device_kinds(kinds) == 0
    # a mixed cluster plans for its smallest card
    MM.DEVICE_MEMORY_BYTES["small card"] = 1 << 30
    try:
        assert MM.budget_from_device_kinds({h100, "small card"}) == int(
            (1 << 30) * MM.DEFAULT_BUDGET_FRACTION)
    finally:
        del MM.DEVICE_MEMORY_BYTES["small card"]


def test_admission_governs_with_the_registered_cards_budget(torch_tpch_dir, monkeypatch):
    """The scheduler plans against the budget its executors' cards give,
    not one it probes: an H100 registered, the q3 job's memory report
    carries its budget; none registered, no report."""
    from ballista_tpu_torch.scheduler.cluster import ExecutorInfo

    sql = open(os.path.join(QUERIES, "q3.sql")).read()
    g = _scheduler_stages(PKGS[1], torch_tpch_dir, sql, {})
    assert g.memory_report is None
    server = _m(PKGS[1], "scheduler.server").SchedulerServer(
        _m(PKGS[1], "config").SchedulerConfig())
    server.cluster.register(ExecutorInfo("e1", "127.0.0.1", 1, 2, 2, 2, device_count=1,
                                         device_kind="NVIDIA H100 80GB HBM3"))
    cat = _m(PKGS[1], "client.catalog").Catalog()
    for t in _m(PKGS[1], "models.tpch").TPCH_TABLES:
        cat.register_parquet(t, os.path.join(torch_tpch_dir, t))
    server._plan_and_submit("job-h", "sess", "sql", sql,
                            [m.to_dict() for m in cat.tables.values()], {})
    report = server.tasks.get_job("job-h").memory_report
    assert report is not None and report.budget_bytes == 72_264_869_478
    assert {d.action for d in report.decisions} == {"fits"}
