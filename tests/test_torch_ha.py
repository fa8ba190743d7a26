"""The PyTorch port's durable job state, HA schedulers and KEDA scaler, held
against the JAX package's.

- The JAX package's cases run again on the port (``test_torch_scheduler``'s
  ``mirror``, each collected here under its own name): every case of
  ``tests/test_state_store.py``, ``tests/test_kv_service.py``,
  ``tests/test_etcd_wire.py``, ``tests/test_external_scaler.py`` and
  ``tests/test_ha_failover.py`` but those ``_LEFT_OUT`` names with their
  reasons. Their executors are the port's torch executors on
  ``device="cpu"`` (the JAX cases' ``backend="numpy"`` rewritten), over the
  port's own SF 0.01 data: a standby scheduler finishes, on torch executors,
  a job its peer dropped, over the sqlite, native-gRPC and etcd wires.
- Parity: ``graph_to_json`` of the same finished job gives equal JSON in
  both packages, and each package's ``graph_from_json`` reads the other's;
  the JAX package's ``GrpcKV`` and ``EtcdKV`` work against the port's
  ``KvServer``, and the port's against the JAX one (put, get, scan, lock,
  watch); the ``_pb2`` copies carry the JAX package's serialized
  descriptors, and the service names are the JAX package's.
- The cross-scheduler gang lease, driven from a clock the test controls
  (the steady counterpart of the JAX case, whose sleeps keep 0.2-0.4 s of
  margin against a 1.2 s lease).
- The backends a scheduler accepts, and ``python -m
  ballista_tpu_torch.scheduler.kv_service``.
"""
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from ballista_tpu_torch.config import SchedulerConfig
from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.scheduler import state_store as PS
from ballista_tpu_torch.scheduler.server import SchedulerServer

from test_torch_data import torch_tpch_dir  # noqa: F401
from test_torch_scheduler import _port_copy, mirror

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("ballista_tpu", "ballista_tpu_torch")
# the JAX cases' numpy executors become the port's torch executors on the CPU
TORCH_EXECUTORS = {r'backend="numpy",': 'backend="torch", device="cpu",'}


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(scope="session")
def tpch_dir(torch_tpch_dir):
    """The JAX cases' shared TPC-H fixture is the port's own data here."""
    return torch_tpch_dir


# ---- the JAX package's cases, on the port ------------------------------------------
_LEFT_OUT = {
    ("test_ha_failover.py", "test_gang_lease_blocks_standby_until_released_or_ttl"):
        "flaky in the reference (0.8 + 0.6 s of sleeps against a 1.2 s lease, ROADMAP "
        "queue C); test_gang_lease_blocks_standby_on_a_controlled_clock runs its steps "
        "on a clock the test sets",
}
_MIRRORED = (
    mirror(globals(), "test_state_store.py", _LEFT_OUT)
    + mirror(globals(), "test_kv_service.py", _LEFT_OUT, rewrites=TORCH_EXECUTORS)
    + mirror(globals(), "test_etcd_wire.py", _LEFT_OUT, rewrites=TORCH_EXECUTORS)
    + mirror(globals(), "test_external_scaler.py", _LEFT_OUT)
    + mirror(globals(), "test_ha_failover.py", _LEFT_OUT, rewrites=TORCH_EXECUTORS)
)


def test_every_jax_case_is_mirrored_or_left_out_with_a_reason():
    from test_torch_scheduler import _cases

    files = ("test_state_store.py", "test_kv_service.py", "test_etcd_wire.py",
             "test_external_scaler.py", "test_ha_failover.py")
    every = [c for f in files for c in _cases(f)]
    assert sorted(_MIRRORED) == sorted(c for f, c in every if (f, c) not in _LEFT_OUT)
    assert set(_LEFT_OUT) <= set(every)
    assert all(callable(globals()[c]) for c in _MIRRORED)


# ---- the wire: descriptors and service names ---------------------------------------
@pytest.mark.parametrize("proto", ["kv", "etcd", "keda", "flight_sql"])
def test_pb2_copies_carry_the_jax_packages_descriptors(proto):
    jax, port = (_m(pkg, f"proto.{proto}_pb2") for pkg in PKGS)
    assert port.DESCRIPTOR.serialized_pb == jax.DESCRIPTOR.serialized_pb
    assert port.DESCRIPTOR.package == jax.DESCRIPTOR.package
    with open(os.path.join(REPO, "ballista_tpu", "proto", f"{proto}_pb2.py")) as f, \
            open(os.path.join(REPO, "ballista_tpu_torch", "proto", f"{proto}_pb2.py")) as g:
        assert f.read() == g.read()


def test_service_names_are_the_jax_packages():
    for module, name in (("scheduler.kv_service", "KV_SERVICE"),
                         ("scheduler.external_scaler", "KEDA_SERVICE")):
        jax, port = (getattr(_m(pkg, module), name) for pkg in PKGS)
        assert port == jax
    assert _m(PKGS[1], "scheduler.kv_service").KV_SERVICE == "ballista_tpu.kv.KvStore"


# ---- each package's kv client against the other's server ---------------------------
def _exercise(client) -> None:
    """put/get/scan/delete, lock with a lease, and a pushed watch."""
    got, seen = [], threading.Event()

    def cb(ev):
        got.append((ev["op"], ev["key"], ev["value"]))
        if ev["key"] == "w2":
            seen.set()

    handle = client.watch("Watched", cb)
    try:
        client.put("JobStatus", "a", b"\x00alpha")
        client.put("JobStatus", "b", b"beta")
        client.put("Other", "a", b"elsewhere")
        assert client.get("JobStatus", "a") == b"\x00alpha"
        assert client.get("JobStatus", "nope") is None
        assert dict(client.scan("JobStatus")) == {"a": b"\x00alpha", "b": b"beta"}
        client.delete("JobStatus", "a")
        assert dict(client.scan("JobStatus")) == {"b": b"beta"}
        assert client.lock("ExecutionGraph", "job1", "sched-A", ttl_s=30.0)
        assert client.lock("ExecutionGraph", "job1", "sched-A", ttl_s=30.0)
        assert not client.lock("ExecutionGraph", "job1", "sched-B", ttl_s=30.0)
        # a watch registers server-side after watch() returns: retry with
        # distinct keys until the first event arrives
        deadline = time.time() + 20
        i = 0
        while time.time() < deadline and not got:
            client.put("Watched", f"w1-{i}", b"1")
            i += 1
            time.sleep(0.2)
        assert got, "no watch event"
        client.put("Watched", "w2", b"2")
        assert seen.wait(10), got
        assert ("put", "w2", b"2") in got
    finally:
        handle.stop()


@pytest.mark.parametrize("client_pkg,server_pkg", [(PKGS[0], PKGS[1]), (PKGS[1], PKGS[0])],
                         ids=["jax-client-port-server", "port-client-jax-server"])
@pytest.mark.parametrize("wire", ["grpc-kv", "etcd"])
def test_kv_clients_work_against_the_other_packages_server(client_pkg, server_pkg, wire):
    srv = _m(server_pkg, "scheduler.kv_service").KvServer(
        _m(server_pkg, "scheduler.state_store").InMemoryKV())
    port = srv.start(0, "127.0.0.1")
    cls = (_m(client_pkg, "scheduler.kv_service").GrpcKV if wire == "grpc-kv"
           else _m(client_pkg, "scheduler.etcd_gateway").EtcdKV)
    client = cls(f"127.0.0.1:{port}")
    try:
        _exercise(client)
    finally:
        client.close()
        srv.stop()


# ---- graph_to_json ------------------------------------------------------------------
def _finished_graph_json(pkg: str, data_dir: str) -> dict:
    """One aggregate job over lineitem, planned by ``pkg`` and driven to
    completion by the JAX test's helpers (their port copy for the port)."""
    helpers = (importlib.import_module("test_execution_graph") if pkg == PKGS[0]
               else sys.modules.get("port_test_execution_graph")
               or _port_copy("test_execution_graph.py"))
    cat = _m(pkg, "client.catalog").Catalog()
    cat.register_parquet("lineitem", os.path.join(data_dir, "lineitem"))
    plan = _m(pkg, "sql.planner").SqlPlanner(cat.schemas()).plan(_m(pkg, "sql.parser").parse_sql(
        "select l_returnflag, l_linestatus, sum(l_quantity) as s, count(*) as c "
        "from lineitem group by l_returnflag, l_linestatus"))
    phys = _m(pkg, "plan.physical_planner").PhysicalPlanner(
        cat, _m(pkg, "config").BallistaConfig()).plan(_m(pkg, "plan.optimizer").optimize(plan))
    g = _m(pkg, "scheduler.execution_graph").ExecutionGraph("job-json", "q", "sess", phys)
    helpers.drain(g, "exec-A")
    assert g.status == "SUCCESSFUL"
    # the wall clock is the one thing the two runs cannot share
    g.queued_at, g.start_time, g.end_time = 1.0, 2.0, 3.0
    return _m(pkg, "scheduler.state_store").graph_to_json(g)


def test_graph_json_equals_the_jax_packages_and_each_reads_the_others(torch_tpch_dir):
    jax_json, port_json = (_finished_graph_json(pkg, torch_tpch_dir) for pkg in PKGS)
    assert json.dumps(port_json, sort_keys=True) == json.dumps(jax_json, sort_keys=True)
    for reader_pkg, payload in ((PKGS[1], jax_json), (PKGS[0], port_json)):
        store = _m(reader_pkg, "scheduler.state_store")
        g = store.graph_from_json(json.loads(json.dumps(payload)))
        assert g.status == "SUCCESSFUL" and sorted(g.stages) == sorted(
            int(s) for s in payload["stages"])
        assert store.graph_to_json(g) == payload


# ---- a fault of the reference the port does not copy -------------------------------
def _pieces_after_a_takeover(pkg: str, data_dir: str) -> list:
    """A job's first task running when its scheduler's graph is saved; the
    adopting scheduler's restored graph hands the demoted partition out again
    (under the same task id: its counter counts finished tasks only), then
    the first attempt's late success and the new attempt's success both
    report. Returns the consumer's pieces per output partition."""
    cat = _m(pkg, "client.catalog").Catalog()
    cat.register_parquet("lineitem", os.path.join(data_dir, "lineitem"))
    plan = _m(pkg, "sql.planner").SqlPlanner(cat.schemas()).plan(_m(pkg, "sql.parser").parse_sql(
        "select l_returnflag, sum(l_quantity) as s from lineitem group by l_returnflag"))
    phys = _m(pkg, "plan.physical_planner").PhysicalPlanner(
        cat, _m(pkg, "config").BallistaConfig()).plan(_m(pkg, "plan.optimizer").optimize(plan))
    store = _m(pkg, "scheduler.state_store")
    g = _m(pkg, "scheduler.execution_graph").ExecutionGraph("job-z", "q", "sess", phys)
    first = g.pop_next_task("exec-A")
    adopted = store.graph_from_json(json.loads(json.dumps(store.graph_to_json(g))))
    again = adopted.pop_next_task("exec-B")
    assert (again.stage_id, again.partition) == (first.stage_id, first.partition)

    def success(t, ex):
        return {"task_id": t.task_id, "stage_id": t.stage_id, "stage_attempt": t.stage_attempt,
                "partition": t.partition, "task_attempt": t.task_attempt, "status": "success",
                "locations": [{"path": f"/{ex}/{t.stage_id}/{t.partition}/{o}.arrow",
                               "host": "h", "flight_port": 1, "executor_id": ex,
                               "stage_id": t.stage_id, "map_partition": t.partition,
                               "output_partition": o, "num_rows": 1, "num_bytes": 1}
                              for o in range(2)]}

    adopted.update_task_status("exec-A", [success(first, "exec-A")])
    adopted.update_task_status("exec-B", [success(again, "exec-B")])
    (consumer,) = adopted.stages[first.stage_id].output_links
    return [len(p) for p in
            adopted.stages[consumer].inputs[first.stage_id].partition_locations]


def test_a_late_report_after_a_takeover_propagates_its_pieces_once(torch_tpch_dir):
    """The JAX graph takes both reports of the re-issued slot and hands the
    consumer each piece twice (rows read twice: q1's sums came out 1.49x in a
    rehearsal of chip_smoke's ha phase); the port's seals the slot once."""
    jax, port = (_pieces_after_a_takeover(pkg, torch_tpch_dir) for pkg in PKGS)
    assert jax == [2, 2]
    assert port == [1, 1]


# ---- the gang lease on a controlled clock ------------------------------------------
class _Clock:
    """Stands in for the state store's ``time`` module: ``time()`` reads
    ``now``; everything else is the real module's."""

    def __init__(self):
        self.now = 1_000_000.0

    def time(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_gang_lease_blocks_standby_on_a_controlled_clock(tmp_path, monkeypatch):
    """The port's counterpart of the JAX package's
    ``test_gang_lease_blocks_standby_until_released_or_ttl``, its steps on a
    clock the test sets, so no step races the lease: a group claimed by A
    is refused to B; A's renewals keep it past the first TTL; A's release
    frees it at once; a group A never releases frees only after the TTL."""
    clock = _Clock()
    monkeypatch.setattr(PS, "time", clock)
    ttl = 1.2
    kv = str(tmp_path / "gang.db")
    a, b = (SchedulerServer(SchedulerConfig(
        scheduling_policy="push", cluster_backend="kv", kv_path=kv,
        job_lease_ttl_seconds=2.0, gang_inflight_ttl_seconds=ttl)) for _ in range(2))

    assert a._claim_gang_group("g1")
    assert not b._claim_gang_group("g1")
    clock.now += ttl - 0.1
    a._gang_inflight["g1"] = ("job-x", 2, 0)
    a._renew_gang_markers()
    clock.now += ttl - 0.1  # past the first lease's end, within the renewed one
    assert not b._claim_gang_group("g1")
    del a._gang_inflight["g1"]
    a._release_gang_group("g1")
    clock.now += 0.01  # a release is a re-lock under a 1 ms lease
    assert b._claim_gang_group("g1")
    b._release_gang_group("g1")

    assert a._claim_gang_group("g2")
    clock.now += ttl - 0.1
    assert not b._claim_gang_group("g2")
    clock.now += 0.2  # A never renewed: its lease has lapsed
    assert b._claim_gang_group("g2")
    assert not a._claim_gang_group("g2")


# ---- backends --------------------------------------------------------------------
def test_scheduler_accepts_every_durable_backend_and_refuses_an_unknown_one(tmp_path):
    from ballista_tpu_torch.scheduler.kv_service import KvServer

    with pytest.raises(BallistaError, match="unknown cluster_backend='sled'"):
        SchedulerServer(SchedulerConfig(cluster_backend="sled"))
    assert SchedulerServer(SchedulerConfig()).state_store is None
    srv = KvServer(PS.InMemoryKV())
    port = srv.start(0, "127.0.0.1")
    try:
        stores = {
            "kv": SchedulerServer(SchedulerConfig(
                cluster_backend="kv", kv_path=str(tmp_path / "s.db"))).state_store,
            "grpc-kv": SchedulerServer(SchedulerConfig(
                cluster_backend="grpc-kv", kv_addr=f"127.0.0.1:{port}")).state_store,
            "etcd": SchedulerServer(SchedulerConfig(
                cluster_backend="etcd", kv_addr=f"127.0.0.1:{port}")).state_store,
        }
        kinds = {k: type(s.kv).__name__ for k, s in stores.items()}
        assert kinds == {"kv": "SqliteKV", "grpc-kv": "GrpcKV", "etcd": "EtcdKV"}
        for s in stores.values():
            s.kv.put("JobStatus", "probe", b"1")
            assert s.kv.get("JobStatus", "probe") == b"1"
    finally:
        srv.stop()


def test_kv_service_process_serves_both_wires():
    from ballista_tpu_torch.scheduler.etcd_gateway import EtcdKV
    from ballista_tpu_torch.scheduler.kv_service import GrpcKV

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.scheduler.kv_service", "--host",
         "127.0.0.1", "--port", str(port)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert f"listening on 127.0.0.1:{port}" in line, proc.stderr.read()[-2000:]
        native, etcd = GrpcKV(f"127.0.0.1:{port}"), EtcdKV(f"127.0.0.1:{port}")
        native.put("Executors", "e1", b"x")
        assert etcd.get("Executors", "e1") == b"x"
        native.close()
        etcd.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
