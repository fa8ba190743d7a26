"""An executor's share of its card, and the leaf cache's room for a stage,
on the CPU.

Two executor processes on one card, outside a mesh group, each plan for
the share of it that ``--device-share`` gives
(``memory_model.set_device_share``): the engine's budget, the device leaf
cache's capacity and the scheduler's admission budget for a registered share
are one number. A card is faked by a probed total in ``memory_model``'s
table and a mesh of one CUDA shard; nothing runs on it.

The leaf cache's device copies make room for a stage before they count
against it (``leaf_cache.make_room``), and a paged join's passes are solved
against the budget alone, so a full cache cannot multiply them.
"""
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig, ExecutorConfig
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.executor.process import ExecutorProcess, _device_inventory
from ballista_tpu_torch.parallel.mesh import device_share_of, mesh_shape, shards_per_card_of
from ballista_tpu_torch.utils.cache import LoadingCache

H100 = "NVIDIA H100 80GB HBM3"
TOTAL = MM.DEVICE_MEMORY_BYTES[H100]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card(monkeypatch):
    """A faked H100 as cuda:0: its probed total, and a mesh of one shard on
    it. Returns a function making a torch engine that plans for it."""
    monkeypatch.setattr(MM, "_DETECTED", {"cuda:0": TOTAL})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(TE, "build_mesh", lambda n, device: [torch.device("cuda", 0)])

    def engine(settings=None):
        e = TE.TorchEngine(BallistaConfig(dict(settings or {})), device="cpu")
        e.device = torch.device("cuda", 0)
        return e

    return engine


@pytest.fixture
def share(monkeypatch):
    """Sets this process's share for a test, and puts the old one back."""
    def set_share(f):
        monkeypatch.setattr(MM, "_DEVICE_SHARE", MM._DEVICE_SHARE)
        MM.set_device_share(f)

    return set_share


@pytest.fixture
def fresh_dev(monkeypatch):
    """An unsized device cache of its own."""
    dev = LoadingCache(capacity=8 * 1024**3, weigher=LC.DEV.weigher,
                       eviction_listener=LC._device_evicted)
    monkeypatch.setattr(LC, "DEV", dev)
    monkeypatch.setattr(LC, "_SIZED", False)
    return dev


def test_half_a_card_halves_the_budget_and_the_device_cache(card, share, fresh_dev):
    whole = card()._hbm_budget()
    assert whole == int(TOTAL * MM.DEFAULT_BUDGET_FRACTION) == 72_264_869_478
    share(0.5)
    e = card()
    assert e._hbm_budget() == int(TOTAL * MM.DEFAULT_BUDGET_FRACTION * 0.5) == 36_132_434_739
    LC._size_device_cache(e)
    assert fresh_dev.capacity == MM.device_cache_bytes(e._hbm_budget()) == 14_452_973_895
    assert e.op_metrics["op.LeafCache.device_capacity.max_bytes"] == fresh_dev.capacity


def test_a_share_of_one_leaves_every_number_as_it_was(card, share, fresh_dev):
    share(1.0)
    e = card()
    assert e._hbm_budget() == 72_264_869_478 == MM.budget_from_device_kinds({H100})
    LC._size_device_cache(e)
    assert fresh_dev.capacity == int(72_264_869_478 * MM.DEVICE_CACHE_SHARE)
    assert mesh_shape([torch.device("cpu")], 1.0) == "1x1"
    big = str(100 * 10**9)
    assert card({"ballista.engine.hbm_budget_bytes": big})._hbm_budget() == 100 * 10**9


def test_the_scheduler_admits_against_the_registered_share(card, share):
    share(0.5)
    shape = mesh_shape([torch.device("cuda", 0)], MM.device_share())
    assert shape == "1x1@0.5"
    assert (shards_per_card_of(shape), device_share_of(shape)) == (1, 0.5)
    assert MM.budget_from_device_kinds({H100}, shards_per_card_of(shape),
                                       device_share_of(shape)) == card()._hbm_budget()
    # four shards of a half card: the half split four ways, on both sides
    assert MM.budget_from_device_kinds({H100}, 4, 0.5) == MM.shard_budget_bytes(
        card()._hbm_budget(), 4)


@pytest.mark.parametrize("shape,want", [("1x1@0.5", 0.5), ("1x4@0.25", 0.25), ("1x4", 1.0),
                                        ("", 1.0), ("1x1@2", 1.0), ("1x1@x", 1.0)])
def test_registered_shapes_parse(shape, want):
    assert device_share_of(shape) == want
    assert shards_per_card_of(shape) == (4 if shape.startswith("1x4") else 1)


def test_an_explicit_budget_above_the_share_is_capped_and_one_below_it_wins(card, share):
    share(0.5)
    half = card()._hbm_budget()
    above = card({"ballista.engine.hbm_budget_bytes": str(half + 10**9)})
    below = card({"ballista.engine.hbm_budget_bytes": str(half // 3)})
    assert above._hbm_budget() == half
    assert below._hbm_budget() == half // 3
    # the scheduler caps it at the registered share too
    cfg = BallistaConfig({"ballista.engine.hbm_budget_bytes": str(half + 10**9)})
    admitted = MM.budget_from_device_kinds({H100}, 1, 0.5)
    assert MM.resolve_budget_bytes(cfg, admitted, shared=True) == half
    assert MM.resolve_budget_bytes(cfg, admitted, shared=False) == half + 10**9


def test_a_registered_executor_plans_its_share(share):
    share(0.5)
    num, kind, shape = _device_inventory("torch", "cpu", 0.5)
    assert (num, kind, shape) == (1, "cpu", "1x1@0.5")
    assert _device_inventory("torch", "cpu")[2] == "1x1"


@pytest.mark.parametrize("bad", [0.0, -0.5, 1.5])
def test_a_share_outside_zero_to_one_is_refused(bad, monkeypatch):
    monkeypatch.setattr(MM, "_DEVICE_SHARE", MM._DEVICE_SHARE)
    with pytest.raises(ValueError):
        MM.set_device_share(bad)
    with pytest.raises(BallistaError, match="a fraction in"):
        ExecutorProcess(ExecutorConfig(backend="numpy", device_share=bad))


def test_a_mesh_group_member_refuses_a_share(monkeypatch):
    """A mesh group splits its cards between its members already
    (``multihost.MeshGroup``): a member asking for a share too is refused
    at start, before it joins the group."""
    monkeypatch.setattr(MM, "_DEVICE_SHARE", MM._DEVICE_SHARE)
    cfg = ExecutorConfig(backend="torch", device="cpu", device_share=0.5,
                         mesh_group_id="g", mesh_group_coordinator="127.0.0.1:1",
                         mesh_group_size=2, mesh_group_process_id=0)
    with pytest.raises(BallistaError, match="does not apply"):
        ExecutorProcess(cfg)
    assert MM.device_share() == 1.0


def test_the_executor_binary_takes_the_share_from_its_environment():
    """``--device-share`` and ``BALLISTA_EXECUTOR_DEVICE_SHARE``: a share
    outside (0, 1] stops the binary at start with status 2 and the reason."""
    env = dict(os.environ, BALLISTA_EXECUTOR_DEVICE_SHARE="1.5",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "ballista_tpu_torch.executor", "--backend",
                          "numpy", "--scheduler-port", "1"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 2 and "a fraction in (0, 1]" in out.stderr
    help_text = subprocess.run([sys.executable, "-m", "ballista_tpu_torch.executor", "--help"],
                               capture_output=True, text=True, cwd=REPO, env=env,
                               timeout=120).stdout
    assert "--device-share" in help_text


# ---- the leaf cache makes room; a full cache never multiplies passes ------------------------
def _dev_copy(nbytes: int) -> list:
    return [torch.zeros(nbytes, dtype=torch.uint8)]


def test_a_stage_takes_its_room_from_unpinned_copies(card, fresh_dev):
    """``make_room`` evicts the card's unpinned copies, least recently used
    first, down to the room asked; pinned ones and another device's stay."""
    e = card()
    for i in range(4):
        fresh_dev.put((("leaf", i), "cuda:0", True), _dev_copy(1000))
    fresh_dev.put((("cpu-leaf",), "cpu", True), _dev_copy(1000))
    fresh_dev.pin((("leaf", 3), "cuda:0", True))
    assert LC.resident_bytes(e) == 4000
    LC.make_room(e, 1500)
    assert LC.resident_bytes(e) == 1000  # only the pinned copy is left on the card
    assert fresh_dev.get((("leaf", 3), "cuda:0", True)) is not None
    assert fresh_dev.get((("cpu-leaf",), "cpu", True)) is not None
    assert e.op_metrics["op.LeafCache.evicted_bytes"] == 3000
    LC.make_room(e, 0)  # a pinned copy never goes
    assert LC.resident_bytes(e) == 1000


@pytest.mark.parametrize("where", [None, lambda key: key != "b"])
def test_evict_and_evict_for_keep_one_rule(where):
    """``evict`` and ``evict_for`` go through the cache's one eviction
    loop: least recently used first, never a pinned entry, nor (with
    ``keep_weightless``) a weightless one, nor a key ``where`` refuses."""
    cache = LoadingCache(capacity=10, weigher=lambda v: v, keep_weightless=True)
    for key, w in (("free", 0), ("a", 3), ("p", 3), ("b", 3), ("c", 3)):
        cache.put(key, w)  # ("a" goes for weight on the last put)
    cache.pin("p")
    assert cache.evict(100, where) == (3 if where else 6)
    assert cache.get("free") is not None and cache.get("p") is not None
    assert (cache.get("b") is not None) == bool(where)
    cache.put("d", 3)  # the least recently used: "d" alone, or "b" then "d"
    assert cache.evict_for(9) == (6 if where else 3)
    assert cache.get("free") is not None and cache.get("d") is None
    assert cache.evictions == 4


def test_stage_budget_counts_the_cache_after_making_room(card, fresh_dev):
    e = card({"ballista.engine.hbm_budget_bytes": "10000"})
    for i in range(4):
        fresh_dev.put((("leaf", i), "cuda:0", True), _dev_copy(2000))
    # counted as it is when nothing is needed
    assert e._stage_budget() == 2000
    # a stage of 6000 bytes evicts the oldest copies until it fits beside them
    assert e._stage_budget(need=6000) == 6000
    assert LC.resident_bytes(e) == 4000


SQL = "select a.k, v, w from a join b on a.k = b.k order by v, w"


def _paged_join(monkeypatch, resident: float, budget: int):
    rng = np.random.default_rng(7)
    probe = pa.table({"k": rng.integers(0, 997, 40_000), "v": np.arange(40_000, dtype=np.int64)})
    build = pa.table({"k": np.arange(2_000, dtype=np.int64) % 997,
                      "w": np.arange(2_000, dtype=np.int64) * 10})
    settings = {"ballista.optimizer.broadcast_rows_threshold": "0",
                "ballista.shuffle.partitions": "2", "ballista.tpu.ici_shuffle": "false",
                "ballista.engine.hbm_budget_bytes": str(budget)}
    monkeypatch.setattr(LC, "resident_bytes", lambda engine: resident)
    ctx = BallistaContext.standalone(BallistaConfig(settings), device="cpu")
    ctx.register_arrow("a", probe, partitions=2)
    ctx.register_arrow("b", build, partitions=2)
    return ctx.sql(SQL).collect(), ctx.last_engine_metrics


def test_a_full_cache_never_multiplies_a_paged_joins_passes(monkeypatch):
    """The fault this repairs: with the cache's bytes above the budget, a
    stage was admitted against 1 byte and its paged join doubled its passes
    to 256. Now the passes are those the budget alone needs, and the rows
    are the same."""
    budget = 2_000_000
    alone, m0 = _paged_join(monkeypatch, 0.0, budget)
    assert m0.get("op.PagedJoin.count", 0) > 0
    crowded, m1 = _paged_join(monkeypatch, 2e9, budget)
    assert m1["op.PagedJoin.count"] == m0["op.PagedJoin.count"]
    assert m1["op.PagedJoin.passes"] == m0["op.PagedJoin.passes"]
    assert m1["op.PagedJoin.passes"] < MM.MAX_PAGED_PASSES
    assert crowded.equals(alone)
