"""The torch engine's leaf caches sized from the card, on the CPU.

- The capacity rule: the device cache holds ``DEVICE_CACHE_SHARE`` of a
  card's budget, resolved on a CUDA engine's first lookup; a CPU engine
  leaves it as it is. ``LoadingCache``'s eviction accounting
  (``evicted_weight``, ``evict_for``, ``keep_weightless``,
  ``invalidate_if``).
- A CUDA engine's host entry becomes a storage-free stand-in once its
  tensors are in the device cache; a device eviction drops the stand-in, so
  the next lookup scans and encodes again. The CPU has no CUDA engine, so
  these cases let a CPU engine keep stand-ins as a CUDA one does
  (``leaf_cache.keeps_stand_ins``), over a fresh pair of caches.
- The governor admits a stage against the budget less the cache's resident
  bytes on the card.
- TPC-H q1, q3, q5, q6 and q12 at SF 0.01 with both caches capped below the
  rotation's working set (evictions counted, answers equal the oracle) and
  above it (no eviction, the same answers).
- The counters ``op.LeafCache.evicted_bytes``, ``.device_hits``,
  ``.device_misses`` and ``.device_capacity.max_bytes``, and the range
  ``ballista.leaf.evict``.
"""
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu_torch.client.context import BallistaContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine import torch_engine as TE
from ballista_tpu_torch.models.tpch import TPCH_TABLES
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.utils.cache import LoadingCache

from test_torch_data import torch_oracle_tables, torch_tpch_dir  # noqa: F401
from test_tpch_numpy import ORDERED, assert_frames_match
from tpch_oracle import ORACLES

QUERIES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks",
                       "queries")
ROTATION = ("q1", "q6", "q3", "q5", "q12")
# an H100 80GB HBM3's budget: 0.85 of the 85,017,493,504 bytes it reports
H100_BUDGET = 72_264_869_478


def _sql(qname: str) -> str:
    with open(os.path.join(QUERIES, f"{qname}.sql")) as f:
        return f.read()


def _fresh_caches(monkeypatch, enc_bytes: float, dev_bytes: float) -> tuple:
    """A fresh pair of leaf caches with the store's weighers and listener,
    of the given capacities, in place of the process's."""
    enc = LoadingCache(capacity=enc_bytes, weigher=LC.ENC.weigher, keep_weightless=True)
    dev = LoadingCache(capacity=dev_bytes, weigher=LC.DEV.weigher,
                       eviction_listener=LC._device_evicted)
    monkeypatch.setattr(LC, "ENC", enc)
    monkeypatch.setattr(LC, "DEV", dev)
    return enc, dev


@pytest.fixture
def stand_ins(monkeypatch):
    """The CPU engine keeps stand-ins on the host as a CUDA engine does."""
    monkeypatch.setattr(LC, "keeps_stand_ins", lambda engine: True)


def _ctx(torch_tpch_dir, **settings) -> BallistaContext:  # noqa: F811
    c = BallistaContext.standalone(BallistaConfig({k: str(v) for k, v in settings.items()}),
                                   device="cpu")
    for t in TPCH_TABLES:
        c.register_parquet(t, os.path.join(torch_tpch_dir, t))
    return c


def _rotation(ctx, oracle_tables) -> dict:
    """The rotation once, each answer against the oracle; the leaf-cache,
    fused-input, swapped-join and device-execute counters of its queries
    summed."""
    out: dict = {}
    for q in ROTATION:
        got = ctx.sql(_sql(q)).collect().to_pandas()
        assert_frames_match(got, ORACLES[q](oracle_tables), q in ORDERED, q)
        for k, v in ctx.last_engine_metrics.items():
            if k.startswith(("op.LeafCache.", "op.FusedInput.")) or k in COUNTED:
                out[k] = out.get(k, 0.0) + v
    return out


# the counters a rotation's lookups, builds and programs are pinned by
COUNTED = ("op.LeafCache.hits", "op.LeafCache.misses", "op.LeafCache.device_hits",
           "op.LeafCache.device_misses", "op.LeafCache.evicted_bytes",
           "op.FusedInput.device_builds", "op.FusedInput.host_builds", "op.FusedJoin.swapped",
           "op.DeviceExecute.count", "op.FusedOutput.device_handoffs")
# per case (capped, keeps_stand_ins, broadcast threshold): the COUNTED
# values of the cold rotation and of two warm ones, recorded on the code
# before the leaf caches' policy moved into engine/leaf_cache.py; since
# fused outputs are handed to their device consumers on the device, the
# fused inputs above them are built there too (every host build became a
# device build) and each such hand-off counts
_UNCAPPED = [(6, 62, 6, 35, 0, 4, 0, 0, 92, 4), (12, 0, 6, 0, 0, 0, 0, 0, 71, 4),
             (12, 0, 6, 0, 0, 0, 0, 0, 71, 4)]
_UNCAPPED_T0 = [(24, 102, 20, 67, 0, 12, 0, 1, 264, 10), (52, 32, 34, 32, 0, 3, 0, 1, 241, 10),
                (52, 32, 34, 32, 0, 3, 0, 1, 241, 10)]
ROTATION_COUNTS = {
    (False, False, None): _UNCAPPED,
    (False, True, None): _UNCAPPED,
    (False, False, "0"): _UNCAPPED_T0,
    (False, True, "0"): _UNCAPPED_T0,
    (True, False, None): [(6, 62, 6, 35, 15935360, 4, 0, 0, 92, 4),
                          (6, 62, 6, 35, 17688584, 4, 0, 0, 92, 4),
                          (6, 62, 6, 35, 17688584, 4, 0, 0, 92, 4)],
    (True, True, None): [(6, 62, 6, 35, 11035128, 4, 0, 0, 92, 4),
                         (6, 62, 6, 35, 12562560, 4, 0, 0, 92, 4),
                         (6, 62, 6, 35, 12562560, 4, 0, 0, 92, 4)],
    (True, False, "0"): [(24, 102, 20, 67, 20846592, 12, 0, 1, 264, 10),
                         (24, 102, 20, 67, 22000952, 12, 0, 1, 264, 10),
                         (24, 102, 20, 67, 22000952, 12, 0, 1, 264, 10)],
    (True, True, "0"): [(24, 102, 20, 67, 14038528, 12, 0, 1, 264, 10),
                        (24, 102, 20, 67, 14843312, 12, 0, 1, 264, 10),
                        (24, 102, 20, 67, 14843312, 12, 0, 1, 264, 10)],
}


# ---- the capacity rule and the cache's accounting ------------------------------------
@pytest.mark.parametrize("budget", [0, 1 << 30, H100_BUDGET])
def test_device_cache_capacity_is_a_share_of_the_budget(budget):
    assert MM.device_cache_bytes(budget) == int(budget * MM.DEVICE_CACHE_SHARE)
    # the card keeps the rest of its budget for stages
    assert MM.device_cache_bytes(budget) <= budget // 2


def test_h100_capacity_holds_a_warm_sf10_working_set():
    """About 16 GB of device copies at SF10 (a tenth of that at SF1),
    with the rest of the budget over 40 GB."""
    cap = MM.device_cache_bytes(H100_BUDGET)
    assert 16e9 < cap and H100_BUDGET - cap > 40e9


def test_cuda_engine_sizes_the_device_cache_once(monkeypatch):
    _enc, dev = _fresh_caches(monkeypatch, 1 << 30, 8 << 30)
    monkeypatch.setattr(LC, "_SIZED", False)
    engine = TE.TorchEngine(device="cpu")
    LC._size_device_cache(engine)
    assert dev.capacity == 8 << 30 and not LC._SIZED  # the CPU sizes nothing
    assert "op.LeafCache.device_capacity.max_bytes" not in engine.op_metrics

    class Card:
        type = "cuda"

    monkeypatch.setattr(engine, "device", Card())
    monkeypatch.setattr(engine, "_hbm_budget", lambda: H100_BUDGET)
    LC._size_device_cache(engine)
    assert dev.capacity == MM.device_cache_bytes(H100_BUDGET)
    assert engine.op_metrics["op.LeafCache.device_capacity.max_bytes"] == dev.capacity
    # resolved once in the process: a later engine's budget changes nothing
    monkeypatch.setattr(engine, "_hbm_budget", lambda: 1 << 20)
    LC._size_device_cache(engine)
    assert dev.capacity == MM.device_cache_bytes(H100_BUDGET)


def test_cache_counts_evicted_weight_and_makes_room():
    evicted = []
    c = LoadingCache(capacity=10, weigher=len, eviction_listener=lambda k, v: evicted.append(k))
    for k in "abc":
        c.put(k, "xxxx")
    assert evicted == ["a"] and c.evictions == 1 and c.evicted_weight == 4
    # room for 6 before the entry is loaded: the least recently used goes
    c.get("b")
    assert c.evict_for(6) == 4 and evicted == ["a", "c"] and c.total_weight() == 4
    # an invalidation is no eviction
    c.invalidate("b")
    assert c.evictions == 2 and c.evicted_weight == 8 and evicted == ["a", "c", "b"]


def test_weightless_entries_are_kept():
    c = LoadingCache(capacity=5, weigher=len, keep_weightless=True)
    c.put("stand-in", "")
    for k in "ab":
        c.put(k, "xxxx")
    assert "stand-in" in c._entries and "a" not in c._entries
    c.invalidate_if("stand-in", lambda v: v != "")
    assert "stand-in" in c._entries
    c.invalidate_if("stand-in", lambda v: v == "")
    assert "stand-in" not in c._entries


def test_cache_total_weight_where():
    c = LoadingCache(capacity=100, weigher=len)
    c.put(("x", "cuda:0", True), "aaa")
    c.put(("y", "cuda:1", True), "bb")
    c.put(("z", "cpu", True), "c")
    assert c.total_weight() == 6
    assert c.total_weight(lambda k: k[1].startswith("cuda")) == 5


def test_resident_bytes_count_one_card(monkeypatch):
    _enc, dev = _fresh_caches(monkeypatch, 1 << 30, 1 << 30)
    dev.put((("pq", 1), "cuda:0", True), [torch.zeros(100, dtype=torch.int64)])
    dev.put((("pq", 2), "cuda:1", True), [torch.zeros(10, dtype=torch.int64)])
    dev.put((("pq", 3), "cpu", True), [torch.zeros(1000, dtype=torch.int64)])
    assert LC._resident_on_card(0) == 800 and LC._resident_on_card(1) == 80


# ---- host stand-ins ----------------------------------------------------------------------
def test_stand_in_keeps_metadata_and_weighs_nothing():
    from ballista_tpu_torch.ops.batch import ColumnBatch

    batch = ColumnBatch.from_arrow(pa.table({
        "a": np.arange(5, dtype=np.int64), "b": np.array([1.25, 2.5, 3.75, 4.0, 5.5]),
        "s": ["x", "y", "x", "z", "y"]}))
    enc = KT.encode_host_batch(batch)
    stand = KT.with_stand_ins(enc)
    assert KT.stand_ins(stand) and not KT.stand_ins(enc)
    assert LC.ENC.weigher(stand) == 0 < LC.ENC.weigher(enc)
    assert [(tuple(t.shape), t.device.type) for t in stand.arrays] == \
        [(a.shape, "meta") for a in enc.arrays]
    assert [t.dtype for t in stand.arrays] == [torch.from_numpy(a).dtype for a in enc.arrays]
    assert (stand.n_rows, stand.n_pad, stand.col_meta, stand.int_ranges, stand.ssums) == \
        (enc.n_rows, enc.n_pad, enc.col_meta, enc.int_ranges, enc.ssums)


def test_leaf_on_the_device_keeps_a_stand_in(torch_tpch_dir, torch_oracle_tables,  # noqa: F811
                                             monkeypatch, stand_ins):
    enc, dev = _fresh_caches(monkeypatch, 1 << 30, 1 << 30)
    ctx = _ctx(torch_tpch_dir)
    _rotation(ctx, torch_oracle_tables)
    scans = [k for k in enc._entries if k[0] == "pq"]
    assert scans and all(KT.stand_ins(enc._entries[k]) for k in scans)
    assert enc.total_weight() == 0
    on_device = {k[0] for k in dev._entries}
    assert set(scans) <= on_device
    # warm: every lookup hits, nothing is scanned again
    warm = _rotation(ctx, torch_oracle_tables)
    assert warm.get("op.LeafCache.misses", 0) == 0 and warm["op.LeafCache.hits"] > 0
    assert warm.get("op.LeafCache.evicted_bytes", 0) == 0


def test_device_eviction_drops_the_stand_in(torch_tpch_dir, torch_oracle_tables,  # noqa: F811
                                            monkeypatch, stand_ins):
    enc, dev = _fresh_caches(monkeypatch, 1 << 30, 1 << 30)
    ctx = _ctx(torch_tpch_dir)
    _rotation(ctx, torch_oracle_tables)
    key = next(k for k in dev._entries if k[0][0] == "pq")
    assert KT.stand_ins(enc._entries[key[0]])
    # make room for the whole cache: every copy leaves, and its stand-in
    dev.evict_for(dev.capacity)
    assert len(dev) == 0 and not any(KT.stand_ins(v) for v in enc._entries.values())
    # the next rotation scans and encodes again, with the same answers
    again = _rotation(ctx, torch_oracle_tables)
    assert again["op.LeafCache.device_misses"] > 0
    assert key[0] in enc._entries and key in dev._entries


def test_stand_in_whose_copy_is_gone_is_encoded_again(torch_tpch_dir,  # noqa: F811
                                                      torch_oracle_tables, monkeypatch,
                                                      stand_ins):
    """A device copy invalidated behind the cache's back (its listener
    does not run) leaves a stand-in with no tensors: the leaf's scan runs
    again inside the device lookup."""
    enc, dev = _fresh_caches(monkeypatch, 1 << 30, 1 << 30)
    ctx = _ctx(torch_tpch_dir)
    _rotation(ctx, torch_oracle_tables)
    dev.eviction_listener = None
    dev.clear()
    dev.eviction_listener = LC._device_evicted
    assert any(KT.stand_ins(v) for v in enc._entries.values())
    again = _rotation(ctx, torch_oracle_tables)
    assert again["op.LeafCache.device_misses"] > 0 and len(dev) > 0


def test_tiny_stage_over_a_stand_in_scans_again(torch_tpch_dir, torch_oracle_tables,  # noqa: F811
                                                monkeypatch, stand_ins):
    _fresh_caches(monkeypatch, 1 << 30, 1 << 30)
    _rotation(_ctx(torch_tpch_dir), torch_oracle_tables)
    tiny = _ctx(torch_tpch_dir, **{"ballista.tpu.min_device_rows": 1 << 30})
    got = tiny.sql(_sql("q6")).collect().to_pandas()
    assert_frames_match(got, ORACLES["q6"](torch_oracle_tables), False, "q6")
    assert tiny.last_engine_metrics.get("op.HostTinyStage.count", 0) > 0


# ---- the governor ----------------------------------------------------------------------
def test_admission_budget_less_resident_bytes():
    assert MM.admission_budget_bytes(1000, 0) == 1000
    assert MM.admission_budget_bytes(1000, 300) == 700
    # a budget the cache has filled stays a budget; none stays none
    assert MM.admission_budget_bytes(1000, 5000) == 1
    assert MM.admission_budget_bytes(0, 300) == 0


def test_stage_admitted_against_budget_less_resident(monkeypatch):
    """A partitioned join's stage fits a 50 MB budget alone, and pages when
    the cache holds all of it but 2.5 MB; the rows stay the same."""
    rng = np.random.default_rng(7)
    probe = pa.table({"k": rng.integers(0, 997, 40_000), "v": np.arange(40_000, dtype=np.int64)})
    build = pa.table({"k": np.arange(2_000, dtype=np.int64) % 997,
                      "w": np.arange(2_000, dtype=np.int64) * 10})
    sql = "select a.k, v, w from a join b on a.k = b.k order by v, w"
    settings = {"ballista.optimizer.broadcast_rows_threshold": "0",
                "ballista.shuffle.partitions": "2", "ballista.tpu.ici_shuffle": "false",
                "ballista.engine.hbm_budget_bytes": str(50_000_000)}

    def run(resident: float):
        monkeypatch.setattr(LC, "resident_bytes", lambda engine: resident)
        ctx = BallistaContext.standalone(BallistaConfig(dict(settings)), device="cpu")
        ctx.register_arrow("a", probe, partitions=2)
        ctx.register_arrow("b", build, partitions=2)
        return ctx.sql(sql).collect(), ctx.last_engine_metrics

    alone, m0 = run(0.0)
    assert m0.get("op.PagedJoin.count", 0) == 0
    crowded, m1 = run(50_000_000 - 2_500_000)
    assert m1.get("op.PagedJoin.count", 0) > 0
    assert crowded.equals(alone)


# ---- TPC-H under capped and roomy caches ---------------------------------------------------
@pytest.mark.parametrize("threshold", [None, "0"])
@pytest.mark.parametrize("keeps_stand_ins", [False, True])
@pytest.mark.parametrize("capped", [True, False])
def test_rotation_under_capped_and_roomy_caches(torch_tpch_dir, torch_oracle_tables,  # noqa: F811
                                                monkeypatch, capped, keeps_stand_ins,
                                                threshold):
    """At SF 0.01 a rotation's leaves weigh about 7 MB encoded and 10 MB on
    the device. Capped below that, every rotation evicts and answers right;
    with room, a warm rotation evicts nothing and only hits, and two warm
    rotations count the same hits. With a broadcast threshold of 0 the
    joins partition, fuse and swap as at SF1. Every rotation's counters
    (``COUNTED``) are pinned to the literals of ``ROTATION_COUNTS``."""
    monkeypatch.setattr(LC, "keeps_stand_ins", lambda engine: keeps_stand_ins)
    if capped:
        enc, dev = _fresh_caches(monkeypatch, 1 << 20, 2 << 20)
    else:
        enc, dev = _fresh_caches(monkeypatch, 1 << 30, 1 << 30)
    settings = {} if threshold is None else {"ballista.optimizer.broadcast_rows_threshold":
                                             threshold}
    ctx = _ctx(torch_tpch_dir, **settings)
    cold = _rotation(ctx, torch_oracle_tables)
    warm = [_rotation(ctx, torch_oracle_tables) for _ in range(2)]
    for m in [cold] + warm:
        assert m["op.LeafCache.device_hits"] + m.get("op.LeafCache.device_misses", 0) > 0
        assert m["op.LeafCache.hits"] >= m["op.LeafCache.device_hits"]
    if capped:
        assert all(m["op.LeafCache.evicted_bytes"] > 0 for m in warm)
        assert all(m["op.LeafCache.device_misses"] > 0 for m in warm)
        assert dev.evictions > 0 and dev.evicted_weight > 0
        assert dev.total_weight() <= dev.capacity + max(dev._weights.values())
    else:
        assert cold.get("op.LeafCache.evicted_bytes", 0) == 0
        for m in warm:
            assert m.get("op.LeafCache.evicted_bytes", 0) == 0
            if threshold is None:
                # a partitioned join's build side is copied once per
                # execution, under the prepared batch's id: it always misses
                assert m.get("op.LeafCache.misses", 0) == 0
                assert m.get("op.LeafCache.device_misses", 0) == 0
        assert warm[0] == warm[1]
        assert dev.evictions == 0 and enc.evictions == 0
    got = [tuple(int(m.get(k, 0)) for k in COUNTED) for m in [cold] + warm]
    assert got == ROTATION_COUNTS[capped, keeps_stand_ins, threshold]
    # nothing counted outside COUNTED under these prefixes
    assert {k for m in [cold] + warm for k in m} <= set(COUNTED)


def test_eviction_opens_its_range(torch_tpch_dir, torch_oracle_tables,  # noqa: F811
                                  monkeypatch, stand_ins):
    _fresh_caches(monkeypatch, 1 << 20, 2 << 20)
    ctx = _ctx(torch_tpch_dir)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        m = _rotation(ctx, torch_oracle_tables)
    names = {e.name for e in prof.events()}
    assert "ballista.leaf.evict" in names and m["op.LeafCache.evicted_bytes"] > 0
