"""The leaf caches and their policy: hot leaf encodings on the host (``ENC``)
and their device copies (``DEV``), kept across queries and engines.

Keys name content (``torch_engine._leaf_cache_key``: scan files with their
stamps, in-memory batch ids, the dtype policy), never object ids; a device
key also names its device (``_dev_key``), so a CPU and a CUDA engine never
share a tensor. On the CPU a cached tensor shares memory with its host
array, and on CUDA every later query reads it: no stage may write a leaf
tensor in place.

- Stand-ins (``KT.stand_ins``): on CUDA a scan leaf whose tensors are in
  ``DEV`` keeps only its metadata in ``ENC``, as a fused input built on the
  device always does; one built on the host and a build side keep their
  arrays. Stand-ins weigh nothing; when a device copy leaves ``DEV`` its
  stand-in goes too, so the next lookup encodes again.
- ``DEV`` is sized once per process, on the first CUDA lookup, to
  ``memory_model.DEVICE_CACHE_SHARE`` of the device budget. A copy makes
  room before it allocates (``_room_for``), and a stage is admitted against
  the budget less what ``DEV`` holds on its card (``resident_bytes``).
- ``ballista.tpu.pin_device_cache`` pins a fused input's shards (``_pin``).
- Counted in ``op.LeafCache.{hits,misses,device_hits,device_misses,
  evicted_bytes,device_capacity.max_bytes}``.
Functions take the engine first (metrics, phases, device, budget, copies).
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ballista_tpu_torch.config import BALLISTA_TPU_PIN_DEVICE_CACHE
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.parallel import split_rows
from ballista_tpu_torch.utils.cache import LoadingCache


def _device_evicted(key: tuple, _tensors) -> None:
    """A device copy left ``DEV``: the host entry standing in for it goes
    too. A scan leaf's host key is its content key; a fused input's shard
    ``("fused_dev", k, i)`` stands for the input ``("fused_in", k)``."""
    content = key[0]
    host = ("fused_in", content[1]) if content[0] == "fused_dev" else content
    ENC.invalidate_if(host, KT.stand_ins)


ENC: LoadingCache = LoadingCache(
    capacity=4 * 1024**3,
    weigher=lambda enc: sum(a.nbytes for a in enc.arrays if isinstance(a, np.ndarray)),
    keep_weightless=True,
)
DEV: LoadingCache = LoadingCache(
    # until a CUDA engine sizes it from its card (_size_device_cache)
    capacity=8 * 1024**3, weigher=lambda ts: sum(t.numel() * t.element_size() for t in ts),
    eviction_listener=_device_evicted,
)
_SIZED = False
# depth of leaf-cache calls on this thread: evictions count once, in the
# outermost (a loader may look up other leaves)
_LOOKUP = threading.local()
# a device-cache key's device string -> its card's index (None: not CUDA)
_KEY_CARDS: dict = {}
# (input plan fingerprint, width, device, shard) -> its pinned device-cache key
_PINNED: dict = {}


def clear() -> None:
    ENC.clear()
    DEV.clear()


def build_key(uid) -> tuple:
    """A prepared join build's device key: once per execution."""
    return ("build", uid)


def keeps_stand_ins(engine) -> bool:
    """Whether a scan leaf on the device keeps only stand-ins on the host: on
    CUDA (on the CPU a cached tensor shares its host array's memory)."""
    return engine.device.type == "cuda"


def _dev_key(engine, key: tuple, device=None) -> tuple:
    """A device key: the content key, the device (default the engine's)."""
    return (key, str(device or engine.device), KT.NATIVE_DTYPES)


# ---- counted lookups ---------------------------------------------------------------------
def _lookup(engine, cache: LoadingCache, key, load: Callable):
    """``cache.get_with(key, load)``, counted in ``op.LeafCache.hits`` or
    ``op.LeafCache.misses`` as the cache counts it (a load that another
    thread made for this key is a hit), and for ``DEV`` in
    ``op.LeafCache.device_hits`` or ``device_misses`` too."""
    loaded = []

    def loader():
        loaded.append(True)
        return load()

    on_device = cache is DEV
    if on_device:
        _size_device_cache(engine)
    value = _call(engine, lambda: cache.get_with(key, loader))
    engine._metric("op.LeafCache.misses" if loaded else "op.LeafCache.hits", 1.0)
    if on_device:
        engine._metric("op.LeafCache.device_misses" if loaded else "op.LeafCache.device_hits",
                       1.0)
    return value


def _call(engine, call: Callable):
    """``call()`` of a leaf cache, the bytes either cache evicted meanwhile
    added to ``op.LeafCache.evicted_bytes`` (in the outermost call on this
    thread only: a loader's own lookups are inside it)."""
    depth = getattr(_LOOKUP, "depth", 0)
    before = ENC.evicted_weight + DEV.evicted_weight if depth == 0 else 0.0
    _LOOKUP.depth = depth + 1
    try:
        return call()
    finally:
        _LOOKUP.depth = depth
        if depth == 0:
            evicted = ENC.evicted_weight + DEV.evicted_weight - before
            if evicted:
                engine._metric("op.LeafCache.evicted_bytes", evicted)


# ---- sizing, eviction and residency ------------------------------------------------------
def _size_device_cache(engine) -> None:
    """On a CUDA engine: ``DEV``'s capacity, once per process, from its
    device budget (the card's when the governor is off), counted in
    ``op.LeafCache.device_capacity.max_bytes``."""
    global _SIZED
    if engine.device.type != "cuda":
        return
    if not _SIZED:
        budget = engine._hbm_budget() or MM.detect_device_budget_bytes(engine.device)
        DEV.capacity = MM.device_cache_bytes(budget)
        _SIZED = True
    engine._metric_max("op.LeafCache.device_capacity.max_bytes", DEV.capacity)


def _room_for(engine, nbytes: float) -> None:
    """Evicts device copies, least recently used first, until ``nbytes``
    more fit ``DEV``, before a copy allocates (``ballista.leaf.evict``)."""
    if DEV.total_weight() + nbytes > DEV.capacity:
        with engine._phase("ballista.leaf.evict"):
            DEV.evict_for(nbytes)


def _card_index(device) -> int:
    """The index of the card ``device`` names (bare ``cuda``: the current)."""
    d = torch.device(device)
    return d.index if d.index is not None else torch.cuda.current_device()


def _resident_on_card(card: int) -> float:
    """The bytes of ``DEV``'s copies on CUDA card ``card``."""
    def on_card(key) -> bool:
        dev = key[1]
        if dev not in _KEY_CARDS:
            _KEY_CARDS[dev] = _card_index(dev) if dev.startswith("cuda") else None
        return _KEY_CARDS[dev] == card

    return DEV.total_weight(on_card)


def resident_bytes(engine) -> float:
    """``DEV``'s bytes on the engine's card, pinned ones included."""
    return _resident_on_card(_card_index(engine.device)) if engine.device.type == "cuda" else 0.0


# ---- scan leaves and their device copies -------------------------------------------------
def encoding(engine, key: Optional[tuple], load: Callable) -> KT.EncodedBatch:
    """A scan leaf's encoding, ``load()`` on a miss; ``key`` None: uncached."""
    return load() if key is None else _lookup(engine, ENC, key, load)


def on_device(engine, cache_key: Optional[tuple], arrays: list, device=None,
              host: Optional[Callable] = None) -> list:
    """``arrays`` on ``device`` (default the engine's), read through ``DEV``
    under ``cache_key`` unless it is None. ``host()``, when given, supplies
    the host arrays to copy (``arrays`` may be stand-ins)."""
    if cache_key is None:
        return engine._to_device(arrays, device)
    key = _dev_key(engine, cache_key, device)

    def load() -> list:
        src = arrays if host is None else host()
        _room_for(engine, sum(a.nbytes for a in src))
        return engine._to_device(src, device)

    cached = _lookup(engine, DEV, key, load)
    if len(cached) != len(arrays):  # stale entry shape: reload
        cached = load()
        _call(engine, lambda: DEV.put(key, cached))
    return cached


def resident_leaf(engine, enc: KT.EncodedBatch, key: tuple, encode: Callable) -> list:
    """A cached scan leaf's tensors, through ``DEV``. Where stand-ins are
    kept, its host entry then keeps only the metadata; a stand-in whose
    device copy has gone is encoded again (``encode()``, from its scan)."""
    def host() -> list:
        return encode().arrays if KT.stand_ins(enc) else enc.arrays

    tensors = on_device(engine, key, enc.arrays, host=host)
    if keeps_stand_ins(engine) and not KT.stand_ins(enc):
        _call(engine, lambda: ENC.put(key, KT.with_stand_ins(enc)))
    return tensors


def on_mesh(engine, enc: KT.EncodedBatch, mesh: list, cache_key: Optional[tuple] = None) -> list:
    """Shard ``i``'s arrays on ``mesh[i]``, through ``DEV`` under
    ``cache_key + (i,)`` unless ``cache_key`` is None."""
    with engine._phase("ballista.leaf.h2d"):
        return [on_device(engine, None if cache_key is None else cache_key + (i,), arrays, dev)
                for i, (arrays, dev) in enumerate(zip(split_rows(enc.arrays, len(mesh)), mesh))]


# ---- fused inputs ------------------------------------------------------------------------
def fused_input(engine, key: Optional[tuple], plan: str, mesh: list, build: Callable,
                device_ok: bool = True) -> tuple:
    """(encoding, each shard's device tensors on ``mesh``) of the fused input
    of content key ``key`` (None: uncached) and plan fingerprint ``plan``.
    ``build()`` gives (encoding, shards, or None for a host build). A device
    build's shards enter ``DEV`` as they are; a device miss of one is built
    again, never copied from its stand-ins. With ``device_ok`` False the
    host encoding alone (shards None), in place of an entry of stand-ins."""
    if key is None:
        enc, shards = build()
        if device_ok and shards is None:
            shards = on_mesh(engine, enc, mesh)
        return enc, shards
    built: list = []  # the shards of a build on the device this call made

    def load():
        enc, shards = build()
        if shards is not None:
            built.append(shards)
        return enc

    enc = _lookup(engine, ENC, ("fused_in", key), load)
    if not device_ok:
        if KT.stand_ins(enc):
            enc = load()
            _call(engine, lambda: ENC.put(("fused_in", key), enc))
        return enc, None
    if KT.stand_ins(enc):
        def shard(i):
            if not built:
                # a device-cache miss of an input built on the device
                again = load()
                if not built:  # built on the host this time
                    built.append(on_mesh(engine, again, mesh))
            _room_for(engine, DEV.weigher(built[0][i]))
            return built[0][i]

        shards = [_lookup(engine, DEV, _dev_key(engine, ("fused_dev", key, i), dev),
                          lambda i=i: shard(i))
                  for i, dev in enumerate(mesh)]
    else:
        shards = on_mesh(engine, enc, mesh, ("fused_dev", key))
    _pin(engine, key, plan, mesh)
    return enc, shards


def _pin(engine, key: tuple, plan: str, mesh: list) -> None:
    """With ``ballista.tpu.pin_device_cache`` each shard's copy is pinned,
    one pin per plan, width, device and shard, so a table registered again
    releases its old content's copy; with it off the pins are released."""
    pin = engine.config.get(BALLISTA_TPU_PIN_DEVICE_CACHE)
    for i, dev in enumerate(mesh):
        dev_key = _dev_key(engine, ("fused_dev", key, i), dev)
        slot = (plan, len(mesh), str(dev), i)
        old = _PINNED.pop(slot, None)
        if old is not None and (not pin or old != dev_key):
            DEV.unpin(old)
            if pin:  # the old content's copy
                DEV.invalidate(old)
        if pin:
            _PINNED[slot] = dev_key
            DEV.pin(dev_key)


def build_side(engine, key: Optional[tuple], sig: tuple, build: Callable) -> KT.EncodedBatch:
    """A fused join's build side (``sig``: its join keys); ``key`` None:
    uncached."""
    return build() if key is None else _lookup(engine, ENC, ("fused_jb", key, sig), build)


def build_side_shards(engine, enc: KT.EncodedBatch, mesh: list, key: Optional[tuple],
                      sig: tuple) -> list:
    """The build side's shards on the mesh; ``key`` None: uncached."""
    return on_mesh(engine, enc, mesh, None if key is None else ("fused_jb_dev", key, sig))
