"""Mesh groups: one fused stage spanning several executor processes (the
port of ``ballista_tpu/parallel/multihost.py``).

A stage's materialized shuffle writes files that the next stage fetches
over Flight. A mesh group removes that hop for a gang-scheduled
``final-agg(Repartition(partial-agg))`` stage or partitioned join: the
group's processes run the stage as ONE program over the group's mesh, P
processes of L shards each (a process's shards take the global ranks after
those of lower process ids), whose exchange is one cross-process
``all_to_all`` per round (``parallel.ShardCollective``).

Execution contract: every process of the group calls
``run_fused_aggregate_multihost`` (or ``run_fused_join_multihost``) with the
same plan and its own partitions of the input. The processes first agree on
the encoding through the group's store (a ``torch.distributed.TCPStore``
that process 0 hosts, the counterpart of the ``jax.distributed`` key-value
store): string dictionaries are unioned, null flags OR'd, int ranges
unioned, decimal scales and subset-sum bounds agreed, shard padding maxed.
Every data-dependent decision of the eager program (group radices, decimal
scales, ``presum_safe`` headroom, dictionary codes, padding, exchange
capacity) is then the same in every process, so the buckets and group ids
agree. Each process gets back its own slice: its shards' outputs, in shard
order; the union of the slices is the exact global result.

Transport, chosen once per group from the card identities the members
publish when they join: NCCL when each member has cards of its own; gloo
over pinned host memory on the CPU and when members share a card (NCCL
refuses two ranks on one device). The choice is a rule of where the ranks
are: a transport that fails raises. Each gang attempt builds its own process
group over a ``PrefixStore`` of its tag, once, and the attempt's programs
share it; a group whose collective failed is never used again.

Budget: the shards of all members on one card share that card's budget
(``memory_model.shard_budget_bytes`` over the card's shards in the whole
group), and the group plans against the least per-shard budget of its
members, so a budget decision is the same in every member.
"""
from __future__ import annotations

import datetime
import logging
import pickle
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.errors import ExecutionError
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.schema import DataType

log = logging.getLogger("ballista.multihost")

# how long a member waits for its peers at the group's join
JOIN_TIMEOUT_S = 300.0


class GangUnfusable(ExecutionError):
    """The collective program met a shape it cannot produce correct results
    for (duplicate build keys, skew overflow, a stage the device cannot
    express, an input past the cap or the budget). Deterministic for this
    data: the scheduler must not gang the stage again, and the error text
    carries the ``GANG_UNFUSABLE`` marker it keys on."""

    def __init__(self, detail: str):
        super().__init__(f"GANG_UNFUSABLE: {detail}")


@dataclass
class MeshGroup:
    """This process's membership: the group's shape, where its shards sit,
    the budget and transport the group agreed on, the cross-process
    rounds, bytes and seconds of its exchanges so far, and the process
    groups built for gang attempts and the seconds that took. The group's mesh has
    ``size * local_shards`` shards; this process's ``local_devices`` are
    global ranks ``process_id * local_shards`` onwards."""

    host: str
    port: int
    size: int
    process_id: int
    device: torch.device
    local_devices: list
    store: object  # held open: member 0's hosts the group's store server
    cards: list  # each local shard's card identity
    shards_on_card: dict  # card identity -> the group's shards on it
    own_budget_bytes: int  # this member's per-shard budget
    shard_budget_bytes: int  # the group's: the least over its members
    transport: str  # "nccl" or "gloo"
    transport_reason: str
    stats: dict = field(default_factory=lambda: {"rounds": 0, "bytes": 0, "seconds": 0.0,
                                                 "setups": 0, "setup_s": 0.0})
    lock: threading.Lock = field(default_factory=threading.Lock)
    # (gang attempt, its process group or None once a collective on it
    # failed): the latest attempt's, built by its first program
    attempt_pg: tuple = (None, None)
    pg_lock: threading.Lock = field(default_factory=threading.Lock)

    @property
    def local_shards(self) -> int:
        return len(self.local_devices)

    @property
    def global_shards(self) -> int:
        return self.size * self.local_shards

    def shards_per_card(self) -> int:
        """The most shards of the whole group on one of this member's cards."""
        return max(self.shards_on_card[c] for c in self.cards)

    def mesh_shape(self) -> str:
        """The ``"CxS"`` shape this member registers: its C cards, each
        holding S shards of the group (``parallel.mesh.mesh_shape`` counts
        the member's own shards only)."""
        return f"{len(set(self.cards))}x{self.shards_per_card()}"

    def note(self, nbytes: int, seconds: float) -> None:
        with self.lock:
            self.stats["rounds"] += 1
            self.stats["bytes"] += int(nbytes)
            self.stats["seconds"] += seconds

    def process_group(self, attempt: str, store, timeout: datetime.timedelta):
        """Gang attempt ``attempt``'s process group: built by the attempt's
        first program over ``store`` (a rendezvous and a full-mesh connect,
        counted in ``setups`` / ``setup_s``, apart from the rounds) and
        shared by its later ones. An earlier attempt's is dropped, and one
        whose collective failed raises."""
        with self.pg_lock:
            tag, pg = self.attempt_pg
            if tag == attempt:
                if pg is None:
                    raise ExecutionError(f"gang attempt {attempt}: a collective failed earlier")
                return pg
            self.attempt_pg = (None, None)
            t0 = time.time()
            pg = _new_process_group(self.transport, torch.distributed.PrefixStore(
                f"pg/{attempt}", store), self.process_id, self.size, self.host, timeout)
            with self.lock:
                self.stats["setups"] += 1
                self.stats["setup_s"] += time.time() - t0
            self.attempt_pg = (attempt, pg)
            return pg

    def process_group_failed(self, attempt: str) -> None:
        with self.pg_lock:
            if self.attempt_pg[0] == attempt:
                self.attempt_pg = (attempt, None)


_GROUP: Optional[MeshGroup] = None
_INIT_LOCK = threading.Lock()


def _card_identity(device: torch.device) -> str:
    """The identity of the card a shard runs on: the card's UUID, or the
    host's CPU."""
    if device.type == "cuda":
        return str(torch.cuda.get_device_properties(device).uuid)
    return f"{socket.gethostname()}/cpu"


def _card_budget_bytes(device: torch.device) -> int:
    """A card's whole budget (0 on the CPU, which has none)."""
    from ballista_tpu_torch.engine import memory_model as MM

    return MM.detect_device_budget_bytes(device) if device.type == "cuda" else 0


def _split(coordinator: str) -> tuple[str, int]:
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"mesh group coordinator {coordinator!r}: host:port")
    return host, int(port)


def _timedelta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def init_mesh_group(coordinator: str, num_processes: int, process_id: int,
                    local_devices: Optional[int] = None, device: Optional[str] = None,
                    timeout_s: float = JOIN_TIMEOUT_S) -> MeshGroup:
    """Join this process to a mesh group; once per process (a second call
    returns the group already joined). Process 0 hosts the group's store at
    ``coordinator`` (host:port). ``local_devices`` is this process's shard
    count (``parallel.force_mesh_shards``); ``device`` the engine's (``cuda``
    unless the caller asks for ``cpu``). Every member publishes its shards'
    card identities and its card's budget, and waits for all the others:
    the group's budget split and transport follow from them."""
    global _GROUP
    from ballista_tpu_torch import parallel
    from ballista_tpu_torch.engine import memory_model as MM
    from ballista_tpu_torch.engine.torch_engine import resolve_device
    from ballista_tpu_torch.parallel.mesh import build_mesh

    with _INIT_LOCK:
        if _GROUP is not None:
            return _GROUP
        if not 0 <= int(process_id) < int(num_processes):
            raise ValueError(f"process id {process_id} outside a group of {num_processes}")
        dev = torch.device(resolve_device(device))
        if local_devices is not None:
            parallel.force_mesh_shards(int(local_devices))
        mesh = build_mesh(parallel.mesh_shards(dev), dev)
        host, port = _split(coordinator)
        store = torch.distributed.TCPStore(
            host, port, None, process_id == 0, timeout=_timedelta(timeout_s),
            wait_for_workers=False)
        cards = [_card_identity(d) for d in mesh]
        budgets = {_card_identity(d): _card_budget_bytes(d) for d in set(mesh)}
        store.set(f"join/{process_id}", pickle.dumps(
            {"shards": len(mesh), "cards": cards, "budgets": budgets, "type": dev.type}))
        keys = [f"join/{i}" for i in range(num_processes)]
        store.wait(keys, _timedelta(timeout_s))
        metas = [pickle.loads(store.get(k)) for k in keys]
        counts = {m["shards"] for m in metas}
        if len(counts) != 1:
            raise ExecutionError(f"mesh group members have different shard counts {counts}")
        on_card: dict = {}
        for m in metas:
            for c in m["cards"]:
                on_card[c] = on_card.get(c, 0) + 1
        per_member = [min(MM.shard_budget_bytes(m["budgets"][c], on_card[c])
                          for c in set(m["cards"])) for m in metas]
        transport, reason = _choose_transport(metas)
        _GROUP = MeshGroup(host, port, int(num_processes), int(process_id), dev, mesh, store,
                           cards, on_card, per_member[process_id], min(per_member),
                           transport, reason)
        log.info("mesh group joined: process %d/%d, %d shards on %s, per-shard budget %d "
                 "bytes (group %d), transport %s (%s)", process_id, num_processes, len(mesh),
                 dev, _GROUP.own_budget_bytes, _GROUP.shard_budget_bytes, transport, reason)
        return _GROUP


def _new_process_group(transport: str, store, rank: int, size: int, host: str,
                       timeout: datetime.timedelta):
    dist = torch.distributed
    if transport == "gloo":
        opts = dist.ProcessGroupGloo._Options()
        opts._timeout = timeout
        if host in ("127.0.0.1", "localhost"):
            opts._devices = [dist.ProcessGroupGloo.create_device(hostname="127.0.0.1")]
        else:
            opts._devices = [dist.ProcessGroupGloo.create_default_device()]
        return dist.ProcessGroupGloo(store, rank, size, opts)
    opts = dist.ProcessGroupNCCL.Options()
    opts._timeout = timeout
    return dist.ProcessGroupNCCL(store, rank, size, opts)


def _choose_transport(metas: list) -> tuple[str, str]:
    """(transport, reason) from where the members' shards are."""
    if any(m["type"] != "cuda" for m in metas):
        return "gloo", "the group's shards are on the CPU"
    owner: dict = {}
    for pid, m in enumerate(metas):
        for c in m["cards"]:
            if owner.setdefault(c, pid) != pid:
                return "gloo", f"members {owner[c]} and {pid} share card {c}"
    return "nccl", "each member has cards of its own"


def in_mesh_group() -> bool:
    return _GROUP is not None


def current_group() -> Optional[MeshGroup]:
    return _GROUP


def _require() -> MeshGroup:
    if _GROUP is None:
        raise ExecutionError("not in a mesh group: call init_mesh_group first")
    return _GROUP


class _Attempt:
    """One collective program's rendezvous: a store client with the gang
    attempt's timeout, under the prefix of the program's tag, and the gang
    attempt's process group (``MeshGroup.process_group``). ``exchange`` is
    the transport ``parallel.shard_map`` calls once per round."""

    def __init__(self, group: MeshGroup, tag: str, timeout_ms: int, attempt: str):
        self.group = group
        self.attempt = attempt
        self.timeout = _timedelta(timeout_ms / 1000.0)
        self.timeout_s = timeout_ms / 1000.0
        self.client = torch.distributed.TCPStore(group.host, group.port, None, False,
                                                 timeout=self.timeout)
        self.store = torch.distributed.PrefixStore(f"fg/{tag}", self.client)
        self.size = group.size
        self.on_host = group.transport == "gloo"
        self._published: list[str] = []

    def release(self) -> None:
        """Drop this member's keys once the program has run: every peer
        read them before the program's first round, which no member passes
        alone."""
        for key in self._published:
            self.store.delete_key(key)
        self._published = []

    def publish(self, key: str, obj) -> None:
        self.store.set(f"{key}/{self.group.process_id}", pickle.dumps(obj))
        self._published.append(f"{key}/{self.group.process_id}")

    def fetch_all(self, key: str) -> list:
        keys = [f"{key}/{i}" for i in range(self.size)]
        self.store.wait(keys, self.timeout)
        return [pickle.loads(self.store.get(k)) for k in keys]

    def exchange(self, send: torch.Tensor) -> torch.Tensor:
        """Block ``q`` of ``send`` (its first dimension) to process ``q``;
        block ``q`` of the result from process ``q``. One call, timed
        without the process group's set-up."""
        pg = self.group.process_group(self.attempt, self.client, self.timeout)
        t0 = time.time()
        recv = torch.empty_like(send)
        try:
            pg.alltoall_base(recv, send.contiguous(), [], [],
                             torch.distributed.AllToAllOptions()).wait()
        except Exception:
            self.group.process_group_failed(self.attempt)
            raise
        if recv.is_cuda:
            torch.cuda.current_stream(recv.device).synchronize()
        self.group.note(send.numel(), time.time() - t0)
        return recv

    # ---- the agreed layout ------------------------------------------------------
    def agreed_encoded(self, key: str, batch: ColumnBatch) -> tuple:
        """(encoding, per-shard rows, the group's total rows) of this
        member's ``batch`` under the layout every member agrees on."""
        metas = self._agree(key, batch)
        dicts, force_null, ranges, max_rows, scales, ssums, shared = _agree_encoding(metas)
        n_local = self.group.local_shards
        per_dev = KT.bucket_size(max(1, -(-max_rows // n_local)))
        enc = KT.encode_host_batch(batch, pad=per_dev * n_local, dictionaries=dicts,
                                   force_null=force_null, force_scales=scales)
        enc.int_ranges = ranges
        enc.ssums = ssums
        enc.dict_ids = shared if any(shared) else None
        return enc, per_dev, sum(m["rows"] for m in metas)

    def _agree(self, key: str, batch: ColumnBatch) -> list:
        self.publish(f"meta/{key}", _encoding_meta(batch))
        return self.fetch_all(f"meta/{key}")


def _encoding_meta(batch: ColumnBatch) -> dict:
    """What the other members need to agree on this member's layout. A
    string column also names the catalog-shared dictionary its values all
    lie in (``dict_id``), when this process holds it."""
    from ballista_tpu_torch.engine.dictionaries import REGISTRY

    dicts, shared, has_null, raw_ranges, decimals = [], [], [], [], []
    for f, c in zip(batch.schema, batch.columns):
        dec = None
        did = None
        if f.dtype is DataType.STRING:
            values = KT.sorted_unique(c.data.fill_null(""))
            dicts.append(values.tolist())
            known = REGISTRY.get(c.dict_id) if getattr(c, "dict_id", None) else None
            if known is not None and bool(np.isin(values, known).all()):
                did = c.dict_id
            has_null.append(bool(c.data.null_count))
            raw_ranges.append(None)
        else:
            dicts.append(None)
            has_null.append(bool(c.valid is not None and not c.valid.all()))
            raw_ranges.append(
                KT.raw_int_range(c)
                if f.dtype in (DataType.INT32, DataType.INT64, DataType.DATE32, DataType.BOOL)
                else None)
            if f.dtype is DataType.FLOAT64 and KT.NATIVE_DTYPES:
                sniffed = KT.sniff_decimal(np.asarray(c.data), c.valid)
                if sniffed is not None:
                    s, scaled, (lo, hi) = sniffed
                    dec = (s, lo, hi, KT.abs_sum_bound(scaled))
        shared.append(did)
        decimals.append(dec)
    return {"rows": batch.num_rows, "dicts": dicts, "shared": shared, "has_null": has_null,
            "ranges": raw_ranges, "decimals": decimals}


def _agree_encoding(metas: list) -> tuple:
    """The layout every member computes alike from all members' metadata:
    unioned sorted dictionaries (or the catalog-shared dictionary every
    member's values lie in, with its id: the codes a process that held all
    the rows would give them), OR'd null flags, union int ranges (they set
    the program's grouping radices), the agreed decimal scale with its range
    and the group's subset-sum bound, and the largest row count."""
    from ballista_tpu_torch.engine.dictionaries import REGISTRY

    ncols = len(metas[0]["dicts"])
    union_dicts: list = []
    shared_ids: list = []
    force_null: list = []
    union_ranges: list = []
    force_scales: list = []
    agreed_ssums: list = []
    for i in range(ncols):
        ids = {m["shared"][i] for m in metas}
        did = ids.pop() if len(ids) == 1 else None
        shared_ids.append(did)
        if did is not None:
            union_dicts.append(REGISTRY.get(did))
        elif metas[0]["dicts"][i] is None:
            union_dicts.append(None)
        else:
            values: set = set()
            for m in metas:
                values.update(m["dicts"][i])
            union_dicts.append(np.array(sorted(values), dtype=object))
        force_null.append(any(m["has_null"][i] for m in metas))
        raws = [m["ranges"][i] for m in metas if m["ranges"][i] is not None]
        union_ranges.append(
            KT.bucket_range(min(r[0] for r in raws), max(r[1] for r in raws)) if raws else None)
        # the scaled layout agrees bit for bit: the largest local scale; a
        # member without a decimal (or int64 exactness lost at that scale)
        # keeps the column f64 everywhere
        decs = [m["decimals"][i] for m in metas]
        agreed = agreed_ssum = None
        if all(d is not None for d in decs):
            s_star = max(d[0] for d in decs)
            lo = min(d[1] * 10 ** (s_star - d[0]) for d in decs)
            hi = max(d[2] * 10 ** (s_star - d[0]) for d in decs)
            if max(abs(lo), abs(hi)) < (1 << 53):
                agreed = s_star
                union_ranges[-1] = KT.bucket_range(lo, hi)
                agreed_ssum = KT._pow2_at_least(
                    sum(d[3] * 10 ** (s_star - d[0]) for d in decs))
        force_scales.append(agreed)
        agreed_ssums.append(agreed_ssum)
    max_rows = max(m["rows"] for m in metas)
    return (union_dicts, force_null, union_ranges, max_rows, force_scales, agreed_ssums,
            shared_ids)


# ---- the collective programs ------------------------------------------------------
def _engine(group: MeshGroup):
    from ballista_tpu_torch.engine.torch_engine import TorchEngine

    return TorchEngine(device=str(group.device))


def _check_rows(total: int, max_rows: int, what: str) -> None:
    if max_rows and total > max_rows:
        raise GangUnfusable(f"{what}: {total} input rows past the fused-input cap {max_rows}")


def run_fused_aggregate_multihost(final_plan: P.HashAggregateExec,
                                  partial_plan: P.HashAggregateExec,
                                  local_batches: list, group_tag: str,
                                  timeout_ms: int = 120_000, *, engine=None,
                                  max_rows: int = 0,
                                  attempt: Optional[str] = None) -> ColumnBatch:
    """Collective: every member calls this with its own partitions of the
    partial aggregate's input (already materialized through the subtree
    below it). Returns this member's slice of the global aggregate (each
    group lands on exactly one shard); the union over the members is the
    exact result. ``group_tag`` is unique per (stage attempt, node) and the
    same in every member: it names the rendezvous. ``engine`` (default: a
    torch engine on the group's device) records the program's metrics;
    ``max_rows`` > 0 caps the group's total input rows (past it every member
    raises ``GangUnfusable``). The programs of one gang ``attempt`` (default:
    ``group_tag``) share its process group."""
    from ballista_tpu_torch.engine import fused_exchange as FX

    group = _require()
    engine = engine if engine is not None else _engine(group)
    big = (ColumnBatch.concat(local_batches) if local_batches
           else ColumnBatch.empty(partial_plan.input.schema()))
    mesh = group.local_devices
    n_dev = group.global_shards
    att = _Attempt(group, group_tag, timeout_ms, attempt or group_tag)
    enc, _per_dev, total = att.agreed_encoded("in", big)
    _check_rows(total, max_rows, "fused aggregate")
    if total == 0:
        return ColumnBatch.empty(final_plan.schema())
    holders = [{} for _ in mesh]
    fns = [FX.make_aggregate_dev_fn(final_plan, partial_plan, enc, n_dev, h) for h in holders]
    out, _dt = FX._run_mesh(
        engine, fns, LC.on_mesh(engine, enc, mesh), mesh, enc.n_rows,
        FX.aggregate_estimate(final_plan, partial_plan, enc, holders, n_dev),
        group=att, timeout=att.timeout_s)
    att.release()
    out_db = KT.device_batch_from_outputs(holders[0]["meta"], out, 0)
    return engine._fetch(out_db)


def run_fused_join_multihost(join_plan: P.HashJoinExec, local_left: list, local_right: list,
                             group_tag: str, timeout_ms: int = 120_000, *, engine=None,
                             max_rows: int = 0, attempt: Optional[str] = None) -> ColumnBatch:
    """Collective partitioned join: every member calls this with its own
    partitions of both join inputs (the subtrees below the two
    ``RepartitionExec`` nodes); both sides ride the group's exchange by
    join-key hash and each member gets back its slice of the join. The
    arguments after ``group_tag`` are ``run_fused_aggregate_multihost``'s.

    Build-key uniqueness cannot be checked on one host here (the keys are
    spread over the members), so the program counts duplicate build keys
    and rows past an exchange's capacity on the device and sums the count
    over the group: when it is not zero every member raises
    :class:`GangUnfusable` and the scheduler restarts the stage un-ganged."""
    from ballista_tpu_torch.engine import fused_exchange as FX

    if join_plan.how not in ("inner", "left", "semi", "anti") or not join_plan.on:
        raise GangUnfusable(f"join shape {join_plan.how!r} not collective-fusable")
    group = _require()
    engine = engine if engine is not None else _engine(group)
    lbig = (ColumnBatch.concat(local_left) if local_left
            else ColumnBatch.empty(join_plan.left.input.schema()))
    rbig = (ColumnBatch.concat(local_right) if local_right
            else ColumnBatch.empty(join_plan.right.input.schema()))
    mesh = group.local_devices
    n_dev = group.global_shards
    att = _Attempt(group, group_tag, timeout_ms, attempt or group_tag)
    lenc, _lper, ltotal = att.agreed_encoded("L", lbig)
    renc, _rper, rtotal = att.agreed_encoded("R", rbig)
    _check_rows(max(ltotal, rtotal), max_rows, "fused join")
    if ltotal == 0:
        return ColumnBatch.empty(join_plan.schema())
    holders = [{} for _ in mesh]
    fns = [FX.make_join_dev_fn(join_plan, lenc, renc, n_dev, h) for h in holders]
    ldev = LC.on_mesh(engine, lenc, mesh)
    rdev = LC.on_mesh(engine, renc, mesh)
    out, _dt = FX._run_mesh(
        engine, fns, [ld + rd for ld, rd in zip(ldev, rdev)], mesh, lenc.n_rows + renc.n_rows,
        FX.join_estimate(join_plan, lenc, renc, len(mesh), n_dev), group=att,
        timeout=att.timeout_s)
    att.release()
    rows = FX._fused_rows(engine, holders[0], out)
    if rows is None:
        raise GangUnfusable(
            "fused join: duplicate build keys or skew overflow "
            f"(count {int(out[-1].sum())}); rerun with the materialized exchange")
    return rows
