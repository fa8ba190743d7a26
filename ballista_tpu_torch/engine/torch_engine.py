"""PyTorch execution engine — the port's device backend.

The port of ``ballista_tpu/engine/jax_engine.py``. Whole-stage execution:
the device-supported subtree of a stage (filter, project, hash aggregate,
sort, hash join, cross join, window) runs as one PyTorch program over tensors
on the engine's device, with power-of-two row buckets and validity masks. Host work
is confined to the leaves: scans and unsupported children materialize
host-side (numpy kernels), are encoded, and enter the program as tensors. A
hash join's build side is sorted by key hash on the host once per execution
and probed on the device with ``searchsorted``. String dictionaries are host
metadata — string predicates become lookup tables gathered by code on the
device.

As the JAX engine does over its mesh, a final aggregate over a hash exchange
of a partial aggregate runs as one fused program over the engine's mesh of
``mesh_devices`` shards (partial aggregate, exchange, final aggregate:
``engine/fused_exchange.py``; the mesh: ``parallel``), and so does a
partitioned join over two exchanges whose build keys are unique, or an inner
one whose left keys are, run with the roles exchanged
(``op.FusedJoin.swapped``); config ``ballista.tpu.ici_shuffle=false`` turns
both off. A fused program that declines by design (a zero-row or over-cap
input, repeated keys on the side it sorts, rows past an exchange's
capacity, a budget it exceeds, a shard that failed) is counted in
``op.FusedDeclined.count`` and the materialized exchange runs.
An exchange the scheduler promoted onto the mesh (``IciExchangeExec``) or a
chain it promoted whole (``MegastageExec``, ``engine/megastage.py``) is a
contract instead: every decline raises ``IciDemoted`` naming its exchanges,
and the scheduler splits them onto the Flight tier. In a stage the scheduler
gang-launched onto a mesh group (``ballista.tpu.mesh_group.tag``), the
collectives ``gang_collectives`` finds run across the group's processes
(``parallel/multihost.py``): each member materializes its share of the
input partitions, enters the program with its peers and emits its slice
under output partition == its process id; nothing declines locally (a
refusal the members share raises ``GangUnfusable``, any other failure
raises, and the scheduler restarts the stage). Leaf encodings and their
device copies are cached across queries under content keys
(``engine/leaf_cache.py``), so a warm query re-reads no scan it has seen.
With ``ballista.tpu.min_device_rows`` set, a stage whose leaves hold fewer
rows runs on the host kernels (``op.HostTinyStage.count``), a route the
configuration chose and not a fallback.

The memory governor (``engine/memory_model.py``) gives a CUDA engine a
device budget: ``ballista.engine.hbm_budget_bytes``, or 0.85 of the card's
memory when that is 0 (a CPU engine has none). A stage whose estimate from
its real leaves exceeds the budget pages its widest partitioned join: both
sides are hash-split into buckets on disk and joined one bucket pair at a
time (``op.PagedJoin.count``, ``op.PagedJoin.passes``), as a join the
client's admission flagged ``paged`` always is. A fused exchange whose
estimate exceeds the budget is declined. Each stage records its estimate
(``op.HbmEst.max_bytes``) and, on the card, its measured peak
(``op.HbmPeak.max_bytes``). A stage or fused program is admitted against
the budget less the leaf caches' device copies on its card.

With a trace context (``trace_ctx``), the engine records the JAX engine's
spans: ``CompiledStage`` per device stage (its rows, ``execute_ms``, the
stage's estimate ``hbm_est_bytes`` and, on the card, its measured peak
``hbm_peak_bytes``), ``DeviceExecute`` per device program (``program`` is
``eager`` for a stage, ``fused`` for a fused exchange or join), and
``PagedJoin`` per paged join. Each closes after the synchronisation that
ends its device work, so it holds device time, not enqueue time. There is no
``DeviceCompile`` span: eager torch compiles nothing. Every phase of the
stage driver is an ``obs.Phase``: while ``torch.profiler`` records it is a
``ballista.*`` range on the profiler's timeline (the stage, its leaves,
estimate, device arguments, memory accounting, dispatch, waits and fetch,
leaf encodes and copies), and its time and count go to ``op_metrics``
(``op.DeviceDispatch``, ``op.DeviceWait``, ``op.HostEncode``, ...; the list
is in ``docs/observability.md``). A stage is a child of the operator that
runs it, so that operator's exclusive time leaves the stage out. An
execution's grouped_sums record in ``op.GroupedSums.*``.

PyTorch runs eagerly, so a stage program is traced anew on every call: there
is no compile cache. What a first run costs instead is first launches (CUDA's
lazy load of each kernel module, the grouped_sums library and workspace, the
allocator's first growth), and the scheduler's precompile hints hide them:
the compile service (``engine/compile_service.py``) runs each hinted
downstream stage once on synthetic bucket-shaped inputs while the stage
before it runs (``precompile_stage_template``, the JAX engine's decisions
spec for spec), and a real stage whose shape key was warmed adds the warm's
wall to ``op.CompileHidden.time_s`` once (``compile_hidden_ms`` on its
``CompiledStage`` span). The JAX engine's shape-generalized background
programs of the fused exchange and the megastage have no counterpart: those
run as eager calls on the mesh shards' threads and are never warmed.

Nodes outside ``_supported`` run on the host kernels, as the JAX engine's
unsupported nodes do, and each such run adds to ``op.HostFallback.count``.

A stage over a shuffle read streams (``execute_partition_stream``): chunks
coalesced to ``ballista.tpu.stream_device_rows`` run one device stage each,
with the next chunk's host-to-device copy on a side CUDA stream when
``ballista.engine.prefetch_depth`` > 0, and a final aggregate folds each
chunk's states on the device in ``merge`` mode.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ballista_tpu_torch.config import (
    BALLISTA_ENGINE_PAGED_JOIN, BALLISTA_ENGINE_PAGED_JOIN_THRESHOLD,
    BALLISTA_ENGINE_PRECOMPILE, BALLISTA_ENGINE_PREFETCH_DEPTH, BALLISTA_SHUFFLE_COMPRESSION,
    BALLISTA_TPU_FUSE_INPUT_MAX_ROWS, BALLISTA_TPU_ICI_SHUFFLE,
    BALLISTA_TPU_MESH_GROUP_PROCESS_ID, BALLISTA_TPU_MESH_GROUP_SIZE, BALLISTA_TPU_MESH_GROUP_TAG,
    BALLISTA_TPU_MESH_GROUP_TIMEOUT_MS, BALLISTA_TPU_MIN_DEVICE_ROWS,
    BALLISTA_TPU_NATIVE_DTYPES, BALLISTA_TPU_STREAM_DEVICE_ROWS, BallistaConfig,
)
from ballista_tpu_torch.engine import compile_service as CS
from ballista_tpu_torch.engine import leaf_cache as LC
from ballista_tpu_torch.engine import memory_model as MM
from ballista_tpu_torch.engine.numpy_engine import NumpyEngine
from ballista_tpu_torch.errors import ExecutionError, IciDemoted
from ballista_tpu_torch.ops import grouped_sums as GS
from ballista_tpu_torch.ops import kernels_np as KNP
from ballista_tpu_torch.ops import kernels_torch as KT
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.ops.eval_np import evaluate
from ballista_tpu_torch.parallel import mesh_shards
from ballista_tpu_torch.parallel.mesh import build_mesh, shards_per_card
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.expr import (
    FOLLOWING, PRECEDING, Agg, Alias, BinaryOp, Case, Cast, Col, Expr, Func, InList, IsNull,
    Like, Lit, Not, WindowFunc, unalias, walk,
)
from ballista_tpu_torch.plan.schema import DataType

log = logging.getLogger("ballista.engine")

# leaf_cache's objects, read by portbench/deployments/standalone{,_resident}.py
_ENC_CACHE, _DEV_CACHE, clear_caches = LC.ENC, LC.DEV, LC.clear


def resolve_device(device: Optional[str]) -> str:
    """The engine's device: ``None`` means ``cuda``. Raises when CUDA is asked
    for and unavailable — never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ExecutionError(f"torch engine runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ExecutionError(
            "CUDA is not available; pass device='cpu' to run the torch engine on the host"
        )
    return str(dev)


class _HostFallback(Exception):
    """Raised at trace time when a runtime property forces the host kernel
    path for one stage (e.g. a string aggregate argument, or a join build
    side whose duplicate-key runs exceed the cap)."""


class _PagedJoinFallback(Exception):
    """Raised by ``_run_stage`` when the stage's estimate from its real leaves
    exceeds the device budget: the stage runs again with ``node``, a
    partitioned join, paged."""

    def __init__(self, node):
        super().__init__("stage program over the device budget; paging a join")
        self.node = node


# operators the device could run: when one runs on the host kernels instead,
# it is a host fallback (scans, exchanges and merges are host work on every
# engine)
_DEVICE_OPS = (P.FilterExec, P.ProjectExec, P.HashAggregateExec, P.SortExec,
               P.HashJoinExec, P.CrossJoinExec, P.WindowExec)

# the expanded probe of an emit join (probe n_pad * duplicate bucket) past
# which it falls back; the duplicate-run cap itself is the memory governor's
# (_build_dup_cap)
MAX_EXPAND_ROWS = 1 << 23


class TorchEngine(NumpyEngine):
    name = "torch"

    def __init__(self, config: Optional[BallistaConfig] = None,
                 device: Optional[str] = None):
        super().__init__(config or BallistaConfig())
        self.device = torch.device(resolve_device(device))
        # width of the fused exchange: the process's mesh (parallel.mesh_shards)
        self.mesh_devices = mesh_shards(self.device)
        # fused-exchange results of this execution, keyed by the exchange's
        # (or the join's) node id; None records a declined attempt
        self._fused: dict[int, Optional[list]] = {}
        # > 0 while a subtree runs on host kernels by choice (a tiny stage,
        # or a fused input materialized on the host): no device stages, and
        # no host fallbacks counted
        self._host_only = 0
        # the plan trees _host_tiny_stage rebuilt, kept alive for the
        # execution so no later node reuses an id the materialization
        # caches keyed on
        self._tiny_keepalive: list = []
        # prepared join build sides, computed once per execution (see
        # _prepared_build)
        self._build_prep: dict[tuple, tuple] = {}
        # the device budget, resolved on first use (see _hbm_budget)
        self._hbm_budget_v: Optional[int] = None
        # > 0 while a paged join's passes run: each pass is sized to the
        # budget already, so the stage estimate must not page it again
        self._in_paged = 0
        # the side stream prefetched chunks cross to the card on, made on
        # first use (see _pipelined_chunks)
        self._copy_stream: Optional[torch.cuda.Stream] = None
        # in a gang-scheduled stage: the ids of the collective nodes that run
        # across the mesh group, and of the stage root they were found from
        self._gang_nodes: set = set()
        self._gang_root: Optional[int] = None
        # the running stage's CompiledStage attrs (see _run_stage): its
        # estimate, measured peak and dictionary-coded columns
        self._last_hbm_est = 0
        self._last_hbm_peak = 0
        self._last_dict_shared = 0
        self._last_dict_per_batch = 0
        self._apply_dtype_policy()

    def _apply_dtype_policy(self) -> None:
        # module-level so trace-time literal/arith decisions see it
        KT.NATIVE_DTYPES = bool(self.config.get(BALLISTA_TPU_NATIVE_DTYPES))

    def execute_partition(self, plan: P.PhysicalPlan, partition: int) -> ColumnBatch:
        if self._gang_tag() and self._gang_root != id(plan):
            # the stage's collectives across the mesh group, found once from
            # the root every task of the stage executes
            self._gang_nodes = {id(n) for n in gang_collectives(plan)}
            self._gang_root = id(plan)
        return super().execute_partition(plan, partition)

    def _gang_tag(self) -> Optional[str]:
        """The gang attempt's tag when the scheduler gang-launched this
        stage onto a mesh group, else None."""
        return self.config.settings().get(BALLISTA_TPU_MESH_GROUP_TAG) or None

    def execute_all(self, plan: P.PhysicalPlan) -> list[ColumnBatch]:
        # serial over partitions: one device, and the host thread pool of the
        # numpy engine would only interleave launches
        self._apply_dtype_policy()
        self._cache.clear()
        self._fused.clear()
        self._tiny_keepalive.clear()
        self._build_prep.clear()
        before = GS.thread_record()
        out = [self._exec(plan, i) for i in range(plan.output_partitions())]
        with self._phase("ballista.stage.memory"):
            self._note_device_peak()
        # the execution's grouped_sums calls, its mesh shards' included
        for key, val in GS.record_metrics(GS.record_since(before)).items():
            self._metric(key, val)
        return out

    # ---- dispatch --------------------------------------------------------------
    def _exec(self, plan: P.PhysicalPlan, part: int, unfetched: Optional[list] = None):
        """The partition's output as a host batch. With ``unfetched`` (a
        list), a device stage at ``plan`` returns its ``DeviceBatch`` instead,
        not fetched, and appends its ``CompiledStage`` span dict (None
        untraced) to ``unfetched``: the caller fills in its ``rows``."""
        if isinstance(plan, P.MegastageExec):
            # a promoted whole chain: one mesh program, or a demotion
            return self._run_megastage_node(plan, part)
        if isinstance(plan, P.IciExchangeExec):
            # a promoted exchange runs only inside a collective program of
            # its consumer; reaching the node means every such path declined
            raise IciDemoted([plan.exchange_id], "no collective path for this exchange")
        fused = self._try_fused_exchange(plan, part)
        if fused is not None:
            return fused
        if self._host_only:
            # fused exchanges still apply (above, and a partitioned join at
            # the root of a host-only subtree); plain device stages do not
            if _fusable_partitioned_join(plan):
                fj = self._try_fused_join(plan, part)
                if fj is not None:
                    return fj
            return super()._exec(plan, part)
        if isinstance(plan, P.HashJoinExec) and self._pages(plan):
            return self._paged_join(plan, part)
        if not _supported(plan):
            return super()._exec(plan, part)
        try:
            return self._timed_stage(plan, part, unfetched)
        except _PagedJoinFallback as pf:
            return self._page_and_rerun(plan, pf.node, part)
        except (_HostFallback, KT.DeviceUnsupported):
            pass  # a runtime shape the device path cannot express
        return super()._exec(plan, part)  # host kernels

    def _timed_stage(self, plan: P.PhysicalPlan, part: int, unfetched: Optional[list] = None):
        # a child of the operator that called it, as a host operator is: the
        # caller's exclusive time leaves the stage out
        stack = self._op_stack
        stack.append([0.0])
        ph = self._phase("ballista.stage", "op.CompiledStage", span="CompiledStage")
        try:
            with ph:
                hidden_before = self.op_metrics.get("op.CompileHidden.time_s", 0.0)
                if unfetched is None:
                    out = self._run_stage(plan, part)
                else:
                    out = self._stage_on_device(plan, part)
                # the stage ends in its fetch to the host, which waits for the
                # device, or (unfetched) in the wait that ends its program
                elapsed = ph.stop()
                # the JAX span's attrs; an eager stage compiles nothing
                attrs = {
                    "rows": out.num_rows if isinstance(out, ColumnBatch) else None,
                    "partition": part,
                    "compile_ms": 0.0,
                    "execute_ms": round(elapsed * 1000, 3),
                }
                if self._last_hbm_est:
                    attrs["hbm_est_bytes"] = int(self._last_hbm_est)
                if self._last_hbm_peak:
                    attrs["hbm_peak_bytes"] = int(self._last_hbm_peak)
                if self._last_dict_shared:
                    attrs["dict_shared_cols"] = self._last_dict_shared
                if self._last_dict_per_batch:
                    attrs["dict_per_batch_cols"] = self._last_dict_per_batch
                hidden_s = self.op_metrics.get("op.CompileHidden.time_s", 0.0) - hidden_before
                if hidden_s:
                    attrs["compile_hidden_ms"] = round(hidden_s * 1000, 3)
                ph.attrs = attrs
        finally:
            stack.pop()
            if stack:
                stack[-1][0] += ph.stop()
        if isinstance(out, KT.DeviceBatch):
            unfetched.append(ph.recorded)
        return out

    def _exec_inner(self, plan: P.PhysicalPlan, part: int) -> ColumnBatch:
        if isinstance(plan, _DEVICE_OPS) and not self._host_only:
            self._metric("op.HostFallback.count", 1.0)
        return super()._exec_inner(plan, part)

    def _metric_max(self, key: str, val: float) -> None:
        with self._lock:
            self.op_metrics[key] = max(self.op_metrics.get(key, 0.0), float(val))

    def _sync(self, device=None) -> None:
        if self.device.type == "cuda":
            with self._wait():
                torch.cuda.synchronize(device or self.device)

    def _wait(self):
        """The phase of a wait of the host on the card (``op.DeviceWait``);
        on the CPU there is none to wait for."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return self._phase("ballista.device.wait", "op.DeviceWait")

    def _min_device_rows(self) -> int:
        return int(self.config.get(BALLISTA_TPU_MIN_DEVICE_ROWS) or 0)

    # ---- fused exchanges over the mesh ----------------------------------------------
    def _try_fused_exchange(self, plan: P.PhysicalPlan, part: int) -> Optional[ColumnBatch]:
        """final-agg(Repartition(partial-agg(...))) as one program over the
        mesh: the partial aggregate per shard, its states hash-exchanged and
        merged by the final aggregate on their owning shard. None when the
        shape does not fit (the materialized exchange runs instead); for a
        promoted exchange, ``IciDemoted`` with the reason."""
        if not (isinstance(plan, P.HashAggregateExec) and plan.mode == "final"):
            return None
        rep = plan.input
        if not isinstance(rep, P.RepartitionExec):
            return None
        if id(plan) in self._gang_nodes:
            return self._fused_exchange_multihost(plan, rep, rep.input, part)
        ici_ids = [rep.exchange_id] if isinstance(rep, P.IciExchangeExec) else None
        if not self.config.get(BALLISTA_TPU_ICI_SHUFFLE):
            return self._ici_demote(ici_ids, "engine ICI shuffle disabled")
        partial = rep.input
        if not (isinstance(partial, P.HashAggregateExec) and partial.mode == "partial"):
            return self._ici_demote(ici_ids, "exchange input is not a partial aggregate")
        if not _supported(partial):
            return self._ici_demote(ici_ids, "aggregate not expressible on device")
        if self._fuse_over_cap(rep.est_rows):
            return self._ici_demote(ici_ids, "input exceeds the fused-exchange cap")
        over = self._fused_over_budget(id(rep), [rep])
        if over:
            return self._ici_demote(ici_ids, over)
        from ballista_tpu_torch.engine import fused_exchange as FX

        return self._fused_part(
            id(rep), part, "op.FusedIciExchange.count", ici_ids,
            "collective aggregate declined at runtime",
            lambda: FX.run_fused_aggregate(self, plan, partial, self.mesh_devices))

    def _try_fused_join(self, plan: P.HashJoinExec, part: int) -> Optional[ColumnBatch]:
        """A partitioned join over two exchanges as one program over the mesh
        (see fused_exchange.run_fused_join)."""
        if id(plan) in self._gang_nodes:
            return self._fused_join_multihost(plan, part)
        ici_ids = [s.exchange_id for s in (plan.left, plan.right)
                   if isinstance(s, P.IciExchangeExec)] or None
        if not self.config.get(BALLISTA_TPU_ICI_SHUFFLE):
            return self._ici_demote(ici_ids, "engine ICI shuffle disabled")
        if self._fuse_over_cap(max(plan.left.est_rows, getattr(plan.right, "est_rows", 0))):
            return self._ici_demote(ici_ids, "input exceeds the fused-exchange cap")
        # both exchanged sides are on the device at once
        over = self._fused_over_budget(id(plan), [plan.left, plan.right])
        if over:
            return self._ici_demote(ici_ids, over)
        from ballista_tpu_torch.engine import fused_exchange as FX

        return self._fused_part(
            id(plan), part, "op.FusedIciJoin.count", ici_ids,
            "collective join declined at runtime (skew overflow or non-unique sorted keys)",
            lambda: FX.run_fused_join(self, plan, self.mesh_devices))

    # ---- gang-scheduled collectives across a mesh group ---------------------------
    def _gang_gate(self, exchanges: list) -> tuple:
        """(group, timeout in ms, row cap) of a collective in a gang stage,
        or ``GangUnfusable`` when the engine's knob, the cap or the budget
        refuses it. Every member decides alike: the plan, the session and
        the group's agreed budget are the same in all of them, and a refusal
        restarts the stage un-ganged rather than leave one member to a
        local exchange while its peers wait in the collective."""
        from ballista_tpu_torch.parallel import multihost

        group = multihost.current_group()
        if group is None:
            raise ExecutionError("a gang-launched stage on an executor outside a mesh group")
        launched = (int(self.config.get(BALLISTA_TPU_MESH_GROUP_SIZE)),
                    int(self.config.get(BALLISTA_TPU_MESH_GROUP_PROCESS_ID)))
        if launched != (group.size, group.process_id):
            raise ExecutionError(f"gang launch for member {launched[1]} of {launched[0]} on "
                                 f"member {group.process_id} of {group.size}")
        if not self.config.get(BALLISTA_TPU_ICI_SHUFFLE):
            raise multihost.GangUnfusable("engine ICI shuffle disabled")
        if self._fuse_over_cap(max(x.est_rows for x in exchanges)):
            raise multihost.GangUnfusable("input exceeds the fused-exchange cap")
        budget = self._hbm_budget()
        if budget > 0:
            est = sum(MM.estimate_ici_exchange_bytes(x.schema(), x.est_rows, group.global_shards)
                      for x in exchanges if x.est_rows)
            if est > budget:
                raise multihost.GangUnfusable(
                    f"hbm_budget: exchange estimated {MM.fmt_bytes(est)}/shard over the "
                    f"{MM.fmt_bytes(budget)} budget")
        timeout_ms = int(self.config.get(BALLISTA_TPU_MESH_GROUP_TIMEOUT_MS))
        cap = int(self.config.get(BALLISTA_TPU_FUSE_INPUT_MAX_ROWS) or 0)
        return group, timeout_ms, cap

    def _gang_run(self, group, what: str, run) -> tuple:
        """``run()`` of a collective and the cross-process exchange it made
        (rounds, bytes, seconds, and the gang attempt's process group when
        this program built it: setups, setup_s), also added to
        ``op.MeshGroup.*``. A shape
        the device cannot express (deterministic, so the same in every
        member) raises ``GangUnfusable``, and every other failure raises as
        it is: the scheduler restarts the whole gang stage."""
        from ballista_tpu_torch.parallel import ShardFailed, multihost

        with group.lock:
            before = dict(group.stats)
        try:
            local = run()
        except ShardFailed as err:
            if isinstance(err.error, (_HostFallback, KT.DeviceUnsupported)):
                raise multihost.GangUnfusable(f"{what} not expressible on device: "
                                              f"{err.error}") from err
            raise
        except (_HostFallback, KT.DeviceUnsupported) as err:
            raise multihost.GangUnfusable(f"{what} not expressible on device: {err}") from err
        with group.lock:
            moved = {k: group.stats[k] - before[k] for k in before}
        self._metric("op.MeshGroup.rounds", moved["rounds"])
        self._metric("op.MeshGroup.bytes", moved["bytes"])
        self._metric("op.MeshGroup.time_s", moved["seconds"])
        self._metric("op.MeshGroup.setup_s", moved["setup_s"])
        self._metric_max("op.MeshGroup.shard_budget.max_bytes", group.shard_budget_bytes)
        return local, moved

    def _gang_slice(self, local: ColumnBatch, n_parts: int, pid: int) -> list:
        """A member's slice under output partition ``pid``, the others
        empty: the stage's readers union the members' slices."""
        return [local if p == pid else ColumnBatch.empty(local.schema) for p in range(n_parts)]

    def _gang_failure_kept(self, key, run):
        """``run()``, or the failure it raised, kept for the stage's other
        tasks on this engine: they raise it again at once instead of entering
        the collective a second time, alone, while the stage restarts."""
        try:
            return run()
        except Exception as err:  # noqa: BLE001 - kept, then raised again
            self._fused[key] = err
            raise

    def _gang_result(self, key, part: int) -> ColumnBatch:
        kept = self._fused[key]
        if isinstance(kept, Exception):
            raise kept
        return kept[part]

    def _fused_exchange_multihost(self, plan: P.HashAggregateExec, rep, partial,
                                  part: int) -> ColumnBatch:
        """The fused aggregate across the mesh group of a gang-scheduled
        stage, run once per engine (the stage's tasks on this member share
        it) by ``_gang_aggregate``."""
        key = ("mh", id(plan))
        if key not in self._fused:
            self._fused[key] = self._gang_failure_kept(
                key, lambda: self._gang_aggregate(plan, rep, partial))
        return self._gang_result(key, part)

    def _gang_aggregate(self, plan: P.HashAggregateExec, rep, partial) -> list:
        """This member materializes only its share of the partial
        aggregate's input partitions (partition i belongs to member i %
        size), enters the collective program with its peers and emits its
        slice under output partition == its process id (empties elsewhere)."""
        import hashlib

        from ballista_tpu_torch.parallel import multihost

        group, timeout_ms, cap = self._gang_gate([rep])
        size, pid = group.size, group.process_id
        child = partial.input
        mine = [self._exec(child, i) for i in range(child.output_partitions())
                if i % size == pid]
        disc = hashlib.sha1(plan.fingerprint().encode()).hexdigest()[:12]
        local, moved = self._gang_run(
            group, "aggregate", lambda: multihost.run_fused_aggregate_multihost(
                plan, partial, mine, f"{self._gang_tag()}/a-{disc}", timeout_ms,
                engine=self, max_rows=cap, attempt=self._gang_tag()))
        self._metric("op.FusedMultiHostExchange.count", 1.0)
        log.info("multihost fused aggregate: group=%s process=%d/%d local_rows=%d -> "
                 "%d groups; exchange %d rounds, %d bytes, %.6f s over %s; process group "
                 "set-up %.6f s", self._gang_tag(), pid, size, sum(b.num_rows for b in mine),
                 local.num_rows, moved["rounds"], moved["bytes"], moved["seconds"],
                 group.transport, moved["setup_s"])
        return self._gang_slice(local, plan.output_partitions(), pid)

    def _fused_join_multihost(self, plan: P.HashJoinExec, part: int) -> ColumnBatch:
        """The fused partitioned join across the mesh group, run once per
        engine by ``_gang_join``."""
        key = ("mhj", id(plan))
        if key not in self._fused:
            self._fused[key] = self._gang_failure_kept(key, lambda: self._gang_join(plan))
        return self._gang_result(key, part)

    def _gang_join(self, plan: P.HashJoinExec) -> list:
        """This member materializes its share of both join inputs, enters
        the collective join with its peers, and emits its slice under output
        partition == its process id. Its rendezvous tag comes from the
        plan's fingerprint, the same in every member."""
        import hashlib

        from ballista_tpu_torch.parallel import multihost

        group, timeout_ms, cap = self._gang_gate([plan.left, plan.right])
        size, pid = group.size, group.process_id
        mine_l = [self._exec(plan.left.input, i)
                  for i in range(plan.left.input.output_partitions()) if i % size == pid]
        mine_r = [self._exec(plan.right.input, i)
                  for i in range(plan.right.input.output_partitions()) if i % size == pid]
        disc = hashlib.sha1(plan.fingerprint().encode()).hexdigest()[:12]
        local, moved = self._gang_run(
            group, "join", lambda: multihost.run_fused_join_multihost(
                plan, mine_l, mine_r, f"{self._gang_tag()}/j-{disc}", timeout_ms,
                engine=self, max_rows=cap, attempt=self._gang_tag()))
        self._metric("op.FusedMultiHostJoin.count", 1.0)
        log.info("multihost fused join: group=%s process=%d/%d local_rows=%d/%d -> %d rows; "
                 "exchange %d rounds, %d bytes, %.6f s over %s; process group set-up %.6f s",
                 self._gang_tag(), pid, size, sum(b.num_rows for b in mine_l),
                 sum(b.num_rows for b in mine_r), local.num_rows, moved["rounds"],
                 moved["bytes"], moved["seconds"], group.transport, moved["setup_s"])
        return self._gang_slice(local, plan.output_partitions(), pid)

    def _fused_part(self, key: int, part: int, metric: str, ici_ids, declined: str,
                    run) -> Optional[ColumnBatch]:
        """Partition ``part`` of a fused program's result, run once per
        execution. A program that returns None declined by design (a zero-row
        or over-cap input, repeated sorted keys, rows past an exchange's
        capacity), as does one an injected ``ici.exchange`` fault or a failed
        shard stopped: ``op.FusedDeclined.count``. A stage the device cannot
        express falls back as an unfused stage would. A promoted exchange
        demotes (``declined`` its reason) instead of either."""
        from ballista_tpu_torch.parallel import ShardFailed
        from ballista_tpu_torch.utils import faults

        if key not in self._fused:
            try:
                for i in ici_ids or ():
                    faults.check("ici.exchange", {"exchange_id": i})
                self._fused[key] = run()
            except ShardFailed as err:
                if isinstance(err.error, (_HostFallback, KT.DeviceUnsupported)):
                    self._fused[key] = None
                    return self._ici_demote(ici_ids, "fused program fell back to host")
                log.warning("fused program declined: %s", err, exc_info=err.error)
                self._decline(key)
            except (_HostFallback, KT.DeviceUnsupported):
                self._fused[key] = None
                return self._ici_demote(ici_ids, "fused program fell back to host")
            except faults.InjectedFault:
                self._decline(key)
            else:
                if self._fused[key] is None:
                    self._metric("op.FusedDeclined.count", 1.0)
        result = self._fused[key]
        if result is None:
            return self._ici_demote(ici_ids, declined)
        self._metric(metric, 1.0)
        return result[part]

    def _decline(self, key: int) -> None:
        self._fused[key] = None
        self._metric("op.FusedDeclined.count", 1.0)

    @staticmethod
    def _ici_demote(ici_ids, reason: str):
        """None (a decline: the materialized exchange runs) for an exchange
        the engine fused by its own choice; for a scheduler-promoted one,
        where a host run would defeat the planned boundary, ``IciDemoted``,
        so the scheduler splits it onto the Flight tier."""
        if ici_ids:
            raise IciDemoted(ici_ids, reason)
        return None

    def _run_megastage_node(self, ms: P.MegastageExec, part: int) -> ColumnBatch:
        """A promoted megastage as one mesh program (engine/megastage.py).
        Every decline raises ``IciDemoted`` naming the aggregate exchange the
        megastage promotion added, so the scheduler strips the wrapper and
        splits that boundary; the join's own promoted exchanges then retry
        on the fused paths, which demote themselves if they decline too."""
        from ballista_tpu_torch.config import BALLISTA_ENGINE_MEGASTAGE
        from ballista_tpu_torch.engine import megastage as MS
        from ballista_tpu_torch.parallel import ShardFailed
        from ballista_tpu_torch.utils import faults

        parts = MS.megastage_parts(ms)
        all_ids = [n.exchange_id for n in P.walk_physical(ms) if isinstance(n, P.IciExchangeExec)]
        ici_ids = [parts[1].exchange_id] if parts is not None else (all_ids or [0])
        if not self.config.get(BALLISTA_ENGINE_MEGASTAGE):
            return self._ici_demote(ici_ids, "engine megastage disabled")
        if not self.config.get(BALLISTA_TPU_ICI_SHUFFLE):
            return self._ici_demote(ici_ids, "engine ICI shuffle disabled")
        if parts is None:
            return self._ici_demote(ici_ids, "not a compilable megastage chain")
        _final, agg_ex, _partial, join = parts
        if any(self._fuse_over_cap(r.est_rows) for r in (agg_ex, join.left, join.right)):
            return self._ici_demote(ici_ids, "input exceeds the fused-exchange cap")
        budget = self._stage_budget()
        if budget > 0:
            # the running max over segments, as the JAX package prices it
            segments = [[(r.schema(), r.est_rows) for r in (join.left, join.right) if r.est_rows],
                        [(agg_ex.schema(), agg_ex.est_rows)] if agg_ex.est_rows else []]
            est = MM.estimate_megastage_bytes(segments, self.mesh_devices)
            if est > budget:
                return self._ici_demote(
                    ici_ids, f"hbm_budget: megastage widest segment estimated "
                    f"{MM.fmt_bytes(est)}/device over the {MM.fmt_bytes(budget)} budget")
        key = id(ms)
        if key not in self._fused:
            try:
                for i in all_ids:
                    faults.check("ici.exchange", {"exchange_id": i})
                self._fused[key] = MS.run_megastage(self, ms, self.mesh_devices)
            except (ShardFailed, _HostFallback, KT.DeviceUnsupported,
                    faults.InjectedFault) as err:
                log.info("megastage declined: %s", err)
                self._fused[key] = None
        result = self._fused[key]
        if result is None:
            return self._ici_demote(ici_ids, "megastage declined at runtime")
        return result[part]

    def _fuse_over_cap(self, est_rows: int) -> bool:
        """A fused exchange concatenates and encodes its whole input: past
        the cap the materialized exchange runs instead. Plan-time estimate;
        the fused input's build re-checks the real count."""
        cap = int(self.config.get(BALLISTA_TPU_FUSE_INPUT_MAX_ROWS) or 0)
        return bool(cap) and est_rows > cap

    def _fused_over_budget(self, key: int, exchanges: list) -> Optional[str]:
        """Why the fused program keyed ``key`` would hold more than the
        device budget (None when it fits): its exchanges' estimated
        footprints a shard (the exchanged input, the receive buffer and the
        merged result of each), from the planner's row estimates. A designed
        decline, counted once per execution in ``op.FusedDeclined.count``:
        the materialized exchange runs instead."""
        budget = self._stage_budget()
        if budget <= 0:
            return None
        est = sum(MM.estimate_ici_exchange_bytes(x.schema(), x.est_rows, self.mesh_devices)
                  for x in exchanges if isinstance(x, P.RepartitionExec) and x.est_rows)
        if est <= budget:
            return None
        if key not in self._fused:
            self._decline(key)
        return (f"hbm_budget: exchange estimated {MM.fmt_bytes(est)}/device over the "
                f"{MM.fmt_bytes(budget)} budget")

    # ---- the memory governor -------------------------------------------------------
    def _hbm_budget(self) -> int:
        """The device budget this engine plans against (0: none), resolved
        once: ``ballista.engine.hbm_budget_bytes`` > 0 wins, 0 detects it
        from the engine's card (a CPU engine probes nothing and has none),
        < 0 turns the governor off."""
        if self._hbm_budget_v is None:
            from ballista_tpu_torch.parallel import multihost

            detected = 0
            group = multihost.current_group()
            if group is not None and group.device == self.device:
                # a card's budget is shared by every shard on it, of every
                # member; the group plans against its least member's
                detected = group.shard_budget_bytes
            elif self.device.type == "cuda":
                # a card's budget is shared by the mesh's shards on it
                mesh = build_mesh(self.mesh_devices, self.device)
                detected = MM.shard_budget_bytes(
                    min(MM.detect_device_budget_bytes(d) for d in set(mesh)),
                    shards_per_card(mesh))
            self._hbm_budget_v = MM.resolve_budget_bytes(self.config, detected, self.device)
        return self._hbm_budget_v

    def _stage_budget(self) -> int:
        """The budget a stage or fused program is admitted against: the
        device budget less the leaf caches' copies on this engine's card
        (``leaf_cache.resident_bytes``; none on the CPU, whose cached tensors
        share host memory)."""
        budget = self._hbm_budget()
        if budget <= 0:
            return budget
        return MM.admission_budget_bytes(budget, LC.resident_bytes(self))

    def _paged_join_enabled(self) -> bool:
        return bool(self.config.get(BALLISTA_ENGINE_PAGED_JOIN))

    def _paged_threshold(self) -> float:
        return float(self.config.get(BALLISTA_ENGINE_PAGED_JOIN_THRESHOLD) or 1.0)

    def _pages(self, node: P.HashJoinExec) -> bool:
        """Does this join run as a paged join here? Flagged by admission (or
        by a stage estimate over the budget), partitioned, with keys, and
        not already one pass of a paged join."""
        return (node.paged and bool(node.on) and not node.collect_build
                and not self._in_paged and self._paged_join_enabled())

    def _build_dup_cap(self, node: P.HashJoinExec, build: ColumnBatch) -> int:
        """The longest duplicate-key run this join's build may hold on the
        device (``memory_model.solve_build_dup_cap`` under the budget; probe
        rows estimated by the build's, the sides being co-partitioned)."""
        return MM.solve_build_dup_cap(node.left.schema(), build.num_rows, build.schema,
                                      build.num_rows, node.how, self._hbm_budget())

    def _page_and_rerun(self, plan: P.PhysicalPlan, join: P.HashJoinExec,
                        part: int) -> ColumnBatch:
        """The stage again with ``join`` (possibly interior) flagged paged:
        leaf collection then runs it as a paged join and the rest of the
        stage reads its output as a leaf."""
        if join is plan:
            return self._paged_join(join, part)

        def mark(node: P.PhysicalPlan) -> P.PhysicalPlan:
            if node is join:
                return P.HashJoinExec(node.left, node.right, node.how, node.on, node.filter,
                                      node.collect_build, paged=True)
            kids = node.children()
            new = [mark(c) for c in kids]
            if all(a is b for a, b in zip(kids, new)):
                return node
            return node.with_children(*new)

        new_plan = mark(plan)
        # untouched subtrees keep their identity, so the id-keyed caches hit;
        # the rebuilt spine lives for the execution, so no later node reuses
        # one of its ids
        self._tiny_keepalive.append(new_plan)
        return self._exec(new_plan, part)

    def _paged_join(self, plan: P.HashJoinExec, part: int) -> ColumnBatch:
        """A join whose program cannot fit the device budget, in passes
        (Grace-style): both sides of this partition are hash-split on the
        join keys into ``passes`` buckets on disk (salted, so the split is
        independent of the exchange that partitioned them), and each bucket
        pair runs as an ordinary device join sized to fit the budget.
        Matching rows share a bucket, so the passes' results together are
        the join (in another row order)."""
        with self._phase("ballista.join.paged", span="PagedJoin") as ph:
            out, attrs = self._paged_passes(plan, part)
            ph.attrs = attrs
        self._metric("op.PagedJoin.count", 1.0)
        self._metric("op.PagedJoin.passes", float(attrs["passes"]))
        return out

    def _paged_passes(self, plan: P.HashJoinExec, part: int) -> tuple:
        """The paged join's result and its span's attrs."""
        from ballista_tpu_torch.engine.spill import PartitionSpill

        probe = self._exec(plan.left, part)
        build = self._exec(plan.right, part)
        budget = self._stage_budget()
        limit = int(budget * self._paged_threshold()) if budget > 0 else 0
        # passes are sized with the build's real duplicate runs (a key's
        # duplicates share a bucket, so splitting never shortens them),
        # capped at what one device join may hold
        dup = 1
        if plan.on and build.num_rows:
            bkey, bvalid = KNP.combined_key([evaluate(r, build) for _, r in plan.on])
            bk = bkey[bvalid]
            if len(bk):
                _, counts = np.unique(bk, return_counts=True)
                dup = min(int(counts.max()), self._build_dup_cap(plan, build))
        passes = 2
        while limit and passes < MM.MAX_PAGED_PASSES and MM.estimate_join_program(
                probe.schema, max(1, probe.num_rows // passes),
                build.schema, max(1, build.num_rows // passes), plan.how,
                max_dup=dup) > limit:
            passes <<= 1
        codec = str(self.config.get(BALLISTA_SHUFFLE_COMPRESSION) or "")
        p_spill = PartitionSpill(passes, [l for l, _ in plan.on], salted=True,
                                 compression=codec)
        b_spill = PartitionSpill(passes, [r for _, r in plan.on], salted=True,
                                 compression=codec)
        pieces: list[ColumnBatch] = []
        self._in_paged += 1
        try:
            p_spill.append_split(probe)
            p_spill.finish()
            b_spill.append_split(build)
            b_spill.finish()
            for b in range(passes):
                pb = p_spill.read_all(b, probe.schema)
                bb = b_spill.read_all(b, build.schema)
                # an empty side that cannot change the result: inner and
                # semi need both; left and anti emit unmatched probe rows,
                # right unmatched build rows, full both
                if plan.how in ("inner", "semi"):
                    if pb.num_rows == 0 or bb.num_rows == 0:
                        continue
                elif plan.how in ("left", "anti"):
                    if pb.num_rows == 0:
                        continue
                elif plan.how == "right":
                    if bb.num_rows == 0:
                        continue
                elif pb.num_rows == 0 and bb.num_rows == 0:
                    continue
                sub = P.HashJoinExec(_scan_of(pb), _scan_of(bb), plan.how, plan.on,
                                     plan.filter)
                # alive for the execution: the id-keyed caches must never
                # see a recycled address
                self._tiny_keepalive.append(sub)
                pieces.append(self._exec(sub, 0))
        finally:
            self._in_paged -= 1
            p_spill.close()
            b_spill.close()
        out = ColumnBatch.concat(pieces) if pieces else ColumnBatch.empty(plan.schema())
        # each pass ended in its fetch to the host
        return out, {"rows": out.num_rows, "partition": part, "passes": passes,
                     "probe_rows": probe.num_rows, "build_rows": build.num_rows,
                     "hbm_budget_bytes": budget}

    def _note_device_peak(self) -> None:
        """Fold the allocator's high-water mark since its last reset into
        ``op.DevicePeak.max_bytes``: the most device memory the execution
        held at once, cached leaves included. Each device stage resets the
        mark to measure itself, so it is read before every reset and once
        at the end."""
        if self.device.type == "cuda":
            self._metric_max("op.DevicePeak.max_bytes", MM.device_peak_bytes(self.device))

    # ---- the stage driver ----------------------------------------------------------
    def _run_stage(self, plan: P.PhysicalPlan, part: int) -> ColumnBatch:
        out = self._stage_on_device(plan, part)
        return out if isinstance(out, ColumnBatch) else self._fetch(out)

    def _stage_on_device(self, plan: P.PhysicalPlan, part: int):
        """The stage's program run to its end: its output as a
        ``DeviceBatch`` on the device, or a host batch where the stage ran
        on the host kernels (a tiny stage)."""
        with self._phase("ballista.stage.leaves"):
            leaves = self._collect_leaves(plan, part)
        # this stage's CompiledStage attrs, reset so a host path taken below
        # (a tiny stage) cannot report the previous stage's
        self._last_hbm_est = 0
        self._last_hbm_peak = 0
        self._last_dict_shared = 0
        self._last_dict_per_batch = 0
        for _kind, enc, _extra, _key, _node in leaves.values():
            dids = enc.dict_ids or [None] * len(enc.col_meta)
            for m, did in zip(enc.col_meta, dids):
                if m[2] is not None:
                    if did:
                        self._last_dict_shared += 1
                    else:
                        self._last_dict_per_batch += 1
        min_rows = self._min_device_rows()
        if min_rows and leaves and sum(e.n_rows for _, e, _, _, _ in leaves.values()) < min_rows:
            # every leaf is already on the host: a stage this small costs
            # more in launches and copies than its host kernels take
            return self._host_tiny_stage(plan, part, leaves)

        # the stage's device bytes, estimated from its real leaves: past the
        # budget, its widest partitioned join pages (a safety net under
        # admission, which plans from row estimates)
        with self._phase("ballista.stage.estimate"):
            self._last_hbm_est = MM.estimate_program_bytes(plan, leaves)
            self._metric_max("op.HbmEst.max_bytes", self._last_hbm_est)
            est = MM.estimate_eager_program_bytes(plan, leaves)
            self._metric_max("op.HbmEstEager.max_bytes", est)
            budget = self._stage_budget()
            if (budget > 0 and est > self._paged_threshold() * budget and not self._in_paged
                    and self._paged_join_enabled()):
                # never a join whose output a fused exchange supplied (an "out"
                # leaf): the fused program serves the whole join on partition 0,
                # while a paged join reads one exchange partition per task, so
                # paging it would lose every row outside partition 0
                candidates = [n for n in P.walk_physical(plan)
                              if isinstance(n, P.HashJoinExec) and n.on and not n.collect_build
                              and not n.paged and leaves.get(id(n), ("",))[0] != "out"]
                if candidates:
                    raise _PagedJoinFallback(
                        max(candidates, key=lambda n: MM.estimate_eager_program_bytes(n, leaves)))

        if self._precompile_enabled():
            self._adopt_warm(plan, leaves)
        with self._phase("ballista.stage.args"):
            tensors = self._device_args(leaves, part)
        stage_fn, holder = _make_stage_fn(plan, _stage_layout(leaves))

        in_rows = float(sum(enc.n_rows for _, enc, _, _, _ in leaves.values()))
        # no warm run falls inside the measured window (compile_service.WINDOW)
        with CS.WINDOW.stage():
            with self._phase("ballista.stage.memory"):
                base = self._stage_peak_start()
            with self._phase("ballista.device.execute", "op.DeviceExecute",
                             span="DeviceExecute") as ex:
                ex.attrs = {"rows": in_rows, "program": "eager"}
                # the eager program's launches, and any waits inside them
                with self._phase("ballista.stage.dispatch", "op.DeviceDispatch"):
                    out = stage_fn(*tensors)
                self._sync()
            if base is not None:
                with self._phase("ballista.stage.memory"):
                    # arguments (each tensor once) plus what the program allocated
                    resident = sum(t.numel() * t.element_size()
                                   for t in {t.data_ptr(): t for t in tensors}.values())
                    self._last_hbm_peak = MM.measured_program_bytes(self.device, base,
                                                                    resident)
                    self._metric_max("op.HbmPeak.max_bytes", self._last_hbm_peak)
        self._metric("op.DeviceExecute.rows", in_rows)

        return KT.device_batch_from_outputs(holder["meta"], list(out), 0)

    def _precompile_enabled(self) -> bool:
        return bool(self.config.get(BALLISTA_ENGINE_PRECOMPILE))

    def _warm_key(self, plan: P.PhysicalPlan, leaves: dict) -> tuple:
        """The shape key a warm run records and a real stage looks up: the
        program's fingerprint, its leaves' layout without their data stats,
        the dtype policy and the device."""
        return ("gen", plan.fingerprint(), _shape_key(leaves), KT.NATIVE_DTYPES,
                str(self.device))

    def _adopt_warm(self, plan: P.PhysicalPlan, leaves: dict) -> None:
        """A real stage's lookup of its warmed key (``compile_cache.hits`` or
        ``misses``); a warm found and not yet credited adds its wall to
        ``op.CompileHidden.time_s``."""
        svc = CS.get_service()
        entry = svc.cache.lookup(lambda: self._warm_key(plan, leaves))
        if entry is not None:
            hidden_ms = svc.note_hidden(entry)
            if hidden_ms:
                self._metric("op.CompileHidden.time_s", hidden_ms / 1000.0)

    def _stage_peak_start(self) -> Optional[int]:
        """On the card: the allocator's peak reset (after folding it into
        ``op.DevicePeak.max_bytes``) and the bytes allocated now, from which
        the stage's peak is measured. None on the CPU."""
        if self.device.type != "cuda":
            return None
        self._sync()
        self._note_device_peak()
        torch.cuda.reset_peak_memory_stats(self.device)
        return torch.cuda.memory_allocated(self.device)

    def _fetch(self, out_db) -> ColumnBatch:
        with self._phase("ballista.stage.fetch", "op.DeviceFetch"):
            batch = KT.to_host(out_db, self._wait)
        self._metric(
            "op.DeviceFetch.bytes",
            float(sum(c.data.nbytes for c in batch.columns
                      if c.dtype is not None and not c.dtype.is_string)),
        )
        return batch

    def _host_tiny_stage(self, plan: P.PhysicalPlan, part: int, leaves: dict) -> ColumnBatch:
        """The stage on host kernels, each materialized leaf substituted into
        the plan as a MemoryScanExec (nothing upstream runs again)."""

        def scan_of(node: P.PhysicalPlan, enc) -> P.MemoryScanExec:
            # a stand-in's rows are on the device only: its scan runs again
            batch = (self._exec_child(node, part) if KT.stand_ins(enc)
                     else KT.decode_encoded_batch(enc))
            parts = [batch if i == part else ColumnBatch.empty(enc.schema)
                     for i in range(max(node.output_partitions(), part + 1))]
            return P.MemoryScanExec(parts, enc.schema, ephemeral=True)

        # "out" leaves stand for the node; "build" and "cross" leaves for the
        # join's right side. The batch at index ``part`` serves partitioned
        # joins (partitions[part]) and collected ones (the concat of all)
        subs = {node_id: (kind == "out", scan_of(node if kind == "out" else node.right, enc))
                for node_id, (kind, enc, _x, _k, node) in leaves.items()}

        def rebuild(node: P.PhysicalPlan) -> P.PhysicalPlan:
            sub = subs.get(id(node))
            if sub is not None and sub[0]:
                return sub[1]
            ch = node.children()
            if not ch:
                return node
            return node.with_children(*[sub[1] if sub is not None and i == 1 else rebuild(c)
                                        for i, c in enumerate(ch)])

        self._metric("op.HostTinyStage.count", 1.0)
        new_plan = rebuild(plan)
        self._tiny_keepalive.append(new_plan)
        # host-only for the whole substituted subtree: its children dispatch
        # through self._exec, which must not start device stages again
        self._host_only += 1
        try:
            return NumpyEngine._exec(self, new_plan, part)
        finally:
            self._host_only -= 1

    def _device_args(self, leaves: dict, part: int) -> list:
        """Every leaf array on the device, in the stage's parameter order (a
        build leaf's sorted keys after its columns); leaves with a cache key
        through the device cache."""
        out = []
        for kind, enc, extra, cache_key, node in leaves.values():
            arrays = enc.arrays if extra is None else enc.arrays + [extra[0]]
            # a streamed chunk whose copies the prefetch already issued on
            # the side stream (single-use, like its pre-encode)
            pre = getattr(enc, "_pre_dev", None)
            if pre is not None and cache_key is None and extra is None:
                enc._pre_dev = None
                out.extend(self._await_prefetched(*pre))
                continue
            if kind == "out" and cache_key is not None:
                out.extend(LC.resident_leaf(
                    self, enc, cache_key, lambda: self._encode(self._exec_child(node, part))))
                continue
            out.extend(LC.on_device(self, cache_key, arrays))
        return out

    def _await_prefetched(self, tensors: list, done) -> list:
        """Tensors the prefetch copied on the side stream, made safe to use
        on this thread's current stream: it waits for the copies' event, and
        each tensor records that stream, so the caching allocator hands its
        memory back only once the compute queued on it has run."""
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in tensors:
                t.record_stream(cur)
        self._metric("op.PrefetchH2D.count", 1.0)
        return tensors

    def _to_device(self, arrays: list, device=None) -> list:
        """Host arrays on ``device`` (default the engine's): the copies
        issued non-blocking from pinned memory and awaited together, so the
        transfer time stays out of the execute time."""
        device = torch.device(device or self.device)
        with self._phase("ballista.leaf.h2d", "op.DeviceTransfer"):
            out = [KT.host_to_device(a, device) for a in arrays]
            if device.type == "cuda":
                self._sync(device)
        self._metric("op.DeviceTransfer.bytes", float(sum(a.nbytes for a in arrays)))
        return out

    # ---- leaf collection -------------------------------------------------------------
    def _collect_leaves(self, plan: P.PhysicalPlan, part: int) -> dict:
        """Walk the device subtree; materialize and encode its leaf inputs on
        the host. Returns {id(node): (kind, EncodedBatch, extra, cache key,
        node)}:

        * ``"out"`` — the node's own output (an unsupported subtree, or a
          fused exchange's result);
        * ``"build"`` — a hash join's prepared build side, ``extra`` its
          (sorted build keys, duplicate bucket);
        * ``"cross"`` — a cross join's one-row right side.

        A scan leaf's encoding is read through the leaf caches under its
        content key (``_leaf_cache_key``). Insertion order is the stage's
        parameter layout."""
        leaves: dict[int, tuple] = {}

        def visit(node: P.PhysicalPlan):
            if isinstance(node, P.MegastageExec):
                # a promoted whole chain (or its demotion): its output is a leaf
                leaves[id(node)] = ("out", self._encode(self._run_megastage_node(node, part)),
                                    None, None, node)
                return
            # a final aggregate over an exchange, or a partitioned join, may
            # run as a fused program; its merged output is a leaf here
            if isinstance(node, P.HashAggregateExec) and node.mode == "final":
                fused = self._try_fused_exchange(node, part)
                if fused is not None:
                    leaves[id(node)] = ("out", self._encode(fused), None, None, node)
                    return
            if isinstance(node, P.HashJoinExec) and self._pages(node):
                # a paged join inside the stage: its output is a leaf
                leaves[id(node)] = ("out", self._encode(self._paged_join(node, part)), None,
                                    None, node)
                return
            if isinstance(node, P.HashJoinExec) and _supported(node):
                if _fusable_partitioned_join(node):
                    fused = self._try_fused_join(node, part)
                    if fused is not None:
                        leaves[id(node)] = ("out", self._encode(fused), None, None, node)
                        return
                visit(node.left)
                enc, bk, max_dup, uid = self._prepared_build(node, part)
                leaves[id(node)] = ("build", enc, (bk, max_dup), LC.build_key(uid), node)
                return
            if isinstance(node, P.CrossJoinExec) and _supported(node):
                visit(node.left)
                right = self._materialized_single(node.right)
                if right.num_rows != 1:
                    raise _HostFallback(f"cross join right side of {right.num_rows} rows")
                leaves[id(node)] = ("cross", self._encode(right), None, None, node)
                return
            if _supported(node):
                for c in node.children():
                    visit(c)
                return
            key = _leaf_cache_key(node, part)
            enc = LC.encoding(self, key, lambda: self._encode(self._exec_child(node, part)))
            leaves[id(node)] = ("out", enc, None, key, node)

        visit(plan)
        return leaves

    def _encode(self, batch: ColumnBatch):
        # the prefetch may have encoded this chunk on its producer thread
        # already (single-use: consumed here, so a reused batch never replays it)
        pre = getattr(batch, "_pre_enc", None)
        if pre is not None:
            batch._pre_enc = None
            return pre
        with self._phase("ballista.leaf.encode", "op.HostEncode"):
            return KT.encode_host_batch(batch)

    def _prepared_build(self, node: P.HashJoinExec, part: int) -> tuple:
        """The join's build side sorted by key hash and encoded, once per
        execution. Keyed on the build subtree's identity, the partition (none
        for a collected build, which every probe partition shares), the key
        expressions and outer-ness, which together pin the prepared layout."""
        key = (
            id(node.right),
            None if node.collect_build else part,
            tuple(repr(r) for _, r in node.on),
            node.how in ("right", "full"),
        )
        prep = self._build_prep.get(key)
        if prep is None:
            if node.collect_build:
                build = self._materialized_single(node.right)
            else:
                build = self._exec_child(node.right, part)
            with self._phase("ballista.leaf.encode", "op.HostEncode"):
                prep = _prep_build(build, node, self._build_dup_cap(node, build))
            self._build_prep[key] = prep
        return prep

    def _exec_child(self, node: P.PhysicalPlan, part: int) -> ColumnBatch:
        """Host-materialize a leaf; its own subtree may still use device
        stages (NumpyEngine dispatches children through ``self._exec``). A
        promoted chain or exchange never materializes on the host: it runs
        as its mesh program or demotes."""
        if isinstance(node, (P.MegastageExec, P.IciExchangeExec)):
            return self._exec(node, part)
        return NumpyEngine._exec(self, node, part)

    # ---- device streaming (bounded-memory shuffle consumers) -------------------------
    # Streamed shuffle-read chunks are coalesced to the device-batch budget,
    # spliced into the plan as single-use MemoryScan leaves and run through the
    # ordinary stage driver. A final aggregate folds each chunk's partial
    # states on the device with a merge-mode aggregate, so resident state stays
    # bounded by the distinct-group count while the per-chunk work runs on the
    # card.
    def _stream_maker(self, plan: P.PhysicalPlan, part: int):
        if self._host_only:
            return super()._stream_maker(plan, part)
        if isinstance(plan, P.HashAggregateExec) and plan.mode == "final" and _supported(plan):
            return lambda: self._stream_device_final_agg(plan, part)
        if self._chunkwise_device(plan) and self._chunk_source(plan) is not plan:
            return lambda: self._stream_device_chunks(plan, part)
        return super()._stream_maker(plan, part)

    def _chunkwise_device(self, node: P.PhysicalPlan) -> bool:
        """Can this node process one streamed chunk at a time on the device?
        A probe join streams its probe side against a collected build;
        right and full joins would need unmatched-build tracking across
        chunks, so they stay on the one-shot path."""
        if isinstance(node, (P.FilterExec, P.ProjectExec)):
            return _supported(node)
        if isinstance(node, P.HashJoinExec):
            return (node.collect_build and node.how in ("inner", "left", "semi", "anti")
                    and _supported(node))
        return False

    def _chunk_source(self, plan: P.PhysicalPlan) -> P.PhysicalPlan:
        """Descend the chunk-wise device chain to the streamed source node."""
        node = plan
        while self._chunkwise_device(node):
            node = node.left if isinstance(node, P.HashJoinExec) else node.input
        return node

    def _stream_device_rows(self) -> int:
        return int(self.config.get(BALLISTA_TPU_STREAM_DEVICE_ROWS) or (1 << 20))

    def _coalesce_chunks(self, chunks):
        """Streamed chunks concatenated up to the device-batch budget: each
        stage launch amortises over a large batch while resident memory stays
        bounded by the budget."""
        budget = max(1, self._stream_device_rows())
        buf: list[ColumnBatch] = []
        rows = 0
        for c in chunks:
            if c.num_rows == 0:
                continue
            buf.append(c)
            rows += c.num_rows
            if rows >= budget:
                yield buf[0] if len(buf) == 1 else ColumnBatch.concat(buf)
                buf, rows = [], 0
        if buf:
            yield buf[0] if len(buf) == 1 else ColumnBatch.concat(buf)

    def _splice(self, plan: P.PhysicalPlan, source: P.PhysicalPlan, scan) -> P.PhysicalPlan:
        """``plan`` with ``source`` replaced by ``scan``, keeping the identity
        of every untouched subtree: the id-keyed caches (prepared builds,
        materialized inputs) must keep hitting across chunks."""
        if plan is source:
            return scan
        kids = plan.children()
        new = [self._splice(c, source, scan) for c in kids]
        if all(a is b for a, b in zip(kids, new)):
            return plan
        return plan.with_children(*new)

    def _scan_at(self, batch: ColumnBatch, part: int) -> P.MemoryScanExec:
        """A scan serving ``batch`` at partition ``part``, kept out of the
        content-keyed leaf caches (a chunk is never read again)."""
        parts = [batch if i == part else ColumnBatch.empty(batch.schema) for i in range(part + 1)]
        return P.MemoryScanExec(parts, batch.schema, ephemeral=True)

    def _exec_spliced(self, plan: P.PhysicalPlan, source: P.PhysicalPlan,
                      chunk: ColumnBatch, part: int) -> ColumnBatch:
        # the spliced tree is not kept: cache entries key only on original
        # nodes, which the caller's plan keeps alive, and keeping every
        # chunk's tree would pin every chunk's data for the whole task
        return self._exec(self._splice(plan, source, self._scan_at(chunk, part)), part)

    def _prefetch_depth(self) -> int:
        return int(self.config.get(BALLISTA_ENGINE_PREFETCH_DEPTH) or 0)

    def _pipelined_chunks(self, source: P.PhysicalPlan, part: int):
        """Coalesced stream chunks. With ``prefetch_depth`` > 0 a bounded
        producer thread reads and decodes chunk k+1 while the device computes
        chunk k, encodes it, and on CUDA issues its host-to-device copies on
        a side stream from pinned memory, recording an event the consumer
        waits on (``_await_prefetched``). The current stream is per thread:
        copies issued on the producer's default stream would queue behind the
        compute and overlap nothing. Only those copies leave the engine
        thread: a source whose own stream would run device stages (a
        coalesce of partial aggregates, say) is read on the engine thread,
        unprefetched. Closing the consumer stops the producer and closes the
        source stream."""
        chunks = self._coalesce_chunks(self._stream(source, part))
        depth = self._prefetch_depth()
        if depth <= 0 or any(_supported(n) for n in P.walk_physical(source)):
            return chunks
        from ballista_tpu_torch.utils.prefetch import prefetch_iter

        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)

        def stage(chunk: ColumnBatch) -> ColumnBatch:
            try:
                enc = KT.encode_host_batch(chunk)
                if self._copy_stream is None:
                    enc._pre_dev = ([KT.host_to_device(a, self.device) for a in enc.arrays], None)
                else:
                    with torch.cuda.device(self.device), torch.cuda.stream(self._copy_stream):
                        tensors = [KT.host_to_device(a, self.device) for a in enc.arrays]
                        done = torch.cuda.Event()
                        done.record(self._copy_stream)
                    enc._pre_dev = (tensors, done)
                self._metric("op.PrefetchH2D.bytes", float(sum(a.nbytes for a in enc.arrays)))
            except Exception:  # noqa: BLE001 - counted: the consumer encodes inline
                log.warning("chunk pre-encode failed; encoding inline", exc_info=True)
                self._metric("op.PrefetchEncode.failed", 1.0)
                return chunk
            chunk._pre_enc = enc
            self._metric("op.PrefetchEncode.count", 1.0)
            return chunk

        return prefetch_iter(chunks, depth, transform=stage)

    def _stream_device_chunks(self, plan: P.PhysicalPlan, part: int):
        source = self._chunk_source(plan)
        for chunk in self._pipelined_chunks(source, part):
            self._metric("op.StreamChunk.count", 1.0)
            yield self._exec_spliced(plan, source, chunk, part)

    def _stream_device_final_agg(self, plan: P.HashAggregateExec, part: int):
        """Per chunk, one device stage runs the chunk-wise chain below the
        aggregate (filters, projects, probe joins) and a merge-mode fold of
        its partial states; only the fold of state with state, bounded by
        the distinct-group count, runs on the host between chunks. When that
        state outgrows ``ballista.agg.spill_state_rows``, chunk states spill
        to salted hash buckets on disk and each bucket merges and finalizes
        alone: groups never straddle buckets, so resident memory is one
        bucket."""
        from ballista_tpu_torch.engine.spill import PartitionSpill

        below = plan.input
        source = self._chunk_source(below) if self._chunkwise_device(below) else below
        merge_node = P.HashAggregateExec(
            input=below, mode="merge", group_exprs=plan.group_exprs,
            agg_exprs=plan.agg_exprs, input_schema_for_aggs=plan.input_schema_for_aggs,
        )
        self._tiny_keepalive.append(merge_node)
        budget = self._agg_spill_rows()
        state: Optional[ColumnBatch] = None
        spill: Optional[PartitionSpill] = None
        for chunk in self._pipelined_chunks(source, part):
            self._metric("op.StreamChunk.count", 1.0)
            chunk_state = self._exec_spliced(merge_node, source, chunk, part)
            if spill is not None:
                spill.append_split(chunk_state)
                continue
            state = chunk_state if state is None else KNP.merge_partial_states(
                ColumnBatch.concat([state, chunk_state]), plan.group_exprs, plan.agg_exprs)
            if budget and plan.group_exprs and state.num_rows > budget:
                spill = PartitionSpill(
                    self.AGG_SPILL_BUCKETS, list(plan.group_exprs), self._spill_dir(),
                    salted=True, compression=self._shuffle_codec(),
                )
                spill.append_split(state)
                state = None
        if spill is None:
            if state is None:
                state = ColumnBatch.empty(below.schema())
            yield self._exec_spliced(plan, below, state, part)
            return
        spill.finish()
        self._metric("op.AggSpill.rows", float(spill.spilled_rows))
        try:
            for b in range(spill.n):
                bstate: Optional[ColumnBatch] = None
                for chunk in spill.read_chunks(b):
                    bstate = chunk if bstate is None else KNP.merge_partial_states(
                        ColumnBatch.concat([bstate, chunk]), plan.group_exprs, plan.agg_exprs)
                if bstate is not None and bstate.num_rows:
                    yield self._exec_spliced(plan, below, bstate, part)
        finally:
            spill.close()

    # ---- warm runs for precompile hints (compile_service) ---------------------------
    def precompile_stage_template(
        self, writer_plan, chunk_buckets: list[int], state_buckets: list[int],
        submit=None,
    ) -> tuple[int, Optional[str]]:
        """Warm the stage programs a downstream stage TEMPLATE (shuffle
        leaves still unresolved) will run, from synthetic bucket-shaped
        inputs, recording them under their shape keys: called by the compile
        service while the upstream stage is still executing.

        Mirrors the streaming task path's program construction exactly
        (``_stream_device_final_agg`` / ``_stream_device_chunks``), as the
        JAX engine's method of the same name does, spec for spec: streamed
        chunks are spliced into the plan as MemoryScan leaves, so the spliced
        fingerprints here match what ``_run_stage`` computes at run time.
        Returns ``(programs warmed or submitted, skip_reason)``; stages whose
        programs bake data content into the run (per-batch string
        dictionaries, join build sides, non-streamable shapes) are skipped,
        never guessed."""
        inner = writer_plan.input if isinstance(writer_plan, P.ShuffleWriterExec) else writer_plan
        shuffle_leaves = (P.UnresolvedShuffleExec, P.ShuffleReaderExec)
        specs: list[tuple[P.PhysicalPlan, P.PhysicalPlan, object, int]] = []

        def no_joins(top, stop) -> bool:
            # a probe-join chain needs its collected build side, and the
            # build input does not exist before the upstream stage runs
            node = top
            while node is not stop:
                if isinstance(node, (P.HashJoinExec, P.CrossJoinExec)):
                    return False
                node = node.input
            return True

        def mirror(top) -> Optional[str]:
            """Mirror ``_stream_maker``'s program construction for one
            streamed subtree: chunk-wise chains splice their source with a
            chunk scan; a final aggregate below them contributes its merge
            and finalize programs and feeds the chain its OUTPUT chunks."""
            src = (self._chunk_source(top)
                   if self._chunkwise_device(top) and self._chunk_source(top) is not top
                   else top)
            if not no_joins(top, src):
                return "join build side unavailable before the stage runs"
            if isinstance(src, shuffle_leaves):
                if top is src:
                    return "stage shape is not streamable"
                for b in chunk_buckets:
                    specs.append((top, src, src.schema(), b))
                return None
            if isinstance(src, P.HashAggregateExec) and src.mode == "final" and _supported(src):
                below = src.input
                agg_src = self._chunk_source(below) if self._chunkwise_device(below) else below
                if not isinstance(agg_src, shuffle_leaves):
                    return "source is not a shuffle read"
                if not no_joins(below, agg_src):
                    return "join build side unavailable before the stage runs"
                merge_node = P.HashAggregateExec(
                    input=below, mode="merge", group_exprs=src.group_exprs,
                    agg_exprs=src.agg_exprs, input_schema_for_aggs=src.input_schema_for_aggs,
                )
                self._tiny_keepalive.append(merge_node)
                for b in chunk_buckets:
                    specs.append((merge_node, agg_src, agg_src.schema(), b))
                for b in state_buckets:
                    specs.append((src, below, below.schema(), b))
                if top is not src:
                    # the chain above consumes the aggregate's finalized
                    # chunks: group-count-sized, so the state buckets apply
                    for b in state_buckets:
                        specs.append((top, src, src.schema(), b))
                return None
            return "stage shape is not streamable"

        # host fold-op roots (top-k sort, local limit, coalesce) just consume
        # their input's chunk stream (``_stream_maker``): the device programs
        # the stage needs belong to the subtree below them
        while True:
            if isinstance(inner, P.SortExec) and inner.fetch is not None:
                inner = inner.input
            elif isinstance(inner, P.LimitExec) and not inner.global_ and inner.n >= 0:
                inner = inner.input
            elif isinstance(inner, P.CoalescePartitionsExec):
                inner = inner.input
            else:
                break

        reason = mirror(inner)
        if reason is not None:
            return 0, reason
        # smallest buckets first: what tiny stages and short partitions hit,
        # and the cheapest warms
        specs.sort(key=lambda s: s[3])
        if submit is not None:
            for top, source, schema, bucket in specs:
                submit(self._precompile_one, top, source, schema, bucket)
            return len(specs), None
        return sum(self._precompile_one(*spec) for spec in specs), None

    def _precompile_one(self, top, source, schema, bucket: int) -> bool:
        # shared-dictionary string columns are hintable: the shuffle leaf's
        # dict_refs name registered dictionaries (per-batch-dictionary
        # strings stay Unhintable)
        import ballista_tpu_torch.ops.grouped_sums as GS

        with GS.warming():
            batch = CS.synthetic_batch(schema, bucket, getattr(source, "dict_refs", None))
            spliced = self._splice(top, source, self._scan_at(batch, 0))
            return self._precompile_spliced(spliced)

    def _precompile_spliced(self, plan: P.PhysicalPlan, part: int = 0) -> bool:
        """One warm run of a (synthetic) spliced stage program: its device
        program runs once on the engine's device, synchronised, alone in the
        device window, and the result is dropped; its shape key is recorded
        with the run's wall (False: the key was warmed already). The
        synthetic scan is ephemeral, so nothing enters the leaf caches.
        Declined (``Unhintable``) when the estimate does not fit what the
        device budget leaves free, or when the device path declines the
        program."""
        if not _supported(plan):
            raise CS.Unhintable("stage subtree is not device-supported")
        leaves = self._collect_leaves(plan, part)
        svc = CS.get_service()

        def warm():
            budget = self._hbm_budget()
            if budget > 0:
                est = MM.estimate_eager_program_bytes(plan, leaves)
                used = torch.cuda.memory_allocated(self.device) if self.device.type == "cuda" else 0
                if used + est > budget:
                    raise CS.Unhintable(f"over budget: {est} bytes estimated, {used} of "
                                        f"{budget} in use")
            tensors = self._device_args(leaves, part)
            stage_fn, _holder = _make_stage_fn(plan, _stage_layout(leaves))
            on_card = self.device.type == "cuda"
            with CS.WINDOW.warm():
                reserved = torch.cuda.memory_reserved(self.device) if on_card else 0
                t0 = time.time()
                try:
                    stage_fn(*tensors)
                    self._sync()
                except (_HostFallback, KT.DeviceUnsupported) as e:
                    raise CS.Unhintable(f"the device path declines the program: {e}") from e
                dt = time.time() - t0
            svc.note_warm(dt, reserved, torch.cuda.memory_reserved(self.device) if on_card else 0)
            return CS.StageEntry(dt * 1000.0, "hint")

        return svc.cache.record(self._warm_key(plan, leaves), warm) is not None


def _shape_key(leaves: dict) -> tuple:
    """The stage's leaves by layout (``compile_service.shape_signature``),
    with each build leaf's key count and duplicate bucket. A numeric
    column's decimal scale is kept only as scaled or not: the scale is
    sniffed from the values, which a synthetic batch cannot know, and in an
    eager program it changes constants, not the kernels launched."""
    def layout(enc) -> tuple:
        return tuple(c[:3] + (c[3] is not None,) + c[4:]
                     if isinstance(c, tuple) and len(c) == 5 and c[2] is None else c
                     for c in CS.shape_signature(enc))

    return tuple((kind, layout(enc), None if extra is None else (tuple(extra[0].shape), extra[1]))
                 for kind, enc, extra, _key, _node in leaves.values())


def _leaf_cache_key(node: P.PhysicalPlan, part: int) -> Optional[tuple]:
    """The content key of a scan leaf's encoding, or None (not cacheable):
    an in-memory partition by its batch id, a parquet partition by its files
    with their sizes and modification times (a table rewritten in place
    misses), the projection, the pushed filters and the shared dictionaries.
    Carries the dtype policy: the encoding differs under it (scaled int64 vs
    f64)."""
    if isinstance(node, P.MemoryScanExec):
        if not node.partitions or node.ephemeral:
            return None  # single-use data: never cache
        src = node.partitions[min(part, len(node.partitions) - 1)]
        return ("mem", src.uid, tuple(node.projection or ()), KT.NATIVE_DTYPES)
    if isinstance(node, P.ParquetScanExec):
        files = tuple(node.file_groups[part]) if node.file_groups else ()
        try:
            stamps = tuple((os.stat(f).st_size, os.stat(f).st_mtime_ns) for f in files)
        except OSError:
            return None
        # the shared dictionaries the scan's string columns carry: a table
        # registered again mints new ids, even over the same files
        dicts = tuple(sorted((node.dict_refs or {}).items()))
        return ("pq", files, stamps, tuple(node.projection or ()),
                tuple(repr(f) for f in node.filters), dicts, KT.NATIVE_DTYPES)
    return None


def _fusable_partitioned_join(node: P.PhysicalPlan) -> bool:
    """A partitioned join over two exchanges: it may run as one fused
    program, both sides exchanged on the join keys."""
    return (
        isinstance(node, P.HashJoinExec)
        and _supported(node)
        and not node.collect_build
        and isinstance(node.left, P.RepartitionExec)
        and isinstance(node.right, P.RepartitionExec)
    )


# operators whose partition p reads only partition p of each child: a
# collective under them still runs across the mesh group. A union is not
# one: its partition p reads partition p - offset of one child, whose
# collective slice another member may hold
_PARTITION_WISE = (P.ShuffleWriterExec, P.FilterExec, P.ProjectExec, P.HashAggregateExec,
                   P.SortExec, P.HashJoinExec)


def gang_collectives(root: P.PhysicalPlan) -> list:
    """The nodes of a gang-scheduled stage that run as one program across
    its mesh group: final aggregates over a hash exchange of a
    device-expressible partial aggregate, and partitioned inner, left, semi
    and anti joins over two exchanges, each reached from the stage's root
    through operators that read their children partition by partition (a
    member computes only its partitions, and a collective leaves its slice
    in one partition). Below an operator that reads other partitions than
    its own (an exchange no collective consumes, a collected build side, a
    cross join, a limit, a union) the subtree runs in each member alone, as
    in an executor outside a group. The scheduler gangs a stage only when this
    finds a collective, and the engine runs exactly these across the group."""
    found: list = []

    def walk(node: P.PhysicalPlan) -> None:
        if (isinstance(node, P.HashAggregateExec) and node.mode == "final"
                and type(node.input) is P.RepartitionExec
                and isinstance(node.input.input, P.HashAggregateExec)
                and node.input.input.mode == "partial" and _supported(node.input.input)):
            found.append(node)
            walk(node.input.input.input)
        elif (_fusable_partitioned_join(node) and node.how in ("inner", "left", "semi", "anti")
              and node.on and type(node.left) is P.RepartitionExec
              and type(node.right) is P.RepartitionExec):
            found.append(node)
            walk(node.left.input)
            walk(node.right.input)
        elif isinstance(node, P.HashJoinExec) and node.collect_build:
            walk(node.left)
        elif isinstance(node, _PARTITION_WISE):
            for c in node.children():
                walk(c)

    walk(root)
    return found


def _scan_of(batch: ColumnBatch) -> P.MemoryScanExec:
    """A one-partition scan of single-use data (a paged join's bucket), kept
    out of the content-keyed leaf caches."""
    return P.MemoryScanExec([batch], batch.schema, ephemeral=True)


def _prep_build(build: ColumnBatch, node: P.HashJoinExec, dup_cap: int):
    """(encoding, sorted int64 key hashes, duplicate bucket, id of the sorted
    batch: the device cache's key for its copy) of a build side:
    rows with a NULL key dropped (kept after the keyed rows for right and
    full joins), the rest ordered by ``kernels_np.combined_key``, whose bits
    the device's probe hash reproduces. Raises _HostFallback when a key's
    run of rows exceeds ``dup_cap``."""
    if node.on:
        bkey, keep = KNP.combined_key([evaluate(r, build) for _, r in node.on])
    else:
        bkey = np.zeros(build.num_rows, np.int64)
        keep = np.ones(build.num_rows, bool)
    idx = np.nonzero(keep)[0]
    bk = bkey[idx]
    _, counts = np.unique(bk, return_counts=True)
    max_dup = int(counts.max()) if len(counts) else 1
    if max_dup > dup_cap:
        raise _HostFallback(f"build key run of {max_dup} rows, past the cap {dup_cap}")
    order = np.argsort(bk, kind="stable")
    if node.how in ("right", "full"):
        # outer-emitting joins keep NULL-key build rows too (after the keyed
        # prefix, so searchsorted over bk never matches them): they are
        # unmatched by definition and are emitted once
        build_sorted = build.take(np.concatenate([idx[order], np.nonzero(~keep)[0]]))
    else:
        build_sorted = build.take(idx[order])
    enc = KT.encode_host_batch(build_sorted)
    # a power-of-two bucket, as the JAX package rounds it for its compile cache
    dup = 1 if max_dup == 1 else KT.bucket_size(max_dup, minimum=2)
    return enc, bk[order], dup, build_sorted.uid


def _stage_layout(leaves: dict) -> dict:
    """{leaf node id: (start, end, kind, EncodedBatch, duplicate bucket)}
    over the flat tensor list; a build leaf's last tensor is its sorted
    keys."""
    slices = {}
    pos = 0
    for node_id, (kind, enc, extra, _key, _node) in leaves.items():
        count = len(enc.arrays) + (0 if extra is None else 1)
        slices[node_id] = (pos, pos + count, kind, enc, None if extra is None else extra[1])
        pos += count
    return slices


def _make_stage_fn(plan: P.PhysicalPlan, slices: dict):
    """The whole-stage function over the flat tensor layout, plus the holder
    its call fills with the output's static metadata. Its environment maps a
    leaf node's id to (kind, DeviceBatch, (sorted build keys, duplicate
    bucket) or None)."""
    holder: dict = {}

    def stage_fn(*args):
        env = {}
        for node_id, (s, e, kind, enc, max_dup) in slices.items():
            chunk = list(args[s:e])
            if kind == "build":
                env[node_id] = (kind, KT.device_batch_from_encoded(enc, chunk[:-1]),
                                (chunk[-1], max_dup))
            else:
                env[node_id] = (kind, KT.device_batch_from_encoded(enc, chunk), None)
        out_db = _trace_node(plan, env)
        arrays, meta = KT.flatten_device_batch(out_db)
        holder["meta"] = meta
        return tuple(arrays)

    return stage_fn, holder


def _supported(plan: P.PhysicalPlan) -> bool:
    if isinstance(plan, P.FilterExec):
        return _expr_ok(plan.predicate)
    if isinstance(plan, P.ProjectExec):
        return all(_expr_ok(e) for e in plan.exprs)
    if isinstance(plan, P.HashAggregateExec):
        for e in plan.group_exprs:
            if not _expr_ok(e):
                return False
        for e in plan.agg_exprs:
            a = unalias(e)
            if a.fn not in ("sum", "avg", "min", "max", "count", "count_star"):
                return False
            if a.expr is not None and not _expr_ok(a.expr):
                return False
        return True
    if isinstance(plan, P.HashJoinExec):
        if plan.how not in ("inner", "left", "semi", "anti", "right", "full"):
            return False
        if plan.filter is not None and not _expr_ok(plan.filter):
            return False
        return all(_expr_ok(l) and _expr_ok(r) for l, r in plan.on)
    if isinstance(plan, P.CrossJoinExec):
        return True
    if isinstance(plan, P.SortExec):
        return all(_expr_ok(e) for e, _ in plan.keys)
    if isinstance(plan, P.WindowExec):
        in_schema = plan.input.schema()
        for e in plan.window_exprs:
            w = unalias(e)
            if not isinstance(w, WindowFunc):
                return False
            if w.fn not in ("row_number", "rank", "dense_rank",
                            "sum", "avg", "min", "max", "count"):
                return False
            if not all(_expr_ok(s) for s in
                       list(w.args) + list(w.partition_by) + [o for o, _ in w.order_by]):
                return False
            if w.args and w.args[0].data_type(in_schema) is DataType.STRING:
                return False  # string window aggregates stay on the host
            if (w.frame is not None and w.frame.units == "range"
                    and {w.frame.start[0], w.frame.end[0]} & {PRECEDING, FOLLOWING}):
                # value offsets need the single numeric order key (the
                # planner enforces it for SQL; guards programmatic plans)
                if len(w.order_by) != 1 or \
                        w.order_by[0][0].data_type(in_schema) is DataType.STRING:
                    return False
        return True
    return False


def _expr_ok(e: Expr) -> bool:
    """Can this expression evaluate on the device (strings only as
    dictionary ops)?"""
    for n in walk(e):
        if isinstance(n, (Col, Lit, BinaryOp, Not, IsNull, Case, Cast, Like, InList, Alias)):
            continue
        if isinstance(n, Func) and n.fn in KT.DEVICE_FUNCS:
            continue
        if isinstance(n, Agg):
            continue  # checked by the aggregate support path
        return False
    return True


# ---- tracing (module-level: the stage function must not retain an engine) ---------
def _trace_node(plan: P.PhysicalPlan, env: dict):
    if id(plan) in env:
        kind, db, _extra = env[id(plan)]
        # "out" is the node's output; "build" and "cross" entries hold a
        # join's right input, and the join itself still traces
        if kind == "out":
            return db

    if isinstance(plan, P.FilterExec):
        db = _trace_node(plan.input, env)
        vals, null = KT.eval_dev_predicate(plan.predicate, db)
        keep = vals if null is None else (vals & ~null)
        return KT.DeviceBatch(db.schema, db.cols, db.row_valid & keep, db.n_rows)

    if isinstance(plan, P.ProjectExec):
        db = _trace_node(plan.input, env)
        schema = plan.schema()
        cols = [
            _coerce_dev(KT.eval_dev(e, db), f.dtype) for e, f in zip(plan.exprs, schema)
        ]
        return KT.DeviceBatch(schema, cols, db.row_valid, db.n_rows)

    if isinstance(plan, P.HashAggregateExec):
        return _trace_agg(plan, env)

    if isinstance(plan, P.HashJoinExec):
        return _trace_join(plan, env)

    if isinstance(plan, P.CrossJoinExec):
        return _trace_cross(plan, env)

    if isinstance(plan, P.SortExec):
        db = _trace_node(plan.input, env)
        key_specs = [(KT.eval_dev(e, db), asc) for e, asc in plan.keys]
        return KT.sort_device(db, key_specs, plan.fetch)

    if isinstance(plan, P.WindowExec):
        return KT.window_device(_trace_node(plan.input, env), plan.window_exprs, plan.schema())

    raise ExecutionError(f"cannot trace {type(plan).__name__}")


def _trace_agg(plan: P.HashAggregateExec, env: dict):
    """An aggregate in two phases: every aggregate's arguments are evaluated
    (and ``presum_safe`` run) in plan order while its sums and counts are
    registered with one ``SegSums``, which computes them all at once; then
    each aggregate builds its output columns from the results."""
    db = _trace_node(plan.input, env)
    out_schema = plan.schema()
    key_cols = [KT.eval_dev(g, db) for g in plan.group_exprs]

    reps = per_key = None
    if not key_cols:
        ids = (~db.row_valid).to(torch.int64)  # valid rows 0, the rest 1
        k = 1
    else:
        kind, info = KT.group_plan(key_cols, db.n_pad)
        if kind == "direct":
            per_key = info
            ids, k = KT.group_ids_direct(db, key_cols, per_key)
        else:
            # bounded-k sorted segmentation: k < n_pad whenever dictionary
            # sizes or encoded int ranges bound the key cardinality
            k = info
            ids, reps = KT.group_ids_sorted(db, key_cols, k)

    sums = KT.SegSums(ids, k, db.row_valid)
    seen_at = sums.count(None)
    builds = [_trace_agg_cols(plan.mode, unalias(e), e.name(), db, sums)
              for e in plan.agg_exprs]
    res = sums.compute()

    out_cols: list = []
    if reps is not None:
        safe = torch.clamp(reps, 0, db.n_pad - 1)
        for c in key_cols:
            if c.null is None:
                out_cols.append(replace(c, data=c.data[safe], null=None))
                continue
            # data under NULL zeroed (join gathers leave garbage there), so
            # later hashing buckets nulls alike on every device
            null = c.null[safe]
            data = torch.where(null, torch.zeros((), dtype=c.data.dtype, device=c.data.device),
                               c.data[safe])
            out_cols.append(replace(c, data=data, null=null))
    elif key_cols:
        out_cols.extend(KT.decode_group_keys(key_cols, per_key, k))
    for build in builds:
        out_cols.extend(build(res))

    pad = KT.bucket_size(k)
    padded = [
        replace(
            c,
            data=_pad_dev(c.data, pad),
            null=_pad_dev(c.null, pad) if c.null is not None else None,
        )
        for c in out_cols
    ]
    if key_cols:
        row_valid = _pad_dev(res[seen_at] > 0, pad)
    else:
        # a global aggregate over zero rows still emits its single row (SQL)
        row_valid = torch.arange(pad, device=db.device) < 1
    return KT.DeviceBatch(out_schema, padded, row_valid, k)


def _trace_agg_cols(mode, a: Agg, name, db, sums):
    """Phase one of one aggregate: evaluates its argument, registers its
    sums and counts with ``sums``, and returns ``build(res)``, which makes
    its output columns from ``sums.compute()``'s results."""
    rv = db.row_valid

    def arg_col():
        c = KT.eval_dev(a.expr, db)
        if c.is_string:
            raise _HostFallback()
        return c

    def seg_sum_col(c):
        """Segment sum preserving the scaled-int64 representation: scaled
        inputs sum EXACTLY in int64 (presum_safe proves headroom or falls
        back), unscaled inputs keep their own width. The output inherits the
        subset-sum bound, so re-summing states stays provably safe. Returns
        ``make(res, label, null_mark)`` for the column."""
        cc = KT.presum_safe(c, db.n_pad)
        at = sums.sum(cc.data, cc.null)
        rng = KT.sum_range(cc, db.n_pad)
        bound = KT._sum_bound(cc, db.n_pad) if cc.scale is not None else None

        def make(res, label, null_mark=None):
            return KT.DeviceCol(label, res[at], null_mark, range=rng, scale=cc.scale,
                                ssum=bound)

        return make

    def avg_div(scol, cnt, null_mark):
        """Final AVG division: scaled sums divide EXACTLY in int64 and stay a
        scaled decimal; unscaled sums keep their float width."""
        if scol.scale is not None:
            data, out_scale, mul = KT.avg_scaled(scol.data, cnt, scol.scale, KT._eb(scol))
            rng = None
            rp = KT._range_pair(scol)
            if rp is not None:
                rng = KT.bucket_range(rp[0] * mul, rp[1] * mul)
            return KT.DeviceCol(DataType.FLOAT64, data, null_mark,
                                range=rng, scale=out_scale)
        return KT.DeviceCol(DataType.FLOAT64, scol.data / torch.clamp(cnt, min=1), null_mark)

    def sum_of(c):
        cnt = sums.count(c.null)
        s = seg_sum_col(c)
        dtype = _sum_dtype(c.dtype)
        return lambda res: [s(res, dtype, res[cnt] == 0)]

    def min_max_of(c):
        m = KT.seg_min(c.data, sums.ids, sums.k, rv, c.null, a.fn == "min")
        cnt = sums.count(c.null)
        return lambda res: [KT.DeviceCol(_sum_dtype(c.dtype), m, res[cnt] == 0,
                                         range=c.range, scale=c.scale)]

    if mode in ("single", "partial"):
        if a.fn == "count_star":
            cnt = sums.count(None)
            return lambda res: [KT.DeviceCol(DataType.INT64, res[cnt])]
        if a.fn == "count":
            cnt = sums.count(KT.eval_dev(a.expr, db).null)
            return lambda res: [KT.DeviceCol(DataType.INT64, res[cnt])]
        c = arg_col()
        if a.fn == "sum":
            return sum_of(c)
        if a.fn == "avg":
            cnt = sums.count(c.null)
            if c.scale is None and not c.dtype.is_floating:
                # int argument: exact scale-0 sums under the native policy,
                # f64 sums otherwise
                sc = KT.as_scaled(c) if KT.NATIVE_DTYPES else None
                c = sc if sc is not None else replace(c, data=c.data.to(torch.float64))
            s = seg_sum_col(c)
            if mode == "partial":
                return lambda res: [s(res, DataType.FLOAT64),
                                    KT.DeviceCol(DataType.INT64, res[cnt])]
            return lambda res: [avg_div(s(res, DataType.FLOAT64), res[cnt], res[cnt] == 0)]
        if a.fn in ("min", "max"):
            return min_max_of(c)
        raise ExecutionError(a.fn)

    if mode == "merge":
        # partial-layout states in, partial-layout states out: the streamed
        # final aggregate's fold step (associative, so chunks fold in any
        # order; the final step runs once at the end)
        if a.fn in ("count", "count_star"):
            st = db.col(f"{name}#count")
            cnt = sums.count(st.null)
            at = sums.sum(st.data, st.null)
            return lambda res: [KT.DeviceCol(DataType.INT64, res[at], res[cnt] == 0)]
        if a.fn == "avg":
            s = db.col(f"{name}#sum")
            cn = db.col(f"{name}#count")
            ssum = seg_sum_col(s)
            scnt = sums.sum(cn.data, cn.null)
            return lambda res: [ssum(res, DataType.FLOAT64), KT.DeviceCol(DataType.INT64, res[scnt])]
        st = db.col(f"{name}#{a.fn}")
        if st.is_string:
            raise _HostFallback()
        if a.fn == "sum":
            cnt = sums.count(st.null)
            ssum = seg_sum_col(st)
            return lambda res: [ssum(res, st.dtype, res[cnt] == 0)]
        if a.fn in ("min", "max"):
            m = KT.seg_min(st.data, sums.ids, sums.k, rv, st.null, a.fn == "min")
            cnt = sums.count(st.null)
            return lambda res: [KT.DeviceCol(st.dtype, m, res[cnt] == 0,
                                             range=st.range, scale=st.scale)]
        raise ExecutionError(a.fn)

    # final: merge partial states located by name
    if a.fn in ("count", "count_star"):
        st = db.col(f"{name}#count")
        at = sums.sum(st.data, st.null)
        return lambda res: [KT.DeviceCol(DataType.INT64, res[at])]
    if a.fn == "avg":
        s = db.col(f"{name}#sum")
        cn = db.col(f"{name}#count")
        ssum = seg_sum_col(s)
        scnt = sums.sum(cn.data, cn.null)
        return lambda res: [avg_div(ssum(res, DataType.FLOAT64), res[scnt], res[scnt] == 0)]
    st = db.col(f"{name}#{a.fn}")
    if st.is_string:
        raise _HostFallback()
    if a.fn == "sum":
        return sum_of(st)
    if a.fn in ("min", "max"):
        return min_max_of(st)
    raise ExecutionError(a.fn)


# ---- joins -----------------------------------------------------------------------------
def _trace_join(plan: P.HashJoinExec, env: dict):
    probe = _trace_node(plan.left, env)
    _kind, build_dev, (bk_sorted, max_dup) = env[id(plan)]
    return _probe_join(plan, probe, build_dev, bk_sorted, max_dup)


def _probe_join(plan: P.HashJoinExec, probe, build_dev, bk_sorted, max_dup: int):
    """The join of the traced probe side against the prepared build side:
    probe keys hash (splitmix64 over ``_canonical_dev``, the bits
    ``kernels_np.combined_key`` gave the build), ``searchsorted`` finds each
    key's run in the sorted build keys, and build columns gather from it."""
    m = int(bk_sorted.shape[0])
    dev = probe.device
    pk = torch.zeros(probe.n_pad, dtype=torch.int64, device=dev)
    pnull = torch.zeros(probe.n_pad, dtype=torch.bool, device=dev)
    for l, _ in plan.on:
        c = KT.eval_dev(l, probe)
        pk = KT.splitmix64_dev(pk ^ KT._canonical_dev(c))
        if c.null is not None:
            pnull = pnull | c.null

    if m == 0:
        found = torch.zeros(probe.n_pad, dtype=torch.bool, device=dev)
        pos = torch.zeros(probe.n_pad, dtype=torch.int64, device=dev)
    else:
        pos = torch.clamp(torch.searchsorted(bk_sorted, pk), 0, m - 1)
        found = (bk_sorted[pos] == pk) & ~pnull & probe.row_valid

    if max_dup > 1:
        if plan.how in ("semi", "anti"):
            # existence over the key's run of up to max_dup candidates,
            # OR-ing filter matches (q21's EXISTS / NOT EXISTS self-joins)
            any_match = torch.zeros(probe.n_pad, dtype=torch.bool, device=dev)
            base_ok = ~pnull & probe.row_valid
            for j in range(max_dup):
                idx = torch.clamp(pos + j, 0, m - 1)
                cand_ok = ((pos + j) < m) & (bk_sorted[idx] == pk) & base_ok
                if plan.filter is not None:
                    g = _gather_build_cols(build_dev, idx, cand_ok)
                    cand_ok = cand_ok & _pair_filter(plan, probe, build_dev, probe.cols + g,
                                                     probe.row_valid, probe.n_rows)
                any_match = any_match | cand_ok
            return _semi_anti(plan, probe, any_match)
        return _trace_join_expand(plan, probe, build_dev, bk_sorted, pk, pnull, pos, max_dup)

    gathered = _gather_build_cols(build_dev, pos, found)
    if plan.filter is not None and plan.on:
        found = found & _pair_filter(plan, probe, build_dev, probe.cols + gathered,
                                     probe.row_valid, probe.n_rows)
        # a match the filter rejects leaves its probe row unmatched: NULL
        # build columns in left and full joins (the JAX engine keeps the
        # rejected row's values there, against its own host kernels)
        gathered = [replace(g, null=g.null | ~found) for g in gathered]

    if plan.how in ("semi", "anti"):
        return _semi_anti(plan, probe, found)
    if plan.how in ("right", "full"):
        matched = torch.zeros(build_dev.n_pad, dtype=torch.int32, device=dev)
        if m:
            matched = matched.scatter_reduce(0, pos, found.to(torch.int32), "amax",
                                             include_self=True)
        sec1_valid = found if plan.how == "right" else probe.row_valid
        return _assemble_outer(plan, probe.cols, sec1_valid, gathered, build_dev, matched > 0)
    if plan.how == "inner":
        return KT.DeviceBatch(plan.schema(), probe.cols + gathered,
                              probe.row_valid & found, probe.n_rows)
    # left join: unmatched probe rows keep nulls on the build side
    return KT.DeviceBatch(plan.schema(), probe.cols + gathered, probe.row_valid, probe.n_rows)


def _semi_anti(plan, probe, found):
    keep = found if plan.how == "semi" else ~found
    return KT.DeviceBatch(plan.schema(), probe.cols, probe.row_valid & keep, probe.n_rows)


def _pair_filter(plan, probe, build_dev, cols, row_valid, n_rows):
    """The join filter over ``cols``, (probe row, gathered build row)
    pairs; NULL is false."""
    pair = KT.DeviceBatch(probe.schema.join(build_dev.schema), cols, row_valid, n_rows)
    fv, fn_ = KT.eval_dev_predicate(plan.filter, pair)
    return fv if fn_ is None else (fv & ~fn_)


def _trace_join_expand(plan, probe, build_dev, bk_sorted, pk, pnull, pos, max_dup):
    """Bounded-duplicate emit join (inner, left, right, full): every probe
    row fans out into a ``max_dup``-wide slot group; slot j holds the j-th
    build row of the probe key's run, unmatched slots are masked invalid.
    The output pad is probe.n_pad * max_dup (both powers of two)."""
    n_pad = probe.n_pad
    D = max_dup
    if n_pad * D > MAX_EXPAND_ROWS:
        raise _HostFallback(f"expanded probe of {n_pad} x {D} rows")
    m = int(bk_sorted.shape[0])
    out_pad = n_pad * D
    dev = probe.device

    base_ok = ~pnull & probe.row_valid
    pos_mat = pos[:, None] + torch.arange(D, device=dev)  # (n_pad, D)
    safe = torch.clamp(pos_mat, 0, m - 1)
    match = (pos_mat < m) & (bk_sorted[safe] == pk[:, None]) & base_ok[:, None]
    flat_idx = safe.reshape(out_pad)
    flat_match = match.reshape(out_pad)

    probe_cols = [
        replace(
            c,
            data=c.data.repeat_interleave(D),
            null=c.null.repeat_interleave(D) if c.null is not None else None,
            ssum=None,  # D-way fan-out invalidates the subset-sum bound
        )
        for c in probe.cols
    ]
    gathered = _gather_build_cols(build_dev, flat_idx, flat_match)

    if plan.filter is not None:
        flat_match = flat_match & _pair_filter(plan, probe, build_dev, probe_cols + gathered,
                                               flat_match, out_pad)

    if plan.how == "inner":
        return KT.DeviceBatch(plan.schema(), probe_cols + gathered, flat_match, out_pad)

    def matched_build():
        return torch.zeros(build_dev.n_pad, dtype=torch.int32, device=dev).scatter_reduce(
            0, flat_idx, flat_match.to(torch.int32), "amax", include_self=True) > 0

    if plan.how == "right":
        return _assemble_outer(plan, probe_cols, flat_match, gathered, build_dev,
                               matched_build())

    # left/full: matched slots + one null-padded slot-0 row for match-less rows
    any_match = flat_match.reshape(n_pad, D).any(dim=1)
    slot0 = (torch.arange(out_pad, device=dev) % D) == 0
    pv = probe.row_valid.repeat_interleave(D)
    row_valid = flat_match | (slot0 & pv & ~any_match.repeat_interleave(D))
    build_cols = [
        replace(c, null=(c.null if c.null is not None
                         else torch.zeros(out_pad, dtype=torch.bool, device=dev)) | ~flat_match)
        for c in gathered
    ]
    if plan.how == "full":
        return _assemble_outer(plan, probe_cols, row_valid, build_cols, build_dev,
                               matched_build())
    return KT.DeviceBatch(plan.schema(), probe_cols + build_cols, row_valid, out_pad)


def _assemble_outer(plan, probe_cols, sec1_valid, gathered, build_dev, matched):
    """Right and full outer emission: a probe-major matched section, then
    the unmatched build rows (null probe side). Build sides of right and full
    joins are hash-partitioned on the join keys (never broadcast), so a
    build row's matches all live in this partition and emitting the
    unmatched rows per partition emits each exactly once."""
    n1 = int(sec1_valid.shape[0])
    n2 = build_dev.n_pad
    out_pad = KT.bucket_size(n1 + n2)
    dev = sec1_valid.device
    sec2_valid = build_dev.row_valid & ~matched

    def falses(n):
        return torch.zeros(n, dtype=torch.bool, device=dev)

    cols = []
    for c in probe_cols:  # probe side: data in section 1, nulls in section 2
        data = torch.cat([c.data, torch.zeros(n2, dtype=c.data.dtype, device=dev)])
        null1 = c.null if c.null is not None else falses(n1)
        null = torch.cat([null1, torch.ones(n2, dtype=torch.bool, device=dev)])
        cols.append(replace(c, data=_pad_dev(data, out_pad), null=_pad_dev(null, out_pad)))
    for g, b in zip(gathered, build_dev.cols):  # build side: matches, then rows
        data = torch.cat([g.data, b.data])
        gnull = g.null if g.null is not None else falses(n1)
        bnull = b.null if b.null is not None else falses(n2)
        null = torch.cat([gnull, bnull])
        cols.append(replace(g, data=_pad_dev(data, out_pad), null=_pad_dev(null, out_pad)))
    row_valid = _pad_dev(torch.cat([sec1_valid, sec2_valid]), out_pad)
    return KT.DeviceBatch(plan.schema(), cols, row_valid, n1 + n2)


def _trace_cross(plan: P.CrossJoinExec, env: dict):
    """A cross join against a one-row right side: its values broadcast to
    every probe row."""
    probe = _trace_node(plan.left, env)
    _kind, right_db, _extra = env[id(plan)]
    n = probe.n_pad
    cols = list(probe.cols)
    for c in right_db.cols:
        data = c.data[:1].expand(n).contiguous()
        null = c.null[:1].expand(n).contiguous() if c.null is not None else None
        cols.append(replace(c, data=data, null=null, ssum=None))  # broadcast fan-out
    return KT.DeviceBatch(plan.schema(), cols, probe.row_valid, probe.n_rows)


def _gather_build_cols(build_dev, pos, found):
    """Build columns at ``pos``, NULL where ``found`` is false. Gathers can
    repeat build rows, so no subset-sum bound survives: ``ssum`` is None on
    every gathered column, as ``presum_safe`` downstream expects."""
    safe = torch.clamp(pos, 0, build_dev.n_pad - 1)
    notfound = ~found
    out = []
    for c in build_dev.cols:
        null = c.null[safe] if c.null is not None else torch.zeros_like(found)
        out.append(replace(c, data=c.data[safe], null=null | notfound, ssum=None))
    return out


def _sum_dtype(dt: DataType) -> DataType:
    if dt in (DataType.FLOAT32, DataType.FLOAT64):
        return DataType.FLOAT64
    if dt is DataType.DATE32:
        return DataType.DATE32
    return DataType.INT64


def _coerce_dev(c, dtype: DataType):
    if c.dtype is dtype or c.is_string:
        return c
    return KT.convert_repr(c, dtype)


def _pad_dev(a, pad: int):
    if a is None:
        return None
    n = a.shape[0]
    if n == pad:
        return a
    if n > pad:
        return a[:pad]
    return torch.cat([a, torch.zeros(pad - n, dtype=a.dtype, device=a.device)])
