"""Device-resident exchanges over a mesh of shards.

The port of ``ballista_tpu/parallel``. A fused exchange is written per shard,
SPMD-shaped, with the collective passed in or looked up: an object whose
``all_to_all(bufs)`` takes this shard's send buffers ``[n_dev, cap]`` (row
``j`` of each goes to shard ``j``), exchanged in one round, and returns the
rows received, each ``[n_dev, cap]`` (row ``j`` from shard ``j``), and
whose ``all_sum(x)`` sums a scalar tensor over the mesh
(``jax.lax.all_to_all`` and ``jax.lax.psum`` under the JAX package's
``shard_map``).

The process model: one process drives its host's mesh, one host thread per
shard, as one JAX process drives ``jax.local_devices()`` under ``shard_map``.
``shard_map`` here runs a per-shard body once per shard, each on its own
thread, device and CUDA stream, and returns the outputs in shard order. A
mesh has ``force_mesh_shards(n)`` shards when that is set, else one per
visible card (one on the CPU); with fewer cards than shards the shards go
round-robin over the cards, and on the CPU every shard is ``cpu``. Between
two cards a shard receives a peer's rows by a peer copy on its own stream;
between shards of one card, by a copy on that card. Each collective waits
for its peers' send buffers by CUDA event, and a sender's stream waits for
its receivers' copies before it reuses a buffer. A shard that raises aborts
the mesh's barrier, so its peers stop waiting, and a barrier that waits past
``COLLECTIVE_TIMEOUT_S`` breaks: the program fails as a whole
(``ShardFailed``), never part of it. A round costs the shards' threads two
barriers under the interpreter lock (about 4 ms on 4 shards of an H100,
PERF.md), so an exchange sends all its columns in one round.

A mesh group (``parallel.multihost``) spans several processes: P processes
of L shards each form one mesh of P x L shards, a process's shards taking
the global ranks after those of lower process ids. ``shard_map`` given the
group's transport runs this process's L shards as ranks ``pid * L ..``; a
round is still one cross-process call: the local shards pack their buffers
into bytes and post them, one thread (local rank 0) makes the call, and each
shard takes its rows, so that every shard receives what the one-process mesh
of P x L shards would give it, in global shard order.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import torch

from ballista_tpu_torch.errors import ExecutionError

# how long a shard waits at a collective for its peers before the program
# fails (a peer that hangs, where one that raises aborts at once)
COLLECTIVE_TIMEOUT_S = 120.0

# the process-wide shard count set by force_mesh_shards (None: one per card)
_FORCED: Optional[int] = None


def force_mesh_shards(n: Optional[int]) -> Optional[int]:
    """Set how many shards this process's mesh has (None: one per visible
    card, one on the CPU); returns the previous setting, so a caller can
    restore it. The counterpart of the JAX package's ``force_cpu_devices``:
    on one card, ``n`` shards share it."""
    global _FORCED
    if n is not None and int(n) < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    prev, _FORCED = _FORCED, None if n is None else int(n)
    return prev


def mesh_shards(device) -> int:
    """The shard count of the mesh an engine on ``device`` runs over."""
    if _FORCED is not None:
        return _FORCED
    if torch.device(device).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


class SingleDevice:
    """The world of one device: every collective is the identity."""

    n_dev = 1

    def all_to_all(self, bufs):
        return bufs

    def all_sum(self, x):
        return x


class ShardFailed(ExecutionError):
    """A mesh program failed on a shard (it raised, or a collective waited
    past its timeout); ``error`` is the first shard's own exception."""

    def __init__(self, rank: int, error: BaseException):
        self.rank = rank
        self.error = error
        super().__init__(f"mesh shard {rank} failed: {type(error).__name__}: {error}")


class _MeshRun:
    """One run's shared state: the barrier, each shard's posted value and,
    in a mesh group, the transport and each round's received bytes."""

    def __init__(self, devices: Sequence[torch.device], timeout: float, group=None):
        self.devices = list(devices)
        self.n = len(self.devices)
        self.barrier = threading.Barrier(self.n, timeout=timeout)
        self.posted: list = [None] * self.n
        self.done: list = [None] * self.n
        self.group = group
        self.received = None
        self._round: Optional[torch.Tensor] = None
        self._round_lock = threading.Lock()
        self._round_seen = 0

    def round_buffer(self, shape: tuple, device: torch.device, pin: bool) -> torch.Tensor:
        """The current round's shared send buffer: the first shard to reach
        a round makes it, the others take it (a round ends at a barrier that
        no shard passes before the transport has sent the last one)."""
        with self._round_lock:
            if self._round_seen % self.n == 0:
                self._round = torch.empty(shape, dtype=torch.uint8, device=device,
                                          pin_memory=pin)
            self._round_seen += 1
            return self._round


class ShardCollective:
    """Shard ``rank``'s collectives in one mesh run (``rank`` is its local
    rank; in a mesh group its global rank is ``pid * L + rank``)."""

    def __init__(self, run: _MeshRun, rank: int):
        self.run = run
        self.rank = rank
        self.n_dev = run.n * (run.group.size if run.group is not None else 1)
        self.device = run.devices[rank]

    def _stream(self):
        return torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

    def _post(self, value) -> list:
        """Every shard's ``value``, in rank order, each with the event its
        shard's stream recorded after producing it."""
        stream = self._stream()
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        self.run.posted[self.rank] = (value, event)
        self.run.barrier.wait()
        return list(self.run.posted)

    def _take(self, posted: list, pick: Callable) -> list:
        """``pick(value)`` of every posted value on this shard's device, after
        its producer's event; then the release: every shard records that it
        has read, and each stream waits for its readers before it may reuse
        what it posted."""
        stream = self._stream()
        out = []
        for value, event in posted:
            if event is not None:
                stream.wait_event(event)
            out.append([t.to(self.device, non_blocking=True) for t in pick(value)])
        done = None
        if stream is not None:
            done = torch.cuda.Event()
            done.record(stream)
        self.run.done[self.rank] = done
        self.run.barrier.wait()
        if stream is not None:
            for peer in list(self.run.done):
                stream.wait_event(peer)
        return out

    def all_to_all(self, bufs: list) -> list:
        """Row ``j`` of each ``[n_dev, cap]`` buffer in ``bufs`` to shard
        ``j``, in one round; row ``j`` of each result from shard ``j``."""
        if self.run.group is not None:
            return self._group_all_to_all(list(bufs))
        r = self.rank
        got = self._take(self._post(list(bufs)), lambda bs: [b[r] for b in bs])
        return [torch.stack([peer[c] for peer in got]) for c in range(len(bufs))]

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the shards, in rank order."""
        if self.run.group is not None:
            got = self._group_all_to_all([x.reshape(1, 1).expand(self.n_dev, 1)])[0]
            parts = [got[j, 0] for j in range(self.n_dev)]
        else:
            parts = [p[0] for p in self._take(self._post(x), lambda v: [v])]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total.reshape(x.shape)

    def _group_all_to_all(self, bufs: list) -> list:
        """``all_to_all`` across a mesh group's processes, in one
        cross-process call. Each shard copies its ``[P * L, cap]`` buffers
        (any dtypes) as bytes into its place of the round's send buffer
        ``[P, L_src, L_dst, row bytes]`` (block ``q`` goes to process ``q``),
        in pinned host memory over gloo, waiting for its stream's copies;
        local rank 0 makes the transport's call and lays the received bytes
        out as one block a shard, each buffer's ``[P * L, cap]`` rows
        contiguous in it; each shard copies its buffers' rows onto its
        device on its own stream, rows in global shard order."""
        run, group = self.run, self.run.group
        n_proc, n_local = group.size, run.n
        layout, row_bytes, block_bytes = _layout(bufs, self.n_dev)
        stream = self._stream()
        send = run.round_buffer(
            (n_proc, n_local, n_local, row_bytes),
            torch.device("cpu") if group.on_host else run.devices[0],
            pin=group.on_host and stream is not None)
        for b, (_dtype, _cap, nbytes, _padded, off, _goff) in zip(bufs, layout):
            raw = b.contiguous().view(torch.uint8).reshape(n_proc, n_local, nbytes)
            send[:, self.rank, :, off:off + nbytes].copy_(raw)
        event = None
        if stream is not None and send.is_cuda:
            event = torch.cuda.Event()
            event.record(stream)
            send.record_stream(stream)
        run.posted[self.rank] = (None, event)
        run.barrier.wait()
        if self.rank == 0:
            try:
                for _value, peer in run.posted:
                    if peer is not None:
                        stream.wait_event(peer)
                received = group.exchange(send)
                out = torch.empty((n_local, block_bytes), dtype=torch.uint8,
                                  device=received.device,
                                  pin_memory=not received.is_cuda and stream is not None)
                for _dtype, _cap, _nbytes, padded, off, goff in layout:
                    out[:, goff:goff + self.n_dev * padded].view(
                        n_local, n_proc, n_local, padded).copy_(
                        received[:, :, :, off:off + padded].permute(2, 0, 1, 3))
                done = None
                if out.is_cuda:
                    done = torch.cuda.Event()
                    done.record(stream)
                run.received = (out, done)
            except BaseException:
                run.barrier.abort()
                raise
        run.barrier.wait()
        out, done = run.received
        if done is not None:
            stream.wait_event(done)
        got = _unpack(out[self.rank], layout, self.n_dev,
                      self.device if stream is not None else None)
        if out.is_cuda:
            out.record_stream(stream)
        return got


def _layout(bufs: list, n_dev: int) -> tuple:
    """Where each ``[n_dev, cap]`` buffer's bytes go in a round: per buffer
    (dtype, cap, bytes a row, bytes a row padded to 8, offset in a send row,
    offset in a shard's received block); the send row's bytes; the
    received block's bytes."""
    out, off, goff = [], 0, 0
    for b in bufs:
        nbytes = int(b.shape[1]) * b.element_size()
        padded = nbytes + (-nbytes % 8)
        out.append((b.dtype, int(b.shape[1]), nbytes, padded, off, goff))
        off += padded
        goff += n_dev * padded
    return out, off, goff


def _unpack(block: torch.Tensor, layout: list, n_dev: int, device=None) -> list:
    """Each buffer's ``[n_dev, cap]`` rows from a shard's received block: a
    view of it, or with ``device`` a tensor of its own copied there on the
    current stream (so that each buffer is freed when its last use ends, as
    the one-process collective's are)."""
    out = []
    for dtype, cap, nbytes, padded, _off, goff in layout:
        rows = block[goff:goff + n_dev * padded]
        if device is not None:
            rows = rows.to(device, non_blocking=True, copy=True)
        rows = rows.view(n_dev, padded)
        if padded != nbytes:
            rows = rows[:, :nbytes].contiguous()
        out.append(rows.view(dtype).reshape(n_dev, cap))
    return out


_TLS = threading.local()


def collective_for(n_dev: int):
    """The collective of an ``n_dev``-shard exchange on this thread: the
    identity for one shard; inside ``shard_map``, the running shard's.
    Raises for more than one shard outside a mesh program, which no
    exchange may fall back from."""
    if n_dev == 1:
        return SingleDevice()
    coll = getattr(_TLS, "collective", None)
    if coll is None or coll.n_dev != n_dev:
        raise ExecutionError(
            f"a collective over {n_dev} shards runs only inside a mesh program "
            "(parallel.shard_map over that many shards)")
    return coll


_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def _shard_stream(device: torch.device, rank: int):
    """Shard ``rank``'s CUDA stream on ``device``, made once per process."""
    with _STREAMS_LOCK:
        key = (device.index, rank)
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device=device)
        return _STREAMS[key]


def shard_map(body: Callable, shard_args: Sequence[Sequence], devices: Sequence,
              timeout: float = COLLECTIVE_TIMEOUT_S, group=None) -> list:
    """``body(*shard_args[i])`` once per shard ``i`` of the mesh ``devices``,
    each on its own thread and, on a card, its own stream (synchronized
    before the shard ends), with ``collective_for`` giving that shard's
    collective; the outputs in shard order (one shard alone runs on the
    calling thread, with no collective). With ``group``, a mesh group's
    transport (``parallel.multihost``), ``devices`` are this process's
    shards of the group's mesh and the collectives span the group. Raises
    ``ShardFailed`` when any shard raised or a collective timed out."""
    devices = [torch.device(d) for d in devices]
    if len(shard_args) != len(devices):
        raise ValueError(f"{len(shard_args)} shard argument lists for {len(devices)} shards")
    if len(devices) == 1 and group is None:
        return [body(*shard_args[0])]
    run = _MeshRun(devices, timeout, group)
    results: list = [None] * run.n
    errors: list = [None] * run.n

    def work(r: int) -> None:
        dev = devices[r]
        _TLS.collective = ShardCollective(run, r)
        try:
            if dev.type == "cuda":
                stream = _shard_stream(dev, r)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    results[r] = body(*shard_args[r])
                    stream.synchronize()
            else:
                # the shards share the host's cores: one intra-op thread
                # each (the setting is this thread's own)
                torch.set_num_threads(1)
                results[r] = body(*shard_args[r])
        except BaseException as err:  # noqa: BLE001 - handed to the caller below
            errors[r] = err
            run.barrier.abort()
        finally:
            _TLS.collective = None

    threads = [threading.Thread(target=work, args=(r,), name=f"mesh-shard-{r}", daemon=True)
               for r in range(run.n)]
    for t in threads:
        t.start()
    for r, t in enumerate(threads):
        # a shard stuck outside a collective: the others have broken out of
        # the barrier by now; this one is left behind, and the program fails
        t.join(timeout + 5.0)
        if t.is_alive():
            run.barrier.abort()
            raise ShardFailed(r, TimeoutError(f"shard {r} still running after {timeout} s"))
    failed = [(r, e) for r, e in enumerate(errors) if e is not None]
    if failed:
        # the shard that raised first, not the peers its abort broke
        r, err = next(((r, e) for r, e in failed
                       if not isinstance(e, threading.BrokenBarrierError)), failed[0])
        raise ShardFailed(r, err) from err
    return results


def split_rows(arrays: Sequence, n: int) -> list:
    """Each of ``n`` shards' equal contiguous slice of every array (tensor
    or numpy), in shard order: the split the JAX package's ``P(axis)``
    input specs make."""
    per = arrays[0].shape[0] // n
    return [[a[i * per:(i + 1) * per] for a in arrays] for i in range(n)]


def shard_rows(body: Callable, arrays: Sequence[torch.Tensor], devices: Sequence) -> list:
    """``body`` over the mesh ``devices`` with row-sharded inputs: shard
    ``i`` gets its ``split_rows`` slice of ``arrays`` on ``devices[i]``.
    Each output of ``body`` (a sequence of tensors) comes back concatenated
    in shard order on the first shard's device, as ``P(axis)`` outputs do."""
    devices = [torch.device(d) for d in devices]
    parts = split_rows(arrays, len(devices))
    outs = shard_map(body, [[a.to(d) for a in part] for part, d in zip(parts, devices)],
                     devices)
    return [torch.cat([o[j].to(devices[0]) for o in outs]) for j in range(len(outs[0]))]
