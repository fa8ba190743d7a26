"""Streaming shuffle ingest: bounded-memory consumption of shuffle partitions.

Reference analog: ``ShuffleReaderExec`` streams record batches end-to-end
(``arrow-ballista: ballista/core/src/execution_plans/shuffle_reader.rs:136-171``
— ``send_fetch_partitions`` feeds an ``AbortableReceiverStream`` that the
operators above poll batch-by-batch). The round-2 reader instead fetched every
remote piece into RAM and ``concat_tables``-ed the lot, so one fat consumer
partition at SF100 could OOM the host before the device saw a row.

This module restores the bounded-memory property in a TPU-friendly shape:

* remote pieces are streamed over Flight **directly to local spill files**
  (disk-bounded, never RAM-materialised; bounded fetch concurrency);
* fetches are **consolidated per producing executor**: one do_get whose
  ticket carries the executor's full path list, pieces streamed back-to-back
  with end markers (streams drop from O(maps x executors) to O(executors));
  connections come from the process-wide Flight pool;
* all pieces — local fast-path files and spilled fetches — are then consumed
  **memory-mapped**, batch by batch, so resident memory is page-cache
  (reclaimable) rather than anonymous heap;
* batches are coalesced to a configurable chunk size before hitting the
  engine: big chunks keep the columnar kernels vectorised (the TPU engine
  wants large static shapes; 8k-row reference batches would be pure overhead
  here).
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional

import pyarrow as pa
import pyarrow.ipc as ipc
import pyarrow.flight as flight

from ballista_tpu_torch.errors import FetchFailed
from ballista_tpu_torch.obs.tracing import Phase
from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.shuffle.pool import GLOBAL_FLIGHT_POOL, flight_connection

# chunk target for engine consumption; kernels are vectorised so bigger is
# better until RAM pressure — 256k rows of a ~100B row is ~25MB per chunk
DEFAULT_CHUNK_ROWS = 262_144
MAX_CONCURRENT_FETCHES = 8  # files on disk, so cap is about NIC+disk, not RAM
FETCH_ATTEMPTS = 3
RETRY_BACKOFF_S = 3.0


def fetch_partition_to_file(
    host: str,
    port: int,
    path: str,
    dest: str,
    executor_id: str = "",
    map_stage_id: int = 0,
    map_partition_id: int = 0,
    object_store_url: str = "",
    cancelled=None,
    attempts=None,
    pooled: bool = True,
    codec: str = "",
) -> str:
    """Stream one remote shuffle piece to a local IPC file without ever
    holding more than one record batch in memory. Same retry/typed-error
    discipline as ``flight.fetch_partition`` (client.rs:113-188). When the
    producer executor is unreachable and ``object_store_url`` is set, the
    piece is downloaded from the object store instead — surviving producer
    preemption without a stage re-run (reference: ObjectStoreRemote,
    shuffle_reader.rs:340-363). ``cancelled`` (an Event-like) short-circuits
    retries when the consumer terminated early (limit/top-k); ``attempts``
    overrides the Flight retry budget for callers that know the path is gone.
    Connections are borrowed from the process-wide pool (``pooled=False``
    dials a one-shot client)."""
    last_err: Optional[Exception] = None
    for attempt in range(int(attempts or FETCH_ATTEMPTS)):
        if cancelled is not None and cancelled.is_set():
            raise FetchFailed(
                executor_id, map_stage_id, map_partition_id, "fetch cancelled"
            )
        if attempt:
            time.sleep(RETRY_BACKOFF_S * attempt)
        tmp = f"{dest}.tmp-{uuid.uuid4().hex[:8]}"
        try:
            from ballista_tpu_torch.shuffle.writer import spill_write_options

            ticket = {"path": path}
            if codec:
                # wire compression (docs/shuffle.md): the server re-encodes
                # the stream with this codec; the spill file keeps it too
                ticket["codec"] = codec
            opts = spill_write_options(codec)
            with flight_connection(host, port, pooled) as (client, _reused):
                reader = client.do_get(
                    flight.Ticket(json.dumps(ticket).encode())
                )
                first = True
                writer = None
                try:
                    for chunk in reader:
                        if chunk.data is None:
                            continue
                        if first:
                            writer = ipc.new_file(
                                tmp, chunk.data.schema, options=opts
                            )
                            first = False
                        writer.write_batch(chunk.data)
                    if writer is None:
                        # zero-batch stream: write an empty file with the
                        # stream's schema so downstream mmap reads succeed
                        writer = ipc.new_file(tmp, reader.schema, options=opts)
                finally:
                    if writer is not None:
                        writer.close()
                os.replace(tmp, dest)
                return dest
        except Exception as e:  # noqa: BLE001 - converted to typed error below
            last_err = e
            try:
                os.unlink(tmp)
            except OSError:
                pass
            from ballista_tpu_torch.shuffle.integrity import is_integrity_error

            if is_integrity_error(e):
                # checksum mismatch is deterministic — skip straight to the
                # next tier instead of re-fetching the same corrupt bytes
                break
    if object_store_url:
        from ballista_tpu_torch.shuffle.integrity import verify_downloaded
        from ballista_tpu_torch.utils.object_store import (
            download_file,
            shuffle_object_url,
        )

        try:
            download_file(shuffle_object_url(object_store_url, path), dest)
            # same integrity gate as a Flight fetch, against the uploaded
            # sidecar (missing sidecar -> unverified, never failed)
            verify_downloaded(object_store_url, path, dest)
            return dest
        except Exception as e:  # noqa: BLE001 - fall through to FetchFailed
            last_err = e
            try:
                os.unlink(dest)
            except OSError:
                pass
    raise FetchFailed(
        executor_id, map_stage_id, map_partition_id,
        f"streaming fetch {path} from {host}:{port} failed: {last_err}",
    )


def fetch_pieces_to_files(
    host: str,
    port: int,
    locs: list[dict[str, Any]],
    dests: list[str],
    object_store_url: str = "",
    cancelled=None,
    pooled: bool = True,
    codec: str = "",
) -> list[str]:
    """Consolidated per-executor fetch: stream ALL of one producing
    executor's pieces for this reduce task through ONE do_get, each piece
    landing in its own spill file (finalized on the server's piece-end
    marker, so a mid-stream failure loses only the unfinished piece). The
    remainder is retried consolidated, then degrades to the per-piece path —
    one Flight attempt each (the stream budget is spent) plus the
    object-store tier — FetchFailed still names the exact lost map partition
    for lineage rollback."""
    from ballista_tpu_torch.shuffle.flight import drive_consolidated_rounds

    if len(locs) == 1:
        loc = locs[0]
        fetch_partition_to_file(
            host, port, loc["path"], dests[0], loc.get("executor_id", ""),
            loc.get("stage_id", 0), loc.get("map_partition", 0),
            object_store_url, cancelled, loc.get("_flight_attempts"), pooled,
            codec,
        )
        return dests

    from ballista_tpu_torch.shuffle.writer import spill_write_options

    spill_opts = spill_write_options(codec)

    def sink_round(remaining, schema_box, done):
        # one open writer at a time: pieces arrive strictly in ticket order,
        # the marker for piece i closes it before piece i+1's first batch
        state: dict[str, Any] = {"writer": None, "tmp": None, "piece": None}

        def _open(piece: int, schema: pa.Schema) -> None:
            tmp = f"{dests[remaining[piece]]}.tmp-{uuid.uuid4().hex[:8]}"
            state["writer"] = ipc.new_file(tmp, schema, options=spill_opts)
            state["tmp"] = tmp
            state["piece"] = piece

        def on_batch(piece: int, rb: pa.RecordBatch) -> None:
            if state["writer"] is None or state["piece"] != piece:
                _open(piece, rb.schema)
            state["writer"].write_batch(rb)

        def on_end(piece: int, _meta: dict) -> None:
            if state["writer"] is None:
                # zero-batch piece: empty file with the stream schema so
                # downstream mmap reads succeed
                _open(piece, schema_box[0])
            state["writer"].close()
            os.replace(state["tmp"], dests[remaining[piece]])
            state["writer"] = state["tmp"] = state["piece"] = None
            done.add(remaining[piece])

        def abort() -> None:
            if state["writer"] is not None:
                # discard the unfinished piece: partial spill files must
                # never be finalized (re-fetch would duplicate rows)
                try:
                    state["writer"].close()
                except Exception:  # noqa: BLE001
                    pass
                try:
                    os.unlink(state["tmp"])
                except OSError:
                    pass
                state["writer"] = state["tmp"] = state["piece"] = None

        return on_batch, on_end, abort

    done = drive_consolidated_rounds(
        host, port, locs, pooled, sink_round, cancelled, codec=codec
    )
    missing = [i for i in range(len(locs)) if i not in done]
    if missing:
        # per-piece fallback, in PARALLEL (bounded): recovering a dead
        # executor's M pieces from the object store must not degrade to M
        # sequential downloads
        from ballista_tpu_torch.shuffle.flight import FALLBACK_CONCURRENCY

        def fallback(i: int) -> None:
            loc = locs[i]
            fetch_partition_to_file(
                host, port, loc["path"], dests[i], loc.get("executor_id", ""),
                loc.get("stage_id", 0), loc.get("map_partition", 0),
                object_store_url, cancelled, attempts=1, pooled=pooled,
                codec=codec,
            )

        with ThreadPoolExecutor(
            max_workers=min(FALLBACK_CONCURRENCY, len(missing)),
            thread_name_prefix="shuffle-fallback",
        ) as fb_pool:
            list(fb_pool.map(fallback, missing))
    return dests


def _spill_dest(spill_dir: str, loc: dict[str, Any]) -> str:
    # debug-friendly tag + a per-fetch uuid: concurrent tasks of one stage
    # fetch pieces whose remote paths differ only in the out-partition
    # directory (same basename), and may even fetch the SAME piece — every
    # fetch gets its own file so spills can never alias
    tag = f"{loc.get('executor_id','')}-{loc.get('stage_id',0)}-{loc.get('map_partition',0)}"
    return os.path.join(spill_dir, f"fetch-{tag}-{uuid.uuid4().hex[:12]}.arrow")


def _iter_ipc_file(path: str) -> Iterator[pa.RecordBatch]:
    """Memory-mapped batch-by-batch read. lz4-compressed batches decompress
    per batch (bounded by the writer's max_chunksize), the file itself stays
    on the page cache."""
    with pa.memory_map(path, "rb") as source:
        reader = ipc.open_file(source)
        for i in range(reader.num_record_batches):
            yield reader.get_batch(i)


def iter_shuffle_arrow(
    locations: list[dict[str, Any]],
    spill_dir: Optional[str] = None,
    object_store_url: str = "",
    consolidate: bool = True,
    pooled: bool = True,
    codec: str = "",
    pipeline_wait_s: float = 120.0,
    feed_stats=None,
) -> Iterator[pa.RecordBatch]:
    """Yield one shuffle input partition as raw Arrow record batches, bounded
    memory: remote pieces spill to ``spill_dir`` and are DELETED right after
    their batches are consumed (peak spill = in-flight fetches, not the whole
    partition), local pieces are read memory-mapped in place. Remote pieces
    are grouped by producing executor and fetched through ONE consolidated
    stream per executor (``consolidate=False`` restores per-piece streams).
    Raises ``FetchFailed`` exactly like the materialising reader so lineage
    rollback is unchanged; an early-terminated consumer (limit/top-k) sets
    the shared cancellation flag so fetch threads stop between retries.

    Pipelined shuffle (docs/shuffle.md): PENDING markers — pieces a producer
    had not sealed when this early-launched consumer resolved — are handed
    to a background resolver thread polling the live piece feed; sealed-at-
    launch pieces stream FIRST (fetch/decode/compute overlaps the producer
    tail), late pieces stream in seal order as the feed delivers them. A
    marker that outlives ``pipeline_wait_s`` raises the same ``FetchFailed``
    lineage error naming the exact map partition. ``feed_stats`` (a
    ``feed.FeedStats``) accumulates pending-wait/overlap accounting."""
    import threading

    from ballista_tpu_torch.shuffle.flight import group_locations_by_endpoint

    local: list[dict[str, Any]] = []
    remote: list[dict[str, Any]] = []
    pending: list[dict[str, Any]] = []
    for loc in locations:
        if loc.get("pending"):
            pending.append(loc)
        elif loc.get("path") and os.path.exists(loc["path"]):
            local.append(loc)
        else:
            remote.append(loc)

    # one consolidated stream per producing executor, randomized group order
    # (per-piece groups when consolidation is off or a piece is demoted)
    groups = group_locations_by_endpoint(remote, consolidate)

    spill_dir = spill_dir or os.path.join(tempfile.gettempdir(), "ballista-spill")
    if remote or pending:
        os.makedirs(spill_dir, exist_ok=True)
    pool: Optional[ThreadPoolExecutor] = None
    cancelled = threading.Event()
    futs: list[tuple[list[str], Any]] = []  # (dests, future) per group
    loc_by_path: dict[str, dict[str, Any]] = {l["path"]: l for l in local}
    if groups:
        pool = ThreadPoolExecutor(
            max_workers=min(MAX_CONCURRENT_FETCHES, len(groups)),
            thread_name_prefix="shuffle-fetch",
        )
        for (host, port), glocs in groups:
            dests = [_spill_dest(spill_dir, loc) for loc in glocs]
            for dest, loc in zip(dests, glocs):
                loc_by_path[dest] = loc
            futs.append(
                (
                    dests,
                    pool.submit(
                        fetch_pieces_to_files,
                        host, port, glocs, dests,
                        object_store_url, cancelled, pooled, codec,
                    ),
                )
            )

    # live piece feed (docs/shuffle.md): a background thread polls the feed
    # for the pending markers and queues each piece's SEALED location as it
    # lands; the consumer drains the queue after the ready pieces so the
    # producer tail overlaps ready-piece fetch/decode/compute. Errors (feed
    # deadline, job gone, cancellation) travel through the queue as the
    # typed FetchFailed the lineage machinery expects.
    _FEED_DONE = object()
    resolved_q: Optional["queue.Queue"] = None
    if pending:
        import queue as _queue

        from ballista_tpu_torch.shuffle import feed as _feed

        if feed_stats is not None:
            feed_stats.note_window_start()
        resolved_q = _queue.Queue()

        def _resolve_pending() -> None:
            try:
                by_group: dict[tuple, list[dict]] = {}
                for m in pending:
                    by_group.setdefault(
                        (m.get("stage_id"), m.get("partition_id")), []
                    ).append(m)
                # ONE absolute deadline across the groups (producers seal in
                # parallel; a per-group restart would stretch the budget to
                # groups x pipeline_wait_s — see feed.resolve_pending)
                t_end = time.monotonic() + max(0.0, pipeline_wait_s)
                for markers in by_group.values():
                    for loc in _feed.iter_resolved(
                        markers, max(0.0, t_end - time.monotonic()), cancelled
                    ):
                        resolved_q.put(loc)
                resolved_q.put(_FEED_DONE)
            except BaseException as e:  # noqa: BLE001 - delivered to consumer
                resolved_q.put(e)

        threading.Thread(
            target=_resolve_pending, daemon=True, name="piece-feed"
        ).start()

    try:
        def sources() -> Iterator[tuple[str, bool]]:
            for loc in local:
                yield loc["path"], False
            for dests, fut in futs:
                fut.result()  # re-raises FetchFailed from the fetch thread
                for dest in dests:
                    yield dest, True

        for path, is_spill in sources():
            yielded = False
            try:
                if not is_spill:
                    # local fast-path pieces never cross the Flight server's
                    # integrity gate — verify here (spilled fetches were
                    # verified server-side before streaming). The corrupt
                    # fault point models disk rot between write and read.
                    from ballista_tpu_torch.shuffle.integrity import verify_piece
                    from ballista_tpu_torch.utils import faults

                    faults.corrupt_file("shuffle.read", path)
                    verify_piece(path)
                for rb in _iter_ipc_file(path):
                    if rb.num_rows:
                        yielded = True
                        yield rb
            except FetchFailed:
                raise
            except Exception as e:  # noqa: BLE001 - typed for lineage rollback
                loc = loc_by_path.get(path, {"path": path})
                # only retry when NOTHING was yielded from this piece yet —
                # a mid-file failure after partial yields must fail the task
                # (re-reading the whole piece would duplicate rows)
                if not is_spill and not yielded:
                    # a LOCAL file can vanish between the existence check and
                    # the read (decommission cleanup): retry via the remote
                    # tiers (single Flight attempt — the producer has likely
                    # lost the same path — then the object store)
                    dest = _spill_dest(spill_dir, loc)
                    os.makedirs(spill_dir, exist_ok=True)
                    fetch_partition_to_file(
                        loc.get("host", ""), loc.get("flight_port", 0),
                        loc["path"], dest,
                        loc.get("executor_id", ""), loc.get("stage_id", 0),
                        loc.get("map_partition", 0), object_store_url,
                        attempts=1, pooled=pooled,
                    )  # raises FetchFailed if every tier fails
                    try:
                        for rb in _iter_ipc_file(dest):
                            if rb.num_rows:
                                yield rb
                    except Exception as e2:  # noqa: BLE001 - keep the
                        # typed-error contract: a corrupt re-fetched piece
                        # must still drive lineage rollback, not a raw crash
                        raise FetchFailed(
                            loc.get("executor_id", ""), loc.get("stage_id", 0),
                            loc.get("map_partition", 0),
                            f"re-fetched read {dest}: {e2}",
                        ) from e2
                    finally:
                        try:
                            os.unlink(dest)
                        except OSError:
                            pass
                    continue
                raise FetchFailed(
                    loc.get("executor_id", ""), loc.get("stage_id", 0),
                    loc.get("map_partition", 0), f"read {path}: {e}",
                ) from e
            finally:
                if is_spill:
                    # consumed: free the spill immediately (ADVICE r3 — peak
                    # spill usage must not be the whole partition)
                    try:
                        os.unlink(path)
                    except OSError:
                        pass

        # late pieces: drain the feed queue in seal order. Blocked time here
        # is genuine producer-wait (everything sealed is already consumed) —
        # it feeds op.PendingWait.time_s and is EXCLUDED from the straggler
        # p50 baseline scheduler-side.
        while resolved_q is not None:
            t0 = time.monotonic()
            item = resolved_q.get()
            if feed_stats is not None:
                feed_stats.pending_wait_s += time.monotonic() - t0
            if item is _FEED_DONE:
                break
            if isinstance(item, BaseException):
                raise item
            loc = item
            if feed_stats is not None:
                feed_stats.note_piece()
            spill_path: Optional[str] = None
            yielded = False
            try:
                read_path = None
                if loc.get("path") and os.path.exists(loc["path"]):
                    try:
                        # local fast path, same integrity gate as the ready
                        # pieces; a vanished/corrupt file demotes to the
                        # remote tiers below instead of failing the stage
                        from ballista_tpu_torch.shuffle.integrity import verify_piece
                        from ballista_tpu_torch.utils import faults

                        faults.corrupt_file("shuffle.read", loc["path"])
                        verify_piece(loc["path"])
                        read_path = loc["path"]
                    except Exception as e:  # noqa: BLE001 - demote to remote
                        logging.getLogger("ballista.shuffle").warning(
                            "pipelined local read %s failed (%s); trying "
                            "remote tiers", loc["path"], e,
                        )
                if read_path is None:
                    spill_path = _spill_dest(spill_dir, loc)
                    fetch_partition_to_file(
                        loc.get("host", ""), loc.get("flight_port", 0),
                        loc["path"], spill_path, loc.get("executor_id", ""),
                        loc.get("stage_id", 0), loc.get("map_partition", 0),
                        object_store_url, cancelled, pooled=pooled,
                        codec=codec,
                    )
                    read_path = spill_path
                for rb in _iter_ipc_file(read_path):
                    if rb.num_rows:
                        yielded = True
                        yield rb
            except FetchFailed:
                raise
            except Exception as e:  # noqa: BLE001 - typed for lineage rollback
                if spill_path is None and not yielded:
                    # the local file broke mid-read BEFORE any rows left:
                    # one remote attempt (the producer likely lost the same
                    # path) + the object-store tier, like the ready path.
                    # After partial yields a re-read would duplicate rows —
                    # fail the task instead.
                    spill_path = _spill_dest(spill_dir, loc)
                    fetch_partition_to_file(
                        loc.get("host", ""), loc.get("flight_port", 0),
                        loc["path"], spill_path, loc.get("executor_id", ""),
                        loc.get("stage_id", 0), loc.get("map_partition", 0),
                        object_store_url, cancelled, attempts=1,
                        pooled=pooled, codec=codec,
                    )  # raises FetchFailed when every tier fails
                    try:
                        for rb in _iter_ipc_file(spill_path):
                            if rb.num_rows:
                                yield rb
                    except Exception as e2:  # noqa: BLE001 - keep typed
                        raise FetchFailed(
                            loc.get("executor_id", ""), loc.get("stage_id", 0),
                            loc.get("map_partition", 0),
                            f"pipelined re-fetched read {spill_path}: {e2}",
                        ) from e2
                else:
                    raise FetchFailed(
                        loc.get("executor_id", ""), loc.get("stage_id", 0),
                        loc.get("map_partition", 0),
                        f"pipelined read {loc.get('path')}: {e}",
                    ) from e
            finally:
                if spill_path is not None:
                    try:
                        os.unlink(spill_path)
                    except OSError:
                        pass
    finally:
        cancelled.set()
        if pool is not None:
            for _, fut in futs:
                fut.cancel()
            pool.shutdown(wait=True)
            # leftover fetched files: ones an early-terminated consumer never
            # read, ones whose future completed after a sibling raised, and
            # pieces a failed group finalized before its stream broke
            # (already-consumed spills were unlinked above — double unlink is
            # a no-op)
            for dests, _ in futs:
                for dest in dests:
                    try:
                        os.unlink(dest)
                    except OSError:
                        pass


def iter_shuffle_partition(
    locations: list[dict[str, Any]],
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    spill_dir: Optional[str] = None,
    object_store_url: str = "",
    consolidate: bool = True,
    pooled: bool = True,
    codec: str = "",
    pipeline_wait_s: float = 120.0,
    feed_stats=None,
) -> Iterator[ColumnBatch]:
    """``iter_shuffle_arrow`` coalesced into ``ColumnBatch`` chunks of
    ~``chunk_rows`` rows — the engine-facing form (big chunks keep the
    columnar kernels vectorised)."""
    from ballista_tpu_torch.obs.tracing import ambient, ambient_span
    from ballista_tpu_torch.shuffle.flight import _endpoint
    from ballista_tpu_torch.shuffle.pool import attach_conn_stats

    rows = 0
    # instrumentation inputs only when traced: untraced reads must stay on
    # the zero-cost path (no pool-lock snapshot, no per-location stat calls)
    conn0 = remote = None
    if ambient() is not None:
        conn0 = GLOBAL_FLIGHT_POOL.stats()
        # classify up front, with the same test the fetch path applies —
        # recomputing after consumption could disagree (files appear/vanish)
        remote = [
            loc for loc in locations
            if not loc.get("pending")
            and not (loc.get("path") and os.path.exists(loc["path"]))
        ]
    with ambient_span("shuffle-read", "shuffle", {"pieces": len(locations)}) as span:
        from ballista_tpu_torch.ops.batch import wire_batches_to_columnbatch

        acc: list[pa.RecordBatch] = []
        acc_rows = 0
        for rb in iter_shuffle_arrow(
            locations, spill_dir=spill_dir, object_store_url=object_store_url,
            consolidate=consolidate, pooled=pooled, codec=codec,
            pipeline_wait_s=pipeline_wait_s, feed_stats=feed_stats,
        ):
            acc.append(rb)
            acc_rows += rb.num_rows
            if acc_rows >= chunk_rows:
                rows += acc_rows
                yield wire_batches_to_columnbatch(acc)
                acc, acc_rows = [], 0
        if acc_rows:
            rows += acc_rows
            yield wire_batches_to_columnbatch(acc)
        if span is not None:
            span.set("rows", rows)
            span.set(
                "bytes", sum(int(loc.get("num_bytes", 0) or 0) for loc in locations)
            )
            if feed_stats is not None and feed_stats.pending_pieces:
                # pipelined shuffle: late pieces streamed via the feed and
                # the producer-wait they cost (docs/shuffle.md)
                span.set("pending_pieces", feed_stats.pending_pieces)
                span.set(
                    "pending_wait_ms",
                    round(feed_stats.pending_wait_s * 1000.0, 3),
                )
            # data-plane shape: how many endpoint streams served the remote
            # pieces, and whether their connections were pooled or fresh
            if remote:
                span.set("remote_pieces", len(remote))
                span.set(
                    "executor_streams",
                    len({_endpoint(loc) for loc in remote})
                    if consolidate else len(remote),
                )
                attach_conn_stats(span, conn0, pooled)


class ShuffleStreamWriter:
    """Incremental shuffle writer: consume a stream of input chunks, append
    each chunk's hash split to per-output-partition IPC files.

    Reference analog: ``ShuffleWriterExec::execute_shuffle_write``'s
    per-batch loop (``shuffle_writer.rs:174-336`` — each input batch is
    partitioned and appended to the per-partition writers; nothing holds the
    whole partition). Same file layout and attempt-suffix discipline as the
    one-shot ``write_shuffle_partitions``. Object-store uploads overlap the
    tail of the write: each finished file is submitted as it closes instead
    of after the whole set.
    """

    def __init__(self, plan, input_partition: int, work_dir: str, stage_attempt: int = 0,
                 object_store_url: str = "", checksums: bool = True,
                 dict_codes: bool = True, task_attempt: int = 0,
                 compression: str = ""):
        from ballista_tpu_torch.shuffle.writer import IPC_MAX_CHUNK_ROWS, codec_of

        # internal hash exchanges only: pass-through stages include the
        # job's RESULT stage, whose files external Flight SQL clients read
        # verbatim — never engine-private code columns (see writer.py)
        self.dict_codes = dict_codes and plan.partitioning is not None
        self.plan = plan
        self.input_partition = input_partition
        self.work_dir = work_dir
        self.stage_attempt = stage_attempt
        self.task_attempt = task_attempt
        self.object_store_url = object_store_url
        self.checksums = checksums
        self.opts = ipc.IpcWriteOptions(compression=codec_of(compression))
        self.max_chunk = IPC_MAX_CHUNK_ROWS
        self._writers: dict[int, ipc.RecordBatchFileWriter] = {}
        self._files: dict[int, pa.OSFile] = {}
        self._paths: dict[int, str] = {}
        self._rows: dict[int, int] = {}
        self._schema: Optional[pa.Schema] = None
        # write_time_s counts only time spent INSIDE append()/finish() — the
        # chunks are lazily generated, so wall time since construction would
        # charge upstream engine compute to the write metric (ADVICE r3)
        self._write_time = 0.0
        self.input_rows = 0

    def _path_for(self, out_idx: int) -> str:
        d = os.path.join(
            self.work_dir, self.plan.job_id, str(self.plan.stage_id), str(out_idx)
        )
        os.makedirs(d, exist_ok=True)
        from ballista_tpu_torch.shuffle.writer import piece_suffix

        suffix = piece_suffix(self.stage_attempt, self.task_attempt)
        return os.path.join(d, f"data-{self.input_partition}{suffix}.arrow")

    def _writer_for(self, out_idx: int, schema: pa.Schema) -> ipc.RecordBatchFileWriter:
        w = self._writers.get(out_idx)
        if w is None:
            path = self._path_for(out_idx)
            f = pa.OSFile(path, "wb")
            w = ipc.new_file(f, schema, options=self.opts)
            self._writers[out_idx] = w
            self._files[out_idx] = f
            self._paths[out_idx] = path
            self._rows[out_idx] = 0
        return w

    def append(self, batch: ColumnBatch) -> None:
        with Phase("ballista.shuffle.write"):
            self._append(batch)

    def _append(self, batch: ColumnBatch) -> None:
        from ballista_tpu_torch.ops.kernels_np import hash_partition

        t0 = time.time()
        self.input_rows += batch.num_rows
        if self.plan.partitioning is None:
            parts = {self.input_partition: batch}
        else:
            parts = dict(
                enumerate(
                    hash_partition(
                        batch, list(self.plan.partitioning.exprs), self.plan.partitioning.n
                    )
                )
            )
        for out_idx, part in parts.items():
            from ballista_tpu_torch.ops.batch import WIRE_DICT_META, to_wire_table

            # wire codes for shared-dictionary strings (docs/strings.md); the
            # plan's dict_refs claim is value-sound, so every chunk of a
            # claimed column encodes against the same dictionary and the
            # per-partition file schema stays stable across chunks
            # (refs_only: code only plan-claimed columns — see writer.py)
            table = to_wire_table(part, getattr(self.plan, "dict_refs", None),
                                  self.dict_codes, refs_only=True)
            if self._schema is None:
                self._schema = table.schema
            elif table.schema != self._schema:
                if any(
                    (f.metadata and WIRE_DICT_META in f.metadata)
                    or (g.metadata and WIRE_DICT_META in g.metadata)
                    for f, g in zip(table.schema, self._schema)
                ):
                    # a wire-coding flip between chunks of ONE stream (a
                    # chunk held a value outside its claimed dictionary):
                    # the benign-drift cast below would silently turn codes
                    # into stringified numbers — fail the task loudly, the
                    # retry surfaces the propagation bug instead of wrong
                    # rows
                    from ballista_tpu_torch.errors import ExecutionError

                    raise ExecutionError(
                        f"shuffle stream wire schema changed mid-partition "
                        f"(stage {self.plan.stage_id}): a chunk violated its "
                        f"shared-dictionary claim; expected {self._schema}, "
                        f"got {table.schema}"
                    )
                table = table.cast(self._schema)
            w = self._writer_for(out_idx, self._schema)
            w.write_table(table, max_chunksize=self.max_chunk)
            self._rows[out_idx] += part.num_rows
        self._write_time += time.time() - t0

    def finish(self):
        """Close writers; emit a (possibly empty) file for every output
        partition so readers never see a missing path. Returns the same
        ``ShuffleWriteStats`` list as the one-shot writer. Uploads (when the
        object-store tier is on) are launched per file as it closes and
        joined at the end — overlapped, not tacked on after."""
        with Phase("ballista.shuffle.write"):
            return self._finish()

    def _finish(self):
        from ballista_tpu_torch.shuffle.writer import (
            ShuffleWriteStats,
            WRITE_CONCURRENCY,
            seal_piece,
            upload_shuffle_file,
        )

        n_out = (
            self.plan.partitioning.n
            if self.plan.partitioning is not None
            else None
        )
        all_parts = (
            range(n_out) if n_out is not None else [self.input_partition]
        )
        t0 = time.time()
        if self._schema is None:
            from ballista_tpu_torch.ops.batch import to_wire_table

            # wire schema even for an all-empty stream, so every piece of the
            # stage shares one schema regardless of which partitions got rows
            empty = to_wire_table(
                ColumnBatch.empty(self.plan.schema()),
                getattr(self.plan, "dict_refs", None), self.dict_codes,
            )
            self._schema = empty.schema
        for out_idx in all_parts:
            if out_idx not in self._writers:
                self._writer_for(out_idx, self._schema)
        stats = []
        uploader: Optional[ThreadPoolExecutor] = None
        upload_futs = []
        if self.object_store_url:
            uploader = ThreadPoolExecutor(
                max_workers=min(WRITE_CONCURRENCY, len(self._writers)),
                thread_name_prefix="shuffle-upload",
            )
        try:
            for out_idx, w in sorted(self._writers.items()):
                w.close()
                self._files[out_idx].close()
                path = self._paths[out_idx]
                seal_piece(path, self.checksums)
                self._write_time += time.time() - t0
                t0 = time.time()
                stats.append(
                    ShuffleWriteStats(
                        out_idx,
                        path,
                        self._rows[out_idx],
                        os.path.getsize(path),
                        self._write_time,
                    )
                )
                if uploader is not None:
                    upload_futs.append(
                        uploader.submit(upload_shuffle_file, path, self.object_store_url)
                    )
        finally:
            if uploader is not None:
                for f in upload_futs:
                    f.result()  # best-effort inside; never raises
                uploader.shutdown(wait=True)
        return stats

    def abort(self) -> None:
        # robust to partial finish(): closing an already-closed writer or
        # file must not stop the remaining handles/files being reclaimed
        for out_idx, w in self._writers.items():
            try:
                w.close()
            except Exception:  # noqa: BLE001
                pass
            try:
                self._files[out_idx].close()
            except Exception:  # noqa: BLE001
                pass
            try:
                os.unlink(self._paths[out_idx])
            except OSError:
                pass


def write_shuffle_stream(
    plan, input_partition: int, chunks: Iterator[ColumnBatch], work_dir: str,
    stage_attempt: int = 0, object_store_url: str = "", checksums: bool = True,
    dict_codes: bool = True, task_attempt: int = 0, compression: str = "",
):
    """Drive a chunk stream through a ``ShuffleStreamWriter``; returns
    ``(stats, input_rows)``."""
    from ballista_tpu_torch.obs.tracing import ambient_span

    w = ShuffleStreamWriter(plan, input_partition, work_dir, stage_attempt,
                            object_store_url, checksums, dict_codes,
                            task_attempt=task_attempt, compression=compression)
    with ambient_span(
        "shuffle-write", "shuffle",
        {"stage": plan.stage_id, "input_partition": input_partition,
         "streamed": True},
    ) as span:
        try:
            for chunk in chunks:
                w.append(chunk)
            stats = w.finish()
        except BaseException:
            # finish() failures abort too: otherwise the remaining partitions'
            # IPC writers and file handles leak and footer-less files linger
            w.abort()
            raise
        if span is not None:
            span.set("bytes", sum(s.num_bytes for s in stats))
            span.set("rows", w.input_rows)
            span.set("partitions", len(stats))
        return stats, w.input_rows
