"""Arrow Flight data plane: serve and fetch materialized shuffle partitions.

Reference analog: ``BallistaFlightService::do_get(FetchPartition)``
(``arrow-ballista: ballista/executor/src/flight_service.rs:79-123``) and the
``BallistaClient`` fetch with bounded retries (``core/src/client.rs:113-188``
— 3 total attempts with 3s backoff). Intra-host the reader takes the
local-file fast path and Flight is never touched (survey §2.7: on TPU pods the
intra-slice exchange moves onto ICI instead).

Data-plane shape (see docs/shuffle.md):

* **streaming serve** — ``do_get`` streams record batches from a
  memory-mapped reader via a generator; server memory is bounded by one
  batch, never the whole piece (the round-3 server ``read_all()``-ed the
  file, so one fat piece spiked executor RAM mid-query);
* **consolidated tickets** — a ticket may carry ``{"paths": [...]}``: the
  server streams the pieces back-to-back in ONE schema-aligned stream, with
  a piece-end marker (empty batch + ``app_metadata``) after each piece so
  the client always knows which map partition a mid-stream failure loses —
  FetchFailed keeps attributing the exact piece for lineage rollback;
* **connection pool** — every client path borrows persistent Flight clients
  from ``shuffle.pool.GLOBAL_FLIGHT_POOL`` instead of dialing per piece.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Optional

import pyarrow as pa
import pyarrow.ipc as ipc
import pyarrow.flight as flight

from ballista_tpu_torch.errors import FetchFailed
from ballista_tpu_torch.shuffle.integrity import is_integrity_error, verify_piece
from ballista_tpu_torch.shuffle.pool import flight_connection
from ballista_tpu_torch.utils import faults

FETCH_ATTEMPTS = 3  # total attempts (1 + 2 retries), matching client.rs
RETRY_BACKOFF_S = 3.0
FALLBACK_CONCURRENCY = 8  # parallel per-piece recovery of a broken group

log = logging.getLogger("ballista.shuffle")


def _empty_batch(schema: pa.Schema) -> pa.RecordBatch:
    return pa.RecordBatch.from_arrays(
        [pa.array([], type=f.type) for f in schema], schema=schema
    )


class ShuffleFlightServer(flight.FlightServerBase):
    """Serves FetchPartition tickets.

    Ticket forms (JSON):
      ``{"path": p}``            — one piece, streamed batch-by-batch;
      ``{"paths": [p0, ...]}``   — consolidated: pieces streamed back-to-back,
                                   an empty marker batch with ``app_metadata``
                                   ``{"end": i, "rows": n}`` after each piece;
      either may carry ``"schema"`` (base64 IPC schema) — batches are cast to
      it so strict Flight SQL clients see the advertised schema.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 work_dir: Optional[str] = None, on_serve=None):
        location = f"grpc://{host}:{port}"
        super().__init__(location)
        self.work_dir = work_dir
        # best-effort serve notification (one call per ticket path): the
        # executor's orphan sweeper reads it as "this job's pieces are still
        # being consumed" (pin-awareness, docs/fault_tolerance.md)
        self.on_serve = on_serve

    def _check_path(self, path: str) -> None:
        if self.work_dir is not None:
            # path-traversal guard (reference: executor_server.rs is_subdirectory)
            if not os.path.realpath(path).startswith(os.path.realpath(self.work_dir) + os.sep):
                raise flight.FlightServerError(f"path {path!r} outside work dir")

    def do_get(self, context, ticket: flight.Ticket):
        faults.check("flight.do_get", {"ticket": "fetch"})
        req = json.loads(ticket.ticket.decode())
        paths = req.get("paths") or ([req["path"]] if req.get("path") else [])
        if not paths:
            raise flight.FlightServerError("empty fetch ticket")
        for p in paths:
            self._check_path(p)
            if self.on_serve is not None:
                try:
                    self.on_serve(p)
                except Exception:  # noqa: BLE001 - advisory, never fails a fetch
                    pass
        consolidated = "paths" in req
        cast_schema = ticket_schema(req)
        # wire compression (docs/shuffle.md): the CLIENT asks for a codec on
        # its ticket (its session knob); the stream re-encodes with it. No
        # codec = uncompressed wire, the default.
        wire_opts = None
        codec = req.get("codec")
        if codec:
            from ballista_tpu_torch.shuffle.writer import spill_write_options

            wire_opts = spill_write_options(codec)
        # the stream schema must be known before the first byte: the ticket's
        # declared schema wins; otherwise the first piece's file schema (IPC
        # files carry a schema even with zero batches)
        if cast_schema is not None:
            stream_schema = cast_schema
        else:
            with pa.memory_map(paths[0], "rb") as source:
                stream_schema = ipc.open_file(source).schema

        def gen():
            for i, path in enumerate(paths):
                # integrity gate before the piece's first byte: a bit-flipped
                # file must surface as a named error, never as silently wrong
                # batches. Raised INSIDE the generator so a consolidated
                # stream keeps the pieces already finalized before it.
                try:
                    verify_piece(path)
                except Exception as e:  # noqa: BLE001 - re-typed for Flight
                    raise flight.FlightServerError(str(e)) from e
                rows = 0
                with pa.memory_map(path, "rb") as source:
                    reader = ipc.open_file(source)
                    for bi in range(reader.num_record_batches):
                        faults.check("flight.stream", {"piece": i, "batch": bi})
                        rb = reader.get_batch(bi)
                        if rb.schema != stream_schema:
                            rb = rb.cast(stream_schema)
                        rows += rb.num_rows
                        yield rb
                if consolidated:
                    marker = json.dumps({"end": i, "rows": rows}).encode()
                    yield _empty_batch(stream_schema), marker

        if wire_opts is not None:
            return flight.GeneratorStream(stream_schema, gen(), options=wire_opts)
        return flight.GeneratorStream(stream_schema, gen())

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve, daemon=True, name="flight-server")
        t.start()
        return t


def ticket_schema(req: dict) -> Optional[pa.Schema]:
    """Decode the base64 IPC-serialized schema in ``req["schema"]``, if any."""
    enc = req.get("schema")
    if not enc:
        return None
    import base64

    return pa.ipc.read_schema(pa.py_buffer(base64.b64decode(enc)))


def maybe_cast_to_ticket_schema(table: pa.Table, req: dict) -> pa.Table:
    """Cast to the ticket's declared schema, if any (Flight SQL direct
    endpoints: shuffle files can store narrower types than advertised)."""
    schema = ticket_schema(req)
    if schema is None or table.schema == schema:
        return table
    return table.cast(schema)


def consume_consolidated_stream(
    reader,
    on_batch: Callable[[int, pa.RecordBatch], None],
    on_piece_end: Callable[[int, dict], None],
) -> int:
    """Drain a consolidated do_get stream. Batches between markers belong to
    the current piece (pieces are served strictly in ticket order); an
    ``{"end": i}`` marker completes piece ``i``. Returns the number of pieces
    COMPLETED — on a mid-stream error the caller knows the first lost piece
    is exactly ``completed`` (partial batches of it must be discarded)."""
    completed = 0
    for chunk in reader:
        md = chunk.app_metadata
        if md is not None:
            meta = json.loads(md.to_pybytes().decode())
            if "end" in meta:
                on_piece_end(int(meta["end"]), meta)
                completed = int(meta["end"]) + 1
                continue
        if chunk.data is not None and chunk.data.num_rows:
            on_batch(completed, chunk.data)
    return completed


def fetch_partition(
    host: str, port: int, path: str, executor_id: str, map_stage_id: int,
    map_partition_id: int, object_store_url: str = "", attempts=None,
    pooled: bool = True, codec: str = "",
) -> pa.Table:
    """Fetch one shuffle piece over Flight; FetchFailed drives stage rollback.
    With ``object_store_url`` set, an unreachable producer falls back to the
    object-store copy (reference: ObjectStoreRemote, shuffle_reader.rs:340).
    ``attempts`` overrides the Flight retry budget — a caller that already
    knows the path is gone (vanished local file) shouldn't burn ~9s of
    backoff before reaching the store tier. The connection comes from the
    process-wide pool (evicted on error) unless ``pooled`` is False."""
    last_err: Optional[Exception] = None
    for attempt in range(int(attempts or FETCH_ATTEMPTS)):
        if attempt:
            time.sleep(RETRY_BACKOFF_S * attempt)
        try:
            with flight_connection(host, port, pooled) as (client, _reused):
                req = {"path": path}
                if codec:
                    req["codec"] = codec
                ticket = flight.Ticket(json.dumps(req).encode())
                return client.do_get(ticket).read_all()
        except Exception as e:  # noqa: BLE001 - converted to typed error below
            last_err = e
            if is_integrity_error(e):
                # a checksum mismatch is deterministic: retrying burns the
                # whole backoff budget on bytes that cannot heal — go
                # straight to the next tier (object store / FetchFailed)
                break
    if object_store_url:
        from ballista_tpu_torch.utils.object_store import (
            GLOBAL_OBJECT_STORES,
            shuffle_object_url,
        )

        try:
            return _object_store_fetch(object_store_url, path)
        except Exception as e:  # noqa: BLE001 - fall through to FetchFailed
            last_err = e
    raise FetchFailed(
        executor_id, map_stage_id, map_partition_id,
        f"fetch {path} from {host}:{port} failed: {last_err}",
    )


def _object_store_fetch(object_store_url: str, path: str) -> pa.Table:
    """Object-store tier for the in-memory fetch path: the piece's bytes are
    read once, verified against the uploaded sidecar (when present), then
    decoded — the redundancy tier gets the same integrity gate as Flight."""
    from ballista_tpu_torch.shuffle.integrity import (
        remote_expected_checksum,
        verify_bytes,
    )
    from ballista_tpu_torch.utils.object_store import (
        GLOBAL_OBJECT_STORES,
        shuffle_object_url,
    )

    fs, opath = GLOBAL_OBJECT_STORES.resolve(shuffle_object_url(object_store_url, path))
    with fs.open_input_file(opath) as f:
        data = f.read()
    verify_bytes(path, data, remote_expected_checksum(object_store_url, path))
    return ipc.open_file(pa.BufferReader(data)).read_all()


def _endpoint(loc: dict[str, Any]) -> tuple[str, int]:
    return (loc.get("host", ""), int(loc.get("flight_port", 0) or 0))


def group_locations_by_endpoint(
    remote: list[dict[str, Any]], consolidate: bool = True
) -> list[tuple[tuple[str, int], list[dict[str, Any]]]]:
    """Group remote piece locations into fetch units: one consolidated group
    per producing executor, in randomized order to avoid hot executors
    (shuffle_reader.rs send_fetch_partitions). Pieces carrying the
    ``_flight_attempts`` demotion hint (a vanished local path — the producer
    has likely also lost it) stay single-piece groups so a known-probably-
    gone path can never break a healthy consolidated stream on every retry
    round. ``consolidate=False`` makes every piece its own group."""
    singles: list[dict[str, Any]] = []
    by_ep: dict[tuple[str, int], list[dict[str, Any]]] = {}
    for loc in remote:
        if not consolidate or loc.get("_flight_attempts"):
            singles.append(loc)
        else:
            by_ep.setdefault(_endpoint(loc), []).append(loc)
    groups = list(by_ep.items()) + [(_endpoint(loc), [loc]) for loc in singles]
    import random

    random.shuffle(groups)
    return groups


def drive_consolidated_rounds(
    host: str,
    port: int,
    locs: list[dict[str, Any]],
    pooled: bool,
    sink_round: Callable,
    cancelled=None,
    codec: str = "",
) -> set:
    """Shared retry driver for consolidated group fetches: up to
    ``FETCH_ATTEMPTS`` broken/empty streams, each round re-requesting only
    the still-missing pieces. ``sink_round(remaining, schema_box, done)`` is
    called per round and returns ``(on_batch, on_end, abort)``: ``on_end``
    must finalize the piece and add its ORIGINAL index to ``done``;
    ``abort()`` discards any partial piece state after the round. Returns
    the completed original indices — the caller degrades the rest to the
    per-piece tiers. A clean stream that completes zero pieces (a server
    that never sends markers) burns an attempt so the loop is always
    bounded. ``cancelled`` (Event-like) is honored MID-STREAM, not just
    between rounds: an early-terminated consumer (limit/top-k) must not
    drag a whole executor group's pieces to spill before stopping."""

    def _cancelled_now() -> bool:
        return cancelled is not None and cancelled.is_set()

    def _raise_cancelled() -> None:
        loc = locs[next(i for i in range(len(locs)) if i not in done)]
        raise FetchFailed(
            loc.get("executor_id", ""), loc.get("stage_id", 0),
            loc.get("map_partition", 0), "fetch cancelled",
        )

    done: set = set()
    stream_errors = 0
    while len(done) < len(locs) and stream_errors < FETCH_ATTEMPTS:
        if _cancelled_now():
            _raise_cancelled()
        if stream_errors:
            # an Event wait doubles as a cancellable backoff sleep
            if cancelled is not None:
                cancelled.wait(RETRY_BACKOFF_S * stream_errors)
                if cancelled.is_set():
                    _raise_cancelled()
            else:
                time.sleep(RETRY_BACKOFF_S * stream_errors)
        remaining = [i for i in range(len(locs)) if i not in done]
        schema_box: list[Optional[pa.Schema]] = [None]
        on_batch, on_end, abort = sink_round(remaining, schema_box, done)
        if cancelled is not None:
            inner_batch, inner_end = on_batch, on_end

            def on_batch(piece, rb):  # noqa: F811 - cancellation wrapper
                if _cancelled_now():
                    _raise_cancelled()
                inner_batch(piece, rb)

            def on_end(piece, meta):  # noqa: F811 - cancellation wrapper
                if _cancelled_now():
                    _raise_cancelled()
                inner_end(piece, meta)

        progress = len(done)
        try:
            with flight_connection(host, port, pooled) as (client, _reused):
                req = {"paths": [locs[i]["path"] for i in remaining]}
                if codec:
                    req["codec"] = codec
                ticket = flight.Ticket(json.dumps(req).encode())
                reader = client.do_get(ticket)
                schema_box[0] = reader.schema
                consume_consolidated_stream(reader, on_batch, on_end)
            if len(done) == progress:
                stream_errors += 1
        except FetchFailed:
            raise  # cancellation from a sink wrapper: stop immediately
        except Exception as e:  # noqa: BLE001 - retry remainder, then per-piece
            stream_errors += 1
            if is_integrity_error(e):
                # deterministic checksum mismatch on some piece: further
                # consolidated rounds would break at the same byte every
                # time — drop to the per-piece tier where healthy pieces
                # fetch individually and only the corrupt one FetchFails
                stream_errors = FETCH_ATTEMPTS
            log.debug(
                "consolidated fetch from %s:%s failed (%d pieces left): %s",
                host, port, len(locs) - len(done), e,
            )
        finally:
            abort()
    return done


def fetch_partition_group(
    host: str,
    port: int,
    locs: list[dict[str, Any]],
    object_store_url: str = "",
    pooled: bool = True,
    consolidate: bool = True,
    codec: str = "",
) -> list[pa.Table]:
    """Fetch every piece a reduce task needs from ONE producing executor in a
    single consolidated do_get (O(1) streams per executor instead of O(maps)).
    Returns the tables in ``locs`` order. A mid-stream failure keeps the
    pieces completed before it and retries only the remainder; after the
    stream retry budget the remainder degrades to the per-piece path — one
    Flight attempt each (the stream budget is spent) plus the object-store
    tier — so failure attribution for lineage rollback is exactly as precise
    as before."""
    if not consolidate or len(locs) == 1:
        return [
            fetch_partition(
                host, port, loc["path"], loc.get("executor_id", ""),
                loc.get("stage_id", 0), loc.get("map_partition", 0),
                object_store_url, loc.get("_flight_attempts"), pooled, codec,
            )
            for loc in locs
        ]
    results: dict[int, pa.Table] = {}

    def sink_round(remaining, schema_box, done):
        acc: dict[int, list[pa.RecordBatch]] = {}

        def on_batch(piece: int, rb: pa.RecordBatch) -> None:
            schema_box[0] = rb.schema
            acc.setdefault(piece, []).append(rb)

        def on_end(piece: int, _meta: dict) -> None:
            batches = acc.pop(piece, [])
            schema = batches[0].schema if batches else schema_box[0]
            results[remaining[piece]] = (
                pa.Table.from_batches(batches, schema=schema)
                if schema is not None
                else pa.table({})
            )
            done.add(remaining[piece])

        return on_batch, on_end, acc.clear

    done = drive_consolidated_rounds(
        host, port, locs, pooled, sink_round, codec=codec
    )
    missing = [i for i in range(len(locs)) if i not in done]
    if missing:
        # per-piece fallback, in PARALLEL (bounded): recovering a dead
        # executor's M pieces from the object store must not degrade to M
        # sequential downloads. Raises FetchFailed naming the exact lost piece.
        from concurrent.futures import ThreadPoolExecutor

        def fallback(i: int) -> pa.Table:
            loc = locs[i]
            return fetch_partition(
                host, port, loc["path"], loc.get("executor_id", ""),
                loc.get("stage_id", 0), loc.get("map_partition", 0),
                object_store_url, attempts=1, pooled=pooled, codec=codec,
            )

        with ThreadPoolExecutor(
            max_workers=min(FALLBACK_CONCURRENCY, len(missing)),
            thread_name_prefix="shuffle-fallback",
        ) as fb_pool:
            for i, t in zip(missing, fb_pool.map(fallback, missing)):
                results[i] = t
    return [results[i] for i in range(len(locs))]
