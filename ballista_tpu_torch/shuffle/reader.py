"""Shuffle reader: assemble one output partition from its locations.

Reference analog: ``ShuffleReaderExec::execute``
(``arrow-ballista: ballista/core/src/execution_plans/shuffle_reader.rs:136-171``):
locations split into local (direct file read) vs remote (Flight fetch, bounded
concurrency, randomized order to avoid hot executors); remote failures map to
``FetchFailed`` for lineage rollback. Remote pieces are grouped by producing
executor and fetched through ONE pooled, consolidated Flight stream per
executor (``flight.fetch_partition_group``) — connections and streams are
O(executors), not O(pieces).
"""
from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import pyarrow as pa

from ballista_tpu_torch.ops.batch import ColumnBatch
from ballista_tpu_torch.plan.schema import Schema
from ballista_tpu_torch.shuffle.flight import (
    fetch_partition_group,
    group_locations_by_endpoint,
)
from ballista_tpu_torch.shuffle.pool import GLOBAL_FLIGHT_POOL
from ballista_tpu_torch.shuffle.writer import read_ipc_file

MAX_CONCURRENT_FETCHES = 50  # reference: shuffle_reader.rs send_fetch_partitions


def read_shuffle_partition(
    locations: list[dict[str, Any]], schema: Schema, object_store_url: str = "",
    consolidate: bool = True, pooled: bool = True, codec: str = "",
    pipeline_wait_s: float = 120.0, feed_stats=None,
) -> ColumnBatch:
    """locations: [{path, host, flight_port, executor_id, stage_id, map_partition}]."""
    from ballista_tpu_torch.obs.tracing import ambient, ambient_span
    from ballista_tpu_torch.shuffle.pool import attach_conn_stats

    conn0 = GLOBAL_FLIGHT_POOL.stats() if ambient() is not None else None
    with ambient_span("shuffle-read", "shuffle", {"pieces": len(locations)}) as span:
        batch = _read_shuffle_partition(
            locations, schema, object_store_url, consolidate, pooled, codec,
            pipeline_wait_s, feed_stats,
        )
        if span is not None:
            span.set("rows", batch.num_rows)
            span.set(
                "bytes", sum(int(loc.get("num_bytes", 0) or 0) for loc in locations)
            )
            if feed_stats is not None and feed_stats.pending_pieces:
                span.set("pending_pieces", feed_stats.pending_pieces)
                span.set(
                    "pending_wait_ms",
                    round(feed_stats.pending_wait_s * 1000.0, 3),
                )
            attach_conn_stats(span, conn0, pooled)
        return batch


def _read_shuffle_partition(
    locations: list[dict[str, Any]], schema: Schema, object_store_url: str = "",
    consolidate: bool = True, pooled: bool = True, codec: str = "",
    pipeline_wait_s: float = 120.0, feed_stats=None,
) -> ColumnBatch:
    if any(loc.get("pending") for loc in locations):
        # pipelined shuffle on the ONE-SHOT path (streaming disabled or a
        # materializing caller): block until the feed resolves every pending
        # marker — correctness does not depend on the streamed path, only
        # the fetch/compute overlap does (docs/shuffle.md)
        from ballista_tpu_torch.shuffle.feed import resolve_pending

        if feed_stats is not None:
            feed_stats.note_window_start()
        n_pending = sum(1 for loc in locations if loc.get("pending"))
        locations, waited = resolve_pending(locations, pipeline_wait_s)
        if feed_stats is not None:
            feed_stats.pending_wait_s += waited
            for _ in range(n_pending):
                feed_stats.note_piece()
    local, remote = [], []
    for loc in locations:
        if loc.get("path") and os.path.exists(loc["path"]):
            local.append(loc)
        else:
            remote.append(loc)

    tables: list[pa.Table] = []
    for loc in local:
        try:
            # local fast-path pieces never cross the Flight server's
            # integrity gate — verify here; a mismatch demotes to the remote
            # tiers exactly like a vanished file (and FetchFails from there)
            from ballista_tpu_torch.shuffle.integrity import verify_piece
            from ballista_tpu_torch.utils import faults

            faults.corrupt_file("shuffle.read", loc["path"])
            verify_piece(loc["path"])
            tables.append(read_ipc_file(loc["path"]))
        except Exception as e:  # noqa: BLE001 - the file can vanish between
            # the existence check and the read (a decommissioning executor's
            # cleanup); demote to the remote tiers (Flight, then object
            # store) instead of failing the stage outright. Keep the root
            # cause in the logs, and don't burn the full Flight retry budget
            # on a path the producer has likely also lost.
            logging.getLogger("ballista.shuffle").warning(
                "local shuffle read %s failed (%s); trying remote tiers",
                loc["path"], e,
            )
            demoted = dict(loc)
            demoted["_flight_attempts"] = 1
            remote.append(demoted)

    if remote:
        # one consolidated stream per producing executor, randomized group
        # order (per-piece groups when consolidation is off or a piece is
        # demoted with a _flight_attempts hint)
        groups = group_locations_by_endpoint(remote, consolidate)
        with ThreadPoolExecutor(max_workers=min(MAX_CONCURRENT_FETCHES, len(groups))) as pool:
            futs = [
                pool.submit(
                    fetch_partition_group,
                    host, port, glocs, object_store_url, pooled, consolidate,
                    codec,
                )
                for (host, port), glocs in groups
            ]
            for f in futs:
                tables.extend(f.result())

    tables = [t for t in tables if t.num_rows]
    if not tables:
        return ColumnBatch.empty(schema)
    # decode each piece independently: shared-dictionary code columns are
    # self-describing per piece (field metadata), and pieces may mix wire
    # schemas (a producer that lost the reference writes raw strings)
    from ballista_tpu_torch.ops.batch import from_wire_table

    decoded = [from_wire_table(t) for t in tables]
    return decoded[0] if len(decoded) == 1 else ColumnBatch.concat(decoded)
