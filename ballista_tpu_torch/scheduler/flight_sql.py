"""Arrow Flight SQL service on the scheduler — the JDBC/ADBC path.

Reference analog: the scheduler's ``FlightSqlServiceImpl``
(``arrow-ballista: ballista/scheduler/src/flight_sql.rs:80-1008``). This
speaks the REAL Flight SQL command protocol: ``FlightDescriptor.cmd`` carries
``google.protobuf.Any``-packed ``arrow.flight.protocol.sql.*`` messages
(``CommandStatementQuery``, ``CommandPreparedStatementQuery``, the catalog
metadata commands), tickets are Any-packed ``TicketStatementQuery``, and
prepared statements ride ``DoAction("CreatePreparedStatement")`` /
``("ClosePreparedStatement")`` with Any-packed request/result bodies — the
wire format a stock Flight SQL client produces. Plain-bytes SQL descriptors
remain accepted for ad-hoc pyarrow clients.

Tables are registered server-side via ``do_action("register_parquet",
'{"name": ..., "path": ...}')`` or ahead of time on the service object.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Optional

import pyarrow as pa
import pyarrow.flight as flight
from google.protobuf import any_pb2

from ballista_tpu_torch.client.catalog import Catalog
from ballista_tpu_torch.errors import BallistaError
from ballista_tpu_torch.plan.serde import schema_from_json
from ballista_tpu_torch.proto import ballista_pb2 as pb
from ballista_tpu_torch.proto import flight_sql_pb2 as fsql

_SQL_TYPE_PREFIX = "type.googleapis.com/arrow.flight.protocol.sql."

CATALOG_NAME = "ballista"
SCHEMA_NAME = "public"


def pack_any(msg) -> bytes:
    a = any_pb2.Any()
    a.Pack(msg)
    return a.SerializeToString()


def _try_unpack(raw: bytes):
    """(short message type name, decoded message) for Any-packed Flight SQL
    commands, or (None, None) for non-FlightSQL payloads."""
    a = any_pb2.Any()
    try:
        a.ParseFromString(raw)
    except Exception:  # noqa: BLE001 - not a protobuf Any
        return None, None
    if not a.type_url.startswith(_SQL_TYPE_PREFIX):
        return None, None
    name = a.type_url[len(_SQL_TYPE_PREFIX):]
    cls = getattr(fsql, name, None)
    if cls is None:
        raise flight.FlightServerError(f"unsupported Flight SQL command {name}")
    msg = cls()
    if not a.Unpack(msg):
        raise flight.FlightServerError(f"malformed {name}")
    return name, msg


class SchedulerFlightService(flight.FlightServerBase):
    def __init__(self, scheduler, host: str = "0.0.0.0", port: int = 0,
                 object_store_url: str = "", executor_endpoints: bool = True,
                 query_timeout_s: Optional[float] = None,
                 config=None):
        super().__init__(f"grpc://{host}:{port}")
        # how long _run awaits a job before cancelling it; defaults to the
        # ballista.client.query_timeout_s entry (was a hardcoded 300.0)
        if query_timeout_s is None:
            from ballista_tpu_torch.config import (
                BALLISTA_CLIENT_QUERY_TIMEOUT_S,
                BallistaConfig,
            )

            query_timeout_s = float(BallistaConfig().get(BALLISTA_CLIENT_QUERY_TIMEOUT_S))
        self.query_timeout_s = query_timeout_s
        # result partitions are shuffle consumers too: with a shared store
        # configured, a preempted producer cannot fail a JDBC result fetch
        self.object_store_url = object_store_url
        # endpoints point clients at the executors' Flight servers so result
        # bytes never transit this process (reference: flight_sql.rs returns
        # executor-located endpoints); scheduler-proxied tickets remain the
        # fallback for partitions without a reachable executor
        self.executor_endpoints = executor_endpoints
        # advertised as each endpoint's fallback location (requires a real
        # host; behind 0.0.0.0 the client already holds our address anyway)
        self._self_location = (
            flight.Location.for_grpc_tcp(host, self.port)
            if host not in ("0.0.0.0", "") else None
        )
        self.scheduler = scheduler
        self.catalog = Catalog(config=config)
        self._tokens: set[str] = set()
        # statement_handle -> per-partition payloads ("loc"|"table", value,
        # schema). Bounded LRU: clients may legitimately re-fetch a ticket, so
        # entries are kept until evicted by newer statements rather than
        # dropped on first read (a long-lived server must not grow unbounded)
        from collections import OrderedDict

        self._results: "OrderedDict[str, list]" = OrderedDict()
        self._results_cap = 256
        # handle -> (SQL text, statement fingerprint); bounded for the same
        # reason as _results (a crashed client pool never sends
        # ClosePreparedStatement). The fingerprint is resolved ONCE at
        # prepare time and pins the scheduler's plan-cache entry; eviction
        # here must release that pin too, or a crashed pool's leaked handles
        # would pin cache slots forever (docs/serving.md)
        self._prepared: "OrderedDict[bytes, tuple[str, str]]" = OrderedDict()
        self._prepared_cap = 1024
        # sealed-result cache (docs/serving.md): repeat statements return
        # straight from here without touching executors. Keyed by statement
        # fingerprint + catalog version, so register/deregister invalidates.
        from ballista_tpu_torch.config import (
            BALLISTA_SERVING_RESULT_CACHE,
            BALLISTA_SERVING_RESULT_CACHE_BYTES,
            BALLISTA_SERVING_RESULT_MAX_BYTES,
            BallistaConfig,
        )
        from ballista_tpu_torch.scheduler.serving import ResultCache

        # JDBC clients carry no ballista session, so the serving knobs are
        # read ONCE at construction from the ``config`` argument (same
        # pattern as query_timeout_s above) — pass
        # ``BallistaConfig({"ballista.serving.result_cache": "true", ...})``
        # to turn the sealed-result tier on for this server
        cfg = config if config is not None else BallistaConfig()
        self.result_cache_enabled = bool(cfg.get(BALLISTA_SERVING_RESULT_CACHE))
        self.result_cache = ResultCache(
            cfg.get(BALLISTA_SERVING_RESULT_CACHE_BYTES),
            cfg.get(BALLISTA_SERVING_RESULT_MAX_BYTES),
        )

    def _store_result(self, handle: str, parts: list) -> None:
        self._results[handle] = parts
        while len(self._results) > self._results_cap:
            self._results.popitem(last=False)

    # ---- plan-cache pins (prepared statements; docs/serving.md) -----------------
    def _plan_cache(self):
        return getattr(self.scheduler, "plan_cache", None)

    def _pin_fingerprint(self, fp: str) -> None:
        pc = self._plan_cache()
        if pc is not None and fp:
            pc.pin(fp)

    def _unpin_fingerprint(self, fp: str) -> None:
        pc = self._plan_cache()
        if pc is not None and fp:
            pc.unpin(fp)

    # ---- actions ------------------------------------------------------------------
    def do_action(self, context, action: flight.Action):
        if action.type == "register_parquet":
            req = json.loads(action.body.to_pybytes().decode())
            meta = self.catalog.register_parquet(req["name"], req["path"])
            # the catalog-version bump above already makes every cached key
            # unreachable; clearing eagerly just reclaims the bytes now
            self.result_cache.clear()
            yield json.dumps({"registered": meta.name, "rows": meta.num_rows}).encode()
        elif action.type == "handshake":
            token = uuid.uuid4().hex
            self._tokens.add(token)
            yield token.encode()
        elif action.type == "CreatePreparedStatement":
            name, msg = _try_unpack(action.body.to_pybytes())
            if name != "ActionCreatePreparedStatementRequest":
                raise flight.FlightServerError("bad CreatePreparedStatement body")
            from ballista_tpu_torch.scheduler.serving import fingerprint_sql

            handle = uuid.uuid4().hex.encode()
            # fingerprint resolved ONCE here: every execution of this handle
            # binds straight to the scheduler's cached plan template (the
            # fingerprint rides the submit settings), and the pin keeps the
            # template from being evicted while the statement is open
            fp = fingerprint_sql(msg.query)
            self._prepared[handle] = (msg.query, fp)
            self._pin_fingerprint(fp)
            while len(self._prepared) > self._prepared_cap:
                # handle-table eviction must release the scheduler-side pin
                # too: a crashed client pool (never Closes) otherwise leaks
                # plan-cache pins until the cache can no longer evict
                _, (_, old_fp) = self._prepared.popitem(last=False)
                self._unpin_fingerprint(old_fp)
            schema = self._dataset_schema(msg.query)
            result = fsql.ActionCreatePreparedStatementResult(
                prepared_statement_handle=handle,
                dataset_schema=schema.serialize().to_pybytes() if schema else b"",
                parameter_schema=pa.schema([]).serialize().to_pybytes(),
            )
            yield pack_any(result)
        elif action.type == "ClosePreparedStatement":
            name, msg = _try_unpack(action.body.to_pybytes())
            if name != "ActionClosePreparedStatementRequest":
                raise flight.FlightServerError("bad ClosePreparedStatement body")
            entry = self._prepared.pop(msg.prepared_statement_handle, None)
            if entry is not None:
                self._unpin_fingerprint(entry[1])
            yield b""
        else:
            raise flight.FlightServerError(f"unknown action {action.type!r}")

    def list_actions(self, context):
        return [
            ("register_parquet", "register a parquet table"),
            ("handshake", "get a token"),
            ("CreatePreparedStatement", "Flight SQL prepared statement"),
            ("ClosePreparedStatement", "Flight SQL prepared statement"),
        ]

    def _dataset_schema(self, sql: str) -> Optional[pa.Schema]:
        """Result schema WITHOUT executing (prepared-statement metadata)."""
        try:
            from ballista_tpu_torch.sql.parser import parse_sql
            from ballista_tpu_torch.sql.planner import SqlPlanner

            plan = SqlPlanner(self.catalog.schemas()).plan(parse_sql(sql))
            return plan.schema().to_arrow()
        except Exception:  # noqa: BLE001 - schema is advisory metadata
            return None

    # ---- query path ----------------------------------------------------------------
    def get_flight_info(self, context, descriptor: flight.FlightDescriptor):
        name, msg = _try_unpack(descriptor.command)
        if name is None:
            # ad-hoc pyarrow clients: plain SQL bytes in the descriptor
            return self._statement_info(descriptor, descriptor.command.decode())
        if name == "CommandStatementQuery":
            return self._statement_info(descriptor, msg.query)
        if name == "CommandPreparedStatementQuery":
            entry = self._prepared.get(msg.prepared_statement_handle)
            if entry is None:
                raise flight.FlightServerError("unknown prepared statement handle")
            sql, fp = entry
            # executions bind straight to the cached template: the prepare-
            # time fingerprint rides the submit, no re-normalization
            return self._statement_info(descriptor, sql, fingerprint=fp)
        if name in ("CommandGetCatalogs", "CommandGetDbSchemas",
                    "CommandGetTables", "CommandGetTableTypes",
                    "CommandGetSqlInfo", "CommandGetPrimaryKeys",
                    "CommandGetExportedKeys", "CommandGetImportedKeys",
                    "CommandGetXdbcTypeInfo"):
            table = self._metadata_table(name, msg)
            handle = uuid.uuid4().hex
            self._store_result(handle, [("table", table, None)])
            ticket = flight.Ticket(
                pack_any(fsql.TicketStatementQuery(statement_handle=f"{handle}:0".encode()))
            )
            return flight.FlightInfo(
                table.schema, descriptor, [flight.FlightEndpoint(ticket, [])],
                table.num_rows, -1,
            )
        raise flight.FlightServerError(f"unsupported Flight SQL command {name}")

    def _statement_info(
        self, descriptor, sql: str, fingerprint: Optional[str] = None
    ) -> flight.FlightInfo:
        # sealed-result cache: an identical (normalized) statement against an
        # unchanged catalog returns the cached Arrow table without submitting
        # a job — no executor is touched (docs/serving.md)
        rkey = None
        if self.result_cache_enabled:
            if fingerprint is None:
                from ballista_tpu_torch.scheduler.serving import fingerprint_sql

                fingerprint = fingerprint_sql(sql)
            rkey = (fingerprint, self.catalog.version)
            cached = self.result_cache.get(rkey)
            if cached is not None:
                handle = uuid.uuid4().hex
                self._store_result(handle, [("table", cached, None)])
                ticket = flight.Ticket(pack_any(
                    fsql.TicketStatementQuery(statement_handle=f"{handle}:0".encode())
                ))
                return flight.FlightInfo(
                    cached.schema, descriptor,
                    [flight.FlightEndpoint(ticket, [])],
                    cached.num_rows, -1,
                )
        status = self._run(sql)
        schema = schema_from_json(json.loads(status.result_schema.decode())).to_arrow()
        handle = uuid.uuid4().hex
        parts = []
        endpoints = []
        for i, loc in enumerate(status.partition_locations):
            d = {
                "path": loc.path,
                "host": loc.host,
                "flight_port": loc.flight_port,
                "executor_id": loc.executor_id,
                "stage_id": loc.partition.stage_id,
                "map_partition": loc.map_partition,
            }
            parts.append(("loc", d, schema))
            if self.executor_endpoints and loc.host and loc.flight_port:
                # direct data plane: the ticket is the executor Flight
                # server's native FetchPartition form ({"path": ...} — extra
                # keys ignored), so a spec-following client fetches the
                # partition straight from the executor at `locations`; a
                # client that ignores locations and do_gets here instead
                # hits this service's JSON-ticket fallback (same payload).
                # The declared result schema rides along: shuffle files can
                # store narrower types than the advertised FlightInfo schema
                import base64

                t = dict(d, schema=base64.b64encode(
                    schema.serialize().to_pybytes()).decode())
                ticket = flight.Ticket(json.dumps(t).encode())
                locs = [flight.Location.for_grpc_tcp(loc.host, loc.flight_port)]
                if self._self_location is not None:
                    # second location = this service: if the executor is
                    # preempted between job success and the fetch, the client
                    # retries here and the proxy path's object-store fallback
                    # still satisfies the read
                    locs.append(self._self_location)
                endpoints.append(flight.FlightEndpoint(ticket, locs))
            else:
                ticket = flight.Ticket(
                    pack_any(fsql.TicketStatementQuery(statement_handle=f"{handle}:{i}".encode()))
                )
                endpoints.append(flight.FlightEndpoint(ticket, []))
        self._store_result(handle, parts)
        if rkey is not None:
            self._maybe_cache_result(rkey, status, schema)
        return flight.FlightInfo(schema, descriptor, endpoints, -1, -1)

    def _maybe_cache_result(self, rkey, status, schema: pa.Schema) -> None:
        """Seal a small finished result into the cache: materialize the
        partitions (cast to the declared schema — byte-identical to what a
        client assembles from the endpoints) when the producers' byte
        accounting fits the per-entry bound."""
        est = sum(loc.num_bytes for loc in status.partition_locations)
        if est > self.result_cache.max_entry_bytes:
            self.result_cache.oversize_skips += 1
            return
        locs = [
            {
                "path": loc.path, "host": loc.host,
                "flight_port": loc.flight_port,
                "executor_id": loc.executor_id,
                "stage_id": loc.partition.stage_id,
                "map_partition": loc.map_partition,
            }
            for loc in status.partition_locations
        ]
        try:
            batches = list(_location_batches(locs, schema, self.object_store_url))
            table = (
                pa.Table.from_batches(batches, schema=schema)
                if batches else schema.empty_table()
            )
        except Exception:  # noqa: BLE001 - sealing is an optimization; the
            # client still has the endpoints (e.g. a producer was preempted
            # between job success and this read)
            return
        self.result_cache.put(rkey, table)

    def _metadata_table(self, name: str, msg) -> pa.Table:
        """Catalog metadata results with the Flight SQL spec schemas.

        Catalog/schema filter fields are honored (a JDBC tool browsing
        another catalog gets an EMPTY result, not ours); the key-metadata
        and type-info commands return empty tables with the spec columns —
        this engine tracks no PK/FK constraints, and JDBC clients expect an
        empty result set, not an error (flight_sql.rs does the same).
        """

        def like(pat: str):
            # SQL LIKE pattern -> anchored regex; everything else literal
            return re.compile(
                "^" + "".join(
                    ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
                    for ch in pat
                ) + "$"
            )

        def catalog_matches() -> bool:
            c = getattr(msg, "catalog", "")
            return not c or c == CATALOG_NAME

        def schema_matches() -> bool:
            pat = getattr(msg, "db_schema_filter_pattern", "")
            return not pat or bool(like(pat).match(SCHEMA_NAME))

        import re

        if name == "CommandGetCatalogs":
            return pa.table({"catalog_name": [CATALOG_NAME]})
        if name == "CommandGetDbSchemas":
            ok = catalog_matches() and schema_matches()
            # explicit utf8 schema: pa.table infers null-typed columns from
            # empty python lists, and the result schema must not depend on
            # whether the filter matched
            return pa.table(
                {
                    "catalog_name": [CATALOG_NAME] if ok else [],
                    "db_schema_name": [SCHEMA_NAME] if ok else [],
                },
                schema=pa.schema(
                    [("catalog_name", pa.string()), ("db_schema_name", pa.string())]
                ),
            )
        if name == "CommandGetTableTypes":
            return pa.table({"table_type": ["TABLE"]})
        if name == "CommandGetSqlInfo":
            return self._sql_info_table(list(msg.info))
        if name in ("CommandGetPrimaryKeys", "CommandGetExportedKeys",
                    "CommandGetImportedKeys"):
            # spec field ORDER matters: drivers read these positionally
            if name == "CommandGetPrimaryKeys":
                spec = [("catalog_name", pa.string()), ("db_schema_name", pa.string()),
                        ("table_name", pa.string()), ("column_name", pa.string()),
                        ("key_sequence", pa.int32()), ("key_name", pa.string())]
            else:
                spec = [("pk_catalog_name", pa.string()), ("pk_db_schema_name", pa.string()),
                        ("pk_table_name", pa.string()), ("pk_column_name", pa.string()),
                        ("fk_catalog_name", pa.string()), ("fk_db_schema_name", pa.string()),
                        ("fk_table_name", pa.string()), ("fk_column_name", pa.string()),
                        ("key_sequence", pa.int32()), ("fk_key_name", pa.string()),
                        ("pk_key_name", pa.string()),
                        ("update_rule", pa.uint8()), ("delete_rule", pa.uint8())]
            return pa.table({f: pa.array([], t) for f, t in spec},
                            schema=pa.schema(spec))
        if name == "CommandGetXdbcTypeInfo":
            return pa.table({
                "type_name": pa.array([], pa.string()),
                "data_type": pa.array([], pa.int32()),
                "column_size": pa.array([], pa.int32()),
                "nullable": pa.array([], pa.int32()),
                "searchable": pa.array([], pa.int32()),
            })
        # CommandGetTables
        if not (catalog_matches() and schema_matches()):
            names = []
        else:
            rx = like(msg.table_name_filter_pattern or "%")
            names = [t for t in sorted(self.catalog.tables) if rx.match(t)]
        if msg.table_types and "TABLE" not in msg.table_types:
            names = []
        cols = {
            "catalog_name": [CATALOG_NAME] * len(names),
            "db_schema_name": [SCHEMA_NAME] * len(names),
            "table_name": names,
            "table_type": ["TABLE"] * len(names),
        }
        if msg.include_schema:
            cols["table_schema"] = [
                self.catalog.tables[t].schema.to_arrow().serialize().to_pybytes()
                for t in names
            ]
        return pa.table(cols)

    def _sql_info_table(self, wanted: list[int]) -> pa.Table:
        """GetSqlInfo result: info_name uint32 + dense-union value (the spec
        schema); string/bool members only — enough for JDBC driver startup.
        Info ids are the public spec values: 0=SERVER_NAME, 1=SERVER_VERSION,
        2=SERVER_ARROW_VERSION, 3=SERVER_READ_ONLY, 4=SERVER_SQL."""
        from ballista_tpu_torch import __version__

        strings = {0: "ballista-tpu", 1: __version__, 2: pa.__version__}
        bools = {3: True, 4: True}  # read-only over Flight SQL; SQL supported
        items = [(k, "s", v) for k, v in strings.items()]
        items += [(k, "b", v) for k, v in bools.items()]
        if wanted:
            items = [it for it in items if it[0] in wanted]
        items.sort()
        type_ids, offsets, svals, bvals = [], [], [], []
        for _, kind, v in items:
            if kind == "s":
                type_ids.append(0)
                offsets.append(len(svals))
                svals.append(v)
            else:
                type_ids.append(1)
                offsets.append(len(bvals))
                bvals.append(v)
        value = pa.UnionArray.from_dense(
            pa.array(type_ids, pa.int8()),
            pa.array(offsets, pa.int32()),
            [pa.array(svals, pa.string()), pa.array(bvals, pa.bool_())],
            ["string_value", "bool_value"],
        )
        return pa.table({
            "info_name": pa.array([it[0] for it in items], pa.uint32()),
            "value": value,
        })

    def do_get(self, context, ticket: flight.Ticket):
        name, msg = _try_unpack(ticket.ticket)
        if name == "TicketStatementQuery":
            try:
                handle, _, idx = msg.statement_handle.decode().partition(":")
                parts = self._results.get(handle)
                if parts is None:
                    raise KeyError(handle)
                kind, value, schema = parts[int(idx or 0)]
            except (KeyError, ValueError, IndexError, UnicodeDecodeError):
                raise flight.FlightServerError("unknown statement handle")
            if kind == "table":
                return flight.RecordBatchStream(value)
            # spill-capable: stream record batches straight off the shuffle
            # files (remote pieces spill to disk) — the scheduler never holds
            # a whole result partition in memory (shuffle_reader.rs:136)
            return flight.GeneratorStream(
                schema, _location_batches([value], schema, self.object_store_url)
            )
        loc = json.loads(ticket.ticket.decode())
        if "sql" in loc:
            # convenience: direct SQL ticket without get_flight_info
            status = self._run(loc["sql"])
            schema = schema_from_json(json.loads(status.result_schema.decode())).to_arrow()
            locs = [
                {
                    "path": l.path, "host": l.host, "flight_port": l.flight_port,
                    "executor_id": l.executor_id,
                    "stage_id": l.partition.stage_id,
                    "map_partition": l.map_partition,
                }
                for l in status.partition_locations
            ]
            return flight.GeneratorStream(
                schema, _location_batches(locs, schema, self.object_store_url)
            )
        # a single partition ticket from get_flight_info
        table = read_shuffle_partition_to_table(loc, self.object_store_url)
        from ballista_tpu_torch.shuffle.flight import maybe_cast_to_ticket_schema

        table = maybe_cast_to_ticket_schema(table, loc)
        return flight.RecordBatchStream(table)

    def _run(self, sql: str, timeout_s: Optional[float] = None):
        if timeout_s is None:
            timeout_s = self.query_timeout_s
        table_defs = [
            json.dumps(meta.to_dict()).encode()
            for meta in self.catalog.tables.values()
            if meta.format == "parquet"
        ]
        # NOTE: the prepare-time fingerprint is deliberately NOT forwarded as
        # a cache key — the scheduler derives the identical value from the
        # SQL itself (the plan cache is shared across sessions; honoring a
        # caller-supplied key would be a poisoning vector). It still keys
        # this service's result cache and the plan-cache pin.
        result = self.scheduler.execute_query(
            pb.ExecuteQueryParams(sql=sql, table_defs=table_defs), None
        )
        deadline = time.time() + timeout_s
        while True:
            status = self.scheduler.get_job_status(
                pb.GetJobStatusParams(job_id=result.job_id), None
            ).status
            if status.state == "SUCCESSFUL":
                return status
            if status.state in ("FAILED", "CANCELLED"):
                raise flight.FlightServerError(f"job {result.job_id}: {status.error}")
            if time.time() > deadline:
                # clean CANCELLED, not a bare exception: the job is actually
                # cancelled (no orphaned tasks burning slots) and the error
                # names the knob that fired
                try:
                    self.scheduler.cancel_job(
                        pb.CancelJobParams(job_id=result.job_id), None
                    )
                except Exception:  # noqa: BLE001 - cancellation best-effort
                    pass
                raise flight.FlightCancelledError(
                    f"job {result.job_id} CANCELLED: exceeded "
                    f"ballista.client.query_timeout_s={timeout_s:g}s"
                )
            time.sleep(0.05)

    def serve_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve, daemon=True, name="flight-sql")
        t.start()
        return t


def _location_batches(locs: list[dict], schema: pa.Schema,
                      object_store_url: str = ""):
    """Generator of record batches over result partitions, casting to the
    declared result schema (shuffle files can carry narrower parquet types)."""
    from ballista_tpu_torch.shuffle.stream import iter_shuffle_arrow

    for loc in locs:
        for rb in iter_shuffle_arrow([loc], object_store_url=object_store_url):
            if rb.schema != schema:
                rb = pa.Table.from_batches([rb]).cast(schema).to_batches()[0]
            yield rb


def read_shuffle_partition_to_table(loc: dict, object_store_url: str = "") -> pa.Table:
    from ballista_tpu_torch.shuffle.flight import fetch_partition
    from ballista_tpu_torch.shuffle.writer import read_ipc_file
    import os

    if loc.get("path") and os.path.exists(loc["path"]):
        return read_ipc_file(loc["path"])
    return fetch_partition(
        loc["host"], loc["flight_port"], loc["path"], loc.get("executor_id", ""),
        loc.get("stage_id", 0), loc.get("map_partition", 0), object_store_url,
    )
