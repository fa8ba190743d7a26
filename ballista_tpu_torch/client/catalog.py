"""Table catalog: schema + file listing + basic statistics.

Reference analog: the client-side table registry in ``BallistaContext``
(``arrow-ballista: ballista/client/src/context.rs:85-475``) plus DataFusion's
listing-table provider. One scan partition per file group (tuning-guide.md:
file count determines scan parallelism).
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import pyarrow.parquet as pq

from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan.schema import Schema


@dataclass
class TableMeta:
    name: str
    schema: Schema
    format: str  # parquet | memory
    file_groups: list[list[str]] = field(default_factory=list)
    partitions: list[Any] = field(default_factory=list)  # memory tables
    num_rows: int = 0
    # catalog-shared string dictionaries (docs/strings.md): column name ->
    # dict_id installed in the process-wide registry at registration time.
    # Declined columns (oversized / build failure) record the reason instead
    # — surfaced by the plan verifier and EXPLAIN VERIFY.
    dict_refs: dict[str, str] = field(default_factory=dict)
    dict_declines: dict[str, str] = field(default_factory=dict)
    # leaf-stage row estimates (docs/shuffle.md): per-file row counts and
    # row-group counts from parquet footers at registration. The planner
    # stamps per-GROUP row totals onto ParquetScanExec so the scheduler's
    # precompile hints and the pipelined-shuffle estimator can size
    # leaf-scan consumers without executing anything.
    file_rows: dict[str, int] = field(default_factory=dict)
    file_row_groups: dict[str, int] = field(default_factory=dict)

    def group_row_counts(self) -> Optional[list[int]]:
        """Rows per scan file group, or None when any file is unknown."""
        if not self.file_groups or not self.file_rows:
            return None
        out = []
        for grp in self.file_groups:
            if any(f not in self.file_rows for f in grp):
                return None
            out.append(sum(self.file_rows[f] for f in grp))
        return out

    def to_dict(self) -> dict:
        assert self.format == "parquet", "only file-backed tables serialize"
        out = {
            "name": self.name,
            "format": self.format,
            "file_groups": self.file_groups,
            "num_rows": self.num_rows,
            "schema": [(f.name, f.dtype.value, f.nullable) for f in self.schema],
        }
        if self.file_rows:
            out["file_rows"] = dict(self.file_rows)
        if self.file_row_groups:
            out["file_row_groups"] = dict(self.file_row_groups)
        if self.dict_refs:
            from ballista_tpu_torch.engine.dictionaries import REGISTRY

            # ship values with the refs: the scheduler (a different process)
            # must be able to serialize them into stage plans for executors
            out["dict_refs"] = dict(self.dict_refs)
            out["dicts"] = {
                did: REGISTRY.get(did).tolist()
                for did in self.dict_refs.values()
                if REGISTRY.get(did) is not None
            }
        if self.dict_declines:
            out["dict_declines"] = dict(self.dict_declines)
        return out

    @staticmethod
    def from_dict(d: dict) -> "TableMeta":
        from ballista_tpu_torch.plan.schema import DataType, Field

        schema = Schema(tuple(Field(n, DataType(t), nl) for n, t, nl in d["schema"]))
        refs = dict(d.get("dict_refs") or {})
        if refs:
            from ballista_tpu_torch.engine.dictionaries import REGISTRY

            dicts = d.get("dicts") or {}
            for col, did in list(refs.items()):
                if did in dicts:
                    REGISTRY.ensure(did, dicts[did])
                elif REGISTRY.get(did) is None:
                    refs.pop(col)  # values never arrived: drop the ref
        return TableMeta(
            d["name"], schema, d["format"], [list(g) for g in d["file_groups"]],
            [], d["num_rows"], refs, dict(d.get("dict_declines") or {}),
            {k: int(v) for k, v in (d.get("file_rows") or {}).items()},
            {k: int(v) for k, v in (d.get("file_row_groups") or {}).items()},
        )


class Catalog:
    def __init__(self, config=None):
        self.tables: dict[str, TableMeta] = {}
        # monotonic (de)registration counter: the serving layer's cache keys
        # carry it, so register/deregister invalidates every cached plan and
        # sealed result derived from the previous table set (docs/serving.md)
        self.version = 0
        # knob source for shared-dictionary builds (docs/strings.md); None =
        # registered defaults (shared dicts ON, max_dict_size 65536)
        self.config = config

    def _build_dicts(self, meta: TableMeta, string_chunks) -> None:
        """Build + register the shared string dictionaries for a just-
        registered table (docs/strings.md). Never fails registration."""
        from ballista_tpu_torch.engine.dictionaries import (
            build_table_dictionaries,
            default_knobs,
        )

        enabled, max_size = default_knobs(self.config)
        if not enabled:
            return
        try:
            meta.dict_refs, meta.dict_declines = build_table_dictionaries(
                meta.name, meta.schema, self.version + 1, string_chunks, max_size
            )
        except Exception:  # noqa: BLE001 - dictionaries are an optimization
            import logging

            logging.getLogger("ballista.dicts").warning(
                "shared dictionary build for table %s failed", meta.name,
                exc_info=True,
            )

    def register_parquet(
        self, name: str, path: str, target_partitions: Optional[int] = None
    ) -> TableMeta:
        name = name.lower()
        if "://" in path:
            # object-store URL (gs://, s3://, hdfs://): resolve via the registry
            from ballista_tpu_torch.utils.object_store import list_parquet_files

            _, files = list_parquet_files(path)
        elif os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "*.parquet")))
        else:
            files = sorted(glob.glob(path)) if any(c in path for c in "*?[") else [path]
        if not files:
            raise PlanningError(f"no parquet files at {path!r}")

        def _pf(f: str) -> pq.ParquetFile:
            if "://" in f:
                from ballista_tpu_torch.utils.object_store import GLOBAL_OBJECT_STORES

                fs, p = GLOBAL_OBJECT_STORES.resolve(f)
                return pq.ParquetFile(fs.open_input_file(p))
            return pq.ParquetFile(f)

        schema = Schema.from_arrow(_pf(files[0]).schema_arrow)
        # per-file row + row-group counts off the parquet footers (already
        # open for the schema/row total): exact leaf-scan cardinality the
        # scheduler's precompile hints and pending-piece estimates consume
        file_rows: dict[str, int] = {}
        file_row_groups: dict[str, int] = {}
        num_rows = 0
        for f in files:
            md = _pf(f).metadata
            file_rows[f] = md.num_rows
            file_row_groups[f] = md.num_row_groups
            num_rows += md.num_rows
        # one partition per file unless asked to re-group
        if target_partitions and target_partitions < len(files):
            groups: list[list[str]] = [[] for _ in range(target_partitions)]
            for i, f in enumerate(files):
                groups[i % target_partitions].append(f)
        else:
            groups = [[f] for f in files]
        meta = TableMeta(name, schema, "parquet", groups, [], num_rows,
                         file_rows=file_rows, file_row_groups=file_row_groups)

        def string_chunks(col: str):
            # row-group-sized column-projected reads: the oversize bail fires
            # after ~max_dict_size distinct values regardless of file layout
            # (a single-file comments column must not be read whole just to
            # discover its decline)
            for f in files:
                for rb in _pf(f).iter_batches(columns=[col], batch_size=65536):
                    yield rb.column(0)

        self._build_dicts(meta, string_chunks)
        self.tables[name] = meta
        self.version += 1
        return meta

    def register_csv(
        self,
        name: str,
        path: str,
        has_header: bool = True,
        delimiter: str = ",",
        schema: Optional[Schema] = None,
        target_partitions: Optional[int] = None,
    ) -> TableMeta:
        """CSV listing table: read eagerly into memory partitions (reference:
        ``register_csv``/``read_csv``; CSV has no row-group structure to scan
        lazily, and the reference also materializes per-task)."""
        import pyarrow.csv as pacsv

        name = name.lower()
        if os.path.isdir(path):
            files = sorted(
                glob.glob(os.path.join(path, "*.csv")) + glob.glob(os.path.join(path, "*.tbl"))
            )
        else:
            files = sorted(glob.glob(path)) if any(c in path for c in "*?[") else [path]
        if not files:
            raise PlanningError(f"no csv files at {path!r}")
        read_opts = pacsv.ReadOptions(autogenerate_column_names=not has_header)
        if schema is not None and not has_header:
            read_opts = pacsv.ReadOptions(column_names=schema.names)
        parse_opts = pacsv.ParseOptions(delimiter=delimiter)
        convert = (
            pacsv.ConvertOptions(column_types=schema.to_arrow()) if schema is not None else None
        )
        from ballista_tpu_torch.ops.batch import ColumnBatch

        parts = []
        out_schema = schema
        for f in files:
            table = pacsv.read_csv(
                f, read_options=read_opts, parse_options=parse_opts, convert_options=convert
            )
            b = ColumnBatch.from_arrow(table)
            out_schema = out_schema or b.schema
            parts.append(b)
        return self.register_batches(name, parts, out_schema)

    def register_json(self, name: str, path: str) -> TableMeta:
        """Newline-delimited JSON (reference: read_json)."""
        import pyarrow.json as pajson

        from ballista_tpu_torch.ops.batch import ColumnBatch

        files = sorted(glob.glob(os.path.join(path, "*.json"))) if os.path.isdir(path) else [path]
        if not files:
            raise PlanningError(f"no json files at {path!r}")
        parts = [ColumnBatch.from_arrow(pajson.read_json(f)) for f in files]
        return self.register_batches(name, parts, parts[0].schema)

    def register_avro(self, name: str, path: str) -> TableMeta:
        """Avro object container files (reference: context.rs read_avro);
        decoded by the built-in reader (utils/avro.py — null/deflate codecs,
        records over primitives, nullable unions, date logical type).
        Accepts a file, a directory, a glob, or an object-store URL."""
        from ballista_tpu_torch.ops.batch import ColumnBatch
        from ballista_tpu_torch.utils.avro import read_avro_bytes

        try:
            if "://" in path:
                from ballista_tpu_torch.utils.object_store import GLOBAL_OBJECT_STORES

                fs, p = GLOBAL_OBJECT_STORES.resolve(path)
                import pyarrow.fs as pafs

                info = fs.get_file_info(p)
                if info.type == pafs.FileType.Directory:
                    sel = pafs.FileSelector(p, recursive=False)
                    files = sorted(
                        f.path for f in fs.get_file_info(sel)
                        if f.type == pafs.FileType.File and f.path.endswith(".avro")
                    )
                else:
                    files = [p]
                if not files:
                    raise PlanningError(f"no avro files at {path!r}")
                parts = []
                for f in files:
                    with fs.open_input_stream(f) as src:
                        parts.append(ColumnBatch.from_arrow(read_avro_bytes(src.read())))
            else:
                if os.path.isdir(path):
                    files = sorted(glob.glob(os.path.join(path, "*.avro")))
                elif any(ch in path for ch in "*?["):
                    files = sorted(glob.glob(path))
                else:
                    files = [path]
                if not files:
                    raise PlanningError(f"no avro files at {path!r}")
                parts = [
                    ColumnBatch.from_arrow(read_avro_bytes(open(f, "rb").read()))
                    for f in files
                ]
        except PlanningError:
            raise
        except Exception as e:  # noqa: BLE001 - surface as a planning error
            raise PlanningError(f"cannot read avro at {path!r}: {e}") from e
        return self.register_batches(name, parts, parts[0].schema)

    def register_batches(self, name: str, partitions: list[Any], schema: Schema) -> TableMeta:
        from ballista_tpu_torch.plan.schema import DataType

        name = name.lower()
        rows = sum(len(p) for p in partitions)
        meta = TableMeta(name, schema, "memory", [], partitions, rows)

        def string_chunks(col: str):
            for p in partitions:
                yield p.column(col).data

        self._build_dicts(meta, string_chunks)
        # tag the stored partitions so the memory scan's Columns carry the
        # reference at runtime (the parquet scan reads its refs off the plan)
        for p in partitions:
            for f, c in zip(p.schema, p.columns):
                if f.dtype is DataType.STRING and f.name in meta.dict_refs:
                    c.dict_id = meta.dict_refs[f.name]
        self.tables[name] = meta
        self.version += 1
        return meta

    def deregister(self, name: str) -> bool:
        if self.tables.pop(name.lower(), None) is None:
            return False
        self.version += 1
        return True

    def get(self, name: str) -> TableMeta:
        if name.lower() not in self.tables:
            raise PlanningError(f"table {name!r} not found")
        return self.tables[name.lower()]

    def schemas(self) -> dict[str, Schema]:
        return {n: t.schema for n, t in self.tables.items()}

    def names(self) -> list[str]:
        return sorted(self.tables)
