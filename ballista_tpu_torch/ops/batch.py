"""ColumnBatch: the in-memory columnar unit exchanged between operators.

Reference analog: Arrow ``RecordBatch`` flowing through DataFusion operators and
Ballista's shuffle (``arrow-ballista: ballista/core/src/execution_plans/shuffle_writer.rs:174-336``).
Here the host-side representation is hybrid, chosen for the TPU execution model:

* fixed-width columns (ints, floats, dates, bools) are numpy arrays — a device
  stage encodes them and copies them to the device as torch tensors;
* string columns stay as ``pyarrow`` arrays — they never live on device; device
  programs see them dictionary-encoded (codes) or hashed (join/group keys), and
  string-valued predicates are pre-evaluated host-side by the scan operator.

Null handling: numeric columns carry an optional boolean validity mask
(``None`` == all valid); string columns use Arrow's own validity.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Union

import numpy as np
import pyarrow as pa

from ballista_tpu_torch.plan.schema import DataType, Field, Schema

ArrayLike = Union[np.ndarray, pa.Array]


def _is_string_col(dtype: DataType) -> bool:
    return dtype is DataType.STRING


@dataclass
class Column:
    dtype: DataType
    data: ArrayLike                      # numpy for fixed-width, pa.Array for strings
    valid: Optional[np.ndarray] = None   # bool mask for numpy-backed columns; None = all valid
    # catalog-shared dictionary reference (docs/strings.md): set by scans on
    # string columns whose table registered a shared dictionary; selection
    # ops propagate it, computed strings drop it. The values stay a plain
    # pa.Array — the id only pins WHICH dictionary leaf encodes and the
    # shuffle wire may use for stable int32 codes.
    dict_id: Optional[str] = None

    def __post_init__(self):
        if not _is_string_col(self.dtype):
            self.dict_id = None
        if _is_string_col(self.dtype):
            if isinstance(self.data, pa.ChunkedArray):
                self.data = self.data.combine_chunks()
            if isinstance(self.data, np.ndarray):
                self.data = pa.array(self.data.tolist(), type=pa.string())
            assert self.valid is None, "string columns carry validity in arrow"
        else:
            if isinstance(self.data, (pa.Array, pa.ChunkedArray)):
                arr = self.data.combine_chunks() if isinstance(self.data, pa.ChunkedArray) else self.data
                np_valid = None
                if arr.null_count:
                    np_valid = np.asarray(arr.is_valid())
                    arr = arr.fill_null(0)
                self.data = np.asarray(arr.cast(self.dtype.to_arrow())).astype(
                    self.dtype.to_numpy(), copy=False
                )
                self.valid = np_valid
            else:
                self.data = np.asarray(self.data).astype(self.dtype.to_numpy(), copy=False)

    def __len__(self) -> int:
        return len(self.data)

    # ---- selection --------------------------------------------------------------
    def take(self, indices: np.ndarray) -> "Column":
        if _is_string_col(self.dtype):
            return Column(self.dtype, self.data.take(pa.array(indices)),
                          dict_id=self.dict_id)
        valid = self.valid[indices] if self.valid is not None else None
        return Column(self.dtype, self.data[indices], valid)

    def filter(self, mask: np.ndarray) -> "Column":
        if _is_string_col(self.dtype):
            return Column(self.dtype, self.data.filter(pa.array(mask)),
                          dict_id=self.dict_id)
        valid = self.valid[mask] if self.valid is not None else None
        return Column(self.dtype, self.data[mask], valid)

    def slice(self, offset: int, length: int) -> "Column":
        if _is_string_col(self.dtype):
            return Column(self.dtype, self.data.slice(offset, length),
                          dict_id=self.dict_id)
        valid = self.valid[offset : offset + length] if self.valid is not None else None
        return Column(self.dtype, self.data[offset : offset + length], valid)

    # ---- conversions ------------------------------------------------------------
    def to_arrow(self) -> pa.Array:
        if _is_string_col(self.dtype):
            return self.data
        arr = pa.array(self.data, type=self.dtype.to_arrow())
        if self.valid is not None:
            arr = pa.array(self.data, type=self.dtype.to_arrow(), mask=~self.valid)
        return arr

    @staticmethod
    def from_arrow(arr: Union[pa.Array, pa.ChunkedArray]) -> "Column":
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if pa.types.is_dictionary(arr.type):
            arr = arr.cast(arr.type.value_type)
        dtype = DataType.from_arrow(arr.type)
        return Column(dtype, arr if dtype is DataType.STRING else arr)

    @staticmethod
    def concat(cols: Sequence["Column"]) -> "Column":
        dtype = cols[0].dtype
        if _is_string_col(dtype):
            ids = {c.dict_id for c in cols}
            shared = ids.pop() if len(ids) == 1 else None
            return Column(dtype, pa.concat_arrays([c.data for c in cols]),
                          dict_id=shared)
        data = np.concatenate([c.data for c in cols])
        if any(c.valid is not None for c in cols):
            valid = np.concatenate(
                [c.valid if c.valid is not None else np.ones(len(c), bool) for c in cols]
            )
        else:
            valid = None
        return Column(dtype, data, valid)

    def null_count(self) -> int:
        if _is_string_col(self.dtype):
            return self.data.null_count
        return 0 if self.valid is None else int((~self.valid).sum())


class ColumnBatch:
    """A schema plus equal-length columns; the unit of exchange between operators."""

    _uid_counter = itertools.count()

    def __init__(self, schema: Schema, columns: Sequence[Column], num_rows: Optional[int] = None):
        assert len(schema) == len(columns), (schema, len(columns))
        # process-unique identity token for content caches: unlike id(), never
        # reused after the batch is garbage-collected
        self.uid = next(ColumnBatch._uid_counter)
        self.schema = schema
        self.columns = list(columns)
        if columns:
            self.num_rows = len(columns[0])
        else:
            self.num_rows = num_rows or 0  # zero-column relations (SELECT 1)
        for c in self.columns:
            assert len(c) == self.num_rows

    # ---- accessors --------------------------------------------------------------
    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def __len__(self) -> int:
        return self.num_rows

    # ---- construction -----------------------------------------------------------
    @staticmethod
    def from_arrow(table: Union[pa.Table, pa.RecordBatch]) -> "ColumnBatch":
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        schema = Schema.from_arrow(table.schema)
        cols = []
        for f, col in zip(schema, table.columns):
            arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
            if pa.types.is_dictionary(arr.type):
                arr = arr.cast(arr.type.value_type)
            if f.dtype is DataType.STRING:
                cols.append(Column(f.dtype, arr.cast(pa.string())))
            else:
                cols.append(Column(f.dtype, arr))
        return ColumnBatch(schema, cols)

    @staticmethod
    def from_dict(data: dict, schema: Optional[Schema] = None) -> "ColumnBatch":
        if schema is None:
            fields, cols = [], []
            for name, arr in data.items():
                if isinstance(arr, Column):
                    c = arr
                elif isinstance(arr, (pa.Array, pa.ChunkedArray)):
                    c = Column.from_arrow(arr)
                else:
                    arr = np.asarray(arr)
                    if arr.dtype == object or arr.dtype.kind in "US":
                        c = Column(DataType.STRING, pa.array(arr.tolist(), type=pa.string()))
                    else:
                        dt = DataType.from_arrow(pa.from_numpy_dtype(arr.dtype))
                        c = Column(dt, arr)
                fields.append(Field(name, c.dtype))
                cols.append(c)
            return ColumnBatch(Schema(tuple(fields)), cols)
        cols = []
        for f in schema:
            arr = data[f.name]
            cols.append(arr if isinstance(arr, Column) else Column(f.dtype, arr))
        return ColumnBatch(schema, cols)

    @staticmethod
    def empty(schema: Schema) -> "ColumnBatch":
        cols = [
            Column(f.dtype, pa.array([], type=pa.string()))
            if f.dtype is DataType.STRING
            else Column(f.dtype, np.empty(0, f.dtype.to_numpy()))
            for f in schema
        ]
        return ColumnBatch(schema, cols)

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"]) -> "ColumnBatch":
        batches = list(batches)
        assert batches
        if len(batches) == 1:
            return batches[0]
        schema = batches[0].schema
        cols = [
            Column.concat([b.columns[i] for b in batches]) for i in range(len(schema))
        ]
        return ColumnBatch(schema, cols)

    # ---- selection --------------------------------------------------------------
    def take(self, indices: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.schema, [c.take(indices) for c in self.columns])

    def filter(self, mask: np.ndarray) -> "ColumnBatch":
        return ColumnBatch(self.schema, [c.filter(mask) for c in self.columns])

    def slice(self, offset: int, length: int) -> "ColumnBatch":
        length = min(length, self.num_rows - offset)
        return ColumnBatch(self.schema, [c.slice(offset, length) for c in self.columns])

    def select(self, names: list[str]) -> "ColumnBatch":
        return ColumnBatch(
            self.schema.select(names), [self.column(n) for n in names]
        )

    def rename(self, names: list[str]) -> "ColumnBatch":
        return ColumnBatch(self.schema.rename_all(names), self.columns)

    # ---- conversions ------------------------------------------------------------
    def to_arrow(self) -> pa.Table:
        return pa.Table.from_arrays(
            [c.to_arrow() for c in self.columns], schema=self.schema.to_arrow()
        )

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    def to_pydict(self) -> dict:
        return self.to_arrow().to_pydict()

    def nbytes(self) -> int:
        total = 0
        for c in self.columns:
            if isinstance(c.data, np.ndarray):
                total += c.data.nbytes
            else:
                total += c.data.nbytes
        return total

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"ColumnBatch({self.num_rows} rows, {self.schema})"


# ---- shuffle wire format (docs/strings.md) -----------------------------------------
# Shared-dictionary string columns travel as int32 codes + a dictionary
# reference in Arrow field metadata instead of raw string bytes: fewer bytes
# on Flight, crc over codes, and the reader restores the SAME dict_id so the
# consuming stage's leaf encode stays on the shared-dictionary path. The
# format is self-describing per column — a producer that lost the reference
# (computed strings, mixed concat) writes raw strings and the reader handles
# both, even mixed across pieces of one partition.
WIRE_DICT_META = b"ballista_dict"


def to_wire_table(
    batch: "ColumnBatch", dict_refs: Optional[dict] = None, dict_codes: bool = True,
    refs_only: bool = False,
) -> pa.Table:
    """Arrow table for the shuffle wire. With ``dict_codes``, string columns
    carrying a registered ``dict_id`` (or claimed by the plan's ``dict_refs``
    annotation — which is provably value-sound, see
    ``dictionaries.propagate_dict_refs``) are emitted as nullable int32 codes
    with the reference in field metadata; everything else is the plain
    ``to_arrow`` representation.

    ``refs_only`` restricts coding to the PLAN-claimed refs: shuffle writers
    must use it, because the consumer process installs exactly the
    dictionaries its own plan ships — a runtime-only ``dict_id`` (the
    propagation can exceed the static claim, e.g. through a join that merges
    same-named columns) would produce a code column the reader cannot
    decode."""
    def ref_of(f, c) -> Optional[str]:
        from ballista_tpu_torch.engine.dictionaries import lookup_ref

        claimed = lookup_ref(dict_refs, f.name)
        if refs_only:
            return claimed
        return c.dict_id or claimed

    if not dict_codes or not any(
        ref_of(f, c)
        for f, c in zip(batch.schema, batch.columns)
        if _is_string_col(c.dtype)
    ):
        return batch.to_arrow()
    import pyarrow.compute as pc

    fields, arrays = [], []
    for f, c in zip(batch.schema, batch.columns):
        ref = ref_of(f, c) if _is_string_col(f.dtype) else None
        if ref is not None:
            value_set = _pa_dictionary(ref)
            if value_set is not None:
                got = pc.index_in(c.data.fill_null(""), value_set=value_set)
                if got.null_count == 0:
                    codes = got.cast(pa.int32())
                    if c.data.null_count:
                        codes = pc.if_else(
                            pc.is_null(c.data), pa.scalar(None, pa.int32()), codes
                        )
                    arrays.append(codes)
                    fields.append(pa.field(
                        f.name, pa.int32(), nullable=True,
                        metadata={WIRE_DICT_META: ref.encode()},
                    ))
                    continue
                # a value outside the claimed dictionary: a propagation bug
                # upstream — fall back to raw strings rather than corrupt
                import logging

                logging.getLogger("ballista.dicts").warning(
                    "column %s claims dictionary %s but holds values outside "
                    "it; writing raw strings", f.name, ref,
                )
        arrays.append(c.to_arrow())
        fields.append(f.to_arrow())
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def _pa_dictionary(dict_id: str):
    """Registry dictionary as a memoized pyarrow string array (the index_in
    value set)."""
    from ballista_tpu_torch.engine.dictionaries import REGISTRY

    values = REGISTRY.get(dict_id)
    if values is None:
        return None
    cache = _pa_dictionary._cache
    got = cache.get(dict_id)
    if got is None:
        got = pa.array(values, type=pa.string())
        if len(cache) > 256:
            cache.clear()
        cache[dict_id] = got
    return got


_pa_dictionary._cache = {}


def wire_batches_to_columnbatch(batches: list) -> "ColumnBatch":
    """Decode a run of wire record batches into ONE ColumnBatch, tolerating
    mixed wire schemas across pieces (one producer wrote codes, another —
    e.g. an empty partition or a computed-string fallback — wrote raw
    strings): consecutive same-schema runs decode together, the decoded
    ColumnBatches concat (string columns with disagreeing dict_ids degrade
    to per-batch encoding downstream, never to wrong values)."""
    def wire_key(rb):
        # pa.Schema equality IGNORES field metadata — but the metadata IS the
        # wire format here (two code columns with different dict_ids must
        # never decode through one dictionary)
        return tuple(
            (f.name, str(f.type), tuple(sorted((f.metadata or {}).items())))
            for f in rb.schema
        )

    groups: list[list] = []
    prev_key = None
    for rb in batches:
        key = wire_key(rb)
        if groups and key == prev_key:
            groups[-1].append(rb)
        else:
            groups.append([rb])
            prev_key = key
    parts = [
        from_wire_table(pa.Table.from_batches(g, schema=g[0].schema))
        for g in groups
    ]
    return parts[0] if len(parts) == 1 else ColumnBatch.concat(parts)


def from_wire_table(table: pa.Table) -> "ColumnBatch":
    """Inverse of :func:`to_wire_table`: code columns are rebuilt as string
    Columns carrying the SAME ``dict_id`` (so downstream leaf encodes stay
    shared); plain tables pass through ``ColumnBatch.from_arrow``."""
    if not any(
        f.metadata and WIRE_DICT_META in f.metadata for f in table.schema
    ):
        return ColumnBatch.from_arrow(table)
    from ballista_tpu_torch.plan.schema import DataType as DT, Field as F, Schema as S

    fields, cols = [], []
    for f, col in zip(table.schema, table.columns):
        arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
        meta = f.metadata or {}
        if WIRE_DICT_META in meta:
            dict_id = meta[WIRE_DICT_META].decode()
            value_set = _pa_dictionary(dict_id)
            if value_set is None:
                from ballista_tpu_torch.errors import ExecutionError

                raise ExecutionError(
                    f"shuffle piece references unknown shared dictionary "
                    f"{dict_id!r}: the reading process never installed it "
                    f"(plan serde ships dictionary values; a version-skewed "
                    f"plan or a cleared registry can cause this)"
                )
            # take with null indices yields nulls: string nullability restored
            strings = value_set.take(arr)
            fields.append(F(f.name, DT.STRING, True))
            cols.append(Column(DT.STRING, strings, dict_id=dict_id))
        else:
            field = F(f.name, DT.from_arrow(f.type), f.nullable)
            if field.dtype is DT.STRING:
                cols.append(Column(DT.STRING, arr.cast(pa.string())))
            else:
                cols.append(Column(field.dtype, arr))
            fields.append(field)
    return ColumnBatch(S(tuple(fields)), cols, num_rows=table.num_rows)
