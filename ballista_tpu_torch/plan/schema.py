"""Column types, fields and schemas.

Reference analog: DataFusion's ``arrow_schema`` usage throughout
``arrow-ballista: ballista/core/src/serde/`` — the TPU build narrows the type
lattice to what maps cleanly onto device arrays: fixed-width numerics, date32
(int32 days), and strings (kept host-side as Arrow arrays, dictionary/hashed
on device).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import pyarrow as pa


class DataType(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DATE32 = "date32"  # days since unix epoch, int32 storage
    STRING = "string"

    # ---- classification helpers -------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self in (DataType.INT32, DataType.INT64, DataType.FLOAT32, DataType.FLOAT64)

    @property
    def is_integer(self) -> bool:
        return self in (DataType.INT32, DataType.INT64)

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    @property
    def is_string(self) -> bool:
        return self is DataType.STRING

    def to_numpy(self) -> np.dtype:
        return _NUMPY_OF[self]

    def to_arrow(self) -> pa.DataType:
        return _ARROW_OF[self]

    @staticmethod
    def from_arrow(t: pa.DataType) -> "DataType":
        if pa.types.is_dictionary(t):
            return DataType.from_arrow(t.value_type)
        if pa.types.is_boolean(t):
            return DataType.BOOL
        if pa.types.is_date32(t):
            return DataType.DATE32
        if pa.types.is_date64(t) or pa.types.is_timestamp(t):
            return DataType.DATE32
        if pa.types.is_decimal(t):
            return DataType.FLOAT64
        if pa.types.is_floating(t):
            return DataType.FLOAT32 if t == pa.float32() else DataType.FLOAT64
        if pa.types.is_integer(t):
            return DataType.INT32 if t.bit_width <= 32 else DataType.INT64
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            return DataType.STRING
        raise TypeError(f"unsupported arrow type: {t}")

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


_NUMPY_OF = {
    DataType.BOOL: np.dtype(np.bool_),
    DataType.INT32: np.dtype(np.int32),
    DataType.INT64: np.dtype(np.int64),
    DataType.FLOAT32: np.dtype(np.float32),
    DataType.FLOAT64: np.dtype(np.float64),
    DataType.DATE32: np.dtype(np.int32),
    DataType.STRING: np.dtype(object),
}

_ARROW_OF = {
    DataType.BOOL: pa.bool_(),
    DataType.INT32: pa.int32(),
    DataType.INT64: pa.int64(),
    DataType.FLOAT32: pa.float32(),
    DataType.FLOAT64: pa.float64(),
    DataType.DATE32: pa.date32(),
    DataType.STRING: pa.string(),
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def to_arrow(self) -> pa.Field:
        return pa.field(self.name, self.dtype.to_arrow(), nullable=self.nullable)

    def rename(self, name: str) -> "Field":
        return Field(name, self.dtype, self.nullable)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{self.name}:{self.dtype.value}"


@dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...] = field(default=())

    def __post_init__(self):
        if not isinstance(self.fields, tuple):
            object.__setattr__(self, "fields", tuple(self.fields))

    # ---- accessors --------------------------------------------------------------
    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        short = name.split(".")[-1]
        if "." in name:
            # qualified ref "q.c": exact miss above, so it can only mean an
            # unqualified field "c" (table-name qualification of a bare scan);
            # it must NOT match a differently-qualified "other.c"
            hits = [i for i, f in enumerate(self.fields) if f.name == short]
        else:
            # unqualified ref "c" matches "c" or any "alias.c"
            hits = [i for i, f in enumerate(self.fields) if f.name.split(".")[-1] == short]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise KeyError(f"ambiguous column {name!r} in schema {self.names}")
        raise KeyError(f"no column {name!r} in schema {self.names}")

    def field(self, name: str) -> Field:
        return self.fields[self.index_of(name)]

    def has(self, name: str) -> bool:
        try:
            self.index_of(name)
            return True
        except KeyError:
            return False

    # ---- construction -----------------------------------------------------------
    @staticmethod
    def of(*pairs: tuple[str, DataType]) -> "Schema":
        return Schema(tuple(Field(n, t) for n, t in pairs))

    @staticmethod
    def from_arrow(s: pa.Schema) -> "Schema":
        return Schema(tuple(Field(f.name, DataType.from_arrow(f.type), f.nullable) for f in s))

    def to_arrow(self) -> pa.Schema:
        return pa.schema([f.to_arrow() for f in self.fields])

    def select(self, names: list[str]) -> "Schema":
        return Schema(tuple(self.field(n) for n in names))

    def join(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)

    def rename_all(self, names: list[str]) -> "Schema":
        assert len(names) == len(self.fields)
        return Schema(tuple(f.rename(n) for f, n in zip(self.fields, names)))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "Schema[" + ", ".join(map(repr, self.fields)) + "]"
