"""Minimal Avro Object Container File reader/writer (no external deps).

Implements the subset the register_avro path needs, from the PUBLIC Avro 1.11
specification: container framing (magic, metadata map, sync-marker-delimited
blocks), ``null``/``deflate`` codecs, record schemas over primitive types
(null, boolean, int, long, float, double, bytes, string), nullable unions
``["null", T]`` (either order), and the ``date`` logical type (int days).

Reference analog: the reference client's Avro read path
(``arrow-ballista: ballista/client/src/context.rs`` read_avro /
register_avro, backed by DataFusion's avro feature).
"""
from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Optional

import numpy as np
import pyarrow as pa

MAGIC = b"Obj\x01"


# ---- zigzag varint ----------------------------------------------------------------
def _read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated avro varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: io.BytesIO, v: int) -> None:
    v = (v << 1) ^ (v >> 63)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.write(bytes([b | 0x80]))
        else:
            out.write(bytes([b]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    return buf.read(n)


def _write_bytes(out: io.BytesIO, b: bytes) -> None:
    _write_long(out, len(b))
    out.write(b)


# ---- schema ----------------------------------------------------------------------
def _field_type(t) -> tuple[str, Optional[int]]:
    """(primitive name, null_branch_index) for a field type; unions must be
    two-branch with null, in EITHER order — the index records which branch
    is null so decoding honors the file's declared order."""
    if isinstance(t, list):
        names = [x if isinstance(x, str) else x.get("type") for x in t]
        if len(t) == 2 and "null" in names:
            null_idx = names.index("null")
            other = t[1 - null_idx]
            name, _ = _field_type(other)
            return name, null_idx
        raise ValueError(f"unsupported avro union {t}")
    if isinstance(t, dict):
        if t.get("logicalType") == "date":
            return "date", None
        return _field_type(t["type"])
    if t in ("null", "boolean", "int", "long", "float", "double", "bytes", "string"):
        return t, None
    raise ValueError(f"unsupported avro type {t!r}")


_ARROW_TYPES = {
    "boolean": pa.bool_(),
    "int": pa.int32(),
    "long": pa.int64(),
    "float": pa.float32(),
    "double": pa.float64(),
    "bytes": pa.binary(),
    "string": pa.string(),
    "date": pa.date32(),
}


def _read_value(buf: io.BytesIO, typ: str, null_idx: Optional[int]):
    if null_idx is not None:
        idx = _read_long(buf)
        if idx == null_idx:
            return None
    if typ == "boolean":
        return buf.read(1) == b"\x01"
    if typ in ("int", "long", "date"):
        return _read_long(buf)
    if typ == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if typ == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if typ == "bytes":
        return _read_bytes(buf)
    if typ == "string":
        return _read_bytes(buf).decode()
    raise ValueError(typ)


def _write_value(out: io.BytesIO, typ: str, null_idx: Optional[int], v) -> None:
    if null_idx is not None:  # this writer always emits ["null", T] (idx 0)
        if v is None:
            _write_long(out, 0)
            return
        _write_long(out, 1)
    if typ == "boolean":
        out.write(b"\x01" if v else b"\x00")
    elif typ in ("int", "long", "date"):
        _write_long(out, int(v))
    elif typ == "float":
        out.write(struct.pack("<f", float(v)))
    elif typ == "double":
        out.write(struct.pack("<d", float(v)))
    elif typ == "bytes":
        _write_bytes(out, bytes(v))
    elif typ == "string":
        _write_bytes(out, str(v).encode())
    else:
        raise ValueError(typ)


# ---- container file ---------------------------------------------------------------
def read_avro(path: str) -> pa.Table:
    with open(path, "rb") as f:
        return read_avro_bytes(f.read(), path)


def read_avro_bytes(raw: bytes, path: str = "<bytes>") -> pa.Table:
    buf = io.BytesIO(raw)
    if buf.read(4) != MAGIC:
        raise ValueError(f"{path}: not an avro object container file")
    meta: dict[str, bytes] = {}
    while True:
        n = _read_long(buf)
        if n == 0:
            break
        if n < 0:  # block with explicit byte size
            _read_long(buf)
            n = -n
        for _ in range(n):
            k = _read_bytes(buf).decode()
            meta[k] = _read_bytes(buf)
    sync = buf.read(16)
    schema = json.loads(meta["avro.schema"].decode())
    codec = meta.get("avro.codec", b"null").decode()
    if schema.get("type") != "record":
        raise ValueError("avro top-level schema must be a record")
    fields = [
        (f["name"], *_field_type(f["type"])) for f in schema["fields"]
    ]

    cols: dict[str, list] = {name: [] for name, _, _ in fields}
    while True:
        head = buf.read(1)
        if not head:
            break
        buf.seek(-1, io.SEEK_CUR)
        count = _read_long(buf)
        size = _read_long(buf)
        block = buf.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise ValueError(f"unsupported avro codec {codec!r}")
        bbuf = io.BytesIO(block)
        for _ in range(count):
            for name, typ, null_idx in fields:
                cols[name].append(_read_value(bbuf, typ, null_idx))
        if buf.read(16) != sync:
            raise ValueError("avro sync marker mismatch")

    arrays = {
        name: pa.array(cols[name], type=_ARROW_TYPES[typ])
        for name, typ, _null_idx in fields
    }
    return pa.table(arrays)


_AVRO_TYPES = {
    pa.types.is_boolean: "boolean",
    pa.types.is_int32: "int",
    pa.types.is_int64: "long",
    pa.types.is_float32: "float",
    pa.types.is_float64: "double",
    pa.types.is_binary: "bytes",
    pa.types.is_string: "string",
}


def _avro_type(t: pa.DataType):
    if pa.types.is_date32(t):
        return {"type": "int", "logicalType": "date"}
    for pred, name in _AVRO_TYPES.items():
        if pred(t):
            return name
    raise ValueError(f"cannot write arrow type {t} to avro")


def write_avro(path: str, table: pa.Table, codec: str = "deflate") -> None:
    fields = []
    specs = []
    for f in table.schema:
        t = _avro_type(f.type)
        nullable = any(c.null_count for c in table.column(f.name).chunks) or f.nullable
        fields.append({"name": f.name, "type": ["null", t] if nullable else t})
        name = t["logicalType"] if isinstance(t, dict) else t
        specs.append((f.name, "date" if name == "date" else name, 0 if nullable else None))
    schema = {"type": "record", "name": "row", "fields": fields}

    body = io.BytesIO()
    rows = table.to_pylist()
    for row in rows:
        for name, typ, null_idx in specs:
            v = row[name]
            if typ == "date" and v is not None and not isinstance(v, int):
                import datetime

                v = (v - datetime.date(1970, 1, 1)).days
            _write_value(body, typ, null_idx, v)
    block = body.getvalue()
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        block = comp.compress(block) + comp.flush()

    out = io.BytesIO()
    out.write(MAGIC)
    meta = {"avro.schema": json.dumps(schema).encode(), "avro.codec": codec.encode()}
    _write_long(out, len(meta))
    for k, v in meta.items():
        _write_bytes(out, k.encode())
        _write_bytes(out, v)
    _write_long(out, 0)
    sync = os.urandom(16)
    out.write(sync)
    _write_long(out, len(rows))
    _write_long(out, len(block))
    out.write(block)
    out.write(sync)
    with open(path, "wb") as f:
        f.write(out.getvalue())
