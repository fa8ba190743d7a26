"""The plain reference: exact TPC-H answers in numpy, and the comparison
that decides whether a run is correct.

Sums of 2-decimal columns are taken in int64 (hundredths; a revenue
``price * (100 - discount)`` in units of 10^-4) and converted to the nearest
double once at the end (Python's int / int rounds correctly). Joins are
dense key lookups: every join key of the queries here is a primary key on
one side. Each query's answer is a function in ``queries/<query>.py``; this
module holds what they share. It imports nothing of the port: it reads the
tables the benchmark generated, never anything the program made.

The helpers ``hundredths``, ``index`` and ``lookup`` and the query bodies are
copied from ``chip_smoke.py`` (``exact_reference``), with the spec's
validation literals made substitution parameters.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

HERE = os.path.dirname(os.path.abspath(__file__))


def day(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def add_years(iso: str, n: int) -> str:
    return f"{int(iso[:4]) + n}{iso[4:]}"


def hundredths(v: np.ndarray) -> np.ndarray:
    """Exact int64 hundredths of a 2-decimal f64 column."""
    c = np.round(v * 100).astype(np.int64)
    if not np.array_equal(c / 100.0, v):
        raise ValueError("column is not an exact 2-decimal column")
    return c


def index(keys: np.ndarray, values: np.ndarray, fill) -> np.ndarray:
    """A dense lookup array: out[key] = value, ``fill`` elsewhere."""
    out = np.full(int(keys.max()) + 1 if len(keys) else 1, fill, dtype=values.dtype)
    out[keys] = values
    return out


def lookup(table: np.ndarray, keys: np.ndarray, fill) -> np.ndarray:
    """table[keys], ``fill`` for keys past its end."""
    inside = keys < len(table)
    return np.where(inside, table[np.where(inside, keys, 0)], fill)


class Strings:
    """A string column as dictionary codes: cheap equality and membership
    over millions of rows."""

    def __init__(self, col):
        enc = pc.dictionary_encode(col).combine_chunks()
        self.codes = enc.indices.to_numpy(zero_copy_only=False)
        self.words = np.array(enc.dictionary.to_pylist(), dtype=object)

    def isin(self, words) -> np.ndarray:
        return np.isin(self.words, list(words))[self.codes]

    def eq(self, word: str) -> np.ndarray:
        return self.isin([word])

    def values(self, rows=None) -> np.ndarray:
        return self.words[self.codes if rows is None else self.codes[rows]]


class Tables:
    """Columns of the generated tables, converted once on first use: dates
    as int32 days, strings as ``Strings``, numbers as numpy arrays."""

    def __init__(self, tables: dict):
        self._tables = tables
        self._cols: dict = {}

    def __call__(self, table: str, column: str):
        key = (table, column)
        if key not in self._cols:
            col = self._tables[table].column(column)
            if pa.types.is_string(col.type) or pa.types.is_large_string(col.type):
                self._cols[key] = Strings(col)
            elif pa.types.is_date32(col.type):
                self._cols[key] = col.cast(pa.int32()).to_numpy()
            else:
                self._cols[key] = col.to_numpy()
        return self._cols[key]

    def cents(self, table: str, column: str) -> np.ndarray:
        key = (table, column, "cents")
        if key not in self._cols:
            self._cols[key] = hundredths(self(table, column))
        return self._cols[key]


def query_module(name: str):
    """``queries/<name>.py``: its ``answer(tables, params)`` gives
    {column: values in ORDER BY order}."""
    path = os.path.join(HERE, "queries", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_query_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def answer(tables: Tables, query: str, params: dict) -> dict:
    return query_module(query).answer(tables, params)


def _as_list(col: pa.ChunkedArray) -> list:
    if pa.types.is_date32(col.type):
        return list(col.cast(pa.int32()).to_numpy())
    return col.to_pylist()


def compare(got: pa.Table, exact: dict, kinds: dict) -> dict:
    """One answer against the reference's. ``kinds`` names the columns not
    held exactly: ``avg`` (relative gap) and ``sum`` (a decimal sum the
    program may take from rounded rows: absolute gap). Returns
    ``{"mismatches": values that differ from the exact answer (a missing or
    extra row or column counts each of its values), "sum_gap": the largest
    absolute gap of a ``sum`` column, "avg_rel_gap": the largest relative
    gap of an ``avg`` column}``."""
    out = {"mismatches": 0, "sum_gap": 0.0, "avg_rel_gap": 0.0}
    rows = len(next(iter(exact.values()))) if exact else 0
    if list(got.schema.names) != list(exact) or got.num_rows != rows:
        out["mismatches"] = max(rows, got.num_rows, 1) * max(len(exact), 1)
        return out
    for name, want in exact.items():
        col = got.column(name)
        kind = kinds.get(name)
        if kind in ("avg", "sum"):
            g = np.asarray(col.to_numpy(zero_copy_only=False), dtype=np.float64)
            x = np.asarray(want, dtype=np.float64)
            bad = ~np.isfinite(g)
            out["mismatches"] += int(bad.sum())
            gap = np.abs(np.where(bad, x, g) - x)
            if kind == "avg":
                rel = gap / np.maximum(np.abs(x), np.finfo(np.float64).tiny)
                out["avg_rel_gap"] = max(out["avg_rel_gap"], float(rel.max(initial=0.0)))
            else:
                out["sum_gap"] = max(out["sum_gap"], float(gap.max(initial=0.0)))
            continue
        values = _as_list(col)
        want = [int(w) if isinstance(w, (np.integer,)) else w for w in want]
        out["mismatches"] += sum(1 for a, b in zip(values, want) if a != b)
    return out


def worst(readings) -> dict:
    """The worst of several ``compare`` readings, key by key."""
    out = {"mismatches": 0, "sum_gap": 0.0, "avg_rel_gap": 0.0}
    for r in readings:
        out["mismatches"] += r["mismatches"]
        out["sum_gap"] = max(out["sum_gap"], r["sum_gap"])
        out["avg_rel_gap"] = max(out["avg_rel_gap"], r["avg_rel_gap"])
    return out
