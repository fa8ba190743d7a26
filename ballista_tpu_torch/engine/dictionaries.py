"""Catalog-shared string dictionaries: the device-resident string layer.

Before this module, dictionaries were a per-batch encode detail: every leaf
encode ran ``sorted_dictionary_encode`` over its own partition, so every
partition produced a DIFFERENT dictionary, every stage program baked a
different lookup table, the compile cache keyed string stages on dictionary
CONTENT (one XLA compile per partition), and the precompile hint service
declined every string-bearing stage outright ("string column pins a
dictionary").

This module promotes the dictionary to a first-class, catalog-versioned plan
property (the Arrow ``DictionaryArray``-through-the-whole-plan analog the
reference gets for free):

* at table registration the catalog builds ONE shared sorted dictionary per
  string column (bounded by ``ballista.engine.max_dict_size``; oversized
  columns decline and keep today's per-batch behavior);
* the dictionary is identified by a content-addressed ``dict_id`` that embeds
  the catalog version — a re-registered table mints new ids, so the PR-8
  plan cache and the compile cache can never replay against a stale
  dictionary;
* ``Column.dict_id`` / ``DeviceCol.dict_id`` carry the reference through the
  host kernels and device programs; leaf encodes emit stable int32 codes
  against the shared dictionary and sign the encoding with the ID instead of
  hashing dictionary content;
* shuffles move codes + the reference instead of raw strings
  (``ops.batch.to_wire_table``/``from_wire_table``);
* the propagation analysis (:func:`propagate_dict_refs`) mirrors the runtime
  column propagation statically, so the scheduler can annotate shuffle
  boundaries and the compile-hint service can trace string stages from the
  registry instead of declining them.

The registry is process-wide. Distributed executors learn dictionary values
from plan serde: encoded plans carry ``{dict_id: values}`` for every
reference in the tree (bounded by ``max_dict_size``), and ``ensure`` installs
them at decode time — ids are content-addressed, so installation is
idempotent and can never alias two dictionaries.
"""
from __future__ import annotations

import hashlib
import logging
import threading
from typing import Optional

import numpy as np

log = logging.getLogger("ballista.dicts")


def _content_hash(values: np.ndarray) -> str:
    h = hashlib.sha1()
    for v in values.tolist():
        h.update(str(v).encode("utf-8", "surrogatepass"))
        h.update(b"\x00")
    return h.hexdigest()[:12]


def make_dict_id(table: str, column: str, version: int, values: np.ndarray) -> str:
    """Content-addressed dictionary identity. The catalog version makes
    re-registration mint a fresh id even for identical content (plan-cache
    epochs stay ordered); the content hash makes the id safe to install
    cross-process (two processes deriving the same id hold the same bytes)."""
    return f"{table}.{column}@v{version}:{_content_hash(values)}"


class DictionaryRegistry:
    """Process-wide dict_id -> sorted string values (object ndarray), plus
    memoized derived artifacts (the pandas hash LUT the canonical paths
    gather through). Bounded implicitly: entries are max_dict_size-bounded
    at build time and tables re-register rarely; `trim` drops derived caches
    if a long-lived process ever accumulates stale versions."""

    MAX_ENTRIES = 4096

    def __init__(self):
        self._mu = threading.Lock()
        self._values: dict[str, np.ndarray] = {}
        self._hash_luts: dict[str, np.ndarray] = {}
        self.shared_encodes = 0   # leaf encodes that rode a shared dictionary
        self.per_batch_encodes = 0  # string-col encodes that built their own

    def ensure(self, dict_id: str, values) -> str:
        """Install (idempotently) and return the id. Values are normalized to
        a sorted object ndarray — sortedness is LOAD-BEARING (code order ==
        lexicographic order drives device comparisons/sorts/min-max), so it
        is enforced here at the one public install point rather than trusted
        to every caller. Content-addressed ids make double-install a no-op
        rather than a conflict."""
        with self._mu:
            if dict_id not in self._values:
                if len(self._values) >= self.MAX_ENTRIES:
                    # drop the oldest installs (stale catalog versions); the
                    # ids are re-installable from any plan that needs them
                    for k in list(self._values)[: self.MAX_ENTRIES // 4]:
                        self._values.pop(k, None)
                        self._hash_luts.pop(k, None)
                arr = np.asarray(values, dtype=object)
                if len(arr) > 1 and not bool(np.all(arr[:-1] <= arr[1:])):
                    arr = np.sort(arr, kind="stable")
                self._values[dict_id] = arr
        return dict_id

    def get(self, dict_id: Optional[str]) -> Optional[np.ndarray]:
        if not dict_id:
            return None
        with self._mu:
            return self._values.get(dict_id)

    def hash_lut(self, dict_id: str) -> Optional[np.ndarray]:
        """int64 pandas-hash per dictionary entry (the trace-time constant the
        device canonical path gathers through) — memoized per id so multi-
        hundred-k dictionaries hash once per process, not once per trace."""
        with self._mu:
            lut = self._hash_luts.get(dict_id)
            if lut is not None:
                return lut
            values = self._values.get(dict_id)
        if values is None:
            return None
        import pandas as pd

        lut = pd.util.hash_array(values.astype(object)).astype(np.int64)
        with self._mu:
            self._hash_luts[dict_id] = lut
        return lut

    def note_encode(self, shared: bool) -> None:
        with self._mu:
            if shared:
                self.shared_encodes += 1
            else:
                self.per_batch_encodes += 1

    def stats(self) -> dict:
        with self._mu:
            return {
                "entries": len(self._values),
                "shared_encodes": self.shared_encodes,
                "per_batch_encodes": self.per_batch_encodes,
            }

    def clear(self) -> None:
        with self._mu:
            self._values.clear()
            self._hash_luts.clear()


REGISTRY = DictionaryRegistry()


# ---- build at registration ---------------------------------------------------------
def default_knobs(config=None) -> tuple[bool, int]:
    """(shared_dicts_enabled, max_dict_size) from a BallistaConfig (or the
    registered defaults when the caller has none)."""
    from ballista_tpu_torch.config import (
        BALLISTA_ENGINE_MAX_DICT_SIZE,
        BALLISTA_ENGINE_SHARED_DICTS,
        BallistaConfig,
    )

    cfg = config or BallistaConfig()
    try:
        return (
            bool(cfg.get(BALLISTA_ENGINE_SHARED_DICTS)),
            int(cfg.get(BALLISTA_ENGINE_MAX_DICT_SIZE)),
        )
    except Exception:  # noqa: BLE001 - minimal configs without the keys
        return True, 65536


def build_shared_dictionary(chunks, max_size: int) -> Optional[np.ndarray]:
    """Sorted unique values over an iterable of pyarrow string arrays (or
    ChunkedArrays), or None once the distinct count exceeds ``max_size``.
    The empty string is always included: null rows encode as fill_null("")
    and their code must resolve inside the dictionary."""
    import pyarrow as pa
    import pyarrow.compute as pc

    seen: Optional[pa.Array] = None
    for chunk in chunks:
        if isinstance(chunk, pa.ChunkedArray):
            chunk = chunk.combine_chunks()
        if not pa.types.is_string(chunk.type):
            chunk = chunk.cast(pa.string())  # dictionary/large_string parquet
        u = pc.unique(chunk.fill_null(""))
        seen = u if seen is None else pc.unique(pa.concat_arrays(
            [seen.cast(pa.string()), u.cast(pa.string())]
        ))
        if len(seen) > max_size:
            return None
    if seen is None:
        seen = pa.array([], type=pa.string())
    values = np.asarray(seen).astype(object)
    if "" not in values:
        values = np.concatenate([np.array([""], dtype=object), values])
    if len(values) > max_size:
        return None
    return np.sort(values, kind="stable")


def build_table_dictionaries(
    name: str,
    schema,
    version: int,
    string_chunks,
    max_size: int,
) -> tuple[dict[str, str], dict[str, str]]:
    """(dict_refs {column: dict_id}, declines {column: reason}) for a table.

    ``string_chunks`` is a callable ``column_name -> iterable of pyarrow
    string arrays`` (file-by-file for parquet, partition-by-partition for
    memory tables) so the build streams and the oversize bail stops reading
    a column early."""
    from ballista_tpu_torch.plan.schema import DataType

    refs: dict[str, str] = {}
    declines: dict[str, str] = {}
    for f in schema:
        if f.dtype is not DataType.STRING:
            continue
        try:
            values = build_shared_dictionary(string_chunks(f.name), max_size)
        except Exception as e:  # noqa: BLE001 - the dictionary is an
            # optimization; a build failure must never fail registration
            log.warning("shared dictionary build for %s.%s failed: %s",
                        name, f.name, e)
            declines[f.name] = f"build failed: {e}"
            continue
        if values is None:
            declines[f.name] = (
                f"distinct count exceeds ballista.engine.max_dict_size={max_size}"
            )
            log.info("shared dictionary declined for %s.%s: %s",
                     name, f.name, declines[f.name])
            continue
        did = make_dict_id(name, f.name, version, values)
        REGISTRY.ensure(did, values)
        refs[f.name] = did
    return refs, declines


def lookup_ref(refs: Optional[dict], name: str) -> Optional[str]:
    """THE dict-ref name resolution, shared by every consumer (verifier,
    synthetic hint batches, scan tagging, wire encode): exact name first,
    then a UNIQUE short-name match (Schema.index_of discipline). An
    ambiguous short name resolves to None — claiming either dictionary for
    a name that covers two columns would be unsound."""
    if not refs:
        return None
    ref = refs.get(name)
    if ref is not None:
        return ref
    short = name.split(".")[-1]
    hits = {v for k, v in refs.items() if k.split(".")[-1] == short}
    return hits.pop() if len(hits) == 1 else None


# ---- static propagation (mirror of the runtime Column.dict_id flow) ----------------
def propagate_dict_refs(plan) -> dict[str, str]:
    """{output column name: dict_id} for a physical plan, derived statically
    by the same rules the runtime Column propagation follows: scans introduce
    refs, plain column references carry them, computed strings drop them.
    Used to annotate shuffle boundaries at stage-split time and to let the
    compile-hint service trace string stages from the registry.

    Conservative by construction: a column this analysis misses merely rides
    the per-batch path; a column it claims must genuinely carry the shared
    dictionary at runtime (all rules here are a subset of the runtime ones)."""
    from ballista_tpu_torch.plan import physical as P
    from ballista_tpu_torch.plan.expr import Agg, Col, unalias

    def of(node) -> dict[str, str]:
        if isinstance(node, (P.ParquetScanExec, P.UnresolvedShuffleExec,
                             P.ShuffleReaderExec)):
            refs = dict(getattr(node, "dict_refs", None) or {})
            names = set(node.schema().names)
            return {k: v for k, v in refs.items() if k in names}
        if isinstance(node, P.MemoryScanExec):
            refs: dict[str, str] = {}
            names = set(node.schema().names)
            for b in node.partitions or []:
                for f, c in zip(b.schema, getattr(b, "columns", [])):
                    did = getattr(c, "dict_id", None)
                    if did and f.name in names:
                        prev = refs.get(f.name)
                        if prev is not None and prev != did:
                            refs[f.name] = ""  # conflicting partitions: drop
                        elif prev is None:
                            refs[f.name] = did
            return {k: v for k, v in refs.items() if v}
        if isinstance(node, (P.FilterExec, P.LimitExec, P.SortExec,
                             P.SortPreservingMergeExec,
                             P.CoalescePartitionsExec)):
            return of(node.input)
        if isinstance(node, P.RepartitionExec):  # incl. IciExchangeExec
            return of(node.input)
        if isinstance(node, P.ShuffleWriterExec):
            return of(node.input)
        if isinstance(node, P.ProjectExec):
            below = of(node.input)
            out: dict[str, str] = {}
            for e, f in zip(node.exprs, node.schema()):
                inner = unalias(e)
                if isinstance(inner, Col):
                    ref = _lookup(below, inner.col)
                    if ref:
                        out[f.name] = ref
            return out
        if isinstance(node, P.HashAggregateExec):
            below = of(node.input)
            out = {}
            for e, f in zip(list(node.group_exprs), node.schema()):
                inner = unalias(e)
                if isinstance(inner, Col):
                    ref = _lookup(below, inner.col)
                    if ref:
                        out[f.name] = ref
            # min/max over a shared-dict column stays inside the dictionary
            for e in node.agg_exprs:
                a = unalias(e)
                if isinstance(a, Agg) and a.fn in ("min", "max") and a.expr is not None:
                    inner = unalias(a.expr)
                    if isinstance(inner, Col):
                        ref = _lookup(below, inner.col)
                        if ref:
                            out[e.name()] = ref
            return out
        if isinstance(node, (P.HashJoinExec, P.CrossJoinExec)):
            left = of(node.left)
            right = of(node.right)
            out = dict(left)
            for k, v in right.items():
                if k in out and out[k] != v:
                    out.pop(k)
                    continue
                out[k] = v
            # Schema.join concatenates fields WITHOUT renaming: one output
            # name present in BOTH inputs covers two columns, and a claim
            # sourced from only one side would encode the other side's
            # column against a dictionary it never agreed to. Keep such a
            # name only when BOTH sides claim the SAME id (then both columns
            # provably share that dictionary); drop it otherwise — value
            # soundness over coverage.
            dup = set(node.left.schema().names) & set(node.right.schema().names)
            for k in dup:
                if k in out and not (left.get(k) == right.get(k) == out[k]):
                    out.pop(k)
            names = set(node.schema().names)
            return {k: v for k, v in out.items() if k in names}
        if isinstance(node, P.UnionExec):
            branches = [of(c) for c in node.inputs]
            names = node.schema().names
            out = {}
            if branches:
                # positional alignment: every branch must agree per position
                for i, name in enumerate(names):
                    refs = set()
                    for b, child in zip(branches, node.inputs):
                        cn = child.schema().names[i]
                        refs.add(b.get(cn))
                    if len(refs) == 1 and None not in refs:
                        out[name] = refs.pop()
            return out
        if isinstance(node, P.WindowExec):
            # window exprs append computed columns; pass-through cols keep refs
            below = of(node.input)
            names = set(node.schema().names)
            return {k: v for k, v in below.items() if k in names}
        return {}

    _lookup = lookup_ref

    try:
        return of(plan)
    except Exception:  # noqa: BLE001 - analysis is an optimization input
        log.debug("dict-ref propagation failed", exc_info=True)
        return {}


def collect_plan_dict_ids(plan) -> set[str]:
    """Every dict_id referenced anywhere in a physical plan tree (the set the
    serde payload must ship values for)."""
    from ballista_tpu_torch.plan import physical as P

    out: set[str] = set()
    for node in P.walk_physical(plan):
        refs = getattr(node, "dict_refs", None)
        if refs:
            out.update(v for v in refs.values() if v)
        if isinstance(node, P.MemoryScanExec):
            for b in node.partitions or []:
                for c in getattr(b, "columns", []):
                    did = getattr(c, "dict_id", None)
                    if did:
                        out.add(did)
    return out
