"""Plan / expression serde.

Reference analog: ``BallistaCodec`` + the datafusion/ballista plan protos
(``arrow-ballista: ballista/core/src/serde/mod.rs:73-295``). The control-plane
protobuf carries plans as opaque bytes there; here the plan payload encoding is
a versioned JSON tree over the IR (compact, debuggable, schema-stable), with
the three shuffle operators as first-class nodes exactly like the reference's
extension codec.
"""
from __future__ import annotations

import json
from typing import Any

from ballista_tpu_torch.errors import PlanningError
from ballista_tpu_torch.plan import logical as L
from ballista_tpu_torch.plan import physical as P
from ballista_tpu_torch.plan.expr import (
    Agg, Alias, BinaryOp, Case, Cast, Col, Expr, Func, InList, IsNull, Like, Lit,
    Not, OuterCol,
)
from ballista_tpu_torch.plan.physical import HashPartitioning
from ballista_tpu_torch.plan.schema import DataType, Field, Schema

SERDE_VERSION = 1


# ---- schema -----------------------------------------------------------------------
def schema_to_json(s: Schema) -> list:
    return [[f.name, f.dtype.value, f.nullable] for f in s]


def schema_from_json(j: list) -> Schema:
    return Schema(tuple(Field(n, DataType(t), nl) for n, t, nl in j))


# ---- expressions ------------------------------------------------------------------
def expr_to_json(e: Expr) -> Any:
    if isinstance(e, Col):
        return {"t": "col", "name": e.col}
    if isinstance(e, OuterCol):
        return {"t": "outer", "name": e.col, "dtype": e.dtype.value}
    if isinstance(e, Lit):
        return {"t": "lit", "v": e.value, "dtype": e.dtype.value}
    if isinstance(e, BinaryOp):
        return {"t": "bin", "op": e.op, "l": expr_to_json(e.left), "r": expr_to_json(e.right)}
    if isinstance(e, Not):
        return {"t": "not", "e": expr_to_json(e.expr)}
    if isinstance(e, IsNull):
        return {"t": "isnull", "e": expr_to_json(e.expr), "neg": e.negated}
    if isinstance(e, Like):
        return {"t": "like", "e": expr_to_json(e.expr), "pat": e.pattern, "neg": e.negated}
    if isinstance(e, InList):
        return {
            "t": "inlist", "e": expr_to_json(e.expr),
            "vals": [expr_to_json(v) for v in e.values], "neg": e.negated,
        }
    if isinstance(e, Case):
        return {
            "t": "case",
            "branches": [[expr_to_json(c), expr_to_json(v)] for c, v in e.branches],
            "else": expr_to_json(e.else_) if e.else_ is not None else None,
        }
    if isinstance(e, Cast):
        return {"t": "cast", "e": expr_to_json(e.expr), "to": e.to.value}
    if isinstance(e, Func):
        return {"t": "func", "fn": e.fn, "args": [expr_to_json(a) for a in e.args]}
    if isinstance(e, Agg):
        return {
            "t": "agg", "fn": e.fn,
            "e": expr_to_json(e.expr) if e.expr is not None else None,
            "distinct": e.distinct,
        }
    if isinstance(e, Alias):
        return {"t": "alias", "e": expr_to_json(e.expr), "name": e.alias_name}
    from ballista_tpu_torch.plan.expr import WindowFunc

    if isinstance(e, WindowFunc):
        return {
            "t": "window", "fn": e.fn,
            "args": [expr_to_json(a) for a in e.args],
            "partition_by": [expr_to_json(p) for p in e.partition_by],
            "order_by": [[expr_to_json(o), asc] for o, asc in e.order_by],
            "frame": None if e.frame is None else {
                "units": e.frame.units,
                "start": list(e.frame.start),
                "end": list(e.frame.end),
            },
        }
    raise PlanningError(f"cannot serialize expr {e!r}")


def expr_from_json(j: Any) -> Expr:
    t = j["t"]
    if t == "col":
        return Col(j["name"])
    if t == "outer":
        return OuterCol(j["name"], DataType(j["dtype"]))
    if t == "lit":
        return Lit(j["v"], DataType(j["dtype"]))
    if t == "bin":
        return BinaryOp(j["op"], expr_from_json(j["l"]), expr_from_json(j["r"]))
    if t == "not":
        return Not(expr_from_json(j["e"]))
    if t == "isnull":
        return IsNull(expr_from_json(j["e"]), j["neg"])
    if t == "like":
        return Like(expr_from_json(j["e"]), j["pat"], j["neg"])
    if t == "inlist":
        return InList(expr_from_json(j["e"]), tuple(expr_from_json(v) for v in j["vals"]), j["neg"])
    if t == "case":
        return Case(
            tuple((expr_from_json(c), expr_from_json(v)) for c, v in j["branches"]),
            expr_from_json(j["else"]) if j["else"] is not None else None,
        )
    if t == "cast":
        return Cast(expr_from_json(j["e"]), DataType(j["to"]))
    if t == "func":
        return Func(j["fn"], tuple(expr_from_json(a) for a in j["args"]))
    if t == "agg":
        return Agg(j["fn"], expr_from_json(j["e"]) if j["e"] is not None else None, j["distinct"])
    if t == "alias":
        return Alias(expr_from_json(j["e"]), j["name"])
    if t == "window":
        from ballista_tpu_torch.plan.expr import WindowFrame, WindowFunc

        fj = j.get("frame")
        frame = None if fj is None else WindowFrame(
            fj["units"], tuple(fj["start"]), tuple(fj["end"])
        )
        return WindowFunc(
            j["fn"], tuple(expr_from_json(a) for a in j["args"]),
            tuple(expr_from_json(p) for p in j["partition_by"]),
            tuple((expr_from_json(o), asc) for o, asc in j["order_by"]),
            frame,
        )
    raise PlanningError(f"unknown expr tag {t}")


# ---- logical plans ----------------------------------------------------------------
def logical_to_json(p: L.LogicalPlan) -> Any:
    if isinstance(p, L.Scan):
        return {
            "t": "scan", "table": p.table, "schema": schema_to_json(p.table_schema),
            "projection": p.projection, "filters": [expr_to_json(f) for f in p.filters],
        }
    if isinstance(p, L.Filter):
        return {"t": "filter", "in": logical_to_json(p.input), "pred": expr_to_json(p.predicate)}
    if isinstance(p, L.Project):
        return {"t": "project", "in": logical_to_json(p.input), "exprs": [expr_to_json(e) for e in p.exprs]}
    if isinstance(p, L.Aggregate):
        return {
            "t": "agg", "in": logical_to_json(p.input),
            "groups": [expr_to_json(e) for e in p.group_exprs],
            "aggs": [expr_to_json(e) for e in p.agg_exprs],
        }
    if isinstance(p, L.Join):
        return {
            "t": "join", "l": logical_to_json(p.left), "r": logical_to_json(p.right),
            "how": p.how, "on": [[expr_to_json(a), expr_to_json(b)] for a, b in p.on],
            "filter": expr_to_json(p.filter) if p.filter is not None else None,
        }
    if isinstance(p, L.Sort):
        return {"t": "sort", "in": logical_to_json(p.input), "keys": [[expr_to_json(e), a] for e, a in p.keys]}
    if isinstance(p, L.Limit):
        return {"t": "limit", "in": logical_to_json(p.input), "n": p.n, "offset": p.offset}
    if isinstance(p, L.SubqueryAlias):
        return {"t": "alias", "in": logical_to_json(p.input), "name": p.alias}
    if isinstance(p, L.EmptyRelation):
        return {"t": "empty", "one_row": p.produce_one_row}
    if isinstance(p, L.Union):
        return {"t": "union", "ins": [logical_to_json(c) for c in p.inputs]}
    if isinstance(p, L.Window):
        return {"t": "windowp", "in": logical_to_json(p.input),
                "exprs": [expr_to_json(e) for e in p.window_exprs]}
    raise PlanningError(f"cannot serialize plan {type(p).__name__}")


def logical_from_json(j: Any) -> L.LogicalPlan:
    t = j["t"]
    if t == "scan":
        return L.Scan(
            j["table"], schema_from_json(j["schema"]), j["projection"],
            [expr_from_json(f) for f in j["filters"]],
        )
    if t == "filter":
        return L.Filter(logical_from_json(j["in"]), expr_from_json(j["pred"]))
    if t == "project":
        return L.Project(logical_from_json(j["in"]), [expr_from_json(e) for e in j["exprs"]])
    if t == "agg":
        return L.Aggregate(
            logical_from_json(j["in"]),
            [expr_from_json(e) for e in j["groups"]],
            [expr_from_json(e) for e in j["aggs"]],
        )
    if t == "join":
        return L.Join(
            logical_from_json(j["l"]), logical_from_json(j["r"]), j["how"],
            [(expr_from_json(a), expr_from_json(b)) for a, b in j["on"]],
            expr_from_json(j["filter"]) if j["filter"] is not None else None,
        )
    if t == "sort":
        return L.Sort(logical_from_json(j["in"]), [(expr_from_json(e), a) for e, a in j["keys"]])
    if t == "limit":
        return L.Limit(logical_from_json(j["in"]), j["n"], j.get("offset", 0))
    if t == "alias":
        return L.SubqueryAlias(logical_from_json(j["in"]), j["name"])
    if t == "empty":
        return L.EmptyRelation(j["one_row"])
    if t == "union":
        return L.Union([logical_from_json(c) for c in j["ins"]])
    if t == "windowp":
        return L.Window(logical_from_json(j["in"]),
                        [expr_from_json(e) for e in j["exprs"]])
    raise PlanningError(f"unknown plan tag {t}")


# ---- physical plans ---------------------------------------------------------------
def physical_to_json(p: P.PhysicalPlan) -> Any:
    if isinstance(p, P.ParquetScanExec):
        out = {
            "t": "parquet", "table": p.table, "files": p.file_groups,
            "schema": schema_to_json(p.table_schema), "projection": p.projection,
            "filters": [expr_to_json(f) for f in p.filters],
        }
        if p.dict_refs:
            out["dict_refs"] = dict(p.dict_refs)
        if p.group_rows is not None:
            # per-group parquet row counts (leaf-stage row estimates): the
            # scheduler's hint/estimate layers read them off the template
            out["group_rows"] = list(p.group_rows)
        return out
    if isinstance(p, P.EmptyExec):
        return {"t": "empty", "one_row": p.produce_one_row}
    if isinstance(p, P.FilterExec):
        return {"t": "filter", "in": physical_to_json(p.input), "pred": expr_to_json(p.predicate)}
    if isinstance(p, P.ProjectExec):
        return {"t": "project", "in": physical_to_json(p.input), "exprs": [expr_to_json(e) for e in p.exprs]}
    if isinstance(p, P.HashAggregateExec):
        return {
            "t": "hashagg", "in": physical_to_json(p.input), "mode": p.mode,
            "groups": [expr_to_json(e) for e in p.group_exprs],
            "aggs": [expr_to_json(e) for e in p.agg_exprs],
            "in_schema": schema_to_json(p.input_schema_for_aggs) if p.input_schema_for_aggs else None,
        }
    if isinstance(p, P.HashJoinExec):
        return {
            "t": "hashjoin", "l": physical_to_json(p.left), "r": physical_to_json(p.right),
            "how": p.how, "on": [[expr_to_json(a), expr_to_json(b)] for a, b in p.on],
            "filter": expr_to_json(p.filter) if p.filter is not None else None,
            "collect_build": p.collect_build,
            "paged": p.paged,
        }
    if isinstance(p, P.CrossJoinExec):
        return {"t": "cross", "l": physical_to_json(p.left), "r": physical_to_json(p.right)}
    if isinstance(p, P.SortExec):
        return {
            "t": "sort", "in": physical_to_json(p.input),
            "keys": [[expr_to_json(e), a] for e, a in p.keys], "fetch": p.fetch,
        }
    if isinstance(p, P.SortPreservingMergeExec):
        return {
            "t": "spm", "in": physical_to_json(p.input),
            "keys": [[expr_to_json(e), a] for e, a in p.keys],
        }
    if isinstance(p, P.CoalescePartitionsExec):
        return {"t": "coalesce", "in": physical_to_json(p.input)}
    if isinstance(p, P.LimitExec):
        return {"t": "limit", "in": physical_to_json(p.input), "n": p.n, "global": p.global_,
                "offset": p.offset}
    if isinstance(p, P.IciExchangeExec):
        # checked before RepartitionExec (its base class): the ICI boundary
        # must survive the wire so executors see the collective contract
        return {
            "t": "iciex", "in": physical_to_json(p.input),
            "exprs": [expr_to_json(e) for e in p.partitioning.exprs], "n": p.partitioning.n,
            "est_rows": p.est_rows, "exchange_id": p.exchange_id,
        }
    if isinstance(p, P.MegastageExec):
        return {"t": "megastage", "in": physical_to_json(p.input)}
    if isinstance(p, P.RepartitionExec):
        return {
            "t": "repart", "in": physical_to_json(p.input),
            "exprs": [expr_to_json(e) for e in p.partitioning.exprs], "n": p.partitioning.n,
            "est_rows": p.est_rows,
        }
    if isinstance(p, P.UnionExec):
        return {"t": "union", "ins": [physical_to_json(c) for c in p.inputs]}
    if isinstance(p, P.WindowExec):
        return {"t": "window", "in": physical_to_json(p.input),
                "exprs": [expr_to_json(e) for e in p.window_exprs]}
    if isinstance(p, P.ShuffleWriterExec):
        out = {
            "t": "shufwrite", "job": p.job_id, "stage": p.stage_id,
            "in": physical_to_json(p.input),
            "exprs": [expr_to_json(e) for e in p.partitioning.exprs] if p.partitioning else None,
            "n": p.partitioning.n if p.partitioning else None,
        }
        if p.dict_refs:
            out["dict_refs"] = dict(p.dict_refs)
        return out
    if isinstance(p, P.UnresolvedShuffleExec):
        out = {
            "t": "unresolved", "stage": p.stage_id,
            "schema": schema_to_json(p.out_schema), "n": p.n_partitions,
        }
        if p.dict_refs:
            out["dict_refs"] = dict(p.dict_refs)
        return out
    if isinstance(p, P.ShuffleReaderExec):
        out = {
            "t": "shufread", "stage": p.stage_id, "schema": schema_to_json(p.out_schema),
            "locations": p.partition_locations,
        }
        if p.dict_refs:
            out["dict_refs"] = dict(p.dict_refs)
        if p.partition_ranges is not None:
            # AQE coalesce/skew ranges (docs/adaptive.md) must survive the
            # wire: the executor's reader and PV005 both consume them
            out["ranges"] = [list(r) for r in p.partition_ranges]
        return out
    raise PlanningError(f"cannot serialize physical plan {type(p).__name__}")


def physical_from_json(j: Any) -> P.PhysicalPlan:
    t = j["t"]
    if t == "parquet":
        return P.ParquetScanExec(
            j["table"], [list(g) for g in j["files"]], schema_from_json(j["schema"]),
            j["projection"], [expr_from_json(f) for f in j["filters"]],
            j.get("dict_refs"),
            list(j["group_rows"]) if j.get("group_rows") is not None else None,
        )
    if t == "empty":
        return P.EmptyExec(j["one_row"])
    if t == "filter":
        return P.FilterExec(physical_from_json(j["in"]), expr_from_json(j["pred"]))
    if t == "project":
        return P.ProjectExec(physical_from_json(j["in"]), [expr_from_json(e) for e in j["exprs"]])
    if t == "hashagg":
        return P.HashAggregateExec(
            physical_from_json(j["in"]), j["mode"],
            [expr_from_json(e) for e in j["groups"]],
            [expr_from_json(e) for e in j["aggs"]],
            schema_from_json(j["in_schema"]) if j["in_schema"] else None,
        )
    if t == "hashjoin":
        return P.HashJoinExec(
            physical_from_json(j["l"]), physical_from_json(j["r"]), j["how"],
            [(expr_from_json(a), expr_from_json(b)) for a, b in j["on"]],
            expr_from_json(j["filter"]) if j["filter"] is not None else None,
            j["collect_build"],
            j.get("paged", False),
        )
    if t == "cross":
        return P.CrossJoinExec(physical_from_json(j["l"]), physical_from_json(j["r"]))
    if t == "sort":
        return P.SortExec(
            physical_from_json(j["in"]), [(expr_from_json(e), a) for e, a in j["keys"]], j["fetch"]
        )
    if t == "spm":
        return P.SortPreservingMergeExec(
            physical_from_json(j["in"]), [(expr_from_json(e), a) for e, a in j["keys"]]
        )
    if t == "coalesce":
        return P.CoalescePartitionsExec(physical_from_json(j["in"]))
    if t == "limit":
        return P.LimitExec(physical_from_json(j["in"]), j["n"], j["global"], j.get("offset", 0))
    if t == "repart":
        return P.RepartitionExec(
            physical_from_json(j["in"]),
            HashPartitioning(tuple(expr_from_json(e) for e in j["exprs"]), j["n"]),
            j.get("est_rows", 0),
        )
    if t == "iciex":
        return P.IciExchangeExec(
            physical_from_json(j["in"]),
            HashPartitioning(tuple(expr_from_json(e) for e in j["exprs"]), j["n"]),
            j.get("est_rows", 0),
            j.get("exchange_id", 0),
        )
    if t == "megastage":
        return P.MegastageExec(physical_from_json(j["in"]))
    if t == "union":
        return P.UnionExec([physical_from_json(c) for c in j["ins"]])
    if t == "window":
        return P.WindowExec(physical_from_json(j["in"]),
                            [expr_from_json(e) for e in j["exprs"]])
    if t == "shufwrite":
        part = None
        if j["n"] is not None:
            part = HashPartitioning(tuple(expr_from_json(e) for e in j["exprs"]), j["n"])
        return P.ShuffleWriterExec(j["job"], j["stage"], physical_from_json(j["in"]),
                                   part, j.get("dict_refs"))
    if t == "unresolved":
        return P.UnresolvedShuffleExec(j["stage"], schema_from_json(j["schema"]),
                                       j["n"], j.get("dict_refs"))
    if t == "shufread":
        ranges = j.get("ranges")
        return P.ShuffleReaderExec(
            j["stage"], schema_from_json(j["schema"]), [list(l) for l in j["locations"]],
            j.get("dict_refs"),
            [tuple(r) for r in ranges] if ranges is not None else None,
        )
    raise PlanningError(f"unknown physical tag {t}")


# ---- byte-level codec (reference: BallistaCodec) ----------------------------------
def encode_logical(p: L.LogicalPlan) -> bytes:
    return json.dumps({"v": SERDE_VERSION, "plan": logical_to_json(p)}).encode()


def decode_logical(b: bytes) -> L.LogicalPlan:
    j = json.loads(b.decode())
    if j.get("v") != SERDE_VERSION:
        raise PlanningError(f"serde version mismatch: {j.get('v')}")
    return logical_from_json(j["plan"])


# encoded-plan memo: the scheduler encodes ONE stage plan once per TASK
# (LaunchTask protos, state-store checkpoints, precompile hints) — with
# shared-dictionary values riding the payload, re-serializing per task would
# JSON-encode the same multi-k-entry dictionaries N times per stage. Keyed by
# object identity, validated by a weakref (a dead referent means the id may
# have been recycled); plans are treated immutably everywhere (the walkers
# are identity-preserving), matching the repo's id-keyed cache discipline.
_ENC_MEMO: dict[int, tuple] = {}
_ENC_MEMO_MAX = 64


def encode_physical(p: P.PhysicalPlan) -> bytes:
    import weakref

    hit = _ENC_MEMO.get(id(p))
    if hit is not None and hit[0]() is p:
        return hit[1]
    payload = {"v": SERDE_VERSION, "plan": physical_to_json(p)}
    # shared-dictionary values ride ONCE per payload (nodes carry only ids):
    # the decoding process installs them, so executors can re-encode scanned
    # strings to the agreed codes and rebuild wire code columns. Bounded by
    # ballista.engine.max_dict_size per dictionary at build time.
    try:
        from ballista_tpu_torch.engine.dictionaries import REGISTRY, collect_plan_dict_ids

        ids = collect_plan_dict_ids(p)
        dicts = {
            did: REGISTRY.get(did).tolist()
            for did in sorted(ids)
            if REGISTRY.get(did) is not None
        }
        if dicts:
            payload["dicts"] = dicts
    except Exception:  # noqa: BLE001 - refs degrade to per-batch encoding
        pass
    data = json.dumps(payload).encode()
    try:
        if len(_ENC_MEMO) >= _ENC_MEMO_MAX:
            _ENC_MEMO.clear()
        _ENC_MEMO[id(p)] = (weakref.ref(p), data)
    except TypeError:  # non-weakref-able plan object: skip the memo
        pass
    return data


def decode_physical(b: bytes) -> P.PhysicalPlan:
    j = json.loads(b.decode())
    if j.get("v") != SERDE_VERSION:
        raise PlanningError(f"serde version mismatch: {j.get('v')}")
    if j.get("dicts"):
        from ballista_tpu_torch.engine.dictionaries import REGISTRY

        for did, values in j["dicts"].items():
            REGISTRY.ensure(did, values)
    return physical_from_json(j["plan"])
