"""TPC-H tables made from a seed: the benchmark's own frozen copy of the
port's generator (``ballista_tpu_torch/models/tpch.py``).

The tables are equal, value for value and type for type, to what that
generator gives for the same scale factor and seed (a CPU test holds the two
together), so the benchmark stands on the data the port's records used. The
value distributions approximate dbgen's (vocabularies, key ranges, date
offsets); they are not dbgen's output.

Two changes make it quicker without changing a value: ``l_linenumber`` is
computed without a Python loop, and lineitem reuses the orders table it was
given instead of making it again. Only the tables a caller asks for are made.

Imports nothing of the port.
"""
from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

TABLES = ("region", "nation", "supplier", "customer", "part", "partsupp", "orders", "lineitem")
# tables written as one file; the others are split into ``parts`` files
SMALL = ("region", "nation", "supplier")
# threads writing parquet files at once
WRITERS = 4

_S, _I32, _I64, _F64, _D = pa.string(), pa.int32(), pa.int64(), pa.float64(), pa.date32()
SCHEMAS = {
    "region": [("r_regionkey", _I64), ("r_name", _S), ("r_comment", _S)],
    "nation": [("n_nationkey", _I64), ("n_name", _S), ("n_regionkey", _I64), ("n_comment", _S)],
    "supplier": [("s_suppkey", _I64), ("s_name", _S), ("s_address", _S), ("s_nationkey", _I64),
                 ("s_phone", _S), ("s_acctbal", _F64), ("s_comment", _S)],
    "customer": [("c_custkey", _I64), ("c_name", _S), ("c_address", _S), ("c_nationkey", _I64),
                 ("c_phone", _S), ("c_acctbal", _F64), ("c_mktsegment", _S), ("c_comment", _S)],
    "part": [("p_partkey", _I64), ("p_name", _S), ("p_mfgr", _S), ("p_brand", _S),
             ("p_type", _S), ("p_size", _I32), ("p_container", _S), ("p_retailprice", _F64),
             ("p_comment", _S)],
    "partsupp": [("ps_partkey", _I64), ("ps_suppkey", _I64), ("ps_availqty", _I32),
                 ("ps_supplycost", _F64), ("ps_comment", _S)],
    "orders": [("o_orderkey", _I64), ("o_custkey", _I64), ("o_orderstatus", _S),
               ("o_totalprice", _F64), ("o_orderdate", _D), ("o_orderpriority", _S),
               ("o_clerk", _S), ("o_shippriority", _I32), ("o_comment", _S)],
    "lineitem": [("l_orderkey", _I64), ("l_partkey", _I64), ("l_suppkey", _I64),
                 ("l_linenumber", _I32), ("l_quantity", _F64), ("l_extendedprice", _F64),
                 ("l_discount", _F64), ("l_tax", _F64), ("l_returnflag", _S),
                 ("l_linestatus", _S), ("l_shipdate", _D), ("l_commitdate", _D),
                 ("l_receiptdate", _D), ("l_shipinstruct", _S), ("l_shipmode", _S),
                 ("l_comment", _S)],
}

NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1), ("EGYPT", 4),
    ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3), ("INDIA", 2), ("INDONESIA", 2),
    ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0),
    ("MOROCCO", 0), ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1),
]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
TYPE_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_SYL1 = ["SM", "MED", "JUMBO", "WRAP", "LG"]
CONTAINER_SYL2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIP_MODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIP_INSTRUCTS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black", "blanched",
    "blue", "blush", "brown", "burlywood", "burnished", "chartreuse", "chiffon",
    "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
    "dim", "dodger", "drab", "firebrick", "floral", "forest", "frosted", "gainsboro",
    "ghost", "goldenrod", "green", "grey", "honeydew", "hot", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin", "navajo",
    "navy", "olive", "orange", "orchid", "pale", "papaya", "peach", "peru", "pink",
    "plum", "powder", "puff", "purple", "red", "rose", "rosy", "royal", "saddle",
    "salmon", "sandy", "seashell", "sienna", "sky", "slate", "smoke", "snow", "spring",
    "steel", "tan", "thistle", "tomato", "turquoise", "violet", "wheat", "white",
    "yellow",
]
COMMENT_WORDS = [
    "carefully", "quickly", "furiously", "slyly", "blithely", "final", "bold",
    "regular", "express", "ironic", "pending", "silent", "even", "daring", "unusual",
    "packages", "deposits", "requests", "accounts", "instructions", "foxes",
    "platelets", "pinto", "beans", "theodolites", "dependencies", "ideas", "sleep",
    "haggle", "nag", "wake", "cajole", "detect", "special", "across", "above",
    "against", "along",
]


def day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return int(np.datetime64(iso, "D").astype(np.int64))


DATE_1992_01_01 = day("1992-01-01")
DATE_1995_06_17 = day("1995-06-17")
ORDERDATE_MAX = day("1998-08-02")


def schema(name: str) -> pa.Schema:
    return pa.schema(SCHEMAS[name])


def _strings(rng, choices: list, n: int) -> pa.Array:
    codes = rng.integers(0, len(choices), n, dtype=np.int32)
    return pa.DictionaryArray.from_arrays(pa.array(codes), pa.array(choices)).cast(pa.string())


def _comments(rng, n: int, nwords: int = 5, pool: int = 997) -> pa.Array:
    pool_rng = np.random.default_rng(7)
    sentences = [" ".join(pool_rng.choice(COMMENT_WORDS, nwords)) for _ in range(pool)]
    return _strings(rng, sentences, n)


def _phones(rng, nationkeys: np.ndarray) -> pa.Array:
    cc = (10 + nationkeys).astype("U2")
    d1 = rng.integers(100, 1000, len(nationkeys)).astype("U3")
    d2 = rng.integers(100, 1000, len(nationkeys)).astype("U3")
    d3 = rng.integers(1000, 10000, len(nationkeys)).astype("U4")
    out = cc
    for part in ("-", d1, "-", d2, "-", d3):
        out = np.char.add(out, part)
    return pa.array(out)


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    return (90000 + ((partkey // 10) % 20001) + 100 * (partkey % 1000)) / 100.0


def _stable_seed(name: str, sf: float, seed: int) -> int:
    return zlib.crc32(f"{name}:{round(sf * 1000)}:{seed}".encode()) % (2**31)


def make_table(name: str, sf: float, seed: int, orders: pa.Table = None) -> pa.Table:
    """One table. ``orders``, for lineitem, is this scale and seed's orders
    table (made here when not given)."""
    rng = np.random.default_rng(_stable_seed(name, sf, seed))
    sch = schema(name)
    if name == "region":
        return pa.table({"r_regionkey": np.arange(5, dtype=np.int64),
                         "r_name": pa.array(REGIONS), "r_comment": _comments(rng, 5)}, schema=sch)
    if name == "nation":
        return pa.table({"n_nationkey": np.arange(25, dtype=np.int64),
                         "n_name": pa.array([n for n, _ in NATIONS]),
                         "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
                         "n_comment": _comments(rng, 25)}, schema=sch)
    if name == "supplier":
        n = max(1, int(10_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, 25, n, dtype=np.int64)
        comments = np.asarray(_comments(rng, n))
        bad = rng.random(n) < 0.0005 * 10
        comments = np.where(bad, "sit Customer midst Complaints quick", comments)
        return pa.table({
            "s_suppkey": keys, "s_name": pa.array(np.char.add("Supplier#", keys.astype("U9"))),
            "s_address": _comments(rng, n, nwords=3), "s_nationkey": nk,
            "s_phone": _phones(rng, nk), "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
            "s_comment": pa.array(comments.tolist())}, schema=sch)
    if name == "customer":
        n = max(1, int(150_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, 25, n, dtype=np.int64)
        return pa.table({
            "c_custkey": keys, "c_name": pa.array(np.char.add("Customer#", keys.astype("U9"))),
            "c_address": _comments(rng, n, nwords=3), "c_nationkey": nk,
            "c_phone": _phones(rng, nk), "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
            "c_mktsegment": _strings(rng, SEGMENTS, n), "c_comment": _comments(rng, n)},
            schema=sch)
    if name == "part":
        n = max(1, int(200_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        name_pool = [" ".join(np.random.default_rng(11 + i).choice(COLORS, 5, replace=False))
                     for i in range(997)]
        brands = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
        types = [f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2 for c in TYPE_SYL3]
        containers = [f"{a} {b}" for a in CONTAINER_SYL1 for b in CONTAINER_SYL2]
        return pa.table({
            "p_partkey": keys, "p_name": _strings(rng, name_pool, n),
            "p_mfgr": _strings(rng, [f"Manufacturer#{i}" for i in range(1, 6)], n),
            "p_brand": _strings(rng, brands, n), "p_type": _strings(rng, types, n),
            "p_size": rng.integers(1, 51, n, dtype=np.int32),
            "p_container": _strings(rng, containers, n), "p_retailprice": _retailprice(keys),
            "p_comment": _comments(rng, n, nwords=3)}, schema=sch)
    if name == "partsupp":
        nparts, nsupp = max(1, int(200_000 * sf)), max(1, int(10_000 * sf))
        pk = np.repeat(np.arange(1, nparts + 1, dtype=np.int64), 4)
        off = np.tile(np.arange(4, dtype=np.int64), nparts)
        sk = (pk + off * (nsupp // 4 + 1)) % nsupp + 1
        n = len(pk)
        return pa.table({
            "ps_partkey": pk, "ps_suppkey": sk,
            "ps_availqty": rng.integers(1, 10_000, n, dtype=np.int32),
            "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n), 2),
            "ps_comment": _comments(rng, n)}, schema=sch)
    if name == "orders":
        ncust, n = max(1, int(150_000 * sf)), max(1, int(1_500_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        ck = rng.integers(1, max(2, ncust + 1), n, dtype=np.int64)
        ck = np.where(ck % 3 == 0, (ck % max(1, ncust)) + 1, ck)
        ck = np.where(ck % 3 == 0, np.maximum(1, ck - 1), ck)
        odate = rng.integers(DATE_1992_01_01, ORDERDATE_MAX + 1, n).astype(np.int32)
        comments = np.asarray(_comments(rng, n, nwords=6))
        special = rng.random(n) < 0.01
        comments = np.where(special, "was special limply express requests handle", comments)
        return pa.table({
            "o_orderkey": keys, "o_custkey": ck, "o_orderstatus": _strings(rng, ["F", "O", "P"], n),
            "o_totalprice": np.round(rng.uniform(850.0, 560_000.0, n), 2), "o_orderdate": odate,
            "o_orderpriority": _strings(rng, PRIORITIES, n),
            "o_clerk": pa.array(np.char.add(
                "Clerk#", rng.integers(1, max(2, int(1000 * sf) + 1), n).astype("U9"))),
            "o_shippriority": np.zeros(n, dtype=np.int32),
            "o_comment": pa.array(comments.tolist())}, schema=sch)
    if name == "lineitem":
        norders = max(1, int(1_500_000 * sf))
        nparts, nsupp = max(1, int(200_000 * sf)), max(1, int(10_000 * sf))
        if orders is None:
            orders = make_table("orders", sf, seed)
        per_order = np.random.default_rng(_stable_seed("lcount", sf, seed)).integers(1, 8, norders)
        okeys = np.repeat(np.asarray(orders["o_orderkey"]), per_order)
        odates = np.repeat(np.asarray(orders["o_orderdate"]).astype(np.int32), per_order)
        return _lineitem(rng, okeys, odates, per_order, nparts, nsupp, sch)
    raise KeyError(name)


def _lineitem(rng, okeys, odates, per_order, nparts, nsupp, sch) -> pa.Table:
    n = len(okeys)
    starts = np.repeat(np.cumsum(per_order) - per_order, per_order)
    linenum = (np.arange(n) - starts + 1).astype(np.int32)
    pk = rng.integers(1, nparts + 1, n, dtype=np.int64)
    off = rng.integers(0, 4, n, dtype=np.int64)
    sk = (pk + off * (nsupp // 4 + 1)) % nsupp + 1
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = np.round(qty * _retailprice(pk) / 10.0, 2)
    ship = (odates + rng.integers(1, 122, n)).astype(np.int32)
    commit = (odates + rng.integers(30, 91, n)).astype(np.int32)
    receipt = (ship + rng.integers(1, 31, n)).astype(np.int32)
    returned = receipt <= DATE_1995_06_17
    # R or A where returned, N elsewhere; O after 1995-06-17, F before
    rf_code = np.where(returned, np.where(rng.random(n) < 0.5, 0, 1), 2).astype(np.int32)
    ls_code = (ship > DATE_1995_06_17).astype(np.int32)

    def coded(codes, words):
        return pa.DictionaryArray.from_arrays(pa.array(codes), pa.array(words)).cast(pa.string())

    return pa.table({
        "l_orderkey": okeys, "l_partkey": pk, "l_suppkey": sk, "l_linenumber": linenum,
        "l_quantity": qty, "l_extendedprice": price,
        "l_discount": np.round(rng.integers(0, 11, n) / 100.0, 2),
        "l_tax": np.round(rng.integers(0, 9, n) / 100.0, 2),
        "l_returnflag": coded(rf_code, ["R", "A", "N"]),
        "l_linestatus": coded(ls_code, ["F", "O"]),
        "l_shipdate": ship, "l_commitdate": commit, "l_receiptdate": receipt,
        "l_shipinstruct": _strings(rng, SHIP_INSTRUCTS, n),
        "l_shipmode": _strings(rng, SHIP_MODES, n),
        "l_comment": _comments(rng, n, nwords=3)}, schema=sch)


def make_tables(sf: float, seed: int, names) -> dict:
    """{name: pa.Table} for ``names``, lineitem from the orders made here."""
    out: dict = {}
    for name in TABLES:
        if name in names or (name == "orders" and "lineitem" in names):
            out[name] = make_table(name, sf, seed, orders=out.get("orders"))
    return {name: out[name] for name in names}


def write_tables(tables: dict, root: str, parts: int) -> dict:
    """Each table as parquet under ``root/<name>/part-<i>.parquet``, the
    large ones in ``parts`` row-chunked files, the files written by a few
    threads at once; {name: directory}."""
    out, files = {}, []
    for name, table in tables.items():
        tdir = os.path.join(root, name)
        os.makedirs(tdir, exist_ok=True)
        n = 1 if name in SMALL else parts
        step = (table.num_rows + n - 1) // n if table.num_rows else 1
        files += [(table.slice(i * step, step), os.path.join(tdir, f"part-{i}.parquet"))
                  for i in range(n)]
        out[name] = tdir
    with ThreadPoolExecutor(WRITERS) as pool:
        for done in [pool.submit(pq.write_table, t, path) for t, path in files]:
            done.result()
    return out
