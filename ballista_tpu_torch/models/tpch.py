"""TPC-H table schemas, vocabularies and a vectorized synthetic data generator.

Reference analog: the benchmark harness ``arrow-ballista: benchmarks/src/bin/tpch.rs``
(table schemas at ``get_schema``) and its ``convert`` subcommand. The reference
relies on external dbgen output; this build ships a deterministic numpy
generator instead (zero-egress environment), with dbgen-shaped vocabularies and
value distributions so every one of the 22 queries exercises its predicates.
Correctness is asserted against a pandas oracle over the same generated data.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ballista_tpu_torch.plan.schema import DataType, Schema

D = DataType

TPCH_TABLES = [
    "region",
    "nation",
    "supplier",
    "customer",
    "part",
    "partsupp",
    "orders",
    "lineitem",
]

TPCH_SCHEMAS: dict[str, Schema] = {
    "region": Schema.of(
        ("r_regionkey", D.INT64), ("r_name", D.STRING), ("r_comment", D.STRING)
    ),
    "nation": Schema.of(
        ("n_nationkey", D.INT64),
        ("n_name", D.STRING),
        ("n_regionkey", D.INT64),
        ("n_comment", D.STRING),
    ),
    "supplier": Schema.of(
        ("s_suppkey", D.INT64),
        ("s_name", D.STRING),
        ("s_address", D.STRING),
        ("s_nationkey", D.INT64),
        ("s_phone", D.STRING),
        ("s_acctbal", D.FLOAT64),
        ("s_comment", D.STRING),
    ),
    "customer": Schema.of(
        ("c_custkey", D.INT64),
        ("c_name", D.STRING),
        ("c_address", D.STRING),
        ("c_nationkey", D.INT64),
        ("c_phone", D.STRING),
        ("c_acctbal", D.FLOAT64),
        ("c_mktsegment", D.STRING),
        ("c_comment", D.STRING),
    ),
    "part": Schema.of(
        ("p_partkey", D.INT64),
        ("p_name", D.STRING),
        ("p_mfgr", D.STRING),
        ("p_brand", D.STRING),
        ("p_type", D.STRING),
        ("p_size", D.INT32),
        ("p_container", D.STRING),
        ("p_retailprice", D.FLOAT64),
        ("p_comment", D.STRING),
    ),
    "partsupp": Schema.of(
        ("ps_partkey", D.INT64),
        ("ps_suppkey", D.INT64),
        ("ps_availqty", D.INT32),
        ("ps_supplycost", D.FLOAT64),
        ("ps_comment", D.STRING),
    ),
    "orders": Schema.of(
        ("o_orderkey", D.INT64),
        ("o_custkey", D.INT64),
        ("o_orderstatus", D.STRING),
        ("o_totalprice", D.FLOAT64),
        ("o_orderdate", D.DATE32),
        ("o_orderpriority", D.STRING),
        ("o_clerk", D.STRING),
        ("o_shippriority", D.INT32),
        ("o_comment", D.STRING),
    ),
    "lineitem": Schema.of(
        ("l_orderkey", D.INT64),
        ("l_partkey", D.INT64),
        ("l_suppkey", D.INT64),
        ("l_linenumber", D.INT32),
        ("l_quantity", D.FLOAT64),
        ("l_extendedprice", D.FLOAT64),
        ("l_discount", D.FLOAT64),
        ("l_tax", D.FLOAT64),
        ("l_returnflag", D.STRING),
        ("l_linestatus", D.STRING),
        ("l_shipdate", D.DATE32),
        ("l_commitdate", D.DATE32),
        ("l_receiptdate", D.DATE32),
        ("l_shipinstruct", D.STRING),
        ("l_shipmode", D.STRING),
        ("l_comment", D.STRING),
    ),
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

# epoch day helpers: TPC-H dates span 1992-01-01 .. 1998-12-31
DATE_1992_01_01 = (np.datetime64("1992-01-01") - np.datetime64("1970-01-01")).astype(int)
DATE_1995_06_17 = (np.datetime64("1995-06-17") - np.datetime64("1970-01-01")).astype(int)
ORDERDATE_MAX = (np.datetime64("1998-08-02") - np.datetime64("1970-01-01")).astype(int)


def date32(s: str) -> int:
    """Parse 'YYYY-MM-DD' into days-since-epoch (int)."""
    return int((np.datetime64(s) - np.datetime64("1970-01-01")).astype(int))


def _strings(rng, choices: list[str], n: int) -> pa.Array:
    codes = rng.integers(0, len(choices), n, dtype=np.int32)
    return pa.DictionaryArray.from_arrays(pa.array(codes), pa.array(choices)).cast(pa.string())


def _comments(rng, n: int, nwords: int = 5, pool: int = 997) -> pa.Array:
    """Random comment strings drawn from a pool of word-combination sentences."""
    pool_rng = np.random.default_rng(7)
    sentences = [
        " ".join(pool_rng.choice(COMMENT_WORDS, nwords)) for _ in range(pool)
    ]
    return _strings(rng, sentences, n)


def _phones(rng, nationkeys: np.ndarray) -> pa.Array:
    cc = (10 + nationkeys).astype("U2")
    d1 = rng.integers(100, 1000, len(nationkeys)).astype("U3")
    d2 = rng.integers(100, 1000, len(nationkeys)).astype("U3")
    d3 = rng.integers(1000, 10000, len(nationkeys)).astype("U4")
    out = np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(np.char.add(
        cc, "-"), d1), "-"), d2), "-"), d3)
    return pa.array(out)


def _retailprice(partkey: np.ndarray) -> np.ndarray:
    return (90000 + ((partkey // 10) % 20001) + 100 * (partkey % 1000)) / 100.0


def _stable_seed(name: str, sf: float, seed: int) -> int:
    # crc32 of the label, NOT builtin hash(): str hashing is randomized per
    # process (PYTHONHASHSEED), which would make the "deterministic" generator
    # emit different data on every run.
    return zlib.crc32(f"{name}:{round(sf * 1000)}:{seed}".encode()) % (2**31)


def generate_table(name: str, sf: float, seed: int = 42) -> pa.Table:
    rng = np.random.default_rng(_stable_seed(name, sf, seed))
    schema = TPCH_SCHEMAS[name].to_arrow()

    if name == "region":
        return pa.table(
            {
                "r_regionkey": np.arange(5, dtype=np.int64),
                "r_name": pa.array(REGIONS),
                "r_comment": _comments(rng, 5),
            },
            schema=schema,
        )

    if name == "nation":
        return pa.table(
            {
                "n_nationkey": np.arange(25, dtype=np.int64),
                "n_name": pa.array([n for n, _ in NATIONS]),
                "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
                "n_comment": _comments(rng, 25),
            },
            schema=schema,
        )

    if name == "supplier":
        n = max(1, int(10_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, 25, n, dtype=np.int64)
        # ~0.05% of suppliers complain (q16 filters them out)
        comments = np.asarray(_comments(rng, n))
        bad = rng.random(n) < 0.0005 * max(1, 10)
        comments = np.where(bad, "sit Customer midst Complaints quick", comments)
        return pa.table(
            {
                "s_suppkey": keys,
                "s_name": pa.array(np.char.add("Supplier#", keys.astype("U9"))),
                "s_address": _comments(rng, n, nwords=3),
                "s_nationkey": nk,
                "s_phone": _phones(rng, nk),
                "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
                "s_comment": pa.array(comments.tolist()),
            },
            schema=schema,
        )

    if name == "customer":
        n = max(1, int(150_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        nk = rng.integers(0, 25, n, dtype=np.int64)
        return pa.table(
            {
                "c_custkey": keys,
                "c_name": pa.array(np.char.add("Customer#", keys.astype("U9"))),
                "c_address": _comments(rng, n, nwords=3),
                "c_nationkey": nk,
                "c_phone": _phones(rng, nk),
                "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n), 2),
                "c_mktsegment": _strings(rng, SEGMENTS, n),
                "c_comment": _comments(rng, n),
            },
            schema=schema,
        )

    if name == "part":
        n = max(1, int(200_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        name_pool = [" ".join(np.random.default_rng(11 + i).choice(COLORS, 5, replace=False)) for i in range(997)]
        brands = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
        types = [f"{a} {b} {c}" for a in TYPE_SYL1 for b in TYPE_SYL2 for c in TYPE_SYL3]
        containers = [f"{a} {b}" for a in CONTAINER_SYL1 for b in CONTAINER_SYL2]
        return pa.table(
            {
                "p_partkey": keys,
                "p_name": _strings(rng, name_pool, n),
                "p_mfgr": _strings(rng, [f"Manufacturer#{i}" for i in range(1, 6)], n),
                "p_brand": _strings(rng, brands, n),
                "p_type": _strings(rng, types, n),
                "p_size": rng.integers(1, 51, n, dtype=np.int32),
                "p_container": _strings(rng, containers, n),
                "p_retailprice": _retailprice(keys),
                "p_comment": _comments(rng, n, nwords=3),
            },
            schema=schema,
        )

    if name == "partsupp":
        nparts = max(1, int(200_000 * sf))
        nsupp = max(1, int(10_000 * sf))
        pk = np.repeat(np.arange(1, nparts + 1, dtype=np.int64), 4)
        # dbgen spreads each part across 4 distinct suppliers
        off = np.tile(np.arange(4, dtype=np.int64), nparts)
        sk = (pk + off * (nsupp // 4 + 1)) % nsupp + 1
        n = len(pk)
        return pa.table(
            {
                "ps_partkey": pk,
                "ps_suppkey": sk,
                "ps_availqty": rng.integers(1, 10_000, n, dtype=np.int32),
                "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n), 2),
                "ps_comment": _comments(rng, n),
            },
            schema=schema,
        )

    if name == "orders":
        ncust = max(1, int(150_000 * sf))
        n = max(1, int(1_500_000 * sf))
        keys = np.arange(1, n + 1, dtype=np.int64)
        # only customers with custkey % 3 != 0 place orders (dbgen convention; q22
        # depends on customers without orders existing)
        ck = rng.integers(1, max(2, ncust + 1), n, dtype=np.int64)
        ck = np.where(ck % 3 == 0, (ck % max(1, ncust)) + 1, ck)
        ck = np.where(ck % 3 == 0, np.maximum(1, ck - 1), ck)
        odate = rng.integers(DATE_1992_01_01, ORDERDATE_MAX + 1, n).astype(np.int32)
        comments = np.asarray(_comments(rng, n, nwords=6))
        special = rng.random(n) < 0.01
        comments = np.where(special, "was special limply express requests handle", comments)
        table = pa.table(
            {
                "o_orderkey": keys,
                "o_custkey": ck,
                "o_orderstatus": _strings(rng, ["F", "O", "P"], n),
                "o_totalprice": np.round(rng.uniform(850.0, 560_000.0, n), 2),
                "o_orderdate": odate,
                "o_orderpriority": _strings(rng, PRIORITIES, n),
                "o_clerk": pa.array(
                    np.char.add("Clerk#", rng.integers(1, max(2, int(1000 * sf) + 1), n).astype("U9"))
                ),
                "o_shippriority": np.zeros(n, dtype=np.int32),
                "o_comment": pa.array(comments.tolist()),
            },
            schema=schema,
        )
        return table

    if name == "lineitem":
        norders = max(1, int(1_500_000 * sf))
        nparts = max(1, int(200_000 * sf))
        nsupp = max(1, int(10_000 * sf))
        orders_tbl = generate_table("orders", sf, seed)
        per_order = np.random.default_rng(_stable_seed("lcount", sf, seed)).integers(1, 8, norders)
        okeys = np.repeat(np.asarray(orders_tbl["o_orderkey"]), per_order)
        odates = np.repeat(np.asarray(orders_tbl["o_orderdate"], dtype=np.int32), per_order)
        return _lineitem_columns(rng, okeys, odates, per_order, nparts, nsupp, schema)

    raise KeyError(name)


def _lineitem_columns(rng, okeys, odates, per_order, nparts, nsupp, schema) -> "pa.Table":
    """Shared lineitem column construction: the full-table generator and the
    chunked SF100 generator produce identical per-row distributions because
    they both call THIS (same formulas, same rng call order)."""
    n = len(okeys)
    linenum = np.concatenate([np.arange(1, c + 1) for c in per_order]).astype(np.int32)
    pk = rng.integers(1, nparts + 1, n, dtype=np.int64)
    # match partsupp pairing so (l_partkey, l_suppkey) joins hit partsupp rows
    off = rng.integers(0, 4, n, dtype=np.int64)
    sk = (pk + off * (nsupp // 4 + 1)) % nsupp + 1
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = np.round(qty * _retailprice(pk) / 10.0, 2)
    ship = (odates + rng.integers(1, 122, n)).astype(np.int32)
    commit = (odates + rng.integers(30, 91, n)).astype(np.int32)
    receipt = (ship + rng.integers(1, 31, n)).astype(np.int32)
    returned = receipt <= DATE_1995_06_17
    rf = np.where(returned, np.where(rng.random(n) < 0.5, "R", "A"), "N")
    ls = np.where(ship > DATE_1995_06_17, "O", "F")
    return pa.table(
        {
            "l_orderkey": okeys,
            "l_partkey": pk,
            "l_suppkey": sk,
            "l_linenumber": linenum,
            "l_quantity": qty,
            "l_extendedprice": price,
            "l_discount": np.round(rng.integers(0, 11, n) / 100.0, 2),
            "l_tax": np.round(rng.integers(0, 9, n) / 100.0, 2),
            "l_returnflag": pa.array(rf.tolist()),
            "l_linestatus": pa.array(ls.tolist()),
            "l_shipdate": ship,
            "l_commitdate": commit,
            "l_receiptdate": receipt,
            "l_shipinstruct": _strings(rng, SHIP_INSTRUCTS, n),
            "l_shipmode": _strings(rng, SHIP_MODES, n),
            "l_comment": _comments(rng, n, nwords=3),
        },
        schema=schema,
    )


def generate_lineitem_chunked(
    data_dir: str,
    sf: float,
    orders_per_chunk: int = 5_000_000,
    seed: int = 42,
) -> str:
    """Chunked lineitem-only datagen for SF100-class scans (VERDICT r4 #3):
    the table NEVER exists in RAM at once — peak memory is one chunk of
    ~orders_per_chunk*4 rows. Column distributions match ``generate_table``
    ("lineitem") but order dates are drawn directly (uniform over the dbgen
    date range, exactly the orders generator's distribution) instead of
    materializing the 150M-row orders table. Single-table queries (q1/q6)
    are distribution-faithful; FK-join consistency is NOT maintained — the
    SF1/SF10 oracle-verified sweeps cover join correctness, this covers
    scan/aggregate SCALE."""
    import pyarrow.parquet as pq

    tdir = os.path.join(data_dir, "lineitem")
    done = os.path.join(tdir, "_DONE")
    if os.path.exists(done):
        return tdir
    os.makedirs(tdir, exist_ok=True)
    leftovers = [f for f in os.listdir(tdir) if f.endswith(".parquet")]
    if leftovers:
        # a full-table generate_tpch run (or an interrupted chunked one)
        # already wrote files here; registering both sets would silently
        # double-count rows (the catalog globs *.parquet)
        raise RuntimeError(
            f"{tdir} holds {len(leftovers)} parquet files but no _DONE marker "
            "— refusing to mix chunked output with existing data; delete the "
            "directory first"
        )
    norders = max(1, int(1_500_000 * sf))
    nparts = max(1, int(200_000 * sf))
    nsupp = max(1, int(10_000 * sf))
    schema = TPCH_SCHEMAS["lineitem"].to_arrow()
    idx = 0
    start = 0
    while start < norders:
        m = min(orders_per_chunk, norders - start)
        rng = np.random.default_rng(_stable_seed(f"lchunk{idx}", sf, seed))
        per_order = rng.integers(1, 8, m)
        okeys = np.repeat(np.arange(start + 1, start + m + 1, dtype=np.int64), per_order)
        odates = np.repeat(
            rng.integers(DATE_1992_01_01, ORDERDATE_MAX + 1, m).astype(np.int32),
            per_order,
        )
        chunk = _lineitem_columns(rng, okeys, odates, per_order, nparts, nsupp, schema)
        pq.write_table(chunk, os.path.join(tdir, f"part-{idx:04d}.parquet"))
        start += m
        idx += 1
    open(done, "w").write(str(norders))
    return tdir


def generate_tpch(
    data_dir: str,
    sf: float,
    tables: list[str] | None = None,
    parts_per_table: int = 2,
    seed: int = 42,
) -> dict[str, str]:
    """Write TPC-H tables as (multi-file) parquet under ``data_dir``.

    Returns {table_name: directory}. Small tables are written as a single file;
    large ones into ``parts_per_table`` row-chunked files so scans parallelize
    (reference: one partition per file, tuning-guide.md).

    Each table is written into a private directory beside its target and
    renamed into place whole, so a table directory that exists is complete:
    processes that generate into one ``data_dir`` at once never read a file
    another is still writing, and a run killed midway leaves only a hidden
    ``.<table>.tmp-*`` directory that no later run adopts. When another
    process's rename wins, this one drops its copy and uses the winner's.
    """
    out: dict[str, str] = {}
    os.makedirs(data_dir, exist_ok=True)
    for name in tables or TPCH_TABLES:
        tdir = os.path.join(data_dir, name)
        if os.path.isdir(tdir) and os.listdir(tdir):
            if os.path.exists(os.path.join(tdir, "_DONE")):
                # generate_lineitem_chunked's marker: that data is
                # FK-INCONSISTENT by design (single-table q1/q6 only) —
                # silently adopting it would corrupt every join query
                raise RuntimeError(
                    f"{tdir} holds chunked single-table data (_DONE marker); "
                    "it cannot back multi-table runs — delete it or use "
                    "--chunked-lineitem"
                )
            out[name] = tdir
            continue
        tmp = tempfile.mkdtemp(prefix=f".{name}.tmp-", dir=data_dir)
        table = generate_table(name, sf, seed)
        nparts = 1 if name in ("region", "nation", "supplier") else parts_per_table
        rows = table.num_rows
        step = (rows + nparts - 1) // nparts if rows else 1
        for i in range(nparts):
            chunk = table.slice(i * step, step)
            pq.write_table(chunk, os.path.join(tmp, f"part-{i}.parquet"))
        os.chmod(tmp, 0o755)  # mkdtemp's 0700 would hide the table from other users
        try:
            # replaces a missing or empty directory; fails on a full one
            os.rename(tmp, tdir)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if not (os.path.isdir(tdir) and os.listdir(tdir)):
                raise
        out[name] = tdir
    return out
