"""TPC-H Q3, shipping priority: exact answer for SEGMENT and DATE."""
import numpy as np

from reference import day, index, lookup


def answer(t, p) -> dict:
    cut = day(p["DATE"])
    price, disc = t.cents("lineitem", "l_extendedprice"), t.cents("lineitem", "l_discount")
    building = index(t("customer", "c_custkey"), t("customer", "c_mktsegment").eq(p["SEGMENT"]),
                     False)
    odate_all = t("orders", "o_orderdate")
    ok = (odate_all < cut) & lookup(building, t("orders", "o_custkey"), False)
    okeys = t("orders", "o_orderkey")[ok]
    at = lookup(index(okeys, np.arange(len(okeys)), -1), t("lineitem", "l_orderkey"), -1)
    lk = (t("lineitem", "l_shipdate") > cut) & (at >= 0)
    sums = np.zeros(len(okeys), np.int64)
    np.add.at(sums, at[lk], price[lk] * (100 - disc[lk]))
    seen = np.zeros(len(okeys), bool)
    seen[at[lk]] = True
    cand = np.nonzero(seen)[0]
    odate = odate_all[ok]
    top = cand[np.lexsort((odate[cand], -sums[cand]))][:10]
    return {
        "l_orderkey": okeys[top].tolist(),
        "revenue": [int(v) / 10**4 for v in sums[top]],
        "o_orderdate": odate[top].tolist(),
        "o_shippriority": t("orders", "o_shippriority")[ok][top].tolist(),
    }
