"""TPC-H Q5, local supplier volume: exact answer for REGION and DATE."""
import numpy as np

from reference import add_years, day, index, lookup


def answer(t, p) -> dict:
    price, disc = t.cents("lineitem", "l_extendedprice"), t.cents("lineitem", "l_discount")
    rkeys = t("region", "r_regionkey")[t("region", "r_name").eq(p["REGION"])]
    nkeys = t("nation", "n_nationkey")
    in_region = index(nkeys, np.isin(t("nation", "n_regionkey"), rkeys), False)
    od = t("orders", "o_orderdate")
    oy = (od >= day(p["DATE"])) & (od < day(add_years(p["DATE"], 1)))
    cust_of = index(t("orders", "o_orderkey")[oy], t("orders", "o_custkey")[oy], -1)
    c_nat = index(t("customer", "c_custkey"), t("customer", "c_nationkey"), -1)
    s_nat = index(t("supplier", "s_suppkey"), t("supplier", "s_nationkey"), -1)
    oc = lookup(cust_of, t("lineitem", "l_orderkey"), -1)
    sn = s_nat[t("lineitem", "l_suppkey")]
    lk = (oc >= 0) & (c_nat[np.maximum(oc, 0)] == sn) & in_region[sn]
    by_nation = np.zeros(len(in_region), np.int64)
    np.add.at(by_nation, sn[lk], price[lk] * (100 - disc[lk]))
    present = np.unique(sn[lk])
    names = index(nkeys, t("nation", "n_name").values(), None)
    order = present[np.argsort(-by_nation[present], kind="stable")]
    return {"n_name": [names[k] for k in order],
            "revenue": [int(by_nation[k]) / 10**4 for k in order]}
