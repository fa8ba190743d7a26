"""TPC-H Q12, shipping modes and order priority: exact answer for
SHIPMODE1, SHIPMODE2 and DATE."""
import numpy as np

from reference import add_years, day, index


def answer(t, p) -> dict:
    pri = t("orders", "o_orderpriority")
    high_of = index(t("orders", "o_orderkey"), pri.isin(["1-URGENT", "2-HIGH"]), False)
    recv, commit = t("lineitem", "l_receiptdate"), t("lineitem", "l_commitdate")
    mode = t("lineitem", "l_shipmode")
    m = (mode.isin([p["SHIPMODE1"], p["SHIPMODE2"]]) & (commit < recv)
         & (t("lineitem", "l_shipdate") < commit)
         & (recv >= day(p["DATE"])) & (recv < day(add_years(p["DATE"], 1))))
    high = high_of[t("lineitem", "l_orderkey")[m]]
    modes = mode.values(np.nonzero(m)[0])
    out: dict = {"l_shipmode": [], "high_line_count": [], "low_line_count": []}
    for name in sorted(set(modes)):
        sel = modes == name
        out["l_shipmode"].append(name)
        out["high_line_count"].append(int((high & sel).sum()))
        out["low_line_count"].append(int((~high & sel).sum()))
    return out
