"""TPC-H Q1, pricing summary report: exact answer for the substitution
parameter DELTA (days before 1998-12-01)."""
import numpy as np

from reference import day


def answer(t, p) -> dict:
    days = t("lineitem", "l_shipdate")
    qty, price, disc, tax = (t.cents("lineitem", c) for c in
                             ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    rf, ls = t("lineitem", "l_returnflag"), t("lineitem", "l_linestatus")
    keep = days <= day("1998-12-01") - int(p["DELTA"])
    pair = rf.codes.astype(np.int64) * len(ls.words) + ls.codes
    groups = sorted((rf.words[g // len(ls.words)], ls.words[g % len(ls.words)], g)
                    for g in np.unique(pair[keep]))
    out: dict = {}
    for f, s, g in groups:
        m = keep & (pair == g)
        n = int(m.sum())
        rev = price[m] * (100 - disc[m])
        sq, sp, sd = int(qty[m].sum()), int(price[m].sum()), int(disc[m].sum())
        row = {
            "l_returnflag": f, "l_linestatus": s,
            "sum_qty": sq / 100, "sum_base_price": sp / 100,
            "sum_disc_price": int(rev.sum()) / 10**4,
            "sum_charge": int((rev * (100 + tax[m])).sum()) / 10**6,
            "avg_qty": sq / (100 * n), "avg_price": sp / (100 * n), "avg_disc": sd / (100 * n),
            "count_order": n,
        }
        for k, v in row.items():
            out.setdefault(k, []).append(v)
    return out or {k: [] for k in (
        "l_returnflag", "l_linestatus", "sum_qty", "sum_base_price", "sum_disc_price",
        "sum_charge", "avg_qty", "avg_price", "avg_disc", "count_order")}
