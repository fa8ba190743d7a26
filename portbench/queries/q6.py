"""TPC-H Q6, forecasting revenue change: exact answer for DATE, DISCOUNT
and QUANTITY, with decimal semantics (DISCOUNT - 0.01 and + 0.01 exactly)."""
from reference import add_years, day


def answer(t, p) -> dict:
    days = t("lineitem", "l_shipdate")
    price, disc = t.cents("lineitem", "l_extendedprice"), t.cents("lineitem", "l_discount")
    qty = t.cents("lineitem", "l_quantity")
    d = round(float(p["DISCOUNT"]) * 100)
    m = ((days >= day(p["DATE"])) & (days < day(add_years(p["DATE"], 1)))
         & (disc >= d - 1) & (disc <= d + 1) & (qty < 100 * int(p["QUANTITY"])))
    # SUM over no rows is NULL
    return {"revenue": [int((price[m] * disc[m]).sum()) / 10**4 if m.any() else None]}
