"""Stand-ins for the two numbers that the program's own lower precision
cannot fail. The control ``ballista.tpu.native_dtypes=false`` (decimals as
float64 on the card) reads closer to the exact answer than the port does on
q1's AVGs (``avg_rel_gap``) and on q1's ``sum_charge`` (``sum_gap``), so it
sets no upper reading for them. Each stand-in is the reference put in the
program's place with one step taken at a lower precision, on the card:

- ``avg_bf16``, ``avg_fp16``: every AVG the quotient of its exact sum and
  count, carried in float32 and rounded to bfloat16 (the precision below the
  float32 the engine divides in) or to float16: the gentlest such path;
- ``sum_f32``: ``sum_charge`` from each row's exact charge, accumulated in
  float32 by ``torch.sum``.

Its answer goes through ``reference.compare`` like the program's, and has to
come out not correct against the configuration's limits. The benchmark's
runs never run it; ``tests/test_portbench_standins.py`` does, and

    python3 portbench/standins.py --config tpch1-standalone --sf 1 --seeds 11 12 13

prints the readings at a cell's own size, one JSON line per seed, DELTA and
stand-in, for q1's validation DELTA and both ends of its qgen range.

Imports nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import datagen  # noqa: E402
import reference  # noqa: E402
from reference import day  # noqa: E402

STANDINS = ("avg_bf16", "avg_fp16", "sum_f32")
# q1's AVG columns and the column each averages
AVGS = {"avg_qty": "l_quantity", "avg_price": "l_extendedprice", "avg_disc": "l_discount"}


def q1_answer(t: reference.Tables, params: dict, standin: str, device: str) -> dict:
    """q1's exact answer with one step taken at the stand-in's precision."""
    import torch

    exact = reference.answer(t, "q1", params)
    out = {k: list(v) for k, v in exact.items()}
    keep = t("lineitem", "l_shipdate") <= day("1998-12-01") - int(params["DELTA"])
    rf, ls = t("lineitem", "l_returnflag"), t("lineitem", "l_linestatus")
    cents = {c: t.cents("lineitem", c) for c in
             ("l_quantity", "l_extendedprice", "l_discount", "l_tax")}
    for i, (f, s) in enumerate(zip(exact["l_returnflag"], exact["l_linestatus"])):
        m = keep & rf.eq(f) & ls.eq(s)
        if standin == "sum_f32":
            price, disc, tax = (cents[c][m] for c in ("l_extendedprice", "l_discount", "l_tax"))
            charge = price * (100 - disc) * (100 + tax) / 1e6
            x = torch.as_tensor(charge, dtype=torch.float32, device=device)
            out["sum_charge"][i] = float(x.sum())
            continue
        low = {"avg_bf16": torch.bfloat16, "avg_fp16": torch.float16}[standin]
        n = torch.tensor(float(m.sum()), dtype=torch.float32, device=device)
        for avg, col in AVGS.items():
            total = torch.tensor(int(cents[col][m].sum()) / 100, dtype=torch.float32,
                                 device=device)
            out[avg][i] = float((total / n).to(low))
    return out


def readings(t: reference.Tables, params: dict, standin: str, device: str) -> dict:
    """``reference.compare`` of the stand-in's answer against the exact one."""
    import pyarrow as pa

    import traffic

    exact = reference.answer(t, "q1", params)
    got = pa.table(q1_answer(t, params, standin, device))
    return reference.compare(got, exact, traffic.query_spec("q1").get("inexact", {}))


def deltas() -> list:
    """q1's validation DELTA and both ends of its qgen range."""
    import traffic

    spec = traffic.query_spec("q1")
    lo, hi = spec["qgen"]["DELTA"]["int"]
    return sorted({spec["validation"]["DELTA"], lo, hi})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", default="tpch1-standalone")
    p.add_argument("--sf", type=float, default=None, help="default: the configuration's")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    with open(os.path.join(HERE, "configs", f"{args.config}.json")) as f:
        config = json.load(f)
    sf = config["scale_factor"] if args.sf is None else args.sf
    limits = config["limits"]
    for seed in args.seeds:
        t = reference.Tables(datagen.make_tables(sf, seed, ["lineitem"]))
        for delta in deltas():
            for standin in STANDINS:
                r = readings(t, {"DELTA": delta}, standin, args.device)
                correct = all(r[k] <= limits[k] for k in r)
                print(json.dumps({"seed": seed, "sf": sf, "DELTA": delta, "standin": standin,
                                  "correct": correct, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
