"""The exact reference: right on tables built by hand, and in agreement
with the port on the CPU for drawn literals."""
import pyarrow as pa
import pytest

from conftest import SF

import datagen
import reference
import run
import traffic


def tables_by_hand():
    d = lambda iso: datagen.day(iso)  # noqa: E731
    li = pa.table({
        "l_orderkey": [1, 1, 2, 3],
        "l_suppkey": [1, 2, 1, 2],
        "l_quantity": [10.0, 20.0, 30.0, 5.0],
        "l_extendedprice": [100.0, 200.5, 300.25, 50.0],
        "l_discount": [0.05, 0.06, 0.07, 0.10],
        "l_tax": [0.01, 0.02, 0.0, 0.08],
        "l_returnflag": ["A", "A", "N", "R"],
        "l_linestatus": ["F", "F", "O", "F"],
        "l_shipdate": pa.array([d("1994-02-01"), d("1995-03-20"), d("1998-09-01"),
                                d("1998-10-01")], pa.int32()).cast(pa.date32()),
        "l_commitdate": pa.array([d("1994-03-01"), d("1995-04-01"), d("1998-09-10"),
                                  d("1998-10-05")], pa.int32()).cast(pa.date32()),
        "l_receiptdate": pa.array([d("1994-03-05"), d("1995-04-10"), d("1998-09-20"),
                                   d("1998-10-09")], pa.int32()).cast(pa.date32()),
        "l_shipmode": ["MAIL", "SHIP", "MAIL", "AIR"],
    })
    orders = pa.table({
        "o_orderkey": [1, 2, 3], "o_custkey": [1, 2, 1],
        "o_orderdate": pa.array([d("1994-01-10"), d("1995-03-01"), d("1998-08-01")],
                                pa.int32()).cast(pa.date32()),
        "o_shippriority": pa.array([0, 0, 0], pa.int32()),
        "o_orderpriority": ["1-URGENT", "3-MEDIUM", "2-HIGH"],
    })
    customer = pa.table({"c_custkey": [1, 2], "c_mktsegment": ["BUILDING", "MACHINERY"],
                         "c_nationkey": [8, 9]})
    supplier = pa.table({"s_suppkey": [1, 2], "s_nationkey": [8, 12]})
    nation = pa.table({"n_nationkey": [8, 9, 12], "n_name": ["INDIA", "INDONESIA", "JAPAN"],
                       "n_regionkey": [2, 2, 2]})
    region = pa.table({"r_regionkey": [2], "r_name": ["ASIA"]})
    return reference.Tables({"lineitem": li, "orders": orders, "customer": customer,
                             "supplier": supplier, "nation": nation, "region": region})


def test_q1_by_hand():
    got = reference.answer(tables_by_hand(), "q1", {"DELTA": 90})
    # 1998-09-02 and before: the A/F pair (rows 1, 2) and N/O (row 3)
    assert got["l_returnflag"] == ["A", "N"] and got["count_order"] == [2, 1]
    assert got["sum_qty"] == [30.0, 30.0] and got["sum_base_price"] == [300.5, 300.25]
    assert got["sum_disc_price"] == [(10000 * 95 + 20050 * 94) / 10**4, 30025 * 93 / 10**4]
    assert got["sum_charge"] == [(10000 * 95 * 101 + 20050 * 94 * 102) / 10**6,
                                 30025 * 93 * 100 / 10**6]
    assert got["avg_disc"] == [0.055, 0.07]


def test_q3_q5_q6_q12_by_hand():
    t = tables_by_hand()
    q3 = reference.answer(t, "q3", {"SEGMENT": "BUILDING", "DATE": "1995-03-15"})
    assert q3 == {"l_orderkey": [1], "revenue": [20050 * 94 / 10**4],
                  "o_orderdate": [datagen.day("1994-01-10")], "o_shippriority": [0]}
    q5 = reference.answer(t, "q5", {"REGION": "ASIA", "DATE": "1994-01-01"})
    # order 1's customer and line 1's supplier share INDIA; line 2's is JAPAN
    assert q5 == {"n_name": ["INDIA"], "revenue": [10000 * 95 / 10**4]}
    q6 = reference.answer(t, "q6", {"DATE": "1994-01-01", "DISCOUNT": "0.06", "QUANTITY": 24})
    assert q6 == {"revenue": [10000 * 5 / 10**4]}
    q12 = reference.answer(t, "q12", {"SHIPMODE1": "MAIL", "SHIPMODE2": "SHIP",
                                      "DATE": "1994-01-01"})
    assert q12 == {"l_shipmode": ["MAIL"], "high_line_count": [1], "low_line_count": [0]}


def test_compare_counts_what_differs():
    exact = {"k": [1, 2], "s": [1.5, 2.5], "avg_x": [1.0, 2.0]}
    table = pa.table({"k": [1, 3], "s": [1.5, 2.0], "avg_x": [1.0, 2.02]})
    got = reference.compare(table, exact, {"s": "sum", "avg_x": "avg"})
    assert got == {"mismatches": 1, "sum_gap": 0.5, "avg_rel_gap": pytest.approx(0.01)}
    short = reference.compare(table.slice(0, 1), exact, {})
    assert short["mismatches"] == 6


@pytest.fixture(scope="module")
def port_and_tables(tmp_path_factory):
    from ballista_tpu_torch.client.context import BallistaContext

    tables = datagen.make_tables(SF, 2**31 + 99, run.load("configs", "tpch1-standalone")["tables"])
    paths = datagen.write_tables(tables, str(tmp_path_factory.mktemp("tpch")), 2)
    ctx = BallistaContext.standalone(device="cpu")
    for name, path in paths.items():
        ctx.register_parquet(name, path)
    return ctx, reference.Tables(tables)


def test_reference_agrees_with_the_port_on_drawn_literals(port_and_tables):
    ctx, cols = port_and_tables
    specs = {q: traffic.query_spec(q) for q in ("q1", "q3", "q5", "q6", "q12")}
    cases = [traffic.instance(q, s, s["validation"]) for q, s in specs.items()]
    cases += [traffic.instance(q, s, p) for q, s in specs.items()
              for p in traffic.ordered_grid(s, 2024, q)[:3]]
    cases += [traffic.instance("q6", specs["q6"], dict(specs["q6"]["validation"],
                                                      DISCOUNT=f"0.0{d}")) for d in range(2, 10)]
    for inst in cases:
        got = ctx.sql(inst.sql).collect()
        want = reference.answer(cols, inst.query, dict(inst.params))
        diff = reference.compare(got, want, specs[inst.query].get("inexact", {}))
        assert diff["mismatches"] == 0, (inst.query, inst.params, got.to_pylist(), want)
        assert diff["sum_gap"] < 1e-6 and diff["avg_rel_gap"] < 1e-6, (inst, diff)
