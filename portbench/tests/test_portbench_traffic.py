"""The traffic generator: the same seed gives the same instances, drawn
literals lie in TPC-H clause 2.4's ranges, and no combination repeats
before the grid is spent."""
import datetime

import run
import traffic

def two_streams():
    """The ad-hoc mix sent by two streams."""
    return dict(run.load("workloads", "tpch1-sa-adhoc"), streams=2)


def instances(cell, seed, stream, n):
    mix = cell if isinstance(cell, dict) else run.load("workloads", cell)
    s = traffic.Stream(mix, seed, stream)
    return [s.next() for _ in range(n)]


def test_same_seed_same_instances_other_seed_other_ones():
    for cell in ("tpch1-sa-repeat", "tpch1-sa-adhoc", two_streams()):
        a = instances(cell, 2**31 + 11, 0, 40)
        assert a == instances(cell, 2**31 + 11, 0, 40)
        assert len({i.query for i in a}) == 5
    assert instances("tpch1-sa-adhoc", 7, 0, 40) != instances("tpch1-sa-adhoc", 8, 0, 40)
    assert instances(two_streams(), 7, 0, 40) != instances(two_streams(), 7, 1, 40)


def test_repeat_sends_the_validation_literals_round_robin():
    got = instances("tpch1-sa-repeat", 3, 0, 10)
    assert [i.sql for i in got[:5]] == [i.sql for i in got[5:]]
    q6 = next(i for i in got if i.query == "q6")
    assert "l_discount between 0.06 - 0.01 and 0.06 + 0.01" in q6.sql
    assert "l_quantity < 24" in q6.sql and "date '1994-01-01'" in q6.sql


def test_qgen_draws_lie_in_clause_2_4_ranges():
    seen = {}
    for seed in range(20):
        for inst in instances("tpch1-sa-adhoc", 10**9 + seed, 0, 25):
            p = dict(inst.params)
            seen.setdefault(inst.query, []).append(p)
            assert "{" not in inst.sql
    assert all(60 <= p["DELTA"] <= 120 for p in seen["q1"])
    for p in seen["q3"]:
        d = datetime.date.fromisoformat(p["DATE"])
        assert (d.year, d.month) == (1995, 3)
        assert p["SEGMENT"] in ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
    for q in ("q5", "q6", "q12"):
        assert all(p["DATE"][4:] == "-01-01" and 1993 <= int(p["DATE"][:4]) <= 1997
                   for p in seen[q])
    assert {p["REGION"] for p in seen["q5"]} == {"AFRICA", "AMERICA", "ASIA", "EUROPE",
                                                "MIDDLE EAST"}
    assert {p["DISCOUNT"] for p in seen["q6"]} == {f"0.0{d}" for d in range(2, 10)}
    assert {p["QUANTITY"] for p in seen["q6"]} == {24, 25}
    assert all(p["SHIPMODE1"] != p["SHIPMODE2"] for p in seen["q12"])


def test_streams_share_one_order_and_never_repeat_a_combination():
    mix = two_streams()
    a, b = (traffic.Stream(mix, 99, i) for i in range(2))
    sent = [s.next() for _ in range(19 * 5) for s in (a, b)]
    q5 = [i.params for i in sent if i.query == "q5"]
    # q5's grid: 5 regions x 5 years, the last SETUP_ENTRIES kept for set-up;
    # a window sends some ten q5s
    assert len(q5) == 38 and len(set(q5[:12])) == 12 and len(set(q5)) == 19
    setup = {i.params for r in traffic.warmup(mix, 99) for i in r if i.query == "q5"}
    assert len(setup) == traffic.SETUP_ENTRIES and not setup & set(q5)
    assert [i.query for i in sent[:2]] == ["q1", "q3"]  # stream starts 0 and 2


def test_the_grids_are_clause_2_4s():
    sizes = {q: len(traffic.grid(traffic.query_spec(q))) for q in ("q1", "q3", "q5", "q6", "q12")}
    assert sizes == {"q1": 61, "q3": 5 * 31, "q5": 25, "q6": 5 * 8 * 2, "q12": 5 * 42}
