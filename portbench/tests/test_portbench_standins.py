"""The stand-ins of ``standins.py`` come out not correct through
``reference.compare``, and the exact answer comes out correct: q1's AVGs
rounded to bfloat16 or float16 fail ``avg_rel_gap`` at any size; q1's
``sum_charge`` accumulated in float32 fails ``sum_gap`` at the cell's own
size (SF1), checked on the card (at SF 0.1 its gap is about a tenth)."""
import pyarrow as pa
import pytest

import datagen
import reference
import run
import standins

LIMITS = run.load("configs", "tpch1-standalone")["limits"]


def tables(sf, seed):
    return reference.Tables(datagen.make_tables(sf, seed, ["lineitem"]))


def over_limits(r):
    return {k for k in r if r[k] > LIMITS[k]}


@pytest.mark.parametrize("seed", [2**31 + 41, 2**32 + 42])
def test_avg_standins_fail_and_the_f32_sum_drifts(seed):
    t = tables(0.1, seed)
    for delta in standins.deltas():
        exact = reference.answer(t, "q1", {"DELTA": delta})
        assert over_limits(reference.compare(pa.table(exact), exact, {})) == set()
        for standin in ("avg_bf16", "avg_fp16"):
            assert over_limits(standins.readings(t, {"DELTA": delta}, standin, "cpu")) == \
                {"avg_rel_gap"}
        assert standins.readings(t, {"DELTA": delta}, "sum_f32", "cpu")["sum_gap"] > 1


@pytest.mark.cuda
def test_every_standin_fails_at_the_cells_size_on_the_card(card):
    t = tables(1, 2**31 + 43)
    for delta in standins.deltas():
        got = {s: over_limits(standins.readings(t, {"DELTA": delta}, s, "cuda"))
               for s in standins.STANDINS}
        assert got == {"avg_bf16": {"avg_rel_gap"}, "avg_fp16": {"avg_rel_gap"},
                       "sum_f32": {"sum_gap"}}, got
