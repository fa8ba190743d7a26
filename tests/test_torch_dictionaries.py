"""The port's shared string dictionaries, built at registration with each
string column on a thread of its own: the same ids, values and declines as
one column at a time, in schema order."""
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.client.catalog import Catalog
from ballista_tpu_torch.engine import dictionaries as D
from ballista_tpu_torch.plan.schema import DataType, Field, Schema

COLUMNS = {
    "flag": [["A", "N", None], ["R", "A"]],
    "n": None,
    "mode": [["AIR", "RAIL"], ["SHIP", "AIR", "MAIL"]],
    "comment": [[f"c{i}" for i in range(6)], [f"d{i}" for i in range(6)]],
    "status": [["F", "O"], ["P"]],
}


def _chunks(col):
    if col == "broken":
        raise OSError("unreadable")
    return (pa.array(c) for c in COLUMNS[col])


def _schema(*extra):
    fields = [Field(c, DataType.INT64 if c == "n" else DataType.STRING) for c in COLUMNS]
    return Schema(fields + [Field(c, DataType.STRING) for c in extra])


@pytest.mark.parametrize("cores", [1, 8])
def test_columns_built_apart_match_one_at_a_time(monkeypatch, cores):
    monkeypatch.setattr(D.os, "cpu_count", lambda: cores)
    refs, declines = D.build_table_dictionaries("t", _schema("broken"), 3, _chunks, 8)
    assert list(refs) == ["flag", "mode", "status"]
    for col, did in refs.items():
        values = D.build_shared_dictionary(_chunks(col), 8)
        assert did == D.make_dict_id("t", col, 3, values)
        np.testing.assert_array_equal(D.REGISTRY.get(did), values)
    assert list(declines) == ["comment", "broken"]
    assert "max_dict_size=8" in declines["comment"]
    assert declines["broken"] == "build failed: unreadable"


def test_parquet_registration_reads_every_file(tmp_path):
    parts = [{"flag": ["A", "N", None], "mode": ["AIR", "RAIL", "AIR"]},
             {"flag": ["R", "A"], "mode": ["SHIP", "MAIL"]}]
    for i, part in enumerate(parts):
        pq.write_table(pa.table(part), tmp_path / f"part-{i}.parquet")
    meta = Catalog().register_parquet("t", str(tmp_path))
    np.testing.assert_array_equal(D.REGISTRY.get(meta.dict_refs["flag"]), ["", "A", "N", "R"])
    np.testing.assert_array_equal(D.REGISTRY.get(meta.dict_refs["mode"]),
                                  ["", "AIR", "MAIL", "RAIL", "SHIP"])
    assert meta.num_rows == 5 and not meta.dict_declines
