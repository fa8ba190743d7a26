"""The PyTorch port's own TPC-H test data, and its generator's atomic writes.

The port's tests read SF 0.01 generated by the port's ``generate_tpch`` into
``<test data>/torch_tpch_sf001`` (``tests/.data`` unless
``BALLISTA_TPU_TEST_DATA`` names another root), never the shared directory
the JAX package's tests generate into. The fixtures below are imported by the
other ``test_torch_*.py`` files. Test workers that start together all call
the generator; it writes each table into a private directory and renames it
into place whole, so none of them reads a table another is still writing.
"""
import os
import subprocess
import sys
import time

import pyarrow.parquet as pq
import pytest

from ballista_tpu_torch.models.tpch import TPCH_TABLES, generate_table, generate_tpch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_ROOT = os.environ.get(
    "BALLISTA_TPU_TEST_DATA", os.path.join(os.path.dirname(os.path.abspath(__file__)), ".data")
)
SF = 0.01
PARTS = 2


@pytest.fixture(scope="session")
def torch_tpch_dir():
    """TPC-H parquet at SF 0.01 from the port's generator, cached across runs."""
    d = os.path.join(DATA_ROOT, "torch_tpch_sf001")
    generate_tpch(d, sf=SF, parts_per_table=PARTS)
    return d


@pytest.fixture(scope="session")
def torch_oracle_tables(torch_tpch_dir):
    """The pandas oracle's input: every table read from ``torch_tpch_dir``."""
    return {
        t: pq.read_table(os.path.join(torch_tpch_dir, t)).to_pandas(date_as_object=False)
        for t in TPCH_TABLES
    }


@pytest.fixture(scope="module")
def row_counts():
    return {t: generate_table(t, SF, 42).num_rows for t in TPCH_TABLES}


_GENERATE = r"""
import sys, time
sys.path.insert(0, {repo!r})
from ballista_tpu_torch.models.tpch import generate_tpch
time.sleep(max(0.0, {start!r} - time.time()))
out = generate_tpch({data!r}, sf={sf!r}, parts_per_table={parts!r})
print(sorted(out))
"""


def test_two_processes_generating_at_once_leave_every_table_whole(tmp_path, row_counts):
    data = str(tmp_path / "tpch")
    # both start from one agreed instant, so their writes overlap
    code = _GENERATE.format(repo=REPO, start=time.time() + 3.0, data=data, sf=SF, parts=PARTS)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
             for _ in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        assert out.strip() == repr(sorted(TPCH_TABLES))
    for t in TPCH_TABLES:
        assert pq.read_table(os.path.join(data, t)).num_rows == row_counts[t], t
    assert sorted(os.listdir(data)) == sorted(TPCH_TABLES)  # no private copy left


def test_half_written_private_copy_is_never_adopted(tmp_path, row_counts):
    """A run killed midway leaves its private copy; the next run ignores it
    and writes the table whole."""
    data = tmp_path / "tpch"
    stale = data / ".lineitem.tmp-killed"
    stale.mkdir(parents=True)
    (stale / "part-0.parquet").write_bytes(b"PAR1 cut short")
    out = generate_tpch(str(data), sf=SF, tables=["lineitem"], parts_per_table=PARTS)
    assert pq.read_table(out["lineitem"]).num_rows == row_counts["lineitem"]
    assert sorted(os.listdir(out["lineitem"])) == ["part-0.parquet", "part-1.parquet"]


def test_empty_table_directory_is_filled_and_a_full_one_adopted(tmp_path, row_counts):
    data = tmp_path / "tpch"
    (data / "nation").mkdir(parents=True)
    out = generate_tpch(str(data), sf=SF, tables=["nation"])
    assert pq.read_table(out["nation"]).num_rows == row_counts["nation"]
    before = os.stat(os.path.join(out["nation"], "part-0.parquet")).st_mtime_ns
    assert generate_tpch(str(data), sf=SF, tables=["nation"]) == out
    assert os.stat(os.path.join(out["nation"], "part-0.parquet")).st_mtime_ns == before


def test_fixture_data_is_whole(torch_tpch_dir, row_counts):
    for t in TPCH_TABLES:
        assert pq.read_table(os.path.join(torch_tpch_dir, t)).num_rows == row_counts[t], t
