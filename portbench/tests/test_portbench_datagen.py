"""The frozen generator gives the port's generator's tables."""
import pytest

import datagen


@pytest.mark.parametrize("seed", [42, 2**31 + 5])
def test_frozen_generator_equals_the_ports(seed):
    from ballista_tpu_torch.models import tpch

    got = datagen.make_tables(0.01, seed, datagen.TABLES)
    for name in datagen.TABLES:
        assert got[name].equals(tpch.generate_table(name, 0.01, seed)), name


def test_written_files_hold_the_tables(tmp_path):
    import pyarrow.parquet as pq

    tables = datagen.make_tables(0.01, 3, ["nation", "lineitem"])
    paths = datagen.write_tables(tables, str(tmp_path), 4)
    assert len(list((tmp_path / "lineitem").iterdir())) == 4
    assert len(list((tmp_path / "nation").iterdir())) == 1
    assert pq.read_table(paths["lineitem"]).equals(tables["lineitem"])
