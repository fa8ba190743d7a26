"""Time in the host's parquet scan per query, in ms
(op.ParquetScanExec.time_s; a query whose leaves all hit scans nothing)."""


def read(r):
    if not r["queries"] or "engine" not in r:
        return None
    return 1000 * r["engine"].get("op.ParquetScanExec.time_s", 0.0) / r["queries"]
