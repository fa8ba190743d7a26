"""Median wall of every query completed in the window, client side, from
``sql()`` to the last result row (host clock)."""
import statistics


def read(r):
    lat = r["latencies_s"]
    return 1000 * statistics.median(lat) if lat else None
