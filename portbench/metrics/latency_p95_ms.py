"""95th percentile of the wall of every query completed in the window
(host clock; statistics.quantiles, inclusive)."""
import statistics


def read(r):
    lat = r["latencies_s"]
    if len(lat) < 2:
        return None
    return 1000 * statistics.quantiles(lat, n=100, method="inclusive")[94]
