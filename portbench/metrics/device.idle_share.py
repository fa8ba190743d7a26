"""Share of the traced window in which no kernel, copy or set ran on the
card: 1 - (union of device intervals) / window, from torch.profiler."""


def read(r):
    p = r.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100 * (1 - p["busy_s"] / p["window_s"])
