"""Share of the fused inputs built over the window (cache misses of the
fused exchange's and fused join's inputs) that were built on the device
from their stages' outputs, counted by the program at each build:
op.FusedInput.device_builds over it plus op.FusedInput.host_builds. None
where no input was built, as in a program that counts neither."""


def read(r):
    e = r.get("engine") or {}
    dev = e.get("op.FusedInput.device_builds", 0.0)
    host = e.get("op.FusedInput.host_builds", 0.0)
    if dev + host <= 0:
        return None
    return 100 * dev / (dev + host)
