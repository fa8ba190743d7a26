"""Queries answered in the window, all streams together, per second of
the window: from its start to the last answer of its whole rotations (host
clock)."""


def read(r):
    return r["queries"] / r["seconds"] if r["queries"] else None
