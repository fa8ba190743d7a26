"""The one traffic generator: query instances for each stream of a cell,
from the cell's mix file and the run's seed.

A stream walks the mix's ``rotation`` of queries round robin; stream ``i``
of ``n`` starts at position ``i * len(rotation) // n``, for every seed. With
``"literals": "validation"`` every instance carries the spec's validation
literals, so the SQL repeats exactly. With ``"qgen"`` each instance takes
fresh substitution parameters from the ranges in ``queries/<query>.json``
(TPC-H clause 2.4): the seed orders the grid of every combination of them,
and the streams take its entries in turn, so no combination comes twice
before all have come once and every seed sends the same kind of work in
another order. Set-up takes the grid's last ``SETUP_ENTRIES`` entries,
which the window never sends. The same seed gives the same instances in the
same order.
"""
from __future__ import annotations

import datetime
import itertools
import json
import os
import zlib
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# entries of each query's grid kept for set-up's runs
SETUP_ENTRIES = 6


@dataclass(frozen=True)
class Instance:
    query: str
    params: tuple  # sorted (name, value) pairs
    sql: str

    @property
    def key(self) -> tuple:
        return (self.query, self.params)


def query_spec(name: str) -> dict:
    with open(os.path.join(HERE, "queries", f"{name}.json")) as f:
        spec = json.load(f)
    with open(os.path.join(HERE, "queries", f"{name}.sql")) as f:
        spec["template"] = f.read()
    return spec


def _values(kind: str, arg) -> list:
    if kind == "int":
        return list(range(arg[0], arg[1] + 1))
    if kind == "choice":
        return list(arg)
    if kind == "day":
        lo, hi = (datetime.date.fromisoformat(d) for d in arg)
        return [(lo + datetime.timedelta(i)).isoformat() for i in range((hi - lo).days + 1)]
    if kind == "year":
        return [f"{y}-01-01" for y in range(arg[0], arg[1] + 1)]
    if kind == "cents":
        return [f"{c / 100:.2f}" for c in range(arg[0], arg[1] + 1)]
    raise ValueError(f"unknown parameter kind {kind!r}")


def grid(spec: dict) -> list:
    """Every combination of the spec's ``qgen`` parameters, in the order of
    their names. A name may list several parameters, separated by commas,
    that take distinct values of one vocabulary (in order)."""
    out = [{}]
    for names in sorted(spec["qgen"]):
        (kind, arg), = spec["qgen"][names].items()
        if kind == "distinct":
            keys = names.split(",")
            choices = [dict(zip(keys, c)) for c in itertools.permutations(arg, len(keys))]
        else:
            choices = [{names: v} for v in _values(kind, arg)]
        out = [dict(a, **b) for a in out for b in choices]
    return out


def instance(name: str, spec: dict, params: dict) -> Instance:
    return Instance(name, tuple(sorted(params.items())), spec["template"].format(**params))


class Stream:
    """The instances one stream of ``streams`` sends, in order."""

    def __init__(self, mix: dict, seed: int, index: int):
        self.rotation = list(mix["rotation"])
        self.literals = mix["literals"]
        if self.literals not in ("validation", "qgen"):
            raise ValueError(f"literals must be validation or qgen, not {self.literals!r}")
        self.specs = {q: query_spec(q) for q in self.rotation}
        self.index, self.streams = index, mix["streams"]
        self.orders = {q: ordered_grid(spec, seed, q) for q, spec in self.specs.items()
                       if self.literals == "qgen"}
        self.position = index * len(self.rotation) // self.streams
        self.sent = 0
        self._taken: dict = {}

    def next(self) -> Instance:
        name = self.rotation[self.position]
        self.position = (self.position + 1) % len(self.rotation)
        self.sent += 1
        spec = self.specs[name]
        if self.literals == "validation":
            return instance(name, spec, spec["validation"])
        k = self._taken.get(name, 0)
        self._taken[name] = k + 1
        order = self.orders[name]
        window = len(order) - SETUP_ENTRIES
        return instance(name, spec, order[(k * self.streams + self.index) % window])

    @property
    def at_rotation_start(self) -> bool:
        return self.sent % len(self.rotation) == 0


def ordered_grid(spec: dict, seed: int, query: str) -> list:
    """The spec's grid in the order the seed gives it (one order for all
    streams of a run)."""
    g = grid(spec)
    rng = np.random.default_rng([seed % 2**64, zlib.crc32(query.encode())])
    return [g[i] for i in rng.permutation(len(g))]


def warmup(mix: dict, seed: int) -> list:
    """Set-up's instances: ``SETUP_ENTRIES`` rounds of one instance of each
    query of the rotation, with the validation literals, or with the last
    entries of the seed's order of each grid (round ``r`` the ``r``-th from
    the end)."""
    rounds = [[] for _ in range(SETUP_ENTRIES)]
    for name in mix["rotation"]:
        spec = query_spec(name)
        order = ordered_grid(spec, seed, name) if mix["literals"] == "qgen" else None
        for r, out in enumerate(rounds):
            out.append(instance(name, spec, spec["validation"] if order is None
                                else order[-1 - r]))
    return rounds
