"""Runtime concurrency verifier: lock-order + guarded-state checking.

The scheduler control plane is about to get much more concurrent (ROADMAP
item 3 moves pop_tasks/heartbeats/piece-feed polls off the GIL), and the
only defenses so far are the *static* lint rules (BL001/BL003) plus whatever
chaos_soak happens to interleave. This module is the dynamic complement —
the lockset/lock-order approach of Eraser (Savage et al., SOSP '97) packaged
as an always-runnable test-mode instrument, standing in for the compile-time
ownership guarantees the reference engine gets from Rust:

* ``make_lock(name)`` / ``make_rlock(name)`` — the traced-lock factory every
  *named* scheduler/executor lock routes through. Mode ``off`` (the default)
  returns plain ``threading`` objects: zero overhead, byte-identical
  behavior. Modes ``warn``/``assert`` return ``TracedLock``/``TracedRLock``
  drop-ins that record per-thread acquisition stacks, maintain a global
  lock-order graph, and check each NEW edge — before blocking on the
  underlying lock, so a genuine ABBA interleaving raises instead of
  deadlocking the test run.

* Lock-hierarchy spec (``analysis/lock_order.json``): the checked-in set of
  sanctioned nesting edges ``"Outer -> Inner"``. Any observed edge not in
  the spec is a violation carrying BOTH acquisition stacks; any edge that
  closes a cycle in the observed graph is a potential cross-thread ABBA
  deadlock regardless of baselining.

* Guarded state: ``guarded_dict``/``guarded_list`` wrap a shared mutable
  container so every access asserts the guarding traced lock is held by the
  current thread (violations name the attribute and the current holder);
  ``guarded_by("_lock")`` decorates ``*_locked``-convention methods with the
  same check. In ``off`` mode the factories return plain containers and the
  decorator adds one global-read per call (the faults-registry precedent).

* Blocking-IO-while-held: while installed, ``time.sleep`` is wrapped to
  report a sleep executed while the thread holds any traced lock — the
  dynamic analog of lint rule BL001.

Reentrant re-acquisition of the SAME lock object (RLock discipline) is
exempt from edge recording. A nesting of two different instances sharing a
name (e.g. two ``Histogram._lock``s) records a self-edge ``"X -> X"`` and
must be baselined explicitly — it is a real hazard unless an instance-level
ordering discipline exists.

Mode selection: ``BALLISTA_ANALYSIS_CONCURRENCY`` env var at import, or
``install(mode)`` BEFORE the traced objects are constructed (tracedness is
decided at construction — see docs/static_analysis.md). The config knob
``ballista.analysis.concurrency`` validates the same values.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from collections import OrderedDict
from typing import Callable, Optional

log = logging.getLogger("ballista.analysis.concurrency")

MODE_OFF = "off"
MODE_WARN = "warn"
MODE_ASSERT = "assert"
MODES = (MODE_OFF, MODE_WARN, MODE_ASSERT)

DEFAULT_SPEC = os.path.join(os.path.dirname(__file__), "lock_order.json")

# acquisition stacks are bounded: deep enough to name the caller chain,
# shallow enough that tier-1-with-assert stays fast on the pop_tasks path
_STACK_LIMIT = 12
_MAX_VIOLATIONS = 256


class ConcurrencyViolation(RuntimeError):
    """A lock-order or guarded-state violation (mode=assert raises it)."""


# ---- module state -------------------------------------------------------------------

_mode = MODE_OFF
_spec_edges: set[tuple[str, str]] = set()
_spec_loaded = False  # False = accept every edge (ad-hoc/unit-test locks)
_sink: Optional[Callable[[str, str, float], None]] = None

# internal bookkeeping lock — deliberately a PLAIN lock (tracing the
# verifier's own mutex would recurse)
_state_mu = threading.Lock()
_graph: "OrderedDict[tuple[str, str], dict]" = OrderedDict()
_violations: list[dict] = []
_warned_keys: set[str] = set()

_tls = threading.local()

_real_sleep = time.sleep


def _held_stack() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def parse_mode(v) -> str:
    s = str(v).strip().lower()
    if s in ("", "0", "false", "no", "none"):
        s = MODE_OFF
    if s not in MODES:
        raise ValueError(
            f"ballista.analysis.concurrency must be one of {MODES}, got {v!r}"
        )
    return s


def load_spec(path: str = DEFAULT_SPEC) -> set[tuple[str, str]]:
    """Parse a lock hierarchy spec: ``{"edges": ["Outer -> Inner", ...]}``."""
    with open(path) as f:
        doc = json.load(f)
    edges: set[tuple[str, str]] = set()
    for e in doc.get("edges", []):
        outer, _, inner = str(e).partition("->")
        if not inner:
            raise ValueError(f"malformed lock_order edge (want 'A -> B'): {e!r}")
        edges.add((outer.strip(), inner.strip()))
    return edges


def install(mode: Optional[str] = None, spec_edges=None, spec_path: Optional[str] = None) -> str:
    """Select the verifier mode. Must run BEFORE the traced objects are
    constructed — the factory decides tracedness at construction time.
    ``spec_edges`` (tests) or ``spec_path`` override the checked-in spec;
    with neither, the default spec is loaded when present."""
    global _mode, _spec_edges, _spec_loaded
    if mode is None:
        mode = os.environ.get("BALLISTA_ANALYSIS_CONCURRENCY", MODE_OFF)
    _mode = parse_mode(mode)
    if spec_edges is not None:
        _spec_edges, _spec_loaded = set(spec_edges), True
    elif spec_path is not None:
        _spec_edges, _spec_loaded = load_spec(spec_path), True
    elif _mode != MODE_OFF and os.path.exists(DEFAULT_SPEC):
        _spec_edges, _spec_loaded = load_spec(DEFAULT_SPEC), True
    if _mode == MODE_OFF:
        time.sleep = _real_sleep
    else:
        time.sleep = _checked_sleep
    return _mode


def installed_mode() -> str:
    return _mode


def enabled() -> bool:
    return _mode != MODE_OFF


def set_metrics_sink(sink: Optional[Callable[[str, str, float], None]]) -> None:
    """``sink(kind, lock_name, seconds)`` with kind in {"wait", "hold"} —
    the scheduler threads this into its FlightRecorder as the
    ``ballista_lock_wait_ms``/``ballista_lock_hold_ms`` families."""
    global _sink
    _sink = sink


def clear_state() -> None:
    """Reset the observed graph + violation log (per-seed soak hygiene).
    Thread-local held stacks of live threads are intentionally kept."""
    with _state_mu:
        _graph.clear()
        _violations.clear()
        _warned_keys.clear()


def violations() -> list[dict]:
    with _state_mu:
        return list(_violations)


def observed_edges() -> list[tuple[str, str]]:
    with _state_mu:
        return list(_graph.keys())


def graph_size() -> int:
    with _state_mu:
        return len(_graph)


def unbaselined_edges() -> list[tuple[str, str]]:
    with _state_mu:
        if not _spec_loaded:
            return []
        return [e for e in _graph if e not in _spec_edges]


_THIS_FILE = os.path.abspath(__file__)


def _capture_stack():
    # capture the caller chain, dropping the verifier's own frames — the
    # call depth differs between `lock.acquire()` and `with lock:` paths
    frames = traceback.extract_stack(sys._getframe(1), limit=_STACK_LIMIT + 4)
    return [f for f in frames if os.path.abspath(f.filename) != _THIS_FILE][-_STACK_LIMIT:]


def _fmt_stack(stack) -> str:
    if not stack:
        return "  <no stack captured>"
    return "".join(traceback.format_list(list(stack))).rstrip()


def _report(kind: str, key: str, message: str) -> None:
    """Record a violation; raise in assert mode, log once per key in warn."""
    with _state_mu:
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append({"kind": kind, "key": key, "message": message})
        first = key not in _warned_keys
        _warned_keys.add(key)
    if _mode == MODE_ASSERT:
        raise ConcurrencyViolation(message)
    if first:
        log.warning("concurrency verifier: %s", message)


def _find_path(src: str, dst: str) -> Optional[list[str]]:
    """DFS over the observed graph: a name-path src -> ... -> dst."""
    adj: dict[str, list[str]] = {}
    for (a, b) in _graph:
        adj.setdefault(a, []).append(b)
    seen = set()
    stack = [(src, [src])]
    while stack:
        node, path = stack.pop()
        if node == dst:
            return path
        if node in seen:
            continue
        seen.add(node)
        for nxt in adj.get(node, ()):
            stack.append((nxt, path + [nxt]))
    return None


def _record_edge(outer, inner_lock, inner_stack) -> None:
    """Called BEFORE blocking on ``inner_lock`` while ``outer`` is held, so
    a true ABBA interleaving raises instead of deadlocking."""
    edge = (outer.name, inner_lock.name)
    rev = None
    with _state_mu:
        known = edge in _graph
        if not known:
            _graph[edge] = {
                "outer_stack": outer.stack,
                "inner_stack": inner_stack,
                "count": 1,
            }
            # a self-edge (two same-named INSTANCES nested) is not a trivial
            # cycle — it goes through the spec check like any other edge
            cycle = (
                _find_path(edge[1], edge[0]) if edge[0] != edge[1] else None
            )
            unbaselined = _spec_loaded and edge not in _spec_edges
            if cycle is not None and len(cycle) > 1:
                rev = _graph.get((cycle[0], cycle[1]))
        else:
            _graph[edge]["count"] += 1
    if known:
        return
    if cycle is not None:
        msg = (
            f"lock-order cycle: acquiring '{edge[1]}' while holding "
            f"'{edge[0]}' closes the cycle {' -> '.join(cycle + [edge[1]])} "
            f"(potential ABBA deadlock across threads).\n"
            f"-- stack holding '{edge[0]}':\n{_fmt_stack(outer.stack)}\n"
            f"-- stack acquiring '{edge[1]}':\n{_fmt_stack(inner_stack)}"
        )
        if rev is not None:
            msg += (
                f"\n-- earlier stack that established "
                f"'{cycle[0]}' -> '{cycle[1]}':\n"
                f"{_fmt_stack(rev['inner_stack'])}"
            )
        _report("lock-order-cycle", f"cycle:{edge[0]}->{edge[1]}", msg)
    elif unbaselined:
        _report(
            "unbaselined-edge",
            f"edge:{edge[0]}->{edge[1]}",
            (
                f"unbaselined lock-order edge '{edge[0]}' -> '{edge[1]}' "
                f"(not in analysis/lock_order.json).\n"
                f"-- stack holding '{edge[0]}':\n{_fmt_stack(outer.stack)}\n"
                f"-- stack acquiring '{edge[1]}':\n{_fmt_stack(inner_stack)}"
            ),
        )


class _Acq:
    __slots__ = ("lock", "name", "stack", "reentrant", "t0")

    def __init__(self, lock, name, stack, reentrant, t0):
        self.lock = lock
        self.name = name
        self.stack = stack
        self.reentrant = reentrant
        self.t0 = t0


class _TracedBase:
    """Drop-in for threading.Lock/RLock recording order + ownership."""

    _reentrant_ok = False

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner
        self._owner: Optional[str] = None  # diagnostic only; racy reads ok

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r} owner={self._owner!r}>"

    def held_by_me(self) -> bool:
        return any(a.lock is self for a in _held_stack())

    def holder(self) -> Optional[str]:
        """Thread name of the current holder (diagnostic; best-effort)."""
        return self._owner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held_stack()
        reentrant = any(a.lock is self for a in held)
        stack = None
        if not reentrant:
            stack = _capture_stack()
            outer = next(
                (a for a in reversed(held) if not a.reentrant), None
            )
            if outer is not None:
                _record_edge(outer, self, stack)
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if not reentrant and _sink is not None:
                _sink("wait", self.name, time.perf_counter() - t0)
            held.append(_Acq(self, self.name, stack, reentrant, time.perf_counter()))
            self._owner = threading.current_thread().name
        return ok

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                acq = held.pop(i)
                if not acq.reentrant:
                    self._owner = None
                    if _sink is not None:
                        _sink("hold", self.name, time.perf_counter() - acq.t0)
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class TracedLock(_TracedBase):
    def locked(self) -> bool:
        return self._inner.locked()


class TracedRLock(_TracedBase):
    _reentrant_ok = True


def make_lock(name: str):
    """Named-lock factory: plain ``threading.Lock`` in mode off."""
    if _mode == MODE_OFF:
        return threading.Lock()
    return TracedLock(name, threading.Lock())


def make_rlock(name: str):
    if _mode == MODE_OFF:
        return threading.RLock()
    return TracedRLock(name, threading.RLock())


# ---- blocking-IO-while-held -----------------------------------------------------------


def _checked_sleep(secs):
    held = [a.name for a in _held_stack() if not a.reentrant]
    if held:
        stack = traceback.extract_stack(sys._getframe(1), limit=_STACK_LIMIT)
        _report(
            "blocking-under-lock",
            f"sleep:{'+'.join(held)}",
            (
                f"time.sleep({secs!r}) while holding traced lock(s) "
                f"{held} — blocking under a lock stalls every waiter "
                f"(dynamic BL001).\n{_fmt_stack(stack)}"
            ),
        )
    return _real_sleep(secs)


# ---- guarded state --------------------------------------------------------------------


def _guard_check(name: str, lock) -> None:
    if lock.held_by_me():
        return
    holder = lock.holder()
    who = threading.current_thread().name
    stack = _capture_stack()
    _report(
        "guarded-state",
        f"guard:{name}",
        (
            f"guarded state '{name}' accessed by thread '{who}' without "
            f"holding '{lock.name}' (current holder: "
            f"{holder or 'nobody'}).\n{_fmt_stack(stack)}"
        ),
    )


class GuardedDict(OrderedDict):
    """Dict asserting its guarding traced lock on EVERY access. Subclasses
    OrderedDict so LRU users (move_to_end/popitem(last=...)) wrap too."""

    def __init__(self, name: str, lock, data=()):
        self._g_name = name
        self._g_lock = lock
        self._g_ready = False  # construction predates sharing (Eraser's
        super().__init__(data)  # initialization-phase exemption)
        self._g_ready = True

    def _g_check(self):
        if self._g_ready:
            _guard_check(self._g_name, self._g_lock)

    def __getitem__(self, k):
        self._g_check()
        return super().__getitem__(k)

    def __setitem__(self, k, v):
        self._g_check()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._g_check()
        super().__delitem__(k)

    def __contains__(self, k):
        self._g_check()
        return super().__contains__(k)

    def __iter__(self):
        self._g_check()
        return super().__iter__()

    def __len__(self):
        self._g_check()
        return super().__len__()

    def get(self, k, default=None):
        self._g_check()
        return super().get(k, default)

    def pop(self, *a, **kw):
        self._g_check()
        return super().pop(*a, **kw)

    def popitem(self, last=True):
        self._g_check()
        return super().popitem(last)

    def setdefault(self, k, default=None):
        self._g_check()
        return super().setdefault(k, default)

    def update(self, *a, **kw):
        self._g_check()
        return super().update(*a, **kw)

    def clear(self):
        self._g_check()
        return super().clear()

    def keys(self):
        self._g_check()
        return super().keys()

    def values(self):
        self._g_check()
        return super().values()

    def items(self):
        self._g_check()
        return super().items()

    def move_to_end(self, k, last=True):
        self._g_check()
        return super().move_to_end(k, last)


class GuardedList(list):
    """List asserting its guarding traced lock on every access."""

    def __init__(self, name: str, lock, data=()):
        self._g_name = name
        self._g_lock = lock
        self._g_ready = False
        super().__init__(data)
        self._g_ready = True

    def _g_check(self):
        if self._g_ready:
            _guard_check(self._g_name, self._g_lock)

    def __getitem__(self, i):
        self._g_check()
        return super().__getitem__(i)

    def __setitem__(self, i, v):
        self._g_check()
        return super().__setitem__(i, v)

    def __delitem__(self, i):
        self._g_check()
        return super().__delitem__(i)

    def __iter__(self):
        self._g_check()
        return super().__iter__()

    def __len__(self):
        self._g_check()
        return super().__len__()

    def __contains__(self, v):
        self._g_check()
        return super().__contains__(v)

    def append(self, v):
        self._g_check()
        return super().append(v)

    def extend(self, it):
        self._g_check()
        return super().extend(it)

    def insert(self, i, v):
        self._g_check()
        return super().insert(i, v)

    def pop(self, i=-1):
        self._g_check()
        return super().pop(i)

    def remove(self, v):
        self._g_check()
        return super().remove(v)

    def clear(self):
        self._g_check()
        return super().clear()


def guarded_dict(name: str, lock, data=()):
    """Wrap a shared map so accesses assert ``lock`` is held. Plain
    OrderedDict in mode off, or when the guarding lock is itself untraced
    (constructed before install) — OrderedDict rather than dict so callers
    relying on ``move_to_end``/``popitem(last=...)`` (LRU maps) behave
    identically under either mode."""
    if _mode == MODE_OFF or not isinstance(lock, _TracedBase):
        return OrderedDict(data)
    return GuardedDict(name, lock, data)


def guarded_list(name: str, lock, data=()):
    if _mode == MODE_OFF or not isinstance(lock, _TracedBase):
        return list(data)
    return GuardedList(name, lock, data)


def guard_lock(container):
    """The lock guarding a guarded container — for tests that reach into
    shared state directly and must do it the way production code does.
    Returns a no-op context manager when the container is unguarded
    (mode off, or a lock constructed before install)."""
    lk = getattr(container, "_g_lock", None)
    if lk is not None:
        return lk
    import contextlib

    return contextlib.nullcontext()


def guarded_by(lock_attr: str):
    """Method decorator for the ``*_locked`` convention: asserts the
    instance's named lock is held on entry. One global read + isinstance
    per call when disabled (the faults-registry overhead precedent)."""

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(self, *args, **kwargs):
            if _mode != MODE_OFF:
                lk = getattr(self, lock_attr, None)
                if isinstance(lk, _TracedBase) and not lk.held_by_me():
                    _guard_check(
                        f"{type(self).__name__}.{fn.__name__}", lk
                    )
            return fn(self, *args, **kwargs)

        return wrapper

    return deco


def dump_edges(path: str) -> None:
    """Write the observed lock-order graph in lock_order.json format —
    baseline regeneration: run the suite under
    ``BALLISTA_ANALYSIS_CONCURRENCY=warn BALLISTA_CONCURRENCY_DUMP=/tmp/e.json``
    and merge the dumped edges into analysis/lock_order.json."""
    with _state_mu:
        edges = sorted(f"{a} -> {b}" for a, b in _graph)
    with open(path, "w") as f:
        json.dump(
            {
                "comment": "observed lock-order edges (dump_edges); merge "
                "the sanctioned ones into analysis/lock_order.json",
                "edges": edges,
            },
            f,
            indent=2,
        )
        f.write("\n")


# read the env at import so `BALLISTA_ANALYSIS_CONCURRENCY=assert pytest`
# traces every lock from process start (tier-1-with-assert CI leg)
if os.environ.get("BALLISTA_ANALYSIS_CONCURRENCY"):
    install()
    if os.environ.get("BALLISTA_CONCURRENCY_DUMP"):
        import atexit

        atexit.register(dump_edges, os.environ["BALLISTA_CONCURRENCY_DUMP"])
