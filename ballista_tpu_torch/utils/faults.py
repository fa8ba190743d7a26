"""Deterministic, seeded fault injection at every RPC/IO boundary.

Chaos engineering for the engine (Basiri et al., IEEE Software 2016; the
Spark failure-domain design of Zaharia et al., NSDI'12): recovery code that
is not continuously executed under injected faults is recovery code that
does not work. This module is the single process-wide registry the chaos
soak (``benchmarks/chaos_soak.py``), the ``-m chaos`` test suite, and
operators drive.

Fault points (name -> layer; see docs/fault_tolerance.md for the full table
with supported modes)::

    flight.do_get     shuffle Flight serve, before the stream starts
    flight.stream     shuffle Flight serve, mid-stream (per batch)
    pool.checkout     shuffle Flight connection checkout
    rpc.launch        scheduler -> executor LaunchMultiTask (per attempt)
    rpc.cancel        scheduler -> executor CancelTasks
    rpc.clean         scheduler -> executor RemoveJobData
    rpc.status        executor -> scheduler UpdateTaskStatus
    heartbeat.send    executor -> scheduler heartbeat delivery
    task.execute      executor task execution (fail_once/fail_n/hang/slow)
    kv.get/kv.put/kv.delete/kv.scan/kv.lock/kv.watch   KV store operations
    shuffle.write     shuffle-file write (corrupt: bit-flip after checksum)
    shuffle.read      local shuffle-file read (corrupt: bit-flip in place)

Schedules are strings so they ride config/env verbatim::

    flight.do_get:unavailable@p=0.1:seed=7
    task.execute:fail_n@n=2;rpc.launch:unavailable@n=1
    shuffle.write:corrupt@n=1:seed=3
    task.execute:slow@delay=0.5:p=0.2;kv.put:unavailable@p=0.3

Grammar: entries separated by ``;``, each ``point:mode`` followed by
``key=value`` options separated by ``:`` or ``@``. Options: ``p`` (fire
probability, default 1), ``n`` (max fires), ``after`` (skip the first N
eligible calls), ``delay`` (seconds, for slow/hang), ``seed`` (per-rule
seed override); any OTHER key is a context filter matched against the call
site's ctx dict (e.g. ``rpc.launch:unavailable@executor_id=exec-1``).

Determinism: the fire/no-fire decision for the k-th eligible call at a
point is a pure function of ``(seed, point, k)`` (sha1-derived uniform
draw) — a schedule replays byte-for-byte given the same per-point call
sequence. Cross-thread interleaving can reorder WHICH logical operation is
the k-th call; the soak treats a seed as one deterministic schedule of
decisions, not a vector clock.

Zero overhead when disabled: ``check()`` is one function call plus one
dict miss on the module-level ``_ACTIVE`` map (asserted by
``benchmarks/chaos_soak.py --microbench``).

Every fired fault is appended to the registry's bounded ``fired`` log and,
when an ambient trace context is set (executor task threads, client fetch
threads), recorded as a zero-duration ``fault:<point>`` span — so injected
faults land in the scheduler's trace store next to the spans they broke.
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

log = logging.getLogger("ballista.faults")

MODES = ("unavailable", "error", "fail_once", "fail_n", "hang", "slow", "corrupt")

# hang mode is interruptible (clear()/install() release sleepers) and capped:
# a leaked hanging task thread must not block process exit on pool join
HANG_CAP_S = 120.0


class InjectedFault(Exception):
    """A fault fired by the chaos registry (generic/error modes)."""


class InjectedUnavailable(InjectedFault, ConnectionError):
    """Transient-transport-shaped injected fault: subclasses ConnectionError
    so transport-error classifiers (connection pool eviction, the RPC retry
    driver) treat it exactly like a real dead endpoint."""


@dataclass
class FaultRule:
    point: str
    mode: str
    p: float = 1.0
    n: Optional[int] = None  # max fires; None = unlimited
    after: int = 0  # skip the first `after` eligible calls
    delay_s: float = 0.0  # slow/hang sleep seconds
    seed: int = 0
    match: dict[str, str] = field(default_factory=dict)
    # mutable counters (kept on the rule; registry lock serializes)
    seq: int = 0  # eligible calls seen
    fired: int = 0

    def spec(self) -> str:
        opts = [f"p={self.p:g}"]
        if self.n is not None:
            opts.append(f"n={self.n}")
        if self.after:
            opts.append(f"after={self.after}")
        if self.delay_s:
            opts.append(f"delay={self.delay_s:g}")
        opts.append(f"seed={self.seed}")
        opts += [f"{k}={v}" for k, v in self.match.items()]
        return f"{self.point}:{self.mode}@" + ":".join(opts)


def _det_draw(seed: int, point: str, seq: int) -> float:
    """Deterministic uniform [0,1) draw for the seq-th call at a point."""
    h = hashlib.sha1(f"{seed}:{point}:{seq}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


def parse_schedule(schedule: str, default_seed: int = 0) -> list[FaultRule]:
    """Parse a schedule string into rules. Raises ValueError on malformed
    entries — a typo'd chaos schedule must fail loudly, not silently no-op."""
    rules: list[FaultRule] = []
    for entry in schedule.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        head, sep, rest = entry.partition(":")
        if not sep:
            raise ValueError(f"fault entry {entry!r}: expected point:mode")
        point = head.strip()
        # tokens after the point: mode first, then key=value options; ':'
        # and '@' both separate (the schedule's p=..@seed=.. shorthand)
        tokens = [t for part in rest.split(":") for t in part.split("@") if t]
        if not tokens:
            raise ValueError(f"fault entry {entry!r}: missing mode")
        mode = tokens[0].strip()
        if mode not in MODES:
            raise ValueError(
                f"fault entry {entry!r}: unknown mode {mode!r} (one of {MODES})"
            )
        rule = FaultRule(point=point, mode=mode, seed=default_seed)
        explicit_n = False
        if mode == "fail_once":
            rule.mode, rule.n = "error", 1
        elif mode == "fail_n":
            rule.mode = "error"  # n= option is REQUIRED (checked below)
        for tok in tokens[1:]:
            if "=" not in tok:
                raise ValueError(f"fault entry {entry!r}: bad option {tok!r}")
            k, _, v = tok.partition("=")
            k = k.strip()
            v = v.strip()
            try:
                if k == "p":
                    rule.p = float(v)
                elif k == "n":
                    rule.n = int(v)
                    explicit_n = True
                elif k == "after":
                    rule.after = int(v)
                elif k == "delay":
                    rule.delay_s = float(v)
                elif k == "seed":
                    rule.seed = int(v)
                else:
                    rule.match[k] = v
            except ValueError as e:
                raise ValueError(
                    f"fault entry {entry!r}: bad value for {k}: {v!r}"
                ) from e
        if mode == "fail_n" and not explicit_n:
            # a bare fail_n silently degrading to fail-once is exactly the
            # silent no-op this parser exists to reject
            raise ValueError(f"fault entry {entry!r}: fail_n requires n=")
        rules.append(rule)
    return rules


class FaultRegistry:
    """Process-wide registry of active fault rules.

    Not instantiated per component: schedulers, executors and shuffle all
    check the one ``GLOBAL`` instance (in-process chaos tests cover every
    layer with a single ``install()``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rules: dict[str, list[FaultRule]] = {}
        self._unhang = threading.Event()
        self.schedule: str = ""
        # True when the active schedule arrived via task-launch props: a
        # later task WITHOUT the props key then uninstalls it, so one chaos
        # session can never permanently degrade a shared executor
        self.installed_from_props: bool = False
        from collections import deque

        self.fired: "deque[dict]" = deque(maxlen=10_000)

    # ---- configuration ---------------------------------------------------------
    def install(
        self, schedule: str, default_seed: int = 0, from_props: bool = False
    ) -> None:
        """Replace the active rule set; empty schedule disables injection.
        ``from_props`` marks a props-scoped lifetime (set UNDER the lock —
        concurrent task threads must never observe an installed schedule
        with a stale lifetime flag)."""
        rules = parse_schedule(schedule, default_seed)
        by_point: dict[str, list[FaultRule]] = {}
        for r in rules:
            by_point.setdefault(r.point, []).append(r)
        with self._lock:
            self._unhang.set()  # release sleepers of the previous schedule
            self._unhang = threading.Event()
            self._rules = by_point
            self.schedule = schedule
            self.installed_from_props = from_props
        _set_active(self._rules if by_point else {})

    def clear_if_from_props(self) -> None:
        """Uninstall ONLY a props-installed schedule (atomic check+clear)."""
        with self._lock:
            if not (self.installed_from_props and self.schedule):
                return
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._unhang.set()
            self._unhang = threading.Event()
            self._rules = {}
            self.schedule = ""
            self.installed_from_props = False
            self.fired.clear()
        _set_active({})

    def active(self) -> bool:
        return bool(self._rules)

    def rules(self) -> list[FaultRule]:
        with self._lock:
            return [r for rs in self._rules.values() for r in rs]

    def fired_log(self) -> list[dict]:
        with self._lock:
            return list(self.fired)

    # ---- firing ----------------------------------------------------------------
    def _decide(
        self, point: str, ctx: Optional[dict]
    ) -> Optional[tuple[FaultRule, int, threading.Event]]:
        """Pick the rule (if any) that fires for this call; bumps counters
        under the lock, returns (rule, seq, unhang_event). The release event
        is CAPTURED under the lock: clear()/install() set the old event then
        rebind the attribute, so a sleeper reading ``self._unhang`` after
        the rebind would wait on a never-set fresh event."""
        with self._lock:
            rules = self._rules.get(point)
            if not rules:
                return None
            for rule in rules:
                if rule.match:
                    c = ctx or {}
                    if any(str(c.get(k)) != v for k, v in rule.match.items()):
                        continue
                seq = rule.seq
                rule.seq += 1
                if seq < rule.after:
                    continue
                if rule.n is not None and rule.fired >= rule.n:
                    continue
                if rule.p < 1.0 and _det_draw(rule.seed, point, seq) >= rule.p:
                    continue
                rule.fired += 1
                rec = {
                    "ts": time.time(),
                    "point": point,
                    "mode": rule.mode,
                    "seq": seq,
                    "fired": rule.fired,
                    "ctx": dict(ctx or {}),
                }
                self.fired.append(rec)
                return rule, seq, self._unhang
        return None

    def _record_span(self, point: str, rule: FaultRule, seq: int, ctx) -> None:
        from ballista_tpu_torch.obs.tracing import ambient, now_us

        actx = ambient()
        if actx is None:
            return
        actx.collector.record(
            f"fault:{point}", trace_id=actx.trace_id, parent_id=actx.parent_id,
            service="faults", start_us=now_us(), dur_us=0,
            attrs={"mode": rule.mode, "seq": seq, **{k: str(v) for k, v in (ctx or {}).items()}},
        )

    def fire(self, point: str, ctx: Optional[dict] = None) -> None:
        """Evaluate the point's rules; raise/sleep when one fires."""
        hit = self._decide(point, ctx)
        if hit is None:
            return
        rule, seq, unhang = hit
        self._record_span(point, rule, seq, ctx)
        msg = f"injected {rule.mode} at {point} (call #{seq}, seed {rule.seed})"
        log.info("%s ctx=%s", msg, ctx or {})
        if rule.mode == "unavailable":
            raise InjectedUnavailable(msg)
        if rule.mode == "error":
            raise InjectedFault(msg)
        if rule.mode in ("slow", "hang"):
            delay = rule.delay_s or (1.0 if rule.mode == "slow" else HANG_CAP_S)
            # interruptible: clear()/install() release hung sleepers so
            # non-daemon task-pool threads never block process shutdown
            # (waiting on the event captured at decision time, not the
            # possibly-rebound attribute)
            unhang.wait(min(delay, HANG_CAP_S))
            return
        # corrupt mode fired through check(): no bytes in hand — degrade to
        # an error (corrupt is meant for corrupt_file(); see below)
        if rule.mode == "corrupt":
            raise InjectedFault(msg)

    def corrupt_file(self, point: str, path: str, ctx: Optional[dict] = None) -> bool:
        """Bit-flip one byte of ``path`` if a corrupt-mode rule fires at
        this point. The flipped offset is deterministic in (seed, point,
        seq). Returns True when the file was corrupted."""
        hit = self._decide(point, {**(ctx or {}), "path": path})
        if hit is None:
            return False
        rule, seq, _unhang = hit
        if rule.mode != "corrupt":
            # non-corrupt rule on a file point: raise like check() would
            self._record_span(point, rule, seq, ctx)
            msg = f"injected {rule.mode} at {point} (call #{seq})"
            if rule.mode == "unavailable":
                raise InjectedUnavailable(msg)
            raise InjectedFault(msg)
        import os

        size = os.path.getsize(path)
        if size == 0:
            return False
        # skip the first/last 16 bytes (arrow magic + footer length) so the
        # flip lands in data/metadata, i.e. the silent-corruption region
        lo, hi = min(16, size - 1), max(size - 16, min(16, size - 1) + 1)
        off = lo + int(_det_draw(rule.seed, point + "#off", seq) * max(1, hi - lo))
        off = min(off, size - 1)
        with open(path, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0x40]))
        self._record_span(point, rule, seq, {"path": path, "offset": off})
        log.info("injected bit-flip at %s offset %d (%s)", path, off, point)
        return True


GLOBAL = FaultRegistry()

# hot-path membership map: check() does ONE dict lookup here when no
# schedule is installed. Rebound (never mutated in place) by _set_active so
# readers need no lock.
_ACTIVE: dict[str, list[FaultRule]] = {}


def _set_active(rules: dict[str, list[FaultRule]]) -> None:
    global _ACTIVE
    _ACTIVE = rules


def check(point: str, ctx: Optional[dict] = None) -> None:
    """The fault point: call at every RPC/IO boundary. No schedule installed
    (the production state) -> a single dict-miss and return."""
    if point not in _ACTIVE:
        return
    GLOBAL.fire(point, ctx)


def corrupt_file(point: str, path: str, ctx: Optional[dict] = None) -> bool:
    """File-corruption fault point (shuffle.write / shuffle.read)."""
    if point not in _ACTIVE:
        return False
    return GLOBAL.corrupt_file(point, path, ctx)


def install(schedule: str, seed: int = 0) -> None:
    GLOBAL.install(schedule, seed)


def clear() -> None:
    GLOBAL.clear()


def install_from_env() -> None:
    """Process bootstrap hook (scheduler/executor mains): BALLISTA_FAULTS
    carries a schedule string, BALLISTA_FAULTS_SEED the default seed."""
    import os

    schedule = os.environ.get("BALLISTA_FAULTS", "")
    if schedule:
        GLOBAL.install(schedule, int(os.environ.get("BALLISTA_FAULTS_SEED", "0")))


def maybe_install_from_props(props: Optional[dict]) -> None:
    """Task-launch hook: a ``ballista.faults.schedule`` session setting
    installs process-wide on the executor (multi-process chaos runs drive
    remote executors through the ordinary launch-props channel).

    Lifetime is bounded by the props, not the process: a task whose props
    OMIT the key (or carry it empty) uninstalls a props-installed schedule,
    so the first normal job after a chaos session restores the executor.
    Schedules installed any other way (env bootstrap, direct install())
    are never touched here."""
    from ballista_tpu_torch.config import BALLISTA_FAULTS_SCHEDULE, BALLISTA_FAULTS_SEED

    schedule = (props or {}).get(BALLISTA_FAULTS_SCHEDULE)
    if not schedule:
        GLOBAL.clear_if_from_props()
        return
    if schedule == GLOBAL.schedule:
        return
    GLOBAL.install(
        schedule, int(props.get(BALLISTA_FAULTS_SEED, "0") or 0),
        from_props=True,
    )
