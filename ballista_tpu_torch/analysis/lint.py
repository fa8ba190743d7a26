"""Codebase lint suite: the port's copy of ``ballista_tpu/analysis/lint.py``.

An AST-based linter (stdlib ``ast`` only — no third-party deps) with
race-detector-flavored rules for the scheduler/executor and JAX tracing rules
for the engine. The two bug classes it targets have dominated fixes so far:
scheduler concurrency hazards (blocking work under a lock, inconsistent lock
acquisition order) and JAX tracing pitfalls (host ops inside jit-traced
functions, nondeterministic iteration feeding plan hashes).

The rules are the JAX package's, every one of them: they read source text and
import nothing they inspect, so this linter reports on any input what the
reference reports. BL101 looks for ``jax.jit``, which the port never calls:
it finds nothing in the port's own tree and stays so that both linters agree
on every input. The port's baseline (``lint_baseline.json`` beside this file)
starts empty.

Run::

    python -m ballista_tpu_torch.analysis.lint ballista_tpu_torch/ [--baseline FILE]
    python -m ballista_tpu_torch.analysis.lint ballista_tpu_torch/ --write-baseline

Rule catalog (ids are stable; see docs/static_analysis.md):

* ``BL001 blocking-under-lock``   — a blocking call (``time.sleep``, file
  ``open()``, a synchronous gRPC stub RPC, ``subprocess`` waits, future
  ``.result()``) inside a ``with <lock>:`` block — directly, or through a
  chain of ``self.method()`` calls within the same class (the whole callee
  body runs under the caller's lock). Every other thread queueing on that
  lock stalls for the call's full latency.
* ``BL002 blocking-in-callback``  — a blocking call in an event-loop callback
  (``on_receive``/``on_start``/``on_error`` of an ``EventAction``): the loop
  is single-consumer, so one slow handler head-of-line-blocks every event.
* ``BL003 lock-order``            — lock A is taken while holding B in one
  function and B while holding A in another: the classic ABBA deadlock.
* ``BL004 guarded-state``         — a ``self`` attribute is mutated under a
  ``with <lock>:`` block in one method of a class but mutated lock-free in
  another: either the lock is unnecessary or the lock-free site is a race.
  ``__init__``/``__new__`` are exempt (single-threaded construction), as are
  ``*_locked`` methods and ``@concurrency.guarded_by`` methods (their
  contract is that the caller already holds the lock).
* ``BL005 per-call-lock``         — a lock constructed inside a function and
  only ever acquired locally (``threading.Lock()`` / ``concurrency.
  make_lock()`` assigned to a local, or ``with threading.Lock():`` inline):
  every call gets a FRESH lock, so it can never exclude concurrent callers.
  Locks that escape the call (returned, captured by a nested def, stored
  into an attribute/container, passed to another call) are exempt.
* ``BL101 host-call-in-jit``      — a host-side call (``np.*``, ``print``,
  ``.item()``, ``.tolist()``) inside a function that is jit-traced
  (``@jax.jit`` decorated or passed to ``jax.jit``): it either breaks the
  trace or silently constant-folds a traced value.
* ``BL102 unordered-iteration``   — iteration over a ``set``/``frozenset``
  inside hashing/serde/fingerprint code: Python set order is not
  deterministic across processes, so plan hashes/serialized bytes diverge.

Suppression: append ``# ballista: lint-ok[RULE]`` to the flagged line (a bare
``# ballista: lint-ok`` suppresses every rule on that line). Findings may also
be absorbed by a checked-in baseline file (counts keyed by file + rule +
enclosing function) so legacy debt does not block CI while new violations do.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
from dataclasses import dataclass
from typing import Optional

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "lint_baseline.json")

SUPPRESS_RE = re.compile(r"#\s*ballista:\s*lint-ok(?:\[([A-Za-z0-9_,\s]+)\])?")

# attribute names whose *text* marks the context expr as a lock
# (covers _lock, _revive_lock, mutex, _mu, semaphores)
_LOCK_HINT_RE = re.compile(r"lock|mutex|sem(aphore)?$|^_?mu$", re.IGNORECASE)
# gRPC stub method naming convention in this repo: CamelCase RPC names
_CAMEL_RPC_RE = re.compile(r"^[A-Z][a-z0-9]+(?:[A-Z][A-Za-z0-9]*)+$")
_STUB_HINT_RE = re.compile(r"stub", re.IGNORECASE)
_HASHING_FN_RE = re.compile(
    r"fingerprint|hash|serde|signature|encode|to_json|cache_key", re.IGNORECASE
)
_EVENT_CALLBACKS = {"on_receive", "on_start", "on_error"}
# np attributes that are legal inside a trace (dtype constructors / constants)
_NP_TRACE_OK = {
    "dtype", "bool_", "int8", "int16", "int32", "int64", "uint8", "uint16",
    "uint32", "uint64", "float16", "float32", "float64", "issubdtype",
    "iinfo", "finfo", "ndim", "shape",
}


@dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    scope: str  # dotted qualname of the enclosing function/class

    def key(self) -> str:
        return f"{self.path}::{self.rule}::{self.scope}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message} (in {self.scope or '<module>'})"


def _src(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # noqa: BLE001 - display only
        return type(node).__name__


def _is_lockish(expr: ast.expr) -> Optional[str]:
    """A with-item context manager that looks like a lock. Returns the lock's
    normalized identity (``_revive_lock``), or None."""
    target = expr
    # threading.Lock()-returning helpers: with self._lock_for(x): ...
    if isinstance(target, ast.Call):
        target = target.func
    text = _src(target)
    leaf = text.split(".")[-1].split("(")[0]
    if _LOCK_HINT_RE.search(leaf):
        return leaf
    return None


def _blocking_reason(call: ast.Call) -> Optional[str]:
    """Classify a call as blocking. Conservative: only patterns that are
    near-certainly synchronous waits in this codebase."""
    f = call.func
    if isinstance(f, ast.Name):
        if f.id == "open":
            return "file I/O open()"
        return None
    if not isinstance(f, ast.Attribute):
        return None
    base = _src(f.value)
    attr = f.attr
    if attr == "sleep" and base in ("time",):
        return "time.sleep()"
    if base.startswith("subprocess") and attr in (
        "run", "call", "check_call", "check_output", "wait", "communicate"
    ):
        return f"subprocess.{attr}()"
    if attr == "result" and not call.args and not call.keywords:
        return ".result() wait on a future"
    if attr in ("read", "write") and _src(f.value).endswith("file"):
        return f"file .{attr}()"
    if _CAMEL_RPC_RE.match(attr) and _STUB_HINT_RE.search(base):
        return f"synchronous RPC {attr}()"
    return None


def _jit_decorated(fn: ast.FunctionDef) -> bool:
    for dec in fn.decorator_list:
        text = _src(dec)
        if text in ("jit", "jax.jit") or text.startswith(("jax.jit(", "jit(")):
            return True
        if isinstance(dec, ast.Call) and _src(dec.func) in (
            "partial", "functools.partial"
        ):
            if dec.args and _src(dec.args[0]) in ("jit", "jax.jit"):
                return True
    return False


def _host_call_reason(node: ast.Call) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name) and f.id == "print":
        return "print() inside a traced function"
    if isinstance(f, ast.Attribute):
        base = _src(f.value)
        if base in ("np", "numpy") and f.attr not in _NP_TRACE_OK:
            return f"host numpy call np.{f.attr}() inside a traced function"
        if f.attr in ("item", "tolist") and not node.args:
            return f".{f.attr}() forces a device sync inside a traced function"
    return None


def _iterates_set(it: ast.expr) -> bool:
    if isinstance(it, ast.Set):
        return True
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
        return it.func.id in ("set", "frozenset")
    return False


class _FileLinter:
    def __init__(self, path: str, rel: str, tree: ast.Module, lines: list[str]):
        self.path = path
        self.rel = rel
        self.tree = tree
        self.lines = lines
        self.findings: list[LintFinding] = []
        # lock-order edges discovered in this file: (outer, inner) -> site
        self.lock_edges: dict[tuple[str, str], LintFinding] = {}
        self._scope: list[str] = []
        self._class_stack: list[str] = []
        self._lock_stack: list[tuple[str, ast.AST]] = []
        self._event_action_classes: set[str] = set()
        self._jitted_fns: set[ast.FunctionDef] = set()
        # interprocedural BL001: per-class method facts + under-lock call seeds
        self._methods: dict[tuple[str, str], dict] = {}
        self._lock_seeds: list[tuple[str, str, str, str]] = []  # cls, meth, lock, caller

    # -- suppression ---------------------------------------------------------------
    def _suppressed(self, line: int, rule: str) -> bool:
        if 1 <= line <= len(self.lines):
            m = SUPPRESS_RE.search(self.lines[line - 1])
            if m:
                rules = m.group(1)
                if rules is None:
                    return True
                return rule in {r.strip() for r in rules.split(",")}
        return False

    def _add(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 1)
        if self._suppressed(line, rule):
            return
        self.findings.append(
            LintFinding(self.rel, line, getattr(node, "col_offset", 0),
                        rule, message, ".".join(self._scope))
        )

    # -- pre-pass: which defs are jitted / which classes are EventActions -----------
    def _prepass(self) -> None:
        defs_by_name: dict[str, list[ast.FunctionDef]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)
                if _jit_decorated(node):
                    self._jitted_fns.add(node)
            elif isinstance(node, ast.ClassDef):
                base_texts = {_src(b) for b in node.bases}
                if base_texts & {"EventAction", "event_loop.EventAction"}:
                    self._event_action_classes.add(node.name)
        # jax.jit(fn_name) / jax.jit(lambda ...) applied to a named local def
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            if _src(node.func) not in ("jax.jit", "jit"):
                continue
            if node.args and isinstance(node.args[0], ast.Name):
                for d in defs_by_name.get(node.args[0].id, []):
                    self._jitted_fns.add(d)

    # -- method facts for the interprocedural BL001 pass ---------------------------
    @staticmethod
    def _walk_own_body(fn):
        """Walk a function body, NOT descending into nested function/class
        defs (closures usually run later on another thread; inline callees
        are covered by the call-chain propagation instead)."""
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                stack.append(child)

    def _collect_method_facts(self) -> None:
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                blocking, self_calls = [], []
                for sub in self._walk_own_body(fn):
                    if not isinstance(sub, ast.Call):
                        continue
                    reason = _blocking_reason(sub)
                    if reason is not None:
                        blocking.append((sub, reason))
                    f = sub.func
                    if (
                        isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "self"
                    ):
                        self_calls.append(f.attr)
                self._methods[(node.name, fn.name)] = {
                    "blocking": blocking, "self_calls": self_calls,
                }

    def _propagate_lock_seeds(self) -> None:
        """BL001 through self.method() chains: a method invoked while a lock
        is held runs its entire body (and its own self-calls) under that
        lock."""
        visited: set[tuple[str, str, str]] = set()
        queue = [(c, m, lock, (caller,)) for c, m, lock, caller in self._lock_seeds]
        while queue:
            cls, meth, lock, chain = queue.pop(0)
            if (cls, meth, lock) in visited:
                continue
            visited.add((cls, meth, lock))
            facts = self._methods.get((cls, meth))
            if facts is None:
                continue
            via = " -> ".join(chain + (meth,))
            saved = self._scope
            self._scope = [cls, meth]
            for site, reason in facts["blocking"]:
                self._add(site, "BL001",
                          f"blocking {reason} while holding lock {lock!r} "
                          f"(call chain {via})")
            self._scope = saved
            for callee in facts["self_calls"]:
                queue.append((cls, callee, lock, chain + (meth,)))

    # -- main walk ------------------------------------------------------------------
    def run(self) -> None:
        self._prepass()
        self._collect_method_facts()
        for stmt in self.tree.body:
            self._visit(stmt)
        self._propagate_lock_seeds()
        self._check_guarded_state()
        self._check_local_locks()

    def _visit(self, node: ast.AST, in_callback: bool = False) -> None:
        if isinstance(node, ast.ClassDef):
            self._scope.append(node.name)
            self._class_stack.append(node.name)
            is_action = node.name in self._event_action_classes
            for child in node.body:
                if (
                    is_action
                    and isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and child.name in _EVENT_CALLBACKS
                ):
                    self._visit_function(child, in_callback=True)
                else:
                    self._visit(child)
            self._class_stack.pop()
            self._scope.pop()
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self._visit_function(node, in_callback=False)
            return
        self._visit_stmt(node, in_callback)

    def _visit_function(self, fn, in_callback: bool) -> None:
        self._scope.append(fn.name)
        # a nested def does not inherit the lock context: the closure usually
        # runs later on another thread (and if it runs inline, the with-block
        # rules still see the call sites it contains when visited here)
        saved_locks = self._lock_stack
        self._lock_stack = []
        jitted = fn in self._jitted_fns
        if jitted:
            self._check_jit_body(fn)
        if _HASHING_FN_RE.search(fn.name):
            self._check_hashing_body(fn)
        for stmt in fn.body:
            self._visit_stmt(stmt, in_callback)
        self._lock_stack = saved_locks
        self._scope.pop()

    def _visit_stmt(self, node: ast.AST, in_callback: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            self._visit(node)
            return
        if isinstance(node, ast.With):
            locks = []
            for item in node.items:
                lock = _is_lockish(item.context_expr)
                if lock is not None:
                    locks.append(lock)
            for lock in locks:
                for held, _site in self._lock_stack:
                    if held != lock and not self._suppressed(node.lineno, "BL003"):
                        self.lock_edges.setdefault(
                            (held, lock),
                            LintFinding(
                                self.rel, node.lineno, node.col_offset, "BL003",
                                f"acquires {lock!r} while holding {held!r}",
                                ".".join(self._scope),
                            ),
                        )
                self._lock_stack.append((lock, node))
            for stmt in node.body:
                self._visit_stmt(stmt, in_callback)
            for _ in locks:
                self._lock_stack.pop()
            return
        # expressions and remaining statements: scan for calls
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                self._visit(child)
            elif isinstance(child, ast.stmt):
                self._visit_stmt(child, in_callback)
            else:
                self._scan_calls(child, in_callback)

    def _scan_calls(self, node: ast.AST, in_callback: bool) -> None:
        for call in ast.walk(node):
            # nested defs inside expressions (lambdas) keep their own context
            if isinstance(call, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not isinstance(call, ast.Call):
                continue
            f = call.func
            if (
                self._lock_stack
                and self._class_stack
                and isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
            ):
                # self.method() under a lock: the callee body runs locked too
                self._lock_seeds.append(
                    (self._class_stack[-1], f.attr, self._lock_stack[-1][0],
                     self._scope[-1] if self._scope else "<module>")
                )
            reason = _blocking_reason(call)
            if reason is None:
                continue
            if self._lock_stack:
                held = self._lock_stack[-1][0]
                self._add(call, "BL001",
                          f"blocking {reason} while holding lock {held!r}")
            if in_callback:
                self._add(call, "BL002",
                          f"blocking {reason} inside an event-loop callback")

    # -- BL004: guarded-state consistency --------------------------------------------
    # self-attribute methods whose CALL mutates the receiver in place
    _MUTATOR_METHODS = {
        "append", "appendleft", "add", "clear", "discard", "extend", "insert",
        "move_to_end", "pop", "popitem", "remove", "setdefault", "update",
    }

    @staticmethod
    def _self_attr_path(expr: ast.expr) -> Optional[str]:
        """``self.X.Y`` -> ``"X.Y"``; None for anything not rooted at self."""
        parts: list[str] = []
        while isinstance(expr, ast.Attribute):
            parts.append(expr.attr)
            expr = expr.value
        if isinstance(expr, ast.Name) and expr.id == "self" and parts:
            return ".".join(reversed(parts))
        return None

    @staticmethod
    def _locked_contract(fn) -> bool:
        """Methods whose contract says the caller already holds the lock."""
        if fn.name.endswith("_locked"):
            return True
        return any("guarded_by" in _src(d) for d in fn.decorator_list)

    def _iter_mutations(self, fn, base_lock: Optional[str]):
        """Yield (site, attr_path, lock_name|None) for every self-attribute
        mutation in ``fn``'s own body. Nested defs are skipped (closures run
        on another thread/later — their lock context is not this method's)."""

        def emit_targets(node, targets, lock, out):
            for t in targets:
                for el in (t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]):
                    tgt = el.value if isinstance(el, ast.Subscript) else el
                    path = self._self_attr_path(tgt)
                    if path is not None:
                        out.append((node, path, lock))

        def walk(node, lock, out):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda, ast.ClassDef)):
                return
            if isinstance(node, ast.With):
                inner = lock
                for item in node.items:
                    lk = _is_lockish(item.context_expr)
                    if lk is not None:
                        inner = lk
                for b in node.body:
                    walk(b, inner, out)
                return
            if isinstance(node, ast.Assign):
                emit_targets(node, node.targets, lock, out)
            elif isinstance(node, ast.AugAssign):
                emit_targets(node, [node.target], lock, out)
            elif isinstance(node, ast.Delete):
                emit_targets(node, node.targets, lock, out)
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and f.attr in self._MUTATOR_METHODS:
                    path = self._self_attr_path(f.value)
                    if path is not None:
                        out.append((node, path, lock))
            for child in ast.iter_child_nodes(node):
                walk(child, lock, out)

        out: list[tuple[ast.AST, str, Optional[str]]] = []
        for stmt in fn.body:
            walk(stmt, base_lock, out)
        return out

    def _check_guarded_state(self) -> None:
        saved = self._scope
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            locked_by: dict[str, tuple[str, str]] = {}  # attr -> (lock, method)
            unlocked: dict[str, list[tuple[ast.AST, str]]] = {}
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if fn.name in ("__init__", "__new__"):
                    continue  # construction is single-threaded
                base = "<caller-held>" if self._locked_contract(fn) else None
                for site, attr, lock in self._iter_mutations(fn, base):
                    if lock is not None:
                        locked_by.setdefault(attr, (lock, fn.name))
                    else:
                        unlocked.setdefault(attr, []).append((site, fn.name))
            for attr, sites in sorted(unlocked.items()):
                if attr not in locked_by:
                    continue
                lock, meth = locked_by[attr]
                for site, fn_name in sites:
                    self._scope = [node.name, fn_name]
                    self._add(
                        site, "BL004",
                        f"attribute {attr!r} mutated without a lock here but "
                        f"under {lock!r} in {meth}(): either the lock is "
                        "unnecessary or this site races it",
                    )
        self._scope = saved

    # -- BL005: per-call lock construction -------------------------------------------
    _LOCK_CTORS = {
        "threading.Lock", "threading.RLock", "threading.Semaphore",
        "threading.BoundedSemaphore", "threading.Condition",
        "concurrency.make_lock", "concurrency.make_rlock",
    }

    def _check_local_locks(self) -> None:
        saved = self._scope
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            candidates: list[tuple[ast.AST, str, str]] = []  # site, name, ctor
            escaped: set[str] = set()
            for node in ast.walk(fn):
                if (
                    isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda))
                    and node is not fn
                ):
                    # captured by a closure: the lock outlives this call
                    # (once-flag idiom: released = Lock(); cb releases it)
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Name):
                            escaped.add(sub.id)
                elif isinstance(node, ast.Return) and node.value is not None:
                    for sub in ast.walk(node.value):
                        if isinstance(sub, ast.Name):
                            escaped.add(sub.id)
                elif isinstance(node, ast.Call):
                    # args/keywords escape; name.acquire()/.release() do not
                    for sub in list(node.args) + [kw.value for kw in node.keywords]:
                        for s2 in ast.walk(sub):
                            if isinstance(s2, ast.Name):
                                escaped.add(s2.id)
                elif isinstance(node, ast.Assign):
                    ctor = (
                        _src(node.value.func)
                        if isinstance(node.value, ast.Call)
                        else None
                    )
                    if ctor in self._LOCK_CTORS:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                candidates.append((node, t.id, ctor))
                    # storing into an attribute/subscript escapes the value
                    if any(isinstance(t, (ast.Attribute, ast.Subscript))
                           for t in node.targets):
                        for s2 in ast.walk(node.value):
                            if isinstance(s2, ast.Name):
                                escaped.add(s2.id)
                elif isinstance(node, ast.With):
                    for item in node.items:
                        ce = item.context_expr
                        if (
                            isinstance(ce, ast.Call)
                            and _src(ce.func) in self._LOCK_CTORS
                        ):
                            self._scope = [fn.name]
                            self._add(
                                ce, "BL005",
                                f"{_src(ce.func)}() constructed inline in a "
                                "with-statement: every call locks a FRESH "
                                "lock, excluding nobody",
                            )
            for site, name, ctor in candidates:
                if name in escaped:
                    continue
                self._scope = [fn.name]
                self._add(
                    site, "BL005",
                    f"lock {name!r} constructed per call ({ctor}()) and never "
                    "escapes: each call locks a fresh lock, excluding nobody "
                    "— hoist it to __init__/module scope",
                )
        self._scope = saved

    # -- BL101: host calls inside jitted functions ----------------------------------
    def _check_jit_body(self, fn) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                reason = _host_call_reason(node)
                if reason is not None:
                    self._add(node, "BL101", reason)

    # -- BL102: unordered iteration in hashing/serde code ---------------------------
    _ORDERED_CONSUMERS = {"sorted", "min", "max", "set", "frozenset", "sum"}

    def _check_hashing_body(self, fn) -> None:
        # a comprehension whose RESULT goes straight into an order-insensitive
        # or explicitly ordering consumer (sorted(str(k) for k in set(..)))
        # is deterministic by construction — collect those first and skip them
        ordered: set[ast.AST] = set()
        for node in ast.walk(fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in self._ORDERED_CONSUMERS
            ):
                for arg in node.args:
                    if isinstance(arg, (ast.ListComp, ast.SetComp,
                                        ast.GeneratorExp)):
                        ordered.add(arg)
        for node in ast.walk(fn):
            iters = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                if node in ordered:
                    continue
                iters.extend(g.iter for g in node.generators)
            for it in iters:
                if _iterates_set(it):
                    self._add(
                        node, "BL102",
                        f"iteration over a set ({_src(it)[:40]}) in "
                        "hashing/serde code: order is nondeterministic",
                    )


# ---- driver -----------------------------------------------------------------------
def _iter_py_files(paths: list[str]) -> list[str]:
    out = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
    return out


def lint_paths(paths: list[str], root: Optional[str] = None) -> list[LintFinding]:
    root = root or os.getcwd()
    findings: list[LintFinding] = []
    # lock-order edges across the whole run: ABBA pairs are reported wherever
    # the second direction shows up, regardless of file
    edges: dict[tuple[str, str], LintFinding] = {}
    for path in _iter_py_files(paths):
        rel = os.path.relpath(path, root)
        try:
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError) as e:
            findings.append(
                LintFinding(rel, getattr(e, "lineno", 1) or 1, 0, "BL000",
                            f"cannot parse: {e}", ""))
            continue
        linter = _FileLinter(path, rel, tree, source.splitlines())
        linter.run()
        findings.extend(linter.findings)
        for edge, site in linter.lock_edges.items():
            edges.setdefault(edge, site)
    for (a, b), site in sorted(edges.items()):
        if (b, a) in edges and a < b:
            other = edges[(b, a)]
            for s, o in ((site, other), (other, site)):
                findings.append(
                    LintFinding(
                        s.path, s.line, s.col, "BL003",
                        f"lock-order inversion: {s.message}; the opposite "
                        f"order is taken at {o.path}:{o.line}",
                        s.scope,
                    )
                )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ---- baseline ---------------------------------------------------------------------
def load_baseline(path: str) -> dict[str, int]:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def apply_baseline(
    findings: list[LintFinding], baseline: dict[str, int]
) -> list[LintFinding]:
    """New findings = findings beyond each baseline bucket's count."""
    budget = dict(baseline)
    fresh = []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            fresh.append(f)
    return fresh


def write_baseline(findings: list[LintFinding], path: str) -> None:
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.key()] = counts.get(f.key(), 0) + 1
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(
            {
                "comment": "lint baseline: legacy findings absorbed by CI; "
                           "regenerate with --write-baseline",
                "findings": dict(sorted(counts.items())),
            },
            fh, indent=2, sort_keys=False,
        )
        fh.write("\n")


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ballista_tpu_torch.analysis.lint",
        description="ballista-tpu concurrency/JAX lint suite",
    )
    ap.add_argument("paths", nargs="+", help="files or directories to lint")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report everything")
    ap.add_argument("--write-baseline", action="store_true",
                    help="absorb all current findings into the baseline file")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths)
    if args.write_baseline:
        write_baseline(findings, args.baseline)
        print(f"wrote {len(findings)} findings to {args.baseline}")
        return 0
    if not args.no_baseline:
        findings = apply_baseline(findings, load_baseline(args.baseline))
    for f in findings:
        print(f.render())
    if findings:
        print(f"\n{len(findings)} finding(s). Fix, suppress with "
              "'# ballista: lint-ok[RULE]', or absorb with --write-baseline.")
        return 1
    print("lint clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
