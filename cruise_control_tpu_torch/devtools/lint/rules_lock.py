"""lock-discipline — lockset consistency for lock-bearing classes.

An AST-level cousin of Eraser's lockset algorithm (Savage et al.),
scoped to where a Python service can actually be checked: any class
that creates a ``threading.Lock``/``RLock``/``Condition`` attribute has
declared that some of its state is shared; inside such a class the rule
flags writes to ``self``-attributes that escape the lock two ways:

* **lockset inconsistency** — the attribute is accessed under
  ``with self.<lock>:`` somewhere in the class, but this write happens
  outside any lock region.  Guarded-somewhere means shared; shared
  means guarded-everywhere.
* **cross-thread write** — the write runs on a code path reachable from
  an internal thread entry point (a ``threading.Thread(target=...)``
  or ``pool.submit(...)`` function) while the same attribute is also
  accessed from a different entry point (e.g. a public method HTTP
  worker threads call), and neither side holds a lock.

Helper methods only ever called with the lock held count as lock
regions themselves (one-level call-graph propagation — the
``_record``/``_rate`` pattern in the flight recorder), and attributes
holding inherently thread-safe primitives (``threading.Event``,
queues, executor pools) are out of scope.  ``__init__`` is
construction-time and exempt.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "lock-discipline"

#: InstrumentedLock is a guarding ctor like the stdlib's: converting a
#: hot lock to the contention wrapper must not lose lockset coverage
_LOCK_CTORS = {"Lock", "RLock", "Condition", "InstrumentedLock"}
#: constructors whose instances synchronize internally — their attrs are
#: exempt from the lockset (calling .set()/.put() needs no outer lock)
_SAFE_CTORS = {"Event", "Semaphore", "BoundedSemaphore", "Barrier",
               "InstrumentedSemaphore",
               "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
               "ThreadPoolExecutor", "ProcessPoolExecutor"}
#: method names that mutate their receiver in place
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "add", "update", "setdefault", "pop", "popleft", "popitem",
             "remove", "discard", "clear", "sort", "reverse", "rotate"}


def _ctor_name(value: ast.expr) -> Optional[str]:
    """The bare class name if ``value`` is a ``Name(...)``/``mod.Name(...)``
    constructor call, else None."""
    if not isinstance(value, ast.Call):
        return None
    f = value.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _self_attr(node: ast.expr) -> Optional[str]:
    """``self.Y`` (descending through subscript chains: ``self.Y[k][1]``
    resolves to Y) → Y, else None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


@dataclasses.dataclass
class _Site:
    attr: str
    write: bool
    locked: bool
    lineno: int
    func: str          # function key (method name or method>nested path)


@dataclasses.dataclass
class _Func:
    key: str
    node: ast.AST
    method: str                    # enclosing method name
    sites: List[_Site] = dataclasses.field(default_factory=list)
    #: self.m(...) call targets, with the lock state at the call site
    calls: List[tuple] = dataclasses.field(default_factory=list)


class _ClassScan:
    """One pass over a ClassDef collecting locks, functions, and sites."""

    def __init__(self, cls: ast.ClassDef):
        self.cls = cls
        self.lock_attrs: Set[str] = set()
        self.safe_attrs: Set[str] = set()
        self.funcs: Dict[str, _Func] = {}
        self.thread_roots: Set[str] = set()    # function keys
        self.public_roots: Set[str] = set()
        self._collect_attr_kinds()
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(stmt, key=stmt.name,
                                    method=stmt.name, locked=False)
                if not stmt.name.startswith("_"):
                    self.public_roots.add(stmt.name)

    def _collect_attr_kinds(self) -> None:
        for node in ast.walk(self.cls):
            if not isinstance(node, ast.Assign):
                continue
            ctor = _ctor_name(node.value)
            if ctor is None:
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None:
                    continue
                if ctor in _LOCK_CTORS:
                    self.lock_attrs.add(attr)
                elif ctor in _SAFE_CTORS:
                    self.safe_attrs.add(attr)

    # ---- per-function scan ----------------------------------------------------
    def _scan_function(self, fn, key: str, method: str,
                       locked: bool) -> None:
        rec = self.funcs[key] = _Func(key=key, node=fn, method=method)
        for stmt in fn.body:
            self._scan_stmt(stmt, rec, locked)

    def _is_lock_with(self, item: ast.withitem) -> bool:
        attr = _self_attr(item.context_expr)
        return attr is not None and attr in self.lock_attrs

    def _scan_stmt(self, node: ast.AST, rec: _Func, locked: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def's body runs later, on whatever thread calls it
            # — never under the lexically-enclosing lock
            self._scan_function(node, key=f"{rec.method}>{node.name}",
                                method=rec.method, locked=False)
            return
        if isinstance(node, ast.With):
            inner = locked or any(self._is_lock_with(i) for i in node.items)
            for i in node.items:
                if not self._is_lock_with(i):
                    self._scan_expr(i.context_expr, rec, locked)
            for stmt in node.body:
                self._scan_stmt(stmt, rec, inner)
            return
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self._scan_target(tgt, rec, locked)
            self._scan_expr(node.value, rec, locked)
            return
        if isinstance(node, ast.AugAssign):
            self._scan_target(node.target, rec, locked)
            self._scan_expr(node.value, rec, locked)
            return
        if isinstance(node, ast.AnnAssign):
            self._scan_target(node.target, rec, locked)
            if node.value is not None:
                self._scan_expr(node.value, rec, locked)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._scan_target(tgt, rec, locked)
            return
        # compound statements: recurse into child statements with the same
        # lock state; everything else is expression territory
        for field in ("body", "orelse", "finalbody"):
            for stmt in getattr(node, field, ()):
                self._scan_stmt(stmt, rec, locked)
        for handler in getattr(node, "handlers", ()):
            for stmt in handler.body:
                self._scan_stmt(stmt, rec, locked)
        for field in ("test", "iter", "value", "exc"):
            child = getattr(node, field, None)
            if isinstance(child, ast.expr):
                self._scan_expr(child, rec, locked)

    def _scan_target(self, tgt: ast.expr, rec: _Func, locked: bool) -> None:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._scan_target(el, rec, locked)
            return
        attr = _self_attr(tgt)
        if attr is not None:
            rec.sites.append(_Site(attr, True, locked, tgt.lineno, rec.key))
        if isinstance(tgt, ast.Subscript):  # index expr is a read
            self._scan_expr(tgt.slice, rec, locked)

    def _scan_expr(self, expr: ast.expr, rec: _Func, locked: bool) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute):
                    base = _self_attr(f.value)
                    if base is not None and f.attr in _MUTATORS:
                        rec.sites.append(_Site(base, True, locked,
                                               node.lineno, rec.key))
                    if (base is None and isinstance(f.value, ast.Name)
                            and f.value.id == "self"):
                        rec.calls.append((f.attr, locked, node.lineno))
                self._note_thread_root(node, rec)
            elif isinstance(node, ast.Attribute):
                attr = _self_attr(node)
                if attr is not None and isinstance(node.ctx, ast.Load):
                    rec.sites.append(_Site(attr, False, locked,
                                           node.lineno, rec.key))

    def _note_thread_root(self, call: ast.Call, rec: _Func) -> None:
        """Thread(target=f) / pool.submit(f): f becomes a thread entry."""
        f = call.func
        callee = f.attr if isinstance(f, ast.Attribute) else getattr(
            f, "id", None)
        cands: List[ast.expr] = []
        if callee == "Thread":
            cands += [kw.value for kw in call.keywords
                      if kw.arg == "target"]
        elif callee in ("submit", "call_soon", "start_new_thread"):
            cands += list(call.args[:1])
        for cand in cands:
            if isinstance(cand, ast.Name):
                self.thread_roots.add(f"{rec.method}>{cand.id}")
            else:
                attr = _self_attr(cand)
                if attr is not None:
                    self.thread_roots.add(attr)


def _reachable(scan: _ClassScan, root: str) -> Set[str]:
    seen, stack = set(), [root]
    while stack:
        key = stack.pop()
        if key in seen or key not in scan.funcs:
            continue
        seen.add(key)
        rec = scan.funcs[key]
        for callee, _locked, _ln in rec.calls:
            stack.append(callee)
        # a method also reaches its own nested defs' call targets only
        # when those defs run — conservatively treat nested defs of a
        # reached thread-root as reached via the root itself (handled by
        # roots being nested keys); do not descend implicitly.
    return seen


def _held_only_methods(scan: _ClassScan) -> Set[str]:
    """Methods every one of whose intra-class call sites holds the lock
    (fixpoint: calls from held-only methods count as held)."""
    held: Set[str] = set()
    while True:
        changed = False
        for key, rec in scan.funcs.items():
            if key in held or key in scan.public_roots \
                    or key in scan.thread_roots:
                continue
            callers = [
                (caller.key, locked)
                for caller in scan.funcs.values()
                for callee, locked, _ln in caller.calls
                if callee == key
            ]
            if callers and all(
                locked or ckey in held for ckey, locked in callers
            ):
                if key not in held:
                    held.add(key)
                    changed = True
        if not changed:
            return held


class LockDisciplineRule:
    id = RULE_ID
    summary = ("in lock-bearing classes, writes to shared self-attributes "
               "must hold the lock (lockset consistency + cross-thread "
               "write detection)")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ctx.all_nodes:
            if isinstance(node, ast.ClassDef):
                out.extend(self._check_class(ctx, node))
        return out

    def _check_class(self, ctx: FileContext,
                     cls: ast.ClassDef) -> List[Finding]:
        scan = _ClassScan(cls)
        if not scan.lock_attrs:
            return []
        held = _held_only_methods(scan)

        def effective_locked(site: _Site) -> bool:
            return site.locked or site.func in held

        skip = scan.lock_attrs | scan.safe_attrs
        sites = [
            s for rec in scan.funcs.values() for s in rec.sites
            if s.attr not in skip and rec.key != "__init__"
        ]
        guarded: Dict[str, List[int]] = {}
        for s in sites:
            if effective_locked(s):
                guarded.setdefault(s.attr, []).append(s.lineno)

        roots = scan.public_roots | scan.thread_roots
        reach = {r: _reachable(scan, r) for r in roots}

        def site_roots(site: _Site) -> frozenset:
            return frozenset(r for r in roots if site.func in reach[r])

        lock_names = " / ".join(
            f"self.{a}" for a in sorted(scan.lock_attrs))
        out: List[Finding] = []
        for s in sites:
            if not s.write or effective_locked(s):
                continue
            if s.attr in guarded:
                lines = sorted(set(guarded[s.attr]))[:3]
                out.append(Finding(
                    ctx.path, s.lineno, RULE_ID,
                    f"{cls.name}.{s.attr} written without holding "
                    f"{lock_names}, but the same attribute is used under "
                    f"the lock at line(s) {lines} — guarded-somewhere "
                    "means shared; take the lock here too",
                ))
                continue
            mine = site_roots(s)
            if not mine:
                continue
            for other in sites:
                if other.attr != s.attr or other.func == s.func:
                    continue
                theirs = site_roots(other)
                if not theirs or theirs == mine:
                    continue
                if (mine | theirs) & scan.thread_roots:
                    kind = "written" if other.write else "read"
                    out.append(Finding(
                        ctx.path, s.lineno, RULE_ID,
                        f"{cls.name}.{s.attr} written here on a thread "
                        f"entry path without a lock while also {kind} at "
                        f"line {other.lineno} on a different entry path — "
                        f"guard both sides with {lock_names}",
                    ))
                    break
        return out
