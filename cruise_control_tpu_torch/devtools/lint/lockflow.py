"""Flow-sensitive lock analysis shared by the three concurrency rules
(``lock-order``, ``blocking-under-lock``, ``lock-release-safety``).

Built once per run (lazily, cached on :class:`ProjectContext`), in
three passes:

1. **Intra** — for every function with a CFG, run the must-lockset
   analysis (``dataflow.must_locksets``) and record (a) each lock
   acquisition with the set of NAMED locks already held, (b) each call
   site executed while a named lock is held, and (c) each blocking op
   with the locks held at it.  Lock identity comes from the PR-10
   receiver-typing machinery: ``self._x`` resolves through
   ``ClassSummary.lock_names`` (captured from
   ``InstrumentedLock("name")`` constructor literals, including
   ``Condition(InstrumentedLock(...))`` wrapping), locals/globals
   through ``FuncSummary.lock_names``, and a module-level lock of
   another module through this module's imports (the port's
   ``DEVICE_LOCK``).  Unnamed locks are invisible to the ordering
   vocabulary (documented blind spot).

2. **Transitive fixpoints** — project acquisitions and blocking ops
   through the callgraph (skipping ``spawn`` edges: work handed to a
   thread or pool does not run under the caller's locks), keeping a
   representative witness chain per (function, lock) / (function, op).
   A ``with X:`` over a project context-manager class (e.g. the model
   generation lock wrapping the instrumented semaphore) is treated as
   a call to its ``__enter__``.

3. **Global edges** — every acquisition of ``B`` while ``A`` is held
   (directly or through a projected call) becomes an edge ``A → B``
   with a file:line witness chain.  Same-name self-edges are dropped:
   distinct instances sharing a name (every EventJournal is
   "journal.events") are indistinguishable statically.

The polarity everywhere is UNDER-approximation: must-locksets only
report a lock held when it is held on every path, and unresolved
receivers contribute nothing — the rules miss edges rather than invent
them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set, Tuple

from cruise_control_tpu_torch.devtools.lint import cfg as cfg_mod
from cruise_control_tpu_torch.devtools.lint import dataflow
from cruise_control_tpu_torch.devtools.lint.callgraph import fid
from cruise_control_tpu_torch.devtools.lint.graph import (
    BlockingOp,
    FuncSummary,
)

#: receiver constructor tails that make a zero-arg ``.get()`` /
#: ``.put()`` a blocking queue op
_QUEUE_CTORS = frozenset((
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue", "JoinableQueue",
))

#: witness-chain depth cap (renders stay readable; deeper chains add
#: nothing a reviewer can act on)
#: — 16 where the reference has 8: the served port takes the engine's
#: step-loop lock 13 hops below the facade's single flight, an order the
#: runtime witness sees
_CHAIN_CAP = 16


@dataclasses.dataclass(frozen=True)
class Acq:
    """One lock acquisition with flow-sensitive context."""

    lock: str
    path: str
    line: int
    held: frozenset            # named locks held BEFORE this acquire
    via: str                   # "with" | "call"


@dataclasses.dataclass(frozen=True)
class BlockSite:
    """One blocking op, resolved and filtered for applicability."""

    path: str
    line: int
    desc: str
    #: lock the op itself releases while blocked (Condition.wait) —
    #: subtracted from the held set before reporting
    own: Optional[str] = None


def _label(function_id: str) -> str:
    return function_id.split(":", 1)[1]


class LockFlow:
    def __init__(self, project) -> None:
        t0 = time.perf_counter()
        self.graph = project.graph
        self.cg = project.callgraph
        #: fid → direct acquisitions (named locks only)
        self.acquires: Dict[str, List[Acq]] = {}
        #: fid → (callee fid, line, held) for call sites under a lock
        self.calls_held: Dict[str, List[Tuple[str, int, frozenset]]] = {}
        #: fid → (site, held-at-op) for every applicable blocking op
        self.direct_blocking: Dict[str, List[Tuple[BlockSite,
                                                   frozenset]]] = {}
        #: (A, B) → witness chain of (path, line, note) for "A held
        #: while B acquired"; first witness wins, count accumulates
        self.edge_witness: Dict[Tuple[str, str], Tuple] = {}
        self.edge_count: Dict[Tuple[str, str], int] = {}
        #: every named lock seen anywhere (graph nodes incl. isolated)
        self.lock_vocab: Set[str] = set()
        self._resolve_memo: Dict[Tuple[str, str, str], Optional[str]] = {}
        #: factory-resolution cycle breaker: keys currently mid-resolve
        self._resolving: Set[Tuple[str, str, str]] = set()
        #: synthesized call edges: with-statement → __enter__
        self._synth: Dict[str, List[Tuple[str, int]]] = {}
        self._build_intra()
        self.trans_acquires = self._fix_acquires()
        self.trans_blocking = self._fix_blocking()
        self._project_edges()
        self.build_ms = (time.perf_counter() - t0) * 1000.0

    # ---- lock identity ----------------------------------------------------------
    def resolve_lock(self, module: str, func: FuncSummary,
                     obj: str) -> Optional[str]:
        """Dotted lock expression as written → named-lock id, or None
        when unnamed/unresolvable."""
        key = (module, func.name, obj)
        if key in self._resolve_memo:
            return self._resolve_memo[key]
        out: Optional[str] = None
        s = self.graph.modules.get(module)
        if "." not in obj:
            out = func.lock_names.get(obj)
            if out is None and s is not None:
                mod_fn = s.functions.get("<module>")
                if mod_fn is not None:
                    out = mod_fn.lock_names.get(obj)
            if out is None:
                out = self._imported_lock(module, obj)
            if out is None and key not in self._resolving:
                self._resolving.add(key)
                try:
                    out = self._factory_lock(module, func, obj)
                finally:
                    self._resolving.discard(key)
        else:
            recv, attr = obj.rsplit(".", 1)
            hit = self.graph.class_of_receiver(module, func, recv)
            if hit is not None:
                out = hit[1].lock_names.get(attr)
            else:
                out = self._imported_lock(module, obj)
        self._resolve_memo[key] = out  # cclint: disable=cache-key-discipline -- analysis-lifetime memo: a LockFlow is built once per lint run over an immutable SymbolGraph and discarded with it; nothing can go stale
        return out

    def _imported_lock(self, module: str, obj: str) -> Optional[str]:
        """A module-level named lock of another project module, reached
        through this module's imports: ``from m import LOCK; with LOCK:``
        or ``import m; with m.LOCK:`` (the port's ``utils/device.py:
        DEVICE_LOCK``, taken by the optimizer and the what-if engine)."""
        head, _, rest = obj.partition(".")
        target = self.graph.import_aliases(module).get(head)
        if target is None:
            return None
        owner, _, name = (f"{target}.{rest}" if rest else target) \
            .rpartition(".")
        s = self.graph.modules.get(owner)
        mod_fn = s.functions.get("<module>") if s is not None else None
        return mod_fn.lock_names.get(name) if mod_fn is not None else None

    def _factory_lock(self, module: str, func: FuncSummary,
                      var: str) -> Optional[str]:
        """``lock = factory(); with lock:`` — resolve through a
        context-manager factory.  The bound callee must be a project
        function whose every ``return`` constructs the SAME
        ``Guard(lock_expr, ...)``, where ``Guard.__enter__`` performs
        an acquire; the first constructor argument is then resolved as
        a lock expression in the factory's own scope (the
        model-generation-lock idiom in ``monitor/load_monitor.py``).
        Anything short of that exact shape yields None — the
        under-approximation the must-lockset polarity requires."""
        callee = func.var_types.get(var)
        if not callee:
            return None
        target = self.cg._resolve(module, func, callee)
        if target is None:
            return None
        tmod, tkey = target.split(":", 1)
        ts = self.graph.modules.get(tmod)
        tfunc = ts.functions.get(tkey) if ts is not None else None
        if tfunc is None:
            return None
        shapes = set(tfunc.returns_calls)
        if len(shapes) != 1:
            return None
        ctor, arg = next(iter(shapes))
        if arg is None:
            return None
        hit = self.graph.resolve_class(tmod, ctor)
        if hit is None:
            return None
        found = self.graph.class_method(hit[0], hit[1], "__enter__")
        if found is None or found[1].cfg is None:
            return None
        if not any(e.kind == cfg_mod.ACQUIRE
                   for b in found[1].cfg.blocks for e in b.events):
            return None
        return self.resolve_lock(tmod, tfunc, arg)

    def _factory_enter(self, module: str, func: FuncSummary,
                       obj: str) -> Optional[str]:
        """``with factory_call(...):`` — fid of the returned guard's
        ``__enter__``, when the callee is a project function whose
        every ``return`` constructs the SAME project class (the
        progress-step idiom: ``with progress.step(...)``).  Lock state
        projects through the __enter__ like any other call."""
        target = self.cg._resolve(module, func, obj)
        if target is None:
            return None
        tmod, tkey = target.split(":", 1)
        ts = self.graph.modules.get(tmod)
        tfunc = ts.functions.get(tkey) if ts is not None else None
        if tfunc is None or not tfunc.returns_calls:
            return None
        ctors = {c for c, _ in tfunc.returns_calls}
        if len(ctors) != 1:
            return None
        hit = self.graph.resolve_class(tmod, next(iter(ctors)))
        if hit is None:
            return None
        found = self.graph.class_method(hit[0], hit[1], "__enter__")
        if found is None:
            return None
        t = fid(found[0], found[1].name)
        return t if t in self.cg.funcs else None

    def _recv_type(self, module: str, func: FuncSummary,
                   recv: str) -> Optional[str]:
        """Constructor-dotted type of a receiver expression (queue
        detection) — locals first, then class attribute types."""
        if "." not in recv:
            return func.var_types.get(recv) or func.annotations.get(recv)
        owner, attr = recv.rsplit(".", 1)
        hit = self.graph.class_of_receiver(module, func, owner)
        if hit is None:
            return None
        return hit[1].attr_types.get(attr)

    def _enter_target(self, module: str, func: FuncSummary,
                      obj: str) -> Optional[str]:
        """``with X:`` over a project context-manager class → the fid
        of its ``__enter__`` (lock state projects through it)."""
        hit = self.graph.class_of_receiver(module, func, obj)
        if hit is None:
            return None
        found = self.graph.class_method(hit[0], hit[1], "__enter__")
        if found is None:
            return None
        target = fid(found[0], found[1].name)
        return target if target in self.cg.funcs else None

    # ---- pass 1: intra-procedural -----------------------------------------------
    def _build_intra(self) -> None:
        for mod, s in self.graph.modules.items():
            for csum in s.classes.values():
                self.lock_vocab.update(csum.lock_names.values())
            for fkey, func in s.functions.items():
                self.lock_vocab.update(func.lock_names.values())
                f_id = fid(mod, fkey)
                held_at_call: Dict[Tuple[str, int], frozenset] = {}
                if func.cfg is not None:
                    self._scan_cfg(mod, s.path, f_id, func, held_at_call)
                for op in func.blocking_ops:
                    site = self._blocking_site(mod, s.path, func, op)
                    if site is None:
                        continue
                    held = held_at_call.get((op.callee, op.lineno),
                                            frozenset())
                    self.direct_blocking.setdefault(f_id, []).append(
                        (site, held))

    def _scan_cfg(self, mod: str, path: str, f_id: str, func: FuncSummary,
                  held_at_call: Dict[Tuple[str, int], frozenset]) -> None:
        states = dataflow.must_locksets(
            func.cfg, lambda e: self.resolve_lock(mod, func, e.obj))
        for (b, i), held in sorted(states.items()):
            event = func.cfg.blocks[b].events[i]
            if event.kind == cfg_mod.ACQUIRE:
                lid = self.resolve_lock(mod, func, event.obj)
                if lid is not None:
                    self.acquires.setdefault(f_id, []).append(
                        Acq(lid, path, event.lineno, held, event.via))
                    for h in sorted(held):
                        self._edge(h, lid, (
                            (path, event.lineno, f"acquires {lid}"),))
                elif event.via == "with":
                    target = self._enter_target(mod, func, event.obj)
                    if target is not None:
                        self._synth.setdefault(f_id, []).append(
                            (target, event.lineno))
                        if held:
                            self.calls_held.setdefault(f_id, []).append(
                                (target, event.lineno, held))
            elif event.kind == cfg_mod.CALL:
                held_at_call[(event.obj, event.lineno)] = held
                if held:
                    target = self.cg._resolve(mod, func, event.obj)
                    if target is not None and target in self.cg.funcs:
                        self.calls_held.setdefault(f_id, []).append(
                            (target, event.lineno, held))
                if event.via == "with":
                    # `with factory(...):` — the returned guard is
                    # entered unconditionally; project its __enter__
                    enter = self._factory_enter(mod, func, event.obj)
                    if enter is not None:
                        self._synth.setdefault(f_id, []).append(
                            (enter, event.lineno))
                        if held:
                            self.calls_held.setdefault(f_id, []).append(
                                (enter, event.lineno, held))

    def _blocking_site(self, mod: str, path: str, func: FuncSummary,
                       op: BlockingOp) -> Optional[BlockSite]:
        if op.kind == "queue":
            recv = op.callee.rsplit(".", 1)[0]
            if "." not in op.callee:
                return None
            t = self._recv_type(mod, func, recv)
            if t is None or t.rsplit(".", 1)[-1] not in _QUEUE_CTORS:
                return None
            return BlockSite(path, op.lineno, op.desc)
        if op.kind == "wait":
            recv = op.callee.rsplit(".", 1)[0]
            own = (self.resolve_lock(mod, func, recv)
                   if "." in op.callee else None)
            return BlockSite(path, op.lineno, op.desc, own=own)
        return BlockSite(path, op.lineno, op.desc)

    # ---- pass 2: callgraph fixpoints --------------------------------------------
    def _edges_from(self, caller: str):
        for e in self.cg.edges.get(caller, ()):
            if not e.spawn:
                yield e.callee, e.lineno
        for callee, line in self._synth.get(caller, ()):
            yield callee, line

    def _caller_path(self, caller: str) -> str:
        s = self.graph.modules.get(caller.split(":", 1)[0])
        return s.path if s is not None else ""

    def _fix_acquires(self) -> Dict[str, Dict[str, Tuple]]:
        ta: Dict[str, Dict[str, Tuple]] = {}
        for f_id, acqs in self.acquires.items():
            d = ta.setdefault(f_id, {})
            for a in acqs:
                d.setdefault(a.lock,
                             ((a.path, a.line, f"acquires {a.lock}"),))
        callers = sorted(set(self.cg.edges) | set(self._synth))
        changed = True
        while changed:
            changed = False
            for caller in callers:
                cpath = self._caller_path(caller)
                d = ta.get(caller)
                for callee, line in self._edges_from(caller):
                    sub = ta.get(callee)
                    if not sub:
                        continue
                    if d is None:
                        d = ta.setdefault(caller, {})
                    for lock, chain in sub.items():
                        if lock not in d and len(chain) < _CHAIN_CAP:
                            d[lock] = ((cpath, line,
                                        f"→ {_label(callee)}"),) + chain
                            changed = True
        return ta

    def _fix_blocking(self) -> Dict[str, Dict[Tuple[str, int],
                                              Tuple[BlockSite, Tuple]]]:
        tb: Dict[str, Dict[Tuple[str, int], Tuple[BlockSite, Tuple]]] = {}
        for f_id, sites in self.direct_blocking.items():
            d = tb.setdefault(f_id, {})
            for site, _held in sites:
                d.setdefault((site.path, site.line), (site, ()))
        callers = sorted(set(self.cg.edges) | set(self._synth))
        changed = True
        while changed:
            changed = False
            for caller in callers:
                cpath = self._caller_path(caller)
                d = tb.get(caller)
                for callee, line in self._edges_from(caller):
                    sub = tb.get(callee)
                    if not sub:
                        continue
                    if d is None:
                        d = tb.setdefault(caller, {})
                    for key, (site, chain) in sub.items():
                        if key not in d and len(chain) < _CHAIN_CAP \
                                and len(d) < 64:
                            d[key] = (site, ((cpath, line,
                                              f"→ {_label(callee)}"),)
                                      + chain)
                            changed = True
        return tb

    # ---- pass 3: the global lock-order graph ------------------------------------
    def _edge(self, a: str, b: str, witness: Tuple) -> None:
        if a == b:
            return  # same-name self-edges: distinct instances, dropped
        self.lock_vocab.update((a, b))
        key = (a, b)
        self.edge_count[key] = self.edge_count.get(key, 0) + 1
        self.edge_witness.setdefault(key, witness)

    def _project_edges(self) -> None:
        for f_id in sorted(self.calls_held):
            path = self._caller_path(f_id)
            for callee, line, held in self.calls_held[f_id]:
                sub = self.trans_acquires.get(callee)
                if not sub:
                    continue
                for lock, chain in sorted(sub.items()):
                    for h in sorted(held):
                        self._edge(h, lock, (
                            (path, line, f"→ {_label(callee)}"),) + chain)

    # ---- cycle detection --------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Elementary cycles of the lock-order graph, one representative
        per strongly connected component, nodes in cycle order."""
        adj: Dict[str, List[str]] = {}
        for a, b in self.edge_witness:
            adj.setdefault(a, []).append(b)
        for v in adj.values():
            v.sort()
        sccs = _tarjan(adj)
        out: List[List[str]] = []
        for comp in sccs:
            if len(comp) < 2:
                continue
            cyc = _cycle_in(sorted(comp), adj)
            if cyc:
                out.append(cyc)
        out.sort()
        return out

    def witness_chain(self, a: str, b: str) -> Tuple:
        return self.edge_witness.get((a, b), ())


def _tarjan(adj: Dict[str, List[str]]) -> List[List[str]]:
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]
    nodes = sorted(set(adj) | {b for vs in adj.values() for b in vs})

    def strongconnect(v: str) -> None:
        # iterative DFS (the package graph is small, but recursion
        # limits are not a correctness budget)
        work = [(v, iter(adj.get(v, ())))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(adj.get(w, ()))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp: List[str] = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)

    for v in nodes:
        if v not in index:
            strongconnect(v)
    return sccs


def _cycle_in(comp: List[str], adj: Dict[str, List[str]]) -> List[str]:
    """Shortest simple cycle through the SCC's smallest node (BFS back
    to the start; the closing edge is last → first)."""
    members = set(comp)
    start = comp[0]
    parent: Dict[str, Optional[str]] = {start: None}
    frontier = [start]
    while frontier:
        nxt: List[str] = []
        for node in frontier:
            for w in adj.get(node, ()):
                if w == start:
                    path: List[str] = []
                    n: Optional[str] = node
                    while n is not None:
                        path.append(n)
                        n = parent[n]
                    return list(reversed(path))
                if w in members and w not in parent:
                    parent[w] = node
                    nxt.append(w)
        frontier = nxt
    return []
