"""Call graph over the project symbol graph (phase 1, part 2).

Nodes are function ids ``"<module>:<funckey>"`` (funckey as produced by
``graph._Extractor`` — ``f``, ``C.m``, ``C.m>nested``).  Edges come
from the recorded call sites with a method-receiver approximation:

* bare names resolve to module-local functions, then import aliases
  (``from x import f``);
* dotted names resolve through import aliases (``mod.f``), ``self``
  (own class, then project base classes), constructor-assigned locals
  (``x = ClassName(...)``), parameter annotations, ``alias = self``,
  and constructor-assigned instance attributes (``self._y = C()`` →
  ``self._y.m`` → ``C.m``);
* a call that resolves to a project class adds an edge to its
  ``__init__``;
* function-valued arguments to ``submit``/``Thread(target=...)``/
  ``call_soon`` count as calls — work handed to a pool or thread is
  still on the call path.

Known blind spots (documented in docs/STATIC_ANALYSIS.md): calls
through containers or getattr, lambdas, monkey-patching, and receivers
whose type only dataflow would reveal.  The interprocedural rules are
therefore UNDER-approximate: they miss paths, they do not invent
them — which is the right polarity for a zero-findings gate."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from cruise_control_tpu_torch.devtools.lint.graph import (
    FuncSummary,
    SymbolGraph,
)

#: callee tails whose function-typed first argument (or target=) runs on
#: another thread — edges are added to the argument
SPAWN_TAILS = {"submit", "call_soon", "start_new_thread"}


@dataclasses.dataclass(frozen=True)
class Edge:
    caller: str          # function id "module:funckey"
    callee: str
    lineno: int
    #: the callee runs on another thread (Thread target / submit /
    #: call_soon) — lock/blocking state does NOT flow across it
    spawn: bool = False


def fid(module: str, funckey: str) -> str:
    return f"{module}:{funckey}"


class CallGraph:
    def __init__(self, graph: SymbolGraph):
        self.graph = graph
        self.funcs: Dict[str, FuncSummary] = {}
        for mod, s in graph.modules.items():
            for key, f in s.functions.items():
                self.funcs[fid(mod, key)] = f
        self.edges: Dict[str, List[Edge]] = {}
        self._build()

    # -- resolution --
    def _resolve(self, module: str, func: FuncSummary,
                 callee: str) -> Optional[str]:
        """callee dotted expr as written → function id, or None."""
        g = self.graph
        s = g.modules.get(module)
        if s is None:
            return None
        parts = callee.split(".")
        # self.m() / self._x.m() / x.m() with known receiver type
        if len(parts) >= 2:
            recv, meth = ".".join(parts[:-1]), parts[-1]
            hit = g.class_of_receiver(module, func, recv)
            if hit is not None:
                found = g.class_method(hit[0], hit[1], meth)
                if found is not None:
                    return fid(found[0], found[1].name)
                return None
        if len(parts) == 1:
            name = parts[0]
            # own nested def, then sibling nested def / own function
            # scope first
            own = f"{func.name}>{name}"
            if own in s.functions:
                return fid(module, own)
            if ">" in func.name:
                parent = func.name.rsplit(">", 1)[0]
                sib = f"{parent}>{name}"
                if sib in s.functions:
                    return fid(module, sib)
            if func.cls is not None:
                meth = f"{func.cls}.{name}"
                if meth in s.functions:
                    return fid(module, meth)
            if name in s.functions:
                return fid(module, name)
            if name in s.classes:
                init = f"{name}.__init__"
                return fid(module, init) if init in s.functions else None
            target = g.import_aliases(module).get(name)
            if target is not None:
                return self._resolve_absolute(target)
            return None
        # dotted through an import alias: mod.f / pkg.mod.f / mod.Class
        aliases = g.import_aliases(module)
        head = parts[0]
        target = aliases.get(head)
        if target is not None:
            return self._resolve_absolute(".".join([target] + parts[1:]))
        return None

    def _resolve_absolute(self, dotted: str) -> Optional[str]:
        """Absolute dotted path → function id: module function, class
        (→ __init__), or class method."""
        g = self.graph
        for cut in range(len(dotted.split(".")), 0, -1):
            parts = dotted.split(".")
            mod, rest = ".".join(parts[:cut]), parts[cut:]
            s = g.modules.get(mod)
            if s is None:
                continue
            if not rest:
                return None
            if len(rest) == 1:
                name = rest[0]
                if name in s.functions:
                    return fid(mod, name)
                if name in s.classes:
                    init = f"{name}.__init__"
                    return fid(mod, init) if init in s.functions else None
                return None
            if len(rest) == 2 and rest[0] in s.classes:
                found = g.class_method(mod, s.classes[rest[0]], rest[1])
                if found is not None:
                    return fid(found[0], found[1].name)
            return None
        return None

    # -- construction --
    def _build(self) -> None:
        for caller_id, func in self.funcs.items():
            module = caller_id.split(":", 1)[0]
            out: List[Edge] = []
            for site in func.calls:
                target = self._resolve(module, func, site.callee)
                if target is not None and target in self.funcs:
                    out.append(Edge(caller_id, target, site.lineno,
                                    spawn=site.spawned))
                tail = site.callee.rsplit(".", 1)[-1]
                if tail in SPAWN_TAILS:
                    # the function argument is (eventually) called
                    for arg in site.arg_exprs:
                        if not arg:
                            continue
                        t = self._resolve(module, func, arg)
                        if t is not None and t in self.funcs:
                            out.append(Edge(caller_id, t, site.lineno,
                                            spawn=True))
            if out:
                self.edges[caller_id] = out

    # -- reachability --
    def reachable_from(self, roots: Set[str]) -> Dict[str, Tuple[str, ...]]:
        """BFS: function id → shortest call path (ids, root first) for
        everything reachable from ``roots`` (roots map to their own
        1-element path)."""
        out: Dict[str, Tuple[str, ...]] = {}
        frontier = [(r, (r,)) for r in sorted(roots) if r in self.funcs]
        while frontier:
            nxt: List[Tuple[str, Tuple[str, ...]]] = []
            for node, path in frontier:
                if node in out:
                    continue
                out[node] = path
                for e in self.edges.get(node, ()):
                    if e.callee not in out:
                        nxt.append((e.callee, path + (e.callee,)))
            frontier = nxt
        return out

    def callers_of(self, target: str) -> List[Edge]:
        return [e for edges in self.edges.values() for e in edges
                if e.callee == target]


def render_path(path: Tuple[str, ...]) -> str:
    """Human-readable call path: drop module prefixes except the first
    and last hop (the anchor file:line already locates the finding)."""
    if len(path) <= 1:
        return path[0] if path else ""
    labels = [path[0]] + [p.split(":", 1)[1] for p in path[1:]]
    return " → ".join(labels)
