"""Per-function control-flow graphs for the flow-sensitive rules.

The PR-4/10 rules are flow-INsensitive: they know which with-contexts
lexically enclose a call site, but nothing about manual
``acquire()``/``release()`` pairing, exception paths, or statement
order.  This module builds a small, picklable CFG per function —
branches, loops, ``try``/``except``/``finally``, ``with``, ``match``,
``return``/``raise``/``break``/``continue`` — that the worklist
analyses in ``dataflow.py`` run over.  ``graph._Extractor`` attaches a
CFG to every :class:`~graph.FuncSummary` that has lock events (a
plain-dotted ``with`` item or an ``.acquire()``/``.release()`` call),
so the CFGs ride the ``.cclint_cache`` pipeline and warm runs stay
parse-free.

Modeling decisions (documented in docs/STATIC_ANALYSIS.md):

* Blocks carry ordered *events* — lock acquires/releases and calls —
  not statements.  Everything without an event is control flow only.
* Every event-bearing statement can raise: an exception edge leaves
  with the PRE-event state (the statement's effect never landed), so
  blocks are split at events.  The innermost handler / ``finally`` /
  ``with``-exit is the exception target; the function exit is the
  outermost target (an uncaught exception leaves the function).
* ``with <dotted>:`` acquires at entry and releases in a dedicated
  exit block that BOTH the normal and the exception path route
  through — a with-held lock can never be reported as leaked.
* ``finally`` continuations are over-approximated: the finally end
  edges to the normal continuation AND the outer exception/cleanup
  target.  Spurious paths only ever SHRINK must-locksets (intersection
  join), which is the safe polarity for a zero-findings gate.
* Expressions are walked at statement granularity; short-circuit
  evaluation inside one expression is not modeled.  Lambda and nested
  ``def`` bodies are skipped (they run later, on their own CFG).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import List, Optional, Tuple

ACQUIRE = "acquire"
RELEASE = "release"
CALL = "call"

_LOCK_TAILS = {"acquire", "release"}


@dataclasses.dataclass(frozen=True)
class CFGEvent:
    kind: str                # "acquire" | "release" | "call"
    obj: str                 # lock expr for acquire/release, callee for call
    lineno: int
    via: str = "call"        # acquire/release provenance: "with" | "call"
    assigned: bool = True    # acquire: result consumed (not a bare stmt)
    bounded: bool = False    # acquire: timeout/blocking argument present


@dataclasses.dataclass
class CFGBlock:
    events: List[CFGEvent] = dataclasses.field(default_factory=list)
    succs: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CFG:
    """blocks[0] is the entry, blocks[1] the (single) exit."""

    blocks: List[CFGBlock]
    entry: int = 0
    exit: int = 1


# ---- event extraction -----------------------------------------------------------
def _dotted(node: ast.expr) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _walk_expr(node: ast.AST):
    """ast.walk that does not descend into deferred bodies."""
    stack = [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.Lambda, ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            stack.append(child)


def _events(nodes, bare_call: Optional[ast.Call] = None) -> List[CFGEvent]:
    out: List[CFGEvent] = []
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        d = _dotted(n.func)
        if d is None:
            continue
        tail = d.rsplit(".", 1)[-1]
        if tail == "acquire" and "." in d:
            bounded = bool(n.args) or any(
                kw.arg in ("timeout", "blocking") for kw in n.keywords)
            out.append(CFGEvent(
                ACQUIRE, d.rsplit(".", 1)[0], n.lineno, via="call",
                assigned=(n is not bare_call), bounded=bounded))
        elif tail == "release" and "." in d:
            out.append(CFGEvent(RELEASE, d.rsplit(".", 1)[0], n.lineno,
                                via="call"))
        else:
            out.append(CFGEvent(CALL, d, n.lineno))
    out.sort(key=lambda e: e.lineno)
    return out


def _expr_events(expr: Optional[ast.expr]) -> List[CFGEvent]:
    if expr is None:
        return []
    return _events(_walk_expr(expr))


def _stmt_events(stmt: ast.stmt) -> List[CFGEvent]:
    bare = (stmt.value if isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Call) else None)
    return _events(_walk_expr(stmt), bare_call=bare)


def has_lock_events(fn) -> bool:
    """True when the function body (nested defs excluded) contains a
    plain-dotted ``with`` item or an ``.acquire()``/``.release()``
    call — the trigger for building and caching a CFG."""
    for node in _walk_expr(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                if _dotted(item.context_expr) is not None:
                    return True
        elif isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d is not None and "." in d \
                    and d.rsplit(".", 1)[-1] in _LOCK_TAILS:
                return True
    return False


# ---- construction ---------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _Ctx:
    exc: int                          # innermost exception target
    cleanups: Tuple[int, ...] = ()    # finally / with-exit chain (outer→inner)
    #: (break target, continue target, cleanup depth at loop entry)
    loop: Optional[Tuple[int, int, int]] = None


class _Builder:
    def __init__(self):
        self.blocks: List[CFGBlock] = [CFGBlock(), CFGBlock()]

    EXIT = 1

    def new(self) -> int:
        self.blocks.append(CFGBlock())
        return len(self.blocks) - 1

    def edge(self, a: Optional[int], b: Optional[int]) -> None:
        if a is None or b is None:
            return
        succs = self.blocks[a].succs
        if b not in succs:
            succs.append(b)

    def _live(self, b: int) -> bool:
        return any(b in blk.succs for blk in self.blocks)

    # -- statement walk --
    def stmts(self, body, cur: Optional[int], ctx: _Ctx) -> Optional[int]:
        for stmt in body:
            if cur is None:
                break
            cur = self.stmt(stmt, cur, ctx)
        return cur

    def emit(self, events: List[CFGEvent], cur: int, ctx: _Ctx) -> int:
        """Append events behind an exception split: the handler path
        leaves ``cur`` with the PRE-event state.  Pure-release
        statements get NO split: ``release()`` raises only when the
        lock is not held (misuse outside this model), and the phantom
        pre-release exception path would mark every correct
        try/finally release as skippable."""
        if not events:
            return cur
        if not all(e.kind == RELEASE for e in events):
            self.edge(cur, ctx.exc)
        nxt = self.new()
        self.edge(cur, nxt)
        self.blocks[nxt].events.extend(events)
        return nxt

    def stmt(self, node: ast.stmt, cur: int, ctx: _Ctx) -> Optional[int]:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return cur
        if isinstance(node, (ast.With, ast.AsyncWith)):
            return self._with(node, cur, ctx)
        if isinstance(node, ast.If):
            return self._if(node, cur, ctx)
        if isinstance(node, ast.While):
            return self._loop(node, node.test, cur, ctx)
        if isinstance(node, (ast.For, ast.AsyncFor)):
            return self._loop(node, node.iter, cur, ctx)
        if isinstance(node, ast.Try) or (
                hasattr(ast, "TryStar")
                and isinstance(node, getattr(ast, "TryStar"))):
            return self._try(node, cur, ctx)
        if isinstance(node, ast.Match):
            return self._match(node, cur, ctx)
        if isinstance(node, ast.Return):
            cur = self.emit(_expr_events(node.value), cur, ctx)
            self.edge(cur, ctx.cleanups[-1] if ctx.cleanups else self.EXIT)
            return None
        if isinstance(node, ast.Raise):
            cur = self.emit(_stmt_events(node), cur, ctx)
            self.edge(cur, ctx.exc)
            return None
        if isinstance(node, (ast.Break, ast.Continue)):
            if ctx.loop is None:
                return None
            brk, cont, depth = ctx.loop
            target = brk if isinstance(node, ast.Break) else cont
            if len(ctx.cleanups) > depth:
                target = ctx.cleanups[-1]
            self.edge(cur, target)
            return None
        return self.emit(_stmt_events(node), cur, ctx)

    def _if(self, node: ast.If, cur: int, ctx: _Ctx) -> Optional[int]:
        cur = self.emit(_expr_events(node.test), cur, ctx)
        after = self.new()
        then = self.new()
        self.edge(cur, then)
        self.edge(self.stmts(node.body, then, ctx), after)
        if node.orelse:
            other = self.new()
            self.edge(cur, other)
            self.edge(self.stmts(node.orelse, other, ctx), after)
        else:
            self.edge(cur, after)
        return after if self._live(after) else None

    def _loop(self, node, head_expr: ast.expr, cur: int,
              ctx: _Ctx) -> Optional[int]:
        head = self.new()
        self.edge(cur, head)
        h = self.emit(_expr_events(head_expr), head, ctx)
        after = self.new()
        body = self.new()
        self.edge(h, body)
        inner = dataclasses.replace(
            ctx, loop=(after, head, len(ctx.cleanups)))
        self.edge(self.stmts(node.body, body, inner), head)
        infinite = (isinstance(node, ast.While)
                    and isinstance(node.test, ast.Constant)
                    and bool(node.test.value))
        if not infinite:
            if node.orelse:
                ob = self.new()
                self.edge(h, ob)
                self.edge(self.stmts(node.orelse, ob, ctx), after)
            else:
                self.edge(h, after)
        return after if self._live(after) else None

    def _with(self, node, cur: int, ctx: _Ctx) -> Optional[int]:
        # items are entered LEFT TO RIGHT (`with A, B:` desugars to
        # nested withs), so a later item's context expression runs with
        # every earlier item's lock already held — events interleave in
        # item order, not calls-then-acquires
        entry_events: List[CFGEvent] = []
        releases: List[CFGEvent] = []
        for item in node.items:
            d = _dotted(item.context_expr)
            if d is not None:
                entry_events.append(CFGEvent(
                    ACQUIRE, d, item.context_expr.lineno, via="with"))
                releases.append(CFGEvent(
                    RELEASE, d, item.context_expr.lineno, via="with"))
            else:
                evts = _expr_events(item.context_expr)
                ce = item.context_expr
                if isinstance(ce, ast.Call):
                    # tag the context-manager call itself (not argument
                    # sub-calls) so lockflow can project the returned
                    # guard's __enter__ (`with progress.step(...):`)
                    cd = _dotted(ce.func)
                    for i, e in enumerate(evts):
                        if (e.kind == CALL and e.obj == cd
                                and e.lineno == ce.lineno):
                            evts[i] = dataclasses.replace(e, via="with")
                            break
                entry_events.extend(evts)
        cur = self.emit(entry_events, cur, ctx)
        wexit = self.new()
        self.blocks[wexit].events.extend(reversed(releases))
        inner = dataclasses.replace(
            ctx, exc=wexit, cleanups=ctx.cleanups + (wexit,))
        body = self.new()
        self.edge(cur, body)
        self.edge(body, wexit)  # region-entry exception edge
        self.edge(self.stmts(node.body, body, inner), wexit)
        after = self.new()
        self.edge(wexit, after)
        # propagating exception / return continues AFTER __exit__ released
        self.edge(wexit, ctx.exc)
        if ctx.cleanups:
            self.edge(wexit, ctx.cleanups[-1])
        return after

    def _try(self, node, cur: int, ctx: _Ctx) -> Optional[int]:
        after = self.new()
        if node.finalbody:
            fentry = self.new()
            fend = self.stmts(node.finalbody, fentry, ctx)
            self.edge(fend, after)            # normal completion
            self.edge(fend, ctx.exc)          # re-raise continuation
            self.edge(fend, ctx.cleanups[-1] if ctx.cleanups
                      else self.EXIT)         # return continuation
            inner_exc = fentry
            inner_cleanups = ctx.cleanups + (fentry,)
            tail = fentry
        else:
            inner_exc = ctx.exc
            inner_cleanups = ctx.cleanups
            tail = after
        if node.handlers:
            hentry = self.new()
            self.edge(hentry, inner_exc)      # unmatched exception
            hctx = dataclasses.replace(
                ctx, exc=inner_exc, cleanups=inner_cleanups)
            for handler in node.handlers:
                hb = self.new()
                self.edge(hentry, hb)
                self.edge(self.stmts(handler.body, hb, hctx), tail)
            body_exc = hentry
        else:
            body_exc = inner_exc
        bctx = dataclasses.replace(
            ctx, exc=body_exc, cleanups=inner_cleanups)
        body = self.new()
        self.edge(cur, body)
        self.edge(body, body_exc)             # region-entry exception edge
        bend = self.stmts(node.body, body, bctx)
        if node.orelse and bend is not None:
            octx = dataclasses.replace(
                ctx, exc=inner_exc, cleanups=inner_cleanups)
            ob = self.new()
            self.edge(bend, ob)
            bend = self.stmts(node.orelse, ob, octx)
        self.edge(bend, tail)
        return after if self._live(after) else None

    def _match(self, node, cur: int, ctx: _Ctx) -> Optional[int]:
        cur = self.emit(_expr_events(node.subject), cur, ctx)
        after = self.new()
        for case in node.cases:
            cb = self.new()
            self.edge(cur, cb)
            self.edge(self.stmts(case.body, cb, ctx), after)
        self.edge(cur, after)                 # no case matched
        return after


def build_cfg(fn) -> CFG:
    """CFG for one ``FunctionDef``/``AsyncFunctionDef`` body."""
    b = _Builder()
    ctx = _Ctx(exc=_Builder.EXIT)
    b.edge(b.stmts(fn.body, 0, ctx), _Builder.EXIT)
    return CFG(blocks=b.blocks)
