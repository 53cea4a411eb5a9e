"""swallowed-exception — daemon loops must not eat errors silently.

The service's daemon loops (flight-recorder sampler, detector
scheduler, executor drive phases, fetcher manager) all follow the same
pattern: catch broadly so one bad iteration cannot kill the thread,
**but say so** — log the exception or journal it.  A ``try/except
Exception: pass`` inside a loop converts a persistent failure into a
silent flatline: the thread looks alive, the work never happens, and
nothing points at why (exactly how the pre-telemetry Meter races hid).

Flagged: an ``except`` handler that (a) catches ``Exception``,
``BaseException``, or everything (bare), (b) sits lexically inside a
``for``/``while`` loop, and (c) neither re-raises nor records —
no logging call (``LOG.exception(...)``, ``logger.warning(...)``, …),
no ``events.emit(...)``, no metric ``.inc()``/``.mark()``.
"""

from __future__ import annotations

import ast
from typing import List

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "swallowed-exception"

_BROAD = {"Exception", "BaseException"}
_RECORDING_CALLS = {"exception", "warning", "error", "critical", "info",
                    "debug", "log", "emit", "inc", "mark"}


def _catches_broadly(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = t.elts if isinstance(t, ast.Tuple) else [t]
    for n in names:
        name = n.attr if isinstance(n, ast.Attribute) else getattr(
            n, "id", None)
        if name in _BROAD:
            return True
    return False


def _records(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in _RECORDING_CALLS:
                return True
    return False


def find_swallowed_in_loops(tree: ast.AST, parents=None, nodes=None):
    """(lineno,) for every broad, silent handler inside a loop."""
    if nodes is None:
        nodes = list(ast.walk(tree))
    if parents is None:
        parents = {}
        for node in nodes:
            for child in ast.iter_child_nodes(node):
                parents[child] = node
    out = []
    for node in nodes:
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _catches_broadly(node) or _records(node):
            continue
        cur = node
        in_loop = False
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.For, ast.While)):
                in_loop = True
                break
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break  # loop outside the enclosing function doesn't count
        if in_loop:
            out.append(node.lineno)
    return out


class SwallowedExceptionRule:
    id = RULE_ID
    summary = ("broad except handlers inside daemon loops must log, "
               "journal, or re-raise — silent flatlines are undebuggable")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return [
            Finding(
                ctx.path, lineno, self.id,
                "broad except inside a loop neither logs, journals, nor "
                "re-raises — a persistent failure here becomes a silent "
                "flatline; add LOG.exception(...)/events.emit(...) or "
                "narrow the catch",
            )
            for lineno in find_swallowed_in_loops(ctx.tree, ctx.parents,
                                                  ctx.all_nodes)
        ]
