"""retry-discipline — retry loops need backoff, jitter, and a bound.

This PR's executor retries failed moves with exponential backoff and a
bounded attempt budget (``execution.task.retry.*``); this rule keeps the
rest of the tree honest to the same discipline.  A retry loop is a
``for``/``while`` loop that both catches exceptions AND sleeps — the
classic shape of "try again until it works":

* **constant backoff**: ``time.sleep(<numeric literal>)`` inside such a
  loop retries on a fixed cadence — under a real outage every client
  hammers the dependency in lockstep.  A computed argument (a variable,
  ``min(delay * 2, cap)``, a helper call) is taken as evidence of real
  backoff and stays quiet.
* **unbounded retry**: a ``while True`` retry loop whose failure path
  (the except handlers and the statements after the try) never
  ``raise``/``break``/``return`` retries forever — a permanent failure
  becomes an invisible hot loop.  Bounded iteration (``for _ in
  range(n)``) or a conditioned ``while`` is assumed to encode the bound.

Daemon service loops (catch + log, no sleep) are out of scope — that is
swallowed-exception's beat.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "retry-discipline"

_FUNC_BOUNDARIES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _walk_same_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk ``node`` without descending into nested function scopes (an
    inner def's loop/sleep belongs to the inner function's analysis)."""
    for child in ast.iter_child_nodes(node):
        yield child
        if not isinstance(child, _FUNC_BOUNDARIES):
            yield from _walk_same_scope(child)


def _is_sleep(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr == "sleep"
    return getattr(f, "id", None) == "sleep"


def _constant_sleeps(loop: ast.AST) -> List[ast.Call]:
    return [
        n for n in _walk_same_scope(loop)
        if isinstance(n, ast.Call) and _is_sleep(n) and n.args
        and isinstance(n.args[0], ast.Constant)
        and isinstance(n.args[0].value, (int, float))
    ]


def _has_sleep(loop: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call) and _is_sleep(n)
        for n in _walk_same_scope(loop)
    )


def _handlers(loop: ast.AST) -> List[ast.ExceptHandler]:
    return [n for n in _walk_same_scope(loop)
            if isinstance(n, ast.ExceptHandler)]


def _is_while_true(loop: ast.AST) -> bool:
    return (
        isinstance(loop, ast.While)
        and isinstance(loop.test, ast.Constant)
        and bool(loop.test.value)
    )


def _failure_path_bounded(loop: ast.While) -> bool:
    """True when some exit exists on the failure path: a raise/break/
    return inside an except handler, or anywhere in the loop body outside
    the try bodies (an attempt-counter check after the try)."""
    trys = [n for n in _walk_same_scope(loop) if isinstance(n, ast.Try)]
    in_try_body: set = set()
    for t in trys:
        for stmt in t.body:
            in_try_body.update(ast.walk(stmt))
    for n in _walk_same_scope(loop):
        if isinstance(n, (ast.Raise, ast.Break, ast.Return)) \
                and n not in in_try_body:
            return True
    return False


def find_retry_findings(tree: ast.AST, nodes=None) -> List[tuple]:
    """(lineno, message) per violation."""
    out: List[tuple] = []
    for node in (nodes if nodes is not None else ast.walk(tree)):
        if not isinstance(node, (ast.For, ast.While)):
            continue
        if not _handlers(node) or not _has_sleep(node):
            continue  # not a retry loop
        for call in _constant_sleeps(node):
            out.append((
                call.lineno,
                "retry loop sleeps a constant — use exponential backoff "
                "with jitter (a computed delay silences this)",
            ))
        if _is_while_true(node) and not _failure_path_bounded(node):
            out.append((
                node.lineno,
                "unbounded retry: `while True` with no raise/break/return "
                "on the failure path — bound the attempts (for attempt in "
                "range(n)) or escalate after a budget",
            ))
    return out


class RetryDisciplineRule:
    id = RULE_ID
    summary = ("retry loops must back off exponentially (no constant "
               "sleeps) and bound their attempts")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return [
            Finding(ctx.path, lineno, self.id, message)
            for lineno, message in find_retry_findings(ctx.tree, ctx.all_nodes)
        ]
