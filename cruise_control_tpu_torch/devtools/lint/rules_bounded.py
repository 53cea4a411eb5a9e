"""bounded-resource — growable runtime resources need an explicit bound.

This PR's front door bounds every queue between a client and the
analyzer (admission queue, per-class concurrency limits, worker pool);
this rule keeps the rest of the tree honest to the same discipline.  An
unbounded buffer is the classic overload failure: under sustained
pressure it converts load into memory growth and tail latency instead of
backpressure, and the process falls over minutes *after* the overload
began — the journal then blames the victim allocation, not the queue.

Flagged constructions (non-test code):

* ``queue.Queue()`` / ``LifoQueue()`` / ``PriorityQueue()`` with no
  ``maxsize`` (positional or keyword), and ``SimpleQueue()`` which has
  no bound at all;
* ``collections.deque(...)`` with no ``maxlen=``;
* ``ThreadPoolExecutor(...)`` with no ``max_workers`` (the default
  scales with CPU count — an implicit, machine-dependent bound is still
  a reviewed decision; say it explicitly).

A bound passed as a variable counts (the rule checks presence, not
value).  Deliberate unbounded structures take the usual
``# cclint: disable=bounded-resource -- reason`` with a MANDATORY
reason.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "bounded-resource"

#: constructor name → (bound kwarg, positional index of the bound, hint)
_BOUNDED_CTORS = {
    "Queue": ("maxsize", 0, "queue.Queue(maxsize=N)"),
    "LifoQueue": ("maxsize", 0, "queue.LifoQueue(maxsize=N)"),
    "PriorityQueue": ("maxsize", 0, "queue.PriorityQueue(maxsize=N)"),
    "deque": ("maxlen", 1, "deque(maxlen=N)"),
    "ThreadPoolExecutor": ("max_workers", 0,
                           "ThreadPoolExecutor(max_workers=N)"),
}


def _ctor_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _module_of(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id
    return None


def find_unbounded(tree: ast.AST, nodes=None) -> List[tuple]:
    """(lineno, message) per unbounded construction."""
    out: List[tuple] = []
    for node in (nodes if nodes is not None else ast.walk(tree)):
        if not isinstance(node, ast.Call):
            continue
        name = _ctor_name(node)
        if name == "SimpleQueue":
            mod = _module_of(node)
            if mod in (None, "queue"):
                out.append((
                    node.lineno,
                    "queue.SimpleQueue has no capacity bound — use "
                    "queue.Queue(maxsize=N) so overload backpressures "
                    "instead of growing memory",
                ))
            continue
        spec = _BOUNDED_CTORS.get(name)
        if spec is None:
            continue
        kwarg, pos, hint = spec
        # a Queue()-named constructor from an unrelated module (e.g.
        # multiprocessing) still deserves the bound; only obvious
        # non-library attributes (self.Queue) are skipped
        if isinstance(node.func, ast.Attribute) and not isinstance(
                node.func.value, ast.Name):
            continue
        if any(kw.arg == kwarg for kw in node.keywords):
            continue
        if any(kw.arg is None for kw in node.keywords):
            continue  # **kwargs may carry the bound — benefit of the doubt
        if len(node.args) > pos:
            # positional bound present — but an explicit None is unbounded
            arg = node.args[pos]
            if not (isinstance(arg, ast.Constant) and arg.value is None):
                continue
        out.append((
            node.lineno,
            f"{name}(...) without an explicit bound — pass {hint} (or "
            f"suppress with a reason if unbounded is a reviewed decision)",
        ))
    return out


class BoundedResourceRule:
    id = RULE_ID
    summary = ("growable resources (Queue/deque/ThreadPoolExecutor) must "
               "declare an explicit bound")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        return [
            Finding(ctx.path, lineno, self.id, message)
            for lineno, message in find_unbounded(ctx.tree, ctx.all_nodes)
        ]
