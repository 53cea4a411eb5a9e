"""obs-dynamic-name — observability names must be static.

Three name surfaces, one discipline (docs/OBSERVABILITY.md):

* span names: an f-string name (positional or ``sub=``) at a
  ``span()``/``device_span()`` call site must be guarded by
  ``tracing.enabled()`` so the disabled path never pays for string
  formatting on a hot path;
* event kinds and payloads at ``events.emit()`` call sites: a dynamic
  kind mints unbounded journal vocabulary, and payload f-strings are
  formatting cost the disabled path still pays — same guard rule;
* metric names at ``registry.counter/gauge/timer/histogram/meter()``
  call sites: an f-string name mints one metric family per distinct
  value.  No ``enabled()`` escape here — the registry is always on, so
  a dynamic name is a cardinality question, not a cost question; a
  deliberately bounded dynamic name carries a suppression whose reason
  states the bound.

This module is the framework home of the checks ``tests/
test_span_hygiene.py`` introduced as a one-off; that test now imports
``find_unguarded_dynamic_spans``/``find_unguarded_dynamic_event_kinds``
from here, so the original fixture cases double as rule unit tests.
"""

from __future__ import annotations

import ast
from typing import List

from cruise_control_tpu_torch.devtools.lint.context import FileContext
from cruise_control_tpu_torch.devtools.lint.findings import Finding

RULE_ID = "obs-dynamic-name"

SPAN_FUNCS = {"span", "device_span"}
EVENT_FUNCS = {"emit"}
METRIC_FUNCS = {"counter", "gauge", "timer", "histogram", "meter"}
#: receivers whose counter()/timer()/… calls are metric-registry calls
#: (``registry.timer(...)``, ``self.registry.meter(...)``, ``reg.…``) —
#: keeps dict-method homonyms out of scope
_REGISTRY_NAMES = {"registry", "reg", "metrics_registry"}


def _is_enabled_call(node: ast.AST) -> bool:
    """True for any `...enabled()` call (tracing.enabled / tel.enabled /
    the bare-name import form)."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
    return name == "enabled"


def _guard_tests(ancestors):
    """Yield the test expressions of every conditional construct whose
    TAKEN branch leads to the call: `if` statements (body branch only —
    an else branch is the path tracing is OFF), ternaries, and
    `cond and expr` short-circuits."""
    for parent, child in zip(ancestors, ancestors[1:] + [None]):
        if isinstance(parent, ast.If) and child in parent.body:
            yield parent.test
        elif isinstance(parent, ast.IfExp) and child is parent.body:
            yield parent.test
        elif isinstance(parent, ast.BoolOp) and isinstance(parent.op,
                                                           ast.And):
            idx = parent.values.index(child) if child in parent.values else 0
            for v in parent.values[:idx]:
                yield v


def _find_unguarded_dynamic_calls(tree: ast.AST, func_names,
                                  nodes=None, parents=None):
    """(lineno, func_name) for every call to one of ``func_names`` that
    builds an f-string argument without an enclosing enabled() guard.
    ``nodes``/``parents`` accept the FileContext's memoized traversal
    products (the bare-tree form re-walks, for the unit-test helpers)."""
    if nodes is None:
        nodes = list(ast.walk(tree))
    if parents is None:
        parents = {}
        for node in nodes:
            for child in ast.iter_child_nodes(node):
                parents[child] = node
    offenders = []
    for node in nodes:
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        name = (f.attr if isinstance(f, ast.Attribute)
                else getattr(f, "id", None))
        if name not in func_names:
            continue
        dynamic = any(
            isinstance(a, ast.JoinedStr) for a in node.args
        ) or any(
            isinstance(kw.value, ast.JoinedStr) for kw in node.keywords
        )
        if not dynamic:
            continue
        chain = [node]
        cur = node
        while cur in parents:
            cur = parents[cur]
            chain.append(cur)
        chain.reverse()  # outermost first
        guarded = any(
            any(_is_enabled_call(n) for n in ast.walk(test))
            for test in _guard_tests(chain)
        )
        if not guarded:
            offenders.append((node.lineno, name))
    return offenders


def find_unguarded_dynamic_spans(tree: ast.AST, nodes=None, parents=None):
    """(lineno, source_hint) for every span()/device_span() call that
    builds an f-string name without an enclosing enabled() guard."""
    return _find_unguarded_dynamic_calls(tree, SPAN_FUNCS, nodes, parents)


def find_unguarded_dynamic_event_kinds(tree: ast.AST, nodes=None,
                                       parents=None):
    """(lineno, source_hint) for every emit() call that builds an
    f-string argument (kind or payload value) without an enabled() guard.

    Scope note: payload f-strings are flagged too — on the disabled path
    emit()'s arguments are still evaluated, so the formatting cost rule is
    the same as for span names; put dynamic values in the payload as raw
    kwargs, not pre-formatted strings."""
    return _find_unguarded_dynamic_calls(tree, EVENT_FUNCS, nodes, parents)


def _receiver_is_registry(func: ast.expr) -> bool:
    if not isinstance(func, ast.Attribute):
        return False
    recv = func.value
    if isinstance(recv, ast.Name):
        return recv.id in _REGISTRY_NAMES
    if isinstance(recv, ast.Attribute):  # self.registry / app.registry
        return recv.attr in _REGISTRY_NAMES
    return False


def find_dynamic_metric_names(tree: ast.AST, nodes=None):
    """(lineno, func_name) for registry.counter/gauge/… calls whose NAME
    argument is an f-string — flagged unconditionally (cardinality, not
    cost: there is no disabled path for the registry)."""
    offenders = []
    for node in (nodes if nodes is not None else ast.walk(tree)):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in METRIC_FUNCS
                and _receiver_is_registry(f)):
            continue
        name_arg = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "name":
                name_arg = kw.value
        if isinstance(name_arg, ast.JoinedStr):
            offenders.append((node.lineno, f.attr))
    return offenders


class ObsDynamicNameRule:
    id = RULE_ID
    summary = ("span names / event kinds built from f-strings must sit "
               "behind enabled() guards; metric-registry names must be "
               "static (label-cardinality stays bounded)")

    def check_file(self, ctx: FileContext) -> List[Finding]:
        out = []
        nodes, parents = ctx.all_nodes, ctx.parents
        for lineno, fn in find_unguarded_dynamic_spans(
                ctx.tree, nodes, parents):
            out.append(Finding(
                ctx.path, lineno, self.id,
                f"{fn}() with f-string name outside a tracing.enabled() "
                "guard — pass a static name and route dynamic parts "
                "through sub= inside a guard (docs/OBSERVABILITY.md)",
            ))
        for lineno, fn in find_unguarded_dynamic_event_kinds(
                ctx.tree, nodes, parents):
            out.append(Finding(
                ctx.path, lineno, self.id,
                f"{fn}() with f-string argument outside an "
                "events.enabled() guard — event kinds must be static "
                "dotted strings; put dynamic values in the payload as "
                "raw kwargs (docs/OBSERVABILITY.md)",
            ))
        for lineno, fn in find_dynamic_metric_names(ctx.tree, nodes):
            out.append(Finding(
                ctx.path, lineno, self.id,
                f"registry.{fn}() with f-string metric name — every "
                "distinct value mints a new metric family; use a static "
                "name, or suppress with the reason stating the bound on "
                "the value set",
            ))
        return out
